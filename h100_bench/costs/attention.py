"""FLOPs of SegFormer's attention, counted from the shapes of a
configuration and its traffic: per block, ``softmax(q k^T / sqrt(d)) v``
over ``B`` images, ``h`` heads of ``d``, ``N`` queries and ``M`` keys.

- forward: the two matrix products, ``4 B h N M d``;
- backward: the four products a backward needs (the gradients of the
  scores, of ``v``, of ``q`` and of ``k``), ``8 B h N M d``. A
  FlashAttention backward recomputes the scores as well; that product is
  not counted, so the count is the same whatever runs the attention.

The token grids follow the overlapping patch embeddings (7x7 / stride 4,
then 3x3 / stride 2, padding k // 2), the keys the ``r x r`` / stride-``r``
reduction. MiT-B5 at b8 512x1024: 648,540,061,696 FLOPs forward, three
times that a train step.
"""

from __future__ import annotations

from typing import List, Tuple


def _conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def stages(model: dict, hw: Tuple[int, int]) -> List[Tuple[int, int, int, int, int]]:
    """(blocks, heads, head width, queries N, keys M) of each stage on an
    ``hw`` input."""
    h, w = hw
    out = []
    for i, (c, depth, heads, r) in enumerate(zip(model["mit_embed_dims"], model["mit_depths"],
                                                 model["mit_num_heads"], model["mit_sr_ratios"])):
        k, s = (7, 4) if i == 0 else (3, 2)
        h, w = _conv_out(h, k, s, k // 2), _conv_out(w, k, s, k // 2)
        out.append((depth, heads, c // heads, h * w, _conv_out(h, r, r, 0) * _conv_out(w, r, r, 0)))
    return out


def forward_flops(model: dict, batch: int, hw: Tuple[int, int]) -> int:
    return sum(4 * batch * heads * d * n * m * blocks for blocks, heads, d, n, m in stages(model, hw))


def train_step_flops(config: dict, traffic: dict) -> int:
    """Forward and backward of every attention call of a source-only step."""
    return 3 * forward_flops(config["model"], traffic["batch"], tuple(traffic["source"]))
