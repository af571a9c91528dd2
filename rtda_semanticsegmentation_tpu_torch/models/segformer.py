"""SegFormer (Xie et al., arXiv:2105.15203): the Mix Transformer encoder
(MiT) and the all-MLP decoder, as NVlabs' ``mix_transformer.py`` and
``segformer_head.py`` build them. The JAX package has no SegFormer.

Per stage ``i`` of width ``C`` (``embed_dims``), ``heads`` heads of
``C / heads`` and spatial-reduction ratio ``r``, on the ``N = H_i x W_i``
tokens of an overlapping patch embedding (a 7x7 / stride-4 conv for stage
1, 3x3 / stride 2 for the others, then a LayerNorm):

- ``x = x + proj(SDPA(q(LN1 x), k, v))``, ``k, v = kv(LN_sr(sr(LN1 x)))``
  where ``sr`` is an ``r x r`` / stride-``r`` conv (no reduction, and no
  ``sr`` or ``LN_sr``, at ``r = 1``);
- ``x = x + fc2(GELU(DWConv3x3(fc1(LN2 x))))``, ``fc1`` widening ``C`` to
  ``mlp_ratio * C`` (Mix-FFN);
- a LayerNorm ends the stage.

The head maps each stage to ``decoder_dim`` with a ``Linear``, resizes
stages 2-4 bilinearly to stage 1's 1/4 grid, concatenates ``[c4, c3, c2,
c1]``, fuses them with a bias-free 1x1 conv, BatchNorm and ReLU, predicts
the classes with a 1x1 conv and resizes the logits to the input.

The block norms and the stage norms take ``eps = 1e-6``, the patch
embeddings' and the reduction's norms PyTorch's 1e-5, as published. Module
names are mmsegmentation's (``backbone.block3.12.attn.kv``,
``decode_head.linear_fuse.bn``), less its wrappers of one module
(``linear_c4`` for ``linear_c4.proj``, ``mlp.dwconv`` for
``mlp.dwconv.dwconv``). Drop-path and dropout are left out: the train step
is deterministic.

Layouts: tokens stay ``(B, N, C)`` between blocks. A token tensor is
viewed as a ``(B, C, H, W)`` map in ``channels_last`` memory for the
convs (``sr``, the depthwise conv), whose ``channels_last`` outputs are
viewed back as tokens, so neither direction copies. The one copy is the
head's concatenation of the four 768-wide maps. Attention runs through
``F.scaled_dot_product_attention``; on a card only its flash and
memory-efficient kernels may run it (a call neither can take raises
rather than writing its score matrix out), and every call counts
``attention.calls``. Spans ``segformer.encoder`` and ``segformer.head``
(``obs/spans.py``) time the two halves of a forward. The resizes'
backward is ``kernels/upsample.py``'s gather (``layers.resize_bilinear``).

A train-mode forward on a card in bf16 or fp16 (where attention runs its
flash kernels) runs the encoder, forward and backward, as CUDA graphs
(``torch.cuda.make_graphed_callables``), captured on the first call for
each input shape: eager, its ~5,000 kernel launches a step cost the host
about twice the device's time, so the step waited on the host and its
rate followed the host's speed. In f32 attention takes the
memory-efficient kernel, whose backward did not capture on the card, so
f32 stays eager. The graphs replay the same
kernels; the encoder has no buffers and no randomness, so the capture's
warm-up passes change nothing. A graph holds one forward's activations,
so a second forward of the same shape before the first's backward has
reached the encoder (the adversarial step's two domains at one size) runs
eager. A replay counts the blocks' 52 ``attention.calls`` and the
encoder's 161 ``layernorm.fwd_calls`` itself, and its 161
``layernorm.bwd_calls`` when the backward reaches it (the graph's own
calls do not reach Python). The head (train BatchNorm, the resizes and
their counters) stays eager.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..obs.spans import count, span
from .layers import Conv, ConvBN, LayerNorm, Linear, gelu, resize_bilinear

HW = Tuple[int, int]
BLOCK_EPS = 1e-6  # block and stage LayerNorms
EMBED_EPS = 1e-5  # patch-embedding and reduction LayerNorms
CARD_BACKENDS = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION)


def to_map(x: torch.Tensor, hw: HW) -> torch.Tensor:
    """(B, N, C) tokens as a (B, C, H, W) map: a view, ``channels_last``
    where the tokens are contiguous."""
    return x.transpose(1, 2).unflatten(2, hw)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) map as (B, N, C) tokens: a contiguous view of a
    ``channels_last`` map."""
    return x.flatten(2).transpose(1, 2)


def _attention_backends(device: torch.device):
    return sdpa_kernel(list(CARD_BACKENDS)) if device.type == "cuda" else contextlib.nullcontext()


class Attention(nn.Module):
    """Multi-head attention whose keys and values come from the tokens
    reduced by an ``sr_ratio`` x ``sr_ratio`` / stride conv."""

    def __init__(self, dim, heads, sr_ratio, *, dtype=torch.float32):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, sr_ratio, 0, dtype=dtype, init="fan_out")
            self.norm = LayerNorm(dim, EMBED_EPS, dtype=dtype)

    def forward(self, x, hw: HW):
        b, n, c = x.shape
        h = self.heads
        q = self.q(x).unflatten(2, (h, c // h)).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(to_tokens(self.sr(to_map(x, hw))))
        k, v = self.kv(x).unflatten(2, (2, h, c // h)).permute(2, 0, 3, 1, 4)
        count("attention.calls")
        y = F.scaled_dot_product_attention(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    """``fc2(GELU(DWConv3x3(fc1(x))))``, the depthwise conv on the token grid."""

    def __init__(self, dim, hidden, *, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = Conv(hidden, hidden, 3, 1, 1, groups=hidden, dtype=dtype, init="fan_out")
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x, hw: HW):
        y = to_tokens(self.dwconv(to_map(self.fc1(x), hw)))
        return self.fc2(gelu(y))


class Block(nn.Module):
    def __init__(self, dim, heads, sr_ratio, mlp_ratio, *, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, BLOCK_EPS, dtype=dtype)
        self.attn = Attention(dim, heads, sr_ratio, dtype=dtype)
        self.norm2 = LayerNorm(dim, BLOCK_EPS, dtype=dtype)
        self.mlp = MixFFN(dim, mlp_ratio * dim, dtype=dtype)

    def forward(self, x, hw: HW):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class PatchEmbed(nn.Module):
    """Overlapping patch embedding: a k x k / stride conv, padding k // 2,
    then a LayerNorm over the tokens."""

    def __init__(self, in_ch, dim, kernel, stride, *, dtype=torch.float32):
        super().__init__()
        self.proj = Conv(in_ch, dim, kernel, stride, kernel // 2, dtype=dtype, init="fan_out")
        self.norm = LayerNorm(dim, EMBED_EPS, dtype=dtype)

    def forward(self, x) -> Tuple[torch.Tensor, HW]:
        y = self.proj(x)
        return self.norm(to_tokens(y)), (y.shape[2], y.shape[3])


class MixVisionTransformer(nn.Module):
    """The MiT encoder; ``forward`` gives each stage's tokens and grid."""

    def __init__(self, embed_dims, depths, num_heads, sr_ratios, mlp_ratio, *, dtype=torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        cin = 3
        for i, (dim, depth, heads, sr) in enumerate(zip(embed_dims, depths, num_heads, sr_ratios)):
            setattr(self, f"patch_embed{i + 1}", PatchEmbed(cin, dim, 7 if i == 0 else 3, 4 if i == 0 else 2,
                                                            dtype=dtype))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, heads, sr, mlp_ratio, dtype=dtype) for _ in range(depth)))
            setattr(self, f"norm{i + 1}", LayerNorm(dim, BLOCK_EPS, dtype=dtype))
            cin = dim

    def forward(self, x) -> List[Tuple[torch.Tensor, HW]]:
        out = []
        for i in range(len(self.depths)):
            t, hw = getattr(self, f"patch_embed{i + 1}")(x)
            for block in getattr(self, f"block{i + 1}"):
                t = block(t, hw)
            t = getattr(self, f"norm{i + 1}")(t)
            out.append((t, hw))
            x = to_map(t, hw)
        return out


class SegFormerHead(nn.Module):
    """The all-MLP decoder, up to the logits on stage 1's grid."""

    def __init__(self, embed_dims: Sequence[int], dim: int, num_classes: int, *, dtype=torch.float32):
        super().__init__()
        self.stages = len(embed_dims)
        for i in reversed(range(self.stages)):
            setattr(self, f"linear_c{i + 1}", Linear(embed_dims[i], dim, dtype=dtype))
        self.linear_fuse = ConvBN(self.stages * dim, dim, 1, 1, 0, dtype=dtype, init="fan_out")
        self.linear_pred = Conv(dim, num_classes, 1, dtype=dtype, init="fan_out")

    def forward(self, feats: List[Tuple[torch.Tensor, HW]]):
        hw1 = feats[0][1]
        maps = []
        for i in reversed(range(self.stages)):
            t, hw = feats[i]
            y = to_map(getattr(self, f"linear_c{i + 1}")(t), hw)
            maps.append(y if hw == hw1 else resize_bilinear(y, hw1))
        # the one copy of the forward: the four maps into one 4 x dim tensor
        return self.linear_pred(self.linear_fuse(torch.cat(maps, dim=1)))


class SegFormer(nn.Module):
    """``forward(x)`` takes NCHW float input and returns NCHW logits at the
    input size; in train mode ``(logits, None, None)``, BiSeNet's signature,
    whose ``aux`` it takes too: the model has no aux heads."""

    def __init__(self, num_classes=19, *, embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1), mlp_ratio=4, decoder_dim=768,
                 dtype=torch.float32):
        super().__init__()
        lengths = {len(embed_dims), len(depths), len(num_heads), len(sr_ratios)}
        if len(lengths) != 1:
            raise ValueError(f"MiT widths, depths, heads and ratios differ in length: {sorted(lengths)}")
        for dim, heads in zip(embed_dims, num_heads):
            if dim % heads:
                raise ValueError(f"MiT width {dim} is not a multiple of its {heads} heads")
        self.backbone = MixVisionTransformer(embed_dims, depths, num_heads, sr_ratios, mlp_ratio, dtype=dtype)
        self.decode_head = SegFormerHead(embed_dims, decoder_dim, num_classes, dtype=dtype)
        # the encoder's CUDA graphs by input (shape, strides, dtype): a plain
        # dict, so the graphed wrapper is no submodule and adds no state
        self._graphs = {}

    def forward(self, x, aux: bool = False):
        h, w = x.shape[2], x.shape[3]
        with span("segformer.encoder"), _attention_backends(x.device):
            feats = self._encode(x)
        with span("segformer.head"):
            logits = resize_bilinear(self.decode_head(feats), (h, w))
        return (logits, None, None) if self.training else logits

    def _encode(self, x) -> List[Tuple[torch.Tensor, HW]]:
        """The encoder's stages: eager, or on a card in a bf16 or fp16
        train-mode forward that records gradients, a replay of its graphs
        (module docstring)."""
        if not (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and self.training
                and torch.is_grad_enabled()):
            return self.backbone(x)
        key = (tuple(x.shape), x.stride(), x.dtype)
        if key not in self._graphs:
            # the module itself, its forward now the graphs' replay
            self._graphs[key] = torch.cuda.make_graphed_callables(_Stages(self.backbone), (x.detach().clone(),))
        stages = self._graphs[key]
        if stages.pending:  # its activations still wait for their backward
            return self.backbone(x)
        count("attention.calls", sum(self.backbone.depths))
        count("layernorm.fwd_calls", stages.norms)
        tokens = stages(x)
        stages.pending = True
        tokens[0].register_hook(stages.backward_reached)
        return list(zip(tokens, stages.grids))


class _Stages(nn.Module):
    """The encoder as a function of tensors alone, for its graphs: each
    stage's tokens (its grids kept aside, fixed by the input's shape)."""

    def __init__(self, backbone: MixVisionTransformer):
        super().__init__()
        self.backbone = backbone
        self.grids: List[HW] = []
        self.pending = False  # replayed, and the backward has not reached it
        self.norms = sum(isinstance(m, LayerNorm) for m in backbone.modules())  # each a call each way

    def backward_reached(self, grad):
        self.pending = False
        count("layernorm.bwd_calls", self.norms)

    def forward(self, x):
        feats = self.backbone(x)
        self.grids = [hw for _, hw in feats]
        return tuple(t for t, _ in feats)
