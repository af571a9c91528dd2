"""SegFormer (Xie et al., arXiv:2105.15203) as NVlabs' SegFormer repository
configures it: the Mix Transformer encoder (MiT) and the all-MLP decoder.

Per stage ``i`` of width ``C``, ``h`` heads of ``d = C / h`` and
spatial-reduction ratio ``r``, on the ``N`` tokens of an overlapping patch
embedding (7x7 / stride 4, then 3x3 / stride 2; padding k // 2; a
LayerNorm):

- ``x = x + proj(softmax(q k^T / sqrt(d)) v)``, ``q = q(LN1 x)``, ``k, v =
  kv(LN_sr(Conv_{r x r, stride r}(LN1 x)))`` (no reduction at ``r = 1``);
- ``x = x + fc2(GELU(DWConv3x3(fc1(LN2 x))))``, ``fc1`` widening ``C`` to
  ``mlp_ratio * C``, the exact (erf) GELU;
- a LayerNorm ends the stage. Block and stage norms take eps 1e-6, the
  patch embeddings' and the reduction's 1e-5.

The head maps each stage to ``decoder_dim`` with a ``Linear``, resizes
stages 2-4 bilinearly (half-pixel) to 1/4, concatenates ``[c4, c3, c2,
c1]``, runs a bias-free 1x1 conv, BatchNorm and ReLU, then a 1x1 conv to
the classes, and resizes the logits to the input.

Departures, shared with the system under test: drop-path and dropout are
0; weights are drawn from the seed (``Linear`` N(0, 0.02) through the
configuration's ``init`` patterns, convs Kaiming fan-in; LayerNorms and
BatchNorm at 1 and 0). Attention is written out, its score matrix whole.
The depthwise conv is written out too, as the sum of its nine taps, each a
shifted view of the padded input times its channels' weights: the same
arithmetic as ``F.conv2d(..., groups=C)``, whose weight gradient
``FlopCounterMode`` counts as a dense conv's (C times over: it takes no
notice of the groups), which would put the step's FLOPs (``costs/flops.py``)
at three times the model's. Written out, the taps count no FLOPs: the
step's count leaves out the depthwise convs' 0.068 TFLOP of its 11.5. The
float32 train step at b8 512x1024 saves about 40 GB of activations for its
backward (counted on ``meta``), so it runs whole, with no recompute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench.reference.nets import Shapes, add_bn, add_conv, conv
from h100_bench.reference.ops import batch_norm, upsample

OPTIMIZER_SKIPS = ()
BLOCK_EPS, EMBED_EPS = 1e-6, 1e-5


def init_rule(name, shape):
    """Kernels and ``Linear`` weights drawn; LayerNorm and BatchNorm scales
    and running variances 1; biases and running means 0."""
    if len(shape) >= 2:
        return None
    if name.endswith(("weight", "running_var")):
        return 1.0
    if name.endswith(("bias", "running_mean")):
        return 0.0
    raise ValueError(f"no init rule for {name} {shape}")


def _stages(model):
    return list(zip(model["mit_embed_dims"], model["mit_depths"], model["mit_num_heads"], model["mit_sr_ratios"]))


def _add_linear(out: Shapes, name, cin, cout):
    out.append((f"{name}.weight", (cout, cin)))
    out.append((f"{name}.bias", (cout,)))


def _add_ln(out: Shapes, name, c):
    out.append((f"{name}.weight", (c,)))
    out.append((f"{name}.bias", (c,)))


def param_shapes(model: dict, train: bool = False) -> Shapes:
    out: Shapes = []
    cin, hidden = 3, model["mit_mlp_ratio"]
    for i, (c, depth, _, sr) in enumerate(_stages(model)):
        p = f"backbone.patch_embed{i + 1}"
        add_conv(out, f"{p}.proj", cin, c, 7 if i == 0 else 3)
        _add_ln(out, f"{p}.norm", c)
        for j in range(depth):
            b = f"backbone.block{i + 1}.{j}"
            _add_ln(out, f"{b}.norm1", c)
            _add_linear(out, f"{b}.attn.q", c, c)
            _add_linear(out, f"{b}.attn.kv", c, 2 * c)
            _add_linear(out, f"{b}.attn.proj", c, c)
            if sr > 1:
                add_conv(out, f"{b}.attn.sr", c, c, sr)
                _add_ln(out, f"{b}.attn.norm", c)
            _add_ln(out, f"{b}.norm2", c)
            _add_linear(out, f"{b}.mlp.fc1", c, hidden * c)
            out.append((f"{b}.mlp.dwconv.weight", (hidden * c, 1, 3, 3)))
            out.append((f"{b}.mlp.dwconv.bias", (hidden * c,)))
            _add_linear(out, f"{b}.mlp.fc2", hidden * c, c)
        _add_ln(out, f"backbone.norm{i + 1}", c)
        cin = c
    dims, e = model["mit_embed_dims"], model["decoder_dim"]
    for i in reversed(range(len(dims))):
        _add_linear(out, f"decode_head.linear_c{i + 1}", dims[i], e)
    out.append(("decode_head.linear_fuse.conv.weight", (e, len(dims) * e, 1, 1)))
    add_bn(out, "decode_head.linear_fuse.bn", e)
    add_conv(out, "decode_head.linear_pred", e, model["num_classes"], 1)
    return out


def _ln(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def _map(x, hw):
    """(B, N, C) tokens as a (B, C, H, W) map."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *hw)


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


def _block(P, b, x, hw, heads, sr):
    bsz, n, c = x.shape
    d = c // heads
    y = _ln(P, f"{b}.norm1", x, BLOCK_EPS)
    q = _linear(P, f"{b}.attn.q", y).reshape(bsz, n, heads, d).transpose(1, 2)
    if sr > 1:
        y = _tokens(conv(_map(y, hw), P[f"{b}.attn.sr.weight"], P[f"{b}.attn.sr.bias"], sr))
        y = _ln(P, f"{b}.attn.norm", y, EMBED_EPS)
    kv = _linear(P, f"{b}.attn.kv", y).reshape(bsz, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    attn = torch.softmax((q @ k.transpose(-2, -1)) * d ** -0.5, dim=-1)
    y = (attn @ v).transpose(1, 2).reshape(bsz, n, c)
    x = x + _linear(P, f"{b}.attn.proj", y)
    y = _linear(P, f"{b}.mlp.fc1", _ln(P, f"{b}.norm2", x, BLOCK_EPS))
    y = _tokens(_depthwise3x3(_map(y, hw), P[f"{b}.mlp.dwconv.weight"], P[f"{b}.mlp.dwconv.bias"]))
    return x + _linear(P, f"{b}.mlp.fc2", F.gelu(y))


def _depthwise3x3(x, w, bias):
    """3x3 / stride-1 / padding-1 conv of each channel with its own kernel
    ``w`` (C, 1, 3, 3): the nine taps summed (module docstring). Each tap
    scales the whole padded input and then takes its shifted window, so the
    backward keeps the padded input once, however the fp8 control rounds
    each result."""
    h, wd = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    y = bias.view(1, -1, 1, 1)
    for i in range(3):
        for j in range(3):
            y = y + (xp * w[:, 0, i, j].view(1, -1, 1, 1))[:, :, i:i + h, j:j + wd]
    return y


def encoder(P, x, model):
    """Each stage's (tokens, (H, W))."""
    out = []
    for i, (c, depth, heads, sr) in enumerate(_stages(model)):
        p = f"backbone.patch_embed{i + 1}"
        k = 7 if i == 0 else 3
        y = conv(x, P[f"{p}.proj.weight"], P[f"{p}.proj.bias"], 4 if i == 0 else 2, k // 2)
        hw = tuple(y.shape[2:])
        t = _ln(P, f"{p}.norm", _tokens(y), EMBED_EPS)
        for j in range(depth):
            t = _block(P, f"backbone.block{i + 1}.{j}", t, hw, heads, sr)
        t = _ln(P, f"backbone.norm{i + 1}", t, BLOCK_EPS)
        out.append((t, hw))
        x = _map(t, hw)
    return out


def generator(P, stats, train, x, model, momentum=0.9):
    feats = encoder(P, x, model)
    hw1 = feats[0][1]
    maps = []
    for i in reversed(range(len(feats))):
        t, hw = feats[i]
        y = _map(_linear(P, f"decode_head.linear_c{i + 1}", t), hw)
        maps.append(y if hw == hw1 else upsample(y, hw1))
    y = conv(torch.cat(maps, dim=1), P["decode_head.linear_fuse.conv.weight"])
    y = F.relu(batch_norm(y, P, "decode_head.linear_fuse.bn", train, stats, momentum))
    y = conv(y, P["decode_head.linear_pred.weight"], P["decode_head.linear_pred.bias"])
    return upsample(y, x.shape[2:])
