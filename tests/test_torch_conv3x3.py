"""The port's 3x3 / stride-1 conv (kernel K4) and its fused ConvBN against the
JAX package.

On the CPU the wrapper ``kernels/conv3x3.py::conv3x3`` runs the kernel's
plain PyTorch version; the CUDA kernel is held to that version on the card
(``tests/test_torch_cuda.py``, and ``chip_smoke.py`` at the serve paths'
shapes). Here the plain version is held to the JAX package on the same
numpy-seeded inputs:

- at pad 1 against the Pallas kernel ``conv3x3s1p1`` in interpret mode, at
  the shapes of ``tests/test_pallas_conv3.py``, with and without the fused
  scale / shift / ReLU epilogue, and its zero-border case;
- at odd H and W and at dilations 2 and 4 (padding = dilation), which the
  Pallas kernel does not take, against ``lax.conv_general_dilated`` on the
  bf16-rounded operands at f32 precision.

Tolerance: both sides round the operands to bf16 and add the exact products
in f32, so only the order of the sums differs: max |diff| <= 1e-5 *
max |ref| at f32 output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rtda_semanticsegmentation_tpu.ops.pallas_conv3 import conv3x3s1p1
from rtda_semanticsegmentation_tpu_torch.kernels import conv3x3 as k4
from rtda_semanticsegmentation_tpu_torch.models.layers import ConvBN, QuantPolicy, fold_kernel_operands


def assert_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def _case(seed, shape, co, x_dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(x_dtype)
    w = (rng.randn(3, 3, shape[-1], co) * 0.1).astype(np.float32)
    s = (rng.rand(co) + 0.5).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    return x, w, s, b


def _port(x, w, s=None, b=None, **kw):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return k4.conv3x3(t(x), t(w), t(s), t(b), out_dtype=torch.float32, **kw).numpy()


@pytest.mark.parametrize("shape,co,br", [((2, 8, 16, 16), 24, 4), ((1, 16, 8, 8), 8, 8),
                                         ((2, 12, 20, 32), 16, 6), ((1, 6, 6, 4), 4, 2)])
def test_plain_version_matches_pallas_k4(shape, co, br):
    x, w, _, _ = _case(0, shape, co)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # the JAX test's bf16 input
    ref = conv3x3s1p1(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), block_rows=br,
                      out_dtype=jnp.float32, interpret=True)
    assert_close(_port(x, w), ref)


@pytest.mark.parametrize("relu", [True, False])
def test_fused_epilogue_matches_pallas_k4(relu):
    x, w, s, b = _case(1, (2, 8, 12, 16), 8)
    ref = conv3x3s1p1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(b), block_rows=4,
                      relu=relu, out_dtype=jnp.float32, interpret=True)
    assert_close(_port(x, w, s, b, relu=relu), ref)
    # scale without shift: a zero shift on both sides
    ref = conv3x3s1p1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), block_rows=4, relu=relu,
                      out_dtype=jnp.float32, interpret=True)
    assert_close(_port(x, w, s, relu=relu), ref)


def test_bf16_output_matches_pallas_k4():
    """bf16 output: the f32 sums round once, so the two agree within one
    bf16 ulp of the reference plus 1e-5 * max |ref|."""
    x, w, s, b = _case(2, (2, 8, 16, 16), 24)
    ref = np.asarray(conv3x3s1p1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(b),
                                 block_rows=4, relu=True, interpret=True).astype(jnp.float32))
    got = k4.conv3x3(*(torch.from_numpy(a) for a in (x, w, s, b)), relu=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.ldexp(1.0, np.frexp(ref)[1] - 8)
    assert np.all(np.abs(got - ref) <= ulp + 1e-5 * np.abs(ref).max())


def test_zero_padding_borders():
    x = np.ones((1, 6, 6, 3), np.float32)
    w = np.ones((3, 3, 3, 1), np.float32)
    got = _port(x, w)
    ref = np.asarray(conv3x3s1p1(jnp.asarray(x), jnp.asarray(w), block_rows=2,
                                 out_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 0, 0, 0], got[0, 0, 3, 0], got[0, 3, 3, 0]) == (12.0, 18.0, 27.0)


def _lax_ref(x, w, s, b, d, relu):
    xb = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
    wb = jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)
    z = jax.lax.conv_general_dilated(xb, wb, (1, 1), ((d, d), (d, d)), rhs_dilation=(d, d),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     precision=jax.lax.Precision.HIGHEST)
    z = z * s + b
    return np.asarray(jnp.maximum(z, 0.0) if relu else z)


@pytest.mark.parametrize("shape,co,d", [((2, 9, 13, 16), 24, 1), ((1, 17, 33, 8), 19, 2),
                                        ((1, 9, 17, 16), 8, 4), ((2, 7, 5, 24), 5, 4)])
def test_odd_sizes_and_dilations_match_lax(shape, co, d):
    x, w, s, b = _case(3 + d, shape, co)
    for relu in (True, False):
        assert_close(_port(x, w, s, b, relu=relu, dilation=d), _lax_ref(x, w, s, b, d, relu))


def test_padded_weight_rows_are_read_as_the_kernel_reads_them():
    """A (3, 3, C, CO) view of weights padded to a wider CO: the layout the
    port's ConvBN hands K4 (CO = 19 padded to 24)."""
    x, w, s, b = _case(4, (1, 10, 14, 16), 19)
    wide = np.zeros((3, 3, 16, 24), np.float32)
    wide[..., :19] = w
    view = torch.from_numpy(wide)[..., :19]
    assert not view.is_contiguous() and k4._weight_row_stride(view) == 24
    got = k4.conv3x3(torch.from_numpy(x), view, torch.from_numpy(s), torch.from_numpy(b),
                     out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, _port(x, w, s, b))
    for bad in (torch.from_numpy(w)[..., ::2], torch.from_numpy(w).transpose(0, 1)):
        with pytest.raises(ValueError, match="unit stride"):
            k4._weight_row_stride(bad)


@pytest.mark.parametrize("bad", ["x_rank", "w_shape", "dtype", "out_dtype", "shift_alone",
                                 "scale_shape", "dilation", "device"])
def test_wrapper_argument_checks(bad):
    x = torch.zeros(1, 4, 5, 8)
    w = torch.zeros(3, 3, 8, 6)
    s = torch.ones(6)
    kw = {}
    if bad == "x_rank":
        x = x[0]
    elif bad == "w_shape":
        w = torch.zeros(1, 1, 8, 6)
    elif bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.int8
    elif bad == "shift_alone":
        kw["shift"] = s
    elif bad == "scale_shape":
        kw["scale"] = torch.ones(5)
    elif bad == "dilation":
        kw["dilation"] = 0
    elif bad == "device":
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        k4.conv3x3(x, w, **kw)


def _convbn(seed, cin, cout, d=1, relu=True):
    g = torch.Generator().manual_seed(seed)
    m = ConvBN(cin, cout, 3, 1, d, dilation=d, use_relu=relu, dtype=torch.bfloat16, fused_conv3=True)
    with torch.no_grad():
        m.conv.weight.copy_(torch.randn(m.conv.weight.shape, generator=g) * 0.1)
        m.bn.weight.copy_(torch.rand(cout, generator=g) + 0.5)
        m.bn.bias.copy_(torch.randn(cout, generator=g) * 0.1)
        m.bn.running_mean.copy_(torch.randn(cout, generator=g) * 0.1)
        m.bn.running_var.copy_(torch.rand(cout, generator=g) + 0.5)
    return m.eval()


@pytest.mark.parametrize("d,relu", [(1, True), (2, True), (4, False)])
def test_fused_convbn_is_k4_on_the_folded_batch_norm(d, relu):
    """The fused ConvBN's output is K4's on the BatchNorm folded into scale /
    shift (within one bf16 ulp: the padded weight view may change the CPU
    conv's order of sums), and agrees with the unfused bf16 ConvBN within
    bf16 rounding (that one rounds the conv to bf16 before the BatchNorm)."""
    m = _convbn(5 + d, 16, 19, d, relu)
    x = torch.randn(2, 16, 9, 13, generator=torch.Generator().manual_seed(d)).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="fold_kernel_operands"):
        m(x)
    fold_kernel_operands(m)
    assert m.k4_weight.shape == (3, 3, 16, 24) and m.k4_weight.dtype == torch.bfloat16
    assert "k4_weight" not in m.state_dict()  # non-persistent: the bridge never sees it
    got = m(x)
    inv = m.bn.weight * torch.rsqrt(m.bn.running_var + m.bn.eps)
    want = k4.conv3x3_plain(x.permute(0, 2, 3, 1), m.conv.weight.permute(2, 3, 1, 0), inv,
                            m.bn.bias - m.bn.running_mean * inv, relu=relu, dilation=d)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 19, 9, 13)
    got32, want32 = got.float(), want.permute(0, 3, 1, 2).float()
    ulp = torch.ldexp(torch.ones_like(want32), torch.frexp(want32)[1] - 8)
    assert bool(((got32 - want32).abs() <= ulp + 1e-5 * want32.abs().max()).all())
    m.fused = False  # the same module on F.conv2d and the BatchNorm
    ref = m(x).float()
    assert (got.float() - ref).abs().max().item() <= 0.02 * ref.abs().max().item()


def test_fused_convbn_refuses_what_k4_cannot_run():
    with pytest.raises(ValueError, match="bf16"):
        ConvBN(8, 8, 3, 1, 1, dtype=torch.float32, fused_conv3=True)
    with pytest.raises(ValueError, match="quantization"):
        ConvBN(128, 8, 3, 1, 1, dtype=torch.bfloat16, fused_conv3=True,
               quant=QuantPolicy("calib"), path="layer")
    m = _convbn(0, 8, 8)
    fold_kernel_operands(m)
    with pytest.raises(RuntimeError, match="eval path"):
        m.train()(torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16))
    # stride 2, 1x1 and padding != dilation stay on F.conv2d
    for args in ((3, 2, 1), (1, 1, 0), (3, 1, 2)):
        assert not ConvBN(8, 8, *args, dtype=torch.bfloat16, fused_conv3=True).fused


def test_launch_plan_at_the_serve_path_shapes():
    """The N tile of every K4 conv of the three serve paths
    (chip_smoke.CONV3_SHAPES, the port's bf16 weights with CO padded to 8):
    64 for CO = 64, 128 for 128-512, 24 for the FFMs' 19; no operand copy.
    f32 operands, C or a row stride off a multiple of 8, or a misaligned
    base take a bf16 copy."""
    bf = torch.bfloat16
    plans = {where: k4.launch_plan(c, co, -(-co // 8) * 8, bf, bf) for where, c, co, *_ in chip_smoke.CONV3_SHAPES}
    want = {where: ({19: 24, 64: 64}.get(co, 128), False, False) for where, c, co, *_ in chip_smoke.CONV3_SHAPES}
    assert plans == want and {n for n, *_ in plans.values()} == {24, 64, 128}
    assert k4.launch_plan(13, 19, 24, bf, bf) == (24, True, False)
    assert k4.launch_plan(24, 5, 5, torch.float32, torch.float32) == (24, True, True)
    assert k4.launch_plan(64, 200, 200, bf, bf, x_aligned=True, w_aligned=False) == (128, False, True)
