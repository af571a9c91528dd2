"""The port's 4x4/s2/p1 conv kernels' plain versions (K5a forward, K5b
weight gradient, K5c input gradient) and their autograd Function against
the JAX package's Pallas kernels, run in interpret mode as
``tests/test_pallas_conv.py`` runs them.

Shapes: ``tests/test_pallas_conv.py``'s, the odd (1, 12, 20, 7) case
included, NHWC/HWIO on the JAX side and NCHW/OIHW in the port.

Tolerance: both sides round the operands to bf16 and add the exact
products in f32, so only the order of the sums differs:
max |diff| <= 1e-5 * max |ref| at f32 output, and at bf16 output one bf16
ulp of the reference plus that (two f32 sums a few ulps apart can round to
neighbouring bf16 values, and an output that cancels to far below its
terms moves by more than its own ulp before it is rounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.ops.pallas_conv import (
    conv4x4s2p1,
    conv4x4s2p1_dw,
    conv4x4s2p1_dx,
    fused_conv4x4s2p1,
)
from rtda_semanticsegmentation_tpu_torch.kernels import conv4x4 as kc

FWD_SHAPES = [((2, 16, 32, 19), 64), ((1, 8, 8, 3), 5), ((2, 32, 64, 19), 64), ((1, 12, 20, 7), 16)]
BWD_SHAPES = [((2, 16, 32, 19), 64), ((1, 8, 8, 3), 5), ((2, 32, 64, 7), 16), ((1, 12, 20, 7), 16)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def assert_close(got, ref, dtype: str):
    """The module's tolerance, on numpy arrays (bf16 values upcast to f32)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    f32_tol = 1e-5 * np.max(np.abs(ref))
    if dtype == "bfloat16":
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64) * 2.0**16
        assert np.all(np.abs(got - ref) <= ulp + f32_tol), np.max(np.abs(got - ref) - ulp)
    else:
        assert np.max(np.abs(got - ref)) <= f32_tol


def _nchw(a) -> torch.Tensor:
    """A JAX NHWC array -> a port NCHW tensor of the same dtype, exactly."""
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).permute(0, 3, 1, 2).contiguous()
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w, np.float32)).permute(3, 2, 0, 1).contiguous()


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _case(shape, co, x_dtype, seed):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.rand(*shape), x_dtype)
    w = jnp.asarray(rng.randn(4, 4, shape[-1], co) * 0.1, jnp.float32)
    dy = jnp.asarray(rng.randn(shape[0], shape[1] // 2, shape[2] // 2, co), x_dtype)
    return x, w, dy


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co", FWD_SHAPES)
def test_forward_plain_matches_pallas(shape, co, out_dtype):
    jdt, tdt = DTYPES[out_dtype]
    x, w, _ = _case(shape, co, jnp.bfloat16, 0)
    ref = conv4x4s2p1(x, w, block_rows=4, chunk=2, out_dtype=jdt, interpret=True)
    got = kc.conv4x4s2p1(_nchw(x), _oihw(w), tdt)
    assert got.dtype == tdt
    assert_close(_to_nhwc(got), jnp.asarray(ref, jnp.float32), out_dtype)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co", BWD_SHAPES)
def test_weight_grad_plain_matches_pallas(shape, co, x_dtype):
    """f32 result; f32 operands are rounded to bf16 on both sides."""
    x, w, dy = _case(shape, co, DTYPES[x_dtype][0], 1)
    ref = conv4x4s2p1_dw(x, dy, block_rows=4, chunk=2, interpret=True)
    got = kc.conv4x4s2p1_dw(_nchw(x), _nchw(dy))
    assert got.dtype == torch.float32 and tuple(got.shape) == (co, shape[-1], 4, 4)
    assert_close(got.permute(2, 3, 1, 0).numpy(), ref, "float32")


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co", BWD_SHAPES)
def test_input_grad_plain_matches_pallas(shape, co, out_dtype):
    jdt, tdt = DTYPES[out_dtype]
    _, w, dy = _case(shape, co, jnp.float32, 2)
    ref = conv4x4s2p1_dx(dy, w, block_rows=4, chunk=2, out_dtype=jdt, interpret=True)
    got = kc.conv4x4s2p1_dx(_nchw(dy), _oihw(w), tdt)
    assert got.dtype == tdt
    assert_close(_to_nhwc(got), jnp.asarray(ref, jnp.float32), out_dtype)


def test_zero_padding_edges():
    """Border outputs see zeros outside the image, exactly: the corner window
    has 3x3 of its 16 taps inside (9 * 2 channels), the interior all 16."""
    x = jnp.ones((1, 8, 8, 2), jnp.float32)
    w = jnp.ones((4, 4, 2, 1), jnp.float32)
    ref = np.asarray(conv4x4s2p1(x, w, block_rows=4, chunk=2, out_dtype=jnp.float32, interpret=True))
    got = _to_nhwc(kc.conv4x4s2p1(_nchw(x), _oihw(w), torch.float32))
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 0, 0] == 18.0 and got[0, 1, 1, 0] == 32.0


def test_fused_function_grads_match_jax():
    """``jax.grad`` through ``fused_conv4x4s2p1`` (interpret) and
    ``backward`` through the port's Function, f32, at the module's
    tolerance."""
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.rand(1, 16, 16, 5), jnp.float32)
    w = jnp.asarray(rng.randn(4, 4, 5, 8) * 0.1, jnp.float32)
    dy_w = jnp.asarray(rng.randn(1, 8, 8, 8), jnp.float32)

    def loss(x, w):
        return jnp.sum(fused_conv4x4s2p1(x, w, 8, 4, jnp.float32, True) * dy_w)

    gx, gw = jax.grad(loss, argnums=(0, 1))(x, w)
    tx = _nchw(x).requires_grad_(True)
    tw = _oihw(w).requires_grad_(True)
    y = kc.fused_conv4x4s2p1(tx, tw, torch.float32)
    assert_close(_to_nhwc(y.detach()), conv4x4s2p1(x, w, out_dtype=jnp.float32, interpret=True), "float32")
    (y * _nchw(dy_w)).sum().backward()
    assert_close(_to_nhwc(tx.grad), gx, "float32")
    assert_close(tw.grad.permute(2, 3, 1, 0).numpy(), gw, "float32")


@pytest.mark.parametrize("x_grad,w_grad", [(True, True), (True, False), (False, True)])
def test_fused_function_runs_only_the_needed_backward(x_grad, w_grad, monkeypatch):
    """The backward calls the dW wrapper only when ``w`` needs a gradient
    and the dx wrapper only when ``x`` does (the D step needs dW alone, G's
    path through D dx alone)."""
    calls = []
    before = (kc.fwd_launches, kc.dw_launches, kc.dx_launches)
    for name in ("conv4x4s2p1_dw", "conv4x4s2p1_dx"):
        fn = getattr(kc, name)
        monkeypatch.setattr(kc, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    x = torch.rand(2, 3, 8, 10, requires_grad=x_grad)
    w = (torch.randn(4, 3, 4, 4) * 0.1).requires_grad_(w_grad)
    kc.fused_conv4x4s2p1(x, w, torch.float32).sum().backward()
    assert sorted(calls) == sorted(["conv4x4s2p1_dx"] * x_grad + ["conv4x4s2p1_dw"] * w_grad)
    assert (x.grad is not None) == x_grad and (w.grad is not None) == w_grad
    assert (kc.fwd_launches, kc.dw_launches, kc.dx_launches) == before  # CPU: plain versions only


def test_wrappers_reject_what_the_kernels_do_not_take():
    w = torch.zeros(4, 3, 4, 4)
    with pytest.raises(ValueError, match="H and W even"):
        kc.conv4x4s2p1(torch.zeros(1, 3, 7, 8), w)
    with pytest.raises(ValueError, match="w must be"):
        kc.conv4x4s2p1(torch.zeros(1, 3, 8, 8), torch.zeros(4, 2, 4, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kc.conv4x4s2p1(torch.zeros(1, 3, 8, 8, device="meta"), w.to("meta"))


def _plan_tiles(kind, b, h, w):
    """K5a and K5b: tiles of 2 output rows x 64 columns; K5c: 2 pairs of
    input rows (rows 2i - 1, 2i for i = 0 .. H/2) x 128 dy columns."""
    if kind == "dx":
        return b * -(-(h // 2 + 1) // 2) * -(-(w // 2) // 128)
    return b * -(-h // 4) * -(-(w // 2) // 64)


@pytest.mark.parametrize("kind", ["fwd", "dw", "dx"])
def test_launch_plan_copies_only_what_tma_cannot_read(kind):
    """The flagship's bf16 maps (8 x 19 x 720x1280 and 512x1024) take no
    copy; an f32 x or dy, a misaligned base or a row that is not a multiple
    of 16 bytes (bf16 W = 300 or 20, and their y and dy rows of 150 and 10)
    does. K5c's x is its output dx: written padded where its bf16 row is off
    the rule, never copied for being f32 or for its base (the wrapper makes
    it)."""
    bf, f32 = torch.bfloat16, torch.float32
    dx = kind == "dx"
    for h, w in ((720, 1280), (512, 1024)):
        assert kc.launch_plan(kind, (8, 19, h, w), bf, bf) == (_plan_tiles(kind, 8, h, w), False, False)
    assert kc.launch_plan(kind, (1, 19, 2, 2), bf, bf)[0] == 1  # B = 1, H = 2
    assert kc.launch_plan(kind, (1, 19, 36, 300), bf, bf) == (_plan_tiles(kind, 1, 36, 300), True, True)
    assert kc.launch_plan(kind, (1, 7, 12, 20), bf, bf) == (_plan_tiles(kind, 1, 12, 20), True, True)
    assert kc.launch_plan(kind, (2, 19, 64, 96), f32, bf)[1:] == (not dx, False)
    assert kc.launch_plan(kind, (2, 19, 64, 96), bf, bf, x_aligned=False)[1:] == (not dx, False)
    # K5a writes an f32 y by TMA when its row of W/2 is a multiple of 4; K5b
    # and K5c copy an f32 dy to bf16, and a misaligned one
    other = kc.launch_plan(kind, (2, 19, 64, 104), bf, f32)[2]
    assert other == (kind != "fwd")
    assert kc.launch_plan(kind, (2, 19, 64, 96), bf, bf, other_aligned=False)[2] == (kind != "fwd")
    with pytest.raises(ValueError, match="kind"):
        kc.launch_plan("dy", (2, 19, 64, 96), bf, bf)
