"""The port's s8 conv (kernel K3) against the JAX package.

On the CPU the wrapper ``kernels/int8_conv.py::int8_conv`` runs the
kernel's plain PyTorch version; the CUDA kernel matches that version bit for
bit on the card (``tests/test_torch_cuda.py``, and ``chip_smoke.py``
at the slice's shapes). Here the plain version is held to
the JAX package's own references on the same numpy-seeded codes:

- at 3x3/s1/p1 against the Pallas kernel ``int8_conv3x3s1p1`` in interpret
  mode, mirroring ``tests/test_pallas_conv_int8.py`` (bf16 and requantized
  s8 outputs);
- at 3x3/s2/p1 and 1x1/s2/p0, CO=19 included, against
  ``ops/quant.py::int8_conv_frozen`` (XLA's s8 conv, exact on the CPU).

Without JAX: the kernel's weight operands (``kmajor_weights``, folded into
each frozen ``QuantConv``), the border correction its epilogue adds to a
zero-filled conv to restore the -127 pad, and the launch plan at the serve
path's shapes.

Tolerance: none. Accumulators are integers and the epilogue rounds each f32
operation the same way on both sides, so outputs and codes are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from rtda_semanticsegmentation_tpu.ops import quant as jq
from rtda_semanticsegmentation_tpu.ops.pallas_conv_int8 import int8_conv3x3s1p1
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
from rtda_semanticsegmentation_tpu_torch.models.layers import QuantConv, fold_kernel_operands
from rtda_semanticsegmentation_tpu_torch.ops import quant as tq


def _case(seed, B=2, H=16, W=32, C=64, CO=128):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (B, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, C, CO)).astype(np.int8)
    a = rng.rand(CO).astype(np.float32) * 0.01
    b = rng.randn(CO).astype(np.float32) * 0.1
    inv = (rng.rand(CO).astype(np.float32) + 0.5) * 50
    return xq, wq, a, b, inv


def _port(xq, wq, a, b, inv=None, **kw):
    t = torch.from_numpy
    out = k3.int8_conv(t(xq), t(wq), t(a), t(b), None if inv is None else t(inv), **kw)
    return out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy()


def _pallas(xq, wq, a, b, inv=None, relu=True):
    out = int8_conv3x3s1p1(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(a), jnp.asarray(b),
                           None if inv is None else jnp.asarray(inv), relu=relu, interpret=True)
    return np.asarray(out.astype(jnp.float32) if out.dtype == jnp.bfloat16 else out)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_output_matches_pallas_k3_exactly(seed):
    xq, wq, a, b, _ = _case(seed)
    got = _port(xq, wq, a, b, stride=1, padding=1, relu=True, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, _pallas(xq, wq, a, b))


def test_s8_requantized_output_matches_pallas_k3_exactly():
    xq, wq, a, b, inv = _case(2)
    got = _port(xq, wq, a, b, inv, stride=1, padding=1, relu=True)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, _pallas(xq, wq, a, b, inv))


def test_no_relu_bf16_output_matches_pallas_k3_exactly():
    xq, wq, a, b, _ = _case(3, C=128, CO=64)
    got = _port(xq, wq, a, b, stride=1, padding=1, relu=False, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, _pallas(xq, wq, a, b, relu=False))


def test_requant_without_relu_raises():
    xq, wq, a, b, inv = _case(4)
    with pytest.raises(ValueError, match="relu"):
        _port(xq, wq, a, b, inv, stride=1, padding=1, relu=False)


# (kernel, stride, pad, C, CO): the strided and 1x1 shapes of BiSeNet-R18's
# quantized convs, narrowed, and the ragged CO=19 of the FFM conv
STRIDED = [(3, 2, 1, 32, 48), (1, 2, 0, 32, 48), (3, 1, 1, 64, 19), (3, 2, 1, 64, 19)]


def _jax_frozen(x, wq, sw, c, absmax, k, s, p):
    out = jq.int8_conv_frozen(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(c), jnp.asarray(absmax),
        (s, s), ((p, p), (p, p)), out_dtype=jnp.float32,
    )
    return np.asarray(out)


@pytest.mark.parametrize("k,s,p,C,CO", STRIDED)
def test_accumulator_matches_xla_s8_conv_exactly(k, s, p, C, CO):
    """Unit epilogue (a=1, b=0, f32 out) exposes the raw s32 accumulator;
    codes go in as values 0..254 on the unsigned grid (absmax 254)."""
    rng = np.random.RandomState(10 + k + s + C)
    codes = rng.randint(0, 255, (2, 15, 17, C)).astype(np.float32)
    wq = rng.randint(-127, 128, (k, k, C, CO)).astype(np.int8)
    ones, zeros = np.ones(CO, np.float32), np.zeros(CO, np.float32)
    absmax = np.full(C, 254.0, np.float32)
    want = _jax_frozen(codes, wq, ones, zeros, absmax, k, s, p)
    got = tq.int8_conv_frozen(torch.from_numpy(codes), torch.from_numpy(wq), torch.from_numpy(ones),
                              torch.from_numpy(zeros), torch.from_numpy(absmax), (s, s),
                              ((p, p), (p, p)), out_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,s,p,C,CO", STRIDED)
def test_frozen_conv_matches_jax_int8_conv_frozen_exactly(k, s, p, C, CO):
    """Float input through the quantizer, the zero-code pad and the
    ``acc * sw + c`` epilogue, against the JAX frozen conv."""
    rng = np.random.RandomState(20 + k + s + C)
    x = np.abs(rng.randn(2, 15, 17, C)).astype(np.float32) * rng.rand(C).astype(np.float32)
    absmax = np.abs(x).max(axis=(0, 1, 2))
    wq = rng.randint(-127, 128, (k, k, C, CO)).astype(np.int8)
    sw = (rng.rand(CO).astype(np.float32) + 0.5) * 1e-3
    c = rng.randn(CO).astype(np.float32)
    want = _jax_frozen(x, wq, sw, c, absmax, k, s, p)
    t = torch.from_numpy
    got = tq.int8_conv_frozen(t(x), t(wq), t(sw), t(c), t(absmax), (s, s), ((p, p), (p, p)),
                              out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensor_takes_plain_version_without_counting_a_launch():
    xq, wq, a, b, _ = _case(5, C=16, CO=8)
    before = k3.launches
    got = _port(xq, wq, a, b, stride=2, padding=1, relu=True, out_dtype=torch.float32)
    assert got.shape == (2, 8, 16, 8)
    assert k3.launches == before


def test_wrapper_rejects_bad_operands():
    xq, wq, a, b, _ = _case(6, C=16, CO=8)
    t = torch.from_numpy
    with pytest.raises(TypeError):
        k3.int8_conv(t(xq).float(), t(wq), t(a), t(b), stride=1, padding=1, relu=True)
    with pytest.raises(ValueError, match="channels"):
        k3.int8_conv(t(xq)[..., :8], t(wq), t(a), t(b), stride=1, padding=1, relu=True)
    with pytest.raises(ValueError, match="f32"):
        k3.int8_conv(t(xq), t(wq), t(a)[:4], t(b), stride=1, padding=1, relu=True)


def _s32_conv(xq, wq, stride):
    """The exact integer conv of unpadded s8 codes, as int64 (f64 sums of
    integers far below 2**53)."""
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.permute(3, 2, 0, 1).double()
    return torch.round(F.conv2d(x, w, stride=stride)).to(torch.int64).permute(0, 2, 3, 1)


# (kernel, stride, pad, H, W): 3x3/s1/p1, 3x3/s2/p1 on odd H and W, 1x1/s2/p0
BORDER = [(3, 1, 1, 6, 9), (3, 2, 1, 7, 11), (3, 2, 1, 9, 5), (1, 2, 0, 7, 9)]


@pytest.mark.parametrize("k,s,p,H,W", BORDER)
def test_border_correction_turns_the_zero_filled_conv_into_the_zero_code_padded_one(k, s, p, H, W):
    """What the kernel computes (TMA fills the border with 0) plus the
    epilogue's correction equals the -127-padded conv exactly, at B = 2."""
    rng = np.random.RandomState(40 + k + s + H)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, H, W, 13)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (k, k, 13, 19)).astype(np.int8))
    zero_filled = _s32_conv(F.pad(xq, (0, 0, p, p, p, p)), wq, s)
    padded = _s32_conv(k3.pad_zero_code(xq, p), wq, s)
    _, colsum = k3.kmajor_weights(wq)
    corr = k3.zero_code_border_correction(colsum, H, W, k, k, s, p)
    assert corr.dtype == torch.int64 and corr.shape == padded.shape[1:]
    assert torch.equal(zero_filled + corr, padded)
    assert bool(corr.any()) == (p > 0)


def test_kmajor_weights_are_wq_permuted_and_summed():
    wq = torch.from_numpy(np.random.RandomState(7).randint(-127, 128, (3, 3, 13, 19)).astype(np.int8))
    wk, colsum = k3.kmajor_weights(wq)
    assert wk.dtype == torch.int8 and wk.shape == (19, 9, 16)  # C padded to 16
    assert torch.equal(wk[..., :13], wq.permute(3, 0, 1, 2).reshape(19, 9, 13))
    assert not wk[..., 13:].any()
    assert colsum.dtype == torch.int32 and colsum.shape == (9, 19)
    assert torch.equal(colsum.long(), wq.long().sum(dim=2).reshape(9, 19))


def test_frozen_quant_conv_folds_its_kernel_weights():
    """``fold_kernel_operands`` gives each frozen QuantConv the K-major copy
    of its loaded ``wq``, in non-persistent buffers the bridge never sees,
    and the conv's output does not change."""
    m = QuantConv(16, 19, 3, 1, 1, mode="int8_frozen", relu=True)
    rng = np.random.RandomState(8)
    with torch.no_grad():
        m.wq.copy_(torch.from_numpy(rng.randint(-127, 128, (3, 3, 16, 19)).astype(np.int8)))
        m.a.copy_(torch.from_numpy(rng.rand(19).astype(np.float32) * 1e-4))
        m.in_absmax.fill_(3.0)
    x = torch.from_numpy(rng.rand(2, 16, 5, 7).astype(np.float32) * 3.0)
    before = m(x)
    fold_kernel_operands(m)
    wk, colsum = k3.kmajor_weights(m.wq)
    assert torch.equal(m.k3_weight, wk) and torch.equal(m.k3_colsum, colsum)
    assert "k3_weight" not in m.state_dict() and "k3_colsum" not in m.state_dict()
    assert torch.equal(m(x), before)


@pytest.mark.parametrize("change", ["load", "replace"])
def test_frozen_quant_conv_refuses_weights_changed_after_the_fold(change):
    """Weights loaded into ``wq`` (in place) or a new ``wq`` after the fold
    would leave K3's copy stale: the forward raises until the model is
    folded again, and then serves the new weights."""
    m = QuantConv(16, 8, 3, 1, 1, mode="int8_frozen", relu=False)
    rng = np.random.RandomState(9)
    with torch.no_grad():
        m.a.fill_(1e-3)
        m.in_absmax.fill_(3.0)
    fold_kernel_operands(m)
    x = torch.from_numpy(rng.rand(1, 16, 4, 6).astype(np.float32) * 3.0)
    before = m(x)
    new = torch.from_numpy(rng.randint(-127, 128, (3, 3, 16, 8)).astype(np.int8))
    if change == "load":
        m.load_state_dict(dict(m.state_dict(), wq=new))
    else:
        m.wq = new
    with pytest.raises(RuntimeError, match="fold_kernel_operands"):
        m(x)
    fold_kernel_operands(m)
    assert torch.equal(m.k3_weight, k3.kmajor_weights(new)[0])
    assert not torch.equal(m(x), before)


def test_launch_plan_at_the_serve_path_shapes():
    """The N tile of every quantized conv of BiSeNet-R18 (chip_smoke.SHAPES):
    128 (CO >= 128) and 24 for the FFM's CO = 19; no copy of xq (C a
    multiple of 16). C = 13 or a misaligned xq takes the padded copy."""
    plans = {where: k3.launch_plan(cin, cout) for where, cin, cout, *_ in chip_smoke.SHAPES}
    assert plans == {where: (24 if cout == 19 else 128, False) for where, cin, cout, *_ in chip_smoke.SHAPES}
    assert k3.launch_plan(13, 19) == (24, True) and k3.launch_plan(64, 48) == (128, False)
    assert k3.launch_plan(128, 128, x_aligned=False) == (128, True)
