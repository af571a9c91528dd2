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

Tolerance: none. Accumulators are integers and the epilogue rounds each f32
operation the same way on both sides, so outputs and codes are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.ops import quant as jq
from rtda_semanticsegmentation_tpu.ops.pallas_conv_int8 import int8_conv3x3s1p1
from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3
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

