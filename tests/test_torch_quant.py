"""The port's int8 quantization primitives against the JAX package's
``ops/quant.py`` on the same numpy-seeded kernels, statistics and inputs.

Tolerances: elementwise ops compute the same f32 expressions, so codes,
``wq``, scales and the exact-max statistic match exactly. ``c`` holds an
f32 sum over kh*kw*ci terms (the bias correction) that the two frameworks
reduce in different orders: max |diff| <= 1e-6 * max |c|. The quantile
statistic interpolates the same sorted samples: rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.ops import quant as jq
from rtda_semanticsegmentation_tpu_torch.ops import quant as tq


def _kernel_and_stats(seed, kh=3, ci=64, co=48):
    rng = np.random.RandomState(seed)
    kernel = (rng.randn(kh, kh, ci, co) * np.logspace(-2, 0, co)).astype(np.float32)
    absmax = (rng.rand(ci) * 4 + 0.01).astype(np.float32)
    mean = (absmax * rng.rand(ci) * 0.3).astype(np.float32)
    return kernel, absmax, mean


@pytest.mark.parametrize("seed,kh,ci,co", [(0, 3, 64, 48), (1, 1, 128, 19), (2, 3, 256, 19)])
def test_freeze_weights_matches_jax(seed, kh, ci, co):
    kernel, absmax, mean = _kernel_and_stats(seed, kh, ci, co)
    wq_j, sw_j, c_j = (np.asarray(v) for v in jq.freeze_weights(
        jnp.asarray(kernel), jnp.asarray(absmax), jnp.asarray(mean)))
    wq, sw, c = (v.numpy() for v in tq.freeze_weights(
        torch.from_numpy(kernel), torch.from_numpy(absmax), torch.from_numpy(mean)))
    assert wq.dtype == np.int8 and wq.shape == (kh, kh, ci, co)
    np.testing.assert_array_equal(wq, wq_j)
    np.testing.assert_allclose(sw, sw_j, rtol=1e-6, atol=0)
    assert np.abs(c - c_j).max() <= 1e-6 * np.abs(c_j).max()


def test_quantize_act_unsigned_matches_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 7, 16) * 3).astype(np.float32)  # negatives clamp to -127
    absmax = np.abs(x).max(axis=(0, 1, 2)) * rng.uniform(0.5, 1.0, 16).astype(np.float32)
    want = np.asarray(jq.quantize_act_unsigned(jnp.asarray(x), jnp.asarray(absmax)))
    got = tq.quantize_act_unsigned(torch.from_numpy(x), torch.from_numpy(absmax)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("unsigned", [False, True])
def test_act_scale_matches_jax(unsigned):
    m = np.asarray([0.0, 1e-20, 0.5, 3.0, 1e4], np.float32)
    want = np.asarray(jq.act_scale(jnp.asarray(m), unsigned=unsigned))
    np.testing.assert_array_equal(tq.act_scale(torch.from_numpy(m), unsigned=unsigned).numpy(), want)


@pytest.mark.parametrize("q", [1.0, 0.999])
def test_calib_clip_channels_matches_jax(q):
    rng = np.random.RandomState(4)
    x = (np.abs(rng.standard_t(3, (2, 9, 11, 32))) * rng.rand(32)).astype(np.float32)
    want = np.asarray(jq.calib_clip_channels(jnp.asarray(x), q))
    got = tq.calib_clip_channels(torch.from_numpy(x), q).numpy()
    if q >= 1.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_calib_clip_channels_subsamples_the_same_pixels():
    """Past ``max_samples`` both take every step-th pixel of the (P, C) view."""
    rng = np.random.RandomState(5)
    x = np.abs(rng.randn(2, 16, 16, 8)).astype(np.float32)
    want = np.asarray(jq.calib_clip_channels(jnp.asarray(x), 0.9, max_samples=512))
    got = tq.calib_clip_channels(torch.from_numpy(x), 0.9, max_samples=512).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pad_zero_code_matches_jax():
    rng = np.random.RandomState(6)
    xq = rng.randint(-127, 128, (1, 4, 5, 3)).astype(np.int8)
    want = np.asarray(jq.pad_zero_code(jnp.asarray(xq), ((1, 1), (1, 1))))
    got = tq.pad_zero_code(torch.from_numpy(xq), 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == -127).all() and (got[:, :, -1] == -127).all()
