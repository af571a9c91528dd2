"""The port's serving upsample against the JAX package's fused
``ops/upsample.py::upsample_bilinear_argmax``.

The JAX package's phase-form upsample + argmax is a TPU rearrangement of
``argmax(resize_bilinear(logits))``; the port serves that plain form
(``models/layers.py::resize_bilinear``, ``F.interpolate`` with half-pixel
centres, then ``torch.argmax`` in ``serving.py``). These tests hold the
plain form against the JAX op on ``tests/test_upsample.py``'s factors and
shapes, so the port computes what the JAX op computes.

Tolerances, each with its reason:

- the interpolated field against JAX's ``_interp_axis`` field, and at a
  non-integer factor against ``jax.image.resize``: atol and rtol 1e-5, the
  JAX test's (f32, the same two-tap sums written another way);
- the predictions: equal to JAX's at every pixel (f32 inputs whose top two
  interpolated values are apart; the draws are seeded), and from bf16
  logits (the port interpolates them in bf16, the JAX op in f32) at more
  than 0.99 of the pixels, the JAX test's bar for near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu.ops.upsample import _interp_axis as jinterp_axis
from rtda_semanticsegmentation_tpu.ops.upsample import upsample_bilinear_argmax as jupsample
from rtda_semanticsegmentation_tpu_torch.models.layers import resize_bilinear

FACTORS = [(8, 8), (2, 2), (4, 2), (1, 8)]


def _serve_argmax(x: torch.Tensor, out_hw) -> torch.Tensor:
    """The port's serving head on NCHW logits: the resize, then the argmax."""
    return torch.argmax(resize_bilinear(x, out_hw), dim=1)


@pytest.mark.parametrize("fh,fw", FACTORS)
def test_field_matches_jax_and_interpolate(fh, fw):
    x = np.random.RandomState(0).randn(2, 5, 7, 4).astype(np.float32)
    b, h, w, c = x.shape
    want = jinterp_axis(jinterp_axis(jnp.asarray(x), 1, fh), 3, fw).reshape(b, h * fh, w * fw, c)
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (h * fh, w * fw))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [((2, 6, 10, 19), (48, 80)), ((1, 8, 16, 19), (64, 128)),
                                          ((2, 5, 7, 4), (10, 56)), ((1, 4, 4, 3), (4, 4))])
def test_predictions_match_jax_and_the_plain_version(shape, out_hw):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = np.asarray(jupsample(jnp.asarray(x), out_hw))
    got = _serve_argmax(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    assert tuple(got.shape) == (shape[0], *out_hw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_logits_high_agreement_with_jax():
    x = np.random.RandomState(3).randn(2, 8, 8, 19).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jupsample(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), (64, 64)))
    got = _serve_argmax(xb.permute(0, 3, 1, 2), (64, 64)).numpy()
    assert (got == want).mean() > 0.99


def test_first_class_wins_a_tie():
    x = torch.zeros(1, 5, 3, 3)
    x[:, 2] = x[:, 4] = 1.0
    assert (_serve_argmax(x, (24, 24)) == 2).all()


def test_non_integer_factor_matches_jax_resize():
    """Where the JAX op raises (a factor that is not an integer: DeepLabV2's
    9 x 17 logits to 65 x 129), the port's resize is ``jax.image.resize``'s."""
    x = np.random.RandomState(4).randn(1, 9, 17, 5).astype(np.float32)
    with pytest.raises(ValueError, match="integer factors"):
        jupsample(jnp.asarray(x), (65, 129))
    want = jax.image.resize(jnp.asarray(x), (1, 65, 129, 5), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (65, 129))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
