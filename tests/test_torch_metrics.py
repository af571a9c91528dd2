"""The port's metrics and eval engine against the JAX package's and the
reference's numpy oracles.

Tolerances: the confusion matrices are integer counts and must be equal
(int64 on the port's side); ``per_class_iou_np`` is the same f64 formula
on both sides, so equal; ``mean_iou`` within 1e-6 (the JAX device version
is f32); ``evaluate`` with one fixed-logits ``apply_fn`` gives equal
histograms and the loss within 1e-6 relative (the same f32 CE, summed in
another order); the real BiSeNet-R18 in f32 agrees with JAX's on at least
0.999 of the histogram's pixels (f32 convs round differently, which can
flip a near-tie argmax) and on the loss within 1e-5 relative.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import fast_hist_oracle, per_class_iou_oracle
from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.models.factory import init_model as jinit_model
from rtda_semanticsegmentation_tpu.ops import metrics as jmetrics
from rtda_semanticsegmentation_tpu.train import evaluate as jevaluate
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model, load_variables
from rtda_semanticsegmentation_tpu_torch.ops import metrics as tmetrics
from rtda_semanticsegmentation_tpu_torch.train import evaluate as tevaluate

from test_torch_loop import drop_tmp_path, torch_one_thread  # noqa: E402,F401  (autouse fixtures)

C = 19


def _labels_preds(seed, shape=(4096,), ignore=0.15):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=shape).astype(np.int32)
    labels[rng.random(shape) < ignore] = 255
    preds = rng.integers(0, C, size=shape).astype(np.int32)
    return labels, preds


@pytest.mark.parametrize("seed", range(3))
def test_confusion_matrix_matches_jax_and_fast_hist(seed):
    labels, preds = _labels_preds(seed, shape=(2, 48, 64))
    got = tmetrics.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds), C)
    assert got.dtype == torch.int64 and tuple(got.shape) == (C, C)
    want_jax = np.asarray(jmetrics.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), C))
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), fast_hist_oracle(labels.ravel(), preds.ravel(), C))
    # predictions outside [0, C) are dropped as the reference's fast_hist does
    preds[0, 0, :5] = -1
    preds[1, 0, :5] = C
    got = tmetrics.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds), C)
    np.testing.assert_array_equal(got.numpy(), fast_hist_oracle(labels.ravel(), preds.ravel(), C))


def test_per_class_iou_and_mean_match_jax():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 100, size=(C, C)).astype(np.int64)
    hist[5] = 0
    hist[:, 5] = 0  # an absent class scores 0
    np.testing.assert_array_equal(tmetrics.per_class_iou_np(hist), jmetrics.per_class_iou_np(hist))
    got = tmetrics.per_class_iou(torch.from_numpy(hist))
    assert got.dtype == torch.float64 and float(got[5]) == 0.0
    np.testing.assert_allclose(got.numpy(), per_class_iou_oracle(hist), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), tmetrics.per_class_iou_np(hist), rtol=0, atol=0)
    want = float(jmetrics.mean_iou(jnp.asarray(hist.astype(np.int32))))
    assert float(tmetrics.mean_iou(torch.from_numpy(hist))) == pytest.approx(want, abs=1e-6)
    # an int32 histogram takes the f32 path, as JAX's
    assert tmetrics.per_class_iou(torch.from_numpy(hist.astype(np.int32))).dtype == torch.float32


def test_confusion_matrix_and_iou_exact_past_2pow31():
    """Counts past 2^31 in a cell (a GTA5-sized eval set) stay exact: the
    histogram is int64 on the device, so no flush is needed."""
    cell = (1 << 31) + 5
    hist = torch.zeros((2, 2), dtype=torch.int64)
    for _ in range(3):  # accumulated as evaluate() does
        hist = hist + torch.tensor([[cell, 1], [3, 7]], dtype=torch.int64)
    assert int(hist[0, 0]) == 3 * cell
    tp0, fp0, fn0 = 3 * cell, 9, 3
    assert tmetrics.per_class_iou_np(hist.numpy())[0] == pytest.approx(tp0 / (tp0 + fp0 + fn0 + 1e-5), rel=1e-15)
    # a bincount cell really counts past 2^31 on the port's path
    labels = torch.zeros((1 << 16,), dtype=torch.int32)
    one = tmetrics.confusion_matrix(labels, labels, 2)
    total = sum([one] * ((1 << 15) + 1))  # (2^15 + 1) * 2^16 > 2^31
    assert total.dtype == torch.int64 and int(total[0, 0]) == ((1 << 15) + 1) << 16


def test_evaluate_fixed_logits_matches_jax():
    """One fixed-logits apply_fn given to both packages' eval engines: the
    histograms are equal and the loss within 1e-6 relative, padded tail
    images (img_valid False) left out of both."""
    b, h, w = 3, 16, 24
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, b, h, w, C)).astype(np.float32)
    batches = []
    for i in range(2):
        labels = rng.integers(0, C, size=(b, h, w)).astype(np.int32)
        labels[rng.random((b, h, w)) < 0.2] = 255
        images = rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8)
        valid = np.array([True, True, i == 0])  # the last batch has a padding image
        batches.append((images, labels, valid))

    def japply(variables, images, train):
        return jnp.asarray(logits[variables["i"]])

    def tapply(variables, x, train):
        return torch.from_numpy(logits[variables["i"]]).permute(0, 3, 1, 2)

    jcfg = jconfig.ExperimentConfig()
    tcfg = tconfig.ExperimentConfig()
    jstep, tstep = jevaluate.make_eval_step(jcfg, japply), tevaluate.make_eval_step(tcfg, tapply)
    want = jevaluate.evaluate(lambda v, *a: jstep({"i": next(v)}, *a), iter([0, 1]),
                              [tuple(jnp.asarray(x) for x in bt) for bt in batches], C)
    got = tevaluate.evaluate(lambda v, *a: tstep({"i": next(v)}, *a), iter([0, 1]),
                             [tuple(torch.from_numpy(x) for x in bt) for bt in batches], C)
    assert got["hist"].dtype == np.int64
    np.testing.assert_array_equal(got["hist"], want["hist"])
    assert got["num_images"] == want["num_images"] == 5
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert got["miou"] == pytest.approx(want["miou"], abs=1e-12)
    np.testing.assert_array_equal(got["per_class_iou"], want["per_class_iou"])
    assert got["batches"] == 2


def test_evaluate_real_r18_f32_matches_jax():
    """The eval engines with the real BiSeNet-R18 (f32, JAX's seeded weights
    bridged into the port) on the same batches: the histograms agree on at
    least 0.999 of the pixels and the loss within 1e-5 relative."""
    b, h, w = 2, 64, 96
    jcfg = jconfig.ExperimentConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, compute_dtype="float32"))
    tcfg = tconfig.ExperimentConfig()
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, compute_dtype="float32"))
    jmodel = jbuild_model(jcfg.model)
    variables = jinit_model(jmodel, jax.random.PRNGKey(3), (1, h, w, 3), train=False)
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    model = build_model(tcfg.model, device="cpu")
    load_variables(model, from_jax_variables({k: np.array(v) for k, v in flat.items()}))
    rng = np.random.default_rng(5)
    batches = []
    for i in range(2):
        labels = rng.integers(0, C, size=(b, h, w)).astype(np.int32)
        labels[rng.random((b, h, w)) < 0.1] = 255
        images = rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8)
        batches.append((images, labels, np.array([True, i == 0])))
    want = jevaluate.evaluate(jax.jit(jevaluate.make_eval_step(jcfg, jmodel.apply)), variables,
                              [tuple(jnp.asarray(x) for x in bt) for bt in batches], C)
    got = tevaluate.evaluate(tevaluate.make_eval_step(tcfg), model,
                             [tuple(torch.from_numpy(x) for x in bt) for bt in batches], C)
    total = want["hist"].sum()
    assert got["hist"].sum() == total == sum(int((bt[1][bt[2]] != 255).sum()) for bt in batches)
    agree = np.minimum(got["hist"], want["hist"]).sum() / total
    assert agree >= 0.999, agree
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
