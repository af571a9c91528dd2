"""The port's training job against the JAX package's, vanilla mode (CE,
Adam, no augmentation), on the CPU: both run ``run_experiment`` for 2
epochs of 3 steps on the same synthetic batches (the loaders give the same
bits), the port's G starting from the JAX Trainer's initial variables
bridged by ``models/convert.py``.

Both sides compute in float64 (JAX under ``jax_enable_x64``), as
``tests/test_train_parity.py`` does, so the comparison decides: in f32 this
tiny configuration (batch 4 at 32x32, gradient norms near 600, the ARM
BatchNorms over 4 values) amplifies rounding differences step by step, and
the two loops' 6th losses were measured 1.4e-3 to 3.8e-3 apart (batch 8 at
32x32, batch 4 at 64x96) while their first losses agreed within 4e-6.

Tolerances: the learning rate logged at each step is exactly the f32
rounding of the reference formula ``base * (1 - t / max_iter) ** 0.9`` at
the same ``t``; JAX evaluates that formula in f32 arithmetic, so its value
lies within one f32 ulp of the port's; the first step's loss within 1e-5
relative and the last of the 6 steps' within 1e-3 (in f64 they agree to
about 1e-6: Adam's early updates are about sign(g), which amplifies
rounding on near-zero gradients); the validation loss within 1e-3 and mIoU within 0.01 per
epoch; the best checkpoint's epoch, step and target-stream rate equal, its
mIoU within 0.01.
"""

import dataclasses
import json
import shutil

import flax
import jax
import numpy as np
import pytest

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.train import checkpoint as jcheckpoint
from rtda_semanticsegmentation_tpu.train import loop as jloop
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.models.convert import from_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import load_variables
from rtda_semanticsegmentation_tpu_torch.train import checkpoint as tcheckpoint
from rtda_semanticsegmentation_tpu_torch.train import loop as tloop

from test_torch_loop import torch_one_thread  # noqa: E402,F401  (autouse: one intra-op thread)

H = W = 32


def _cfg(cfgmod, tmp_path, side):
    cfg = cfgmod.ExperimentConfig()
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, train_dataset="synthetic", val_dataset="synthetic", gta5_size=(H, W),
                                 cityscapes_size=(H, W), eval_batch_size=4, num_workers=2, prefetch_batches=1,
                                 synthetic_length=16),
        model=dataclasses.replace(cfg.model, compute_dtype="float64"),
        train=dataclasses.replace(cfg.train, epochs=2, batch_size=4, steps_per_epoch=3, print_freq_batch=1,
                                  checkpoint_dir=str(tmp_path / side / "ckpt")),
        augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"),
        obs=dataclasses.replace(cfg.obs, backend="jsonl", log_dir=str(tmp_path / side / "logs")),
    )
    if cfgmod is jconfig:
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=1))
    return cfg


def _log(tmp_path, side):
    events = [json.loads(line) for line in open(tmp_path / side / "logs" / "parity.jsonl")]
    train = [e for e in events if e["event"] == "metrics" and "train/loss" in e]
    val = [e for e in events if e["event"] == "metrics" and "val/mIoU" in e]
    return train, val


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("parity")
    jcfg, tcfg = _cfg(jconfig, tmp_path, "jax"), _cfg(tconfig, tmp_path, "port")
    jax.config.update("jax_enable_x64", True)
    mp = pytest.MonkeyPatch()
    try:
        jinit = jloop.Trainer(jcfg).state.generator
        flat = flax.traverse_util.flatten_dict({"params": jinit.params, "batch_stats": jinit.batch_stats}, sep="/")
        bridged = from_jax_variables({k: np.array(v) for k, v in flat.items()})
        jreport = jloop.run_experiment(jcfg, run_name="parity", measure_performance=False, verbose=False)
        jmeta = jcheckpoint.CheckpointManager(jcfg, run_name="parity").restore_into(jreport["state"], "best")[1]
        mp.setattr(tloop, "init_model", lambda model, generator: load_variables(model, bridged))
        treport = tloop.run_experiment(tcfg, run_name="parity", measure_performance=False, verbose=False,
                                       device="cpu")
    finally:
        mp.undo()
        jax.config.update("jax_enable_x64", False)
    tmeta = tcheckpoint.CheckpointManager(tcfg, run_name="parity").restore_into(treport["state"], "best")[1]
    out = dict(jax=_log(tmp_path, "jax"), port=_log(tmp_path, "port"), jmeta=jmeta, tmeta=tmeta,
               jreport=jreport, treport=treport)
    shutil.rmtree(tmp_path, ignore_errors=True)  # two loops' checkpoints, about 150 MB each
    return out


def test_lr_sequence_and_losses_match_jax(runs):
    (jtrain, _), (ttrain, _) = runs["jax"], runs["port"]
    assert [e["step"] for e in ttrain] == [e["step"] for e in jtrain] == [1, 2, 3, 4, 5, 6]
    max_iter = 6
    want = [float(np.float32(1e-4 * (1 - t / max_iter) ** 0.9)) for t in range(6)]
    assert [e["train/lr"] for e in ttrain] == want
    for t, j in zip(ttrain, jtrain):
        assert abs(t["train/lr"] - j["train/lr"]) <= np.spacing(np.float32(j["train/lr"]))
    first, last = (ttrain[i]["train/loss"] for i in (0, -1)), (jtrain[i]["train/loss"] for i in (0, -1))
    (t0, t5), (j0, j5) = first, last
    assert t0 == pytest.approx(j0, rel=1e-5)
    assert t5 == pytest.approx(j5, rel=1e-3)
    assert runs["treport"]["global_step"] == runs["jreport"]["global_step"] == 6


def test_validation_and_checkpoint_meta_match_jax(runs):
    (_, jval), (_, tval) = runs["jax"], runs["port"]
    assert [e["step"] for e in tval] == [e["step"] for e in jval] == [3, 6]
    for t, j in zip(tval, jval):
        assert t["val/epoch_loss"] == pytest.approx(j["val/epoch_loss"], rel=1e-3)
        assert abs(t["val/mIoU"] - j["val/mIoU"]) < 0.01
    jmeta, tmeta = runs["jmeta"], runs["tmeta"]
    for k in ("epoch", "host_batches_per_epoch"):
        assert tmeta[k] == jmeta[k], k
    assert int(runs["treport"]["state"].step) == int(jax.device_get(runs["jreport"]["state"].step))
    assert abs(tmeta["best_miou"] - jmeta["best_miou"]) < 0.01
    assert runs["treport"]["best_miou"] == pytest.approx(tmeta["best_miou"])
