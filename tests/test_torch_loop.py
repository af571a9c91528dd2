"""The port's training job end to end on the CPU: ``run_experiment`` on the
synthetic dataset at 32x32 (R18, f32), as ``tests/test_loop.py`` drives the
JAX package's. Resume and preemption: ``tests/test_torch_loop_resume.py``;
the loop against JAX's: ``tests/test_torch_loop_parity.py``."""

import dataclasses
import glob
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu_torch.config import ExperimentConfig
from rtda_semanticsegmentation_tpu_torch.models.convert import to_jax_variables
from rtda_semanticsegmentation_tpu_torch.train import loop
from rtda_semanticsegmentation_tpu_torch.train.loop import NonFiniteLossError, Trainer, _check_finite, run_experiment

H = W = 32


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One intra-op thread per test process: the tier-1 run puts 6 workers
    on the CPU's cores, and torch's default of a thread per core in each
    worker oversubscribes them many times over. Other test modules of the
    training job import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    """Remove a test's ``tmp_path`` when it ends: an R18 checkpoint with its
    Adam state is about 150 MB, and pytest keeps the directories of its last
    runs. Other test modules of the training job import this fixture."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def e2e_cfg(tmp_path, **over) -> ExperimentConfig:
    """``tests/test_loop.py``'s configuration (without its 4-device mesh)."""
    cfg = ExperimentConfig()
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, train_dataset="synthetic", val_dataset="synthetic", gta5_size=(H, W),
            cityscapes_size=(H, W), eval_batch_size=4, num_workers=2, prefetch_batches=1,
            adversarial_target_dataset="synthetic", synthetic_length=16,
        ),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        train=dataclasses.replace(
            cfg.train, epochs=2, batch_size=4, steps_per_epoch=3, checkpoint_dir=str(tmp_path / "ckpt"),
            print_freq_batch=2, validate_freq_epoch=1,
        ),
        augment=dataclasses.replace(cfg.augment, pipeline="no_new_aug"),
        obs=dataclasses.replace(cfg.obs, backend="jsonl", log_dir=str(tmp_path / "logs")),
    )
    for k, v in over.items():
        sec, field_name = k.split("__")
        cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **{field_name: v})})
    return cfg


def run(cfg, name, **kw):
    return run_experiment(cfg, run_name=name, measure_performance=kw.pop("perf", False), verbose=False,
                          device="cpu", **kw)


def _events(tmp_path, name):
    return [json.loads(line) for line in open(tmp_path / "logs" / f"{name}.jsonl")]


def test_run_experiment_end_to_end(tmp_path):
    cfg = e2e_cfg(tmp_path)
    report = run(cfg, "e2e", perf=True)
    assert report["global_step"] == 6  # 2 epochs x 3 steps
    assert 0.0 <= report["best_miou"] <= 1.0
    assert report["per_class_iou"] is not None and len(report["per_class_iou"]) == 19
    assert glob.glob(str(tmp_path / "ckpt" / "e2e" / "best_miou" / "*"))
    assert os.path.isdir(tmp_path / "ckpt" / "e2e" / "latest")
    events = _events(tmp_path, "e2e")
    kinds = [e["event"] for e in events]
    assert "run_config" in kinds and "metrics" in kinds and "summary" in kinds
    # train scalars at print_freq_batch 2: steps 2, 4, 6
    steps = [e["step"] for e in events if e["event"] == "metrics" and "train/loss" in e]
    assert steps == [2, 4, 6]
    # the reference's report: latency and FLOPs of the eval forward at batch 1
    assert report["mean_latency_ms"] > 0 and report["flops_g"] > 0 and report["params_m"] > 10
    assert "flop_table" in report and "context_path" in report["flop_table"]
    timings = report["timings"]
    assert len(timings["step_ms"]) == len(timings["loader_wait_ms"]) == 6
    assert len(timings["eval_ms_per_batch"]) == 2 and len(timings["checkpoint_save_s"]) >= 1
    assert all(math.isfinite(v) for v in timings["step_ms"])


def test_final_int8_eval_reports_delta(tmp_path):
    """The best model served through the int8 path (K3's plain version on
    the CPU) on the validation set: the report carries its mIoU and delta."""
    cfg = e2e_cfg(tmp_path, train__final_int8_eval=True)
    report = run(cfg, "int8e")
    assert "int8_miou" in report and "int8_miou_delta" in report
    assert np.isfinite(report["int8_miou"])
    assert report["int8_miou_delta"] == pytest.approx(report["int8_miou"] - report["best_miou"])
    assert abs(report["int8_miou_delta"]) < 0.1, report["int8_miou_delta"]


def test_final_int8_eval_does_not_swallow_errors(tmp_path, monkeypatch):
    """Unlike the JAX package's loop, a failure of the int8 pass is raised."""
    from rtda_semanticsegmentation_tpu_torch.models import quantize

    def broken(*a, **k):
        raise RuntimeError("int8 path broke")

    monkeypatch.setattr(quantize, "freeze", broken)
    with pytest.raises(RuntimeError, match="int8 path broke"):
        run(e2e_cfg(tmp_path, train__final_int8_eval=True, train__epochs=1), "int8x")


def test_profile_steps_writes_trace(tmp_path):
    cfg = e2e_cfg(tmp_path, train__profile_steps=2, train__steps_per_epoch=6, train__epochs=1,
                  data__synthetic_length=24)
    run(cfg, "prof")
    trace_root = os.path.join(str(tmp_path / "logs"), "prof", "trace")
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(trace_root) for f in fs]
    assert files, f"no trace files under {trace_root}"
    trace = json.load(open(files[0]))
    assert trace["traceEvents"]


def test_adversarial_end_to_end(tmp_path):
    cfg = e2e_cfg(tmp_path, adversarial__enabled=True, loss__use_lovasz=True)
    report = run(cfg, "adv")
    assert report["global_step"] == 6
    assert report["state"].discriminator is not None
    lines = _events(tmp_path, "adv")
    keys = set().union(*(line.keys() for line in lines))
    assert any("loss_d" in k for k in keys), keys
    assert any("loss_lovasz" in k for k in keys), keys
    # D's first conv on cuDNN, as the JAX loop builds it
    assert report["trainer"].disc.conv1.fused is False


def test_watch_and_checkpoint_upload_events(tmp_path):
    cfg = e2e_cfg(tmp_path, train__epochs=3, train__save_checkpoint_freq_epoch=1, obs__watch_freq_steps=2,
                  obs__upload_checkpoints=True)
    run(cfg, "watched")
    events = _events(tmp_path, "watched")
    watch = [e for e in events if e["event"] == "metrics" and any(k.startswith("watch/") for k in e)]
    assert watch, "no watch events logged"
    for e in watch:
        assert e["step"] % 2 == 0
        assert all(k.startswith("watch/") or k in ("event", "step", "ts") for k in e)
        assert any(k.endswith("/grad_norm") for k in e) and any(k.startswith("watch/g/") for k in e)
    for e in events:
        if e["event"] == "metrics" and "train/loss" in e:
            assert not any(k.startswith("watch/") for k in e)
    arts = [e for e in events if e["event"] == "artifact"]
    assert arts, "no artifact events for uploaded checkpoints"
    for e in arts:
        assert os.path.isdir(e["path"])
    assert any(p["path"].endswith("best_miou") for p in arts)
    assert any(p["path"].endswith("latest") for p in arts)


def test_steps_per_epoch_beyond_dataset_rejected(tmp_path):
    with pytest.raises(ValueError, match="steps_per_epoch"):
        run(e2e_cfg(tmp_path, train__steps_per_epoch=99), "over")


def test_data_echo_multiplies_steps(tmp_path):
    # 16 samples / batch 4 = 4 loaded batches; echo 3 -> 12 steps an epoch
    cfg = e2e_cfg(tmp_path, train__data_echo=3, train__steps_per_epoch=None, train__epochs=1)
    with pytest.warns(UserWarning, match="data_echo"):
        report = run(cfg, "echo")
    assert report["global_step"] == 12
    cfg = e2e_cfg(tmp_path, train__data_echo=3, train__steps_per_epoch=5, train__epochs=1)
    with pytest.warns(UserWarning, match="data_echo"):
        report = run(cfg, "echo_capped")
    assert report["global_step"] == 5


def test_data_echo_extends_lr_horizon(tmp_path):
    cfg = e2e_cfg(tmp_path, train__data_echo=3, train__steps_per_epoch=None, train__epochs=2)
    with pytest.warns(UserWarning, match="data_echo"):
        tr = Trainer(cfg, device="cpu")
    assert tr.steps_per_epoch == 12
    assert tr.max_iter == 24
    assert tr.state.schedule(23) > 0.0 and tr.state.schedule(24) == 0.0


def test_check_finite_guard():
    _check_finite({"train/loss": 0.5, "train/lr": 1e-4}, 10, "batch log point")
    with pytest.raises(NonFiniteLossError, match=r"step 7.*loss=nan"):
        _check_finite({"loss": float("nan"), "lr": 1e-4}, 7, "epoch mean")
    with pytest.raises(NonFiniteLossError, match="grad_norm=inf"):
        _check_finite({"grad_norm": float("inf")}, 3, "batch log point")


def test_divergent_run_halts_with_diagnostic(tmp_path):
    with pytest.raises(NonFiniteLossError, match="non-finite train metrics"):
        run(e2e_cfg(tmp_path, optimizer__learning_rate=1e32), "diverge")
    cfg2 = e2e_cfg(tmp_path, optimizer__learning_rate=1e32, train__halt_on_nonfinite=False,
                   train__checkpoint_dir=str(tmp_path / "c2"))
    assert run(cfg2, "diverge_ok") is not None


def test_pretrained_warm_starts(tmp_path):
    """``pretrained_discriminator`` and ``pretrained_backbone`` load a
    converted ``.npz`` (JAX keys) through ``models/convert.py``."""
    donor = Trainer(e2e_cfg(tmp_path, adversarial__enabled=True), device="cpu")
    d_flat = {k: v + 1.0 for k, v in to_jax_variables(donor.disc.state_dict()).items()}
    np.savez(tmp_path / "d.npz", **d_flat)
    g_flat = {k: v + 1.0 for k, v in to_jax_variables(donor.model.state_dict()).items()
              if k.startswith("params/context_path")}
    np.savez(tmp_path / "g.npz", **g_flat)
    tr = Trainer(e2e_cfg(tmp_path, adversarial__enabled=True,
                         adversarial__pretrained_discriminator=str(tmp_path / "d.npz"),
                         model__pretrained_backbone=str(tmp_path / "g.npz")), device="cpu")
    torch.testing.assert_close(tr.disc.conv1.bias, donor.disc.conv1.bias + 1.0, rtol=0, atol=0)
    for k, v in tr.model.state_dict().items():
        want = donor.model.state_dict()[k]
        if k.startswith("context_path") and k.endswith(("weight", "bias")):
            want = want + 1.0
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)


def test_trainer_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    """``device='cuda'`` (the default) raises without a CUDA device; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(e2e_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(e2e_cfg(tmp_path), run_name="nocard", verbose=False)


def test_step_seed_is_a_function_of_seed_and_step():
    """The augmentation draws depend on (seed, step) only."""
    seeds = {loop.step_seed(59, s) for s in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2 ** 63 for s in seeds)
    assert loop.step_seed(59, 7) == loop.step_seed(59, 7) != loop.step_seed(60, 7)
