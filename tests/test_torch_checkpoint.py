"""The port's checkpoints: the 11 cases of ``tests/test_checkpoint.py`` on
``torch.save`` files. Every restored tensor must equal the saved one
exactly (``torch.equal``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu_torch.config import ExperimentConfig
from rtda_semanticsegmentation_tpu_torch.models.factory import (
    AUX_HEADS,
    build_discriminator,
    build_model,
    init_discriminator,
    init_model,
)
from rtda_semanticsegmentation_tpu_torch.train.checkpoint import FILENAME, CheckpointManager
from rtda_semanticsegmentation_tpu_torch.train.optim import build_discriminator_tx, build_generator_tx
from rtda_semanticsegmentation_tpu_torch.train.schedule import poly_lr_schedule
from rtda_semanticsegmentation_tpu_torch.train.state import TrainState

from test_torch_loop import drop_tmp_path, torch_one_thread  # noqa: E402,F401  (autouse fixtures)


def small_cfg(tmp_path, adversarial=False) -> ExperimentConfig:
    cfg = ExperimentConfig()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path)),
        adversarial=dataclasses.replace(cfg.adversarial, enabled=adversarial),
    )


def _step_once(module, optimizer):
    """One optimizer update on unit gradients, so its state has moments."""
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_state(cfg, with_disc=False, seed=0) -> TrainState:
    model = build_model(cfg.model, device="cpu", train=True)
    init_model(model, torch.Generator().manual_seed(seed))
    opt = build_generator_tx(cfg.optimizer, model, decay_exempt=AUX_HEADS)
    state = TrainState(model, opt, poly_lr_schedule(1e-4, 10))
    if with_disc:
        disc = build_discriminator(cfg.model, device="cpu")
        init_discriminator(disc, torch.Generator().manual_seed(seed + 1))
        state.discriminator, state.d_optimizer = disc, build_discriminator_tx(cfg.adversarial, disc)
        state.d_schedule = poly_lr_schedule(2.5e-5, 10)
    return state


@torch.no_grad()
def mutate(state: TrainState) -> TrainState:
    for p in state.model.parameters():
        p.add_(1.0)
    state.step += 7
    state.best_miou = 0.42
    return state


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _opt_equal(a: dict, b: dict) -> bool:
    if a["param_groups"] != b["param_groups"] or a["state"].keys() != b["state"].keys():
        return False
    return all(_equal(a["state"][k], b["state"][k]) for k in a["state"])


def test_periodic_roundtrip_and_resume_epoch(tmp_path):
    cfg = small_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    state = mutate(make_state(cfg))
    mgr.save_periodic(state, epoch=4)
    mgr.wait()
    assert os.path.isfile(os.path.join(mgr.latest_dir, FILENAME))
    assert not [f for f in os.listdir(mgr.latest_dir) if f != FILENAME]  # no temporary file left
    restored, meta = mgr.restore_into(make_state(cfg, seed=5), "latest")
    assert meta["epoch"] == 4  # the caller resumes at epoch 5
    assert restored.step == 7
    assert restored.best_miou == pytest.approx(0.42)
    assert _equal(state.model.state_dict(), restored.model.state_dict())
    mgr.close()


def test_best_checkpoint_carries_per_class_ious(tmp_path):
    cfg = small_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    ious = np.linspace(0, 1, 19)
    mgr.save_best(mutate(make_state(cfg)), epoch=2, per_class_ious=ious)
    _, meta = mgr.restore_into(make_state(cfg), "best")
    np.testing.assert_array_equal(meta["per_class_ious"], ious)


def test_vanilla_restores_adversarial_checkpoint(tmp_path):
    """A vanilla run pointed at an adversarial run's directory restores G
    and ignores D."""
    adv_cfg = small_cfg(tmp_path, adversarial=True)
    mgr = CheckpointManager(adv_cfg)
    adv_state = mutate(make_state(adv_cfg, with_disc=True))
    mgr.save_periodic(adv_state, epoch=1)
    fresh = make_state(adv_cfg, seed=3)  # no discriminator
    restored, meta = CheckpointManager(adv_cfg).restore_into(fresh, "latest")
    assert restored.discriminator is None and meta["epoch"] == 1
    assert _equal(adv_state.model.state_dict(), restored.model.state_dict())


def test_adversarial_roundtrip_restores_discriminator(tmp_path):
    cfg = small_cfg(tmp_path, adversarial=True)
    mgr = CheckpointManager(cfg)
    state = make_state(cfg, with_disc=True)
    with torch.no_grad():
        for p in state.discriminator.parameters():
            p.mul_(2).add_(3)
    _step_once(state.discriminator, state.d_optimizer)
    mgr.save_periodic(state, epoch=0)
    restored, _ = mgr.restore_into(make_state(cfg, with_disc=True, seed=9), "latest")
    assert _equal(state.discriminator.state_dict(), restored.discriminator.state_dict())
    assert _opt_equal(state.d_optimizer.state_dict(), restored.d_optimizer.state_dict())


def test_restore_none_when_no_checkpoint(tmp_path):
    cfg = small_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    assert mgr.restore_into(make_state(cfg), "latest") is None
    assert mgr.restore_into(make_state(cfg), "best") is None
    assert mgr.restore_from_path(make_state(cfg), str(tmp_path / "nowhere")) is None
    assert mgr.restore_variables("best") is None


def test_optimizer_moments_restored_exactly(tmp_path):
    """G's Adam moments and step counts survive a vanilla restore of an
    adversarial checkpoint bit for bit."""
    adv_cfg = small_cfg(tmp_path, adversarial=True)
    state = make_state(adv_cfg, with_disc=True)
    _step_once(state.model, state.optimizer)
    for s in state.optimizer.state.values():
        s["exp_avg"].add_(3.25)
    CheckpointManager(adv_cfg).save_periodic(state, epoch=0)
    restored, _ = CheckpointManager(adv_cfg).restore_into(make_state(adv_cfg, seed=4), "latest")
    assert _opt_equal(state.optimizer.state_dict(), restored.optimizer.state_dict())
    assert len(restored.optimizer.state) > 0


def test_same_mode_resume_uses_template_path(tmp_path, capsys):
    """A same-mode restore is exact and silent (the JAX package reports a
    fallback to its raw restore here; the port has one path)."""
    cfg = small_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    state = make_state(cfg)
    _step_once(state.model, state.optimizer)
    mgr.save_periodic(state, epoch=0)
    out = mgr.restore_into(make_state(cfg, seed=2), "latest")
    assert out is not None
    assert _opt_equal(state.optimizer.state_dict(), out[0].optimizer.state_dict())
    captured = capsys.readouterr()
    assert captured.out == "" and captured.err == ""


def test_restore_rejects_unknown_stream(tmp_path):
    cfg = small_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    with pytest.raises(ValueError, match="'latest' or 'best'"):
        mgr.restore_into(make_state(cfg), "/some/path")
    with pytest.raises(ValueError, match="'latest' or 'best'"):
        mgr.restore_variables("/some/path")


def test_adversarial_restore_from_vanilla_raises_clean_error(tmp_path):
    v_cfg = small_cfg(tmp_path / "v")
    v_mgr = CheckpointManager(v_cfg)
    v_mgr.save_periodic(mutate(make_state(v_cfg)), epoch=0)
    a_cfg = small_cfg(tmp_path / "a", adversarial=True)
    a_mgr = CheckpointManager(a_cfg)
    with pytest.raises(ValueError, match="no discriminator state"):
        a_mgr.restore_from_path(make_state(a_cfg, with_disc=True), v_mgr.root)


def test_periodic_placeholder_ious_not_reported(tmp_path):
    """A periodic checkpoint carries no per-class IoUs; a best one does."""
    cfg = small_cfg(tmp_path)
    state = make_state(cfg)
    mgr = CheckpointManager(cfg)
    mgr.save_periodic(mutate(state), epoch=0)
    _, meta = mgr.restore_into(make_state(cfg), "latest")
    assert meta.get("per_class_ious") is None
    ious = np.linspace(0.1, 0.9, 19)
    mgr.save_best(state, epoch=0, per_class_ious=ious)
    _, meta = mgr.restore_into(make_state(cfg), "best")
    np.testing.assert_array_equal(meta["per_class_ious"], ious)
    # the serving restore: G's eval variables, without the aux heads
    variables, vmeta = mgr.restore_variables("best")
    assert vmeta == {"epoch": 0, "best_miou": pytest.approx(0.42), "step": 7}
    assert not [k for k in variables if k.startswith(AUX_HEADS)]
    assert _equal(variables, {k: v for k, v in state.model.state_dict().items() if not k.startswith(AUX_HEADS)})


def test_host_batches_per_epoch_meta_roundtrip(tmp_path):
    """The saving run's target-stream rate rides in the checkpoint, and an
    explicit path (a run root, a stream directory or the file) restores."""
    cfg = small_cfg(tmp_path)
    state = make_state(cfg)
    ckpt = CheckpointManager(cfg)
    ckpt.save_periodic(state, epoch=2, host_batches_per_epoch=37)
    _, meta = ckpt.restore_into(state, "latest")
    assert meta["host_batches_per_epoch"] == 37
    for path in (ckpt.root, ckpt.latest_dir, os.path.join(ckpt.latest_dir, FILENAME)):
        _, meta = ckpt.restore_from_path(make_state(cfg), path)
        assert meta["epoch"] == 2 and meta["host_batches_per_epoch"] == 37
