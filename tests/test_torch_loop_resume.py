"""Resume and preemption of the port's training job on the CPU, as
``tests/test_loop.py`` checks the JAX package's. A preempted and resumed
run must end with exactly the weights, batch statistics and optimizer state
of an uninterrupted one (``torch.equal`` on every tensor)."""

import glob
import json
import os
import signal

import pytest
import torch

from test_torch_loop import drop_tmp_path, e2e_cfg, run, torch_one_thread  # noqa: F401  (autouse fixtures)

from rtda_semanticsegmentation_tpu_torch.train import loop
from rtda_semanticsegmentation_tpu_torch.train.loop import GracefulPreemption


def test_resume_continues_from_checkpoint(tmp_path):
    cfg = e2e_cfg(tmp_path, train__save_checkpoint_freq_epoch=1, train__epochs=3)
    run(cfg, "first")
    cfg2 = e2e_cfg(tmp_path, train__save_checkpoint_freq_epoch=1, train__epochs=3,
                   train__resume_checkpoint="latest")
    # run_name "second" has no checkpoint of its own: nothing to restore
    assert run(cfg2, "second")["global_step"] == 9
    # the same run name: periodic saves at epochs 1 and 2 (not the final);
    # resume at epoch 3 -> one more epoch of 3 steps on the 6 banked
    cfg3 = e2e_cfg(tmp_path, train__save_checkpoint_freq_epoch=1, train__epochs=4,
                   train__resume_checkpoint="latest")
    assert run(cfg3, "first")["global_step"] == 12


def test_resume_falls_back_to_best_when_no_latest(tmp_path):
    cfg = e2e_cfg(tmp_path, train__epochs=2)  # save freq 5: no periodic checkpoint
    run(cfg, "short")
    assert not os.listdir(tmp_path / "ckpt" / "short" / "latest")
    cfg2 = e2e_cfg(tmp_path, train__epochs=3, train__resume_checkpoint="latest")
    report = run(cfg2, "short")
    assert report["global_step"] > 6  # continued from best, not restarted


def test_graceful_preemption_guard_catches_sigterm():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda *_: seen.append("outer"))
    try:
        with GracefulPreemption() as guard:
            assert not guard.requested
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.requested  # flag set, process not killed
        os.kill(os.getpid(), signal.SIGTERM)  # the previous handler is back
        assert seen == ["outer"]
    finally:
        signal.signal(signal.SIGTERM, prev)


def _preempting_step_factory(after: int):
    """make_train_step whose step sends SIGTERM to this process once
    ``after`` updates have been taken."""
    real = loop.make_train_step

    def factory(*a, **k):
        step = real(*a, **k)

        def wrapped(state, batch, generator):
            out = step(state, batch, generator)
            if out[0].step == after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    return factory


def _full_state(report):
    state = report["state"]
    out = {f"g.{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return out


@pytest.mark.parametrize("mode", ["vanilla", "adversarial"])
def test_preemption_checkpoints_and_resume_continues_exactly(tmp_path, monkeypatch, mode):
    """SIGTERM after update 4 (mid epoch 2 of 3-step epochs) saves 'latest'
    and returns; ``resume latest`` fast-forwards the trained step of the
    interrupted epoch and continues. The combined run ends with the same
    bits as an uninterrupted 3-epoch run, augmentation draws included."""
    over = dict(train__epochs=3, train__validate_freq_epoch=1000, train__save_checkpoint_freq_epoch=1000,
                augment__pipeline="all_four_combined")
    if mode == "adversarial":
        over.update(adversarial__enabled=True, loss__use_lovasz=True)
    straight = run(e2e_cfg(tmp_path, **over), f"straight_{mode}")
    assert straight["global_step"] == 9

    with monkeypatch.context() as m:
        m.setattr(loop, "make_train_step", _preempting_step_factory(4))
        report = run(e2e_cfg(tmp_path, **over), f"pre_{mode}")
    assert report.get("preempted") is True
    assert report["global_step"] == 4 and report["epochs"] == 1  # in the second epoch (index 1)
    assert glob.glob(str(tmp_path / "ckpt" / f"pre_{mode}" / "latest" / "*"))
    summaries = [json.loads(line) for line in open(tmp_path / "logs" / f"pre_{mode}.jsonl")
                 if json.loads(line)["event"] == "summary"]
    assert summaries and summaries[-1]["preempted"] is True

    resumed = run(e2e_cfg(tmp_path, train__resume_checkpoint="latest", **over), f"pre_{mode}")
    assert not resumed.get("preempted") and resumed["global_step"] == 9
    want, got = _full_state(straight), _full_state(resumed)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    if mode == "adversarial":
        for k, v in straight["state"].discriminator.state_dict().items():
            assert torch.equal(v, resumed["state"].discriminator.state_dict()[k]), k


def test_resume_from_explicit_path(tmp_path):
    cfg = e2e_cfg(tmp_path, train__save_checkpoint_freq_epoch=1, train__epochs=3)
    run(cfg, "donor")
    donor_root = str(tmp_path / "ckpt" / "donor")
    # a run root: 'latest' preferred (epoch index 1, step 6)
    cfg2 = e2e_cfg(tmp_path, train__epochs=3, train__resume_checkpoint=donor_root,
                   train__checkpoint_dir=str(tmp_path / "ckpt_b"))
    assert run(cfg2, "warm_root")["global_step"] == 9
    # one stream's directory: best at epoch e (step 3(e+1)) -> 9 for any e
    cfg3 = e2e_cfg(tmp_path, train__epochs=3, train__resume_checkpoint=os.path.join(donor_root, "best_miou"),
                   train__checkpoint_dir=str(tmp_path / "ckpt_c"))
    assert run(cfg3, "warm_stream")["global_step"] == 9
    # a path with nothing: warn and start fresh
    cfg4 = e2e_cfg(tmp_path, train__resume_checkpoint=str(tmp_path / "nope"),
                   train__checkpoint_dir=str(tmp_path / "ckpt_d"))
    assert run(cfg4, "fresh")["global_step"] == 6
