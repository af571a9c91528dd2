"""Experiment orchestration (port of the JAX package's ``train/loop.py``):
seeds -> loaders -> model(s) -> optimizer(s) -> resume -> epoch loop (train
epoch, validate, best / periodic checkpoint) -> reload the best checkpoint
-> final report (mIoU, latency, FLOPs, parameters, per-class IoUs).

The step runs on the device and reads nothing back; its metrics accumulate
as device tensors and cross to the host only at ``print_freq_batch``,
watch and epoch points. The batches reach the device through pinned memory
and a side stream (``data/loader.py::prefetch_to_device``).

Augmentation draws are a function of (seed, step): before each step the
loop seeds the step's ``torch.Generator`` from ``(train.seed + 17, step)``,
as the JAX package folds ``state.step`` into ``PRNGKey(seed + 17)``. So a
run preempted and resumed from its checkpoint ends with the same weights as
one that ran through (the same bits, on the CPU).

The loop records, in ``Trainer.timings``: each step's time on the device's
timeline, from a CUDA event recorded before it to the next step's (or the
epoch end's), so a device left waiting for the host, for the next batch
among others, counts that wait; the host's wait for each batch (an epoch's
first wait comes before any event of the epoch); the eval time per batch
and each checkpoint save's seconds.

Data parallel (``cfg.mesh`` over a ``torch.distributed`` process group,
``parallel/``): each data index loads its rows of every global batch,
trains with the global BatchNorm statistics, losses and gradients,
evaluates its slice of the validation set into the global confusion
matrix, and the ranks agree on a SIGTERM every ``PREEMPT_SYNC_EVERY``
steps. Tensor parallel (``cfg.mesh.model`` > 1): after the state is built
its conv kernels of at least ``TP_MIN_CHANNELS`` output channels are
sharded over each model group (``parallel/tp.py::shard_state``), as the
JAX loop shards its state; a restore keeps that layout (each rank loads
its slices), and the ranks of a model group load the same rows. Rank 0
alone prints, logs, writes checkpoints (the others wait at a barrier; the
sharded kernels are gathered first), traces and makes the final report's
latency, FLOPs and int8 evaluation, on a whole copy of G when it is
sharded (:meth:`Trainer.full_model`).
"""

from __future__ import annotations

import itertools
import math
import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.datasets import build_dataset
from ..data.labels import CITYSCAPES_ID_TO_NAME
from ..data.loader import InfiniteLoader, Loader, eval_batches, lookahead, prefetch_to_device, zip_source_target
from ..models.convert import load_npz_into_state
from ..models.factory import (
    AUX_HEADS,
    build_discriminator,
    build_model,
    eval_variables,
    init_discriminator,
    init_model,
    load_variables,
)
from ..models.layers import fold_kernel_operands, sync_batch_norm
from ..obs import make_logger, performance_metrics
from ..ops.augment import normalize_u8
from ..parallel import create_mesh, shard_state, sync_any_flag, tp
from .checkpoint import CheckpointManager
from .evaluate import apply_model, evaluate, make_eval_step
from .optim import build_discriminator_tx, build_generator_tx
from .schedule import poly_lr_schedule
from .state import TrainState
from .steps import make_train_step

AUG_SEED_OFFSET = 17  # the augmentation stream's seed is train.seed + 17, as in JAX
TRACE_SKIP = 3  # warm steps before a profile_steps trace starts
PREEMPT_SYNC_EVERY = 16  # steps between the ranks' agreements on a SIGTERM, as in JAX
TP_MIN_CHANNELS = 256  # the narrowest conv sharded over the model axis, as in JAX's loop
_MASK64 = (1 << 64) - 1


class NonFiniteLossError(RuntimeError):
    """A train metric went NaN/Inf (``train.halt_on_nonfinite``).

    Raised at a log point, so at most ``print_freq_batch`` poisoned updates
    ran. Recovery: resume from the periodic 'latest' checkpoint with a lower
    learning rate, or run with ``--no_halt_on_nonfinite`` to ignore it."""


def _check_finite(scalars: Dict[str, float], step: int, where: str) -> None:
    bad = {k: v for k, v in scalars.items() if not math.isfinite(v)}
    if bad:
        raise NonFiniteLossError(
            f"non-finite train metrics at step {step} ({where}): "
            + ", ".join(f"{k}={v}" for k, v in sorted(bad.items()))
            + ". Params are likely poisoned; resume from the 'latest' "
            "checkpoint with a lower learning rate."
        )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' (--device cpu) to run on the CPU")
    return device


def step_seed(base: int, step: int) -> int:
    """The augmentation seed of update ``step``: splitmix64 of (base, step),
    a function of the pair only, below 2^63."""
    z = (base * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _host_scalars(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars -> Python floats in one transfer."""
    if not tensors:
        return {}
    values = torch.stack([torch.as_tensor(v).detach().to(torch.float64).reshape(()) for v in tensors.values()])
    return dict(zip(tensors, values.cpu().tolist()))


class Trainer:
    """Everything an experiment needs, built once from its config, on
    ``device`` (a CUDA device without an index: this rank's card)."""

    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        self.cfg = cfg
        self.mesh = create_mesh(cfg.mesh, device)
        self.device = resolve_device(self.mesh.device)
        t = cfg.train
        workers = cfg.data.resolved_num_workers()
        self.mesh.check_batch(t.batch_size)
        self.mesh.check_batch(cfg.data.eval_batch_size, "eval batch")
        shard = {"process_index": self.mesh.data_rank, "process_count": self.mesh.data_size}

        # --- data ---
        self.train_ds = build_dataset(cfg.data.train_dataset, "train", cfg.train_size, cfg.data)
        self.val_ds = build_dataset(cfg.data.val_dataset, "val", cfg.eval_size, cfg.data)
        self.train_loader = Loader(self.train_ds, t.batch_size, shuffle=True, drop_last=True, seed=t.seed,
                                   num_workers=workers, **shard)
        self.target_loader: Optional[InfiniteLoader] = None
        if cfg.adversarial.enabled:
            # the target stream at the train resolution
            target_ds = build_dataset(cfg.data.adversarial_target_dataset, cfg.data.adversarial_target_split,
                                      cfg.data.train_size_override or cfg.data.cityscapes_size, cfg.data)
            self.target_loader = InfiniteLoader(Loader(target_ds, t.batch_size, shuffle=True, drop_last=True,
                                                       seed=t.seed + 1, num_workers=workers, **shard))

        if cfg.data.train_dataset == "cityscapes" and cfg.augment.pipeline != "no_new_aug":
            warnings.warn(f"augmentation pipeline {cfg.augment.pipeline!r} is inert for a Cityscapes train "
                          "source (the reference augments GTA5 only); set no_new_aug to silence this")
        echo = max(1, t.data_echo)
        if echo > 1 and (cfg.augment.pipeline == "no_new_aug" or cfg.data.train_dataset == "cityscapes"):
            warnings.warn(
                f"data_echo={t.data_echo} with a deterministic input pipeline (no_new_aug, or a "
                "Cityscapes train source where augmentation is inert) repeats bit-identical gradient "
                "steps — effectively a larger LR with momentum compounding. Echo is intended for "
                "stochastic augmentation pipelines."
            )
        # echoed steps are optimizer steps: the poly-LR horizon counts them
        self.steps_per_epoch = t.steps_per_epoch or len(self.train_loader) * echo
        if self.steps_per_epoch <= 0:
            raise ValueError("empty training dataset")
        if t.steps_per_epoch and t.steps_per_epoch > len(self.train_loader) * echo:
            raise ValueError(
                f"train.steps_per_epoch={t.steps_per_epoch} exceeds the {len(self.train_loader)} batches the "
                f"dataset yields per epoch (x data_echo {echo} = {len(self.train_loader) * echo} optimizer "
                "steps); lower steps_per_epoch or raise data_echo"
            )
        self.max_iter = t.epochs * self.steps_per_epoch
        self.data_echo = echo
        # the target stream gives one batch per source host batch; checkpoints
        # carry the rate so a resume with another epoch length realigns it
        self.host_batches_per_epoch = -(-self.steps_per_epoch // echo)

        # --- models and optimizers ---
        self.model = build_model(cfg.model, self.device, train=True)
        init_model(self.model, torch.Generator().manual_seed(t.seed))  # the same weights on every rank
        sync_batch_norm(self.model, self.mesh)
        if cfg.model.pretrained_backbone:
            self.model.load_state_dict(load_npz_into_state(self.model.state_dict(), cfg.model.pretrained_backbone,
                                                           cfg.model.name))
        g_sched = poly_lr_schedule(cfg.optimizer.learning_rate, self.max_iter, cfg.optimizer.poly_power)
        optimizer = build_generator_tx(
            cfg.optimizer, self.model, freeze_bn=(cfg.model.name == "deeplabv2"),
            # unused aux heads get no gradient and no decay, as in the reference
            decay_exempt=() if cfg.loss.aux_weight else AUX_HEADS,
        )
        self.state = TrainState(self.model, optimizer, g_sched)
        d_sched = None
        self.disc = None
        if cfg.adversarial.enabled:
            # D's first conv stays on cuDNN (fused_conv1=False), as in JAX's loop
            self.disc = build_discriminator(cfg.model, self.device)
            init_discriminator(self.disc, torch.Generator().manual_seed(t.seed + 1))
            if cfg.adversarial.pretrained_discriminator:
                self.disc.load_state_dict(load_npz_into_state(
                    self.disc.state_dict(), cfg.adversarial.pretrained_discriminator, "discriminator"))
            d_sched = poly_lr_schedule(cfg.adversarial.disc_learning_rate, self.max_iter, cfg.optimizer.poly_power)
            self.state.discriminator = self.disc
            self.state.d_optimizer = build_discriminator_tx(cfg.adversarial, self.disc)
            self.state.d_schedule = d_sched
        shard_state(self.state, self.mesh, TP_MIN_CHANNELS)
        self.train_step = make_train_step(cfg, g_sched, d_sched, mesh=self.mesh)
        self.eval_step = make_eval_step(cfg)
        # an explicit run name gets its own checkpoint directory
        self.ckpt = CheckpointManager(cfg, run_name=cfg.obs.run_name or "", device=self.device, mesh=self.mesh)
        self.aug_generator = torch.Generator(device=self.device)
        self.aug_seed = t.seed + AUG_SEED_OFFSET
        self.timings: Dict[str, list] = {"step_ms": [], "loader_wait_ms": [], "eval_ms_per_batch": [],
                                         "checkpoint_save_s": []}

    # -- pieces ---------------------------------------------------------

    def train_batches(self):
        """One epoch of device batches (source and target paired when
        adversarial), ``steps_per_epoch`` optimizer steps when set."""
        it = iter(self.train_loader)
        if self.target_loader is not None:
            it = zip_source_target(it, self.target_loader)
        echo = self.data_echo
        steps = self.cfg.train.steps_per_epoch
        if steps is not None:
            # bound the host batches first: none is decoded and then dropped
            it = itertools.islice(it, -(-steps // echo))
        out = prefetch_to_device(it, self.device, self.cfg.data.prefetch_batches)
        if echo > 1:
            out = (b for batch in out for b in itertools.repeat(batch, echo))
        if steps is not None:
            out = itertools.islice(out, steps)
        return out

    def validate(self, eval_step=None, variables=None, alone: bool = False) -> Dict[str, Any]:
        """Evaluate on the validation set, each rank its slice of every
        batch (``alone``: this rank all of it, no collective: the final
        int8 pass on rank 0); ``eval_step`` / ``variables`` replace the
        float model."""
        depth = self.cfg.data.prefetch_batches
        mesh = None if alone else self.mesh
        batches = eval_batches(self.val_ds, self.cfg.data.eval_batch_size, self.cfg.data.resolved_num_workers(),
                               process_index=0 if alone else self.mesh.data_rank,
                               process_count=1 if alone else self.mesh.data_size)
        batches = prefetch_to_device(lookahead(batches, depth), self.device, depth)
        t0 = time.perf_counter()
        out = evaluate(eval_step or self.eval_step, self.model if variables is None else variables, batches,
                       self.cfg.model.num_classes, mesh=mesh)
        self.timings["eval_ms_per_batch"].append((time.perf_counter() - t0) * 1e3 / max(out["batches"], 1))
        return out

    def full_model(self) -> Optional[torch.nn.Module]:
        """G with every kernel whole, on rank 0: the model itself, or, when
        it is sharded, a copy made from the gathered state. Every rank calls
        it (the gather is a collective over the model group); the others
        get None."""
        if not tp.sharded_convs(self.model):
            return self.model if self.mesh.is_main else None
        sd = tp.full_state_dict(self.model)
        if not self.mesh.is_main:
            return None
        full = build_model(self.cfg.model, self.device, train=True)
        full.load_state_dict(sd)
        return full

    @torch.no_grad()
    def predict(self, images_u8: np.ndarray, model=None) -> np.ndarray:
        """trainId predictions of the current G (or ``model``) for uint8 NHWC
        frames; a sharded G runs its collectives, so every rank of its model
        group calls this together (rank 0 alone passes :meth:`full_model`'s)."""
        x = normalize_u8(torch.from_numpy(images_u8).to(self.device), self.cfg.augment)
        x = x.to(getattr(torch, self.cfg.model.compute_dtype)).permute(0, 3, 1, 2)
        return torch.argmax(apply_model(self.model if model is None else model, x), dim=1).cpu().numpy()

    def save(self, stream: str, *args) -> None:
        """``ckpt.save_best`` / ``save_periodic``, timed."""
        t0 = time.perf_counter()
        (self.ckpt.save_best if stream == "best" else self.ckpt.save_periodic)(self.state, *args)
        self.timings["checkpoint_save_s"].append(time.perf_counter() - t0)


class GracefulPreemption:
    """SIGTERM -> finish the step in flight, save 'latest', return.

    The epoch loop polls ``requested`` after each step. Installs only in the
    main thread; elsewhere it is an inert flag. Restores the previous
    handler on exit."""

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False

    def __enter__(self):
        import signal as _signal

        def _handler(signum, frame):
            self.requested = True

        try:
            self._prev = _signal.signal(_signal.SIGTERM, _handler)
            self._installed = True
        except ValueError:  # not the main thread of the main interpreter
            pass
        return self

    def __exit__(self, *exc):
        if self._installed:
            import signal as _signal

            # a handler installed from C reads back as None: restore the default
            _signal.signal(_signal.SIGTERM, self._prev or _signal.SIG_DFL)
        return False


def _preempted_exit(trainer: Trainer, logger, state: TrainState, epoch: int, best_per_class, say) -> Dict[str, Any]:
    """Save 'latest' with ``epoch - 1`` semantics and shut down: ``--resume
    latest`` re-enters the interrupted epoch and fast-forwards its trained
    steps (the saved step counter says how many), so the continuation is
    the uninterrupted run."""
    trainer.save("latest", epoch - 1, trainer.host_batches_per_epoch)
    say(f"SIGTERM received: saved 'latest' checkpoint at step {state.step} "
        f"(--resume latest continues epoch {epoch + 1} from that step)")
    report: Dict[str, Any] = {
        "preempted": True,
        "best_miou": float(state.best_miou),
        "per_class_iou": np.asarray(best_per_class) if best_per_class is not None else None,
        "epochs": epoch,
        "global_step": state.step,
    }
    logger.summary({k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in report.items()})
    logger.finish()
    trainer.ckpt.close()
    report.update(trainer=trainer, state=state, timings=trainer.timings)
    return report


def _per_class_table(per_class_ious) -> str:
    lines = [f"{'class':<14s} IoU"]
    for cid, iou in enumerate(np.asarray(per_class_ious)):
        lines.append(f"{CITYSCAPES_ID_TO_NAME.get(cid, str(cid)):<14s} {iou:.4f}")
    return "\n".join(lines)


class _StepClock:
    """Marks before each step of an epoch and at its end: CUDA events (the
    device's timeline, no host sync) or host times on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        """Milliseconds between consecutive marks; call after a sync."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def _resume(trainer: Trainer, state: TrainState, say):
    """Restore per ``train.resume_checkpoint``; returns (state, start epoch,
    steps of that epoch to fast-forward, best per-class IoUs)."""
    t = trainer.cfg.train
    if t.resume_checkpoint in ("latest", "best"):
        out = trainer.ckpt.restore_into(state, t.resume_checkpoint)
        if out is None:
            # a short run may have written only the other stream
            other = "best" if t.resume_checkpoint == "latest" else "latest"
            out = trainer.ckpt.restore_into(state, other)
            if out is not None:
                say(f"no '{t.resume_checkpoint}' checkpoint under {trainer.ckpt.root}; resuming from "
                    f"'{other}' instead")
        where = trainer.ckpt.root
    else:
        # an explicit path: warm-start from any run's checkpoints
        out = trainer.ckpt.restore_from_path(state, t.resume_checkpoint)
        where = t.resume_checkpoint
    if out is None:
        say(f"resume requested ({t.resume_checkpoint}) but no checkpoint found under {where}; starting fresh")
        return state, 0, 0, None
    state, meta = out
    start_epoch = meta["epoch"] + 1
    say(f"resumed from epoch {meta['epoch']} (step {state.step}, best mIoU {meta['best_miou']:.4f})")
    # a preemption checkpoint carries a mid-epoch step: fast-forward the
    # resumed epoch's trained steps instead of training them again
    spe = trainer.steps_per_epoch
    extra = state.step - start_epoch * spe
    skip = 0
    if extra >= spe:
        skipped_epochs = extra // spe
        start_epoch += skipped_epochs
        extra -= skipped_epochs * spe
        if skipped_epochs > 1:
            warnings.warn(
                f"restored step {state.step} spans {skipped_epochs} epochs beyond the saved epoch index "
                f"at steps_per_epoch={spe} — the checkpoint likely came from a run with a different epoch "
                "length; continuing at the step counter's epoch."
            )
    if extra > 0:
        skip = extra
        say(f"mid-epoch checkpoint: fast-forwarding {extra} already-trained steps of epoch {start_epoch + 1}")
    # the shuffle stream continues as an uninterrupted run's would
    trainer.train_loader.set_epoch(start_epoch)
    if trainer.target_loader is not None:
        # the target stream was pulled once per source host batch, at the
        # saving run's rate; the fast-forward replays the resumed epoch's pulls
        hbpe = trainer.host_batches_per_epoch
        saved_hbpe = meta.get("host_batches_per_epoch") or hbpe
        if saved_hbpe != hbpe:
            warnings.warn(f"checkpoint was written at {saved_hbpe} target pulls/epoch but this run makes "
                          f"{hbpe} — realigning the target stream from the saved rate.")
        trainer.target_loader.set_position(start_epoch * saved_hbpe)
    if start_epoch >= t.epochs:
        warnings.warn(
            f"resumed checkpoint is at epoch {meta['epoch']} but train.epochs={t.epochs}: no epochs remain "
            "to train. The run will emit its report from the restored weights only — raise --epochs to "
            "continue training."
        )
    return state, start_epoch, skip, meta.get("per_class_ious")


def run_experiment(cfg: ExperimentConfig, run_name: Optional[str] = None, measure_performance: bool = True,
                   verbose: bool = True, device="cuda") -> Dict[str, Any]:
    """Train, validate, checkpoint and report, on ``device``. Returns the
    report dict (with the ``trainer``, its ``state`` and ``timings``)."""

    import dataclasses as _dc

    # one run name drives the logger and the checkpoint directory
    if run_name and not cfg.obs.run_name:
        cfg = cfg.replace(obs=_dc.replace(cfg.obs, run_name=run_name))
    trainer = Trainer(cfg, device=device)
    mesh = trainer.mesh

    def say(msg: str) -> None:
        if verbose and mesh.is_main:
            print(msg, flush=True)

    logger = make_logger(cfg if mesh.is_main else cfg.replace(obs=_dc.replace(cfg.obs, backend="null")), run_name)
    t = cfg.train
    state = trainer.state
    best_per_class = None
    start_epoch = 0
    resume_skip_steps = 0
    if t.resume_checkpoint:
        state, start_epoch, resume_skip_steps, ious = _resume(trainer, state, say)
        best_per_class = ious if ious is not None else best_per_class

    model = cfg.model.name if cfg.model.name == "deeplabv2" else f"{cfg.model.name}/{cfg.model.context_path}"
    backend = torch.distributed.get_backend() if mesh.grouped else "none"
    say(f"mode={cfg.train_mode} model={model} device={trainer.device} backend={backend} world={mesh.world} "
        f"mesh={mesh.data_size}x{mesh.model_size} steps/epoch={trainer.steps_per_epoch} max_iter={trainer.max_iter}")

    # --- optional trace of a few warm steps, on rank 0 ---
    trace_dir = None
    if t.profile_steps > 0 and mesh.is_main:
        trace_dir = os.path.join(cfg.obs.log_dir, cfg.obs.run_name or "run", "trace")
    profiler = None
    trace_stop_after = None

    def stop_trace():
        nonlocal profiler, trace_stop_after
        profiler.stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace_step{trace_stop_after - t.profile_steps}.json")
        profiler.export_chrome_trace(path)
        profiler, trace_stop_after = None, None
        return path

    def check_finite_or_halt(scalars: Dict[str, float], step: int, where: str):
        """The non-finite guard; a trace in flight is written first."""
        try:
            _check_finite(scalars, step, where)
        except NonFiniteLossError:
            if profiler is not None:
                stop_trace()
            raise

    run_start_step = state.step
    preempted = False
    with GracefulPreemption() as preempt:
        for epoch in range(start_epoch, t.epochs):
            t0 = time.time()
            running: Dict[str, torch.Tensor] = {}
            n_batches = 0
            host_step = state.step
            batches = trainer.train_batches()
            if resume_skip_steps:
                # pull the trained steps through the loader without training
                batches = itertools.islice(batches, resume_skip_steps, None)
                resume_skip_steps = 0
            batches = iter(batches)
            clock = _StepClock(trainer.device)
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                trainer.timings["loader_wait_ms"].append((time.perf_counter() - tw) * 1e3)
                if trace_dir is not None and profiler is None and host_step - run_start_step >= TRACE_SKIP:
                    if trainer.device.type == "cuda":
                        torch.cuda.synchronize(trainer.device)  # drain the warm-up steps
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if trainer.device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                    trace_stop_after = host_step + t.profile_steps
                clock.mark()
                trainer.aug_generator.manual_seed(step_seed(trainer.aug_seed, state.step))
                state, metrics = trainer.train_step(state, batch, trainer.aug_generator)
                n_batches += 1
                host_step += 1
                if profiler is not None and host_step >= trace_stop_after:
                    if trainer.device.type == "cuda":
                        torch.cuda.synchronize(trainer.device)
                    path = stop_trace()
                    trace_dir = None
                    say(f"  profiler trace of {t.profile_steps} steps -> {path} (chrome://tracing)")
                # device tensors; the watch norms have their own cadence
                for k, v in metrics.items():
                    if not k.startswith("watch/"):
                        running[k] = running[k] + v if k in running else v.clone()
                if host_step % t.print_freq_batch == 0:
                    host = _host_scalars({f"train/{k}": v for k, v in metrics.items() if not k.startswith("watch/")})
                    logger.log(host, host_step)
                    if t.halt_on_nonfinite:
                        check_finite_or_halt(host, host_step, "batch log point")
                watch_freq = cfg.obs.watch_freq_steps
                if watch_freq > 0 and host_step % watch_freq == 0:
                    logger.log(_host_scalars({k: v for k, v in metrics.items() if k.startswith("watch/")}),
                               host_step)
                # the flag lands on the ranks at different times: they agree
                # on it at the same steps, or one would leave the collectives
                if mesh.world == 1:
                    preempted = preempt.requested
                elif host_step % PREEMPT_SYNC_EVERY == 0:
                    preempted = sync_any_flag(preempt.requested, trainer.device)
                if preempted:
                    break
            clock.mark()
            if preempted:
                if profiler is not None:
                    stop_trace()
                return _preempted_exit(trainer, logger, state, epoch, best_per_class, say)
            epoch_means = {k: v / max(n_batches, 1) for k, v in _host_scalars(running).items()}
            trainer.timings["step_ms"].extend(clock.step_ms())  # after the sync above
            if t.halt_on_nonfinite:
                # catches divergence in epochs shorter than print_freq_batch
                check_finite_or_halt(epoch_means, state.step, "epoch mean")
            say(f"epoch {epoch + 1}/{t.epochs} "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(epoch_means.items()))
                + f" ({time.time() - t0:.1f}s)")
            logger.log({f"train_epoch/{k}": v for k, v in epoch_means.items()}, state.step)

            # --- validation ---
            if (epoch + 1) % t.validate_freq_epoch == 0 or epoch == t.epochs - 1:
                val = trainer.validate()
                logger.log_validation(val["miou"], val["loss"], val["per_class_iou"], state.step)
                say(f"  val mIoU={val['miou']:.4f} loss={val['loss']:.4f} ({int(val['num_images'])} images)")
                # a mask overlay of the first val sample every log_images_freq_epoch
                if (epoch + 1) % t.log_images_freq_epoch == 0 and len(trainer.val_ds):
                    whole = trainer.full_model()  # on every rank: a collective when G is sharded
                    try:
                        if mesh.is_main:
                            img_u8, label = trainer.val_ds.load(0)
                            pred = trainer.predict(img_u8[None], whole)[0]
                            logger.log_segmentation_images(img_u8, label, pred, state.step)
                    except Exception as e:  # image logging is best-effort, as the reference's
                        say(f"validation image logging skipped: {e!r}")
                    del whole
                if val["miou"] > float(state.best_miou):
                    state.best_miou = float(val["miou"])
                    best_per_class = val["per_class_iou"]
                    trainer.save("best", epoch, best_per_class, trainer.host_batches_per_epoch)
                    say(f"  new best mIoU {val['miou']:.4f} -> checkpoint saved")
                    if cfg.obs.upload_checkpoints:
                        logger.save_dir(trainer.ckpt.best_dir)

            # periodic checkpoint, skipped on the final epoch
            if (epoch + 1) % t.save_checkpoint_freq_epoch == 0 and epoch != t.epochs - 1:
                trainer.save("latest", epoch, trainer.host_batches_per_epoch)
                if cfg.obs.upload_checkpoints:
                    logger.save_dir(trainer.ckpt.latest_dir)

    if profiler is not None:  # the run ended mid-trace
        stop_trace()
    elif trace_dir is not None:
        say(f"profiler trace NOT captured: the run ended before {TRACE_SKIP} warm-up steps completed "
            f"(total steps this run: {state.step - run_start_step})")

    final_step = state.step

    # --- final report from the best checkpoint ---
    restored = trainer.ckpt.restore_into(state, "best")
    if restored is not None:
        state, meta = restored
        best_per_class = meta.get("per_class_ious", best_per_class)

    report: Dict[str, Any] = {
        "best_miou": float(state.best_miou),
        "per_class_iou": np.asarray(best_per_class) if best_per_class is not None else None,
        "epochs": t.epochs,
        "global_step": final_step,
    }
    compute_dtype = getattr(torch, cfg.model.compute_dtype)
    perf_h, perf_w = cfg.eval_size
    measure_performance = measure_performance and mesh.is_main
    whole = trainer.full_model()  # on every rank: a collective when G is sharded
    if measure_performance:
        # at the eval resolution, batch 1, as the reference measures
        report.update(performance_metrics(whole, height=perf_h, width=perf_w, iterations=t.latency_iterations,
                                          warmup=t.warmup_iterations, dtype=compute_dtype))

    if t.final_int8_eval and mesh.is_main:
        # the best model served through the int8 PTQ path (kernel K3) on the
        # whole validation set, on rank 0. Unlike the JAX package's loop, a
        # failure here is not swallowed: it would hide a fault of K3.
        from ..models.quantize import calibrate, freeze, quantized_model

        calib = []
        for images, _, _ in eval_batches(trainer.val_ds, cfg.data.eval_batch_size, cfg.data.resolved_num_workers()):
            calib.append(normalize_u8(torch.from_numpy(images).to(trainer.device), cfg.augment))
            if len(calib) >= 2:
                break
        q_vars = freeze(cfg.model, calibrate(cfg.model, eval_variables(whole.state_dict()), calib,
                                             device=trainer.device))
        q_model = quantized_model(cfg.model, frozen=True, device=trainer.device)
        load_variables(q_model, q_vars)
        fold_kernel_operands(q_model)
        q_val = trainer.validate(variables=q_model, alone=True)
        report["int8_miou"] = float(q_val["miou"])
        report["int8_miou_delta"] = report["int8_miou"] - report["best_miou"]

    say("\n=== Final results ===")
    say(f"best mIoU: {report['best_miou'] * 100:.2f}%")
    if "int8_miou" in report:
        say(f"int8 serving mIoU: {report['int8_miou'] * 100:.2f}% "
            f"(delta {report['int8_miou_delta'] * 100:+.2f} pts vs {cfg.model.compute_dtype} best)")
    if measure_performance:
        say(f"latency: {report['mean_latency_ms']:.2f} ± {report['std_latency_ms']:.2f} ms  "
            f"({report['mean_fps']:.1f} FPS) @ {perf_w}x{perf_h} on {trainer.device}")
        say(f"FLOPs: {report['flops_g']} G   params: {report['params_m']} M")
        try:  # the per-module table is best-effort, as the reference's
            from ..obs import flop_count_table

            table = flop_count_table(whole, (1, 3, perf_h, perf_w), depth=3, dtype=compute_dtype)
            say(table)
            report["flop_table"] = table
        except Exception as e:
            say(f"per-module FLOP table skipped: {e!r}")
    if report["per_class_iou"] is not None:
        say(_per_class_table(report["per_class_iou"]))

    # a prediction gallery of the best model (6 samples), best-effort
    try:
        for i in range(min(6, len(trainer.val_ds)) if mesh.is_main else 0):
            img_u8, label = trainer.val_ds.load(i)
            pred = trainer.predict(img_u8[None], whole)[0]
            logger.log_segmentation_images(img_u8, label, pred, final_step, tag=f"best/prediction_{i}")
    except Exception as e:
        say(f"prediction gallery skipped: {e!r}")

    logger.summary({k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in report.items()})
    logger.finish()
    trainer.ckpt.close()
    report.update(trainer=trainer, state=state, timings=trainer.timings)
    return report
