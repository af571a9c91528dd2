"""The train step (port of the JAX ``train/steps.py``): the source-only
modes ``vanilla`` (CE) and ``lovasz`` (CE + w * Lovász), and the
adversarial modes ``adversarial`` and ``adversarial_lovasz``.

A source-only step: on-device augmentation and normalization of the uint8
batch, a train-mode forward (BatchNorm batch statistics, running statistics
updated), the loss, the backward, the poly learning rate and one optimizer
update. With the binned Lovász loss the forward histograms run on kernel K1
and the backward on kernel K2.

An adversarial step (the reference's ``train.py:238-313``): one train-mode
G forward on the source and one on the target, BatchNorm statistics updated
in that order; the discriminator steps first, on the detached softmax maps
(source real = 1, target fake = 0, loss x 0.5); then G's loss, the
segmentation loss plus ``lambda_adv`` times the BCE of the *updated* D on
the live target map against "real", flows back through D into G and only G
steps. With ``fused_conv1`` D's first conv runs on kernels K5a-c: K5a on
each of the three D forwards, K5b on the D step's two backward passes, K5c
on G's path back through D.

With ``train.remat`` each G forward runs under
``torch.utils.checkpoint`` (where the JAX package applies
``jax.checkpoint``): the backward recomputes the forward's activations
instead of keeping them. The recompute holds the BatchNorm running
statistics (``models/layers.py::running_stats_held``), so they move once a
forward, as in JAX, whose checkpoint is functional.

Data parallel (a ``mesh``, ``parallel.MeshContext``): each rank holds the
rows of its data index of the global batch. The augmentation draws are the
global batch's, cut to those rows; the BatchNorm statistics are the global
batch's (``models/layers.py::sync_batch_norm``, which the caller applies);
each loss is the data index's share of the global loss
(``ops/losses.py``); after each backward one coalesced ``all_reduce`` per
model and kind sums the gradients (``MeshContext.reduce_grads``). Tensor
parallel (``parallel/tp.py::shard_state``, model > 1): the ranks of a
model group see the same rows and each holds its slice of the wide
kernels; the gradient norms count the slices' squares summed over the
model group, so every metric is the whole model's. Not
``DistributedDataParallel``: the adversarial step backpropagates G's loss
through the updated D, whose gradients must be neither reduced nor
applied, and DeepLabV2 has parameters outside its optimizer, on both of
which DDP's reducer hooks misfire. The metrics are the global values: the
shares summed over the data group in one more ``all_reduce``.

The step reads nothing back to the host, so it never waits for the device;
its metrics are device tensors. It clears the gradients of the whole model
before each backward, so a parameter outside the optimizer (DeepLabV2's
frozen BatchNorm, ``train/optim.py``) holds only this step's gradient.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ExperimentConfig
from ..models.layers import running_stats_held
from ..ops.augment import augment_batch, normalize_u8
from ..ops.losses import bce_with_logits, cross_entropy_with_ignore, lovasz_softmax, lovasz_softmax_binned
from ..parallel.tp import sharded_ids
from .state import TrainState

Metrics = Dict[str, torch.Tensor]

REAL_LABEL = 1.0  # source domain
FAKE_LABEL = 0.0  # target domain


def _prep_source(batch, generator, cfg: ExperimentConfig, mesh=None):
    """Augmentation + normalization of the uint8 source batch. A Cityscapes
    source and the ``no_new_aug`` pipeline get normalization only, at the
    compute dtype floored at f32."""
    images_u8, labels = batch["image"], batch["label"]
    if cfg.data.train_dataset != "cityscapes" and cfg.augment.pipeline != "no_new_aug":
        rows = None if mesh is None else mesh.rows(images_u8.shape[0])
        return augment_batch(images_u8, labels, generator, cfg.augment, rows=rows)
    dt = torch.promote_types(getattr(torch, cfg.model.compute_dtype), torch.float32)
    return normalize_u8(images_u8, cfg.augment, dtype=dt), labels


def _block_mean(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool a (B, C, H, W) map by ``factor`` per spatial axis
    (``adversarial.disc_downsample``); 1 is the identity."""
    if factor == 1:
        return x
    b, c, h, w = x.shape
    if h % factor or w % factor:
        raise ValueError(
            f"adversarial.disc_downsample={factor} must divide the train "
            f"resolution; got a {h}x{w} map"
        )
    return x.reshape(b, c, h // factor, factor, w // factor, factor).mean(dim=(3, 5))


def _disc_input(pred: torch.Tensor, pool: int, dtype: torch.dtype) -> torch.Tensor:
    """What D consumes: the softmax, in at least f32, of the block-mean
    pooled logits, cast to the compute dtype in contiguous NCHW (the layout
    the K5 kernels read; the cast is the one pass that writes it)."""
    pooled = _block_mean(pred, pool)
    if min(pooled.shape[2], pooled.shape[3]) < 32:
        raise ValueError(
            f"discriminator input {pooled.shape[2]}x{pooled.shape[3]} (train "
            f"resolution / disc_downsample={pool}) is below the 32-pixel minimum "
            "side the 5-conv stride-2 trunk supports — lower "
            "adversarial.disc_downsample or raise the train resolution"
        )
    probs = torch.softmax(pooled.to(torch.promote_types(pooled.dtype, torch.float32)), dim=1)
    return probs.to(dtype, memory_format=torch.contiguous_format)


def _norms(groups: Dict[str, list], mesh) -> Metrics:
    """The L2 norm of each group of ``(tensor, sharded)`` pairs. Without a
    sharded tensor, ``get_total_norm``; with them (tensor parallel: this
    rank's slices), the squares of the replicated tensors plus those of the
    slices summed over the model group, in f64, one ``all_reduce`` for all
    the groups."""
    if not any(sharded for ts in groups.values() for _, sharded in ts):
        return {k: torch.nn.utils.get_total_norm([t for t, _ in ts]) for k, ts in groups.items()}
    device = next(iter(groups.values()))[0][0].device
    zero = torch.zeros((), dtype=torch.float64, device=device)
    squares = [torch.stack([sum((t.detach().double().square().sum() for t, sh in ts if sh == kind), zero)
                            for ts in groups.values()]) for kind in (False, True)]
    total = (squares[0] + mesh.model_sum_(squares[1])).sqrt()
    return {k: total[i].to(ts[0][0].dtype) for i, (k, ts) in enumerate(groups.items())}


def _grad_norm(module: torch.nn.Module, mesh=None) -> torch.Tensor:
    shards = sharded_ids(module)
    return _norms({"": [(p.grad, id(p) in shards) for p in module.parameters() if p.grad is not None]}, mesh)[""]


def _watch_norms(module: torch.nn.Module, tag: str, mesh=None) -> Metrics:
    """Per-top-level-module L2 norms of the parameters and their gradients,
    ``watch/<tag>/<module>/param_norm`` and ``.../grad_norm``, as the JAX
    package's ``_watch_norms`` computes them. The port's modules carry the
    flax paths, so the first component of a parameter's name is the flax
    top-level module; batch statistics are buffers and take no part. A
    module without gradients (the aux heads at ``aux_weight == 0``) has a
    zero gradient in JAX, so its ``grad_norm`` is 0. Sharded kernels count
    whole (their slices' squares summed over the model group)."""
    shards = sharded_ids(module)
    params: Dict[str, list] = {}
    grads: Dict[str, list] = {}
    for name, p in module.named_parameters():
        top = name.split(".", 1)[0]
        params.setdefault(top, []).append((p.detach(), id(p) in shards))
        grads.setdefault(top, [])
        if p.grad is not None:
            grads[top].append((p.grad, id(p) in shards))
    param_norms = _norms(params, mesh)
    grad_norms = _norms({top: gs for top, gs in grads.items() if gs}, mesh)
    out: Metrics = {}
    for top, ps in params.items():
        p = ps[0][0]
        out[f"watch/{tag}/{top}/param_norm"] = param_norms[top]
        out[f"watch/{tag}/{top}/grad_norm"] = grad_norms.get(top, torch.zeros((), device=p.device, dtype=p.dtype))
    return out


def _update(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def _apply_train(model: torch.nn.Module, x: torch.Tensor, aux: bool, remat: bool = False):
    """Train-mode forward of NCHW ``x``: (logits, sup1, sup2), the aux heads
    None unless ``aux``; with ``remat`` under ``checkpoint``, its recompute
    holding the running statistics."""
    model.train()
    if not remat:
        return model(x, aux=aux)
    return checkpoint(model, x, aux=aux, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), running_stats_held(model)))


def _seg_loss(logits, labels, cfg: ExperimentConfig, aux: Tuple = (), mesh=None) -> Tuple[torch.Tensor, Metrics]:
    loss_cfg = cfg.loss
    ce = cross_entropy_with_ignore(logits, labels, loss_cfg.ignore_index, mesh=mesh)
    total, parts = ce, {"loss_ce": ce}
    if loss_cfg.aux_weight and any(a is not None for a in aux):
        aux_ce = sum(cross_entropy_with_ignore(a, labels, loss_cfg.ignore_index, mesh=mesh)
                     for a in aux if a is not None)
        total = total + loss_cfg.aux_weight * aux_ce
        parts["loss_aux"] = aux_ce
    if loss_cfg.use_lovasz:
        probas = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=1)
        if loss_cfg.lovasz_impl == "binned":
            lov = lovasz_softmax_binned(probas, labels, loss_cfg.ignore_index,
                                        bins=loss_cfg.lovasz_bins, interp=loss_cfg.lovasz_interp, mesh=mesh)
        else:
            lov = lovasz_softmax(probas, labels, loss_cfg.ignore_index, mesh=mesh)
        total = total + loss_cfg.lovasz_weight * lov
        parts["loss_lovasz"] = lov
    return total, parts


def _global_losses(metrics: Metrics, mesh) -> Metrics:
    """The losses' global values: the data group's shares summed, in one
    ``all_reduce`` (the identity for one data index)."""
    keys = [k for k in metrics if k.startswith("loss")]
    if mesh is None or mesh.data_size == 1 or not keys:
        return metrics
    summed = mesh.sum_(torch.stack([metrics[k].detach().to(torch.float64) for k in keys]))
    return {**metrics, **{k: summed[i].to(metrics[k].dtype) for i, k in enumerate(keys)}}


def make_train_step(cfg: ExperimentConfig, g_schedule: Callable[[int], float],
                    d_schedule: Optional[Callable[[int], float]] = None, mesh=None):
    """``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds uint8 NHWC ``image``, int32 NHW ``label`` and, in the
    adversarial modes, uint8 NHWC ``target_image``, on the device;
    ``generator`` is a ``torch.Generator`` on that device, the source of the
    augmentation draws. The step updates ``state.model`` and
    ``state.optimizer`` (and ``state.discriminator`` and
    ``state.d_optimizer``) in place and advances ``state.step``; update
    ``t`` runs at learning rates ``state.schedule(t)`` and
    ``state.d_schedule(t)``. The metrics are device tensors: ``loss``,
    ``lr`` (``g_schedule`` of the update), ``grad_norm`` (global L2 norm of
    G's gradients), ``loss_ce`` and, when on, ``loss_lovasz`` and
    ``loss_aux``; the adversarial modes add ``loss_d``, ``lr_d``
    (``d_schedule``), ``grad_norm_d``, ``loss_seg`` and ``loss_adv_g``.
    With ``obs.watch_freq_steps > 0`` every step adds the JAX package's
    ``watch/g/<module>/{param,grad}_norm`` (and ``watch/d/...``), the
    parameters' norms taken after the update. With a ``mesh`` the batch is
    this rank's rows of the global batch (see the module's docstring).
    """
    remat = cfg.train.remat
    adversarial = cfg.adversarial.enabled
    if adversarial and cfg.adversarial.disc_downsample < 1:
        raise ValueError(
            "adversarial.disc_downsample must be >= 1, got "
            f"{cfg.adversarial.disc_downsample}"
        )
    if adversarial and d_schedule is None:
        raise ValueError("the adversarial modes need d_schedule")
    compute_dtype = getattr(torch, cfg.model.compute_dtype)
    use_aux = bool(cfg.loss.aux_weight)
    watch = cfg.obs.watch_freq_steps > 0

    def source_step(state: TrainState, batch, generator) -> Tuple[TrainState, Metrics]:
        images, labels = _prep_source(batch, generator, cfg, mesh)
        # NHWC -> NCHW view: channels_last memory, which the convs read as it is
        x = images.to(compute_dtype).permute(0, 3, 1, 2)
        logits, sup1, sup2 = _apply_train(state.model, x, use_aux, remat)
        loss, parts = _seg_loss(logits, labels, cfg, aux=(sup1, sup2), mesh=mesh)
        state.model.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            mesh.reduce_grads(state.model, sharded_ids(state.model))
        grad_norm = _grad_norm(state.model, mesh)
        _update(state.optimizer, state.schedule(state.step))
        metrics = {
            "loss": loss.detach(),
            "lr": torch.full((), g_schedule(state.step), device=loss.device),
            "grad_norm": grad_norm,
            **{k: v.detach() for k, v in parts.items()},
        }
        if watch:
            metrics.update(_watch_norms(state.model, "g", mesh))
        state.step += 1
        return state, _global_losses(metrics, mesh)

    def adversarial_step(state: TrainState, batch, generator) -> Tuple[TrainState, Metrics]:
        images_s, labels_s = _prep_source(batch, generator, cfg, mesh)
        images_t = normalize_u8(batch["target_image"], cfg.augment,
                                dtype=torch.promote_types(compute_dtype, torch.float32))
        g, d = state.model, state.discriminator
        # one G forward per domain, source first (BatchNorm statistics in that
        # order); its graph serves G's backward
        pred_s, sup1, sup2 = _apply_train(g, images_s.to(compute_dtype).permute(0, 3, 1, 2), use_aux, remat)
        pred_t, _, _ = _apply_train(g, images_t.to(compute_dtype).permute(0, 3, 1, 2), False, remat)
        pool = cfg.adversarial.disc_downsample
        sm_t_live = _disc_input(pred_t, pool, compute_dtype)

        # D first, on the detached maps
        sm_s = _disc_input(pred_s.detach(), pool, compute_dtype)
        sm_t = sm_t_live.detach()
        d.zero_grad(set_to_none=True)
        loss_d = 0.5 * (bce_with_logits(d(sm_s), REAL_LABEL, mesh) + bce_with_logits(d(sm_t), FAKE_LABEL, mesh))
        loss_d.backward()
        if mesh is not None:
            mesh.reduce_grads(d, sharded_ids(d))
        grad_norm_d = _grad_norm(d, mesh)
        _update(state.d_optimizer, state.d_schedule(state.step))

        # G through the updated D: D's parameters take no gradient
        loss_seg, parts = _seg_loss(pred_s, labels_s, cfg, aux=(sup1, sup2), mesh=mesh)
        d.requires_grad_(False)
        try:
            loss_adv = bce_with_logits(d(sm_t_live), REAL_LABEL, mesh)
        finally:
            d.requires_grad_(True)
        loss = loss_seg + cfg.adversarial.lambda_adv * loss_adv
        g.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            mesh.reduce_grads(g, sharded_ids(g))
        grad_norm = _grad_norm(g, mesh)
        _update(state.optimizer, state.schedule(state.step))
        metrics = {
            "loss": loss.detach(),
            "loss_d": loss_d.detach(),
            "lr": torch.full((), g_schedule(state.step), device=loss.device),
            "lr_d": torch.full((), d_schedule(state.step), device=loss.device),
            "grad_norm": grad_norm,
            "grad_norm_d": grad_norm_d,
            **{k: v.detach() for k, v in parts.items()},
            "loss_seg": loss_seg.detach(),
            "loss_adv_g": loss_adv.detach(),
        }
        if watch:
            metrics.update(_watch_norms(g, "g", mesh))
            metrics.update(_watch_norms(d, "d", mesh))
        state.step += 1
        return state, _global_losses(metrics, mesh)

    return adversarial_step if adversarial else source_step
