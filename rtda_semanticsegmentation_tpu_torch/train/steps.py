"""The train step of the source-only modes (port of the JAX
``train/steps.py``): ``vanilla`` (CE) and ``lovasz`` (CE + w * Lovász).

One step: on-device augmentation and normalization of the uint8 batch, a
train-mode forward (BatchNorm batch statistics, running statistics
updated), the loss, the backward, the poly learning rate and one optimizer
update. With the binned Lovász loss the forward histograms run on kernel K1
and the backward on kernel K2. The step reads nothing back to the host, so
it never waits for the device; its metrics are device tensors.

The adversarial modes are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..config import ExperimentConfig
from ..ops.augment import augment_batch, normalize_u8
from ..ops.losses import cross_entropy_with_ignore, lovasz_softmax, lovasz_softmax_binned
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


def _prep_source(batch, generator, cfg: ExperimentConfig):
    """Augmentation + normalization of the uint8 source batch. A Cityscapes
    source and the ``no_new_aug`` pipeline get normalization only, at the
    compute dtype floored at f32."""
    images_u8, labels = batch["image"], batch["label"]
    if cfg.data.train_dataset != "cityscapes" and cfg.augment.pipeline != "no_new_aug":
        return augment_batch(images_u8, labels, generator, cfg.augment)
    dt = torch.promote_types(getattr(torch, cfg.model.compute_dtype), torch.float32)
    return normalize_u8(images_u8, cfg.augment, dtype=dt), labels


def _apply_train(model: torch.nn.Module, x: torch.Tensor, aux: bool):
    """Train-mode forward of NCHW ``x``: (logits, sup1, sup2), the aux heads
    None unless ``aux``."""
    model.train()
    return model(x, aux=aux)


def _seg_loss(logits, labels, cfg: ExperimentConfig, aux: Tuple = ()) -> Tuple[torch.Tensor, Metrics]:
    loss_cfg = cfg.loss
    ce = cross_entropy_with_ignore(logits, labels, loss_cfg.ignore_index)
    total, parts = ce, {"loss_ce": ce}
    if loss_cfg.aux_weight and any(a is not None for a in aux):
        aux_ce = sum(cross_entropy_with_ignore(a, labels, loss_cfg.ignore_index)
                     for a in aux if a is not None)
        total = total + loss_cfg.aux_weight * aux_ce
        parts["loss_aux"] = aux_ce
    if loss_cfg.use_lovasz:
        probas = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=1)
        if loss_cfg.lovasz_impl == "binned":
            lov = lovasz_softmax_binned(probas, labels, loss_cfg.ignore_index,
                                        bins=loss_cfg.lovasz_bins, interp=loss_cfg.lovasz_interp)
        else:
            lov = lovasz_softmax(probas, labels, loss_cfg.ignore_index)
        total = total + loss_cfg.lovasz_weight * lov
        parts["loss_lovasz"] = lov
    return total, parts


def make_train_step(cfg: ExperimentConfig, g_schedule: Callable[[int], float]):
    """``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds uint8 NHWC ``image`` and int32 NHW ``label`` on the
    device; ``generator`` is a ``torch.Generator`` on that device, the
    source of the augmentation draws. The step updates ``state.model`` and
    ``state.optimizer`` in place and advances ``state.step``; update ``t``
    runs at learning rate ``state.schedule(t)``. The metrics are device
    tensors: ``loss``, ``lr`` (``g_schedule`` of the update), ``grad_norm``
    (global L2 norm of the gradients), ``loss_ce`` and, when on,
    ``loss_lovasz`` and ``loss_aux``.
    """
    if cfg.train_mode not in ("vanilla", "lovasz"):
        raise NotImplementedError(f"train mode {cfg.train_mode!r} is not ported to the PyTorch package yet")
    if cfg.train.remat:
        raise NotImplementedError("train.remat is not ported to the PyTorch package yet")
    compute_dtype = getattr(torch, cfg.model.compute_dtype)
    use_aux = bool(cfg.loss.aux_weight)

    def step(state: TrainState, batch, generator) -> Tuple[TrainState, Metrics]:
        images, labels = _prep_source(batch, generator, cfg)
        # NHWC -> NCHW view: channels_last memory, which the convs read as it is
        x = images.to(compute_dtype).permute(0, 3, 1, 2)
        logits, sup1, sup2 = _apply_train(state.model, x, use_aux)
        loss, parts = _seg_loss(logits, labels, cfg, aux=(sup1, sup2))
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in state.model.parameters() if p.grad is not None])
        for group in opt.param_groups:
            group["lr"] = state.schedule(state.step)
        opt.step()
        metrics = {
            "loss": loss.detach(),
            "lr": torch.full((), g_schedule(state.step), device=loss.device),
            "grad_norm": grad_norm,
            **{k: v.detach() for k, v in parts.items()},
        }
        state.step += 1
        return state, metrics

    return step
