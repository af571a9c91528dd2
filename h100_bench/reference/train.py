"""The reference train step, followed for the first steps of a run.

One step (Tsai et al.'s output-space adaptation, with the segmentation
loss CE + w * binned Lovász in ``adversarial_lovasz``; CE alone in
``vanilla``): the source frames augmented (``augment``), one train-mode G
forward on the source and, when adversarial, one on the target (running
statistics moved in that order); the discriminator steps first on the
detached softmax maps (source 1, target 0, loss x 0.5); then G's loss, the
segmentation loss plus ``lambda_adv`` times the BCE of the updated D on the
live target map against 1, flows back through D (whose weights take no
gradient) and G steps. Learning rates follow the poly schedule
``lr * (1 - t / max_iter) ** power``. Adam and SGD with momentum are
PyTorch's, with the weight decay added into the gradient; AdamW is
PyTorch's, its decay taken off the weights before the step; frozen
BatchNorm affines (the configuration's ``freeze_bn``) and the leaves its
architecture names (``OPTIMIZER_SKIPS``, G's aux heads) are left out of
the optimizer.

:func:`follow` returns what the benchmark compares: each step's losses,
each leaf's first gradient as the optimizer takes it (decay included),
the norm of each leaf's raw first gradient, and each leaf's change over the
steps (the running statistics' too).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import augment as aug_ref
from .losses import bce_with_logits, cross_entropy, lovasz_binned
from .nets import arch, discriminator, generator, is_buffer
from .ops import activations, no_tf32


def poly(base: float, max_iter: int, power: float, t: int) -> float:
    return base * max(1.0 - t / float(max_iter), 0.0) ** power


def trainable(name: str, freeze_bn: bool, skips: tuple) -> bool:
    """Leaves the generator's optimizer updates: not a buffer, not under a
    prefix of ``skips``, and no BatchNorm affine where ``freeze_bn``."""
    if is_buffer(name) or name.startswith(skips):
        return False
    parts = name.split(".")
    return not (freeze_bn and len(parts) >= 2 and parts[-2] == "bn")


class Optimizer:
    """Adam (``eps`` outside the root, bias-corrected), SGD with momentum,
    both with ``weight_decay`` added into the gradient first, or AdamW
    (``adamw``: Adam on the raw gradient, the weights first scaled by
    ``1 - lr * weight_decay``)."""

    KINDS = ("adam", "adamw", "sgd")

    def __init__(self, kind, wd, momentum=0.9, betas=(0.9, 0.999), eps=1e-8):
        if kind not in self.KINDS:
            raise ValueError(f"optimizer {kind!r}: the reference has {self.KINDS}")
        self.kind, self.wd, self.momentum, self.betas, self.eps = kind, wd, momentum, betas, eps
        self.state: Dict[str, dict] = {}

    def effective(self, p, g):
        """The gradient as the optimizer's state takes it."""
        return g + self.wd * p if self.wd and self.kind != "adamw" else g

    @torch.no_grad()
    def step(self, name, p, g, lr):
        g = self.effective(p, g)
        s = self.state.setdefault(name, {"t": 0})
        s["t"] += 1
        if self.kind == "adamw" and self.wd:
            p = p * (1 - lr * self.wd)
        if self.kind == "sgd":
            s["buf"] = g.clone() if "buf" not in s else s["buf"] * self.momentum + g
            return p - lr * s["buf"]
        b1, b2 = self.betas
        s["m"] = g * (1 - b1) if "m" not in s else s["m"] * b1 + g * (1 - b1)
        s["v"] = g * g * (1 - b2) if "v" not in s else s["v"] * b2 + g * g * (1 - b2)
        c1, c2 = 1 - b1 ** s["t"], 1 - b2 ** s["t"]
        return p - (lr / c1) * s["m"] / (s["v"].sqrt() / c2 ** 0.5 + self.eps)


def _seg_loss(cfg, logits, labels):
    loss_cfg = cfg["loss"]
    loss = cross_entropy(logits, labels, loss_cfg["ignore_index"])
    if loss_cfg["use_lovasz"]:
        probas = torch.softmax(logits.float(), dim=1)
        loss = loss + loss_cfg["lovasz_weight"] * lovasz_binned(
            probas, labels, loss_cfg["ignore_index"], loss_cfg["lovasz_bins"], loss_cfg["lovasz_interp"])
    return loss


def _source(cfg, batch, gen):
    a = cfg["augment"]
    if cfg["data"]["train_dataset"] != "cityscapes" and a["pipeline"] != "no_new_aug":
        x, labels = aug_ref.augment(batch["image"], batch["label"], gen, a)
    else:
        x, labels = aug_ref.normalize(batch["image"].float() / 255.0, a), batch["label"]
    return x.permute(0, 3, 1, 2).contiguous(), labels


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def follow(cfg: dict, g_weights: dict, d_weights, batches: List[dict], gen_states: List[torch.Tensor],
           device, fp8: bool = False) -> dict:
    """Run ``len(batches)`` reference steps from the given weights, in
    float32 with TF32 off (the forwards in float8 with ``fp8``: the
    control); ``gen_states[t]`` is the augmentation generator's state
    before step ``t``."""
    with no_tf32():
        return _follow(cfg, g_weights, d_weights, batches, gen_states, device, fp8)


def _follow(cfg, g_weights, d_weights, batches, gen_states, device, fp8):
    model, opt_cfg, adv = cfg["model"], cfg["optimizer"], cfg["adversarial"]
    skips = tuple(arch(model).OPTIMIZER_SKIPS)
    max_iter = cfg["schedule"]["max_iter"]
    G = {k: v.detach().float().clone() for k, v in g_weights.items()}
    leaves = [k for k in G if trainable(k, cfg.get("freeze_bn", False), skips)]
    grad_leaves = [k for k in G if trainable(k, False, skips)]
    g_opt = Optimizer(opt_cfg["name"], opt_cfg["weight_decay"], opt_cfg["sgd_momentum"],
                      (opt_cfg["adam_b1"], opt_cfg["adam_b2"]))
    D, d_opt = None, None
    if adv["enabled"]:
        D = {k: v.detach().float().clone() for k, v in d_weights.items()}
        d_opt = Optimizer(adv["disc_optimizer"], adv["disc_weight_decay"], 0.9,
                          (adv["disc_adam_b1"], adv["disc_adam_b2"]))
    start = {**{f"g.{k}": v.clone() for k, v in G.items()}, **({f"d.{k}": v.clone() for k, v in D.items()} if D else {})}
    out = {"loss": [], "loss_d": [], "grad": {}, "raw_grad": {}}
    for t, batch in enumerate(batches):
        gen = torch.Generator(device=device)
        gen.set_state(gen_states[t])
        lr = poly(opt_cfg["learning_rate"], max_iter, opt_cfg["poly_power"], t)
        for k in grad_leaves:
            G[k].requires_grad_(True)
        with activations(fp8):
            x_s, labels = _source(cfg, batch, gen)
            pred_s = generator(model, G, x_s, True, G)
        if D is not None:
            for v in D.values():
                v.requires_grad_(True)
            with activations(fp8):
                x_t = aug_ref.normalize(batch["target_image"].float() / 255.0, cfg["augment"]).permute(0, 3, 1, 2)
                pred_t = generator(model, G, x_t.contiguous(), True, G)
                sm_t = torch.softmax(pred_t, dim=1)
                d_s = discriminator(D, torch.softmax(pred_s.detach(), dim=1))
                d_t = discriminator(D, sm_t.detach())
            loss_d = 0.5 * (bce_with_logits(d_s, 1.0) + bce_with_logits(d_t, 0.0))
            dg = dict(zip(D, torch.autograd.grad(loss_d, list(D.values()))))
            if t == 0:
                out["grad"].update({f"d.{k}": d_opt.effective(D[k], g) for k, g in dg.items()})
                out["raw_grad"].update({f"d.{k}": g for k, g in dg.items()})
            lr_d = poly(adv["disc_learning_rate"], max_iter, opt_cfg["poly_power"], t)
            D = {k: d_opt.step(k, D[k].detach(), dg[k], lr_d) for k in D}
            with activations(fp8):
                d_live = discriminator(D, sm_t)
            loss = _seg_loss(cfg, pred_s, labels) + adv["lambda_adv"] * bce_with_logits(d_live, 1.0)
            out["loss_d"].append(float(loss_d.detach()))
        else:
            loss = _seg_loss(cfg, pred_s, labels)
        gg = dict(zip(grad_leaves, torch.autograd.grad(loss, [G[k] for k in grad_leaves])))
        if t == 0:
            out["grad"].update({f"g.{k}": g_opt.effective(G[k].detach(), gg[k]) for k in leaves})
            out["raw_grad"].update({f"g.{k}": gg[k] for k in leaves})
        for k in grad_leaves:
            G[k] = G[k].detach()
        for k in leaves:
            G[k] = g_opt.step(k, G[k], gg[k], lr)
        out["loss"].append(float(loss.detach()))
        if t == 0:
            out["grad"], out["raw_grad"] = _norms(out["grad"]), _norms(out["raw_grad"])
    now = {**{f"g.{k}": v for k, v in G.items()}, **({f"d.{k}": v for k, v in D.items()} if D else {})}
    out["change"] = _norms({k: now[k].detach() - start[k] for k in start
                            if k in out["grad"] or is_buffer(k)})
    return out
