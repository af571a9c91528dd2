"""The generator's and the discriminator's optimizers (port of the JAX
``train/optim.py``).

SGD(momentum) or Adam, with the reference's weight decay: torch's L2 added
into the gradient before the optimizer's own update, as
``optax.add_decayed_weights`` placed before the optimizer in the JAX
package. AdamW (SegFormer's, which the JAX package lacks) decouples it:
the weights are scaled by ``1 - lr * weight_decay`` and Adam runs on the
raw gradient. Adam's and AdamW's ``eps`` sit outside the square root, as
in ``optax.scale_by_adam``. The learning rate is set per
step by the train step from the state's schedule.

DeepLabV2's frozen BatchNorm (``freeze_bn``): JAX gives every ``bn/scale``
and ``bn/bias`` a zero update through ``optax.set_to_zero`` (no step, no
momentum, no decay) while their gradients are still taken and counted in
``grad_norm``. Here those parameters keep ``requires_grad`` and stay out
of the optimizer: it never touches them. The train step clears the
gradients of the whole model (``model.zero_grad``), not only the
optimizer's, so theirs do not add up from step to step.
"""

from __future__ import annotations

import torch

from ..config import AdversarialConfig, OptimizerConfig


def is_bn_affine(name: str) -> bool:
    """A BatchNorm scale or bias by its name, ``.../bn.weight`` or
    ``.../bn.bias``: the JAX package's ``bn_param_labels`` rule on the
    flax path (``.../bn/scale``, ``.../bn/bias``)."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "bn" and parts[-1] in ("weight", "bias")


def build_generator_tx(cfg: OptimizerConfig, model: torch.nn.Module, freeze_bn: bool = False,
                       decay_exempt: tuple = ()) -> torch.optim.Optimizer:
    """The optimizer over ``model``'s parameters.

    ``decay_exempt``: top-level module names whose parameters get no weight
    decay (their own param group). With ``aux_weight == 0`` the aux heads
    ``supervision1``/``supervision2`` are exempt and also get no gradient,
    so the optimizer skips them (``grad is None``): they stay at their init,
    as the JAX package's masked decay plus zero gradient keeps them.
    ``freeze_bn``: every BatchNorm scale and bias (:func:`is_bn_affine`)
    is left out of the optimizer (module docstring)."""
    exempt = frozenset(decay_exempt)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if freeze_bn and is_bn_affine(name):
            continue
        groups[name.split(".", 1)[0] in exempt].append(p)
    params = [{"params": groups[False], "weight_decay": cfg.weight_decay}]
    if groups[True]:
        params.append({"params": groups[True], "weight_decay": 0.0})
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.sgd_momentum)
    if cfg.name in ("adam", "adamw"):
        adam = torch.optim.Adam if cfg.name == "adam" else torch.optim.AdamW
        return adam(params, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)
    raise ValueError(f"unknown optimizer {cfg.name!r}; options: sgd, adam, adamw")


def build_discriminator_tx(cfg: AdversarialConfig, model: torch.nn.Module) -> torch.optim.Optimizer:
    """The discriminator's optimizer: Adam with ``(disc_adam_b1,
    disc_adam_b2)``, or SGD with momentum 0.9, at ``disc_learning_rate``
    with ``disc_weight_decay`` as L2 into the gradient."""
    params = list(model.parameters())
    if cfg.disc_optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.disc_learning_rate, betas=(cfg.disc_adam_b1, cfg.disc_adam_b2),
                                eps=1e-8, weight_decay=cfg.disc_weight_decay)
    if cfg.disc_optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.disc_learning_rate, momentum=0.9,
                               weight_decay=cfg.disc_weight_decay)
    raise ValueError(f"unknown disc optimizer {cfg.disc_optimizer!r}; options: adam, sgd")
