"""FLOPs of a train step or a serving request, counted by
``FlopCounterMode`` (2 per multiply-accumulate of the convs and matrix
products) on the reference's models on the ``meta`` device, so no tensor
is made and whatever runs the work, the count is the same.

A train step counts what the reference's step differentiates: G forward
on the source (and the target), D forward on the two detached maps and
its weight gradients, then G's loss through the updated D (D's input
gradient, no weight gradient) and G's weight gradients; the first conv's
input takes no gradient. The losses themselves hold no matrix products
and are replaced by sums here.
"""

from __future__ import annotations

import torch

from h100_bench.reference import nets


def _meta(shapes, grad: bool):
    return {n: torch.empty(s, device="meta", requires_grad=grad and not nets.is_buffer(n)) for n, s in shapes}


def _counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def train_step_flops(config: dict, traffic: dict) -> float:
    model, adv = config["model"], config["adversarial"]["enabled"]
    b = traffic["batch"]

    def step():
        G = _meta(nets.param_shapes(model, train=True), True)
        leaves = [v for v in G.values() if v.requires_grad]
        x_s = torch.empty((b, 3, *traffic["source"]), device="meta")
        pred_s = nets.generator(model, G, x_s, True, dict(G))
        loss = pred_s.float().sum()
        if adv:
            D = _meta(nets.discriminator_shapes(model), True)
            x_t = torch.empty((b, 3, *traffic["target"]), device="meta")
            sm_t = torch.softmax(nets.generator(model, G, x_t, True, dict(G)), dim=1)
            loss_d = nets.discriminator(D, torch.softmax(pred_s.detach(), 1)).sum() + \
                nets.discriminator(D, sm_t.detach()).sum()
            torch.autograd.grad(loss_d, list(D.values()))
            frozen = {k: v.detach() for k, v in D.items()}
            loss = loss + nets.discriminator(frozen, sm_t).sum()
        torch.autograd.grad(loss, leaves, allow_unused=True)

    return _counted(step)


def serve_flops(config: dict, traffic: dict) -> float:
    model = config["model"]

    def forward():
        P = _meta(nets.param_shapes(model, train=False), False)
        x = torch.empty((traffic["batch"], 3, *traffic["size"]), device="meta")
        with torch.no_grad():
            nets.generator(model, P, x, False, P)

    return _counted(forward)
