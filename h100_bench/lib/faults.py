"""Faults planted in the port, to show that the comparison catches them.

Each is a context manager that breaks the timed path underneath the
harness while it is open; build the program inside it.

- ``unchanged``: a train step that leaves the weights and the optimizer
  as they were;
- ``half_batch``: a train step that sees only the first half of the
  batch's rows, its losses the mean over them;
- ``altered_answer``: serving whose first frame's mask, in every request,
  comes out moved to the next class.
"""

from __future__ import annotations

import contextlib

CLASSES = 19  # the Cityscapes trainIds every configuration serves


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged():
    from rtda_semanticsegmentation_tpu_torch.train import steps

    return _patched(steps, "_update", lambda optimizer, lr: None)


def half_batch():
    from rtda_semanticsegmentation_tpu_torch.train import steps

    make = steps.make_train_step

    def broken(*args, **kw):
        step = make(*args, **kw)

        def halved(state, batch, generator):
            return step(state, {k: v[: max(v.shape[0] // 2, 1)] for k, v in batch.items()}, generator)

        return halved

    return _patched(steps, "make_train_step", broken)


def altered_answer():
    from rtda_semanticsegmentation_tpu_torch import serving

    forward = serving.ServingModule.forward

    def broken(self, images_u8):
        masks = forward(self, images_u8).clone()
        masks[0] = (masks[0] + 1) % CLASSES
        return masks

    return _patched(serving.ServingModule, "forward", broken)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer}
