"""The plain reference: the networks of ``archs/`` (one file an
architecture, found by the configuration's model name: ``nets.py``) and the
FC-Discriminator, the train augmentation, the losses and the optimizers,
written from their published descriptions in plain float32 PyTorch.

It imports nothing of the port, of ``chip_smoke.py`` or of the
``profile_*.py`` scripts, and takes nothing the port made: it is given the
benchmark's own weights, frames, labels and generator states, and works out
everything else (the augmentation draws, the batch statistics, the
optimizer state) itself. The models are functions of a dict of tensors
keyed by the port's ``state_dict`` names, so both sides load one set of
weights.
"""
