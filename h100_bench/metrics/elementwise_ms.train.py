"""Augmentation, losses, BatchNorm and activations: device ms a train step in
elementwise kernels (those no other group claims, copies aside)."""

from h100_bench.lib.readers import group_ms


def read(run):
    return group_ms(run, "train", "elementwise")
