"""Bytes the binned Lovász kernels must move, counted from shapes: each
input byte read once, each output byte written once.

- K1 (histograms): reads (B, C, N) float32 probabilities and (B, N) int32
  labels, writes (C, 3, bins) float32 histograms.
- K2 (backward): reads the probabilities, the labels and the (C, 2, bins)
  float32 coefficient table, writes the (B, C, N) float32 gradient.

At (8, 19, 512 x 1024) and 256 bins K1 moves 335.6 MB; on the flagship's
(8, 19, 720 x 1280) map K1 589.8 MB and K2 1150 MB.
"""


def k1_bytes(b: int, c: int, n: int, bins: int) -> int:
    return 4 * b * c * n + 4 * b * n + 4 * c * 3 * bins


def k2_bytes(b: int, c: int, n: int, bins: int, interp: bool = True) -> int:
    table = c * (2 if interp else 1) * bins
    return 2 * 4 * b * c * n + 4 * b * n + 4 * table
