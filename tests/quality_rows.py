"""Seeded phred rows for the quality-offsets tests and chip_smoke.py's
check of the kernel on the card, numpy only: all-zero reads, q = 0 runs,
reads with no usable window, low-quality ends (usable < L), high-quality
islands (desired clamped by potential), uniformly middling reads and one
short island whose keys' error product rejects the read. Binned to <= 16
values, so the palette-packed route takes them."""
import numpy as np


def qualities(B, L, seed):
    """(B, L) int8 phred rows over the ladder's cases."""
    rng = np.random.default_rng(seed)
    levels = np.array([0, 2, 5, 9, 12, 16, 22, 27, 32, 37], np.int8)
    q = levels[rng.integers(4, 10, (B, L))]
    q[0] = 0                                   # all zero: no key
    q[1] = 2                                   # no usable window
    q[2, :L // 3] = 2                          # low-quality ends
    q[2, -L // 4:] = 2
    q[3] = 2                                   # high-quality islands
    for at in rng.integers(0, L - 20, 3):
        q[3, at:at + 18] = 37
    q[4, L // 2:L // 2 + 9] = 0                # a q = 0 run
    q[5::3, rng.integers(0, L, 4)] = 0         # scattered zeros
    q[6::5, :20] = 5
    q[7] = 9                                   # uniformly middling
    dips = rng.random((B, L)) < 0.03
    q[8:][dips[8:]] = 2
    q[5] = 2                                   # one short island: its keys'
    q[5, L // 2:L // 2 + 12] = 12              # error product > 0.5, reject
    return q
