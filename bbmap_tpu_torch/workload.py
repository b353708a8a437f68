"""The short-read bench workload, made from a seed with numpy: a random
genome with implanted repeat families and FR pairs with an Illumina-like
error and quality model. Own copy of the generators in the repository's
``bench.py`` (make_genome, make_pairs; same seeds give the same bytes), so
that the port's smoke run and tests draw the workload without the JAX
package.
"""

from __future__ import annotations

import numpy as np

from .core.bases import COMP_ASCII


def make_genome(n=4_600_000, seed=7):
    """Random body + implanted repeat families (divergence 1%)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(bases, size=n).astype(np.uint8)

    def implant(length, copies, divergence=0.01):
        unit = rng.choice(bases, size=length).astype(np.uint8)
        for _ in range(copies):
            at = int(rng.integers(0, n - length))
            u = unit.copy()
            nmut = int(length * divergence)
            if nmut:
                pos = rng.choice(length, size=nmut, replace=False)
                u[pos] = bases[rng.integers(0, 4, size=nmut)]
            g[at:at + length] = u

    implant(5000, 7)     # rRNA-operon-like
    implant(1200, 20)    # IS-element-like
    implant(700, 30)     # short diverged repeats
    return g


def _mutate(reads, windows, rng, L):
    """~78% clean, 12% 1-3 subs, 5% one 1-10 bp deletion, 5% one
    1-10 bp insertion (per mate)."""
    n_reads = len(reads)
    bases = np.frombuffer(b"ACGT", np.uint8)
    r = rng.random(n_reads)
    sub_rows = np.nonzero((r >= 0.78) & (r < 0.90))[0]
    del_rows = np.nonzero((r >= 0.90) & (r < 0.95))[0]
    ins_rows = np.nonzero(r >= 0.95)[0]
    for i in sub_rows:
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, L))
            reads[i, p] = bases[int(rng.integers(0, 4))]
    for i in del_rows:
        d = int(rng.integers(1, 11))
        p = int(rng.integers(10, L - 10))
        w = windows[i]
        reads[i] = np.concatenate([w[:p], w[p + d:p + d + (L - p)]])
    for i in ins_rows:
        d = int(rng.integers(1, 11))
        p = int(rng.integers(10, L - 10))
        ins = bases[rng.integers(0, 4, size=d)]
        reads[i] = np.concatenate([reads[i, :p], ins,
                                   reads[i, p:L - d]])
    return reads


def make_quality(rng, n_reads, L):
    """Illumina-like phred profile: high plateau with a sagging tail and
    sporadic low-quality positions, BINNED to the 8 RTA quality levels
    like every modern Illumina instrument (NovaSeq bins to 4) —
    exercises the quality-probability seeding offsets and the keyProbs
    greedy-trim weights (reference: AbstractMapThread.java:679) inside
    the timed loop, and keeps the batch palette-packable (<= 16 levels,
    quickmap_device.pack_quality_host)."""
    pos = np.arange(L)
    base = 37.0 - 8.0 * (pos / L) ** 2                     # 37 -> 29
    q = base[None, :] + rng.normal(0, 2.0, (n_reads, L))
    dips = rng.random((n_reads, L)) < 0.01                  # 1% bad spots
    q = np.where(dips, rng.uniform(2, 12, (n_reads, L)), q)
    q = np.clip(q, 2, 41)
    levels = np.array([2, 9, 12, 16, 22, 27, 32, 37], np.int8)
    edges = (levels[1:] + levels[:-1]) / 2.0
    return levels[np.digitize(q, edges)]


def make_pairs(genome, n_pairs, L=150, seed=11, with_quality=True):
    """FR innie pairs, insert ~N(250, 45) clipped to [2L+10, 420]; both
    mates carry the single-end error model. Returns (reads1, reads2,
    qual1, qual2, truth1, truth2) — truth = genome-forward alignment
    start of each mate; mate 2 is reverse-complemented in its read
    row."""
    rng = np.random.default_rng(seed)
    W = L + 12
    insert = np.clip(rng.normal(250, 45, n_pairs).astype(np.int64),
                     2 * L + 10, 420)
    starts = rng.integers(0, len(genome) - 460, size=n_pairs)
    idx1 = starts[:, None] + np.arange(W)[None, :]
    r1 = genome[idx1]
    s2 = starts + insert - L
    idx2 = s2[:, None] + np.arange(W)[None, :]
    win2 = genome[idx2]
    r1 = _mutate(r1[:, :L].copy(), genome[idx1], rng, L)
    r2f = _mutate(win2[:, :L].copy(), win2, rng, L)
    r2 = COMP_ASCII[r2f][:, ::-1]
    if with_quality:
        q1 = make_quality(rng, n_pairs, L)
        q2 = make_quality(rng, n_pairs, L)
    else:
        q1 = q2 = None
    return (np.ascontiguousarray(r1), np.ascontiguousarray(r2),
            q1, q2, starts.astype(np.int64), s2.astype(np.int64))
