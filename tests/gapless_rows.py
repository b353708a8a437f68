"""Candidate tables crafted for the gapless score kernel's edges, for its
CPU tests and chip_smoke.py's check of the kernel on the card. numpy only.

The kernel scores a window a word of 16 positions at a time (its "warp"
mapping gives each lane a run of whole words), so the edges are: where a
window starts in the genome's 2-bit words (16 bases) and N-mask words (32
bases), sub runs that cross a word edge with lim3 - 1, lim3, lim3 + 1 and
more subs, N in the read or the genome beside a word edge (and inside a sub
run), and windows off either end of the genome or wholly off it."""
import numpy as np

K = 8


def _plant_run(read, gc, start, n, rng):
    """Substitutions at read positions start .. start + n - 1 (within the
    read, where both the read and the genome hold a base)."""
    L = len(read)
    for j in range(max(start, 0), min(start + n, L)):
        if read[j] <= 3 and gc[j] <= 3:
            read[j] = (gc[j] + rng.integers(1, 4)) % 4


def gapless_rows(codes, B: int, L: int, lim3: int, rng):
    """B reads and their (B, 8) candidate table on a genome of ``codes``
    (0..3, 4 = N; longer than L + 64). Row b's window starts at b mod 32
    in the genome's 32-base words; every fourth row where the genome has N
    sits so that one of them falls just before or at a word edge of the
    window; sub runs of lim3 - 1, lim3, lim3 + 1 and 2 lim3 + 3 cross word
    edges; N in the read at word edges and inside runs; odd rows are
    reverse-complemented reads. Candidates: 0 the true diagonal and
    strand, 1 the other strand, 2 shifted by up to 17, 3 off the genome's
    start, 4 past its end, 5 wholly off it, 6 another diagonal with a
    genome N at a word edge (where there is one), 7 anywhere. Returns
    reads (B, L) uint8, mode and strand (B, 8) int32."""
    codes = np.minimum(np.asarray(codes), 4).astype(np.uint8)
    G = len(codes)
    n_at = np.flatnonzero(codes > 3)
    n_at = n_at[(n_at >= L) & (n_at < G - L)]
    edges = np.arange(16, L, 16)
    reads = np.empty((B, L), np.uint8)
    mode = np.empty((B, K), np.int64)
    strand = np.empty((B, K), np.int64)

    def at_n_edge():
        """A window start that puts a genome N at a word edge."""
        j = int(rng.choice(edges)) - int(rng.integers(0, 2)) if len(
            edges) else 0
        return int(rng.choice(n_at)) - j

    for b in range(B):
        if b % 4 == 3 and len(n_at):
            src = at_n_edge()
        else:
            base = int(rng.integers(32, G - L - 32))
            src = base - base % 32 + b % 32
        gc = codes[src:src + L]
        read = gc.copy()
        for e in edges:
            if rng.random() < 0.6:
                n = int(rng.choice([lim3 - 1, lim3, lim3 + 1, lim3 + 1,
                                    2 * lim3 + 3]))
                n = max(n, 1)
                _plant_run(read, gc, int(e) - int(rng.integers(1, n + 1)), n,
                           rng)
        if b % 3 == 1 and len(edges):
            e = int(rng.choice(edges))
            read[e - int(rng.integers(0, 2))] = 4
        if b % 6 == 5 and len(edges):
            e = int(rng.choice(edges))
            _plant_run(read, gc, e - lim3, 2 * lim3, rng)
            read[e - int(rng.integers(0, 3))] = 4
        minus = b % 2
        if minus:
            read = np.where(read <= 3, 3 - read, read)[::-1]
        reads[b] = read
        mode[b] = [src, src, src + int(rng.integers(-17, 18)),
                   -int(rng.integers(1, L)), G - L + int(rng.integers(1, L)),
                   (-L - int(rng.integers(0, 40))) if b % 2
                   else G + int(rng.integers(0, 40)),
                   at_n_edge() if len(n_at) else int(rng.integers(0, G - L)),
                   int(rng.integers(-L, G))]
        strand[b] = [minus, 1 - minus, minus, minus, 1 - minus, minus,
                     int(rng.integers(0, 2)), int(rng.integers(0, 2))]
    return reads, mode.astype(np.int32), strand.astype(np.int32)
