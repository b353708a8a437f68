"""Rows crafted for the candidate stage's two kernels (the slot pack and
the chain step), for their CPU tests and chip_smoke.py's check of the
kernels on the card. numpy only.

``slot_rows`` gives the slot pack's per-key inputs: ties in the budget's
lengths, zero lengths, lists longer than the budget, sums landing exactly
on it, local lengths apart from the global ones, rows with nothing
admitted, first sites near the end of the sites. ``chain_rows`` gives the
chain step's unsorted slots: all-invalid rows, steps exactly at and one
past ``chain_dist``, negative diagonals, a key slot repeated within a
chain, modal-run ties, runs longer than 255 slots and runs that start past
offset 255 of their chain (at W = 512), reads with fewer than 8 chains,
and the same chains on both strands (vote ties across strands)."""
import numpy as np

INVALID = 2 ** 30


def slot_rows(rng, B: int, nk: int, W: int, n_sites: int):
    """gadm, cnt_local, s0, offadj (B, 2, nk) int32 and admit (B, 2, nk)
    bool, a kind of row for each (read, strand) in turn."""
    shape = (B, 2, nk)
    gadm = np.zeros(shape, np.int64)
    cnt = np.zeros(shape, np.int64)
    admit = rng.random(shape) < 0.8
    for b in range(B):
        for h in range(2):
            kind = (2 * b + h) % 8
            if kind == 0:            # short lists, some zero
                g = rng.integers(0, max(2, W // 4), nk)
            elif kind == 1:          # ties: one length everywhere
                g = np.full(nk, max(1, W // 7))
            elif kind == 2:          # zero lengths among ties and longs
                g = rng.choice([0, 0, 3, 3, W, 2 * W], nk)
            elif kind == 3:          # sums landing exactly on W
                g = np.zeros(nk, np.int64)
                parts = rng.integers(1, 4)
                at = rng.choice(nk, min(nk, parts + 1), replace=False)
                cuts = np.sort(rng.choice(np.arange(1, W), parts,
                                          replace=False))
                g[at[:parts + 1]] = np.diff(np.r_[0, cuts, W])[:len(at)]
            elif kind == 4:          # lists longer than the budget
                g = rng.integers(W + 1, 4 * W, nk)
                g[rng.integers(0, nk)] = W
            elif kind == 5:          # nothing admitted
                g = rng.integers(0, W, nk)
                admit[b, h] = False
            elif kind == 6:          # every key one slot
                g = np.ones(nk, np.int64)
            else:                    # many small ties and one whole-budget
                g = rng.choice([1, 2, 2, 5], nk)
                g[rng.integers(0, nk)] = W
            gadm[b, h] = g
            # the local length: the global one, or below it (a shard's
            # share), or past it on a few rows (totals past W)
            loc = g.copy()
            if kind in (0, 2):
                loc = (g * rng.random(nk)).astype(np.int64)
            if kind == 7:
                loc = g + rng.integers(0, 3, nk)
            cnt[b, h] = loc
    s0 = rng.integers(0, n_sites, shape)
    s0[:, :, ::5] = n_sites - rng.integers(1, 4, s0[:, :, ::5].shape)
    offadj = rng.integers(-200, 200, shape)
    return (gadm.astype(np.int32), cnt.astype(np.int32),
            s0.astype(np.int32), offadj.astype(np.int32), admit)


def _row(rng, kind: int, W: int, nk: int, cd: int):
    """One row's (diag, toff) lists of at most W valid slots, sorted by
    construction (the caller shuffles them)."""
    d, t = [], []

    def run(start, length, step=0):
        for i in range(length):
            d.append(start + i * step)
            t.append(int(rng.integers(0, nk)))

    if kind == 0:                    # all invalid
        pass
    elif kind == 1:                  # steps exactly at cd, then cd + 1
        x = int(rng.integers(-500, 500))
        for i in range(min(W, 12)):
            d.append(x)
            t.append(i % nk)
            x += cd if i % 4 != 3 else cd + 1
    elif kind == 2:                  # negative diagonals, short chains
        for c in range(int(rng.integers(1, 5))):
            run(-3000 + c * 5 * cd, int(rng.integers(1, 6)))
    elif kind == 3:                  # a key slot repeated within a chain
        x = int(rng.integers(0, 10 ** 6))
        for i in range(min(W, 20)):
            d.append(x + i * (cd // 8))
            t.append(int(rng.integers(0, 3)))
    elif kind == 4:                  # modal-run ties: runs of equal length
        x = int(rng.integers(0, 10 ** 6))
        n = int(rng.integers(2, 5))
        for r in range(n):
            run(x + r * 7, 3)
    elif kind == 5:                  # one long chain (runs past 255 at 512)
        x = int(rng.integers(0, 10 ** 6))
        n = W - int(rng.integers(0, 4))
        pos, i = x, 0
        while i < n:
            ln = int(rng.integers(1, 4)) if i < 280 else int(
                rng.integers(4, 9))
            ln = min(ln, n - i)
            run(pos, ln)
            pos += int(rng.integers(1, 3))
            i += ln
    elif kind == 6:                  # a run longer than 255 slots
        x = int(rng.integers(0, 10 ** 6))
        run(x, min(W, 300))
        if len(d) < W:
            run(x + 5, W - len(d))
    else:                            # random chains, some dense
        x = int(rng.integers(-1000, 10 ** 6))
        n = int(rng.integers(1, W + 1))
        for i in range(n):
            d.append(x)
            t.append(int(rng.integers(0, nk)))
            x += int(rng.choice([0, 0, 1, cd, cd + 1, 3 * cd]))
    return d[:W], t[:W]


def chain_rows(rng, B: int, W: int, nk: int, chain_dist: int):
    """diag, toff (B, 2, W) int32: each row's valid slots shuffled among
    invalid ones (diag 2**30, any key slot), a kind of row for each (read,
    strand) in turn; every eighth read all invalid, every third the same
    row on both strands."""
    diag = np.full((B, 2, W), INVALID, np.int64)
    toff = rng.integers(0, nk, (B, 2, W))
    for b in range(B):
        rows = []
        for h in range(2):
            if h == 1 and b % 3 == 2:
                rows.append(rows[0])
                continue
            if b % 8 == 7:               # the whole read invalid
                kind = 0
            elif W < 256 or b % 2:
                kind = (2 * b + h) % 8
            else:                        # the long chains at W = 512
                kind = 5 + (b // 2 + h) % 3
            rows.append(_row(rng, kind, W, nk, chain_dist))
        for h, (d, t) in enumerate(rows):
            at = rng.permutation(W)[:len(d)] if b % 4 else np.arange(len(d))
            diag[b, h, at] = d
            toff[b, h, at] = t
    return diag.astype(np.int32), toff.astype(np.int32)
