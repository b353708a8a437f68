"""The candidate stage's chain step (bbmap_tpu_torch/csrc/chain_candidates.cu,
wrapper ``quickmap_device.chain_candidates_kernel``, plain version
``_chain_candidates_plain``: ``_sort_rows``, ``_chain_segments``,
``_candidate_table``).

The plain version against the JAX package's ``candidate_stage`` stopped at
"sort" (the sorted diagonals and key slots), "votes" (each chain's
distinct-key count at its first slot), "runs" (the read's votes and the
packed modal run's running max) and in full (the candidate table and
``hi_over``) on the same reads, in the short configuration (L = 100: with
and without quality, one and two tiers, the tier admission) and the long
one (L = 6,000, 750 keys, W = 512: the JAX package keeps the votes exact
there with 24 mask words); and against a sequential numpy oracle written
chain by chain (the distinct keys of a chain as a set, its runs and their
packed (run, 255 - offset) words, the stable top 8) on the path's rows and
on rows crafted for the places the kernel can go wrong (``tests/
candidate_rows.chain_rows``): all-invalid rows, steps exactly at
``chain_dist``, negative diagonals, a key slot repeated within a chain,
modal-run ties, runs past chain offset 255 and runs longer than 255 at W =
512, reads with fewer than 8 chains (the table's zero-vote fill entries),
vote ties across strands. Tolerance: exact. A numpy model of the
kernel's register mapping (``regs_model``: the bitonic network on the
int64 key diagonal * 65536 + key slot, the ballot words a 32-slot piece read by
popcount / find-first / count-leading-zeros with carries over the pieces,
the distinct keys by a match within the piece and a bit set or a broadcast
across pieces, the votes as the new keys between a chain's first and last
slot, the top K as rounds of a 32-bit max) is held to both at W = 40, 64,
100 and 128, with its cross-piece check shown to matter. The kernel itself
is held to the plain version on the card by
tests/test_torch_candidate_card.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from tests import candidate_stages as cs
from tests.candidate_rows import INVALID, chain_rows

torch.set_num_threads(2)

FIELDS = ("votes", "mode", "strand", "start", "spread")


def _row_oracle(d, t, cd):
    """One row: sorted diagonals f, and per slot the last slot, the chain
    start, the votes and the packed modal word read at a chain's last slot
    (or at an invalid slot: the last chain's, or 0)."""
    W = len(d)
    f, ts = map(list, zip(*sorted(zip(d.tolist(), t.tolist()))))
    n = sum(x < INVALID for x in f)
    last = list(range(W))
    segs = [-1] * W
    votes = [0] * W
    word = [0] * W
    starts = [i for i in range(n) if i == 0 or f[i] - f[i - 1] > cd]
    best = 0
    for o, s in enumerate(starts, start=1):
        e = (starts[o] if o < len(starts) else n) - 1
        votes[s] = len(set(ts[s:e + 1]))
        best = 0
        r = s
        while r <= e:
            q = r
            while q + 1 <= e and f[q + 1] == f[r]:
                q += 1
            meta = (min(q - r + 1, 255) << 8) | (255 - min(r - s, 255))
            best = max(best, meta)
            r = q + 1
        for i in range(s, e + 1):
            last[i] = e
            segs[i] = s
        word[e] = (o << 16) | best
    for i in range(n, W):
        segs[i] = starts[-1] if starts else -1
        word[i] = (len(starts) << 16) | best if starts else 0
    return f, last, segs, votes, word


def chain_oracle(diag, toff, cd, K=8):
    """The candidate table of each read, sequentially."""
    B, _two, W = diag.shape
    out = {k: np.zeros((B, K), np.int32) for k in FIELDS}
    for b in range(B):
        f, last, segs, votes, word = [sum(x, []) for x in zip(*(
            _row_oracle(diag[b, h], toff[b, h], cd) for h in range(2)))]
        top = sorted(range(2 * W), key=lambda i: (-votes[i], i))[:K]
        for k, i in enumerate(top):
            half = int(i >= W)
            so = half * W
            stop_at = min(max(last[i] + so, 0), 2 * W - 1)
            mi = min(max(segs[i] + 255 - (word[stop_at] & 0xFF), 0), W - 1)
            out["votes"][b, k] = votes[i]
            out["strand"][b, k] = half
            out["start"][b, k] = f[i]
            out["mode"][b, k] = f[min(max(mi + so, 0), 2 * W - 1)]
            out["spread"][b, k] = f[stop_at] - f[i] if votes[i] > 0 else 0
    return out


def _cfg(W: int, nk: int, cd: int = 400) -> tqd.QmConfig:
    return tqd.QmConfig(k=13, L=150, S=32, chain_dist=cd, min_score=0,
                        offsets_list=tuple(range(nk)), G=1, slot_budget=W)


def _check(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)


@pytest.mark.parametrize("name", cs.CASES)
def test_plain_matches_jax_stages(name):
    want, got, ct = cs.case(name)
    (cfg, diag, toff_slot), cand = got["chain"]
    nk = len(cfg.offsets_list)
    flat, toff = tqd._sort_rows(diag, toff_slot)
    flat, toff = flat.numpy(), toff.numpy()
    np.testing.assert_array_equal(flat, want["sort"]["a"])
    # equal diagonals carry their key slots in either order: compare the
    # (diagonal, key slot) pairs of the valid slots as sorted keys
    valid = flat < INVALID
    key = np.where(valid, flat.astype(np.int64) * 65536 + toff, -1)
    jkey = np.where(valid, flat.astype(np.int64) * 65536
                    + want["sort"]["b"], -1)
    np.testing.assert_array_equal(np.sort(key, 1), np.sort(jkey, 1))
    last_idx, seg_start, gmax, size = tqd._chain_segments(
        torch.from_numpy(flat), torch.from_numpy(toff), cfg.chain_dist, nk)
    np.testing.assert_array_equal(size.numpy(), want["votes"]["a"])
    np.testing.assert_array_equal(size.numpy().reshape(len(diag), -1),
                                  want["runs"]["a"])
    np.testing.assert_array_equal(gmax.numpy(), want["runs"]["b"])
    for k in want["cand"]:
        np.testing.assert_array_equal(got["cand"][k], want["cand"][k],
                                      err_msg=k)
    _check(cand, chain_oracle(diag.numpy(), toff_slot.numpy(),
                              cfg.chain_dist))
    if name.startswith("long"):
        assert diag.shape[-1] == 512 and nk == 750
        assert (cand["votes"].numpy()[:, 0] > 255).any()


@pytest.mark.parametrize("W,nk,cd,B", [(64, 18, 400, 96), (512, 750, 400, 24),
                                       (64, 18, 0, 48), (40, 33, 25, 48)])
def test_plain_matches_oracle_on_crafted_rows(W, nk, cd, B):
    rng = np.random.default_rng(W + nk + cd)
    diag, toff = chain_rows(rng, B, W, nk, cd)
    got = tqd.chain_candidates_kernel(_cfg(W, nk, cd), torch.from_numpy(diag),
                                      torch.from_numpy(toff))
    want = chain_oracle(diag, toff, cd)
    _check(got, want)
    votes = want["votes"]
    assert (votes[:, 0] == 0).any()                  # all-invalid reads
    assert ((votes > 0).sum(1) < 8).any()            # zero-vote fill
    assert (diag[(diag < INVALID)] < 0).any()
    if W == 512:
        # a modal run that starts past offset 255 of its chain: the
        # packed word's low byte 0, the mode read at chain start + 255
        assert votes.max() > 255


def test_crafted_rows_reach_the_edges():
    """The crafted rows hold what they are for: a step of exactly
    chain_dist inside a chain and one past it between chains; a key slot
    twice in a chain (fewer votes than slots); equal runs in a chain; a
    run past offset 255 that decides the mode; reads whose two strands
    tie."""
    cd = 400
    rng = np.random.default_rng(9)
    diag, toff = chain_rows(rng, 48, 512, 750, cd)
    steps = ties = repeats = late = 0
    for b in range(len(diag)):
        rows = []
        for h in range(2):
            f, last, segs, votes, word = _row_oracle(diag[b, h], toff[b, h],
                                                     cd)
            rows.append(votes)
            n = sum(x < INVALID for x in f)
            dd = np.diff(np.asarray(f[:n], np.int64))
            steps += int((dd == cd).any() and (dd == cd + 1).any())
            for s in range(n):
                if votes[s]:
                    e = last[s]
                    repeats += votes[s] < e - s + 1
                    late += (word[e] & 0xFF) == 0 and e - s > 255
        ties += rows[0] == rows[1] and max(rows[0]) > 0
    assert steps and ties and repeats and late


def test_mutation_fails():
    """Votes that count slots instead of distinct key slots, and a mode
    taken at the chain's first run, each change the table."""
    rng = np.random.default_rng(5)
    diag, toff = chain_rows(rng, 32, 64, 18, 400)
    want = chain_oracle(diag, toff, 400)
    same = chain_oracle(diag, np.broadcast_to(np.arange(64, dtype=np.int32),
                                              diag.shape), 400)
    assert (same["votes"] != want["votes"]).any()
    first = {k: v.copy() for k, v in want.items()}
    first["mode"] = np.where(want["votes"] > 0, want["start"], want["mode"])
    assert (first["mode"] != want["mode"]).any()


def test_wrapper_checks_and_counts():
    rng = np.random.default_rng(6)
    diag, toff = (torch.from_numpy(a) for a in chain_rows(rng, 8, 64, 18,
                                                          400))
    cfg = _cfg(64, 18)
    tqd.reset_launches()
    got = tqd.chain_candidates_kernel(cfg, diag, toff)
    assert tqd.chain_candidates_kernel.launches == 0    # CPU: plain
    _check(got, {k: v.numpy() for k, v in tqd._chain_candidates_plain(
        cfg, diag, toff).items()})
    assert all(got[k].dtype == torch.int32 for k in FIELDS)
    with pytest.raises(TypeError):
        tqd.chain_candidates_kernel(cfg, diag.long(), toff)
    with pytest.raises(ValueError):
        tqd.chain_candidates_kernel(cfg, diag, toff[:, :, :5])
    with pytest.raises(ValueError):
        tqd.chain_candidates_kernel(cfg, diag, toff.to("meta"))


INT_MAX = 2 ** 31 - 1
ALL = 0xFFFFFFFF


def _ballot(flags) -> int:
    """The 32-bit ballot word of 32 lane flags."""
    return int(np.dot(np.asarray(flags, np.int64) & 1,
                      1 << np.arange(32, dtype=np.int64)))


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def _hi(x: int) -> int:
    """31 - clz(x): the highest set bit."""
    return x.bit_length() - 1


def _popc(x: int) -> int:
    return bin(x).count("1")


def _bitonic(key):
    """csrc/chain_candidates.cu's network over P = 32 NP int64 keys (diag *
    65536 + key slot), slot i = p * 32 + lane: at each (k, j) the slot
    keeps the smaller of (itself, slot i ^ j) where it is the lower one of
    an ascending pair or the upper one of a descending pair, else the
    larger."""
    key = key.copy()
    P = len(key)
    idx = np.arange(P)
    k = 2
    while k <= P:
        j = k >> 1
        while j > 0:
            o = key[idx ^ j]
            keep_min = (idx < (idx ^ j)) == ((idx & k) == 0)
            key = np.where(keep_min, np.minimum(key, o), np.maximum(key, o))
            j >>= 1
        k <<= 1
    return key


def _segment(d, t, W, cd, stats, spill=True):
    """One sorted row, (NP, 32) lanes: the register mapping's chain
    segmentation. Returns per-slot (last, segs, gmax, votes)."""
    NP = d.shape[0]
    lane = np.arange(32)
    valid, nc, nr = (np.zeros((NP, 32), bool) for _ in range(3))
    vb, ncb, bb, rb = [], [], [], []
    for p in range(NP):
        i = p * 32 + lane
        fp = np.r_[d[p, 0] if p == 0 else d[p - 1, 31], d[p, :31]]
        dd = ((d[p] - fp + 2 ** 31) % 2 ** 32) - 2 ** 31   # int32 wrap
        valid[p] = (i < W) & (d[p] < INVALID)
        nc[p] = valid[p] & ((i == 0) | (dd > cd))
        nr[p] = valid[p] & ((i == 0) | (dd != 0) | nc[p])
        inm = _ballot(i < W)
        vb.append(_ballot(valid[p]))
        ncb.append(_ballot(nc[p]))
        bb.append(ncb[p] | (inm & ~vb[p]))
        rb.append(_ballot(nr[p]) | (inm & ~vb[p]))
    next_b, next_r, prev_s, ord0 = [0] * NP, [0] * NP, [0] * NP, [0] * NP
    nb = nrs = W
    for p in range(NP - 1, -1, -1):
        next_b[p], next_r[p] = nb, nrs
        if bb[p]:
            nb = p * 32 + _ffs(bb[p]) - 1
        if rb[p]:
            nrs = p * 32 + _ffs(rb[p]) - 1
    ps, o = -1, 0
    for p in range(NP):
        prev_s[p], ord0[p] = ps, o
        if ncb[p]:
            ps = p * 32 + _hi(ncb[p])
        o += _popc(ncb[p])
    last, segs, run, ords = (np.zeros((NP, 32), np.int64) for _ in range(4))
    inb = []
    for p in range(NP):
        new = np.zeros(32, bool)
        for ln in range(32):
            i = p * 32 + ln
            above, upto = (ALL << (ln + 1)) & ALL, ALL >> (31 - ln)
            ba, ra = bb[p] & above, rb[p] & above
            n_b = p * 32 + _ffs(ba) - 1 if ba else next_b[p]
            n_r = p * 32 + _ffs(ra) - 1 if ra else next_r[p]
            last[p, ln] = min(max(n_b - 1, 0), W - 1)
            run[p, ln] = n_r - i if nr[p, ln] else 0
            su = ncb[p] & upto
            s = p * 32 + _hi(su) if su else prev_s[p]
            segs[p, ln] = s
            ords[p, ln] = ord0[p] + _popc(su)
            lo = max(s - p * 32, 0)
            dup = bool(((t[p, lo:ln] == t[p, ln])).any())
            new[ln] = valid[p, ln] and not dup
        sp = prev_s[p]
        if spill and p > 0 and sp >= 0 and vb[p] & 1 and not ncb[p] & 1:
            spilled = segs[p] == sp
            for q in range(sp >> 5, p):
                lo = sp & 31 if q == sp >> 5 else 0
                keys = t[q, lo:]
                if ((keys < 0) | (keys >= 32)).any():
                    stats["broadcast"] += 1
                    seen = np.isin(t[p], keys)
                else:
                    stats["bitset"] += 1
                    bits = _ballot(np.isin(np.arange(32), keys))
                    tp = np.clip(t[p], 0, 31)
                    seen = ((t[p] >= 0) & (t[p] < 32)
                            & ((bits >> tp) & 1).astype(bool))
                new &= ~(spilled & seen)
        inb.append(_ballot(new))
    pref = np.r_[0, np.cumsum([_popc(x) for x in inb])]
    votes = np.zeros((NP, 32), np.int64)
    for p in range(NP):
        for ln in range(32):
            if not nc[p, ln]:
                continue
            x = int(last[p, ln]) + 1
            px = x >> 5
            cx = pref[NP] if px >= NP else pref[px] + _popc(
                inb[px] & ((1 << (x & 31)) - 1))
            ci = pref[p] + _popc(inb[p] & ((1 << ln) - 1))
            votes[p, ln] = cx - ci
    i = np.arange(NP)[:, None] * 32 + lane
    meta = (np.clip(run, 0, 255) << 8) | (255 - np.clip(i - segs, 0, 255))
    glob = (ords << 16) | np.where(nr, meta, 0)
    gmax = np.maximum.accumulate(glob.ravel()).reshape(NP, 32)
    return last, segs, gmax, votes


def regs_model(diag, toff, cd, K=8, spill=True, stats=None):
    """numpy model of the register mapping of csrc/chain_candidates.cu,
    a read at a time. ``spill=False`` drops the cross-piece distinct-key
    check on purpose; ``stats`` counts the pieces that took each form of
    it ("bitset", "broadcast")."""
    B, _two, W = diag.shape
    NP = 1 if W <= 32 else 2 if W <= 64 else 4
    stats = {"bitset": 0, "broadcast": 0} if stats is None else stats
    out = {k: np.zeros((B, K), np.int32) for k in FIELDS}
    for b in range(B):
        per = []
        for h in range(2):
            key = np.full(32 * NP, 2 ** 63 - 1, np.int64)
            key[:W] = diag[b, h].astype(np.int64) * 65536 + toff[b, h]
            key = _bitonic(key).reshape(NP, 32)
            d, t = key >> 16, key & 0xFFFF
            per.append((d, *_segment(d, t, W, cd, stats, spill)))
        f, last, segs, gmax, votes = (np.stack([r[n] for r in per])
                                      .reshape(2, -1)[:, :W]
                                      for n in range(5))
        slot = np.arange(2 * W).reshape(2, W)
        keys = (votes << 16) | (2 * W - 1 - slot)
        prev = INT_MAX
        for r in range(K):
            best = int(keys[keys < prev].max())
            prev = best
            s = 2 * W - 1 - (best & 0xFFFF)
            h, x = s // W, s % W
            stop_at = min(max(int(last[h, x]), 0), W - 1)
            mi = min(max(int(segs[h, x]) + 255 - (int(gmax[h, stop_at])
                                                  & 0xFF), 0), W - 1)
            v = best >> 16
            out["votes"][b, r] = v
            out["strand"][b, r] = h
            out["start"][b, r] = f[h, x]
            out["mode"][b, r] = f[h, mi]
            out["spread"][b, r] = (f[h, stop_at] - f[h, x]) if v > 0 else 0
    return out


@pytest.mark.parametrize("W,nk,cd", [(40, 33, 25), (64, 18, 400),
                                     (100, 60, 400), (128, 18, 0)])
def test_regs_model_matches_oracle_and_plain(W, nk, cd):
    """The register mapping's steps give the sequential oracle's table
    and the plain version's, and the rows reach the cross-piece check in
    the form the key slots call for (a bit set below 32 key slots, a
    broadcast past them)."""
    rng = np.random.default_rng(W * 7 + nk)
    diag, toff = chain_rows(rng, 48, W, nk, cd)
    stats = {"bitset": 0, "broadcast": 0}
    got = regs_model(diag, toff, cd, stats=stats)
    _check(got, chain_oracle(diag, toff, cd))
    plain = tqd._chain_candidates_plain(_cfg(W, nk, cd),
                                        torch.from_numpy(diag),
                                        torch.from_numpy(toff))
    _check(got, {k: v.numpy() for k, v in plain.items()})
    if nk <= 32:
        assert stats["bitset"] > 0 and stats["broadcast"] == 0
    else:
        assert stats["broadcast"] > 0
    cross = regs_model(diag, toff, cd, spill=False)
    assert (cross["votes"] != got["votes"]).any()


@pytest.mark.parametrize("W,mapping,want", [
    (64, None, "regs"), (128, None, "regs"), (129, None, "smem"),
    (512, None, "smem"), (64, "smem", "smem"), (32, "regs", "regs")])
def test_chain_mapping_choice(W, mapping, want):
    assert tqd.chain_mapping(W, mapping) == want


def test_chain_mapping_refusals_and_counts():
    """A mapping that cannot take W raises, on CPU tensors too, before any
    launch; the CPU path counts nothing in either mapping."""
    with pytest.raises(ValueError):
        tqd.chain_mapping(129, "regs")
    with pytest.raises(ValueError):
        tqd.chain_mapping(64, "shared")
    rng = np.random.default_rng(8)
    diag, toff = (torch.from_numpy(a) for a in chain_rows(rng, 4, 200, 18,
                                                          400))
    with pytest.raises(ValueError):
        tqd.chain_candidates_kernel(_cfg(200, 18), diag, toff,
                                    mapping="regs")
    tqd.reset_launches()
    got = tqd.chain_candidates_kernel(_cfg(200, 18), diag, toff,
                                      mapping="smem")
    _check(got, chain_oracle(diag.numpy(), toff.numpy(), 400))
    assert tqd.chain_candidates_kernel.launches == 0
    assert tqd.chain_candidates_kernel.launches_by == {"regs": 0, "smem": 0}
