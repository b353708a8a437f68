"""The candidate stage's slot budget and slot-to-key assignment
(bbmap_tpu_torch/csrc/slot_pack.cu, wrapper
``quickmap_device.slot_pack_kernel``, plain version ``_slot_pack_plain``
with the budget in ``_slot_counts``).

The plain version against the JAX package's ``candidate_stage`` stopped at
"admit" (the counts the budget keeps) and "slots" (the slots' diagonals)
on the same reads, in the short configuration (L = 100: with and without
quality, one and two tiers, the tier admission) and the long one (L =
6,000, 750 keys, W = 512: the JAX package ranks by argsort there and by a
pairwise rank-sum at the short nk); and against a sequential numpy oracle
(the kernel's per-row definition: the rank as a count of the keys before,
the owner of a slot as the upper bound of the prefix sums) on the path's
rows and on rows crafted across the budget's edges (``tests/
candidate_rows.slot_rows``: length ties, zero lengths, lists past the
budget, sums landing on it, local lengths apart from the global ones,
rows with nothing admitted, first sites near the end). The oracle's two
forms of the budget (rank-sum and stable sort) are held to each other.
A numpy emulation of the kernel's "block" mapping (a block a row: the
row's 64-bit sort keys in sorted order, the budget and cum by block scans
of the threads' totals through warp scans, the slots' binary search) is
held bit-equal to the plain version on crafted rows at 18, 64, 65, 750
and 2,100 keys, rows whose int32 length sums wrap among them;
``slot_pack_mapping``'s rule and the wrapper's ``mapping=`` are checked.
Tolerance: exact. The kernel itself is held to the plain version on the
card by tests/test_torch_candidate_card.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from tests import candidate_stages as cs
from tests.candidate_rows import slot_rows, wrap_slot_rows

torch.set_num_threads(2)


def _i32(x):
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(
        np.int64)


def slot_oracle(gadm, cnt_local, s0, offadj, admit, W, n_sites):
    """numpy model of csrc/slot_pack.cu, a row at a time. Returns
    (gather_idx, offadj_slot, toff_slot, valid_slot, total)."""
    B, _two, nk = gadm.shape
    gi = np.zeros((B, 2, W), np.int64)
    oa = np.zeros((B, 2, W), np.int32)
    ts = np.zeros((B, 2, W), np.int32)
    vs = np.zeros((B, 2, W), bool)
    tot = np.zeros((B, 2), np.int32)
    big = 1 << 30
    for b in range(B):
        for h in range(2):
            g = gadm[b, h].astype(np.int64)
            g1 = np.where(g > 0, g, big)
            # the rank as a count: the keys at or before j in (g1, index)
            rank_sum = np.array([
                g[(g1 < g1[j]) | ((g1 == g1[j]) & (np.arange(nk) <= j))]
                .sum() for j in range(nk)])
            fits = _i32(rank_sum) <= W
            # the same budget through a stable sort
            order = np.argsort(g1, kind="stable")
            fits_sorted = np.empty(nk, bool)
            fits_sorted[order] = _i32(np.cumsum(g[order])) <= W
            np.testing.assert_array_equal(fits, fits_sorted)
            cnt = np.where(admit[b, h] & fits & (g > 0),
                           cnt_local[b, h].astype(np.int64), 0)
            cum = _i32(np.cumsum(cnt))
            for w in range(W):
                t = min(int((cum <= w).sum()), nk - 1)
                prev = int(cum[t - 1]) if t else 0
                base = int(_i32(int(s0[b, h, t]) - prev))
                gi[b, h, w] = min(max(int(_i32(base + w)), 0), n_sites - 1)
                oa[b, h, w] = offadj[b, h, t]
                ts[b, h, w] = t
                vs[b, h, w] = w < cum[-1]
            tot[b, h] = cum[-1]
    return gi, oa, ts, vs, tot


U32 = np.uint64(0xffffffff)


def _block_shape(nk: int):
    """csrc/slot_pack.cu's block mapping: the bitonic network's width, the
    threads and the keys a thread owns in the scans."""
    n2 = 64
    while n2 < nk:
        n2 *= 2
    threads = min(1024, max(256, n2 // 2))
    kpt = 1
    while kpt < -(-nk // threads):
        kpt *= 2
    return n2, threads, kpt


def _block_scan(vals, threads, kpt):
    """The kernel's two-level scan: each thread's kpt values summed in
    order, the threads' totals by warp scans and a scan of the warp
    totals; returns the inclusive sums (uint32, wrapped)."""
    v = np.zeros(threads * kpt, np.uint64)
    v[:len(vals)] = vals
    per = v.reshape(threads, kpt)
    incl = np.cumsum(per, axis=1) & U32
    run = incl[:, -1]
    warp = (np.cumsum(run.reshape(-1, 32), axis=1) & U32).reshape(-1)
    wtot = np.cumsum(warp.reshape(-1, 32)[:, -1]) & U32
    before = (np.r_[np.uint64(0), wtot[:-1]].repeat(32) + warp - run) & U32
    return ((before[:, None] + incl) & U32).reshape(-1)[:len(vals)]


def block_emulation(gadm, cnt_local, s0, offadj, admit, W, n_sites,
                    mutation=None):
    """numpy model of csrc/slot_pack.cu's "block" mapping, a row at a
    time: the row's 64-bit keys (g1 << 13 | index) sorted (the bitonic
    network's order: the keys are distinct), the lengths summed in that
    order by the block's scan and each key's fit written back at its
    index; the counts kept scanned in key order; the slots take the upper
    bound of w in cum. ``mutation="exclusive"`` breaks it on purpose: a
    key fits by the lengths before it, without its own. Returns
    (gather_idx, offadj_slot, toff_slot, valid_slot, total)."""
    B, _two, nk = gadm.shape
    _n2, threads, kpt = _block_shape(nk)
    big = 1 << 30
    gi = np.zeros((B, 2, W), np.int64)
    oa = np.zeros((B, 2, W), np.int32)
    ts = np.zeros((B, 2, W), np.int32)
    vs = np.zeros((B, 2, W), bool)
    tot = np.zeros((B, 2), np.int32)
    u32 = (lambda x: (np.asarray(x, np.int64) & 0xffffffff).astype(
        np.uint64))
    i32 = (lambda x: x.astype(np.int64).astype(np.int32))
    for b in range(B):
        for h in range(2):
            g = gadm[b, h].astype(np.int64)
            key = (np.where(g > 0, g, big) << 13) | np.arange(nk)
            order = np.argsort(key)
            csum = _block_scan(u32(g[order]), threads, kpt)
            if mutation == "exclusive":
                csum = (csum - u32(g[order])) & U32
            fits = np.empty(nk, bool)
            fits[order] = i32(csum) <= W
            keep = fits & admit[b, h] & (g > 0)
            c = np.where(keep, u32(cnt_local[b, h]), np.uint64(0))
            cum_u = _block_scan(c, threads, kpt)
            cum = i32(cum_u)
            prev = (cum_u - c) & U32
            base = i32((u32(s0[b, h]) - prev) & U32)
            w = np.arange(W)
            t = np.minimum(_upper_bound(cum, w), nk - 1)
            idx = i32((base[t].astype(np.int64) + w) & 0xffffffff)
            gi[b, h] = np.clip(idx.astype(np.int64), 0, n_sites - 1)
            oa[b, h] = offadj[b, h, t]
            ts[b, h] = t
            vs[b, h] = w < cum[-1]
            tot[b, h] = cum[-1]
    return gi, oa, ts, vs, tot


def _upper_bound(cum, w):
    """The kernel's binary search: the first t with cum_t > w (cum may be
    unsorted where a wrapped sum left it so)."""
    out = np.empty(len(w), np.int64)
    for i, x in enumerate(w):
        lo, hi = 0, len(cum)
        while lo < hi:
            mid = (lo + hi) >> 1
            if cum[mid] <= x:
                lo = mid + 1
            else:
                hi = mid
        out[i] = lo
    return out


def _cfg(W: int, nk: int) -> tqd.QmConfig:
    return tqd.QmConfig(k=13, L=150, S=32, chain_dist=400, min_score=0,
                        offsets_list=tuple(range(nk)), G=1, slot_budget=W)


def _check(got, want):
    for name, g, w in zip(("gather_idx", "offadj_slot", "toff_slot",
                           "valid_slot", "total"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("name", cs.CASES)
def test_plain_matches_jax_stages(name):
    """The budget's counts and the slots' diagonals equal the JAX
    package's, and the path's slot pack equals the oracle."""
    want, got, ct = cs.case(name)
    (cfg, gadm, cnt_local, s0, offadj, admit, n_sites), out = \
        got["slot_pack"]
    cnt = tqd._slot_counts(gadm, cnt_local, admit, cfg.slot_budget)
    np.testing.assert_array_equal(cnt.numpy(), want["admit"]["a"])
    np.testing.assert_array_equal(got["chain"][0][1].numpy(),
                                  want["slots"]["a"])
    if "hi_over" in want["cand"]:
        np.testing.assert_array_equal(got["cand"]["hi_over"],
                                      want["cand"]["hi_over"])
    _check(out, slot_oracle(*(a.numpy() for a in (gadm, cnt_local, s0,
                                                 offadj, admit)),
                            cfg.slot_budget, n_sites))
    assert (cnt.numpy() > 0).sum() > 0
    if name.startswith("long"):
        assert cfg.slot_budget == 512 and gadm.shape[-1] == 750
        assert (out[4].numpy() == 512).any()       # rows that fill W


@pytest.mark.parametrize("W,nk,B", [(64, 18, 96), (512, 750, 8),
                                    (64, 1, 16), (40, 33, 24)])
def test_plain_matches_oracle_on_crafted_rows(W, nk, B):
    rng = np.random.default_rng(W + nk)
    n_sites = 5000
    arrays = slot_rows(rng, B, nk, W, n_sites)
    got = tqd.slot_pack_kernel(_cfg(W, nk),
                               *(torch.from_numpy(a) for a in arrays),
                               n_sites)
    want = slot_oracle(*arrays, W, n_sites)
    _check(got, want)
    tot = want[4]
    assert (tot == 0).any() and (tot > 0).any()
    if nk > 1:
        assert (tot == W).any() or (tot > W).any()


def test_oracle_mutation_fails():
    """An owner taken as the lower bound (searchsorted left) moves the
    slots that start a key's list."""
    rng = np.random.default_rng(3)
    arrays = slot_rows(rng, 32, 18, 64, 5000)
    want = slot_oracle(*arrays, 64, 5000)
    cum = np.cumsum(tqd._slot_counts(
        *(torch.from_numpy(a) for a in (arrays[0], arrays[1], arrays[4])),
        64).numpy(), axis=-1)
    w = np.arange(64)
    left = np.minimum((cum[..., None, :] < w[:, None]).sum(-1), 17)
    assert (left != want[2]).any()


def test_wrapper_checks_and_counts():
    rng = np.random.default_rng(4)
    arrays = [torch.from_numpy(a) for a in slot_rows(rng, 8, 18, 64, 900)]
    cfg = _cfg(64, 18)
    tqd.reset_launches()
    got = tqd.slot_pack_kernel(cfg, *arrays, 900)
    assert tqd.slot_pack_kernel.launches == 0           # CPU: plain
    _check(got, [t.numpy() for t in tqd._slot_pack_plain(cfg, *arrays,
                                                        900)])
    with pytest.raises(TypeError):
        tqd.slot_pack_kernel(cfg, arrays[0].long(), *arrays[1:], 900)
    with pytest.raises(TypeError):
        tqd.slot_pack_kernel(cfg, *arrays[:4], arrays[4].int(), 900)
    with pytest.raises(ValueError):
        tqd.slot_pack_kernel(cfg, arrays[0], arrays[1][:, :, :5],
                             *arrays[2:], 900)
    with pytest.raises(ValueError):
        tqd.slot_pack_kernel(cfg, arrays[0], arrays[1].to("meta"),
                             *arrays[2:], 900)


@pytest.mark.parametrize("nk,W,B", [(18, 64, 64), (64, 64, 24),
                                    (65, 64, 24), (750, 512, 6),
                                    (2100, 512, 2)])
def test_block_emulation_matches_plain(nk, W, B):
    """The "block" mapping's order bit-equal to the plain version on
    crafted rows, with rows whose int32 length sums wrap (the plain
    budget's cumsum wraps the same way)."""
    rng = np.random.default_rng(7 * nk + W)
    n_sites = 5000
    arrays = wrap_slot_rows(slot_rows(rng, B, nk, W, n_sites))
    want = tqd._slot_pack_plain(_cfg(W, nk),
                                *(torch.from_numpy(a) for a in arrays),
                                n_sites)
    got = block_emulation(*arrays, W, n_sites)
    for name, g, w in zip(("gather_idx", "offadj_slot", "toff_slot",
                           "valid_slot", "total"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    # the wrapped rows keep keys past the wrap: the sums passed 2^31
    g = arrays[0].astype(np.int64)
    assert (g[::4, 0].sum(-1) > 2 ** 31).all()
    cnt = tqd._slot_counts(*(torch.from_numpy(a) for a in
                             (arrays[0], arrays[1], arrays[4])), W).numpy()
    assert (cnt[::4, 0] > 0).any()


def test_block_emulation_mutation_fails():
    """The emulation with a budget that leaves a key's own length out of
    its sum moves the budget on the crafted rows."""
    rng = np.random.default_rng(11)
    arrays = slot_rows(rng, 16, 65, 64, 5000)
    want = block_emulation(*arrays, 64, 5000)
    got = block_emulation(*arrays, 64, 5000, mutation="exclusive")
    assert (got[4] != want[4]).any() and (got[2] != want[2]).any()


def test_slot_pack_mapping_rule():
    """"warp" below SLOT_PACK_BLOCK_FROM keys (128, where chip_smoke.py's
    sweep found the block mapping faster at 4,096 reads), "block" from
    there; a forced mapping is taken where it holds nk; an unknown one, or
    nk past a mapping's shared memory, raises."""
    assert tqd.SLOT_PACK_BLOCK_FROM == 128
    for nk, want in ((1, "warp"), (18, "warp"), (65, "warp"),
                     (127, "warp"), (128, "block"), (750, "block"),
                     (8192, "block")):
        assert tqd.slot_pack_mapping(nk) == want
    assert tqd.slot_pack_mapping(750, "warp") == "warp"
    assert tqd.slot_pack_mapping(18, "block") == "block"
    for nk, mapping in ((8193, None), (3633, "warp"), (8193, "block"),
                        (18, "regs")):
        with pytest.raises(ValueError):
            tqd.slot_pack_mapping(nk, mapping)


@pytest.mark.parametrize("mapping", [None, "warp", "block"])
def test_wrapper_mapping_on_the_cpu(mapping):
    """On CPU tensors every mapping gives the plain version and counts no
    launch, by mapping or in all; an unknown mapping raises before any
    work."""
    rng = np.random.default_rng(5)
    arrays = [torch.from_numpy(a) for a in slot_rows(rng, 8, 70, 64, 900)]
    cfg = _cfg(64, 70)
    tqd.reset_launches()
    got = tqd.slot_pack_kernel(cfg, *arrays, 900, mapping=mapping)
    _check(got, [t.numpy() for t in tqd._slot_pack_plain(cfg, *arrays,
                                                        900)])
    assert tqd.slot_pack_kernel.launches == 0
    assert tqd.slot_pack_kernel.launches_by == {"warp": 0, "block": 0}
    with pytest.raises(ValueError):
        tqd.slot_pack_kernel(cfg, *arrays, 900, mapping="row")
