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
Tolerance: exact. The kernel itself is held to the plain version on the
card by tests/test_torch_candidate_card.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from tests import candidate_stages as cs
from tests.candidate_rows import slot_rows

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
