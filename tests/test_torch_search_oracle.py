"""The port's key-retention oracle (bbmap_tpu_torch/align/search_oracle.py,
a verbatim copy) against the JAX package's on the same inputs, and the
port's device retention (quickmap_device._ref_retention) against the
oracle, without and with quality weights, on a repeat-heavy genome where
the greedy trim fires, and on key sets crafted to straddle the
re-admission tiers, where staged re-admission fires. Tolerance: exact."""

import numpy as np
import pytest
import torch

from bbmap_tpu.align import search_oracle as jso
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd
from bbmap_tpu_torch.align import search_oracle as so
from bbmap_tpu_torch.align import seed as seed_host

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)
L = 150
UNIT = 400


def _repeat_genome(n=300_000, seed=21):
    """tests/test_search_oracle.py's genome (a 400 bp unit implanted 60x,
    some diverged, and a 2 kbp unit 12x), with the 400 bp unit's
    positions."""
    rng = np.random.default_rng(seed)
    g = rng.choice(BASES, size=n).astype(np.uint8)
    unit = rng.choice(BASES, size=UNIT).astype(np.uint8)
    at_unit = []
    for i in range(60):
        at = int(rng.integers(0, n - UNIT))
        u = unit.copy()
        for _ in range(i % 5):
            u[rng.integers(0, UNIT)] = BASES[rng.integers(0, 4)]
        g[at:at + UNIT] = u
        at_unit.append(at)
    unit2 = rng.choice(BASES, size=2000).astype(np.uint8)
    for i in range(12):
        at = int(rng.integers(0, n - 2000))
        g[at:at + 2000] = unit2
    return g, np.asarray(at_unit)


@pytest.fixture(scope="module")
def setup():
    g, at_unit = _repeat_genome()
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="rep")]).finalize()
    jindex = build_index(genome, 13)
    analyze_index(jindex, 0.03)
    assert jindex.counts_canonical is not None
    index = convert.index(jindex)
    dindex = tqd.DeviceIndex(index, "cpu")
    return g, at_unit, jindex, index, dindex


def _reads(g, at_unit, B, seed):
    """B reads of L bp: half anywhere, half inside a copy of the 400 bp
    unit (keys around the exclusion threshold: the trim's work)."""
    rng = np.random.default_rng(seed)
    anywhere = rng.integers(0, len(g) - L - 1, size=B - B // 2)
    inside = rng.choice(at_unit, size=B // 2) \
        + rng.integers(0, UNIT - L, B // 2)
    return np.stack([g[s:s + L] for s in np.concatenate([anywhere, inside])])


def _quality(B, seed):
    """tests/test_search_oracle.py's quality: plateau, sagging tail,
    frequent deep dips, and 12 nearly hopeless reads (probAllErrors)."""
    rng = np.random.default_rng(seed)
    pos = np.arange(L)
    q = 38.0 - 10.0 * (pos / L) ** 2 + rng.normal(0, 3, (B, L))
    dips = rng.random((B, L)) < 0.06
    q = np.where(dips, rng.uniform(0, 12, (B, L)), q)
    bad = rng.choice(B, size=12, replace=False)
    q[bad] = 2.0
    for r in bad:
        at = int(rng.integers(0, L - 16))
        q[r, at:at + 16] = 8.0
    return np.clip(q, 0, 41).astype(np.int8)


def _trimmed(keys_in, keys_out, counts, max_len) -> bool:
    """The oracle kept fewer keys than staged re-admission admitted."""
    num, _ = so.staged_readmission(keys_in, counts, max_len)
    return len(keys_out) < num


def test_oracle_copy_equals_the_jax_oracle(setup):
    """Every step of the oracle, on the index both packages built, for
    reads with and without quality weights."""
    g, at_unit, jindex, index, _ = setup
    reads = _reads(g, at_unit, 64, seed=5)
    q = _quality(64, 7)
    offsets = np.asarray(seed_host.make_offsets(L, index.k), np.int64)
    counts = index.counts_canonical
    for r in range(len(reads)):
        keys = seed_host.keys_at_offsets(reads[r], offsets, index.k
                                         ).astype(np.int64)
        for a, b in zip(so.staged_readmission(keys, counts,
                                              index.max_usable_length),
                        jso.staged_readmission(keys, counts,
                                               jindex.max_usable_length)):
            np.testing.assert_array_equal(a, b)
        sc, pae = so.key_scores_from_quality(q[r], offsets, index.k)
        sc_j, pae_j = jso.key_scores_from_quality(q[r], offsets, index.k)
        np.testing.assert_array_equal(sc, sc_j)
        assert pae == pae_j
        for scores in (np.full(len(offsets), 100 * index.k, np.int32), sc):
            got = so.retain_keys(keys, offsets, scores, index)
            want = jso.retain_keys(keys, offsets, scores, jindex)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_device_retention_matches_oracle(setup):
    """Plain ladder offsets, every key weighted 1.0."""
    g, at_unit, _, index, dindex = setup
    B = 256
    reads = _reads(g, at_unit, B, seed=5)
    cfg = tqd.make_config(dindex, L)
    assert cfg.ref_admit
    offsets = np.asarray(cfg.offsets_list, np.int32)
    nk = len(offsets)
    rcodes = tqd.ascii_to_codes(torch.from_numpy(reads))
    kp = tqd._keys_from_codes(rcodes, cfg.offsets_list, cfg.k, L)
    ccnt_p = torch.where(kp < 0, 0, dindex.ccnt[torch.where(
        kp < 0, 0, kp).long()])
    off_p = torch.from_numpy(offsets)[None, :].expand(B, nk)
    alive = tqd._ref_retention(cfg, kp, off_p, ccnt_p).numpy()
    kp = kp.numpy()

    counts = index.counts_canonical
    key_scores = np.full(nk, 100 * index.k, np.int32)
    n_trimmed = 0
    for r in range(B):
        keys_r = kp[r].astype(np.int64)
        keys_o, _offs, _sc = so.retain_keys(
            keys_r, offsets.astype(np.int64), key_scores, index)
        np.testing.assert_array_equal(
            np.sort(kp[r][alive[r]]), np.sort(keys_o), err_msg=f"read {r}")
        n_trimmed += _trimmed(keys_r, keys_o, counts,
                              index.max_usable_length)
    assert n_trimmed > B // 10, n_trimmed


def test_device_retention_matches_oracle_with_quality(setup):
    """Quality offsets and keyProbs weights from the port's device stage,
    the weighted greedy trim and the probAllErrors rejection."""
    g, at_unit, _, index, dindex = setup
    B = 256
    reads = _reads(g, at_unit, B, seed=6)
    q = _quality(B, 17)
    cfg = tqd.make_config(dindex, L)
    den2, den3 = seed_host.key_density_ladder(L, index.k)
    offs, wts, rej = tqd.quality_offsets_stage(
        cfg, torch.from_numpy(q), den2, den3, return_weights=True)
    rcodes = tqd.ascii_to_codes(torch.from_numpy(reads))
    keys_all = tqd._keys_all_positions(rcodes, cfg.k, L)
    od = offs.to(torch.int32)
    kp = torch.gather(keys_all, 1,
                      torch.clamp(od, 0, L - cfg.k).long())
    kp = torch.where((od < 0) | rej[:, None], -1, kp)
    ccnt_p = torch.where(kp < 0, 0, dindex.ccnt[torch.where(
        kp < 0, 0, kp).long()])
    alive = tqd._ref_retention(cfg, kp, torch.clamp(od, min=0), ccnt_p,
                               weights=wts).numpy()
    offs, rej, kp = offs.numpy(), rej.numpy(), kp.numpy()

    counts = index.counts_canonical
    n_weight_differs = n_trimmed = 0
    for r in range(B):
        act = offs[r] >= 0
        off_r = offs[r][act].astype(np.int64)
        scores, pae = so.key_scores_from_quality(q[r], off_r, index.k)
        n_weight_differs += len(np.unique(scores)) > 1
        if rej[r]:
            assert pae > 0.5, f"read {r}: device rejected, pae={pae}"
            assert not alive[r].any()
            continue
        keys_r = kp[r][act].astype(np.int64)
        keys_o, _offs, _sc = so.retain_keys(keys_r, off_r, scores, index)
        np.testing.assert_array_equal(
            np.sort(kp[r][alive[r]]), np.sort(keys_o), err_msg=f"read {r}")
        n_trimmed += _trimmed(keys_r, keys_o, counts,
                              index.max_usable_length)
    assert rej.sum() >= 1, "the reads never tripped probAllErrors"
    assert n_weight_differs > B // 2, n_weight_differs
    assert n_trimmed > B // 20, n_trimmed


def test_device_retention_matches_oracle_on_crafted_keys(setup):
    """tests/test_search_oracle.py's key sets: a few keys below the
    exclusion threshold beside keys in each re-admission band, so every
    tier of the ladder re-admits; the device keeps the oracle's keys."""
    _g, _at, _j, index, dindex = setup
    rng = np.random.default_rng(9)
    c = index.counts_canonical.astype(np.int64)
    maxLen = index.max_usable_length
    cfg = tqd.make_config(dindex, L)
    offsets = np.asarray(cfg.offsets_list, np.int64)
    nk = len(offsets)
    pools = [np.nonzero((c > 0) & (c < maxLen))[0],
             np.nonzero((c >= maxLen) & (c < (maxLen * 3) // 2))[0],
             np.nonzero((c >= (maxLen * 3) // 2) & (c < maxLen * 2))[0],
             np.nonzero((c >= maxLen * 2) & (c < maxLen * 5))[0],
             np.nonzero(c >= maxLen * 5)[0]]
    assert len(pools[0]) > nk and len(pools[1]) > 0
    rows = []
    for _trial in range(64):
        keys = np.full(nk, -1, np.int64)
        n_base = int(rng.integers(0, 5))
        slots = rng.choice(nk, size=nk, replace=False)
        si = 0
        for p in rng.choice(len(pools[0]), size=max(n_base, 1),
                            replace=False)[:n_base]:
            keys[slots[si]] = pools[0][p]
            si += 1
        for band in (1, 2, 3, 4):
            for _ in range(int(rng.integers(0, 4)) if len(pools[band])
                           else 0):
                if si >= nk:
                    break
                keys[slots[si]] = pools[band][int(
                    rng.integers(0, len(pools[band])))]
                si += 1
        rows.append(keys)
    kp = torch.from_numpy(np.stack(rows).astype(np.int32))
    B = kp.shape[0]
    ccnt_p = torch.where(kp < 0, 0, dindex.ccnt[torch.where(
        kp < 0, 0, kp).long()])
    off_p = torch.from_numpy(offsets.astype(np.int32))[None, :].expand(
        B, nk)
    alive = tqd._ref_retention(cfg, kp, off_p, ccnt_p).numpy()
    kp = kp.numpy()
    key_scores = np.full(nk, 100 * index.k, np.int32)
    readmitted = 0
    for r in range(B):
        keys_o, _, _ = so.retain_keys(kp[r].astype(np.int64), offsets,
                                      key_scores, index)
        np.testing.assert_array_equal(np.sort(kp[r][alive[r]]),
                                      np.sort(keys_o), err_msg=str(r))
        readmitted += any(c[k] >= maxLen for k in keys_o)
    assert readmitted > 0, "the key sets never fired the re-admission"
