"""The port's device quickmap (bbmap_tpu_torch/align/quickmap_device.py)
against the JAX package's, on the tests/test_fused.py genome: the
device-resident index, reference-window extraction, the quality-driven
seed offsets (raw and palette-packed), the candidate stage (two-tier
slot gather, forced hi-budget overflow, tier admission) and the
finalize stage. Tolerance: exact, including the float32 key weights
(elementwise float32 ops in the JAX order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.align import quickmap_device as jqd
from bbmap_tpu.align import seed as seed_host
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)
L = 100


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    g0 = rng.choice(BASES, size=80_000).astype(np.uint8)
    unit = rng.choice(BASES, size=600).astype(np.uint8)
    for at in (5_000, 22_000, 47_000, 63_000):
        g0[at:at + 600] = unit
    g = Genome(chroms=[g0], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g0),
                 name="c1")]).finalize()
    index = build_index(g, 11)
    analyze_index(index, 0.01)
    return index, tqd.DeviceIndex(convert.index(index), "cpu")


def make_reads(index, n, seed, from_repeat=False):
    """Reads from the genome with substitutions, indels, N bases and
    both strands; ``from_repeat`` samples inside the repeat unit so
    admitted site totals overflow the low slot tier."""
    gc = index.genome_codes
    A = np.frombuffer(b"ACGTN", np.uint8)
    rng = np.random.default_rng(seed)
    if from_repeat:
        starts = rng.choice([5_000, 22_000, 47_000, 63_000], size=n) \
            + rng.integers(0, 600 - L - 12, n)
    else:
        ok = np.lib.stride_tricks.sliding_window_view(
            gc < 4, L + 12).all(axis=1)
        starts = rng.choice(np.nonzero(ok)[0], size=n)
    w = np.stack([A[np.minimum(gc[s:s + L + 12], 4)] for s in starts])
    out = w[:, :L].copy()
    r = rng.random(n)
    for i in np.nonzero((r >= 0.5) & (r < 0.75))[0]:
        for _ in range(int(rng.integers(1, 4))):
            out[i, int(rng.integers(0, L))] = BASES[int(rng.integers(0, 4))]
    for i in np.nonzero((r >= 0.75) & (r < 0.88))[0]:
        d, p = int(rng.integers(1, 9)), int(rng.integers(10, L - 10))
        out[i] = np.concatenate([w[i, :p], w[i, p + d:p + d + (L - p)]])
    for i in np.nonzero(r >= 0.88)[0]:
        d, p = int(rng.integers(1, 9)), int(rng.integers(10, L - 10))
        out[i] = np.concatenate([out[i, :p], BASES[rng.integers(0, 4, d)],
                                 out[i, p:L - d]])
    out[::17, 30] = ord("N")
    flip = rng.random(n) < 0.5
    out[flip] = COMP_ASCII[out[flip]][:, ::-1]
    return out


def binned_quality(n, seed):
    rng = np.random.default_rng(seed)
    levels = np.array([2, 9, 12, 16, 22, 27, 32, 37], np.int8)
    q = levels[rng.integers(3, 8, (n, L))]
    q[::5, :14] = 2
    q[::7, 40:60] = 9
    q[3, :] = 2                      # a read with no usable keys
    return q


def test_device_index_matches_jax_arrays(setup):
    index, dix = setup
    starts, sites, gpack, nmask, G = jqd.device_arrays(index)
    np.testing.assert_array_equal(dix.starts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(dix.sites.numpy(), np.asarray(sites))
    np.testing.assert_array_equal(dix.gpack.numpy(),
                                  np.asarray(gpack).astype(np.int64))
    np.testing.assert_array_equal(dix.nmask.numpy(),
                                  np.asarray(nmask).astype(np.int64))
    assert dix.G == G
    np.testing.assert_array_equal(dix.scnt.numpy().view(np.uint32),
                                  np.asarray(jqd.scnt_array(index)))
    np.testing.assert_array_equal(dix.ccnt.numpy(),
                                  np.asarray(jqd.ccnt_array(index)))
    assert set(dict(dix.named_buffers())) == {
        "starts", "sites", "gpack", "nmask", "scnt", "ccnt",
        "chrom_offsets"}


def test_extract_ref_codes_matches_jax():
    """Codes and N/out-of-range mask against the JAX gather on a genome
    with N pads, at every window position including negative and
    past-the-end bases (template: tests/test_device_gathers.py)."""
    rng = np.random.default_rng(4)
    G = 4000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    codes[:500] = 4
    codes[-500:] = 4
    codes[1777] = 4
    gpack, nmask = jqd.pack_genome_2bit(codes)
    base = np.concatenate([np.arange(-200, 200), np.arange(G - 200, G + 60),
                           rng.integers(-100, G, 200)]).astype(np.int32)
    for has_n in (True, False):
        cj, nj = jax.jit(lambda b: jqd.extract_ref_codes(
            jnp.asarray(gpack), jnp.asarray(nmask), b, 150, G,
            has_n=has_n))(jnp.asarray(base))
        ct, nt = tqd.extract_ref_codes(
            torch.from_numpy(gpack.astype(np.int64)),
            torch.from_numpy(nmask.astype(np.int64)),
            torch.from_numpy(base), 150, G, has_n=has_n)
        nj = np.asarray(nj)
        np.testing.assert_array_equal(nt.numpy(), nj)
        vis = ~nj
        np.testing.assert_array_equal(ct.numpy()[vis], np.asarray(cj)[vis])


def _cfg_pair(index, dix):
    cj = jqd.make_config(index, L)
    ct = tqd.make_config(dix, L)
    assert tuple(cj) == tuple(ct)
    return cj, ct


@pytest.mark.parametrize("packed", [False, True])
def test_quality_offsets_stage_matches(setup, packed):
    index, dix = setup
    cj, ct = _cfg_pair(index, dix)
    den2, den3 = seed_host.key_density_ladder(L, index.k)
    q = binned_quality(96, 1)
    if packed:
        qpack, pal, pcp = jqd.pack_quality_host(q, L)
        qpack_t, pal_t, pcp_t = tqd.pack_quality_host(q, L)
        np.testing.assert_array_equal(qpack, qpack_t)
        want = jax.jit(lambda a, b, c: jqd.quality_offsets_stage_packed(
            cj, a, b, c, den2, den3, return_weights=True))(
                jnp.asarray(qpack), jnp.asarray(pal), jnp.asarray(pcp))
        got = tqd.quality_offsets_stage_packed(
            ct, torch.from_numpy(qpack_t.astype(np.int64)),
            torch.from_numpy(pal_t), torch.from_numpy(pcp_t), den2, den3,
            return_weights=True)
    else:
        want = jax.jit(lambda a: jqd.quality_offsets_stage(
            cj, a, den2, den3, return_weights=True))(jnp.asarray(q))
        got = tqd.quality_offsets_stage(ct, torch.from_numpy(q), den2,
                                        den3, return_weights=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ladder = np.asarray(ct.offsets_list)
    offs = got[0].numpy()
    assert (offs != ladder[None, :]).any(axis=1).sum() > 10


def _cand_both(index, dix, bases, quality=None, two_tier=True):
    cj, ct = _cfg_pair(index, dix)
    starts, sites, gpack, nmask, _G = jqd.device_arrays(index)
    scnt = jqd.scnt_array(index)
    ccnt = jqd.ccnt_array(index) if cj.ref_admit else None
    den2, den3 = seed_host.key_density_ladder(L, index.k)
    offs_j = wts_j = rej_j = None
    offs_t = wts_t = rej_t = None
    if quality is not None:
        offs_j, wts_j, rej_j = jqd.quality_offsets_stage(
            cj, jnp.asarray(quality), den2, den3, return_weights=True)
        offs_t, wts_t, rej_t = tqd.quality_offsets_stage(
            ct, torch.from_numpy(quality), den2, den3, return_weights=True)
    rj, cand_j = jax.jit(lambda b, o, w, r: jqd.candidate_stage(
        cj, b, starts, sites, offsets_dyn=o, scnt_d=scnt, ccnt_d=ccnt,
        two_tier=two_tier, weights_dyn=w, reject=r))(
            jnp.asarray(bases), offs_j, wts_j, rej_j)
    rt, cand_t = tqd.candidate_stage(ct, torch.from_numpy(bases), dix,
                                     offsets_dyn=offs_t, weights_dyn=wts_t,
                                     reject=rej_t, two_tier=two_tier)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert set(cand_j) == set(cand_t)
    for k in cand_j:
        np.testing.assert_array_equal(cand_t[k].numpy(),
                                      np.asarray(cand_j[k]), err_msg=k)
    return cj, ct, rt, cand_t, rj, cand_j


@pytest.mark.parametrize("mode", ["plain", "quality", "one_tier",
                                  "tier_admission"])
def test_candidate_stage_matches(setup, mode, monkeypatch):
    index, dix = setup
    if mode == "tier_admission":
        monkeypatch.setenv("BBMAP_REF_ADMIT", "0")
    bases = make_reads(index, 128, seed=7)
    q = binned_quality(128, 2) if mode == "quality" else None
    _, _, _, cand_t, _, _ = _cand_both(index, dix, bases, q,
                                       two_tier=mode != "one_tier")
    assert (cand_t["votes"].numpy()[:, 0] > 0).mean() > 0.9


def test_candidate_stage_hi_over(setup, monkeypatch):
    """Repeat-unit reads overflow the low slot tier; with hi_budget
    forced small some rows fall off the budget and are flagged."""
    index, dix = setup
    monkeypatch.setattr(jqd, "hi_budget", lambda R2: 8)
    monkeypatch.setattr(tqd, "hi_budget", lambda R2: 8)
    bases = make_reads(index, 64, seed=19, from_repeat=True)
    _, _, _, cand_t, _, _ = _cand_both(index, dix, bases)
    hi = cand_t["hi_over"].numpy()
    assert hi.any() and not hi.all()


def test_finalize_stage_matches(setup):
    index, dix = setup
    bases = make_reads(index, 96, seed=23)
    cj, ct, rt, cand_t, rj, cand_j = _cand_both(index, dix, bases,
                                                two_tier=False)
    _s, _si, gpack, nmask, _G = jqd.device_arrays(index)
    out_j, match_j = jqd.finalize_stage(cj, rj, cand_j, gpack, nmask)
    out_t, sym_t = tqd.finalize_stage(ct, rt, cand_t, dix)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    want = jqd._UNPACK_LUT[np.asarray(match_j)].reshape(len(bases), -1)
    np.testing.assert_array_equal(tqd._SYM_TABLE[sym_t.numpy()],
                                  want[:, :L])


def test_quickmap_run_host_dict(setup):
    """build_quickmap end to end: the .host() dicts agree key by key."""
    index, dix = setup
    bases = make_reads(index, 64, seed=29)
    q = binned_quality(64, 3)
    dj = jqd.build_quickmap(index, L)(bases, q).host()
    dt = tqd.build_quickmap(dix, L)(bases, q).host()
    assert set(dj) == set(dt)
    for k in dj:
        assert dt[k].dtype == dj[k].dtype, k
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)


def long_reads(index, n, LL, seed):
    """Reads of length LL > 600 (the long-read configuration: slot
    budget 512, hundreds of seed keys) with ~10 % substitutions, indels
    and both strands."""
    gc = index.genome_codes
    A = np.frombuffer(b"ACGTN", np.uint8)
    rng = np.random.default_rng(seed)
    out = np.empty((n, LL), np.uint8)
    for i in range(n):
        s = int(rng.integers(0, len(gc) - 2 * LL))
        src = A[np.minimum(gc[s:s + 2 * LL], 4)].copy()
        keep = rng.random(len(src)) >= 0.03             # deletions
        src = src[keep]
        ins = rng.random(len(src)) < 0.03
        src = np.insert(src, np.nonzero(ins)[0],
                        BASES[rng.integers(0, 4, int(ins.sum()))])
        sub = rng.random(LL) < 0.04
        rd = src[:LL].copy()
        rd[sub] = BASES[rng.integers(0, 4, int(sub.sum()))]
        out[i] = COMP_ASCII[rd][::-1] if rng.random() < 0.5 else rd
    return out


@pytest.mark.parametrize("with_quality", [False, True])
def test_quickmap_long_reads_host_dict(setup, with_quality):
    """L = 700 (> 600): slot_budget 512 and the nk > 64 branches of the
    candidate stage (weights compaction, list-position weights, the
    shortest-first admission and the slot->key assignment), end to end
    through build_quickmap; the .host() dicts agree key by key."""
    index, dix = setup
    LL = 700
    assert tqd.make_config(dix, LL).slot_budget == 512
    bases = long_reads(index, 12, LL, seed=31)
    q = None
    if with_quality:
        rng = np.random.default_rng(5)
        q = rng.integers(8, 40, (12, LL)).astype(np.int8)
        q[::3, 100:160] = 2
    dj = jqd.build_quickmap(index, LL)(bases, q).host()
    dt = tqd.build_quickmap(dix, LL)(bases, q).host()
    assert set(dj) == set(dt)
    for k in dj:
        assert dt[k].dtype == dj[k].dtype, k
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
