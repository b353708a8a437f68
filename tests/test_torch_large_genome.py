"""The port's main path on the two-gather lookup of an index past 2^24
sites, against the JAX package on the CPU, at small sizes.

An index of 2^24 sites or more has no packed ``start << 8 | count`` table
(24-bit starts): the candidate stage reads ``starts`` twice instead. Both
packages are forced onto that path here on small fixtures: the JAX package
by making its ``quickmap_device.scnt_array`` return None (its fused
programs import it at build time, so nothing in the package changes), the
port by setting ``quickmap_device.SCNT_MAX_SITES`` to 0. Cases:

- ``DeviceIndex`` at 2^24 - 1 and 2^24 sites of a synthetic index: the
  packed table, decoded, equals ``starts`` and the clamped counts, then is
  None;
- ``candidate_stage`` on tests/candidate_stages.py's configurations: the
  candidate table and the chain step's diagonals equal to the JAX
  package's on the two-gather path and to the port's own packed path;
- ``map_pairs_columnar`` without and with quality, and the port's
  two-gather run against its packed run;
- single-end ``map_batch_columnar`` on 40 scaffolds of ~20 kbp (each its
  own chrom, as tests/test_large_genome.py lays out 300 Mbp), reads
  across the scaffolds' ends: every MappedBatch field and match equal;
- the chain step on rows whose diagonals span more than its kernel's
  32-bit sort key holds (``tests/candidate_rows.wide_chain_rows``): the
  plain version and the kernel's register model against the sequential
  oracle, and the same spans made by both packages' ``candidate_stage``
  from a synthetic index whose sites lie up to 2^30 apart.

Tolerance: exact."""

import numpy as np
import pytest
import torch

from bbmap_tpu.align import quickmap_device as jqd
from bbmap_tpu.align.pipeline import BBMapAligner as JaxAligner
from bbmap_tpu.core.batch import ReadBatch
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import (KmerIndex, analyze_index, build_index,
                                   set_fraction_to_exclude)
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd
from bbmap_tpu_torch.align.pipeline import BBMapAligner as TorchAligner
from tests import candidate_stages as cs
from tests.candidate_rows import INVALID, int32_key_fits, wide_chain_rows
from tests.test_torch_chain_kernel import FIELDS, chain_oracle, regs_model

from .test_torch_fused import (assert_mb_equal, batch, make_pairs,  # noqa: F401
                               quality_for, setup, torch_aligner)

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def two_gather(monkeypatch):
    """Both packages on the two-gather lookup for the test's duration."""
    monkeypatch.setattr(jqd, "scnt_array", lambda index: None)
    monkeypatch.setattr(tqd, "SCNT_MAX_SITES", 0)


def _synthetic_index(n_sites: int, k: int = 4) -> KmerIndex:
    """n_sites sites over the 4**k keys, lists of uneven lengths (some past
    255, some empty), the last keys' lists reaching the end."""
    rng = np.random.default_rng(n_sites & 0xFFFF)
    nk = 4 ** k
    w = rng.random(nk) * (rng.random(nk) < 0.8)
    cnt = np.floor(w / w.sum() * n_sites).astype(np.int64)
    cnt[-1] += n_sites - cnt.sum()
    starts = np.zeros(nk + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    codes = rng.integers(0, 4, 256).astype(np.uint8)
    return KmerIndex(k=k, starts=starts,
                     sites=np.arange(n_sites, dtype=np.int32) % 256,
                     genome_codes=codes,
                     chrom_offsets=np.array([0, 256], np.int64))


@pytest.mark.parametrize("n_sites", [(1 << 24) - 1, 1 << 24])
def test_device_index_packs_below_2_24_sites(n_sites):
    from bbmap_tpu_torch.index.build import KmerIndex as TKmerIndex
    ref = _synthetic_index(n_sites)
    idx = TKmerIndex(**{f: getattr(ref, f) for f in (
        "k", "starts", "sites", "genome_codes", "chrom_offsets")})
    dix = tqd.DeviceIndex(idx, "cpu")
    assert tqd.SCNT_MAX_SITES == 1 << 24
    if n_sites >= 1 << 24:
        assert dix.scnt is None
        return
    sc = dix.scnt.long() & 0xFFFFFFFF
    st = idx.starts
    np.testing.assert_array_equal((sc >> 8).numpy(), st[:-1])
    np.testing.assert_array_equal((sc & 255).numpy(),
                                  np.minimum(np.diff(st), 255))
    assert np.diff(st).max() > 255 and (np.diff(st) == 0).any()


def _cand_equal(got, want):
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", ["short_quality", "short_plain",
                                  "short_one_tier", "short_tier_admission",
                                  "long_quality"])
def test_candidate_stage_two_gather(name, two_gather, monkeypatch):
    """The candidate table and the chain step's input on the two-gather
    path against the JAX package's, and against the port's packed path
    (tests/candidate_stages.case, built with the table)."""
    if name.startswith("short"):
        index, _ = cs.short_index()
        B = 96
        bases = cs.make_reads(index, B, seed=31)
        bases[:24] = cs.make_reads(index, 24, seed=37, from_repeat=True)
        q = cs.binned_quality(B, 5) if name == "short_quality" else None
        L, two_tier = 100, name != "short_one_tier"
        if name == "short_tier_admission":
            monkeypatch.setenv("BBMAP_REF_ADMIT", "0")
    else:
        index, _ = cs.long_index()
        bases = cs.long_reads(index, 4, seed=9)
        q = cs.long_quality(4, 10)
        L, two_tier = cs.LONG_L, False
    dix = tqd.DeviceIndex(convert.index(index), "cpu")
    assert dix.scnt is None
    want, got, _ct = cs.run_both(index, dix, L, bases, q, two_tier=two_tier)
    _cand_equal(got["cand"], want["cand"])
    (_cfg, diag, _toff), _ = got["chain"]
    np.testing.assert_array_equal(diag.numpy(), want["slots"]["a"])
    monkeypatch.undo()
    packed = cs.case(name)[1]
    _cand_equal(got["cand"], packed["cand"])
    assert packed["chain"][0][1].shape == diag.shape


@pytest.mark.parametrize("variant", ["plain", "quality"])
def test_map_pairs_two_gather(setup, variant, two_gather):
    g, genome, index = setup
    L, B = 100, 128
    r1, r2 = make_pairs(g, B, L=L, seed={"plain": 15, "quality": 16}[variant])
    q1 = q2 = None
    if variant == "quality":
        q1, q2 = quality_for(B, L, 13), quality_for(B, L, 14)
    aj = JaxAligner(genome, index)
    at = torch_aligner(genome, index)
    assert at.dindex.scnt is None
    b1, b2 = batch(r1, L, q1), batch(r2, L, q2)
    mj = aj.map_pairs_columnar(b1, b2)
    mt = at.map_pairs_columnar(convert.read_batch(b1), convert.read_batch(b2))
    for a, b in zip(mj, mt):
        assert_mb_equal(a, b)
    assert (at._n_esc_rows, at._n_fallback_rows) == \
        (aj._n_esc_rows, aj._n_fallback_rows)
    assert mt[0].mapped.sum() > 0.9 * B


def test_map_pairs_two_gather_equals_packed(setup, monkeypatch):
    g, genome, index = setup
    L, B = 100, 96
    r1, r2 = make_pairs(g, B, L=L, seed=17)
    b1 = convert.read_batch(batch(r1, L, quality_for(B, L, 18)))
    b2 = convert.read_batch(batch(r2, L, quality_for(B, L, 19)))
    packed = torch_aligner(genome, index)
    assert packed.dindex.scnt is not None
    mp = packed.map_pairs_columnar(b1, b2)
    monkeypatch.setattr(tqd, "SCNT_MAX_SITES", 0)
    two = torch_aligner(genome, index)
    assert two.dindex.scnt is None
    for a, b in zip(mp, two.map_pairs_columnar(b1, b2)):
        assert_mb_equal(a, b)


@pytest.fixture(scope="module")
def scaffolds40():
    """tests/test_large_genome.py's layout at ~800 kbp: 40 scaffolds of
    20 kbp from default_rng(17), each its own chrom, k = 13."""
    rng = np.random.default_rng(17)
    per = 20_000
    chroms = [rng.choice(BASES, size=per).astype(np.uint8)
              for _ in range(40)]
    genome = Genome(chroms=chroms, scaffolds=[
        Scaffold(chrom=i + 1, sid=i + 1, start=0, length=per,
                 name=f"scaf{i}") for i in range(40)]).finalize()
    index = build_index(genome, 13)
    analyze_index(index, set_fraction_to_exclude(40 * per))
    return genome, index


def _se_reads(index, rng, n_random: int, L: int = 150):
    """Reads from the flat codes: n_random anywhere, then 5 a scaffold end
    that cross it (50, 75 and 100 bases before the end) or end at it; a
    third with 1-3 substitutions, every other one reverse-complemented.
    Returns (bases (B, L) uint8, flat starts)."""
    from bbmap_tpu.core.bases import COMP_ASCII
    flat = index.genome_codes
    ends = index.chrom_offsets[1:-1]
    starts = np.concatenate([
        rng.integers(0, len(flat) - L, n_random),
        (ends[:, None] - np.array([50, 75, 100, L, L + 1])).ravel()])
    a = np.frombuffer(b"ACGTN", np.uint8)[flat[starts[:, None]
                                                + np.arange(L)]]
    sub = rng.random(len(a)) < 0.33
    for i in np.nonzero(sub)[0]:
        at = rng.integers(0, L, int(rng.integers(1, 4)))
        a[i, at] = BASES[rng.integers(0, 4, len(at))]
    a[1::2] = COMP_ASCII[a[1::2]][:, ::-1]
    return np.ascontiguousarray(a), starts


def test_single_end_40_scaffolds(scaffolds40, two_gather):
    genome, index = scaffolds40
    L = 150
    bases, starts = _se_reads(index, np.random.default_rng(3), 160, L)
    B = len(bases)
    rb = ReadBatch(bases=bases, quality=None, lengths=np.full(B, L, np.int32),
                   ids=[f"r{i}" for i in range(B)],
                   numeric_ids=np.arange(B, dtype=np.int64))
    aj = JaxAligner(genome, index)
    at = TorchAligner(convert.genome(genome), convert.index(index), "cpu")
    assert at.dindex.scnt is None
    mj = aj.map_batch_columnar(rb)
    mt = at.map_batch_columnar(convert.read_batch(rb))
    assert_mb_equal(mj, mt)
    m = mt.mapped
    assert m.mean() > 0.95
    flat = at.chrom_offsets[np.maximum(mt.chrom, 1) - 1] + mt.start
    assert (np.abs(flat - starts)[m] <= 20).mean() > 0.95
    assert (mt.start[m] >= 0).all()
    assert len(set(mt.chrom[m].tolist())) > 30
    # most reads over a scaffold end map
    assert m[160:].mean() > 0.9


def _wide_index(rng, n_reads: int, L: int = 60, k: int = 9):
    """A synthetic KmerIndex and reads whose candidate stage makes the
    chain step's wide rows: each read's keys (both strands) are its own,
    with 1-2 sites a key; by read in turn the plus row's diagonals span
    from past the 32-bit key's limit 2^(32 - tb) - 1 (and 2^27) to ~2^30,
    exactly 2^(32 - tb) - 2 (the key holds it), 2^(32 - tb) - 1, or the
    plus row is short and the minus row wide. Returns
    (index, bases, kinds)."""
    from bbmap_tpu.align import seed as seed_host
    from bbmap_tpu.index.build import reverse_complement_key
    offs = seed_host.make_offsets(L, k)
    nk = len(offs)
    lim = (1 << (32 - (nk - 1).bit_length())) - 1
    top = INVALID - 4096
    lists, reads, kinds, used = {}, [], [], set()
    while len(reads) < n_reads:
        r = rng.choice(BASES, size=L).astype(np.uint8)
        codes = np.searchsorted(BASES, r)
        kp = np.array([int("".join(map(str, codes[o:o + k])), 4)
                       for o in offs])
        km = reverse_complement_key(kp, k)
        keys = set(kp.tolist()) | set(km.tolist())
        if len(keys) != 2 * nk or keys & used:
            continue
        used |= keys
        kind = len(reads) % 4
        for h, (kk, adj) in enumerate(((kp, offs), (km, L - (offs + k)))):
            # the row's least diagonal on its first key, at or below 0
            # with every site >= 0
            lo = -int(rng.integers(0, int(adj[0]) + 1))
            if (kind == 3) == (h == 0):
                span = int(rng.integers(0, 4000))
            elif kind in (0, 3):
                span = int(rng.integers(max(1 << 27, lim), top - lo))
            else:
                span = lim - 1 if kind == 1 else lim
            for j in range(nk):
                d = lo if j == 0 else lo + span if j == nk - 1 else int(
                    rng.integers(lo, lo + span + 1))
                s = [d]
                if 0 < j < nk - 1 and rng.random() < 0.4:
                    s.append(min(d + int(rng.integers(0, 300)), lo + span))
                lists[int(kk[j])] = sorted(x + int(adj[j]) for x in set(s))
        reads.append(r)
        kinds.append(kind)
    n_keys = 4 ** k
    cnt = np.zeros(n_keys, np.int64)
    for key, s in lists.items():
        cnt[key] = len(s)
    starts = np.zeros(n_keys + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    sites = np.concatenate([np.asarray(lists[key], np.int64)
                            for key in sorted(lists)]).astype(np.int32)
    codes = np.random.default_rng(1).integers(0, 4, 4096).astype(np.uint8)
    index = KmerIndex(k=k, starts=starts, sites=sites, genome_codes=codes,
                      chrom_offsets=np.array([0, len(codes)], np.int64))
    return index, np.stack(reads), np.array(kinds)


@pytest.mark.parametrize("W,nk,cd,B", [(64, 18, 400, 64), (64, 9, 0, 48),
                                       (128, 33, 400, 32),
                                       (512, 750, 400, 12)])
def test_wide_rows_plain_and_model_match_oracle(W, nk, cd, B):
    rng = np.random.default_rng(W + nk + cd)
    diag, toff = wide_chain_rows(rng, B, W, nk, cd)
    fits = int32_key_fits(diag, toff)
    assert fits[1::4].all() and not fits[0::4].any()
    assert not fits[2::4].any() and not fits[3::4].any()
    valid = diag < INVALID
    span = np.where(valid, diag, 0).max(2) - np.where(valid, diag,
                                                     INVALID).min(2)
    assert span[0::4].min() >= 1 << 27 and (diag[valid] < 0).any()
    cfg = tqd.QmConfig(k=13, L=150, S=32, chain_dist=cd, min_score=0,
                       offsets_list=tuple(range(nk)), G=1, slot_budget=W)
    got = tqd.chain_candidates_kernel(cfg, torch.from_numpy(diag),
                                      torch.from_numpy(toff))
    want = chain_oracle(diag, toff, cd)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if W <= 128:
        model = regs_model(diag, toff, cd)
        for k in FIELDS:
            np.testing.assert_array_equal(model[k], want[k], err_msg=k)
    assert (np.abs(want["start"]) >= 1 << 27).any()


def test_wide_rows_from_candidate_stage_match_jax(two_gather):
    """A synthetic index with sites up to 2^30 apart: both packages'
    candidate_stage on the two-gather path give the same sorted rows and
    candidate table, and the chain step's rows are wide (int64 key) or at
    the 32-bit key's limit as the reads were made."""
    index, bases, kinds = _wide_index(np.random.default_rng(8), 64)
    dix = tqd.DeviceIndex(convert.index(index), "cpu")
    want, got, ct = cs.run_both(index, dix, bases.shape[1], bases, None,
                                two_tier=True)
    _cand_equal(got["cand"], want["cand"])
    (_cfg, diag, toff), _ = got["chain"]
    np.testing.assert_array_equal(diag.numpy(), want["slots"]["a"])
    fits = int32_key_fits(diag.numpy(), toff.numpy())
    np.testing.assert_array_equal(fits, kinds == 1)
    assert (np.abs(got["cand"]["mode"]) >= 1 << 27).any()
    assert (got["cand"]["votes"][:, 0] > 0).all()


def test_pairs_across_scaffolds(scaffolds40, two_gather):
    """Pairs whose mates lie on different scaffolds (every other pair),
    or within one scaffold over its end, through map_pairs_columnar with
    quality on the two-gather path: every field and match equal."""
    from bbmap_tpu.core.bases import COMP_ASCII
    genome, index = scaffolds40
    rng = np.random.default_rng(21)
    L, B = 150, 96
    flat = np.frombuffer(b"ACGTN", np.uint8)[index.genome_codes]
    offs = index.chrom_offsets
    c1 = rng.integers(0, 40, B)
    c2 = np.where(np.arange(B) % 2 == 0, (c1 + rng.integers(1, 40, B)) % 40,
                  c1)
    s1 = offs[c1] + rng.integers(0, 20_000 - 400, B)
    s1[1::8] = offs[c1[1::8] + 1] - 200         # near the scaffold's end
    s2 = np.where(c2 == c1, s1 + rng.integers(100, 250, B),
                  offs[c2] + rng.integers(0, 20_000 - L, B))
    s2 = np.minimum(s2, len(flat) - L)
    r1 = np.stack([flat[s:s + L] for s in s1]).copy()
    r2 = COMP_ASCII[np.stack([flat[s:s + L] for s in s2])][:, ::-1].copy()
    for rows in (r1, r2):
        hit = rng.random(B) < 0.3
        rows[hit, rng.integers(0, L, int(hit.sum()))] = BASES[
            rng.integers(0, 4, int(hit.sum()))]
    q1, q2 = quality_for(B, L, 22), quality_for(B, L, 23)
    b1, b2 = batch(r1, L, q1), batch(r2, L, q2)
    aj = JaxAligner(genome, index)
    at = TorchAligner(convert.genome(genome), convert.index(index), "cpu")
    mj = aj.map_pairs_columnar(b1, b2)
    mt = at.map_pairs_columnar(convert.read_batch(b1), convert.read_batch(b2))
    for a, b in zip(mj, mt):
        assert_mb_equal(a, b)
    both = mt[0].mapped & mt[1].mapped
    assert both.mean() > 0.9
    apart = both & (mt[0].chrom != mt[1].chrom)
    assert apart.sum() > B // 4
    assert not mt[0].paired[apart].any()
