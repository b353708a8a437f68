"""The port's fused paired program and aligner against the JAX package,
on the tests/test_fused_pair.py genome: the pair boost, the device mate
rescue scan (also against the host oracle ``_quick_rescue``), the fused
pair program's ``.host()`` dict (JAX with BBMAP_FUSED_PALLAS=1, so its
score / fill passes are the Pallas kernels in interpret mode). The
aligner entry points are held against the JAX package in
tests/test_torch_pairs.py and tests/test_torch_stream.py. Tolerance:
exact for every integer, boolean and byte field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.align import fused_device as jfd
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.core.batch import ReadBatch
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import fused_device as tfd
from bbmap_tpu_torch.align.pipeline import BBMapAligner as TorchAligner
from bbmap_tpu_torch.align.quickmap_device import DeviceIndex

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    g = rng.choice(BASES, size=60000).astype(np.uint8)
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="ref")]).finalize()
    index = build_index(genome, 13)
    analyze_index(index, 0.01)
    return g, genome, index


def make_pairs(g, B, L=100, insert=180, seed=5):
    """FR pairs with substitutions and 1-8 bp indels on both mates and a
    few N bases."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(g) - insert - 20, size=B)
    r1 = np.stack([g[s:s + L] for s in starts]).copy()
    r2f = np.stack([g[s + insert - L:s + insert] for s in starts]).copy()
    for rows, off in ((r1, 0), (r2f, insert - L)):
        for i in range(B):
            u = rng.random()
            if u < 0.3:
                for _ in range(int(rng.integers(1, 4))):
                    rows[i, rng.integers(0, L)] = BASES[rng.integers(0, 4)]
            elif u < 0.45:
                d, p = int(rng.integers(1, 9)), int(rng.integers(10, L - 10))
                s = starts[i] + off
                rows[i] = np.concatenate([g[s:s + p], g[s + p + d:s + L + d]])
            elif u < 0.6:
                d, p = int(rng.integers(1, 9)), int(rng.integers(10, L - 10))
                rows[i] = np.concatenate([rows[i, :p],
                                          BASES[rng.integers(0, 4, d)],
                                          rows[i, p:L - d]])
    r1[::23, L // 2] = ord("N")
    r2 = COMP_ASCII[r2f][:, ::-1].copy()
    return r1, r2


def quality_for(B, L, seed):
    rng = np.random.default_rng(seed)
    levels = np.array([2, 12, 22, 27, 32, 37], np.int8)
    q = levels[rng.integers(2, 6, (B, L))]
    q[::6, :10] = 2
    return q


def batch(rows, L, qual=None):
    B = len(rows)
    return ReadBatch(bases=rows, quality=qual,
                     lengths=np.full(B, L, np.int32),
                     ids=[f"r{i}" for i in range(B)],
                     numeric_ids=np.arange(B, dtype=np.int64))


def torch_aligner(genome, index):
    """The port's aligner on the CPU over the reference's genome and
    index, carried across by ``convert``."""
    return TorchAligner(convert.genome(genome), convert.index(index), "cpu")


def assert_mb_equal(a, b):
    for f in ("mapped", "strand", "chrom", "start", "stop", "score",
              "perfect", "ambiguous", "n_sites", "paired", "rescued"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for i in range(a.size):
        if a.mapped[i]:
            assert a.match(i) == b.match(i), i


def assert_dicts_equal(dj, dt, path=""):
    assert set(dj) == set(dt), (path, set(dj) ^ set(dt))
    for k in dj:
        if isinstance(dj[k], dict):
            assert_dicts_equal(dj[k], dt[k], path + k + ".")
            continue
        assert dt[k].dtype == dj[k].dtype, path + k
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=path + k)


def test_pair_boost_matches_jax():
    """Random candidate tables with negative and invalid scores, both
    strands, two chromosomes and unequal mate lengths."""
    rng = np.random.default_rng(0)
    Bp, C = 64, 8
    choff = np.array([0, 30000, 60000], np.int32)
    for L1, L2, apd in ((100, 100, 180), (100, 80, 140), (150, 150, 100)):
        gl = rng.integers(-3000, 9000, (2 * Bp, C)).astype(np.int32)
        gl[rng.random((2 * Bp, C)) < 0.15] = -(2 ** 30)
        start = rng.integers(0, 60000, (2 * Bp, C)).astype(np.int32)
        start[Bp:] = np.clip(start[:Bp] + rng.integers(-400, 400,
                                                       (Bp, C)), 0, 59999)
        cand = {"start": start,
                "spread": rng.integers(0, 40, (2 * Bp, C)).astype(np.int32),
                "strand": rng.integers(0, 2, (2 * Bp, C)).astype(np.int32)}
        want = np.asarray(jfd.pair_boost_device(
            jnp.asarray(gl), {k: jnp.asarray(v) for k, v in cand.items()},
            Bp, L1, L2, jnp.int32(apd), jnp.asarray(choff)))
        got = tfd.pair_boost_device(
            torch.from_numpy(gl),
            {k: torch.from_numpy(v) for k, v in cand.items()},
            Bp, L1, L2, apd, torch.from_numpy(choff))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want > -(2 ** 30)).sum() > 10


def test_rescue_scan_matches_jax_and_host(setup):
    """Device quickRescue (both directions, N bases, exact-match bound
    shrink) against the JAX program and the host oracle."""
    from bbmap_tpu.align.quickmap_device import _B2C
    from bbmap_tpu.ops import rescue_device as jrd
    from bbmap_tpu_torch.ops import rescue_device as trd
    g, genome, index = setup
    al = torch_aligner(genome, index)
    rng = np.random.default_rng(11)
    Lm, R, N_OFF = 100, 48, 1536
    reads = np.zeros((R, Lm), np.uint8)
    lo_a, n_a, ik_a, mm_a = (np.zeros(R, np.int32) for _ in range(4))
    rt_a = np.zeros(R, bool)
    expected = []
    gref = al.codes_ascii
    for t in range(R):
        src = int(rng.integers(8200, len(gref) - 8200 - Lm))
        read = gref[src:src + Lm].copy()
        for _ in range(int(rng.integers(0, 8))):
            read[rng.integers(0, Lm)] = ord("ACGT"[rng.integers(0, 4)])
        if rng.random() < 0.1:
            read[rng.integers(0, Lm)] = ord("N")
        right = bool(rng.random() < 0.5)
        span = int(rng.integers(200, 1200))
        if right:
            lo = src - int(rng.integers(0, 150))
            hi = lo + span
            loc = lo
        else:
            hi = src + int(rng.integers(0, 150))
            lo = hi - span
            loc = hi
        ideal = src + int(rng.integers(-60, 60))
        lo = max(0, lo)
        hi = min(len(gref) - Lm, hi)
        max_mm = int(rng.integers(2, 20))
        expected.append(al._quick_rescue(read, loc, span, right, ideal,
                                         max_mm, 1))
        reads[t] = _B2C[read]
        lo_a[t], n_a[t], ik_a[t] = lo, hi - lo + 1, ideal - lo
        rt_a[t], mm_a[t] = right, max_mm
    bk_t, mm_t = trd.build_rescue(al.dindex, Lm, R, N_OFF)(
        reads, lo_a, n_a, ik_a, rt_a, mm_a)
    bk_j, mm_j = jrd.build_rescue(index, Lm, R, N_OFF)(
        reads, lo_a, n_a, ik_a, rt_a, mm_a)
    np.testing.assert_array_equal(bk_t, np.asarray(bk_j))
    np.testing.assert_array_equal(mm_t, np.asarray(mm_j))
    for t in range(R):
        if expected[t] is None:
            assert bk_t[t] < 0, t
        else:
            start = lo_a[t] + bk_t[t] if rt_a[t] \
                else lo_a[t] + (n_a[t] - 1) - bk_t[t]
            assert (int(start), int(mm_t[t])) == expected[t], t


@pytest.mark.parametrize("with_q", [False, True])
def test_fused_pair_program_host_dict(setup, with_q, monkeypatch):
    """The fused pair program's .host() dict, key by key and dtype by
    dtype, against the JAX program on its Pallas branch."""
    monkeypatch.setenv("BBMAP_FUSED_PALLAS", "1")
    g, genome, index = setup
    L, Bp = 48, 48
    r1, r2 = make_pairs(g, Bp, L=L, insert=110, seed=31)
    q1 = q2 = None
    if with_q:
        q1, q2 = quality_for(Bp, L, 1), quality_for(Bp, L, 2)
    fj = jfd.build_fused_pair(index, L, Bp, index.chrom_offsets)
    ft = tfd.build_fused_pair(DeviceIndex(convert.index(index), "cpu"), L,
                              Bp)
    dj = fj(r1, r2, 150, q1, q2).host()
    dt = ft(r1, r2, 150, q1, q2).host()
    assert_dicts_equal(dj, dt)
    assert dt["_trace"]["tloc"].min() < 2 ** 30     # traces were walked
