"""The port's mate-rescue scan (bbmap_tpu_torch/ops/rescue_device.py)
against the JAX package's program (bbmap_tpu/ops/rescue_device.py), on a
genome with N runs: the plain version (``_rescue_stage``, what
``rescue_scan`` runs on CPU tensors) bit-equal to the JAX scan on seeded
edge cases, a numpy emulation of ``csrc/rescue_scan.cu``'s loop order
(the window staged with bad bases as 4 and read N as 5, only the offsets
the walk reads scanned, the walk on one thread stopping at min(n, N_OFF)
or past klim) bit-equal to the plain version, the unpadded launch against
the 1,024-row padding the JAX program cache needs, and the one-copy
upload. Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch

from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import build_index
from bbmap_tpu.ops import rescue_device as jrd
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
from bbmap_tpu_torch.ops import rescue_device as trd

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)
LM, N_OFF = 64, 1536
PAD_ROWS = 1024          # the JAX program's fixed job budget


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    g = rng.choice(BASES, size=30_000).astype(np.uint8)
    g[9_000:9_040] = ord("N")
    g[9_500] = ord("N")
    unit = rng.choice(BASES, size=16).astype(np.uint8)
    g[15_000:15_800] = np.tile(unit, 50)        # ties: period 16
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="c1")]).finalize()
    index = build_index(genome, 13)
    dix = DeviceIndex(convert.index(index), "cpu")
    assert dix.has_n
    return index, dix


def _job(rng, codes, src, right, n, ideal_off, max_mm, subs=0, n_read=0,
         ideal_delta=0):
    """One job reading the genome at ``src`` (mate-oriented codes), the
    scan window placed so that the source lies ``ideal_off`` scan steps
    in, the ideal start ``ideal_delta`` bases past it."""
    read = codes[max(0, src):src + LM].copy()
    read = np.concatenate([read, np.full(LM - len(read), 4, np.uint8)])
    for _ in range(subs):
        read[rng.integers(0, LM)] = rng.integers(0, 4)
    read[rng.integers(0, LM, n_read)] = 4
    if right:
        lo = src - ideal_off
    else:
        lo = src + ideal_off - (n - 1)
    return read, lo, n, src - lo + ideal_delta, right, max_mm


def edge_jobs(codes, seed=5):
    """Seeded jobs over the cases the kernel must hold: both directions;
    n = 1, n < N_OFF and n = N_OFF; N bases in the read and in the window;
    windows past the genome's end and before its start; max_mm 0 and -1;
    ties in (score, absdif) on the period-16 repeat; padding rows (n = 0,
    max_mm -1, an all-N read)."""
    rng = np.random.default_rng(seed)
    G = len(codes)
    jobs = []
    for right in (True, False):
        for n in (1, 2, 37, 700, N_OFF - 1, N_OFF):
            for max_mm in (0, 3, 12, -1):
                src = int(rng.integers(2_000, 25_000))
                off = int(rng.integers(0, n))
                jobs.append(_job(rng, codes, src, right, n, off, max_mm,
                                 subs=int(rng.integers(0, 3))))
        # N bases in the read, and windows over the N run
        jobs.append(_job(rng, codes, 12_000, right, 900, 400, 10,
                         subs=1, n_read=3))
        jobs.append(_job(rng, codes, 9_020, right, 500, 250, 20))
        jobs.append(_job(rng, codes, 9_480, right, N_OFF, 700, 12, n_read=1))
        # the genome's end and start: windows reach past both
        jobs.append(_job(rng, codes, G - LM, right, 800, 799 if right else 0,
                         6))
        jobs.append(_job(rng, codes, G - LM - 3, right, N_OFF,
                         N_OFF - 10 if right else 5, 6))
        jobs.append(_job(rng, codes, 10, right, 300, 200 if right else 100,
                         6))
        # ties on the repeat: equal scores every 16 offsets, the ideal
        # start on a match, between two (equal absdif) or nearer one
        for shift, delta in ((0, 0), (3, 8), (5, 5), (11, -8)):
            jobs.append(_job(rng, codes, 15_200 + shift, right, 600, 300, 4,
                             ideal_delta=delta))
    reads, lo, n, ik, rt, mm = (np.array(x) for x in zip(*jobs))
    # padding rows, as the JAX program's fixed budget fills them
    pad = 4
    reads = np.concatenate([reads, np.full((pad, LM), 4, np.uint8)])
    lo = np.concatenate([lo, np.zeros(pad, np.int64)])
    n = np.concatenate([n, np.zeros(pad, np.int64)])
    ik = np.concatenate([ik, np.zeros(pad, np.int64)])
    rt = np.concatenate([rt, np.zeros(pad, bool)])
    mm = np.concatenate([mm, np.full(pad, -1, np.int64)])
    return (reads.astype(np.uint8), lo.astype(np.int32), n.astype(np.int32),
            ik.astype(np.int32), rt.astype(bool), mm.astype(np.int32))


def kernel_emulation(codes, reads, lo, n, ik, right, max_mm,
                     mutation=None):
    """numpy model of csrc/rescue_scan.cu, a job at a time: the staged
    window (bad = 4) and read (N = 5), per-offset statistics for t <
    min(n, N_OFF) only, and the walk of thread 0 with its early stops.
    ``mutation="tie_le"`` breaks it on purpose: a tie in score at an
    equal absdif replaces the match found first. (The klim stop changes
    no result: past kref + a every absdif is larger than a.)"""
    G = len(codes)
    R = len(reads)
    best_k = np.empty(R, np.int32)
    min_mm_out = np.empty(R, np.int32)
    for b in range(R):
        used = max(0, min(int(n[b]), N_OFF))
        staged = used + LM - 1 if used else 0
        pos = int(lo[b]) + np.arange(staged)
        inside = (pos >= 0) & (pos < G)
        win = np.full(staged, 4, np.uint8)
        win[inside] = codes[pos[inside]]
        win[win > 3] = 4
        rd = np.where(reads[b] > 3, 5, reads[b]).astype(np.uint8)
        mism = np.zeros(used, np.int64)
        cur = np.zeros(used, np.int64)
        best = np.zeros(used, np.int64)
        for j in range(LM):
            good = win[j:j + used] == rd[j]
            mism += ~good
            cur = np.where(good, cur + 1, 0)
            best = np.maximum(best, cur)
        score = (LM - mism) + best
        nb, ib = int(n[b]), int(ik[b])
        rt = bool(right[b])
        kref = ib if rt else (nb - 1) - ib
        mn, bs, ba, bk, klim = int(max_mm[b]) + 1, 0, 2 ** 30, -1, N_OFF
        k = 0
        while k < used and k <= klim:
            t = k if rt else (nb - 1) - k
            ts = min(t, N_OFF - 1)
            m, s, a = int(mism[ts]), int(score[ts]), abs(t - ib)
            better = a <= ba if mutation == "tie_le" else a < ba
            if m <= mn and (s > bs or (s == bs and better)):
                mn, bs, ba, bk = m, s, a, k
                if m == 0:
                    klim = min(klim, kref + a)
            k += 1
        best_k[b], min_mm_out[b] = bk, mn
    return best_k, min_mm_out


def _plain(dix, jobs):
    up = trd.upload_jobs(*jobs, "cpu")
    return [x.numpy() for x in trd.rescue_scan(dix, *up, LM, N_OFF)]


def test_plain_matches_jax_on_edge_cases(setup):
    """The plain version bit-equal to the JAX program on every edge case,
    with accepted and rejected rows of every kind among them."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes)
    R = len(jobs[0])
    bk_t, mm_t = _plain(dix, jobs)
    bk_j, mm_j = jrd.build_rescue(index, LM, R, N_OFF)(*jobs)
    np.testing.assert_array_equal(bk_t, np.asarray(bk_j))
    np.testing.assert_array_equal(mm_t, np.asarray(mm_j))
    lo, n, right, max_mm = jobs[1], jobs[2], jobs[4], jobs[5]
    found = bk_t >= 0
    assert found.sum() > 40 and (~found).sum() >= 10
    # both directions found something, exact matches under max_mm 0, and
    # the padding rows found nothing
    assert (found & right).any() and (found & ~right).any()
    assert (found & (max_mm == 0)).any()
    assert not found[n == 0].any()
    assert (mm_t[n == 0] == 0).all()
    # windows past the genome's end accepted a start inside it
    end = found & (lo + n - 1 + LM > len(index.genome_codes) - 1)
    assert end.any()


def test_kernel_emulation_matches_plain(setup):
    """The kernel's loop order (numpy model) bit-equal to the plain
    version on the edge cases and on ties."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes, seed=9)
    want = _plain(dix, jobs)
    got = kernel_emulation(index.genome_codes, *jobs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_edge_cases_catch_a_broken_tie_rule(setup):
    """The edge cases reach the absdif tie rule: a walk that takes a tie
    at an equal absdif gives other rows, in both directions."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes, seed=9)
    want = _plain(dix, jobs)
    got = kernel_emulation(index.genome_codes, *jobs, mutation="tie_le")
    apart = got[0] != want[0]
    assert (apart & jobs[4]).any() and (apart & ~jobs[4]).any()


def test_unpadded_equals_padded(setup):
    """The real rows of one launch equal those of the 1,024-row padding
    (padding rows: all-N read, n = 0, max_mm -1)."""
    index, dix = setup
    reads, lo, n, ik, rt, mm = edge_jobs(index.genome_codes, seed=13)
    R = len(reads)
    pad = PAD_ROWS - R
    padded = (np.concatenate([reads, np.full((pad, LM), 4, np.uint8)]),
              np.concatenate([lo, np.zeros(pad, np.int32)]),
              np.concatenate([n, np.zeros(pad, np.int32)]),
              np.concatenate([ik, np.zeros(pad, np.int32)]),
              np.concatenate([rt, np.zeros(pad, bool)]),
              np.concatenate([mm, np.full(pad, -1, np.int32)]))
    got = _plain(dix, (reads, lo, n, ik, rt, mm))
    want = _plain(dix, padded)
    np.testing.assert_array_equal(got[0], want[0][:R])
    np.testing.assert_array_equal(got[1], want[1][:R])
    assert (want[0][R:] == -1).all()


def test_upload_and_build_rescue(setup):
    """upload_jobs lays the arrays out in one buffer and hands back views
    equal to them; build_rescue takes at most R jobs a call."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes)
    up = trd.upload_jobs(*jobs, "cpu")
    assert len({t.untyped_storage().data_ptr() for t in up}) == 1
    for got, want in zip(up, jobs):
        np.testing.assert_array_equal(got.numpy(), want)
    assert up[4].dtype == torch.bool and up[0].dtype == torch.uint8
    R = len(jobs[0])
    run = trd.build_rescue(dix, LM, R, N_OFF)
    bk, mm = run(*jobs)
    np.testing.assert_array_equal(bk, _plain(dix, jobs)[0])
    with pytest.raises(ValueError):
        trd.build_rescue(dix, LM, R - 1, N_OFF)(*jobs)
    trd.reset_launches()
    assert trd.rescue_scan.launches == 0


def test_wrapper_checks_its_inputs(setup):
    index, dix = setup
    reads, lo, n, ik, rt, mm = (torch.from_numpy(x) for x in
                                edge_jobs(index.genome_codes))
    with pytest.raises(TypeError):
        trd.rescue_scan(dix, reads, lo.long(), n, ik, rt, mm, LM, N_OFF)
    with pytest.raises(TypeError):
        trd.rescue_scan(dix, reads, lo, n, ik, rt.to(torch.int32), mm, LM,
                        N_OFF)
    with pytest.raises(ValueError):
        trd.rescue_scan(dix, reads[:, :10], lo, n, ik, rt, mm, LM, N_OFF)


def test_kernel_equals_plain_on_the_card(setup):
    """The CUDA kernel, one launch, against the plain version on the card
    (chip_smoke.py does this on the main path's jobs and on 1,024 edge
    jobs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    index, _ = setup
    dev = torch.device("cuda", 0)
    dix = DeviceIndex(convert.index(index), dev)
    up = trd.upload_jobs(*edge_jobs(index.genome_codes), dev)
    want = trd._rescue_stage(dix, up[0], up[0] > 3, *up[1:], LM, N_OFF)
    trd.reset_launches()
    got = trd.rescue_scan(dix, *up, LM, N_OFF)
    assert trd.rescue_scan.launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
