"""The port's mate-rescue scan (bbmap_tpu_torch/ops/rescue_device.py)
against the JAX package's program (bbmap_tpu/ops/rescue_device.py), on a
genome with N runs: the plain version (``_rescue_stage``, what
``rescue_scan`` runs on CPU tensors) bit-equal to the JAX scan on seeded
edge cases; a numpy emulation of ``csrc/rescue_scan.cu``'s order (the
window and the read as 2-bit words with bad and ok bits, only the offsets
the walk reads scanned, a word of 16 positions a step with the run carried
from word to word, the walk on one warp by ballots 32 steps a chunk,
stopping at min(n, N_OFF) or past klim) bit-equal to the plain version at
the JAX tests' read length and at lengths that end inside a word, with
mutations of the walk that must fail (a tie taken at an equal absdif, the
highest voter accepted); the unpadded launch against the 1,024-row
padding the JAX program cache needs, and the one-copy upload. Tolerance:
exact (integers)."""

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
         ideal_delta=0, lm=LM):
    """One job reading the genome at ``src`` (mate-oriented codes), the
    scan window placed so that the source lies ``ideal_off`` scan steps
    in, the ideal start ``ideal_delta`` bases past it."""
    read = codes[max(0, src):src + lm].copy()
    read = np.concatenate([read, np.full(lm - len(read), 4, np.uint8)])
    for _ in range(subs):
        read[rng.integers(0, lm)] = rng.integers(0, 4)
    read[rng.integers(0, lm, n_read)] = 4
    if right:
        lo = src - ideal_off
    else:
        lo = src + ideal_off - (n - 1)
    return read, lo, n, src - lo + ideal_delta, right, max_mm


def edge_jobs(codes, seed=5, lm=LM):
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
                                 subs=int(rng.integers(0, 3)), lm=lm))
        # N bases in the read, and windows over the N run
        jobs.append(_job(rng, codes, 12_000, right, 900, 400, 10,
                         subs=1, n_read=3, lm=lm))
        jobs.append(_job(rng, codes, 9_020, right, 500, 250, 20, lm=lm))
        jobs.append(_job(rng, codes, 9_480, right, N_OFF, 700, 12, n_read=1,
                         lm=lm))
        # the genome's end and start: windows reach past both
        jobs.append(_job(rng, codes, G - lm, right, 800, 799 if right else 0,
                         6, lm=lm))
        jobs.append(_job(rng, codes, G - lm - 3, right, N_OFF,
                         N_OFF - 10 if right else 5, 6, lm=lm))
        jobs.append(_job(rng, codes, 10, right, 300, 200 if right else 100,
                         6, lm=lm))
        # ties on the repeat: equal scores every 16 offsets, the ideal
        # start on a match, between two (equal absdif) or nearer one
        for shift, delta in ((0, 0), (3, 8), (5, 5), (11, -8)):
            jobs.append(_job(rng, codes, 15_200 + shift, right, 600, 300, 4,
                             ideal_delta=delta, lm=lm))
    reads, lo, n, ik, rt, mm = (np.array(x) for x in zip(*jobs))
    # padding rows, as the JAX program's fixed budget fills them
    pad = 4
    reads = np.concatenate([reads, np.full((pad, lm), 4, np.uint8)])
    lo = np.concatenate([lo, np.zeros(pad, np.int64)])
    n = np.concatenate([n, np.zeros(pad, np.int64)])
    ik = np.concatenate([ik, np.zeros(pad, np.int64)])
    rt = np.concatenate([rt, np.zeros(pad, bool)])
    mm = np.concatenate([mm, np.full(pad, -1, np.int64)])
    return (reads.astype(np.uint8), lo.astype(np.int32), n.astype(np.int32),
            ik.astype(np.int32), rt.astype(bool), mm.astype(np.int32))


EVEN = np.uint64(0x55555555)       # bit 2i: base i of a 16-base word
M32 = np.uint64(0xffffffff)


def _words(vals):
    """(16 w,) values 0..3 to (w,) words of 16 bases, 2 bits a base
    (uint64 holding uint32)."""
    sh = np.arange(16, dtype=np.uint64) * np.uint64(2)
    return (vals.reshape(-1, 16).astype(np.uint64) << sh).sum(1).astype(
        np.uint64)


def _popc(x):
    x = x.astype(np.uint64)
    return np.array([bin(int(v)).count("1") for v in x], np.int64)


def _scan_words(codes, read, lo, used, lm, lim=None):
    """mism, score of offsets t < used as csrc/rescue_scan.cu scans them:
    the window staged as words of 2-bit codes aligned to lo with a bad bit
    at each base's even bit, the read's codes and ok bits; a word of 16
    positions a step (funnel shift, XOR, fold), the misses by popcounts,
    stopped once they pass ``lim`` (max_mm + 1: such an offset is never
    accepted, and keeps that partial count), then for the offsets within
    it the longest run, the trailing run carried from word to word and the
    runs inside a word counted by shifting where the popcount could beat
    the best so far. ``lim`` None: no offset stops."""
    G = len(codes)
    nw = -(-lm // 16)
    staged = ((used - 1) >> 4) + nw + 1
    pos = lo + np.arange(16 * staged)
    inside = (pos >= 0) & (pos < G)
    code = np.zeros(len(pos), np.int64)
    code[inside] = codes[pos[inside]]
    cw = _words(np.where(code > 3, 0, code))
    bw = _words((~inside | (code > 3)).astype(np.int64))
    rd = np.full(16 * nw, 4, np.int64)
    rd[:lm] = read
    rw = _words(np.where(rd > 3, 0, rd))
    ok = _words((rd <= 3).astype(np.int64))
    t = np.arange(used)
    q = t >> 4
    sh = ((t & 15) * 2).astype(np.uint64)
    lim = np.iinfo(np.int64).max if lim is None else lim

    def good_word(j):
        c = ((cw[q + j] | (cw[q + j + 1] << np.uint64(32))) >> sh) & M32
        b = ((bw[q + j] | (bw[q + j + 1] << np.uint64(32))) >> sh) & M32
        x = c ^ rw[j]
        return ok[j] & ~(x | (x >> np.uint64(1)) | b) & M32

    miss = np.full(used, -(16 * nw - lm), np.int64)
    for j in range(nw):
        miss += np.where(miss <= lim, _popc(~good_word(j) & EVEN), 0)
    cur = np.zeros(used, np.int64)
    best = np.zeros(used, np.int64)
    for j in range(nw):
        g = np.where(miss <= lim, good_word(j), np.uint64(0))
        pc = _popc(g)
        full = g == EVEN
        ng = ~g & EVEN
        low = ng & (~ng + np.uint64(1))                 # the lowest bad
        lead = _popc(low - np.uint64(1)) >> 1
        best = np.where(full, best, np.maximum(best, cur + lead))
        inner = np.zeros(used, np.int64)
        y = np.where(~full & (pc > best), g, np.uint64(0))
        while y.any():
            inner += y != 0
            y = y & (y >> np.uint64(2))
        best = np.maximum(best, inner)
        hi = np.frexp(np.maximum(ng, np.uint64(1)).astype(np.float64))[1] - 1
        cur = np.where(full, cur + 16, (31 - hi) >> 1)
    best = np.where(miss <= lim, np.maximum(best, cur), 0)
    return miss, (lm - miss) + best


def kernel_emulation(codes, reads, lo, n, ik, right, max_mm,
                     mutation=None, lm=LM, rounds=None):
    """numpy model of csrc/rescue_scan.cu, a job at a time: the offsets t <
    min(n, N_OFF) scanned a word of 16 positions a step, cut at max_mm + 1
    (``_scan_words``); a mark for each walk step whose offset stayed within
    that bound, a word a chunk of 32 steps; then the walk on one warp over
    the marked chunks in order: each round the marked lanes whose step
    dominates the state vote and the lowest voter is accepted; the walk
    stops at min(n, N_OFF) or once a chunk starts past klim. Mutations:
    ``"tie_le"``, a tie in score at an equal absdif replaces the match
    found first (its walk drops the lanes at or before an accept, or the
    accepted lane would vote again); ``"highest"``, a round accepts the
    highest voter; ``"lim_low"``, the scan cuts at max_mm in place of
    max_mm + 1. The variant ``"mask"`` drops the lanes at or before an
    accept from the chunk's later rounds (the kernel does not need to). (The klim stop changes no result: past kref + a every
    absdif is larger than a.) ``rounds``, a list, gets each job's ballot
    rounds."""
    R = len(reads)
    best_k = np.empty(R, np.int32)
    min_mm_out = np.empty(R, np.int32)
    lane = np.arange(32)
    for b in range(R):
        used = max(0, min(int(n[b]), N_OFF))
        lim = int(max_mm[b]) + 1
        mism = score = np.zeros(0, np.int64)
        if used:
            mism, score = _scan_words(codes, reads[b], int(lo[b]), used, lm,
                                      lim - (mutation == "lim_low"))
        nb, ib = int(n[b]), int(ik[b])
        rt = bool(right[b])
        kref = ib if rt else (nb - 1) - ib
        mn, bs, ba, bk, klim = lim, 0, 2 ** 30, -1, N_OFF
        n_rounds = 0
        for k0 in range(0, used, 32):
            if k0 > klim:
                break
            k = k0 + lane
            inn = k < used
            t = np.where(rt, k, (nb - 1) - k)
            ts = np.clip(t, 0, N_OFF - 1)
            m = np.where(inn, mism[np.minimum(ts, used - 1)], 0)
            s = np.where(inn, score[np.minimum(ts, used - 1)], 0)
            a = np.abs(t - ib)
            left = inn & (m <= lim)            # the chunk's marks
            if not left.any():
                continue
            while True:
                n_rounds += 1
                better = a <= ba if mutation == "tie_le" else a < ba
                dom = left & (k <= klim) & (m <= mn) & (
                    (s > bs) | ((s == bs) & better))
                if not dom.any():
                    break
                at = int(np.flatnonzero(dom)[-1 if mutation == "highest"
                                                else 0])
                mn, bs, ba, bk = int(m[at]), int(s[at]), int(a[at]), k0 + at
                if mn == 0:
                    klim = min(klim, kref + ba)
                if mutation in ("mask", "tie_le"):   # the order not strict
                    left &= lane > at
        if rounds is not None:
            rounds.append(n_rounds)
        best_k[b], min_mm_out[b] = bk, mn
    return best_k, min_mm_out


def _plain(dix, jobs, lm=LM):
    up = trd.upload_jobs(*jobs, "cpu")
    return [x.numpy() for x in trd.rescue_scan(dix, *up, lm, N_OFF)]


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


@pytest.mark.parametrize("mutation", ["highest", "lim_low"])
def test_edge_cases_catch_a_broken_walk(setup, mutation):
    """A walk whose round accepts the highest voting lane of a chunk in
    place of the lowest (a later step that also dominates the state), and
    a scan that cuts offsets at max_mm where an offset of max_mm + 1
    misses can still be accepted, give other rows, in both directions."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes, seed=9)
    want = _plain(dix, jobs)
    got = kernel_emulation(index.genome_codes, *jobs, mutation=mutation)
    apart = (got[0] != want[0]) | (got[1] != want[1])
    assert (apart & jobs[4]).any() and (apart & ~jobs[4]).any()


def test_walk_mask_changes_no_round(setup):
    """The lanes at or before an accept cannot vote again, so the kernel
    does not mask them out: the accept test is a strict lexicographic
    order on (score, -absdif) with bounds that only tighten, so a step
    that did not dominate the state before an accept does not dominate the
    state after it, nor does the accepted step dominate itself. With the
    mask the walk gives the same rows in the same number of rounds."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes, seed=9)
    masked, unmasked = [], []
    got = kernel_emulation(index.genome_codes, *jobs, mutation="mask",
                           rounds=masked)
    loose = kernel_emulation(index.genome_codes, *jobs, rounds=unmasked)
    np.testing.assert_array_equal(got[0], loose[0])
    np.testing.assert_array_equal(got[1], loose[1])
    assert masked == unmasked
    # rounds = accepts + marked chunks: far fewer than the serial walk's
    # steps
    steps = np.minimum(np.maximum(jobs[2], 0), N_OFF).sum()
    assert sum(masked) < steps / 20


def _byte_scan(codes, read, lo, used, lm):
    """mism, score of offsets t < used a base at a time: the window's codes
    with bad bases as 4, the read's N as 5, one compare a base."""
    G = len(codes)
    pos = lo + np.arange(used + lm - 1)
    inside = (pos >= 0) & (pos < G)
    win = np.full(len(pos), 4, np.int64)
    win[inside] = np.minimum(codes[pos[inside]], 4)
    rd = np.where(read > 3, 5, read)
    mism = np.zeros(used, np.int64)
    cur = np.zeros(used, np.int64)
    best = np.zeros(used, np.int64)
    for j in range(lm):
        good = win[j:j + used] == rd[j]
        mism += ~good
        cur = np.where(good, cur + 1, 0)
        best = np.maximum(best, cur)
    return mism, (lm - mism) + best


@pytest.mark.parametrize("lm", [64, 150, 37, 16])
def test_word_scan_equals_byte_scan(setup, lm):
    """Every scanned offset's mism and score, a word of 16 positions a step
    (runs carried across words, counted inside a word only where they
    could beat the best), equal to a count a base at a time, on the edge
    jobs (N runs, the genome's ends, the repeat); with the scan cut at
    max_mm + 1, the offsets within it equal and every offset cut past it
    with a stored mism past it too."""
    index, _ = setup
    codes = index.genome_codes
    reads, lo, n, _ik, _rt, max_mm = edge_jobs(codes, seed=lm + 1, lm=lm)
    runs = cut = 0
    for b in range(len(reads)):
        used = max(0, min(int(n[b]), N_OFF))
        if not used:
            continue
        got = _scan_words(codes, reads[b], int(lo[b]), used, lm)
        want = _byte_scan(codes, reads[b], int(lo[b]), used, lm)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        runs += int((want[1] - (lm - want[0]) >= min(lm, 20)).sum())
        lim = int(max_mm[b]) + 1
        cm, cs_ = _scan_words(codes, reads[b], int(lo[b]), used, lm, lim)
        within = want[0] <= lim
        np.testing.assert_array_equal(cm[within], want[0][within])
        np.testing.assert_array_equal(cs_[within], want[1][within])
        assert (cm[~within] > lim).all()
        cut += int((cm[~within] < want[0][~within]).sum())
    # long runs, and counts cut short where a read has a word to skip
    assert runs > 0 and (cut > 0 or lm <= 16)


@pytest.mark.parametrize("lm", [150, 37, 16, 1])
def test_kernel_emulation_at_other_lengths(setup, lm):
    """The kernel's order bit-equal to the plain version at reads that end
    inside a word (37), on a word's edge (16), of one base (1) and of the
    main path's 150 bp."""
    index, dix = setup
    jobs = edge_jobs(index.genome_codes, seed=lm, lm=lm)
    want = _plain(dix, jobs, lm)
    got = kernel_emulation(index.genome_codes, *jobs, lm=lm)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (want[0] >= 0).sum() > 20


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
