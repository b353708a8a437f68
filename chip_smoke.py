#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bbmap_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each timed on its own line:

1. device facts: the card's name and power limit;
2. build: nvcc builds ``bbmap_tpu_torch/csrc/msa_dp.cu`` into
   ``build/torch_kernels/`` (skipped when a library of the same source
   hash is there);
3. kernel vs plain: the DP kernels against their plain PyTorch versions
   on the card, bit-equal (tolerance 0: the DP is integer arithmetic):
   K2 score and K3 fill at the short path's shapes (one row per thread),
   PACBIO at (1,100, 1,200) and at the long-read shapes (6,000, 6,456)
   and (6,000, 8,192) (rows strided over the block), and K1 on its own
   operands at (150, 174); kernel and plain times at the shapes the
   paths use;
4. K1 entry point: ``msa_kernels.score_batch`` on 32,768 jobs, counted;
5. main path: ``make -C csrc`` once (its return code is reported next
   to the quality-offset route), then the bench workload (4.6 Mbp genome
   with repeat families, k=13 index, 2x150 bp pairs with quality, 32,768
   pairs a batch) through ``BBMapAligner.map_pairs_columnar`` (one warmup
   batch) and ``map_pairs_columnar_stream`` (3 steady batches), graded
   against the simulated origins; fails below sensitivity 0.997, mapped
   fraction 0.999 or pair rate 0.997, or when K2 or K3 was never
   launched;
6. SAM: ``emit_sam`` on the first 1,000 pairs;
7. long reads: bench_tools.bench_mappacbio's inputs (400 PacBio-model
   reads of 6 kbp at 12 % error on the same genome) through the port's
   ``mappacbio`` CLI on the card, graded by gradesam (strict = within
   400 bp); fails below mapped 0.98 or strict 0.65, or when the
   strided-row K2 or K3 was never launched.

Each path's launch counts are set to 0 just before it and read just
after. Any failure raises and exits non-zero without the final ``ok``
line. It exits 2 when no CUDA device is available or when it is not run
from a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
L = 150
N_PAIRS = 32768
N_STEADY = 3
SENS_MIN, MAPPED_MIN, PAIR_MIN = 0.997, 0.999, 0.997
N_LONG, L_LONG = 400, 6000
LONG_MAPPED_MIN, LONG_STRICT_MIN = 0.98, 0.65
K1_JOBS = 32768
REPLACES = {"msa_score_rows": "bbmap_tpu/ops/msa_pallas.py:243",
            "msa_score": "bbmap_tpu/ops/msa_pallas.py:577",
            "msa_fill": "bbmap_tpu/ops/msa_pallas.py:588"}
SOURCE = "bbmap_tpu_torch/csrc/msa_dp.cu"


def say(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cuda_ms(fn, reps: int, warm: bool = True):
    """Mean milliseconds of ``reps`` calls of fn between CUDA events
    (after one warmup call when ``warm``), and the last call's result."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def _pb_errors(rng, src, n: int, err: float):
    """PacBio-model errors at rate ``err`` per source base (60 %
    insertions, 25 % deletions, 15 % substitutions, as tests/test_pacbio.py
    draws them); the first n bases of the result."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    u = rng.random(len(src))
    ins = u < 0.60 * err
    sub = (u >= 0.85 * err) & (u < err)
    keep = ~((u >= 0.60 * err) & (u < 0.85 * err))
    src = src.copy()
    src[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
    counts = keep.astype(np.int64) + ins
    pos = np.cumsum(counts) - 1                 # where each kept base lands
    out = np.empty(int(counts.sum()), np.uint8)
    out[pos[keep]] = src[keep]
    out[pos[ins] - 1] = bases[rng.integers(0, 4, int(ins.sum()))]
    return out[:n]


def dp_jobs(genome, n: int, R: int, C: int, seed: int, device,
            var_rows: bool = True, pb_err: float = 0.0):
    """Bench-like DP jobs: reads sampled from the genome with 1-3
    substitutions or one 1-10 bp insertion/deletion (or, with
    ``pb_err``, PacBio-model errors at that rate), windows around the
    origin as the fused program cuts them (start - 4), and, when
    ``var_rows``, a quarter of the jobs with 1-8 fewer rows (the read
    padded with N)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    G = len(genome)
    starts = rng.integers(8, G - C - (2 if pb_err else 1) * R - 32, n)
    reads = np.empty((n, R), np.uint8)
    refs = np.empty((n, C), np.uint8)
    for i, s in enumerate(starts):
        refs[i] = genome[s - 4:s - 4 + C]
        if pb_err:
            reads[i] = _pb_errors(rng, genome[s:s + 2 * R], R, pb_err)
            continue
        src = genome[s:s + R + 16].copy()
        kind = rng.random()
        if kind < 0.4:
            for _ in range(int(rng.integers(1, 4))):
                src[rng.integers(0, R)] = bases[rng.integers(0, 4)]
        elif kind < 0.7:
            d, p = int(rng.integers(1, 11)), int(rng.integers(10, R - 10))
            src = np.concatenate([src[:p], src[p + d:]])
        else:
            d, p = int(rng.integers(1, 11)), int(rng.integers(10, R - 10))
            src = np.concatenate([src[:p], bases[rng.integers(0, 4, d)],
                                  src[p:]])
        reads[i] = src[:R]
    rows = np.full(n, R, np.int32)
    if var_rows:
        short = rng.random(n) < 0.25
        rows[short] -= rng.integers(1, 9, int(short.sum())).astype(np.int32)
        for i in np.nonzero(short)[0]:
            reads[i, rows[i]:] = ord("N")
    dev = torch.device(device)
    return (torch.from_numpy(reads).to(dev), torch.from_numpy(refs).to(dev),
            torch.from_numpy(rows).to(dev))


def valid_cells(rows, R: int, C: int):
    """(B, R+C, R+1) mask of the cells where prev codes are defined."""
    import torch
    dev = rows.device
    d = torch.arange(1, R + C + 1, device=dev).view(1, -1, 1)
    r = torch.arange(R + 1, device=dev).view(1, 1, -1)
    c = d - r
    return (r >= 1) & (r <= rows.view(-1, 1, 1)) & (c >= 1) & (c <= C)


def kernel_phase(genome, device) -> dict:
    """Kernels against their plain versions on the card; returns per
    kernel variant {max_abs_err, ms, plain_ms}: "msa_score_rows" (K1),
    "msa_score" / "msa_fill" (one row per thread) and "msa_score_long" /
    "msa_fill_long" (rows strided over the block)."""
    import torch
    from bbmap_tpu.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk

    err = {}

    def record(name, tag, n, R, C, e, what=""):
        key = name + ("_long" if mk.launch_shape(R, C).long else "")
        err[key] = max(err.get(key, 0), e)
        say(f"kernel {key} {tag}: {n} jobs (R, C) = ({R}, {C}) "
            f"max_abs_err {e}{what}")
        if e != 0:
            raise AssertionError(f"{key} disagrees with its plain version "
                                 f"({tag})")

    def jobs(n, R, C, seed, pb_err=0.0):
        return dp_jobs(genome, n, R, C, seed, device, pb_err=pb_err)

    def cmp_score(tag, P, job, k=None, p=None):
        rd, rf, rw = job
        k = mk.msa_score(rd, rf, rw, P) if k is None else k
        p = mk.msa_score_plain(rd, rf, rw, P) if p is None else p
        _sync(device)
        record("msa_score", tag, *rd.shape, rf.shape[1],
               int((k.long() - p.long()).abs().max()))

    def cmp_fill(tag, P, job, k=None, p=None):
        rd, rf, rw = job
        k, kp = mk.msa_fill(rd, rf, rw, P) if k is None else k
        p, pp = mk.msa_fill_plain(rd, rf, rw, P) if p is None else p
        _sync(device)
        R, C = rd.shape[1], rf.shape[1]
        valid = valid_cells(rw, R, C)
        e = max(int((k.long() - p.long()).abs().max()),
                int(((kp.short() - pp.short()).abs() * valid).max()))
        record("msa_fill", tag, len(rw), R, C, e,
               " (out and prev codes on valid cells)")

    def cmp_rows(tag, job):
        rd, rf, rw = job
        R, C = rd.shape[1], rf.shape[1]
        r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
        k = mk.msa_score_rows(r1, r0, (rp, rows), R, C, 64)
        p = mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 64)
        _sync(device)
        record("msa_score_rows", tag, len(rw), R, C,
               int((k.long() - p.long()).abs().max()))

    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    cmp_score("short narrow", S, jobs(4096, L, L + 24, 1))
    cmp_score("short wide", S, jobs(512, L, L + 456, 2))
    cmp_score("pacbio", PB, jobs(256, 300, 360, 3))
    cmp_fill("short narrow", S, jobs(1024, L, L + 24, 4))
    cmp_fill("short wide", S, jobs(64, L, L + 456, 5))
    cmp_fill("pacbio", PB, jobs(256, 300, 360, 6))
    cmp_rows("short narrow", jobs(4096, L, L + 24, 12))
    # rows strided over the block: just past the old 1,023-row limit and
    # at the long-indel pass's widest window (the long-read escalation
    # window is compared on its timing runs below)
    cmp_score("pacbio past 1,023 rows", PB, jobs(8, 1100, 1200, 13, 0.12))
    cmp_fill("pacbio past 1,023 rows", PB, jobs(8, 1100, 1200, 14, 0.12))
    cmp_score("pacbio long-indel width", PB, jobs(2, L_LONG, 8192, 15, 0.12))
    cmp_fill("pacbio long-indel width", PB, jobs(2, L_LONG, 8192, 16, 0.12))

    # times at the paths' shapes: the short path's 2E = 32,768 score
    # jobs and T = 8,192 fill jobs at (R, C) = (150, 174), K1 at its
    # entry point's 32,768 jobs, and the long-read wide escalation
    # window (6,000, 6,456): 256 score jobs and 16 fill jobs, whose
    # kernel and plain results are compared as well
    out = {}

    def timed(name, kern, plain, reps, plain_warm=True):
        ms, k = _cuda_ms(kern, reps)
        plain_ms, p = _cuda_ms(plain, 1, warm=plain_warm)
        out[name] = {"ms": ms, "plain_ms": plain_ms}
        return k, p

    rd, rf, rw = dp_jobs(genome, 2 * 16384, L, L + 24, 7, device,
                         var_rows=False)
    timed("msa_score", lambda: mk.msa_score(rd, rf, rw, S),
          lambda: mk.msa_score_plain(rd, rf, rw, S), 10)
    r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
    R, C = rd.shape[1], rf.shape[1]
    timed("msa_score_rows",
          lambda: mk.msa_score_rows(r1, r0, (rp, rows), R, C, 64),
          lambda: mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 64), 10)
    rd, rf, rw = rd[:8192], rf[:8192], rw[:8192]
    timed("msa_fill", lambda: mk.msa_fill(rd, rf, rw, S),
          lambda: mk.msa_fill_plain(rd, rf, rw, S), 10)
    job = rd, rf, rw = jobs(256, L_LONG, L_LONG + 456, 19, 0.12)
    k, p = timed("msa_score_long", lambda: mk.msa_score(rd, rf, rw, PB),
                 lambda: mk.msa_score_plain(rd, rf, rw, PB), 2, False)
    cmp_score("pacbio long read", PB, job, k, p)
    job = rd, rf, rw = jobs(16, L_LONG, L_LONG + 456, 20, 0.12)
    k, p = timed("msa_fill_long", lambda: mk.msa_fill(rd, rf, rw, PB),
                 lambda: mk.msa_fill_plain(rd, rf, rw, PB), 2, False)
    cmp_fill("pacbio long read", PB, job, k, p)
    # 28 jobs: the pipeline's chunk cap at this window; the prev-code
    # block is 28 x 12,456 x 6,001 = 2.09e9 bytes, past 2**31, so the
    # last jobs check the kernel's 64-bit indexing
    rd, rf, rw = jobs(28, L_LONG, L_LONG + 456, 22, 0.12)
    k, kp = mk.msa_fill(rd, rf, rw, PB)
    cmp_fill("pacbio long read, last 2 of 28 jobs (prev codes past 2**31 "
             "bytes)", PB, (rd[26:], rf[26:], rw[26:]),
             (k[:, 26:], kp[26:]))
    del k, kp
    shapes = {"msa_score": "32,768 x (150, 174)",
              "msa_score_rows": "32,768 x (150, 174)",
              "msa_fill": "8,192 x (150, 174)",
              "msa_score_long": "256 x (6,000, 6,456) PACBIO",
              "msa_fill_long": "16 x (6,000, 6,456) PACBIO"}
    for name, t in out.items():
        t["max_abs_err"] = err[name]
        say(f"time {name} at {shapes[name]}: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms")
    return out


def k1_entry(genome, device) -> int:
    """K1's own entry point, ``score_batch``, on the card at 32,768 jobs
    of (150, 174), counted; held equal to K2 on the same jobs. Returns
    K1's launch count."""
    from bbmap_tpu.core.constants import SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk
    rd, rf, rw = dp_jobs(genome, K1_JOBS, L, L + 24, 21, device)
    mk.reset_launches()
    got = mk.score_batch(rd, rf, rw, BB=64)
    _sync(device)
    n = mk.msa_score_rows.launches
    want = mk.msa_score_plain(rd, rf, rw, SHORT_PROFILE)
    e = max(int((g.long() - w.long()).abs().max())
            for g, w in zip(got, want))
    say(f"K1 entry point score_batch: {K1_JOBS} jobs, launches {n}, "
        f"max_abs_err vs plain {e}")
    if e != 0 or n == 0:
        raise AssertionError("score_batch did not run K1 or disagrees")
    return n


def grade(aligner, graded, t1, t2, n_pairs: int) -> dict:
    """bench.grade: strict-correct within 20 bp of the sampled origin,
    over both mates; pair rate over mate 1's proper-pair flags."""
    import numpy as np
    n_mapped = n_correct = n_paired = 0
    for b, (mb1, mb2) in graded:
        lo = b * n_pairs
        for mb, truth in ((mb1, t1), (mb2, t2)):
            tr = truth[lo:lo + n_pairs]
            flat = aligner.chrom_offsets[np.maximum(mb.chrom, 1) - 1] \
                + mb.start
            n_mapped += int(mb.mapped.sum())
            n_correct += int((mb.mapped & (np.abs(flat - tr) <= 20)).sum())
        n_paired += int(mb1.paired.sum())
    n_total = 2 * len(graded) * n_pairs
    return {"sensitivity": n_correct / n_total,
            "mapped_fraction": n_mapped / n_total,
            "pair_rate": n_paired / (len(graded) * n_pairs)}


def launch_counts() -> dict:
    """Each kernel wrapper's launches since the last reset, with the
    strided-row launches as "<name>_long"."""
    from bbmap_tpu_torch.ops import msa_kernels
    out = {}
    for k in msa_kernels.KERNELS:
        out[k.__name__] = k.launches
        out[k.__name__ + "_long"] = k.long_launches
    return out


def make_csrc() -> str:
    """``make -C csrc`` (the JAX package's native host library, which
    sets the quality-offset route): return code and the last lines of
    its stderr, on one line."""
    try:
        p = subprocess.run(["make", "-C", str(ROOT / "csrc")],
                           capture_output=True, text=True, timeout=300)
        rc, tail = p.returncode, p.stderr.strip().splitlines()[-3:]
    except (OSError, subprocess.TimeoutExpired) as e:
        rc, tail = None, [f"{type(e).__name__}: {e}"]
    return f"make -C csrc: rc={rc} stderr: {' | '.join(tail) or '(none)'}"


def main_path(device, n_pairs: int = N_PAIRS, n_steady: int = N_STEADY,
              genome_bases=None, check: bool = True,
              make_report: str = "not run"):
    """The bench workload through the port's aligner. Returns (summary
    dict, (batch1, batch2, (mb1, mb2), aligner) of the warmup batch)."""
    import numpy as np
    import torch

    import bench
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu.core.genome import Genome, Scaffold
    from bbmap_tpu.index.build import analyze_index, build_index
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.ops import msa_kernels

    t0 = time.time()
    gbases = bench.make_genome() if genome_bases is None else genome_bases
    g = Genome(chroms=[gbases], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(gbases),
                 name="ecoli_like")]).finalize()
    index = build_index(g, 13)
    analyze_index(index, 0.01)
    aligner = BBMapAligner(g, index, device)
    n_batches = 1 + n_steady
    r1, r2, q1, q2, t1, t2 = bench.make_pairs(
        gbases, n_pairs * n_batches, L=L, seed=11, with_quality=True)
    say(f"setup: genome {len(gbases)} bp, index k=13, "
        f"{n_batches} x {n_pairs} pairs: {time.time() - t0:.1f} s")

    def mk(rows, quals, b):
        lo = b * n_pairs
        return ReadBatch(
            bases=rows[lo:lo + n_pairs], quality=quals[lo:lo + n_pairs],
            lengths=np.full(n_pairs, L, np.int32),
            ids=[str(i) for i in range(lo, lo + n_pairs)],
            numeric_ids=np.arange(lo, lo + n_pairs, dtype=np.int64))

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    msa_kernels.reset_launches()
    tw = time.time()
    out0 = aligner.map_pairs_columnar(mk(r1, q1, 0), mk(r2, q2, 0))
    warm_s = time.time() - tw
    say(f"warmup batch: {warm_s:.2f} s")
    ts = time.time()
    outs = list(aligner.map_pairs_columnar_stream(
        (mk(r1, q1, b), mk(r2, q2, b)) for b in range(1, n_batches)))
    _sync(device)
    dt = time.time() - ts
    launches = launch_counts()
    res = grade(aligner, [(0, out0)] + [(b + 1, o)
                                        for b, o in enumerate(outs)],
                t1, t2, n_pairs)
    res["reads_per_s"] = 2 * n_steady * n_pairs / dt
    res["steady_s"] = dt
    res["warmup_s"] = warm_s
    res["launches"] = launches
    res["max_memory_allocated"] = \
        torch.cuda.max_memory_allocated() if on_card else None
    res["n_esc_rows"] = aligner._n_esc_rows
    res["n_fallback_rows"] = aligner._n_fallback_rows
    # quality offsets come from the native host stage when its library
    # builds, else from the device stage (same results either way)
    from bbmap_tpu.io import native
    res["quality_offsets"] = "host" if native.get_lib() is not None \
        else "device"
    res["make_csrc"] = make_report

    # per-stage decomposition on one more batch, stage by stage
    b1x, b2x = mk(r1, q1, 1), mk(r2, q2, 1)
    stages = {}
    st = time.time()
    f = aligner._fused_pair_dispatch(b1x, b2x, L)
    _sync(device)
    stages["fused_device_ms"] = 1e3 * (time.time() - st)
    st = time.time()
    dd = f.host()
    stages["fetch_ms"] = 1e3 * (time.time() - st)
    st = time.time()
    mid = aligner._pair_phase1(b1x, b2x, L, dd)
    _sync(device)
    stages["host_assemble_ms"] = 1e3 * (time.time() - st)
    st = time.time()
    aligner._pair_phase2(mid)
    _sync(device)
    stages["rescue_ms"] = 1e3 * (time.time() - st)
    res["stages"] = stages
    say("main path: " + json.dumps({k: v for k, v in res.items()}))
    if check:
        if res["sensitivity"] < SENS_MIN or \
                res["mapped_fraction"] < MAPPED_MIN or \
                res["pair_rate"] < PAIR_MIN:
            raise AssertionError(
                f"accuracy below the bar (sensitivity >= {SENS_MIN}, "
                f"mapped >= {MAPPED_MIN}, pair rate >= {PAIR_MIN})")
        if not (launches["msa_score"] and launches["msa_fill"]):
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
    return res, (mk(r1, q1, 0), mk(r2, q2, 0), out0, aligner)


def sam_phase(first, n: int = 1000) -> int:
    """emit_sam on the first n pairs; every line has >= 11 fields and
    flags 99/147 appear. Returns the number of lines."""
    import numpy as np
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu_torch.align.pipeline import MappedRead, emit_sam
    b1, b2, (mb1, mb2), aligner = first

    def sub(b):
        return ReadBatch(bases=b.bases[:n], quality=b.quality[:n],
                         lengths=b.lengths[:n], ids=b.ids[:n],
                         numeric_ids=np.arange(n, dtype=np.int64))
    res1 = [MappedRead() for _ in range(mb1.size)]
    res2 = [MappedRead() for _ in range(mb2.size)]
    mb1.fill_objects(res1)
    mb2.fill_objects(res2)
    lines = emit_sam(aligner.genome, sub(b1), res1[:n], res2[:n], sub(b2))
    flags = set()
    for ln in lines:
        f = ln.split("\t")
        if len(f) < 11:
            raise AssertionError(f"SAM line with {len(f)} fields: {ln!r}")
        flags.add(int(f[1]))
    if not {99, 147} <= flags:
        raise AssertionError(f"flags 99/147 missing: {sorted(flags)[:20]}")
    return len(lines)


@contextlib.contextmanager
def gpu_util_sampler(samples: list):
    """Sample the card's utilization.gpu (the share of time a kernel was
    running) every 200 ms while the block runs; the samples land in
    ``samples`` and the sampler process is stopped on exit."""
    p = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        p.terminate()
        try:
            out = p.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        samples.extend(float(x) for x in out.split() if x.isdigit())


def write_fasta(path: str, name: str, bases) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for a in range(0, len(bases), 80):
            fh.write(bases[a:a + 80].tobytes().decode() + "\n")


def long_phase(device, genome_bases, n_reads: int = N_LONG,
               L_read: int = L_LONG, check: bool = True) -> dict:
    """bench_tools.bench_mappacbio's inputs, built the same way, through
    the port's ``mappacbio`` CLI: the genome as FASTA, ``randomreads
    pacbio=t pbmin=pbmax=L pberror=0.12 seed=19``, mapped with
    ``device=``, graded with ``gradesam.grade(out, 400)``. The wall time
    covers the CLI's index build and mapping; the CLI's own mapping time
    is read from its report."""
    import re

    import torch
    from bbmap_tpu.tools import gradesam, randomreads
    from bbmap_tpu_torch.ops import msa_kernels
    from bbmap_tpu_torch.tools import mappacbio

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pb")
    try:
        ref = os.path.join(tmp, "ref.fa")
        reads = os.path.join(tmp, "reads.fq")
        out = os.path.join(tmp, "mapped.sam")
        write_fasta(ref, "ecoli_like", genome_bases)
        if randomreads.main([
                f"ref={ref}", f"out={reads}", f"reads={n_reads}",
                "pacbio=t", f"pbmin={L_read}", f"pbmax={L_read}",
                "pberror=0.12", "seed=19"]) != 0:
            raise AssertionError("randomreads failed")
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        util = []
        sampler = gpu_util_sampler(util) if on_card \
            else contextlib.nullcontext()
        msa_kernels.reset_launches()
        t0 = time.time()
        try:
            with sampler, contextlib.redirect_stderr(log):
                rc = mappacbio.main([f"ref={ref}", f"in={reads}",
                                     f"out={out}", "nodisk",
                                     f"device={device}"])
                _sync(device)
        finally:
            for ln in log.getvalue().strip().splitlines()[-6:]:
                say(f"  mappacbio: {ln}")
        wall = time.time() - t0
        launches = launch_counts()
        if rc != 0:
            raise AssertionError(f"mappacbio exited {rc}")
        s = gradesam.grade(out, 400)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = max(1, s["primary"] - s["unparsed"])
    m = re.search(r"Time:\s*([0-9.]+) seconds", log.getvalue())
    if m is None:
        raise AssertionError("the CLI reported no mapping time")
    map_s = float(m.group(1))
    res = {"reads": n_reads, "read_len": L_read,
           "strict_correct": s["strict"] / n,
           "mapped_fraction": s["mapped"] / n,
           "wall_s": wall, "map_s": map_s,
           "reads_per_s": n_reads / map_s,
           "bases_per_s": n_reads * L_read / map_s,
           "launches": launches,
           "gpu_util_mean_pct": sum(util) / len(util) if util else None,
           "max_memory_allocated":
               torch.cuda.max_memory_allocated() if on_card else None}
    say("long reads: " + json.dumps(res))
    if check:
        if res["mapped_fraction"] < LONG_MAPPED_MIN or \
                res["strict_correct"] < LONG_STRICT_MIN:
            raise AssertionError(
                f"long-read accuracy below the bar (mapped >= "
                f"{LONG_MAPPED_MIN}, strict >= {LONG_STRICT_MIN})")
        if not (launches["msa_score_long"] and launches["msa_fill_long"]):
            raise AssertionError(f"the strided-row kernels never launched "
                                 f"on the long-read path: {launches}")
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "bbmap_tpu_torch").is_dir() or \
            not (ROOT / "bench.py").is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)

    t = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    say(f"device: {kind}")
    say(smi)
    say(f"phase device facts: {time.time() - t:.2f} s")

    from bbmap_tpu_torch.ops import _build
    t = time.time()
    _build.load("msa_dp")
    say(f"phase build: {time.time() - t:.2f} s "
        f"({_build.library_path('msa_dp').name})")

    import bench
    t = time.time()
    gbases = bench.make_genome()
    ktimes = kernel_phase(gbases, device)
    say(f"phase kernel vs plain: {time.time() - t:.1f} s")

    t = time.time()
    k1_launches = k1_entry(gbases, device)
    say(f"phase K1 entry point: {time.time() - t:.1f} s")

    t = time.time()
    made = make_csrc()
    res, first = main_path(device, genome_bases=gbases, make_report=made)
    say(f"phase main path: {time.time() - t:.1f} s; reads/s "
        f"{res['reads_per_s']:.1f} over {N_STEADY} steady batches of "
        f"{N_PAIRS} pairs; sensitivity {res['sensitivity']:.4f}, mapped "
        f"{res['mapped_fraction']:.4f}, pair rate {res['pair_rate']:.4f}; "
        f"launches {res['launches']}; quality offsets "
        f"{res['quality_offsets']} ({made}); card {smi}")

    t = time.time()
    n_lines = sam_phase(first)
    say(f"phase SAM: {n_lines} lines, {time.time() - t:.2f} s")

    t = time.time()
    lres = long_phase(device, gbases)
    say(f"phase long reads: {time.time() - t:.1f} s; {N_LONG} reads of "
        f"{L_LONG} bp: reads/s {lres['reads_per_s']:.3f}, bases/s "
        f"{lres['bases_per_s']:.1f} (mapping {lres['map_s']:.1f} s, wall "
        f"with index build {lres['wall_s']:.1f} s); mapped "
        f"{lres['mapped_fraction']:.4f}, strict "
        f"{lres['strict_correct']:.4f}; launches {lres['launches']}; "
        f"peak memory {lres['max_memory_allocated']} B; card {smi}")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    launches = {"msa_score_rows": k1_launches,
                "msa_score": res["launches"]["msa_score"],
                "msa_fill": res["launches"]["msa_fill"],
                "msa_score_long": lres["launches"]["msa_score_long"],
                "msa_fill_long": lres["launches"]["msa_fill_long"]}
    kernels = []
    for name, n in launches.items():
        kt = ktimes[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name.replace("_long", "")],
                        "launches": n, "max_abs_err": kt["max_abs_err"],
                        "ms": kt["ms"], "plain_ms": kt["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
