#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bbmap_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each timed on its own line:

1. device facts: the card's name and power limit;
2. build: nvcc builds ``bbmap_tpu_torch/csrc/msa_dp.cu`` into
   ``build/torch_kernels/`` (skipped when a library of the same source
   hash is there);
3. kernel vs plain: the DP score and fill kernels against their plain
   PyTorch versions on the card, bit-equal (tolerance 0: the DP is
   integer arithmetic), at the main path's shapes and at the wide window,
   for the short-read and PacBio profiles; kernel and plain times;
4. main path: the bench workload (4.6 Mbp genome with repeat families,
   k=13 index, 2x150 bp pairs with quality, 32,768 pairs a batch) through
   ``BBMapAligner.map_pairs_columnar`` (one warmup batch) and
   ``map_pairs_columnar_stream`` (3 steady batches), graded against the
   simulated origins; fails below sensitivity 0.997, mapped fraction
   0.999 or pair rate 0.997, or when either kernel was never launched;
5. SAM: ``emit_sam`` on the first 1,000 pairs.

Any failure raises and exits non-zero without the final ``ok`` line. It
exits 2 when no CUDA device is available or when it is not run from a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
L = 150
N_PAIRS = 32768
N_STEADY = 3
SENS_MIN, MAPPED_MIN, PAIR_MIN = 0.997, 0.999, 0.997
REPLACES = {"msa_score": "bbmap_tpu/ops/msa_pallas.py:577",
            "msa_fill": "bbmap_tpu/ops/msa_pallas.py:588"}
SOURCE = "bbmap_tpu_torch/csrc/msa_dp.cu"


def say(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def dp_jobs(genome, n: int, R: int, C: int, seed: int, device,
            var_rows: bool = True):
    """Bench-like DP jobs: reads sampled from the genome with 1-3
    substitutions or one 1-10 bp insertion/deletion, windows around the
    origin as the fused program cuts them (start - 4), and, when
    ``var_rows``, a quarter of the jobs with 1-8 fewer rows (the read
    padded with N)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    G = len(genome)
    starts = rng.integers(8, G - C - R - 32, n)
    reads = np.empty((n, R), np.uint8)
    refs = np.empty((n, C), np.uint8)
    for i, s in enumerate(starts):
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
        refs[i] = genome[s - 4:s - 4 + C]
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
    kernel {max_abs_err, ms, plain_ms}."""
    import torch
    from bbmap_tpu.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk

    err = {"msa_score": 0, "msa_fill": 0}

    def cmp_score(tag, P, n, R, C, seed):
        rd, rf, rw = dp_jobs(genome, n, R, C, seed, device)
        k = mk.msa_score(rd, rf, rw, P)
        p = mk.msa_score_plain(rd, rf, rw, P)
        _sync(device)
        e = int((k.long() - p.long()).abs().max())
        err["msa_score"] = max(err["msa_score"], e)
        say(f"kernel msa_score {tag}: {n} jobs (R, C) = ({R}, {C}) "
            f"max_abs_err {e}")
        if e != 0:
            raise AssertionError(f"msa_score disagrees with its plain "
                                 f"version ({tag})")

    def cmp_fill(tag, P, n, R, C, seed):
        rd, rf, rw = dp_jobs(genome, n, R, C, seed, device)
        k, kp = mk.msa_fill(rd, rf, rw, P)
        p, pp = mk.msa_fill_plain(rd, rf, rw, P)
        _sync(device)
        valid = valid_cells(rw, R, C)
        e = max(int((k.long() - p.long()).abs().max()),
                int(((kp.short() - pp.short()).abs() * valid).max()))
        err["msa_fill"] = max(err["msa_fill"], e)
        say(f"kernel msa_fill {tag}: {n} jobs (R, C) = ({R}, {C}) "
            f"max_abs_err {e} (out and prev codes on valid cells)")
        if e != 0:
            raise AssertionError(f"msa_fill disagrees with its plain "
                                 f"version ({tag})")

    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    cmp_score("short narrow", S, 4096, L, L + 24, 1)
    cmp_score("short wide", S, 512, L, L + 456, 2)
    cmp_score("pacbio", PB, 256, 300, 360, 3)
    cmp_fill("short narrow", S, 1024, L, L + 24, 4)
    cmp_fill("short wide", S, 64, L, L + 456, 5)
    cmp_fill("pacbio", PB, 256, 300, 360, 6)

    # times at the main path's shapes: 2E = 32,768 score jobs and
    # T = 8,192 fill jobs at (R, C) = (150, 174)
    out = {}
    rd, rf, rw = dp_jobs(genome, 2 * 16384, L, L + 24, 7, device,
                         var_rows=False)
    out["msa_score"] = {
        "ms": _cuda_ms(lambda: mk.msa_score(rd, rf, rw, S), 10),
        "plain_ms": _cuda_ms(lambda: mk.msa_score_plain(rd, rf, rw, S), 1)}
    rd, rf, rw = rd[:8192], rf[:8192], rw[:8192]
    out["msa_fill"] = {
        "ms": _cuda_ms(lambda: mk.msa_fill(rd, rf, rw, S), 10),
        "plain_ms": _cuda_ms(lambda: mk.msa_fill_plain(rd, rf, rw, S), 1)}
    for name, t in out.items():
        t["max_abs_err"] = err[name]
        say(f"time {name} at the main-path shape: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms")
    return out


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


def main_path(device, n_pairs: int = N_PAIRS, n_steady: int = N_STEADY,
              genome_bases=None, check: bool = True):
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
    launches = {k.__name__: k.launches for k in msa_kernels.KERNELS}
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
        if not all(v > 0 for v in launches.values()):
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

    from bbmap_tpu_torch.ops import _build, msa_kernels
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
    res, first = main_path(device, genome_bases=gbases)
    say(f"phase main path: {time.time() - t:.1f} s; reads/s "
        f"{res['reads_per_s']:.1f} over {N_STEADY} steady batches of "
        f"{N_PAIRS} pairs; sensitivity {res['sensitivity']:.4f}, mapped "
        f"{res['mapped_fraction']:.4f}, pair rate {res['pair_rate']:.4f}; "
        f"launches {res['launches']}; card {smi}")

    t = time.time()
    n_lines = sam_phase(first)
    say(f"phase SAM: {n_lines} lines, {time.time() - t:.2f} s")

    kernels = []
    for k in msa_kernels.KERNELS:
        name = k.__name__
        kt = ktimes[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": res["launches"][name],
                        "max_abs_err": kt["max_abs_err"], "ms": kt["ms"],
                        "plain_ms": kt["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
