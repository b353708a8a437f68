#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bbmap_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each timed on its own line:

1. device facts: the card's name and power limit;
2. build: one nvcc for each source in ``bbmap_tpu_torch/csrc/``
   (``msa_dp.cu``, ``msa_dp_warp.cu``, ``msa_dp_band.cu``,
   ``msa_walk.cu``), all started together, into ``build/torch_kernels/``
   (a source whose library is there is skipped); ``cuobjdump -sass`` of the libraries gives each
   kernel's instructions a cell (the main loop's length over the cells
   one pass of it evaluates), and the least of them among a function's
   mappings is the count that function's bound is reckoned with;
3. kernel vs plain: every kernel against its plain PyTorch version on
   the card, bit-equal (tolerance 0: the DP and the walk are integer
   arithmetic): K2 score and K3 fill at the short path's shapes
   (150, 174), (150, 606) and PACBIO (300, 360) in the warp-a-job
   mapping and in the one-row mapping; past 1,023 rows the band mapping
   at 2, 4 and 8 rows a lane and the strided mapping it replaced, at
   (1,024, 1,100) with one job, (1,100, 1,200) with 100 jobs (last band
   and last lane partly empty; K1's operands too), (2,500, 2,600) SHORT
   profile, the long-read shapes (6,000, 6,024) and (6,000, 6,456) and
   (8,191, 8,192), per-job rows below R among them; K1 on its own
   operands at (150, 174) in both mappings; and the walk kernel at 8,192
   x (150, 174) bounded to 190 steps, at (150, 606) full length, and at
   (6,000, 6,456) over the row-major and over the wave-major block, on
   the last 16 jobs of 64-job fills whose prev codes pass 2**31 bytes in
   either layout, from the fill's own columns and states and from
   shifted ones, so that cut walks are among them; kernel, plain and
   other-mapping times at the shapes the paths use, each kernel's bound,
   K2 in the warp and the one-row mapping from 128 to 8,192 jobs (the
   sweep that ``msa_kernels.WARP_MIN_JOBS`` is chosen from), the band
   mapping over rows a lane and the job count beside the strided mapping
   (``BAND_MIN_WARPS``) and beside the one-row mapping between 320 and
   1,023 rows (``BAND_MID_MIN_ROWS`` / ``BAND_MID_MIN_JOBS``);
4. K1 entry point: ``msa_kernels.score_batch`` on 32,768 jobs, counted;
5. main path: the bench workload (4.6 Mbp genome with repeat families,
   k=13 index, 2x150 bp pairs with quality, 32,768 pairs a batch) through ``BBMapAligner.map_pairs_columnar`` (one warmup
   batch) and ``map_pairs_columnar_stream`` (3 steady batches), graded
   against the simulated origins; fails below sensitivity 0.997, mapped
   fraction 0.999 or pair rate 0.997, or when K2, K3 or the walk kernel
   was never launched; the quality offsets are computed on the card;
6. SAM: ``emit_sam`` on the first 1,000 pairs;
7. long reads: 400 PacBio-model reads of 6 kbp at 12 % error on the same
   genome (``randomreads pacbio=t``) through the port's ``mappacbio``
   CLI on the card, graded by gradesam (strict = within 400 bp); fails
   below mapped 0.98 or strict 0.65, when the band K2 or K3 or the walk
   kernel was never launched, or when a strided kernel was; the fill
   chunk the card's memory allows is printed beside the launches.

Each path's launch counts are set to 0 just before it and read just
after. Any failure raises and exits non-zero without the final ``ok``
line. It exits 2 when no CUDA device is available or when it is not run
from a checkout of the repository.

``python3 chip_smoke.py --profile`` runs no check: it prints where the
time goes (one short-read batch under torch.profiler, 32 long reads under
cProfile and under torch.profiler) and no ``ok`` line.
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
_K1, _K2, _K3 = ("bbmap_tpu/ops/msa_pallas.py:243",
                 "bbmap_tpu/ops/msa_pallas.py:577",
                 "bbmap_tpu/ops/msa_pallas.py:588")
REPLACES = {"msa_score_rows": _K1, "msa_score": _K2, "msa_score_row": _K2,
            "msa_score_long": _K2, "msa_score_strided": _K2,
            "msa_fill": _K3, "msa_fill_long": _K3, "msa_fill_strided": _K3,
            "msa_walk": "bbmap_tpu/ops/msa_jax.py:451"}
CSRC = "bbmap_tpu_torch/csrc/"
SOURCE = {"msa_score_rows": CSRC + "msa_dp_warp.cu",
          "msa_score": CSRC + "msa_dp_warp.cu",
          "msa_score_row": CSRC + "msa_dp.cu",
          "msa_fill": CSRC + "msa_dp.cu",
          "msa_score_long": CSRC + "msa_dp_band.cu",
          "msa_fill_long": CSRC + "msa_dp_band.cu",
          "msa_score_strided": CSRC + "msa_dp.cu",
          "msa_fill_strided": CSRC + "msa_dp.cu",
          "msa_walk": CSRC + "msa_walk.cu"}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# Each of an SM's four schedulers starts one warp instruction (32 lanes) a
# clock. The kernels' integer work spreads over the ALU and the FMA pipes
# (IMAD, moves), so the schedulers' rate, and not the 64 int32 ALU lanes an
# SM, is the rate no instruction mix can pass.
SCHEDULER_LANES_PER_SM = 128
# kernel variant -> its name in the ``kernels`` line, by wrapper and mapping
VARIANT = {("msa_score", "warp"): "msa_score",
           ("msa_score", "row"): "msa_score_row",
           ("msa_score", "band"): "msa_score_long",
           ("msa_score", "strided"): "msa_score_strided",
           ("msa_fill", "warp"): "msa_fill_warp",
           ("msa_fill", "row"): "msa_fill",
           ("msa_fill", "band"): "msa_fill_long",
           ("msa_fill", "strided"): "msa_fill_strided",
           ("msa_score_rows", "warp"): "msa_score_rows",
           ("msa_score_rows", "row"): "msa_score_rows_row",
           ("msa_score_rows", "band"): "msa_score_rows_long"}
# the long-read escalation window, and the job counts its kernels are
# timed at: the ``kernels`` line's (the 16-job fill every earlier run
# timed) first
LONG_C = L_LONG + 456
LONG_SCORE_JOBS = 256
LONG_FILL_JOBS = (16, 64, 128, 256, 400)
LONG_SWEEP_JOBS = (1, 16, 64, 100, 128, 200, 256, 400)
PAST_32_BITS = 2 ** 31          # bytes a 64-job block of prev codes passes
# kernel variant -> the function it computes; every variant of a function
# is held to one bound
FUNCTION = {v: w for (w, _), v in VARIANT.items()}
FUNCTION["msa_walk"] = "msa_walk"


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


def prev_code_err(k, p, rows, R: int, C: int) -> int:
    """Largest difference between two fills' prev codes, each a (block,
    layout) pair, over the cells where they are defined: 1 <= r <=
    rows[b], 1 <= c <= C, read through each block's stride map."""
    import torch
    from bbmap_tpu_torch.ops import msa
    valid = torch.arange(1, R + 1, device=rows.device).view(1, -1, 1) \
        <= rows.view(-1, 1, 1)
    worst = 0
    for a in range(0, len(rows), 16):     # bounded scratch for long jobs
        kc, pc = (msa.cell_view(b[a:a + 16], R, C, lay) for b, lay in (k, p))
        worst = max(worst, int(((kc.short() - pc.short()).abs()
                                * valid[a:a + 16]).max()))
    return worst


@contextlib.contextmanager
def band_rows_a_lane(J: int, jobs: int, R: int):
    """Make ``launch_shape`` give the band mapping J rows a lane for this
    job count (for the comparisons and sweeps over J): the warp threshold
    is set to what J yields, and a fill may take 8 rows a lane."""
    from bbmap_tpu_torch.ops import msa_kernels as mk
    old = mk.BAND_MIN_WARPS, mk.BAND_FILL_MAX_ROWS_PER_LANE
    mk.BAND_MIN_WARPS = jobs * mk.band_count(R, J)
    mk.BAND_FILL_MAX_ROWS_PER_LANE = max(mk.BAND_ROWS_PER_LANE)
    try:
        for fill in (False, True):
            got = mk.launch_shape(R, 1, "band", jobs, fill).rows_per_thread
            if got != J and mk.band_count(R, got) != mk.band_count(R, J):
                raise AssertionError(f"{got} rows a lane, wanted {J}")
        yield
    finally:
        mk.BAND_MIN_WARPS, mk.BAND_FILL_MAX_ROWS_PER_LANE = old


def sass_counts(lib_path) -> dict:
    """``cuobjdump -sass`` of a built library: {mangled kernel name:
    (instructions, instructions of its main loop)}. The main loop is the
    backward branch that spans the most instructions."""
    import re
    from bbmap_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        addrs, branches = [], []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk):
            addr, ins = int(m.group(1), 16), m.group(2)
            addrs.append(addr)
            t = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if t and int(t.group(1), 16) < addr:
                branches.append((int(t.group(1), 16), addr))
        loop = max((sum(lo <= x <= hi for x in addrs)
                    for lo, hi in branches), default=len(addrs))
        out[name] = (len(addrs), loop)
    return out


def kernel_instructions() -> dict:
    """Instructions a DP cell (or a walk step) for each kernel variant
    the paths launch, from the built libraries' SASS: the main loop's
    instructions over the cells one pass of it evaluates ("per_cell"),
    and the least of them among the variants of the same function
    ("function_per_cell"): what one mapping does a cell in, no mapping
    needs more for. Keys: the variant names of ``VARIANT`` and
    "msa_walk"."""
    from bbmap_tpu_torch.ops import _build
    from bbmap_tpu_torch.ops import msa_kernels as mk

    def pick(counts, *parts):
        hits = [v for k, v in counts.items() if all(p in k for p in parts)]
        if len(hits) != 1:
            raise AssertionError(f"{len(hits)} kernels match {parts}")
        return hits[0]

    dp = sass_counts(_build.library_path("msa_dp"))
    warp = sass_counts(_build.library_path("msa_dp_warp"))
    band = sass_counts(_build.library_path("msa_dp_band"))
    walk = sass_counts(_build.library_path("msa_walk"))
    Jw = mk.launch_shape(L, L + 24, "warp").rows_per_thread
    Jl = mk.launch_shape(L_LONG, LONG_C, "strided").rows_per_thread
    # rows a lane of the band launches the ``kernels`` line times
    Jb = {"msa_score": mk.launch_shape(L_LONG, LONG_C, None,
                                       LONG_SCORE_JOBS).rows_per_thread,
          "msa_fill": mk.launch_shape(L_LONG, LONG_C, None, LONG_FILL_JOBS[0],
                                      True).rows_per_thread}
    out = {}
    for name, ops, prevs in (("msa_score", "RawOps", "Lb0"),
                             ("msa_fill", "RawOps", "Lb1"),
                             ("msa_score_rows", "RowOps", "Lb0")):
        tot, loop = pick(warp, "msa_dp_warp_kernel", ops, prevs, f"Li{Jw}E")
        out[VARIANT[name, "warp"]] = {"sass": tot, "loop": loop,
                                      "per_cell": loop / Jw}
        tot, loop = pick(dp, "msa_dp_kernel", ops, prevs)
        out[VARIANT[name, "row"]] = {"sass": tot, "loop": loop,
                                     "per_cell": loop}
        if ops == "RawOps":
            tot, loop = pick(dp, "msa_dp_long_kernel", ops, prevs,
                             f"Li{Jl}E")
            out[VARIANT[name, "strided"]] = {"sass": tot, "loop": loop,
                                             "per_cell": loop / Jl}
            for J in mk.BAND_ROWS_PER_LANE:
                tot, loop = pick(band, "msa_dp_band_kernel", ops, prevs,
                                 f"Li{J}E")
                key = VARIANT[name, "band"] + ("" if J == Jb[name]
                                               else f"/{J}")
                out[key] = {"sass": tot, "loop": loop, "per_cell": loop / J}
                FUNCTION[key] = name
    tot, loop = pick(walk, "msa_walk_kernel")
    out["msa_walk"] = {"sass": tot, "loop": loop, "per_cell": loop}
    for name, v in out.items():
        v["function_per_cell"] = min(w["per_cell"] for n, w in out.items()
                                     if FUNCTION[n] == FUNCTION[name])
        say(f"sass {name}: {v['sass']} instructions, main loop {v['loop']}, "
            f"{v['per_cell']:.1f} a cell; {FUNCTION[name]} needs at most "
            f"{v['function_per_cell']:.1f}")
    return out


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def bound_ms(n_bytes: float, n_instructions: float, clock_hz: float):
    """The least time the card could take: the larger of bytes over the
    device memory rate and instructions over the schedulers' rate, SMs
    x 4 schedulers x 32 lanes x the SM clock. Returns (ms, "bytes" or
    "operations")."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_instructions / (sms * SCHEDULER_LANES_PER_SM * clock_hz)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(genome, device) -> dict:
    """Kernels against their plain versions on the card; returns per
    kernel variant {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms and, where another mapping was timed beside the default,
    row_ms / warp_ms / strided_ms}: "msa_score_rows" (K1), "msa_score" /
    "msa_fill" (a warp a job / a row a thread), "msa_score_long" /
    "msa_fill_long" (a warp a band of rows), "msa_score_strided" /
    "msa_fill_strided" (rows strided over the block) and "msa_walk"."""
    import torch
    from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa
    from bbmap_tpu_torch.ops import msa_kernels as mk

    err = {}
    instr = kernel_instructions()
    clock = max_sm_clock_hz()
    say(f"card clocks.max.sm {clock / 1e6:.0f} MHz")

    def record(key, tag, n, R, C, e, what=""):
        err[key] = max(err.get(key, 0), e)
        say(f"kernel {key} {tag}: {n} jobs (R, C) = ({R}, {C}) "
            f"max_abs_err {e}{what}")
        if e != 0:
            raise AssertionError(f"{key} disagrees with its plain version "
                                 f"({tag})")

    def key_of(name, n, R, C, mapping):
        shape = mk.launch_shape(R, C, mapping, jobs=n,
                                fill=name == "msa_fill")
        return VARIANT[name, shape.mapping]

    def jobs(n, R, C, seed, pb_err=0.0):
        return dp_jobs(genome, n, R, C, seed, device, pb_err=pb_err)

    def cmp_score(tag, P, job, k=None, p=None, mapping=None):
        rd, rf, rw = job
        k = mk.msa_score(rd, rf, rw, P, mapping) if k is None else k
        p = mk.msa_score_plain(rd, rf, rw, P) if p is None else p
        _sync(device)
        R, C = rd.shape[1], rf.shape[1]
        record(key_of("msa_score", len(rw), R, C, mapping), tag, len(rw), R,
               C, int((k.long() - p.long()).abs().max()))
        return p

    def cmp_fill(tag, P, job, k=None, p=None, mapping=None):
        """A fill (out, prev codes, layout) against the plain version's,
        on out and, through each block's stride map, on every valid prev
        code. Returns the plain version's."""
        rd, rf, rw = job
        k = mk.msa_fill(rd, rf, rw, P, mapping) if k is None else k
        p = mk.msa_fill_plain(rd, rf, rw, P) if p is None else p
        _sync(device)
        R, C = rd.shape[1], rf.shape[1]
        e = max(int((k[0].long() - p[0].long()).abs().max()),
                prev_code_err(k[1:], p[1:], rw, R, C))
        record(key_of("msa_fill", len(rw), R, C, mapping), tag, len(rw), R,
               C, e, f" (out and prev codes on valid cells, "
               f"{'row' if k[2] == msa.row_major(R, C) else 'wave'}-major)")
        return p

    def cmp_rows(tag, job, k=None, p=None, mapping=None):
        rd, rf, rw = job
        R, C = rd.shape[1], rf.shape[1]
        if k is None or p is None:
            r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
            k = mk.msa_score_rows(r1, r0, (rp, rows), R, C, 64, mapping)
            p = mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 64)
        _sync(device)
        record(key_of("msa_score_rows", len(rw), R, C, mapping), tag,
               len(rw), R, C, int((k.long() - p.long()).abs().max()))

    def cmp_walk(tag, job, prevs, col0, st0, steps, layout=None, tail=0):
        """The walk kernel against its plain version on one fill's prev
        codes (a block in ``layout``, default wave-major), from the given
        columns and states; with ``tail`` the plain version walks the
        last ``tail`` jobs only. Returns the number of walks that were
        cut."""
        rd, rf, _ = job
        R, C = rd.shape[1], rf.shape[1]
        k = mk.msa_walk(prevs, rd, rf, col0, st0, R, C, steps, layout)
        p = mk.msa_walk_plain(*(x[-tail:] for x in (prevs, rd, rf, col0,
                                                   st0)), R, C, steps, layout)
        _sync(device)
        e = max(int((a[-tail:].long() - b.long()).abs().max())
                for a, b in zip(k, p))
        cut = int((k[3] > 0).sum())
        lay = "row" if layout == msa.row_major(R, C) else "wave"
        record("msa_walk", tag, len(p[1]), R, C, e,
               f" (symbols, out_len, gaps, row_end; steps {steps or R + C},"
               f" {cut} walks cut, {lay}-major block of {len(col0)} jobs)")
        return cut

    def walk_starts(out, C, seed):
        """The fill's own last-row columns and states, and a shifted set:
        random columns in 1..C and random states."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        n = out.shape[1]
        col = torch.randint(1, C + 1, (n,), generator=g, dtype=torch.int32)
        st = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
        return ((out[1], out[2]), (col.to(out.device), st.to(out.device)))

    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    for mapping in ("warp", "row"):
        cmp_score("short narrow", S, jobs(4096, L, L + 24, 1),
                  mapping=mapping)
        cmp_score("short wide", S, jobs(512, L, L + 456, 2), mapping=mapping)
        cmp_score("pacbio", PB, jobs(256, 300, 360, 3), mapping=mapping)
        cmp_fill("short narrow", S, jobs(1024, L, L + 24, 4),
                 mapping=mapping)
        cmp_fill("pacbio", PB, jobs(256, 300, 360, 6), mapping=mapping)
        cmp_rows("short narrow", jobs(4096, L, L + 24, 12), mapping=mapping)
    # the walk over a wide fill, full length, N and gap columns included
    job = rd, rf, rw = jobs(64, L, L + 456, 5)
    rf[::7, 200] = ord("-")
    rf[::5, 90] = ord("N")
    cmp_fill("short wide, gap columns", S, job, mapping="warp")
    k = mk.msa_fill(rd, rf, rw, S)
    pp = cmp_fill("short wide, gap columns", S, job, k)[1]
    for col0, st0 in walk_starts(k[0], L + 456, 31):
        cmp_walk("short wide, full length", job, pp, col0, st0, 0)
    del k, pp

    def cmp_long(tag, P, job, Js=mk.BAND_ROWS_PER_LANE):
        """Past 1,023 rows: the band mapping at each rows a lane and the
        strided mapping, score and fill, against one plain fill (whose
        out is the score pass's). Returns the plain fill."""
        rd, rf, rw = job
        p = mk.msa_fill_plain(rd, rf, rw, P)
        for J in Js:
            with band_rows_a_lane(J, len(rw), rd.shape[1]):
                cmp_score(f"{tag}, {J} rows a lane", P, job, p=p[0],
                          mapping="band")
                cmp_fill(f"{tag}, {J} rows a lane", P, job, p=p,
                         mapping="band")
        cmp_score(tag, P, job, p=p[0], mapping="strided")
        cmp_fill(tag, P, job, p=p, mapping="strided")
        return p

    # the band mapping at the edges of its design: one job just past
    # 1,023 rows; 100 jobs whose last band and last lane are partly empty
    # (1,101 rows) and K1's operands on the same jobs; SHORT profile with
    # N and gap columns; the long-read narrow window; the largest R. The
    # long-read escalation window is compared on its timing runs below.
    cmp_long("pacbio past 1,023 rows", PB, jobs(1, 1024, 1100, 13, 0.12))
    job = jobs(100, 1100, 1200, 14, 0.12)
    cmp_long("pacbio, ragged last band", PB, job)
    cmp_rows("ragged last band", tuple(x[:64] for x in job))
    job = rd, rf, rw = jobs(16, 2500, 2600, 15, 0.1)
    rf[::3, 1300] = ord("-")
    rf[::5, 700] = ord("N")
    cmp_long("short profile, gap columns", S, job)
    cmp_long("pacbio long read, narrow window", PB,
             jobs(3, L_LONG, L_LONG + 24, 16, 0.12), Js=(2, 4))
    cmp_long("pacbio largest R", PB, jobs(2, 8191, 8192, 17, 0.12),
             Js=(4, 8))

    # times at the paths' shapes: the short path's 2E = 32,768 score
    # jobs and T = 8,192 fill jobs at (R, C) = (150, 174) with the walk
    # bounded to 190 steps, K1 at its entry point's 32,768 jobs, and the
    # long-read wide escalation window (6,000, 6,456): 256 score jobs
    # and 16 to 400 fill jobs and their walks, in the band and in the
    # strided mapping, whose results are compared with the plain
    # version's as well. The wide pass (128 score and 64 fill jobs at
    # (150, 606)) and PACBIO (300, 360) are timed in both mappings.
    out = {}

    def timed(name, kern, plain, reps, plain_warm=True, other=None):
        """Time a kernel and its plain version; ``other`` = (key, fn)
        times the other mapping beside it."""
        ms, k = _cuda_ms(kern, reps)
        plain_ms, p = _cuda_ms(plain, 1, warm=plain_warm)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None}
        if other is not None:
            out[name][other[0]] = _cuda_ms(other[1], reps)[0]
        return k, p

    def dp_bound(name, job, fill, keep=True):
        """Bytes: reads, windows and rows in, out (3, B) and, for the
        fill, one byte a valid cell out. Instructions: the (rows + 1) x
        (C + 1) in-window cells of each job's own rows times the
        function's instructions a cell (the least among its mappings,
        not this kernel's own). With ``keep`` stored beside ``name``'s
        times; returns (ms, "bytes" or "operations")."""
        rd, rf, rw = job
        C = rf.shape[1]
        rows = rw.double()
        n_bytes = rd.numel() + rf.numel() + 4 * rw.numel() + 12 * len(rw)
        if name == "msa_score_rows":        # K1 reads int32 operands
            R = rd.shape[1]
            n_bytes = 4 * len(rw) * (2 * (R + 1) + C + 2 * R + 2 + 1 + 3)
        if fill:
            n_bytes += float((rows * C).sum())
        cells = float(((rows + 1) * (C + 1)).sum())
        ms, by = bound_ms(n_bytes, cells * instr[name]["function_per_cell"],
                          clock)
        if keep:
            out[name].update(bound_ms=ms, bound_by=by, cells=cells)
        return ms, by

    def walk_bound(walked, n_jobs, steps):
        """Bytes: three bytes a step walked (prev code, read and window
        character), the (B, steps) symbols out and 20 bytes a job of
        columns, states and results. Instructions: the steps walked
        times the kernel's instructions a step (one lane of a warp
        walks)."""
        n_bytes = 3 * walked + n_jobs * steps + 20 * n_jobs
        return bound_ms(
            n_bytes, walked * instr["msa_walk"]["function_per_cell"], clock)

    job = rd, rf, rw = dp_jobs(genome, 2 * 16384, L, L + 24, 7, device,
                               var_rows=False)
    k, p = timed("msa_score", lambda: mk.msa_score(rd, rf, rw, S),
                 lambda: mk.msa_score_plain(rd, rf, rw, S), 10,
                 other=("row_ms", lambda: mk.msa_score(rd, rf, rw, S,
                                                       "row")))
    dp_bound("msa_score", job, False)
    cmp_score("short narrow, 32,768 jobs", S, job, k, p)
    r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
    R, C = rd.shape[1], rf.shape[1]
    k, p = timed(
        "msa_score_rows",
        lambda: mk.msa_score_rows(r1, r0, (rp, rows), R, C, 64),
        lambda: mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 64), 10,
        other=("row_ms", lambda: mk.msa_score_rows(r1, r0, (rp, rows), R, C,
                                                   64, "row")))
    dp_bound("msa_score_rows", job, False)
    cmp_rows("short narrow, 32,768 jobs", job, k, p)
    del k, p, r1, r0, rp, rows
    # K2 in both mappings over the job count, at the narrow and the wide
    # window: where the warp mapping starts to win is WARP_MIN_JOBS
    for Cs in (L + 24, L + 456):
        for n in (128, 256, 512, 1024, 2048, 4096, 8192):
            a = (rd[:n], rf[:n], rw[:n]) if Cs == L + 24 \
                else dp_jobs(genome, n, L, Cs, 40, device, var_rows=False)
            w, r = (_cuda_ms(lambda: mk.msa_score(*a, S, m), 10)[0]
                    for m in ("warp", "row"))
            say(f"sweep msa_score {n} x ({L}, {Cs}): warp {w:.4f} ms, "
                f"one-row {r:.4f} ms, default "
                f"{mk.launch_shape(L, Cs, jobs=n).mapping}")
    job = rd, rf, rw = rd[:8192], rf[:8192], rw[:8192]
    k, p = timed("msa_fill", lambda: mk.msa_fill(rd, rf, rw, S),
                 lambda: mk.msa_fill_plain(rd, rf, rw, S), 10,
                 other=("warp_ms", lambda: mk.msa_fill(rd, rf, rw, S,
                                                       "warp")))
    dp_bound("msa_fill", job, True)
    cmp_fill("short narrow, 8,192 jobs", S, job, k, p)
    cmp_fill("short narrow, 8,192 jobs", S, job, p=p, mapping="warp")
    steps = L + 24 + 16
    (col0, st0), shifted = walk_starts(k[0], L + 24, 32)
    kw, pw = timed("msa_walk",
                  lambda: mk.msa_walk(k[1], rd, rf, col0, st0, L, L + 24,
                                      steps),
                  lambda: mk.msa_walk_plain(k[1], rd, rf, col0, st0, L,
                                            L + 24, steps), 10)
    ms_b, by = walk_bound(float(kw[1].sum()), len(rw), steps)
    out["msa_walk"].update(bound_ms=ms_b, bound_by=by)
    record("msa_walk", "short narrow, bounded, the kernel's prev codes",
           len(rw), L, L + 24,
           max(int((a.long() - b.long()).abs().max())
               for a, b in zip(kw, pw)))
    cmp_walk("short narrow, bounded", job, p[1], col0, st0, steps)
    cmp_walk("short narrow, bounded, shifted starts", job, p[1], *shifted,
             steps)
    if cmp_walk("short narrow, cut at 120 steps", job, p[1], col0, st0,
                120) == 0:
        raise AssertionError("no walk was cut at 120 steps")
    del k, p, kw, pw

    # the wide pass as the main path runs it (one-row mapping at 128
    # jobs), and the small shapes in both mappings
    job = rd, rf, rw = jobs(128, L, L + 456, 23)
    k, p = timed("msa_score_row", lambda: mk.msa_score(rd, rf, rw, S),
                 lambda: mk.msa_score_plain(rd, rf, rw, S), 10,
                 other=("warp_ms", lambda: mk.msa_score(rd, rf, rw, S,
                                                        "warp")))
    dp_bound("msa_score_row", job, False)
    cmp_score("short wide, 128 jobs", S, job, k, p)
    extra = {}
    for tag, P, n, R, C, seed, fn in (
            ("msa_fill wide retrace", S, 64, L, L + 456, 25, mk.msa_fill),
            ("msa_score pacbio", PB, 256, 300, 360, 24, mk.msa_score),
            ("msa_fill pacbio", PB, 256, 300, 360, 24, mk.msa_fill)):
        a = jobs(n, R, C, seed)
        extra[tag] = (n, R, C, _cuda_ms(lambda: fn(*a, P, "warp"), 10)[0],
                      _cuda_ms(lambda: fn(*a, P, "row"), 10)[0])

    def strided_beside(name):
        """The strided kernel's entry: the band entry's shape, plain time
        and bound, with its own time."""
        t = dict(out[name], ms=out[name]["strided_ms"])
        del t["strided_ms"]
        out[name.replace("_long", "_strided")] = t

    def over_rows_a_lane(fn, job):
        """ms of one band launch at each rows a lane."""
        times = []
        for J in mk.BAND_ROWS_PER_LANE:
            with band_rows_a_lane(J, len(job[2]), L_LONG):
                # [0]: a fill's prev codes are freed as soon as it returns
                times.append(_cuda_ms(lambda: fn(*job, PB, "band")[0], 2)[0])
        return ", ".join(f"{J} rows a lane {t:.3f} ms" for J, t in
                         zip(mk.BAND_ROWS_PER_LANE, times))

    Cl = LONG_C
    most = jobs(max(LONG_SWEEP_JOBS), L_LONG, Cl, 19, 0.12)
    job = rd, rf, rw = tuple(x[:LONG_SCORE_JOBS] for x in most)
    k, p = timed("msa_score_long", lambda: mk.msa_score(rd, rf, rw, PB),
                 lambda: mk.msa_score_plain(rd, rf, rw, PB), 2, False,
                 other=("strided_ms",
                        lambda: mk.msa_score(rd, rf, rw, PB, "strided")))
    dp_bound("msa_score_long", job, False)
    strided_beside("msa_score_long")
    cmp_score("pacbio long read", PB, job, k, p)
    cmp_score("pacbio long read", PB, job, p=p, mapping="strided")
    for n in LONG_SWEEP_JOBS:
        sub = tuple(x[:n] for x in most)
        say(f"sweep msa_score band {n} x ({L_LONG}, {Cl}): "
            f"{over_rows_a_lane(mk.msa_score, sub)}; strided "
            f"{_cuda_ms(lambda: mk.msa_score(*sub, PB, 'strided'), 2)[0]:.3f}"
            f" ms; default "
            f"{mk.launch_shape(L_LONG, Cl, jobs=n).rows_per_thread}")
    del k, p, most
    # fills: the 16 jobs every earlier run timed are held against the
    # plain version, alone and as the last 16 of 64 to 400 jobs. The
    # 64-job blocks pass 2**31 bytes in either layout (64 x 38.8 MB
    # row-major, 64 x 74.7 MB wave-major), so their last jobs check the
    # kernels' 64-bit offsets.
    n16 = LONG_FILL_JOBS[0]
    job = rd, rf, rw = jobs(n16, L_LONG, Cl, 20, 0.12)
    k, p = timed("msa_fill_long", lambda: mk.msa_fill(rd, rf, rw, PB),
                 lambda: mk.msa_fill_plain(rd, rf, rw, PB), 2, False,
                 other=("strided_ms",
                        lambda: mk.msa_fill(rd, rf, rw, PB, "strided")))
    dp_bound("msa_fill_long", job, True)
    strided_beside("msa_fill_long")
    cmp_fill("pacbio long read", PB, job, k, p)
    cmp_fill("pacbio long read", PB, job, p=p, mapping="strided")
    (col0, st0), shifted = walk_starts(k[0], Cl, 33)
    ms_l, kw = _cuda_ms(lambda: mk.msa_walk(k[1], rd, rf, col0, st0, L_LONG,
                                            Cl, 0, k[2]), 2)
    ms_b, by = walk_bound(float(kw[1].sum()), len(rw), L_LONG + Cl)
    extra["msa_walk long"] = (len(rw), L_LONG, Cl, ms_l, ms_b)
    pw = mk.msa_walk_plain(p[1], rd, rf, col0, st0, L_LONG, Cl)
    _sync(device)
    record("msa_walk", "pacbio long read, full length, the band fill's "
           "row-major block against the plain fill's wave-major block",
           n16, L_LONG, Cl, max(int((a.long() - b.long()).abs().max())
                                for a, b in zip(kw, pw)))
    del kw, pw
    cmp_walk("pacbio long read, full length, shifted starts", job, k[1],
             *shifted, 0, k[2])
    if cmp_walk(f"pacbio long read, cut at {L_LONG + 50} steps", job, k[1],
                col0, st0, L_LONG + 50, k[2]) == 0:
        raise AssertionError("no long walk was cut")
    say(f"sweep msa_fill band {n16} x ({L_LONG}, {Cl}): "
        f"{over_rows_a_lane(mk.msa_fill, job)}; strided "
        f"{out['msa_fill_long']['strided_ms']:.3f} ms; default "
        f"{mk.launch_shape(L_LONG, Cl, None, n16, True).rows_per_thread}")
    del k
    one = jobs(1, L_LONG, Cl, 18, 0.12)
    say(f"sweep msa_fill band 1 x ({L_LONG}, {Cl}): "
        f"{over_rows_a_lane(mk.msa_fill, one)}; strided "
        f"{_cuda_ms(lambda: mk.msa_fill(*one, PB, 'strided'), 2)[0]:.3f} ms")
    for n in LONG_FILL_JOBS[1:]:
        more = jobs(n - n16, L_LONG, Cl, 22 + n, 0.12)
        big = brd, brf, brw = tuple(torch.cat([a, b])
                                    for a, b in zip(more, job))
        del more
        ms, kb = _cuda_ms(lambda: mk.msa_fill(brd, brf, brw, PB), 2)
        e = max(int((kb[0][:, -n16:].long() - p[0].long()).abs().max()),
                prev_code_err((kb[1][-n16:], kb[2]), p[1:], rw, L_LONG, Cl))
        record("msa_fill_long", f"pacbio long read, last {n16} of {n} jobs "
               f"({kb[1].numel()} bytes of prev codes)", n16, L_LONG, Cl, e)
        if n == LONG_FILL_JOBS[1]:
            if kb[1].numel() <= PAST_32_BITS:
                raise AssertionError("the block does not pass 2**31 bytes")
            cmp_walk(f"pacbio long read, last {n16} of {n} jobs (prev codes "
                     f"past 2**31 bytes)", big, kb[1], kb[0][1], kb[0][2], 0,
                     kb[2], tail=n16)
        bound, _ = dp_bound("msa_fill_long", big, True, keep=False)
        say(f"sweep msa_fill band {n} x ({L_LONG}, {Cl}): "
            f"{over_rows_a_lane(mk.msa_fill, big)}; default "
            f"{mk.launch_shape(L_LONG, Cl, None, n, True).rows_per_thread}")
        del kb
        ms_s = _cuda_ms(lambda: mk.msa_fill(brd, brf, brw, PB,
                                            "strided")[0], 2)[0]
        if n == LONG_FILL_JOBS[1]:
            ks = mk.msa_fill(brd, brf, brw, PB, "strided")
            if ks[1].numel() <= PAST_32_BITS:
                raise AssertionError("the block does not pass 2**31 bytes")
            e = max(int((ks[0][:, -n16:].long() - p[0].long()).abs().max()),
                    prev_code_err((ks[1][-n16:], ks[2]), p[1:], rw, L_LONG,
                                  Cl))
            record("msa_fill_strided", f"pacbio long read, last {n16} of "
                   f"{n} jobs ({ks[1].numel()} bytes of prev codes)", n16,
                   L_LONG, Cl, e)
            cmp_walk(f"pacbio long read, last {n16} of {n} jobs (prev codes "
                     f"past 2**31 bytes)", big, ks[1], ks[0][1], ks[0][2], 0,
                     ks[2], tail=n16)
            del ks
        del big, brd, brf, brw
        torch.cuda.empty_cache()
        say(f"time msa_fill_long at {n} x ({L_LONG}, {Cl}) PACBIO: band "
            f"{ms:.3f} ms, strided {ms_s:.3f} ms, bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f} % of the bound reached)")
    del p
    # between the warp mapping's 319 rows and 1,023: the band mapping
    # beside the one-row mapping, what BAND_MID_MIN_ROWS / _JOBS rest on
    for R, C in ((500, 560), (700, 760), (1000, 1100)):
        for n in (16, 64, 256, 1024):
            a = jobs(n, R, C, 50, 0.1)
            cols = []
            for fn in (mk.msa_score, mk.msa_fill):
                cols.append("one-row %.3f ms, band %.3f ms" % tuple(
                    _cuda_ms(lambda: fn(*a, PB, m), 3)[0]
                    for m in ("row", "band")))
            say(f"sweep band mid {n} x ({R}, {C}): score {cols[0]}; fill "
                f"{cols[1]}; default "
                f"{mk.launch_shape(R, C, None, n).mapping}")
    shapes = {"msa_score": "32,768 x (150, 174)",
              "msa_score_row": "128 x (150, 606)",
              "msa_score_rows": "32,768 x (150, 174)",
              "msa_fill": "8,192 x (150, 174)",
              "msa_walk": "8,192 x (150, 174), 190 steps",
              "msa_score_long": "256 x (6,000, 6,456) PACBIO",
              "msa_fill_long": "16 x (6,000, 6,456) PACBIO"}
    shapes.update({k.replace("_long", "_strided"): v
                   for k, v in shapes.items() if k.endswith("_long")})
    for name, t in out.items():
        t["max_abs_err"] = err[name]
        t["per_cell"] = instr[name]["per_cell"]
        t["function_per_cell"] = instr[name]["function_per_cell"]
        row = f", one-row mapping {t['row_ms']:.3f} ms" \
            if "row_ms" in t else ""
        if "warp_ms" in t:
            row = f", warp mapping {t['warp_ms']:.3f} ms"
        if "strided_ms" in t:
            row = f", strided mapping {t['strided_ms']:.3f} ms"
        say(f"time {name} at {shapes[name]}: kernel {t['ms']:.3f} ms{row}, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']} ({100 * t['bound_ms'] / t['ms']:.1f} % of "
            f"the bound reached; bound at {t['function_per_cell']:.1f} "
            f"instructions a cell, this kernel {t['per_cell']:.1f})")
    for tag, (n, R, C, a, b2) in extra.items():
        first, second = ("kernel", "bound") if tag == "msa_walk long" \
            else ("warp mapping", "one-row mapping")
        say(f"time {tag}: {n} x ({R}, {C}): {first} {a:.3f} ms, "
            f"{second} {b2:.4f} ms")
    return out


def k1_entry(genome, device) -> int:
    """K1's own entry point, ``score_batch``, on the card at 32,768 jobs
    of (150, 174), counted; held equal to K2 on the same jobs. Returns
    K1's launch count."""
    from bbmap_tpu_torch.core.constants import SHORT_PROFILE
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
    """Each kernel wrapper's launches since the last reset; a DP
    kernel's by mapping as well: "<name>_warp", "<name>_row",
    "<name>_band" and "<name>_strided"."""
    from bbmap_tpu_torch.ops import msa_kernels
    out = {k.__name__: k.launches for k in msa_kernels.KERNELS}
    for k in msa_kernels.DP_KERNELS:
        for mapping in msa_kernels.MAPPINGS:
            out[f"{k.__name__}_{mapping}"] = k.launches_by[mapping]
    return out


def main_path(device, n_pairs: int = N_PAIRS, n_steady: int = N_STEADY,
              genome_bases=None, check: bool = True):
    """The bench workload through the port's aligner. Returns (summary
    dict, (batch1, batch2, (mb1, mb2), aligner) of the warmup batch)."""
    import numpy as np
    import torch

    from bbmap_tpu_torch import workload
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.core.batch import ReadBatch
    from bbmap_tpu_torch.core.genome import Genome, Scaffold
    from bbmap_tpu_torch.index.build import analyze_index, build_index
    from bbmap_tpu_torch.ops import msa_kernels

    t0 = time.time()
    gbases = workload.make_genome() if genome_bases is None \
        else genome_bases
    g = Genome(chroms=[gbases], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(gbases),
                 name="ecoli_like")]).finalize()
    index = build_index(g, 13)
    analyze_index(index, 0.01)
    aligner = BBMapAligner(g, index, device)
    n_batches = 1 + n_steady
    r1, r2, q1, q2, t1, t2 = workload.make_pairs(
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
        if not (launches["msa_score_warp"] and launches["msa_score_row"]
                and launches["msa_fill_row"] and launches["msa_walk"]):
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
    return res, (mk(r1, q1, 0), mk(r2, q2, 0), out0, aligner)


def sam_phase(first, n: int = 1000) -> int:
    """emit_sam on the first n pairs; every line has >= 11 fields and
    flags 99/147 appear. Returns the number of lines."""
    import numpy as np
    from bbmap_tpu_torch.align.pipeline import MappedRead, emit_sam
    from bbmap_tpu_torch.core.batch import ReadBatch
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
    """The long-read bench's inputs through the port's ``mappacbio``
    CLI: the genome as FASTA, ``randomreads
    pacbio=t pbmin=pbmax=L pberror=0.12 seed=19``, mapped with
    ``device=``, graded with ``gradesam.grade(out, 400)``. The wall time
    covers the CLI's index build and mapping; the CLI's own mapping time
    is read from its report."""
    import re

    import torch
    from bbmap_tpu_torch import backend
    from bbmap_tpu_torch.align import escalate_device, pipeline
    from bbmap_tpu_torch.ops import msa_kernels
    from bbmap_tpu_torch.tools import gradesam, mappacbio, randomreads

    # what the card's free memory allows a fill launch at the escalation
    # windows (the aligner asks again at each launch)
    for C in (L_read + 24, L_read + 456):
        ladder = escalate_device._trace_ladder(
            L_read, C, escalate_device.TRACE_CHUNKS_W, device)
        say(f"fill chunk at ({L_read}, {C}): budget "
            f"{backend.prev_code_budget(device)} B over "
            f"{msa_kernels.prev_code_bytes(L_read, C, device)} B a job: "
            f"{pipeline._dp_tb_chunk_cap(L_read, C, device)} jobs, trace "
            f"ladder {ladder}")
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
        if not (launches["msa_score_band"] and launches["msa_fill_band"]
                and launches["msa_walk"]):
            raise AssertionError(f"the band kernels or the walk kernel "
                                 f"never launched on the long-read path: "
                                 f"{launches}")
        if launches["msa_score_strided"] or launches["msa_fill_strided"]:
            raise AssertionError(f"a strided kernel launched on the "
                                 f"long-read path: {launches}")
    return res


def _device_profile(fn, tag: str, wall_ms: float, top: int = 12) -> None:
    """Run fn under torch.profiler (CPU + CUDA activities) and print the
    number of kernels, their summed device time, the host time inside
    cudaLaunchKernel, the idle share (1 - device time / ``wall_ms``, the
    same work's wall time without the profiler) and the ``top`` kernels
    by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    launch_us = n_launch_calls = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, us + ev.device_time)
        elif ev.name == "cudaLaunchKernel":
            n_launch_calls += 1
            launch_us += ev.cpu_time
    n_kernels = sum(n for n, _ in kernels.values())
    dev_ms = sum(us for _, us in kernels.values()) / 1e3
    say(f"profile {tag}: wall {wall_ms:.1f} ms without the profiler, "
        f"{n_kernels} device kernels and copies, device time {dev_ms:.3f} "
        f"ms, idle share {100 * (1 - dev_ms / wall_ms):.1f} %, "
        f"cudaLaunchKernel {n_launch_calls} calls {launch_us / 1e3:.1f} ms")
    for name, (n, us) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        say(f"  {us / 1e3:10.3f} ms {n:8d} x {name[:90]}")


def profile_paths(device, gbases) -> None:
    """``python3 chip_smoke.py --profile``: where the time goes. One
    short-read batch of the main path, plain and under torch.profiler,
    then 32 long reads through ``mappacbio`` three times: plain (the
    CLI's mapping time), under cProfile (host functions by cumulative
    time) and under torch.profiler (device kernels)."""
    import cProfile
    import pstats
    _res, (b1, b2, _out, aligner) = main_path(device, n_steady=1,
                                              genome_bases=gbases)
    t0 = time.time()
    aligner.map_pairs_columnar(b1, b2)
    _sync(device)
    _device_profile(lambda: aligner.map_pairs_columnar(b1, b2),
                    f"short batch of {N_PAIRS} pairs",
                    1e3 * (time.time() - t0))
    del aligner
    map_ms = 1e3 * long_phase(device, gbases, n_reads=32,
                              check=False)["map_s"]
    pr = cProfile.Profile()
    pr.enable()
    long_phase(device, gbases, n_reads=32, check=False)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(28)
    for ln in buf.getvalue().splitlines():
        if ln.strip():
            say("  cprofile: " + ln.rstrip()[:150])
    _device_profile(lambda: long_phase(device, gbases, n_reads=32,
                                       check=False),
                    "32 long reads (wall: the CLI's mapping time)", map_ms)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "bbmap_tpu_torch" / "csrc" / "msa_dp.cu").is_file():
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
    libs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    say(f"phase build: {time.time() - t:.2f} s "
        f"({', '.join(p.name for p in libs)})")

    from bbmap_tpu_torch import workload
    t = time.time()
    gbases = workload.make_genome()
    if "--profile" in sys.argv[1:]:
        profile_paths(device, gbases)
        return 0
    ktimes = kernel_phase(gbases, device)
    say(f"phase kernel vs plain: {time.time() - t:.1f} s")

    t = time.time()
    k1_launches = k1_entry(gbases, device)
    say(f"phase K1 entry point: {time.time() - t:.1f} s")

    t = time.time()
    res, first = main_path(device, genome_bases=gbases)
    say(f"phase main path: {time.time() - t:.1f} s; reads/s "
        f"{res['reads_per_s']:.1f} over {N_STEADY} steady batches of "
        f"{N_PAIRS} pairs; sensitivity {res['sensitivity']:.4f}, mapped "
        f"{res['mapped_fraction']:.4f}, pair rate {res['pair_rate']:.4f}; "
        f"launches {res['launches']}; quality offsets device (computed "
        f"on the card on every CUDA run); card {smi}")

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

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "bbmap_tpu"))
    if foreign:
        raise AssertionError(f"the JAX package was imported: {foreign[:5]}")
    # main-path launches; the band kernels run on the long-read path
    # only, K1 at its own entry point, and the strided kernels, which the
    # band kernels replaced, on no path (mapping= only)
    launches = {"msa_score_rows": k1_launches,
                "msa_score": res["launches"]["msa_score_warp"],
                "msa_score_row": res["launches"]["msa_score_row"],
                "msa_fill": res["launches"]["msa_fill_row"],
                "msa_walk": res["launches"]["msa_walk"],
                "msa_score_long": lres["launches"]["msa_score_band"],
                "msa_fill_long": lres["launches"]["msa_fill_band"],
                "msa_score_strided": lres["launches"]["msa_score_strided"]
                + res["launches"]["msa_score_strided"],
                "msa_fill_strided": lres["launches"]["msa_fill_strided"]
                + res["launches"]["msa_fill_strided"]}
    say(f"walk kernel launches: main path {res['launches']['msa_walk']}, "
        f"long reads {lres['launches']['msa_walk']}")
    kernels = []
    for name, n in launches.items():
        kt = ktimes[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name],
                        "replaces": REPLACES[name],
                        "launches": n, "max_abs_err": kt["max_abs_err"],
                        "ms": kt["ms"], "plain_ms": kt["plain_ms"],
                        "bound_ms": kt["bound_ms"],
                        "bound_by": kt["bound_by"],
                        "library_ms": kt["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
