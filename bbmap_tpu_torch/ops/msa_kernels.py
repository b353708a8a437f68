"""The DP kernels (``csrc/msa_dp.cu``, ``csrc/msa_dp_warp.cu``,
``csrc/msa_dp_pipe.cu``, ``csrc/msa_dp_band.cu``), the traceback walk
kernel (``csrc/msa_walk.cu``)
and the fused fill + walk kernel (``csrc/msa_fill_walk.cu``), their
wrappers, launch counters and plain PyTorch versions.

- ``msa_score`` (K2) and ``msa_fill`` (K3) replace the Pallas kernels
  ``msa_score_pallas_t`` and ``msa_fill_pallas_t``
  (bbmap_tpu/ops/msa_pallas.py:577, :588). They take what the DP
  computes on, not the TPU's operand layout: raw reads (B, R) uint8
  ASCII, reference windows (B, C) uint8 ASCII and per-job row counts
  (B,) int32. Outputs: (3, B) int32 [score >> SCOREOFFSET, col, state]
  and, for the fill, a block of prev-state codes uint8 with its
  ``PrevLayout`` (``ops/msa.py``): wave-major (B, R+C, R+1) from the short
  mappings and the plain version, row-major (B, R+1, pitch) from the band
  mapping; defined on the valid cells 1 <= r <= rows[b], 1 <= c <= C.
- ``msa_score_rows`` (K1) replaces ``msa_score_pallas``
  (msa_pallas.py:243) with its signature and operands: read1 / read0
  (B, R+1) int32, the reversed, padded, pre-rotated window (B, C+2R+2)
  int32 and rows (B, 1) int32 (``prep_operands``); out (B, 3) int32,
  SHORT profile. ``score_batch`` is its convenience entry point.

- ``msa_score_segments`` is ``msa_score`` over several lists of jobs
  that share R (the fused program's narrow and wide passes), in one
  launch of the warp mapping with a segment table.

- ``msa_walk`` replaces the device walk ``_walk_device``
  (bbmap_tpu/ops/msa_jax.py:451, a compiled scan): one launch walks every
  job's prev codes, in either layout, from (R, col0, st0) and writes the
  symbols, their count, the gap count and the row the walk ended on; a
  warp a job, the row-major block's codes staged in shared memory tile by
  tile.
- ``msa_fill_walk`` is ``msa_fill`` followed by ``msa_walk`` from the
  fill's own column and state, as the fused program and
  ``ops/msa.msa_align_batch`` run them: where ``fill_walk_shape`` holds
  the job (R <= 1,023, its codes within a block's shared memory) one
  kernel (``csrc/msa_fill_walk.cu``) fills and walks with the prev codes
  in shared memory, and no block of prev codes is allocated; elsewhere
  the two kernels above.

``launch_shape`` picks a DP kernel's mapping: a warp a job ("warp", 1 to
10 rows a lane) for score passes of 1,024 jobs or more up to R = 319, one
DP row per thread ("row") up to R = 1,023, a block a job with a warp a
band of rows pipelined inside it ("pipe", 1 or 2 rows a lane) from 700
rows, where it won, and past 1,023 rows a warp a band of rows, the bands
of a job pipelined over the card ("band", 2, 4 or 8 rows a lane) up to
R = 8,191. Rows strided over one block ("strided"), which "band"
replaced, stays launchable by ``mapping=`` for comparison.

A wrapper given CPU tensors runs the plain version (``ops/msa.dp_plain``,
``ops/msa.walk_plain``; ``msa_score_plain`` a segment) and counts
nothing. Given CUDA tensors it launches the kernel and adds one to its
``launches`` count (a DP wrapper to ``launches_by[mapping]`` as well,
``msa_fill_walk`` to ``launches_by[variant]``), or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.constants import SHORT_PROFILE, ScoringProfile

from . import _build
from .msa import (PrevLayout, _ins0_np, dp_plain, prev_block_shape,
                  prev_pitch, row_major, walk_plain, wave_major)

I32 = torch.int32
WARP_MAX_ROWS_PER_LANE = 10    # a warp a job: R + 1 <= 320 rows
WARP_MAX_ROWS = 32 * WARP_MAX_ROWS_PER_LANE - 1
WARP_THREADS = 128             # four jobs a block
# Below it a score pass takes the one-row mapping. From the sweep of K2
# over the job count in the warp, one-row and pipe mappings (chip_smoke.py,
# "sweep msa_score" lines, NVIDIA H100 80GB HBM3, 700 W): at
# 1,024 jobs the warp mapping wins at (150, 174), 0.363 ms against one-row
# 0.453 and pipe 0.414, and ties at (150, 606), 1.100 against 1.081 and
# 1.154; at 512 jobs the one-row mapping wins at both windows (0.248
# against 0.332 and 0.257 at (150, 174)).
WARP_MIN_JOBS = 1024
SHORT_MAX_ROWS = 1023          # one thread per DP row, 1,024 threads a block
# The pipelined-warp mapping (csrc/msa_dp_pipe.cu): a lane a row up to
# this many rows (16 warps), two rows a lane past it (at most 16 warps).
PIPE_ONE_ROW_MAX = 511
PIPE_CHUNK, PIPE_RING = 4, 64   # columns a hand-over, columns a ring
LONG_ROWS_PER_THREAD = (2, 4, 8)
MAX_THREADS = 1024
MAX_ROWS = LONG_ROWS_PER_THREAD[-1] * MAX_THREADS - 1   # 8,191
BAND_ROWS_PER_LANE = (2, 4, 8)  # a band is 32 lanes of as many rows
BAND_FILL_MAX_ROWS_PER_LANE = 4
# A launch whose bands, at the given rows a lane, would be fewer warps
# than this takes half as many rows a lane: thinner bands, more warps.
# From a sweep over rows a lane and the job count at (6,000, 6,456) on an
# H100 (chip_smoke.py, "sweep" lines): a job alone takes 9-10 ms at 2 rows
# a lane and 21-22 ms at 8, 16 jobs 11-13 ms against 21-22 ms; from 64 jobs
# (1,536 warps at 8 rows a lane) the three run within a quarter of each
# other in no steady order. A fill at 8 rows a lane takes 167 registers
# and was never ahead (level at 64 jobs, 77 ms against 62 ms at 128, 236
# against 174 at 400), so a fill stops at 4.
BAND_MIN_WARPS = 1024
# Between the warp mapping's 319 rows and 1,023 rows, from the same run's
# "sweep band mid" lines (score / fill ms, one-row, band, pipe): from 700
# rows the pipe mapping wins the score pass at every job count swept (16 to
# 1,024: 1.062 / 1.113 / 1.163 at 16 x (700, 760), 5.036 / 6.217 / 7.960
# at 1,024; at 16 x (1,000, 1,100) band 1.625 and pipe 1.652 tie) and the
# fill from 256 jobs (1.862 against 2.111 and 2.262 at (700, 760)); below
# 256 jobs a fill keeps the one-row mapping (the band mapping is ahead by
# up to 19 % at (1,000, 1,100) and behind at 64 x (700, 760)). Below 700
# rows every launch under WARP_MIN_JOBS keeps the one-row mapping: the
# pipe's and the band mapping's few wins there (narrow windows from ~520
# jobs, (500, 560) from 1,024 jobs; PERF.md) were measured at too few
# window widths to draw a rule from.
PIPE_MID_MIN_ROWS = 700
PIPE_MID_MIN_FILL_JOBS = 256
SMEM_MAX = 232_448             # 227 KB of shared memory a block (sm_90)
SMEM_PER_SM = 233_472          # 228 KB an SM, of it 1 KB reserved a block
# The fused fill + walk (csrc/msa_fill_walk.cu): a block a job, a thread
# a row (R <= 1,023), the codes in shared memory a byte a cell ("row") or
# four bits ("row_packed"). From the sweep over the job count on an H100
# (chip_smoke.py, "sweep msa_fill_walk" lines): a byte a cell wins at
# (150, 174) at every job count from 64 to 8,192; at (150, 606), whose
# byte block leaves room for 2 blocks an SM, packing wins from 1,024 jobs
# (1.19 ms against 1.57 at 1,024, 8.56 against 11.97 at 8,192) and loses
# below (0.41 against 0.37 ms at 64 jobs). So the codes are packed where a
# byte block leaves room for fewer than FILL_WALK_PACK_BELOW_BLOCKS blocks
# an SM and the launch has FILL_WALK_PACK_MIN_JOBS jobs or more.
FILL_WALK_VARIANTS = ("row", "row_packed")
FILL_WALK_PACK_BELOW_BLOCKS = 4
FILL_WALK_PACK_MIN_JOBS = 1024
# Score passes of one R over several windows launch together
# (msa_score_segments), at most this many segments a launch.
MAX_SEGMENTS = 4
# When a dict, every DP launch adds one to it under (wrapper, mapping,
# jobs, R, C): the shapes a run gives each mapping (chip_smoke.py reads
# the CLIs' one-row launches so). None: nothing is recorded.
LAUNCH_SHAPES: Optional[dict] = None

_PROF_FIELDS = (
    "TIMEMASK", "SCOREOFFSET", "MAX_TIME", "MASK5", "BARRIER_I1",
    "BARRIER_D1", "LIMIT_FOR_COST_3", "LIMIT_FOR_COST_4",
    "LIMIT_FOR_COST_5", "POINTSoff_MATCH", "POINTSoff_MATCH2",
    "POINTSoff_SUB", "POINTSoff_SUBR", "POINTSoff_SUB2", "POINTSoff_SUB3",
    "POINTSoff_NOCALL", "POINTSoff_INS", "POINTSoff_INS2",
    "POINTSoff_INS3", "POINTSoff_INS4", "POINTSoff_DEL", "POINTSoff_DEL2",
    "POINTSoff_DEL3", "POINTSoff_DEL4", "POINTSoff_DEL5",
    "POINTSoff_DEL_REF_N", "POINTSoff_GAP", "BADoff")


def prof_array(P: ScoringProfile) -> np.ndarray:
    """The profile constants in the order of ``struct Prof`` in the
    kernel source."""
    return np.array([getattr(P, f) for f in _PROF_FIELDS], np.int32)


class LaunchShape(NamedTuple):
    rows_per_thread: int    # warp, pipe, band: rows a lane; row: 1;
    threads: int            # strided: 2-8
    smem_bytes: int
    mapping: str            # one of MAPPINGS


MAPPINGS = ("warp", "pipe", "row", "band", "strided")


def pipe_smem(R: int, C: int, bands: int) -> int:
    """Shared memory of a pipe block: the window and the read staged (each
    rounded to 16 bytes), and a ring of PIPE_RING x 3 ints and two
    counters a band."""
    return -(-C // 16) * 16 + -(-R // 16) * 16 + bands * (
        PIPE_RING * 3 + 2) * 4


def band_count(R: int, rows_per_lane: int) -> int:
    """Bands (warps) the band mapping cuts a job of R + 1 rows into."""
    return -(-(R + 1) // (32 * rows_per_lane))


def edge_pitch(C: int) -> int:
    """Ints a band's edge row takes a state: C + 1 rounded up to 32."""
    return (C + 32) // 32 * 32


def launch_shape(R: int, C: int, mapping: Optional[str] = None,
                 jobs: Optional[int] = None, fill: bool = False
                 ) -> LaunchShape:
    """The kernel mapping for ``jobs`` DP jobs of R rows and a window of C
    columns (``fill``: with prev codes).

    - "warp" (R <= 319): a warp a job, lane l owns the ceil((R+1)/32)
      rows from l * J on; four jobs a block, no shared memory. The
      default for score passes of ``WARP_MIN_JOBS`` jobs or more (``jobs=None``
      counts as many): fewer jobs leave most of the card's warp slots
      empty, and a fill's prev codes become scattered single-byte stores
      that cost more than the sweep saves (times in PERF.md), so those
      take the one-row mapping.
    - "row" (R <= 1,023): a block a job, one row a thread. Both wave
      slots take 24 * (R+1) bytes of shared memory, the window C more.
      The default below the warp mapping's launches and below
      ``PIPE_MID_MIN_ROWS`` rows, and for an unknown job count.
    - "pipe" (R <= 1,023): a block a job, a warp a band of 32 rows (a
      lane a row; 64, two a lane, past ``PIPE_ONE_ROW_MAX`` rows), the
      bands handing their bottom rows on through a ring in shared memory
      (``csrc/msa_dp_pipe.cu``); the window and the read staged. The
      default from ``PIPE_MID_MIN_ROWS`` rows (a fill: of
      ``PIPE_MID_MIN_FILL_JOBS`` jobs or more), where it beat the one-row
      and band mappings on the card.
    - "band" (R <= 8,191; the default past R = 1,023): a warp a band of
      32 * J rows, a block a band, the bands of a job handing their bottom
      rows on through device memory (``csrc/msa_dp_band.cu``); no shared
      memory. J is 8 (a fill: 4) for launches of ``BAND_MIN_WARPS`` warps
      or more at that J (``jobs=None`` counts as many), else 4, else 2:
      few jobs are cut into thinner bands so that more warps run.
    - "strided" (1,024 <= R <= 8,191, by ``mapping=`` only): a block a
      job, 2, 4 or 8 rows a thread, strided; the read is staged as well
      (R bytes).

    ``mapping`` forces a mapping where it holds R (for a comparison on
    the card). Raises above R = 8,191 or when the shared memory would
    exceed 227 KB. The launchers in the kernel sources recompute the
    shape and refuse a launch that disagrees."""
    if R < 0 or C < 0:
        raise ValueError(f"R={R}, C={C}: both must be >= 0")
    many = jobs is None or jobs >= WARP_MIN_JOBS
    if mapping is None:
        if R <= WARP_MAX_ROWS and many and not fill:
            mapping = "warp"
        elif R > SHORT_MAX_ROWS:
            mapping = "band"
        elif jobs is not None and R >= PIPE_MID_MIN_ROWS and (
                not fill or jobs >= PIPE_MID_MIN_FILL_JOBS):
            mapping = "pipe"
        else:
            mapping = "row"
    elif not ((mapping == "warp" and R <= WARP_MAX_ROWS)
              or (mapping in ("row", "pipe") and R <= SHORT_MAX_ROWS)
              or mapping == "band"
              or (mapping == "strided" and R > SHORT_MAX_ROWS)):
        raise ValueError(f"mapping {mapping!r} cannot be forced at R={R}")
    if R > MAX_ROWS:
        raise ValueError(f"R={R}: the DP kernels hold at most {MAX_ROWS} "
                         f"rows")
    wave = 24 * (R + 1)
    if mapping == "warp":
        shape = LaunchShape(-(-(R + 1) // 32), WARP_THREADS, 0, mapping)
    elif mapping == "row":
        shape = LaunchShape(1, (R + 1 + 31) // 32 * 32, wave + C, mapping)
    elif mapping == "pipe":
        J = 1 if R <= PIPE_ONE_ROW_MAX else 2
        bands = band_count(R, J)
        shape = LaunchShape(J, 32 * bands, pipe_smem(R, C, bands), mapping)
    elif mapping == "band":
        J = next((j for j in reversed(BAND_ROWS_PER_LANE)
                  if (not fill or j <= BAND_FILL_MAX_ROWS_PER_LANE)
                  and (jobs is None
                       or jobs * band_count(R, j) >= BAND_MIN_WARPS)),
                 BAND_ROWS_PER_LANE[0])
        shape = LaunchShape(J, 32, 0, mapping)
    else:
        J = next(j for j in LONG_ROWS_PER_THREAD
                 if j * MAX_THREADS >= R + 1)
        threads = (-(-(R + 1) // J) + 31) // 32 * 32
        shape = LaunchShape(J, threads, wave + C + R, mapping)
    if shape.smem_bytes > SMEM_MAX:
        raise ValueError(f"(R, C) = ({R}, {C}) needs {shape.smem_bytes} B "
                         f"of shared memory, more than {SMEM_MAX}")
    return shape


class FillWalkShape(NamedTuple):
    threads: int
    smem_bytes: int
    pitch: int              # bytes a row of a job's codes
    packed: bool            # four bits a cell, else a byte

    @property
    def variant(self) -> str:
        return "row_packed" if self.packed else "row"


@functools.lru_cache(maxsize=256)
def fill_walk_pitch(C: int, packed: bool) -> int:
    """Bytes a row of a job's codes takes in shared memory: from the bytes
    the row needs (C, packed (C + 1) // 2) the least pitch at which the
    stores of one wave fall on the fewest distinct words a bank. The 32
    threads of a warp store on one wave the cells (k, c0 - k), k = 0..31,
    at byte (k - 1) * pitch plus the column's byte; packed, only the
    threads that complete a byte store."""
    need = (C + 1) // 2 if packed else C
    k = np.arange(32)

    def conflicts(pitch: int) -> int:
        worst = 0
        for c0 in range(33, 37):
            c = c0 - k
            store = (c % 2 == 0) if packed else np.ones(32, bool)
            byte = (c - 1) // 2 if packed else c - 1
            words = np.unique((k * pitch + byte)[store] // 4)
            worst = max(worst, int(np.bincount(words % 32).max()))
        return worst

    return min(range(need, need + 32), key=lambda p: (conflicts(p), p))


def _fill_walk_variant(R: int, C: int, packed: bool
                       ) -> Optional[FillWalkShape]:
    """The launch for jobs of (R, C) with the codes a byte a cell or
    ``packed``, or None where it does not hold them (more than 1,023 rows,
    shared memory past a block's)."""
    if R < 1 or C < 1 or R > SHORT_MAX_ROWS:
        return None
    pitch = fill_walk_pitch(C, packed)
    shape = FillWalkShape(
        (R + 32) // 32 * 32,
        24 * (R + 1) + (C + 15) // 16 * 16 + R * pitch, pitch, packed)
    return shape if shape.smem_bytes <= SMEM_MAX else None


def fill_walk_shape(R: int, C: int, jobs: Optional[int] = None,
                    variant: Optional[str] = None
                    ) -> Optional[FillWalkShape]:
    """The launch of the fused fill + walk for ``jobs`` jobs of (R, C), or
    None where it does not hold them (the two-kernel route then runs).

    A block a job, a thread a row (R <= 1,023); shared memory the two wave
    slots (24 * (R+1)), the window (C rounded to 16) and the codes (R *
    pitch). "row" keeps a byte a cell, "row_packed" four bits. The default
    is "row", or "row_packed" where a "row" block leaves room for fewer
    than ``FILL_WALK_PACK_BELOW_BLOCKS`` blocks an SM and the launch has
    ``FILL_WALK_PACK_MIN_JOBS`` jobs or more (``jobs=None`` counts as
    many), or where only the packed block fits. ``variant`` (one of
    ``FILL_WALK_VARIANTS``) forces one for a comparison on the card and
    raises where it does not hold the job. The launcher in the source
    recomputes the shape and refuses a launch that disagrees."""
    if variant is not None:
        if variant not in FILL_WALK_VARIANTS:
            raise ValueError(f"no fill + walk variant {variant!r}")
        shape = _fill_walk_variant(R, C, variant == "row_packed")
        if shape is None:
            raise ValueError(f"{variant} does not hold (R, C) = ({R}, {C})")
        return shape
    byte = _fill_walk_variant(R, C, False)
    few = jobs is not None and jobs < FILL_WALK_PACK_MIN_JOBS
    if byte is not None and (few or SMEM_PER_SM // (byte.smem_bytes + 1024)
                             >= FILL_WALK_PACK_BELOW_BLOCKS):
        return byte
    return _fill_walk_variant(R, C, True)


def prev_code_bytes(R: int, C: int, device) -> int:
    """Bytes of prev codes one fill job of (R, C) takes on ``device`` at
    most: on a card the row-major block of the band and pipe mappings, else
    the wave-major block (on the CPU the plain version's)."""
    band = torch.device(device).type == "cuda" and \
        launch_shape(R, C, jobs=1, fill=True).mapping in ("band", "pipe")
    rows, pitch = prev_block_shape(
        R, C, row_major(R, C) if band else wave_major(R, C))
    return rows * pitch


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SHAPE = [_CI, _CI, _CI]           # rows a thread, threads, smem
_SCORE_ARGS = [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, *_SHAPE]
_FILL_ARGS = [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, *_SHAPE]
_ROWS_ARGS = [_VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, *_SHAPE]
# the band mapping also takes its band count, both pitches, sync and edge
_BAND = [_CI, _CI, _CI, _VP, _VP]
_LL = ctypes.c_longlong
# library -> {C function: argument types}
_INTERFACE = {
    "msa_dp": {"msa_score_launch": [*_SCORE_ARGS, _VP],
               "msa_fill_launch": [*_FILL_ARGS, _VP],
               "msa_score_rows_launch": [*_ROWS_ARGS, _VP]},
    "msa_dp_warp": {"msa_score_warp_launch": [*_SCORE_ARGS, _VP],
                    "msa_fill_warp_launch": [*_FILL_ARGS, _VP],
                    "msa_score_rows_warp_launch": [*_ROWS_ARGS, _VP],
                    "msa_score_segments_warp_launch": [
                        _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _VP,
                        *_SHAPE, _VP]},
    "msa_dp_pipe": {"msa_score_pipe_launch": [*_SCORE_ARGS, _VP],
                    "msa_fill_pipe_launch": [*_FILL_ARGS, _VP],
                    "msa_score_rows_pipe_launch": [*_ROWS_ARGS, _VP],
                    "dp_cell_check_launch": [_VP, _CI, _VP, _VP, _VP],
                    "addmax_probe_launch": [_VP, _CI, _VP, _VP],
                    "msa_dp_pipe_smem": [_CI, _CI, _CI]},
    "msa_dp_band": {"msa_score_band_launch": [*_SCORE_ARGS, *_BAND, _VP],
                    "msa_fill_band_launch": [*_FILL_ARGS, *_BAND, _VP],
                    "msa_score_rows_band_launch": [*_ROWS_ARGS, *_BAND,
                                                   _VP]},
    "msa_walk": {"msa_walk_launch": [_VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI,
                                     _CI, _LL, _LL, _LL, _LL, _VP, _VP, _VP,
                                     _VP, _VP]},
    "msa_fill_walk": {"msa_fill_walk_launch": [
        _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP, _CI, _VP, _VP, _VP, _VP, _VP,
        _CI, _CI, _CI, _CI, _VP]},
}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_bbmap_typed", False):
        for fn, argtypes in _INTERFACE[_build._source(name)[0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _CI
        lib._bbmap_typed = True
    return lib


def _dp_fn(kind: str, shape: LaunchShape):
    """The C launcher of a DP kernel (kind: "score", "fill" or
    "score_rows") in the mapping's library."""
    if shape.mapping in ("warp", "band", "pipe"):
        return getattr(_lib(f"msa_dp_{shape.mapping}"),
                       f"msa_{kind}_{shape.mapping}_launch")
    return getattr(_lib("msa_dp"), f"msa_{kind}_launch")


@functools.lru_cache(maxsize=16)
def _ins0_on(R: int, P: ScoringProfile, dev: torch.device) -> torch.Tensor:
    """Column-0 boundary (R+1,) int32 on the card, read by every mapping
    but the one-row one."""
    return torch.as_tensor(_ins0_np(R, P), device=dev)


def _launch(wrapper, kind: str, inputs, outputs, B: int, R: int, C: int,
            P: ScoringProfile, shape: LaunchShape) -> None:
    """Launch one DP kernel in the mapping of ``shape``; raise on a
    non-zero CUDA error, else count the launch."""
    fn = _dp_fn(kind, shape)
    dev = outputs[0].device
    prof = prof_array(P)
    band = ()
    if shape.mapping == "band":
        # scratch of the launch: the ticket and a column count a band
        # (zero), and the bands' bottom rows, written once and read once
        bands = band_count(R, shape.rows_per_thread)
        sync = torch.zeros(1 + B * bands, dtype=I32, device=dev)
        edge = torch.empty((B, bands - 1, 3, edge_pitch(C)), dtype=I32,
                           device=dev)
        band = (bands, prev_pitch(C), edge_pitch(C), sync.data_ptr(),
                edge.data_ptr())
    err = fn(*(x.data_ptr() for x in inputs), _ins0_on(R, P, dev).data_ptr(),
             B, R, C, prof.ctypes.data, *(x.data_ptr() for x in outputs),
             *shape[:3], *band, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")
    wrapper.launches += 1
    wrapper.launches_by[shape.mapping] += 1
    if LAUNCH_SHAPES is not None:
        key = (wrapper.__name__, shape.mapping, B, R, C)
        LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


def _check(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor):
    if reads.dim() != 2 or refs.dim() != 2 or rows.dim() != 1:
        raise ValueError("reads (B, R), refs (B, C), rows (B,) expected")
    if reads.shape[0] != refs.shape[0] or reads.shape[0] != rows.shape[0]:
        raise ValueError("reads, refs and rows disagree on the job count")
    if reads.dtype != torch.uint8 or refs.dtype != torch.uint8:
        raise TypeError("reads and refs must be uint8 ASCII")
    if rows.dtype != I32:
        raise TypeError("rows must be int32")
    if not (reads.device == refs.device == rows.device):
        raise ValueError("reads, refs and rows must share one device")


def _on_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(
            f"the DP kernels run on CUDA tensors (got {t.device})")


def msa_score_plain(reads: torch.Tensor, refs: torch.Tensor,
                    rows: torch.Tensor, P: ScoringProfile) -> torch.Tensor:
    """Plain version of the score kernel: (3, B) int32."""
    _check(reads, refs, rows)
    return dp_plain(reads, refs, rows, P, want_prevs=False)[0]


def msa_fill_plain(reads: torch.Tensor, refs: torch.Tensor,
                   rows: torch.Tensor, P: ScoringProfile,
                   layout: Optional[PrevLayout] = None):
    """Plain version of the fill kernel: ((3, B) int32, the block of prev
    codes uint8, its layout); wave-major (B, R+C, R+1) unless ``layout``
    asks for the row-major block."""
    _check(reads, refs, rows)
    lay = layout or wave_major(reads.shape[1], refs.shape[1])
    return (*dp_plain(reads, refs, rows, P, True, lay), lay)


def _raw_dp(wrapper, reads, refs, rows, P: ScoringProfile,
            want_prevs: bool, mapping: Optional[str] = None):
    """K2 / K3 on raw jobs: the plain version on CPU tensors, the kernel
    on CUDA tensors. Returns (out (3, B), prevs or None, layout)."""
    _check(reads, refs, rows)
    B, R = reads.shape
    C = refs.shape[1]
    if reads.device.type == "cpu":
        return (*dp_plain(reads, refs, rows, P, want_prevs),
                wave_major(R, C))
    _on_cuda(reads)
    reads, refs, rows = (x.contiguous() for x in (reads, refs, rows))
    shape = launch_shape(R, C, mapping, jobs=B, fill=want_prevs)
    layout = row_major(R, C) if shape.mapping in ("band", "pipe") \
        else wave_major(R, C)
    out = torch.empty((3, B), dtype=I32, device=reads.device)
    prevs = torch.empty((B, *prev_block_shape(R, C, layout)),
                        dtype=torch.uint8,
                        device=reads.device) if want_prevs else None
    if B:
        _launch(wrapper, "fill" if want_prevs else "score",
                (reads, refs, rows), (out, prevs) if want_prevs else (out,),
                B, R, C, P, shape)
    return out, prevs, layout


def msa_score(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
              P: ScoringProfile, mapping: Optional[str] = None
              ) -> torch.Tensor:
    """DP score pass (K2). CPU tensors: plain version. CUDA tensors:
    the hand-written kernel, or an exception. ``mapping`` (one of
    ``MAPPINGS``) overrides ``launch_shape``'s choice for a comparison on
    the card; no caller of the package passes it."""
    return _raw_dp(msa_score, reads, refs, rows, P, False, mapping)[0]


def msa_fill(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
             P: ScoringProfile, mapping: Optional[str] = None):
    """DP fill pass (K3): (out, prev-state codes, their ``PrevLayout``).
    CPU tensors: plain version, wave-major. CUDA tensors: the hand-written
    kernel, or an exception; the band and pipe mappings write the
    row-major block, the others the wave-major one. ``mapping`` as for ``msa_score``. Only
    the codes of the valid cells are defined."""
    return _raw_dp(msa_fill, reads, refs, rows, P, True, mapping)


def segments_launch(segments) -> Optional[LaunchShape]:
    """The warp mapping's shape where ``msa_score_segments`` launches the
    segments together: every segment of one R <= 319, at most
    ``MAX_SEGMENTS`` of them, ``WARP_MIN_JOBS`` jobs or more in all (the
    count from which the warp mapping wins alone); else None, and each
    segment goes through ``msa_score``."""
    Rs = {rd.shape[1] for rd, _, _ in segments}
    jobs = sum(rd.shape[0] for rd, _, _ in segments)
    if len(Rs) != 1 or len(segments) > MAX_SEGMENTS or jobs < WARP_MIN_JOBS:
        return None
    R = Rs.pop()
    return launch_shape(R, 0, "warp") if R <= WARP_MAX_ROWS else None


def msa_score_segments(segments, P: ScoringProfile) -> list:
    """K2 score passes of several windows that share R, in one launch:
    ``segments`` is a list of (reads (B_i, R) uint8, refs (B_i, C_i) uint8,
    rows (B_i,) int32); returns one (3, B_i) int32 a segment, what
    ``msa_score`` returns for it alone.

    CPU tensors: ``msa_score_plain`` a segment. CUDA tensors: where
    ``segments_launch`` gives a shape, one launch of the warp mapping
    (``csrc/msa_dp_warp.cu``, a segment table; the segments of the widest
    windows take the first blocks, so that their long sweeps start first),
    else ``msa_score`` a segment. A failed launch raises."""
    for rd, rf, rw in segments:
        _check(rd, rf, rw)
        if rd.device != segments[0][0].device:
            raise ValueError("the segments must share one device")
    if not segments:
        return []
    if segments[0][0].device.type == "cpu":
        return [msa_score_plain(rd, rf, rw, P) for rd, rf, rw in segments]
    shape = segments_launch(segments)
    if shape is None:
        return [msa_score(rd, rf, rw, P) for rd, rf, rw in segments]
    _on_cuda(segments[0][0])
    dev = segments[0][0].device
    R = segments[0][0].shape[1]
    segs = [tuple(x.contiguous() for x in seg) for seg in segments]
    outs = [torch.empty((3, rd.shape[0]), dtype=I32, device=dev)
            for rd, _, _ in segs]
    order = sorted(range(len(segs)), key=lambda i: -segs[i][1].shape[1])
    ptrs = np.array([[segs[i][k].data_ptr() for i in order] for k in range(3)]
                    + [[outs[i].data_ptr() for i in order]], np.uint64)
    dims = np.array([[segs[i][1].shape[k] for i in order]
                     for k in range(2)], np.int32)   # B, then C
    prof = prof_array(P)
    fn = _lib("msa_dp_warp").msa_score_segments_warp_launch
    err = fn(len(segs), *(ptrs[k].ctypes.data for k in range(4)),
             dims[0].ctypes.data, dims[1].ctypes.data,
             _ins0_on(R, P, dev).data_ptr(), R, prof.ctypes.data, *shape[:3],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"msa_score_segments_warp_launch failed: "
                           f"cudaError {err}")
    msa_score_segments.launches += 1
    return outs


# --------------------------------------------------------------------------
# K1: msa_score_pallas's signature and operand layout (SHORT profile).
# --------------------------------------------------------------------------

def prep_operands(reads: torch.Tensor, refs: torch.Tensor,
                  rows: torch.Tensor):
    """K1's operands (msa_pallas.prep_operands): read1[r] = read[r-1],
    read0[r] = read[r-2] ('?' sentinels), the window reversed and padded
    by R+1 '!' on each side, pre-rotated by -(C+R); rows as (B, 1).
    All int32, on the inputs' device."""
    B, R = reads.shape
    C = refs.shape[1]
    dev = reads.device
    read1 = torch.full((B, R + 1), ord("?"), dtype=I32, device=dev)
    read1[:, 1:] = reads.to(I32)
    read0 = torch.full((B, R + 1), ord("?"), dtype=I32, device=dev)
    read0[:, 2:] = reads[:, :-1].to(I32)
    refpad = torch.full((B, C + 2 * (R + 1)), ord("!"), dtype=I32,
                        device=dev)
    refpad[:, R + 1:R + 1 + C] = refs.flip(1).to(I32)
    refpad = torch.roll(refpad, -(C + R), dims=1)
    return read1, read0, refpad, rows.reshape(-1, 1).to(I32)


def _check_rows_operands(read1, read0, refpad, rows, R: int, C: int,
                         BB: int):
    B = read1.shape[0]
    want = {"read1": (read1, (B, R + 1)), "read0": (read0, (B, R + 1)),
            "refpad": (refpad, (B, C + 2 * R + 2)), "rows": (rows, (B, 1))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype != I32:
            raise TypeError(f"{name} must be int32")
        if x.device != read1.device:
            raise ValueError("K1 operands must share one device")
    if BB <= 0 or B % BB:
        raise ValueError(f"B={B} must be a multiple of BB={BB}")


def msa_score_rows_plain(read1: torch.Tensor, read0: torch.Tensor,
                         refpad_rows, R: int, C: int, BB: int
                         ) -> torch.Tensor:
    """Plain version of K1: decode the operands into reads, windows and
    rows, then ``dp_plain`` (SHORT profile). Returns (B, 3) int32."""
    refpad, rows = refpad_rows
    _check_rows_operands(read1, read0, refpad, rows, R, C, BB)
    # window column c (1..C) sits at lane (1 - c) mod (C + 2R + 2)
    lanes = (1 - torch.arange(1, C + 1, device=refpad.device)) \
        % (C + 2 * R + 2)
    reads = read1[:, 1:].to(torch.uint8)
    refs = refpad[:, lanes].to(torch.uint8)
    out = dp_plain(reads, refs, rows[:, 0].contiguous(), SHORT_PROFILE,
                   want_prevs=False)[0]
    return out.T.contiguous()


def msa_score_rows(read1: torch.Tensor, read0: torch.Tensor, refpad_rows,
                   R: int, C: int, BB: int, mapping: Optional[str] = None
                   ) -> torch.Tensor:
    """DP score pass with K1's operands (msa_score_pallas): returns
    (B, 3) int32 [score, col, state]. CPU tensors: plain version. CUDA
    tensors: the hand-written kernel, or an exception. ``mapping`` as
    for ``msa_score``."""
    refpad, rows = refpad_rows
    _check_rows_operands(read1, read0, refpad, rows, R, C, BB)
    if read1.device.type == "cpu":
        return msa_score_rows_plain(read1, read0, refpad_rows, R, C, BB)
    _on_cuda(read1)
    read1, read0, refpad, rows = (x.contiguous() for x in
                                  (read1, read0, refpad, rows))
    B = read1.shape[0]
    out = torch.empty((B, 3), dtype=I32, device=read1.device)
    if B:
        _launch(msa_score_rows, "score_rows", (read1, read0, refpad, rows),
                (out,), B, R, C, SHORT_PROFILE,
                launch_shape(R, C, mapping, jobs=B))
    return out


def score_batch(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
                BB: int = 64):
    """K1's entry point (msa_pallas.score_batch): (B, R) uint8 reads,
    (B, C) uint8 windows, (B,) int32 rows -> (scores, cols, states),
    each (B,) int32. Pads the batch with N jobs to a multiple of BB."""
    B, R = reads.shape
    C = refs.shape[1]
    pad = (-B) % BB
    if pad:
        dev = reads.device
        reads = torch.cat([reads, torch.full((pad, R), ord("N"),
                                             dtype=torch.uint8, device=dev)])
        refs = torch.cat([refs, torch.full((pad, C), ord("N"),
                                           dtype=torch.uint8, device=dev)])
        rows = torch.cat([rows.to(I32),
                          torch.full((pad,), R, dtype=I32, device=dev)])
    r1, r0, rp, rw = prep_operands(reads, refs, rows)
    out = msa_score_rows(r1, r0, (rp, rw), R, C, BB)[:B]
    return out[:, 0], out[:, 1], out[:, 2]


# --------------------------------------------------------------------------
# The traceback walk over K3's prev codes.
# --------------------------------------------------------------------------

def _check_walk(prevs, reads, refs, col0, st0, R: int, C: int, steps: int,
                layout: PrevLayout):
    """Shapes, types and devices of the walk's operands; ``prevs`` must be
    the block of ``layout``, one of the two that keep every cell
    (1..R, 1..C) inside a job's block."""
    if prevs.dim() != 3:
        raise ValueError("prevs must be a (B, rows, pitch) block")
    B = prevs.shape[0]
    want = {"prevs": (prevs, (B, *prev_block_shape(R, C, layout))),
            "reads": (reads, (B, R)),
            "refs": (refs, (B, C)), "col0": (col0, (B,)), "st0": (st0, (B,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != prevs.device:
            raise ValueError("the walk's operands must share one device")
    for name in ("prevs", "reads", "refs"):
        if want[name][0].dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8")
    if R < 1 or C < 1 or steps < 0:
        raise ValueError(f"R={R}, C={C}, steps={steps}: R and C must be "
                         f">= 1 and steps >= 0")


def msa_walk_plain(prevs: torch.Tensor, reads: torch.Tensor,
                   refs: torch.Tensor, col0: torch.Tensor,
                   st0: torch.Tensor, R: int, C: int, steps: int = 0,
                   layout: Optional[PrevLayout] = None):
    """Plain version of the walk kernel (``ops/msa.walk_plain``, one
    tensor step per walk step): (symbols (B, steps) uint8, out_len, gaps,
    row_end), the last three (B,) int32."""
    layout = layout or wave_major(R, C)
    _check_walk(prevs, reads, refs, col0, st0, R, C, steps, layout)
    return walk_plain(prevs, reads, refs, col0, st0, R, C, steps, layout)


def msa_walk(prevs: torch.Tensor, reads: torch.Tensor, refs: torch.Tensor,
             col0: torch.Tensor, st0: torch.Tensor, R: int, C: int,
             steps: int = 0, layout: Optional[PrevLayout] = None):
    """Traceback walk over a block of prev codes in ``layout`` (what the
    fill returned beside it; default wave-major, (B, R+C, R+1)) from
    (R, col0, st0), at most ``steps`` symbols (0: R + C, the hard maximum).
    Returns
    (symbols (B, steps) uint8 in walk order, zero after the last,
    out_len, gaps, row_end); row_end > 0 marks a walk that was cut. CPU
    tensors: plain version. CUDA tensors: the hand-written kernel, one
    launch, or an exception."""
    layout = layout or wave_major(R, C)
    _check_walk(prevs, reads, refs, col0, st0, R, C, steps, layout)
    if prevs.device.type == "cpu":
        return walk_plain(prevs, reads, refs, col0, st0, R, C, steps,
                          layout)
    _on_cuda(prevs)
    n = steps if steps else R + C
    prevs, reads, refs = (x.contiguous() for x in (prevs, reads, refs))
    col0, st0 = (x.to(I32).contiguous() for x in (col0, st0))
    B, dev = prevs.shape[0], prevs.device
    syms = torch.empty((B, n), dtype=torch.uint8, device=dev)
    out_len, gaps, row_end = (torch.empty(B, dtype=I32, device=dev)
                              for _ in range(3))
    if B:
        fn = _lib("msa_walk").msa_walk_launch
        err = fn(prevs.data_ptr(), reads.data_ptr(), refs.data_ptr(),
                 col0.data_ptr(), st0.data_ptr(), B, R, C, n,
                 prevs.shape[1] * prevs.shape[2], *layout,
                 syms.data_ptr(), out_len.data_ptr(), gaps.data_ptr(),
                 row_end.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"msa_walk_launch failed: cudaError {err}")
        msa_walk.launches += 1
    return syms, out_len, gaps, row_end


# --------------------------------------------------------------------------
# Fill and walk in one kernel, the prev codes in shared memory.
# --------------------------------------------------------------------------

def msa_fill_walk_plain(reads: torch.Tensor, refs: torch.Tensor,
                        rows: torch.Tensor, P: ScoringProfile,
                        steps: int = 0):
    """Plain version of the fused fill + walk: ``msa_fill_plain`` followed
    by ``walk_plain`` from the fill's own column and state. Returns (out
    (3, B) int32, symbols (B, steps) uint8, out_len, gaps, row_end)."""
    out, prevs, layout = msa_fill_plain(reads, refs, rows, P)
    R, C = reads.shape[1], refs.shape[1]
    return (out, *walk_plain(prevs, reads, refs, out[1], out[2], R, C,
                             steps, layout))


def msa_fill_walk(reads: torch.Tensor, refs: torch.Tensor,
                  rows: torch.Tensor, P: ScoringProfile, steps: int = 0,
                  variant: Optional[str] = None):
    """Fill (K3) and traceback walk from the fill's own last-row column
    and state, at most ``steps`` symbols (0: R + C). Returns (out (3, B)
    int32 [score >> SCOREOFFSET, col, state], symbols (B, steps) uint8 in
    walk order, zero after the last, out_len, gaps, row_end); row_end > 0
    marks a walk that was cut. Rows must lie in 0..R.

    CPU tensors: the plain version. CUDA tensors, by shape: one launch of
    ``csrc/msa_fill_walk.cu`` where ``fill_walk_shape`` holds the jobs,
    else ``msa_fill`` + ``msa_walk`` (the long reads' band mapping among
    them); a failed launch raises. ``variant`` forces one of
    ``FILL_WALK_VARIANTS`` for a comparison on the card."""
    _check(reads, refs, rows)
    B, R = reads.shape
    C = refs.shape[1]
    if R < 1 or C < 1 or steps < 0:
        raise ValueError(f"R={R}, C={C}, steps={steps}: R and C must be "
                         f">= 1 and steps >= 0")
    if reads.device.type == "cpu":
        return msa_fill_walk_plain(reads, refs, rows, P, steps)
    _on_cuda(reads)
    shape = fill_walk_shape(R, C, B, variant)
    if shape is None:
        out, prevs, layout = msa_fill(reads, refs, rows, P)
        return (out, *msa_walk(prevs, reads, refs, out[1], out[2], R, C,
                               steps, layout))
    n = steps if steps else R + C
    reads, refs, rows = (x.contiguous() for x in (reads, refs, rows))
    dev = reads.device
    out = torch.empty((3, B), dtype=I32, device=dev)
    syms = torch.empty((B, n), dtype=torch.uint8, device=dev)
    out_len, gaps, row_end = (torch.empty(B, dtype=I32, device=dev)
                              for _ in range(3))
    if B:
        fn = _lib("msa_fill_walk").msa_fill_walk_launch
        prof = prof_array(P)          # alive until the launcher has read it
        err = fn(reads.data_ptr(), refs.data_ptr(), rows.data_ptr(),
                 _ins0_on(R, P, dev).data_ptr(), B, R, C,
                 prof.ctypes.data, n, out.data_ptr(),
                 syms.data_ptr(), out_len.data_ptr(), gaps.data_ptr(),
                 row_end.data_ptr(), int(shape.packed), shape.threads,
                 shape.smem_bytes, shape.pitch,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"msa_fill_walk_launch failed: cudaError "
                               f"{err}")
        msa_fill_walk.launches += 1
        msa_fill_walk.launches_by[shape.variant] += 1
    return out, syms, out_len, gaps, row_end


# --------------------------------------------------------------------------
# dp_cell's forms on the card (csrc/msa_dp_pipe.cu): a check, not a path.
# --------------------------------------------------------------------------

CELL_OPERANDS = ("r", "c", "C", "rows", "read1", "read0", "ref1", "ref0",
                 "dd_ms", "dd_del", "dd_ins", "own_ms", "own_del", "up_ms",
                 "up_ins", "ins0", "subfloor")


def dp_cell_forms(ops: torch.Tensor, P: ScoringProfile) -> torch.Tensor:
    """dp_cell with prev codes on every row of ``ops`` ((n, 17) int32 on
    the card, the operands of ``CELL_OPERANDS``) in its plain form and
    its DPX form: (n, 2, 4) int32, (ms, del, ins, code) a form."""
    _on_cuda(ops)
    ops = ops.to(I32).contiguous()
    out = torch.empty((ops.shape[0], 2, 4), dtype=I32, device=ops.device)
    prof = prof_array(P)
    err = _lib("msa_dp_pipe").dp_cell_check_launch(
        ops.data_ptr(), ops.shape[0], prof.ctypes.data, out.data_ptr(),
        torch.cuda.current_stream(ops.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dp_cell_check_launch failed: cudaError {err}")
    return out


def addmax_probe(abc: torch.Tensor) -> torch.Tensor:
    """``__viaddmax_s32(a, b, c)`` beside max(a + b wrapped, c) on every
    row of ``abc`` ((n, 3) int32 on the card): (n, 2) int32."""
    _on_cuda(abc)
    abc = abc.to(I32).contiguous()
    out = torch.empty((abc.shape[0], 2), dtype=I32, device=abc.device)
    err = _lib("msa_dp_pipe").addmax_probe_launch(
        abc.data_ptr(), abc.shape[0], out.data_ptr(),
        torch.cuda.current_stream(abc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"addmax_probe_launch failed: cudaError {err}")
    return out


DP_KERNELS = (msa_score_rows, msa_score, msa_fill)
KERNELS = (*DP_KERNELS, msa_score_segments, msa_walk, msa_fill_walk)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in DP_KERNELS:
        k.launches_by = dict.fromkeys(MAPPINGS, 0)
    msa_fill_walk.launches_by = dict.fromkeys(FILL_WALK_VARIANTS, 0)


reset_launches()
