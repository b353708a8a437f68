"""The DP kernels (``csrc/msa_dp.cu``), their wrappers, launch counters
and plain PyTorch versions.

- ``msa_score`` (K2) and ``msa_fill`` (K3) replace the Pallas kernels
  ``msa_score_pallas_t`` and ``msa_fill_pallas_t``
  (bbmap_tpu/ops/msa_pallas.py:577, :588). They take what the DP
  computes on, not the TPU's operand layout: raw reads (B, R) uint8
  ASCII, reference windows (B, C) uint8 ASCII and per-job row counts
  (B,) int32. Outputs: (3, B) int32 [score >> SCOREOFFSET, col, state]
  and, for the fill, prev-state codes (B, R+C, R+1) uint8, defined on
  the valid cells 1 <= r <= rows[b], 1 <= c <= C.
- ``msa_score_rows`` (K1) replaces ``msa_score_pallas``
  (msa_pallas.py:243) with its signature and operands: read1 / read0
  (B, R+1) int32, the reversed, padded, pre-rotated window (B, C+2R+2)
  int32 and rows (B, 1) int32 (``prep_operands``); out (B, 3) int32,
  SHORT profile. ``score_batch`` is its convenience entry point.

``launch_shape`` picks the kernel's mapping from R: one DP row per
thread up to R = 1,023, rows strided over the block (2, 4 or 8 a thread)
up to R = 8,191.

A wrapper given CPU tensors runs the plain version (``ops/msa.dp_plain``)
and counts nothing. Given CUDA tensors it launches the kernel, adds one
to its ``launches`` count (and to ``long_launches`` for the strided
mapping), or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bbmap_tpu.core.constants import SHORT_PROFILE, ScoringProfile

from . import _build
from .msa import _ins0_np, dp_plain

I32 = torch.int32
SHORT_MAX_ROWS = 1023          # one thread per DP row, 1,024 threads a block
LONG_ROWS_PER_THREAD = (2, 4, 8)
MAX_THREADS = 1024
MAX_ROWS = LONG_ROWS_PER_THREAD[-1] * MAX_THREADS - 1   # 8,191
SMEM_MAX = 232_448             # 227 KB of shared memory a block (sm_90)

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
    rows_per_thread: int    # 1: one row a thread; 2, 4, 8: strided rows
    threads: int
    smem_bytes: int

    @property
    def long(self) -> bool:
        return self.rows_per_thread > 1


def launch_shape(R: int, C: int) -> LaunchShape:
    """The kernel mapping for a DP of R rows and a window of C columns.
    Both wave slots take 24 * (R+1) bytes of shared memory, the window C
    more, and the strided mapping stages the read as well (R bytes).
    Raises above R = 8,191 or when the shared memory would exceed 227 KB.
    ``smem_bytes`` must agree with ``smem_bytes`` in the kernel source,
    which refuses a launch that disagrees."""
    if R < 0 or C < 0:
        raise ValueError(f"R={R}, C={C}: both must be >= 0")
    wave = 24 * (R + 1)
    if R <= SHORT_MAX_ROWS:
        shape = LaunchShape(1, (R + 1 + 31) // 32 * 32, wave + C)
    else:
        J = next((j for j in LONG_ROWS_PER_THREAD
                  if j * MAX_THREADS >= R + 1), None)
        if J is None:
            raise ValueError(f"R={R}: the DP kernels hold at most "
                             f"{MAX_ROWS} rows")
        threads = (-(-(R + 1) // J) + 31) // 32 * 32
        shape = LaunchShape(J, threads, wave + C + R)
    if shape.smem_bytes > SMEM_MAX:
        raise ValueError(f"(R, C) = ({R}, {C}) needs {shape.smem_bytes} B "
                         f"of shared memory, more than {SMEM_MAX}")
    return shape


def _lib() -> ctypes.CDLL:
    lib = _build.load("msa_dp")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        tail = [ci, ci, ci, vp]     # rows_per_thread, threads, smem, stream
        lib.msa_score_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp,
                                         *tail]
        lib.msa_fill_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp,
                                        vp, *tail]
        lib.msa_score_rows_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci,
                                              ci, vp, vp, *tail]
        for fn in (lib.msa_score_launch, lib.msa_fill_launch,
                   lib.msa_score_rows_launch):
            fn.restype = ci
        lib._bbmap_typed = True
    return lib


@functools.lru_cache(maxsize=16)
def _ins0_on(R: int, P: ScoringProfile, dev: torch.device) -> torch.Tensor:
    """Column-0 boundary (R+1,) int32 on the card, read by the strided
    mapping."""
    return torch.as_tensor(_ins0_np(R, P), device=dev)


def _launch(wrapper, fn, inputs, outputs, B: int, R: int, C: int,
            P: ScoringProfile) -> None:
    """Launch one kernel of the library with the mapping launch_shape
    picks; raise on a non-zero CUDA error, else count the launch."""
    shape = launch_shape(R, C)
    dev = outputs[0].device
    prof = prof_array(P)
    err = fn(*(x.data_ptr() for x in inputs), _ins0_on(R, P, dev).data_ptr(),
             B, R, C, prof.ctypes.data, *(x.data_ptr() for x in outputs),
             *shape, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")
    wrapper.launches += 1
    if shape.long:
        wrapper.long_launches += 1


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
                   rows: torch.Tensor, P: ScoringProfile):
    """Plain version of the fill kernel: ((3, B) int32,
    (B, R+C, R+1) uint8)."""
    _check(reads, refs, rows)
    return dp_plain(reads, refs, rows, P, want_prevs=True)


def _raw_dp(wrapper, reads, refs, rows, P: ScoringProfile,
            want_prevs: bool):
    """K2 / K3 on raw jobs: the plain version on CPU tensors, the kernel
    on CUDA tensors. Returns (out (3, B), prevs or None)."""
    _check(reads, refs, rows)
    if reads.device.type == "cpu":
        return dp_plain(reads, refs, rows, P, want_prevs)
    _on_cuda(reads)
    reads, refs, rows = (x.contiguous() for x in (reads, refs, rows))
    B, R = reads.shape
    C = refs.shape[1]
    out = torch.empty((3, B), dtype=I32, device=reads.device)
    prevs = torch.empty((B, R + C, R + 1), dtype=torch.uint8,
                        device=reads.device) if want_prevs else None
    if B:
        lib = _lib()
        fn = lib.msa_fill_launch if want_prevs else lib.msa_score_launch
        _launch(wrapper, fn, (reads, refs, rows),
                (out, prevs) if want_prevs else (out,), B, R, C, P)
    return out, prevs


def msa_score(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
              P: ScoringProfile) -> torch.Tensor:
    """DP score pass (K2). CPU tensors: plain version. CUDA tensors:
    the hand-written kernel, or an exception."""
    return _raw_dp(msa_score, reads, refs, rows, P, want_prevs=False)[0]


def msa_fill(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
             P: ScoringProfile):
    """DP fill pass (K3): score plus prev-state codes. CPU tensors: plain
    version. CUDA tensors: the hand-written kernel, or an exception."""
    return _raw_dp(msa_fill, reads, refs, rows, P, want_prevs=True)


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
                   R: int, C: int, BB: int) -> torch.Tensor:
    """DP score pass with K1's operands (msa_score_pallas): returns
    (B, 3) int32 [score, col, state]. CPU tensors: plain version. CUDA
    tensors: the hand-written kernel, or an exception."""
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
        _launch(msa_score_rows, _lib().msa_score_rows_launch,
                (read1, read0, refpad, rows), (out,), B, R, C,
                SHORT_PROFILE)
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


KERNELS = (msa_score_rows, msa_score, msa_fill)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.long_launches = 0


reset_launches()
