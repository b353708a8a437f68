"""The DP score and fill kernels (``csrc/msa_dp.cu``), their wrappers,
launch counters and plain PyTorch versions.

Replaces the Pallas kernels ``msa_score_pallas_t`` and
``msa_fill_pallas_t`` (bbmap_tpu/ops/msa_pallas.py:577, :588). The
kernels take what the DP computes on, not the TPU's operand layout: raw
reads (B, R) uint8 ASCII, reference windows (B, C) uint8 ASCII and
per-job row counts (B,) int32. Outputs: (3, B) int32
[score >> SCOREOFFSET, col, state] and, for the fill, prev-state codes
(B, R+C, R+1) uint8, defined on the valid cells 1 <= r <= rows[b],
1 <= c <= C.

A wrapper given CPU tensors runs the plain version (``ops/msa.dp_plain``)
and counts nothing. Given CUDA tensors it launches the kernel, adds one
to its ``launches`` count, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bbmap_tpu.core.constants import ScoringProfile

from . import _build
from .msa import dp_plain

MAX_ROWS = 1023     # one thread per DP row, at most 1024 threads a block

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("msa_dp")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msa_score_launch.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp]
        lib.msa_score_launch.restype = ci
        lib.msa_fill_launch.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp,
                                        vp]
        lib.msa_fill_launch.restype = ci
        lib._bbmap_typed = True
    return lib


def _check(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor):
    if reads.dim() != 2 or refs.dim() != 2 or rows.dim() != 1:
        raise ValueError("reads (B, R), refs (B, C), rows (B,) expected")
    if reads.shape[0] != refs.shape[0] or reads.shape[0] != rows.shape[0]:
        raise ValueError("reads, refs and rows disagree on the job count")
    if reads.dtype != torch.uint8 or refs.dtype != torch.uint8:
        raise TypeError("reads and refs must be uint8 ASCII")
    if rows.dtype != torch.int32:
        raise TypeError("rows must be int32")
    if not (reads.device == refs.device == rows.device):
        raise ValueError("reads, refs and rows must share one device")


def _cuda_args(reads, refs, rows):
    if reads.device.type != "cuda":
        raise RuntimeError(
            f"the DP kernels run on CUDA tensors (got {reads.device})")
    R = reads.shape[1]
    if R + 1 > MAX_ROWS + 1:
        raise ValueError(f"R={R}: the kernel holds one row per thread, "
                         f"R must be <= {MAX_ROWS}")
    return (reads.contiguous(), refs.contiguous(), rows.contiguous())


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


def msa_score(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
              P: ScoringProfile) -> torch.Tensor:
    """DP score pass (K2). CPU tensors: plain version. CUDA tensors:
    the hand-written kernel, or an exception."""
    _check(reads, refs, rows)
    if reads.device.type == "cpu":
        return dp_plain(reads, refs, rows, P, want_prevs=False)[0]
    reads, refs, rows = _cuda_args(reads, refs, rows)
    B, R = reads.shape
    C = refs.shape[1]
    out = torch.empty((3, B), dtype=torch.int32, device=reads.device)
    if B == 0:
        return out
    prof = prof_array(P)
    stream = torch.cuda.current_stream(reads.device).cuda_stream
    err = _lib().msa_score_launch(
        reads.data_ptr(), refs.data_ptr(), rows.data_ptr(), B, R, C,
        prof.ctypes.data, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"msa_score_launch failed: cudaError {err}")
    msa_score.launches += 1
    return out


def msa_fill(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
             P: ScoringProfile):
    """DP fill pass (K3): score plus prev-state codes. CPU tensors: plain
    version. CUDA tensors: the hand-written kernel, or an exception."""
    _check(reads, refs, rows)
    if reads.device.type == "cpu":
        return dp_plain(reads, refs, rows, P, want_prevs=True)
    reads, refs, rows = _cuda_args(reads, refs, rows)
    B, R = reads.shape
    C = refs.shape[1]
    out = torch.empty((3, B), dtype=torch.int32, device=reads.device)
    prevs = torch.empty((B, R + C, R + 1), dtype=torch.uint8,
                        device=reads.device)
    if B == 0:
        return out, prevs
    prof = prof_array(P)
    stream = torch.cuda.current_stream(reads.device).cuda_stream
    err = _lib().msa_fill_launch(
        reads.data_ptr(), refs.data_ptr(), rows.data_ptr(), B, R, C,
        prof.ctypes.data, out.data_ptr(), prevs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"msa_fill_launch failed: cudaError {err}")
    msa_fill.launches += 1
    return out, prevs


msa_score.launches = 0
msa_fill.launches = 0

KERNELS = (msa_score, msa_fill)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
