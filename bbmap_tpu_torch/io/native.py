"""ctypes bindings for the native host-I/O kernels (csrc/bbio.cpp).

Builds libbbio.so on demand with the in-repo Makefile; every entry point
has a pure-Python/numpy fallback so the package works without a
toolchain. (The reference gates its JNI fast paths the same way —
reference: align2/MSA.java:45-48 usejni.) When the library cannot be
built or loaded, ``load_error`` keeps the exception and one line on
stderr says so; nothing on a CUDA device depends on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libbbio.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False
load_error: Optional[Exception] = None   # why get_lib() has no library


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH)
                < os.path.getmtime(os.path.join(_CSRC, "bbio.cpp"))):
            subprocess.run(["make", "-C", _CSRC], capture_output=True,
                           check=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fastq_scan.restype = ctypes.c_long
        lib.fastq_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long)]
        lib.revcomp_batch.restype = None
        lib.sam_format_batch.restype = ctypes.c_long
        _lib = lib
    except (OSError, subprocess.CalledProcessError, AttributeError) as e:
        load_error = e
        detail = (getattr(e, "stderr", None) or b"").decode(
            errors="replace").strip().splitlines()[-1:]
        print(f"bbmap_tpu_torch.io.native: no native host library "
              f"({type(e).__name__}: {e}{'; ' + detail[0] if detail else ''}"
              f"); using the numpy paths", file=sys.stderr)
    return _lib


def fastq_scan(buf: bytes, max_recs: int):
    """Returns (offsets (n, 8) int64, consumed) or None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros((max_recs, 8), np.int64)
    consumed = ctypes.c_long(0)
    n = lib.fastq_scan(
        buf, len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        max_recs, ctypes.byref(consumed))
    if n < 0:
        raise ValueError(f"malformed FASTQ near byte {-n - 1}")
    return out[:n], consumed.value


def quality_offsets_scores(quality: np.ndarray, L: int, k: int,
                           prob_correct: np.ndarray,
                           ladder: np.ndarray, max_density: float,
                           a: int):
    """Host twin of the device quality-offsets stage (C, threaded):
    returns (offsets (B, nk) int16 [-1 unused], scores (B, nk) int16,
    reject (B,) bool) or None when the native library is unavailable.
    Bit-identical to quickmap_device._quality_offsets_core
    (tests/test_quality_seeding.py)."""
    lib = get_lib()
    if lib is None or L > 1024:
        return None
    if not hasattr(lib, "quality_offsets_scores"):
        return None
    q = np.ascontiguousarray(quality[:, :L], np.int8)
    B = q.shape[0]
    nk = len(ladder)
    pc = np.ascontiguousarray(prob_correct, np.float32)
    lad = np.ascontiguousarray(ladder, np.int32)
    out_off = np.empty((B, nk), np.int16)
    out_sc = np.empty((B, nk), np.int16)
    out_rej = np.empty(B, np.uint8)
    lib.quality_offsets_scores(
        q.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(B),
        ctypes.c_long(q.shape[1]), ctypes.c_int(L), ctypes.c_int(k),
        pc.ctypes.data_as(ctypes.c_void_p),
        lad.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(nk),
        ctypes.c_double(max_density), ctypes.c_int(a),
        out_off.ctypes.data_as(ctypes.c_void_p),
        out_sc.ctypes.data_as(ctypes.c_void_p),
        out_rej.ctypes.data_as(ctypes.c_void_p))
    return out_off, out_sc, out_rej.astype(bool)
