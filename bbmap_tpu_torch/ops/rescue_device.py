"""Device mate rescue: the brute-force windowed scan of
AbstractMapThread.quickRescue (reference:
align2/AbstractMapThread.java:2303-2404), a batch of jobs a call.

Port of ``bbmap_tpu/ops/rescue_device.py``. Per job: scan every
candidate start in [lo, hi], counting mismatches and the longest
exact-match run ("contig"), score = (L - mism) + contig, then apply the
reference's order-dependent acceptance walk (tightening mismatch bound,
(score, absdif-to-ideal) lexicographic improvement, exact-match bound
shrink) exactly as the host oracle ``pipeline._quick_rescue``.

- ``rescue_scan`` is the kernel's wrapper. Given CUDA tensors it makes
  one launch of ``csrc/rescue_scan.cu`` (a block a job: the window and
  the read staged as 2-bit words in shared memory, the offsets over the
  threads a word of 16 positions a step, cut once their misses pass
  max_mm + 1, the walk on one warp by ballots, 32 steps a round) and adds
  one to ``rescue_scan.launches``; given CPU tensors it runs the plain
  version and counts nothing.
- ``_rescue_stage`` is the plain version: the per-offset statistics
  accumulate in a loop over read positions; the acceptance walk is a loop
  over scan positions in ascending order, with the per-offset arrays
  pre-flipped for leftward scans.
- ``upload_jobs`` puts a batch's job arrays on the device in one copy
  (pinned and non-blocking on a card); ``build_rescue`` is the JAX
  package's entry point on numpy arrays.

The JAX package pads every call to a fixed job budget for its program
cache; the port launches exactly the jobs it is given.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..align.quickmap_device import DeviceIndex, extract_ref_codes
from . import _build

I32 = torch.int32
BIGA = 2 ** 30


def _rescue_stage(dindex: DeviceIndex, reads, rn, lo, n, ideal_k, right,
                  max_mm, Lm: int, N_OFF: int):
    """reads: (R, Lm) codes 0..4 (mate-oriented). lo: (R,) flat window
    start. n: (R,) candidate offsets (<= N_OFF). ideal_k: (R,) scan
    coordinate of the ideal start. right: (R,) bool scan direction.
    Returns (best_k, min_mm) — best_k < 0 when nothing was accepted."""
    dev = reads.device
    R = reads.shape[0]
    W = N_OFF + Lm
    g, gbad = extract_ref_codes(dindex.gpack, dindex.nmask, lo, W, dindex.G,
                                has_n=dindex.has_n)
    i16 = torch.int16
    mism = torch.zeros((R, N_OFF), dtype=i16, device=dev)
    cur = torch.zeros((R, N_OFF), dtype=i16, device=dev)
    contig = torch.zeros((R, N_OFF), dtype=i16, device=dev)
    for j in range(Lm):
        good = (g[:, j:j + N_OFF] == reads[:, j:j + 1]) \
            & ~gbad[:, j:j + N_OFF] & ~rn[:, j:j + 1]
        mism = mism + (~good).to(i16)
        cur = torch.where(good, cur + 1, 0).to(i16)
        contig = torch.maximum(contig, cur)
    mism = mism.to(I32)
    score = (Lm - mism) + contig.to(I32)

    k_ar = torch.arange(N_OFF, dtype=I32, device=dev)[None, :]
    t_of_k = torch.where(right[:, None], k_ar, (n[:, None] - 1) - k_ar)
    t_valid = (t_of_k >= 0) & (t_of_k < n[:, None])
    t_safe = torch.clamp(t_of_k, 0, N_OFF - 1).long()
    mism_k = torch.gather(mism, 1, t_safe)
    score_k = torch.gather(score, 1, t_safe)
    absdif_k = torch.abs(t_of_k - ideal_k[:, None])
    kref = torch.where(right, ideal_k, (n - 1) - ideal_k)

    min_mm = (max_mm + 1).to(I32)
    best_s = torch.zeros(R, dtype=I32, device=dev)
    best_a = torch.full((R,), BIGA, dtype=I32, device=dev)
    best_k = torch.full((R,), -1, dtype=I32, device=dev)
    klim = torch.full((R,), N_OFF, dtype=I32, device=dev)
    for k in range(N_OFF):
        m = mism_k[:, k]
        s = score_k[:, k]
        a = absdif_k[:, k]
        ok = t_valid[:, k] & (k <= klim) & (m <= min_mm) \
            & ((s > best_s) | ((s == best_s) & (a < best_a)))
        min_mm = torch.where(ok, m, min_mm)
        best_s = torch.where(ok, s, best_s)
        best_a = torch.where(ok, a, best_a)
        best_k = torch.where(ok, k, best_k)
        klim = torch.where(ok & (m == 0), torch.minimum(klim, kref + a),
                           klim)
    return best_k, min_mm


def _lib() -> ctypes.CDLL:
    lib = _build.load("rescue_scan")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rescue_scan_launch.argtypes = [
            vp, vp, ll, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        lib.rescue_scan_launch.restype = ci
        lib.rescue_scan_smem.argtypes = [ci, ci]
        lib.rescue_scan_smem.restype = ll
        lib._bbmap_typed = True
    return lib


def _check(dindex, reads, lo, n, ideal_k, right, max_mm, Lm: int,
           N_OFF: int) -> None:
    if reads.dim() != 2 or reads.shape[1] != Lm:
        raise ValueError(f"reads (R, {Lm}) expected, got {tuple(reads.shape)}")
    R = reads.shape[0]
    for name, t in (("lo", lo), ("n", n), ("ideal_k", ideal_k),
                    ("max_mm", max_mm)):
        if t.shape != (R,) or t.dtype != I32:
            raise TypeError(f"{name} must be ({R},) int32")
    if right.shape != (R,) or right.dtype != torch.bool:
        raise TypeError(f"right must be ({R},) bool")
    if reads.dtype != torch.uint8:
        raise TypeError("reads must be uint8 codes")
    if not 1 <= Lm < 2 ** 15 or N_OFF < 1:
        raise ValueError(f"Lm={Lm} must lie in [1, 32767], N_OFF={N_OFF} "
                         f">= 1 (the plain version counts in int16)")
    devs = {t.device for t in (reads, lo, n, ideal_k, right, max_mm)}
    if devs != {dindex.device}:
        raise ValueError("the jobs and the index must share one device")


def rescue_scan(dindex: DeviceIndex, reads: torch.Tensor, lo: torch.Tensor,
                n: torch.Tensor, ideal_k: torch.Tensor, right: torch.Tensor,
                max_mm: torch.Tensor, Lm: int, N_OFF: int):
    """quickRescue's scan of R jobs (the arguments of ``_rescue_stage``,
    ``rn`` taken from the reads). Returns (best_k, min_mm) (R,) int32.
    CPU tensors: the plain version. CUDA tensors: one launch of
    ``csrc/rescue_scan.cu``; a failed launch raises."""
    _check(dindex, reads, lo, n, ideal_k, right, max_mm, Lm, N_OFF)
    if reads.device.type == "cpu":
        return _rescue_stage(dindex, reads, reads > 3, lo, n, ideal_k, right,
                             max_mm, Lm, N_OFF)
    if reads.device.type != "cuda":
        raise RuntimeError(
            f"the rescue kernel runs on CUDA tensors (got {reads.device})")
    R, dev = reads.shape[0], reads.device
    best_k = torch.empty(R, dtype=I32, device=dev)
    min_mm = torch.empty(R, dtype=I32, device=dev)
    if R == 0:
        return best_k, min_mm
    lib = _lib()
    smem = lib.rescue_scan_smem(Lm, N_OFF)
    if smem > 232448:
        raise ValueError(f"a job at Lm={Lm}, N_OFF={N_OFF} takes {smem} B "
                         f"of shared memory, past a block's 227 KB")
    args = [t.contiguous() for t in (reads, lo, n, ideal_k, right, max_mm)]
    err = lib.rescue_scan_launch(
        dindex.gpack.data_ptr(), dindex.nmask.data_ptr(), dindex.G,
        int(dindex.has_n), *(t.data_ptr() for t in args), R, Lm, N_OFF,
        best_k.data_ptr(), min_mm.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rescue_scan_launch failed: cudaError {err}")
    rescue_scan.launches += 1
    return best_k, min_mm


def reset_launches() -> None:
    rescue_scan.launches = 0


reset_launches()


def upload_jobs(reads_codes: np.ndarray, lo: np.ndarray, n: np.ndarray,
                ideal_k: np.ndarray, right: np.ndarray, max_mm: np.ndarray,
                device) -> tuple:
    """R jobs on ``device`` in one copy (pinned and non-blocking on a
    card). Returns (reads (R, Lm) uint8, lo, n, ideal_k (R,) int32, right
    (R,) bool, max_mm (R,) int32), the arguments of ``rescue_scan``."""
    R, Lm = reads_codes.shape
    dev = torch.device(device)
    host = torch.empty(17 * R + R * Lm, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    h = host.numpy()
    table = h[:16 * R].view(np.int32).reshape(4, R)
    table[0], table[1], table[2], table[3] = lo, n, ideal_k, max_mm
    h[16 * R:17 * R] = right
    h[17 * R:].reshape(R, Lm)[:] = reads_codes
    buf = host.to(dev, non_blocking=True)
    tab = buf[:16 * R].view(I32).view(4, R)
    return (buf[17 * R:].view(R, Lm), tab[0], tab[1], tab[2],
            buf[16 * R:17 * R].view(torch.bool), tab[3])


def build_rescue(dindex: DeviceIndex, Lm: int, R: int, N_OFF: int = 1536):
    """Returns rescue(reads, lo, n, ideal_k, right, max_mm) ->
    (best_k, min_mm) numpy for at most R jobs a call. ``reads`` are
    mate-oriented 2-bit codes (4 = N); callers convert best_k to a flat
    start (lo + best_k when right, lo + n-1 - best_k otherwise)."""
    dev = dindex.device

    def dispatch(reads_codes: np.ndarray, lo: np.ndarray, n: np.ndarray,
                 ideal_k: np.ndarray, right: np.ndarray,
                 max_mm: np.ndarray):
        """Run the scan; returns device tensors (best_k, min_mm)."""
        if len(reads_codes) > R:
            raise ValueError(f"{len(reads_codes)} jobs, at most {R} a call")
        return rescue_scan(dindex, *upload_jobs(reads_codes, lo, n, ideal_k,
                                                right, max_mm, dev),
                           Lm, N_OFF)

    def run(reads_codes, lo, n, ideal_k, right, max_mm):
        out = dispatch(reads_codes, lo, n, ideal_k, right, max_mm)
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    run.dispatch = dispatch
    run.N_OFF = N_OFF
    run.R = R
    return run
