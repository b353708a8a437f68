"""Device mate rescue: the brute-force windowed scan of
AbstractMapThread.quickRescue (reference:
align2/AbstractMapThread.java:2303-2404), batched over a job budget.

Port of ``bbmap_tpu/ops/rescue_device.py``. Per job: scan every
candidate start in [lo, hi], counting mismatches and the longest
exact-match run ("contig"), score = (L - mism) + contig, then apply the
reference's order-dependent acceptance walk (tightening mismatch bound,
(score, absdif-to-ideal) lexicographic improvement, exact-match bound
shrink) exactly as the host oracle ``pipeline._quick_rescue``. The
per-offset statistics accumulate in a loop over read positions; the
acceptance walk is a loop over scan positions in ascending order, with
the per-offset arrays pre-flipped for leftward scans.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.quickmap_device import DeviceIndex, extract_ref_codes

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


def build_rescue(dindex: DeviceIndex, Lm: int, R: int, N_OFF: int = 1536):
    """Returns rescue(reads, lo, n, ideal_k, right, max_mm) ->
    (best_k (R,), min_mm (R,)) numpy for a job budget R. ``reads`` are
    mate-oriented 2-bit codes (4 = N); callers convert best_k to a flat
    start (lo + best_k when right, lo + n-1 - best_k otherwise)."""
    dev = dindex.device

    def dispatch(reads_codes: np.ndarray, lo: np.ndarray, n: np.ndarray,
                 ideal_k: np.ndarray, right: np.ndarray,
                 max_mm: np.ndarray):
        """Run the scan; returns device tensors (best_k, min_mm)."""
        def up(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.to(dtype) if dtype is not None else t).to(dev)
        reads = up(reads_codes)
        return _rescue_stage(dindex, reads, reads > 3, up(lo, I32),
                             up(n, I32), up(ideal_k, I32), up(right),
                             up(max_mm, I32), Lm, N_OFF)

    def run(reads_codes, lo, n, ideal_k, right, max_mm):
        out = dispatch(reads_codes, lo, n, ideal_k, right, max_mm)
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    run.dispatch = dispatch
    run.N_OFF = N_OFF
    run.R = R
    return run
