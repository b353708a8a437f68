"""Device DP escalation for the host-fallback (refit) path: score and
fill + traceback programs that gather their reference windows from the
2-bit packed genome on the device.

Port of ``bbmap_tpu/align/escalate_device.py`` (reference:
align2/BBMapThread.scoreSlow:252-345 scores every retained site;
traceback :309-345 runs on kept sites only). A job is (read row, strand,
window start); the window is C reference bases from flat position
``wstart`` with C one of two widths:

- narrow: L + 2*PAD + 16
- wide:   L + 2*PAD + 448

Scores go through the score kernel and traces through the fill kernel
plus the full-length walk (ops/msa.py). Trace jobs run in chunks bounded
by the device's prev-code budget (``backend.prev_code_budget``) over the
bytes a job's prev codes take there (``_trace_ladder``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..backend import prev_code_budget
from ..ops import msa, msa_kernels
from .quickmap_device import DeviceIndex, extract_ref_codes

I32 = torch.int32
SLOW_ALIGN_PADDING = 4
NARROW_SPREAD = 16
WIDE_SPREAD = 448
TRACE_CHUNKS = (2048, 1024, 512)
TRACE_CHUNKS_W = (1024,)


def _trace_ladder(L: int, C: int, ladder, device):
    """Memory-aware trace-chunk ladder: the rungs of ``ladder`` that fit
    the device's prev-code budget at the bytes a job's prev codes take in
    the fill's layout there; always at least chunk size 8."""
    cap = max(8, prev_code_budget(device)
              // msa_kernels.prev_code_bytes(L, C, device))
    out = tuple(c for c in ladder if c <= cap)
    if not out:
        c = 8
        while c * 2 <= cap:
            c *= 2
        out = (c,)
    return out


def _codes_to_ascii_dev(codes: torch.Tensor, is_n: torch.Tensor):
    """2-bit genome codes -> ASCII bases (N for undefined/out of range)."""
    c = codes.to(I32)
    a = 65 + 2 * c + 2 * (c >= 2).to(I32) + 11 * (c == 3).to(I32)
    return torch.where(is_n, 78, a).to(torch.uint8)


def make_programs(L: int, dindex: DeviceIndex, profile=None):
    """The four programs for read length L: 'score_n', 'score_w',
    'trace_n', 'trace_w', each taking (reads (J, L) uint8 ASCII numpy,
    wstart (J,) int32 numpy) and returning device tensors."""
    if profile is None:
        from ..core.constants import SHORT_PROFILE
        profile = SHORT_PROFILE
    dev = dindex.device

    def build(C: int, trace: bool):
        def prog(reads: np.ndarray, wstart: np.ndarray):
            rd = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
            ws = torch.from_numpy(wstart.astype(np.int32)).to(dev)
            codes, isn = extract_ref_codes(dindex.gpack, dindex.nmask, ws,
                                           C, dindex.G)
            refs = _codes_to_ascii_dev(codes, isn)
            if trace:
                return msa.msa_align_batch(rd, refs, profile)
            return msa.msa_score_batch(rd, refs, profile)
        return prog

    Cn = L + 2 * SLOW_ALIGN_PADDING + NARROW_SPREAD
    Cw = L + 2 * SLOW_ALIGN_PADDING + WIDE_SPREAD
    return {
        "Cn": Cn, "Cw": Cw, "device": dev,
        "score_n": build(Cn, False),
        "score_w": build(Cw, False),
        "trace_n": build(Cn, True),
        "trace_w": build(Cw, True),
    }


def score_jobs(progs: Dict, reads: np.ndarray, wstart: np.ndarray,
               wide: np.ndarray) -> np.ndarray:
    """Score all jobs (reads (J, L) ASCII oriented to the window strand,
    wstart flat genome coords, wide bool per job). Returns scores (J,)
    int64."""
    out = np.full(len(wstart), -(2 ** 30), np.int64)
    for is_wide, key in ((False, "score_n"), (True, "score_w")):
        rows = np.nonzero(wide == is_wide)[0]
        if not len(rows):
            continue
        sc, _col, _st = progs[key](reads[rows], wstart[rows])
        out[rows] = sc.cpu().numpy().astype(np.int64)
    return out


def trace_jobs(progs: Dict, reads: np.ndarray, wstart: np.ndarray,
               wide: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """Fill + traceback for winner jobs. Returns host arrays (symbols
    (J, L+Cw) uint8 reversed, out_len (J,), gaps (J,), score (J,) int64,
    col (J,)) aligned to the input job order; narrow-window symbol rows
    are zero-padded to the wide width."""
    J, L = len(wstart), reads.shape[1]
    Cw = progs["Cw"]
    sym = np.zeros((J, L + Cw), np.uint8)
    ln = np.zeros(J, np.int32)
    gaps = np.zeros(J, np.int32)
    score = np.full(J, -(2 ** 30), np.int64)
    col = np.zeros(J, np.int32)
    for is_wide, key, ladder0 in ((False, "trace_n", TRACE_CHUNKS),
                                  (True, "trace_w", TRACE_CHUNKS_W)):
        C = Cw if is_wide else progs["Cn"]
        chunk = _trace_ladder(L, C, ladder0, progs["device"])[0]
        rows = np.nonzero(wide == is_wide)[0]
        for a in range(0, len(rows), chunk):
            sel = rows[a:a + chunk]
            s_, l_, g_, sc_, c_, _st = progs[key](reads[sel], wstart[sel])
            s_h = s_.cpu().numpy()
            sym[sel, :s_h.shape[1]] = s_h
            ln[sel] = l_.cpu().numpy()
            gaps[sel] = g_.cpu().numpy()
            score[sel] = sc_.cpu().numpy().astype(np.int64)
            col[sel] = c_.cpu().numpy()
    return sym, ln, gaps, score, col
