"""Quality trimming of a read batch (the ``optimal_trim_points`` of
bbmap_tpu/tools/bbduk.py:31, which ``bbmap qtrim=`` uses; the rest of
that tool is not part of the port)."""

from __future__ import annotations

from typing import Optional

import numpy as np

PROB_ERROR = 10.0 ** (-np.arange(128) / 10.0)
NPROB = 0.75


def optimal_trim_points(bases: np.ndarray, qual: Optional[np.ndarray],
                        lengths: np.ndarray, trimq: int
                        ) -> np.ndarray:
    """Vectorized maximal-scoring-subarray quality trim
    (reference: align2/TrimRead.testOptimal). Returns (B, 2) [left, right]
    trim amounts."""
    B, Lmax = bases.shape
    if qual is None:
        return np.zeros((B, 2), np.int32)
    avg_err = PROB_ERROR[trimq]
    nprob = max(min(avg_err * 1.1, 1.0), NPROB)
    q = np.clip(qual, 0, 127)
    prob = np.where(bases == ord("N"), nprob, PROB_ERROR[q])
    delta = (avg_err - prob).astype(np.float32)
    valid = np.arange(Lmax)[None, :] < lengths[:, None]
    delta = np.where(valid, delta, 0.0)
    # Kadane via prefix sums: best window ending at i has score
    # prefix[i] - min(prefix[:i]); start = argmin position
    prefix = np.cumsum(delta, axis=1)
    prefix0 = np.concatenate([np.zeros((B, 1), np.float32), prefix], axis=1)
    runmin = np.minimum.accumulate(prefix0, axis=1)[:, :-1]
    window = prefix - runmin
    window = np.where(valid, window, -1.0)
    end = np.argmax(window, axis=1)  # first max — reference prefers longer
    # windows on ties; approximated by the first maximal end with earliest
    # min-prefix start below
    best = window[np.arange(B), end]
    # start: first index where prefix0 equals runmin at end
    tgt = runmin[np.arange(B), end]
    is_start = np.abs(prefix0[:, :-1] - tgt[:, None]) < 1e-7
    start = np.argmax(is_start, axis=1)
    left = np.where(best > 0, start, lengths)
    right = np.where(best > 0, lengths - end - 1, 0)
    return np.stack([left.astype(np.int32), right.astype(np.int32)],
                    axis=1)
