"""Gapless (no-indel) scoring and match generation, vectorized over a batch
(PyTorch port of bbmap_tpu/align/gapless.py; its numpy half is copied
verbatim below because the original module imports jax further down).

Clone of the reference's scoreNoIndels / genMatchNoIndels semantics
(reference: align2/MultiStateAligner11ts.java:1885-1975): run-length
streak scoring where N positions contribute 0 points and do NOT interrupt
the match/sub streak (mode and timeInMode persist across N runs).

This is the reference's main DP-avoidance path: a site whose gapless score
is >= maxImperfectScore cannot be beaten by any indel alignment, so the
full DP is skipped (reference: align2/AbstractMapThread.java:1252).
Vectorized here as run-length encoding over the N-filtered positions —
one pass of numpy ops for an entire candidate batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.constants import (POINTS_MATCH, POINTS_MATCH2,
                                      POINTS_NOCALL, POINTS_NOREF,
                                      POINTS_SUB, POINTS_SUB2, POINTS_SUB3,
                                      POINTS_SUB_ARRAY)

_N = ord("N")


def score_no_indels_flat(reads: np.ndarray, lengths: np.ndarray,
                         genome: np.ndarray,
                         ref_starts: np.ndarray,
                         prof=None) -> np.ndarray:
    """Score J gapless alignments.

    reads: (J, Lmax) ASCII; lengths: (J,); genome: flat ASCII genome;
    ref_starts: (J,) flat genome position aligned to read base 0.
    Returns int32 scores. Positions outside the genome score POINTS_NOREF
    (reference: :1902-1913)."""
    PM, PM2, PSUB, PSUB2, PSUB3, LIM3 = (
        (POINTS_MATCH, POINTS_MATCH2, POINTS_SUB, POINTS_SUB2,
         POINTS_SUB3, 5) if prof is None else
        (prof.POINTS_MATCH, prof.POINTS_MATCH2, prof.POINTS_SUB,
         prof.POINTS_SUB2, prof.POINTS_SUB3, prof.LIMIT_FOR_COST_3))
    J, Lmax = reads.shape
    G = len(genome)
    pos = ref_starts[:, None] + np.arange(Lmax)[None, :]
    inb = (pos >= 0) & (pos < G)
    refs = np.full((J, Lmax), _N, np.uint8)
    refs[inb] = genome[pos[inb].astype(np.int64)]
    valid = np.arange(Lmax)[None, :] < lengths[:, None]

    c = reads
    r = refs
    is_match = (c == r) & (c != _N) & valid & inb
    is_nocall = (c == _N) & valid
    is_noref = (~is_match) & (~is_nocall) & (r == _N) & valid & inb
    out_of_bounds = valid & ~inb
    is_skip = is_nocall | is_noref | out_of_bounds
    is_sub = valid & ~is_match & ~is_skip

    # run-length scoring over the N-filtered subsequence of each row
    flat_keep = (valid & ~is_skip)
    kind = np.where(is_match, 0, 1)  # only meaningful where flat_keep

    rows, cols = np.nonzero(flat_keep)
    if len(rows) == 0:
        return np.zeros(J, np.int32)
    kinds = kind[rows, cols]
    # run boundaries: row change or kind change
    newrun = np.ones(len(rows), bool)
    newrun[1:] = (rows[1:] != rows[:-1]) | (kinds[1:] != kinds[:-1])
    run_id = np.cumsum(newrun) - 1
    run_start = np.zeros(run_id[-1] + 1, np.int64)
    run_start[run_id[newrun]] = np.nonzero(newrun)[0]
    pos_in_run = np.arange(len(rows)) - run_start[run_id]

    sub_i = pos_in_run + 1
    sub_pts = np.where(sub_i > LIM3, PSUB3,
                       np.where(sub_i > 1, PSUB2, PSUB))
    pts = np.where(kinds == 0,
                   np.where(pos_in_run == 0, PM, PM2), sub_pts)
    scores = np.zeros(J, np.int64)
    np.add.at(scores, rows, pts)
    # NOCALL/NOREF points are 0 with default constants; kept for clarity
    if POINTS_NOCALL:
        scores += POINTS_NOCALL * is_nocall.sum(1)
    if POINTS_NOREF:
        scores += POINTS_NOREF * (is_noref.sum(1) + out_of_bounds.sum(1))
    return scores.astype(np.int32)


def gen_match_no_indels(read: np.ndarray, genome: np.ndarray,
                        ref_start: int) -> bytes:
    """reference: align2/MultiStateAligner11ts.genMatchNoIndels:1956-1972.
    m/S/N per position; out-of-genome ref counts as N."""
    L = len(read)
    pos = ref_start + np.arange(L)
    inb = (pos >= 0) & (pos < len(genome))
    r = np.full(L, _N, np.uint8)
    r[inb] = genome[pos[inb]]
    out = np.where((read == _N) | (r == _N), ord("N"),
                   np.where(read == r, ord("m"), ord("S"))).astype(np.uint8)
    return bytes(out)




def gather_ref_rows(genome: np.ndarray, ref_starts: np.ndarray,
                    L: int) -> np.ndarray:
    """(J,) flat starts -> (J, L) ASCII ref rows, 'N' outside."""
    J = len(ref_starts)
    G = len(genome)
    starts = np.asarray(ref_starts, np.int64)
    # fast path: all rows fully inside the genome (the common case —
    # avoids the 2x boolean masks and masked fancy assignment)
    if J and starts.min() >= 0 and starts.max() + L <= G:
        pos = (starts[:, None] + np.arange(L, dtype=np.int64)[None, :])
        return genome[pos]
    pos = starts[:, None] + np.arange(L)[None, :]
    inb = (pos >= 0) & (pos < G)
    out = np.full((J, L), _N, np.uint8)
    out[inb] = genome[pos[inb]]
    return out


def gen_match_no_indels_batch(reads: np.ndarray,
                              refs: np.ndarray) -> np.ndarray:
    """(J, L) reads/refs -> (J, L) match symbols (m/S/N), vectorized
    (reference: genMatchNoIndels:1956-1972)."""
    return np.where((reads == _N) | (refs == _N), ord("N"),
                    np.where(reads == refs, ord("m"),
                             ord("S"))).astype(np.uint8)


# ---------------------------------------------------------------------------
# Device (PyTorch) gapless scorers — same semantics as score_no_indels_flat.
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from ..core.constants import LIMIT_FOR_COST_3 as _LIM3  # noqa: E402

_MODE_NONE, _MODE_MS, _MODE_SUB = 0, 1, 2


def _points(prof):
    return ((POINTS_MATCH, POINTS_MATCH2, POINTS_SUB, POINTS_SUB2,
             POINTS_SUB3, _LIM3) if prof is None else
            (prof.POINTS_MATCH, prof.POINTS_MATCH2, prof.POINTS_SUB,
             prof.POINTS_SUB2, prof.POINTS_SUB3, prof.LIMIT_FOR_COST_3))


def score_no_indels(reads: torch.Tensor, refs: torch.Tensor,
                    prof=None) -> torch.Tensor:
    """reads, refs: (J, L) uint8 ASCII on one device (refs pre-gathered at
    each candidate's diagonal, out-of-genome positions as 'N'). Returns
    (J,) int32 scores: a loop over read positions with every candidate in
    the batch dimension (reference: scoreNoIndels :1885-1952)."""
    PM, PM2, PS, PS2, PS3, LIM3 = _points(prof)
    J, L = reads.shape
    dev = reads.device
    i32 = torch.int32
    score = torch.zeros(J, dtype=i32, device=dev)
    mode = torch.full((J,), _MODE_NONE, dtype=i32, device=dev)
    t = torch.zeros(J, dtype=i32, device=dev)
    rd = reads.to(i32)
    rf = refs.to(i32)
    for j in range(L):
        c, r = rd[:, j], rf[:, j]
        is_match = (c == r) & (c != _N)
        is_nocall = c == _N
        is_noref = ~is_match & ~is_nocall & (r == _N)
        is_sub = ~is_match & ~is_nocall & ~is_noref
        in_ms = mode == _MODE_MS
        m_pts = torch.where(in_ms, PM2, PM)
        new_t_m = torch.where(in_ms, t + 1, 0)
        s_t = torch.where(mode == _MODE_SUB, t + 1, 0)
        s_pts = torch.where(s_t + 1 > LIM3, PS3,
                            torch.where(s_t + 1 > 1, PS2, PS))
        score = score + torch.where(is_match, m_pts,
                                    torch.where(is_sub, s_pts, 0)).to(i32)
        mode = torch.where(is_match, _MODE_MS,
                           torch.where(is_sub, _MODE_SUB, mode)).to(i32)
        t = torch.where(is_match, new_t_m,
                        torch.where(is_sub, s_t, t)).to(i32)
    return score


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def score_match_sub_vec(is_match: torch.Tensor, is_sub: torch.Tensor,
                        prof=None) -> torch.Tensor:
    """Closed-form gapless streak scoring (no sequential loop), same
    semantics as score_no_indels: skip positions (neither match nor sub)
    are transparent to the match/sub run state. Runs are recovered with
    running maxima of the last-match / last-sub indices. is_match/is_sub:
    bool (..., L), mutually exclusive. Returns int32 scores (...,)."""
    PM, PM2, PS, PS2, PS3, LIM3 = _points(prof)
    L = is_match.shape[-1]
    i32 = torch.int32
    l_ = torch.arange(L, dtype=i32, device=is_match.device)
    lm = torch.where(is_match, l_, -1).to(i32)
    ls = torch.where(is_sub, l_, -1).to(i32)
    cm = torch.cummax(lm, dim=-1).values
    cs = torch.cummax(ls, dim=-1).values
    pm = _shift_right(cm, -1)
    ps = _shift_right(cs, -1)
    prev_is_match = pm > ps
    prev_is_sub = ps > pm
    m_start = is_match & ~prev_is_match
    s_start = is_sub & ~prev_is_sub
    ns = is_match | is_sub
    r = torch.cumsum(ns.to(i32), dim=-1, dtype=i32)
    rstart = torch.cummax(torch.where(s_start, r, 0).to(i32), dim=-1).values
    p = r - rstart + 1
    sub_pts = torch.where(p <= 1, PS, torch.where(p <= LIM3, PS2, PS3))
    pts = torch.where(is_match, torch.where(m_start, PM, PM2),
                      torch.where(is_sub, sub_pts, 0)).to(i32)
    return torch.sum(pts, dim=-1, dtype=i32)
