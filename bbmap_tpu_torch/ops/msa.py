"""Plain PyTorch form of the multi-state banded affine DP, the traceback
walk, and the batched entry points the aligner calls.

Counterpart of ``bbmap_tpu/ops/msa_jax.py``: the same anti-diagonal
("wave") formulation with packed int32 ``score << SCOREOFFSET | streak``
cells, bit-identical to the reference scoring
(reference: align2/MultiStateAligner11ts.java:623-866). Wave ``d`` holds
cells (r, c = d - r) for r in [0, R]:

  MS(r, c)  <- wave d-2, r-1   (diagonal)
  DEL(r, c) <- wave d-1, r     (left)
  INS(r, c) <- wave d-1, r-1   (up)

``dp_plain`` sweeps the waves with one batched tensor step per wave; it is
the plain version of the hand-written CUDA kernels in
``ops/msa_kernels.py`` (score and fill), as ``walk_plain`` is of the walk
kernel. The entry points here (``msa_score_batch``, ``msa_align_batch``,
``walk``) always go through those kernel wrappers, which run the plain
versions only for tensors on the CPU.
Prev-state codes, one byte ``ms | del << 2 | ins << 4`` a cell, come in
two layouts, both affine in (r, c) and named by a ``PrevLayout``:
wave-major (B, R+C, R+1), ``prevs[b, d-1, r]`` for cell (r, d - r), which
the short mappings write coalesced, and row-major (B, R+1, pitch),
``prevs[b, r, c]``, which the band mapping of the long-read shapes writes
in whole words. The walks take either.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.constants import (GAPC, GAPLEN, MODE_DEL, MODE_INS,
                                      MODE_MS, SHORT_PROFILE, ScoringProfile)

_N = ord("N")
I32 = torch.int32
NEG_INF = -(2 ** 31) + 2


class PrevLayout(NamedTuple):
    """Where a job's block of prev codes keeps cell (r, c): at byte
    ``base + r * row + c * col``. Defined for 1 <= r <= R, 1 <= c <= C."""
    base: int
    row: int
    col: int


def prev_pitch(C: int) -> int:
    """Bytes a row of the row-major block takes: C + 1 rounded up to 16."""
    return (C + 16) // 16 * 16


def wave_major(R: int, C: int) -> PrevLayout:
    """Block (R+C, R+1): cell (r, c) at byte (r + c - 1, r)."""
    return PrevLayout(-(R + 1), R + 2, R + 1)


def row_major(R: int, C: int) -> PrevLayout:
    """Block (R+1, prev_pitch(C)): cell (r, c) at byte (r, c)."""
    return PrevLayout(0, prev_pitch(C), 1)


def prev_block_shape(R: int, C: int, layout: PrevLayout) -> Tuple[int, int]:
    """A job's block in one of the two layouts."""
    if layout == wave_major(R, C):
        return (R + C, R + 1)
    if layout == row_major(R, C):
        return (R + 1, prev_pitch(C))
    raise ValueError(f"{layout} is neither layout of (R, C) = ({R}, {C})")


def cell_view(prevs: torch.Tensor, R: int, C: int,
              layout: Optional[PrevLayout] = None) -> torch.Tensor:
    """The prev codes of cells 1 <= r <= R, 1 <= c <= C as a (B, R, C)
    view of a block in ``layout`` (default wave-major): ``[b, r-1, c-1]``."""
    lay = layout or wave_major(R, C)
    if tuple(prevs.shape[1:]) != prev_block_shape(R, C, lay):
        raise ValueError(f"prevs {tuple(prevs.shape)} is no block of "
                         f"(R, C) = ({R}, {C}) in {lay}")
    return torch.as_strided(prevs, (prevs.shape[0], R, C),
                            (prevs.stride(0), lay.row, lay.col),
                            prevs.storage_offset() + lay.base + lay.row
                            + lay.col)


def _ins0_column(R: int, P: ScoringProfile) -> np.ndarray:
    """Cumulative insertion penalty for column 0 (reference ctor :95-104)."""
    ins_off = np.zeros(R + 2, np.int64)
    for i in range(1, R + 2):
        if i > P.LIMIT_FOR_COST_4:
            ins_off[i] = P.POINTSoff_INS4
        elif i > P.LIMIT_FOR_COST_3:
            ins_off[i] = P.POINTSoff_INS3
        elif i > 1:
            ins_off[i] = P.POINTSoff_INS2
        else:
            ins_off[i] = P.POINTSoff_INS
    col = np.zeros(R + 1, np.int64)
    for i in range(R + 1):
        prev = 0 if i < 2 else col[i - 1]
        col[i] = prev + ins_off[i]
    return col.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _ins0_np(R: int, P: ScoringProfile = SHORT_PROFILE) -> np.ndarray:
    return _ins0_column(R, P)


def dp_plain(reads: torch.Tensor, refs: torch.Tensor, rows: torch.Tensor,
             P: ScoringProfile, want_prevs: bool,
             layout: Optional[PrevLayout] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain batched DP. reads (B, R) uint8 ASCII, refs (B, C) uint8
    ASCII, rows (B,) int32 per-job row count (<= R). Returns
    (out (3, B) int32 [score >> SCOREOFFSET, col, state], prevs uint8 or
    None): wave-major (B, R+C, R+1) unless ``layout`` is
    ``row_major(R, C)``, then the same codes permuted into
    (B, R+1, pitch), zero outside cells (1..R, 1..C)."""
    dev = reads.device
    B, R = reads.shape
    C = refs.shape[1]
    Rp1 = R + 1
    SM = ~P.TIMEMASK
    TM = P.TIMEMASK

    def i32(x):
        return torch.tensor(x, dtype=I32, device=dev)

    q = ord("?")
    read1 = torch.full((B, Rp1), q, dtype=I32, device=dev)
    read1[:, 1:] = reads.to(I32)
    read0 = torch.full((B, Rp1), q, dtype=I32, device=dev)
    read0[:, 2:] = reads[:, :-1].to(I32)
    refp = torch.full((B, C + 2 * Rp1), ord("!"), dtype=I32, device=dev)
    refp[:, Rp1:Rp1 + C] = refs.to(I32)
    rows_c = rows.to(I32).reshape(B, 1)
    r_idx = torch.arange(Rp1, dtype=I32, device=dev).reshape(1, Rp1)
    ar_r = torch.arange(Rp1, device=dev)
    maxGain = (rows_c - 1) * P.POINTSoff_MATCH2 + P.POINTSoff_MATCH
    subfloor = (-2 * maxGain).to(I32)
    ins0 = torch.as_tensor(_ins0_np(R, P), device=dev).reshape(1, Rp1)
    bad = i32(P.BADoff)
    zero = i32(0)
    one = i32(1)

    w0 = torch.where(r_idx == 0, zero, bad).expand(B, Rp1)
    p1 = [w0.clone(), w0.clone(), w0.clone()]      # wave d-1
    badw = torch.full((B, Rp1), P.BADoff, dtype=I32, device=dev)
    p2 = [badw.clone(), badw.clone(), badw.clone()]  # wave d-2
    best_s = torch.full((3, B), NEG_INF, dtype=I32, device=dev)
    best_c = torch.zeros((3, B), dtype=I32, device=dev)
    prevs = torch.empty((B, R + C, Rp1), dtype=torch.uint8,
                        device=dev) if want_prevs else None
    rows_g = rows.to(torch.int64).clamp(0, R).reshape(B, 1)

    def sub_array(i):
        return torch.where(
            i > P.LIMIT_FOR_COST_3, i32(P.POINTSoff_SUB3),
            torch.where(i > 1, i32(P.POINTSoff_SUB2), i32(P.POINTSoff_SUB)))

    def ins_array(i):
        return torch.where(
            i > P.LIMIT_FOR_COST_4, i32(P.POINTSoff_INS4),
            torch.where(i > P.LIMIT_FOR_COST_3, i32(P.POINTSoff_INS3),
                        torch.where(i > 1, i32(P.POINTSoff_INS2),
                                    i32(P.POINTSoff_INS))))

    def del_ext(s):
        return torch.where(
            s == 0, i32(P.POINTSoff_DEL),
            torch.where(
                s < P.LIMIT_FOR_COST_3, i32(P.POINTSoff_DEL2),
                torch.where(
                    s < P.LIMIT_FOR_COST_4, i32(P.POINTSoff_DEL3),
                    torch.where(s < P.LIMIT_FOR_COST_5,
                                i32(P.POINTSoff_DEL4),
                                torch.where((s & P.MASK5) == 0,
                                            i32(P.POINTSoff_DEL5), zero)))))

    def clamp_time(t):
        return torch.where(t > P.MAX_TIME, i32(P.MAX_TIME - P.MASK5), t)

    for d in range(1, R + C + 1):
        c_idx = d - r_idx
        idx = Rp1 + d - 1 - ar_r
        ref1 = refp[:, idx]
        ref0 = refp[:, idx - 1]
        match = (read1 == ref1) & (ref1 != _N)
        pm = (read0 == ref0) & (ref0 != _N)
        gap = ref1 == GAPC

        ms_dd = torch.roll(p2[MODE_MS], 1, dims=1)
        del_dd = torch.roll(p2[MODE_DEL], 1, dims=1)
        ins_dd = torch.roll(p2[MODE_INS], 1, dims=1)
        ms_left, del_left = p1[MODE_MS], p1[MODE_DEL]
        ms_up = torch.roll(p1[MODE_MS], 1, dims=1)
        ins_up = torch.roll(p1[MODE_INS], 1, dims=1)

        s_diag, s_del, s_ins = ms_dd & SM, del_dd & SM, ins_dd & SM
        streak = ms_dd & TM
        m_ms = s_diag + torch.where(pm, i32(P.POINTSoff_MATCH2),
                                    i32(P.POINTSoff_MATCH))
        m_d = s_del + P.POINTSoff_MATCH
        m_i = s_ins + P.POINTSoff_MATCH
        m_best = torch.maximum(m_ms, torch.maximum(m_d, m_i))
        m_from_ms = (m_ms >= m_d) & (m_ms >= m_i)
        m_time = torch.where(m_from_ms & pm, streak + 1, one)
        sub_pen = torch.where(
            pm, torch.where(streak <= 1, i32(P.POINTSoff_SUBR),
                            i32(P.POINTSoff_SUB)),
            sub_array(streak + 1))
        x_ms = torch.where((ref1 != _N) & (read1 != _N), s_diag + sub_pen,
                           s_diag + P.POINTSoff_NOCALL)
        x_d = s_del + P.POINTSoff_SUB
        x_i = s_ins + P.POINTSoff_SUB
        x_best = torch.maximum(x_ms, torch.maximum(x_d, x_i))
        x_from_ms = (x_ms >= x_d) & (x_ms >= x_i)
        x_time = torch.where(x_from_ms, torch.where(pm, one, streak + 1),
                             one)
        ms_score = torch.where(match, m_best, x_best)
        ms_time = clamp_time(torch.where(match, m_time, x_time))
        ms_val = torch.where(gap, subfloor.expand(B, Rp1),
                             ms_score | ms_time)

        dstreak = del_left & TM
        d_ms = (ms_left & SM) + P.POINTSoff_DEL
        d_d = (del_left & SM) + del_ext(dstreak)
        refn_adj = torch.where(ref1 == _N, i32(P.POINTSoff_DEL_REF_N),
                               torch.where(gap, i32(P.POINTSoff_GAP), zero))
        d_ms = d_ms + refn_adj
        d_d = d_d + refn_adj
        del_score = torch.maximum(d_ms, d_d)
        del_time = clamp_time(torch.where(d_ms >= d_d, one, dstreak + 1))
        del_barrier = (r_idx < P.BARRIER_D1) | (r_idx > rows_c
                                                 - P.BARRIER_D1)
        del_val = torch.where(del_barrier, subfloor.expand(B, Rp1),
                              del_score | del_time)

        istreak = ins_up & TM
        i_ms = (ms_up & SM) + P.POINTSoff_INS
        i_i = (ins_up & SM) + ins_array(istreak + 1)
        ins_score = torch.maximum(i_ms, i_i)
        ins_time = clamp_time(torch.where(i_ms >= i_i, one, istreak + 1))
        ins_barrier = gap | ((r_idx < P.BARRIER_I1) & (c_idx > 1)) | (
            (r_idx > rows_c - P.BARRIER_I1) & (c_idx < C - 1))
        ins_val = torch.where(ins_barrier, subfloor.expand(B, Rp1),
                              ins_score | ins_time)

        is_row0 = r_idx == 0
        is_col0 = r_idx == d
        use_bound = is_row0 | is_col0
        bound = torch.where(is_row0, zero, torch.where(is_col0, ins0, zero))
        invalid = (c_idx < 0) | (c_idx > C) | (r_idx > rows_c)
        wave = []
        for v in (ms_val, del_val, ins_val):
            v = torch.where(use_bound, bound.expand(B, Rp1), v)
            wave.append(torch.where(invalid, bad, v))

        if want_prevs:
            ms_arg = torch.where((s_diag >= s_del) & (s_diag >= s_ins),
                                 i32(MODE_MS),
                                 torch.where(s_del >= s_ins, i32(MODE_DEL),
                                             i32(MODE_INS)))
            ms_prev = torch.where(ms_time > 1, i32(MODE_MS), ms_arg)
            del_arg = torch.where((ms_left & SM) >= (del_left & SM),
                                  i32(MODE_MS), i32(MODE_DEL))
            del_prev = torch.where(del_time > 1, i32(MODE_DEL), del_arg)
            ins_arg = torch.where((ms_up & SM) >= (ins_up & SM),
                                  i32(MODE_MS), i32(MODE_INS))
            ins_prev = torch.where(ins_time > 1, i32(MODE_INS), ins_arg)
            prevs[:, d - 1, :] = (ms_prev | (del_prev << 2)
                                  | (ins_prev << 4)).to(torch.uint8)

        val = torch.stack([torch.gather(w, 1, rows_g)[:, 0] & SM
                           for w in wave])                  # (3, B)
        col = (d - rows_c[:, 0]).reshape(1, B)
        on_last = (col >= 1) & (col <= C)
        take = on_last & (val > best_s)
        best_s = torch.where(take, val, best_s)
        best_c = torch.where(take, col.expand(3, B), best_c)
        p2 = p1
        p1 = wave

    b0, b1, b2 = best_s[0], best_s[1], best_s[2]
    state = torch.where((b0 >= b1) & (b0 >= b2), i32(0),
                        torch.where(b1 >= b2, i32(1), i32(2)))
    score = torch.where(state == 0, b0, torch.where(state == 1, b1, b2))
    colf = torch.where(state == 0, best_c[0],
                       torch.where(state == 1, best_c[1], best_c[2]))
    out = torch.stack([score >> P.SCOREOFFSET, colf, state]).to(I32)
    if want_prevs and layout is not None and layout != wave_major(R, C):
        block = torch.zeros((B, *prev_block_shape(R, C, layout)),
                            dtype=torch.uint8, device=dev)
        if B:
            cell_view(block, R, C, layout).copy_(cell_view(prevs, R, C))
        prevs = block
    return out, prevs


_DEFINED_TABLE = np.zeros(256, np.bool_)
for _c in b"ACGTU":
    _DEFINED_TABLE[_c] = True


def walk_plain(prevs: torch.Tensor, reads: torch.Tensor,
               refs: torch.Tensor, col0: torch.Tensor, st0: torch.Tensor,
               R: int, C: int, steps: int = 0,
               layout: Optional[PrevLayout] = None):
    """Batched traceback walk over prev codes, one tensor step per walk
    step (port of msa_jax._walk_device); the plain version of the walk
    kernel. prevs uint8: a block of B jobs in ``layout`` (default
    wave-major, (B, R+C, R+1)). Returns (symbols
    (B, steps) uint8 in reverse order, out_len (B,), gaps (B,), row_end
    (B,)), all int32 but the symbols. ``steps`` (default R + C, the hard
    maximum) bounds the serial loop; a walk with row_end > 0 was cut."""
    dev = prevs.device
    B = prevs.shape[0]
    n = steps if steps else R + C
    defined = torch.as_tensor(_DEFINED_TABLE, device=dev)
    read_i = reads.to(I32)
    ref_i = refs.to(I32)
    read_prop = (read_i | (defined[reads.long()].to(I32) << 8)).reshape(-1)
    ref_prop = (ref_i | (defined[refs.long()].to(I32) << 8)
                | ((ref_i == GAPC).to(I32) << 9)).reshape(-1)
    flat_prevs = prevs.reshape(-1)
    jb = torch.arange(B, device=dev, dtype=torch.int64)
    lay = layout or wave_major(R, C)
    base_p = jb * (prevs.shape[1] * prevs.shape[2]) + lay.base
    base_r = jb * R
    base_f = jb * C
    row = torch.full((B,), R, dtype=I32, device=dev)
    col = col0.to(I32).clone()
    st = st0.to(I32).clone()
    gaps = torch.zeros(B, dtype=I32, device=dev)
    syms = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    m_, S_, N_ = ord("m"), ord("S"), ord("N")
    for i in range(n):
        main = (row > 0) & (col > 0)
        xpad = (row > 0) & (col <= 0)
        ri = row.clamp(1, R).long()
        ci = col.clamp(1, C).long()
        code = flat_prevs[base_p + ri * lay.row + ci * lay.col].to(I32)
        prev = (code >> (2 * st)) & 3
        rp = read_prop[base_r + (row - 1).clamp(min=0).long()]
        fp = ref_prop[base_f + (col - 1).clamp(0, C - 1).long()]
        c_ = rp & 255
        r_ = fp & 255
        both_def = ((rp & 256) > 0) & ((fp & 256) > 0)
        sym_ms = torch.where(c_ == r_, m_, torch.where(both_def, S_, N_))
        is_gap = (fp & 512) > 0
        sym_del = torch.where(is_gap, ord("-"), ord("D"))
        sym_ins = torch.where(col >= C, ord("Y"), ord("I"))
        sym = torch.where(st == MODE_MS, sym_ms,
                          torch.where(st == MODE_DEL, sym_del, sym_ins))
        sym = torch.where(xpad, ord("X"), sym)
        act = main | xpad
        syms[:, i] = torch.where(act, sym, 0).to(torch.uint8)
        gaps = gaps + (main & (st == MODE_DEL) & is_gap).to(I32)
        drow = (main & (st != MODE_DEL)).to(I32) + xpad.to(I32)
        dcol = (main & (st != MODE_INS)).to(I32) + xpad.to(I32)
        st = torch.where(main, prev, st)
        row = row - drow
        col = col - dcol
    outpos = (syms != 0).sum(dim=1).to(I32)
    return syms, outpos, gaps, row


def walk(prevs: torch.Tensor, reads: torch.Tensor, refs: torch.Tensor,
         col0: torch.Tensor, st0: torch.Tensor, R: int, C: int,
         steps: int = 0, layout: Optional[PrevLayout] = None):
    """Batched traceback walk (``msa_kernels.msa_walk``): the walk kernel
    on CUDA tensors, ``walk_plain`` on CPU tensors. Same returns."""
    from . import msa_kernels
    return msa_kernels.msa_walk(prevs, reads, refs, col0, st0, R, C, steps,
                                layout)


def _full_rows(B: int, R: int, dev) -> torch.Tensor:
    return torch.full((B,), R, dtype=I32, device=dev)


def msa_score_batch(reads, refs, P: ScoringProfile = SHORT_PROFILE):
    """Score pass over (B, R) reads and (B, C) windows, every job with R
    rows. Returns (score, col, state), each (B,) int32."""
    from . import msa_kernels
    B, R = reads.shape
    out = msa_kernels.msa_score(reads, refs, _full_rows(B, R, reads.device),
                                P)
    return out[0], out[1], out[2]


def msa_align_batch(reads, refs, P: ScoringProfile = SHORT_PROFILE):
    """Fill + full-length traceback walk (steps = R + C). Returns
    (symbols (B, R+C) uint8 in reverse order, lengths, gaps, scores,
    cols, states)."""
    from . import msa_kernels
    B, R = reads.shape
    C = refs.shape[1]
    out, prevs, layout = msa_kernels.msa_fill(
        reads, refs, _full_rows(B, R, reads.device), P)
    sym, ln, gaps, _row = walk(prevs, reads, refs, out[1], out[2], R, C,
                               layout=layout)
    return sym, ln, gaps, out[0], out[1], out[2]


def traceback_prevs(read: np.ndarray, ref: np.ndarray, prevs: np.ndarray,
                    col: int, state: int,
                    layout: Optional[PrevLayout] = None) -> bytes:
    """Host walk over one job's block of prev codes in ``layout`` (default
    wave-major, (R+C, R+1): prevs[d-1, r] holds the packed codes of cell
    (r, c=d-r)) — identical output to the oracle traceback (reference:
    traceback2 :1102-1232)."""
    R, C = len(read), len(ref)
    lay = layout or wave_major(R, C)
    flat = np.ascontiguousarray(prevs).reshape(-1)
    row = R
    out = bytearray()
    gaps = 0
    while row > 0 and col > 0:
        code = int(flat[lay.base + row * lay.row + col * lay.col])
        prev = (code >> (2 * state)) & 3
        if state == MODE_MS:
            c, r = int(read[row - 1]), int(ref[col - 1])
            if c == r:
                out.append(ord("m"))
            elif not _defined(c) or not _defined(r):
                out.append(ord("N"))
            else:
                out.append(ord("S"))
            row -= 1
            col -= 1
        elif state == MODE_DEL:
            if ref[col - 1] == GAPC:
                out.append(ord("-"))
                gaps += 1
            else:
                out.append(ord("D"))
            col -= 1
        else:
            if col >= C:
                out.append(ord("Y"))
            else:
                out.append(ord("I"))
            row -= 1
        state = prev
    while row > 0:
        out.append(ord("X"))
        row -= 1
    out.reverse()
    if gaps == 0:
        return bytes(out)
    out3 = bytearray()
    for ch in out:
        if ch != GAPC:
            out3.append(ch)
        else:
            out3.extend(b"D" * GAPLEN)
    return bytes(out3)


def _defined(c: int) -> bool:
    return c in (ord("A"), ord("C"), ord("G"), ord("T"), ord("U"))


def finish_match(symbols_row: np.ndarray, out_len: int, gaps: int) -> bytes:
    """Host: reverse the walked symbols and expand GAPC placeholders
    (reference: traceback2 :1205-1227)."""
    out = bytes(symbols_row[:out_len][::-1])
    if gaps == 0:
        return out
    res = bytearray()
    for ch in out:
        if ch == GAPC:
            res.extend(b"D" * GAPLEN)
        else:
            res.append(ch)
    return bytes(res)
