"""The pipelined-warp mapping of the DP kernels for up to 1,023 rows
(bbmap_tpu_torch/csrc/msa_dp_pipe.cu) and dp_cell's DPX form
(csrc/msa_dp.cuh), on the CPU:

- a numpy emulation of the kernel's schedule (a block a job, a warp a band
  of 32 lanes, the bands' bottom rows handed on through a ring of 64
  columns in chunks of 4 behind a published column count, the producer
  held back until its slots were read, in-window cells only, prev codes
  gathered four a word into the row-major block) against
  ``msa_score_plain`` / ``msa_fill_plain`` in out, prev codes and walk
  symbols, below 32 rows, at 150, at a band's edge and at two rows a
  lane, with N and gap columns and per-job rows below R;
- a numpy model of dp_cell's two forms (plain, and DPX: add-then-max with
  int32 wrap, predicates from the two-way maximum) against the plain cell
  model of tests/test_torch_msa.py on random and extreme packed operands;
- ``launch_shape``'s pipe shape against the launcher in the source.

Tolerance: exact everywhere (integer DP, byte codes, symbols)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.ops import msa, msa_kernels

from .test_torch_msa import PROFILES, batch_of, np_dp_cell, t

CSRC = Path(msa_kernels.__file__).resolve().parent.parent / "csrc"
I32 = np.int32
LANES = 32


class _Warp:
    """One band (one warp of a pipe block): the kernel's registers as
    numpy arrays over the 32 lanes."""

    def __init__(self, b, band, R, C, J, P):
        BAD = I32(P.BADoff)
        self.b, self.band, self.s = b, band, 0
        self.r0 = band * LANES * J + np.arange(LANES, dtype=I32) * J
        self.cells = [[np.full(LANES, BAD, I32) for _ in range(3)]
                      for _ in range(J)]
        self.car = [np.full(LANES, BAD, I32) for _ in range(3)]
        self.acc = np.zeros((J, LANES), np.uint32)
        self.best = np.full(3, msa.NEG_INF, I32)
        self.bcol = np.zeros(3, I32)
        n_rows = min(LANES * J, R + 1 - band * LANES * J)
        self.n_steps = C + -(-n_rows // J)


def pipe_schedule(reads, refs, rows, P, J, chunk=msa_kernels.PIPE_CHUNK,
                  ring=msa_kernels.PIPE_RING, seed=0):
    """The schedule of msa_dp_pipe_kernel on numpy arrays: every band of
    every job resident (a block a job), a random one takes its next step;
    a band whose next chunk is not published does not move (the consumer's
    acquire loop), nor does a band whose lane 31 would overwrite a ring
    slot the band below has not read (the producer's). The ring keeps each
    slot's column beside it, and a read of another column fails. Returns
    (out (3, B), prevs (B, R+1, pitch) row-major with 0xEE in every byte
    never stored, the steps on which a band waited)."""
    B, R = reads.shape
    C = refs.shape[1]
    SM = I32(~P.TIMEMASK)
    bands = msa_kernels.band_count(R, J)
    Cp = msa.prev_pitch(C)
    lane = np.arange(LANES, dtype=I32)
    ins0_col = msa._ins0_np(R, P)
    read_pad = np.concatenate(
        [np.full((B, 2), ord("?"), I32), reads.astype(I32),
         np.full((B, LANES * J * bands), ord("?"), I32)], axis=1)
    ref_pad = np.concatenate(
        [np.full((B, 2), ord("!"), I32), refs.astype(I32),
         np.full((B, 2), ord("!"), I32)], axis=1)
    with np.errstate(over="ignore"):
        gain = ((rows.astype(I32) - 1) * I32(P.POINTSoff_MATCH2)
                + I32(P.POINTSoff_MATCH)).astype(I32)
        subfloor = (gain * I32(-2)).astype(I32)
    produced = np.zeros((B, bands), np.int64)
    consumed = np.zeros((B, bands), np.int64)
    rings = np.zeros((B, bands, ring, 3), I32)
    ring_col = np.full((B, bands, ring), -1, np.int64)
    prevs = np.full((B, R + 1, Cp), 0xEE, np.uint8)
    out = np.zeros((3, B), I32)

    def step(st):
        b, band, s = st.b, st.band, st.s
        fed = band > 0
        feeds = band + 1 < bands and (band + 1) * LANES * J <= rows[b]
        cl = s - (LANES - 1)
        producing = feeds and 0 <= cl <= C and st.r0[-1] <= R
        if producing and cl % chunk == 0 and \
                consumed[b, band + 1] <= cl + chunk - 1 - ring:
            return False
        if fed and s % chunk == 0 and s <= C:
            if produced[b, band - 1] < min(s + chunk, C + 1):
                return False
            consumed[b, band] = s
        bottom = st.cells[J - 1]
        up = [np.concatenate([v[:1], v[:-1]]) for v in bottom]
        if fed and s <= C:                  # lane 0 reads column s
            slot = s % ring
            assert ring_col[b, band - 1, slot] == s, "stale slot"
            for k in range(3):
                up[k][0] = rings[b, band - 1, slot, k]
        c = (s - lane).astype(I32)
        active = (c >= 0) & (c <= C) & (st.r0 <= R)
        cc = np.clip(c, -1, C + 1)
        ref1, ref0 = ref_pad[b, cc + 1], ref_pad[b, cc]
        flush = ((c & 3) == 3) | (c == C)
        dd = list(st.car)
        u = [up[0], up[2]]
        for j in range(J):
            r = (st.r0 + j).astype(I32)
            do = active & (r <= R)
            own = st.cells[j]
            ins0 = np.where(c == 0, ins0_col[np.minimum(r, R)], 0)
            with np.errstate(over="ignore"):
                new, code = np_dp_cell(
                    P, r, c, C, rows[b].astype(I32), read_pad[b, r + 1],
                    read_pad[b, r], ref1, ref0, dd, own[:2], u, ins0,
                    subfloor[b])
            acc = st.acc[j] | (code.astype(np.uint32)
                               << ((c & 3) * 8).astype(np.uint32))
            st.acc[j] = np.where(do, acc, st.acc[j])
            for li in np.nonzero(do & flush)[0]:
                word = np.array([st.acc[j, li]], "<u4").view(np.uint8)
                prevs[b, r[li], (c[li] & ~3):(c[li] & ~3) + 4] = word
                st.acc[j, li] = 0
            on_last = do & (r == rows[b]) & (c >= 1)
            for li in np.nonzero(on_last)[0]:
                for k in range(3):
                    v = new[k][li] & SM
                    if v > st.best[k]:
                        st.best[k], st.bcol[k] = v, c[li]
            dd = [np.where(do, o, x) for o, x in zip(own, dd)]
            u = [np.where(do, new[0], u[0]), np.where(do, new[2], u[1])]
            st.cells[j] = [np.where(do, n_, o) for n_, o in zip(new, own)]
        if producing:
            slot = cl % ring
            for k in range(3):
                rings[b, band, slot, k] = st.cells[J - 1][k][LANES - 1]
            ring_col[b, band, slot] = cl
            if cl % chunk == chunk - 1 or cl == C:
                produced[b, band] = cl + 1
        st.car = up
        st.s += 1
        return True

    def finish(st):
        jr = rows[st.b] - st.band * LANES * J
        if rows[st.b] <= R and jr < LANES * J:
            b0, b1, b2 = st.best
            state = 0 if b0 >= b1 and b0 >= b2 else (1 if b1 >= b2 else 2)
            out[:, st.b] = (st.best[state] >> P.SCOREOFFSET,
                            st.bcol[state], state)

    running = [_Warp(b, w, R, C, J, P) for b in range(B)
               for w in range(bands) if w * LANES * J <= rows[b]]
    rng = np.random.default_rng(seed)
    waits = 0
    while running:
        st = running[rng.integers(len(running))]
        if not step(st):
            waits += 1
            assert waits < 10_000_000, "no band can move"
        elif st.s == st.n_steps:
            finish(st)
            running.remove(st)
    return out, prevs, waits


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R, C, B, ring", [
    (20, 44, 3, msa_kernels.PIPE_RING),     # one band, below 32 rows
    (63, 90, 3, msa_kernels.PIPE_RING),     # two full bands: a band's edge
    (64, 80, 2, 16),      # a band of one row below them; a small ring
    (150, 174, 2, msa_kernels.PIPE_RING),   # the narrow window, 5 bands
    (150, 174, 1, 16),    # the producers held back by a small ring
    (600, 640, 1, msa_kernels.PIPE_RING),   # two rows a lane, 10 bands
])
def test_pipe_schedule_matches_plain(R, C, B, ring, prof):
    """The pipe schedule equals msa_score_plain / msa_fill_plain in out
    and, through the stride map of the row-major block, in the prev codes
    of every valid cell, and the walks over its block equal the walks over
    the plain fill's: N and gap columns, per-job rows below R (bands past
    a job's last row leave at once), any interleaving of the bands."""
    P = PROFILES[prof]
    shape = msa_kernels.launch_shape(R, C, "pipe")
    J = shape.rows_per_thread
    assert J == (1 if R <= msa_kernels.PIPE_ONE_ROW_MAX else 2)
    reads, refs, rows = batch_of(R + C, B, R, C, gap=True)
    rows[0] = R                             # a job the walks can start in
    if B > 1:
        rows[1] = max(0, R - LANES * J - 1)   # a band below the last row
        reads[1, rows[1]:] = ord("N")
    out, prevs, waits = pipe_schedule(reads, refs, rows, P, J, ring=ring,
                                      seed=R)
    want = msa_kernels.msa_score_plain(t(reads), t(refs), t(rows), P)
    np.testing.assert_array_equal(out, want.numpy())
    fout, fpv, flay = msa_kernels.msa_fill_plain(t(reads), t(refs), t(rows),
                                                 P)
    np.testing.assert_array_equal(out, fout.numpy())
    lay = msa.row_major(R, C)
    got_cells = msa.cell_view(t(prevs), R, C, lay).numpy()
    want_cells = msa.cell_view(fpv, R, C, flay).numpy()
    valid = (np.arange(1, R + 1)[None, :, None] <= rows[:, None, None]
             ).repeat(C, 2)
    np.testing.assert_array_equal(got_cells[valid], want_cells[valid])
    # the walks start at row R: the jobs of R rows (the codes of the rows
    # below a job's last row are not defined)
    full = torch.from_numpy(np.nonzero(rows == R)[0])
    assert len(full)
    for steps in (0, R // 2 + 3):
        got = msa.walk_plain(t(prevs)[full], t(reads)[full], t(refs)[full],
                             fout[1][full], fout[2][full], R, C, steps, lay)
        ref = msa.walk_plain(fpv[full], t(reads)[full], t(refs)[full],
                             fout[1][full], fout[2][full], R, C, steps, flay)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    if msa_kernels.band_count(R, J) > 1:
        assert waits > 0
    if B > 1 and rows[1] < R - LANES * J:
        assert (prevs[1, R] == 0xEE).all()


def test_pipe_shape_agrees_with_the_source():
    """launch_shape's pipe shape (rows a lane, a warp a band, the shared
    memory) is what the launcher in the source recomputes, and its ring
    constants are the source's."""
    src = (CSRC / "msa_dp_pipe.cu").read_text()
    chunk = int(re.search(r"kChunk = (\d+);", src).group(1))
    assert chunk == msa_kernels.PIPE_CHUNK
    ring = int(re.search(r"kRing = (\d+) \* kChunk;", src).group(1))
    assert msa_kernels.PIPE_RING == ring * chunk
    assert "(C + 15) / 16 * 16 + (R + 15) / 16 * 16" in src
    assert "bands * (kRing * 3 + 2) * static_cast<int>(sizeof(int))" in src
    for R in (0, 31, 32, 150, 511, 512, 700, 1023):
        for C in (R + 24, R + 456):
            s = msa_kernels.launch_shape(R, C, "pipe")
            J = 1 if R <= msa_kernels.PIPE_ONE_ROW_MAX else 2
            bands = (R + 32 * J) // (32 * J)
            assert s == (J, 32 * bands, msa_kernels.pipe_smem(R, C, bands),
                         "pipe")
            assert s.threads <= 512 and 32 * J * bands >= R + 1
    assert set(msa_kernels._INTERFACE["msa_dp_pipe"]) == set(
        re.findall(r"(?:cudaError_t|int) (\w+)\(", src.split(
            'extern "C" {')[1]))


# ---- dp_cell's forms --------------------------------------------------------

def _wrap(x):
    """int64 values wrapped to int32, as the card's 32-bit sums wrap."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(I32)


def _viaddmax(a, b, c):
    """__viaddmax_s32: max(a + b, c), the sum wrapped to 32 bits."""
    return np.maximum(_wrap(a.astype(np.int64) + b), c)


def _vibmax(a, b):
    """__vibmax_s32: (max(a, b), a >= b)."""
    return np.maximum(a, b), a >= b


def np_dp_cell_form(P, dpx, r, c, C, rows, read1, read0, ref1, ref0, dd,
                    own, up, ins0, subfloor):
    """dp_cell of csrc/msa_dp.cuh in its plain form or (``dpx``) its DPX
    form on numpy int32 arrays, the intrinsics modelled as their
    definitions (the sums wrapped). Returns ((ms, del, ins), code) as
    ``np_dp_cell``."""
    SM, TM = I32(~P.TIMEMASK), I32(P.TIMEMASK)

    def add(a, b):
        return _wrap(np.asarray(a, np.int64) + np.asarray(b, np.int64))

    def clamp_time(x):
        return np.where(x > P.MAX_TIME, I32(P.MAX_TIME - P.MASK5), x)

    def tiers(x, *lv):
        out = I32(lv[-1])
        for lim, val in reversed(lv[:-1]):
            out = np.where(x > lim, I32(val), out)
        return out

    n_ = ord("N")
    match = (read1 == ref1) & (ref1 != n_)
    pm = (read0 == ref0) & (ref0 != n_)
    gap = ref1 == ord("-")
    s_diag, s_del, s_ins = dd[0] & SM, dd[1] & SM, dd[2] & SM
    streak = dd[0] & TM
    m_ms = add(s_diag, np.where(pm, P.POINTSoff_MATCH2, P.POINTSoff_MATCH))
    sub_pen = np.where(
        pm, np.where(streak <= 1, I32(P.POINTSoff_SUBR), I32(P.POINTSoff_SUB)),
        tiers(streak + 1, (P.LIMIT_FOR_COST_3, P.POINTSoff_SUB3),
              (1, P.POINTSoff_SUB2), P.POINTSoff_SUB))
    x_ms = np.where((ref1 != n_) & (read1 != n_), add(s_diag, sub_pen),
                    add(s_diag, P.POINTSoff_NOCALL))
    if dpx:
        m_best = _viaddmax(s_ins, P.POINTSoff_MATCH,
                           _viaddmax(s_del, P.POINTSoff_MATCH, m_ms))
        x_best = _viaddmax(s_ins, P.POINTSoff_SUB,
                           _viaddmax(s_del, P.POINTSoff_SUB, x_ms))
        m_from, x_from = m_best == m_ms, x_best == x_ms
    else:
        m_d, m_i = add(s_del, P.POINTSoff_MATCH), add(s_ins, P.POINTSoff_MATCH)
        m_best = np.maximum(m_ms, np.maximum(m_d, m_i))
        m_from = (m_ms >= m_d) & (m_ms >= m_i)
        x_d, x_i = add(s_del, P.POINTSoff_SUB), add(s_ins, P.POINTSoff_SUB)
        x_best = np.maximum(x_ms, np.maximum(x_d, x_i))
        x_from = (x_ms >= x_d) & (x_ms >= x_i)
    m_time = np.where(m_from & pm, streak + 1, 1)
    x_time = np.where(x_from, np.where(pm, 1, streak + 1), 1)
    ms_time = clamp_time(np.where(match, m_time, x_time)).astype(I32)
    ms_val = np.where(gap, subfloor, np.where(match, m_best, x_best)
                      | ms_time)

    dstreak = own[1] & TM
    del_ext = np.where(
        dstreak == 0, I32(P.POINTSoff_DEL),
        np.where(dstreak < P.LIMIT_FOR_COST_3, I32(P.POINTSoff_DEL2),
                 np.where(dstreak < P.LIMIT_FOR_COST_4, I32(P.POINTSoff_DEL3),
                          np.where(dstreak < P.LIMIT_FOR_COST_5,
                                   I32(P.POINTSoff_DEL4),
                                   np.where((dstreak & P.MASK5) == 0,
                                            I32(P.POINTSoff_DEL5), I32(0))))))
    adj = np.where(ref1 == n_, I32(P.POINTSoff_DEL_REF_N),
                   np.where(gap, I32(P.POINTSoff_GAP), I32(0)))
    d_ms = add(add(own[0] & SM, P.POINTSoff_DEL), adj)
    d_d = add(add(own[1] & SM, del_ext), adj)
    if dpx:
        del_score, d_from = _vibmax(d_ms, d_d)
    else:
        del_score, d_from = np.maximum(d_ms, d_d), d_ms >= d_d
    del_time = clamp_time(np.where(d_from, 1, dstreak + 1)).astype(I32)
    del_val = np.where((r < P.BARRIER_D1) | (r > rows - P.BARRIER_D1),
                       subfloor, del_score | del_time)

    istreak = up[1] & TM
    i_ms = add(up[0] & SM, P.POINTSoff_INS)
    i_i = add(up[1] & SM, tiers(istreak + 1,
                                (P.LIMIT_FOR_COST_4, P.POINTSoff_INS4),
                                (P.LIMIT_FOR_COST_3, P.POINTSoff_INS3),
                                (1, P.POINTSoff_INS2), P.POINTSoff_INS))
    if dpx:
        ins_score, i_from = _vibmax(i_ms, i_i)
    else:
        ins_score, i_from = np.maximum(i_ms, i_i), i_ms >= i_i
    ins_time = clamp_time(np.where(i_from, 1, istreak + 1)).astype(I32)
    ins_barrier = gap | ((r < P.BARRIER_I1) & (c > 1)) | (
        (r > rows - P.BARRIER_I1) & (c < C - 1))
    ins_val = np.where(ins_barrier, subfloor, ins_score | ins_time)

    vals = []
    for v in (ms_val, del_val, ins_val):
        v = np.where(r == 0, 0, np.where(c == 0, ins0, v))
        vals.append(np.where((c < 0) | (c > C) | (r > rows),
                             I32(P.BADoff), v).astype(I32))
    if dpx:
        m_di, del_ge = _vibmax(s_del, s_ins)
        _, diag_ge = _vibmax(s_diag, m_di)
        ms_arg = np.where(diag_ge, 0, np.where(del_ge, 1, 2))
    else:
        ms_arg = np.where((s_diag >= s_del) & (s_diag >= s_ins), 0,
                          np.where(s_del >= s_ins, 1, 2))
    ms_prev = np.where(ms_time > 1, 0, ms_arg)
    del_prev = np.where(del_time > 1, 1,
                        np.where((own[0] & SM) >= (own[1] & SM), 0, 1))
    ins_prev = np.where(ins_time > 1, 2,
                        np.where((up[0] & SM) >= (up[1] & SM), 0, 2))
    code = (ms_prev | (del_prev << 2) | (ins_prev << 4)).astype(np.uint8)
    return vals, code


EXTREMES = np.array([2**31 - 1, -2**31, -2**31 + 1, -2147483646, 2**30,
                     -2**30, 0, 1, -1, 2**31 - 2048, -(3 << 29)], np.int64)


def cell_operands(rng, P, n):
    """n operand sets of dp_cell: rows and columns in and off the window,
    read and window characters among ACGTN, '-' and the sentinels, and
    packed cells that are scores with streaks, BAD, NEG_INF, random 32-bit
    words or the int32 extremes (whose sums wrap)."""
    chars = np.frombuffer(b"ACGTN-?!", np.uint8).astype(np.int64)

    def cells():
        kind = rng.integers(0, 6, n)
        packed = (rng.integers(-40000, 40000, n) << P.SCOREOFFSET) \
            | rng.integers(0, 300, n)
        v = np.where(kind == 0, P.BADoff, np.where(
            kind == 1, msa.NEG_INF, np.where(
                kind == 2, rng.integers(-2**31, 2**31 - 1, n),
                np.where(kind == 3, rng.choice(EXTREMES, n), packed))))
        return _wrap(v)

    r = rng.integers(0, 200, n).astype(I32)
    c = rng.integers(-2, 200, n).astype(I32)
    C = np.full(n, 174, I32)
    rows = rng.integers(1, 151, n).astype(I32)
    ch = [rng.choice(chars, n).astype(I32) for _ in range(4)]
    return (r, c, C, rows, *ch, [cells(), cells(), cells()],
            [cells(), cells()], [cells(), cells()], cells(), cells())


@pytest.mark.parametrize("prof", ["short", "pacbio"])
def test_dpx_forms_equal_the_plain_cell(prof):
    """dp_cell's DPX form gives the plain form's bits on random and
    extreme packed operands, the int32 wrap of every sum included, and the
    plain form is the cell model of tests/test_torch_msa.py."""
    P = PROFILES[prof]
    rng = np.random.default_rng(17)
    r, c, C, rows, rd1, rd0, rf1, rf0, dd, own, up, ins0, sf = \
        cell_operands(rng, P, 200_000)
    args = (r, c, C, rows, rd1, rd0, rf1, rf0, dd, own, up, ins0, sf)
    with np.errstate(over="ignore"):
        base_vals, base_code = np_dp_cell(P, *args)
        forms = [np_dp_cell_form(P, dpx, *args) for dpx in (False, True)]
    for vals, code in forms:
        for a, b in zip(vals, base_vals):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(code, base_code)
    # the operands reach every branch: sums that wrap, each source of MS
    s_del = dd[1] & I32(~P.TIMEMASK)
    with np.errstate(over="ignore"):
        wrapped = (s_del.astype(np.int64) + P.POINTSoff_MATCH
                   != _wrap(s_del.astype(np.int64) + P.POINTSoff_MATCH))
    assert wrapped.any()
    assert len(np.unique(base_code & 3)) == 3


def test_dpx_model_wraps_as_the_card_is_asked_to():
    """The add-then-max model wraps its sum: the case the card's probe
    (chip_smoke.py, "dpx addmax") checks against max(a + b wrapped, c)."""
    a = np.array([2**31 - 1, -2**31, 5], np.int64).astype(I32)
    b = np.array([1, -1, 7], I32)
    c = np.array([-2**31, 0, 3], I32)
    np.testing.assert_array_equal(_viaddmax(a, b, c), [-2**31, 2**31 - 1, 12])


def test_pipe_kernel_equals_plain_on_the_card():
    """The pipe mapping's K2, K3 and K1 operands against their plain
    versions on the card, and dp_cell's two forms against each other there
    (chip_smoke.py does this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for R, C in ((20, 44), (63, 90), (150, 174), (600, 640)):
        reads, refs, rows = (torch.from_numpy(x).to(dev) for x in
                             batch_of(R + 1, 6, R, C, gap=True))
        P = PROFILES["short"]
        out, prevs, lay = msa_kernels.msa_fill(reads, refs, rows, P, "pipe")
        want, want_pv, want_lay = msa_kernels.msa_fill_plain(reads, refs,
                                                             rows, P)
        assert torch.equal(out, want)
        assert lay == msa.row_major(R, C)
        valid = (torch.arange(1, R + 1, device=dev)[None, :, None]
                 <= rows[:, None, None]).expand(-1, -1, C)
        assert torch.equal(msa.cell_view(prevs, R, C, lay)[valid],
                           msa.cell_view(want_pv, R, C, want_lay)[valid])
        assert torch.equal(msa_kernels.msa_score(reads, refs, rows, P,
                                                 "pipe"), want)
        r1, r0, rp, rw = msa_kernels.prep_operands(reads, refs, rows)
        assert torch.equal(
            msa_kernels.msa_score_rows(r1, r0, (rp, rw), R, C, 1, "pipe"),
            msa_kernels.msa_score_rows_plain(r1, r0, (rp, rw), R, C, 1))
    rng = np.random.default_rng(3)
    ops = cell_operands(rng, PROFILES["pacbio"], 4096)
    r, c, C, rows, rd1, rd0, rf1, rf0, dd, own, up, ins0, sf = ops
    flat = np.stack([r, c, C, rows, rd1, rd0, rf1, rf0, *dd, *own, *up,
                     ins0, sf], 1).astype(I32)
    forms = msa_kernels.dp_cell_forms(torch.from_numpy(flat).to(dev),
                                      PROFILES["pacbio"]).cpu()
    assert torch.equal(forms[:, 1], forms[:, 0])
