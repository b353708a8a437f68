"""The band mapping of the long-row DP kernels
(bbmap_tpu_torch/csrc/msa_dp_band.cu) and what came with it, on the CPU:

- a numpy emulation of the kernel's schedule (bands of lanes, the edge
  rows handed on in chunks behind a published column count, tickets in
  place of block indices, prev codes gathered four a word into the
  row-major block) against ``dp_plain``;
- the walks over the row-major block against the walks over the
  wave-major block and against the JAX package's ``_walk_device`` and
  ``traceback_prevs``;
- ``launch_shape`` for the band mapping, and its agreement with the
  launcher in the source;
- the prev-code budget and the two chunk caps that divide it, and that
  chunking changes no output of ``trace_jobs``;
- the quality-offset route by device type.

Tolerance: exact everywhere (integer DP, byte codes, symbols)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.ops import msa_jax
from bbmap_tpu_torch import backend
from bbmap_tpu_torch.align import escalate_device, fused_device, pipeline
from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
from bbmap_tpu_torch.core.genome import Genome, Scaffold
from bbmap_tpu_torch.index.build import analyze_index, build_index
from bbmap_tpu_torch.ops import msa, msa_kernels

from .test_torch_msa import (BASES, JAX_PROFILES, PROFILES, batch_of,
                             np_dp_cell, t)

torch.set_num_threads(2)

CSRC = Path(msa_kernels.__file__).resolve().parent.parent / "csrc"
POISON = np.int32(0x5A5A5A5A)    # an edge column nobody has published


class _Band:
    """One band (one warp of the kernel) of one job, W lanes wide: the
    registers of msa_dp_band_kernel as numpy arrays over the lanes."""

    def __init__(self, b, band, sh):
        self.b, self.band, self.s = b, band, 0
        W, J, BAD = sh["W"], sh["J"], np.int32(sh["P"].BADoff)
        self.r0 = band * W * J + np.arange(W, dtype=np.int32) * J
        self.cells = [[np.full(W, BAD, np.int32) for _ in range(3)]
                      for _ in range(J)]
        self.car = [np.full(W, BAD, np.int32) for _ in range(3)]
        self.e = [np.full(W, BAD, np.int32) for _ in range(3)]
        self.acc = np.zeros((J, W), np.uint32)
        self.best = np.full(3, msa.NEG_INF, np.int32)
        self.bcol = np.zeros(3, np.int32)
        n_rows = min(W * J, sh["R"] + 1 - band * W * J)
        self.n_steps = sh["C"] + -(-n_rows // J)


def band_schedule(reads, refs, rows, P, J, W=4, chunk=2, resident=3,
                  seed=0):
    """The schedule of msa_dp_band_kernel on numpy arrays, W lanes a band
    in place of 32 and ``chunk`` columns a hand-over in place of 16.
    Blocks draw (job, band) tickets in order, at most ``resident`` run at
    once and a random one of them takes its next step; a band whose edge
    chunk is not published yet does not move (the kernel's acquire loop).
    Returns (out (3, B), prevs (B, R+1, pitch) row-major with 0xEE in
    every byte never stored, steps on which a band had to wait)."""
    i32 = np.int32
    B, R = reads.shape
    C = refs.shape[1]
    assert chunk <= W
    SM, BAD = i32(~P.TIMEMASK), i32(P.BADoff)
    bands = -(-(R + 1) // (W * J))
    Ce = msa_kernels.edge_pitch(C)
    Cp = msa.prev_pitch(C)
    sh = dict(W=W, J=J, P=P, R=R, C=C)
    lane = np.arange(W, dtype=i32)
    ins0_col = msa._ins0_np(R, P)
    read_pad = np.concatenate(
        [np.full((B, 2), ord("?"), i32), reads.astype(i32),
         np.full((B, W * J * bands), ord("?"), i32)], axis=1)
    ref_pad = np.concatenate(
        [np.full((B, 2), ord("!"), i32), refs.astype(i32),
         np.full((B, 2), ord("!"), i32)], axis=1)
    with np.errstate(over="ignore"):
        gain = ((rows.astype(i32) - 1) * i32(P.POINTSoff_MATCH2)
                + i32(P.POINTSoff_MATCH)).astype(i32)
        subfloor = (gain * i32(-2)).astype(i32)
    flag = np.zeros((B, bands), np.int64)
    edge = np.full((B, max(bands - 1, 1), 3, Ce), POISON, i32)
    prevs = np.full((B, R + 1, Cp), 0xEE, np.uint8)
    out = np.zeros((3, B), i32)

    def step(st):
        """One pass of the kernel's step loop; False when it must wait."""
        b, band, s = st.b, st.band, st.s
        fed = band > 0
        feeds = band + 1 < bands and (band + 1) * W * J <= rows[b]
        if fed and s % chunk == 0 and s <= C:
            if flag[b, band - 1] < min(s + chunk, C + 1):
                return False
            for k in range(3):
                ce = s + lane
                ok = (lane < chunk) & (ce <= C)
                st.e[k] = np.where(
                    ok, edge[b, band - 1, k, np.minimum(ce, Ce - 1)],
                    st.e[k])
        bottom = st.cells[J - 1]
        up = [np.concatenate([v[:1], v[:-1]]) for v in bottom]
        if fed:
            for k in range(3):
                up[k][0] = st.e[k][s % chunk]
        c = (s - lane).astype(i32)
        active = (c >= 0) & (c <= C) & (st.r0 <= R)
        cc = np.clip(c, -1, C + 1)
        ref1, ref0 = ref_pad[b, cc + 1], ref_pad[b, cc]
        flush = ((c & 3) == 3) | (c == C)
        dd = list(st.car)
        u = [up[0], up[2]]
        for j in range(J):
            r = (st.r0 + j).astype(i32)
            do = active & (r <= R)
            own = st.cells[j]
            ins0 = np.where(c == 0, ins0_col[np.minimum(r, R)], 0)
            with np.errstate(over="ignore"):
                new, code = np_dp_cell(
                    P, r, c, C, rows[b].astype(i32), read_pad[b, r + 1],
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
        if feeds and active[W - 1]:
            cl = c[W - 1]
            for k in range(3):
                edge[b, band, k, cl] = st.cells[J - 1][k][W - 1]
            if cl % chunk == chunk - 1 or cl == C:
                flag[b, band] = cl + 1
        st.car = up
        st.s += 1
        return True

    def finish(st):
        jr = rows[st.b] - st.band * W * J
        if rows[st.b] <= R and jr < W * J:
            b0, b1, b2 = st.best
            state = 0 if b0 >= b1 and b0 >= b2 else (1 if b1 >= b2 else 2)
            out[:, st.b] = (st.best[state] >> P.SCOREOFFSET,
                            st.bcol[state], state)

    rng = np.random.default_rng(seed)
    ticket, running, waits = 0, [], 0
    while ticket < B * bands or running:
        while ticket < B * bands and len(running) < resident:
            b, band = divmod(ticket, bands)
            ticket += 1
            if band * W * J <= rows[b]:     # else the band leaves at once
                running.append(_Band(b, band, sh))
        if not running:
            continue
        st = running[rng.integers(len(running))]
        if not step(st):
            waits += 1
            assert any(o.b == st.b and o.band == st.band - 1
                       for o in running), "waits for a band not running"
        elif st.s == st.n_steps:
            finish(st)
            running.remove(st)
    return out, prevs, waits


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R, J, W, chunk, resident", [
    (40, 2, 4, 2, 3),      # 6 bands, the last one row short of full
    (70, 2, 4, 4, 2),      # 9 bands, last band 7 of 8 rows, last lane half
    (100, 4, 4, 2, 5),     # 7 bands, last band 5 rows: two lanes, one partly
    (47, 2, 8, 4, 1),      # 3 full bands, one resident at a time
    (33, 4, 4, 2, 3),      # 3 bands, the last two rows
])
def test_band_schedule_matches_plain(R, J, W, chunk, resident, prof):
    """The band schedule equals dp_plain in out and, through the stride
    map of the row-major block, in the prev codes of every valid cell:
    several bands, a partly empty last band and last lane, per-job rows
    below R (bands past a job's last row leave at once), N and gap
    columns, any interleaving of at most ``resident`` bands."""
    P = PROFILES[prof]
    C, B = R + 22, 3
    reads, refs, rows = batch_of(R + J, B, R, C, gap=True)
    rows[1] = R - W * J - 1          # a whole band below the last row
    reads[1, rows[1]:] = ord("N")
    out, prevs, waits = band_schedule(reads, refs, rows, P, J, W, chunk,
                                      resident, seed=R)
    want, want_pv = msa.dp_plain(t(reads), t(refs), t(rows), P, True)
    np.testing.assert_array_equal(out, want.numpy())
    lay = msa.row_major(R, C)
    got_cells = msa.cell_view(t(prevs), R, C, lay).numpy()
    want_cells = msa.cell_view(want_pv, R, C).numpy()
    valid = np.arange(1, R + 1)[None, :, None] <= rows[:, None, None]
    np.testing.assert_array_equal(got_cells[valid.repeat(C, 2)],
                                  want_cells[valid.repeat(C, 2)])
    # rows of the band that left at once were never stored
    assert (prevs[1, R] == 0xEE).all()
    if resident > 1:
        assert waits > 0


# ---- the walks over the row-major block -----------------------------------

@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("steps", [0, 44, 25])
def test_walk_row_major_matches_wave_major_and_jax(prof, steps):
    """dp_plain's row-major block holds the codes of its wave-major block
    on every valid cell; walk_plain and msa_walk give the same symbols,
    lengths, gaps and end rows over either, and both equal the JAX
    package's _walk_device over its own fill."""
    P, JP = PROFILES[prof], JAX_PROFILES[prof]
    R, C, B = 30, 50, 8
    reads, refs, _ = batch_of(21, B, R, C, var_rows=False, gap=True)
    refs[1::3, 20] = ord("-")
    rows = np.full(B, R, np.int32)
    lay = msa.row_major(R, C)
    out, pv_wave, lay_w = msa_kernels.msa_fill_plain(t(reads), t(refs),
                                                     t(rows), P)
    out_r, pv_row, lay_r = msa_kernels.msa_fill_plain(t(reads), t(refs),
                                                      t(rows), P, lay)
    assert lay_w == msa.wave_major(R, C) and lay_r == lay
    assert tuple(pv_row.shape) == (B, R + 1, msa.prev_pitch(C))
    np.testing.assert_array_equal(out.numpy(), out_r.numpy())
    pv_x, sc, col, st = msa_jax.msa_trace_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C, JP)
    np.testing.assert_array_equal(out.numpy(), np.stack([sc, col, st]))
    for block, la in ((pv_wave, None), (pv_row, lay)):
        np.testing.assert_array_equal(
            msa.cell_view(block, R, C, la).numpy(),
            msa.cell_view(t(np.asarray(pv_x)), R, C).numpy())
    js = jax.vmap(lambda p, rd, rf, c0, s0: msa_jax._walk_device(
        p, rd, rf, c0, s0, R, C, steps=steps))(
            pv_x, jnp.asarray(reads), jnp.asarray(refs), col, st)
    for walker in (msa.walk_plain, msa_kernels.msa_walk,
                   msa_kernels.msa_walk_plain):
        over_wave = walker(pv_wave, t(reads), t(refs), out[1], out[2], R, C,
                           steps)
        over_row = walker(pv_row, t(reads), t(refs), out[1], out[2], R, C,
                          steps, lay)
        for a, b, w in zip(over_wave, over_row, js):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(b.numpy(), np.asarray(w))


def test_traceback_prevs_row_major_matches_jax():
    """The host walk over one job's row-major block equals the walk over
    its wave-major block and the JAX package's traceback_prevs."""
    R, C = 30, 50
    reads, refs, _ = batch_of(23, 4, R, C, var_rows=False, gap=True)
    rows = t(np.full(4, R, np.int32))
    lay = msa.row_major(R, C)
    out, pv_wave = msa.dp_plain(t(reads), t(refs), rows, PROFILES["short"],
                                True)
    _, pv_row = msa.dp_plain(t(reads), t(refs), rows, PROFILES["short"],
                             True, lay)
    for b in range(4):
        pe, se, ce, ste = msa_jax.msa_trace_single(reads[b], refs[b], R, C)
        want = msa_jax.traceback_prevs(reads[b], refs[b], np.asarray(pe),
                                       int(ce), int(ste))
        col, st = int(out[1, b]), int(out[2, b])
        assert (col, st) == (int(ce), int(ste))
        assert msa.traceback_prevs(reads[b], refs[b], pv_wave[b].numpy(),
                                   col, st) == want
        assert msa.traceback_prevs(reads[b], refs[b], pv_row[b].numpy(),
                                   col, st, lay) == want


def test_walk_refuses_a_block_of_the_other_layout():
    R, C, B = 12, 20, 3
    reads, refs, rows = batch_of(3, B, R, C, var_rows=False)
    out, prevs, lay = msa_kernels.msa_fill(t(reads), t(refs), t(rows),
                                           PROFILES["short"])
    assert lay == msa.wave_major(R, C)
    with pytest.raises(ValueError):
        msa_kernels.msa_walk(prevs, t(reads), t(refs), out[1], out[2], R, C,
                             layout=msa.row_major(R, C))
    with pytest.raises(ValueError):
        msa_kernels.msa_walk(prevs, t(reads), t(refs), out[1], out[2], R, C,
                             layout=msa.PrevLayout(0, R + 1, 2))


# ---- launch_shape for the band mapping ------------------------------------

@pytest.mark.parametrize("R, C, jobs, fill, want_J", [
    (1024, 1100, None, False, 8),
    (1024, 1100, 1, True, 2),
    (2500, 2600, 16, True, 2),
    (6000, 6456, 16, True, 2),
    (6000, 6456, 16, False, 2),
    (6000, 6456, 22, True, 4),
    (6000, 6456, 42, True, 4),
    (6000, 6456, 42, False, 4),
    (6000, 6456, 43, False, 8),
    (6000, 6456, 43, True, 4),
    (6000, 6456, 256, False, 8),
    (6000, 6024, 512, True, 4),
    (8191, 8192, 3, False, 2),
    (8191, 8192, 4096, True, 4),
    (1100, 1200, 256, False, 8),
    (2000, 2100, 4096, True, 4),
])
def test_launch_shape_band(R, C, jobs, fill, want_J):
    """Past 1,023 rows every pass takes the band mapping: 32 threads a
    block, no shared memory, and as many rows a lane (a fill: 4 at most)
    as keep the launch at BAND_MIN_WARPS warps or more (else the thinnest
    bands)."""
    s = msa_kernels.launch_shape(R, C, jobs=jobs, fill=fill)
    assert tuple(s) == (want_J, 32, 0, "band")
    bands = msa_kernels.band_count(R, s.rows_per_thread)
    assert 32 * s.rows_per_thread * (bands - 1) < R + 1 \
        <= 32 * s.rows_per_thread * bands
    if jobs is not None and want_J > 2:
        assert jobs * bands >= msa_kernels.BAND_MIN_WARPS
    top = msa_kernels.BAND_FILL_MAX_ROWS_PER_LANE if fill else 8
    if jobs is not None and want_J < top:
        assert jobs * msa_kernels.band_count(R, 2 * want_J) \
            < msa_kernels.BAND_MIN_WARPS


@pytest.mark.parametrize("R, C", [(0, 8), (150, 174), (700, 760),
                                  (1023, 1100), (6000, 6456)])
def test_launch_shape_band_and_strided_forced(R, C):
    """"band" can be forced at any R the kernels hold, "strided" (the
    mapping it replaced) past 1,023 rows; neither above 8,191."""
    s = msa_kernels.launch_shape(R, C, "band", jobs=10_000)
    assert tuple(s) == (8, 32, 0, "band")
    if R > 1023:
        st = msa_kernels.launch_shape(R, C, "strided")
        assert st.mapping == "strided" and st.smem_bytes == \
            24 * (R + 1) + C + R
        assert st.threads * st.rows_per_thread >= R + 1
    else:
        with pytest.raises(ValueError):
            msa_kernels.launch_shape(R, C, "strided")
    for mapping in ("band", "strided", None):
        with pytest.raises(ValueError):
            msa_kernels.launch_shape(8192, 8200, mapping)


def test_band_source_agrees_with_launch_shape():
    """What the launcher in csrc/msa_dp_band.cu recomputes and refuses to
    differ from: the rows a lane it instantiates, 32 threads and no
    shared memory, the band count and both pitches."""
    src = (CSRC / "msa_dp_band.cu").read_text()
    cases = tuple(int(j) for j in re.findall(r"BAND_CASE\((\d+)\)", src))
    assert cases == msa_kernels.BAND_ROWS_PER_LANE
    assert "threads != 32 || smem != 0" in src
    assert "bands != (R + 32 * J) / (32 * J)" in src
    pitches = dict(re.findall(
        r"inline int (\w+_pitch)\(int C\) \{ return ([^;]+); \}", src))
    for R in (0, 255, 256, 1024, 6000, 8191):
        for J in cases:
            assert msa_kernels.band_count(R, J) == (R + 32 * J) // (32 * J)
    for C in (1, 15, 16, 31, 32, 6024, 6456, 8192):
        assert msa.prev_pitch(C) == eval(
            pitches["prev_pitch"].replace("/", "//"), {"C": C})
        assert msa_kernels.edge_pitch(C) == eval(
            pitches["edge_pitch"].replace("/", "//"), {"C": C})
        assert msa.prev_pitch(C) % 16 == 0 and msa.prev_pitch(C) > C
        assert msa_kernels.edge_pitch(C) > C
    assert set(msa_kernels._INTERFACE["msa_dp_band"]) == set(
        re.findall(r"cudaError_t (msa_\w+_band_launch)\(", src))


def test_launch_counters_name_every_mapping():
    msa_kernels.reset_launches()
    assert msa_kernels.MAPPINGS == ("warp", "pipe", "row", "band", "strided")
    for k in msa_kernels.DP_KERNELS:
        assert k.launches_by == dict.fromkeys(msa_kernels.MAPPINGS, 0)


# ---- the prev-code budget and the chunk caps ------------------------------

GIB = 1 << 30


@pytest.mark.parametrize("free_gib", [4, 20, 79])
def test_budget_and_chunk_caps_follow_free_memory(monkeypatch, free_gib):
    """On a card the budget is a share of the free bytes, and both chunk
    caps divide it by the bytes a job's prev codes take in the layout the
    fill uses there: the row-major block past 1,023 rows. On the CPU the
    budget stays 2 GiB over the wave-major block."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free_gib * GIB, 80 * GIB))
    cuda = torch.device("cuda", 0)
    budget = backend.prev_code_budget(cuda)
    assert budget == int(free_gib * GIB * backend.PREV_CODE_SHARE)
    assert backend.prev_code_budget("cpu") == 2 * GIB
    L, C = 6000, 6456
    per_job = (L + 1) * msa.prev_pitch(C)
    assert msa_kernels.prev_code_bytes(L, C, cuda) == per_job
    assert msa_kernels.prev_code_bytes(L, C, "cpu") == (L + C) * (L + 1)
    assert msa_kernels.prev_code_bytes(150, 174, cuda) == 324 * 151
    cap = budget // per_job
    assert pipeline._dp_tb_chunk_cap(L, C, cuda) == max(8, min(8192, cap))
    assert pipeline._dp_tb_chunk_cap(L, C, "cpu") == 28
    assert pipeline._dp_tb_chunk_cap(150, 174, cuda) == 8192
    ladder = escalate_device._trace_ladder(
        L, C, escalate_device.TRACE_CHUNKS_W, cuda)
    assert len(ladder) == 1 and ladder[0] <= max(8, cap) < 2 * ladder[0] \
        or ladder == (1024,)
    if free_gib >= 20:
        assert ladder[0] >= 64      # well over the 16 jobs of a 2 GiB budget
    assert escalate_device._trace_ladder(
        L, C, escalate_device.TRACE_CHUNKS_W, "cpu") == (16,)
    assert escalate_device._trace_ladder(
        150, 174, escalate_device.TRACE_CHUNKS, cuda) == (2048, 1024, 512)


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    g = rng.choice(BASES, size=20000).astype(np.uint8)
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="ref")]).finalize()
    index = build_index(genome, 13)
    analyze_index(index, 0.01)
    return g, DeviceIndex(index, torch.device("cpu"))


def test_trace_jobs_equal_under_two_budgets(monkeypatch, small_index):
    """Jobs are independent, so the chunk a budget allows changes no
    output: the same trace jobs under a budget of one 8-job chunk and
    under 2 GiB give the same symbols, lengths, gaps, scores and
    columns."""
    g, dindex = small_index
    L, J = 40, 37
    progs = escalate_device.make_programs(L, dindex)
    rng = np.random.default_rng(8)
    starts = rng.integers(600, len(g) - 1200, J)
    reads = np.stack([g[s:s + L] for s in starts]).copy()
    for i in range(J):
        reads[i, rng.integers(0, L)] = BASES[rng.integers(0, 4)]
        if i % 3 == 0:
            p = int(rng.integers(8, L - 8))
            reads[i] = np.concatenate([reads[i, :p], reads[i, p + 2:],
                                       BASES[rng.integers(0, 4, 2)]])
    wide = rng.random(J) < 0.4
    wstart = (starts - np.where(wide, 200, 6)).astype(np.int32)
    seen = []

    def run(budget):
        monkeypatch.setattr(escalate_device, "prev_code_budget",
                            lambda device: budget)
        seen.append(escalate_device._trace_ladder(
            L, progs["Cn"], escalate_device.TRACE_CHUNKS,
            progs["device"])[0])
        return escalate_device.trace_jobs(progs, reads, wstart, wide)

    small, big = run(1), run(2 * GIB)
    assert seen == [8, 2048]
    for a, b in zip(small, big):
        np.testing.assert_array_equal(a, b)
    assert (small[1] >= L).all()            # every job walked its read


# ---- one quality-offset route a device type -------------------------------

class _FakeIndex:
    k = 13

    def __init__(self, device):
        self.device = torch.device(device)


@pytest.mark.parametrize("device, packs, want", [
    ("cpu", True, "host"),
    ("meta", True, "device packed"),
    ("meta", False, "device raw"),
])
def test_quality_inputs_route_by_device_type(monkeypatch, device, packs,
                                             want):
    """On the CPU the quality offsets come from the native host stage
    (when its library is there); on any other device type always from
    the device stage, packed or raw, and the host stage is not asked."""
    calls = []
    B, L = 4, 50
    quality = np.full((B, L), 30, np.int8)

    def host_stage(q, L_, k, *rest):
        calls.append("host")
        return (np.zeros((B, 3), np.int16), np.ones((B, 3), np.int16),
                np.zeros(B, bool))

    def pack(q, L_):
        return (np.zeros((B, 4), np.uint32), np.zeros(16, np.int8),
                np.zeros(16, np.float32)) if packs else (None, None, None)

    def stage(name):
        def fn(cfg, *args, return_weights=False):
            calls.append(name)
            assert all(a.device.type == device for a in args
                       if isinstance(a, torch.Tensor))
            return "offs", "wts", "rej"
        return fn

    monkeypatch.setattr(fused_device.native, "quality_offsets_scores",
                        host_stage)
    monkeypatch.setattr(fused_device.qd, "pack_quality_host", pack)
    monkeypatch.setattr(fused_device.qd, "quality_offsets_stage_packed",
                        stage("device packed"))
    monkeypatch.setattr(fused_device.qd, "quality_offsets_stage",
                        stage("device raw"))
    cfg = type("Cfg", (), {"offsets_list": [0, 1, 2]})()
    got = fused_device._quality_inputs(cfg, _FakeIndex(device), quality, L,
                                       1.0, 1.0)
    assert calls == [want]
    if want == "host":
        offs, wts, rej = got
        assert offs.dtype == torch.int32 and wts.dtype == torch.float32
    else:
        assert got == ("offs", "wts", "rej")


def test_native_records_why_it_has_no_library(monkeypatch, capsys, tmp_path):
    """get_lib keeps the numpy paths working without the library but no
    longer hides why: the exception is kept and said once on stderr."""
    from bbmap_tpu_torch.io import native
    for name, value in (("_lib", None), ("_tried", False),
                        ("load_error", None),
                        ("_CSRC", str(tmp_path)),
                        ("_LIB_PATH", str(tmp_path / "libbbio.so"))):
        monkeypatch.setattr(native, name, value)
    assert native.get_lib() is None
    assert native.load_error is not None
    assert native.fastq_scan(b"@r\nAC\n+\nII\n", 4) is None
    assert native.get_lib() is None
    err = capsys.readouterr().err
    assert err.count("no native host library") == 1
