"""The fused fill + traceback walk of short DP jobs
(bbmap_tpu_torch/csrc/msa_fill_walk.cu, ``ops/msa_kernels.msa_fill_walk``)
on the CPU:

- its plain version, ``msa_fill_walk_plain``, against the JAX package's
  ``msa_fill_pallas_t`` (interpret mode) followed by
  ``msa_jax._walk_device``: full walks, bounded walks, walks that are cut,
  clipped ends, N bases, gap columns and rows below R;
- a numpy emulation of the kernel's mapping (a block a job with a thread
  a row that evaluates only its in-window cells), with a byte or four
  bits a cell: the sweep order, the codes stored into a row-major
  shared-memory block of the kernel's pitch (every byte never stored
  poisoned) and the walk reading that block only, against the plain
  version;
- the route rules: which shapes the fused kernel holds, CPU tensors
  taking the plain version, and the launcher in the source agreeing with
  ``fill_walk_shape``;
- the fused program calling the fused entry point for its T fill and its
  retry (``msa_align_batch``), with no separate fill or walk.

Tolerance: exact everywhere (integer DP, byte codes, symbols)."""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.ops import msa_jax
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import fused_device as tfd
from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
from bbmap_tpu_torch.ops import msa, msa_kernels

from .test_torch_fused import make_pairs, setup  # noqa: F401 (fixture)
from .test_torch_msa import (JAX_PROFILES, PROFILES, batch_of, np_dp_cell,
                             pallas_t, t, walk_kernel_emulation)

torch.set_num_threads(2)

CSRC = Path(msa_kernels.__file__).resolve().parent.parent / "csrc"
POISON = 0xFF          # a byte never stored: as a code, ms = 3 is no state
SLOT_POISON = np.int32(0x5A5A5A5A)


def clipped_batch(seed, B, R, C):
    """batch_of's jobs (rows below R, N bases, a gap column), and four
    whose reads hang off the window: two over the left edge (the walk
    ends in X or I), two over the right edge (it starts with Y)."""
    reads, refs, rows = batch_of(seed, B, R, C, gap=True)
    rng = np.random.default_rng(seed + 1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for b, shift in ((1, -6), (2, -11), (3, C - R + 5), (4, C - R + 9)):
        ref = rng.choice(bases, size=C + 40).astype(np.uint8)
        lo = 20 + shift
        reads[b] = ref[lo:lo + R]
        refs[b] = ref[20:20 + C]
        rows[b] = R
    return reads, refs, rows


def jax_fill_walk(reads, refs, rows, R, C, P, steps):
    """msa_fill_pallas_t (interpret mode) followed by _walk_device from
    the fill's own column and state, as the JAX fused program runs them:
    (out, syms, out_len, gaps, row_end) as numpy arrays."""
    out, prevs = pallas_t(reads, refs, rows, R, C, P, fill=True)
    walked = jax.vmap(lambda p, rd, rf, c0, s0: msa_jax._walk_device(
        p, rd, rf, c0, s0, R, C, steps=steps))(
            jnp.asarray(prevs), jnp.asarray(reads), jnp.asarray(refs),
            jnp.asarray(out[1]), jnp.asarray(out[2]))
    return (out, *(np.asarray(w) for w in walked))


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R, C, steps", [
    (30, 54, 0),           # full walks: steps = R + C
    (30, 54, 30 + 24 + 16),  # bounded as the fused program bounds them
    (30, 54, 20),          # cut: every walk ends with row_end > 0
    (40, 41, 0),           # the window barely wider than the read
])
def test_plain_matches_pallas_fill_and_walk_device(prof, R, C, steps):
    """msa_fill_walk_plain equals msa_fill_pallas_t + _walk_device on all
    seven outputs (score, col, state, symbols, out_len, gaps, row_end)."""
    B = 8
    reads, refs, rows = clipped_batch(R + C + steps, B, R, C)
    got = msa_kernels.msa_fill_walk_plain(t(reads), t(refs), t(rows),
                                          PROFILES[prof], steps)
    want = jax_fill_walk(reads, refs, rows, R, C, JAX_PROFILES[prof], steps)
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    sym, row_end = got[1].numpy(), got[4].numpy()
    if steps == 20:
        assert (row_end > 0).all()
    if steps == 0:
        assert (row_end == 0).all()
        starts = {chr(sym[b, int(got[2][b]) - 1]) for b in range(B)}
        assert starts & {"X", "I"} and (sym[:, 0] == ord("Y")).any()
    # the wrapper on CPU tensors is the plain version
    for g, w in zip(msa_kernels.msa_fill_walk(
            t(reads), t(refs), t(rows), PROFILES[prof], steps), got):
        assert torch.equal(g, w)


# ---- the kernel's schedule and shared-memory layout -----------------------

class SmemCodes:
    """The shared-memory blocks of B jobs: (B, R, pitch) bytes, every byte
    poisoned until stored; codes stored as the kernel's put_code does (a
    byte a cell, or a nibble with the row's pending low nibble)."""

    def __init__(self, B, R, C, pitch, packed):
        self.smem = np.full((B, R, pitch), POISON, np.uint8)
        self.pending = np.zeros((B, R + 1), np.int64)
        self.C, self.packed = C, packed

    def store(self, b, r, c, code):
        code = code.astype(np.int64)
        if not self.packed:
            self.smem[b, r - 1, c - 1] = code
            return
        nib = (code & 7) | ((code >> 2) & 8)
        first = (c & 1) == 1
        self.pending[b[first], r[first]] = nib[first]
        last = first & (c == self.C)
        self.smem[b[last], r[last] - 1, (c[last] - 1) >> 1] = nib[last]
        hi = ~first
        self.smem[b[hi], r[hi] - 1, (c[hi] - 1) >> 1] = \
            self.pending[b[hi], r[hi]] | (nib[hi] << 4)

    def code_at(self, b, r, c):
        """SmemCodes<PACK> of the kernel: the byte code of cell (r, c),
        read from the block alone; a poisoned byte or nibble fails."""
        byte = int(self.smem[b, r - 1, (c - 1) >> 1 if self.packed
                             else c - 1])
        if not self.packed:
            assert byte != POISON, (b, r, c)
            return byte
        nib = (byte >> (((c - 1) & 1) * 4)) & 15
        assert nib & 3 != 3, (b, r, c)
        return (nib & 7) | ((nib & 8) << 2)


def row_schedule(reads, refs, rows, P, store):
    """The sweep of msa_fill_walk_row_kernel on numpy arrays (B, R+1):
    thread r of block b evaluates cell (r, d - r) on wave d only where
    0 <= c <= C, reading its upper neighbour from the wave slot of wave
    d-1 (both slots poisoned but for what the kernel writes before the
    first wave) and keeping its own and its diagonal cells in registers;
    codes go to ``store``. Returns out (3, B)."""
    i32 = np.int32
    B, R = reads.shape
    C = refs.shape[1]
    SM, BAD = i32(~P.TIMEMASK), i32(P.BADoff)
    r = np.arange(R + 1, dtype=i32)[None, :]
    rows_c = rows.astype(i32)[:, None]
    with np.errstate(over="ignore"):
        gain = ((rows_c - 1) * i32(P.POINTSoff_MATCH2)
                + i32(P.POINTSoff_MATCH)).astype(i32)
        subfloor = (gain * i32(-2)).astype(i32)
    ins0 = msa._ins0_np(R, P)[None, :]
    read_pad = np.concatenate([np.full((B, 2), ord("?"), i32),
                               reads.astype(i32)], axis=1)
    read1, read0 = read_pad[:, 1:], read_pad[:, :-1]
    ref_pad = np.concatenate(
        [np.full((B, 2), ord("!"), i32), refs.astype(i32),
         np.full((B, 2), ord("!"), i32)], axis=1)
    own = [np.where(r == 0, 0, BAD).astype(i32).repeat(B, 0)
           for _ in range(3)]
    slots = np.full((2, 3, B, R + 1), SLOT_POISON, i32)
    for k in range(3):
        slots[0, k] = own[k]
    dd = [np.full((B, R + 1), BAD, i32) for _ in range(3)]
    best = np.full((3, B), msa.NEG_INF, i32)
    bcol = np.zeros((3, B), i32)
    for d in range(1, R + C + 1):
        c = (d - r).astype(i32)
        act = np.broadcast_to((c >= 0) & (c <= C), (B, R + 1))
        cc = np.clip(c, -1, C + 1)
        ref1 = ref_pad[:, cc[0] + 1]
        ref0 = ref_pad[:, cc[0]]
        rd = slots[(d - 1) & 1]
        up = [np.concatenate([np.full((B, 1), BAD, i32), rd[k][:, :-1]],
                             axis=1) for k in range(3)]
        with np.errstate(over="ignore"):
            new, code = np_dp_cell(
                P, r, c, C, rows_c, read1, read0, ref1, ref0, dd, own[:2],
                (up[0], up[2]), np.where(c == 0, ins0, 0), subfloor)
        wr = act & (r >= 1) & (c >= 1)
        bi, ri = np.nonzero(wr)
        store(bi, ri, c[0, ri], code[bi, ri])
        on_last = act & (r == rows_c) & (c >= 1)
        for k in range(3):
            v = new[k] & SM
            take = on_last & (v > best[k][:, None])
            hit = take.any(axis=1)
            best[k] = np.where(hit, np.where(take, v, 0).sum(axis=1),
                               best[k])
            bcol[k] = np.where(hit, np.where(take, c, 0).sum(axis=1),
                               bcol[k])
        for k in range(3):
            slots[d & 1, k] = np.where(act, new[k], slots[d & 1, k])
            dd[k] = np.where(act, up[k], dd[k])
            own[k] = np.where(act, new[k], own[k])
    b0, b1, b2 = best
    state = np.where((b0 >= b1) & (b0 >= b2), 0, np.where(b1 >= b2, 1, 2))
    return np.stack([np.choose(state, best) >> P.SCOREOFFSET,
                     np.choose(state, bcol), state]).astype(i32)


def fill_walk_emulation(reads, refs, rows, P, variant, steps):
    """msa_fill_walk_launch's kernel in numpy: the mapping's sweep into the
    shared-memory block of ``fill_walk_shape``'s pitch, then one walk a
    job over that block alone (walk_job), the tail zeroed. Returns (out,
    syms, out_len, gaps, row_end, the shared-memory blocks)."""
    B, R = reads.shape
    C = refs.shape[1]
    shape = msa_kernels.fill_walk_shape(R, C, B, variant)
    codes = SmemCodes(B, R, C, shape.pitch, shape.packed)
    out = row_schedule(reads, refs, rows, P, codes.store)
    walked = walk_kernel_emulation(
        None, reads, refs, out[1], out[2], R, C, steps,
        code_at=codes.code_at)
    return (out, *walked, codes.smem)


@pytest.mark.parametrize("variant", msa_kernels.FILL_WALK_VARIANTS)
@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R, C, steps", [
    (31, 54, 0),           # one warp of rows; C even
    (40, 63, 40 + 23 + 16),  # C odd (a lone last nibble)
    (47, 70, 25),          # cut walks
    (100, 123, 0),         # four warps, the last partly empty
])
def test_kernel_schedule_matches_plain(variant, prof, R, C, steps):
    """The emulated kernel equals msa_fill_walk_plain on every output; the
    walk read only stored cells (a poisoned byte fails), and the cells off
    the window stayed poisoned."""
    P = PROFILES[prof]
    B = 6
    reads, refs, rows = clipped_batch(R * 3 + C, B, R, C)
    got = fill_walk_emulation(reads, refs, rows, P, variant, steps)
    want = msa_kernels.msa_fill_walk_plain(t(reads), t(refs), t(rows), P,
                                           steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    smem = got[5]
    shape = msa_kernels.fill_walk_shape(R, C, B, variant)
    need = (C + 1) // 2 if shape.packed else C
    assert (smem[:, :, :need] != POISON).all()       # every cell stored
    assert (smem[:, :, need:] == POISON).all()       # the pitch's pad not


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R, C, want", [
    (320, 344, "row"),            # 352 threads a block
    (645, 669, "row_packed"),     # 672: the widest block the route gives
])
def test_kernel_schedule_wide_rows(prof, R, C, want):
    """The route's own variant at wide reads: the emulated kernel equals
    msa_fill_walk_plain, and one more row leaves the fused route."""
    P = PROFILES[prof]
    B = 5
    assert msa_kernels.fill_walk_shape(R, C, B).variant == want
    if want == "row_packed":
        assert msa_kernels.fill_walk_shape(R + 1, C + 1, B) is None
    reads, refs, rows = clipped_batch(R + C, B, R, C)
    got = fill_walk_emulation(reads, refs, rows, P, None, 0)
    want_ = msa_kernels.msa_fill_walk_plain(t(reads), t(refs), t(rows), P)
    for g, w in zip(got, want_):
        np.testing.assert_array_equal(g, w.numpy())


def test_kernel_schedule_per_job_rows():
    """Rows below R (the read padded with N) in both packings: the best
    is taken on each job's own last row, codes of every row are stored."""
    P = PROFILES["short"]
    R, C, B = 45, 68, 5
    reads, refs, rows = batch_of(77, B, R, C, gap=True)
    rows[0] = R - 9
    reads[0, rows[0]:] = ord("N")
    want = msa_kernels.msa_fill_walk_plain(t(reads), t(refs), t(rows), P)
    for variant in msa_kernels.FILL_WALK_VARIANTS:
        got = fill_walk_emulation(reads, refs, rows, P, variant, 0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


# ---- the route -------------------------------------------------------------

@pytest.mark.parametrize("R, C, jobs, want", [
    (150, 174, 8192, "row"),             # the fused program's T fill
    (150, 174, None, "row"),
    (150, 606, 64, "row"),               # its retry at Cw
    (150, 170, 256, "row"),              # rescue and refit chunks
    (150, 606, 1023, "row"),
    (150, 606, 1024, "row_packed"),      # 2 byte blocks an SM: packed
    (150, 606, None, "row_packed"),
    (300, 360, 4096, "row_packed"),
    (320, 400, 16, "row"),
    (150, 1600, 64, "row_packed"),       # only the packed block fits
    (150, 2900, 8192, "row_packed"),
    (150, 3100, 64, None),               # the codes exceed shared memory
    (150, 3200, 8192, None),
    (1023, 1100, 16, None),
    (1024, 1100, 16, None),              # past the one-row mapping
    (6000, 6456, 16, None),              # long reads: band fill + walk
    (0, 10, 8, None),
])
def test_route_by_shape(R, C, jobs, want):
    """Which launches the fused kernel holds (else the two-kernel route);
    a shape's block fits a block's shared memory, its pitch holds a row,
    and a forced variant that cannot hold the job raises."""
    s = msa_kernels.fill_walk_shape(R, C, jobs)
    assert (s.variant if s else None) == want
    for v in msa_kernels.FILL_WALK_VARIANTS:
        try:
            f = msa_kernels.fill_walk_shape(R, C, jobs, v)
        except ValueError:
            f = None
        if f is None:
            continue
        assert f.smem_bytes <= msa_kernels.SMEM_MAX
        assert f.pitch >= ((C + 1) // 2 if f.packed else C)
        assert f.threads == (R + 32) // 32 * 32 <= 1024
        assert f.smem_bytes == 24 * (R + 1) + (C + 15) // 16 * 16 \
            + R * f.pitch
    if R > 1023 or R < 1:
        for v in msa_kernels.FILL_WALK_VARIANTS:
            with pytest.raises(ValueError):
                msa_kernels.fill_walk_shape(R, C, jobs, v)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs msa_fill_walk_plain, builds and
    counts nothing; the route is chosen by shape, with no try/except that
    could step down to another route."""
    def no_kernel(name):
        raise AssertionError(f"a kernel library was loaded: {name}")
    monkeypatch.setattr(msa_kernels, "_lib", no_kernel)
    msa_kernels.reset_launches()
    R, C, B = 20, 36, 4
    reads, refs, rows = batch_of(5, B, R, C)
    got = msa_kernels.msa_fill_walk(t(reads), t(refs), t(rows),
                                    PROFILES["short"], 30)
    want = msa_kernels.msa_fill_walk_plain(t(reads), t(refs), t(rows),
                                           PROFILES["short"], 30)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert msa_kernels.msa_fill_walk.launches == 0
    assert not any(msa_kernels.msa_fill_walk.launches_by.values())
    assert set(msa_kernels.msa_fill_walk.launches_by) == \
        set(msa_kernels.FILL_WALK_VARIANTS)
    assert "try:" not in inspect.getsource(msa_kernels.msa_fill_walk)
    with pytest.raises(ValueError):
        msa_kernels.msa_fill_walk(t(reads), t(refs), t(rows),
                                  PROFILES["short"], -1)


def test_source_agrees_with_fill_walk_shape():
    """What the launcher in csrc/msa_fill_walk.cu recomputes and refuses
    to differ from: rows rounded up to 32 threads, at most 1,024, the
    window's bytes, a row's bytes, and the C interface."""
    src = (CSRC / "msa_fill_walk.cu").read_text()
    assert "threads != (R + 32) / 32 * 32 || threads > kMaxThreads" in src
    assert msa_kernels.SHORT_MAX_ROWS + 1 == msa_kernels.MAX_THREADS
    assert re.search(r"int window_bytes\(int C\) \{\s*return "
                     r"\(C \+ 15\) / 16 \* 16;", src)
    assert "return packed ? (C + 1) / 2 : C;" in src
    assert "6 * static_cast<size_t>(R + 1) * sizeof(int)" in src
    assert set(msa_kernels._INTERFACE["msa_fill_walk"]) == set(
        re.findall(r"cudaError_t (msa_\w+_launch)\(", src))
    n_args = len(re.search(r"cudaError_t msa_fill_walk_launch\(([^)]*)\)",
                           src).group(1).split(","))
    assert n_args == len(msa_kernels._INTERFACE["msa_fill_walk"]
                         ["msa_fill_walk_launch"])


# ---- the fused program -----------------------------------------------------

def test_fused_program_takes_the_fused_entry_point(setup, monkeypatch):  # noqa: F811
    """fused_stage fills and walks its T jobs (bounded at Cn + 16 steps)
    and its RT retry jobs (full length, through msa_align_batch) through
    msa_fill_walk, and never calls the separate fill or walk."""
    calls, direct = [], []
    fill_walk = msa_kernels.msa_fill_walk

    def spy(reads, refs, rows, P, steps=0, variant=None):
        calls.append((tuple(reads.shape), refs.shape[1], steps))
        return fill_walk(reads, refs, rows, P, steps, variant)
    monkeypatch.setattr(msa_kernels, "msa_fill_walk", spy)
    for name in ("msa_fill", "msa_walk"):
        monkeypatch.setattr(msa_kernels, name,
                            lambda *a, _n=name, **k: direct.append(_n))
    g, genome, index = setup
    L, Bp = 48, 32
    r1, r2 = make_pairs(g, Bp, L=L, insert=110, seed=41)
    ft = tfd.build_fused_pair(DeviceIndex(convert.index(index), "cpu"), L,
                              Bp)
    d = ft(r1, r2, 150).host()
    assert d["_trace"]["tloc"].min() < 2 ** 30
    assert not direct
    fcfg = ft.fcfg
    assert calls == [((fcfg.T, L), fcfg.Cn, fcfg.Cn + 16),
                     ((fcfg.RT, L), fcfg.Cw, 0)]
