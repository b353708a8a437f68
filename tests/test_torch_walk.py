"""The walk kernel's tile schedule (bbmap_tpu_torch/csrc/msa_walk.cu) on
the CPU: a numpy emulation of where the kernel anchors a tile of the
row-major block's prev codes, when it refills one, which tile it
prefetches and what the tile loads copy (16-byte pieces), with every
byte of the two shared-memory buffers tagged by the cell it was loaded
from, so that a read of a byte the schedule did not load for that cell
fails (the wave-major block is read in place); and of the kernel's loop
around it, which
extends the scalar emulation of the walk (``walk_kernel_emulation``,
tests/test_torch_msa.py): lane 0 records states only, and the warp
decodes them into symbols 32 at a time from a scan of the moves. Held
against ``walk_plain`` and the JAX package's ``_walk_device`` on both
layouts: long deletions (the walk leaves a tile sideways), long
insertions (it leaves upward), cut walks, 'X' padding, the fill's own
starts and shifted ones. A refill rule that reads one column past a
tile's left edge fails it. The emulation takes the kernel's tile, step
buffer and prefetch margin from the source.

Tolerance: exact (byte codes, symbols, counts)."""

import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.ops import msa_jax
from bbmap_tpu_torch.ops import msa, msa_kernels

from .test_torch_fillwalk import CSRC
from .test_torch_msa import JAX_PROFILES, PROFILES, batch_of, t

torch.set_num_threads(2)

POISON = 0xEE
# the kernel's constants: tile rows T and columns W, the steps kBuf lane 0
# records between two decodes, the columns kMargin a prefetch keeps right
# of its diagonal guess
KERNEL = {k: int(v) for k, v in re.findall(
    r"constexpr int (\w+) = (\d+);", (CSRC / "msa_walk.cu").read_text())}
MARGIN = KERNEL["kMargin"]


def tiles(prevs: torch.Tensor, layout) -> bool:
    """The launcher's rule (msa_walk_launch): a block is tiled where a
    job's rows are contiguous and 16-byte aligned; any other layout is read
    in place."""
    job_stride = prevs.shape[1] * prevs.shape[2]
    return (layout.col == 1 and layout.row % 16 == 0
            and layout.base % 16 == 0 and job_stride % 16 == 0
            and prevs.data_ptr() % 16 == 0)


class DirectCodes:
    """One job's prev codes read straight from its block, as the kernel
    reads a layout it does not tile (the wave-major block)."""

    def __init__(self, block, layout):
        self.block, self.lay = block, layout
        self.stats = Counter()

    def enter(self, row, cc):
        pass

    def stop(self):
        return 1, 1

    def read(self, row, cc):
        return int(self.block[self.lay.base + row * self.lay.row
                              + cc * self.lay.col])


class TiledCodes:
    """One job's prev codes as the kernel's schedule stages them: tiles of
    T rows x W = T + S columns in two buffers. ``enter`` is the refill rule
    at a position outside the current tile, ``read`` a code read from the
    buffer, which fails for a byte loaded for another cell; ``stop`` is the
    walker's rule for staying in the tile, which ``edge`` > 0 lets run that
    many columns past the tile's left edge (a mutation). ``stats`` counts
    fresh loads, prefetch hits and misses, and the side each tile was left
    by."""

    def __init__(self, block, layout, R, C, T, S, edge=0):
        self.block, self.lay, self.R, self.C = block, layout, R, C
        self.T, self.W, self.edge = T, T + S, edge
        self.buf = np.full(2 * T * self.W, POISON, np.uint8)
        self.tag = np.full((2 * T * self.W, 2), -1, np.int64)
        self.cur = self.nxt = None
        self.cb = 0
        self.stats = Counter()

    def tile_at(self, row, cc, margin):
        return (row - self.T + 1, ((cc + margin) & ~15) - self.W + 16)

    def inside(self, tile, row, cc):
        return tile is not None and tile[0] <= row < tile[0] + self.T \
            and tile[1] <= cc < tile[1] + self.W

    def load(self, slot, tile):
        """16-byte pieces of rows 1..R that start at column 0 or later and
        end inside the row's stride."""
        T, W, R, lay = self.T, self.W, self.R, self.lay
        off = slot * T * W
        for i in range(T):
            r = tile[0] + i
            if not 1 <= r <= R:
                continue
            for j in range(0, W, 16):
                c = tile[1] + j
                if 0 <= c < lay.row:
                    a = lay.base + r * lay.row + c
                    self.buf[off + i * W + j:off + i * W + j + 16] = \
                        self.block[a:a + 16]
                    self.tag[off + i * W + j:off + i * W + j + 16] = \
                        [(r, c + k) for k in range(16)]

    def enter(self, row, cc):
        """The tile that holds (row, cc): the current one, the prefetched
        one, or one loaded there; then the prefetch of the tile where a
        diagonal walk would leave it."""
        if self.inside(self.cur, row, cc):
            return
        if self.cur is not None:
            self.stats["left up" if row < self.cur[0] else "left sideways"] \
                += 1
        if self.inside(self.nxt, row, cc):
            self.cur, self.cb = self.nxt, self.cb ^ 1
            self.stats["prefetch hit"] += 1
        else:
            self.stats["prefetch miss" if self.nxt else "fresh"] += 1
            self.cur = self.tile_at(row, cc, 0)
            self.load(self.cb, self.cur)
        self.nxt = None
        gr = self.cur[0] - 1
        gc = max(cc - (row - self.cur[0] + 1), 1)
        if gr >= 1:
            self.nxt = self.tile_at(gr, gc, MARGIN)
            self.load(self.cb ^ 1, self.nxt)

    def stop(self):
        """The least row and column the walker stays at."""
        return max(self.cur[0], 1), max(self.cur[1] - self.edge, 1)

    def read(self, row, cc):
        T, W = self.T, self.W
        k = (self.cb * T * W + (row - self.cur[0]) * W + cc - self.cur[1]) \
            % len(self.buf)
        if tuple(self.tag[k]) != (row, cc):
            raise AssertionError(f"cell ({row}, {cc}) read from a byte "
                                 f"loaded for {tuple(self.tag[k])}")
        return int(self.buf[k])


DEFINED = set(b"ACGTU")


def symbol(st, c_, r_, col, C):
    """walk_symbol of csrc/msa_dp.cuh."""
    if st == 0:
        return ord("m") if c_ == r_ else ord(
            "S" if c_ in DEFINED and r_ in DEFINED else "N")
    if st == 1:
        return ord("-") if r_ == ord("-") else ord("D")
    return ord("Y") if col >= C else ord("I")


def tiled_walk_emulation(prevs, layout, reads, refs, col0, st0, R, C, steps,
                         T, S, edge=0):
    """The loop of msa_walk_kernel, a job at a time: the 'X' steps past
    column 0 written at once; else the tile entered (TiledCodes, where
    ``tiles`` gives tiles; else DirectCodes), lane 0's run of up to
    kBuf steps recording states only, and the warp's decode of them 32 at
    a time from a scan of the moves (rows in the low 16 bits, columns in
    the high). ``prevs`` (B, rows, pitch) in ``layout``. Returns (symbols,
    out_len, gaps, row_end, stats)."""
    tiled = tiles(torch.from_numpy(prevs), layout)
    flat = prevs.reshape(len(prevs), -1)
    B = len(col0)
    n_max = steps if steps else R + C
    syms = np.full((B, n_max), POISON, np.uint8)
    out_len, gaps_o, row_end = (np.zeros(B, np.int32) for _ in range(3))
    stats = Counter()
    for b in range(B):
        codes = TiledCodes(flat[b], layout, R, C, T, S, edge) if tiled \
            else DirectCodes(flat[b], layout)
        row, col, st, gaps, n = R, int(col0[b]), int(st0[b]), 0, 0
        while n < n_max and row > 0:
            if col <= 0:
                cnt = min(n_max - n, row)
                syms[b, n:n + cnt] = ord("X")
                n, row, col = n + cnt, row - cnt, col - cnt
                break
            codes.enter(row, min(col, C))
            rstop, cstop = codes.stop()
            lim = min(KERNEL["kBuf"], n_max - n)
            states, r, c, s = [], row, col, st
            while len(states) < lim and r >= rstop and c >= cstop:
                code = codes.read(r, min(c, C))
                states.append(s)
                r, c = r - (s != 1), c - (s != 2)
                s = (code >> (2 * s)) & 3
            k, dr, dc = len(states), 0, 0
            for base in range(0, k, 32):
                sm = np.array(states[base:base + 32], np.int64)
                own = (sm != 1).astype(np.int64) | ((sm != 2) << 16)
                before = np.cumsum(own) - own
                for m, (st_m, bf) in enumerate(zip(sm, before)):
                    rm = row - dr - (bf & 0xFFFF)
                    cm = col - dc - (bf >> 16)
                    r_ = int(refs[b, min(cm, C) - 1])
                    syms[b, n + base + m] = symbol(st_m, int(reads[b, rm - 1]),
                                                   r_, cm, C)
                    gaps += st_m == 1 and r_ == ord("-")
                dr += int(own.sum()) & 0xFFFF
                dc += int(own.sum()) >> 16
            n, row, col, st = n + k, r, c, s
        syms[b, n:] = 0
        out_len[b], gaps_o[b], row_end[b] = n, gaps, row
        stats += codes.stats
    return syms, out_len, gaps_o, row_end, stats


def indel_batch(seed, B, R, C):
    """batch_of's jobs (N bases, a gap column) and, planted in the first
    rows: reads with a 40-base deletion, with a 30-base insertion, with
    both, and two hanging over the window's left edge (their walks end in
    'X' when started from the fill's column)."""
    reads, refs, _ = batch_of(seed, B, R, C, var_rows=False, gap=True)
    rng = np.random.default_rng(seed + 1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ins = rng.choice(bases, size=30).astype(np.uint8)
    for b, kind in enumerate(("del", "ins", "both", "left", "left")):
        ref = refs[b]
        if kind == "del":
            rd = np.concatenate([ref[10:60], ref[100:100 + R]])
        elif kind == "ins":
            rd = np.concatenate([ref[10:50], ins, ref[50:50 + R]])
        elif kind == "both":
            rd = np.concatenate([ref[5:35], ins, ref[35:60], ref[100:100 + R]])
        else:
            lead = 12 + 9 * (b - 3)
            rd = np.concatenate([rng.choice(bases, size=lead).astype(np.uint8),
                                 ref[:R]])
        reads[b] = rd[:R]
    return reads, refs


R_W, C_W, B_W = 96, 180, 9
# (tile rows, spare columns) the schedule is emulated at: small tiles leave
# often, the kernel's own tile, and a wide one
KERNEL_TILE = (KERNEL["T"], KERNEL["W"] - KERNEL["T"])
SCHEDULES = sorted({(16, 32), (32, 32), KERNEL_TILE})


@pytest.fixture(scope="module")
def walks():
    """For each profile and start set: the jobs, both blocks of prev codes
    (plain fill, wave-major and row-major), the starts, and the JAX
    package's fill and walk, cached per number of steps."""
    cache = {}

    def get(prof, starts, steps):
        key = (prof, starts)
        if key not in cache:
            P, JP = PROFILES[prof], JAX_PROFILES[prof]
            reads, refs = indel_batch(17, B_W, R_W, C_W)
            rows = np.full(B_W, R_W, np.int32)
            out, pv_w, lay_w = msa_kernels.msa_fill_plain(
                t(reads), t(refs), t(rows), P)
            _, pv_r, lay_r = msa_kernels.msa_fill_plain(
                t(reads), t(refs), t(rows), P, msa.row_major(R_W, C_W))
            col0, st0 = out[1].numpy(), out[2].numpy()
            if starts == "shifted":
                rng = np.random.default_rng(5)
                col0 = rng.integers(1, C_W + 1, B_W).astype(np.int32)
                st0 = rng.integers(0, 3, B_W).astype(np.int32)
                col0[:2] = (3, 1)               # 'X' padding after 3 / 1
            pv_x, *_ = msa_jax.msa_trace_batch_var(
                jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows),
                R_W, C_W, JP)
            cache[key] = dict(reads=reads, refs=refs, col0=col0, st0=st0,
                              blocks=((pv_w, lay_w), (pv_r, lay_r)),
                              pv_x=pv_x, jax={})
        c = cache[key]
        if steps not in c["jax"]:
            c["jax"][steps] = [np.asarray(x) for x in jax.vmap(
                lambda p, rd, rf, c0, s0: msa_jax._walk_device(
                    p, rd, rf, c0, s0, R_W, C_W, steps=steps))(
                        c["pv_x"], jnp.asarray(c["reads"]),
                        jnp.asarray(c["refs"]), jnp.asarray(c["col0"]),
                        jnp.asarray(c["st0"]))]
        return c
    return get


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("starts", ["fill", "shifted"])
@pytest.mark.parametrize("steps", [0, 60])
def test_tiled_walk_matches_plain_and_jax(walks, prof, starts, steps):
    """The kernel's loop over both layouts, tiled at each SCHEDULES tile
    over the row-major block, gives walk_plain's and _walk_device's
    symbols, out_len, gaps and row_end; its reads never touch a byte
    loaded for another cell. Walks leave tiles upward and sideways,
    prefetches hit, full walks end at row 0 (some in 'X'), walks of 60
    steps are cut."""
    c = walks(prof, starts, steps)
    reads, refs, col0, st0 = c["reads"], c["refs"], c["col0"], c["st0"]
    seen = Counter()
    for pv, lay in c["blocks"]:
        plain = msa_kernels.msa_walk_plain(pv, t(reads), t(refs), t(col0),
                                           t(st0), R_W, C_W, steps, lay)
        for p, w in zip(plain, c["jax"][steps]):
            np.testing.assert_array_equal(p.numpy(), w)
        for T, S in SCHEDULES:
            *got, stats = tiled_walk_emulation(
                pv.numpy(), lay, reads, refs, col0, st0, R_W, C_W, steps, T,
                S)
            for g, p in zip(got, plain):
                np.testing.assert_array_equal(g, p.numpy())
            seen += stats
    assert seen["left up"] and seen["left sideways"]
    assert seen["prefetch hit"] and seen["fresh"]
    syms, row_end = plain[0].numpy(), plain[3].numpy()
    if steps:
        assert (row_end > 0).all()
    else:
        assert (row_end == 0).all() and (syms == ord("X")).any()
        assert (syms == ord("D")).sum() >= 40 and (syms == ord("I")).any()


def test_refill_rule_reading_a_stale_column_fails(walks):
    """A refill rule that keeps the walker in its tile one column past
    the left edge reads a byte the schedule loaded for another cell: the
    emulation refuses it."""
    c = walks("short", "fill", 0)
    pv, lay = c["blocks"][1]
    assert lay == msa.row_major(R_W, C_W)
    args = (pv.numpy(), lay, c["reads"], c["refs"], c["col0"], c["st0"],
            R_W, C_W, 0, 16, 32)
    tiled_walk_emulation(*args)
    with pytest.raises(AssertionError, match="read from a byte loaded"):
        tiled_walk_emulation(*args, edge=1)


def test_tiles_only_for_the_row_major_block():
    """The port's row-major block meets the launcher's rule for tiles (a
    job's rows contiguous and 16-byte aligned), also from a later job on,
    at the short, the mid and the long shapes; the wave-major block does
    not, and is read straight from device memory. The kernel's tile rows
    are whole 16-byte copies."""
    assert KERNEL["W"] % 16 == 0 and KERNEL["W"] > KERNEL["T"]
    for R, C in ((96, 180), (150, 174), (1100, 1201), (6000, 6456)):
        row = torch.zeros((3, *msa.prev_block_shape(R, C, msa.row_major(
            R, C))), dtype=torch.uint8)
        wave = torch.zeros((3, *msa.prev_block_shape(R, C, msa.wave_major(
            R, C))), dtype=torch.uint8)
        assert tiles(row, msa.row_major(R, C))
        assert tiles(row[1:], msa.row_major(R, C))
        assert not tiles(wave, msa.wave_major(R, C))


def test_walk_launcher_interface():
    """The C interface the wrapper declares for msa_walk_launch has the
    source's argument count."""
    src = (CSRC / "msa_walk.cu").read_text()
    n_args = len(re.search(r"cudaError_t msa_walk_launch\(([^)]*)\)",
                           src).group(1).split(","))
    assert set(msa_kernels._INTERFACE["msa_walk"]) == {"msa_walk_launch"}
    assert n_args == len(msa_kernels._INTERFACE["msa_walk"]
                         ["msa_walk_launch"])
