"""The port's banded edit distance (ops/banded_device.py) against the JAX
package's jitted scan (bbmap_tpu/ops/banded_device.py, run on the CPU
with BBMAP_DEVICE_BANDED=1) and the numpy band sweep, value by value
(tolerance 0); a numpy emulation of the CUDA kernel's two mappings
(csrc/banded_edit.cu: the packed sliding window, the chunked lane scan
with its carry, the early stop at saturation), of the four-lane body (four
pairs in the byte lanes of a word, in the thread and the block mapping,
with the rows it runs), of the block mapping and of the containment
mapping (the pair table, the reverse complement read in place) against
the plain version; the kernel itself against the plain version where
there is a card (both band bodies forced: tests/test_torch_banded_card.py,
which runs without JAX)."""

import numpy as np
import pytest
import torch

from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.ops import banded_device as jbd
from bbmap_tpu.ops.banded import banded_edit_distance
from bbmap_tpu_torch.ops import banded_device as tbd
from tests.banded_cases import BYTES, class_case as _class_case, \
    contained_case as _contained_case, mutate as _mutate, \
    quad_words as _quad_words, random_pairs as _pairs, rc as _rc

def _stack(pairs):
    W = max(1, max(max(len(a), len(b)) for a, b in pairs))
    A = jbd._pad_rows([p[0] for p in pairs], W)
    B = jbd._pad_rows([p[1] for p in pairs], W)
    la = np.array([len(p[0]) for p in pairs], np.int32)
    lb = np.array([len(p[1]) for p in pairs], np.int32)
    return A, la, B, lb


def _plain(A, la, B, lb, E, infix, rows_out=None):
    return tbd.banded_edit_batch_plain(
        torch.from_numpy(A.T.copy()), torch.from_numpy(la),
        torch.from_numpy(B.T.copy()), torch.from_numpy(lb), E, infix,
        rows_out=rows_out).numpy()


@pytest.mark.parametrize("infix", [False, True], ids=["global", "infix"])
@pytest.mark.parametrize("E", [0, 1, 2, 4, 16, 40])
def test_plain_equals_the_jax_scan(monkeypatch, E, infix):
    """banded_edit_batch_plain and banded_edit_batch (device cpu) equal
    the JAX scan value by value; global results equal the numpy sweep
    clipped at E + 1; the entry points equal the JAX ones (infix:
    contained_distances at tol = E, global: edit_distances_vs_one)."""
    monkeypatch.setenv("BBMAP_DEVICE_BANDED", "1")
    pairs = _pairs(100 + E + 50 * infix, 48, E)
    A, la, B, lb = _stack(pairs)
    want = jbd.banded_edit_batch(A, la, B, lb, E, infix=infix)
    got = _plain(A, la, B, lb, E, infix)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbd.banded_edit_batch(A, la, B, lb, E, infix, device="cpu"), want)
    assert got.max() == E + 1 and got.min() <= E
    if not infix:
        sweep = [min(banded_edit_distance(a, b, E), E + 1) for a, b in pairs]
        np.testing.assert_array_equal(np.minimum(got, E + 1), sweep)
    rng = np.random.default_rng(7 + E)
    query = pairs[4][0] if len(pairs[4][0]) else pairs[5][0]
    others = [_mutate(rng, query, int(rng.integers(0, 2 * E + 3)))
              for _ in range(9)] + [p[1] for p in pairs[:5]] + [query]
    if infix:
        # windows as dedupe cuts them: the container +- tol around the read
        wins = [np.concatenate([rng.choice(BYTES, int(rng.integers(0, E + 1))),
                                o, rng.choice(BYTES, E)]).astype(np.uint8)
                for o in others]
        want = jbd.contained_distances(query, wins, E)
        got = tbd.contained_distances(query, wins, E, device="cpu")
    else:
        want = jbd.edit_distances_vs_one(query, others, E)
        got = tbd.edit_distances_vs_one(query, others, E, device="cpu")
        sweep = [min(banded_edit_distance(query, o, E), E + 1)
                 for o in others]
        np.testing.assert_array_equal(got, sweep)
    np.testing.assert_array_equal(got, want)
    assert got.min() <= E


# ---------------------------------------------------------------------------
# A numpy emulation of csrc/banded_edit.cu, mapping by mapping.
# ---------------------------------------------------------------------------

THREAD_EXACT = (1, 3, 5, 7, 9, 11, 13, 15)
WARP_CHUNKS = (3, 4, 6, 8, 12, 16, 24, 32)


def _byte(row, pos, Lb):
    return int(row[pos]) if 0 <= pos < Lb else 255


def _row0(d, w, E, lb, infix):
    j = d - E
    return (0 if infix else j) if d < w and 0 <= j <= lb else E + 1


def _final(v, w, E, la, lb, infix):
    if infix:
        cells = [v[d] for d in range(len(v))
                 if d < w and 0 <= la - E + d <= lb]
        return min(cells, default=E + 1)
    df = lb - la + E
    return v[df] if 0 <= df < len(v) else E + 1


def _band_row_words(v, win, ai, nb, i, E, w, W, lb):
    """band_row: one row of a thread's band on the packed window, in
    place; returns the row's least cell."""
    BIG, NW = E + 1, len(win)
    m = []
    for j in range(NW):                 # __vcmpne4
        m.append(sum((0xFF if ((win[j] >> (8 * q)) & 0xFF) != ai else 0)
                     << (8 * q) for q in range(4)))
    dlo, dhi = E + 1 - i, min(lb + E - i, w - 1)
    r = rowmin = BIG
    for d in range(W):
        ne = (m[d >> 2] >> (8 * (d & 3))) & 1
        up = (v[d + 1] if d + 1 < W else BIG) + 1
        c = min(v[d] + ne, up)
        c = c if dlo <= d <= dhi else BIG
        r = min(c, r + 1)
        v[d] = min(r, BIG)
        rowmin = min(rowmin, v[d])
    for j in range(NW - 1):             # __funnelshift_r(lo, hi, 8)
        win[j] = ((win[j] >> 8) | (win[j + 1] << 24)) & 0xFFFFFFFF
    win[NW - 1] = (win[NW - 1] >> 8) | (nb << 24)
    return rowmin


def _emulate_thread(a, la, b, lb, E, infix, La, Lb, K=1):
    """banded_thread_kernel<W> for one pair, W as the launcher picks it; K:
    thread_pair's groups of K rows (the early stop at a group's end) and
    its ring of K bytes of a and of b (slot (i - 1) mod K, each loaded K
    rows before its row); K = 1 loads a row's bytes the row before. a is
    read only at positions < min(la, La)."""
    w, BIG = 2 * E + 1, E + 1
    W = w if w in THREAD_EXACT else (32 if w <= 32 else 64)
    if not infix and abs(lb - la) > E:
        return BIG
    NW = (W + 3) // 4
    TOP = 4 * NW - 1
    v = [_row0(d, w, E, lb, infix) for d in range(W)]
    win = [sum(_byte(b, 4 * k + q - E, Lb) << (8 * q) for q in range(4))
           for k in range(NW)]
    rows = min(la, La)
    ra = [int(a[k]) if k < rows else 0 for k in range(K)]
    rb = [_byte(b, k + 1 - E + TOP, Lb) for k in range(K)]
    i = 1
    while i + K - 1 <= rows:
        for k in range(K):
            ai, nb = ra[k], rb[k]
            ra[k] = int(a[i + k + K - 1]) if i + k + K <= rows else 0
            rb[k] = _byte(b, i + k + K - E + TOP, Lb)
            rowmin = _band_row_words(v, win, ai, nb, i + k, E, w, W, lb)
        if rowmin > E:
            return BIG
        i += K
    for k in range(K - 1):              # the last rows, fewer than K
        if i + k > rows:
            break
        _band_row_words(v, win, ra[k], rb[k], i + k, E, w, W, lb)
    return _final(v, w, E, la, lb, infix)


def _emulate_warp(a, la, b, lb, E, infix, La, Lb, mem=False, ring=False):
    """banded_warp_kernel<NC> (mem: banded_warp_mem_kernel) for one pair,
    the 32 lanes as a vector; ring: warp_pair's ring across the lanes
    (lane l holds the bytes of row i0 + l for a chunk of 32 rows from i0,
    the next chunk's in flight, a row's taken by a shuffle)."""
    w, BIG = 2 * E + 1, E + 1
    nc = -(-w // 32)
    NC = nc if mem else next(c for c in WARP_CHUNKS if c >= nc)
    if not infix and abs(lb - la) > E:
        return BIG
    lane = np.arange(32)
    TOP = 32 * NC - 1
    band = [np.array([_row0(32 * c + x, w, E, lb, infix) for x in lane])
            for c in range(NC)]
    wb = [np.array([_byte(b, 32 * c + x - E, Lb) for x in lane])
          for c in range(NC)]
    rows = min(la, La)
    if ring:
        ca = [int(a[x]) if x < rows else 0 for x in lane]
        cb = [_byte(b, 1 + x - E + TOP, Lb) for x in lane]
        na = [int(a[x + 32]) if x + 32 < rows else 0 for x in lane]
        nx = [_byte(b, 33 + x - E + TOP, Lb) for x in lane]
    else:
        ai = int(a[0]) if rows >= 1 else 0
        nb = _byte(b, 1 - E + TOP, Lb)
    for i in range(1, rows + 1):
        if ring:
            k = (i - 1) & 31                # __shfl_sync(ca / cb, k)
            ai, nb = ca[k], cb[k]
            if k == 31:
                ca, cb = na, nx
                na = [int(a[i + 32 + x]) if i + 32 + x < rows else 0
                      for x in lane]
                nx = [_byte(b, i + 33 + x - E + TOP, Lb) for x in lane]
        else:
            ai_next = int(a[i]) if i < rows else 0
            nb_next = _byte(b, i + 1 - E + TOP, Lb)
        dlo, dhi = E + 1 - i, min(lb + E - i, w - 1)
        carry, rowmin = BIG, np.full(32, BIG)
        for c in range(NC):
            d = 32 * c + lane
            if mem:                     # the band read from memory
                flat = np.concatenate(band + [np.array([BIG])])
                up = flat[d + 1]
                bj = np.array([_byte(b, i - E - 1 + x, Lb) for x in d])
            else:                       # __shfl_down_sync, lane 31 fixed up
                up = np.concatenate([band[c][1:], band[c][31:]])
                up[31] = band[c + 1][0] if c + 1 < NC else BIG
                bj = wb[c]
            x = np.minimum(band[c] + (bj != ai), up + 1)
            x = np.where((d >= dlo) & (d <= dhi), x, BIG)
            s = x - lane
            off = 1
            while off < 32:             # __shfl_up_sync min scan
                y = np.concatenate([s[:off], s[:-off]])
                s = np.where(lane >= off, np.minimum(s, y), s)
                off <<= 1
            r = np.minimum(s + lane, carry + lane + 1)
            carry = int(r[31])
            band[c] = np.minimum(r, BIG)
            rowmin = np.minimum(rowmin, band[c])
        if not mem:
            for c in range(NC):         # the window slides a byte
                down = np.concatenate([wb[c][1:], wb[c][31:]])
                down[31] = wb[c + 1][0] if c + 1 < NC else nb
                wb[c] = down
        if not ring:
            ai, nb = ai_next, nb_next
        if (rowmin > E).all():
            return BIG
    return _final(np.concatenate(band), w, E, la, lb, infix)


@pytest.mark.parametrize("E,mapping", [
    (E, "thread") for E in (0, 1, 2, 4, 7, 8, 15, 16, 31)] + [
    (E, "warp") for E in (32, 40, 47, 70, 100)] + [
    (E, "warp_mem") for E in (0, 2, 40)])
def test_kernel_emulation_equals_plain(E, mapping):
    """Both mappings of the kernel, emulated pair by pair on the bytes as
    the kernel reads them (255 outside b), equal the plain version for
    global and infix pairs, with a shared query and pair-minor staging
    alike, each at the E the launcher gives it: a thread a pair to E = 31
    (2E + 1 <= 64 cells), a warp a pair from E = 32 (3 chunks). The memory
    band, whose loop takes any chunk count, runs here at small E too."""
    pairs = _pairs(300 + E, 10, E, max_len=70)
    A, la, B, lb = _stack(pairs)
    La, Lb = A.shape[1], B.shape[1]
    for infix in (False, True):
        want = _plain(A, la, B, lb, E, infix)
        got = []
        for t in range(len(pairs)):
            args = (A[t], int(la[t]), B[t], int(lb[t]), E, infix, La, Lb)
            if mapping == "thread":
                got.append(_emulate_thread(*args))
            else:
                got.append(_emulate_warp(*args, mem=mapping == "warp_mem"))
        np.testing.assert_array_equal(got, want)


def test_memory_band_past_the_registers():
    """Past 32 chunks (E >= 512) the warp mapping keeps the band in device
    memory: its emulation equals the plain version there too."""
    E = 520
    pairs = _pairs(9, 4, 3, max_len=40)
    A, la, B, lb = _stack(pairs)
    for infix in (False, True):
        want = _plain(A, la, B, lb, E, infix)
        got = [_emulate_warp(A[t], int(la[t]), B[t], int(lb[t]), E, infix,
                             A.shape[1], B.shape[1], mem=True)
               for t in range(len(pairs))]
        np.testing.assert_array_equal(got, want)


def test_rows_out_counts_the_kernel_rows():
    """rows_out: 0 for a global pair past E in length, the saturation row,
    or min(la, La) — the rows the kernel runs."""
    E = 2
    a = np.frombuffer(b"ACGTACGTAC", np.uint8)
    pairs = [(a, a), (a, a[:5]), (a, np.frombuffer(b"TTTTTTTTTT", np.uint8)),
             (a[:0], a[:2])]
    A, la, B, lb = _stack(pairs)
    rows = torch.zeros(len(pairs), dtype=torch.int32)
    got = _plain(A, la, B, lb, E, False, rows_out=rows)
    assert got.tolist() == [0, E + 1, E + 1, 2]
    assert rows.tolist() == [10, 0, 3, 0]


def _block(seqs):
    return tbd.upload_block(seqs, "cpu")


def test_store_equals_the_list_entry_point():
    """SequenceStore (length classes, a launch of the block kernel a class
    that holds lengths within E of a query's) flags a query exactly where
    edit_distances_vs_one over every kept sequence finds one within E,
    and each class it launches on holds every kept length within E of
    some query."""
    rng = np.random.default_rng(3)
    E = 2
    base = rng.choice(BYTES, 150).astype(np.uint8)
    kept = [_mutate(rng, base, int(rng.integers(0, 6))) for _ in range(20)]
    kept += [rng.choice(BYTES, int(n)).astype(np.uint8)
             for n in rng.integers(100, 200, 10)]
    store = tbd.SequenceStore("cpu")
    q, lq = _block(kept)
    store.append(q, lq, [len(x) for x in kept], list(range(len(kept))))
    assert len(store) == len(kept)
    queries = [base, kept[3], rng.choice(BYTES, 151).astype(np.uint8),
               rng.choice(BYTES, 40).astype(np.uint8)]
    q, lq = _block(queries)
    lengths = [len(x) for x in queries]
    got = store.check(q, lq, lengths, E).numpy()
    want = [(tbd.edit_distances_vs_one(x, kept, E, device="cpu")
             <= E).any() for x in queries]
    np.testing.assert_array_equal(got, want)
    assert got[:2].all() and not got[3]
    near = store.near(lengths, E)
    assert {tbd.length_class(len(s)) for s in kept
            if any(abs(len(s) - n) <= E for n in lengths)} <= set(near)


def test_store_holds_about_its_own_bytes():
    """Kept sequences of far different lengths (reads and a contig 400
    times longer) cost the device under 2 x 17/16 of their bytes past a
    class's first tile of 128: a class pads a sequence by under 1/16 of
    its length, and its capacity stays a multiple of 128 under twice its
    count once past 128. A block's kept sequences join in one copy a
    class, in order."""
    rng = np.random.default_rng(5)
    lens = [100] * 9 + [40_000] + [150] * 5 + [151, 0, 7]
    seqs = [rng.choice(BYTES, n).astype(np.uint8) for n in lens]
    store = tbd.SequenceStore("cpu")
    q, lq = _block(seqs)
    keep = [i for i in range(len(seqs)) if i != 3]
    store.append(q, lq, lens, keep)
    store.append(q, lq, lens, [3] * 300)     # 300 more of one class
    kept = [lens[i] for i in keep] + [lens[3]] * 300
    assert sorted(store.classes) == sorted({tbd.length_class(n)
                                            for n in lens})
    held = 0
    for lo, (t, lens_t, k) in store.classes.items():
        members = [n for n in kept if tbd.length_class(n) == lo]
        assert k == len(members) <= t.shape[1]
        assert t.shape[1] % tbd.BLOCK_TILE == 0
        assert t.shape[1] < max(tbd.BLOCK_TILE + 1, 2 * k)
        assert max(members) <= t.shape[0] <= max(members) * 17 / 16
        assert sorted(lens_t[:k].tolist()) == sorted(members)
        held += t.numel()
    assert held < 2 * 17 / 16 * sum(kept) + tbd.BLOCK_TILE * sum(
        t.shape[0] for t, _, _ in store.classes.values())
    t100 = store.classes[tbd.length_class(100)]
    cols = [i for i in keep if lens[i] == 100] + [3] * 300
    np.testing.assert_array_equal(t100[0][:100, :t100[2]].T.numpy(),
                                  np.stack([seqs[i] for i in cols]))
    assert store.near([150], 1) == [144]
    assert store.near([3], 2) == []
    flags = store.check(*_block([seqs[12], BYTES[:3]]), [150, 3], 1)
    assert flags.tolist() == [1, 0]


# ---------------------------------------------------------------------------
# The block mapping (banded_block_kernel): a numpy emulation of its tiles,
# query groups, vote and triangle, against the plain version.
# ---------------------------------------------------------------------------

def _emulate_block(qT, lq, sT, ls, E, tri, group, tile=8, warp=4):
    """banded_block_kernel on numpy arrays, ``tile`` sequences a block
    and ``warp`` lanes a vote in place of 128 and 32: blocks over (tiles,
    query groups) in any order; each thread runs thread_pair (its
    emulation above) on the staged bytes, and a warp's vote sets a
    query's flag, or the thread writes its cell of the triangle."""
    Q, Lq = qT.shape[1], qT.shape[0]
    if tri:
        sT, ls = qT, lq
    k, Ls = sT.shape[1], sT.shape[0]
    out = np.zeros((Q, Q) if tri else Q, np.uint8)
    blocks = [(bx, by) for bx in range(-(-k // tile))
              for by in range(-(-Q // group))]
    rng = np.random.default_rng(len(blocks))
    for bx, by in (blocks[i] for i in rng.permutation(len(blocks))):
        j0, g0 = bx * tile, by * group
        st = np.zeros((Ls, tile), np.uint8)           # the staged tile
        st[:, :min(tile, k - j0)] = sT[:, j0:j0 + tile]
        sq = qT[:, g0:g0 + group]                      # the staged group
        for g in range(sq.shape[1]):
            i = g0 + g
            hits = np.zeros(tile, bool)
            for t in range(tile):
                j = j0 + t
                if j < k and (not tri or j < i):
                    hits[t] = _emulate_thread(sq[:, g], int(lq[i]), st[:, t],
                                              int(ls[j]), E, False, Lq,
                                              Ls) <= E
                    if tri:
                        out[i, j] = hits[t]
            if not tri and hits.reshape(-1, warp).any(1).any():
                out[i] = 1
    return out


@pytest.mark.parametrize("E", [0, 1, 2])
@pytest.mark.parametrize("group", [1, 3, 16])
def test_block_emulation_equals_plain(E, group):
    """The block mapping, emulated block by block in a random order
    (tiles, query groups, the staged bytes, the warp vote, the triangle),
    equals banded_any_plain, which equals any() over the list entry point;
    lengths at a class's edges and past E of the class."""
    qT, lq, sT, ls = _class_case(40 + E + group, E, 13, 21)
    plain = tbd.banded_any_plain(torch.from_numpy(qT), torch.from_numpy(lq),
                                 torch.from_numpy(sT), torch.from_numpy(ls),
                                 E).numpy()
    got = _emulate_block(qT, lq, sT, ls, E, False, group)
    np.testing.assert_array_equal(got, plain)
    seqs = [sT[:n, j] for j, n in enumerate(ls)]
    want = [(tbd.edit_distances_vs_one(qT[:n, i], seqs, E, device="cpu")
             <= E).any() for i, n in enumerate(lq)]
    np.testing.assert_array_equal(plain, want)
    assert 0 < plain.sum() < len(plain)
    tri = tbd.banded_any_plain(torch.from_numpy(qT), torch.from_numpy(lq),
                               None, None, E, tri=True).numpy()
    np.testing.assert_array_equal(
        _emulate_block(qT, lq, None, None, E, True, group), tri)
    for i, n in enumerate(lq):
        d = tbd.edit_distances_vs_one(qT[:n, i], [qT[:m, j] for j, m in
                                                  enumerate(lq[:i])], E,
                                      device="cpu")
        np.testing.assert_array_equal(tri[i, :i], d <= E)
    assert not np.triu(tri).any() and tri.any()


def test_block_groups_fill_the_card(monkeypatch):
    """Queries a block: several blocks an SM over the class's tiles (of
    the thread body's 128 sequences and of the quad body's 512), at most
    BLOCK_MAX_GROUP a block, never more than the queries."""
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    for tile in (tbd.BLOCK_TILE, tbd.BLOCK_QUAD_TILE):
        for Q, k in ((512, 1_000), (512, 15_000), (512, 100_000), (3, 50),
                     (1, 10**6)):
            g = tbd.block_groups(Q, k, "cuda", tile)
            blocks = -(-k // tile) * -(-Q // g)
            assert 1 <= g <= min(Q, tbd.BLOCK_MAX_GROUP)
            assert blocks >= min(tbd.BLOCK_AIM_PER_SM * 132,
                                 -(-k // tile) * Q) or \
                g == tbd.BLOCK_MAX_GROUP
    assert tbd.block_groups(512, 15_000, "cuda") == \
        tbd.block_groups(512, 15_000, "cuda", tbd.BLOCK_QUAD_TILE)


# ---------------------------------------------------------------------------
# The four-lane body (quad_pairs): four pairs in the byte lanes of a word,
# each cell's value x as its headroom D(x) = (1 << (E + 1 - x)) - 1, a min
# an OR, + 1 a shift within the lane. The same word operations in the same
# order on Python ints, against the plain version, with the rows it runs.
# ---------------------------------------------------------------------------

M32, ONES, LOW7, HIGH = 0xFFFFFFFF, 0x01010101, 0x7F7F7F7F, 0x80808080


def _spread_top(x):
    """prmt.b32 x, 0, 0xba98: each byte lane's top bit replicated."""
    return sum(0xFF << 8 * q for q in range(4) if (x >> (8 * q + 7)) & 1)


def _nonzero_lanes(x):
    return _spread_top((((x & LOW7) + LOW7) | x) & M32)


def _ge_lanes(x, y):
    return _spread_top(((x | HIGH) - y) & M32)


def _lanes_above(v, at, live):
    return sum(0xFF << 8 * q for q in range(4) if v[q] > at) & live


def _quad_pick(v, la, lb, E, infix):
    W, pick = len(v), 0
    if not infix:
        df = sum(((lb[q] - la[q] + E) & 0xFF) << 8 * q for q in range(4))
        for d in range(W):
            pick |= v[d] & ~_nonzero_lanes(df ^ (d * ONES)) & M32
    else:
        lo = hi = 0
        for q in range(4):
            h = min(W - 1, lb[q] + E - la[q])
            lo |= (16 if h < 0 else max(0, E - la[q])) << 8 * q
            hi |= max(h, 0) << 8 * q
        for d in range(W):
            pick |= v[d] & _ge_lanes(d * ONES, lo) & _ge_lanes(hi, d * ONES)
    return pick


def _emulate_quad(a_word, b_word, la, lb, lanes, La, E, infix, freeze):
    """quad_pairs<W = 2E + 1, FREEZE> for the four lanes of ``lanes``:
    a_word(pos) / b_word(pos) the four lanes' bytes at a position (b_word
    255 past Lb). Returns (each lane's D of its distance, the rows run)."""
    W, BIG = 2 * E + 1, E + 1
    rows = [min(x, La) for x in la]
    alive = lbc = last = 0
    rows_min = lb_min = 1 << 31
    for q in range(4):
        m = 0xFF << 8 * q
        if lanes & m and (infix or abs(lb[q] - la[q]) <= E):
            alive |= m
            last = max(last, rows[q])
            rows_min = min(rows_min, rows[q])
            lb_min = min(lb_min, lb[q])
        lbc |= min(lb[q], 127) << 8 * q
    if not alive:
        return 0, 0
    v, win, vwin = [0] * W, [0] * W, [0] * W
    for d in range(W):
        j = d - E
        if j >= 0:
            d0 = (1 << BIG) - 1 if infix else (1 << (W - d)) - 1
            v[d] = (d0 * ONES) & _ge_lanes(lbc, j * ONES) & alive
            vwin[d] = _ge_lanes(lbc, (j + 1) * ONES)
        win[d] = b_word(j) if j >= 0 else M32
    aw = a_word(0) if last >= 1 else 0
    nb = b_word(1 + E)
    ran = 0
    for i in range(1, last + 1):
        ran = i
        a_next = a_word(i) if i < last else 0
        nb_next = b_word(i + 1 + E)
        act = _lanes_above(rows, i - 1, alive) if freeze and i > rows_min \
            else alive
        r = any_ = 0
        s = (v[0] >> 1) & LOW7
        for d in range(W):
            up = (v[d + 1] >> 1) & LOW7 if d + 1 < W else 0
            ne = _nonzero_lanes(win[d] ^ aw)
            c = ((v[d] & ~ne) | s | up) & vwin[d]
            r = c | ((r >> 1) & LOW7)
            v[d] = (r & act) | (v[d] & ~act & M32) if freeze else r
            any_ |= r
            s = up
        win = win[1:] + [nb]
        vwin = vwin[1:] + [M32 if i + E < lb_min
                           else _lanes_above(lb, i + E, alive)]
        nb, aw = nb_next, a_next
        if not any_ & act & ONES:
            break
    return _quad_pick(v, la, lb, E, infix) & alive, ran


def _lane_word(col, pos, k0, n):
    """Bytes (pos, k0 .. k0 + 3) of a pair-minor column block as a word
    (bytes past n are the padding's zeros)."""
    return sum(int(col[pos, k0 + q]) << 8 * q
               for q in range(4) if k0 + q < n)


def _emulate_thread_quad(A, la, B, lb, E, infix, La, Lb, shared=False):
    """banded_thread_quad_kernel on numpy arrays: A (La, n) or, shared,
    (La,) one query; B (Lb, n); la, lb (n,). A thread pairs 4t .. 4t + 3;
    FREEZE where the lengths of a are the pairs' own. Returns (the
    distances, each thread's rows run, its four pairs)."""
    n = len(lb)
    out, runs = [], []
    for k0 in range(0, n, 4):
        cnt = min(4, n - k0)
        la4 = [int(la[k0 + q]) if q < cnt else 0 for q in range(4)]
        lb4 = [int(lb[k0 + q]) if q < cnt else 0 for q in range(4)]
        lanes = sum(0xFF << 8 * q for q in range(cnt))
        if shared:
            def a_word(pos):
                return int(A[pos]) * ONES
        else:
            def a_word(pos, k0=k0):
                return _lane_word(A, pos, k0, n)

        def b_word(pos, k0=k0):
            return _lane_word(B, pos, k0, n) if pos < Lb else M32
        pick, ran = _emulate_quad(a_word, b_word, la4, lb4, lanes, La, E,
                                  infix, freeze=len(set(la4[:cnt])) > 1)
        out += [E + 1 - bin((pick >> 8 * q) & 0xFF).count("1")
                for q in range(cnt)]
        runs.append((ran, list(range(k0, k0 + cnt))))
    return np.array(out, np.int32), runs


def _check_rows(runs, rows, freeze_ok):
    """A thread runs to its four pairs' last row the plain scan needs (one
    more where the pairs' rows differ and the last live pair's ended)."""
    for ran, ks in runs:
        need = max(int(rows[k]) for k in ks)
        assert need <= ran <= need + (1 if freeze_ok else 0), (ran, need, ks)


@pytest.mark.parametrize("infix", [False, True], ids=["global", "infix"])
@pytest.mark.parametrize("E", list(range(8)))
def test_quad_emulation_equals_plain(E, infix):
    """The four-lane body, emulated word by word (banded_thread_quad_kernel
    with its per-pair lengths and with a shared query), equals the plain
    version for E = 0-7, global and infix, on words whose four lanes
    differ in la and lb (a lane that ends early, an empty side, |lb - la|
    = E + 1), N, IUPAC and lowercase bytes, n not a multiple of 4; and each
    thread runs exactly the rows its pairs need."""
    for seed, n in ((E, 37), (50 + E, 42)):
        pairs = _quad_words(seed, E, n) + _pairs(900 + seed, 9, E, 50)
        A, la, B, lb = _stack(pairs)
        AT, BT = A.T.copy(), B.T.copy()
        rows = torch.zeros(len(pairs), dtype=torch.int32)
        want = _plain(A, la, B, lb, E, infix, rows_out=rows)
        got, runs = _emulate_thread_quad(AT, la, BT, lb, E, infix,
                                         AT.shape[0], BT.shape[0])
        np.testing.assert_array_equal(got, want)
        _check_rows(runs, rows, True)
        assert want.min() <= E < want.max()
        # one query against every b, as _vs_query stages it
        q = AT[:, 0]
        lq = np.full(len(pairs), la[0], np.int32)
        rows = torch.zeros(len(pairs), dtype=torch.int32)
        want = tbd.banded_edit_batch_plain(
            torch.from_numpy(q.copy()), torch.from_numpy(lq),
            torch.from_numpy(BT), torch.from_numpy(lb), E, infix,
            rows_out=rows).numpy()
        got, runs = _emulate_thread_quad(q, lq, BT, lb, E, infix,
                                         AT.shape[0], BT.shape[0], True)
        np.testing.assert_array_equal(got, want)
        _check_rows(runs, rows, False)


def _emulate_block_quad(qT, lq, sT, ls, E, tri, group, threads=4, warp=2):
    """banded_block_quad_kernel on numpy arrays, ``threads`` threads a
    block (a tile of 4 x threads sequences) and ``warp`` threads a vote in
    place of 128 and 32: blocks in a random order; a thread's four
    sequences against each query of the group on the four-lane body, the
    query's byte in every lane; a warp's vote sets a query's flag, or a
    thread writes its lanes' cells of the triangle. Returns (out, [(rows
    run, [(i, j), ...])])."""
    Q, Lq = qT.shape[1], qT.shape[0]
    if tri:
        sT, ls = qT, lq
    k, Ls = sT.shape[1], sT.shape[0]
    tile = 4 * threads
    out = np.zeros((Q, Q) if tri else Q, np.uint8)
    blocks = [(bx, by) for bx in range(-(-k // tile))
              for by in range(-(-Q // group))]
    rng = np.random.default_rng(len(blocks))
    runs = []
    for bx, by in (blocks[i] for i in rng.permutation(len(blocks))):
        j0, g0 = bx * tile, by * group
        for g in range(min(group, Q - g0)):
            i = g0 + g
            hits = []
            for t in range(threads):
                j = j0 + 4 * t
                lanes = sum(0xFF << 8 * q for q in range(4)
                            if j + q < k and (not tri or j + q < i))
                lb4 = [int(ls[j + q]) if j + q < k else 0 for q in range(4)]
                la4 = [int(lq[i])] * 4

                def b_word(pos, j=j):
                    return _lane_word(sT, pos, j, k) if pos < Ls else M32
                pick, ran = _emulate_quad(
                    lambda pos, i=i: int(qT[pos, i]) * ONES, b_word, la4,
                    lb4, lanes, Lq, E, False, False) if lanes else (0, 0)
                runs.append((ran, [(i, j + q) for q in range(4)
                                   if lanes >> 8 * q & 1]))
                hits.append(pick & ONES)
                if tri:
                    for q in range(4):
                        if lanes >> 8 * q & 1:
                            out[i, j + q] = pick >> 8 * q & 1
            if not tri and any(any(hits[w:w + warp])
                               for w in range(0, threads, warp)):
                out[i] = 1
    return out, runs


@pytest.mark.parametrize("E", [0, 1, 2, 5, 7])
@pytest.mark.parametrize("group", [1, 3, 16])
def test_quad_block_emulation_equals_plain(E, group):
    """The block mapping on the four-lane body, emulated block by block in
    a random order (tiles of four sequences a thread, query groups, the
    warp vote, the triangle's lanes j < i), equals banded_any_plain; query
    and class counts that are not multiples of 4 or of the tile; each
    thread runs exactly the rows its four pairs need."""
    qT, lq, sT, ls = _class_case(70 + E + group, E, 13, 23)
    args = [torch.from_numpy(x) for x in (qT, lq, sT, ls)]
    assert qT.shape[1] % 4 and sT.shape[1] % 4
    for tri in (False, True):
        rows = []
        want = tbd.banded_any_plain(*args[:2], *(args[2:] if not tri else
                                                 (None, None)), E, tri)
        got, runs = _emulate_block_quad(qT, lq, sT, ls, E, tri, group)
        np.testing.assert_array_equal(got, want.numpy())
        assert 0 < want.sum() < want.numel()
        sT_, ls_ = (qT, lq) if tri else (sT, ls)
        for ran, ij in runs:
            if not ij:
                continue
            ii = torch.tensor([x for x, _ in ij])
            jj = torch.tensor([x for _, x in ij])
            rows = torch.zeros(len(ij), dtype=torch.int32)
            tbd.banded_edit_batch_plain(
                args[0][:, ii], args[1][ii], torch.from_numpy(sT_)[:, jj],
                torch.from_numpy(ls_)[jj], E, rows_out=rows)
            assert ran == int(rows.max()), (ran, rows.tolist())


def test_pair_minor_pitch_reads_words():
    """The numpy entry points stage a and b at a pitch of a multiple of 4
    (so the four-lane body reads a word of four pairs), values unchanged;
    words_fit takes such a view and refuses strides, pitches and bases it
    cannot read a word at a time."""
    rng = np.random.default_rng(2)
    rows = rng.choice(BYTES, (7, 11)).astype(np.uint8)
    x = tbd._pair_minor(rows, torch.device("cpu"))
    assert x.shape == (11, 7) and x.stride() == (8, 1)
    np.testing.assert_array_equal(x.numpy(), rows.T)
    assert tbd.words_fit(x, 7) and not tbd.words_fit(x[:, 1:], 6)
    full = torch.zeros((11, 64), dtype=torch.uint8)
    assert tbd.words_fit(full, 64) and tbd.words_fit(full[:, :61], 61)
    assert not tbd.words_fit(full[:, 1:], 63)          # the base
    assert not tbd.words_fit(full[:, :61].contiguous(), 61)   # the pitch
    assert not tbd.words_fit(full.T, 11)               # a pair stride
    tail = torch.zeros(10 * 64 + 61, dtype=torch.uint8)  # the last row
    assert not tbd.words_fit(tail.as_strided((11, 61), (64, 1)), 61)
    assert tbd.words_fit(tail.as_strided((11, 60), (64, 1)), 60)


def test_kernel_equals_plain_on_the_card():
    """The kernel in the mapping the launcher picks (four pairs a thread to
    E = 7 where the words align, as here, a thread a pair to E = 31, a
    warp a pair past it, the band in memory at E = 520) against the plain
    version on the card (chip_smoke.py does this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for E in (0, 2, 4, 31, 32, 40, 520):
        A, la, B, lb = _stack(_pairs(E, 64, E))
        args = [torch.from_numpy(x).to(dev) for x in
                (A.T.copy(), la, B.T.copy(), lb)]
        for infix in (False, True):
            want = tbd.banded_edit_batch_plain(*args, E, infix)
            tbd.reset_launches()
            got = tbd.banded_edit(*args, E, infix)
            mapping = "quad" if E <= 7 else "thread" if E <= 31 else "warp"
            assert tbd.banded_edit.launches_by[mapping] == 1
            assert torch.equal(got, want), (E, infix)


def test_block_kernel_equals_plain_on_the_card():
    """The block kernel, staged and in place, both modes, against its
    plain version on the card (chip_smoke.py does this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for E in (0, 2, 31):
        qT, lq, sT, ls = _class_case(E, E, 40, 300)
        q, lqd = tbd.upload_block([qT[:n, i] for i, n in enumerate(lq)], dev)
        seqs = [sT[:n, j] for j, n in enumerate(ls)]
        sb, lsd = tbd.upload_block(seqs, dev)
        for s_, what in ((sb, "staged"), (sb.contiguous(), "in place")):
            want = tbd.banded_any_plain(q, lqd, s_, lsd, E)
            tbd.reset_launches()
            assert torch.equal(tbd.banded_any(q, lqd, s_, lsd, E), want), \
                (E, what)
            assert tbd.banded_any.launches_by["class"] == 1
        want = tbd.banded_any_plain(q, lqd, None, None, E, tri=True)
        assert torch.equal(tbd.banded_any(q, lqd, None, None, E, tri=True),
                           want)


# ---------------------------------------------------------------------------
# The containment mapping (banded_contained_kernel): dedupe's containment
# check of a block of reads, a pair table, both orientations in place.
# ---------------------------------------------------------------------------

def _contained_block(reads, pairs):
    q, lq = tbd.upload_block(reads, "cpu")
    w, table = tbd.upload_windows([r for r, _ in pairs],
                                  [x for _, x in pairs], "cpu")
    return q, lq, w, table


@pytest.mark.parametrize("tol", [1, 2, 16])
def test_contained_any_plain_equals_both_orientations(monkeypatch, tol):
    """contained_any_plain flags a read exactly where, over its windows,
    min(d(read), d(reverse complement)) <= tol by contained_distances, the
    port's and the JAX package's, read by read; the windows and the table
    come back from upload_windows as they went in."""
    monkeypatch.setenv("BBMAP_DEVICE_BANDED", "1")
    reads, pairs = _contained_case(60 + tol, tol)
    q, lq, w, table = _contained_block(reads, pairs)
    assert table.tolist() == [[r for r, _ in pairs], list(range(len(pairs))),
                              [len(x) for _, x in pairs]]
    for k, (_, x) in enumerate(pairs):
        np.testing.assert_array_equal(w[:len(x), k].numpy(), x)
    got = tbd.contained_any_plain(q, lq, w, table, tol).numpy()
    want = []
    for r, read in enumerate(reads):
        wins = [x for i, x in pairs if i == r]
        if not wins:
            want.append(False)
            continue
        d = [tbd.contained_distances(x, wins, tol, device="cpu")
             for x in (read, _rc(read))]
        for x, dx in zip((read, _rc(read)), d):
            np.testing.assert_array_equal(
                dx, jbd.contained_distances(x, wins, tol))
        want.append(bool((np.minimum(*d) <= tol).any()))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(reads)
    assert tbd.contained_any(q, lq, w, table, tol).tolist() == got.tolist()


class _Strided:
    """A query column read as the kernel reads it: byte i at start + i *
    step of the column, through a 256-byte table; ``n``: the positions of
    the column the kernel may read (0 <= start + i * step < n)."""

    def __init__(self, col, start, step, tab, n=None):
        self.col, self.start, self.step, self.tab = col, start, step, tab
        self.n = len(col) if n is None else n

    def __getitem__(self, i):
        pos = self.start + i * self.step
        assert 0 <= pos < self.n, (pos, self.n)
        return int(self.tab[self.col[pos]])


def _kernel_comp_table():
    """kComp of csrc/banded_edit.cu, parsed from the source."""
    import re
    from pathlib import Path
    src = (Path(tbd.__file__).parent.parent / "csrc"
           / "banded_edit.cu").read_text()
    body = re.search(r"kComp\[256\] = \{([^}]*)\}", src).group(1)
    return np.array([int(x) for x in body.replace("\n", " ").split(",")],
                    np.uint8)


def _stage_pitch(L):
    """stage_pitch of csrc/banded_edit.cu: L rounded up to an odd number of
    words."""
    return 4 * ((-(-L // 4)) | 1)


def _ring_depth(W):
    return 8 if W <= 16 else 4 if W <= 32 else 2


def _emulate_contained(q, lq, w, table, tol, warp=4, block=8,
                       mapping="inplace"):
    """The containment mapping on numpy arrays. The thread bodies
    ("inplace", "staged", "ring"; past 64 cells the warp bodies "inplace"
    and "warp"): thread t = 2k + rc runs pair k in orientation rc, the
    reverse complement read from the forward column backward through the
    staged complement table; "staged" reads its operands only from an
    emulated shared block (block // 2 pairs, a row of stage_pitch bytes
    for each pair's query and window, random bytes outside what
    stage_pair copies); "ring" reads through thread_pair's ring of
    ring_depth(W) bytes; a warp of ``warp`` lanes votes a query's flag
    among its lanes of that query and the lowest of them stores 1; blocks
    of ``block`` threads in a random order. "split": a warp a pair, both
    orientations by _emulate_split, one store where either hits."""
    comp = _kernel_comp_table()
    tabs = (np.arange(256, dtype=np.uint8), comp)
    qn, lqn, wn, tn = (x.numpy() for x in (q, lq, w, table))
    P, E = tn.shape[1], 2 * tol
    Lq, Lw = qn.shape[0], wn.shape[0]
    w_ = 2 * E + 1
    thread_band = w_ <= 64
    W = w_ if w_ in THREAD_EXACT else (32 if w_ <= 32 else 64)
    flags = np.zeros(qn.shape[1], np.uint8)
    rng = np.random.default_rng(P)
    if mapping == "split":
        for k in rng.permutation(P):
            col, wc, lw = (int(x) for x in tn[:, k])
            la = int(lqn[col])
            d = [_emulate_split(_Strided(qn[:, col], la - 1 if rc and la
                                         else 0, -1 if rc else 1, tabs[rc],
                                         la), la, wn[:, wc], lw, tol, Lq,
                                Lw) for rc in (0, 1)]
            if min(d) <= tol:
                flags[col] = 1
        return flags
    n_threads = -(-2 * P // block) * block
    starts = list(range(0, n_threads, block))
    pq, pw, slots = _stage_pitch(Lq), _stage_pitch(Lw), block // 2
    for b0 in (starts[i] for i in rng.permutation(len(starts))):
        if mapping == "staged":         # the block's rows, then stage_pair
            sa = rng.choice(BYTES, (slots, pq)).astype(np.uint8)
            sw = rng.choice(BYTES, (slots, pw)).astype(np.uint8)
            for slot in range(slots):
                ks = b0 // 2 + slot
                if ks < P:
                    col, wc, lw = (int(x) for x in tn[:, ks])
                    n = min(int(lqn[col]), Lq)
                    sa[slot, :n] = qn[:n, col]
                    sw[slot, :min(lw, Lw)] = wn[:min(lw, Lw), wc]
        for w0 in range(b0, b0 + block, warp):
            cols, hits = [], []
            for t in range(w0, w0 + warp):
                k, rc = t >> 1, t & 1
                if k >= P:
                    cols.append(-1)
                    hits.append(False)
                    continue
                col, wc, lw = (int(x) for x in tn[:, k])
                la = int(lqn[col])
                start = la - 1 if rc and la else 0
                if mapping == "staged":
                    slot = (t - b0) >> 1
                    a = _Strided(sa[slot], start, -1 if rc else 1, tabs[rc],
                                 la)
                    bcol = sw[slot]
                else:
                    a = _Strided(qn[:, col], start, -1 if rc else 1,
                                 tabs[rc], la)
                    bcol = wn[:, wc]
                args = (a, la, bcol, lw, E, True, Lq, Lw)
                if thread_band:
                    d = _emulate_thread(*args, K=_ring_depth(W) if
                                        mapping == "ring" else 1)
                else:
                    d = _emulate_warp(*args, ring=mapping == "warp")
                cols.append(col)
                hits.append(d <= tol)
            for lane, col in enumerate(cols):
                peers = [x for x, c in enumerate(cols) if c == col]
                if col >= 0 and lane == peers[0] and any(hits[x]
                                                         for x in peers):
                    flags[col] = 1
    return flags


@pytest.mark.parametrize("tol", [1, 2, 4, 16])
def test_contained_emulation_equals_plain(tol):
    """The containment mapping's first body ("inplace"), emulated thread by
    thread (the pair table's walk, the reverse complement read in place
    through the kernel's own complement table, the vote among a query's
    lanes, blocks in a random order), equals contained_any_plain: the
    thread band to tol = 15, the warp body from tol = 16. The kernel's
    table is core/bases.COMP_ASCII."""
    np.testing.assert_array_equal(_kernel_comp_table(), COMP_ASCII)
    reads, pairs = _contained_case(80 + tol, tol, n_q=8 if tol > 4 else 12)
    args = _contained_block(reads, pairs)
    want = tbd.contained_any_plain(*args, tol).numpy()
    np.testing.assert_array_equal(_emulate_contained(*args, tol), want)
    assert 0 < want.sum() < len(reads)


# ---------------------------------------------------------------------------
# The split mapping (banded_contained_split_kernel): each of 16 lanes
# composes the min-plus map of its run of rows on the columns of a matrix
# (the headroom code, four columns to a word), then the maps meet the
# final cells from the last lane down.
# ---------------------------------------------------------------------------

def _plus1(x):
    return (x >> 1) & LOW7


def _vcmpne4(x, y):
    return sum((0xFF if ((x >> (8 * q)) & 0xFF) != ((y >> (8 * q)) & 0xFF)
                else 0) << (8 * q) for q in range(4))


def _split_row(U, win, ai, i, lb, W):
    """split_row: row i of the band on every column of U (U[d][g]: row d
    of the map, columns 4g..4g+3 in the byte lanes, headroom code)."""
    E, NG = (W - 1) // 2, (W + 3) // 4
    rep = ai * ONES
    m = [_vcmpne4(win[j], rep) for j in range(NG)]
    dlo, dhi = E + 1 - i, min(lb + E - i, W - 1)
    r = [0] * NG
    s = [_plus1(U[0][g]) for g in range(NG)]
    for d in range(W):
        ne = M32 if (m[d >> 2] >> (8 * (d & 3))) & 1 else 0
        ok = M32 if dlo <= d <= dhi else 0
        for g in range(NG):
            up = _plus1(U[d + 1][g]) if d + 1 < W else 0
            c = ((U[d][g] & ~ne & M32) | (s[g] & ne) | up) & ok
            r[g] = c | _plus1(r[g])
            U[d][g] = r[g]
            s[g] = up


def _split_maps(a, la, b, lb, tol, La, Lb, lanes=16, chunk=16):
    """Each lane's map after its rows, as banded_contained_split_kernel
    composes them: lane j's rows rows * j // lanes + 1 .. rows * (j + 1) //
    lanes, read a run of ``chunk`` rows at a time into a queue of words;
    lane 0 from row 0's band in every column, the others from the
    identity."""
    W, E = 4 * tol + 1, 2 * tol
    NG = (W + 3) // 4
    TOP, D0 = 4 * NG - 1, (1 << (E + 1)) - 1
    rows = min(la, La)
    maps = []
    for seg in range(lanes):
        r0, r1 = seg * rows // lanes, (seg + 1) * rows // lanes
        if seg == 0:
            U = [[D0 * ONES if _row0(d, W, E, lb, True) == 0 else 0
                  for _ in range(NG)] for d in range(W)]
        else:
            U = [[D0 << (8 * (d & 3)) if d >> 2 == g else 0
                  for g in range(NG)] for d in range(W)]
        win = [sum(_byte(b, r0 + 4 * j + q - E, Lb) << (8 * q)
                   for q in range(4)) for j in range(NG)]
        for i0 in range(r0 + 1, r1 + 1, chunk):
            run = range(i0, i0 + chunk)
            xa = [a[i - 1] if i <= r1 else 0 for i in run]
            xb = [_byte(b, i - E + TOP, Lb) if i <= r1 else 0 for i in run]
            qa = [sum(xa[4 * j + q] << (8 * q) for q in range(4))
                  for j in range(chunk // 4)]
            qb = [sum(xb[4 * j + q] << (8 * q) for q in range(4))
                  for j in range(chunk // 4)]
            for i in range(i0, min(r1, i0 + chunk - 1) + 1):
                _split_row(U, win, qa[0] & 0xFF, i, lb, W)
                for j in range(NG - 1):
                    win[j] = ((win[j] >> 8) | (win[j + 1] << 24)) & M32
                win[NG - 1] = (win[NG - 1] >> 8) | ((qb[0] & 0xFF) << 24)
                for q_ in (qa, qb):
                    for j in range(len(q_) - 1):
                        q_[j] = ((q_[j] >> 8) | (q_[j + 1] << 24)) & M32
                    q_[-1] >>= 8
        maps.append(U)
    return maps


def _split_join(maps, la, lb, tol):
    """The join: lane 15's min over the final cells (la - E + d in [0,
    lb]), handed down the lanes, c'[e] = min_d (c[d] + A[d][e]) by shifts
    of A's row words; the distance from lane 0's c."""
    W, E = 4 * tol + 1, 2 * tol
    BIG, NG = E + 1, (W + 3) // 4
    c = [0] * NG
    for d in range(W):
        if 0 <= la - E + d <= lb:
            c = [x | y for x, y in zip(c, maps[-1][d])]
    for U in maps[-2::-1]:              # __shfl_down_sync, a lane a step
        cc = [0] * NG
        for d in range(W):
            x = BIG - bin((c[d >> 2] >> (8 * (d & 3))) & 0xFF).count("1")
            keep = (0xFF >> x) * ONES
            cc = [y | ((U[d][g] >> x) & keep) for g, y in enumerate(cc)]
        c = cc
    return BIG - bin(c[0] & 0xFF).count("1")


def _emulate_split(a, la, b, lb, tol, La, Lb, lanes=16):
    """banded_contained_split_kernel for one orientation of a pair."""
    return _split_join(_split_maps(a, la, b, lb, tol, La, Lb, lanes), la, lb,
                       tol)


def _band_row(v, win, ai, i, lb, E, W):
    """thread_pair's row i on the band v (values), window bytes win[d] =
    b[i - E - 1 + d]."""
    BIG = E + 1
    dlo, dhi = E + 1 - i, min(lb + E - i, W - 1)
    out, r = list(v), BIG
    for d in range(W):
        up = (v[d + 1] if d + 1 < W else BIG) + 1
        c = min(v[d] + (win[d] != ai), up) if dlo <= d <= dhi else BIG
        r = min(c, r + 1)
        out[d] = min(r, BIG)
    return out


def _row_maps(a, la, b, lb, E, Lb):
    """The min-plus matrix of each row (column e: the row run on the unit
    band, 0 at e and BIG elsewhere), entries capped at BIG."""
    W, BIG = 2 * E + 1, E + 1
    out = []
    for i in range(1, la + 1):
        win = [_byte(b, i - E - 1 + d, Lb) for d in range(W)]
        cols = [_band_row([0 if d == e else BIG for d in range(W)], win,
                          int(a[i - 1]), i, lb, E, W) for e in range(W)]
        out.append(np.array(cols, np.int64).T)
    return out


def _mp(A, B, BIG):
    """min-plus product capped at BIG"""
    return np.minimum((A[:, :, None] + B[None, :, :]).min(1), BIG)


def _mp_group(maps, rng, BIG):
    """The product maps[-1] (x) ... (x) maps[0] in a random bracketing."""
    if len(maps) == 1:
        return maps[0]
    cut = int(rng.integers(1, len(maps)))
    return _mp(_mp_group(maps[cut:], rng, BIG), _mp_group(maps[:cut], rng,
                                                           BIG), BIG)


@pytest.mark.parametrize("tol", [0, 1, 2, 3])
def test_contained_split_maps_compose(tol):
    """The map algebra the split mapping rests on, on numpy seeds: each
    row's min-plus matrix applied to random bands (values 0..BIG) equals
    thread_pair's row; random bracketings of a pair's row matrices equal
    the rows run one after another from row 0's band; each lane's map in
    the kernel's headroom code (composed a row at a time on the identity)
    decodes to the product of its rows' matrices, and lane 0's to its
    band; the join in the kernel's lane order gives the band's infix
    distance."""
    E, W = 2 * tol, 4 * tol + 1
    BIG = E + 1
    rng = np.random.default_rng(40 + tol)
    reads, pairs = _contained_case(140 + tol, tol, n_q=6)
    for r, win_b in pairs[:8]:
        a, la, lb = reads[r], len(reads[r]), len(win_b)
        Lb = lb + 3
        b = np.concatenate([win_b, rng.choice(BYTES, 3)]).astype(np.uint8)
        M = _row_maps(a, la, b, lb, E, Lb)
        v = np.array([_row0(d, W, E, lb, True) for d in range(W)])
        bands = [v]
        for i, Mi in enumerate(M, 1):
            win = [_byte(b, i - E - 1 + d, Lb) for d in range(W)]
            for _ in range(3):
                x = rng.integers(0, BIG + 1, W)
                np.testing.assert_array_equal(
                    np.minimum((Mi + x[None, :]).min(1), BIG),
                    _band_row(list(x), win, int(a[i - 1]), i, lb, E, W))
            bands.append(np.array(_band_row(list(bands[-1]), win,
                                            int(a[i - 1]), i, lb, E, W)))
        for _ in range(4):
            lo = int(rng.integers(0, la))
            hi = int(rng.integers(lo + 1, la + 1))
            prod = _mp_group(M[lo:hi], rng, BIG)
            np.testing.assert_array_equal(
                np.minimum((prod + bands[lo][None, :]).min(1), BIG),
                bands[hi])
        maps = _split_maps(_Strided(a, 0, 1, np.arange(256), la), la, b, lb,
                           tol, la, Lb)
        for seg, U in enumerate(maps):
            r0, r1 = seg * la // 16, (seg + 1) * la // 16
            dec = np.array([[BIG - bin((U[d][e >> 2] >> (8 * (e & 3)))
                                       & 0xFF).count("1") for e in range(W)]
                            for d in range(W)])
            if seg == 0:
                np.testing.assert_array_equal(
                    dec, np.repeat(bands[r1][:, None], W, 1))
            elif r1 > r0:
                np.testing.assert_array_equal(dec, _mp_group(
                    M[r0:r1], rng, BIG))
            else:
                np.testing.assert_array_equal(
                    dec, np.where(np.eye(W, dtype=bool), 0, BIG))
        want = _final(list(bands[-1]), W, E, la, lb, True)
        assert _split_join(maps, la, lb, tol) == want


@pytest.mark.parametrize("tol", [0, 1, 2, 3])
def test_contained_split_row_counts(tol):
    """The split mapping against the plain version pair by pair where the
    rows do not fill the lanes evenly: 1, 5, 15, 16, 17, 31, 33 and 150
    rows (fewer rows than lanes, counts that are not multiples of 16 or
    32), a run past the 16-row queue (400 rows), queries longer than the
    window, and bands that saturate in the first rows (unrelated
    windows), both orientations."""
    E = 2 * tol
    rng = np.random.default_rng(60 + tol)
    comp = _kernel_comp_table()
    cases = []
    for n in (1, 5, 15, 16, 17, 31, 33, 150, 400):
        base = rng.choice(BYTES, n + 2 * tol + 4).astype(np.uint8)
        read = _mutate(rng, base[tol:tol + n], int(rng.integers(0, tol + 2)))
        cases += [(read, base), (read, base[:max(0, len(read) - tol - 1)]),
                  (read, rng.choice(BYTES, n + 2 * tol).astype(np.uint8))]
    for read, win_b in cases:
        la, lb = len(read), len(win_b)
        Lb = lb + 5
        b = np.concatenate([win_b, rng.choice(BYTES, 5)]).astype(np.uint8)
        for rc, (x, tab) in enumerate(((read, np.arange(256)), (read, comp))):
            want = tbd.banded_edit_batch_plain(
                torch.from_numpy(_rc(x) if rc else x.copy()),
                torch.tensor([la], dtype=torch.int32),
                torch.from_numpy(b[:, None].copy()),
                torch.tensor([lb], dtype=torch.int32), E, True)[0]
            a = _Strided(x, la - 1 if rc and la else 0, -1 if rc else 1,
                         tab, la)
            assert _emulate_split(a, la, b, lb, tol, la, Lb) == int(want), \
                (la, lb, rc)


@pytest.mark.parametrize("tol,mapping", [
    (0, "split"), (1, "split"), (2, "split"), (3, "split"),
    (1, "staged"), (2, "staged"), (4, "staged"), (7, "staged"),
    (15, "staged"), (2, "ring"), (7, "ring"), (15, "ring"), (16, "warp"),
    (2, "inplace")])
def test_contained_mappings_emulation_equal_plain(tol, mapping):
    """Each mapping of the containment kernel, emulated, equals
    contained_any_plain on dedupe's block layout: windows clipped at a
    container's ends (some shorter than the read less tol), N and
    lowercase bytes through the kernel's complement table, queries of
    different lengths in one block; "staged" reads its operands only from
    the emulated shared block, random bytes outside what was staged; the
    rule lets each mapping apply where it is emulated."""
    reads, pairs = _contained_case(170 + tol, tol, n_q=8 if tol > 4 else 12)
    # two windows cut short, as at a container's end: lb < la - tol
    pairs += [(r, x[:len(reads[r]) - tol - 1 - k]) for k, (r, x) in
              enumerate(pairs[:2])]
    args = _contained_block(reads, pairs)
    q, _, w, _ = args
    assert tbd.contained_mapping(len(pairs), tol, q.shape[0], w.shape[0],
                                 mapping) == mapping
    assert len({len(x) for x in reads}) > 3
    want = tbd.contained_any_plain(*args, tol).numpy()
    np.testing.assert_array_equal(
        _emulate_contained(*args, tol, mapping=mapping), want)
    assert 0 < want.sum() < len(reads)


def test_contained_no_pairs_and_one_pair():
    """P = 0: no flag, every mapping's rule still answers; P = 1: the one
    pair's flag in each mapping's emulation equals the plain version, hit
    and miss."""
    reads, pairs = _contained_case(211, 2, n_q=4)
    q, lq, w, table = _contained_block(reads, pairs)
    empty = table[:, :0].contiguous()
    assert tbd.contained_any_plain(q, lq, w, empty, 2).sum() == 0
    assert tbd.contained_any(q, lq, w, empty, 2).sum() == 0
    assert tbd.contained_mapping(0, 2, q.shape[0], w.shape[0]) == "split"
    seen = set()
    for k in range(table.shape[1]):
        one = table[:, k:k + 1].contiguous()
        want = tbd.contained_any_plain(q, lq, w, one, 2).numpy()
        seen.add(int(want.sum()))
        for mapping in ("split", "staged", "ring", "inplace"):
            np.testing.assert_array_equal(
                _emulate_contained(q, lq, w, one, 2, mapping=mapping), want)
    assert seen == {0, 1}


def test_contained_mapping_rule():
    """contained_mapping: "split" below CONTAINED_SPLIT_BELOW pairs where
    4 tol + 1 <= 13, else "staged" where a block's rows fit its shared
    bytes, "ring" where they do not, "warp" past 64 cells; a forced
    mapping where it applies, a ValueError where not; "inplace" never
    picked."""
    below = tbd.CONTAINED_SPLIT_BELOW
    for tol in range(0, 4):
        assert tbd.contained_mapping(1, tol, 150, 154) == "split"
        assert tbd.contained_mapping(below - 1, tol, 150, 154) == "split"
        assert tbd.contained_mapping(below, tol, 150, 154) == "staged"
        assert tbd.contained_mapping(below, tol, 5000, 5004) == "ring"
    for tol in (4, 7, 15):
        assert tbd.contained_mapping(1, tol, 150, 180) == "staged"
        assert tbd.contained_mapping(1, tol, 2000, 2030) == "ring"
        with pytest.raises(ValueError):
            tbd.contained_mapping(1, tol, 150, 180, "split")
    for tol in (16, 300):
        assert tbd.contained_mapping(1, tol, 150, 182) == "warp"
        for m in ("split", "staged", "ring"):
            with pytest.raises(ValueError):
                tbd.contained_mapping(1, tol, 150, 182, m)
    assert tbd.contained_stage_bytes(150, 154) == 64 * (156 + 156)
    assert tbd.contained_stage_bytes(376, 376) <= tbd.CONTAINED_STAGE_MAX
    assert tbd.contained_stage_bytes(381, 381) > tbd.CONTAINED_STAGE_MAX
    with pytest.raises(ValueError):
        tbd.contained_mapping(1, 2, 150, 154, "quad")
    for tol in (0, 2, 7, 16, 300):
        assert _applies("inplace", tol)
        assert all(tbd.contained_mapping(P, tol, L, L + 4 * tol) != "inplace"
                   for P in (0, 1, below, 10**6) for L in (100, 5000))
    assert set(tbd.CONTAINED_MAPPINGS) == set(tbd._CONTAINED_CODES)


def _applies(mapping, tol, Lq=150, Lw=154):
    try:
        tbd.contained_mapping(1, tol, Lq, Lw, mapping)
        return True
    except ValueError:
        return False


def test_contained_launcher_interface():
    """The wrapper and csrc/banded_edit.cu agree on the containment
    launcher: its argument count, the mapping codes of ContainedMapping,
    the split's widest band (kSplitMaxCells), the thread bodies' (64), the
    staged block (kThreads / 2 pairs, kStageMax bytes, stage_pitch) and
    the launcher's switch over the split's band widths."""
    import re
    from pathlib import Path
    from types import SimpleNamespace
    src = (Path(tbd.__file__).parent.parent / "csrc"
           / "banded_edit.cu").read_text()

    class Fake:
        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            x = SimpleNamespace()
            setattr(self, name, x)
            return x
    import bbmap_tpu_torch.ops._build as build
    fake = Fake()
    real = build.load
    build.load = lambda name: fake
    try:
        tbd._lib()
    finally:
        build.load = real
    n_args = len(re.search(r"cudaError_t banded_contained_launch\(([^)]*)\)",
                           src).group(1).split(","))
    assert n_args == len(fake.banded_contained_launch.argtypes) == 14
    codes = dict(re.findall(r"kContained(\w+) = (\d+),", src))
    assert {m: int(codes[m.capitalize()]) for m in tbd.CONTAINED_MAPPINGS} \
        == tbd._CONTAINED_CODES
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(const["kSplitMaxCells"]) == tbd.CONTAINED_SPLIT_MAX_CELLS
    assert int(const["kThreadMaxCells"]) == tbd.THREAD_MAX_CELLS
    assert const["kStagePairs"] == "kThreads / 2" and \
        int(const["kThreads"]) // 2 == tbd.CONTAINED_STAGE_PAIRS
    assert eval(const["kStageMax"]) == tbd.CONTAINED_STAGE_MAX
    assert "return 4 * (((L + 3) / 4) | 1);" in src
    split = src[src.index("case kContainedSplit:"):]
    widths = [int(x) for x in re.findall(
        r"case (\d+): return launch_contained_split",
        split[:split.index("default")])]
    assert widths == [4 * t + 1 for t in range(4)]
    assert max(widths) == tbd.CONTAINED_SPLIT_MAX_CELLS


def test_contained_kernel_equals_plain_on_the_card():
    """The containment mapping against its plain version on the card, each
    mapping forced where it applies and the one the rule picks, in the
    thread band (tol 1, 2, 3, 7, 15), on the warp body (tol 16) and, at
    tol 2, on contigs too long for the staged block ("ring"), on dedupe's
    block layout (chip_smoke.py does this at dedupe's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cases = [(tol, _contained_case(tol, tol, n_q=40))
             for tol in (1, 2, 3, 7, 15, 16)]
    cases.append((2, _contained_case(5, 2, n_q=6, n_c=3, long=True)))
    for tol, (reads, pairs) in cases:
        q, lq = tbd.upload_block(reads, dev)
        w, table = tbd.upload_windows([r for r, _ in pairs],
                                      [x for _, x in pairs], dev)
        want = tbd.contained_any_plain(q, lq, w, table, tol)
        for mapping in (None, *tbd.CONTAINED_MAPPINGS):
            if mapping and not _applies(mapping, tol, q.shape[0],
                                        w.shape[0]):
                continue
            tbd.reset_launches()
            got = tbd.contained_any(q, lq, w, table, tol, mapping)
            assert tbd.contained_any.launches == 1
            picked = mapping or tbd.contained_mapping(
                table.shape[1], tol, q.shape[0], w.shape[0])
            assert tbd.contained_any.launches_by[picked] == 1
            assert torch.equal(got, want), (tol, mapping)
