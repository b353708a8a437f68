"""The port's banded edit distance (ops/banded_device.py) against the JAX
package's jitted scan (bbmap_tpu/ops/banded_device.py, run on the CPU
with BBMAP_DEVICE_BANDED=1) and the numpy band sweep, value by value
(tolerance 0); a numpy emulation of the CUDA kernel's two mappings
(csrc/banded_edit.cu: the packed sliding window, the chunked lane scan
with its carry, the early stop at saturation) against the plain version;
the kernel itself against the plain version where there is a card."""

import numpy as np
import pytest
import torch

from bbmap_tpu.ops import banded_device as jbd
from bbmap_tpu.ops.banded import banded_edit_distance
from bbmap_tpu_torch.ops import banded_device as tbd

BYTES = np.frombuffer(b"ACGTNacgt", np.uint8)


def _mutate(rng, a, n_ops):
    b = a.copy()
    for _ in range(n_ops):
        op = int(rng.integers(0, 3))
        p = int(rng.integers(0, max(1, len(b))))
        if op == 0 and len(b):
            b[p] = BYTES[int(rng.integers(0, len(BYTES)))]
        elif op == 1:
            b = np.insert(b, p, BYTES[int(rng.integers(0, len(BYTES)))])
        elif len(b) > 1:
            b = np.delete(b, p)
    return b


def _pairs(seed, n, E, max_len=300):
    """Unrelated pairs, mutated copies (up to 2E + 2 edits), lengths that
    differ by more than E, empty sides, and a far longer than b."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        la = int(rng.integers(0, max_len + 1))
        a = rng.choice(BYTES, la).astype(np.uint8)
        kind = k % 6
        if kind == 0:
            b = rng.choice(BYTES, int(rng.integers(0, max_len + 1)))
        elif kind == 1:
            b = a[:max(0, la - E - 1 - int(rng.integers(0, 5)))]
        elif kind == 2:
            b = a[:int(rng.integers(0, 4))]
        elif kind == 3 and k % 12 == 3:
            a, b = a[:0], rng.choice(BYTES, int(rng.integers(0, E + 2)))
        else:
            b = _mutate(rng, a, int(rng.integers(0, 2 * E + 3)))
        out.append((a, np.asarray(b, np.uint8)))
    return out


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


def _emulate_thread(a, la, b, lb, E, infix, La, Lb):
    """banded_thread_kernel<W> for one pair, W as the launcher picks it."""
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
    ai = int(a[0]) if rows >= 1 else 0
    nb = _byte(b, 1 - E + TOP, Lb)
    for i in range(1, rows + 1):
        ai_next = int(a[i]) if i < rows else 0
        nb_next = _byte(b, i + 1 - E + TOP, Lb)
        m = []
        for k in range(NW):             # __vcmpne4
            m.append(sum((0xFF if ((win[k] >> (8 * q)) & 0xFF) != ai else 0)
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
        for k in range(NW - 1):         # __funnelshift_r(lo, hi, 8)
            win[k] = ((win[k] >> 8) | (win[k + 1] << 24)) & 0xFFFFFFFF
        win[NW - 1] = (win[NW - 1] >> 8) | (nb << 24)
        ai, nb = ai_next, nb_next
        if rowmin > E:
            return BIG
    return _final(v, w, E, la, lb, infix)


def _emulate_warp(a, la, b, lb, E, infix, La, Lb, mem=False):
    """banded_warp_kernel<NC> (mem: banded_warp_mem_kernel) for one pair,
    the 32 lanes as a vector."""
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
    ai = int(a[0]) if rows >= 1 else 0
    nb = _byte(b, 1 - E + TOP, Lb)
    for i in range(1, rows + 1):
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


def test_store_equals_the_list_entry_point():
    """SequenceStore (length classes, a launch a class that holds lengths
    within E of the query's) gives the values of edit_distances_vs_one
    over the kept sequences of those classes, and so its decisions."""
    rng = np.random.default_rng(3)
    E = 2
    base = rng.choice(BYTES, 150).astype(np.uint8)
    kept = [_mutate(rng, base, int(rng.integers(0, 6))) for _ in range(20)]
    kept += [rng.choice(BYTES, int(n)).astype(np.uint8)
             for n in rng.integers(100, 200, 10)]
    store = tbd.SequenceStore("cpu")
    for s in kept:
        store.append(store.upload(s))
    assert len(store) == len(kept)
    for q in (base, kept[3], rng.choice(BYTES, 151).astype(np.uint8),
              rng.choice(BYTES, 40).astype(np.uint8)):
        d = store.distances(store.upload(q), E).numpy()
        near = store.near(len(q), E)
        order = [k for lo in near for k, s in enumerate(kept)
                 if tbd.length_class(len(s)) == lo]
        want = tbd.edit_distances_vs_one(q, kept, E, device="cpu")
        np.testing.assert_array_equal(d, want[order])
        assert (d <= E).any() == (want <= E).any()
        assert {k for k, s in enumerate(kept)
                if abs(len(s) - len(q)) <= E} <= set(order)


def test_store_holds_about_its_own_bytes():
    """Kept sequences of far different lengths (reads and a contig 400
    times longer) cost the device under 2 x 17/16 of their bytes: a class
    pads a sequence by under 1/16 of its length, and its capacity stays
    under twice its count."""
    rng = np.random.default_rng(5)
    lens = [100] * 9 + [40_000] + [150] * 5 + [151, 0, 7]
    store = tbd.SequenceStore("cpu")
    for n in lens:
        store.append(store.upload(rng.choice(BYTES, n).astype(np.uint8)))
    assert sorted(store.classes) == sorted({tbd.length_class(n)
                                            for n in lens})
    held = 0
    for lo, (t, lens_t, k) in store.classes.items():
        members = [n for n in lens if tbd.length_class(n) == lo]
        assert k == len(members) <= t.shape[1] < 2 * k
        assert max(members) <= t.shape[0] <= max(members) * 17 / 16
        assert sorted(lens_t[:k].tolist()) == sorted(members)
        held += t.numel()
    assert held < 2 * 17 / 16 * sum(lens)
    q = store.upload(rng.choice(BYTES, 150).astype(np.uint8))
    assert store.near(150, 1) == [144]
    assert store.distances(q, 1).shape == (6,)
    assert store.distances(store.upload(BYTES[:3]), 2).shape == (0,)


def test_kernel_equals_plain_on_the_card():
    """The kernel in the mapping the launcher picks (a thread a pair to
    E = 31, a warp a pair past it, the band in memory at E = 520) against
    the plain version on the card (chip_smoke.py does this at full size)."""
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
            mapping = "thread" if E <= 31 else "warp"
            assert tbd.banded_edit.launches_by[mapping] == 1
            assert torch.equal(got, want), (E, infix)
