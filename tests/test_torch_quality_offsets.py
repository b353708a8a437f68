"""The port's quality-driven key offsets (bbmap_tpu_torch/align/
quickmap_device.py: ``_quality_offsets_core``, the plain version that
``quality_offsets_kernel`` runs on CPU tensors, through both stage entry
points, and the packed entry ``quality_offsets_packed_kernel``, whose plain
version unpacks the words first) against the JAX package's
``_quality_offsets_core`` and ``quality_offsets_stage_packed``, on seeded
qualities (``tests/quality_rows``): L = 150 (k = 13, nk = 18) raw and
palette-packed, and L = 6,000 (k = 12, nk = 750), with all-zero reads, q = 0
runs, reads with no usable window, low-quality ends (usable < L) and
high-quality islands (desired clamped by potential). A numpy emulation of
``csrc/quality_offsets.cu``'s order (probs, the ok2 ballot words and their
highest / lowest index tables, the ladder's positions as a prefix max past
the float additions, each step's candidates looked up from the tables, the
prev chain, the weights and the ordered reject product) is held to the
plain version, and shown to fail without either search; a model of its
q == 0 window test (one funnel shift, k <= 32) is held to the direct
check. Tolerance: exact, the float32 weights included (every
float32 operation rounds alone, in the JAX order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.align import quickmap_device as jqd
from bbmap_tpu.align import seed as seed_host
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd
from tests.quality_rows import qualities

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)
SHAPES = {"short": (150, 13), "long": (6000, 12)}


@pytest.fixture(scope="module")
def configs():
    """(JAX config, port config, den2, den3) at each shape of SHAPES."""
    rng = np.random.default_rng(2)
    g = rng.choice(BASES, size=20_000).astype(np.uint8)
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="c1")]).finalize()
    out = {}
    for name, (L, k) in SHAPES.items():
        index = build_index(genome, k)
        dix = tqd.DeviceIndex(convert.index(index), "cpu")
        cj, ct = jqd.make_config(index, L), tqd.make_config(dix, L)
        assert cj.offsets_list == ct.offsets_list
        out[name] = (cj, ct, *seed_host.key_density_ladder(L, k))
    assert len(out["long"][1].offsets_list) == 750
    return out


def _jax(cj, q, den2, den3):
    pc = seed_host.PROB_CORRECT[np.clip(q.astype(np.int32), 0, 127)]
    out = jqd._quality_offsets_core(
        cj, jnp.asarray(np.clip(q.astype(np.int32), 0, 127)),
        jnp.asarray(pc), den2, den3, return_weights=True)
    return [np.asarray(x) for x in out]


def _equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("route", ["raw", "packed"])
def test_short_plain_matches_jax(configs, route):
    cj, ct, den2, den3 = configs["short"]
    L = ct.L
    q = qualities(96, L, 1)
    want = _jax(cj, q, den2, den3)
    if route == "raw":
        got = tqd.quality_offsets_stage(ct, torch.from_numpy(q), den2, den3,
                                        return_weights=True)
    else:
        qpack, pal, pcp = tqd.pack_quality_host(q, L)
        assert qpack is not None
        got = tqd.quality_offsets_stage_packed(
            ct, torch.from_numpy(qpack.astype(np.int64)),
            torch.from_numpy(pal), torch.from_numpy(pcp), den2, den3,
            return_weights=True)
    _equal(got, want)
    offs = want[0]
    ladder = np.asarray(ct.offsets_list)
    assert (offs[0] == ladder).all() and (offs[1] == ladder).all()
    assert (offs != ladder[None, :]).any(axis=1).sum() > 60
    assert (offs[3] == -1).sum() > 0           # desired below nk
    assert want[2][5] and not want[2].all()
    # the offsets alone, as the return_weights=False callers take them
    only = tqd.quality_offsets_stage(ct, torch.from_numpy(q), den2, den3)
    np.testing.assert_array_equal(only.numpy(), offs)


def test_long_plain_matches_jax(configs):
    cj, ct, den2, den3 = configs["long"]
    q = qualities(10, ct.L, 2)
    rng = np.random.default_rng(3)
    q[8:] = rng.integers(28, 36, (2, ct.L))    # randomreads' PacBio range
    want = _jax(cj, q, den2, den3)
    got = tqd.quality_offsets_stage(ct, torch.from_numpy(q), den2, den3,
                                    return_weights=True)
    _equal(got, want)
    assert (want[0][8:] > -1).all()            # all 750 keys used
    assert want[2][5] and not want[2][8:].any()


def kernel_emulation(ct, q, pc, max_density, mutation=None):
    """numpy model of csrc/quality_offsets.cu, a read at a time: the
    windows 32 key positions a chunk, the ok1 / ok2 ballot words, the ok2
    words' prefix max of their highest set index (hw) and suffix min of
    their lowest (lw), the ladder's positions j_i as a prefix max past the
    float additions, each step's candidates from those tables (T: j where
    bit j is set, else the highest ok2 index at or below j - 1; U: j, else
    the lowest at or above j + 1 if below lim), the prev chain, the
    weights and the ordered reject product. ``mutation`` breaks it on
    purpose: "forward_only" / "backward_only" drop the backward / forward
    candidate."""
    k, L = ct.k, ct.L
    nk = len(ct.offsets_list)
    m = L - k + 1
    nw = (m + 31) // 32
    d2_tab, div_tab = tqd._offset_tables_np(L, k, nk, max_density)
    l1, l2 = np.float32(0.94), np.float32(0.9999)
    one, half = np.float32(1.0), np.float32(0.5)
    a = 100 * k
    base_ks = a // 8
    rng = np.float32(a - base_ks)
    inv = np.float32(1.0) / np.float32(a)
    B = q.shape[0]
    big = 2 ** 31 - 1
    offs_out = np.empty((B, nk), np.int32)
    wts_out = np.empty((B, nk), np.float32)
    rej_out = np.empty(B, bool)

    def ballots(flags):
        bits = np.zeros(nw * 32, bool)
        bits[:m] = flags
        return [int(x) for x in np.packbits(bits.reshape(nw, 32), axis=1,
                                            bitorder="little").view(
                                                np.uint32).ravel()]

    for b in range(B):
        prob = pc[b, :m].copy()
        zero = q[b, :m] == 0
        for j in range(1, k):
            prob = (prob * pc[b, j:m + j]).astype(np.float32)
            zero |= q[b, j:m + j] == 0
        probs = np.where(zero, one, (one - prob).astype(np.float32))
        b1, words = ballots(probs < l1), ballots(probs < l2)
        hit1 = [w for w in range(nw) if b1[w]]
        any1 = bool(hit1)
        left = hit1[0] * 32 + _ffs(b1[hit1[0]]) - 1 if any1 else 0
        right = hit1[-1] * 32 + b1[hit1[-1]].bit_length() - 1 if any1 \
            else m - 1
        hw = np.maximum.accumulate([w * 32 + x.bit_length() - 1 if x else -1
                                    for w, x in enumerate(words)])
        lw = np.minimum.accumulate([w * 32 + _ffs(x) - 1 if x else big
                                    for w, x in enumerate(words)][::-1])[::-1]
        pot = sum(bin(words[w] & _bits_in(w, left, right)).count("1")
                  for w in range(nw))
        valid = any1 and pot > 0 and right >= left
        offs = list(ct.offsets_list)
        if valid:
            usable = right - left + k
            d2 = int(d2_tab[min(max(usable, 0), L)])
            d2 = min(usable - k + 1, max(d2, 2))
            desired = min(d2, nk) if usable < L else nk
            desired = max(min(desired, pot), 1)
            span = min(max(right - left, 0), m - 1)
            interval = div_tab[span, min(max(desired - 1, 0), nk - 1)]
            iint = int(interval) + 1
            # j_i = min(i + max(left, fl_t - t for t <= i), m - 1): the
            # float additions in order, the positions a prefix max
            f, terms = np.float32(left), [left]
            for i in range(1, desired):
                f = np.float32(f + interval)
                terms.append(int(np.floor(np.float32(f + half))) - i)
            run = np.maximum.accumulate(terms)
            js = [min(i + int(run[i]), m - 1) for i in range(desired)]
            ts, us = [], []
            for j in js:
                xh, xl = min(j - 1, m - 1), j + 1
                hi_f = min(min(j + iint, right) - 1, m - 1)
                wh, wl = max(xh, 0) >> 5, min(xl, m - 1) >> 5
                bh = words[wh] & (0xFFFFFFFF >> (31 - (max(xh, 0) & 31)))
                bl = words[wl] & ((0xFFFFFFFF << (min(xl, m - 1) & 31))
                                  & 0xFFFFFFFF)
                h = wh * 32 + bh.bit_length() - 1 if bh else (
                    hw[wh - 1] if wh > 0 else -1)
                if xh < 0 or mutation == "forward_only":
                    h = -1
                lo = wl * 32 + _ffs(bl) - 1 if bl else (
                    lw[wl + 1] if wl + 1 < nw else big)
                if xl > hi_f or lo > hi_f or mutation == "backward_only":
                    lo = -1
                hit = (words[j >> 5] >> (j & 31)) & 1
                ts.append(j if hit else int(h))
                us.append(j if hit else int(lo))
            prev = -1
            for i in range(nk):
                if i >= desired:
                    offs[i] = -1
                    continue
                j, t, u = js[i], ts[i], us[i]
                x = (t if t >= prev + 3 else u) if prev < j else -1
                offs[i] = x
                prev = x if x > -1 else max(prev, j - 2)
        psel = np.array([probs[min(max(o, 0), m - 1)] if o > -1 else one
                         for o in offs], np.float32)
        t = (rng * (one - psel).astype(np.float32)).astype(np.float32)
        score = base_ks + np.floor((t + half).astype(np.float32)).astype(
            np.int32)
        offs_out[b] = offs
        wts_out[b] = (score.astype(np.float32) * inv).astype(np.float32)
        pae = psel[0]
        for i in range(1, nk):
            pae = np.float32(pae * psel[i])
        rej_out[b] = valid and pae > half
    return offs_out, wts_out, rej_out


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def _bits_in(w, lo, hi):
    a = max(lo - (w << 5), 0)
    b = min(hi - (w << 5), 31)
    return 0 if a > b else ((1 << (b + 1)) - 1) & ~((1 << a) - 1)


def zero_windows(zflags, k, masked=True):
    """numpy model of csrc/quality_offsets.cu's q == 0 test of every key
    window of one read: the flags as 32-bit words with a spare word of 0,
    a window's 32 flags from position i by one funnel shift of two words,
    masked to its k (so k <= 32). ``masked=False`` drops the mask (a broken
    model below k = 32)."""
    L = len(zflags)
    nz = (L + 31) // 32
    bits = np.zeros((nz + 1) * 32, bool)
    bits[:L] = zflags
    zw = [int(x) for x in np.packbits(bits.reshape(nz + 1, 32), axis=1,
                                      bitorder="little").view(
                                          np.uint32).ravel()]
    kmask = 0xFFFFFFFF if k >= 32 or not masked else (1 << k) - 1
    return np.array([(((zw[i >> 5] | zw[(i >> 5) + 1] << 32) >> (i & 31))
                      & kmask) != 0 for i in range(L - k + 1)])


@pytest.mark.parametrize("k", [1, 12, 13, 31, 32])
def test_zero_window_word(k):
    """The kernel's q == 0 test of a key window, one funnel shift and the
    key's mask, equals the window's direct check at every k it takes
    (1-32); without the mask it fails below 32."""
    rng = np.random.default_rng(k)
    zf = rng.random(400) < 0.01
    zf[150:159] = True
    direct = np.array([zf[i:i + k].any() for i in range(400 - k + 1)])
    assert (zero_windows(zf, k) == direct).all()
    if k < 32:
        assert (zero_windows(zf, k, masked=False) != direct).any()


@pytest.mark.parametrize("shape", ["short", "long"])
def test_kernel_emulation_matches_plain(configs, shape):
    _cj, ct, den2, den3 = configs[shape]
    q = qualities(40 if shape == "short" else 9, ct.L, 4).astype(np.int32)
    pc = seed_host.PROB_CORRECT[q]
    want = tqd.quality_offsets_kernel(ct, torch.from_numpy(q),
                                      torch.from_numpy(pc), den2, den3)
    _equal(kernel_emulation(ct, q, pc, den3), [w.numpy() for w in want])


@pytest.mark.parametrize("mutation", ["forward_only", "backward_only"])
def test_edge_cases_catch_a_broken_search(configs, mutation):
    """The qualities reach both bitmask searches: a ladder without the
    backward or without the forward candidate gives other offsets."""
    _cj, ct, den2, den3 = configs["short"]
    q = qualities(40, ct.L, 4).astype(np.int32)
    pc = seed_host.PROB_CORRECT[q]
    want = kernel_emulation(ct, q, pc, den3)
    got = kernel_emulation(ct, q, pc, den3, mutation=mutation)
    assert (got[0] != want[0]).any()


def test_wrapper_checks_and_counts(configs):
    _cj, ct, den2, den3 = configs["short"]
    q = torch.from_numpy(qualities(8, ct.L, 5).astype(np.int32))
    pc = torch.from_numpy(seed_host.PROB_CORRECT[q.numpy()])
    tqd.reset_launches()
    tqd.quality_offsets_kernel(ct, q, pc, den2, den3)
    assert tqd.quality_offsets_kernel.launches == 0     # CPU: plain
    with pytest.raises(TypeError):
        tqd.quality_offsets_kernel(ct, q.long(), pc, den2, den3)
    with pytest.raises(ValueError):
        tqd.quality_offsets_kernel(ct, q[:, :100], pc[:, :100], den2, den3)


@pytest.mark.parametrize("shape", ["short", "long"])
def test_kernel_equals_plain_on_the_card(configs, shape):
    """The CUDA kernel, one launch, against the plain version on the card
    (chip_smoke.py does this at 65,536 x 150 and 32 x 6,000)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cj, ct, den2, den3 = configs[shape]
    dev = torch.device("cuda", 0)
    q = torch.from_numpy(qualities(64, ct.L, 6).astype(np.int32)).to(dev)
    pc = torch.as_tensor(seed_host.PROB_CORRECT, device=dev)[q.long()]
    want = tqd._quality_offsets_core(ct, q, pc, den2, den3, True)
    tqd.reset_launches()
    got = tqd.quality_offsets_kernel(ct, q, pc, den2, den3)
    assert tqd.quality_offsets_kernel.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", ["short", "long"])
def test_packed_entry_plain_matches_jax(configs, shape):
    """The packed entry on CPU tensors (its plain version: the words
    unpacked, then ``_quality_offsets_core``) against the JAX package's
    ``quality_offsets_stage_packed`` on the same words."""
    cj, ct, den2, den3 = configs[shape]
    L = ct.L
    q = qualities(64 if shape == "short" else 8, L, 11)
    qpack, pal, pcp = tqd.pack_quality_host(q, L)
    assert qpack is not None
    want = [np.asarray(x) for x in jqd.quality_offsets_stage_packed(
        cj, jnp.asarray(qpack), jnp.asarray(pal), jnp.asarray(pcp), den2,
        den3, return_weights=True)]
    got = tqd.quality_offsets_packed_kernel(
        ct, torch.from_numpy(qpack.astype(np.int64)), torch.from_numpy(pal),
        torch.from_numpy(pcp), den2, den3)
    _equal(got, want)
    assert (want[0] > -1).any() and want[2].any()


def test_packed_wrapper_checks_and_counts(configs):
    _cj, ct, den2, den3 = configs["short"]
    q = qualities(8, ct.L, 5)
    qpack, pal, pcp = (torch.from_numpy(a) for a in
                       tqd.pack_quality_host(q, ct.L))
    words = qpack.to(torch.int64)
    tqd.reset_launches()
    got = tqd.quality_offsets_stage_packed(ct, words, pal, pcp, den2, den3,
                                           return_weights=True)
    assert tqd.quality_offsets_packed_kernel.launches == 0   # CPU: plain
    assert tqd.quality_offsets_kernel.launches == 0
    want = tqd.quality_offsets_stage(ct, torch.from_numpy(q), den2, den3,
                                     return_weights=True)
    _equal(got, [w.numpy() for w in want])
    with pytest.raises(TypeError):
        tqd.quality_offsets_packed_kernel(ct, words.to(torch.int32), pal,
                                          pcp, den2, den3)
    with pytest.raises(ValueError):
        tqd.quality_offsets_packed_kernel(ct, words[:, :5], pal, pcp, den2,
                                          den3)
    with pytest.raises(ValueError):
        tqd.quality_offsets_packed_kernel(ct, words, pal[:8], pcp, den2,
                                          den3)
