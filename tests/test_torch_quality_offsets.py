"""The port's quality-driven key offsets (bbmap_tpu_torch/align/
quickmap_device.py: ``_quality_offsets_core``, the plain version that
``quality_offsets_kernel`` runs on CPU tensors, through both stage entry
points) against the JAX package's ``_quality_offsets_core``, on seeded
qualities: L = 150 (k = 13, nk = 18) raw and palette-packed, and L = 6,000
(k = 12, nk = 750), with all-zero reads, q = 0 runs, reads with no usable
window, low-quality ends (usable < L) and high-quality islands (desired
clamped by potential). A numpy emulation of ``csrc/quality_offsets.cu``'s
order (probs, the ok2 bitmask, the ladder on one thread with the backward
candidate from the highest set bit and the forward one from the lowest,
the weights and the ordered reject product) is held to the plain version.
Tolerance: exact, the float32 weights included (every float32 operation
rounds alone, in the JAX order)."""

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


def qualities(B, L, seed):
    """Seeded phred rows over the ladder's cases; binned to <= 16 values
    so that the palette-packed route takes them."""
    rng = np.random.default_rng(seed)
    levels = np.array([0, 2, 5, 9, 12, 16, 22, 27, 32, 37], np.int8)
    q = levels[rng.integers(4, 10, (B, L))]
    q[0] = 0                                   # all zero: no key
    q[1] = 2                                   # no usable window
    q[2, :L // 3] = 2                          # low-quality ends
    q[2, -L // 4:] = 2
    q[3] = 2                                   # high-quality islands
    for at in rng.integers(0, L - 20, 3):
        q[3, at:at + 18] = 37
    q[4, L // 2:L // 2 + 9] = 0                # a q = 0 run
    q[5::3, rng.integers(0, L, 4)] = 0         # scattered zeros
    q[6::5, :20] = 5
    q[7] = 9                                   # uniformly middling
    dips = rng.random((B, L)) < 0.03
    q[8:][dips[8:]] = 2
    q[5] = 2                                   # one short island: its keys'
    q[5, L // 2:L // 2 + 12] = 12              # error product > 0.5, reject
    return q


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
    """numpy model of csrc/quality_offsets.cu, a read at a time.
    ``mutation`` breaks it on purpose: "forward_only" / "backward_only"
    drop the backward / forward candidate."""
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
    offs_out = np.empty((B, nk), np.int32)
    wts_out = np.empty((B, nk), np.float32)
    rej_out = np.empty(B, bool)

    def highest_in(words, lo, hi):
        if lo > hi:
            return -1
        for w in range(hi >> 5, (lo >> 5) - 1, -1):
            bits = words[w] & _bits_in(w, lo, hi)
            if bits:
                return (w << 5) + bits.bit_length() - 1
        return -1

    def lowest_in(words, lo, hi):
        if lo > hi:
            return -1
        for w in range(lo >> 5, (hi >> 5) + 1):
            bits = words[w] & _bits_in(w, lo, hi)
            if bits:
                return (w << 5) + (bits & -bits).bit_length() - 1
        return -1

    for b in range(B):
        prob = pc[b, :m].copy()
        zero = q[b, :m] == 0
        for j in range(1, k):
            prob = (prob * pc[b, j:m + j]).astype(np.float32)
            zero |= q[b, j:m + j] == 0
        probs = np.where(zero, one, (one - prob).astype(np.float32))
        ok1 = probs < l1
        bits2 = np.zeros(nw * 32, bool)
        bits2[:m] = probs < l2
        words = [int(x) for x in np.packbits(
            bits2.reshape(nw, 32), axis=1, bitorder="little").view(
                np.uint32).ravel()]
        any1 = bool(ok1.any())
        left = int(np.argmax(ok1)) if any1 else 0
        right = int(m - 1 - np.argmax(ok1[::-1])) if any1 else m - 1
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
            f = np.float32(left)
            prev, j = -1, left
            for i in range(nk):
                if i >= desired:
                    offs[i] = -1
                    continue
                x = -1
                if prev < j:
                    if probs[min(max(j, 0), m - 1)] < l2:
                        x = j
                    else:
                        xb = highest_in(words, max(prev + 3, 0),
                                        min(j - 1, m - 1))
                        lim = min(j + iint, right)
                        xc = lowest_in(words, max(j + 1, 0),
                                       min(lim - 1, m - 1))
                        if mutation == "forward_only":
                            xb = -1
                        elif mutation == "backward_only":
                            xc = -1
                        x = xb if xb >= 0 else xc
                offs[i] = x
                prev = x if x > -1 else max(prev, j - 2)
                f = np.float32(f + interval)
                fl = int(np.floor(np.float32(f + half)))
                j = min(max(j + 1, fl), m - 1)
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


def _bits_in(w, lo, hi):
    a = max(lo - (w << 5), 0)
    b = min(hi - (w << 5), 31)
    return 0 if a > b else ((1 << (b + 1)) - 1) & ~((1 << a) - 1)


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
