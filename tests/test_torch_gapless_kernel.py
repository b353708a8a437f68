"""The gapless streak-score kernel (bbmap_tpu_torch/csrc/gapless_score.cu,
wrapper ``quickmap_device.gapless_scores_kernel``): a numpy emulation of its
per-(read, candidate) walk, in the kernel's order (a genome word of 16
bases at a time with its 16 N-mask bits, the positions of the first and
last words outside the window skipped, the read's code on the candidate's
strand, out-of-range positions as N, the sequential streak rule), held to
the plain version (``_gapless_scores_plain``) and to the JAX package's
``finalize_stage`` scores, on genomes with and without N runs (``has_n``
True and False), reads with N, minus-strand candidates and candidates off
either end of the genome, at L = 150 (short profile) and L = 6,000 (PacBio
profile). The port's ``finalize_stage``, whose match symbols now come from
the winner's row alone, is held to the JAX one on the same tables. A
mutation the emulation must fail: a minus-strand candidate read without
its flip. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.align import quickmap_device as jqd
from bbmap_tpu.core import constants as jK
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import gapless
from bbmap_tpu_torch.align import quickmap_device as tqd

torch.set_num_threads(2)

ACGT = np.frombuffer(b"ACGT", np.uint8)
K = tqd.MAX_CANDIDATES
SHAPES = {"short": (150, 13, 60_000, None),
          "long": (6000, 12, 60_000, jK.PACBIO_PROFILE)}


def _genome(G, seed, n_runs):
    rng = np.random.default_rng(seed)
    g = rng.choice(ACGT, G).astype(np.uint8)
    for at in rng.integers(0, G - 200, n_runs):
        g[at:at + int(rng.integers(1, 120))] = ord("N")
    return Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=G, name="c1")]).finalize()


@pytest.fixture(scope="module")
def setups():
    """(JAX index, port DeviceIndex, JAX config, port config) by (shape,
    has_n): a genome with N runs and one without."""
    out = {}
    for shape, (L, k, G, prof) in SHAPES.items():
        for has_n in (True, False):
            index = build_index(_genome(G, 3, 12 if has_n else 0), k)
            dix = tqd.DeviceIndex(convert.index(index), "cpu")
            cj = jqd.make_config(index, L, profile=prof)
            ct = tqd.make_config(dix, L, profile=None if prof is None
                                 else convert.profile(prof))
            assert ct.has_n == has_n == cj.has_n
            out[shape, has_n] = (index, dix, cj, ct)
    return out


def table(index, L, B, seed):
    """B reads (codes, N = 4) and a (B, K) candidate table: the true
    diagonal on the read's strand, shifted diagonals, the other strand,
    diagonals off the genome's start and past its end, and random ones."""
    rng = np.random.default_rng(seed)
    gc = np.minimum(index.genome_codes, 4).astype(np.uint8)
    G = len(gc)
    src = rng.integers(0, G - L, B)
    reads = np.stack([gc[s:s + L] for s in src]).copy()
    sub = rng.random((B, L)) < 0.04
    reads[sub] = rng.integers(0, 4, sub.sum())
    reads[rng.random((B, L)) < 0.01] = 4
    reads[::9, L // 3:L // 3 + 7] = 4
    minus = rng.random(B) < 0.5
    reads[minus] = np.where(reads[minus] <= 3, 3 - reads[minus],
                            reads[minus])[:, ::-1]
    mode = np.empty((B, K), np.int32)
    strand = np.empty((B, K), np.int32)
    for b in range(B):
        mode[b] = src[b] + rng.integers(-3, 4, K)
        mode[b, 0] = src[b]
        strand[b] = minus[b]
        strand[b, 1] = 1 - minus[b]
        mode[b, 2] = -int(rng.integers(1, L))          # off the start
        mode[b, 3] = G - int(rng.integers(1, L))       # past the end
        mode[b, 4] = int(rng.integers(-2 * L, G + L))
        mode[b, 5] = -5 * L if b % 4 == 0 else mode[b, 5]
    return reads, mode, strand


def gapless_emulation(ct, dix, reads, mode, strand, mutation=None):
    """numpy model of csrc/gapless_score.cu, a (read, candidate) at a time.
    ``mutation``: "no_flip" reads a minus-strand candidate forward."""
    PM, PM2, PS, PS2, PS3, LIM3 = gapless._points(ct.profile)
    gpack = dix.gpack.numpy()
    nmask = dix.nmask.numpy()
    nw, nwn, G, L = len(gpack), len(nmask), ct.G, ct.L
    B, Kc = mode.shape
    out = np.zeros((B, Kc), np.int32)
    for b in range(B):
        row = [int(x) for x in reads[b]]
        for c in range(Kc):
            minus = strand[b, c] != 0 and mutation != "no_flip"
            base = int(mode[b, c])
            score = run = streak = 0
            for w in range(base >> 4, ((base + L - 1) >> 4) + 1):
                inside = 0 <= w and (w << 4) < G
                word = int(gpack[min(w, nw - 1)]) & 0xFFFFFFFF \
                    if inside else 0
                nb = (int(nmask[min(w >> 1, nwn - 1)]) >> ((w & 1) * 16)
                      ) & 0xFFFF if inside and ct.has_n else 0
                for q in range(16):
                    j = (w << 4) + q - base
                    if j < 0 or j >= L:
                        continue
                    x = row[L - 1 - j] if minus else row[j]
                    if minus and x <= 3:
                        x = 3 - x
                    pos = (w << 4) + q
                    ref_n = pos < 0 or pos >= G or bool((nb >> q) & 1)
                    r = (word >> (2 * q)) & 3
                    read_n = x > 3
                    eq = x == r and not ref_n
                    if eq and not read_n:
                        score += PM2 if run == 1 else PM
                        streak = streak + 1 if run == 1 else 0
                        run = 1
                    elif not eq and not read_n and not ref_n:
                        s = streak + 1 if run == 2 else 0
                        score += PS3 if s + 1 > LIM3 else (
                            PS2 if s + 1 > 1 else PS)
                        streak, run = s, 2
            out[b, c] = score
    return out


def _cand(mode, strand, lib):
    votes = np.ones_like(mode)
    start = mode - 2
    spread = np.full_like(mode, 4)
    return {"votes": lib(votes), "mode": lib(mode), "strand": lib(strand),
            "start": lib(start), "spread": lib(spread)}


def _jax_finalize(index, cj, reads, mode, strand):
    _s, _si, gpack, nmask, _G = jqd.device_arrays(index)
    return jqd.finalize_stage(cj, jnp.asarray(reads),
                              _cand(mode, strand, jnp.asarray), gpack, nmask,
                              return_scores=True)


@pytest.mark.parametrize("shape,has_n,B", [
    ("short", True, 48), ("short", False, 48), ("long", True, 3),
    ("long", False, 2)])
def test_emulation_plain_and_jax_agree(setups, shape, has_n, B):
    index, dix, cj, ct = setups[shape, has_n]
    reads, mode, strand = table(index, ct.L, B, 5)
    out_j, match_j, scores_j = _jax_finalize(index, cj, reads, mode, strand)
    want = np.asarray(scores_j)
    got = tqd.gapless_scores_kernel(
        ct, torch.from_numpy(reads), torch.from_numpy(mode),
        torch.from_numpy(strand), dix).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        gapless_emulation(ct, dix, reads, mode, strand), want)
    # the true diagonal scores high on either strand; the other strand and
    # the windows off the genome do not
    assert (want[:, 0] > want[:, 1]).mean() > 0.9
    assert (want[:, 2] < want[:, 0]).all() and (want[:, 3] < want[:, 0]).all()
    # finalize_stage: the whole output and the winner's match symbols
    out_t, sym_t, scores_t = tqd.finalize_stage(
        ct, torch.from_numpy(reads), _cand(mode, strand, torch.from_numpy),
        dix, return_scores=True)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(scores_t.numpy(), want)
    sym_j = jqd._UNPACK_LUT[np.asarray(match_j)].reshape(B, -1)[:, :ct.L]
    np.testing.assert_array_equal(tqd._SYM_TABLE[sym_t.numpy()], sym_j)


def test_minus_flip_mutation_fails(setups):
    """Half the candidates are on the minus strand: reading them forward
    gives other scores."""
    index, dix, _cj, ct = setups["short", True]
    reads, mode, strand = table(index, ct.L, 16, 6)
    want = tqd.gapless_scores_kernel(
        ct, torch.from_numpy(reads), torch.from_numpy(mode),
        torch.from_numpy(strand), dix).numpy()
    got = gapless_emulation(ct, dix, reads, mode, strand, mutation="no_flip")
    minus = strand != 0
    assert (got[minus] != want[minus]).any()
    np.testing.assert_array_equal(got[~minus], want[~minus])


def test_wrapper_checks_and_counts(setups):
    index, dix, _cj, ct = setups["short", True]
    reads, mode, strand = (torch.from_numpy(a) for a in
                           table(index, ct.L, 8, 7))
    tqd.reset_launches()
    got = tqd.gapless_scores_kernel(ct, reads, mode, strand, dix)
    assert tqd.gapless_scores_kernel.launches == 0       # CPU: plain
    np.testing.assert_array_equal(got.numpy(), tqd._gapless_scores_plain(
        ct, reads, mode, strand, dix).numpy())
    with pytest.raises(TypeError):
        tqd.gapless_scores_kernel(ct, reads, mode.long(), strand, dix)
    with pytest.raises(TypeError):
        tqd.gapless_scores_kernel(ct, reads.int(), mode, strand, dix)
    with pytest.raises(ValueError):
        tqd.gapless_scores_kernel(ct, reads[:, :100], mode, strand, dix)
    with pytest.raises(ValueError):
        tqd.gapless_scores_kernel(ct, reads, mode, strand[:, :4], dix)


@pytest.mark.parametrize("shape", ["short", "long"])
def test_kernel_equals_plain_on_the_card(setups, shape):
    """The CUDA kernel, one launch, against the plain version on the card
    (chip_smoke.py does this on the main path's warmup batch and on the
    long path's first call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    index, _dix, _cj, ct = setups[shape, True]
    dix = tqd.DeviceIndex(convert.index(index), dev)
    reads, mode, strand = (torch.from_numpy(a).to(dev) for a in
                           table(index, ct.L, 256 if shape == "short" else 32,
                                 8))
    want = tqd._gapless_scores_plain(ct, reads, mode, strand, dix)
    tqd.reset_launches()
    got = tqd.gapless_scores_kernel(ct, reads, mode, strand, dix)
    assert tqd.gapless_scores_kernel.launches == 1
    assert torch.equal(got, want)
