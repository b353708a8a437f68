"""The gapless streak-score kernel (bbmap_tpu_torch/csrc/gapless_score.cu,
wrapper ``quickmap_device.gapless_scores_kernel``): a numpy emulation of
both its mappings in the kernel's order (each read packed as 2-bit words of
16 bases with a word of N bits on both strands; a window word at a time:
the genome's 16 codes a funnel shift of two words, equality from read ^
genome, the positions that score moved down past the skipped ones, the
word's points from popcounts with the sub run carried in above lim3 bits,
the state carried out; "thread" walks a candidate's words in turn, "warp"
scores each lane's chunk of words from a fresh state and joins the lanes'
summaries in order by a tree of five steps), held to the plain version
(``_gapless_scores_plain``) and to the JAX package's ``finalize_stage``
scores, on genomes with and without N runs (``has_n`` True and False),
reads with N, minus-strand candidates and candidates off either end of the
genome, and on the crafted rows of ``tests/gapless_rows.py`` (every start
offset mod 32, sub runs of lim3 - 1 to 2 lim3 + 3 across word and lane
edges, N at word edges in the read and the genome, windows off the
genome), at L = 150 (short profile) and L = 6,000 (PacBio profile). The
port's ``finalize_stage``, whose match symbols come from the winner's row
alone, is held to the JAX one on the same tables. Mutations the emulation
must fail: a minus-strand candidate read without its flip, and a sub
streak not carried across a word. The mapping rule (``gapless_mapping``)
and the wrapper's checks. Tolerance: exact."""

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
from tests.gapless_rows import gapless_rows

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


NONE, MATCH, SUB = 0, 1, 2
M32 = 0xFFFFFFFF


def _popc(x):
    return bin(x).count("1")


def _even_bits(x):
    """Bits 0, 2, .., 30 of x to bits 0 .. 15 (the kernel's steps)."""
    x &= 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def _span_bits(a, b):
    a, b = max(a, 0), min(b, 16)
    return 0 if a >= b else ((1 << b) - 1) & ~((1 << a) - 1)


def _funnel(lo, hi, sh):
    return (((hi << 32) | lo) >> (sh & 31)) & M32


def _pack(row, minus):
    """A read's (code word, N bits) a word of 16, on one strand."""
    L = len(row)
    words = []
    for w in range((L + 15) // 16):
        code = nb = 0
        for q in range(16):
            j = 16 * w + q
            if j >= L:
                break
            c = row[L - 1 - j] if minus else row[j]
            if c > 3:
                nb |= 1 << q
            code |= ((c & 3) ^ (3 if minus else 0)) << (2 * q)
        words.append((code, nb))
    return words


def _score_word(eq, scored, st, ld, pts, mutation=None):
    """One word's points from the run state st = [last, t] (advanced in
    place); ld = [first, lead, has_match] of a lane's chunk, or None.
    ``mutation`` "no_carry": the sub run is not carried into the word."""
    PM, PM2, PS, PS2, PS3, T = pts
    if scored == 0:
        return 0
    a = (scored & -scored).bit_length() - 1
    x, eq = scored >> a, eq >> a
    holes = ~x & ((2 << (x.bit_length() - 1)) - 1)
    while holes:
        low = (1 << (holes.bit_length() - 1)) - 1
        eq = (eq & low) | ((eq >> 1) & ~low)
        x = (x & low) | ((x >> 1) & ~low)
        holes &= low
    M, S = eq & x, ~eq & x
    nm = _popc(M)
    nmm = _popc(M & ((M << 1) | int(st[0] == MATCH)))
    tin = st[1] if st[0] == SUB and mutation != "no_carry" else 0
    E = (S << T) | (((1 << tin) - 1) << (T - tin))
    ns = _popc(S)
    n1 = _popc(S & ~((E << 1) >> T))
    R, have = E, 1
    while have < T + 1:
        d = min(have, T + 1 - have)
        R &= (R << d) & M32
        have += d
    n3 = _popc(R >> T)
    if ld is not None:
        if ld[0] == NONE:
            ld[0] = MATCH if M & 1 else SUB
        if not ld[2]:
            ld[1] = min(ld[1] + ((M & -M).bit_length() - 1 if M else ns), T)
            ld[2] = M != 0
    hi = x.bit_length() - 1
    if (M >> hi) & 1:
        st[:] = [MATCH, 0]
    else:
        v = (E << (31 - T - hi)) & M32
        st[:] = [SUB, min(32 - (~v & M32).bit_length(), T)]
    return (PM * nm + (PM2 - PM) * nmm + PS * n1 + PS2 * (ns - n1 - n3)
            + PS3 * n3)


def _run_points(m, pts):
    PS, PS2, PS3, T = pts[2], pts[3], pts[4], pts[5]
    return 0 if m <= 0 else PS + PS2 * (min(m, T) - 1) + PS3 * max(m - T, 0)


def _join(a, b, pts):
    """Chunks (score, last, t, first, lead, has_match), a then b."""
    if b[3] == NONE:
        return a
    if a[3] == NONE:
        return b
    score = a[0] + b[0]
    if b[3] == MATCH and a[1] == MATCH:
        score += pts[1] - pts[0]
    if b[3] == SUB and a[1] == SUB:
        score += (_run_points(a[2] + b[4], pts) - _run_points(a[2], pts)
                  - _run_points(b[4], pts))
    lead = a[4] if a[5] else min(a[4] + b[4], pts[5])
    if b[5]:
        last, t = b[1], b[2]
    else:
        last, t = SUB, min((a[2] if a[1] == SUB else 0) + b[4], pts[5])
    return (score, last, t, a[3], lead, a[5] or b[5])


def gapless_emulation(ct, dix, reads, mode, strand, mutation=None,
                      mapping="thread"):
    """numpy model of csrc/gapless_score.cu in its ``mapping``, a (read,
    candidate) at a time. ``mutation``: "no_flip" reads a minus-strand
    candidate forward; "no_carry" drops the sub run carried into a
    word."""
    pts = gapless._points(ct.profile)
    gpack = [int(x) & M32 for x in dix.gpack.numpy()]
    nmask = [int(x) & M32 for x in dix.nmask.numpy()]
    nw, nwn, G, L = len(gpack), len(nmask), ct.G, ct.L
    nwr = (L + 15) // 16

    def gword(w):
        return 0 if w < 0 or (w << 4) >= G else gpack[min(w, nw - 1)]

    def nword(i):
        return 0 if i < 0 or i >= nwn else nmask[i]

    B, Kc = mode.shape
    out = np.zeros((B, Kc), np.int32)
    for b in range(B):
        row = [int(x) for x in reads[b]]
        packed = (_pack(row, False), _pack(row, True))
        for c in range(Kc):
            minus = int(strand[b, c] != 0 and mutation != "no_flip")
            rw = packed[minus]
            p0 = int(mode[b, c])
            jlo, jhi = min(max(-p0, 0), L), min(max(G - p0, 0), L)

            def word(w, st, ld):
                j0 = 16 * w
                x = rw[w][0] ^ _funnel(gword((p0 >> 4) + w),
                                       gword((p0 >> 4) + w + 1),
                                       2 * (p0 & 15))
                eq = ~_even_bits(x | (x >> 1)) & 0xFFFF
                n = rw[w][1]
                if ct.has_n:
                    p = p0 + j0
                    n |= _funnel(nword(p >> 5), nword((p >> 5) + 1),
                                 p & 31) & 0xFFFF
                scored = _span_bits(jlo - j0, jhi - j0) & ~n
                return _score_word(eq, scored, st, ld, pts, mutation)

            if mapping == "thread":
                st = [NONE, 0]
                out[b, c] = sum(word(w, st, None) for w in range(nwr))
                continue
            cw = (nwr + 31) // 32
            lanes = []
            for lane in range(32):
                w0 = min(lane * cw, nwr)
                st, ld = [NONE, 0], [NONE, 0, False]
                score = sum(word(w, st, ld)
                            for w in range(w0, min(w0 + cw, nwr)))
                lanes.append((score, st[0], st[1], ld[0], ld[1], ld[2]))
            d = 1
            while d < 32:
                lanes = [_join(lanes[i], lanes[i + d], pts)
                         if i % (2 * d) == 0 else lanes[i]
                         for i in range(32 - d)] + lanes[32 - d:]
                d *= 2
            out[b, c] = lanes[0][0]
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
    for mapping in tqd.GAPLESS_MAPPINGS:
        np.testing.assert_array_equal(gapless_emulation(
            ct, dix, reads, mode, strand, mapping=mapping), want)
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


@pytest.mark.parametrize("shape,has_n,B", [
    ("short", True, 64), ("short", False, 32), ("long", True, 4),
    ("long", False, 2)])
def test_crafted_rows(setups, shape, has_n, B):
    """The crafted rows (word and lane edges, N, windows off the genome):
    both mappings' emulation, the plain version and the JAX scores
    agree."""
    index, dix, cj, ct = setups[shape, has_n]
    lim3 = gapless._points(ct.profile)[5]
    reads, mode, strand = gapless_rows(index.genome_codes, B, ct.L, lim3,
                                       np.random.default_rng(B + has_n))
    want = np.asarray(_jax_finalize(index, cj, reads, mode, strand)[2])
    got = tqd.gapless_scores_kernel(
        ct, torch.from_numpy(reads), torch.from_numpy(mode),
        torch.from_numpy(strand), dix).numpy()
    np.testing.assert_array_equal(got, want)
    for mapping in tqd.GAPLESS_MAPPINGS:
        np.testing.assert_array_equal(gapless_emulation(
            ct, dix, reads, mode, strand, mapping=mapping), want)
    # the rows reach the genome's N and the windows off it
    assert (mode < 0).any() and (mode > ct.G - ct.L).any()


@pytest.mark.parametrize("shape,mapping", [("short", "thread"),
                                           ("long", "thread"),
                                           ("long", "warp")])
def test_no_carry_mutation_fails(setups, shape, mapping):
    """Sub runs cross word edges in the crafted rows: a word that starts
    its sub run afresh scores them otherwise (in the warp mapping at L =
    150 a lane holds one word, whose run the join carries, so only the
    long rows, 12 words a lane, reach it there)."""
    index, dix, _cj, ct = setups[shape, True]
    lim3 = gapless._points(ct.profile)[5]
    reads, mode, strand = gapless_rows(index.genome_codes,
                                       16 if shape == "short" else 2, ct.L,
                                       lim3, np.random.default_rng(21))
    want = tqd.gapless_scores_kernel(
        ct, torch.from_numpy(reads), torch.from_numpy(mode),
        torch.from_numpy(strand), dix).numpy()
    np.testing.assert_array_equal(gapless_emulation(
        ct, dix, reads, mode, strand, mapping=mapping), want)
    got = gapless_emulation(ct, dix, reads, mode, strand,
                            mutation="no_carry", mapping=mapping)
    assert (got != want).any()


def test_mapping_rule():
    """"warp" below GAPLESS_WARP_BELOW candidates, "thread" from there;
    a mapping given is kept, an unknown one refused."""
    below = tqd.GAPLESS_WARP_BELOW
    assert tqd.gapless_mapping(32 * 8) == "warp"
    assert tqd.gapless_mapping(below - 1) == "warp"
    assert tqd.gapless_mapping(below) == "thread"
    assert tqd.gapless_mapping(65536 * 8) == "thread"
    assert tqd.gapless_mapping(65536 * 8, "warp") == "warp"
    assert tqd.gapless_mapping(8, "thread") == "thread"
    with pytest.raises(ValueError):
        tqd.gapless_mapping(8, "block")


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
    with pytest.raises(ValueError):
        tqd.gapless_scores_kernel(ct, reads, mode, strand, dix,
                                  mapping="lane")
    wide = (torch.cat([mode, mode[:, :1]], 1),
            torch.cat([strand, strand[:, :1]], 1))
    with pytest.raises(ValueError):         # the warp mapping holds K <= 8
        tqd.gapless_scores_kernel(ct, reads, *wide, dix, mapping="warp")
    assert tqd.gapless_scores_kernel(ct, reads, *wide, dix,
                                     mapping="thread").shape == (8, K + 1)
    assert tqd.gapless_scores_kernel.launches_by == {"thread": 0, "warp": 0}


@pytest.mark.parametrize("mapping", ["thread", "warp"])
@pytest.mark.parametrize("shape", ["short", "long"])
def test_kernel_equals_plain_on_the_card(setups, shape, mapping):
    """The CUDA kernel in each mapping, one launch, against the plain
    version on the card (chip_smoke.py does this on the main path's warmup
    batch and on the long path's first call)."""
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
    got = tqd.gapless_scores_kernel(ct, reads, mode, strand, dix,
                                    mapping=mapping)
    assert tqd.gapless_scores_kernel.launches == 1
    assert tqd.gapless_scores_kernel.launches_by[mapping] == 1
    assert torch.equal(got, want)
