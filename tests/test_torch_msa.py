"""The port's DP (bbmap_tpu_torch/ops/msa.py and the plain versions of
the score / fill kernels in ops/msa_kernels.py) against the JAX package:
the Pallas kernels msa_score_pallas_t / msa_fill_pallas_t (interpret
mode on the CPU), the XLA scan of ops/msa_jax.py, the traceback walk,
and the golden fill vectors. Tolerance: exact for every integer and
byte output; prev codes compared on the valid cells
(1 <= r <= rows, 1 <= c <= C), where they are defined."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.core.constants import PACBIO_PROFILE as JAX_PACBIO
from bbmap_tpu.core.constants import SHORT_PROFILE as JAX_SHORT
from bbmap_tpu.ops import msa_jax, msa_pallas
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.ops import msa, msa_kernels

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)
# the reference's profiles for the JAX functions, carried across for the
# port's
JAX_PROFILES = {"short": JAX_SHORT, "pacbio": JAX_PACBIO}
PROFILES = {k: convert.profile(v) for k, v in JAX_PROFILES.items()}
SHORT_PROFILE, PACBIO_PROFILE = PROFILES["short"], PROFILES["pacbio"]


def make_case(rng, rlen, clen, nsubs=0, nins=0, ndels=0, n_n=0):
    """Plant a read in a ref window with controlled edits (the cases of
    tests/test_msa.py)."""
    ref = rng.choice(BASES, size=clen).astype(np.uint8)
    offset = int(rng.integers(0, max(1, clen - rlen)))
    read = ref[offset:offset + rlen].copy()
    if len(read) < rlen:
        read = np.concatenate(
            [read, rng.choice(BASES, size=rlen - len(read)).astype(np.uint8)])
    for _ in range(nsubs):
        i = int(rng.integers(0, rlen))
        read[i] = BASES[(int(np.searchsorted(BASES, read[i])) + 1) % 4]
    for _ in range(nins):
        i = int(rng.integers(1, rlen - 1))
        read = np.concatenate(
            [read[:i], rng.choice(BASES, size=1).astype(np.uint8),
             read[i:-1]])
    for _ in range(ndels):
        i = int(rng.integers(1, rlen - 1))
        read = np.concatenate([read[:i], read[i + 1:],
                               rng.choice(BASES, size=1).astype(np.uint8)])
    for _ in range(n_n):
        read[int(rng.integers(0, rlen))] = ord("N")
    return read[:rlen], ref


CASES = [
    dict(rlen=20, clen=40),
    dict(rlen=20, clen=40, nsubs=2),
    dict(rlen=30, clen=50, nins=1),
    dict(rlen=30, clen=50, ndels=2),
    dict(rlen=30, clen=64, nsubs=3, nins=1, ndels=1),
    dict(rlen=25, clen=45, n_n=2),
    dict(rlen=40, clen=40),
    dict(rlen=16, clen=90, nsubs=1),
]


def batch_of(seed, B, R, C, var_rows=True, with_n=True, gap=False):
    """B jobs of (R, C): edited reads planted in their windows, N bases
    in reads and refs, and (var_rows) per-job rows below R with the read
    padded by N."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((B, R), np.uint8)
    refs = np.zeros((B, C), np.uint8)
    for b in range(B):
        rd, rf = make_case(rng, R, C, nsubs=int(rng.integers(0, 4)),
                           nins=int(rng.integers(0, 2)),
                           ndels=int(rng.integers(0, 2)),
                           n_n=int(rng.integers(0, 2)) if with_n else 0)
        reads[b], refs[b] = rd, rf
        if with_n and rng.random() < 0.3:
            refs[b, rng.integers(0, C)] = ord("N")
    if gap:
        refs[0, C // 3] = ord("-")
    rows = np.full(B, R, np.int32)
    if var_rows:
        rows = rng.integers(max(R - 8, 4), R + 1, B).astype(np.int32)
        for b in range(B):
            reads[b, rows[b]:] = ord("N")
    return reads, refs, rows


def valid_mask(rows, R, C):
    d = np.arange(1, R + C + 1)[None, :, None]
    r = np.arange(R + 1)[None, None, :]
    c = d - r
    return (r >= 1) & (r <= rows[:, None, None]) & (c >= 1) & (c <= C)


def t(a):
    return torch.from_numpy(np.array(a))


def pallas_t(reads, refs, rows, R, C, P, fill):
    r1, r0, rp, rw = msa_pallas.prep_operands_t_device(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C)
    B = reads.shape[0]
    if fill:
        out, prevs = msa_pallas.msa_fill_pallas_t(r1, r0, rp, rw, R, C, B, P)
        return np.asarray(out), np.asarray(prevs).transpose(2, 0, 1)
    return np.asarray(msa_pallas.msa_score_pallas_t(r1, r0, rp, rw, R, C,
                                                    B, P))


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("shape", [(24, 40, 8), (40, 64, 16)])
def test_score_plain_matches_pallas_and_scan(prof, shape):
    R, C, B = shape
    P = PROFILES[prof]
    reads, refs, rows = batch_of(R * 7 + C, B, R, C, gap=True)
    out = msa_kernels.msa_score(t(reads), t(refs), t(rows), P).numpy()
    JP = JAX_PROFILES[prof]
    np.testing.assert_array_equal(out, pallas_t(reads, refs, rows, R, C, JP,
                                                fill=False))
    sc, col, st = msa_jax.msa_score_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C, JP)
    np.testing.assert_array_equal(out, np.stack([sc, col, st]))


@pytest.mark.parametrize("prof", ["short", "pacbio"])
def test_fill_plain_matches_pallas_and_scan(prof):
    R, C, B = 30, 48, 8
    P = PROFILES[prof]
    reads, refs, rows = batch_of(11, B, R, C)
    out, prevs, _lay = msa_kernels.msa_fill(t(reads), t(refs), t(rows), P)
    out, prevs = out.numpy(), prevs.numpy()
    JP = JAX_PROFILES[prof]
    o_p, pv_p = pallas_t(reads, refs, rows, R, C, JP, fill=True)
    np.testing.assert_array_equal(out, o_p)
    m = valid_mask(rows, R, C)
    np.testing.assert_array_equal(prevs[m], pv_p[m])
    pv_x, sc, col, st = msa_jax.msa_trace_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C, JP)
    np.testing.assert_array_equal(out, np.stack([sc, col, st]))
    np.testing.assert_array_equal(prevs[m], np.asarray(pv_x)[m])


@pytest.mark.parametrize("case", CASES)
def test_cases_score_and_traceback(case):
    rng = np.random.default_rng(sum(case.values()))
    read, ref = make_case(rng, **case)
    R, C = len(read), len(ref)
    (sc, col, st), prevs, _lay = msa_kernels.msa_fill(
        t(read[None]), t(ref[None]), torch.tensor([R], dtype=torch.int32),
        SHORT_PROFILE)
    pe, se, ce, ste = msa_jax.msa_trace_single(read, ref, R, C)
    assert (int(sc[0]), int(col[0]), int(st[0])) == \
        (int(se), int(ce), int(ste))
    m_t = msa.traceback_prevs(read, ref, prevs[0].numpy(), int(col[0]),
                              int(st[0]))
    m_j = msa_jax.traceback_prevs(read, ref, np.asarray(pe), int(ce),
                                  int(ste))
    assert m_t == m_j


@pytest.mark.parametrize("prof", ["short", "pacbio"])
def test_align_batch_matches_jax(prof):
    """Fill + full-length walk (msa_align_batch) against the JAX
    package's msa_align_batch, symbol for symbol."""
    R, C, B = 32, 56, 12
    P = PROFILES[prof]
    reads, refs, _ = batch_of(5, B, R, C, var_rows=False, gap=True)
    got = msa.msa_align_batch(t(reads), t(refs), P)
    want = msa_jax.msa_align_batch(jnp.asarray(reads), jnp.asarray(refs),
                                   R, C, JAX_PROFILES[prof])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def walk_kernel_emulation(prevs, reads, refs, col0, st0, R, C, steps):
    """The per-job loop of csrc/msa_walk.cu in scalar Python: lane 0
    walks until row 0 or ``steps`` symbols, the warp zeroes the tail."""
    B = len(col0)
    n_max = steps if steps else R + C
    syms = np.full((B, n_max), 0xEE, np.uint8)
    out_len, gaps_o, row_end = (np.zeros(B, np.int32) for _ in range(3))
    defined = set(b"ACGTU")
    for b in range(B):
        row, col, st, gaps, n = R, int(col0[b]), int(st0[b]), 0, 0
        while n < n_max and row > 0:
            if col > 0:
                di = min(row + col - 1, R + C - 1)
                prev = (int(prevs[b, di, row]) >> (2 * st)) & 3
                c_, r_ = int(reads[b, row - 1]), int(refs[b, min(col - 1,
                                                                 C - 1)])
                if st == 0:
                    sym = "m" if c_ == r_ else (
                        "S" if c_ in defined and r_ in defined else "N")
                    row, col = row - 1, col - 1
                elif st == 1:
                    sym = "-" if r_ == ord("-") else "D"
                    gaps += r_ == ord("-")
                    col -= 1
                else:
                    sym = "Y" if col >= C else "I"
                    row -= 1
                st = prev
            else:
                sym = "X"
                row, col = row - 1, col - 1
            syms[b, n] = ord(sym)
            n += 1
        syms[b, n:] = 0
        out_len[b], gaps_o[b], row_end[b] = n, gaps, row
    return syms, out_len, gaps_o, row_end


@pytest.mark.parametrize("steps", [0, 40])
def test_walk_matches_walk_device(steps):
    """The batched walk against msa_jax._walk_device, full (steps = R+C)
    and bounded (a cut walk reports row_end > 0)."""
    import jax
    R, C, B = 30, 50, 8
    reads, refs, _ = batch_of(9, B, R, C, var_rows=False)
    rows = np.full(B, R, np.int32)
    out, prevs, _lay = msa_kernels.msa_fill(t(reads), t(refs), t(rows),
                                            SHORT_PROFILE)
    sym, ln, gaps, row = msa.walk(prevs, t(reads), t(refs), out[1], out[2],
                                  R, C, steps=steps)
    pv = jnp.asarray(prevs.numpy())
    js = jax.vmap(lambda p, rd, rf, c0, s0: msa_jax._walk_device(
        p, rd, rf, c0, s0, R, C, steps=steps))(
            pv, jnp.asarray(reads), jnp.asarray(refs),
            jnp.asarray(out[1].numpy()), jnp.asarray(out[2].numpy()))
    for g, w in zip((sym, ln, gaps, row), js):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if steps:
        assert (row.numpy() >= 0).all()


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("steps", [0, 44, 25])
@pytest.mark.parametrize("starts", ["fill", "shifted"])
def test_walk_kernel_emulation_plain_and_jax_agree(prof, steps, starts):
    """The walk kernel's per-job loop (scalar emulation), msa_walk_plain
    and msa_jax._walk_device agree on symbols, out_len, gaps and row_end:
    full and bounded steps, walks that are cut (25 steps < R), gap
    columns and N, walks that run off the window's left edge (X),
    starting from the fill's own column and state and from random
    ones. Tolerance: exact."""
    import jax
    P = PROFILES[prof]
    R, C, B = 30, 50, 10
    reads, refs, _ = batch_of(13, B, R, C, var_rows=False, gap=True)
    refs[1::3, 20] = ord("-")
    rows = np.full(B, R, np.int32)
    out, prevs, _lay = msa_kernels.msa_fill(t(reads), t(refs), t(rows), P)
    col0, st0 = out[1].numpy(), out[2].numpy()
    if starts == "shifted":
        rng = np.random.default_rng(steps)
        col0 = rng.integers(1, C + 1, B).astype(np.int32)
        st0 = rng.integers(0, 3, B).astype(np.int32)
        col0[:2], st0[:2] = (0, 1), 0      # X padding: col runs out first
    got = msa_kernels.msa_walk(prevs, t(reads), t(refs), t(col0), t(st0),
                               R, C, steps)
    plain = msa_kernels.msa_walk_plain(prevs, t(reads), t(refs), t(col0),
                                       t(st0), R, C, steps)
    emu = walk_kernel_emulation(prevs.numpy(), reads, refs, col0, st0, R, C,
                                steps)
    js = jax.vmap(lambda p, rd, rf, c0, s0: msa_jax._walk_device(
        p, rd, rf, c0, s0, R, C, steps=steps))(
            jnp.asarray(prevs.numpy()), jnp.asarray(reads),
            jnp.asarray(refs), jnp.asarray(col0), jnp.asarray(st0))
    for g, p, e, w in zip(got, plain, emu, js):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_array_equal(e, p.numpy())
        np.testing.assert_array_equal(np.asarray(w), p.numpy())
    row_end, syms = plain[3].numpy(), plain[0].numpy()
    if steps == 25:
        assert (row_end > 0).all()
    if steps == 0:
        assert (row_end == 0).all()
        if starts == "shifted":
            assert (syms[:2] == ord("X")).any()
        assert (syms == ord("-")).any() or starts == "shifted"


def test_walk_wrapper_checks_inputs():
    R, C, B = 12, 20, 3
    reads, refs, rows = batch_of(3, B, R, C, var_rows=False)
    out, prevs, _lay = msa_kernels.msa_fill(t(reads), t(refs), t(rows),
                                            SHORT_PROFILE)
    with pytest.raises(ValueError):
        msa_kernels.msa_walk(prevs[:, 1:], t(reads), t(refs), out[1],
                             out[2], R, C)
    with pytest.raises(TypeError):
        msa_kernels.msa_walk(prevs.int(), t(reads), t(refs), out[1], out[2],
                             R, C)
    with pytest.raises(ValueError):
        msa_kernels.msa_walk(prevs, t(reads), t(refs), out[1][:2], out[2],
                             R, C)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fill_unlimited_vectors.json")


def test_golden_fill_vectors():
    """Score, column, state and traceback of every golden vector."""
    with open(GOLDEN) as fh:
        vectors = json.load(fh)
    for vec in vectors:
        read = np.frombuffer(vec["read"].encode(), np.uint8)
        ref = np.frombuffer(vec["ref"].encode(), np.uint8)
        sym, ln, gaps, sc, col, st = msa.msa_align_batch(
            t(read[None]), t(ref[None]), SHORT_PROFILE)
        assert int(sc[0]) == vec["maxScore"], vec["tag"]
        assert int(col[0]) == vec["maxCol"], vec["tag"]
        assert int(st[0]) == vec["maxState"], vec["tag"]
        match = msa.finish_match(sym[0].numpy(), int(ln[0]), int(gaps[0]))
        assert match.decode() == vec["match"], vec["tag"]


def test_wrapper_checks_inputs():
    reads, refs, rows = batch_of(3, 4, 10, 20)
    with pytest.raises(TypeError):
        msa_kernels.msa_score(t(reads).int(), t(refs), t(rows),
                              SHORT_PROFILE)
    with pytest.raises(ValueError):
        msa_kernels.msa_fill(t(reads), t(refs[:3]), t(rows), SHORT_PROFILE)


# ---- K1: msa_score_pallas's operands and entry point ---------------------

@pytest.fixture
def pallas_interpret(monkeypatch):
    """msa_score_pallas has no interpret switch: run its pallas_call in
    interpret mode, as tests/test_msa.py does."""
    orig = msa_pallas.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    monkeypatch.setattr(msa_pallas.pl, "pallas_call", interp_call)


def k1_case(seed, B, R, C):
    """tests/test_msa.py's K1 case: reads of 12..R bases copied from
    their windows (plus a substitution), padded with N past rows."""
    rng = np.random.default_rng(seed)
    reads = np.full((B, R), ord("N"), np.uint8)
    refs = rng.choice(BASES, size=(B, C)).astype(np.uint8)
    rows = np.zeros(B, np.int32)
    for i in range(B):
        L = int(rng.integers(max(12, R - 12), R + 1))
        rows[i] = L
        off = int(rng.integers(0, C - L))
        reads[i, :L] = refs[i, off:off + L]
        reads[i, rng.integers(0, L)] = BASES[rng.integers(0, 4)]
    return reads, refs, rows


@pytest.mark.parametrize("shape", [(24, 40, 8, 8), (150, 174, 8, 4),
                                   (150, 174, 6, 4)])
def test_k1_score_batch_matches_pallas(pallas_interpret, shape):
    """The port's score_batch (K1's plain version on the CPU) against
    msa_pallas.score_batch in interpret mode, bit-equal; (150, 174, 6, 4)
    pads the batch to a multiple of BB."""
    R, C, B, BB = shape
    reads, refs, rows = k1_case(R + B, B, R, C)
    want = msa_pallas.score_batch(reads, refs, rows, BB=BB)
    got = msa_kernels.score_batch(t(reads), t(refs), t(rows), BB=BB)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k1_prep_operands_match():
    reads, refs, rows = k1_case(2, 5, 30, 47)
    want = msa_pallas.prep_operands(reads, refs, rows)
    got = msa_kernels.prep_operands(t(reads), t(refs), t(rows))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_k1_matches_k2_and_checks_inputs():
    """K1 on its operands equals K2 on the raw jobs (SHORT profile), and
    the wrapper refuses what msa_score_pallas refuses."""
    R, C, B = 40, 64, 8
    reads, refs, rows = k1_case(4, B, R, C)
    r1, r0, rp, rw = msa_kernels.prep_operands(t(reads), t(refs), t(rows))
    out = msa_kernels.msa_score_rows(r1, r0, (rp, rw), R, C, 4)
    k2 = msa_kernels.msa_score(t(reads), t(refs), t(rows), SHORT_PROFILE)
    np.testing.assert_array_equal(out.numpy(), k2.numpy().T)
    with pytest.raises(ValueError):
        msa_kernels.msa_score_rows(r1, r0, (rp, rw), R, C, 3)
    with pytest.raises(ValueError):
        msa_kernels.msa_score_rows(r1, r0, (rp[:, 1:], rw), R, C, 4)
    with pytest.raises(TypeError):
        msa_kernels.msa_score_rows(r1.long(), r0, (rp, rw), R, C, 4)


# ---- past 1,023 rows: the long-read DP shapes ------------------------------

def test_plain_past_1023_rows_matches_scan():
    """The plain DP (what the strided-row kernels are held against on
    the card) against msa_jax's scan, PACBIO profile, R = 1,100: out and
    prev codes on the valid cells."""
    R, C, B = 1100, 1150, 3
    P = PACBIO_PROFILE
    reads, refs, rows = batch_of(17, B, R, C, gap=True)
    out, prevs, _lay = msa_kernels.msa_fill(t(reads), t(refs), t(rows), P)
    pv_x, sc, col, st = msa_jax.msa_trace_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C,
        JAX_PACBIO)
    np.testing.assert_array_equal(out.numpy(), np.stack([sc, col, st]))
    m = valid_mask(rows, R, C)
    np.testing.assert_array_equal(prevs.numpy()[m], np.asarray(pv_x)[m])
    score = msa_kernels.msa_score(t(reads), t(refs), t(rows), P)
    np.testing.assert_array_equal(score.numpy(), out.numpy())


@pytest.mark.parametrize("R, C, want", [
    (0, 8, (1, 128, 0, "warp")),
    (31, 40, (1, 128, 0, "warp")),
    (32, 40, (2, 128, 0, "warp")),
    (150, 174, (5, 128, 0, "warp")),
    (150, 606, (5, 128, 0, "warp")),
    (300, 360, (10, 128, 0, "warp")),
    (319, 400, (10, 128, 0, "warp")),
    (320, 400, (1, 352, 24 * 321 + 400, "row")),
    (1023, 1100, (1, 1024, 24 * 1024 + 1100, "row")),
    (1024, 1100, (8, 32, 0, "band")),
    (1100, 1200, (8, 32, 0, "band")),
    (4095, 4200, (8, 32, 0, "band")),
    (6000, 6024, (8, 32, 0, "band")),
    (6000, 6456, (8, 32, 0, "band")),
    (6000, 8192, (8, 32, 0, "band")),
    (8191, 8192, (8, 32, 0, "band")),
])
def test_launch_shape_rules(R, C, want):
    s = msa_kernels.launch_shape(R, C)
    assert tuple(s) == want
    assert (s.mapping == "band") == (R > 1023)
    assert s.threads % 32 == 0 and s.threads <= 1024
    per_job = {"warp": 32, "row": s.threads,
               "band": 32 * msa_kernels.band_count(R, s.rows_per_thread)}
    assert per_job[s.mapping] * s.rows_per_thread >= R + 1
    assert s.smem_bytes <= 232_448


@pytest.mark.parametrize("R, C, want", [
    (0, 8, (1, 32, 24 + 8, "row")),
    (150, 174, (1, 160, 24 * 151 + 174, "row")),
    (300, 360, (1, 320, 24 * 301 + 360, "row")),
    (1023, 1100, (1, 1024, 24 * 1024 + 1100, "row")),
])
def test_launch_shape_forced_one_row(R, C, want):
    """The one-row mapping stays launchable where the warp mapping is the
    default, and is the default for a fill and for few jobs; the strided
    mapping cannot be forced where the one-row mapping holds R."""
    assert tuple(msa_kernels.launch_shape(R, C, "row")) == want
    assert tuple(msa_kernels.launch_shape(R, C, fill=True)) == want
    few = msa_kernels.WARP_MIN_JOBS - 1
    if R >= msa_kernels.BAND_MID_MIN_ROWS:      # from there: the band mapping
        assert msa_kernels.launch_shape(R, C, jobs=few).mapping == "band"
        few = msa_kernels.BAND_MID_MIN_JOBS - 1
    assert tuple(msa_kernels.launch_shape(R, C, jobs=few)) == want
    for bad in ("strided", "other"):
        with pytest.raises(ValueError):
            msa_kernels.launch_shape(R, C, bad)
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(1024, 1100, "row")


@pytest.mark.parametrize("R, C, jobs, fill, want", [
    (150, 174, 32768, False, (5, 128, 0, "warp")),
    (150, 174, msa_kernels.WARP_MIN_JOBS, False, (5, 128, 0, "warp")),
    (150, 606, 128, False, (1, 160, 24 * 151 + 606, "row")),
    (150, 174, 8192, True, (1, 160, 24 * 151 + 174, "row")),
    (6000, 6456, 512, True, (4, 32, 0, "band")),
])
def test_launch_shape_by_jobs_and_fill(R, C, jobs, fill, want):
    """What the main path's passes get: the warp mapping for the 32,768
    job score pass, the one-row mapping for the 128-job wide pass and for
    fills; forcing "warp" gives four jobs a block at any job count."""
    assert tuple(msa_kernels.launch_shape(R, C, jobs=jobs, fill=fill)) == want
    if R <= 319:
        forced = msa_kernels.launch_shape(R, C, "warp", jobs=jobs, fill=fill)
        assert forced == (-(-(R + 1) // 32), 128, 0, "warp")
    else:
        with pytest.raises(ValueError):
            msa_kernels.launch_shape(R, C, "warp", jobs=jobs, fill=fill)


def test_launch_shape_limits():
    for R in range(0, 8192, 97):
        s = msa_kernels.launch_shape(R, R + 456)
        bands = msa_kernels.band_count(R, s.rows_per_thread)
        per_job = 32 * bands if s.mapping in ("warp", "band") else s.threads
        assert per_job * s.rows_per_thread >= R + 1
        if s.mapping == "warp":
            assert 32 * (s.rows_per_thread - 1) < R + 1 <= 320
        elif s.mapping == "band":
            assert 32 * (bands - 1) * s.rows_per_thread < R + 1
        else:
            assert (s.threads - 32) * s.rows_per_thread < R + 1
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(8192, 8192)          # rows
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(6000, 90_000, "strided")   # shared memory
    assert msa_kernels.launch_shape(6000, 90_000).smem_bytes == 0
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(-1, 10)


# ---- emulations of the card's kernels (csrc/msa_dp_warp.cu, msa_walk.cu) ---

def np_dp_cell(P, r, c, C, rows, read1, read0, ref1, ref0, dd, own, up,
               ins0, subfloor):
    """dp_cell of csrc/msa_dp.cuh on numpy int32 arrays of one shape:
    dd = (ms, del, ins) of cell (r-1, c-1), own = (ms, del) of (r, c-1),
    up = (ms, ins) of (r-1, c). Returns ((ms, del, ins), code)."""
    i32 = np.int32
    SM, TM = i32(~P.TIMEMASK), i32(P.TIMEMASK)

    def clamp_time(t):
        return np.where(t > P.MAX_TIME, i32(P.MAX_TIME - P.MASK5), t)

    def pick(x, *tiers):
        # tiers: (limit, value) pairs tried in order, then the default
        out = i32(tiers[-1])
        for lim, val in reversed(tiers[:-1]):
            out = np.where(x > lim, i32(val), out)
        return out

    n_ = ord("N")
    match = (read1 == ref1) & (ref1 != n_)
    pm = (read0 == ref0) & (ref0 != n_)
    gap = ref1 == ord("-")
    s_diag, s_del, s_ins = dd[0] & SM, dd[1] & SM, dd[2] & SM
    streak = dd[0] & TM
    m_ms = s_diag + np.where(pm, i32(P.POINTSoff_MATCH2),
                             i32(P.POINTSoff_MATCH))
    m_d, m_i = s_del + i32(P.POINTSoff_MATCH), s_ins + i32(P.POINTSoff_MATCH)
    m_best = np.maximum(m_ms, np.maximum(m_d, m_i))
    m_time = np.where((m_ms >= m_d) & (m_ms >= m_i) & pm, streak + 1, 1)
    sub_pen = np.where(
        pm, np.where(streak <= 1, i32(P.POINTSoff_SUBR), i32(P.POINTSoff_SUB)),
        pick(streak + 1, (P.LIMIT_FOR_COST_3, P.POINTSoff_SUB3),
             (1, P.POINTSoff_SUB2), P.POINTSoff_SUB))
    x_ms = np.where((ref1 != n_) & (read1 != n_), s_diag + sub_pen,
                    s_diag + i32(P.POINTSoff_NOCALL))
    x_d, x_i = s_del + i32(P.POINTSoff_SUB), s_ins + i32(P.POINTSoff_SUB)
    x_best = np.maximum(x_ms, np.maximum(x_d, x_i))
    x_time = np.where((x_ms >= x_d) & (x_ms >= x_i),
                      np.where(pm, 1, streak + 1), 1)
    ms_time = clamp_time(np.where(match, m_time, x_time)).astype(i32)
    ms_val = np.where(gap, subfloor, np.where(match, m_best, x_best)
                      | ms_time)

    dstreak = own[1] & TM
    del_ext = np.where(
        dstreak == 0, i32(P.POINTSoff_DEL),
        np.where(dstreak < P.LIMIT_FOR_COST_3, i32(P.POINTSoff_DEL2),
                 np.where(dstreak < P.LIMIT_FOR_COST_4, i32(P.POINTSoff_DEL3),
                          np.where(dstreak < P.LIMIT_FOR_COST_5,
                                   i32(P.POINTSoff_DEL4),
                                   np.where((dstreak & P.MASK5) == 0,
                                            i32(P.POINTSoff_DEL5), i32(0))))))
    adj = np.where(ref1 == n_, i32(P.POINTSoff_DEL_REF_N),
                   np.where(gap, i32(P.POINTSoff_GAP), i32(0)))
    d_ms = (own[0] & SM) + i32(P.POINTSoff_DEL) + adj
    d_d = (own[1] & SM) + del_ext + adj
    del_time = clamp_time(np.where(d_ms >= d_d, 1, dstreak + 1)).astype(i32)
    del_val = np.where((r < P.BARRIER_D1) | (r > rows - P.BARRIER_D1),
                       subfloor, np.maximum(d_ms, d_d) | del_time)

    istreak = up[1] & TM
    i_ms = (up[0] & SM) + i32(P.POINTSoff_INS)
    i_i = (up[1] & SM) + pick(istreak + 1,
                              (P.LIMIT_FOR_COST_4, P.POINTSoff_INS4),
                              (P.LIMIT_FOR_COST_3, P.POINTSoff_INS3),
                              (1, P.POINTSoff_INS2), P.POINTSoff_INS)
    ins_time = clamp_time(np.where(i_ms >= i_i, 1, istreak + 1)).astype(i32)
    ins_barrier = gap | ((r < P.BARRIER_I1) & (c > 1)) | (
        (r > rows - P.BARRIER_I1) & (c < C - 1))
    ins_val = np.where(ins_barrier, subfloor,
                       np.maximum(i_ms, i_i) | ins_time)

    vals = []
    for v in (ms_val, del_val, ins_val):
        v = np.where(r == 0, 0, np.where(c == 0, ins0, v))
        vals.append(np.where((c < 0) | (c > C) | (r > rows),
                             i32(P.BADoff), v).astype(i32))
    ms_arg = np.where((s_diag >= s_del) & (s_diag >= s_ins), 0,
                      np.where(s_del >= s_ins, 1, 2))
    ms_prev = np.where(ms_time > 1, 0, ms_arg)
    del_prev = np.where(del_time > 1, 1,
                        np.where((own[0] & SM) >= (own[1] & SM), 0, 1))
    ins_prev = np.where(ins_time > 1, 2,
                        np.where((up[0] & SM) >= (up[1] & SM), 0, 2))
    code = (ms_prev | (del_prev << 2) | (ins_prev << 4)).astype(np.uint8)
    return vals, code


def warp_schedule(reads, refs, rows, P, J):
    """The schedule of msa_dp_warp_kernel on numpy arrays (B, 32): lane l
    owns rows l*J .. l*J + J-1 and is at column s - l on step s; the
    three __shfl_up_sync are array shifts by one lane (lane 0 keeps its
    own value). Returns (out (3, B), prevs (B, R+C, R+1) with 0xEE in
    every byte the kernel leaves unwritten)."""
    i32 = np.int32
    B, R = reads.shape
    C = refs.shape[1]
    SM = i32(~P.TIMEMASK)
    BAD = i32(P.BADoff)
    lane = np.arange(32, dtype=i32)[None, :]
    r0 = lane * J
    rows_c = rows.astype(i32)[:, None]
    with np.errstate(over="ignore"):
        gain = ((rows_c - 1) * i32(P.POINTSoff_MATCH2)
                + i32(P.POINTSoff_MATCH)).astype(i32)
        subfloor = (gain * i32(-2)).astype(i32)
    ins0_col = msa._ins0_np(R, P)
    read_pad = np.concatenate(
        [np.full((B, 2), ord("?"), i32), reads.astype(i32),
         np.full((B, 32 * J), ord("?"), i32)], axis=1)
    ref_pad = np.concatenate(
        [np.full((B, 2), ord("!"), i32), refs.astype(i32),
         np.full((B, 2), ord("!"), i32)], axis=1)
    cells = [[np.full((B, 32), BAD, i32) for _ in range(3)]
             for _ in range(J)]
    car = [np.full((B, 32), BAD, i32) for _ in range(3)]
    best = np.full((3, B), msa.NEG_INF, i32)
    bcol = np.zeros((3, B), i32)
    prevs = np.full((B, R + C, R + 1), 0xEE, np.uint8)
    bb = np.arange(B)[:, None]
    n_live = (R + J) // J
    for s in range(C + n_live):
        up = [np.concatenate([v[:, :1], v[:, :-1]], axis=1)
              for v in cells[J - 1]]
        c = (s - lane).astype(i32)
        active = (c >= 0) & (c <= C) & (r0 <= R)
        cc = np.clip(c, -1, C + 1)
        ref1 = np.take_along_axis(ref_pad, np.broadcast_to(cc + 1, (B, 32)),
                                  1)
        ref0 = np.take_along_axis(ref_pad, np.broadcast_to(cc, (B, 32)), 1)
        dd = list(car)
        u = [up[0], up[2]]
        for j in range(J):
            r = (r0 + j).astype(i32)
            do = active & (r <= R)
            rr = np.broadcast_to(np.minimum(r, R + 32 * J - 1), (B, 32))
            read1 = np.take_along_axis(read_pad, rr + 1, 1)
            read0 = np.take_along_axis(read_pad, rr, 1)
            own = cells[j]
            ins0 = np.where(c == 0, ins0_col[np.minimum(r, R)], 0)
            with np.errstate(over="ignore"):
                new, code = np_dp_cell(P, r, c, C, rows_c, read1, read0,
                                       ref1, ref0, dd, own[:2], u, ins0,
                                       subfloor)
            wr = do & (r >= 1) & (c >= 1)
            bi, li = np.nonzero(np.broadcast_to(wr, (B, 32)))
            rv, cv = r[0, li], c[0, li]
            prevs[bi, rv + cv - 1, rv] = code[bi, li]
            on_last = do & (r == rows_c) & (c >= 1)
            for k in range(3):
                v = new[k] & SM
                take = on_last & (v > best[k][:, None])
                hit = take.any(axis=1)
                best[k] = np.where(hit, np.where(take, v, 0).sum(axis=1),
                                   best[k])
                bcol[k] = np.where(hit, np.where(take, c, 0).sum(axis=1),
                                   bcol[k])
            dd = [np.where(do, o, x) for o, x in zip(own, dd)]
            u = [np.where(do, new[0], u[0]), np.where(do, new[2], u[1])]
            cells[j] = [np.where(do, n_, o) for n_, o in zip(new, own)]
        car = up
    b0, b1, b2 = best
    state = np.where((b0 >= b1) & (b0 >= b2), 0, np.where(b1 >= b2, 1, 2))
    score = np.choose(state, best)
    col = np.choose(state, bcol)
    return np.stack([score >> P.SCOREOFFSET, col, state]).astype(i32), prevs


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R", [1, 31, 32, 150, 255])
def test_warp_schedule_matches_plain(R, prof):
    """The warp-a-job schedule (32 lanes, J rows a lane, the shuffles as
    array shifts, 0xEE where the kernel writes nothing) equals dp_plain
    in out and in prev codes on the valid cells, variable rows, N and
    gap columns included. Tolerance: exact."""
    P = PROFILES[prof]
    C, B = R + 24, 5
    if R >= 20:
        reads, refs, rows = batch_of(R + 3, B, R, C, gap=True)
    else:
        rng = np.random.default_rng(R)
        reads = rng.choice(BASES, size=(B, R)).astype(np.uint8)
        refs = rng.choice(BASES, size=(B, C)).astype(np.uint8)
        rows = np.full(B, R, np.int32)
    shape = msa_kernels.launch_shape(R, C)
    assert shape.mapping == "warp"
    out, prevs = warp_schedule(reads, refs, rows, P, shape.rows_per_thread)
    want, want_pv = msa.dp_plain(t(reads), t(refs), t(rows), P,
                                 want_prevs=True)
    np.testing.assert_array_equal(out, want.numpy())
    m = valid_mask(rows, R, C)
    np.testing.assert_array_equal(prevs[m], want_pv.numpy()[m])
    assert (prevs[~m] == 0xEE).mean() > 0.3     # unwritten bytes stay
