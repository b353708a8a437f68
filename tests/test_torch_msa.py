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

from bbmap_tpu.core.constants import PACBIO_PROFILE, SHORT_PROFILE
from bbmap_tpu.ops import msa_jax, msa_pallas
from bbmap_tpu_torch.ops import msa, msa_kernels

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)
PROFILES = {"short": SHORT_PROFILE, "pacbio": PACBIO_PROFILE}


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
    np.testing.assert_array_equal(out, pallas_t(reads, refs, rows, R, C, P,
                                                fill=False))
    sc, col, st = msa_jax.msa_score_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C, P)
    np.testing.assert_array_equal(out, np.stack([sc, col, st]))


@pytest.mark.parametrize("prof", ["short", "pacbio"])
def test_fill_plain_matches_pallas_and_scan(prof):
    R, C, B = 30, 48, 8
    P = PROFILES[prof]
    reads, refs, rows = batch_of(11, B, R, C)
    out, prevs = msa_kernels.msa_fill(t(reads), t(refs), t(rows), P)
    out, prevs = out.numpy(), prevs.numpy()
    o_p, pv_p = pallas_t(reads, refs, rows, R, C, P, fill=True)
    np.testing.assert_array_equal(out, o_p)
    m = valid_mask(rows, R, C)
    np.testing.assert_array_equal(prevs[m], pv_p[m])
    pv_x, sc, col, st = msa_jax.msa_trace_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C, P)
    np.testing.assert_array_equal(out, np.stack([sc, col, st]))
    np.testing.assert_array_equal(prevs[m], np.asarray(pv_x)[m])


@pytest.mark.parametrize("case", CASES)
def test_cases_score_and_traceback(case):
    rng = np.random.default_rng(sum(case.values()))
    read, ref = make_case(rng, **case)
    R, C = len(read), len(ref)
    (sc, col, st), prevs = msa_kernels.msa_fill(
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
                                   R, C, P)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("steps", [0, 40])
def test_walk_matches_walk_device(steps):
    """The batched walk against msa_jax._walk_device, full (steps = R+C)
    and bounded (a cut walk reports row_end > 0)."""
    import jax
    R, C, B = 30, 50, 8
    reads, refs, _ = batch_of(9, B, R, C, var_rows=False)
    rows = np.full(B, R, np.int32)
    out, prevs = msa_kernels.msa_fill(t(reads), t(refs), t(rows),
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
    out, prevs = msa_kernels.msa_fill(t(reads), t(refs), t(rows), P)
    pv_x, sc, col, st = msa_jax.msa_trace_batch_var(
        jnp.asarray(reads), jnp.asarray(refs), jnp.asarray(rows), R, C, P)
    np.testing.assert_array_equal(out.numpy(), np.stack([sc, col, st]))
    m = valid_mask(rows, R, C)
    np.testing.assert_array_equal(prevs.numpy()[m], np.asarray(pv_x)[m])
    score = msa_kernels.msa_score(t(reads), t(refs), t(rows), P)
    np.testing.assert_array_equal(score.numpy(), out.numpy())


@pytest.mark.parametrize("R, C, want", [
    (0, 8, (1, 32, 24 + 8)),
    (150, 174, (1, 160, 24 * 151 + 174)),
    (1023, 1100, (1, 1024, 24 * 1024 + 1100)),
    (1024, 1100, (2, 544, 24 * 1025 + 1100 + 1024)),
    (1100, 1200, (2, 576, 24 * 1101 + 1200 + 1100)),
    (4095, 4200, (4, 1024, 24 * 4096 + 4200 + 4095)),
    (6000, 6024, (8, 768, 24 * 6001 + 6024 + 6000)),
    (6000, 6456, (8, 768, 24 * 6001 + 6456 + 6000)),
    (6000, 8192, (8, 768, 24 * 6001 + 8192 + 6000)),
    (8191, 8192, (8, 1024, 24 * 8192 + 8192 + 8191)),
])
def test_launch_shape_rules(R, C, want):
    s = msa_kernels.launch_shape(R, C)
    assert tuple(s) == want
    assert s.long == (R > 1023)
    assert s.threads % 32 == 0 and s.threads <= 1024
    assert s.threads * s.rows_per_thread >= R + 1
    assert s.smem_bytes <= 232_448


def test_launch_shape_limits():
    for R in range(0, 8192, 97):
        s = msa_kernels.launch_shape(R, R + 456)
        assert s.threads * s.rows_per_thread >= R + 1
        assert (s.threads - 32) * s.rows_per_thread < R + 1
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(8192, 8192)          # rows
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(6000, 90_000)        # shared memory
    with pytest.raises(ValueError):
        msa_kernels.launch_shape(-1, 10)
