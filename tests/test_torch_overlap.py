"""The port's pair-overlap ladders (``bbmap_tpu_torch.ops.overlap_device``,
torch on the CPU) against the JAX package's device programs
(``bbmap_tpu.ops.overlap_device`` on the CPU backend) and the numpy
ladders both packages keep: insert, bad and ambig of the ratio mode and
of the mismatch mode, with and without quality, at equal and uneven read
lengths, on the generator of the JAX package's device test. Tolerance:
exact (the ratio ladder is float32 in both programs)."""

import numpy as np
import pytest

from bbmap_tpu.ops import overlap_device as jod
from bbmap_tpu_torch.ops import overlap as tov
from bbmap_tpu_torch.ops import overlap_device as tod

BASES = np.frombuffer(b"ACGT", np.uint8)


def _pairs(rng, B, alen=150, blen=150, overlap_frac=0.7, err_rate=0.01):
    """tests/test_overlap_device.py's generator: a fraction of the pairs
    overlap at random inserts with 1 % substitutions, the rest are
    unrelated; b in read 1's orientation; phred 2-40."""
    a = rng.choice(BASES, size=(B, alen)).astype(np.uint8)
    b_rc = rng.choice(BASES, size=(B, blen)).astype(np.uint8)
    inserts = rng.integers(60, alen + blen - 20, size=B)
    for i in range(B):
        if rng.random() > overlap_frac:
            continue
        ins = int(inserts[i])
        frag = rng.choice(BASES, size=max(ins, alen, blen))
        a[i] = frag[:alen]
        b_rc[i] = frag[max(0, ins - blen):max(0, ins - blen) + blen]
        errs = rng.random((blen,)) < err_rate
        b_rc[i, errs] = BASES[rng.integers(0, 4, size=int(errs.sum()))]
    qa = rng.integers(2, 41, size=(B, alen)).astype(np.int8)
    qb = rng.integers(2, 41, size=(B, blen)).astype(np.int8)
    return a, qa, b_rc, qb


def _same(got, want, plain):
    for g, w, p, name in zip(got, want, plain, ("insert", "bad", "ambig")):
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, p, err_msg=name)


LENGTHS = [(150, 150, 1), (150, 150, 2), (150, 100, 5), (90, 140, 6)]


@pytest.mark.parametrize("alen,blen,seed", LENGTHS)
def test_ratio_ladder_matches_jax(alen, blen, seed):
    rng = np.random.default_rng(seed)
    a, _qa, b, _qb = _pairs(rng, 64, alen, blen)
    b[::9, 40] = ord("N")
    got = tov.mate_by_overlap_ratio_batch(a, b, device="cpu")
    _same(got, jod.mate_by_overlap_ratio_device(a, b),
          tov.mate_by_overlap_ratio_batch_plain(a, b))
    assert (got[0] > 0).sum() > 10


@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("alen,blen,seed", LENGTHS[::2])
def test_mismatch_ladder_matches_jax(alen, blen, seed, with_q):
    rng = np.random.default_rng(seed + 8)
    a, qa, b, qb = _pairs(rng, 64, alen, blen)
    args = (a, qa if with_q else None, b, qb if with_q else None)
    for minq, mo in ((10, 11), (6, 13)):          # bbmerge's QUAL_ITERS
        kw = dict(min_overlap=mo, minq=minq)
        got = tov.mate_by_overlap_batch(*args, **kw, device="cpu")
        _same(got, jod.mate_by_overlap_device(*args, **kw),
              tov.mate_by_overlap_batch_plain(*args, **kw))
    assert (got[0] > 0).sum() > 10


def test_count_blocks_and_routes(monkeypatch):
    """Blocks of a few inserts give what one block of all gives; each
    call counts one run of its ladder."""
    rng = np.random.default_rng(3)
    a, qa, b, qb = _pairs(rng, 40)
    whole = (tov.mate_by_overlap_ratio_batch(a, b, device="cpu"),
             tov.mate_by_overlap_batch(a, qa, b, qb, device="cpu"))
    monkeypatch.setattr(tod, "COUNT_BLOCK_ELEMENTS", 40 * 150 * 7)
    tod.reset_scans()
    blocks = (tov.mate_by_overlap_ratio_batch(a, b, device="cpu"),
              tov.mate_by_overlap_batch(a, qa, b, qb, device="cpu"))
    assert tod.scans == {"ratio": 1, "mismatch": 1}
    for w, g in zip(whole, blocks):
        for x, y in zip(w, g):
            np.testing.assert_array_equal(x, y)


def test_no_overlap_possible():
    """Reads too short for any overlap: no merge, as in the JAX program
    (the numpy ratio ladder has no insert to reduce over there)."""
    a = np.full((3, 4), ord("A"), np.uint8)
    got = tov.mate_by_overlap_ratio_batch(a, a, min_insert0=40,
                                          device="cpu")
    want = jod.mate_by_overlap_ratio_device(a, a, min_insert0=40)
    _same(got, want, want)
    got = tov.mate_by_overlap_batch(a, None, a, None, device="cpu")
    _same(got, jod.mate_by_overlap_device(a, None, a, None),
          tov.mate_by_overlap_batch_plain(a, None, a, None))
