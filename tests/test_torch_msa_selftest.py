"""The port's kernel self-test (bbmap_tpu_torch/ops/msa_selftest.py) must
itself work: on the CPU its wrappers take the plain versions (on the card,
the kernels); a broken kernel is caught, not accepted; and its cases are
the JAX package's for the same generator."""

import numpy as np
import pytest
import torch

from bbmap_tpu.ops import msa_selftest as jst
from bbmap_tpu_torch.ops import msa_kernels
from bbmap_tpu_torch.ops import msa_selftest as tst
from bbmap_tpu_torch.ops.msa_selftest import kernel_selftest

torch.set_num_threads(2)


def test_selftest_passes_short():
    assert kernel_selftest(profiles=("short",), n=16, device="cpu")


def test_selftest_passes_pacbio():
    assert kernel_selftest(profiles=("pacbio",), n=16, device="cpu")


def test_selftest_catches_regression(monkeypatch):
    """A K2 whose scores are one off must be reported, not accepted."""
    orig = msa_kernels.msa_score

    def broken(reads, refs, rows, P, mapping=None):
        out = orig(reads, refs, rows, P, mapping).clone()
        out[0] += 1
        return out

    monkeypatch.setattr(msa_kernels, "msa_score", broken)
    msgs = []
    assert not kernel_selftest(profiles=("short",), n=16, device="cpu",
                               verbose=msgs.append)
    assert any("MISMATCH" in m and "score-kernel score" in m for m in msgs)
    assert not any("fill" in m for m in msgs)


@pytest.mark.parametrize("n,R,C", [(16, 64, 128), (128, 64, 128),
                                   (8, 30, 80)])
def test_cases_equal_the_jax_cases(n, R, C):
    a = tst._cases(np.random.default_rng(20260820), n, R, C)
    b = jst._cases(np.random.default_rng(20260820), n, R, C)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_precomputed_cases_are_the_generated_ones():
    """``selftest_cases`` draws the profiles' cases in the order
    ``kernel_selftest`` does, and handing them over gives its answer."""
    cases = tst.selftest_cases(n=8)
    rng = np.random.default_rng(20260820)
    for pname, reads, refs, score, col in cases:
        r, f = tst._cases(rng, 8, 64, 128)
        np.testing.assert_array_equal(reads, r)
        np.testing.assert_array_equal(refs, f)
        assert score.shape == col.shape == (8,) and (score > 0).all()
    assert [c[0] for c in cases] == ["short", "pacbio"]
    assert kernel_selftest(device="cpu", cases=cases)
