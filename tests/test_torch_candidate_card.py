"""The candidate stage's two kernels on the card: ``slot_pack_kernel``
(csrc/slot_pack.cu) and ``chain_candidates_kernel``
(csrc/chain_candidates.cu), one launch each, against their plain versions
on the same CUDA tensors, tolerance 0, on the crafted rows of
``tests/candidate_rows`` at the short path's shape (W = 64, 18 keys) and
the long path's (W = 512, 750 keys), and at the short path's batch
(65,536 reads). Every test skips where there is no CUDA device. This file
imports neither jax nor the JAX package, so it runs on a machine without
them: ``python -m pytest --noconftest tests/test_torch_candidate_card.py``."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from tests.candidate_rows import chain_rows, slot_rows


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(W: int, nk: int) -> tqd.QmConfig:
    return tqd.QmConfig(k=13, L=150, S=32, chain_dist=400, min_score=0,
                        offsets_list=tuple(range(nk)), G=1, slot_budget=W)


@pytest.mark.parametrize("W,nk,B", [(64, 18, 4096), (512, 750, 32),
                                    (64, 18, 65536), (40, 33, 100)])
def test_slot_pack_equals_plain(W, nk, B):
    dev = _card()
    n_sites = 10_000
    rng = np.random.default_rng(W + B)
    args = [torch.from_numpy(a).to(dev)
            for a in slot_rows(rng, min(B, 4096), nk, W, n_sites)]
    reps = -(-B // args[0].shape[0])
    args = [a.repeat(reps, 1, 1)[:B] for a in args]
    cfg = _cfg(W, nk)
    want = tqd._slot_pack_plain(cfg, *args, n_sites)
    tqd.reset_launches()
    got = tqd.slot_pack_kernel(cfg, *args, n_sites)
    torch.cuda.synchronize()
    assert tqd.slot_pack_kernel.launches == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("W,nk,B", [(64, 18, 4096), (512, 750, 32),
                                    (64, 18, 65536), (40, 33, 100)])
def test_chain_candidates_equal_plain(W, nk, B):
    dev = _card()
    rng = np.random.default_rng(W + B + 1)
    diag, toff = (torch.from_numpy(a).to(dev)
                  for a in chain_rows(rng, min(B, 2048), W, nk, 400))
    reps = -(-B // diag.shape[0])
    diag, toff = (a.repeat(reps, 1, 1)[:B] for a in (diag, toff))
    cfg = _cfg(W, nk)
    want = tqd._chain_candidates_plain(cfg, diag, toff)
    tqd.reset_launches()
    got = tqd.chain_candidates_kernel(cfg, diag, toff)
    torch.cuda.synchronize()
    assert tqd.chain_candidates_kernel.launches == 1
    for k, w in want.items():
        assert torch.equal(got[k], w), k
