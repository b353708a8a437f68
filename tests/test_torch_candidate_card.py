"""The candidate stage's kernels on the card: ``slot_pack_kernel``
(csrc/slot_pack.cu), ``chain_candidates_kernel`` (csrc/chain_candidates.cu,
both mappings: "regs", the rows in registers, and "smem", the rows in
shared memory) and the quality offsets' two entries
(``quality_offsets_kernel`` on q and pc, ``quality_offsets_packed_kernel``
on the palette-packed words; csrc/quality_offsets.cu), one launch each,
against their plain versions on the same CUDA tensors, tolerance 0: on the
crafted rows of ``tests/candidate_rows`` at the short path's shape (W = 64,
18 keys; 65,536 reads as well) and the long path's (W = 512, 750 keys, 32
reads), rows the register mapping's 32-bit sort key cannot hold, and on
the qualities of ``tests/quality_rows`` at 65,536 x 150 (k 13), 32 x 6,000
(k 12), 200 x 2,000 (k 13) and 512 x 400 at the longest key the kernel
takes (k 32; past it both entries refuse). Every test skips where there is
no CUDA device.
This file imports neither jax nor the JAX package, so it runs on a machine
without them: ``python -m pytest --noconftest
tests/test_torch_candidate_card.py``."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from bbmap_tpu_torch.align import seed
from tests.candidate_rows import INVALID, chain_rows, slot_rows
from tests.quality_rows import qualities


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


@pytest.mark.parametrize("W,nk,B,mapping", [
    (64, 18, 4096, None), (512, 750, 32, None), (64, 18, 65536, None),
    (40, 33, 100, None), (64, 18, 65536, "smem"), (512, 750, 32, "smem"),
    (100, 60, 300, "regs"), (128, 18, 300, "regs"), (32, 700, 300, "regs")])
def test_chain_candidates_equal_plain(W, nk, B, mapping):
    dev = _card()
    rng = np.random.default_rng(W + B + 1)
    diag, toff = (torch.from_numpy(a).to(dev)
                  for a in chain_rows(rng, min(B, 2048), W, nk, 400))
    reps = -(-B // diag.shape[0])
    diag, toff = (a.repeat(reps, 1, 1)[:B] for a in (diag, toff))
    cfg = _cfg(W, nk)
    want = tqd._chain_candidates_plain(cfg, diag, toff)
    tqd.reset_launches()
    got = tqd.chain_candidates_kernel(cfg, diag, toff, mapping=mapping)
    torch.cuda.synchronize()
    how = tqd.chain_mapping(W, mapping)
    assert tqd.chain_candidates_kernel.launches == 1
    assert tqd.chain_candidates_kernel.launches_by[how] == 1
    assert how == (mapping or ("regs" if W <= 128 else "smem"))
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("B,L,k", [(65536, 150, 13), (32, 6000, 12),
                                   (200, 2000, 13), (512, 400, 32)])
@pytest.mark.parametrize("entry", ["raw", "packed"])
def test_quality_entries_equal_plain(B, L, k, entry):
    dev = _card()
    cfg = tqd.QmConfig(k=k, L=L, S=2, chain_dist=400, min_score=0,
                       offsets_list=tuple(int(o) for o in
                                          seed.make_offsets(L, k)), G=0)
    den2, den3 = seed.key_density_ladder(L, k)
    q = qualities(min(B, 4096), L, L + B)
    q = np.tile(q, (-(-B // len(q)), 1))[:B]
    if L > 1000:       # randomreads' PacBio range, within 16 values
        q[B // 2:] = np.random.default_rng(3).choice(
            np.array([28, 31, 33, 35], np.int8), (B - B // 2, L))
    qi = torch.as_tensor(np.clip(q.astype(np.int32), 0, 127), device=dev)
    pc = torch.as_tensor(seed.PROB_CORRECT, device=dev)[qi.long()]
    want = tqd._quality_offsets_core(cfg, qi, pc, den2, den3, True)
    tqd.reset_launches()
    if entry == "raw":
        got = tqd.quality_offsets_kernel(cfg, qi, pc, den2, den3)
        n = tqd.quality_offsets_kernel.launches
    else:
        qpack, pal, pcp = tqd.pack_quality_host(q, L)
        assert qpack is not None
        got = tqd.quality_offsets_packed_kernel(
            cfg, torch.as_tensor(qpack.astype(np.int64), device=dev),
            torch.as_tensor(pal, device=dev), torch.as_tensor(pcp,
                                                              device=dev),
            den2, den3)
        n = tqd.quality_offsets_packed_kernel.launches
    torch.cuda.synchronize()
    assert n == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("entry", ["raw", "packed"])
def test_quality_refuses_keys_past_32(entry):
    """Keys of 33 bases: both entries raise on CUDA tensors and launch
    nothing (the plain version on CPU tensors takes any k)."""
    dev = _card()
    L, k = 400, 33
    cfg = tqd.QmConfig(k=k, L=L, S=2, chain_dist=400, min_score=0,
                       offsets_list=tuple(int(o) for o in
                                          seed.make_offsets(L, k)), G=0)
    den2, den3 = seed.key_density_ladder(L, k)
    q = qualities(64, L, 9)
    tqd.reset_launches()
    with pytest.raises(ValueError):
        if entry == "raw":
            qi = torch.as_tensor(q.astype(np.int32), device=dev)
            pc = torch.as_tensor(seed.PROB_CORRECT, device=dev)[qi.long()]
            tqd.quality_offsets_kernel(cfg, qi, pc, den2, den3)
        else:
            qpack, pal, pcp = tqd.pack_quality_host(q, L)
            tqd.quality_offsets_packed_kernel(
                cfg, torch.as_tensor(qpack.astype(np.int64), device=dev),
                torch.as_tensor(pal, device=dev),
                torch.as_tensor(pcp, device=dev), den2, den3)
    assert tqd.quality_offsets_kernel.launches == 0
    assert tqd.quality_offsets_packed_kernel.launches == 0


@pytest.mark.parametrize("wide", ["spread", "invalid", "slots"])
def test_chain_regs_wide_rows_equal_plain(wide):
    """Rows the register mapping's 32-bit sort key cannot hold (a row's
    diagonals spread past it, invalid diagonals other than 2^30, key slots
    past 16 bits of the key) take its int64 key: still the plain table."""
    dev = _card()
    W, nk, B = 64, 40, 4096
    rng = np.random.default_rng(len(wide))
    diag, toff = chain_rows(rng, 512, W, nk, 400)
    d = diag.astype(np.int64)
    valid = d < INVALID
    if wide == "spread":
        d[::3, 0, :5] = np.where(valid[::3, 0, :5], d[::3, 0, :5] - 2 ** 29,
                                 d[::3, 0, :5])
    elif wide == "invalid":
        d[~valid] = INVALID + rng.integers(0, 5, (~valid).sum())
    else:
        toff = np.where(rng.random(toff.shape) < 0.2,
                        rng.integers(0, 65535, toff.shape), toff)
    diag, toff = (torch.from_numpy(a.astype(np.int32)).to(dev)
                  .repeat(B // 512, 1, 1) for a in (d, toff))
    cfg = _cfg(W, nk)
    want = tqd._chain_candidates_plain(cfg, diag, toff)
    got = tqd.chain_candidates_kernel(cfg, diag, toff, mapping="regs")
    for k, w in want.items():
        assert torch.equal(got[k], w), k
