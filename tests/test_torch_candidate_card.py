"""The candidate stage's kernels on the card: ``slot_pack_kernel``
(csrc/slot_pack.cu, both mappings: "warp", a warp a row, and "block", a
block a row, on crafted rows with wrapping length sums too, from 18 to
8,192 keys), ``chain_candidates_kernel (csrc/chain_candidates.cu,
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
takes (k 32; past it both entries refuse); the key retention
(``ref_retention_kernel``, csrc/ref_retention.cu: "regs", a key a lane,
and "block", a block a read) on crafted counts from 18 to 4,000 keys, and
the gapless score (``gapless_scores_kernel``, csrc/gapless_score.cu:
"thread" and "warp") on the crafted rows of ``tests/gapless_rows`` at 150
and 6,000 bp. Every test skips where there is no CUDA device.
This file imports neither jax nor the JAX package, so it runs on a machine
without them: ``python -m pytest --noconftest
tests/test_torch_candidate_card.py``."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from bbmap_tpu_torch.align import seed
from tests.candidate_rows import INVALID, chain_rows, slot_rows, \
    wrap_slot_rows
from tests.quality_rows import qualities
from tests.retention_counts import crafted


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
    (64, 18, 65536, "warp"), (64, 18, 65536, "block"),
    (64, 64, 4096, "warp"), (64, 65, 4096, "block"), (64, 65, 4096, "warp"),
    (512, 750, 32, "warp"), (512, 750, 32, "block"),
    (512, 750, 4096, "block"), (512, 1100, 16, "block"),
    (512, 2100, 8, "block"), (128, 8192, 4, "block"),
    (64, 3632, 4, "warp")])
def test_slot_pack_mappings_equal_plain(W, nk, B, mapping):
    """Each mapping, forced, on crafted rows with lengths whose int32 sums
    wrap: one launch counted under its mapping, every output equal to the
    plain version's (1, 2, 4 and 8 keys a thread in the block mapping; the
    warp mapping up to its shared memory's 3,632 keys)."""
    dev = _card()
    n_sites = 10_000
    rng = np.random.default_rng(W + nk + B)
    rows = wrap_slot_rows(slot_rows(rng, min(B, 2048), nk, W, n_sites))
    args = [torch.from_numpy(a).to(dev) for a in rows]
    reps = -(-B // args[0].shape[0])
    args = [a.repeat(reps, 1, 1)[:B] for a in args]
    cfg = _cfg(W, nk)
    want = tqd._slot_pack_plain(cfg, *args, n_sites)
    tqd.reset_launches()
    got = tqd.slot_pack_kernel(cfg, *args, n_sites, mapping=mapping)
    torch.cuda.synchronize()
    assert tqd.slot_pack_kernel.launches_by == {
        m: int(m == mapping) for m in tqd.SLOT_PACK_MAPPINGS}
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


@pytest.mark.parametrize("nk,B,max_len,mapping", [
    (18, 65536, 4000, "regs"), (18, 65536, 100, "block"),
    (18, 4096, 4000, "block"), (32, 4096, 4000, "regs"),
    (40, 300, 3000, "block"), (750, 32, 3000, "block"),
    (1500, 16, 3000, "block"), (4000, 4, 9000, "block")])
def test_retention_mappings_equal_plain(nk, B, max_len, mapping):
    """The key retention in each mapping on counts crafted across its tiers
    and branches (``tests/retention_counts``), with weights: one or more
    keys a thread of the block mapping (750 and 40: one, 1,500: two,
    4,000: four)."""
    dev = _card()
    rng = np.random.default_rng(nk + B)
    offsets = tuple(range(0, 8 * nk, 8))
    kp, off, ccnt = (torch.as_tensor(np.tile(a, (-(-B // len(a)), 1))[:B],
                                     device=dev)
                     for a in crafted(rng, min(B, 1024), nk, max_len,
                                      offsets))
    w = torch.as_tensor(rng.uniform(0.2, 1.0, (B, nk)), dtype=torch.float32,
                        device=dev)
    cfg = _cfg(64, nk)._replace(max_usable_length=max_len)
    for weights in (None, w):
        want = tqd._ref_retention(cfg, kp, off, ccnt, weights)
        tqd.reset_launches()
        got = tqd.ref_retention_kernel(cfg, kp, off, ccnt, weights,
                                       mapping=mapping)
        torch.cuda.synchronize()
        assert tqd.ref_retention_kernel.launches_by[mapping] == 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("L,B", [(150, 65536), (150, 1024), (6000, 32)])
@pytest.mark.parametrize("mapping", ["thread", "warp"])
def test_gapless_mappings_equal_plain(L, B, mapping):
    """The gapless score in each mapping on the crafted rows of
    ``tests/gapless_rows`` (word and lane edges, N, windows off the
    genome) on a 200 kbp genome with N runs."""
    from bbmap_tpu_torch.core.genome import Genome, Scaffold
    from bbmap_tpu_torch.index.build import build_index
    from tests.gapless_rows import gapless_rows
    dev = _card()
    rng = np.random.default_rng(L + B)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000).astype(
        np.uint8)
    for at in rng.integers(0, len(g) - 200, 40):
        g[at:at + int(rng.integers(1, 120))] = ord("N")
    genome = Genome(chroms=[g], scaffolds=[Scaffold(
        chrom=1, sid=1, start=0, length=len(g), name="c1")]).finalize()
    dix = tqd.DeviceIndex(build_index(genome, 13), dev)
    cfg = tqd.make_config(dix, L)
    rows = gapless_rows(dix.index.genome_codes, min(B, 4096), L, 5, rng)
    reads, mode, strand = (torch.as_tensor(a, device=dev).repeat(
        -(-B // len(a)), 1)[:B] for a in rows)
    want = tqd._gapless_scores_plain(cfg, reads, mode, strand, dix)
    tqd.reset_launches()
    got = tqd.gapless_scores_kernel(cfg, reads, mode, strand, dix,
                                    mapping=mapping)
    torch.cuda.synchronize()
    assert tqd.gapless_scores_kernel.launches_by[mapping] == 1
    assert torch.equal(got, want)
