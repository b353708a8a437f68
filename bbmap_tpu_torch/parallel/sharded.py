"""Multi-device execution: mesh construction and sharded alignment steps
(PyTorch port of bbmap_tpu/parallel/sharded.py).

Replacement for the reference's (stubbed) MPI distributed stream layer
(reference: stream/ConcurrentReadInputStreamD.java:17,
align2/Shared.java:33-38; SURVEY.md §2.11 P5/§5.8). Instead of
master-broadcast read batches over MPI ranks, read batches are split
over a :class:`Mesh`, a (data, index) grid of torch devices:

- axis "data": batch data parallelism — each device scores its
  contiguous chunk of the batch (reference mechanism P1: thread data
  parallelism)
- axis "index": genome/index block sharding — each shard seeds reads
  against its genome block and the shards' candidates are merged in the
  whole index's order (reference mechanism P4: CHROMS_PER_BLOCK index
  blocks, align2/BBIndex.java:616-642)

In one process the mesh is a loop over its entries (on one card every
entry is the same device). Across processes (``build_crosshost_quickmap``)
the "index" axis is the ranks of the gloo process group of
``multihost.init``, and the candidate tables cross it as host tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..backend import DeviceLike, resolve_device
from ..ops import msa_kernels


class Mesh:
    """A (data, index) grid of torch devices with its axis names: what a
    ``jax.sharding.Mesh`` holds for the JAX package. ``devices[d][s]``
    runs data chunk d against index shard s."""

    def __init__(self, devices: Sequence[Sequence[DeviceLike]],
                 axis_names=("data", "index")):
        rows = [[resolve_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.devices = rows
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))


def make_mesh(n_data: Optional[int] = None, n_index: int = 1,
              device: DeviceLike = "cuda") -> Mesh:
    """Build a (data, index) mesh whose every entry is ``device`` (one
    card, or the CPU); ``n_data`` defaults to 1."""
    dev = resolve_device(device)
    return Mesh([[dev] * n_index for _ in range(n_data or 1)])


def sharded_score_step(mesh: Mesh, R: int, C: int):
    """Mesh-sharded candidate-scoring step.

    Inputs: reads (B, R) uint8, refs (B, S, C) uint8 — S index-shard
    windows per read (stand-in for per-genome-block candidates); window
    s of data chunk d is scored on ``mesh.devices[d][s % n_index]`` by
    K1's entry point (``msa_kernels.score_batch``). Returns per-read best
    (score, shard) plus the mapped count — the all-gather / all-reduce of
    per-shard best scores described in SURVEY.md §5.8 — on the mesh's
    first device."""
    n_data = mesh.shape["data"]
    n_index = mesh.shape["index"]
    dev0 = mesh.devices[0][0]

    def step(reads, refs, min_score: int):
        reads, refs = (x if isinstance(x, torch.Tensor)
                       else torch.from_numpy(np.ascontiguousarray(x))
                       for x in (reads, refs))
        chunks = []
        for d, (rd, rf) in enumerate(zip(torch.tensor_split(reads, n_data),
                                         torch.tensor_split(refs, n_data))):
            rows = torch.full((rd.shape[0],), R, dtype=torch.int32,
                              device=rd.device)
            per_shard = []
            for s in range(rf.shape[1]):
                dev = mesh.devices[d][s % n_index]
                score, _col, _st = msa_kernels.score_batch(
                    rd.to(dev), rf[:, s].contiguous().to(dev), rows.to(dev))
                per_shard.append(score.to(dev0))
            chunks.append(torch.stack(per_shard, dim=1))
        scores = torch.cat(chunks)                            # (B, S)
        best = torch.max(scores, dim=1).values
        best_shard = torch.argmax(scores, dim=1).to(torch.int32)
        n_mapped = torch.sum((best >= min_score).to(torch.int32),
                             dtype=torch.int32)
        return best, best_shard, n_mapped

    return step


# ---------------------------------------------------------------------------
# Real sharded pipeline: the CSR k-mer index — the dominant device tenant
# at ~5 bytes/genome-base vs 0.25 for the packed genome — is partitioned
# into contiguous genome blocks over the mesh's "index" axis (reference
# P4: per-block sub-indexes, align2/BBIndex.java:616-642, IndexMaker4
# CHROMS_PER_BLOCK). Each shard runs the quickmap candidate stage
# (seed->chain->vote->top-K) against its block; candidates are gathered
# over "index" and merged with the exact single-device selection order;
# gapless scoring + match generation run on the merged top-K against the
# replicated packed genome. Reads are data-parallel over "data"
# (reference P1/P5).
# ---------------------------------------------------------------------------

from dataclasses import dataclass

from ..align import quickmap_device as qd
from ..align import seed as seed_host
from ..index.build import KmerIndex


@dataclass
class ShardedIndex:
    """CSR index partitioned into contiguous genome blocks. Sites keep
    GLOBAL flat positions, so merged candidates need no coordinate
    translation."""
    n_shards: int
    bounds: np.ndarray      # (n_shards + 1,) block boundaries (flat)
    starts_s: np.ndarray    # (n_shards, 4^k + 1) int32 per-block CSR
    sites_s: np.ndarray     # (n_shards, width) int32, padded


def shard_index(index: KmerIndex, n_shards: int,
                bounds: Optional[np.ndarray] = None) -> ShardedIndex:
    """Partition the CSR index at genome-block boundaries. Default
    bounds: equal flat splits snapped to scaffold starts when one lies
    within 25% of the block size (the reference packs whole chromosomes
    per block; chains never straddle blocks there — snapping preserves
    that property for multi-scaffold genomes)."""
    G = len(index.genome_codes)
    if bounds is None:
        from ..index.build import shard_bounds
        bounds = shard_bounds(G, index.chrom_offsets, n_shards)
    bounds = np.asarray(bounds, np.int64)
    assert len(bounds) == n_shards + 1
    n_keys = index.n_keys
    lengths = np.diff(index.starts)
    key_of_site = np.repeat(np.arange(n_keys, dtype=np.int64), lengths)
    block_of_site = np.clip(
        np.searchsorted(bounds, index.sites, side="right") - 1,
        0, n_shards - 1)
    starts_list = []
    sites_list = []
    for b in range(n_shards):
        sel = block_of_site == b
        counts_b = np.bincount(key_of_site[sel], minlength=n_keys)
        st = np.zeros(n_keys + 1, np.int64)
        np.cumsum(counts_b, out=st[1:])
        starts_list.append(st.astype(np.int32))
        # selection preserves order, and global per-key lists are in
        # ascending position order, so per-block lists stay sorted
        sites_list.append(index.sites[sel])
    width = max(1, max(len(s) for s in sites_list))
    sites_s = np.zeros((n_shards, width), np.int32)
    for b, s in enumerate(sites_list):
        sites_s[b, :len(s)] = s
    return ShardedIndex(n_shards=n_shards, bounds=bounds,
                        starts_s=np.stack(starts_list), sites_s=sites_s)


def _global_counts(index: KmerIndex) -> np.ndarray:
    """Per-key GLOBAL site-list length, uint8 saturated at 255 (every
    admission threshold — 5x tier cap and the slot budget — is < 255).
    Replicated to every shard so over-long-list exclusion, staged
    re-admission, and the greedy slot budget reproduce the
    single-device decisions bit for bit (reference:
    BBIndex.find:421-440 consults whole-index list lengths)."""
    return np.minimum(np.diff(index.starts), 255).astype(np.uint8)


def _merge_candidates(cand, K: int):
    """Merge per-shard candidate tables (B, n_shards*K tensors) down to
    the global top-K with EXACTLY the single-device selection order:
    votes desc, then strand asc, then chain-start diagonal asc (the
    single-device top_k's slot order — strand-major, diagonals sorted
    ascending within strand)."""
    votes = cand["votes"]
    # two stable argsorts give the lexicographic key in int32: sort by
    # start asc, then stably by (budget-votes)*2+strand asc
    ord1 = torch.argsort(cand["start"], dim=1, stable=True)
    v1 = torch.gather(votes, 1, ord1)
    s1 = torch.gather(cand["strand"], 1, ord1)
    key1 = ((1 << 20) - v1.to(torch.int32)) * 2 + s1.to(torch.int32)
    ord2 = torch.argsort(key1, dim=1, stable=True)[:, :K]
    final = torch.gather(ord1, 1, ord2)
    return {k: torch.gather(v, 1, final) for k, v in cand.items()}


def _shard_finalize(cfg, K: int, rcodes, cands: List[dict], dindex):
    """The per-shard quickmap body after each shard's candidate stage
    (against its CSR block, with the GLOBAL list lengths): the shards'
    candidate tables concatenated along axis 1 in shard order (what an
    all-gather over "index" gives), the exact single-device merge, then
    finalize against the replicated packed genome of ``dindex``."""
    dev = rcodes.device
    gathered = {k: torch.cat([c[k].to(dev) for c in cands], dim=1)
                for k in cands[0]}
    merged = _merge_candidates(gathered, K)
    return qd.finalize_stage(cfg, rcodes, merged, dindex)


def build_sharded_quickmap(mesh: Mesh, index: KmerIndex,
                           sindex: ShardedIndex, L: int,
                           chain_dist: int = 400,
                           min_ratio: float = 0.56,
                           max_list_length: Optional[int] = None,
                           profile=None):
    """Mesh-sharded quickmap over the REAL pipeline candidate/finalize
    stages, in one process. Returns run(bases (B, L) uint8) ->
    QuickmapRun on the mesh's first device: the batch splits into
    contiguous chunks over the "data" axis, and each chunk is seeded
    against every "index" shard on ``mesh.devices[d][s]``. Output
    semantics match build_quickmap exactly when chains do not straddle
    block bounds (guaranteed for scaffold-aligned bounds)."""
    n_data, n_index = mesh.shape["data"], mesh.shape["index"]
    assert sindex.n_shards == n_index, (sindex.n_shards, n_index)
    if max_list_length is None:
        actual_max = int(np.diff(index.starts).max()) \
            if len(index.sites) else 1
        max_list_length = min(index.max_usable_length, qd.MAX_SITES_CAP,
                              max(actual_max, 1))
    gcnt = _global_counts(index)
    # one shard DeviceIndex (its block's CSR, the genome, the global
    # canonical counts) and global count table a (device, shard)
    shards = {}
    for row in mesh.devices:
        for s, dev in enumerate(row):
            if (dev, s) not in shards:
                n = int(sindex.starts_s[s, -1])
                local = dataclasses.replace(
                    index, starts=sindex.starts_s[s].astype(np.int64),
                    sites=sindex.sites_s[s, :max(n, 1)])
                shards[dev, s] = (qd.DeviceIndex(local, dev),
                                  torch.from_numpy(gcnt).to(dev))
    first = shards[mesh.devices[0][0], 0][0]
    cfg = qd.make_config(first, L, chain_dist, min_ratio,
                         max_list_length, profile)
    # _global_counts saturates at uint8 255: every admission threshold
    # must stay below that or sharded-vs-single parity silently breaks
    # (ADVICE r2) — assert the invariant at build time.
    assert 5 * cfg.S < 255 and qd.SLOT_BUDGET < 255, \
        (cfg.S, qd.SLOT_BUDGET)
    K = qd.MAX_CANDIDATES
    dev0 = first.device

    def run(bases) -> qd.QuickmapRun:
        b = torch.from_numpy(np.ascontiguousarray(bases[:, :L]))
        outs, syms = [], []
        for d, chunk in enumerate(torch.tensor_split(b, n_data)):
            cands, rcodes = [], []
            for s, dev in enumerate(mesh.devices[d]):
                dix, gcnt_d = shards[dev, s]
                rc, cand = qd.candidate_stage(cfg, chunk.to(dev), dix,
                                              gcnt_d=gcnt_d)
                cands.append(cand)
                rcodes.append(rc)
            # finalize on the chunk's first entry, against its genome
            out_i32, sym = _shard_finalize(
                cfg, K, rcodes[0], cands, shards[mesh.devices[d][0], 0][0])
            outs.append(out_i32.to(dev0))
            syms.append(sym.to(dev0))
        return qd.QuickmapRun(torch.cat(outs), torch.cat(syms), L)

    run.cfg = cfg
    return run


# ---------------------------------------------------------------------------
# Cross-host index sharding: each OS process holds ONLY its genome-block
# CSR shard on its device (index/build.build_index_shard); the ranks of
# the process group form the "index" axis and every batch's candidate
# tables are all-gathered across them — the reference's per-block search
# loop (align2/BBIndex.java:616-642) combined with its distributed-stream
# rank model (stream/ConcurrentReadInputStreamD.java). Replicate-vs-shard
# policy: replication (tools/bbmap.py hosts= striping) wins while the
# index fits one device — no per-batch collective, reads stripe so each
# host does 1/N of the work; sharding wins when the CSR (~5 B/base +
# sites) exceeds the device — every host maps EVERY batch but holds only
# 1/N of the sites, paying one K-candidate all-gather per batch.
# ---------------------------------------------------------------------------


def crosshost_mesh(device: DeviceLike = "cuda") -> Mesh:
    """(data, index) mesh over the process group: "index" spans the
    ranks (one shard a rank), "data" is this rank's one device; every
    entry names this rank's ``device`` (the others are not addressable
    from here)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh([[resolve_device(device)] * n])


def _allgather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's copy of the equal-shaped host tensor ``t``, in rank
    order."""
    import torch.distributed as dist
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def xh_allgather_varlen(flat: np.ndarray, lens: np.ndarray):
    """All-gather variable-length host data across processes: returns
    (flat int64 arrays per process, lens per process). Pads to the max
    total then gathers once (the collective needs equal shapes)."""
    totals = [int(t) for t in _allgather(
        torch.tensor([len(flat)], dtype=torch.int64))]
    cap = max(1, max(totals))
    pad = torch.zeros(cap, dtype=torch.int64)
    pad[:len(flat)] = torch.from_numpy(np.asarray(flat, np.int64))
    data = _allgather(pad)
    lens_all = _allgather(torch.from_numpy(
        np.ascontiguousarray(lens, np.int64)))
    return ([data[p][:totals[p]].numpy() for p in range(len(totals))],
            torch.stack(lens_all).numpy())


def build_crosshost_quickmap(dindex_local: "qd.DeviceIndex",
                             counts_global: np.ndarray, L: int,
                             chain_dist: int = 400,
                             min_ratio: float = 0.56,
                             mesh: Optional[Mesh] = None, profile=None):
    """Cross-host sharded quickmap: every rank calls this with ITS local
    block index on its device (build_index_shard, after
    analyze_index(..., lengths_global=counts_global)). Returns
    run(bases, quality=None) -> QuickmapRun, the same on every rank.
    Output parity with a single-process full-index run is exact, quality
    included: each rank computes the quality offsets with the same device
    stage as the single-process quickmap."""
    import torch.distributed as dist

    if mesh is None:
        mesh = crosshost_mesh(dindex_local.device)
    n_proc = mesh.shape["index"]
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert world == n_proc, (world, n_proc)

    actual_max = max(int(counts_global.max()), 1)
    cfg = qd.make_config(
        dindex_local, L, chain_dist, min_ratio,
        max_list_length=min(dindex_local.index.max_usable_length,
                            qd.MAX_SITES_CAP, actual_max),
        profile=profile)
    K = qd.MAX_CANDIDATES
    assert 5 * cfg.S < 255 and qd.SLOT_BUDGET < 255, \
        (cfg.S, qd.SLOT_BUDGET)
    dev = dindex_local.device
    gcnt_d = torch.from_numpy(
        np.minimum(counts_global, 255).astype(np.uint8)).to(dev)
    den2, den3 = seed_host.key_density_ladder(L, dindex_local.k)
    fields = ("votes", "mode", "strand", "start", "spread")

    def run(bases, quality=None) -> qd.QuickmapRun:
        b = torch.from_numpy(np.ascontiguousarray(bases[:, :L])).to(dev)
        offs = wts = rej = None
        if quality is not None:
            qt = torch.from_numpy(
                np.ascontiguousarray(quality[:, :L])).to(dev)
            offs, wts, rej = qd.quality_offsets_stage(
                cfg, qt, den2, den3, return_weights=True)
        rcodes, cand = qd.candidate_stage(
            cfg, b, dindex_local, offsets_dyn=offs, weights_dyn=wts,
            reject=rej, gcnt_d=gcnt_d)
        # one collective a batch: the five (B, K) tables stacked, through
        # host memory (gloo), back to this rank's device in rank order
        stacked = torch.stack([cand[f].to(torch.int32) for f in fields])
        cands = [dict(zip(fields, t.to(dev)))
                 for t in _allgather(stacked.cpu())]
        out_i32, sym = _shard_finalize(cfg, K, rcodes, cands, dindex_local)
        return qd.QuickmapRun(out_i32, sym, L)

    run.cfg = cfg
    return run


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """Run the REAL aligner pipeline (BBMapAligner.map_batch_columnar)
    over an n-entry (data x index) mesh on ``device`` — the CSR k-mer
    index sharded into genome blocks over the "index" axis, reads
    data-parallel over "data", candidates merged as the all-gather would
    (reference P4: align2/BBIndex.java:616-642, P5:
    stream/ConcurrentReadInputStreamD.java:157) — and assert parity with
    the single-device path on the same reads (the counterpart of
    ``__graft_entry__.dryrun_multichip``)."""
    from ..align.pipeline import BBMapAligner
    from ..core.batch import ReadBatch
    from ..core.genome import Genome, Scaffold
    from ..index.build import analyze_index, build_index

    n_index = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_index
    mesh = make_mesh(n_data=n_data, n_index=n_index, device=device)

    rng = np.random.default_rng(1)
    bases4 = np.frombuffer(b"ACGT", np.uint8)
    chroms = [rng.choice(bases4, size=n).astype(np.uint8)
              for n in (30_000, 34_000)]
    # implanted repeat family: a 600 bp unit copied 12x across both
    # chroms drives k-mer site lists past the base admission cap, so the
    # staged re-admission tiers and greedy slot budget (global-count
    # table, reference: BBIndex.find:421-440) fire inside this check
    unit = rng.choice(bases4, size=600).astype(np.uint8)
    for c in chroms:
        for at in rng.choice(len(c) - 700, size=6, replace=False):
            c[at:at + 600] = unit
    g = Genome(chroms=chroms, scaffolds=[
        Scaffold(chrom=i + 1, sid=i + 1, start=0, length=len(c),
                 name=f"s{i + 1}") for i, c in enumerate(chroms)
    ]).finalize()
    index = build_index(g, 10)
    analyze_index(index, 0.01)

    L = 100
    B = 8 * n_data
    gc = index.genome_codes
    A = np.frombuffer(b"ACGTN", np.uint8)
    ok = np.lib.stride_tricks.sliding_window_view(gc < 4, L).all(axis=1)
    starts = rng.choice(np.nonzero(ok)[0], size=B)
    reads = A[np.minimum(
        np.stack([gc[s:s + L] for s in starts]), 4)]
    # a quarter of the reads come from inside the repeat unit (long
    # site lists: the re-admission path must agree across shards)
    reads[:B // 4] = unit[100:100 + L][None, :]
    for i in range(0, B, 3):   # substitutions on a third of the reads
        for _ in range(2):
            reads[i, rng.integers(0, L)] = bases4[rng.integers(0, 4)]
    batch = ReadBatch(
        bases=reads, quality=None,
        lengths=np.full(B, L, np.int32),
        ids=[str(i) for i in range(B)],
        numeric_ids=np.arange(B, dtype=np.int64))

    multi = BBMapAligner(g, index, device, mesh=mesh)
    single = BBMapAligner(g, index, device)
    mb_m = multi.map_batch_columnar(batch)
    mb_s = single.map_batch_columnar(batch)
    assert mb_m is not None and mb_s is not None
    for field in ("mapped", "strand", "chrom", "start", "stop", "score"):
        a = getattr(mb_s, field)
        b = getattr(mb_m, field)
        assert np.array_equal(a, b), (
            f"multi-device parity failure on {field}")
    n_mapped = int(mb_m.mapped.sum())
    assert n_mapped == B, f"expected all {B} mapped, got {n_mapped}"
    offs = np.asarray(index.chrom_offsets)
    flat = offs[np.asarray(mb_m.chrom) - 1] + np.asarray(mb_m.start)
    correct = np.abs(flat - starts) <= 5
    # repeat-family reads (rows < B//4) legitimately map to any copy;
    # the exact multi == single asserts above cover them
    correct[:B // 4] = True
    frac = correct.mean()
    assert frac >= 0.75, f"origin correctness {frac:.2f}"
