"""BBMap-class alignment pipeline: seed -> chain -> device DP -> select ->
traceback -> SAM (PyTorch port of bbmap_tpu/align/pipeline.py).

Host numpy code copied from the JAX package with its device calls pointed
at this package's modules: the quickmap, fused, escalation and rescue
programs run as PyTorch on the aligner's ``device``, and every DP pass
goes through the score / fill kernel wrappers (ops/msa_kernels.py). A
``mesh`` (parallel/sharded.py) shards the CSR index over genome blocks in
one process; the cross-host sharded index injects its quickmap through
``quickmap_factory`` (tools/bbmap.py shardindex=).

Orchestration replacing the reference per-thread loop
(reference: align2/AbstractMapThread.java:387-640 processRead /
align2/BBMapThread.java:389-943). Stages:

1. seeding/chaining (align/seed.py) produces Candidate sites per read
2. candidate windows are bucketed by (read-rows, window-cols) and scored by
   the wavefront DP (ops/msa.msa_score_batch) — the analog of
   msa.fillAndScoreLimited over each SiteScore
   (reference: align2/BBMapThread.scoreSlow:252-345)
3. per-read site selection with the reference's clearzone ambiguity model
   (reference: align2/BBMapThread.java:500-560)
4. winners only re-run through the full DP (msa_full_batch) and the
   traceback walk produces long-form match strings
   (reference: align2/MultiStateAligner11ts.traceback2)
5. host SAM emission (io/sam.py)
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import seed
from ..core import constants as K
from ..core.batch import ReadBatch
from ..core.genome import Genome
from ..index.build import KmerIndex
from ..io import sam as samio

from ..backend import DeviceLike, prev_code_budget, resolve_device
from ..ops import msa, msa_kernels
from .quickmap_device import DeviceIndex

# reference defaults (align2/BBMap.java:44-63, align2/AbstractMapThread.java)
MIN_RATIO = 0.56
SLOW_ALIGN_PADDING = 4
MAX_PAIR_DIST = 32000            # reference: AbstractMapThread.java:2975
MIN_PAIR_DIST = -160             # reference: AbstractMapThread.java:2974
MAX_RESCUE_DIST = 1200           # reference: AbstractMapThread.java:2976
MAX_RESCUE_MISMATCHES = 32       # reference: AbstractMapThread.java:2977
AVERAGE_PAIR_DIST = 100          # initial (:2948); updated to the
# cumulative mated-inner-distance mean once >1000 pairs observed
# (DYNAMIC_INSERT_LENGTH, reference: BBMapThread.java:1307-1309)
_NB = ord("N")
OUTER_DIST_MULT = 14             # reference: AbstractMapThread.java:2991
OUTER_DIST_DIV = 32
# clearzone model (reference: align2/BBMapThread.java:38-57,114-134)
CLEARZONEP = int(1.6 * K.POINTS_MATCH2)
CLEARZONE1 = int(2.0 * K.POINTS_MATCH2)
CLEARZONE1b = int(2.6 * K.POINTS_MATCH2)
CLEARZONE1c = int(4.6 * K.POINTS_MATCH2)
CLEARZONE3 = int(8.0 * K.POINTS_MATCH2)
CLEARZONE1e = 2 * K.POINTS_MATCH2 - K.POINTS_MATCH - K.POINTS_SUB + 1
CZ1B_CUTOFF_FLAT = 12 * K.POINTS_MATCH2
CZ1B_CUTOFF_SCALE = 0.97
CZ1C_CUTOFF_FLAT = 26 * K.POINTS_MATCH2
CZ1C_CUTOFF_SCALE = 0.92


@dataclass(slots=True)
class MappedRead:
    """Final per-read mapping result (the essentials of the reference's
    mapped Read, stream/Read.java)."""
    mapped: bool = False
    strand: int = 0
    chrom: int = 0          # 1-based chrom block
    start: int = 0          # 0-based chrom-local alignment start
    stop: int = 0           # 0-based chrom-local last ref base
    score: int = 0
    match: Optional[bytes] = None
    ambiguous: bool = False
    perfect: bool = False
    paired: bool = False    # proper-pair
    rescued: bool = False   # found by mate rescue (SiteScore.rescued)
    n_sites: int = 1
    secondary: Optional[list] = None  # [(chrom, start, stop, strand,
    #   score, match)] when secondary-site output is enabled


class MappedBatch:
    """Columnar (struct-of-arrays) mapping results for one batch — the
    device fast path writes vectorized numpy columns instead of one
    Python object per read (reference's Read-object model replaced per
    VERDICT r1: columnar MappedRead). Escalated (DP) reads carry their
    variable-length match strings in ``match_override``; direct gapless
    reads share the fixed (B, L) match-row block transferred from the
    device."""

    __slots__ = ("size", "mapped", "strand", "chrom", "start", "stop",
                 "score", "ambiguous", "perfect", "paired", "rescued",
                 "n_sites", "match_rows", "match_is_row",
                 "match_override", "match_fill")

    def __init__(self, B: int, L: int = 0):
        self.size = B
        self.mapped = np.zeros(B, bool)
        self.strand = np.zeros(B, np.int8)
        self.chrom = np.zeros(B, np.int32)
        self.start = np.zeros(B, np.int64)
        self.stop = np.zeros(B, np.int64)
        self.score = np.zeros(B, np.int64)
        self.ambiguous = np.zeros(B, bool)
        self.perfect = np.zeros(B, bool)
        self.paired = np.zeros(B, bool)
        self.rescued = np.zeros(B, bool)
        self.n_sites = np.ones(B, np.int32)
        self.match_rows: Optional[np.ndarray] = None  # (B, L) uint8
        self.match_is_row = np.zeros(B, bool)
        self.match_override: Dict[int, Optional[bytes]] = {}
        # deferred gapless-match fillers (fused path: match rows are
        # recomputed from the genome only when a consumer actually asks
        # — throughput paths never pay for them)
        self.match_fill: list = []

    def materialize_matches(self) -> None:
        if self.match_fill:
            fns, self.match_fill[:] = list(self.match_fill), []
            for fn in fns:
                fn()

    def match(self, i: int) -> Optional[bytes]:
        self.materialize_matches()
        if i in self.match_override:
            return self.match_override[i]
        if self.match_is_row[i] and self.match_rows is not None:
            return bytes(self.match_rows[i])
        return None

    def absorb_objects(self, objs: Dict[int, "MappedRead"]) -> None:
        """Merge per-read objects (escalated reads) into the columns."""
        for i, r in objs.items():
            self.mapped[i] = r.mapped
            self.strand[i] = r.strand
            self.chrom[i] = r.chrom
            self.start[i] = r.start
            self.stop[i] = r.stop
            self.score[i] = r.score
            self.ambiguous[i] = r.ambiguous
            self.perfect[i] = r.perfect
            self.paired[i] = r.paired
            self.rescued[i] = r.rescued
            self.n_sites[i] = r.n_sites
            self.match_is_row[i] = False
            self.match_override[i] = r.match

    def fill_objects(self, results: List["MappedRead"]) -> None:
        mapped = self.mapped
        for i in range(self.size):
            r = results[i]
            r.score = int(self.score[i])
            r.perfect = bool(self.perfect[i])
            r.ambiguous = bool(self.ambiguous[i])
            r.n_sites = int(self.n_sites[i])
            r.paired = bool(self.paired[i])
            r.rescued = bool(self.rescued[i])
            if mapped[i]:
                r.mapped = True
                r.strand = int(self.strand[i])
                r.chrom = int(self.chrom[i])
                r.start = int(self.start[i])
                r.stop = int(self.stop[i])
                r.match = self.match(i)


def clearzone_for(score: int, max_sw: int, perfect: bool) -> int:
    """reference: align2/BBMapThread.java:508-525."""
    if perfect:
        return CLEARZONEP
    cz1b_lim = max_sw * CZ1B_CUTOFF_SCALE - CZ1B_CUTOFF_FLAT
    cz1c_lim = max_sw * CZ1C_CUTOFF_SCALE - CZ1C_CUTOFF_FLAT
    if score > cz1b_lim:
        return int(((max_sw - score) * CLEARZONE1b
                    + (score - cz1b_lim) * CLEARZONE1)
                   / (max_sw - cz1b_lim))
    if score > cz1c_lim:
        return int(((cz1b_lim - score) * CLEARZONE1c
                    + (score - cz1c_lim) * CLEARZONE1b)
                   / (cz1b_lim - cz1c_lim))
    return CLEARZONE1c


def clearzone_vec(score: np.ndarray, max_sw: int,
                  perfect: np.ndarray) -> np.ndarray:
    """Vectorized clearzone_for (reference: align2/BBMapThread.java:508-525)."""
    score = score.astype(np.float64)
    cz1b_lim = max_sw * CZ1B_CUTOFF_SCALE - CZ1B_CUTOFF_FLAT
    cz1c_lim = max_sw * CZ1C_CUTOFF_SCALE - CZ1C_CUTOFF_FLAT
    hi = ((max_sw - score) * CLEARZONE1b
          + (score - cz1b_lim) * CLEARZONE1) / max(max_sw - cz1b_lim, 1e-9)
    mid = ((cz1b_lim - score) * CLEARZONE1c
           + (score - cz1c_lim) * CLEARZONE1b) / max(cz1b_lim - cz1c_lim,
                                                     1e-9)
    cz = np.where(score > cz1b_lim, hi,
                  np.where(score > cz1c_lim, mid, CLEARZONE1c))
    return np.where(perfect, CLEARZONEP, cz.astype(np.int64))


# PacBio clearzone model: step thresholds, no interpolation, no flat
# offsets (reference: align2/BBMapThreadPacBio.java:38-54, 1096-1112)
CZP_RATIOP, CZP_RATIO1, CZP_RATIO1b, CZP_RATIO1c = 1.5, 2.2, 2.8, 4.8
CZP_1B_CUTOFF, CZP_1C_CUTOFF = 0.92, 0.82


def clearzone_vec_pacbio(score: np.ndarray, max_sw: int,
                         perfect: np.ndarray) -> np.ndarray:
    m2 = K.POINTS_MATCH2
    czp = int(CZP_RATIOP * m2)
    cz1 = int(CZP_RATIO1 * m2)
    cz1b = int(CZP_RATIO1b * m2)
    cz1c = int(CZP_RATIO1c * m2)
    cz = np.where(score >= int(max_sw * CZP_1B_CUTOFF), cz1,
                  np.where(score >= int(max_sw * CZP_1C_CUTOFF),
                           cz1b, cz1c))
    return np.where(perfect, czp, cz).astype(np.int64)


def _bucket_pad(n: int) -> int:
    """Pad job counts to powers of two (min 16) to bound recompilation."""
    p = 16
    while p < n:
        p <<= 1
    return p


DP_CHUNK = 8192       # device batch for fill+traceback DP jobs


def _dp_tb_chunk_cap(L: int, C: int, device) -> int:
    """Memory-aware cap for fill+traceback chunks: the device's
    prev-code budget (``backend.prev_code_budget``) over the bytes one
    job's prev codes take in the fill's layout there — tens of MB a job
    at the 6 kbp PacBio envelope, where a short-read-sized chunk would
    not fit any card."""
    per_job = msa_kernels.prev_code_bytes(L, C, device)
    return max(8, min(DP_CHUNK, prev_code_budget(device) // per_job))
DP_SCORE_CHUNK = 32768  # device batch for score-only DP
GAPLESS_CHUNK = 8192  # fixed device batch for gapless scoring


class _ResultsProxy:
    """results-list stand-in for the escalation path: only the escalated
    read indices are materialized as MappedRead objects (the direct bulk
    stays columnar)."""

    def __init__(self):
        self.store: Dict[int, MappedRead] = {}

    def __getitem__(self, i) -> MappedRead:
        i = int(i)
        r = self.store.get(i)
        if r is None:
            r = MappedRead()
            self.store[i] = r
        return r


def _fixed_chunks(n: int, size: int):
    """Yield (start, stop) covering [0, n) in fixed-size chunks; every
    chunk is padded to exactly `size` by the caller, so the compiled
    shapes never vary between batches."""
    for a in range(0, max(n, 1), size):
        yield a, min(a + size, n)


class BBMapAligner:
    def __init__(self, genome: Genome, index: KmerIndex,
                 device: DeviceLike,
                 min_ratio: float = MIN_RATIO,
                 max_candidates: int = 16,
                 chain_dist: int = 400,
                 ambig_mode: str = "best", maxindel: int = 16000,
                 device_quickmap: bool = True, local: bool = False,
                 print_secondary: bool = False, max_sites: int = 5,
                 mesh=None, n_index_shards: Optional[int] = None,
                 profile=None):
        self.device = resolve_device(device)
        # multi-device: shard the CSR index over the mesh's "index" axis
        # and read batches over "data" (reference P4/P5; VERDICT r1 #2).
        # The shard count is the mesh's; n_index_shards is kept for the
        # JAX package's signature and must name the same number
        if mesh is not None:
            from ..parallel.sharded import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.sharded.Mesh, "
                                f"not {type(mesh).__name__}")
            if n_index_shards not in (None, mesh.shape["index"]):
                raise ValueError(
                    f"n_index_shards={n_index_shards}, but the mesh has "
                    f"{mesh.shape['index']} index shards")
        self.mesh = mesh
        self._sharded_index = None
        # cross-host index sharding (parallel/sharded.py
        # build_crosshost_quickmap): an injected factory supplies the
        # quickmap runner; mesh_quality marks that it accepts quality;
        # _xh_gather merges host-side long-indel seed lists across
        # processes; _li_global_counts replaces local CSR lengths in
        # host seeding filters (the local shard's lengths are partial)
        self.quickmap_factory = None
        self.mesh_quality = False
        self._xh_gather = None
        self._li_global_counts = None
        # scoring profile: SHORT (MSA11ts) or PACBIO (MSA9PacBio) with
        # its own clearzone model (reference: BBMapThreadPacBio.java)
        self.profile = profile if profile is not None else K.SHORT_PROFILE
        self._czvec = (clearzone_vec_pacbio
                       if self.profile.name == "pacbio"
                       else clearzone_vec)
        self.print_secondary = print_secondary
        self.max_sites = max_sites
        self.local = local
        self.genome = genome
        self.index = index
        # the device-resident index (CSR, packed genome, counts)
        self.dindex = DeviceIndex(index, self.device)
        self.min_ratio = min_ratio
        self.max_candidates = max_candidates
        self.chain_dist = chain_dist
        self.ambig_mode = ambig_mode
        self.maxindel = maxindel
        # the flat int32 site space caps device quickmap at 1 Gbp genomes
        self.device_quickmap = (device_quickmap
                                and index.chrom_offsets[-1] < 2 ** 30)
        self._qm_cache: Dict[int, object] = {}
        self._esc_cache: Dict[int, dict] = {}
        self._fused_cache: Dict[Tuple[int, int], object] = {}
        # running average of observed inner pair distances (reference:
        # AbstractMapThread AVERAGE_PAIR_DIST dynamic update, :131,
        # INITIAL_AVERAGE_PAIR_DIST=100)
        self.average_pair_dist = float(AVERAGE_PAIR_DIST)
        self._pair_obs = 0
        self._inner_sum = 0      # innerLengthSum (reference: :3037)
        self._num_mated = 0      # numMated (:3033)
        self._mapped_retained = 0  # mappedRetained2 rescue cutoff (:1146)
        # device-budget fallback accounting (ADVICE r4 visibility)
        self._n_esc_rows = 0
        self._n_fallback_rows = 0
        self.codes_ascii = self._genome_ascii()
        self.chrom_offsets = index.chrom_offsets

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the aligner's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _genome_ascii(self) -> np.ndarray:
        """Concatenated genome as ASCII (for DP windows and traceback)."""
        from ..core.bases import codes_to_ascii
        return codes_to_ascii(self.index.genome_codes)

    # ---- window extraction ----
    def _window(self, start: int, length: int) -> np.ndarray:
        g = self.codes_ascii
        lo, hi = start, start + length
        lo_c, hi_c = max(lo, 0), min(hi, len(g))
        out = np.full(length, ord("N"), np.uint8)
        out[lo_c - lo:hi_c - lo] = g[lo_c:hi_c]
        return out

    def _chrom_of(self, flat_pos: int) -> Tuple[int, int]:
        """flat position -> (1-based chrom, chrom-local 0-based loc)."""
        c = int(np.searchsorted(self.chrom_offsets, flat_pos,
                                side="right")) - 1
        c = max(0, min(c, len(self.chrom_offsets) - 2))
        return c + 1, flat_pos - int(self.chrom_offsets[c])

    # ---- main entry ----
    def map_batch(self, batch: ReadBatch) -> List[MappedRead]:
        B = batch.size
        results = [MappedRead() for _ in range(B)]
        lens = np.unique(batch.lengths)
        if (self.device_quickmap and len(lens) == 1
                and int(lens[0]) >= self.index.k):
            self._map_batch_device(batch, int(lens[0]), results)
            return results
        if self.quickmap_factory is not None:
            # cross-host sharded index: the host per-length fallback
            # seeds against the LOCAL CSR block only — mixed-length
            # batches must be length-bucketed upstream
            raise RuntimeError(
                "cross-host sharded index requires uniform-length "
                "read batches (got lengths "
                f"{sorted(set(int(x) for x in lens))[:5]})")
        by_len: Dict[int, List[int]] = {}
        for i in range(B):
            L = int(batch.lengths[i])
            if L >= self.index.k:
                by_len.setdefault(L, []).append(i)
        for L, idxs in sorted(by_len.items()):
            self._map_group(batch, L, np.asarray(idxs, np.int64), results)
        return results

    # ---- device quickmap fast path ----
    def _qm_dispatch(self, batch: ReadBatch, L: int):
        """Launch the device quickmap without blocking — the returned
        handle's .host() transfers the packed results (two arrays). Used
        by map_stream to overlap host finalize of batch N with device
        compute of batch N+1 (reference's producer/consumer overlap,
        stream/ConcurrentGenericReadInputStream.java:122-166)."""
        from . import quickmap_device
        if L not in self._qm_cache:
            if self.quickmap_factory is not None:
                self._qm_cache[L] = self.quickmap_factory(L)
            elif self.mesh is not None:
                from ..parallel import sharded
                if self._sharded_index is None:
                    self._sharded_index = sharded.shard_index(
                        self.index, self.mesh.shape["index"])
                self._qm_cache[L] = sharded.build_sharded_quickmap(
                    self.mesh, self.index, self._sharded_index, L,
                    chain_dist=self.chain_dist,
                    min_ratio=self.min_ratio, profile=self.profile)
            else:
                self._qm_cache[L] = quickmap_device.build_quickmap(
                    self.dindex, L, chain_dist=self.chain_dist,
                    min_ratio=self.min_ratio, profile=self.profile)
        if batch.quality is not None and (self.mesh is None
                                          or self.mesh_quality):
            return self._qm_cache[L](batch.bases[:, :L],
                                     batch.quality[:, :L])
        return self._qm_cache[L](batch.bases[:, :L])

    def _qm_run(self, batch: ReadBatch, L: int):
        return self._qm_dispatch(batch, L).host()

    # ---- fused single-dispatch path (quickmap + escalation + trace in
    # one device program; align/fused_device.py) ----
    # the fused single-dispatch programs are sized for the SHORT-read
    # stack (reference envelope: ALIGN_ROWS=601, BBMapThread.java:28);
    # a 6 kbp PacBio batch blows the 128 MB VMEM budget in the fused
    # finalize/quality stages — long reads take the unfused quickmap +
    # host escalation path (the reference's separate PacBio stack).
    FUSED_MAX_L = 600

    def _use_fused(self, L: Optional[int] = None) -> bool:
        return (self.device_quickmap and self.mesh is None
                and self.maxindel > 0 and not self.print_secondary
                and (L is None or L <= self.FUSED_MAX_L))

    def _fused_dispatch(self, batch: ReadBatch, L: int):
        from . import fused_device
        key = (L, batch.size)
        run = self._fused_cache.get(key)
        if run is None:
            run = fused_device.build_fused(
                self.dindex, L, batch.size, chain_dist=self.chain_dist,
                min_ratio=self.min_ratio, profile=self.profile)
            self._fused_cache[key] = run
        if batch.quality is not None:
            return run(batch.bases, batch.quality)
        return run(batch.bases)

    def _direct_select(self, L: int, d: dict, direct: np.ndarray,
                       scored: Optional[np.ndarray] = None,
                       second: Optional[np.ndarray] = None):
        """Vectorized selection for reads settled by the device quickmap
        (gapless winners). `scored`/`second` override raw scores for
        pair-boosted selection. Returns a dict of per-read columns."""
        best = d["best_score"].astype(np.int64)
        eff = best if scored is None else scored
        snd = d["second_score"].astype(np.int64) if second is None \
            else second
        max_sw = self.profile.max_quality(L)
        min_score = int(max_sw * self.min_ratio)
        if scored is not None:
            # paired path: boosted sites use the relaxed paired ratio
            # (reference: AbstractMapThread.java:106,
            # removeLowQualitySitesPaired)
            ratio_paired = max(self.min_ratio * 0.80,
                               1 - (1 - self.min_ratio) * 1.4)
            min_paired = int(max_sw * ratio_paired)
            mapped = direct & np.where(eff > best, best >= min_paired,
                                       best >= min_score)
        else:
            mapped = direct & (best >= min_score)
        perfect = best >= max_sw
        cz = self._czvec(eff, max_sw, perfect)
        ambiguous = (snd > -(2 ** 29)) & (eff - snd < cz)
        diags = d["best_diag"].astype(np.int64)
        chroms = np.clip(np.searchsorted(self.chrom_offsets, diags,
                                         side="right") - 1,
                         0, len(self.chrom_offsets) - 2)
        locs = diags - self.chrom_offsets[chroms]
        return dict(mapped=mapped, eff=eff, perfect=perfect,
                    ambiguous=ambiguous, chroms=chroms, locs=locs,
                    min_score=min_score)

    def _stale_match_rows(self, d: dict, rows: np.ndarray,
                          L: int) -> np.ndarray:
        """Recompute m/S/N match rows on host for reads whose pair-boost
        re-pick changed the best site (the device match block covers the
        device-selected best only)."""
        from ..core.bases import COMP_ASCII
        from . import gapless
        diags = d["best_diag"][rows].astype(np.int64)
        refs = gapless.gather_ref_rows(self.codes_ascii, diags, L)
        sub = d["_bases"][rows][:, :L]
        rc = COMP_ASCII[sub][:, ::-1]
        strands = d["best_strand"][rows]
        reads = np.where((strands == 0)[:, None], sub, rc)
        return gapless.gen_match_no_indels_batch(reads, refs)

    def _direct_fill_columnar(self, batch: ReadBatch, L: int, d: dict,
                              mb: MappedBatch, direct: np.ndarray,
                              scored: Optional[np.ndarray] = None,
                              second: Optional[np.ndarray] = None) -> None:
        sel = self._direct_select(L, d, direct, scored, second)
        mapped = sel["mapped"]
        toss = self.ambig_mode == "toss"
        keep = mapped & ~(sel["ambiguous"] & toss) if toss else mapped
        mb.score[mapped] = sel["eff"][mapped]
        mb.perfect[mapped] = sel["perfect"][mapped]
        mb.ambiguous[mapped] = sel["ambiguous"][mapped]
        mb.n_sites[mapped] = d["n_good"][mapped]
        mb.mapped[keep] = True
        mb.strand[keep] = d["best_strand"][keep]
        mb.chrom[keep] = sel["chroms"][keep] + 1
        mb.start[keep] = sel["locs"][keep]
        mb.stop[keep] = sel["locs"][keep] + L - 1
        if "best_match" in d:
            if mb.match_rows is None:
                mb.match_rows = d["best_match"]
            mb.match_is_row |= keep
        else:
            # fused path: match rows are not shipped over the link —
            # recompute the kept winners' gapless m/S/N rows from the
            # genome, LAZILY (throughput consumers never ask)
            if mb.match_rows is None:
                mb.match_rows = np.zeros((mb.size, L), np.uint8)
            mrows = mb.match_rows
            rows = np.nonzero(keep)[0]
            if len(rows):
                d.setdefault("_bases", batch.bases)

                def _fill(rows=rows, d=d, mrows=mrows):
                    mrows[rows] = self._stale_match_rows(d, rows, L)
                mb.match_fill.append(_fill)
            mb.match_is_row |= keep
        stale = d.get("match_stale")
        if stale is not None:
            rows = np.nonzero(keep & stale)[0]
            if len(rows):
                d.setdefault("_bases", batch.bases)
                mb.match_rows = np.array(mb.match_rows)  # own the buffer
                mb.match_rows[rows] = self._stale_match_rows(d, rows, L)
        return mapped

    def _direct_fill(self, batch: ReadBatch, L: int, d: dict,
                     results: List[MappedRead], direct: np.ndarray,
                     scored: Optional[np.ndarray] = None,
                     second: Optional[np.ndarray] = None) -> None:
        """Object-path wrapper over the columnar fill (compat for the
        paired path and tools that consume MappedRead objects)."""
        mb = MappedBatch(len(results), L)
        d.setdefault("_bases", batch.bases)
        mapped = self._direct_fill_columnar(batch, L, d, mb, direct,
                                            scored, second)
        sel_mapped = np.nonzero(mapped)[0]
        sec_data = None
        if self.print_secondary:
            max_sw = self.profile.max_quality(L)
            min_score = int(max_sw * self.min_ratio)
            sec_data = (d["cand_scores"], d["cand_diag"],
                        d["cand_strand"], min_score)
        for i in sel_mapped:
            res = results[i]
            res.score = int(mb.score[i])
            res.perfect = bool(mb.perfect[i])
            res.ambiguous = bool(mb.ambiguous[i])
            res.n_sites = int(mb.n_sites[i])
            if sec_data is not None:
                scs, dgs, sts, min_score = sec_data
                secs = []
                for c in range(1, min(self.max_sites + 1,
                                      scs.shape[1])):
                    sc_c = int(scs[i, c])
                    if sc_c < min_score:
                        break
                    dd = int(dgs[i, c])
                    ch = int(np.clip(np.searchsorted(
                        self.chrom_offsets, dd, side="right") - 1, 0,
                        len(self.chrom_offsets) - 2))
                    lc = dd - int(self.chrom_offsets[ch])
                    secs.append((ch + 1, lc, lc + L - 1,
                                 int(sts[i, c]), sc_c, None))
                if secs:
                    res.secondary = secs
            if mb.mapped[i]:
                res.mapped = True
                res.strand = int(mb.strand[i])
                res.match = mb.match(i)
                res.chrom = int(mb.chrom[i])
                res.start = int(mb.start[i])
                res.stop = int(mb.stop[i])

    def map_batch_columnar(self, batch: ReadBatch
                           ) -> Optional[MappedBatch]:
        """Columnar fast path: uniform-length batch through the device
        quickmap, results as struct-of-arrays (no per-read objects).
        Returns None when the batch can't take the device path."""
        lens = np.unique(batch.lengths)
        if not (self.device_quickmap and len(lens) == 1
                and int(lens[0]) >= self.index.k):
            return None
        L = int(lens[0])
        if self._use_fused(L):
            f = self._fused_dispatch(batch, L)
            return self._columnar_from_fused(batch, L, f.host())
        d = self._qm_run(batch, L)
        return self._columnar_from_qm(batch, L, d)

    def _columnar_from_qm(self, batch: ReadBatch, L: int,
                          d: dict) -> MappedBatch:
        B = batch.size
        mb = MappedBatch(B, L)
        max_imp = self.profile.max_imperfect_score(L)
        best = d["best_score"].astype(np.int64)
        escalate = best < max_imp if self.maxindel > 0 \
            else np.zeros(len(best), bool)
        d.setdefault("_bases", batch.bases)
        self._direct_fill_columnar(batch, L, d, mb, ~escalate)
        idxs = np.nonzero(escalate)[0]
        if len(idxs):
            self._escalate_columnar(batch, L, idxs.astype(np.int64), d,
                                    mb)
        return mb

    def _columnar_from_fused(self, batch: ReadBatch, L: int,
                             d: dict) -> MappedBatch:
        """Assemble a MappedBatch from the fused single-dispatch program
        (align/fused_device.py). Applies the same selection semantics as
        ``_escalate_columnar`` — the device already ran the DP and
        traceback; the host computes clearzone ambiguity (float64, like
        the unfused path) and fills columns. Rows the device could not
        settle exactly (escalation/trace budget overflow, wide windows)
        re-run through the unfused path on a padded sub-batch."""
        B = batch.size
        mb = MappedBatch(B, L)
        max_imp = self.profile.max_imperfect_score(L)
        best0 = d["best_score"].astype(np.int64)
        escalate = best0 < max_imp
        d.setdefault("_bases", batch.bases)
        self._direct_fill_columnar(batch, L, d, mb, ~escalate)
        E = len(d["_esc"]["idx"])
        over = np.nonzero(escalate)[0][E:]           # esc budget overflow
        fallback, applied = self._apply_fused_esc(batch, L, d, mb, over)
        # two-tier slot-budget overflow rows: candidates were truncated
        # in-device — whole-row exact refit (quickmap_device
        # candidate_stage two_tier contract)
        hi = np.nonzero(d["hi_over"])[0] if "hi_over" in d else \
            np.zeros(0, np.int64)
        if len(hi):
            fallback = np.union1d(fallback, hi).astype(np.int64)
            applied = applied[~d["hi_over"][applied]]
        if len(fallback):
            self._refit_rows(batch, L, fallback, mb)
        # long-indel tail only on rows the device flagged plausible
        # (li_plaus: a stitched wide chain exists in the candidate
        # table) — the pass was re-seeding EVERY unmapped row before
        still = applied[~mb.mapped[applied]
                        & d["li_plaus"][applied]]
        if self.maxindel > self.chain_dist and len(still):
            proxy = _ResultsProxy()
            self._long_indel_pass(batch, L, still.astype(np.int64),
                                  proxy)
            if proxy.store:
                mb.absorb_objects(proxy.store)
        return mb

    def _apply_fused_esc(self, batch: ReadBatch, L: int, d: dict,
                         mb: MappedBatch, overflow_rows: np.ndarray,
                         paired: bool = False):
        """Apply a fused dispatch's escalation + trace blocks to ``mb``.
        ``overflow_rows``: escalated rows that did not fit the device
        budget (caller computes — pair and single compaction differ).
        Returns (fallback_rows, applied_rows). ``paired``: the device
        best is the pair-BOOSTED winner score; mapping then follows the
        host paired retention rule (raw winner score vs the relaxed
        paired ratio when the boost decided the winner —
        pipeline._direct_select, reference: AbstractMapThread.java:106)."""
        esc = d["_esc"]
        tr = d["_trace"]
        eidx = esc["idx"].astype(np.int64)
        valid = eidx < 2 ** 30
        E = len(eidx)

        fallback = []
        if len(overflow_rows):
            fallback.append(overflow_rows)
        fb = esc["fb"].astype(bool) & valid
        # fallback-rate visibility (ADVICE r4: the NARROW_SPREAD 64->16
        # change routes mid-spread jobs to the fixed wide-lane budgets;
        # on a repetitive genome wide_over/wide_trace_over could
        # silently saturate and push whole rows to the host refit —
        # track the rate so the cliff is observable, not silent)
        self._n_esc_rows += int(valid.sum())
        self._n_fallback_rows += int(fb.sum()) + len(overflow_rows)
        if fb.any():
            fallback.append(eidx[fb])

        app = valid & ~fb                            # esc rows applied
        besta = esc["best"].astype(np.int64)
        seconda = esc["second"].astype(np.int64)
        max_sw = self.profile.max_quality(L)
        min_score = int(max_sw * self.min_ratio)
        if paired:
            raweff = esc["raweff"].astype(np.int64)
            ratio_paired = max(self.min_ratio * 0.80,
                               1 - (1 - self.min_ratio) * 1.4)
            min_paired = int(max_sw * ratio_paired)
            mapped = app & np.where(besta > raweff,
                                    raweff >= min_paired,
                                    raweff >= min_score)
            # perfection is a property of the RAW alignment, not the
            # boosted selection value (a boost past max_sw must not
            # fake NM:i:0 / perfect)
            perfect = raweff >= max_sw
        else:
            mapped = app & (besta >= min_score)
            perfect = besta >= max_sw
        cz = self._czvec(besta, max_sw, perfect)
        ambiguous = (seconda > -(2 ** 29)) & (besta - seconda < cz)
        toss = self.ambig_mode == "toss"
        keep = mapped & ~(ambiguous & toss) if toss else mapped
        rows_m = eidx[mapped]
        mb.score[rows_m] = besta[mapped]
        mb.perfect[rows_m] = perfect[mapped]
        mb.ambiguous[rows_m] = ambiguous[mapped]
        mb.n_sites[rows_m] = esc["n_sites"][mapped]

        dp_beat = esc["dp_beat"]
        needs = mapped & dp_beat                     # device trace gate
        tloc = tr["tloc"].astype(np.int64)
        t_valid = tloc < 2 ** 30
        got_trace = np.zeros(E, bool)
        got_trace[tloc[t_valid]] = True
        t_over = needs & ~got_trace                  # trace overflow
        if t_over.any():
            fallback.append(eidx[t_over])
            app = app & ~t_over
            keep = keep & ~t_over

        gl = keep & ~dp_beat
        if gl.any():
            from ..core.bases import COMP_ASCII
            from . import gapless
            gdiag = esc["wdiag"][gl].astype(np.int64)
            chroms = np.clip(np.searchsorted(self.chrom_offsets, gdiag,
                                             side="right") - 1,
                             0, len(self.chrom_offsets) - 2)
            locs = gdiag - self.chrom_offsets[chroms]
            rows = eidx[gl]
            mb.mapped[rows] = True
            mb.strand[rows] = esc["wstrand"][gl]
            mb.chrom[rows] = chroms + 1
            mb.start[rows] = locs
            mb.stop[rows] = locs + L - 1
            mb.match_is_row[rows] = True
            # winner gapless match recomputed host-side, lazily
            if mb.match_rows is None:
                mb.match_rows = np.zeros((mb.size, L), np.uint8)
            mrows = mb.match_rows
            wstrand_gl = esc["wstrand"][gl].copy()
            bases_rows = batch.bases[rows][:, :L]

            def _fill_gl(rows=rows, gdiag=gdiag, mrows=mrows,
                         wstrand=wstrand_gl, sub=bases_rows):
                refs = gapless.gather_ref_rows(self.codes_ascii,
                                               gdiag, L)
                rc = COMP_ASCII[sub][:, ::-1]
                reads = np.where((wstrand == 1)[:, None], rc, sub)
                mrows[rows] = gapless.gen_match_no_indels_batch(
                    reads, refs)
            mb.match_fill.append(_fill_gl)

        tsel = t_valid & keep[np.clip(tloc, 0, E - 1)] \
            & ~t_over[np.clip(tloc, 0, E - 1)]
        if tsel.any():
            from ..core.bases import COMP_ASCII
            erow = tloc[tsel]
            rows_g = eidx[erow]
            wstrand = esc["wstrand"][erow]
            sub = batch.bases[rows_g][:, :L]
            rc = COMP_ASCII[sub][:, ::-1]
            treads = np.where((wstrand == 0)[:, None], sub, rc)
            tws = tr["tws"][tsel].astype(np.int32)
            # device already re-traced wide winners and clipped rows at
            # the wide width; passing retried as `twide` suppresses a
            # second host-side retry for them
            self._apply_traces(
                None, mb, rows_g, treads, tws,
                tr["retried"][tsel].astype(bool), wstrand,
                tr["sym"][tsel], tr["ln"][tsel].astype(np.int32),
                tr["gaps"][tsel].astype(np.int32),
                tr["sc2"][tsel].astype(np.int64),
                tr["col"][tsel].astype(np.int32), L)

        if fallback:
            fb_rows = np.unique(np.concatenate(fallback)).astype(np.int64)
        else:
            fb_rows = np.zeros(0, np.int64)
        return fb_rows, eidx[app]

    def _refit_rows(self, batch: ReadBatch, L: int, rows: np.ndarray,
                    mb: MappedBatch) -> None:
        """Re-map a handful of rows through the unfused quickmap +
        host escalation path (budget-overflow / wide-window fallback of
        the fused program) and merge the results into ``mb``."""
        n = len(rows)
        P = _bucket_pad(n)
        bases = np.full((P, batch.bases.shape[1]), ord("N"), np.uint8)
        bases[:n] = batch.bases[rows]
        qual = None
        if batch.quality is not None:
            qual = np.zeros((P, batch.quality.shape[1]), np.int8)
            qual[:n] = batch.quality[rows]
        sub = ReadBatch(
            bases=bases, quality=qual,
            lengths=np.full(P, L, np.int32),
            ids=[batch.ids[int(r)] for r in rows] + [""] * (P - n),
            numeric_ids=np.arange(P, dtype=np.int64))
        d = self._qm_run(sub, L)
        smb = self._columnar_from_qm(sub, L, d)
        for f in ("mapped", "strand", "chrom", "start", "stop", "score",
                  "perfect", "ambiguous", "n_sites"):
            getattr(mb, f)[rows] = getattr(smb, f)[:n]
        # matches merge via UNCONDITIONAL override (same contract as
        # _refit_pairs): deferred match_fill lambdas appended before the
        # refit captured these rows and would overwrite
        # mb.match_rows[row] with a stale gapless row at materialize
        # time (ADVICE r4 high) — an override always wins in match().
        mb.match_is_row[rows] = False
        for i, r in enumerate(rows):
            mb.match_override[int(r)] = smb.match(i)

    def _esc_programs(self, L: int):
        if L not in self._esc_cache:
            from . import escalate_device
            self._esc_cache[L] = escalate_device.make_programs(
                L, self.dindex, self.profile)
        return self._esc_cache[L]

    def _escalate_columnar(self, batch: ReadBatch, L: int,
                           idxs: np.ndarray, d: dict,
                           mb: MappedBatch) -> None:
        """Vectorized device escalation (VERDICT r1 next-step #1): score
        the top-4 candidates of every escalated read with the fixed-shape
        device DP (reference windows gathered in HBM — nothing but reads
        and window starts cross the host link), select winners with the
        clearzone model, and run fill+traceback only for winners whose DP
        beat their gapless alignment (reference:
        align2/BBMapThread.scoreSlow:252-345 scores all retained sites,
        traceback :309-345 runs on kept sites only)."""
        from ..core.bases import COMP_ASCII
        from . import escalate_device as esc
        from . import gapless

        n = len(idxs)
        # DP the top-2 gapless candidates; lower candidates keep their
        # gapless scores in the selection/ambiguity competition below
        # (the reference's pre-DP site pruning, removeLowQualitySites)
        top = 2
        progs = self._esc_programs(L)
        scs_all = d["cand_scores"][idxs]
        ord_all = np.argsort(-scs_all, axis=1, kind="stable")
        ordc = ord_all[:, :top]
        take = lambda a: np.take_along_axis(a[idxs], ordc, axis=1)
        g_sc = take(d["cand_scores"]).astype(np.int64)       # (n, top)
        diag = take(d["cand_diag"]).astype(np.int64)
        strand = take(d["cand_strand"]).astype(np.int8)
        start = take(d["cand_start"]).astype(np.int64)
        spread = take(d["cand_spread"]).astype(np.int64)
        valid = g_sc > -(2 ** 29)
        wstart = start - SLOW_ALIGN_PADDING
        wide = spread > esc.NARROW_SPREAD

        sub = batch.bases[idxs][:, :L]
        rc = COMP_ASCII[sub][:, ::-1]
        reads_j = np.where((strand == 0)[..., None], sub[:, None, :],
                           rc[:, None, :])                    # (n, top, L)

        # score both candidates first, trace only winners whose DP beat
        # their gapless alignment — a speculative trace-the-top-1 variant
        # was measured SLOWER (trace ≈ 3x a score-only fill, and ~35% of
        # escalated winners settle gapless, so tracing all top-1s costs
        # more than the extra round trip saves)
        jsel = np.nonzero(valid.ravel())[0]
        sc_dp = np.full(n * top, -(2 ** 30), np.int64)
        if len(jsel):
            sc_dp[jsel] = esc.score_jobs(
                progs, reads_j.reshape(n * top, L)[jsel],
                wstart.ravel()[jsel].astype(np.int32),
                wide.ravel()[jsel])
        sc_dp = sc_dp.reshape(n, top)

        # selection with clearzone ambiguity (reference:
        # align2/BBMapThread.java:500-560)
        eff = np.maximum(g_sc, sc_dp)
        ord2 = np.argsort(-eff, axis=1, kind="stable")
        ar = np.arange(n)
        w0 = ord2[:, 0]
        best = eff[ar, w0]
        second = eff[ar, ord2[:, 1]]
        # non-DP'd candidates compete with their gapless scores
        rest = np.take_along_axis(scs_all, ord_all[:, top:],
                                  axis=1).astype(np.int64)
        rest_best = rest.max(axis=1) if rest.shape[1] else \
            np.full(n, -(2 ** 30), np.int64)
        second = np.maximum(second, rest_best)
        max_sw = self.profile.max_quality(L)
        min_score = int(max_sw * self.min_ratio)
        mapped = best >= min_score
        perfect = best >= max_sw
        cz = self._czvec(best, max_sw, perfect)
        ambiguous = (second > -(2 ** 29)) & (best - second < cz)
        n_sites = ((eff >= min_score).sum(axis=1)
                   + (rest >= min_score).sum(axis=1)).astype(np.int32)
        toss = self.ambig_mode == "toss"
        keep = mapped & ~(ambiguous & toss) if toss else mapped

        rows_m = idxs[mapped]
        mb.score[rows_m] = best[mapped]
        mb.perfect[rows_m] = perfect[mapped]
        mb.ambiguous[rows_m] = ambiguous[mapped]
        mb.n_sites[rows_m] = n_sites[mapped]

        wdiag = diag[ar, w0]
        wstrand = strand[ar, w0]
        wws = wstart[ar, w0]
        wwide = wide[ar, w0]
        needs_trace = keep & (sc_dp[ar, w0] > g_sc[ar, w0])

        # gapless winners: coordinates at the modal diagonal; match rows
        # come from the device block when the winner IS the device-picked
        # best, else a vectorized host recompute
        gl = keep & ~needs_trace
        if gl.any():
            gdiag = wdiag[gl]
            chroms = np.clip(np.searchsorted(self.chrom_offsets, gdiag,
                                             side="right") - 1,
                             0, len(self.chrom_offsets) - 2)
            locs = gdiag - self.chrom_offsets[chroms]
            rows = idxs[gl]
            mb.mapped[rows] = True
            mb.strand[rows] = wstrand[gl]
            mb.chrom[rows] = chroms + 1
            mb.start[rows] = locs
            mb.stop[rows] = locs + L - 1
            same = (wdiag == d["best_diag"][idxs].astype(np.int64)) \
                & (wstrand == d["best_strand"][idxs])
            mb.match_is_row[rows] = True
            stale = gl & ~same
            if stale.any():
                srows = idxs[stale]
                refs = gapless.gather_ref_rows(self.codes_ascii,
                                               wdiag[stale], L)
                reads_s = reads_j[ar[stale], w0[stale]]
                if mb.match_rows is None:
                    mb.match_rows = np.zeros((mb.size, L), np.uint8)
                else:
                    mb.match_rows = np.array(mb.match_rows)
                mb.match_rows[srows] = gapless.gen_match_no_indels_batch(
                    reads_s, refs)

        if needs_trace.any():
            treads = reads_j[ar[needs_trace], w0[needs_trace]]
            tws = wws[needs_trace].astype(np.int32)
            twide = wwide[needs_trace]
            sym, ln, gaps, sc2, col = esc.trace_jobs(progs, treads, tws,
                                                     twide)
            self._apply_traces(progs, mb, idxs[needs_trace], treads,
                               tws, twide, wstrand[needs_trace],
                               sym, ln, gaps, sc2, col, L)

        still = idxs[~mb.mapped[idxs]]
        if self.maxindel > self.chain_dist and len(still):
            proxy = _ResultsProxy()
            self._long_indel_pass(batch, L, still.astype(np.int64),
                                  proxy)
            if proxy.store:
                mb.absorb_objects(proxy.store)

    def _apply_traces(self, progs, mb: MappedBatch, rows, treads,
                      tws, twide, wstrand, sym, ln, gaps, sc2, col,
                      L: int) -> None:
        """Apply device fill+traceback results (possibly speculative)
        to the winner rows; one wide-window retry for alignments clipped
        at the window edge (reference:
        align2/AbstractMapThread.java:1012 re-pad on retry).
        `rows` are GLOBAL batch indices; sym/ln/gaps/sc2/col are aligned
        to them."""
        from . import escalate_device as esc

        tws = np.asarray(tws, np.int32).copy()
        first = sym[np.arange(len(rows)),
                    np.maximum(ln - 1, 0)]   # post-reversal first symbol
        last = sym[:, 0]
        clip_l = (first == ord("I")) | (first == ord("X"))
        clip_r = (last == ord("I")) | (last == ord("Y"))
        retry = (clip_l | clip_r) & ~twide
        if retry.any():
            if progs is None:   # fused path: host retry only on device
                progs = self._esc_programs(L)   # RT-budget overflow
            extra = (80 if self.maxindel > 0 else 20) + SLOW_ALIGN_PADDING
            rws = (tws[retry] - np.where(clip_l[retry], extra, 0)) \
                .astype(np.int32)
            rsym, rln, rgaps, rsc, rcol = esc.trace_jobs(
                progs, treads[retry], rws,
                np.ones(int(retry.sum()), bool))
            rr = np.nonzero(retry)[0]
            if rsym.shape[1] > sym.shape[1]:
                # fused-path sym rows are narrow-window width; the wide
                # retry emits wider rows — grow the buffer
                grown = np.zeros((sym.shape[0], rsym.shape[1]), np.uint8)
                grown[:, :sym.shape[1]] = sym
                sym = grown
            else:
                sym = np.array(sym)
            sym[rr, :rsym.shape[1]] = rsym
            ln[rr] = rln
            gaps[rr] = rgaps
            sc2[rr] = rsc
            col[rr] = rcol
            tws[rr] = rws

        # vectorized ref-consumption count over the walked symbols
        pos = np.arange(sym.shape[1])[None, :]
        used = pos < ln[:, None]
        is_refc = ((sym == ord("m")) | (sym == ord("S"))
                   | (sym == ord("D")) | (sym == ord("N"))) & used
        ref_consumed = is_refc.sum(axis=1).astype(np.int64)
        flat_start = tws.astype(np.int64) + col - ref_consumed
        flat_stop = tws.astype(np.int64) + col - 1
        chroms = np.clip(np.searchsorted(self.chrom_offsets, flat_start,
                                         side="right") - 1,
                         0, len(self.chrom_offsets) - 2)
        locs = flat_start - self.chrom_offsets[chroms]
        mb.mapped[rows] = True
        mb.strand[rows] = wstrand
        for t, row in enumerate(rows):
            match = msa.finish_match(sym[t], int(ln[t]), int(gaps[t]))
            if self.local:
                match, pre, post = samio.to_local_alignment(match)
                mb.start[row] = int(locs[t]) + pre
                mb.stop[row] = int(locs[t]) + int(
                    flat_stop[t] - flat_start[t]) - post
            else:
                mb.start[row] = int(locs[t])
                mb.stop[row] = int(locs[t]) + int(
                    flat_stop[t] - flat_start[t])
            mb.chrom[row] = int(chroms[t]) + 1
            mb.score[row] = int(sc2[t])
            mb.match_is_row[row] = False
            mb.match_override[int(row)] = match

    def map_stream(self, batches) -> "Iterator[MappedBatch]":
        """Map an iterator of uniform-length batches with device/host
        overlap: batch N+1's quickmap is dispatched before batch N's
        results are transferred and finalized (the TPU analog of the
        reference's reader/worker thread overlap, SURVEY §2.11 P2)."""
        pending = None   # (batch, L, handle, fin)
        for batch in batches:
            L = int(batch.lengths[0])
            if self._use_fused(L):
                handle = self._fused_dispatch(batch, L)
                fin = self._columnar_from_fused
            else:
                handle = self._qm_dispatch(batch, L)
                fin = self._columnar_from_qm
            if pending is not None:
                pb, pL, ph, pf = pending
                yield pf(pb, pL, ph.host())
            pending = (batch, L, handle, fin)
        if pending is not None:
            pb, pL, ph, pf = pending
            yield pf(pb, pL, ph.host())

    def map_batches_stream(self, batches):
        """Object-result streaming over ReadBatches with dispatch
        overlap (the CLI's unpaired loop; VERDICT r2 weak #7). Uniform-
        length batches ride the fused/quickmap dispatch queue; anything
        else (mixed lengths, secondary-site output) falls back to the
        synchronous map_batch. Yields List[MappedRead] per batch."""
        def finish(item):
            if len(item) == 1:
                return self.map_batch(item[0])
            batch, L, handle, fin = item
            mb = fin(batch, L, handle.host())
            results = [MappedRead() for _ in range(batch.size)]
            mb.fill_objects(results)
            return results

        pending = None
        for batch in batches:
            lens = np.unique(batch.lengths)
            streamable = (self.device_quickmap and len(lens) == 1
                          and int(lens[0]) >= self.index.k
                          and not self.print_secondary)
            if streamable:
                L = int(lens[0])
                if self._use_fused(L):
                    item = (batch, L, self._fused_dispatch(batch, L),
                            self._columnar_from_fused)
                else:
                    item = (batch, L, self._qm_dispatch(batch, L),
                            self._columnar_from_qm)
            else:
                item = (batch,)
            if pending is not None:
                yield finish(pending)
            pending = item
        if pending is not None:
            yield finish(pending)

    def _map_batch_device(self, batch: ReadBatch, L: int,
                          results: List[MappedRead]) -> None:
        if self._use_fused(L):
            f = self._fused_dispatch(batch, L)
            mb = self._columnar_from_fused(batch, L, f.host())
            mb.fill_objects(results)
            return
        d = self._qm_run(batch, L)
        mb = self._columnar_from_qm(batch, L, d)
        mb.fill_objects(results)
        if self.print_secondary:
            # secondary sites need the candidate table (object path only)
            max_sw = self.profile.max_quality(L)
            min_score = int(max_sw * self.min_ratio)
            scs, dgs, sts = (d["cand_scores"], d["cand_diag"],
                             d["cand_strand"])
            for i in np.nonzero(mb.mapped | (mb.score != 0))[0]:
                secs = []
                for c in range(1, min(self.max_sites + 1, scs.shape[1])):
                    sc_c = int(scs[i, c])
                    if sc_c < min_score:
                        break
                    dd = int(dgs[i, c])
                    ch = int(np.clip(np.searchsorted(
                        self.chrom_offsets, dd, side="right") - 1, 0,
                        len(self.chrom_offsets) - 2))
                    lc = dd - int(self.chrom_offsets[ch])
                    secs.append((ch + 1, lc, lc + L - 1,
                                 int(sts[i, c]), sc_c, None))
                if secs:
                    results[i].secondary = secs

    def _cs_from_device(self, d: dict, idxs: np.ndarray, L: int,
                        top: int = 4):
        """Rebuild a host CandidateSet from the device quickmap's fixed
        candidate table, restricted to the escalated reads — avoids
        re-seeding those reads on the host. Only the top `top` candidates
        per read (by gapless score) are slow-aligned — the reference's
        low-quality site pruning before slow alignment (reference:
        align2/BBMapThread.scoreSlow minMsaLimit cutoffs,
        AbstractMapThread.removeLowQualitySites)."""
        scs = d["cand_scores"][idxs]          # (n, C)
        valid = scs > -(2 ** 29)
        if top is not None and top < scs.shape[1]:
            kth = -np.partition(-scs, top - 1, axis=1)[:, top - 1:top]
            valid &= scs >= kth
        n_read, n_c = valid.shape
        rloc = np.repeat(np.arange(n_read), n_c).reshape(n_read, n_c)
        sel = valid.ravel()
        if not sel.any():
            return None, None
        read_idx = rloc.ravel()[sel].astype(np.int32)
        start = d["cand_start"][idxs].ravel()[sel].astype(np.int64)
        spread = d["cand_spread"][idxs].ravel()[sel].astype(np.int32)
        cs = seed.CandidateSet(
            read_idx=read_idx,
            strand=d["cand_strand"][idxs].ravel()[sel].astype(np.int8),
            start=start,
            stop=start + spread + L - 1,
            votes=np.full(sel.sum(), 2, np.int32),
            spread=spread,
            best_diag=d["cand_diag"][idxs].ravel()[sel].astype(np.int64))
        slow = scs.ravel()[sel].astype(np.int64)
        return cs, slow

    def _g_from_device(self, batch: ReadBatch, L: int, idxs: np.ndarray,
                       d: dict) -> Optional[dict]:
        """Group-scoring dict for escalated reads built from the device
        quickmap candidates (seeding + gapless already done on device)."""
        from ..core.bases import COMP_ASCII

        cs, _gapless_scores = self._cs_from_device(d, idxs, L)
        if cs is None:
            return None
        sub = batch.bases[idxs][:, :L]
        rc_sub = COMP_ASCII[sub][:, ::-1]
        cand_reads = np.where(cs.strand[:, None] == 0,
                              sub[cs.read_idx], rc_sub[cs.read_idx])
        n = len(cs)
        needs_dp = np.ones(n, bool)  # all escalated candidates are < maxImp
        wstart = cs.start - SLOW_ALIGN_PADDING
        # chains wider than the escalation window cap fall through to the
        # gap-compressed long-indel pass; clamping keeps the DP shape set
        # small (one or two compiled buckets per run)
        spread_c = np.minimum(_round_up_vec(cs.spread, 64), 448)
        wlen = np.full(n, L + 2 * SLOW_ALIGN_PADDING, np.int64) + spread_c
        # candidates are scored with the cheaper score-only DP; winners
        # are re-filled with traceback in _finalize_winners
        dp_scores = self._dp_score(cand_reads, wstart, wlen,
                                   np.arange(n), L, None,
                                   score_only=True)
        return dict(cs=cs, slow=dp_scores, needs_dp=needs_dp,
                    wstart=wstart, wlen=wlen, cand_reads=cand_reads,
                    refs_g=np.zeros((0, L), np.uint8), idxs=idxs, L=L,
                    dp_cache=None)

    def _escalate_from_device(self, batch: ReadBatch, L: int,
                              idxs: np.ndarray, d: dict,
                              results: List[MappedRead]) -> None:
        g = self._g_from_device(batch, L, idxs, d)
        if g is not None:
            winners = self._select_group(g, results, None, paired=False)
            self._finalize_winners(g["cand_reads"], g["refs_g"], g["cs"],
                                   winners, results, L, g["dp_cache"])
        if self.maxindel > self.chain_dist:
            still = np.array([i for i in idxs if not results[i].mapped],
                             np.int64)
            if len(still):
                self._long_indel_pass(batch, L, still, results)

    def map_pairs(self, b1: ReadBatch, b2: ReadBatch
                  ) -> Tuple[List[MappedRead], List[MappedRead]]:
        """Pair-aware mapping: candidate sites of both mates boost each
        other before selection (reference: AbstractMapThread
        pairSiteScoresFinal:1919-2100), and proper-pair flags follow
        canPair on the top sites (reference: BBMapThread.java:1188-1200).
        Rescue (quickRescue) is a later milestone."""
        B = b1.size
        res1 = [MappedRead() for _ in range(B)]
        res2 = [MappedRead() for _ in range(B)]
        mbs = self.map_pairs_columnar(b1, b2)
        if mbs is not None:
            mbs[0].fill_objects(res1)
            mbs[1].fill_objects(res2)
            return res1, res2
        l1 = np.unique(b1.lengths)
        l2 = np.unique(b2.lengths)
        if len(l1) != 1 or len(l2) != 1:
            return self.map_batch(b1), self.map_batch(b2)
        L1, L2 = int(l1[0]), int(l2[0])
        if self.device_quickmap and L1 >= self.index.k \
                and L2 >= self.index.k:
            return self._map_pairs_device(b1, b2, L1, L2, res1, res2)
        idxs = np.arange(B, dtype=np.int64)
        g1 = self._score_candidates(b1, L1, idxs)
        g2 = self._score_candidates(b2, L2, idxs)
        boost1 = boost2 = None
        if g1 is not None and g2 is not None:
            boost1, boost2 = self._pair_boost(g1, g2)
        w1 = self._select_group(g1, res1, boost1, paired=True) \
            if g1 is not None else []
        w2 = self._select_group(g2, res2, boost2, paired=True) \
            if g2 is not None else []
        if g1 is not None:
            self._finalize_winners(g1["cand_reads"], g1["refs_g"],
                                   g1["cs"], w1, res1, L1,
                                   g1.get("dp_cache"))
        if g2 is not None:
            self._finalize_winners(g2["cand_reads"], g2["refs_g"],
                                   g2["cs"], w2, res2, L2,
                                   g2.get("dp_cache"))
        self._rescue(b1, b2, L1, L2, res1, res2)
        self._set_pair_flags(res1, res2, L1, L2)
        return res1, res2

    def _pair_boost_fixed(self, d1: dict, d2: dict, L1: int, L2: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """pairSiteScoresFinal over the fixed (B, C, C) candidate cross
        (device quickmap path). Same formula as _pair_boost."""
        s1 = d1["cand_scores"].astype(np.int64)
        s2 = d2["cand_scores"].astype(np.int64)
        v1 = s1 > -(2 ** 29)
        v2 = s2 > -(2 ** 29)
        # contributor-positivity guard (see pair_boost_device note)
        c1 = s1 > 0
        c2 = s2 > 0
        a_start = d1["cand_start"].astype(np.int64)
        a_stop = a_start + d1["cand_spread"] + L1 - 1
        b_start = d2["cand_start"].astype(np.int64)
        b_stop = b_start + d2["cand_spread"] + L2 - 1
        st1 = d1["cand_strand"]
        st2 = d2["cand_strand"]
        ch1 = np.searchsorted(self.chrom_offsets, a_start, "right")
        ch2 = np.searchsorted(self.chrom_offsets, b_start, "right")
        A = lambda x: x[:, :, None]
        Bx = lambda x: x[:, None, :]
        opp = A(st1) != Bx(st2)
        inner = np.where(A(st1) == 0, Bx(b_start) - A(a_stop),
                         A(a_start) - Bx(b_stop))
        outer = np.where(A(st1) == 0, Bx(b_stop) - A(a_start),
                         A(a_stop) - Bx(b_start))
        outer_limit = (max(L1, L2) * OUTER_DIST_MULT) // OUTER_DIST_DIV
        okg = (A(v1) & Bx(v2) & opp & (A(ch1) == Bx(ch2))
               & (outer >= outer_limit) & (inner <= MAX_PAIR_DIST))
        ok = okg
        apd = int(self.average_pair_dist)
        expected_frag = apd + L1 + L2
        # deviation cap mirrors fused_device.pair_boost_device (int32
        # overflow guard there; value-preserving for positive mate
        # scores — see DEV_CAP note there)
        from .fused_device import DEV_CAP
        deviation = np.minimum(np.abs(apd - np.where(ok, inner, 0)),
                               DEV_CAP)
        mult1 = min(0.5, max(0.25, L1 / (4.0 * L2)))
        mult2 = min(0.5, max(0.25, L2 / (4.0 * L1)))
        denom = max(100, 10 * expected_frag + 100)
        p1 = A(s1) + 1 + np.maximum(
            1, (Bx(s2) * mult1).astype(np.int64)
            - (deviation * Bx(s2)) // denom)
        p2 = Bx(s2) + 1 + np.maximum(
            1, (A(s1) * mult2).astype(np.int64)
            - (deviation * A(s1)) // denom)
        neg = np.int64(-(2 ** 30))
        boost1 = np.where(okg & Bx(c2), p1, neg).max(axis=2)
        boost2 = np.where(okg & A(c1), p2, neg).max(axis=1)
        return (np.maximum(boost1, neg), np.maximum(boost2, neg))

    @staticmethod
    def _repick(d: dict, scored: np.ndarray) -> Tuple[dict, np.ndarray,
                                                      np.ndarray]:
        """Re-select best/second candidate slots after pair boosting."""
        order = np.argsort(-scored, axis=1, kind="stable")
        o0 = order[:, 0:1]
        o1 = order[:, 1:2]
        take = lambda a, o: np.take_along_axis(a, o, axis=1)[:, 0]
        new = dict(d)
        new["best_score"] = take(d["cand_scores"], o0)
        new["best_diag"] = take(d["cand_diag"], o0)
        new["best_strand"] = take(d["cand_strand"], o0)
        new["best_start"] = take(d["cand_start"], o0)
        new["best_spread"] = take(d["cand_spread"], o0)
        # the device match block covers the device-selected best site;
        # rows whose winner changed need a host match recompute
        new["match_stale"] = (
            (new["best_diag"] != d["best_diag"])
            | (new["best_strand"] != d["best_strand"]))
        return new, take(scored, o0), take(scored, o1)

    def map_pairs_stream(self, pairs):
        """Pair-aware streaming: batch N+1's two quickmap dispatches go
        to the device before batch N's results transfer and finalize
        (the paired analog of map_stream; VERDICT r2 weak #7 — the CLI
        loop uses this). ``pairs`` yields (b1, b2); yields (res1, res2)
        lists in order."""
        pending = None
        for b1, b2 in pairs:
            Lp = self._can_pair_columnar(b1, b2)
            item = None
            if Lp is not None:
                item = (b1, b2, Lp, self._fused_pair_dispatch(b1, b2,
                                                              Lp))
            if item is None:
                l1 = np.unique(b1.lengths)
                l2 = np.unique(b2.lengths)
                if len(l1) == 1 and len(l2) == 1 and self.device_quickmap:
                    L1, L2 = int(l1[0]), int(l2[0])
                    if L1 >= self.index.k and L2 >= self.index.k:
                        h1 = self._qm_dispatch(b1, L1)
                        h2 = self._qm_dispatch(b2, L2)
                        item = (b1, b2, L1, L2, h1, h2)
            if item is None:
                item = (b1, b2)
            if pending is not None:
                yield self._finish_pair_item(pending)
            pending = item
        if pending is not None:
            yield self._finish_pair_item(pending)

    def _finish_pair_item(self, item):
        if len(item) == 2:
            return self.map_pairs(item[0], item[1])
        if len(item) == 4:
            b1, b2, Lp, f = item
            mb1, mb2 = self._columnar_pair_from_fused(b1, b2, Lp,
                                                      f.host())
            res1 = [MappedRead() for _ in range(b1.size)]
            res2 = [MappedRead() for _ in range(b2.size)]
            mb1.fill_objects(res1)
            mb2.fill_objects(res2)
            return res1, res2
        b1, b2, L1, L2, h1, h2 = item
        B = b1.size
        res1 = [MappedRead() for _ in range(B)]
        res2 = [MappedRead() for _ in range(B)]
        return self._map_pairs_device(b1, b2, L1, L2, res1, res2,
                                      d1=h1.host(), d2=h2.host())

    def _map_pairs_device(self, b1, b2, L1, L2, res1, res2,
                          d1=None, d2=None):
        if d1 is None:
            d1 = self._qm_run(b1, L1)
        if d2 is None:
            d2 = self._qm_run(b2, L2)
        b1m, b2m = self._pair_boost_fixed(d1, d2, L1, L2)
        sc1 = np.maximum(d1["cand_scores"].astype(np.int64), b1m)
        sc2 = np.maximum(d2["cand_scores"].astype(np.int64), b2m)
        p1, eff1, snd1 = self._repick(d1, sc1)
        p2, eff2, snd2 = self._repick(d2, sc2)
        max_imp1 = self.profile.max_imperfect_score(L1)
        max_imp2 = self.profile.max_imperfect_score(L2)
        best1 = p1["best_score"].astype(np.int64)
        best2 = p2["best_score"].astype(np.int64)
        escalate = np.zeros(len(best1), bool)
        if self.maxindel > 0:
            escalate = (best1 < max_imp1) | (best2 < max_imp2)
        direct = ~escalate
        self._direct_fill(b1, L1, p1, res1, direct, eff1, snd1)
        self._direct_fill(b2, L2, p2, res2, direct, eff2, snd2)
        idxs = np.nonzero(escalate)[0].astype(np.int64)
        if len(idxs):
            g1 = self._g_from_device(b1, L1, idxs, d1)
            g2 = self._g_from_device(b2, L2, idxs, d2)
            hb1 = hb2 = None
            if g1 is not None and g2 is not None:
                hb1, hb2 = self._pair_boost(g1, g2)
            w1 = self._select_group(g1, res1, hb1, paired=True) \
                if g1 is not None else []
            w2 = self._select_group(g2, res2, hb2, paired=True) \
                if g2 is not None else []
            if g1 is not None:
                self._finalize_winners(g1["cand_reads"], g1["refs_g"],
                                       g1["cs"], w1, res1, L1,
                                       g1.get("dp_cache"))
            if g2 is not None:
                self._finalize_winners(g2["cand_reads"], g2["refs_g"],
                                       g2["cs"], w2, res2, L2,
                                       g2.get("dp_cache"))
        self._rescue(b1, b2, L1, L2, res1, res2)
        self._set_pair_flags(res1, res2, L1, L2)
        return res1, res2

    # ------------------------------------------------------------------
    # fused paired device path (single dispatch per pair batch)
    # ------------------------------------------------------------------

    def _fused_pair_dispatch(self, b1: ReadBatch, b2: ReadBatch, L: int):
        """Dispatch both mates through the fused paired program
        (align/fused_device.build_fused_pair) — candidates, pair boost,
        DP escalation and traceback in ONE device program."""
        from . import fused_device as fdev
        key = ("pair", L, b1.size)
        f = self._fused_cache.get(key)
        if f is None:
            f = fdev.build_fused_pair(
                self.dindex, L, b1.size, chain_dist=self.chain_dist,
                min_ratio=self.min_ratio,
                profile=self.profile)
            self._fused_cache[key] = f
        q1 = b1.quality
        q2 = b2.quality
        return f(b1.bases, b2.bases, int(self.average_pair_dist),
                 q1, q2)

    def _can_pair_columnar(self, b1: ReadBatch, b2: ReadBatch):
        l1 = np.unique(b1.lengths)
        l2 = np.unique(b2.lengths)
        if not (self.device_quickmap and self.maxindel > 0
                and len(l1) == 1 and len(l2) == 1):
            return None
        L1, L2 = int(l1[0]), int(l2[0])
        if L1 != L2 or L1 < self.index.k:
            return None
        if not self._use_fused(L1):
            return None
        if (b1.quality is None) != (b2.quality is None):
            return None
        return L1

    def map_pairs_columnar(self, b1: ReadBatch, b2: ReadBatch):
        """Columnar paired fast path: one fused device dispatch for the
        pair batch + one small device rescue dispatch. Returns
        (mb1, mb2) MappedBatches, or None when the batch shapes don't
        qualify (caller falls back to map_pairs)."""
        L = self._can_pair_columnar(b1, b2)
        if L is None:
            return None
        f = self._fused_pair_dispatch(b1, b2, L)
        return self._columnar_pair_from_fused(b1, b2, L, f.host())

    def _columnar_pair_from_fused(self, b1: ReadBatch, b2: ReadBatch,
                                  L: int, d: dict):
        """Assemble (mb1, mb2) from the fused paired dispatch: direct
        fill with boosted eff/second, escalation/trace application with
        the paired retention rule, host fallback by PAIR, device mate
        rescue, and columnar pair flags."""
        mid = self._pair_phase1(b1, b2, L, d)
        return self._pair_phase2(mid)

    def _pair_phase1(self, b1: ReadBatch, b2: ReadBatch, L: int,
                     d: dict):
        """Everything up to and including the rescue DISPATCH (the
        rescue program queues on the device; fetching it is deferred to
        _pair_phase2 so a streaming caller can slot the next batch's
        fused dispatch in between — ops/rescue_device rides behind it
        without stalling the host)."""
        B = b1.size
        vbases = np.vstack([b1.bases[:, :L], b2.bases[:, :L]])
        vbatch = ReadBatch(
            bases=vbases, quality=None,
            lengths=np.full(2 * B, L, np.int32),
            ids=b1.ids + b2.ids,
            numeric_ids=np.arange(2 * B, dtype=np.int64))
        mb = MappedBatch(2 * B, L)
        max_imp = self.profile.max_imperfect_score(L)
        best0 = d["best_score"].astype(np.int64)
        escalate = best0 < max_imp      # per MATE (see fused_stage note)
        d.setdefault("_bases", vbases)
        self._direct_fill_columnar(
            vbatch, L, d, mb, ~escalate,
            scored=d["eff"].astype(np.int64),
            second=d["second_score"].astype(np.int64))
        E = len(d["_esc"]["idx"])
        over_rows = np.nonzero(escalate)[0][E:]
        fallback, applied = self._apply_fused_esc(
            vbatch, L, d, mb, over_rows, paired=True)
        # long-indel tail on still-unmapped applied rows flagged
        # plausible by the device (same as the single fused path)
        still = applied[~mb.mapped[applied]
                        & d["li_plaus"][applied]]
        if self.maxindel > self.chain_dist and len(still):
            proxy = _ResultsProxy()
            self._long_indel_pass(vbatch, L, still.astype(np.int64),
                                  proxy)
            if proxy.store:
                mb.absorb_objects(proxy.store)
        # post-DP winner-level pair re-boost (VERDICT r4 #8): the
        # device selection carried the PRE-DP boost delta through the
        # DP competition, so the reported value (and therefore MAPQ,
        # stream/SamLine.java:1703-1721) drifted from the host paired
        # path, which derives pairedScore AFTER scoreSlow (reference
        # order: AbstractMapThread scoreSlow -> pairSiteScoresFinal).
        # Re-derive the boost from the FINAL raw winner scores.
        raw = d["best_score"].astype(np.int64).copy()
        esc_v = d["_esc"]
        ev = esc_v["idx"].astype(np.int64)
        ev_ok = ev < 2 ** 30
        raw[ev[ev_ok]] = esc_v["raweff"][ev_ok].astype(np.int64)
        if len(still):
            raw[still] = mb.score[still]
        self._reboost_winner_pairs(mb, raw, B, L)
        mb1 = self._mb_slice(mb, 0, B, L)
        mb2 = self._mb_slice(mb, B, 2 * B, L)
        hi = np.nonzero(d["hi_over"])[0] if "hi_over" in d else \
            np.zeros(0, np.int64)
        if len(hi):
            # two-tier slot-budget overflow: candidates truncated
            # in-device — the PAIR is refit exactly (the mate's boost
            # consulted the truncated table too)
            fallback = np.union1d(fallback, hi).astype(np.int64)
        if len(fallback):
            pair_ids = np.unique(fallback % B)
            self._refit_pairs(b1, b2, L, pair_ids, mb1, mb2)
        pend = self._rescue_dispatch(b1, b2, L, L, mb1, mb2)
        return (b1, b2, L, mb1, mb2, pend)

    def _reboost_winner_pairs(self, mb: "MappedBatch", raw: np.ndarray,
                              B: int, L: int) -> None:
        """Winner-level pairSiteScoresFinal on POST-DP raw scores
        (reference: AbstractMapThread.java:1919-2070 applied to the
        selected sites): where both mates mapped and their winner sites
        form a valid opposite-strand pair within the distance limits,
        score = max(raw, raw + 1 + max(1, mate*mult - dev*mate/denom));
        where the winner pair is invalid or a mate is unmapped the
        device selection value stands (it already max-ed over the full
        candidate cross)."""
        m = mb.mapped[:B] & mb.mapped[B:]
        if not m.any():
            return
        rows = np.nonzero(m)[0]
        ch1 = mb.chrom[:B][rows].astype(np.int64)
        ch2 = mb.chrom[B:][rows].astype(np.int64)
        off1 = self.chrom_offsets[np.maximum(ch1, 1) - 1]
        off2 = self.chrom_offsets[np.maximum(ch2, 1) - 1]
        a_start = off1 + mb.start[:B][rows].astype(np.int64)
        a_stop = off1 + mb.stop[:B][rows].astype(np.int64)
        b_start = off2 + mb.start[B:][rows].astype(np.int64)
        b_stop = off2 + mb.stop[B:][rows].astype(np.int64)
        st1 = mb.strand[:B][rows]
        st2 = mb.strand[B:][rows]
        opp = st1 != st2
        inner = np.where(st1 == 0, b_start - a_stop,
                         a_start - b_stop)
        outer = np.where(st1 == 0, b_stop - a_start,
                         a_stop - b_start)
        outer_limit = (L * OUTER_DIST_MULT) // OUTER_DIST_DIV
        ok = (opp & (ch1 == ch2) & (outer >= outer_limit)
              & (inner <= MAX_PAIR_DIST))
        if not ok.any():
            return
        apd = int(self.average_pair_dist)
        expected_frag = apd + 2 * L
        deviation = np.abs(apd - inner)
        mult = min(0.5, max(0.25, 1.0 / 4.0))
        denom = max(100, 10 * expected_frag + 100)
        r1 = raw[rows]
        r2 = raw[B + rows]
        p1 = r1 + 1 + np.maximum(
            1, (r2 * mult).astype(np.int64) - (deviation * r2) // denom)
        p2 = r2 + 1 + np.maximum(
            1, (r1 * mult).astype(np.int64) - (deviation * r1) // denom)
        okr = rows[ok]
        mb.score[okr] = np.maximum(r1[ok], p1[ok])
        mb.score[B + okr] = np.maximum(r2[ok], p2[ok])

    def _pair_phase2(self, mid):
        return self._pair_phase2b(self._pair_phase2a(mid))

    def _pair_phase2a(self, mid):
        """Fetch the rescue scan + dispatch the slowRescue DP (the DP
        fetch is deferred one more stream slot)."""
        if mid[0] == "done":       # host-path stream item
            return mid
        b1, b2, L, mb1, mb2, pend = mid
        st2 = self._rescue_apply_score(pend)
        return ("2a", b1, b2, L, mb1, mb2, st2)

    def _pair_phase2b(self, mid2):
        if mid2[0] == "done":
            return mid2[1]
        _tag, b1, b2, L, mb1, mb2, st2 = mid2
        self._rescue_finish(st2)
        self._set_pair_flags_columnar(mb1, mb2, L, L)
        return mb1, mb2

    @staticmethod
    def _mb_slice(mb: MappedBatch, lo: int, hi: int,
                  L: int) -> MappedBatch:
        """View-slice a MappedBatch row range (shares the column
        buffers)."""
        out = MappedBatch.__new__(MappedBatch)
        out.size = hi - lo
        for f in ("mapped", "strand", "chrom", "start", "stop", "score",
                  "ambiguous", "perfect", "paired", "rescued",
                  "n_sites", "match_is_row"):
            setattr(out, f, getattr(mb, f)[lo:hi])
        out.match_rows = None if mb.match_rows is None \
            else mb.match_rows[lo:hi]
        out.match_override = {
            i - lo: v for i, v in mb.match_override.items()
            if lo <= i < hi}
        out.match_fill = mb.match_fill   # shared deferred fillers (they
        # write into the parent buffer the slices view)
        return out

    def _refit_pairs(self, b1: ReadBatch, b2: ReadBatch, L: int,
                     pair_ids: np.ndarray, mb1: MappedBatch,
                     mb2: MappedBatch) -> None:
        """Re-map fallback pairs through the host paired path (unfused
        quickmap + host escalation + host rescue) and merge."""
        n = len(pair_ids)
        P = max(256, _bucket_pad(n))   # few shapes ever compile

        def sub(b):
            bases = np.full((P, b.bases.shape[1]), ord("N"), np.uint8)
            bases[:n] = b.bases[pair_ids]
            qual = None
            if b.quality is not None:
                qual = np.zeros((P, b.quality.shape[1]), np.int8)
                qual[:n] = b.quality[pair_ids]
            return ReadBatch(
                bases=bases, quality=qual,
                lengths=np.full(P, L, np.int32),
                ids=[b.ids[int(r)] for r in pair_ids] + [""] * (P - n),
                numeric_ids=np.arange(P, dtype=np.int64))

        res1, res2 = self._map_pairs_device(
            sub(b1), sub(b2), L, L,
            [MappedRead() for _ in range(P)],
            [MappedRead() for _ in range(P)])
        for t, pid in enumerate(pair_ids):
            for mbx, r in ((mb1, res1[t]), (mb2, res2[t])):
                i = int(pid)
                mbx.mapped[i] = r.mapped
                mbx.strand[i] = r.strand
                mbx.chrom[i] = r.chrom
                mbx.start[i] = r.start
                mbx.stop[i] = r.stop
                mbx.score[i] = r.score
                mbx.ambiguous[i] = r.ambiguous
                mbx.perfect[i] = r.perfect
                mbx.paired[i] = r.paired
                mbx.rescued[i] = r.rescued
                mbx.n_sites[i] = r.n_sites
                mbx.match_is_row[i] = False
                mbx.match_override[i] = r.match

    def _rescue_columnar(self, b1, b2, L1: int, L2: int,
                         mb1: MappedBatch, mb2: MappedBatch) -> None:
        self._rescue_apply(self._rescue_dispatch(b1, b2, L1, L2,
                                                 mb1, mb2))

    def _rescue_dispatch(self, b1, b2, L1: int, L2: int,
                         mb1: MappedBatch, mb2: MappedBatch):
        """Columnar mate rescue, dispatch half: job construction
        vectorized, the quickRescue scan launched on device
        (ops/rescue_device — bit-equal to the host oracle). Returns the
        pending state for :meth:`_rescue_apply` (or None). Semantics
        mirror ``_rescue`` (reference:
        AbstractMapThread.rescue:1144-1250)."""
        from ..core.bases import COMP_ASCII

        if self._mapped_retained > 1000 and \
                self._num_mated * 20 < self._mapped_retained:
            return None
        apd = int(self.average_pair_dist)
        search_dist = min(MAX_PAIR_DIST, 2 * apd + 100)
        if search_dist > MAX_RESCUE_DIST:
            return None

        jobs = []      # (mb_target, row, mate_read_ascii, lo, n,
        #                 ideal_k, right, max_mm, strand, anchor_mb)
        for which, (amb, mmb, bm, Lm, La) in (
                (2, (mb1, mb2, b2, L2, L1)),
                (1, (mb2, mb1, b1, L1, L2))):
            rows = np.nonzero(amb.mapped & ~mmb.mapped)[0]
            if not len(rows):
                continue
            a_chrom = amb.chrom[rows].astype(np.int64)
            a_start = amb.start[rows].astype(np.int64)
            a_stop = amb.stop[rows].astype(np.int64)
            a_strand = amb.strand[rows].astype(np.int64)
            anchor_flat = self.chrom_offsets[a_chrom - 1] + a_start
            span = a_stop - a_start
            search_into = (span - 1) + (La * 11) // 16
            strand0 = a_strand == 0
            loc = np.where(strand0,
                           anchor_flat + span - search_into,
                           anchor_flat + search_into)
            ideal = np.where(strand0, anchor_flat + span + apd,
                             anchor_flat - apd)
            total = search_dist + search_into
            ch_lo = self.chrom_offsets[a_chrom - 1]
            ch_hi = np.where(
                a_chrom < len(self.chrom_offsets) - 1,
                self.chrom_offsets[np.minimum(
                    a_chrom, len(self.chrom_offsets) - 1)],
                len(self.codes_ascii))
            lo = np.where(strand0, np.maximum(ch_lo, loc),
                          np.maximum(ch_lo, loc - total))
            hi = np.where(strand0, np.minimum(ch_hi - Lm, loc + total),
                          np.minimum(ch_hi - Lm, loc))
            n = hi - lo + 1
            max_mm = min(MAX_RESCUE_MISMATCHES, int(0.60 * Lm - 1))
            for t, row in enumerate(rows):
                if n[t] <= 0:
                    continue
                raw = bm.bases[row, :Lm]
                mate_read = COMP_ASCII[raw][::-1] if strand0[t] else raw
                jobs.append((which, int(row), mate_read, int(lo[t]),
                             int(n[t]), int(ideal[t] - lo[t]),
                             bool(strand0[t]), max_mm,
                             0 if not strand0[t] else 1))
        if not jobs:
            return None

        from .quickmap_device import _B2C
        Lm = L2   # L1 == L2 on this path
        N_OFF = 1536
        dev_jobs: list = []
        host_jobs: list = []
        for j in jobs:
            if self.device_quickmap and j[4] <= N_OFF:
                dev_jobs.append(j)
            else:
                host_jobs.append(j)
        pending_dev = None
        if dev_jobs:
            # exactly the device jobs, one upload and one launch
            from ..ops import rescue_device
            reads_c = _B2C[np.stack([j[2] for j in dev_jobs])]
            lo_a, n_a, ik_a, mm_a = np.array(
                [(j[3], j[4], j[5], j[7]) for j in dev_jobs], np.int32).T
            rt_a = np.array([j[6] for j in dev_jobs], bool)
            jobs_d = rescue_device.upload_jobs(reads_c, lo_a, n_a, ik_a,
                                               rt_a, mm_a, self.dindex.device)
            pending_dev = (rescue_device.rescue_scan(self.dindex, *jobs_d,
                                                     Lm, N_OFF), lo_a)
        return (mb1, mb2, Lm, dev_jobs, host_jobs, pending_dev)

    def _rescue_apply(self, pend) -> None:
        """Synchronous rescue tail: scan fetch + slowRescue + writes."""
        self._rescue_finish(self._rescue_apply_score(pend))

    def _rescue_apply_score(self, pend):
        """Fetch the in-flight rescue scan, merge host-path jobs, run
        the vectorized gapless re-score, and DISPATCH the slowRescue DP
        (reference: AbstractMapThread.java:1247-1303). Returns the
        state for :meth:`_rescue_finish` (or None)."""
        from . import gapless
        if pend is None:
            return None
        mb1, mb2, Lm, dev_jobs, host_jobs, pending_dev = pend
        results = {}   # (which, row) -> (job, start_flat, mm)
        if pending_dev is not None:
            (best_k, min_mm), lo_a = pending_dev
            best_k, min_mm = best_k.cpu().numpy(), min_mm.cpu().numpy()
            for t, job in enumerate(dev_jobs):
                which, row = job[0], job[1]
                bk = int(best_k[t])
                if bk < 0:
                    continue
                n_t, right = job[4], job[6]
                start = (lo_a[t] + bk) if right \
                    else (lo_a[t] + (n_t - 1) - bk)
                results[(which, row)] = (job, int(start),
                                         int(min_mm[t]))
        for job in host_jobs:
            which, row, mate_read, lo_t, n_t, ik, right, max_mm, \
                mstrand = job
            found = self._quick_rescue(
                mate_read, lo_t if right else lo_t + n_t - 1,
                n_t - 1, right, ik + lo_t, max_mm,
                int((mb1 if which == 2 else mb2).chrom[row]))
            if found is not None:
                results[(which, row)] = (job, int(found[0]),
                                         int(found[1]))

        if not results:
            return None
        return self._rescue_score(results, Lm, mb1, mb2)

    def _rescue_score(self, results, Lm, mb1, mb2):
        """slowRescue part 1: vectorized gapless re-score of every found
        site + DISPATCH of the batched DP for imperfect rescues (the
        fetch is deferred to :meth:`_rescue_finish` so a streaming
        caller can slot the next fused dispatch in between)."""
        from . import gapless
        recs = list(results.values())
        g = self.codes_ascii
        max_mm_v = np.array([r[0][7] for r in recs])
        mm_v = np.array([r[2] for r in recs])
        ok0 = mm_v <= max_mm_v
        reads_m = np.stack([r[0][2] for r in recs])
        diag_v = np.array([r[1] for r in recs], np.int64)
        scores = gapless.score_no_indels_flat(
            reads_m, np.full(len(recs), Lm), g, diag_v, self.profile)
        max_imp = self.profile.max_imperfect_score(Lm)
        start_flat = diag_v.copy()
        stop_flat = diag_v + Lm - 1
        match_v: list = [None] * len(recs)
        score_v = scores.astype(np.int64)
        dp_rows = np.nonzero(ok0 & (score_v < max_imp))[0] \
            if self.maxindel > 0 else np.zeros(0, np.int64)
        launch = None
        pad = SLOW_ALIGN_PADDING + 6
        if len(dp_rows):
            # slowRescue DP, batched (host _rescue runs the numpy oracle
            # per job — same DP family, parity-tested in tests/test_msa)
            C = Lm + 2 * pad
            chunk = max(256, _bucket_pad(len(dp_rows)))
            reads_b = np.full((chunk, Lm), ord("N"), np.uint8)
            refs_b = np.full((chunk, C), ord("N"), np.uint8)
            for s_i, t in enumerate(dp_rows):
                reads_b[s_i] = reads_m[t]
                refs_b[s_i] = self._window(int(diag_v[t]) - pad, C)
            sym, ln, gaps, sc, col, st = msa.msa_align_batch(
                self._dev(reads_b), self._dev(refs_b), self.profile)
            launch = (sym, ln, gaps, sc, col)
        return (recs, reads_m, ok0, score_v, start_flat, stop_flat,
                match_v, dp_rows, diag_v, launch, Lm, mb1, mb2, pad)

    def _rescue_finish(self, st2) -> None:
        """slowRescue part 2: fetch the DP, apply improvements, retain
        rules, and write the rescued mates (reference:
        AbstractMapThread.java:1247-1303 retain 0.4/0.55)."""
        from . import gapless
        if st2 is None:
            return
        (recs, reads_m, ok0, score_v, start_flat, stop_flat, match_v,
         dp_rows, diag_v, launch, Lm, mb1, mb2, pad) = st2
        g = self.codes_ascii
        max_sw = self.profile.max_quality(Lm)
        retain = int(0.4 * max_sw)
        retain2 = int(0.55 * max_sw)
        if launch is not None:
            sym, ln, gaps, sc, col = _fetch(list(launch))
            for s_i, t in enumerate(dp_rows):
                if int(sc[s_i]) > score_v[t]:
                    mmatch = msa.finish_match(
                        sym[s_i], int(ln[s_i]), int(gaps[s_i]))
                    refc = sum(1 for ch in mmatch if ch in b"mSDN-")
                    ws = int(diag_v[t]) - pad
                    score_v[t] = int(sc[s_i])
                    start_flat[t] = ws + int(col[s_i]) - refc
                    stop_flat[t] = ws + int(col[s_i]) - 1
                    match_v[t] = mmatch

        keep = ok0 & (score_v > retain)
        rows_k = np.nonzero(keep)[0]
        if len(rows_k):
            nomatch = [t for t in rows_k if match_v[t] is None]
            if nomatch:
                refs = gapless.gather_ref_rows(
                    g, start_flat[np.array(nomatch)], Lm)
                mats = gapless.gen_match_no_indels_batch(
                    reads_m[np.array(nomatch)], refs)
                for s_i, t in enumerate(nomatch):
                    match_v[t] = bytes(mats[s_i])
        for t in rows_k:
            job, _, mmv = recs[t]
            which, row = job[0], job[1]
            mmb = mb2 if which == 2 else mb1
            amb = mb1 if which == 2 else mb2
            mmb.mapped[row] = True
            mmb.rescued[row] = True
            mmb.strand[row] = 1 if job[6] else 0   # right => anchor fwd
            mmb.score[row] = score_v[t]
            mmb.perfect[row] = score_v[t] >= max_sw
            mmb.ambiguous[row] = False
            mmb.n_sites[row] = 1
            chrom, lloc = self._chrom_of(int(start_flat[t]))
            mmb.chrom[row] = chrom
            mmb.start[row] = lloc
            mmb.stop[row] = lloc + int(stop_flat[t] - start_flat[t])
            mmb.match_is_row[row] = False
            mmb.match_override[int(row)] = bytes(match_v[t])
            if score_v[t] > retain2:
                mmb.paired[row] = True
                amb.paired[row] = True

    def _set_pair_flags_columnar(self, mb1: MappedBatch,
                                 mb2: MappedBatch, L1: int,
                                 L2: int) -> None:
        """Vectorized canPair + running insert model (mirrors
        _set_pair_flags; reference: AbstractMapThread.canPair:2098)."""
        outer_limit = (max(L1, L2) * OUTER_DIST_MULT) // OUTER_DIST_DIV
        both = (mb1.mapped & mb2.mapped & (mb1.chrom == mb2.chrom)
                & (mb1.strand != mb2.strand))
        s0 = mb1.strand == 0
        inner = np.where(s0, mb2.start - mb1.stop, mb1.start - mb2.stop)
        outer = np.where(s0, mb2.stop - mb1.start, mb1.stop - mb2.start)
        ok = both & (outer >= outer_limit) & (inner <= MAX_PAIR_DIST)
        mb1.paired |= ok
        mb2.paired |= ok
        inner_cl = np.clip(inner[ok], MIN_PAIR_DIST, MAX_PAIR_DIST)
        self._mapped_retained += int(mb1.mapped.sum()) \
            + int(mb2.mapped.sum())
        self._num_mated += 2 * int(ok.sum())
        self._inner_sum += int(inner_cl.sum())
        if ok.any() and self._num_mated > 2000:
            self.average_pair_dist = (
                self._inner_sum * 2.0 / self._num_mated)

    def map_pairs_columnar_stream(self, pairs):
        """Streaming columnar paired mapping, pipelined TWO deep: batch
        N+1's fused pair dispatch reaches the device before batch N's
        host assembly, and batch N's rescue program (dispatched during
        assembly) executes right behind batch N+1's fused program — so
        the device never idles and the host never blocks on a fetch
        queued behind a full fused program. Yields (mb1, mb2) in order;
        pairs that can't take the device path yield via the object path
        converted to columns."""
        import time as _time
        trace = os.environ.get("BBMAP_STREAM_TRACE") == "1"
        t00 = _time.time()

        def _tr(tag, t0):
            if trace:
                print(f"[stream +{_time.time()-t00:7.3f}s] {tag} "
                      f"{1e3*(_time.time()-t0):6.1f} ms",
                      file=sys.stderr, flush=True)

        # The stage order is the JAX package's, kept exactly: each
        # dispatch reads the average_pair_dist that the pair flags of the
        # batches finished before it have updated, so the order decides
        # the results. Per
        # iteration: phase2a(k-1) (rescue scan results + slowRescue DP),
        # dispatch fused(k+1), mid(k) (fused results + host assembly +
        # rescue scan), phase2b(k-2) (DP results, pair flags, yield).
        p_disp = None      # newest: fused dispatched, not yet assembled
        p_mid = None       # assembled, rescue scan in flight
        p_sc = None        # oldest: slowRescue DP in flight
        for b1, b2 in pairs:
            t0 = _time.time()
            new_sc = None
            if p_mid is not None:
                new_sc = self._pair_phase2a(p_mid)
                p_mid = None
            _tr("phase2a ", t0)
            L = self._can_pair_columnar(b1, b2)
            t0 = _time.time()
            if L is not None:
                item = (b1, b2, L, self._fused_pair_dispatch(b1, b2, L))
            else:
                item = (b1, b2)
            _tr("dispatch", t0)
            if p_disp is not None:
                t0 = _time.time()
                p_mid = self._pair_mid(p_disp)
                _tr("mid(fetch+p1)", t0)
            p_disp = item
            if p_sc is not None:
                t0 = _time.time()
                yield self._pair_phase2b(p_sc)
                _tr("phase2b ", t0)
            p_sc = new_sc
        # drain
        for flush in range(4):
            new_sc = None
            if p_mid is not None:
                new_sc = self._pair_phase2a(p_mid)
                p_mid = None
            if p_disp is not None:
                p_mid = self._pair_mid(p_disp)
                p_disp = None
            if p_sc is not None:
                yield self._pair_phase2b(p_sc)
            p_sc = new_sc

    def _pair_mid(self, item):
        """Run phase 1 (host assembly + rescue dispatch) of a stream
        item; host-path items complete entirely here."""
        if len(item) == 4:
            b1, b2, L, f = item
            return self._pair_phase1(b1, b2, L, f.host())
        b1, b2 = item
        mbs = self._finish_pair_columnar(item)
        return ("done", mbs)

    def _finish_pair_columnar(self, item):
        if len(item) == 4:
            b1, b2, L, f = item
            return self._columnar_pair_from_fused(b1, b2, L, f.host())
        b1, b2 = item
        res1, res2 = self.map_pairs(b1, b2)
        mbs = []
        for b, res in ((b1, res1), (b2, res2)):
            mbo = MappedBatch(b.size, int(b.lengths.max())
                              if b.size else 0)
            for i, r in enumerate(res):
                mbo.mapped[i] = r.mapped
                mbo.strand[i] = r.strand
                mbo.chrom[i] = r.chrom
                mbo.start[i] = r.start
                mbo.stop[i] = r.stop
                mbo.score[i] = r.score
                mbo.ambiguous[i] = r.ambiguous
                mbo.perfect[i] = r.perfect
                mbo.paired[i] = r.paired
                mbo.rescued[i] = r.rescued
                mbo.n_sites[i] = r.n_sites
                mbo.match_override[i] = r.match
            mbs.append(mbo)
        return mbs[0], mbs[1]

    def _quick_rescue(self, mate_read: np.ndarray, loc: int,
                      search_dist: int, search_right: bool, ideal: int,
                      max_mm: int, chrom: int):
        """Exact quickRescue scan (reference:
        AbstractMapThread.quickRescue:2303-2404): per-offset mismatch
        count (read N = mismatch) + longest exact-run ("contig") bonus,
        score = (L - mismatches) + contig, acceptance is sequential in
        scan order with a monotonically tightening mismatch bound and an
        absdif-to-ideal tiebreak; an exact match shrinks the remaining
        scan to |ideal - start|. Returns (best_start, mismatches) or
        None. The heavy per-offset arrays are vectorized; only the
        order-dependent acceptance walk stays scalar."""
        g = self.codes_ascii
        Lm = len(mate_read)
        ch_lo = int(self.chrom_offsets[chrom - 1])
        ch_hi = int(self.chrom_offsets[chrom]) \
            if chrom < len(self.chrom_offsets) - 1 else len(g)
        if search_right:
            lo = max(ch_lo, loc)
            hi = min(ch_hi - Lm, loc + search_dist)
        else:
            lo = max(ch_lo, loc - search_dist)
            hi = min(ch_hi - Lm, loc)
        if hi < lo:
            return None
        n = hi - lo + 1
        win = np.lib.stride_tricks.sliding_window_view(
            g[lo:hi + Lm], Lm)[:n]
        bad = (win != mate_read[None, :]) | (mate_read[None, :] == _NB)
        mism = bad.sum(1).astype(np.int64)
        # longest run of matches per offset: boundaries via cumsum reset
        run_id = np.cumsum(bad, axis=1)
        contig = np.zeros(n, np.int64)
        # per row: count occurrences of each run_id among non-bad cells;
        # vectorized with bincount over (row * (L+1) + run_id)
        rows_f, cols_f = np.nonzero(~bad)
        if len(rows_f):
            key = rows_f * (Lm + 1) + run_id[rows_f, cols_f]
            cnt = np.bincount(key, minlength=n * (Lm + 1))
            contig = cnt.reshape(n, Lm + 1).max(1).astype(np.int64)
        score = (Lm - mism) + contig
        absdif = np.abs(np.arange(lo, hi + 1, dtype=np.int64) - ideal)

        min_mm = max_mm + 1
        best_score = 0
        best_start = -1
        best_absdif = 1 << 60
        order = range(n) if search_right else range(n - 1, -1, -1)
        bound_lo, bound_hi = lo, hi
        for t in order:
            start = lo + t
            if start < bound_lo or start > bound_hi:
                break
            m = int(mism[t])
            if m > min_mm:
                continue
            s = int(score[t])
            a = int(absdif[t])
            if s > best_score or (s == best_score and a < best_absdif):
                best_start = start
                min_mm = m
                best_score = s
                best_absdif = a
                if m == 0:
                    if search_right:
                        bound_hi = min(bound_hi, ideal + a)
                    else:
                        bound_lo = max(bound_lo, ideal - a)
        if best_start < 0:
            return None
        return best_start, min_mm

    def _rescue(self, b1, b2, L1, L2, res1, res2) -> None:
        """Mate rescue (reference: AbstractMapThread.rescue:1144-1250):
        directional quickRescue scan from each anchor with the dynamic
        pair-distance model, disabled when pairing is failing (<5%
        mated, :1146), gapless re-score + DP escalation of the rescued
        site (slowRescue), retain thresholds 0.4/0.55 of max score."""
        from ..core.bases import COMP_ASCII
        from . import gapless

        # skip rescue when mating is not working (reference: :1146)
        if self._mapped_retained > 1000 and \
                self._num_mated * 20 < self._mapped_retained:
            return
        apd = int(self.average_pair_dist)
        search_dist = min(MAX_PAIR_DIST, 2 * apd + 100)
        if search_dist > MAX_RESCUE_DIST:
            return  # too slow (reference: :1147)

        jobs = []  # (pair_idx, which_missing)
        for i, (r1, r2) in enumerate(zip(res1, res2)):
            if r1.mapped and not r2.mapped:
                jobs.append((i, 2))
            elif r2.mapped and not r1.mapped:
                jobs.append((i, 1))
        if not jobs:
            return
        for i, which in jobs:
            anchor = res1[i] if which == 2 else res2[i]
            bm = b2 if which == 2 else b1
            Lm = L2 if which == 2 else L1
            La = L1 if which == 2 else L2
            resm = res2 if which == 2 else res1
            row = bm.bases[i, :Lm]
            anchor_flat = int(self.chrom_offsets[anchor.chrom - 1]) \
                + anchor.start
            # fragments down to 68% of a read length overlap the anchor
            # (reference: :1187)
            search_into = (anchor.stop - anchor.start - 1) \
                + (La * 11) // 16
            if anchor.strand == 0:
                # FR innie: mate downstream on the minus strand
                mate_strand = 1
                mate_read = COMP_ASCII[row][::-1]
                loc = anchor_flat + (anchor.stop - anchor.start) \
                    - search_into
                ideal = anchor_flat + (anchor.stop - anchor.start) + apd
                search_right = True
            else:
                mate_strand = 0
                mate_read = row
                loc = anchor_flat + search_into
                ideal = anchor_flat - apd
                search_right = False
            max_sw = self.profile.max_quality(Lm)
            max_imp = self.profile.max_imperfect_score(Lm)
            # loose read is unmapped here -> bestLooseScore = 0
            # (reference: :1170-1171)
            max_mm = min(MAX_RESCUE_MISMATCHES, int(0.60 * Lm - 1))
            found = self._quick_rescue(
                mate_read, loc, search_dist + search_into, search_right,
                ideal, max_mm, anchor.chrom)
            if found is None:
                continue
            diag, mm = found
            if mm > max_mm:
                continue
            # slowRescue (reference: :1247-1303): gapless re-score, DP
            # escalation when imperfect and indels are allowed
            g = self.codes_ascii
            score = int(gapless.score_no_indels_flat(
                mate_read[None, :], np.array([Lm]), g,
                np.array([diag]), self.profile)[0])
            match = None
            start_flat, stop_flat = diag, diag + Lm - 1
            if score < max_imp and self.maxindel > 0:
                pad = SLOW_ALIGN_PADDING + 6
                C = Lm + 2 * pad
                ref = self._window(diag - pad, C)
                msc, mstart, mmatch = 0, 0, None
                from ..ops import msa_ref as _mref
                msc, mstart, mmatch = _mref.align(mate_read, ref,
                                                  self.profile)
                if msc > score:
                    score = int(msc)
                    start_flat = diag - pad + mstart
                    refc = sum(1 for ch in mmatch if ch in b"mSND")
                    stop_flat = start_flat + refc - 1
                    match = mmatch
            # retain limits (reference: :1168-1169 with bestLoose=0)
            retain = int(0.4 * max_sw)
            retain2 = int(0.55 * max_sw)
            if score <= retain:
                continue
            rm = resm[i]
            rm.mapped = True
            rm.rescued = True
            rm.strand = mate_strand
            rm.score = score
            rm.perfect = score >= max_sw
            rm.ambiguous = False
            rm.n_sites = 1
            chrom, lloc = self._chrom_of(start_flat)
            rm.chrom = chrom
            rm.start = lloc
            rm.stop = lloc + (stop_flat - start_flat)
            if match is None:
                refs = gapless.gather_ref_rows(
                    g, np.array([start_flat]), Lm)
                match = bytes(gapless.gen_match_no_indels_batch(
                    mate_read[None, :], refs)[0])
            rm.match = match
            if score > retain2:
                # resistant to discard = proper pair (reference: :1229)
                rm.paired = True
                anchor.paired = True

    def _map_group(self, batch: ReadBatch, L: int, idxs: np.ndarray,
                   results: List[MappedRead]) -> None:
        g = self._score_candidates(batch, L, idxs)
        if g is None:
            return
        winners = self._select_group(g, results, None, paired=False)
        self._finalize_winners(g["cand_reads"], g["refs_g"], g["cs"],
                               winners, results, L, g.get("dp_cache"))
        if self.maxindel > self.chain_dist:
            still = np.array([i for i in idxs if not results[i].mapped],
                             np.int64)
            if len(still):
                self._long_indel_pass(batch, L, still, results)

    def _long_indel_pass(self, batch: ReadBatch, L: int,
                         idxs: np.ndarray,
                         results: List[MappedRead]) -> None:
        """Gap-compressed DP for reads whose alignment spans an indel
        wider than the chain window (reference: makeGref gap compression,
        SiteScore.gaps; SURVEY §5.7). Chains to ±maxindel, compresses gap
        interiors to GAPC symbols, aligns, and translates coordinates
        back through the column map."""
        from ..core.bases import COMP_ASCII
        from ..ops import gref as grefmod

        k = self.index.k
        offsets = seed.make_offsets(L, k)
        if offsets is None:
            return
        max_sw = self.profile.max_quality(L)
        min_score = int(max_sw * self.min_ratio)

        from ..index.build import reverse_complement_key
        gcounts = self._li_global_counts

        def local_diags(i):
            """Both strands' seed diagonals from the (possibly
            block-local) CSR; per-key list-length filters consult the
            GLOBAL counts in cross-host mode (the local shard's
            lengths are partial)."""
            row = batch.bases[i, :L]
            keys_p = seed.keys_at_offsets(row, offsets, k)
            out = []
            for strand in (0, 1):
                if strand == 0:
                    kk = keys_p
                    off_adj = offsets.astype(np.int64)
                else:
                    kk = reverse_complement_key(
                        np.where(keys_p < 0, 0, keys_p), k)
                    kk = np.where(keys_p < 0, -1, kk)
                    off_adj = (L - (offsets + k)).astype(np.int64)
                diags = []
                for t in range(len(kk)):
                    key = int(kk[t])
                    if key < 0:
                        continue
                    s0, s1 = self.index.starts[key], \
                        self.index.starts[key + 1]
                    gl = int(gcounts[key]) if gcounts is not None \
                        else s1 - s0
                    if gl == 0 or gl > 64:
                        continue
                    diags.append(
                        self.index.sites[s0:s1].astype(np.int64)
                        - off_adj[t])
                out.append(np.concatenate(diags) if diags
                           else np.zeros(0, np.int64))
            return out

        per_read = [local_diags(i) for i in idxs]
        if self._xh_gather is not None and len(idxs):
            # merge seed lists across processes: each shard saw only
            # its genome block's sites. ONE fixed-shape collective per
            # pass (every process reaches here with identical idxs —
            # upstream results are replicated)
            flat = np.concatenate(
                [d for pair in per_read for d in pair]) \
                if per_read else np.zeros(0, np.int64)
            lens = np.array([len(d) for pair in per_read
                             for d in pair], np.int64)
            flats, lens_all = self._xh_gather(flat, lens)
            n_ent = len(lens)
            offs_p = [np.concatenate([[0], np.cumsum(lens_all[p])])
                      for p in range(len(flats))]
            merged = []
            for t in range(n_ent):
                merged.append(np.concatenate(
                    [flats[p][offs_p[p][t]:offs_p[p][t + 1]]
                     for p in range(len(flats))]))
            per_read = [(merged[2 * t], merged[2 * t + 1])
                        for t in range(len(idxs))]
        jobs = []   # (read_idx, strand, read_row, gref_padded, c2r, C)
        for pos_i, i in enumerate(idxs):
            row = batch.bases[i, :L]
            best = None
            for strand in (0, 1):
                draw = per_read[pos_i][strand]
                if len(draw) == 0:
                    continue
                dall = np.sort(draw)
                # largest chain within maxindel
                breaks = np.nonzero(np.diff(dall) > self.maxindel)[0]
                seg_a = np.concatenate([[0], breaks + 1])
                seg_b = np.concatenate([breaks + 1, [len(dall)]])
                sizes = seg_b - seg_a
                t = int(np.argmax(sizes))
                chain = dall[seg_a[t]:seg_b[t]]
                if best is None or len(chain) > len(best[1]):
                    best = (strand, chain)
            if best is None:
                continue
            strand, chain = best
            if len(chain) < 2:
                continue
            spread = int(chain[-1] - chain[0])
            if spread < K.MINGAP:
                continue  # narrow chains were already tried
            segments = grefmod.chain_segments(chain, L,
                                              pad=SLOW_ALIGN_PADDING)
            grefw, c2r = grefmod.make_gref(self.codes_ascii, segments)
            C = len(grefw)
            if C < L or C > 8192:
                continue
            # canonical power-of-two widths (>=512) so at most 5 DP
            # programs ever compile for this pass — variable widths made
            # steady state recompile nearly every batch
            Cp = 512
            while Cp < C:
                Cp <<= 1
            read = row if strand == 0 else COMP_ASCII[row][::-1]
            jobs.append((i, strand, read, grefw, c2r, C, Cp))
        if not jobs:
            return
        # batch the gap-compressed alignments by padded width — one
        # device dispatch per bucket instead of one per read
        buckets: Dict[int, List[int]] = {}
        for t, job in enumerate(jobs):
            buckets.setdefault(job[6], []).append(t)
        launches = []
        for Cp, slots in buckets.items():
            chunk = 16   # fixed: job counts here are tiny (tens/batch)
            for a, b in _fixed_chunks(len(slots), chunk):
                reads = np.full((chunk, L), ord("N"), np.uint8)
                refs = np.full((chunk, Cp), ord("!"), np.uint8)
                for s_i, t in enumerate(slots[a:b]):
                    _, _, read, grefw, _, C, _ = jobs[t]
                    reads[s_i] = read
                    refs[s_i, :C] = grefw
                sym, ln, gaps, sc, col, st = msa.msa_align_batch(
                    self._dev(reads), self._dev(refs), self.profile)
                launches.append((slots[a:b], (sym, ln, gaps, sc, col)))
        fetched = _fetch([a for _, outs in launches for a in outs])
        fi = 0
        for slots, _ in launches:
            sym, ln, gaps, sc, col = fetched[fi:fi + 5]
            fi += 5
            for s_i, t in enumerate(slots):
                i, strand, read, grefw, c2r, C, Cp = jobs[t]
                score = int(sc[s_i])
                if score < min_score:
                    continue
                match = msa.finish_match(sym[s_i], int(ln[s_i]),
                                         int(gaps[s_i]))
                max_col = int(col[s_i])
                flat_stop = int(c2r[min(max_col, C) - 1])
                ref_consumed = sum(1 for ch in match if ch in b"mSND")
                flat_start = flat_stop - ref_consumed + 1
                res = results[i]
                res.mapped = True
                res.strand = strand
                res.score = score
                res.perfect = False
                res.n_sites = 1
                chrom, loc = self._chrom_of(flat_start)
                res.chrom = chrom
                res.start = loc
                res.stop = loc + ref_consumed - 1
                res.match = match

    def _score_candidates(self, batch: ReadBatch, L: int,
                          idxs: np.ndarray) -> Optional[dict]:
        from ..core.bases import COMP_ASCII
        from . import gapless

        sub = batch.bases[idxs][:, :L]
        qual = batch.quality[idxs] if batch.quality is not None else None
        cs = seed.gather_candidates_batch(
            self.index, sub, L, chain_dist=self.chain_dist,
            max_candidates=self.max_candidates, quality=qual)
        if cs is None or len(cs) == 0:
            return None
        # drop single-vote noise chains for reads with a well-seeded site
        # (the reference's greedy hit-list trimming / prescan skipping,
        # align2/BBIndex.java:266,642)
        maxv = np.zeros(len(idxs), np.int32)
        np.maximum.at(maxv, cs.read_idx, cs.votes)
        keep = (cs.votes >= 2) | (maxv[cs.read_idx] < 3)
        if not keep.all():
            cs = seed.CandidateSet(
                read_idx=cs.read_idx[keep], strand=cs.strand[keep],
                start=cs.start[keep], stop=cs.stop[keep],
                votes=cs.votes[keep], spread=cs.spread[keep],
                best_diag=cs.best_diag[keep])
        n = len(cs)
        rc_sub = COMP_ASCII[sub][:, ::-1]
        cand_reads = np.where(cs.strand[:, None] == 0,
                              sub[cs.read_idx], rc_sub[cs.read_idx])

        # gapless fast path: sites whose no-indel score can't be beaten by
        # any indel alignment skip the DP entirely
        # (reference: align2/AbstractMapThread.java:1252). Scored on device
        # (one lax.scan over L with all candidates in the lanes), padded to
        # power-of-two job counts to bound recompilation.
        refs_g = gapless.gather_ref_rows(self.codes_ascii, cs.best_diag, L)
        g_scores = np.zeros(n, np.int32)
        chunk = min(GAPLESS_CHUNK, _bucket_pad(n))
        for a, b in _fixed_chunks(n, chunk):
            reads_p = np.full((chunk, L), ord("N"), np.uint8)
            refs_p = np.full((chunk, L), ord("N"), np.uint8)
            reads_p[:b - a] = cand_reads[a:b]
            refs_p[:b - a] = refs_g[a:b]
            g_scores[a:b] = gapless.score_no_indels(
                self._dev(reads_p), self._dev(refs_p),
                self.profile).cpu().numpy()[:b - a]
        max_imp = self.profile.max_imperfect_score(L)
        max_sw_q = self.profile.max_quality(L)
        slow = g_scores.astype(np.int64)
        needs_dp = np.zeros(n, bool)
        if self.maxindel > 0:
            # DP only sites that could still win: single-vote chains with a
            # poor gapless score are index noise the reference prunes by
            # quickScore before slow alignment (reference:
            # align2/BBIndex.java prescan/trimByGreedy, BBMapThread
            # scoreSlow minMsaLimit cutoffs)
            plausible = (cs.votes >= 2) | (
                g_scores >= int(max_sw_q * self.min_ratio))
            needs_dp = (g_scores < max_imp) & plausible
        dp_jobs = np.nonzero(needs_dp)[0]
        wstart = cs.start - SLOW_ALIGN_PADDING
        wlen = np.full(n, L + 2 * SLOW_ALIGN_PADDING, np.int64) + \
            _round_up_vec(cs.spread, 64)
        dp_cache: Dict[int, tuple] = {}
        if len(dp_jobs):
            dp_scores = self._dp_score(cand_reads, wstart, wlen, dp_jobs,
                                       L, dp_cache)
            slow = slow.copy()
            slow[dp_jobs] = dp_scores
        return dict(cs=cs, slow=slow, needs_dp=needs_dp, wstart=wstart,
                    wlen=wlen, cand_reads=cand_reads, refs_g=refs_g,
                    idxs=idxs, L=L, dp_cache=dp_cache)

    def _pair_boost(self, g1: dict, g2: dict
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """pairedScore for every cross-pair of mate candidates
        (reference: AbstractMapThread.pairSiteScoresFinal:1919-2070)."""
        cs1, cs2 = g1["cs"], g2["cs"]
        s1, s2 = g1["slow"], g2["slow"]
        L1, L2 = g1["L"], g2["L"]
        B = len(g1["idxs"])
        n1 = np.bincount(cs1.read_idx, minlength=B)
        n2 = np.bincount(cs2.read_idx, minlength=B)
        # candidates are read-sorted; start offset of each read's block
        st1 = np.concatenate([[0], np.cumsum(n1)[:-1]])
        st2 = np.concatenate([[0], np.cumsum(n2)[:-1]])
        cross = n1 * n2
        total = int(cross.sum())
        boost1 = np.zeros(len(cs1.read_idx), np.int64)
        boost2 = np.zeros(len(cs2.read_idx), np.int64)
        if total == 0:
            return boost1, boost2
        cross_read = np.repeat(np.arange(B), cross)
        t = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(cross)[:-1]]), cross)
        j1 = (st1[cross_read] + t // n2[cross_read]).astype(np.int64)
        j2 = (st2[cross_read] + t % n2[cross_read]).astype(np.int64)

        a_start, a_stop = cs1.start[j1], cs1.stop[j1]
        b_start, b_stop = cs2.start[j2], cs2.stop[j2]
        strand1, strand2 = cs1.strand[j1], cs2.strand[j2]
        # same chrom check on flat coords
        ch1 = np.searchsorted(self.chrom_offsets, a_start, "right")
        ch2 = np.searchsorted(self.chrom_offsets, b_start, "right")
        opp = strand1 != strand2
        inner = np.where(strand1 == 0, b_start - a_stop,
                         a_start - b_stop)
        outer = np.where(strand1 == 0, b_stop - a_start,
                         a_stop - b_start)
        # same-strand fallback distances (reference :2000-2016)
        inner_ss = np.where(a_start <= b_start, b_start - a_stop,
                            a_start - b_stop)
        outer_ss = np.where(a_start <= b_start, b_stop - a_start,
                            a_stop - b_start)
        inner = np.where(opp, inner, inner_ss)
        outer = np.where(opp, outer, outer_ss)

        outer_limit = (max(L1, L2) * OUTER_DIST_MULT) // OUTER_DIST_DIV
        ok = ((ch1 == ch2) & (outer >= outer_limit)
              & (inner <= MAX_PAIR_DIST) & opp)
        if not ok.any():
            return boost1, boost2
        apd = int(self.average_pair_dist)
        expected_frag = apd + L1 + L2
        deviation = np.abs(apd - inner)
        mult1 = min(0.5, max(0.25, L1 / (4.0 * L2)))
        mult2 = min(0.5, max(0.25, L2 / (4.0 * L1)))
        denom = max(100, 10 * expected_frag + 100)
        sc1 = s1[j1]
        sc2 = s2[j2]
        p1 = sc1 + 1 + np.maximum(
            1, (sc2 * mult1).astype(np.int64) - (deviation * sc2) // denom)
        p2 = sc2 + 1 + np.maximum(
            1, (sc1 * mult2).astype(np.int64) - (deviation * sc1) // denom)
        # contributor-positivity guard (see pair_boost_device note):
        # a site donates a boost only when its own score is positive
        ok1 = ok & (sc2 > 0)
        ok2 = ok & (sc1 > 0)
        np.maximum.at(boost1, j1[ok1], p1[ok1])
        np.maximum.at(boost2, j2[ok2], p2[ok2])
        return boost1, boost2

    def _select_group(self, g: dict, results: List[MappedRead],
                      boost: Optional[np.ndarray],
                      paired: bool) -> List[tuple]:
        """Vectorized per-read site selection with clearzone ambiguity
        (reference: align2/BBMapThread.java:500-560 unpaired interpolated
        clearzone; :1157-1183 paired stepwise clearzone)."""
        cs = g["cs"]
        slow = g["slow"]
        idxs = g["idxs"]
        L = g["L"]
        n = len(cs)
        scored = slow if boost is None else np.maximum(slow, boost)
        max_sw = self.profile.max_quality(L)
        min_score = int(max_sw * self.min_ratio)
        if paired:
            # reference: MINIMUM_ALIGNMENT_SCORE_RATIO_PAIRED
            # (AbstractMapThread.java:106)
            ratio_paired = max(self.min_ratio * 0.80,
                               1 - (1 - self.min_ratio) * 1.4)
            min_paired = int(max_sw * ratio_paired)
        order = np.lexsort((cs.start, cs.strand, -scored, cs.read_idx))
        r_of = cs.read_idx[order]
        boundaries = np.ones(n, bool)
        boundaries[1:] = r_of[1:] != r_of[:-1]
        first_of = np.nonzero(boundaries)[0]
        best_j = order[first_of]
        best = scored[best_j]
        best_slow = slow[best_j]
        has_second = np.zeros(len(first_of), bool)
        has_second[:-1] = np.diff(first_of) > 1
        if len(first_of):
            has_second[-1] = first_of[-1] + 1 < n
        second = np.where(
            has_second, scored[order[np.minimum(first_of + 1, n - 1)]],
            np.int64(-(2 ** 31)))
        was_boosted = (boost is not None) & (best > best_slow)
        if paired:
            mapped = np.where(was_boosted, best_slow >= min_paired,
                              best_slow >= min_score)
        else:
            mapped = best >= min_score
        perfect = best_slow >= max_sw
        if paired:
            # stepwise clearzone (reference: BBMapThread.java:1157-1160)
            cz1b_lim = max_sw * CZ1B_CUTOFF_SCALE - CZ1B_CUTOFF_FLAT
            cz1c_lim = max_sw * CZ1C_CUTOFF_SCALE - CZ1C_CUTOFF_FLAT
            cz = np.where(perfect, CLEARZONEP,
                          np.where(best >= cz1b_lim, CLEARZONE1,
                                   np.where(best >= cz1c_lim, CLEARZONE1b,
                                            CLEARZONE1c)))
        else:
            cz = self._czvec(best, max_sw, perfect)
        ambiguous = has_second & (best - second < cz)
        good_c = scored[order] >= min_score
        grp = np.cumsum(boundaries) - 1
        n_sites = np.bincount(grp[good_c], minlength=len(first_of))

        winners: List[tuple] = []
        toss = self.ambig_mode == "toss"
        wstart, wlen, needs_dp = g["wstart"], g["wlen"], g["needs_dp"]
        for gi in np.nonzero(mapped)[0]:
            read_global = int(idxs[int(r_of[first_of[gi]])])
            res = results[read_global]
            res.score = int(best[gi])
            res.perfect = bool(perfect[gi])
            res.ambiguous = bool(ambiguous[gi])
            res.n_sites = int(n_sites[gi])
            if res.ambiguous and toss:
                continue
            res.mapped = True
            j = int(best_j[gi])
            res.strand = int(cs.strand[j])
            # provisional coordinates for pair-flag checks; finalize
            # overwrites with traceback-accurate values
            ch = int(np.searchsorted(self.chrom_offsets,
                                     cs.start[j], "right"))
            res.chrom = ch
            res.start = int(cs.start[j]
                            - self.chrom_offsets[ch - 1])
            res.stop = res.start + L - 1
            winners.append((read_global, j, int(wstart[j]),
                            int(wlen[j]), int(best[gi]),
                            bool(needs_dp[j])))
        return winners

    def _set_pair_flags(self, res1, res2, L1: int, L2: int) -> None:
        """canPair on top sites (reference: BBMapThread.java:1188-1200,
        AbstractMapThread.canPair:2098-2130) + running insert average
        update."""
        outer_limit = (max(L1, L2) * OUTER_DIST_MULT) // OUTER_DIST_DIV
        inner_sum = 0
        inner_n = 0
        for r1, r2 in zip(res1, res2):
            if not (r1.mapped and r2.mapped):
                continue
            if r1.chrom != r2.chrom or r1.strand == r2.strand:
                continue
            if r1.strand == 0:
                inner = r2.start - r1.stop
                outer = r2.stop - r1.start
            else:
                inner = r1.start - r2.stop
                outer = r1.stop - r2.start
            if outer >= outer_limit and inner <= MAX_PAIR_DIST:
                r1.paired = r2.paired = True
                inner_sum += max(MIN_PAIR_DIST, min(inner, MAX_PAIR_DIST))
                inner_n += 1
        # cumulative mean insert model + rescue-health counters
        # (reference: BBMapThread.java:1307-1309 DYNAMIC_INSERT_LENGTH;
        # AbstractMapThread.java:1146 rescue cutoff)
        self._mapped_retained += sum(
            1 for r in res1 if r.mapped) + sum(
            1 for r in res2 if r.mapped)
        self._num_mated += 2 * inner_n
        self._inner_sum += inner_sum
        if inner_n and self._num_mated > 2000:  # 1000 pairs (:1307)
            self.average_pair_dist = (
                self._inner_sum * 2.0 / self._num_mated)

    def _dp_score(self, cand_reads: np.ndarray, wstart: np.ndarray,
                  wlen: np.ndarray, dp_jobs: np.ndarray, L: int,
                  dp_cache: Optional[Dict[int, tuple]] = None,
                  score_only: bool = False) -> np.ndarray:
        """Score DP-needing candidates, bucketed by window length.
        score_only skips the traceback walk (half the sequential DP
        steps) — winners are re-aligned with traceback afterwards
        (reference: fillAndScoreLimited scores all sites, traceback runs
        on kept sites only, align2/BBMapThread.java:309-345)."""
        out = np.zeros(len(dp_jobs), np.int64)
        buckets: Dict[int, List[int]] = {}
        for t, j in enumerate(dp_jobs):
            buckets.setdefault(int(wlen[j]), []).append(t)
        launches = []   # (slot list, device output arrays)
        for C, slots in buckets.items():
            max_chunk = DP_SCORE_CHUNK if score_only \
                else _dp_tb_chunk_cap(L, C, self.device)
            # exactly the bucket's jobs: the kernels take any job count
            # (the JAX package pads to a power of two for its program
            # cache)
            for a, b in _fixed_chunks(len(slots), min(max_chunk,
                                                      len(slots))):
                reads = np.empty((b - a, L), np.uint8)
                refs = np.empty((b - a, C), np.uint8)
                for s_i, t in enumerate(slots[a:b]):
                    j = int(dp_jobs[t])
                    reads[s_i] = cand_reads[j]
                    refs[s_i] = self._window(int(wstart[j]), C)
                if score_only:
                    sc, col, st = msa.msa_score_batch(
                        self._dev(reads), self._dev(refs), self.profile)
                    launches.append((slots[a:b], (sc,)))
                else:
                    sym, ln, gaps, sc, col, st = msa.msa_align_batch(
                        self._dev(reads), self._dev(refs), self.profile)
                    launches.append((slots[a:b], (sc, sym, ln, gaps, col)))
        # all chunks dispatched; fetch everything
        fetched = _fetch([a for _, outs in launches for a in outs])
        fi = 0
        for slots_chunk, outs in launches:
            if len(outs) == 1:
                sc = fetched[fi]
                fi += 1
                for s_i, t in enumerate(slots_chunk):
                    out[t] = int(sc[s_i])
                continue
            sc, sym, ln, gaps, col = fetched[fi:fi + 5]
            fi += 5
            for s_i, t in enumerate(slots_chunk):
                out[t] = int(sc[s_i])
                if dp_cache is not None:
                    j = int(dp_jobs[t])
                    dp_cache[j] = (sym[s_i], int(ln[s_i]),
                                   int(gaps[s_i]), int(col[s_i]))
        return out

    def _finalize_winners(self, cand_reads, refs_g, cs, winners, results,
                          L: int, dp_cache: Optional[dict] = None) -> None:
        from . import gapless

        gapless_winners = [w for w in winners if not w[5]]
        dp_winners = [w for w in winners if w[5]]
        if gapless_winners:
            jlist = np.array([w[1] for w in gapless_winners], np.int64)
            matches = gapless.gen_match_no_indels_batch(
                cand_reads[jlist], refs_g[jlist])
            starts_flat = cs.best_diag[jlist]
            chroms = np.searchsorted(self.chrom_offsets, starts_flat,
                                     side="right") - 1
            chroms = np.clip(chroms, 0, len(self.chrom_offsets) - 2)
            locs = starts_flat - self.chrom_offsets[chroms]
            for t, (read_global, j, ws, wl, score, _dp) in enumerate(
                    gapless_winners):
                res = results[read_global]
                res.match = bytes(matches[t])
                res.chrom = int(chroms[t]) + 1
                res.start = int(locs[t])
                res.stop = int(locs[t]) + L - 1
        if dp_winners:
            self._traceback_dp(cand_reads, dp_winners, results, L,
                               dp_cache=dp_cache)

    def _traceback_dp(self, cand_reads, dp_winners, results, L,
                      depth: int = 0, dp_cache: Optional[dict] = None
                      ) -> None:
        """Apply cached device-walked matches for DP winners; re-align
        with a wider window when the alignment is clipped at the window
        edge (reference: align2/AbstractMapThread.java:1012 — extra
        padding of 80+SLOW_ALIGN_PADDING on retry)."""
        retries = []
        uncached = []
        for w, rec in enumerate(dp_winners):
            j = rec[1]
            if depth == 0 and dp_cache is not None and j in dp_cache:
                read_global, j, ws, wl, score, _dp = rec
                sym, ln, gaps, col = dp_cache[j]
                match = msa.finish_match(sym, ln, gaps)
                self._apply_dp_result(results, read_global, j, match, ws,
                                      wl, col, score, retries, depth)
            else:
                uncached.append(w)
        buckets: Dict[int, List[int]] = {}
        for w in uncached:
            buckets.setdefault(dp_winners[w][3], []).append(w)
        launches = []
        for C, idx_list in buckets.items():
            for a, b in _fixed_chunks(len(idx_list), min(
                    _dp_tb_chunk_cap(L, C, self.device), len(idx_list))):
                reads = np.empty((b - a, L), np.uint8)
                refs = np.empty((b - a, C), np.uint8)
                for slot, w in enumerate(idx_list[a:b]):
                    read_global, j, ws, wl, score, _dp = dp_winners[w]
                    reads[slot] = cand_reads[j]
                    refs[slot] = self._window(ws, C)
                sym, ln, gaps, sc, col, st = msa.msa_align_batch(
                    self._dev(reads), self._dev(refs), self.profile)
                launches.append((idx_list[a:b],
                                 (sym, ln, gaps, sc, col)))
        fetched = _fetch([a for _, outs in launches for a in outs])
        fi = 0
        for idx_chunk, _ in launches:
            sym, ln, gaps, sc, col = fetched[fi:fi + 5]
            fi += 5
            for slot, w in enumerate(idx_chunk):
                read_global, j, ws, wl, score, _dp = dp_winners[w]
                match = msa.finish_match(sym[slot], int(ln[slot]),
                                         int(gaps[slot]))
                self._apply_dp_result(results, read_global, j, match,
                                      ws, wl, int(col[slot]),
                                      int(sc[slot]), retries, depth)
        if retries:
            self._traceback_dp(cand_reads, retries, results, L, depth + 1)

    def _apply_dp_result(self, results, read_global, j, match, ws, wl,
                         col, score, retries, depth) -> None:
        """Set final coordinates/match from a traceback, or schedule a
        wider-window retry when the alignment was clipped."""
        clipped_left = match[:1] in (b"I", b"X")
        clipped_right = match[-1:] in (b"I", b"Y")
        if (clipped_left or clipped_right) and depth < 2:
            extra = (80 if self.maxindel > 0 else 20) + SLOW_ALIGN_PADDING
            new_ws = ws - (extra if clipped_left else 0)
            new_wl = wl + extra * (int(clipped_left) + int(clipped_right))
            retries.append((read_global, j, new_ws,
                            _round_up(new_wl, 64), score, True))
            return
        ref_consumed = sum(1 for ch in match if ch in b"mSDN-")
        flat_start = ws + col - ref_consumed
        flat_stop = ws + col - 1
        chrom, loc = self._chrom_of(flat_start)
        res = results[read_global]
        if self.local:
            match, pre, post = samio.to_local_alignment(match)
            loc += pre
            flat_stop -= post
        res.match = match
        res.chrom = chrom
        res.start = loc
        res.stop = loc + (flat_stop - flat_start)
        # a wider retry window may have found a better alignment; take
        # the max of the fill's own score and the selection value — the
        # selection value can carry the pair boost, which the reference
        # KEEPS for the final record (pairedScore is promoted into
        # ss.score and r.mapScore, BBMapThread.java:889-897 +
        # AbstractMapThread.java:205; MAPQ derives from it,
        # SamLine.toMapq:1703). Overwriting with the raw fill score
        # un-boosted every paired DP winner (VERDICT r4 #8).
        res.score = max(score, res.score)


def _fetch(arrs):
    """Device tensors -> host numpy arrays."""
    return [a.cpu().numpy() for a in arrs]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up_vec(x: np.ndarray, m: int) -> np.ndarray:
    return ((x.astype(np.int64) + m - 1) // m) * m


# ---------------------------------------------------------------------------
# SAM emission for a mapped batch
# ---------------------------------------------------------------------------

def emit_sam(genome: Genome, batch: ReadBatch,
             results: List[MappedRead],
             results2: Optional[List[MappedRead]] = None,
             batch2: Optional[ReadBatch] = None) -> List[str]:
    """Build SAM lines for a batch (and its mate batch if paired).
    reference: stream/SamLine.java:82-412 constructor semantics."""
    lines: List[str] = []
    paired_input = results2 is not None
    B = batch.size
    for i in range(B):
        r1, r2 = results[i], (results2[i] if paired_input else None)
        b1, b2 = batch, (batch2 if paired_input else None)
        proper = (r1.paired or _properly_paired(genome, r1, r2)) \
            if paired_input else False
        if proper:
            r1.paired = r2.paired = True
        lines.append(_one_sam_line(genome, b1, i, r1, r2, 0, paired_input,
                                   proper))
        _emit_secondary(genome, b1, i, r1, lines, paired_input, 0)
        if paired_input:
            lines.append(_one_sam_line(genome, b2, i, r2, r1, 1,
                                       paired_input, proper))
            _emit_secondary(genome, b2, i, r2, lines, paired_input, 1)
    return lines


def _emit_secondary(genome, b, i, r, lines, paired_input, fragnum):
    """Secondary alignment lines: flag|0x100 with '*' seq/qual
    (reference: stream/SamLine SECONDARY_ALIGNMENT_ASTERISKS:2427,
    ReadStreamWriter OUTPUT_SAM_SECONDARY_ALIGNMENTS)."""
    if not r.secondary:
        return
    L = int(b.lengths[i])
    qname = b.ids[i].replace("\t", "_")
    for (chrom, start, stop, strand, score, match) in r.secondary:
        scaf, a1 = genome.locate(chrom, start)
        flag = samio.make_flag(True, None, strand, None, paired_input,
                               fragnum, False, secondary=True)
        mapq = samio.to_mapq(score, L, True, False)
        lines.append("\t".join([
            qname, str(flag), scaf.name, str(max(1, a1 + 1)),
            str(mapq), "*", "*", "0", "0", "*", "*"]))


def _properly_paired(genome, r1, r2) -> bool:
    """Innie orientation on the same scaffold within MAX_PAIR_DIST
    (reference: BBMapGuide.txt:70, AbstractMapThread pairing)."""
    if r1 is None or r2 is None or not (r1.mapped and r2.mapped):
        return False
    if r1.chrom != r2.chrom or r1.strand == r2.strand:
        return False
    s1, _ = genome.locate(r1.chrom, r1.start)
    s2, _ = genome.locate(r2.chrom, r2.start)
    if s1.sid != s2.sid:
        return False
    if r1.strand == 0:
        inner = r2.start - r1.stop
    else:
        inner = r1.start - r2.stop
    return inner <= MAX_PAIR_DIST


def _one_sam_line(genome, b, i, r, mate, fragnum, paired_input,
                  proper) -> str:
    L = int(b.lengths[i])
    seq = bytes(b.bases[i, :L])
    qual = None
    if b.quality is not None:
        qual = bytes((b.quality[i, :L].astype(np.int16) + 33)
                     .astype(np.uint8))
    qname = b.ids[i]
    if paired_input and len(qname) > 2:
        c = qname[-2]
        num = ord(qname[-1]) - ord("1")
        if num in (0, 1) and c in (" ", "/"):
            qname = qname[:-2]
    qname = qname.replace("\t", "_")

    flag = samio.make_flag(r.mapped, mate.mapped if mate else None,
                           r.strand, mate.strand if mate else None,
                           paired_input, fragnum, proper)
    rname = "*"
    pos = 0
    cigar = "*"
    mapq = 0
    tags: List[str] = []
    scaf = None
    a1 = b1 = 0
    scaflen = 0
    if r.mapped:
        scaf, a1 = genome.locate(r.chrom, r.start)
        b1 = a1 + (r.stop - r.start)
        scaflen = scaf.length
        rname = scaf.name
        clip = samio.count_leading_clip(r.match or b"")
        clipped_indels = samio.count_leading_indels(a1, r.match)
        pos = max(1, a1 + 1 + clip + clipped_indels)
        mapq = samio.to_mapq(r.score, L, True, r.ambiguous)
        inbounds = a1 >= 0 and b1 < scaflen
        if r.match is not None:
            if (samio.VERSION > 1.3 and inbounds and r.perfect
                    and not r.match.strip(b"m")):
                cigar = f"{L}="
            else:
                cigar = samio.match_to_cigar(r.match, a1, b1, scaflen)
        if r.ambiguous:
            tags.append("XT:A:R")
        if samio.MAKE_XS_TAG and "N" in cigar:
            # spliced-alignment strand (reference:
            # stream/SamLine.makeXSTag:1346-1359 — plus for strand 0,
            # flipped for read 2 and for secondstrand libraries)
            plus = r.strand == 0
            if fragnum != 0:
                plus = not plus
            if samio.XS_SECONDSTRAND:
                plus = not plus
            tags.append("XS:A:+" if plus else "XS:A:-")
        if samio.MAKE_MD_TAG and r.match is not None:
            # call bases in reference orientation (the match string's
            # frame; reference passes r.bases post-mapping)
            call = seq if r.strand == 0 else samio.revcomp_bytes(seq)
            tags.append(samio.make_md_tag(
                r.match, call, genome.chroms[r.chrom - 1], r.start,
                r.start - a1, scaflen))
        if samio.MAKE_NM_TAG and r.match is not None:
            nm = 0 if r.perfect else samio.calc_nm(r.match, cigar, L)
            tags.append(f"NM:i:{nm}")
        if samio.MAKE_AM_TAG:
            if mate is None:
                am = mapq
            elif mate.mapped:
                am = min(mapq, max(1, mate.score // max(1, L)))
            else:
                am = 0
            tags.append(f"AM:i:{am}")

    # mate fields
    rnext = "*"
    pnext = 0
    tlen = 0
    if paired_input and mate is not None:
        mate_scaf = None
        pos0_mate = 0
        if mate.mapped:
            mate_scaf, a2 = genome.locate(mate.chrom, mate.start)
            clip2 = samio.count_leading_clip(mate.match or b"")
            ci2 = samio.count_leading_indels(a2, mate.match)
            pos0_mate = max(1, a2 + 1 + clip2 + ci2)
        if r.mapped and mate.mapped:
            same = scaf is not None and mate_scaf is not None and \
                scaf.sid == mate_scaf.sid
            rnext = "=" if same else (mate_scaf.name if mate_scaf else "*")
            pnext = pos0_mate
            if same:
                # reference: tlen = 1 + (max(pos1, pos1_mate) -
                # min(pos0, pos0_mate)) in 1-based coords
                # (stream/SamLine.java:228-232)
                pos1 = a1 + 1 + (r.stop - r.start)
                pos1_mate = a2 + 1 + (mate.stop - mate.start)
                tlen = 1 + max(pos1, pos1_mate) - min(pos, pnext)
                # sign (reference: stream/SamLine.java:345-352)
                r_start_flat = (r.chrom, r.start)
                m_start_flat = (mate.chrom, mate.start)
                if (r_start_flat < m_start_flat or
                        (r_start_flat == m_start_flat and fragnum == 0)):
                    pass
                else:
                    tlen = -tlen
        elif r.mapped and not mate.mapped:
            rnext = "="
            pnext = pos
        elif not r.mapped and mate.mapped:
            rname_m = mate_scaf.name if mate_scaf else "*"
            rnext = "="
            pos = pos0_mate
            pnext = pos0_mate
            rname = rname_m
    return samio.SamRecord(
        qname=qname, flag=flag, rname=rname, pos=pos, mapq=mapq,
        cigar=cigar, rnext=rnext, pnext=pnext, tlen=tlen, seq=seq,
        qual=qual, tags=tags).to_line()
