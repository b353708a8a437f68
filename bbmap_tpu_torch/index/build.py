"""Dense k-mer index: CSR (starts, sites) arrays over the packed genome.

The reference's Block layout (reference: align2/Block.java:15, int[] starts
of size 4^k+1 + int[] sites) is already the ideal HBM layout, so we keep it:
``starts[key] .. starts[key+1]`` delimits the sorted site list of a k-mer.
Unlike the reference (per-block chrom<<SHIFT|site packing,
align2/BBIndex.java:3038), sites here are flat positions into the single
concatenated genome code array; chrom/scaffold translation happens on host
via the genome offsets table. Build is a radix histogram + exclusive scan +
stable sort (reference: align2/IndexMaker4.java:100-240 count/prefix/fill
passes, collapsed into numpy/XLA primitives).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.bases import N_CODE
from ..core.genome import Genome


@dataclass
class KmerIndex:
    k: int
    starts: np.ndarray       # int64 [4^k + 1]
    sites: np.ndarray        # int32 [n_sites] flat genome positions
    genome_codes: np.ndarray  # uint8 packed genome (0..3, 4=N)
    chrom_offsets: np.ndarray  # int64 [n_chroms + 1]
    counts_canonical: Optional[np.ndarray] = None  # int32 [4^k], key+rc hits
    max_usable_length: int = 1 << 30  # list-length exclusion threshold
    max_usable_length2: int = 1 << 30  # staged re-admission threshold
    # (reference: BBIndex.MAX_USABLE_LENGTH2, find:421-440)
    # greedy-trim limits (reference: BBIndex.java:276-281 + Solver):
    length_histogram: Optional[np.ndarray] = None  # int64 [1001]
    limit_avg: int = 20
    limit_avg2: int = 20
    limit_shortest: int = 20
    points_per_site: int = -50

    @property
    def n_keys(self) -> int:
        return 4 ** self.k

    def list_length(self, key: int) -> int:
        return int(self.starts[key + 1] - self.starts[key])

    def get_sites(self, key: int) -> np.ndarray:
        return self.sites[self.starts[key]:self.starts[key + 1]]


def rolling_keys(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All k-mer keys over a code array (big-endian 2-bit packing, matching
    reference ChromosomeArray.toNumber, dna/ChromosomeArray.java:297-307).
    Returns (keys int64 [n-k+1], valid bool)."""
    n = len(codes)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    m = n - k + 1
    keys = np.zeros(m, np.int64)
    invalid = np.zeros(m, bool)
    c = codes.astype(np.int64)
    for j in range(k):
        col = c[j:m + j]
        keys = (keys << 2) | (col & 3)
        invalid |= col >= N_CODE
    return keys, ~invalid


def reverse_complement_key(keys: np.ndarray, k: int) -> np.ndarray:
    """rc of 2-bit packed keys (reference:
    dna/AminoAcid.reverseComplementBinaryFast). Complement is bitwise NOT
    (A=00<->T=11, C=01<->G=10); base order reverses by reversing 2-bit
    groups — done branch-free with swap/byteswap so it vectorizes over
    arbitrarily large key arrays (needed for whole-keyspace analysis)."""
    scalar = np.isscalar(keys) or np.ndim(keys) == 0
    x = (~np.asarray(keys, np.int64)).astype(np.uint64)
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | \
        ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | \
        ((x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F))
    x = x.byteswap()  # reverse the 8 bytes of each 64-bit value
    x = x >> np.uint64(64 - 2 * k)
    out = x.astype(np.int64)
    return int(out) if scalar else out


MODULO = 9  # reference: align2/IndexMaker4.java:335 (usemodulo keep rate)


def build_index(genome: Genome, k: int = 13,
                usemodulo: bool = False) -> KmerIndex:
    """Count -> prefix-sum -> stable-sort scatter
    (reference: align2/IndexMaker4.java:155-240).

    usemodulo: low-memory mode keeping only keys where key%9==0 or
    rc(key)%9==0 (reference: align2/IndexMaker4.java:335,522-523 — must
    be set at both index and map time; the map side needs no change
    here because absent keys simply yield empty site lists)."""
    codes, offsets = genome.packed_codes()
    keys, valid = rolling_keys(codes, k)
    if usemodulo:
        rc = reverse_complement_key(keys.astype(np.int64), k)
        valid = valid & ((keys % MODULO == 0) | (rc % MODULO == 0))
    pos = np.nonzero(valid)[0]
    vkeys = keys[valid]
    n_keys = 4 ** k
    counts = np.bincount(vkeys, minlength=n_keys)
    starts = np.zeros(n_keys + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(vkeys, kind="stable")
    sites = pos[order].astype(np.int32)
    return KmerIndex(k=k, starts=starts, sites=sites, genome_codes=codes,
                     chrom_offsets=offsets)


# reference: align2/BBIndex.java:3243-3251, AbstractIndex.java:141
SMALL_GENOME_LIST = 20
CLUMPY_MAX_DIST = 5
CLUMPY_MIN_LENGTH_INDEX = 2000
CLUMPY_FRACTION = 0.75
DOUBLE_SEARCH_THRESH_MULT = 0.25
HIST_BUCKETS = 1000


def shard_bounds(G: int, chrom_offsets: np.ndarray,
                 n_shards: int) -> np.ndarray:
    """Genome-block boundaries for index sharding: equal flat splits
    snapped STRICTLY to chrom boundaries — the reference packs whole
    chromosomes per block (align2/IndexMaker4.java CHROMS_PER_BLOCK),
    and that invariant is what guarantees no candidate chain ever
    straddles a block (chroms are separated by >= 8000 N pad, far wider
    than the chain window, so seed sites cannot chain across; a
    mid-chrom split was observed to split a straddling chain into two
    half-vote candidates and flip a read to ambiguous). Genomes that
    need sharding are the >HBM ones, which naturally span many chroms
    (the genome packer caps chroms at ~536 Mbp). Raises ValueError when
    the genome has fewer chroms than shards. Deterministic: every host
    computes the same bounds."""
    offs = np.asarray(chrom_offsets, np.int64)
    interior = offs[1:-1]
    if len(interior) < n_shards - 1:
        raise ValueError(
            f"cannot shard the index {n_shards} ways: the genome has "
            f"{len(interior) + 1} chrom block(s); shard boundaries "
            f"must align to chrom boundaries (reference "
            f"CHROMS_PER_BLOCK semantics). Re-pack with a smaller "
            f"maxchromlen or use fewer shards.")
    raw = np.linspace(0, G, n_shards + 1).astype(np.int64)
    snapped = raw.copy()
    used = set()
    for i in range(1, n_shards):
        order = np.argsort(np.abs(interior - raw[i]))
        for j in order:
            if j not in used:
                used.add(int(j))
                snapped[i] = interior[j]
                break
    snapped[1:n_shards] = np.sort(snapped[1:n_shards])
    if len(np.unique(snapped)) != n_shards + 1:
        raise ValueError("cannot shard: degenerate chrom-aligned "
                         f"bounds {snapped}")
    return snapped


def build_index_shard(genome: Genome, k: int, shard_id: int,
                      n_shards: int, usemodulo: bool = False,
                      bounds: Optional[np.ndarray] = None):
    """Build ONLY this host's genome-block shard of the CSR index
    (cross-host index sharding, BASELINE config 4; reference P4:
    align2/BBIndex.java:616-642 per-block sub-indexes +
    stream/ConcurrentReadInputStreamD.java:157 rank ownership —
    SURVEY §5.8). The k-mer scan covers the whole genome (cheap, one
    pass) so the GLOBAL per-key counts — which drive frequency
    exclusion, staged re-admission, and greedy trimming — are exact
    without any cross-host communication; only the sites array (the
    dominant ~4-5 bytes/base tenant) is restricted to
    [bounds[shard_id], bounds[shard_id+1]).

    Returns (local KmerIndex, counts_global int64 [4^k], bounds).
    Pass counts_global to analyze_index(lengths_global=...) so the
    analysis decisions are bit-identical to a full-index build
    (tests/test_crosshost_shard.py)."""
    codes, offsets = genome.packed_codes()
    keys, valid = rolling_keys(codes, k)
    if usemodulo:
        rc = reverse_complement_key(keys.astype(np.int64), k)
        valid = valid & ((keys % MODULO == 0) | (rc % MODULO == 0))
    pos = np.nonzero(valid)[0]
    vkeys = keys[valid]
    n_keys = 4 ** k
    counts_global = np.bincount(vkeys, minlength=n_keys)
    if bounds is None:
        bounds = shard_bounds(len(codes), offsets, n_shards)
    lo, hi = int(bounds[shard_id]), int(bounds[shard_id + 1])
    sel = (pos >= lo) & (pos < hi)
    lk = vkeys[sel]
    lpos = pos[sel]
    counts_l = np.bincount(lk, minlength=n_keys)
    starts = np.zeros(n_keys + 1, np.int64)
    np.cumsum(counts_l, out=starts[1:])
    order = np.argsort(lk, kind="stable")
    sites = lpos[order].astype(np.int32)
    idx = KmerIndex(k=k, starts=starts, sites=sites,
                    genome_codes=codes, chrom_offsets=offsets)
    # clumpy analysis needs the GLOBAL site list of its few candidate
    # keys; recover them from the whole-genome scan (exact, no comm)
    idx._global_sites_fn = lambda kk: pos[vkeys == kk]
    return idx, counts_global.astype(np.int64), bounds


def analyze_index(index: KmerIndex,
                  fraction_to_exclude: float = 0.03,
                  remove_clumpy: bool = True,
                  lengths_global: Optional[np.ndarray] = None) -> None:
    """Frequency analysis (reference: align2/BBIndex.analyzeIndex:101-191):

    1. canonical (key + rc summed) per-key site counts
    2. clumpy-key removal: keys whose site list is long (>2000 canonical)
       and >=75% tandem (consecutive sites within 5 bp) are zeroed — both
       the key and its rc (reference: :125-169); here the CSR arrays are
       compacted so every consumer sees the exclusion
    3. SITE-weighted length histogram with 1000 quantile buckets
       (reference: Tools.makeLengthHistogram3/4:1797-1852 — the quantile
       is over genome positions, NOT distinct keys) ->
       MAX_USABLE_LENGTH = max(2*SMALL_GENOME_LIST, hist[(1-f)*1000])
       (reference: :176-184) with the re-admission threshold
       MAX_USABLE_LENGTH2 likewise.

    ``lengths_global``: cross-host sharded mode (build_index_shard) —
    the index holds only its genome-block sites, but every analysis
    decision (exclusion quantiles, canonical COUNTS, clumpy removal,
    Solver limits) must follow the GLOBAL per-key counts so all hosts
    agree bit-for-bit with a full-index build; clumpy site inspection
    then reads the global lists via the shard's ``_global_sites_fn``.
    """
    sharded_mode = lengths_global is not None
    lengths = lengths_global if sharded_mode else np.diff(index.starts)
    if sharded_mode:
        gs_fn = getattr(index, "_global_sites_fn", None)
        assert gs_fn is not None, \
            "lengths_global requires a build_index_shard index"
    else:
        gs_fn = lambda kk: index.sites[
            index.starts[kk]:index.starts[kk + 1]]
    nzk = np.nonzero(lengths)[0]
    if len(nzk) == 0:
        index.max_usable_length = 1 << 30
        return
    rc_nzk = reverse_complement_key(nzk, index.k)
    canon_nzk = (lengths[nzk] + lengths[rc_nzk]).astype(np.int64)

    if remove_clumpy:
        # only canonical lists > 2000 are candidates — enumerate them and
        # check tandemness directly on their (sorted) site slices
        cand = nzk[canon_nzk > CLUMPY_MIN_LENGTH_INDEX]
        drop = set()
        for key in cand:
            key = int(key)
            if key in drop:
                continue
            rk = int(reverse_complement_key(key, index.k))
            clumps = 0
            ln = 0
            for kk in {key, rk}:
                s = gs_fn(kk)
                if len(s) > 1:
                    d = np.diff(s.astype(np.int64))
                    clumps += int(((d > 0) & (d <= CLUMPY_MAX_DIST)).sum())
                ln += len(s)
            if ln > CLUMPY_MIN_LENGTH_INDEX and \
                    clumps > CLUMPY_FRACTION * ln:
                drop.add(key)
                drop.add(rk)
        if drop:
            keep = np.ones(len(index.sites), bool)
            for key in drop:
                keep[index.starts[key]:index.starts[key + 1]] = False
            new_counts = np.diff(index.starts).copy()
            for key in drop:
                new_counts[key] = 0
            index.sites = index.sites[keep]
            starts = np.zeros(len(index.starts), np.int64)
            np.cumsum(new_counts, out=starts[1:])
            index.starts = starts
            # compaction invalidates any device-resident mirrors (the
            # device index build seeds them pre-analysis)
            for attr in ("_device_arrays", "_scnt_array"):
                if hasattr(index, attr):
                    delattr(index, attr)
            if sharded_mode:
                lengths = lengths_global.copy()
                for key in drop:
                    lengths[key] = 0
            else:
                lengths = np.diff(index.starts)
            nzk = np.nonzero(lengths)[0]
            if len(nzk) == 0:
                index.max_usable_length = 1 << 30
                return
            rc_nzk = reverse_complement_key(nzk, index.k)
            canon_nzk = (lengths[nzk] + lengths[rc_nzk]).astype(np.int64)

    # canonical values live on every key of each (key, rc) pair in the
    # reference's COUNTS array; reproduce the same multiset over the
    # union of present keys and their rcs (zero-length keys whose rc is
    # present carry the pair's canonical value too)
    all_keys = np.unique(np.concatenate([nzk, rc_nzk]))
    rc_all = reverse_complement_key(all_keys, index.k)
    canon = (lengths[all_keys] + lengths[rc_all]).astype(np.int64)

    # site-weighted histogram: cum[l] = total weight of lists <= l
    nkeys_by_len = np.bincount(canon)
    w = nkeys_by_len * np.arange(len(nkeys_by_len), dtype=np.int64)
    cum = np.cumsum(w)
    total = int(cum[-1])
    bucket_idx = np.arange(HIST_BUCKETS, dtype=np.int64)
    limits = (total * bucket_idx + HIST_BUCKETS // 2) // HIST_BUCKETS
    hist = np.searchsorted(cum, limits, side="left")
    hist = np.append(hist, len(nkeys_by_len) - 1)

    if fraction_to_exclude > 0:
        i1 = int((1 - fraction_to_exclude) * HIST_BUCKETS)
        i2 = int((1 - fraction_to_exclude * DOUBLE_SEARCH_THRESH_MULT)
                 * HIST_BUCKETS)
        index.max_usable_length = max(2 * SMALL_GENOME_LIST,
                                      int(hist[i1]))
        index.max_usable_length2 = max(6 * SMALL_GENOME_LIST,
                                       int(hist[i2]))
    else:
        # no frequency exclusion on small genomes, but the reference
        # still builds COUNTS + the greedy-trim limits below
        index.max_usable_length = 1 << 30
        index.max_usable_length2 = 1 << 30

    # full canonical COUNTS table + Solver/greedy-trim limits
    # (reference: AbstractIndex.COUNTS, BBIndex.java:176-191 +
    # setFractionToExclude:3214-3221) — consumed by the reference-
    # faithful key-retention path (align/search_oracle.py and the
    # device admission)
    counts = np.zeros(index.n_keys, np.int32)
    counts[all_keys] = np.minimum(canon, 2 ** 31 - 1)
    counts[rc_all] = counts[all_keys]
    index.counts_canonical = counts
    index.length_histogram = hist.astype(np.int64)
    f = fraction_to_exclude
    idx_avg = int(1000 * (1 - 2.3 * f))
    idx_avg2 = int(1000 * (1 - 1.4 * f))
    idx_short = int(1000 * (1 - 2.8 * f))
    index.limit_avg = max(SMALL_GENOME_LIST, int(hist[idx_avg]))
    index.limit_avg2 = max(SMALL_GENOME_LIST, int(hist[idx_avg2]))
    index.limit_shortest = max(SMALL_GENOME_LIST, int(hist[idx_short]))
    # Solver.POINTS_PER_SITE (reference: BBIndex.java:187)
    index.points_per_site = int(np.floor(
        (-50 * 4000.0) / max(2 * SMALL_GENOME_LIST,
                             float(hist[idx_avg]))))


def set_fraction_to_exclude(genome_bases: int) -> float:
    """Genome-size-scaled exclusion fraction
    (reference: align2/BBMap.java:365-380 — larger genomes exclude a larger
    share of the busiest k-mers)."""
    g = genome_bases
    if g < 3_000_000:
        return 0.0
    if g < 30_000_000:
        return 0.01
    if g < 100_000_000:
        return 0.02
    if g < 1_000_000_000:
        return 0.03
    return 0.05


def save_index(index: KmerIndex, path: str) -> None:
    np.savez_compressed(
        path, k=index.k, starts=index.starts, sites=index.sites,
        genome_codes=index.genome_codes, chrom_offsets=index.chrom_offsets,
        counts_canonical=(index.counts_canonical
                          if index.counts_canonical is not None
                          else np.zeros(0, np.int32)),
        max_usable_length=index.max_usable_length,
        max_usable_length2=index.max_usable_length2,
        length_histogram=(index.length_histogram
                          if index.length_histogram is not None
                          else np.zeros(0, np.int64)),
        limits=np.array([index.limit_avg, index.limit_avg2,
                         index.limit_shortest, index.points_per_site],
                        np.int64))


def load_index(path: str) -> KmerIndex:
    z = np.load(path)
    cc = z["counts_canonical"]
    out = KmerIndex(
        k=int(z["k"]), starts=z["starts"], sites=z["sites"],
        genome_codes=z["genome_codes"], chrom_offsets=z["chrom_offsets"],
        counts_canonical=cc if len(cc) else None,
        max_usable_length=int(z["max_usable_length"]))
    if "max_usable_length2" in z:
        out.max_usable_length2 = int(z["max_usable_length2"])
    if "length_histogram" in z and len(z["length_histogram"]):
        out.length_histogram = z["length_histogram"]
    if "limits" in z:
        (out.limit_avg, out.limit_avg2, out.limit_shortest,
         out.points_per_site) = [int(v) for v in z["limits"]]
    return out
