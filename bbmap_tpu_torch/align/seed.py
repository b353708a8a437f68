"""Seeding: key offsets, key lookup, site gathering, and diagonal chaining.

Candidate-site generation replacing the reference's heap-merge walk
(reference: align2/BBIndex.java find:403 / slowWalk2:855 and
align2/KeyRing.java). Instead of a k-way heap merge of sorted per-key site
lists, all (site - offset) diagonals are collected and sorted, and runs
within ±chain window become candidate sites with vote counts — same
candidate set, array-friendly construction.

Round-1 notes:
- offsets use the density ladder of quickMap (reference:
  align2/AbstractMapThread.java:663-676) with even spacing
  (KeyRing.makeOffsetsWithNumberOfKeys); the quality-probability offset
  shifting of makeOffsets3 is not yet reproduced.
- chaining window is capped (reference chains to ±MAX_INDEL=16000 with
  gap-compressed DP; long-indel gap compression lands with the PacBio
  stack).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.bases import BASE_TO_NUMBER
from ..index.build import KmerIndex, reverse_complement_key

# reference defaults (align2/BBMap.java:44-63)
KEY_DENSITY = 1.9
MAX_KEY_DENSITY = 3.0
MIN_KEY_DENSITY = 1.5
MAX_DESIRED_KEYS = 15


def desired_keys_from_density(readlen: int, k: int, density: float,
                              min_keys: int) -> int:
    """reference: align2/KeyRing.desiredKeysFromDensity:271-283."""
    slots = readlen - k + 1
    desired = int(np.ceil((readlen * density) / k))
    desired = max(min_keys, desired)
    return min(slots, desired)


def make_offsets_with_number_of_keys(readlen: int, k: int,
                                     max_keys: int) -> Optional[np.ndarray]:
    """reference: align2/KeyRing.makeOffsetsWithNumberOfKeys:186-246."""
    if k > readlen:
        return None
    slots = readlen - k + 1
    if slots == 1 or max_keys == 1:
        return np.array([slots // 2], np.int32)
    if slots == 2 or max_keys == 2:
        return np.array([0, slots - 1], np.int32)
    if slots == 3 or max_keys == 3:
        return np.array([0, slots // 2, slots - 1], np.int32)
    midslots = slots - 2
    max_keys = min(max_keys, slots)
    middles = min(max_keys - 2, midslots)
    fspacing = max(1.0, midslots / np.float32(middles + 1.0))
    offsets = np.zeros(middles + 2, np.int32)
    offsets[-1] = slots - 1
    for i in range(1, middles + 1):
        # Java Math.round on float
        offsets[i] = int(np.floor(np.float32(fspacing) * i + 0.5))
    if middles > 2:
        offsets[1] = int(fspacing)
        offsets[middles] = int(np.ceil(fspacing * middles))
    return offsets


def key_density_ladder(readlen: int, k: int) -> Tuple[float, float]:
    """(keyDen2, keyDen3) — reference:
    align2/AbstractMapThread.java:663-676."""
    key_den2 = (MAX_DESIRED_KEYS * k) / float(readlen)
    key_den2 = max(MIN_KEY_DENSITY, key_den2)
    key_den2 = min(KEY_DENSITY, key_den2, float(k))
    if readlen <= 50:
        key_den3 = MAX_KEY_DENSITY
    elif readlen >= 200:
        key_den3 = MAX_KEY_DENSITY - 0.5
    else:
        key_den3 = MAX_KEY_DENSITY - 0.003333333333 * (readlen - 50)
    key_den3 = max(KEY_DENSITY, key_den3)
    key_den3 = min(float(k), key_den3)
    return key_den2, key_den3


def make_offsets(readlen: int, k: int) -> Optional[np.ndarray]:
    key_den2, _ = key_density_ladder(readlen, k)
    desired = desired_keys_from_density(readlen, k, key_den2, 2)
    return make_offsets_with_number_of_keys(readlen, k, desired)


# ---------------------------------------------------------------------------
# Quality-probability key selection
# (reference: align2/QualityTools.makeKeyProbs:188-247 +
#  align2/KeyRing.makeOffsets3:396-506)
# ---------------------------------------------------------------------------

# PROB_ERROR[q] = 10^(-q/10) with the q=0 slot pinned to 0.8
# (reference: align2/QualityTools.makeQualityToFloat:519-527)
PROB_ERROR = (10.0 ** (-np.arange(128) / 10.0)).astype(np.float32)
PROB_ERROR[0] = np.float32(0.8)
PROB_CORRECT = (1.0 - PROB_ERROR).astype(np.float32)


def make_key_probs(quality: np.ndarray, keylen: int) -> np.ndarray:
    """Per-offset key error probability: 1 - prod(PROB_CORRECT[q]) over
    the key window; any window containing a q==0 base (N) is forced to
    1.0 (reference: QualityTools.makeKeyProbs:188-218, timeSinceZero
    handling)."""
    q = np.asarray(quality, np.int64)
    L = len(q)
    m = L - keylen + 1
    if m <= 0:
        return np.empty(0, np.float32)
    pc = PROB_CORRECT[np.clip(q, 0, 127)]
    win = np.lib.stride_tricks.sliding_window_view(pc, keylen)
    probs = (1.0 - win.prod(axis=1)).astype(np.float32)
    haszero = np.lib.stride_tricks.sliding_window_view(
        q == 0, keylen).any(axis=1)
    probs[haszero] = 1.0
    return probs


def make_offsets3(key_error_prob: np.ndarray, readlen: int, k: int,
                  density: float, max_density: float, min_keys: int,
                  semiperfect: bool = False) -> Optional[np.ndarray]:
    """Quality-aware offset selection: trim hopeless read ends, then
    space desiredKeys across the usable region, nudging each offset off
    positions whose key error probability exceeds errorLimit2
    (reference: align2/KeyRing.makeOffsets3:396-506; search order —
    exact slot, then backward to prev+2, then forward within the
    interval, :459-474)."""
    max_prob_index = readlen - k
    left, right = 0, max_prob_index
    error_limit2 = 0.9999
    error_limit1 = 0.99 if semiperfect else 0.94
    p = key_error_prob
    while left <= right and p[left] >= error_limit1:
        left += 1
    while right >= left and p[right] >= error_limit1:
        right -= 1
    if right < left:
        return None
    potential = int((p[left:right + 1] < error_limit2).sum())
    if potential == 0:
        return None
    usable = right - left + k
    desired = desired_keys_from_density(readlen, k, density, min_keys)
    if usable < readlen:
        desired = min(desired, desired_keys_from_density(
            usable, k, max_density, min_keys))
    desired = min(desired, potential)
    offsets = np.full(desired, -1, np.int64)
    # float32 arithmetic like the Java (KeyRing.java: 'float interval',
    # 'float f') — keeps the host and the device quickmap's
    # quality_offsets_stage bit-identical
    interval = np.float32(right - left) / np.float32(max(desired - 1, 1))
    interval_int = int(interval) + 1
    f = np.float32(left)
    prev = -1
    misses = 0
    j = left
    for i in range(desired):
        x = -1
        if prev < j:
            if p[j] < error_limit2 and (prev < 0 or j - prev > 0):
                x = j
            else:
                kk = j - 1
                lim = prev + 2
                while kk > lim:
                    if p[kk] < error_limit2:
                        x = kk
                        break
                    kk -= 1
                if x < 0:
                    kk = j + 1
                    lim = min(j + interval_int, right)
                    while kk < lim:
                        if p[kk] < error_limit2:
                            x = kk
                            break
                        kk += 1
        offsets[i] = x
        if x > -1:
            prev = x
        else:
            misses += 1
            prev = max(prev, j - 2)
        f = np.float32(f + interval)
        j = min(max_prob_index,
                max(j + 1, int(np.floor(np.float32(f + np.float32(0.5))))))
    if misses > 0:
        offsets = offsets[offsets >= 0]
    if len(offsets) == 0:
        return None
    return offsets.astype(np.int32)


def make_offsets_quality(quality: np.ndarray, readlen: int,
                         k: int) -> Optional[np.ndarray]:
    """Quality-aware version of make_offsets (the host seeding entry:
    reference AbstractMapThread calls KeyRing.makeOffsets3 with the
    density ladder, align2/AbstractMapThread.java:663-700)."""
    key_den2, key_den3 = key_density_ladder(readlen, k)
    probs = make_key_probs(quality, k)
    off = make_offsets3(probs, readlen, k, key_den2, key_den3, 2)
    if off is None:
        return make_offsets(readlen, k)
    return off


def keys_at_offsets(bases_row: np.ndarray, offsets: np.ndarray,
                    k: int) -> np.ndarray:
    """2-bit big-endian keys at each offset; -1 where a key spans an
    undefined base (reference: ChromosomeArray.toNumber)."""
    keys = np.zeros(len(offsets), np.int64)
    bad = np.zeros(len(offsets), bool)
    for j in range(k):
        c = BASE_TO_NUMBER[bases_row[offsets + j]].astype(np.int64)
        bad |= c < 0
        keys = (keys << 2) | (c & 3)
    keys[bad] = -1
    return keys


@dataclass
class Candidate:
    """A chained candidate site (the reference's SiteScore skeleton,
    stream/SiteScore.java:21)."""
    read_idx: int
    strand: int         # 0 plus, 1 minus
    start: int          # flat genome position of expected read base 0
    stop: int           # flat genome position of expected read end
    votes: int          # approx hit count (quickScore proxy)
    spread: int         # diagonal spread within the chain (indel extent)


def gather_candidates(index: KmerIndex, offsets: np.ndarray,
                      keys_p: np.ndarray, read_len: int, read_idx: int,
                      chain_dist: int = 400,
                      max_list_length: Optional[int] = None,
                      max_candidates: int = 16) -> List[Candidate]:
    """Chain index hits on both strands for one read.

    Minus-strand handling per the reference: look up the rc of each key;
    a minus hit at site s with key offset o corresponds to the rc-read
    starting at s - (read_len - (o + k)) (reference:
    align2/KeyRing.reverseOffsets:125-137).
    """
    k = index.k
    if max_list_length is None:
        max_list_length = index.max_usable_length
    cands: List[Candidate] = []
    starts = index.starts
    sites = index.sites
    for strand in (0, 1):
        if strand == 0:
            kk = keys_p
            off_adj = offsets
        else:
            kk = reverse_complement_key(keys_p, k)
            off_adj = read_len - (offsets + k)  # rc-read offset of same key
        diags = []
        votes_w = []
        for i in range(len(kk)):
            key = int(kk[i])
            if key < 0:
                continue
            s0, s1 = starts[key], starts[key + 1]
            n = s1 - s0
            if n == 0 or n > max_list_length:
                continue
            site_list = sites[s0:s1]
            diags.append(site_list.astype(np.int64) - int(off_adj[i]))
            votes_w.append(np.full(n, i, np.int32))
        if not diags:
            continue
        dall = np.concatenate(diags)
        kidx = np.concatenate(votes_w)
        order = np.argsort(dall, kind="stable")
        dall = dall[order]
        kidx = kidx[order]
        # split chains where consecutive diagonals differ by > chain_dist
        breaks = np.nonzero(np.diff(dall) > chain_dist)[0]
        seg_starts = np.concatenate([[0], breaks + 1])
        seg_ends = np.concatenate([breaks + 1, [len(dall)]])
        for a, b in zip(seg_starts, seg_ends):
            seg_d = dall[a:b]
            votes = len(np.unique(kidx[a:b]))
            start = int(seg_d[0])
            spread = int(seg_d[-1] - seg_d[0])
            cands.append(Candidate(
                read_idx=read_idx, strand=strand, start=start,
                stop=int(seg_d[-1]) + read_len - 1, votes=votes,
                spread=spread))
    cands.sort(key=lambda c: (-c.votes, c.strand, c.start))
    return cands[:max_candidates]


# ---------------------------------------------------------------------------
# Vectorized whole-batch seeding (numpy) — no per-read Python loops.
# Same candidate semantics as gather_candidates, built from flat arrays:
# CSR expansion of per-key site lists -> lexsort by (read, strand, diagonal)
# -> chain segmentation -> per-chain votes and majority diagonal.
# ---------------------------------------------------------------------------

@dataclass
class CandidateSet:
    """Columnar candidate table for one uniform-length read batch."""
    read_idx: np.ndarray    # (n,) int32
    strand: np.ndarray      # (n,) int8
    start: np.ndarray       # (n,) int64 min diagonal (chain start)
    stop: np.ndarray        # (n,) int64 max diag + read_len - 1
    votes: np.ndarray       # (n,) int32 distinct seed offsets in chain
    spread: np.ndarray      # (n,) int32 diagonal spread
    best_diag: np.ndarray   # (n,) int64 majority diagonal (gapless start)

    def __len__(self):
        return len(self.read_idx)


def keys_batch(bases: np.ndarray, offsets: np.ndarray, k: int) -> np.ndarray:
    """(B, L) ASCII -> (B, nk) int64 keys, -1 where undefined.
    offsets may be (nk,) shared or (B, nk) per-read."""
    B = bases.shape[0]
    if offsets.ndim == 1:
        nk = len(offsets)
        keys = np.zeros((B, nk), np.int64)
        bad = np.zeros((B, nk), bool)
        for j in range(k):
            c = BASE_TO_NUMBER[bases[:, offsets + j]].astype(np.int64)
            bad |= c < 0
            keys = (keys << 2) | (c & 3)
        keys[bad] = -1
        return keys
    nk = offsets.shape[1]
    rows = np.arange(B)[:, None]
    safe = np.maximum(offsets, 0)
    keys = np.zeros((B, nk), np.int64)
    bad = offsets < 0
    for j in range(k):
        c = BASE_TO_NUMBER[bases[rows, safe + j]].astype(np.int64)
        bad |= c < 0
        keys = (keys << 2) | (c & 3)
    keys[bad] = -1
    return keys


def quality_offsets_batch(quality: np.ndarray, read_len: int, k: int,
                          default: np.ndarray) -> np.ndarray:
    """Per-read key offsets honoring quality (reference:
    AbstractMapThread seeds each read via KeyRing.makeOffsets3 with its
    quality-derived key error probabilities, :663-700). Reads whose
    default-offset windows are all confidently callable keep the shared
    default offsets; only degraded reads recompute. Returns (B, nk)
    int64 with -1 marking unused slots."""
    B = quality.shape[0]
    nk = len(default)
    out = np.broadcast_to(default.astype(np.int64), (B, nk)).copy()
    q = quality[:, :read_len]
    # a read needs per-read offsets iff some default key window contains
    # a q==0 base or its error prob crosses errorLimit1 (0.94)
    pc = PROB_CORRECT[np.clip(q, 0, 127)]
    win_log = np.log(np.maximum(pc, 1e-30))
    cs = np.concatenate([np.zeros((B, 1)), np.cumsum(win_log, 1)], 1)
    win_prob = 1.0 - np.exp(cs[:, default + k] - cs[:, default])
    haszero = np.zeros((B, nk), bool)
    iszero = q == 0
    cz = np.concatenate([np.zeros((B, 1), int),
                         np.cumsum(iszero, 1)], 1)
    haszero = (cz[:, default + k] - cz[:, default]) > 0
    degraded = (haszero | (win_prob >= 0.94)).any(axis=1)
    for i in np.nonzero(degraded)[0]:
        off = make_offsets_quality(q[i], read_len, k)
        if off is None:
            continue
        row = np.full(nk, -1, np.int64)
        m = min(nk, len(off))
        row[:m] = off[:m]
        out[i] = row
    return out


def gather_candidates_batch(index: KmerIndex, bases: np.ndarray,
                            read_len: int,
                            chain_dist: int = 400,
                            max_candidates: int = 16,
                            max_list_length: Optional[int] = None,
                            quality: Optional[np.ndarray] = None
                            ) -> Optional[CandidateSet]:
    """Candidates for a whole batch of uniform-length reads. When
    `quality` is given, degraded reads get per-read quality-aware
    offsets (reference: KeyRing.makeOffsets3 via AbstractMapThread)."""
    k = index.k
    B = bases.shape[0]
    if max_list_length is None:
        max_list_length = index.max_usable_length
    offsets = make_offsets(read_len, k)
    if offsets is None:
        return None
    nk = len(offsets)
    if quality is not None and quality.shape[1] >= read_len:
        off2d = quality_offsets_batch(quality, read_len, k, offsets)
    else:
        off2d = np.broadcast_to(offsets.astype(np.int64), (B, nk))
    kp = keys_batch(bases, off2d, k)                     # (B, nk)
    km = reverse_complement_key(np.where(kp < 0, 0, kp), k)
    km[kp < 0] = -1
    off_safe = np.where(off2d < 0, 0, off2d).astype(np.int64)
    off_p = off_safe
    off_m = read_len - (off_safe + k)

    keys_all = np.stack([kp, km], axis=1)                # (B, 2, nk)
    offadj = np.stack([off_p, off_m], axis=1)
    valid = keys_all >= 0
    safe_keys = np.where(valid, keys_all, 0)
    s0 = index.starts[safe_keys]
    cnt = (index.starts[safe_keys + 1] - s0)
    cnt = np.where(valid & (cnt <= max_list_length), cnt, 0).astype(np.int64)

    flat_cnt = cnt.ravel()
    total = int(flat_cnt.sum())
    if total == 0:
        return None
    flat_s0 = s0.ravel()
    flat_off = offadj.ravel()
    # CSR expansion: element e of the H hits belongs to flat slot
    # slot_of[e], with rank r = e - first_of_slot
    reps = flat_cnt
    slot_of = np.repeat(np.arange(len(reps)), reps)
    first = np.concatenate([[0], np.cumsum(reps)[:-1]])
    rank = np.arange(total) - first[slot_of]
    site = index.sites[flat_s0[slot_of] + rank].astype(np.int64)
    diag = site - flat_off[slot_of]
    hit_read = (slot_of // (2 * nk)).astype(np.int64)
    hit_strand = ((slot_of // nk) % 2).astype(np.int8)
    hit_key = (slot_of % nk).astype(np.int32)

    order = np.lexsort((diag, hit_strand, hit_read))
    diag = diag[order]
    hit_read = hit_read[order]
    hit_strand = hit_strand[order]
    hit_key = hit_key[order]

    new_chain = np.ones(total, bool)
    if total > 1:
        same_group = (hit_read[1:] == hit_read[:-1]) & \
            (hit_strand[1:] == hit_strand[:-1])
        new_chain[1:] = (~same_group) | (np.diff(diag) > chain_dist)
    chain_id = np.cumsum(new_chain) - 1
    n_chains = int(chain_id[-1]) + 1

    c_first = np.nonzero(new_chain)[0]
    c_last = np.concatenate([c_first[1:] - 1, [total - 1]])
    c_start = diag[c_first]
    c_stop_diag = diag[c_last]
    c_read = hit_read[c_first]
    c_strand = hit_strand[c_first]

    # votes: distinct key offsets per chain
    vorder = np.lexsort((hit_key, chain_id))
    vk = hit_key[vorder]
    vc = chain_id[vorder]
    vnew = np.ones(total, bool)
    vnew[1:] = (vc[1:] != vc[:-1]) | (vk[1:] != vk[:-1])
    votes = np.bincount(vc[vnew], minlength=n_chains).astype(np.int32)

    # majority diagonal per chain (hits already diag-sorted within chain)
    dnew = np.ones(total, bool)
    dnew[1:] = new_chain[1:] | (diag[1:] != diag[:-1])
    dfirst = np.nonzero(dnew)[0]
    dcount = np.diff(np.concatenate([dfirst, [total]]))
    dchain = chain_id[dfirst]
    # first max within each chain: stable order by (chain, -count)
    morder = np.lexsort((dfirst, -dcount, dchain))
    mchain = dchain[morder]
    mfirstflag = np.ones(len(morder), bool)
    mfirstflag[1:] = mchain[1:] != mchain[:-1]
    best_diag = np.zeros(n_chains, np.int64)
    best_diag[mchain[mfirstflag]] = diag[dfirst[morder[mfirstflag]]]

    # cap candidates per read: rank chains by (read, -votes, strand, start)
    corder = np.lexsort((c_start, c_strand, -votes, c_read))
    cr = c_read[corder]
    rnew = np.ones(n_chains, bool)
    rnew[1:] = cr[1:] != cr[:-1]
    rfirst = np.zeros(n_chains, np.int64)
    rfirst[np.nonzero(rnew)[0]] = np.nonzero(rnew)[0]
    np.maximum.accumulate(rfirst, out=rfirst)
    rrank = np.arange(n_chains) - rfirst
    keep = corder[rrank < max_candidates]

    return CandidateSet(
        read_idx=c_read[keep].astype(np.int32),
        strand=c_strand[keep],
        start=c_start[keep],
        stop=c_stop_diag[keep] + read_len - 1,
        votes=votes[keep],
        spread=(c_stop_diag[keep] - c_start[keep]).astype(np.int32),
        best_diag=best_diag[keep])
