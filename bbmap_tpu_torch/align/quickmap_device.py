"""Device quickmap: seeding -> chaining -> gapless scoring -> best site,
as PyTorch tensor code on one device.

Port of ``bbmap_tpu/align/quickmap_device.py`` (reference:
align2/AbstractMapThread.quickMap:643 + align2/BBIndex.find:403). The CSR
index (starts/sites, or the packed ``start << 8 | count`` table), the
canonical counts and the 2-bit packed genome live on the device as the
buffers of a :class:`DeviceIndex`; a batch of reads flows through

1. key extraction at the seed offsets (both strands)
2. bounded site-list gather with over-long-list exclusion and staged
   re-admission (or the reference-faithful retention of
   ``_ref_retention``, on the card one launch of ``ref_retention_kernel``),
   packed into a per-(read, strand) slot budget (on the card one launch
   of ``slot_pack_kernel``)
3. diagonal sort + chain segmentation + distinct-offset votes + modal
   diagonal (``_sort_rows``, ``_chain_segments``)
4. top-K candidates per read (``_candidate_table``; steps 3-4 on the
   card one launch of ``chain_candidates_kernel``)
5. gapless streak scoring of every candidate at its modal diagonal (on
   the card one launch of ``gapless_scores_kernel``) and best/second
   selection.

Bit-exactness notes. torch has no shifts on uint32, so packed words are
held in int64 (genome words, key reversal) or as int32 bit patterns
decoded with masks (the ``scnt`` table). Gathers clamp their indices and
mask the result explicitly where the JAX package relied on clamped or
dropped out-of-range accesses. Ties follow the JAX package: stable sorts
everywhere, and ``lax.top_k``'s lower-index-first rule through a stable
descending sort. Float32 steps stay separate eager ops in the JAX order.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from . import seed as seed_host
from ..core import constants as K
from ..index.build import KmerIndex

from ..backend import DeviceLike, resolve_device
from ..ops import _build
from .gapless import _points, score_match_sub_vec

MAX_SITES_CAP = 32     # upper bound on the adaptive per-key site-list cap
SLOT_BUDGET = 64       # total site slots per (read, strand)
MAX_CANDIDATES = 8
I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
BIG = 2 ** 30

# ASCII -> 2-bit code, undefined -> 4
_B2C = np.full(256, 4, np.uint8)
for _i, _ch in enumerate("ACGT"):
    _B2C[ord(_ch)] = _i
    _B2C[ord(_ch.lower())] = _i
_B2C[ord("U")] = 3
_B2C[ord("u")] = 3

# match-symbol 2-bit codes: 0=m 1=S 2=N
_SYM_TABLE = np.frombuffer(b"mSNN", np.uint8)

N_META = 7  # best_score, best_diag, best_strand, best_start, best_spread,
#             second_score, n_good
N_CFIELD = 5  # scores, diag, strand, start, spread


def pack_genome_2bit(codes: np.ndarray):
    """uint8 code array (0..3, 4=N) -> (gpack uint32 16 bases/word,
    nmask uint32 32 bases/word), both padded."""
    G = len(codes)
    nw = (G + 15) // 16 + 2
    c = np.minimum(codes, 3).astype(np.uint32)
    cpad = np.zeros(nw * 16, np.uint32)
    cpad[:G] = c
    shifts = (2 * np.arange(16, dtype=np.uint32))
    gpack = (cpad.reshape(nw, 16) << shifts[None, :]).sum(
        axis=1, dtype=np.uint32)
    nwn = (G + 31) // 32 + 2
    nbit = (codes > 3).astype(np.uint32)
    npad = np.zeros(nwn * 32, np.uint32)
    npad[:G] = nbit
    bshift = np.arange(32, dtype=np.uint32)
    nmask = (npad.reshape(nwn, 32) << bshift[None, :]).sum(
        axis=1, dtype=np.uint32)
    return gpack, nmask


class DeviceIndex(nn.Module):
    """The device-resident index: CSR arrays, the packed
    ``start << 8 | min(count, 255)`` table (stored as the int32 bit
    pattern of the uint32 word), canonical counts, the 2-bit packed
    genome and its N mask (uint32 words held in int64), and the chrom
    offsets — all registered buffers. Host-side facts the programs need
    (genome length, whether the genome has N bases, the longest list)
    are plain attributes. Replaces the JAX package's ``device_arrays`` /
    ``scnt_array`` / ``ccnt_array`` caches on the KmerIndex: the CSR and
    the packed genome that ``index/build_device.build_index_device`` left
    on the index (``_device_arrays``) are taken as they are when they lie
    on this device (``seeded`` says so), else uploaded."""

    def __init__(self, index: KmerIndex, device: DeviceLike):
        super().__init__()
        dev = resolve_device(device)
        self.index = index
        self.k = index.k
        self.G = len(index.genome_codes)
        self.has_n = bool(np.any(index.genome_codes > 3))
        self.max_list = int(np.diff(index.starts).max()) \
            if len(index.sites) else 1

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        seeded = getattr(index, "_device_arrays", None)
        self.seeded = seeded is not None and seeded[0].device == dev
        if self.seeded:
            starts, sites, gpack, nmask, _G = seeded
        else:
            gpack, nmask = (put(a.astype(np.int64))
                            for a in pack_genome_2bit(index.genome_codes))
            starts = put(index.starts.astype(np.int32))
            sites = put(index.sites.astype(np.int32))
        self.register_buffer("starts", starts)
        self.register_buffer("sites", sites)
        self.register_buffer("gpack", gpack)
        self.register_buffer("nmask", nmask)
        scnt = None
        if len(index.sites) < (1 << 24):
            st = index.starts.astype(np.int64)
            cnt8 = np.minimum(np.diff(st), 255).astype(np.uint32)
            packed = (st[:-1].astype(np.uint32) << np.uint32(8)) | cnt8
            scnt = put(packed.view(np.int32))
        self.register_buffer("scnt", scnt)
        ccnt = None
        if index.counts_canonical is not None:
            ccnt = put(index.counts_canonical.astype(np.int32))
        self.register_buffer("ccnt", ccnt)
        self.register_buffer("chrom_offsets",
                             put(np.asarray(index.chrom_offsets, np.int32)))

    @property
    def device(self) -> torch.device:
        return self.gpack.device


def extract_ref_codes(gpack: torch.Tensor, nmask: torch.Tensor,
                      base: torch.Tensor, L: int, G: int,
                      has_n: bool = True):
    """Gather L consecutive genome codes starting at flat position
    ``base`` (any leading shape; may be out of range). Returns (codes
    uint8 (..., L) in 0..3, is_n bool (..., L) — N or out of bounds).
    Codes at out-of-bounds positions are unspecified; callers mask them
    with is_n, as in the JAX package."""
    pos = base.to(I64)[..., None] + torch.arange(L, dtype=I64,
                                                 device=base.device)
    oob = (pos < 0) | (pos >= G)
    widx = (pos >> 4).clamp(0, gpack.shape[0] - 1)
    codes = ((gpack[widx] >> ((pos & 15) * 2)) & 3).to(torch.uint8)
    if not has_n:
        return codes, oob
    nidx = (pos >> 5).clamp(0, nmask.shape[0] - 1)
    nbits = ((nmask[nidx] >> (pos & 31)) & 1).bool()
    return codes, nbits | oob


def ascii_to_codes(bases: torch.Tensor) -> torch.Tensor:
    """(..., L) ASCII -> 2-bit codes 0..3 (A0 C1 G2 T3), 4 otherwise."""
    c = bases.to(I32)
    x = (c >> 1) & 3
    x = x ^ (x >> 1)
    ok = (c == 65) | (c == 67) | (c == 71) | (c == 84) \
        | (c == 97) | (c == 99) | (c == 103) | (c == 116) \
        | (c == 85) | (c == 117)
    return torch.where(ok, x, 4).to(torch.uint8)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (JAX int32 wraps)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(I32)


def _keys_all_positions(codes: torch.Tensor, k: int, L: int):
    """(B, L) 2-bit codes -> (B, L-k+1) int32 keys, -1 where the window
    holds an undefined base."""
    m = L - k + 1
    ci = codes.to(I64)
    keys = torch.zeros((codes.shape[0], m), dtype=I64, device=codes.device)
    bad = torch.zeros((codes.shape[0], m), dtype=torch.bool,
                      device=codes.device)
    for j in range(k):
        c = ci[:, j:m + j]
        bad |= c > 3
        keys = (keys << 2) | torch.where(c > 3, 0, c)
    return torch.where(bad, -1, _wrap32(keys)).to(I32)


def _keys_from_codes(codes, offsets_list, k, L):
    keys_all = _keys_all_positions(codes, k, L)
    off = torch.as_tensor(np.asarray(offsets_list, np.int64),
                          device=codes.device)
    return keys_all[:, off]


def _rc_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of k-mer keys (uint32 arithmetic held in int64)."""
    x = (~keys.to(I64)) & 0xFFFFFFFF
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0000FFFF) << 16) | (x >> 16)
    x = x >> (32 - 2 * k)
    return _wrap32(x)


class QuickmapRun:
    """Result of a quickmap dispatch; ``host()`` copies it to numpy and
    unpacks it into the result dict (keys as the JAX package's)."""

    def __init__(self, out_i32: torch.Tensor, best_sym: torch.Tensor,
                 L: int):
        self._out_i32 = out_i32
        self._best_sym = best_sym
        self._L = L

    def host(self) -> Dict[str, np.ndarray]:
        m = self._out_i32.cpu().numpy()
        sym = self._best_sym.cpu().numpy()
        B = m.shape[0]
        C = MAX_CANDIDATES
        d = {
            "best_score": m[:, 0],
            "best_diag": m[:, 1],
            "best_strand": m[:, 2],
            "best_start": m[:, 3],
            "best_spread": m[:, 4],
            "second_score": m[:, 5],
            "n_good": m[:, 6],
        }
        cand = m[:, N_META:].reshape(B, N_CFIELD, C)
        d["cand_scores"] = cand[:, 0]
        d["cand_diag"] = cand[:, 1]
        d["cand_strand"] = cand[:, 2]
        d["cand_start"] = cand[:, 3]
        d["cand_spread"] = cand[:, 4]
        d["best_match"] = _SYM_TABLE[sym][:, :self._L]
        return d


class QmConfig(NamedTuple):
    """Static quickmap configuration (the JAX package's QmConfig)."""
    k: int
    L: int
    S: int
    chain_dist: int
    min_score: int
    offsets_list: tuple
    G: int
    profile: object = None
    has_n: bool = True
    ref_admit: bool = False
    max_usable_length: int = 1 << 30
    slot_budget: int = 64
    limit_avg: int = 20
    limit_avg2: int = 20
    limit_shortest: int = 20
    points_per_site: int = -50


def make_config(dindex: DeviceIndex, L: int, chain_dist: int = 400,
                min_ratio: float = 0.56,
                max_list_length: Optional[int] = None,
                profile=None) -> QmConfig:
    index = dindex.index
    k = index.k
    offsets_np = seed_host.make_offsets(L, k)
    if offsets_np is None:
        raise ValueError(f"read length {L} < k {k}")
    if max_list_length is None:
        max_list_length = min(index.max_usable_length, MAX_SITES_CAP,
                              max(dindex.max_list, 1))
    slot_budget = SLOT_BUDGET if L <= 600 else 512
    S = int(max(2, min(max_list_length, MAX_SITES_CAP, slot_budget)))
    max_sw = profile.max_quality(L) if profile is not None \
        else K.max_quality(L)
    ref_admit = (index.counts_canonical is not None
                 and os.environ.get("BBMAP_REF_ADMIT", "1")
                 not in ("0", "false", "off"))
    return QmConfig(k=k, L=L, S=S, chain_dist=chain_dist,
                    min_score=int(max_sw * min_ratio),
                    offsets_list=tuple(int(o) for o in offsets_np),
                    G=dindex.G, profile=profile,
                    has_n=dindex.has_n, ref_admit=ref_admit,
                    max_usable_length=int(index.max_usable_length),
                    limit_avg=int(index.limit_avg),
                    limit_avg2=int(index.limit_avg2),
                    limit_shortest=int(index.limit_shortest),
                    points_per_site=int(index.points_per_site),
                    slot_budget=slot_budget)


EARLY_TERMINATION_SCORE = -100000   # Solver.java:232


def hi_budget(R2: int) -> int:
    """Two-tier slot-gather upper-half row budget (module-level so tests
    can force the overflow path)."""
    return min(R2, max(256, -(-R2 // 8) // 256 * 256))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """argmax of a bool row (first True; 0 when none), as jnp.argmax."""
    return torch.argmax(mask.to(torch.uint8), dim=1).to(I32)


def _ref_retention(cfg: QmConfig, kp, off_p, ccnt, weights=None):
    """Reference-faithful key retention per read on the plus-strand
    layout: staged re-admission on canonical counts, then the
    Solver-weighted greedy hit-list trim (port of
    quickmap_device._ref_retention; oracle: align/search_oracle.py).
    Returns alive (B, nk) bool."""
    dev = kp.device
    B, nk = kp.shape
    valid = kp >= 0
    maxLen = cfg.max_usable_length
    slot = torch.arange(nk, dtype=I32, device=dev)[None, :]
    pos = ccnt > 0

    tiers = tuple(min(t, 2 ** 31 - 1)
                  for t in (maxLen, (maxLen * 3) // 2, maxLen * 2,
                            maxLen * 3, maxLen * 5))
    hit = [valid & pos & (ccnt < t) for t in tiers]
    n = [torch.sum(h.to(I32), dim=1, dtype=I32) for h in hit]
    trig = (3 * nk) // 4
    gate = n[0] > 0
    sel = torch.zeros_like(n[0])
    num = n[0]
    for t, need in ((1, 4), (2, 3), (3, 3), (4, 2)):
        esc = gate & (num < need) & (num < trig)
        sel = torch.where(esc, t, sel)
        num = torch.where(esc, n[t], num)
    adm = hit[0]
    for t in range(1, 5):
        adm = torch.where((sel == t)[:, None], hit[t], adm)

    if weights is not None:
        # position r holds the weight of the r-th ADMITTED slot (a pure
        # reorder: admitted slots first, in slot order)
        order = torch.argsort((~adm).to(I32), dim=1, stable=True)
        weights = torch.gather(weights, 1, order)

    lengths0 = torch.where(adm, ccnt, 0)
    initial = torch.sum((lengths0 > 0).to(I32), dim=1, dtype=I32)
    total0 = torch.sum(lengths0, dim=1, dtype=I32)
    shortest = torch.min(torch.where(lengths0 > 0, lengths0, BIG), dim=1
                         ).values
    limit3 = max(20, cfg.limit_shortest)
    kill = (initial >= 1) & (shortest > limit3)
    alive = adm & ~kill[:, None]
    limit = max(20, cfg.limit_avg) * initial
    limit2 = max(20, cfg.limit_avg2)
    max_lists = torch.clamp(
        (torch.tensor(0.85, dtype=F32, device=dev)
         * initial.to(F32)).to(I32), min=6)
    first_adm = _first_true(adm)
    last_adm = (nk - 1) - _first_true(adm.flip(1))
    off_last = torch.gather(off_p, 1, last_adm[:, None].long())[:, 0]
    pps = cfg.points_per_site
    vm_cap = (2 ** 30) // max(1, -pps)
    chunk = cfg.k
    hits = torch.where(kill, 0, initial).to(I32)
    total = torch.where(kill, 0, total0).to(I32)
    active = ~kill & (initial >= 1)
    ar = torch.arange(nk, dtype=I32, device=dev)

    while bool(active.any()):
        l_ = torch.where(alive, ccnt, 0)
        numl = torch.clamp(hits, min=1)[:, None]
        prevoff = torch.cummax(torch.where(alive, off_p, -1), dim=1).values
        offL = torch.cat([torch.full((B, 1), -1, dtype=I32, device=dev),
                          prevoff[:, :-1]], dim=1)
        nxt = torch.cummin(torch.where(alive, off_p, BIG).flip(1),
                           dim=1).values.flip(1)
        offR_next = torch.cat([nxt[:, 1:],
                               torch.full((B, 1), BIG, dtype=I32,
                                          device=dev)], dim=1)
        is_first = alive & (offL == -1)
        is_last = alive & (offR_next == BIG)
        offR = torch.where(is_last, off_last[:, None] + 1, offR_next)
        lsafe = torch.clamp(l_, min=1)
        vp = (30000 + torch.div(60000, numl, rounding_mode="floor")
              + torch.div(300000, lsafe, rounding_mode="floor"))
        vp = vp + torch.where((slot == first_adm[:, None])
                              | (slot == last_adm[:, None]), 40000, 0)
        oldL = off_p - offL
        oldR = offR - off_p
        newS = offR - offL
        space = ((oldL * oldL + oldR * oldR) - newS * newS) * (-30)
        uc = torch.where(
            is_first, offR - off_p,
            torch.where(is_last, off_p - offL,
                        torch.clamp(offR - (offL + chunk), min=0)))
        tail = torch.where(is_first | is_last, 11500 * uc, 6000 * uc)
        vp_final = torch.where(numl == 1, vp + 11500 * chunk,
                               vp + space + tail).to(I32)
        if weights is None:
            vpw = vp_final
        else:
            # weight by LIST position (alive rank) — reference quirk
            rank = torch.cumsum(alive.to(I32), dim=1, dtype=I32) - 1
            rclip = torch.clamp(rank, 0, nk - 1)
            w = torch.gather(weights, 1, rclip.long())
            vpw = (vp_final.to(F32) * w).to(I32)
        value = vpw + pps * torch.clamp(l_, max=vm_cap)
        vals = torch.where(alive, value, BIG).to(I32)
        runmin = torch.cummin(vals, dim=1).values
        runmin_before = torch.cat(
            [torch.full((B, 1), BIG, dtype=I32, device=dev),
             runmin[:, :-1]], dim=1)
        is_new = alive & (vals < runmin_before)
        first_alive = _first_true(alive)
        trigm = is_new & (runmin_before < EARLY_TERMINATION_SCORE) \
            & (slot != first_alive[:, None])
        trig_any = trigm.any(dim=1)
        first_trig = _first_true(trigm)
        gmin = torch.argmin(vals, dim=1).to(I32)
        worst = torch.where(trig_any, first_trig, gmin)
        wl = worst[:, None].long()
        worst_value = torch.gather(vals, 1, wl)[:, 0]
        worst_len = torch.gather(l_, 1, wl)[:, 0]
        cond = active & (hits >= 1) & (
            (total > limit)
            | (torch.div(total, torch.clamp(initial, min=1),
                         rounding_mode="floor") > limit2)
            | (hits > max_lists))
        stop_now = (worst_value > 0) | (worst_len < 20)
        do_remove = cond & ~stop_now
        total = torch.where(cond, total - worst_len, total)
        alive = alive & ~(do_remove[:, None] & (ar[None, :] == worst[:, None]))
        hits = torch.where(do_remove, hits - 1, hits)
        active = do_remove
    return alive


def _retention_lib() -> ctypes.CDLL:
    lib = _build.load("ref_retention")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ref_retention_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ctypes.POINTER(ci), ci, ci, ci, ci, ci,
            ci, ci, vp, vp]
        lib.ref_retention_launch.restype = ci
        lib._bbmap_typed = True
    return lib


def ref_retention_kernel(cfg: QmConfig, kp: torch.Tensor,
                         off_p: torch.Tensor, ccnt: torch.Tensor,
                         weights: Optional[torch.Tensor] = None):
    """Key retention of B reads (``_ref_retention``'s function): kp, off_p,
    ccnt (B, nk) int32, weights (B, nk) float32 or None. Returns alive
    (B, nk) bool. CPU tensors: the plain version (``_ref_retention``).
    CUDA tensors: one launch of ``csrc/ref_retention.cu``, no host sync; a
    failed launch raises (past 227 KB of shared memory a block, nk ~
    3,400, as cudaErrorInvalidValue)."""
    B, nk = kp.shape
    for name, t in (("off_p", off_p), ("ccnt", ccnt), ("weights", weights)):
        if t is not None and t.shape != (B, nk):
            raise ValueError(f"{name} {tuple(t.shape)} against kp "
                             f"{(B, nk)}")
    if kp.dtype != I32 or off_p.dtype != I32 or ccnt.dtype != I32:
        raise TypeError("kp, off_p and ccnt must be int32")
    if weights is not None and weights.dtype != F32:
        raise TypeError("weights must be float32")
    if any(t is not None and t.device != kp.device
           for t in (off_p, ccnt, weights)):
        raise ValueError("the operands must share one device")
    if kp.device.type == "cpu":
        return _ref_retention(cfg, kp, off_p, ccnt, weights)
    if kp.device.type != "cuda":
        raise RuntimeError(f"the retention kernel runs on CUDA tensors "
                           f"(got {kp.device})")
    alive = torch.empty((B, nk), dtype=torch.bool, device=kp.device)
    if B == 0:
        return alive
    lib = _retention_lib()
    kp, off_p, ccnt = kp.contiguous(), off_p.contiguous(), ccnt.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    maxLen = cfg.max_usable_length
    tiers = (ctypes.c_int * 5)(*(min(t, 2 ** 31 - 1) for t in (
        maxLen, (maxLen * 3) // 2, maxLen * 2, maxLen * 3, maxLen * 5)))
    pps = cfg.points_per_site
    err = lib.ref_retention_launch(
        kp.data_ptr(), off_p.data_ptr(), ccnt.data_ptr(),
        None if weights is None else weights.data_ptr(), B, nk, tiers,
        (3 * nk) // 4, max(20, cfg.limit_shortest), max(20, cfg.limit_avg),
        max(20, cfg.limit_avg2), pps, (2 ** 30) // max(1, -pps), cfg.k,
        alive.data_ptr(), torch.cuda.current_stream(kp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ref_retention_launch failed: cudaError {err}")
    ref_retention_kernel.launches += 1
    return alive


def quality_offsets_stage(cfg: QmConfig, qual: torch.Tensor,
                          density: float, max_density: float,
                          return_weights: bool = False):
    """Quality-probability key selection (port of
    quickmap_device.quality_offsets_stage; reference:
    QualityTools.makeKeyProbs + KeyRing.makeOffsets3, float32).
    qual: (B, L) int8 phred."""
    q = torch.clamp(qual.to(I32), 0, 127)
    pc_tab = torch.as_tensor(seed_host.PROB_CORRECT.astype(np.float32),
                             device=qual.device)
    pc = pc_tab[q.long()]
    out = quality_offsets_kernel(cfg, q, pc, density, max_density)
    return out if return_weights else out[0]


def pack_quality_host(quality: np.ndarray, L: int):
    """(B, >=L) int8 phred -> (qpack (B, ceil(L/8)) uint32 [8 nibbles
    per word], palette (16,) int32, pcpal (16,) float32) when the batch
    has <= 16 distinct quality values, else (None, None, None)."""
    q = np.clip(quality[:, :L], 0, 127).astype(np.uint8)
    pal = np.unique(q)
    if len(pal) > 16:
        return None, None, None
    B = q.shape[0]
    pal16 = np.zeros(16, np.uint8)
    pal16[:len(pal)] = pal
    lut = np.zeros(128, np.uint8)
    lut[pal] = np.arange(len(pal), dtype=np.uint8)
    qi = lut[q]
    W8 = (L + 7) // 8
    pad = np.zeros((B, W8 * 8), np.uint8)
    pad[:, :L] = qi
    n8 = pad[:, 0::2] | (pad[:, 1::2] << 4)
    qpack = np.ascontiguousarray(n8).view(np.uint32)
    pcpal = seed_host.PROB_CORRECT[pal16]
    return qpack, pal16.astype(np.int32), pcpal.astype(np.float32)


def unpack_quality_device(qpack: torch.Tensor, palette: torch.Tensor,
                          pcpal: torch.Tensor, L: int):
    """Inverse of pack_quality_host. qpack: (B, W8) uint32 words held in
    int64. Returns (q (B, L) int32, pc (B, L) float32)."""
    B = qpack.shape[0]
    nibs = torch.stack([(qpack >> (4 * s)) & 15 for s in range(8)],
                       dim=2)
    qi = nibs.reshape(B, -1)[:, :L]
    q = palette.to(I32)[qi]
    pc = pcpal.to(F32)[qi]
    return q, pc


def quality_offsets_stage_packed(cfg: QmConfig, qpack, palette, pcpal,
                                 density: float, max_density: float,
                                 return_weights: bool = False):
    q, pc = unpack_quality_device(qpack, palette, pcpal, cfg.L)
    out = quality_offsets_kernel(cfg, q, pc, density, max_density)
    return out if return_weights else out[0]


def _offset_tables_np(L: int, k: int, nk: int, max_density: float):
    """The two divisions of the quality offsets as host tables, exactly as
    the JAX package resolves them: d2_tab (L + 1,) int32 = ceil(u *
    max_density / k) in float64, div_tab (m, nk) float32 = span /
    max(desired - 1, 1) in true float32 division."""
    m = L - k + 1
    d2_tab = np.ceil(np.arange(L + 1, dtype=np.float64) * float(max_density)
                     / float(k)).astype(np.int32)
    div_tab = (np.arange(m, dtype=np.float32)[:, None]
               / np.maximum(np.arange(nk, dtype=np.float32)[None, :],
                            np.float32(1.0))).astype(np.float32)
    return d2_tab, div_tab


def _quality_offsets_core(cfg: QmConfig, q, pc, density: float,
                          max_density: float, return_weights: bool = False):
    """Plain version of ``quality_offsets_kernel``: keyProbs, the
    makeOffsets3 ladder a step at a time over the batch, and with
    ``return_weights`` the Solver weights and the reject flag."""
    dev = q.device
    k, L = cfg.k, cfg.L
    m = L - k + 1
    nk = len(cfg.offsets_list)
    B = q.shape[0]

    def f32(x):
        return torch.tensor(x, dtype=F32, device=dev)

    prob = pc[:, 0:m]
    for j in range(1, k):
        prob = prob * pc[:, j:m + j]
    probs = f32(1.0) - prob
    z = q == 0
    haszero = z[:, 0:m]
    for j in range(1, k):
        haszero = haszero | z[:, j:m + j]
    probs = torch.where(haszero, f32(1.0), probs)

    l1 = f32(0.94)
    l2 = f32(0.9999)
    idx = torch.arange(m, dtype=I32, device=dev)[None, :]
    ok1 = probs < l1
    ok2 = probs < l2
    any1 = ok1.any(dim=1)
    left = _first_true(ok1)
    right = (m - 1) - _first_true(ok1.flip(1))
    inwin = (idx >= left[:, None]) & (idx <= right[:, None])
    potential = torch.sum((inwin & ok2).to(I32), dim=1, dtype=I32)
    valid_read = any1 & (potential > 0) & (right >= left)
    usable = right - left + k
    slots_u = usable - k + 1
    d2_np, div_np = _offset_tables_np(L, k, nk, max_density)
    d2_tab = torch.as_tensor(d2_np, device=dev)
    d2 = d2_tab[torch.clamp(usable, 0, L).long()]
    d2 = torch.minimum(slots_u, torch.clamp(d2, min=2))
    desired = torch.where(usable < L, torch.clamp(d2, max=nk),
                          torch.full_like(d2, nk))
    desired = torch.clamp(torch.minimum(desired, potential), min=1)
    span = torch.clamp(right - left, 0, m - 1)
    dm1 = torch.clamp(desired - 1, 0, nk - 1)
    interval = torch.as_tensor(div_np.ravel(), device=dev)[
        (span * nk + dm1).long()]
    interval_int = interval.to(I32) + 1

    offs = []
    f = left.to(F32)
    prev = torch.full((B,), -1, dtype=I32, device=dev)
    j = left
    big_m = m + 9
    for i in range(nk):
        active = (i < desired) & valid_read
        pj = torch.gather(probs, 1, torch.clamp(j, 0, m - 1)[:, None].long()
                          )[:, 0]
        condA = pj < l2
        mb = ok2 & (idx > (prev + 2)[:, None]) & (idx <= (j - 1)[:, None])
        xb = torch.max(torch.where(mb, idx, -1), dim=1).values.to(I32)
        lim = torch.minimum(j + interval_int, right)
        mc = ok2 & (idx >= (j + 1)[:, None]) & (idx < lim[:, None])
        xc = torch.min(torch.where(mc, idx, big_m), dim=1).values.to(I32)
        xc = torch.where(xc >= big_m, -1, xc)
        x = torch.where(condA, j, torch.where(xb >= 0, xb, xc))
        x = torch.where(active & (prev < j), x, -1).to(I32)
        offs.append(x)
        hit = x > -1
        prev = torch.where(active, torch.where(hit, x,
                                               torch.maximum(prev, j - 2)),
                           prev)
        f = torch.where(active, f + interval, f)
        fl = torch.floor(f + f32(0.5)).to(I32)
        j = torch.where(active,
                        torch.clamp(torch.maximum(j + 1, fl), max=m - 1),
                        j).to(I32)
    offsets = torch.stack(offs, dim=1)
    ladder = torch.as_tensor(np.asarray(cfg.offsets_list, np.int32),
                             device=dev)
    out_off = torch.where(valid_read[:, None], offsets,
                          ladder[None, :].expand(B, nk))
    if not return_weights:
        return out_off
    active = out_off > -1
    clip_off = torch.clamp(out_off, 0, m - 1)
    psel = torch.gather(probs, 1, clip_off.long())
    psel = torch.where(active, psel, f32(1.0))
    a = 100 * k
    base_ks = a // 8
    rng_i = a - base_ks
    t = f32(float(rng_i)) * (f32(1.0) - psel)
    score = base_ks + torch.floor(t + f32(0.5)).to(I32)
    inv = f32(float(np.float32(1.0) / np.float32(a)))
    wts = score.to(F32) * inv
    pmask = torch.where(active, psel, f32(1.0))
    pae = pmask[:, 0]
    for i in range(1, nk):
        pae = pae * pmask[:, i]
    reject = valid_read & (pae > f32(0.5))
    return out_off, wts, reject


# keyProbs thresholds (ok1, ok2), float32 as the plain version holds them
_L1, _L2 = np.float32(0.94), np.float32(0.9999)


def _quality_lib() -> ctypes.CDLL:
    lib = _build.load("quality_offsets")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.quality_offsets_launch.argtypes = [
            vp, vp, ci, ci, ci, ci, vp, vp, vp, cf, cf, ci, cf, cf, vp, vp,
            vp, vp]
        lib.quality_offsets_launch.restype = ci
        lib.quality_offsets_smem.argtypes = [ci, ci, ci]
        lib.quality_offsets_smem.restype = ctypes.c_longlong
        lib._bbmap_typed = True
    return lib


@functools.lru_cache(maxsize=8)
def _offset_tables(L: int, k: int, offsets: tuple, max_density: float,
                   device: torch.device):
    """The kernel's operands that depend only on the configuration, on
    ``device``: d2_tab, div_tab (``_offset_tables_np``) and the fixed
    ladder."""
    d2_tab, div_tab = _offset_tables_np(L, k, len(offsets), max_density)
    return (torch.as_tensor(d2_tab, device=device),
            torch.as_tensor(div_tab, device=device),
            torch.as_tensor(np.asarray(offsets, np.int32), device=device))


def quality_offsets_kernel(cfg: QmConfig, q: torch.Tensor, pc: torch.Tensor,
                           density: float, max_density: float):
    """Quality-driven key offsets of B reads from q (B, L) int32 phred and
    pc (B, L) float32 (its probability correct). Returns (offsets (B, nk)
    int32, weights (B, nk) float32, reject (B,) bool). CPU tensors: the
    plain version (``_quality_offsets_core``). CUDA tensors: one launch of
    ``csrc/quality_offsets.cu``; a failed launch raises."""
    k, L = cfg.k, cfg.L
    nk = len(cfg.offsets_list)
    B = q.shape[0]
    if q.shape != (B, L) or pc.shape != (B, L):
        raise ValueError(f"q and pc (B, {L}) expected, got "
                         f"{tuple(q.shape)} and {tuple(pc.shape)}")
    if q.dtype != I32 or pc.dtype != F32:
        raise TypeError("q must be int32 and pc float32")
    if q.device != pc.device:
        raise ValueError("q and pc must share one device")
    if q.device.type == "cpu":
        return _quality_offsets_core(cfg, q, pc, density, max_density, True)
    if q.device.type != "cuda":
        raise RuntimeError(f"the quality offsets kernel runs on CUDA tensors "
                           f"(got {q.device})")
    dev = q.device
    out_off = torch.empty((B, nk), dtype=I32, device=dev)
    wts = torch.empty((B, nk), dtype=F32, device=dev)
    reject = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out_off, wts, reject
    lib = _quality_lib()
    smem = lib.quality_offsets_smem(L, k, nk)
    if L - k + 1 < 1 or smem > 232448:
        raise ValueError(f"reads of {L} bp (k={k}, {nk} keys) take {smem} B "
                         f"of shared memory a block, past 227 KB")
    d2_tab, div_tab, ladder = _offset_tables(
        L, k, tuple(cfg.offsets_list), float(max_density), dev)
    q, pc = q.contiguous(), pc.contiguous()
    a = 100 * k
    base_ks = a // 8
    err = lib.quality_offsets_launch(
        q.data_ptr(), pc.data_ptr(), B, L, k, nk, d2_tab.data_ptr(),
        div_tab.data_ptr(), ladder.data_ptr(), float(_L1), float(_L2),
        base_ks, float(np.float32(a - base_ks)),
        float(np.float32(1.0) / np.float32(a)), out_off.data_ptr(),
        wts.data_ptr(), reject.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quality_offsets_launch failed: cudaError {err}")
    quality_offsets_kernel.launches += 1
    return out_off, wts, reject


def _stable_desc(x: torch.Tensor, dim: int = -1):
    """Stable descending sort (ties keep index order, as lax.top_k and
    argsort(-x, stable=True))."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


def _chain_segments(flat: torch.Tensor, toff: torch.Tensor,
                    chain_dist: int, nk: int):
    """Chain segmentation, distinct-offset votes and the modal run over
    each (read, strand) row of diagonals sorted ascending (flat (R2, W)
    int32, 2**30 past the row's valid slots; toff their key slots).
    Returns (last_idx, seg_start, gmax, size), each (R2, W) int32: a
    chain's last slot, its first slot, the running max of the packed
    (chain ordinal, run size, offset in chain) and the chain's distinct
    key count at its first slot."""
    R2, W = flat.shape
    dev = flat.device
    valid_f = flat < 2 ** 30
    dd = flat[:, 1:] - flat[:, :-1]
    ones_col = torch.ones((R2, 1), dtype=torch.bool, device=dev)
    new_chain = torch.cat([ones_col, dd > chain_dist], dim=1) & valid_f
    idx = torch.arange(W, dtype=I32, device=dev)[None, :].expand(R2, W)
    Wcol = torch.full((R2, 1), W, dtype=I32, device=dev)
    boundary = new_chain | ~valid_f
    bidx = torch.where(boundary, idx, W)
    nxt = torch.cummin(bidx.flip(1), dim=1).values.flip(1)
    next_start = torch.cat([nxt[:, 1:], Wcol], dim=1)
    last_idx = torch.clamp(next_start - 1, 0, W - 1)
    seg_start0 = torch.cummax(torch.where(new_chain, idx, 0), dim=1).values

    # distinct-offset votes: segmented prefix-OR of key-slot bitmasks
    n_groups = (nk + 31) // 32
    toff64 = toff.to(I64)
    mbits = [torch.where(valid_f & ((toff >> 5) == gi),
                         torch.ones_like(toff64) << (toff64 & 31), 0)
             for gi in range(n_groups)]
    incls = list(mbits)
    s = 1
    while s < W:
        prev_ok = idx - s >= seg_start0
        for gi in range(n_groups):
            shifted = torch.cat([torch.zeros((R2, s), dtype=I64,
                                             device=dev),
                                 incls[gi][:, :-s]], dim=1)
            incls[gi] = incls[gi] | torch.where(prev_ok, shifted, 0)
        s <<= 1
    in_seg = idx - 1 >= seg_start0
    is_new = valid_f
    for gi in range(n_groups):
        seen_excl = torch.cat([torch.zeros((R2, 1), dtype=I64, device=dev),
                               incls[gi][:, :-1]], dim=1)
        seen_excl = torch.where(in_seg, seen_excl, 0)
        is_new = is_new & ((seen_excl & mbits[gi]) == 0)
    c = torch.cumsum(is_new.to(I32), dim=1, dtype=I32)
    cbase = torch.cummax(torch.where(new_chain, c - is_new.to(I32), -1),
                         dim=1).values
    dcnt = c - torch.clamp(cbase, min=0)
    seg_ord0 = torch.cumsum(new_chain.to(I32), dim=1, dtype=I32)
    packed_dc = ((W + 1 - seg_ord0) << 16) | torch.where(valid_f, dcnt, 0)
    rmax = torch.cummax(packed_dc.flip(1), dim=1).values.flip(1)
    chain_distinct = rmax & 0xFFFF
    size = torch.where(new_chain, chain_distinct, 0).to(I32)

    # modal diagonal: longest equal-diag run in the chain, ties -> lowest
    dd_eq = torch.cat([ones_col, dd != 0], dim=1)
    new_run = (dd_eq | new_chain) & valid_f
    ridx = torch.where(new_run | ~valid_f, idx, W)
    rnxt = torch.cummin(ridx.flip(1), dim=1).values.flip(1)
    rnext = torch.cat([rnxt[:, 1:], Wcol], dim=1)
    run_size = torch.where(new_run, rnext - idx, 0)
    seg_start = torch.cummax(torch.where(new_chain, idx, -1), dim=1).values
    in_chain_off = torch.clamp(idx - seg_start, 0, 255)
    meta = (torch.clamp(run_size, 0, 255) << 8) | (255 - in_chain_off)
    seg_ord = torch.cumsum(new_chain.to(I32), dim=1, dtype=I32)
    glob = (seg_ord << 16) | torch.where(new_run, meta, 0)
    gmax = torch.cummax(glob.to(I32), dim=1).values
    return last_idx, seg_start, gmax, size


def _slot_counts(gadm: torch.Tensor, cnt_local: torch.Tensor,
                 admit: torch.Tensor, budget: int) -> torch.Tensor:
    """The shortest-first greedy slot budget: key j precedes key k iff
    (len_j, j) < (len_k, k), with len = ``gadm`` and BIG for a length of
    0; k fits iff its inclusive prefix length in that order is within
    ``budget``. Returns cnt (..., nk) int32: ``cnt_local`` where the key
    is admitted, fits and has a length, else 0."""
    g1 = torch.where(gadm > 0, gadm, BIG)
    order = torch.argsort(g1, dim=-1, stable=True)
    g_sorted = torch.gather(gadm, -1, order)
    csum_sorted = torch.cumsum(g_sorted, dim=-1, dtype=I32)
    fits = torch.empty_like(csum_sorted, dtype=torch.bool)
    fits.scatter_(-1, order, csum_sorted <= budget)
    return torch.where(admit & fits & (gadm > 0), cnt_local, 0)


def _slot_pack_plain(cfg: QmConfig, gadm, cnt_local, s0, offadj, admit,
                     n_sites: int):
    """Plain version of ``slot_pack_kernel``: the greedy budget
    (``_slot_counts``), then each of the W = ``cfg.slot_budget`` slots
    of a (read, strand) row given to its owning key #{t : cum_t <= w}
    (cum the inclusive prefix sum of the counts), clamped to nk - 1."""
    B, _two, nk = gadm.shape
    dev = gadm.device
    WB = cfg.slot_budget
    cnt = _slot_counts(gadm, cnt_local, admit, WB)
    cum = torch.cumsum(cnt, dim=-1, dtype=I32)              # (B, 2, nk)
    wslot = torch.arange(WB, dtype=I32, device=dev)
    t_of = torch.searchsorted(
        cum, wslot.expand(B, 2, WB).contiguous(), right=True)
    t_clip = torch.clamp(t_of, 0, nk - 1)
    cum_prev_k = torch.cat([torch.zeros((B, 2, 1), dtype=I32, device=dev),
                            cum[:, :, :-1]], dim=-1)
    base = torch.gather((s0 - cum_prev_k).to(I32), -1, t_clip)
    offadj_slot = torch.gather(offadj, -1, t_clip)
    toff_slot = t_clip.to(I32)
    valid_slot = wslot < cum[..., -1:]
    gather_idx = torch.clamp(base + wslot, 0, n_sites - 1).long()
    return gather_idx, offadj_slot, toff_slot, valid_slot, cum[..., -1]


def _slot_pack_lib() -> ctypes.CDLL:
    lib = _build.load("slot_pack")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.slot_pack_launch.argtypes = [
            vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp, vp, vp,
            vp, vp, vp]
        lib.slot_pack_launch.restype = ci
        lib._bbmap_typed = True
    return lib


def slot_pack_kernel(cfg: QmConfig, gadm: torch.Tensor,
                     cnt_local: torch.Tensor, s0: torch.Tensor,
                     offadj: torch.Tensor, admit: torch.Tensor,
                     n_sites: int):
    """The slot budget and the slot-to-key assignment of B reads: gadm
    (the lengths the budget ranks by), cnt_local (the lengths gathered),
    s0 (the lists' first sites), offadj (B, 2, nk) int32 and admit
    (B, 2, nk) bool. Returns the gather index into the ``n_sites`` sites
    (B, 2, W) int64, offadj_slot and toff_slot (B, 2, W) int32,
    valid_slot (B, 2, W) bool and the row total (B, 2) int32. CPU
    tensors: the plain version (``_slot_pack_plain``). CUDA tensors: one
    launch of ``csrc/slot_pack.cu``, no host sync; a failed launch
    raises."""
    B, two, nk = gadm.shape
    if two != 2 or nk < 1:
        raise ValueError(f"gadm (B, 2, nk >= 1) expected, got "
                         f"{tuple(gadm.shape)}")
    for name, t in (("cnt_local", cnt_local), ("s0", s0),
                    ("offadj", offadj), ("admit", admit)):
        if t.shape != gadm.shape:
            raise ValueError(f"{name} {tuple(t.shape)} against gadm "
                             f"{tuple(gadm.shape)}")
    if any(t.dtype != I32 for t in (gadm, cnt_local, s0, offadj)) \
            or admit.dtype != torch.bool:
        raise TypeError("gadm, cnt_local, s0 and offadj must be int32, "
                        "admit bool")
    dev = gadm.device
    if any(t.device != dev for t in (cnt_local, s0, offadj, admit)):
        raise ValueError("the operands must share one device")
    if dev.type == "cpu":
        return _slot_pack_plain(cfg, gadm, cnt_local, s0, offadj, admit,
                                n_sites)
    if dev.type != "cuda":
        raise RuntimeError(f"the slot pack kernel runs on CUDA tensors "
                           f"(got {dev})")
    WB = cfg.slot_budget
    gather_idx = torch.empty((B, 2, WB), dtype=I64, device=dev)
    offadj_slot = torch.empty((B, 2, WB), dtype=I32, device=dev)
    toff_slot = torch.empty((B, 2, WB), dtype=I32, device=dev)
    valid_slot = torch.empty((B, 2, WB), dtype=torch.bool, device=dev)
    total = torch.empty((B, 2), dtype=I32, device=dev)
    if B == 0:
        return gather_idx, offadj_slot, toff_slot, valid_slot, total
    lib = _slot_pack_lib()
    ins = [t.contiguous() for t in (gadm, cnt_local, s0, offadj, admit)]
    err = lib.slot_pack_launch(
        *(t.data_ptr() for t in ins), 2 * B, nk, WB,
        max(-1, min(n_sites - 1, 2 ** 31 - 1)), gather_idx.data_ptr(),
        offadj_slot.data_ptr(), toff_slot.data_ptr(), valid_slot.data_ptr(),
        total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slot_pack_launch failed: cudaError {err}")
    slot_pack_kernel.launches += 1
    return gather_idx, offadj_slot, toff_slot, valid_slot, total


def _sort_rows(diag: torch.Tensor, toff_slot: torch.Tensor):
    """Each (read, strand) row of (B, 2, W) diagonals and key slots
    sorted by (diagonal, key slot): the int64 key diag * 65536 + slot.
    Returns (flat, toff), each (2B, W) int32."""
    B, _two, WB = diag.shape
    key = diag.reshape(B * 2, WB).to(I64) * 65536 \
        + toff_slot.reshape(B * 2, WB).to(I64)
    key = torch.sort(key, dim=1).values
    return (key >> 16).to(I32), (key & 0xFFFF).to(I32)


def _candidate_table(flat, last_idx, seg_start, gmax, size):
    """The top-K table of each read over its 2W slots (strand 0 first):
    the K most-voted slots, ties to the lowest slot, as the stable sort
    gives them, and each one's start, stop, modal diagonal (the chain's
    packed modal run read back from ``gmax`` at its last slot) and
    spread. Inputs (2B, W) int32 from ``_sort_rows`` and
    ``_chain_segments``."""
    R2, nseg = flat.shape
    B = R2 // 2
    votes = size.reshape(B, 2 * nseg)
    topv, topi = _stable_desc(votes, dim=1)
    topv = topv[:, :MAX_CANDIDATES]
    topi = topi[:, :MAX_CANDIDATES]
    half = (topi >= nseg).to(I32)
    strand_off = half * nseg
    flat2 = flat.reshape(B, 2 * nseg)
    last2 = last_idx.reshape(B, 2 * nseg)
    segs2 = seg_start.reshape(B, 2 * nseg)
    gmax2 = gmax.reshape(B, 2 * nseg)
    cd_start = torch.gather(flat2, 1, topi)
    last_raw = torch.gather(last2, 1, topi)
    segs_raw = torch.gather(segs2, 1, topi)
    cd_last = torch.clamp(last_raw + strand_off, 0, 2 * nseg - 1).long()
    cd_stop = torch.gather(flat2, 1, cd_last)
    win = torch.gather(gmax2, 1, cd_last)
    win_off = 255 - (win & 0xFF)
    cd_mode_idx = torch.clamp(segs_raw + win_off, 0, nseg - 1)
    cd_mode = torch.gather(
        flat2, 1,
        torch.clamp(cd_mode_idx + strand_off, 0, 2 * nseg - 1).long())
    cd_votes = topv
    cd_valid = cd_votes > 0
    cd_spread = torch.where(cd_valid, cd_stop - cd_start, 0).to(I32)
    return {"votes": cd_votes, "mode": cd_mode, "strand": half,
            "start": cd_start, "spread": cd_spread}


def _chain_candidates_plain(cfg: QmConfig, diag, toff_slot):
    """Plain version of ``chain_candidates_kernel``: ``_sort_rows``,
    ``_chain_segments``, ``_candidate_table``."""
    flat, toff = _sort_rows(diag, toff_slot)
    last_idx, seg_start, gmax, size = _chain_segments(
        flat, toff, cfg.chain_dist, len(cfg.offsets_list))
    return _candidate_table(flat, last_idx, seg_start, gmax, size)


def _chain_lib() -> ctypes.CDLL:
    lib = _build.load("chain_candidates")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.chain_candidates_launch.argtypes = [
            vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp]
        lib.chain_candidates_launch.restype = ci
        lib._bbmap_typed = True
    return lib


def chain_candidates_kernel(cfg: QmConfig, diag: torch.Tensor,
                            toff_slot: torch.Tensor) -> Dict[str,
                                                             torch.Tensor]:
    """The candidate table of B reads from their unsorted slots: diag
    (B, 2, W) int32 (2**30 past a row's valid slots) and toff_slot
    (B, 2, W) int32 key slots. Returns the ``cand`` dict of (B, K) int32
    tensors (votes, mode, strand, start, spread). CPU tensors: the plain
    version (``_chain_candidates_plain``). CUDA tensors: one launch of
    ``csrc/chain_candidates.cu``, no host sync; a failed launch raises,
    and so does a row the launch refuses (2W < K, W >= 32,768 or past
    the block's shared memory)."""
    B, two, WB = diag.shape
    if two != 2 or toff_slot.shape != diag.shape:
        raise ValueError(f"diag and toff_slot (B, 2, W) expected, got "
                         f"{tuple(diag.shape)} and "
                         f"{tuple(toff_slot.shape)}")
    if diag.dtype != I32 or toff_slot.dtype != I32:
        raise TypeError("diag and toff_slot must be int32")
    dev = diag.device
    if toff_slot.device != dev:
        raise ValueError("the operands must share one device")
    if dev.type == "cpu":
        return _chain_candidates_plain(cfg, diag, toff_slot)
    if dev.type != "cuda":
        raise RuntimeError(f"the chain kernel runs on CUDA tensors "
                           f"(got {dev})")
    K = MAX_CANDIDATES
    outs = torch.empty((5, B, K), dtype=I32, device=dev)
    cand = dict(zip(("votes", "mode", "strand", "start", "spread"),
                    outs.unbind(0)))
    if B == 0:
        return cand
    lib = _chain_lib()
    diag, toff_slot = diag.contiguous(), toff_slot.contiguous()
    err = lib.chain_candidates_launch(
        diag.data_ptr(), toff_slot.data_ptr(), B, WB, cfg.chain_dist, K,
        *(t.data_ptr() for t in outs.unbind(0)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain_candidates_launch failed: cudaError "
                           f"{err}")
    chain_candidates_kernel.launches += 1
    return cand


def candidate_stage(cfg: QmConfig, bases, dindex: DeviceIndex,
                    offsets_dyn=None, rcodes=None, two_tier: bool = False,
                    weights_dyn=None, reject=None, gcnt_d=None):
    """Steps 1-5 (seed -> chain -> vote -> top-K candidates) against the
    CSR of ``dindex`` (the whole index, or one genome block's shard).
    Returns (rcodes (B, L) uint8, cand dict of (B, K) int32 tensors:
    votes, mode, strand, start, spread; plus ``hi_over`` (B,) bool when
    two_tier).

    ``gcnt_d``: optional per-key GLOBAL site-list length table (uint8,
    saturated at 255 — every admission threshold is < 255). A shard sees
    only its block's lists, so over-long-list exclusion, staged
    re-admission and the greedy slot budget (reference:
    BBIndex.find:421-440) consult the global length to make the
    whole index's decisions; None uses the local (= global) count."""
    k, L, S = cfg.k, cfg.L, cfg.S
    offsets_list = cfg.offsets_list
    nk = len(offsets_list)
    sites_d = dindex.sites
    dev = sites_d.device
    INVALID = 2 ** 30

    if rcodes is None:
        rcodes = ascii_to_codes(bases)
    B = rcodes.shape[0]
    if offsets_dyn is None:
        kp = _keys_from_codes(rcodes, offsets_list, k, L)
        offsets_d = torch.as_tensor(np.asarray(offsets_list, np.int32),
                                    device=dev)
        offadj_minus = torch.as_tensor(
            (L - (np.asarray(offsets_list) + k)).astype(np.int32),
            device=dev)
        off_p = offsets_d[None, :].expand(B, nk)
        off_m = offadj_minus[None, :].expand(B, nk)
    else:
        keys_all = _keys_all_positions(rcodes, k, L)
        m = L - k + 1
        od = offsets_dyn.to(I32)
        kp = torch.gather(keys_all, 1, torch.clamp(od, 0, m - 1).long())
        kp = torch.where(od < 0, -1, kp)
        if reject is not None:
            kp = torch.where(reject[:, None], -1, kp)
        off_p = torch.clamp(od, min=0)
        off_m = L - (off_p + k)
    kp = kp.to(I32)
    km = torch.where(kp < 0, -1, _rc_keys(torch.where(kp < 0, 0, kp), k))
    keys = torch.stack([kp, km], dim=1)                     # (B, 2, nk)
    offadj = torch.stack([off_p.to(I32), off_m.to(I32)], dim=1)
    valid = keys >= 0
    safe = torch.where(valid, keys, 0).long()
    if dindex.scnt is not None:
        sc = dindex.scnt[safe]
        s0 = (sc >> 8) & 0xFFFFFF
        cnt_local = sc & 255
    else:
        s0 = dindex.starts[safe]
        cnt_local = dindex.starts[safe + 1] - s0
    # admission consults the GLOBAL list length (== local on one
    # device); the gathers use the LOCAL length
    gcnt = cnt_local if gcnt_d is None else gcnt_d[safe].to(I32)
    if cfg.ref_admit and dindex.ccnt is not None:
        ccnt_p = dindex.ccnt[torch.where(kp < 0, 0, kp).long()]
        ccnt_p = torch.where(kp < 0, 0, ccnt_p)
        alive = ref_retention_kernel(cfg, kp, off_p.to(I32), ccnt_p,
                                     weights=weights_dyn)
        admit = alive[:, None, :].expand(B, 2, nk)
        gadm = torch.where(admit, ccnt_p[:, None, :], 0)
    else:
        nz = valid & (gcnt > 0)
        tiers = (S, (3 * S) // 2, 2 * S, 3 * S, 5 * S)
        nh = [torch.sum((nz & (gcnt <= t)).to(I32), dim=-1, dtype=I32)
              for t in tiers]
        trig = (3 * nk) // 4
        sel = torch.zeros_like(nh[0])
        esc = (nh[0] > 0) & (nh[0] < 4) & (nh[0] < trig)
        sel = torch.where(esc, 1, sel)
        cur = torch.where(esc, nh[1], nh[0])
        for t, need in ((2, 3), (3, 3), (4, 2)):
            esc = esc & (cur < need) & (cur < trig)
            sel = torch.where(esc, t, sel)
            cur = torch.where(esc, nh[t], cur)
        tier_arr = torch.as_tensor(np.asarray(tiers, np.int32), device=dev)
        Tsel = tier_arr[sel.long()][..., None]
        admit = gcnt <= Tsel
        gadm = torch.where(valid & admit, gcnt, 0)
    gadm = gadm.to(I32)
    WB = cfg.slot_budget
    gather_idx, offadj_slot, toff_slot, valid_slot, total = slot_pack_kernel(
        cfg, gadm, cnt_local.to(I32), s0.to(I32), offadj, valid & admit,
        sites_d.shape[0])
    hi_over = None
    if not two_tier:
        site = sites_d[gather_idx]
    else:
        # upper half of the slot axis gathered only for rows that need
        # it, compacted to a budget; rows falling off it are flagged
        LO = WB // 2
        R2 = B * 2
        site_lo = sites_d[gather_idx[:, :, :LO]]
        need_hi = (total > LO).reshape(R2)
        HB = hi_budget(R2)
        pri = torch.where(need_hi, torch.arange(R2, dtype=I32, device=dev),
                          INVALID)
        rows = torch.sort(pri).values[:HB]
        ok = rows < INVALID
        rcl = torch.clamp(rows, 0, R2 - 1).long()
        hi_idx = gather_idx.reshape(R2, WB)[:, LO:]
        site_hi_rows = sites_d[hi_idx[rcl]]                 # (HB, LO)
        rows_s = torch.where(ok, rcl, R2)                   # trash slot
        site_hi = torch.zeros((R2 + 1, LO), dtype=sites_d.dtype,
                              device=dev)
        site_hi[rows_s] = site_hi_rows
        covered = torch.zeros(R2 + 1, dtype=torch.bool, device=dev)
        covered[rows_s] = True
        site_hi = site_hi[:R2]
        covered = covered[:R2]
        ok_hi = (covered | ~need_hi).reshape(B, 2, 1)
        valid_slot = valid_slot & torch.cat(
            [torch.ones((B, 2, LO), dtype=torch.bool, device=dev),
             ok_hi.expand(B, 2, LO)], dim=-1)
        hi_over = (need_hi & ~covered).reshape(B, 2).any(dim=1)
        site = torch.cat([site_lo, site_hi.reshape(B, 2, LO)], dim=-1)
    diag = torch.where(valid_slot, site - offadj_slot, INVALID).to(I32)
    cand = chain_candidates_kernel(cfg, diag, toff_slot)
    if hi_over is not None:
        cand["hi_over"] = hi_over
    return rcodes, cand


def _on_strand(cfg: QmConfig, rcodes, mode, strand, dindex: DeviceIndex):
    """The read's codes on each candidate's strand (minus: complemented
    and reversed) and the genome's codes and N flags (N or off the
    genome) at the candidate's diagonal. rcodes (B, L); mode, strand of
    shape (B,) or (B, K). Returns three (..., L) tensors."""
    ref_codes, ref_n = extract_ref_codes(dindex.gpack, dindex.nmask, mode,
                                         cfg.L, cfg.G, has_n=cfg.has_n)
    rc = torch.where(rcodes <= 3, 3 - rcodes, rcodes).flip(1)
    row = (slice(None),) + (None,) * (mode.dim() - 1)
    codes = torch.where((strand == 0)[..., None], rcodes[row], rc[row])
    return codes, ref_codes, ref_n


def _gapless_scores_plain(cfg: QmConfig, rcodes, cd_mode, cd_strand,
                          dindex: DeviceIndex):
    """Plain version of ``gapless_scores_kernel``: the (B, K, L) reference
    windows at each candidate's modal diagonal, the read's codes on the
    candidate's strand, and ``score_match_sub_vec``'s closed form."""
    cand_codes, ref_codes, ref_n = _on_strand(cfg, rcodes, cd_mode,
                                              cd_strand, dindex)
    read_n = cand_codes > 3
    eq = (cand_codes == ref_codes) & ~ref_n
    is_match = eq & ~read_n
    is_sub = ~eq & ~read_n & ~ref_n
    return score_match_sub_vec(is_match, is_sub, cfg.profile)


def _gapless_lib() -> ctypes.CDLL:
    lib = _build.load("gapless_score")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gapless_score_launch.argtypes = [
            vp, ci, ci, ci, vp, vp, vp, cll, vp, cll, cll, ci, ci, ci, ci,
            ci, ci, ci, vp, vp]
        lib.gapless_score_launch.restype = ci
        lib._bbmap_typed = True
    return lib


def gapless_scores_kernel(cfg: QmConfig, rcodes: torch.Tensor,
                          cd_mode: torch.Tensor, cd_strand: torch.Tensor,
                          dindex: DeviceIndex) -> torch.Tensor:
    """Gapless streak scores of the candidate table: rcodes (B, L) uint8
    codes, cd_mode / cd_strand (B, K) int32 (modal diagonal, strand).
    Returns (B, K) int32 scores, before the valid-candidate mask. CPU
    tensors: the plain version (``_gapless_scores_plain``). CUDA tensors:
    one launch of ``csrc/gapless_score.cu``; a failed launch raises."""
    B, K = cd_mode.shape
    if rcodes.shape != (B, cfg.L) or cd_strand.shape != (B, K):
        raise ValueError(f"rcodes (B, {cfg.L}) and cd_strand {(B, K)} "
                         f"expected, got {tuple(rcodes.shape)} and "
                         f"{tuple(cd_strand.shape)}")
    if rcodes.dtype != torch.uint8 or cd_mode.dtype != I32 \
            or cd_strand.dtype != I32:
        raise TypeError("rcodes must be uint8, cd_mode and cd_strand int32")
    dev = rcodes.device
    if cd_mode.device != dev or cd_strand.device != dev \
            or dindex.device != dev:
        raise ValueError("the operands and the index must share one device")
    if dev.type == "cpu":
        return _gapless_scores_plain(cfg, rcodes, cd_mode, cd_strand, dindex)
    if dev.type != "cuda":
        raise RuntimeError(f"the gapless kernel runs on CUDA tensors "
                           f"(got {dev})")
    scores = torch.empty((B, K), dtype=I32, device=dev)
    if B * K == 0:
        return scores
    lib = _gapless_lib()
    rcodes, cd_mode = rcodes.contiguous(), cd_mode.contiguous()
    cd_strand = cd_strand.contiguous()
    PM, PM2, PS, PS2, PS3, LIM3 = _points(cfg.profile)
    err = lib.gapless_score_launch(
        rcodes.data_ptr(), B, cfg.L, K, cd_mode.data_ptr(),
        cd_strand.data_ptr(), dindex.gpack.data_ptr(), dindex.gpack.shape[0],
        dindex.nmask.data_ptr(), dindex.nmask.shape[0], cfg.G,
        int(cfg.has_n), PM, PM2, PS, PS2, PS3, LIM3, scores.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gapless_score_launch failed: cudaError {err}")
    gapless_scores_kernel.launches += 1
    return scores


def reset_launches() -> None:
    quality_offsets_kernel.launches = 0
    ref_retention_kernel.launches = 0
    slot_pack_kernel.launches = 0
    chain_candidates_kernel.launches = 0
    gapless_scores_kernel.launches = 0


reset_launches()


def _best_sym(cfg: QmConfig, rcodes, mode, strand, dindex: DeviceIndex):
    """(B, L) match symbols (0=m 1=S 2=N) of each read against the genome
    at ``mode`` (B,) on ``strand`` (B,): the winner's row of the
    candidate table."""
    codes, ref_codes, ref_n = _on_strand(cfg, rcodes, mode, strand, dindex)
    eq = (codes == ref_codes) & ~ref_n
    return torch.where((codes > 3) | ref_n, 2,
                       torch.where(eq, 0, 1)).to(torch.uint8)


def finalize_stage(cfg: QmConfig, rcodes, cand, dindex: DeviceIndex,
                   return_scores: bool = False, boost_fn=None):
    """Steps 6-7: gapless scoring of the candidate table at each modal
    diagonal + best/second selection + the best site's match symbols.
    Returns (out_i32 (B, N_META[+1] + 5K), best_sym (B, L) uint8 codes
    0=m 1=S 2=N[, scores (B, K)[, sel (B, K)]]). The scores come from
    ``gapless_scores_kernel`` (one launch on the card), the symbols from
    the winner's row alone."""
    min_score = cfg.min_score
    B = rcodes.shape[0]
    cd_votes = cand["votes"]
    cd_mode = cand["mode"]
    cd_strand = cand["strand"]
    cd_start = cand["start"]
    cd_spread = cand["spread"]
    cd_valid = cd_votes > 0

    scores = gapless_scores_kernel(cfg, rcodes, cd_mode, cd_strand, dindex)
    scores = torch.where(cd_valid, scores, -(2 ** 30)).to(I32)

    sel = scores if boost_fn is None else boost_fn(scores)
    order = _stable_desc(sel, dim=1).indices
    o0 = order[:, 0:1]
    o1 = order[:, 1:2]

    def g1(a, o):
        return torch.gather(a, 1, o)[:, 0]

    best_score = g1(scores, o0)
    second_score = g1(sel, o1)
    n_good = torch.sum(scores >= min_score, dim=1, dtype=I32)
    best_sym = _best_sym(cfg, rcodes, g1(cd_mode, o0), g1(cd_strand, o0),
                         dindex)
    meta_cols = [best_score.to(I32), g1(cd_mode, o0), g1(cd_strand, o0),
                 g1(cd_start, o0), g1(cd_spread, o0).to(I32),
                 second_score.to(I32), n_good]
    if boost_fn is not None:
        meta_cols.append(g1(sel, o0).to(I32))
    cand_block = torch.stack([scores, cd_mode.to(I32), cd_strand.to(I32),
                              cd_start.to(I32), cd_spread], dim=1).reshape(
        B, N_CFIELD * cd_votes.shape[1])
    out_i32 = torch.cat([torch.stack(meta_cols, dim=1).to(I32),
                         cand_block.to(I32)], dim=1)
    if return_scores:
        if boost_fn is not None:
            return out_i32, best_sym, scores, sel.to(I32)
        return out_i32, best_sym, scores
    return out_i32, best_sym


def build_quickmap(dindex: DeviceIndex, L: int, chain_dist: int = 400,
                   min_ratio: float = 0.56,
                   max_list_length: Optional[int] = None, profile=None):
    """Returns quickmap(bases_ascii (B, L) uint8 numpy, quality=None) ->
    QuickmapRun, on the DeviceIndex's device."""
    cfg = make_config(dindex, L, chain_dist, min_ratio, max_list_length,
                      profile)
    den2, den3 = seed_host.key_density_ladder(L, dindex.k)
    dev = dindex.device

    def run(bases, quality=None) -> QuickmapRun:
        b = torch.from_numpy(np.ascontiguousarray(bases[:, :L])).to(dev)
        offs = wts = rej = None
        if quality is not None:
            qt = torch.from_numpy(
                np.ascontiguousarray(quality[:, :L])).to(dev)
            offs, wts, rej = quality_offsets_stage(cfg, qt, den2, den3,
                                                   return_weights=True)
        rcodes, cand = candidate_stage(cfg, b, dindex, offsets_dyn=offs,
                                       weights_dyn=wts, reject=rej)
        out_i32, best_sym = finalize_stage(cfg, rcodes, cand, dindex)
        return QuickmapRun(out_i32, best_sym, L)

    run.cfg = cfg
    return run
