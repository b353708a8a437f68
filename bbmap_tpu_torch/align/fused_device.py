"""Fused mapping program: quickmap + DP escalation + traceback for one
batch, as one sequence of device operations.

Port of ``bbmap_tpu/align/fused_device.py``. The steps and their
selection rules are the JAX program's:

1. candidate_stage + finalize_stage (align/quickmap_device.py), with the
   pair boost on the paired path
2. escalate flags: best gapless < maxImperfectScore (reference:
   align2/AbstractMapThread.java:1252)
3. compact escalated rows to a budget E; DP-score the top-2 candidates
   of each at the narrow window Cn, and re-score wide chains at Cw
   (budget W): both passes in one launch of the score kernel
   (ops/msa_kernels.msa_score_segments)
4. selection: eff = max(gapless, DP), winner/second/rest, n_sites
5. rows whose winner DP beat gapless compact to a budget T and run the
   fill + the bounded traceback walk (ops/msa_kernels.msa_fill_walk: one
   kernel, the prev codes in shared memory)
6. wide winners and window-clipped traces re-trace at Cw (budget RT,
   ops/msa.msa_align_batch, the same kernel)

Rows the program cannot settle exactly (budget overflow, wide windows
past a budget) are flagged for the host refit path, as in the JAX
package. Outputs stay on the device until ``FusedRun.host()`` copies
them and returns the dict the JAX package's ``FusedRun.host()`` returns,
key for key and dtype for dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import seed as seed_host
from ..core.constants import MINGAP, SHORT_PROFILE
from ..io import native

from ..ops import msa, msa_kernels
from . import quickmap_device as qd
from .quickmap_device import (I32, N_META, DeviceIndex, QmConfig,
                              extract_ref_codes, make_config)

SLOW_ALIGN_PADDING = 4
NARROW_SPREAD = 16          # must match escalate_device.NARROW_SPREAD
WIDE_SPREAD = 448           # must match escalate_device.WIDE_SPREAD
RETRY_EXTRA = 80 + SLOW_ALIGN_PADDING
BIG = 2 ** 30

_B2C = qd._B2C


def pack_reads_host(bases: np.ndarray):
    """(B, L) ASCII -> (codes2 (B, W16) uint32 [16 bases/word],
    nmask (B, W32) uint32 or None when the batch has no N/undefined
    bases)."""
    B, L = bases.shape
    codes = _B2C[bases]
    W16 = (L + 15) // 16
    cpad = np.zeros((B, W16 * 16), np.uint8)
    np.minimum(codes, 3, out=cpad[:, :L])
    h4 = cpad[:, 0::2] | (cpad[:, 1::2] << 2)
    h8 = h4[:, 0::2] | (h4[:, 1::2] << 4)
    codes2 = np.ascontiguousarray(h8).view(np.uint32)
    nb = codes > 3
    if not nb.any():
        return codes2, None
    W32 = (L + 31) // 32
    npad = np.zeros((B, W32 * 32), np.uint32)
    npad[:, :L] = nb
    bshift = np.arange(32, dtype=np.uint32)
    nmask = (npad.reshape(B, W32, 32) << bshift[None, None, :]).sum(
        axis=2, dtype=np.uint32)
    return codes2, nmask


def unpack_reads_device(codes2: torch.Tensor, nmask: Optional[torch.Tensor],
                        L: int) -> torch.Tensor:
    """Inverse of pack_reads_host -> (B, L) uint8 codes 0..4. The uint32
    words arrive held in int64."""
    B, W16 = codes2.shape
    slots = torch.arange(16, dtype=torch.int64, device=codes2.device) * 2
    c = ((codes2[:, :, None] >> slots) & 3).to(torch.uint8)
    c = c.reshape(B, W16 * 16)[:, :L]
    if nmask is None:
        return c
    W32 = nmask.shape[1]
    bslots = torch.arange(32, dtype=torch.int64, device=codes2.device)
    nb = ((nmask[:, :, None] >> bslots) & 1).bool()
    nb = nb.reshape(B, W32 * 32)[:, :L]
    return torch.where(nb, 4, c).to(torch.uint8)


def _codes_to_read_ascii(codes: torch.Tensor) -> torch.Tensor:
    """(..., L) codes 0..4 -> ASCII ACGTN."""
    c = codes.to(I32)
    a = 65 + 2 * c + 2 * (c >= 2).to(I32) + 11 * (c == 3).to(I32)
    return torch.where(c > 3, 78, a).to(torch.uint8)


def _window_ascii(dindex: DeviceIndex, cfg: QmConfig, wstart, C: int):
    codes, isn = extract_ref_codes(dindex.gpack, dindex.nmask, wstart, C,
                                   cfg.G, has_n=cfg.has_n)
    return torch.where(isn, 78, _codes_to_read_ascii(codes)).to(
        torch.uint8)


class FusedConfig(NamedTuple):
    qm: QmConfig
    E: int            # escalation row budget
    T: int            # traceback row budget
    W: int            # wide-window rescore job budget
    RT: int           # wide/clip-retry traceback row budget
    Cn: int           # narrow DP window width
    Cw: int           # wide DP window width
    max_imp: int      # maxImperfectScore(L)
    min_score: int
    maxindel: int = 16000


def esc_budget(B: int) -> int:
    if B <= 2048:
        return B
    return max(1024, (B * 4 // 16 + 255) // 256 * 256)


def trace_budget(B: int) -> int:
    if B <= 2048:
        return B
    return max(512, (B // 8 + 255) // 256 * 256)


def make_fused_config(dindex: DeviceIndex, L: int, B: int,
                      chain_dist: int = 400, min_ratio: float = 0.56,
                      max_list_length: Optional[int] = None,
                      profile=None, maxindel: int = 16000) -> FusedConfig:
    qm = make_config(dindex, L, chain_dist, min_ratio, max_list_length,
                     profile)
    if profile is None:
        profile = SHORT_PROFILE
    E = esc_budget(B)
    T = min(trace_budget(B), E)
    return FusedConfig(
        qm=qm, E=E, T=T, W=min(128, 2 * E), RT=min(64, T),
        Cn=L + 2 * SLOW_ALIGN_PADDING + NARROW_SPREAD,
        Cw=L + 2 * SLOW_ALIGN_PADDING + WIDE_SPREAD,
        max_imp=int(profile.max_imperfect_score(L)),
        min_score=qm.min_score, maxindel=maxindel)


def _compact_indices(flags: torch.Tensor, budget: int) -> torch.Tensor:
    """Indices of True flags, ascending, padded with BIG to ``budget``."""
    n = flags.shape[0]
    pri = torch.where(flags, torch.arange(n, dtype=I32,
                                          device=flags.device), BIG)
    return torch.sort(pri).values[:budget].to(I32)


def _scatter_trash(base: torch.Tensor, idx: torch.Tensor,
                   upd: torch.Tensor) -> torch.Tensor:
    """base[idx] = upd where padded entries of idx point at the trash
    slot len(base) (never a real row)."""
    ext = torch.cat([base, torch.zeros((1,) + base.shape[1:],
                                       dtype=base.dtype,
                                       device=base.device)])
    ext[idx.long()] = upd.to(base.dtype)
    return ext[:base.shape[0]]


# pairing constants (mirror align/pipeline.py — reference:
# AbstractMapThread.java:2975-2991)
MAX_PAIR_DIST = 32000
OUTER_DIST_MULT = 14
OUTER_DIST_DIV = 32
NEG_BOOST = -(2 ** 30)
DEV_CAP = 1 << 22      # insert-deviation clamp (see pair_boost_device)


def pair_boost_device(gl: torch.Tensor, cand: Dict[str, torch.Tensor],
                      Bp: int, L1: int, L2: int, apd: int,
                      chrom_offsets_d: torch.Tensor) -> torch.Tensor:
    """Pair boost over the (Bp, C, C) candidate cross (port of
    fused_device.pair_boost_device; reference:
    AbstractMapThread.pairSiteScoresFinal:1919-2100). ``gl``: (2*Bp, C)
    raw gapless scores, mate-1 rows then mate-2 rows. Intermediates are
    int64; on the lanes that survive the masks every value equals the
    JAX program's int32 value."""
    i64 = torch.int64
    s1 = gl[:Bp].to(i64)
    s2 = gl[Bp:].to(i64)
    v1 = s1 > -(2 ** 29)
    v2 = s2 > -(2 ** 29)
    c1 = s1 > 0
    c2 = s2 > 0
    a_start = cand["start"][:Bp].to(i64)
    a_stop = a_start + cand["spread"][:Bp] + (L1 - 1)
    b_start = cand["start"][Bp:].to(i64)
    b_stop = b_start + cand["spread"][Bp:] + (L2 - 1)
    st1 = cand["strand"][:Bp]
    st2 = cand["strand"][Bp:]
    ch1 = torch.searchsorted(chrom_offsets_d, cand["start"][:Bp]
                             .to(chrom_offsets_d.dtype).contiguous(),
                             right=True)
    ch2 = torch.searchsorted(chrom_offsets_d, cand["start"][Bp:]
                             .to(chrom_offsets_d.dtype).contiguous(),
                             right=True)

    def A(x):
        return x[:, :, None]

    def Bx(x):
        return x[:, None, :]

    opp = A(st1) != Bx(st2)
    fwd = A(st1) == 0
    inner = torch.where(fwd, Bx(b_start) - A(a_stop),
                        A(a_start) - Bx(b_stop))
    outer = torch.where(fwd, Bx(b_stop) - A(a_start),
                        A(a_stop) - Bx(b_start))
    outer_limit = (max(L1, L2) * OUTER_DIST_MULT) // OUTER_DIST_DIV
    okg = (A(v1) & Bx(v2) & opp & (A(ch1) == Bx(ch2))
           & (outer >= outer_limit) & (inner <= MAX_PAIR_DIST))
    ok1 = okg & Bx(c2)
    ok2 = okg & A(c1)
    apd = int(apd)
    expected_frag = apd + (L1 + L2)
    deviation = torch.clamp(torch.abs(apd - torch.where(okg, inner, 0)),
                            max=DEV_CAP)
    mult1 = min(0.5, max(0.25, L1 / (4.0 * L2)))
    mult2 = min(0.5, max(0.25, L2 / (4.0 * L1)))
    denom = max(100, 10 * expected_frag + 100)
    f1 = torch.tensor(mult1, dtype=torch.float32, device=gl.device)
    f2 = torch.tensor(mult2, dtype=torch.float32, device=gl.device)
    m1 = (Bx(gl[Bp:]).to(torch.float32) * f1).to(I32).to(i64)
    m2 = (A(gl[:Bp]).to(torch.float32) * f2).to(I32).to(i64)
    p1 = A(s1) + 1 + torch.clamp(
        m1 - torch.div(deviation * Bx(s2), denom, rounding_mode="floor"),
        min=1)
    p2 = Bx(s2) + 1 + torch.clamp(
        m2 - torch.div(deviation * A(s1), denom, rounding_mode="floor"),
        min=1)
    boost1 = torch.where(ok1, p1, NEG_BOOST).max(dim=2).values
    boost2 = torch.where(ok2, p2, NEG_BOOST).max(dim=1).values
    return torch.cat([torch.clamp(boost1, min=NEG_BOOST),
                      torch.clamp(boost2, min=NEG_BOOST)]).to(I32)


def fused_stage(fcfg: FusedConfig, rcodes: torch.Tensor,
                dindex: DeviceIndex, offsets_dyn=None, weights_dyn=None,
                reject=None, pair=None) -> Dict[str, torch.Tensor]:
    """The fused program body. rcodes: (B, L) uint8 codes (0..3, 4=N).
    ``pair``: paired-mode context — rcodes is then mate-1 rows then
    mate-2 rows, and the dict carries {"apd": int, "min_gate": int}.
    Returns a dict of device tensors (see FusedRun.host)."""
    cfg = fcfg.qm
    L, G = cfg.L, cfg.G
    E, T, Cn = fcfg.E, fcfg.T, fcfg.Cn
    P = cfg.profile if cfg.profile is not None else SHORT_PROFILE
    dev = rcodes.device

    rcodes, cand = qd.candidate_stage(cfg, None, dindex,
                                      offsets_dyn=offsets_dyn,
                                      rcodes=rcodes, two_tier=True,
                                      weights_dyn=weights_dyn,
                                      reject=reject)
    hi_over = cand.pop("hi_over")
    B = rcodes.shape[0]
    if pair is None:
        out_i32, _sym, gl_scores = qd.finalize_stage(
            cfg, rcodes, cand, dindex, return_scores=True)
        boosted = gl_scores
    else:
        Bp = B // 2

        def boost_fn(scores):
            boost = pair_boost_device(scores, cand, Bp, L, L, pair["apd"],
                                      dindex.chrom_offsets)
            return torch.maximum(scores, boost)

        out_i32, _sym, gl_scores, boosted = qd.finalize_stage(
            cfg, rcodes, cand, dindex, return_scores=True,
            boost_fn=boost_fn)

    # long-indel plausibility flag (host gap-compressed pass gate)
    dgc = cand["mode"]
    stc = cand["strand"]
    vc = cand["votes"] > 0
    sep = torch.abs(dgc[:, :, None] - dgc[:, None, :])
    same = stc[:, :, None] == stc[:, None, :]
    okp = (vc[:, :, None] & vc[:, None, :] & same
           & (sep > cfg.chain_dist) & (sep <= fcfg.maxindel))
    li = okp.any(dim=2).any(dim=1) | (vc & (cand["spread"]
                                            >= MINGAP)).any(dim=1)

    meta_cols = [out_i32[:, 0], out_i32[:, 1], out_i32[:, 2],
                 out_i32[:, 5], out_i32[:, 6]]
    if pair is not None:
        meta_cols.append(out_i32[:, N_META])       # eff
    meta_cols.append(li.to(I32) | (hi_over.to(I32) << 1))
    meta = torch.stack(meta_cols, dim=1)

    # --- escalation compaction (per mate also on the paired path)
    best0 = meta[:, 0]
    escalate = best0 < fcfg.max_imp
    esc_idx = _compact_indices(escalate, E)
    esc_valid = esc_idx < BIG
    eidx = torch.clamp(esc_idx, 0, B - 1).long()

    scs = gl_scores[eidx]                               # (E, C)
    bscs = boosted[eidx] if pair is not None else scs
    ord_all = qd._stable_desc(bscs, dim=1).indices
    ordc = ord_all[:, :2]

    def take2(a):
        return torch.gather(a[eidx], 1, ordc)

    g_sc = torch.gather(scs, 1, ordc)
    delta = (torch.gather(bscs, 1, ordc) - g_sc) if pair is not None \
        else None
    diag = take2(cand["mode"])
    strand = take2(cand["strand"])
    start = take2(cand["start"])
    spread = take2(cand["spread"])
    valid_c = g_sc > -(2 ** 29)
    wstart = start - SLOW_ALIGN_PADDING
    wide_c = (spread > NARROW_SPREAD) & valid_c

    # --- DP score jobs: (E, 2) candidates at the narrow window
    rc_codes = torch.where(rcodes <= 3, 3 - rcodes, rcodes).flip(1)
    fwd_e = rcodes[eidx]
    rc_e = rc_codes[eidx]
    reads_j2 = torch.where((strand == 0)[..., None], fwd_e[:, None, :],
                           rc_e[:, None, :])            # (E, 2, L) codes
    reads_ascii = _codes_to_read_ascii(reads_j2.reshape(E * 2, L))
    wflat = wstart.reshape(E * 2).to(I32)
    refs_ascii = _window_ascii(dindex, cfg, wflat, Cn)
    rows_j = torch.full((E * 2,), L, dtype=I32, device=dev)

    # --- wide-window rescore of chains wider than the narrow window, in
    # the narrow pass's launch
    W, Cw = fcfg.W, fcfg.Cw
    wide_flat = wide_c.reshape(E * 2)
    wloc = _compact_indices(wide_flat, W)
    w_ok = wloc < BIG
    wl = torch.clamp(wloc, 0, E * 2 - 1).long()
    wrefs = _window_ascii(dindex, cfg, wflat[wl], Cw)
    sc_narrow, sc_wide = msa_kernels.msa_score_segments(
        [(reads_ascii, refs_ascii, rows_j),
         (reads_ascii[wl].contiguous(), wrefs,
          torch.full((W,), L, dtype=I32, device=dev))], P)
    sc_dp_flat, wsc = sc_narrow[0], sc_wide[0]
    wl_s = torch.where(w_ok, wl, E * 2)
    sc_dp_flat = _scatter_trash(sc_dp_flat, wl_s, wsc)
    covered = _scatter_trash(torch.zeros(E * 2, dtype=torch.bool,
                                         device=dev), wl_s,
                             torch.ones(W, dtype=torch.bool, device=dev))
    wide_over = (wide_flat & ~covered).reshape(E, 2).any(dim=1)
    sc_dp = torch.where(valid_c, sc_dp_flat.reshape(E, 2), -(2 ** 30))

    # --- selection (mirrors _escalate_columnar host math)
    eff = torch.maximum(g_sc, sc_dp)
    if delta is not None:
        eff = eff + delta
    w0 = (eff[:, 1] > eff[:, 0]).long()                 # ties -> slot 0
    ar = torch.arange(E, device=dev)
    best_e = eff[ar, w0]
    second_e = eff[ar, 1 - w0]
    rest = torch.gather(bscs, 1, ord_all[:, 2:])
    rest_best = rest.max(dim=1).values if rest.shape[1] else \
        torch.full((E,), -(2 ** 30), dtype=I32, device=dev)
    second_full = torch.maximum(second_e, rest_best)
    min_gate = fcfg.min_score if pair is None else pair["min_gate"]
    n_sites = ((eff >= min_gate).sum(dim=1)
               + (rest >= min_gate).sum(dim=1)).to(I32)
    wdiag = diag[ar, w0]
    wstrand = strand[ar, w0]
    wws = wstart[ar, w0]
    g_w = g_sc[ar, w0]
    dp_w = sc_dp[ar, w0]
    mapped_e = best_e >= min_gate

    # --- trace compaction + fill + bounded walk (narrow window)
    wide_w = wide_c[ar, w0]
    needs_trace = mapped_e & (dp_w > g_w) & esc_valid
    tloc = _compact_indices(needs_trace, T)
    t_valid = tloc < BIG
    tl = torch.clamp(tloc, 0, E - 1).long()
    treads = _codes_to_read_ascii(reads_j2[tl, w0[tl]])
    tws = wws[tl].to(I32)
    trefs = _window_ascii(dindex, cfg, tws, Cn)
    rows_t = torch.full((T,), L, dtype=I32, device=dev)
    # the walk runs R + max-deletion-span steps; a truncated walk
    # (row_end > 0) re-traces at Cw like a clipped alignment
    steps_n = L + (Cn - L) + 16
    out3, sym, ln, gaps, row_end = msa_kernels.msa_fill_walk(
        treads, trefs, rows_t, P, steps_n)
    sc2, col = out3[0], out3[1]
    truncated = row_end > 0

    # --- wide/retry traceback at Cw
    RT = fcfg.RT
    twide = wide_w[tl]
    first = torch.gather(sym, 1, torch.clamp(ln - 1, min=0)[:, None]
                         .long())[:, 0]
    last = sym[:, 0]
    clip_l = (first == ord("I")) | (first == ord("X"))
    clip_r = (last == ord("I")) | (last == ord("Y"))
    clipped = (clip_l | clip_r) & ~twide
    rneed = t_valid & (clipped | twide | truncated)
    rloc = _compact_indices(rneed, RT)
    r_ok = rloc < BIG
    rtl = torch.clamp(rloc, 0, T - 1).long()
    rws = torch.where(twide[rtl], tws[rtl],
                      tws[rtl] - torch.where(clip_l[rtl], RETRY_EXTRA, 0)
                      ).to(I32)
    rrefs = _window_ascii(dindex, cfg, rws, Cw)
    sym_w, ln_w, gaps_w, sc2_w, col_w, _stw = msa.msa_align_batch(
        treads[rtl].contiguous(), rrefs, P)
    rtl_s = torch.where(r_ok, rtl, T)
    ln = _scatter_trash(ln.to(I32), rtl_s, ln_w)
    gaps = _scatter_trash(gaps.to(I32), rtl_s, gaps_w)
    sc2 = _scatter_trash(sc2.to(I32), rtl_s, sc2_w)
    col = _scatter_trash(col.to(I32), rtl_s, col_w)
    tws_final = _scatter_trash(tws, rtl_s, rws)
    retried = _scatter_trash(torch.zeros(T, dtype=torch.bool, device=dev),
                             rtl_s, torch.ones(RT, dtype=torch.bool,
                                               device=dev))
    runsat = rneed & ~retried
    wide_trace_over = _scatter_trash(
        torch.zeros(E, dtype=torch.bool, device=dev),
        torch.where(t_valid & runsat & twide, tl, E),
        torch.ones(T, dtype=torch.bool, device=dev))
    row_fallback = wide_over | wide_trace_over

    raweff = torch.maximum(g_w, dp_w).to(I32)
    dp_beat = (dp_w > g_w).to(I32)
    packed = ((torch.clamp(n_sites, 0, 2 ** 22) << 8)
              | (wstrand.to(I32) << 2) | (dp_beat << 1)
              | row_fallback.to(I32))
    esc_i32 = torch.stack([esc_idx, best_e.to(I32), second_full.to(I32),
                           wdiag.to(I32), raweff, packed], dim=1)
    trace_i32 = torch.stack([tloc, ln, gaps, sc2, col, tws_final,
                             retried.to(I32)], dim=1)
    return {"meta": meta, "esc": esc_i32, "trace": trace_i32, "sym": sym,
            "rloc": rloc, "sym_w": sym_w}


ESC_COLS = ("idx", "best", "second", "wdiag", "raweff", "packed")
TRACE_COLS = ("tloc", "ln", "gaps", "sc2", "col", "tws", "retried")


class FusedRun:
    """Result of a fused dispatch; ``host()`` copies it to numpy and
    unpacks it into the JAX package's result dict."""

    def __init__(self, outs: Dict[str, torch.Tensor], L: int, Cn: int,
                 Cw: int, pair: bool = False):
        self._outs = outs
        self._L = L
        self._Cn = Cn
        self._Cw = Cw
        self._pair = pair

    def host(self) -> Dict[str, np.ndarray]:
        o = {k: v.cpu().numpy() for k, v in self._outs.items()}
        meta, esc_i32, trace_i32 = o["meta"], o["esc"], o["trace"]
        L = self._L
        d = {
            "best_score": meta[:, 0],
            "best_diag": meta[:, 1],
            "best_strand": meta[:, 2],
            "second_score": meta[:, 3],
            "n_good": meta[:, 4],
        }
        flags = meta[:, 6] if self._pair else meta[:, 5]
        if self._pair:
            d["eff"] = meta[:, 5]
        d["li_plaus"] = (flags & 1).astype(bool)
        d["hi_over"] = ((flags >> 1) & 1).astype(bool)
        esc = {k: esc_i32[:, i] for i, k in enumerate(ESC_COLS)}
        pk = esc.pop("packed")
        esc["n_sites"] = pk >> 8
        esc["wstrand"] = (pk >> 2) & 1
        esc["dp_beat"] = ((pk >> 1) & 1).astype(bool)
        esc["fb"] = (pk & 1).astype(bool)
        tr = {k: trace_i32[:, i] for i, k in enumerate(TRACE_COLS)}
        T = trace_i32.shape[0]
        sym = np.zeros((T, L + self._Cw), np.uint8)
        sym_n = o["sym"]
        wn = min(sym_n.shape[1], L + self._Cn)
        sym[:, :wn] = sym_n[:, :wn]
        rloc = o["rloc"]
        r_ok = rloc < 2 ** 30
        if r_ok.any():
            sym[rloc[r_ok]] = o["sym_w"][r_ok][:, :L + self._Cw]
        tr["sym"] = sym
        d["_esc"] = esc
        d["_trace"] = tr
        return d


def _to_dev(a: np.ndarray, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


def _upload_words(a: Optional[np.ndarray], dev) -> Optional[torch.Tensor]:
    """uint32 words -> int64 device tensor holding the same values."""
    if a is None:
        return None
    return _to_dev(a.astype(np.int64), dev)


def _quality_inputs(cfg: QmConfig, dindex: DeviceIndex, quality, L: int,
                    den2: float, den3: float):
    """Quality-derived (offsets, weights, reject) on the device. One route
    a device type: on a card always the device stage (palette-packed, or
    raw when the batch has too many distinct quality values), whether or
    not the native host library is built; on the CPU the native host
    stage when that library is available, as the JAX package does, else
    the same device stage on CPU tensors. Same results by every route."""
    dev = dindex.device
    k = dindex.k
    host_os = None
    if dev.type == "cpu":
        host_os = native.quality_offsets_scores(
            quality, L, k, seed_host.PROB_CORRECT,
            np.asarray(cfg.offsets_list, np.int32), den3, 100 * k)
    if host_os is not None:
        o16, s16, rej = host_os
        inv_a = torch.tensor(float(np.float32(1.0) / np.float32(100 * k)),
                             dtype=torch.float32, device=dev)
        offs = _to_dev(o16, dev, I32)
        wts = _to_dev(s16, dev, torch.float32) * inv_a
        return offs, wts, _to_dev(rej, dev)
    qpack, pal, pcp = qd.pack_quality_host(quality, L)
    if qpack is not None:
        return qd.quality_offsets_stage_packed(
            cfg, _upload_words(qpack, dev), _to_dev(pal, dev),
            _to_dev(pcp, dev), den2, den3, return_weights=True)
    return qd.quality_offsets_stage(cfg, _to_dev(quality[:, :L], dev),
                                    den2, den3, return_weights=True)


def build_fused(dindex: DeviceIndex, L: int, B: int, chain_dist: int = 400,
                min_ratio: float = 0.56,
                max_list_length: Optional[int] = None, profile=None):
    """Returns fused(bases_ascii (B, L), quality=None) -> FusedRun."""
    fcfg = make_fused_config(dindex, L, B, chain_dist, min_ratio,
                             max_list_length, profile)
    cfg = fcfg.qm
    den2, den3 = seed_host.key_density_ladder(L, dindex.k)
    dev = dindex.device

    def run(bases, quality=None) -> FusedRun:
        codes2, nm = pack_reads_host(np.ascontiguousarray(bases[:, :L]))
        rcodes = unpack_reads_device(_upload_words(codes2, dev),
                                     _upload_words(nm, dev), L)
        offs = wts = rej = None
        if quality is not None:
            offs, wts, rej = _quality_inputs(cfg, dindex, quality, L,
                                             den2, den3)
        outs = fused_stage(fcfg, rcodes, dindex, offsets_dyn=offs,
                           weights_dyn=wts, reject=rej)
        return FusedRun(outs, L, fcfg.Cn, fcfg.Cw)

    run.fcfg = fcfg
    return run


def paired_min_gate(profile, L: int, min_ratio: float) -> int:
    """The relaxed paired-site retention score (reference:
    AbstractMapThread.java:106 removeLowQualitySitesPaired)."""
    ratio_paired = max(min_ratio * 0.80, 1 - (1 - min_ratio) * 1.4)
    return int(profile.max_quality(L) * ratio_paired)


def build_fused_pair(dindex: DeviceIndex, L: int, Bp: int,
                     chain_dist: int = 400, min_ratio: float = 0.56,
                     max_list_length: Optional[int] = None, profile=None):
    """Paired fused program (reference: BBMapThread.processReadPair:943 —
    quickMap x2 -> pairSiteScoresFinal -> scoreSlow -> traceback).
    Returns run(bases1, bases2, apd, quality1=None, quality2=None) ->
    FusedRun over the 2*Bp rows (mate-1 rows then mate-2 rows)."""
    fcfg = make_fused_config(dindex, L, 2 * Bp, chain_dist, min_ratio,
                             max_list_length, profile)
    cfg = fcfg.qm
    if profile is None:
        profile = SHORT_PROFILE
    min_gate = paired_min_gate(profile, L, min_ratio)
    den2, den3 = seed_host.key_density_ladder(L, dindex.k)
    dev = dindex.device

    def run(bases1, bases2, apd: int, quality1=None, quality2=None
            ) -> FusedRun:
        c2a, nma = pack_reads_host(np.ascontiguousarray(bases1[:, :L]))
        c2b, nmb = pack_reads_host(np.ascontiguousarray(bases2[:, :L]))
        r1 = unpack_reads_device(_upload_words(c2a, dev),
                                 _upload_words(nma, dev), L)
        r2 = unpack_reads_device(_upload_words(c2b, dev),
                                 _upload_words(nmb, dev), L)
        rcodes = torch.cat([r1, r2], dim=0)
        offs = wts = rej = None
        if quality1 is not None:
            qcat = np.vstack([quality1[:, :L], quality2[:, :L]])
            offs, wts, rej = _quality_inputs(cfg, dindex, qcat, L, den2,
                                             den3)
        outs = fused_stage(fcfg, rcodes, dindex, offsets_dyn=offs,
                           weights_dyn=wts, reject=rej,
                           pair={"apd": int(np.int32(apd)),
                                 "min_gate": min_gate})
        return FusedRun(outs, L, fcfg.Cn, fcfg.Cw, pair=True)

    run.fcfg = fcfg
    run.min_gate = min_gate
    return run
