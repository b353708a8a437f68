"""The pair-overlap scan of bbmerge (and of bbduk's ``tbo=``) as torch
tensor code on one device: the port of the JAX package's
``ops/overlap_device.py`` (its ratio program and mismatch program, with
the same outputs: insert int32, bad int32, ambig bool per pair).

Each program is a ladder over insert sizes (ratio mode) or overlap
lengths (mismatch mode), sequential in the insert, with its decision
state vectorised across the pairs. The counts of an insert do not depend
on that state, so they come first, for blocks of inserts at once: the
(B, inserts, overlap) windows of both reads are gathered, compared and
summed. The ladder then runs one insert at a time on (B,) tensors, one
short chain of elementwise launches a step.

Numerics. The ratio ladder is float32 and matches the JAX program bit
for bit: every product and sum in its order, every constant a float32,
no fused multiply-add (each elementwise op is its own launch), and every
division by a tensor on the device (PyTorch turns a division by a host
scalar into a multiplication by its reciprocal). The mismatch mode's
quality gate is the host's float64 table (``_counted_table``), as in the
JAX program.

The numpy ladders of ``ops/overlap.py`` (``*_plain``) are the plain
versions these are held against. Every entry point runs on the device it
is given: 'cuda' without a card raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend
from .overlap import PROB_CORRECT

_N = ord("N")
F32 = torch.float32
I32 = torch.int32
# elements of one (B, inserts, overlap) block of the counts step
COUNT_BLOCK_ELEMENTS = 1 << 27

ROUTES = ("ratio", "mismatch")
# ladders run since the last reset_scans(), by program
scans: Dict[str, int] = {}


def reset_scans() -> None:
    scans.update(dict.fromkeys(ROUTES, 0))


reset_scans()


def _f32(value, device) -> torch.Tensor:
    """A float32 constant on the device (what ``F32(...)`` is in JAX)."""
    return torch.tensor(np.float32(value), dtype=F32, device=device)


def _upload(x: np.ndarray, pad: int, device) -> torch.Tensor:
    """(B, L) host array -> device tensor padded with ``pad`` zero
    columns, so that every window start + lane stays in bounds."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return F.pad(t, (0, pad))


def _window_blocks(n: int, B: int, maxol: int):
    """Slices of ``n`` inserts, each a block of at most
    ``COUNT_BLOCK_ELEMENTS`` (B, inserts, maxol) elements."""
    step = max(1, COUNT_BLOCK_ELEMENTS // max(1, B * maxol))
    return [slice(t, min(n, t + step)) for t in range(0, n, step)]


def _windows(x: torch.Tensor, starts: torch.Tensor,
             lane: torch.Tensor) -> torch.Tensor:
    """(B, L + pad) -> (B, T, maxol): the windows x[:, s:s + maxol] for
    the T starts."""
    return x[:, starts[:, None] + lane]


# ---------------------------------------------------------------------------
# ratio mode (the reference default)
# ---------------------------------------------------------------------------

def _ratio_tables(alen: int, blen: int, min_overlap0: int,
                  min_overlap: int, min_insert0: int, min_insert: int):
    """Static per-insert geometry, mirroring the host loop exactly."""
    min_overlap = max(4, min_overlap0, min_overlap)
    min_overlap0 = int(np.clip(min_overlap0, 4, min_overlap))
    largest = alen + blen - min_overlap0
    smallest = min_insert0
    inserts = np.arange(largest, smallest - 1, -1, dtype=np.int32)
    istart = np.where(inserts <= blen, 0, inserts - blen)
    jstart = np.where(inserts >= blen, 0, blen - inserts)
    olen = np.minimum(np.minimum(alen - istart, blen - jstart), inserts)
    fb = (min_insert <= inserts) & (inserts <= alen + blen - min_overlap)
    return (inserts, istart.astype(np.int32), jstart.astype(np.int32),
            olen.astype(np.int32), fb, min_overlap, min_overlap0)


def mate_by_overlap_ratio_device(
        a_bases: np.ndarray, b_bases: np.ndarray,
        min_overlap0: int = 5, min_overlap: int = 8,
        min_insert0: int = 26, min_insert: int = 35,
        max_ratio: float = 0.09, min_second_ratio: float = 0.1,
        margin: float = 5.5, offset: float = 0.55,
        g_incr: float = 0.95, b_incr: float = 0.95, *, device
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device twin of ``overlap.mate_by_overlap_ratio_batch_plain``:
    a_bases (B, alen), b_bases (B, blen) uint8 ASCII, b already in read
    1's orientation. Returns (insert (B,) int32, -1 for no merge; bad
    (B,) int32; ambig (B,) bool)."""
    dev = backend.resolve_device(device)
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    (inserts, istart, jstart, olen, fb, mo, mo0) = _ratio_tables(
        alen, blen, min_overlap0, min_overlap, min_insert0, min_insert)
    min_length = min(alen, blen)
    maxol = int(olen.max()) if len(olen) else 0
    if maxol <= 0:
        return (np.full(B, -1, np.int32), np.full(B, min_length, np.int32),
                np.zeros(B, bool))
    scans["ratio"] += 1
    a = _upload(a_bases, maxol, dev)
    b = _upload(b_bases, maxol, dev)
    lane = torch.arange(maxol, device=dev)
    ist = torch.from_numpy(istart.astype(np.int64)).to(dev)
    jst = torch.from_numpy(jstart.astype(np.int64)).to(dev)
    ol = torch.from_numpy(olen.astype(np.int64)).to(dev)
    n = len(inserts)

    # counts of every insert, a block of inserts at a time
    goods = torch.empty((n, B), dtype=F32, device=dev)
    bads = torch.empty((n, B), dtype=F32, device=dev)
    for sl in _window_blocks(n, B, maxol):
        ai = _windows(a, ist[sl], lane)
        bj = _windows(b, jst[sl], lane)
        m = lane < ol[sl, None]
        eq = (ai == bj) & m
        nn = (ai != _N) & m
        goods[sl] = (eq & nn).sum(dim=2, dtype=I32).T.to(F32) * \
            np.float32(g_incr)
        bads[sl] = ((~eq) & m).sum(dim=2, dtype=I32).T.to(F32) * \
            np.float32(b_incr)
        del ai, bj, m, eq, nn
    valid = ol > 0
    olen_f = ol.to(F32)
    inf = _f32(np.inf, dev)
    ratios = torch.where(valid[:, None],
                         (bads + _f32(offset, dev))
                         / olen_f.clamp(min=1)[:, None], inf)
    fb_t = torch.from_numpy(fb).to(dev)
    x = torch.where((fb_t & valid)[:, None], ratios, inf).amin(dim=0)
    x = torch.minimum(x, _f32(max_ratio + 0.0001, dev))
    max_ratio_t = _f32(max_ratio, dev)
    no_solution = x > max_ratio_t
    max_ratio_v = torch.minimum(max_ratio_t, x)

    margin_t = _f32(margin, dev)
    margin2 = _f32((margin + offset) / min_length, dev)
    second_min = _f32(min_second_ratio, dev)
    extra_mult = _f32(1.2, dev)
    one = _f32(1.0, dev)
    ins_t = torch.from_numpy(inserts).to(dev)
    best_insert = torch.full((B,), -1, dtype=I32, device=dev)
    best_bad = torch.full((B,), float(min_length), dtype=F32, device=dev)
    best_ratio = torch.ones((B,), dtype=F32, device=dev)
    second_ratio = torch.ones((B,), dtype=F32, device=dev)
    ambig = torch.zeros((B,), dtype=torch.bool, device=dev)
    done = no_solution.clone()
    early_neg = no_solution.clone()
    for t in range(n):
        if olen[t] <= 0:
            continue
        good, bad, ratio = goods[t], bads[t], ratios[t]
        badlimit = extra_mult * (torch.minimum(best_ratio, max_ratio_v)
                                 * margin_t * olen_f[t]) + one
        cond0 = (~done) & (bad <= badlimit)
        e1 = cond0 & (bad == 0) & (good > mo0) & (good < mo)
        ambig |= e1
        early_neg |= e1
        done |= e1
        c2 = cond0 & (~e1) & (ratio < best_ratio * margin_t)
        new_ambig = (ratio * margin_t >= best_ratio) | (good < mo)
        ambig = torch.where(c2, new_ambig, ambig)
        improve = c2 & (ratio < best_ratio)
        second_ratio = torch.where(improve, best_ratio, second_ratio)
        best_insert = torch.where(improve, ins_t[t], best_insert)
        best_bad = torch.where(improve, bad, best_bad)
        best_ratio = torch.where(improve, ratio, best_ratio)
        tie2 = c2 & (~improve) & (ratio < second_ratio)
        second_ratio = torch.where(tie2, ratio, second_ratio)
        f = c2 & ((ambig & (best_ratio < margin2))
                  | (second_ratio < second_min))
        early_neg |= f
        done |= f
    final_neg = early_neg | ((~ambig) & (best_ratio > max_ratio_v))
    insert_out = torch.where(final_neg, -1, best_insert)
    return (insert_out.to(I32).cpu().numpy(),
            best_bad.to(I32).cpu().numpy(), ambig.cpu().numpy())


# ---------------------------------------------------------------------------
# mismatch mode
# ---------------------------------------------------------------------------

def _counted_table(minq: int) -> np.ndarray:
    """(16384,) bool: PROB_CORRECT[qa]*PROB_CORRECT[qb] > minprob,
    evaluated host-side in float64 so the device matches the host gate
    bit for bit."""
    minprob = PROB_CORRECT[min(max(1, minq), 41)]
    p = PROB_CORRECT
    return ((p[:, None] * p[None, :]) > minprob).ravel()


def mate_by_overlap_device(
        a_bases: np.ndarray, a_qual: Optional[np.ndarray],
        b_bases: np.ndarray, b_qual: Optional[np.ndarray],
        min_overlap0: int = 8, min_overlap: int = 11,
        min_insert0: int = 35, margin: int = 2,
        max_mismatches0: int = 3, max_mismatches: int = 3,
        minq: int = 10, *, device
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device twin of ``overlap.mate_by_overlap_batch_plain``: bases as
    in the ratio mode, quals phred (B, alen) / (B, blen) or None. Returns
    (insert (B,) int32, -1 for no merge; bad (B,) int32; ambig (B,)
    bool)."""
    dev = backend.resolve_device(device)
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    min_overlap0 = min(max(1, min_overlap0), min_overlap)
    margin = max(margin, 0)
    max_overlap = alen + blen - max(min_overlap, min_insert0)
    ovr = np.arange(max(min_overlap0, 0), max_overlap, dtype=np.int32)
    istart = np.where(ovr <= alen, 0, ovr - alen).astype(np.int32)
    jstart = np.where(ovr <= alen, alen - ovr, 0).astype(np.int32)
    iters = np.minimum(np.minimum(ovr - istart, blen - istart),
                       alen - jstart).astype(np.int32)
    keep = iters > 0
    ovr, istart, jstart, iters = (x[keep] for x in
                                  (ovr, istart, jstart, iters))
    maxol = int(iters.max()) if len(iters) else 0
    if maxol <= 0:
        return (np.full(B, -1, np.int32),
                np.full(B, max_mismatches0, np.int32), np.zeros(B, bool))
    scans["mismatch"] += 1
    have_q = a_qual is not None and b_qual is not None
    const_counted = (0.98 * 0.98) > PROB_CORRECT[min(max(1, minq), 41)]
    a = _upload(a_bases, maxol, dev)
    b = _upload(b_bases, maxol, dev)
    if have_q:
        aq = _upload(a_qual, maxol, dev).to(I32).clamp_(0, 127)
        bq = _upload(b_qual, maxol, dev).to(I32).clamp_(0, 127)
        tbl = torch.from_numpy(_counted_table(minq)).to(dev)
    lane = torch.arange(maxol, device=dev)
    ist = torch.from_numpy(istart.astype(np.int64)).to(dev)
    jst = torch.from_numpy(jstart.astype(np.int64)).to(dev)
    its = torch.from_numpy(iters.astype(np.int64)).to(dev)
    n = len(ovr)

    goods = torch.empty((n, B), dtype=I32, device=dev)
    bads = torch.empty((n, B), dtype=I32, device=dev)
    for sl in _window_blocks(n, B, maxol):
        aj = _windows(a, jst[sl], lane)
        bi = _windows(b, ist[sl], lane)
        m = (lane < its[sl, None]).expand(B, -1, -1)
        if have_q:
            qi = _windows(aq, jst[sl], lane) * 128 + \
                _windows(bq, ist[sl], lane)
            counted = tbl[qi] & m
            del qi
        else:
            counted = m if const_counted else torch.zeros_like(m)
        eq = aj == bi
        goods[sl] = (counted & eq).sum(dim=2, dtype=I32).T
        bads[sl] = (counted & (~eq)).sum(dim=2, dtype=I32).T
        del aj, bi, m, counted, eq

    ovr_t = torch.from_numpy(ovr).to(dev)
    best_overlap = torch.full((B,), -1, dtype=I32, device=dev)
    best_good = torch.full((B,), -1, dtype=I32, device=dev)
    best_bad = torch.full((B,), max_mismatches0, dtype=I32, device=dev)
    ambig = torch.zeros((B,), dtype=torch.bool, device=dev)
    done = torch.zeros_like(ambig)
    early_ret = torch.zeros_like(ambig)
    for t in range(n):
        good, bad = goods[t], bads[t]
        cand = (~done) & (bad * 2 < good)
        c1 = cand & (good > min_overlap) & (bad <= best_bad)
        winner = c1 & ((bad < best_bad)
                       | ((bad == best_bad) & (good > best_good)))
        ambig |= winner & (best_bad - bad < margin)
        ambig |= c1 & (~winner) & (bad == best_bad)
        best_overlap = torch.where(winner, ovr_t[t], best_overlap)
        best_good = torch.where(winner, good, best_good)
        best_bad = torch.where(winner, bad, best_bad)
        f = c1 & ambig & (best_bad < margin)
        early_ret |= f
        done |= f
        g = cand & (~(good > min_overlap)) & (bad < margin)
        ambig |= g
        early_ret |= g
        done |= g
    no_sln = (~ambig) & (best_bad > max_mismatches - margin)
    best_overlap = torch.where(no_sln | early_ret, -1, best_overlap)
    insert = torch.where(best_overlap < 0, -1,
                         alen + blen - best_overlap)
    return (insert.to(I32).cpu().numpy(), best_bad.cpu().numpy(),
            ambig.cpu().numpy())
