"""Batched banded edit distance on a torch device — Dedupe's verification
hot loop (reference: jni/BandedAlignerJNI.c:588-716
alignForward/RC/Reverse/RC, align2/BandedAlignerConcrete.java), the
PyTorch port of bbmap_tpu/ops/banded_device.py.

The JAX package runs it as one jitted ``lax.scan`` over the rows with
the band (2*maxEdits+1 diagonals) on the lanes. Here:

- ``banded_edit`` is the kernel's wrapper. Given CUDA tensors it makes
  one launch of the hand-written kernel ``csrc/banded_edit.cu`` (four
  pairs a thread in the byte lanes of a word, the "quad" body, for bands
  of up to 15 cells whose operands it can read a word at a time; else a
  thread a pair for bands of up to 64 cells, a warp a pair past that: the
  wrapper picks from E and the layout) and adds one to
  ``banded_edit.launches`` (and ``launches_by[mapping]``); given CPU
  tensors it runs the plain version and counts nothing.
- ``banded_edit_batch_plain`` is the plain version: the JAX row scan as
  torch ops on any device, the insertion sweep closed into ``cummin``.
  It drops a pair once its whole band is past max_edits (the rest of the
  scan would leave it there, so the value is the same).
- ``banded_any`` is the block kernel's wrapper (the block mapping of
  ``csrc/banded_edit.cu``): a block of queries against one class of
  sequences in one launch, one flag a query (``any(d <= E)``), or the
  queries against each other (the lower triangle of ``d <= E``);
  ``banded_any_plain`` is its plain version (``banded_edit_batch_plain``
  over every pair, then ``any``). Its launches count in
  ``banded_any.launches``, ``launches_by["class" | "triangle"]`` and by
  band body in ``launches_by_body["quad" | "thread"]``: four kept
  sequences a thread (2E + 1 <= 15, the class's words aligned) or one.
- ``contained_any`` is the containment mapping's wrapper (dedupe's
  containment check, ``csrc/banded_edit.cu``): a block of queries against
  the windows cut for them from kept containers, named by a pair table
  (``upload_windows``: the windows and the table in one pinned,
  non-blocking copy), both read orientations, the reverse complement read
  from the forward column through the complement table, in one launch;
  one flag a query (any pair within tol, E = 2 tol, infix).
  ``contained_mapping`` picks the kernel's mapping from the pair count,
  tol and the operands' lengths: "split" (a warp a pair, the rows split
  over the lanes) below ``CONTAINED_SPLIT_BELOW`` pairs where 4 tol + 1 <=
  ``CONTAINED_SPLIT_MAX_CELLS``, else a thread an orientation with the
  block's operands staged in shared memory ("staged") or, past
  ``CONTAINED_STAGE_MAX`` bytes, read in place through a ring of registers
  ("ring"), and a warp an orientation past 64 band cells ("warp"); the
  first body, read in place a row ahead ("inplace"), only where forced.
  ``contained_any_plain`` is its plain version (``banded_edit_batch_plain``
  over the table in both orientations). Its launches count in
  ``contained_any.launches`` and ``launches_by[mapping]``, its pairs in
  ``contained_any.pairs``.
- ``banded_edit_batch``, ``contained_distances`` and
  ``edit_distances_vs_one`` are the JAX package's entry points on numpy
  arrays, with ``device=``; ``SequenceStore`` keeps Dedupe's kept
  sequences on the device in length classes, checks a block of queries
  (``upload_block``, one upload) against them a launch a near class, and
  keeps a block's kept reads a copy a class.

Tensors are position-major (pair-minor): byte (pos, pair) of ``a`` (La,
n) and ``b`` (Lb, n) at [pos, pair], so that the kernel's neighbouring
threads read neighbouring bytes; ``a`` may be one query (La,) that every
pair reads. Results (n,) int32, saturated at max_edits + 1, equal value
by value to the JAX scan (tests/test_torch_banded.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import backend
from ..core.bases import COMP_ASCII
from . import _build

I32 = torch.int32
# banded_edit's mappings: four pairs a thread, a thread a pair, a warp a
# pair; the block kernel's band bodies
MAPPINGS = ("quad", "thread", "warp")
BODIES = ("quad", "thread")
# The containment kernel's mappings, by their codes in
# banded_contained_launch, and the limits of its rule
# (``contained_mapping``): "split" below CONTAINED_SPLIT_BELOW pairs (the
# pair-count sweep of chip_smoke.py's containment phase) where 4 tol + 1 <=
# CONTAINED_SPLIT_MAX_CELLS (the maps' values in a byte lane's headroom
# code: BIG <= 7); the thread bodies to THREAD_MAX_CELLS band cells,
# "staged" where a block's CONTAINED_STAGE_PAIRS pairs' rows take at most
# CONTAINED_STAGE_MAX bytes of shared memory.
CONTAINED_MAPPINGS = ("split", "staged", "ring", "warp", "inplace")
_CONTAINED_CODES = {"inplace": 0, "staged": 1, "ring": 2, "warp": 3,
                    "split": 4}
CONTAINED_SPLIT_BELOW = 2304
CONTAINED_SPLIT_MAX_CELLS = 13
THREAD_MAX_CELLS = 64
CONTAINED_STAGE_PAIRS = 64
CONTAINED_STAGE_MAX = 48 * 1024 - 512
# who made a banded_edit launch (banded_edit's ``site=``): a containment
# check a read (contained_distances), dedupe's check of a read against the
# containers kept earlier in its own block, or another caller (the store
# check is banded_any's, the block's containment check contained_any's)
SITES = ("containment", "containment_in_block", "other")
# rows of the plain scan between two looks for saturated pairs
PLAIN_CHECK_ROWS = 8
# The block mapping (banded_any): class sequences a block on the thread
# body (a thread each; the store's capacities and upload_block's pitch are
# multiples of it) and on the quad body (four a thread), the widest E its
# thread band holds (2E + 1 <= 64 cells), the queries a block at most, the
# blocks an SM its query groups aim for, and the shared memory a block of
# the thread body may stage (two blocks an SM) before it reads in place.
BLOCK_TILE = 128
BLOCK_QUAD_TILE = 512
BLOCK_MAX_E = 31
BLOCK_MAX_GROUP = 64
BLOCK_AIM_PER_SM = 16
BLOCK_STAGE_MAX = 96 * 1024
# pairs a call of the plain version takes at once (bounded scratch)
PLAIN_ANY_PAIRS = 1 << 21
ANY_MODES = ("class", "triangle")

def _lib() -> ctypes.CDLL:
    lib = _build.load("banded_edit")
    if not getattr(lib, "_bbmap_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.banded_edit_launch.argtypes = [
            vp, ll, ll, vp, ll, vp, ll, ll, vp, ll,
            ci, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.banded_edit_launch.restype = ci
        lib.banded_edit_scratch_ints.argtypes = [ci]
        lib.banded_edit_scratch_ints.restype = ll
        lib.banded_edit_thread_max_cells.restype = ci
        lib.banded_edit_quad_max_cells.restype = ci
        lib.banded_block_launch.argtypes = [
            vp, ll, vp, ci, ci, vp, ll, vp, ci, ci, ci, ci, ci, ci, ci, vp,
            vp]
        lib.banded_block_launch.restype = ci
        lib.banded_block_smem.argtypes = [ci, ci, ci]
        lib.banded_block_smem.restype = ci
        lib.banded_block_tile.argtypes = [ci]
        lib.banded_block_tile.restype = ci
        lib.banded_contained_launch.argtypes = [
            vp, ll, vp, ci, vp, ll, ci, vp, ci, ci, ci, vp, vp, vp]
        lib.banded_contained_launch.restype = ci
        lib.banded_contained_clocks.argtypes = [vp]
        lib.banded_contained_clocks.restype = ci
        lib._bbmap_typed = True
    return lib


def _check(a, la, b, lb) -> None:
    if a.dim() not in (1, 2) or b.dim() != 2 or la.dim() != 1 \
            or lb.dim() != 1:
        raise ValueError("a (La, n) or (La,), b (Lb, n), la and lb (n,) "
                         "expected")
    n = lb.shape[0]
    if b.shape[1] != n or la.shape[0] != n or (a.dim() == 2
                                               and a.shape[1] != n):
        raise ValueError("a, la, b and lb disagree on the pair count")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("a and b must be uint8")
    if la.dtype != I32 or lb.dtype != I32:
        raise TypeError("la and lb must be int32")
    if not (a.device == la.device == b.device == lb.device):
        raise ValueError("a, la, b and lb must share one device")


def banded_edit_batch_plain(a: torch.Tensor, la: torch.Tensor,
                            b: torch.Tensor, lb: torch.Tensor,
                            max_edits: int, infix: bool = False,
                            rows_out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of the kernel on any device: a (La, n) uint8 or one
    query (La,), la (n,) int32, b (Lb, n) uint8, lb (n,) int32. Returns
    (n,) int32 saturated at max_edits + 1 (``infix``: a's best match to any
    infix of b). ``rows_out`` (n,) int32, when given, receives the rows
    the kernel's scan runs for each pair: 0 for a global pair whose
    lengths differ by more than max_edits, else the row at which its band
    saturates, or min(la, La)."""
    _check(a, la, b, lb)
    dev = b.device
    n = lb.shape[0]
    E = int(max_edits)
    w, BIG = 2 * E + 1, E + 1
    La, Lb = a.shape[0], b.shape[0]
    out = torch.full((n,), BIG, dtype=I32, device=dev)
    if rows_out is not None:
        rows_out.copy_(torch.minimum(la, torch.tensor(La, dtype=I32,
                                                      device=dev)))
    if n == 0:
        return out
    la, lb = la.to(I32), lb.to(I32)
    idx = torch.arange(n, device=dev)
    if not infix:
        # the global result needs |lb - la| <= E: the others stay BIG
        keep = (lb - la).abs() <= E
        if rows_out is not None:
            rows_out[~keep] = 0
        idx = idx[keep]
    shared = a.dim() == 1
    d_idx = torch.arange(w, dtype=I32, device=dev)[:, None]
    la_c, lb_c = la[idx], lb[idx]
    a_c = a if shared else a[:, idx]
    j0 = d_idx - E
    ok0 = (j0 >= 0) & (j0 <= lb_c[None, :])
    prev = torch.where(ok0, torch.zeros_like(j0) if infix
                       else j0.clamp(min=0), torch.full_like(j0, BIG))
    prev = torch.minimum(prev, torch.tensor(BIG, dtype=I32, device=dev))
    prev = prev.expand(w, idx.numel()).contiguous()
    Lmax = min(La, int(la_c.max())) if idx.numel() else 0
    # b padded so that the window of row i is bp[i : i + w], b[i - E - 1
    # + d] (255 outside b, as the JAX package pads)
    bp = torch.full((E + 1 + Lb + Lmax + w + 2, idx.numel()), 255,
                    dtype=torch.uint8, device=dev)
    bp[E + 1:E + 1 + Lb] = b[:, idx]
    big_row = torch.full((1, idx.numel()), BIG, dtype=I32, device=dev)
    i = 1
    while i <= Lmax:
        win = bp[i:i + w]
        ai = a_c[i - 1] if shared else a_c[i - 1][None, :]
        js = i - E + d_idx
        valid = (js >= 1) & (js <= lb_c[None, :])
        sub = prev + (win != ai).to(I32)
        up = torch.cat([prev[1:], big_row], 0) + 1
        cur = torch.where(valid, torch.minimum(sub, up), BIG)
        cur = torch.minimum(torch.cummin(cur - d_idx, 0).values + d_idx, cur)
        cur = torch.clamp(cur, max=BIG)
        active = i <= la_c
        prev = torch.where(active[None, :], cur, prev)
        if rows_out is not None:
            sat = active & (prev > E).all(0)
            rows_out[idx[sat]] = torch.minimum(
                rows_out[idx[sat]], torch.tensor(i, dtype=I32, device=dev))
        if i % PLAIN_CHECK_ROWS == 0 or i == Lmax:
            # a band all past E stays so: its result is BIG; drop it
            alive = (prev <= E).any(0)
            if not bool(alive.all()):
                idx, la_c, lb_c, prev, bp = (
                    idx[alive], la_c[alive], lb_c[alive], prev[:, alive],
                    bp[:, alive])
                if not shared:
                    a_c = a_c[:, alive]
                big_row = big_row[:, alive]
                if idx.numel() == 0:
                    break
                Lmax = min(Lmax, int(la_c.max()))
        i += 1
    if idx.numel() == 0:
        return out
    if infix:
        jsf = la_c[None, :] - E + d_idx
        okf = (jsf >= 0) & (jsf <= lb_c[None, :])
        res = torch.where(okf, prev, BIG).amin(0)
    else:
        d_final = lb_c - la_c + E
        res = prev.gather(0, d_final.clamp(0, w - 1)[None, :].long())[0]
    out[idx] = res.to(I32)
    return out


def _on_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(
            f"the banded kernel runs on CUDA tensors (got {t.device})")


def words_fit(x: torch.Tensor, n: int) -> bool:
    """Whether x (L, n) uint8, position-major with a pair stride of 1, can
    be read in aligned 4-byte words of four pairs (the four-lane body): its
    base and row pitch multiples of 4 and every row's bytes up to n
    rounded up to 4 within its storage."""
    ps = x.stride(0)
    if x.stride(1) != 1 or ps % 4 or x.data_ptr() % 4:
        return False
    end = x.storage_offset() + (x.shape[0] - 1) * ps + -(-n // 4) * 4
    return x.shape[0] == 0 or end <= x.untyped_storage().nbytes()


def _quad_layout(a: torch.Tensor, b: torch.Tensor, n: int) -> bool:
    """b and a readable a word of four pairs a position (a may be shared:
    one query, or a pair stride of 0)."""
    return words_fit(b, n) and (a.dim() == 1 or a.stride(1) == 0
                                or words_fit(a, n))


def _pick(mapping: Optional[str], quad_ok: bool, widest: str) -> str:
    """The band body: ``mapping`` where given ("quad" or "thread", for a
    comparison on the card; the quad body only where ``quad_ok``), else
    the quad body where it applies, else ``widest``."""
    if mapping is None:
        return "quad" if quad_ok else widest
    if mapping not in BODIES or (mapping == "quad" and not quad_ok) or (
            mapping == "thread" and widest != "thread"):
        raise ValueError(f"mapping={mapping!r} does not apply here (the "
                         f"quad body: {quad_ok}; else {widest})")
    return mapping


def banded_edit(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                lb: torch.Tensor, max_edits: int,
                infix: bool = False, site: str = "other",
                mapping: Optional[str] = None) -> torch.Tensor:
    """Banded edit distance of n pairs, in the layout of
    ``banded_edit_batch_plain`` (any strides; a pair stride of 0 shares a
    query or a length). CPU tensors: the plain version. CUDA tensors: one
    launch of ``csrc/banded_edit.cu``: four pairs a thread where 2E + 1 <=
    15 cells and b (and a, unless shared) are pair-minor with a pair stride
    of 1 and readable a 4-byte word at a time (``words_fit``), else a
    thread a pair where 2E + 1 <= 64 cells, else a warp a pair; a failed
    launch raises. ``mapping`` ("quad" or "thread") forces a body where it
    applies. ``site`` (one of ``SITES``) names the caller in
    ``launches_by_site``."""
    _check(a, la, b, lb)
    if b.device.type == "cpu":
        return banded_edit_batch_plain(a, la, b, lb, max_edits, infix)
    _on_cuda(b)
    n = lb.shape[0]
    E = int(max_edits)
    if E < 0:
        raise ValueError(f"max_edits={E} must be >= 0")
    out = torch.empty(n, dtype=I32, device=b.device)
    if n == 0:
        return out
    lib = _lib()
    mapping = _pick(mapping, 2 * E + 1 <= lib.banded_edit_quad_max_cells()
                    and _quad_layout(a, b, n),
                    "thread" if 2 * E + 1 <= lib.banded_edit_thread_max_cells()
                    else "warp")
    ints = lib.banded_edit_scratch_ints(E)
    scratch = torch.empty(n * ints if ints else 1, dtype=I32,
                          device=b.device)
    a_ps, a_pp = (a.stride(0), 0) if a.dim() == 1 else a.stride()
    err = lib.banded_edit_launch(
        a.data_ptr(), a_ps, a_pp, la.data_ptr(), la.stride(0), b.data_ptr(),
        b.stride(0), b.stride(1), lb.data_ptr(), lb.stride(0), n,
        a.shape[0], b.shape[0], E, int(bool(infix)), int(mapping == "quad"),
        out.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_edit_launch failed: cudaError {err}")
    banded_edit.launches += 1
    banded_edit.launches_by[mapping] += 1
    banded_edit.launches_by_site[site] += 1
    return out


def reset_launches() -> None:
    banded_edit.launches = 0
    banded_edit.launches_by = dict.fromkeys(MAPPINGS, 0)
    banded_edit.launches_by_site = dict.fromkeys(SITES, 0)
    banded_any.launches = 0
    banded_any.launches_by = dict.fromkeys(ANY_MODES, 0)
    banded_any.launches_by_body = dict.fromkeys(BODIES, 0)
    contained_any.launches = 0
    contained_any.launches_by = dict.fromkeys(CONTAINED_MAPPINGS, 0)
    contained_any.pairs = 0


def _check_any(q, lq, s, ls) -> None:
    if q.dim() != 2 or lq.dim() != 1 or q.shape[1] != lq.shape[0]:
        raise ValueError("queries (Lq, Q) and lengths (Q,) expected")
    if s is not None and (s.dim() != 2 or ls.dim() != 1
                          or s.shape[1] != ls.shape[0]):
        raise ValueError("sequences (Ls, k) and lengths (k,) expected")
    for x in (q, s):
        if x is not None and x.dtype != torch.uint8:
            raise TypeError("queries and sequences must be uint8")
    for x in (lq, ls):
        if x is not None and x.dtype != I32:
            raise TypeError("lengths must be int32")
    if any(x is not None and x.device != q.device for x in (lq, s, ls)):
        raise ValueError("queries, sequences and lengths must share one "
                         "device")


def banded_any_plain(q: torch.Tensor, lq: torch.Tensor,
                     s: Optional[torch.Tensor], ls: Optional[torch.Tensor],
                     max_edits: int, tri: bool = False,
                     rows_out: Optional[list] = None) -> torch.Tensor:
    """Plain version of the block kernel on any device:
    ``banded_edit_batch_plain`` over every (query, sequence) pair, then
    ``any``. q (Lq, Q) uint8 position-major, lq (Q,) int32; s (Ls, k), ls
    (k,) the class. Returns (Q,) uint8, 1 where some sequence lies within
    max_edits of the query (global distance). ``tri``: s and ls are not
    read; returns (Q, Q) uint8 with [i, j] = d(query i, query j) <=
    max_edits for j < i, 0 elsewhere. ``rows_out``, when given a list,
    receives the rows the kernel's scan runs for the pairs, summed (the
    cells the data needs, over the band width)."""
    _check_any(q, lq, s, ls)
    dev, Q = q.device, q.shape[1]
    if tri:
        s, ls = q, lq
    k = s.shape[1]
    E = int(max_edits)
    out = torch.zeros((Q, Q) if tri else (Q,), dtype=torch.uint8,
                      device=dev)
    ii, jj = (torch.tril_indices(Q, Q, -1, device=dev) if tri else
              torch.cartesian_prod(torch.arange(Q, device=dev),
                                   torch.arange(k, device=dev)).T)
    for a0 in range(0, ii.numel(), PLAIN_ANY_PAIRS):
        i, j = ii[a0:a0 + PLAIN_ANY_PAIRS], jj[a0:a0 + PLAIN_ANY_PAIRS]
        rows = None if rows_out is None else torch.zeros(
            i.numel(), dtype=I32, device=dev)
        hit = banded_edit_batch_plain(q[:, i], lq[i], s[:, j], ls[j], E,
                                      rows_out=rows) <= E
        if rows_out is not None:
            rows_out.append(int(rows.long().sum()))
        if tri:
            out[i, j] = hit.to(torch.uint8)
        else:
            out[i[hit]] = 1
    return out


def block_groups(Q: int, k: int, device, tile: int = BLOCK_QUAD_TILE) -> int:
    """Queries a block of the block kernel takes: as many as leave
    ``BLOCK_AIM_PER_SM`` blocks an SM over the class's tiles of ``tile``
    sequences, at most ``BLOCK_MAX_GROUP``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-k // tile)
    groups = max(1, min(Q, -(-BLOCK_AIM_PER_SM * sms // tiles)))
    return min(BLOCK_MAX_GROUP, max(1, Q // groups))


def banded_any(q: torch.Tensor, lq: torch.Tensor, s: Optional[torch.Tensor],
               ls: Optional[torch.Tensor], max_edits: int,
               tri: bool = False,
               mapping: Optional[str] = None) -> torch.Tensor:
    """Many queries against one class of sequences in one launch (the
    layout and result of ``banded_any_plain``; ``tri``: the queries
    against each other). CPU tensors: the plain version. CUDA tensors: one
    launch of the block mapping of ``csrc/banded_edit.cu`` for E up to
    ``BLOCK_MAX_E``: on the quad body (four sequences a thread, tiles of
    ``BLOCK_QUAD_TILE``, read in place) where 2E + 1 <= 15 and the class
    reads a 4-byte word at a time (``words_fit``), else on the thread body
    (tiles of ``BLOCK_TILE``, staged in shared memory where the class's
    pitch and a block's bytes allow); ``mapping`` ("quad" or "thread")
    forces one where it applies. Past ``BLOCK_MAX_E`` (dedupe's ``e=`` above
    31) the block design does not apply: a ``banded_edit`` launch a query
    (a warp a pair), looped here, so the launches grow with the reads
    again. A failed launch raises."""
    _check_any(q, lq, s, ls)
    if q.device.type == "cpu":
        return banded_any_plain(q, lq, s, ls, max_edits, tri)
    _on_cuda(q)
    E = int(max_edits)
    if E < 0:
        raise ValueError(f"max_edits={E} must be >= 0")
    Q = q.shape[1]
    if tri:
        s, ls = q, lq
    k = s.shape[1]
    out = torch.zeros((Q, Q) if tri else (Q,), dtype=torch.uint8,
                      device=q.device)
    if Q == 0 or k == 0:
        return out
    if q.stride(1) != 1 or s.stride(1) != 1:
        raise ValueError("queries and sequences must be position-major with "
                         "a pair stride of 1")
    if E > BLOCK_MAX_E:
        for i in range(1 if tri else 0, Q):
            d = banded_edit(q[:, i], lq[i].expand(i if tri else k),
                            s[:, :i] if tri else s,
                            ls[:i] if tri else ls, E)
            if tri:
                out[i, :i] = (d <= E).to(torch.uint8)
            else:
                out[i] = (d <= E).any().to(torch.uint8)
        return out
    lib = _lib()
    body = _pick(mapping, 2 * E + 1 <= lib.banded_edit_quad_max_cells()
                 and words_fit(s, k), "thread")
    quad = int(body == "quad")
    group = block_groups(Q, k, q.device, lib.banded_block_tile(quad))
    Lq, Ls = q.shape[0], s.shape[0]
    staged = not quad and s.stride(0) % 16 == 0 and s.data_ptr() % 16 == 0 \
        and s.stride(0) >= -(-k // BLOCK_TILE) * BLOCK_TILE \
        and lib.banded_block_smem(Ls, Lq, group) <= BLOCK_STAGE_MAX
    err = lib.banded_block_launch(
        q.data_ptr(), q.stride(0), lq.data_ptr(), Q, Lq, s.data_ptr(),
        s.stride(0), ls.data_ptr(), k, Ls, E, int(tri), group, int(staged),
        quad, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_block_launch failed: cudaError {err}")
    banded_any.launches += 1
    banded_any.launches_by["triangle" if tri else "class"] += 1
    banded_any.launches_by_body[body] += 1
    return out


def _check_contained(q, lq, w, table) -> None:
    _check_any(q, lq, None, None)
    if w.dim() != 2 or w.dtype != torch.uint8:
        raise ValueError("windows (Lw, n) uint8 expected")
    if table.dim() != 2 or table.shape[0] != 3 or table.dtype != I32:
        raise ValueError("a pair table (3, P) int32 expected")
    if not (w.device == table.device == q.device):
        raise ValueError("queries, windows and table must share one device")


def _reverse_complements(q: torch.Tensor, lq: torch.Tensor,
                         cols: torch.Tensor) -> torch.Tensor:
    """(Lq, n) uint8: the reverse complement of query cols[k] of q (Lq, Q)
    in column k (core/bases.COMP_ASCII; bytes past its length mean
    nothing)."""
    comp = torch.from_numpy(COMP_ASCII).to(q.device)
    back = lq[cols].long()[None, :] - 1 - torch.arange(
        q.shape[0], device=q.device)[:, None]
    return comp[q[back.clamp(min=0), cols[None, :]].long()]


def contained_any_plain(q: torch.Tensor, lq: torch.Tensor, w: torch.Tensor,
                        table: torch.Tensor, tol: int,
                        rows_out: Optional[list] = None) -> torch.Tensor:
    """Plain version of the containment mapping on any device: q (Lq, Q)
    uint8 position-major and lq (Q,) int32 (``upload_block``), w (Lw, n)
    uint8 the windows, table (3, P) int32 (query column, window column,
    window length: ``upload_windows``). For each pair the infix distance at
    E = 2 tol of the query and of its reverse complement within the window
    (``banded_edit_batch_plain``). Returns (Q,) uint8, 1 where one of them
    is <= tol for some pair of the query. ``rows_out``, when given a list,
    receives the rows the kernel's scan runs for the 2P (pair,
    orientation) runs, summed."""
    _check_contained(q, lq, w, table)
    out = torch.zeros(q.shape[1], dtype=torch.uint8, device=q.device)
    P = table.shape[1]
    if P == 0:
        if rows_out is not None:
            rows_out.append(0)
        return out
    cols, wcols = table[0].long(), table[1].long()
    a = torch.cat([q[:, cols], _reverse_complements(q, lq, cols)], 1)
    rows = None if rows_out is None else torch.zeros(
        2 * P, dtype=I32, device=q.device)
    d = banded_edit_batch_plain(a, lq[cols].repeat(2), w[:, wcols].repeat(
        1, 2), table[2].repeat(2), 2 * int(tol), True, rows_out=rows)
    if rows_out is not None:
        rows_out.append(int(rows.long().sum()))
    out[cols[(d <= tol).view(2, P).any(0)]] = 1
    return out


def contained_stage_bytes(Lq: int, Lw: int) -> int:
    """Shared bytes of a block of the "staged" body: CONTAINED_STAGE_PAIRS
    rows of each operand, a row's pitch Lq (Lw) rounded up to an odd
    number of 4-byte words (``stage_pitch`` of ``csrc/banded_edit.cu``)."""
    def pitch(L):
        return 4 * ((-(-L // 4)) | 1)
    return CONTAINED_STAGE_PAIRS * (pitch(Lq) + pitch(Lw))


def contained_mapping(P: int, tol: int, Lq: int, Lw: int,
                      mapping: Optional[str] = None) -> str:
    """The containment kernel's mapping for P pairs at tol, queries of Lq
    and windows of Lw positions: ``mapping`` where given and it applies
    (a ValueError otherwise), else "split" below CONTAINED_SPLIT_BELOW
    pairs where 4 tol + 1 <= CONTAINED_SPLIT_MAX_CELLS, else "staged" to
    THREAD_MAX_CELLS band cells where ``contained_stage_bytes(Lq, Lw)`` <=
    CONTAINED_STAGE_MAX, "ring" to THREAD_MAX_CELLS, "warp" past them.
    "inplace" applies everywhere and is never picked."""
    cells = 4 * int(tol) + 1
    applies = {"split": cells <= CONTAINED_SPLIT_MAX_CELLS,
               "staged": cells <= THREAD_MAX_CELLS and contained_stage_bytes(
                   Lq, Lw) <= CONTAINED_STAGE_MAX,
               "ring": cells <= THREAD_MAX_CELLS,
               "warp": cells > THREAD_MAX_CELLS,
               "inplace": True}
    if mapping is None:
        if applies["split"] and P < CONTAINED_SPLIT_BELOW:
            return "split"
        return next(m for m in ("staged", "ring", "warp") if applies[m])
    if not applies.get(mapping, False):
        raise ValueError(f"containment mapping {mapping!r} does not apply "
                         f"at tol={tol}, Lq={Lq}, Lw={Lw}: one of "
                         f"{[m for m, ok in applies.items() if ok]}")
    return mapping


def contained_any(q: torch.Tensor, lq: torch.Tensor, w: torch.Tensor,
                  table: torch.Tensor, tol: int,
                  mapping: Optional[str] = None) -> torch.Tensor:
    """Dedupe's containment check of a block of queries in one launch (the
    layout and result of ``contained_any_plain``). CPU tensors: the plain
    version. CUDA tensors: one launch of the containment mapping of
    ``csrc/banded_edit.cu`` that ``contained_mapping`` picks (``mapping``
    forces one where it applies); queries and windows position-major
    with a pair stride of 1, lengths and table contiguous, the table's
    columns within q and w, each query's length <= q's positions. A failed
    launch raises."""
    _check_contained(q, lq, w, table)
    if q.device.type == "cpu":
        return contained_any_plain(q, lq, w, table, tol)
    _on_cuda(q)
    tol = int(tol)
    if tol < 0:
        raise ValueError(f"tol={tol} must be >= 0")
    if q.stride(1) != 1 or w.stride(1) != 1 or lq.stride(0) != 1 \
            or not table.is_contiguous():
        raise ValueError("queries and windows position-major with a pair "
                         "stride of 1, lengths and table contiguous")
    flags = torch.zeros(q.shape[1], dtype=torch.uint8, device=q.device)
    P = table.shape[1]
    mapping = contained_mapping(P, tol, q.shape[0], w.shape[0], mapping)
    if P == 0:
        return flags
    lib = _lib()
    E = 2 * tol
    ints = lib.banded_edit_scratch_ints(E)
    scratch = torch.empty(2 * P * ints if ints else 1, dtype=I32,
                          device=q.device)
    err = lib.banded_contained_launch(
        q.data_ptr(), q.stride(0), lq.data_ptr(), q.shape[0], w.data_ptr(),
        w.stride(0), w.shape[0], table.data_ptr(), P, tol,
        _CONTAINED_CODES[mapping], flags.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_contained_launch ({mapping}) failed: "
                           f"cudaError {err}")
    contained_any.launches += 1
    contained_any.launches_by[mapping] += 1
    contained_any.pairs += P
    return flags


def upload_windows(cols: List[int], windows: List[np.ndarray],
                   device) -> tuple:
    """The containment check's pairs on ``device`` in one copy (pinned and
    non-blocking on a CUDA device): pair k is query column cols[k] against
    windows[k]. Returns (the windows (Lw, P) uint8 position-major, bytes
    past a window's length meaning nothing; the table (3, P) int32: query
    column, window column, window length)."""
    P = len(windows)
    lens = np.array([len(x) for x in windows], np.int32)
    Lw = int(lens.max()) if P else 0
    at = -(-12 * P // 16) * 16             # the windows after the table
    dev = backend.resolve_device(device)
    host = torch.empty(at + Lw * P, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    h = host.numpy()
    table = h[:12 * P].view(np.int32).reshape(3, P)
    table[0], table[1], table[2] = cols, np.arange(P), lens
    h[at:].reshape(Lw, P)[:] = _pad_rows(windows, Lw).T
    buf = host.to(dev, non_blocking=True)
    return (buf[at:].view(Lw, P),
            buf[:12 * P].view(torch.int32).view(3, P))


reset_launches()


def banded_edit_batch(a: np.ndarray, la: np.ndarray, b: np.ndarray,
                      lb: np.ndarray, max_edits: int,
                      infix: bool = False, *, device) -> np.ndarray:
    """Batched banded edit distance. a (n, La) / b (n, Lb) uint8 with
    per-row lengths la/lb; returns (n,) int32 saturated at
    max_edits + 1. ``infix=True`` scores a's best match to ANY infix of
    b (free start/end in b) — Dedupe's contained-with-edits
    verification (reference: Dedupe containment via
    BandedAligner.alignForward from a candidate offset). Staged
    position-major (``_pair_minor``) and run on ``device`` (the kernel on
    cuda, the plain version on cpu)."""
    dev = backend.resolve_device(device)

    def up(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)
    d = banded_edit(_pair_minor(np.asarray(a, np.uint8), dev),
                    up(la, np.int32),
                    _pair_minor(np.asarray(b, np.uint8), dev),
                    up(lb, np.int32), max_edits, infix)
    return d.cpu().numpy()


def _pad_rows(seqs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(seqs), width), np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def _pair_minor(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """rows (n, L) uint8 on ``dev`` position-major: an (L, n) view whose
    row pitch is n rounded up to 4, so that the kernel reads four pairs'
    bytes at a position as one aligned word (``words_fit``)."""
    n, L = rows.shape
    host = np.zeros((L, -(-n // 4) * 4), np.uint8)
    host[:, :n] = rows.T
    return torch.from_numpy(host).to(dev)[:, :n]


def _vs_query(query: np.ndarray, seqs: List[np.ndarray], E: int,
              infix: bool, dev: torch.device,
              site: str = "other") -> np.ndarray:
    """One query against every sequence of ``seqs``: the query uploaded
    once (every pair reads it), the sequences position-major at a pitch of
    a multiple of 4 (``_pair_minor``)."""
    q = torch.from_numpy(np.array(query, np.uint8)).to(dev)
    la = torch.tensor([len(query)], dtype=I32, device=dev).expand(len(seqs))
    b = _pair_minor(_pad_rows(seqs, max(len(s) for s in seqs)), dev)
    lb = torch.tensor([len(s) for s in seqs], dtype=I32, device=dev)
    return banded_edit(q, la, b, lb, E, infix, site).cpu().numpy()


def contained_distances(query: np.ndarray,
                        windows: List[np.ndarray],
                        max_edits: int, *, device,
                        site: str = "containment") -> np.ndarray:
    """Best infix edit distance of `query` within each window (free
    start/end inside the window) — Dedupe's contained-with-edits
    verification. Band width 2*max_edits covers the offset slack of a
    ±max_edits window. ``site`` names the caller in
    ``banded_edit.launches_by_site``."""
    n = len(windows)
    if n == 0:
        return np.zeros(0, np.int32)
    dev = backend.resolve_device(device)
    d = _vs_query(query, windows, 2 * max_edits, True, dev, site)
    return np.minimum(d, max_edits + 1)


def edit_distances_vs_one(query: np.ndarray,
                          others: List[np.ndarray],
                          max_edits: int, *, device) -> np.ndarray:
    """Distances of one query against many candidates (Dedupe's
    near-duplicate check), one launch on ``device``."""
    n = len(others)
    if n == 0:
        return np.zeros(0, np.int32)
    return _vs_query(query, others, max_edits, False,
                     backend.resolve_device(device))


def length_class(L: int) -> int:
    """The first length of L's class in ``SequenceStore``: lengths below
    32 a class each, then 16 classes an octave ([2^(k-1), 2^k) cut into
    steps of 2^(k-5)), so that a class's widest length is under L + L/16."""
    shift = max(0, L.bit_length() - 5)
    return L >> shift << shift


def class_width(lo: int) -> int:
    """The widest length of the class that starts at lo."""
    return lo + (1 << max(0, lo.bit_length() - 5)) - 1


def upload_block(seqs: List[np.ndarray], device) -> tuple:
    """A block of sequences on ``device`` in the layout of the block
    kernel: (Lq, Q rounded up to ``BLOCK_TILE``) uint8 position-major, byte
    (pos, i) of sequence i (bytes past a sequence's length mean nothing),
    and the (Q,) int32 lengths; one upload each. Returns (the (Lq, Q) view,
    lengths)."""
    Q = len(seqs)
    lens = np.array([len(x) for x in seqs], np.int32)
    Lq = int(lens.max()) if Q else 0
    host = np.zeros((Lq, -(-max(Q, 1) // BLOCK_TILE) * BLOCK_TILE), np.uint8)
    for i, x in enumerate(seqs):
        host[:len(x), i] = x
    dev = backend.resolve_device(device)
    return (torch.from_numpy(host).to(dev)[:, :Q],
            torch.from_numpy(lens).to(dev))


class SequenceStore:
    """Sequences kept on a device in length classes (``length_class``): a
    class holds its sequences position-major in a (class width, capacity)
    uint8 tensor, byte (pos, k) of its sequence k, beside their lengths;
    the capacity starts at ``BLOCK_TILE`` and doubles as the class fills
    (a multiple of 128, so the block kernel stages its tiles with aligned
    16-byte copies), and the card holds under 2 x 17/16 of the kept bytes
    past the first tile of a class. ``check`` runs a block of queries
    against every class that holds lengths within max_edits of one of
    them (Dedupe's near-duplicate check with e=, as the JAX package's
    length buckets), a launch of the block kernel a class; ``append``
    keeps some of the block's sequences, a copy a class. A kept sequence
    whose length differs from a query's by more than max_edits lies past
    max_edits of it, the kernel's first test."""

    def __init__(self, device):
        self.device = backend.resolve_device(device)
        self.n = 0
        # first length -> [(width, capacity) uint8, (capacity,) int32
        # lengths, sequences held]
        self.classes: Dict[int, list] = {}

    def __len__(self) -> int:
        return self.n

    def near(self, lengths, max_edits: int) -> List[int]:
        """The classes (their first lengths) that hold a sequence of a
        length within max_edits of one of ``lengths``, shortest first."""
        out = set()
        for L in set(int(x) for x in lengths):
            lo = length_class(max(0, L - max_edits))
            while lo <= L + max_edits:
                if lo in self.classes:
                    out.add(lo)
                lo = class_width(lo) + 1
        return sorted(out)

    def check(self, q: torch.Tensor, lq: torch.Tensor, lengths,
              max_edits: int) -> torch.Tensor:
        """Flags (Q,) uint8 on the device: 1 where a kept sequence lies
        within max_edits of query i (global banded edit distance) of the
        block q (Lq, Q), lq (Q,) (``upload_block``); ``lengths`` the
        queries' lengths on the host. A launch a near class."""
        flags = torch.zeros(q.shape[1], dtype=torch.uint8,
                            device=self.device)
        for lo in self.near(lengths, max_edits):
            seqs, lens, k = self.classes[lo]
            flags |= banded_any(q, lq, seqs[:, :k], lens[:k], max_edits)
        return flags

    def append(self, q: torch.Tensor, lq: torch.Tensor, lengths,
               keep: List[int]) -> None:
        """Keep the block's sequences ``keep`` (column indices of q (Lq,
        Q), in order; ``lengths`` on the host): one copy a class they fall
        in."""
        by_class: Dict[int, List[int]] = {}
        for i in keep:
            by_class.setdefault(length_class(int(lengths[i])), []).append(i)
        for lo, idx in by_class.items():
            cls = self.classes.get(lo)
            if cls is None:
                cls = self.classes[lo] = [
                    torch.empty((class_width(lo), BLOCK_TILE),
                                dtype=torch.uint8, device=self.device),
                    torch.empty(BLOCK_TILE, dtype=I32, device=self.device),
                    0]
            seqs, lens, k = cls
            cap = seqs.shape[1]
            while cap < k + len(idx):
                cap *= 2
            if cap > seqs.shape[1]:
                grown = torch.empty((seqs.shape[0], cap), dtype=torch.uint8,
                                    device=self.device)
                grown[:, :k] = seqs[:, :k]
                grown_lens = torch.empty(cap, dtype=I32, device=self.device)
                grown_lens[:k] = lens[:k]
                cls[0], cls[1] = seqs, lens = grown, grown_lens
            cols = torch.tensor(idx, dtype=torch.long, device=self.device)
            m = min(q.shape[0], seqs.shape[0])
            seqs[:m, k:k + len(idx)] = q[:m].index_select(1, cols)
            lens[k:k + len(idx)] = lq.index_select(0, cols)
            cls[2] = k + len(idx)
            self.n += len(idx)
