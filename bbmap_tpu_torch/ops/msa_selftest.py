"""Kernel parity self-test on the device (port of
``bbmap_tpu/ops/msa_selftest.py``).

The CPU tests run the plain versions of the DP kernels only; a fault of
the compiled kernels would otherwise surface as silent mis-mapping. This
check runs the kernels that a device path launches — K2 score
(``msa_kernels.msa_score``), K3 fill (``msa_kernels.msa_fill``) and the
fused fill + walk (``msa_kernels.msa_fill_walk``) — on short-read-shaped
cases with substitutions and indels, and holds each case's score and
column against the numpy oracle (``ops/msa_ref.fill_unlimited``, itself
pinned to the committed golden transcription vectors). There is no
fallback: a caller that gets False fails. On CPU tensors the wrappers
take their plain versions, as everywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import DeviceLike, resolve_device


def _cases(rng, n, R: int, C: int):
    """n (read, ref_window) pairs with subs and small indels."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = np.zeros((n, R), np.uint8)
    refs = np.zeros((n, C), np.uint8)
    for i in range(n):
        ref = rng.choice(bases, size=C).astype(np.uint8)
        at = int(rng.integers(4, C - R - 12))
        read = ref[at:at + R].copy()
        kind = i % 4
        if kind == 1:
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(0, R))
                read[p] = bases[int(rng.integers(0, 4))]
        elif kind == 2:        # deletion in read (ref has extra bases)
            d = int(rng.integers(1, 6))
            p = int(rng.integers(5, R - 5))
            w = ref[at:at + R + d]
            read = np.concatenate([w[:p], w[p + d:p + d + (R - p)]])
        elif kind == 3:        # insertion in read
            d = int(rng.integers(1, 6))
            p = int(rng.integers(5, R - 5))
            ins = bases[rng.integers(0, 4, size=d)]
            read = np.concatenate([read[:p], ins, read[p:R - d]])
        reads[i] = read[:R]
        refs[i] = ref
    return reads, refs


def selftest_cases(profiles=("short", "pacbio"), n: int = 128,
                   R: int = 64, C: int = 128) -> list:
    """The cases of every requested profile with the oracle's answers,
    host numpy only: [(profile name, reads (n, R) uint8, refs (n, C)
    uint8, score (n,) int64, column (n,) int64)], from the generator
    seeded with 20260820, as the JAX package draws them."""
    from ..core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from . import msa_ref

    rng = np.random.default_rng(20260820)
    cases = []
    for pname in profiles:
        P = SHORT_PROFILE if pname == "short" else PACBIO_PROFILE
        reads, refs = _cases(rng, n, R, C)
        want_score = np.zeros(n, np.int64)
        want_col = np.zeros(n, np.int64)
        for i in range(n):
            _packed, (_rows, max_col, _state, max_score) = \
                msa_ref.fill_unlimited(reads[i], refs[i], P)
            want_score[i] = max_score
            want_col[i] = max_col
        cases.append((pname, reads, refs, want_score, want_col))
    return cases


def kernel_selftest(profiles=("short", "pacbio"), n: int = 128,
                    R: int = 64, C: int = 128, device: DeviceLike = "cuda",
                    verbose=print, cases=None) -> bool:
    """True iff K2, K3 and the fused fill + walk on ``device`` reproduce
    the numpy oracle's score and column on every case, for every requested
    scoring profile; else False, with one ``KERNEL SELFTEST MISMATCH``
    line a disagreeing output through ``verbose``. ``cases``: what
    ``selftest_cases(profiles, n, R, C)`` returns, computed beforehand
    (the oracle is the slow part, and needs no device)."""
    from ..core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from . import msa_kernels

    dev = resolve_device(device)
    if cases is None:
        cases = selftest_cases(profiles, n, R, C)
    ok = True
    for pname, reads, refs, want_score, want_col in cases:
        P = SHORT_PROFILE if pname == "short" else PACBIO_PROFILE
        n, R = reads.shape
        rd = torch.from_numpy(reads).to(dev)
        rf = torch.from_numpy(refs).to(dev)
        rows = torch.full((n,), R, dtype=torch.int32, device=dev)
        got_s = msa_kernels.msa_score(rd, rf, rows, P).cpu().numpy()
        got_f = msa_kernels.msa_fill(rd, rf, rows, P)[0].cpu().numpy()
        got_w = msa_kernels.msa_fill_walk(rd, rf, rows, P)[0].cpu().numpy()
        for name, got, want in (
                (f"{pname}/score-kernel score", got_s[0], want_score),
                (f"{pname}/score-kernel col", got_s[1], want_col),
                (f"{pname}/fill-kernel score", got_f[0], want_score),
                (f"{pname}/fill-kernel col", got_f[1], want_col),
                (f"{pname}/fill-walk-kernel score", got_w[0], want_score),
                (f"{pname}/fill-walk-kernel col", got_w[1], want_col)):
            bad = np.nonzero(got.astype(np.int64) != want)[0]
            if len(bad):
                ok = False
                i = int(bad[0])
                verbose(f"KERNEL SELFTEST MISMATCH {name}: "
                        f"{len(bad)}/{n} cases differ; case {i}: "
                        f"got {got[i]} want {want[i]}")
    return ok
