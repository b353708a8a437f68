"""Score passes of several windows in one launch
(``ops/msa_kernels.msa_score_segments``, the segment table of
bbmap_tpu_torch/csrc/msa_dp_warp.cu) on the CPU:

- its plain route (``msa_score_plain`` a segment) against the JAX
  package's ``msa_score_pallas_t`` in interpret mode and against
  ``msa_score`` on each segment alone: SHORT and PACBIO, unequal windows,
  per-job rows below R, N bases, gap columns, an empty segment;
- the route rule (``segments_launch``) and the launcher in the source
  agreeing with it and with the C interface;
- the fused program scoring its narrow and its wide jobs in one call, its
  scores equal to the JAX kernel's on the same jobs, and nothing else
  scored apart.

Tolerance: exact (integer DP)."""

import inspect
import re

import numpy as np
import pytest
import torch

from bbmap_tpu.ops import msa_pallas
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import fused_device as tfd
from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
from bbmap_tpu_torch.ops import msa_kernels

from .test_torch_fillwalk import CSRC
from .test_torch_fused import make_pairs, setup  # noqa: F401 (fixture)
from .test_torch_msa import (JAX_PROFILES, PROFILES, batch_of, pallas_t,
                             t)

torch.set_num_threads(2)


def segments_of(seed, R, Cs, Bs):
    """One segment a (C, B): batch_of's jobs (rows below R, N bases, a gap
    column); an empty segment for B = 0."""
    segs = []
    for k, (C, B) in enumerate(zip(Cs, Bs)):
        if B == 0:
            segs.append((np.zeros((0, R), np.uint8), np.zeros((0, C), np.uint8),
                         np.zeros(0, np.int32)))
        else:
            segs.append(batch_of(seed + k, B, R, C, gap=True))
    return segs


@pytest.mark.parametrize("prof", ["short", "pacbio"])
@pytest.mark.parametrize("R, Cs, Bs", [
    (24, (40, 90, 33), (6, 3, 5)),
    (40, (64, 48), (4, 0)),
    (30, (30, 120, 56, 41), (2, 5, 0, 3)),
])
def test_segments_match_pallas_and_msa_score(prof, R, Cs, Bs):
    """Each segment's (3, B_i) out equals msa_score on that segment alone
    and the JAX package's msa_score_pallas_t (interpret mode) on it."""
    P = PROFILES[prof]
    segs = segments_of(R + sum(Cs), R, Cs, Bs)
    got = msa_kernels.msa_score_segments(
        [tuple(t(x) for x in seg) for seg in segs], P)
    assert len(got) == len(segs)
    for (reads, refs, rows), g in zip(segs, got):
        assert g.dtype == torch.int32 and tuple(g.shape) == (3, len(rows))
        alone = msa_kernels.msa_score(t(reads), t(refs), t(rows), P)
        np.testing.assert_array_equal(g.numpy(), alone.numpy())
        if len(rows):
            want = pallas_t(reads, refs, rows, R, refs.shape[1],
                            JAX_PROFILES[prof], fill=False)
            np.testing.assert_array_equal(g.numpy(), want)


def meta(B, R, C):
    """A segment of shapes only (no storage): what the route rule reads."""
    return (torch.empty((B, R), dtype=torch.uint8, device="meta"),
            torch.empty((B, C), dtype=torch.uint8, device="meta"),
            torch.empty(B, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("segs, want", [
    # the fused program's narrow and wide passes: one warp launch, J = 5
    ([(32768, 150, 174), (128, 150, 606)], (5, 128, 0, "warp")),
    ([(1023, 150, 174), (1, 150, 606)], (5, 128, 0, "warp")),
    ([(1000, 150, 174), (23, 150, 606)], None),       # under WARP_MIN_JOBS
    ([(4096, 319, 400), (64, 319, 900)], (10, 128, 0, "warp")),
    ([(4096, 320, 400), (64, 320, 900)], None),       # past WARP_MAX_ROWS
    ([(4096, 150, 174), (64, 151, 606)], None),       # R differs
    ([(1024, 150, 174 + k) for k in range(4)], (5, 128, 0, "warp")),
    ([(1024, 150, 174 + k) for k in range(5)], None),  # past MAX_SEGMENTS
])
def test_segments_route_rule(segs, want):
    got = msa_kernels.segments_launch([meta(*s) for s in segs])
    assert (tuple(got) if got is not None else None) == want
    if want is not None:
        R = segs[0][1]
        assert got == msa_kernels.launch_shape(R, 0, "warp", jobs=1)


def test_segments_cpu_route_loads_no_kernel(monkeypatch):
    """CPU tensors take the plain version: no library is loaded, nothing
    is counted, and no try/except could step down to another route; the
    segments must share one device, and each is checked as msa_score
    checks its jobs."""
    def no_kernel(name):
        raise AssertionError(f"a kernel library was loaded: {name}")
    monkeypatch.setattr(msa_kernels, "_lib", no_kernel)
    msa_kernels.reset_launches()
    segs = [tuple(t(x) for x in seg)
            for seg in segments_of(3, 20, (36, 80), (4, 3))]
    got = msa_kernels.msa_score_segments(segs, PROFILES["short"])
    assert len(got) == 2 and msa_kernels.msa_score_segments.launches == 0
    assert msa_kernels.msa_score_segments([], PROFILES["short"]) == []
    assert "try:" not in inspect.getsource(msa_kernels.msa_score_segments)
    with pytest.raises(ValueError):
        msa_kernels.msa_score_segments([segs[0], meta(4, 20, 36)],
                                       PROFILES["short"])
    with pytest.raises(TypeError):
        msa_kernels.msa_score_segments(
            [(segs[0][0].int(), *segs[0][1:])], PROFILES["short"])


def test_segments_source_agrees_with_wrapper():
    """What the launcher in csrc/msa_dp_warp.cu holds to: the segment
    table's size, the rows a lane it instantiates, the warp shape check
    shared with the one-segment launcher, four jobs a block, and the C
    interface's arguments."""
    src = (CSRC / "msa_dp_warp.cu").read_text()
    assert f"constexpr int kMaxSegments = {msa_kernels.MAX_SEGMENTS};" in src
    cases = tuple(int(j) for j in re.findall(r"SEG_CASE\((\d+)\)", src))
    assert cases == tuple(range(1, msa_kernels.WARP_MAX_ROWS_PER_LANE + 1))
    assert "constexpr int kWarpsPerBlock = 4;" in src
    assert msa_kernels.WARP_THREADS == 4 * 32
    assert "rows_per_lane * 32 < R + 1 || (rows_per_lane - 1) * 32 >= R + 1" \
        in src
    assert "threads != kWarpsPerBlock * 32 || smem != 0" in src
    assert src.count("bad_shape(R, rows_per_lane, threads, smem)") == 2
    n_args = len(re.search(r"msa_score_segments_warp_launch\(([^)]*)\)",
                           src).group(1).split(","))
    assert n_args == len(msa_kernels._INTERFACE["msa_dp_warp"]
                         ["msa_score_segments_warp_launch"])
    assert set(msa_kernels._INTERFACE["msa_dp_warp"]) == set(
        re.findall(r"cudaError_t (msa_\w+_launch)\(", src))


def test_fused_program_scores_narrow_and_wide_in_one_call(
        setup, monkeypatch):  # noqa: F811
    """fused_stage scores its 2E narrow jobs at Cn and its W wide jobs at
    Cw in one msa_score_segments call and calls msa_score for nothing
    else; each segment's scores equal the JAX kernel's
    (msa_score_pallas_t, interpret mode) on the same jobs."""
    calls, direct = [], []
    segments = msa_kernels.msa_score_segments

    def spy(segs, P):
        out = segments(segs, P)
        calls.append([(tuple(x.numpy() for x in seg), o.numpy())
                      for seg, o in zip(segs, out)])
        return out
    monkeypatch.setattr(msa_kernels, "msa_score_segments", spy)
    monkeypatch.setattr(msa_kernels, "msa_score",
                        lambda *a, **k: direct.append(a))
    g, genome, index = setup
    L, Bp = 48, 32
    r1, r2 = make_pairs(g, Bp, L=L, insert=110, seed=43)
    ft = tfd.build_fused_pair(DeviceIndex(convert.index(index), "cpu"), L,
                              Bp)
    ft(r1, r2, 150).host()
    assert not direct and len(calls) == 1
    fcfg = ft.fcfg
    shapes = [(seg[0].shape, seg[1].shape[1]) for seg, _ in calls[0]]
    assert shapes == [((2 * fcfg.E, L), fcfg.Cn), ((fcfg.W, L), fcfg.Cw)]
    for (reads, refs, rows), out in calls[0]:
        want = pallas_t(reads, refs, rows, L, refs.shape[1],
                        JAX_PROFILES["short"], fill=False)
        np.testing.assert_array_equal(out, want)
