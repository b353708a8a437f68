"""The port's device index build (bbmap_tpu_torch/index/build_device.py)
on the CPU against the JAX package's host build and its device build (run
on the CPU as JAX runs it): ``starts`` and ``sites`` bit-identical, with N
bases across two chroms; the low-memory modulo mode on the host; the
seeded device arrays taken by ``DeviceIndex`` and dropped by
``analyze_index``'s compaction; and the aligner on the device-built index
mapping as on the host-built one. Tolerance: exact."""

import numpy as np
import pytest
import torch

from bbmap_tpu.core.genome import Genome as JGenome
from bbmap_tpu.core.genome import Scaffold as JScaffold
from bbmap_tpu.index import build as jbuild
from bbmap_tpu.index.build_device import build_index_device as jbuild_device
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
from bbmap_tpu_torch.index.build import analyze_index, build_index
from bbmap_tpu_torch.index.build_device import build_index_device

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)


def _genome(rng, sizes, n_frac=0.001, poly_a=0):
    """A JAX-package genome of one chrom a size, ``n_frac`` of each chrom
    N, and a run of ``poly_a`` A bases in the first (a clumpy key that
    ``analyze_index`` removes)."""
    chroms = []
    for n in sizes:
        c = rng.choice(BASES, n).astype(np.uint8)
        nn = int(n * n_frac)
        if nn:
            c[rng.choice(n, nn, replace=False)] = ord("N")
        chroms.append(c)
    if poly_a:
        chroms[0][1000:1000 + poly_a] = ord("A")
    return JGenome(chroms=chroms, scaffolds=[
        JScaffold(chrom=i + 1, sid=i + 1, start=0, length=len(c),
                  name=f"s{i}") for i, c in enumerate(chroms)
    ]).finalize()


@pytest.mark.parametrize("k", [8, 11])
def test_device_build_equals_both_jax_builds(k):
    rng = np.random.default_rng(k)
    jg = _genome(rng, (30_000, 20_000))
    assert (jg.packed_codes()[0] > 3).sum() == 50
    got = build_index_device(convert.genome(jg), k, device="cpu")
    for want in (jbuild.build_index(jg, k), jbuild_device(jg, k)):
        for f in ("starts", "sites", "genome_codes", "chrom_offsets"):
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.starts[-1] == len(got.sites) > 0


def test_usemodulo_builds_on_the_host():
    rng = np.random.default_rng(5)
    jg = _genome(rng, (20_000, 10_000))
    g = convert.genome(jg)
    got = build_index_device(g, 11, usemodulo=True, device="cpu")
    want = jbuild.build_index(jg, 11, usemodulo=True)
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.sites, want.sites)
    np.testing.assert_array_equal(
        got.sites, build_index(g, 11, usemodulo=True).sites)
    assert len(got.sites) < len(build_index(g, 11).sites)
    assert not hasattr(got, "_device_arrays")


def test_seeded_arrays_taken_then_dropped_by_compaction():
    """DeviceIndex takes the build's device tensors as they are; an
    ``analyze_index`` that removes a clumpy key (a 3 kbp poly-A run)
    compacts the CSR and drops them, so the next DeviceIndex uploads the
    compacted arrays. Without a clumpy key the seeds survive analysis."""
    rng = np.random.default_rng(9)
    g = convert.genome(_genome(rng, (40_000, 10_000), poly_a=3000))
    idx = build_index_device(g, 10, device="cpu")
    seeds = idx._device_arrays
    d = DeviceIndex(idx, "cpu")
    assert d.seeded
    for name, t in zip(("starts", "sites", "gpack", "nmask"), seeds):
        assert getattr(d, name) is t, name
    n_before = len(idx.sites)
    analyze_index(idx, 0.01)
    assert len(idx.sites) < n_before - 2500       # the run's key went
    assert not hasattr(idx, "_device_arrays")
    d2 = DeviceIndex(idx, "cpu")
    assert not d2.seeded
    np.testing.assert_array_equal(d2.starts.numpy(), idx.starts)
    np.testing.assert_array_equal(d2.sites.numpy(), idx.sites)
    for name in ("gpack", "nmask"):
        assert torch.equal(getattr(d2, name), getattr(d, name)), name

    plain = build_index_device(
        convert.genome(_genome(rng, (20_000,), n_frac=0)), 10, device="cpu")
    analyze_index(plain, 0.01)
    assert hasattr(plain, "_device_arrays")
    assert DeviceIndex(plain, "cpu").seeded


def test_aligner_on_the_device_built_index():
    """After analyze_index, a BBMapAligner on the device-built index maps
    reads exactly as one on the host-built index; the first reuses the
    seeded tensors (no clumpy key here), the second uploads its own."""
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.core.batch import ReadBatch

    rng = np.random.default_rng(3)
    g = convert.genome(_genome(rng, (50_000,), n_frac=0))
    gc = g.chroms[0]
    L, B = 100, 32
    starts = rng.integers(0, len(gc) - L, B)
    reads = np.stack([gc[s:s + L] for s in starts])
    outs, seeded = [], []
    for builder in (build_index, build_index_device):
        idx = builder(g, 13) if builder is build_index \
            else builder(g, 13, device="cpu")
        analyze_index(idx, 0.01)
        al = BBMapAligner(g, idx, "cpu")
        seeded.append(al.dindex.seeded)
        batch = ReadBatch(bases=reads, quality=None,
                          lengths=np.full(B, L, np.int32),
                          ids=[str(i) for i in range(B)],
                          numeric_ids=np.arange(B, dtype=np.int64))
        mb = al.map_batch_columnar(batch)
        outs.append((mb.mapped.copy(), mb.start.copy(), mb.score.copy()))
    assert seeded == [False, True]
    for x, y in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(x, y)
    assert outs[0][0].sum() == B
