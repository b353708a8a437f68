"""The port and ``chip_smoke`` import neither jax nor any module of the
JAX package ``bbmap_tpu``, the kernel wrappers count nothing on CPU
tensors, and asking for a device that is not there raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.core.constants import SHORT_PROFILE
from bbmap_tpu_torch.core.genome import Genome, Scaffold
from bbmap_tpu_torch.index.build import analyze_index, build_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
import bbmap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bbmap_tpu_torch.__path__,
                                               "bbmap_tpu_torch.")]
assert {"bbmap_tpu_torch.parallel.multihost",
        "bbmap_tpu_torch.parallel.sharded",
        "bbmap_tpu_torch.index.build_device",
        "bbmap_tpu_torch.ops.msa_selftest",
        "bbmap_tpu_torch.align.search_oracle"} <= set(names), names
for n in names:
    if n != "bbmap_tpu_torch.__main__":
        importlib.import_module(n)
sys.argv = ["bbmap_tpu_torch"]
try:
    runpy.run_module("bbmap_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
foreign = sorted(m for m in sys.modules
                 if m == "bbmap_tpu" or m.startswith("bbmap_tpu."))
assert not foreign, foreign
print("imported", len(names))
"""

_IMPORT_SMOKE = """
import sys
import chip_smoke
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "bbmap_tpu"))
assert not foreign, foreign
print("imported chip_smoke")
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    """Every module of the port imported and ``python -m bbmap_tpu_torch``
    run: neither jax nor ``bbmap_tpu`` (or a module of it) is loaded."""
    p = _run(_IMPORT_ALL)
    assert p.returncode == 0, p.stderr
    assert "usage: python -m bbmap_tpu_torch" in p.stdout
    n = int(p.stdout.strip().splitlines()[-1].split()[-1])
    assert n >= 30


def test_chip_smoke_import_is_clean():
    """``import chip_smoke`` (import only, no run) loads neither jax nor
    the JAX package."""
    p = _run(_IMPORT_SMOKE)
    assert p.returncode == 0, p.stderr
    assert "imported chip_smoke" in p.stdout


def test_port_sources_name_no_reference_import():
    """No import statement in the port or in chip_smoke.py names
    ``bbmap_tpu``: it appears only in comments and in strings that cite
    the reference by file and line."""
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top, _dirs, names in os.walk(os.path.join(ROOT, "bbmap_tpu_torch")):
        files += [os.path.join(top, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("bbmap_tpu", "jax"), \
                    (path, node.lineno, m)


def test_cli_without_tool_prints_usage():
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-m", "bbmap_tpu_torch"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "bbmap" in p.stdout


def test_cpu_wrappers_do_not_count_launches():
    from bbmap_tpu_torch.ops import msa_kernels
    msa_kernels.reset_launches()
    rng = np.random.default_rng(0)
    A = np.frombuffer(b"ACGT", np.uint8)
    reads = torch.from_numpy(A[rng.integers(0, 4, (6, 20))])
    refs = torch.from_numpy(A[rng.integers(0, 4, (6, 32))])
    rows = torch.full((6,), 20, dtype=torch.int32)
    out = msa_kernels.msa_score(reads, refs, rows, SHORT_PROFILE)
    out2, prevs, _lay = msa_kernels.msa_fill(reads, refs, rows, SHORT_PROFILE)
    assert torch.equal(out, out2) and prevs.shape == (6, 52, 21)
    s, c, st = msa_kernels.score_batch(reads, refs, rows, BB=4)
    assert torch.equal(torch.stack([s, c, st]), out)
    sym, ln, _gaps, row_end = msa_kernels.msa_walk(prevs, reads, refs,
                                                   out[1], out[2], 20, 32)
    assert sym.shape == (6, 52) and int(row_end.max()) == 0
    assert int(ln.min()) >= 20
    for k in msa_kernels.KERNELS:
        assert k.launches == 0, k.__name__
    for k in msa_kernels.DP_KERNELS:
        assert not any(k.launches_by.values()), k.__name__


def test_cpu_rescue_and_quality_wrappers_do_not_count(tiny):
    """rescue_scan and quality_offsets_kernel run their plain versions on
    CPU tensors and count nothing."""
    from bbmap_tpu_torch.align import quickmap_device as qd
    from bbmap_tpu_torch.align import seed
    from bbmap_tpu_torch.ops import rescue_device
    g, index = tiny
    dix = qd.DeviceIndex(index, "cpu")
    rescue_device.reset_launches()
    qd.reset_launches()
    rng = np.random.default_rng(2)
    R, Lm, N_OFF = 5, 40, 64
    reads = index.genome_codes[100:100 + Lm][None, :].repeat(R, 0)
    up = rescue_device.upload_jobs(
        reads, np.full(R, 90, np.int32), np.full(R, 30, np.int32),
        np.full(R, 10, np.int32), rng.random(R) < 0.5,
        np.full(R, 4, np.int32), "cpu")
    best_k, min_mm = rescue_device.rescue_scan(dix, *up, Lm, N_OFF)
    assert (min_mm == 0).all() and (best_k >= 0).all()
    cfg = qd.make_config(dix, 60)
    q = torch.from_numpy(rng.integers(2, 41, (4, 60)).astype(np.int32))
    pc = torch.from_numpy(seed.PROB_CORRECT[q.numpy()])
    offs, wts, rej = qd.quality_offsets_kernel(cfg, q, pc, 1.5, 2.5)
    assert offs.shape == wts.shape == (4, len(cfg.offsets_list))
    assert rescue_device.rescue_scan.launches == 0
    assert qd.quality_offsets_kernel.launches == 0


def test_cpu_retention_and_gapless_wrappers_do_not_count(tiny, monkeypatch):
    """A quickmap batch with quality on CPU tensors goes through
    ref_retention_kernel and gapless_scores_kernel, which run their plain
    versions and count nothing; both CUDA sources are in the build."""
    from bbmap_tpu_torch.align import quickmap_device as qd
    from bbmap_tpu_torch.ops import _build
    assert {"ref_retention", "gapless_score"} <= set(_build.SOURCES)
    g, index = tiny
    dix = qd.DeviceIndex(index, "cpu")
    run = qd.build_quickmap(dix, 60)
    assert run.cfg.ref_admit
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 4900, 6)
    bases = np.stack([g.chroms[0][s:s + 60] for s in starts])
    q = rng.integers(10, 41, (6, 60)).astype(np.int8)
    calls = {"ref_retention_kernel": 0, "gapless_scores_kernel": 0}
    qd.reset_launches()
    for name in calls:
        def counted(*a, _orig=getattr(qd, name), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(qd, name, counted)
    d = run(bases, q).host()
    assert calls == {"ref_retention_kernel": 1, "gapless_scores_kernel": 1}
    assert (d["best_start"] == starts).mean() > 0.5
    monkeypatch.undo()
    assert qd.ref_retention_kernel.launches == 0
    assert qd.gapless_scores_kernel.launches == 0


_IMPORT_CANDIDATE_WRAPPERS = """
import sys
from bbmap_tpu_torch.align.quickmap_device import (
    _chain_candidates_plain, _chain_lib, _slot_pack_lib, _slot_pack_plain,
    chain_candidates_kernel, slot_pack_kernel)
from bbmap_tpu_torch.ops import _build
assert {"slot_pack", "chain_candidates"} <= set(_build.SOURCES)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "bbmap_tpu"))
assert not foreign, foreign
print("imported the candidate stage's wrappers")
"""


def test_candidate_kernel_wrappers_import_clean():
    """Importing the slot pack's and the chain step's wrappers, plain
    versions and library loaders loads neither jax nor the JAX package
    (and builds nothing); both CUDA sources are in the build."""
    p = _run(_IMPORT_CANDIDATE_WRAPPERS)
    assert p.returncode == 0, p.stderr
    assert "imported the candidate stage's wrappers" in p.stdout


def test_cpu_slot_pack_and_chain_wrappers_do_not_count(tiny, monkeypatch):
    """A quickmap batch on CPU tensors goes through slot_pack_kernel and
    chain_candidates_kernel once each; they run their plain versions and
    count nothing."""
    from bbmap_tpu_torch.align import quickmap_device as qd
    g, index = tiny
    dix = qd.DeviceIndex(index, "cpu")
    run = qd.build_quickmap(dix, 60)
    rng = np.random.default_rng(4)
    starts = rng.integers(0, 4900, 6)
    bases = np.stack([g.chroms[0][s:s + 60] for s in starts])
    calls = {"slot_pack_kernel": 0, "chain_candidates_kernel": 0}
    qd.reset_launches()
    for name in calls:
        def counted(*a, _orig=getattr(qd, name), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(qd, name, counted)
    d = run(bases).host()
    assert calls == {"slot_pack_kernel": 1, "chain_candidates_kernel": 1}
    assert (d["best_start"] == starts).mean() > 0.5
    monkeypatch.undo()
    assert qd.slot_pack_kernel.launches == 0
    assert qd.chain_candidates_kernel.launches == 0


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(1)
    g0 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000).astype(np.uint8)
    g = Genome(chroms=[g0], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g0),
                 name="c")]).finalize()
    index = build_index(g, 11)
    analyze_index(index, 0.01)
    return g, index


def test_device_must_exist_and_be_explicit(tiny):
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
    from bbmap_tpu_torch.parallel.sharded import make_mesh
    g, index = tiny
    with pytest.raises(TypeError):
        BBMapAligner(g, index)                       # no device given
    with pytest.raises(TypeError):
        BBMapAligner(g, index, "cpu", mesh=object())   # not a Mesh
    with pytest.raises(ValueError):                    # not the mesh's
        BBMapAligner(g, index, "cpu", mesh=make_mesh(1, 2, "cpu"),
                     n_index_shards=3)
    with pytest.raises(ValueError):
        DeviceIndex(index, None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: 'cuda' is valid here")
    with pytest.raises(RuntimeError):
        DeviceIndex(index, "cuda")
    with pytest.raises(RuntimeError):
        BBMapAligner(g, index, "cuda")


def test_mesh_is_taken_and_maps(tiny):
    """A parallel.sharded.Mesh of CPU entries is taken: the aligner
    shards the index over its "index" axis, leaves the fused program, and
    maps a batch as the unsharded aligner does."""
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.core.batch import ReadBatch
    from bbmap_tpu_torch.parallel.sharded import make_mesh
    g, index = tiny
    rng = np.random.default_rng(3)
    L, B = 60, 16
    starts = rng.integers(0, 5000 - L, B)
    reads = np.stack([index.genome_codes[s:s + L] for s in starts])
    reads = np.frombuffer(b"ACGTN", np.uint8)[reads]
    batch = ReadBatch(bases=reads, quality=None,
                      lengths=np.full(B, L, np.int32),
                      ids=[str(i) for i in range(B)],
                      numeric_ids=np.arange(B, dtype=np.int64))
    mesh = make_mesh(2, 1, "cpu")
    multi = BBMapAligner(g, index, "cpu", mesh=mesh)
    assert multi.mesh is mesh and not multi._use_fused(L)
    got = multi.map_batch_columnar(batch)
    want = BBMapAligner(g, index, "cpu").map_batch_columnar(batch)
    for f in ("mapped", "strand", "chrom", "start", "stop", "score"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert int(got.mapped.sum()) == B
