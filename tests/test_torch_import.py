"""The port imports no jax, its kernel wrappers count nothing on CPU
tensors, and asking for a device that is not there raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bbmap_tpu.core.constants import SHORT_PROFILE
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
import bbmap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bbmap_tpu_torch.__path__,
                                               "bbmap_tpu_torch.")]
for n in names:
    if n != "bbmap_tpu_torch.__main__":
        importlib.import_module(n)
sys.argv = ["bbmap_tpu_torch"]
try:
    runpy.run_module("bbmap_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("imported", len(names))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    p = _run(_IMPORT_ALL)
    assert p.returncode == 0, p.stderr
    assert "usage: python -m bbmap_tpu_torch" in p.stdout
    n = int(p.stdout.strip().splitlines()[-1].split()[-1])
    assert n >= 14


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
    out2, prevs = msa_kernels.msa_fill(reads, refs, rows, SHORT_PROFILE)
    assert torch.equal(out, out2) and prevs.shape == (6, 52, 21)
    s, c, st = msa_kernels.score_batch(reads, refs, rows, BB=4)
    assert torch.equal(torch.stack([s, c, st]), out)
    for k in msa_kernels.KERNELS:
        assert k.launches == 0 and k.long_launches == 0, k.__name__


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
    g, index = tiny
    with pytest.raises(TypeError):
        BBMapAligner(g, index)                       # no device given
    with pytest.raises(NotImplementedError):
        BBMapAligner(g, index, "cpu", mesh=object())
    with pytest.raises(ValueError):
        DeviceIndex(index, None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: 'cuda' is valid here")
    with pytest.raises(RuntimeError):
        DeviceIndex(index, "cuda")
    with pytest.raises(RuntimeError):
        BBMapAligner(g, index, "cuda")
