"""``python -m bbmap_tpu_torch bbmap`` (device=cpu) and
``python -m bbmap_tpu bbmap`` (BBMAP_FORCE_CPU=1) write byte-equal SAM
on a small synthetic reference and reads, paired and single-end."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bbmap_tpu.core.bases import COMP_ASCII

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(1)
    B = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(B, 30000).astype(np.uint8)
    with open(d / "ref.fa", "w") as f:
        f.write(">chr1\n" + bytes(g[:20000]).decode() + "\n>chr2\n"
                + bytes(g[20000:]).decode() + "\n")
    L, n = 100, 48
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(n):
            s = int(rng.integers(0, 19000 - 300))
            r1 = g[s:s + L].copy()
            r2 = COMP_ASCII[g[s + 200:s + 200 + L]][::-1].copy()
            if i % 3 == 0:
                r1[rng.integers(0, L)] = ord("A")
            if i % 5 == 0:
                r2 = np.concatenate([r2[:40], r2[43:], B[:3]])
            if i % 7 == 0:
                r1 = np.concatenate([r1[:60], B[:2], r1[60:L - 2]])
            q = "".join(chr(33 + int(x)) for x in rng.integers(12, 40, L))
            f1.write(f"@p{i}/1\n{bytes(r1).decode()}\n+\n{q}\n")
            f2.write(f"@p{i}/2\n{bytes(r2).decode()}\n+\n{q}\n")
    return d


def _bbmap(pkg, args, extra_env):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2", **extra_env)
    p = subprocess.run([sys.executable, "-m", pkg, "bbmap", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]


@pytest.mark.parametrize("paired", [True, False])
def test_cli_sam_byte_equal(inputs, paired):
    d = inputs
    common = [f"ref={d / 'ref.fa'}", f"in={d / 'r1.fq'}", "nodisk"]
    if paired:
        common.append(f"in2={d / 'r2.fq'}")
    tag = "pe" if paired else "se"
    _bbmap("bbmap_tpu_torch",
           common + [f"out={d / f'torch_{tag}.sam'}", "device=cpu"], {})
    _bbmap("bbmap_tpu", common + [f"out={d / f'jax_{tag}.sam'}"],
           {"BBMAP_FORCE_CPU": "1"})
    got = (d / f"torch_{tag}.sam").read_bytes()
    want = (d / f"jax_{tag}.sam").read_bytes()
    assert got == want
    body = [ln for ln in got.decode().splitlines() if not ln.startswith("@")]
    assert len(body) == (96 if paired else 48)
