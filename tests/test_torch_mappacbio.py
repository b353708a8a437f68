"""The port's long-read mapper (bbmap_tpu_torch/tools/mappacbio.py)
against the JAX package's: the CLI's SAM bytes on PacBio-model reads
(``python -m bbmap_tpu_torch mappacbio device=cpu`` against
``BBMAP_FORCE_CPU=1 python -m bbmap_tpu mappacbio``), the read splitter
and chunk rejoiner byte for byte, and the argv each entry point forwards
to its ``bbmap`` tool. Tolerance: exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bbmap_tpu.tools import mappacbio as jax_mp
from bbmap_tpu.tools import randomreads
from bbmap_tpu_torch.tools import mappacbio as torch_mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 6


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pacbio")
    rng = np.random.default_rng(3)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60_000)
    (d / "ref.fa").write_text(">chr1\n" + bytes(g[:40_000]).decode()
                              + "\n>chr2\n" + bytes(g[40_000:]).decode()
                              + "\n")
    assert randomreads.main([
        f"ref={d / 'ref.fa'}", f"out={d / 'reads.fq'}",
        f"reads={N_READS}", "pacbio=t", "pbmin=700", "pbmax=1200",
        "pberror=0.12", "seed=19"]) == 0
    return d


def _mappacbio(pkg, args, extra_env):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2", **extra_env)
    p = subprocess.run([sys.executable, "-m", pkg, "mappacbio", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]


def test_cli_sam_byte_equal(inputs):
    d = inputs
    common = [f"ref={d / 'ref.fa'}", f"in={d / 'reads.fq'}", "nodisk"]
    _mappacbio("bbmap_tpu_torch",
               common + [f"out={d / 'torch.sam'}", "device=cpu"], {})
    _mappacbio("bbmap_tpu", common + [f"out={d / 'jax.sam'}"],
               {"BBMAP_FORCE_CPU": "1"})
    got = (d / "torch.sam").read_bytes()
    assert got == (d / "jax.sam").read_bytes()
    body = [ln.split("\t") for ln in got.decode().splitlines()
            if not ln.startswith("@")]
    assert len(body) == N_READS
    assert sum(not int(f[1]) & 4 for f in body) >= N_READS - 1


def test_split_long_reads_byte_equal(tmp_path):
    rng = np.random.default_rng(8)
    A = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "in.fq", "w") as fh:
        for i, n in enumerate((150, 6000, 6001, 13_500)):
            s = bytes(A[rng.integers(0, 4, n)]).decode()
            q = "".join(chr(33 + int(x)) for x in rng.integers(5, 40, n))
            fh.write(f"@r{i}\n{s}\n+\n{q}\n")
    jax_mp.split_long_reads(str(tmp_path / "in.fq"), str(tmp_path / "j.fq"))
    torch_mp.split_long_reads(str(tmp_path / "in.fq"),
                              str(tmp_path / "t.fq"))
    got = (tmp_path / "t.fq").read_bytes()
    assert got == (tmp_path / "j.fq").read_bytes()
    assert got.count(b"_chunk") == 2 + 3


def _rec(name, flag, rname, pos, cigar, seq):
    return [name, str(flag), rname, str(pos), "40", cigar, "*", "0", "0",
            seq, "I" * len(seq), "AM:i:1"]


S = lambda n, ch: ch * n  # noqa: E731
REJOIN_CASES = {
    # tests/test_pacbio.py: the minority chunk on the other strand
    "noncollinear_inversion": [
        _rec("r1_chunk0", 0, "chr1", 1001, "2000M", S(2000, "A")),
        _rec("r1_chunk1", 0, "chr1", 3001, "2000M", S(2000, "C")),
        _rec("r1_chunk2", 16, "chr1", 50001, "2000M", S(2000, "G"))],
    "collinear": [
        _rec("r2_chunk0", 0, "chr1", 101, "1000M", S(1000, "A")),
        _rec("r2_chunk1", 0, "chr1", 1101, "1000M", S(1000, "C"))],
    "minus_with_gap_and_unmapped": [
        _rec("r3_chunk0", 16, "chr1", 5001, "900M", S(900, "A")),
        _rec("r3_chunk1", 16, "chr1", 4001, "950M", S(950, "C")),
        _rec("r3_chunk2", 4, "*", 0, "*", S(300, "G")),
        _rec("plain", 0, "chr1", 77, "50M", S(50, "T"))],
    "too_far_apart": [
        _rec("r4_chunk1", 0, "chr1", 9001, "500M", S(500, "C")),
        _rec("r4_chunk0", 0, "chr1", 1001, "500M", S(500, "A"))],
    "single_chunk": [
        _rec("r5_chunk0", 0, "chr1", 11, "10M", S(10, "A"))],
}


@pytest.mark.parametrize("case", sorted(REJOIN_CASES))
def test_rejoin_sam_byte_equal(tmp_path, case):
    hdr = "@HD\tVN:1.4\n@SQ\tSN:chr1\tLN:100000\n"
    (tmp_path / "in.sam").write_text(
        hdr + "".join("\t".join(f) + "\n" for f in REJOIN_CASES[case]))
    jax_mp.rejoin_sam(str(tmp_path / "in.sam"), str(tmp_path / "j.sam"))
    torch_mp.rejoin_sam(str(tmp_path / "in.sam"), str(tmp_path / "t.sam"))
    assert (tmp_path / "t.sam").read_bytes() == \
        (tmp_path / "j.sam").read_bytes()


def _capture(monkeypatch, module, attr):
    calls = []

    def fake(argv):
        calls.append(list(argv))
        return 1                     # no SAM written: skip the rejoin
    monkeypatch.setattr(module, attr, fake)
    return calls


@pytest.mark.parametrize("argv", [
    [],
    ["k=13", "minid=0.8", "maxindel=100", "batchsize=64", "profile=short"],
    ["device=cpu", "rejoin=f", "ambig=random", "maxsites=3"],
])
def test_main_forwards_same_argv(tmp_path, monkeypatch, argv):
    """main() forwards the same arguments and long-read defaults to its
    bbmap tool (the temporary split-reads path aside)."""
    (tmp_path / "r.fq").write_text("@a\nACGTACGT\n+\nIIIIIIII\n")
    argv = ["ref=x.fa", f"in={tmp_path / 'r.fq'}", "out=o.sam"] + argv
    got = _capture(monkeypatch, torch_mp.bbmap_tool, "main")
    want = _capture(monkeypatch, jax_mp.bbmap_tool, "main")
    assert torch_mp.main(list(argv)) == jax_mp.main(list(argv)) == 1
    strip = [[a for a in c if not a.startswith("in=")] for c in
             (got[0], want[0])]
    assert strip[0] == strip[1]
    assert sum(a.startswith("in=") for a in got[0]) == 1


@pytest.mark.parametrize("argv", [
    ["ref=x.fa", "in=r.fq"],
    ["ref=x.fa", "in=r.fq", "ambiguous=best", "secondary=f", "sssr=2"],
])
def test_skimmer_forwards_same_argv(monkeypatch, argv):
    got = _capture(monkeypatch, torch_mp, "main")
    want = _capture(monkeypatch, jax_mp, "main")
    torch_mp.skimmer_main(list(argv))
    jax_mp.skimmer_main(list(argv))
    assert got == want
