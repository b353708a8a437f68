"""``python -m bbmap_tpu_torch bbmap ... hosts=2`` on the CPU: two
processes (``device=cpu``) joined in a gloo group map their stripes of
batches (``batch_id % 2 == hostid``) and host 0 merges the SAM shards.
The merged SAM is byte-equal to the port's one-process run and to
``python -m bbmap_tpu bbmap`` in one process; the histogram and
scafstats side files, reduced on host 0, equal the one-process files;
no shard, sidecar or barrier marker is left. A run of the first 40 reads
with ``profiledir=`` writes a torch.profiler trace and the same SAM
records. Inputs of tests/test_multiprocess.py's size: 600 reads of 120 bp
on 60 kbp, in batches of 200 (three batches: host 0 maps two, host 1
one). Tolerance: exact."""

import os

import numpy as np
import pytest

from tests.test_torch_multihost import free_port, run_ranks

HISTS = ("qhist", "lhist", "mhist", "scafstats")


def write_reads(path, rng, srcs, n: int, L: int) -> None:
    """n reads of L bp from the sequences ``srcs`` in turn, 1 % of their
    bases substituted."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for i in range(n):
            src = srcs[i % len(srcs)]
            at = int(rng.integers(0, len(src) - L))
            row = src[at:at + L].copy()
            errs = rng.random(L) < 0.01
            row[errs] = bases[rng.integers(0, 4, size=int(errs.sum()))]
            f.write(f"@r{i}\n{bytes(row).decode()}\n+\n{'I' * L}\n")


@pytest.fixture(scope="module")
def striped(tmp_path_factory):
    """The five runs at once: the port in one process (histograms,
    scafstats), the JAX package in one process, the port's two hosts
    (histograms, scafstats), and the port on the first 40 reads with
    profiledir=."""
    d = tmp_path_factory.mktemp("striped")
    rng = np.random.default_rng(77)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=60_000)
    (d / "ref.fa").write_text(">chr1\n" + bytes(g).decode() + "\n")
    write_reads(d / "reads.fq", rng, [g], 600, 120)
    (d / "first.fq").write_bytes(b"".join(
        (d / "reads.fq").read_bytes().splitlines(keepends=True)[:160]))
    common = [f"ref={d}/ref.fa", f"in={d}/reads.fq", "nodisk",
              "batchsize=200"]
    for tag in ("single", "multi"):
        (d / tag).mkdir()

    def hists(tag):
        return [f"{h}={d}/{tag}/{h}.txt" for h in HISTS]

    coord = f"coordinator=localhost:{free_port()}"
    res = run_ranks([
        ["-m", "bbmap_tpu_torch", "bbmap", *common, f"out={d}/single.sam",
         "device=cpu", *hists("single")],
        ["-m", "bbmap_tpu", "bbmap", *common, f"out={d}/jax.sam"],
        *[["-m", "bbmap_tpu_torch", "bbmap", *common, f"out={d}/multi.sam",
           "device=cpu", "hosts=2", f"hostid={h}", coord, *hists("multi")]
          for h in range(2)],
        ["-m", "bbmap_tpu_torch", "bbmap", f"ref={d}/ref.fa",
         f"in={d}/first.fq", "nodisk", f"out={d}/prof.sam", "device=cpu",
         f"profiledir={d}/prof"]], timeout=400,
        env_extra={"BBMAP_FORCE_CPU": "1"})
    assert len(res) == 5 and all(r[0] == 0 for r in res), \
        [r[2][-2000:] for r in res]
    return d, [r[2] for r in res]


def test_striped_sam_byte_equal(striped):
    d, errs = striped
    multi = (d / "multi.sam").read_bytes()
    assert multi == (d / "single.sam").read_bytes()
    assert multi == (d / "jax.sam").read_bytes()
    body = [ln for ln in multi.split(b"\n") if ln and not ln.startswith(b"@")]
    assert len(body) == 600
    # host 0 reports the merged counts; every process joined the group
    assert "Mapped:\t600 reads" in errs[2]
    assert "Mapped:\t200 reads" in errs[3]


def test_striped_side_files_reduced_on_host_0(striped):
    d, _ = striped
    for h in HISTS:
        got = (d / "multi" / f"{h}.txt").read_bytes()
        assert got == (d / "single" / f"{h}.txt").read_bytes(), h
        assert got
    assert sorted(p.name for p in d.iterdir() if "multi" in p.name) == \
        ["multi", "multi.sam"]


def test_profiledir_writes_a_trace(striped):
    """profiledir=: a chrome trace of the mapping loop in the directory,
    and the SAM records of an unprofiled run."""
    d, errs = striped
    assert f"Profiler trace -> {d}/prof" in errs[4]
    assert os.listdir(d / "prof") == ["bbmap_host0.trace.json"]
    with open(d / "prof" / "bbmap_host0.trace.json") as fh:
        head = fh.read(4096)
    assert head.lstrip().startswith("{") and "traceEvents" in head

    def body(name):
        return [ln for ln in (d / name).read_bytes().split(b"\n")
                if ln and not ln.startswith(b"@")]
    assert body("prof.sam") == body("single.sam")[:40]
