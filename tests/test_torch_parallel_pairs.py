"""``python -m bbmap_tpu_torch bbmap in= in2= ... hosts=2`` on the CPU:
paired striping. Each host keeps its own running average pair distance
(AVERAGE_PAIR_DIST, updated once more than 2,000 reads are mated), so a
batch that a host maps after the average would have moved in one process
is scored against the initial distance: the merged SAM is not the
one-process SAM. It is byte-equal to

- the JAX package's ``hosts=2`` run on the same input, and
- the port in one process over each host's stripe of batches (batch b to
  host b % 2), the two SAMs interleaved by batch id: runs that restart
  the average the same way (the oracle ``chip_smoke.py`` holds the card's
  paired merge to).

Input: 1,800 pairs of 2 x 100 bp at inserts of 500-700 bp (inner
distances far from the initial 100) on 60 kbp, in batches of 600 pairs:
host 0 maps batches 0 and 2, host 1 batch 1, and in one process batch 2
is the first past the update. The JAX package's host 1 can wait out its
file barrier after host 0 has merged and removed the markers (the
cleanup race ROADMAP.md records), so its two processes are stopped once
host 0 has reported. Tolerance: exact."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.test_torch_multihost import ROOT, free_port

N_PAIRS, L, BATCH = 1_800, 100, 600


def write_pairs(d, rng) -> None:
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(bases, size=60_000)
    (d / "ref.fa").write_text(">chr1\n" + bytes(g).decode() + "\n")
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(N_PAIRS):
            ins = int(rng.integers(500, 700))
            at = int(rng.integers(0, len(g) - ins))
            frag = g[at:at + ins].copy()
            errs = rng.random(ins) < 0.01
            frag[errs] = bases[rng.integers(0, 4, size=int(errs.sum()))]
            a = bytes(frag[:L]).decode()
            b = bytes(frag[-L:]).translate(comp)[::-1].decode()
            f1.write(f"@p{i}/1\n{a}\n+\n{'I' * L}\n")
            f2.write(f"@p{i}/2\n{b}\n+\n{'I' * L}\n")


def write_stripes(d) -> None:
    """stripe{h}_{1,2}.fq: the batches b with b % 2 == h."""
    per = 4 * BATCH
    for m in (1, 2):
        lines = (d / f"r{m}.fq").read_bytes().splitlines(keepends=True)
        for h in range(2):
            with open(d / f"stripe{h}_{m}.fq", "wb") as fh:
                for b in range(h, -(-N_PAIRS // BATCH), 2):
                    fh.writelines(lines[b * per:(b + 1) * per])


def sam_split(path):
    lines = path.read_bytes().split(b"\n")[:-1]
    head = [ln for ln in lines if ln.startswith(b"@")]
    return head, lines[len(head):]


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """Seven processes at once, one CPU thread each: the port's two hosts,
    the JAX package's two hosts, the port in one process over each stripe
    and over the whole input."""
    d = tmp_path_factory.mktemp("striped_pairs")
    write_pairs(d, np.random.default_rng(78))
    write_stripes(d)
    common = [f"ref={d}/ref.fa", "nodisk", f"batchsize={BATCH}"]
    both = [f"in={d}/r1.fq", f"in2={d}/r2.fq"]
    port, jport = free_port(), free_port()
    runs = {
        **{f"two{h}": ["-m", "bbmap_tpu_torch", "bbmap", *common, *both,
                       f"out={d}/two.sam", "device=cpu", "hosts=2",
                       f"hostid={h}", f"coordinator=localhost:{port}"]
           for h in range(2)},
        **{f"stripe{h}": ["-m", "bbmap_tpu_torch", "bbmap", *common,
                          f"in={d}/stripe{h}_1.fq",
                          f"in2={d}/stripe{h}_2.fq",
                          f"out={d}/stripe{h}.sam", "device=cpu"]
           for h in range(2)},
        "one": ["-m", "bbmap_tpu_torch", "bbmap", *common, *both,
                f"out={d}/one.sam", "device=cpu"],
        **{f"jax{h}": ["-m", "bbmap_tpu", "bbmap", *common, *both,
                       f"out={d}/jax.sam", "hosts=2", f"hostid={h}",
                       f"coordinator=localhost:{jport}"]
           for h in range(2)}}
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="", BBMAP_FORCE_CPU="1",
               BBMAP_CPU_DEVICES="2")
    procs = {}
    for tag, argv in runs.items():
        with open(d / f"{tag}.err", "w") as fh:
            procs[tag] = subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                          env=env, stdout=subprocess.DEVNULL,
                                          stderr=fh)
    deadline = time.time() + 400
    try:
        for tag, p in procs.items():
            if tag.startswith("jax"):
                continue
            p.wait(timeout=max(1.0, deadline - time.time()))
            assert p.returncode == 0, (tag, (d / f"{tag}.err").read_text())
        # the JAX host 0 reports after its merge
        while "Time:" not in (d / "jax0.err").read_text():
            assert procs["jax0"].poll() in (None, 0), \
                (d / "jax0.err").read_text()
            assert time.time() < deadline, (d / "jax0.err").read_text()
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return d, {tag: (d / f"{tag}.err").read_text() for tag in runs}


def test_paired_merge_as_the_jax_hosts_run(paired):
    d, errs = paired
    two = (d / "two.sam").read_bytes()
    assert two == (d / "jax.sam").read_bytes()
    assert f"Mapped:\t{2 * N_PAIRS} reads" in errs["two0"]
    assert f"Mapped:\t{2 * BATCH} reads" in errs["two1"]
    assert sorted(p.name for p in d.iterdir() if p.name.startswith("two")) \
        == ["two.sam", "two0.err", "two1.err"]


def test_paired_merge_as_the_stripes_interleaved(paired):
    """The oracle: batch b's 2 x BATCH records from stripe b % 2's run;
    the one-process run differs from the merge in batch 2 alone."""
    d, _ = paired
    heads, bodies = zip(*(sam_split(d / f"stripe{h}.sam") for h in range(2)))
    per = 2 * BATCH
    want = list(heads[0])
    for b in range(-(-N_PAIRS // BATCH)):
        want += bodies[b % 2][(b // 2) * per:(b // 2 + 1) * per]
    assert b"\n".join(want) + b"\n" == (d / "two.sam").read_bytes()
    head, one = sam_split(d / "one.sam")
    got = want[len(heads[0]):]
    assert head == list(heads[0]) and len(one) == len(got) == 2 * N_PAIRS
    apart = [i // per for i, (x, y) in enumerate(zip(one, got)) if x != y]
    assert apart and set(apart) == {2}
