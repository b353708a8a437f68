"""The mapper's CLI variants in the port (device=cpu) against the JAX
package's tools on the CPU, byte for byte: ``bbmapacc`` (denser seeding
for one call), ``bbmap5``, ``bbmapskimmer`` (the unfused ``secondary=t``
path with ``ambig=all``, single-end and paired) and ``bbsplit`` (two
references merged, reads binned by ``basename=``, ``refstats=``), on a
30 kbp genome with repeat families."""

import sys

import numpy as np
import pytest

from bbmap_tpu import __main__ as jax_main
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu_torch import __main__ as port_main

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """30 kbp in two chromosomes with a 600 bp unit implanted 6 times and
    a 300 bp unit 4 times (with a few substitutions each), written whole
    and split in two references; 100 pairs of 2 x 100 bp (inserts
    250-350, 0-4 substitutions, an indel in every 7th) and their first
    mates as single-end reads."""
    d = tmp_path_factory.mktemp("mapvariants")
    rng = np.random.default_rng(41)
    g = rng.choice(BASES, 30_000).astype(np.uint8)
    for unit_len, copies in ((600, 6), (300, 4)):
        unit = rng.choice(BASES, unit_len).astype(np.uint8)
        for _ in range(copies):
            at = int(rng.integers(0, len(g) - unit_len))
            u = unit.copy()
            u[rng.integers(0, unit_len, 3)] = BASES[rng.integers(0, 4, 3)]
            g[at:at + unit_len] = u
    c1, c2 = bytes(g[:18_000]).decode(), bytes(g[18_000:]).decode()
    (d / "ref.fa").write_text(f">chr1\n{c1}\n>chr2\n{c2}\n")
    (d / "refA.fa").write_text(f">chr1\n{c1}\n")
    (d / "refB.fa").write_text(f">chr2\n{c2}\n")
    L, n = 100, 100
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(n):
            ins = int(rng.integers(250, 351))
            s = int(rng.integers(0, len(g) - ins))
            r1 = g[s:s + L].copy()
            r2 = COMP_ASCII[g[s + ins - L:s + ins]][::-1].copy()
            for r in (r1, r2):
                k = int(rng.integers(0, 5))
                r[rng.integers(0, L, k)] = BASES[rng.integers(0, 4, k)]
            if i % 7 == 0:
                r1 = np.concatenate([r1[:50], r1[52:], BASES[:2]])
            q = "".join(chr(33 + int(x)) for x in rng.integers(15, 41, L))
            f1.write(f"@p{i}/1\n{bytes(r1).decode()}\n+\n{q}\n")
            f2.write(f"@p{i}/2\n{bytes(r2).decode()}\n+\n{q}\n")
    return d


# case -> (tool, arguments); {d} the inputs, {o} the run's directory
CASES = {
    "bbmapacc": ("bbmapacc", ["ref={d}/ref.fa", "in={d}/r1.fq",
                              "out={o}/out.sam", "nodisk"]),
    "bbmap5 paired": ("bbmap5", ["ref={d}/ref.fa", "in={d}/r1.fq",
                                 "in2={d}/r2.fq", "out={o}/out.sam",
                                 "nodisk"]),
    "bbmapskimmer": ("bbmapskimmer", ["ref={d}/ref.fa", "in={d}/r1.fq",
                                      "out={o}/out.sam", "nodisk"]),
    "bbmapskimmer paired": ("bbmapskimmer", [
        "ref={d}/ref.fa", "in={d}/r1.fq", "in2={d}/r2.fq",
        "out={o}/out.sam", "nodisk"]),
    "bbsplit": ("bbsplit", ["ref={d}/refA.fa,{d}/refB.fa", "in={d}/r1.fq",
                            "basename={o}/out_%.fq",
                            "refstats={o}/refstats.txt"]),
    "bbsplit paired toss": ("bbsplit", [
        "ref={d}/refA.fa,{d}/refB.fa", "in={d}/r1.fq", "in2={d}/r2.fq",
        "basename={o}/out_%.fq", "ambig2=toss",
        "refstats={o}/refstats.txt"]),
}


def _run(monkeypatch, capsys, side, tool, args):
    if side == "port":
        monkeypatch.setattr(sys, "argv", ["bbmap_tpu_torch", tool, *args,
                                          "device=cpu"])
        main = port_main.main
    else:
        monkeypatch.setattr(sys, "argv", ["bbmap_tpu", tool, *args])
        main = jax_main.main
    capsys.readouterr()
    rc = main()
    return rc, capsys.readouterr().err


def _report(err: str, o) -> list:
    """The report without wall times, the output directory as {o}."""
    return [ln.replace(str(o), "{o}") for ln in err.splitlines()
            if "seconds" not in ln and not ln.startswith("Time:")]


@pytest.mark.parametrize("case", list(CASES))
def test_variant_byte_equal(corpus, tmp_path, monkeypatch, capsys, case):
    tool, template = CASES[case]
    runs = {}
    for side in ("port", "jax"):
        o = tmp_path / side
        o.mkdir()
        rc, err = _run(monkeypatch, capsys, side, tool,
                       [a.format(d=corpus, o=o) for a in template])
        assert rc == 0, (side, err[-2000:])
        runs[side] = (_report(err, o), {p.name: p.read_bytes()
                                        for p in sorted(o.iterdir())})
    assert runs["port"][0] == runs["jax"][0]
    files = runs["port"][1]
    assert sorted(files) == sorted(runs["jax"][1])
    for name in files:
        assert files[name] == runs["jax"][1][name], name
    if tool == "bbsplit":
        assert {"out_refA.fq", "out_refB.fq", "refstats.txt"} <= set(files)
        return
    body = [ln.split("\t") for ln in files["out.sam"].decode().splitlines()
            if not ln.startswith("@")]
    mapped = [f for f in body if not int(f[1]) & 4]
    assert len(mapped) > 0.8 * len({f[0] for f in body})
    if tool == "bbmapskimmer":
        # every site above the threshold: secondary lines are written
        assert any(int(f[1]) & 256 for f in body)


def test_acc_restores_the_seed_densities(corpus, tmp_path, monkeypatch,
                                         capsys):
    """bbmapacc sets the seed densities for its one call: a bbmap run
    after it, in the same process, writes the SAM of a bbmap run before
    it."""
    from bbmap_tpu_torch.align import seed
    before = (seed.KEY_DENSITY, seed.MAX_KEY_DENSITY, seed.MIN_KEY_DENSITY)
    sams = []
    for tool in ("bbmap", "bbmapacc", "bbmap"):
        o = tmp_path / f"{tool}_{len(sams)}"
        o.mkdir()
        rc, err = _run(monkeypatch, capsys, "port", tool, [
            f"ref={corpus}/ref.fa", f"in={corpus}/r1.fq",
            f"out={o}/out.sam", "nodisk"])
        assert rc == 0, err[-2000:]
        sams.append((o / "out.sam").read_bytes())
    assert (seed.KEY_DENSITY, seed.MAX_KEY_DENSITY,
            seed.MIN_KEY_DENSITY) == before
    assert sams[0] == sams[2]


# The reads that bbmap and bbmapacc grade apart over chip_smoke.py's
# 32,768 pairs (randomreads seed 37 on workload.make_genome(), the
# variants phase on the card): name prefix and mate -> the tool that
# places the read within 20 bp of its origin.
ACC_APART = {
    ("12831", 1): "bbmap", ("14788", 2): "bbmap", ("14788", 1): "bbmap",
    ("16257", 2): "bbmap", ("16257", 1): "bbmap", ("22024", 1): "bbmap",
    ("22024", 2): "bbmap", ("32075", 1): "bbmap", ("32075", 2): "bbmap",
    ("3772", 1): "bbmap", ("5506", 2): "bbmap", ("5506", 1): "bbmap",
    ("8214", 1): "bbmap", ("8214", 2): "bbmap", ("12800", 1): "bbmapacc",
    ("12800", 2): "bbmapacc", ("13750", 1): "bbmapacc",
    ("13750", 2): "bbmapacc", ("14016", 2): "bbmapacc",
    ("17900", 2): "bbmapacc", ("24676", 2): "bbmapacc",
    ("27629", 2): "bbmapacc", ("28041", 1): "bbmapacc",
    ("28041", 2): "bbmapacc", ("30560", 2): "bbmapacc",
    ("8990", 2): "bbmapacc",
}


@pytest.fixture(scope="module")
def workload_apart(tmp_path_factory):
    """The workload genome and the pairs of chip_smoke.py's variants
    phase that hold the reads of ACC_APART."""
    from bbmap_tpu_torch import workload
    from bbmap_tpu_torch.tools import randomreads
    d = tmp_path_factory.mktemp("acc_apart")
    g = workload.make_genome()
    (d / "genome.fa").write_text(">ecoli_like\n" + bytes(g).decode() + "\n")
    assert randomreads.main([
        f"ref={d}/genome.fa", f"out={d}/all1.fq", f"out2={d}/all2.fq",
        "reads=32768", "length=150", "paired=t", "snprate=0.3",
        "maxsnps=3", "insrate=0.05", "delrate=0.05", "seed=37"]) == 0
    ids = {pair for pair, _ in ACC_APART}
    for m in (1, 2):
        lines = (d / f"all{m}.fq").read_text().splitlines()
        keep = [ln for i in range(0, len(lines), 4)
                if lines[i][1:].split("_")[0] in ids
                for ln in lines[i:i + 4]]
        (d / f"r{m}.fq").write_text("\n".join(keep) + "\n")
    return d


@pytest.mark.parametrize("tool", ["bbmap", "bbmapacc"])
def test_acc_apart_as_the_jax_tools(workload_apart, tmp_path, monkeypatch,
                                    capsys, tool):
    """On the pairs that hold the reads bbmap and bbmapacc grade apart on
    the card, the port writes the JAX tool's SAM byte for byte, and the
    JAX tool places those reads as the card's run did, right in one tool
    and wrong in the other, but pair 28041: bbmapacc places it right
    within its batch of 4,096 pairs on the card, and on the other copy of
    its repeat, as bbmap does, when it is mapped with these pairs alone
    (the pairing depends on the batch)."""
    import chip_smoke
    d = workload_apart
    sams = {}
    for side in ("port", "jax"):
        o = tmp_path / side
        o.mkdir()
        rc, err = _run(monkeypatch, capsys, side, tool, [
            f"ref={d}/genome.fa", f"in={d}/r1.fq", f"in2={d}/r2.fq",
            f"out={o}/out.sam", "nodisk"])
        assert rc == 0, (side, err[-2000:])
        sams[side] = o / "out.sam"
    assert sams["port"].read_bytes() == sams["jax"].read_bytes()
    lines = chip_smoke.grade_paired(sams["jax"], keep=True)["lines"]
    graded = {(name.split("_")[0], flag >> 6): ok
              for (name, flag), (ok, *_) in lines.items()}
    assert {k: graded[k] for k in ACC_APART} == {
        k: right == tool and k[0] != "28041"
        for k, right in ACC_APART.items()}
