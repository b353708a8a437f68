"""The port's k-mer counting and QC CLIs against the JAX package's:
``python -m bbmap_tpu_torch <tool> ... device=cpu`` and ``python -m
bbmap_tpu <tool> ...`` (both dispatchers' ``main``, in this process)
write byte-equal output files and the same report on stderr (once lines
that carry a wall time or the output directory are set aside), for every
CLI name the port registered for this slice: kmercountexact, khist,
callpeaks, tadpole, tadpolewrapper, tadwrapper, bbnorm, ecc, pileup,
kmercoverage, filterbycoverage, decontaminate, crossblock,
crosscontaminate, postfilter, splitpairs, bbsplitpairs, repair,
filterbyname, demuxbyname, splitnexteralmp, splitnextera, rqcfilter and
bbqc. Every reference file is written here; nothing is read from outside
the test's directory.

Documented deviations (the reference faults the port does not copy):
paired rqcfilter keeps its pairs through the chain and writes a
non-empty, mate-synced ``out2`` (the JAX tool passes ``in2=`` to the first
stage only and writes an empty ``out2``), and its insert-size histogram
comes from the filtered pairs; a requested rqcfilter reference that is
absent is named on stderr.
"""

import gzip
import re
import sys

import numpy as np
import pytest

from bbmap_tpu import __main__ as jax_main
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.tools.pairtools import NEXTERA_JUNCTION
from bbmap_tpu_torch import __main__ as port_main

BASES = np.frombuffer(b"ACGT", np.uint8)
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"


def _seq(rng, n):
    return bytes(rng.choice(BASES, n))


def _rc(s: bytes) -> bytes:
    return COMP_ASCII[np.frombuffer(s, np.uint8)][::-1].tobytes()


def _mutate(rng, s: bytes, rate: float) -> bytes:
    a = np.frombuffer(s, np.uint8).copy()
    hit = rng.random(len(a)) < rate
    a[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    return a.tobytes()


def _fq(path, recs):
    with open(path, "wb") as fh:
        for name, seq in recs:
            q = bytes(33 + ((np.arange(len(seq)) * 7 + len(name)) % 30
                            + 10).astype(np.uint8))
            fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n" + q
                     + b"\n")


def _fa(path, recs):
    with open(path, "wb") as fh:
        for name, seq in recs:
            fh.write(b">" + name.encode() + b"\n" + seq + b"\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 4 kbp genome and 500 reads of 100 bp from it (a third with 1 %
    substitutions, a fifth from a 300 bp hot spot); a 2 kbp genome at
    depth ~60 for tadpole; pairs with adapter read-through, phiX-like and
    artifact reads; Nextera LMP pairs; a SAM for pileup; two libraries
    and their assemblies (contig + unsupported junk) for decontaminate."""
    d = tmp_path_factory.mktemp("kmertools")
    rng = np.random.default_rng(8)
    g = _seq(rng, 4000)
    reads = []
    for i in range(500):
        s = int(rng.integers(1000, 1200)) if i % 5 == 0 else \
            int(rng.integers(0, len(g) - 100))
        r = g[s:s + 100]
        if i % 3 == 0:
            r = _mutate(rng, r, 0.01)
        reads.append((f"r{i}", r if i % 2 else _rc(r)))
    _fq(d / "reads.fq", reads)
    _fq(d / "reads2.fq", [(n, _rc(s)) for n, s in reads])
    _fq(d / "names_a.fq", [(("a_" if i % 3 else "b_") + n, s)
                           for i, (n, s) in enumerate(reads[:90])])
    (d / "names.txt").write_text("".join(f"r{i}\n" for i in range(0, 300,
                                                                  4)))
    inter = []
    for i in range(0, 120, 2):
        inter += [(f"p{i}/1", reads[i][1]), (f"p{i}/2", reads[i + 1][1])]
    inter.insert(30, ("lone1", reads[200][1]))
    inter.append(("lone2", reads[201][1]))
    _fq(d / "inter.fq", inter)

    t = _seq(rng, 2000)
    tad = []
    for i in range(1200):
        s = int(rng.integers(0, len(t) - 100))
        r = _mutate(rng, t[s:s + 100], 0.002)
        tad.append((f"t{i}", r if i % 2 else _rc(r)))
    _fq(d / "tad.fq", tad)
    _fq(d / "tad_few.fq", tad[:40])
    (d / "hist.txt").write_text("#Depth\tCount\n" + "".join(
        f"{x}\t{int(1000 * np.exp(-x / 2) + 300 * np.exp(-(x - 25) ** 2 / 20) + 5)}\n"
        for x in range(1, 60)))

    artifact = _seq(rng, 70)
    phix = _seq(rng, 1500)
    _fa(d / "adapters.fa", [("truseq", TRUSEQ)])
    _fa(d / "artifacts.fa", [("art1", artifact)])
    _fa(d / "phix.fa", [("phix", phix)])
    se, p1, p2 = [], [], []
    for i in range(240):
        ins = int(rng.integers(60, 100)) if i % 4 == 0 else \
            int(rng.integers(130, 260))
        s = int(rng.integers(0, len(g) - ins))
        src = phix if i % 9 == 0 else g
        s = s % (len(src) - ins)
        frag = src[s:s + ins]
        if i % 11 == 0:
            frag = frag[:20] + artifact + frag[20:]
        a = (frag + TRUSEQ * 3)[:100]
        b = (_rc(frag) + _seq(rng, 100))[:100]
        p1.append((f"q{i}/1", a))
        p2.append((f"q{i}/2", _mutate(rng, b, 0.005)))
        se.append((f"s{i}", a))
    _fq(d / "pe1.fq", p1)
    _fq(d / "pe2.fq", p2)
    _fq(d / "se.fq", se)
    l1, l2 = [], []
    for i in range(60):
        a, b = _seq(rng, 60), _seq(rng, 60)
        if i % 3:
            a = a[:35] + NEXTERA_JUNCTION + a[35:60]
        l1.append((f"n{i}", a))
        l2.append((f"n{i}", b + _seq(rng, 40)))
    _fq(d / "lmp1.fq", l1)
    _fq(d / "lmp2.fq", l2)

    contigs = [("c1", g[:2500]), ("c2", g[2500:]), ("junk", _seq(rng, 900))]
    _fa(d / "contigs.fa", contigs)
    with open(d / "map.sam", "w") as fh:
        fh.write("@HD\tVN:1.4\tSO:unsorted\n")
        for name, s in contigs:
            fh.write(f"@SQ\tSN:{name}\tLN:{len(s)}\n")
        cig = ["100M", "40M3D60M", "10S90M", "50M2I48M", "100M", "95M5S"]
        for i in range(300):
            flag = 4 if i % 17 == 0 else (256 if i % 29 == 0 else
                                          (16 if i % 2 else 0))
            c = ["c1", "c2"][i % 2]
            pos = int(rng.integers(1, 1400 if c == "c2" else 2400))
            fh.write(f"m{i}\t{flag}\t{c if flag != 4 else '*'}\t{pos}\t"
                     f"30\t{cig[i % 6] if flag != 4 else '*'}\t*\t0\t0\t"
                     f"{'A' * 100}\t{'I' * 100}\n")
    for lib in ("libA", "libB"):
        a = _seq(rng, 2500)
        _fa(d / f"{lib}.fa", [(f"{lib}_main", a),
                              (f"{lib}_junk", _seq(rng, 600))])
        lib_reads = []
        for i in range(110):
            s = int(rng.integers(0, len(a) - 100))
            lib_reads.append((f"{lib}r{i}", _mutate(rng, a[s:s + 100],
                                                    0.003)))
        _fq(d / f"{lib}.fq", lib_reads)
    return d


SMALL = "cells=65536"
CASES = {
    "kmercountexact k=25 dump peaks": ("kmercountexact", [
        "in={d}/reads.fq", "k=25", "khist={o}/khist.txt",
        "peaks={o}/peaks.txt", "out={o}/dump.fa", "mincount=3"]),
    "kmercountexact k=40": ("kmercountexact", [
        "in={d}/reads.fq", "k=40", "khist={o}/khist.txt", "out={o}/dump.fa",
        "mincount=4"]),
    "khist": ("khist", ["in={d}/tad.fq", "khist={o}/khist.txt",
                        "peaks={o}/peaks.txt"]),
    "callpeaks": ("callpeaks", ["in={d}/hist.txt", "out={o}/peaks.txt",
                                "smoothradius=1", "minpeak=3"]),
    "tadpole contig": ("tadpole", ["in={d}/tad.fq", "out={o}/contigs.fa",
                                   "k=31", "shave=t", "rinse=t"]),
    "tadpole k=41": ("tadpole", ["in={d}/tad.fq", "out={o}/contigs.fa",
                                 "k=41"]),
    "tadpole correct": ("tadpole", ["in={d}/reads.fq", "out={o}/ecc.fq",
                                    "mode=correct", "k=25"]),
    "tadpole extend": ("tadpole", ["in={d}/tad_few.fq", "out={o}/ext.fq",
                                   "extra={d}/tad.fq", "mode=extend",
                                   "k=31", "el=40"]),
    "tadpolewrapper": ("tadpolewrapper", ["in={d}/tad.fq",
                                          "out={o}/best.fa", "k=21,31"]),
    "tadwrapper": ("tadwrapper", ["in={d}/tad.fq", "out={o}/best.fa",
                                  "k=25,41"]),
    "bbnorm paired khist": ("bbnorm", [
        "in={d}/reads.fq", "in2={d}/reads2.fq", "out={o}/n1.fq",
        "out2={o}/n2.fq", "outt={o}/toss.fq", "target=8", "mindepth=3",
        "k=25", "khist={o}/khist.txt", SMALL]),
    "bbnorm bits=4 hashes=1": ("bbnorm", [
        "in={d}/reads.fq", "out={o}/n.fq", "target=6", "k=31", "bits=4",
        "hashes=1", "cells=4096", "khist={o}/khist.txt", "seed=3"]),
    "bbnorm ecc": ("bbnorm", ["in={d}/reads.fq", "out={o}/n.fq",
                              "target=30", "ecc=t", "k=25", SMALL]),
    "ecc": ("ecc", ["in={d}/reads.fq", "out={o}/ecc.fq", "k=21", SMALL]),
    "pileup": ("pileup", ["in={d}/map.sam", "out={o}/covstats.txt",
                          "basecov={o}/basecov.txt",
                          "bincov={o}/bincov.txt", "binsize=200",
                          "covhist={o}/covhist.txt"]),
    "kmercoverage": ("kmercoverage", ["in={d}/reads.fq",
                                      "out={o}/cov.fq", "hist={o}/hist.txt",
                                      "k=25", SMALL]),
    "filterbycoverage": ("filterbycoverage", [
        "in={d}/contigs.fa", "cov={c}", "out={o}/clean.fa",
        "outd={o}/dirty.fa", "mincov=2", "minpercent=50"]),
    "crosscontaminate": ("crosscontaminate", [
        "in={d}/libA.fq,{d}/libB.fq", "out={o}/a.fq,{o}/b.fq", "rate=0.2",
        "seed=4"]),
    "decontaminate": ("decontaminate", [
        "reads={d}/libA.fq,{d}/libB.fq", "ref={d}/libA.fa,{d}/libB.fa",
        "outdir={o}", "tmpdir={t}", "minl=100", "target=20",
        "mindepth=1"]),
    "crossblock ecc": ("crossblock", [
        "reads={d}/libA.fq", "ref={d}/libA.fa", "outdir={o}", "tmpdir={t}",
        "minl=100", "minc=2", "ecc=t", "k=25"]),
    "postfilter": ("postfilter", [
        "in={d}/libA.fq", "ref={d}/libA.fa", "out={o}/kept.fa",
        "outd={o}/dirty.fa", "cov={o}/covstats.txt", "minl=100", "minr=2",
        "minp=50"]),
    "splitpairs": ("splitpairs", ["in={d}/inter.fq", "out={o}/pairs.fq",
                                  "outs={o}/singles.fq"]),
    "bbsplitpairs": ("bbsplitpairs", ["in={d}/inter.fq",
                                      "out={o}/pairs.fq"]),
    "repair": ("repair", ["in={d}/inter.fq", "out={o}/pairs.fq",
                          "outs={o}/singles.fq"]),
    "filterbyname": ("filterbyname", ["in={d}/reads.fq", "out={o}/f.fq",
                                      "names={d}/names.txt"]),
    "filterbyname include substring": ("filterbyname", [
        "in={d}/reads.fq", "out={o}/f.fq", "names=r1,r22", "include=t",
        "substring=t"]),
    "demuxbyname": ("demuxbyname", ["in={d}/names_a.fq",
                                    "out={o}/dm_%.fq", "names=a,b",
                                    "delimiter=_"]),
    "splitnexteralmp": ("splitnexteralmp", [
        "in={d}/lmp1.fq", "in2={d}/lmp2.fq", "out={o}/lmp.fq",
        "outf={o}/frag.fq", "outu={o}/unk.fq", "outs={o}/single.fq",
        "stats={o}/stats.txt", "minlen=20"]),
    "splitnextera single": ("splitnextera", [
        "in={d}/lmp1.fq", "out={o}/lmp.fq", "outs={o}/single.fq",
        "minlen=20"]),
    "rqcfilter single-end khist": ("rqcfilter", [
        "in={d}/se.fq", "out=clean.fq", "path={o}", "ref={d}/adapters.fa",
        "artifactdb={d}/artifacts.fa", "phixref={d}/phix.fa", "khist=t",
        "ihist=ihist.txt"]),
    "bbqc phix=f": ("bbqc", [
        "in={d}/se.fq", "out=clean.fq.gz", "path={o}", "ref={d}/adapters.fa",
        "artifactdb={d}/artifacts.fa", "phix=f", "maq=20", "ftm=5"]),
    "rqcfilter clip": ("rqcfilter", [
        "in={d}/se.fq", "out=clean.fq", "path={o}", "library=clip",
        "cliplinker=AGATCGGAAGAGCAC", "artifactdb={d}/artifacts.fa",
        "phixref={d}/phix.fa"]),
    "rqcfilter nextera": ("rqcfilter", [
        "in={d}/lmp1.fq", "out=clean.fq.gz",
        "path={o}", "ref={d}/adapters.fa", "filter=f", "nextera=t",
        "minlength=20"]),
}
# files with a time stamp or the command line (device= on the port's)
UNCOMPARED = {"status.log", "reproduce.sh"}


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
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _report(err: str, o) -> str:
    """stderr without wall times and with the output directory as {o}."""
    keep = [ln.replace(str(o), "{o}") for ln in err.splitlines()
            if not ln.startswith("Time:")
            and not re.search(r"\d seconds", ln)]
    return "\n".join(keep)


def _files(o):
    return {p.name: p.read_bytes() for p in sorted(o.iterdir())
            if p.is_file() and p.name not in UNCOMPARED}


@pytest.fixture(scope="module")
def covstats(corpus, tmp_path_factory):
    from bbmap_tpu.tools import pileup
    path = tmp_path_factory.mktemp("cov") / "covstats.txt"
    assert pileup.main([f"in={corpus}/map.sam", f"out={path}"]) == 0
    return path


@pytest.mark.parametrize("case", list(CASES))
def test_cli_byte_equal(corpus, covstats, tmp_path, monkeypatch, capsys,
                        case):
    tool, template = CASES[case]
    runs = {}
    for side in ("port", "jax"):
        o = tmp_path / side
        o.mkdir()
        args = [a.format(d=corpus, o=o, t=tmp_path / f"tmp_{side}",
                         c=covstats) for a in template]
        rc, out, err = _run(monkeypatch, capsys, side, tool, args)
        assert rc == 0, (side, err[-2000:])
        runs[side] = (out, _report(err, o), _files(o))
    (out_p, err_p, files_p), (out_j, err_j, files_j) = \
        runs["port"], runs["jax"]
    assert out_p == out_j
    assert err_p == err_j
    assert sorted(files_p) == sorted(files_j) and files_p
    for name in files_p:
        assert files_p[name] == files_j[name], name
    assert sum(len(v) for v in files_p.values()) > 40


def test_dispatcher_lists_the_slice(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bbmap_tpu_torch"])
    assert port_main.main() == 0
    listed = capsys.readouterr().out
    tools = {tool for tool, _ in CASES.values()}
    assert len(tools) == 24
    for tool in tools:
        assert tool in port_main.TOOLS and re.search(
            rf"\b{re.escape(tool)}\b", listed)


def _mates(path):
    lines = path.read_bytes().split(b"\n")
    return [lines[i][1:].split(b"/")[0] for i in range(0, len(lines) - 1, 4)]


def test_rqcfilter_paired_keeps_its_pairs(corpus, tmp_path, monkeypatch,
                                          capsys):
    """Documented deviation: paired rqcfilter threads the pairing through
    every stage. Its out2 holds the mates of out, in order (the JAX tool's
    is empty), the pairs are those the single stages would keep, and the
    insert-size histogram is bbmerge's on the filtered pairs."""
    args = [f"in={corpus}/pe1.fq", f"in2={corpus}/pe2.fq", "out=c1.fq",
            "out2=c2.fq", f"ref={corpus}/adapters.fa",
            f"artifactdb={corpus}/artifacts.fa",
            f"phixref={corpus}/phix.fa", "ihist=ihist.txt", "khist=t"]
    o, j = tmp_path / "port", tmp_path / "jax"
    rc, _, err = _run(monkeypatch, capsys, "port", "rqcfilter",
                      args + [f"path={o}"])
    assert rc == 0, err
    rc, _, _ = _run(monkeypatch, capsys, "jax", "rqcfilter",
                    args + [f"path={j}"])
    assert rc == 0
    assert (j / "c2.fq").read_bytes() == b""          # the JAX tool's fault
    m1, m2 = _mates(o / "c1.fq"), _mates(o / "c2.fq")
    assert 100 < len(m1) < 240 and m1 == m2
    stats = (o / "filterStats.txt").read_text().splitlines()
    trim_reads = int(stats[1].split("\t")[1])
    filt_reads = int(stats[2].split("\t")[1])
    assert trim_reads % 2 == 0 and filt_reads == 2 * len(m1) < trim_reads
    assert "filtered_fastq_2=c2.fq" in (o / "file-list.txt").read_text()
    # phiX and artifact pairs are gone, both mates of each
    names = set(m1)
    assert not any(f"q{i}".encode() in names for i in range(0, 240, 9))
    want = tmp_path / "want_ihist.txt"
    rc, _, _ = _run(monkeypatch, capsys, "port", "bbmerge",
                    [f"in={o}/c1.fq", f"in2={o}/c2.fq", f"ihist={want}"])
    assert rc == 0
    assert (o / "ihist.txt").read_bytes() == want.read_bytes()
    kh = tmp_path / "want_khist.txt"
    rc, _, _ = _run(monkeypatch, capsys, "port", "kmercountexact",
                    [f"in={o}/c1.fq", f"in2={o}/c2.fq", f"khist={kh}",
                     "k=31"])
    assert (o / "khist.txt").read_bytes() == kh.read_bytes()


def test_rqcfilter_paired_interleaved_stages(corpus, tmp_path, monkeypatch,
                                             capsys):
    """Documented deviation: without out2= the paired chain writes the
    filtered pairs interleaved to out, mates adjacent; a filter stage
    without references passes them through and splits them at the end
    when out2= is given."""
    common = [f"in={corpus}/pe1.fq", f"in2={corpus}/pe2.fq",
              f"ref={corpus}/adapters.fa"]
    o = tmp_path / "inter"
    rc, _, err = _run(monkeypatch, capsys, "port", "rqcfilter", common + [
        "out=c.fq", f"path={o}", f"artifactdb={corpus}/artifacts.fa",
        f"phixref={corpus}/phix.fa"])
    assert rc == 0, err
    m = _mates(o / "c.fq")
    assert len(m) % 2 == 0 and m[0::2] == m[1::2] and m
    o2 = tmp_path / "norefs"
    rc, _, err = _run(monkeypatch, capsys, "port", "rqcfilter", common + [
        "out=c1.fq", "out2=c2.fq", f"path={o2}",
        f"artifactdb={tmp_path}/absent.fa"])
    assert rc == 0, err
    m1, m2 = _mates(o2 / "c1.fq"), _mates(o2 / "c2.fq")
    assert m1 == m2 and len(m1) > 100
    # both references are named, the absent file and the one not given
    assert "no artifactdb reference" in err and "absent.fa not found" in err
    assert "no phixref reference (not given)" in err
    stats = (o2 / "filterStats.txt").read_text().splitlines()
    assert len(stats) == 2 and stats[1].startswith(f"trim\t{2 * len(m1)}\t")
    # the Nextera split reads the trimmed pairs as pairs: mate 2 (no
    # junction) joins its mate 1's left part as a long mate pair, where
    # the JAX tool reads them one by one and writes mate 2 as a singleton
    lmp = {}
    for side in ("port", "jax"):
        o3 = tmp_path / f"nextera_{side}"
        rc, _, err = _run(monkeypatch, capsys, side, "rqcfilter", [
            f"in={corpus}/lmp1.fq", f"in2={corpus}/lmp2.fq",
            "out=c.fq.gz", f"path={o3}", f"ref={corpus}/adapters.fa",
            "filter=f", "nextera=t", "minlength=20"])
        assert rc == 0, err
        with gzip.open(o3 / "c.lmp.fq.gz", "rb") as fh:
            lmp[side] = fh.read()
    mate2 = [ln for ln in (corpus / "lmp2.fq").read_bytes().split(b"\n")[1::4]
             if ln]
    assert sum(m[:50] in lmp["port"] for m in mate2) > 20
    assert not any(m[:50] in lmp["jax"] for m in mate2)


def test_rqcfilter_names_an_absent_adapter_file(corpus, tmp_path,
                                                monkeypatch, capsys):
    """A requested trim reference that is not given is named on stderr;
    the stage runs without it (quality trimming only). So is ribo=t
    without ribodb=, a stage then skipped. The JAX tool reads a default
    path under the machine's reference directory for the adapters and
    skips the ribo stage without a word."""
    o = tmp_path / "rqc"
    rc, _, err = _run(monkeypatch, capsys, "port", "rqcfilter", [
        f"in={corpus}/se.fq", "out=c.fq", f"path={o}", "phix=f",
        f"artifactdb={corpus}/artifacts.fa", "ribo=t"])
    assert rc == 0, err
    assert "trim stage: no ref reference (not given)" in err
    assert "ribo stage: no ribodb reference (not given)" in err
    assert "phixref" not in err
    assert (o / "c.fq").stat().st_size > 0


def test_kmercountexact_counts_in2(corpus, tmp_path, monkeypatch, capsys):
    """The port's kmercountexact also counts the mates of in2= (rqcfilter's
    khist of a paired run): its files equal the JAX tool's on the two
    files joined."""
    both = tmp_path / "both.fq"
    both.write_bytes((corpus / "reads.fq").read_bytes()
                     + (corpus / "reads2.fq").read_bytes())
    runs = {}
    for side, inputs in (("port", [f"in={corpus}/reads.fq",
                                   f"in2={corpus}/reads2.fq"]),
                         ("jax", [f"in={both}"])):
        o = tmp_path / side
        o.mkdir()
        rc, _, err = _run(monkeypatch, capsys, side, "kmercountexact",
                          inputs + [f"khist={o}/khist.txt", "k=21",
                                    f"out={o}/dump.fa", "mincount=2"])
        assert rc == 0, err
        runs[side] = (err, _files(o))
    assert runs["port"] == runs["jax"]
    assert "Reads:\t1000\n" in runs["port"][0]
