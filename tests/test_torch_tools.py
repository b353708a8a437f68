"""The port's read-preprocessing CLIs against the JAX package's:
``python -m bbmap_tpu_torch <tool> ... device=cpu`` (the dispatcher's
``main``, in this process) and the JAX tool's ``main`` (device scans
forced on, ``BBMAP_DEVICE_KMERS=1`` / ``BBMAP_DEVICE_OVERLAP=1``, as its
own tests do) write byte-equal output read files and stats files, and
the same report on stderr once its ``Time:`` line is dropped: bbduk
(ktrim=r / l with short tip k-mers and hdist, kmask, filter, qtrim,
paired tbo=t), bbduk2 with four sets, seal (stats / rpkm / refstats /
pattern, paired) and bbmerge (ratio mode and the mismatch mode's
QUAL_ITERS ladder). ``hosts=2`` (two processes) gives each tool's
``hosts=1`` output and the JAX tool's. Two
documented deviations from the JAX tools, which crash there: bbduk with
k > 31 and seal with ``interleaved=t`` over an odd number of reads exit
1 with a message."""

import sys

import numpy as np
import pytest

from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.tools import bbduk as jbbduk
from bbmap_tpu.tools import bbduk2 as jbbduk2
from bbmap_tpu.tools import bbmerge as jbbmerge
from bbmap_tpu.tools import seal as jseal
from bbmap_tpu_torch import __main__ as port_main

BASES = np.frombuffer(b"ACGT", np.uint8)
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"
JAX_MAIN = {"bbduk": jbbduk.main, "bbduk2": jbbduk2.main,
            "seal": jseal.main, "bbmerge": jbbmerge.main}


def _seq(rng, n):
    return bytes(rng.choice(BASES, n))


def _fq(path, recs):
    with open(path, "wb") as fh:
        for name, seq, q in recs:
            fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                     + bytes(33 + np.asarray(q, np.uint8)) + b"\n")


def _quals(rng, n):
    """phred 20-40 with a low-quality tail on a third of the reads."""
    q = rng.integers(20, 41, n)
    if rng.random() < 0.33:
        q[-int(rng.integers(5, 30)):] = rng.integers(2, 9)
    return q


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Adapters and 400 single reads of 150 bp, a third with an adapter
    (or its first 12-20 bases at the tip), 0.5 % N; 600 pairs of 2 x 100
    bp at inserts 60-180 with adapter read-through; seal's references
    and reads; bbduk2's four sets; bbmerge's pairs at inserts 150-260."""
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(3)
    adapter = _seq(rng, 34)
    with open(d / "adapters.fa", "wb") as fh:
        fh.write(b">ad1\n" + adapter + b"\n>truseq\n" + TRUSEQ + b"\n")
    recs = []
    for i in range(400):
        body = bytearray(_seq(rng, 150))
        kind = i % 6
        ad = TRUSEQ if i % 12 < 6 else adapter
        if kind == 0:
            at = int(rng.integers(60, 110))
            body[at:at + len(ad)] = ad
        elif kind == 1:
            tip = int(rng.integers(12, 21))
            body[150 - tip:] = ad[:tip]
        elif kind == 2:
            at = int(rng.integers(0, 40))
            body[at:at + len(ad)] = COMP_ASCII[np.frombuffer(ad, np.uint8)
                                               ][::-1].tobytes()
        body = bytes(body[:150])
        arr = np.frombuffer(body, np.uint8).copy()
        arr[rng.random(150) < 0.005] = ord("N")
        recs.append((f"r{i}", arr.tobytes(), _quals(rng, 150)))
    _fq(d / "reads.fq", recs)

    r1s, r2s = [], []
    for i in range(600):
        ins = int(rng.integers(60, 181))
        frag = np.frombuffer(_seq(rng, ins), np.uint8)
        r1 = np.concatenate([frag, np.frombuffer(TRUSEQ * 3, np.uint8)])
        r2 = np.concatenate([COMP_ASCII[frag][::-1],
                             np.frombuffer(adapter * 3, np.uint8)])
        r1s.append((f"p{i}/1", r1[:100].tobytes(), _quals(rng, 100)))
        r2s.append((f"p{i}/2", r2[:100].tobytes(), _quals(rng, 100)))
    _fq(d / "pe1.fq", r1s)
    _fq(d / "pe2.fq", r2s)

    refs = [bytearray(_seq(rng, 500)) for _ in range(3)]
    refs[2][100:200] = refs[0][300:400]         # k-mers with two owners
    refs = [bytes(r) for r in refs]
    with open(d / "refA.fa", "wb") as fh:
        fh.write(b">rA desc\n" + refs[0] + b"\n>rB\n" + refs[1] + b"\n")
    with open(d / "refB.fa", "wb") as fh:
        fh.write(b">rC\n" + refs[2] + b"\n")
    s1, s2 = [], []
    for i in range(300):
        src = refs[i % 3] if i % 7 else _seq(rng, 500)
        s = int(rng.integers(0, 500 - 260))
        a = np.frombuffer(src[s:s + 90], np.uint8).copy()
        b = COMP_ASCII[np.frombuffer(src[s + 170:s + 260], np.uint8)][::-1]
        a[rng.random(90) < 0.02] = ord("G")
        s1.append((f"s{i}", a.tobytes(), _quals(rng, 90)))
        s2.append((f"s{i}", b.tobytes(), _quals(rng, 90)))
    _fq(d / "seal1.fq", s1)
    _fq(d / "seal2.fq", s2)

    body = _seq(rng, 60).decode()
    sets = {"f": "GAGTTTTATCGCTTCCATGACGCAG",
            "r": "AGATCGGAAGAGCACACGTCTGAACT",
            "l": "TTCAGACGTGTGCTCTTCCGATCTAA",
            "m": "CCGGTTAACCGGTTAACCGGTTAACC"}
    for s, seq in sets.items():
        (d / f"{s}.fa").write_text(f">{s}set\n{seq}\n")
    reads2 = []
    for i in range(120):
        kind = i % 5
        b = body[i % 20:] + body[:i % 20]
        seq = {0: b, 1: b[:20] + sets["f"] + b[20:40],
               2: b[:40] + sets["r"], 3: sets["l"] + b[:40],
               4: b[:20] + sets["m"] + b[20:40]}[kind]
        reads2.append((f"b{i}", seq.encode(), _quals(rng, len(seq))))
    _fq(d / "duk2.fq", reads2)

    m1, m2 = [], []
    for i in range(600):
        ins = int(rng.integers(150, 261))
        frag = np.frombuffer(_seq(rng, ins), np.uint8).copy()
        r1 = frag[:150].copy()
        r2 = COMP_ASCII[frag[ins - 150:]][::-1].copy()
        r2[rng.random(150) < 0.01] = BASES[rng.integers(0, 4)]
        m1.append((f"m{i}/1", r1.tobytes(), _quals(rng, 150)))
        m2.append((f"m{i}/2", r2.tobytes(), _quals(rng, 150)))
    _fq(d / "merge1.fq", m1)
    _fq(d / "merge2.fq", m2)
    return d


REF = "ref={d}/adapters.fa"
CASES = {
    "bbduk ktrim=r mink hdist": ("bbduk", [
        "in={d}/reads.fq", "out={o}/out.fq", REF, "k=23", "ktrim=r",
        "mink=11", "hdist=1", "stats={o}/stats.txt"]),
    "bbduk ktrim=l mink": ("bbduk", [
        "in={d}/reads.fq", "out={o}/out.fq", REF, "k=23", "ktrim=l",
        "mink=11", "stats={o}/stats.txt"]),
    "bbduk kmask": ("bbduk", [
        "in={d}/reads.fq", "out={o}/out.fq", REF, "k=25", "kmask=N"]),
    "bbduk filter": ("bbduk", [
        "in={d}/reads.fq", "out={o}/out.fq", "outm={o}/outm.fq", REF,
        "k=27", "hdist=1", "stats={o}/stats.txt"]),
    "bbduk qtrim": ("bbduk", [
        "in={d}/reads.fq", "out={o}/out.fq", "outm={o}/outm.fq", REF,
        "k=23", "ktrim=r", "qtrim=rl", "trimq=10", "minlen=40"]),
    "bbduk paired tbo": ("bbduk", [
        "in={d}/pe1.fq", "in2={d}/pe2.fq", "out={o}/out1.fq",
        "out2={o}/out2.fq", "outm={o}/outm.fq", REF, "k=23", "ktrim=r",
        "hdist=1", "tbo=t", "tpe=t", "stats={o}/stats.txt"]),
    "bbduk2 four sets": ("bbduk2", [
        "in={d}/duk2.fq", "out={o}/out.fq", "outm={o}/outm.fq",
        "fref={d}/f.fa", "rref={d}/r.fa", "lref={d}/l.fa", "mref={d}/m.fa",
        "k=25", "stats={o}/stats.txt"]),
    "seal paired stats rpkm refstats pattern": ("seal", [
        "in={d}/seal1.fq", "in2={d}/seal2.fq",
        "ref={d}/refA.fa,{d}/refB.fa", "stats={o}/stats.txt",
        "rpkm={o}/rpkm.txt", "refstats={o}/refstats.txt",
        "pattern={o}/out_%.fq", "outu={o}/outu.fq", "k=21"]),
    "seal ambig=all statscolumns=5": ("seal", [
        "in={d}/seal1.fq", "ref={d}/refA.fa,{d}/refB.fa",
        "stats={o}/stats.txt", "pattern={o}/out_%.fq", "ambig=all",
        "cols=5", "k=25", "mkf=0.2"]),
    "bbmerge ratio mode": ("bbmerge", [
        "in1={d}/merge1.fq", "in2={d}/merge2.fq", "out={o}/merged.fq",
        "outu={o}/u1.fq", "outu2={o}/u2.fq", "ihist={o}/ihist.txt"]),
    "bbmerge mismatch mode": ("bbmerge", [
        "in1={d}/merge1.fq", "in2={d}/merge2.fq", "out={o}/merged.fq",
        "outu={o}/u1.fq", "ihist={o}/ihist.txt", "useratio=f"]),
}


def _port(monkeypatch, tool, args):
    monkeypatch.setattr(sys, "argv",
                        ["bbmap_tpu_torch", tool, *args, "device=cpu"])
    return port_main.main()


def _report(err: str) -> str:
    return "\n".join(ln for ln in err.splitlines()
                     if not ln.startswith("Time:"))


@pytest.mark.parametrize("case", list(CASES))
def test_cli_byte_equal(corpus, tmp_path, monkeypatch, capsys, case):
    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "1")
    monkeypatch.setenv("BBMAP_DEVICE_OVERLAP", "1")
    tool, template = CASES[case]
    runs = {}
    for side in ("port", "jax"):
        o = tmp_path / side
        o.mkdir()
        args = [a.format(d=corpus, o=o) for a in template]
        capsys.readouterr()
        rc = _port(monkeypatch, tool, args) if side == "port" \
            else JAX_MAIN[tool](args)
        assert rc == 0, side
        runs[side] = (_report(capsys.readouterr().err),
                      {p.name: p.read_bytes() for p in o.iterdir()})
    (err_p, files_p), (err_j, files_j) = runs["port"], runs["jax"]
    assert err_p == err_j
    assert sorted(files_p) == sorted(files_j) and files_p
    for name in files_p:
        assert files_p[name] == files_j[name], name
    reads = b"".join(v for n, v in files_p.items() if n.endswith(".fq"))
    assert reads.count(b"\n@") > 50


HOSTS_ARGS = {
    "bbduk": ["in={d}/reads.fq", "out={o}/o.fq", "outm={o}/m.fq",
              "ref={d}/adapters.fa", "stats={o}/s.txt"],
    "seal": ["in={d}/seal1.fq", "in2={d}/seal2.fq", "ref={d}/refA.fa,"
             "{d}/refB.fa", "outm={o}/m.fq", "outu={o}/u.fq",
             "pattern={o}/p_%.fq", "stats={o}/s.txt", "ambig=all"],
    "bbmerge": ["in1={d}/merge1.fq", "in2={d}/merge2.fq", "out={o}/m.fq",
                "outu1={o}/u1.fq", "outu2={o}/u2.fq", "ihist={o}/ih.txt"]}


@pytest.mark.parametrize("tool", ["bbduk", "seal", "bbmerge"])
def test_hosts_striped_equals_one_host(corpus, tmp_path, monkeypatch,
                                       capsys, tool):
    """hosts=2 (two processes, device=cpu): host 0 merges the shards and
    reduces the counts, and every output and stats file is byte-equal to
    the port's hosts=1 run and to the JAX tool's; no shard or marker is
    left."""
    from tests.test_torch_multihost import cli_ranks
    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "1")
    monkeypatch.setenv("BBMAP_DEVICE_OVERLAP", "1")
    files = {}
    for side in ("one", "two", "jax"):
        o = tmp_path / side
        o.mkdir()
        args = [a.format(d=corpus, o=o) for a in HOSTS_ARGS[tool]]
        if side == "one":
            assert _port(monkeypatch, tool, args) == 0
        elif side == "two":
            cli_ranks(tool, args + ["device=cpu"], timeout=240)
        else:
            assert JAX_MAIN[tool](args) == 0
        files[side] = {p.name: p.read_bytes() for p in o.iterdir()}
    assert sorted(files["two"]) == sorted(files["one"]) == \
        sorted(files["jax"])
    for name in files["one"]:
        assert files["two"][name] == files["one"][name] == \
            files["jax"][name], name
    assert sum(len(v) for v in files["two"].values()) > 1000


@pytest.mark.parametrize("k, adapters", [(40, "adapters.fa"),
                                         (32, "long.fa")])
def test_bbduk_k_above_31_exits(corpus, tmp_path, monkeypatch, capsys, k,
                                adapters):
    """Documented deviation: k > 31 exits 1 with a message naming the
    limit and kbig=, before the set is built, whether the set would be
    empty (k = 40 over 34 bp adapters) or not (k = 32 over an adapter of
    60 bp). The JAX tool raises OverflowError at
    bbmap_tpu/index/build.py:86 in both cases."""
    (corpus / "long.fa").write_bytes(b">long\n" + TRUSEQ + TRUSEQ[:26]
                                     + b"\n")
    args = [f"in={corpus}/reads.fq", f"out={tmp_path}/o.fq",
            f"ref={corpus}/{adapters}", f"k={k}", "hdist=0"]
    assert _port(monkeypatch, "bbduk", args) == 1
    err = capsys.readouterr().err
    assert f"k={k}" in err and "k <= 31" in err and "kbig=" in err
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "1")
    (tmp_path / "j").mkdir()
    with pytest.raises(OverflowError):
        jbbduk.main([a.replace(str(tmp_path), str(tmp_path / "j"))
                     for a in args])


def test_seal_interleaved_odd_count_exits(corpus, tmp_path, monkeypatch,
                                          capsys):
    """Documented deviation: seal with interleaved=t over a file of an odd
    number of reads exits 1 with a message naming the count. The JAX tool
    splits the chunk into unequal mate lists
    (bbmap_tpu/tools/seal.py:563-566) and crashes."""
    lines = (corpus / "seal1.fq").read_bytes().splitlines(keepends=True)
    odd = tmp_path / "odd.fq"
    odd.write_bytes(b"".join(lines[:4 * 101]))
    args = [f"in={odd}", f"ref={corpus}/refA.fa", "interleaved=t",
            f"outm={tmp_path}/m.fq", f"stats={tmp_path}/s.txt"]
    assert _port(monkeypatch, "seal", args) == 1
    err = capsys.readouterr().err
    assert "odd number of reads (101)" in err and "interleaved=t" in err
    assert not (tmp_path / "s.txt").exists()
    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "1")
    with pytest.raises(Exception):
        jseal.main([a.replace("m.fq", "jm.fq").replace("s.txt", "js.txt")
                    for a in args])


def test_dispatcher_lists_the_tools(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bbmap_tpu_torch"])
    assert port_main.main() == 0
    listed = capsys.readouterr().out
    for tool in ("bbduk", "bbduk2", "seal", "bbmerge", "bbmerge-auto",
                 "bbmask"):
        assert f" {tool}," in listed or listed.rstrip().endswith(tool)
