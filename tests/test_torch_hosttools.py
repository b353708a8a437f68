"""The port's host tools against the JAX package's, first part: ``python
-m bbmap_tpu_torch <tool> ...`` and ``python -m bbmap_tpu <tool> ...``
(both dispatchers' ``main``, in this process) on the same seeded inputs
print the same stdout, the same report on stderr (once lines that carry a
wall time are set aside) and write byte-equal output files. This file
covers reformat, stats, comparesam, samtoroc, calctruequality, clumpify,
loglog, sketch / comparesketch, bbcountunique, reclusterbykmer, the id
tools (idmatrix, idtree, msa, cutprimers, commonkmers), removesmartbell
and the taxonomy suite; ``test_torch_smalltools.py`` and
``test_torch_synthtools.py`` cover the rest and use this file's harness.

The host tools take no ``device=``; only ``bbwrap`` gets ``device=cpu`` on
the port's side. Every input is written here from a seed; nothing is read
from outside the test's directories.

What is compared less than whole, and why (``PARTIAL``): ``gitable``
writes a ``.npz`` whose zip members carry the time they were written, so
its arrays are compared instead of its bytes.
"""

import importlib
import io
import itertools
import re
import sys
import zipfile

import numpy as np
import pytest

from bbmap_tpu import __main__ as jax_main
from bbmap_tpu.tools.removesmartbell import SMARTBELL
from bbmap_tpu_torch import __main__ as port_main

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
# tools that run on a device and so take device= on the port's side
DEVICE_TOOLS = {"bbwrap"}
# file suffix -> how its content is read for the comparison, and why
PARTIAL = {".npz": "zip members carry their write time; arrays compared"}


def rc(s: bytes) -> bytes:
    return s.translate(COMP)[::-1]


def seq(rng, n) -> bytes:
    return bytes(rng.choice(BASES, n))


def mutate(rng, s: bytes, n_subs: int) -> bytes:
    a = bytearray(s)
    for p in rng.choice(len(a), n_subs, replace=False):
        a[p] = BASES[(BASES.tolist().index(a[p]) + 1
                      + int(rng.integers(0, 3))) % 4]
    return bytes(a)


def qual(rng, n, lo=10, hi=41) -> bytes:
    return bytes((33 + rng.integers(lo, hi, n)).astype(np.uint8))


def write_fa(path, recs):
    with open(path, "wb") as fh:
        for name, s in recs:
            fh.write(b">" + name.encode() + b"\n" + s + b"\n")


def write_fq(path, recs):
    with open(path, "wb") as fh:
        for name, s, q in recs:
            fh.write(b"@" + name.encode() + b"\n" + s + b"\n+\n" + q + b"\n")


def write_sam(path, rng, scafs, n, shift=None):
    """A SAM of ``n`` reads of 60 bp named as randomreads names them
    (``{i}_chr{c}_{strand}_{start}_{stop}_{rel}_{scaffold}``), with =/X/D
    cigars, MD tags and qualities; every read over s1:500 carries a T
    there. ``shift`` moves, flips or unmaps some reads (a second mapper's
    answer)."""
    lines = ["@HD\tVN:1.4\tSO:unsorted"]
    lines += [f"@SQ\tSN:{nm}\tLN:{len(s)}" for nm, s in scafs]
    offs = np.cumsum([0] + [len(s) for _, s in scafs])
    for i in range(n):
        c = int(rng.integers(0, len(scafs)))
        nm, g = scafs[c]
        L = 60
        pos = int(rng.integers(0, len(g) - L - 4))
        if c == 0 and i % 3 == 0:
            pos = int(rng.integers(500 - L + 1, 500))
        strand = int(rng.integers(0, 2))
        start = int(offs[c]) + pos
        name = f"{i}_chr{c + 1}_{strand}_{start}_{start + L - 1}_{pos}_{nm}"
        ref = bytearray(g[pos:pos + L + 2])
        read = bytearray(ref[:L])
        subs = set(int(x) for x in rng.choice(L, int(rng.integers(0, 3)),
                                               replace=False))
        if c == 0 and pos <= 500 < pos + L:
            subs.add(500 - pos)
        dele = i % 11 == 5
        ops, md, run = [], [], 0
        for j in range(L):
            if dele and j == 30:
                read = read[:30] + ref[32:L + 2]
                ops += ["D", "D"]
                md.append(f"{run}^{ref[30:32].decode()}")
                run = 0
            rj = ref[j + 2 if dele and j >= 30 else j]
            if j in subs:
                alt = b"T"[0] if c == 0 and pos + j == 500 else \
                    BASES[(BASES.tolist().index(rj) + 1) % 4]
                if alt == rj:
                    alt = BASES[(BASES.tolist().index(rj) + 2) % 4]
                read[j] = alt
                ops.append("X")
                md.append(f"{run}{chr(rj)}")
                run = 0
            else:
                read[j] = rj
                ops.append("=")
                run += 1
        md.append(str(run))
        cigar = "".join(f"{len(list(grp))}{op}"
                        for op, grp in itertools.groupby(ops))
        flag, mapq, rname, p1 = 16 * strand, int(rng.integers(0, 51)), nm, \
            pos + 1
        if i % 13 == 7:
            flag, mapq, rname, p1, cigar = 4, 0, "*", 0, "*"
        elif i % 9 == 4:
            p1 += int(rng.integers(30, 300))
        if shift is not None and i % shift == 1 and flag != 4:
            if i % 2:
                p1 += 50
            else:
                flag ^= 16
        tags = "" if flag & 4 else f"\tNM:i:{len(subs) + 2 * dele}" \
            f"\tMD:Z:{''.join(md)}"
        lines.append(f"{name}\t{flag}\t{rname}\t{p1}\t{mapq}\t{cigar}\t*\t0"
                     f"\t0\t{bytes(read[:L]).decode()}\t"
                     f"{qual(rng, L).decode()}{tags}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


class _Stream(io.BytesIO):
    """A captured stream that outlives the tools that close stdout when
    they are done with it (``fastx.write_fasta("stdout", ...)``)."""

    def close(self):
        pass


def run_cli(monkeypatch, side, tool, args):
    """One tool run through a dispatcher's ``main`` in this process:
    (rc, stdout, stderr)."""
    if side == "port":
        extra = ["device=cpu"] if tool in DEVICE_TOOLS else []
        argv, main = ["bbmap_tpu_torch", tool, *args, *extra], port_main.main
    else:
        argv, main = ["bbmap_tpu", tool, *args], jax_main.main
    monkeypatch.setattr(sys, "argv", argv)
    streams = {}
    for name in ("stdout", "stderr"):
        streams[name] = io.TextIOWrapper(_Stream(), encoding="utf-8",
                                         write_through=True)
        monkeypatch.setattr(sys, name, streams[name])
    rc = main()
    out, err = (streams[n].buffer.getvalue().decode() for n in
                ("stdout", "stderr"))
    return rc, out, err


def _report(text: str, o) -> str:
    """A stream without wall times and with the output directory as {o}."""
    return "\n".join(ln.replace(str(o), "{o}") for ln in text.splitlines()
                     if not ln.startswith("Time:")
                     and not re.search(r"\d seconds", ln))


def _content(path):
    data = path.read_bytes()
    if path.suffix in PARTIAL:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            return {n: np.load(io.BytesIO(z.read(n))).tobytes()
                    for n in sorted(z.namelist())}
    return data


def _files(o):
    return {str(p.relative_to(o)): _content(p)
            for p in sorted(o.rglob("*")) if p.is_file()}


def compare(tmp_path, monkeypatch, d, tool, template, setup=None):
    """Run ``tool`` on both packages, each into its own directory; assert
    rc 0, equal stdout and stderr reports and equal files, and return the
    port's (stdout, files)."""
    runs = {}
    for side in ("port", "jax"):
        o = tmp_path / side
        o.mkdir()
        if setup is not None:
            setup(o)
        args = [a.format(d=d, o=o) for a in template]
        rc, out, err = run_cli(monkeypatch, side, tool, args)
        assert rc == 0, (side, err[-2000:])
        runs[side] = (_report(out, o), _report(err, o), _files(o))
    (out_p, err_p, files_p), (out_j, err_j, files_j) = \
        runs["port"], runs["jax"]
    assert out_p == out_j
    assert err_p == err_j
    assert sorted(files_p) == sorted(files_j)
    for name in files_p:
        assert files_p[name] == files_j[name], name
    assert out_p.strip() or any(len(v) for v in files_p.values())
    return out_p, files_p


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from bbmap_tpu.tools import idtools, sketch, taxonomy
    d = tmp_path_factory.mktemp("hosttools")
    rng = np.random.default_rng(2024)
    g = seq(rng, 5000)
    scafs = [("s1", g[:3000]), ("s2", g[3000:])]
    write_fa(d / "ref.fa", scafs)
    write_fa(d / "asm.fa", [
        ("scaf1", seq(rng, 700) + b"N" * 20 + seq(rng, 500)),
        ("scaf2", seq(rng, 400)), ("scaf3", seq(rng, 90) + b"NNNN"
                                   + seq(rng, 60)),
        ("scaf4", b"GGCCGGCC" * 30)])
    reads = []
    for i in range(240):
        p = int(rng.integers(0, len(g) - 100))
        s = g[p:p + 100] if i % 4 else rc(g[p:p + 100])
        s = mutate(rng, s, int(rng.integers(0, 3)))
        q = bytearray(qual(rng, 100, 25, 41))
        if i % 5 == 0:
            q[80:] = qual(rng, 20, 2, 12)
        reads.append((f"r{i}", s, bytes(q)))
    reads.append(("dup", reads[3][1], reads[3][2]))
    reads.append(("rcdup", rc(reads[8][1]), reads[8][2][::-1]))
    reads.append(("lower", reads[9][1].lower(), reads[9][2]))
    write_fq(d / "reads.fq", reads)
    pairs1, pairs2 = [], []
    for i in range(40):
        p = int(rng.integers(0, len(g) - 300))
        n2 = f"q{i}/2" if i == 5 else f"p{i}/2"
        pairs1.append((f"p{i}/1", g[p:p + 80], qual(rng, 80)))
        pairs2.append((n2, rc(g[p + 200:p + 280]), qual(rng, 80)))
    write_fq(d / "r1.fq", pairs1)
    write_fq(d / "r2.fq", pairs2)
    write_fq(d / "inter.fq", [r for pr in zip(pairs1, pairs2) for r in pr])
    write_sam(d / "map.sam", np.random.default_rng(5), scafs, 160)
    write_sam(d / "map2.sam", np.random.default_rng(5), scafs, 160, shift=4)
    left, right = seq(rng, 300), seq(rng, 250)
    write_fq(d / "pb.fq", [
        (f"zmw{i}", s, b"I" * len(s)) for i, s in enumerate([
            left + SMARTBELL + right, left[:200] + rc(SMARTBELL) + right,
            mutate(rng, left + SMARTBELL + right[:30], 0), seq(rng, 400),
            left[:150] + mutate(rng, SMARTBELL, 3) + right[:150]
            + SMARTBELL + left[150:]])])
    src_a, src_b = seq(rng, 1000), seq(rng, 1000)
    rk = [(f"a{i}", src_a[s:s + 100], b"I" * 100)
          for i, s in enumerate(rng.integers(0, 900, 20))]
    rk += [(f"b{i}", src_b[s:s + 100], b"I" * 100)
           for i, s in enumerate(rng.integers(0, 900, 20))]
    write_fq(d / "clusters.fq", rk)
    base = seq(rng, 60)
    write_fa(d / "ids.fa", [
        ("a", base), ("b", mutate(rng, base, 3)),
        ("c", base[:25] + base[27:] + b"AC"), ("d", seq(rng, 60)),
        ("e", mutate(rng, base, 9)), ("f", base[5:55])])
    write_fa(d / "primers.fa", [
        ("s1", b"AACCGGTT" + b"ACGTACGT" + b"TTTTCCCC" + b"GGATCCAT"
         + b"AAGGTTCC"),
        ("s2", seq(rng, 12) + b"ACGTACGT" + seq(rng, 20) + b"GGATCCAT"
         + seq(rng, 6)),
        ("s3", seq(rng, 40))])
    assert idtools.idmatrix([f"in={d / 'ids.fa'}",
                             f"out={d / 'mat.tsv'}"]) == 0
    assert idtools.msa([f"in={d / 'primers.fa'}", f"out={d / 'p1.sam'}",
                        "literal=ACGTACGT"]) == 0
    assert idtools.msa([f"in={d / 'primers.fa'}", f"out={d / 'p2.sam'}",
                        "literal=GGATCCAT"]) == 0
    g1 = seq(rng, 20000)
    write_fa(d / "g1.fa", [("g1", g1)])
    write_fa(d / "g2.fa", [("g2", mutate(rng, g1, 200))])
    write_fa(d / "g3.fa", [("g3", seq(rng, 20000))])
    assert sketch.main([f"in={d / 'g1.fa'}", f"out={d / 'g1.sketch'}",
                        "size=500"]) == 0
    (d / "nodes.dmp").write_text(NODES)
    (d / "names.dmp").write_text(NAMES)
    assert taxonomy.taxtree_build([str(d / "names.dmp"),
                                   str(d / "nodes.dmp"),
                                   str(d / "tree.taxtree.gz")]) == 0
    (d / "gi.dmp").write_text("100\t562\n200\t1385\n300\t1224\n400\t2\n")
    assert taxonomy.gitable([str(d / "gi.dmp"),
                             str(d / "gitable.npz")]) == 0
    write_fa(d / "tax.fa", [
        ("tid|1385|bac", b"AAAA"), ("tid|562|eco something", b"CCCC"),
        ("tid|1224|proteo", b"GGGG"), ("tid|20|arch", b"TTTT"),
        ("noid", b"ACGT")])
    write_fa(d / "gi.fa", [("gi|100|ecoli", b"ACGT"),
                           ("gi|999|unknown", b"GGGG"),
                           ("gi|300|proteo", b"TTTT")])
    (d / "gis.txt").write_text("setA\t100,200\nsetB\t100,300\n"
                               "setC\t400\n")
    return d


NODES = """1\t|\t1\t|\tno rank\t|
2\t|\t131567\t|\tsuperkingdom\t|
131567\t|\t1\t|\tno rank\t|
1224\t|\t2\t|\tphylum\t|
1236\t|\t1224\t|\tclass\t|
562\t|\t1236\t|\tspecies\t|
1239\t|\t2\t|\tphylum\t|
1385\t|\t1239\t|\torder\t|
20\t|\t1\t|\tsuperkingdom\t|
"""
NAMES = """1\t|\troot\t|\t\t|\tscientific name\t|
2\t|\tBacteria\t|\t\t|\tscientific name\t|
131567\t|\tcellular organisms\t|\t\t|\tscientific name\t|
1224\t|\tProteobacteria\t|\t\t|\tscientific name\t|
1236\t|\tGammaproteobacteria\t|\t\t|\tscientific name\t|
562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|
1239\t|\tFirmicutes\t|\t\t|\tscientific name\t|
1385\t|\tBacillales\t|\t\t|\tscientific name\t|
"""

CASES = {
    # slice b: format, statistics and SAM tools
    "reformat fasta": ("reformat", ["in={d}/reads.fq", "out={o}/r.fa"]),
    "reformat qtrim": ("reformat", [
        "in={d}/reads.fq", "out={o}/t.fq", "qtrim=rl", "trimq=20",
        "minlen=50", "ftl=2", "ftr=95"]),
    "reformat sample": ("reformat", [
        "in={d}/reads.fq", "out={o}/s.fq.gz", "samplerate=0.3",
        "sampleseed=7"]),
    "reformat pairs": ("reformat", [
        "in={d}/r1.fq", "in2={d}/r2.fq", "out={o}/i.fq", "vpair=t",
        "rc=t"]),
    "reformat interleaved": ("reformat", [
        "in={d}/inter.fq", "int=t", "out={o}/a.fq", "out2={o}/b.fa",
        "reads=30", "tuc=t", "maxlen=60"]),
    "stats": ("stats", ["in={d}/asm.fa"]),
    "stats gc": ("stats", ["{d}/asm.fa", "gc"]),
    "comparesam": ("comparesam", [
        "in1={d}/map.sam", "in2={d}/map2.sam", "out={o}/diff.sam"]),
    "samtoroc": ("samtoroc", ["in={d}/map.sam"]),
    "samtoroc thresh": ("samtoroc", ["{d}/map.sam", "thresh=5"]),
    "calctruequality": ("calctruequality", [
        "in={d}/map.sam", "out={o}/tq.txt"]),
    # slice c: k-mer sketches, clumping and clustering
    "clumpify": ("clumpify", ["in={d}/reads.fq", "out={o}/c.fq"]),
    "clumpify groups dedupe": ("clumpify", [
        "in={d}/reads.fq", "out={o}/c.fq.gz", "dedupe=t", "groups=3",
        "k=21"]),
    "loglog": ("loglog", ["in={d}/reads.fq"]),
    "loglog k": ("loglog", ["{d}/reads.fq", "k=25"]),
    "sketch": ("sketch", ["in={d}/g1.fa", "out={o}/g1.sketch",
                          "size=500"]),
    "comparesketch": ("comparesketch", [
        "in={d}/g2.fa", "ref={d}/g1.fa,{d}/g3.fa,{d}/g1.sketch",
        "size=500"]),
    "bbcountunique": ("bbcountunique", [
        "in={d}/reads.fq", "out={o}/u.txt", "interval=50", "k=21"]),
    "reclusterbykmer": ("reclusterbykmer", [
        "in={d}/clusters.fq", "out={o}/o.fq", "k=15", "mincsim=0.2"]),
    "reclusterbykmer pattern": ("reclusterbykmer", [
        "in={d}/clusters.fq", "pattern={o}/c_%.fq"]),
    # slice d: alignment small tools
    "idmatrix": ("idmatrix", ["in={d}/ids.fa", "out={o}/m.tsv"]),
    "idmatrix percent": ("idmatrix", [
        "in={d}/ids.fa", "out={o}/m.tsv", "percent=t", "edits=4"]),
    "idtree": ("idtree", ["in={d}/mat.tsv", "out={o}/t.nwk"]),
    "msa": ("msa", ["in={d}/primers.fa", "out={o}/p.sam",
                    "literal=ACGTACGT,GGATCCAT"]),
    "cutprimers": ("cutprimers", [
        "in={d}/primers.fa", "out={o}/cut.fa", "sam1={d}/p1.sam",
        "sam2={d}/p2.sam"]),
    "cutprimers include": ("cutprimers", [
        "in={d}/primers.fa", "out={o}/cut.fa", "sam1={d}/p1.sam",
        "sam2={d}/p2.sam", "include=t", "fake=f"]),
    "commonkmers": ("commonkmers", [
        "in={d}/ids.fa", "k=3", "display=2", "count=t"]),
    "commonkmers out": ("commonkmers", [
        "in={d}/ids.fa", "out={o}/ck.txt", "k=4"]),
    "removesmartbell": ("removesmartbell", [
        "in={d}/pb.fq", "out={o}/split.fq"]),
    "removesmartbell unsplit": ("removesmartbell", [
        "in={d}/pb.fq", "out={o}/split.fa", "split=f", "minlen=100",
        "edits=2"]),
    # slice a: the taxonomy suite
    "printtaxonomy": ("printtaxonomy", [
        "nodes={d}/nodes.dmp", "names={d}/names.dmp", "id=562"]),
    "taxonomy": ("taxonomy", [
        "tree={d}/tree.taxtree.gz", "name=Escherichia coli"]),
    "findancestor": ("findancestor", [
        "nodes={d}/nodes.dmp", "names={d}/names.dmp", "ids=562,1385"]),
    "filterbytaxa": ("filterbytaxa", [
        "nodes={d}/nodes.dmp", "in={d}/tax.fa", "out={o}/f.fa",
        "taxa=1224"]),
    "filterbytaxa exclude": ("filterbytaxa", [
        "tree={d}/tree.taxtree.gz", "in={d}/tax.fa", "out={o}/f.fa",
        "taxa=2", "include=f"]),
    "taxtree": ("taxtree", [
        "{d}/names.dmp", "{d}/nodes.dmp", "{o}/tree.taxtree.gz"]),
    "gitable": ("gitable", ["{d}/gi.dmp", "{o}/gitable.npz"]),
    "gi2taxid": ("gi2taxid", [
        "in={d}/gi.fa", "out={o}/out.fa", "table={d}/gitable.npz"]),
    "gi2ancestors": ("gi2ancestors", [
        "in={d}/gis.txt", "out={o}/anc.txt", "table={d}/gitable.npz",
        "tree={d}/tree.taxtree.gz"]),
    "sortbytaxa": ("sortbytaxa", [
        "in={d}/tax.fa", "out={o}/s.fa", "tree={d}/tree.taxtree.gz"]),
    "splitbytaxa": ("splitbytaxa", [
        "in={d}/tax.fa", "out={o}/grp_%.fa", "level=phylum",
        "tree={d}/tree.taxtree.gz"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_byte_equal(corpus, tmp_path, monkeypatch, case):
    tool, template = CASES[case]
    compare(tmp_path, monkeypatch, corpus, tool, template)


def test_reformat_hosts_is_refused(corpus, tmp_path, monkeypatch):
    """reformat hosts=2 exits 1 with its message and writes nothing: the
    multi-host striping is not in the port yet."""
    rc, out, err = run_cli(monkeypatch, "port", "reformat", [
        f"in={corpus / 'reads.fq'}", f"out={tmp_path / 'o.fq'}", "hosts=2"])
    assert rc == 1 and not out
    assert "reformat: hosts= > 1 (multi-host striping) is not ported yet" \
        in err
    assert not any(tmp_path.iterdir())


def _jax_names():
    names = {n: (m, "main") for n, m in jax_main.TOOLS.items()}
    names.update(jax_main.SUBTOOLS)
    return names


def test_dispatcher_matches_the_jax_one():
    """The port's dispatcher has the JAX dispatcher's 136 names (its TOOLS
    and SUBTOOLS), each on the same module and entry point of the port's
    package, and each resolves to a callable."""
    want = _jax_names()
    assert len(want) == 136
    assert set(port_main.TOOLS) == set(want)
    for name, (module, entry) in port_main.TOOLS.items():
        jmod, jentry = want[name]
        assert module == jmod.replace("bbmap_tpu.", "bbmap_tpu_torch.", 1) \
            and entry == jentry, name
        assert callable(getattr(importlib.import_module(module), entry)), \
            name


def test_every_host_tool_name_has_a_case():
    """The parity files together run every name this slice registered:
    the 95 names the port's dispatcher lacked before."""
    from tests.test_torch_smalltools import CASES as small, UNCOMPARED
    from tests.test_torch_synthtools import CASES as synth
    tools = {t for cases in (CASES, small, synth) for t, _ in cases.values()}
    tools |= set(UNCOMPARED)
    added = {
        "reformat", "stats", "comparesam", "samtoroc", "calctruequality",
        "clumpify", "loglog", "sketch", "comparesketch", "bbcountunique",
        "reclusterbykmer", "idmatrix", "idtree", "msa", "cutprimers",
        "commonkmers", "removesmartbell", "printtaxonomy", "findancestor",
        "filterbytaxa", "taxtree", "gitable", "gi2taxid", "gi2ancestors",
        "sortbytaxa", "splitbytaxa", "taxonomy"}
    for module in ("smalltools", "synth", "barcodes", "sorttools",
                   "callvariants", "misc", "pacbio", "textutils",
                   "liftover"):
        added |= {n for n, (m, _e) in port_main.TOOLS.items()
                  if m.endswith("." + module)}
    assert len(added) == 95
    assert added <= tools
