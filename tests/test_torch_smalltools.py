"""The port's host tools against the JAX package's, second part: the
jgi/driver long tail (``tools/smalltools.py``: countgc ...
dedupebymapping), the text utilities (``tools/textutils.py``, with
``bbgrep``) and ``liftover`` / ``translator``, through both dispatchers'
``main`` in this process on the same seeded inputs, with the harness of
``test_torch_hosttools.py``: equal stdout, equal stderr (less wall times)
and byte-equal output files.

Compared less than whole (``UNCOMPARED``): ``printtime`` prints the time
since the stamp in its file and writes the clock into it, so its case
holds both packages to the same form of output and the same stamp file
name, not to the same numbers.
"""

import re

import numpy as np
import pytest

from tests.test_torch_hosttools import (NAMES, NODES, compare, mutate,
                                        qual, run_cli, seq, write_fa,
                                        write_fq, write_sam)

UNCOMPARED = {"printtime": "prints and stores the clock; compared by form"}

SAM = ("@HD\tVN:1.3\n@SQ\tSN:c\tLN:1000\n"
       "p1\t0\tc\t1\t37\t4M\t*\t0\t0\tACGT\tIIII\tMD:Z:4\n"
       "m1\t16\tc\t5\t37\t4M\t*\t0\t0\tACGT\tIIII\tMD:Z:4\n"
       "u1\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n"
       "sub\t0\tc\t1\t37\t4M\t*\t0\t0\tACGT\tII#I\tMD:Z:2A1\n"
       "sub2\t0\tc\t1\t37\t4M\t*\t0\t0\tACGT\tIIII\tMD:Z:1G2\n"
       "indel\t0\tc\t1\t37\t2M1I1M\t*\t0\t0\tACGT\tIIII\tMD:Z:3\n"
       "d1\t0\tc\t100\t37\t4M\t*\t0\t0\tACGT\t!!!!\n"
       "d2\t0\tc\t100\t37\t4M\t*\t0\t0\tACGT\tIIII\n"
       "d3\t16\tc\t200\t37\t4M\t*\t0\t0\tACGT\tIIII\n")
EST_SAM = (
    "@SQ\tSN:scaf1\tLN:1000\n@SQ\tSN:scaf2\tLN:500\n"
    "est1_part_1\t0\tscaf1\t1\t37\t50M\t*\t0\t0\t" + "A" * 50 + "\t*\n"
    "est1_part_2\t0\tscaf1\t51\t37\t50M\t*\t0\t0\t" + "A" * 50 + "\t*\n"
    "est2\t4\t*\t0\t0\t*\t*\t0\t0\t" + "C" * 40 + "\t*\n"
    "est3_part_1\t0\tscaf1\t200\t37\t20M20S\t*\t0\t0\t" + "G" * 40 + "\t*\n"
    "est3_part_2\t0\tscaf2\t1\t37\t40M\t*\t0\t0\t" + "G" * 40 + "\t*\n"
    "est4\t0\tscaf2\t100\t37\t38M2S\t*\t0\t0\t" + "T" * 40 + "\t*\n")
CHAIN = """chain 1000 chrA 300 + 0 100 chrB 200 + 10 110 1
60\t10\t5
30

chain 900 chrA 300 + 200 260 chrC 120 - 20 80 2
60

"""
MERGE_LOG = """*** bbmerge k=31
real\t0m12.500s
user\t1m2.250s
sys\t0m0.750s
Correct:  98.5\t1970
Incorrect:  1.5\t30
SNR:  17.2
*** flash
real\t1m1.000s
user\t2m0.000s
sys\t0m1.500s
Correct:  95.0\t1900
Incorrect:  5.0\t100
SNR:  12.8
"""
FRAG_LOG = """*** lib1 frag
real\t0m3.250s
Reads Used: \t2000\t(200000 bases)
mapped:  \t98.50%\t1970
Error Rate:  \t1.20%\t2400\tbases
Sub Rate:  \t0.90%\t1800\tbases
*** lib2
real\t0m4.000s
Reads Used: \t1000\t(100000 bases)
Del Rate:  \t0.10%\t100\tbases
Ins Rate:  \t0.20%\t200\tbases
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from bbmap_tpu.tools import taxonomy
    d = tmp_path_factory.mktemp("smalltools")
    rng = np.random.default_rng(7)
    write_fa(d / "a.fa", [("s1", b"GGCC"), ("s2", b"AATT"), ("s3", b"ACGTN"),
                          ("s4 long name", seq(rng, 300)),
                          ("s5", b"acgtnnGGCC" + seq(rng, 40))])
    write_fq(d / "r.fq", [(f"r{i}", seq(rng, 50 + 9 * i),
                           qual(rng, 50 + 9 * i)) for i in range(12)])
    write_fq(d / "r1.fq", [(f"x{i}/1", seq(rng, 30), qual(rng, 30))
                           for i in range(5)])
    write_fq(d / "r2.fq", [(f"x{i}/2", seq(rng, 35), qual(rng, 35))
                           for i in range(5)])
    write_fq(d / "inter.fq", [r for i in range(4) for r in (
        (f"y{i}/1", seq(rng, 20), qual(rng, 20)),
        (f"y{i}/2", seq(rng, 25), qual(rng, 25)))])
    (d / "in.sam").write_text(SAM)
    scafs = [("s1", seq(rng, 3000)), ("s2", seq(rng, 2000))]
    write_sam(d / "map.sam", np.random.default_rng(3), scafs, 120)
    (d / "est.sam").write_text(EST_SAM)
    (d / "t.txt").write_text("".join(f"line {i}\n" for i in range(12)))
    (d / "a.phy").write_text(" 3 8\nseqA ACGT\nseqB TTTT\nseqC GGCA\n\n"
                             "ACGT\nTTTT\nCCCC\n")
    (d / "m1.tsv").write_text("a\t1.0\t0.9\t0.2\nb\t0.9\t1.0\t0.3\n"
                              "c\t0.2\t0.3\t1.0\n")
    (d / "m2.tsv").write_text("#x\ta\tb\tc\na\t1.0\t0.8\t0.1\n"
                              "b\t0.8\t1.0\t0.35\nc\t0.1\t0.35\t1.0\n")
    (d / "cov.txt").write_text(
        "#ID\tAvg_fold\tLength\tRef_GC\tCovered_percent\tPlus_reads\n"
        "a1 otuA\t10.0\t100\t0.5\t50.0\t7\n"
        "a2 otuA\t20.0\t300\t0.5\t100.0\t9\n"
        "b1 otuB\t5.0\t100\t0.4\t10.0\t3\n"
        "c1\t2.5\t250\t0.6\t80.0\t4\n")
    (d / "lib1.txt").write_text("#name\t%unambiguousReads\n"
                                "orgA\t90.0\norgB\t8.0\norgC\t2.0\n")
    (d / "lib2.txt").write_text("#name\t%unambiguousReads\n"
                                "orgB\t60.0\norgA\t40.0\n")
    (d / "seal1.txt").write_text("#Name\tReads\tReadsPct\n"
                                 "refA\t900\t90.0\nrefB\t100\t10.0\n")
    (d / "seal2.txt").write_text("#Name\tPct\tReads\n"
                                 "refC\t5.0\t25\nrefD\t95.0\t475\n")
    write_fa(d / "x.fa", [("r1", b"AAAA"), ("r2", b"ACCA")])
    write_fa(d / "y.fa", [("r1", b"CCCC")])
    write_fa(d / "silva.fa", [
        ("a;Bacteria;E.coli", b"AAAA"), ("b;Bacteria;E.coli", b"CCCC"),
        ("c;Bacteria;B.subtilis", b"GGGG"), ("d;Archaea;M.jannaschii",
                                             b"TTTT")])
    base = seq(rng, 80)
    write_fa(d / "query.fa", [("q1", mutate(rng, base, 2)),
                              ("q2", seq(rng, 80)),
                              ("q3", base[:60] + seq(rng, 20))])
    write_fa(d / "est_ref.fa", [("t1", base), ("t2", seq(rng, 90))])
    (d / "xb1.txt").write_text("#name\tdepth\tremoved\tlength\n"
                               "c1\t3.0\t0\t1200\nc2\t0.1\t1\t400\n"
                               "c3\t9.0\t0\t800\n")
    (d / "xb2.txt").write_text("c9\t0.0\t1\t100\n")
    (d / "merge.log").write_text(MERGE_LOG)
    (d / "frag.log").write_text(FRAG_LOG)
    (d / "nodes.dmp").write_text(NODES)
    (d / "names.dmp").write_text(NAMES)
    assert taxonomy.taxtree_build([str(d / "names.dmp"),
                                   str(d / "nodes.dmp"),
                                   str(d / "tree.taxtree.gz")]) == 0
    (d / "assembly_summary.txt").write_text(
        "# assembly_accession\tbioproject\tbiosample\twgs\tcat\tref\ttaxid\n"
        "GCF_1\tp\tb\tw\tc\tr\t562\n"
        "GCF_2\tp\tb\tw\tc\tr\t1385\n"
        "GCF_3\tp\tb\tw\tc\tr\tnotanumber\n"
        "GCF_4\tp\tb\tw\tc\tr\t1236\n"
        "short\tline\n")
    (d / "a.txt").write_text("one\ntwo\nthree\nTwo\n")
    (d / "b.txt").write_text("two\nfour\nthree\n")
    (d / "headers.txt").write_text("@h_a\n>h_b\n\nh_c\n")
    (d / "rename.tsv").write_text("r1\tfirst\nr3\tthird\nbad line\n")
    (d / "a.chain").write_text(CHAIN)
    (d / "in.bed").write_text("chrA\t5\t15\tx\nchrA\t75\t85\tseg2\n"
                              "chrA\t150\t160\tgap\nchrA\t210\t220\tminus\n"
                              "chrZ\t1\t5\tnochain\n")
    (d / "pos.txt").write_text("chrA\t0\nchrA\t205\nchrA\t120\n")
    return d


CASES = {
    # the jgi/driver long tail (tools/smalltools.py)
    "countgc": ("countgc", ["in={d}/a.fa", "out={o}/gc.txt", "format=4"]),
    "countgc stdout": ("countgc", ["in={d}/a.fa"]),
    "countgc format 2": ("countgc", ["in={d}/r.fq", "out={o}/gc.txt",
                                     "format=2"]),
    "readlength": ("readlength", ["in={d}/r.fq", "out={o}/lh.txt",
                                  "bin=10"]),
    "readlength pairs": ("readlength", [
        "in={d}/r1.fq", "in2={d}/r2.fq", "out={o}/lh.txt", "bin=3",
        "round=t", "nzo=t", "max=40"]),
    "fuse": ("fuse", ["in={d}/a.fa", "out={o}/f.fa", "pad=3",
                      "name=joined"]),
    "fuse pairs": ("fuse", ["in={d}/inter.fq", "out={o}/f.fq", "pad=5",
                            "fusepairs=t", "q=20"]),
    "getreads": ("getreads", ["in={d}/r.fq", "id=0,7-9,3",
                              "out={o}/g.fq"]),
    "splitsam": ("splitsam", ["{d}/in.sam", "{o}/p.sam", "{o}/m.sam",
                              "{o}/u.sam", "header"]),
    "splitsam named": ("splitsam", ["in={d}/in.sam", "plus={o}/p.sam",
                                    "minus={o}/m.sam"]),
    "rename": ("rename", ["in={d}/r.fq", "out={o}/rn.fq",
                          "prefix=sample"]),
    "rename pairs": ("rename", ["in={d}/r1.fq", "in2={d}/r2.fq",
                                "out={o}/a.fq", "out2={o}/b.fq"]),
    "testformat": ("testformat", ["{d}/r.fq", "{d}/inter.fq",
                                  "in={d}/a.fa"]),
    "textfile": ("textfile", ["{d}/t.txt", "2", "5"]),
    "phylip2fasta": ("phylip2fasta", ["in={d}/a.phy", "out={o}/a.fa"]),
    "matrixtocolumns": ("matrixtocolumns", [
        "in1={d}/m1.tsv", "in2={d}/m2.tsv", "out={o}/cols.txt"]),
    "mergeotus": ("mergeotus", ["in={d}/cov.txt", "out={o}/m.txt"]),
    "summarizescafstats": ("summarizescafstats", [
        "in={d}/lib1.txt,{d}/lib2.txt", "out={o}/sum.txt"]),
    "summarizeseal": ("summarizeseal", [
        "in={d}/seal1.txt,{d}/seal2.txt", "out={o}/seal.txt"]),
    "summarizeseal stdout": ("summarizeseal", ["{d}/seal1.txt"]),
    "muxbyname": ("muxbyname", ["in={d}/x.fa,{d}/y.fa",
                                "out={o}/mux.fa"]),
    "filtersubs": ("filtersubs", ["in={d}/in.sam", "out={o}/f.sam",
                                  "minq=30", "maxq=99", "countindels=f"]),
    "filtersubs keepperfect": ("filtersubs", [
        "in={d}/map.sam", "out={o}/f.sam", "minq=0", "maxq=30",
        "countindels=t", "keepperfect=t"]),
    "reducesilva": ("reducesilva", ["in={d}/silva.fa", "out={o}/r.fa",
                                    "column=0"]),
    "reducesilva column 1": ("reducesilva", ["in={d}/silva.fa",
                                             "out={o}/r.fa"]),
    "estherfilter": ("estherfilter", ["{d}/query.fa", "{d}/est_ref.fa",
                                      "140"]),
    "estherfilter fasta": ("estherfilter", ["{d}/query.fa",
                                            "{d}/est_ref.fa", "60",
                                            "fasta"]),
    "bbest": ("bbest", ["in={d}/est.sam", "out={o}/stats.txt"]),
    "summarizecrossblock": ("summarizecrossblock", [
        "in={d}/xb1.txt,{d}/xb2.txt", "out={o}/xb.txt"]),
    "summarizemerge": ("summarizemerge", ["in={d}/merge.log"]),
    "processfrag": ("processfrag", ["{d}/frag.log"]),
    "processfrag sym": ("processfrag", ["in={d}/frag.log", "sym=,"]),
    "filterassemblysummary": ("filterassemblysummary", [
        "in={d}/assembly_summary.txt", "out={o}/f.txt",
        "tree={d}/tree.taxtree.gz", "ids=1224"]),
    "filterassemblysummary exclude": ("filterassemblysummary", [
        "in={d}/assembly_summary.txt", "out={o}/f.txt",
        "nodes={d}/nodes.dmp", "ids=1224", "include=f"]),
    "dedupebymapping": ("dedupebymapping", ["in={d}/in.sam",
                                            "out={o}/out.sam"]),
    "dedupebymapping mapped only": ("dedupebymapping", [
        "in={d}/map.sam", "out={o}/out.sam", "keepunmapped=f"]),
    # driver/ text utilities (tools/textutils.py)
    "concatenatetextfiles": ("concatenatetextfiles", [
        "in={d}/a.txt,{d}/b.txt", "out={o}/c.txt"]),
    "filterlines": ("filterlines", ["in={d}/a.txt", "out={o}/f.txt",
                                    "names=two", "include=f"]),
    "filterlines case prefix": ("filterlines", [
        "in={d}/a.txt", "out={o}/f.txt", "names=tw,th", "include=t",
        "case=f", "prefix=t"]),
    "countsharedlines": ("countsharedlines", ["in1={d}/a.txt",
                                              "in2={d}/b.txt"]),
    "replaceheaders": ("replaceheaders", ["in={d}/r.fq", "out={o}/rh.fq",
                                          "prefix=read_"]),
    "replaceheaders hin": ("replaceheaders", [
        "in={d}/a.fa", "out={o}/rh.fa", "hin={d}/headers.txt"]),
    "statswrapper": ("statswrapper", ["in={d}/a.fa,{d}/query.fa"]),
    "bbgrep": ("bbgrep", ["{d}/a.txt", "pattern=^t"]),
    "bbgrep invert": ("bbgrep", ["in={d}/t.txt", "regex=line [13]",
                                 "out={o}/g.txt", "invert=t"]),
    "linecount": ("linecount", ["{d}/a.txt", "{d}/t.txt"]),
    "renamebyheader": ("renamebyheader", [
        "in={d}/r.fq", "out={o}/n.fq", "names={d}/rename.tsv"]),
    "renamebyheader prefix": ("renamebyheader", [
        "in={d}/a.fa", "out={o}/n.fa", "prefix=lib1_"]),
    # liftover / translator
    "liftover bed": ("liftover", ["chain={d}/a.chain", "in={d}/in.bed",
                                  "out={o}/out.bed",
                                  "unmapped={o}/un.bed"]),
    "translator positions": ("translator", [
        "chain={d}/a.chain", "in={d}/pos.txt", "out={o}/out.txt"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_byte_equal(corpus, tmp_path, monkeypatch, case):
    tool, template = CASES[case]
    compare(tmp_path, monkeypatch, corpus, tool, template)


def test_printtime_form(tmp_path, monkeypatch):
    """printtime on an old stamp: both print one ``Elapsed`` line
    of the same form, and both rewrite the stamp with a clock in ms."""
    seen = {}
    for side in ("port", "jax"):
        stamp = tmp_path / f"{side}.stamp"
        stamp.write_text("1000")
        rc, out, err = run_cli(monkeypatch, side, "printtime",
                               [str(stamp)])
        assert rc == 0 and not err
        assert re.fullmatch(r"Elapsed:\t\d+\.\d{3} s\n", out), out
        assert re.fullmatch(r"\d{13}", stamp.read_text())
        seen[side] = float(out.split("\t")[1].split()[0])
    assert abs(seen["port"] - seen["jax"]) < 60
