"""The port's host tools against the JAX package's, third part: the
synthetic-data tools (``tools/synth.py``, with ``bbfakereads`` and
``mutate``), the barcode tools, ``sortsam`` / ``sortbyname`` /
``grademerge``, ``callvariants`` / ``applyvariants``, the misc tools
(``shuffle``, ``partition``, ``translate6frames``, ``kcompress``,
``filterbysequence`` and ``bbwrap``) and the PacBio site-stack pipeline
(``tools/pacbio.py``), through both dispatchers' ``main`` in this process
on the same seeded inputs, with the harness of ``test_torch_hosttools.py``:
equal stdout, equal stderr (less wall times) and byte-equal output files.

Every draw is seeded (``seed=`` of the synth tools and of ``shuffle``).
``bbwrap`` is the one case that maps reads: two single-end inputs on a
30 kbp reference, the port's side with ``device=cpu``, and with
``nodisk`` so that neither package loads the index the other wrote.
"""

import numpy as np
import pytest

from tests.test_torch_hosttools import (compare, mutate, qual, rc, seq,
                                        write_fa, write_fq, write_sam)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from bbmap_tpu.tools import callvariants, pacbio, synth
    d = tmp_path_factory.mktemp("synthtools")
    rng = np.random.default_rng(11)
    g = seq(rng, 6000)
    scafs = [("s1", g[:3000]), ("s2", g[3000:])]
    write_fa(d / "g.fa", scafs)
    write_fa(d / "contigs.fa", [
        ("c1", seq(rng, 900)), ("c2", seq(rng, 300)),
        ("c3", seq(rng, 120) + b"NNNNNNNNNN" + seq(rng, 200) + b"nn"),
        ("c4", seq(rng, 1500))])
    reads = []
    for i in range(60):
        p = int(rng.integers(0, len(g) - 100))
        reads.append((f"r{i}", mutate(rng, g[p:p + 100], i % 3),
                      qual(rng, 100)))
    write_fq(d / "reads.fq", reads)
    write_fa(d / "reads.fa", [(n, s) for n, s, _ in reads[:20]])
    write_fa(d / "motifs.fa", [("m1", reads[2][1][10:22]),
                               ("m2", reads[5][1][40:52].lower()),
                               ("m3", rc(reads[7][1][30:42]))])
    write_fq(d / "r2.fq", [(f"r{i}", rc(s), q[::-1])
                           for i, (_n, s, q) in enumerate(reads)])
    write_fq(d / "trimmed.fq", [
        (f"t{i}_adapter{70 - i % 2}", seq(rng, 70), b"I" * 70)
        for i in range(8)] + [("plain", seq(rng, 50), b"I" * 50)])
    merged = []
    for i in range(16):
        ins = int(rng.integers(120, 181))
        got = ins if i % 5 else ins - 3
        merged.append((f"{i}_chr1_0_{i * 10}_{i * 10 + 99} insert={ins}",
                       seq(rng, got), qual(rng, got)))
    merged.append(("7_chr1_0_100_299", seq(rng, 200), qual(rng, 200)))
    merged.append(("9_chr1_1_100_299", seq(rng, 150), qual(rng, 150)))
    write_fq(d / "merged.fq", merged)
    write_sam(d / "map.sam", np.random.default_rng(2), scafs, 200)
    assert callvariants.main([f"in={d / 'map.sam'}", f"ref={d / 'g.fa'}",
                              f"out={d / 'vars.txt'}"]) == 0
    # barcodes (reference: jgi/CountBarcodes.java and kin)
    write_fq(d / "codes.fq", [
        (f"read{i}:{code}", b"ACGT", b"IIII") for i, code in enumerate(
            ["ACGTAC", "ACGTAC", "ACGTAA", "NNGTAC", "TTGTAC", "ACGTAC"])])
    (d / "expected.txt").write_text("ACGTAC\nTTTTTT\n")
    write_fq(d / "badcodes.fq", [
        ("a:ACGT", b"AAAA", b"IIII"), ("b:AC+T", b"AAAA", b"IIII"),
        ("c:ANGT", b"AAAA", b"IIII"), ("d", b"AAAA", b"IIII")])
    write_fq(d / "bar.fq", [("r0", b"ACGTAC", b"IIIIII"),
                            ("r1", b"TTTTTT", b"######"),
                            ("r2", b"GGCCAA", b"IIII##")])
    write_fq(d / "plain.fq", [("r0", b"AAAACCCC", b"IIIIIIII"),
                              ("r1", b"GGGGTTTT", b"IIIIIIII"),
                              ("r2", b"ACACACAC", b"IIIIIIII")])
    write_fq(d / "barmerged.fq", [
        ("ACGTAC_IIIIII_r0", b"AAAACCCC", b"IIIIIIII"),
        ("TTTTTT_######_r1", b"GGGGTTTT", b"IIIIIIII"),
        ("GGCCAA_IIII##_r2", b"ACACACAC", b"IIIIIIII")])
    # sort and pacbio inputs
    (d / "unsorted.sam").write_text(
        "@HD\tVN:1.4\n@SQ\tSN:a\tLN:100\n@SQ\tSN:b\tLN:100\n"
        "r2\t0\tb\t5\t40\t10=\t*\t0\t0\tAAAAAAAAAA\tIIIIIIIIII\n"
        "r1\t0\ta\t50\t40\t10=\t*\t0\t0\tAAAAAAAAAA\tIIIIIIIIII\n"
        "u\t4\t*\t0\t0\t*\t*\t0\t0\tAAAAAAAAAA\tIIIIIIIIII\n"
        "r0\t0\ta\t10\t40\t10=\t*\t0\t0\tAAAAAAAAAA\tIIIIIIIIII\n"
        "r3\t16\tb\t5\t40\t10=\t*\t0\t0\tAAAAAAAAAA\tIIIIIIIIII\n")
    lines = ["@HD\tVN:1.4", "@SQ\tSN:s1\tLN:1000"]
    for i in range(10):
        lines.append(f"r{i}\t0\ts1\t{1 + 7 * (i % 4)}\t40\t50M\t*\t0\t0\t"
                     + "A" * 50 + "\t" + "I" * 50)
    lines.append("u1\t4\t*\t0\t0\t*\t*\t0\t0\tAAAA\tIIII")
    (d / "stack.sam").write_text("\n".join(lines) + "\n")
    assert pacbio.stacksites_main([f"in={d / 'stack.sam'}",
                                   f"out={d / 'sites.txt'}"]) == 0
    with open(d / "sites.txt") as fh:
        rows = fh.readlines()
    head = [r for r in rows if r.startswith("#")]
    body = [r for r in rows if not r.startswith("#")]
    (d / "shuffled_sites.txt").write_text(
        "".join(head + body[::-1] + ["s0\tx\n"]))
    (d / "covstats.txt").write_text(
        "#ID\tAvg_fold\tLength\tCovered_percent\n"
        "c1\t5.0\t900\t100.0\nc2\t1.0\t300\t100.0\nc3\t8.0\t332\t90.0\n"
        "c4\t2.0\t1500\t100.0\n")
    assert synth.shred([f"in={d / 'g.fa'}", f"out={d / 'shreds.fa'}",
                        "length=700", "overlap=100"]) == 0
    # bbwrap: test_torch_cli.py's reference and reads, single-end
    rb = np.random.default_rng(1)
    B = np.frombuffer(b"ACGT", np.uint8)
    gw = rb.choice(B, 30000).astype(np.uint8)
    write_fa(d / "wrap_ref.fa", [("chr1", bytes(gw[:20000])),
                                 ("chr2", bytes(gw[20000:]))])
    wr = []
    for i in range(48):
        s = int(rb.integers(0, 19000 - 300))
        r1 = gw[s:s + 100].copy()
        if i % 3 == 0:
            r1[rb.integers(0, 100)] = ord("A")
        if i % 7 == 0:
            r1 = np.concatenate([r1[:60], B[:2], r1[60:98]])
        s1 = bytes(r1) if i % 2 else rc(bytes(r1))
        wr.append((f"w{i}", s1, qual(rb, 100, 12, 40)))
    write_fq(d / "wa.fq", wr[:24])
    write_fq(d / "wb.fq", wr[24:])
    return d


CASES = {
    # synthetic data (tools/synth.py)
    "mutategenome": ("mutategenome", ["in={d}/g.fa", "out={o}/m.fa",
                                      "subrate=0.02", "seed=1"]),
    "mutate indels": ("mutate", ["in={d}/g.fa", "out={o}/m.fa",
                                 "subrate=0.01", "indelrate=0.005",
                                 "seed=4"]),
    "shred": ("shred", ["in={d}/g.fa", "out={o}/s.fa", "length=500"]),
    "shred overlap": ("shred", ["in={d}/contigs.fa", "out={o}/s.fa",
                                "length=250", "overlap=50"]),
    "makechimeras": ("makechimeras", ["in={d}/reads.fq", "out={o}/ch.fa",
                                      "readsout=25", "seed=3"]),
    "addadapters": ("addadapters", ["in={d}/reads.fq", "out={o}/ad.fq",
                                    "rate=0.5", "seed=2"]),
    "addadapters grade": ("addadapters", ["in={d}/trimmed.fq", "grade=t"]),
    "fakereads": ("fakereads", ["in={d}/contigs.fa", "out={o}/f1.fq",
                                "out2={o}/f2.fq", "length=150"]),
    "bbfakereads": ("bbfakereads", ["in={d}/shreds.fa", "out={o}/f.fq",
                                    "length=100"]),
    "synthmda": ("synthmda", ["ref={d}/g.fa", "out={o}/amp.fa",
                              "cycles=3", "minlen=300", "length=1200",
                              "seed=3"]),
    "fungalrelease": ("fungalrelease", ["in={d}/contigs.fa",
                                        "out={o}/rel.fa", "minlen=250",
                                        "rename=t"]),
    "fungalrelease unsorted": ("fungalrelease", [
        "in={d}/shreds.fa", "out={o}/rel.fa", "sort=f", "prefix=ctg_"]),
    # barcodes
    "countbarcodes": ("countbarcodes", ["in={d}/codes.fq",
                                        "out={o}/counts.txt",
                                        "expected=ACGTAC"]),
    "countbarcodes valid file": ("countbarcodes", [
        "in={d}/codes.fq", "out={o}/counts.txt",
        "valid={d}/expected.txt", "countundefined=f", "printheader=f"]),
    "removebadbarcodes": ("removebadbarcodes", ["in={d}/badcodes.fq",
                                                "out={o}/out.fq"]),
    "mergebarcodes": ("mergebarcodes", ["in={d}/plain.fq", "bar={d}/bar.fq",
                                        "out={o}/merged.fq"]),
    "filterbarcodes": ("filterbarcodes", [
        "in={d}/barmerged.fq", "out={o}/filt.fq", "maq=20",
        "outcor={o}/cor.txt"]),
    "correlatebarcodes": ("correlatebarcodes", [
        "in={d}/barmerged.fq", "out={o}/filt.fq", "minq=5",
        "aqhist={o}/aq.txt", "mqhist={o}/mq.txt"]),
    # sorting, variants and the misc tools
    "sortsam": ("sortsam", ["in={d}/unsorted.sam", "out={o}/s.sam"]),
    "sortsam spill": ("sortsam", ["in={d}/map.sam", "out={o}/s.sam",
                                  "records=37"]),
    "sortbyname": ("sortbyname", ["in={d}/reads.fq", "out={o}/s.fq"]),
    "sortbyname spill": ("sortbyname", ["in={d}/reads.fa", "out={o}/s.fa",
                                        "records=6"]),
    "grademerge": ("grademerge", ["in={d}/merged.fq"]),
    "callvariants": ("callvariants", ["in={d}/map.sam", "ref={d}/g.fa",
                                      "out={o}/vars.txt"]),
    "callvariants loose": ("callvariants", [
        "in={d}/map.sam", "ref={d}/g.fa", "out={o}/vars.txt", "mincov=1",
        "maf=0.2"]),
    "applyvariants": ("applyvariants", ["ref={d}/g.fa", "vars={d}/vars.txt",
                                        "out={o}/mut.fa"]),
    "shuffle": ("shuffle", ["in={d}/reads.fq", "out={o}/sh.fq", "seed=5"]),
    "shuffle fasta": ("shuffle", ["in={d}/reads.fa", "out={o}/sh.fa",
                                  "seed=9"]),
    "partition": ("partition", ["in={d}/reads.fq", "out={o}/part_%.fq",
                                "ways=3"]),
    "translate6frames": ("translate6frames", ["in={d}/contigs.fa",
                                              "out={o}/aa.fa"]),
    "translate6frames 3": ("translate6frames", ["in={d}/reads.fa",
                                                "out={o}/aa.fa",
                                                "frames=3"]),
    "kcompress": ("kcompress", ["in={d}/reads.fq", "out={o}/kc.fa",
                                "k=31"]),
    "kcompress min": ("kcompress", ["in={d}/shreds.fa", "out={o}/kc.fa",
                                    "k=21", "min=1"]),
    "filterbysequence": ("filterbysequence", [
        "in={d}/badcodes.fq", "out={o}/kept.fq", "ref=AAAA",
        "include=t"]),
    "filterbysequence contains": ("filterbysequence", [
        "in={d}/reads.fa", "out={o}/m.fa", "outu={o}/u.fa",
        "ref={d}/motifs.fa", "contains=t", "include=t"]),
    "bbwrap": ("bbwrap", ["ref={d}/wrap_ref.fa", "in={d}/wa.fq,{d}/wb.fq",
                          "out={o}/a.sam,{o}/b.sam", "nodisk"]),
    # the PacBio site-stack pipeline (tools/pacbio.py)
    "stacksites": ("stacksites", ["in={d}/stack.sam", "out={o}/sites.txt"]),
    "calccoveragefromsites": ("calccoveragefromsites", [
        "in={d}/sites.txt", "out={o}/cov.txt", "binsize=20"]),
    "processstackedsites": ("processstackedsites", [
        "in={d}/sites.txt", "out={o}/norm.txt", "target=3"]),
    "mergefastacontigs": ("mergefastacontigs", [
        "in={d}/contigs.fa", "out={o}/m.fa", "npad=5",
        "outlist={o}/locs.txt"]),
    "mergefastacontigs maxlen": ("mergefastacontigs", [
        "in={d}/shreds.fa", "out={o}/m.fa", "maxlen=2000"]),
    "partitionreads": ("partitionreads", ["in={d}/reads.fq",
                                          "out={o}/p_#.fq",
                                          "partitions=3"]),
    "partitionreads pairs": ("partitionreads", [
        "in={d}/reads.fq", "in2={d}/r2.fq", "out={o}/a_#.fq",
        "out2={o}/b_#.fq"]),
    "partitionfastafile": ("partitionfastafile", [
        "in={d}/contigs.fa", "out={o}/part_#.fa", "partition=1000"]),
    "removenfromchromosome": ("removenfromchromosome", [
        "in={d}/contigs.fa", "out={o}/noN.fa", "table={o}/ns.txt"]),
    "sortsites": ("sortsites", ["in={d}/shuffled_sites.txt",
                                "out={o}/sorted.txt"]),
    "splitoffperfectcontigs": ("splitoffperfectcontigs", [
        "in={d}/contigs.fa", "cov={d}/covstats.txt", "out={o}/perfect.fa",
        "outb={o}/rest.fa"]),
    "splitoffperfectcontigs cutoff": ("splitoffperfectcontigs", [
        "in={d}/contigs.fa", "cov={d}/covstats.txt", "out={o}/perfect.fa",
        "cutoff=1"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_byte_equal(corpus, tmp_path, monkeypatch, case):
    tool, template = CASES[case]
    out, files = compare(tmp_path, monkeypatch, corpus, tool, template)
    if tool == "bbwrap":
        body = [ln for name in ("a.sam", "b.sam")
                for ln in files[name].decode().splitlines()
                if not ln.startswith("@")]
        assert len(body) == 48
        assert sum(ln.split("\t")[1] != "4" for ln in body) >= 40
