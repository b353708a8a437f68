"""Coverage-based QC tools: filterbycoverage, kmercoverage, decontaminate.

reference: jgi/FilterByCoverage.java, jgi/KmerCoverage.java,
jgi/DecontaminateByNormalization.java (SURVEY §2.8 'Coverage-based').

The port's copy of the JAX package's tools: ``device=`` (default cuda)
names the torch device of kmercoverage's counting Bloom filter and of the
bbnorm and bbmap runs inside decontaminate (crossblock) and postfilter.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from ..core.batch import ReadBatch, batched
from ..index.kcount import KCountArray, make_kca
from ..io import fastx
from ..utils.args import Args
from .bbnorm import canonical_kmers, read_depths


def filterbycoverage(argv: List[str]) -> int:
    """Filter contigs by mapped coverage stats (reference:
    jgi/FilterByCoverage.java — reads covstats from pileup)."""
    args = Args.parse(argv)
    inp = args.get("in")
    cov = args.get("cov", "covstats")
    out = args.get("out")
    outd = args.get("outd", "outdirty")
    mincov = args.get_float("mincov", "minc", default=5.0)
    minpercent = args.get_float("minpercent", "minp", default=40.0)
    minlen = args.get_int("minlen", "minl", default=0)
    if None in (inp, cov, out):
        print("Usage: filterbycoverage in=<contigs> cov=<covstats> "
              "out=<clean> [outd=] mincov=5 minpercent=40",
              file=sys.stderr)
        return 1
    stats: Dict[str, tuple] = {}
    with open(cov) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            stats[f[0]] = (float(f[1]), float(f[3]))  # avg_fold, cov%
    kept = removed = 0
    out_fh = fastx.xopen(out, "wb")
    outd_fh = fastx.xopen(outd, "wb") if outd else None
    for rec in fastx.read_seqs(inp):
        avg, pct = stats.get(rec.id, (0.0, 0.0))
        ok = (avg >= mincov and pct >= minpercent
              and len(rec.bases) >= minlen)
        fh = out_fh if ok else outd_fh
        if ok:
            kept += 1
        else:
            removed += 1
        if fh is not None:
            fh.write(b">" + rec.id.encode() + b"\n" + rec.bases + b"\n")
    out_fh.close()
    if outd_fh:
        outd_fh.close()
    sys.stderr.write(f"Kept:\t{kept}\nRemoved:\t{removed}\n")
    return 0


def kmercoverage(argv: List[str]) -> int:
    """Per-read k-mer depth annotation/histogram (reference:
    jgi/KmerCoverage.java + kmercoverage.sh)."""
    args = Args.parse(argv)
    inp = args.get("in", "in1")
    out = args.get("out")
    hist_path = args.get("hist", "khist")
    k = args.get_int("k", default=31)
    cells = args.get_int("cells", default=1 << 26)
    device = args.get("device", default="cuda")
    if inp is None:
        print("Usage: kmercoverage in=<reads> [out=annotated.fq] "
              "[hist=depth.txt]", file=sys.stderr)
        return 1
    kca = make_kca(cells, cell_bits=16, hashes=2, device=device)
    for chunk in batched(fastx.read_seqs(inp), 8192):
        b = ReadBatch.from_records(chunk)
        can, valid = canonical_kmers(b.bases, k)
        if can.shape[1]:
            kca.increment(can[valid])
    hist = np.zeros(10001, np.int64)
    out_fh = fastx.xopen(out, "wb") if out else None
    for chunk in batched(fastx.read_seqs(inp), 8192):
        b = ReadBatch.from_records(chunk)
        depths = read_depths(kca, b.bases, k, 0.5)
        np.add.at(hist, np.clip(depths, 0, 10000), 1)
        if out_fh is not None:
            for rec, d in zip(chunk, depths):
                q = rec.quality if rec.quality is not None \
                    else b"I" * len(rec.bases)
                out_fh.write(b"@" + rec.id.encode()
                             + f";cov={int(d)}".encode() + b"\n"
                             + rec.bases + b"\n+\n" + q + b"\n")
    if out_fh is not None:
        out_fh.close()
    if hist_path:
        with open(hist_path, "w") as fh:
            fh.write("#Depth\tReads\n")
            for d in np.nonzero(hist)[0]:
                fh.write(f"{d}\t{hist[d]}\n")
    return 0


def crosscontaminate(argv: List[str]) -> int:
    """Blend reads between libraries at a given rate to fabricate
    contamination test data (reference: jgi/CrossContaminate.java)."""
    args = Args.parse(argv)
    ins = (args.get("in") or "").split(",")
    outs = (args.get("out") or "").split(",")
    rate = args.get_float("rate", default=0.01)
    seed = args.get_int("seed", default=0)
    if len(ins) < 2 or len(ins) != len(outs):
        print("Usage: crosscontaminate in=a.fq,b.fq out=a2.fq,b2.fq "
              "rate=0.01", file=sys.stderr)
        return 1
    rng = np.random.default_rng(seed)
    libs = [list(fastx.read_seqs(p)) for p in ins]
    for i, out in enumerate(outs):
        recs = []
        for rec in libs[i]:
            if rng.random() < rate and len(libs) > 1:
                j = int(rng.integers(0, len(libs) - 1))
                if j >= i:
                    j += 1
                donor = libs[j]
                recs.append(donor[int(rng.integers(0, len(donor)))])
            else:
                recs.append(rec)
        fastx.write_fastq(out, recs)
    return 0


def decontaminate(argv: List[str]) -> int:
    """Cross-contamination removal across multi-library assemblies
    (reference: jgi/DecontaminateByNormalization.java:258-283 +
    sh/decontaminate.sh). Pipeline per the reference's process():

    1. rename+mux: merge every library's reads, ids prefixed lib_
    2. (ecc=t) tadpole error correction of the pool
    3. bbnorm the pooled reads (target=, mindepth=) — contaminant reads
       are rare in their true library's pool slot, so normalization by
       the POOLED depth suppresses carried-over reads
    4. demux back per library by id prefix
    5. map each library's normalized reads to its own assembly;
       pileup covstats
    6. filterbycoverage each assembly (minc/minp/minl) -> clean/dirty

    reads=/ref= are comma lists (or list files) of equal length, paired
    positionally."""
    import os
    import tempfile

    from . import bbmap as bbmap_tool
    from . import bbnorm as bbnorm_tool
    from . import pileup as pileup_tool

    args = Args.parse(argv)
    reads_arg = args.get("reads", "read", "in")
    ref_arg = args.get("ref", "refs")
    outdir = args.get("outdir", "out", default=".")
    tmpdir = args.get("tmpdir") or tempfile.mkdtemp(prefix="dbn_")
    target = args.get_int("target", default=20)
    mindepth = args.get_int("mindepth", "mind", default=2)
    k = args.get_int("k", default=31)
    minc = args.get_float("minc", default=3.5)
    minp = args.get_float("minp", default=20)
    minl = args.get_int("minl", default=500)
    ecc = args.get_bool("ecc", default=False)
    device = args.get("device", default="cuda")
    if reads_arg is None or ref_arg is None:
        print("Usage: decontaminate reads=<r1.fq,r2.fq,...> "
              "ref=<a1.fa,a2.fa,...> outdir=<dir>", file=sys.stderr)
        return 1

    def expand(val):
        out = []
        for part in val.split(","):
            if os.path.isfile(part) and part.endswith(".txt"):
                with open(part) as fh:
                    out.extend(l.strip() for l in fh if l.strip())
            else:
                out.append(part)
        return out

    read_paths = expand(reads_arg)
    ref_paths = expand(ref_arg)
    if len(read_paths) != len(ref_paths):
        print("decontaminate: reads= and ref= lists must pair up",
              file=sys.stderr)
        return 1
    os.makedirs(outdir, exist_ok=True)
    os.makedirs(tmpdir, exist_ok=True)
    core = [os.path.basename(p).split(".")[0] for p in read_paths]

    # 1. rename + mux (reference: renameAndMux_ST:306-335)
    merged = os.path.join(tmpdir, "merged.fq")
    with fastx.xopen(merged, "wb") as out_fh:
        for c, path in zip(core, read_paths):
            for rec in fastx.read_seqs(path, fake_quality=30):
                out_fh.write(
                    b"@" + c.encode() + b"~" + rec.id.encode() + b"\n"
                    + rec.bases + b"\n+\n"
                    + (rec.quality or b"I" * len(rec.bases)) + b"\n")

    # 2. optional pooled error correction (reference: eccTadpole:451)
    if ecc:
        from . import tadpole as tadpole_tool
        corrected = os.path.join(tmpdir, "corrected.fq")
        if tadpole_tool.main([f"in={merged}", f"out={corrected}",
                              "mode=correct", f"k={min(k, 31)}"]) == 0:
            merged = corrected

    # 3. normalize the pool (reference: normalize:481-507)
    normed = os.path.join(tmpdir, "normalized.fq")
    rc = bbnorm_tool.main([f"in={merged}", f"out={normed}",
                           f"target={target}", f"mindepth={mindepth}",
                           f"k={k}", f"device={device}"])
    if rc != 0:
        return rc

    # 4. demux by library prefix (reference: demux:523-563)
    demuxed = {c: os.path.join(tmpdir, f"{c}_demuxed.fq")
               for c in core}
    handles = {c: fastx.xopen(p, "wb") for c, p in demuxed.items()}
    for rec in fastx.read_seqs(normed, fake_quality=30):
        c, _, rid = rec.id.partition("~")
        fh = handles.get(c)
        if fh is None:
            continue
        fh.write(b"@" + rid.encode() + b"\n" + rec.bases + b"\n+\n"
                 + (rec.quality or b"I" * len(rec.bases)) + b"\n")
    for fh in handles.values():
        fh.close()

    # 5. map + covstats (reference: map:567-609 'covstats=' flag; here
    #    bbmap emits SAM and pileup derives the same covstats table)
    # 6. filterbycoverage (reference: filter:612-668)
    for c, ref in zip(core, ref_paths):
        sam = os.path.join(tmpdir, f"{c}.sam")
        stats1 = os.path.join(outdir, f"{c}_covstats1.txt")
        rc = bbmap_tool.main([f"ref={ref}", f"in={demuxed[c]}",
                              f"out={sam}", "nodisk", f"device={device}"])
        if rc != 0:
            return rc
        rc = pileup_tool.main([f"in={sam}", f"out={stats1}",
                               f"ref={ref}"])
        if rc != 0:
            return rc
        rc = filterbycoverage([
            f"in={ref}", f"cov={stats1}",
            f"out={os.path.join(outdir, c + '_clean.fasta')}",
            f"outd={os.path.join(outdir, c + '_dirty.fasta')}",
            f"minc={minc}", f"minp={minp}", f"minl={minl}"])
        if rc != 0:
            return rc
    sys.stderr.write(f"Decontaminated {len(core)} libraries into "
                     f"{outdir}\n")
    return 0


def postfilter(argv: List[str]) -> int:
    """reference: postfilter.sh (assemble/Postfilter.java) — map reads
    to the assembly, pileup covstats, then drop contigs failing
    minc/minp/minr/minl; trim= trims contig ends first."""
    import os
    import tempfile

    from . import bbmap as bbmap_tool
    from . import pileup as pileup_tool

    args = Args.parse(argv)
    inp = args.get("in", "in1")
    in2 = args.get("in2")
    ref = args.get("ref")
    out = args.get("out", default="filtered.fa")
    outd = args.get("outd", "outdirty")
    cov = args.get("cov", default="covstats.txt")
    minc = args.get_float("minc", "mincov", default=2.0)
    minp = args.get_float("minp", "minpercent", default=95.0)
    minr = args.get_int("minr", "minreads", default=6)
    minl = args.get_int("minl", "minlength", default=400)
    trim = args.get_int("trim", "trimends", default=0)
    device = args.get("device", default="cuda")
    if inp is None or ref is None:
        print("Usage: postfilter in=<reads> ref=<contigs> "
              "out=<filtered>", file=sys.stderr)
        return 1
    tmpdir = tempfile.mkdtemp(prefix="postfilter_")
    ref_use = ref
    if trim > 0:
        ref_use = os.path.join(tmpdir, "trimmed.fa")
        def gen():
            for rec in fastx.read_seqs(ref):
                b = rec.bases[trim:len(rec.bases) - trim]
                if b:
                    yield fastx.SeqRecord(id=rec.id, bases=b)
        fastx.write_fasta(ref_use, gen())
    sam = os.path.join(tmpdir, "mapped.sam")
    margs = [f"ref={ref_use}", f"in={inp}", f"out={sam}", "nodisk",
             "minhits=2", "maxindel=0", "rescue=f", f"device={device}"]
    if in2:
        margs.insert(2, f"in2={in2}")
    rc = bbmap_tool.main(margs)
    if rc != 0:
        return rc
    rc = pileup_tool.main([f"in={sam}", f"out={cov}", "32bit=t"])
    if rc != 0:
        return rc
    # covstats: #ID Avg_fold Length Covered_percent Covered_bases
    #           Plus_reads ... (reference: jgi/CoveragePileup.java)
    stats: Dict[str, tuple] = {}
    with open(cov) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            stats[f[0]] = (float(f[1]), float(f[3]), int(float(f[5])))
    kept = removed = 0
    out_fh = fastx.xopen(out, "wb")
    outd_fh = fastx.xopen(outd, "wb") if outd else None
    for rec in fastx.read_seqs(ref):
        avg, pct, reads = stats.get(rec.id, (0.0, 0.0, 0))
        ok = (avg >= minc and pct >= minp and reads >= minr
              and len(rec.bases) >= minl)
        if ok:
            kept += 1
            out_fh.write(b">" + rec.id.encode() + b"\n" + rec.bases
                         + b"\n")
        else:
            removed += 1
            if outd_fh is not None:
                outd_fh.write(b">" + rec.id.encode() + b"\n"
                              + rec.bases + b"\n")
    out_fh.close()
    if outd_fh:
        outd_fh.close()
    sys.stderr.write(f"Contigs kept:\t{kept}\nContigs removed:\t"
                     f"{removed}\n")
    return 0


TOOLS = dict(filterbycoverage=filterbycoverage,
             decontaminate=decontaminate,
             kmercoverage=kmercoverage,
             crosscontaminate=crosscontaminate,
             postfilter=postfilter)


def main(argv: List[str]) -> int:
    if not argv or argv[0] not in TOOLS:
        print("coverage tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])
