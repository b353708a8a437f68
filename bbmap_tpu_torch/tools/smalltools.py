"""Small single-purpose tools from the reference's jgi/ + driver/ long
tail: countgc, readlength, fuse, getreads, splitsam, rename, testformat,
textfile, printtime, phylip2fasta, matrixtocolumns, mergeotus,
summarizescafstats, summarizeseal, muxbyname, filtersubs, reducesilva,
estherfilter.

reference: jgi/CountGC.java, jgi/MakeLengthHistogram.java,
jgi/FuseSequence.java, jgi/GetReads.java, jgi/SplitSamFile.java,
jgi/RenameReads.java, fileIO/TestFormat (testformat.sh),
fileIO/TextFile.java (textfile.sh), driver/PrintTime.java,
driver/PhylipToFasta.java, driver/MatrixToColumns.java,
driver/MergeCoverageOTU.java, jgi/SummarizeScafStats.java,
driver/SummarizeSealStats.java, jgi/MultiplexByName (muxbyname.sh),
driver/FilterReadsWithSubs.java (filtersubs.sh),
driver/ReduceSilva.java, driver/EstherFilter.java.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from ..io import fastx
from ..utils.args import Args


def _inputs(args: Args):
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    return inp


def _rawpos(argv: List[str]) -> List[str]:
    """All argv tokens without '=' — true positionals (Args.positional
    only keeps existing files, which drops output paths and numbers)."""
    return [a for a in argv if a and "=" not in a
            and not a.startswith("-")]


def countgc(argv: List[str]) -> int:
    """reference: jgi/CountGC.java — per-sequence base composition.
    format=1: name len A C G T N (ACGT as fractions of defined bases);
    format=2: name GC; format=4: name len GC."""
    args = Args.parse(argv)
    inp = _inputs(args)
    out = args.get("out")
    fmt = args.get_int("format", default=1)
    if inp is None:
        print("Usage: countgc in=<input> out=<output> format=<1|2|4>",
              file=sys.stderr)
        return 1
    if fmt not in (1, 2, 4):
        print(f"invalid format {fmt}; must be 1, 2 or 4",
              file=sys.stderr)
        return 1
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    tot = [0] * 5
    tlen = 0
    try:
        for rec in fastx.read_seqs(inp):
            b = rec.bases.upper()
            n = len(b)
            a, c, g, t = (b.count(ch) for ch in (65, 67, 71, 84))
            nn = n - a - c - g - t
            tot[0] += a
            tot[1] += c
            tot[2] += g
            tot[3] += t
            tot[4] += nn
            tlen += n
            d = max(1, a + c + g + t)
            if fmt == 1:
                oh.write(f"{rec.id}\t{n}\t{a / d:.5f}\t{c / d:.5f}\t"
                         f"{g / d:.5f}\t{t / d:.5f}\t{nn / d:.5f}\n")
            elif fmt == 2:
                oh.write(f"{rec.id}\t{(g + c) / d:.5f}\n")
            else:
                oh.write(f"{rec.id}\t{n}\t{(g + c) / d:.5f}\n")
    finally:
        if out:
            oh.close()
    d = max(1, sum(tot[:4]))
    sys.stderr.write(f"Overall GC:\t{(tot[1] + tot[2]) / d:.5f}\n")
    return 0


def readlength(argv: List[str]) -> int:
    """reference: jgi/MakeLengthHistogram.java (readlength.sh) — binned
    read-length histogram with cumulative columns."""
    args = Args.parse(argv)
    inp = _inputs(args)
    in2 = args.get("in2")
    out = args.get("out")
    binsz = args.get_int("bin", default=10)
    maxlen = args.get_int("max", default=80000)
    do_round = args.get_bool("round", default=False)
    nzo = args.get_bool("nzo", "nonzeroonly", default=False)
    max_reads = args.get_int("reads", default=-1)
    if inp is None:
        print("Usage: readlength in=<file> [out=<file>] bin=10",
              file=sys.stderr)
        return 1
    nbins = maxlen // binsz + 1
    hist = [0] * (nbins + 1)
    n_reads = 0
    n_bases = 0
    mn, mx = 1 << 62, 0
    lens: List[int] = []

    def add(L: int):
        nonlocal n_reads, n_bases, mn, mx
        n_reads += 1
        n_bases += L
        mn = min(mn, L)
        mx = max(mx, L)
        lens.append(L)
        if do_round:
            b = (L + binsz // 2) // binsz
        else:
            b = L // binsz
        hist[min(b, nbins)] += 1

    paths = [p for p in (inp, in2) if p]
    for p in paths:
        for rec in fastx.read_seqs(p):
            add(len(rec.bases))
            if 0 <= max_reads <= n_reads:
                break
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    lens.sort()
    med = lens[len(lens) // 2] if lens else 0
    avg = n_bases / max(1, n_reads)
    oh.write(f"#Reads:\t{n_reads}\n#Bases:\t{n_bases}\n"
             f"#Max:\t{mx if n_reads else 0}\n"
             f"#Min:\t{mn if n_reads else 0}\n"
             f"#Avg:\t{avg:.1f}\n#Median:\t{med}\n")
    oh.write("#Length\treads\tpct_reads\tcum_reads\tcum_pct_reads\n")
    cum = 0
    for b, cnt in enumerate(hist):
        if nzo and cnt == 0:
            continue
        cum += cnt
        oh.write(f"{b * binsz}\t{cnt}\t"
                 f"{100.0 * cnt / max(1, n_reads):.3f}\t{cum}\t"
                 f"{100.0 * cum / max(1, n_reads):.3f}\n")
        if cum >= n_reads and b * binsz >= (mx if n_reads else 0):
            break
    if out:
        oh.close()
    return 0


def fuse(argv: List[str]) -> int:
    """reference: jgi/FuseSequence.java — fuse all sequences (or each
    pair, fusepairs=t) into one, padding joins with Ns."""
    args = Args.parse(argv)
    inp = _inputs(args)
    pos = _rawpos(argv)
    out = args.get("out") or (pos[1] if len(pos) > 1 else None)
    pad = args.get_int("pad", default=300)
    qual = args.get_int("quality", "q", default=30)
    fusepairs = args.get_bool("fusepairs", default=False)
    name = args.get("name")
    if inp is None or out is None:
        print("Usage: fuse in=<input> out=<output> pad=<Ns>",
              file=sys.stderr)
        return 1
    recs = fastx.read_seqs(inp)
    if fusepairs:
        def gen():
            it = iter(recs)
            for r1 in it:
                r2 = next(it, None)
                if r2 is None:
                    yield r1
                    break
                bases = r1.bases + b"N" * pad + r2.bases
                q = None
                if r1.quality is not None and r2.quality is not None:
                    q = (r1.quality + bytes([qual + 33]) * pad
                         + r2.quality)
                yield fastx.SeqRecord(id=r1.id, bases=bases, quality=q)
        _write_out(out, gen(), qual)
        return 0
    parts: List[bytes] = []
    first = None
    for rec in recs:
        if first is None:
            first = rec.id
        parts.append(rec.bases)
    bases = (b"N" * pad).join(parts)
    rid = name or first or "fused"
    _write_out(out, [fastx.SeqRecord(id=rid, bases=bases)], qual)
    return 0


def _write_out(out: str, records, fake_q: int = 30) -> None:
    fmt = fastx.sniff_format(out)
    if fmt == "fastq":
        def addq(rs):
            for r in rs:
                if r.quality is None:
                    r.quality = bytes([fake_q + 33]) * len(r.bases)
                yield r
        fastx.write_fastq(out, addq(records))
    else:
        fastx.write_fasta(out, records)


def getreads(argv: List[str]) -> int:
    """reference: jgi/GetReads.java — select reads (pairs) by numeric
    id; id=5,93,17-31,8."""
    args = Args.parse(argv)
    inp = _inputs(args)
    out = args.get("out")
    ids = args.get("id", "ids")
    if inp is None or out is None or ids is None:
        print("Usage: getreads in=<file> id=<n,n,a-b,...> out=<file>",
              file=sys.stderr)
        return 1
    wanted = set()
    for part in ids.split(","):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            wanted.update(range(int(a), int(b) + 1))
        elif part:
            wanted.add(int(part))
    def gen():
        for i, rec in enumerate(fastx.read_seqs(inp)):
            if i in wanted:
                yield rec
    _write_records(out, gen())
    return 0


def _write_records(out: str, records) -> None:
    fmt = fastx.sniff_format(out)
    if fmt == "fastq":
        fastx.write_fastq(out, records)
    else:
        fastx.write_fasta(out, records)


def splitsam(argv: List[str]) -> int:
    """reference: jgi/SplitSamFile.java — split sam into plus/minus/
    unmapped files; positional: in plus minus unmapped [header]."""
    args = Args.parse(argv)
    pos = _rawpos(argv)
    inp = args.get("in") or (pos[0] if pos else None)
    if args.get("in") is None and pos:
        pos = pos[1:]
    plus = args.get("plus") or (pos[0] if len(pos) > 0 else None)
    minus = args.get("minus") or (pos[1] if len(pos) > 1 else None)
    unmapped = args.get("unmapped") or (pos[2] if len(pos) > 2 else None)
    header = args.get_bool("header", default="header" in [
        p.lower() for p in pos])
    if inp is None:
        print("Usage: splitsam <input> <plus> <minus> <unmapped> "
              "[header]", file=sys.stderr)
        return 1
    from ..io.sam import open_sam_lines
    outs = {}
    for key, path in (("plus", plus), ("minus", minus),
                      ("unmapped", unmapped)):
        outs[key] = fastx.xopen(path, "wt") if path else None
    counts = {"plus": 0, "minus": 0, "unmapped": 0}
    try:
        for line in open_sam_lines(inp):
            if line.startswith("@"):
                if header:
                    for oh in outs.values():
                        if oh:
                            oh.write(line if line.endswith("\n")
                                     else line + "\n")
                continue
            f = line.split("\t", 3)
            flag = int(f[1])
            if flag & 4:
                key = "unmapped"
            elif flag & 16:
                key = "minus"
            else:
                key = "plus"
            counts[key] += 1
            oh = outs[key]
            if oh:
                oh.write(line if line.endswith("\n") else line + "\n")
    finally:
        for oh in outs.values():
            if oh:
                oh.close()
    sys.stderr.write(
        f"Plus:\t{counts['plus']}\nMinus:\t{counts['minus']}\n"
        f"Unmapped:\t{counts['unmapped']}\n")
    return 0


def rename(argv: List[str]) -> int:
    """reference: jgi/RenameReads.java — rename reads to
    <prefix>_<number> (pairs share the number, suffixed ' 1:'/' 2:'
    style /1 /2)."""
    args = Args.parse(argv)
    inp = _inputs(args)
    in2 = args.get("in2")
    out = args.get("out")
    out2 = args.get("out2")
    prefix = args.get("prefix", default="")
    if inp is None or out is None:
        print("Usage: rename in=<file> out=<file> prefix=<p>",
              file=sys.stderr)
        return 1
    if in2:
        it = fastx.PairedReader(inp, in2)
        def gen1():
            for i, (r1, r2) in enumerate(it_pairs):
                r1.id = f"{prefix}_{i} /1" if prefix else f"{i} /1"
                yield r1
        # materialize pairs once
        it_pairs = list(it)
        def gen2():
            for i, (r1, r2) in enumerate(it_pairs):
                r2.id = f"{prefix}_{i} /2" if prefix else f"{i} /2"
                yield r2
        _write_records(out, gen1())
        _write_records(out2 or out, gen2())
        return 0
    def gen():
        for i, rec in enumerate(fastx.read_seqs(inp)):
            rec.id = f"{prefix}_{i}" if prefix else str(i)
            yield rec
    _write_records(out, gen())
    return 0


def testformat(argv: List[str]) -> int:
    """reference: testformat.sh (stream/FASTQ detection) — report
    format, compression, quality offset, interleaving, read length."""
    args = Args.parse(argv)
    paths = _rawpos(argv)
    if args.get("in"):
        paths = args.get("in").split(",") + paths
    if not paths:
        print("Usage: testformat <file> [<file> ...]", file=sys.stderr)
        return 1
    for p in paths:
        fmt = fastx.sniff_format(p)
        comp = ("gz" if p.endswith(".gz") else
                "bz2" if p.endswith(".bz2") else "raw")
        qoff = "sanger"
        length = 0
        inter = False
        try:
            recs = []
            for rec in fastx.read_seqs(p):
                recs.append(rec)
                if len(recs) >= 4:
                    break
            if recs:
                length = len(recs[0].bases)
                quals = b"".join(r.quality or b"" for r in recs)
                # sanger spans 33..74, illumina-64 spans 64..104; calls
                # below 59 prove sanger, above 74 prove illumina-64
                # (reference: stream/FASTQ.detectQuality — ambiguous
                # inputs default to sanger)
                if quals and min(quals) >= 64 and max(quals) > 74:
                    qoff = "illumina"
                if len(recs) >= 2:
                    i1, i2 = recs[0].id, recs[1].id
                    base1 = i1.split()[0].rstrip("/1")
                    base2 = i2.split()[0].rstrip("/2")
                    inter = base1 == base2
        except Exception:
            pass
        print("\t".join([fmt, comp,
                         qoff if fmt == "fastq" else "-",
                         "interleaved" if inter else "single",
                         str(length)]))
    return 0


def textfile(argv: List[str]) -> int:
    """reference: textfile.sh (fileIO/TextFile.java main) — print lines
    [start, stop] (zero-based) of a text file."""
    args = Args.parse(argv)
    pos = _rawpos(argv)
    if not pos:
        print("Usage: textfile <file> <start line> <stop line>",
              file=sys.stderr)
        return 1
    path = pos[0]
    start = int(pos[1]) if len(pos) > 1 else 0
    stop = int(pos[2]) if len(pos) > 2 else (1 << 62)
    with fastx.xopen(path, "rt") as fh:
        for i, line in enumerate(fh):
            if i > stop:
                break
            if i >= start:
                sys.stdout.write(line)
    return 0


def printtime(argv: List[str]) -> int:
    """reference: driver/PrintTime.java — print ms elapsed since the
    timestamp stored in <file>; rewrite the file with the current time."""
    args = Args.parse(argv)
    pos = _rawpos(argv)
    if not pos:
        print("Usage: printtime <file>", file=sys.stderr)
        return 1
    path = pos[0]
    now = int(time.time() * 1000)
    prev = None
    if os.path.exists(path):
        try:
            with open(path) as fh:
                prev = int(fh.read().strip())
        except Exception:
            prev = None
    if prev is not None:
        print(f"Elapsed:\t{(now - prev) / 1000.0:.3f} s")
    with open(path, "w") as fh:
        fh.write(str(now))
    return 0


def phylip2fasta(argv: List[str]) -> int:
    """reference: driver/PhylipToFasta.java — interleaved phylip ->
    fasta."""
    args = Args.parse(argv)
    inp = _inputs(args)
    pos = _rawpos(argv)
    out = args.get("out") or (pos[1] if len(pos) > 1 else None)
    if inp is None or out is None:
        print("Usage: phylip2fasta in=<phylip> out=<fasta>",
              file=sys.stderr)
        return 1
    with fastx.xopen(inp, "rt") as fh:
        header = fh.readline().split()
        ntax = int(header[0]) if header else 0
        names: List[str] = []
        seqs: List[List[str]] = []
        idx = 0
        first_block = True
        for line in fh:
            line = line.rstrip("\n")
            if not line.strip():
                idx = 0
                first_block = False
                continue
            if first_block and len(names) < ntax:
                parts = line.split(None, 1)
                names.append(parts[0])
                seqs.append([parts[1].replace(" ", "")
                             if len(parts) > 1 else ""])
            else:
                seqs[idx % max(1, ntax)].append(line.replace(" ", ""))
                idx += 1
    recs = (fastx.SeqRecord(id=n, bases="".join(s).encode())
            for n, s in zip(names, seqs))
    fastx.write_fasta(out, recs)
    return 0


def matrixtocolumns(argv: List[str]) -> int:
    """reference: driver/MatrixToColumns.java — two matched identity
    matrices -> 2-column rows."""
    args = Args.parse(argv)
    in1 = args.get("in1", "in")
    in2 = args.get("in2")
    out = args.get("out")
    if in1 is None or in2 is None or out is None:
        print("Usage: matrixtocolumns in1=<m1> in2=<m2> out=<file>",
              file=sys.stderr)
        return 1

    def cells(path):
        with fastx.xopen(path, "rt") as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                for v in line.split()[1:]:
                    yield v
    with fastx.xopen(out, "wt") as oh:
        for a, b in zip(cells(in1), cells(in2)):
            oh.write(f"{a}\t{b}\n")
    return 0


def mergeotus(argv: List[str]) -> int:
    """reference: driver/MergeCoverageOTU.java — sum pileup covstats
    lines that share an OTU key (text after first space, before first
    tab, of the name field)."""
    args = Args.parse(argv)
    pos = _rawpos(argv)
    inp = args.get("in") or (pos[0] if pos else None)
    out = args.get("out") or (pos[1] if len(pos) > 1 else None)
    if inp is None or out is None:
        print("Usage: mergeOTUs in=<file> out=<file>", file=sys.stderr)
        return 1
    header = None
    order: List[str] = []
    acc = {}
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if header is None:
                if not line.startswith("#"):
                    print("Expected a header line starting with #",
                          file=sys.stderr)
                    return 1
                header = line
                continue
            f = line.split("\t")
            name = f[0]
            sp = name.find(" ")
            otu = name[sp + 1:] if sp >= 0 else name
            # columns: ID Avg_fold Length Ref_GC Covered_percent
            #          Covered_bases Plus_reads Minus_reads ...
            row = acc.get(otu)
            vals = [float(x) for x in f[1:]]
            if row is None:
                order.append(otu)
                acc[otu] = vals
            else:
                # length/covered/reads add; averages fold in by length
                oldlen = row[1]
                newlen = vals[1]
                tot = max(1.0, oldlen + newlen)
                row[0] = (row[0] * oldlen + vals[0] * newlen) / tot
                row[2] = (row[2] * oldlen + vals[2] * newlen) / tot
                row[3] = (row[3] * oldlen + vals[3] * newlen) / tot
                row[1] = oldlen + newlen
                for i in range(4, len(vals)):
                    row[i] += vals[i]
    with fastx.xopen(out, "wt") as oh:
        if header:
            oh.write(header + "\n")
        for otu in order:
            vals = acc[otu]
            cols = [otu]
            for i, v in enumerate(vals):
                cols.append(f"{v:.4f}" if i in (0, 2, 3)
                            else str(int(v)))
            oh.write("\t".join(cols) + "\n")
    return 0


def summarizescafstats(argv: List[str]) -> int:
    """reference: summarizescafstats.sh — one summary row per scafstats
    file: name, primary scaffold pct, sum of others."""
    args = Args.parse(argv)
    ins = args.get("in")
    paths = (ins.split(",") if ins else []) + list(args.positional)
    out = args.get("out")
    if not paths:
        print("Usage: summarizescafstats in=<file,file...> out=<file>",
              file=sys.stderr)
        return 1
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    oh.write("#file\tprimary\tprimary_pct\tsecondary_pct\tratio\n")
    for p in paths:
        rows = []
        with fastx.xopen(p, "rt") as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                f = line.split("\t")
                # name %unambiguousReads unambiguousMB ...
                try:
                    rows.append((f[0], float(f[1])))
                except (ValueError, IndexError):
                    continue
        if not rows:
            continue
        rows.sort(key=lambda r: -r[1])
        prim_name, prim = rows[0]
        rest = sum(r[1] for r in rows[1:])
        ratio = prim / rest if rest > 0 else float("inf")
        oh.write(f"{os.path.basename(p)}\t{prim_name}\t{prim:.4f}\t"
                 f"{rest:.4f}\t{ratio:.2f}\n")
    if out:
        oh.close()
    return 0


def summarizeseal(argv: List[str]) -> int:
    """reference: driver/SummarizeSealStats.java — per seal-stats file:
    primary ref reads vs others (cross-contamination estimate)."""
    args = Args.parse(argv)
    ins = args.get("in")
    paths = (ins.split(",") if ins else []) + list(args.positional)
    out = args.get("out")
    if not paths:
        print("Usage: summarizeseal in=<file,file...> out=<file>",
              file=sys.stderr)
        return 1
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    oh.write("#file\tprimary\tprimaryReads\tsecondaryReads\t"
             "contamPct\n")
    for p in paths:
        rows = []
        with fastx.xopen(p, "rt") as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                f = line.split("\t")
                try:
                    rows.append((f[0], int(float(f[2]))
                                 if len(f) > 2 else int(float(f[1]))))
                except (ValueError, IndexError):
                    continue
        if not rows:
            continue
        rows.sort(key=lambda r: -r[1])
        prim_name, prim = rows[0]
        rest = sum(r[1] for r in rows[1:])
        pct = 100.0 * rest / max(1, prim + rest)
        oh.write(f"{os.path.basename(p)}\t{prim_name}\t{prim}\t{rest}\t"
                 f"{pct:.4f}\n")
    if out:
        oh.close()
    return 0


def muxbyname(argv: List[str]) -> int:
    """reference: muxbyname.sh — combine reads from many files, rename
    each read to <filename>_<original name>."""
    args = Args.parse(argv)
    ins = args.get("in")
    paths = (ins.split(",") if ins else []) + [
        p for p in args.positional]
    out = args.get("out")
    if not paths or out is None:
        print("Usage: muxbyname in=<file,file,...> out=<file>",
              file=sys.stderr)
        return 1

    def gen():
        for p in paths:
            stem = os.path.basename(p)
            for ext in (".gz", ".bz2"):
                if stem.endswith(ext):
                    stem = stem[:-len(ext)]
            stem = os.path.splitext(stem)[0]
            for rec in fastx.read_seqs(p):
                rec.id = f"{stem}_{rec.id}"
                yield rec
    _write_records(out, gen())
    return 0


def filtersubs(argv: List[str]) -> int:
    """reference: filtersubs.sh (driver/FilterReadsWithSubs.java) —
    keep sam reads having substitutions whose base quality lies in
    [minq, maxq]."""
    args = Args.parse(argv)
    inp = _inputs(args)
    out = args.get("out")
    minq = args.get_int("minq", default=0)
    maxq = args.get_int("maxq", default=99)
    countindels = args.get_bool("countindels", default=True)
    keepperfect = args.get_bool("keepperfect", default=False)
    if inp is None or out is None:
        print("Usage: filtersubs in=<sam> out=<sam> minq= maxq=",
              file=sys.stderr)
        return 1
    import re
    from ..io.sam import open_sam_lines
    kept = total = 0
    with fastx.xopen(out, "wt") as oh:
        for line in open_sam_lines(inp):
            if line.startswith("@"):
                oh.write(line if line.endswith("\n") else line + "\n")
                continue
            total += 1
            f = line.rstrip("\n").split("\t")
            flag = int(f[1])
            if flag & 4:
                continue
            cigar = f[5]
            qual = f[10]
            md = None
            for tag in f[11:]:
                if tag.startswith("MD:Z:"):
                    md = tag[5:]
                    break
            keep = False
            has_indel = ("I" in cigar) or ("D" in cigar)
            subs_q: List[int] = []
            if md is not None:
                # walk MD to get read positions of substitutions
                pos = 0
                i = 0
                while i < len(md):
                    if md[i].isdigit():
                        j = i
                        while j < len(md) and md[j].isdigit():
                            j += 1
                        pos += int(md[i:j])
                        i = j
                    elif md[i] == "^":
                        i += 1
                        while i < len(md) and md[i].isalpha():
                            i += 1
                    else:
                        if qual != "*" and pos < len(qual):
                            subs_q.append(ord(qual[pos]) - 33)
                        pos += 1
                        i += 1
            perfect = not subs_q and not has_indel
            if perfect and keepperfect:
                keep = True
            if any(minq <= q <= maxq for q in subs_q):
                keep = True
            if has_indel and countindels and not perfect:
                keep = True
            if keep:
                kept += 1
                oh.write(line if line.endswith("\n") else line + "\n")
    sys.stderr.write(f"Kept {kept} of {total} reads\n")
    return 0


def reducesilva(argv: List[str]) -> int:
    """reference: driver/ReduceSilva.java — keep the first sequence per
    distinct taxa (semicolon-delimited header field, column= from the
    right, default 1)."""
    args = Args.parse(argv)
    inp = _inputs(args)
    out = args.get("out")
    column = args.get_int("column", default=1)
    if inp is None or out is None:
        print("Usage: reducesilva in=<file> out=<file> column=1",
              file=sys.stderr)
        return 1
    seen = set()
    def gen():
        kept = 0
        for rec in fastx.read_seqs(inp):
            split = rec.id.split(";")
            if len(split) <= column:
                yield rec
                continue
            taxa = split[len(split) - column - 1]
            if taxa in seen:
                continue
            seen.add(taxa)
            kept += 1
            yield rec
    _write_records(out, gen())
    return 0


def estherfilter(argv: List[str]) -> int:
    """reference: driver/EstherFilter.java — BLAST query vs ref, keep
    hits scoring above cutoff. Runs `blastall` when present (same
    command line as the reference); otherwise falls back to the
    built-in banded aligner as the scorer (documented deviation — this
    environment has no BLAST)."""
    args = Args.parse(argv)
    pos = _rawpos(argv)
    if len(pos) < 3:
        print("Usage: estherfilter <query.fa> <ref.fa> <cutoff> "
              "[fasta]", file=sys.stderr)
        return 1
    query, ref, cutoff = pos[0], pos[1], float(pos[2])
    outfasta = len(pos) > 3 and pos[3].lower() == "fasta"
    import shutil
    import subprocess
    if shutil.which("blastall"):
        cmd = ["blastall", "-p", "blastn", "-i", query, "-d", ref,
               "-e", "0.00001", "-m", "8"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        names = set()
        for line in res.stdout.splitlines():
            f = line.split("\t")
            if len(f) >= 12 and float(f[11]) >= cutoff:
                names.add(f[0])
    else:
        from ..ops.banded import banded_edit_distance
        import numpy as np
        refs = list(fastx.read_seqs(ref))
        names = set()
        for rec in fastx.read_seqs(query):
            for rr in refs:
                m = min(len(rec.bases), len(rr.bases))
                if m == 0:
                    continue
                band = max(8, m // 4)
                ed = banded_edit_distance(
                    np.frombuffer(rec.bases[:m], np.uint8),
                    np.frombuffer(rr.bases[:m], np.uint8), band)
                ident = 1.0 - min(ed, band + 1) / m
                # bitscore proxy: 2 bits per matching base
                if 2.0 * ident * m >= cutoff:
                    names.add(rec.id)
                    break
    if outfasta:
        recs = (r for r in fastx.read_seqs(query) if r.id in names)
        fastx.write_fasta("stdout", recs)
    else:
        for n in sorted(names):
            print(n)
    return 0


def bbest(argv: List[str]) -> int:
    """reference: bbest.sh (jgi/SamToEst.java) — EST capture stats from
    an ordered sam file. ESTs split into parts by BBMap carry
    '_part_<n>' name suffixes; parts regroup by base name. Classes per
    EST: all (match fraction >= fraction=), most (>= 1/2), some (> 0),
    zero; multi = parts mapped to >1 scaffold."""
    args = Args.parse(argv)
    inp = _inputs(args)
    out = args.get("out")
    ref = args.get("ref")
    est = args.get("est")
    fraction = args.get_float("fraction", default=0.98)
    if inp is None:
        print("Usage: bbest in=<sam> out=<stats>", file=sys.stderr)
        return 1
    import re
    from ..io.sam import open_sam_lines
    ref_count = 0
    ref_bases = 0
    est_count = est_bases = 0
    cls = dict(all=[0, 0], most=[0, 0], some=[0, 0], zero=[0, 0],
               multi=[0, 0])
    introns: Dict[int, int] = {}

    cur_name = None
    cur_len = 0
    cur_match = 0
    cur_scafs: set = set()

    def classify():
        nonlocal est_count, est_bases
        if cur_name is None:
            return
        est_count += 1
        est_bases += cur_len
        if len(cur_scafs) > 1:
            cls["multi"][0] += 1
            cls["multi"][1] += cur_len
        if cur_match >= cur_len * fraction:
            key = "all"
        elif cur_match >= cur_len / 2:
            key = "most"
        elif cur_match > 0:
            key = "some"
        else:
            key = "zero"
        cls[key][0] += 1
        cls[key][1] += cur_len

    part_re = re.compile(r"^(.*)_part_\d{1,5}$")
    for line in open_sam_lines(inp):
        if line.startswith("@"):
            if line.startswith("@SQ"):
                ref_count += 1
                m = re.search(r"LN:(\d+)", line)
                if m:
                    ref_bases += int(m.group(1))
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 11:
            continue
        flag = int(f[1])
        if flag & 0x100:          # secondary
            continue
        name = f[0]
        m = part_re.match(name)
        if m:
            name = m.group(1)
        if name != cur_name:
            classify()
            cur_name, cur_len, cur_match, cur_scafs = name, 0, 0, set()
        seqlen = len(f[9]) if f[9] != "*" else 0
        cur_len += seqlen
        if not flag & 4:
            cur_scafs.add(f[2])
            # matched bases: from cigar = blocks minus indels; count
            # M/= as match (reference uses match string / cigarToMsdic)
            for num, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]):
                L = int(num)
                if op in "M=":
                    cur_match += L
                elif op in "DN" and L >= 10:
                    introns[L] = introns.get(L, 0) + 1
    classify()
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    oh.write(f"ref_file={ref}\nest_file={est}\nsam_file={inp}\n")
    oh.write(f"n_ref_scaffolds={ref_count}\nn_ref_bases={ref_bases}\n")
    oh.write(f"n_est={est_count}\nn_est_bases={est_bases}\n")
    oh.write("type\tn_est\tpct_est\tn_bases\tpct_bases\n")
    me = 100.0 / max(1, est_count)
    mb = 100.0 / max(1, est_bases)
    for key in ("all", "most", "some", "zero", "multi"):
        n, b = cls[key]
        oh.write(f"{key}:\t{n}\t{me * n:.4f}%\t{b}\t{mb * b:.4f}%\n")
    total = sum(introns.values())
    if total:
        keys = sorted(introns)
        mn, mx = keys[0], keys[-1]
        ssum = sum(k * v for k, v in introns.items())
        half = (total + 1) // 2
        acc = 0
        med = mn
        for k in keys:
            acc += introns[k]
            if acc >= half:
                med = k
                break
        oh.write("introns\tmin\tmax\tmedian\taverage\n")
        oh.write(f"{total}\t{mn}\t{mx}\t{med}\t{ssum / total:.1f}\n")
    else:
        oh.write("introns\tmin\tmax\tmedian\taverage\n")
        oh.write("0\t0\t0\t0\t0.0\n")
    if out:
        oh.close()
    return 0


def dedupebymapping(argv: List[str]) -> int:
    """reference: dedupebymapping.sh (jgi/DedupeByMapping.java) — keep
    one read (pair) per mapping coordinate key (scaf, pos, strand,
    mate scaf/pos); the copy with the highest quality sum wins."""
    args = Args.parse(argv)
    pos = _rawpos(argv)
    inp = args.get("in") or (pos[0] if pos else None)
    out = args.get("out") or (pos[1] if len(pos) > 1 else None)
    keepunmapped = args.get_bool("keepunmapped", "ku", default=True)
    if inp is None or out is None:
        print("Usage: dedupebymapping in=<sam> out=<sam>",
              file=sys.stderr)
        return 1
    from ..io.sam import open_sam_lines
    best: Dict[tuple, tuple] = {}    # key -> (qualsum, first_index)
    lines_by_name: Dict[str, List[str]] = {}
    order: List[str] = []
    header: List[str] = []
    keys_of: Dict[str, tuple] = {}
    quals_of: Dict[str, int] = {}
    n_unmapped = 0
    for line in open_sam_lines(inp):
        if line.startswith("@"):
            header.append(line)
            continue
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x100:
            continue
        name = f[0]
        if name not in lines_by_name:
            lines_by_name[name] = []
            order.append(name)
        lines_by_name[name].append(line)
        mapped = not flag & 4
        strand = 1 if flag & 16 else 0
        k = (f[2], int(f[3]), strand, f[6], int(f[7])) if mapped \
            else None
        prev = keys_of.get(name)
        if prev is None:
            keys_of[name] = k if k is not None else ("*",)
        elif k is not None:
            keys_of[name] = tuple(list(prev) + list(k))
        q = 0
        if f[10] != "*":
            q = sum(ord(c) - 33 for c in f[10])
        quals_of[name] = quals_of.get(name, 0) + q
    kept: Dict[tuple, str] = {}
    for name in order:
        k = keys_of[name]
        if k == ("*",):
            continue
        old = kept.get(k)
        if old is None or quals_of[name] > quals_of[old]:
            kept[k] = name
    keep_names = set(kept.values())
    n_kept = n_dropped = 0
    with fastx.xopen(out, "wt") as oh:
        for h in header:
            oh.write(h if h.endswith("\n") else h + "\n")
        for name in order:
            is_unmapped = keys_of[name] == ("*",)
            if name in keep_names or (is_unmapped and keepunmapped):
                n_kept += 1
                for line in lines_by_name[name]:
                    oh.write(line if line.endswith("\n")
                             else line + "\n")
            else:
                n_dropped += 1
    sys.stderr.write(f"Kept:\t{n_kept}\nDropped:\t{n_dropped}\n")
    return 0


def summarizecrossblock(argv: List[str]) -> int:
    """reference: driver/SummarizeCrossblock.java +
    ParseCrossblockResults.java — summarize crossblock (decontaminate)
    results files: per file, contigs/bases kept and discarded.
    Results lines: name <tab> ? <tab> removed(0/1) <tab> length."""
    args = Args.parse(argv)
    ins = args.get("in")
    paths = (ins.split(",") if ins else []) + list(args.positional)
    out = args.get("out")
    if not paths:
        print("Usage: summarizecrossblock in=<file,file...> out=<file>",
              file=sys.stderr)
        return 1
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    oh.write("#fname\tcopies\tcontigs\tcontigsDiscarded\tbases\t"
             "basesDiscarded\n")
    for i, p in enumerate(paths, 1):
        try:
            ck = cd = bk = bd = 0
            with fastx.xopen(p, "rt") as fh:
                for line in fh:
                    if line.startswith("#") or not line.strip():
                        continue
                    f = line.split("\t")
                    length = int(f[3])
                    removed = int(f[2]) == 1
                    if removed:
                        cd += 1
                        bd += length
                    else:
                        ck += 1
                        bk += length
            oh.write(f"{p}\t{i}\t{ck}\t{cd}\t{bk}\t{bd}\n")
        except Exception as e:
            oh.write(f"{p}\tERROR\n")
    if out:
        oh.close()
    return 0


def _time_to_seconds(s: str) -> float:
    """'1m23.456s' -> seconds (reference: driver/ProcessSpeed
    .toSeconds)."""
    s = s.replace("s", "")
    m, sec = s.split("m")
    return 60 * float(m) + float(sec)


def summarizemerge(argv: List[str]) -> int:
    """reference: summarizemerge.sh (driver/ProcessSpeed.java) —
    condense GradeMerge + `time` output into rows: name, real, user,
    sys, correct%, incorrect%, SNR."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    if inp is None:
        print("Usage: summarizemerge in=<file>", file=sys.stderr)
        return 1
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("***"):
                print(line.replace("***", "").strip())
            elif line.startswith(("real\t", "user\t", "sys\t")):
                print(f"{_time_to_seconds(line.split(chr(9))[1]):.3f}",
                      end="\t")
            elif line.startswith("Correct:"):
                print(line.split()[1], end="\t")
            elif line.startswith("Incorrect:"):
                print(line.split()[1], end="\t")
            elif line.startswith("SNR:"):
                print(line.split()[1])
    return 0


def processfrag(argv: List[str]) -> int:
    """reference: processfrag.sh (driver/ProcessFragMerging.java) —
    condense timing + grading output into one CSV-ish row per ***
    section (made for the BBMerge paper data)."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    sym = args.get("sym", default="\t")
    if inp is None:
        print("Usage: processfrag <file>", file=sys.stderr)
        return 1
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            split = line.split()
            if line.startswith("***"):
                name = split[1] if len(split) > 1 else ""
                sys.stdout.write("\n" + name + sym)
            elif line.startswith("real"):
                secs = _time_to_seconds(line.split("\t")[1])
                sys.stdout.write(f"{secs:.3f}{sym}")
            elif line.startswith("Reads Used:"):
                sys.stdout.write(split[2] + sym
                                 + split[3].lstrip("(") + sym)
            elif line.startswith("mapped:"):
                sys.stdout.write(split[1] + sym + split[2] + sym)
            elif line.startswith(("Error Rate:", "Sub Rate:",
                                  "Del Rate:", "Ins Rate:")):
                sys.stdout.write(split[2] + sym + split[4] + sym)
    sys.stdout.write("\n")
    return 0


def filterassemblysummary(argv: List[str]) -> int:
    """reference: filterassemblysummary.sh
    (driver/FilterAssemblySummary.java) — keep NCBI assembly-summary
    lines whose taxid (column 6, zero-based) passes the taxonomy
    filter (ids= ancestors, include=t)."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    ids = args.get("ids", "id", "taxa")
    include = args.get_bool("include", default=True)
    if inp is None or out is None or ids is None:
        print("Usage: filterassemblysummary in= out= tree=<taxtree> "
              "ids=<taxids>", file=sys.stderr)
        return 1
    from .taxonomy import _load_tree
    t = _load_tree(args)
    if t is None:
        print("tree= is required", file=sys.stderr)
        return 1
    targets = set()
    for tok in ids.split(","):
        tid = t.resolve(tok)
        if tid is not None:
            targets.add(tid)
    kept = total = 0
    with fastx.xopen(inp, "rt") as fh, fastx.xopen(out, "wt") as oh:
        for line in fh:
            if line.startswith("#"):
                oh.write(line)
                continue
            total += 1
            f = line.rstrip("\n").split("\t")
            if len(f) <= 6:
                continue
            try:
                taxid = int(f[6])
            except ValueError:
                continue
            lin = set(t.lineage(taxid))
            hit = bool(lin & targets)
            if hit == include:
                kept += 1
                oh.write(line)
    sys.stderr.write(f"Kept {kept} of {total} lines\n")
    return 0
