"""PacBio auxiliary pipeline tools: site stacking, coverage, contig merge.

reference: pacbio/ package —
- StackSites2.java:36 collects per-read alignment sites (SiteScoreR)
  from mapped reads, sorted by genomic position, for downstream
  consensus building.
- CalcCoverageFromSites.java computes per-position coverage from the
  stacked site file.
- ProcessStackedSitesNormalized.java subsamples stacks so coverage is
  bounded (normalization) before consensus.
- MergeFastaContigs.java merges many contigs/scaffolds into padded
  pseudo-chromosomes separated by N runs (npad, default 300).

The site file here is a TSV: rname, start0, stop0 (inclusive), strand,
score, qname — sorted by (rname, start).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..io import fastx
from ..utils.args import Args

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _refspan(cigar: str) -> int:
    return sum(int(n) for n, op in _CIGAR_RE.findall(cigar)
               if op in "MDN=X")


def read_sam_sites(path: str) -> List[Tuple[str, int, int, int, int,
                                            str]]:
    """Extract (rname, start0, stop0, strand, score, qname) per mapped
    record (reference: StackSites2 builds SiteScoreR from read sites)."""
    sites = []
    with fastx.xopen(path, "rt") as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11 or int(f[1]) & 0x4 or f[5] == "*":
                continue
            start = int(f[3]) - 1
            stop = start + _refspan(f[5]) - 1
            strand = 1 if int(f[1]) & 0x10 else 0
            sites.append((f[2], start, stop, strand, int(f[4]), f[0]))
    sites.sort(key=lambda s: (s[0], s[1], s[2]))
    return sites


def stacksites_main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out") or (args.positional[1]
                              if len(args.positional) > 1 else None)
    if inp is None or out is None:
        print("Usage: stacksites in=<mapped.sam> out=<sites.txt>",
              file=sys.stderr)
        return 1
    sites = read_sam_sites(inp)
    with fastx.xopen(out, "wt") as fh:
        fh.write("#rname\tstart\tstop\tstrand\tscore\tqname\n")
        for s in sites:
            fh.write("\t".join(map(str, s)) + "\n")
    sys.stderr.write(f"Sites:\t{len(sites)}\n")
    return 0


def _load_sites(path: str):
    sites = []
    with fastx.xopen(path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            sites.append((f[0], int(f[1]), int(f[2]), int(f[3]),
                          int(f[4]), f[5]))
    return sites


def calccoverage_main(argv: List[str]) -> int:
    """reference: pacbio/CalcCoverageFromSites.java — per-position
    coverage from stacked sites, reported per bin."""
    args = Args.parse(argv)
    inp = args.get("in", "in1", "sites") or (
        args.positional[0] if args.positional else None)
    out = args.get("out")
    binsize = args.get_int("binsize", "bin", default=100)
    if inp is None or out is None:
        print("Usage: calccoveragefromsites in=<sites.txt> "
              "out=<cov.txt> [binsize=100]", file=sys.stderr)
        return 1
    sites = _load_sites(inp)
    by_ref: Dict[str, List[Tuple[int, int]]] = {}
    for (rn, a, b, *_rest) in sites:
        by_ref.setdefault(rn, []).append((a, b))
    with fastx.xopen(out, "wt") as fh:
        fh.write("#rname\tbin_start\tbin_stop\tavg_coverage\n")
        for rn in sorted(by_ref):
            iv = by_ref[rn]
            hi = max(b for _, b in iv) + 1
            cov = np.zeros(hi + 1, np.int64)
            for a, b in iv:
                cov[a] += 1
                cov[b + 1] -= 1
            cov = np.cumsum(cov)[:hi]
            for s in range(0, hi, binsize):
                e = min(s + binsize, hi)
                fh.write(f"{rn}\t{s}\t{e - 1}\t"
                         f"{cov[s:e].mean():.2f}\n")
    return 0


def normalize_stacks(sites, target: int):
    """Keep at most `target` covering sites per position, preferring
    higher scores (reference: ProcessStackedSitesNormalized — bounded
    coverage subsampling of stacks)."""
    by_ref: Dict[str, List] = {}
    for s in sites:
        by_ref.setdefault(s[0], []).append(s)
    kept = []
    for rn in sorted(by_ref):
        iv = sorted(by_ref[rn], key=lambda s: (s[1], -s[4]))
        hi = max(s[2] for s in iv) + 2
        cov = np.zeros(hi, np.int32)
        for s in iv:
            a, b = s[1], s[2]
            if int(cov[a:b + 1].max()) >= target:
                continue
            cov[a:b + 1] += 1
            kept.append(s)
    kept.sort(key=lambda s: (s[0], s[1], s[2]))
    return kept


def processstacked_main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1", "sites") or (
        args.positional[0] if args.positional else None)
    out = args.get("out")
    target = args.get_int("targetcoverage", "target", "cov", default=40)
    if inp is None or out is None:
        print("Usage: processstackedsites in=<sites.txt> out=<sites.txt>"
              " [target=40]", file=sys.stderr)
        return 1
    sites = _load_sites(inp)
    kept = normalize_stacks(sites, target)
    with fastx.xopen(out, "wt") as fh:
        fh.write("#rname\tstart\tstop\tstrand\tscore\tqname\n")
        for s in kept:
            fh.write("\t".join(map(str, s)) + "\n")
    sys.stderr.write(f"Sites in:\t{len(sites)}\nSites out:\t"
                     f"{len(kept)}\n")
    return 0


def mergefastacontigs_main(argv: List[str]) -> int:
    """reference: pacbio/MergeFastaContigs.java — concatenate contigs
    into pseudo-chromosomes with N_PAD_LENGTH Ns between contigs (:57,
    default 300) and at the front/back; emits a contig-location list so
    coordinates can be mapped back."""
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out") or (args.positional[1]
                              if len(args.positional) > 1 else None)
    npad = args.get_int("npad", default=300)
    maxlen = args.get_int("maxlen", "chromlen", default=200_000_000)
    outlist = args.get("outlist", "list")
    if inp is None or out is None:
        print("Usage: mergefastacontigs in=<contigs.fa> out=<merged.fa>"
              " [npad=300]", file=sys.stderr)
        return 1
    pad = b"N" * npad
    chrom_num = 0
    locs: List[Tuple[str, int, int, str]] = []
    out_fh = fastx.xopen(out, "wb")

    cur: List[bytes] = []
    cur_len = 0

    def flush():
        nonlocal chrom_num, cur, cur_len
        if not cur:
            return
        chrom_num += 1
        seq = pad + pad.join(cur) + pad
        out_fh.write(f">chr{chrom_num}\n".encode())
        for j in range(0, len(seq), 70):
            out_fh.write(seq[j:j + 70] + b"\n")
        cur = []
        cur_len = 0

    pos_in_chrom = npad
    for rec in fastx.read_seqs(inp):
        if cur and cur_len + len(rec.bases) + npad > maxlen:
            flush()
            pos_in_chrom = npad
        locs.append((rec.id, chrom_num + 1, pos_in_chrom,
                     f"{pos_in_chrom + len(rec.bases) - 1}"))
        pos_in_chrom += len(rec.bases) + npad
        cur.append(rec.bases)
        cur_len += len(rec.bases) + npad
    flush()
    out_fh.close()
    if outlist:
        with fastx.xopen(outlist, "wt") as fh:
            fh.write("#contig\tchrom\tstart\tstop\n")
            for (cid, ch, a, b) in locs:
                fh.write(f"{cid}\tchr{ch}\t{a}\t{b}\n")
    sys.stderr.write(f"Contigs:\t{len(locs)}\nChroms:\t{chrom_num}\n")
    return 0


def partitionreads_main(argv: List[str]) -> int:
    """Round-robin split of reads into N partition files (reference:
    pacbio/PartitionReads.java — out names carry a '#' replaced by the
    partition number; paired mode keeps mates together)."""
    from ..utils.args import Args
    from ..io import fastx
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out = args.get("out", "out1")
    out2 = args.get("out2")
    parts = args.get_int("partitions", "ways", default=2)
    if in1 is None or out is None or (parts > 1 and "#" not in out):
        print("Usage: partitionreads in=<reads> out=<name_#.fq> "
              "partitions=<N>", file=sys.stderr)
        return 1

    def open_parts(pattern):
        if pattern is None:
            return None
        return [fastx.xopen(pattern.replace("#", str(p)), "wb")
                for p in range(parts)]

    fhs1 = open_parts(out)
    fhs2 = open_parts(out2)

    def w(fh, rec):
        q = rec.quality or b"I" * len(rec.bases)
        fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n"
                 + q + b"\n")

    n = 0
    reader = fastx.PairedReader(in1, in2)
    for r1, r2 in reader:
        p = n % parts
        w(fhs1[p], r1)
        if r2 is not None:
            w((fhs2 or fhs1)[p], r2)
        n += 1
    for fh in (fhs1 or []) + (fhs2 or []):
        fh.close()
    sys.stderr.write(f"Partitioned {n} reads into {parts} files.\n")
    return 0


def partitionfastafile_main(argv: List[str]) -> int:
    """Split a fasta into partitions of ~N bases, never splitting a
    record (reference: pacbio/PartitionFastaFile.java)."""
    from ..utils.args import Args
    from ..io import fastx
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out") or (args.positional[1]
                              if len(args.positional) > 1 else None)
    size = args.get_int("partition", "size", default=1 << 20)
    if in1 is None or out is None or "#" not in out:
        print("Usage: partitionfastafile in=<fa> out=<name_#.fa> "
              "partition=<bases>", file=sys.stderr)
        return 1
    part = 0
    acc = 0
    fh = fastx.xopen(out.replace("#", str(part)), "wb")
    n = 0
    for rec in fastx.read_seqs(in1):
        if acc and acc + len(rec.bases) > size:
            fh.close()
            part += 1
            acc = 0
            fh = fastx.xopen(out.replace("#", str(part)), "wb")
        fh.write(b">" + rec.id.encode() + b"\n")
        for i in range(0, len(rec.bases), 70):
            fh.write(rec.bases[i:i + 70] + b"\n")
        acc += len(rec.bases)
        n += 1
    fh.close()
    sys.stderr.write(f"Split {n} records into {part + 1} partitions.\n")
    return 0


def removenfromchromosome_main(argv: List[str]) -> int:
    """Strip runs of N from sequences, recording removed intervals
    (reference: pacbio/RemoveNFromChromosome.java)."""
    from ..utils.args import Args
    from ..io import fastx
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    table = args.get("table")
    if in1 is None or out is None:
        print("Usage: removenfromchromosome in=<fa> out=<fa> "
              "[table=<intervals.txt>]", file=sys.stderr)
        return 1
    import re as _re
    tf = open(table, "w") if table else None
    with fastx.xopen(out, "wb") as ofh:
        for rec in fastx.read_seqs(in1):
            seq = rec.bases
            kept = bytearray()
            pos = 0
            for m in _re.finditer(b"[Nn]+", seq):
                kept += seq[pos:m.start()]
                if tf:
                    tf.write(f"{rec.id}\t{m.start()}\t{m.end()}\n")
                pos = m.end()
            kept += seq[pos:]
            ofh.write(b">" + rec.id.encode() + b"\n")
            for i in range(0, len(kept), 70):
                ofh.write(bytes(kept[i:i + 70]) + b"\n")
    if tf:
        tf.close()
    return 0


def sortsites_main(argv: List[str]) -> int:
    """Sort a stacked-sites text file by (chrom, start) (reference:
    pacbio/SortSites.java)."""
    from ..utils.args import Args
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out") or (args.positional[1]
                              if len(args.positional) > 1 else None)
    if in1 is None or out is None:
        print("Usage: sortsites in=<sites.txt> out=<sorted.txt>",
              file=sys.stderr)
        return 1
    header = []
    rows = []
    with open(in1) as fh:
        for line in fh:
            if line.startswith("#"):
                header.append(line)
                continue
            f = line.split("\t")
            try:
                key = (f[0], int(f[1]))
            except (ValueError, IndexError):
                key = (f[0], 0)
            rows.append((key, line))
    rows.sort(key=lambda t: t[0])
    with open(out, "w") as fh:
        fh.writelines(header)
        for _, line in rows:
            fh.write(line)
    sys.stderr.write(f"Sorted {len(rows)} sites.\n")
    return 0


def splitoffperfectcontigs_main(argv: List[str]) -> int:
    """Separate contigs whose coverage table marks them fully covered
    at depth >= cutoff (reference: pacbio/SplitOffPerfectContigs.java)."""
    from ..utils.args import Args
    from ..io import fastx
    args = Args.parse(argv)
    in1 = args.get("in", "in1")
    cov = args.get("cov", "coverage")
    out = args.get("out", "outperfect")
    outb = args.get("outb", "outimperfect")
    cutoff = args.get_int("cutoff", "mindepth", default=2)
    if in1 is None or out is None:
        print("Usage: splitoffperfectcontigs in=<fa> cov=<covstats> "
              "out=<perfect.fa> outb=<rest.fa> cutoff=2",
              file=sys.stderr)
        return 1
    perfect = set()
    if cov:
        with open(cov) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                # covstats: name, avg_fold, length, covered_pct, ...
                try:
                    if float(f[1]) >= cutoff and float(f[3]) >= 100.0:
                        perfect.add(f[0])
                except (ValueError, IndexError):
                    continue
    np_, ni = 0, 0
    with fastx.xopen(out, "wb") as pf:
        bf = fastx.xopen(outb, "wb") if outb else None
        for rec in fastx.read_seqs(in1):
            fh = pf if rec.id in perfect else (bf or pf)
            if rec.id in perfect:
                np_ += 1
            else:
                ni += 1
                if bf is None:
                    continue
            fh.write(b">" + rec.id.encode() + b"\n" + rec.bases + b"\n")
        if bf:
            bf.close()
    sys.stderr.write(f"Perfect:\t{np_}\nImperfect:\t{ni}\n")
    return 0
