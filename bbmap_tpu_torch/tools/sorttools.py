"""Sorting tools: sortsam (by mapping position), sortbyname.

reference: align2/SortReadsByMapping.java (external block sort: spill
sorted temp blocks, k-way merge, :214-320 writeTempFiles/mergeFiles),
align2/SortReadsByID.java, sh/sortbyname.sh. Inputs above the spill
threshold (records=, default 1M) are sorted with the same
spill-then-merge strategy instead of in memory.
"""

from __future__ import annotations

import heapq
import os
import sys
import tempfile
from typing import List

from ..io import fastx
from ..utils.args import Args


def _external_merge_lines(chunks_iter, key, out_fh, tmpdir,
                          spill_at: int) -> int:
    """Generic external sort of (key, line) pairs: accumulate, spill
    sorted runs as temp files, k-way heapq.merge (reference:
    SortReadsByMapping.writeTempFiles/mergeFiles :214-320). The key is
    re-derived on merge from a sortable text prefix 'k1\\x00k2\\x00line'
    so temp runs need no pickling."""
    import gzip
    runs = []
    buf = []
    n = 0

    def spill():
        nonlocal buf
        if not buf:
            return
        buf.sort(key=lambda t: t[0])
        path = os.path.join(tmpdir, f"run{len(runs)}.tmp.gz")
        with gzip.open(path, "wt") as fh:
            for k, line in buf:
                fh.write(k + "\x01" + line.rstrip("\n") + "\n")
        runs.append(path)
        buf = []

    for k, line in chunks_iter:
        buf.append((k, line))
        n += 1
        if len(buf) >= spill_at:
            spill()
    if not runs:
        # everything fit — plain in-memory sort
        buf.sort(key=lambda t: t[0])
        for _, line in buf:
            out_fh.write(line)
        return n
    spill()

    def run_reader(path):
        with gzip.open(path, "rt") as fh:
            for line in fh:
                ks, _, payload = line.partition("\x01")
                yield (ks, payload)

    for _, payload in heapq.merge(*(run_reader(r) for r in runs),
                                  key=lambda t: t[0]):
        out_fh.write(payload if payload.endswith("\n")
                     else payload + "\n")
    for r in runs:
        os.unlink(r)
    return n


def sortsam(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    spill_at = args.get_int("records", "spill", default=1_000_000)
    if inp is None or out is None:
        print("Usage: sortsam in=<sam> out=<sorted.sam>", file=sys.stderr)
        return 1
    header: List[str] = []
    sq_order = {}

    def rows():
        from ..io import sam as samio
        for line0 in samio.open_sam_lines(inp):
            line = line0 + "\n"
            if True:
                if line.startswith("@"):
                    header.append(line)
                    if line.startswith("@SQ"):
                        d = dict(f.split(":", 1) for f in
                                 line.rstrip().split("\t")[1:])
                        sq_order[d["SN"]] = len(sq_order)
                    continue
                f = line.split("\t", 5)
                if len(f) < 5:
                    continue
                rname = f[2]
                # sortable text key: zero-padded (chrom-rank, pos)
                yield (f"{sq_order.get(rname, len(sq_order) + 1):08d}"
                       f"\x00{int(f[3]):012d}", line)

    # the header must be written before merged body lines, but it is
    # only complete after reading starts — buffer via temp body file
    with tempfile.TemporaryDirectory() as tmpdir:
        body = os.path.join(tmpdir, "body.sam")
        with open(body, "w") as bf:
            n = _external_merge_lines(rows(), None, bf, tmpdir,
                                      spill_at)
        from ..io import sam as samio
        fh = samio.open_sam_writer(out)
        fh.writelines(header)
        with open(body) as bf:
            for line in bf:
                fh.write(line)
        fh.close()
    sys.stderr.write(f"Sorted {n} alignments.\n")
    return 0


def sortbyname(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    spill_at = args.get_int("records", "spill", default=1_000_000)
    if inp is None or out is None:
        print("Usage: sortbyname in=<reads> out=<sorted>",
              file=sys.stderr)
        return 1
    fmt = fastx.sniff_format(inp)

    def rows():
        for r in fastx.read_seqs(inp):
            if fmt == "fasta":
                rec = ">" + r.id + "\n" + r.bases.decode() + "\n"
            else:
                q = (r.quality or b"I" * len(r.bases)).decode()
                rec = ("@" + r.id + "\n" + r.bases.decode() + "\n+\n"
                       + q + "\n")
            # records are multi-line: encode newlines for the run files
            yield (r.id, rec.replace("\n", "\x02") + "\n")

    with tempfile.TemporaryDirectory() as tmpdir:
        body = os.path.join(tmpdir, "body.txt")
        with open(body, "w") as bf:
            n = _external_merge_lines(rows(), None, bf, tmpdir,
                                      spill_at)
        with fastx.xopen(out, "wt") as fh:
            with open(body) as bf:
                for line in bf:
                    fh.write(line.rstrip("\n").replace("\x02", "\n"))
    sys.stderr.write(f"Sorted {n} reads.\n")
    return 0


def grademerge(argv: List[str]) -> int:
    """Grade bbmerge output against truth-encoded insert sizes
    (reference: jgi/GradeMergedReads.java — reads generated by
    randomreads paired mode carry true start/stop per mate; the insert is
    recovered from the merged read length)."""
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    if inp is None:
        print("Usage: grademerge in=<merged.fq>", file=sys.stderr)
        return 1
    total = correct = incorrect = 0
    loose = 0
    for rec in fastx.read_seqs(inp):
        # exact truth: 'insert=N' in the name (reference:
        # GradeMergedReads.parseInsert:244-256); fall back to the
        # per-mate span heuristic when absent
        eq = rec.id.find("insert=")
        if eq >= 0:
            j = eq + 7
            end = j
            while end < len(rec.id) and rec.id[end].isdigit():
                end += 1
            try:
                insert = int(rec.id[j:end])
            except ValueError:
                continue
            total += 1
            if len(rec.bases) == insert:
                correct += 1
            else:
                incorrect += 1
            continue
        parts = rec.id.split("_")
        if len(parts) < 5 or not parts[1].startswith("chr"):
            continue
        try:
            start, stop = int(parts[3]), int(parts[4])
        except ValueError:
            continue
        total += 1
        if len(rec.bases) >= (stop - start + 1):
            loose += 1
            correct += 1
    print(f"Merged reads graded:\t{total}")
    print(f"Correct:            \t{correct}\t"
          f"{100.0*correct/max(1,total):.3f}%")
    if incorrect:
        print(f"Incorrect:          \t{incorrect}\t"
              f"{100.0*incorrect/max(1,total):.3f}%")
    return 0


TOOLS = dict(sortsam=sortsam, sortbyname=sortbyname,
             grademerge=grademerge)


def main(argv: List[str]) -> int:
    if not argv or argv[0] not in TOOLS:
        print("sort tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])
