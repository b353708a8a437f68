"""Barcode suite: countbarcodes / mergebarcodes / correlatebarcodes
(filterbarcodes) / removebadbarcodes.

reference: jgi/CountBarcodes.java, jgi/MergeBarcodes.java,
jgi/CorrelateBarcodes.java (sh/filterbarcodes.sh runs this class),
jgi/RemoveBadBarcodes.java.

Barcode conventions (Illumina): the index sequence is the read-id
suffix after the last ':' (count/removebad); mergebarcodes prepends
"BAR_QUAL+33_" to the id from a separate barcode fastq;
correlatebarcodes parses that "BAR_QUAL_" prefix back.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from ..io import fastx
from ..utils.args import Args

_DEF = set(b"ACGTUacgtu")


def _barcode_of(read_id: str) -> Optional[str]:
    loc = read_id.rfind(":")
    if loc < 0 or loc >= len(read_id) - 1:
        return None
    return read_id[loc + 1:]


def _hdist(a: str, b: str) -> int:
    if len(a) != len(b):
        return max(len(a), len(b))
    return sum(1 for x, y in zip(a, b) if x != y)


def _edist(a: str, b: str) -> int:
    """Levenshtein (reference: CountBarcodes.calcEdist)."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[lb]


def _load_codes(val: Optional[str]) -> List[str]:
    import os
    out: List[str] = []
    if not val:
        return out
    for part in val.split(","):
        if os.path.exists(part):
            with open(part) as fh:
                for line in fh:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        out.append(line.split()[0])
        else:
            out.append(part)
    return out


def countbarcodes(argv: List[str]) -> int:
    """reference: jgi/CountBarcodes.java + sh/countbarcodes.sh. Counts
    read-header barcodes; table: code, count, Hamming/edit distance to
    the nearest expected code, validity."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "counts")
    if in1 is None:
        print("Usage: countbarcodes in=<file> out=<counts.txt> "
              "[expected=<codes>] [valid=<codes>] [maxrows=N]",
              file=sys.stderr)
        return 1
    expected = _load_codes(args.get("expected"))
    valid = set(_load_codes(args.get("valid")) + expected)
    maxrows = args.get_int("maxrows", default=-1)
    count_undefined = args.get_bool("countundefined", default=True)
    printheader = args.get_bool("printheader", default=True)

    counts: Dict[str, int] = {}
    n_reads = 0
    for rec in fastx.read_seqs(in1):
        n_reads += 1
        code = _barcode_of(rec.id)
        if code is None:
            continue
        if not count_undefined and any(
                c not in "ACGTU+" for c in code.upper()):
            continue
        counts[code] = counts.get(code, 0) + 1
    order = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    lines = []
    if printheader:
        lines.append("#code\tcount\tHamming_dist\tedit_dist\tvalid")
    rows = 0
    for code, n in order:
        if maxrows >= 0 and rows >= maxrows:
            break
        rows += 1
        hd = min((_hdist(code, e) for e in expected), default=0)
        ed = hd
        if hd > 1 and expected:
            ed = min(_edist(code, e) for e in expected)
        lines.append(f"{code}\t{n}\t{hd}\t{ed}\t"
                     f"{'valid' if code in valid else ''}")
    text = "\n".join(lines) + "\n"
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    sys.stderr.write(f"Reads:\t{n_reads}\nCodes:\t{len(counts)}\n")
    return 0


def removebadbarcodes(argv: List[str]) -> int:
    """reference: jgi/RemoveBadBarcodes.java:44-61 — keep reads whose
    header barcode is fully defined (ACGTU or '+'); drop the rest."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "out1")
    if in1 is None:
        print("Usage: removebadbarcodes in=<file> out=<file>",
              file=sys.stderr)
        return 1
    good = bad = nobar = 0
    out_fh = fastx.xopen(out, "wb") if out else None

    def write(rec):
        if out_fh is None:
            return
        if rec.quality is not None:
            out_fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases
                         + b"\n+\n" + rec.quality + b"\n")
        else:
            out_fh.write(b">" + rec.id.encode() + b"\n" + rec.bases
                         + b"\n")

    for rec in fastx.read_seqs(in1):
        code = _barcode_of(rec.id)
        if code is None:
            nobar += 1
            continue
        if all(c == "+" or ord(c) in _DEF for c in code):
            good += 1
            write(rec)
        else:
            bad += 1
    if out_fh:
        out_fh.close()
    sys.stderr.write(f"Good:               {good}\n"
                     f"Bad:                {bad}\n"
                     f"No Barcode:         {nobar}\n")
    return 0


def mergebarcodes(argv: List[str]) -> int:
    """reference: jgi/MergeBarcodes.java:293-409 — prepend each read's
    barcode (from bar=<fastq>, matched by read id) as 'BAR_QUAL_' to the
    read id."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    bar = args.get("bar", "barcode", "index")
    out = args.get("out", "out1")
    if in1 is None or bar is None:
        print("Usage: mergebarcodes in=<file> bar=<barcode fastq> "
              "out=<file>", file=sys.stderr)
        return 1
    barmap: Dict[str, object] = {}
    for rec in fastx.read_seqs(bar, fake_quality=30):
        key = rec.id.split(" ")[0]
        barmap[key] = rec
    found = notfound = 0
    out_fh = fastx.xopen(out, "wb") if out else None
    for rec in fastx.read_seqs(in1, fake_quality=30):
        key = rec.id.split(" ")[0]
        b = barmap.get(key)
        if b is not None:
            qual = (b.quality if b.quality is not None
                    else b"I" * len(b.bases))
            new_id = (b.bases.decode() + "_" + qual.decode() + "_"
                      + rec.id)
            found += 1
        else:
            new_id = rec.id
            notfound += 1
        if out_fh is not None:
            out_fh.write(b"@" + new_id.encode() + b"\n" + rec.bases
                         + b"\n+\n"
                         + (rec.quality or b"I" * len(rec.bases))
                         + b"\n")
    if out_fh:
        out_fh.close()
    total = max(1, found + notfound)
    sys.stderr.write(
        f"Barcodes Found:         \t{found} reads "
        f"({100.0 * found / total:.2f}%)\n"
        f"Barcodes Not Found:     \t{notfound} reads "
        f"({100.0 * notfound / total:.2f}%)\n")
    return 0


def correlatebarcodes(argv: List[str]) -> int:
    """reference: jgi/CorrelateBarcodes.java (sh/filterbarcodes.sh):
    parse 'BAR_QUAL_' id prefixes, histogram barcode average/min
    quality, correlate read quality with barcode quality (outcor=), and
    filter by maq=/minq= into out=."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "out1")
    outcor = args.get("outcor")
    aqhist = args.get("aqhist")
    mqhist = args.get("mqhist")
    maq = args.get_int("maq", "minbarcodeaveragequality", default=0)
    minq = args.get_int("minq", "minbarcodeminquality", default=0)
    if in1 is None:
        print("Usage: filterbarcodes in=<file> out=<file> maq=<int>",
              file=sys.stderr)
        return 1

    QMAX = 48
    aq = np.zeros(QMAX, np.int64)
    mq = np.zeros(QMAX, np.int64)
    cor = np.zeros((QMAX, QMAX), np.int64)
    tossed = 0
    processed = 0
    out_fh = fastx.xopen(out, "wb") if out else None

    def avg_q_by_prob(quals: np.ndarray) -> int:
        # reference: Read.avgQualityByProbability — average error
        # probability back-converted to phred
        if len(quals) == 0:
            return 0
        p = np.power(10.0, -quals.astype(np.float64) / 10.0).mean()
        return int(min(QMAX - 1, round(-10.0 * np.log10(max(p, 1e-12)))))

    for rec in fastx.read_seqs(in1, fake_quality=30):
        parts = rec.id.split("_")
        if len(parts) < 2:
            continue
        barquals = np.frombuffer(parts[1].encode(),
                                 np.uint8).astype(np.int32) - 33
        qbar = avg_q_by_prob(barquals)
        minbar = int(barquals.min()) if len(barquals) else 0
        aq[min(qbar, QMAX - 1)] += 1
        mq[min(max(minbar, 0), QMAX - 1)] += 1
        processed += 1
        rq = avg_q_by_prob(
            np.frombuffer(rec.quality, np.uint8).astype(np.int32) - 33
            if rec.quality is not None else np.zeros(0, np.int32))
        cor[rq, qbar] += 1
        if qbar < maq or minbar < minq:
            tossed += 1
            continue
        if out_fh is not None:
            out_fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases
                         + b"\n+\n"
                         + (rec.quality or b"I" * len(rec.bases))
                         + b"\n")
    if out_fh:
        out_fh.close()
    if outcor:
        with open(outcor, "w") as fh:
            fh.write("#Read1_Q\tBar_Q\tstdev\tcount\n")
            for q in range(QMAX):
                n = cor[q].sum()
                if n == 0:
                    continue
                w = cor[q]
                mean = (np.arange(QMAX) * w).sum() / n
                var = ((np.arange(QMAX) - mean) ** 2 * w).sum() / n
                fh.write(f"{q}\t{mean:.2f}\t{np.sqrt(var):.2f}\t{n}\n")
    for path, arr, name in ((aqhist, aq, "avg"), (mqhist, mq, "min")):
        if path:
            with open(path, "w") as fh:
                fh.write(f"#Barcode_{name}_quality\tcount\n")
                for q in range(QMAX):
                    if arr[q]:
                        fh.write(f"{q}\t{arr[q]}\n")
    sys.stderr.write(f"Processed:\t{processed}\nTossed:\t{tossed}\n")
    return 0


filterbarcodes = correlatebarcodes  # sh/filterbarcodes.sh -> same class

TOOLS = dict(countbarcodes=countbarcodes,
             mergebarcodes=mergebarcodes,
             correlatebarcodes=correlatebarcodes,
             filterbarcodes=correlatebarcodes,
             removebadbarcodes=removebadbarcodes)


def main(argv: List[str]) -> int:
    if not argv:
        print("barcode tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
