"""Pair handling + name-based utilities: splitpairs, repair, filterbyname,
demuxbyname.

reference: jgi/SplitPairsAndSingles.java (bbsplitpairs.sh),
jgi/DemuxByName.java, FilterReadsByName.java.

The port's copy of the JAX package's tools: ``device=`` (default cuda)
names the torch device of splitnexteralmp's junction k-mer scan.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Set

from ..io import fastx
from ..utils.args import Args


def _core_name(name: str) -> str:
    n = name.split()[0]
    if len(n) > 2 and n[-2] == "/" and n[-1] in "12":
        return n[:-2]
    return n


def _wfq(fh, rec):
    q = rec.quality if rec.quality is not None else b"I" * len(rec.bases)
    fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n" + q
             + b"\n")


def splitpairs(argv: List[str]) -> int:
    """Separate interleaved input into proper pairs and singletons; also
    re-pairs out-of-order mates (reference: jgi/SplitPairsAndSingles
    repair mode)."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1")
    out = args.get("out", "outpair")
    outs = args.get("outs", "outsingle", "outb")
    repair = args.get_bool("repair", "fixinterleaving", "fint",
                           default=True)
    if in1 is None:
        print("Usage: splitpairs in=<interleaved> out=pairs.fq "
              "outs=singles.fq", file=sys.stderr)
        return 1
    pending: Dict[str, fastx.SeqRecord] = {}
    out_fh = fastx.xopen(out, "wb") if out else None
    outs_fh = fastx.xopen(outs, "wb") if outs else None
    pairs = singles = 0
    for rec in fastx.read_seqs(in1):
        core = _core_name(rec.id)
        if core in pending:
            mate = pending.pop(core)
            if out_fh:
                _wfq(out_fh, mate)
                _wfq(out_fh, rec)
            pairs += 2
        else:
            pending[core] = rec
    for rec in pending.values():
        if outs_fh:
            _wfq(outs_fh, rec)
        singles += 1
    for fh in (out_fh, outs_fh):
        if fh:
            fh.close()
    sys.stderr.write(f"Pairs:\t{pairs}\nSingletons:\t{singles}\n")
    return 0


def filterbyname(argv: List[str]) -> int:
    """Keep or exclude reads by name list
    (reference: FilterReadsByName, filterbyname.sh)."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1")
    out = args.get("out")
    names_arg = args.get("names")
    include = args.get_bool("include", default=False)
    substring = args.get_bool("substring", default=False)
    if in1 is None or out is None or names_arg is None:
        print("Usage: filterbyname in= out= names=<file|list> "
              "include=f", file=sys.stderr)
        return 1
    names: Set[str] = set()
    import os
    for tok in names_arg.split(","):
        if os.path.exists(tok):
            with fastx.xopen(tok, "rt") as fh:
                for line in fh:
                    names.add(line.strip())
        else:
            names.add(tok)
    out_fh = fastx.xopen(out, "wb")
    kept = 0
    fmt = fastx.sniff_format(in1)
    for rec in fastx.read_seqs(in1):
        nm = rec.id
        if substring:
            hit = any(s in nm for s in names)
        else:
            hit = nm in names or nm.split()[0] in names
        if hit == include:
            kept += 1
            if fmt == "fasta":
                out_fh.write(b">" + rec.id.encode() + b"\n" + rec.bases
                             + b"\n")
            else:
                _wfq(out_fh, rec)
    out_fh.close()
    sys.stderr.write(f"Kept:\t{kept}\n")
    return 0


def demuxbyname(argv: List[str]) -> int:
    """Route reads to files by name suffix/prefix/barcode
    (reference: jgi/DemuxByName.java)."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1")
    pattern = args.get("out", "pattern")
    names_arg = args.get("names")
    suffix = args.get_bool("suffixmode", "suffix", default=False)
    delimiter = args.get("delimiter")
    if in1 is None or pattern is None or "%" not in (pattern or ""):
        print("Usage: demuxbyname in= out=out_%.fq names=a,b,c "
              "[suffixmode=t] [delimiter=:]", file=sys.stderr)
        return 1
    keys = names_arg.split(",") if names_arg else None
    fhs: Dict[str, object] = {}
    counts: Dict[str, int] = {}
    for rec in fastx.read_seqs(in1):
        nm = rec.id.split()[0]
        key = None
        if delimiter:
            key = rec.id.split(delimiter)[-1]
        elif keys:
            for cand in keys:
                if (nm.endswith(cand) if suffix else nm.startswith(cand)):
                    key = cand
                    break
        if key is None:
            continue
        if key not in fhs:
            fhs[key] = fastx.xopen(pattern.replace("%", key), "wb")
        _wfq(fhs[key], rec)
        counts[key] = counts.get(key, 0) + 1
    for fh in fhs.values():
        fh.close()
    for key, cnt in sorted(counts.items()):
        sys.stderr.write(f"{key}\t{cnt}\n")
    return 0


TOOLS = dict(splitpairs=splitpairs, filterbyname=filterbyname,
             demuxbyname=demuxbyname)


def main(argv: List[str]) -> int:
    if not argv or argv[0] not in TOOLS:
        print("pair tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))



# Nextera LMP junction adapter (reference: jgi/SplitNexteraLMP.java:601
# default literal — the full 38 bp palindromic junction)
NEXTERA_JUNCTION = b"CTGTCTCTTATACACATCTAGATGTGTATAAGAGACAG"


class _JunctionMasker:
    """K-mer junction detector (reference: SplitNexteraLMP loads the
    junction literal into kmer tables at k=19 mink=11 hdist=1 and
    kMasks each read; the first/last masked index split the read)."""

    def __init__(self, literals: List[bytes], k: int = 19,
                 mink: int = 11, hdist: int = 1, *, device):
        from ..index import kmerset
        self.ks = kmerset.build_kmer_set(
            literals, k=k, mink=mink, hdist=hdist, mask_middle=True)
        self.k = k
        self.mink = mink
        self.device = device
        self._scan = kmerset.scan_batch
        self._tips = kmerset.scan_tips

    def span(self, bases: bytes):
        """(start, stop) of the masked junction span, or (-1, -1)."""
        import numpy as np
        arr = np.frombuffer(bases, np.uint8)[None, :]
        L = arr.shape[1]
        if L < self.mink:
            return -1, -1
        first = last = -1
        if L >= self.k:
            hits, _ids = self._scan(self.ks, arr, self.device)
            pos = np.nonzero(hits[0])[0]
            if pos.size:
                first = int(pos[0])
                last = int(pos[-1]) + self.k - 1
        # tip kmers (mink..k-1) extend the mask to read edges
        lengths = np.array([L], np.int32)
        tl = int(self._tips(self.ks, arr, lengths, "l")[0])
        if tl > 0:
            first = 0
            last = max(last, tl - 1)
        tr = int(self._tips(self.ks, arr, lengths, "r")[0])
        if tr >= 0:
            last = max(last, L - 1)
            if first < 0:
                first = tr
        return first, last


def splitnexteralmp(argv: List[str]) -> int:
    """splitnexteralmp: split Nextera Long-Mate-Pair reads at the
    junction adapter into mate pairs.

    reference: jgi/SplitNexteraLMP.java + sh/splitnexteralmp.sh. The
    junction literal (k=19/mink=11/hdist=1 tables) is located in each
    read; reads/pairs are classified per the reference's
    processReadPair:409-536: outer LMP (r1-left + r2-right-part),
    inner LMP (useinnerlmp=t), left/right fragment pairs, singletons,
    junction-free pairs -> unknown. Note the reference does NOT
    reverse-complement the split halves — LMP mates stay
    outward-facing; r2's left/right roles are swapped because mate 2
    is already reversed (SplitNexteraLMP.java:446-451)."""
    from ..io import fastx
    from ..utils.args import Args

    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out1 = args.get("out", "out1")
    out2 = args.get("out2")
    outf = args.get("outf", "outfrag", "outf1")
    outu = args.get("outu", "outunknown")
    outs = args.get("outs", "outsingle")
    stats = args.get("stats")
    minlen = args.get_int("minlength", "minlen", "ml", default=40)
    inner = args.get_bool("useinnerlmp", "innerlmp", default=False)
    interleaved = args.get_bool("interleaved", "int", default=False)
    hdist = args.get_int("hdist", default=1)
    lit = args.get("literal")
    literals = [x.encode() for x in lit.split(",")] if lit \
        else [NEXTERA_JUNCTION]
    if in1 is None or out1 is None:
        print("Usage: splitnexteralmp in=<reads.fq> [in2=] out=<lmp> "
              "[outf=frag] [outu=unknown] [outs=single] [minlen=40]",
              file=sys.stderr)
        return 1
    masker = _JunctionMasker(literals, hdist=hdist,
                             device=args.get("device", default="cuda"))

    o1 = fastx.xopen(out1, "wb")
    o2 = fastx.xopen(out2, "wb") if out2 else None
    of = fastx.xopen(outf, "wb") if outf else None
    ou = fastx.xopen(outu, "wb") if outu else None
    os_ = fastx.xopen(outs, "wb") if outs else None
    n = {"reads_in": 0, "bases_in": 0, "lmp_r": 0, "lmp_b": 0,
         "frag_r": 0, "frag_b": 0, "unk_r": 0, "unk_b": 0,
         "single_r": 0, "single_b": 0, "sought": 0, "detected": 0}

    def wr(fh, name, seq, qual, alt=None):
        fh = fh if fh is not None else alt
        if fh is None:
            return
        q = qual if qual is not None and len(qual) == len(seq) \
            else b"I" * len(seq)
        fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n" + q
                 + b"\n")

    def sub(rec, a, b):
        """(bases, qual, length) slice a..b (exclusive)."""
        return (rec.bases[a:b],
                rec.quality[a:b] if rec.quality else None)

    def emit_pair(cat, fh1, fh2, name, p1, p2):
        n[cat + "_r"] += 2
        n[cat + "_b"] += len(p1[0]) + len(p2[0])
        wr(fh1, name + " 1:", p1[0], p1[1])
        wr(fh2 if fh2 is not None else fh1, name + " 2:", p2[0], p2[1])

    def emit_single(p, name):
        n["single_r"] += 1
        n["single_b"] += len(p[0])
        wr(os_, name, p[0], p[1], alt=o1)

    def process_pair(r1, r2):
        n["reads_in"] += 2
        n["bases_in"] += len(r1.bases) + len(r2.bases)
        n["sought"] += 1
        s1, e1 = masker.span(r1.bases)
        s2, e2 = masker.span(r2.bases)
        if s1 < 0 and s2 < 0:
            n["unk_r"] += 2
            n["unk_b"] += len(r1.bases) + len(r2.bases)
            wr(ou, r1.id + " 1:", r1.bases, r1.quality, alt=o1)
            wr(ou, r2.id + " 2:", r2.bases, r2.quality, alt=o1)
            return
        n["detected"] += 1
        r1left = r1right = r2left = r2right = None
        if s1 >= 0:
            if s1 >= minlen:
                r1left = sub(r1, 0, s1)
            if len(r1.bases) - e1 - 1 >= minlen:
                r1right = sub(r1, e1 + 1, len(r1.bases))
        else:
            r1left = sub(r1, 0, len(r1.bases))
        if s2 >= 0:
            # mate 2 is already reversed: its LEFT part plays the
            # "right" role and vice versa (reference :446-451)
            if len(r2.bases) - e2 - 1 >= minlen:
                r2left = sub(r2, e2 + 1, len(r2.bases))
            if s2 >= minlen:
                r2right = sub(r2, 0, s2)
        else:
            r2right = sub(r2, 0, len(r2.bases))
        if s1 < 0:
            r1right = None
        if s2 < 0:
            r2left = None
        name = r1.id
        if r1left and r2right:                        # outer LMP
            emit_pair("lmp", o1, o2, name, r1left, r2right)
            r1left = r2right = None
        if r1right and r2left and inner:              # inner LMP
            emit_pair("lmp", o1, o2, name, r1right, r2left)
            r1right = r2left = None
        if r1left and r2left:                         # left frag
            emit_pair("frag", of if of else o1,
                      None if of else o2, name, r1left, r2left)
            r1left = r2left = None
        if r1right and r2right:                       # right frag
            emit_pair("frag", of if of else o1,
                      None if of else o2, name, r1right, r2right)
            r1right = r2right = None
        for p in (r1left, r1right, r2left, r2right):
            if p:
                emit_single(p, name)

    def process_single(r1):
        n["reads_in"] += 1
        n["bases_in"] += len(r1.bases)
        n["sought"] += 1
        s1, e1 = masker.span(r1.bases)
        if s1 < 0:
            emit_single(sub(r1, 0, len(r1.bases)), r1.id)
            return
        n["detected"] += 1
        left = sub(r1, 0, s1) if s1 >= minlen else None
        right = sub(r1, e1 + 1, len(r1.bases)) \
            if len(r1.bases) - e1 - 1 >= minlen else None
        if left and right:
            emit_pair("lmp", o1, o2, r1.id, left, right)
        elif left:
            emit_single(left, r1.id)
        elif right:
            emit_single(right, r1.id)

    if in2:
        for r1, r2 in zip(fastx.read_seqs(in1), fastx.read_seqs(in2)):
            process_pair(r1, r2)
    elif interleaved:
        prev = None
        for rec in fastx.read_seqs(in1):
            if prev is None:
                prev = rec
            else:
                process_pair(prev, rec)
                prev = None
        if prev is not None:
            process_single(prev)
    else:
        for rec in fastx.read_seqs(in1):
            process_single(rec)

    for fh in (o1, o2, of, ou, os_):
        if fh is not None:
            fh.close()
    bmult = 100.0 / max(1, n["bases_in"])
    rmult = 100.0 / max(1, n["reads_in"])
    recovered = (n["lmp_b"] + n["frag_b"] + n["unk_b"]
                 + n["single_b"])
    lines = [
        "Long Mate Pairs:        \t%d reads (%.2f%%) \t%d bases "
        "(%.2f%%)" % (n["lmp_r"], n["lmp_r"] * rmult, n["lmp_b"],
                      n["lmp_b"] * bmult),
        "Fragment Pairs:         \t%d reads (%.2f%%) \t%d bases "
        "(%.2f%%)" % (n["frag_r"], n["frag_r"] * rmult, n["frag_b"],
                      n["frag_b"] * bmult),
        "Unknown Pairs:          \t%d reads (%.2f%%) \t%d bases "
        "(%.2f%%)" % (n["unk_r"], n["unk_r"] * rmult, n["unk_b"],
                      n["unk_b"] * bmult),
        "Singletons:             \t%d reads (%.2f%%) \t%d bases "
        "(%.2f%%)" % (n["single_r"], n["single_r"] * rmult,
                      n["single_b"], n["single_b"] * bmult),
        "",
        "Adapters Detected:      \t%d (%.2f%%)"
        % (n["detected"], n["detected"] * 100.0 / max(1, n["sought"])),
        "Bases Recovered:        \t%d (%.2f%%)"
        % (recovered, recovered * bmult),
    ]
    text = "\n".join(lines) + "\n"
    if stats:
        with open(stats, "w") as fh:
            fh.write(text)
    sys.stderr.write(text)
    return 0
