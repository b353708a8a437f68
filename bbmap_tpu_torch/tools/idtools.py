"""Alignment-flavored small tools: idmatrix, idtree, msa (FindPrimers),
cutprimers, commonkmers.

reference: jgi/IdentityMatrix.java (idmatrix.sh), tax/IDTree.java
(idtree.sh), jgi/FindPrimers.java (msa.sh), jgi/CutPrimers.java
(cutprimers.sh), jgi/CommonKmers.java (commonkmers.sh).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from ..io import fastx
from ..utils.args import Args


def idmatrix(argv: List[str]) -> int:
    """reference: jgi/IdentityMatrix.java — all-to-all banded edit
    alignment; identity = 1 - edits/max(len). Output rows: name then
    identity per sequence (TSV)."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    percent = args.get_bool("percent", default=False)
    edits_cap = args.get_int("edits", default=0)
    if inp is None:
        print("Usage: idmatrix in=<file> out=<file>", file=sys.stderr)
        return 1
    from ..ops.banded import banded_edit_distance
    recs = list(fastx.read_seqs(inp))
    n = len(recs)
    arrs = [np.frombuffer(r.bases.upper(), np.uint8) for r in recs]
    maxlen = max((len(a) for a in arrs), default=0)
    cap = edits_cap if edits_cap > 0 else maxlen
    mat = np.ones((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            m = max(len(arrs[i]), len(arrs[j]))
            ed = banded_edit_distance(arrs[i], arrs[j], cap)
            ident = 1.0 - min(ed, m) / max(1, m)
            mat[i, j] = mat[j, i] = ident
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    scale, fmtc = (100.0, "{:.2f}") if percent else (1.0, "{:.4f}")
    for i, r in enumerate(recs):
        row = "\t".join(fmtc.format(mat[i, j] * scale)
                        for j in range(n))
        oh.write(f"{r.id.split()[0]}\t{row}\n")
    if out:
        oh.close()
    return 0


def idtree(argv: List[str]) -> int:
    """reference: tax/IDTree.java (idtree.sh) — UPGMA joining over an
    identity matrix (distance = 1 - identity), Newick output."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    if inp is None:
        print("Usage: idtree in=<matrix.tsv> out=<tree.nwk>",
              file=sys.stderr)
        return 1
    names: List[str] = []
    rows: List[List[float]] = []
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            names.append(f[0])
            rows.append([float(x) for x in f[1:]])
    n = len(names)
    d = 1.0 - np.asarray(rows, float)
    if np.nanmax(d) > 1.0:            # percent-format matrix
        d = d + 1.0 - 1.0
        d = (100.0 - np.asarray(rows, float)) / 100.0
    # UPGMA
    active = list(range(n))
    labels = {i: names[i] for i in range(n)}
    heights = {i: 0.0 for i in range(n)}
    sizes = {i: 1 for i in range(n)}
    dm: Dict[tuple, float] = {}
    for i in range(n):
        for j in range(i + 1, n):
            dm[(i, j)] = float(d[i, j])
    nxt = n
    while len(active) > 1:
        best = None
        for ii, i in enumerate(active):
            for j in active[ii + 1:]:
                key = (min(i, j), max(i, j))
                v = dm[key]
                if best is None or v < best[0]:
                    best = (v, i, j)
        v, i, j = best
        h = v / 2.0
        bi = max(0.0, h - heights[i])
        bj = max(0.0, h - heights[j])
        labels[nxt] = (f"({labels[i]}:{bi:.4f},{labels[j]}:{bj:.4f})")
        heights[nxt] = h
        sizes[nxt] = sizes[i] + sizes[j]
        for k in active:
            if k in (i, j):
                continue
            ki = dm[(min(k, i), max(k, i))]
            kj = dm[(min(k, j), max(k, j))]
            dm[(min(k, nxt), max(k, nxt))] = (
                ki * sizes[i] + kj * sizes[j]) / (sizes[i] + sizes[j])
        active = [k for k in active if k not in (i, j)] + [nxt]
        nxt += 1
    tree = labels[active[0]] + ";" if active else ";"
    if out:
        with fastx.xopen(out, "wt") as oh:
            oh.write(tree + "\n")
    else:
        print(tree)
    return 0


def msa(argv: List[str]) -> int:
    """reference: jgi/FindPrimers.java (msa.sh) — align query literals
    to every reference sequence with the MultiStateAligner; emit the
    best-scoring position per reference as a SAM line."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    literals = args.get("literal", "query")
    qfile = args.get("ref", "queryfile")
    if inp is None or (literals is None and qfile is None):
        print("Usage: msa in=<file> out=<sam> literal=<ACGT,...>",
              file=sys.stderr)
        return 1
    queries: List[bytes] = []
    qnames: List[str] = []
    if literals:
        for i, lit in enumerate(literals.split(",")):
            queries.append(lit.upper().encode())
            qnames.append(f"query{i + 1}")
    if qfile:
        for rec in fastx.read_seqs(qfile):
            queries.append(rec.bases.upper())
            qnames.append(rec.id.split()[0])
    from ..io.sam import match_to_cigar
    from ..ops import msa_ref
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    oh.write("@HD\tVN:1.4\tSO:unsorted\n")
    recs = list(fastx.read_seqs(inp))
    for rec in recs:
        name = rec.id.split()[0]
        oh.write(f"@SQ\tSN:{name}\tLN:{len(rec.bases)}\n")
    for rec in recs:
        ref = np.frombuffer(rec.bases.upper(), np.uint8)
        best = None
        for q, qn in zip(queries, qnames):
            read = np.frombuffer(q, np.uint8)
            score, start, match = msa_ref.align(read, ref)
            if best is None or score > best[0]:
                best = (score, start, match, q, qn)
        if best is None:
            continue
        score, start, match, q, qn = best
        ref_len = sum(1 for ch in match if ch in b"mSDN")
        cigar = match_to_cigar(match, start, start + ref_len - 1,
                               len(rec.bases))
        oh.write(f"{qn}\t0\t{rec.id.split()[0]}\t{start + 1}\t"
                 f"{min(41, max(0, score // max(1, len(q))))}\t{cigar}"
                 f"\t*\t0\t0\t{q.decode()}\t*\tYI:f:"
                 f"{100.0 * score / max(1, 100 * len(q)):.2f}\n")
    if out:
        oh.close()
    return 0


def cutprimers(argv: List[str]) -> int:
    """reference: jgi/CutPrimers.java — cut the sequence between primer
    sites identified in two sam files (msa.sh output), per reference
    sequence."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    sam1 = args.get("sam1")
    sam2 = args.get("sam2")
    fake = args.get_bool("fake", default=True)
    include = args.get_bool("include", default=False)
    if None in (inp, out, sam1, sam2):
        print("Usage: cutprimers in= out= sam1= sam2=",
              file=sys.stderr)
        return 1

    def load_sites(path):
        sites = {}
        from ..io.sam import open_sam_lines
        for line in open_sam_lines(path):
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 10 or f[2] == "*":
                continue
            pos = int(f[3])
            # ref bases consumed from cigar
            import re
            reflen = sum(int(x) for x, op in
                         re.findall(r"(\d+)([MDN=X])", f[5]))
            sites[f[2]] = (pos, pos + reflen - 1)
        return sites

    s1 = load_sites(sam1)
    s2 = load_sites(sam2)

    def gen():
        for rec in fastx.read_seqs(inp):
            name = rec.id.split()[0]
            a = s1.get(name)
            b = s2.get(name)
            if a is None or b is None:
                if fake:
                    yield fastx.SeqRecord(id=rec.id, bases=b"N")
                continue
            if include:
                lo, hi = a[0], b[1]
            else:
                lo, hi = a[1] + 1, b[0] - 1
            lo = max(1, lo)
            hi = min(len(rec.bases), hi)
            if hi < lo:
                if fake:
                    yield fastx.SeqRecord(id=rec.id, bases=b"N")
                continue
            q = rec.quality[lo - 1:hi] if rec.quality else None
            yield fastx.SeqRecord(id=rec.id, bases=rec.bases[lo - 1:hi],
                                  quality=q)
    fmt = fastx.sniff_format(out)
    if fmt == "fastq":
        fastx.write_fastq(out, gen())
    else:
        fastx.write_fasta(out, gen())
    return 0


def commonkmers(argv: List[str]) -> int:
    """reference: jgi/CommonKmers.java — print the most common short
    canonical kmers per sequence (k<=12)."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    k = args.get_int("k", default=2)
    display = args.get_int("display", default=3)
    show_count = args.get_bool("count", default=False)
    if inp is None or not (0 < k <= 12):
        print("Usage: commonkmers in=<file> out=<file> k=<1-12>",
              file=sys.stderr)
        return 1
    from ..core.bases import COMP_ASCII
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    code = np.full(256, -1, np.int8)
    for i, ch in enumerate(b"ACGT"):
        code[ch] = i
    for rec in fastx.read_seqs(inp):
        b = np.frombuffer(rec.bases.upper(), np.uint8)
        c = code[b]
        n = len(c) - k + 1
        counts: Dict[bytes, int] = {}
        if n > 0:
            valid = np.ones(n, bool)
            km = np.zeros(n, np.int64)
            for i in range(k):
                ci = c[i:i + n]
                valid &= ci >= 0
                km = km * 4 + np.maximum(ci, 0)
            # canonical: min(kmer, rc)
            rc = np.zeros(n, np.int64)
            for i in range(k):
                ci = 3 - c[i:i + n]
                rc = rc + (np.maximum(ci, 0).astype(np.int64)
                           << (2 * i))
            canon = np.minimum(km, rc)[valid]
            uniq, cnt = np.unique(canon, return_counts=True)
            order = np.lexsort((uniq, -cnt))
            lut = np.frombuffer(b"ACGT", np.uint8)
            for idx in order[:display]:
                v = int(uniq[idx])
                s = bytes(lut[(v >> (2 * (k - 1 - i))) & 3]
                          for i in range(k)).decode()
                counts[s] = int(cnt[idx])
        items = "\t".join(
            (f"{s}={c2}" if show_count else s)
            for s, c2 in counts.items())
        oh.write(f"{rec.id.split()[0]}\t{items}\n")
    if out:
        oh.close()
    return 0
