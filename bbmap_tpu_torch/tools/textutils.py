"""Text utilities from the reference's driver/ grab-bag.

reference: driver/ConcatenateTextFiles.java, driver/FilterLines.java,
driver/CountSharedLines.java, driver/ReplaceHeaders.java — small
file-manipulation helpers shipped with BBTools.
"""

from __future__ import annotations

import sys
from typing import List

from ..io import fastx
from ..utils.args import Args


def concatenatetextfiles(argv: List[str]) -> int:
    """reference: driver/ConcatenateTextFiles.java — merge files (gz
    transparent) into one output."""
    args = Args.parse(argv)
    out = args.get("out")
    ins = args.get("in")
    paths = (ins.split(",") if ins else []) + list(args.positional)
    if out in paths:
        paths.remove(out)
    if not paths or out is None:
        print("Usage: concatenatetextfiles in=a.txt,b.txt out=c.txt",
              file=sys.stderr)
        return 1
    n = 0
    with fastx.xopen(out, "wb") as o:
        for p in paths:
            with fastx.xopen(p, "rb") as fh:
                data = fh.read()
                n += data.count(b"\n")
                o.write(data)
                if data and not data.endswith(b"\n"):
                    o.write(b"\n")
    sys.stderr.write(f"Lines:\t{n}\n")
    return 0


def filterlines(argv: List[str]) -> int:
    """reference: driver/FilterLines.java — keep/toss lines matching
    substrings (names=, include=t/f, casesensitive=)."""
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    names = args.get("names", "name")
    include = args.get_bool("include", "retain", default=False)
    case = args.get_bool("casesensitive", "case", default=True)
    prefix = args.get_bool("prefix", default=False)
    if inp is None or out is None or names is None:
        print("Usage: filterlines in=file out=file names=a,b "
              "include=f", file=sys.stderr)
        return 1
    pats = names.split(",")
    if not case:
        pats = [p.lower() for p in pats]
    kept = total = 0
    with fastx.xopen(inp, "rt") as fh, fastx.xopen(out, "wt") as o:
        for line in fh:
            total += 1
            probe = line if case else line.lower()
            if prefix:
                hit = any(probe.startswith(p) for p in pats)
            else:
                hit = any(p in probe for p in pats)
            if hit == include:
                o.write(line)
                kept += 1
    sys.stderr.write(f"Lines in:\t{total}\nLines kept:\t{kept}\n")
    return 0


def countsharedlines(argv: List[str]) -> int:
    """reference: driver/CountSharedLines.java — count lines shared
    between two files."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2") or (args.positional[1]
                              if len(args.positional) > 1 else None)
    if in1 is None or in2 is None:
        print("Usage: countsharedlines in1=a in2=b", file=sys.stderr)
        return 1
    with fastx.xopen(in1, "rt") as fh:
        s1 = set(line.rstrip("\n") for line in fh)
    shared = total2 = 0
    with fastx.xopen(in2, "rt") as fh:
        for line in fh:
            total2 += 1
            if line.rstrip("\n") in s1:
                shared += 1
    print(f"Lines in file 1:\t{len(s1)}")
    print(f"Lines in file 2:\t{total2}")
    print(f"Shared lines:\t{shared}")
    return 0


def replaceheaders(argv: List[str]) -> int:
    """reference: driver/ReplaceHeaders.java — replace read headers
    from a list file (hin=) or with a prefix+counter (prefix=)."""
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    hin = args.get("hin", "headers")
    prefix = args.get("prefix")
    if inp is None or out is None or (hin is None and prefix is None):
        print("Usage: replaceheaders in= out= (hin=headers.txt | "
              "prefix=read)", file=sys.stderr)
        return 1
    headers = None
    if hin:
        with fastx.xopen(hin, "rt") as fh:
            headers = [line.rstrip("\n").lstrip("@>") for line in fh
                       if line.strip()]
    n = 0
    fmt = fastx.sniff_format(inp)
    with fastx.xopen(out, "wb") as o:
        for rec in fastx.read_seqs(inp):
            if headers is not None:
                name = headers[n] if n < len(headers) else rec.id
            else:
                name = f"{prefix}{n}"
            n += 1
            if fmt == "fasta":
                o.write(b">" + name.encode() + b"\n" + rec.bases
                        + b"\n")
            else:
                q = rec.quality if rec.quality is not None \
                    else b"I" * len(rec.bases)
                o.write(b"@" + name.encode() + b"\n" + rec.bases
                        + b"\n+\n" + q + b"\n")
    sys.stderr.write(f"Reads:\t{n}\n")
    return 0


def statswrapper(argv: List[str]) -> int:
    """reference: sh/statswrapper.sh — assembly stats over many files,
    one table row per file."""
    from . import stats as stats_tool
    args = Args.parse(argv)
    ins = args.get("in")
    paths = (ins.split(",") if ins else []) + list(args.positional)
    if not paths:
        print("Usage: statswrapper in=a.fa,b.fa", file=sys.stderr)
        return 1
    for p in paths:
        print(f"==> {p}")
        stats_tool.main([f"in={p}"])
    return 0


def grep(argv: List[str]) -> int:
    """Regex line filter (reference: driver/Grep.java — args: file,
    regex; prints matching lines)."""
    import re
    args = Args.parse(argv)
    in1 = args.get("in") or (args.positional[0]
                             if args.positional else None)
    pattern = args.get("regex", "pattern") or (
        args.positional[1] if len(args.positional) > 1 else None)
    out = args.get("out")
    invert = args.get_bool("invert", "v", default=False)
    if in1 is None or pattern is None:
        print("Usage: grep <file> <regex> [out=] [invert=t]",
              file=sys.stderr)
        return 1
    rx = re.compile(pattern)
    ofh = open(out, "w") if out else sys.stdout
    n = 0
    with fastx.xopen(in1, "rt") as fh:
        for line in fh:
            if bool(rx.search(line)) != invert:
                ofh.write(line)
                n += 1
    if out:
        ofh.close()
    sys.stderr.write(f"Matched:\t{n}\n")
    return 0


def linecount(argv: List[str]) -> int:
    """reference: driver/LineCount.java."""
    args = Args.parse(argv)
    paths = ([args.get("in")] if args.get("in") else args.positional)
    if not paths:
        print("Usage: linecount <files...>", file=sys.stderr)
        return 1
    for p in paths:
        n = 0
        with fastx.xopen(p, "rt") as fh:
            for _ in fh:
                n += 1
        print(f"{p}\t{n}")
    return 0


def renamebyheader(argv: List[str]) -> int:
    """Rename reads from a mapping file of old->new names (reference:
    driver/RenameByHeader.java)."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    names = args.get("names", "map")
    out = args.get("out")
    prefix = args.get("prefix")
    if in1 is None or out is None or (names is None and prefix is None):
        print("Usage: renamebyheader in=<reads> out=<reads> "
              "names=<old<TAB>new per line> | prefix=<str>",
              file=sys.stderr)
        return 1
    mapping = {}
    if names:
        with open(names) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) >= 2:
                    mapping[f[0]] = f[1]
    fmt = fastx.sniff_format(in1)
    with fastx.xopen(out, "wb") as ofh:
        n = 0
        for rec in fastx.read_seqs(in1):
            new = mapping.get(rec.id.split()[0])
            if new is None:
                new = (prefix + rec.id) if prefix else rec.id
            if fmt == "fasta":
                ofh.write(b">" + new.encode() + b"\n" + rec.bases
                          + b"\n")
            else:
                q = rec.quality or b"I" * len(rec.bases)
                ofh.write(b"@" + new.encode() + b"\n" + rec.bases
                          + b"\n+\n" + q + b"\n")
            n += 1
    sys.stderr.write(f"Renamed:\t{n}\n")
    return 0
