"""SAM emission: match-string -> CIGAR, MAPQ model, flags, tags, header.

Host-side serialization of device alignment results. Semantics mirror the
reference SAM layer exactly, since the SAM text defines output equivalence:

- CIGAR 1.3 (M) vs 1.4 (=/X) selected by VERSION
  (reference: stream/SamLine.java:600-760, stream/SamHeader.java:28)
- POS from scaffold-relative start + leading clip adjustment
  (reference: stream/SamLine.java:171-260)
- MAPQ model (reference: stream/SamLine.java:1703-1721)
- NM/AM tags on by default, XT:A:R for ambiguous
  (reference: stream/SamLine.java:1481-1560, 2400-2422)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..core.bases import COMP_ASCII
from ..core.genome import Genome

VERSION = 1.4
INTRON_LIMIT = 2 ** 31 - 1
SOFT_CLIP = True
MAKE_NM_TAG = True
MAKE_AM_TAG = True
MAKE_MD_TAG = False
MAKE_XS_TAG = False      # auto-on when INTRON_LIMIT is set
XS_SECONDSTRAND = False  # xstag=ss flips the strand sense
PENALIZE_AMBIG = True

BBMAP_VERSION_STRING = "36.19"  # tool-compatibility version the CLI reports


def to_mapq(score: int, length: int, mapped: bool, ambig: bool) -> int:
    """reference: stream/SamLine.java:1709-1721."""
    if not mapped or length < 1:
        return 0
    if ambig and PENALIZE_AMBIG:
        adjusted = (score * 3.0) / (100.0 * length)
        return max(1, round_half_up(adjusted))
    score2 = (score - length * 40) * 1.6
    mx = 1.5 * math.log2(length) + 36
    adjusted = (score2 * mx) / (100.0 * length)
    return max(4, round_half_up(adjusted))


def round_half_up(x: float) -> int:
    """Java Math.round: floor(x + 0.5)."""
    return int(math.floor(x + 0.5))


# symbol -> CIGAR-mode translation tables (index = match symbol byte).
# Used by the C-level fast path of match_to_cigar for fully in-bounds
# alignments, where the mode depends only on the symbol, never on refloc.
def _mk_mode_table(v14: bool) -> bytes:
    t = bytearray(b"\x00" * 256)
    if v14:
        for c in b"ms":
            t[c] = ord("=")
        t[ord("S")] = ord("X")
        for c in b"NB":
            # N/no-call columns print as M even in 1.4 cigars
            # (reference: SamLine.toCigar14:713-715)
            t[c] = ord("M")
    else:
        for c in b"msSNB":
            t[c] = ord("M")
    for c in b"IXY":
        t[c] = ord("I")
    t[ord("D")] = ord("D")
    t[ord("C")] = ord("S")
    return bytes(t)


_MODE14 = _mk_mode_table(True)
_MODE13 = _mk_mode_table(False)
# ref-consuming symbols (advance refloc): everything except I/X/Y
_REF_CONSUMES = bytes(0 if c in b"IXY" else 1 for c in range(256))


def _match_to_cigar_fast(match: bytes, v14: bool) -> str:
    """RLE of the translated mode string — valid only when every position
    is inside the scaffold (no soft-clip conversion)."""
    modes = match.translate(_MODE14 if v14 else _MODE13)
    if b"\x00" in modes:
        raise ValueError("bad match symbol")
    if modes.count(modes[0]) == len(modes):  # single run (common case)
        return f"{len(modes)}{modes[:1].decode()}"
    arr = np.frombuffer(modes, np.uint8)
    cut = np.nonzero(arr[1:] != arr[:-1])[0]
    starts = np.empty(len(cut) + 1, np.int64)
    starts[0] = 0
    starts[1:] = cut + 1
    ends = np.empty_like(starts)
    ends[:-1] = cut + 1
    ends[-1] = len(arr)
    parts = []
    for s, e in zip(starts, ends):
        parts.append(f"{e - s}{modes[s:s + 1].decode()}")
    return "".join(parts)


def match_to_cigar(match: bytes, read_start: int, read_stop: int,
                   reflen: int, version: float = VERSION) -> str:
    """Long-form match string -> CIGAR
    (reference: stream/SamLine.toCigar13:600 / toCigar14:679).
    read_start = scaffold-relative alignment start (may be negative);
    reflen = scaffold length. Out-of-scaffold positions soft-clip."""
    if not match:
        return "*"
    if read_start >= 0 and read_stop < reflen and (
            INTRON_LIMIT >= len(match) or b"D" not in match):
        # fully in-bounds and no possible D->N conversion: mode depends
        # only on the symbol (fast path)
        return _match_to_cigar_fast(match, version > 1.3)
    return _match_to_cigar_slow(match, read_start, read_stop, reflen,
                                version)


def _match_to_cigar_slow(match: bytes, read_start: int, read_stop: int,
                         reflen: int, version: float = VERSION) -> str:
    ops: List[Tuple[int, str]] = []
    count = 0
    last_mode = "="
    mode = "="
    refloc = read_start
    v14 = version > 1.3

    def emit(cnt: int, m: str):
        if cnt > 0:
            if m == "D" and cnt > INTRON_LIMIT:
                ops.append((cnt, "N"))
            else:
                ops.append((cnt, m))

    for m in match:
        ch = chr(m)
        sfd = False
        if SOFT_CLIP and (refloc < 0 or refloc >= reflen):
            mode = "S"
            if ch != "I":
                refloc += 1
            if ch == "D":
                sfd = True
        elif v14:
            if ch in "ms":
                mode = "="
                refloc += 1
            elif ch == "S":
                mode = "X"
                refloc += 1
            elif ch in "NB":
                mode = "M"
                refloc += 1
            elif ch in "IXY":
                mode = "I"
            elif ch == "D":
                mode = "D"
                refloc += 1
            elif ch == "C":
                mode = "S"
                refloc += 1
            else:
                raise ValueError(f"bad match symbol {ch!r}")
        else:
            if ch in "msSNB":
                mode = "M"
                refloc += 1
            elif ch in "IXY":
                mode = "I"
            elif ch == "D":
                mode = "D"
                refloc += 1
            elif ch == "C":
                mode = "S"
                refloc += 1
            else:
                raise ValueError(f"bad match symbol {ch!r}")
        if mode != last_mode:
            emit(count, last_mode)
            count = 0
            last_mode = mode
        count += 1
        if sfd:
            count -= 1
    emit(count, mode)
    return "".join(f"{c}{m}" for c, m in ops) or "*"


def count_leading_clip(match: bytes) -> int:
    """reference: stream/SamLine.countLeadingClip (long-form only here)."""
    return len(match) - len(match.lstrip(b"C"))


def count_trailing_clip(match: bytes) -> int:
    return len(match) - len(match.rstrip(b"C"))


def count_leading_indels(a: int, match: Optional[bytes]) -> int:
    """Indels in the region that hangs off the scaffold start
    (reference: stream/SamLine.countLeadingIndels). Counts D minus I among
    match symbols while refloc < 0."""
    if match is None or a >= 0:
        return 0
    dels = inss = 0
    refloc = a
    for m in match:
        if refloc >= 0:
            break
        ch = chr(m)
        if ch == "D":
            dels += 1
            refloc += 1
        elif ch in "IXY":
            inss += 1
        else:
            refloc += 1
    return dels - inss


def count_trailing_indels(b: int, scaflen: int, match: Optional[bytes]) -> int:
    if match is None or b < scaflen:
        return 0
    dels = inss = 0
    refloc = b
    for m in reversed(match):
        if refloc < scaflen:
            break
        ch = chr(m)
        if ch == "D":
            dels += 1
            refloc -= 1
        elif ch in "IXY":
            inss += 1
        else:
            refloc -= 1
    return dels - inss


def calc_nm(match: bytes, cigar: str, read_len: int) -> int:
    """NM over the unclipped region (reference: stream/SamLine.java:1515-1540).
    N symbols count as mismatches; deletions longer than INTRON_LIMIT don't
    count."""
    leftclip = _cigar_left_clip(cigar)
    rightclip = _cigar_right_clip(cigar)
    frm, to = leftclip, read_len - rightclip
    if frm == 0 and to >= read_len and (not match
                                        or match[-1] != ord("D")) \
            and (INTRON_LIMIT >= len(match) or b"D" not in match):
        # unclipped fast path: every symbol is in range and every
        # deletion run is < INTRON_LIMIT for short reads, so NM is just
        # the symbol counts (C-level scans)
        return (match.count(ord("I")) + match.count(ord("S"))
                + match.count(ord("N")) + match.count(ord("X"))
                + match.count(ord("Y")) + match.count(ord("D")))
    nm = 0
    dels = 0
    cpos = 0
    for m in match:
        ch = chr(m)
        if frm <= cpos < to:
            if ch in "ISNXY":
                nm += 1
            if ch == "D":
                dels += 1
            else:
                if dels <= INTRON_LIMIT:
                    nm += dels
                dels = 0
        if ch != "D":
            cpos += 1
    if dels <= INTRON_LIMIT:
        nm += dels
    return nm


def _cigar_left_clip(cigar: str) -> int:
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            return int(num) if ch == "S" else 0
    return 0


def _cigar_right_clip(cigar: str) -> int:
    if not cigar.endswith("S"):
        return 0
    i = len(cigar) - 2
    num = ""
    while i >= 0 and cigar[i].isdigit():
        num = cigar[i] + num
        i -= 1
    return int(num) if num else 0


def make_flag(mapped1: bool, mapped2: Optional[bool], strand1: int,
              strand2: Optional[int], paired_input: bool, fragnum: int,
              proper: bool, secondary: bool = False,
              discarded: bool = False) -> int:
    """reference: stream/SamLine.makeFlag:2134-2152."""
    flag = 0
    if paired_input:
        flag |= 0x1
        if proper:
            flag |= 0x2
        if fragnum == 0:
            flag |= 0x40
        else:
            flag |= 0x80
    if not mapped1:
        flag |= 0x4
    if paired_input and not mapped2:
        flag |= 0x8
    if strand1 == 1:
        flag |= 0x10
    if paired_input and strand2 == 1:
        flag |= 0x20
    if secondary:
        flag |= 0x100
    if discarded:
        flag |= 0x200
    return flag


def sam_header(genome: Genome, sort_scaffolds: bool = False) -> List[str]:
    """reference: stream/SamHeader.java header0/header1/header2."""
    lines = [f"@HD\tVN:{'1.3' if VERSION < 1.4 else '1.4'}\tSO:unsorted"]
    scafs = genome.scaffolds
    if sort_scaffolds:
        scafs = sorted(scafs, key=lambda s: s.name)
    for s in scafs:
        # full header text is kept verbatim (reference: SamHeader
        # appendScafName — no whitespace trimming)
        lines.append(f"@SQ\tSN:{s.name}\tLN:{s.length}")
    lines.append(f"@PG\tID:BBMap\tPN:BBMap\tVN:{BBMAP_VERSION_STRING}")
    return lines


def revcomp_bytes(b: bytes) -> bytes:
    return bytes(COMP_ASCII[np.frombuffer(b, np.uint8)][::-1])


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    rnext: str
    pnext: int
    tlen: int
    seq: bytes
    qual: Optional[bytes]
    tags: List[str] = field(default_factory=list)

    def to_line(self) -> str:
        seq = self.seq
        qual = self.qual
        if (self.flag & 0x4) == 0 and (self.flag & 0x10) != 0:
            seq = revcomp_bytes(seq)
            qual = qual[::-1] if qual is not None else None
        fields = [
            self.qname, str(self.flag), self.rname, str(self.pos),
            str(self.mapq), self.cigar, self.rnext, str(self.pnext),
            str(self.tlen), seq.decode(),
            qual.decode() if qual is not None else "*",
        ]
        if self.tags:
            fields.extend(self.tags)
        return "\t".join(fields)


def make_md_tag(match: bytes, call: bytes, cha: np.ndarray,
                refstart: int, scafloc: int, scaflen: int) -> str:
    """MD:Z tag from a long-form match string, the reference-oriented
    read bases, and the chromosome array (reference:
    stream/SamLine.makeMdTag:1361-1445, transcription-golden in
    tests/golden/gen_samline.py). Reference quirks preserved exactly:
    consecutive subs omit the separating 0; N columns act as match or
    sub depending on the call base; clipped/out-of-scaffold columns are
    skipped; deletion runs longer than INTRON_LIMIT are dropped."""
    out = ["MD:Z:"]
    scafstop = scafloc + scaflen
    n_cha = len(cha)

    def get(i):
        return chr(cha[i]) if 0 <= i < n_cha else "N"

    prev_m = "?"
    count = 0
    dels = 0
    prev_sub = False
    rpos = refstart
    cpos = 0
    for m in match:
        ch = chr(m)
        c = chr(call[cpos]) if cpos < len(call) else "?"
        if prev_m == "D" and ch != "D":
            if dels <= INTRON_LIMIT:
                out.append(str(count))
                count = 0
                out.append("^")
                for i in range(rpos - dels, rpos):
                    out.append(get(i))
                dels = 0
        if ch == "C" or rpos < scafloc or rpos >= scafstop:
            rpos += 1
            if ch != "D":
                cpos += 1
        elif ch in "ms":
            count += 1
            rpos += 1
            cpos += 1
        elif ch == "S":
            if count > 0 or not prev_sub:
                out.append(str(count))
            out.append(get(rpos))
            count = 0
            rpos += 1
            cpos += 1
            prev_sub = True
        elif ch == "N":
            r = get(rpos)
            if c == r:
                count += 1
            else:
                if count > 0 or not prev_sub:
                    out.append(str(count))
                out.append(r)
                count = 0
                prev_sub = True
            rpos += 1
            cpos += 1
        elif ch in "IXY":
            cpos += 1
        elif ch == "D":
            rpos += 1
            dels += 1
        prev_m = ch
    out.append(str(count))
    return "".join(out)


def score_match_symbols(match: bytes) -> np.ndarray:
    """Per-symbol score deltas of a long-form match string using the
    exact affine tables (reference scoring semantics of
    MultiStateAligner11ts; used for local-alignment conversion)."""
    from ..core.constants import (POINTS_MATCH, POINTS_MATCH2,
                                  POINTS_SUB_ARRAY, POINTS_INS_ARRAY,
                                  del_streak_points)
    deltas = np.zeros(len(match), np.int64)
    prev = 0
    streak = 0
    for i, m in enumerate(match):
        ch = chr(m)
        if ch == "m":
            deltas[i] = POINTS_MATCH2 if prev == ord("m") else POINTS_MATCH
        elif ch in "SN":
            streak = streak + 1 if prev == m else 1
            if ch == "S":
                deltas[i] = POINTS_SUB_ARRAY[min(streak,
                                                 len(POINTS_SUB_ARRAY) - 1)]
            else:
                deltas[i] = 0
        elif ch == "I":
            streak = streak + 1 if prev == m else 1
            deltas[i] = POINTS_INS_ARRAY[min(streak,
                                             len(POINTS_INS_ARRAY) - 1)]
        elif ch == "D":
            streak = streak + 1 if prev == m else 0
            deltas[i] = del_streak_points(streak if prev == m else 0)
        else:
            deltas[i] = 0
        prev = m
    return deltas


def to_local_alignment(match: bytes) -> Tuple[bytes, int, int]:
    """Global -> local: clip negative-scoring tips to 'C' soft-clips
    (reference: stream/Read.toLocalAlignment, wired at
    align2/BBMapThread.java:1337-1347). Returns (new match, ref bases
    clipped at start, ref bases clipped at end)."""
    deltas = score_match_symbols(match)
    # maximal-scoring subarray (ties -> longest, i.e. earliest start)
    best = -1
    best_a = best_b = 0
    run = 0
    run_start = 0
    for i, d in enumerate(deltas):
        if run <= 0:
            run = 0
            run_start = i
        run += int(d)
        if run > best:
            best = run
            best_a, best_b = run_start, i + 1
    if best <= 0:
        return match, 0, 0
    out = bytearray(match)
    ref_pre = 0
    for i in range(best_a):
        if chr(match[i]) in "mSND":
            ref_pre += 1
        out[i] = ord("C") if chr(match[i]) not in "D" else ord("C")
    ref_post = 0
    for i in range(best_b, len(match)):
        if chr(match[i]) in "mSND":
            ref_post += 1
        out[i] = ord("C")
    # deletions cannot be soft-clipped (no read bases) — drop them
    cleaned = bytes(ch for i, ch in enumerate(out)
                    if not (ch == ord("C") and chr(match[i]) == "D"))
    return cleaned, ref_pre, ref_post


# ---------------------------------------------------------------------------
# SAM/BAM IO helpers: .bam paths route through the native BGZF/BAM codec
# (io/bam.py; reference: fileIO/ReadWrite.java:463-607 samtools piping,
# replaced by an in-process implementation)
# ---------------------------------------------------------------------------

def open_sam_lines(path: str):
    """Iterate SAM text lines from a .sam(.gz/.bz2) or .bam file."""
    if path.endswith(".bam"):
        from . import bam
        return bam.bam_to_sam_lines(path)
    from . import fastx

    def gen():
        with fastx.xopen(path, "rt") as fh:
            for line in fh:
                yield line.rstrip("\n")
    return gen()


def open_sam_writer(path: str):
    """Text handle writing SAM; .bam paths encode to BAM on the fly."""
    if path.endswith(".bam"):
        from . import bam
        return bam.SamTextBamWriter(path)
    from . import fastx
    return fastx.xopen(path, "wt")
