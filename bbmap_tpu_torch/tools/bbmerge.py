"""bbmerge: paired-read overlap merging.

reference: jgi/BBMerge.java:34 + sh/bbmerge.sh. Covers the mismatch-count
("normal") overlap mode with the QUAL_ITERS retry ladder
(reference: jgi/BBMerge.mateByOverlap_normalMode:1641-1695), strictness
presets as parameter rewrites (reference: :75-260), consensus joining, and
the insert-size histogram. Ratio mode is a round-2 item.

The port's copy of the JAX package's tool: ``device=`` (default cuda)
names the torch device of the overlap ladders (ratio mode and the
QUAL_ITERS mismatch ladder); ``hosts=`` above 1 (multi-host striping) is
not ported yet and exits 1.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from .. import backend
from ..core.bases import COMP_ASCII
from ..core.batch import ReadBatch, batched
from ..io import fastx
from ..ops import overlap as ov
from ..utils.args import Args

# reference defaults (jgi/BBMerge.java:2278-2350)
MIN_OVERLAPPING_BASES = 11
MIN_OVERLAPPING_BASES_0 = 8
MISMATCH_MARGIN = 2
MAX_MISMATCHES = 3
MAX_MISMATCHES0 = 3
MIN_QUALITY = 10
QUAL_ITERS = 3
MIN_INSERT = 35


def apply_strictness(name: str, p: dict) -> None:
    """Strictness ladder rewrites (reference: jgi/BBMerge.java:122-260)."""
    if name in ("xstrict", "ustrict", "vstrict", "strict"):
        p["margin"] = 3
        p["max_mismatches"] = {"xstrict": 0, "ustrict": 0,
                               "vstrict": 1, "strict": 2}[name]
        p["max_mismatches0"] = p["max_mismatches"]
        p["min_overlap"] = {"xstrict": 14, "ustrict": 12, "vstrict": 12,
                            "strict": 11}[name]
        p["ratio_margin"] = {"xstrict": 12.0, "ustrict": 12.0,
                             "vstrict": 12.0, "strict": 7.5}[name]
    elif name in ("loose", "vloose", "uloose", "xloose"):
        p["margin"] = 2
        p["max_mismatches"] = {"loose": 4, "vloose": 5, "uloose": 6,
                               "xloose": 8}[name]
        p["max_mismatches0"] = p["max_mismatches"] + 2
        p["min_overlap"] = {"loose": 10, "vloose": 9, "uloose": 8,
                            "xloose": 7}[name]
        p["ratio_margin"] = {"loose": 4.7, "vloose": 3.0, "uloose": 2.2,
                             "xloose": 2.0}[name]


class BBMerge:
    def __init__(self, min_overlap=MIN_OVERLAPPING_BASES,
                 min_overlap0=MIN_OVERLAPPING_BASES_0,
                 margin=MISMATCH_MARGIN, max_mismatches=MAX_MISMATCHES,
                 max_mismatches0=MAX_MISMATCHES0, minq=MIN_QUALITY,
                 min_insert=MIN_INSERT, min_insert0: Optional[int] = None,
                 qual_iters=QUAL_ITERS, use_ratio: bool = True,
                 ratio_margin: float = 5.5, max_ratio: float = 0.09,
                 min_second_ratio: float = 0.1, ratio_offset: float = 0.55,
                 use_entropy: bool = False, *, device):
        self.device = backend.resolve_device(device)
        self.use_entropy = use_entropy
        self.use_ratio = use_ratio
        self.ratio_margin = ratio_margin
        self.max_ratio = max_ratio
        self.min_second_ratio = min_second_ratio
        self.ratio_offset = ratio_offset
        self.min_overlap = min_overlap
        self.min_overlap0 = min_overlap0
        self.margin = margin
        self.max_mismatches = max_mismatches
        self.max_mismatches0 = max_mismatches0
        self.minq = minq
        self.min_insert = min_insert
        if min_insert0 is None:
            # reference: :605-611
            min_insert0 = min(min_insert,
                              max(int(min_insert * 0.75), 5,
                                  MIN_OVERLAPPING_BASES_0))
        self.min_insert0 = min_insert0
        self.qual_iters = qual_iters
        self.hist = np.zeros(1000, np.int64)
        self.pairs = 0
        self.merged = 0
        self.ambiguous = 0
        self.too_short = 0
        self.no_solution = 0

    def merge_batch(self, b1: ReadBatch, b2: ReadBatch):
        """Returns (inserts (B,), joined list of (bases, qual)|None)."""
        B = b1.size
        a_bases = b1.bases
        b_bases_rc = COMP_ASCII[b2.bases][:, ::-1]
        a_qual = b1.quality
        b_qual_rc = (b2.quality[:, ::-1] if b2.quality is not None
                     else None)
        self.pairs += B

        insert = np.full(B, -1, np.int32)
        ambig = np.zeros(B, bool)
        if self.use_entropy:
            # complexity-scaled per-pair minimum overlap
            # (reference: jgi/BBMerge.calcMinOverlapFromEntropy:1697-1712)
            min_ov = np.zeros(B, np.int32)
            for i in range(B):
                a = ov.calc_min_overlap_by_entropy(
                    b1.bases[i, :int(b1.lengths[i])], tail=True)
                c = ov.calc_min_overlap_by_entropy(
                    b2.bases[i, :int(b2.lengths[i])], tail=True)
                min_ov[i] = max(self.min_overlap, a, c)
        else:
            min_ov = np.full(B, self.min_overlap, np.int32)
        if self.use_ratio:
            # ratio mode is the reference default
            # (jgi/BBMerge.java:2339; mateByOverlap_ratioMode:1615-1639)
            red = 3  # MIN_OVERLAPPING_BASES_RATIO_REDUCTION
            insert, bad, ambig = ov.mate_by_overlap_ratio_batch(
                a_bases, b_bases_rc,
                min_overlap0=MIN_OVERLAPPING_BASES_0 - red,
                min_overlap=self.min_overlap - red,
                min_insert0=self.min_insert0, min_insert=self.min_insert,
                max_ratio=self.max_ratio,
                min_second_ratio=self.min_second_ratio,
                margin=self.ratio_margin, offset=self.ratio_offset,
                device=self.device)
            if self.use_entropy:
                # per-pair complexity gate: the found overlap must meet
                # that pair's entropy-scaled minimum
                alen = a_bases.shape[1]
                blen = b_bases_rc.shape[1]
                olap = alen + blen - insert
                too_short = (insert > 0) & (olap < min_ov)
                insert = np.where(too_short, -1, insert)
            return self._finish(b1, b2, a_bases, a_qual, b_bases_rc,
                                b_qual_rc, insert, ambig)
        # QUAL_ITERS ladder (reference: :1652-1659): progressively wider
        # overlap requirement and lower quality gate
        have_q = a_qual is not None and b_qual_rc is not None
        iters = self.qual_iters if have_q else 1
        todo = np.ones(B, bool)
        for i in range(iters):
            if not todo.any():
                break
            ins_i, bad_i, amb_i = ov.mate_by_overlap_batch(
                a_bases, a_qual, b_bases_rc, b_qual_rc,
                min_overlap0=self.min_overlap0 - i,
                min_overlap=self.min_overlap + i,
                min_insert0=self.min_insert0, margin=self.margin,
                max_mismatches0=self.max_mismatches0,
                max_mismatches=self.max_mismatches,
                minq=self.minq - 2 * i, device=self.device)
            found = todo & (ins_i > -1)
            insert[found] = ins_i[found]
            ambig[found] = amb_i[found]
            todo &= ~found

        return self._finish(b1, b2, a_bases, a_qual, b_bases_rc,
                            b_qual_rc, insert, ambig)

    def _finish(self, b1, b2, a_bases, a_qual, b_bases_rc, b_qual_rc,
                insert, ambig):
        ok = (insert > 0) & ~ambig & (insert >= self.min_insert)
        self.ambiguous += int(((insert > 0) & ambig).sum())
        self.too_short += int(((insert > 0) & ~ambig
                               & (insert < self.min_insert)).sum())
        self.no_solution += int((insert <= 0).sum())
        self.merged += int(ok.sum())
        np.add.at(self.hist, np.clip(insert[ok], 0, len(self.hist) - 1), 1)

        final_insert = np.where(ok, insert, -1)
        joined = ov.join_pairs(a_bases, a_qual, b_bases_rc, b_qual_rc,
                               final_insert)
        return final_insert, joined


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out = args.get("out", "outm", "outmerged")
    outu1 = args.get("outu", "outu1", "outunmerged")
    outu2 = args.get("outu2")
    ihist_path = args.get("ihist")
    ecco = args.get_bool("ecco", "ecc", default=False)
    interleaved = args.get_bool("interleaved", "int",
                                default=in2 is None)

    p = dict(min_overlap=args.get_int("minoverlap", "mino",
                                      default=MIN_OVERLAPPING_BASES),
             min_overlap0=args.get_int("minoverlap0",
                                       default=MIN_OVERLAPPING_BASES_0),
             margin=args.get_int("margin", default=MISMATCH_MARGIN),
             max_mismatches=args.get_int("mismatches", "maxmismatches",
                                         default=MAX_MISMATCHES),
             max_mismatches0=args.get_int("mismatches0",
                                          default=MAX_MISMATCHES0),
             minq=args.get_int("minq", default=MIN_QUALITY),
             min_insert=args.get_int("mininsert", default=MIN_INSERT),
             use_ratio=args.get_bool("useratio", "ratio", "ratiomode",
                                     default=True),
             ratio_margin=args.get_float("ratiomargin", default=5.5),
             max_ratio=args.get_float("maxratio", default=0.09),
             min_second_ratio=args.get_float("minsecondratio",
                                             default=0.1),
             ratio_offset=args.get_float("ratiooffset", default=0.55),
             use_entropy=args.get_bool("entropy", "useentropy",
                                       default=False))
    for preset in ("xstrict", "ustrict", "vstrict", "strict", "loose",
                   "vloose", "uloose", "xloose"):
        if args.get_bool(preset, default=False):
            apply_strictness(preset, p)
    p["max_mismatches0"] = max(p["max_mismatches0"], p["max_mismatches"])

    if in1 is None:
        print("Usage: bbmerge in1= in2= out=merged.fq outu=unmerged.fq",
              file=sys.stderr)
        return 1
    if args.get_int("hosts", default=1) > 1:
        print("bbmerge: hosts= > 1 (multi-host striping) is not ported yet",
              file=sys.stderr)
        return 1

    merger = BBMerge(**p, device=args.get("device", default="cuda"))
    out_fh = fastx.xopen(out, "wb") if out else None
    outu1_fh = fastx.xopen(outu1, "wb") if outu1 else None
    outu2_fh = fastx.xopen(outu2, "wb") if outu2 else None

    def wfq(fh, name, bases, qual):
        if fh is None:
            return
        q = qual if qual is not None else b"I" * len(bases)
        fh.write(b"@" + name.encode() + b"\n" + bases + b"\n+\n" + q
                 + b"\n")

    t0 = time.time()
    reader = fastx.PairedReader(in1, in2, interleaved and in2 is None)
    for chunk in batched(iter(reader), 8192):
        recs1 = [c[0] for c in chunk]
        recs2 = [c[1] for c in chunk]
        if any(r is None for r in recs2):
            raise ValueError("bbmerge requires paired input")
        b1 = ReadBatch.from_records(recs1)
        b2 = ReadBatch.from_records(recs2)
        inserts, joined = merger.merge_batch(b1, b2)
        if ecco:
            # error-correct by overlap consensus without joining
            # (reference: jgi/BBMerge errorCorrectWithInsert:1416)
            from ..core.bases import COMP_ASCII
            import numpy as _np
            for i, rec in enumerate(recs1):
                if inserts[i] > 0 and joined[i] is not None:
                    jb = _np.frombuffer(joined[i][0], _np.uint8)
                    jq = (_np.frombuffer(joined[i][1], _np.uint8) - 33
                          if joined[i][1] else None)
                    L1 = len(rec.bases)
                    L2 = len(recs2[i].bases)
                    nb1 = bytes(jb[:L1])
                    nq1 = (bytes(jq[:L1] + 33) if jq is not None
                           else rec.quality)
                    tail = jb[max(0, len(jb) - L2):]
                    nb2 = bytes(COMP_ASCII[tail][::-1])
                    nq2 = (bytes((jq[max(0, len(jq) - L2):] + 33)[::-1])
                           if jq is not None else recs2[i].quality)
                    wfq(out_fh, rec.id, nb1, nq1)
                    wfq(outu2_fh if outu2_fh else out_fh, recs2[i].id,
                        nb2, nq2)
                else:
                    wfq(out_fh, rec.id, rec.bases, rec.quality)
                    wfq(outu2_fh if outu2_fh else out_fh, recs2[i].id,
                        recs2[i].bases, recs2[i].quality)
            continue
        for i, rec in enumerate(recs1):
            if inserts[i] > 0 and joined[i] is not None:
                wfq(out_fh, rec.id, joined[i][0], joined[i][1])
            else:
                wfq(outu1_fh, rec.id, rec.bases, rec.quality)
                wfq(outu2_fh if outu2_fh else outu1_fh, recs2[i].id,
                    recs2[i].bases, recs2[i].quality)
    for fh in (out_fh, outu1_fh, outu2_fh):
        if fh is not None:
            fh.close()
    dt = time.time() - t0
    pct = 100.0 * merger.merged / max(1, merger.pairs)
    sys.stderr.write(
        f"Pairs:\t{merger.pairs}\nJoined:\t{merger.merged}\t{pct:.3f}%\n"
        f"Ambiguous:\t{merger.ambiguous}\nNo solution:\t"
        f"{merger.no_solution}\nToo short:\t{merger.too_short}\n"
        f"Time:\t{dt:.3f} seconds.\n")
    if ihist_path:
        nz = np.nonzero(merger.hist)[0]
        with open(ihist_path, "w") as fh:
            fh.write("#InsertSize\tCount\n")
            for i in nz:
                fh.write(f"{i}\t{merger.hist[i]}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
