"""bbduk2: simultaneous filter / left-trim / right-trim / mask against
FOUR independent reference sets in ONE pass.

reference: jgi/BBDuk2.java (3,761 LoC) + sh/bbduk2.sh. Where BBDuk runs
one operation per invocation, BBDuk2 tags every stored k-mer with its
set and applies, per read pair, in this order (reference:
BBDuk2.java:2203-2262):

1. kfilter  (fref= / fliteral=)  -> discard matching reads
2. kmask    (mref= / mliteral=)  -> overwrite hit spans with kmask symbol
3. ktrim-R  (rref= / rliteral=)  -> trim from leftmost hit to 3' end
4. ktrim-L  (lref= / lliteral=)  -> trim from 5' end through rightmost hit
then qtrim / forcetrim / minlength / entropy exactly as bbduk.

There is no ktrim= flag: the operation is implied by which ref sets are
given (reference: BBDuk2.java:334-338 throws on ktrim=). The kmask=
flag picks the mask symbol (default N; 'lc'/'lowercase' lowercases).

Each set keeps its own per-scaffold match stats (stats= writes all four
sections).

The port's copy of the JAX package's tool: ``device=`` (default cuda)
names the torch device of the k-mer scans.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from .. import backend
from ..core.batch import ReadBatch
from ..index import kmerset
from ..io import fastx
from ..utils.args import Args
from .bbduk import optimal_trim_points, read_min_entropy

SETS = ("filter", "mask", "right", "left")


class BBDuk2:
    def __init__(self, set_seqs: dict, set_names: dict, k: int = 27,
                 mink: int = 0, hdist: int = 0, mask_middle: bool = True,
                 rcomp: bool = True, kmask_symbol: str = "N",
                 kmask_lower: bool = False, min_kmer_hits: int = 1,
                 qtrim: str = "f", trimq: int = 6, minlength: int = 10,
                 forcetrimleft: int = 0, forcetrimright: int = -1,
                 entropy: float = -1.0, *, device):
        self.device = backend.resolve_device(device)
        self.k = k
        self.mink = mink
        self.qtrim = qtrim
        self.trimq = trimq
        self.minlength = minlength
        self.ftl = forcetrimleft
        self.ftr = forcetrimright
        self.entropy = entropy
        self.kmask_symbol = kmask_symbol
        self.kmask_lower = kmask_lower
        self.min_kmer_hits = min_kmer_hits
        self.ks = {}
        self.counts = {}
        self.names = set_names
        for s in SETS:
            seqs = set_seqs.get(s) or []
            if seqs:
                # mink (tip scan) only matters for the trim sets
                use_mink = mink if s in ("right", "left") else 0
                mm = mask_middle and not (0 < use_mink < k)
                self.ks[s] = kmerset.build_kmer_set(
                    seqs, k=k, mink=use_mink, hdist=hdist,
                    mask_middle=mm, rcomp=rcomp,
                    names=set_names.get(s))
                self.counts[s] = np.zeros(max(1, len(seqs)), np.int64)
        self.reads_in = 0
        self.bases_in = 0
        self.reads_kfiltered = 0
        self.reads_kmasked = 0
        self.bases_kmasked = 0
        self.reads_ktrimmed = 0
        self.bases_ktrimmed = 0
        self.reads_qtrimmed = 0

    def _attr(self, s: str, hits, ids, rows) -> None:
        for i in rows:
            first = int(np.argmax(hits[i]))
            sid = int(ids[i, first])
            if sid >= 0:
                self.counts[s][sid] += 1

    def process_batch(self, batch: ReadBatch
                      ) -> Tuple[np.ndarray, list, np.ndarray]:
        """Returns (keep mask, output SeqRecords, matched-any flags)."""
        B = batch.size
        bases = batch.bases.copy()
        qual = (batch.quality.copy() if batch.quality is not None
                else None)
        lengths = batch.lengths.copy()
        left = np.zeros(B, np.int32)
        self.reads_in += B
        self.bases_in += int(lengths.sum())
        if self.ftl > 0:
            left += self.ftl
        if self.ftr >= 0:
            lengths = np.minimum(lengths, self.ftr + 1)

        keep = np.ones(B, bool)
        matched_any = np.zeros(B, bool)
        k = self.k

        def scan(s):
            hits, ids = kmerset.scan_batch(self.ks[s], bases, self.device)
            m = hits.shape[1]
            if m:
                kvalid = (np.arange(m)[None, :] >= left[:, None]) & \
                    (np.arange(m)[None, :] <= (lengths - k)[:, None])
                hits = hits & kvalid
            return hits, ids

        # 1. filter (reference: BBDuk2.java:2203 countSetKmers ->
        #    maxBadKmers discard)
        if "filter" in self.ks:
            hits, ids = scan("filter")
            matched = hits.sum(1) >= self.min_kmer_hits
            rows = np.nonzero(matched)[0]
            self._attr("filter", hits, ids, rows)
            keep &= ~matched
            matched_any |= matched
            self.reads_kfiltered += len(rows)

        # 2. mask (NMODE; reference: kmask :2951)
        if "mask" in self.ks:
            hits, ids = scan("mask")
            matched = hits.sum(1) >= 1
            rows = np.nonzero(matched & keep)[0]
            self._attr("mask", hits, ids, rows)
            matched_any |= matched
            for i in rows:
                nm = 0
                for p in np.nonzero(hits[i])[0]:
                    a, b = int(p), int(p) + k
                    if self.kmask_lower:
                        seg = bases[i, a:b]
                        bases[i, a:b] = np.where(
                            (seg >= 65) & (seg <= 90), seg + 32, seg)
                    else:
                        bases[i, a:b] = ord(self.kmask_symbol)
                    nm += k
                self.reads_kmasked += 1
                self.bases_kmasked += nm

        # 3. right-trim (RIGHTMODE; reference: ktrim :2780, :2869)
        if "right" in self.ks:
            hits, ids = scan("right")
            matched = hits.sum(1) >= 1
            rows = np.nonzero(matched & keep)[0]
            self._attr("right", hits, ids, rows)
            matched_any |= matched
            for i in rows:
                pos = int(np.argmax(hits[i]))
                cut = int(lengths[i]) - pos
                if cut > 0:
                    lengths[i] = pos
                    self.reads_ktrimmed += 1
                    self.bases_ktrimmed += cut
            if self.mink > 0:
                tip = kmerset.scan_tips(self.ks["right"], bases,
                                        lengths, "r")
                for i in np.nonzero(tip >= 0)[0]:
                    if keep[i] and tip[i] < lengths[i]:
                        self.bases_ktrimmed += int(lengths[i] - tip[i])
                        lengths[i] = tip[i]
                        self.reads_ktrimmed += 1

        # 4. left-trim (LEFTMODE; reference: ktrim :2780, :2835)
        if "left" in self.ks:
            hits, ids = scan("left")
            m = hits.shape[1]
            matched = hits.sum(1) >= 1
            rows = np.nonzero(matched & keep)[0]
            self._attr("left", hits, ids, rows)
            matched_any |= matched
            for i in rows:
                last = m - 1 - int(np.argmax(hits[i][::-1]))
                new_left = last + k
                if new_left > left[i]:
                    self.bases_ktrimmed += int(new_left - left[i])
                    left[i] = new_left
                    self.reads_ktrimmed += 1
            if self.mink > 0:
                tip = kmerset.scan_tips(self.ks["left"], bases,
                                        lengths, "l")
                for i in np.nonzero(tip >= 0)[0]:
                    if keep[i]:
                        left[i] = max(left[i], int(tip[i]))

        # quality trim + length/entropy gates (same as bbduk)
        if self.qtrim in ("r", "l", "rl", "t", "true"):
            pts = optimal_trim_points(bases, qual, lengths, self.trimq)
            if self.qtrim in ("l", "rl", "t", "true"):
                left = np.maximum(left, pts[:, 0])
            if self.qtrim in ("r", "rl", "t", "true"):
                lengths = np.minimum(
                    lengths, np.maximum(lengths - pts[:, 1], left))
            self.reads_qtrimmed += int(((pts[:, 0] > 0) |
                                        (pts[:, 1] > 0)).sum())

        newlen = np.maximum(lengths - left, 0)
        keep &= newlen >= self.minlength
        if self.entropy >= 0:
            for i in range(B):
                if keep[i] and read_min_entropy(
                        bases[i], int(newlen[i])) < self.entropy:
                    keep[i] = False

        out_records = []
        for i in range(B):
            a, b = int(left[i]), int(lengths[i])
            q = None
            if qual is not None:
                q = bytes((qual[i, a:b].astype(np.int16)
                           + fastx.ASCII_OFFSET).astype(np.uint8))
            out_records.append(fastx.SeqRecord(
                batch.ids[i], bytes(bases[i, a:b]), q,
                int(batch.numeric_ids[i])))
        return keep, out_records, matched_any

    def stats_lines(self) -> List[str]:
        lines = [f"#Total\t{self.reads_in}"]
        for s in SETS:
            if s not in self.ks:
                continue
            total = int(self.counts[s].sum())
            lines.append(f"#Set {s}\t{total}\t"
                         f"{100.0 * total / max(1, self.reads_in):.5f}%")
            names = self.ks[s].ref_names or [
                str(i) for i in range(len(self.counts[s]))]
            order = np.argsort(-self.counts[s], kind="stable")
            for sid in order:
                if self.counts[s][sid] > 0:
                    lines.append(
                        f"{names[sid]}\t{self.counts[s][sid]}\t"
                        f"{100.0 * self.counts[s][sid] / max(1, self.reads_in):.5f}%")
        return lines


def _load_set(ref_arg: Optional[str], lit_arg: Optional[str],
              tag: str) -> Tuple[list, list]:
    seqs, names = [], []
    if ref_arg:
        for path in ref_arg.split(","):
            for rec in fastx.read_seqs(path):
                seqs.append(rec.bases)
                names.append(rec.id.decode() if isinstance(rec.id, bytes)
                             else rec.id)
    if lit_arg:
        for i, s in enumerate(lit_arg.split(",")):
            seqs.append(s.encode())
            names.append(f"{tag}_literal_{i}")
    return seqs, names


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out = args.get("out", "out1", "outu")
    out2 = args.get("out2", "outu2")
    outm = args.get("outm", "outmatched", "outb")
    stats = args.get("stats")
    if in1 is None:
        print("Usage: bbduk2 in=<reads> out=<file> "
              "fref=|rref=|lref=|mref=<fastas> k=27 ...",
              file=sys.stderr)
        return 1
    if args.get("ktrim") is not None:
        # reference: BBDuk2.java:334-338
        print("BBDuk2 does not need the ktrim flag. It trims according "
              "to which references are specified (lref/rref); use kmask= "
              "for masking modes.", file=sys.stderr)
        return 1

    set_seqs, set_names = {}, {}
    for s, refk, litk in (("filter", "fref", "fliteral"),
                          ("mask", "mref", "mliteral"),
                          ("right", "rref", "rliteral"),
                          ("left", "lref", "lliteral")):
        seqs, names = _load_set(
            args.get(refk, {"mask": "maskref", "filter": "filterref",
                            "right": "rightref",
                            "left": "leftref"}[s]),
            args.get(litk), s)
        if seqs:
            set_seqs[s] = seqs
            set_names[s] = names
    if not set_seqs:
        print("bbduk2: no reference sets given "
              "(fref=/rref=/lref=/mref= or *literal=)", file=sys.stderr)
        return 1

    kmask_arg = args.get("kmask") or "N"
    kmask_lower = kmask_arg.lower() in ("lc", "lowercase")
    duk = BBDuk2(
        set_seqs, set_names,
        k=args.get_int("k", default=27),
        mink=args.get_int("mink", default=0),
        hdist=args.get_int("hdist", "hammingdistance", default=0),
        mask_middle=args.get_bool("maskmiddle", "mm", default=True),
        rcomp=args.get_bool("rcomp", default=True),
        kmask_symbol=("N" if kmask_lower or len(kmask_arg) != 1
                      else kmask_arg),
        kmask_lower=kmask_lower,
        min_kmer_hits=args.get_int("minkmerhits", "mkh", default=1),
        qtrim=(args.get("qtrim", default="f") or "f").lower(),
        trimq=args.get_int("trimq", default=6),
        minlength=args.get_int("minlength", "minlen", "ml", default=10),
        forcetrimleft=args.get_int("forcetrimleft", "ftl", default=0),
        forcetrimright=args.get_int("forcetrimright", "ftr", default=-1),
        entropy=args.get_float("entropy", default=-1.0),
        device=args.get("device", default="cuda"))

    out_fh = fastx.xopen(out, "wb") if out else None
    out2_fh = fastx.xopen(out2, "wb") if out2 else None
    outm_fh = fastx.xopen(outm, "wb") if outm else None

    def write(fh, rec):
        if fh is None:
            return
        if rec.quality is not None:
            fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases
                     + b"\n+\n" + rec.quality + b"\n")
        else:
            fh.write(b">" + rec.id.encode() + b"\n" + rec.bases + b"\n")

    n_kept = n_tossed = 0
    paired = in2 is not None
    streams = ([fastx.read_seqs(in1, fake_quality=30),
                fastx.read_seqs(in2, fake_quality=30)] if paired
               else [fastx.read_seqs(in1, fake_quality=30)])
    import itertools
    BATCH = 4096
    while True:
        recs1 = list(itertools.islice(streams[0], BATCH))
        if not recs1:
            break
        recs2 = (list(itertools.islice(streams[1], BATCH)) if paired
                 else None)
        b1 = ReadBatch.from_records(recs1)
        keep1, out1, m1 = duk.process_batch(b1)
        if paired:
            b2 = ReadBatch.from_records(recs2)
            keep2, out2r, m2 = duk.process_batch(b2)
            # removePairsIfEitherBad (reference: BBDuk2.java:2183)
            keep = keep1 & keep2
            for i in range(len(out1)):
                if keep[i]:
                    write(out_fh, out1[i])
                    write(out2_fh if out2_fh else out_fh, out2r[i])
                    n_kept += 2
                else:
                    write(outm_fh, out1[i])
                    write(outm_fh, out2r[i])
                    n_tossed += 2
        else:
            for i in range(len(out1)):
                if keep1[i]:
                    write(out_fh, out1[i])
                    n_kept += 1
                else:
                    write(outm_fh, out1[i])
                    n_tossed += 1
    for fh in (out_fh, out2_fh, outm_fh):
        if fh:
            fh.close()
    if stats:
        with open(stats, "w") as fh:
            fh.write("\n".join(duk.stats_lines()) + "\n")
    sys.stderr.write(
        f"Input:\t{duk.reads_in} reads\t{duk.bases_in} bases.\n"
        f"KFiltered:\t{duk.reads_kfiltered} reads\n"
        f"KMasked:\t{duk.reads_kmasked} reads\t"
        f"{duk.bases_kmasked} bases\n"
        f"KTrimmed:\t{duk.reads_ktrimmed} reads\t"
        f"{duk.bases_ktrimmed} bases\n"
        f"Result:\t{n_kept} reads kept\t{n_tossed} removed\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
