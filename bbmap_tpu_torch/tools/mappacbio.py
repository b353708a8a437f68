"""mappacbio: long-read mapping mode, PyTorch port of
bbmap_tpu/tools/mappacbio.py.

reference: align2/BBMapPacBio.java:24 + sh/mapPacBio.sh. Long-read
defaults (reference setDefaults :47-69): k=12 index, minratio=0.46,
maxindel=400, batchsize=256 and the MSA9PacBio scoring profile. Reads
longer than the alignment envelope (6,000 bases) are split into chunks,
mapped independently by the port's ``bbmap`` tool and rejoined into
whole-read records (reference: fastareadlen=6000, sh/mapPacBio.sh:52;
AbstractMapThread.processReadSplit:2787). ``device=`` passes through to
``bbmap`` (default cuda).

The host functions are copies of the JAX package's, not imports: that
module imports the JAX ``bbmap`` tool and with it jax.
"""

from __future__ import annotations

import os
import re
import sys
import tempfile
from typing import Dict, List

from ..io import fastx
from ..utils.args import Args

from . import bbmap as bbmap_tool

MAX_CHUNK = 6000  # reference: PacBio stack envelope (ALIGN_ROWS=6020)

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _refspan(cigar: str) -> int:
    return sum(int(n) for n, op in _CIGAR_RE.findall(cigar)
               if op in "MDN=X")


def _rc(seq: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp.get(c, "N") for c in reversed(seq))


def _try_merge_run(recs, i, j, tolerance):
    """Merge the contiguous chunk run recs[i..j] (all mapped, same
    rname+strand) into (pos0, cigar, seq, qual, minus), or None when the
    chunks are not collinear within tolerance."""
    run = recs[i:j + 1]
    minus = bool(int(run[0][1]) & 0x10)
    ordered = run if not minus else run[::-1]
    cigar_parts: List[str] = []
    seq_parts: List[str] = []
    qual_parts: List[str] = []
    pos0 = int(ordered[0][3])
    cur_end = pos0 - 1
    for t, f in enumerate(ordered):
        p = int(f[3])
        if t > 0:
            gap = p - cur_end - 1
            if gap < 0 or gap > tolerance:
                return None
            if gap > 0:
                cigar_parts.append(f"{gap}D")
        cigar_parts.append(f[5])
        seq_parts.append(f[9])
        qual_parts.append(f[10])
        cur_end = p + _refspan(f[5]) - 1
    return (pos0, "".join(cigar_parts), "".join(seq_parts),
            "".join(qual_parts), minus)


def _runs(recs):
    """Maximal contiguous runs of mapped chunks sharing rname+strand:
    (i, j, weight = total seq length)."""
    out_runs = []
    i = 0
    n = len(recs)
    while i < n:
        f = recs[i]
        if int(f[1]) & 0x4:
            i += 1
            continue
        j = i
        while (j + 1 < n and not int(recs[j + 1][1]) & 0x4
               and recs[j + 1][2] == f[2]
               and (int(recs[j + 1][1]) & 0x10) == (int(f[1]) & 0x10)):
            j += 1
        out_runs.append((i, j, sum(len(r[9]) for r in recs[i:j + 1])))
        i = j + 1
    return out_runs


def _merge_chunks(base: str, recs, tolerance: int):
    """One whole-read record from a read's chunk records, or None when
    no collinear run can be merged. The heaviest collinear run is the
    majority alignment; the minority chunks become soft-clips of it
    (reference: AbstractMapThread.processReadSplit:2787 tolerates chunks
    on different strands/scaffolds)."""
    best = None
    for (i, j, _w) in sorted(_runs(recs), key=lambda r: -r[2]):
        m = _try_merge_run(recs, i, j, tolerance)
        if m is not None and (j > i or len(recs) == 1 or best is None):
            best = (i, j, m)
            if j > i:
                break
    if best is None or len(recs) <= 1:
        return None
    i, j, (pos0, cig, seq, qual, minus) = best

    def chunk_seq(f):
        """A minority chunk's bases, oriented to the majority strand."""
        s, q = f[9], f[10]
        if bool(int(f[1]) & 0x10) != minus:
            return _rc(s), q[::-1]
        return s, q
    lead = [chunk_seq(f) for f in recs[:i]]
    trail = [chunk_seq(f) for f in recs[j + 1:]]
    if minus:
        # reference orientation reverses read-chunk order
        lead, trail = trail[::-1], lead[::-1]
    lseq = "".join(s for s, _ in lead)
    lqual = "".join(q for _, q in lead)
    tseq = "".join(s for s, _ in trail)
    tqual = "".join(q for _, q in trail)
    cigar = ((f"{len(lseq)}S" if lseq else "") + cig
             + (f"{len(tseq)}S" if tseq else ""))
    merged = recs[i][:]
    merged[0] = base
    merged[3] = str(pos0)
    merged[5] = cigar
    merged[9] = lseq + seq + tseq
    merged[10] = lqual + qual + tqual
    return merged[:11]  # tags would be stale


def rejoin_sam(in_path: str, out_path: str,
               tolerance: int = 500) -> None:
    """Merge collinear chunk alignments back into whole-read records
    (reference: AbstractMapThread.processReadSplit:2787 rejoins split
    long reads). Chunks that are unmapped or non-collinear stay as
    separate records."""
    header: List[str] = []
    groups: Dict[str, list] = {}
    order: List[str] = []
    passthrough: List[str] = []
    with fastx.xopen(in_path, "rt") as fh:
        for line in fh:
            if line.startswith("@"):
                header.append(line)
                continue
            f = line.rstrip("\n").split("\t")
            m = re.match(r"^(.*)_chunk(\d+)$", f[0])
            if not m:
                passthrough.append(line)
                continue
            base, idx = m.group(1), int(m.group(2))
            if base not in groups:
                groups[base] = []
                order.append(base)
            groups[base].append((idx, f))
    with fastx.xopen(out_path, "wt") as out:
        out.writelines(header)
        out.writelines(passthrough)
        for base in order:
            recs = [f for _, f in sorted(groups[base])]
            merged = _merge_chunks(base, recs, tolerance)
            for f in ([merged] if merged is not None else recs):
                out.write("\t".join(f) + "\n")


def split_long_reads(path: str, out_path: str,
                     chunk: int = MAX_CHUNK) -> None:
    """Pre-chunk reads longer than the alignment envelope
    (reference: sh/mapPacBio.sh fastareadlen)."""
    def gen():
        for rec in fastx.read_seqs(path, fake_quality=30):
            if len(rec.bases) <= chunk:
                yield rec
            else:
                for i, lo in enumerate(range(0, len(rec.bases), chunk)):
                    q = (rec.quality[lo:lo + chunk]
                         if rec.quality is not None else None)
                    yield fastx.SeqRecord(f"{rec.id}_chunk{i}",
                                          rec.bases[lo:lo + chunk], q,
                                          rec.numeric_id)
    fastx.write_fastq(out_path, gen())


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    if in1 is None:
        print("Usage: mappacbio ref=<fasta> in=<reads> out=<sam> "
              "[device=cuda|cpu]", file=sys.stderr)
        return 1
    # every read goes through the splitter (short reads pass unchanged)
    fd, chunked = tempfile.mkstemp(suffix=".fq")
    os.close(fd)
    split_long_reads(in1, chunked)
    fwd = [a for a in argv if not a.lower().startswith(("in=", "in1="))]
    fwd.append(f"in={chunked}")
    # long-read defaults (reference: BBMapPacBio.setDefaults)
    if not args.has("k", "keylen"):
        fwd.append("k=12")
    if not args.has("minratio") and not args.has("minid"):
        fwd.append("minratio=0.46")
    if not args.has("maxindel"):
        fwd.append("maxindel=400")
    if not args.has("batchsize"):
        fwd.append("batchsize=256")
    if not args.has("profile"):
        # MSA9PacBio scoring stack + PacBio clearzone model
        # (reference: align2/MultiStateAligner9PacBio.java:2359-2408,
        # BBMapThreadPacBio.java:38-54)
        fwd.append("profile=pacbio")
    rejoin = args.get_bool("rejoin", default=True)
    out_path = args.get("out")
    try:
        rc = bbmap_tool.main(fwd)
        if rc == 0 and rejoin and out_path:
            tmp_out = out_path + ".chunks"
            os.replace(out_path, tmp_out)
            rejoin_sam(tmp_out, out_path)
            os.unlink(tmp_out)
        return rc
    finally:
        os.unlink(chunked)


def skimmer_main(argv: List[str]) -> int:
    """mappacbioskimmer: long-read mapping that emits ALL sites above
    threshold (reference: align2/BBMapPacBioSkimmer.java via
    sh/bbmapskimmer.sh — the PacBio stack with skimmer site emission):
    pacbio profile + secondary-site output + ambig=all."""
    extra = []
    keys = {a.split("=")[0].lower() for a in argv if "=" in a}
    if "ambig" not in keys and "ambiguous" not in keys:
        extra.append("ambig=all")
    if "secondary" not in keys:
        extra.append("secondary=t")
    if "maxsites" not in keys and "sssr" not in keys:
        extra.append("maxsites=20")
    return main(argv + extra)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
