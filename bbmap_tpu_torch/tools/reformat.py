"""reformat: universal read converter/subsampler.

reference: jgi/ReformatReads.java:38 + sh/reformat.sh. Covers format
conversion (fasta<->fastq, gzip), sampling (samplerate/sampleseed/
samplereadstarget), read count/base limits, force-trim, quality trim,
length filters, reverse-complement, interleaving/deinterleaving, and
pair verification.

The port's copy of the JAX package's tool (host numpy). It runs on one
host: hosts= above 1 (striping over 8192-pair batches) exits 1 until the
port has the multi-host layer.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from ..core.bases import COMP_ASCII
from ..io import fastx
from ..utils.args import Args
from .bbduk import optimal_trim_points


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out1 = args.get("out", "out1")
    out2 = args.get("out2")
    samplerate = args.get_float("samplerate", default=1.0)
    sampleseed = args.get_int("sampleseed", default=-1)
    reads_cap = args.get_int("reads", default=-1)
    ftl = args.get_int("forcetrimleft", "ftl", default=0)
    ftr = args.get_int("forcetrimright", "ftr", default=-1)
    qtrim = (args.get("qtrim", default="f") or "f").lower()
    trimq = args.get_int("trimq", default=6)
    minlength = args.get_int("minlength", "minlen", "ml", default=0)
    maxlength = args.get_int("maxlength", "maxlen", default=-1)
    do_rc = args.get_bool("rcomp", "rc", default=False)
    interleaved_in = args.get_bool("interleaved", "int", default=False)
    fake_quality = args.get_int("qfake", default=30) \
        if args.has("qfake") else 30
    verify = args.get_bool("verifypairing", "vpair", default=False)
    uppercase = args.get_bool("touppercase", "tuc", default=False)

    if in1 is None:
        print("Usage: reformat in=<file> out=<file> [options]",
              file=sys.stderr)
        return 1

    rng = np.random.default_rng(sampleseed if sampleseed >= 0 else None)
    paired = in2 is not None or interleaved_in

    if args.get_int("hosts", default=1) > 1:
        print("reformat: hosts= > 1 (multi-host striping) is not ported yet",
              file=sys.stderr)
        return 1
    out_fmt1 = fastx.sniff_format(out1) if out1 else None
    out1_fh = fastx.xopen(out1, "wb") if out1 else None
    out2_fh = fastx.xopen(out2, "wb") if out2 else None

    def emit(fh, fmt, rec):
        if fh is None:
            return
        if fmt == "fasta":
            fh.write(b">" + rec.id.encode() + b"\n" + rec.bases + b"\n")
        else:
            q = rec.quality
            if q is None:
                q = bytes([fake_quality + 33]) * len(rec.bases)
            fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n"
                     + q + b"\n")

    def transform(rec: fastx.SeqRecord) -> Optional[fastx.SeqRecord]:
        bases = np.frombuffer(rec.bases, np.uint8).copy()
        qual = (np.frombuffer(rec.quality, np.uint8).astype(np.int16) - 33
                if rec.quality is not None else None)
        if uppercase:
            up = bases.copy()
            lo = (up >= ord("a")) & (up <= ord("z"))
            up[lo] -= 32
            bases = up
        a, b = 0, len(bases)
        if ftl > 0:
            a = min(ftl, b)
        if ftr >= 0:
            b = min(b, ftr + 1)
        if qtrim in ("r", "l", "rl", "t", "true") and qual is not None:
            pts = optimal_trim_points(
                bases[None, :], qual[None, :].astype(np.int8),
                np.array([len(bases)]), trimq)
            if qtrim in ("l", "rl", "t", "true"):
                a = max(a, int(pts[0, 0]))
            if qtrim in ("r", "rl", "t", "true"):
                b = min(b, len(bases) - int(pts[0, 1]))
        b = max(a, b)
        bases = bases[a:b]
        qual = qual[a:b] if qual is not None else None
        if do_rc:
            bases = COMP_ASCII[bases][::-1]
            qual = qual[::-1] if qual is not None else None
        if len(bases) < minlength:
            return None
        if 0 <= maxlength < len(bases):
            bases = bases[:maxlength]
            qual = qual[:maxlength] if qual is not None else None
        q = (bytes((qual + 33).astype(np.uint8))
             if qual is not None else None)
        return fastx.SeqRecord(rec.id, bytes(bases), q, rec.numeric_id)

    n_in = n_out = bases_in = bases_out = 0
    pair_name_mismatch = 0
    t0 = time.time()
    reader = fastx.PairedReader(in1, in2, interleaved_in,
                                qfin=args.get("qfin"),
                                qfin2=args.get("qfin2"))
    from ..core.batch import batched as _batched
    src = _batched(iter(reader), 8192)
    out_fmt2 = fastx.sniff_format(out2) if out2 else out_fmt1
    stop = False
    for chunk in src:
        if stop:
            break
        for r1, r2 in chunk:
            n_in += 1 if r2 is None else 2
            bases_in += len(r1.bases) + (len(r2.bases) if r2 else 0)
            if reads_cap >= 0 and n_out >= reads_cap:
                stop = True
                break
            if samplerate < 1.0 and rng.random() >= samplerate:
                continue
            if verify and r2 is not None:
                n1 = r1.id.split()[0].rstrip("/12")
                n2 = r2.id.split()[0].rstrip("/12")
                if n1 != n2:
                    pair_name_mismatch += 1
            t1 = transform(r1)
            t2 = transform(r2) if r2 is not None else None
            if t1 is None and t2 is None:
                continue
            if t1 is not None:
                emit(out1_fh, out_fmt1, t1)
                n_out += 1
                bases_out += len(t1.bases)
            if t2 is not None:
                fh = out2_fh if out2_fh is not None else out1_fh
                fmt = out_fmt2 if out2_fh is not None else out_fmt1
                emit(fh, fmt, t2)
                n_out += 1
                bases_out += len(t2.bases)
    for fh in (out1_fh, out2_fh):
        if fh is not None:
            fh.close()
    dt = time.time() - t0
    sys.stderr.write(
        f"Input:\t{n_in} reads\t{bases_in} bases\n"
        f"Output:\t{n_out} reads ({100.0*n_out/max(1,n_in):.2f}%)\t"
        f"{bases_out} bases ({100.0*bases_out/max(1,bases_in):.2f}%)\n"
        f"Time:\t{dt:.3f} seconds.\n")
    if verify:
        if pair_name_mismatch == 0:
            sys.stderr.write("Names appear to be correctly paired.\n")
        else:
            sys.stderr.write(
                f"WARNING: {pair_name_mismatch} pair name mismatches!\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
