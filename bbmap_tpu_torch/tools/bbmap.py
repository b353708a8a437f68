"""bbmap: k-mer-indexed banded-affine-DP read aligner (CLI front-end),
PyTorch port of bbmap_tpu/tools/bbmap.py.

reference: align2/BBMap.java:24 + sh/bbmap.sh. Flag-for-flag compatible for
the core mapping flags. ``device=`` selects the torch device (default
cuda; device=cpu runs the plain PyTorch versions of the kernels). The
multi-host (hosts=, shardindex=) and profiler (profiledir=) options are
not yet ported and raise.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List

import numpy as np

from ..core.batch import ReadBatch, batched
from ..core.genome import build_genome, genome_hash
from ..index.build import (analyze_index, build_index, load_index,
                                   save_index, set_fraction_to_exclude)
from ..io import fastx
from ..io import sam as samio
from ..utils.args import Args

from ..align.pipeline import BBMapAligner, emit_sam


def _apply_presets(argv: List[str]) -> List[str]:
    """fast= / slow= / vslow= arg-rewrites (reference:
    align2/BBMap.java:66-131 — each preset PREPENDS flags so explicit
    user flags still win; the exclude fraction scales with the preset).
    Sensitivity knobs that exist in this engine: minratio, maxindel,
    maxsites, excludefraction, rescue distances."""
    lower = [a.split("=")[0].lower() for a in argv]

    def on(name):
        if name not in lower:
            return False
        v = argv[lower.index(name)].partition("=")[2].lower()
        return v in ("", "t", "true", "1")

    base_frac = 0.03
    pre: List[str] = []
    if on("fast"):
        # reference: :66-97
        pre = ["maxindel=80", "minratio=0.65", "maxsites=3",
               f"excludefraction={base_frac * 1.25:g}"]
    elif on("slow"):
        # reference: :99-117
        pre = ["minratio=0.45",
               f"excludefraction={base_frac * 0.4:g}"]
    elif on("vslow"):
        # reference: :100-131
        pre = ["minratio=0.25", "excludefraction=0"]
    if not pre:
        return argv
    keep = [a for a in argv
            if a.split("=")[0].lower() not in ("fast", "slow", "vslow")]
    return pre + keep


def main(argv: List[str]) -> int:
    argv = _apply_presets(argv)
    args = Args.parse(argv)
    for opt in ("hosts", "hostid", "coordinator", "shardindex",
                "indexshard", "profiledir"):
        if args.get(opt) is not None:
            raise NotImplementedError(f"{opt}= is not yet ported")
    device = args.get("device", default="cuda")
    ref = args.get("ref")
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out = args.get("out", "outm")
    k = args.get_int("k", "keylen", default=13)
    min_ratio = args.get_float("minratio", default=0.56)
    minid = args.get("minid", "minidentity")
    if minid is not None:
        from ..core.constants import min_id_to_min_ratio
        min_ratio = min_id_to_min_ratio(float(minid))
    # excludefraction= overrides the genome-size-scaled quantile
    # (reference: BBIndex.setFractionToExclude, preset-adjusted)
    excl_frac = args.get_float("excludefraction", default=-1.0)
    nodisk = args.get_bool("nodisk", default=False)
    ambig = args.get("ambig", "ambiguous", default="best")
    maxindel = args.get_int("maxindel", default=16000)
    batch_size = args.get_int("batchsize", default=4096)
    interleaved = args.get_bool("interleaved", "int", default=False)
    samio.MAKE_MD_TAG = args.get_bool("mdtag", "md", default=False)
    local = args.get_bool("local", default=False)
    secondary = args.get_bool("secondary", default=False)
    max_sites = args.get_int("maxsites", "sssr", default=5)
    qtrim = (args.get("qtrim", default="f") or "f").lower()
    trimq = args.get_int("trimq", default=6)
    untrim = args.get_bool("untrim", default=False)
    usemodulo = args.get_bool("usemodulo", default=False)
    # RNA-seq splice emission (reference: align2/BBMap.java:239-240 —
    # intronlen sets INTRON_LIMIT so deletions >= it print as N ops;
    # XS strand tag auto-enables when intronlen is set)
    intronlen = args.get_int("intronlen", "intron", default=0)
    xs_arg = args.get("xstag", "xs")
    samio.INTRON_LIMIT = 2 ** 31 - 1   # reset statics (in-process runs)
    samio.MAKE_XS_TAG = False
    samio.XS_SECONDSTRAND = False
    if intronlen > 0:
        samio.INTRON_LIMIT = intronlen
    if xs_arg is not None:
        samio.MAKE_XS_TAG = xs_arg.lower() not in ("f", "false", "0")
        samio.XS_SECONDSTRAND = xs_arg.lower() in ("ss", "secondstrand")
        if samio.MAKE_XS_TAG and intronlen <= 0:
            samio.INTRON_LIMIT = 10
    elif intronlen > 0:
        samio.MAKE_XS_TAG = True

    if ref is None or in1 is None:
        print("Usage: bbmap ref=<fasta> in=<reads> [in2=] out=<sam>",
              file=sys.stderr)
        return 1

    t0 = time.time()
    maxchromlen = args.get_int("maxchromlen", default=0)
    if maxchromlen > 0:
        genome = build_genome(ref, max_length=maxchromlen)
    else:
        genome = build_genome(ref)
    sys.stderr.write(f"Loaded Reference:\t{time.time()-t0:.3f} seconds.\n")

    t1 = time.time()
    index = None
    if not nodisk:
        cache_dir = os.path.join(
            os.path.dirname(os.path.abspath(ref)), "ref_tpu")
        os.makedirs(cache_dir, exist_ok=True)
        mod_tag = "_mod9" if usemodulo else ""
        if excl_frac >= 0:
            mod_tag += f"_x{excl_frac:g}"
        cache = os.path.join(
            cache_dir, f"index_{genome_hash(ref, k)}{mod_tag}.npz")
        if os.path.exists(cache):
            index = load_index(cache)
    if index is None:
        index = build_index(genome, k, usemodulo=usemodulo)
        frac = excl_frac if excl_frac >= 0 else \
            set_fraction_to_exclude(genome.total_bases())
        analyze_index(index, frac)
        if not nodisk:
            save_index(index, cache)
    sys.stderr.write(
        f"Generated Index:\t{time.time()-t1:.3f} seconds.\n")

    # scoring profile: profile=pacbio selects the MSA9PacBio stack
    # (reference: align2/BBMapPacBio.java MSA_TYPE, BBMapThreadPacBio)
    profile = None
    if (args.get("profile") or "").lower() in ("pacbio", "pb"):
        from ..core.constants import PACBIO_PROFILE
        profile = PACBIO_PROFILE
    aligner = BBMapAligner(genome, index, device, min_ratio=min_ratio,
                           ambig_mode=ambig,
                           chain_dist=min(400, maxindel) if maxindel > 0
                           else 0, local=local,
                           print_secondary=secondary,
                           max_sites=max_sites, profile=profile)
    out_fh = None
    if out:
        out_fh = samio.open_sam_writer(out)
        for line in samio.sam_header(genome):
            out_fh.write(line + "\n")

    # histogram battery (reference: align2/ReadStats flags,
    # docs/UsageGuide.txt:277-283) + per-scaffold stats
    from ..utils.readstats import ReadStats
    hist_flags = {h: args.get(h) for h in
                  ("qhist", "lhist", "gchist", "ihist", "idhist",
                   "indelhist", "mhist", "ehist", "bqhist", "timehist")}
    stats = ReadStats() if any(hist_flags.values()) else None
    scafstats_path = args.get("scafstats")
    scaf_counts = {} if scafstats_path else None

    def accumulate(batch, results):
        if stats is not None:
            stats.add_batch(batch.bases, batch.quality, batch.lengths)
            for r in results:
                if r.mapped and r.match is not None:
                    stats.add_match(r.match)
        if scaf_counts is not None:
            for r in results:
                if r.mapped:
                    scaf, _ = genome.locate(r.chrom, r.start)
                    scaf_counts[scaf.name] = \
                        scaf_counts.get(scaf.name, 0) + 1

    paired = in2 is not None or interleaved
    n_reads = 0
    n_mapped = 0
    t2 = time.time()
    do_qtrim = qtrim in ("r", "l", "rl", "t", "true")

    def trim_records(recs):
        """qtrim before mapping; returns (trimmed recs, (ltrim, orig))
        per read for untrim (reference: align2/TrimRead.trim/untrim —
        untrim restores bases and adjusts SAM pos with soft-clips)."""
        if not do_qtrim:
            return recs, None
        from ..utils.qtrim import optimal_trim_points
        out = []
        info = []
        for r in recs:
            bb = np.frombuffer(r.bases, np.uint8)
            qq = (np.frombuffer(r.quality, np.uint8).astype(np.int16)
                  - 33).astype(np.int8) if r.quality else None
            if qq is None:
                out.append(r)
                info.append((0, r))
                continue
            pts = optimal_trim_points(bb[None, :], qq[None, :],
                                      np.array([len(bb)]), trimq)
            lt = int(pts[0, 0]) if qtrim in ("l", "rl", "t", "true") \
                else 0
            rt = int(pts[0, 1]) if qtrim in ("r", "rl", "t", "true") \
                else 0
            lt = min(lt, len(bb))
            rt = min(rt, len(bb) - lt)
            if lt or rt:
                nb = r.bases[lt:len(bb) - rt]
                nq = r.quality[lt:len(bb) - rt]
                out.append(fastx.SeqRecord(r.id, nb, nq, r.numeric_id))
            else:
                out.append(r)
            info.append((lt, r))
        return out, info

    def apply_untrim(results, info):
        if info is None or not untrim:
            return
        for res, (lt, orig) in zip(results, info):
            if not res.mapped or res.match is None:
                continue
            L0 = len(orig.bases)
            rt = L0 - lt - (len(res.match)
                            - res.match.count(b"D"[0])
                            - res.match.count(b"-"[0]))
            rt = max(0, rt)
            if lt == 0 and rt == 0:
                continue
            # minus-strand reads: trimming was applied in read orientation,
            # clips swap ends in reference orientation
            a, b_ = (lt, rt) if res.strand == 0 else (rt, lt)
            res.match = b"C" * a + res.match + b"C" * b_
            res.start -= a
            res.stop += b_

    # hung-run watchdog: aborts if no batch completes for 30 min
    # (reference: stream/KillSwitch.java:17 kill timer around the
    # map/print loop)
    from ..utils.watchdog import Watchdog
    dog = Watchdog(max_seconds=float(
        args.get_int("watchdogsecs", default=1800))).start()
    reader = fastx.PairedReader(in1, in2, interleaved,
                                qfin=args.get("qfin"),
                                qfin2=args.get("qfin2"))
    # reader thread decodes batch N+1 while N maps (reference P2:
    # stream/ConcurrentGenericReadInputStream.java:122-166)
    from collections import deque

    from ..core.batch import prefetch
    batches = enumerate(batched(iter(reader), batch_size))

    # producer prepares batch N+1 (decode + trim) and queues its
    # metadata while the aligner stream holds batch N's dispatch in
    # flight on the device — the CLI now uses the same dispatch/finalize
    # overlap the bench measures (map_stream / map_pairs_stream;
    # reference P2: reader/worker thread overlap,
    # stream/ConcurrentGenericReadInputStream.java:122-166)
    meta_q = deque()

    def produce():
        for batch_id, chunk in prefetch(batches, depth=2):
            recs1 = [p[0] for p in chunk]
            recs1, info1 = trim_records(recs1)
            b1 = ReadBatch.from_records(recs1)
            if paired:
                recs2 = [p[1] for p in chunk]
                recs2, info2 = trim_records(recs2)
                b2 = ReadBatch.from_records(recs2)
                meta_q.append((batch_id, recs1, info1, info2, b1, b2))
                yield b1, b2
            else:
                meta_q.append((batch_id, recs1, info1, None, b1, None))
                yield b1

    results_iter = (aligner.map_pairs_stream(produce()) if paired
                    else aligner.map_batches_stream(produce()))
    for result in results_iter:
        dog.tick()
        t_batch = time.time()
        batch_id, recs1, info1, info2, b1, b2 = meta_q.popleft()
        if paired:
            res1, res2 = result
            if untrim:
                apply_untrim(res1, info1)
                apply_untrim(res2, info2)
                b1 = ReadBatch.from_records([t[1] for t in info1]) \
                    if info1 else b1
                b2 = ReadBatch.from_records([t[1] for t in info2]) \
                    if info2 else b2
            lines = emit_sam(genome, b1, res1, res2, b2)
            n_reads += 2 * len(recs1)
            n_mapped += sum(r.mapped for r in res1)
            n_mapped += sum(r.mapped for r in res2)
            accumulate(b1, res1)
            accumulate(b2, res2)
            if stats is not None:
                for r1m, r2m in zip(res1, res2):
                    if r1m.paired:
                        stats.add_insert(
                            abs(max(r1m.stop, r2m.stop)
                                - min(r1m.start, r2m.start)) + 1)
        else:
            res1 = result
            if untrim:
                apply_untrim(res1, info1)
                b1 = ReadBatch.from_records([t[1] for t in info1]) \
                    if info1 else b1
            lines = emit_sam(genome, b1, res1)
            n_reads += len(recs1)
            n_mapped += sum(r.mapped for r in res1)
            accumulate(b1, res1)
        if out_fh is not None:
            out_fh.write("\n".join(lines) + "\n")
        if stats is not None:
            stats.add_time(time.time() - t_batch,
                           (2 if paired else 1) * len(recs1))
    dog.stop()
    if out_fh is not None and out_fh not in (sys.stdout,):
        out_fh.close()
    dt = time.time() - t2
    if stats is not None:
        writers = dict(qhist=stats.write_qhist, lhist=stats.write_lhist,
                       gchist=stats.write_gchist, ihist=stats.write_ihist,
                       idhist=stats.write_idhist,
                       indelhist=stats.write_indelhist,
                       mhist=stats.write_mhist, ehist=stats.write_ehist,
                       bqhist=stats.write_bqhist,
                       timehist=stats.write_timehist)
        for flag, path in hist_flags.items():
            if path:
                writers[flag](path)
    if scaf_counts is not None and scafstats_path:
        with open(scafstats_path, "w") as fh:
            fh.write("#name\tassignedReads\tassignedPct\n")
            for name, cnt in sorted(scaf_counts.items(),
                                    key=lambda kv: -kv[1]):
                fh.write(f"{name}\t{cnt}\t"
                         f"{100.0*cnt/max(1,n_reads):.4f}%\n")
    sys.stderr.write(
        f"Mapped:\t{n_reads} reads\t{n_mapped} mapped "
        f"({100.0*n_mapped/max(1,n_reads):.3f}%)\n"
        f"Time:\t{dt:.3f} seconds.\t"
        f"Reads/sec:\t{n_reads/max(dt,1e-9):.0f}\n")
    fbn = getattr(aligner, "_n_fallback_rows", 0)
    fbe = getattr(aligner, "_n_esc_rows", 0)
    if fbn and fbn > 0.005 * max(1, fbe):
        # device wide/trace/slot budget overflow visibility (ADVICE r4:
        # a repetitive genome can saturate the fixed wide-lane budgets
        # and silently push rows to the exact-but-slow host refit)
        sys.stderr.write(
            f"NOTE: {fbn} of {fbe} escalated rows "
            f"({100.0*fbn/max(1,fbe):.2f}%) overflowed device budgets "
            f"and took the host refit path (exact, but slow — "
            f"consider larger budgets for this reference).\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))


def acc_main(argv: List[str]) -> int:
    """bbmapacc: the accuracy-leaning variant (reference:
    align2/BBMapAcc.java setDefaults:44-66 — denser seeding
    keyDensity 2.3/3.2/1.8, MIN_APPROX_HITS_TO_KEEP=1, up to 8 site
    scores). The engine has ONE unified index/thread stack (the CSR
    block layout already is BBIndexAcc/BBIndex5's flat-array design),
    so the variant is its parameter set, applied here."""
    from ..align import seed
    saved = (seed.KEY_DENSITY, seed.MAX_KEY_DENSITY,
             seed.MIN_KEY_DENSITY)
    seed.KEY_DENSITY, seed.MAX_KEY_DENSITY, seed.MIN_KEY_DENSITY = \
        2.3, 3.2, 1.8
    try:
        extra = []
        keys = {a.split("=")[0].lower() for a in argv if "=" in a}
        if "maxsites" not in keys and "sssr" not in keys:
            extra.append("maxsites=8")
        return main(argv + extra)
    finally:
        (seed.KEY_DENSITY, seed.MAX_KEY_DENSITY,
         seed.MIN_KEY_DENSITY) = saved


def bbmap5_main(argv: List[str]) -> int:
    """bbmap5 (reference: align2/BBMap5.java over BBIndex5.java:16 —
    'a single array per block, 32-bit unsigned'). That memory layout IS
    this engine's CSR index (one flat int32 sites array per shard), so
    bbmap5 runs the standard pipeline; the name exists for CLI
    compatibility."""
    return main(argv)


def skimmer_main(argv: List[str]) -> int:
    """bbmapskimmer: emit ALL sites above threshold, not just the best
    (reference: sh/bbmapskimmer.sh via BBMapSkimmer stack,
    docs/guides/BBMapGuide.txt:106 — 'returns all alignments above a
    score threshold'). Implemented as bbmap with secondary-site output
    and ambig=all defaults."""
    extra = []
    keys = {a.split("=")[0].lower() for a in argv if "=" in a}
    if "ambig" not in keys and "ambiguous" not in keys:
        extra.append("ambig=all")
    if "secondary" not in keys:
        extra.append("secondary=t")
    if "maxsites" not in keys and "sssr" not in keys:
        extra.append("maxsites=20")
    if "minratio" not in keys:
        extra.append("minratio=0.45")
    return main(argv + extra)
