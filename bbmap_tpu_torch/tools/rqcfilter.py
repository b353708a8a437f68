"""rqcfilter/bbqc: JGI production filtering pipeline.

reference: jgi/RQCFilter.java (2,352 LoC) + jgi/BBQC.java +
sh/rqcfilter.sh. Chains tool stages in-process (the reference invokes
each stage's class inside one JVM, RQCFilter.java:480 process()):

  1. adapter ktrim      (doTrim,   RQCFilter.ktrim:839)
  2. artifact filter    (doFilter, RQCFilter.filter:1000 — synthetic
                         contaminants + optional phiX/pJET)
  3. ribo removal       (riboFlag, RQCFilter.filterRibo:1100)
  4. nextera LMP split  (doNextera, RQCFilter.splitNextera:1193)
  5. bbmerge ihist      (doMerge,  RQCFilter.merge:1290)
  6. khist              (doKhist,  RQCFilter.khist)

Library presets (library=frag|lfpe|clip|clrs, RQCFilter.java:390-399,
:902-925) pick the trim reference: frag = fragment adapters (+tbo/tpe
when ktrim=r), lfpe/clrs = linker references, clip = short literal
linker with k=min(literal), mm=f, hdist=0.

Artifacts reproduced (RQCFilter.java:466-553, :805):
  <path>/file-list.txt    output-file manifest
  <path>/status.log       timestamped per-stage start/finish lines
  <path>/reproduce.sh     equivalent standalone shell commands
  <path>/filterStats.txt  reads/bases remaining after each stage
  per-stage bbduk stats   (adapterStats / filterStats_scaffolds / ...)

The port's copy of the JAX package's tool. ``device=`` (default cuda) goes
to every bbduk stage, to splitnexteralmp and to bbmerge. Reference files
have no default path: the adapters (``ref=``; ``lfpelinker=`` /
``clrslinker=`` for those presets), the artifacts (``artifactdb=``) and
phiX (``phixref=``) are named on the command line. A requested reference
that is not given or not found is named on stderr; its stage runs without
it (trim: quality trimming only), or is skipped when no reference is left
(filter, ribo). A paired run (``in2=``) stays paired through the chain:
the first stage reads both files, the later ones the interleaved pairs
(``interleaved=t``), the last writes ``out2=`` where it is given, and the
insert-size histogram and khist read the filtered pairs.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from ..io import fastx
from ..utils.args import Args
from . import bbduk

DEFAULT_CLIP_LINKER = "GGTTCATCGTCAGG"   # reference clipLinker default


class _Pipeline:
    def __init__(self, path: str, argv: List[str], log_name: str,
                 file_list: str, reproduce: str):
        self.path = path
        self.log_path = os.path.join(path, log_name)
        self.file_list_path = os.path.join(path, file_list)
        self.reproduce_path = os.path.join(path, reproduce)
        os.makedirs(path, exist_ok=True)
        with open(self.log_path, "w") as fh:
            fh.write(self._stamp("start") + "\n")
        # reproduce header (reference: writeReproduceHeader)
        with open(self.reproduce_path, "w") as fh:
            fh.write("#!/bin/bash\n")
            fh.write("#bbmap_tpu_torch rqcfilter\n")
            fh.write("#The steps below recapitulate the output of "
                     "RQCFilter when run like this:\n")
            fh.write("#rqcfilter " + " ".join(argv) + "\n\n")
        self.stage_stats: List[str] = []

    def _stamp(self, msg: str) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%S") + "\t" + msg

    def log(self, msg: str):
        with open(self.log_path, "a") as fh:
            fh.write(self._stamp(msg) + "\n")

    def reproduce(self, tool: str, tool_args: List[str]):
        with open(self.reproduce_path, "a") as fh:
            fh.write(f"{tool} " + " ".join(tool_args) + "\n")

    def write_file_list(self, entries: List[str]):
        with open(self.file_list_path, "w") as fh:
            fh.write("\n".join(entries) + ("\n" if entries else ""))

    def remaining(self, stage: str, path1: str,
                  path2: Optional[str] = None):
        reads = bases = 0
        for p in (path1, path2):
            if not p or not os.path.exists(p):
                continue
            for rec in fastx.read_seqs(p):
                reads += 1
                bases += len(rec.bases)
        self.log(f"#Remaining:\t{reads} reads\t{bases} bases")
        self.stage_stats.append(f"{stage}\t{reads}\t{bases}")
        return reads, bases


def _reference(stage: str, key: str, path: Optional[str]) -> Optional[str]:
    """``path`` when it names a file; else None, and stderr says that the
    stage runs without the reference named by ``key``."""
    if path and os.path.exists(path):
        return path
    why = f"{path} not found" if path else "not given"
    sys.stderr.write(f"rqcfilter: {stage} stage: no {key} reference "
                     f"({why}); the stage runs without it\n")
    return None


def _deinterleave(src: str, out1: str, out2: str) -> None:
    """Write the interleaved pairs of ``src`` to ``out1`` / ``out2``."""
    with fastx.xopen(out1, "wb") as o1, fastx.xopen(out2, "wb") as o2:
        for r1, r2 in fastx.PairedReader(src, None, True):
            for fh, rec in ((o1, r1), (o2, r2)):
                q = rec.quality if rec.quality is not None \
                    else b"I" * len(rec.bases)
                fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases
                         + b"\n+\n" + q + b"\n")


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out = args.get("out", "out1")
    out2 = args.get("out2")
    path = args.get("path", default=".")
    library = (args.get("library", "lib", default="frag") or
               "frag").lower()
    adapters = args.get("ref", "adapters", "fragadapter")
    artifacts = args.get("artifactdb", "artifacts")
    riboref = args.get("ribodb", "riboref")
    phix = args.get("phixref")
    trimq = args.get_int("trimq", default=10)
    qtrim = args.get("qtrim", default="rl")
    minlength = args.get_int("minlength", "ml", default=45)
    maq = args.get_int("maq", default=0)
    maxns = args.get_int("maxns", default=-1)
    ftm = args.get_int("forcetrimmod", "ftm", default=0)
    trim_k = args.get_int("trimk", default=23)
    filter_k = args.get_int("filterk", default=31)
    mink = args.get_int("mink", default=11)
    hdist_trim = args.get_int("trimhdist", default=1)
    hdist_filter = args.get_int("filterhdist", default=1)
    do_trim = args.get_bool("trimflag", "ktrimflag", default=True)
    do_filter = args.get_bool("filterflag", "filter", default=True)
    do_phix = args.get_bool("phix", "removephix", default=True)
    do_ribo = args.get_bool("ribo", default=False)
    do_nextera = args.get_bool("nextera", "nexteralmp", default=False)
    ihist = args.get("ihist")
    do_khist = args.get_bool("khist", default=False)
    ktrim = args.get("ktrim", default="r")
    tbo = args.get_bool("tbo", default=True)
    tpe = args.get_bool("tpe", default=True)
    device = args.get("device", default="cuda")
    if in1 is None or out is None:
        print("Usage: rqcfilter in=<reads> [in2=] out=<clean> "
              "path=<outdir> [library=frag|lfpe|clip|clrs] [phix=t] "
              "[ribo=f ribodb=<ref>] [nextera=f] [ihist=<file>]",
              file=sys.stderr)
        return 1
    if library not in ("frag", "lfpe", "clip", "clrs"):
        print(f"Unknown library type {library}", file=sys.stderr)
        return 1

    pipe = _Pipeline(path, argv, "status.log", "file-list.txt",
                     "reproduce.sh")
    out_in_path = os.path.join(path, out) if os.sep not in out else out
    out2_in_path = (os.path.join(path, out2)
                    if out2 and os.sep not in out2 else out2)

    # stage plan (reference: numSteps accounting, RQCFilter.java:616)
    steps = []
    if do_trim:
        steps.append("trim")
    if do_filter:
        steps.append("filter")
    if do_ribo and riboref:
        steps.append("ribo")
    elif do_ribo:
        sys.stderr.write("rqcfilter: ribo stage: no ribodb reference (not "
                         "given); the stage is skipped\n")
    if do_nextera:
        steps.append("nextera")

    cur1, cur2 = in1, in2
    paired = in2 is not None
    rc = 0
    for i, stage in enumerate(steps):
        last = i == len(steps) - 1
        if stage == "nextera":
            break           # terminal stage handled below
        nxt1 = out_in_path if last else os.path.join(
            path, f"rqc_{stage}.fq.gz")
        nxt2 = out2_in_path if last else None
        sargs = [f"in={cur1}", f"out={nxt1}"]
        if cur2:
            sargs.append(f"in2={cur2}")
        elif paired:
            sargs.append("interleaved=t")
        if nxt2:
            sargs.append(f"out2={nxt2}")
        if stage == "trim":
            pipe.log("ktrim start")
            # library presets pick the trim reference and special
            # flags (reference: RQCFilter.java:902-925)
            if library in ("frag", "lfpe", "clrs"):
                key = {"frag": "ref", "lfpe": "lfpelinker",
                       "clrs": "clrslinker"}[library]
                ref = _reference("trim", key, adapters if key == "ref"
                                 else args.get(key))
                if ref:
                    sargs.append(f"ref={ref}")
                sargs += [f"ktrim={ktrim}", f"k={trim_k}", f"mink={mink}",
                          f"hdist={hdist_trim}"]
                if library == "frag" and ktrim == "r":
                    if tbo:
                        sargs.append("tbo")
                    if tpe:
                        sargs.append("tpe")
            elif library == "clip":
                # short literal linker: k = literal length, exact
                # match only (reference: RQCFilter.java:907-924)
                lit = args.get("cliplinker",
                               default=DEFAULT_CLIP_LINKER)
                sargs += [f"literal={lit}", f"ktrim={ktrim}",
                          f"k={min(len(x) for x in lit.split(','))}",
                          "mm=f", "hdist=0"]
            sargs += [f"qtrim={qtrim}", f"trimq={trimq}",
                      f"minlength={minlength}"]
            if ftm > 0:
                sargs.append(f"ftm={ftm}")
            sargs.append(
                f"stats={os.path.join(path, 'adapterStats.txt')}")
        elif stage == "filter":
            pipe.log("filter start")
            refs = [_reference("filter", "artifactdb", artifacts)]
            if do_phix:
                refs.append(_reference("filter", "phixref", phix))
            refs = [r for r in refs if r]
            if not refs:
                pipe.log("filter skip (no references present)")
                if last:
                    import shutil
                    if paired and cur2 is None and nxt2:
                        _deinterleave(cur1, nxt1, nxt2)
                    else:
                        shutil.copyfile(cur1, nxt1)
                        if cur2 and nxt2:
                            shutil.copyfile(cur2, nxt2)
                    cur1, cur2 = nxt1, nxt2
                continue
            sargs += [f"ref={','.join(refs)}", f"k={filter_k}",
                      f"hdist={hdist_filter}",
                      f"minlength={minlength}",
                      f"stats={os.path.join(path, 'filterStats_scaffolds.txt')}"]
            if maq > 0:
                sargs.append(f"maq={maq}")
            if maxns >= 0:
                sargs.append(f"maxns={maxns}")
        elif stage == "ribo":
            pipe.log("ribo start")
            sargs += [f"ref={riboref}", "k=31",
                      f"hdist={args.get_int('ribohdist', default=0)}",
                      f"minlength={minlength}",
                      f"stats={os.path.join(path, 'riboStats.txt')}"]
        sargs.append(f"device={device}")
        pipe.reproduce("bbduk", sargs)
        rc = bbduk.main(sargs)
        if rc != 0:
            pipe.log(f"{stage} failed")
            return rc
        pipe.remaining(stage, nxt1, nxt2)
        pipe.log(("ktrim" if stage == "trim" else stage) + " finish")
        if cur1 not in (in1, in2) and os.path.exists(cur1):
            os.unlink(cur1)
        cur1, cur2 = nxt1, nxt2

    file_list = []
    if do_nextera:
        # terminal Nextera LMP split (reference: splitNextera:1193 —
        # output name set derived from the raw name)
        pipe.log("splitNextera start")
        from .pairtools import splitnexteralmp
        base = os.path.basename(out)
        stem = base[:-len(".fq.gz")] if base.endswith(".fq.gz") \
            else base.rsplit(".", 1)[0]
        lmp = os.path.join(path, stem + ".lmp.fq.gz")
        frag = os.path.join(path, stem + ".frag.fq.gz")
        unk = os.path.join(path, stem + ".unknown.fq.gz")
        single = os.path.join(path, stem + ".singleton.fq.gz")
        nstats = os.path.join(path, "nexteraStats.txt")
        nargs = [f"in={cur1}", f"out={lmp}", f"outf={frag}",
                 f"outu={unk}", f"outs={single}", f"stats={nstats}",
                 f"minlen={minlength}", f"device={device}"]
        if cur2:
            nargs.insert(1, f"in2={cur2}")
        elif paired:
            nargs.insert(1, "interleaved=t")
        pipe.reproduce("splitnexteralmp", nargs)
        rc = splitnexteralmp(nargs)
        if rc != 0:
            pipe.log("splitNextera failed")
            return rc
        pipe.remaining("nextera", lmp)
        pipe.log("splitNextera finish")
        file_list += [f"lmp={os.path.basename(lmp)}",
                      f"frag={os.path.basename(frag)}",
                      f"unknown={os.path.basename(unk)}",
                      f"singleton={os.path.basename(single)}"]
        if cur1 not in (in1, in2) and os.path.exists(cur1):
            os.unlink(cur1)
    else:
        if not steps:
            # no stages: pass input through
            import shutil
            shutil.copyfile(in1, out_in_path)
            if in2 and out2:
                shutil.copyfile(in2, out2_in_path)
        file_list.append(f"filtered_fastq={os.path.basename(out)}")
        if out2:
            file_list.append(
                f"filtered_fastq_2={os.path.basename(out2)}")

    # insert-size histogram via bbmerge (reference: merge:1290)
    if ihist and not paired and not do_nextera:
        pipe.log("merge skip (unpaired input)")
    elif ihist:
        pipe.log("merge start")
        from . import bbmerge
        ih = ihist if os.sep in ihist else os.path.join(path, ihist)
        # the chain's filtered pairs (in2= where the last stage wrote
        # out2=, else interleaved); the raw pairs ahead of a Nextera split
        src1, src2 = (in1, in2) if do_nextera else (cur1, cur2)
        margs = [f"in={src1}", f"ihist={ih}", f"device={device}"]
        if src2:
            margs.insert(1, f"in2={src2}")
        pipe.reproduce("bbmerge", margs)
        try:
            bbmerge.main(margs)
            file_list.append(f"ihist={os.path.basename(ih)}")
        except Exception as e:   # merge failure is non-fatal
            pipe.log(f"merge failed ({type(e).__name__}: {e})")
            sys.stderr.write(f"rqcfilter: merge failed "
                             f"({type(e).__name__}: {e})\n")
        pipe.log("merge finish")

    if do_khist:
        pipe.log("khist start")
        from . import kmercountexact
        kh = os.path.join(path, "khist.txt")
        pk = os.path.join(path, "peaks.txt")
        kargs = [f"in={cur1}", f"khist={kh}", f"peaks={pk}", "k=31"]
        if cur2:
            kargs.insert(1, f"in2={cur2}")
        pipe.reproduce("kmercountexact", kargs)
        try:
            kmercountexact.main(kargs)
            file_list += [f"khist={os.path.basename(kh)}",
                          f"peaks={os.path.basename(pk)}"]
        except Exception as e:
            pipe.log(f"khist failed ({type(e).__name__}: {e})")
            sys.stderr.write(f"rqcfilter: khist failed "
                             f"({type(e).__name__}: {e})\n")
        pipe.log("khist finish")

    # combined per-stage stats (reference: rqcStats, RQCFilter.java:805)
    with open(os.path.join(path, "filterStats.txt"), "w") as fh:
        fh.write("#Stage\tReadsRemaining\tBasesRemaining\n")
        fh.write("\n".join(pipe.stage_stats)
                 + ("\n" if pipe.stage_stats else ""))
    pipe.write_file_list(file_list)
    pipe.log("finish")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
