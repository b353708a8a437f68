"""Tool dispatcher: ``python -m bbmap_tpu_torch <tool> key=value ...``

The port's counterpart of ``python -m bbmap_tpu``. The ported tools are
the short-read mapper ``bbmap`` with its variants ``bbmapacc`` (denser
seeding), ``bbmap5`` and ``bbmapskimmer`` (every site above a threshold,
``secondary=t``), ``bbsplit`` (binning reads between references), the
long-read mappers ``mappacbio`` and ``mappacbioskimmer``, ``dedupe`` /
``dedupe2`` (duplicate and containment removal on the banded edit
distance kernel), the read-preprocessing tools ``bbduk``, ``bbduk2``
(k-mer trimming and filtering), ``seal`` (k-mer binning), ``bbmerge`` /
``bbmerge-auto`` (pair merging) and ``bbmask`` (entropy masking), and the
read simulator and SAM grader the smoke run uses (``randomreads``,
``gradesam``), and the k-mer counting and QC tools: ``kmercountexact`` /
``khist`` / ``callpeaks`` (exact counting), ``tadpole`` /
``tadpolewrapper`` / ``tadwrapper`` (assembly), ``bbnorm`` / ``ecc``
(depth normalization and error correction on the counting Bloom filter),
``pileup``, the coverage tools ``kmercoverage``, ``filterbycoverage``,
``decontaminate`` / ``crossblock``, ``crosscontaminate`` and
``postfilter``, the pair tools ``splitpairs`` / ``bbsplitpairs`` /
``repair``, ``filterbyname``, ``demuxbyname`` and ``splitnexteralmp`` /
``splitnextera``, and the QC chain ``rqcfilter`` / ``bbqc``.

The host tools, copies of the JAX package's that run on the host as they
do there: ``reformat``, ``stats``, ``comparesam``, ``samtoroc`` and
``calctruequality``; the k-mer sketch and clumping tools ``clumpify``,
``loglog``, ``sketch`` / ``comparesketch``, ``bbcountunique`` and
``reclusterbykmer``; the alignment small tools ``idmatrix``, ``idtree``,
``msa``, ``cutprimers``, ``commonkmers`` and ``removesmartbell``; the
jgi/driver long tail (``countgc`` ... ``dedupebymapping``); the taxonomy
suite (``printtaxonomy``, ``taxtree``, ``gi2taxid``, ...); the synthetic
data tools (``mutategenome`` / ``mutate``, ``shred``, ``fakereads`` /
``bbfakereads``, ...); the barcode tools; ``sortsam``, ``sortbyname``,
``grademerge``, ``callvariants`` / ``applyvariants``, ``shuffle``,
``partition``, ``translate6frames``, ``kcompress``, ``filterbysequence``
and ``bbwrap``; the PacBio site-stack pipeline (``stacksites`` ...
``splitoffperfectcontigs``); the text utilities (``bbgrep``,
``linecount``, ...); and ``liftover`` / ``translator``. Of these only
``bbwrap`` maps reads: it hands its arguments, ``device=`` with them, to
``bbmap`` for each input.

Each entry names a module and its entry point; the tools that run on a
device take ``device=`` (default cuda).
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {
    "bbmap": ("bbmap_tpu_torch.tools.bbmap", "main"),
    "bbmapacc": ("bbmap_tpu_torch.tools.bbmap", "acc_main"),
    "bbmap5": ("bbmap_tpu_torch.tools.bbmap", "bbmap5_main"),
    "bbmapskimmer": ("bbmap_tpu_torch.tools.bbmap", "skimmer_main"),
    "bbsplit": ("bbmap_tpu_torch.tools.bbsplit", "main"),
    "dedupe": ("bbmap_tpu_torch.tools.dedupe", "main"),
    "dedupe2": ("bbmap_tpu_torch.tools.dedupe", "dedupe2_main"),
    "mappacbio": ("bbmap_tpu_torch.tools.mappacbio", "main"),
    "mappacbioskimmer": ("bbmap_tpu_torch.tools.mappacbio", "skimmer_main"),
    "randomreads": ("bbmap_tpu_torch.tools.randomreads", "main"),
    "gradesam": ("bbmap_tpu_torch.tools.gradesam", "main"),
    "bbduk": ("bbmap_tpu_torch.tools.bbduk", "main"),
    "bbduk2": ("bbmap_tpu_torch.tools.bbduk2", "main"),
    "seal": ("bbmap_tpu_torch.tools.seal", "main"),
    "bbmerge": ("bbmap_tpu_torch.tools.bbmerge", "main"),
    "bbmerge-auto": ("bbmap_tpu_torch.tools.bbmerge", "main"),
    "bbmask": ("bbmap_tpu_torch.tools.bbmask", "main"),
    "kmercountexact": ("bbmap_tpu_torch.tools.kmercountexact", "main"),
    "khist": ("bbmap_tpu_torch.tools.kmercountexact", "main"),
    "callpeaks": ("bbmap_tpu_torch.tools.kmercountexact", "callpeaks_main"),
    "tadpole": ("bbmap_tpu_torch.tools.tadpole", "main"),
    "tadpolewrapper": ("bbmap_tpu_torch.tools.tadpole", "wrapper_main"),
    "tadwrapper": ("bbmap_tpu_torch.tools.tadpole", "wrapper_main"),
    "bbnorm": ("bbmap_tpu_torch.tools.bbnorm", "main"),
    "ecc": ("bbmap_tpu_torch.tools.bbnorm", "ecc_main"),
    "pileup": ("bbmap_tpu_torch.tools.pileup", "main"),
    "kmercoverage": ("bbmap_tpu_torch.tools.covtools", "kmercoverage"),
    "filterbycoverage": ("bbmap_tpu_torch.tools.covtools",
                         "filterbycoverage"),
    "decontaminate": ("bbmap_tpu_torch.tools.covtools", "decontaminate"),
    "crossblock": ("bbmap_tpu_torch.tools.covtools", "decontaminate"),
    "crosscontaminate": ("bbmap_tpu_torch.tools.covtools",
                         "crosscontaminate"),
    "postfilter": ("bbmap_tpu_torch.tools.covtools", "postfilter"),
    "splitpairs": ("bbmap_tpu_torch.tools.pairtools", "splitpairs"),
    "bbsplitpairs": ("bbmap_tpu_torch.tools.pairtools", "splitpairs"),
    "repair": ("bbmap_tpu_torch.tools.pairtools", "splitpairs"),
    "filterbyname": ("bbmap_tpu_torch.tools.pairtools", "filterbyname"),
    "demuxbyname": ("bbmap_tpu_torch.tools.pairtools", "demuxbyname"),
    "splitnexteralmp": ("bbmap_tpu_torch.tools.pairtools",
                        "splitnexteralmp"),
    "splitnextera": ("bbmap_tpu_torch.tools.pairtools", "splitnexteralmp"),
    "rqcfilter": ("bbmap_tpu_torch.tools.rqcfilter", "main"),
    "bbqc": ("bbmap_tpu_torch.tools.rqcfilter", "main"),
    # format, statistics and SAM tools
    "reformat": ("bbmap_tpu_torch.tools.reformat", "main"),
    "stats": ("bbmap_tpu_torch.tools.stats", "main"),
    "comparesam": ("bbmap_tpu_torch.tools.comparesam", "main"),
    "samtoroc": ("bbmap_tpu_torch.tools.samtoroc", "main"),
    "calctruequality": ("bbmap_tpu_torch.tools.calctruequality", "main"),
    # k-mer sketches, clumping and clustering
    "clumpify": ("bbmap_tpu_torch.tools.clumpify", "main"),
    "loglog": ("bbmap_tpu_torch.tools.loglog", "main"),
    "sketch": ("bbmap_tpu_torch.tools.sketch", "main"),
    "comparesketch": ("bbmap_tpu_torch.tools.sketch", "main"),
    "bbcountunique": ("bbmap_tpu_torch.tools.bbcountunique", "main"),
    "reclusterbykmer": ("bbmap_tpu_torch.tools.recluster", "main"),
    # alignment small tools
    "idmatrix": ("bbmap_tpu_torch.tools.idtools", "idmatrix"),
    "idtree": ("bbmap_tpu_torch.tools.idtools", "idtree"),
    "msa": ("bbmap_tpu_torch.tools.idtools", "msa"),
    "cutprimers": ("bbmap_tpu_torch.tools.idtools", "cutprimers"),
    "commonkmers": ("bbmap_tpu_torch.tools.idtools", "commonkmers"),
    "removesmartbell": ("bbmap_tpu_torch.tools.removesmartbell", "main"),
    # the jgi/driver long tail
    "countgc": ("bbmap_tpu_torch.tools.smalltools", "countgc"),
    "readlength": ("bbmap_tpu_torch.tools.smalltools", "readlength"),
    "fuse": ("bbmap_tpu_torch.tools.smalltools", "fuse"),
    "getreads": ("bbmap_tpu_torch.tools.smalltools", "getreads"),
    "splitsam": ("bbmap_tpu_torch.tools.smalltools", "splitsam"),
    "rename": ("bbmap_tpu_torch.tools.smalltools", "rename"),
    "testformat": ("bbmap_tpu_torch.tools.smalltools", "testformat"),
    "textfile": ("bbmap_tpu_torch.tools.smalltools", "textfile"),
    "printtime": ("bbmap_tpu_torch.tools.smalltools", "printtime"),
    "phylip2fasta": ("bbmap_tpu_torch.tools.smalltools", "phylip2fasta"),
    "matrixtocolumns": ("bbmap_tpu_torch.tools.smalltools", "matrixtocolumns"),
    "mergeotus": ("bbmap_tpu_torch.tools.smalltools", "mergeotus"),
    "summarizescafstats": ("bbmap_tpu_torch.tools.smalltools",
                           "summarizescafstats"),
    "summarizeseal": ("bbmap_tpu_torch.tools.smalltools", "summarizeseal"),
    "muxbyname": ("bbmap_tpu_torch.tools.smalltools", "muxbyname"),
    "filtersubs": ("bbmap_tpu_torch.tools.smalltools", "filtersubs"),
    "reducesilva": ("bbmap_tpu_torch.tools.smalltools", "reducesilva"),
    "estherfilter": ("bbmap_tpu_torch.tools.smalltools", "estherfilter"),
    "bbest": ("bbmap_tpu_torch.tools.smalltools", "bbest"),
    "summarizecrossblock": ("bbmap_tpu_torch.tools.smalltools",
                            "summarizecrossblock"),
    "summarizemerge": ("bbmap_tpu_torch.tools.smalltools", "summarizemerge"),
    "processfrag": ("bbmap_tpu_torch.tools.smalltools", "processfrag"),
    "filterassemblysummary": ("bbmap_tpu_torch.tools.smalltools",
                              "filterassemblysummary"),
    "dedupebymapping": ("bbmap_tpu_torch.tools.smalltools", "dedupebymapping"),
    # taxonomy suite
    "printtaxonomy": ("bbmap_tpu_torch.tools.taxonomy", "printtaxonomy"),
    "findancestor": ("bbmap_tpu_torch.tools.taxonomy", "findancestor"),
    "filterbytaxa": ("bbmap_tpu_torch.tools.taxonomy", "filterbytaxa"),
    "taxtree": ("bbmap_tpu_torch.tools.taxonomy", "taxtree_build"),
    "gitable": ("bbmap_tpu_torch.tools.taxonomy", "gitable"),
    "gi2taxid": ("bbmap_tpu_torch.tools.taxonomy", "gi2taxid"),
    "gi2ancestors": ("bbmap_tpu_torch.tools.taxonomy", "gi2ancestors"),
    "sortbytaxa": ("bbmap_tpu_torch.tools.taxonomy", "sortbytaxa"),
    "splitbytaxa": ("bbmap_tpu_torch.tools.taxonomy", "splitbytaxa"),
    "taxonomy": ("bbmap_tpu_torch.tools.taxonomy", "printtaxonomy"),
    # synthetic data
    "mutategenome": ("bbmap_tpu_torch.tools.synth", "mutategenome"),
    "shred": ("bbmap_tpu_torch.tools.synth", "shred"),
    "makechimeras": ("bbmap_tpu_torch.tools.synth", "makechimeras"),
    "addadapters": ("bbmap_tpu_torch.tools.synth", "addadapters"),
    "fakereads": ("bbmap_tpu_torch.tools.synth", "fakereads"),
    "synthmda": ("bbmap_tpu_torch.tools.synth", "synthmda"),
    "fungalrelease": ("bbmap_tpu_torch.tools.synth", "fungalrelease"),
    "bbfakereads": ("bbmap_tpu_torch.tools.synth", "fakereads"),
    "mutate": ("bbmap_tpu_torch.tools.synth", "mutategenome"),
    # barcodes
    "countbarcodes": ("bbmap_tpu_torch.tools.barcodes", "countbarcodes"),
    "mergebarcodes": ("bbmap_tpu_torch.tools.barcodes", "mergebarcodes"),
    "correlatebarcodes": ("bbmap_tpu_torch.tools.barcodes",
                          "correlatebarcodes"),
    "filterbarcodes": ("bbmap_tpu_torch.tools.barcodes", "filterbarcodes"),
    "removebadbarcodes": ("bbmap_tpu_torch.tools.barcodes",
                          "removebadbarcodes"),
    # sorting, variants and the rest
    "sortsam": ("bbmap_tpu_torch.tools.sorttools", "sortsam"),
    "sortbyname": ("bbmap_tpu_torch.tools.sorttools", "sortbyname"),
    "grademerge": ("bbmap_tpu_torch.tools.sorttools", "grademerge"),
    "callvariants": ("bbmap_tpu_torch.tools.callvariants", "main"),
    "applyvariants": ("bbmap_tpu_torch.tools.callvariants", "applyvariants"),
    "shuffle": ("bbmap_tpu_torch.tools.misc", "shuffle"),
    "partition": ("bbmap_tpu_torch.tools.misc", "partition"),
    "translate6frames": ("bbmap_tpu_torch.tools.misc", "translate6frames"),
    "kcompress": ("bbmap_tpu_torch.tools.misc", "kcompress"),
    "bbwrap": ("bbmap_tpu_torch.tools.misc", "bbwrap"),
    "filterbysequence": ("bbmap_tpu_torch.tools.misc", "filterbysequence"),
    # the PacBio site-stack pipeline
    "stacksites": ("bbmap_tpu_torch.tools.pacbio", "stacksites_main"),
    "calccoveragefromsites": ("bbmap_tpu_torch.tools.pacbio",
                              "calccoverage_main"),
    "processstackedsites": ("bbmap_tpu_torch.tools.pacbio",
                            "processstacked_main"),
    "mergefastacontigs": ("bbmap_tpu_torch.tools.pacbio",
                          "mergefastacontigs_main"),
    "partitionreads": ("bbmap_tpu_torch.tools.pacbio", "partitionreads_main"),
    "partitionfastafile": ("bbmap_tpu_torch.tools.pacbio",
                           "partitionfastafile_main"),
    "removenfromchromosome": ("bbmap_tpu_torch.tools.pacbio",
                              "removenfromchromosome_main"),
    "sortsites": ("bbmap_tpu_torch.tools.pacbio", "sortsites_main"),
    "splitoffperfectcontigs": ("bbmap_tpu_torch.tools.pacbio",
                               "splitoffperfectcontigs_main"),
    # text utilities, liftover
    "concatenatetextfiles": ("bbmap_tpu_torch.tools.textutils",
                             "concatenatetextfiles"),
    "filterlines": ("bbmap_tpu_torch.tools.textutils", "filterlines"),
    "countsharedlines": ("bbmap_tpu_torch.tools.textutils",
                         "countsharedlines"),
    "replaceheaders": ("bbmap_tpu_torch.tools.textutils", "replaceheaders"),
    "statswrapper": ("bbmap_tpu_torch.tools.textutils", "statswrapper"),
    "bbgrep": ("bbmap_tpu_torch.tools.textutils", "grep"),
    "linecount": ("bbmap_tpu_torch.tools.textutils", "linecount"),
    "renamebyheader": ("bbmap_tpu_torch.tools.textutils", "renamebyheader"),
    "liftover": ("bbmap_tpu_torch.tools.liftover", "main"),
    "translator": ("bbmap_tpu_torch.tools.liftover", "main"),
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        print("usage: python -m bbmap_tpu_torch <tool> key=value ...")
        print("tools: " + ", ".join(sorted(TOOLS)))
        return 0
    tool = sys.argv[1].lower()
    if tool in TOOLS:
        module, entry = TOOLS[tool]
        return getattr(importlib.import_module(module), entry)(sys.argv[2:])
    print(f"unknown tool {tool!r}; available: " + ", ".join(sorted(TOOLS)))
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
