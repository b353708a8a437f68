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
``splitnextera``, and the QC chain ``rqcfilter`` / ``bbqc``. Each entry
names a module and its entry point; the tools that run on a device take
``device=`` (default cuda).
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
