#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bbmap_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each timed on its own line:

1. device facts: the card's name and power limit;
2. build: one nvcc for each source in ``bbmap_tpu_torch/csrc/``
   (``msa_dp.cu``, ``msa_dp_warp.cu``, ``msa_dp_pipe.cu``,
   ``msa_dp_band.cu``, ``msa_walk.cu``, ``msa_fill_walk.cu``,
   ``banded_edit.cu``, ``rescue_scan.cu``, ``quality_offsets.cu``,
   ``ref_retention.cu``, ``gapless_score.cu``, ``slot_pack.cu``,
   ``chain_candidates.cu``) and
   for each build of ``_build.VARIANTS`` (the
   DPX cell in the mappings that keep the plain one), all started
   together, into
   ``build/torch_kernels/``
   (a source whose library is there is skipped); ``cuobjdump -sass`` of the libraries gives each
   kernel's instructions a cell (the main loop's length over the cells
   one pass of it evaluates), and the least of them among a function's
   mappings is the count that function's bound is reckoned with; beside
   the nvcc processes, in a thread, the kernel self-test's oracle
   (``ops/msa_ref.fill_unlimited`` on its 2 x 128 cases);
3. kernel selftest: ``ops/msa_selftest.kernel_selftest`` on the card,
   K2, K3 and the fused fill + walk against that oracle's score and
   column on 128 cases a profile (64 x 128, substitutions, deletions and
   insertions), SHORT and PACBIO; fails on False or when one of the
   three kernels never launched;
4. kernel vs plain: every kernel against its plain PyTorch version on
   the card, bit-equal (tolerance 0: the DP and the walk are integer
   arithmetic): K2 score and K3 fill at the short path's shapes
   (150, 174), (150, 606) and PACBIO (300, 360) in the warp-a-job
   mapping and in the one-row mapping, and K2, K3 and K1's operands in
   the pipe mapping (``csrc/msa_dp_pipe.cu``) below 32 rows, at a band's
   edge, at both short windows with gap and N columns, PACBIO (300, 360),
   two rows a lane at (600, 660) and 1,023 rows; past 1,023 rows the band mapping
   at 2, 4 and 8 rows a lane and the strided mapping it replaced, at
   (1,024, 1,100) with one job, (1,100, 1,200) with 100 jobs (last band
   and last lane partly empty; K1's operands too), (2,500, 2,600) SHORT
   profile, the long-read shapes (6,000, 6,024) and (6,000, 6,456) and
   (8,191, 8,192), per-job rows below R among them; K1 on its own
   operands at (150, 174) in both mappings; and the walk kernel at 8,192
   x (150, 174) bounded to 190 steps, at (150, 606) full length, and at
   (6,000, 6,456) over the row-major and over the wave-major block (its
   timed shape, the long-read path's; at (6,000, 6,456) the kernels run
   at the full job counts and the plain versions, timed, on the first
   ``LONG_CMP_JOBS`` jobs, which are the ones compared), on
   the last 16 jobs of 64-job fills whose prev codes pass 2**31 bytes in
   either layout, from the fill's own columns and states and from
   shifted ones, so that cut walks are among them; kernel, plain and
   other-mapping times at the shapes the paths use, each kernel's bound,
   K2 in the warp, one-row and pipe mappings and K3 in the one-row and
   pipe mappings from 16 to 4,096 jobs (the sweep that
   ``msa_kernels.WARP_MIN_JOBS`` is chosen from), the band
   mapping over rows a lane and the job count beside the strided mapping
   (``BAND_MIN_WARPS``) and beside the one-row and pipe mappings between
   320 and 1,023 rows (``PIPE_MID_MIN_ROWS``, ``PIPE_MID_MIN_FILL_JOBS``);
   the fused
   fill + walk (``msa_fill_walk``) with a byte and with four bits a cell
   and by its default route against ``msa_fill_walk_plain`` at the fused
   program's two launches, 8,192 x (150, 174) bounded to 190 steps and
   64 x (150, 606) full length, with walks cut, and at 64 x (320, 344)
   and 64 x (645, 669) (the widest block the route gives, 672 threads),
   SHORT and PACBIO, timed beside K3 + the walk kernel on the same jobs,
   and swept over the job count; its registers a thread read with
   ``cuobjdump -res-usage`` (a block of 1,024 threads must fit), and every
   other kernel's printed; the merged score launch
   (``msa_score_segments``) at the fused program's 32,768 narrow + 128
   wide jobs and at PACBIO segments with an empty one, against the plain
   version and ``msa_score`` on each segment alone, timed beside the two
   launches one after the other, with the wide pass's clocks a wave; the
   walk kernel also at
   400 x (6,000, 6,456) against its plain version, and at 16 and 400 jobs
   full length, cut at R + 50 and from shifted starts, with its clocks a
   walked step (the launch's time at ``clocks.max.sm`` over the longest
   walk); the pipe mapping's K2 at 128 x (150, 606), K3 at 8,192 x (150,
   174) and K1 at 128 x (150, 174) timed beside the one-row (and warp)
   mapping, every one of them held to the plain version's out, and
   their bounds; dp_cell's DPX form: ``__viaddmax_s32``
   against max(a + b wrapped, c) on the int32 extremes and 2**20 random
   triples, the two forms of the cell on 2**20 random and extreme
   operand sets a profile, all equal, and the mappings that keep the plain
   cell timed once with their DPX builds (the same outputs);
5. K1 entry point: ``msa_kernels.score_batch`` on 32,768 jobs, counted;
6. main path: the bench workload (4.6 Mbp genome with repeat families,
   k=13 index, 2x150 bp pairs with quality, 32,768 pairs a batch) through ``BBMapAligner.map_pairs_columnar`` (one warmup
   batch) and ``map_pairs_columnar_stream`` (3 steady batches), graded
   against the simulated origins; fails below sensitivity 0.997, mapped
   fraction 0.999 or pair rate 0.997, when the fused fill + walk was never
   launched, when the merged score launch did not run once a batch (the
   fused program scores its narrow and wide passes in one launch), or
   when a fill or a walk took the two-kernel route; the quality offsets are computed on the
   card, every call through the quality offsets kernel
   (``csrc/quality_offsets.cu``), and the mate rescue scans a batch's
   jobs in one launch of the rescue kernel (``csrc/rescue_scan.cu``):
   fails when either never launched or the rescue kernel launched more
   often than there were batches; the candidate stage's key retention
   (``csrc/ref_retention.cu``, no host sync), slot pack
   (``csrc/slot_pack.cu``) and chain step (``csrc/chain_candidates.cu``)
   and the finalize stage's gapless score (``csrc/gapless_score.cu``)
   launch once a call: fails when one launched less than once a batch. The first call of each is
   recorded,
   and after the SAM phase both kernels are held to their plain versions
   on the card, tolerance 0: the rescue scan on the warmup batch's jobs
   and on 1,024 edge jobs (both directions, n = 1, 2 and 1,536, N bases
   in reads and windows, windows past the genome's ends, max_mm -1 and
   0, ties on a repeat) on a 200 kbp genome with N runs, the quality
   offsets on the warmup batch's 65,536 x 150 and on 32 x 6,000 at
   randomreads' PacBio quality (k = 12, 750 keys); each timed beside its
   plain version and its bound;
7. SAM: ``emit_sam`` on the first 1,000 pairs;
8. index build: ``index/build_device.build_index_device`` on the card
   (k = 13, torch operations: one stable sort, a binary search a key)
   against the host ``build_index`` on the main path's genome and on one
   of the same length with 0.1 % N bases across two chroms, ``starts``
   and ``sites`` equal; the host build, ``analyze_index`` and the device
   build (cold, warm, and its CSR alone between CUDA events) timed, with
   the device build's peak memory and its bound in bytes; then the main
   path's warmup batch through a ``BBMapAligner`` on the device-built
   index after ``analyze_index``: every ``MappedBatch`` field and match
   equal to the main path's, and which aligner took the device arrays
   the build left on the index;
9. long reads: 400 PacBio-model reads of 6 kbp at 12 % error on the same
   genome (``randomreads pacbio=t``) through the port's ``mappacbio``
   CLI on the card, graded by gradesam (strict = within 400 bp); fails
   below mapped 0.98 or strict 0.65, when the band K2 or K3 or the walk
   kernel was never launched, or when a strided kernel was; the fill
   chunk the card's memory allows is printed beside the launches; the
   first calls of the key retention and the gapless score are recorded
   here too. Then both kernels against their plain versions on the card,
   tolerance 0, on the main path's first calls (65,536 reads of 18 keys
   with quality weights; 65,536 x 8 candidates of 150 bp) and on the long
   path's cut to 32 reads (750 keys with weights; 8 candidates of 6,000
   bp), each timed beside its plain version and its bound; the scalar
   reads of a device value (``aten::_local_scalar_dense``) under
   torch.profiler in one call of the kernel (none) and of the plain trim
   (one a round and one more: the counter's check). Then the candidate
   stage's slot pack (``csrc/slot_pack.cu``) and chain step
   (``csrc/chain_candidates.cu``: the rows' sort, the chain segmentation,
   the distinct-key votes, the modal run and the top-8 table), whose
   first calls on both paths are recorded too, against their plain
   versions on the card, tolerance 0 on every output, on the main path's
   first calls (65,536 reads, 2 x 18 keys, W 64) and the long path's cut
   to 32 reads (2 x 750 keys, W 512), each timed beside its plain version
   and its bound, and on rows crafted for their edges
   (``tests/candidate_rows.py``) at both shapes; torch.profiler counts
   the scans and the scalar reads of a device value in one call of each
   kernel (none) and of each plain version; the plain versions' times at
   the main path's shapes printed as the split of the former eager scans;
10. tools: the read-preprocessing tools at ``bench_tools.py``'s sizes on
   seeded synthetic data. bbduk's k-mer scan (k=23, hdist=1, 200 adapters
   of 34-66 bp) over 1,000,000 reads of 150 bp and seal (k=31,
   ambig=first, 50 references of 5,000 bp) over 500,000 reads through
   ``Seal.assign_batch``, both in chunks of 131,072; bbmerge's mismatch
   and ratio ladders over 500,000 pairs of 2 x 100 bp at insert 160 in
   batches of 65,536. The first chunk of each is held against the numpy
   host path of the same module, tolerance 0: bbduk's (B, m) ids, seal's
   (B, nrefs) counts and the (row, owner) pairs of ``scan_batch_multi``
   on a multi-owner set, bbmerge's insert, bad and ambig in both modes.
   Fails below a seal matched fraction of 0.99 or when a device scan or
   ladder counter differs from the chunks fed. Then the ``bbduk``
   (paired, ktrim=r mink=11 hdist=1 tbo=t), ``seal`` (stats=, pattern=)
   and ``bbmerge`` CLIs on 20,000 reads or pairs, once with ``device=``
   the card and once with ``device=cpu`` (each in a process of its own,
   one thread, started with the phase, beside the card's work): every
   output file byte-equal,
   the reports too without their ``Time:`` line, and the card's run seen
   in the scan and ladder counters;
11. kmer tools: the counting Bloom filter (``index/kcount.py``) at
   bbnorm's size, 3 x 2**26 16-bit cells, counting the canonical 31-mers
   of 1,048,576 reads of 150 bp from the genome in bbnorm's chunks of
   8,192, then looking them up: k-mers/s and reads/s of each pass and the
   share of host ``canonical_kmers``; the rows, the load and 65,536 reads
   (half of them counted k-mers) equal to the numpy ``KCountArray`` after
   4 chunks, and again at 8 and 2 bits on a chunk from a 2 kbp window,
   where cells saturate. Then the CLIs ``bbnorm`` (20,000 pairs, khist=),
   ``ecc`` (2,000 pairs), ``kmercoverage`` (20,000 reads, hist=),
   ``rqcfilter`` (2,000 pairs; adapter and artifact references written
   here, phix=f, ihist=, khist=t) and ``decontaminate`` (two libraries of
   2,000 reads against 50 kbp assemblies) once on the card and once with
   ``device=cpu`` (each in a process of its own, one thread, started with
   the tools phase, which writes kcount's calls to a file when it ends):
   every
   output file byte-equal (rqcfilter's status.log and
   reproduce.sh left out), the reports too without their wall times, the
   card's runs seen in kcount's calls, rqcfilter's out2 holding the mates
   of out, decontaminate's junk contigs dirty and its main contigs clean.
12. dedupe and mapper variants: the banded edit distance kernel
   (``csrc/banded_edit.cu``) against its plain version, tolerance 0, at
   65,536 pairs of 150 bp from the genome (0-6 substitutions and indels)
   at E = 0, 2, 4, 31 (a thread a pair), E = 40 (a warp a pair) and E =
   520 on 1,024 pairs (the band in device memory), global and infix, one
   query against all 65,536, 1,024 contigs of 5,000 bp at E = 8, and the
   first 1,000 pairs at E = 2 against the numpy band sweep, each timed
   beside its bound; the block kernel (``banded_any``, both modes, staged
   and in place) at 256 queries against the 65,536 reads, and 512
   queries against 15,000 and 1,000 of them, E = 0 and 2, against its
   plain version and timed beside its bound; the containment kernel
   (``contained_any``) on a block of 512 reads with 64 fragments and 4
   windows each at tol 2 (a thread an orientation of a pair) and tol 16
   (the warp body), against its plain version, timed beside its bound;
   the ``dedupe`` (e=2; s=2 ac=t; fo=t c=t mo=100 with
   cluster stats, graph and cluster files) and ``dedupe2 nam=2`` CLIs
   over 2,000 reads, and ``bbmapacc``, ``bbmap5``, ``bbmapskimmer`` and
   ``bbsplit`` (the reference cut into two sets) over 500 pairs, on the
   card and, each in a process of its own started first, on the CPU:
   every file and report byte-equal; bbmap on the card before and after
   bbmapacc in this process, the same SAM; then on the card alone dedupe
   e=2 ac=t over 50,000 reads (reads/s, the store check's launches of
   the block kernel, the containment check's launches by site: the
   containment kernel a block, at most one a block, and the in-block
   checks' ``banded_edit``; the containment kernel held to its plain
   version on the run's median block and timed there, a block's check
   against all kept reads, a block's containment check and an in-block
   check timed, the kernels' share of the wall)
   and bbmap, bbmapacc and bbmapskimmer over 32,768 pairs (reads/s over
   each CLI's mapping time, accuracy graded from randomreads' names;
   bbmapacc maps no fewer reads than bbmap and is not less sensitive
   beyond a 3-sigma sign test on the reads the two grade apart; every DP
   launch recorded by (jobs, R, C), the one-row and pipe ones printed as
   a histogram and put on the ``kernels`` line, K2 timed at each of
   their shapes in the pipe, one-row and warp mappings, each held to the
   plain version's out).
13. host tools: ``bbwrap`` (``tools/misc.bbwrap``, a ``bbmap`` run an
   input) over two single-end inputs of 500 reads on the 1 Mbp slice
   (the variants' pairs, each mate file an input), on the card and, in a
   process of its own, on the CPU: both SAM files and the report
   byte-equal; one run of each other host tool module the port copied
   (reformat, stats, comparesam, samtoroc, calctruequality, clumpify,
   loglog, sketch, bbcountunique, recluster, idtools, removesmartbell,
   smalltools, synth, barcodes, sorttools, callvariants, pacbio,
   textutils, liftover) on small inputs written here, each exit 0 with
   output, its wall printed; then bbwrap on the card over the genome at
   32,768 pairs, twice: the pairs interleaved in one file
   (``interleaved=t``, the pair stream) and their first mates alone (the
   single-end stream), each input's reads/s over its mapping time, its
   mapped fraction and grading and its launches; fails when either input
   launched no K2 or no fill + walk, or maps below 0.95.
14. parallel (``bbmap_tpu_torch/parallel/``), two processes on the one
   card (a gloo process group; NCCL takes no two ranks on one GPU):
   (a) bbmap over the host tools' 32,768 pairs on the genome (its index
   cache, batches of 4,096 pairs) in one process, then in two with
   ``hosts=2`` (both on cuda:0): each CLI's reads/s over its mapping
   time, the two processes' aggregate over the longer of their times,
   their walls, and the records apart from the one process's SAM by
   column (the running average pair distance restarts on each host, so
   MAPQ moves); the merged SAM byte-equal to bbmap in one process over
   each host's stripe of batches (which restarts the average the same
   way), interleaved by batch id; the first mates single-end likewise,
   host 0's SAM byte-equal to the one process's;
   (b) the genome as two scaffolds in chrom blocks of their own
   (``maxchromlen=``), 8,192 first mates single-end, two processes with
   ``shardindex=t``: each shard a strict part of the sites, the parts
   summing to the whole, host 0's SAM byte-equal to the CLI in this
   process with the fused programs off (the path a sharded index takes),
   and the records apart from the fused program's one-process SAM
   counted; (c) the in-process mesh at full width: (b)'s genome,
   ``BBMapAligner(mesh=make_mesh(1, 2, card))``
   on the main path's 32,768 first mates without quality, every
   ``MappedBatch`` field and match equal to the unsharded aligner's on
   the same unfused path (the fields apart from the fused program's
   counted), ``sharded_score_step`` (K1's entry point) on 8,192 reads x 2
   windows held to plain K1, ``dryrun_multichip(2)``; (d) bbduk, seal,
   bbmerge and reformat at ``hosts=2`` (the eight processes at once) on
   20,000 reads or pairs, every file byte-equal to ``hosts=1``. Fails
   when (c) launched no K2, no fill + walk or no K1.

Each path's launch counts (and the tools' device scan and ladder
counters, and kcount's calls) are set to 0 just before it and read just
after; the kmer tools' path is decontaminate's run on the card (its two
single-end ``bbmap`` runs); the dedupe path is dedupe's run over 50,000
reads, the mapper variants' path bbmapskimmer's over 32,768 pairs, the
host tools' path bbwrap's two runs over 32,768 pairs (both inputs), the
parallel path the mesh's batch and ``sharded_score_step`` (c). The
``kernels`` line gives each kernel's launches on each path and, as
``launches``, on the path whose shape it is timed at. Any failure raises
and exits non-zero without the final ``ok`` line. It exits 2 when no CUDA device is available or when it is not run
from a checkout of the repository.

``python3 chip_smoke.py --profile`` runs no check: it prints where the
time goes (one short-read batch under torch.profiler, with its scalar
reads of a device value, its device-to-host copies and its kernels'
launches, 32 long reads under cProfile, with the quality and rescue
stages' cumulative host time, and under torch.profiler, one chunk of
bbduk, of seal and of each bbmerge mode under torch.profiler) and no
``ok`` line.

``python3 chip_smoke.py --dedupe-split <dir>`` runs dedupe e=2 ac=t over
the dedupe phase's 50,000-read library with the checkout in <dir> (the
parent) and with this tree, in the order parent, change, change, parent,
and prints each run's reads/s and the banded kernels' launches by call
site (store check, containment check); no ``ok`` line.

``python3 chip_smoke.py --paired <dir>`` runs the main path and the long
reads of the checkout in <dir> (the parent commit, unpacked with ``git
archive``) and of this tree, each in a process of its own, in the order
parent, change, change, parent, and prints one line a run: reads/s,
accuracy, stage times and launches of each, with the fused program's
device kernels from torch.profiler; no ``ok`` line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
L = 150
N_PAIRS = 32768
N_STEADY = 3
SENS_MIN, MAPPED_MIN, PAIR_MIN = 0.997, 0.999, 0.997
N_LONG, L_LONG = 400, 6000
LONG_MAPPED_MIN, LONG_STRICT_MIN = 0.98, 0.65
K1_JOBS = 32768
_K1, _K2, _K3 = ("bbmap_tpu/ops/msa_pallas.py:243",
                 "bbmap_tpu/ops/msa_pallas.py:577",
                 "bbmap_tpu/ops/msa_pallas.py:588")
_WALK = "bbmap_tpu/ops/msa_jax.py:451"
_BANDED = "bbmap_tpu/ops/banded_device.py:34 (_program, an XLA scan)"
_RESCUE = "bbmap_tpu/ops/rescue_device.py:37 (_rescue_stage, two XLA scans)"
_QUALITY = ("bbmap_tpu/align/quickmap_device.py:781 (_quality_offsets_core, "
            "an XLA program)")
_RETENTION = ("bbmap_tpu/align/quickmap_device.py:513 (_ref_retention, its "
              "greedy trim an XLA while_loop)")
_GAPLESS = ("bbmap_tpu/align/quickmap_device.py:1291 (finalize_stage's "
            "gapless score: extract_ref_codes + score_match_sub_vec, XLA)")
_SLOT_PACK = ("bbmap_tpu/align/quickmap_device.py:1036-1104 (candidate_stage's"
              " slot budget and slot assignment, XLA)")
_CHAIN = ("bbmap_tpu/align/quickmap_device.py:1150-1288 (candidate_stage's "
          "sort, chain segmentation, votes, modal run and top_k, XLA)")
# the fused fill + walk's variants (ops/msa_kernels.FILL_WALK_VARIANTS)
FILL_WALK = {v: f"msa_fill_walk_{v}" for v in ("row", "row_packed")}
REPLACES = {"msa_score_rows": _K1, "msa_score": _K2, "msa_score_row": _K2,
            "msa_score_segments": _K2,
            "msa_score_long": _K2, "msa_score_strided": _K2,
            "msa_fill": _K3, "msa_fill_long": _K3, "msa_fill_strided": _K3,
            "msa_walk": _WALK, "banded_edit": _BANDED, "banded_any": _BANDED,
            "contained_any": _BANDED,
            "msa_score_pipe": _K2, "msa_fill_pipe": _K3,
            "msa_score_rows_pipe": _K1,
            "rescue_scan": _RESCUE, "quality_offsets": _QUALITY,
            "ref_retention": _RETENTION, "gapless_score": _GAPLESS,
            "slot_pack": _SLOT_PACK, "chain_candidates": _CHAIN,
            **{n: f"{_K3} + {_WALK}" for n in FILL_WALK.values()}}
CSRC = "bbmap_tpu_torch/csrc/"
SOURCE = {"msa_score_rows": CSRC + "msa_dp_warp.cu",
          "msa_score": CSRC + "msa_dp_warp.cu",
          "msa_score_row": CSRC + "msa_dp.cu",
          "msa_score_segments": CSRC + "msa_dp_warp.cu",
          "msa_fill": CSRC + "msa_dp.cu",
          "msa_score_long": CSRC + "msa_dp_band.cu",
          "msa_fill_long": CSRC + "msa_dp_band.cu",
          "msa_score_strided": CSRC + "msa_dp.cu",
          "msa_fill_strided": CSRC + "msa_dp.cu",
          "msa_walk": CSRC + "msa_walk.cu",
          "banded_edit": CSRC + "banded_edit.cu",
          "banded_any": CSRC + "banded_edit.cu",
          "contained_any": CSRC + "banded_edit.cu",
          "msa_score_pipe": CSRC + "msa_dp_pipe.cu",
          "msa_fill_pipe": CSRC + "msa_dp_pipe.cu",
          "msa_score_rows_pipe": CSRC + "msa_dp_pipe.cu",
          "rescue_scan": CSRC + "rescue_scan.cu",
          "quality_offsets": CSRC + "quality_offsets.cu",
          "ref_retention": CSRC + "ref_retention.cu",
          "gapless_score": CSRC + "gapless_score.cu",
          "slot_pack": CSRC + "slot_pack.cu",
          "chain_candidates": CSRC + "chain_candidates.cu",
          **{n: CSRC + "msa_fill_walk.cu" for n in FILL_WALK.values()}}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# Each of an SM's four schedulers starts one warp instruction (32 lanes) a
# clock. The kernels' integer work spreads over the ALU and the FMA pipes
# (IMAD, moves), so the schedulers' rate, and not the 64 int32 ALU lanes an
# SM, is the rate no instruction mix can pass.
SCHEDULER_LANES_PER_SM = 128
# kernel variant -> its name in the ``kernels`` line, by wrapper and mapping
VARIANT = {("msa_score", "warp"): "msa_score",
           ("msa_score", "row"): "msa_score_row",
           ("msa_score", "pipe"): "msa_score_pipe",
           ("msa_fill", "pipe"): "msa_fill_pipe",
           ("msa_score_rows", "pipe"): "msa_score_rows_pipe",
           ("msa_score", "band"): "msa_score_long",
           ("msa_score", "strided"): "msa_score_strided",
           ("msa_fill", "warp"): "msa_fill_warp",
           ("msa_fill", "row"): "msa_fill",
           ("msa_fill", "band"): "msa_fill_long",
           ("msa_fill", "strided"): "msa_fill_strided",
           ("msa_score_rows", "warp"): "msa_score_rows",
           ("msa_score_rows", "row"): "msa_score_rows_row",
           ("msa_score_rows", "band"): "msa_score_rows_long"}
# the long-read escalation window, and the job counts its kernels are
# timed at: the ``kernels`` line's (the 16-job fill every earlier run
# timed) first
LONG_C = L_LONG + 456
LONG_SCORE_JOBS = 256
LONG_FILL_JOBS = (16, 64, 128, 256, 400)
LONG_SWEEP_JOBS = (1, 16, 64, 100, 128, 200, 256, 400)
PAST_32_BITS = 2 ** 31          # bytes a 64-job block of prev codes passes
LONG_CMP_JOBS = 2               # jobs at (6,000, 6,456) the plain versions run
# The band mapping's edge cases past 1,023 rows: (tag, profile, jobs, R, C,
# seed, error rate, rows a lane compared, gap and N columns). Their plain
# fills cost a wave at a time whatever the job count (37,931 waves in
# all), so they run in a CPU process of their own (``PlainFills``)
# beside the card's work and are compared when they are done.
EDGE_CASES = (
    ("pacbio past 1,023 rows", "PB", 1, 1024, 1100, 13, 0.12, (2, 4, 8),
     False),
    ("pacbio, ragged last band", "PB", 100, 1100, 1200, 14, 0.12,
     (2, 4, 8), False),
    ("short profile, gap columns", "S", 16, 2500, 2600, 15, 0.1, (2, 4, 8),
     True),
    ("pacbio long read, narrow window", "PB", 3, L_LONG, L_LONG + 24, 16,
     0.12, (2, 4), False),
    ("pacbio largest R", "PB", 2, 8191, 8192, 17, 0.12, (4, 8), False))
# the one-row sweep's job counts, and the pipe mapping's checks: (jobs, R,
# C, profile, tag); a window past 400 columns gets gap and N columns
ONEROW_SWEEP_JOBS = (16, 64, 128, 256, 512, 768, 1024, 2048, 4096)
PIPE_CHECKS = (
    (64, 31, 60, "S", "below 32 rows"), (40, 32, 70, "S", "33 rows"),
    (40, 63, 90, "S", "a band's edge"), (512, L, L + 24, "S", "narrow"),
    (128, L, L + 456, "S", "wide, gap and N columns"),
    (100, 300, 360, "PB", "pacbio"), (16, 600, 660, "PB", "two rows a lane"),
    (5, 1023, 1100, "PB", "1,023 rows"))
# kernel variant -> the function it computes; every variant of a function
# is held to one bound
FUNCTION = {v: w for (w, _), v in VARIANT.items()}
FUNCTION["msa_walk"] = "msa_walk"
FUNCTION["msa_score_segments"] = "msa_score"
FUNCTION.update(dict.fromkeys(FILL_WALK.values(), "msa_fill_walk"))
# the fused program's two fill + walk launches: (jobs, R, C, steps) of the
# T fill at Cn, bounded to Cn + 16 steps, and of the RT retry at Cw, full
# length; the job counts the variants are swept over at both windows
FW_SHAPES = ((8192, L, L + 24, L + 24 + 16), (64, L, L + 456, 0))
FW_CUT = (1024, L, L + 24, 120)      # walks cut short: row_end > 0
# wide reads, full length: 352 threads a block a byte a cell, and the
# widest block the route gives (672 threads, codes packed)
FW_WIDE = ((64, 320, 344, 0), (64, 645, 669, 0))
# the retry's window at a job count where the route packs the codes (a
# refit or rescue chunk of that size): the packed entry's shape
FW_PACKED = (1024, L, L + 456, 0)
FW_SWEEP_JOBS = (64, 256, 1024, 2048, 4096, 8192)
# the read-preprocessing tools at bench_tools.py's sizes (bench_bbduk,
# bench_seal, bench_bbmerge), the chunks they are fed in, and the reads or
# pairs each CLI runs on twice (card, then CPU), in the tools' own batches
N_DUK, K_DUK, HDIST_DUK, N_ADAPTERS = 1_000_000, 23, 1, 200
N_SEAL, SEAL_REFS, SEAL_REF_LEN, K_SEAL = 500_000, 50, 5000, 31
SEAL_MATCHED_MIN = 0.99
N_MERGE, MERGE_L, MERGE_INSERT = 500_000, 100, 160
SCAN_CHUNK, MERGE_CHUNK = 131072, 65536
N_CLI, CLI_BATCH = 20_000, 8192


def say(msg: str) -> None:
    print(msg, flush=True)


def torch_cuda(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _diff(a, b) -> int:
    """Largest absolute difference of two integer tensors (0 if empty)."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _cuda_ms(fn, reps: int, warm: bool = True):
    """Mean milliseconds of ``reps`` calls of fn between CUDA events
    (after one warmup call when ``warm``), and the last call's result."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def _pb_errors(rng, src, n: int, err: float):
    """PacBio-model errors at rate ``err`` per source base (60 %
    insertions, 25 % deletions, 15 % substitutions, as tests/test_pacbio.py
    draws them); the first n bases of the result."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    u = rng.random(len(src))
    ins = u < 0.60 * err
    sub = (u >= 0.85 * err) & (u < err)
    keep = ~((u >= 0.60 * err) & (u < 0.85 * err))
    src = src.copy()
    src[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
    counts = keep.astype(np.int64) + ins
    pos = np.cumsum(counts) - 1                 # where each kept base lands
    out = np.empty(int(counts.sum()), np.uint8)
    out[pos[keep]] = src[keep]
    out[pos[ins] - 1] = bases[rng.integers(0, 4, int(ins.sum()))]
    return out[:n]


def dp_jobs(genome, n: int, R: int, C: int, seed: int, device,
            var_rows: bool = True, pb_err: float = 0.0):
    """Bench-like DP jobs: reads sampled from the genome with 1-3
    substitutions or one 1-10 bp insertion/deletion (or, with
    ``pb_err``, PacBio-model errors at that rate), windows around the
    origin as the fused program cuts them (start - 4), and, when
    ``var_rows``, a quarter of the jobs with 1-8 fewer rows (the read
    padded with N)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    G = len(genome)
    starts = rng.integers(8, G - C - (2 if pb_err else 1) * R - 32, n)
    reads = np.empty((n, R), np.uint8)
    refs = np.empty((n, C), np.uint8)
    for i, s in enumerate(starts):
        refs[i] = genome[s - 4:s - 4 + C]
        if pb_err:
            reads[i] = _pb_errors(rng, genome[s:s + 2 * R], R, pb_err)
            continue
        src = genome[s:s + R + 16].copy()
        kind = rng.random()
        if kind < 0.4:
            for _ in range(int(rng.integers(1, 4))):
                src[rng.integers(0, R)] = bases[rng.integers(0, 4)]
        elif kind < 0.7:
            d, p = int(rng.integers(1, 11)), int(rng.integers(10, R - 10))
            src = np.concatenate([src[:p], src[p + d:]])
        else:
            d, p = int(rng.integers(1, 11)), int(rng.integers(10, R - 10))
            src = np.concatenate([src[:p], bases[rng.integers(0, 4, d)],
                                  src[p:]])
        reads[i] = src[:R]
    rows = np.full(n, R, np.int32)
    if var_rows:
        short = rng.random(n) < 0.25
        rows[short] -= rng.integers(1, 9, int(short.sum())).astype(np.int32)
        for i in np.nonzero(short)[0]:
            reads[i, rows[i]:] = ord("N")
    dev = torch.device(device)
    return (torch.from_numpy(reads).to(dev), torch.from_numpy(refs).to(dev),
            torch.from_numpy(rows).to(dev))


def edge_jobs(genome, case, device):
    """The jobs of one of ``EDGE_CASES`` on ``device`` (the same bytes on
    any device: they are drawn with numpy)."""
    _tag, _prof, n, R, C, seed, err, _Js, gaps = case
    rd, rf, rw = dp_jobs(genome, n, R, C, seed, device, pb_err=err)
    if gaps:
        rf[::3, C // 2] = ord("-")
        rf[::5, 700] = ord("N")
    return rd, rf, rw


_PLAIN_FILLS = """
import os, sys, torch
sys.path.insert(0, ".")
torch.set_num_threads(2)
import chip_smoke as cs
from bbmap_tpu_torch import workload
from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
from bbmap_tpu_torch.ops import msa_kernels as mk
genome = workload.make_genome()
for i, case in enumerate(cs.EDGE_CASES):
    P = SHORT_PROFILE if case[1] == "S" else PACBIO_PROFILE
    out, prevs, lay = mk.msa_fill_plain(*cs.edge_jobs(genome, case, "cpu"), P)
    tmp = os.path.join(sys.argv[1], f"{i}.tmp")
    torch.save((out, prevs, tuple(lay)), tmp)
    os.replace(tmp, os.path.join(sys.argv[1], f"{i}.pt"))
"""


class PlainFills:
    """The plain fills of ``EDGE_CASES`` in a CPU process of its own
    (no card, two threads), started now; ``get(i, device)`` waits for case
    i's and returns (out, prevs, layout) on ``device``; ``stop`` ends the
    process and removes its files."""

    def __init__(self):
        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_plain"))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
                   CUDA_VISIBLE_DEVICES="")
        self.err = open(self.dir / "stderr.txt", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _PLAIN_FILLS, str(self.dir)], cwd=ROOT,
            env=env, stdout=subprocess.DEVNULL, stderr=self.err)

    def get(self, i: int, device, timeout: float = 900.0):
        import torch
        from bbmap_tpu_torch.ops import msa
        path = self.dir / f"{i}.pt"
        t0 = time.time()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise AssertionError(
                    "the CPU process of plain fills ended early: "
                    + (self.dir / "stderr.txt").read_text()[-2000:])
            if time.time() - t0 > timeout:
                raise AssertionError(f"no plain fill of edge case {i} in "
                                     f"{timeout:.0f} s")
            time.sleep(0.2)
        out, prevs, lay = torch.load(path)
        path.unlink()
        return out.to(device), prevs.to(device), msa.PrevLayout(*lay)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def prev_code_err(k, p, rows, R: int, C: int) -> int:
    """Largest difference between two fills' prev codes, each a (block,
    layout) pair, over the cells where they are defined: 1 <= r <=
    rows[b], 1 <= c <= C, read through each block's stride map."""
    import torch
    from bbmap_tpu_torch.ops import msa
    valid = torch.arange(1, R + 1, device=rows.device).view(1, -1, 1) \
        <= rows.view(-1, 1, 1)
    worst = 0
    for a in range(0, len(rows), 16):     # bounded scratch for long jobs
        kc, pc = (msa.cell_view(b[a:a + 16], R, C, lay) for b, lay in (k, p))
        worst = max(worst, int(((kc.short() - pc.short()).abs()
                                * valid[a:a + 16]).max()))
    return worst


@contextlib.contextmanager
def band_rows_a_lane(J: int, jobs: int, R: int):
    """Make ``launch_shape`` give the band mapping J rows a lane for this
    job count (for the comparisons and sweeps over J): the warp threshold
    is set to what J yields, and a fill may take 8 rows a lane."""
    from bbmap_tpu_torch.ops import msa_kernels as mk
    old = mk.BAND_MIN_WARPS, mk.BAND_FILL_MAX_ROWS_PER_LANE
    mk.BAND_MIN_WARPS = jobs * mk.band_count(R, J)
    mk.BAND_FILL_MAX_ROWS_PER_LANE = max(mk.BAND_ROWS_PER_LANE)
    try:
        for fill in (False, True):
            got = mk.launch_shape(R, 1, "band", jobs, fill).rows_per_thread
            if got != J and mk.band_count(R, got) != mk.band_count(R, J):
                raise AssertionError(f"{got} rows a lane, wanted {J}")
        yield
    finally:
        mk.BAND_MIN_WARPS, mk.BAND_FILL_MAX_ROWS_PER_LANE = old


def sass_loops(lib_path) -> dict:
    """``cuobjdump -sass`` of a built library: {mangled kernel name:
    (instructions, [(instructions, opcodes) of each loop])}, a loop being
    the span of a backward branch."""
    import re
    from bbmap_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        code, branches = [], []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk):
            addr, ins = int(m.group(1), 16), m.group(2)
            op = re.match(r"(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", ins.strip())
            code.append((addr, op.group(1) if op else ""))
            t = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if t and int(t.group(1), 16) < addr:
                branches.append((int(t.group(1), 16), addr))
        loops = []
        for lo, hi in branches:
            ops = [op for a, op in code if lo <= a <= hi]
            loops.append((len(ops), frozenset(ops)))
        out[name] = (len(code), loops)
    return out


def sass_counts(lib_path) -> dict:
    """{mangled kernel name: (instructions, instructions of its main
    loop)}. The main loop is the backward branch that spans the most
    instructions."""
    return {name: (tot, max((n for n, _ in loops), default=tot))
            for name, (tot, loops) in sass_loops(lib_path).items()}


def res_usage(lib_path) -> dict:
    """``cuobjdump -res-usage`` of a built library: {mangled kernel name:
    (registers a thread, stack bytes, local bytes)}."""
    import re
    from bbmap_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-res-usage", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
            for m in re.finditer(r"Function (\S+?):?\s+REG:(\d+)\s+"
                                 r"STACK:(\d+)\s+SHARED:\d+\s+LOCAL:(\d+)",
                                 text)}


def kernel_instructions() -> dict:
    """Instructions a DP cell (or a walk step) for each kernel variant
    the paths launch, from the built libraries' SASS: the main loop's
    instructions over the cells one pass of it evaluates ("per_cell"),
    and the least of them among the variants of the same function
    ("function_per_cell"): what one mapping does a cell in, no mapping
    needs more for. Keys: the variant names of ``VARIANT`` and
    "msa_walk"."""
    from bbmap_tpu_torch.ops import _build
    from bbmap_tpu_torch.ops import msa_kernels as mk

    def pick(counts, *parts):
        hits = [v for k, v in counts.items() if all(p in k for p in parts)]
        if len(hits) != 1:
            raise AssertionError(f"{len(hits)} kernels match {parts}")
        return hits[0]

    dp = sass_counts(_build.library_path("msa_dp"))
    pipe = sass_counts(_build.library_path("msa_dp_pipe"))
    warp = sass_counts(_build.library_path("msa_dp_warp"))
    band = sass_counts(_build.library_path("msa_dp_band"))
    Jw = mk.launch_shape(L, L + 24, "warp").rows_per_thread
    Jl = mk.launch_shape(L_LONG, LONG_C, "strided").rows_per_thread
    # rows a lane of the band launches the ``kernels`` line times
    Jb = {"msa_score": mk.launch_shape(L_LONG, LONG_C, None,
                                       LONG_SCORE_JOBS).rows_per_thread,
          "msa_fill": mk.launch_shape(L_LONG, LONG_C, None, LONG_FILL_JOBS[0],
                                      True).rows_per_thread}
    out = {}
    for name, ops, prevs in (("msa_score", "RawOps", "Lb0"),
                             ("msa_fill", "RawOps", "Lb1"),
                             ("msa_score_rows", "RowOps", "Lb0")):
        tot, loop = pick(warp, "msa_dp_warp_kernel", ops, prevs, f"Li{Jw}E")
        out[VARIANT[name, "warp"]] = {"sass": tot, "loop": loop,
                                      "per_cell": loop / Jw}
        tot, loop = pick(dp, "msa_dp_kernel", ops, prevs)
        out[VARIANT[name, "row"]] = {"sass": tot, "loop": loop,
                                     "per_cell": loop}
        # the pipe mapping at the short reads' 150 rows: a lane a row
        tot, loop = pick(pipe, "msa_dp_pipe_kernel", ops, prevs, "Li1E")
        out[VARIANT[name, "pipe"]] = {"sass": tot, "loop": loop,
                                      "per_cell": loop}
        if ops == "RawOps":
            tot, loop = pick(dp, "msa_dp_long_kernel", ops, prevs,
                             f"Li{Jl}E")
            out[VARIANT[name, "strided"]] = {"sass": tot, "loop": loop,
                                             "per_cell": loop / Jl}
            for J in mk.BAND_ROWS_PER_LANE:
                tot, loop = pick(band, "msa_dp_band_kernel", ops, prevs,
                                 f"Li{J}E")
                key = VARIANT[name, "band"] + ("" if J == Jb[name]
                                               else f"/{J}")
                out[key] = {"sass": tot, "loop": loop, "per_cell": loop / J}
                FUNCTION[key] = name
    tot, loop = pick(warp, "msa_score_segments_kernel", f"Li{Jw}E")
    out["msa_score_segments"] = {"sass": tot, "loop": loop,
                                 "per_cell": loop / Jw}
    # the walk: a step is one pass of the shortest loop that reads shared
    # memory (the tile's code) and stores there (the state buffer)
    tot, loops = pick(sass_loops(_build.library_path("msa_walk")),
                      "msa_walk_kernel")
    step = min(n for n, ops in loops if {"LDS", "STS"} <= ops)
    out["msa_walk"] = {"sass": tot, "loop": step, "per_cell": step}
    # the fused fill + walk: its sweep loop a cell (the walk's loop is the
    # shorter one)
    fw_lib = _build.library_path("msa_fill_walk")
    fw = sass_counts(fw_lib)
    use = res_usage(fw_lib)
    for v, name in FILL_WALK.items():
        packed = f"Lb{int(v.endswith('_packed'))}"
        tot, loop = pick(fw, "msa_fill_walk_row_kernel", packed)
        out[name] = {"sass": tot, "loop": loop, "per_cell": loop}
        # a block of up to 1,024 threads must find its registers on an SM
        regs, stack, local = pick(use, "msa_fill_walk_row_kernel", packed)
        say(f"resources {name}: {regs} registers a thread, stack {stack} "
            f"B, local {local} B")
        if regs * mk.MAX_THREADS > 65536:
            raise AssertionError(f"{name}: {regs} registers a thread do "
                                 f"not fit a block of {mk.MAX_THREADS}")
    for lib in _build.SOURCES:
        for name, (regs, stack, local) in sorted(
                res_usage(_build.library_path(lib)).items()):
            say(f"resources {lib} {name}: {regs} registers a thread, stack "
                f"{stack} B, local {local} B")
    for name, v in out.items():
        v["function_per_cell"] = min(w["per_cell"] for n, w in out.items()
                                     if FUNCTION[n] == FUNCTION[name])
        say(f"sass {name}: {v['sass']} instructions, main loop {v['loop']}, "
            f"{v['per_cell']:.1f} a cell; {FUNCTION[name]} needs at most "
            f"{v['function_per_cell']:.1f}")
    return out


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def bound_ms(n_bytes: float, n_instructions: float, clock_hz: float):
    """The least time the card could take: the larger of bytes over the
    device memory rate and instructions over the schedulers' rate, SMs
    x 4 schedulers x 32 lanes x the SM clock. Returns (ms, "bytes" or
    "operations")."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_instructions / (sms * SCHEDULER_LANES_PER_SM * clock_hz)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(genome, device) -> dict:
    """``kernel_phases`` with the edge cases' plain fills computed in a CPU
    process beside it (``PlainFills``)."""
    plain = PlainFills()
    try:
        return kernel_phases(genome, device, plain)
    finally:
        plain.stop()


def kernel_phases(genome, device, plain) -> dict:
    """Kernels against their plain versions on the card (the band
    mapping's edge cases against plain fills from ``plain``); returns per
    kernel variant {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms and, where another mapping was timed beside the default,
    row_ms / warp_ms / strided_ms}: "msa_score_rows" (K1), "msa_score" /
    "msa_fill" (a warp a job / a row a thread), "msa_score_long" /
    "msa_fill_long" (a warp a band of rows), "msa_score_strided" /
    "msa_fill_strided" (rows strided over the block) and "msa_walk"."""
    import torch
    from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa
    from bbmap_tpu_torch.ops import msa_kernels as mk

    err = {}
    instr = kernel_instructions()
    clock = max_sm_clock_hz()
    say(f"card clocks.max.sm {clock / 1e6:.0f} MHz")

    def record(key, tag, n, R, C, e, what=""):
        err[key] = max(err.get(key, 0), e)
        say(f"kernel {key} {tag}: {n} jobs (R, C) = ({R}, {C}) "
            f"max_abs_err {e}{what}")
        if e != 0:
            raise AssertionError(f"{key} disagrees with its plain version "
                                 f"({tag})")

    def key_of(name, n, R, C, mapping):
        shape = mk.launch_shape(R, C, mapping, jobs=n,
                                fill=name == "msa_fill")
        return VARIANT[name, shape.mapping]

    def jobs(n, R, C, seed, pb_err=0.0):
        return dp_jobs(genome, n, R, C, seed, device, pb_err=pb_err)

    def cmp_score(tag, P, job, k=None, p=None, mapping=None):
        rd, rf, rw = job
        k = mk.msa_score(rd, rf, rw, P, mapping) if k is None else k
        p = mk.msa_score_plain(rd, rf, rw, P) if p is None else p
        _sync(device)
        R, C = rd.shape[1], rf.shape[1]
        record(key_of("msa_score", len(rw), R, C, mapping), tag, len(rw), R,
               C, int((k.long() - p.long()).abs().max()))
        return p

    def cmp_fill(tag, P, job, k=None, p=None, mapping=None):
        """A fill (out, prev codes, layout) against the plain version's,
        on out and, through each block's stride map, on every valid prev
        code. Returns the plain version's."""
        rd, rf, rw = job
        k = mk.msa_fill(rd, rf, rw, P, mapping) if k is None else k
        p = mk.msa_fill_plain(rd, rf, rw, P) if p is None else p
        _sync(device)
        R, C = rd.shape[1], rf.shape[1]
        e = max(int((k[0].long() - p[0].long()).abs().max()),
                prev_code_err(k[1:], p[1:], rw, R, C))
        record(key_of("msa_fill", len(rw), R, C, mapping), tag, len(rw), R,
               C, e, f" (out and prev codes on valid cells, "
               f"{'row' if k[2] == msa.row_major(R, C) else 'wave'}-major)")
        return p

    def cmp_rows(tag, job, k=None, p=None, mapping=None):
        rd, rf, rw = job
        R, C = rd.shape[1], rf.shape[1]
        if k is None or p is None:
            r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
            k = mk.msa_score_rows(r1, r0, (rp, rows), R, C, 64, mapping)
            p = mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 64)
        _sync(device)
        record(key_of("msa_score_rows", len(rw), R, C, mapping), tag,
               len(rw), R, C, int((k.long() - p.long()).abs().max()))

    def cmp_walk(tag, job, prevs, col0, st0, steps, layout=None,
                 part=slice(None), ref=None):
        """The walk kernel against its plain version on one fill's prev
        codes (a block in ``layout``, default wave-major), from the given
        columns and states; the plain version walks the jobs of ``part``
        only. With ``ref`` (the walks of those jobs from the same starts,
        already held to the plain version) no plain walk runs: the jobs of
        ``part`` are held to ``ref``. Returns the number of walks that were
        cut."""
        rd, rf, _ = job
        R, C = rd.shape[1], rf.shape[1]
        k = mk.msa_walk(prevs, rd, rf, col0, st0, R, C, steps, layout)
        p = ref if ref is not None else mk.msa_walk_plain(
            *(x[part] for x in (prevs, rd, rf, col0, st0)), R, C, steps,
            layout)
        _sync(device)
        e = max(int((a[part].long() - b.long()).abs().max())
                for a, b in zip(k, p))
        cut = int((k[3] > 0).sum())
        lay = "row" if layout == msa.row_major(R, C) else "wave"
        record("msa_walk", tag, len(p[1]), R, C, e,
               f" (symbols, out_len, gaps, row_end; steps {steps or R + C},"
               f" {cut} walks cut, {lay}-major block of {len(col0)} jobs)")
        return cut

    def walk_starts(out, C, seed):
        """The fill's own last-row columns and states, and a shifted set:
        random columns in 1..C and random states."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        n = out.shape[1]
        col = torch.randint(1, C + 1, (n,), generator=g, dtype=torch.int32)
        st = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
        return ((out[1], out[2]), (col.to(out.device), st.to(out.device)))

    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    for mapping in ("warp", "row"):
        cmp_score("short narrow", S, jobs(4096, L, L + 24, 1),
                  mapping=mapping)
        cmp_score("short wide", S, jobs(512, L, L + 456, 2), mapping=mapping)
        cmp_score("pacbio", PB, jobs(256, 300, 360, 3), mapping=mapping)
        cmp_fill("short narrow", S, jobs(1024, L, L + 24, 4),
                 mapping=mapping)
        cmp_fill("pacbio", PB, jobs(256, 300, 360, 6), mapping=mapping)
        cmp_rows("short narrow", jobs(4096, L, L + 24, 12), mapping=mapping)
    # the walk over a wide fill, full length, N and gap columns included
    job = rd, rf, rw = jobs(64, L, L + 456, 5)
    rf[::7, 200] = ord("-")
    rf[::5, 90] = ord("N")
    cmp_fill("short wide, gap columns", S, job, mapping="warp")
    k = mk.msa_fill(rd, rf, rw, S)
    pp = cmp_fill("short wide, gap columns", S, job, k)[1]
    for col0, st0 in walk_starts(k[0], L + 456, 31):
        cmp_walk("short wide, full length", job, pp, col0, st0, 0)
    del k, pp

    def cmp_long(i):
        """Past 1,023 rows, edge case i of ``EDGE_CASES``: the band mapping
        at each of its rows a lane and the strided mapping, score and
        fill, against one plain fill (whose out is the score pass's) from
        the CPU process. Returns the jobs."""
        tag, prof, _n, _R, _C, _seed, _err, Js, _gaps = EDGE_CASES[i]
        P = S if prof == "S" else PB
        job = rd, rf, rw = edge_jobs(genome, EDGE_CASES[i], device)
        p = plain.get(i, device)
        for J in Js:
            with band_rows_a_lane(J, len(rw), rd.shape[1]):
                cmp_score(f"{tag}, {J} rows a lane", P, job, p=p[0],
                          mapping="band")
                cmp_fill(f"{tag}, {J} rows a lane", P, job, p=p,
                         mapping="band")
        cmp_score(tag, P, job, p=p[0], mapping="strided")
        cmp_fill(tag, P, job, p=p, mapping="strided")
        return job

    # times at the paths' shapes: the short path's 2E = 32,768 score
    # jobs and T = 8,192 fill jobs at (R, C) = (150, 174) with the walk
    # bounded to 190 steps, K1 at its entry point's 32,768 jobs, and the
    # long-read wide escalation window (6,000, 6,456): 256 score jobs
    # and 16 to 400 fill jobs and their walks, in the band and in the
    # strided mapping, whose results are compared with the plain
    # version's as well. The wide pass (128 score and 64 fill jobs at
    # (150, 606)) and PACBIO (300, 360) are timed in both mappings.
    out = {}

    def timed(name, kern, plain, reps, plain_warm=True, other=None):
        """Time a kernel and its plain version; ``other`` = (key, fn)
        times the other mapping beside it."""
        ms, k = _cuda_ms(kern, reps)
        plain_ms, p = _cuda_ms(plain, 1, warm=plain_warm)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None}
        if other is not None:
            out[name][other[0]] = _cuda_ms(other[1], reps)[0]
        return k, p

    def dp_bound(name, job, fill, keep=True):
        """Bytes: reads, windows and rows in, out (3, B) and, for the
        fill, one byte a valid cell out. Instructions: the (rows + 1) x
        (C + 1) in-window cells of each job's own rows times the
        function's instructions a cell (the least among its mappings,
        not this kernel's own). With ``keep`` stored beside ``name``'s
        times; returns (ms, "bytes" or "operations")."""
        rd, rf, rw = job
        C = rf.shape[1]
        rows = rw.double()
        n_bytes = rd.numel() + rf.numel() + 4 * rw.numel() + 12 * len(rw)
        if name == "msa_score_rows":        # K1 reads int32 operands
            R = rd.shape[1]
            n_bytes = 4 * len(rw) * (2 * (R + 1) + C + 2 * R + 2 + 1 + 3)
        if fill:
            n_bytes += float((rows * C).sum())
        cells = float(((rows + 1) * (C + 1)).sum())
        ms, by = bound_ms(n_bytes, cells * instr[name]["function_per_cell"],
                          clock)
        if keep:
            out[name].update(bound_ms=ms, bound_by=by, cells=cells)
        return ms, by

    def walk_bound(walked, n_jobs, steps):
        """Bytes: three bytes a step walked (prev code, read and window
        character), the (B, steps) symbols out and 20 bytes a job of
        columns, states and results. Instructions: the steps walked
        times the kernel's instructions a step (one lane of a warp
        walks)."""
        n_bytes = 3 * walked + n_jobs * steps + 20 * n_jobs
        return bound_ms(
            n_bytes, walked * instr["msa_walk"]["function_per_cell"], clock)

    def walk_clocks(tag, ms, lens):
        """Clocks a walked step: the launch's time at clocks.max.sm over
        the longest walk's steps (the chains run side by side)."""
        longest = int(lens.max())
        say(f"clocks msa_walk at {tag}: {ms * 1e-3 * clock / longest:.1f} "
            f"clocks a walked step ({ms:.4f} ms, longest walk {longest} "
            f"steps, {float(lens.double().mean()):.1f} on average, "
            f"{clock / 1e6:.0f} MHz)")

    def walk_times(tag, job, fill, starts, shifted):
        """The walk kernel over a fill's block (out, prevs, layout): full
        length, cut at R + 50, and from shifted starts, each timed and
        held equal to its first run."""
        rd, rf, _ = job
        _, prevs, lay = fill
        for steps in (0, L_LONG + 50):
            for name, (c0, s0) in (("", starts), (", shifted starts",
                                                   shifted)):
                want = mk.msa_walk(prevs, rd, rf, c0, s0, L_LONG, Cl, steps,
                                   lay)
                ms, got = _cuda_ms(lambda: mk.msa_walk(
                    prevs, rd, rf, c0, s0, L_LONG, Cl, steps, lay), 3)
                e = max(int((a.long() - b.long()).abs().max())
                        for a, b in zip(got, want))
                what = "full length" if not steps else f"cut at {steps}"
                say(f"time msa_walk at {tag}, {what}{name}: {ms:.4f} ms "
                    f"({int((got[3] > 0).sum())} walks cut; same as the "
                    f"first run: max_abs_err {e})")
                walk_clocks(f"{tag}, {what}{name}", ms, got[1])
                if e:
                    raise AssertionError("two runs of the walk disagree")

    job = rd, rf, rw = dp_jobs(genome, 2 * 16384, L, L + 24, 7, device,
                               var_rows=False)
    k, p = timed("msa_score", lambda: mk.msa_score(rd, rf, rw, S),
                 lambda: mk.msa_score_plain(rd, rf, rw, S), 10,
                 other=("row_ms", lambda: mk.msa_score(rd, rf, rw, S,
                                                       "row")))
    dp_bound("msa_score", job, False)
    cmp_score("short narrow, 32,768 jobs", S, job, k, p)
    r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
    R, C = rd.shape[1], rf.shape[1]
    k, p = timed(
        "msa_score_rows",
        lambda: mk.msa_score_rows(r1, r0, (rp, rows), R, C, 64),
        lambda: mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 64), 10,
        other=("row_ms", lambda: mk.msa_score_rows(r1, r0, (rp, rows), R, C,
                                                   64, "row")))
    dp_bound("msa_score_rows", job, False)
    cmp_rows("short narrow, 32,768 jobs", job, k, p)
    del k, p, r1, r0, rp, rows
    # K2 in the warp, one-row and pipe mappings over the job count, K3 in
    # the one-row and pipe mappings, at the narrow and the wide window:
    # what launch_shape's WARP_MIN_JOBS and its choice below it rest on
    for Cs in (L + 24, L + 456):
        wide_jobs = dp_jobs(genome, 4096, L, Cs, 40, device,
                            var_rows=False) if Cs == L + 456 else None
        for n in ONEROW_SWEEP_JOBS:
            a = (rd[:n], rf[:n], rw[:n]) if Cs == L + 24 \
                else tuple(x[:n] for x in wide_jobs)
            t_ = {m: _cuda_ms(lambda: mk.msa_score(*a, S, m), 10)[0]
                  for m in ("warp", "row", "pipe")}
            f_ = {m: _cuda_ms(lambda: mk.msa_fill(*a, S, m)[0], 5)[0]
                  for m in ("row", "pipe")}
            say(f"sweep msa_score {n} x ({L}, {Cs}): warp {t_['warp']:.4f} "
                f"ms, one-row {t_['row']:.4f} ms, pipe {t_['pipe']:.4f} ms, "
                f"default {mk.launch_shape(L, Cs, jobs=n).mapping}; "
                f"msa_fill one-row {f_['row']:.4f} ms, pipe "
                f"{f_['pipe']:.4f} ms, default "
                f"{mk.launch_shape(L, Cs, jobs=n, fill=True).mapping}")
        del wide_jobs
    job = rd, rf, rw = rd[:8192], rf[:8192], rw[:8192]
    k, p = timed("msa_fill", lambda: mk.msa_fill(rd, rf, rw, S, "row"),
                 lambda: mk.msa_fill_plain(rd, rf, rw, S), 10,
                 other=("warp_ms", lambda: mk.msa_fill(rd, rf, rw, S,
                                                       "warp")))
    dp_bound("msa_fill", job, True)
    cmp_fill("short narrow, 8,192 jobs", S, job, k, p, mapping="row")
    cmp_fill("short narrow, 8,192 jobs", S, job, p=p, mapping="warp")
    steps = L + 24 + 16
    (col0, st0), shifted = walk_starts(k[0], L + 24, 32)
    # short walks run in the fused kernel on every path; the walk kernel
    # is held to its plain version here and timed at the long reads' shape
    kw = mk.msa_walk(k[1], rd, rf, col0, st0, L, L + 24, steps)
    pw = mk.msa_walk_plain(k[1], rd, rf, col0, st0, L, L + 24, steps)
    _sync(device)
    record("msa_walk", "short narrow, bounded, the kernel's prev codes",
           len(rw), L, L + 24,
           max(int((a.long() - b.long()).abs().max())
               for a, b in zip(kw, pw)))
    cmp_walk("short narrow, bounded", job, p[1], col0, st0, steps)
    cmp_walk("short narrow, bounded, shifted starts", job, p[1], *shifted,
             steps)
    if cmp_walk("short narrow, cut at 120 steps", job, p[1], col0, st0,
                120) == 0:
        raise AssertionError("no walk was cut at 120 steps")
    del k, p, kw, pw

    # the wide pass as the main path runs it (one-row mapping at 128
    # jobs), and the small shapes in both mappings
    job = rd, rf, rw = jobs(128, L, L + 456, 23)
    k, p = timed("msa_score_row", lambda: mk.msa_score(rd, rf, rw, S),
                 lambda: mk.msa_score_plain(rd, rf, rw, S), 10,
                 other=("warp_ms", lambda: mk.msa_score(rd, rf, rw, S,
                                                        "warp")))
    dp_bound("msa_score_row", job, False)
    cmp_score("short wide, 128 jobs", S, job, k, p)
    extra = {}
    for tag, P, n, R, C, seed, fn in (
            ("msa_fill wide retrace", S, 64, L, L + 456, 25, mk.msa_fill),
            ("msa_score pacbio", PB, 256, 300, 360, 24, mk.msa_score),
            ("msa_fill pacbio", PB, 256, 300, 360, 24, mk.msa_fill)):
        a = jobs(n, R, C, seed)
        extra[tag] = (n, R, C, _cuda_ms(lambda: fn(*a, P, "warp"), 10)[0],
                      _cuda_ms(lambda: fn(*a, P, "row"), 10)[0])

    def strided_beside(name):
        """The strided kernel's entry: the band entry's shape, plain time
        and bound, with its own time."""
        t = dict(out[name], ms=out[name]["strided_ms"])
        del t["strided_ms"]
        out[name.replace("_long", "_strided")] = t

    def over_rows_a_lane(fn, job):
        """ms of one band launch at each rows a lane."""
        times = []
        for J in mk.BAND_ROWS_PER_LANE:
            with band_rows_a_lane(J, len(job[2]), L_LONG):
                # [0]: a fill's prev codes are freed as soon as it returns
                times.append(_cuda_ms(lambda: fn(*job, PB, "band")[0], 2)[0])
        return ", ".join(f"{J} rows a lane {t:.3f} ms" for J, t in
                         zip(mk.BAND_ROWS_PER_LANE, times))

    # At (6,000, 6,456) the kernels run at the full job counts and the
    # plain versions on the first LONG_CMP_JOBS of them (row counts and
    # error profile as drawn), the comparisons on those jobs: the plain
    # runs on all of them took minutes of the script's limit.
    Cl = LONG_C
    two = slice(0, LONG_CMP_JOBS)
    most = jobs(max(LONG_SWEEP_JOBS), L_LONG, Cl, 19, 0.12)
    job = rd, rf, rw = tuple(x[:LONG_SCORE_JOBS] for x in most)
    job2 = tuple(x[two] for x in job)
    k, p = timed("msa_score_long", lambda: mk.msa_score(rd, rf, rw, PB),
                 lambda: mk.msa_score_plain(*job2, PB), 2, False,
                 other=("strided_ms",
                        lambda: mk.msa_score(rd, rf, rw, PB, "strided")))
    out["msa_score_long"]["plain_jobs"] = LONG_CMP_JOBS
    dp_bound("msa_score_long", job, False)
    strided_beside("msa_score_long")
    cmp_score("pacbio long read", PB, job2, k[:, two], p)
    cmp_score("pacbio long read", PB, job2, p=p, mapping="strided")
    for n in LONG_SWEEP_JOBS:
        sub = tuple(x[:n] for x in most)
        say(f"sweep msa_score band {n} x ({L_LONG}, {Cl}): "
            f"{over_rows_a_lane(mk.msa_score, sub)}; strided "
            f"{_cuda_ms(lambda: mk.msa_score(*sub, PB, 'strided'), 2)[0]:.3f}"
            f" ms; default "
            f"{mk.launch_shape(L_LONG, Cl, jobs=n).rows_per_thread}")
    del k, p, most
    # fills: the 16 jobs every earlier run timed are held against the
    # plain version, alone and as the last 16 of 64 to 400 jobs. The
    # 64-job blocks pass 2**31 bytes in either layout (64 x 38.8 MB
    # row-major, 64 x 74.7 MB wave-major), so their last jobs check the
    # kernels' 64-bit offsets.
    n16 = LONG_FILL_JOBS[0]
    job = rd, rf, rw = jobs(n16, L_LONG, Cl, 20, 0.12)
    job2 = tuple(x[two] for x in job)
    k, p = timed("msa_fill_long", lambda: mk.msa_fill(rd, rf, rw, PB),
                 lambda: mk.msa_fill_plain(*job2, PB), 2, False,
                 other=("strided_ms",
                        lambda: mk.msa_fill(rd, rf, rw, PB, "strided")))
    out["msa_fill_long"]["plain_jobs"] = LONG_CMP_JOBS
    dp_bound("msa_fill_long", job, True)
    strided_beside("msa_fill_long")
    cmp_fill("pacbio long read", PB, job2, (k[0][:, two], k[1][two], k[2]),
             p)
    cmp_fill("pacbio long read", PB, job2, p=p, mapping="strided")
    (col0, st0), shifted = walk_starts(k[0], Cl, 33)
    # the walk kernel's entry: the long-read path's walk, full length, from
    # the fill's own starts and from shifted ones; the plain version walks
    # the compared jobs from both in one call (its time is a step's, not a
    # job's) over the plain fill's wave-major block
    ms_l, kw = _cuda_ms(lambda: mk.msa_walk(k[1], rd, rf, col0, st0, L_LONG,
                                            Cl, 0, k[2]), 2)
    kw_s = mk.msa_walk(k[1], rd, rf, *shifted, L_LONG, Cl, 0, k[2])
    both = (torch.cat([p[1], p[1]]), *(torch.cat([x, x]) for x in job2[:2]),
            torch.cat([col0[two], shifted[0][two]]),
            torch.cat([st0[two], shifted[1][two]]))
    plain_ms, pw = _cuda_ms(lambda: mk.msa_walk_plain(*both, L_LONG, Cl), 1,
                            warm=False)
    ms_b, by = walk_bound(float(kw[1].sum()), len(rw), L_LONG + Cl)
    out["msa_walk"] = {"ms": ms_l, "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": ms_b, "bound_by": by,
                       "plain_jobs": 2 * LONG_CMP_JOBS}
    nc = LONG_CMP_JOBS
    for what, kk, half in (("", kw, slice(0, nc)),
                           (", shifted starts", kw_s, slice(nc, 2 * nc))):
        record("msa_walk", f"pacbio long read, full length{what}, the band "
               f"fill's row-major block against the plain fill's wave-major "
               f"block", nc, L_LONG, Cl,
               max(int((a[two].long() - b[half].long()).abs().max())
                   for a, b in zip(kk, pw)))
    walk_clocks(f"{n16} x ({L_LONG}, {Cl}), full length", ms_l, kw[1])
    # the compared jobs' walks from their own starts: the reference of the
    # 64- and 400-job blocks below, which hold the same jobs
    ref_walk = tuple(x[two] for x in kw)
    del kw, kw_s, pw, both
    if cmp_walk(f"pacbio long read, cut at {L_LONG + 50} steps", job, k[1],
                col0, st0, L_LONG + 50, k[2], part=two) == 0:
        raise AssertionError("no long walk was cut")
    walk_times(f"{n16} x ({L_LONG}, {Cl})", job, k, (col0, st0), shifted)
    say(f"sweep msa_fill band {n16} x ({L_LONG}, {Cl}): "
        f"{over_rows_a_lane(mk.msa_fill, job)}; strided "
        f"{out['msa_fill_long']['strided_ms']:.3f} ms; default "
        f"{mk.launch_shape(L_LONG, Cl, None, n16, True).rows_per_thread}")
    del k
    one = jobs(1, L_LONG, Cl, 18, 0.12)
    say(f"sweep msa_fill band 1 x ({L_LONG}, {Cl}): "
        f"{over_rows_a_lane(mk.msa_fill, one)}; strided "
        f"{_cuda_ms(lambda: mk.msa_fill(*one, PB, 'strided'), 2)[0]:.3f} ms")
    for n in LONG_FILL_JOBS[1:]:
        more = jobs(n - n16, L_LONG, Cl, 22 + n, 0.12)
        big = brd, brf, brw = tuple(torch.cat([a, b])
                                    for a, b in zip(more, job))
        del more
        ms, kb = _cuda_ms(lambda: mk.msa_fill(brd, brf, brw, PB), 2)
        # the compared jobs: the first LONG_CMP_JOBS of the 16 at the end
        at = slice(n - n16, n - n16 + LONG_CMP_JOBS)
        e = max(int((kb[0][:, at].long() - p[0].long()).abs().max()),
                prev_code_err((kb[1][at], kb[2]), p[1:], rw[two], L_LONG,
                              Cl))
        record("msa_fill_long", f"pacbio long read, jobs {at.start} and "
               f"{at.start + 1} of {n} ({kb[1].numel()} bytes of prev "
               f"codes)", LONG_CMP_JOBS, L_LONG, Cl, e)
        if n == LONG_FILL_JOBS[1]:
            if kb[1].numel() <= PAST_32_BITS:
                raise AssertionError("the block does not pass 2**31 bytes")
            cmp_walk(f"pacbio long read, jobs {at.start} and {at.start + 1}"
                     f" of {n} (prev codes past 2**31 bytes)", big, kb[1],
                     kb[0][1], kb[0][2], 0, kb[2], part=at, ref=ref_walk)
        if n == LONG_FILL_JOBS[-1]:
            starts, shifted_n = walk_starts(kb[0], Cl, 34)
            starts = tuple(x.clone() for x in starts)
            starts[0][at], starts[1][at] = col0[two], st0[two]
            cmp_walk(f"pacbio long read, {n} jobs, full length", big, kb[1],
                     *starts, 0, kb[2], part=at, ref=ref_walk)
            walk_times(f"{n} x ({L_LONG}, {Cl})", big, kb, starts, shifted_n)
            del starts, shifted_n
        bound, _ = dp_bound("msa_fill_long", big, True, keep=False)
        say(f"sweep msa_fill band {n} x ({L_LONG}, {Cl}): "
            f"{over_rows_a_lane(mk.msa_fill, big)}; default "
            f"{mk.launch_shape(L_LONG, Cl, None, n, True).rows_per_thread}")
        del kb
        ms_s = _cuda_ms(lambda: mk.msa_fill(brd, brf, brw, PB,
                                            "strided")[0], 2)[0]
        if n == LONG_FILL_JOBS[1]:
            ks = mk.msa_fill(brd, brf, brw, PB, "strided")
            if ks[1].numel() <= PAST_32_BITS:
                raise AssertionError("the block does not pass 2**31 bytes")
            e = max(int((ks[0][:, at].long() - p[0].long()).abs().max()),
                    prev_code_err((ks[1][at], ks[2]), p[1:], rw[two], L_LONG,
                                  Cl))
            record("msa_fill_strided", f"pacbio long read, jobs {at.start} "
                   f"and {at.start + 1} of {n} ({ks[1].numel()} bytes of "
                   f"prev codes)", LONG_CMP_JOBS, L_LONG, Cl, e)
            cmp_walk(f"pacbio long read, jobs {at.start} and {at.start + 1}"
                     f" of {n} (prev codes past 2**31 bytes)", big, ks[1],
                     ks[0][1], ks[0][2], 0, ks[2], part=at, ref=ref_walk)
            del ks
        del big, brd, brf, brw
        torch.cuda.empty_cache()
        say(f"time msa_fill_long at {n} x ({L_LONG}, {Cl}) PACBIO: band "
            f"{ms:.3f} ms, strided {ms_s:.3f} ms, bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f} % of the bound reached)")
    del p
    # the band mapping at the edges of its design, against the CPU
    # process's plain fills: one job just past 1,023 rows; 100 jobs whose
    # last band and last lane are partly empty (1,101 rows) and K1's
    # operands on the same jobs; SHORT profile with N and gap columns; the
    # long-read narrow window; the largest R
    for i in range(len(EDGE_CASES)):
        job = cmp_long(i)
        if i == 1:
            cmp_rows("ragged last band", tuple(x[:64] for x in job))
    del job
    # between the warp mapping's 319 rows and 1,023: the band mapping
    # beside the one-row and pipe mappings, what PIPE_MID_* rests on; the
    # jobs of a window made once at 2,048 jobs, a launch of n jobs their
    # first n, every mapping's out held to the plain version's
    for R, C in ((500, 560), (700, 760), (1000, 1100)):
        a_all = jobs(2048, R, C, 50, 0.1)
        want = mk.msa_score_plain(*a_all, PB)
        for n in (16, 64, 256, 1024, 2048):
            a = tuple(x[:n] for x in a_all)
            cols = []
            for name, fn in (
                    ("msa_score", lambda m: mk.msa_score(*a, PB, m)),
                    ("msa_fill", lambda m: mk.msa_fill(*a, PB, m)[0])):
                ts = {}
                for m in ("row", "band", "pipe"):
                    ts[m], got = _cuda_ms(lambda: fn(m), 3)
                    key = key_of(name, n, R, C, m)
                    e = _diff(got, want[:, :n])
                    err[key] = max(err.get(key, 0), e)
                    if e:
                        raise AssertionError(f"{key} at {n} x ({R}, {C}) "
                                             f"disagrees with its plain "
                                             f"version: max_abs_err {e}")
                cols.append("one-row %.3f ms, band %.3f ms, pipe %.3f ms"
                            % tuple(ts[m] for m in ("row", "band", "pipe")))
            say(f"sweep band mid {n} x ({R}, {C}): score {cols[0]}; fill "
                f"{cols[1]}; default "
                f"{mk.launch_shape(R, C, None, n).mapping}; every out "
                f"equal to the plain version's")
    shapes = {"msa_score": "32,768 x (150, 174)",
              "msa_score_row": "128 x (150, 606)",
              "msa_score_rows": "32,768 x (150, 174)",
              "msa_fill": "8,192 x (150, 174)",
              "msa_walk": "16 x (6,000, 6,456) PACBIO, full length",
              "msa_score_long": "256 x (6,000, 6,456) PACBIO",
              "msa_fill_long": "16 x (6,000, 6,456) PACBIO"}
    shapes.update({k.replace("_long", "_strided"): v
                   for k, v in shapes.items() if k.endswith("_long")})
    for name, t in out.items():
        t["max_abs_err"] = err[name]
        t["per_cell"] = instr[name]["per_cell"]
        t["function_per_cell"] = instr[name]["function_per_cell"]
        row = f", one-row mapping {t['row_ms']:.3f} ms" \
            if "row_ms" in t else ""
        if "warp_ms" in t:
            row = f", warp mapping {t['warp_ms']:.3f} ms"
        if "strided_ms" in t:
            row = f", strided mapping {t['strided_ms']:.3f} ms"
        say(f"time {name} at {shapes[name]}: kernel {t['ms']:.3f} ms{row}, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']} ({100 * t['bound_ms'] / t['ms']:.1f} % of "
            f"the bound reached; bound at {t['function_per_cell']:.1f} "
            f"instructions a cell, this kernel {t['per_cell']:.1f})")
    for tag, (n, R, C, a, b2) in extra.items():
        say(f"time {tag}: {n} x ({R}, {C}): warp mapping {a:.3f} ms, "
            f"one-row mapping {b2:.4f} ms")
    out.update(fill_walk_phase(genome, device, instr, clock))
    out.update(segments_phase(genome, device, instr, clock,
                              out["msa_score_row"]["ms"]))
    for name, t in pipe_phase(genome, device, instr, clock).items():
        t["max_abs_err"] = max(t["max_abs_err"], err.get(name, 0))
        out[name] = t
    dpx_phase(genome, device)
    return out


def pipe_phase(genome, device, instr: dict, clock: float) -> dict:
    """The pipe mapping (``csrc/msa_dp_pipe.cu``) on the card: K2, K3 and
    K1's operands against their plain versions, tolerance 0, below 32
    rows, at a band's edge (32 and 64 rows), at the short reads' windows
    with N and gap columns, PACBIO at (300, 360), two rows a lane at (600,
    660) and 1,023 rows, a quarter of the jobs with rows below R; then
    each one's time beside the one-row mapping's (and the warp mapping's
    where it holds R) and its bound: K2 at 128 x (150, 606), K3 at 8,192 x
    (150, 174), K1 at 128 x (150, 174). Returns the ``kernels`` line's
    entries."""
    from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk

    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    err = {}
    for n, R, C, pname, tag in PIPE_CHECKS:
        P = S if pname == "S" else PB
        job = rd, rf, rw = dp_jobs(genome, n, R, C, n + R, device,
                                   pb_err=0.12 if P is PB else 0.0)
        if C > 400:
            rf[::7, C // 3] = ord("-")
            rf[::5, C // 6] = ord("N")
        p = mk.msa_fill_plain(rd, rf, rw, P)
        k = mk.msa_score(rd, rf, rw, P, "pipe")
        kf = mk.msa_fill(rd, rf, rw, P, "pipe")
        _sync(device)
        es = {"msa_score_pipe": _diff(k, p[0]),
              "msa_fill_pipe": max(_diff(kf[0], p[0]),
                                   prev_code_err(kf[1:], p[1:], rw, R, C))}
        if P is S:
            r1, r0, rp, rows = mk.prep_operands(rd, rf, rw)
            es["msa_score_rows_pipe"] = _diff(
                mk.msa_score_rows(r1, r0, (rp, rows), R, C, 1, "pipe"),
                mk.msa_score_rows_plain(r1, r0, (rp, rows), R, C, 1))
        for name, e in es.items():
            err[name] = max(err.get(name, 0), e)
        say(f"kernel pipe {tag}: {n} jobs (R, C) = ({R}, {C}), "
            f"{mk.launch_shape(R, C, 'pipe').rows_per_thread} rows a lane: "
            f"max_abs_err " + ", ".join(f"{k_} {v}" for k_, v in es.items())
            + " (out; the fill's prev codes on valid cells, row-major)")
        if any(es.values()):
            raise AssertionError(f"the pipe mapping disagrees ({tag})")
    out = {}
    for name, (n, R, C), fn, plain, others in (
            ("msa_score_pipe", (128, L, L + 456),
             lambda a, m: mk.msa_score(*a, S, m),
             lambda a: mk.msa_score_plain(*a, S), ("row", "warp")),
            ("msa_fill_pipe", (8192, L, L + 24),
             lambda a, m: mk.msa_fill(*a, S, m)[0],
             lambda a: mk.msa_fill_plain(*a, S)[0], ("row",)),
            ("msa_score_rows_pipe", (128, L, L + 24),
             lambda a, m: mk.msa_score_rows(*a, m),
             lambda a: mk.msa_score_rows_plain(*a), ("row", "warp"))):
        job = dp_jobs(genome, n, R, C, 90 + n, device, var_rows=False)
        a = job
        if name == "msa_score_rows_pipe":
            r1, r0, rp, rows = mk.prep_operands(*job)
            a = (r1, r0, (rp, rows), R, C, 1)
        ms, got = _cuda_ms(lambda: fn(a, "pipe"), 10)
        outs = {m: _cuda_ms(lambda: fn(a, m), 10) for m in others}
        times = {m: t for m, (t, _) in outs.items()}
        plain_ms, want = _cuda_ms(lambda: plain(a), 1, warm=False)
        # every mapping timed here, held to the plain version's out
        es = {"pipe": _diff(got, want),
              **{m: _diff(o, want) for m, (_, o) in outs.items()}}
        if any(es.values()):
            raise AssertionError(f"{name} at {n} x ({R}, {C}): the timed "
                                 f"mappings disagree with the plain "
                                 f"version: {es}")
        err[name] = max(err[name], es["pipe"])
        rd, rf, rw = job
        n_bytes = rd.numel() + rf.numel() + 16 * len(rw)
        if name == "msa_score_rows_pipe":
            n_bytes = 4 * n * (2 * (R + 1) + C + 2 * R + 2 + 1 + 3)
        if name == "msa_fill_pipe":
            n_bytes += float((rw.double() * C).sum())
        cells = float(((rw.double() + 1) * (C + 1)).sum())
        bound, by = bound_ms(n_bytes, cells * instr[name][
            "function_per_cell"], clock)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None,
                     "max_abs_err": err[name],
                     **{f"{m}_ms": t for m, t in times.items()}}
        say(f"time {name} at {n} x ({R}, {C}): max_abs_err against the "
            f"plain version " + ", ".join(f"{m} {e}" for m, e in es.items())
            + f"; pipe {ms:.4f} ms, " +
            ", ".join(f"{'one-row' if m == 'row' else m} mapping {t:.4f} ms"
                      for m, t in times.items()) +
            f", plain {plain_ms:.3f} ms, bound {bound:.4f} ms by {by} "
            f"({100 * bound / ms:.1f} % of the bound reached; "
            f"{instr[name]['per_cell']:.1f} instructions a cell, bound at "
            f"{instr[name]['function_per_cell']:.1f})")
    return out


@contextlib.contextmanager
def dpx_libraries(on: bool):
    """With ``on``, the mappings that keep dp_cell's plain form load their
    DPX builds (``_build.VARIANTS``, "<source>_dpx") in place of their
    libraries until the block ends."""
    from bbmap_tpu_torch.ops import _build
    names = [n for n in _build.VARIANTS if n.endswith("_dpx")]
    saved = {_build.VARIANTS[n][0]: _build._libs.get(_build.VARIANTS[n][0])
             for n in names}
    try:
        if on:
            for n in names:
                _build._libs[_build.VARIANTS[n][0]] = _build.load(n)
        yield
    finally:
        for src, lib in saved.items():
            if lib is None:
                _build._libs.pop(src, None)
            else:
                _build._libs[src] = lib


def dpx_phase(genome, device) -> None:
    """dp_cell's DPX form on the card: ``__viaddmax_s32`` beside max(a + b
    wrapped, c) on the int32 extremes and random words, then the two
    forms of the cell on 2**20 operand sets a profile (rows and columns in
    and off the window, read and window characters among ACGTN, '-' and
    the sentinels, packed cells that are scores with streaks, BAD,
    NEG_INF, random words and the extremes), all equal; then the mappings
    that keep the plain form timed once with it on (their DPX builds) and
    off, each held equal to itself off."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa, msa_kernels as mk
    rng = np.random.default_rng(101)
    ext = np.array([2**31 - 1, -2**31, -2**31 + 1, msa.NEG_INF, 2**30,
                    -2**30, 0, 1, -1, 2**31 - 2048, -(3 << 29)], np.int64)
    grid = np.stack(np.meshgrid(ext, ext, ext), -1).reshape(-1, 3)
    abc = np.concatenate([grid, rng.integers(-2**31, 2**31 - 1,
                                             (1 << 20, 3))])
    got = mk.addmax_probe(torch.from_numpy(abc.astype(np.int32)).to(
        device)).cpu().numpy()
    bad = int((got[:, 0] != got[:, 1]).sum())
    say(f"dpx addmax: __viaddmax_s32 against max(a + b wrapped, c) on "
        f"{len(abc)} triples ({len(grid)} of the int32 extremes): {bad} "
        f"differ")
    if bad:
        raise AssertionError("__viaddmax_s32 does not wrap as wadd does")
    chars = np.frombuffer(b"ACGTN-?!", np.uint8).astype(np.int64)
    n = 1 << 20
    for P, pname in ((SHORT_PROFILE, "short"), (PACBIO_PROFILE, "pacbio")):
        def cells():
            kind = rng.integers(0, 6, n)
            packed = (rng.integers(-40000, 40000, n) << P.SCOREOFFSET) \
                | rng.integers(0, 300, n)
            return np.where(kind == 0, P.BADoff, np.where(
                kind == 1, msa.NEG_INF, np.where(
                    kind == 2, rng.integers(-2**31, 2**31 - 1, n),
                    np.where(kind == 3, rng.choice(ext, n), packed))))
        ops = np.stack([rng.integers(0, 200, n), rng.integers(-2, 200, n),
                        np.full(n, 174), rng.integers(1, 151, n),
                        *(rng.choice(chars, n) for _ in range(4)),
                        *(cells() for _ in range(9))], 1)
        forms = mk.dp_cell_forms(torch.from_numpy(
            ((ops + 2**31) % 2**32 - 2**31).astype(np.int32)).to(device),
            P).cpu().numpy()
        d = int((forms[:, 1] != forms[:, 0]).any(1).sum())
        say(f"dpx cell, {pname}: the DPX form against the plain form on "
            f"{n} operand sets: {d} differ")
        if d:
            raise AssertionError("dp_cell's DPX form disagrees")
    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    narrow = dp_jobs(genome, 2 * 16384, L, L + 24, 110, device,
                     var_rows=False)
    wide = dp_jobs(genome, 128, L, L + 456, 111, device, var_rows=False)
    long_ = dp_jobs(genome, LONG_SCORE_JOBS, L_LONG, LONG_C, 112, device,
                    pb_err=0.12)
    for tag, fn in (
            ("msa_score warp, 32,768 x (150, 174)",
             lambda: mk.msa_score(*narrow, S, "warp")),
            ("msa_score one-row, 128 x (150, 606)",
             lambda: mk.msa_score(*wide, S, "row")),
            (f"msa_score band, {LONG_SCORE_JOBS} x ({L_LONG}, {LONG_C})",
             lambda: mk.msa_score(*long_, PB, "band")),
            ("msa_fill_walk, 8,192 x (150, 174), 190 steps",
             lambda: mk.msa_fill_walk(*(x[:8192] for x in narrow), S,
                                      L + 40)[0])):
        reps = 2 if "band" in tag else 10
        off, want = _cuda_ms(fn, reps)
        with dpx_libraries(True):
            on, got = _cuda_ms(fn, reps)
        e = _diff(got, want)
        say(f"time dpx {tag}: plain cell {off:.4f} ms, DPX cell {on:.4f} ms "
            f"({100 * (off - on) / off:+.1f} %), same out: max_abs_err {e}")
        if e:
            raise AssertionError(f"the DPX build disagrees: {tag}")


def segments_phase(genome, device, instr: dict, clock: float,
                   row_ms: float) -> dict:
    """The merged score launch (``msa_score_segments``) on the card: the
    fused program's narrow pass, 32,768 jobs at (150, 174), with its wide
    pass, 128 jobs at (150, 606), and PACBIO segments of (300, 360), (300,
    700) and an empty one with rows below R; each segment against its
    plain version and against ``msa_score`` on that segment alone,
    tolerance 0. Then the merged launch's time beside the two launches one
    after the other and the bound, and the clocks a wave of the wide pass
    in each. Returns the ``kernels`` line's
    entry."""
    from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk

    S, PB = SHORT_PROFILE, PACBIO_PROFILE
    narrow = dp_jobs(genome, 2 * 16384, L, L + 24, 71, device,
                     var_rows=False)
    wide = dp_jobs(genome, 128, L, L + 456, 72, device, var_rows=False)
    segs = [narrow, wide]
    pb = [dp_jobs(genome, 3000, 300, 360, 73, device),
          dp_jobs(genome, 64, 300, 700, 74, device)]
    pb.append(tuple(x[:0] for x in pb[1]))
    err = 0
    for tag, P, sg in (("the fused program's narrow and wide passes", S,
                        segs), ("pacbio, rows below R, an empty segment",
                                PB, pb)):
        if mk.segments_launch(sg) is None:
            raise AssertionError(f"{tag}: no merged launch")
        mk.reset_launches()
        got = mk.msa_score_segments(sg, P)
        if mk.msa_score_segments.launches != 1:
            raise AssertionError("the merged launch was not counted once")
        for i, (seg, g) in enumerate(zip(sg, got)):
            want = mk.msa_score_plain(*seg, P)
            alone = mk.msa_score(*seg, P)
            _sync(device)
            e = max(_diff(g, want), _diff(g, alone))
            err = max(err, e)
            say(f"kernel msa_score_segments {tag}, segment {i}: "
                f"{seg[0].shape[0]} jobs (R, C) = ({seg[0].shape[1]}, "
                f"{seg[1].shape[1]}) max_abs_err {e} (against the plain "
                f"version and msa_score on the segment alone)")
            if e:
                raise AssertionError("msa_score_segments disagrees")
    ms, _ = _cuda_ms(lambda: mk.msa_score_segments(segs, S), 10)
    sep_ms = _cuda_ms(lambda: [mk.msa_score(*x, S) for x in segs], 10)[0]
    narrow_ms = _cuda_ms(lambda: mk.msa_score(*narrow, S), 10)[0]
    plain_ms = _cuda_ms(
        lambda: [mk.msa_score_plain(*x, S) for x in segs], 1, warm=False)[0]
    n_bytes = sum(rd.numel() + rf.numel() + 4 * rw.numel() + 12 * len(rw)
                  for rd, rf, rw in segs)
    cells = sum(float(((rw.double() + 1) * (rf.shape[1] + 1)).sum())
                for _, rf, rw in segs)
    bound, by = bound_ms(
        n_bytes, cells * instr["msa_score_segments"]["function_per_cell"],
        clock)
    waves = L + L + 456
    say(f"time msa_score_segments at 32,768 x (150, 174) + 128 x (150, 606):"
        f" merged launch {ms:.3f} ms, the two launches one after the other "
        f"{sep_ms:.3f} ms, the narrow pass alone {narrow_ms:.3f} ms, plain "
        f"{plain_ms:.3f}"
        f" ms, bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f} % of the "
        f"bound reached; {instr['msa_score_segments']['per_cell']:.1f} "
        f"instructions a cell, bound at "
        f"{instr['msa_score_segments']['function_per_cell']:.1f})")
    say(f"clocks a wave of the wide pass ({waves} waves, {clock / 1e6:.0f} "
        f"MHz): one-row launch alone {row_ms * 1e-3 * clock / waves:.1f}, "
        f"merged launch {ms * 1e-3 * clock / waves:.1f} (all of it; the "
        f"narrow jobs share it)")
    return {"msa_score_segments": {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "max_abs_err": err, "separate_ms": sep_ms}}


def fill_walk_phase(genome, device, instr: dict, clock: float) -> dict:
    """The fused fill + walk (``csrc/msa_fill_walk.cu``) on the card. Both
    packings where they hold the job, and the default route, against
    ``msa_fill_walk_plain`` on all five outputs, tolerance 0, at the
    fused program's two launches (``FW_SHAPES``), with walks cut at 120
    steps (``FW_CUT``) and at wide reads (``FW_WIDE``), SHORT and PACBIO
    profiles, a quarter of the jobs with rows below R; then each
    packing's time at both shapes and at ``FW_PACKED`` beside the
    two-kernel route it replaces there (K3 in ``launch_shape``'s mapping
    + the walk kernel) and beside its bound, and the sweep of the
    packings over the job count at both windows (what
    ``fill_walk_shape``'s rule rests on). Returns the ``kernels`` line's
    entries, one a packing, each timed at the first shape whose default
    it is: {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms,
    pair_ms, shape}."""
    from bbmap_tpu_torch.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk

    S = SHORT_PROFILE
    err = dict.fromkeys(mk.FILL_WALK_VARIANTS, 0)

    def max_err(got, want) -> int:
        return max(int((a.long() - b.long()).abs().max())
                   for a, b in zip(got, want))

    def holds(R, C, v) -> bool:
        try:
            return mk.fill_walk_shape(R, C, None, v) is not None
        except ValueError:
            return False

    for (n, R, C, steps), seed in zip((*FW_SHAPES, FW_CUT, *FW_WIDE),
                                      (61, 62, 66, 67, 68)):
        for pname, P in (("short", S), ("pacbio", PACBIO_PROFILE)):
            job = dp_jobs(genome, n, R, C, seed, device)
            want = mk.msa_fill_walk_plain(*job, P, steps)
            cut = int((want[4] > 0).sum())
            if steps == FW_CUT[3] and not cut:
                raise AssertionError(f"no walk was cut at {steps} steps")
            shape = mk.fill_walk_shape(R, C, n)
            forced = [v for v in mk.FILL_WALK_VARIANTS if holds(R, C, v)]
            for v in (*forced, None):
                got = mk.msa_fill_walk(*job, P, steps, v)
                _sync(device)
                e = max_err(got, want)
                name = v or shape.variant
                err[name] = max(err[name], e)
                say(f"kernel {FILL_WALK[name]} {pname}: {n} jobs (R, C) = "
                    f"({R}, {C}), {shape.threads} threads a block, steps "
                    f"{steps or R + C}: max_abs_err {e} (out, symbols, "
                    f"out_len, gaps, row_end; {cut} walks cut"
                    f"{'; the default route' if v is None else ''})")
                if e != 0:
                    raise AssertionError(f"{FILL_WALK[name]} disagrees with "
                                         f"msa_fill_walk_plain")
            del job, want, got

    def two_kernels(rd, rf, rw, steps):
        o, prevs, lay = mk.msa_fill(rd, rf, rw, S)
        return mk.msa_walk(prevs, rd, rf, o[1], o[2], rd.shape[1],
                           rf.shape[1], steps, lay)

    res = {}
    for (n, R, C, steps), seed in zip((*FW_SHAPES, FW_PACKED),
                                      (63, 64, 69)):
        job = rd, rf, rw = dp_jobs(genome, n, R, C, seed, device,
                                   var_rows=False)
        tag = f"{n:,} x ({R}, {C}), {steps or R + C} steps"
        pair = _cuda_ms(lambda: two_kernels(rd, rf, rw, steps), 10)[0]
        plain_ms, want = _cuda_ms(
            lambda: mk.msa_fill_walk_plain(rd, rf, rw, S, steps), 1,
            warm=False)
        cells = float(((rw.double() + 1) * (C + 1)).sum())
        walked = float(want[2].sum())
        n_bytes = rd.numel() + rf.numel() + 4 * n + 12 * n \
            + n * (steps or R + C) + 12 * n
        bound, by = bound_ms(
            n_bytes, cells * instr["msa_fill"]["function_per_cell"]
            + walked * instr["msa_walk"]["function_per_cell"], clock)
        default = mk.fill_walk_shape(R, C, n).variant
        for v in mk.FILL_WALK_VARIANTS:
            ms, got = _cuda_ms(lambda: mk.msa_fill_walk(rd, rf, rw, S, steps,
                                                        v), 10)
            if max_err(got, want):
                raise AssertionError(f"{FILL_WALK[v]} disagrees with "
                                     f"msa_fill_walk_plain ({tag})")
            name = FILL_WALK[v]
            if v == default and name not in res:
                res[name] = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by,
                             "library_ms": None, "pair_ms": pair,
                             "shape": tag, "max_abs_err": err[v]}
            mark = "; the default" if v == default else ""
            say(f"time {name} at {tag}: kernel {ms:.3f} ms, K3 "
                f"({mk.launch_shape(R, C, jobs=n, fill=True).mapping}) + "
                f"walk {pair:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound:.4f} ms by {by} ({100 * bound / ms:.1f} % of the "
                f"bound reached; {instr[name]['per_cell']:.1f} instructions"
                f" a cell in the sweep){mark}")
        del job, want, got
    if set(res) != set(FILL_WALK.values()):
        raise AssertionError(f"a packing is the default at no shape timed: "
                             f"{sorted(res)}")
    for _, R, C, steps in FW_SHAPES:
        big = dp_jobs(genome, max(FW_SWEEP_JOBS), R, C, 65, device,
                      var_rows=False)
        for n in FW_SWEEP_JOBS:
            a = tuple(x[:n] for x in big)
            cols = ["%s %.4f" % (v, _cuda_ms(
                lambda: mk.msa_fill_walk(*a, S, steps, v), 5)[0])
                for v in mk.FILL_WALK_VARIANTS]
            pair = _cuda_ms(lambda: two_kernels(*a, steps), 5)[0]
            say(f"sweep msa_fill_walk {n} x ({R}, {C}), steps "
                f"{steps or R + C}: {', '.join(cols)} ms; K3 + walk "
                f"{pair:.4f} ms; default "
                f"{mk.fill_walk_shape(R, C, n).variant}")
        del big
    return res


def k1_entry(genome, device) -> dict:
    """K1's own entry point, ``score_batch``, on the card at 32,768 jobs
    of (150, 174), counted; held equal to K2 on the same jobs. Returns
    every kernel's launches in that call."""
    from bbmap_tpu_torch.core.constants import SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk
    rd, rf, rw = dp_jobs(genome, K1_JOBS, L, L + 24, 21, device)
    reset_counts()
    got = mk.score_batch(rd, rf, rw, BB=64)
    _sync(device)
    launches = launch_counts()
    n = mk.msa_score_rows.launches
    want = mk.msa_score_plain(rd, rf, rw, SHORT_PROFILE)
    e = max(int((g.long() - w.long()).abs().max())
            for g, w in zip(got, want))
    say(f"K1 entry point score_batch: {K1_JOBS} jobs, launches {n}, "
        f"max_abs_err vs plain {e}")
    if e != 0 or n == 0:
        raise AssertionError("score_batch did not run K1 or disagrees")
    return launches


def grade(aligner, graded, t1, t2, n_pairs: int) -> dict:
    """bench.grade: strict-correct within 20 bp of the sampled origin,
    over both mates; pair rate over mate 1's proper-pair flags."""
    import numpy as np
    n_mapped = n_correct = n_paired = 0
    for b, (mb1, mb2) in graded:
        lo = b * n_pairs
        for mb, truth in ((mb1, t1), (mb2, t2)):
            tr = truth[lo:lo + n_pairs]
            flat = aligner.chrom_offsets[np.maximum(mb.chrom, 1) - 1] \
                + mb.start
            n_mapped += int(mb.mapped.sum())
            n_correct += int((mb.mapped & (np.abs(flat - tr) <= 20)).sum())
        n_paired += int(mb1.paired.sum())
    n_total = 2 * len(graded) * n_pairs
    return {"sensitivity": n_correct / n_total,
            "mapped_fraction": n_mapped / n_total,
            "pair_rate": n_paired / (len(graded) * n_pairs)}


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from bbmap_tpu_torch.align import quickmap_device
    from bbmap_tpu_torch.ops import banded_device, msa_kernels, rescue_device
    msa_kernels.reset_launches()
    banded_device.reset_launches()
    rescue_device.reset_launches()
    quickmap_device.reset_launches()


def launch_counts() -> dict:
    """Each kernel wrapper's launches since the last ``reset_counts``; a
    DP kernel's by mapping as well: "<name>_warp", "<name>_row",
    "<name>_band" and "<name>_strided", the fused fill + walk's by
    variant ("msa_fill_walk_<variant>"), the banded kernel's as
    "banded_edit" and by mapping ("banded_edit_thread",
    "banded_edit_warp"), the block kernel's as "banded_any" and by mode
    ("banded_any_class", "banded_any_triangle"), the containment kernel's
    as "contained_any" and by mapping ("contained_any_thread",
    "contained_any_warp"), the rescue kernel's as "rescue_scan", the
    quality offsets kernel's as "quality_offsets", the key-retention
    kernel's as "ref_retention", the gapless kernel's as "gapless_score",
    the slot pack's as "slot_pack" and the chain step's as
    "chain_candidates"."""
    from bbmap_tpu_torch.align import quickmap_device
    from bbmap_tpu_torch.ops import banded_device, msa_kernels, rescue_device
    out = {k.__name__: k.launches for k in msa_kernels.KERNELS}
    for k in msa_kernels.DP_KERNELS:
        for mapping in msa_kernels.MAPPINGS:
            out[f"{k.__name__}_{mapping}"] = k.launches_by[mapping]
    for v, n in msa_kernels.msa_fill_walk.launches_by.items():
        out[FILL_WALK[v]] = n
    banded = banded_device.banded_edit
    out["banded_edit"] = banded.launches
    for mapping, n in banded.launches_by.items():
        out[f"banded_edit_{mapping}"] = n
    out["banded_any"] = banded_device.banded_any.launches
    for mode, n in banded_device.banded_any.launches_by.items():
        out[f"banded_any_{mode}"] = n
    out["contained_any"] = banded_device.contained_any.launches
    for mapping, n in banded_device.contained_any.launches_by.items():
        out[f"contained_any_{mapping}"] = n
    out["rescue_scan"] = rescue_device.rescue_scan.launches
    out["quality_offsets"] = quickmap_device.quality_offsets_kernel.launches
    out["ref_retention"] = quickmap_device.ref_retention_kernel.launches
    out["gapless_score"] = quickmap_device.gapless_scores_kernel.launches
    out["slot_pack"] = quickmap_device.slot_pack_kernel.launches
    out["chain_candidates"] = quickmap_device.chain_candidates_kernel.launches
    return out


def main_path(device, n_pairs: int = N_PAIRS, n_steady: int = N_STEADY,
              genome_bases=None, check: bool = True):
    """The bench workload through the port's aligner. Returns (summary
    dict, (batch1, batch2, (mb1, mb2), aligner) of the warmup batch)."""
    import numpy as np
    import torch

    from bbmap_tpu_torch import workload
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.core.batch import ReadBatch
    from bbmap_tpu_torch.core.genome import Genome, Scaffold
    from bbmap_tpu_torch.index.build import analyze_index, build_index

    t0 = time.time()
    gbases = workload.make_genome() if genome_bases is None \
        else genome_bases
    g = Genome(chroms=[gbases], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(gbases),
                 name="ecoli_like")]).finalize()
    index = build_index(g, 13)
    analyze_index(index, 0.01)
    aligner = BBMapAligner(g, index, device)
    n_batches = 1 + n_steady
    r1, r2, q1, q2, t1, t2 = workload.make_pairs(
        gbases, n_pairs * n_batches, L=L, seed=11, with_quality=True)
    say(f"setup: genome {len(gbases)} bp, index k=13, "
        f"{n_batches} x {n_pairs} pairs: {time.time() - t0:.1f} s")

    def mk(rows, quals, b):
        lo = b * n_pairs
        return ReadBatch(
            bases=rows[lo:lo + n_pairs], quality=quals[lo:lo + n_pairs],
            lengths=np.full(n_pairs, L, np.int32),
            ids=[str(i) for i in range(lo, lo + n_pairs)],
            numeric_ids=np.arange(lo, lo + n_pairs, dtype=np.int64))

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tw = time.time()
    out0 = aligner.map_pairs_columnar(mk(r1, q1, 0), mk(r2, q2, 0))
    warm_s = time.time() - tw
    say(f"warmup batch: {warm_s:.2f} s")
    ts = time.time()
    outs = list(aligner.map_pairs_columnar_stream(
        (mk(r1, q1, b), mk(r2, q2, b)) for b in range(1, n_batches)))
    _sync(device)
    dt = time.time() - ts
    launches = launch_counts()
    res = grade(aligner, [(0, out0)] + [(b + 1, o)
                                        for b, o in enumerate(outs)],
                t1, t2, n_pairs)
    res["reads_per_s"] = 2 * n_steady * n_pairs / dt
    res["steady_s"] = dt
    res["warmup_s"] = warm_s
    res["launches"] = launches
    res["max_memory_allocated"] = \
        torch.cuda.max_memory_allocated() if on_card else None
    res["n_esc_rows"] = aligner._n_esc_rows
    res["n_fallback_rows"] = aligner._n_fallback_rows

    # per-stage decomposition on one more batch, stage by stage
    b1x, b2x = mk(r1, q1, 1), mk(r2, q2, 1)
    stages = {}
    st = time.time()
    f = aligner._fused_pair_dispatch(b1x, b2x, L)
    _sync(device)
    stages["fused_device_ms"] = 1e3 * (time.time() - st)
    st = time.time()
    dd = f.host()
    stages["fetch_ms"] = 1e3 * (time.time() - st)
    st = time.time()
    mid = aligner._pair_phase1(b1x, b2x, L, dd)
    _sync(device)
    stages["host_assemble_ms"] = 1e3 * (time.time() - st)
    st = time.time()
    aligner._pair_phase2(mid)
    _sync(device)
    stages["rescue_ms"] = 1e3 * (time.time() - st)
    res["stages"] = stages
    say("main path: " + json.dumps({k: v for k, v in res.items()}))
    if check:
        if res["sensitivity"] < SENS_MIN or \
                res["mapped_fraction"] < MAPPED_MIN or \
                res["pair_rate"] < PAIR_MIN:
            raise AssertionError(
                f"accuracy below the bar (sensitivity >= {SENS_MIN}, "
                f"mapped >= {MAPPED_MIN}, pair rate >= {PAIR_MIN})")
        if not (launches["msa_score_segments"]
                and launches["msa_fill_walk"]):
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        # the fused program runs once a batch and scores its narrow and
        # wide passes in one launch
        if launches["msa_score_segments"] != n_batches:
            raise AssertionError(f"{launches['msa_score_segments']} merged "
                                 f"score launches for {n_batches} batches")
        if launches["msa_fill"] or launches["msa_walk"]:
            raise AssertionError(f"a short fill or walk left the fused "
                                 f"kernel: {launches}")
        # every quality-offsets call goes through its kernel, and the mate
        # rescue scans a batch's jobs in one launch
        if not (launches["quality_offsets"] and launches["rescue_scan"]):
            raise AssertionError(f"the quality offsets or the rescue "
                                 f"kernel never launched: {launches}")
        if launches["rescue_scan"] > n_batches:
            raise AssertionError(f"{launches['rescue_scan']} rescue "
                                 f"launches for {n_batches} batches")
        # the candidate stage's key retention, slot pack and chain step
        # and the finalize stage's gapless score: one launch a call, at
        # least one a batch
        low = [n for n in ("ref_retention", "slot_pack", "chain_candidates",
                           "gapless_score") if launches[n] < n_batches]
        if low:
            raise AssertionError(f"{', '.join(low)} launched less than once "
                                 f"a batch: {launches}")
    return res, (mk(r1, q1, 0), mk(r2, q2, 0), out0, aligner)


@contextlib.contextmanager
def first_call(module, name: str):
    """Record the arguments of the first call of ``module.<name>`` while
    inside (a list that gets one (args, kwargs) pair). The recording
    wrapper shares the function's attributes, its launch count among
    them."""
    orig = getattr(module, name)
    calls = []

    def rec(*args, **kw):
        if not calls:
            calls.append((args, kw))
        return orig(*args, **kw)

    rec.__dict__ = orig.__dict__
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


N_OFF = 1536                  # the rescue scan's offsets (pipeline's)
RESCUE_EDGE_JOBS = 1024
QUALITY_LONG = (32, L_LONG, 12)   # reads, length, k of the long path
PACBIO_Q = (28, 35)           # randomreads' quality range (minq, maxq)
# the rescue edge genome's repeat and N runs (rescue_edge_index)
REPEAT_AT, N_RUNS = 100_000, (40_000, 120_000, 180_000)


def rescue_edge_jobs(codes, R: int, Lm: int, seed: int):
    """R seeded rescue jobs on a genome's codes (0..3, 4 = N): both scan
    directions; n = 1, 2, random and N_OFF; max_mm -1, 0 and up to 20;
    reads with substitutions and N bases; windows over N runs, past the
    genome's end and before its start; ideal starts between two copies of
    a repeat (ties in score and absdif). Returns the numpy arguments of
    ``rescue_device.upload_jobs``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    G = len(codes)
    reads = np.empty((R, Lm), np.uint8)
    lo, n, ik, mm = (np.empty(R, np.int64) for _ in range(4))
    right = rng.random(R) < 0.5
    kinds = rng.integers(0, 6, R)
    for t in range(R):
        n_t = int(rng.choice([1, 2, N_OFF, int(rng.integers(3, N_OFF))]))
        if kinds[t] == 0:                      # near the genome's end
            src = G - Lm - int(rng.integers(0, 40))
        elif kinds[t] == 1:                    # near its start
            src = int(rng.integers(0, 40))
        elif kinds[t] == 2:                    # on the repeat
            src = int(rng.integers(REPEAT_AT, REPEAT_AT + 1600 - Lm))
        elif kinds[t] == 3:                    # over an N run
            src = int(rng.choice(N_RUNS)) - int(rng.integers(0, Lm))
        else:
            src = int(rng.integers(0, G - Lm))
        read = codes[src:src + Lm].copy()
        for _ in range(int(rng.integers(0, 4))):
            read[rng.integers(0, Lm)] = rng.integers(0, 4)
        if rng.random() < 0.2:
            read[rng.integers(0, Lm, 2)] = 4
        off = int(rng.integers(0, n_t))
        lo[t] = src - off if right[t] else src + off - (n_t - 1)
        ik[t] = src - lo[t] + int(rng.choice([0, 0, 8, -8, 3]))
        n[t] = n_t
        mm[t] = int(rng.choice([-1, 0, 3, 20]))
        reads[t] = read
    return (reads, lo.astype(np.int32), n.astype(np.int32),
            ik.astype(np.int32), right, mm.astype(np.int32))



def rescue_edge_index(device):
    """A 200 kbp genome with N runs (``N_RUNS``) and a period-16 repeat
    of 1,600 bp at ``REPEAT_AT``, indexed (k = 13) on the card."""
    import numpy as np
    from bbmap_tpu_torch.align.quickmap_device import DeviceIndex
    from bbmap_tpu_torch.core.genome import Genome, Scaffold
    from bbmap_tpu_torch.index.build import build_index
    rng = np.random.default_rng(29)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(acgt, 200_000).astype(np.uint8)
    for at in N_RUNS:
        g[at:at + 30] = ord("N")
    g[REPEAT_AT:REPEAT_AT + 1600] = np.tile(rng.choice(acgt, 16), 100)
    genome = Genome(chroms=[g], scaffolds=[Scaffold(
        chrom=1, sid=1, start=0, length=len(g), name="edges")]).finalize()
    return DeviceIndex(build_index(genome, 13), device)


def _rescue_bound(dix, n, Lm: int, clock: float):
    """The rescue scan's bound for jobs of n offsets: the window codes it
    must read (2-bit words, and the N mask's where the genome has N), the
    reads, job arrays and outputs once; n x Lm compares and n walk steps
    a job."""
    import numpy as np
    used = np.clip(n.astype(np.int64), 0, N_OFF)
    span = np.where(used > 0, used + Lm - 1, 0)
    words = (-(-span // 16)).sum() * 8
    if dix.has_n:
        words += (-(-span // 32)).sum() * 8
    R = len(n)
    return bound_ms(words + R * Lm + 17 * R + 8 * R,
                    float((used * Lm + used).sum()), clock)


def _quality_bound(B: int, L: int, k: int, nk: int, clock: float):
    """The quality offsets' bound: q and pc read once (8 B a base), the
    offsets, weights and flags written once; B x m x k multiplies and nk
    ladder steps a read."""
    m = L - k + 1
    return bound_ms(8 * B * L + 8 * B * nk + B, float(B * (m * k + nk)),
                    clock)


def rescue_quality_phase(device, rescue_call, quality_call,
                         clock: float) -> dict:
    """The rescue kernel and the quality offsets kernel against their
    plain versions on the card, tolerance 0: the rescue scan on the main
    path's warmup jobs (``rescue_call``, its first call's arguments) and on
    ``RESCUE_EDGE_JOBS`` edge jobs on a genome with N runs; the quality
    offsets on the warmup batch's 65,536 x 150 (``quality_call``, the
    fused program's palette route) and on 32 reads of 6 kbp with the
    quality randomreads gives PacBio reads (raw route, the long path's
    shape). Each timed beside its plain version and its bound. Returns
    the ``kernels`` line's entries of both kernels."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.align import quickmap_device as qd
    from bbmap_tpu_torch.align import seed
    from bbmap_tpu_torch.ops import rescue_device as rd

    out = {}
    (dix, reads, lo, n, ik, rt, mm, Lm, n_off), _ = rescue_call
    if n_off != N_OFF:
        raise AssertionError(f"the main path's rescue scans {n_off} offsets")

    def rescue_err(args):
        got = rd.rescue_scan(*args)
        d, rr = args[0], args[1]
        want = rd._rescue_stage(d, rr, rr > 3, *args[2:])
        _sync(device)
        return max(_diff(got[0], want[0]), _diff(got[1], want[1])), got

    args = (dix, reads, lo, n, ik, rt, mm, Lm, N_OFF)
    e_main, got = rescue_err(args)
    ms, _ = _cuda_ms(lambda: rd.rescue_scan(*args), 20)
    plain_ms, _ = _cuda_ms(
        lambda: rd._rescue_stage(dix, reads, reads > 3, lo, n, ik, rt, mm,
                                 Lm, N_OFF), 1, warm=False)
    b_ms, b_by = _rescue_bound(dix, n.cpu().numpy(), Lm, clock)
    found = int((got[0] >= 0).sum())
    edix = rescue_edge_index(device)
    edge = rd.upload_jobs(*rescue_edge_jobs(
        edix.index.genome_codes, RESCUE_EDGE_JOBS, Lm, 31), device)
    e_edge, got_e = rescue_err((edix, *edge, Lm, N_OFF))
    say(f"kernel rescue_scan: the warmup batch's {len(n)} jobs (Lm {Lm}, "
        f"N_OFF {N_OFF}, {found} found) max_abs_err {e_main}, {ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by {b_by}); "
        f"{RESCUE_EDGE_JOBS} edge jobs max_abs_err {e_edge} "
        f"({int((got_e[0] >= 0).sum())} found)")
    out["rescue_scan"] = {
        "max_abs_err": max(e_main, e_edge), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"jobs": len(n), "Lm": Lm, "N_OFF": N_OFF,
                  "found": found},
        "edge_jobs": RESCUE_EDGE_JOBS, "max_abs_err_edge": e_edge}

    def quality_err(args):
        got = qd.quality_offsets_kernel(*args)
        want = qd._quality_offsets_core(*args, True)
        _sync(device)
        return max(float(_diff(got[0], want[0])),
                   float((got[1] - want[1]).abs().max()),
                   float(_diff(got[2], want[2])))

    (cfg, q, pc, den2, den3), _ = quality_call
    shapes = {}
    B, L_q = q.shape
    if (B, L_q) != (2 * N_PAIRS, L):
        raise AssertionError(f"the main path's quality offsets ran at "
                             f"{(B, L_q)}")
    rng = np.random.default_rng(37)
    nl, ll, kl = QUALITY_LONG
    cfg_l = qd.QmConfig(k=kl, L=ll, S=2, chain_dist=400, min_score=0,
                        offsets_list=tuple(int(o) for o in
                                           seed.make_offsets(ll, kl)), G=0)
    ql = torch.as_tensor(rng.integers(PACBIO_Q[0], PACBIO_Q[1] + 1, (nl, ll)),
                         dtype=torch.int32, device=device)
    pcl = torch.as_tensor(seed.PROB_CORRECT, device=device)[ql.long()]
    cases = (("main", (cfg, q, pc, den2, den3), 3),
             ("long", (cfg_l, ql, pcl, *seed.key_density_ladder(ll, kl)), 1))
    for tag, qargs, plain_reps in cases:
        err = quality_err(qargs)
        ms, _ = _cuda_ms(lambda: qd.quality_offsets_kernel(*qargs), 20)
        plain_ms, _ = _cuda_ms(
            lambda: qd._quality_offsets_core(*qargs, True), plain_reps,
            warm=False)
        c, qq = qargs[0], qargs[1]
        nk = len(c.offsets_list)
        b_ms, b_by = _quality_bound(qq.shape[0], c.L, c.k, nk, clock)
        shapes[tag] = {"reads": qq.shape[0], "L": c.L, "k": c.k, "nk": nk,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        say(f"kernel quality_offsets at {qq.shape[0]} x {c.L} (k {c.k}, nk "
            f"{nk}): max_abs_err {err}, {ms:.4f} ms (plain {plain_ms:.3f} "
            f"ms, bound {b_ms:.6f} ms by {b_by})")
    m = shapes["main"]
    out["quality_offsets"] = {
        "max_abs_err": max(s_["max_abs_err"] for s_ in shapes.values()),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None, "shapes": shapes}
    if any(v["max_abs_err"] != 0 for v in out.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{out}")
    return out


RETENTION_LONG_READS = 32      # the long path's first call, cut to these
RETENTION_MAX_LENS = (4000, 100)   # crafted counts' maxLen: trimmed, kept
RETENTION_CRAFTED_ROWS = 4096  # rows crafted, then tiled to the shape


def crafted_counts(rng, B: int, nk: int, max_len: int, offsets):
    """Key counts that reach every re-admission tier and the trim's
    branches (``tests/retention_counts.crafted``, the retention kernel's
    CPU tests' generator) for B reads: at most ``RETENTION_CRAFTED_ROWS``
    rows crafted, tiled to B. Returns kp, off, ccnt (B, nk) int32 numpy."""
    import numpy as np
    from tests.retention_counts import crafted
    n = min(B, RETENTION_CRAFTED_ROWS)
    reps = -(-B // n)
    return tuple(np.ascontiguousarray(np.tile(a, (reps, 1))[:B], np.int32)
                 for a in crafted(rng, n, nk, max_len, offsets))


def gapless_table(codes, B: int, L: int, rng):
    """B reads from a genome's codes (4 = N) with 3 % substitutions, half
    of them reverse-complemented, and a candidate table of 8 a read: the
    true diagonal and shifted ones on random strands, one off the genome's
    start, one past its end, one anywhere. Returns (reads (B, L) uint8,
    mode, strand (B, 8) int32) numpy."""
    import numpy as np
    G = len(codes)
    src = rng.integers(0, G - L, B)
    reads = np.minimum(codes[src[:, None] + np.arange(L)], 4).astype(np.uint8)
    sub = rng.random((B, L)) < 0.03
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    minus = rng.random(B) < 0.5
    reads[minus] = np.where(reads[minus] <= 3, 3 - reads[minus],
                            reads[minus])[:, ::-1]
    mode = src[:, None] + rng.integers(-3, 4, (B, 8))
    mode[:, 0] = src
    mode[:, 2] = -rng.integers(1, L, B)
    mode[:, 3] = G - rng.integers(1, L, B)
    mode[:, 4] = rng.integers(-2 * L, G + L, B)
    strand = np.where(rng.random((B, 8)) < 0.5, 1, 0)
    strand[:, 0] = minus
    return reads, mode.astype(np.int32), strand.astype(np.int32)


def _retention_bound(kp, weights, clock: float):
    """The key retention's bound: keys, offsets, counts (and weights) read
    once, 4 B each, the flags written; one operation a key."""
    B, nk = kp.shape
    n_bytes = B * nk * (12 + (4 if weights is not None else 0) + 1)
    return bound_ms(n_bytes, float(B * nk), clock)


def _words_read(mode, L: int, G: int, per: int, n_words: int) -> int:
    """The distinct words of ``per`` bases that hold a genome position of
    some candidate's window [mode, mode + L) (positions off the genome
    are in no word)."""
    import torch
    m = mode.reshape(-1).to(torch.int64)
    lo, hi = m.clamp(0, G), (m + L).clamp(0, G)
    keep = hi > lo
    first, last = lo[keep] // per, (hi[keep] - 1) // per
    one = torch.ones_like(first, dtype=torch.int32)
    d = torch.zeros(n_words + 1, dtype=torch.int32, device=mode.device)
    d.index_add_(0, first, one)
    d.index_add_(0, last + 1, -one)
    return int((d.cumsum(0)[:n_words] > 0).sum())


def _gapless_bound(mode, L: int, dindex, cfg, clock: float):
    """The gapless score's bound: the read codes (1 B a base), the
    candidates' modes and strands and the scores (12 B a candidate) once,
    and each genome word under some candidate's window once (16 bases a
    word, and 32 a word of the N mask where the genome has N, at the
    index's bytes a word); one operation a position."""
    B, K = mode.shape
    n_bytes = B * L + 12 * B * K + dindex.gpack.element_size() * _words_read(
        mode, L, cfg.G, 16, dindex.gpack.shape[0])
    if cfg.has_n:
        n_bytes += dindex.nmask.element_size() * _words_read(
            mode, L, cfg.G, 32, dindex.nmask.shape[0])
    return bound_ms(n_bytes, float(B * K * L), clock)


def _slot_pack_bound(gadm, W: int, clock: float):
    """The slot pack's bound: its (rows, nk) inputs read once (four int32
    and a flag: 17 B a key) and its (rows, W) outputs written once (the
    int64 gather index, two int32 and a flag: 17 B a slot) with the row
    totals; one operation a key for each compare-exchange of a sort of
    its row (nk log2 nk) and for each of its two scans, and one a slot
    for each step of its search (log2 nk)."""
    B, two, nk = gadm.shape
    rows, lg = B * two, max(1, (nk - 1).bit_length())
    return bound_ms(rows * (17 * nk + 17 * W + 4),
                    float(rows * (nk * lg + 2 * nk + W * lg)), clock)


def _chain_bound(diag, K: int, clock: float):
    """The chain step's bound: the diagonals and key slots read once (8 B
    a slot) and the (B, K) table written once (five int32); one operation
    a slot for each compare-exchange of a sort of its row (W log2 W), for
    each of the chain segmentation's 12 scans and for the top K's pass
    over the read."""
    B, two, W = diag.shape
    slots = B * two * W
    return bound_ms(8 * slots + 20 * B * K,
                    float(slots * (max(1, (W - 1).bit_length()) + 13)),
                    clock)


def retention_gapless_phase(device, main_calls: dict, long_calls: dict,
                            clock: float) -> dict:
    """The key-retention kernel (``ref_retention_kernel``) and the gapless
    streak-score kernel (``gapless_scores_kernel``) against their plain
    versions on the card, tolerance 0, on their first calls on the main
    path (the warmup batch's fused program: 65,536 reads, 18 keys with
    quality weights; 65,536 x 8 candidates of 150 bp) and on the long
    path's first calls cut to ``RETENTION_LONG_READS`` reads (6,000 bp,
    750 keys with weights; 8 candidates). Each timed beside its plain
    version and its bound; the plain versions at the main path's shapes
    give the split of the eager scans these kernels replaced. Then the
    retention kernel on counts crafted across
    the tiers and the trim's branches (``crafted_counts``) at both shapes,
    and the gapless kernel on a genome with N runs at the main path's
    shape. At the main path's shape, torch.profiler counts the scalar
    reads of a device value in one call of the retention kernel (it must
    make none) and of the plain trim (it must make one at least, or the
    counter reads nothing). Returns the ``kernels`` line's entries of both
    kernels and the chain segmentation's timing."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.align import quickmap_device as qd

    def cut(a, n):
        return a[:n] if isinstance(a, torch.Tensor) else a

    out = {"ref_retention": {"shapes": {}}, "gapless_score": {"shapes": {}}}
    for tag, calls in (("main", main_calls), ("long", long_calls)):
        n = None if tag == "main" else RETENTION_LONG_READS
        (args, kw), = calls["ref_retention_kernel"]
        cfg, kp, off_p, ccnt = (cut(a, n) for a in args)
        w = cut(kw.get("weights"), n)
        if tag == "long" and (cfg.L, kp.shape[1]) != (L_LONG, 750):
            raise AssertionError(f"the long path's retention ran at L "
                                 f"{cfg.L} with {kp.shape[1]} keys")
        got = qd.ref_retention_kernel(cfg, kp, off_p, ccnt, w)
        want = qd._ref_retention(cfg, kp, off_p, ccnt, w)
        _sync(device)
        err = _diff(got.int(), want.int())
        ms, _ = _cuda_ms(lambda: qd.ref_retention_kernel(cfg, kp, off_p,
                                                         ccnt, w), 20)
        plain_ms, _ = _cuda_ms(lambda: qd._ref_retention(cfg, kp, off_p,
                                                         ccnt, w),
                               3 if tag == "main" else 1, warm=False)
        b_ms, b_by = _retention_bound(kp, w, clock)
        out["ref_retention"]["shapes"][tag] = {
            "reads": kp.shape[0], "L": cfg.L, "nk": kp.shape[1],
            "weights": w is not None, "kept": int(got.sum()),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}
        say(f"kernel ref_retention at {kp.shape[0]} x {kp.shape[1]} keys (L "
            f"{cfg.L}, weights {w is not None}): max_abs_err {err}, "
            f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by "
            f"{b_by})")
        if tag == "main":
            reads = {name: _device_profile(
                fn, f"{name} at {kp.shape[0]} x {kp.shape[1]} keys", t,
                top=0)["scalar_reads"] for name, fn, t in (
                    ("ref_retention_kernel", lambda: qd.ref_retention_kernel(
                        cfg, kp, off_p, ccnt, w), ms),
                    ("_ref_retention", lambda: qd._ref_retention(
                        cfg, kp, off_p, ccnt, w), plain_ms))}
            out["ref_retention"]["scalar_reads"] = reads
            if reads["ref_retention_kernel"] != 0 \
                    or reads["_ref_retention"] < 1:
                raise AssertionError(f"scalar reads of a device value: "
                                     f"{reads} (the kernel must make none, "
                                     f"the plain trim one a round)")

        (args, _kw), = calls["gapless_scores_kernel"]
        cfg, rcodes, mode, strand, dix = (cut(a, n) for a in args)
        got = qd.gapless_scores_kernel(cfg, rcodes, mode, strand, dix)
        want = qd._gapless_scores_plain(cfg, rcodes, mode, strand, dix)
        _sync(device)
        err = _diff(got, want)
        ms, _ = _cuda_ms(lambda: qd.gapless_scores_kernel(
            cfg, rcodes, mode, strand, dix), 20)
        plain_ms, _ = _cuda_ms(lambda: qd._gapless_scores_plain(
            cfg, rcodes, mode, strand, dix), 3, warm=False)
        B, K = mode.shape
        b_ms, b_by = _gapless_bound(mode, cfg.L, dix, cfg, clock)
        out["gapless_score"]["shapes"][tag] = {
            "reads": B, "candidates": K, "L": cfg.L, "has_n": cfg.has_n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}
        say(f"kernel gapless_score at {B} x {K} x {cfg.L} (has_n "
            f"{cfg.has_n}): max_abs_err {err}, {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms by {b_by})")
    # crafted counts at both shapes (many more trim rounds than the paths'
    # reads give) and the gapless score on a genome with N runs at the
    # main path's shape (the bench genome has none)
    rng = np.random.default_rng(41)
    for tag, calls in (("main", main_calls), ("long", long_calls)):
        (args, _kw), = calls["ref_retention_kernel"]
        cfg = args[0]
        B = 2 * N_PAIRS if tag == "main" else RETENTION_LONG_READS
        nk = len(cfg.offsets_list)
        for max_len in RETENTION_MAX_LENS:
            c = cfg._replace(max_usable_length=max_len)
            kp, off_p, ccnt = (torch.as_tensor(a, device=device) for a in
                               crafted_counts(rng, B, nk, max_len,
                                              cfg.offsets_list))
            w = torch.as_tensor(rng.uniform(0.2, 1.0, (B, nk)),
                                dtype=torch.float32, device=device)
            got = qd.ref_retention_kernel(c, kp, off_p, ccnt, w)
            want = qd._ref_retention(c, kp, off_p, ccnt, w)
            _sync(device)
            err = _diff(got.int(), want.int())
            ms, _ = _cuda_ms(lambda: qd.ref_retention_kernel(
                c, kp, off_p, ccnt, w), 5)
            key = f"{tag}_crafted_{max_len}"
            out["ref_retention"]["shapes"][key] = {
                "reads": B, "nk": nk, "max_len": max_len,
                "max_abs_err": err, "ms": ms}
            say(f"kernel ref_retention on crafted counts at {B} x {nk} keys "
                f"(maxLen {max_len}, weights): max_abs_err {err}, {ms:.4f} "
                f"ms")
    edix = rescue_edge_index(device)
    ecfg = qd.make_config(edix, L)
    reads, mode, strand = (torch.as_tensor(a, device=device) for a in
                           gapless_table(edix.index.genome_codes, 2 * N_PAIRS,
                                         L, rng))
    got = qd.gapless_scores_kernel(ecfg, reads, mode, strand, edix)
    want = qd._gapless_scores_plain(ecfg, reads, mode, strand, edix)
    _sync(device)
    err = _diff(got, want)
    ms, _ = _cuda_ms(lambda: qd.gapless_scores_kernel(
        ecfg, reads, mode, strand, edix), 20)
    out["gapless_score"]["shapes"]["main_with_n"] = {
        "reads": 2 * N_PAIRS, "candidates": 8, "L": L,
        "has_n": ecfg.has_n, "max_abs_err": err, "ms": ms}
    say(f"kernel gapless_score at {2 * N_PAIRS} x 8 x {L} on a genome with N "
        f"runs (has_n {ecfg.has_n}): max_abs_err {err}, {ms:.4f} ms")
    for name in ("ref_retention", "gapless_score"):
        e = out[name]
        m = e["shapes"]["main"]
        e.update(max_abs_err=max(v["max_abs_err"]
                                 for v in e["shapes"].values()),
                 ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                 bound_by=m["bound_by"], library_ms=None)
    if any(out[k]["max_abs_err"] != 0 for k in ("ref_retention",
                                                "gapless_score")):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{out}")
    return out


CANDIDATE_CRAFTED_READS = 2048   # crafted reads, then tiled to the shape


def _tiled(arrays, B: int, device):
    """numpy arrays of (n, ...) tiled along the first axis to B rows, on
    ``device``."""
    import torch
    return [torch.as_tensor(a, device=device).repeat(
        -(-B // a.shape[0]), *(1,) * (a.ndim - 1))[:B] for a in arrays]


def candidate_kernels_phase(device, main_calls: dict, long_calls: dict,
                            clock: float) -> dict:
    """The candidate stage's slot pack (``slot_pack_kernel``) and chain
    step (``chain_candidates_kernel``) against their plain versions
    (``_slot_pack_plain``, ``_chain_candidates_plain``) on the card,
    tolerance 0 on every output, on their first calls on the main path
    (the warmup batch's fused program: 65,536 reads, 2 x 18 keys, W 64)
    and on the long path's first calls cut to ``RETENTION_LONG_READS``
    reads (2 x 750 keys, W 512), each timed beside its plain version and
    its bound; then on rows crafted for their edges
    (``tests/candidate_rows``: ``slot_rows``, ``chain_rows``) at both
    shapes. At the main path's shape, torch.profiler counts the scans
    (``aten::cummax`` / ``cummin`` / ``cumsum``) and the scalar reads of a
    device value in one call of each kernel (none of either) and of each
    plain version (the plain chain step's 10 scans at least: the
    counter's check). Returns the ``kernels`` line's entries of both."""
    import numpy as np
    from bbmap_tpu_torch.align import quickmap_device as qd
    from tests.candidate_rows import chain_rows, slot_rows

    def cut(a, n):
        return a[:n] if hasattr(a, "shape") else a

    def outputs(x):
        return list(x.values()) if isinstance(x, dict) else list(x)

    def held(kernel, plain, args):
        got, want = outputs(kernel(*args)), outputs(plain(*args))
        _sync(device)
        return max(_diff(g, w) + int(g.dtype != w.dtype)
                   for g, w in zip(got, want))

    K = qd.MAX_CANDIDATES
    names = {"slot_pack": ("slot_pack_kernel", qd.slot_pack_kernel,
                           qd._slot_pack_plain),
             "chain_candidates": ("chain_candidates_kernel",
                                  qd.chain_candidates_kernel,
                                  qd._chain_candidates_plain)}
    out = {name: {"shapes": {}} for name in names}
    for tag, calls in (("main", main_calls), ("long", long_calls)):
        n = None if tag == "main" else RETENTION_LONG_READS
        for name, (rec, kernel, plain) in names.items():
            (args, _kw), = calls[rec]
            args = [cut(a, n) for a in args]
            cfg, x = args[0], args[1]
            if tag == "long" and cfg.L != L_LONG:
                raise AssertionError(f"the long path's {name} ran at L "
                                     f"{cfg.L}")
            err = held(kernel, plain, args)
            ms, _ = _cuda_ms(lambda: kernel(*args), 20)
            plain_ms, _ = _cuda_ms(lambda: plain(*args), 3, warm=False)
            if name == "slot_pack":
                b_ms, b_by = _slot_pack_bound(x, cfg.slot_budget, clock)
                shape = {"reads": x.shape[0], "nk": x.shape[2],
                         "W": cfg.slot_budget}
            else:
                b_ms, b_by = _chain_bound(x, K, clock)
                shape = {"reads": x.shape[0], "W": x.shape[2]}
            out[name]["shapes"][tag] = {
                **shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            say(f"kernel {name} at {shape}: max_abs_err {err}, {ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by {b_by})")
            if tag == "main":
                counts = {f: _device_profile(
                    lambda f=f: f(*args), f"{f.__name__} at {shape}", t,
                    top=0) for f, t in ((kernel, ms), (plain, plain_ms))}
                seen = {f.__name__: {k: c[k] for k in ("scans",
                                                        "scalar_reads")}
                        for f, c in counts.items()}
                out[name]["profile"] = seen
                if any(seen[kernel.__name__].values()) or (
                        name == "chain_candidates"
                        and seen[plain.__name__]["scans"] < 10):
                    raise AssertionError(f"{name}: scans or scalar reads "
                                         f"{seen} (the kernel must make "
                                         f"none, the plain chain step 10 "
                                         f"scans at least)")
    rng = np.random.default_rng(43)
    for tag, calls in (("main", main_calls), ("long", long_calls)):
        (args, _kw), = calls["slot_pack_kernel"]
        cfg = args[0]
        B = args[1].shape[0] if tag == "main" else RETENTION_LONG_READS
        W, nk = cfg.slot_budget, len(cfg.offsets_list)
        n_sites = int(args[6])
        m = min(B, CANDIDATE_CRAFTED_READS)
        sargs = [cfg, *_tiled(slot_rows(rng, m, nk, W, n_sites), B, device),
                 n_sites]
        cargs = [cfg, *_tiled(chain_rows(rng, m, W, nk, cfg.chain_dist), B,
                              device)]
        for name, a in (("slot_pack", sargs), ("chain_candidates", cargs)):
            _rec, kernel, plain = names[name]
            err = held(kernel, plain, a)
            ms, _ = _cuda_ms(lambda: kernel(*a), 5)
            out[name]["shapes"][f"{tag}_crafted"] = {
                "reads": B, "W": W, "nk": nk, "max_abs_err": err, "ms": ms}
            say(f"kernel {name} on crafted rows at {B} reads, W {W}, {nk} "
                f"keys: max_abs_err {err}, {ms:.4f} ms")
    for name, e in out.items():
        m = e["shapes"]["main"]
        e.update(max_abs_err=max(v["max_abs_err"]
                                 for v in e["shapes"].values()),
                 ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                 bound_by=m["bound_by"], library_ms=None)
    if any(e["max_abs_err"] != 0 for e in out.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{out}")
    return out


def sam_phase(first, n: int = 1000) -> int:
    """emit_sam on the first n pairs; every line has >= 11 fields and
    flags 99/147 appear. Returns the number of lines."""
    import numpy as np
    from bbmap_tpu_torch.align.pipeline import MappedRead, emit_sam
    from bbmap_tpu_torch.core.batch import ReadBatch
    b1, b2, (mb1, mb2), aligner = first

    def sub(b):
        return ReadBatch(bases=b.bases[:n], quality=b.quality[:n],
                         lengths=b.lengths[:n], ids=b.ids[:n],
                         numeric_ids=np.arange(n, dtype=np.int64))
    res1 = [MappedRead() for _ in range(mb1.size)]
    res2 = [MappedRead() for _ in range(mb2.size)]
    mb1.fill_objects(res1)
    mb2.fill_objects(res2)
    lines = emit_sam(aligner.genome, sub(b1), res1[:n], res2[:n], sub(b2))
    flags = set()
    for ln in lines:
        f = ln.split("\t")
        if len(f) < 11:
            raise AssertionError(f"SAM line with {len(f)} fields: {ln!r}")
        flags.add(int(f[1]))
    if not {99, 147} <= flags:
        raise AssertionError(f"flags 99/147 missing: {sorted(flags)[:20]}")
    return len(lines)


def selftest_phase(device, cases) -> dict:
    """``msa_selftest.kernel_selftest`` on the card over ``cases`` (the
    oracle's answers, computed beside the build): K2, K3 and the fused
    fill + walk on 128 cases a profile, SHORT and PACBIO; fails on False,
    or when a kernel of the three did not launch."""
    from bbmap_tpu_torch.ops import msa_selftest
    msgs = []
    reset_counts()
    t = time.time()
    ok = msa_selftest.kernel_selftest(device=device, cases=cases,
                                      verbose=msgs.append)
    _sync(device)
    wall = time.time() - t
    launches = {k: v for k, v in launch_counts().items() if v}
    if not ok:
        raise AssertionError("kernel selftest: " + "; ".join(msgs))
    if torch_cuda(device) and not all(
            launches.get(k) for k in ("msa_score", "msa_fill",
                                      "msa_fill_walk")):
        raise AssertionError(f"kernel selftest: K2, K3 or the fused fill + "
                             f"walk never launched: {launches}")
    return {"ok": ok, "cases": sum(len(c[1]) for c in cases),
            "profiles": [c[0] for c in cases], "wall_s": wall,
            "launches": launches}


# the index build phase: the bench genome and one of the same length with
# INDEX_N_FRACTION N bases across two chroms, k = 13
INDEX_K, INDEX_N_FRACTION, INDEX_DEVICE_REPS = 13, 0.001, 3


def index_genomes(gbases) -> dict:
    """name -> Genome: the main path's genome (one chrom), and the same
    bases as two chroms of half the length each with INDEX_N_FRACTION of
    the bases N (seeded), where every window over an N takes the
    sentinel key."""
    import numpy as np
    from bbmap_tpu_torch.core.genome import Genome, Scaffold
    half = len(gbases) // 2
    rng = np.random.default_rng(71)
    withn = gbases.copy()
    withn[rng.choice(len(gbases), int(len(gbases) * INDEX_N_FRACTION),
                     replace=False)] = ord("N")
    out = {"bench": Genome(chroms=[gbases], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(gbases),
                 name="ecoli_like")]).finalize()}
    chroms = [withn[:half].copy(), withn[half:].copy()]
    out["with_n"] = Genome(chroms=chroms, scaffolds=[
        Scaffold(chrom=i + 1, sid=i + 1, start=0, length=len(c),
                 name=f"part{i}") for i, c in enumerate(chroms)]).finalize()
    return out


def index_build_phase(device, gbases, first, smi: str) -> dict:
    """``index/build_device.build_index_device`` on the card against the
    host ``build_index`` on ``index_genomes``: ``starts`` and ``sites``
    equal (dtypes too), the host build timed, the device build timed cold
    and warm (its whole call, and the device CSR alone between CUDA
    events) with its peak memory, and its bound (the packed genome read
    once, ``starts`` and ``sites`` written once, over the card's memory
    rate). Then ``analyze_index`` (host code; timed) on the device-built
    bench index and the main path's warmup batch through a BBMapAligner
    on it: every MappedBatch field and match equal to the main path's, and
    which of the two aligners took the seeded device arrays."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.align.quickmap_device import pack_genome_2bit
    from bbmap_tpu_torch.index import build_device
    from bbmap_tpu_torch.index.build import analyze_index, build_index

    on_card = torch_cuda(device)
    res = {}
    built = {}
    for name, g in index_genomes(gbases).items():
        t = time.time()
        host = build_index(g, INDEX_K)
        host_s = time.time() - t
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device) if on_card else 0
        t = time.time()
        idx = build_device.build_index_device(g, INDEX_K, device=device)
        _sync(device)
        cold_s = time.time() - t
        peak = torch.cuda.max_memory_allocated(device) - base \
            if on_card else None
        for f in ("starts", "sites"):
            a, b = getattr(idx, f), getattr(host, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"index build {name}: {f} of the "
                                     f"device build differs from the host "
                                     f"build's ({a.dtype}, {b.dtype})")
        warm = []
        for _ in range(INDEX_DEVICE_REPS):
            t = time.time()
            build_device.build_index_device(g, INDEX_K, device=device)
            _sync(device)
            warm.append(time.time() - t)
        _starts, _sites, gpack, nmask, G = idx._device_arrays
        csr_ms = _cuda_ms(lambda: build_device._device_csr(
            gpack, nmask, G, INDEX_K), INDEX_DEVICE_REPS)[0] \
            if on_card else float("nan")
        codes = g.packed_codes()[0]
        gp, nm = pack_genome_2bit(codes)
        n_bytes = gp.nbytes + nm.nbytes + 4 * (len(host.starts)
                                               + len(host.sites))
        res[name] = {"G": len(codes), "chroms": g.n_chroms,
                     "n_bases": int((codes > 3).sum()),
                     "sites": len(host.sites), "k": INDEX_K,
                     "host_build_s": host_s,
                     "device_build_cold_s": cold_s,
                     "device_build_warm_s": warm, "device_csr_ms": csr_ms,
                     "device_peak_bytes": peak,
                     "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
                     "bound_by": "bytes", "starts_sites_equal": True}
        say(f"index build {name}: {len(codes)} bp, {g.n_chroms} chroms, "
            f"{res[name]['n_bases']} N, k={INDEX_K}, {len(host.sites)} "
            f"sites: host build_index {host_s:.3f} s; "
            f"build_index_device cold {cold_s:.3f} s, "
            f"warm {', '.join(f'{w:.3f}' for w in warm)} s (the device CSR "
            f"alone {csr_ms:.3f} ms, bound {res[name]['bound_ms']:.4f} ms "
            f"in bytes), peak {peak} B above the {base} B held before; "
            f"starts and sites equal to the host build's; card {smi}")
        built[name] = (g, idx)
        del host

    # the main path's warmup batch on the device-built bench index
    b1, b2, (mb1, mb2), main_aligner = first
    g, idx = built["bench"]
    n_sites = len(idx.sites)
    t = time.time()
    analyze_index(idx, 0.01)
    analyze_s = time.time() - t
    compacted = len(idx.sites) != n_sites
    al = BBMapAligner(g, idx, device)
    reset_counts()
    t = time.time()
    got = al.map_pairs_columnar(b1, b2)
    _sync(device)
    map_s = time.time() - t
    launches = {k: v for k, v in launch_counts().items() if v}
    fields = ("mapped", "strand", "chrom", "start", "stop", "score",
              "ambiguous", "perfect", "paired", "rescued", "n_sites")
    for mate, (a, b) in enumerate(zip(got, (mb1, mb2))):
        for f in fields:
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"index build: mate {mate + 1}'s {f} on "
                                     f"the device-built index differs from "
                                     f"the host-built run's")
        bad = [i for i in range(a.size) if a.match(i) != b.match(i)]
        if bad:
            raise AssertionError(f"index build: mate {mate + 1}: "
                                 f"{len(bad)} match strings differ, first "
                                 f"at read {bad[0]}")
    res["aligner"] = {"pairs": b1.size, "map_s": map_s,
                      "analyze_s": analyze_s, "compacted": compacted,
                      "seeded_device_built": al.dindex.seeded,
                      "seeded_host_built": main_aligner.dindex.seeded,
                      "launches": launches}
    say(f"index build: the main path's warmup batch ({b1.size} pairs) on "
        f"the device-built index after analyze_index ({analyze_s:.3f} s, "
        f"{'compacted' if compacted else 'no clumpy key removed'}): every "
        f"MappedBatch field and match equal to the host-built run's, "
        f"{map_s:.2f} s; seeded device arrays taken by the device-built "
        f"index's aligner: {al.dindex.seeded}, by the main path's "
        f"(host-built) aligner: {main_aligner.dindex.seeded}; card {smi}")
    del al, built
    return res


@contextlib.contextmanager
def gpu_util_sampler(samples: list):
    """Sample the card's utilization.gpu (the share of time a kernel was
    running) every 200 ms while the block runs; the samples land in
    ``samples`` and the sampler process is stopped on exit."""
    p = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        p.terminate()
        try:
            out = p.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        samples.extend(float(x) for x in out.split() if x.isdigit())


def write_fasta(path: str, name: str, bases) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for a in range(0, len(bases), 80):
            fh.write(bases[a:a + 80].tobytes().decode() + "\n")


def long_phase(device, genome_bases, n_reads: int = N_LONG,
               L_read: int = L_LONG, check: bool = True) -> dict:
    """The long-read bench's inputs through the port's ``mappacbio``
    CLI: the genome as FASTA, ``randomreads
    pacbio=t pbmin=pbmax=L pberror=0.12 seed=19``, mapped with
    ``device=``, graded with ``gradesam.grade(out, 400)``. The wall time
    covers the CLI's index build and mapping; the CLI's own mapping time
    is read from its report."""
    import re

    import torch
    from bbmap_tpu_torch import backend
    from bbmap_tpu_torch.align import escalate_device, pipeline
    from bbmap_tpu_torch.ops import msa_kernels
    from bbmap_tpu_torch.tools import gradesam, mappacbio, randomreads

    # what the card's free memory allows a fill launch at the escalation
    # windows (the aligner asks again at each launch)
    for C in (L_read + 24, L_read + 456):
        ladder = escalate_device._trace_ladder(
            L_read, C, escalate_device.TRACE_CHUNKS_W, device)
        say(f"fill chunk at ({L_read}, {C}): budget "
            f"{backend.prev_code_budget(device)} B over "
            f"{msa_kernels.prev_code_bytes(L_read, C, device)} B a job: "
            f"{pipeline._dp_tb_chunk_cap(L_read, C, device)} jobs, trace "
            f"ladder {ladder}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pb")
    try:
        ref = os.path.join(tmp, "ref.fa")
        reads = os.path.join(tmp, "reads.fq")
        out = os.path.join(tmp, "mapped.sam")
        write_fasta(ref, "ecoli_like", genome_bases)
        if randomreads.main([
                f"ref={ref}", f"out={reads}", f"reads={n_reads}",
                "pacbio=t", f"pbmin={L_read}", f"pbmax={L_read}",
                "pberror=0.12", "seed=19"]) != 0:
            raise AssertionError("randomreads failed")
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        util = []
        sampler = gpu_util_sampler(util) if on_card \
            else contextlib.nullcontext()
        reset_counts()
        t0 = time.time()
        try:
            with sampler, contextlib.redirect_stderr(log):
                rc = mappacbio.main([f"ref={ref}", f"in={reads}",
                                     f"out={out}", "nodisk",
                                     f"device={device}"])
                _sync(device)
        finally:
            for ln in log.getvalue().strip().splitlines()[-6:]:
                say(f"  mappacbio: {ln}")
        wall = time.time() - t0
        launches = launch_counts()
        if rc != 0:
            raise AssertionError(f"mappacbio exited {rc}")
        s = gradesam.grade(out, 400)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = max(1, s["primary"] - s["unparsed"])
    m = re.search(r"Time:\s*([0-9.]+) seconds", log.getvalue())
    if m is None:
        raise AssertionError("the CLI reported no mapping time")
    map_s = float(m.group(1))
    res = {"reads": n_reads, "read_len": L_read,
           "strict_correct": s["strict"] / n,
           "mapped_fraction": s["mapped"] / n,
           "wall_s": wall, "map_s": map_s,
           "reads_per_s": n_reads / map_s,
           "bases_per_s": n_reads * L_read / map_s,
           "launches": launches,
           "gpu_util_mean_pct": sum(util) / len(util) if util else None,
           "max_memory_allocated":
               torch.cuda.max_memory_allocated() if on_card else None}
    say("long reads: " + json.dumps(res))
    if check:
        if res["mapped_fraction"] < LONG_MAPPED_MIN or \
                res["strict_correct"] < LONG_STRICT_MIN:
            raise AssertionError(
                f"long-read accuracy below the bar (mapped >= "
                f"{LONG_MAPPED_MIN}, strict >= {LONG_STRICT_MIN})")
        if not (launches["msa_score_band"] and launches["msa_fill_band"]
                and launches["msa_walk"]):
            raise AssertionError(f"the band kernels or the walk kernel "
                                 f"never launched on the long-read path: "
                                 f"{launches}")
        if launches["msa_score_strided"] or launches["msa_fill_strided"]:
            raise AssertionError(f"a strided kernel launched on the "
                                 f"long-read path: {launches}")
    return res


def _equal(what: str, got, want) -> None:
    """Raise unless the card's result equals the plain host path's
    (tolerance 0)."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} on the card, "
                             f"{want.shape} on the host")
    n_diff = int((got != want).sum())
    if n_diff:
        raise AssertionError(f"{what}: {n_diff} of {got.size} values differ "
                             f"between the card and the plain host path")


def _chunks(rows, ch: int):
    """rows padded with its own first rows to whole chunks of ch (as
    bench_tools.py pads), and the chunks' starts."""
    import numpy as np
    n = len(rows)
    npad = -(-n // ch) * ch
    if npad != n:
        rows = np.concatenate([rows, rows[:npad - n]])
    return rows, range(0, npad, ch)


def duk_inputs(n_reads: int = N_DUK):
    """bench_tools.bench_bbduk's reads with a synthetic adapter set (the
    bench read TruSeq adapters from a file the repository does not hold):
    200 adapters of 34-66 bp and n reads of 150 bp, 20 % of them with the
    first <= 33 bases of an adapter at a tail position."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(5)
    adapters = [bytes(rng.choice(acgt, int(rng.integers(34, 67))))
                for _ in range(N_ADAPTERS)]
    reads = rng.choice(acgt, size=(n_reads, L)).astype(np.uint8)
    adlen = min(len(adapters[0]), 33)
    for i in np.nonzero(rng.random(n_reads) < 0.2)[0]:
        p = int(rng.integers(L // 2, L - 5))
        ad = adapters[int(rng.integers(0, N_ADAPTERS))][:min(adlen, L - p)]
        reads[i, p:p + len(ad)] = np.frombuffer(ad, np.uint8)
    return adapters, reads


def seal_inputs(n_reads: int = N_SEAL):
    """bench_tools.bench_seal's inputs: 50 references of 5,000 bp and n
    reads of 150 bp, each an exact substring of one of them."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(11)
    refs = [bytes(rng.choice(acgt, SEAL_REF_LEN)) for _ in range(SEAL_REFS)]
    srcs = rng.integers(0, SEAL_REFS, n_reads)
    offs = rng.integers(0, SEAL_REF_LEN - L, n_reads)
    refmat = np.array([np.frombuffer(r, np.uint8) for r in refs])
    return refs, refmat[srcs[:, None], offs[:, None] + np.arange(L)[None, :]]


def merge_inputs(n_pairs: int = N_MERGE):
    """bench_tools.bench_bbmerge's pairs: 2 x 100 bp at insert 160, read
    2 given in read 1's orientation."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(7)
    frag = rng.choice(acgt, size=(n_pairs, MERGE_INSERT)).astype(np.uint8)
    return (frag[:, :MERGE_L].copy(),
            frag[:, MERGE_INSERT - MERGE_L:].copy())


def bbduk_scan(device, n_reads: int = N_DUK) -> dict:
    """bbduk's k-mer scan (k=23, hdist=1) over n reads in chunks of
    131,072 through ``kmerset.scan_batch`` on the card; the first chunk's
    ids held against ``scan_batch_plain``."""
    from bbmap_tpu_torch.index import kmerset, kmerset_device
    t = time.time()
    adapters, reads = duk_inputs(n_reads)
    ks = kmerset.build_kmer_set(adapters, k=K_DUK, hdist=HDIST_DUK)
    reads, starts = _chunks(reads, SCAN_CHUNK)
    setup_s = time.time() - t
    t = time.time()
    first = reads[:SCAN_CHUNK]
    _equal("bbduk ids", kmerset.scan_batch(ks, first, device)[1],
           kmerset.scan_batch_plain(ks, first)[1])
    check_s = time.time() - t
    kmerset_device.reset_scans()
    t = time.time()
    n_hit = 0
    for a in starts:
        hits, _ids = kmerset.scan_batch(ks, reads[a:a + SCAN_CHUNK], device)
        n_hit += int(hits.any(axis=1).sum())
    dt = time.time() - t
    scans = dict(kmerset_device.scans)
    res = {"tool": "bbduk", "reads": len(reads), "k": K_DUK,
           "hdist": HDIST_DUK, "set_values": len(ks.values),
           "reads_per_s": len(reads) / dt, "reads_with_hit": n_hit,
           "scan_s": dt, "scans": scans, "setup_s": setup_s,
           "check_s": check_s}
    if torch_cuda(device):
        # a chunk's scan at least: the reads in, the set's sorted values
        # (int64) in, the ids (int32 a k-mer position) out; and at each
        # position the two k-mers built (2k shift-or steps) and a binary
        # search of the values (a compare and a select a halving)
        pos = SCAN_CHUNK * (L - K_DUK + 1)
        n_bytes = SCAN_CHUNK * L + 8 * len(ks.values) + 4 * pos
        ops = pos * (2 * 2 * K_DUK + 2 * max(1, len(ks.values)).bit_length())
        res["chunk_ms"] = 1e3 * dt / len(starts)
        res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, ops,
                                                    max_sm_clock_hz())
        say(f"bound bbduk scan a chunk of {SCAN_CHUNK} x {L} bp: {n_bytes} "
            f"B, {ops} operations, {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}) against {res['chunk_ms']:.3f} ms of wall a "
            f"chunk (host included)")
    say("bbduk: " + json.dumps(res))
    if scans != {"ids": len(starts), "slots": 0, "counts": 0}:
        raise AssertionError(f"bbduk: {len(starts)} chunks fed, device "
                             f"scans {scans}")
    return res


def seal_assign(device, n_reads: int = N_SEAL) -> dict:
    """seal (k=31, ambig=first) over n reads in chunks of 131,072 through
    ``Seal.assign_batch`` on the card: the count route. The first chunk's
    (B, nrefs) counts held against ``count_hits_plain``, and the slot
    route's (row, owner) pairs on a multi-owner set (the references and
    ten chimeras of two of them) against ``scan_batch_multi_plain``."""
    import numpy as np
    from bbmap_tpu_torch.core.batch import ReadBatch
    from bbmap_tpu_torch.index import kmerset, kmerset_device
    from bbmap_tpu_torch.tools.seal import Seal
    t = time.time()
    refs, reads = seal_inputs(n_reads)
    names = [f"scaf{i}" for i in range(SEAL_REFS)]
    seal = Seal(refs, names, k=K_SEAL, ambig="first", device=device)
    reads, starts = _chunks(reads, SCAN_CHUNK)
    setup_s = time.time() - t

    def mk(a):
        return ReadBatch(
            bases=reads[a:a + SCAN_CHUNK], quality=None,
            lengths=np.full(SCAN_CHUNK, L, np.int32),
            ids=[str(i) for i in range(SCAN_CHUNK)],
            numeric_ids=np.arange(a, a + SCAN_CHUNK, dtype=np.int64))

    t = time.time()
    first = reads[:SCAN_CHUNK]
    _equal("seal counts",
           kmerset_device.device_scan_counts(seal.ks, first, seal.nrefs,
                                             device),
           kmerset_device.count_hits_plain(seal.ks, first, seal.nrefs))
    chimeras = [refs[i][1000:3000] + refs[i + 1][2000:4000]
                for i in range(0, 20, 2)]
    multi = kmerset.build_kmer_set(
        refs + chimeras, k=K_SEAL, multi=True,
        names=names + [f"chimera{i}" for i in range(len(chimeras))])
    n_multi = int((np.diff(multi.multi_offsets) > 1).sum())
    if not n_multi:
        raise AssertionError("seal: the multi-owner set has no k-mer with "
                             "two owners")
    for what, g, w in zip(("rows", "ids"),
                          kmerset.scan_batch_multi(multi, first, device),
                          kmerset.scan_batch_multi_plain(multi, first)):
        _equal(f"seal multi-owner {what}", g, w)
    check_s = time.time() - t
    seal.assign_batch(mk(0))
    kmerset_device.reset_scans()
    t = time.time()
    n_matched = 0
    for a in starts:
        n_matched += int((seal.assign_batch(mk(a)).primary >= 0).sum())
    dt = time.time() - t
    scans = dict(kmerset_device.scans)
    res = {"tool": "seal", "reads": len(reads), "k": K_SEAL,
           "refs": SEAL_REFS, "set_values": len(seal.ks.values),
           "reads_per_s": len(reads) / dt,
           "matched_fraction": n_matched / len(reads), "assign_s": dt,
           "scans": scans, "multi_owner_values": n_multi,
           "setup_s": setup_s, "check_s": check_s}
    say("seal: " + json.dumps(res))
    if scans != {"ids": 0, "slots": 0, "counts": len(starts)}:
        raise AssertionError(f"seal: {len(starts)} chunks fed, device "
                             f"scans {scans}")
    if res["matched_fraction"] < SEAL_MATCHED_MIN:
        raise AssertionError(f"seal matched below {SEAL_MATCHED_MIN}: every "
                             f"read is a substring of a reference")
    return res


def bbmerge_ladders(device, n_pairs: int = N_MERGE) -> dict:
    """bbmerge's overlap ladders over n pairs in batches of 65,536 on the
    card: ``mate_by_overlap_batch`` (mismatch mode, no quality, as the
    bench runs it) and ``mate_by_overlap_ratio_batch`` (bbmerge's default
    mode); each mode's first batch held against its numpy ladder."""
    from bbmap_tpu_torch.ops import overlap, overlap_device
    t = time.time()
    a, b = merge_inputs(n_pairs)
    a, starts = _chunks(a, MERGE_CHUNK)
    b, _ = _chunks(b, MERGE_CHUNK)
    modes = {
        "mismatch": (
            lambda x, y: overlap.mate_by_overlap_batch(x, None, y, None,
                                                       device=device),
            lambda x, y: overlap.mate_by_overlap_batch_plain(x, None, y,
                                                             None)),
        "ratio": (
            lambda x, y: overlap.mate_by_overlap_ratio_batch(x, y,
                                                             device=device),
            overlap.mate_by_overlap_ratio_batch_plain)}
    res = {"tool": "bbmerge", "pairs": len(a), "setup_s": time.time() - t}
    for mode, (on_card, plain) in modes.items():
        t = time.time()
        x, y = a[:MERGE_CHUNK], b[:MERGE_CHUNK]
        for what, g, w in zip(("insert", "bad", "ambig"), on_card(x, y),
                              plain(x, y)):
            _equal(f"bbmerge {mode} {what}", g, w)
        check_s = time.time() - t
        overlap_device.reset_scans()
        t = time.time()
        n_merged = 0
        for s in starts:
            ins, _bad, _amb = on_card(a[s:s + MERGE_CHUNK],
                                      b[s:s + MERGE_CHUNK])
            n_merged += int((ins > 0).sum())
        dt = time.time() - t
        scans = dict(overlap_device.scans)
        res[mode] = {"reads_per_s": 2 * len(a) / dt,
                     "merged_fraction": n_merged / len(a), "ladder_s": dt,
                     "scans": scans, "check_s": check_s}
        if torch_cuda(device):
            # a batch at least: both mates' bases in, (insert, bad, ambig)
            # int32 out; each insert size's overlap compared once, a
            # compare and a count a base (inserts from the ladder's
            # smallest, 26 or 35, to the two mates' length)
            la, lb = a.shape[1], b.shape[1]
            lo = 35 if mode == "mismatch" else 26
            per_pair = sum(min(i, la, lb, la + lb - i)
                           for i in range(lo, la + lb + 1))
            n_bytes = MERGE_CHUNK * (la + lb + 12)
            ops = 2 * MERGE_CHUNK * per_pair
            bms, by = bound_ms(n_bytes, ops, max_sm_clock_hz())
            res[mode].update(batch_ms=1e3 * dt / len(starts), bound_ms=bms,
                             bound_by=by)
            say(f"bound bbmerge {mode} ladder a batch of {MERGE_CHUNK} "
                f"pairs: {n_bytes} B, {ops} operations, {bms:.4f} ms "
                f"({by}) against {1e3 * dt / len(starts):.3f} ms of wall a "
                f"batch (host included)")
        want = dict.fromkeys(overlap_device.ROUTES, 0)
        want[mode] = len(starts)
        if scans != want:
            raise AssertionError(f"bbmerge {mode}: {len(starts)} batches "
                                 f"fed, ladders run {scans}")
    say("bbmerge: " + json.dumps(res))
    return res


def _fastq(path: str, names, rows, quals) -> None:
    with open(path, "wb") as fh:
        for nm, r, q in zip(names, rows, quals):
            fh.write(b"@" + nm.encode() + b"\n" + r.tobytes() + b"\n+\n"
                     + (q + 33).astype("uint8").tobytes() + b"\n")


def _cli_pairs(rng, n: int, read_len: int, ins_lo: int, ins_hi: int,
               adapter1: bytes, adapter2: bytes):
    """n pairs of read_len at inserts ins_lo..ins_hi, reading through into
    adapter1 / adapter2 (repeated) past a short insert; read 2 with 0.5 %
    substitutions, both with 0.1 % N and phred 20-40."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    ins = rng.integers(ins_lo, ins_hi + 1, n)[:, None]
    frag = rng.choice(acgt, (n, max(ins_hi, read_len))).astype(np.uint8)
    col = np.arange(read_len)[None, :]
    inside = col < ins
    past = np.clip(col - ins, 0, read_len - 1)

    def through(ad):
        return np.frombuffer((ad * (read_len // len(ad) + 1))[:read_len],
                             np.uint8)[past]
    r1 = np.where(inside, frag[:, :read_len], through(adapter1))
    r2 = np.where(inside, comp[np.take_along_axis(
        frag, np.clip(ins - 1 - col, 0, None), axis=1)], through(adapter2))
    sub = rng.random(r2.shape) < 0.005
    r2[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    for r in (r1, r2):
        r[rng.random(r.shape) < 0.001] = ord("N")
    q1, q2 = (rng.integers(20, 41, (n, read_len)) for _ in range(2))
    return r1, r2, q1, q2


def run_tool(tool: str, args, keep_time: bool = False) -> tuple:
    """The port's CLI entry point of ``tool`` (``python -m
    bbmap_tpu_torch <tool>``) in this process: (exit code, its report on
    stderr without the ``Time:`` line, unless ``keep_time``)."""
    import importlib
    from bbmap_tpu_torch.__main__ import TOOLS
    module, entry = TOOLS[tool]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = getattr(importlib.import_module(module), entry)(list(args))
    return rc, "\n".join(ln for ln in err.getvalue().splitlines()
                         if keep_time or not ln.startswith("Time:"))


def tools_cli_inputs(d: Path, n: int = N_CLI) -> dict:
    """The inputs of the bbduk (paired, ktrim=r k=23 mink=11 hdist=1
    tbo=t), seal (stats= and pattern=) and bbmerge (paired) CLI runs,
    written into ``d``: n reads (bbduk: n / 2 pairs) or n pairs (bbmerge).
    Returns tool -> (argument templates, reads in, device scans and
    ladders expected on the card); {d} is ``d``, {o} the run's output
    directory."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(23)
    adapters, _ = duk_inputs(0)
    refs, seal_reads = seal_inputs(n)
    with open(d / "adapters.fa", "w") as fh:
        for i, s in enumerate(adapters):
            fh.write(f">adapter{i}\n{s.decode()}\n")
    with open(d / "refs.fa", "w") as fh:
        for i, s in enumerate(refs):
            fh.write(f">scaf{i}\n{s.decode()}\n")
    n_duk = n // 2
    r1, r2, q1, q2 = _cli_pairs(rng, n_duk, L, 60, 300, adapters[0],
                                adapters[1])
    _fastq(d / "duk1.fq", [f"d{i}/1" for i in range(n_duk)], r1, q1)
    _fastq(d / "duk2.fq", [f"d{i}/2" for i in range(n_duk)], r2, q2)
    r1, r2, q1, q2 = _cli_pairs(rng, n, MERGE_L, 110, 190, b"A", b"C")
    _fastq(d / "merge1.fq", [f"m{i}/1" for i in range(n)], r1, q1)
    _fastq(d / "merge2.fq", [f"m{i}/2" for i in range(n)], r2, q2)
    seal_reads[::10] = rng.choice(acgt, (len(seal_reads[::10]), L))
    _fastq(d / "seal.fq", [f"s{i}" for i in range(n)], seal_reads,
           rng.integers(20, 41, seal_reads.shape))
    duk_batches = -(-n_duk // CLI_BATCH)
    n_batches = -(-n // CLI_BATCH)
    return {
        "bbduk": (["in={d}/duk1.fq", "in2={d}/duk2.fq",
                   "out={o}/out1.fq", "out2={o}/out2.fq",
                   "outm={o}/outm.fq", "ref={d}/adapters.fa", "k=23",
                   "mink=11", "hdist=1", "ktrim=r", "tbo=t",
                   "stats={o}/stats.txt"], 2 * n_duk,
                  {"ids": 2 * duk_batches}, {"ratio": duk_batches}),
        "seal": (["in={d}/seal.fq", "ref={d}/refs.fa", "k=31",
                  "stats={o}/stats.txt", "pattern={o}/out_%.fq",
                  "outu={o}/outu.fq"], n, {"counts": n_batches}, {}),
        "bbmerge": (["in1={d}/merge1.fq", "in2={d}/merge2.fq",
                     "out={o}/merged.fq", "outu={o}/u1.fq",
                     "outu2={o}/u2.fq", "ihist={o}/ihist.txt"], 2 * n,
                    {}, {"ratio": n_batches})}


def tools_cli(device, d: Path, runs: dict, cpu_runs: dict) -> dict:
    """The CLIs of ``tools_cli_inputs`` on the card in this process, each
    held to its CPU run (``cpu_runs``: tool -> ``CpuRun`` with
    ``device=cpu``, started beforehand in processes of their own): every
    output file byte-equal between the two, the reports too once the
    ``Time:`` line is dropped, and the card's run counted in the scan and
    ladder counters."""
    from bbmap_tpu_torch.index import kmerset_device
    from bbmap_tpu_torch.ops import overlap_device
    res = {}
    for tool, (template, reads_in, want_scans, want_ladders) in runs.items():
        o = d / f"{tool}_card"
        kmerset_device.reset_scans()
        overlap_device.reset_scans()
        card = cli_card(device, o, tool, [a.format(d=d, o=o)
                                          for a in template])
        scans, ladders = dict(kmerset_device.scans), \
            dict(overlap_device.scans)
        cmp = cli_compare(tool, card, cpu_runs[tool].finish(900))
        want = dict.fromkeys(kmerset_device.ROUTES, 0)
        want.update(want_scans)
        want_l = dict.fromkeys(overlap_device.ROUTES, 0)
        want_l.update(want_ladders)
        if scans != want or ladders != want_l:
            raise AssertionError(f"{tool}: device scans {scans}, "
                                 f"ladders {ladders} on the card; "
                                 f"expected {want}, {want_l}")
        n_reads = sum(v.count(b"\n+\n") for k, v in card["files"].items()
                      if k.endswith(".fq"))
        res[tool] = {"reads_in": reads_in, "reads_out": n_reads,
                     "files": cmp["files"], "bytes": cmp["bytes"],
                     "scans": scans, "ladders": ladders,
                     "wall_s": cmp["wall_s"], "wall_cpu_s": cmp["wall_cpu_s"],
                     "report": card["report"].splitlines()}
        if not n_reads:
            raise AssertionError(f"{tool} wrote no reads")
    say("tools CLI: " + json.dumps(res))
    return res


def tools_phase(device) -> list:
    """The read-preprocessing tools on the card at bench_tools.py's sizes,
    then their CLIs byte-equal between the card and the CPU, the CPU runs
    in processes of their own started first, beside the card's work: the
    results of bbduk_scan, seal_assign, bbmerge_ladders and tools_cli."""
    from bbmap_tpu_torch.io import native
    native.get_lib()                 # its one stderr line, if any, goes now
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools")
    cpu_runs = {}
    try:
        d = Path(tmp)
        runs = tools_cli_inputs(d)
        for tool, (template, *_) in runs.items():
            for side in ("card", "cpu"):
                (d / f"{tool}_{side}").mkdir()
            o = d / f"{tool}_cpu"
            cpu_runs[tool] = CpuRun(o, tool, [a.format(d=d, o=o)
                                              for a in template])
        return [bbduk_scan(device), seal_assign(device),
                bbmerge_ladders(device),
                tools_cli(device, d, runs, cpu_runs)]
    finally:
        for r in cpu_runs.values():
            r.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# the kmer tools phase: the counting Bloom filter at bbnorm's defaults
# (bbmap_tpu/tools/bbnorm.py:74-76: 2**26 cells, 3 hashes, 16-bit cells)
# over 1,048,576 reads of 150 bp (~34x of the 4.6 Mbp genome), k = 31, in
# bbnorm's chunks of 8,192 reads; the rows are held against the numpy
# class after the first KCA_CHECK_CHUNKS chunks, with KCA_QUERIES reads;
# saturation at 8 and 2 bits on a chunk from a KCA_HOT_BP window
N_KCA_READS, KCA_CHUNK, KCA_K = 1 << 20, 8192, 31
KCA_CELLS, KCA_HASHES, KCA_BITS = 1 << 26, 3, 16
KCA_CHECK_CHUNKS, KCA_QUERIES = 4, 65536
KCA_HOT_BP, KCA_HOT_CELLS = 2000, 1 << 22
# the CLIs on the card and on the CPU: pairs (bbnorm, ecc), reads
# (kmercoverage), rqcfilter's pairs, and decontaminate's two libraries
N_NORM_PAIRS, N_ECC_PAIRS, N_KCOV_READS = 20_000, 2_000, 20_000
N_RQC_PAIRS = 2_000
N_DECON_READS, DECON_REF_BP, DECON_JUNK_BP = 2_000, 48_000, 2_000
# the genome windows the CLI reads come from, so that their k-mers have
# depth: bbnorm / kmercoverage ~40x, ecc ~30x
NORM_WINDOW, ECC_WINDOW = 150_000, 20_000


def genome_reads(gbases, n: int, start: int, span: int, seed: int,
                 err: float = 0.0):
    """n reads of L bp from gbases[start:start + span], every other one
    reverse-complemented, with substitutions at rate err: (n, L) uint8."""
    import numpy as np
    from bbmap_tpu_torch.core.bases import COMP_ASCII
    rng = np.random.default_rng(seed)
    win = np.lib.stride_tricks.sliding_window_view(
        gbases[start:start + span], L)
    rows = win[rng.integers(0, len(win), n)]
    rows[1::2] = COMP_ASCII[rows[1::2, ::-1]]
    if err:
        hit = rng.random(rows.shape) < err
        rows[hit] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(hit.sum()))]
    return rows


def _kca_equal(what: str, kca, host, queries) -> None:
    """The port's filter on the card against the numpy KCountArray fed the
    same k-mers: every row, reads of ``queries`` and the load, tolerance
    0."""
    for h in range(host.hashes):
        _equal(f"{what} row {h}", kca.array[h].cpu().numpy(), host.array[h])
    _equal(f"{what} read", kca.read(queries), host.read(queries))
    if kca.used_fraction() != host.used_fraction():
        raise AssertionError(f"{what}: used_fraction "
                             f"{kca.used_fraction()} on the card, "
                             f"{host.used_fraction()} on the host")


def kmer_count(device, gbases) -> dict:
    """The counting Bloom filter on the card at bbnorm's size: counting
    (host canonical_kmers, then ``increment``) and lookup (host
    canonical_kmers, then ``read``) passes over N_KCA_READS reads, timed
    with the comparisons against the numpy class left out of the clock;
    then the saturation check at 8 and 2 bits."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.index import kcount
    from bbmap_tpu_torch.tools.bbnorm import canonical_kmers
    reads = genome_reads(gbases, N_KCA_READS, 0, len(gbases), 29)
    kca = kcount.make_kca(KCA_CELLS, cell_bits=KCA_BITS, hashes=KCA_HASHES,
                          device=device)
    host = kcount.KCountArray(KCA_CELLS, cell_bits=KCA_BITS,
                              hashes=KCA_HASHES)
    kcount.reset_calls()
    n_kmers, t_cut, t_check = 0, 0.0, 0.0
    _sync(device)
    t0 = time.perf_counter()
    for c, lo in enumerate(range(0, N_KCA_READS, KCA_CHUNK)):
        t = time.perf_counter()
        can, valid = canonical_kmers(reads[lo:lo + KCA_CHUNK], KCA_K)
        km = can[valid]
        t_cut += time.perf_counter() - t
        kca.increment(km)
        n_kmers += len(km)
        if c < KCA_CHECK_CHUNKS:
            t = time.perf_counter()
            host.increment(km)
            if c == KCA_CHECK_CHUNKS - 1:
                rng = np.random.default_rng(3)
                q = np.concatenate([
                    rng.choice(km, KCA_QUERIES // 2),
                    rng.integers(0, 1 << (2 * KCA_K), KCA_QUERIES // 2)])
                _sync(device)
                _kca_equal(f"kcount after {KCA_CHECK_CHUNKS} chunks", kca,
                           host, q)
                del host
            t_check += time.perf_counter() - t
    _sync(device)
    wall = time.perf_counter() - t0 - t_check
    n_chunks = N_KCA_READS // KCA_CHUNK
    if kcount.calls != {"increment": n_chunks, "read": 1}:
        raise AssertionError(f"kcount calls {kcount.calls}, expected "
                             f"{n_chunks} increments and 1 read")
    res = {"reads": N_KCA_READS, "kmers": n_kmers, "count_wall_s": wall,
           "count_kmers_per_s": n_kmers / wall,
           "count_reads_per_s": N_KCA_READS / wall,
           "count_host_cut_share": t_cut / wall,
           "load": kca.used_fraction()}
    n_q, t_cut, t_read = 0, 0.0, 0.0
    t0 = time.perf_counter()
    for lo in range(0, N_KCA_READS, KCA_CHUNK):
        t = time.perf_counter()
        can, _valid = canonical_kmers(reads[lo:lo + KCA_CHUNK], KCA_K)
        t1 = time.perf_counter()
        kca.read(can.ravel())
        t_read += time.perf_counter() - t1
        t_cut += t1 - t
        n_q += can.size
    wall = time.perf_counter() - t0
    res.update({"read_wall_s": wall, "read_kmers_per_s": n_q / t_read,
                "read_reads_per_s": N_KCA_READS / wall,
                "read_host_cut_share": t_cut / wall, "queries": n_q})
    if torch.device(device).type == "cuda":
        # one chunk's increment and read alone, host k-mers ready: the
        # upload from pageable memory and the card's work
        res["increment_chunk_ms"] = _cuda_ms(lambda: kca.increment(km), 10)[0]
        res["read_chunk_ms"] = _cuda_ms(lambda: kca.read(km), 10)[0]
        res["chunk_kmers"] = len(km)
        # the bytes a chunk's increment and read must move, each input read
        # once and each output written once: the k-mers (int64) in; a cell
        # of each hash row read and written (increment) or read (read), and
        # the counts (int32) out
        n = len(km)
        cell = 8 if KCA_BITS == 32 else 4
        for what, n_bytes in (("increment", 8 * n + 2 * KCA_HASHES * n * cell),
                              ("read", 8 * n + KCA_HASHES * n * cell + 4 * n)):
            bms, by = bound_ms(n_bytes, 0, max_sm_clock_hz())
            res[f"{what}_bound_ms"] = bms
            say(f"bound kcount {what} a chunk of {n} k-mers: {n_bytes} B, "
                f"{bms:.4f} ms ({by}) against "
                f"{res[f'{what}_chunk_ms']:.3f} ms measured "
                f"({100 * bms / res[f'{what}_chunk_ms']:.1f} %)")
    del kca
    # saturation: a chunk from a KCA_HOT_BP window (depth ~500 a k-mer)
    hot = genome_reads(gbases, KCA_CHUNK, 100_000, KCA_HOT_BP, 37)
    can, valid = canonical_kmers(hot, KCA_K)
    km = can[valid]
    q = np.concatenate([km[:KCA_QUERIES // 2], np.random.default_rng(5)
                        .integers(0, 1 << (2 * KCA_K), KCA_QUERIES // 2)])
    for bits in (8, 2):
        kca = kcount.make_kca(KCA_HOT_CELLS, cell_bits=bits,
                              hashes=KCA_HASHES, device=device)
        host = kcount.KCountArray(KCA_HOT_CELLS, cell_bits=bits,
                                  hashes=KCA_HASHES)
        for part in (km[:len(km) // 2], km[len(km) // 2:]):
            kca.increment(part)
            host.increment(part)
        if int(host.array.max()) != host.cell_max:
            raise AssertionError(f"{bits}-bit cells never saturated")
        _kca_equal(f"kcount {bits}-bit", kca, host, q)
        res[f"saturated_cells_{bits}bit"] = int(
            (host.array[0] == host.cell_max).sum())
    say("kmer tools count: " + json.dumps(res))
    return res


def _report_lines(err: str, paths) -> str:
    """A CLI's stderr without the lines that carry a wall time, with each
    of ``paths`` (the run's own directories) replaced by a tag."""
    import re
    out = []
    for ln in err.splitlines():
        if ln.startswith("Time:") or re.search(r"\d seconds", ln):
            continue
        for tag, p in paths.items():
            ln = ln.replace(str(p), tag)
        out.append(ln)
    return "\n".join(out)


def kmer_cli_inputs(d: Path, gbases) -> dict:
    """The inputs of the bbnorm (pairs, khist=), ecc (pairs), kmercoverage
    (hist=), rqcfilter (paired; ihist=, khist=t; adapter and artifact
    references written here, phix=f) and decontaminate (two libraries
    against their assemblies) CLI runs, written into ``d``. Returns tool
    -> argument templates: {d} is ``d``, {o} the run's output directory,
    {t} its temporary directory."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(41)

    def pairs(name, n, start, span, seed):
        r1 = genome_reads(gbases, n, start, span, seed, 0.005)
        r2 = genome_reads(gbases, n, start, span, seed + 1, 0.005)
        q = rng.integers(20, 41, (2, n, L))
        _fastq(d / f"{name}1.fq", [f"{name}{i}/1" for i in range(n)],
               r1, q[0])
        _fastq(d / f"{name}2.fq", [f"{name}{i}/2" for i in range(n)],
               r2, q[1])
    pairs("norm", N_NORM_PAIRS, 1_000_000, NORM_WINDOW, 51)
    pairs("ecc", N_ECC_PAIRS, 2_000_000, ECC_WINDOW, 53)
    kr = genome_reads(gbases, N_KCOV_READS, 1_000_000, NORM_WINDOW, 55,
                      0.005)
    _fastq(d / "kcov.fq", [f"k{i}" for i in range(N_KCOV_READS)], kr,
           rng.integers(20, 41, kr.shape))
    adapters, _ = duk_inputs(0)
    artifacts = [bytes(rng.choice(acgt, 80)) for _ in range(4)]
    with open(d / "adapters.fa", "w") as fh:
        for i, s in enumerate(adapters):
            fh.write(f">adapter{i}\n{s.decode()}\n")
    with open(d / "artifacts.fa", "w") as fh:
        for i, s in enumerate(artifacts):
            fh.write(f">artifact{i}\n{s.decode()}\n")
    r1, r2, q1, q2 = _cli_pairs(rng, N_RQC_PAIRS, L, 60, 300,
                                adapters[0], adapters[1])
    hit = np.nonzero(rng.random(N_RQC_PAIRS) < 0.05)[0]
    for i in hit:                         # artifact-bearing pairs
        p = int(rng.integers(0, L - 80))
        r1[i, p:p + 80] = np.frombuffer(artifacts[i % 4], np.uint8)
    _fastq(d / "rqc1.fq", [f"q{i}/1" for i in range(N_RQC_PAIRS)], r1,
           q1)
    _fastq(d / "rqc2.fq", [f"q{i}/2" for i in range(N_RQC_PAIRS)], r2,
           q2)
    for j, lib in enumerate(("libA", "libB")):
        at = 3_000_000 + j * 100_000
        write_fasta(d / f"{lib}.fa", f"{lib}_main",
                    gbases[at:at + DECON_REF_BP])
        with open(d / f"{lib}.fa", "ab") as fh:
            fh.write(f">{lib}_junk\n".encode()
                     + rng.choice(acgt, DECON_JUNK_BP).tobytes() + b"\n")
        lr = genome_reads(gbases, N_DECON_READS, at, DECON_REF_BP,
                          61 + j, 0.005)
        _fastq(d / f"{lib}.fq", [f"{lib}r{i}" for i in
                                 range(N_DECON_READS)], lr,
               rng.integers(20, 41, lr.shape))
    return {
        "bbnorm": ["in={d}/norm1.fq", "in2={d}/norm2.fq",
                   "out={o}/n1.fq", "out2={o}/n2.fq",
                   "outt={o}/tossed.fq", "target=20", "mindepth=3",
                   "khist={o}/khist.txt"],
        "ecc": ["in={d}/ecc1.fq", "in2={d}/ecc2.fq", "out={o}/e1.fq",
                "out2={o}/e2.fq"],
        "kmercoverage": ["in={d}/kcov.fq", "out={o}/cov.fq",
                         "hist={o}/hist.txt"],
        "rqcfilter": ["in={d}/rqc1.fq", "in2={d}/rqc2.fq",
                      "out=clean1.fq", "out2=clean2.fq", "path={o}",
                      "ref={d}/adapters.fa",
                      "artifactdb={d}/artifacts.fa", "phix=f",
                      "ihist=ihist.txt", "khist=t"],
        "decontaminate": ["reads={d}/libA.fq,{d}/libB.fq",
                          "ref={d}/libA.fa,{d}/libB.fa", "outdir={o}",
                          "tmpdir={t}", "minc=3", "minp=20",
                          "minl=500"]}


# rqcfilter's files that carry time stamps and the command line
KMER_CLI_UNCOMPARED = ("status.log", "reproduce.sh")


def kmer_cli(device, d: Path, runs: dict, cpu_runs: dict) -> dict:
    """The CLIs of ``kmer_cli_inputs`` on the card in this process, each
    held to its CPU run (``cpu_runs``: tool -> ``CpuRun`` with
    ``device=cpu`` that reports kcount's calls, started beforehand in
    processes of their own): every output file byte-equal between the two
    (``KMER_CLI_UNCOMPARED`` left out), the reports too once the lines with
    a wall time are dropped; the card's runs seen in kcount's calls, equal
    to the CPU's, and, for decontaminate, in the kernels' launches
    (returned as ``launches``)."""
    res = {}
    for tool, template in runs.items():
        o, t = d / f"{tool}_card", d / f"{tool}_card_tmp"
        card = cli_card(device, o, tool,
                        [a.format(d=d, o=o, t=t) for a in template],
                        tags={"{o}": o, "{t}": t})
        cpu = cpu_runs[tool].finish(900)
        for r in (card, cpu):
            for name in KMER_CLI_UNCOMPARED:
                r["files"].pop(name, None)
        cmp = cli_compare(tool, card, cpu)
        if card["kcount_calls"] != cpu["kcount_calls"]:
            raise AssertionError(f"{tool}: kcount calls "
                                 f"{card['kcount_calls']} on the card, "
                                 f"{cpu['kcount_calls']} on the CPU")
        res[tool] = {"files": cmp["files"], "bytes": cmp["bytes"],
                     "kcount_calls": card["kcount_calls"],
                     "wall_s": cmp["wall_s"], "wall_cpu_s": cmp["wall_cpu_s"]}
        if tool == "decontaminate":
            res[tool]["launches"] = card["launches"]
    for tool in ("bbnorm", "ecc", "kmercoverage", "decontaminate"):
        if not res[tool]["kcount_calls"]["increment"]:
            raise AssertionError(f"{tool}: no kcount increment ran")
    fl = (d / "rqcfilter_card" / "file-list.txt").read_text()
    for want in ("filtered_fastq_2=clean2.fq", "ihist=ihist.txt",
                 "khist=khist.txt"):
        if want not in fl:
            raise AssertionError(f"rqcfilter: {want} not in its "
                                 f"file-list: {fl!r}")
    c1, c2 = (d / "rqcfilter_card" / n for n in ("clean1.fq",
                                                 "clean2.fq"))
    m1 = [ln.split(b"/")[0] for ln in c1.read_bytes().split(b"\n")[::4]
          if ln]
    m2 = [ln.split(b"/")[0] for ln in c2.read_bytes().split(b"\n")[::4]
          if ln]
    if m1 != m2 or not m1:
        raise AssertionError(f"rqcfilter: out2 does not hold the mates "
                             f"of out ({len(m1)} and {len(m2)} reads)")
    cov = (d / "decontaminate_card" / "libA_covstats1.txt").read_text()
    clean = (d / "decontaminate_card" / "libA_clean.fasta").read_text()
    dirty = (d / "decontaminate_card" / "libA_dirty.fasta").read_text()
    if ">libA_main" not in clean or ">libA_junk" not in dirty:
        raise AssertionError(f"decontaminate: the main contig is not "
                             f"clean or the junk not dirty:\n{cov}")
    res["decontaminate"]["covstats_libA"] = cov.splitlines()[1:]
    say("kmer tools CLI: " + json.dumps(res))
    return res


def kmer_cli_start(d: Path, gbases, cpu_runs: dict) -> dict:
    """Write ``kmer_cli_inputs`` into ``d`` and start each CLI's CPU run
    (a ``CpuRun`` that reports kcount's calls) into ``cpu_runs``, which the
    caller stops. Returns the runs' argument templates."""
    runs = kmer_cli_inputs(d, gbases)
    for tool, template in runs.items():
        (d / f"{tool}_card").mkdir()
        o, t = d / f"{tool}_cpu", d / f"{tool}_cpu_tmp"
        o.mkdir()
        cpu_runs[tool] = CpuRun(
            o, tool, [a.format(d=d, o=o, t=t) for a in template],
            tags={"{o}": o, "{t}": t}, calls=d / f"{tool}.calls.json")
    return runs


def kmer_tools_phase(device, gbases, d: Path, runs: dict,
                     cpu_runs: dict) -> tuple:
    """The counting Bloom filter at bbnorm's size, then the k-mer tool
    CLIs byte-equal between the card and the CPU (their CPU runs started
    by ``kmer_cli_start`` beforehand, beside the card's work): the results
    of kmer_count and kmer_cli."""
    return kmer_count(device, gbases), kmer_cli(device, d, runs, cpu_runs)


# ---------------------------------------------------------------------------
# dedupe and the mapper's CLI variants
# ---------------------------------------------------------------------------

# the banded kernel against its plain version: pairs of 150 bp from the
# genome with 0-6 substitutions and indels at each E, global and infix (a
# thread a pair), at E = 40 (a warp a pair, the band in registers) and at
# E = 520 (a warp a pair, the band in device memory); one query against
# the pairs' b sides (dedupe's call); contigs of 5,000 bp at E = 8; and the
# first pairs at E = 2 against the numpy band sweep
BANDED_PAIRS, BANDED_ES, BANDED_WARP_E = 65_536, (0, 2, 4, 31), 40
BANDED_MEM_E, BANDED_MEM_PAIRS = 520, 1_024
CONTIG_PAIRS, CONTIG_L, CONTIG_E = 1_024, 5_000, 8
BANDED_NUMPY_PAIRS = 1_000
# the block kernel: queries at the table's shape (a class of BANDED_PAIRS
# reads), and dedupe's block against a class of about its 150 bp class's
# size at 50,000 reads
BLOCK_QUERIES_TABLE, BLOCK_QUERIES, DEDUPE_CLASS = 256, 512, 15_000
# the containment kernel at dedupe's block: fragments with windows in a
# block of BLOCK_QUERIES reads (4 windows each)
CONTAINED_FRAGMENTS = 64
# the CLIs card vs CPU, and the card's runs at a size users run
N_DEDUPE_CLI, N_DEDUPE_BIG = 2_000, 50_000
N_VARIANT_PAIRS, N_VARIANT_BIG = 500, 32_768
VARIANT_REF_BP = 1_000_000


def mutate_pairs(rng, src, max_ops: int):
    """b sides of pairs: each row of src (n, La) uint8 with 0..max_ops
    substitutions, insertions and deletions. Returns (B (n, La + max_ops)
    uint8, lb (n,) int32)."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n, La = src.shape
    B = np.zeros((n, La + max_ops), np.uint8)
    lb = np.zeros(n, np.int32)
    for t in range(n):
        b = src[t]
        for _ in range(int(rng.integers(0, max_ops + 1))):
            op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(b)))
            if op == 0:
                b = b.copy()
                b[p] = acgt[int(rng.integers(0, 4))]
            elif op == 1:
                b = np.insert(b, p, acgt[int(rng.integers(0, 4))])
            else:
                b = np.delete(b, p)
        B[t, :len(b)] = b
        lb[t] = len(b)
    return B, lb


def banded_instructions() -> tuple:
    """Instructions a band cell of each instantiation of
    ``csrc/banded_edit.cu`` from its SASS: a thread's row loop over its W
    cells, a warp's over 32 NC cells (each of the 32 lanes runs the loop),
    and the least of them, which the bound is reckoned with."""
    import re
    from bbmap_tpu_torch.ops import _build
    per = {}
    for name, (tot, loop) in sass_counts(
            _build.library_path("banded_edit")).items():
        m = re.search(r"banded_(thread|warp|block|contained|contained_warp)"
                      r"_kernelILi(\d+)E", name)
        if m and m.group(2) != "0":
            warp = m.group(1).endswith("warp")
            cells = int(m.group(2)) * (32 if warp else 1)
            key = f"{m.group(1)} {m.group(2)}"
            if m.group(1) == "block":
                key += " staged" if "ELb1E" in name else " in place"
            per[key] = 32 * loop / cells if warp else loop / cells
    if not per:
        raise AssertionError("no banded kernel in the library's SASS")
    least = min(per.values())
    say("sass banded_edit a cell: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(per.items())) +
        f"; the function needs at most {least:.1f}")
    return per, least


def banded_check(what: str, device, a, la, b, lb, E: int, infix: bool,
                 per_cell: float, clock: float, reps: int = 20) -> dict:
    """The kernel against its plain version on the same tensors (the
    layout of ``ops/banded_device``), tolerance 0, timed; the bound from
    the cells the data needs (each pair's rows to saturation or its end,
    from the plain version) and the bytes read and written once."""
    import torch
    from bbmap_tpu_torch.ops import banded_device as bd
    n = lb.shape[0]
    ms, got = _cuda_ms(lambda: bd.banded_edit(a, la, b, lb, E, infix), reps)
    plain_ms, want = _cuda_ms(lambda: bd.banded_edit_batch_plain(
        a, la, b, lb, E, infix), 1, warm=False)
    rows = torch.zeros(n, dtype=torch.int32, device=device)
    bd.banded_edit_batch_plain(a, la, b, lb, E, infix, rows_out=rows)
    err = _diff(got, want)
    cells = (2 * E + 1) * int(rows.long().sum())
    n_bytes = a.numel() + b.numel() + 12 * n
    bms, by = bound_ms(n_bytes, cells * per_cell, clock)
    res = {"pairs": n, "E": E, "infix": infix, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "share": bms / ms, "cells": cells,
           "at_most_E": int((got <= E).sum())}
    say(f"kernel banded_edit {what}: {n} pairs, E={E}, "
        f"{'infix' if infix else 'global'}: max_abs_err {err}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
        f"({by}), share {100 * bms / ms:.1f} %, {cells} cells, "
        f"{res['at_most_E']} pairs within E")
    if err != 0:
        raise AssertionError(f"banded_edit {what} E={E} disagrees with its "
                             f"plain version")
    return res


def banded_phase(device, gbases, clock: float) -> dict:
    """The banded kernel against its plain version on the card at every
    shape of the phase's list; returns the ``kernels`` line's entry (the
    E = 2 global shape, dedupe's) with every shape's result."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.ops import banded_device as bd
    from bbmap_tpu_torch.ops.banded import banded_edit_distance
    _, per_cell = banded_instructions()
    rng = np.random.default_rng(71)

    def stage(A, la, B, lb):
        return (torch.from_numpy(np.ascontiguousarray(A.T)).to(device),
                torch.from_numpy(la).to(device),
                torch.from_numpy(np.ascontiguousarray(B.T)).to(device),
                torch.from_numpy(lb).to(device))
    win = np.lib.stride_tricks.sliding_window_view(gbases, L)
    A = win[rng.integers(0, len(win), BANDED_PAIRS)]
    B, lb = mutate_pairs(rng, A, 6)
    la = np.full(BANDED_PAIRS, L, np.int32)
    args = stage(A, la, B, lb)
    shapes = []
    for E in BANDED_ES:
        for infix in (False, True):
            shapes.append(banded_check(f"{L} bp", device, *args, E, infix,
                                       per_cell, clock))
    for infix in (False, True):
        shapes.append(banded_check(f"{L} bp warp", device, *args,
                                   BANDED_WARP_E, infix, per_cell, clock))
        shapes.append(banded_check(
            f"{L} bp warp, band in memory", device,
            *(x[..., :BANDED_MEM_PAIRS] for x in args), BANDED_MEM_E,
            infix, per_cell, clock, reps=3))
    # dedupe's call: one query (stride 0) against every b
    q, lq = args[0][:, 0].contiguous(), args[1][:1].expand(BANDED_PAIRS)
    shapes.append(banded_check(f"{L} bp one query", device, q, lq,
                               *args[2:], 2, False, per_cell, clock))
    cw = np.lib.stride_tricks.sliding_window_view(gbases, CONTIG_L)
    CA = cw[rng.integers(0, len(cw), CONTIG_PAIRS)]
    CB, clb = mutate_pairs(rng, CA, 2 * CONTIG_E)
    cargs = stage(CA, np.full(CONTIG_PAIRS, CONTIG_L, np.int32), CB, clb)
    for infix in (False, True):
        shapes.append(banded_check(f"{CONTIG_L} bp contigs", device,
                                   *cargs, CONTIG_E, infix, per_cell, clock,
                                   reps=5))
    # the first pairs at E = 2 against the numpy band sweep
    got = bd.banded_edit(*(x[..., :BANDED_NUMPY_PAIRS] for x in args), 2)
    sweep = np.array([min(banded_edit_distance(A[t], B[t, :lb[t]], 2), 3)
                      for t in range(BANDED_NUMPY_PAIRS)], np.int32)
    err = int(np.abs(got.cpu().numpy() - sweep).max())
    say(f"kernel banded_edit {BANDED_NUMPY_PAIRS} pairs, E=2 against the "
        f"numpy band sweep: max_abs_err {err}")
    if err != 0:
        raise AssertionError("banded_edit disagrees with the numpy sweep")
    main = shapes[2]                     # E = 2, global: dedupe's e=2
    blocks = []
    for k, Q, what in ((BANDED_PAIRS, BLOCK_QUERIES_TABLE, "the table's"),
                       (DEDUPE_CLASS, BLOCK_QUERIES, "dedupe's"),
                       (1_000, BLOCK_QUERIES, "a small class")):
        cls = A[:k]
        near, nlb = mutate_pairs(rng, cls[rng.integers(0, k, Q // 2)], 3)
        qs = [near[i, :nlb[i]] for i in range(Q // 2)] + list(
            win[rng.integers(0, len(win), Q - Q // 2)])
        s_, ls = bd.upload_block(list(cls), device)
        q, lq = bd.upload_block(qs, device)
        # past BLOCK_MAX_E (the small class only) a banded_edit launch a
        # query, outside the block design
        wide = (bd.BLOCK_MAX_E + 9,) if k == 1_000 else ()
        for E in (0, 2, *wide):
            for tri in (False, True):
                blocks.append(block_check(
                    f"{what} shape, {Q} queries x {k}", device, q, lq,
                    None if tri else s_, None if tri else ls, E, tri,
                    per_cell, clock, reps=3 if E in wide else 20))
            if E == 2:
                blocks.append(block_check(
                    f"{what} shape, {Q} queries x {k}, in place", device, q,
                    lq, s_.contiguous(), ls, E, False, per_cell, clock))
    table = blocks[2]                    # the table's shape, E = 2, class
    any_entry = {"max_abs_err": max(b["max_abs_err"] for b in blocks),
                 "ms": table["ms"], "plain_ms": table["plain_ms"],
                 "bound_ms": table["bound_ms"],
                 "bound_by": table["bound_by"], "library_ms": None,
                 "shapes": blocks}
    return {"max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shapes": shapes}, any_entry


def block_check(what: str, device, q, lq, s, ls, E: int, tri: bool,
                per_cell: float, clock: float, reps: int = 20) -> dict:
    """The block kernel (``banded_any``) against its plain version on the
    same tensors, tolerance 0, timed; the bound from the cells the data
    needs (each pair's rows to saturation or its end, from the plain
    version, over the band width) and the bytes read and written once."""
    from bbmap_tpu_torch.ops import banded_device as bd
    ms, got = _cuda_ms(lambda: bd.banded_any(q, lq, s, ls, E, tri), reps)
    rows = []
    plain_ms, want = _cuda_ms(lambda: bd.banded_any_plain(
        q, lq, s, ls, E, tri, rows_out=rows), 1, warm=False)
    err = _diff(got, want)
    Q = q.shape[1]
    cells = (2 * E + 1) * sum(rows)
    n_bytes = q.shape[0] * Q + 4 * Q + want.numel() + (
        0 if tri else s.shape[0] * s.shape[1] + 4 * s.shape[1])
    bms, by = bound_ms(n_bytes, cells * per_cell, clock)
    mode = "triangle" if tri else "class"
    res = {"what": what, "mode": mode, "queries": Q,
           "sequences": Q if tri else s.shape[1], "E": E,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "share": bms / ms,
           "cells": cells, "hits": int(want.sum())}
    say(f"kernel banded_any {mode} {what}, E={E}: max_abs_err {err}, kernel"
        f" {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}),"
        f" share {100 * bms / ms:.1f} %, {cells} cells, {res['hits']} hits")
    if err != 0:
        raise AssertionError(f"banded_any {what} E={E} disagrees with its "
                             f"plain version")
    return res


def contained_check(what: str, device, q, lq, w, table, tol: int,
                    per_cell: float, clock: float, reps: int = 20) -> dict:
    """The containment kernel (``contained_any``) against its plain version
    on the same tensors, tolerance 0, timed; the bound from the cells the
    data needs (each pair's rows in each orientation to saturation or its
    end, from the plain version, over the band width 4 tol + 1) and the
    bytes read and written once (the queries the table names, the
    windows, the table, the flags)."""
    from bbmap_tpu_torch.ops import banded_device as bd
    ms, got = _cuda_ms(lambda: bd.contained_any(q, lq, w, table, tol), reps)
    rows = []
    plain_ms, want = _cuda_ms(lambda: bd.contained_any_plain(
        q, lq, w, table, tol, rows_out=rows), 1, warm=False)
    err = _diff(got, want)
    P = table.shape[1]
    cols = table[0].long().unique()
    cells = (4 * tol + 1) * rows[-1]
    n_bytes = int(lq[cols].long().sum()) + int(table[2].long().sum()) + \
        table.numel() * 4 + q.shape[1]
    bms, by = bound_ms(n_bytes, cells * per_cell, clock)
    res = {"what": what, "queries": q.shape[1], "queries_with_pairs":
           int(cols.numel()), "pairs": P, "tol": tol, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "share": bms / ms, "cells": cells, "flagged": int(want.sum())}
    say(f"kernel contained_any {what}: {q.shape[1]} queries "
        f"({res['queries_with_pairs']} with pairs), {P} pairs x 2 "
        f"orientations, tol={tol}: max_abs_err {err}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bms:.6f} ms ({by}), share "
        f"{100 * bms / ms:.2f} %, {cells} cells, {res['flagged']} flagged")
    if err != 0:
        raise AssertionError(f"contained_any {what} tol={tol} disagrees with "
                             f"its plain version")
    return res


def contained_block(gbases, rng, tol: int, n_frag: int, device):
    """A block as dedupe's containment check stages it: BLOCK_QUERIES reads
    of L bp from the genome, the first n_frag of them fragments of 60-120
    bp of other reads (half reverse-complemented, some with a
    substitution or an indel), each with the window dedupe cuts around its
    offset (+- tol, clipped at the container's ends) and three windows of
    other reads at random offsets. Returns (q, lq, w, table) on device."""
    import numpy as np
    from bbmap_tpu_torch.core.bases import COMP_ASCII
    from bbmap_tpu_torch.ops import banded_device as bd
    win = np.lib.stride_tricks.sliding_window_view(gbases, L)
    reads = list(win[rng.integers(0, len(win), BLOCK_QUERIES)])
    conts = win[rng.integers(0, len(win), 4 * n_frag)]
    cols, wins = [], []
    for r in range(n_frag):
        c = conts[r]
        n = int(rng.integers(60, 121))
        q0 = int(rng.integers(0, L - n + 1))
        frag, fl = mutate_pairs(rng, c[None, q0:q0 + n], 1)
        frag = frag[0, :fl[0]]
        reads[r] = COMP_ASCII[frag[::-1]] if r % 2 else frag
        for k, cc in enumerate((c, *conts[n_frag + 3 * r:n_frag + 3 * r + 3])):
            at = q0 if k == 0 else int(rng.integers(0, L - n + 1))
            cols.append(r)
            wins.append(cc[max(0, at - tol):min(L, at + n + tol)])
    q, lq = bd.upload_block(reads, device)
    return (q, lq, *bd.upload_windows(cols, wins, device))


def contained_phase(device, gbases, clock: float) -> list:
    """The containment kernel against its plain version on the card at
    dedupe's block shape, tol 2 (a thread an orientation of a pair, 9 band
    cells) and tol 16 (the warp body, 65 cells); the shapes' results."""
    import numpy as np
    _, per_cell = banded_instructions()
    rng = np.random.default_rng(73)
    return [contained_check(f"{BLOCK_QUERIES}-read block, {n} fragments",
                            device, *contained_block(gbases, rng, tol, n,
                                                     device), tol,
                            per_cell, clock)
            for tol, n in ((2, CONTAINED_FRAGMENTS), (16, CONTAINED_FRAGMENTS))]


def dedupe_reads(gbases, n: int, seed: int):
    """A read library of n reads from a window of the genome at ~3x
    (150 bp; reads overlap): about 60 % distinct, 10 % exact copies, 8 %
    reverse-complement copies, 10 % near copies (1-2 substitutions or
    indels) and 12 % contained fragments of 60-120 bp (some
    reverse-complemented, some with a substitution). Returns [(name,
    bases)]."""
    import numpy as np
    from bbmap_tpu_torch.core.bases import COMP_ASCII
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n0 = int(0.6 * n)
    base = genome_reads(gbases, n0, 500_000, 50 * n, seed)
    recs = [(f"u{i}", bytes(r)) for i, r in enumerate(base)]
    for k in range(n - n0):
        src = base[int(rng.integers(0, n0))]
        u = rng.random()
        if u < 0.25:
            seq, kind = src, "x"
        elif u < 0.45:
            seq, kind = COMP_ASCII[src[::-1]], "rc"
        elif u < 0.7:
            seq, kind = src.copy(), "near"
            for _ in range(int(rng.integers(1, 3))):
                p, op = int(rng.integers(5, len(seq) - 5)), rng.integers(0, 3)
                if op == 0:
                    seq = seq.copy()
                    seq[p] = acgt[(int(np.searchsorted(acgt, seq[p])) + 1)
                                  % 4]
                elif op == 1:
                    seq = np.insert(seq, p, acgt[int(rng.integers(0, 4))])
                else:
                    seq = np.delete(seq, p)
        else:
            f = int(rng.integers(60, 121))
            s = int(rng.integers(0, L - f + 1))
            seq, kind = src[s:s + f].copy(), "frag"
            if rng.random() < 0.5:
                seq = COMP_ASCII[seq[::-1]]
            if rng.random() < 0.3:
                p = int(rng.integers(0, f))
                seq[p] = acgt[(int(np.searchsorted(acgt, seq[p])) + 1) % 4]
        recs.append((f"{kind}{k}", bytes(seq)))
    order = rng.permutation(len(recs))
    return [recs[i] for i in order]


def _fastq_recs(path, recs, seed: int) -> None:
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        for name, seq in recs:
            q = (rng.integers(20, 41, len(seq)) + 33).astype(np.uint8)
            fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                     + q.tobytes() + b"\n")


def dedupe_runs() -> dict:
    """dedupe's CLI runs card vs CPU: key -> (tool, arguments); {d} is the
    inputs' directory, {o} the run's output directory."""
    io_ = ["in={d}/lib.fq", "out={o}/u.fq", "outd={o}/dup.fq"]
    return {"dedupe e=2": ("dedupe", [*io_, "e=2", "ac=f"]),
            "dedupe s=2 ac=t": ("dedupe", [*io_, "s=2", "ac=t"]),
            "dedupe fo=t c=t": ("dedupe", [
                *io_, "fo=t", "c=t", "mo=100", "csf={o}/stats.txt",
                "dot={o}/graph.dot", "pattern={o}/cluster_%.fq"]),
            "dedupe2 nam=2": ("dedupe2", [*io_, "nam=2", "e=1", "ac=t"])}


def variant_runs() -> dict:
    """The mapper variants' runs card vs CPU, as ``dedupe_runs``."""
    pairs = ["in={d}/small1.fq", "in2={d}/small2.fq"]
    sam = ["ref={d}/ref.fa", *pairs, "out={o}/out.sam", "nodisk"]
    return {"bbmapacc": ("bbmapacc", sam), "bbmap5": ("bbmap5", sam),
            "bbmapskimmer": ("bbmapskimmer", sam),
            "bbsplit": ("bbsplit", ["ref={d}/setA.fa,{d}/setB.fa", *pairs,
                                    "basename={o}/out_%.fq",
                                    "refstats={o}/refstats.txt"])}


def _files(o: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(o.iterdir())}


def cli_card(device, o: Path, tool: str, args, tags: dict = None) -> dict:
    """``tool`` on the card in this process: its report (without wall
    times, each path of ``tags``, by default {"{o}": o}, replaced by its
    tag), output files, wall, kcount's calls and every kernel's
    launches."""
    from bbmap_tpu_torch.index import kcount
    reset_counts()
    kcount.reset_calls()
    w = time.time()
    rc, report = run_tool(tool, list(args) + [f"device={device}"])
    _sync(device)
    wall = time.time() - w
    if rc != 0:
        raise AssertionError(f"{tool} device={device} exited {rc}: {report}")
    return {"report": _report_lines(report, tags or {"{o}": o}),
            "files": _files(o), "wall_s": wall,
            "kcount_calls": dict(kcount.calls), "launches": launch_counts()}


# a CLI run on the CPU that also writes kcount's calls (argv[1]) as JSON
_COUNTED_CLI = """
import json, sys
from bbmap_tpu_torch.__main__ import main
from bbmap_tpu_torch.index import kcount
calls, sys.argv = sys.argv[1], ["bbmap_tpu_torch", *sys.argv[2:]]
try:
    rc = main()
finally:
    with open(calls, "w") as fh:
        json.dump(dict(kcount.calls), fh)
raise SystemExit(rc)
"""


class CpuRun:
    """``python -m bbmap_tpu_torch <tool> ... device=cpu`` in a process of
    its own (one thread, no card), started now; ``finish`` waits for it and
    returns what ``cli_card`` returns but the launches, and kcount's calls
    only where ``calls`` names the file the process writes them to."""

    def __init__(self, o: Path, tool: str, args, tags: dict = None,
                 calls: Path = None):
        import threading
        self.o, self.tool, self.calls = o, tool, calls
        self.tags = tags or {"{o}": o}
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        head = ["-m", "bbmap_tpu_torch"] if calls is None \
            else ["-c", _COUNTED_CLI, str(calls)]
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, *head, tool, *args, "device=cpu"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.done = {}
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self):
        self.done["out"] = self.proc.communicate()
        self.done["t1"] = time.time()

    def finish(self, timeout: float) -> dict:
        self.waiter.join(timeout)
        if self.waiter.is_alive():
            raise AssertionError(f"{self.tool} device=cpu did not end in "
                                 f"{timeout:.0f} s")
        _, err = self.done["out"]
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.tool} device=cpu exited "
                                 f"{self.proc.returncode}: {err[-2000:]}")
        # the process's own one-time note that the native host library
        # did not load (this process printed its own at its first use)
        from bbmap_tpu_torch.io import native
        note = native.__name__ + ":"
        report = "\n".join(ln for ln in err.splitlines()
                           if not ln.startswith(("Time:", note)))
        out = {"report": _report_lines(report, self.tags),
               "files": _files(self.o), "wall_s": self.done["t1"] - self.t0}
        if self.calls is not None:
            out["kcount_calls"] = json.loads(self.calls.read_text())
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def cli_compare(key: str, card: dict, cpu: dict) -> dict:
    """Raise unless the card's and the CPU's runs wrote the same files
    and reports; the comparison's summary."""
    if card["report"] != cpu["report"]:
        raise AssertionError(f"{key}: the reports differ:\n{card['report']}"
                             f"\n---\n{cpu['report']}")
    fc, fh = card["files"], cpu["files"]
    if sorted(fc) != sorted(fh) or not fc:
        raise AssertionError(f"{key}: output files {sorted(fc)} on the card,"
                             f" {sorted(fh)} on the CPU")
    for name in fc:
        if fc[name] != fh[name]:
            raise AssertionError(f"{key}: {name} differs between the card "
                                 f"and the CPU")
    say(f"{key}: byte-equal card vs CPU, {len(fc)} files, card "
        f"{card['wall_s']:.2f} s, CPU {cpu['wall_s']:.2f} s (a process "
        f"of its own, one thread, beside the others); "
        + "; ".join(card["report"].splitlines()[-3:]))
    return {"files": len(fc), "bytes": sum(len(v) for v in fc.values()),
            "wall_s": card["wall_s"], "wall_cpu_s": cpu["wall_s"],
            "launches": {k: v for k, v in card["launches"].items() if v}}


def variant_inputs(gbases, d: Path) -> None:
    """The variants' references (a slice of the genome, and the slice cut
    into two sets for bbsplit, and the whole genome) and randomreads pairs:
    N_VARIANT_PAIRS from the slice and N_VARIANT_BIG from the genome."""
    from bbmap_tpu_torch.tools import randomreads
    at = 1_500_000
    ref = gbases[at:at + VARIANT_REF_BP]
    half = VARIANT_REF_BP // 2
    write_fasta(d / "ref.fa", "slice", ref)
    write_fasta(d / "setA.fa", "a", ref[:half])
    write_fasta(d / "setB.fa", "b", ref[half:])
    write_fasta(d / "genome.fa", "ecoli_like", gbases)
    for name, refname, n, seed in (("small", "ref.fa", N_VARIANT_PAIRS, 31),
                                   ("big", "genome.fa", N_VARIANT_BIG, 37)):
        if randomreads.main([
                f"ref={d / refname}", f"out={d / name}1.fq",
                f"out2={d / name}2.fq", f"reads={n}", "length=150",
                "paired=t", "snprate=0.3", "maxsnps=3", "insrate=0.05",
                "delrate=0.05", f"seed={seed}"]) != 0:
            raise AssertionError("randomreads failed")


# the containment check of the design before the block mapping, at
# 50,000 reads of this library on an NVIDIA H100 80GB HBM3 (700 W): two
# banded_edit launches and a fetch a read, and a check's time
CONTAINMENT_BEFORE = {"launches": 5_466, "check_ms": 0.3909}


def dedupe_big(device, d: Path, clock: float) -> dict:
    """dedupe e=2 ac=t over N_DEDUPE_BIG reads on the card: reads/s over
    the CLI's wall, every kernel's launches (the store check's by length
    class and triangle, the containment check's by site: a launch of the
    containment kernel a block, and the in-block checks' ``banded_edit``
    launches), the kept reads' length classes and their bytes on the card,
    and the kernels' share of the wall reckoned from timings at the run's
    end: a block of the library's reads checked against every kept read (a
    launch a near class and the triangle, ``tools/dedupe.BLOCK`` reads), a
    block's containment check (the windows' upload, the launch and a
    fetch) on the pairs of the run's median block, held to the plain
    version, and one in-block check (two launches and their fetch)."""
    import numpy as np
    import torch
    from bbmap_tpu_torch.ops import banded_device as bd
    from bbmap_tpu_torch.tools import dedupe
    reset_counts()
    real, calls = bd.contained_any, []

    def spy(q, lq, w, table, tol):
        calls.append((q, lq, w, table, tol))
        return real(q, lq, w, table, tol)
    # the wrapper counts through its module name: the spy shares its counts
    spy.__dict__ = real.__dict__
    bd.contained_any = spy
    t0 = time.time()
    try:
        rc, report = run_tool("dedupe", [f"in={d}/big.fq",
                                         f"out={d}/big_u.fq", "e=2", "ac=t",
                                         f"device={device}"])
        _sync(device)
    finally:
        bd.contained_any = real
    wall = time.time() - t0
    launches = launch_counts()
    by_site = dict(bd.banded_edit.launches_by_site)
    by_mode = dict(bd.banded_any.launches_by)
    cont_pairs = real.pairs
    n_blocks = -(-N_DEDUPE_BIG // dedupe.BLOCK)
    if rc != 0 or not launches["banded_any"]:
        raise AssertionError(f"dedupe at {N_DEDUPE_BIG} reads: rc {rc}, "
                             f"{launches['banded_any']} block launches: "
                             f"{report}")
    if launches["banded_edit"] != by_site["containment_in_block"]:
        raise AssertionError(f"banded_edit launched by another caller than "
                             f"the in-block containment check: {by_site}")
    if not 0 < launches["contained_any"] <= n_blocks:
        raise AssertionError(f"{launches['contained_any']} launches of the "
                             f"containment kernel in {n_blocks} blocks")
    pairs = sorted((c[3].shape[1], k) for k, c in enumerate(calls))
    median = calls[pairs[len(pairs) // 2][1]]
    _, per_cell = banded_instructions()
    cont = contained_check(f"dedupe's median block ({len(calls)} launches)",
                           device, *median, per_cell, clock)
    del calls
    store = bd.SequenceStore(device)
    kept = [np.frombuffer(x, np.uint8) for x in
            (d / "big_u.fq").read_bytes().split(b"\n")[1::4]]
    q, lq = bd.upload_block(kept, device)
    store.append(q, lq, [len(x) for x in kept], list(range(len(kept))))
    del q, lq
    reads = [np.frombuffer(x, np.uint8) for x in
             (d / "big.fq").read_bytes().split(b"\n")[1::4]]
    block = reads[:dedupe.BLOCK]
    lengths = [len(x) for x in block]
    q, lq = bd.upload_block(block, device)
    near = store.near(lengths, 2)

    def check():
        flags = store.check(q, lq, lengths, 2)
        tri = bd.banded_any(q, lq, None, None, 2, tri=True)
        return torch.cat([flags[None, :], tri]).cpu()
    ms_block, _ = _cuda_ms(check, 10)
    # a block's containment check as dedupe makes it on the median block's
    # pairs: the windows' pinned upload, one launch and a fetch
    mq, mlq, mw, mtable, _ = median
    cols, mt = mtable[0].tolist(), mtable.cpu()
    wins = [mw[:int(mt[2, k]), k].cpu().numpy() for k in range(mt.shape[1])]
    t1 = time.time()
    for _ in range(20):
        bd.contained_any(mq, mlq, *bd.upload_windows(cols, wins, device),
                         2).cpu()
    ms_cblock = 1e3 * (time.time() - t1) / 20
    lens = np.array([len(x) for x in kept])
    Lc = int(np.bincount(lens).argmax())
    arr = next(x for x in kept if len(x) == Lc)
    wins = [x for x in kept[:64] if len(x) >= Lc - 4][:8]
    t1 = time.time()
    for _ in range(20):
        bd.contained_distances(arr, wins, 2, device=device)
        bd.contained_distances(arr[::-1].copy(), wins, 2, device=device)
    ms_contain = 1e3 * (time.time() - t1) / 20
    in_block = by_site["containment_in_block"]
    kernel_s = 1e-3 * (n_blocks * ms_block
                       + launches["contained_any"] * ms_cblock
                       + in_block / 2 * ms_contain)
    held = sum(c[0].numel() for c in store.classes.values())
    big = {"reads": N_DEDUPE_BIG, "wall_s": wall,
           "reads_per_s": N_DEDUPE_BIG / wall, "block": dedupe.BLOCK,
           "launches": launches["banded_any"] + launches["banded_edit"]
           + launches["contained_any"],
           "store_check_launches": launches["banded_any"],
           "store_check_by_mode": by_mode,
           "containment_launches": {"block": launches["contained_any"],
                                    "in_block": in_block},
           "containment_pairs": cont_pairs,
           "containment_before": CONTAINMENT_BEFORE,
           "kernel_launches": launches, "kept": len(kept),
           "classes": len(store.classes), "store_bytes": held,
           "kept_bytes": int(lens.sum()), "block_near_classes": len(near),
           "block_check_ms_at_all_kept": ms_block,
           "containment_block_ms": ms_cblock,
           "containment_in_block_check_ms": ms_contain,
           "contained_check": cont,
           "kernel_s_reckoned": kernel_s, "kernel_share": kernel_s / wall}
    say(f"dedupe e=2 ac=t at {N_DEDUPE_BIG} reads on the card: "
        f"{big['reads_per_s']:.1f} reads/s ({wall:.2f} s), blocks of "
        f"{dedupe.BLOCK}: store check {launches['banded_any']} launches "
        f"{big['store_check_by_mode']}; containment check "
        f"{launches['contained_any']} block launches "
        f"({cont_pairs} pairs) and {in_block} in-block banded_edit launches"
        f" (before the block mapping: {CONTAINMENT_BEFORE['launches']} "
        f"launches); {len(kept)} kept "
        f"in {len(store.classes)} length classes ({held} B on the card for "
        f"{big['kept_bytes']} B of reads); a block's check against every "
        f"kept read ({len(near)} near classes and the triangle, one fetch)"
        f" {ms_block:.4f} ms, a block's containment check (upload, launch, "
        f"fetch; {median[3].shape[1]} pairs) {ms_cblock:.4f} ms, an in-block"
        f" check {ms_contain:.4f} ms (before: "
        f"{CONTAINMENT_BEFORE['check_ms']} ms a check a read): the kernels "
        f"at most {kernel_s:.2f} s of {wall:.2f} s "
        f"({100 * kernel_s / wall:.1f} %); "
        + "; ".join(report.splitlines()[-3:]))
    del store, q, lq
    torch.cuda.empty_cache()
    return big


def grade_paired(sam_path, keep: bool = False) -> dict:
    """gradesam's grading (``parse_custom``, ``cigar_spans``) of a paired
    run on randomreads' names, whose contig field carries the pair's
    ``_insert=N`` suffix, so that ``gradesam.grade`` finds no contig right;
    the genome is one contig, and it is not compared: primary alignments,
    mapped, strict (start and stop exact) and within 20 bp (start or
    stop), on the strand. ``keep``:
    also each primary line's (correct, flag, pos, mapq, cigar) by name and
    mate, as "lines"."""
    from bbmap_tpu_torch.tools import gradesam
    s = dict(primary=0, mapped=0, strict=0, loose=0)
    lines = {}
    with open(sam_path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t")
            flag = int(f[1])
            if flag & 0x900:
                continue
            s["primary"] += 1
            truth = gradesam.parse_custom(f[0])
            if truth is None:
                raise AssertionError(f"unparsed read name {f[0]}")
            _, tstrand, tstart, tstop, trel, _ = truth
            ok = False
            if not flag & 0x4:
                s["mapped"] += 1
                lead, span, trail, _ = gradesam.cigar_spans(f[5])
                start = int(f[3]) - 1 - lead
                stop = start + lead + span + trail - 1
                on = (1 if flag & 0x10 else 0) == tstrand
                cstop = trel + tstop - tstart
                s["strict"] += on and start == trel and stop == cstop
                ok = on and (abs(start - trel) <= 20
                             or abs(stop - cstop) <= 20)
                s["loose"] += ok
            if keep:
                lines[(f[0], flag & 0xC0)] = (ok, flag, int(f[3]), int(f[4]),
                                              f[5])
    if keep:
        s["lines"] = lines
    return s


def variants_big(device, d: Path) -> dict:
    """bbmap, bbmapacc and bbmapskimmer over N_VARIANT_BIG pairs on the
    card: reads/s over each CLI's mapping time, accuracy, every kernel's
    launches; the reads that bbmap and bbmapacc grade apart, printed."""
    import re
    from bbmap_tpu_torch.ops import msa_kernels as mk
    big, lines = {}, {}
    for tool in ("bbmap", "bbmapacc", "bbmapskimmer"):
        o = d / f"big_{tool}.sam"
        reset_counts()
        mk.LAUNCH_SHAPES = {}
        t0 = time.time()
        try:
            rc, report = run_tool(tool, [
                f"ref={d}/genome.fa", f"in={d}/big1.fq", f"in2={d}/big2.fq",
                f"out={o}", f"device={device}"], keep_time=True)
            _sync(device)
        finally:
            shapes, mk.LAUNCH_SHAPES = mk.LAUNCH_SHAPES, None
        wall = time.time() - t0
        launches = launch_counts()
        if rc != 0:
            raise AssertionError(f"{tool} exited {rc}: {report}")
        # the CLI's own mapping time (the index build and SAM header not
        # in it), as the long-read phase reads it
        m = re.search(r"Time:\s*([0-9.]+) seconds", report)
        if m is None:
            raise AssertionError(f"{tool} reported no mapping time")
        s = grade_paired(o, keep=tool != "bbmapskimmer")
        lines[tool] = s.pop("lines", None)
        n = max(1, s["primary"])
        map_s = float(m.group(1))
        big[tool] = {"pairs": N_VARIANT_BIG, "wall_s": wall, "map_s": map_s,
                     "reads_per_s": 2 * N_VARIANT_BIG / map_s,
                     "sensitivity": s["loose"] / n,
                     "strict": s["strict"] / n,
                     "mapped_fraction": s["mapped"] / n,
                     "launches": launches,
                     "dp_shapes": [[*key, k] for key, k in sorted(
                         shapes.items())]}
        say(f"{tool} at {N_VARIANT_BIG} pairs on the card: "
            f"{big[tool]['reads_per_s']:.1f} reads/s over its mapping "
            f"time {map_s:.3f} s (wall with the index's load "
            f"{wall:.2f} s), "
            f"sensitivity (within 20 bp) {big[tool]['sensitivity']:.4f}, "
            f"strict {big[tool]['strict']:.4f}, mapped "
            f"{big[tool]['mapped_fraction']:.4f}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        o.unlink()
    base, acc = lines["bbmap"], lines["bbmapacc"]
    lost = sorted(k for k in base if base[k][0] and not acc[k][0])
    won = sorted(k for k in base if acc[k][0] and not base[k][0])
    say(f"bbmapacc against bbmap on the same {2 * N_VARIANT_BIG} reads: "
        f"{len(won)} graded correct by bbmapacc alone, {len(lost)} by bbmap "
        f"alone")
    for k in lost + won:
        say(f"  {k[0]} mate {k[1] >> 6}: bbmap {base[k]}, bbmapacc {acc[k]}")
    big["acc_only_correct"], big["bbmap_only_correct"] = len(won), len(lost)
    # bbmapacc must map at least as many reads as bbmap and must not be
    # less sensitive beyond chance: of the reads the two grade apart
    # (placements on another copy of a repeat family, both ways), bbmap's
    # surplus stays within 3 sigma of a fair sign test. On these reads the
    # JAX tools place them so too, and the port writes their SAM lines
    # (tests/test_torch_mapvariants.py::test_acc_apart_as_the_jax_tools)
    acc, base = big["bbmapacc"], big["bbmap"]
    if acc["mapped_fraction"] < base["mapped_fraction"] or \
            len(lost) - len(won) > 3 * (len(lost) + len(won)) ** 0.5:
        raise AssertionError(
            f"bbmapacc below bbmap: mapped {acc['mapped_fraction']} against "
            f"{base['mapped_fraction']}, {len(lost)} reads correct by bbmap "
            f"alone against {len(won)} by bbmapacc alone")
    return big


def dedupe_variants_phase(device, gbases, clock: float) -> tuple:
    """The CLIs card vs CPU (dedupe and dedupe2 over N_DEDUPE_CLI reads,
    the four mapper variants over N_VARIANT_PAIRS pairs): the CPU sides
    each in a process of its own, all started first, beside the card's
    runs in this process, then compared file by file; bbmap on the card
    before and after bbmapacc (the same SAM). Then, with those processes
    ended: the banded kernel against its plain version at every shape of
    the phase's list, dedupe over N_DEDUPE_BIG reads and the variants over
    N_VARIANT_BIG pairs on the card. Returns (the banded kernel's, the
    block kernel's and the containment kernel's entries, {dedupe runs,
    "big"}, {variant runs, "big"})."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dedupe")
    cpu_runs = {}
    try:
        d = Path(tmp)
        dd_in, vv_in = d / "dedupe", d / "variants"
        dd_in.mkdir()
        vv_in.mkdir()
        _fastq_recs(dd_in / "lib.fq", dedupe_reads(gbases, N_DEDUPE_CLI,
                                                   81), 82)
        _fastq_recs(dd_in / "big.fq", dedupe_reads(gbases, N_DEDUPE_BIG,
                                                   91), 92)
        variant_inputs(gbases, vv_in)
        # the genome's index, built and saved beside the reference by a
        # bbmap run on the CPU over four pairs, beside the CLI runs, for
        # the card's runs at N_VARIANT_BIG pairs to load
        (vv_in / "warm").mkdir()
        (vv_in / "warm.fq").write_bytes(b"\n".join(
            (vv_in / "small1.fq").read_bytes().split(b"\n")[:16]) + b"\n")
        cpu_runs["index"] = CpuRun(vv_in / "warm", "bbmap", [
            f"ref={vv_in}/genome.fa", f"in={vv_in}/warm.fq",
            f"out={vv_in}/warm/out.sam"])
        runs = {key: (dd_in, *r) for key, r in dedupe_runs().items()}
        runs.update({key: (vv_in, *r) for key, r in variant_runs().items()})
        outs = {}
        for key, (src, tool, template) in runs.items():
            tag = key.replace(" ", "_").replace("=", "")
            outs[key] = (d / f"{tag}_card", d / f"{tag}_cpu")
            for o in outs[key]:
                o.mkdir()
            cpu_runs[key] = CpuRun(outs[key][1], tool,
                                   [a.format(d=src, o=outs[key][1])
                                    for a in template])
        card = {}
        for key, (src, tool, template) in runs.items():
            o = outs[key][0]
            card[key] = cli_card(device, o, tool, [a.format(d=src, o=o)
                                                   for a in template])
        sams = []
        for tool in ("bbmap", "bbmapacc", "bbmap"):
            o = d / f"order_{len(sams)}"
            o.mkdir()
            r = cli_card(device, o, tool, [
                f"ref={vv_in}/ref.fa", f"in={vv_in}/small1.fq",
                f"in2={vv_in}/small2.fq", f"out={o}/out.sam", "nodisk"])
            sams.append(r["files"]["out.sam"])
        if sams[0] != sams[2]:
            raise AssertionError("bbmap after bbmapacc in one process wrote "
                                 "another SAM than bbmap before it")
        say("bbmap after bbmapacc in one process: the SAM of bbmap before it")
        dd, vv = {}, {}
        for key, (src, tool, template) in runs.items():
            res = cli_compare(key, card[key], cpu_runs[key].finish(900))
            if any(a.startswith("e=") for a in template) and not \
                    res["launches"].get("banded_any"):
                raise AssertionError(f"{key}: the block kernel never "
                                     f"launched")
            if tool == "bbsplit" and not {"out_setA.fq", "out_setB.fq"} <= \
                    set(card[key]["files"]):
                raise AssertionError(f"bbsplit binned into "
                                     f"{sorted(card[key]['files'])}")
            (dd if src == dd_in else vv)[key] = res
        cpu_runs["index"].finish(900)
        kt, kany = banded_phase(device, gbases, clock)
        kcont = contained_phase(device, gbases, clock)
        dd["big"] = dedupe_big(device, dd_in, clock)
        vv["big"] = variants_big(device, vv_in)
        vv["onerow_at_cli_shapes"], vv["cli_shapes_max_abs_err"] = \
            onerow_at_cli_shapes(device, gbases, vv["big"])
    finally:
        for r in cpu_runs.values():
            r.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    # the containment kernel's entry: its check on dedupe's median block,
    # beside the kernel phase's shapes
    c = dd["big"]["contained_check"]
    kcont = {"max_abs_err": max(x["max_abs_err"] for x in [c, *kcont]),
             "ms": c["ms"], "plain_ms": c["plain_ms"],
             "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
             "library_ms": None, "shapes": [*kcont, c]}
    return kt, kany, kcont, dd, vv


def onerow_at_cli_shapes(device, gbases, big: dict) -> tuple:
    """The one-row and pipe launches of bbmap, bbmapacc and bbmapskimmer
    over N_VARIANT_BIG pairs as a histogram by (jobs, R, C), and K2 timed
    at each score shape in the pipe, one-row and (where it holds R) warp
    mappings on bench-like jobs, every mapping's out held to the plain
    version's (tolerance 0): the jobs of each window made once at the
    largest job count, the plain version run once on them, a shape of n
    jobs their first n. Returns ([[tool, wrapper, mapping, jobs, R, C,
    launches], ...], {kernels line name: max_abs_err}) and prints the
    times."""
    from bbmap_tpu_torch.core.constants import SHORT_PROFILE
    from bbmap_tpu_torch.ops import msa_kernels as mk
    hist = [[tool, *row] for tool in ("bbmap", "bbmapacc", "bbmapskimmer")
            for row in big[tool]["dp_shapes"] if row[1] in ("row", "pipe")]
    for row in hist:
        say(f"one-row launches {row[0]}: {row[1]} {row[2]} {row[3]} jobs x "
            f"({row[4]}, {row[5]}): {row[6]}")
    shapes = sorted({tuple(r[3:6]) for r in hist if r[1] == "msa_score"})
    totals = dict.fromkeys(("pipe", "row", "warp"), 0.0)
    err = {}
    for R, C in sorted({(R, C) for _, R, C in shapes}):
        top = max(n for n, R_, C_ in shapes if (R_, C_) == (R, C))
        jobs = dp_jobs(gbases, top, R, C, top + C, device)
        want = mk.msa_score_plain(*jobs, SHORT_PROFILE)
        for n in sorted(n for n, R_, C_ in shapes if (R_, C_) == (R, C)):
            a = tuple(x[:n] for x in jobs)
            res = {m: _cuda_ms(lambda: mk.msa_score(*a, SHORT_PROFILE, m),
                               10)
                   for m in ("pipe", "row") + (("warp",) if R <= 319
                                                else ())}
            es = {m: _diff(o, want[:, :n]) for m, (_, o) in res.items()}
            for m, e in es.items():
                name = VARIANT["msa_score", m]
                err[name] = max(err.get(name, 0), e)
            launched = sum(r[6] for r in hist if tuple(r[3:6]) == (n, R, C)
                           and r[1] == "msa_score")
            for m, (t, _) in res.items():
                totals[m] += launched * t
            say(f"time msa_score at a CLI's one-row shape {n} x ({R}, {C}),"
                f" {launched} launches: " + ", ".join(
                    f"{m} {t:.4f} ms" for m, (t, _) in res.items())
                + f", default {mk.launch_shape(R, C, jobs=n).mapping}; "
                f"max_abs_err against the plain version " + ", ".join(
                    f"{m} {e}" for m, e in es.items()))
            if any(es.values()):
                raise AssertionError(f"msa_score at {n} x ({R}, {C}): a "
                                     f"mapping disagrees with the plain "
                                     f"version: {es}")
    say("time msa_score at the CLIs' one-row shapes, launches x ms summed: "
        + ", ".join(f"{m} {t:.2f} ms" for m, t in totals.items()))
    return hist, err


# one run of each host tool module the port copied but misc (whose bbwrap
# the phase runs at size): module -> (tool, arguments); {d} is the
# phase's inputs, {o} the run's own directory
HOST_TOOL_RUNS = {
    "reformat": ("reformat", ["in={d}/small1.fq", "out={o}/r.fa",
                              "qtrim=rl", "trimq=10"]),
    "stats": ("stats", ["in={d}/ref.fa"]),
    "comparesam": ("comparesam", ["in1={d}/card_a.sam",
                                  "in2={d}/cpu_a.sam", "out={o}/diff.sam"]),
    "samtoroc": ("samtoroc", ["in={d}/card_a.sam"]),
    "calctruequality": ("calctruequality", ["in={d}/card_a.sam",
                                            "out={o}/tq.txt"]),
    "clumpify": ("clumpify", ["in={d}/small1.fq", "out={o}/c.fq",
                              "dedupe=t"]),
    "loglog": ("loglog", ["in={d}/small1.fq"]),
    "sketch": ("sketch", ["in={d}/ref.fa", "out={o}/ref.sketch",
                          "size=1000"]),
    "bbcountunique": ("bbcountunique", ["in={d}/small1.fq",
                                        "out={o}/u.txt", "interval=100"]),
    "recluster": ("reclusterbykmer", ["in={d}/few.fq", "out={o}/o.fq"]),
    "idtools": ("idmatrix", ["in={d}/few.fa", "out={o}/m.tsv"]),
    "removesmartbell": ("removesmartbell", ["in={d}/pb.fq",
                                            "out={o}/split.fq"]),
    "smalltools": ("countgc", ["in={d}/ref.fa", "out={o}/gc.txt"]),
    "synth": ("mutategenome", ["in={d}/ref.fa", "out={o}/m.fa",
                               "subrate=0.01", "seed=1"]),
    "barcodes": ("countbarcodes", ["in={d}/codes.fq", "out={o}/c.txt",
                                   "expected=ACGTAC"]),
    "sorttools": ("sortsam", ["in={d}/card_a.sam", "out={o}/s.sam"]),
    "callvariants": ("callvariants", ["in={d}/card_a.sam",
                                      "ref={d}/ref.fa", "out={o}/v.txt"]),
    "pacbio": ("stacksites", ["in={d}/card_a.sam", "out={o}/sites.txt"]),
    "textutils": ("linecount", ["in={d}/card_a.sam"]),
    "liftover": ("liftover", ["chain={d}/a.chain", "in={d}/in.bed",
                              "out={o}/out.bed"]),
}


class _KeptOpen(io.BytesIO):
    """A captured stream that outlives the tools that close stdout."""

    def close(self):
        pass


def run_host_tool(tool: str, args) -> tuple:
    """The port's CLI entry point of ``tool`` in this process: (exit code,
    stdout, stderr)."""
    import importlib
    from bbmap_tpu_torch.__main__ import TOOLS
    module, entry = TOOLS[tool]
    streams = [io.TextIOWrapper(_KeptOpen(), encoding="utf-8",
                                write_through=True) for _ in range(2)]
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = streams
    try:
        rc = getattr(importlib.import_module(module), entry)(list(args))
    finally:
        sys.stdout, sys.stderr = saved
    return (rc, *(s.buffer.getvalue().decode() for s in streams))


def host_tool_inputs(d: Path, gbases) -> None:
    """The small inputs of HOST_TOOL_RUNS beside the variants' (the first
    24 reads of small1.fq as fastq and fasta, PacBio-like reads around a
    SMRTbell adapter, barcoded reads, a chain and a bed file)."""
    from bbmap_tpu_torch.tools.removesmartbell import SMARTBELL
    lines = (d / "small1.fq").read_bytes().split(b"\n")[:96]
    (d / "few.fq").write_bytes(b"\n".join(lines) + b"\n")
    (d / "few.fa").write_bytes(b"".join(
        b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n"
        for i in range(0, 96, 4)))
    g = bytes(gbases[:4000])
    with open(d / "pb.fq", "wb") as fh:
        for i, read in enumerate((g[:300] + SMARTBELL + g[300:550],
                                  g[600:900] + SMARTBELL + g[900:1300]
                                  + SMARTBELL + g[1300:1500], g[2000:2400])):
            fh.write(b"@zmw%d\n%s\n+\n%s\n" % (i, read, b"I" * len(read)))
    with open(d / "codes.fq", "w") as fh:
        for i, code in enumerate(("ACGTAC", "ACGTAC", "ACGTAA", "NNGTAC")):
            fh.write(f"@read{i}:{code}\nACGT\n+\nIIII\n")
    (d / "a.chain").write_text(
        "chain 1000 chrA 300 + 0 100 chrB 200 + 10 110 1\n60\t10\t5\n30\n"
        "\nchain 900 chrA 300 + 200 260 chrC 120 - 20 80 2\n60\n\n")
    (d / "in.bed").write_text("chrA\t5\t15\tx\nchrA\t75\t85\tseg2\n"
                              "chrA\t210\t220\tminus\n")


def _interleave(a: Path, b: Path, out: Path) -> None:
    la, lb = (p.read_bytes().rstrip(b"\n").split(b"\n") for p in (a, b))
    with open(out, "wb") as fh:
        for i in range(0, len(la), 4):
            fh.write(b"\n".join(la[i:i + 4] + lb[i:i + 4]) + b"\n")


def _dp_launched(launches: dict) -> bool:
    """Whether a run launched a K2 (any score mapping) and a fill + walk
    (the fused kernel, or a fill and the walk kernel)."""
    k2 = launches["msa_score"] + launches["msa_score_segments"]
    k3 = sum(launches[n] for n in FILL_WALK.values()) + \
        min(launches["msa_fill"], launches["msa_walk"])
    return k2 > 0 and k3 > 0


def bbwrap_big(device, d: Path) -> dict:
    """bbwrap on the card over the genome: input A the N_VARIANT_BIG pairs
    interleaved (``interleaved=t``: the pair stream), input B their first
    mates (the single-end stream), one bbwrap run each, since bbwrap hands
    every argument to every input. Each input's reads/s over its mapping
    time, grading and launches (the counts set to 0 before A and read
    after each input; "launches", read after B, is the host tools' path)."""
    import re
    out = {}
    reset_counts()
    seen = launch_counts()
    for key, name, extra, reads in (
            ("A", "bigA.fq", ["interleaved=t"], 2 * N_VARIANT_BIG),
            ("B", "big1.fq", [], N_VARIANT_BIG)):
        sam = d / f"big{key}.sam"
        t0 = time.time()
        rc, report = run_tool("bbwrap", [
            f"ref={d}/genome.fa", f"in={d}/{name}", f"out={sam}", *extra,
            f"device={device}"], keep_time=True)
        _sync(device)
        wall = time.time() - t0
        if rc != 0:
            raise AssertionError(f"bbwrap {key} exited {rc}: {report}")
        now = launch_counts()
        launches = {k: now[k] - seen[k] for k in now}
        seen = now
        m = re.search(r"Time:\s*([0-9.]+) seconds", report)
        if m is None:
            raise AssertionError(f"bbwrap {key} reported no mapping time")
        s = grade_paired(sam)
        n = max(1, s["primary"])
        map_s = float(m.group(1))
        out[key] = {"input": name, "reads": reads, "wall_s": wall,
                    "map_s": map_s, "reads_per_s": reads / map_s,
                    "primary": s["primary"],
                    "mapped_fraction": s["mapped"] / n,
                    "sensitivity": s["loose"] / n, "strict": s["strict"] / n,
                    "launches": {k: v for k, v in launches.items() if v}}
        say(f"bbwrap input {key} ({name}{', interleaved' if extra else ''})"
            f" on the card: {reads} reads, {out[key]['reads_per_s']:.1f} "
            f"reads/s over its mapping time {map_s:.3f} s (wall with the "
            f"index's load {wall:.2f} s), mapped "
            f"{out[key]['mapped_fraction']:.4f}, sensitivity (within 20 bp) "
            f"{out[key]['sensitivity']:.4f}, strict "
            f"{out[key]['strict']:.4f}; launches {out[key]['launches']}")
        if s["primary"] != reads:
            raise AssertionError(f"bbwrap {key}: {s['primary']} primary "
                                 f"lines for {reads} reads")
        if not _dp_launched(launches):
            raise AssertionError(f"bbwrap {key} launched no K2 or no fill "
                                 f"+ walk: {out[key]['launches']}")
        if out[key]["mapped_fraction"] < 0.95:
            raise AssertionError(f"bbwrap {key} mapped "
                                 f"{out[key]['mapped_fraction']}")
        sam.unlink()
    out["launches"] = seen
    return out


def host_tools_phase(device, gbases, d: Path = None) -> dict:
    """bbwrap card vs CPU over two single-end inputs of N_VARIANT_PAIRS
    reads (the variants' mate files on the 1 Mbp slice, nodisk), one run
    of each other copied host tool module (HOST_TOOL_RUNS), then bbwrap at
    N_VARIANT_BIG pairs (``bbwrap_big``); a CPU process builds the
    genome's index beside the first two for the last to load. The inputs
    go into ``d`` (which the caller removes) or into a temporary
    directory removed at the end."""
    tmp = None if d is not None else tempfile.mkdtemp(
        prefix="chip_smoke_host")
    cpu_runs = []
    try:
        d = d if tmp is None else Path(tmp)
        t = time.time()
        variant_inputs(gbases, d)
        _interleave(d / "big1.fq", d / "big2.fq", d / "bigA.fq")
        (d / "warm").mkdir()
        (d / "warm.fq").write_bytes(b"\n".join(
            (d / "small1.fq").read_bytes().split(b"\n")[:16]) + b"\n")
        cpu_runs.append(CpuRun(d / "warm", "bbmap", [
            f"ref={d}/genome.fa", f"in={d}/warm.fq",
            f"out={d}/warm/out.sam"]))
        say(f"host tools inputs: {time.time() - t:.1f} s")
        wrap = ["ref={d}/ref.fa", "in={d}/small1.fq,{d}/small2.fq",
                "out={o}/a.sam,{o}/b.sam", "nodisk"]
        outs = {side: d / f"wrap_{side}" for side in ("card", "cpu")}
        for o in outs.values():
            o.mkdir()
        cpu = CpuRun(outs["cpu"], "bbwrap",
                     [a.format(d=d, o=outs["cpu"]) for a in wrap])
        cpu_runs.append(cpu)
        card = cli_card(device, outs["card"], "bbwrap",
                        [a.format(d=d, o=outs["card"]) for a in wrap])
        res = {"bbwrap_cli": cli_compare("bbwrap", card, cpu.finish(900))}
        if not _dp_launched(card["launches"]):
            raise AssertionError("bbwrap on the card launched no K2 or no "
                                 "fill + walk")
        for side, o in outs.items():
            shutil.copy(o / "a.sam", d / f"{side}_a.sam")
        host_tool_inputs(d, gbases)
        res["modules"] = {}
        for module, (tool, template) in HOST_TOOL_RUNS.items():
            o = d / f"mod_{module}"
            o.mkdir()
            t = time.time()
            rc, out, err = run_host_tool(tool, [a.format(d=d, o=o)
                                               for a in template])
            wall = time.time() - t
            size = len(out) + sum(p.stat().st_size for p in o.iterdir())
            if rc != 0 or not size:
                raise AssertionError(f"{module}: {tool} exited {rc} with "
                                     f"{size} bytes of output: {err[-800:]}")
            res["modules"][module] = {"tool": tool, "wall_s": wall,
                                      "output_bytes": size}
            say(f"host tool {module}: {tool} exit 0, {size} bytes of "
                f"output, {wall:.3f} s")
        cpu_runs[0].finish(900)
        res["big"] = bbwrap_big(device, d)
    finally:
        for r in cpu_runs:
            r.stop()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# parallel/: two processes on the one card, the in-process mesh
# ---------------------------------------------------------------------------

N_SHARD_READS = 8_192           # (b): first mates, every rank maps all
SHARD_MAXCHROMLEN = 3_000_000   # the two halves of the genome, two blocks
N_STEP_READS = 8_192            # sharded_score_step: 2 windows a read
N_PAR_TOOLS = 20_000            # (d): reads or pairs, three batches
BBMAP_BATCH = 4096              # bbmap's default batchsize= (pairs)


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _map_time(report: str) -> float:
    """The mapping time of a bbmap report's ``Time:`` line."""
    import re
    m = re.search(r"Time:\s*([0-9.]+) seconds", report)
    if m is None:
        raise AssertionError(f"no mapping time in: {report[-800:]}")
    return float(m.group(1))


class Children:
    """``python -m bbmap_tpu_torch <argv>`` for each argv, started at once
    on the card (the checkout on PYTHONPATH; the kernels' libraries are
    built already), stderr in a file each, ``threads`` CPU threads each
    where given, a thread each noting when it ends; ``finish`` waits for
    all and returns each one's wall and report, and kills every one still
    running when one fails or the time is up."""

    def __init__(self, tag: str, argvs, logdir: Path, threads: int = 0):
        import threading
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        if threads:
            env.update(OMP_NUM_THREADS=str(threads),
                       MKL_NUM_THREADS=str(threads))
        self.tag = tag
        self.logs = [logdir / f"{tag}.{i}.err" for i in range(len(argvs))]
        self.walls = [None] * len(argvs)
        self.procs = []
        self.t0 = time.time()
        for argv, log in zip(argvs, self.logs):
            with open(log, "w") as fh:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bbmap_tpu_torch", *argv],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                    stderr=fh))
        self.waiters = [threading.Thread(target=self._wait, args=(i,),
                                         daemon=True)
                        for i in range(len(argvs))]
        for w in self.waiters:
            w.start()

    def _wait(self, i: int) -> None:
        self.procs[i].wait()
        self.walls[i] = time.time() - self.t0

    def finish(self, timeout: float) -> list:
        try:
            while None in self.walls:
                for i, p in enumerate(self.procs):
                    if self.walls[i] is not None and p.returncode != 0:
                        raise AssertionError(
                            f"{self.tag} process {i} exited "
                            f"{p.returncode}: "
                            f"{self.logs[i].read_text()[-2000:]}")
                if time.time() - self.t0 > timeout:
                    raise AssertionError(f"{self.tag}: not done in "
                                         f"{timeout:.0f} s")
                time.sleep(0.05)
            for i, p in enumerate(self.procs):
                if p.returncode != 0:
                    raise AssertionError(
                        f"{self.tag} process {i} exited {p.returncode}: "
                        f"{self.logs[i].read_text()[-2000:]}")
        finally:
            self.stop()
        return [{"wall_s": w, "report": log.read_text()}
                for w, log in zip(self.walls, self.logs)]

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for w in self.waiters:
            w.join()


@contextlib.contextmanager
def unfused():
    """BBMapAligner's fused programs off in this process: the path a mesh
    or ``shardindex=`` takes, for the one-process run it is held to."""
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    saved = BBMapAligner._use_fused
    BBMapAligner._use_fused = lambda self, L=None: False
    try:
        yield
    finally:
        BBMapAligner._use_fused = saved


def _same_file(what: str, a: Path, b: Path) -> int:
    x, y = a.read_bytes(), b.read_bytes()
    if x != y or not x:
        raise AssertionError(f"{what}: {a.name} ({len(x)} bytes) and "
                             f"{b.name} ({len(y)} bytes) differ")
    return len(x)


SAM_COLUMNS = ("QNAME", "FLAG", "RNAME", "POS", "MAPQ", "CIGAR", "RNEXT",
               "PNEXT", "TLEN", "SEQ", "QUAL")


def _sam_apart(a: Path, b: Path) -> tuple:
    """(records apart, {column or tag: records where it differs}) of two
    SAM files of the same reads in the same order."""
    x, y = (p.read_bytes().decode().split("\n") for p in (a, b))
    if len(x) != len(y):
        raise AssertionError(f"{a.name} and {b.name}: {len(x)} and "
                             f"{len(y)} lines")
    cols = {}
    n = 0
    for u, v in zip(x, y):
        if u == v:
            continue
        n += 1
        fu, fv = u.split("\t"), v.split("\t")
        for i, (p, q) in enumerate(zip(fu, fv)):
            if p != q:
                name = SAM_COLUMNS[i] if i < len(SAM_COLUMNS) else p[:2]
                cols[name] = cols.get(name, 0) + 1
    return n, cols


def striped_pairs(d: Path, o: Path, smi: str) -> dict:
    """(a) bbmap over the variants' N_VARIANT_BIG pairs on the genome (the
    index cache beside it), the default batch of 4,096 pairs, on the
    card: one process, then two (hosts=2, a gloo group, both on cuda:0).
    Reads/s over each CLI's mapping time; the two processes' aggregate
    over the longer of their two times (each counts its wait at the
    barrier). The merged SAM holds as many records as the one process's;
    the records apart are counted by column: the running average pair
    distance (AVERAGE_PAIR_DIST) restarts on each host, so MAPQ moves
    after a host's first batch (in both packages). ``stripes_finish``
    holds the merged SAM (kept as two.sam) to runs that restart the same
    way."""
    common = [f"ref={d}/genome.fa", f"in={d}/big1.fq", f"in2={d}/big2.fq"]
    one = Children("striped_one", [["bbmap", *common, f"out={o}/one.sam"]],
                   o).finish(600)[0]
    coord = f"coordinator=localhost:{_free_port()}"
    two = Children("striped_two", [
        ["bbmap", *common, f"out={o}/two.sam", "hosts=2", f"hostid={h}",
         coord] for h in range(2)], o).finish(600)
    apart, cols = _sam_apart(o / "two.sam", o / "one.sam")
    reads = 2 * N_VARIANT_BIG
    sizes = [min(BBMAP_BATCH, N_VARIANT_BIG - a)
             for a in range(0, N_VARIANT_BIG, BBMAP_BATCH)]
    for h, want in ((0, reads), (1, 2 * sum(sizes[1::2]))):
        if f"Mapped:\t{want} reads" not in two[h]["report"]:
            raise AssertionError(f"striped host {h} did not map {want} "
                                 f"reads: {two[h]['report'][-800:]}")
    _no_leftovers(o)
    t_one = _map_time(one["report"])
    t_two = [_map_time(r["report"]) for r in two]
    res = {"reads": reads, "records_apart": apart, "columns_apart": cols,
           "one_process": {"wall_s": one["wall_s"], "map_s": t_one,
                           "reads_per_s": reads / t_one},
           "two_processes": {"wall_s": [r["wall_s"] for r in two],
                             "map_s": t_two,
                             "reads_per_s": reads / max(t_two)},
           "card": smi}
    say(f"parallel (a) striped bbmap, {reads} reads ({N_VARIANT_BIG} pairs,"
        f" batches of {BBMAP_BATCH} pairs): one process "
        f"{reads / t_one:.1f} reads/s over {t_one:.3f} s of mapping (wall "
        f"{one['wall_s']:.2f} s); two "
        f"processes on the one card {reads / max(t_two):.1f} reads/s in "
        f"aggregate over max({t_two[0]:.3f}, {t_two[1]:.3f}) s (walls "
        f"{two[0]['wall_s']:.2f} / {two[1]['wall_s']:.2f} s); {apart} of "
        f"{reads} records apart from the one process's, by column {cols}; "
        f"card {smi}")
    os.unlink(o / "one.sam")
    return res


def stripes_start(d: Path, o: Path) -> Children:
    """(a)'s oracle, started: each host's stripe of batches (batch b of
    BBMAP_BATCH pairs to host b % 2) written as a pair of FASTQ files, and
    bbmap in one process over each, the two at once on the card."""
    for m in (1, 2):
        lines = (d / f"big{m}.fq").read_bytes().splitlines()
        per = 4 * BBMAP_BATCH
        n_batches = -(-N_VARIANT_BIG // BBMAP_BATCH)
        for h in range(2):
            with open(d / f"stripe{h}_{m}.fq", "wb") as fh:
                for b in range(h, n_batches, 2):
                    fh.write(b"".join(ln + b"\n" for ln in
                                      lines[b * per:(b + 1) * per]))
    return Children("stripes", [
        ["bbmap", f"ref={d}/genome.fa", f"in={d}/stripe{h}_1.fq",
         f"in2={d}/stripe{h}_2.fq", f"out={o}/stripe{h}.sam"]
        for h in range(2)], o, threads=1)


def stripes_finish(ch: Children, o: Path) -> dict:
    """(a)'s oracle, checked: the two stripes' SAM records interleaved by
    batch id (2 x BBMAP_BATCH records a batch), after stripe 0's header,
    byte-equal to the two processes' merged SAM."""
    ch.finish(600)
    heads, bodies = [], []
    for h in range(2):
        lines = (o / f"stripe{h}.sam").read_bytes().split(b"\n")[:-1]
        heads.append([ln for ln in lines if ln.startswith(b"@")])
        bodies.append(lines[len(heads[h]):])
    per = 2 * BBMAP_BATCH
    want = list(heads[0])
    for b in range(-(-N_VARIANT_BIG // BBMAP_BATCH)):
        k = b // 2
        want += bodies[b % 2][k * per:(k + 1) * per]
    if sum(map(len, bodies)) != 2 * N_VARIANT_BIG:
        raise AssertionError(f"the stripes' SAMs hold "
                             f"{[len(x) for x in bodies]} records")
    got = (o / "two.sam").read_bytes()
    if b"\n".join(want) + b"\n" != got:
        raise AssertionError("striped paired bbmap: the merged SAM differs "
                             "from the stripes' one-process runs "
                             "interleaved by batch")
    say(f"parallel (a) striped bbmap paired: the merged SAM ({len(got)} "
        f"bytes) byte-equal to one-process runs over each host's stripe, "
        f"interleaved by batch id")
    for name in ("two.sam", "stripe0.sam", "stripe1.sam"):
        os.unlink(o / name)
    return {"byte_equal_to_stripes": True, "sam_bytes": len(got)}


def _no_leftovers(o: Path) -> None:
    """No SAM shard, sidecar or barrier marker is left beside the merged
    SAM."""
    import re
    left = [p.name for p in o.iterdir()
            if re.search(r"\.shard\d{4}", p.name)
            or p.name.endswith((".done", ".passed"))]
    if left:
        raise AssertionError(f"striped runs left {left}")


def striped_se_start(d: Path, o: Path, hosts: int) -> Children:
    """(a), single-end: the pairs' first mates (N_VARIANT_BIG reads,
    batches of 4,096) in one process or in ``hosts`` processes."""
    common = ["bbmap", f"ref={d}/genome.fa", f"in={d}/big1.fq",
              f"out={o}/se{hosts}.sam"]
    if hosts == 1:
        return Children("striped_se_one", [common], o, threads=2)
    coord = f"coordinator=localhost:{_free_port()}"
    return Children("striped_se_two", [
        [*common, f"hosts={hosts}", f"hostid={h}", coord]
        for h in range(hosts)], o, threads=1)


def striped_se_finish(one: dict, two: list, o: Path, smi: str) -> dict:
    """(a), single-end, checked: host 0's merged SAM byte-equal to the one
    process's (single-end mapping keeps no state across batches)."""
    n_bytes = _same_file("striped single-end bbmap", o / "se2.sam",
                         o / "se1.sam")
    _no_leftovers(o)
    t_one = _map_time(one["report"])
    t_two = [_map_time(r["report"]) for r in two]
    res = {"reads": N_VARIANT_BIG, "sam_bytes": n_bytes, "byte_equal": True,
           "one_process": {"wall_s": one["wall_s"], "map_s": t_one},
           "two_processes": {"wall_s": [r["wall_s"] for r in two],
                             "map_s": t_two}, "card": smi}
    say(f"parallel (a) striped bbmap single-end, {N_VARIANT_BIG} first "
        f"mates: SAM byte-equal to one process ({n_bytes} bytes); mapping "
        f"{t_one:.3f} s in one process (beside the sharded runs), "
        f"{t_two[0]:.3f} / {t_two[1]:.3f} s in two (beside the tools'); "
        f"card {smi}")
    os.unlink(o / "se1.sam")
    os.unlink(o / "se2.sam")
    return res


def _shard_args(d: Path) -> list:
    return [f"ref={d}/genome2.fa", f"in={d}/se.fq", "nodisk",
            f"maxchromlen={SHARD_MAXCHROMLEN}"]


def sharded_bbmap_start(d: Path, o: Path, gbases) -> Children:
    """(b), started: the genome as two scaffolds of half its length, each
    in a chrom block of its own (maxchromlen=), and the first
    N_SHARD_READS first mates of the variants' pairs, single-end; two
    processes with shardindex=t and one with the whole index (the fused
    program), all three at once, nodisk."""
    half = len(gbases) // 2
    with open(d / "genome2.fa", "wb") as fh:
        fh.write(b">a\n" + gbases[:half].tobytes() + b"\n>b\n"
                 + gbases[half:].tobytes() + b"\n")
    lines = (d / "big1.fq").read_bytes().split(b"\n")[:4 * N_SHARD_READS]
    (d / "se.fq").write_bytes(b"\n".join(lines) + b"\n")
    coord = f"coordinator=localhost:{_free_port()}"
    return Children("shardindex", [
        ["bbmap", *_shard_args(d), f"out={o}/sh_two.sam", "hosts=2",
         f"hostid={h}", "shardindex=t", coord] for h in range(2)] + [
        ["bbmap", *_shard_args(d), f"out={o}/sh_fused.sam"]], o, threads=2)


def sharded_bbmap_finish(ch: Children, d: Path, o: Path, device,
                         smi: str) -> dict:
    """(b), checked: host 0's SAM byte-equal to the one-process run on
    the same path (this process, the CLI with the fused programs off: a
    sharded index maps through the unfused path); the SAM records apart
    from the fused one-process run counted; each rank's ``Generated Index
    Shard i/2 (n of N sites)`` a strict part, the two parts summing to
    N."""
    import re
    t = time.time()
    with unfused():
        rc, report = run_tool("bbmap", [*_shard_args(d),
                                        f"out={o}/sh_one.sam",
                                        f"device={device}"], keep_time=True)
    _sync(device)
    one_wall = time.time() - t
    if rc != 0:
        raise AssertionError(f"bbmap (unfused) exited {rc}: {report}")
    *two, fused = ch.finish(600)
    n_bytes = _same_file("shardindex bbmap", o / "sh_two.sam",
                         o / "sh_one.sam")
    apart, cols = _sam_apart(o / "sh_two.sam", o / "sh_fused.sam")
    sites = []
    for h, r in enumerate(two):
        m = re.search(r"Generated Index Shard (\d)/2 \((\d+) of (\d+) "
                      r"sites\)", r["report"])
        if m is None or int(m.group(1)) != h:
            raise AssertionError(f"rank {h} printed no shard line: "
                                 f"{r['report'][-800:]}")
        sites.append((int(m.group(2)), int(m.group(3))))
    total = sites[0][1]
    if sites[1][1] != total or sites[0][0] + sites[1][0] != total \
            or not all(0 < n < total for n, _ in sites):
        raise AssertionError(f"shards are not a partition: {sites}")
    t_one = _map_time(report)
    t_two = [_map_time(r["report"]) for r in two]
    res = {"reads": N_SHARD_READS, "sam_bytes": n_bytes, "byte_equal": True,
           "shard_sites": [n for n, _ in sites], "sites": total,
           "records_apart_from_fused": apart,
           "columns_apart_from_fused": cols,
           "one_process": {"wall_s": one_wall, "map_s": t_one},
           "fused_one_process": {"wall_s": fused["wall_s"],
                                 "map_s": _map_time(fused["report"])},
           "two_processes": {"wall_s": [r["wall_s"] for r in two],
                             "map_s": t_two}, "card": smi}
    say(f"parallel (b) shardindex=t, {N_SHARD_READS} single-end reads on "
        f"the genome as two scaffolds: shards {sites[0][0]} + {sites[1][0]}"
        f" of {total} sites; SAM byte-equal ({n_bytes} bytes) to one "
        f"process on the same (unfused) path; {apart} records apart from "
        f"the fused program's, by column {cols}; mapping {t_two[0]:.3f} / {t_two[1]:.3f} s "
        f"(walls {two[0]['wall_s']:.2f} / {two[1]['wall_s']:.2f} s, beside "
        f"the in-process mesh); one process {t_one:.3f} s; card {smi}")
    for name in ("sh_one.sam", "sh_two.sam", "sh_fused.sam"):
        os.unlink(o / name)
    return res


def mesh_phase(device, gbases, first, d: Path) -> dict:
    """(c) the in-process mesh at full width: (b)'s genome2.fa (the genome
    as two scaffolds, each in a chrom block of its own and padded with N
    as the CLI packs them: an index shards at chrom bounds only, and the
    pads keep chains from straddling them), its k=13 index, and the main
    path's first batch's first mates (N_PAIRS reads of 150 bp) without
    quality (the mesh takes none, as in the JAX package), through
    BBMapAligner(mesh=make_mesh(1, 2, card)) and through the unsharded
    aligner on the same unfused path: every field equal, and each read's
    match string (the fused program's fields are compared and counted
    too; the mesh maps the batch twice, and the second call is the one
    timed); then
    sharded_score_step (K1's entry point) on N_STEP_READS reads against
    two windows each, held to the plain version of K1 on the same jobs.
    The counts from 0 over the mesh's batch and the step are the
    "parallel" path. Then dryrun_multichip(2) on the card."""
    import dataclasses
    import numpy as np
    import torch
    from bbmap_tpu_torch.align.pipeline import BBMapAligner
    from bbmap_tpu_torch.core.constants import SHORT_PROFILE
    from bbmap_tpu_torch.core.genome import build_genome
    from bbmap_tpu_torch.index.build import analyze_index, build_index
    from bbmap_tpu_torch.ops import msa_kernels as mk
    from bbmap_tpu_torch.parallel import sharded

    t = time.time()
    g = build_genome(str(d / "genome2.fa"), max_length=SHARD_MAXCHROMLEN)
    index = build_index(g, 13)
    analyze_index(index, 0.01)
    index_s = time.time() - t
    batch = dataclasses.replace(first[0], quality=None)
    flat = BBMapAligner(g, index, device)
    mb_fused = flat.map_batch_columnar(batch)
    t = time.time()
    with unfused():                             # the mesh's path
        mb_flat = flat.map_batch_columnar(batch)
    _sync(device)
    flat_s = time.time() - t
    del flat
    mesh = sharded.make_mesh(1, 2, device)
    multi = BBMapAligner(g, index, device, mesh=mesh)
    C = L + 24
    rd, rf0, _ = dp_jobs(gbases, N_STEP_READS, L, C, 41, device,
                         var_rows=False)
    _, rf1, _ = dp_jobs(gbases, N_STEP_READS, L, C, 43, device,
                        var_rows=False)
    rf1[::7] = rf0[::7]                         # ties between the shards
    refs = torch.stack([rf0, rf1], dim=1)
    min_score = int(SHORT_PROFILE.max_quality(L) * 0.56)
    step = sharded.sharded_score_step(mesh, L, C)
    t = time.time()
    multi.map_batch_columnar(batch)     # shards the index and uploads it
    _sync(device)
    mesh_first_s = time.time() - t
    reset_counts()
    t = time.time()
    mb = multi.map_batch_columnar(batch)
    _sync(device)
    mesh_s = time.time() - t
    best, shard, n_mapped = step(rd, refs, min_score)
    _sync(device)
    launches = launch_counts()
    fields = ("mapped", "strand", "chrom", "start", "stop", "score",
              "ambiguous")
    for f in fields:
        if not np.array_equal(getattr(mb, f), getattr(mb_flat, f)):
            raise AssertionError(f"mesh: {f} differs from the unsharded "
                                 f"aligner's")
    bad = [i for i in range(batch.size) if mb.match(i) != mb_flat.match(i)]
    if bad:
        raise AssertionError(f"mesh: {len(bad)} match strings differ, "
                             f"first at read {bad[0]}")
    fused_diff = int(sum((getattr(mb, f) != getattr(mb_fused, f)).sum()
                         for f in fields))
    if torch_cuda(device) and not _dp_launched(launches):
        raise AssertionError(f"the mesh's batch launched no K2 or no fill "
                             f"+ walk: {launches}")
    if torch_cuda(device) and launches["msa_score_rows"] == 0:
        raise AssertionError("sharded_score_step launched no K1")
    rows = torch.full((N_STEP_READS,), L, dtype=torch.int32, device=device)
    tp = time.time()
    want = torch.stack([mk.msa_score_plain(rd, refs[:, s], rows,
                                           SHORT_PROFILE)[0]
                        for s in range(2)], dim=1)
    _sync(device)
    plain_ms = 1000 * (time.time() - tp)
    w_best = want.max(dim=1).values
    e = max(_diff(best, w_best),
            _diff(shard, torch.argmax(want, dim=1).to(torch.int32)),
            abs(int(n_mapped) - int((w_best >= min_score).sum())))
    if e != 0:
        raise AssertionError(f"sharded_score_step differs from plain K1 by "
                             f"{e}")
    step_ms = _cuda_ms(lambda: step(rd, refs, min_score), 5)[0] \
        if torch_cuda(device) else float("nan")
    t = time.time()
    sharded.dryrun_multichip(2, device)
    dry_s = time.time() - t
    res = {"reads": batch.size, "index_s": index_s,
           "mesh_first_map_s": mesh_first_s, "mesh_map_s": mesh_s,
           "unsharded_unfused_map_s": flat_s,
           "mapped": int(mb.mapped.sum()),
           "field_values_apart_from_fused": fused_diff,
           "score_step": {"reads": N_STEP_READS, "windows": 2, "R": L,
                          "C": C, "ms": step_ms, "plain_ms": plain_ms,
                          "max_abs_err": e, "mapped": int(n_mapped)},
           "dryrun_multichip_s": dry_s,
           "launches": launches}
    say(f"parallel (c) mesh (1 x 2) on the card: {batch.size} reads "
        f"mapped in {mesh_s:.2f} s (the first call, which shards and uploads"
        f" the index, {mesh_first_s:.2f} s; unsharded, same unfused path, "
        f"{flat_s:.2f} s), every field and match equal; field values "
        f"differing from the fused program's: {fused_diff}; "
        f"sharded_score_step {N_STEP_READS} x 2 windows ({L}, {C}) "
        f"{step_ms:.3f} ms (plain {plain_ms:.1f} ms), max_abs_err {e}; "
        f"dryrun_multichip(2) {dry_s:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return res


def striped_tools(device, d: Path, o: Path, smi: str) -> dict:
    """(d) bbduk (paired filter, k=23 hdist=1, stats=), seal (stats=,
    pattern=, outm=, outu=), bbmerge (out=, outu=, outu2=, ihist=) and
    reformat (paired, ftl=5 qtrim=rl) on N_PAR_TOOLS reads or pairs
    (three batches of 8,192), each at hosts=2 (two processes on the card,
    all eight at once) against hosts=1 in this process on the card: every
    file byte-equal."""
    import numpy as np
    rng = np.random.default_rng(29)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapters, _ = duk_inputs(0)
    refs, seal_reads = seal_inputs(N_PAR_TOOLS)
    with open(d / "p_adapters.fa", "w") as fh:
        for i, s in enumerate(adapters):
            fh.write(f">adapter{i}\n{s.decode()}\n")
    with open(d / "p_refs.fa", "w") as fh:
        for i, s in enumerate(refs):
            fh.write(f">scaf{i}\n{s.decode()}\n")
    n = N_PAR_TOOLS
    r1, r2, q1, q2 = _cli_pairs(rng, n, L, 60, 300, adapters[0],
                                adapters[1])
    _fastq(d / "p_duk1.fq", [f"d{i}/1" for i in range(n)], r1, q1)
    _fastq(d / "p_duk2.fq", [f"d{i}/2" for i in range(n)], r2, q2)
    r1, r2, q1, q2 = _cli_pairs(rng, n, MERGE_L, 110, 190, b"A", b"C")
    _fastq(d / "p_merge1.fq", [f"m{i}/1" for i in range(n)], r1, q1)
    _fastq(d / "p_merge2.fq", [f"m{i}/2" for i in range(n)], r2, q2)
    seal_reads[::10] = rng.choice(acgt, (len(seal_reads[::10]), L))
    _fastq(d / "p_seal.fq", [f"s{i}" for i in range(n)], seal_reads,
           rng.integers(20, 41, seal_reads.shape))
    runs = {
        "bbduk": ["in={d}/p_duk1.fq", "in2={d}/p_duk2.fq", "out={o}/o1.fq",
                  "out2={o}/o2.fq", "outm={o}/m.fq", "ref={d}/p_adapters.fa",
                  "k=23", "hdist=1", "stats={o}/stats.txt"],
        "seal": ["in={d}/p_seal.fq", "ref={d}/p_refs.fa", "k=31",
                 "stats={o}/stats.txt", "pattern={o}/out_%.fq",
                 "outm={o}/m.fq", "outu={o}/u.fq"],
        "bbmerge": ["in1={d}/p_merge1.fq", "in2={d}/p_merge2.fq",
                    "out={o}/merged.fq", "outu={o}/u1.fq", "outu2={o}/u2.fq",
                    "ihist={o}/ihist.txt"],
        "reformat": ["in={d}/p_merge1.fq", "in2={d}/p_merge2.fq",
                     "out={o}/r1.fq", "out2={o}/r2.fq", "ftl=5",
                     "minlength=20", "qtrim=rl", "trimq=12"]}
    children = {}
    for tool, template in runs.items():
        od = o / f"{tool}_two"
        od.mkdir()
        args = [a.format(d=d, o=od) for a in template]
        children[tool] = Children(f"{tool}_two", [
            [tool, *args, "hosts=2", f"hostid={h}"] for h in range(2)], o,
            threads=1)
    res = {}
    try:
        for tool, template in runs.items():
            od = o / f"{tool}_one"
            od.mkdir()
            t = time.time()
            dev = [f"device={device}"] if tool != "reformat" else []
            rc, report = run_tool(tool, [a.format(d=d, o=od)
                                         for a in template] + dev)
            _sync(device)
            if rc != 0:
                raise AssertionError(f"{tool} hosts=1 exited {rc}: {report}")
            res[tool] = {"wall_one_s": time.time() - t}
        for tool in runs:
            two = children[tool].finish(600)
            one, got = _files(o / f"{tool}_one"), _files(o / f"{tool}_two")
            if sorted(one) != sorted(got) or not one:
                raise AssertionError(f"{tool}: files {sorted(got)} at "
                                     f"hosts=2, {sorted(one)} at hosts=1")
            for name in one:
                if one[name] != got[name]:
                    raise AssertionError(f"{tool}: {name} differs between "
                                         f"hosts=2 and hosts=1")
            res[tool].update({"files": len(one),
                              "bytes": sum(map(len, one.values())),
                              "walls_two_s": [r["wall_s"] for r in two],
                              "byte_equal": True})
    finally:
        for ch in children.values():
            ch.stop()
    say(f"parallel (d) hosts=2 tools on {n} reads or pairs, byte-equal to "
        f"hosts=1: " + "; ".join(
            f"{t} {r['files']} files {r['bytes']} bytes, hosts=1 "
            f"{r['wall_one_s']:.2f} s, hosts=2 walls "
            f"{r['walls_two_s'][0]:.2f} / {r['walls_two_s'][1]:.2f} s (the "
            f"eight processes at once)" for t, r in res.items())
        + f"; card {smi}")
    return res


def parallel_phase(device, gbases, first, d: Path, smi: str) -> dict:
    """parallel/ on the one card: (a) striped bbmap, paired (one process,
    then two, each alone on the card; the two stripes' one-process runs
    beside (b) and (c)) and single-end (one process beside (b) and (c),
    two beside (d)); (b) the sharded index (its three
    processes beside (c)); (c) the in-process mesh, sharded_score_step and
    dryrun_multichip; (d) the striped tools. ``d`` holds the host tools
    phase's inputs (genome.fa with its index cache, big1.fq, big2.fq)."""
    o = d / "parallel"
    o.mkdir()
    res = {"striped_pairs": striped_pairs(d, o, smi)}
    shard = sharded_bbmap_start(d, o, gbases)
    se_one = striped_se_start(d, o, 1)
    stripes = stripes_start(d, o)
    try:
        res["mesh"] = mesh_phase(device, gbases, first, d)
        res["sharded_index"] = sharded_bbmap_finish(shard, d, o, device,
                                                    smi)
        se1 = se_one.finish(600)[0]
        res["striped_pairs"].update(stripes_finish(stripes, o))
    finally:
        shard.stop()
        se_one.stop()
        stripes.stop()
    se_two = striped_se_start(d, o, 2)
    try:
        res["tools"] = striped_tools(device, d, o, smi)
        res["striped_single_end"] = striped_se_finish(
            se1, se_two.finish(600), o, smi)
    finally:
        se_two.stop()
    return res


def _device_profile(fn, tag: str, wall_ms: float, top: int = 12) -> dict:
    """Run fn under torch.profiler (CPU + CUDA activities) and print the
    number of kernels, their summed device time, the host time inside
    cudaLaunchKernel, the scans (``aten::cummax``, ``aten::cummin``,
    ``aten::cumsum``), the scalar reads of a device value
    (``aten::_local_scalar_dense``: ``bool()``, ``int()``, ``.item()``,
    each a host sync), the device-to-host copies (``.cpu()``,
    ``.tolist()``, ``.numpy()`` of a device tensor, and the copy under
    each scalar read: a sync unless asynchronous into pinned memory), the
    idle share (1 - device time / ``wall_ms``, the same work's wall time
    without the profiler) and the ``top`` kernels by device time. Returns
    those counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    launch_us = n_launch_calls = n_scalar = n_scans = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, us + ev.device_time)
        elif ev.name == "cudaLaunchKernel":
            n_launch_calls += 1
            launch_us += ev.cpu_time
        elif ev.name == "aten::_local_scalar_dense":
            n_scalar += 1
        elif ev.name in ("aten::cummax", "aten::cummin", "aten::cumsum"):
            n_scans += 1
    n_kernels = sum(n for n, _ in kernels.values())
    n_dtoh = sum(n for name, (n, _) in kernels.items() if "DtoH" in name)
    dev_ms = sum(us for _, us in kernels.values()) / 1e3
    say(f"profile {tag}: wall {wall_ms:.1f} ms without the profiler, "
        f"{n_kernels} device kernels and copies, device time {dev_ms:.3f} "
        f"ms, idle share {100 * (1 - dev_ms / wall_ms):.1f} %, "
        f"cudaLaunchKernel {n_launch_calls} calls {launch_us / 1e3:.1f} ms, "
        f"{n_scans} scans, {n_scalar} scalar reads of a device value, "
        f"{n_dtoh} device-to-host copies")
    for name, (n, us) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        say(f"  {us / 1e3:10.3f} ms {n:8d} x {name[:90]}")
    return {"kernels": n_kernels, "device_ms": dev_ms, "scans": n_scans,
            "scalar_reads": n_scalar, "dtoh_copies": n_dtoh}


def profile_paths(device, gbases) -> None:
    """``python3 chip_smoke.py --profile``: where the time goes. One
    short-read batch of the main path, plain and under torch.profiler,
    then 32 long reads through ``mappacbio`` three times: plain (the
    CLI's mapping time), under cProfile (host functions by cumulative
    time) and under torch.profiler (device kernels)."""
    import cProfile
    import pstats
    _res, (b1, b2, _out, aligner) = main_path(device, n_steady=1,
                                              genome_bases=gbases)
    t0 = time.time()
    aligner.map_pairs_columnar(b1, b2)
    _sync(device)
    wall_ms = 1e3 * (time.time() - t0)
    reset_counts()
    _device_profile(lambda: aligner.map_pairs_columnar(b1, b2),
                    f"short batch of {N_PAIRS} pairs", wall_ms)
    say(f"profile short batch launches: {launch_counts()}")
    del aligner
    map_ms = 1e3 * long_phase(device, gbases, n_reads=32,
                              check=False)["map_s"]
    pr = cProfile.Profile()
    pr.enable()
    long_phase(device, gbases, n_reads=32, check=False)
    pr.disable()
    buf = io.StringIO()
    stats = pstats.Stats(pr, stream=buf)
    stats.sort_stats("cumulative").print_stats(28)
    for ln in buf.getvalue().splitlines():
        if ln.strip():
            say("  cprofile: " + ln.rstrip()[:150])
    # the quality stage's share of the long run (host time: a launch
    # returns before the card is done)
    total = max(st[3] for st in stats.stats.values())
    for (_f, _ln, fn), st in stats.stats.items():
        if fn in ("quality_offsets_stage", "quality_offsets_kernel",
                  "_quality_offsets_core", "rescue_scan", "_rescue_stage"):
            say(f"  cprofile {fn}: {st[1]} calls, cumulative {st[3]:.3f} s "
                f"of {total:.3f} s ({100 * st[3] / total:.1f} %)")
    _device_profile(lambda: long_phase(device, gbases, n_reads=32,
                                       check=False),
                    "32 long reads (wall: the CLI's mapping time)", map_ms)
    tools_profile(device)


def tools_profile(device) -> None:
    """One bbduk chunk, one seal chunk (the count route) and one bbmerge
    batch in each mode at the tools phase's sizes, each timed once and
    then run under torch.profiler: kernels and launches a chunk, device
    time, idle share."""
    from bbmap_tpu_torch.index import kmerset, kmerset_device
    from bbmap_tpu_torch.ops import overlap
    from bbmap_tpu_torch.tools.seal import Seal
    adapters, reads = duk_inputs(SCAN_CHUNK)
    ks = kmerset.build_kmer_set(adapters, k=K_DUK, hdist=HDIST_DUK)
    refs, seal_reads = seal_inputs(SCAN_CHUNK)
    seal = Seal(refs, [f"scaf{i}" for i in range(SEAL_REFS)], k=K_SEAL,
                ambig="first", device=device)
    a, b = merge_inputs(MERGE_CHUNK)
    for tag, fn in (
            (f"bbduk chunk of {SCAN_CHUNK} reads",
             lambda: kmerset.scan_batch(ks, reads, device)),
            (f"seal count chunk of {SCAN_CHUNK} reads",
             lambda: kmerset_device.device_scan_counts(
                 seal.ks, seal_reads, seal.nrefs, device)),
            (f"bbmerge mismatch batch of {MERGE_CHUNK} pairs",
             lambda: overlap.mate_by_overlap_batch(a, None, b, None,
                                                   device=device)),
            (f"bbmerge ratio batch of {MERGE_CHUNK} pairs",
             lambda: overlap.mate_by_overlap_ratio_batch(a, b,
                                                         device=device))):
        fn()
        _sync(device)
        t0 = time.time()
        fn()
        _sync(device)
        _device_profile(fn, tag, 1e3 * (time.time() - t0))


_PAIRED_RUN = """
import json, statistics, sys, time, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from bbmap_tpu_torch import workload
from bbmap_tpu_torch.ops import _build
_build.build_all()
dev = torch.device('cuda', 0)
g = workload.make_genome()
r, (b1, b2, _, aligner) = cs.main_path(dev, genome_bases=g)
reps = []
for _ in range(8):
    t = time.time()
    aligner._fused_pair_dispatch(b1, b2, cs.L)
    torch.cuda.synchronize()
    reps.append(1e3 * (time.time() - t))
r['stages']['fused_device_ms_reps'] = reps
cs._device_profile(lambda: aligner._fused_pair_dispatch(b1, b2, cs.L),
                   'fused program', statistics.median(reps), top=30)
lr = cs.long_phase(dev, g)
keep = ('reads_per_s', 'sensitivity', 'mapped_fraction', 'pair_rate',
        'stages', 'launches', 'max_memory_allocated')
print('PAIRED ' + json.dumps({'short': {k: r[k] for k in keep}, 'long': {
    k: lr[k] for k in ('map_s', 'reads_per_s', 'mapped_fraction',
                       'strict_correct')}}))
"""


def paired(parent: str) -> int:
    """``--paired <dir>``: the short-read main path and the long reads of
    the tree in <dir> (a checkout of another commit, the parent) and of
    this tree, each in a process of its own on the same card, in the order
    parent, change, change, parent; one line a run, no ``ok`` line. Each
    tree runs its own ``chip_smoke.main_path`` and ``long_phase``, times
    its fused program 8 more times on the warmup batch
    (``fused_device_ms_reps``) and runs it once more under torch.profiler:
    its device kernels by device time, and its idle share against the
    median of the 8 (``profile fused program`` lines)."""
    here = str(ROOT)
    for tag, tree in (("parent", parent), ("change", here),
                      ("change", here), ("parent", parent)):
        t = time.time()
        p = subprocess.run([sys.executable, "-c", _PAIRED_RUN], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
        got = [ln[7:] for ln in p.stdout.splitlines()
               if ln.startswith("PAIRED ")]
        if p.returncode != 0 or not got:
            say(p.stdout[-3000:] + p.stderr[-3000:])
            raise AssertionError(f"the {tag} run failed ({tree})")
        say(f"paired {tag} ({time.time() - t:.1f} s): {got[0]}")
        lines = p.stdout.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if ln.startswith("profile fused program"))
        for ln in lines[at:]:
            if not (ln is lines[at] or ln.startswith("  ")):
                break
            say(f"paired {tag} {ln.strip()}")
    return 0


# One dedupe run of the checkout in the working directory over the library
# in sys.argv[1] (e=2 ac=t on the card): reads/s and banded_edit's
# launches split by call site, counted around the two call sites of any
# tree (SequenceStore.distances of the one-read-a-launch design, the
# containment check's contained_distances), banded_any's and
# contained_any's where the tree has them. One "SPLIT <json>" line.
_SPLIT_RUN = """
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from bbmap_tpu_torch.ops import banded_device as bd
split = {"store": 0, "containment": 0}
def counted(site, fn):
    def run(*a, **k):
        n0 = bd.banded_edit.launches
        try:
            return fn(*a, **k)
        finally:
            split[site] += bd.banded_edit.launches - n0
    return run
if hasattr(bd.SequenceStore, "distances"):
    bd.SequenceStore.distances = counted("store",
                                         bd.SequenceStore.distances)
bd.contained_distances = counted("containment", bd.contained_distances)
from bbmap_tpu_torch.ops import _build
_build.load("banded_edit")           # built before the timed run
cs.reset_counts()
t = time.time()
rc, rep = cs.run_tool("dedupe", [f"in={sys.argv[1]}", f"out={sys.argv[2]}",
                                 "e=2", "ac=t", "device=cuda"])
torch.cuda.synchronize()
wall = time.time() - t
block = getattr(bd, "banded_any", None)
cont = getattr(bd, "contained_any", None)
print("SPLIT " + json.dumps({
    "rc": rc, "wall_s": wall, "reads_per_s": cs.N_DEDUPE_BIG / wall,
    "banded_edit": bd.banded_edit.launches, "banded_edit_by_site": split,
    "banded_any": dict(block.launches_by) if block else None,
    "contained_any": cont.launches if cont else None,
    "report": rep.splitlines()[-3:]}), flush=True)
"""


def dedupe_split(parent: str) -> int:
    """``--dedupe-split <dir>``: dedupe e=2 ac=t over the N_DEDUPE_BIG-read
    library of the dedupe phase with the tree in <dir> (the parent) and
    with this tree, each run in a process of its own on the card, in the
    order parent, change, change, parent: reads/s and the banded kernels'
    launches by call site (the store check, the containment check), and
    every output byte-equal; no ``ok`` line."""
    from bbmap_tpu_torch import workload
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_split"))
    try:
        lib = tmp / "big.fq"
        _fastq_recs(lib, dedupe_reads(workload.make_genome(), N_DEDUPE_BIG,
                                      91), 92)
        outs = {}
        trees = {"parent": parent, "change": str(ROOT)}
        for n, tag in enumerate(("parent", "change", "change", "parent")):
            tree = trees[tag]
            out = tmp / f"{tag}{n}_u.fq"
            p = subprocess.run([sys.executable, "-c", _SPLIT_RUN, str(lib),
                                str(out)], cwd=tree, capture_output=True,
                               text=True, timeout=900)
            got = [ln[6:] for ln in p.stdout.splitlines()
                   if ln.startswith("SPLIT ")]
            if p.returncode != 0 or not got:
                say(p.stdout[-3000:] + p.stderr[-3000:])
                raise AssertionError(f"the {tag} dedupe run failed ({tree})")
            say(f"dedupe split {tag}: {got[0]}")
            outs[n] = out.read_bytes()
        if len(set(outs.values())) != 1:
            raise AssertionError("the parent's and the change's dedupe "
                                 "outputs differ")
        say("dedupe split: the parent's and the change's outputs byte-equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "bbmap_tpu_torch" / "csrc" / "msa_dp.cu").is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)

    t = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    say(f"device: {kind}")
    say(smi)
    say(f"phase device facts: {time.time() - t:.2f} s")

    from concurrent.futures import ThreadPoolExecutor
    from bbmap_tpu_torch.ops import _build, msa_selftest
    t = time.time()
    with ThreadPoolExecutor(1) as pool:
        # the self-test's oracle (host numpy) beside the nvcc processes
        oracle = pool.submit(lambda: (msa_selftest.selftest_cases(),
                                      time.time() - t))
        libs = _build.build_all([*_build.SOURCES, *_build.VARIANTS])
        for name in _build.SOURCES:
            _build.load(name)
        say(f"phase build: {time.time() - t:.2f} s "
            f"({', '.join(p.name for p in libs)})")
        cases, oracle_s = oracle.result()

    if "--paired" in sys.argv[1:]:
        return paired(sys.argv[sys.argv.index("--paired") + 1])
    if "--dedupe-split" in sys.argv[1:]:
        return dedupe_split(sys.argv[sys.argv.index("--dedupe-split") + 1])

    t = time.time()
    st = selftest_phase(device, cases)
    say(f"phase kernel selftest: {time.time() - t:.2f} s; kernel_selftest "
        f"{st['ok']}: K2, K3 and the fused fill + walk equal to the numpy "
        f"oracle on {st['cases']} cases ({', '.join(st['profiles'])}) in "
        f"{st['wall_s']:.2f} s, launches {st['launches']} (the oracle "
        f"{oracle_s:.2f} s beside the build); card {smi}")

    from bbmap_tpu_torch import workload
    t = time.time()
    gbases = workload.make_genome()
    if "--profile" in sys.argv[1:]:
        profile_paths(device, gbases)
        return 0
    ktimes = kernel_phase(gbases, device)
    say(f"phase kernel vs plain: {time.time() - t:.1f} s")

    t = time.time()
    k1 = k1_entry(gbases, device)
    say(f"phase K1 entry point: {time.time() - t:.1f} s")

    from bbmap_tpu_torch.align import quickmap_device
    from bbmap_tpu_torch.ops import rescue_device
    t = time.time()
    scans = ("ref_retention_kernel", "gapless_scores_kernel",
             "slot_pack_kernel", "chain_candidates_kernel")
    with first_call(rescue_device, "rescue_scan") as rescue_call, \
            first_call(quickmap_device, "quality_offsets_kernel") as q_call, \
            contextlib.ExitStack() as stack:
        main_scans = {name: stack.enter_context(first_call(quickmap_device,
                                                           name))
                      for name in scans}
        res, first = main_path(device, genome_bases=gbases)
    say(f"phase main path: {time.time() - t:.1f} s; reads/s "
        f"{res['reads_per_s']:.1f} over {N_STEADY} steady batches of "
        f"{N_PAIRS} pairs; sensitivity {res['sensitivity']:.4f}, mapped "
        f"{res['mapped_fraction']:.4f}, pair rate {res['pair_rate']:.4f}; "
        f"launches {res['launches']}; quality offsets device (computed "
        f"on the card on every CUDA run); card {smi}")

    t = time.time()
    n_lines = sam_phase(first)
    say(f"phase SAM: {n_lines} lines, {time.time() - t:.2f} s")

    t = time.time()
    rq = rescue_quality_phase(device, rescue_call[0], q_call[0],
                              max_sm_clock_hz())
    ktimes.update(rq)
    del rescue_call, q_call
    say(f"phase rescue and quality offsets kernels: {time.time() - t:.1f} "
        f"s; rescue_scan and quality_offsets equal to their plain versions "
        f"(max_abs_err 0) on the warmup batch's inputs and on edge cases; "
        f"rescue_scan {rq['rescue_scan']['ms']:.4f} ms at "
        f"{rq['rescue_scan']['shape']['jobs']} jobs (plain "
        f"{rq['rescue_scan']['plain_ms']:.3f} ms), quality_offsets "
        f"{rq['quality_offsets']['ms']:.4f} ms at {2 * N_PAIRS} x {L} (plain "
        f"{rq['quality_offsets']['plain_ms']:.3f} ms), "
        f"{rq['quality_offsets']['shapes']['long']['ms']:.4f} ms at "
        f"{QUALITY_LONG[0]} x {QUALITY_LONG[1]} (plain "
        f"{rq['quality_offsets']['shapes']['long']['plain_ms']:.3f} ms); "
        f"card {smi}")

    t = time.time()
    ib = index_build_phase(device, gbases, first, smi)
    say(f"phase index build: {time.time() - t:.1f} s; build_index_device "
        f"on the card equal to the host build_index at "
        f"{ib['bench']['G']} bp, k={INDEX_K}, without and with N bases "
        f"({ib['with_n']['n_bases']} N, 2 chroms): host build "
        f"{ib['bench']['host_build_s']:.3f} s, analyze_index "
        f"{ib['aligner']['analyze_s']:.3f} s, device build warm "
        f"{min(ib['bench']['device_build_warm_s']):.3f} s (the device CSR "
        f"{ib['bench']['device_csr_ms']:.3f} ms, bound "
        f"{ib['bench']['bound_ms']:.4f} ms), peak "
        f"{ib['bench']['device_peak_bytes']} B; the warmup batch on the "
        f"device-built index equal to the host-built run; card {smi}")

    t = time.time()
    with contextlib.ExitStack() as stack:
        long_scans = {name: stack.enter_context(first_call(quickmap_device,
                                                           name))
                      for name in scans}
        lres = long_phase(device, gbases)
    say(f"phase long reads: {time.time() - t:.1f} s; {N_LONG} reads of "
        f"{L_LONG} bp: reads/s {lres['reads_per_s']:.3f}, bases/s "
        f"{lres['bases_per_s']:.1f} (mapping {lres['map_s']:.1f} s, wall "
        f"with index build {lres['wall_s']:.1f} s); mapped "
        f"{lres['mapped_fraction']:.4f}, strict "
        f"{lres['strict_correct']:.4f}; launches {lres['launches']}; "
        f"peak memory {lres['max_memory_allocated']} B; card {smi}")

    t = time.time()
    rg = retention_gapless_phase(device, main_scans, long_scans,
                                 max_sm_clock_hz())
    ktimes.update(rg)
    rr, gg = rg["ref_retention"]["shapes"], rg["gapless_score"]["shapes"]
    say(f"phase retention and gapless kernels: {time.time() - t:.1f} s; "
        f"ref_retention and gapless_score equal to their plain versions "
        f"(max_abs_err 0) on the main path's and the long path's first "
        f"calls; ref_retention {rr['main']['ms']:.4f} ms at "
        f"{rr['main']['reads']} x {rr['main']['nk']} (plain "
        f"{rr['main']['plain_ms']:.3f} ms), {rr['long']['ms']:.4f} ms at "
        f"{rr['long']['reads']} x {rr['long']['nk']} (plain "
        f"{rr['long']['plain_ms']:.3f} ms); gapless_score "
        f"{gg['main']['ms']:.4f} ms at {gg['main']['reads']} x "
        f"{gg['main']['candidates']} x {gg['main']['L']} (plain "
        f"{gg['main']['plain_ms']:.3f} ms), {gg['long']['ms']:.4f} ms at "
        f"{gg['long']['reads']} x {gg['long']['candidates']} x "
        f"{gg['long']['L']} (plain {gg['long']['plain_ms']:.3f} ms); card "
        f"{smi}")

    t = time.time()
    ck = candidate_kernels_phase(device, main_scans, long_scans,
                                 max_sm_clock_hz())
    ktimes.update(ck)
    del main_scans, long_scans
    sp, cc = ck["slot_pack"]["shapes"], ck["chain_candidates"]["shapes"]
    say(f"phase slot pack and chain kernels: {time.time() - t:.1f} s; "
        f"slot_pack and chain_candidates equal to their plain versions "
        f"(max_abs_err 0) on the main path's and the long path's first "
        f"calls and on crafted rows; slot_pack {sp['main']['ms']:.4f} ms at "
        f"{sp['main']['reads']} x 2 x {sp['main']['nk']} keys, W "
        f"{sp['main']['W']} (plain {sp['main']['plain_ms']:.3f} ms), "
        f"{sp['long']['ms']:.4f} ms at {sp['long']['reads']} x 2 x "
        f"{sp['long']['nk']}, W {sp['long']['W']} (plain "
        f"{sp['long']['plain_ms']:.3f} ms); chain_candidates "
        f"{cc['main']['ms']:.4f} ms at {cc['main']['reads']} x 2 x "
        f"{cc['main']['W']} (plain {cc['main']['plain_ms']:.3f} ms), "
        f"{cc['long']['ms']:.4f} ms at {cc['long']['reads']} x 2 x "
        f"{cc['long']['W']} (plain {cc['long']['plain_ms']:.3f} ms); scans "
        f"and scalar reads in one call {ck['slot_pack']['profile']} "
        f"{ck['chain_candidates']['profile']}; card {smi}")
    say(f"split of the short batch's former eager scans, each plain version "
        f"alone at the main path's shape: the trim loop (_ref_retention) "
        f"{rr['main']['plain_ms']:.3f} ms, the gapless score "
        f"(_gapless_scores_plain) {gg['main']['plain_ms']:.3f} ms, the slot "
        f"pack (_slot_pack_plain) {sp['main']['plain_ms']:.3f} ms, the chain "
        f"step (_chain_candidates_plain: sort, _chain_segments, table) "
        f"{cc['main']['plain_ms']:.3f} ms; card {smi}")

    kd = Path(tempfile.mkdtemp(prefix="chip_smoke_kmer"))
    kmer_cpu = {}
    try:
        # the kmer tools' CLI runs on the CPU start now, beside the tools
        # phase: decontaminate's takes ~2 minutes on one thread
        kmer_runs = kmer_cli_start(kd, gbases, kmer_cpu)
        t = time.time()
        duk, seal, merge, cli = tools_phase(device)
        tools_s = time.time() - t
        t = time.time()
        kcnt, kcli = kmer_tools_phase(device, gbases, kd, kmer_runs,
                                      kmer_cpu)
        kmer_s = time.time() - t
    finally:
        for r in kmer_cpu.values():
            r.stop()
        shutil.rmtree(kd, ignore_errors=True)
    say(f"phase tools: {tools_s:.1f} s; bbduk reads/s "
        f"{duk['reads_per_s']:.1f} ({duk['reads']} reads, "
        f"{duk['reads_with_hit']} with a hit); seal reads/s "
        f"{seal['reads_per_s']:.1f} (matched {seal['matched_fraction']:.4f})"
        f"; bbmerge reads/s {merge['mismatch']['reads_per_s']:.1f} mismatch "
        f"mode (merged {merge['mismatch']['merged_fraction']:.4f}), "
        f"{merge['ratio']['reads_per_s']:.1f} ratio mode (merged "
        f"{merge['ratio']['merged_fraction']:.4f}); CLIs byte-equal between "
        f"the card and the CPU; card {smi}")

    say(f"phase kmer tools: {kmer_s:.1f} s; counting Bloom filter "
        f"({KCA_HASHES} x {KCA_CELLS} cells of {KCA_BITS} bits, k="
        f"{KCA_K}) over {kcnt['reads']} reads: increment "
        f"{kcnt['count_kmers_per_s']:.1f} k-mers/s, "
        f"{kcnt['count_reads_per_s']:.1f} reads/s (host canonical_kmers "
        f"{100 * kcnt['count_host_cut_share']:.1f} % of the wall); read "
        f"{kcnt['read_kmers_per_s']:.1f} k-mers/s, "
        f"{kcnt['read_reads_per_s']:.1f} reads/s (host canonical_kmers "
        f"{100 * kcnt['read_host_cut_share']:.1f} %); rows and reads equal "
        f"to numpy at 16, 8 and 2 bits; CLIs byte-equal between the card "
        f"and the CPU, wall on the card: " + ", ".join(
            f"{tool} {kcli[tool]['wall_s']:.2f} s (CPU "
            f"{kcli[tool]['wall_cpu_s']:.2f} s)"
            for tool in ("bbnorm", "ecc", "kmercoverage", "rqcfilter",
                         "decontaminate")) + f"; card {smi}")

    t = time.time()
    bkt, bany, bcont, dd, vv = dedupe_variants_phase(device, gbases,
                                                     max_sm_clock_hz())
    vb = vv["big"]
    say(f"phase dedupe and mapper variants: {time.time() - t:.1f} s; "
        f"banded_edit at {BANDED_PAIRS} x {L} bp, E=2: {bkt['ms']:.4f} ms "
        f"(plain {bkt['plain_ms']:.3f} ms, bound {bkt['bound_ms']:.4f} ms, "
        f"share {100 * bkt['bound_ms'] / bkt['ms']:.1f} %), every shape "
        f"equal to its plain version; banded_any at {BLOCK_QUERIES_TABLE} "
        f"queries x {BANDED_PAIRS}, E=2: {bany['ms']:.4f} ms (bound "
        f"{bany['bound_ms']:.4f} ms, share "
        f"{100 * bany['bound_ms'] / bany['ms']:.1f} %); contained_any at "
        f"dedupe's median block: {bcont['ms']:.4f} ms (bound "
        f"{bcont['bound_ms']:.6f} ms); dedupe e=2 ac=t at "
        f"{N_DEDUPE_BIG} reads {dd['big']['reads_per_s']:.1f} reads/s, "
        f"store check {dd['big']['store_check_launches']} launches "
        f"{dd['big']['store_check_by_mode']}, containment check "
        f"{dd['big']['containment_launches']}, kernels <= "
        f"{100 * dd['big']['kernel_share']:.1f} % of the wall; at "
        f"{N_VARIANT_BIG} pairs "
        + ", ".join(f"{tool} {vb[tool]['reads_per_s']:.1f} reads/s "
                    f"(sensitivity {vb[tool]['sensitivity']:.4f})"
                    for tool in ("bbmap", "bbmapacc", "bbmapskimmer"))
        + f"; one-row launches in bbmapskimmer: K2 "
        f"{vb['bbmapskimmer']['launches']['msa_score_row']} one-row, "
        f"{vb['bbmapskimmer']['launches']['msa_score_pipe']} pipe, K3 "
        f"{vb['bbmapskimmer']['launches']['msa_fill_row']} one-row, "
        f"{vb['bbmapskimmer']['launches']['msa_fill_pipe']} pipe; CLIs "
        f"byte-equal between the card and the CPU; card {smi}")

    hd = Path(tempfile.mkdtemp(prefix="chip_smoke_host"))
    try:
        t = time.time()
        host = host_tools_phase(device, gbases, hd)
        hb = host["big"]
        say(f"phase host tools: {time.time() - t:.1f} s; bbwrap over two "
            f"inputs byte-equal between the card and the CPU; "
            f"{len(host['modules'])} other host tool modules exit 0 in "
            f"{sum(r['wall_s'] for r in host['modules'].values()):.2f} s; "
            f"bbwrap at {N_VARIANT_BIG} pairs interleaved "
            f"{hb['A']['reads_per_s']:.1f} reads/s (mapped "
            f"{hb['A']['mapped_fraction']:.4f}, sensitivity "
            f"{hb['A']['sensitivity']:.4f}), their first mates single-end "
            f"{hb['B']['reads_per_s']:.1f} reads/s (mapped "
            f"{hb['B']['mapped_fraction']:.4f}); card {smi}")

        t = time.time()
        par = parallel_phase(device, gbases, first, hd, smi)
        pa = par["striped_pairs"]
        say(f"phase parallel: {time.time() - t:.1f} s; (a) striped bbmap "
            f"at {N_VARIANT_BIG} pairs: two processes "
            f"{pa['two_processes']['reads_per_s']:.1f} reads/s in aggregate"
            f", one process {pa['one_process']['reads_per_s']:.1f} "
            f"({pa['records_apart']} records apart: MAPQ), single-end "
            f"byte-equal; (b) "
            f"shardindex=t byte-equal, shards "
            f"{par['sharded_index']['shard_sites']} of "
            f"{par['sharded_index']['sites']} sites; (c) mesh equal to the "
            f"unsharded aligner, sharded_score_step equal to plain K1; (d) "
            f"bbduk, seal, bbmerge, reformat hosts=2 byte-equal to hosts=1;"
            f" card {smi}")
    finally:
        shutil.rmtree(hd, ignore_errors=True)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "bbmap_tpu"))
    if foreign:
        raise AssertionError(f"the JAX package was imported: {foreign[:5]}")
    # launches on each path, each counted from 0 over that path's run
    # and read at its end: K1 at its own entry point ("k1_entry"), the
    # short-read path ("main"), the long-read path ("long"),
    # decontaminate's two single-end bbmap runs on the card
    # ("kmer_tools"), dedupe over N_DEDUPE_BIG reads ("dedupe"),
    # bbmapskimmer over N_VARIANT_BIG pairs ("mapper_variants"),
    # bbwrap's two inputs at N_VARIANT_BIG pairs ("host_tools") and the
    # in-process mesh's batch with sharded_score_step ("parallel");
    # "launches" is the count on the path whose shape the entry is timed
    # at: the band kernels and the walk kernel (short fills and walks take
    # the fused kernel) on the long-read path, K1 at its entry point, the
    # banded kernel on dedupe's, the rest on the main path; the strided
    # kernels, which the band kernels replaced, run on no path, and the
    # pipe kernels, the default from 700 rows, on none of these paths
    counted = {"msa_score_rows": "msa_score_rows_warp",
               "msa_score": "msa_score_warp", "msa_score_row": "msa_score_row",
               "msa_score_segments": "msa_score_segments",
               "msa_fill": "msa_fill_row", "msa_walk": "msa_walk",
               **{n: n for n in FILL_WALK.values()},
               "msa_score_long": "msa_score_band",
               "msa_fill_long": "msa_fill_band",
               "msa_score_strided": "msa_score_strided",
               "msa_fill_strided": "msa_fill_strided",
               "msa_score_pipe": "msa_score_pipe",
               "msa_fill_pipe": "msa_fill_pipe",
               "msa_score_rows_pipe": "msa_score_rows_pipe",
               "banded_edit": "banded_edit", "banded_any": "banded_any",
               "contained_any": "contained_any",
               "rescue_scan": "rescue_scan",
               "quality_offsets": "quality_offsets",
               "ref_retention": "ref_retention",
               "gapless_score": "gapless_score",
               "slot_pack": "slot_pack",
               "chain_candidates": "chain_candidates"}
    home = {"msa_score_rows": "k1_entry", "msa_walk": "long",
            "msa_score_long": "long", "msa_fill_long": "long",
            "msa_score_strided": "long", "msa_fill_strided": "long",
            "banded_edit": "dedupe", "banded_any": "dedupe",
            "contained_any": "dedupe",
            "msa_score_row": "mapper_variants",
            "msa_score_pipe": "mapper_variants",
            "msa_fill_pipe": "mapper_variants",
            "msa_score_rows_pipe": "k1_entry"}
    ktimes["banded_edit"] = bkt
    ktimes["banded_any"] = bany
    ktimes["contained_any"] = bcont
    # K2 at the CLIs' one-row shapes, held to its plain version there too
    for name, e in vv["cli_shapes_max_abs_err"].items():
        ktimes[name]["max_abs_err"] = max(ktimes[name]["max_abs_err"], e)
        ktimes[name]["max_abs_err_at_cli_shapes"] = e
    # the CLIs' one-row launches by shape, on the entries of their mapping
    cli_shapes = {}
    for tool, wrapper, mapping, n, R, C, k in vv["onerow_at_cli_shapes"]:
        cli_shapes.setdefault(VARIANT[wrapper, mapping], []).append(
            [tool, n, R, C, k])
    paths = {"k1_entry": k1, "main": res["launches"],
             "long": lres["launches"],
             "kmer_tools": kcli["decontaminate"]["launches"],
             "dedupe": dd["big"]["kernel_launches"],
             "mapper_variants": vb["bbmapskimmer"]["launches"],
             "host_tools": hb["launches"],
             "parallel": par["mesh"]["launches"]}
    kernels = []
    for name, key in counted.items():
        kt = ktimes[name]
        by_path = {path: counts[key] for path, counts in paths.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name],
                        "replaces": REPLACES[name],
                        "launches": by_path[home.get(name, "main")],
                        "launches_by_path": by_path,
                        "max_abs_err": kt["max_abs_err"],
                        "ms": kt["ms"], "plain_ms": kt["plain_ms"],
                        "bound_ms": kt["bound_ms"],
                        "bound_by": kt["bound_by"],
                        "library_ms": kt["library_ms"]})
        if "max_abs_err_at_cli_shapes" in kt:
            kernels[-1]["max_abs_err_at_cli_shapes"] = \
                kt["max_abs_err_at_cli_shapes"]
        if name in cli_shapes:
            kernels[-1]["launch_shapes"] = cli_shapes[name]
        say(f"launches {name}: {by_path}")
    print(json.dumps({"tools": [
        {"tool": "bbduk", "reads": duk["reads"],
         "reads_per_s": duk["reads_per_s"],
         "hit_fraction": duk["reads_with_hit"] / duk["reads"]},
        {"tool": "seal", "reads": seal["reads"],
         "reads_per_s": seal["reads_per_s"],
         "matched_fraction": seal["matched_fraction"]}] + [
        {"tool": "bbmerge", "mode": mode, "pairs": merge["pairs"],
         "reads_per_s": merge[mode]["reads_per_s"],
         "merged_fraction": merge[mode]["merged_fraction"]}
        for mode in ("mismatch", "ratio")] + [
        {"tool": f"{tool} CLI", "reads_in": cli[tool]["reads_in"],
         "byte_equal_to_cpu": True, "wall_s": cli[tool]["wall_s"]}
        for tool in ("bbduk", "seal", "bbmerge")]}), flush=True)
    print(json.dumps({"kmer_tools": {
        "count": kcnt, "cli": {tool: {k: v for k, v in r.items()
                                      if k != "covstats_libA"}
                               for tool, r in kcli.items()}}}), flush=True)
    print(json.dumps({"dedupe_variants": {
        "banded_edit": bkt["shapes"], "banded_any": bany["shapes"],
        "contained_any": bcont["shapes"],
        "dedupe": {k: {f: v for f, v in r.items() if f != "report"}
                   for k, r in dd.items()},
        "variants": {k: {f: v for f, v in r.items() if f != "report"}
                     if isinstance(r, dict) else r
                     for k, r in vv.items()}}}), flush=True)
    print(json.dumps({"host_tools": {
        "bbwrap_cli": host["bbwrap_cli"], "modules": host["modules"],
        "bbwrap_big": {k: hb[k] for k in ("A", "B")}}}), flush=True)
    print(json.dumps({"parallel": {
        k: ({f: v for f, v in r.items() if f != "launches"}
            if k == "mesh" else r) for k, r in par.items()}}), flush=True)
    print(json.dumps({"kernel_selftest": st, "card": smi}), flush=True)
    print(json.dumps({"index_build": ib, "card": smi}), flush=True)
    print(json.dumps({"retention_gapless": {
        "ref_retention": rg["ref_retention"]["shapes"],
        "gapless_score": rg["gapless_score"]["shapes"]}, "card": smi}),
        flush=True)
    print(json.dumps({"candidate_kernels": {
        name: {k: e[k] for k in ("shapes", "profile")}
        for name, e in ck.items()}, "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
