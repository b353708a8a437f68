"""seal: k-mer based read attribution to multiple reference sequences.

reference: jgi/Seal.java:51 + sh/seal.sh. Reads (or pairs, kept
together by default — Seal.java:158 keepPairsTogether_=true) are
attributed to the reference scaffold owning the most of their k-mers:
per-scaffold hit counts are condensed (Seal.java:2402 condenseLoose),
scaffolds within ``clearzone`` of the top count are kept
(Seal.java:2484 filterTopScaffolds_withClearzone), and the ambiguity
mode picks the winner(s) (Seal.java:2202-2216: first / all / random
[default] / toss). Counters are per scaffold (reads/bases/frags);
``stats=`` / ``rpkm=`` / ``refstats=`` / ``tax=`` reproduce the
reference artifact formats (Seal.java:writeStats:829,
writeRPKM:885, writeRefStats:930, writeTaxonomy:1036).

Attribution is fully vectorized (the torch k-mer scan of
index/kmerset_device on ``device=``, default cuda, counting hits per
read and scaffold there; past its gates the slot scan plus a sort-free
np.unique condense over the whole batch — no per-read Python loop).
The port's copy of the JAX package's tool; ``hosts=`` stripes
read batches over processes (``parallel/multihost.py``).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import backend
from ..core.batch import ReadBatch, batched
from ..index import kmerset
from ..io import fastx
from ..utils.args import Args

AMBIG_FIRST, AMBIG_ALL, AMBIG_RANDOM, AMBIG_TOSS = range(4)
_AMBIG = {"first": AMBIG_FIRST, "all": AMBIG_ALL,
          "random": AMBIG_RANDOM, "toss": AMBIG_TOSS}

# dense-condense cell budget (B*nrefs); tests shrink it to force the
# sparse path
DENSE_CELLS_CAP = 1 << 26

# reference: tax/TaxTree.java level ordering (stringToLevel); used for
# the tax= report's minlevel/maxlevel gate
TAX_LEVELS = ["no rank", "subspecies", "species", "genus", "family",
              "order", "class", "phylum", "kingdom", "superkingdom",
              "domain", "life"]


def _tax_level(rank: str) -> int:
    rank = (rank or "no rank").lower()
    if rank == "superkingdom":
        rank = "domain"
    try:
        return TAX_LEVELS.index(rank)
    except ValueError:
        return 0


class BatchAssignment:
    """Result of one batch: ``primary`` (B,) int32 scaffold id per
    read/pair (-1 unmatched, -2 ambiguous-tossed) plus the full chosen
    (row, id) set for ambig=all pattern routing."""

    __slots__ = ("primary", "chosen_rows", "chosen_ids")

    def __init__(self, primary, chosen_rows, chosen_ids):
        self.primary = primary
        self.chosen_rows = chosen_rows
        self.chosen_ids = chosen_ids


class Seal:
    def __init__(self, ref_seqs: List[bytes], names: List[str],
                 k: int = 31, hdist: int = 0, mask_middle: bool = True,
                 min_kmer_hits: int = 1, min_kmer_fraction: float = 0.0,
                 ambig: str = "random", clearzone: int = 0, *, device):
        self.device = backend.resolve_device(device)
        self.ks = kmerset.build_kmer_set(
            ref_seqs, k=k, hdist=hdist, mask_middle=mask_middle,
            names=names, multi=True)
        self.k = k
        self.min_kmer_hits = max(1, min_kmer_hits)
        self.min_kmer_fraction = max(0.0, min_kmer_fraction)
        self.ambig = _AMBIG[ambig]
        self.clearzone = clearzone
        self.names = names
        self.nrefs = max(1, len(names))
        self.ref_lengths = np.array([len(s) for s in ref_seqs],
                                    np.int64)
        # per-scaffold counters (reference: scaffoldReadCounts /
        # scaffoldBaseCounts / scaffoldFragCounts, Seal.java:2235-2243)
        self.read_counts = np.zeros(self.nrefs, np.int64)
        self.base_counts = np.zeros(self.nrefs, np.int64)
        self.frag_counts = np.zeros(self.nrefs, np.int64)
        self.reads_in = 0
        self.bases_in = 0
        self.frags_in = 0
        self.reads_matched = 0
        self.bases_matched = 0

    # -- vectorized condense + clearzone + ambig selection ------------

    def _select(self, B: int, rows: np.ndarray, vals: np.ndarray,
                numeric_ids: np.ndarray, min_hits: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray]:
        """Flat (row, scaffold-id) hit pairs. Returns (matched (B,)
        bool, sites (B,), chosen_rows, chosen_ids) where chosen covers
        ALL winners per matched row under the ambig mode."""
        nrefs = self.nrefs
        if rows.size == 0:
            z = np.zeros(0, np.int64)
            return (np.zeros(B, bool), np.zeros(B, np.int64), z, z)
        key = rows * nrefs + vals
        if B * nrefs <= DENSE_CELLS_CAP:
            # dense condense: O(hits) bincount into a (B, nrefs) count
            # matrix — ~8x faster than the sort-based unique on
            # hit-dense batches
            counts = np.bincount(key, minlength=B * nrefs).reshape(
                B, nrefs)
            return self._select_from_counts(counts, numeric_ids,
                                            min_hits)
        # sparse condense (huge reference sets): unique (row, scaffold)
        # with counts; np.unique sorts, so ids are ascending within
        # each row (the reference's loose.sort() — makes ambig=first
        # pick the lowest id)
        ukey, ucnt = np.unique(key, return_counts=True)
        urow = ukey // nrefs
        uid = ukey % nrefs
        maxc = np.zeros(B, np.int64)
        np.maximum.at(maxc, urow, ucnt)
        # filterTopScaffolds_withClearzone: count >= max(1, max - cz)
        thresh = np.maximum(1, maxc - self.clearzone)
        kz = ucnt >= thresh[urow]
        krow, kid = urow[kz], uid[kz]
        sites = np.bincount(krow, minlength=B)
        matched = maxc >= np.maximum(self.min_kmer_hits, min_hits)
        row_start = np.zeros(B + 1, np.int64)
        np.cumsum(sites, out=row_start[1:])
        if self.ambig == AMBIG_ALL:
            cmask = matched[krow]
            return matched, sites, krow[cmask], kid[cmask]
        if self.ambig == AMBIG_TOSS:
            ok = matched & (sites == 1)
            pick = row_start[:-1][ok]
            return matched, sites, np.nonzero(ok)[0], kid[pick]
        if self.ambig == AMBIG_FIRST:
            off = np.zeros(B, np.int64)
        else:                                     # AMBIG_RANDOM
            off = numeric_ids.astype(np.int64) % np.maximum(1, sites)
            off = np.where(sites < 2, 0, off)
        ok = matched & (sites > 0)
        pick = (row_start[:-1] + off)[ok]
        return matched, sites, np.nonzero(ok)[0], kid[pick]

    def _select_from_counts(self, counts: np.ndarray,
                            numeric_ids: np.ndarray,
                            min_hits: np.ndarray):
        """Selection from a dense (B, nrefs) per-scaffold count
        matrix (host bincount or the device count program)."""
        B = counts.shape[0]
        maxc = counts.max(axis=1)
        thresh = np.maximum(1, maxc - self.clearzone)
        kept = (counts >= thresh[:, None]) & (counts > 0)
        sites = kept.sum(axis=1).astype(np.int64)
        matched = maxc >= np.maximum(self.min_kmer_hits, min_hits)
        if self.ambig == AMBIG_ALL:
            krow, kid = np.nonzero(kept & matched[:, None])
            return matched, sites, krow.astype(np.int64), \
                kid.astype(np.int64)
        if self.ambig == AMBIG_TOSS:
            ok = matched & (sites == 1)
            return (matched, sites, np.nonzero(ok)[0],
                    np.argmax(kept[ok], axis=1).astype(np.int64))
        if self.ambig == AMBIG_FIRST:
            off = np.zeros(B, np.int64)
        else:                                     # AMBIG_RANDOM
            off = numeric_ids.astype(np.int64) % np.maximum(1, sites)
            off = np.where(sites < 2, 0, off)
        ok = matched & (sites > 0)
        # the off-th kept column per row (ascending id): position
        # where the running kept-count first reaches off+1
        ord_in_row = np.cumsum(kept, axis=1)
        hitcol = kept & (ord_in_row == (off + 1)[:, None])
        return (matched, sites, np.nonzero(ok)[0],
                np.argmax(hitcol[ok], axis=1).astype(np.int64))

    def assign_batch(self, batch: ReadBatch,
                     batch2: Optional[ReadBatch] = None
                     ) -> BatchAssignment:
        """Attribute one batch (pair batches are kept together:
        combined k-mer counts, reference Seal.java:2056)."""
        B = batch.size
        paired = batch2 is not None
        len1 = batch.lengths.astype(np.int64)
        len2 = batch2.lengths.astype(np.int64) if paired else 0
        self.reads_in += B * (2 if paired else 1)
        self.bases_in += int(len1.sum()) + (int(len2.sum())
                                            if paired else 0)
        self.frags_in += B
        nk = np.maximum(len1 - self.k + 1, 0)
        if paired:
            nk = nk + np.maximum(len2 - self.k + 1, 0)
        min_hits = (self.min_kmer_fraction * nk).astype(np.int64)
        nid = batch.numeric_ids if batch.numeric_ids is not None \
            else np.arange(B)
        # count route: per-read per-scaffold hit counts condensed on
        # the device (kmerset_device.device_scan_counts); None past its
        # gates, then the slot route below
        from ..index.kmerset_device import device_scan_counts
        counts = device_scan_counts(self.ks, batch.bases, self.nrefs,
                                    self.device)
        if counts is not None and paired:
            counts = counts + device_scan_counts(
                self.ks, batch2.bases, self.nrefs, self.device)
        if counts is not None:
            matched, sites, crow, cid = self._select_from_counts(
                counts, nid, min_hits)
        else:
            rows, vals = kmerset.scan_batch_multi(self.ks, batch.bases,
                                                  self.device)
            if paired:
                rows2, vals2 = kmerset.scan_batch_multi(
                    self.ks, batch2.bases, self.device)
                rows = np.concatenate([rows, rows2])
                vals = np.concatenate([vals, vals2])
            matched, sites, crow, cid = self._select(B, rows, vals,
                                                     nid, min_hits)

        read_sum = 2 if paired else 1
        len_sum = len1 + (len2 if paired else 0)
        np.add.at(self.read_counts, cid,
                  np.full(cid.shape, read_sum, np.int64))
        np.add.at(self.base_counts, cid, len_sum[crow])
        np.add.at(self.frag_counts, cid, np.ones(cid.shape, np.int64))
        assigned = np.zeros(B, bool)
        assigned[crow] = True
        self.reads_matched += int(assigned.sum()) * read_sum
        self.bases_matched += int(len_sum[assigned].sum())

        primary = np.full(B, -1, np.int32)
        if self.ambig == AMBIG_TOSS:
            primary[matched & (sites > 1)] = -2
        # first chosen entry per row (ascending ids; for ambig modes
        # picking one winner crow is unique per row already)
        if crow.size:
            first = np.ones(crow.size, bool)
            first[1:] = crow[1:] != crow[:-1]
            primary[crow[first]] = cid[first].astype(np.int32)
        return BatchAssignment(primary, crow, cid.astype(np.int32))

    # -- artifact writers (reference formats) -------------------------

    def write_stats(self, path: str, in1: str, in2: Optional[str],
                    columns: int = 3,
                    nonzero_only: bool = True) -> None:
        """reference: Seal.java writeStats:829 (STATS_COLUMNS 3 or 5).
        Rows sorted by read count descending (StringCount sort)."""
        rmult = 100.0 / max(1, self.reads_in)
        bmult = 100.0 / max(1, self.bases_in)
        rows = [(int(self.read_counts[i]), int(self.base_counts[i]), i)
                for i in range(len(self.names))
                if self.read_counts[i] > 0 or not nonzero_only]
        rows.sort(key=lambda t: (-t[0], -t[1],
                                 self.names[t[2]]))
        with open(path, "w") as fh:
            fh.write(f"#File\t{in1}" + (f"\t{in2}" if in2 else "")
                     + "\n")
            if columns == 3:
                fh.write(f"#Total\t{self.reads_in}\n")
                fh.write("#Matched\t%d\t%.5f%%\n"
                         % (self.reads_matched,
                            rmult * self.reads_matched))
                fh.write("#Name\tReads\tReadsPct\n")
                for r, b, i in rows:
                    fh.write("%s\t%d\t%.5f%%\n"
                             % (self.names[i], r, r * rmult))
            else:
                fh.write(f"#Total\t{self.reads_in}\t{self.bases_in}\n")
                fh.write("#Matched\t%d\t%.5f%%\n"
                         % (self.reads_matched,
                            rmult * self.reads_matched))
                fh.write("#Name\tReads\tReadsPct\tBases\tBasesPct\n")
                for r, b, i in rows:
                    fh.write("%s\t%d\t%.5f%%\t%d\t%.5f%%\n"
                             % (self.names[i], r, r * rmult, b,
                                b * bmult))

    def write_rpkm(self, path: str, in1: str, in2: Optional[str],
                   nonzero_only: bool = True) -> None:
        """reference: Seal.java writeRPKM:885 — per-scaffold coverage,
        RPKM (reads*1e9 / (mappedReads*len)) and FPKM (frags-based)."""
        mapped_reads = int(self.read_counts.sum())
        mapped_frags = int(self.frag_counts.sum())
        read_mult = 1e9 / max(1, mapped_reads)
        frag_mult = 1e9 / max(1, mapped_frags)
        with open(path, "w") as fh:
            fh.write(f"#File\t{in1}" + (f"\t{in2}" if in2 else "")
                     + "\n")
            fh.write(f"#Reads\t{self.reads_in}\n")
            fh.write(f"#Mapped\t{self.reads_matched}\n")
            fh.write(f"#RefSequences\t{len(self.names)}\n")
            fh.write("#Name\tLength\tBases\tCoverage\tReads\tRPKM\t"
                     "Frags\tFPKM\n")
            for i, name in enumerate(self.names):
                r = int(self.read_counts[i])
                if r == 0 and nonzero_only:
                    continue
                ln = max(1, int(self.ref_lengths[i]))
                b = int(self.base_counts[i])
                f = int(self.frag_counts[i])
                fh.write("%s\t%d\t%d\t%.4f\t%d\t%.4f\t%d\t%.4f\n"
                         % (name, int(self.ref_lengths[i]), b, b / ln,
                            r, r * read_mult / ln, f,
                            f * frag_mult / ln))

    def write_refstats(self, path: str, in1: str, in2: Optional[str],
                       ref_names: List[str],
                       ref_scaf_counts: List[int],
                       nonzero_only: bool = True) -> None:
        """reference: Seal.java writeRefStats:930 — scaffold counters
        aggregated per reference FILE."""
        mapped = int(self.read_counts.sum())
        mult = 1e9 / max(1, mapped)
        with open(path, "w") as fh:
            fh.write(f"#File\t{in1}" + (f"\t{in2}" if in2 else "")
                     + "\n")
            fh.write(f"#Reads\t{self.reads_in}\n")
            fh.write(f"#Mapped\t{mapped}\n")
            fh.write(f"#References\t{len(ref_names)}\n")
            fh.write("#Name\tLength\tScaffolds\tBases\tCoverage\t"
                     "Reads\tRPKM\tFrags\tFPKM\n")
            s = 0
            for rname, scafs in zip(ref_names, ref_scaf_counts):
                sl = slice(s, s + scafs)
                r = int(self.read_counts[sl].sum())
                f = int(self.frag_counts[sl].sum())
                b = int(self.base_counts[sl].sum())
                ln = int(self.ref_lengths[sl].sum())
                s += scafs
                if r == 0 and nonzero_only:
                    continue
                inv = 1.0 / max(1, ln)
                fh.write("%s\t%d\t%d\t%d\t%.4f\t%d\t%.4f\t%d\t%.4f\n"
                         % (rname, ln, scafs, b, b * inv, r,
                            r * mult * inv, f, f * mult * inv))

    def write_taxonomy(self, path: str, in1: str, in2: Optional[str],
                       tree, count_limit: int = 1,
                       number_limit: int = 0,
                       min_level: str = "subspecies",
                       max_level: str = "domain") -> None:
        """reference: Seal.java writeTaxonomy:1036 — per-scaffold frag
        counts resolved to tax ids, percolated up the tree, nodes at
        count >= limit within [minlevel, maxlevel] printed by count
        descending."""
        counts: Dict[int, int] = {}
        for i, name in enumerate(self.names):
            f = int(self.frag_counts[i])
            if f == 0:
                continue
            tid = _name_to_taxid(name, tree)
            if tid is None:
                continue
            for anc in tree.lineage(tid):
                counts[anc] = counts.get(anc, 0) + f
        lo, hi = _tax_level(min_level), _tax_level(max_level)
        nodes = [(tid, c) for tid, c in counts.items()
                 if c >= count_limit
                 and lo <= _tax_level(tree.rank.get(tid, "no rank"))
                 <= hi]
        nodes.sort(key=lambda t: (-t[1], t[0]))
        if number_limit > 0:
            nodes = nodes[:number_limit]
        mapped_frags = int(self.frag_counts.sum())
        fmult = 100.0 / max(1, self.frags_in)
        with open(path, "w") as fh:
            fh.write(f"#File\t{in1}" + (f"\t{in2}" if in2 else "")
                     + "\n")
            fh.write(f"#Reads\t{self.frags_in}\n")
            fh.write(f"#Mapped\t{mapped_frags}\n")
            fh.write("#Limits\t%d\t%d\t%d\t%d\n"
                     % (count_limit, number_limit, lo, hi))
            fh.write("#ID\tCount\tPercent\tLevel\tName\n")
            for tid, c in nodes:
                fh.write("%d\t%d\t%.4f\t%s\t%s\n"
                         % (tid, c, c * fmult,
                            tree.rank.get(tid, "no rank"),
                            tree.name.get(tid, str(tid))))


def _name_to_taxid(name: str, tree) -> Optional[int]:
    """Scaffold name -> NCBI tax id: tid|NNN| prefix (reference:
    tax/TaxTree.getID), bare integer, or scientific-name lookup."""
    if name.startswith("tid|"):
        try:
            return int(name.split("|")[1])
        except (IndexError, ValueError):
            return None
    if name.startswith("ncbi|"):
        try:
            return int(name.split("|")[1])
        except (IndexError, ValueError):
            return None
    return tree.resolve(name.split()[0]) if tree else None


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    ref = args.get("ref")
    pattern = args.get("pattern", "outpattern", "basename")
    outm = args.get("outm", "out", "outmatch", "outm1")
    outm2 = args.get("outm2", "out2", "outmatch2")
    outu = args.get("outu", "outu1", "outunmatched")
    outu2 = args.get("outu2", "outunmatched2")
    stats = args.get("stats", "scafstats")
    rpkm = args.get("rpkm", "fpkm", "cov", "coverage", "covstats")
    refstats = args.get("refstats")
    outtax = args.get("tax", "taxa", "outtax")
    k = args.get_int("k", default=31)
    hdist = args.get_int("hdist", "hammingdistance", default=0)
    mkh = args.get_int("minkmerhits", "mkh", default=1)
    mkf = args.get_float("minkmerfraction", "mkf", default=0.0)
    cz = args.get_int("clearzone", "cz", default=0)
    mm = args.get_bool("maskmiddle", "mm", default=True)
    ambig = args.get("ambiguous", "ambig", default="random")
    columns = args.get_int("statscolumns", "cols", default=3)
    nzo = args.get_bool("nzo", "nonzeroonly", default=True)
    interleaved = args.get_bool("interleaved", "int", default=False)
    device = args.get("device", default="cuda")
    if in1 is None or ref is None:
        print("Usage: seal in=<reads> [in2=<mates>] ref=<refs.fa> "
              "stats=<file> [rpkm=<file>] [refstats=<file>] "
              "[pattern=out_%.fq] k=31 ambig=random", file=sys.stderr)
        return 1
    if ambig not in _AMBIG:
        print(f"Unknown ambiguous mode: {ambig}", file=sys.stderr)
        return 1
    seqs, names = [], []
    ref_names, ref_scaf_counts = [], []
    for path in ref.split(","):
        n0 = len(names)
        for rec in fastx.read_seqs(path):
            seqs.append(rec.bases)
            names.append(rec.id.split()[0])
        ref_names.append(path.rsplit("/", 1)[-1].split(".")[0])
        ref_scaf_counts.append(len(names) - n0)
    seal = Seal(seqs, names, k=k, hdist=hdist, mask_middle=mm,
                min_kmer_hits=mkh, min_kmer_fraction=mkf,
                ambig=ambig, clearzone=cz, device=device)

    tree = None
    if outtax:
        from .taxonomy import TaxTree
        ttf = args.get("taxtree", "tree")
        if ttf:
            tree = TaxTree.load_serialized(ttf)
        else:
            nodes = args.get("taxnodes", "taxnode")
            tnames = args.get("taxnames", "taxname")
            if nodes:
                tree = TaxTree.load(nodes, tnames)
        if tree is None:
            print("tax= output needs taxtree= or taxnodes=",
                  file=sys.stderr)
            return 1

    # hosts=N striping (same machinery as bbduk/bbmerge hosts=)
    import io as _io
    import os as _os
    num_hosts = args.get_int("hosts", default=1)
    host_id = args.get_int("hostid", default=int(
        _os.environ.get("BBMAP_TPU_HOST_ID", "0"))) \
        if num_hosts > 1 else 0
    shards: Dict[str, object] = {}
    pat_shards: Dict[int, object] = {}
    if num_hosts > 1:
        from ..parallel import multihost
        for nm, path in (("outm", outm), ("outm2", outm2),
                         ("outu", outu), ("outu2", outu2)):
            shards[nm] = multihost.ShardWriter(path, host_id) \
                if path else None
    per_ref_fh: Dict[int, object] = {}
    outm_fh = fastx.xopen(outm, "wb") if outm and not num_hosts > 1 \
        else None
    outm2_fh = fastx.xopen(outm2, "wb") if outm2 and num_hosts == 1 \
        else None
    outu_fh = fastx.xopen(outu, "wb") if outu and num_hosts == 1 \
        else None
    outu2_fh = fastx.xopen(outu2, "wb") if outu2 and num_hosts == 1 \
        else None

    def wfq(fh, rec):
        if fh is None:
            return
        q = rec.quality if rec.quality is not None \
            else b"I" * len(rec.bases)
        fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n"
                 + q + b"\n")

    def route(chunk1, chunk2, batch_id):
        nonlocal outm_fh, outm2_fh, outu_fh, outu2_fh
        if num_hosts > 1:
            bufs = {nm: _io.BytesIO() if sh is not None else None
                    for nm, sh in shards.items()}
            outm_fh = bufs["outm"]
            outm2_fh = bufs["outm2"]
            outu_fh = bufs["outu"]
            outu2_fh = bufs["outu2"]
            pat_bufs: Dict[int, object] = {}
        b1 = ReadBatch.from_records(chunk1)
        b2 = ReadBatch.from_records(chunk2) if chunk2 else None
        asg = seal.assign_batch(b1, b2)
        # pattern routing covers ambig=all multi-attribution
        # (reference: ArrayListSet als per winner, Seal.java:2221)
        if pattern and "%" in pattern:
            for r, i in zip(asg.chosen_rows, asg.chosen_ids):
                i = int(i)
                if num_hosts > 1:
                    if i not in pat_shards:
                        from ..parallel import multihost
                        safe = names[i].replace("/", "_")
                        pat_shards[i] = multihost.ShardWriter(
                            pattern.replace("%", safe), host_id)
                    fh = pat_bufs.setdefault(i, _io.BytesIO())
                else:
                    if i not in per_ref_fh:
                        safe = names[i].replace("/", "_")
                        per_ref_fh[i] = fastx.xopen(
                            pattern.replace("%", safe), "wb")
                    fh = per_ref_fh[i]
                wfq(fh, chunk1[r])
                if chunk2:
                    wfq(fh, chunk2[r])
        for i, rec in enumerate(chunk1):
            a = int(asg.primary[i])
            if a >= 0:
                wfq(outm_fh, rec)
                if chunk2:
                    wfq(outm2_fh or outm_fh, chunk2[i])
            else:
                wfq(outu_fh, rec)
                if chunk2:
                    wfq(outu2_fh or outu_fh, chunk2[i])
        if num_hosts > 1:
            for nm, sh in shards.items():
                if sh is not None:
                    sh.write_batch(batch_id, bufs[nm].getvalue())
            for i, buf in pat_bufs.items():
                pat_shards[i].write_batch(batch_id, buf.getvalue())

    def striped(src):
        if num_hosts > 1:
            from ..parallel import multihost
            return multihost.stripe_batches(src, host_id, num_hosts)
        return enumerate(src)

    odd = 0
    if in2:
        it1 = batched(fastx.read_seqs(in1), 8192)
        it2 = batched(fastx.read_seqs(in2), 8192)
        for bid, (chunk1, chunk2) in striped(zip(it1, it2)):
            route(chunk1, chunk2, bid)
    elif interleaved:
        # chunks of an even size: only the last can leave a mate alone
        for bid, chunk in striped(batched(fastx.read_seqs(in1),
                                          16384)):
            if len(chunk) % 2:
                odd = 16384 * bid + len(chunk)
                break
            route(chunk[0::2], chunk[1::2], bid)
    else:
        for bid, chunk in striped(batched(fastx.read_seqs(in1),
                                          8192)):
            route(chunk, None, bid)

    for fh in per_ref_fh.values():
        fh.close()
    for fh in (outm_fh, outm2_fh, outu_fh, outu2_fh):
        if fh is not None and not isinstance(fh, _io.BytesIO):
            fh.close()
    if num_hosts > 1:
        from ..parallel import multihost
        for sh in list(shards.values()) + list(pat_shards.values()):
            if sh is not None:
                sh.close()
        pat = np.zeros(len(names), np.int64)     # refs with a pattern shard
        pat[sorted(pat_shards)] = 1
        total = multihost.finish_stripes(
            "seal-shards-done", host_id, num_hosts,
            outm or outu or (stats or "seal") + ".x",
            {"reads_in": seal.reads_in, "bases_in": seal.bases_in,
             "frags_in": seal.frags_in,
             "reads_matched": seal.reads_matched,
             "bases_matched": seal.bases_matched,
             "read_counts": seal.read_counts,
             "base_counts": seal.base_counts,
             "frag_counts": seal.frag_counts, "pat": pat, "odd": odd},
            (outm, outm2, outu, outu2))
        if total is None:
            if odd:
                print(f"seal: interleaved=t takes reads in pairs, but "
                      f"{in1} holds an odd number of reads ({odd})",
                      file=sys.stderr)
                return 1
            return 0
        odd = total.pop("odd")       # one host holds the last batch
        for i in np.nonzero(total.pop("pat"))[0]:
            multihost.merge_shards(
                pattern.replace("%", names[i].replace("/", "_")),
                num_hosts)
        for name, v in total.items():
            setattr(seal, name, v)
    if odd:
        print(f"seal: interleaved=t takes reads in pairs, but {in1} holds "
              f"an odd number of reads ({odd})", file=sys.stderr)
        return 1
    if stats:
        seal.write_stats(stats, in1, in2, columns=columns,
                         nonzero_only=nzo)
    if rpkm:
        seal.write_rpkm(rpkm, in1, in2, nonzero_only=nzo)
    if refstats:
        seal.write_refstats(refstats, in1, in2, ref_names,
                            ref_scaf_counts, nonzero_only=nzo)
    if outtax:
        seal.write_taxonomy(
            outtax, in1, in2, tree,
            count_limit=args.get_int("taxnodecountlimit", "mincount",
                                     default=1),
            number_limit=args.get_int("taxnodenumberlimit", "maxnodes",
                                      default=0),
            min_level=args.get("taxnodeminlevel", "minlevel",
                               default="subspecies"),
            max_level=args.get("taxnodemaxlevel", "maxlevel",
                               default="domain"))
    sys.stderr.write(
        f"Reads:\t{seal.reads_in}\nMatched:\t{seal.reads_matched}\t"
        f"({100.0*seal.reads_matched/max(1,seal.reads_in):.2f}%)\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
