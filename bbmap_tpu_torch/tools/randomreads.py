"""randomreads: synthetic read generator with truth-encoded names.

reference: align2/RandomReads3.java:25 + sh/randomreads.sh. Generates
reads with controlled SNP/ins/del/N mutations; the true origin is encoded
in the read name using the reference's custom-ID format
(reference: stream/FASTQ.customID:290-344):

    {id}_chr{chrom}_{strand}_{start}_{stop}_{scafRelStart}_{scafName}

which gradesam parsecustom consumes.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..core.bases import COMP_ASCII
from ..core.genome import Genome, build_genome
from ..io import fastx
from ..utils.args import Args

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, span: np.ndarray, n_snps: int, n_inss: int, n_dels: int,
            n_ns: int, read_len: int) -> np.ndarray:
    """Apply mutations to a ref span, returning exactly read_len bases."""
    read = span.copy()
    for _ in range(n_dels):
        if len(read) <= read_len:
            break
        p = int(rng.integers(1, len(read) - 1))
        read = np.concatenate([read[:p], read[p + 1:]])
    for _ in range(n_inss):
        p = int(rng.integers(1, max(2, len(read) - 1)))
        read = np.concatenate([read[:p], rng.choice(BASES, 1), read[p:]])
    read = read[:read_len]
    for _ in range(n_snps):
        p = int(rng.integers(0, len(read)))
        old = read[p]
        choices = BASES[BASES != old]
        read[p] = rng.choice(choices)
    for _ in range(n_ns):
        read[int(rng.integers(0, len(read)))] = ord("N")
    return read


class RandomReads:
    def __init__(self, genome: Genome, seed: int = 0,
                 max_snps: int = 3, snp_rate: float = 0.0,
                 max_insertions: int = 2, ins_rate: float = 0.0,
                 max_deletions: int = 2, del_rate: float = 0.0,
                 max_ns: int = 0, n_rate: float = 0.0,
                 min_q: int = 28, max_q: int = 35):
        self.g = genome
        self.rng = np.random.default_rng(seed)
        self.max_snps = max_snps
        self.snp_rate = snp_rate
        self.max_insertions = max_insertions
        self.ins_rate = ins_rate
        self.max_deletions = max_deletions
        self.del_rate = del_rate
        self.max_ns = max_ns
        self.n_rate = n_rate
        self.min_q = min_q
        self.max_q = max_q

    def _counts(self):
        rng = self.rng
        snps = int(rng.integers(1, self.max_snps + 1)) \
            if self.snp_rate > 0 and rng.random() < self.snp_rate else 0
        inss = int(rng.integers(1, self.max_insertions + 1)) \
            if self.ins_rate > 0 and rng.random() < self.ins_rate else 0
        dels = int(rng.integers(1, self.max_deletions + 1)) \
            if self.del_rate > 0 and rng.random() < self.del_rate else 0
        ns = int(rng.integers(1, self.max_ns + 1)) \
            if self.n_rate > 0 and rng.random() < self.n_rate else 0
        return snps, inss, dels, ns

    def _name(self, nid: int, chrom: int, strand: int, start: int,
              stop: int) -> str:
        scaf, rel = self.g.locate(chrom, start)
        return f"{nid}_chr{chrom}_{strand}_{start}_{stop}_{rel}_{scaf.name}"

    def _qual(self, L: int) -> bytes:
        q = self.rng.integers(self.min_q, self.max_q + 1, L)
        return bytes((q + 33).astype(np.uint8))

    def _one_read(self, nid: int, chrom: int, start: int, length: int,
                  strand: int):
        snps, inss, dels, ns = self._counts()
        span_len = length + dels - inss
        arr = self.g.chroms[chrom - 1]
        span = arr[start:start + span_len]
        read = _mutate(self.rng, span, snps, inss, dels, ns, length)
        stop = start + span_len - 1
        if strand == 1:
            read = COMP_ASCII[read][::-1]
        name = self._name(nid, chrom, strand, start, stop)
        return fastx.SeqRecord(name, bytes(read), self._qual(length), nid)

    def pacbio(self, n_reads: int, min_len: int, max_len: int,
               error_rate: float = 0.15):
        """Long reads with the PacBio error profile — indel-dominated:
        ~55% insertions, ~30% deletions, ~15% substitutions of the
        total error budget (reference: RandomReads3 addPacBioErrors /
        pacbio=t flag, align2/RandomReads3.java)."""
        g = self.g
        p_ins = error_rate * 0.55
        p_del = error_rate * 0.30
        p_sub = error_rate * 0.15
        ACGT = np.frombuffer(b"ACGT", np.uint8)
        for nid in range(n_reads):
            length = int(self.rng.integers(min_len, max_len + 1))
            span_need = int(length * (1 + p_del) * 1.2) + 10
            while True:
                chrom = 1 + int(self.rng.integers(0, g.n_chroms))
                arr = g.chroms[chrom - 1]
                hi = len(arr) - span_need - 1
                if hi <= 0:
                    continue
                start = int(self.rng.integers(0, hi))
                if (arr[start:start + span_need]
                        == ord("N")).mean() < 0.2:
                    break
            out = bytearray()
            i = 0
            while len(out) < length and i < span_need:
                r = self.rng.random()
                if r < p_ins:
                    out.append(int(self.rng.choice(ACGT)))
                elif r < p_ins + p_del:
                    i += 1
                elif r < p_ins + p_del + p_sub:
                    b = arr[start + i]
                    c = int(self.rng.choice(ACGT))
                    while c == b:
                        c = int(self.rng.choice(ACGT))
                    out.append(c)
                    i += 1
                else:
                    out.append(int(arr[start + i]))
                    i += 1
            stop = start + i - 1
            strand = int(self.rng.integers(0, 2))
            read = np.frombuffer(bytes(out), np.uint8)
            if strand == 1:
                read = COMP_ASCII[read][::-1]
            name = self._name(nid, chrom, strand, start, stop)
            yield fastx.SeqRecord(name, bytes(read),
                                  self._qual(len(read)), nid)

    def single(self, n_reads: int, length: int):
        g = self.g
        total = sum(len(c) for c in g.chroms)
        for nid in range(n_reads):
            while True:
                chrom = 1 + int(self.rng.integers(0, g.n_chroms))
                arr = g.chroms[chrom - 1]
                lo, hi = 0, len(arr) - length - self.max_deletions - 1
                if hi <= lo:
                    continue
                start = int(self.rng.integers(lo, hi))
                span = arr[start:start + length]
                if (span == ord("N")).mean() < 0.5:
                    break
            strand = int(self.rng.integers(0, 2))
            yield self._one_read(nid, chrom, start, length, strand)

    def paired(self, n_pairs: int, length: int, min_insert: int,
               max_insert: int):
        g = self.g
        for nid in range(n_pairs):
            insert = int(self.rng.integers(min_insert, max_insert + 1))
            while True:
                chrom = 1 + int(self.rng.integers(0, g.n_chroms))
                arr = g.chroms[chrom - 1]
                hi = len(arr) - insert - self.max_deletions - 2
                if hi <= 0:
                    continue
                start = int(self.rng.integers(0, hi))
                if (arr[start:start + insert] == ord("N")).mean() < 0.5:
                    break
            flip = int(self.rng.integers(0, 2))
            left_start = start
            right_start = start + insert - length
            # FR (innie) geometry: the left mate is always plus-strand,
            # the right mate minus; `flip` only selects which mate is
            # read 1 (reference: RandomReads3 paired generation)
            r_left = self._one_read(nid, chrom, left_start, length, 0)
            r_right = self._one_read(nid, chrom, right_start, length, 1)
            # record the true insert size in the name so merged output
            # can be graded exactly (reference: GradeMergedReads
            # parseInsert:244-256 reads 'insert=N' from the header)
            r_left = fastx.SeqRecord(f"{r_left.id}_insert={insert}",
                                     r_left.bases, r_left.quality,
                                     r_left.numeric_id)
            r_right = fastx.SeqRecord(f"{r_right.id}_insert={insert}",
                                      r_right.bases, r_right.quality,
                                      r_right.numeric_id)
            if flip == 0:
                yield r_left, r_right
            else:
                yield r_right, r_left


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    ref = args.get("ref")
    out = args.get("out", "out1")
    out2 = args.get("out2")
    reads = args.get_int("reads", default=1000)
    length = args.get_int("length", "len", "readlength", default=150)
    paired = args.get_bool("paired", default=out2 is not None)
    min_insert = args.get_int("mininsert", default=max(2 * length, 100))
    max_insert = args.get_int("maxinsert", default=max(3 * length, 400))
    seed = args.get_int("seed", default=0)
    if ref is None or out is None:
        print("Usage: randomreads ref= out= [out2=] reads= length= ...",
              file=sys.stderr)
        return 1
    g = build_genome(ref)
    rr = RandomReads(
        g, seed=seed,
        max_snps=args.get_int("maxsnps", "snps", default=3),
        snp_rate=args.get_float("snprate", default=0.0),
        max_insertions=args.get_int("maxinss", "inss", default=2),
        ins_rate=args.get_float("insrate", default=0.0),
        max_deletions=args.get_int("maxdels", "dels", default=2),
        del_rate=args.get_float("delrate", default=0.0),
        max_ns=args.get_int("maxns", default=0),
        n_rate=args.get_float("nrate", default=0.0),
        min_q=args.get_int("minq", default=28),
        max_q=args.get_int("maxq", default=35))
    if args.get_bool("pacbio", default=False):
        min_len = args.get_int("pbmin", "minlength", default=length)
        max_len = args.get_int("pbmax", "maxlength",
                               default=max(length, 3 * length))
        err = args.get_float("pberror", "error", default=0.15)
        fastx.write_fastq(out, rr.pacbio(reads, min_len, max_len, err))
        return 0
    if paired:
        o1 = fastx.xopen(out, "wb")
        o2 = fastx.xopen(out2, "wb") if out2 else o1
        for r1, r2 in rr.paired(reads, length, min_insert, max_insert):
            o1.write(b"@" + r1.id.encode() + b"\n" + r1.bases + b"\n+\n"
                     + r1.quality + b"\n")
            o2.write(b"@" + r2.id.encode() + b"\n" + r2.bases + b"\n+\n"
                     + r2.quality + b"\n")
        o1.close()
        if o2 is not o1:
            o2.close()
    else:
        fastx.write_fastq(out, rr.single(reads, length))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
