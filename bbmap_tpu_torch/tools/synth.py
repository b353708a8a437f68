"""Synthetic-data fabrication tools: mutategenome, shred, makechimeras,
addadapters, fakereads, crosscontaminate.

reference: jgi/MutateGenome.java, jgi/Shred.java, jgi/MakeChimeras.java,
jgi/AddAdapters.java, jgi/FakeReads.java, jgi/CrossContaminate.java
(SURVEY.md §2.8 'Random/synthetic' row) — the test-data side of the
reference's synthetic-truth quality harness.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..core.bases import COMP_ASCII
from ..io import fastx
from ..utils.args import Args

BASES = np.frombuffer(b"ACGT", np.uint8)


def mutategenome(argv: List[str]) -> int:
    """Apply random SNPs/indels to a reference
    (reference: jgi/MutateGenome.java)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    subrate = args.get_float("subrate", default=0.01)
    indelrate = args.get_float("indelrate", default=0.0)
    seed = args.get_int("seed", default=0)
    if inp is None or out is None:
        print("Usage: mutategenome in= out= subrate=0.01 [indelrate=]",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(seed)
    n_subs = n_indels = total = 0

    def gen():
        nonlocal n_subs, n_indels, total
        for rec in fastx.read_fasta(inp):
            seq = np.frombuffer(rec.bases, np.uint8).copy()
            total += len(seq)
            subs = rng.random(len(seq)) < subrate
            n_subs += int(subs.sum())
            shift = rng.integers(1, 4, len(seq))
            codes = np.searchsorted(BASES, seq)
            mutated = BASES[(codes + shift) % 4]
            seq = np.where(subs & np.isin(seq, BASES), mutated, seq)
            if indelrate > 0:
                keep = rng.random(len(seq)) >= indelrate / 2
                parts = []
                last = 0
                ins_at = np.nonzero(rng.random(len(seq))
                                    < indelrate / 2)[0]
                seq = seq[keep]
                n_indels += int((~keep).sum()) + len(ins_at)
                for p in ins_at:
                    p = min(p, len(seq))
                    parts.append(seq[last:p])
                    parts.append(rng.choice(BASES, 1))
                    last = p
                parts.append(seq[last:])
                seq = np.concatenate(parts) if parts else seq
            yield fastx.SeqRecord(rec.id, bytes(seq), None,
                                  rec.numeric_id)

    fastx.write_fasta(out, gen())
    sys.stderr.write(f"Bases:\t{total}\nSubs:\t{n_subs}\n"
                     f"Indels:\t{n_indels}\n")
    return 0


def shred(argv: List[str]) -> int:
    """Cut sequences into fixed-length pieces (reference: jgi/Shred.java)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    length = args.get_int("length", "shredlength", default=500)
    overlap = args.get_int("overlap", default=0)
    if inp is None or out is None:
        print("Usage: shred in= out= length=500 [overlap=]",
              file=sys.stderr)
        return 1

    def gen():
        for rec in fastx.read_seqs(inp):
            step = max(1, length - overlap)
            for i, lo in enumerate(range(0, max(1, len(rec.bases)),
                                         step)):
                piece = rec.bases[lo:lo + length]
                if not piece:
                    break
                yield fastx.SeqRecord(f"{rec.id}_{i}", piece, None, 0)
                if lo + length >= len(rec.bases):
                    break

    fastx.write_fasta(out, gen())
    return 0


def makechimeras(argv: List[str]) -> int:
    """Join random read pairs into chimeras
    (reference: jgi/MakeChimeras.java)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    n_out = args.get_int("readsout", "chimeras", default=1000)
    seed = args.get_int("seed", default=0)
    if inp is None or out is None:
        print("Usage: makechimeras in= out= readsout=N", file=sys.stderr)
        return 1
    recs = list(fastx.read_seqs(inp))
    if not recs:
        return 1
    rng = np.random.default_rng(seed)

    def gen():
        for i in range(n_out):
            a = recs[int(rng.integers(0, len(recs)))]
            b = recs[int(rng.integers(0, len(recs)))]
            ab = a.bases[:int(rng.integers(1, max(2, len(a.bases))))]
            bb = b.bases[int(rng.integers(0, max(1, len(b.bases)))):]
            yield fastx.SeqRecord(f"chimera_{i}_{a.id}_{b.id}", ab + bb,
                                  None, i)

    fastx.write_fasta(out, gen())
    return 0


def addadapters(argv: List[str]) -> int:
    """Insert adapter sequence into reads at known positions, recording
    the position in the name for grading (reference: jgi/AddAdapters.java
    + grade mode)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    adapter = args.get("adapters", "adapter",
                       default="AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC")
    rate = args.get_float("rate", default=0.5)
    seed = args.get_int("seed", default=0)
    grade = args.get_bool("grade", default=False)
    if inp is None or (out is None and not grade):
        print("Usage: addadapters in= out= adapter= rate=0.5 | grade=t",
              file=sys.stderr)
        return 1
    if grade:
        # grade mode: reads named ..._adapterN should be trimmed to N
        total = correct = 0
        for rec in fastx.read_seqs(inp):
            parts = rec.id.rsplit("_adapter", 1)
            if len(parts) != 2:
                continue
            total += 1
            want = int(parts[1])
            if len(rec.bases) == want:
                correct += 1
        print(f"Graded:\t{total}\nCorrectly trimmed:\t{correct}\t"
              f"{100.0*correct/max(1,total):.3f}%")
        return 0
    ad = adapter.encode() if isinstance(adapter, str) else adapter
    rng = np.random.default_rng(seed)

    def gen():
        for rec in fastx.read_seqs(inp, fake_quality=30):
            L = len(rec.bases)
            if rng.random() < rate and L > 10:
                pos = int(rng.integers(L // 4, L))
                bases = rec.bases[:pos] + ad + rec.bases[pos:]
                bases = bases[:L]
                q = rec.quality[:L] if rec.quality else None
                yield fastx.SeqRecord(f"{rec.id}_adapter{pos}", bases, q,
                                      rec.numeric_id)
            else:
                yield fastx.SeqRecord(f"{rec.id}_adapter{L}", rec.bases,
                                      rec.quality, rec.numeric_id)

    fastx.write_fastq(out, gen())
    return 0


def fakereads(argv: List[str]) -> int:
    """Generate fake paired reads from assembly ends
    (reference: jgi/FakeReads.java)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out", "out1")
    out2 = args.get("out2")
    length = args.get_int("length", default=250)
    if inp is None or out is None:
        print("Usage: fakereads in=<contigs> out=r1.fq out2=r2.fq",
              file=sys.stderr)
        return 1
    o1 = fastx.xopen(out, "wb")
    o2 = fastx.xopen(out2, "wb") if out2 else o1
    for rec in fastx.read_seqs(inp):
        if len(rec.bases) < 2 * length:
            continue
        r1 = rec.bases[:length]
        r2 = bytes(COMP_ASCII[np.frombuffer(
            rec.bases[-length:], np.uint8)][::-1])
        q = b"I" * length
        o1.write(b"@" + rec.id.encode() + b" /1\n" + r1 + b"\n+\n" + q
                 + b"\n")
        o2.write(b"@" + rec.id.encode() + b" /2\n" + r2 + b"\n+\n" + q
                 + b"\n")
    o1.close()
    if o2 is not o1:
        o2.close()
    return 0


TOOLS = dict(mutategenome=mutategenome, shred=shred,
             makechimeras=makechimeras, addadapters=addadapters,
             fakereads=fakereads)


def main(argv: List[str]) -> int:
    if not argv or argv[0] not in TOOLS:
        print("synth tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))


def synthmda(argv: List[str]) -> int:
    """synthmda: simulate multiple-displacement-amplification output —
    random-primed, highly uneven overlapping amplicons of a reference
    (reference: jgi/SynthMDA.java:36 — cycles of random-site priming
    with exponential amplification bias)."""
    import numpy as np
    from ..core.bases import COMP_ASCII
    from ..core.genome import build_genome
    from ..utils.args import Args

    args = Args.parse(argv)
    ref = args.get("ref") or (args.positional[0]
                              if args.positional else None)
    out = args.get("out")
    cycles = args.get_int("cycles", default=9)
    init = args.get_int("initialratio", "init", default=8)
    min_len = args.get_int("minlen", default=2000)
    max_len = args.get_int("length", "maxlen", default=10_000)
    seed = args.get_int("seed", default=0)
    if ref is None or out is None:
        print("Usage: synthmda ref=<fa> out=<amplicons.fa> [cycles=9]",
              file=sys.stderr)
        return 1
    g = build_genome(ref)
    rng = np.random.default_rng(seed)
    pool = []  # (chrom, start, stop) templates, genome first
    for c in range(g.n_chroms):
        pool.append((c, 0, len(g.chroms[c])))
    frags = []
    for _ in range(init):
        c = int(rng.integers(0, g.n_chroms))
        arr = g.chroms[c]
        if len(arr) <= min_len:
            continue
        a = int(rng.integers(0, len(arr) - min_len))
        b = min(len(arr), a + int(rng.integers(min_len, max_len + 1)))
        frags.append((c, a, b))
    for _ in range(cycles):
        new = []
        for (c, a, b) in frags:
            # each fragment primes 1-2 sub-amplicons (exponential bias)
            for _ in range(int(rng.integers(1, 3))):
                if b - a <= min_len:
                    continue
                aa = a + int(rng.integers(0, (b - a) - min_len + 1))
                bb = min(b, aa + int(rng.integers(min_len,
                                                  max_len + 1)))
                new.append((c, aa, bb))
        frags.extend(new)
        if len(frags) > 100_000:
            break
    n = 0
    with fastx.xopen(out, "wb") as fh:
        for (c, a, b) in frags:
            seq = bytes(g.chroms[c][a:b])
            if len(seq) < min_len:
                continue
            if rng.random() < 0.5:
                seq = bytes(COMP_ASCII[np.frombuffer(
                    seq, np.uint8)][::-1])
            n += 1
            fh.write(f">mda_{n} chrom={c+1} start={a}\n".encode())
            for j in range(0, len(seq), 70):
                fh.write(seq[j:j + 70] + b"\n")
    sys.stderr.write(f"Amplicons:\t{n}\n")
    return 0


def fungalrelease(argv: List[str]) -> int:
    """fungalrelease: JGI release-format fasta cleanup — sort scaffolds
    by length (descending), rename sequentially, drop short scaffolds
    (reference: jgi/FungalRelease.java — minlen/sortcontigs/
    renamecontigs flags)."""
    from ..utils.args import Args

    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    min_len = args.get_int("minlen", "minlength", "minscaf", default=1)
    do_sort = args.get_bool("sortcontigs", "sort", default=True)
    rename = args.get_bool("renamecontigs", "rename", default=False)
    prefix = args.get("prefix", default="scaffold_")
    if in1 is None or out is None:
        print("Usage: fungalrelease in=<fa> out=<fa> [minlen= sort=t "
              "rename=f]", file=sys.stderr)
        return 1
    recs = [r for r in fastx.read_seqs(in1)
            if len(r.bases) >= min_len]
    if do_sort:
        recs.sort(key=lambda r: len(r.bases), reverse=True)
    n = 0
    with fastx.xopen(out, "wb") as fh:
        for r in recs:
            n += 1
            name = f"{prefix}{n}" if rename else r.id
            fh.write(b">" + name.encode() + b"\n")
            for j in range(0, len(r.bases), 70):
                fh.write(r.bases[j:j + 70] + b"\n")
    sys.stderr.write(f"Scaffolds out:\t{n}\n")
    return 0
