"""``python -m bbmap_tpu_torch dedupe`` / ``dedupe2`` (device=cpu) write
byte-equal files and reports to the JAX package's tools (run on the CPU:
the numpy sweep for e=, the jitted scan for the contained-with-edits
check) in every mode: exact, rc=f, s=, e=, containment with and without
a tolerance, overlap clustering with its stats, graph and cluster files,
and dedupe2's nam=."""

import re
import sys

import numpy as np
import pytest

from bbmap_tpu import __main__ as jax_main
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu_torch import __main__ as port_main

BASES = np.frombuffer(b"ACGT", np.uint8)


def _fastq(path, recs):
    with open(path, "w") as fh:
        for name, seq, q in recs:
            fh.write(f"@{name}\n{seq.decode()}\n+\n{q}\n")


def _fasta(path, recs):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f">{name}\n{seq.decode()}\n")


def _edit(rng, s: bytes, n: int, indels: bool) -> bytes:
    a = np.frombuffer(s, np.uint8).copy()
    for _ in range(n):
        p = int(rng.integers(5, len(a) - 5))
        op = int(rng.integers(0, 3)) if indels else 0
        if op == 0:
            a[p] = BASES[(int(np.searchsorted(BASES, a[p])) + 1) % 4] \
                if a[p] in BASES else ord("A")
        elif op == 1:
            a = np.insert(a, p, BASES[int(rng.integers(0, 4))])
        else:
            a = np.delete(a, p)
    return bytes(a)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded library of ~300 reads from a 6 kbp genome (120-180 bp, so
    that reads overlap) with exact copies, reverse-complement copies, near
    copies (1-2 substitutions, or 1-2 edits with indels), contained
    fragments (some reverse-complemented, some with a substitution) and a
    few N; and the containment inputs of tests/test_dedupe_containment.py
    and tests/test_small_tools.py as FASTA."""
    d = tmp_path_factory.mktemp("dedupe")
    rng = np.random.default_rng(29)
    g = bytes(rng.choice(BASES, 6000))
    base = []
    for i in range(180):
        L = int(rng.integers(120, 181))
        s = int(rng.integers(0, len(g) - L))
        seq = g[s:s + L]
        if i % 37 == 0:
            seq = seq[:40] + b"N" + seq[41:]
        base.append(seq)
    recs = [(f"r{i}", s) for i, s in enumerate(base)]
    for k in range(120):
        src = base[int(rng.integers(0, len(base)))]
        kind = k % 6
        if kind == 0:
            seq = src
        elif kind == 1:
            seq = bytes(COMP_ASCII[np.frombuffer(src, np.uint8)][::-1])
        elif kind == 2:
            seq = _edit(rng, src, int(rng.integers(1, 3)), indels=False)
        elif kind == 3:
            seq = _edit(rng, src, int(rng.integers(1, 3)), indels=True)
        else:
            L = (70, 90)[k % 2]
            s = int(rng.integers(0, len(src) - L))
            seq = src[s:s + L]
            if k % 4 == 0:
                seq = bytes(COMP_ASCII[np.frombuffer(seq, np.uint8)][::-1])
            if k % 5 == 0:
                seq = _edit(rng, seq, 1, indels=False)
        recs.append((f"d{k}_{kind}", seq))
    order = rng.permutation(len(recs))
    lib = [recs[i] for i in order]
    _fastq(d / "lib.fq", [(n, s, "".join(chr(33 + int(q)) for q in
                                         rng.integers(10, 41, len(s))))
                          for n, s in lib])
    # tests/test_dedupe_containment.py and tests/test_small_tools.py inputs
    r1 = np.random.default_rng(1)
    big = bytes(r1.choice(BASES, 400))
    r2 = np.random.default_rng(2)
    big2 = bytes(r2.choice(BASES, 400))
    arr = np.frombuffer(big2[120:260], np.uint8).copy()
    arr[10] = ord("A") if arr[10] != ord("A") else ord("C")
    arr[70] = ord("G") if arr[70] != ord("G") else ord("T")
    r3 = np.random.default_rng(3)
    big3 = bytes(r3.choice(BASES, 500))
    rc = COMP_ASCII[np.frombuffer(big3[200:340], np.uint8)][::-1].copy()
    r4 = np.random.default_rng(4)
    r11 = np.random.default_rng(11)
    big11 = bytes(r11.choice(BASES, 400))
    r12 = np.random.default_rng(12)
    s = bytes(r12.choice(BASES, 150))
    s2 = bytearray(s)
    del s2[70]
    s2.append(ord("A"))
    _fasta(d / "contain.fa", [
        ("big", big), ("small", big[100:220]), ("big2", big2),
        ("small2", bytes(arr)), ("big3", big3),
        ("rcsmall", bytes(np.delete(rc, 50))),
        ("a", bytes(r4.choice(BASES, 300))), ("b", bytes(r4.choice(BASES, 120))),
        ("big11", big11), ("sub", big11[77:260]),
        ("other", bytes(r11.choice(BASES, 200))), ("e1", s), ("e2", bytes(s2))])
    return d


# case -> (tool, input, arguments); {o} is the run's output directory
CASES = {
    "exact": ("dedupe", "lib.fq", ["ac=f"]),
    "rc=f": ("dedupe", "lib.fq", ["rc=f", "ac=f"]),
    "s=2": ("dedupe", "lib.fq", ["s=2", "ac=f"]),
    "e=2": ("dedupe", "lib.fq", ["e=2", "ac=f"]),
    "ac=t": ("dedupe", "lib.fq", ["ac=t"]),
    "s=2 ac=t": ("dedupe", "lib.fq", ["s=2", "ac=t"]),
    "e=2 ac=t containment": ("dedupe", "contain.fa", ["e=2", "ac=t"]),
    "s=2 ac=t containment": ("dedupe", "contain.fa", ["s=2", "ac=t"]),
    "fo=t c=t": ("dedupe", "lib.fq", [
        "ac=t", "fo=t", "c=t", "mo=100", "csf={o}/stats.txt",
        "dot={o}/graph.dot", "pattern={o}/cluster_%.fq"]),
    "dedupe2 nam=3": ("dedupe2", "lib.fq", ["nam=3", "e=1",
                                            "csf={o}/stats.txt"]),
    "dedupe2 nam=0": ("dedupe2", "lib.fq", ["nam=0"]),
}


def _run(monkeypatch, capsys, side, tool, args):
    if side == "port":
        monkeypatch.setattr(sys, "argv", ["bbmap_tpu_torch", tool, *args,
                                          "device=cpu"])
        main = port_main.main
    else:
        monkeypatch.setattr(sys, "argv", ["bbmap_tpu", tool, *args])
        main = jax_main.main
    capsys.readouterr()
    rc = main()
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("case", list(CASES))
def test_dedupe_byte_equal(corpus, tmp_path, monkeypatch, capsys, case):
    tool, inp, template = CASES[case]
    runs = {}
    for side in ("port", "jax"):
        o = tmp_path / side
        o.mkdir()
        args = [f"in={corpus / inp}", f"out={o}/unique.fq",
                f"outd={o}/dups.fq"] + [a.format(o=o) for a in template]
        rc, out, err = _run(monkeypatch, capsys, side, tool, args)
        files = {p.name: p.read_bytes() for p in sorted(o.iterdir())}
        runs[side] = (rc, out, err.replace(str(o), "{o}"), files)
    assert runs["port"] == runs["jax"]
    rc, _out, err, files = runs["port"]
    if case == "dedupe2 nam=0":
        assert rc == 1 and "numaffixmaps" in err
        return
    assert rc == 0
    n_in, n_dup = (int(re.search(rf"{k}:\t(\d+)", err).group(1))
                   for k in ("Input", "Duplicates"))
    assert n_in > 0 and 0 < n_dup < n_in
    assert files["unique.fq"] and files["dups.fq"]
    if case == "fo=t c=t":
        assert {"stats.txt", "graph.dot"} <= set(files)
        assert sum(n.startswith("cluster_") for n in files) > 1
        assert "Overlap edges" in err


@pytest.mark.parametrize("block", [1, 3, 256])
@pytest.mark.parametrize("case", ["e=2", "e=2 ac=t containment",
                                  "s=2 ac=t containment", "dedupe2 nam=3"])
def test_dedupe_blocks_byte_equal(corpus, tmp_path, monkeypatch, capsys,
                                  case, block):
    """The e= check and the containment check in blocks of 1, 3 and 256
    reads (the store and the containers as they stood before the block,
    the block's reads against each other and against the containers kept
    earlier in the block, the decisions in read order) write the JAX
    tools' bytes."""
    from bbmap_tpu_torch.tools import dedupe as tdd
    monkeypatch.setattr(tdd, "BLOCK", block)
    test_dedupe_byte_equal(corpus, tmp_path, monkeypatch, capsys, case)


def test_chain_inside_one_block():
    """Read A is kept; B lies within 2 edits of A and is a duplicate; C lies
    within 2 of B but 4 of A, and is kept, since B was not: in one block as
    one read at a time, and as the JAX package decides."""
    from bbmap_tpu.tools import dedupe as jdd
    from bbmap_tpu_torch.tools import dedupe as tdd
    rng = np.random.default_rng(8)
    a = rng.choice(BASES, 150).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[[30, 90]] = BASES[(np.searchsorted(BASES, a[[30, 90]]) + 1) % 4]
    c[[30, 90]] = b[[30, 90]]
    c[[50, 120]] = BASES[(np.searchsorted(BASES, a[[50, 120]]) + 1) % 4]

    class Rec:
        def __init__(self, name, seq):
            self.id, self.bases, self.quality = name, bytes(seq), None

    recs = [Rec(n, x) for n, x in (("A", a), ("B", b), ("C", c))]
    want = [(r.id, d) for r, d in jdd.dedupe_stream(
        recs, True, 0, 2, False)]
    got = [(r.id, d) for r, d in tdd.dedupe_stream(
        recs, True, 0, 2, False, device="cpu")]
    assert got == want == [("A", False), ("B", True), ("C", False)]


class _Rec:
    def __init__(self, name, seq):
        self.id, self.bases, self.quality = name, bytes(seq), None


def _forward(rng, n):
    """n random bases that start and end with A, so that they are their
    own canonical orientation (dedupe keeps min(seq, rc))."""
    x = rng.choice(BASES, n).astype(np.uint8)
    x[0] = x[-1] = ord("A")
    return x


def _subs(x, at):
    y = x.copy()
    y[at] = BASES[(np.searchsorted(BASES, y[at]) + 1) % 4]
    return y


def _both_streams(monkeypatch, recs, block, mode):
    """dedupe_stream of both packages over recs with ac=t and tol 2 (e=2
    or s=2), the port in blocks of ``block``; the port's containment
    checks recorded: the block launches' query columns and each in-block
    check's result by read."""
    from bbmap_tpu.tools import dedupe as jdd
    from bbmap_tpu_torch.ops import banded_device as tbd
    from bbmap_tpu_torch.tools import dedupe as tdd
    subs, edits = (0, 2) if mode == "e" else (2, 0)
    seen = {"block": 0, "in_block": []}
    check, block_check = tdd._contained_in_block, tbd.contained_any

    def in_block(can, *a, **k):
        got = check(can, *a, **k)
        seen["in_block"].append((can, got))
        return got

    def counted(*a, **k):
        seen["block"] += 1
        return block_check(*a, **k)
    counted.__dict__ = block_check.__dict__   # the wrapper's own counts
    monkeypatch.setattr(tdd, "BLOCK", block)
    monkeypatch.setattr(tdd, "_contained_in_block", in_block)
    monkeypatch.setattr(tbd, "contained_any", counted)
    want = [(r.id, d) for r, d in jdd.dedupe_stream(recs, True, subs, edits,
                                                     True)]
    got = [(r.id, d) for r, d in tdd.dedupe_stream(
        recs, True, subs, edits, True, device="cpu")]
    assert got == want
    return dict(got), seen


@pytest.mark.parametrize("mode", ["e", "s"])
@pytest.mark.parametrize("block", [3, 512])
@pytest.mark.parametrize("gap", [1, 100])
def test_container_kept_in_the_same_block(monkeypatch, mode, block, gap):
    """A read whose only container was kept earlier in its own block (the
    next read, or a read 100 places later): a duplicate within 1
    substitution, found by the in-block check, as the JAX package finds
    it one read at a time; where the block is smaller than the gap, the
    block check against the containers kept before finds it. An exact
    fragment of the same container is a duplicate too."""
    rng = np.random.default_rng(17 + gap)
    recs = [_Rec(f"f{i}", _forward(rng, int(rng.integers(100, 900))))
            for i in range(6 + gap + 12)]
    cont = _forward(rng, 200)
    cont[31] = cont[150] = ord("A")
    recs[6] = _Rec("C", cont)
    recs[6 + gap] = _Rec("R", _subs(cont[31:151], 60))
    recs[6 + gap + 3] = _Rec("X", cont[31:151])
    got, seen = _both_streams(monkeypatch, recs, block, mode)
    assert not got["C"] and got["R"] and got["X"]
    assert sum(got.values()) == 2
    same_block = 6 // block == (6 + gap) // block
    in_block = [hit for can, hit in seen["in_block"]
                if can == recs[6 + gap].bases]
    if same_block:
        assert in_block == [True] and seen["block"] == 0
    else:
        assert in_block == [] and seen["block"] >= 1


@pytest.mark.parametrize("mode", ["e", "s"])
@pytest.mark.parametrize("block", [3, 512])
def test_containers_before_and_inside_the_block(monkeypatch, mode, block):
    """A read with a container kept before its block (3 substitutions off,
    past the tolerance) and one kept earlier inside its block (1
    substitution off): the block check finds the first and rejects it, the
    in-block check finds the second, and the read is a duplicate, as in
    the JAX package; another read 1 off the first container alone is a
    duplicate by the block check."""
    rng = np.random.default_rng(23)
    recs = [_Rec(f"f{i}", _forward(rng, int(rng.integers(100, 900))))
            for i in range(2 * block + 8)]
    core = _forward(rng, 120)
    c1 = np.concatenate([_forward(rng, 62), core, _forward(rng, 40)])
    c2 = np.concatenate([_forward(rng, 31), _subs(core, [58, 59]),
                         _forward(rng, 50)])
    at = 2 * block
    recs[0] = _Rec("C1", c1)
    recs[at] = _Rec("C2", c2)
    recs[at + 1] = _Rec("R", _subs(core, [58, 59, 60]))
    recs[at + 4] = _Rec("S", _subs(core, 20))
    got, seen = _both_streams(monkeypatch, recs, block, mode)
    assert not got["C1"] and not got["C2"] and got["R"] and got["S"]
    assert sum(got.values()) == 2
    assert [hit for can, hit in seen["in_block"]
            if can == recs[at + 1].bases] == [True]
    assert seen["block"] >= 1
