"""Pairs and length classes for the banded edit distance's tests
(``tests/test_torch_banded.py`` on the CPU, ``tests/test_torch_banded_card.py``
on the card). numpy and the port's complement table only.

``random_pairs`` gives unrelated pairs, mutated copies, lengths past E
apart, empty sides and a far longer than b; ``quad_words`` gives pairs
whose groups of four (a word of the four-lane body) mix their lanes: other
la and lb, a lane that ends early, an empty side, |lb - la| = E + 1, N,
IUPAC and lowercase bytes; ``class_case`` gives queries and one length
class of sequences for the block mapping; ``contained_case`` gives reads
and the windows dedupe's containment check cuts for them."""
import numpy as np

from bbmap_tpu_torch.core.bases import COMP_ASCII

BYTES = np.frombuffer(b"ACGTNacgt", np.uint8)


def mutate(rng, a, n_ops):
    b = a.copy()
    for _ in range(n_ops):
        op = int(rng.integers(0, 3))
        p = int(rng.integers(0, max(1, len(b))))
        if op == 0 and len(b):
            b[p] = BYTES[int(rng.integers(0, len(BYTES)))]
        elif op == 1:
            b = np.insert(b, p, BYTES[int(rng.integers(0, len(BYTES)))])
        elif len(b) > 1:
            b = np.delete(b, p)
    return b


def random_pairs(seed, n, E, max_len=300):
    """Unrelated pairs, mutated copies (up to 2E + 2 edits), lengths that
    differ by more than E, empty sides, and a far longer than b."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        la = int(rng.integers(0, max_len + 1))
        a = rng.choice(BYTES, la).astype(np.uint8)
        kind = k % 6
        if kind == 0:
            b = rng.choice(BYTES, int(rng.integers(0, max_len + 1)))
        elif kind == 1:
            b = a[:max(0, la - E - 1 - int(rng.integers(0, 5)))]
        elif kind == 2:
            b = a[:int(rng.integers(0, 4))]
        elif kind == 3 and k % 12 == 3:
            a, b = a[:0], rng.choice(BYTES, int(rng.integers(0, E + 2)))
        else:
            b = mutate(rng, a, int(rng.integers(0, 2 * E + 3)))
        out.append((a, np.asarray(b, np.uint8)))
    return out


def quad_words(seed, E, n):
    """Pairs whose words mix the lanes: each group of four holds a lane
    with another la and lb, one that ends (la short), one empty side and
    one at |lb - la| = E + 1, beside unrelated and near pairs; N, IUPAC
    and lowercase bytes; n not a multiple of 4."""
    rng = np.random.default_rng(seed)
    iupac = np.frombuffer(b"ACGTNRYacgtn", np.uint8)
    pairs = []
    for k in range(n):
        base = rng.choice(iupac, int(rng.integers(8, 48))).astype(np.uint8)
        kind = k % 8
        if kind == 0:
            a, b = base, mutate(rng, base, int(rng.integers(0, E + 2)))
        elif kind == 1:
            a, b = base[:int(rng.integers(0, 6))], base
        elif kind == 2:
            a, b = base[:0] if k % 16 == 2 else base, base[:0]
        elif kind == 3:
            a, b = base, np.concatenate([base, iupac[:E + 1]])
        elif kind == 4:
            a, b = base, rng.choice(iupac, len(base)).astype(np.uint8)
        elif kind == 5:
            a, b = base, mutate(rng, base, int(rng.integers(0, 2 * E + 3)))
        elif kind == 6:
            a, b = base[:E], base[:int(rng.integers(0, 2 * E + 1))]
        else:
            a, b = base[2:], base
        pairs.append((a, np.asarray(b, np.uint8)))
    return pairs


def stack(pairs):
    """(A (n, W), la, B (n, W), lb): the pairs' rows zero-padded."""
    W = max(1, max(max(len(a), len(b)) for a, b in pairs))
    A = np.zeros((len(pairs), W), np.uint8)
    B = np.zeros((len(pairs), W), np.uint8)
    for t, (a, b) in enumerate(pairs):
        A[t, :len(a)] = a
        B[t, :len(b)] = b
    la = np.array([len(p[0]) for p in pairs], np.int32)
    lb = np.array([len(p[1]) for p in pairs], np.int32)
    return A, la, B, lb


def class_case(seed, E, n_q, n_s):
    """Queries and one class of sequences at the edges of a length class
    (144..159 around 150 bp and past it), copies within and past E edits
    of each other, and the queries' own near copies (for the triangle)."""
    rng = np.random.default_rng(seed)
    base = [rng.choice(BYTES[:4], int(rng.integers(144, 160))).astype(
        np.uint8) for _ in range(4)]
    seqs = [mutate(rng, base[int(rng.integers(0, 4))],
                   int(rng.integers(0, 2 * E + 2))) for _ in range(n_s)]
    seqs = [x[:159] for x in seqs if len(x) >= 144]
    qs = [mutate(rng, base[int(rng.integers(0, 4))],
                 int(rng.integers(0, 2 * E + 2))) for _ in range(n_q)]
    qs += [qs[0].copy(), mutate(rng, qs[1], 1),
           rng.choice(BYTES, 150).astype(np.uint8), base[0][:143],
           np.concatenate([base[1], BYTES[:4]])[:160]]
    W = max(len(x) for x in seqs)
    sT = np.zeros((W, len(seqs)), np.uint8)
    for j, x in enumerate(seqs):
        sT[:len(x), j] = x
    Lq = max(len(x) for x in qs)
    qT = np.zeros((Lq, len(qs)), np.uint8)
    for i, x in enumerate(qs):
        qT[:len(x), i] = x
    return (qT, np.array([len(x) for x in qs], np.int32), sT,
            np.array([len(x) for x in seqs], np.int32))


def rc(x):
    """The reverse complement (core/bases.COMP_ASCII) of x."""
    return COMP_ASCII[np.asarray(x, np.uint8)][::-1].copy()


def contained_case(seed, tol, n_q=12, n_c=6, long=False):
    """Reads cut from containers (150-260 bp of ACGTNacgt) with up to 2 tol
    + 1 edits, some reverse-complemented, and for each read the windows
    dedupe cuts around its offsets in some containers (+- tol, clipped at
    a container's ends: offsets at 0, at the end and past both), beside
    unrelated windows and reads with no window; ``long``: every length ten
    times (contigs). Returns (queries, [(read, window)])."""
    rng = np.random.default_rng(seed)
    x = 10 if long else 1
    conts = [rng.choice(BYTES, int(rng.integers(150 * x, 261 * x))).astype(
        np.uint8) for _ in range(n_c)]
    reads, pairs = [], []
    for r in range(n_q):
        c = conts[int(rng.integers(0, n_c))]
        n = int(rng.integers(40 * x, 121 * x))
        q0 = (0, len(c) - n, int(rng.integers(0, len(c) - n + 1)))[r % 3]
        read = mutate(rng, c[q0:q0 + n], int(rng.integers(0, 2 * tol + 2)))
        if r % 4 == 1:
            read = rc(read)
        reads.append(read)
        if r % 6 == 5:
            continue                  # a read with no window
        for off in (q0, q0 - 3, q0 + 2)[:1 + r % 3]:
            lo, hi = max(0, off - tol), min(len(c), off + n + tol)
            pairs.append((r, c[lo:hi]))
        if r % 5 == 0:                # an unrelated window
            pairs.append((r, rng.choice(BYTES, n + 2 * tol).astype(
                np.uint8)))
    return reads, pairs
