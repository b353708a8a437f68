"""The port's k-mer set scan (``bbmap_tpu_torch.index.kmerset_device``,
torch on the CPU) against the JAX package's device programs
(``bbmap_tpu.index.kmerset_device`` on the CPU backend, forced on with
``BBMAP_DEVICE_KMERS=1`` as its own tests do) and against the numpy
search both packages keep: per-position ids, value slots and multi-owner
(row, id) pairs, and seal's per-read hit counts. Tolerance: exact."""

import numpy as np
import pytest
import torch

from bbmap_tpu.index import kmerset as jks
from bbmap_tpu.index import kmerset_device as jdev
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.index import kmerset as tks
from bbmap_tpu_torch.index import kmerset_device as tdev

BASES = np.frombuffer(b"ACGT", np.uint8)


def _seqs(rng, n, lo, hi):
    return [bytes(rng.choice(BASES, rng.integers(lo, hi)))
            for _ in range(n)]


def _reads(rng, seqs, n_reads, L, embed_frac=0.5):
    """Random reads, half carrying a segment of a set sequence (either
    strand), 1 % N and a few lowercase bases."""
    reads = rng.choice(BASES, size=(n_reads, L)).astype(np.uint8)
    for i in range(n_reads):
        if rng.random() < embed_frac:
            seg = np.frombuffer(seqs[int(rng.integers(0, len(seqs)))],
                                np.uint8)
            if rng.random() < 0.5:
                seg = tks.BASE_TO_NUMBER[seg]       # codes 0..3
                seg = BASES[3 - seg][::-1]           # reverse complement
            ln = min(len(seg), L - 2)
            at = int(rng.integers(0, L - ln + 1))
            reads[i, at:at + ln] = seg[:ln]
    reads[rng.random((n_reads, L)) < 0.01] = ord("N")
    low = rng.random((n_reads, L)) < 0.01
    reads[low] = reads[low] | 0x20               # a -> a, N -> n
    return reads


@pytest.mark.parametrize("k", [1, 2, 13, 25, 31, 32, 120, 121])
def test_rolling_kmers_match_the_reference(k):
    """The port's in-place k-mer cut gives the reference's keys (invalid
    windows included) and validity, with N, lowercase bases and windows
    longer than the read."""
    rng = np.random.default_rng(k)
    reads = _reads(rng, _seqs(rng, 3, 30, 60), 300, 120)
    reads[7, :] = ord("N")
    got, want = tks.rolling_kmers_batch(reads, k), \
        jks.rolling_kmers_batch(reads, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def device_kmers(monkeypatch):
    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "1")


@pytest.mark.parametrize("k,mask_middle,rcomp,hdist", [
    (27, True, True, 0),
    (23, True, True, 1),
    (31, False, True, 0),
    (13, True, False, 0),
    (8, True, True, 0),
])
def test_scan_ids_match_jax(k, mask_middle, rcomp, hdist):
    """scan_batch on the CPU gives the JAX program's ids and the numpy
    search's, on the five cases of the JAX package's device test."""
    rng = np.random.default_rng(42 + k)
    seqs = _seqs(rng, 5, k + 5, 80)
    ref = jks.build_kmer_set(seqs, k=k, hdist=hdist,
                             mask_middle=mask_middle, rcomp=rcomp)
    ks = convert.kmer_set(ref)
    reads = _reads(rng, seqs, 64, 101)
    want = jdev.DeviceKmerSet(ref).scan_ids(reads)
    hits, ids = tks.scan_batch(ks, reads, "cpu")
    assert ids.dtype == np.int32 and ids.shape == want.shape
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(hits, want >= 0)
    assert (want >= 0).sum() > 100
    for a, b in zip(tks.scan_batch_plain(ks, reads), (hits, ids)):
        np.testing.assert_array_equal(a, b)


def test_scan_batch_routes_match(device_kmers):
    """The public scans of both packages, each on its device route."""
    rng = np.random.default_rng(7)
    seqs = _seqs(rng, 4, 40, 90)
    ref = jks.build_kmer_set(seqs, k=23, hdist=0)
    reads = _reads(rng, seqs, 64, 120)
    tdev.reset_scans()
    for a, b in zip(tks.scan_batch(convert.kmer_set(ref), reads, "cpu"),
                    jks.scan_batch(ref, reads)):
        np.testing.assert_array_equal(a, b)
    assert tdev.scans == {"ids": 1, "slots": 0, "counts": 0}


@pytest.mark.parametrize("case", ["empty set", "reads shorter than k"])
def test_scan_empty(case):
    """An empty set gives -1 everywhere, reads shorter than k no
    positions; as the JAX package's host path does (its device scan
    declines both)."""
    rng = np.random.default_rng(3)
    if case == "empty set":
        ref = jks.build_kmer_set([], k=27)
        reads = rng.choice(BASES, (4, 50)).astype(np.uint8)
    else:
        ref = jks.build_kmer_set(_seqs(rng, 3, 40, 60), k=27)
        reads = rng.choice(BASES, (4, 20)).astype(np.uint8)
    assert jdev.device_scan_batch(ref, reads) is None
    ks = convert.kmer_set(ref)
    hits, ids = tks.scan_batch(ks, reads, "cpu")
    want_hits, want_ids = jks.scan_batch(ref, reads)
    assert ids.shape == want_ids.shape
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(hits, want_hits)
    assert (ids == -1).all()
    rows, vals = tks.scan_batch_multi(ks, reads, "cpu")
    assert rows.size == vals.size == 0
    counts = tdev.device_scan_counts(ks, reads, 3, "cpu")
    assert counts.shape == (4, 3) and not counts.any()


def _multi_owner_seqs(rng, n=6, length=300):
    """Sequences that share segments, so that k-mers have several
    owners."""
    seqs = [bytearray(rng.choice(BASES, length).tobytes()) for _ in
            range(n)]
    for i in range(1, n):
        a = int(rng.integers(0, length - 80))
        b = int(rng.integers(0, length - 80))
        seqs[i][b:b + 80] = seqs[i - 1][a:a + 80]
    return [bytes(s) for s in seqs]


@pytest.mark.parametrize("multi", [False, True])
def test_scan_counts_match_jax(device_kmers, multi):
    """Seal's count route: the (B, nrefs) hit counts equal the JAX
    program's, and the numpy reference's, for a single-owner set and a
    multi-owner set."""
    rng = np.random.default_rng(11 + multi)
    seqs = _multi_owner_seqs(rng)
    ref = jks.build_kmer_set(seqs, k=21, multi=multi)
    if multi:
        assert (np.diff(ref.multi_offsets) > 1).sum() > 100
    ks = convert.kmer_set(ref)
    reads = _reads(rng, seqs, 64, 100, embed_frac=0.9)
    nrefs = len(seqs)
    want = jdev.device_scan_counts(ref, reads, nrefs)
    assert want is not None
    tdev.reset_scans()
    got = tdev.device_scan_counts(ks, reads, nrefs, "cpu")
    assert got.dtype == np.int64 and got.shape == (64, nrefs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tdev.count_hits_plain(ks, reads,
                                                             nrefs))
    assert tdev.scans == {"ids": 0, "slots": 0, "counts": 1}
    assert got.sum() > 1000


def test_count_route_gates():
    """Past the reference's gates the count route declines and the
    caller takes the slot route."""
    rng = np.random.default_rng(5)
    seqs = _seqs(rng, 3, 60, 80)
    ks = tks.build_kmer_set(seqs, k=21, multi=True)
    reads = rng.choice(BASES, (4, 60)).astype(np.uint8)
    assert tdev.device_scan_counts(ks, reads, tdev.COUNTS_MAX_REFS + 1,
                                   "cpu") is None
    assert tdev.device_scan_counts(ks, reads, 3, "cpu") is not None


def test_scan_batch_multi_matches_jax(device_kmers):
    """Seal's slot route: flat (row, owner) pairs equal the JAX package's
    device-routed scan_batch_multi and the numpy reference."""
    rng = np.random.default_rng(13)
    seqs = _multi_owner_seqs(rng)
    ref = jks.build_kmer_set(seqs, k=21, multi=True)
    ks = convert.kmer_set(ref)
    reads = _reads(rng, seqs, 64, 100, embed_frac=0.9)
    tdev.reset_scans()
    got = tks.scan_batch_multi(ks, reads, "cpu")
    assert tdev.scans == {"ids": 0, "slots": 1, "counts": 0}
    want = jks.scan_batch_multi(ref, reads)
    assert hasattr(ref, "_slot_shadow")          # the JAX device route
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, tks.scan_batch_multi_plain(ks, reads)):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 1000


def test_device_set_cached_per_device():
    rng = np.random.default_rng(2)
    ks = tks.build_kmer_set(_seqs(rng, 2, 40, 60), k=15)
    a = tdev.device_set(ks, "cpu")
    assert tdev.device_set(ks, torch.device("cpu")) is a
    assert a.values.dtype == torch.int64 and a.ids.dtype == torch.int32
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: 'cuda' is valid here")
    with pytest.raises(RuntimeError):
        tdev.device_set(ks, "cuda")
    with pytest.raises(ValueError):
        tks.scan_batch(ks, np.zeros((1, 30), np.uint8), None)
