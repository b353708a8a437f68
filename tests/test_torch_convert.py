"""``bbmap_tpu_torch.convert`` and the port's own copies of the host
modules against the JAX package's: a genome, a k-mer index, a read batch
and a scoring profile carried across equal the reference's field by
field, and ``index.build``, ``align.seed``, ``io.sam`` and the bench
workload generators of the port give the reference's outputs on a seeded
5 kbp genome (guards the copies against drift). Tolerance: exact."""

import dataclasses
import importlib

import numpy as np
import pytest

import bench
from bbmap_tpu.align import seed as jseed
from bbmap_tpu.core import constants as jK
from bbmap_tpu.core.batch import ReadBatch as JReadBatch
from bbmap_tpu.core.genome import Genome as JGenome
from bbmap_tpu.core.genome import Scaffold as JScaffold
from bbmap_tpu.index import build as jbuild
from bbmap_tpu.io import sam as jsam
from bbmap_tpu_torch import convert, workload
from bbmap_tpu_torch.align import seed as tseed
from bbmap_tpu_torch.core import constants as tK
from bbmap_tpu_torch.core.batch import ReadBatch
from bbmap_tpu_torch.core.genome import Genome, Scaffold
from bbmap_tpu_torch.index import build as tbuild
from bbmap_tpu_torch.index.build import KmerIndex
from bbmap_tpu_torch.io import sam as tsam

BASES = np.frombuffer(b"ACGT", np.uint8)
K = 11


def same(a, b, path=""):
    """Deep equality of plain values, numpy arrays, lists and
    dataclasses, with dtypes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for n in names:
            same(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def ref_state():
    """A 5 kbp genome of two scaffolds on two chrom blocks with a few N
    bases, built and indexed by the JAX package."""
    rng = np.random.default_rng(21)
    g = rng.choice(BASES, 5000).astype(np.uint8)
    g[700:704] = ord("N")
    genome = JGenome(chroms=[g[:3000].copy(), g[3000:].copy()], scaffolds=[
        JScaffold(chrom=1, sid=1, start=0, length=3000, name="s1"),
        JScaffold(chrom=2, sid=2, start=0, length=2000, name="s2 extra")],
        name="tiny", source="seeded").finalize()
    index = jbuild.build_index(genome, K)
    jbuild.analyze_index(index, 0.01)
    return g, genome, index


def test_genome_carried_across(ref_state):
    _g, genome, _ = ref_state
    got = convert.genome(genome)
    assert type(got) is Genome and type(got.scaffolds[0]) is Scaffold
    same(got, genome, "genome")
    assert got.total_bases() == genome.total_bases() == 5000
    for chrom, loc in ((1, 0), (1, 2999), (2, 5), (2, 1999)):
        s_t, o_t = got.locate(chrom, loc)
        s_j, o_j = genome.locate(chrom, loc)
        assert (s_t.name, o_t) == (s_j.name, o_j)
    for a, b in zip(got.packed_codes(), genome.packed_codes()):
        same(a, b, "packed_codes")


def test_index_carried_across(ref_state):
    _g, _genome, index = ref_state
    got = convert.index(index)
    assert type(got) is KmerIndex
    same(got, index, "index")
    assert index.counts_canonical is not None
    assert index.length_histogram is not None
    assert got.n_keys == 4 ** K
    key = int(np.argmax(np.diff(index.starts)))
    same(got.get_sites(key), index.get_sites(key), "get_sites")


def test_read_batch_carried_across():
    rng = np.random.default_rng(2)
    B, L = 7, 40
    mate = JReadBatch(bases=rng.choice(BASES, (B, L)).astype(np.uint8),
                      quality=None, lengths=np.full(B, L, np.int32),
                      ids=[f"m{i}" for i in range(B)],
                      numeric_ids=np.arange(B, dtype=np.int64))
    ref = JReadBatch(bases=rng.choice(BASES, (B, L)).astype(np.uint8),
                     quality=rng.integers(2, 41, (B, L)).astype(np.int8),
                     lengths=rng.integers(20, L + 1, B).astype(np.int32),
                     ids=[f"r{i}" for i in range(B)],
                     numeric_ids=np.arange(B, dtype=np.int64) + 100,
                     mate=mate)
    got = convert.read_batch(ref)
    assert type(got) is ReadBatch and type(got.mate) is ReadBatch
    same(got, ref, "batch")
    assert got.size == ref.size and got.lmax == ref.lmax
    same(got.bases_rc(), ref.bases_rc(), "bases_rc")
    assert convert.read_batch(None) is None


@pytest.mark.parametrize("name", ["SHORT_PROFILE", "PACBIO_PROFILE"])
def test_profile_carried_across(name):
    ref = getattr(jK, name)
    got = convert.profile(ref)
    assert type(got) is tK.ScoringProfile
    assert got._fields == ref._fields
    assert tuple(got) == tuple(ref) == tuple(getattr(tK, name))
    for L in (50, 150, 6000):
        assert got.max_quality(L) == ref.max_quality(L)
        assert got.max_imperfect_score(L) == ref.max_imperfect_score(L)


def test_constants_copy_matches():
    """Every public plain constant of core/constants.py."""
    names = [n for n in dir(jK) if n.isupper()
             and isinstance(getattr(jK, n), (int, float, str, tuple))]
    assert len(names) > 40
    for n in names:
        assert tuple([getattr(tK, n)]) == tuple([getattr(jK, n)]), n


def test_index_build_copy_matches(ref_state):
    """build_index + analyze_index of the port on the carried genome
    give the reference's index, every field."""
    _g, genome, index = ref_state
    got = tbuild.build_index(convert.genome(genome), K)
    tbuild.analyze_index(got, 0.01)
    same(got, index, "index")
    keys = np.arange(0, 4 ** K, 997, dtype=np.int64)
    same(tbuild.reverse_complement_key(keys, K),
         jbuild.reverse_complement_key(keys, K), "rc keys")
    codes = index.genome_codes[:600]
    for a, b in zip(tbuild.rolling_keys(codes, K),
                    jbuild.rolling_keys(codes, K)):
        same(a, b, "rolling_keys")


def _public_functions(mod):
    return sorted(n for n, v in vars(mod).items()
                  if callable(v) and not n.startswith("_")
                  and getattr(v, "__module__", None) == mod.__name__)


def test_seed_copy_matches(ref_state):
    """align/seed.py: the same public functions; offsets (plain and
    quality-driven), keys and the batch candidate tables agree on seeded
    reads of the 5 kbp genome."""
    g, _genome, index = ref_state
    assert _public_functions(tseed) == _public_functions(jseed)
    tindex = convert.index(index)
    L = 100
    for n in (40, 100, 150, 400):
        same(tseed.key_density_ladder(n, K), jseed.key_density_ladder(n, K),
             "ladder")
        same(tseed.make_offsets(n, K), jseed.make_offsets(n, K), "offsets")
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 2800, 24)
    reads = np.stack([g[s:s + L] for s in starts]).copy()
    reads[::5, 17] = ord("N")
    reads[1::4, 60] = BASES[0]
    qual = rng.integers(2, 41, (24, L)).astype(np.int8)
    qual[::3, 20:50] = 2
    offs = jseed.make_offsets(L, K)
    same(tseed.keys_batch(reads, offs, K), jseed.keys_batch(reads, offs, K),
         "keys_batch")
    for i in range(4):
        same(tseed.make_offsets_quality(qual[i], L, K),
             jseed.make_offsets_quality(qual[i], L, K), "offsets_quality")
        same(tseed.keys_at_offsets(reads[i], offs, K),
             jseed.keys_at_offsets(reads[i], offs, K), "keys_at_offsets")
    same(tseed.quality_offsets_batch(qual, L, K, offs),
         jseed.quality_offsets_batch(qual, L, K, offs), "quality offsets")
    for q in (None, qual):
        ct = tseed.gather_candidates_batch(tindex, reads, L, quality=q)
        cj = jseed.gather_candidates_batch(index, reads, L, quality=q)
        assert ct is not None and cj is not None
        same(ct, cj, "candidates")


def test_sam_copy_matches(ref_state):
    """io/sam.py: the same public functions; header, CIGAR, NM, MD, MAPQ
    and flag helpers agree."""
    g, genome, _index = ref_state
    assert _public_functions(tsam) == _public_functions(jsam)
    assert tsam.sam_header(convert.genome(genome)) == jsam.sam_header(genome)
    cha = g[:3000]
    for match, start in ((b"mmmmSmmmDDmmmIImmmmmmmmmmmm", 40),
                         (b"XXmmmmNmmmmmmmmmmmmYY", -2),
                         (b"m" * 30, 100), (b"IImmmmmSSmmmmmDmmmmmmmII", 500)):
        rlen = sum(ch not in b"D" for ch in match)
        stop = start + sum(ch not in b"IXY" for ch in match) - 1
        for ver in (1.3, 1.4):
            ct = tsam.match_to_cigar(match, start, stop, 3000, ver)
            assert ct == jsam.match_to_cigar(match, start, stop, 3000, ver)
        assert tsam.calc_nm(match, ct, rlen) == jsam.calc_nm(match, ct, rlen)
        call = bytes(g[100:100 + rlen])
        assert tsam.make_md_tag(match, call, cha, max(start, 0), 0, 3000) \
            == jsam.make_md_tag(match, call, cha, max(start, 0), 0, 3000)
        same(tsam.score_match_symbols(match),
             jsam.score_match_symbols(match), "symbols")
        assert tsam.to_local_alignment(match) == \
            jsam.to_local_alignment(match)
    for score, length in ((300, 100), (1480, 150), (20, 100)):
        for ambig in (False, True):
            assert tsam.to_mapq(score, length, True, ambig) == \
                jsam.to_mapq(score, length, True, ambig)
    for args in ((True, True, 0, 1, True, 0, True),
                 (True, False, 1, None, True, 1, False),
                 (False, None, 0, None, False, 0, False)):
        assert tsam.make_flag(*args) == jsam.make_flag(*args)


# names a copied module has beyond its reference: io.native keeps and
# reports why the native host library did not load
PORT_ADDED = {"io.native": {"sys", "load_error"}}


@pytest.mark.parametrize("mod", [
    "core.bases", "core.batch", "core.constants", "core.genome", "io.fastx",
    "io.sam", "io.native", "io.bam", "io.pigz", "index.build", "align.seed",
    "ops.msa_ref", "ops.gref", "utils.args", "utils.readstats",
    "utils.watchdog", "tools.randomreads", "tools.gradesam"])
def test_copied_module_has_the_reference_names(mod):
    """Each copied module defines what the reference module defines, and
    beside it only what the port added on purpose."""
    j = importlib.import_module("bbmap_tpu." + mod)
    p = importlib.import_module("bbmap_tpu_torch." + mod)
    names = [n for n in vars(j) if not n.startswith("__")]
    assert names and sorted(names) == sorted(
        n for n in vars(p)
        if not n.startswith("__") and n not in PORT_ADDED.get(mod, ()))


def test_workload_copy_matches_bench():
    """workload.make_genome / make_pairs give bench.py's bytes."""
    same(workload.make_genome(n=60_000, seed=7),
         bench.make_genome(n=60_000, seed=7), "genome")
    g = bench.make_genome(n=60_000, seed=3)
    for a, b in zip(workload.make_pairs(g, 300, L=150, seed=11),
                    bench.make_pairs(g, 300, L=150, seed=11)):
        same(a, b, "pairs")


def test_trim_copy_matches():
    from bbmap_tpu.tools.bbduk import optimal_trim_points as jtrim
    from bbmap_tpu_torch.utils.qtrim import optimal_trim_points as ttrim
    rng = np.random.default_rng(8)
    B, L = 16, 60
    bases = rng.choice(BASES, (B, L)).astype(np.uint8)
    bases[::4, 5] = ord("N")
    qual = rng.integers(2, 41, (B, L)).astype(np.int8)
    qual[:, :6] = 2
    qual[::3, -9:] = 3
    lengths = rng.integers(30, L + 1, B).astype(np.int32)
    for trimq in (6, 10, 20):
        same(ttrim(bases, qual, lengths, trimq),
             jtrim(bases, qual, lengths, trimq), "trim")
    same(ttrim(bases, None, lengths, 10), jtrim(bases, None, lengths, 10),
         "no quality")
