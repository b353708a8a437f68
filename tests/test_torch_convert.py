"""``bbmap_tpu_torch.convert`` and the port's own copies of the host
modules against the JAX package's: a genome, a k-mer index, a read batch
and a scoring profile carried across equal the reference's field by
field, and ``index.build``, ``align.seed``, ``io.sam`` and the bench
workload generators of the port give the reference's outputs on a seeded
5 kbp genome (guards the copies against drift). Tolerance: exact."""

import dataclasses
import importlib
from pathlib import Path

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
# reports why the native host library did not load; the k-mer scans and
# the overlap ladders keep their numpy bodies as plain references beside
# the entry points that take a device; the tools resolve their device=;
# kcount's device class hashes in int64 and counts its calls; rqcfilter
# names an absent reference and splits interleaved pairs; banded_device is
# a torch rewrite: the plain version, the kernel's wrapper with its launch
# counts and library, the block kernel's wrapper and plain version, and
# the device store of dedupe's kept sequences, the containment kernel's
# wrapper, its rule, plain version and staging; dedupe checks its reads in
# blocks and splits the containment check into the functions the block
# calls
PORT_ADDED = {
    "ops.banded_device": {"banded_edit_batch_plain", "banded_edit",
                          "backend", "torch", "ctypes", "Optional",
                          "_build", "I32", "MAPPINGS", "PLAIN_CHECK_ROWS",
                          "SequenceStore", "_check", "_lib", "_on_cuda",
                          "_vs_query", "reset_launches", "Dict",
                          "length_class", "class_width", "SITES",
                          "BLOCK_TILE", "BLOCK_MAX_E", "BLOCK_MAX_GROUP",
                          "BLOCK_AIM_PER_SM", "BLOCK_STAGE_MAX",
                          "BLOCK_QUAD_TILE", "CONTAINED_MAPPINGS", "BODIES",
                          "_CONTAINED_CODES", "CONTAINED_SPLIT_BELOW",
                          "CONTAINED_SPLIT_MAX_CELLS", "THREAD_MAX_CELLS",
                          "CONTAINED_STAGE_PAIRS", "CONTAINED_STAGE_MAX",
                          "contained_stage_bytes", "contained_mapping",
                          "words_fit", "_quad_layout", "_pick",
                          "_pair_minor",
                          "PLAIN_ANY_PAIRS", "ANY_MODES", "_check_any",
                          "banded_any_plain", "banded_any", "block_groups",
                          "upload_block", "COMP_ASCII",
                          "_check_contained", "_reverse_complements",
                          "contained_any_plain", "contained_any",
                          "upload_windows"},
    "tools.dedupe": {"backend", "torch", "BLOCK", "COMP_BYTES", "_offsets",
                     "_probes", "_candidates", "_exact", "_windows",
                     "_contained_in_block"},
    "tools.bbsplit": {"backend"},
    "io.native": {"sys", "load_error"},
    "index.kmerset": {"scan_batch_plain", "scan_batch_multi_plain",
                      "_expand_hits"},
    "ops.overlap": {"mate_by_overlap_batch_plain",
                    "mate_by_overlap_ratio_batch_plain"},
    "tools.bbduk": {"backend"}, "tools.bbduk2": {"backend"},
    "tools.seal": {"backend"}, "tools.bbmerge": {"backend"},
    "index.kcount": {"Dict", "torch", "backend", "_signed", "_SALTS",
                     "_FINAL", "ROUTES", "calls", "reset_calls"},
    "tools.rqcfilter": {"_reference", "_deinterleave"},
    # the process group: its timeout, rank 0's store servers kept from one
    # group to the next (_SERVERS) and the call that leaves it; the end
    # of a striped run that every striped tool shares (sidecar of counts,
    # barrier, merge and sum on host 0), with its two helpers
    "parallel.multihost": {"datetime", "INIT_TIMEOUT_S", "_SERVERS",
                           "shutdown", "finish_stripes", "_plain", "_add",
                           "Iterable"},
    # sharded: the Mesh of torch devices is a class of the module (the
    # JAX module imports jax's), and its builders take a device; the
    # shard_map body (_shard_worker) is the candidate stage, the gather
    # and _shard_finalize, gloo's all-gather is _allgather, K1's entry
    # point scores the step, the shard DeviceIndex is a
    # dataclasses.replace of the index, and dryrun_multichip is the
    # counterpart of __graft_entry__.dryrun_multichip
    "parallel.sharded": {"torch", "dataclasses", "Dict", "List",
                         "Sequence", "DeviceLike", "resolve_device",
                         "msa_kernels", "seed_host", "_shard_finalize",
                         "_allgather", "dryrun_multichip"},
    # build_device is a torch rewrite: it takes a device, and fills
    # starts by a binary search over the keyspace in chunks of
    # SEARCH_CHUNK keys (I32 / I64 are its dtypes)
    "index.build_device": {"torch", "DeviceLike", "resolve_device", "I32",
                           "I64", "SEARCH_CHUNK"},
    # msa_selftest checks the CUDA kernels (kernel_selftest, which takes a
    # device) in place of the Pallas kernels, and its oracle's answers can
    # be computed beforehand (selftest_cases), with no device
    "ops.msa_selftest": {"torch", "DeviceLike", "resolve_device",
                         "selftest_cases", "kernel_selftest"},
    # rescue_device: the rescue kernel's wrapper (rescue_scan) with its
    # launch count, library and checks, and the one-copy upload of a
    # batch's jobs; the index is the port's DeviceIndex
    "ops.rescue_device": {"torch", "ctypes", "DeviceIndex", "_build",
                          "_lib", "_check", "rescue_scan", "reset_launches",
                          "upload_jobs"},
    # quickmap_device: the device index as an nn.Module with its device
    # checks, int64 / int32 helpers for torch's missing uint32 shifts and
    # JAX's argmax / top_k ties, and the quality-offsets kernel's wrapper
    # (quality_offsets_kernel, its launch count, library, the device copies
    # of its host tables and its float32 thresholds); the key-retention
    # kernel's wrapper and library; the gapless kernel's wrapper, library,
    # plain version (_gapless_scores_plain) and points (_points), the
    # read on a candidate's strand against the genome (_on_strand, which
    # both the plain version and _best_sym use), the winner's match
    # symbols (_best_sym); the chain segmentation as a
    # function of its own (_chain_segments); the slot pack's wrapper,
    # library, plain version and its budget (slot_pack_kernel,
    # _slot_pack_lib, _slot_pack_plain, _slot_counts), and the chain
    # step's wrapper, library, plain version and its sort and table
    # (chain_candidates_kernel, _chain_lib, _chain_candidates_plain,
    # _sort_rows, _candidate_table), the retention and gapless kernels'
    # mappings and their rules (RETENTION_*, retention_mapping, GAPLESS_*,
    # gapless_mapping), the chain kernel's two mappings and
    # its choice between them (CHAIN_MAPPINGS, CHAIN_REGS_MAX_W,
    # chain_mapping); the packed quality entry's wrapper and the launch
    # operands both quality entries share (quality_offsets_packed_kernel,
    # _quality_launch_args); the packed table's site limit as a constant
    # that tests set to force the two-gather lookup (SCNT_MAX_SITES)
    "align.quickmap_device": {"torch", "nn", "ctypes", "DeviceIndex",
                              "DeviceLike", "resolve_device", "F32", "I64",
                              "_first_true", "_stable_desc", "_wrap32",
                              "_build", "_L1", "_L2", "_quality_lib",
                              "_offset_tables", "_offset_tables_np",
                              "quality_offsets_kernel", "reset_launches",
                              "_retention_lib", "ref_retention_kernel",
                              "_gapless_lib", "gapless_scores_kernel",
                              "_gapless_scores_plain", "_points",
                              "_on_strand", "_best_sym",
                              "_chain_segments", "slot_pack_kernel",
                              "_slot_pack_lib", "_slot_pack_plain",
                              "_slot_counts", "chain_candidates_kernel",
                              "_chain_lib", "_chain_candidates_plain",
                              "_sort_rows", "_candidate_table",
                              "CHAIN_MAPPINGS", "CHAIN_REGS_MAX_W",
                              "chain_mapping", "RETENTION_MAPPINGS",
                              "RETENTION_REGS_MAX_NK",
                              "RETENTION_BLOCK_MAX_NK", "retention_mapping",
                              "GAPLESS_MAPPINGS", "GAPLESS_WARP_BELOW",
                              "GAPLESS_WARP_MAX_K", "gapless_mapping",
                              "SLOT_PACK_MAPPINGS", "SLOT_PACK_BLOCK_FROM",
                              "SLOT_PACK_WARP_MAX_NK",
                              "SLOT_PACK_BLOCK_MAX_NK", "slot_pack_mapping",
                              "quality_offsets_packed_kernel",
                              "_quality_launch_args", "SCNT_MAX_SITES"}}
# names a copy leaves out on purpose: rqcfilter's default reference paths
# under the machine's reference directory (the port takes every reference
# from the command line); kcount's rewritten device class needs no
# Optional. kcount's BBMAP_DEVICE_KCA switch was inside make_kca and
# leaves no name; make_kca decides by its device= alone. banded_device
# leaves out the BBMAP_DEVICE_BANDED switch (_enabled, os), the program
# cache (_CACHE) and the jitted scan (_program), which the plain version
# and the kernel replace
PORT_DROPPED = {
    "ops.banded_device": {"_enabled", "_CACHE", "os", "_program", "Tuple"},
    "tools.rqcfilter": {"RESOURCES", "DEFAULT_ADAPTERS", "DEFAULT_PHIX",
                        "DEFAULT_LFPE_LINKER", "DEFAULT_CLRS_LINKER",
                        "DEFAULT_ARTIFACTS"},
    "index.kcount": {"Optional"},
    # jax itself, its sharding types, jnp and the vmapped DP step
    # (msa_jax) are the JAX package's; shard_batch was device_put with a
    # PartitionSpec (build_sharded_quickmap splits a batch itself), and
    # _shard_worker / functools / Tuple went with the shard_map body.
    # multihost's concatenation of shards without an .idx sidecar goes:
    # every ShardWriter, the JAX package's too, writes the sidecar
    "parallel.multihost": {"jax", "_merge_shards_concat", "List"},
    "parallel.sharded": {"jax", "jnp", "NamedSharding", "P", "msa_jax",
                         "shard_batch", "_shard_worker", "functools",
                         "Tuple"},
    # build_device imports MODULO and reverse_complement_key and uses
    # neither (the modulo mode is build_index's); pallas_selftest is the
    # Pallas kernels' check, kernel_selftest the CUDA kernels'
    "index.build_device": {"MODULO", "reverse_complement_key"},
    "ops.msa_selftest": {"pallas_selftest"},
    # the JAX programs' device arrays and gathers: the port's DeviceIndex
    # holds the arrays (device_arrays, scnt_array, ccnt_array), torch
    # gathers directly (take_flat, take_along_flat, onehot_take_rows,
    # _gather_words and their lookup tables), and uint32 words are int64
    "ops.rescue_device": {"jax", "jnp", "Optional", "device_arrays"},
    "align.quickmap_device": {"jax", "jnp", "U32", "device_arrays",
                              "scnt_array", "ccnt_array", "take_flat",
                              "take_along_flat", "onehot_take_rows",
                              "_gather_words", "BASE_TO_NUMBER",
                              "_COMP_TABLE", "_UNPACK_LUT", "_a", "_b",
                              "_s"}}


@pytest.mark.parametrize("mod", [
    "core.bases", "core.batch", "core.constants", "core.genome", "io.fastx",
    "io.sam", "io.native", "io.bam", "io.pigz", "index.build", "align.seed",
    "ops.msa_ref", "ops.gref", "utils.args", "utils.readstats",
    "utils.watchdog", "tools.randomreads", "tools.gradesam",
    "index.kmerset", "ops.overlap", "tools.bbmask", "tools.taxonomy",
    "tools.bbduk", "tools.bbduk2", "tools.seal", "tools.bbmerge",
    "index.kmer_big", "tools.kmercountexact", "index.kcount",
    "tools.tadpole", "tools.bbnorm", "tools.pileup", "tools.covtools",
    "tools.pairtools", "tools.rqcfilter", "ops.banded", "ops.banded_device",
    "tools.dedupe", "tools.bbsplit", "tools.reformat", "tools.stats",
    "tools.comparesam", "tools.samtoroc", "tools.calctruequality",
    "tools.clumpify", "tools.loglog", "tools.sketch", "tools.bbcountunique",
    "tools.recluster", "tools.idtools", "tools.removesmartbell",
    "tools.smalltools", "tools.synth", "tools.barcodes", "tools.sorttools",
    "tools.callvariants", "tools.misc", "tools.pacbio", "tools.textutils",
    "tools.liftover", "parallel.multihost", "parallel.sharded",
    "align.search_oracle", "index.build_device", "ops.msa_selftest",
    "ops.rescue_device", "align.quickmap_device"])
def test_copied_module_has_the_reference_names(mod):
    """Each copied module defines what the reference module defines, less
    what it leaves out on purpose, and beside it only what the port added
    on purpose."""
    j = importlib.import_module("bbmap_tpu." + mod)
    p = importlib.import_module("bbmap_tpu_torch." + mod)
    assert not PORT_DROPPED.get(mod, set()) & set(vars(p))
    names = [n for n in vars(j) if not n.startswith("__")
             and n not in PORT_DROPPED.get(mod, ())]
    assert names and sorted(names) == sorted(
        n for n in vars(p)
        if not n.startswith("__") and n not in PORT_ADDED.get(mod, ()))


# modules the port holds as verbatim copies of the JAX package's file
VERBATIM = ("align/search_oracle.py",)


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_is_byte_equal(path):
    root = Path(__file__).resolve().parent.parent
    assert (root / "bbmap_tpu_torch" / path).read_bytes() == \
        (root / "bbmap_tpu" / path).read_bytes()


@pytest.mark.parametrize("multi", [False, True])
def test_kmer_set_carried_across(multi):
    """convert.kmer_set carries a reference set field by field, and the
    port's build_kmer_set builds the same set (hdist, mink tips, multi-owner
    CSR)."""
    from bbmap_tpu.index import kmerset as jks
    from bbmap_tpu_torch.index import kmerset as tks
    rng = np.random.default_rng(4)
    seqs = [bytes(rng.choice(BASES, n)) for n in (40, 70, 55)]
    seqs.append(seqs[0][5:35] + seqs[1][:20])
    kw = dict(k=19, mink=0 if multi else 9, hdist=1, mask_middle=not multi,
              names=["a", "b", "c", "d"], multi=multi)
    ref = jks.build_kmer_set(seqs, **kw)
    got = convert.kmer_set(ref)
    assert type(got) is tks.KmerSet
    same(got, ref, "kmer_set")
    assert (got.multi_offsets is not None) == multi
    same(tks.build_kmer_set(seqs, **kw), ref, "build_kmer_set")
    vals = got.values[::7]
    same(got.lookup_ids(vals), ref.lookup_ids(vals), "lookup_ids")
    slots = got.lookup_slots(vals)
    rows = np.arange(len(slots), dtype=np.int64)
    same(got.expand_slots(rows, slots), ref.expand_slots(rows, slots),
         "expand_slots")


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
