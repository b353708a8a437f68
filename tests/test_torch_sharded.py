"""``bbmap_tpu_torch.parallel.sharded`` against the JAX package's
``parallel/sharded.py`` on the CPU: the index partition, the global count
table, the candidate merge, the in-process sharded quickmap and the
sharded ``BBMapAligner`` (the port's mesh of CPU entries against the JAX
package's (4 data x 2 index) mesh of the 8 CPU devices conftest gives
it, and against the port's single-device path), the scoring step through
K1's entry point and the multi-device dry run. Tolerance: exact."""

import numpy as np
import pytest
import torch

from bbmap_tpu.align.pipeline import BBMapAligner as JAligner
from bbmap_tpu.core.batch import ReadBatch as JReadBatch
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu.parallel import sharded as jsh
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd
from bbmap_tpu_torch.align.pipeline import BBMapAligner
from bbmap_tpu_torch.parallel import sharded as tsh

BASES4 = np.frombuffer(b"ACGT", np.uint8)
FIELDS = ("mapped", "strand", "chrom", "start", "stop", "score",
          "ambiguous")


def _genome(chroms, prefix):
    return Genome(chroms=chroms, scaffolds=[
        Scaffold(chrom=i + 1, sid=i + 1, start=0, length=len(c),
                 name=f"{prefix}{i + 1}") for i, c in enumerate(chroms)
    ]).finalize()


@pytest.fixture(scope="module")
def setup():
    """tests/test_sharded.py's two-chrom genome (40 + 44 kbp), k = 10."""
    rng = np.random.default_rng(0)
    chroms = [rng.choice(BASES4, size=n).astype(np.uint8)
              for n in (40_000, 44_000)]
    g = _genome(chroms, "s")
    index = build_index(g, 10)
    analyze_index(index, 0.01)
    return g, index, convert.genome(g), convert.index(index)


def _reads(index, rng, B, L):
    gc = index.genome_codes
    A = np.frombuffer(b"ACGTN", np.uint8)
    ok = np.lib.stride_tricks.sliding_window_view(gc < 4, L).all(axis=1)
    starts = rng.choice(np.nonzero(ok)[0], size=B)
    reads = A[np.minimum(np.stack([gc[s:s + L] for s in starts]), 4)]
    for i in range(0, B, 3):
        for _ in range(2):
            reads[i, rng.integers(0, L)] = BASES4[rng.integers(0, 4)]
    return reads, starts


def _same_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_shard_index_as_the_jax_module(setup):
    """Chrom-aligned bounds (two blocks), and three given flat bounds."""
    _g, index, _tg, tindex = setup
    G = len(index.genome_codes)
    for n, bounds in ((2, None), (3, [0, G // 3, 2 * G // 3, G])):
        j = jsh.shard_index(index, n, bounds)
        t = tsh.shard_index(tindex, n, bounds)
        assert t.n_shards == j.n_shards == n
        for f in ("bounds", "starts_s", "sites_s"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert int(t.starts_s[:, -1].sum()) == len(index.sites)
    np.testing.assert_array_equal(tsh._global_counts(tindex),
                                  jsh._global_counts(index))


def test_merge_candidates_as_the_jax_module():
    """Seeded (B, 3 x 8) tables whose votes tie often and whose starts
    repeat: the same top 8 in the same order, every field."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    B, W, K = 64, 24, 8
    cand = {"votes": rng.integers(0, 4, (B, W)).astype(np.int32),
            "mode": rng.integers(0, 10 ** 6, (B, W)).astype(np.int32),
            "strand": rng.integers(0, 2, (B, W)).astype(np.int32),
            "start": rng.integers(0, 40, (B, W)).astype(np.int32),
            "spread": rng.integers(0, 500, (B, W)).astype(np.int32)}
    got = tsh._merge_candidates(
        {k: torch.from_numpy(v) for k, v in cand.items()}, K)
    want = jsh._merge_candidates({k: jnp.asarray(v)
                                  for k, v in cand.items()}, K)
    _same_dicts({k: v.numpy() for k, v in got.items()}, want)
    assert got["votes"].shape == (B, K)


@pytest.mark.parametrize("n_data", [1, 2])
def test_sharded_quickmap_parity(setup, n_data):
    """The port's in-process sharded quickmap on (n_data x 2) CPU entries
    == the JAX sharded quickmap on its (4 x 2) mesh == the port's
    single-device quickmap: every output column and the match codes."""
    _g, index, _tg, tindex = setup
    rng = np.random.default_rng(1)
    L, B = 100, 64
    reads, _ = _reads(index, rng, B, L)
    single = tqd.build_quickmap(tqd.DeviceIndex(tindex, "cpu"), L)(reads)
    run = tsh.build_sharded_quickmap(
        tsh.make_mesh(n_data, 2, "cpu"), tindex, tsh.shard_index(tindex, 2),
        L)
    got = run(reads)
    want = jsh.build_sharded_quickmap(
        jsh.make_mesh(n_data=4, n_index=2), index, jsh.shard_index(index, 2),
        L)(reads)
    assert torch.equal(got._out_i32, single._out_i32)
    assert torch.equal(got._best_sym, single._best_sym)
    np.testing.assert_array_equal(got._out_i32.numpy(),
                                  np.asarray(want._out_i32))
    _same_dicts(got.host(), want.host())


def test_sharded_readmission_parity():
    """tests/test_sharded.py's repeat family (an 800 bp unit 40 times
    over two chromosomes): site lists past the base cap, so the staged
    re-admission and the greedy slot budget read the global counts on
    every shard; port sharded == JAX sharded == port single."""
    rng = np.random.default_rng(7)
    unit = rng.choice(BASES4, size=800).astype(np.uint8)
    chroms = []
    for n in (60_000, 60_000):
        c = rng.choice(BASES4, size=n).astype(np.uint8)
        for at in rng.choice(n - 900, size=20, replace=False):
            c[at:at + 800] = unit
        chroms.append(c)
    g = _genome(chroms, "r")
    index = build_index(g, 10)
    analyze_index(index, 0.01)
    tindex = convert.index(index)
    L, B = 100, 64
    gc = index.genome_codes
    A = np.frombuffer(b"ACGTN", np.uint8)
    ok = np.lib.stride_tricks.sliding_window_view(gc < 4, L).all(axis=1)
    starts = rng.choice(np.nonzero(ok)[0], size=B)
    reads = A[np.minimum(np.stack([gc[s:s + L] for s in starts]), 4)]
    reads[: B // 2] = unit[50:50 + L][None, :]
    for i in range(0, B, 2):
        reads[i, rng.integers(0, L)] = BASES4[rng.integers(0, 4)]
    d1 = tqd.build_quickmap(tqd.DeviceIndex(tindex, "cpu"), L)(reads).host()
    d2 = tsh.build_sharded_quickmap(
        tsh.make_mesh(1, 2, "cpu"), tindex, tsh.shard_index(tindex, 2),
        L)(reads).host()
    d3 = jsh.build_sharded_quickmap(
        jsh.make_mesh(n_data=4, n_index=2), index,
        jsh.shard_index(index, 2), L)(reads).host()
    _same_dicts(d2, d1)
    _same_dicts(d2, d3)
    assert int((np.asarray(d1["n_good"]) > 1).sum()) > 0


def test_sharded_aligner_parity(setup):
    """BBMapAligner.map_batch_columnar with a (1 x 2) mesh and no quality
    == the JAX sharded aligner on its (4 x 2) mesh == the port's
    unsharded aligner, field by field and match by match."""
    g, index, tg, tindex = setup
    rng = np.random.default_rng(2)
    L, B = 100, 64
    reads, _ = _reads(index, rng, B, L)
    kw = dict(bases=reads, quality=None, lengths=np.full(B, L, np.int32),
              ids=[str(i) for i in range(B)],
              numeric_ids=np.arange(B, dtype=np.int64))
    tbatch = convert.read_batch(JReadBatch(**kw))
    multi = BBMapAligner(tg, tindex, "cpu", mesh=tsh.make_mesh(1, 2, "cpu"))
    assert not multi._use_fused(L)
    mb_m = multi.map_batch_columnar(tbatch)
    mb_s = BBMapAligner(tg, tindex, "cpu").map_batch_columnar(tbatch)
    mb_j = JAligner(g, index, mesh=jsh.make_mesh(n_data=4, n_index=2),
                    n_index_shards=2).map_batch_columnar(JReadBatch(**kw))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mb_m, f), getattr(mb_s, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(mb_m, f),
                                      np.asarray(getattr(mb_j, f)),
                                      err_msg=f)
    for i in range(B):
        assert mb_m.match(i) == mb_s.match(i) == mb_j.match(i), i
    assert int(mb_m.mapped.sum()) == B


def test_sharded_score_step_as_the_jax_step():
    """Reads scored against two windows a read through K1's entry point
    (msa_kernels.score_batch) on a (2 x 2) mesh == the JAX step (a vmap of
    msa_score_single) on its (4 x 2) mesh: best, its shard, mapped."""
    rng = np.random.default_rng(4)
    R, C, B = 40, 72, 32
    reads = BASES4[rng.integers(0, 4, (B, R))]
    refs = BASES4[rng.integers(0, 4, (B, 2, C))]
    for i in range(B):
        s = i % 2
        refs[i, s, 8:8 + R] = reads[i]
        refs[i, s, 8 + (i % R)] = ord("A") if reads[i, i % R] != 65 \
            else ord("C")
    refs[::5, 1] = refs[::5, 0]                 # ties between the shards
    got = tsh.sharded_score_step(tsh.make_mesh(2, 2, "cpu"), R, C)(
        reads, refs, 3000)
    want = jsh.sharded_score_step(jsh.make_mesh(n_data=4, n_index=2),
                                  R, C)(reads, refs, 3000)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(got[2]) < B + 1


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(n):
    """The port's counterpart of __graft_entry__.dryrun_multichip:
    the aligner over an n-entry mesh equals the single device, repeat
    family included."""
    tsh.dryrun_multichip(n, "cpu")


def test_make_mesh_and_device():
    m = tsh.make_mesh(2, 3, "cpu")
    assert m.shape == {"data": 2, "index": 3}
    assert m.axis_names == ("data", "index")
    assert {d.type for row in m.devices for d in row} == {"cpu"}
    with pytest.raises(ValueError):
        tsh.Mesh([[torch.device("cpu")], []])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsh.make_mesh(1, 2)                     # cuda by default


def test_two_process_sharded_index_bbmap(tmp_path):
    """``hosts=2 shardindex=t`` on the CPU: each process builds and holds
    only its genome block's CSR (the two scaffolds packed into separate
    chrom blocks by maxchromlen=, so the block bound is a chrom bound),
    every batch's candidates are all-gathered over gloo, and host 0's SAM
    is byte-equal to the port's and the JAX package's one-process runs
    with the whole index. Each process's stderr shows a strict part of
    the sites, the two parts summing to the whole. 600 reads of 120 bp,
    alternating between the scaffolds, in batches of 200."""
    import re

    from tests.test_torch_multihost import free_port, run_ranks
    from tests.test_torch_parallel_cli import write_reads
    rng = np.random.default_rng(77)
    g1, g2 = (rng.choice(BASES4, size=30_000) for _ in range(2))
    (tmp_path / "xref.fa").write_text(
        ">s1\n" + bytes(g1).decode() + "\n>s2\n" + bytes(g2).decode()
        + "\n")
    write_reads(tmp_path / "xreads.fq", rng, [g1, g2], 600, 120)
    common = [f"ref={tmp_path}/xref.fa", f"in={tmp_path}/xreads.fq",
              "nodisk", "batchsize=200", "maxchromlen=40000"]
    coord = f"coordinator=localhost:{free_port()}"
    res = run_ranks([
        ["-m", "bbmap_tpu_torch", "bbmap", *common,
         f"out={tmp_path}/single.sam", "device=cpu"],
        ["-m", "bbmap_tpu", "bbmap", *common, f"out={tmp_path}/jax.sam"],
        *[["-m", "bbmap_tpu_torch", "bbmap", *common,
           f"out={tmp_path}/multi.sam", "device=cpu", "hosts=2",
           f"hostid={h}", "shardindex=t", coord] for h in range(2)]],
        timeout=400, env_extra={"BBMAP_FORCE_CPU": "1"})
    assert len(res) == 4 and all(r[0] == 0 for r in res), \
        [r[2][-2000:] for r in res]
    sites = []
    for h, (_rc, _out, err) in enumerate(res[2:]):
        m = re.search(r"Index Shard (\d)/2 \((\d+) of (\d+) sites\)", err)
        assert m and int(m.group(1)) == h, err[-2000:]
        sites.append((int(m.group(2)), int(m.group(3))))
    total = sites[0][1]
    assert sites[1][1] == total
    assert sites[0][0] + sites[1][0] == total
    assert all(0 < s < total for s, _t in sites)
    multi = (tmp_path / "multi.sam").read_bytes()
    assert multi == (tmp_path / "single.sam").read_bytes()
    assert multi == (tmp_path / "jax.sam").read_bytes()
    assert sum(1 for ln in multi.split(b"\n")
               if ln and not ln.startswith(b"@")) == 600
    # only host 0 writes; nothing else is left beside the inputs
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "jax.sam", "multi.sam", "single.sam", "xreads.fq", "xref.fa"]
