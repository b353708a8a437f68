"""The port's streaming and single-end entry points and its SAM output
against the JAX package: ``map_pairs_columnar_stream`` over three
batches (its stage order carries the pair state from batch to batch),
``map_batch_columnar`` on single-end reads, and ``emit_sam`` byte for
byte on paired results. Tolerance: exact."""

import torch

from bbmap_tpu.align.pipeline import BBMapAligner as JaxAligner
from bbmap_tpu.align.pipeline import emit_sam as jax_emit_sam
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align.pipeline import emit_sam

from .test_torch_fused import (assert_mb_equal, batch, make_pairs,  # noqa: F401
                               quality_for, setup, torch_aligner)

torch.set_num_threads(2)

L = 100


def test_map_pairs_columnar_stream_matches(setup):
    g, genome, index = setup
    B = 48
    items = []
    for s in range(3):
        r1, r2 = make_pairs(g, B, L=L, seed=40 + s)
        items.append((batch(r1, L, quality_for(B, L, 50 + s)),
                      batch(r2, L, quality_for(B, L, 60 + s))))
    aj = JaxAligner(genome, index)
    at = torch_aligner(genome, index)
    outs_j = list(aj.map_pairs_columnar_stream(iter(items)))
    outs_t = list(at.map_pairs_columnar_stream(
        (convert.read_batch(a), convert.read_batch(b)) for a, b in items))
    assert len(outs_j) == len(outs_t) == 3
    for mj, mt in zip(outs_j, outs_t):
        for a, b in zip(mj, mt):
            assert_mb_equal(a, b)
    assert (at.average_pair_dist, at._num_mated, at._inner_sum) == \
        (aj.average_pair_dist, aj._num_mated, aj._inner_sum)


def test_map_batch_columnar_single_end_matches(setup):
    g, genome, index = setup
    r1, _ = make_pairs(g, 64, L=L, seed=71)
    b = batch(r1, L, quality_for(64, L, 72))
    mj = JaxAligner(genome, index).map_batch_columnar(b)
    mt = torch_aligner(genome, index).map_batch_columnar(
        convert.read_batch(b))
    assert_mb_equal(mj, mt)
    assert mt.mapped.sum() > 55


def test_emit_sam_bytes_match(setup):
    g, genome, index = setup
    B = 40
    r1, r2 = make_pairs(g, B, L=L, seed=81)
    b1 = batch(r1, L, quality_for(B, L, 82))
    b2 = batch(r2, L, quality_for(B, L, 83))
    j1, j2 = JaxAligner(genome, index).map_pairs(b1, b2)
    tb1, tb2 = convert.read_batch(b1), convert.read_batch(b2)
    t1, t2 = torch_aligner(genome, index).map_pairs(tb1, tb2)
    lines_j = jax_emit_sam(genome, b1, j1, j2, b2)
    lines_t = emit_sam(convert.genome(genome), tb1, t1, t2, tb2)
    assert "\n".join(lines_t).encode() == "\n".join(lines_j).encode()
    flags = {int(ln.split("\t")[1]) for ln in lines_t}
    assert {99, 147} <= flags
