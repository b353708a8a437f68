"""The port's paired aligner entry point ``map_pairs_columnar`` against
the JAX package's default CPU path, MappedBatch field by field and match
string by match string: without and with quality, and with the fused
escalation / trace budgets forced tiny so overflow rows take the host
refit path (unfused quickmap + escalate_device + host rescue). Tolerance:
exact."""

import pytest
import torch

from bbmap_tpu.align import fused_device as jfd
from bbmap_tpu.align.pipeline import BBMapAligner as JaxAligner
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import fused_device as tfd

from .test_torch_fused import (assert_mb_equal, batch, make_pairs,  # noqa: F401
                               quality_for, setup, torch_aligner)

torch.set_num_threads(2)


@pytest.mark.parametrize("variant", ["plain", "quality", "overflow"])
def test_map_pairs_columnar_matches(setup, variant, monkeypatch):
    g, genome, index = setup
    L, B = 100, 128
    if variant == "overflow":
        for mod in (jfd, tfd):
            monkeypatch.setattr(mod, "esc_budget", lambda B: 8)
            monkeypatch.setattr(mod, "trace_budget", lambda B: 4)
    r1, r2 = make_pairs(g, B, L=L, seed={"plain": 5, "quality": 6,
                                         "overflow": 7}[variant])
    q1 = q2 = None
    if variant != "plain":
        q1, q2 = quality_for(B, L, 3), quality_for(B, L, 4)
    aj = JaxAligner(genome, index)
    at = torch_aligner(genome, index)
    mj = aj.map_pairs_columnar(batch(r1, L, q1), batch(r2, L, q2))
    mt = at.map_pairs_columnar(convert.read_batch(batch(r1, L, q1)),
                               convert.read_batch(batch(r2, L, q2)))
    for a, b in zip(mj, mt):
        assert_mb_equal(a, b)
    assert (at._n_esc_rows, at._n_fallback_rows) == \
        (aj._n_esc_rows, aj._n_fallback_rows)
    assert mt[0].mapped.sum() > 0.9 * B
    assert sum(len(m.match_override) for m in mt) > 5    # traced rows
    if variant == "overflow":
        assert at._n_fallback_rows > 0
