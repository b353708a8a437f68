"""The banded edit distance's two band bodies on the card
(csrc/banded_edit.cu): ``banded_edit`` and the block kernel
``banded_any`` with each body forced ("quad": four pairs a thread in the
byte lanes of a word; "thread": a pair a thread), one launch each, against
their plain versions on the same CUDA tensors, tolerance 0, for E = 0-7,
global and infix, on the pairs of ``tests/banded_cases`` (words whose
lanes differ in la and lb, lanes that end early, empty sides, IUPAC and
lowercase bytes, counts that are not multiples of 4 or of the tile), with
a per pair, with one query shared (a pair stride of 0), staged and in
place, class and triangle; and the containment kernel
(``contained_any``) with each of its mappings forced, and the one its rule
picks, against its plain version on dedupe's block layout. Every test
skips where there is no CUDA device. This file imports neither jax nor the JAX package, so it runs on a
machine without them: ``python -m pytest --noconftest
tests/test_torch_banded_card.py``."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.ops import banded_device as tbd
from tests.banded_cases import class_case, contained_case, quad_words, \
    random_pairs, stack


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("E", list(range(8)))
def test_quad_kernel_equals_plain_on_the_card(E):
    """banded_edit with each body forced against the plain version, global
    and infix: a per pair and one shared query; the numpy entry point
    (its pitch padded to 4) takes the quad body; a pitch that is not a
    multiple of 4 takes the thread body; the quad body past 15 cells
    refuses."""
    dev = _card()
    pairs = quad_words(E, E, 45) + random_pairs(900 + E, 19, E, 50)
    A, la, B, lb = stack(pairs)
    n = len(pairs)
    at = tbd._pair_minor(A, dev)
    bt = tbd._pair_minor(B, dev)
    lat, lbt = (torch.from_numpy(x).to(dev) for x in (la, lb))
    for infix in (False, True):
        for a_, la_ in ((at, lat), (at[:, 3].contiguous(),
                                    lat[3:4].expand(n))):
            want = tbd.banded_edit_batch_plain(a_, la_, bt, lbt, E, infix)
            for mapping in ("quad", "thread"):
                tbd.reset_launches()
                got = tbd.banded_edit(a_, la_, bt, lbt, E, infix,
                                      mapping=mapping)
                assert tbd.banded_edit.launches_by[mapping] == 1
                assert torch.equal(got, want), (E, infix, mapping)
        want = tbd.banded_edit_batch_plain(at, lat, bt, lbt, E, infix)
        tbd.reset_launches()
        np.testing.assert_array_equal(
            tbd.banded_edit_batch(A, la, B, lb, E, infix, device=dev),
            want.cpu().numpy())
        assert tbd.banded_edit.launches_by["quad"] == 1
    odd = torch.from_numpy(B[:n - 1].T.copy()).to(dev)      # pitch n - 1
    tbd.reset_launches()
    got = tbd.banded_edit(at[:, :n - 1], lat[:n - 1], odd, lbt[:n - 1], E)
    assert tbd.banded_edit.launches_by["thread"] == 1
    assert torch.equal(got, tbd.banded_edit_batch_plain(
        at[:, :n - 1], lat[:n - 1], odd, lbt[:n - 1], E))
    with pytest.raises(ValueError):
        tbd.banded_edit(at, lat, bt, lbt, E + 8, mapping="quad")


@pytest.mark.parametrize("E", list(range(8)))
def test_quad_block_kernel_equals_plain_on_the_card(E):
    """The block kernel with each body forced, staged and in place, class
    and triangle, against its plain version; the body each launch took
    counted."""
    dev = _card()
    qT, lq, sT, ls = class_case(E, E, 41, 600)
    q, lqd = tbd.upload_block([qT[:n, i] for i, n in enumerate(lq)], dev)
    sb, lsd = tbd.upload_block([sT[:n, j] for j, n in enumerate(ls)], dev)
    k4 = sb.shape[1] // 4 * 4
    for s_, ls_ in ((sb, lsd), (sb[:, :k4].contiguous(), lsd[:k4])):
        want = tbd.banded_any_plain(q, lqd, s_, ls_, E)
        for mapping in ("quad", "thread"):
            tbd.reset_launches()
            assert torch.equal(tbd.banded_any(q, lqd, s_, ls_, E,
                                              mapping=mapping), want)
            assert tbd.banded_any.launches_by_body[mapping] == 1
    want = tbd.banded_any_plain(q, lqd, None, None, E, tri=True)
    for mapping in ("quad", "thread"):
        assert torch.equal(tbd.banded_any(q, lqd, None, None, E, tri=True,
                                          mapping=mapping), want)


@pytest.mark.parametrize("tol", [0, 1, 2, 3, 7, 15, 16])
def test_contained_mappings_equal_plain_on_the_card(tol):
    """contained_any with each mapping forced where it applies ("split" to
    tol 3, "staged" and "ring" to tol 15, "warp" from 16, "inplace"
    everywhere) and with the rule's pick, against contained_any_plain on
    the same CUDA tensors, tolerance 0, one launch each, counted under its
    mapping: reads of 40 to 120 bp and their windows (clipped at the
    containers' ends, N and lowercase bytes, reverse complements), and
    contigs ten times longer (past the staged block: "ring"); a pair count
    of 1 too."""
    dev = _card()
    cases = [contained_case(tol, tol, n_q=40),
             contained_case(5 + tol, tol, n_q=6, n_c=3, long=True)]
    for reads, pairs in cases + [(cases[0][0], cases[0][1][:1])]:
        q, lq = tbd.upload_block(reads, dev)
        w, table = tbd.upload_windows([r for r, _ in pairs],
                                      [x for _, x in pairs], dev)
        want = tbd.contained_any_plain(q, lq, w, table, tol)
        P = table.shape[1]
        for mapping in (None, *tbd.CONTAINED_MAPPINGS):
            try:
                picked = tbd.contained_mapping(P, tol, q.shape[0], w.shape[0],
                                               mapping)
            except ValueError:
                continue
            tbd.reset_launches()
            got = tbd.contained_any(q, lq, w, table, tol, mapping)
            assert tbd.contained_any.launches_by[picked] == 1
            assert torch.equal(got, want), (tol, mapping, P)
