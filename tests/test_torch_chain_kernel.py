"""The candidate stage's chain step (bbmap_tpu_torch/csrc/chain_candidates.cu,
wrapper ``quickmap_device.chain_candidates_kernel``, plain version
``_chain_candidates_plain``: ``_sort_rows``, ``_chain_segments``,
``_candidate_table``).

The plain version against the JAX package's ``candidate_stage`` stopped at
"sort" (the sorted diagonals and key slots), "votes" (each chain's
distinct-key count at its first slot), "runs" (the read's votes and the
packed modal run's running max) and in full (the candidate table and
``hi_over``) on the same reads, in the short configuration (L = 100: with
and without quality, one and two tiers, the tier admission) and the long
one (L = 6,000, 750 keys, W = 512: the JAX package keeps the votes exact
there with 24 mask words); and against a sequential numpy oracle written
chain by chain (the distinct keys of a chain as a set, its runs and their
packed (run, 255 - offset) words, the stable top 8) on the path's rows and
on rows crafted for the places the kernel can go wrong (``tests/
candidate_rows.chain_rows``): all-invalid rows, steps exactly at
``chain_dist``, negative diagonals, a key slot repeated within a chain,
modal-run ties, runs past chain offset 255 and runs longer than 255 at W =
512, reads with fewer than 8 chains (the table's zero-vote fill entries),
vote ties across strands. Tolerance: exact. The kernel itself is held to
the plain version on the card by tests/test_torch_candidate_card.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

from bbmap_tpu_torch.align import quickmap_device as tqd
from tests import candidate_stages as cs
from tests.candidate_rows import INVALID, chain_rows

torch.set_num_threads(2)

FIELDS = ("votes", "mode", "strand", "start", "spread")


def _row_oracle(d, t, cd):
    """One row: sorted diagonals f, and per slot the last slot, the chain
    start, the votes and the packed modal word read at a chain's last slot
    (or at an invalid slot: the last chain's, or 0)."""
    W = len(d)
    f, ts = map(list, zip(*sorted(zip(d.tolist(), t.tolist()))))
    n = sum(x < INVALID for x in f)
    last = list(range(W))
    segs = [-1] * W
    votes = [0] * W
    word = [0] * W
    starts = [i for i in range(n) if i == 0 or f[i] - f[i - 1] > cd]
    best = 0
    for o, s in enumerate(starts, start=1):
        e = (starts[o] if o < len(starts) else n) - 1
        votes[s] = len(set(ts[s:e + 1]))
        best = 0
        r = s
        while r <= e:
            q = r
            while q + 1 <= e and f[q + 1] == f[r]:
                q += 1
            meta = (min(q - r + 1, 255) << 8) | (255 - min(r - s, 255))
            best = max(best, meta)
            r = q + 1
        for i in range(s, e + 1):
            last[i] = e
            segs[i] = s
        word[e] = (o << 16) | best
    for i in range(n, W):
        segs[i] = starts[-1] if starts else -1
        word[i] = (len(starts) << 16) | best if starts else 0
    return f, last, segs, votes, word


def chain_oracle(diag, toff, cd, K=8):
    """The candidate table of each read, sequentially."""
    B, _two, W = diag.shape
    out = {k: np.zeros((B, K), np.int32) for k in FIELDS}
    for b in range(B):
        f, last, segs, votes, word = [sum(x, []) for x in zip(*(
            _row_oracle(diag[b, h], toff[b, h], cd) for h in range(2)))]
        top = sorted(range(2 * W), key=lambda i: (-votes[i], i))[:K]
        for k, i in enumerate(top):
            half = int(i >= W)
            so = half * W
            stop_at = min(max(last[i] + so, 0), 2 * W - 1)
            mi = min(max(segs[i] + 255 - (word[stop_at] & 0xFF), 0), W - 1)
            out["votes"][b, k] = votes[i]
            out["strand"][b, k] = half
            out["start"][b, k] = f[i]
            out["mode"][b, k] = f[min(max(mi + so, 0), 2 * W - 1)]
            out["spread"][b, k] = f[stop_at] - f[i] if votes[i] > 0 else 0
    return out


def _cfg(W: int, nk: int, cd: int = 400) -> tqd.QmConfig:
    return tqd.QmConfig(k=13, L=150, S=32, chain_dist=cd, min_score=0,
                        offsets_list=tuple(range(nk)), G=1, slot_budget=W)


def _check(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)


@pytest.mark.parametrize("name", cs.CASES)
def test_plain_matches_jax_stages(name):
    want, got, ct = cs.case(name)
    (cfg, diag, toff_slot), cand = got["chain"]
    nk = len(cfg.offsets_list)
    flat, toff = tqd._sort_rows(diag, toff_slot)
    flat, toff = flat.numpy(), toff.numpy()
    np.testing.assert_array_equal(flat, want["sort"]["a"])
    # equal diagonals carry their key slots in either order: compare the
    # (diagonal, key slot) pairs of the valid slots as sorted keys
    valid = flat < INVALID
    key = np.where(valid, flat.astype(np.int64) * 65536 + toff, -1)
    jkey = np.where(valid, flat.astype(np.int64) * 65536
                    + want["sort"]["b"], -1)
    np.testing.assert_array_equal(np.sort(key, 1), np.sort(jkey, 1))
    last_idx, seg_start, gmax, size = tqd._chain_segments(
        torch.from_numpy(flat), torch.from_numpy(toff), cfg.chain_dist, nk)
    np.testing.assert_array_equal(size.numpy(), want["votes"]["a"])
    np.testing.assert_array_equal(size.numpy().reshape(len(diag), -1),
                                  want["runs"]["a"])
    np.testing.assert_array_equal(gmax.numpy(), want["runs"]["b"])
    for k in want["cand"]:
        np.testing.assert_array_equal(got["cand"][k], want["cand"][k],
                                      err_msg=k)
    _check(cand, chain_oracle(diag.numpy(), toff_slot.numpy(),
                              cfg.chain_dist))
    if name.startswith("long"):
        assert diag.shape[-1] == 512 and nk == 750
        assert (cand["votes"].numpy()[:, 0] > 255).any()


@pytest.mark.parametrize("W,nk,cd,B", [(64, 18, 400, 96), (512, 750, 400, 24),
                                       (64, 18, 0, 48), (40, 33, 25, 48)])
def test_plain_matches_oracle_on_crafted_rows(W, nk, cd, B):
    rng = np.random.default_rng(W + nk + cd)
    diag, toff = chain_rows(rng, B, W, nk, cd)
    got = tqd.chain_candidates_kernel(_cfg(W, nk, cd), torch.from_numpy(diag),
                                      torch.from_numpy(toff))
    want = chain_oracle(diag, toff, cd)
    _check(got, want)
    votes = want["votes"]
    assert (votes[:, 0] == 0).any()                  # all-invalid reads
    assert ((votes > 0).sum(1) < 8).any()            # zero-vote fill
    assert (diag[(diag < INVALID)] < 0).any()
    if W == 512:
        # a modal run that starts past offset 255 of its chain: the
        # packed word's low byte 0, the mode read at chain start + 255
        assert votes.max() > 255


def test_crafted_rows_reach_the_edges():
    """The crafted rows hold what they are for: a step of exactly
    chain_dist inside a chain and one past it between chains; a key slot
    twice in a chain (fewer votes than slots); equal runs in a chain; a
    run past offset 255 that decides the mode; reads whose two strands
    tie."""
    cd = 400
    rng = np.random.default_rng(9)
    diag, toff = chain_rows(rng, 48, 512, 750, cd)
    steps = ties = repeats = late = 0
    for b in range(len(diag)):
        rows = []
        for h in range(2):
            f, last, segs, votes, word = _row_oracle(diag[b, h], toff[b, h],
                                                     cd)
            rows.append(votes)
            n = sum(x < INVALID for x in f)
            dd = np.diff(np.asarray(f[:n], np.int64))
            steps += int((dd == cd).any() and (dd == cd + 1).any())
            for s in range(n):
                if votes[s]:
                    e = last[s]
                    repeats += votes[s] < e - s + 1
                    late += (word[e] & 0xFF) == 0 and e - s > 255
        ties += rows[0] == rows[1] and max(rows[0]) > 0
    assert steps and ties and repeats and late


def test_mutation_fails():
    """Votes that count slots instead of distinct key slots, and a mode
    taken at the chain's first run, each change the table."""
    rng = np.random.default_rng(5)
    diag, toff = chain_rows(rng, 32, 64, 18, 400)
    want = chain_oracle(diag, toff, 400)
    same = chain_oracle(diag, np.broadcast_to(np.arange(64, dtype=np.int32),
                                              diag.shape), 400)
    assert (same["votes"] != want["votes"]).any()
    first = {k: v.copy() for k, v in want.items()}
    first["mode"] = np.where(want["votes"] > 0, want["start"], want["mode"])
    assert (first["mode"] != want["mode"]).any()


def test_wrapper_checks_and_counts():
    rng = np.random.default_rng(6)
    diag, toff = (torch.from_numpy(a) for a in chain_rows(rng, 8, 64, 18,
                                                          400))
    cfg = _cfg(64, 18)
    tqd.reset_launches()
    got = tqd.chain_candidates_kernel(cfg, diag, toff)
    assert tqd.chain_candidates_kernel.launches == 0    # CPU: plain
    _check(got, {k: v.numpy() for k, v in tqd._chain_candidates_plain(
        cfg, diag, toff).items()})
    assert all(got[k].dtype == torch.int32 for k in FIELDS)
    with pytest.raises(TypeError):
        tqd.chain_candidates_kernel(cfg, diag.long(), toff)
    with pytest.raises(ValueError):
        tqd.chain_candidates_kernel(cfg, diag, toff[:, :, :5])
    with pytest.raises(ValueError):
        tqd.chain_candidates_kernel(cfg, diag, toff.to("meta"))
