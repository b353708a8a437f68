"""The key-retention kernel (bbmap_tpu_torch/csrc/ref_retention.cu, wrapper
``quickmap_device.ref_retention_kernel``): a numpy emulation of its
per-read algorithm, in the kernel's order (a read's own loop that ends when
its cond fails or it stops; the warp scans as sequential loops over pieces
of 32 keys with a carry: the backward suffix min, the forward prefix max,
alive rank, running min, first trigger by piece and argmin with the
lowest index on ties; int32 sums and products wrapped as unsigned), held to
the plain version (``_ref_retention``) and to the JAX package's
``_ref_retention`` on the repeat-heavy genome of
tests/test_torch_search_oracle.py without and with quality weights, on key
counts crafted across the re-admission tiers and the trim's branches (ties,
the early-termination trigger, kills), and at nk = 750 (L = 6,000, k = 12).
Mutations the emulation must fail: an argmin that keeps the last index on
ties, and a read that stops one round early. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbmap_tpu.align import quickmap_device as jqd
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd
from bbmap_tpu_torch.align import seed as seed_host
from tests.retention_counts import crafted
from tests.test_torch_search_oracle import _quality, _reads, _repeat_genome

torch.set_num_threads(2)

BIG = 1 << 30
INT_MAX = 2 ** 31 - 1


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


@pytest.fixture(scope="module")
def repeat():
    """The repeat genome indexed at k = 13 by the JAX package, its port,
    and both configurations at L = 150 (reference retention on)."""
    g, at_unit = _repeat_genome()
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="rep")]).finalize()
    jindex = build_index(genome, 13)
    analyze_index(jindex, 0.03)
    dindex = tqd.DeviceIndex(convert.index(jindex), "cpu")
    cj, ct = jqd.make_config(jindex, 150), tqd.make_config(dindex, 150)
    assert ct.ref_admit and cj.max_usable_length == ct.max_usable_length
    return g, at_unit, dindex, cj, ct


@pytest.fixture(scope="module")
def long_cfg():
    """Both configurations at L = 6,000, k = 12 (nk = 750), on a small
    random genome's index (the fields the retention reads: k, the limits,
    points_per_site; max_usable_length is set by each test)."""
    rng = np.random.default_rng(2)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 20_000).astype(np.uint8)
    genome = Genome(chroms=[g], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g),
                 name="c1")]).finalize()
    index = build_index(genome, 12)
    cj = jqd.make_config(index, 6000)
    ct = tqd.make_config(tqd.DeviceIndex(convert.index(index), "cpu"), 6000)
    assert len(ct.offsets_list) == 750
    return cj, ct


def retention_emulation(cfg, kp, off, ccnt, weights=None, mutation=None,
                        max_rounds=None):
    """numpy model of csrc/ref_retention.cu, a read at a time. Returns
    (alive (B, nk) bool, rounds (B,) int32: the rounds whose cond held).
    ``mutation``: "last_tie" (the argmin keeps the last index on ties);
    ``max_rounds`` (B,) caps each read's rounds (a read that stops
    early)."""
    B, nk = kp.shape
    maxLen = cfg.max_usable_length
    tiers = [min(t, INT_MAX) for t in (maxLen, (maxLen * 3) // 2, maxLen * 2,
                                       maxLen * 3, maxLen * 5)]
    trig = (3 * nk) // 4
    limit3 = max(20, cfg.limit_shortest)
    limit_avg = max(20, cfg.limit_avg)
    limit2 = max(20, cfg.limit_avg2)
    pps = cfg.points_per_site
    vm_cap = (2 ** 30) // max(1, -pps)
    chunk = cfg.k
    npieces = (nk + 31) // 32
    alive_out = np.zeros((B, nk), bool)
    rounds_out = np.zeros(B, np.int32)
    for b in range(B):
        o = [int(x) for x in off[b]]
        c = [int(x) for x in ccnt[b]]
        ok = [int(kp[b, j]) >= 0 and c[j] > 0 for j in range(nk)]
        n = [sum(ok[j] and c[j] < t for j in range(nk)) for t in tiers]
        sel, num = 0, n[0]
        for t, need in ((1, 4), (2, 3), (3, 3), (4, 2)):
            if n[0] > 0 and num < need and num < trig:
                sel, num = t, n[t]
        alive = [ok[j] and c[j] < tiers[sel] for j in range(nk)]
        wc = [None] * nk
        initial = total0 = 0
        shortest, first_adm, last_adm = BIG, -1, -1
        for p in range(npieces):
            ball = [j for j in range(32 * p, min(32 * p + 32, nk))
                    if alive[j]]
            for r, j in enumerate(ball):
                total0 += c[j]
                shortest = min(shortest, c[j])
                if weights is not None:
                    wc[initial + r] = np.float32(weights[b, j])
            if ball:
                if first_adm < 0:
                    first_adm = ball[0]
                last_adm = ball[-1]
            initial += len(ball)
        first_adm = max(first_adm, 0)
        if last_adm < 0:
            last_adm = nk - 1
        off_last = o[last_adm]
        kill = initial >= 1 and shortest > limit3
        if kill:
            alive = [False] * nk
        limit = _i32(limit_avg * initial)
        max_lists = max(int(np.float32(0.85) * np.float32(initial)), 6)
        hits = 0 if kill else initial
        total = 0 if kill else _i32(total0)
        active = not kill and initial >= 1
        rounds = 0
        while active:
            cond = hits >= 1 and (total > limit
                                  or total // max(initial, 1) > limit2
                                  or hits > max_lists)
            if not cond:
                break
            if max_rounds is not None and rounds >= max_rounds[b]:
                break
            rounds += 1
            numl = max(hits, 1)
            row = [0] * nk
            carry, first_alive = BIG, 0
            for p in range(npieces - 1, -1, -1):
                js = range(32 * p, min(32 * p + 32, nk))
                for j in reversed(js):          # exclusive suffix min
                    row[j] = carry
                    if alive[j]:
                        carry = min(carry, o[j])
                lanes = [j for j in js if alive[j]]
                if lanes:
                    first_alive = lanes[0]
            cmax, crank, cmin, first_trig = -1, 0, BIG, -1
            best_val, best_idx = INT_MAX, INT_MAX
            vals = [BIG] * nk
            for p in range(npieces):
                js = range(32 * p, min(32 * p + 32, nk))
                trig_lanes, piece = [], []
                for j in js:
                    offL = cmax
                    if alive[j]:
                        cmax = max(cmax, o[j])
                        crank += 1
                    rank = crank - 1
                    val = BIG
                    if alive[j]:
                        nxt = row[j]
                        is_first, is_last = offL == -1, nxt == BIG
                        offR = off_last + 1 if is_last else nxt
                        vp = 30000 + 60000 // numl + 300000 // max(c[j], 1)
                        if j in (first_adm, last_adm):
                            vp += 40000
                        oldL, oldR, newS = o[j] - offL, offR - o[j], \
                            offR - offL
                        space = ((oldL * oldL + oldR * oldR)
                                 - newS * newS) * -30
                        if is_first:
                            uc = offR - o[j]
                        elif is_last:
                            uc = o[j] - offL
                        else:
                            uc = max(_i32(offR - (offL + chunk)), 0)
                        tail = (11500 if is_first or is_last else 6000) * uc
                        vp_final = _i32(vp + 11500 * chunk if numl == 1
                                        else vp + space + tail)
                        vpw = vp_final
                        if weights is not None:
                            w = wc[min(max(rank, 0), nk - 1)]
                            vpw = int(np.float32(vp_final) * w)
                        val = _i32(vpw + pps * min(c[j], vm_cap))
                    before = cmin
                    cmin = min(cmin, val)
                    if alive[j] and val < before \
                            and before < tqd.EARLY_TERMINATION_SCORE \
                            and j != first_alive:
                        trig_lanes.append(j)
                    piece.append((val, j))
                    vals[j] = val
                if first_trig < 0 and trig_lanes:
                    first_trig = trig_lanes[0]
                if mutation == "last_tie":
                    bv, bi = min(piece, key=lambda vj: (vj[0], -vj[1]))
                    if bv <= best_val:
                        best_val, best_idx = bv, bi
                else:
                    bv, bi = min(piece)
                    if (bv, bi) < (best_val, best_idx):
                        best_val, best_idx = bv, bi
            worst = first_trig if first_trig >= 0 else best_idx
            worst_value = vals[worst]
            worst_len = c[worst] if alive[worst] else 0
            total = _i32(total - worst_len)
            if worst_value > 0 or worst_len < 20:
                break
            alive[worst] = False
            hits -= 1
        alive_out[b] = alive
        rounds_out[b] = rounds
    return alive_out, rounds_out


def _jax(cj, kp, off, ccnt, weights=None):
    return np.asarray(jqd._ref_retention(
        cj, jnp.asarray(kp), jnp.asarray(off), jnp.asarray(ccnt),
        None if weights is None else jnp.asarray(weights)))


def _plain(ct, kp, off, ccnt, weights=None):
    return tqd.ref_retention_kernel(
        ct, torch.from_numpy(kp), torch.from_numpy(off),
        torch.from_numpy(ccnt),
        None if weights is None else torch.from_numpy(weights)).numpy()


def _three_way(cj, ct, kp, off, ccnt, weights=None):
    """The plain version against the JAX function and the emulation;
    returns the emulation's (alive, rounds)."""
    want = _jax(cj, kp, off, ccnt, weights)
    got = _plain(ct, kp, off, ccnt, weights)
    np.testing.assert_array_equal(got, want)
    emu = retention_emulation(ct, kp, off, ccnt, weights)
    np.testing.assert_array_equal(emu[0], want)
    return emu


def _repeat_inputs(repeat, B, seed, quality):
    """kp, off, ccnt (and weights) of B reads of the repeat genome, as
    candidate_stage builds them: the fixed ladder, or the quality offsets
    and weights with rejected reads' keys dropped."""
    g, at_unit, dindex, _cj, ct = repeat
    L, k = ct.L, ct.k
    reads = _reads(g, at_unit, B, seed)
    rcodes = tqd.ascii_to_codes(torch.from_numpy(reads))
    weights = None
    if quality:
        den2, den3 = seed_host.key_density_ladder(L, k)
        offs, weights, rej = tqd.quality_offsets_stage(
            ct, torch.from_numpy(_quality(B, seed + 11)), den2, den3,
            return_weights=True)
        keys_all = tqd._keys_all_positions(rcodes, k, L)
        kp = torch.gather(keys_all, 1, torch.clamp(offs, 0, L - k).long())
        kp = torch.where((offs < 0) | rej[:, None], -1, kp)
        off = torch.clamp(offs, min=0)
        weights = weights.numpy()
    else:
        kp = tqd._keys_from_codes(rcodes, ct.offsets_list, k, L)
        off = torch.as_tensor(np.asarray(ct.offsets_list, np.int32)
                              )[None, :].expand(B, len(ct.offsets_list))
    ccnt = torch.where(kp < 0, 0, dindex.ccnt[torch.where(kp < 0, 0,
                                                          kp).long()])
    return (kp.to(torch.int32).numpy(), off.to(torch.int32).contiguous()
            .numpy(), ccnt.to(torch.int32).numpy(), weights)


@pytest.mark.parametrize("quality", [False, True])
def test_emulation_on_the_repeat_genome(repeat, quality):
    """Reads anywhere and inside the 400 bp unit's copies, where the
    greedy trim removes keys."""
    _g, _a, _d, cj, ct = repeat
    kp, off, ccnt, w = _repeat_inputs(repeat, 96, 5, quality)
    alive, rounds = _three_way(cj, ct, kp, off, ccnt, w)
    admitted = (kp >= 0) & (ccnt > 0) & (ccnt < ct.max_usable_length)
    assert (alive.sum(1) < admitted.sum(1)).sum() > 5
    assert rounds.max() >= 1


@pytest.mark.parametrize("max_len", [4000, 100])
def test_emulation_on_crafted_counts(repeat, max_len):
    """maxLen 4,000: lists long enough to go below the value 0 (and the
    early-termination score) are admitted and trimmed; maxLen 100: the
    lists re-admitted past maxLen are short enough to be kept."""
    _g, _a, _d, cj, ct = repeat
    cj = cj._replace(max_usable_length=max_len)
    ct = ct._replace(max_usable_length=max_len)
    nk = len(ct.offsets_list)
    kp, off, ccnt = crafted(np.random.default_rng(7), 120, nk, max_len,
                            ct.offsets_list)
    alive, rounds = _three_way(cj, ct, kp, off, ccnt)
    rng = np.random.default_rng(8)
    w = rng.uniform(0.3, 1.0, kp.shape).astype(np.float32)
    _three_way(cj, ct, kp, off, ccnt, w)
    if max_len == 4000:
        assert rounds.max() >= 3
    else:
        assert ((ccnt >= max_len) & alive).any()   # re-admitted keys kept


def test_emulation_at_nk_750(long_cfg):
    """The long path's shape: 750 keys a read (24 pieces of 32), the fixed
    ladder and the quality ladder's offsets with weights."""
    cj, ct = long_cfg
    cj = cj._replace(max_usable_length=3000)
    ct = ct._replace(max_usable_length=3000)
    nk = len(ct.offsets_list)
    rng = np.random.default_rng(11)
    kp, off, ccnt = crafted(rng, 12, nk, 3000, ct.offsets_list)
    alive, rounds = _three_way(cj, ct, kp, off, ccnt)
    assert rounds.max() > 32
    den2, den3 = seed_host.key_density_ladder(ct.L, ct.k)
    q = rng.integers(20, 36, (12, ct.L)).astype(np.int8)
    q[3, 1000:2000] = 2
    offs, w, _rej = tqd.quality_offsets_stage(ct, torch.from_numpy(q), den2,
                                              den3, return_weights=True)
    offs, w = offs.numpy(), w.numpy()
    kp = np.where(offs < 0, -1, kp)
    ccnt = np.where(offs < 0, 0, ccnt)
    _three_way(cj, ct, kp, np.maximum(offs, 0).astype(np.int32), ccnt, w)


def test_mutations_fail(repeat):
    """The crafted counts reach argmin ties and reads whose last round
    removes a key: a last-index tie rule and a read that stops one round
    early each give other keys."""
    _g, _a, _d, _cj, ct = repeat
    ct = ct._replace(max_usable_length=4000)
    kp, off, ccnt = crafted(np.random.default_rng(7), 120,
                            len(ct.offsets_list), 4000, ct.offsets_list)
    want, rounds = retention_emulation(ct, kp, off, ccnt)
    np.testing.assert_array_equal(want, _plain(ct, kp, off, ccnt))
    tie, _ = retention_emulation(ct, kp, off, ccnt, mutation="last_tie")
    assert (tie != want).any()
    early, _ = retention_emulation(ct, kp, off, ccnt,
                                   max_rounds=np.maximum(rounds - 1, 0))
    assert (early != want).any()


def test_wrapper_checks_and_counts(repeat):
    _g, _a, _d, _cj, ct = repeat
    kp, off, ccnt, w = _repeat_inputs(repeat, 16, 3, True)
    args = [torch.from_numpy(a) for a in (kp, off, ccnt, w)]
    tqd.reset_launches()
    got = tqd.ref_retention_kernel(ct, *args[:3], weights=args[3])
    assert tqd.ref_retention_kernel.launches == 0      # CPU: plain
    np.testing.assert_array_equal(got.numpy(), tqd._ref_retention(
        ct, *args[:3], args[3]).numpy())
    with pytest.raises(TypeError):
        tqd.ref_retention_kernel(ct, args[0].long(), *args[1:3])
    with pytest.raises(TypeError):
        tqd.ref_retention_kernel(ct, *args[:3], weights=args[3].double())
    with pytest.raises(ValueError):
        tqd.ref_retention_kernel(ct, args[0], args[1], args[2][:, :5])
    with pytest.raises(ValueError):
        tqd.ref_retention_kernel(ct, args[0], args[1].to("meta"), args[2])


@pytest.mark.parametrize("shape", ["short", "long"])
def test_kernel_equals_plain_on_the_card(repeat, long_cfg, shape):
    """The CUDA kernel, one launch, against the plain version on the card
    (chip_smoke.py does this on the main path's warmup batch and at
    32 x 6,000)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    if shape == "short":
        ct = repeat[4]
        kp, off, ccnt, w = _repeat_inputs(repeat, 256, 9, True)
    else:
        ct = long_cfg[1]._replace(max_usable_length=3000)
        kp, off, ccnt = crafted(np.random.default_rng(12), 32, 750, 3000,
                                long_cfg[1].offsets_list)
        w = np.random.default_rng(13).uniform(0.3, 1, kp.shape).astype(
            np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (kp, off, ccnt, w)]
    want = tqd._ref_retention(ct, *args[:3], args[3])
    tqd.reset_launches()
    got = tqd.ref_retention_kernel(ct, *args[:3], weights=args[3])
    assert tqd.ref_retention_kernel.launches == 1
    assert torch.equal(got, want)
