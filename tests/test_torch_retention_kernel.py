"""The key-retention kernel (bbmap_tpu_torch/csrc/ref_retention.cu, wrapper
``quickmap_device.ref_retention_kernel``): a numpy emulation of both its
mappings, in the kernel's order (a read's own loop that ends when its cond
fails or it stops; "regs", a key a lane: ballots for the tier counts, lane
r holding the r-th admitted key's weight, the warp's prefix max and suffix
min of the alive offsets, the alive rank by popcount, the running min, the
first trigger by ballot and the argmin as the warp's min then its lowest
lane; "block", KPT keys a thread: each thread's own keys, warp scans over
the threads, the warp totals combined after each barrier, the argmin's and
the first trigger's ties to the lowest warp; int32 sums and products
wrapped as unsigned), held to the plain version (``_ref_retention``) and to
the JAX package's ``_ref_retention`` on the repeat-heavy genome of
tests/test_torch_search_oracle.py without and with quality weights, on key
counts crafted across the re-admission tiers and the trim's branches (ties,
the early-termination trigger, kills), and at nk = 750 (L = 6,000, k = 12)
and 40. Mutations the emulation must fail: an argmin that keeps the last
index on ties, a block argmin that keeps the last warp's index on ties, and
a read that stops one round early. The mapping rule
(``retention_mapping``). Tolerance: exact."""

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


def _keys_a_thread(nk):
    """The block mapping's keys a thread (csrc/ref_retention.cu
    keys_a_thread)."""
    return next(kpt for kpt in (1, 2, 4, 8) if nk <= kpt * 1024)


def _key_value(o, offL, nxt, l, w, first_or_last, numl, off_last, lim):
    """A key's value in a round (unsigned wraps as int32)."""
    is_first, is_last = offL == -1, nxt == BIG
    offR = off_last + 1 if is_last else nxt
    vp = 30000 + 60000 // numl + 300000 // max(l, 1)
    if first_or_last:
        vp += 40000
    oldL, oldR, newS = o - offL, offR - o, offR - offL
    space = ((oldL * oldL + oldR * oldR) - newS * newS) * -30
    if is_first:
        uc = offR - o
    elif is_last:
        uc = o - offL
    else:
        uc = max(_i32(offR - (offL + lim["chunk"])), 0)
    tail = (11500 if is_first or is_last else 6000) * uc
    vp_final = _i32(vp + 11500 * lim["chunk"] if numl == 1
                    else vp + space + tail)
    vpw = vp_final if w is None else int(np.float32(vp_final) * w)
    return _i32(vpw + lim["pps"] * min(l, lim["vm_cap"]))


def _limits(cfg, nk):
    maxLen = cfg.max_usable_length
    pps = cfg.points_per_site
    return {"tiers": [min(t, INT_MAX) for t in (
                maxLen, (maxLen * 3) // 2, maxLen * 2, maxLen * 3,
                maxLen * 5)],
            "trig": (3 * nk) // 4, "limit3": max(20, cfg.limit_shortest),
            "limit_avg": max(20, cfg.limit_avg),
            "limit2": max(20, cfg.limit_avg2), "pps": pps,
            "vm_cap": (2 ** 30) // max(1, -pps), "chunk": cfg.k}


def _admission_tier(n, lim):
    tier, num = lim["tiers"][0], n[0]
    for t, need in ((1, 4), (2, 3), (3, 3), (4, 2)):
        if n[0] > 0 and num < need and num < lim["trig"]:
            num, tier = n[t], lim["tiers"][t]
    return tier


def _trims(hits, total, initial, lim):
    max_lists = max(int(np.float32(0.85) * np.float32(initial)), 6)
    return hits >= 1 and (total > _i32(lim["limit_avg"] * initial)
                          or total // max(initial, 1) > lim["limit2"]
                          or hits > max_lists)


def _regs_read(o, c, ok, w, lim, mutation, max_rounds):
    """One read in the "regs" mapping: a key a lane (nk <= 32), ballots,
    warp scans and __reduce_min_sync. Returns (alive, rounds)."""
    nk = len(o)
    lanes = range(32)
    inn = [ln < nk for ln in lanes]
    o = o + [0] * (32 - nk)
    c = c + [0] * (32 - nk)
    ok = ok + [False] * (32 - nk)
    n = [sum(ok[ln] and c[ln] < t for ln in lanes) for t in lim["tiers"]]
    tier = _admission_tier(n, lim)
    adm = [ok[ln] and c[ln] < tier for ln in lanes]
    ball = [ln for ln in lanes if adm[ln]]
    initial = len(ball)
    total0 = _i32(sum(c[ln] for ln in ball))
    shortest = min([c[ln] for ln in ball] or [BIG])
    first_adm = ball[0] if ball else 0
    last_adm = ball[-1] if ball else nk - 1
    off_last = o[last_adm]
    # lane r: the r-th admitted key's weight (nth_set of the ballot)
    wc = [None if w is None else w[ball[r]] if r < initial else None
          for r in lanes]
    kill = initial >= 1 and shortest > lim["limit3"]
    alive = [a and not kill for a in adm]
    hits = 0 if kill else initial
    total = 0 if kill else total0
    rounds = 0
    while _trims(hits, total, initial, lim):
        if max_rounds is not None and rounds >= max_rounds:
            break
        rounds += 1
        numl = max(hits, 1)
        ab = [ln for ln in lanes if alive[ln]]
        first_alive = ab[0] if ab else 0
        pmax, smin = [], [BIG] * 32
        m = -1
        for ln in lanes:                     # inclusive prefix max
            m = max(m, o[ln] if alive[ln] else -1)
            pmax.append(m)
        m = BIG
        for ln in reversed(lanes):           # inclusive suffix min
            m = min(m, o[ln] if alive[ln] else BIG)
            smin[ln] = m
        val = [BIG if inn[ln] else INT_MAX for ln in lanes]
        for ln in ab:
            rank = sum(1 for x in ab if x < ln)
            val[ln] = _key_value(
                o[ln], pmax[ln - 1] if ln else -1,
                smin[ln + 1] if ln < 31 else BIG, c[ln],
                wc[rank], ln in (first_adm, last_adm), numl, off_last, lim)
        before, m = [], INT_MAX
        for ln in lanes:                     # the running min before it
            before.append(min(m if ln else BIG, BIG))
            m = min(m, val[ln])
        tb = [ln for ln in ab if val[ln] < before[ln]
              and before[ln] < tqd.EARLY_TERMINATION_SCORE
              and ln != first_alive]
        vmin = min(val)
        mb = [ln for ln in lanes if val[ln] == vmin]
        worst = tb[0] if tb else (mb[-1] if mutation == "last_tie"
                                  else mb[0])
        worst_len = c[worst] if alive[worst] else 0
        total = _i32(total - worst_len)
        if val[worst] > 0 or worst_len < 20:
            break
        alive[worst] = False
        hits -= 1
    return alive[:nk], rounds


def _block_read(o, c, ok, w, lim, mutation, max_rounds):
    """One read in the "block" mapping: KPT keys a thread, warp scans over
    the threads' own results, the warp totals combined after each barrier
    (lowest warp on ties). Returns (alive, rounds)."""
    nk = len(o)
    kpt = _keys_a_thread(nk)
    nthreads = -(-(-(-nk // kpt)) // 32) * 32
    nwarps = nthreads // 32
    keys = [range(t * kpt, min(t * kpt + kpt, nk)) for t in range(nthreads)]
    n = [sum(ok[j] and c[j] < t for j in range(nk)) for t in lim["tiers"]]
    tier = _admission_tier(n, lim)
    adm = [ok[j] and c[j] < tier for j in range(nk)]
    # admitted ranks: the warps' counts before, the lanes' before, the keys
    cnt = [sum(adm[j] for j in ks) for ks in keys]
    wtot = [sum(cnt[32 * wp:32 * wp + 32]) for wp in range(nwarps)]
    initial = sum(wtot)
    wc = [None] * nk
    for t, ks in enumerate(keys):
        wp, lane = divmod(t, 32)
        r = sum(wtot[:wp]) + sum(cnt[32 * wp:t])
        for j in ks:
            if adm[j] and w is not None:
                wc[r] = w[j]
            r += adm[j]
    admitted = [j for j in range(nk) if adm[j]]
    total0 = _i32(sum(c[j] for j in admitted))
    shortest = min([c[j] for j in admitted] or [BIG])
    first_adm = admitted[0] if admitted else 0
    last_adm = admitted[-1] if admitted else nk - 1
    off_last = o[last_adm]
    kill = initial >= 1 and shortest > lim["limit3"]
    alive = [a and not kill for a in adm]
    hits = 0 if kill else initial
    total = 0 if kill else total0
    rounds = 0
    vals, lens = [0] * nk, [0] * nk
    while _trims(hits, total, initial, lim):
        if max_rounds is not None and rounds >= max_rounds:
            break
        rounds += 1
        numl = max(hits, 1)
        # A: the threads' alive counts and offsets' max and min
        ca = [sum(alive[j] for j in ks) for ks in keys]
        lmax = [max([o[j] for j in ks if alive[j]] or [-1]) for ks in keys]
        lmin = [min([o[j] for j in ks if alive[j]] or [BIG]) for ks in keys]
        s_cnt, s_max, s_min = [0] * nthreads, [0] * nthreads, [0] * nthreads
        for wp in range(nwarps):
            ts = range(32 * wp, 32 * wp + 32)
            acc_c, acc_m = 0, -1
            for t in ts:
                acc_c, acc_m = acc_c + ca[t], max(acc_m, lmax[t])
                s_cnt[t], s_max[t] = acc_c, acc_m
            acc = BIG
            for t in reversed(ts):
                acc = min(acc, lmin[t])
                s_min[t] = acc
        a_count = [s_cnt[32 * wp + 31] for wp in range(nwarps)]
        a_max = [s_max[32 * wp + 31] for wp in range(nwarps)]
        a_min = [s_min[32 * wp] for wp in range(nwarps)]
        alive_keys = [j for j in range(nk) if alive[j]]
        first_alive = alive_keys[0] if alive_keys else 0
        lrmin = [INT_MAX] * nthreads
        for t, ks in enumerate(keys):
            wp, lane = divmod(t, 32)
            rank = sum(a_count[:wp]) + (s_cnt[t - 1] if lane else 0)
            offL = max([-1] + a_max[:wp] + ([s_max[t - 1]] if lane else []))
            nxt = min([BIG] + a_min[wp + 1:]
                      + ([s_min[t + 1]] if lane < 31 else []))
            nexts = {}
            for j in reversed(ks):
                nexts[j] = nxt
                if alive[j]:
                    nxt = min(nxt, o[j])
            for j in ks:
                val = BIG
                if alive[j]:
                    val = _key_value(o[j], offL, nexts[j], c[j],
                                     None if w is None else wc[rank],
                                     j in (first_adm, last_adm), numl,
                                     off_last, lim)
                    offL = max(offL, o[j])
                    rank += 1
                vals[j], lens[j] = val, c[j] if alive[j] else 0
                lrmin[t] = min(lrmin[t], val)
        # B: the warps' running mins and argmins, then the block's
        b_min, b_idx, s_rmin = [], [], [0] * nthreads
        for wp in range(nwarps):
            ts = range(32 * wp, 32 * wp + 32)
            acc = INT_MAX
            for t in ts:
                acc = min(acc, lrmin[t])
                s_rmin[t] = acc
            wv = min(lrmin[t] for t in ts)
            holder = [t for t in ts if lrmin[t] == wv]
            t = holder[-1] if mutation == "last_tie" else holder[0]
            ks = [j for j in keys[t] if vals[j] == wv]
            b_min.append(wv)
            b_idx.append((ks[-1] if mutation == "last_tie" else ks[0])
                         if ks else INT_MAX)
        vmin = min(b_min)
        holders = [wp for wp in range(nwarps) if b_min[wp] == vmin]
        argmin = b_idx[holders[-1] if mutation == "last_warp"
                       else holders[0]]
        # C: the first key to set a new running min below the early
        # termination score (not the first alive key)
        first_trig = BIG
        for t, ks in enumerate(keys):
            wp, lane = divmod(t, 32)
            before = min([INT_MAX] + b_min[:wp]
                         + ([s_rmin[t - 1]] if lane else []) + [BIG])
            for j in ks:
                if alive[j] and vals[j] < before \
                        and before < tqd.EARLY_TERMINATION_SCORE \
                        and j != first_alive:
                    first_trig = min(first_trig, j)
                    break
                before = min(before, vals[j])
        worst = first_trig if first_trig != BIG else argmin
        total = _i32(total - lens[worst])
        if vals[worst] > 0 or lens[worst] < 20:
            break
        alive[worst] = False
        hits -= 1
    return alive, rounds


def retention_emulation(cfg, kp, off, ccnt, weights=None, mutation=None,
                        max_rounds=None, mapping=None):
    """numpy model of csrc/ref_retention.cu in ``mapping`` (the wrapper's
    rule when None), a read at a time. Returns (alive (B, nk) bool, rounds
    (B,) int32: the rounds whose cond held). ``mutation``: "last_tie" (the
    argmin keeps the last lane, and key, on ties), "last_warp" (the block
    argmin keeps the last warp's on ties); ``max_rounds`` (B,) caps each
    read's rounds (a read that stops early)."""
    B, nk = kp.shape
    mapping = tqd.retention_mapping(nk, mapping)
    lim = _limits(cfg, nk)
    read = _regs_read if mapping == "regs" else _block_read
    alive_out = np.zeros((B, nk), bool)
    rounds_out = np.zeros(B, np.int32)
    for b in range(B):
        c = [int(x) for x in ccnt[b]]
        ok = [int(kp[b, j]) >= 0 and c[j] > 0 for j in range(nk)]
        w = None if weights is None else [np.float32(x) for x in weights[b]]
        alive, rounds = read(
            [int(x) for x in off[b]], c, ok, w, lim, mutation,
            None if max_rounds is None else int(max_rounds[b]))
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
    if kp.shape[1] <= tqd.RETENTION_REGS_MAX_NK:       # "block" holds it too
        np.testing.assert_array_equal(retention_emulation(
            ct, kp, off, ccnt, weights, mapping="block")[0], want)
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


def _tie_rows(nk):
    """Two reads whose seven admitted keys (count 20, the rest unused) lie
    in seven warps of the block mapping at 750 keys, evenly spaced, with
    small equal weights: the five inner keys tie below 0, and one round
    removes one of them (hits 7 > max_lists 6, then the total is at the
    limit)."""
    kp = np.full((2, nk), -1, np.int32)
    ccnt = np.zeros((2, nk), np.int32)
    off = np.zeros((2, nk), np.int32)
    for b, keys in enumerate(([10, 150, 290, 430, 570, 710, 740],
                              [3, 140, 300, 420, 560, 700, 749])):
        kp[b, keys] = 7
        ccnt[b, keys] = 20
        off[b] = np.arange(nk) * 8
        off[b, keys] = 6 * np.arange(1, 8)
    return kp, off, ccnt, np.full((2, nk), 0.01, np.float32)


def test_block_last_warp_mutation_fails(long_cfg):
    """At 750 keys (24 warps, a key a thread) inner keys tie across
    warps: a block argmin that keeps the last warp's key removes another
    key than the plain version; on crafted counts at 750 and at 40 keys
    (two warps) the block mapping holds the plain version."""
    cj, ct = (c._replace(max_usable_length=3000) for c in long_cfg)
    args = _tie_rows(750)
    want = _plain(ct, *args)
    np.testing.assert_array_equal(_jax(cj, *args), want)
    alive, rounds = retention_emulation(ct, *args)
    np.testing.assert_array_equal(alive, want)
    assert (rounds == 1).all() and (want.sum(1) == 6).all()
    got = retention_emulation(ct, *args, mutation="last_warp")[0]
    assert (got != want).any()
    for nk, seed in ((750, 11), (40, 12)):
        kp, off, ccnt = crafted(np.random.default_rng(seed), 6, nk, 3000,
                                ct.offsets_list[:nk])
        w = np.random.default_rng(13).uniform(0.3, 1, kp.shape).astype(
            np.float32)
        np.testing.assert_array_equal(retention_emulation(
            ct, kp, off, ccnt, w)[0], _plain(ct, kp, off, ccnt, w))


def test_mapping_rule():
    """"regs" up to 32 keys, "block" past them and up to 8,192; a mapping
    given is kept where it holds nk, refused where not."""
    assert tqd.retention_mapping(18) == "regs"
    assert tqd.retention_mapping(32) == "regs"
    assert tqd.retention_mapping(33) == "block"
    assert tqd.retention_mapping(750) == "block"
    assert tqd.retention_mapping(18, "block") == "block"
    for nk, mapping in ((33, "regs"), (8193, None), (8193, "block"),
                        (18, "lanes")):
        with pytest.raises(ValueError):
            tqd.retention_mapping(nk, mapping)


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
    with pytest.raises(ValueError):
        tqd.ref_retention_kernel(ct, *args[:3], mapping="warp")
    np.testing.assert_array_equal(tqd.ref_retention_kernel(
        ct, *args[:3], weights=args[3], mapping="block").numpy(), got.numpy())
    assert tqd.ref_retention_kernel.launches_by == {"regs": 0, "block": 0}


@pytest.mark.parametrize("shape,mapping", [("short", "regs"),
                                           ("short", "block"),
                                           ("long", "block")])
def test_kernel_equals_plain_on_the_card(repeat, long_cfg, shape, mapping):
    """The CUDA kernel in each mapping that holds the shape, one launch,
    against the plain version on the card (chip_smoke.py does this on the
    main path's warmup batch and at 32 x 6,000)."""
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
    got = tqd.ref_retention_kernel(ct, *args[:3], weights=args[3],
                                   mapping=mapping)
    assert tqd.ref_retention_kernel.launches == 1
    assert tqd.ref_retention_kernel.launches_by[mapping] == 1
    assert torch.equal(got, want)
