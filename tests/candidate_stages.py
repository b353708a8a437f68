"""The candidate stage's intermediate stages in both packages on the same
reads, for the slot pack's and the chain step's CPU tests: the JAX
package's ``candidate_stage`` stopped at each of its ``_stop`` points, and
the port's ``candidate_stage`` with the inputs and outputs of its two
kernel wrappers (``slot_pack_kernel``, ``chain_candidates_kernel``)
recorded. Configurations: the short one of tests/test_torch_quickmap.py
(L = 100, k = 11, W = 64) and a long one (L = 6,000, k = 12, 750 keys,
W = 512) on a 60 kbp genome with a repeated 2 kbp unit."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bbmap_tpu.align import quickmap_device as jqd
from bbmap_tpu.align import seed as seed_host
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.align import quickmap_device as tqd
from tests.test_torch_quickmap import binned_quality, make_reads

BASES = np.frombuffer(b"ACGT", np.uint8)
STOPS = ("admit", "slots", "sort", "votes", "runs")
LONG_L = 6000


@functools.lru_cache(maxsize=None)
def short_index():
    """tests/test_torch_quickmap.py's genome and index (k = 11)."""
    rng = np.random.default_rng(42)
    g0 = rng.choice(BASES, size=80_000).astype(np.uint8)
    unit = rng.choice(BASES, size=600).astype(np.uint8)
    for at in (5_000, 22_000, 47_000, 63_000):
        g0[at:at + 600] = unit
    g = Genome(chroms=[g0], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g0),
                 name="c1")]).finalize()
    index = build_index(g, 11)
    analyze_index(index, 0.01)
    return index, tqd.DeviceIndex(convert.index(index), "cpu")


@functools.lru_cache(maxsize=None)
def long_index():
    """A 60 kbp genome with a 2 kbp unit at three places, k = 12."""
    rng = np.random.default_rng(5)
    g0 = rng.choice(BASES, size=60_000).astype(np.uint8)
    unit = rng.choice(BASES, size=2_000).astype(np.uint8)
    for at in (4_000, 25_000, 44_000):
        g0[at:at + 2_000] = unit
    g = Genome(chroms=[g0], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g0),
                 name="c1")]).finalize()
    index = build_index(g, 12)
    analyze_index(index, 0.01)
    return index, tqd.DeviceIndex(convert.index(index), "cpu")


def long_reads(index, n: int, seed: int):
    """n reads of 6,000 bp with 2 % substitutions, every other one
    reverse-complemented, one over the repeat unit."""
    from bbmap_tpu.core.bases import COMP_ASCII
    rng = np.random.default_rng(seed)
    A = np.frombuffer(b"ACGTN", np.uint8)
    gc = index.genome_codes
    starts = rng.integers(0, len(gc) - LONG_L, n)
    starts[0] = 3_000
    out = np.stack([A[np.minimum(gc[s:s + LONG_L], 4)] for s in starts])
    sub = rng.random(out.shape) < 0.02
    out[sub] = BASES[rng.integers(0, 4, int(sub.sum()))]
    out[1::2] = COMP_ASCII[out[1::2]][:, ::-1]
    return out


def long_quality(n: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.integers(20, 36, (n, LONG_L)).astype(np.int8)
    q[0, 1_000:1_600] = 3
    return q


@contextlib.contextmanager
def recorded():
    """While inside, every call of the port's two kernel wrappers appends
    (name, args, output) to the list it yields."""
    calls = []
    orig = {n: getattr(tqd, n) for n in ("slot_pack_kernel",
                                         "chain_candidates_kernel")}

    def wrap(name):
        def rec(*args):
            out = orig[name](*args)
            calls.append((name, args, out))
            return out
        return rec

    try:
        for n in orig:
            setattr(tqd, n, wrap(n))
        yield calls
    finally:
        for n, f in orig.items():
            setattr(tqd, n, f)


def run_both(index, dix, L: int, bases, quality=None, two_tier=True):
    """The JAX package's candidate_stage at every stop of ``STOPS`` and in
    full, and the port's with its wrappers recorded. Returns (jax: dict
    stop -> dict of numpy arrays, "cand" -> the table; port: dict with
    the recorded "slot_pack" and "chain" (args, output) and "cand";
    the port's config)."""
    cj, ct = jqd.make_config(index, L), tqd.make_config(dix, L)
    assert tuple(cj) == tuple(ct)
    starts, sites, _gp, _nm, _G = jqd.device_arrays(index)
    scnt = jqd.scnt_array(index)
    ccnt = jqd.ccnt_array(index) if cj.ref_admit else None
    offs_j = wts_j = rej_j = offs_t = wts_t = rej_t = None
    if quality is not None:
        den2, den3 = seed_host.key_density_ladder(L, index.k)
        offs_j, wts_j, rej_j = jqd.quality_offsets_stage(
            cj, jnp.asarray(quality), den2, den3, return_weights=True)
        offs_t, wts_t, rej_t = tqd.quality_offsets_stage(
            ct, torch.from_numpy(quality), den2, den3, return_weights=True)

    def stages(b, o, w, r):
        return [jqd.candidate_stage(
            cj, b, starts, sites, offsets_dyn=o, scnt_d=scnt, ccnt_d=ccnt,
            two_tier=two_tier, weights_dyn=w, reject=r, _stop=stop)[1]
            for stop in STOPS + (None,)]

    outs = jax.jit(stages)(jnp.asarray(bases), offs_j, wts_j, rej_j)
    want = {stop or "cand": {k: np.asarray(v) for k, v in d.items()}
            for stop, d in zip(STOPS + (None,), outs)}
    with recorded() as calls:
        _rt, cand = tqd.candidate_stage(
            ct, torch.from_numpy(bases), dix, offsets_dyn=offs_t,
            weights_dyn=wts_t, reject=rej_t, two_tier=two_tier)
    got = {"cand": {k: v.numpy() for k, v in cand.items()}}
    for name, args, out in calls:
        got["slot_pack" if name == "slot_pack_kernel" else "chain"] = (
            args, out)
    return want, got, ct


@functools.lru_cache(maxsize=None)
def case(name: str):
    """run_both on a named configuration: short_quality, short_plain,
    short_one_tier, short_tier_admission (BBMAP_REF_ADMIT=0: the tier
    admission instead of the retention), long_plain, long_quality."""
    import os
    if name.startswith("short"):
        index, dix = short_index()
        B = 96
        bases = make_reads(index, B, seed=31)
        bases[:24] = make_reads(index, 24, seed=37, from_repeat=True)
        q = binned_quality(B, 5) if name == "short_quality" else None
        if name == "short_tier_admission":
            os.environ["BBMAP_REF_ADMIT"] = "0"
            try:
                return run_both(index, dix, 100, bases, q)
            finally:
                del os.environ["BBMAP_REF_ADMIT"]
        return run_both(index, dix, 100, bases, q,
                        two_tier=name != "short_one_tier")
    index, dix = long_index()
    bases = long_reads(index, 4, seed=9)
    q = long_quality(4, 10) if name == "long_quality" else None
    return run_both(index, dix, LONG_L, bases, q, two_tier=False)


CASES = ("short_quality", "short_plain", "short_one_tier",
         "short_tier_admission", "long_plain", "long_quality")
