"""Device CSR k-mer index build (reference:
align2/IndexMaker4.java:100-240 — per-block count threads, keyspace
partitioned by leading base, count -> prefix-sum -> fill).

Port of ``bbmap_tpu/index/build_device.py`` as torch operations on one
device, no atomics and no per-thread partitions:

1. rolling 2-bit keys of the packed genome over k shifted slices, in
   int64, with the sentinel 4**k for every window that holds an N
2. one stable sort of the keys -> ``sites``: the positions enter in
   order, so a stable sort orders by (key, position), as the JAX
   package's two-key sort does
3. ``starts[key]`` = the number of valid keys below ``key``: a binary
   search of every key 0..4**k in the sorted valid keys
   (``torch.searchsorted``), in chunks of the keyspace. The JAX package
   scatters each run's first position and back-fills with a reverse
   cumulative min; ``torch.cummin`` would add an int64 index tensor as
   long as ``starts`` (8.6 GB at k = 15), the search gives the same array
   and needs only a chunk of query keys beside ``starts``.

Bit-identical to the host build (index/build.py rolling_keys + stable
argsort): both order sites by (key, position).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import DeviceLike, resolve_device
from ..core.genome import Genome
from .build import KmerIndex

I32 = torch.int32
I64 = torch.int64
# keys searched a launch when ``starts`` is filled (a 128 MB int64 chunk)
SEARCH_CHUNK = 1 << 24


def _device_csr(gpack: torch.Tensor, nmask: torch.Tensor, G: int, k: int):
    """(starts (4**k + 1,) int32, sites (m,) int32 of which the first
    n_valid are the index's, n_valid) on the device of ``gpack``: the 2-bit
    words (16 bases a word) and the N bit words (32 a word), both held in
    int64."""
    dev = gpack.device
    NK = 4 ** k

    # unpack 2-bit codes + N flags
    slots = torch.arange(16, dtype=I64, device=dev) * 2
    codes = ((gpack[:, None] >> slots) & 3).reshape(-1)[:G]
    bslots = torch.arange(32, dtype=I64, device=dev)
    nb = ((nmask[:, None] >> bslots) & 1).reshape(-1)[:G].to(torch.bool)

    m = max(G - k + 1, 0)
    keys = torch.zeros(m, dtype=I64, device=dev)
    bad = torch.zeros(m, dtype=torch.bool, device=dev)
    for j in range(k):
        bad |= nb[j:m + j]
        keys = (keys << 2) | codes[j:m + j]
    keys = torch.where(bad, NK, keys)
    skeys, order = torch.sort(keys, stable=True)
    n_valid = m - int(bad.sum())           # the one read-back
    valid_keys = skeys[:n_valid]
    starts = torch.empty(NK + 1, dtype=I32, device=dev)
    for lo in range(0, NK + 1, SEARCH_CHUNK):
        hi = min(NK + 1, lo + SEARCH_CHUNK)
        starts[lo:hi] = torch.searchsorted(
            valid_keys, torch.arange(lo, hi, dtype=I64, device=dev),
            out_int32=True)
    return starts, order.to(I32), n_valid


def build_index_device(genome: Genome, k: int, usemodulo: bool = False,
                       device: DeviceLike = "cuda") -> KmerIndex:
    """Device twin of build.build_index: the same ``starts`` (int64) and
    ``sites`` (int32) as numpy arrays, built on ``device`` (the card unless
    the caller asks for the CPU). The device arrays stay on the index as
    ``_device_arrays`` = (starts int32, sites int32, gpack, nmask, G), which
    ``DeviceIndex`` takes instead of uploading them again;
    ``analyze_index`` drops them when it compacts the index.

    ``usemodulo`` builds on the host, as the JAX package does: it is the
    low-memory mode of the index, not a speed path."""
    if usemodulo:
        from .build import build_index
        return build_index(genome, k, usemodulo=True)
    from ..align.quickmap_device import pack_genome_2bit
    dev = resolve_device(device)
    codes, offsets = genome.packed_codes()
    G = len(codes)
    gpack_np, nmask_np = pack_genome_2bit(codes)
    gpack = torch.from_numpy(gpack_np.astype(np.int64)).to(dev)
    nmask = torch.from_numpy(nmask_np.astype(np.int64)).to(dev)
    starts_d, sites_d, n = _device_csr(gpack, nmask, G, k)
    sites_d = sites_d[:n]
    idx = KmerIndex(k=k, starts=starts_d.cpu().numpy().astype(np.int64),
                    sites=sites_d.cpu().numpy(), genome_codes=codes,
                    chrom_offsets=offsets)
    # the freshly built arrays are already on the device; seed the
    # device cache so the aligner skips the big re-upload
    idx._device_arrays = (starts_d, sites_d, gpack, nmask, G)
    return idx
