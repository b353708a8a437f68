"""kmercountexact: exact k-mer counting, histogram, and peak calling.

reference: jgi/KmerCountExact.java + kmer/KmerTableSet.java +
jgi/CallPeaks.java. Instead of ways-partitioned hash tables, k-mers are
counted by sort: canonical k-mers of all reads are accumulated in chunks
and merged with a radix-style sorted reduction — the array-native
equivalent (and the same layout the index build uses).

The port's copy of the JAX package's tool (host numpy); it also counts
the mates of ``in2=``, as the reference tool does.
"""

from __future__ import annotations

import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.batch import ReadBatch, batched
from ..index.build import reverse_complement_key
from ..index.kmerset import rolling_kmers_batch
from ..io import fastx
from ..utils.args import Args


class KmerCounter:
    """Sorted-array exact counter with chunked accumulation."""

    def __init__(self, k: int, canonical: bool = True,
                 chunk_kmers: int = 32_000_000):
        self.k = k
        self.canonical = canonical
        self.chunk_kmers = chunk_kmers
        self._pending: List[np.ndarray] = []
        self._pending_n = 0
        self._keys = np.zeros(0, np.int64)
        self._counts = np.zeros(0, np.int64)

    def add_batch(self, bases: np.ndarray) -> None:
        kmers, valid = rolling_kmers_batch(bases, self.k)
        km = kmers[valid]
        if self.canonical and len(km):
            km = np.minimum(km, reverse_complement_key(km, self.k))
        if len(km):
            self._pending.append(km)
            self._pending_n += len(km)
        if self._pending_n >= self.chunk_kmers:
            self._merge()

    def _merge(self) -> None:
        if not self._pending:
            return
        new = np.sort(np.concatenate(self._pending))
        self._pending = []
        self._pending_n = 0
        uniq_mask = np.ones(len(new), bool)
        uniq_mask[1:] = new[1:] != new[:-1]
        uk = new[uniq_mask]
        uc = np.diff(np.concatenate([np.nonzero(uniq_mask)[0],
                                     [len(new)]]))
        if len(self._keys) == 0:
            self._keys, self._counts = uk, uc.astype(np.int64)
            return
        allk = np.concatenate([self._keys, uk])
        allc = np.concatenate([self._counts, uc])
        order = np.argsort(allk, kind="stable")
        allk, allc = allk[order], allc[order]
        m = np.ones(len(allk), bool)
        m[1:] = allk[1:] != allk[:-1]
        grp = np.cumsum(m) - 1
        merged_c = np.bincount(grp, weights=allc).astype(np.int64)
        self._keys = allk[m]
        self._counts = merged_c

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        self._merge()
        return self._keys, self._counts

    def histogram(self, max_count: int = 100000) -> np.ndarray:
        _, counts = self.finish()
        return np.bincount(np.minimum(counts, max_count),
                           minlength=max_count + 1)


def call_peaks(hist: np.ndarray, min_height: int = 2, min_volume: int = 5,
               min_width: int = 3, start: int = 2):
    """Simple peak caller over a k-mer depth histogram
    (reference: jgi/CallPeaks.java — local maxima between local minima)."""
    peaks = []
    i = start
    n = len(hist)
    while i < n - 1:
        # find next local max
        while i < n - 1 and hist[i + 1] >= hist[i]:
            i += 1
        center = i
        # descend to local min
        while i < n - 1 and hist[i + 1] <= hist[i]:
            i += 1
        left = center
        while left > start and hist[left - 1] >= hist[center] * 0.5:
            left -= 1
        right = min(i, n - 1)
        vol = int(hist[left:right + 1].sum())
        if hist[center] >= min_height and vol >= min_volume \
                and right - left + 1 >= min_width:
            peaks.append(dict(center=center, start=left, stop=right,
                              height=int(hist[center]), volume=vol))
        i += 1
        if len(peaks) > 20:
            break
    return peaks


def callpeaks_main(argv: List[str]) -> int:
    """Standalone peak caller over a 2-column (x, y) histogram file
    (reference: callpeaks.sh / jgi/CallPeaks.main). Supports
    countcolumn=, smoothing (smoothradius= triangle filter), and the
    min/max peak gates."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    min_height = args.get_int("minheight", "h", default=2)
    min_volume = args.get_int("minvolume", "v", default=2)
    min_width = args.get_int("minwidth", "w", default=2)
    min_peak = args.get_int("minpeak", "minp", default=2)
    max_peak = args.get_int("maxpeak", "maxp", default=1 << 30)
    max_count = args.get_int("maxpeakcount", "maxpc", default=8)
    col = args.get_int("countcolumn", "col", default=1)
    smoothradius = args.get_int("smoothradius", default=0)
    if inp is None:
        print("Usage: callpeaks in=<histogram> out=<file>",
              file=sys.stderr)
        return 1
    xs: List[int] = []
    ys: List[float] = []
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split()
            try:
                xs.append(int(f[0]))
                ys.append(float(f[col]))
            except (ValueError, IndexError):
                continue
    n = (max(xs) + 2) if xs else 2
    hist = np.zeros(n, np.float64)
    for x, y in zip(xs, ys):
        hist[x] = y
    if smoothradius > 0:
        r = smoothradius
        w = np.concatenate([np.arange(1, r + 2),
                            np.arange(r, 0, -1)]).astype(np.float64)
        w /= w.sum()
        hist = np.convolve(hist, w, mode="same")
    pk = call_peaks(hist, min_height=min_height, min_volume=min_volume,
                    min_width=min_width, start=max(1, min_peak))
    pk = [p for p in pk if min_peak <= p["center"] <= max_peak]
    pk.sort(key=lambda p: -p["height"])
    pk = pk[:max_count]
    pk.sort(key=lambda p: p["center"])
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    oh.write("#center\tstart\tstop\theight\tvolume\n")
    for p in pk:
        oh.write(f"{p['center']}\t{p['start']}\t{p['stop']}\t"
                 f"{p['height']}\t{p['volume']}\n")
    if out:
        oh.close()
    return 0


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    k = args.get_int("k", default=31)
    khist_path = args.get("khist", "hist")
    out = args.get("out", "dump")
    mincount = args.get_int("mincounttodump", "mincount", default=1)
    peaks_path = args.get("peaks")
    if in1 is None:
        print("Usage: kmercountexact in=<reads> k=31 khist=<file> "
              "[out=<dump.fa>]", file=sys.stderr)
        return 1
    big = k > 31
    if big:
        from ..index.kmer_big import KmerCounterBig, big_kmer_to_str
        counter = KmerCounterBig(k)
    else:
        counter = KmerCounter(k)
    n = 0
    for path in (in1, in2) if in2 else (in1,):
        for chunk in batched(fastx.read_seqs(path), 8192):
            b = ReadBatch.from_records(chunk)
            counter.add_batch(b.bases)
            n += b.size
    if big:
        hi, lo, counts = counter.finish()
        keys = hi  # length proxy for reporting
    else:
        keys, counts = counter.finish()
    sys.stderr.write(f"Reads:\t{n}\nUnique kmers:\t{len(keys)}\n")
    if khist_path:
        hist = counter.histogram()
        nz = np.nonzero(hist)[0]
        with fastx.xopen(khist_path, "wt") as fh:
            fh.write("#Depth\tCount\n")
            for d in nz:
                if d > 0:
                    fh.write(f"{d}\t{hist[d]}\n")
    if peaks_path:
        hist = counter.histogram()
        pk = call_peaks(hist)
        with fastx.xopen(peaks_path, "wt") as fh:
            fh.write("#center\tstart\tstop\theight\tvolume\n")
            for p in pk:
                fh.write(f"{p['center']}\t{p['start']}\t{p['stop']}\t"
                         f"{p['height']}\t{p['volume']}\n")
    if out:
        sel = counts >= mincount
        with fastx.xopen(out, "wt") as fh:
            if big:
                from ..index.kmer_big import big_kmer_to_str
                for h, l, cnt in zip(hi[sel], lo[sel], counts[sel]):
                    fh.write(f">{cnt}\n"
                             f"{big_kmer_to_str(int(h), int(l), k)}\n")
            else:
                table = np.frombuffer(b"ACGT", np.uint8)
                for key, cnt in zip(keys[sel], counts[sel]):
                    chars = []
                    for j in range(k - 1, -1, -1):
                        chars.append(chr(table[(int(key) >> (2 * j)) & 3]))
                    fh.write(f">{cnt}\n{''.join(chars)}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
