"""Read statistics battery: histogram accumulators + report files.

reference: align2/ReadStats.java:19 — per-thread accumulators merged at
end; here one vectorized accumulator per process. Emits the reference's
machine-parsable artifact files (qhist/lhist/gchist/ihist/indelhist/
idhist/mhist), which are part of the tool contract
(reference: docs/UsageGuide.txt:277-283).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ReadStats:
    def __init__(self, maxlen: int = 1024, maxq: int = 50,
                 max_insert: int = 2000):
        self.qhist_sum = np.zeros(maxlen, np.int64)   # per-position q sum
        self.qhist_cnt = np.zeros(maxlen, np.int64)
        self.lhist = np.zeros(maxlen + 1, np.int64)
        self.gchist = np.zeros(101, np.int64)
        self.ihist = np.zeros(max_insert + 1, np.int64)
        self.idhist = np.zeros(101, np.int64)
        self.indelhist = np.zeros(256, np.int64)
        self.mhist_m = np.zeros(maxlen, np.int64)     # match by position
        self.mhist_s = np.zeros(maxlen, np.int64)
        self.mhist_io = np.zeros(maxlen, np.int64)    # ins+other
        self.ehist = np.zeros(256, np.int64)          # errors per read
        self.maxq = maxq
        # per-position quality histogram for bqhist quartiles
        self.bq = np.zeros((maxlen, maxq + 1), np.int64)
        # per-read processing time, microsecond log2 buckets (timehist)
        self.timehist = np.zeros(64, np.int64)

    _ARRAYS = ("qhist_sum", "qhist_cnt", "lhist", "gchist", "ihist",
               "idhist", "indelhist", "mhist_m", "mhist_s", "mhist_io",
               "ehist", "bq", "timehist")

    def save_npz(self, path: str) -> None:
        """Persist the accumulator state (multi-host stripe sidecar)."""
        np.savez_compressed(path,
                            **{k: getattr(self, k)
                               for k in self._ARRAYS})

    def merge_npz(self, path: str) -> None:
        """Tree-reduce another host's accumulators into this one
        (reference: align2/ReadStats.mergeRaw:208-256 — per-thread
        accumulators summed at end of run; here per-HOST)."""
        z = np.load(path)
        for k in self._ARRAYS:
            if k in z:
                a = getattr(self, k)
                b = z[k]
                n = min(a.shape[0], b.shape[0])
                if a.ndim == 1:
                    a[:n] += b[:n]
                else:
                    m = min(a.shape[1], b.shape[1])
                    a[:n, :m] += b[:n, :m]

    def add_batch(self, bases: np.ndarray, quality: Optional[np.ndarray],
                  lengths: np.ndarray) -> None:
        B, Lmax = bases.shape
        Lcap = min(Lmax, len(self.qhist_cnt))
        valid = np.arange(Lcap)[None, :] < lengths[:, None]
        if quality is not None:
            q = quality[:, :Lcap]
            self.qhist_sum[:Lcap] += np.where(valid, q, 0).sum(0)
            self.qhist_cnt[:Lcap] += valid.sum(0)
            qc = np.clip(q, 0, self.maxq)
            rows, cols = np.nonzero(valid)
            np.add.at(self.bq, (cols, qc[rows, cols]), 1)
        np.add.at(self.lhist, np.minimum(lengths, len(self.lhist) - 1), 1)
        gc = ((bases[:, :Lcap] == ord("G")) |
              (bases[:, :Lcap] == ord("C"))) & valid
        at = ((bases[:, :Lcap] == ord("A")) |
              (bases[:, :Lcap] == ord("T"))) & valid
        denom = np.maximum(1, gc.sum(1) + at.sum(1))
        pct = np.clip((100.0 * gc.sum(1) / denom).round().astype(int),
                      0, 100)
        np.add.at(self.gchist, pct, 1)

    def add_insert(self, insert: int) -> None:
        if insert > 0:
            self.ihist[min(insert, len(self.ihist) - 1)] += 1

    def add_match(self, match: bytes) -> None:
        m = np.frombuffer(match, np.uint8)
        n = len(m)
        Lcap = min(n, len(self.mhist_m))
        mm = m[:Lcap]
        self.mhist_m[:Lcap] += mm == ord("m")
        self.mhist_s[:Lcap] += (mm == ord("S")) | (mm == ord("N"))
        self.mhist_io[:Lcap] += (mm == ord("I")) | (mm == ord("D")) | \
            (mm == ord("X")) | (mm == ord("Y"))
        subs = int((m == ord("S")).sum())
        dels = int((m == ord("D")).sum())
        inss = int((m == ord("I")).sum())
        self.indelhist[min(dels + inss, 255)] += 1
        self.ehist[min(subs + dels + inss, 255)] += 1
        ident = 100.0 * int((m == ord("m")).sum()) / max(1, n)
        self.idhist[int(np.clip(round(ident), 0, 100))] += 1

    # ---- writers (reference artifact formats) ----
    def write_qhist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#BaseNum\tRead1_linear\n")
            nz = np.nonzero(self.qhist_cnt)[0]
            for i in nz:
                fh.write(f"{i}\t{self.qhist_sum[i]/self.qhist_cnt[i]:.3f}\n")

    def write_lhist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#Length\tCount\n")
            for i in np.nonzero(self.lhist)[0]:
                fh.write(f"{i}\t{self.lhist[i]}\n")

    def write_gchist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#GC\tCount\n")
            for i in np.nonzero(self.gchist)[0]:
                fh.write(f"{i}\t{self.gchist[i]}\n")

    def write_ihist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#InsertSize\tCount\n")
            for i in np.nonzero(self.ihist)[0]:
                fh.write(f"{i}\t{self.ihist[i]}\n")

    def write_idhist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#Identity\tReads\n")
            for i in np.nonzero(self.idhist)[0]:
                fh.write(f"{i}\t{self.idhist[i]}\n")

    def write_indelhist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#Indels\tCount\n")
            for i in np.nonzero(self.indelhist)[0]:
                fh.write(f"{i}\t{self.indelhist[i]}\n")

    def add_time(self, seconds: float, n_reads: int) -> None:
        """Per-read wall time in log2 microsecond buckets (reference:
        ReadStats TIME_HIST / timehist= flag)."""
        if n_reads <= 0 or seconds <= 0:
            return
        us = seconds * 1e6 / n_reads
        b = int(np.clip(np.log2(max(us, 1.0)), 0, 63))
        self.timehist[b] += n_reads

    def write_ehist(self, path: str) -> None:
        """#Errors per mapped read (reference: ReadStats errorHistogram,
        ehist= flag)."""
        with open(path, "w") as fh:
            fh.write("#Errors\tCount\n")
            for i in np.nonzero(self.ehist)[0]:
                fh.write(f"{i}\t{self.ehist[i]}\n")

    def write_bqhist(self, path: str) -> None:
        """Per-position quality quartile box data (reference: ReadStats
        bqHistogram, bqhist= flag)."""
        with open(path, "w") as fh:
            fh.write("#BaseNum\tcount_1\tmin_1\tmax_1\tmean_1\tQ1_1\t"
                     "med_1\tQ3_1\n")
            for i in range(self.bq.shape[0]):
                row = self.bq[i]
                n = int(row.sum())
                if n == 0:
                    continue
                qs = np.arange(len(row))
                cum = np.cumsum(row)
                mn = int(qs[np.nonzero(row)[0][0]])
                mx = int(qs[np.nonzero(row)[0][-1]])
                mean = float((qs * row).sum() / n)
                q1 = int(np.searchsorted(cum, 0.25 * n, side="left"))
                med = int(np.searchsorted(cum, 0.50 * n, side="left"))
                q3 = int(np.searchsorted(cum, 0.75 * n, side="left"))
                fh.write(f"{i}\t{n}\t{mn}\t{mx}\t{mean:.2f}\t{q1}\t"
                         f"{med}\t{q3}\n")

    def write_timehist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#Time_us_log2\tReads\n")
            for i in np.nonzero(self.timehist)[0]:
                fh.write(f"{1 << i}\t{self.timehist[i]}\n")

    def write_mhist(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("#BaseNum\tMatch\tSub\tIndelOther\n")
            tot = np.maximum(1, self.mhist_m + self.mhist_s
                             + self.mhist_io)
            nz = np.nonzero(self.mhist_m + self.mhist_s
                            + self.mhist_io)[0]
            for i in nz:
                fh.write(f"{i}\t{self.mhist_m[i]/tot[i]:.5f}\t"
                         f"{self.mhist_s[i]/tot[i]:.5f}\t"
                         f"{self.mhist_io[i]/tot[i]:.5f}\n")
