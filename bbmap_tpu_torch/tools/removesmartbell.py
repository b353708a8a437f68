"""removesmartbell: split PacBio reads at SmartBell adapter sites.

reference: pacbio/RemoveAdapters2.java + sh/removesmartbell.sh — locates
the SmartBell hairpin adapter inside long reads (the reference verifies
with MSA9PacBioAdapter; here a banded edit-distance scan over windows)
and splits the read at each adapter.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..core.bases import COMP_ASCII
from ..io import fastx
from ..ops.banded import banded_edit_distance
from ..utils.args import Args

SMARTBELL = b"ATCTCTCTCTTTTCCTCCTCCTCCGTTGTTGTTGTTGAGAGAGAT"


def find_adapters(seq: bytes, adapter: bytes = SMARTBELL,
                  max_edits: int = 8, step: int = 10) -> List[int]:
    """Approximate adapter occurrences (start positions)."""
    arr = np.frombuffer(seq, np.uint8)
    ad = np.frombuffer(adapter, np.uint8)
    ad_rc = COMP_ASCII[ad][::-1]
    la = len(ad)
    hits = []
    i = 0
    n = len(arr)
    while i + la <= n:
        window = arr[i:i + la + max_edits]
        d1 = banded_edit_distance(ad, window[:la], max_edits)
        d2 = banded_edit_distance(ad_rc, window[:la], max_edits)
        if min(d1, d2) <= max_edits:
            hits.append(i)
            i += la  # skip past this adapter
        else:
            i += step
    return hits


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    adapter = args.get("adapter")
    max_edits = args.get_int("edits", "maxedits", default=8)
    split = args.get_bool("split", default=True)
    minlen = args.get_int("minlen", "minlength", default=40)
    if inp is None or out is None:
        print("Usage: removesmartbell in=<pacbio.fq> out=<split.fq> "
              "[adapter=] [split=t]", file=sys.stderr)
        return 1
    ad = adapter.encode() if adapter else SMARTBELL
    n_in = n_out = n_adapters = 0
    out_fh = fastx.xopen(out, "wb")
    for rec in fastx.read_seqs(inp, fake_quality=30):
        n_in += 1
        hits = find_adapters(rec.bases, ad, max_edits)
        n_adapters += len(hits)
        if not hits or not split:
            pieces = [(0, len(rec.bases))]
            if hits and not split:
                # mask instead of split
                b = bytearray(rec.bases)
                for h in hits:
                    for p in range(h, min(len(b), h + len(ad))):
                        b[p] = ord("N")
                rec = fastx.SeqRecord(rec.id, bytes(b), rec.quality,
                                      rec.numeric_id)
        else:
            bounds = [0]
            for h in hits:
                bounds.extend([h, h + len(ad)])
            bounds.append(len(rec.bases))
            pieces = [(bounds[i], bounds[i + 1])
                      for i in range(0, len(bounds), 2)]
        for t, (a, b_) in enumerate(pieces):
            if b_ - a < minlen:
                continue
            n_out += 1
            name = rec.id if len(pieces) == 1 else f"{rec.id}_part{t}"
            q = rec.quality[a:b_] if rec.quality else b"I" * (b_ - a)
            out_fh.write(b"@" + name.encode() + b"\n" + rec.bases[a:b_]
                         + b"\n+\n" + q + b"\n")
    out_fh.close()
    sys.stderr.write(f"Reads:\t{n_in}\nAdapters found:\t{n_adapters}\n"
                     f"Output:\t{n_out}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
