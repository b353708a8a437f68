"""Native BAM read/write (BGZF container + BAM record codec).

reference: fileIO/ReadWrite.java:463-607 pipes SAM through an external
samtools process for .bam; this environment has no samtools, so the
format is implemented directly (BGZF: gzip members with a BSIZE extra
field, 64 KiB logical blocks, fixed EOF marker; BAM: SAM v1 spec binary
records). Round-trips through `sam_lines_to_bam` / `bam_to_sam_lines`
preserve all fields and tags emitted by this package.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BLOCK = 64 * 1024 - 256

CIGAR_OPS = "MIDNSHP=X"
SEQ_NYBBLE = "=ACMGRSVTWYHKDBN"
_NYB = {c: i for i, c in enumerate(SEQ_NYBBLE)}


class BgzfWriter:
    def __init__(self, path: str):
        self.fh = open(path, "wb")
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= _BLOCK:
            self._flush_block(bytes(self.buf[:_BLOCK]))
            del self.buf[:_BLOCK]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                  + struct.pack("<HHH", 6, 0x4342, 2)
                  + struct.pack("<H", bsize - 1))
        self.fh.write(header + cdata
                      + struct.pack("<II", zlib.crc32(chunk),
                                    len(chunk)))

    def close(self) -> None:
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf = bytearray()
        self.fh.write(BGZF_EOF)
        self.fh.close()


def bgzf_read_all(path: str) -> bytes:
    """Decompress every BGZF member (also accepts plain gzip)."""
    out = bytearray()
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        d = zlib.decompressobj(15 + 32)
        out += d.decompress(data[pos:])
        tail = d.unused_data
        pos = len(data) - len(tail)
        if not tail:
            break
    return bytes(out)


def _encode_record(fields: List[str], ref_ids: dict) -> bytes:
    qname = fields[0]
    flag = int(fields[1])
    rid = ref_ids.get(fields[2], -1)
    pos = int(fields[3]) - 1
    mapq = int(fields[4])
    cigar = fields[5]
    rnext = fields[6]
    nrid = (rid if rnext == "=" else ref_ids.get(rnext, -1))
    pnext = int(fields[7]) - 1
    tlen = int(fields[8])
    seq = fields[9]
    qual = fields[10]

    cig_ops: List[Tuple[int, int]] = []
    if cigar != "*":
        n = 0
        for ch in cigar:
            if ch.isdigit():
                n = n * 10 + ord(ch) - 48
            else:
                cig_ops.append((n, CIGAR_OPS.index(ch)))
                n = 0
    l_seq = 0 if seq == "*" else len(seq)

    rec = bytearray()
    rec += struct.pack("<iiBBHHHiiii", rid, pos, len(qname) + 1, mapq,
                       4680, len(cig_ops), flag, l_seq, nrid, pnext,
                       tlen)
    rec += qname.encode() + b"\x00"
    for n, op in cig_ops:
        rec += struct.pack("<I", (n << 4) | op)
    if l_seq:
        b = bytearray()
        for i in range(0, l_seq, 2):
            hi = _NYB.get(seq[i].upper(), 15)
            lo = _NYB.get(seq[i + 1].upper(), 15) if i + 1 < l_seq else 0
            b.append((hi << 4) | lo)
        rec += bytes(b)
        if qual == "*":
            rec += b"\xff" * l_seq
        else:
            rec += bytes((min(ord(c) - 33, 93) for c in qual))
    # tags
    for tag in fields[11:]:
        parts = tag.split(":", 2)
        if len(parts) != 3:
            continue
        name, typ, val = parts
        rec += name.encode()
        if typ == "i":
            rec += b"i" + struct.pack("<i", int(val))
        elif typ == "A":
            rec += b"A" + val.encode()[:1]
        elif typ == "f":
            rec += b"f" + struct.pack("<f", float(val))
        else:  # Z (and H/B serialized as Z)
            rec += b"Z" + val.encode() + b"\x00"
    return struct.pack("<i", len(rec)) + bytes(rec)


def sam_lines_to_bam(lines: Iterator[str], path: str) -> int:
    """Write SAM text (header + records) as BAM. Returns records
    written."""
    header_lines: List[str] = []
    refs: List[Tuple[str, int]] = []
    body: List[List[str]] = []
    n = 0
    w = None
    ref_ids: dict = {}

    def start(w_refs):
        ww = BgzfWriter(path)
        htext = ("".join(h + "\n" for h in header_lines)).encode()
        ww.write(b"BAM\x01" + struct.pack("<i", len(htext)) + htext)
        ww.write(struct.pack("<i", len(w_refs)))
        for name, ln in w_refs:
            nm = name.encode() + b"\x00"
            ww.write(struct.pack("<i", len(nm)) + nm
                     + struct.pack("<i", ln))
        return ww

    for line in lines:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:])
                refs.append((d["SN"], int(d["LN"])))
            continue
        if w is None:
            ref_ids = {name: i for i, (name, _) in enumerate(refs)}
            w = start(refs)
        w.write(_encode_record(line.split("\t"), ref_ids))
        n += 1
    if w is None:
        ref_ids = {name: i for i, (name, _) in enumerate(refs)}
        w = start(refs)
    w.close()
    return n


class SamTextBamWriter:
    """File-like text sink (``write``/``close``) that encodes SAM text
    into BAM on the fly — drop-in for the .sam output handle in the CLI
    tools (header lines must precede records, as emitted)."""

    def __init__(self, path: str):
        self.path = path
        self._header: List[str] = []
        self._refs: List[Tuple[str, int]] = []
        self._ref_ids: dict = {}
        self._w = None
        self._partial = ""

    def write(self, text: str) -> None:
        text = self._partial + text
        lines = text.split("\n")
        self._partial = lines.pop()
        for line in lines:
            self._line(line)

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    def _line(self, line: str) -> None:
        if not line:
            return
        if line.startswith("@"):
            self._header.append(line)
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:])
                self._refs.append((d["SN"], int(d["LN"])))
            return
        if self._w is None:
            self._start()
        self._w.write(_encode_record(line.split("\t"), self._ref_ids))

    def _start(self) -> None:
        self._ref_ids = {name: i for i, (name, _) in
                         enumerate(self._refs)}
        self._w = BgzfWriter(self.path)
        htext = ("".join(h + "\n" for h in self._header)).encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(htext))
                      + htext)
        self._w.write(struct.pack("<i", len(self._refs)))
        for name, ln in self._refs:
            nm = name.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nm)) + nm
                          + struct.pack("<i", ln))

    def close(self) -> None:
        if self._partial:
            self._line(self._partial)
            self._partial = ""
        if self._w is None:
            self._start()
        self._w.close()


def bam_to_sam_lines(path: str) -> Iterator[str]:
    """Decode a BAM file into SAM text lines (header first)."""
    data = bgzf_read_all(path)
    assert data[:4] == b"BAM\x01", "not a BAM file"
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8:8 + l_text].decode().rstrip("\x00")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs: List[str] = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        name = data[off + 4:off + 4 + l_name - 1].decode()
        off += 4 + l_name + 4
        refs.append(name)
    for line in text.splitlines():
        if line:
            yield line
    while off < len(data):
        block_size = struct.unpack_from("<i", data, off)[0]
        off += 4
        end = off + block_size
        (rid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq, nrid,
         pnext, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p:p + l_qname - 1].decode()
        p += l_qname
        cig = []
        for _ in range(n_cig):
            v = struct.unpack_from("<I", data, p)[0]
            cig.append(f"{v >> 4}{CIGAR_OPS[v & 15]}")
            p += 4
        cigar = "".join(cig) if cig else "*"
        seq = []
        for i in range(l_seq):
            b = data[p + (i >> 1)]
            seq.append(SEQ_NYBBLE[(b >> 4) if i % 2 == 0 else (b & 15)])
        p += (l_seq + 1) // 2
        quals = data[p:p + l_seq]
        p += l_seq
        qual = ("*" if not l_seq or quals[:1] == b"\xff"
                else "".join(chr(q + 33) for q in quals))
        tags = []
        while p < end:
            name = data[p:p + 2].decode()
            typ = chr(data[p + 2])
            p += 3
            if typ == "i":
                val = str(struct.unpack_from("<i", data, p)[0])
                p += 4
                typ_out = "i"
            elif typ in "cCsSI":
                size = {"c": 1, "C": 1, "s": 2, "S": 2, "I": 4}[typ]
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                       "I": "<I"}[typ]
                val = str(struct.unpack_from(fmt, data, p)[0])
                p += size
                typ_out = "i"
            elif typ == "A":
                val = chr(data[p])
                p += 1
                typ_out = "A"
            elif typ == "f":
                val = f"{struct.unpack_from('<f', data, p)[0]:g}"
                p += 4
                typ_out = "f"
            else:  # Z
                z = data.index(b"\x00", p)
                val = data[p:z].decode()
                p = z + 1
                typ_out = "Z"
            tags.append(f"{name}:{typ_out}:{val}")
        rname = refs[rid] if 0 <= rid < len(refs) else "*"
        rnext = ("=" if nrid == rid and nrid >= 0 else
                 refs[nrid] if 0 <= nrid < len(refs) else "*")
        fields = [qname, str(flag), rname, str(pos + 1), str(mapq),
                  cigar, rnext, str(pnext + 1), str(tlen),
                  "".join(seq) or "*", qual] + tags
        yield "\t".join(fields)
        off = end
