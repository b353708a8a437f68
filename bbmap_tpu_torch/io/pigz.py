"""Parallel (pigz-class) gzip compression.

reference: fileIO/ReadWrite.java pipes output through an external pigz
process when available (USE_PIGZ, :700-780); here the same
block-parallel scheme runs in-process: the stream is cut into chunks,
each chunk deflates on a worker thread (zlib releases the GIL), and
members are written in order. The output is standard multi-member gzip,
byte-compatible with every gzip reader (exactly pigz's format).
"""

from __future__ import annotations

import gzip
import io
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

CHUNK = 512 * 1024


def _compress_member(chunk: bytes, level: int) -> bytes:
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=level,
                       mtime=0) as gz:
        gz.write(chunk)
    return buf.getvalue()


class ParallelGzipWriter:
    """Binary file-like writer producing multi-member gzip with
    background compression threads."""

    def __init__(self, path: str, threads: Optional[int] = None,
                 level: int = 6, chunk: int = CHUNK):
        self.fh = open(path, "wb")
        self.level = level
        self.chunk = chunk
        n = threads if threads is not None else \
            max(1, (os.cpu_count() or 2) - 1)
        self.pool = ThreadPoolExecutor(max_workers=n)
        self.pending: List = []
        self.max_pending = 2 * n + 2
        self.buf = bytearray()
        self.closed = False

    def write(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        self.buf += data
        while len(self.buf) >= self.chunk:
            self._submit(bytes(self.buf[:self.chunk]))
            del self.buf[:self.chunk]
        return len(data)

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    def _submit(self, chunk: bytes) -> None:
        self.pending.append(
            self.pool.submit(_compress_member, chunk, self.level))
        while len(self.pending) > self.max_pending:
            self.fh.write(self.pending.pop(0).result())

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.buf:
            self._submit(bytes(self.buf))
            self.buf = bytearray()
        for fut in self.pending:
            self.fh.write(fut.result())
        self.pending = []
        self.pool.shutdown()
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TextParallelGzipWriter:
    """Text-mode wrapper around ParallelGzipWriter."""

    def __init__(self, path: str, **kw):
        self._w = ParallelGzipWriter(path, **kw)

    def write(self, text: str) -> int:
        return self._w.write(text.encode())

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
