"""Bounded chunked scanning for framed append-only logs.

One reader, one set of torn-tail semantics: the hint store
(cluster/hints.py) and the CDC change log (cdc/log.py) both persist
`<I len><I crc> body` frames in append-only files, and both must survive
a SIGKILL mid-append by truncating to the last whole-record boundary at
open. The scan streams the file in bounded chunks (a long outage's hint
backlog or a full CDC retention window can be the whole byte budget;
loading it wholesale just to count records would spike startup RAM by
the sum of every log). A record spanning a chunk boundary leaves an
undecoded tail that the next read extends; whatever tail remains at EOF
is torn and truncates.

Jax-free and stdlib-only (pilint R2): config.py pulls the storage
package in at CLI startup.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

# Default scan chunk. Tests shrink this to force records across chunk
# boundaries without multi-MiB fixtures.
CHUNK_SIZE = 8 << 20


@dataclass
class ScanResult:
    """Outcome of one scan_log pass."""

    valid: int       # absolute offset of the last whole-record boundary
    size: int        # file size before any truncation
    records: int     # whole records decoded
    truncated: bool  # a torn tail was found (and cut, when truncate=True)


def scan_log(
    path: str,
    decode: Callable[[bytes], Iterator[Tuple[object, int]]],
    start: int = 0,
    chunk_size: int = CHUNK_SIZE,
    on_record: Optional[Callable[[object], None]] = None,
    truncate: bool = True,
) -> ScanResult:
    """Scan `path` from byte `start` with `decode`, a generator taking a
    buffer and yielding (record, next_offset) pairs that stops at the
    first incomplete or checksum-failing record — the exact contract of
    cluster/hints.decode_records and cdc/log.decode_cdc_records.

    Calls `on_record(record)` for every whole record. When the file ends
    in a torn tail (crash artifact) and `truncate` is set, the file is
    cut back to the last whole-record boundary so later appends never
    bury garbage mid-log.
    """
    size = os.path.getsize(path) if os.path.exists(path) else 0
    start = min(start, size)
    valid = start
    n_records = 0
    if size > start:
        with open(path, "rb") as f:
            f.seek(start)
            buf = b""
            pos = start  # absolute offset of buf[0]
            while True:
                chunk = f.read(chunk_size)
                buf += chunk
                consumed = 0
                for rec, end in decode(buf):
                    consumed = end
                    n_records += 1
                    if on_record is not None:
                        on_record(rec)
                valid = pos + consumed
                if not chunk:
                    break  # EOF: buf holds the (possibly torn) tail
                buf = buf[consumed:]
                pos += consumed
    torn = valid < size
    if torn and truncate:
        with open(path, "ab") as f:
            f.truncate(valid)
    return ScanResult(valid=valid, size=size, records=n_records,
                      truncated=torn)
