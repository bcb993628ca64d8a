"""Binary wire codec for node-to-node query results.

Replaces the JSON column-list encoding for remote results (the reference
fans out protobuf QueryResponses, internal/private.proto:5-176;
http/client.go:44). A dense 1M-column Row is ~10MB as a JSON int list but
128KiB as a packed bitplane — and decoding a plane keeps the Row in its
device-plane representation end to end, so the coordinator's reduce step
never re-packs column lists.

Body layout (little-endian):
    <I header_len> <header JSON> <blob bytes>

The header is the small type-tagged structure (valcounts, pairs, scalars
inline); Row results reference spans in the blob section:
    {"type": "row", "attrs": {...}, "segs": [[shard, form, off, len], ...]}
      form 0: uint64 local column ids (sparse segments)
      form 1: packed uint32 plane words, WORDS_PER_ROW of them (dense)

The form is chosen per segment by size: columns win below one-eighth
density (8 bytes/column vs 4 bytes/word).

The port's Rows hold int32 torch tensors: encoding reads them through
``.cpu()`` (bytes equal the JAX package's for the same results), and
decoding builds them on the device the caller names.
"""

from __future__ import annotations

import json
import struct
from typing import Any, List, Tuple

import numpy as np

from ..constants import WORDS_PER_ROW
from ..core.cache import Pair
from ..core.row import Row
from ..executor import ValCount
from ..ops import bitplane as bp

CONTENT_TYPE = "application/x-pilosa-remote"
MAGIC = b"PILr"

_FORM_COLUMNS = 0
_FORM_PLANE = 1


def is_wire(data: bytes) -> bool:
    return data[:4] == MAGIC


def encode_results(results: List[Any]) -> bytes:
    header: List[dict] = []
    blobs: List[bytes] = []
    off = 0

    def blob(data: bytes) -> Tuple[int, int]:
        nonlocal off
        blobs.append(data)
        start, off = off, off + len(data)
        return start, len(data)

    for r in results:
        if isinstance(r, Row):
            segs = []
            for shard in sorted(r.segments):
                words = np.ascontiguousarray(bp.to_numpy(r.segments[shard]))
                n = int(np.bitwise_count(words).sum())
                if n * 8 < words.nbytes:
                    data = bp.unpack_bits(words).astype("<u8").tobytes()
                    form = _FORM_COLUMNS
                else:
                    data = words.astype("<u4").tobytes()
                    form = _FORM_PLANE
                o, ln = blob(data)
                segs.append([int(shard), form, o, ln])
            header.append({"type": "row", "attrs": r.attrs or {}, "segs": segs})
        elif isinstance(r, ValCount):
            header.append({"type": "valcount", "value": r.val, "count": r.count})
        elif isinstance(r, list) and (not r or isinstance(r[0], Pair)):
            header.append({"type": "pairs", "pairs": [p.to_dict() for p in r]})
        elif isinstance(r, bool):
            header.append({"type": "bool", "value": r})
        elif isinstance(r, int):
            header.append({"type": "uint64", "value": int(r)})
        else:
            header.append({"type": "none", "value": None})

    head = json.dumps({"results": header}).encode()
    return MAGIC + struct.pack("<I", len(head)) + head + b"".join(blobs)


def decode_results(data: bytes, device="cpu") -> List[Any]:
    """Results from a wire body; Row segments land on `device` (the host
    unless the caller names another)."""
    if not is_wire(data):
        raise ValueError("not a pilosa remote-wire body")
    (head_len,) = struct.unpack_from("<I", data, 4)
    header = json.loads(data[8 : 8 + head_len])
    blob_base = 8 + head_len

    out: List[Any] = []
    for h in header["results"]:
        t = h.get("type")
        if t == "row":
            segments = {}
            for shard, form, o, ln in h.get("segs", []):
                # Bounds-check before slicing: a corrupt offset would
                # otherwise wrap (negative) or silently truncate (past
                # the end) into a wrong-but-plausible column list.
                if (
                    not isinstance(o, int) or not isinstance(ln, int)
                    or isinstance(o, bool) or isinstance(ln, bool)
                    or o < 0 or ln < 0 or blob_base + o + ln > len(data)
                ):
                    raise ValueError(
                        f"bad blob span: off={o!r} len={ln!r} body={len(data)}"
                    )
                raw = data[blob_base + o : blob_base + o + ln]
                if form == _FORM_PLANE:
                    words = np.frombuffer(raw, dtype="<u4")
                    if len(words) != WORDS_PER_ROW:
                        raise ValueError(
                            f"bad plane segment: {len(words)} words"
                        )
                    segments[int(shard)] = bp.to_tensor(words, device)
                else:
                    cols = np.frombuffer(raw, dtype="<u8").astype(np.uint32)
                    segments[int(shard)] = bp.to_tensor(bp.pack_bits(cols), device)
            row = Row(segments)
            row.attrs = h.get("attrs", {})
            out.append(row)
        elif t == "valcount":
            out.append(ValCount(val=h["value"], count=h["count"]))
        elif t == "pairs":
            out.append(
                [Pair(id=p["id"], count=p["count"], key=p.get("key", ""))
                 for p in h["pairs"]]
            )
        elif t in ("bool", "uint64"):
            out.append(h["value"])
        else:
            out.append(None)
    return out
