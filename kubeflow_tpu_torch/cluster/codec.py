"""Compact binary wire codec for the JSON object model: the apiserver's
``Accept``/``Content-Type``-negotiated alternative to JSON.

The port's copy of ``kubeflow_tpu/cluster/codec.py``, byte for byte on
the wire (tests/test_torch_wire_codec.py decodes each package's bytes
with the other's). The codec keeps the JSON data model exactly
(``decode(encode(x)) == x`` for anything ``json.dumps`` accepts) and
encodes it as a tagged token stream with string interning:

- a static intern table of the common Kubernetes key and value strings,
  shared by encoder and decoder (a change to it is a wire-protocol
  change: bump ``BINARY_CONTENT_TYPE``);
- per-message interning: the first occurrence of any other string is
  sent inline and appended to the table, later ones are a back-reference;
- LEB128 varint lengths and counts, zigzag varint ints;
- a one-byte envelope that DEFLATE-compresses a large token stream when
  that is smaller.

Every message stands alone (the dynamic table resets per message), so
cached frame encodings decode independently and in any order. Malformed
input raises ``CodecError`` (a ``ValueError``), never a partial value.

A watch stream frames each event as ``u32 total-length (big-endian) |
u8 type-length | type (ascii) | object payload``, the payload being the
cached ``encode()`` output spliced in without re-encoding.
"""

from __future__ import annotations

import struct
import zlib

#: negotiated media type for request/response bodies and watch streams;
#: the version tag is the compatibility contract for the static table
BINARY_CONTENT_TYPE = "application/vnd.ktpu.v1+binary"
#: merge-patch flavor (the apiserver's PATCH handler keys on the
#: "merge-patch" substring, mirroring application/merge-patch+json)
BINARY_PATCH_CONTENT_TYPE = "application/merge-patch+vnd.ktpu.v1.binary"

# token tags
_T_NULL = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03      # zigzag LEB128
_T_FLOAT = 0x04    # 8-byte IEEE-754 big-endian
_T_STR = 0x05      # varint byte length + UTF-8; appends to intern table
_T_STRREF = 0x06   # varint intern-table index
_T_LIST = 0x07     # varint count + items
_T_DICT = 0x08     # varint count + (key, value) pairs

# envelope flags (first byte of every encoded message)
_ENV_RAW = 0x00
_ENV_DEFLATE = 0x01

#: compress only when the token stream is big enough for DEFLATE to
#: plausibly win (headers cost ~11 bytes; tiny objects stay raw)
_DEFLATE_THRESHOLD = 160

# The static intern table: common k8s key strings plus ubiquitous
# values. ORDER IS WIRE FORMAT — append-only; reordering or removing
# entries breaks decoding of peer-encoded messages.
STATIC_STRINGS = (
    "apiVersion", "kind", "metadata", "name", "namespace", "generateName",
    "labels", "annotations", "resourceVersion", "uid", "generation",
    "creationTimestamp", "deletionTimestamp", "finalizers",
    "ownerReferences", "controller", "blockOwnerDeletion", "spec",
    "status", "conditions", "type", "reason", "message",
    "lastTransitionTime", "replicas", "readyReplicas", "selector",
    "template", "containers", "image", "resources", "limits", "requests",
    "env", "value", "ports", "containerPort", "volumeMounts", "mountPath",
    "volumes", "serviceName", "items", "data", "v1", "apps/v1",
    "kubeflow.org/v1", "Notebook", "StatefulSet", "Service", "Pod",
    "ConfigMap", "Event", "Secret", "SlicePool", "True", "False",
    "Running", "Ready", "Pending", "default", "matchLabels",
    "notebook-name", "cpu", "memory", "phase",
)

_STATIC_INDEX = {s: i for i, s in enumerate(STATIC_STRINGS)}


class CodecError(ValueError):
    """Malformed or truncated binary payload (or an unencodable value).
    The HTTP client converts decode-side instances into a retryable
    transport error, mirroring json.JSONDecodeError handling."""


def _write_varint(buf: bytearray, n: int) -> None:
    while n > 0x7F:
        buf.append((n & 0x7F) | 0x80)
        n >>= 7
    buf.append(n)


def _encode_value(buf: bytearray, value, interned: dict[str, int]) -> None:
    if value is None:
        buf.append(_T_NULL)
    elif value is True:
        buf.append(_T_TRUE)
    elif value is False:
        buf.append(_T_FALSE)
    elif isinstance(value, int):
        buf.append(_T_INT)
        # zigzag: arbitrary-precision-safe form (no fixed-width shifts)
        _write_varint(buf, value * 2 if value >= 0 else -value * 2 - 1)
    elif isinstance(value, float):
        buf.append(_T_FLOAT)
        buf += struct.pack(">d", value)
    elif isinstance(value, str):
        idx = interned.get(value)
        if idx is not None:
            buf.append(_T_STRREF)
            _write_varint(buf, idx)
        else:
            raw = value.encode()
            buf.append(_T_STR)
            _write_varint(buf, len(raw))
            buf += raw
            interned[value] = len(interned)
    elif isinstance(value, (list, tuple)):
        buf.append(_T_LIST)
        _write_varint(buf, len(value))
        for item in value:
            _encode_value(buf, item, interned)
    elif isinstance(value, dict):
        buf.append(_T_DICT)
        _write_varint(buf, len(value))
        for k, v in value.items():
            if not isinstance(k, str):
                raise CodecError(f"non-string dict key {k!r}")
            _encode_value(buf, k, interned)
            _encode_value(buf, v, interned)
    else:
        raise CodecError(f"unencodable type {type(value).__name__}")


def encode(value) -> bytes:
    """Encode one JSON-model value into a self-contained binary message."""
    buf = bytearray()
    _encode_value(buf, value, dict(_STATIC_INDEX))
    if len(buf) >= _DEFLATE_THRESHOLD:
        packed = zlib.compress(bytes(buf), 1)
        if len(packed) < len(buf):
            return b"%c%s" % (_ENV_DEFLATE, packed)
    return b"%c%s" % (_ENV_RAW, bytes(buf))


class _Reader:
    """Cursor over one message's token bytes with bounds checking —
    truncation at any point surfaces CodecError, never an IndexError
    or a silently short value."""

    __slots__ = ("data", "pos", "strings")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.strings = list(STATIC_STRINGS)

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise CodecError("truncated binary payload")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def varint(self) -> int:
        shift = 0
        out = 0
        while True:  # bounded: take() raises on truncation, 10-byte cap
            byte = self.take(1)[0]
            out |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return out
            shift += 7
            if shift > 2048:  # DoS guard, far above any real int
                raise CodecError("varint too long")

    def value(self):
        tag = self.take(1)[0]
        if tag == _T_NULL:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            z = self.varint()
            return (z >> 1) if not z & 1 else -((z + 1) >> 1)
        if tag == _T_FLOAT:
            return struct.unpack(">d", self.take(8))[0]
        if tag == _T_STR:
            try:
                s = self.take(self.varint()).decode()
            except UnicodeDecodeError as exc:
                raise CodecError(f"invalid UTF-8 in string: {exc}") from None
            self.strings.append(s)
            return s
        if tag == _T_STRREF:
            idx = self.varint()
            if idx >= len(self.strings):
                raise CodecError(f"string ref {idx} out of range")
            return self.strings[idx]
        if tag == _T_LIST:
            return [self.value() for _ in range(self.varint())]
        if tag == _T_DICT:
            out = {}
            for _ in range(self.varint()):
                key = self.value()
                if not isinstance(key, str):
                    raise CodecError(f"non-string dict key {key!r}")
                out[key] = self.value()
            return out
        raise CodecError(f"unknown tag 0x{tag:02x}")


def decode(data: bytes):
    """Decode one message produced by ``encode``. Raises CodecError on
    any malformed, truncated, or trailing-garbage input."""
    if not data:
        raise CodecError("empty binary payload")
    env = data[0]
    body = data[1:]
    if env == _ENV_DEFLATE:
        try:
            body = zlib.decompress(body)
        except zlib.error as exc:
            raise CodecError(f"bad deflate envelope: {exc}") from None
    elif env != _ENV_RAW:
        raise CodecError(f"unknown envelope 0x{env:02x}")
    reader = _Reader(body)
    out = reader.value()
    if reader.pos != len(body):
        raise CodecError(f"{len(body) - reader.pos} trailing bytes after "
                         f"value")
    return out


def frame_event(etype: str, obj_payload: bytes) -> bytes:
    """Splice one watch event around an already-encoded object payload
    (the serialize-once fan-out path): ``u32 length | u8 type-len |
    type | payload``."""
    type_raw = etype.encode()
    return struct.pack(">IB", 1 + len(type_raw) + len(obj_payload),
                       len(type_raw)) + type_raw + obj_payload


def parse_event(payload: bytes) -> tuple[str, object]:
    """Inverse of ``frame_event`` given the payload AFTER the u32 length
    prefix (the stream reader consumed it). Returns ``(type, object)``."""
    if not payload:
        raise CodecError("empty watch frame")
    tlen = payload[0]
    if 1 + tlen > len(payload):
        raise CodecError("truncated watch frame type")
    etype = payload[1:1 + tlen].decode("ascii", errors="replace")
    return etype, decode(payload[1 + tlen:])


def accepts_binary(header_value: str | None) -> bool:
    """Does an ``Accept``/``Content-Type`` header name the binary media
    type? Negotiation is exact-ish (parameters ignored); anything else
    stays on the JSON default/debug path."""
    if not header_value:
        return False
    return BINARY_CONTENT_TYPE in header_value or \
        "vnd.ktpu.v1.binary" in header_value
