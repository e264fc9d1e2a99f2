"""Minimal proto3 wire-format codec (encode/decode primitives).

The reference's job contract is protobuf: it unmarshals ``api.Download``
from message bodies and marshals ``api.Convert`` (cmd/downloader/
downloader.go:106,141) using gogo/protobuf against types from the external
dep ``tritonmedia/tritonmedia.go v1.0.2`` (go.mod:15). That dep is not
vendored in the reference tree, so this rebuild defines its own schema
(proto/tritonmedia.proto) and implements the proto3 wire format directly —
no generated code, no protoc/runtime version skew.

Wire types implemented: 0 (varint), 1 (fixed64), 2 (length-delimited),
5 (fixed32). Groups (3/4) are rejected. Unknown fields are skipped, which
keeps decoding forward-compatible the way protobuf requires.
"""

from __future__ import annotations

from typing import Iterator, Tuple

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LEN = 2
WIRETYPE_FIXED32 = 5


class WireError(ValueError):
    """Raised on malformed wire data."""


def encode_varint(value: int) -> bytes:
    if not -(1 << 63) <= value < 1 << 64:
        raise WireError(f"varint out of 64-bit range: {value}")
    if value < 0:
        # proto encodes negative int as 10-byte two's complement varint
        value += 1 << 64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            if result >= 1 << 64:
                raise WireError("varint overflows 64 bits")
            return result, pos
        shift += 7
        if shift >= 64:
            raise WireError("varint too long")


def encode_tag(field_number: int, wire_type: int) -> bytes:
    if field_number < 1:
        raise WireError(f"invalid field number {field_number}")
    return encode_varint((field_number << 3) | wire_type)


def encode_string(field_number: int, value: str) -> bytes:
    """Length-delimited string field; proto3 omits empty scalar fields."""
    if not value:
        return b""
    raw = value.encode("utf-8")
    return encode_tag(field_number, WIRETYPE_LEN) + encode_varint(len(raw)) + raw


def encode_bytes(field_number: int, value: bytes) -> bytes:
    if not value:
        return b""
    return encode_tag(field_number, WIRETYPE_LEN) + encode_varint(len(value)) + value


def encode_submessage(field_number: int, encoded: bytes | None) -> bytes:
    """Submessage fields are emitted even when empty (presence matters)."""
    if encoded is None:
        return b""
    return encode_tag(field_number, WIRETYPE_LEN) + encode_varint(len(encoded)) + encoded


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) triples.

    value is int for varint/fixed types and bytes for length-delimited.
    """
    pos = 0
    while pos < len(buf):
        key, pos = decode_varint(buf, pos)
        field_number, wire_type = key >> 3, key & 0x07
        if field_number == 0:
            raise WireError("field number 0 is illegal")
        if wire_type == WIRETYPE_VARINT:
            value, pos = decode_varint(buf, pos)
        elif wire_type == WIRETYPE_FIXED64:
            if pos + 8 > len(buf):
                raise WireError("truncated fixed64")
            value = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire_type == WIRETYPE_LEN:
            length, pos = decode_varint(buf, pos)
            if pos + length > len(buf):
                raise WireError("truncated length-delimited field")
            value = buf[pos : pos + length]
            pos += length
        elif wire_type == WIRETYPE_FIXED32:
            if pos + 4 > len(buf):
                raise WireError("truncated fixed32")
            value = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wire_type}")
        yield field_number, wire_type, value


def expect_len(wire_type: int, value: object) -> bytes:
    """Validate that a field carries length-delimited data and return it."""
    if wire_type != WIRETYPE_LEN or not isinstance(value, bytes):
        raise WireError(f"expected length-delimited field, got wire type {wire_type}")
    return value


def expect_string(wire_type: int, value: object) -> str:
    """Validate a length-delimited UTF-8 string field and return it decoded.

    Invalid UTF-8 is a wire error (proto3 string fields must be valid
    UTF-8), so callers only ever need to catch WireError for bad input.
    """
    raw = expect_len(wire_type, value)
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as exc:
        raise WireError(f"invalid UTF-8 in string field: {exc}") from exc
