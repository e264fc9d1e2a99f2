"""Bencoding codec (BEP 3) — the wire format of .torrent metainfo and
tracker responses.

The reference outsources all of BitTorrent to anacrolix/torrent
(torrent.go:10); this rebuild implements the protocol stack itself,
starting here. Strict by default: rejects trailing data, non-canonical
integers (leading zeros, ``-0``), and unsorted dict keys can be tolerated
on decode (real-world torrents sometimes missort) while encode always
produces canonical sorted output, so info-dict hashing is stable.
"""

from __future__ import annotations

from typing import Union

Bencodable = Union[int, bytes, str, list, dict]


class BencodeError(ValueError):
    pass


def encode(value: Bencodable) -> bytes:
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _encode(value: Bencodable, out: bytearray) -> None:
    if isinstance(value, bool):
        raise BencodeError("booleans are not bencodable")
    if isinstance(value, int):
        out += b"i%de" % value
    elif isinstance(value, (bytes, bytearray)):
        out += b"%d:" % len(value)
        out += value
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out += b"%d:" % len(raw)
        out += raw
    elif isinstance(value, list):
        out += b"l"
        for item in value:
            _encode(item, out)
        out += b"e"
    elif isinstance(value, dict):
        out += b"d"
        encoded_keys = sorted(
            (k.encode("utf-8") if isinstance(k, str) else bytes(k), v)
            for k, v in value.items()
        )
        for key, item in encoded_keys:
            _encode(key, out)
            _encode(item, out)
        out += b"e"
    else:
        raise BencodeError(f"cannot bencode {type(value).__name__}")


MAX_DEPTH = 100  # bound recursion so hostile input raises BencodeError,
# never RecursionError (which would escape callers' error contracts)


def decode(data: bytes) -> Bencodable:
    value, pos = _decode(data, 0)
    if pos != len(data):
        raise BencodeError(f"trailing data at offset {pos}")
    return value


def _decode(data: bytes, pos: int, depth: int = 0) -> tuple[Bencodable, int]:
    if depth > MAX_DEPTH:
        raise BencodeError(f"nesting deeper than {MAX_DEPTH}")
    if pos >= len(data):
        raise BencodeError("truncated")
    lead = data[pos : pos + 1]
    if lead == b"i":
        end = data.find(b"e", pos)
        if end < 0:
            raise BencodeError("unterminated integer")
        raw = data[pos + 1 : end]
        digits = raw[1:] if raw.startswith(b"-") else raw
        if not digits.isdigit():
            raise BencodeError(f"invalid integer {raw!r}")
        if digits != b"0" and digits.startswith(b"0") or raw == b"-0":
            raise BencodeError(f"non-canonical integer {raw!r}")
        return int(raw), end + 1
    if lead == b"l":
        items = []
        pos += 1
        while data[pos : pos + 1] != b"e":
            item, pos = _decode(data, pos, depth + 1)
            items.append(item)
        return items, pos + 1
    if lead == b"d":
        result: dict[bytes, Bencodable] = {}
        pos += 1
        while data[pos : pos + 1] != b"e":
            key, pos = _decode(data, pos, depth + 1)
            if not isinstance(key, bytes):
                raise BencodeError("dict key must be a byte string")
            value, pos = _decode(data, pos, depth + 1)
            result[key] = value
        return result, pos + 1
    if lead.isdigit():
        colon = data.find(b":", pos)
        if colon < 0:
            raise BencodeError("unterminated string length")
        length_raw = data[pos:colon]
        if not length_raw.isdigit():
            raise BencodeError(f"invalid string length {length_raw!r}")
        if length_raw != b"0" and length_raw.startswith(b"0"):
            raise BencodeError("non-canonical string length")
        length = int(length_raw)
        start = colon + 1
        if start + length > len(data):
            raise BencodeError("truncated string")
        return data[start : start + length], start + length
    raise BencodeError(f"unexpected byte {lead!r} at offset {pos}")
