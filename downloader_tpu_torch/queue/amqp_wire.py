"""AMQP 0-9-1 wire codec: frames, method arguments, field tables.

The reference speaks AMQP through streadway/amqp (go.mod:14); this module
implements the needed slice of the protocol from the spec so the rebuild
has its own wire client (amqp.py) and an in-process test server
(amqp_server.py). Covers: frame (de)framing, short/long strings, field
tables (the subset RabbitMQ emits that we care about), bits, and the
method ids for connection/channel/exchange/queue/basic classes.
"""

from __future__ import annotations

import socket
import struct

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"

FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_HEARTBEAT = 8
FRAME_END = 0xCE

# class ids
CLASS_CONNECTION = 10
CLASS_CHANNEL = 20
CLASS_EXCHANGE = 40
CLASS_QUEUE = 50
CLASS_BASIC = 60

# (class, method) ids
CONNECTION_START = (10, 10)
CONNECTION_START_OK = (10, 11)
CONNECTION_TUNE = (10, 30)
CONNECTION_TUNE_OK = (10, 31)
CONNECTION_OPEN = (10, 40)
CONNECTION_OPEN_OK = (10, 41)
CONNECTION_CLOSE = (10, 50)
CONNECTION_CLOSE_OK = (10, 51)
CHANNEL_OPEN = (20, 10)
CHANNEL_OPEN_OK = (20, 11)
CHANNEL_CLOSE = (20, 40)
CHANNEL_CLOSE_OK = (20, 41)
EXCHANGE_DECLARE = (40, 10)
EXCHANGE_DECLARE_OK = (40, 11)
EXCHANGE_DELETE = (40, 20)
EXCHANGE_DELETE_OK = (40, 21)
QUEUE_DECLARE = (50, 10)
QUEUE_DECLARE_OK = (50, 11)
QUEUE_DELETE = (50, 40)
QUEUE_DELETE_OK = (50, 41)
QUEUE_BIND = (50, 20)
QUEUE_BIND_OK = (50, 21)
BASIC_QOS = (60, 10)
BASIC_QOS_OK = (60, 11)
BASIC_CONSUME = (60, 20)
BASIC_CONSUME_OK = (60, 21)
BASIC_PUBLISH = (60, 40)
BASIC_DELIVER = (60, 60)
BASIC_ACK = (60, 80)
BASIC_NACK = (60, 120)
CONFIRM_SELECT = (85, 10)
CONFIRM_SELECT_OK = (85, 11)


class AmqpWireError(Exception):
    pass


# ---------------------------------------------------------------------------
# primitive encoding


class Writer:
    def __init__(self):
        self._parts = bytearray()
        self._bits: list[bool] = []

    def _flush_bits(self) -> None:
        if self._bits:
            octet = 0
            for index, bit in enumerate(self._bits):
                if bit:
                    octet |= 1 << index
            self._parts.append(octet)
            self._bits = []

    def octet(self, value: int) -> "Writer":
        self._flush_bits()
        self._parts += struct.pack(">B", value)
        return self

    def short(self, value: int) -> "Writer":
        self._flush_bits()
        self._parts += struct.pack(">H", value)
        return self

    def long(self, value: int) -> "Writer":
        self._flush_bits()
        self._parts += struct.pack(">I", value)
        return self

    def longlong(self, value: int) -> "Writer":
        self._flush_bits()
        self._parts += struct.pack(">Q", value)
        return self

    def bit(self, value: bool) -> "Writer":
        if len(self._bits) == 8:
            self._flush_bits()
        self._bits.append(bool(value))
        return self

    def shortstr(self, value: str) -> "Writer":
        self._flush_bits()
        raw = value.encode("utf-8")
        if len(raw) > 255:
            raise AmqpWireError("shortstr too long")
        self._parts += struct.pack(">B", len(raw)) + raw
        return self

    def longstr(self, value: bytes) -> "Writer":
        self._flush_bits()
        self._parts += struct.pack(">I", len(value)) + value
        return self

    def table(self, value: dict) -> "Writer":
        self._flush_bits()
        self._parts += encode_table(value)
        return self

    def done(self) -> bytes:
        self._flush_bits()
        return bytes(self._parts)


def encode_table(table: dict) -> bytes:
    body = bytearray()
    for key, value in table.items():
        raw_key = key.encode("utf-8") if isinstance(key, str) else key
        body += struct.pack(">B", len(raw_key)) + raw_key
        body += _encode_field_value(value)
    return struct.pack(">I", len(body)) + bytes(body)


def _encode_field_value(value) -> bytes:
    if isinstance(value, bool):
        return b"t" + struct.pack(">B", int(value))
    if isinstance(value, int):
        if -(1 << 31) <= value < 1 << 31:
            return b"I" + struct.pack(">i", value)
        return b"l" + struct.pack(">q", value)
    if isinstance(value, float):
        return b"d" + struct.pack(">d", value)
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return b"S" + struct.pack(">I", len(raw)) + raw
    if isinstance(value, bytes):
        return b"S" + struct.pack(">I", len(value)) + value
    if isinstance(value, dict):
        return b"F" + encode_table(value)
    if value is None:
        return b"V"
    raise AmqpWireError(f"cannot encode field value of type {type(value).__name__}")


class Reader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self._bit_octet: int | None = None
        self._bit_index = 0

    def _take(self, count: int) -> bytes:
        if self._pos + count > len(self._data):
            raise AmqpWireError("truncated method arguments")
        chunk = self._data[self._pos : self._pos + count]
        self._pos += count
        return chunk

    def octet(self) -> int:
        self._bit_octet = None
        return self._take(1)[0]

    def short(self) -> int:
        self._bit_octet = None
        return struct.unpack(">H", self._take(2))[0]

    def long(self) -> int:
        self._bit_octet = None
        return struct.unpack(">I", self._take(4))[0]

    def longlong(self) -> int:
        self._bit_octet = None
        return struct.unpack(">Q", self._take(8))[0]

    def bit(self) -> bool:
        if self._bit_octet is None or self._bit_index == 8:
            self._bit_octet = self._take(1)[0]
            self._bit_index = 0
        value = bool(self._bit_octet & (1 << self._bit_index))
        self._bit_index += 1
        return value

    def shortstr(self) -> str:
        self._bit_octet = None
        length = self._take(1)[0]
        return self._take(length).decode("utf-8")

    def longstr(self) -> bytes:
        self._bit_octet = None
        length = struct.unpack(">I", self._take(4))[0]
        return self._take(length)

    def table(self) -> dict:
        self._bit_octet = None
        length = struct.unpack(">I", self._take(4))[0]
        raw = self._take(length)
        return _decode_table_body(raw)


def _decode_table_body(raw: bytes) -> dict:
    result: dict = {}
    pos = 0
    while pos < len(raw):
        key_len = raw[pos]
        pos += 1
        key = raw[pos : pos + key_len].decode("utf-8")
        pos += key_len
        value, pos = _decode_field_value(raw, pos)
        result[key] = value
    return result


def _decode_field_value(raw: bytes, pos: int):
    tag = raw[pos : pos + 1]
    pos += 1
    if tag == b"t":
        return bool(raw[pos]), pos + 1
    if tag == b"b":
        return struct.unpack(">b", raw[pos : pos + 1])[0], pos + 1
    if tag == b"B":
        return raw[pos], pos + 1
    if tag in (b"U", b"s"):
        return struct.unpack(">h", raw[pos : pos + 2])[0], pos + 2
    if tag == b"u":
        return struct.unpack(">H", raw[pos : pos + 2])[0], pos + 2
    if tag == b"I":
        return struct.unpack(">i", raw[pos : pos + 4])[0], pos + 4
    if tag == b"i":
        return struct.unpack(">I", raw[pos : pos + 4])[0], pos + 4
    if tag in (b"L", b"l"):
        return struct.unpack(">q", raw[pos : pos + 8])[0], pos + 8
    if tag == b"f":
        return struct.unpack(">f", raw[pos : pos + 4])[0], pos + 4
    if tag == b"d":
        return struct.unpack(">d", raw[pos : pos + 8])[0], pos + 8
    if tag == b"D":  # decimal: scale octet + long
        scale = raw[pos]
        value = struct.unpack(">i", raw[pos + 1 : pos + 5])[0]
        return value / (10**scale), pos + 5
    if tag == b"S":
        length = struct.unpack(">I", raw[pos : pos + 4])[0]
        return raw[pos + 4 : pos + 4 + length].decode("utf-8", "replace"), pos + 4 + length
    if tag == b"x":
        length = struct.unpack(">I", raw[pos : pos + 4])[0]
        return raw[pos + 4 : pos + 4 + length], pos + 4 + length
    if tag == b"A":
        length = struct.unpack(">I", raw[pos : pos + 4])[0]
        end = pos + 4 + length
        pos += 4
        items = []
        while pos < end:
            item, pos = _decode_field_value(raw, pos)
            items.append(item)
        return items, pos
    if tag == b"T":
        return struct.unpack(">Q", raw[pos : pos + 8])[0], pos + 8
    if tag == b"F":
        length = struct.unpack(">I", raw[pos : pos + 4])[0]
        return _decode_table_body(raw[pos + 4 : pos + 4 + length]), pos + 4 + length
    if tag == b"V":
        return None, pos
    raise AmqpWireError(f"unknown field table type {tag!r}")


# ---------------------------------------------------------------------------
# framing


def write_frame(sock: socket.socket, frame_type: int, channel: int, payload: bytes) -> None:  # deadline: a sendall parked by broker flow control is healthy (streadway semantics); the heartbeat monitor closes the socket of a dead peer, waking it
    frame = (
        struct.pack(">BHI", frame_type, channel, len(payload))
        + payload
        + bytes([FRAME_END])
    )
    sock.sendall(frame)  # analysis: ignore[no-blocking-under-lock] callers hold the dedicated _write_lock whose whole job is serializing this send; the heartbeat monitor tears down a wedged peer's socket, waking the holder


def write_method(
    sock: socket.socket, channel: int, method: tuple[int, int], args: bytes
) -> None:
    payload = struct.pack(">HH", *method) + args
    write_frame(sock, FRAME_METHOD, channel, payload)


def _recv_exact(sock: socket.socket, count: int) -> bytes:  # deadline: the connection's heartbeat monitor tears down idle/dead sockets (kernel keepalives back it up), raising OSError in any blocked read
    data = bytearray()
    while len(data) < count:
        chunk = sock.recv(count - len(data))
        if not chunk:
            raise AmqpWireError("connection closed by peer")
        data += chunk
    return bytes(data)


def read_frame(sock: socket.socket) -> tuple[int, int, bytes]:
    """Read one frame; returns (type, channel, payload)."""
    header = _recv_exact(sock, 7)
    frame_type, channel, size = struct.unpack(">BHI", header)
    if size > 128 * 1024 * 1024:
        raise AmqpWireError(f"frame too large: {size}")
    payload = _recv_exact(sock, size) if size else b""
    end = _recv_exact(sock, 1)
    if end[0] != FRAME_END:
        raise AmqpWireError(f"bad frame end octet 0x{end[0]:02x}")
    return frame_type, channel, payload


def parse_method(payload: bytes) -> tuple[tuple[int, int], Reader]:
    if len(payload) < 4:
        raise AmqpWireError("method frame too short")
    class_id, method_id = struct.unpack(">HH", payload[:4])
    return (class_id, method_id), Reader(payload[4:])


# content header property flags (basic class), high bit first
PROP_CONTENT_TYPE = 1 << 15
PROP_CONTENT_ENCODING = 1 << 14
PROP_HEADERS = 1 << 13
PROP_DELIVERY_MODE = 1 << 12
PROP_PRIORITY = 1 << 11


def encode_content_header(
    body_size: int,
    content_type: str = "application/octet-stream",
    headers: dict | None = None,
    delivery_mode: int = 2,
) -> bytes:
    flags = PROP_CONTENT_TYPE | PROP_DELIVERY_MODE
    writer = Writer()
    if headers:
        flags |= PROP_HEADERS
    writer.short(CLASS_BASIC).short(0)
    writer.longlong(body_size)
    writer.short(flags)
    writer.shortstr(content_type)
    if headers:
        writer.table(headers)
    writer.octet(delivery_mode)
    return writer.done()


def decode_content_header(payload: bytes) -> tuple[int, dict]:
    """Returns (body_size, properties dict with content_type/headers/
    delivery_mode when present)."""
    reader = Reader(payload)
    class_id = reader.short()
    reader.short()  # weight
    body_size = reader.longlong()
    flags = reader.short()
    props: dict = {"class_id": class_id}
    if flags & PROP_CONTENT_TYPE:
        props["content_type"] = reader.shortstr()
    if flags & PROP_CONTENT_ENCODING:
        props["content_encoding"] = reader.shortstr()
    if flags & PROP_HEADERS:
        props["headers"] = reader.table()
    if flags & PROP_DELIVERY_MODE:
        props["delivery_mode"] = reader.octet()
    if flags & PROP_PRIORITY:
        props["priority"] = reader.octet()
    return body_size, props
