"""The port's wire contract and queue layer against the JAX package's.

- Protobuf: ``Media``, ``Download`` and ``Convert`` over seeded random
  fields (empty strings, non-ASCII, a missing ``media``) encode to the
  same bytes, decode the same with unknown fields mixed in, and fuzzed
  inputs either decode the same or raise ``WireError`` in both.
- AMQP framing: the golden corpus (``tests/data/rabbitmq_session.bin``,
  the server side of a RabbitMQ-shaped session) parses to the same frames,
  tables and content headers, the writers give the same bytes, and a
  client replaying the session sends the same bytes from either package.
- AMQP across packages, both ways: the port's client against the
  reference's ``AmqpServerStub`` and the reference's client against the
  port's.
- ``MemoryBroker``: one seeded script of publishes, consumes, acks, nacks,
  prefetch changes and channel closes gives the same deliveries.
- ``delivery``: the same retry headers, DLQ names and shed headers.
"""

import json
import os
import random
import socket
import threading
import time

import numpy as np
import pytest

from test_torch_analysis import torch_lock_order_guard  # noqa: F401  (module guards)
from downloader_tpu.queue import amqp as ref_amqp
from downloader_tpu.queue import amqp_server as ref_amqp_server
from downloader_tpu.queue import amqp_wire as ref_amqp_wire
from downloader_tpu.queue import delivery as ref_delivery
from downloader_tpu.queue import memory as ref_memory
from downloader_tpu.queue.broker import Message as RefMessage
from downloader_tpu.utils import tracing as ref_tracing
from downloader_tpu import wire as ref_wire
from downloader_tpu_torch.queue import amqp, amqp_server, amqp_wire, delivery, memory
from downloader_tpu_torch.queue.broker import Message
from downloader_tpu_torch.utils import tracing
from downloader_tpu_torch import wire

DATA = os.path.join(os.path.dirname(__file__), "data")
TIMEOUT = 10.0
PORT = {"wire": wire, "amqp": amqp, "server": amqp_server, "delivery": delivery,
        "memory": memory, "message": Message, "tracing": tracing}
REF = {"wire": ref_wire, "amqp": ref_amqp, "server": ref_amqp_server,
       "delivery": ref_delivery, "memory": ref_memory, "message": RefMessage,
       "tracing": ref_tracing}


def wait_for(predicate, timeout=TIMEOUT, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# -- protobuf -----------------------------------------------------------------

ALPHABET = "abcXYZ019 -_./:?=&%" + "é𝕩ファイル\u0000"


def _text(rng):
    size = int(rng.integers(0, 40))
    return "".join(ALPHABET[int(i)] for i in rng.integers(0, len(ALPHABET), size))


def _messages(pkg, rng):
    w = pkg["wire"]
    draws = rng.integers(0, 4, 3)
    media = w.Media(id=_text(rng), source_uri=_text(rng))
    return (
        media,
        w.Download(media=None if draws[0] == 0 else media),
        w.Convert(created_at=_text(rng), media=None if draws[1] == 0 else media),
    )


def _unknown_fields(rng):
    """Fields 3..60 of every wire type the decoder skips, encoded with the
    reference's encoder."""
    pw = ref_wire.protowire
    out = b""
    for _ in range(int(rng.integers(0, 4))):
        number = int(rng.integers(3, 61))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            out += pw.encode_tag(number, pw.WIRETYPE_VARINT) + pw.encode_varint(
                int(rng.integers(0, 2**62)))
        elif kind == 1:
            out += pw.encode_tag(number, pw.WIRETYPE_FIXED64) + rng.bytes(8)
        elif kind == 2:
            out += pw.encode_bytes(number, rng.bytes(int(rng.integers(0, 9))))
        else:
            out += pw.encode_tag(number, pw.WIRETYPE_FIXED32) + rng.bytes(4)
    return out


def _decoded(message):
    """A decoded message as plain values (the two packages' dataclasses
    never compare equal to each other)."""
    if message is None:
        return None
    return {k: _decoded(v) if hasattr(v, "marshal") else v for k, v in vars(message).items()}


@pytest.mark.parametrize("seed", range(4))
def test_protobuf_encodings_are_byte_equal(seed):
    rng_port, rng_ref = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(100):
        port_msgs, ref_msgs = _messages(PORT, rng_port), _messages(REF, rng_ref)
        extra = _unknown_fields(rng_port)
        _unknown_fields(rng_ref)
        for port_msg, ref_msg in zip(port_msgs, ref_msgs):
            encoded = port_msg.marshal()
            assert encoded == ref_msg.marshal()
            for buf in (encoded, extra + encoded, encoded + extra):
                port_back = type(port_msg).unmarshal(buf)
                ref_back = type(ref_msg).unmarshal(buf)
                assert _decoded(port_back) == _decoded(ref_back) == _decoded(ref_msg)


@pytest.mark.parametrize("name", ["Media", "Download", "Convert"])
def test_fuzzed_decode_errors_are_wire_errors(name):
    rng = random.Random(name)
    valid = getattr(ref_wire, name)
    seeds = [b"", valid().marshal(), ref_wire.Download(
        media=ref_wire.Media(id="x", source_uri="http://h/a.mkv")).marshal()]
    failures = 0
    for trial in range(600):
        if trial % 2:
            buf = rng.randbytes(rng.randrange(0, 48))
        else:
            base = bytearray(rng.choice(seeds) or b"\x0a\x03abc")
            for _ in range(rng.randrange(1, 4)):
                base[rng.randrange(len(base))] = rng.randrange(256)
            buf = bytes(base[: rng.randrange(len(base) + 1)])
        outcome = []
        for pkg in (PORT, REF):
            try:
                outcome.append(("ok", _decoded(getattr(pkg["wire"], name).unmarshal(buf))))
            except pkg["wire"].WireError as exc:
                outcome.append(("error", str(exc)))
        assert outcome[0] == outcome[1], buf
        failures += outcome[0][0] == "error"
    assert failures > 100


# -- the golden AMQP corpus ---------------------------------------------------

def _corpus():
    with open(os.path.join(DATA, "rabbitmq_session.bin"), "rb") as source:
        blob = source.read()
    with open(os.path.join(DATA, "rabbitmq_session.json")) as source:
        steps = json.load(source)["steps"]
    return blob, steps


def _frames(frames_module, blob):
    """Every frame of ``blob`` through the package's own socket reader."""
    left, right = socket.socketpair()
    left.settimeout(TIMEOUT)
    right.settimeout(TIMEOUT)
    frames = []
    try:
        writer = threading.Thread(target=lambda: (right.sendall(blob), right.shutdown(socket.SHUT_WR)))
        writer.start()
        read = 0
        while read < len(blob):
            frame_type, channel, payload = frames_module.read_frame(left)
            frames.append((frame_type, channel, payload))
            read += 8 + len(payload)
        writer.join(TIMEOUT)
    finally:
        left.close()
        right.close()
    return frames


def _written(frames_module, frames):
    left, right = socket.socketpair()
    right.settimeout(TIMEOUT)
    out = b""
    try:
        for frame_type, channel, payload in frames:
            frames_module.write_frame(left, frame_type, channel, payload)
            want = 8 + len(payload)
            chunk = b""
            while len(chunk) < want:
                chunk += right.recv(want - len(chunk))
            out += chunk
    finally:
        left.close()
        right.close()
    return out


def _parsed(frames_module, frames):
    """Method ids and their argument bytes, decoded content headers, and
    connection.start's server-properties table."""
    parsed = []
    for frame_type, channel, payload in frames:
        if frame_type == 1:
            method, reader = frames_module.parse_method(payload)
            entry = ["method", channel, method]
            if method == (10, 10):
                entry += [reader.octet(), reader.octet(), reader.table(), reader.longstr(),
                          reader.longstr()]
            parsed.append(entry)
        elif frame_type == 2:
            parsed.append(["header", channel, frames_module.decode_content_header(payload)])
        else:
            parsed.append(["other", frame_type, channel, payload])
    return parsed


def test_golden_corpus_parses_to_the_same_frames_and_writes_the_same_bytes():
    blob, _ = _corpus()
    port_frames, ref_frames = _frames(amqp_wire, blob), _frames(ref_amqp_wire, blob)
    assert port_frames == ref_frames
    assert len(port_frames) >= 10
    kinds = {frame_type for frame_type, _, _ in port_frames}
    assert {1, 2, 3, 8} <= kinds  # methods, content headers, bodies, a heartbeat
    port_parsed = _parsed(amqp_wire, port_frames)
    assert port_parsed == _parsed(ref_amqp_wire, ref_frames)
    start = port_parsed[0]
    assert start[2] == (10, 10) and start[5]["product"] == "RabbitMQ"
    # the writers give the corpus back byte for byte
    assert _written(amqp_wire, port_frames) == _written(ref_amqp_wire, ref_frames) == blob
    # re-encoding what was decoded gives the same bytes in both packages,
    # or the same refusal (the writers encode no arrays)
    headers = [entry[2] for entry in port_parsed if entry[0] == "header"]
    assert headers
    for size, properties in headers:
        outcomes = []
        for frames_module in (amqp_wire, ref_amqp_wire):
            try:
                outcomes.append(frames_module.encode_content_header(
                    size, properties.get("content_type", ""), properties.get("headers"),
                    properties.get("delivery_mode", 1)))
            except frames_module.AmqpWireError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
    assert amqp_wire.encode_table(start[5]) == ref_amqp_wire.encode_table(start[5])


def _replay(steps, blob, listener, received):
    """The server side of the corpus session: wait for each client method
    the manifest names, then send the next scripted chunk. Every byte the
    client sends lands in ``received``."""
    sock, _ = listener.accept()
    sock.settimeout(TIMEOUT)

    def take(count):
        got = b""
        while len(got) < count:
            chunk = sock.recv(count - len(got))
            if not chunk:
                raise EOFError
            got += chunk
        received.append(got)
        return got

    try:
        for step in steps:
            if step["await"] == "protocol-header":
                take(8)
            else:
                while True:
                    head = take(7)
                    size = int.from_bytes(head[3:7], "big")
                    payload = take(size + 1)
                    if head[0] == 1 and tuple(
                        int.from_bytes(payload[i:i + 2], "big") for i in (0, 2)
                    ) == tuple(step["await"]):
                        break
            offset, length = step["chunk"]
            sock.sendall(blob[offset:offset + length])
    except (OSError, EOFError):
        pass
    finally:
        sock.close()


def _session(pkg, steps, blob):
    listener = socket.create_server(("127.0.0.1", 0))
    received = []
    server = threading.Thread(target=_replay, args=(steps, blob, listener, received))
    server.start()
    conn = pkg["amqp"].AmqpConnection.dial(
        f"127.0.0.1:{listener.getsockname()[1]}", username="guest", password="guest",
        heartbeat=30,
    )
    messages = []
    try:
        channel = conn.channel()
        channel.confirm_select()
        channel.declare_exchange("dt.golden.x")
        channel.declare_queue("dt-golden-q")
        channel.bind_queue("dt-golden-q", "dt.golden.x", "golden.k")
        channel.consume("dt-golden-q", messages.append)
        assert wait_for(lambda: len(messages) == 2)
        channel.publish("dt.golden.x", "golden.k", b"confirm-me")
        channel.ack(1)
        channel.ack(2)
        properties = conn.server_properties
        heartbeat = conn.negotiated_heartbeat
    finally:
        conn.close()
        server.join(TIMEOUT)
        listener.close()
    return {
        "client_bytes": b"".join(received),
        "messages": [(m.body, m.delivery_tag, m.redelivered, m.exchange, m.routing_key,
                      m.headers) for m in messages],
        "server_properties": properties,
        "heartbeat": heartbeat,
    }


def test_golden_session_replay_sends_the_same_bytes():
    blob, steps = _corpus()
    port, ref = (_session(pkg, steps, blob) for pkg in (PORT, REF))
    assert port == ref
    assert port["heartbeat"] == 30 and port["messages"][1][2] is True
    assert port["client_bytes"].startswith(b"AMQP\x00\x00\x09\x01")


# -- AMQP across packages -----------------------------------------------------

HEADERS = {"X-Retries": 2, "X-Tenant": "acme", "flag": True, "big": 1 << 40,
           "nested": {"k": "v", "n": None}, "neg": -5, "ratio": 0.25}


@pytest.mark.parametrize("client,server", [(PORT, REF), (REF, PORT)],
                         ids=["port-client", "port-server"])
def test_amqp_across_packages(client, server):
    with server["server"].AmqpServerStub(username="u", password="p") as stub:
        conn = client["amqp"].AmqpConnection.dial(stub.endpoint, username="u", password="p")
        try:
            channel = conn.channel()
            channel.confirm_select()
            channel.declare_exchange("v1.download")
            channel.declare_queue("v1.download-0")
            channel.bind_queue("v1.download-0", "v1.download", "v1.download-0")
            channel.set_prefetch(2)
            bodies = [b"", b"\xce" * 7, os.urandom(300_000)]  # empty, sentinel, multi-frame
            for body in bodies:
                channel.publish("v1.download", "v1.download-0", body, headers=HEADERS)
            assert wait_for(lambda: stub.broker.queue_depth("v1.download-0") == 3)
            got = []
            channel.consume("v1.download-0", got.append)
            assert wait_for(lambda: len(got) == 2)  # the prefetch window
            time.sleep(0.05)
            assert len(got) == 2
            channel.nack(got[0].delivery_tag, requeue=True)
            channel.ack(got[1].delivery_tag)
            assert wait_for(lambda: len(got) == 4)
            channel.ack(got[2].delivery_tag)
            channel.ack(got[3].delivery_tag)
            assert wait_for(lambda: not channel.unacked_tags())
            assert sorted(m.body for m in got[1:]) == sorted(bodies)
            assert got[0].body == bodies[0] and not got[0].redelivered
            redelivered = [m for m in got[2:] if m.body == bodies[0]]
            assert len(redelivered) == 1 and redelivered[0].redelivered
            for message in got:
                assert message.headers == HEADERS
                assert (message.exchange, message.routing_key) == ("v1.download",
                                                                    "v1.download-0")
            assert stub.broker.queue_depth("v1.download-0") == 0
        finally:
            conn.close()


# -- the memory broker --------------------------------------------------------

def _broker_script(pkg, seed):
    """A seeded script against one package's MemoryBroker; returns every
    delivery each consumer saw and the queue depths after each step."""
    rng = random.Random(seed)
    broker = pkg["memory"].MemoryBroker()
    admin = broker.connect().channel()
    for queue in ("q-0", "q-1"):
        admin.declare_exchange("topic")
        admin.declare_queue(queue)
        admin.bind_queue(queue, "topic", queue)
    log = []
    channels = []

    def open_consumer(queue, prefetch):
        channel = broker.connect().channel()
        channel.set_prefetch(prefetch)
        index = len(channels)
        held = []
        channel.consume(queue, lambda m: (log.append(
            ("deliver", index, m.delivery_tag, m.body, m.redelivered, m.routing_key,
             dict(m.headers))), held.append(m.delivery_tag)))
        channels.append((channel, held))

    open_consumer("q-0", 2)
    open_consumer("q-1", 1)
    for step in range(300):
        op = rng.randrange(10)
        live = [(i, c, h) for i, (c, h) in enumerate(channels) if c is not None]
        if op <= 3:
            queue = rng.choice(("q-0", "q-1"))
            admin.publish("topic", queue, f"m{step}".encode(), headers={"step": step})
        elif op <= 5 and live:
            index, channel, held = rng.choice(live)
            if held:
                tag = held.pop(rng.randrange(len(held)))
                channel.ack(tag)
        elif op == 6 and live:
            index, channel, held = rng.choice(live)
            if held:
                tag = held.pop(rng.randrange(len(held)))
                channel.nack(tag, requeue=rng.random() < 0.7)
        elif op == 7 and live:
            index, channel, held = rng.choice(live)
            channel.set_prefetch(rng.randrange(1, 4))
        elif op == 8 and live and len(live) > 1:
            index, channel, held = rng.choice(live)
            channel.close()  # its unacked deliveries go back to their queue
            channels[index] = (None, [])
        else:
            open_consumer(rng.choice(("q-0", "q-1")), rng.randrange(1, 4))
        log.append(("depth", step, broker.queue_depth("q-0"), broker.queue_depth("q-1")))
    return log


@pytest.mark.parametrize("seed", range(3))
def test_memory_broker_script_matches_reference(seed):
    port, ref = _broker_script(PORT, seed), _broker_script(REF, seed)
    assert port == ref
    delivered = [entry for entry in port if entry[0] == "deliver"]
    assert len(delivered) > 50 and any(entry[4] for entry in delivered)


# -- delivery headers ---------------------------------------------------------

class _Channel:
    """A channel that records what a delivery does with it."""

    def __init__(self):
        self.calls = []

    def publish(self, exchange, routing_key, body, headers=None):
        self.calls.append(("publish", exchange, routing_key, body, dict(headers or {})))

    def ack(self, tag, multiple=False):
        self.calls.append(("ack", tag, multiple))

    def nack(self, tag, requeue):
        self.calls.append(("nack", tag, requeue))

    def unacked_tags(self):
        return [1, 2, 3, 5]


CASES = [
    ("error", {}), ("error", {"X-Retries": 2}), ("error", {"X-Retries": "bad"}),
    ("shed", {}), ("shed", {"X-Shed-Count": 3, "X-Tenant": "t"}),
    ("shed", {"X-Shed-Count": 1, "X-Job-Class": "Interactive"}),
    ("nack", {}), ("ack", {"X-Mirrors": "http://a/x, http://b/x"}),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_delivery_settles_with_the_same_headers(case, monkeypatch):
    action, headers = CASES[case]
    results = []
    for pkg in (PORT, REF):
        # trace ids come from each package's PRNG: seed both alike
        monkeypatch.setattr(pkg["tracing"], "_rng", random.Random(7))
        channel = _Channel()
        message = pkg["message"](body=b"job", delivery_tag=5, exchange="v1.download",
                                 routing_key="v1.download-1", headers=dict(headers))
        settled = []
        item = pkg["delivery"].Delivery(message, channel, on_settled=settled.append)
        fields = (item.retries, item.shed_count, item.job_class, item.tenant, item.mirrors)
        if action == "error":
            item.error()
        elif action == "shed":
            outcome = item.shed(pkg["delivery"].dlq_name("v1.download"), "tenant-job-quota",
                                retry_after=12, max_sheds=2)
            fields += (outcome, item.shed("x", "again", 1))
        elif action == "nack":
            item.nack(requeue=True)
        else:
            item.ack()
        item.ack()  # settled once only
        results.append((fields, channel.calls, len(settled)))
    assert results[0] == results[1]
    assert results[0][2] == 1


def test_ack_batch_coalesces_the_same_way():
    results = []
    for pkg in (PORT, REF):
        channel = _Channel()
        batch = [pkg["delivery"].Delivery(
            pkg["message"](body=b"j", delivery_tag=tag, exchange="x", routing_key="x-0"),
            channel) for tag in (1, 2, 5)]
        frames = pkg["delivery"].ack_batch(batch)
        results.append((frames, channel.calls, pkg["delivery"].dlq_name("v1.download")))
    assert results[0] == results[1]
    assert results[0][0] == 2 and results[0][2] == "v1.download.dlq"


# -- publisher generations (twin of test_queue.py::TestPublisherGeneration) ---


def _own_publishers(client) -> list:
    """Live ``queue-publisher`` threads that run ``client``'s own publish
    loop: any other client's generations in the process, of either
    package, have the same name and are not counted."""
    return [
        thread for thread in threading.enumerate()
        if thread.name == "queue-publisher"
        # Thread keeps its target until run() returns
        and getattr(getattr(thread, "_target", None), "__self__", None) is client
    ]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_no_duplicate_publisher_threads_after_flapping(pkg):
    if pkg == "port":
        from downloader_tpu_torch.queue import MemoryBroker, QueueClient
        from downloader_tpu_torch.utils.cancel import CancelToken
    else:
        from downloader_tpu.queue import MemoryBroker, QueueClient
        from downloader_tpu.utils.cancel import CancelToken
    broker, token = MemoryBroker(), CancelToken()
    client = QueueClient(token, broker.connect, supervisor_interval=0.05, drain_timeout=1.0)
    try:
        client.consume("t")
        assert wait_for(lambda: len(_own_publishers(client)) == 1)
        for _ in range(5):
            broker.drop_connections()
            time.sleep(0.15)
        time.sleep(0.5)  # let stale generations notice and exit
        assert len(_own_publishers(client)) <= 1
        # and the surviving generation still publishes
        assert client.publish("t", b"after-flap", wait=5.0) is True
        assert len(_own_publishers(client)) == 1
    finally:
        token.cancel()
    assert wait_for(lambda: not _own_publishers(client))
