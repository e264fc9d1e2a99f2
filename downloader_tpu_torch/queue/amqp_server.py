"""In-process AMQP 0-9-1 server stub for integration tests and demos.

Speaks the same protocol slice as the client (amqp.py) over real TCP
sockets and bridges every operation onto a MemoryBroker, so the full
QueueClient → AmqpConnection → TCP → server → broker path is testable
hermetically — including outage simulation (``drop_clients``) and PLAIN
auth verification. The reference has no integration test against its
broker at all (SURVEY.md §4: "multi-node behavior ... is untested").
"""

from __future__ import annotations

import math
import socket
import socketserver
import struct
import threading
import time

from ..utils import get_logger
from . import amqp_wire as wire
from .broker import BrokerError, Message
from .memory import MemoryBroker

log = get_logger("queue.amqp_server")


class AmqpServerStub:
    def __init__(
        self,
        broker: MemoryBroker | None = None,
        username: str = "",
        password: str = "",
        heartbeat: float = 0.0,
    ):
        """``heartbeat`` is the interval the stub proposes during tune
        (0 = heartbeats off). Sub-second values
        keep their precision for the stub's local timers even though the
        wire field is whole seconds, so tests can run fast."""
        self.broker = broker or MemoryBroker()
        self.username = username
        self.password = password
        self.heartbeat = heartbeat
        self.connections_accepted = 0
        # loss-window simulation: route confirm-mode publishes normally
        # but never send the basic.ack, so wire clients waiting on a
        # confirm see the timeout/teardown path
        self.hold_confirm_acks = False
        # slow-broker simulation: acks are sent, but this many seconds
        # late (off the session loop, so publish RECEIPT stays fast —
        # only the confirm is slow, as with a loaded real broker)
        self.confirm_ack_delay = 0.0
        stub = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    _ClientSession(stub, self.request).run()
                except (wire.AmqpWireError, OSError, struct.error):
                    pass

        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._sessions: list[_ClientSession] = []
        self._lock = threading.Lock()

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "AmqpServerStub":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.drop_clients()
        self._server.shutdown()
        self._server.server_close()

    def drop_clients(self) -> None:
        """Kill all client connections (simulated broker restart);
        unacked messages requeue via the memory broker."""
        with self._lock:
            sessions, self._sessions = list(self._sessions), []
        for session in sessions:
            session.kill()

    def mute(self) -> None:
        """Simulate a wedged-but-open broker: every session keeps its TCP
        socket open but stops sending bytes (heartbeats included). A
        heartbeat-negotiating client must detect this in ~2×interval;
        without heartbeats it would hang on kernel keepalives (60s+)."""
        with self._lock:
            for session in self._sessions:
                session._muted = True

    def __enter__(self) -> "AmqpServerStub":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _register(self, session: "_ClientSession") -> None:
        with self._lock:
            self._sessions.append(session)
            self.connections_accepted += 1


class _ClientSession:
    def __init__(self, stub: AmqpServerStub, sock: socket.socket):
        self._stub = stub
        self._sock = sock
        self._write_lock = threading.Lock()
        self._mem = stub.broker.connect()
        self._channels: dict[int, object] = {}  # number -> MemoryChannel
        self._consumer_tags = 0
        self._alive = True
        self._muted = False
        self._heartbeat = 0.0  # outbound send pacing after tune-ok
        self._heartbeat_deadline = 0.0  # client idle limit (2x wire value)
        self._last_recv = time.monotonic()
        self._confirm_seq: dict[int, int] = {}  # channel -> publish seq

    # -- plumbing --------------------------------------------------------

    def _send_method(self, channel: int, method: tuple[int, int], args: bytes):
        if self._muted:
            return
        with self._write_lock:
            wire.write_method(self._sock, channel, method, args)

    def kill(self) -> None:
        self._alive = False
        try:
            # shutdown (not just close) so threads blocked in recv on either
            # side wake up with EOF immediately
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._mem.close()

    # -- handshake + main loop -------------------------------------------

    def run(self) -> None:
        header = self._recv_exact(8)
        if header != wire.PROTOCOL_HEADER:
            # deadline: test-stub session; kill()/stop() close the socket, unblocking any parked write
            self._sock.sendall(wire.PROTOCOL_HEADER)  # version rejection
            return
        start = (
            wire.Writer()
            .octet(0)
            .octet(9)
            .table({"product": "downloader_tpu-stub"})
            .longstr(b"PLAIN")
            .longstr(b"en_US")
            .done()
        )
        self._send_method(0, wire.CONNECTION_START, start)

        method, reader = self._read_method()
        if method != wire.CONNECTION_START_OK:
            return
        reader.table()
        mechanism = reader.shortstr()
        response = reader.longstr()
        if self._stub.username:
            parts = response.split(b"\x00")
            if (
                mechanism != "PLAIN"
                or len(parts) != 3
                or parts[1].decode() != self._stub.username
                or parts[2].decode() != self._stub.password
            ):
                close = (
                    wire.Writer()
                    .short(403)
                    .shortstr("ACCESS_REFUSED - bad credentials")
                    .short(0)
                    .short(0)
                    .done()
                )
                self._send_method(0, wire.CONNECTION_CLOSE, close)
                return

        proposed = math.ceil(self._stub.heartbeat) if self._stub.heartbeat > 0 else 0
        tune = wire.Writer().short(2047).long(131072).short(proposed).done()
        self._send_method(0, wire.CONNECTION_TUNE, tune)
        method, reader = self._read_method()
        if method != wire.CONNECTION_TUNE_OK:
            return
        reader.short()  # channel-max
        reader.long()  # frame-max
        # the client's tune-ok heartbeat is authoritative (AMQP 0-9-1);
        # keep the stub's sub-second precision when it is the smaller
        tuned = reader.short()
        if tuned > 0 and self._stub.heartbeat > 0:
            # send pacing may run sub-second (faster than obligated is
            # safe); the kill deadline honors the wire value the client
            # agreed to — it only promises a frame every tuned/2
            self._heartbeat = min(float(tuned), self._stub.heartbeat)
            self._heartbeat_deadline = 2.0 * tuned
        method, _ = self._read_method()
        if method != wire.CONNECTION_OPEN:
            return
        self._send_method(0, wire.CONNECTION_OPEN_OK, wire.Writer().shortstr("").done())

        self._stub._register(self)
        if self._heartbeat > 0:
            threading.Thread(
                target=self._heartbeat_loop, daemon=True
            ).start()
        try:
            self._loop()
        finally:
            self._mem.close()

    def _heartbeat_loop(self) -> None:
        """Mirror of the client's monitor: emit a heartbeat every
        interval/2, kill the session when the client goes silent for two
        intervals (so the stub also exercises the client's outbound
        heartbeats — a client that stopped sending would be disconnected
        by real RabbitMQ exactly this way)."""
        interval = self._heartbeat
        while self._alive:
            time.sleep(interval / 2)
            if not self._alive:
                return
            if time.monotonic() - self._last_recv > self._heartbeat_deadline:
                log.info("client heartbeat timeout; dropping session")
                self.kill()
                return
            if self._muted:
                continue
            try:
                with self._write_lock:
                    wire.write_frame(self._sock, wire.FRAME_HEARTBEAT, 0, b"")
            except Exception as exc:
                # broad: ANY escaped exception would end heartbeating
                # silently, and real RabbitMQ would then drop the
                # (healthy-looking) session on the client's schedule
                if not isinstance(exc, OSError):
                    log.warning(f"heartbeat write failed: {exc}")
                self.kill()
                return

    def _recv_exact(self, count: int) -> bytes:  # deadline: test-stub session; the stub's heartbeat loop kills wedged sessions and kill()/stop() close the socket
        data = bytearray()
        while len(data) < count:
            chunk = self._sock.recv(count - len(data))
            if not chunk:
                raise OSError("client disconnected")
            data += chunk
        return bytes(data)

    def _read_method(self):
        while True:
            frame_type, channel, payload = wire.read_frame(self._sock)
            self._last_recv = time.monotonic()
            if frame_type == wire.FRAME_HEARTBEAT:
                continue
            if frame_type == wire.FRAME_METHOD:
                return wire.parse_method(payload)

    def _loop(self) -> None:
        pending_publish = None  # (channel_num, exchange, rk, body_size, props, chunks)
        while self._alive:
            frame_type, channel_num, payload = wire.read_frame(self._sock)
            self._last_recv = time.monotonic()
            if frame_type == wire.FRAME_HEARTBEAT:
                continue
            if frame_type == wire.FRAME_HEADER and pending_publish:
                body_size, props = wire.decode_content_header(payload)
                pending_publish[3] = body_size
                pending_publish[4] = props
                if body_size == 0:
                    self._finish_publish(pending_publish)
                    pending_publish = None
                continue
            if frame_type == wire.FRAME_BODY and pending_publish:
                pending_publish[5].append(payload)
                if sum(len(c) for c in pending_publish[5]) >= pending_publish[3]:
                    self._finish_publish(pending_publish)
                    pending_publish = None
                continue
            if frame_type != wire.FRAME_METHOD:
                continue
            method, reader = wire.parse_method(payload)

            if method == wire.CONNECTION_CLOSE:
                self._send_method(0, wire.CONNECTION_CLOSE_OK, b"")
                return
            if method == wire.CHANNEL_OPEN:
                self._channels[channel_num] = self._mem.channel()
                self._send_method(
                    channel_num, wire.CHANNEL_OPEN_OK, wire.Writer().longstr(b"").done()
                )
                continue

            channel = self._channels.get(channel_num)
            if channel is None:
                continue

            if method == wire.CHANNEL_CLOSE:
                channel.close()
                self._send_method(channel_num, wire.CHANNEL_CLOSE_OK, b"")
            elif method == wire.EXCHANGE_DECLARE:
                reader.short()
                name = reader.shortstr()
                channel.declare_exchange(name)
                self._send_method(channel_num, wire.EXCHANGE_DECLARE_OK, b"")
            elif method == wire.QUEUE_DECLARE:
                reader.short()
                name = reader.shortstr()
                channel.declare_queue(name)
                ok = wire.Writer().shortstr(name).long(0).long(0).done()
                self._send_method(channel_num, wire.QUEUE_DECLARE_OK, ok)
            elif method == wire.QUEUE_BIND:
                reader.short()
                queue = reader.shortstr()
                exchange = reader.shortstr()
                routing_key = reader.shortstr()
                try:
                    channel.bind_queue(queue, exchange, routing_key)
                except BrokerError as exc:
                    self._close_channel_with_error(channel_num, 404, str(exc))
                    continue
                self._send_method(channel_num, wire.QUEUE_BIND_OK, b"")
            elif method == wire.QUEUE_DELETE:
                reader.short()
                name = reader.shortstr()
                dropped = channel.delete_queue(name)
                ok = wire.Writer().long(dropped).done()
                self._send_method(channel_num, wire.QUEUE_DELETE_OK, ok)
            elif method == wire.EXCHANGE_DELETE:
                reader.short()
                name = reader.shortstr()
                channel.delete_exchange(name)
                self._send_method(channel_num, wire.EXCHANGE_DELETE_OK, b"")
            elif method == wire.BASIC_QOS:
                reader.long()
                channel.set_prefetch(reader.short())
                self._send_method(channel_num, wire.BASIC_QOS_OK, b"")
            elif method == wire.BASIC_CONSUME:
                reader.short()
                queue = reader.shortstr()
                requested_tag = reader.shortstr()
                self._consumer_tags += 1
                tag = requested_tag or f"stub-ctag-{self._consumer_tags}"
                try:
                    channel.consume(
                        queue,
                        lambda message, t=tag, cn=channel_num: self._deliver(
                            cn, t, message
                        ),
                    )
                except BrokerError as exc:
                    self._close_channel_with_error(channel_num, 404, str(exc))
                    continue
                ok = wire.Writer().shortstr(tag).done()
                self._send_method(channel_num, wire.BASIC_CONSUME_OK, ok)
            elif method == wire.BASIC_PUBLISH:
                reader.short()
                exchange = reader.shortstr()
                routing_key = reader.shortstr()
                pending_publish = [channel_num, exchange, routing_key, 0, {}, []]
            elif method == wire.BASIC_ACK:
                tag = reader.longlong()
                multiple = reader.bit()
                channel.ack(tag, multiple=multiple)
            elif method == wire.BASIC_NACK:
                tag = reader.longlong()
                reader.bit()  # multiple
                requeue = reader.bit()
                channel.nack(tag, requeue=requeue)
            elif method == wire.CONFIRM_SELECT:
                self._confirm_seq[channel_num] = 0
                self._send_method(channel_num, wire.CONFIRM_SELECT_OK, b"")

    def _finish_publish(self, pending) -> None:
        channel_num, exchange, routing_key, _, props, chunks = pending
        channel = self._channels.get(channel_num)
        if channel is None:
            return
        try:
            channel.publish(
                exchange,
                routing_key,
                b"".join(chunks),
                headers=props.get("headers", {}),
            )
        except BrokerError as exc:
            self._close_channel_with_error(channel_num, 404, str(exc))
            return
        if channel_num in self._confirm_seq:
            self._confirm_seq[channel_num] += 1
            if not self._stub.hold_confirm_acks:
                seq = self._confirm_seq[channel_num]

                def send_ack(seq=seq):
                    ack = (
                        wire.Writer()
                        .longlong(seq)
                        .bit(False)  # multiple
                        .done()
                    )
                    try:
                        self._send_method(channel_num, wire.BASIC_ACK, ack)
                    except OSError:
                        pass  # session died while the ack was pending

                delay = self._stub.confirm_ack_delay
                if delay > 0:
                    # Timer thread, not an inline sleep: sleeping here
                    # would stall the session loop and serialize publish
                    # RECEIPT, hiding exactly the client-side overlap
                    # the slow-ack tests exist to measure
                    threading.Timer(delay, send_ack).start()
                else:
                    send_ack()

    def _close_channel_with_error(self, channel_num: int, code: int, text: str):
        args = (
            wire.Writer().short(code).shortstr(text[:250]).short(0).short(0).done()
        )
        self._send_method(channel_num, wire.CHANNEL_CLOSE, args)
        channel = self._channels.pop(channel_num, None)
        if channel is not None:
            channel.close()

    def _deliver(self, channel_num: int, consumer_tag: str, message: Message) -> None:
        if not self._alive or self._muted:
            return
        args = (
            wire.Writer()
            .shortstr(consumer_tag)
            .longlong(message.delivery_tag)
            .bit(message.redelivered)
            .shortstr(message.exchange)
            .shortstr(message.routing_key)
            .done()
        )
        header = wire.encode_content_header(
            len(message.body), headers=message.headers or None
        )
        try:
            with self._write_lock:
                wire.write_method(self._sock, channel_num, wire.BASIC_DELIVER, args)
                wire.write_frame(self._sock, wire.FRAME_HEADER, channel_num, header)
                for start in range(0, len(message.body), 65536):
                    wire.write_frame(
                        self._sock,
                        wire.FRAME_BODY,
                        channel_num,
                        message.body[start : start + 65536],
                    )
                if not message.body:
                    pass
        except OSError:
            self.kill()
