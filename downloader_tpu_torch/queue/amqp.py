"""AMQP 0-9-1 client implementing the broker Connection/Channel interface.

The rebuild's equivalent of streadway/amqp as used by the reference
(internal/rabbitmq/client.go): PLAIN auth from RABBITMQ_USERNAME/PASSWORD
(client.go:303-311), durable direct exchange declare (client.go:326-334),
durable queue declare + bind (client.go:337-357), per-channel qos
(client.go:360-373), persistent publishes (client.go:224), consume with
explicit ack/nack (delivery.go:55-63).

Design: one reader thread per connection dispatches incoming frames;
synchronous RPCs (declare, bind, qos, consume, close) block on per-channel
reply queues; deliveries are reassembled (method + content header + body
frames) and handed to a dispatch thread so consumer callbacks never block
the reader.

Heartbeats: a nonzero interval is negotiated during tune (the reference's
streadway dial does the same at client.go:303-322, 10s). A monitor thread
emits heartbeat frames every interval/2 and tears the connection down when
no inbound traffic (any frame counts) arrives for two full intervals —
so a half-open TCP connection or a wedged-but-open broker is detected in
~2×interval instead of waiting 60s+ on kernel keepalives. Either side
sending 0 during tune disables the mechanism (AMQP 0-9-1 §"tune";
RabbitMQ treats 0 as deactivation).
"""

from __future__ import annotations

import itertools
import math
import queue as queue_mod
import socket
import threading
import time
from typing import Callable

from ..utils import get_logger, profiling
from . import amqp_wire as wire
from .broker import BrokerError, Message

log = get_logger("queue.amqp")

DEFAULT_PORT = 5672
FRAME_MAX = 131072


class AmqpError(BrokerError):
    pass


class _ConfirmSlot:
    __slots__ = ("event", "ok")

    def __init__(self):
        self.event = threading.Event()
        self.ok: bool | None = None

    def resolve(self, ok: bool) -> None:
        self.ok = ok
        self.event.set()


class _PendingContent:
    __slots__ = ("method_reader", "body_size", "props", "chunks", "received")

    def __init__(self, method_reader: wire.Reader):
        self.method_reader = method_reader
        self.body_size = 0
        self.props: dict = {}
        self.chunks: list[bytes] = []
        self.received = 0


class AmqpChannel:
    def __init__(self, connection: "AmqpConnection", number: int):
        self._connection = connection
        self._number = number
        self._replies: "queue_mod.Queue[tuple]" = queue_mod.Queue()
        self._consumers: dict[str, Callable[[Message], None]] = {}
        self._pending: _PendingContent | None = None
        self.closed = False
        # publisher-confirm state (confirm.select): publish seq numbers
        # start at 1 after select; broker acks/nacks carry the seq as the
        # delivery tag, optionally with the `multiple` bit
        self._confirm_mode = False
        self._publish_seq = 0
        self._confirm_lock = threading.Lock()
        self._confirms: dict[int, "_ConfirmSlot"] = {}
        self.confirm_timeout = 30.0
        # consumer-side delivery tags not yet settled on this channel:
        # what a coalesced multiple-ack consults so it never reaches
        # past a delivery another worker still owns. Reader thread adds
        # (deliveries), worker threads remove (ack/nack) — locked.
        self._unacked_lock = threading.Lock()
        self._unacked: set[int] = set()  # guarded-by: _unacked_lock

    # -- RPC plumbing ----------------------------------------------------

    def _rpc(self, method: tuple[int, int], args: bytes, expect: tuple[int, int]):
        self._connection._send_method(self._number, method, args)
        return self._wait_for(expect)

    def _wait_for(self, expect: tuple[int, int]):
        while True:
            try:
                got, reader = self._replies.get(timeout=self._connection.rpc_timeout)
            except queue_mod.Empty:
                raise AmqpError(f"timed out waiting for {expect}") from None
            if got == ("error",):
                raise reader  # reader carries the exception
            if got == expect:
                return reader
            if got == wire.CHANNEL_CLOSE:
                code = reader.short()
                text = reader.shortstr()
                self.closed = True
                self._connection._send_method(
                    self._number, wire.CHANNEL_CLOSE_OK, b""
                )
                raise AmqpError(f"channel closed by server: {code} {text}")
            # unexpected interleave: ignore and keep waiting

    def _check(self) -> None:
        if self.closed or self._connection.is_closed():
            raise AmqpError("channel is closed")

    # -- Channel interface -----------------------------------------------

    def declare_exchange(self, name: str) -> None:
        self._check()
        args = (
            wire.Writer()
            .short(0)  # reserved (ticket)
            .shortstr(name)
            .shortstr("direct")
            .bit(False)  # passive
            .bit(True)  # durable (reference client.go:333)
            .bit(False)  # auto-delete
            .bit(False)  # internal
            .bit(False)  # no-wait
            .table({})
            .done()
        )
        self._rpc(wire.EXCHANGE_DECLARE, args, wire.EXCHANGE_DECLARE_OK)

    def declare_queue(self, name: str) -> None:
        self._check()
        args = (
            wire.Writer()
            .short(0)
            .shortstr(name)
            .bit(False)  # passive
            .bit(True)  # durable (reference client.go:349)
            .bit(False)  # exclusive
            .bit(False)  # auto-delete
            .bit(False)  # no-wait
            .table({})
            .done()
        )
        self._rpc(wire.QUEUE_DECLARE, args, wire.QUEUE_DECLARE_OK)

    def bind_queue(self, queue: str, exchange: str, routing_key: str) -> None:
        self._check()
        args = (
            wire.Writer()
            .short(0)
            .shortstr(queue)
            .shortstr(exchange)
            .shortstr(routing_key)
            .bit(False)  # no-wait
            .table({})
            .done()
        )
        self._rpc(wire.QUEUE_BIND, args, wire.QUEUE_BIND_OK)

    def delete_queue(self, name: str) -> None:
        """queue.delete (if-unused/if-empty false: delete regardless) —
        integration tests clean their per-run entities off shared
        brokers with this."""
        self._check()
        args = (
            wire.Writer()
            .short(0)
            .shortstr(name)
            .bit(False)  # if-unused
            .bit(False)  # if-empty
            .bit(False)  # no-wait
            .done()
        )
        self._rpc(wire.QUEUE_DELETE, args, wire.QUEUE_DELETE_OK)

    def delete_exchange(self, name: str) -> None:
        self._check()
        args = (
            wire.Writer()
            .short(0)
            .shortstr(name)
            .bit(False)  # if-unused
            .bit(False)  # no-wait
            .done()
        )
        self._rpc(wire.EXCHANGE_DELETE, args, wire.EXCHANGE_DELETE_OK)

    def set_prefetch(self, count: int) -> None:
        self._check()
        args = (
            wire.Writer().long(0).short(count).bit(False).done()
        )  # prefetch-size 0, global false
        self._rpc(wire.BASIC_QOS, args, wire.BASIC_QOS_OK)

    def confirm_select(self) -> None:
        """Enter publisher-confirm mode (RabbitMQ extension, class 85):
        after this, ``publish`` blocks until the broker acks the message
        and raises on nack/timeout/connection loss — the durable hand-off
        the reference's ack-after-write path lacks (delivery.go:73-84)."""
        self._check()
        self._rpc(wire.CONFIRM_SELECT, wire.Writer().bit(False).done(),
                  wire.CONFIRM_SELECT_OK)
        self._confirm_mode = True

    def publish(
        self,
        exchange: str,
        routing_key: str,
        body: bytes,
        headers: dict | None = None,
        persistent: bool = True,
    ) -> None:
        self._check()
        args = (
            wire.Writer()
            .short(0)
            .shortstr(exchange)
            .shortstr(routing_key)
            .bit(False)  # mandatory
            .bit(False)  # immediate
            .done()
        )
        header = wire.encode_content_header(
            len(body), headers=headers, delivery_mode=2 if persistent else 1
        )
        if not self._confirm_mode:
            self._connection._send_content(self._number, args, header, body)
            return
        # seq assignment must match socket-write order, so it happens
        # inside the connection write lock's critical section. The
        # confirm lock itself is only held for the dict update — never
        # across the (blocking) socket write — so the reader thread's
        # _resolve_confirms can always make progress even while a
        # publisher is wedged in sendall against a flow-controlled
        # broker (otherwise heartbeat reads would stall behind it and
        # the monitor would tear down a healthy connection).
        #
        # Design tradeoff (deliberate): the write lock serializes every
        # publisher on this CONNECTION for the duration of sendall, so
        # against a broker that stops reading, all channels' publishes
        # park behind the wedged one until its confirm timeout. The
        # confirm WAIT below happens outside the lock, so slow acks
        # (the common slow-broker case) do overlap across threads —
        # proven by test_amqp.py::test_concurrent_publish_confirm_waits
        # _overlap. With the QueueClient's one-publisher-thread shape
        # this never bites; give each publisher its own connection
        # before adding a second concurrent publisher channel.
        with self._connection._write_lock:
            with self._confirm_lock:
                self._publish_seq += 1
                seq = self._publish_seq
                slot = _ConfirmSlot()
                self._confirms[seq] = slot
            try:
                self._connection._send_content_locked(
                    self._number, args, header, body
                )
            except Exception:
                with self._confirm_lock:
                    self._confirms.pop(seq, None)
                raise
        if not slot.event.wait(self.confirm_timeout):
            with self._confirm_lock:
                self._confirms.pop(seq, None)
            raise AmqpError(
                f"publish confirm timed out after {self.confirm_timeout:g}s"
            )
        if not slot.ok:
            raise AmqpError("publish was not confirmed (nacked or connection lost)")

    def publish_many(
        self, entries: list, persistent: bool = True
    ) -> "list[Exception | None]":
        """Publish a batch of (exchange, routing_key, body, headers)
        with ONE confirm wait covering all of it: every body goes onto
        the socket back-to-back under the write lock, then the caller
        blocks once for the broker's acks (RabbitMQ typically answers
        a burst with a single ``multiple=True`` basic.ack). Returns a
        per-entry outcome (None = confirmed; an exception = that
        publish failed), so one failure fails exactly the affected
        publishes. Without confirm mode the sends alone are the
        outcome, as with ``publish``."""
        self._check()
        outcomes: "list[Exception | None]" = [None] * len(entries)
        if not self._confirm_mode:
            for i, (exchange, routing_key, body, headers) in enumerate(entries):
                try:
                    self.publish(
                        exchange, routing_key, body,
                        headers=headers, persistent=persistent,
                    )
                except (AmqpError, OSError) as exc:
                    outcomes[i] = exc
            return outcomes
        slots: "dict[int, _ConfirmSlot]" = {}
        with self._connection._write_lock:
            for i, (exchange, routing_key, body, headers) in enumerate(entries):
                args = (
                    wire.Writer()
                    .short(0)
                    .shortstr(exchange)
                    .shortstr(routing_key)
                    .bit(False)  # mandatory
                    .bit(False)  # immediate
                    .done()
                )
                header = wire.encode_content_header(
                    len(body), headers=headers,
                    delivery_mode=2 if persistent else 1,
                )
                with self._confirm_lock:
                    self._publish_seq += 1
                    seq = self._publish_seq
                    slot = _ConfirmSlot()
                    self._confirms[seq] = slot
                try:
                    self._connection._send_content_locked(
                        self._number, args, header, body
                    )
                except Exception as exc:
                    with self._confirm_lock:
                        self._confirms.pop(seq, None)
                    # the connection is torn down mid-batch: this entry
                    # and every unsent one fail with the send error;
                    # already-sent entries keep their slots (teardown
                    # resolves them as unconfirmed below)
                    for j in range(i, len(entries)):
                        outcomes[j] = exc
                    break
                slots[i] = slot
        deadline = time.monotonic() + self.confirm_timeout
        for i, slot in slots.items():
            remaining = deadline - time.monotonic()
            if remaining > 0:
                slot.event.wait(remaining)
            if slot.event.is_set():
                if not slot.ok:
                    outcomes[i] = AmqpError(
                        "publish was not confirmed "
                        "(nacked or connection lost)"
                    )
                continue
            with self._confirm_lock:
                # drop the slot so a late confirm can't resolve into
                # a dict entry nobody reads
                for seq, live in list(self._confirms.items()):
                    if live is slot:
                        self._confirms.pop(seq, None)
                        break
            outcomes[i] = AmqpError(
                f"publish confirm timed out after {self.confirm_timeout:g}s"
            )
        return outcomes

    def consume(self, queue: str, on_message: Callable[[Message], None]) -> str:
        self._check()
        # client-chosen consumer tag, registered BEFORE the RPC: the server
        # may deliver immediately after consume-ok, and a server-generated
        # tag would only be learnable after deliveries could already be in
        # flight (deliver-before-registration race)
        tag = f"dt-{self._number}-{len(self._consumers) + 1}"
        self._consumers[tag] = on_message
        args = (
            wire.Writer()
            .short(0)
            .shortstr(queue)
            .shortstr(tag)
            .bit(False)  # no-local
            .bit(False)  # no-ack: false → explicit acks
            .bit(False)  # exclusive
            .bit(False)  # no-wait
            .table({})
            .done()
        )
        try:
            self._rpc(wire.BASIC_CONSUME, args, wire.BASIC_CONSUME_OK)
        except Exception:
            self._consumers.pop(tag, None)
            raise
        return tag

    def ack(self, delivery_tag: int, multiple: bool = False) -> None:
        """``multiple=True`` acks every delivery up to ``delivery_tag``
        in one basic.ack frame (AMQP 0-9-1 §basic.ack) — one frame for
        a whole batch instead of one per message."""
        self._check()
        args = wire.Writer().longlong(delivery_tag).bit(multiple).done()
        self._connection._send_method(self._number, wire.BASIC_ACK, args)
        with self._unacked_lock:
            if multiple:
                self._unacked = {
                    t for t in self._unacked if t > delivery_tag
                }
            else:
                self._unacked.discard(delivery_tag)

    def unacked_tags(self) -> list[int]:
        """Delivery tags outstanding on this channel (see the batch
        settle in queue/delivery.py)."""
        with self._unacked_lock:
            return list(self._unacked)

    def nack(self, delivery_tag: int, requeue: bool) -> None:
        self._check()
        args = (
            wire.Writer().longlong(delivery_tag).bit(False).bit(requeue).done()
        )
        self._connection._send_method(self._number, wire.BASIC_NACK, args)
        with self._unacked_lock:
            self._unacked.discard(delivery_tag)

    def close(self) -> None:
        if self.closed or self._connection.is_closed():
            self.closed = True
            return
        self.closed = True
        try:
            args = wire.Writer().short(0).shortstr("").short(0).short(0).done()
            self._rpc(wire.CHANNEL_CLOSE, args, wire.CHANNEL_CLOSE_OK)
        except (AmqpError, OSError):
            pass

    # -- frame ingestion (reader thread) ---------------------------------

    def _handle_method(self, method: tuple[int, int], reader: wire.Reader) -> None:
        if method == wire.BASIC_DELIVER:
            self._pending = _PendingContent(reader)
            return
        if self._confirm_mode and method in (wire.BASIC_ACK, wire.BASIC_NACK):
            # in confirm mode these are broker->client confirms, not
            # consumer operations (which are client->server only)
            tag = reader.longlong()
            multiple = reader.bit()
            self._resolve_confirms(tag, multiple, ok=method == wire.BASIC_ACK)
            return
        if method == wire.CHANNEL_CLOSE and self._confirm_mode:
            # a publisher may be blocked waiting on a confirm that will
            # never come: fail it now instead of letting it ride out the
            # timeout, and mark the channel closed so the NEXT publish
            # fails fast instead of stalling on a server-closed channel.
            # An in-flight RPC (topology declare) learns of the close via
            # the error-tuple path it already understands; with no waiter
            # the entry sits in a dead channel's queue, harmless.
            code = reader.short()
            text = reader.shortstr()
            self.closed = True
            self._fail_confirms()
            try:
                self._connection._send_method(
                    self._number, wire.CHANNEL_CLOSE_OK, b""
                )
            except AmqpError:
                pass
            log.warning(f"publisher channel closed by server: {code} {text}")
            self._replies.put(
                (("error",), AmqpError(f"channel closed by server: {code} {text}"))
            )
            return
        self._replies.put((method, reader))

    def _resolve_confirms(self, tag: int, multiple: bool, ok: bool) -> None:
        with self._confirm_lock:
            if multiple:
                seqs = [s for s in self._confirms if s <= tag]
            else:
                seqs = [tag] if tag in self._confirms else []
            slots = [self._confirms.pop(s) for s in seqs]
        for slot in slots:
            slot.resolve(ok)

    def _fail_confirms(self) -> None:
        with self._confirm_lock:
            slots, self._confirms = list(self._confirms.values()), {}
        for slot in slots:
            slot.resolve(False)

    def _handle_content_header(self, payload: bytes) -> None:
        if self._pending is None:
            return
        self._pending.body_size, self._pending.props = wire.decode_content_header(
            payload
        )
        if self._pending.body_size == 0:
            self._finish_delivery()

    def _handle_body(self, payload: bytes) -> None:
        pending = self._pending
        if pending is None:
            return
        pending.chunks.append(payload)
        pending.received += len(payload)
        if pending.received >= pending.body_size:
            self._finish_delivery()

    def _finish_delivery(self) -> None:
        pending, self._pending = self._pending, None
        reader = pending.method_reader
        consumer_tag = reader.shortstr()
        delivery_tag = reader.longlong()
        redelivered = reader.bit()
        exchange = reader.shortstr()
        routing_key = reader.shortstr()
        message = Message(
            body=b"".join(pending.chunks),
            delivery_tag=delivery_tag,
            exchange=exchange,
            routing_key=routing_key,
            headers=pending.props.get("headers", {}),
            redelivered=redelivered,
        )
        callback = self._consumers.get(consumer_tag)
        if callback is not None:
            with self._unacked_lock:
                self._unacked.add(delivery_tag)
            self._connection._dispatch(callback, message)

    def _fail(self, exc: Exception) -> None:
        self.closed = True
        self._fail_confirms()
        self._replies.put((("error",), exc))


DEFAULT_HEARTBEAT = 10.0  # seconds; reference client.go:303-322


class AmqpConnection:
    def __init__(self, sock: socket.socket, rpc_timeout: float = 30.0):
        self._sock = sock
        self.rpc_timeout = rpc_timeout
        self._write_lock = threading.Lock()
        self._channels: dict[int, AmqpChannel] = {}
        self._channel_numbers = itertools.count(1)
        self._closed = threading.Event()
        self._channel0_replies: "queue_mod.Queue[tuple]" = queue_mod.Queue()
        self._dispatch_queue: "queue_mod.Queue" = queue_mod.Queue()
        self._frame_max = FRAME_MAX
        self._heartbeat = 0.0  # outbound send pacing; 0 = disabled
        self._heartbeat_deadline = 0.0  # inbound idle limit (2x wire value)
        self.server_properties: dict = {}  # connection.start field table
        self.negotiated_heartbeat = 0  # tune-ok wire seconds (0 = off)
        self._last_recv = time.monotonic()  # shared-by-design: monotonic idle clock; reader writes, heartbeat monitor reads — a torn read mis-times one deadline check and self-heals on the next frame

    # -- dial ------------------------------------------------------------

    @classmethod
    def dial(
        cls,
        endpoint: str,
        username: str = "",
        password: str = "",
        vhost: str = "/",
        timeout: float = 10.0,
        rpc_timeout: float = 30.0,
        heartbeat: float = DEFAULT_HEARTBEAT,
    ) -> "AmqpConnection":
        """Connect and perform the AMQP handshake. ``endpoint`` is
        ``host[:port]`` as in RABBITMQ_ENDPOINT (reference cmd:54-58).

        ``heartbeat`` is the requested interval in seconds (0 disables);
        the wire value is negotiated against the server's tune suggestion,
        and sub-second requests keep their precision locally (the wire
        field is integral seconds) so tests can run fast timers."""
        host, _, port_raw = endpoint.partition(":")
        port = int(port_raw) if port_raw else DEFAULT_PORT
        try:
            sock = socket.create_connection((host or "127.0.0.1", port), timeout)
        except OSError as exc:
            raise AmqpError(f"failed to dial {endpoint}: {exc}") from exc
        # kernel keepalives back up the protocol heartbeat: they catch a
        # dead peer even when heartbeats were negotiated off (server sent 0)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        if hasattr(socket, "TCP_KEEPIDLE"):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, 30)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, 10)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT, 3)
        sock.settimeout(timeout)
        conn = cls(sock, rpc_timeout=rpc_timeout)
        try:
            conn._handshake(username, password, vhost, heartbeat)
        except Exception:
            sock.close()
            raise
        sock.settimeout(None)
        # No send timeout on purpose: RabbitMQ flow control (memory/disk
        # alarm) deliberately stops reading from publishers while still
        # sending heartbeats — a blocked sendall there is a healthy
        # connection and must wait, like streadway does. A peer that is
        # truly dead also goes silent inbound, so the heartbeat monitor
        # (which never blocks on the write lock) tears down and closes
        # the socket, waking any sendall stuck behind a full buffer.
        conn._reader_thread = threading.Thread(  # thread-role: amqp-reader
            target=conn._read_loop, name="amqp-reader", daemon=True
        )
        conn._dispatcher_thread = threading.Thread(  # thread-role: amqp-dispatcher
            target=conn._dispatch_loop, name="amqp-dispatch", daemon=True
        )
        conn._reader_thread.start()
        conn._dispatcher_thread.start()
        profiling.ROLES.register_thread(conn._reader_thread, "amqp-reader")
        profiling.ROLES.register_thread(
            conn._dispatcher_thread, "amqp-dispatcher"
        )
        if conn._heartbeat > 0:
            # the handshake reads bypass _read_loop, so the idle clock
            # still holds its construction-time value; a slow handshake
            # must not count against the first deadline window
            conn._last_recv = time.monotonic()
            conn._heartbeat_thread = threading.Thread(  # thread-role: amqp-heartbeat
                target=conn._heartbeat_loop, name="amqp-heartbeat", daemon=True
            )
            conn._heartbeat_thread.start()
            profiling.ROLES.register_thread(
                conn._heartbeat_thread, "amqp-heartbeat"
            )
        return conn

    def _handshake(
        self, username: str, password: str, vhost: str, heartbeat: float
    ) -> None:
        self._sock.sendall(wire.PROTOCOL_HEADER)
        method, reader = self._read_method_sync()
        if method != wire.CONNECTION_START:
            raise AmqpError(f"expected connection.start, got {method}")
        # args: version-major, version-minor, server-properties, mechanisms, locales
        reader.octet(), reader.octet()
        # kept: a real RabbitMQ's server-properties exercises field-table
        # types the in-repo stub never emits (nested capabilities table
        # of booleans, longstrs, ...) — the opt-in integration test
        # asserts this decode against a live broker
        self.server_properties = reader.table()
        mechanisms = reader.longstr()
        if b"PLAIN" not in mechanisms:
            raise AmqpError(f"server offers no PLAIN auth: {mechanisms!r}")

        response = b"\x00" + username.encode() + b"\x00" + password.encode()
        start_ok = (
            wire.Writer()
            .table({"product": "downloader_tpu", "version": "0.1.0"})
            .shortstr("PLAIN")
            .longstr(response)
            .shortstr("en_US")
            .done()
        )
        wire.write_method(self._sock, 0, wire.CONNECTION_START_OK, start_ok)

        method, reader = self._read_method_sync()
        if method == wire.CONNECTION_CLOSE:
            code = reader.short()
            text = reader.shortstr()
            raise AmqpError(f"connection refused: {code} {text}")
        if method != wire.CONNECTION_TUNE:
            raise AmqpError(f"expected connection.tune, got {method}")
        channel_max = reader.short()
        frame_max = reader.long()
        server_heartbeat = reader.short()
        self._frame_max = min(frame_max or FRAME_MAX, FRAME_MAX)
        # 0 from either side deactivates heartbeats (RabbitMQ semantics);
        # otherwise take the smaller of the two intervals. The tune-ok
        # value is the authoritative whole-second wire interval; the local
        # monitor keeps sub-second precision from the requested value.
        if heartbeat <= 0 or server_heartbeat == 0:
            wire_heartbeat = 0
            self._heartbeat = 0.0
            self._heartbeat_deadline = 0.0
        else:
            wire_heartbeat = min(math.ceil(heartbeat), server_heartbeat)
            # outbound pacing may run faster than the wire value (sending
            # early is always safe, and lets tests use sub-second timers);
            # the inbound deadline MUST honor the wire value — the peer is
            # only obligated to send every wire/2, so expecting frames
            # faster would flap against a healthy spec-compliant broker
            self._heartbeat = min(heartbeat, float(wire_heartbeat))
            self._heartbeat_deadline = 2.0 * wire_heartbeat
        self.negotiated_heartbeat = wire_heartbeat
        tune_ok = (
            wire.Writer()
            .short(channel_max)
            .long(self._frame_max)
            .short(wire_heartbeat)
            .done()
        )
        wire.write_method(self._sock, 0, wire.CONNECTION_TUNE_OK, tune_ok)

        open_args = wire.Writer().shortstr(vhost).shortstr("").bit(False).done()
        wire.write_method(self._sock, 0, wire.CONNECTION_OPEN, open_args)
        method, _ = self._read_method_sync()
        if method != wire.CONNECTION_OPEN_OK:
            raise AmqpError(f"expected connection.open-ok, got {method}")

    def _read_method_sync(self) -> tuple[tuple[int, int], wire.Reader]:
        while True:
            frame_type, _, payload = wire.read_frame(self._sock)
            if frame_type == wire.FRAME_HEARTBEAT:
                continue
            if frame_type != wire.FRAME_METHOD:
                raise AmqpError(f"unexpected frame type {frame_type} in handshake")
            return wire.parse_method(payload)

    # -- outbound --------------------------------------------------------

    def _send_method(self, channel: int, method: tuple[int, int], args: bytes) -> None:
        try:
            with self._write_lock:
                wire.write_method(self._sock, channel, method, args)
        except OSError as exc:
            self._teardown(AmqpError(f"send failed: {exc}"))
            raise AmqpError(f"send failed: {exc}") from exc

    def _send_content(
        self, channel: int, publish_args: bytes, header: bytes, body: bytes
    ) -> None:
        with self._write_lock:
            self._send_content_locked(channel, publish_args, header, body)

    def _send_content_locked(
        self, channel: int, publish_args: bytes, header: bytes, body: bytes
    ) -> None:
        """Write the publish frames; caller must hold ``_write_lock``
        (confirm-mode publish holds it directly so the confirm seq number
        is assigned in socket-write order)."""
        max_body = self._frame_max - 8
        try:
            wire.write_method(self._sock, channel, wire.BASIC_PUBLISH, publish_args)
            wire.write_frame(self._sock, wire.FRAME_HEADER, channel, header)
            for start in range(0, len(body), max_body):
                wire.write_frame(
                    self._sock,
                    wire.FRAME_BODY,
                    channel,
                    body[start : start + max_body],
                )
        except OSError as exc:
            self._teardown(AmqpError(f"send failed: {exc}"))
            raise AmqpError(f"send failed: {exc}") from exc

    # -- inbound ---------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            while not self._closed.is_set():
                frame_type, channel_num, payload = wire.read_frame(self._sock)
                self._last_recv = time.monotonic()
                if frame_type == wire.FRAME_HEARTBEAT:
                    continue
                if channel_num == 0:
                    self._handle_channel0(frame_type, payload)
                    continue
                channel = self._channels.get(channel_num)
                if channel is None:
                    continue
                if frame_type == wire.FRAME_METHOD:
                    method, reader = wire.parse_method(payload)
                    channel._handle_method(method, reader)
                elif frame_type == wire.FRAME_HEADER:
                    channel._handle_content_header(payload)
                elif frame_type == wire.FRAME_BODY:
                    channel._handle_body(payload)
        except (wire.AmqpWireError, OSError) as exc:
            self._teardown(AmqpError(str(exc)))

    def _handle_channel0(self, frame_type: int, payload: bytes) -> None:
        if frame_type != wire.FRAME_METHOD:
            return
        method, reader = wire.parse_method(payload)
        if method == wire.CONNECTION_CLOSE:
            code = reader.short()
            text = reader.shortstr()
            try:
                with self._write_lock:
                    wire.write_method(self._sock, 0, wire.CONNECTION_CLOSE_OK, b"")
            except OSError:
                pass
            self._teardown(AmqpError(f"connection closed by server: {code} {text}"))
        else:
            self._channel0_replies.put((method, wire.Reader(b"")))

    def _heartbeat_loop(self) -> None:
        """Send a heartbeat every interval/2; declare the connection dead
        after two intervals with no inbound frames of any kind (the same
        rule streadway applies on the reference's dial path). Teardown
        wakes the blocked reader, fails in-flight RPCs, and lets the
        queue supervisor reconnect."""
        interval = self._heartbeat
        deadline = self._heartbeat_deadline
        while not self._closed.wait(interval / 2):
            # the idle check runs before (and independently of) the write
            # lock: a publisher blocked in sendall against a broker that
            # stopped reading holds the lock indefinitely, and the
            # teardown below is what un-wedges it
            idle = time.monotonic() - self._last_recv
            if idle > deadline:
                log.warning(
                    f"heartbeat timeout: no frames for {idle:.2f}s "
                    f"(limit {deadline:g}s); dropping connection"
                )
                self._teardown(
                    AmqpError(f"heartbeat timeout after {idle:.2f}s")
                )
                return
            if not self._write_lock.acquire(timeout=interval / 2):
                continue  # lock busy (possibly wedged); skip this beat
            try:
                wire.write_frame(self._sock, wire.FRAME_HEARTBEAT, 0, b"")
            except OSError as exc:
                self._teardown(AmqpError(f"heartbeat send failed: {exc}"))
                return
            finally:
                self._write_lock.release()

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            try:
                callback, message = self._dispatch_queue.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            try:
                callback(message)
            except Exception as exc:
                log.error("consumer callback failed", exc=exc)

    def _dispatch(self, callback, message) -> None:
        self._dispatch_queue.put((callback, message))

    def _teardown(self, exc: Exception) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for channel in list(self._channels.values()):
            channel._fail(exc)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # wake a blocked reader
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    # -- Connection interface --------------------------------------------

    def channel(self) -> AmqpChannel:
        if self.is_closed():
            raise AmqpError("connection is closed")
        number = next(self._channel_numbers)
        channel = AmqpChannel(self, number)
        self._channels[number] = channel
        args = wire.Writer().shortstr("").done()
        self._send_method(number, wire.CHANNEL_OPEN, args)
        channel._wait_for(wire.CHANNEL_OPEN_OK)
        return channel

    def is_closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        if self._closed.is_set():
            return
        try:
            args = wire.Writer().short(0).shortstr("").short(0).short(0).done()
            with self._write_lock:
                wire.write_method(self._sock, 0, wire.CONNECTION_CLOSE, args)
        except OSError:
            pass
        self._teardown(AmqpError("connection closed locally"))
