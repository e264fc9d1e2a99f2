"""In-memory broker with real at-least-once semantics.

A faithful stand-in for RabbitMQ at the Connection/Channel interface:
direct exchanges route by exact routing key to bound queues; consumed
messages stay unacked (and counted against prefetch) until acked; nack and
connection loss requeue them with the redelivered flag, exactly the
redelivery behavior the reference leans on for its crash-retry story
(SURVEY.md §5 "checkpoint/resume"). ``MemoryBroker.drop_connections()``
simulates a broker outage so supervisor/reconnect paths are testable — the
reference has no test double at all for this (SURVEY.md §4).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable

from ..utils import get_logger
from .broker import BrokerError, Message

log = get_logger("queue.memory")


class MemoryBroker:
    """The shared 'server' state; create connections with ``connect``."""

    def __init__(self):
        self._lock = threading.RLock()
        self._exchanges: dict[str, dict[str, set[str]]] = {}  # name -> rk -> queues
        self._queues: dict[str, deque] = {}
        self._consumers: dict[str, list["_Consumer"]] = {}
        self._connections: list[MemoryConnection] = []
        self._tag_counter = itertools.count(1)
        self.published: int = 0  # observability for tests/bench
        self.publish_log: list[tuple[str, str]] = []  # (exchange, routing_key)
        self._pump_state_lock = threading.Lock()
        self._pumping: set[int] = set()  # thread idents currently pumping
        self._pump_again: set[int] = set()
        # simulate a sustained outage: drop_connections() alone lets
        # clients reconnect on their next supervisor tick
        self.refuse_connections = False
        # async-confirm mode: while True, confirm-mode publishes are
        # STAGED (accepted off the "socket" but neither routed nor
        # confirmed) until release_confirms() — opening the same window a
        # real broker has between receiving a publish and acking it, so
        # the write-then-crash loss scenario is testable. A connection
        # that dies while its publish is staged never gets the confirm
        # and the staged message is discarded, exactly like a broker
        # crash before persistence.
        self.hold_confirms = False
        self._held: list[_HeldPublish] = []

    # -- wiring ----------------------------------------------------------

    def connect(self) -> "MemoryConnection":
        if self.refuse_connections:
            raise BrokerError("connection refused (simulated outage)")
        conn = MemoryConnection(self)
        with self._lock:
            self._connections.append(conn)
        return conn

    def drop_connections(self) -> None:
        """Simulate a broker outage: every connection dies, unacked
        messages return to their queues (as RabbitMQ does)."""
        with self._lock:
            connections = list(self._connections)
        for conn in connections:
            conn._die()

    # -- server-side ops (called via channels, under lock) ----------------

    def _declare_exchange(self, name: str) -> None:
        with self._lock:
            self._exchanges.setdefault(name, {})

    def _declare_queue(self, name: str) -> None:
        with self._lock:
            self._queues.setdefault(name, deque())

    def _bind(self, queue: str, exchange: str, routing_key: str) -> None:
        with self._lock:
            if exchange not in self._exchanges:
                raise BrokerError(f"no such exchange '{exchange}'")
            if queue not in self._queues:
                raise BrokerError(f"no such queue '{queue}'")
            self._exchanges[exchange].setdefault(routing_key, set()).add(queue)

    def delete_queue(self, name: str) -> int:
        """Drop a queue, its bindings, and its consumers; returns the
        message count discarded (RabbitMQ queue.delete-ok semantics)."""
        with self._lock:
            dropped = len(self._queues.pop(name, ()))
            self._consumers.pop(name, None)
            for bindings in self._exchanges.values():
                for queues in bindings.values():
                    queues.discard(name)
            return dropped

    def delete_exchange(self, name: str) -> None:
        with self._lock:
            self._exchanges.pop(name, None)

    def _publish(
        self, exchange: str, routing_key: str, body: bytes, headers: dict
    ) -> None:
        with self._lock:
            if exchange == "":
                # AMQP 0-9-1 default exchange: every queue is implicitly
                # bound by its own name; unroutable messages are dropped
                # (no `mandatory` support here), matching RabbitMQ
                targets = {routing_key} if routing_key in self._queues else set()
            elif exchange not in self._exchanges:
                raise BrokerError(f"no such exchange '{exchange}'")
            else:
                targets = self._exchanges[exchange].get(routing_key, set())
            for queue in targets:
                self._queues[queue].append(
                    (body, dict(headers), False, exchange, routing_key)
                )
            self.published += 1
            self.publish_log.append((exchange, routing_key))
        self._pump()

    def _requeue(
        self, queue: str, body: bytes, headers: dict, exchange: str, routing_key: str
    ) -> None:
        with self._lock:
            if queue in self._queues:
                self._queues[queue].appendleft(
                    (body, headers, True, exchange, routing_key)
                )
        self._pump()

    def _pump(self) -> None:
        """Deliver queued messages to consumers with prefetch headroom.

        Non-reentrant per thread: a callback that acks (triggering another
        pump) marks the outer pump to loop again instead of recursing, so
        inline-ack consumers can drain arbitrarily deep queues."""
        ident = threading.get_ident()
        with self._pump_state_lock:
            if ident in self._pumping:
                self._pump_again.add(ident)
                return
            self._pumping.add(ident)
        try:
            while True:
                self._pump_once()
                with self._pump_state_lock:
                    if ident not in self._pump_again:
                        return
                    self._pump_again.discard(ident)
        finally:
            with self._pump_state_lock:
                self._pumping.discard(ident)
                self._pump_again.discard(ident)

    def _pump_once(self) -> None:
        while True:
            with self._lock:
                delivery = None
                for queue_name, consumers in self._consumers.items():
                    backlog = self._queues.get(queue_name)
                    if not backlog:
                        continue
                    for consumer in consumers:
                        if consumer.has_capacity():
                            delivery = (queue_name, consumer, backlog.popleft())
                            break
                    if delivery:
                        break
                if delivery is None:
                    return
                queue_name, consumer, entry = delivery
                body, headers, redelivered, exchange, routing_key = entry
                tag = next(self._tag_counter)
                message = Message(
                    body=body,
                    delivery_tag=tag,
                    exchange=exchange,
                    routing_key=routing_key,
                    headers=headers,
                    redelivered=redelivered,
                )
                consumer.track(tag, queue_name, body, headers, exchange, routing_key)
            # deliver outside the lock: callbacks may publish/ack inline
            consumer.deliver(message)

    def queue_depth(self, queue: str) -> int:
        with self._lock:
            return len(self._queues.get(queue, ()))

    # -- async confirms ---------------------------------------------------

    def release_confirms(self) -> None:
        """Route and confirm every staged publish ("the broker caught
        up"). Staged publishes from connections that died in the meantime
        are discarded — their publisher already saw a failure."""
        with self._lock:
            held, self._held = list(self._held), []
        for entry in held:
            if entry.result is not None:  # already failed by _die
                continue
            try:
                self._publish(
                    entry.exchange, entry.routing_key, entry.body, entry.headers
                )
                entry.result = True
            except BrokerError:
                entry.result = False
            entry.event.set()

    def _fail_held(self, connection: "MemoryConnection") -> None:
        with self._lock:
            for entry in self._held:
                if entry.channel._connection is connection:
                    entry.result = False
                    entry.event.set()
            self._held = [e for e in self._held if e.result is None]


class _HeldPublish:
    __slots__ = ("channel", "exchange", "routing_key", "body", "headers",
                 "event", "result")

    def __init__(self, channel, exchange, routing_key, body, headers):
        self.channel = channel
        self.exchange = exchange
        self.routing_key = routing_key
        self.body = body
        self.headers = headers
        self.event = threading.Event()
        self.result: bool | None = None


class _Consumer:
    def __init__(self, channel: "MemoryChannel", callback: Callable[[Message], None]):
        self.channel = channel
        self.callback = callback

    def has_capacity(self) -> bool:
        channel = self.channel
        if channel.closed:
            return False
        prefetch = channel.prefetch
        return prefetch == 0 or len(channel.unacked) < prefetch

    def track(self, tag, queue, body, headers, exchange, routing_key) -> None:
        self.channel.unacked[tag] = (queue, body, headers, exchange, routing_key)

    def deliver(self, message: Message) -> None:
        try:
            self.callback(message)
        except Exception as exc:
            # consumer callbacks must not kill the pump; leave unacked so
            # the message redelivers on connection teardown
            log.debug(f"consumer callback raised; left unacked: {exc}")


class MemoryChannel:
    def __init__(self, connection: "MemoryConnection"):
        self._connection = connection
        self._broker = connection._broker
        self.prefetch = 0
        self.unacked: dict[int, tuple[str, bytes, dict]] = {}
        self.closed = False
        self._consumer_names: list[str] = []
        self._confirm_mode = False
        self.confirm_timeout = 30.0  # overwritten by QueueClient's knob

    def _check(self) -> None:
        if self.closed or self._connection.is_closed():
            raise BrokerError("channel is closed")

    def declare_exchange(self, name: str) -> None:
        self._check()
        self._broker._declare_exchange(name)

    def declare_queue(self, name: str) -> None:
        self._check()
        self._broker._declare_queue(name)

    def bind_queue(self, queue: str, exchange: str, routing_key: str) -> None:
        self._check()
        self._broker._bind(queue, exchange, routing_key)

    def delete_queue(self, name: str) -> int:
        self._check()
        return self._broker.delete_queue(name)

    def delete_exchange(self, name: str) -> None:
        self._check()
        self._broker.delete_exchange(name)

    def set_prefetch(self, count: int) -> None:
        self._check()
        previous = self.prefetch
        self.prefetch = count
        # a GROWN window makes parked backlog deliverable right now —
        # pump, as a real broker does after basic.qos raises the
        # window. Without this, a live-qos widen (the admission
        # ladder's parked-population stretch) only takes effect at the
        # next publish/ack event, which on an otherwise-idle queue may
        # never come: the window ratchet deadlocks with backlog queued
        # behind a too-small window (exposed by the telemetry plane's
        # per-delivery work shifting the flood/shrink interleaving).
        if count == 0 or (previous != 0 and count > previous):
            self._broker._pump()

    def confirm_select(self) -> None:
        self._check()
        self._confirm_mode = True

    def publish(self, exchange, routing_key, body, headers=None, persistent=True):
        self._check()
        if self._confirm_mode and self._broker.hold_confirms:
            entry = _HeldPublish(self, exchange, routing_key, body, headers or {})
            with self._broker._lock:
                self._broker._held.append(entry)
            if not entry.event.wait(self.confirm_timeout):
                # withdraw the staged copy: the publisher is about to
                # retry, and a later release_confirms() must not route a
                # message whose hand-off already reported failure
                with self._broker._lock:
                    if entry in self._broker._held:
                        self._broker._held.remove(entry)
                        raise BrokerError("publish confirm timed out")
                # lost the race with release_confirms: the entry was
                # taken for routing; honor whatever result it reached
                entry.event.wait(self.confirm_timeout)
                if entry.result is True:
                    return
                raise BrokerError("publish confirm timed out")
            if entry.result is not True:
                raise BrokerError("connection died before publish confirm")
            return
        # synchronous mode: routing IS the confirm (the default, so
        # non-confirm callers and fast tests keep their behavior)
        self._broker._publish(exchange, routing_key, body, headers or {})

    def publish_many(
        self, entries: list, persistent: bool = True
    ) -> "list[Exception | None]":
        """Publish a batch with ONE confirm wait covering all of it.
        ``entries`` is (exchange, routing_key, body, headers) tuples;
        returns a per-entry outcome (None = confirmed on the broker,
        an exception = that publish failed) so a confirm failure fails
        exactly the affected publishes, never its batch-mates."""
        self._check()
        if not (self._confirm_mode and self._broker.hold_confirms):
            outcomes: "list[Exception | None]" = []
            for exchange, routing_key, body, headers in entries:
                try:
                    self._broker._publish(
                        exchange, routing_key, body, headers or {}
                    )
                    outcomes.append(None)
                except BrokerError as exc:
                    outcomes.append(exc)
            return outcomes
        # async-confirm mode: stage the whole batch, then wait once
        # under a shared deadline — the coalesced round trip
        held = []
        with self._broker._lock:
            for exchange, routing_key, body, headers in entries:
                entry = _HeldPublish(
                    self, exchange, routing_key, body, headers or {}
                )
                self._broker._held.append(entry)
                held.append(entry)
        deadline = time.monotonic() + self.confirm_timeout
        outcomes = []
        for entry in held:
            remaining = deadline - time.monotonic()
            if remaining > 0:
                entry.event.wait(remaining)
            if entry.result is True:
                outcomes.append(None)
                continue
            if not entry.event.is_set():
                # withdraw the staged copy, as publish() does: a later
                # release_confirms must not route a message whose
                # hand-off already reported failure
                with self._broker._lock:
                    if entry in self._broker._held:
                        self._broker._held.remove(entry)
                        outcomes.append(
                            BrokerError("publish confirm timed out")
                        )
                        continue
                entry.event.wait(self.confirm_timeout)
                if entry.result is True:
                    outcomes.append(None)
                    continue
            outcomes.append(
                BrokerError("connection died before publish confirm")
            )
        return outcomes

    def consume(self, queue: str, on_message: Callable[[Message], None]) -> str:
        self._check()
        consumer = _Consumer(self, on_message)
        with self._broker._lock:
            if queue not in self._broker._queues:
                raise BrokerError(f"no such queue '{queue}'")
            self._broker._consumers.setdefault(queue, []).append(consumer)
        self._consumer_names.append(queue)
        self._broker._pump()
        return f"ctag-{id(consumer)}"

    def ack(self, delivery_tag: int, multiple: bool = False) -> None:
        """``multiple=True`` acks every unacked delivery on THIS channel
        up to and including ``delivery_tag`` (AMQP basic.ack semantics) —
        the coalesced settle the batched fast path uses."""
        self._check()
        if multiple:
            with self._broker._lock:
                for tag in [t for t in self.unacked if t <= delivery_tag]:
                    self.unacked.pop(tag, None)
        else:
            self.unacked.pop(delivery_tag, None)
        self._broker._pump()

    def unacked_tags(self) -> list[int]:
        """Delivery tags outstanding on this channel — what a batch
        settle needs to prove a multiple-ack can't reach past a
        delivery some other worker still owns."""
        with self._broker._lock:
            return list(self.unacked)

    def nack(self, delivery_tag: int, requeue: bool) -> None:
        self._check()
        entry = self.unacked.pop(delivery_tag, None)
        if entry is not None and requeue:
            queue, body, headers, exchange, routing_key = entry
            self._broker._requeue(queue, body, headers, exchange, routing_key)
        self._broker._pump()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        broker = self._broker
        with broker._lock:
            for queue in self._consumer_names:
                broker._consumers[queue] = [
                    c for c in broker._consumers.get(queue, []) if c.channel is not self
                ]
            unacked, self.unacked = dict(self.unacked), {}
        for queue, body, headers, exchange, routing_key in unacked.values():
            broker._requeue(queue, body, headers, exchange, routing_key)


class MemoryConnection:
    def __init__(self, broker: MemoryBroker):
        self._broker = broker
        self._channels: list[MemoryChannel] = []
        self._closed = False

    def channel(self) -> MemoryChannel:
        if self._closed:
            raise BrokerError("connection is closed")
        channel = MemoryChannel(self)
        self._channels.append(channel)
        return channel

    def is_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._die()

    def _die(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._broker._fail_held(self)  # staged publishes are lost with us
        for channel in self._channels:
            channel.close()
        with self._broker._lock:
            if self in self._broker._connections:
                self._broker._connections.remove(self)
