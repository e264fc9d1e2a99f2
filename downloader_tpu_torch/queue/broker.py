"""Broker abstraction for the queue transport.

The reference talks AMQP 0-9-1 through streadway/amqp directly
(internal/rabbitmq/client.go). This rebuild splits the same behavior into
two layers: a small connection-level interface (this module) with two
implementations — a real AMQP 0-9-1 wire client (amqp.py) and an in-memory
broker (memory.py) for hermetic tests, standalone mode, and benchmarks —
and the reference-semantics client on top (client.py): sharded queues,
round-robin publish, supervisor, reconnect, drain.

The interface mirrors the slice of AMQP the reference uses: durable direct
exchanges (client.go:333), durable queue declare + bind (client.go:344-353),
qos/prefetch (client.go:367), publish with persistent delivery mode
(client.go:224, Publish :386-398), consume with explicit ack/nack
(delivery.go:55-63), and connection liveness checks (client.go:169).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol


class BrokerError(Exception):
    """Connection-level failure; the supervisor reacts by reconnecting."""


@dataclass
class Message:
    """A delivered message, with enough identity to ack/nack it."""

    body: bytes
    delivery_tag: int
    exchange: str = ""
    routing_key: str = ""
    headers: dict = field(default_factory=dict)
    redelivered: bool = False


class Channel(Protocol):
    """One multiplexed unit of work on a connection (AMQP channel)."""

    def declare_exchange(self, name: str) -> None: ...

    def declare_queue(self, name: str) -> None: ...

    def bind_queue(self, queue: str, exchange: str, routing_key: str) -> None: ...

    def set_prefetch(self, count: int) -> None: ...

    def confirm_select(self) -> None:
        """Put the channel in publisher-confirm mode (RabbitMQ's
        ``confirm.select`` extension): every subsequent ``publish`` blocks
        until the broker acknowledges the message and raises BrokerError
        if it is nacked, the confirm times out, or the connection dies
        first — so a True return from the layers above genuinely means
        "on the broker", closing the ack-after-socket-write loss window
        the reference shares (delivery.go:73-84)."""
        ...

    def publish(
        self,
        exchange: str,
        routing_key: str,
        body: bytes,
        headers: dict | None = None,
        persistent: bool = True,
    ) -> None: ...

    def consume(self, queue: str, on_message: Callable[[Message], None]) -> str: ...

    def ack(self, delivery_tag: int, multiple: bool = False) -> None:
        """``multiple=True`` settles every unacked delivery on this
        channel up to ``delivery_tag`` in one frame (AMQP basic.ack
        semantics) — the batched fast path's coalesced settle.

        Channels that support coalescing also expose two optional
        extensions the batch settle feature-detects (see
        queue/delivery.py ``ack_batch``):

        - ``unacked_tags() -> list[int]`` — outstanding delivery tags,
          so a multiple-ack provably never reaches past a delivery a
          different worker still owns;
        - ``publish_many(entries, persistent=True) -> list[Exception | None]``
          — publish a batch under ONE confirm wait, with per-entry
          outcomes so a confirm failure fails exactly the affected
          publishes."""
        ...

    def nack(self, delivery_tag: int, requeue: bool) -> None: ...

    def close(self) -> None: ...


class Connection(Protocol):
    """A broker connection; channels are cheap, connections are supervised."""

    def channel(self) -> Channel: ...

    def is_closed(self) -> bool: ...

    def close(self) -> None: ...


ConnectionFactory = Callable[[], Connection]
