"""Delivery wrapper: ack/nack/error with retry metadata.

Rebuild of the reference's ``internal/rabbitmq/delivery.go``. A Delivery
wraps a broker message with the retry count parsed from the ``X-Retries``
header (delivery.go:31-42, tolerating missing/garbage values) and exposes:

- ``ack()``   — remove from the queue (delivery.go:55),
- ``nack()``  — drop without requeue (delivery.go:60-63 passes
  requeue=false), with ``requeue=True`` opt-in for transient failures —
  the knob whose absence causes the reference's starve-on-failure bug
  (cmd:119-149 leaves failures unacked forever),
- ``error()`` — the retry path: republish with X-Retries+1, confirm the
  republish reached the broker, then ack the original (delivery.go:66-84's
  self-described dead-letter HACK — dead code there, wired up here; and
  no 10-second sleep on the worker thread: retry pacing happens on the
  consume side).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..fetch.sources import parse_mirror_list
from ..utils import admission, get_logger, metrics, tracing
from .broker import BrokerError, Channel, Message

log = get_logger("queue")

RETRY_HEADER = "X-Retries"
# admission/QoS headers (utils/admission.py consumes them): producers
# stamp a job class and tenant id; absent/garbage values fall back to
# the worker's configured defaults
CLASS_HEADER = "X-Job-Class"
TENANT_HEADER = "X-Tenant"
# multi-source racing fetch (fetch/sources.py): alternate URLs for the
# SAME object, comma/whitespace separated; the fetch layer races byte
# spans across every mirror whose probe matches the primary. Garbage
# entries degrade to fewer sources, never to a dropped job.
MIRRORS_HEADER = "X-Mirrors"
# the DLQ contract for shed jobs: how many times this message has been
# shed, when a re-injector may retry it, why it was shed, and — past
# the redelivery cap — a terminal marker re-injectors must honor
SHED_HEADER = "X-Shed-Count"
RETRY_AFTER_HEADER = "X-Retry-After"
SHED_REASON_HEADER = "X-Shed-Reason"
DEAD_HEADER = "X-Dead"


def dlq_name(topic: str) -> str:
    """The dead-letter queue paired with a consume topic."""
    return f"{topic}.dlq"


def ack_batch(deliveries: "list[Delivery]") -> int:
    """Ack many settled-together deliveries with coalesced broker
    traffic: per channel, one ``multiple=True`` basic.ack covers the
    longest prefix of outstanding tags that belongs ENTIRELY to this
    batch, and anything past that prefix is acked individually.

    The prefix proof is what keeps at-least-once honest: AMQP's
    multiple-ack settles EVERY delivery up to the tag, including ones
    other workers still hold unsettled — so the high-water mark is
    computed against ``channel.unacked_tags()`` and never reaches past
    a tag outside this batch. Channels without that introspection get
    plain per-delivery acks (no coalescing, same semantics).

    Returns the number of ack frames sent (observability; the saving
    lands on the ``queue_acks_coalesced`` counter)."""
    by_channel: dict[int, tuple[Channel, list[Delivery]]] = {}
    for delivery in deliveries:
        if not delivery._settle():
            continue  # double-settle protection, as in ack()
        channel = delivery._channel
        by_channel.setdefault(id(channel), (channel, []))[1].append(delivery)

    frames = 0
    for channel, group in by_channel.values():
        tags = sorted(d.message.delivery_tag for d in group)
        ours = set(tags)
        high_water = None
        introspect = getattr(channel, "unacked_tags", None)
        if callable(introspect):
            try:
                pending = sorted(introspect())
            except BrokerError:
                pending = None
            if pending is not None:
                # walk outstanding tags in order: the prefix that stays
                # inside our batch bounds the multiple-ack
                for tag in pending:
                    if tag not in ours:
                        break
                    high_water = tag
        remainder = tags
        if high_water is not None:
            covered = [t for t in tags if t <= high_water]
            remainder = [t for t in tags if t > high_water]
            try:
                channel.ack(high_water, multiple=True)
                frames += 1
                if len(covered) > 1:
                    metrics.GLOBAL.add(
                        "queue_acks_coalesced", len(covered) - 1
                    )
            except BrokerError as exc:
                # connection died: the broker requeues everything
                # unacked (at-least-once); nothing more to do here
                log.warning(f"failed to batch-ack messages: {exc}")
                remainder = []
        for tag in remainder:
            try:
                channel.ack(tag)
                frames += 1
            except BrokerError as exc:
                log.warning(f"failed to ack message: {exc}")
    return frames


class Delivery:
    def __init__(  # protocol: delivery-settle acquire
        self,
        message: Message,
        channel: Channel,
        on_settled: Callable[["Delivery"], None] = lambda d: None,
        publisher: "Callable[..., bool] | None" = None,
        publish_confirm_timeout: float = 30.0,
    ):
        self.message = message
        self.body = message.body
        # when this delivery entered the consumer (monotonic): the gap
        # to worker pickup is the job trace's "dequeue" span — queueing
        # delay inside this process, invisible to end-to-end timing
        self.received_at = time.monotonic()
        # the shard queue it arrived on; the queue client stamps this
        # right after construction (observability only)
        self.queue_name = ""
        retries = message.headers.get(RETRY_HEADER, 0)
        self.retries = retries if isinstance(retries, int) else 0
        sheds = message.headers.get(SHED_HEADER, 0)
        self.shed_count = sheds if isinstance(sheds, int) else 0
        # admission identity from headers; job_class stays None when
        # the producer didn't classify (the admission layer applies
        # the configured default), tenant always resolves
        raw_class = message.headers.get(CLASS_HEADER)
        self.job_class: "str | None" = (
            admission.normalize_class(raw_class, default="")
            or None
        )
        self.tenant = admission.normalize_tenant(
            message.headers.get(TENANT_HEADER)
        )
        # parsed mirror list for the multi-source fetch; the daemon
        # merges it with the MIRROR_URLS config fallback per job
        self.mirrors = parse_mirror_list(
            message.headers.get(MIRRORS_HEADER)
        )
        # the logical job's trace identity: adopted from the propagated
        # X-Trace-Context when a prior attempt (or the producer)
        # stamped one, minted fresh otherwise — so even a job that is
        # shed before any trace opens (the admission path) has ONE id
        # its DLQ message and incident bundle can share
        self.trace_context = tracing.TraceContext.parse(
            message.headers.get(tracing.TRACE_CONTEXT_HEADER)
        ) or tracing.TraceContext.mint()
        self._channel = channel
        self._on_settled = on_settled
        self._publisher = publisher
        self._publish_confirm_timeout = publish_confirm_timeout
        self._settled = False
        self._lock = threading.Lock()
        self._settle_hooks: "list[Callable[[], None]]" = []  # guarded-by: _lock

    def add_settle_hook(self, hook: "Callable[[], None]") -> None:
        """Run ``hook`` exactly once when this delivery settles (ack,
        nack, error, or shed — whichever happens first). The admission
        layer hangs quota releases here so a slot is refunded on EVERY
        outcome, including a watchdog-cancelled stall, without the
        daemon enumerating settle sites. A hook added after settlement
        runs immediately (the release must not be lost to the race)."""
        with self._lock:
            if not self._settled:
                self._settle_hooks.append(hook)
                return
        self._run_hook(hook)

    @staticmethod
    def _run_hook(hook) -> None:
        try:
            hook()
        except Exception as exc:
            # a broken release hook must not poison the settle path
            log.warning(f"delivery settle hook raised: {exc}")

    def _stamp_trace_context(self, headers: dict) -> None:
        """Carry the logical job's trace id onto a republish (retry or
        DLQ shed): the active job trace when this thread is inside one
        (real parent-span linkage), else this delivery's inbound/minted
        context advanced one attempt. TRACE_PROPAGATE=off stamps
        nothing — each attempt then traces fresh, as before."""
        value = tracing.outbound_header(fallback=self.trace_context)
        if value is not None:
            headers[tracing.TRACE_CONTEXT_HEADER] = value

    def _settle(self) -> bool:  # protocol: delivery-settle release
        with self._lock:
            if self._settled:
                return False
            self._settled = True
            hooks, self._settle_hooks = self._settle_hooks, []
        self._on_settled(self)
        for hook in hooks:
            self._run_hook(hook)
        return True

    @property
    def settled(self) -> bool:
        return self._settled

    def ack(self) -> None:  # protocol: delivery-settle release
        if not self._settle():
            return
        try:
            self._channel.ack(self.message.delivery_tag)
        except BrokerError as exc:
            # connection died: the broker will redeliver (at-least-once)
            log.warning(f"failed to ack message: {exc}")

    def nack(self, requeue: bool = False) -> None:  # protocol: delivery-settle release
        if not self._settle():
            return
        try:
            self._channel.nack(self.message.delivery_tag, requeue=requeue)
        except BrokerError as exc:
            log.warning(f"failed to nack message: {exc}")

    def error(self) -> None:  # protocol: delivery-settle release
        """Retry the message: republish with an incremented X-Retries, then
        ack the original. The republish must be CONFIRMED on the broker
        before the ack — when the delivery came through a QueueClient the
        publisher is its buffered publish with ``wait=`` (blocks until the
        message is actually on the wire); a buffered-but-unflushed
        republish followed by an ack would lose the job if the process
        died before the flush (the reference's ack-sleep-republish hack
        has the same window, delivery.go:73-84). If the hand-off cannot
        be confirmed in time, the original is requeue-nacked instead —
        the broker redelivers it and the retry count stalls one round,
        which is at-least-once, not loss. Retry pacing is the consumer's
        job (the daemon delays retried messages before processing)."""
        if not self._settle():
            return
        headers = dict(self.message.headers)
        headers[RETRY_HEADER] = self.retries + 1
        self._stamp_trace_context(headers)
        try:
            if self._publisher is not None:
                # Messages consumed off the default exchange ("") carry the
                # target queue in routing_key; re-sharding "" as a topic
                # would publish to a queue that does not exist, so pin the
                # original key instead (reference delivery.go:73-84 always
                # republishes with both msg.Exchange and msg.RoutingKey).
                rk = self.message.routing_key if not self.message.exchange else None
                confirmed = self._publisher(
                    self.message.exchange,
                    self.body,
                    headers,
                    wait=self._publish_confirm_timeout,
                    routing_key=rk,
                )
            else:
                self._channel.publish(
                    self.message.exchange,
                    self.message.routing_key,
                    self.body,
                    headers=headers,
                )
                confirmed = True
        except BrokerError as exc:
            log.warning(f"failed to republish retried message: {exc}")
            confirmed = False
        if not confirmed:
            # never ack what we failed to hand off: requeue the original
            log.warning("retry republish unconfirmed; requeueing original")
            try:
                self._channel.nack(self.message.delivery_tag, requeue=True)
            except BrokerError as nack_exc:
                log.warning(f"failed to requeue message: {nack_exc}")
            return
        try:
            self._channel.ack(self.message.delivery_tag)
        except BrokerError as exc:
            # ack lost -> original redelivers -> duplicate retry; that is
            # at-least-once, not loss
            log.warning(f"failed to ack message post-retry: {exc}")

    def shed(  # protocol: delivery-settle release
        self,
        dlq_queue: str,
        reason: str,
        retry_after: int,
        max_sheds: int = 3,
    ) -> str:
        """Explicitly shed this job to the dead-letter queue instead of
        silently requeueing it forever: publish the body to
        ``dlq_queue`` (default exchange, so the queue name IS the
        routing key) with ``X-Shed-Count`` incremented,
        ``X-Retry-After`` seconds a re-injector must wait, and
        ``X-Shed-Reason``; then ack the original. Past ``max_sheds``
        the message is additionally stamped ``X-Dead`` — it stays in
        the DLQ for operators, and re-injectors must not replay it
        (the capped-redelivery half of the contract).

        The DLQ hand-off is CONFIRMED before the ack, exactly like
        ``error()``: an unconfirmable hand-off requeue-nacks the
        original instead (at-least-once, never loss). Returns the
        outcome: ``"dlq"``, ``"dead"``, ``"requeued"``, or
        ``"already-settled"`` (another path — a watchdog cancel, a
        crash backstop — settled the delivery first; nothing was shed
        and nothing went back to the broker)."""
        if not self._settle():
            return "already-settled"
        headers = dict(self.message.headers)
        new_count = self.shed_count + 1
        headers[SHED_HEADER] = new_count
        self._stamp_trace_context(headers)
        headers[RETRY_AFTER_HEADER] = max(0, int(retry_after))
        headers[SHED_REASON_HEADER] = str(reason)[:200]
        dead = new_count > max_sheds
        if dead:
            headers[DEAD_HEADER] = (
                f"shed {new_count} times (cap {max_sheds})"
            )
        try:
            if self._publisher is not None:
                confirmed = self._publisher(
                    "",  # default exchange: routing key IS the queue
                    self.body,
                    headers,
                    wait=self._publish_confirm_timeout,
                    routing_key=dlq_queue,
                )
            else:
                self._channel.publish(
                    "", dlq_queue, self.body, headers=headers
                )
                confirmed = True
        except BrokerError as exc:
            log.warning(f"failed to publish shed message to DLQ: {exc}")
            confirmed = False
        if not confirmed:
            log.warning("DLQ hand-off unconfirmed; requeueing original")
            try:
                self._channel.nack(self.message.delivery_tag, requeue=True)
            except BrokerError as nack_exc:
                log.warning(f"failed to requeue message: {nack_exc}")
            return "requeued"
        try:
            self._channel.ack(self.message.delivery_tag)
        except BrokerError as exc:
            # ack lost -> original redelivers -> duplicate shed; the
            # DLQ may hold two copies, which is at-least-once, not loss
            log.warning(f"failed to ack message post-shed: {exc}")
        metrics.GLOBAL.add("dlq_published")
        if dead:
            metrics.GLOBAL.add("dlq_dead_jobs")
        return "dead" if dead else "dlq"
