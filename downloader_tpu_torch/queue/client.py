"""Self-healing queue client: sharded queues, supervised workers,
round-robin publishing, reconnect with backoff, graceful drain.

Rebuild of the reference's ``internal/rabbitmq/client.go``. Kept semantics
(citations into tritonmedia/downloader):

- N durable queues per topic named ``<topic>-<i>`` bound to a durable
  direct exchange ``<topic>`` with rk == queue name (client.go:326-357),
  numConsumerQueues defaulting to 2 (client.go:108).
- ``consume(topic)`` declares the topology and multiplexes all shard
  consumers into one stream (client.go:405-421).
- Publishes round-robin across the shard routing keys via a dedicated
  publisher thread fed by an internal buffer (client.go:189-237, 386-398).
- A supervisor ticks every second: recreates dead shard consumers and the
  publisher, and when the connection is closed tears down workers and
  reconnects with exponential backoff (client.go:116-184, 303-322).
- ``done()`` blocks until in-flight work drains and the connection closes
  after cancellation (client.go:400-402, 119-138).

Reference defects deliberately designed out (SURVEY.md §7 step 6):

- publish retry uses real exponential backoff with jitter, not the
  ``backoff ^ 2`` XOR oscillation bug (client.go:226),
- no dead error channel (client.go:421): consumer-level failures are
  logged and surfaced via ``stats()``,
- prefetch can be set any time before ``consume`` without ordering traps
  (the reference nil-derefs if NewClient failed, cmd:62-63),
- drain waits for unsettled deliveries, so jobs finishing during shutdown
  still ack on a live channel rather than being redelivered.
"""

from __future__ import annotations

import queue as queue_mod
import random
import threading
import time
from dataclasses import dataclass, field

from ..utils import get_logger, metrics
from ..utils import incident, profiling, tracing, watchdog
from ..utils.failpoints import FAILPOINTS
from ..utils.cancel import CancelToken
from .broker import BrokerError, Channel, Connection, ConnectionFactory, Message
from .delivery import Delivery

log = get_logger("queue")

DEFAULT_CONSUMER_QUEUES = 2  # reference client.go:108
SUPERVISOR_INTERVAL = 1.0  # reference client.go:113
DEFAULT_PREFETCH = 10  # reference client.go:107
# back-to-back publishes already sitting in the buffer are flushed as
# ONE channel batch (one confirm wait) up to this many at a time —
# bounds worst-case rework when a flush fails mid-batch
PUBLISH_FLUSH_MAX = 64


@dataclass
class _PendingPublish:
    topic: str
    body: bytes
    headers: dict
    # verbatim routing key, bypassing shard round-robin — used when
    # republishing a message consumed off the default exchange (""),
    # where the routing key IS the queue name and re-sharding would
    # route to a queue that does not exist
    routing_key: str | None = None
    attempts: int = 0
    not_before: float = 0.0
    # set once the message is actually on the broker; publish(wait=...)
    # blocks on this so callers can ack upstream work only after the
    # hand-off is durable
    flushed: threading.Event = field(default_factory=threading.Event)


@dataclass
class _Shard:
    queue_name: str
    sink: "queue_mod.Queue[Delivery]"
    channel: Channel | None = None

    def alive(self) -> bool:
        channel = self.channel
        return channel is not None and not getattr(channel, "closed", False)


@dataclass
class ClientStats:
    published: int = 0
    delivered: int = 0
    publish_retries: int = 0
    reconnects: int = 0
    consumer_errors: int = 0


class QueueClient:
    def __init__(
        self,
        token: CancelToken,
        connect: ConnectionFactory,
        num_consumer_queues: int = DEFAULT_CONSUMER_QUEUES,
        supervisor_interval: float = SUPERVISOR_INTERVAL,
        max_connect_backoff: float = 30.0,
        publish_backoff_base: float = 0.1,
        publish_backoff_cap: float = 5.0,
        drain_timeout: float = 60.0,
        publish_confirm_timeout: float = 30.0,
    ):
        self._token = token
        self._connect = connect
        self._num_queues = num_consumer_queues
        self._interval = supervisor_interval
        self._max_connect_backoff = max_connect_backoff
        self._publish_backoff_base = publish_backoff_base
        self._publish_backoff_cap = publish_backoff_cap
        self._drain_timeout = drain_timeout
        self._publish_confirm_timeout = publish_confirm_timeout

        # named for lock-wait profiling: workers, the publisher, and
        # the supervisor all serialize on this one client lock
        self._lock = profiling.named_lock(
            "queue_client", threading.RLock()
        )
        # the admission ladder's worker thread shrinks/restores this
        # while the supervisor thread reads it rebuilding channels —
        # unguarded, a rebuild could pick up a stale window AND miss
        # the live qos update (a thread-role-race finding)
        self._prefetch = DEFAULT_PREFETCH  # guarded-by: _lock
        self._connection: Connection | None = None  # guarded-by: _lock
        self._shards: dict[str, _Shard] = {}  # queue_name -> shard; guarded-by: _lock
        self._publish_buffer: "queue_mod.Queue[_PendingPublish]" = queue_mod.Queue()
        self._publish_rk: dict[str, int] = {}  # guarded-by: _lock
        self._ensured_topics: set[str] = set()  # reset on reconnect; guarded-by: _lock
        self._publisher_alive = False  # guarded-by: _lock
        self._publisher_channel: Channel | None = None  # guarded-by: _lock
        self._unsettled = 0  # guarded-by: _lock
        self._publishes_pending = 0  # not yet on the broker; guarded-by: _lock
        self._reconcile_lock = threading.Lock()
        self._done = threading.Event()
        self.stats = ClientStats()
        # seed the liveness gauge DOWN before the first connect: the
        # alert engine reads the registry, and a publisher that never
        # comes up (broker unreachable from the start) must read as
        # dead — an absent series is "no data", which never pages
        metrics.GLOBAL.gauge_set("queue_publisher_alive", 0)
        # incident-bundle introspection (utils/incident.py): buffer
        # depth + settlement state is exactly what a wedged-publisher
        # post-mortem needs. WeakMethod-held; expires with the client.
        incident.RECORDER.register_probe(
            "queue-client", self._incident_probe
        )

        self._create_connection()  # blocks with backoff, like NewClient
        self._supervisor = threading.Thread(  # thread-role: queue-supervisor
            target=self._supervise, name="queue-supervisor", daemon=True
        )
        self._supervisor.start()
        profiling.ROLES.register_thread(self._supervisor, "queue-supervisor")

    # -- connection ------------------------------------------------------

    def _create_connection(self) -> None:
        backoff = 0.5
        while True:
            self._token.raise_if_cancelled()
            try:
                connection = self._connect()
                # publish under the lock: the supervisor thread calls
                # this while connected() reads from the health thread
                with self._lock:
                    self._connection = connection
                return
            except (BrokerError, OSError) as exc:
                log.error(f"failed to dial broker: {exc}")
                if self._token.wait(backoff + random.uniform(0, backoff / 2)):
                    self._token.raise_if_cancelled()
                backoff = min(backoff * 2, self._max_connect_backoff)

    def _channel(self) -> Channel:
        with self._lock:
            if self._connection is None or self._connection.is_closed():
                raise BrokerError("connection is closed")
            channel = self._connection.channel()
            prefetch = self._prefetch
        channel.set_prefetch(prefetch)
        return channel

    def _refresh_prefetch(self, channel: Channel) -> None:
        """Close the rebuild/apply race's last window: a channel built
        BEFORE an ``apply_prefetch`` write but registered on its shard
        AFTER the snapshot got the old qos window and missed the live
        update. Re-reading (and re-applying) after registration makes
        the two orderings both safe: either this read sees the new
        value, or — registration happening-before this lock
        acquisition — the apply's snapshot saw the channel."""
        with self._lock:
            desired = self._prefetch
        try:
            channel.set_prefetch(desired)
        except BrokerError:
            pass  # channel already dead; the next rebuild reapplies

    # -- public API ------------------------------------------------------

    def set_prefetch(self, prefetch: int) -> None:
        with self._lock:
            self._prefetch = prefetch

    @property
    def prefetch(self) -> int:
        with self._lock:
            return self._prefetch

    def apply_prefetch(self, prefetch: int) -> None:
        """Change the unacked window NOW, on the live shard channels,
        not just for channels created later — the admission ladder's
        first degradation rung shrinks prefetch so an overloaded worker
        stops amplifying its own backlog. A channel that refuses the
        qos update keeps its old window until the supervisor rebuilds
        it; new channels always pick up the latest value."""
        with self._lock:
            # write + snapshot under ONE hold: a channel is either in
            # the snapshot (gets the live update below) or created
            # after the write (reads the new value in _channel) —
            # never both stale
            self._prefetch = prefetch
            channels = [
                shard.channel
                for shard in self._shards.values()
                if shard.channel is not None
            ]
        for channel in channels:
            try:
                channel.set_prefetch(prefetch)
            except BrokerError as exc:
                log.debug(f"live prefetch update failed on a shard: {exc}")
        metrics.GLOBAL.gauge_set("admission_prefetch", prefetch)

    def ensure_queue(self, name: str) -> bool:
        """Declare a bare queue (no exchange binding) — the DLQ the
        shed path publishes to via the default exchange. Must exist
        BEFORE the first shed: the default exchange silently drops
        messages routed to a queue nobody declared. Returns whether
        the declare succeeded (a down broker is not fatal here; the
        shed path falls back to requeue when its publish can't
        confirm)."""
        try:
            channel = self._channel()
        except BrokerError as exc:
            log.warning(f"failed to declare queue '{name}': {exc}")
            return False
        try:
            channel.declare_queue(name)
            return True
        except BrokerError as exc:
            log.warning(f"failed to declare queue '{name}': {exc}")
            return False
        finally:
            try:
                channel.close()
            except BrokerError:
                log.debug(f"channel close after declaring '{name}' failed")


    def connected(self) -> bool:
        """Whether the broker connection is currently up (health checks)."""
        with self._lock:
            connection = self._connection
        try:
            return connection is not None and not connection.is_closed()
        except BrokerError:
            return False

    def _incident_probe(self) -> dict:
        with self._lock:
            unsettled = self._unsettled
            publishes_pending = self._publishes_pending
            publisher_alive = self._publisher_alive
            shards = {
                name: shard.alive() for name, shard in self._shards.items()
            }
        return {
            "connected": self.connected(),
            "unsettled_deliveries": unsettled,
            "publishes_pending": publishes_pending,
            "publish_buffer_depth": self._publish_buffer.qsize(),
            "publisher_alive": publisher_alive,
            "shards_alive": shards,
            "stats": {
                "published": self.stats.published,
                "delivered": self.stats.delivered,
                "publish_retries": self.stats.publish_retries,
                "reconnects": self.stats.reconnects,
                "consumer_errors": self.stats.consumer_errors,
            },
        }

    @staticmethod
    def shard_name(topic: str, index: int) -> str:
        return f"{topic}-{index}"  # reference getRk, client.go:376-378

    def consume(self, topic: str) -> "queue_mod.Queue[Delivery]":
        """Declare the sharded topology for ``topic`` and return the
        multiplexed delivery stream; shard consumers are created (and
        recreated after failures) by the supervisor."""
        channel = self._channel()
        try:
            channel.declare_exchange(topic)
            for i in range(self._num_queues):
                name = self.shard_name(topic, i)
                channel.declare_queue(name)
                channel.bind_queue(name, topic, name)
        finally:
            channel.close()

        sink: "queue_mod.Queue[Delivery]" = queue_mod.Queue()
        with self._lock:
            for i in range(self._num_queues):
                name = self.shard_name(topic, i)
                self._shards[name] = _Shard(queue_name=name, sink=sink)
        self._reconcile()  # start consumers now, not at the next tick
        return sink

    def publish(
        self,
        topic: str,
        body: bytes,
        headers: dict | None = None,
        wait: float | None = None,
        routing_key: str | None = None,
        cancel: CancelToken | None = None,
    ) -> bool:
        """Enqueue for the publisher thread; survives broker outages by
        retrying with exponential backoff, and is drained (not dropped) at
        shutdown before done() completes.

        With ``wait`` set, blocks up to that many seconds until the
        message is confirmed on the broker and returns whether it was —
        callers that must not lose the message (the daemon's Convert
        hand-off, Delivery.error retries) pass a timeout and only ack
        their upstream delivery on True. Fire-and-forget (`wait=None`)
        returns True immediately.

        ``cancel`` lets a watched caller stop WAITING early (the stall
        watchdog releasing a job wedged at its publish stage): the wait
        returns the current confirm state as soon as the token reads
        cancelled — but ONLY for a job-level cancel. When the
        client-wide token is also cancelled (graceful shutdown cancels
        every job's child token), the wait runs to the full timeout as
        before: the publisher keeps draining through shutdown, so the
        confirm usually still arrives and the job acks instead of
        requeueing a Convert that was published anyway (a duplicate
        downstream). The message itself stays buffered either way —
        only the caller's block is interruptible.

        ``routing_key`` publishes to exchange ``topic`` with that exact
        key instead of the shard round-robin — required for the default
        exchange (``topic=""``), which routes directly to the queue named
        by the key and has no shards to round-robin over."""
        pending = self.publish_async(
            topic, body, headers=headers, routing_key=routing_key
        )
        if wait is None:
            return True
        return self.flush([pending], wait, cancel=cancel)[0]

    def publish_async(
        self,
        topic: str,
        body: bytes,
        headers: dict | None = None,
        routing_key: str | None = None,
    ) -> _PendingPublish:
        """Buffer a publish and return its handle WITHOUT waiting for
        the broker — the batched fast path enqueues a whole batch of
        Convert messages this way and then pays ONE ``flush`` covering
        all of them, instead of one confirm round trip per message."""
        if topic == "" and routing_key is None:
            raise ValueError(
                "publishing to the default exchange requires routing_key"
            )
        headers = dict(headers) if headers else {}
        # trace-context propagation (TRACE_PROPAGATE): every publish
        # from inside a job trace — the Convert hand-off above all —
        # carries the logical job's X-Trace-Context, so the downstream
        # consumer (or the next attempt) keeps ONE trace id. Retry/shed
        # paths stamp their own header first; setdefault respects it.
        context = tracing.outbound_header()
        if context is not None:
            headers.setdefault(tracing.TRACE_CONTEXT_HEADER, context)
        pending = _PendingPublish(
            topic=topic, body=body, headers=headers, routing_key=routing_key
        )
        with self._lock:
            self._publishes_pending += 1
        self._publish_buffer.put(pending)
        return pending

    def flush(
        self,
        pendings: "list[_PendingPublish]",
        wait: float,
        cancel: CancelToken | None = None,
    ) -> list[bool]:
        """Block until each handle's message is confirmed on the broker
        (or the shared deadline passes); returns per-handle confirm
        state in order. One deadline covers the whole batch — the
        coalesced confirm wait. ``cancel`` has ``publish``'s semantics:
        a JOB-level cancel stops the waiting early and reports current
        state; a client-wide shutdown keeps waiting (the publisher
        drains through shutdown, and the confirms usually arrive)."""
        deadline = time.monotonic() + wait
        # with no cancel to poll, one uninterrupted wait per handle
        step = wait if cancel is None else 0.2
        results: list[bool] = []
        cancelled_early = False
        for pending in pendings:
            while not cancelled_early and not pending.flushed.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if pending.flushed.wait(min(step, remaining)):
                    break
                if (
                    cancel is not None
                    and cancel.cancelled()
                    and not self._token.cancelled()
                ):
                    cancelled_early = True
            results.append(pending.flushed.is_set())
        return results

    def stop_consuming(self) -> None:
        """Close all shard consumers and forget them so the supervisor
        does not recreate them. Closing a channel with unacked deliveries
        requeues them at the broker (AMQP semantics; the memory broker
        matches), so messages sitting undispatched in the sink at
        shutdown go straight back to the queue instead of ping-ponging
        between a live consumer and the drain loop."""
        with self._lock:
            shards = list(self._shards.values())
            self._shards = {}
        for shard in shards:
            if shard.channel is not None:
                try:
                    shard.channel.close()
                except BrokerError:
                    pass
                shard.channel = None

    def done(self, poll_interval: float | None = None) -> None:
        """Block until, after cancellation, in-flight deliveries settle and
        the connection is closed (reference Done, client.go:400-402).
        Waits in ``poll_interval`` slices (default 0.5s) so the caller's
        thread stays interruptible instead of parking forever on the
        event."""
        interval = 0.5 if poll_interval is None else poll_interval
        while not self._done.wait(timeout=interval):
            pass

    # -- delivery accounting ---------------------------------------------

    def _on_delivery(self, shard: _Shard, channel: Channel, message: Message) -> None:
        # bind to the channel the message arrived on: if the shard has
        # reconnected since, settling on the stale channel must fail softly
        # (the broker already requeued it), never touch the new channel
        with self._lock:
            self._unsettled += 1
            self.stats.delivered += 1
        delivery = Delivery(
            message,
            channel,
            on_settled=self._on_settled,
            # error() retries route through the buffered publisher so they
            # survive outages and are drained at shutdown
            publisher=self.publish,
            publish_confirm_timeout=self._publish_confirm_timeout,
        )
        delivery.queue_name = shard.queue_name  # for the job trace root
        shard.sink.put(delivery)

    def _on_settled(self, delivery: Delivery) -> None:
        with self._lock:
            self._unsettled -= 1

    # -- supervisor ------------------------------------------------------

    def _reconcile(self) -> None:
        # serialized: consume() and the supervisor may call this
        # concurrently, and two racing alive-checks would create duplicate
        # consumers on the same shard
        with self._reconcile_lock:
            self._reconcile_locked()

    def _reconcile_locked(self) -> None:
        with self._lock:
            shards = list(self._shards.values())
        for shard in shards:
            if shard.alive():
                continue
            try:
                channel = self._channel()
                channel.consume(
                    shard.queue_name,
                    lambda message, s=shard, ch=channel: self._on_delivery(
                        s, ch, message
                    ),
                )
                shard.channel = channel
                self._refresh_prefetch(channel)
                log.info(f"worker on queue '{shard.queue_name}' started")
            except BrokerError as exc:
                self.stats.consumer_errors += 1
                log.error(f"failed to create worker '{shard.queue_name}': {exc}")

        with self._lock:
            need_publisher = not self._publisher_alive
        if need_publisher:
            channel = None
            try:
                channel = self._channel()
                # publisher confirms: publish() on this channel blocks
                # until the broker acks, so _PendingPublish.flushed truly
                # means "on the broker" — the reference acks retried
                # messages on a bare socket write (delivery.go:73-84),
                # losing them if the broker dies in the window
                channel.confirm_select()
                channel.confirm_timeout = self._publish_confirm_timeout
            except BrokerError as exc:
                log.error(f"failed to create publisher channel: {exc}")
                if channel is not None:
                    try:
                        channel.close()
                    except BrokerError:
                        pass
                return
            with self._lock:
                self._publisher_channel = channel
                self._publisher_alive = True
                # liveness as a first-class series: the alert engine's
                # publisher-liveness rule watches this gauge, closing
                # the wedged-publisher class's detection loop.
                # Written UNDER the lock (a cheap leaf-lock set) so the
                # gauge ordering always matches the state transitions —
                # a crashed generation's late 0 must not land after the
                # supervisor's rebuild wrote 1 and stick a false
                # publisher-dead page until the next reconnect
                metrics.GLOBAL.gauge_set("queue_publisher_alive", 1)
            publisher = threading.Thread(  # thread-role: queue-publisher
                target=self._publish_loop,
                args=(channel,),
                name="queue-publisher",
                daemon=True,
            )
            publisher.start()
            profiling.ROLES.register_thread(publisher, "queue-publisher")
            log.info("publisher created")

    def _supervise(self) -> None:
        while True:
            if self._token.wait(self._interval):
                self._drain_and_close()
                return
            with self._lock:
                connection = self._connection
            if connection is not None and connection.is_closed():
                log.warning("connection lost; reconnecting")
                self.stats.reconnects += 1
                self._teardown_workers()
                try:
                    self._create_connection()
                except Exception:
                    return  # cancelled during reconnect; drain path follows
            self._reconcile()

    def _teardown_workers(self) -> None:
        with self._lock:
            shards = list(self._shards.values())
            publisher_channel = self._publisher_channel
            self._publisher_channel = None
            self._publisher_alive = False
            self._ensured_topics.clear()
            metrics.GLOBAL.gauge_set("queue_publisher_alive", 0)
        for shard in shards:
            if shard.channel is not None:
                try:
                    shard.channel.close()
                except BrokerError:
                    pass
                shard.channel = None
        if publisher_channel is not None:
            try:
                publisher_channel.close()
            except BrokerError:
                pass

    def _drain_and_close(self) -> None:
        """After cancellation: wait (bounded) for unsettled deliveries
        (in-flight jobs) to ack/nack and for buffered publishes to reach
        the broker, then close everything and signal done(). Deliveries
        still unsettled at the timeout are abandoned — closing their
        channels requeues them, preserving at-least-once."""
        deadline = time.monotonic() + self._drain_timeout
        while time.monotonic() < deadline:
            with self._lock:
                deliveries_pending = self._unsettled
                publishes_pending = self._publishes_pending
            if deliveries_pending <= 0 and publishes_pending <= 0:
                break
            # keep the publisher alive during drain (it may have died on a
            # publish error and needs a fresh channel to finish the buffer)
            with self._lock:
                connection = self._connection
            if connection is not None and connection.is_closed():
                # one dial attempt per drain iteration (the normal
                # _create_connection refuses to run once cancelled)
                try:
                    fresh = self._connect()
                except (BrokerError, OSError):
                    time.sleep(min(self._interval, 0.5))
                    continue
                with self._lock:
                    self._connection = fresh
                self.stats.reconnects += 1
            self._reconcile()
            log.info(
                f"waiting on {deliveries_pending} unsettled deliveries and "
                f"{publishes_pending} unpublished messages ..."
            )
            time.sleep(min(self._interval, 0.5))
        with self._lock:
            deliveries_pending = self._unsettled
            publishes_pending = self._publishes_pending
        if deliveries_pending > 0 or publishes_pending > 0:
            log.warning(
                f"drain timed out ({deliveries_pending} unsettled, "
                f"{publishes_pending} unpublished); unsettled messages will "
                "be redelivered"
            )
        self._teardown_workers()
        with self._lock:
            connection, self._connection = self._connection, None
        if connection is not None and not connection.is_closed():
            try:
                connection.close()
            except BrokerError as exc:
                log.warning(f"failed to close connection gracefully: {exc}")
        self._done.set()

    # -- publisher -------------------------------------------------------

    def _ensure_topology(self, channel: Channel, topic: str) -> None:
        """Declare the exchange and bound shard queues for a publish topic,
        once per connection. The reference only ensures topology on the
        consume side (client.go:405-409), so a publish to a topic nobody
        has consumed yet is silently dropped by the broker; declaring the
        shard queues here makes the pipeline hand-off durable either way."""
        with self._lock:
            if topic in self._ensured_topics:
                return
        channel.declare_exchange(topic)
        for i in range(self._num_queues):
            name = self.shard_name(topic, i)
            channel.declare_queue(name)
            channel.bind_queue(name, topic, name)
        with self._lock:
            self._ensured_topics.add(topic)

    def _next_rk(self, topic: str) -> str:
        with self._lock:
            index = self._publish_rk.get(topic, 0)
            self._publish_rk[topic] = (index + 1) % self._num_queues
        return self.shard_name(topic, index)

    def _publish_loop(self, my_channel: Channel) -> None:
        # stall-watchdog liveness: this loop ticks at >= 5 Hz when idle
        # (buffer get timeout 0.2 s) and beats per publish attempt, so
        # a publisher thread wedged inside a broker write — the exact
        # regression class that once stranded publishes — reads as stalled instead
        # of silently stranding every later publish in the buffer
        watch = watchdog.MONITOR.loop("queue-publisher")
        try:
            self._publish_loop_watched(my_channel, watch)
        except Exception as exc:
            # an exception escaping the inner loop's own handling would
            # kill this thread with ``_publisher_alive`` stuck True —
            # the exact wedged-publisher class the watchdog exists for.
            # Mark the publisher dead so the supervisor rebuilds it.
            log.error("publisher loop crashed; supervisor will rebuild", exc=exc)
            with self._lock:
                if self._publisher_channel is my_channel:
                    self._publisher_alive = False
                    self._publisher_channel = None
                    metrics.GLOBAL.gauge_set("queue_publisher_alive", 0)
            try:
                my_channel.close()
            except BrokerError:
                pass
        finally:
            watchdog.MONITOR.unregister(watch)

    def _publish_loop_watched(
        self, my_channel: Channel, watch
    ) -> None:
        # keeps running after cancellation until the buffer drains (or the
        # drain deadline passes), so Convert messages enqueued by jobs that
        # were just acked are not dropped on shutdown.
        #
        # Generation guard: ``my_channel`` is the channel this thread was
        # spawned with. After a reconnect the supervisor installs a fresh
        # channel and thread; a stale thread that wakes up later must exit
        # without touching shared publisher state (it no longer owns it),
        # otherwise publisher threads accumulate across flapping
        # reconnects.
        drain_deadline: float | None = None
        while True:
            watch.beat()
            with self._lock:
                if self._publisher_channel is not my_channel:
                    return  # superseded; a newer generation owns the state
            if self._token.cancelled():
                if drain_deadline is None:
                    drain_deadline = time.monotonic() + self._drain_timeout
                if time.monotonic() > drain_deadline:
                    break
                with self._lock:
                    if self._publishes_pending == 0:
                        break
            try:
                pending = self._publish_buffer.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            with self._lock:
                if self._publisher_channel is not my_channel:
                    self._publish_buffer.put(pending)  # hand to successor
                    return
            delay = pending.not_before - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, 0.5))
                if time.monotonic() < pending.not_before:
                    self._publish_buffer.put(pending)
                    continue
            # coalesce: whatever else is ALREADY buffered flushes as one
            # channel batch — one confirm wait for the lot instead of
            # one broker round trip per message. Only ripe messages
            # join; a backoff-delayed one goes back and ends the drain
            # (taking more behind it would reorder past it forever).
            batch = [pending]
            if getattr(my_channel, "publish_many", None) is not None:
                now = time.monotonic()
                while len(batch) < PUBLISH_FLUSH_MAX:
                    try:
                        extra = self._publish_buffer.get_nowait()
                    except queue_mod.Empty:
                        break
                    if extra.not_before > now:
                        self._publish_buffer.put(extra)
                        break
                    batch.append(extra)
            if len(batch) > 1:
                if not self._flush_publish_batch(my_channel, batch):
                    return  # thread exits; supervisor recreates
            elif not self._flush_publish_one(my_channel, pending):
                return  # thread exits; supervisor recreates with a fresh channel
        with self._lock:
            if self._publisher_channel is my_channel:
                self._publisher_alive = False
                self._publisher_channel = None
                metrics.GLOBAL.gauge_set("queue_publisher_alive", 0)
        try:
            my_channel.close()
        except BrokerError:
            pass

    # -- publisher flush helpers ------------------------------------------

    def _note_published(self, pending: _PendingPublish) -> None:
        with self._lock:
            self.stats.published += 1
            self._publishes_pending -= 1
        pending.flushed.set()

    def _note_publish_failure(
        self, pending: _PendingPublish, exc: BaseException
    ) -> None:
        """Schedule one message's retry: real exponential backoff with
        jitter — the reference's `backoff ^ 2` XOR bug oscillated
        0↔2ms (client.go:226) — and back into the buffer it goes
        (at-least-once beats silent loss)."""
        pending.attempts += 1
        backoff = min(
            self._publish_backoff_base * (2 ** (pending.attempts - 1)),
            self._publish_backoff_cap,
        )
        pending.not_before = time.monotonic() + backoff * (
            1 + random.uniform(0, 0.25)
        )
        with self._lock:
            self.stats.publish_retries += 1
        log.warning(
            f"publish failed ({exc}); retry {pending.attempts} "
            f"in {backoff:.2f}s"
        )
        self._publish_buffer.put(pending)

    def _retire_publisher_channel(self, my_channel: Channel) -> None:
        """Mark the publisher dead (supervisor rebuilds it) and close
        the abandoned channel: with confirms, a publish failure
        (confirm timeout) can happen on a HEALTHY connection, and
        leaking one open channel per retry cycle would eventually blow
        past the negotiated channel-max on a real broker."""
        with self._lock:
            if self._publisher_channel is my_channel:
                self._publisher_alive = False
                self._publisher_channel = None
                metrics.GLOBAL.gauge_set("queue_publisher_alive", 0)
        try:
            my_channel.close()
        except BrokerError:
            pass

    def _flush_publish_one(
        self, my_channel: Channel, pending: _PendingPublish
    ) -> bool:
        """Publish one buffered message; False means the channel was
        retired and the publisher thread must exit. The exception catch
        is broad on purpose (not just BrokerError): an escaped
        exception would kill the thread while ``_publisher_alive``
        stays True, so the supervisor would never recreate the
        publisher and every later publish would buffer unsent forever."""
        if pending.routing_key is not None:
            routing_key = pending.routing_key
        else:
            routing_key = self._next_rk(pending.topic)
        try:
            if FAILPOINTS.fire("queue.publish"):
                raise BrokerError("failpoint: queue.publish dropped")
            if pending.topic:  # the default exchange ("") is not declarable
                self._ensure_topology(my_channel, pending.topic)
            my_channel.publish(
                pending.topic,
                routing_key,
                pending.body,
                headers=pending.headers,
                persistent=True,
            )
        except Exception as exc:
            self._note_publish_failure(pending, exc)
            self._retire_publisher_channel(my_channel)
            return False
        self._note_published(pending)
        log.with_fields(topic=pending.topic, rk=routing_key).debug(
            "published message"
        )
        return True

    def _flush_publish_batch(
        self, my_channel: Channel, batch: "list[_PendingPublish]"
    ) -> bool:
        """Publish a drained batch under ONE confirm wait
        (``channel.publish_many``). Per-entry outcomes keep failure
        isolation exact: confirmed messages flush, failed ones re-buffer
        with their own backoff — a confirm failure never takes down its
        batch-mates' hand-offs. Any failure still retires the channel
        (False), same as the single path."""
        entries = []
        try:
            if FAILPOINTS.fire("queue.publish"):
                raise BrokerError("failpoint: queue.publish dropped")
            for pending in batch:
                if pending.topic:
                    self._ensure_topology(my_channel, pending.topic)
                routing_key = (
                    pending.routing_key
                    if pending.routing_key is not None
                    else self._next_rk(pending.topic)
                )
                entries.append(
                    (pending.topic, routing_key, pending.body, pending.headers)
                )
            outcomes = my_channel.publish_many(entries)
        except Exception as exc:
            # failed before per-entry outcomes existed (topology declare
            # or the batch API itself): the first message burns an
            # attempt with backoff, the rest re-buffer untouched
            self._note_publish_failure(batch[0], exc)
            for pending in batch[1:]:
                self._publish_buffer.put(pending)
            self._retire_publisher_channel(my_channel)
            return False
        metrics.GLOBAL.add("queue_publish_flushes")
        metrics.GLOBAL.add("queue_publishes_coalesced", len(batch) - 1)
        failed = False
        for pending, outcome in zip(batch, outcomes):
            if outcome is None:
                self._note_published(pending)
            else:
                failed = True
                self._note_publish_failure(pending, outcome)
        if failed:
            self._retire_publisher_channel(my_channel)
            return False
        return True
