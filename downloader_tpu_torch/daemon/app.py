"""Daemon composition root: the consume → download → scan → upload →
publish → ack loop.

Rebuild of ``cmd/downloader/downloader.go``. The pipeline per message
matches the reference (cmd:103-155): unmarshal ``Download``, fetch via the
dispatcher, scan for media, upload, publish ``Convert`` (created_at +
media, cmd:136-139), ack. Differences, all deliberate:

- **N-way job concurrency** — worker threads consume the multiplexed
  delivery stream; the reference hardwires one goroutine (its own TODO,
  cmd:100-101).
- **No starved consumer.** The reference ``continue``s on mid-pipeline
  failure without ack/nack, leaving the message unacked and the
  prefetch-1 consumer blocked until reconnect (cmd:119-149, SURVEY.md
  §3.2). Here every outcome settles the delivery: malformed protobuf or
  missing media → ``nack`` (dropped, as cmd:108 does), transient
  failures → ``delivery.error()`` retry with X-Retries until
  ``max_job_retries`` then nack, unsupported jobs → nack immediately.
- **Graceful shutdown that finishes work**: on SIGINT/SIGTERM/SIGHUP the
  workers stop taking new deliveries, finish and ack in-flight jobs, and
  the queue client drains (the reference kills workers mid-job and relies
  on redelivery).
"""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import threading
import time
from dataclasses import dataclass, field

from ..fetch import DispatchClient, TransferError, UnsupportedJobError
from ..fetch import progress as transfer_progress
from ..queue import QueueClient
from ..queue.delivery import Delivery, ack_batch
from ..scan import scan_dir
from ..store import Uploader, UploadError
from ..utils import metrics, configure_from_env, get_logger, tracing
from ..utils import admission, canary, incident, profiling, watchdog
from ..utils.cancel import Cancelled, CancelToken
from ..utils.failpoints import FAILPOINTS
from ..wire import Convert, Download, WireError
from .config import Config

log = get_logger("daemon")


@dataclass
class DaemonStats:
    processed: int = 0
    failed: int = 0
    retried: int = 0
    dropped: int = 0
    shed: int = 0  # explicitly load-shed to the DLQ (admission layer)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def bump(self, **deltas: int) -> None:
        with self.lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)


@dataclass
class _FastJob:
    """One batched-lane job's open state between its pipeline phase and
    the batch's coalesced settle (confirm flush + multiple-ack)."""

    delivery: Delivery
    media: object
    trace: object  # tracing.OpenTrace
    watch: object
    token: CancelToken
    job_log: object
    started: float
    publish_span: object
    pending: object  # queue client publish handle


# _run_fast_job outcome: the fast path declined late (stale probe,
# redirect, object grew) — the caller reruns the job through the full
# pipeline, which owns every such case
_FALLBACK = object()


class _AnyCancelled:
    """Cancel view over a batch's job tokens for the coalesced confirm
    flush: a watchdog releasing ANY job wedged at its publish stage
    stops the shared wait (confirmed batch-mates still ack; unconfirmed
    ones requeue) — the batched analogue of the unbatched path passing
    ``cancel=job_token`` to ``publish(wait=...)``."""

    __slots__ = ("_tokens",)

    def __init__(self, tokens):
        self._tokens = tokens

    def cancelled(self) -> bool:
        return any(token.cancelled() for token in self._tokens)


class Daemon:
    def __init__(
        self,
        token: CancelToken,
        client: QueueClient,
        dispatcher: DispatchClient,
        uploader: Uploader,
        config: Config,
    ):
        self._token = token
        self._client = client
        self._dispatcher = dispatcher
        self._uploader = uploader
        self._config = config
        self.stats = DaemonStats()
        self._workers: list[threading.Thread] = []
        # SLO-aware admission (utils/admission.py): the process-wide
        # controller is configured from THIS daemon's config — budgets,
        # per-tenant quotas, class weights, and the degradation-ladder
        # thresholds all come from the same env contract
        admission.CONTROLLER.configure(
            budgets=config.admission_budgets or None,
            quota_jobs=config.quota_tenant_jobs,
            quota_bytes=config.quota_tenant_bytes,
            weights=config.admission_weights or None,
            shrink_at=config.admission_shrink_at,
            pause_at=config.admission_pause_at,
            shed_at=config.admission_shed_at,
        )
        # the prefetch to restore when the ladder steps back to normal
        # (serve()/tests set the client's window before building us)
        self._normal_prefetch = getattr(client, "prefetch", None)
        self._ladder_lock = threading.Lock()
        self._ladder_level = admission.LEVEL_NORMAL  # guarded-by: _ladder_lock
        # serializes qos applies end to end (compute → wire → record):
        # concurrent rung transitions must land their windows in order
        # or a stale one sticks; leaf lock, nothing nests inside it but
        # the client's own channel lock
        self._prefetch_apply_lock = threading.Lock()
        self._applied_prefetch = self._normal_prefetch  # guarded-by: _prefetch_apply_lock
        # set by run(); sheds re-try the declare while it stays False
        self._dlq_ready = False
        # /readyz: set once run() has the consume established, the DLQ
        # declared, and the workers spawned — the health server serves
        # 503 until then (and again during drain), distinct from the
        # liveness /healthz
        self.ready = threading.Event()
        # serve() confirms the cache plane attached (when configured)
        # before the job loop starts; /readyz reports it alongside
        self.data_plane_attached = True

    @property
    def worker_count(self) -> int:
        return len(self._workers)

    # -- job pipeline ----------------------------------------------------

    def process_delivery(self, delivery: Delivery) -> None:
        started = time.monotonic()
        # span tree per job: dequeue → decode → fetch → scan → upload →
        # publish → ack, rooted here; backend internals (tracker
        # announces, peer connects, webseed ranges, multipart parts)
        # attach as descendants. Lands on /debug/jobs and feeds the
        # per-stage latency histograms on completion. The trace adopts
        # the delivery's propagated X-Trace-Context, so a redelivered
        # attempt continues its logical job's ONE trace id.
        with tracing.TRACER.job(
            context=getattr(delivery, "trace_context", None)
        ) as trace:
            trace.record(
                "dequeue", delivery.received_at, started,
                queue=delivery.queue_name,
            )
            self._process_traced(delivery, trace, started)

    def _process_traced(
        self, delivery: Delivery, trace, started: float
    ) -> None:
        with tracing.span("decode"):
            try:
                job = Download.unmarshal(delivery.body)
            except WireError as exc:
                log.with_field("event", "decode-message").error(
                    "failed to unmarshal message into protobuf format", exc=exc
                )
                delivery.nack()  # reference cmd:108: drop malformed
                self.stats.bump(dropped=1)
                trace.set_status("dropped")
                return

        if job.media is None or not job.media.id or not job.media.source_uri:
            log.error("download job has no usable media block; dropping")
            delivery.nack()
            self.stats.bump(dropped=1)
            trace.set_status("dropped")
            return

        media = job.media
        job_class = delivery.job_class or self._config.admission_default_class
        trace.annotate(
            job_id=media.id, url=tracing.redact_url(media.source_uri),
            tenant=delivery.tenant, job_class=job_class,
        )
        job_log = log.with_fields(id=media.id, url=media.source_uri)
        job_log.info("got message")

        if delivery.retries > 0:
            # pace retried jobs (the reference slept 10 s on the worker
            # before republishing, delivery.go:75; we delay on consume so
            # the broker, not a timer, owns the in-flight message).
            # FULL-jitter capped exponential backoff: a shed-then-retry
            # wave failed in sync, and a deterministic delay would
            # re-arrive as the same thundering herd it came from
            delay = admission.full_jitter(
                delivery.retries - 1,
                self._config.retry_delay,
                self._config.retry_delay_cap,
            )
            with tracing.span(
                "retry-delay", retries=delivery.retries,
                jitter_s=round(delay, 3),
            ):
                cancelled = self._token.wait(delay)
            if cancelled:
                delivery.nack(requeue=True)  # shutting down; give it back
                trace.set_status("requeued")
                return

        # per-job cancellation: a child token so the stall watchdog can
        # release ONE wedged job (WATCHDOG_ACTION=cancel) without
        # touching its siblings; shutdown still cancels everything
        # through the parent. The job watch travels thread-locally like
        # the trace and the transfer sink — backends beat its stage
        # heartbeats as bytes actually flush.
        job_token = self._token.child()
        watch = watchdog.MONITOR.job(media.id, cancel=job_token.cancel)
        if watch.kind == "job":
            # the watchdog learns the job's lane: a stall incident tags
            # the offending tenant, and /debug/watchdog shows which
            # tenant's traffic is wedged
            watch.meta.update(tenant=delivery.tenant, job_class=job_class)
        try:
            with watchdog.install(watch):
                self._process_watched(
                    delivery, trace, media, job_log, job_token, watch, started
                )
        finally:
            watchdog.MONITOR.unregister(watch)
            # drop the job token from the daemon token's fan-out list,
            # or the parent accumulates one dead child per job forever
            job_token.detach()

    def _process_watched(
        self, delivery, trace, media, job_log, job_token, watch, started
    ) -> None:
        # streaming fetch→upload pipeline: the session consumes the
        # fetch backends' progress reports (write offsets, verified
        # piece spans) and ships S3 multipart parts while the fetch is
        # still running — job transfer time becomes max(fetch, upload)
        # instead of fetch + upload. None when PIPELINE=off; every
        # failure path converges on session.close(), which aborts any
        # speculative multipart upload not explicitly completed.
        session = self._uploader.streaming_session(media.id, job_token)
        try:
            watch.stage("fetch")
            mirrors = self._job_mirrors(delivery, media.source_uri)
            with tracing.span(
                "fetch", url=tracing.redact_url(media.source_uri),
                mirrors=len(mirrors),
            ), transfer_progress.install(session):
                # the kwarg rides only when the job actually has
                # mirrors, so mirror-less deployments keep the exact
                # call shape every existing dispatcher stub expects
                if mirrors:
                    job_dir = self._dispatcher.download(
                        media.id, media.source_uri, token=job_token,
                        mirrors=mirrors,
                    )
                else:
                    job_dir = self._dispatcher.download(
                        media.id, media.source_uri, token=job_token
                    )
            watch.stage("scan")
            with tracing.span("scan"):
                files = scan_dir(job_dir)
            job_log.with_field("count", len(files)).info("found media files")
            watch.stage("upload")
            with tracing.span("upload", files=len(files)):
                # completes streams the scan accepted, aborts streams
                # it rejected; completed files skip store-and-forward
                streamed = session.finalize(files) if session else {}
                self._uploader.upload_files(
                    job_token, media.id, files, streamed=streamed
                )
        except UnsupportedJobError as exc:
            job_log.error("unsupported job; dropping", exc=exc)
            delivery.nack()
            self.stats.bump(dropped=1)
            trace.set_status("dropped")
            return
        except (TransferError, UploadError, OSError) as exc:
            self._settle_transient(delivery, job_log, trace, exc)
            return
        except Cancelled:
            if not self._token.cancelled():
                # job-level cancel with the daemon still running: the
                # watchdog released a stalled job. Retry it like any
                # transient failure (capped), not like a shutdown — the
                # broker pacing gives the stall cause time to clear.
                self._settle_transient(
                    delivery, job_log, trace,
                    Cancelled("watchdog cancelled stalled job"),
                )
                return
            # shutdown mid-job: requeue so another instance picks it up
            delivery.nack(requeue=True)
            trace.set_status("requeued")
            return
        finally:
            if session is not None:
                session.close()

        # crash-matrix boundary: a kill here dies after fetch/scan/
        # upload but before the Convert hand-off; fail mode routes the
        # job through the normal transient-retry path
        if FAILPOINTS.fire("daemon.pre_publish"):
            self._settle_transient(
                delivery, job_log, trace,
                TransferError("failpoint: daemon.pre_publish"),
            )
            return
        log.info("creating v1.convert message")
        convert = Convert(
            created_at=time.strftime("%Y-%m-%d %H:%M:%S %z"), media=media
        )
        # the confirm wait is where a wedged publisher thread surfaces:
        # no publish progress inside the deadline flags THIS job's
        # publish stage (the publisher loop has its own watch too).
        # The job token rides along so WATCHDOG_ACTION=cancel releases
        # a job wedged HERE too — the wait returns unconfirmed and the
        # job requeues, instead of the cancel being logged but the
        # worker staying blocked to the full confirm timeout
        watch.stage("publish")
        with tracing.span("publish"):
            confirmed = self._client.publish(
                self._publish_topic_for(delivery),
                convert.marshal(),
                wait=self._config.publish_confirm_timeout,
                cancel=job_token,
            )
        if not confirmed:
            # the Convert hand-off is the job's whole point: never ack a
            # download whose pipeline hand-off is not durably on the
            # broker (an unflushed in-memory buffer dies with the
            # process). Requeue; re-running the job is at-least-once.
            job_log.error("convert publish unconfirmed; requeueing job")
            delivery.nack(requeue=True)
            self.stats.bump(retried=1)
            trace.set_status("requeued")
            return
        job_log.info("finished processing")
        watch.stage("ack")
        # crash-matrix boundary: a kill here dies with the Convert
        # durably published but the original unacked — the duplicate-
        # delivery window at-least-once promises to survive. Fail mode
        # requeues, modeling the ack frame never reaching the broker.
        if FAILPOINTS.fire("daemon.pre_ack"):
            delivery.nack(requeue=True)
            self.stats.bump(retried=1)
            trace.set_status("requeued")
            return
        with tracing.span("ack"):
            delivery.ack()
        self.stats.bump(processed=1)
        trace.set_status("ok")
        # completed-job latency histogram (consume -> ack, including
        # the confirm-gated Convert hand-off); failed/retried attempts
        # are deliberately not mixed in — they would bimodalize the
        # distribution an operator alerts on
        elapsed = time.monotonic() - started
        metrics.GLOBAL.observe("job_duration_seconds", elapsed)
        self._observe_slo(delivery, elapsed, trace_id=trace.trace_id)

    def _job_mirrors(self, delivery: Delivery, url: str) -> "tuple[str, ...]":
        """The mirror URLs riding this job: the producer's X-Mirrors
        header first (it knows the object), the worker's MIRROR_URLS
        fallback second, deduplicated against the primary and capped at
        MIRROR_MAX. The fetch layer vets each one against the primary's
        probe before a single span is assigned to it."""
        from ..fetch import sources

        return sources.merge_mirrors(
            url,
            getattr(delivery, "mirrors", ()),
            self._config.mirror_urls,
            cap=self._config.mirror_max,
        )

    def _observe_slo(
        self, delivery: Delivery, elapsed: float, trace_id: str = ""
    ) -> None:
        """Per-class SLO latency histogram: the series an operator
        actually alerts on — interactive p99 must hold while bulk is
        allowed to degrade, so the two classes must never share one
        distribution. ``trace_id`` rides as an exemplar (one bounded
        deque append) so a firing burn alert links straight to example
        traces instead of a bare percentile."""
        job_class = delivery.job_class or self._config.admission_default_class
        if job_class == admission.CANARY_CLASS:
            # synthetic probes must never enter the histograms the user
            # SLO burn rules read — the canary plane has its own
            # canary_* series (utils/canary.py)
            return
        metrics.GLOBAL.observe(
            f"slo_job_duration_seconds_{job_class}",
            elapsed,
            exemplar=trace_id,
        )

    def _publish_topic_for(self, delivery: Delivery) -> str:
        """Canary Converts land on a parallel ``<topic>.canary[.
        <instance>]`` lane the PROBING instance's prober consumes
        (utils/canary.py, carried on its reply-to header — in a fleet
        any worker may process the probe): downstream Convert consumers
        never see synthetic media, while the hand-off itself rides the
        same confirm-gated publisher as user traffic. The reply topic
        is honored only under the canary prefix, so a crafted header
        can never redirect a Convert onto the user topic."""
        if delivery.job_class == admission.CANARY_CLASS:
            fallback = f"{self._config.publish_topic}.canary"
            reply = delivery.message.headers.get(
                canary.REPLY_TOPIC_HEADER
            )
            if isinstance(reply, bytes):
                try:
                    reply = reply.decode("ascii")
                except UnicodeDecodeError:
                    reply = None
            if isinstance(reply, str) and reply.startswith(fallback):
                return reply
            return fallback
        return self._config.publish_topic

    def _settle_transient(self, delivery, job_log, trace, exc) -> None:
        """One retry-or-drop policy for every transient job failure —
        transfer/upload errors and watchdog-cancelled stalls alike."""
        if delivery.retries < self._config.max_job_retries:
            job_log.with_field("retries", delivery.retries).error(
                "job failed; scheduling retry", exc=exc
            )
            with tracing.span("retry-republish"):
                delivery.error()
            self.stats.bump(retried=1)
            trace.set_status("retried")
        else:
            job_log.error(
                f"job failed after {delivery.retries} retries; dropping",
                exc=exc,
            )
            delivery.nack()
            self.stats.bump(failed=1)
            trace.set_status("failed")

    # -- batched small-object fast path -----------------------------------

    def _settle_crashed(self, delivery: Delivery, exc: Exception) -> None:
        """The never-kill-the-worker backstop: settle a delivery whose
        processing raised outside the caught exceptions, capped like
        the normal failure path — a poison message that crashes would
        otherwise retry forever."""
        log.error("unexpected error processing job", exc=exc)
        if delivery.settled:
            return
        if delivery.retries < self._config.max_job_retries:
            delivery.error()
            self.stats.bump(retried=1)
        else:
            delivery.nack()
            self.stats.bump(failed=1)

    def _process_safely(self, delivery: Delivery) -> None:
        try:
            self.process_delivery(delivery)
        except Exception as exc:  # never kill the worker thread
            self._settle_crashed(delivery, exc)

    def _collect_batch(
        self, first: Delivery, deliveries: "queue_mod.Queue[Delivery]"
    ) -> "list[Delivery]":
        """One dequeue wave: greedily drain deliveries ALREADY waiting
        behind ``first`` (up to BATCH_JOBS); once at least one more was
        waiting — a burst is in progress — linger up to BATCH_WAIT_MS
        for the rest of it. A lone job never waits, so unbatched
        latency is untouched."""
        limit = self._config.batch_jobs
        batch = [first]
        if limit <= 1:
            return batch
        while len(batch) < limit:
            try:
                batch.append(deliveries.get_nowait())
            except queue_mod.Empty:
                break
        if len(batch) == 1 or len(batch) >= limit:
            return batch
        deadline = time.monotonic() + self._config.batch_wait_ms / 1000.0
        while len(batch) < limit and not self._token.cancelled():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(deliveries.get(timeout=remaining))
            except queue_mod.Empty:
                break
        return batch

    def _peek_media(self, delivery: Delivery):
        """Classification-only decode (is this a small HTTP job?). The
        slow lane re-decodes under its trace so the malformed-message
        handling stays in exactly one place; the ~30 µs duplicate is
        noise against the round trips batching removes."""
        try:
            job = Download.unmarshal(delivery.body)
        except WireError:
            return None
        media = job.media
        if media is None or not media.id or not media.source_uri:
            return None
        return media

    # the fast lane defers every ack to the batch settle, so the wave's
    # cumulative bytes bound how long deliveries stay unacked (and how
    # much disk one settle window can touch): a wave admits fast-lane
    # jobs up to this many ceiling-sized objects' worth of bytes —
    # many tiny jobs still fill the whole wave, a run of near-ceiling
    # ones overflows to the normal per-job path
    WAVE_BYTE_BUDGET_FACTOR = 4

    # total seconds one admission wave may spend on byte-quota size
    # probes (one stalling probe can still run to its own HTTP timeout;
    # the budget stops the NEXT ones from stacking on top of it)
    WAVE_PROBE_BUDGET_S = 2.0

    def process_batch(self, batch: "list[Delivery]") -> None:
        """Process one dequeue wave. Singleton waves take the unbatched
        path bit-for-bit. Larger waves are classified by (cached-)
        probed object size: jobs at most BATCH_MAX_BYTES — bounded by
        the wave byte budget (``WAVE_BYTE_BUDGET_FACTOR × BATCH_MAX_
        BYTES`` cumulative) — run the batched fast lane; everything
        else (large, unknown size, retry pacing, non-HTTP, malformed)
        runs the normal per-job pipeline, untouched. Every delivery is
        settled by exactly one lane."""
        if len(batch) == 1:
            self._process_safely(batch[0])
            return
        fast: "list[tuple[Delivery, object]]" = []
        slow: "list[Delivery]" = []
        budget = self._config.batch_max_bytes * self.WAVE_BYTE_BUDGET_FACTOR
        admitted = 0
        for delivery in batch:
            media = self._peek_media(delivery)
            if media is None or delivery.retries > 0:
                slow.append(delivery)
                continue
            try:
                # the daemon token (no per-job token exists yet): a
                # shutdown mid-classification aborts the probe promptly
                size = self._dispatcher.probe_size(
                    media.source_uri, token=self._token
                )
            except Exception as exc:
                # classification must never decide a job's fate: an
                # unprobeable URL just takes the normal path
                log.debug(f"batch size probe failed for {media.id}: {exc}")
                size = None
            if (
                size is None
                or size > self._config.batch_max_bytes
                or admitted + size > budget
            ):
                slow.append(delivery)
                continue
            admitted += size
            fast.append((delivery, media))
        if len(fast) < 2:
            # nothing to amortize: the whole wave runs unbatched
            for delivery in batch:
                self._process_safely(delivery)
            return
        metrics.GLOBAL.observe(
            "batch_jobs_per_wave", len(fast), buckets=metrics.COUNT_BUCKETS
        )
        self._process_fast_batch(fast)
        for delivery in slow:
            self._process_safely(delivery)

    def _process_fast_batch(
        self, jobs: "list[tuple[Delivery, object]]"
    ) -> None:
        """The batched lane. Per-job traces, watches, and child cancel
        tokens keep observability and cancel isolation identical to
        the unbatched path; what amortizes is the traffic — one store
        connection scope for all the PUTs, ONE publish-confirm wait
        covering the batch's Convert hand-offs, and a multiple-ack
        settle. A mid-batch failure settles only its own delivery."""
        ready: "list[_FastJob]" = []
        with self._uploader.batch_scope():
            for delivery, media in jobs:
                if self._token.cancelled():
                    delivery.nack(requeue=True)  # shutting down
                    continue
                # the batch lane is itself a budgeted resource: when
                # ADMISSION_BATCH_SLOTS is exhausted the job runs the
                # normal per-job path instead — slower, but it doesn't
                # widen the deferred-ack settle window. The slot is
                # refunded when the delivery settles, whatever settles
                # it (ack, retry, shed, crash backstop).
                slot_key = admission.batch_slot_key()
                if not admission.LEDGER.try_charge(
                    "batch_slots", slot_key, 1
                ):
                    metrics.GLOBAL.add("admission_batch_slot_denials")
                    self._process_safely(delivery)
                    continue
                delivery.add_settle_hook(
                    lambda key=slot_key: admission.LEDGER.refund(key)
                )
                try:
                    outcome = self._run_fast_job(delivery, media)
                except Exception as exc:  # never kill the batch
                    self._settle_crashed(delivery, exc)
                    continue
                if outcome is _FALLBACK:
                    self._process_safely(delivery)
                elif outcome is not None:
                    ready.append(outcome)
                # jobs already parked at their publish stage see the
                # batch advancing — the wave moving IS their forward
                # progress, so a long tail of batch-mates doesn't read
                # as a publish stall (slow != stalled)
                for state in ready:
                    state.watch.beat()
        if not ready:
            return
        # ONE confirm wait covers every Convert hand-off in the batch;
        # unconfirmed jobs requeue individually — never ack a download
        # whose pipeline hand-off is not durably on the broker
        confirmed = self._client.flush(
            [state.pending for state in ready],
            self._config.publish_confirm_timeout,
            cancel=_AnyCancelled([state.token for state in ready]),
        )
        acks: "list[_FastJob]" = []
        for state, flushed in zip(ready, confirmed):
            state.publish_span.finish()
            if flushed:
                # per-job crash-matrix boundary, mirroring the
                # unbatched pre-ack seam: confirmed publish, unacked
                # original (fail mode = the ack frame never made it)
                if FAILPOINTS.fire("daemon.pre_ack"):
                    state.delivery.nack(requeue=True)
                    self.stats.bump(retried=1)
                    state.trace.root.set_status("requeued")
                    self._finish_fast_job(state)
                    continue
                acks.append(state)
                continue
            state.job_log.error("convert publish unconfirmed; requeueing job")
            state.delivery.nack(requeue=True)
            self.stats.bump(retried=1)
            state.trace.root.set_status("requeued")
            self._finish_fast_job(state)
        if not acks:
            return
        for state in acks:
            state.watch.stage("ack")
        ack_started = time.monotonic()
        ack_batch([state.delivery for state in acks])
        ack_ended = time.monotonic()
        metrics.GLOBAL.add("batch_fast_jobs", len(acks))
        for state in acks:
            # the coalesced settle is shared wall time; each trace
            # records the interval so /debug/jobs still shows it
            state.trace.root.record("ack", ack_started, ack_ended)
            state.job_log.info("finished processing")
            state.trace.root.set_status("ok")
            # the exemplar id must be read BEFORE complete() hands the
            # trace to the ring (the OpenTrace forgets it on settle)
            trace_id = state.trace.trace_id
            self._finish_fast_job(state)
            self.stats.bump(processed=1)
            elapsed = time.monotonic() - state.started
            metrics.GLOBAL.observe("job_duration_seconds", elapsed)
            self._observe_slo(state.delivery, elapsed, trace_id=trace_id)

    def _finish_fast_job(self, state: "_FastJob") -> None:
        state.trace.complete()
        watchdog.MONITOR.unregister(state.watch)
        # drop the job token from the daemon token's fan-out list, or
        # the parent accumulates one dead child per job forever
        state.token.detach()

    def _run_fast_job(self, delivery: Delivery, media):
        """One fast-lane job through fetch→scan→upload plus the ASYNC
        Convert enqueue. Returns the open ``_FastJob`` for the batch
        settle, ``_FALLBACK`` when the fast path declined late, or None
        when the job was settled here — the failure paths mirror
        ``_process_watched``'s semantics exactly."""
        started = time.monotonic()
        trace = tracing.TRACER.open_job(
            media.id, context=getattr(delivery, "trace_context", None)
        )
        job_token = self._token.child()
        watch = watchdog.MONITOR.job(media.id, cancel=job_token.cancel)
        job_class = delivery.job_class or self._config.admission_default_class
        if watch.kind == "job":
            watch.meta.update(tenant=delivery.tenant, job_class=job_class)
        job_log = log.with_fields(id=media.id, url=media.source_uri)
        keep = False
        try:
            with trace.activate():
                root = trace.root
                root.annotate(
                    job_id=media.id,
                    url=tracing.redact_url(media.source_uri),
                    batched=True,
                    tenant=delivery.tenant,
                    job_class=job_class,
                )
                root.record(
                    "dequeue", delivery.received_at, started,
                    queue=delivery.queue_name,
                )
                job_log.info("got message")
                try:
                    with watchdog.install(watch):
                        watch.stage("fetch")
                        with tracing.span(
                            "fetch",
                            url=tracing.redact_url(media.source_uri),
                            fast_path=True,
                        ):
                            job_dir = self._dispatcher.fast_fetch(
                                media.id,
                                media.source_uri,
                                self._config.batch_max_bytes,
                                token=job_token,
                            )
                        if job_dir is not None:
                            watch.stage("scan")
                            with tracing.span("scan"):
                                files = scan_dir(job_dir)
                            job_log.with_field("count", len(files)).info(
                                "found media files"
                            )
                            watch.stage("upload")
                            with tracing.span("upload", files=len(files)):
                                # small objects are single PUTs on the
                                # batch's scoped store connection; no
                                # streaming session exists to close
                                self._uploader.upload_files(
                                    job_token, media.id, files
                                )
                except (TransferError, UploadError, OSError) as exc:
                    self._settle_transient(delivery, job_log, root, exc)
                    return None
                except Cancelled:
                    if not self._token.cancelled():
                        # watchdog released THIS job; its batch-mates
                        # are untouched (their own tokens, own settles)
                        self._settle_transient(
                            delivery, job_log, root,
                            Cancelled("watchdog cancelled stalled job"),
                        )
                        return None
                    delivery.nack(requeue=True)
                    root.set_status("requeued")
                    return None
                if job_dir is None:
                    root.set_status("fallback")
                    return _FALLBACK
                # same crash-matrix boundary as the unbatched lane
                if FAILPOINTS.fire("daemon.pre_publish"):
                    self._settle_transient(
                        delivery, job_log, root,
                        TransferError("failpoint: daemon.pre_publish"),
                    )
                    return None
                log.info("creating v1.convert message")
                watch.stage("publish")
                convert = Convert(
                    created_at=time.strftime("%Y-%m-%d %H:%M:%S %z"),
                    media=media,
                )
                # opened now, finished after the batch flush: the span
                # covers enqueue→confirmed, same interval the unbatched
                # publish span measures
                publish_span = root.child("publish", coalesced=True)
                pending = self._client.publish_async(
                    self._publish_topic_for(delivery), convert.marshal()
                )
                keep = True
                return _FastJob(
                    delivery=delivery,
                    media=media,
                    trace=trace,
                    watch=watch,
                    token=job_token,
                    job_log=job_log,
                    started=started,
                    publish_span=publish_span,
                    pending=pending,
                )
        except BaseException:
            if trace.status == "in-flight":
                trace.root.set_status("error")
            raise
        finally:
            if not keep:
                trace.complete()
                watchdog.MONITOR.unregister(watch)
                job_token.detach()

    # -- admission: weighted-fair waves, quotas, the shed path -------------

    def _quota_size(self, delivery: Delivery) -> "int | None":
        """Probed object size for the tenant byte quota — consulted
        only when a byte quota is configured (the probe cache makes
        repeats free; an unprobeable job charges zero bytes rather
        than letting classification decide its fate)."""
        media = self._peek_media(delivery)
        if media is None:
            return None
        try:
            return self._dispatcher.probe_size(
                media.source_uri, token=self._token
            )
        except Exception as exc:
            log.debug(f"quota size probe failed: {exc}")
            return None

    def _park_cap(self) -> int:
        """How many paused-bulk deliveries may sit parked in lanes —
        one wave's worth. Parked deliveries stay unacked, so the cap
        also bounds how far the qos window must stretch to keep
        interactive deliveries flowing past them."""
        return max(1, self._config.batch_jobs)

    def _ladder_prefetch(self, level: int) -> "int | None":
        """The qos window the current rung wants. Below shrink: the
        normal window. At shrink and above: the configured floor PLUS
        the parked-bulk population — parked deliveries hold unacked
        slots inside the window, and a window smaller than the parked
        count wedges delivery entirely (the broker would never hand
        the worker another interactive job: the head-of-line blocking
        this layer exists to prevent)."""
        if self._normal_prefetch is None:
            return None
        if level < admission.LEVEL_SHRINK:
            return self._normal_prefetch
        floor = max(1, self._config.admission_min_prefetch)
        # the parked term applies at EVERY engaged rung, not just
        # pause: bulk parked during a pause episode stays unacked
        # after pressure eases to the shrink rung, and a window
        # without the parked term would wedge behind it until the
        # idle-tick waves drained every parked transfer
        parked = admission.CONTROLLER.scheduler.pending({"bulk"})
        return floor + min(parked, self._park_cap())

    def _apply_ladder(self, level: int) -> None:
        """Walk the degradation ladder's first rung: shrink the
        prefetch window under pressure (an overloaded worker must stop
        amplifying its own backlog), restore it when pressure clears.
        The later rungs (pause bulk, shed) act per job in the wave
        builder."""
        with self._ladder_lock:
            previous = self._ladder_level
            self._ladder_level = level
        shrink = admission.LEVEL_SHRINK
        if level >= shrink and previous < shrink:
            log.with_fields(
                level=level, pressure=round(admission.LEDGER.pressure(), 3)
            ).warning("admission ladder engaged: shrinking prefetch")
        elif level < shrink and previous >= shrink:
            log.info("admission pressure cleared: prefetch restored")
        if self._normal_prefetch is None:
            return
        with self._prefetch_apply_lock:
            # compute INSIDE the serialization, from the freshest
            # recorded rung: a desired window computed outside could
            # be applied after a racing transition's, sticking a stale
            # window on the wire
            with self._ladder_lock:
                current = self._ladder_level
            desired = self._ladder_prefetch(current)
            if desired is not None and desired != self._applied_prefetch:
                self._client.apply_prefetch(desired)
                self._applied_prefetch = desired

    def _admit_wave(self, batch: "list[Delivery]") -> "list[Delivery]":
        """Order the dequeue wave with deficit round-robin across
        (class, tenant) lanes, then run every candidate through the
        admission verdict: admitted jobs form the processing wave
        (quota release wired to settlement), deferred bulk re-parks in
        its lane, rejected jobs shed to the DLQ right here."""
        controller = admission.CONTROLLER
        rung = controller.level()  # the whole wave sees ONE ladder rung
        shed_any = False
        park_cap = self._park_cap()
        direct: "list[Delivery]" = []  # in no lane; must ride this wave
        for delivery in batch:
            try:
                if delivery.job_class is None:
                    delivery.job_class = self._config.admission_default_class
                if (
                    rung == admission.LEVEL_PAUSE_BULK
                    and delivery.job_class == "bulk"
                    and controller.scheduler.pending({"bulk"}) >= park_cap
                ):
                    # the paused lane is full: parking more would wedge
                    # the shrunk qos window (parked unacked >= window)
                    # AND grow worker memory unboundedly — overflow
                    # walks the ladder's next rung instead
                    shed_any = True
                    self._shed_delivery(delivery, "bulk-paused-overflow")
                    continue
                controller.scheduler.offer(
                    delivery, delivery.job_class, delivery.tenant
                )
            except Exception as exc:
                # a delivery that reached neither a lane nor the DLQ
                # would sit unacked forever; fail OPEN into the wave
                log.with_fields(tenant=delivery.tenant).warning(
                    f"admission intake failed; admitting job: {exc}"
                )
                if not delivery.settled:
                    direct.append(delivery)
        try:
            # the window must reflect this wave's parked population
            # before the broker decides whether to hand us more; a
            # failed qos frame degrades the window, not the wave
            self._apply_ladder(rung)
        except Exception as exc:
            log.warning(f"admission ladder apply failed: {exc}")
        # pause parks bulk ONLY at its own rung: at the shed rung bulk
        # candidates must still flow through decide() so the explicit
        # shed-to-DLQ verdict (not an ever-growing parked lane) is what
        # answers exhaustion
        paused = (
            frozenset(("bulk",))
            if rung == admission.LEVEL_PAUSE_BULK
            else frozenset()
        )
        candidates = controller.scheduler.take(
            max(1, self._config.batch_jobs), paused
        )
        wave: "list[Delivery]" = []
        # the byte-quota size probe is a synchronous HEAD against the
        # job's own (possibly hostile, possibly slow) origin: bound the
        # wave's total probe spend so one tenant's stalling origin
        # cannot hold the whole wave — interactive probes first (DRR
        # order); past the budget, candidates charge zero bytes (the
        # job-count quota still binds), mirroring the unprobeable case
        probe_deadline = time.monotonic() + self.WAVE_PROBE_BUDGET_S
        for delivery in candidates:
            try:
                # cheap verdicts first: a candidate the job-count quota
                # or the ladder rejects anyway must not spend a HEAD
                # probe against its (possibly hostile) origin out of
                # the wave's budget
                decision = controller.precheck(
                    delivery.job_class, delivery.tenant, rung
                )
                if decision is None:
                    size = (
                        self._quota_size(delivery)
                        if controller.quota_bytes > 0
                        and time.monotonic() < probe_deadline
                        else None
                    )
                    decision = controller.decide(
                        delivery.job_class, delivery.tenant, size, rung=rung
                    )
                if decision.action == "admit":
                    delivery.add_settle_hook(decision.release)
                    wave.append(delivery)
                elif decision.action == "defer":
                    # unreachable with a frozen wave rung (paused bulk
                    # lanes are never taken at the defer-producing
                    # rung); kept so a defer verdict from a future
                    # live-rung decide parks instead of falling into
                    # the shed arm
                    controller.scheduler.offer(
                        delivery, delivery.job_class, delivery.tenant
                    )
                else:
                    shed_any = True
                    self._shed_delivery(delivery, decision.reason)
            except Exception as exc:
                # a broken verdict must never strand a taken delivery
                # unacked (it is in no lane now); fail OPEN into the
                # wave — over-admitting degrades, stranding deadlocks
                log.with_fields(tenant=delivery.tenant).warning(
                    f"admission decision failed; admitting job: {exc}"
                )
                if not delivery.settled and delivery not in wave:
                    wave.append(delivery)
        if not shed_any:
            controller.note_calm()
        return wave + direct

    def _shed_delivery(self, delivery: Delivery, reason: str) -> None:
        """Execute one shed verdict: DLQ with Retry-After + capped
        redelivery. The first shed of an overload episode captures an
        incident bundle (on its own thread — the wave may still carry
        interactive jobs that must not wait on a flight recorder)."""
        config = self._config
        if delivery.job_class == admission.CANARY_CLASS:
            # DLQ hygiene: a shed synthetic probe must never accumulate
            # in the dead-letter queue (nothing will ever drain it) —
            # ack it away and count it as the failed probe it is: its
            # Convert will never arrive
            try:
                job_id = Download.unmarshal(delivery.body).media.id
            except WireError:
                job_id = "canary-unknown"
            delivery.ack()
            canary.note_shed(job_id, reason)
            self.stats.bump(shed=1)
            log.with_fields(job_id=job_id, reason=reason).warning(
                "canary probe shed; self-cleaned instead of dead-lettering"
            )
            return
        if not self._dlq_ready:
            # startup raced a down broker and the declare never
            # happened: re-try it now, and if the DLQ still does not
            # exist, DO NOT shed — an unroutable default-exchange
            # publish still CONFIRMS (the broker drops it), so the
            # "unconfirmable hand-off requeues" safety never engages
            # and the job would be silently lost
            self._dlq_ready = self._client.ensure_queue(
                config.dead_letter_queue
            )
        if not self._dlq_ready:
            log.with_fields(tenant=delivery.tenant, reason=reason).warning(
                "DLQ not declared; requeueing instead of shedding"
            )
            delivery.nack(requeue=True)
            return
        retry_after = admission.retry_after_for(
            delivery.shed_count,
            config.dlq_retry_after_base,
            config.dlq_retry_after_cap,
        )
        outcome = delivery.shed(
            config.dead_letter_queue,
            reason,
            retry_after,
            max_sheds=config.dlq_max_redeliver,
        )
        if outcome == "already-settled":
            # a watchdog cancel or crash backstop settled the delivery
            # between the lane take and this verdict: nothing was shed,
            # nothing bounced — not an event
            return
        if outcome == "requeued":
            # the DLQ hand-off never confirmed: the job went back to
            # the broker, so nothing was actually shed — counting it
            # would let jobs_shed outrun dlq_published and burn the
            # episode's one incident capture on a non-event
            log.with_fields(
                tenant=delivery.tenant, reason=reason,
            ).warning("shed hand-off unconfirmed; job requeued instead")
            return
        if admission.CONTROLLER.note_shed(delivery.tenant, reason):
            context = getattr(delivery, "trace_context", None)
            extra = {
                "tenant": delivery.tenant,
                "job_class": delivery.job_class,
                "shed_reason": reason,
                "tripped_budget": admission.LEDGER.tripped(),
                "pressure": round(admission.LEDGER.pressure(), 4),
                # the shed job's logical identity: the incident bundle
                # and the DLQ message it describes share this id
                "trace_id": context.trace_id if context else None,
            }

            def _capture():
                try:
                    bundle = incident.RECORDER.capture(
                        f"admission shed ({reason})",
                        trigger="admission",
                        extra=extra,
                    )
                    if bundle is None:
                        # suppressed by the recorder's shared auto rate
                        # limit: don't burn the episode's one capture on it
                        admission.CONTROLLER.rearm_episode()
                except Exception as exc:
                    log.warning(f"admission incident capture failed: {exc}")

            try:
                threading.Thread(
                    target=_capture, name="admission-capture", daemon=True
                ).start()
            except RuntimeError:
                # thread exhaustion IS the overload regime; capture
                # inline rather than losing the episode's one bundle
                _capture()
        self.stats.bump(shed=1)
        log.with_fields(
            tenant=delivery.tenant, job_class=delivery.job_class or "",
            reason=reason, outcome=outcome, retry_after_s=retry_after,
        ).warning("admission shed job to the dead-letter queue")

    # -- worker loop -----------------------------------------------------

    def _worker(self, deliveries: "queue_mod.Queue[Delivery]") -> None:
        # dequeue-liveness watch: this loop ticks at >= 5 Hz when idle,
        # so a worker thread that stops iterating OUTSIDE a job (the
        # job watch owns in-job time) reads as wedged
        watch = watchdog.MONITOR.loop(
            f"{threading.current_thread().name}-dequeue"
        )
        try:
            while not self._token.cancelled():
                watch.beat()
                try:
                    delivery = deliveries.get(timeout=0.2)
                except queue_mod.Empty:
                    delivery = None
                    if admission.CONTROLLER.scheduler.pending() == 0:
                        # an idle tick also closes any open overload
                        # episode (pressure permitting) — _admit_wave
                        # never runs again on a drained queue, and the
                        # NEXT overload's first shed must capture a
                        # fresh incident
                        admission.CONTROLLER.note_calm()
                        continue
                    # parked lane work (deferred bulk, a deeper wave
                    # than one take could admit): build a wave from
                    # the lanes alone
                with watch.suspend():
                    batch = (
                        self._collect_batch(delivery, deliveries)
                        if delivery is not None
                        else []
                    )
                    try:
                        wave = self._admit_wave(batch)
                    except Exception as exc:  # never kill the worker thread
                        # last-resort backstop: intake, ladder, and
                        # verdicts all fail open INSIDE _admit_wave, so
                        # reaching here means the lane take itself blew
                        # up — the batch is already offered into the
                        # shared lanes, where the next tick (any
                        # worker's) picks it up; re-processing it here
                        # would double-run deliveries other workers can
                        # also take
                        log.warning(f"admission wave failed: {exc}")
                        wave = []
                    if not wave:
                        continue
                    try:
                        self.process_batch(wave)
                    except Exception as exc:  # never kill the worker thread
                        for stranded in wave:
                            if not stranded.settled:
                                self._settle_crashed(stranded, exc)
        finally:
            watchdog.MONITOR.unregister(watch)

    def run(self) -> None:
        """Start consuming; returns once cancellation completes drain."""
        deliveries = self._client.consume(self._config.consume_topic)
        # the DLQ must exist before the first shed: the default
        # exchange silently drops messages routed to undeclared queues
        self._dlq_ready = self._client.ensure_queue(
            self._config.dead_letter_queue
        )
        for index in range(max(1, self._config.concurrency)):
            worker = threading.Thread(  # thread-role: job-worker
                target=self._worker,
                args=(deliveries,),
                name=f"job-worker-{index}",
                daemon=True,
            )
            worker.start()
            # profile attribution: samples of this thread read as the
            # job-worker role, not an anonymous Thread-N
            profiling.ROLES.register_thread(worker, "job-worker")
            self._workers.append(worker)
        log.with_field("workers", len(self._workers)).info("job loop running")
        # /readyz flips here: the consume is established, the DLQ
        # declared (or its retry armed), and the workers are draining
        self.ready.set()

        self._token.wait()  # block until cancelled
        self.ready.clear()  # draining; not ready for traffic
        for worker in self._workers:
            # deadline: runs after cancellation — every worker blocking op is bounded (dequeue poll, socket timeouts, watchdog cancel) and the loop exits on the cancelled token
            worker.join()
        # stop the shard consumers FIRST: closing their channels requeues
        # everything unacked at the broker and stops redelivery. Only then
        # settle the deliveries stranded in the sink — nacking them while
        # a consumer is still live would bounce each message straight
        # back into the sink in a hot loop until the drain timeout.
        self._client.stop_consuming()
        # deliveries parked in admission lanes (paused bulk, deferred
        # quota waiters) go back to the broker like the sink leftovers
        for parked in admission.CONTROLLER.scheduler.drain():
            parked.nack(requeue=True)
        while True:
            try:
                leftover = deliveries.get_nowait()
            except queue_mod.Empty:
                break
            leftover.nack(requeue=True)  # channel closed → already requeued
        self._client.done()
        log.info("finished shutdown")


# ---------------------------------------------------------------------------
# wiring


def capture_stall_incident(watch, stage: str, idle: float) -> None:
    """The watchdog→flight-recorder hand-off: a stall episode captures
    one bounded incident bundle (utils/incident.py rate-limits mass
    stalls) carrying the job's trace, thread stacks, and subsystem
    internals — tagged with the stalled job's lane (tenant + class),
    so a wedged tenant is identifiable from the bundle alone."""
    meta = dict(getattr(watch, "meta", None) or {})
    tenant = meta.get("tenant")
    if tenant:
        # lane bookkeeping: /debug/admission shows which tenants have
        # stalled jobs (the quota itself refunds on settlement, so a
        # cancelled stall frees its slot instead of leaking it)
        admission.CONTROLLER.note_stall(tenant)
    incident.RECORDER.capture(
        reason=(
            f"watchdog: no forward progress in stage '{stage}' "
            f"for {idle:.1f}s"
        ),
        job_id=watch.name if watch.kind == "job" else None,
        trigger="watchdog",
        extra={
            "watch": watch.name, "kind": watch.kind, "stage": stage,
            **meta,
        },
    )


def build_connection_factory(config: Config):
    if config.broker == "memory":
        from ..queue.memory import MemoryBroker

        broker = MemoryBroker()
        return broker.connect
    if config.broker == "amqp":
        from ..queue.amqp import AmqpConnection

        def connect():
            return AmqpConnection.dial(
                config.amqp_endpoint,
                username=config.amqp_username,
                password=config.amqp_password,
            )

        return connect
    raise ValueError(f"unknown BROKER '{config.broker}'")


def serve(
    base_dir: str | None = None,
    bucket: str | None = None,
    concurrency: int | None = None,
    config: Config | None = None,
    token: CancelToken | None = None,
    install_signal_handlers: bool = True,
) -> int:
    """Run the full daemon until SIGINT/SIGTERM/SIGHUP (reference
    cmd:158-170)."""
    configure_from_env()
    config = config or Config.from_env()
    if base_dir:
        config.base_dir = base_dir
    if bucket:
        config.bucket = bucket
    if concurrency:
        config.concurrency = concurrency

    tracing.TRACER.enabled = config.trace
    tracing.TRACER.set_capacity(config.trace_ring)
    tracing.TRACER.propagate = config.trace_propagate

    # fault injection (utils/failpoints.py): with no FAILPOINT_SPEC the
    # seams stay named no-ops; armed, every injection is a pure function
    # of FAILPOINT_SEED so a chaos run reproduces from its seed
    FAILPOINTS.configure_from_env()

    # flow accounting (utils/flows.py): the byte-attribution ledger the
    # fetch/store seams report into; sizing knobs (hitters, origin and
    # object cardinality caps) come from FLOW_* env vars
    from ..utils import flows

    flows.LEDGER.configure_from_env()

    # telemetry plane: the local time-series store samples the registry
    # on an interval, and the alert engine evaluates burn-rate/threshold
    # rules over it — both liveness-watched loops, both off when their
    # interval is 0
    from ..utils import alerts, tsdb

    metrics.FEDERATION.instance = config.instance
    tsdb.STORE.configure(
        interval_s=config.tsdb_interval,
        samples=config.tsdb_samples,
        downsample=config.tsdb_downsample,
    )
    alerts.ENGINE.configure(
        rules=alerts.default_rules(
            slo_interactive_s=config.alert_slo_interactive_s,
            slo_bulk_s=config.alert_slo_bulk_s,
            objective=config.alert_objective,
            fast_window_s=config.alert_fast_window,
            slow_window_s=config.alert_slow_window,
            factor=config.alert_burn_factor,
        ),
        interval_s=config.alert_interval,
        store=tsdb.STORE,
    )

    # stall watchdog + incident flight recorder: stages report progress
    # heartbeats; a job whose active stage stops advancing for
    # WATCHDOG_STALL_S is flagged (and under WATCHDOG_ACTION=cancel,
    # released through its per-job token), capturing an incident bundle
    incident.RECORDER.configure(
        directory=config.incident_dir, keep=config.incident_keep
    )
    watchdog.MONITOR.configure(
        stall_s=config.watchdog_stall_s,
        action=config.watchdog_action,
        stage_overrides=config.watchdog_stages,
        on_stall=capture_stall_incident,
    )
    # continuous profiling plane: the sampler attributes every thread
    # stack to its registered role (the spawn surfaces below register
    # as they start), lock-wait histograms accrue on /metrics, and
    # /debug/profile serves flamegraphs — PROFILE=0 turns all of it
    # into no-op stubs
    profiling.configure(
        enabled=config.profile,
        interval_ms=config.profile_interval_ms,
        ring=config.profile_ring,
        heap_interval_s=config.profile_heap_s,
        heap_top=config.profile_heap_top,
        heap_frames=config.profile_heap_frames,
    )
    profiling.ROLES.register_current("daemon-main")

    watchdog.MONITOR.start()
    tsdb.STORE.start()
    alerts.ENGINE.start()
    profiling.PROFILER.start()

    token = token or CancelToken()
    if install_signal_handlers:
        def handle(signum, frame):
            log.info("shutting down")
            token.cancel()

        for signum in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
            signal.signal(signum, handle)

    log.info("connecting to broker ...")
    client = QueueClient(
        token,
        build_connection_factory(config),
        publish_confirm_timeout=config.publish_confirm_timeout,
    )
    prefetch = config.prefetch
    if config.batch_jobs > 1 and prefetch < config.batch_jobs:
        # a dequeue wave can never exceed the consumer's unacked
        # window: with the reference-default prefetch of 1 the batched
        # fast path would silently never engage. Give it headroom;
        # operators who want a strict window set BATCH_JOBS=1.
        prefetch = config.batch_jobs
        log.with_fields(
            prefetch=prefetch, batch_jobs=config.batch_jobs
        ).info("raising prefetch to the batch size for the fast path")
    client.set_prefetch(prefetch)
    log.info("connected")

    from ..cli import _default_backends

    # the HTTP fetch knobs come from Config (one parse, logged here)
    # rather than each backend re-reading the environment: segmented
    # fetch shape is operator-visible capacity planning (segments ×
    # jobs concurrent connections against origin servers)
    backends = _default_backends(
        shared_dht=True,
        http_segments=config.http_segments,
        http_pool_per_host=config.http_pool_per_host,
        http_pool_idle=config.http_pool_idle,
    )
    log.with_fields(
        segments=config.http_segments,
        pool_per_host=config.http_pool_per_host,
        pool_idle=config.http_pool_idle,
    ).info("http fetch: segmented ranges + keep-alive pool configured")
    # fleet data plane (store/cas.py + fetch/singleflight.py): when a
    # cache root is configured, both fetch lanes front origin with the
    # shared content cache + cross-process single-flight election. The
    # registry pins the lease index under the cache root unless the
    # supervisor handed down an explicit SINGLEFLIGHT_DIR.
    data_plane = None
    if config.cache_dir:
        from ..fetch.singleflight import (
            CoalescingDataPlane,
            LeaseRegistry,
            activate,
        )
        from ..store.cas import ContentStore

        registry = LeaseRegistry(
            config.singleflight_dir
            or os.path.join(os.path.abspath(config.cache_dir), "inflight"),
            lease_ttl_s=config.singleflight_lease_s,
            instance=config.instance,
        )
        content_store = ContentStore(
            config.cache_dir,
            max_bytes=config.cache_max_bytes,
            ttl_s=config.cache_ttl_s,
            pinned=registry.is_leased,
        )
        data_plane = CoalescingDataPlane(
            content_store, registry, wait_s=config.singleflight_wait_s
        )
        activate(data_plane)
        log.with_fields(
            cache_dir=config.cache_dir,
            max_bytes=config.cache_max_bytes,
            lease_s=config.singleflight_lease_s,
        ).info("fleet data plane: content cache + single-flight armed")
    dispatcher = DispatchClient(
        token, config.base_dir, backends, data_plane=data_plane
    )
    uploader = Uploader.from_env(config.bucket)

    daemon = Daemon(token, client, dispatcher, uploader, config)
    # when a cache plane is configured, it attached above (or serve()
    # would have raised); /readyz reports the verdict either way
    daemon.data_plane_attached = data_plane is not None or not config.cache_dir

    # synthetic canary plane (utils/canary.py): the prober mints
    # known-content probe jobs onto this worker's OWN consume topic —
    # riding the real queue→admission→fetch→scan→upload→publish path —
    # and verifies them from the outside. CANARY=0 builds none of it.
    prober = None
    if config.canary:
        prober = canary.CanaryProber(
            client,
            uploader,
            consume_topic=config.consume_topic,
            publish_topic=config.publish_topic,
            interval_s=config.canary_interval_s,
            timeout_s=config.canary_timeout_s,
            history=config.canary_history,
            object_bytes=config.canary_object_bytes,
            instance=config.instance,
        )
        canary.ACTIVE = prober

    health = None
    if config.health_port > 0:
        from .health import HealthServer

        health = HealthServer(
            daemon, client, config.health_port, config.health_host
        ).start()
    # fleet membership: the supervisor handed down a heartbeat-file
    # path; the writer thread feeds the parent's liveness verdicts
    # (wall-clock beat + publisher gauge + watchdog stalled count)
    heartbeat = None
    if config.fleet_heartbeat_file:
        from .fleet import HeartbeatWriter

        heartbeat = HeartbeatWriter(
            config.fleet_heartbeat_file,
            config.fleet_heartbeat_s,
            health_port=health.port if health is not None else 0,
        ).start()
    if prober is not None:
        prober.start()
    try:
        daemon.run()
    finally:
        # the prober goes FIRST: it publishes onto the consume topic
        # and waits on Converts — both lanes are closing down behind it
        if prober is not None:
            canary.ACTIVE = None
            prober.stop()
        if heartbeat is not None:
            heartbeat.stop()
        profiling.PROFILER.stop()
        alerts.ENGINE.stop()
        tsdb.STORE.stop()
        watchdog.MONITOR.stop()
        if health is not None:
            health.stop()
        uploader.close()  # drains the streaming pipeline's part pool
        for backend in backends:
            backend_close = getattr(backend, "close", None)
            if backend_close is not None:
                backend_close()
        if data_plane is not None:
            from ..fetch.singleflight import activate

            activate(None)
            # refunds this process's ledger charges; entries stay on
            # shared disk as idle capacity for the next life
            data_plane.store.close()
    return 0
