"""Synthetic canary plane: active end-to-end probes the passive planes
cannot fake.

Every other observability layer — tracing, watchdog/incidents, TSDB +
burn alerts, profiling, the fleet debug plane, flow accounting — is
passive: it reports what instrumented code *self-reports*, so a
silent-wrong path (a cache serving stale bytes, an upload landing
corrupt, a Convert publish quietly dropped) shows green on every
dashboard. The canary plane closes that gap with ACTIVE probing:

- A **prober thread** mints synthetic jobs with known deterministic
  content against an in-tree :class:`SyntheticOrigin` and publishes
  them onto the worker's REAL consume topic, so every probe rides the
  full queue → admission → fetch (+cache/single-flight) → scan →
  upload → publish path — no bespoke shortcut lane. Probes run as
  cold/warm PAIRS: the cold probe exercises the origin lane, the warm
  repeat the CAS hit lane, so cache integrity is probed continuously,
  not just at ``cas.lookup`` time.
- Probes carry the dedicated ``canary`` job class
  (:data:`admission.CANARY_CLASS`), EXCLUDED from the user SLO
  histograms, the flow ledger's amplification ratio, and the
  heavy-hitter sketch — synthetic bytes must never skew production
  signals. The daemon routes canary Converts to the probing
  instance's private ``<PUBLISH_TOPIC>.canary.<instance>`` lane
  (carried on :data:`REPLY_TOPIC_HEADER` — in a fleet ANY worker may
  process the probe, and a shared lane would let a sibling's prober
  steal the Convert), so downstream consumers never see them.
- Verification happens from the OUTSIDE: the prober consumes its own
  Convert (metadata + ORIGINAL trace id checked), then reads the
  uploaded object back from the store and compares it byte-for-byte
  against the known payload — the round trip a failpoint-injected
  silent corruption (``canary.corrupt`` in store/uploader.py) cannot
  survive.
- Golden signals land in ``canary_*`` series: ``canary_probes_total``
  / ``canary_probe_failures_total`` (availability),
  ``canary_e2e_seconds`` (latency, trace-id exemplars attached), and
  the ``canary_failing`` gauge (correctness) the ``canary-failure``
  page rule and its fleet twin threshold. The first failed probe of
  an episode captures one rate-limited incident bundle naming the
  instance; ``/debug/canary`` serves the last-N per-stage verdicts.

``CANARY=0`` builds nothing: :data:`ACTIVE` stays None and the
daemon-side hooks (:func:`note_shed`) are one ``is None`` check — the
whole plane rides under the same ≤0.5 ms/job overhead bar as the
watchdog/telemetry/profiling/flow planes.
"""

from __future__ import annotations

import hashlib
import http.server
import os
import re
import threading
import time
from collections import deque

from . import flows, incident, metrics, profiling, tracing, watchdog
from .logging import get_logger

log = get_logger("canary")

DEFAULT_INTERVAL_S = 60.0
DEFAULT_TIMEOUT_S = 30.0
DEFAULT_HISTORY = 32
DEFAULT_OBJECT_BYTES = 64 * 1024

# probes are tenant-isolated too: canary jobs must never eat a real
# tenant's quota, and a quota-shed canary must name itself
CANARY_TENANT = "canary"

# the probe's reply-to lane rides a header: in a fleet, ANY worker may
# dequeue the probe, and the Convert must come back to the PROBING
# instance's private lane — a shared .canary lane would let a sibling
# prober consume (and discard) another instance's verdict
REPLY_TOPIC_HEADER = "X-Canary-Reply-To"

# the worker's live prober (set by daemon serve() when CANARY is on);
# daemon hooks read it through note_shed() — one None check when off
ACTIVE: "CanaryProber | None" = None


def _bool_env(env, name: str) -> bool:
    raw = (env.get(name) or "").strip().lower()
    return raw not in ("0", "off", "false", "no")


def enabled_from_env(environ=None) -> bool:
    """``CANARY``: the whole plane; ``0``/``off`` builds no prober, no
    origin, no hooks — only no-op stubs."""
    env = os.environ if environ is None else environ
    return _bool_env(env, "CANARY")


def interval_from_env(environ=None) -> float:
    """``CANARY_INTERVAL_S``: seconds between probe pairs (the
    detection-latency bound the corruption e2e holds the plane to)."""
    env = os.environ if environ is None else environ
    raw = (env.get("CANARY_INTERVAL_S") or "").strip()
    if not raw:
        return DEFAULT_INTERVAL_S
    try:
        return max(0.05, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CANARY_INTERVAL_S (want seconds)"
        )
        return DEFAULT_INTERVAL_S


def timeout_from_env(environ=None) -> float:
    """``CANARY_TIMEOUT_S``: how long one probe may wait for its
    Convert before the probe counts as failed (availability)."""
    env = os.environ if environ is None else environ
    raw = (env.get("CANARY_TIMEOUT_S") or "").strip()
    if not raw:
        return DEFAULT_TIMEOUT_S
    try:
        return max(0.05, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CANARY_TIMEOUT_S (want seconds)"
        )
        return DEFAULT_TIMEOUT_S


def history_from_env(environ=None) -> int:
    """``CANARY_HISTORY``: probe verdicts kept for ``/debug/canary``."""
    env = os.environ if environ is None else environ
    raw = (env.get("CANARY_HISTORY") or "").strip()
    if not raw:
        return DEFAULT_HISTORY
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CANARY_HISTORY (want an integer)"
        )
        return DEFAULT_HISTORY


def object_bytes_from_env(environ=None) -> int:
    """``CANARY_OBJECT_BYTES``: synthetic payload size per probe."""
    env = os.environ if environ is None else environ
    raw = (env.get("CANARY_OBJECT_BYTES") or "").strip()
    if not raw:
        return DEFAULT_OBJECT_BYTES
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CANARY_OBJECT_BYTES (want bytes)"
        )
        return DEFAULT_OBJECT_BYTES


def probe_payload(seed: str, size: int) -> bytes:
    """Deterministic known content: a sha256-keyed stream of ``seed``.
    Both ends derive the same bytes from the probe name alone, so the
    verifier never has to trust anything the data path stored."""
    out = bytearray()
    counter = 0
    while len(out) < size:
        out += hashlib.sha256(f"{seed}:{counter}".encode()).digest()
        counter += 1
    return bytes(out[:size])


def note_shed(job_id: str, reason: str = "shed") -> None:
    """Daemon hook: a canary delivery shed/dead-lettered must count as
    a failed probe (it never reaches the Convert the prober waits on)
    — and must self-clean instead of accumulating in the DLQ. One
    ``is None`` check when the plane is off."""
    prober = ACTIVE
    if prober is not None:
        prober.note_shed(job_id, reason)


class SyntheticOrigin:
    """The in-tree known-content origin: a loopback HTTP server the
    prober registers each probe's payload on (HEAD for the size probe,
    GET for the body — the same surface any real origin presents to
    the fetch backends). Paths end ``.mkv`` so the scan gate accepts
    the synthetic media."""

    def __init__(self, host: str = "127.0.0.1"):
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_HEAD(self):
                self._serve(send_body=False)

            def do_GET(self):
                self._serve(send_body=True)

            def _serve(self, send_body: bool):
                profiling.ROLES.register_current("canary-origin")
                with origin._lock:
                    payload = origin._payloads.get(self.path)
                if payload is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()
                if send_body:
                    self.wfile.write(payload)

        self._lock = threading.Lock()
        self._payloads: "dict[str, bytes]" = {}  # guarded-by: _lock
        self._httpd = http.server.ThreadingHTTPServer((host, 0), Handler)
        self._host = host
        self._thread = threading.Thread(  # thread-role: canary-origin
            target=self._httpd.serve_forever, name="canary-origin",
            daemon=True,
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def url_for(self, path: str) -> str:
        return f"http://{self._host}:{self.port}{path}"

    def register(self, path: str, payload: bytes) -> str:
        with self._lock:
            self._payloads[path] = payload
        return self.url_for(path)

    def unregister(self, path: str) -> None:
        with self._lock:
            self._payloads.pop(path, None)

    def start(self) -> "SyntheticOrigin":
        self._thread.start()
        profiling.ROLES.register_thread(self._thread, "canary-origin")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class CanaryProber:
    """The worker-level prober: a thread minting cold/warm probe pairs
    every ``interval_s`` (or on demand via ``POST
    /debug/canary/probe`` — how the fleet scheduler localizes a sick
    instance), each probe published onto the real consume topic and
    verified from the outside (Convert metadata + trace id, then a
    byte-for-byte store read-back)."""

    def __init__(
        self,
        client,
        uploader,
        consume_topic: str,
        publish_topic: str,
        interval_s: float = DEFAULT_INTERVAL_S,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        history: int = DEFAULT_HISTORY,
        object_bytes: int = DEFAULT_OBJECT_BYTES,
        origin: "SyntheticOrigin | None" = None,
        instance: "str | None" = None,
    ):
        self._client = client
        self._uploader = uploader
        self._consume_topic = consume_topic
        self.interval_s = max(0.05, interval_s)
        self.timeout_s = max(0.05, timeout_s)
        self.object_bytes = max(1, object_bytes)
        self.instance = (
            instance
            if instance is not None
            else metrics.FEDERATION.instance
        )
        # the instance-private Convert lane (see REPLY_TOPIC_HEADER);
        # the instance name is sanitized into a safe topic token
        lane = re.sub(r"[^A-Za-z0-9._-]", "-", self.instance or "")
        self._canary_topic = (
            f"{publish_topic}.canary.{lane}"
            if lane
            else f"{publish_topic}.canary"
        )
        self._owns_origin = origin is None
        self.origin = origin if origin is not None else SyntheticOrigin()
        self._lock = threading.Lock()
        self._history: "deque[dict]" = deque(maxlen=max(1, history))  # guarded-by: _lock
        self._failing = False  # guarded-by: _lock
        self._counter = 0  # guarded-by: _lock
        self._pending: "dict[str, float]" = {}  # in-flight probe ids; guarded-by: _lock
        self._stop = threading.Event()
        self._trigger = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._converts = None  # the .canary topic sink, bound at start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "CanaryProber":
        if self._owns_origin:
            self.origin.start()
        # consume the canary Convert lane up front: the subscription
        # must exist before the first probe's Convert can land
        self._converts = self._client.consume(self._canary_topic)
        metrics.GLOBAL.gauge_set("canary_failing", 0.0)
        thread = threading.Thread(  # thread-role: canary-prober
            target=self._run, name="canary-prober", daemon=True
        )
        self._thread = thread
        thread.start()
        profiling.ROLES.register_thread(thread, "canary-prober")
        log.with_fields(
            interval_s=self.interval_s, origin_port=self.origin.port
        ).info("canary prober running")
        return self

    def stop(self) -> None:
        self._stop.set()
        self._trigger.set()
        thread = self._thread
        if thread is not None:
            # deadline: the loop waits on the trigger event in interval slices and every probe stage is bounded by timeout_s
            thread.join(timeout=2 * self.timeout_s + 5.0)
        if self._owns_origin:
            self.origin.stop()

    def trigger(self) -> None:
        """One immediate probe pair (the POST /debug/canary/probe
        path); returns without waiting for the verdict — it lands in
        the scorecard and the canary_* series."""
        self._trigger.set()

    def _run(self) -> None:
        watch = watchdog.MONITOR.loop("canary-prober")
        try:
            # the first pair waits a full interval: a worker that lives
            # shorter than CANARY_INTERVAL_S (tests, one-shot runs)
            # never pays for a probe it could not have verified
            while not self._stop.is_set():
                self._trigger.wait(self.interval_s)
                self._trigger.clear()
                if self._stop.is_set():
                    return
                watch.beat()
                try:
                    self.run_probe_pair()
                except Exception as exc:
                    # a prober bug is a failed probe, never a dead plane
                    log.error("canary probe pair crashed", exc=exc)
                    self._record(
                        self._verdict(
                            "crashed", "cold", error=f"prober crashed: {exc}"
                        )
                    )
        finally:
            watchdog.MONITOR.unregister(watch)

    # -- probing -----------------------------------------------------------

    def run_probe_pair(self) -> "list[dict]":
        """One cold + one warm probe of the SAME content: the cold leg
        rides the origin lane, the warm repeat the CAS hit lane (when
        a cache is attached; without one it is simply a second origin
        round trip). Returns both verdicts (tests call this
        synchronously)."""
        with self._lock:
            self._counter += 1
            counter = self._counter
        seed = f"{self.instance}:{counter}"
        payload = probe_payload(seed, self.object_bytes)
        token = hashlib.sha256(seed.encode()).hexdigest()[:16]
        path = f"/canary/{token}.mkv"
        url = self.origin.register(path, payload)
        try:
            verdicts = [
                self.probe_once(f"canary-{token}-cold", url, payload, "cold"),
                self.probe_once(f"canary-{token}-warm", url, payload, "warm"),
            ]
        finally:
            self.origin.unregister(path)
        return verdicts

    def probe_once(
        self, probe_id: str, url: str, payload: bytes, kind: str
    ) -> dict:
        """One synthetic job through the REAL path, verified from the
        outside. Stages (each a verdict field): ``publish`` (the
        Download landed on the consume topic, confirmed), ``convert``
        (the Convert arrived on the canary lane with correct metadata
        and the ORIGINAL trace id), ``integrity`` (the uploaded object
        read back byte-for-byte equal to the known payload)."""
        from ..queue.delivery import CLASS_HEADER, TENANT_HEADER
        from ..wire import Download, Media
        from .admission import CANARY_CLASS

        # exclusion must be registered BEFORE any canary byte moves:
        # the fetch seams key the ledger by redacted-URL object key,
        # the pipeline's egress by the S3 object key
        flows.LEDGER.exclude(flows.object_key(tracing.redact_url(url)))
        context = tracing.TraceContext.mint()
        verdict = self._verdict(probe_id, kind, trace_id=context.trace_id)
        with self._lock:
            self._pending[probe_id] = time.monotonic()
        start = time.monotonic()
        try:
            download = Download(
                media=Media(id=probe_id, source_uri=url)
            )
            headers = {
                CLASS_HEADER: CANARY_CLASS,
                TENANT_HEADER: CANARY_TENANT,
                REPLY_TOPIC_HEADER: self._canary_topic,
                tracing.TRACE_CONTEXT_HEADER: context.header_value(),
            }
            confirmed = self._client.publish(
                self._consume_topic,
                download.marshal(),
                headers=headers,
                wait=self.timeout_s,
            )
            if not confirmed:
                return self._fail(verdict, "publish", "publish unconfirmed")
            verdict["stages"]["publish"] = True
            convert_error = self._await_convert(probe_id, url, context)
            if convert_error is not None:
                return self._fail(verdict, "convert", convert_error)
            verdict["stages"]["convert"] = True
            integrity_error = self._verify_object(probe_id, url, payload)
            if integrity_error is not None:
                return self._fail(verdict, "integrity", integrity_error)
            verdict["stages"]["integrity"] = True
        finally:
            with self._lock:
                self._pending.pop(probe_id, None)
        verdict["ok"] = True
        verdict["e2e_s"] = round(time.monotonic() - start, 6)
        metrics.GLOBAL.observe(
            "canary_e2e_seconds",
            time.monotonic() - start,
            exemplar=context.trace_id,
        )
        self._record(verdict)
        return verdict

    def _await_convert(
        self, probe_id: str, url: str, context
    ) -> "str | None":
        """Drain the canary Convert lane until this probe's message
        arrives (stale Converts from earlier timed-out probes are
        acked and skipped); verify metadata and the original trace
        id. Returns the failure reason, None on success."""
        import queue as queue_mod

        from ..wire import Convert, WireError

        sink = self._converts
        if sink is None:
            return "canary convert lane not consuming"
        deadline = time.monotonic() + self.timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return f"no Convert within {self.timeout_s:g}s"
            try:
                delivery = sink.get(timeout=min(remaining, 0.5))
            except queue_mod.Empty:
                continue
            try:
                convert = Convert.unmarshal(delivery.body)
            except WireError as exc:
                delivery.ack()
                return f"undecodable Convert: {exc}"
            if convert.media.id != probe_id:
                # an earlier probe's straggler: self-clean and keep
                # waiting for ours
                delivery.ack()
                continue
            delivery.ack()
            if convert.media.source_uri != url:
                return (
                    "Convert metadata wrong: source_uri "
                    f"{convert.media.source_uri!r}"
                )
            if not convert.created_at:
                return "Convert metadata wrong: empty created_at"
            if delivery.trace_context.trace_id != context.trace_id:
                return (
                    "trace id not propagated: Convert carried "
                    f"{delivery.trace_context.trace_id}"
                )
            return None

    def _verify_object(
        self, probe_id: str, url: str, payload: bytes
    ) -> "str | None":
        """The outside-in integrity check: read the uploaded object
        back from the store and compare byte-for-byte against the
        known payload — the check a silently corrupt upload cannot
        pass."""
        from urllib.parse import urlsplit

        from ..store.uploader import object_key

        filename = os.path.basename(urlsplit(url).path)
        key = object_key(probe_id, filename)
        flows.LEDGER.exclude(flows.object_key(key))
        try:
            stored = self._uploader.read_back(key)
        except Exception as exc:
            return f"store read-back failed: {exc}"
        if hashlib.sha256(stored).digest() != hashlib.sha256(
            payload
        ).digest() or stored != payload:
            return (
                f"integrity mismatch: stored {len(stored)} bytes, "
                f"sha256 {hashlib.sha256(stored).hexdigest()[:12]} != "
                f"{hashlib.sha256(payload).hexdigest()[:12]}"
            )
        return None

    # -- verdicts ----------------------------------------------------------

    @staticmethod
    def _verdict(
        probe_id: str, kind: str, trace_id: str = "", error: "str | None" = None
    ) -> dict:
        return {
            "probe": probe_id,
            "kind": kind,
            "ok": False,
            "stages": {"publish": False, "convert": False,
                       "integrity": False},
            "e2e_s": None,
            "trace_id": trace_id,
            "error": error,
            "ts": time.time(),
        }

    def _fail(self, verdict: dict, stage: str, reason: str) -> dict:
        verdict["error"] = f"{stage}: {reason}"
        self._record(verdict)
        return verdict

    def note_shed(self, job_id: str, reason: str = "shed") -> None:
        """A shed canary delivery: count the failed probe NOW (its
        Convert will never arrive) under its own verdict."""
        with self._lock:
            pending = job_id in self._pending
        verdict = self._verdict(job_id, "shed", error=f"shed: {reason}")
        verdict["pending"] = pending
        self._record(verdict)

    def _record(self, verdict: dict) -> None:
        metrics.GLOBAL.add("canary_probes_total")
        with self._lock:
            self._history.append(verdict)
        if verdict["ok"]:
            with self._lock:
                cleared = self._failing
                self._failing = False
            metrics.GLOBAL.gauge_set("canary_failing", 0.0)
            if cleared:
                log.with_fields(probe=verdict["probe"]).info(
                    "canary episode cleared"
                )
            return
        metrics.GLOBAL.add("canary_probe_failures_total")
        with self._lock:
            first = not self._failing
            self._failing = True
        metrics.GLOBAL.gauge_set("canary_failing", 1.0)
        entry = log.with_fields(
            probe=verdict["probe"], kind=verdict["kind"]
        )
        entry.error(f"canary probe failed ({verdict['error']})")
        if first:
            # first failure of the episode: one evidence bundle, rate
            # limited like every automatic trigger, naming the instance
            incident.RECORDER.capture(
                f"canary probe failed: {verdict['error']}",
                job_id=verdict["probe"],
                trigger="canary",
                extra={"instance": self.instance, "verdict": dict(verdict)},
            )

    @property
    def failing(self) -> bool:
        with self._lock:
            return self._failing

    def scorecard(self) -> dict:
        """The ``/debug/canary`` view: last-N verdicts (per-stage),
        the live episode state, and the knobs that bound detection
        latency."""
        counters = metrics.GLOBAL.snapshot()
        with self._lock:
            probes = [dict(v) for v in self._history]
            failing = self._failing
            pending = len(self._pending)
        return {
            "instance": self.instance,
            "failing": failing,
            "pending_probes": pending,
            "interval_s": self.interval_s,
            "timeout_s": self.timeout_s,
            "object_bytes": self.object_bytes,
            "probes_total": counters.get("canary_probes_total", 0),
            "failures_total": counters.get("canary_probe_failures_total", 0),
            "probes": probes,
        }
