#!/usr/bin/env python3
"""The port's fleet rig and its SIGKILL-mid-coalesce cell.

The rig drives a real fleet of one package: a loopback origin (HEAD,
Range, an optional throttle), the worker environment, job publishing
with a producer-minted trace context, and the ``Convert`` sink. Every
helper takes a package namespace (``pkg``: the modules ``fleet``,
``stub``, ``amqp_server``, ``metrics``, ``tracing`` and ``wire``, and
``creds``), so the port's fleet tests drive both packages through it;
this module itself imports the port alone (``PORT``).

``leader_kill`` is the coalesce cell: a seeded kill failpoint
(``LEADER_KILL_SPEC``) SIGKILLs the elected coalesce leader mid-fetch,
a follower promotes itself and re-leads from the journaled spans, and
the supervisor restarts the dead worker. Run as a script, it drives
the port's fleet once and prints one JSON line with the verdict and
the top-level modules the process imported; it exits 1 when the
verdict fails. ``hack/failpoint_matrix_torch.py`` runs it so.

Usage: python hack/fleet_torch.py [workdir]
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import socketserver
import sys
import tempfile
import threading
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from downloader_tpu_torch import wire  # noqa: E402
from downloader_tpu_torch.daemon import fleet  # noqa: E402
from downloader_tpu_torch.queue import amqp_server  # noqa: E402
from downloader_tpu_torch.store import Credentials, stub  # noqa: E402
from downloader_tpu_torch.utils import metrics, tracing  # noqa: E402

BUCKET = "fleet-bkt"
# dies on the 17th 256 KiB chunk write (~4 MB in); only an elected
# leader writes, and the promoted successor resumes the journal with
# fewer than 16 chunks left
LEADER_KILL_SPEC = "segments.pwrite=kill:1:16"
LEADER_KILL_BYTES = 6 * 1024 * 1024
LEADER_KILL_SEED = 21

PORT = types.SimpleNamespace(
    name="downloader_tpu_torch", fleet=fleet, stub=stub, amqp_server=amqp_server,
    metrics=metrics, tracing=tracing, wire=wire,
    creds=Credentials(access_key="ak", secret_key="sk"),
)


def payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, np.uint8).tobytes()


def wait(predicate, timeout: float, what: str, interval: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


class Origin:
    """Threaded HTTP origin serving a dict of path -> payload, with HEAD
    and (optionally throttled) GET incl. Range support; counts data GETs
    per path."""

    def __init__(self, objects, rate_bps: float = 0.0):
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                body = origin.objects.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                body = origin.objects.get(self.path)
                with origin.lock:
                    origin.gets[self.path] = origin.gets.get(self.path, 0) + 1
                if body is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                start, end = 0, len(body)
                header = self.headers.get("Range")
                if header and header.startswith("bytes="):
                    lo, _, hi = header[len("bytes="):].partition("-")
                    start = int(lo) if lo else 0
                    end = int(hi) + 1 if hi else len(body)
                    self.send_response(206)
                    self.send_header("Content-Range", f"bytes {start}-{end - 1}/{len(body)}")
                else:
                    self.send_response(200)
                self.send_header("Content-Length", str(end - start))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()
                window = body[start:end]
                chunk = 64 * 1024
                for offset in range(0, len(window), chunk):
                    piece = window[offset:offset + chunk]
                    try:
                        self.wfile.write(piece)
                        self.wfile.flush()
                    except OSError:
                        return
                    if origin.rate_bps > 0:
                        time.sleep(len(piece) / origin.rate_bps)

        self.objects = dict(objects)
        self.rate_bps = rate_bps
        self.gets = {}
        self.lock = threading.Lock()
        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def data_gets(self) -> int:
        with self.lock:
            return sum(self.gets.values())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def worker_env(pkg, broker, s3, base_dir, **extra):
    env = {
        "BROKER": "amqp",
        "RABBITMQ_ENDPOINT": broker.endpoint,
        "RABBITMQ_USERNAME": "",
        "RABBITMQ_PASSWORD": "",
        "S3_ENDPOINT": f"http://{s3.endpoint}",
        "S3_ACCESS_KEY": pkg.creds.access_key,
        "S3_SECRET_KEY": pkg.creds.secret_key,
        "BUCKET": BUCKET,
        "DOWNLOAD_DIR": base_dir,
        "JOB_CONCURRENCY": "1",
        "PREFETCH": "4",
        "BATCH_JOBS": "1",
        "HTTP_SEGMENTS": "1",
        "S3_MULTIPART_THRESHOLD": str(128 * 1024),
        "S3_PART_SIZE": str(128 * 1024),
        "PROFILE": "0",
        "TSDB_INTERVAL": "off",
        "ALERT_INTERVAL": "off",
        "LSD": "off",
        "DHT_BOOTSTRAP": "off",
        "WATCHDOG_STALL_S": "60",
        "MAX_JOB_RETRIES": "6",
        "RETRY_DELAY": "0.1",
        "RETRY_DELAY_CAP": "0.5",
        "PUBLISH_CONFIRM_TIMEOUT": "10",
        "FAILPOINT_SPEC": "",
        "LOG_LEVEL": "info",
    }
    env.update(extra)
    return env


def cache_env(pkg, broker, s3, base_dir, **extra):
    """``worker_env`` with the shared content cache and single-flight
    coalescing armed."""
    env = worker_env(
        pkg, broker, s3, base_dir, BUCKET=BUCKET, PREFETCH="1", WATCHDOG_STALL_S="600",
        MAX_JOB_RETRIES="50", RETRY_DELAY="0.3", RETRY_DELAY_CAP="1.0",
        S3_MULTIPART_THRESHOLD=str(256 * 1024), S3_PART_SIZE=str(256 * 1024),
        CACHE_DIR=os.path.join(base_dir, "shared-cache"), SINGLEFLIGHT_LEASE_S="2.0",
        SINGLEFLIGHT_WAIT_S="120",
    )
    env.update(extra)
    return env


def fleet_config(pkg, workers=2, **overrides):
    base = dict(workers=workers, heartbeat_s=0.2, stall_s=30.0, restart_backoff_s=0.1,
                restart_backoff_cap_s=0.5, start_grace_s=40.0, drain_s=10.0,
                scrape_timeout_s=2.0)
    base.update(overrides)
    return pkg.fleet.FleetConfig(**base)


def declare_topology(channel, topic: str) -> None:
    channel.declare_exchange(topic)
    for index in range(2):
        name = f"{topic}-{index}"
        channel.declare_queue(name)
        channel.bind_queue(name, topic, name)


def publish_job(pkg, broker, media_id: str, url: str, job_class: str = ""):
    """Publish one Download with a producer-minted trace context (the
    continuity anchor every redelivery must preserve); topology is
    declared first so a not-yet-started worker can't lose it."""
    context = pkg.tracing.TraceContext.mint()
    headers = {pkg.tracing.TRACE_CONTEXT_HEADER: context.header_value()}
    if job_class:
        headers["X-Job-Class"] = job_class
    connection = broker.broker.connect()
    try:
        channel = connection.channel()
        declare_topology(channel, "v1.download")
        body = pkg.wire.Download(media=pkg.wire.Media(id=media_id, source_uri=url)).marshal()
        channel.publish("v1.download", "v1.download-0", body, headers=headers, persistent=True)
        channel.close()
    finally:
        connection.close()
    return context


class ConvertSink:
    """Consumes both v1.convert shards: (media id, trace id) pairs as
    workers publish them, and each Convert's media bytes."""

    def __init__(self, pkg, broker):
        self.received = []
        self.media = []
        self.stamped = True
        self._lock = threading.Lock()
        self._connection = broker.broker.connect()
        channel = self._connection.channel()
        channel.set_prefetch(200)
        declare_topology(channel, "v1.convert")
        tracing = pkg.tracing

        def on_message(message, ch=channel):
            convert = pkg.wire.Convert.unmarshal(message.body)
            context = tracing.TraceContext.parse(message.headers.get(tracing.TRACE_CONTEXT_HEADER))
            with self._lock:
                self.received.append((convert.media.id if convert.media else "",
                                      context.trace_id if context else ""))
                self.media.append(convert.media)
                self.stamped = self.stamped and bool(convert.created_at)
            ch.ack(message.delivery_tag)

        for index in range(2):
            channel.consume(f"v1.convert-{index}", on_message)

    def snapshot(self):
        with self._lock:
            return list(self.received)

    def converts(self, origin_url: str):
        """The distinct Convert media payloads, sorted, with the run's
        loopback origin written as ``ORIGIN`` (a redelivered job may
        publish twice: at-least-once)."""
        with self._lock:
            media = list(self.media)
        out = set()
        for entry in media:
            if entry is not None:
                entry.source_uri = entry.source_uri.replace(origin_url, "ORIGIN")
            out.add(b"" if entry is None else entry.marshal())
        return sorted(out)

    def close(self):
        self._connection.close()


def http_get(port: int, path: str, timeout: float = 10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        response = conn.getresponse()
        return response.status, response.read()
    finally:
        conn.close()


def stored(s3) -> dict:
    """The bucket's objects, but for the canary plane's own probes."""
    return {key: bytes(data) for key, data in s3.buckets.get(BUCKET, {}).items()
            if not key.startswith("canary-")}


def counter(pkg, name: str) -> float:
    return pkg.metrics.GLOBAL.snapshot().get(name, 0)


def leader_kill(pkg, body, workdir):
    """Four identical jobs of ``body`` through a 2-worker fleet of
    ``pkg`` with the coalesce leader SIGKILLed mid-fetch: the outcome
    (worker restarted, follower promoted, stored objects, Converts,
    open multipart uploads)."""
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            Origin({"/hot.mp4": body}, rate_bps=1536 * 1024) as origin:
        supervisor = pkg.fleet.FleetSupervisor(
            fleet_config(pkg, stall_s=2.0),
            worker_env=cache_env(
                pkg, broker, s3, str(workdir),
                FAILPOINT_SPEC=LEADER_KILL_SPEC, HTTP_SEGMENTS="2",
                HTTP_SEGMENT_MIN_MB="1", SINGLEFLIGHT_LEASE_S="1.0", WATCHDOG_STALL_S="60",
            ),
        )
        sink = health = None
        try:
            supervisor.start()
            wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 60.0,
                 "both real workers ready")
            sink = ConvertSink(pkg, broker)
            contexts = {f"chaos-{index}": publish_job(pkg, broker, f"chaos-{index}",
                                                      f"{origin.url}/hot.mp4")
                        for index in range(4)}
            wait(lambda: {e[0] for e in sink.snapshot()} >= set(contexts), 180.0,
                 "the crowd to complete through the leader's death")
            foreign = [e for e in sink.snapshot()
                       if e[0] in contexts and e[1] != contexts[e[0]].trace_id]
            assert not foreign, f"trace-id continuity broken: {foreign}"
            health = pkg.fleet.FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            federated = wait(lambda: http_get(health.port, "/metrics/federate")[1], 30.0,
                             "the fleet exposition").decode()
            promotions = sum(float(line.rsplit(" ", 1)[1]) for line in federated.splitlines()
                             if line.startswith("downloader_singleflight_promotions_total"))
            wait(lambda: not s3.list_multipart_uploads(), 30.0,
                 "dangling multipart uploads to be reclaimed")
            return {
                "restarted": counter(pkg, "fleet_worker_restarts") >= 1,
                "promoted": promotions >= 1,
                "objects": stored(s3),
                "converts": sink.converts(origin.url),
                "dangling": s3.list_multipart_uploads(),
            }
        finally:
            if health is not None:
                health.stop()
            if sink is not None:
                sink.close()
            supervisor.drain()


def leader_kill_failures(outcome, body) -> list:
    """What a ``leader_kill`` outcome breaks of the cell's acceptance:
    the dead worker restarted, a follower promoted, the four jobs stored
    as ``body``, no multipart upload left open."""
    failures = []
    if not outcome["restarted"]:
        failures.append("the killed worker was not restarted")
    if not outcome["promoted"]:
        failures.append("no follower promoted itself")
    if sorted(outcome["objects"].values()) != [body] * 4:
        failures.append(f"stored {len(outcome['objects'])} objects, not 4 equal to the payload")
    if outcome["dangling"]:
        failures.append(f"{len(outcome['dangling'])} multipart uploads left open")
    return failures


def main(argv) -> int:
    body = payload(LEADER_KILL_BYTES, LEADER_KILL_SEED)
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="leader-kill-",
                                     dir=argv[1] if len(argv) > 1 else None) as workdir:
        try:
            failures = leader_kill_failures(leader_kill(PORT, body, workdir), body)
        except AssertionError as exc:
            failures = [str(exc)]
    print(json.dumps({
        "elapsed_s": round(time.monotonic() - started, 2),
        "failures": failures,
        "modules": sorted({name.split(".")[0] for name in sys.modules}),
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
