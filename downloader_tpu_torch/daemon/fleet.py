"""Crash-only worker fleet: a supervising parent over N worker
processes.

``run_fleet(workers=N)`` (CLI ``serve --workers N`` / ``FLEET_WORKERS``)
forks N child processes each running today's ``serve()`` against the
broker, and supervises them the crash-only way: workers are expected to
die — SIGKILL mid-multipart, OOM, a wedged device runtime — and the
system's correctness lives in the broker (unacked deliveries requeue),
the store janitor (stale multiparts aborted by the next owner of the
key), and this parent (dead or wedged workers restarted under jittered
capped backoff). Nothing a worker holds in memory is ever load-bearing.

Per worker the supervisor owns:

- **identity** — ``WORKER_INSTANCE=worker-<i>``, the label its samples
  carry through ``/metrics/federate``;
- **liveness, two signals** — process exit (the reaper collects it) and
  a heartbeat file the worker's ``HeartbeatWriter`` thread rewrites
  every ``FLEET_HEARTBEAT_S`` seconds, carrying the
  ``queue_publisher_alive`` gauge and the watchdog's stalled count. A
  heartbeat stale past ``FLEET_STALL_S``, or a publisher dead past
  ``FLEET_PUBLISHER_DOWN_S``, reads as *wedged*: the supervisor kills
  the worker (crash-only: killing is the one recovery primitive) and
  the restart path takes over;
- **restart policy** — full-jitter capped exponential backoff
  (``FLEET_RESTART_BACKOFF_S`` base, ``_CAP_S`` cap), counted on
  ``fleet_worker_restarts`` (the ``worker-flapping`` alert rule's
  series). A worker that exits during startup — bad config, port in
  use — without ever heartbeating is a *start failure*, not a crash:
  after ``FLEET_START_FAILURES_MAX`` consecutive ones the slot goes
  FATAL (``fleet_worker_start_failures``, a log line naming the exit
  code) instead of restart-looping forever;
- **federation** — once a worker heartbeats, the supervisor registers
  an HTTP scraper for its ``/metrics`` as a child source, so the
  parent's ``/metrics/federate`` serves the whole fleet under one
  scrape; a reaped worker's source deregisters with it, and a failing
  scrape costs its samples and a ``fleet_scrape_failures`` bump, never
  the render;
- **the debug plane** — the supervisor's ``FleetHealthServer`` is a
  fleet QUERY plane (daemon/fleetplane.py): every ``/debug/*`` view
  fans out to the ready workers' health ports concurrently under the
  ``FLEET_SCRAPE_TIMEOUT_S`` budget and merges with ``instance``
  attribution, and the alert engine runs fleet-summed burn rules plus
  a worker-outlier rule whose firing captures one cross-worker
  incident bundle.

On SIGTERM the supervisor drains: SIGTERM to every worker (each runs
its own graceful path — finish in-flight jobs, requeue parked/unacked
deliveries, abort in-flight multiparts via ``session.close()``), waits
``FLEET_DRAIN_S``, SIGKILLs stragglers, reaps everything.

The worker lifecycle is a declared protocol
(``# protocol: worker-lifecycle``): every ``WorkerHandle.spawn()`` must
reach exactly one ``reap()`` — enforced statically by the analyzer.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from ..utils import admission, get_logger, metrics, profiling, watchdog
from ..utils.cancel import CancelToken

log = get_logger("fleet")

DEFAULT_HEARTBEAT_S = 1.0
DEFAULT_STALL_S = 10.0
DEFAULT_PUBLISHER_DOWN_S = 15.0
DEFAULT_RESTART_BACKOFF_S = 0.5
DEFAULT_RESTART_BACKOFF_CAP_S = 30.0
DEFAULT_START_GRACE_S = 20.0
DEFAULT_START_FAILURES_MAX = 3
DEFAULT_DRAIN_S = 30.0
DEFAULT_SCRAPE_TIMEOUT_S = 2.0
DEFAULT_OUTLIER_RATIO = 4.0


def _int_env(env, name: str, default: int, minimum: int = 0) -> int:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(minimum, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            f"ignoring invalid {name} (want an integer)"
        )
        return default


def _float_env(env, name: str, default: float, minimum: float = 0.0) -> float:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(minimum, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            f"ignoring invalid {name} (want seconds)"
        )
        return default


def workers_from_env(environ=None) -> int:
    """``FLEET_WORKERS``: worker processes to supervise; 0/1 keeps the
    single-process ``serve()``."""
    env = os.environ if environ is None else environ
    return _int_env(env, "FLEET_WORKERS", 0)


def heartbeat_from_env(environ=None) -> float:
    """``FLEET_HEARTBEAT_S``: worker heartbeat-file write cadence."""
    env = os.environ if environ is None else environ
    return _float_env(env, "FLEET_HEARTBEAT_S", DEFAULT_HEARTBEAT_S, 0.05)


class FleetConfig:
    """The supervisor's knobs, one ``from_env`` like daemon.Config."""

    def __init__(
        self,
        workers: int = 2,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
        stall_s: float = DEFAULT_STALL_S,
        publisher_down_s: float = DEFAULT_PUBLISHER_DOWN_S,
        restart_backoff_s: float = DEFAULT_RESTART_BACKOFF_S,
        restart_backoff_cap_s: float = DEFAULT_RESTART_BACKOFF_CAP_S,
        start_grace_s: float = DEFAULT_START_GRACE_S,
        start_failures_max: int = DEFAULT_START_FAILURES_MAX,
        drain_s: float = DEFAULT_DRAIN_S,
        scrape_timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
        outlier_ratio: float = DEFAULT_OUTLIER_RATIO,
        canary_interval_s: float = 0.0,
    ):
        self.workers = max(1, workers)
        self.heartbeat_s = heartbeat_s
        self.stall_s = stall_s
        self.publisher_down_s = publisher_down_s
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_cap_s = restart_backoff_cap_s
        self.start_grace_s = start_grace_s
        self.start_failures_max = max(1, start_failures_max)
        self.drain_s = drain_s
        # fleet debug plane (daemon/fleetplane.py): the per-worker
        # budget every /debug fan-out and federation scrape runs under,
        # and the worker-outlier rule's p99-vs-fleet-median factor
        self.scrape_timeout_s = max(0.05, scrape_timeout_s)
        self.outlier_ratio = max(1.0, outlier_ratio)
        # fleet canary scheduler: round-robin one POST
        # /debug/canary/probe across the ready workers every interval,
        # so each probe verdict is attributable to ONE instance and a
        # single sick worker is localized. 0 = scheduler off (workers
        # still self-probe on their own CANARY_INTERVAL_S).
        self.canary_interval_s = max(0.0, canary_interval_s)

    @classmethod
    def from_env(cls, environ=None) -> "FleetConfig":
        env = os.environ if environ is None else environ
        return cls(
            workers=max(1, workers_from_env(env)),
            heartbeat_s=heartbeat_from_env(env),
            stall_s=_float_env(env, "FLEET_STALL_S", DEFAULT_STALL_S, 0.1),
            publisher_down_s=_float_env(
                env, "FLEET_PUBLISHER_DOWN_S", DEFAULT_PUBLISHER_DOWN_S, 0.1
            ),
            restart_backoff_s=_float_env(
                env, "FLEET_RESTART_BACKOFF_S", DEFAULT_RESTART_BACKOFF_S
            ),
            restart_backoff_cap_s=_float_env(
                env,
                "FLEET_RESTART_BACKOFF_CAP_S",
                DEFAULT_RESTART_BACKOFF_CAP_S,
            ),
            start_grace_s=_float_env(
                env, "FLEET_START_GRACE_S", DEFAULT_START_GRACE_S
            ),
            start_failures_max=_int_env(
                env, "FLEET_START_FAILURES_MAX", DEFAULT_START_FAILURES_MAX, 1
            ),
            drain_s=_float_env(env, "FLEET_DRAIN_S", DEFAULT_DRAIN_S),
            scrape_timeout_s=_float_env(
                env,
                "FLEET_SCRAPE_TIMEOUT_S",
                DEFAULT_SCRAPE_TIMEOUT_S,
                0.05,
            ),
            outlier_ratio=_float_env(
                env, "FLEET_OUTLIER_RATIO", DEFAULT_OUTLIER_RATIO, 1.0
            ),
            canary_interval_s=_float_env(
                env, "FLEET_CANARY_INTERVAL_S", 0.0, 0.0
            ),
        )


# -- worker-side heartbeat ---------------------------------------------------


class HeartbeatWriter:
    """The worker half of fleet liveness: one thread atomically
    rewriting ``FLEET_HEARTBEAT_FILE`` (tmp + rename) every interval
    with the signals the supervisor judges — wall-clock timestamp,
    the ``queue_publisher_alive`` gauge, the watchdog's stalled count,
    and the worker's resolved health port (how the supervisor learns
    where to scrape ``/metrics`` for federation)."""

    def __init__(self, path: str, interval_s: float, health_port: int = 0):
        self._path = path
        self._interval = max(0.05, interval_s)
        self._health_port = health_port
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "HeartbeatWriter":
        thread = threading.Thread(  # thread-role: fleet-heartbeat
            target=self._run, name="fleet-heartbeat", daemon=True
        )
        self._thread = thread
        thread.start()
        profiling.ROLES.register_thread(thread, "fleet-heartbeat")
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            # deadline: the loop waits in interval slices on the stop event and every write is a local tmp+rename, so the join is bounded by one interval + one write
            thread.join(timeout=5.0)

    def _run(self) -> None:
        # the loop the supervisor's whole liveness story rides on is
        # itself liveness-watched: a wedged heartbeat thread must not
        # silently read as a wedged worker
        watch = watchdog.MONITOR.loop("fleet-heartbeat")
        try:
            self._write()  # first beat NOW: this is the ready signal
            while not self._stop.wait(self._interval):
                watch.beat()
                self._write()
        except Exception as exc:
            # an escaped exception here stops the beats and the
            # supervisor reads this worker as wedged — correct verdict,
            # but the cause must be in the log, not silent
            log.error("fleet heartbeat writer crashed", exc=exc)
        finally:
            watchdog.MONITOR.unregister(watch)

    def _write(self) -> None:
        gauges = metrics.GLOBAL.gauges()
        payload = {
            "pid": os.getpid(),
            "ts": time.time(),
            "publisher_alive": int(
                gauges.get("queue_publisher_alive", 0)
            ),
            "stalled": int(gauges.get("watchdog_stalled_tasks", 0)),
            "health_port": self._health_port,
            "instance": metrics.FEDERATION.instance,
        }
        tmp = f"{self._path}.tmp"
        try:
            with open(tmp, "w") as sink:
                json.dump(payload, sink)
            os.replace(tmp, self._path)
        except OSError as exc:
            # a failed beat reads as staleness at the supervisor, which
            # is the correct degraded verdict for a worker whose disk
            # stopped cooperating — log and keep beating
            log.debug(f"heartbeat write failed: {exc}")


# -- supervisor-side worker handles ------------------------------------------


class WorkerHandle:
    """One spawned worker process and its declared lifecycle:
    spawn -> ready -> draining -> reaped. ``spawn`` opens the
    obligation, ``reap`` is its only release — the analyzer's
    worker-lifecycle protocol holds both halves to that."""

    def __init__(self, instance: str, argv: "list[str]", env: "dict[str, str]"):
        self.instance = instance
        self.argv = list(argv)
        self.env = dict(env)
        self.proc: "subprocess.Popen | None" = None
        self.state = "new"  # shared-by-design: one-way monotonic lifecycle string (new->spawned->ready->draining->reaped); writes are GIL-atomic, a stale read only shows the previous state, and reap() is idempotent so the monitor/reaper overlap is safe
        self.spawned_at = 0.0
        self.exit_code: "int | None" = None

    def spawn(self) -> "WorkerHandle":  # protocol: worker-lifecycle acquire
        assert self.state == "new", f"spawn from state {self.state!r}"
        self.proc = subprocess.Popen(
            self.argv,
            env=self.env,
            stdin=subprocess.DEVNULL,
            start_new_session=True,  # a worker's SIGKILL never splashes us
        )
        self.spawned_at = time.monotonic()
        self.state = "spawned"
        log.with_fields(
            instance=self.instance, pid=self.proc.pid
        ).info("worker spawned")
        return self

    def ready(self) -> None:
        """First heartbeat observed: the worker survived startup."""
        if self.state == "spawned":
            self.state = "ready"

    def draining(self) -> None:
        """SIGTERM: the worker runs its graceful path (finish in-flight
        jobs, requeue parked/unacked deliveries, abort speculative
        multiparts)."""
        if self.state in ("spawned", "ready"):
            self.state = "draining"
            self._signal(signal.SIGTERM)

    def kill(self) -> None:
        """Crash-only recovery primitive: SIGKILL. Used on wedged
        workers and drain-deadline stragglers; the broker requeues, the
        janitor reclaims, the restart path respawns."""
        if self.state in ("spawned", "ready", "draining"):
            self._signal(signal.SIGKILL)

    def _signal(self, signum: int) -> None:
        proc = self.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(signum)
        except (ProcessLookupError, PermissionError) as exc:
            log.with_fields(instance=self.instance).debug(
                f"signal {signum} failed: {exc}"
            )

    def poll(self) -> "int | None":
        proc = self.proc
        return None if proc is None else proc.poll()

    def reap(self, timeout: float = 5.0) -> "int | None":  # protocol: worker-lifecycle release
        """Collect the process (bounded wait; escalates to SIGKILL if
        it is somehow still alive) and close the lifecycle. Idempotent."""
        if self.state == "reaped":
            return self.exit_code
        proc = self.proc
        if proc is not None:
            try:
                self.exit_code = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._signal(signal.SIGKILL)
                try:
                    self.exit_code = proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    log.with_fields(
                        instance=self.instance, pid=proc.pid
                    ).error("worker unreapable after SIGKILL")
        self.state = "reaped"
        return self.exit_code


class _WorkerSlot:
    """One fleet seat: the handle currently in it plus its restart
    bookkeeping. All mutable fields are guarded by the supervisor's
    lock; the monitor thread is the only writer after start()."""

    def __init__(self, index: int):
        self.index = index
        self.instance = f"worker-{index}"
        self.handle: "WorkerHandle | None" = None  # guarded-by: _lock
        self.restarts = 0  # guarded-by: _lock
        self.crash_streak = 0  # consecutive short-lived deaths; guarded-by: _lock
        self.start_failures = 0  # consecutive; guarded-by: _lock
        self.fatal = False  # guarded-by: _lock
        self.backoff_until = 0.0  # guarded-by: _lock
        self.last_beat_mono = 0.0  # guarded-by: _lock
        self.last_beat: dict = {}  # guarded-by: _lock
        self.last_beat_ts = 0.0  # the file's own ts; guarded-by: _lock
        self.publisher_down_since: "float | None" = None  # guarded-by: _lock
        self.ever_ready = False  # this generation; guarded-by: _lock
        self.health_port = 0  # guarded-by: _lock
        self.heartbeat_path = ""


def _free_port() -> int:
    """A currently-free TCP port for a worker's health endpoint. The
    classic bind-close race is accepted: losing it presents as a worker
    start failure, which the supervisor's fatal-after-M path already
    owns (the 'port in use' case)."""
    probe = socket.socket()
    try:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]
    finally:
        probe.close()


class FleetSupervisor:
    """The parent. ``start()`` spawns the fleet and the monitor/reaper
    threads; ``run()`` blocks until the token cancels, then drains."""

    def __init__(
        self,
        config: FleetConfig,
        token: "CancelToken | None" = None,
        worker_argv=None,
        worker_env: "dict[str, str] | None" = None,
        heartbeat_dir: "str | None" = None,
    ):
        """``worker_argv(slot) -> list[str]`` builds a worker's command
        line (tests substitute scripted workers); the default runs
        ``python -m downloader_tpu_torch serve`` (the port's worker, never
        the JAX package's) with this process's environment.
        ``worker_env`` overlays the inherited environment for every
        worker."""
        self._config = config
        self._token = token or CancelToken()
        self._worker_argv = worker_argv or self._default_argv
        self._worker_env = dict(worker_env or {})
        import tempfile

        # an explicitly-passed dir belongs to the caller; one we made
        # ourselves is removed at drain
        self._owns_heartbeat_dir = heartbeat_dir is None
        self._heartbeat_dir = heartbeat_dir or tempfile.mkdtemp(
            prefix="fleet-hb-"
        )
        self._lock = threading.Lock()
        self._slots = [_WorkerSlot(i) for i in range(config.workers)]
        self._reap_queue: "list[WorkerHandle]" = []  # guarded-by: _lock
        self._reap_wakeup = threading.Event()
        self._stop = threading.Event()
        self._monitor: "threading.Thread | None" = None
        self._reaper: "threading.Thread | None" = None
        metrics.GLOBAL.gauge_set("fleet_workers_target", config.workers)
        metrics.GLOBAL.gauge_set("fleet_workers_alive", 0)

    # -- worker construction ----------------------------------------------

    @staticmethod
    def _default_argv(slot: _WorkerSlot) -> "list[str]":
        return [sys.executable, "-m", "downloader_tpu_torch", "serve"]

    def _build_handle(self, slot: _WorkerSlot) -> WorkerHandle:
        slot.health_port = _free_port()
        slot.heartbeat_path = os.path.join(
            self._heartbeat_dir, f"{slot.instance}.json"
        )
        # a stale heartbeat from the previous generation must not make
        # a freshly-spawned worker read as instantly ready
        try:
            os.unlink(slot.heartbeat_path)
        except OSError:
            pass
        env = dict(os.environ)
        env.update(self._worker_env)
        env.update(
            {
                "WORKER_INSTANCE": slot.instance,
                "FLEET_HEARTBEAT_FILE": slot.heartbeat_path,
                "FLEET_HEARTBEAT_S": f"{self._config.heartbeat_s:g}",
                "HEALTH_PORT": str(slot.health_port),
                # a worker process never re-forks the fleet
                "FLEET_WORKERS": "0",
            }
        )
        # fleet data plane coordination: when a cache root is
        # configured, every worker must agree on ONE on-disk store and
        # ONE lease index regardless of its own cwd — the supervisor
        # pins both paths absolute before the fork (see store/cas.py)
        cache_dir = (env.get("CACHE_DIR") or "").strip()
        if cache_dir:
            cache_dir = os.path.abspath(cache_dir)
            env["CACHE_DIR"] = cache_dir
            if not (env.get("SINGLEFLIGHT_DIR") or "").strip():
                env["SINGLEFLIGHT_DIR"] = os.path.join(cache_dir, "inflight")
        # the package must be importable in the child even when the
        # parent was launched from an arbitrary cwd (zipapp, test run)
        package_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        existing = env.get("PYTHONPATH", "")
        if package_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                f"{package_root}{os.pathsep}{existing}"
                if existing
                else package_root
            )
        return WorkerHandle(slot.instance, self._worker_argv(slot), env)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        for slot in self._slots:
            self._spawn_slot(slot)
        monitor = threading.Thread(  # thread-role: fleet-monitor
            target=self._monitor_loop, name="fleet-monitor", daemon=True
        )
        reaper = threading.Thread(  # thread-role: fleet-reaper
            target=self._reaper_loop, name="fleet-reaper", daemon=True
        )
        self._monitor = monitor
        self._reaper = reaper
        monitor.start()
        reaper.start()
        profiling.ROLES.register_thread(monitor, "fleet-monitor")
        profiling.ROLES.register_thread(reaper, "fleet-reaper")
        log.with_fields(workers=len(self._slots)).info("fleet running")
        return self

    def run(self) -> int:
        self.start()
        self._token.wait()
        self.drain()
        return 0

    def stop(self) -> None:
        """Stop the supervision threads without touching the workers
        (tests); ``drain()`` is the real shutdown."""
        self._stop.set()
        self._reap_wakeup.set()
        for thread in (self._monitor, self._reaper):
            if thread is not None:
                # deadline: both loops wait on the stop event in sub-second slices; nothing in a tick blocks unbounded (reap waits are themselves bounded)
                thread.join(timeout=10.0)

    def drain(self) -> None:
        """SIGTERM every worker, give the graceful paths
        ``FLEET_DRAIN_S`` to finish (in-flight jobs complete, parked
        and unacked deliveries requeue, speculative multiparts abort),
        SIGKILL the stragglers, reap everything."""
        self._stop.set()
        self._reap_wakeup.set()
        # the monitor must be OUT before the handle collection below:
        # a tick already past its stop check could otherwise respawn a
        # worker into a slot drain has already collected — a live
        # orphan no SIGTERM or reap would ever reach
        monitor = self._monitor
        if monitor is not None and monitor is not threading.current_thread():
            # deadline: the monitor waits on the stop event in sub-second slices and nothing in a tick blocks unbounded
            monitor.join(timeout=10.0)
        with self._lock:
            handles = [
                slot.handle for slot in self._slots if slot.handle is not None
            ]
        for handle in handles:
            handle.draining()
        deadline = time.monotonic() + self._config.drain_s
        for handle in handles:
            remaining = max(0.1, deadline - time.monotonic())
            proc = handle.proc
            if proc is not None:
                try:
                    proc.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    log.with_fields(instance=handle.instance).warning(
                        "drain deadline passed; killing worker"
                    )
                    handle.kill()
            self._retire_handle(handle)
        with self._lock:
            for slot in self._slots:
                slot.handle = None
        metrics.GLOBAL.gauge_set("fleet_workers_alive", 0)
        self.stop()
        if self._owns_heartbeat_dir:
            import shutil

            shutil.rmtree(self._heartbeat_dir, ignore_errors=True)
        log.info("fleet drained")

    # -- spawn / retire ----------------------------------------------------

    def _spawn_slot(self, slot: _WorkerSlot) -> None:
        handle = self._build_handle(slot)
        try:
            handle = handle.spawn()
        except OSError as exc:
            # the exec itself failed (bad interpreter, ENOENT — or a
            # TRANSIENT fork failure under memory pressure): count it
            # like an exited-during-startup worker, WITH the same
            # backoff the exit path applies — retrying at raw tick
            # cadence would burn every fatal-budget attempt inside a
            # second and park the slot for a blip that cleared
            handle.reap(timeout=0.1)
            self._note_start_failure(slot, exit_code=None, error=str(exc))
            with self._lock:
                slot.handle = None
                attempt = slot.start_failures
                slot.backoff_until = time.monotonic() + admission.full_jitter(
                    attempt - 1,
                    self._config.restart_backoff_s,
                    self._config.restart_backoff_cap_s,
                )
            return
        with self._lock:
            slot.handle = handle
            slot.ever_ready = False
            slot.last_beat_mono = 0.0
            slot.last_beat_ts = 0.0
            slot.publisher_down_since = None

    def _retire_handle(self, handle: WorkerHandle) -> None:
        metrics.FEDERATION.unregister_source(handle.instance)
        handle.reap()

    def _note_start_failure(
        self, slot: _WorkerSlot, exit_code: "int | None", error: str = ""
    ) -> None:
        with self._lock:
            slot.start_failures += 1
            failures = slot.start_failures
            fatal = failures >= self._config.start_failures_max
            slot.fatal = fatal
        metrics.GLOBAL.add("fleet_worker_start_failures")
        entry = log.with_fields(
            instance=slot.instance,
            exit_code=exit_code,
            consecutive=failures,
        )
        if fatal:
            # a worker that cannot START is a configuration problem,
            # and restart-looping it forever
            # would melt the host while hiding the verdict — park the
            # slot and say exactly what the child said
            entry.error(
                "worker failed during startup; slot is FATAL "
                f"(exit code {exit_code}, {failures} consecutive "
                f"failures{'; ' + error if error else ''})"
            )
        else:
            entry.warning(
                f"worker exited during startup (exit code {exit_code}"
                f"{'; ' + error if error else ''}); will retry"
            )

    # -- the monitor -------------------------------------------------------

    def _monitor_loop(self) -> None:
        watch = watchdog.MONITOR.loop("fleet-monitor")
        interval = min(0.25, self._config.heartbeat_s / 2)
        try:
            while not self._stop.wait(interval):
                watch.beat()
                try:
                    self._tick()
                except Exception as exc:
                    # the thing that restarts everyone else must not
                    # die to one bad tick
                    log.error("fleet monitor tick failed", exc=exc)
        finally:
            watchdog.MONITOR.unregister(watch)

    def _tick(self, now: "float | None" = None) -> None:
        now = time.monotonic() if now is None else now
        alive = 0
        for slot in self._slots:
            with self._lock:
                fatal = slot.fatal
                handle = slot.handle
                backoff_until = slot.backoff_until
            if fatal:
                continue
            if handle is None:
                if (
                    now >= backoff_until
                    and not self._token.cancelled()
                    and not self._stop.is_set()
                ):
                    self._spawn_slot(slot)
                    with self._lock:
                        if slot.handle is not None:
                            alive += 1
                continue
            exit_code = handle.poll()
            if exit_code is not None:
                self._handle_exit(slot, handle, exit_code, now)
                continue
            self._judge_liveness(slot, handle, now)
            alive += 1
        metrics.GLOBAL.gauge_set("fleet_workers_alive", alive)

    def _handle_exit(
        self, slot: _WorkerSlot, handle: WorkerHandle, exit_code: int,
        now: float,
    ) -> None:
        with self._lock:
            slot.handle = None
            was_ready = slot.ever_ready
            restarts = slot.restarts
        # hand the corpse to the reaper (waits live there, not here)
        with self._lock:
            self._reap_queue.append(handle)
        self._reap_wakeup.set()
        if not was_ready and now - handle.spawned_at <= (
            self._config.start_grace_s
        ):
            self._note_start_failure(slot, exit_code)
            with self._lock:
                if slot.fatal:
                    return
                attempt = slot.start_failures
        else:
            metrics.GLOBAL.add("fleet_worker_restarts")
            lifetime = now - handle.spawned_at
            with self._lock:
                slot.restarts = restarts + 1
                # a worker dying within ~2 liveness windows of its
                # spawn is crash-looping: the backoff escalates
                # exponentially (capped); a long-lived one restarts
                # near-immediately — jitter keeps a mass crash from
                # respawning as one thundering herd
                if lifetime < 2 * self._config.stall_s:
                    slot.crash_streak += 1
                else:
                    slot.crash_streak = 1
                attempt = slot.crash_streak
            log.with_fields(
                instance=slot.instance, exit_code=exit_code,
                restarts=restarts + 1,
            ).warning("worker died; restarting")
        backoff = admission.full_jitter(
            attempt - 1,
            self._config.restart_backoff_s,
            self._config.restart_backoff_cap_s,
        )
        with self._lock:
            slot.backoff_until = now + backoff

    def _judge_liveness(
        self, slot: _WorkerSlot, handle: WorkerHandle, now: float
    ) -> None:
        beat = self._read_heartbeat(slot)
        if beat is not None:
            with self._lock:
                first = not slot.ever_ready
                fresh = beat.get("ts", 0.0) != slot.last_beat_ts
                if fresh:
                    slot.last_beat = beat
                    slot.last_beat_ts = beat.get("ts", 0.0)
                    slot.last_beat_mono = now
                if first:
                    slot.ever_ready = True
                    slot.start_failures = 0
                    port = int(beat.get("health_port") or 0)
                    if port:
                        slot.health_port = port
            if first:
                handle.ready()
                self._register_federation(slot)
                log.with_fields(instance=slot.instance).info("worker ready")
            with self._lock:
                if fresh:
                    if beat.get("publisher_alive", 1):
                        slot.publisher_down_since = None
                    elif slot.publisher_down_since is None:
                        slot.publisher_down_since = now
        with self._lock:
            ready = slot.ever_ready
            last_beat = slot.last_beat_mono
            down_since = slot.publisher_down_since
        if not ready:
            # still starting: the grace/exit paths own this window
            return
        wedged = None
        if now - last_beat > self._config.stall_s:
            wedged = (
                f"heartbeat stale {now - last_beat:.1f}s "
                f"(> {self._config.stall_s:g}s)"
            )
        elif (
            down_since is not None
            and now - down_since > self._config.publisher_down_s
        ):
            wedged = (
                "publisher dead "
                f"{now - down_since:.1f}s "
                f"(> {self._config.publisher_down_s:g}s)"
            )
        if wedged is not None:
            # crash-only: a wedged worker is not debugged in place, it
            # is killed; the exit path above turns the corpse into a
            # counted restart with backoff
            log.with_fields(instance=slot.instance).error(
                f"worker wedged ({wedged}); killing for restart"
            )
            handle.kill()

    def _read_heartbeat(self, slot: _WorkerSlot) -> "dict | None":
        try:
            with open(slot.heartbeat_path) as source:
                payload = json.load(source)
        except (OSError, ValueError):
            return None
        return payload if isinstance(payload, dict) else None

    def _register_federation(self, slot: _WorkerSlot) -> None:
        with self._lock:
            port = slot.health_port
        if not port:
            return
        timeout = self._config.scrape_timeout_s
        from .fleetplane import _http_request

        def scrape(port=port, timeout=timeout) -> str:
            # bounded by the fleet scrape budget and counted on
            # failure: a stale or wedged source costs its samples and
            # a fleet_scrape_failures bump, never the federate render
            # (render_federated catches and skips failing sources)
            try:
                status, body = _http_request(
                    port, "/metrics", timeout=timeout
                )
                if status != 200:
                    raise OSError(f"/metrics answered {status}")
            except Exception:
                metrics.GLOBAL.add("fleet_scrape_failures")
                raise
            return body.decode()

        metrics.FEDERATION.register_source(slot.instance, scrape)

    def ready_workers(self) -> "list[tuple[str, int]]":
        """The fleet members a /debug fan-out may query: slots whose
        worker has heartbeated (so the health port is known) and whose
        process is still running — a reaped or just-killed worker
        drops out here, so a stale member costs nothing, not even a
        timeout slice."""
        with self._lock:
            out = []
            for slot in self._slots:
                handle = slot.handle
                if (
                    handle is None
                    or not slot.ever_ready
                    or not slot.health_port
                ):
                    continue
                if handle.poll() is not None:
                    continue
                out.append((slot.instance, slot.health_port))
        return out

    # -- the reaper --------------------------------------------------------

    def _reaper_loop(self) -> None:
        # the blocking waits live HERE so a slow-to-die corpse never
        # stalls the monitor's liveness verdicts on the other workers
        watch = watchdog.MONITOR.loop("fleet-reaper")
        try:
            while True:
                self._reap_wakeup.wait(timeout=0.5)
                self._reap_wakeup.clear()
                watch.beat()
                while True:
                    with self._lock:
                        if not self._reap_queue:
                            break
                        handle = self._reap_queue.pop(0)
                    try:
                        self._retire_handle(handle)
                    except Exception as exc:
                        log.error("worker reap failed", exc=exc)
                if self._stop.is_set():
                    with self._lock:
                        drained = not self._reap_queue
                    if drained:
                        return
        finally:
            watchdog.MONITOR.unregister(watch)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            slots = []
            alive = 0
            for slot in self._slots:
                handle = slot.handle
                running = handle is not None and handle.poll() is None
                alive += 1 if running else 0
                slots.append(
                    {
                        "instance": slot.instance,
                        "state": handle.state if handle else "down",
                        "pid": (
                            handle.proc.pid
                            if handle and handle.proc
                            else None
                        ),
                        "restarts": slot.restarts,
                        "start_failures": slot.start_failures,
                        "fatal": slot.fatal,
                        "ready": slot.ever_ready,
                        "health_port": slot.health_port,
                        "last_heartbeat": slot.last_beat,
                    }
                )
        return {
            "workers_target": len(self._slots),
            "workers_alive": alive,
            "slots": slots,
        }


# -- the fleet's own health endpoint -----------------------------------------


class FleetHealthServer:
    """The fleet's operator endpoint: ``/healthz`` + ``/metrics`` +
    ``/metrics/federate`` for the supervisor process (built on the
    same renderers the worker's health server uses) PLUS the fleet
    debug plane — every ``/debug/*`` view fans out to the ready
    workers' health ports under the scrape-timeout budget and merges
    with ``instance`` attribution (daemon/fleetplane.py):
    ``/debug/trace?trace_id=`` stitches one logical trace across
    processes, ``/debug/logs`` merges rings by timestamp,
    ``/debug/incidents`` is the fleet index with fetch-by-id routed
    to the owning worker, ``/debug/profile`` sums folded stacks,
    ``/debug/tsdb`` aggregates rates and percentiles fleet-wide, and
    ``POST /debug/incident`` captures one cross-worker bundle."""

    def __init__(
        self,
        supervisor: FleetSupervisor,
        port: int,
        host: str,
        plane=None,
    ):
        import http.server
        import urllib.parse

        from .fleetplane import FleetQueryPlane
        from .health import render_federated, render_metrics

        fleet = supervisor
        if plane is None:
            plane = FleetQueryPlane(
                supervisor.ready_workers,
                timeout_s=supervisor._config.scrape_timeout_s,
            )
        self.plane = plane

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                profiling.ROLES.register_current("health-server")
                try:
                    parsed = urllib.parse.urlsplit(self.path)
                    path = parsed.path
                    query = urllib.parse.parse_qs(parsed.query)
                    if path == "/healthz":
                        snap = fleet.snapshot()
                        degraded = snap["workers_alive"] < snap[
                            "workers_target"
                        ]
                        snap["status"] = "degraded" if degraded else "ok"
                        code = 503 if degraded else 200
                        body = (json.dumps(snap, indent=1) + "\n").encode()
                        ctype = "application/json"
                    elif path == "/readyz":
                        snap = fleet.snapshot()
                        slots = {
                            slot["instance"]: bool(slot.get("ready"))
                            for slot in snap.get("slots", [])
                        }
                        ready = bool(slots) and all(slots.values())
                        payload = {"ready": ready, "slots": slots}
                        code = 200 if ready else 503
                        body = (
                            json.dumps(payload, indent=1) + "\n"
                        ).encode()
                        ctype = "application/json"
                    elif path == "/debug/canary":
                        code, body, ctype = plane.debug_canary()
                    elif path == "/metrics":
                        code, body = 200, render_metrics()
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/metrics/federate":
                        code, body = 200, render_federated(render_metrics())
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/debug/trace":
                        code, body, ctype = plane.debug_trace(query)
                    elif path == "/debug/logs":
                        code, body, ctype = plane.debug_logs(query)
                    elif path == "/debug/tsdb":
                        code, body, ctype = plane.debug_tsdb(query)
                    elif path == "/debug/profile":
                        code, body, ctype = plane.debug_profile(query)
                    elif path == "/debug/alerts":
                        code, body, ctype = plane.debug_alerts()
                    elif path == "/debug/flows":
                        code, body, ctype = plane.debug_flows(query)
                    elif path == "/debug/critpath":
                        code, body, ctype = plane.debug_critpath(query)
                    elif path == "/debug/incidents":
                        code, body, ctype = plane.debug_incidents()
                    elif path.startswith("/debug/incidents/"):
                        code, body, ctype = plane.debug_incident(
                            path[len("/debug/incidents/"):]
                        )
                    elif path in (
                        "/debug/watchdog", "/debug/admission",
                        "/debug/jobs", "/debug/cache",
                    ):
                        code, body, ctype = plane.debug_passthrough(path)
                    else:
                        code, body, ctype = 404, b"not found\n", "text/plain"
                except Exception as exc:
                    log.error("fleet health view failed", exc=exc)
                    code, body, ctype = 500, b"internal error\n", "text/plain"
                self._reply(code, body, ctype)

            def do_POST(self):
                profiling.ROLES.register_current("health-server")
                try:
                    if self.path == "/debug/incident":
                        bundle = plane.capture_fleet_incident(
                            "operator-requested fleet capture "
                            "(POST /debug/incident)",
                            trigger="manual",
                        )
                        payload = {
                            "id": bundle["id"] if bundle else None,
                            "workers": sorted(
                                (bundle or {})
                                .get("extra", {})
                                .get("workers", {})
                            ),
                        }
                        code = 200
                        body = (json.dumps(payload) + "\n").encode()
                        ctype = "application/json"
                    else:
                        code, body, ctype = 404, b"not found\n", "text/plain"
                except Exception as exc:
                    log.error("fleet health view failed", exc=exc)
                    code, body, ctype = 500, b"internal error\n", "text/plain"
                self._reply(code, body, ctype)

            def _reply(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(  # thread-role: health-server
            target=self._httpd.serve_forever, name="fleet-health", daemon=True
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "FleetHealthServer":
        self._thread.start()
        profiling.ROLES.register_thread(self._thread, "health-server")
        log.with_field("port", self.port).info("fleet health listening")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


# -- entry point -------------------------------------------------------------


def run_fleet(
    workers: "int | None" = None,
    config: "FleetConfig | None" = None,
    token: "CancelToken | None" = None,
    worker_env: "dict[str, str] | None" = None,
    install_signal_handlers: bool = True,
) -> int:
    """The ``serve --workers N`` entry point: supervise N worker
    processes until SIGINT/SIGTERM/SIGHUP, then drain."""
    from ..utils import alerts, configure_from_env, tsdb

    configure_from_env()
    config = config or FleetConfig.from_env()
    if workers is not None:
        config.workers = max(1, workers)
    token = token or CancelToken()
    if install_signal_handlers:
        def handle(signum, frame):
            log.info("fleet shutting down")
            token.cancel()

        for signum in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
            signal.signal(signum, handle)

    # the supervisor's own telemetry plane: its registry carries the
    # fleet_* series, the TSDB gives the flapping rule its windowed
    # rate — and the fleet debug plane promotes it to the FLEET's
    # telemetry: the aggregator collector folds every worker's SLO
    # histograms (summed + per-instance) into the supervisor's TSDB,
    # the alert engine runs fleet burn + worker-outlier rules over
    # them, and a firing fleet rule captures one cross-worker incident
    from .fleetplane import (
        FleetAggregator, FleetQueryPlane, fleet_alert_rules,
    )

    metrics.FEDERATION.instance = "fleet"
    watchdog.MONITOR.configure(
        stall_s=watchdog.stall_from_env(), action="log"
    )
    watchdog.MONITOR.start()

    supervisor = FleetSupervisor(config, token=token, worker_env=worker_env)
    plane = FleetQueryPlane(
        supervisor.ready_workers,
        timeout_s=config.scrape_timeout_s,
        engine=alerts.ENGINE,
    )
    aggregator = FleetAggregator(plane, store=tsdb.STORE)
    tsdb.STORE.configure(interval_s=tsdb.interval_from_env())
    tsdb.STORE.register_collector("fleet-aggregator", aggregator.collect)
    tsdb.STORE.start()
    fast_window, slow_window = alerts.windows_from_env()
    slo_interactive_s, slo_bulk_s = alerts.slo_targets_from_env()
    alerts.ENGINE.configure(
        rules=alerts.fleet_rules(fast_window)
        + fleet_alert_rules(
            aggregator,
            slo_interactive_s=slo_interactive_s,
            slo_bulk_s=slo_bulk_s,
            objective=alerts.objective_from_env(),
            fast_window_s=fast_window,
            slow_window_s=slow_window,
            factor=alerts.burn_factor_from_env(),
            outlier_ratio=config.outlier_ratio,
        ),
        interval_s=alerts.interval_from_env(),
        on_fire=plane.alert_fired,
        exemplar_source=aggregator.exemplars_for,
    )
    alerts.ENGINE.start()

    health = None
    health_port = _int_env(os.environ, "HEALTH_PORT", 0)
    if health_port > 0:
        health = FleetHealthServer(
            supervisor,
            health_port,
            os.environ.get("HEALTH_HOST", "127.0.0.1"),
            plane=plane,
        ).start()

    # fleet canary scheduler: one probe per interval, round-robined
    # across the ready workers — each verdict lands on exactly one
    # instance, so a single sick worker is localized instead of every
    # worker's self-probe firing at once
    canary_stop = threading.Event()
    canary_thread = None
    if config.canary_interval_s > 0:
        from .fleetplane import _http_request

        def _canary_schedule() -> None:
            watch = watchdog.MONITOR.loop("fleet-canary")
            cursor = 0
            try:
                while not canary_stop.wait(config.canary_interval_s):
                    watch.beat()
                    targets = supervisor.ready_workers()
                    if not targets:
                        continue
                    instance, port = targets[cursor % len(targets)]
                    cursor += 1
                    try:
                        status, _ = _http_request(
                            port,
                            "/debug/canary/probe",
                            method="POST",
                            timeout=config.scrape_timeout_s,
                        )
                    except OSError as exc:
                        log.with_fields(instance=instance).warning(
                            f"canary probe dispatch failed: {exc}"
                        )
                        continue
                    if status != 200:
                        log.with_fields(
                            instance=instance, status=status
                        ).warning("canary probe dispatch rejected")
            except Exception as exc:
                # a crashed scheduler stops fleet-driven probes but the
                # workers' own interval probers keep running — degraded,
                # not blind; the cause must be in the log, not silent
                log.error("fleet canary scheduler crashed", exc=exc)
            finally:
                watchdog.MONITOR.unregister(watch)

        canary_thread = threading.Thread(  # thread-role: fleet-canary
            target=_canary_schedule, name="fleet-canary", daemon=True
        )
        canary_thread.start()
        profiling.ROLES.register_thread(canary_thread, "fleet-canary")
    try:
        return supervisor.run()
    finally:
        canary_stop.set()
        if canary_thread is not None:
            # deadline: the loop blocks only on the stop event (interval waits) and a bounded scrape-timeout HTTP dispatch
            canary_thread.join(timeout=config.scrape_timeout_s + 2.0)
        alerts.ENGINE.stop()
        tsdb.STORE.unregister_collector("fleet-aggregator")
        tsdb.STORE.stop()
        watchdog.MONITOR.stop()
        if health is not None:
            health.stop()
