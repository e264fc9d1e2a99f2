"""Deterministic seeded failpoint injection: the crash-only proof's
fault source.

The schedule shaker (``analysis/schedules.py``) perturbs *when* threads
run; this module perturbs *whether the world cooperates* — socket
connects refused, part PUTs answering 5xx, ``os.pwrite`` hitting a full
disk, the publish confirm never arriving, the device runtime wedging at
init, the process dying outright. Each fault surface in the tree
declares a named seam (``FAILPOINTS.fire("s3.part_put")``); with no
spec armed the seam is a single dict-truthiness check, so the hot path
pays nothing (the existing <=0.5 ms/job overhead guards run with the
seams compiled in).

Determinism contract (same as the shaker): every decision is a pure
hash of ``(seed, site, counter)`` — one ``FAILPOINT_SEED`` + one
``FAILPOINT_SPEC`` reproduce the exact injection schedule, call for
call, which is what lets a chaos failure replay from the seed a test
printed.

Spec grammar (``FAILPOINT_SPEC``, comma/semicolon/space separated)::

    site=mode[:prob[:skip[:param]]]

- ``mode`` — what an armed hit does:
    - ``fail``  — ``fire()`` returns True; the seam raises its natural
      error (ENOSPC at pwrite, 5xx at the part PUT, BrokerError at the
      publish, ECONNREFUSED at connect).
    - ``kill``  — SIGKILL this process on the spot (crash-matrix cells:
      the process dies exactly at the seam, no atexit, no flush).
    - ``wedge`` — sleep ``param`` seconds (default 3600) at the seam:
      the device-init wedge, a black-holed origin.
    - ``sleep`` — sleep ``param`` seconds (default 0.05) and DON'T
      inject a failure: slow-origin / slow-disk injection.
- ``prob`` — probability in [0, 1] an eligible call hits (default 1);
  decided by the seeded hash, never ``random``.
- ``skip`` — number of eligible calls to let through before arming
  (default 0): ``s3.part_put=kill:1:1`` dies on the SECOND part PUT.
- ``param`` — mode-specific float (wedge/sleep seconds).

A bare float is shorthand for ``fail``: ``segments.pwrite=0.05``.

Site catalog (the seams in the tree; README "Fleet & fault injection"
documents each with its natural failure):

==================  ====================================================
``net.connect``     socket connect in utils/netio.create_connection
                    (every pooled HTTP dial, mirrors included)
``segments.read``   segment body read in fetch/segments (per chunk)
``http.read``       whole-object body read in the batched fast lane's
                    ``fetch_small`` (per chunk)
``segments.pwrite`` the ranged ``os.pwrite`` into the ``.part`` file
``segments.preallocate``  the ``os.truncate`` preallocation (disk-full
                    at admission time, before any byte moved)
``peer.recv``       peer-wire socket reads (fetch/peerwire)
``peer.send``       peer-wire socket writes
``queue.publish``   the publisher thread's wire publish (confirm never
                    happens; the publisher retires + rebuilds)
``s3.initiate``     multipart initiate
``s3.part_put``     one part PUT (5xx; the client's one retry engages)
``daemon.pre_publish``  after fetch/scan/upload, before the Convert
                    publish (crash-matrix boundary)
``daemon.pre_ack``  after the confirmed publish, before the ack
                    (crash-matrix boundary: duplicate-delivery window)
``device.init``     inside the accelerator init probe (wedge target)
``cas.lookup``      content-cache entry probe (store/cas.py): fail =
                    forced miss (the unreadable-entry path)
``cas.put``         content-cache write-through admission: fail =
                    ENOSPC (the job completes uncached); kill dies
                    between fetch-complete and the entry landing
``coalesce.join``   a follower subscribing to an in-flight leader's
                    fetch (fetch/singleflight.py): fail degrades to a
                    direct uncoalesced fetch
``coalesce.lead``   the moment of lease election/promotion: fail =
                    lease-index IO error (degrades to direct fetch);
                    kill dies HOLDING the lease, forcing a follower
                    promotion
``canary.corrupt``  the store-and-forward upload (store/uploader.py
                    ``_upload_one``): fail = SILENT corruption — the
                    stored object's first byte is flipped past every
                    digest check, the upload still reports success;
                    only the canary plane's outside-in read-back
                    (utils/canary.py) can catch it
==================  ====================================================

Wired in ``serve()`` from the environment; tests drive
``FAILPOINTS.configure`` directly and ``reset()`` for isolation.
"""

from __future__ import annotations

import hashlib
import os
import signal
import threading
import time

from .logging import get_logger

log = get_logger("failpoints")

DEFAULT_SEED = 509  # pinned like the shaker's: chaos runs reproduce
_MODES = ("fail", "kill", "wedge", "sleep")
_DEFAULT_PARAMS = {"fail": 0.0, "kill": 0.0, "wedge": 3600.0, "sleep": 0.05}


class FailpointSite:
    """One armed site's parsed spec + its monotonically counted hits."""

    __slots__ = ("name", "mode", "prob", "skip", "param", "count", "injected")

    def __init__(
        self,
        name: str,
        mode: str = "fail",
        prob: float = 1.0,
        skip: int = 0,
        param: float | None = None,
    ):
        if mode not in _MODES:
            raise ValueError(f"unknown failpoint mode {mode!r}")
        self.name = name
        self.mode = mode
        self.prob = min(1.0, max(0.0, prob))
        self.skip = max(0, skip)
        self.param = _DEFAULT_PARAMS[mode] if param is None else param
        self.count = 0  # eligible calls seen; guarded by the registry lock
        self.injected = 0  # hits that actually fired


def parse_spec(raw: str) -> "dict[str, FailpointSite]":
    """Parse a FAILPOINT_SPEC string; malformed entries are dropped with
    a warning (an operator typo must degrade to fewer injections, never
    to a crashed worker at import time)."""
    sites: dict[str, FailpointSite] = {}
    for chunk in raw.replace(";", ",").split(","):
        for entry in chunk.split():
            entry = entry.strip()
            if not entry:
                continue
            site, sep, spec = entry.partition("=")
            site = site.strip()
            if not sep or not site:
                log.with_fields(entry=entry).warning(
                    "ignoring malformed FAILPOINT_SPEC entry (want site=mode)"
                )
                continue
            fields = spec.split(":")
            mode = fields[0].strip() or "fail"
            try:
                # bare-float shorthand: site=0.05 means fail at p=0.05
                prob_shorthand = float(mode)
            except ValueError:
                prob_shorthand = None
            try:
                if prob_shorthand is not None:
                    sites[site] = FailpointSite(site, "fail", prob_shorthand)
                    continue
                prob = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
                skip = int(fields[2]) if len(fields) > 2 and fields[2] else 0
                param = (
                    float(fields[3])
                    if len(fields) > 3 and fields[3]
                    else None
                )
                sites[site] = FailpointSite(site, mode, prob, skip, param)
            except ValueError as exc:
                log.with_fields(entry=entry).warning(
                    f"ignoring malformed FAILPOINT_SPEC entry ({exc})"
                )
    return sites


def seed_from_env(environ=None) -> int:
    """``FAILPOINT_SEED``: selects the injection schedule; the default
    is pinned so a spec alone already reproduces."""
    env = os.environ if environ is None else environ
    raw = (env.get("FAILPOINT_SEED") or "").strip()
    if not raw:
        return DEFAULT_SEED
    try:
        return int(raw, 0)
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid FAILPOINT_SEED (want an integer)"
        )
        return DEFAULT_SEED


def spec_from_env(environ=None) -> str:
    """``FAILPOINT_SPEC``: the armed sites (empty = every seam is a
    no-op)."""
    env = os.environ if environ is None else environ
    return (env.get("FAILPOINT_SPEC") or "").strip()


class FailpointRegistry:
    """The process-wide failpoint switchboard. ``fire(site)`` is the
    only call a seam makes; everything else is configuration and
    observability."""

    def __init__(self) -> None:
        self.seed = DEFAULT_SEED
        # empty dict == disarmed == the whole fast path: fire() checks
        # truthiness before taking any lock or hashing anything
        self._sites: dict[str, FailpointSite] = {}
        self._lock = threading.Lock()

    # -- configuration ----------------------------------------------------

    def configure(self, spec: str = "", seed: int | None = None) -> None:
        sites = parse_spec(spec) if spec else {}
        with self._lock:
            self._sites = sites
            if seed is not None:
                self.seed = seed
        if sites:
            log.with_fields(
                seed=self.seed, sites=sorted(sites)
            ).warning("failpoints ARMED (fault injection active)")

    def configure_from_env(self, environ=None) -> None:
        self.configure(spec_from_env(environ), seed_from_env(environ))

    def reset(self) -> None:
        """Test isolation: disarm everything, restore the pinned seed."""
        with self._lock:
            self._sites = {}
            self.seed = DEFAULT_SEED

    @property
    def armed(self) -> bool:
        return bool(self._sites)

    # -- the decision function (pure: tests pin it) -----------------------

    def decision(self, site: str, count: int, prob: float) -> bool:
        """Whether eligible call ``count`` at ``site`` hits, at
        probability ``prob`` — a pure function of the seed, so one
        (seed, spec) pair reproduces the whole injection schedule."""
        if prob >= 1.0:
            return True
        if prob <= 0.0:
            return False
        digest = hashlib.sha256(
            f"{self.seed}:{site}:{count}".encode()
        ).digest()
        value = int.from_bytes(digest[:8], "big")
        return (value / 2**64) < prob

    def schedule(self, site: str, calls: int) -> "list[bool]":
        """The first ``calls`` decisions the armed spec would make at
        ``site`` — what a test pins to prove purity-in-seed, without
        mutating the live counters."""
        with self._lock:
            armed = self._sites.get(site)
        if armed is None:
            return [False] * calls
        return [
            count >= armed.skip
            and self.decision(site, count, armed.prob)
            for count in range(calls)
        ]

    # -- the seam hook ----------------------------------------------------

    def fire(self, site: str) -> bool:
        """One seam evaluation. Returns True only in ``fail`` mode (the
        seam then raises its natural error); ``kill``/``wedge``/
        ``sleep`` execute their side effect here so every seam stays a
        one-liner. Disarmed (the production state): one dict check."""
        if not self._sites:
            return False
        with self._lock:
            armed = self._sites.get(site)
            if armed is None:
                return False
            count = armed.count
            armed.count += 1
            hit = count >= armed.skip and self.decision(
                site, count, armed.prob
            )
            if hit:
                armed.injected += 1
            mode = armed.mode
            param = armed.param
        if not hit:
            return False
        if mode == "kill":
            log.with_fields(site=site, call=count).error(
                "failpoint KILL: terminating this process"
            )
            os.kill(os.getpid(), signal.SIGKILL)
            return False  # unreachable; keeps the signature honest
        if mode == "wedge" or mode == "sleep":
            log.with_fields(site=site, call=count, sleep_s=param).warning(
                f"failpoint {mode}: holding this call"
            )
            time.sleep(param)
            return False
        log.with_fields(site=site, call=count).warning(
            "failpoint fail: injecting failure"
        )
        return True

    # -- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "armed": bool(self._sites),
                "seed": self.seed,
                "sites": {
                    name: {
                        "mode": site.mode,
                        "prob": site.prob,
                        "skip": site.skip,
                        "param": site.param,
                        "calls": site.count,
                        "injected": site.injected,
                    }
                    for name, site in self._sites.items()
                },
            }


# the process-wide registry, mirroring metrics.GLOBAL / watchdog.MONITOR:
# serve() arms it from the environment; with no spec every seam is a
# named no-op
FAILPOINTS = FailpointRegistry()
