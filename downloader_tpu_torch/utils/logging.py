"""Structured logging with logrus-compatible semantics.

The reference uses sirupsen/logrus throughout, configured from two env vars
in its entrypoint (cmd/downloader/downloader.go:45-52):

- ``LOG_LEVEL=debug``  -> enable caller reporting (file:line on each record)
- ``LOG_FORMAT=json``  -> JSON formatter instead of key=value text

This module reproduces that surface: a leveled, field-structured logger with
``with_fields`` chaining (logrus ``WithFields``), a text formatter that
renders ``time=... level=... msg="..." key=value`` lines and a JSON
formatter, both thread-safe.

Flight-recorder addition: every emitted record also lands in a bounded
in-memory ring (``LOG_RING`` records, default 256; ``0`` disables)
with job-id/trace-id correlation fields pulled from the active tracing
context — so an incident bundle (utils/incident.py) and ``/debug/logs``
can answer "what was this process saying just before it wedged"
without grepping an external stream. The tracing module registers the
context provider at import (``set_context_provider``), keeping the
logging→tracing dependency inverted (tracing already imports us).
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Mapping, TextIO

_LEVELS = {
    "trace": 5,
    "debug": 10,
    "info": 20,
    "warn": 30,  # logrus accepts both spellings
    "warning": 30,
    "error": 40,
    "fatal": 50,
}
_LEVEL_NAMES = {10: "debug", 20: "info", 30: "warning", 40: "error", 50: "fatal"}

_lock = threading.Lock()

DEFAULT_RING = 256

# the flight-recorder ring: recent structured records as dicts. None
# when LOG_RING=0 — record capture then costs one attribute read.
_ring: "deque[dict] | None" = deque(maxlen=DEFAULT_RING)  # guarded-by: _lock
# returns correlation fields ({"job_id": ..., "trace": ...}) for the
# calling thread, or None; installed by utils.tracing at import
_context_provider: "Callable[[], dict | None] | None" = None


def set_context_provider(provider: "Callable[[], dict | None]") -> None:
    global _context_provider
    _context_provider = provider


def ring_capacity_from_env(environ=None) -> int:
    """``LOG_RING``: records kept in the in-memory ring; 0 disables."""
    env = os.environ if environ is None else environ
    raw = (env.get("LOG_RING") or "").strip()
    if not raw:
        return DEFAULT_RING
    try:
        return max(0, int(raw))
    except ValueError:
        get_logger("logging").with_fields(value=raw).warning(
            "ignoring invalid LOG_RING (want an integer)"
        )
        return DEFAULT_RING


def set_ring_capacity(capacity: int) -> None:
    global _ring
    with _lock:
        _ring = deque(_ring or (), maxlen=capacity) if capacity > 0 else None


def ring_tail(limit: int | None = None) -> list[dict]:
    """The newest ``limit`` ring records (all when None), oldest
    first — what /debug/logs serves and incident bundles embed."""
    with _lock:
        records = list(_ring) if _ring is not None else []
    if limit is not None:
        # explicit 0 branch: records[-0:] would slice the WHOLE list,
        # inverting the contract for a 0-means-none caller
        records = records[-limit:] if limit > 0 else []
    return records


def merge_ring_records(
    records_by_instance: "dict[str, list[dict]]",
    limit: int | None = None,
) -> list[dict]:
    """K-way merge of per-worker log rings by wall-clock ``ts``, each
    record tagged with its worker ``instance`` — the fleet /debug/logs
    view. The merge is a heads-only k-way merge, so it is STABLE under
    clock skew: a worker's records keep their original relative order
    no matter what its clock says (only cross-worker interleaving
    follows the timestamps, which is the best any merge can honestly
    do with skewed clocks). ``limit`` keeps the newest records."""
    import heapq

    heap: list = []
    for index, instance in enumerate(sorted(records_by_instance)):
        source = iter(records_by_instance[instance] or [])
        first = next(source, None)
        if first is not None:
            # (ts, source index, per-source counter) is a unique key, so
            # heapq never falls through to comparing the record dicts
            heapq.heappush(
                heap,
                (first.get("ts", 0.0), index, 0, instance, first, source),
            )
    merged: list[dict] = []
    while heap:
        _, index, n, instance, record, source = heapq.heappop(heap)
        tagged = dict(record)
        tagged.setdefault("instance", instance)
        merged.append(tagged)
        following = next(source, None)
        if following is not None:
            heapq.heappush(
                heap,
                (
                    following.get("ts", 0.0), index, n + 1,
                    instance, following, source,
                ),
            )
    if limit is not None and limit >= 0:
        merged = merged[-limit:] if limit > 0 else []
    return merged


class _Config:
    level: int = _LEVELS["info"]
    json_format: bool = False
    report_caller: bool = False
    stream: TextIO = sys.stderr


_config = _Config()


def configure(
    level: str = "info",
    json_format: bool = False,
    report_caller: bool = False,
    stream: TextIO | None = None,
) -> None:
    """Set global logging behavior. Mirrors logrus' global configuration."""
    with _lock:
        _config.level = _LEVELS.get(level.lower(), _LEVELS["info"])
        _config.json_format = json_format
        _config.report_caller = report_caller
        if stream is not None:
            _config.stream = stream


def configure_from_env(environ: Mapping[str, str] | None = None) -> None:
    """Configure from LOG_LEVEL / LOG_FORMAT, as the reference entrypoint
    does (cmd/downloader/downloader.go:45-52): debug level turns on caller
    reporting; LOG_FORMAT=json selects the JSON formatter."""
    env = os.environ if environ is None else environ
    level = env.get("LOG_LEVEL", "info").lower()
    configure(
        level=level,
        json_format=env.get("LOG_FORMAT", "").lower() == "json",
        report_caller=level == "debug",
    )
    set_ring_capacity(ring_capacity_from_env(env))


def _quote(value: str) -> str:
    if value == "" or any(ch in value for ch in ' "=\n\t'):
        return json.dumps(value)
    return value


class Logger:
    """A named logger carrying a set of structured fields."""

    __slots__ = ("name", "fields")

    def __init__(self, name: str = "", fields: dict[str, Any] | None = None):
        self.name = name
        self.fields = fields or {}

    def with_fields(self, **fields: Any) -> "Logger":
        merged = dict(self.fields)
        merged.update(fields)
        return Logger(self.name, merged)

    def with_field(self, key: str, value: Any) -> "Logger":
        return self.with_fields(**{key: value})

    # -- emit ------------------------------------------------------------

    def _emit(self, level: int, msg: str, exc: BaseException | None = None) -> None:
        if level < _config.level:
            return
        record: dict[str, Any] = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "level": _LEVEL_NAMES.get(level, str(level)),
            "msg": msg,
        }
        if self.name:
            record["logger"] = self.name
        if _config.report_caller:
            # first frame outside this module is the real call site
            this_file = os.path.normcase(__file__)
            for frame in reversed(traceback.extract_stack()):
                if os.path.normcase(frame.filename) != this_file:
                    record["caller"] = (
                        f"{os.path.basename(frame.filename)}:{frame.lineno}"
                    )
                    break
        for key in sorted(self.fields):
            record[key] = self.fields[key]
        if exc is not None:
            record["error"] = f"{type(exc).__name__}: {exc}"

        if _ring is not None:
            # flight-recorder copy BEFORE the text formatter mutates
            # the record; correlation fields come from the active trace
            # so /debug/logs and incident bundles line records up with
            # the job that emitted them
            entry = dict(record)
            entry["ts"] = time.time()
            provider = _context_provider
            if provider is not None:
                try:
                    context = provider()
                except Exception:
                    context = None  # a tracing bug must not kill logging
                if context:
                    for key, value in context.items():
                        entry.setdefault(key, value)
            with _lock:
                if _ring is not None:
                    _ring.append(entry)

        if _config.json_format:
            line = json.dumps(record, default=str)
        else:
            buf = io.StringIO()
            buf.write(f'time={record.pop("time")} level={record.pop("level")} ')
            buf.write(f'msg={_quote(record.pop("msg"))}')
            for key, value in record.items():
                buf.write(f" {key}={_quote(str(value))}")
            line = buf.getvalue()

        with _lock:
            _config.stream.write(line + "\n")
            _config.stream.flush()

    def debug(self, msg: str) -> None:
        self._emit(_LEVELS["debug"], msg)

    def info(self, msg: str) -> None:
        self._emit(_LEVELS["info"], msg)

    def warning(self, msg: str) -> None:
        self._emit(_LEVELS["warning"], msg)

    warn = warning

    def error(self, msg: str, exc: BaseException | None = None) -> None:
        self._emit(_LEVELS["error"], msg, exc)

    def fatal(self, msg: str, exc: BaseException | None = None) -> None:
        """Log at fatal level and raise SystemExit(1), like logrus.Fatal
        (used by the reference entrypoint, e.g. cmd/downloader/downloader.go:64)."""
        self._emit(_LEVELS["fatal"], msg, exc)
        raise SystemExit(1)


def get_logger(name: str = "") -> Logger:
    return Logger(name)
