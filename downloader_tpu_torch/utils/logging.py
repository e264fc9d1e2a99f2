"""Structured logging with logrus-compatible semantics.

A leveled, field-structured logger with ``with_fields`` chaining and a
text (``time=... level=... msg="..." key=value``) or JSON formatter,
as the JAX package's utils/logging.py has. The port carries only the
emitting half; reading ``LOG_LEVEL``/``LOG_FORMAT`` comes with the CLI
and the flight-recorder ring with the planes that read it.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from typing import Any, TextIO

_LEVELS = {
    "trace": 5,
    "debug": 10,
    "info": 20,
    "warn": 30,
    "warning": 30,
    "error": 40,
    "fatal": 50,
}
_LEVEL_NAMES = {10: "debug", 20: "info", 30: "warning", 40: "error", 50: "fatal"}

_lock = threading.Lock()


class _Config:
    level: int = _LEVELS["info"]
    json_format: bool = False
    stream: TextIO = sys.stderr


_config = _Config()


def configure(
    level: str = "info", json_format: bool = False, stream: TextIO | None = None
) -> None:
    """Set global logging behavior."""
    with _lock:
        _config.level = _LEVELS.get(level.lower(), _LEVELS["info"])
        _config.json_format = json_format
        if stream is not None:
            _config.stream = stream


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
        for key in sorted(self.fields):
            record[key] = self.fields[key]
        if exc is not None:
            record["error"] = f"{type(exc).__name__}: {exc}"
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


def get_logger(name: str = "") -> Logger:
    return Logger(name)
