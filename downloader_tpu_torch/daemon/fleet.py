"""Crash-only worker fleet: the environment readers ``Config`` needs.

The port carries the ``FLEET_WORKERS`` and ``FLEET_HEARTBEAT_S``
readers of the JAX package's daemon/fleet.py, so that
``Config.from_env`` parses every knob as the reference does. The
supervisor (``run_fleet``), its worker handles and the worker's
``HeartbeatWriter`` come with the fleet; until then ``serve --workers
N`` with N > 1 exits 2 and ``serve()`` refuses ``FLEET_HEARTBEAT_FILE``.
"""

from __future__ import annotations

import os

from ..utils import get_logger

log = get_logger("fleet")

DEFAULT_HEARTBEAT_S = 1.0


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
