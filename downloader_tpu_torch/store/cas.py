"""Bounded on-disk content-addressed cache: the environment readers
``Config`` needs.

The port carries the ``CACHE_DIR``, ``CACHE_MAX_BYTES`` and
``CACHE_TTL_S`` readers of the JAX package's store/cas.py, so that
``Config.from_env`` parses every knob as the reference does. The
store itself (``ContentStore``, ``content_key``, ``materialize``) comes
with the fleet data plane; until then ``serve()`` refuses ``CACHE_DIR``.
"""

from __future__ import annotations

import os

from ..utils.logging import get_logger

log = get_logger("cas")

DEFAULT_MAX_BYTES = 2 * 1024**3
DEFAULT_TTL_S = 24 * 3600.0


def dir_from_env(environ=None) -> str:
    """``CACHE_DIR``: root of the shared content-addressed cache;
    empty (the default) disables the fleet data plane entirely."""
    env = os.environ if environ is None else environ
    return (env.get("CACHE_DIR") or "").strip()


def max_bytes_from_env(environ=None) -> int:
    """``CACHE_MAX_BYTES``: byte bound on the store (eviction keeps it
    under this; 0 = unbounded)."""
    env = os.environ if environ is None else environ
    raw = (env.get("CACHE_MAX_BYTES") or "").strip()
    if not raw:
        return DEFAULT_MAX_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CACHE_MAX_BYTES (want an integer)"
        )
        return DEFAULT_MAX_BYTES


def ttl_from_env(environ=None) -> float:
    """``CACHE_TTL_S``: entry time-to-live in seconds (0 disables TTL
    expiry; LRU still bounds the store)."""
    env = os.environ if environ is None else environ
    raw = (env.get("CACHE_TTL_S") or "").strip()
    if not raw:
        return DEFAULT_TTL_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid CACHE_TTL_S (want seconds)"
        )
        return DEFAULT_TTL_S
