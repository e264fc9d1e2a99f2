"""Cross-process single-flight coalescing: the environment readers
``Config`` needs.

The port carries the ``SINGLEFLIGHT_DIR``, ``SINGLEFLIGHT_LEASE_S`` and
``SINGLEFLIGHT_WAIT_S`` readers of the JAX package's
fetch/singleflight.py, so that ``Config.from_env`` parses every knob as
the reference does. The lease election and the follower's wait come
with the fleet data plane (``CACHE_DIR``); until then ``serve()``
refuses ``CACHE_DIR``.
"""

from __future__ import annotations

import os

from ..utils.logging import get_logger

log = get_logger("singleflight")

DEFAULT_LEASE_S = 10.0
DEFAULT_WAIT_S = 120.0


def inflight_dir_from_env(environ=None) -> str:
    """``SINGLEFLIGHT_DIR``: where the in-flight lease index lives;
    empty derives ``<CACHE_DIR>/inflight`` (the supervisor pins one
    absolute path into every worker so the index is fleet-shared)."""
    env = os.environ if environ is None else environ
    return (env.get("SINGLEFLIGHT_DIR") or "").strip()


def lease_ttl_from_env(environ=None) -> float:
    """``SINGLEFLIGHT_LEASE_S``: how long a lease may go un-beaten
    before a follower may promote itself over it."""
    env = os.environ if environ is None else environ
    raw = (env.get("SINGLEFLIGHT_LEASE_S") or "").strip()
    if not raw:
        return DEFAULT_LEASE_S
    try:
        return max(0.1, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid SINGLEFLIGHT_LEASE_S (want seconds)"
        )
        return DEFAULT_LEASE_S


def wait_from_env(environ=None) -> float:
    """``SINGLEFLIGHT_WAIT_S``: how long a follower waits on a live
    leader before giving up and fetching directly (correctness over
    dedup: a timeout re-amplifies, it never fails the job)."""
    env = os.environ if environ is None else environ
    raw = (env.get("SINGLEFLIGHT_WAIT_S") or "").strip()
    if not raw:
        return DEFAULT_WAIT_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid SINGLEFLIGHT_WAIT_S (want seconds)"
        )
        return DEFAULT_WAIT_S
