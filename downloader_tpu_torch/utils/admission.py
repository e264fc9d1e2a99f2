"""The resource ledger: the part of admission the transfer path charges.

The port carries the ledger of the JAX package's utils/admission.py.
Global budgets (scratch disk for a segmented fetch's preallocated
file) are charged and refunded at the allocation sites. Charges are
idempotent per key and double-refund safe, exactly like delivery
settlement: the accounting must balance to zero even when a failure
path and a cleanup path both try to release. With no limits
configured — the one-shot CLI configures none — every charge is
within budget. Classes, tenants, quotas, the weighted-fair scheduler
and the degradation ladder come with the daemon.
"""

from __future__ import annotations

import threading


class Ledger:
    """Global resource budgets with idempotent per-key charges.

    A charge is ``(budget, key, amount)``; re-charging the same
    (budget, key) is a no-op returning the original verdict, and
    ``refund(key)`` releases every budget's charge under that key
    exactly once — double-settle safe, like delivery ack/nack. Keys
    are caller-chosen strings (a job id, an upload part, a scratch
    file) so a failure path and a cleanup path can BOTH release
    without the books going negative.

    Limits are advisory at ``charge``: the allocation already
    happened; the ledger keeps the books honest."""

    def __init__(self, limits: "dict[str, int] | None" = None):
        self._lock = threading.Lock()
        self._limits: dict[str, int] = dict(limits or {})  # guarded-by: _lock
        self._used: dict[str, int] = {}  # guarded-by: _lock
        # key -> {budget: amount}; the idempotency record
        self._charges: dict[str, dict[str, int]] = {}  # guarded-by: _lock

    def _record(self, budget: str, key: str, amount: int) -> None:  # holds: _lock
        self._used[budget] = self._used.get(budget, 0) + amount
        self._charges.setdefault(key, {})[budget] = amount

    def charge(self, budget: str, key: str, amount: int) -> bool:  # protocol: ledger-charge acquire bind=key
        """Record ``amount`` against ``budget`` under ``key``; returns
        whether the budget is still within its limit afterwards. Always
        records (the caller already allocated) — an over-limit verdict
        is a degradation signal, not a refusal. Idempotent per
        (budget, key)."""
        amount = max(0, int(amount))
        with self._lock:
            existing = self._charges.get(key)
            if existing is not None and budget in existing:
                used = self._used.get(budget, 0)
            else:
                self._record(budget, key, amount)
                used = self._used.get(budget, 0)
            limit = self._limits.get(budget, 0)
        return limit <= 0 or used <= limit

    def refund(self, key: str) -> None:  # protocol: ledger-charge release bind=key
        """Release every charge recorded under ``key``; safe to call
        any number of times (the second and later are no-ops)."""
        with self._lock:
            charges = self._charges.pop(key, None)
            if not charges:
                return
            for budget, amount in charges.items():
                self._used[budget] = max(0, self._used.get(budget, 0) - amount)


LEDGER = Ledger()


def scratch_key(path: str) -> str:
    """Ledger key for a fetch's preallocated scratch file."""
    return f"scratch:{path}"
