"""Seeded schedule perturbation: the runtime recorders' third half.

The static rules prove what they can see; the runtime recorders
(``analysis/runtime.py``) watch what actually interleaves — but a test
suite only ever explores the scheduler's favorite interleaving, so a
latent race or lock-order inversion that needs an unlucky preemption
stays invisible run after run. ``ScheduleShaker`` injects
deterministic pseudo-random yields at the recorders' own patch points
(lock acquire/release, protocol acquire/release), so the
shaken suites (single-flight here) explore *perturbed* interleavings in
tier-1 — at a pinned seed, so a failure reproduces.

Determinism contract: every perturbation point is keyed by its *site*
(the lock's creation site, or ``Class.method`` for protocol patches)
and a per-site counter; the decision is a pure hash of
``(seed, site, counter)``. Two runs with the same seed make the same
decision sequence at every site — which thread arrives at decision
*n* first still belongs to the OS, but the yields themselves (where
the schedule gets bent) are reproducible, and in practice a long
yield at the right site pins the outcome.

Knobs: ``SCHEDULE_SHAKE_SEED`` selects the decision sequence
(``ScheduleShaker.from_env``; default pinned so tier-1 is
reproducible). ``rate`` yields roughly every N-th decision per site
(``time.sleep(0)`` — a GIL drop), ``long_every`` promotes every N-th
yield to a real sleep of ``sleep_s`` — long enough for a waiting
thread to actually run into the widened window.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time

DEFAULT_SEED = 1307  # pinned: tier-1 explores this seed's schedule
_REAL_LOCK = threading.Lock


class ScheduleShaker:
    """Deterministic yield injection for the runtime recorders. Pass
    one to ``LockOrderRecorder(shaker=...)`` /
    ``ProtocolRecorder(shaker=...)``; every acquire/release they
    intercept calls :meth:`perturb` with its site key."""

    def __init__(
        self,
        seed: int | None = None,
        rate: int = 16,
        long_every: int = 8,
        sleep_s: float = 0.0005,
    ):
        self.seed = DEFAULT_SEED if seed is None else int(seed)
        self.rate = max(1, int(rate))
        self.long_every = max(1, int(long_every))
        self.sleep_s = sleep_s
        self._counts: dict[str, int] = {}
        self._counts_lock = _REAL_LOCK()
        self.yields = 0  # observability: total yields injected
        self.long_yields = 0
        # timing-measurement tests (overhead guards) pause the shaker:
        # they measure the product, not the harness
        self.enabled = True

    @classmethod
    def from_env(cls, environ=None) -> "ScheduleShaker":
        env = os.environ if environ is None else environ
        raw = env.get("SCHEDULE_SHAKE_SEED")
        seed = None
        if raw:
            try:
                seed = int(raw, 0)
            except ValueError:
                seed = None
        return cls(seed=seed)

    # -- the decision function (pure: tests rely on it) -------------------

    def decision(self, site: str, count: int) -> str | None:
        """The (seed, site, counter)-determined action: None,
        ``"yield"`` (drop the GIL), or ``"sleep"`` (widen the window).
        Pure function — two shakers with one seed agree everywhere."""
        digest = hashlib.sha256(
            f"{self.seed}:{site}:{count}".encode()
        ).digest()
        value = int.from_bytes(digest[:8], "big")
        if value % self.rate != 0:
            return None
        return "sleep" if (value // self.rate) % self.long_every == 0 else "yield"

    # -- the hook the recorders call --------------------------------------

    @contextlib.contextmanager
    def paused(self):
        """Suspend yield injection (timing guards measure the product,
        not the harness); decision counters keep advancing so the
        post-pause stream stays seed-deterministic."""
        self.enabled = False
        try:
            yield self
        finally:
            self.enabled = True

    def perturb(self, site: str) -> None:
        with self._counts_lock:
            count = self._counts.get(site, 0)
            self._counts[site] = count + 1
        if not self.enabled:
            return  # paused: counters advance, yields don't (see paused)
        action = self.decision(site, count)
        if action is None:
            return
        with self._counts_lock:
            # read-modify-write under the lock: perturb is hammered
            # from every recorded thread at once, by design
            self.yields += 1
            if action == "sleep":
                self.long_yields += 1
        time.sleep(self.sleep_s if action == "sleep" else 0)
