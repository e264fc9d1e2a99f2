"""SLO-aware admission: priority lanes, per-tenant fairness, and load
shedding under overload.

Everything before this layer hardens one worker's happy path; nothing
protects it from hostile *load*. Heavy traffic is bursty and
adversarial: one tenant with a slow origin can otherwise occupy every
prefetch slot, part-pool buffer, and scratch-disk byte while
interactive jobs starve behind it. Shared capacity must be partitioned
at admission, not discovered at exhaustion, so this module sits
between dequeue and the pipeline:

- **Classes and tenants.** Jobs carry a class (``interactive`` |
  ``bulk``) and a tenant id in message headers (queue/delivery.py owns
  the header names); unclassified traffic gets the configurable
  default class and the ``default`` tenant.
- **Weighted-fair ordering.** ``DeficitScheduler`` orders each dequeue
  wave across (class, tenant) lanes with deficit round-robin: the
  interactive class gets a larger quantum, but bulk lanes still drain
  every round — weighted priority, never starvation.
- **Per-tenant quotas.** In-flight jobs and in-flight bytes per tenant
  are capped; the N+1st job is explicitly rejected (shed with
  Retry-After), not silently queued behind the tenant's own backlog.
- **One resource ledger.** Global budgets — part-pool memory, scratch
  disk, batch-lane slots — are charged and refunded at the allocation
  sites (store/pipeline.py, fetch/segments.py, daemon/app.py).
  Charges are idempotent per key and double-refund safe, exactly like
  delivery settlement: the accounting must balance to zero even when a
  failure path and a cleanup path both try to release.
- **A degradation ladder, in order.** As ledger pressure rises the
  worker degrades gracefully: shrink prefetch (stop amplifying the
  backlog), demote bulk to a paused lane (interactive keeps flowing),
  then explicitly shed — nack to a dead-letter queue with Retry-After
  semantics and a capped redelivery count instead of requeueing
  forever. The first shed of an overload episode captures a
  rate-limited incident bundle tagging the offending tenant and the
  tripped budget.

``full_jitter`` is the retry-pacing companion: a shed-then-retry burst
re-arrives spread over the whole backoff window (AWS full jitter)
instead of thundering-herding the origin at the same instant.
"""

from __future__ import annotations

import os
import random
import threading
from collections import OrderedDict, deque

from . import metrics
from .logging import get_logger

log = get_logger("admission")

JOB_CLASSES = ("interactive", "bulk")
# the synthetic-probe class (utils/canary.py): admitted and scheduled
# like user traffic so probes ride the real path, but excluded from the
# user SLO histograms, flow amplification, and heavy-hitter sketches
CANARY_CLASS = "canary"
DEFAULT_CLASS = "bulk"
DEFAULT_TENANT = "default"

# degradation ladder thresholds, as fractions of the tightest ledger
# budget: shrink the prefetch window first, pause the bulk lanes next,
# shed only when the budget is actually exhausted
DEFAULT_SHRINK_AT = 0.75
DEFAULT_PAUSE_AT = 0.90
DEFAULT_SHED_AT = 1.0

DEFAULT_CLASS_WEIGHTS = {"interactive": 4, "bulk": 1}

# ladder rungs (ordered; snapshot() reports the name)
LEVEL_NORMAL = 0
LEVEL_SHRINK = 1
LEVEL_PAUSE_BULK = 2
LEVEL_SHED = 3
_LEVEL_NAMES = ("normal", "shrink-prefetch", "pause-bulk", "shed")

# how many (class, tenant) lanes the scheduler will track before
# folding strangers into a shared overflow lane — an attacker minting
# tenant ids must not grow worker memory without bound
MAX_LANES = 512


def full_jitter(
    attempt: int, base: float, cap: float, rng: "random.Random | None" = None
) -> float:
    """Full-jitter backoff: uniform in ``[0, min(cap, base * 2**attempt))``.

    The whole window is randomized (not just a fraction of it) because
    the callers are *synchronized by construction*: a shed wave or a
    broker outage fails many jobs at the same instant, and anything
    deterministic re-arrives as the same burst that was just shed."""
    attempt = max(0, min(attempt, 32))  # 2**33 would dwarf any real cap
    ceiling = min(cap, base * (2 ** attempt))
    if ceiling <= 0:
        return 0.0
    return (rng or random).uniform(0.0, ceiling)


def retry_after_for(shed_count: int, base: float, cap: float) -> int:
    """The Retry-After hint stamped on a shed job: the capped
    exponential ceiling, deterministic and in whole seconds (the
    consumer side applies ``full_jitter`` when it re-paces)."""
    shed_count = max(0, min(shed_count, 32))
    return max(1, int(min(cap, base * (2 ** shed_count))))


def normalize_class(value, default: str = DEFAULT_CLASS) -> str:
    """Map a raw header value onto a known job class."""
    if isinstance(value, bytes):
        try:
            value = value.decode("ascii")
        except UnicodeDecodeError:
            return default
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered in JOB_CLASSES or lowered == CANARY_CLASS:
            return lowered
    return default


def normalize_tenant(value) -> str:
    if isinstance(value, bytes):
        try:
            value = value.decode("utf-8")
        except UnicodeDecodeError:
            return DEFAULT_TENANT
    if isinstance(value, str) and value.strip():
        return value.strip()[:128]
    return DEFAULT_TENANT


# -- env parsing (Config.from_env delegates here) ---------------------------


def default_class_from_env(environ=None) -> str:
    env = os.environ if environ is None else environ
    raw = (env.get("ADMISSION_DEFAULT_CLASS") or "").strip().lower()
    if not raw:
        return DEFAULT_CLASS
    if raw not in JOB_CLASSES:
        log.with_fields(value=raw).warning(
            "ignoring invalid ADMISSION_DEFAULT_CLASS (want interactive|bulk)"
        )
        return DEFAULT_CLASS
    return raw


def _int_env(env, name: str, default: int) -> int:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            f"ignoring invalid {name} (want an integer)"
        )
        return default


def _float_env(env, name: str, default: float) -> float:
    raw = (env.get(name) or "").strip()
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            f"ignoring invalid {name} (want a number)"
        )
        return default


def budgets_from_env(environ=None) -> dict[str, int]:
    """The ledger budget limits (bytes / slots; 0 = unlimited)."""
    env = os.environ if environ is None else environ
    return {
        "memory": _int_env(env, "ADMISSION_MEMORY_BUDGET", 0),
        "disk": _int_env(env, "ADMISSION_DISK_BUDGET", 0),
        "batch_slots": _int_env(env, "ADMISSION_BATCH_SLOTS", 0),
    }


def quotas_from_env(environ=None) -> tuple[int, int]:
    """(per-tenant in-flight job cap, per-tenant in-flight byte cap);
    0 = unlimited."""
    env = os.environ if environ is None else environ
    return (
        _int_env(env, "QUOTA_TENANT_JOBS", 0),
        _int_env(env, "QUOTA_TENANT_BYTES", 0),
    )


def class_weights_from_env(environ=None) -> dict[str, int]:
    """``ADMISSION_CLASS_WEIGHTS``: ``class=weight`` pairs, e.g.
    ``interactive=4,bulk=1`` (the default). Weights are DRR quanta —
    relative service shares per wave, not absolute priorities."""
    env = os.environ if environ is None else environ
    raw = (env.get("ADMISSION_CLASS_WEIGHTS") or "").strip()
    weights = dict(DEFAULT_CLASS_WEIGHTS)
    if not raw:
        return weights
    for pair in raw.split(","):
        pair = pair.strip()
        if not pair:
            continue
        name, _, value = pair.partition("=")
        name = name.strip().lower()
        try:
            parsed = max(1, int(value))
        except ValueError:
            log.with_fields(pair=pair).warning(
                "ignoring invalid ADMISSION_CLASS_WEIGHTS entry "
                "(want class=weight)"
            )
            continue
        if name in JOB_CLASSES:
            weights[name] = parsed
    return weights


def ladder_from_env(environ=None) -> tuple[float, float, float]:
    env = os.environ if environ is None else environ
    return (
        _float_env(env, "ADMISSION_SHRINK_AT", DEFAULT_SHRINK_AT),
        _float_env(env, "ADMISSION_PAUSE_AT", DEFAULT_PAUSE_AT),
        _float_env(env, "ADMISSION_SHED_AT", DEFAULT_SHED_AT),
    )


def min_prefetch_from_env(environ=None) -> int:
    env = os.environ if environ is None else environ
    return max(1, _int_env(env, "ADMISSION_MIN_PREFETCH", 1))


# -- the resource ledger ----------------------------------------------------


class Ledger:
    """Global resource budgets with idempotent per-key charges.

    A charge is ``(budget, key, amount)``; re-charging the same
    (budget, key) is a no-op returning the original verdict, and
    ``refund(key)`` releases every budget's charge under that key
    exactly once — double-settle safe, like delivery ack/nack. Keys
    are caller-chosen strings (a job id, an upload part, a scratch
    file) so a failure path and a cleanup path can BOTH release
    without the books going negative.

    Limits are advisory at ``charge`` (the allocation already
    happened; the ledger keeps the books honest and the pressure
    visible) and enforcing at ``try_charge`` (nothing is recorded on
    a refusal)."""

    def __init__(self, limits: "dict[str, int] | None" = None):
        self._lock = threading.Lock()
        self._limits: dict[str, int] = dict(limits or {})  # guarded-by: _lock
        self._used: dict[str, int] = {}  # guarded-by: _lock
        # key -> {budget: amount}; the idempotency record
        self._charges: dict[str, dict[str, int]] = {}  # guarded-by: _lock

    def configure(self, limits: "dict[str, int]") -> None:
        with self._lock:
            self._limits.update(limits)

    def reset(self) -> None:
        """Test isolation: forget every charge and restore no limits."""
        with self._lock:
            self._limits.clear()
            self._used.clear()
            self._charges.clear()

    def limit(self, budget: str) -> int:
        with self._lock:
            return self._limits.get(budget, 0)

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

    def try_charge(self, budget: str, key: str, amount: int) -> bool:  # protocol: ledger-charge acquire bind=key conditional
        """Charge only if it fits; nothing is recorded on refusal, so
        a refused admission can retry later. Idempotent: a key already
        charged against ``budget`` is a successful no-op."""
        amount = max(0, int(amount))
        with self._lock:
            existing = self._charges.get(key)
            if existing is not None and budget in existing:
                return True
            limit = self._limits.get(budget, 0)
            if limit > 0 and self._used.get(budget, 0) + amount > limit:
                return False
            self._record(budget, key, amount)
        return True

    def refund(self, key: str) -> None:  # protocol: ledger-charge release bind=key
        """Release every charge recorded under ``key``; safe to call
        any number of times (the second and later are no-ops)."""
        with self._lock:
            charges = self._charges.pop(key, None)
            if not charges:
                return
            for budget, amount in charges.items():
                self._used[budget] = max(0, self._used.get(budget, 0) - amount)

    def outstanding(self) -> dict[str, int]:
        """Per-budget bytes/slots currently charged (tests assert this
        balances to zero after every run)."""
        with self._lock:
            return {b: u for b, u in self._used.items() if u}

    def pressure(self) -> float:
        """Utilization of the tightest limited budget (0.0 when nothing
        is limited) — the degradation ladder's input signal."""
        with self._lock:
            worst = 0.0
            for budget, limit in self._limits.items():
                if limit <= 0:
                    continue
                worst = max(worst, self._used.get(budget, 0) / limit)
        return worst

    def tripped(self) -> "str | None":
        """The name of a budget at/over its limit, or None. When
        several are over, the most saturated one is reported (the
        incident bundle tags a single offender)."""
        with self._lock:
            worst_name, worst_ratio = None, 0.0
            for budget, limit in self._limits.items():
                if limit <= 0:
                    continue
                ratio = self._used.get(budget, 0) / limit
                if ratio >= 1.0 and ratio > worst_ratio:
                    worst_name, worst_ratio = budget, ratio
        return worst_name

    def snapshot(self) -> dict:
        with self._lock:
            budgets = sorted(set(self._limits) | set(self._used))
            return {
                "budgets": {
                    name: {
                        "limit": self._limits.get(name, 0),
                        "used": self._used.get(name, 0),
                    }
                    for name in budgets
                },
                "charged_keys": len(self._charges),
            }


# -- weighted-fair wave ordering --------------------------------------------


class _Lane:
    __slots__ = ("items", "deficit")

    def __init__(self):
        self.items: deque = deque()
        self.deficit = 0.0


class DeficitScheduler:
    """Deficit round-robin across (class, tenant) lanes.

    Each wave, every non-empty lane's deficit grows by its class
    weight and the lane emits jobs while its deficit covers them
    (cost 1 per job). Interactive lanes get a bigger quantum so they
    go first and get more slots, but a bulk lane's deficit accrues
    every round it waits — bulk never fully starves. Within one lane
    the order stays strictly FIFO, so single-tenant traffic behaves
    exactly like the pre-admission dequeue."""

    def __init__(self, weights: "dict[str, int] | None" = None):
        self._lock = threading.Lock()
        self._weights = dict(weights or DEFAULT_CLASS_WEIGHTS)
        # insertion-ordered: round-robin position is arrival order of
        # the lane's first job, grouped class-major below
        self._lanes: "OrderedDict[tuple[str, str], _Lane]" = OrderedDict()  # guarded-by: _lock

    def configure(self, weights: "dict[str, int]") -> None:
        with self._lock:
            self._weights.update(weights)

    def offer(self, item, job_class: str, tenant: str) -> None:
        key = (job_class, tenant)
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                if len(self._lanes) >= MAX_LANES:
                    # fold strangers into a shared per-class overflow
                    # lane: bounded memory beats per-tenant fairness
                    # for tenant id cardinality attacks
                    key = (job_class, "__overflow__")
                    lane = self._lanes.get(key)
                if lane is None:
                    lane = self._lanes[key] = _Lane()
            lane.items.append(item)
            metrics.GLOBAL.gauge_add("admission_lane_depth", 1)

    def take(self, limit: int, paused_classes: "set[str] | frozenset[str]" = frozenset()) -> list:
        """Emit up to ``limit`` jobs in DRR order. Lanes of a paused
        class are skipped entirely with their deficit FROZEN — no
        credit banks while parked, so a resumed lane re-enters at its
        pre-pause share instead of bursting to catch up (the pause
        exists to shed load; a catch-up burst would re-spike it).
        Lanes drained empty reset their deficit (classic DRR: credit
        does not bank while idle)."""
        out: list = []
        with self._lock:
            if limit <= 0 or not self._lanes:
                return out
            # class-major order: all interactive lanes before bulk in
            # each round, tenants round-robin within the class
            ordered = sorted(
                self._lanes.items(),
                key=lambda kv: -self._weights.get(kv[0][0], 1),
            )
            progressed = True
            while len(out) < limit and progressed:
                progressed = False
                for (job_class, tenant), lane in ordered:
                    if not lane.items:
                        lane.deficit = 0.0
                        continue
                    if job_class in paused_classes:
                        continue
                    lane.deficit += self._weights.get(job_class, 1)
                    while lane.items and lane.deficit >= 1.0 and len(out) < limit:
                        out.append(lane.items.popleft())
                        lane.deficit -= 1.0
                        progressed = True
                    if not lane.items:
                        lane.deficit = 0.0
            for key in [k for k, lane in self._lanes.items() if not lane.items]:
                del self._lanes[key]
        if out:
            metrics.GLOBAL.gauge_add("admission_lane_depth", -len(out))
        return out

    def pending(self, include_classes: "set[str] | None" = None) -> int:
        with self._lock:
            return sum(
                len(lane.items)
                for (job_class, _), lane in self._lanes.items()
                if include_classes is None or job_class in include_classes
            )

    def drain(self) -> list:
        """Every parked item, lanes cleared — shutdown hands them back
        to the broker."""
        out: list = []
        with self._lock:
            for lane in self._lanes.values():
                out.extend(lane.items)
                lane.items.clear()
            self._lanes.clear()
        if out:
            metrics.GLOBAL.gauge_add("admission_lane_depth", -len(out))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                f"{job_class}/{tenant}": len(lane.items)
                for (job_class, tenant), lane in self._lanes.items()
            }


# -- admission decisions ----------------------------------------------------


class Decision:
    """One admission verdict. ``action`` is ``admit`` | ``defer`` |
    ``shed``; admitted jobs carry a ``release`` callable the caller
    must wire to job settlement (idempotent — double release is
    safe)."""

    __slots__ = ("action", "reason", "release")

    def __init__(self, action: str, reason: str = "", release=None):
        self.action = action
        self.reason = reason
        self.release = release or (lambda: None)


class AdmissionController:
    """Quotas + the degradation ladder over one ledger.

    Thread-safe; shared by every worker. The controller owns
    per-tenant in-flight accounting and the overload-episode state;
    the scheduler owns lane ordering; the ledger owns resource
    budgets. ``decide`` is consulted per job as the wave is built."""

    def __init__(self, ledger: "Ledger | None" = None):
        self.ledger = ledger if ledger is not None else Ledger()
        self.scheduler = DeficitScheduler()
        self._lock = threading.Lock()
        self.quota_jobs = 0  # per-tenant in-flight job cap; 0 = unlimited
        self.quota_bytes = 0  # per-tenant in-flight byte cap; 0 = unlimited
        self.shrink_at = DEFAULT_SHRINK_AT
        self.pause_at = DEFAULT_PAUSE_AT
        self.shed_at = DEFAULT_SHED_AT
        self._tenant_jobs: dict[str, int] = {}  # guarded-by: _lock
        self._tenant_bytes: dict[str, int] = {}  # guarded-by: _lock
        self._released: set[str] = set()  # release idempotency; guarded-by: _lock
        self._admit_seq = 0  # guarded-by: _lock
        self._episode_open = False  # one incident per overload episode; guarded-by: _lock
        self._stalled_tenants: dict[str, int] = {}  # guarded-by: _lock

    def configure(
        self,
        budgets: "dict[str, int] | None" = None,
        quota_jobs: "int | None" = None,
        quota_bytes: "int | None" = None,
        weights: "dict[str, int] | None" = None,
        shrink_at: "float | None" = None,
        pause_at: "float | None" = None,
        shed_at: "float | None" = None,
    ) -> None:
        if budgets is not None:
            self.ledger.configure(budgets)
        if weights is not None:
            self.scheduler.configure(weights)
        if quota_jobs is not None:
            self.quota_jobs = quota_jobs
        if quota_bytes is not None:
            self.quota_bytes = quota_bytes
        if shrink_at is not None:
            self.shrink_at = shrink_at
        if pause_at is not None:
            self.pause_at = pause_at
        if shed_at is not None:
            self.shed_at = shed_at

    def reset(self) -> None:
        """Test isolation: forget tenants, lanes, episode state, and
        the ledger's charges."""
        with self._lock:
            self._tenant_jobs.clear()
            self._tenant_bytes.clear()
            self._released.clear()
            self._episode_open = False
            self._stalled_tenants.clear()
        self.scheduler.drain()
        self.ledger.reset()
        self.quota_jobs = 0
        self.quota_bytes = 0
        self.shrink_at = DEFAULT_SHRINK_AT
        self.pause_at = DEFAULT_PAUSE_AT
        self.shed_at = DEFAULT_SHED_AT
        metrics.GLOBAL.gauge_set("admission_lane_depth", 0)
        metrics.GLOBAL.gauge_set("admission_level", 0)
        metrics.GLOBAL.gauge_set("admission_pressure", 0.0)
        metrics.GLOBAL.gauge_set("admission_inflight_jobs", 0)

    # -- the degradation ladder -------------------------------------------

    def level(self) -> int:
        """Current ladder rung from ledger pressure. Exported as the
        ``admission_level`` gauge so an operator can see the worker
        walking down the ladder before anything is shed."""
        pressure = self.ledger.pressure()
        if pressure >= self.shed_at:
            rung = LEVEL_SHED
        elif pressure >= self.pause_at:
            rung = LEVEL_PAUSE_BULK
        elif pressure >= self.shrink_at:
            rung = LEVEL_SHRINK
        else:
            rung = LEVEL_NORMAL
        metrics.GLOBAL.gauge_set("admission_pressure", round(pressure, 4))
        metrics.GLOBAL.gauge_set("admission_level", rung)
        return rung

    def bulk_paused(self) -> bool:
        return self.level() >= LEVEL_PAUSE_BULK

    # -- per-job decisions -------------------------------------------------

    def precheck(
        self, job_class: str, tenant: str, rung: int
    ) -> "Decision | None":
        """The probe-free half of ``decide``: verdicts that need no
        object size — the job-count quota and the ladder — so a wave
        builder can skip the synchronous origin HEAD for candidates it
        would reject anyway (a shed-bound candidate's hostile origin
        must not burn the wave's probe budget). Returns the rejecting
        Decision, or None for "would admit so far" (nothing is
        recorded; ``decide`` re-checks under the same lock)."""
        with self._lock:
            jobs = self._tenant_jobs.get(tenant, 0)
            if self.quota_jobs > 0 and jobs + 1 > self.quota_jobs:
                metrics.GLOBAL.add("admission_quota_rejects")
                return Decision("shed", "tenant-job-quota")
        if job_class == "bulk" and rung >= LEVEL_SHED:
            return Decision("shed", "overload")
        if job_class == "bulk" and rung >= LEVEL_PAUSE_BULK:
            return Decision("defer", "bulk-paused")
        return None

    def decide(
        self,
        job_class: str,
        tenant: str,
        size: "int | None" = None,
        rung: "int | None" = None,
    ) -> Decision:
        """One job's admission verdict, in check order: tenant job
        quota, tenant byte quota, then the ladder (bulk shed under
        exhaustion). Admission records the tenant's in-flight charge;
        the returned ``release`` refunds it exactly once. Callers
        building a whole wave pass ``rung`` so the ladder (and its
        gauge updates) is evaluated once per wave, not once per job."""
        size = int(size or 0)
        if rung is None:
            rung = self.level()
        with self._lock:
            jobs = self._tenant_jobs.get(tenant, 0)
            held = self._tenant_bytes.get(tenant, 0)
            if self.quota_jobs > 0 and jobs + 1 > self.quota_jobs:
                metrics.GLOBAL.add("admission_quota_rejects")
                return Decision("shed", "tenant-job-quota")
            if self.quota_bytes > 0 and size > 0 and held + size > self.quota_bytes:
                metrics.GLOBAL.add("admission_quota_rejects")
                return Decision("shed", "tenant-byte-quota")
            if job_class == "bulk" and rung >= LEVEL_SHED:
                return Decision("shed", "overload")
            if job_class == "bulk" and rung >= LEVEL_PAUSE_BULK:
                return Decision("defer", "bulk-paused")
            self._admit_seq += 1
            key = f"admit-{self._admit_seq}"
            self._tenant_jobs[tenant] = jobs + 1
            self._tenant_bytes[tenant] = held + size
        metrics.GLOBAL.gauge_add("admission_inflight_jobs", 1)

        def release(tenant=tenant, size=size, key=key):
            self._release(tenant, size, key)

        return Decision("admit", "", release)

    def _release(self, tenant: str, size: int, key: str) -> None:
        with self._lock:
            if key in self._released:
                return
            self._released.add(key)
            if len(self._released) > 65536:
                # settled keys only matter for double-release safety of
                # IN-FLIGHT jobs; a bounded clear keeps memory flat
                self._released = {key}
            jobs = self._tenant_jobs.get(tenant, 0) - 1
            if jobs > 0:
                self._tenant_jobs[tenant] = jobs
            else:
                self._tenant_jobs.pop(tenant, None)
            held = self._tenant_bytes.get(tenant, 0) - size
            if held > 0:
                self._tenant_bytes[tenant] = held
            else:
                self._tenant_bytes.pop(tenant, None)
        metrics.GLOBAL.gauge_add("admission_inflight_jobs", -1)

    # -- overload episodes -------------------------------------------------

    def note_shed(self, tenant: str, reason: str) -> bool:
        """Record one shed; returns True when this shed OPENS an
        overload episode (the caller captures the incident bundle —
        once per episode, the recorder rate-limits mass events)."""
        metrics.GLOBAL.add("admission_shed_jobs")
        with self._lock:
            opened = not self._episode_open
            self._episode_open = True
        return opened

    def rearm_episode(self) -> None:
        """The episode-opening shed's incident capture was suppressed
        (the recorder's shared auto rate limit — a watchdog stall
        often co-occurs with overload): re-arm so a LATER shed of the
        same overload retries the capture instead of the episode's one
        bundle being silently lost."""
        with self._lock:
            self._episode_open = False

    def note_calm(self) -> None:
        """A wave passed with nothing shed and pressure below the shed
        rung: the overload episode (if one was open) is over, and the
        NEXT shed captures a fresh incident."""
        if self.ledger.pressure() >= self.shed_at:
            return
        with self._lock:
            self._episode_open = False

    def note_stall(self, tenant: str) -> None:
        """The watchdog flagged a stalled job belonging to ``tenant``
        (lane bookkeeping for /debug/admission; the quota refund rides
        the job's settlement, so a cancelled stall frees its slot the
        moment it settles rather than leaking it). Bounded like the
        scheduler's lanes: an attacker minting tenant ids whose jobs
        stall must not grow worker memory without bound — the oldest
        entry is evicted past MAX_LANES."""
        with self._lock:
            if (
                tenant not in self._stalled_tenants
                and len(self._stalled_tenants) >= MAX_LANES
            ):
                self._stalled_tenants.pop(
                    next(iter(self._stalled_tenants))
                )
            self._stalled_tenants[tenant] = (
                self._stalled_tenants.get(tenant, 0) + 1
            )

    # -- views -------------------------------------------------------------

    def tenants(self) -> dict:
        with self._lock:
            names = sorted(set(self._tenant_jobs) | set(self._tenant_bytes))
            return {
                name: {
                    "inflight_jobs": self._tenant_jobs.get(name, 0),
                    "inflight_bytes": self._tenant_bytes.get(name, 0),
                }
                for name in names
            }

    def snapshot(self) -> dict:
        rung = self.level()
        with self._lock:
            episode_open = self._episode_open
            stalled = dict(self._stalled_tenants)
        return {
            "level": rung,
            "level_name": _LEVEL_NAMES[rung],
            "pressure": round(self.ledger.pressure(), 4),
            "quota_tenant_jobs": self.quota_jobs,
            "quota_tenant_bytes": self.quota_bytes,
            "ladder": {
                "shrink_at": self.shrink_at,
                "pause_at": self.pause_at,
                "shed_at": self.shed_at,
            },
            "episode_open": episode_open,
            "ledger": self.ledger.snapshot(),
            "tenants": self.tenants(),
            "lanes": self.scheduler.snapshot(),
            "stalled_tenants": stalled,
        }


# the process-wide ledger + controller, mirroring watchdog.MONITOR /
# incident.RECORDER: always importable and cheap when unconfigured
# (no limits -> no quota, no ladder, pure FIFO-per-lane ordering);
# serve() configures them from Config, tests configure them directly
LEDGER = Ledger()
CONTROLLER = AdmissionController(LEDGER)


def scratch_key(path: str) -> str:
    """Ledger key for a fetch's preallocated scratch file."""
    return f"scratch:{path}"


def part_key(upload_id: str, number: int) -> str:
    """Ledger key for one in-flight streamed part's buffer window."""
    return f"part:{upload_id}:{number}"


_BATCH_KEYS = threading.Lock()
_batch_seq = 0


def batch_slot_key() -> str:
    """A fresh ledger key for one batched-lane slot."""
    global _batch_seq
    with _BATCH_KEYS:
        _batch_seq += 1
        return f"batch-slot:{_batch_seq}"


__all__ = [
    "AdmissionController",
    "CANARY_CLASS",
    "CONTROLLER",
    "Decision",
    "DeficitScheduler",
    "DEFAULT_CLASS",
    "DEFAULT_TENANT",
    "JOB_CLASSES",
    "LEDGER",
    "Ledger",
    "batch_slot_key",
    "budgets_from_env",
    "class_weights_from_env",
    "default_class_from_env",
    "full_jitter",
    "ladder_from_env",
    "min_prefetch_from_env",
    "normalize_class",
    "normalize_tenant",
    "part_key",
    "quotas_from_env",
    "retry_after_for",
    "scratch_key",
]
