"""Runtime recorders: the dynamic halves of the ``lock-order`` and
``protocol`` rules.

``LockOrderRecorder`` is the lock-order half (below).
``ProtocolRecorder`` is the protocol typestate half: it patches the
acquire/release methods of the declared lifecycle protocols (the
``protocols.RUNTIME_PROTOCOLS`` table — same vocabulary the static
rule reads from the ``# protocol:`` annotations) and tracks every
still-open obligation, so a test suite can assert at teardown that
nothing acquired during the run leaked. The static rule proves
release-on-all-paths per function; the recorder catches the residue
the engine cannot see — obligations handed across threads, stored on
objects, or released through unresolvable dynamic dispatch.

The static checker proves the LEXICAL acquisition graph acyclic, but
it cannot see orders established through calls (session lock held in
``add_span`` while the part pool takes its own lock two classes away).
This recorder patches ``threading.Lock``/``threading.RLock`` so every
lock created while it is installed records, per thread, the stack of
held locks — and every acquisition adds "held -> acquired" edges to a
process-wide graph keyed by each lock's CREATION SITE (file:line of
the constructor call, the runtime analogue of the static checker's
class-qualified lock path). A cycle in that graph is a deadlock that
merely hasn't fired yet.

Used by the module-scoped guard fixtures that
tests/test_torch_analysis.py defines for this package's
concurrency-heavy suites, and directly by its tests.

Scope notes: locks created BEFORE ``install()`` are invisible (they
are real Lock objects already); same-site edges (two instances from
one constructor line) are skipped — an instance-level ladder over one
class's lock is out of scope for a site-keyed graph. The wrapper
implements the private ``_release_save``/``_acquire_restore``/
``_is_owned`` surface so ``threading.Condition`` keeps working (its
``wait`` really releases, which the held-stack must mirror).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import queue as _queue_module
import sys
import threading
from collections import defaultdict

from .core import find_cycles
from .protocols import RUNTIME_PROTOCOLS

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
# exact module files, not name suffixes: a project/test module that
# happens to be called queue.py must keep its own creation sites
_SKIP_FILES = frozenset(
    {__file__, threading.__file__, _queue_module.__file__}
)


def _creation_site() -> str:
    """file:line of the nearest caller outside this module and the
    stdlib threading/queue modules — so a Condition's internal RLock
    or a queue.Queue's mutex is attributed to the code that made the
    Condition/Queue, not to the stdlib line that wrapped it."""
    frame = sys._getframe(2)
    while frame is not None:
        filename = frame.f_code.co_filename
        if filename not in _SKIP_FILES:
            return f"{filename}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class _RecordingLock:
    """Wraps one real lock; mirrors acquire/release into the recorder."""

    def __init__(self, recorder: "LockOrderRecorder", inner, site: str):
        self._recorder = recorder
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        shaker = self._recorder._shaker
        if shaker is not None:
            # BEFORE the acquire: any lock this thread already holds
            # stays held across the yield — the widened window is
            # exactly where latent inversions interleave
            shaker.perturb(self._site)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._recorder._note_acquire(self._site)
        return got

    def release(self) -> None:
        shaker = self._recorder._shaker
        if shaker is not None:
            shaker.perturb(self._site)  # extend the hold: same reason
        self._inner.release()
        self._recorder._note_release(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # os.register_at_fork handlers (concurrent.futures.thread
        # registers one at import) reinitialize locks in the child
        self._inner._at_fork_reinit()
        held = getattr(self._recorder._tls, "held", None)
        if held:
            held.clear()

    def __enter__(self) -> "_RecordingLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    # -- threading.Condition compatibility surface ------------------------

    def _is_owned(self) -> bool:
        probe = getattr(self._inner, "_is_owned", None)
        if probe is not None:
            return probe()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        self._recorder._note_release(self._site)
        saver = getattr(self._inner, "_release_save", None)
        if saver is not None:
            return saver()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        restorer = getattr(self._inner, "_acquire_restore", None)
        if restorer is not None:
            restorer(state)
        else:
            self._inner.acquire()
        self._recorder._note_acquire(self._site)

    def __repr__(self) -> str:
        return f"<recorded {self._inner!r} from {self._site}>"


class LockOrderRecorder:
    def __init__(self, shaker=None) -> None:
        # optional analysis.schedules.ScheduleShaker: deterministic
        # yields injected at every intercepted acquire/release, so the
        # suites running under this recorder explore perturbed
        # interleavings instead of only the scheduler's favorite one
        self._shaker = shaker
        # (held_site, acquired_site) -> observation count
        self._edges: dict[tuple[str, str], int] = defaultdict(int)
        self._edges_lock = _REAL_LOCK()
        self._tls = threading.local()
        # thread ident -> that thread's live held-stack list (the same
        # object _tls holds), so an incident capture (utils/incident.py)
        # can dump WHO holds WHAT from outside the owning threads. The
        # lists mutate GIL-atomically (append/del); a snapshot copy may
        # be momentarily torn, which is fine for diagnostics.
        self._held_by_thread: dict[int, list[str]] = {}  # guarded-by: _edges_lock
        self._installed = False

    # -- wrapper bookkeeping ----------------------------------------------

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
            with self._edges_lock:
                self._held_by_thread[threading.get_ident()] = held
        return held

    def held_snapshot(self) -> dict[str, list[str]]:
        """Lock creation sites currently held, per live thread — the
        incident bundle's 'who is holding what' view."""
        names = {t.ident: t.name for t in threading.enumerate()}
        with self._edges_lock:
            items = list(self._held_by_thread.items())
        return {
            names.get(ident, f"thread-{ident}"): list(held)
            for ident, held in items
            if held and ident in names
        }

    def _note_acquire(self, site: str) -> None:
        held = self._held()
        if held:
            with self._edges_lock:
                for holder in held:
                    if holder != site:
                        self._edges[(holder, site)] += 1
        held.append(site)

    def _note_release(self, site: str) -> None:
        held = self._held()
        # remove the most recent occurrence: out-of-order releases are
        # legal (lock chaining), LIFO is merely the common case
        for index in range(len(held) - 1, -1, -1):
            if held[index] == site:
                del held[index]
                return

    # -- install/uninstall -------------------------------------------------

    def install(self) -> "LockOrderRecorder":
        if self._installed:
            return self
        recorder = self

        def make_lock():
            return _RecordingLock(recorder, _REAL_LOCK(), _creation_site())

        def make_rlock():
            return _RecordingLock(recorder, _REAL_RLOCK(), _creation_site())

        threading.Lock = make_lock  # type: ignore[assignment]
        threading.RLock = make_rlock  # type: ignore[assignment]
        self._installed = True
        global _CURRENT
        _CURRENT = self
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = _REAL_LOCK  # type: ignore[assignment]
        threading.RLock = _REAL_RLOCK  # type: ignore[assignment]
        self._installed = False
        global _CURRENT
        if _CURRENT is self:
            _CURRENT = None

    def __enter__(self) -> "LockOrderRecorder":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()

    # -- results -----------------------------------------------------------

    def edges(self) -> dict[tuple[str, str], int]:
        with self._edges_lock:
            return dict(self._edges)

    def cycles(self) -> list[list[str]]:
        """Distinct cycles in the observed acquisition-order graph
        (each as a site list closing on its first element); empty means
        every test-observed ordering is consistent with ONE global lock
        hierarchy — no latent deadlock among the locks exercised."""
        graph: dict[str, list[str]] = defaultdict(list)
        for held, acquired in self.edges():
            graph[held].append(acquired)
        return [cycle for _, _, cycle in find_cycles(graph)]


# the recorder currently patched into threading (install()/uninstall()
# maintain it), or None. The incident flight recorder reads this to
# fold live lock-acquisition state into bundles when a diagnostic
# session has one installed.
_CURRENT: "LockOrderRecorder | None" = None


def current() -> "LockOrderRecorder | None":
    return _CURRENT


# -- protocol recorder --------------------------------------------------------


def _acquire_site() -> str:
    """file:line of the nearest caller outside this module — the
    acquisition site a leak report points at."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename != __file__:
            return f"{frame.f_code.co_filename}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class ProtocolRecorder:
    """Patch the declared protocol classes so every runtime acquisition
    is tracked until its matching release; ``leaked()`` lists whatever
    is still open. Keys are the obligation's identity: the object for
    ``self``/``result`` obligations (a strong reference is held, so
    ids stay stable), the value itself for string keys (upload ids,
    ledger charge keys). Releases are idempotent — popping an absent
    key is a no-op, mirroring the double-settle-safe design of every
    seeded protocol — and a release method that raises has NOT
    released (``complete_multipart``'s failure path must still reach
    ``abort_multipart``)."""

    def __init__(self, protocols: dict | None = None, shaker=None):
        self._protocols = RUNTIME_PROTOCOLS if protocols is None else protocols
        self._shaker = shaker  # see LockOrderRecorder: same contract
        self._lock = _REAL_LOCK()
        # (protocol, key) -> {"site": file:line, "obj": strong ref}
        self._open: dict[tuple[str, object], dict] = {}
        self._patched: list[tuple[type, str, object]] = []
        self._installed = False

    # -- bookkeeping ------------------------------------------------------

    @staticmethod
    def _key_of(value) -> object:
        if isinstance(value, (str, bytes, int)):
            return value
        return id(value)

    def _note_acquire(self, protocol: str, value, site: str) -> None:
        with self._lock:
            self._open[(protocol, self._key_of(value))] = {
                "site": site,
                "obj": value,
            }

    def _note_release(self, protocol: str, value) -> None:
        with self._lock:
            self._open.pop((protocol, self._key_of(value)), None)

    # -- patching ---------------------------------------------------------

    @staticmethod
    def _resolver(key: str, original):
        """callable(receiver, args, kwargs, result) -> obligation value
        for one method spec's key expression."""
        if key == "self":
            return lambda receiver, args, kwargs, result: receiver
        if key == "result":
            return lambda receiver, args, kwargs, result: result
        param = key[len("arg:"):]
        signature = inspect.signature(original)

        def resolve(receiver, args, kwargs, result):
            try:
                bound = signature.bind(receiver, *args, **kwargs)
            except TypeError:
                return None
            return bound.arguments.get(param)

        return resolve

    def _wrap(self, protocol: str, spec: dict, original):
        recorder = self
        is_acquire = spec["kind"] == "acquire"
        conditional = spec.get("conditional", False)
        skip_types = spec.get("skip_types", ())
        resolve = self._resolver(spec["key"], original)

        site = f"{spec['class']}.{spec['name']}"

        @functools.wraps(original)
        def wrapper(self, *args, **kwargs):
            if recorder._shaker is not None:
                recorder._shaker.perturb(site)
            result = original(self, *args, **kwargs)
            value = resolve(self, args, kwargs, result)
            if value is None:
                return result
            if is_acquire:
                if conditional and not result:
                    return result
                if type(value).__name__ in skip_types:
                    return result
                recorder._note_acquire(protocol, value, _acquire_site())
            else:
                recorder._note_release(protocol, value)
            return result

        return wrapper

    def install(self) -> "ProtocolRecorder":
        if self._installed:
            return self
        try:
            for protocol, table in self._protocols.items():
                module = importlib.import_module(table["module"])
                for spec in table["methods"]:
                    cls = getattr(module, spec["class"])
                    original = cls.__dict__[spec["name"]]
                    setattr(
                        cls, spec["name"], self._wrap(protocol, spec, original)
                    )
                    self._patched.append((cls, spec["name"], original))
        except BaseException:
            # a spec that no longer matches the code (renamed method,
            # moved to a base class) must not strand the methods
            # already wrapped: callers hold install() OUTSIDE their
            # try/finally, so a partial install would outlive the test
            for cls, name, original in reversed(self._patched):
                setattr(cls, name, original)
            self._patched.clear()
            raise
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for cls, name, original in reversed(self._patched):
            setattr(cls, name, original)
        self._patched.clear()
        self._installed = False

    def __enter__(self) -> "ProtocolRecorder":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()

    # -- results ----------------------------------------------------------

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def leaked(self) -> list[str]:
        """One line per still-open obligation: the protocol, what was
        acquired, and where — empty means every runtime acquisition
        observed during the session reached its release."""
        with self._lock:
            items = sorted(
                ((proto, info) for (proto, _), info in self._open.items()),
                key=lambda pair: (pair[0], pair[1]["site"]),
            )
        return [
            f"{proto}: {type(info['obj']).__name__!s} acquired at "
            f"{info['site']} was never released"
            for proto, info in items
        ]
