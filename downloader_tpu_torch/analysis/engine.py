"""The shared analysis engine: one scan per module.

Every rule consumes this scan instead of walking the AST itself. Per
function the engine builds a control-flow graph (``cfg``), solves two
dataflow problems over it (``dataflow``), and extracts the fact
streams the checkers consume:

- **lock state** (must-held, intersection join): which locks are held
  at every node — feeding guarded-by, no-blocking-under-lock, and the
  lock-order acquisition edges;
- **typestate** (may-state, union join): per local variable bound to a
  protocol acquisition or resource creation, the set of states
  {open, closed} reachable at every node — feeding
  resource-finalization and the protocol rules, including leak
  detection on exception edges and must-closed double releases;
- syntactic facts (attribute accesses, blocking calls with their
  deadline arguments, thread targets, env reads, call names) for the
  remaining rules.

Lock paths are dotted attribute chains rooted at ``self``
(``_lock``, ``_session._lock``), resolved through simple local aliases
(``session = self._session`` makes ``session._lock`` resolve to
``_session._lock``). Everything stays intra-procedural: a lock or
obligation reached through an unresolvable expression is invisible
(false negatives over false positives; the suppression syntax and the
runtime recorders exist for the residue).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from . import cfg as cfglib
from . import dataflow
from .core import Module

LOCK_NAME_RE = re.compile(r"(^|_)(r?lock|mutex)$", re.IGNORECASE)

# method names that block the calling thread: sleeps, joins, socket
# I/O, HTTP round trips, future/event waits. Name-based on purpose —
# the receiver's type is unknowable statically, and a false hit is one
# suppression with a written reason
BLOCKING_NAMES = frozenset(
    {
        "sleep",
        "join",
        "recv",
        "recv_into",
        "recvfrom",
        "recvfrom_into",
        "send",
        "sendall",
        "sendto",
        "connect",
        "accept",
        "getresponse",
        "select",
        "wait",
        "result",
    }
)

# the blocking-call-deadline audit's vocabulary: calls that can park a
# thread forever unless a deadline or cancel hook bounds them.
# ``sleep`` is excluded — its argument IS its bound.
DEADLINE_NAMES = frozenset(
    {
        "wait",
        "join",
        "get",
        "result",
        "acquire",
        "select",
        "recv",
        "recv_into",
        "recvfrom",
        "recvfrom_into",
        "sendall",
        "sendto",
        "accept",
        "connect",
        "getresponse",
    }
)

# the subset that is socket-shaped: no timeout parameter exists, the
# deadline lives on the object (settimeout) or in a cancel hook
SOCKET_OPS = frozenset(
    {
        "recv",
        "recv_into",
        "recvfrom",
        "recvfrom_into",
        "sendall",
        "sendto",
        "accept",
        "connect",
        "getresponse",
    }
)

OPEN = "open"
CLOSED = "closed"


# -- protocol vocabulary ------------------------------------------------------


@dataclass
class ProtoMethod:
    """One annotated acquire/release method of a protocol."""

    protocol: str
    kind: str  # "acquire" | "release"
    method: str  # def name as written
    callsite: str  # name seen at call sites (class name for __init__)
    bind: str | None = None  # param name; None = result (acquire) / receiver (release)
    conditional: bool = False  # acquisition only on truthy return
    may_raise: bool = False  # release that can itself fail
    param_index: int | None = None  # call-site positional index of bind
    decl: tuple[str, int] = ("", 0)


class ProtocolTable:
    """The protocol vocabulary in force for a run: terminal call name
    -> declared acquire/release methods. Built from ``# protocol:``
    annotations by the protocol checker's prepare pass."""

    def __init__(self, methods: list[ProtoMethod] | None = None):
        self.methods = methods or []
        self.by_callsite: dict[str, list[ProtoMethod]] = {}
        for m in self.methods:
            self.by_callsite.setdefault(m.callsite, []).append(m)

    def release_names(self, may_raise: bool) -> frozenset[str]:
        return frozenset(
            m.callsite
            for m in self.methods
            if m.kind == "release" and m.may_raise == may_raise
        )

    def __bool__(self) -> bool:
        return bool(self.methods)


EMPTY_TABLE = ProtocolTable()


# -- fact records -------------------------------------------------------------


@dataclass
class AttrAccess:
    attr: str
    line: int
    held: tuple[str, ...]
    func_name: str
    class_name: str | None
    is_store: bool


@dataclass
class LockAcquire:
    path: str
    line: int
    held: tuple[str, ...]
    func_name: str
    class_name: str | None


@dataclass
class BlockingCall:
    name: str
    line: int
    held: tuple[str, ...]


@dataclass
class DeadlineSite:
    """One call from the deadline audit's vocabulary."""

    name: str
    line: int
    receiver: str | None  # dotted self-path of the receiver, if resolvable
    receiver_name: str | None  # terminal identifier of the receiver
    pos_args: int
    timeout: str  # "missing" | "none" | "finite"
    is_with_item: bool = False


@dataclass
class GuardDecl:
    attr: str
    lock: str
    line: int
    class_name: str | None


@dataclass
class ThreadSpawn:
    line: int
    target_name: str | None  # terminal name of the target callable
    kind: str  # "self" (self.method) | "name" (bare identifier) | "other"
    class_name: str | None
    role: str | None = None  # from a `# thread-role:` spawn annotation
    # "thread" (threading.Thread/Timer: an escaped exception kills the
    # thread silently) or "submit" (executor: the Future captures it)
    via: str = "thread"


@dataclass
class CallSite:
    """One call expression with the caller's solved lock state — the
    seam every interprocedural rule consumes summaries through."""

    name: str
    line: int
    held: tuple[str, ...]
    # how the callee is spelled: "bare" (name()), "self" (self.m()),
    # "cls" (cls.m()), "selfattr" (self._x.m(), recv = dotted path),
    # "attr" (X.m(), recv = X), "dotted" (a.b.m(), recv = "a.b"),
    # "other" (dynamic — out of static reach)
    kind: str
    recv: str | None
    pos_names: tuple  # positional args that are plain Names (else None)
    kw_names: tuple  # (kwarg, var-name) pairs for plain-Name kwargs


@dataclass
class SharedDecl:
    """A `# shared-by-design: <reason>` field annotation."""

    attr: str
    reason: str
    line: int
    class_name: str | None


@dataclass
class BorrowEscape:
    """An obligation whose only escape evidence is being passed as an
    argument: the intraprocedural engine grants the escape (ownership
    may have moved), and the interprocedural protocol pass re-judges
    it against the callees' summaries — a callee proven to only BORROW
    the value hands the obligation straight back."""

    protocol: str
    var: str
    line: int  # acquisition site
    release_names: tuple[str, ...]
    # (name, kind, recv, line, pos_index | None, kwarg | None) per pass
    passes: tuple = ()


@dataclass
class EnvRead:
    name: str
    line: int


@dataclass
class ObligationLeak:
    protocol: str
    var: str
    line: int  # acquisition site
    on_exception: bool  # leaks (also) via the exceptional exit
    on_normal: bool
    never_released: bool  # no release site for the var at all
    release_names: tuple[str, ...]


@dataclass
class DoubleRelease:
    protocol: str
    var: str
    line: int  # release site proven to run on an already-closed var
    acquire_line: int


@dataclass
class FunctionAnalysis:
    node: ast.FunctionDef
    class_name: str | None
    accesses: list[AttrAccess] = field(default_factory=list)
    acquires: list[LockAcquire] = field(default_factory=list)
    blocking: list[BlockingCall] = field(default_factory=list)
    deadline_sites: list[DeadlineSite] = field(default_factory=list)
    leaks: list[ObligationLeak] = field(default_factory=list)
    double_releases: list[DoubleRelease] = field(default_factory=list)
    thread_spawns: list[ThreadSpawn] = field(default_factory=list)
    call_sites: list[CallSite] = field(default_factory=list)
    borrow_escapes: list[BorrowEscape] = field(default_factory=list)
    calls: set[str] = field(default_factory=set)
    has_settimeout: bool = False
    has_timeout_kwarg: bool = False
    # explicit (.acquire()/.release()) lock balance facts: locks still
    # held on EVERY normal exit (a deliberate hand-off to the caller),
    # locks explicitly released anywhere, and (path, acquire-line)
    # pairs held on only SOME exit — the intraprocedural lock leak
    exit_held: tuple[str, ...] = ()
    lock_releases: tuple[str, ...] = ()
    lock_imbalances: tuple = ()


@dataclass
class ModuleScan:
    module: Module
    functions: list[FunctionAnalysis] = field(default_factory=list)
    guards: list[GuardDecl] = field(default_factory=list)
    shared: list[SharedDecl] = field(default_factory=list)
    env_reads: list[EnvRead] = field(default_factory=list)
    # (class_name | None, def name) -> FunctionAnalysis, for thread-
    # target resolution and the call-graph reachability pass
    methods: dict[tuple[str | None, str], FunctionAnalysis] = field(
        default_factory=dict
    )


# -- small shared helpers -----------------------------------------------------


def dotted_from_self(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """The dotted attribute path of ``node`` relative to ``self``
    (``self._a.b`` -> ``"_a.b"``), resolving one level of local
    aliasing; None when the expression is not self-rooted."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.reverse()
    if cur.id == "self":
        return ".".join(parts) if parts else None
    base = aliases.get(cur.id)
    if base is None:
        return None
    return ".".join([base] + parts) if parts else base


def is_lock_path(path: str) -> bool:
    return bool(LOCK_NAME_RE.search(path.rsplit(".", 1)[-1]))


def terminal_name(func: ast.expr) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def receiver_root(node: ast.AST) -> str | None:
    """The base identifier of an attribute chain (``a.b.c`` -> "a")."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _mentions(node: ast.AST, name: str) -> bool:
    return any(
        isinstance(sub, ast.Name) and sub.id == name for sub in ast.walk(node)
    )


def walk_pruned(node: ast.AST):
    """ast.walk that does not descend into nested defs/lambdas (their
    bodies run later on another frame — only default expressions
    evaluate here)."""
    stack: list[ast.AST] = [node]
    while stack:
        sub = stack.pop()
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(getattr(sub.args, "defaults", []))
            stack.extend(
                d
                for d in getattr(sub.args, "kw_defaults", []) or []
                if d is not None
            )
            continue
        yield sub
        stack.extend(ast.iter_child_nodes(sub))


def own_statements(func: ast.FunctionDef):
    """Statements of ``func`` excluding nested def/class bodies."""
    stack: list[ast.AST] = list(func.body)
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                stack.append(child)
            elif isinstance(child, ast.ExceptHandler):
                stack.append(child)


# -- the scan -----------------------------------------------------------------


def scan_module(module: Module) -> ModuleScan:
    table: ProtocolTable = getattr(module, "_protocol_table", EMPTY_TABLE)
    factories: frozenset[str] = getattr(module, "_factory_names", EMPTY_FACTORIES)
    scan = ModuleScan(module)

    def visit(body: list[ast.stmt], class_name: str | None) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fa = _scan_function(scan, node, class_name, table, factories)
                scan.methods.setdefault((class_name, node.name), fa)
                visit(node.body, class_name)
            elif isinstance(node, ast.ClassDef):
                visit(node.body, node.name)
            else:
                # defs nested under any compound statement still count
                inner: list[ast.stmt] = []
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.stmt):
                        inner.append(child)
                    elif isinstance(child, ast.ExceptHandler) or (
                        type(child).__name__ == "match_case"
                    ):
                        inner.extend(
                            c
                            for c in ast.iter_child_nodes(child)
                            if isinstance(c, ast.stmt)
                        )
                if inner:
                    visit(inner, class_name)
    visit(module.tree.body, None)
    _scan_env_reads(scan)
    return scan


# default resource factory set lives in checkers; the scan only needs
# whatever the resource checker's prepare pass put on the module
EMPTY_FACTORIES: frozenset[str] = frozenset()


def scan_cached(module: Module) -> ModuleScan:
    """The module's (memoized) engine scan — one per Analyzer run;
    checkers run in sequence on one thread, so a plain memo works. The
    protocol/resource prepare passes run before any check, so the
    vocabulary tables are pinned on the module by scan time."""
    cached = getattr(module, "_engine_scan", None)
    if cached is None:
        cached = scan_module(module)
        module._engine_scan = cached  # type: ignore[attr-defined]
    return cached


def _lexical_aliases(func: ast.FunctionDef) -> dict[str, str]:
    """Final-state local alias map (``session = self._session``). The
    old walker resolved aliases incrementally; resolving against the
    final map differs only when a name is re-bound mid-function, which
    the tree avoids (and a mis-resolution surfaces as a visible
    finding, not a silent pass)."""
    aliases: dict[str, str] = {}
    for stmt in own_statements(func):
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            path = (
                dotted_from_self(stmt.value, aliases)
                if stmt.value is not None
                else None
            )
            if path is not None:
                aliases[stmt.targets[0].id] = path
            else:
                aliases.pop(stmt.targets[0].id, None)
    return aliases


class _LockAnalysis(dataflow.Analysis):
    """Must-held lock set: intersection at joins."""

    def __init__(self, base: frozenset[str]):
        self._base = base

    def initial(self):
        return self._base

    def join(self, states):
        it = iter(states)
        out = next(it)
        for state in it:
            out = out & state
        return out

    def transfer(self, node, state):
        branch = None
        for verb, payload in node.events:
            if verb == "lock_acquire":
                state = state | {payload}
            elif verb == "lock_release":
                state = state - {payload}
            elif verb == "lock_acquire_branch":
                # `if lock.acquire(timeout=t):` — held on one branch only
                branch = payload
        if branch is not None:
            path, label = branch
            return {label: state | {path}, None: state}
        return state


class _MayLockAnalysis(_LockAnalysis):
    """May-held lock set (union at joins): the complement analysis the
    explicit-acquire balance check needs — a lock in MAY-held but not
    MUST-held at an exit was released on some paths only."""

    def join(self, states):
        out = frozenset()
        for state in states:
            out = out | state
        return out


@dataclass
class _Action:
    kind: str  # "acquire" | "release"
    var: str
    protocol: str
    line: int
    conditional: bool = False
    may_raise: bool = False  # release that can itself fail
    release_names: tuple[str, ...] = ()


class _TypestateAnalysis(dataflow.Analysis):
    """May-state of every tracked obligation: frozenset of
    (var, site_line, protocol, status) facts, union at joins.

    ``refines`` maps a test node (a bare ``if ok:`` / ``if not ok:``
    over the boolean a conditional acquire was assigned to) to that
    acquire — the refused branch discards the obligation, so
    ``ok = try_charge(...)`` followed by an early return on falsy is
    as clean as testing the call directly."""

    def __init__(
        self,
        actions: dict[int, list[_Action]],
        refines: dict[int, tuple[_Action, bool]] | None = None,
    ):
        self._actions = actions
        self._refines = refines or {}

    def initial(self):
        return frozenset()

    def join(self, states):
        out = frozenset()
        for state in states:
            out = out | state
        return out

    @staticmethod
    def _acquire(state, action):
        kept = frozenset(
            f for f in state if not (f[0] == action.var and f[2] == action.protocol)
        )
        return kept | {(action.var, action.line, action.protocol, OPEN)}

    @staticmethod
    def _release(state, var, protocol=None):
        out = set()
        for v, site, proto, status in state:
            if v == var and (protocol is None or proto == protocol):
                out.add((v, site, proto, CLOSED))
            else:
                out.add((v, site, proto, status))
        return frozenset(out)

    def transfer(self, node, state):
        managed = [
            payload
            for verb, payload in node.events
            if verb == "with_exit"
        ]
        for item in managed:
            for var in _managed_vars(item, state):
                state = self._release(state, var)
        refine = self._refines.get(id(node))
        if refine is not None:
            action, negated = refine
            refused = frozenset(
                f
                for f in state
                if not (
                    f[0] == action.var
                    and f[1] == action.line
                    and f[2] == action.protocol
                )
            )
            if negated:
                return {"true": refused, "false": state, None: state}
            return {"true": state, "false": refused, None: state}
        actions = self._actions.get(id(node), ())
        conditional = None
        exc_state = None
        for action in actions:
            if action.kind == "acquire":
                if action.conditional and node.kind == "test":
                    conditional = action
                else:
                    if exc_state is None:
                        # the acquiring call raising means nothing was
                        # acquired — its own exception edge carries the
                        # pre-acquire state, or `try: h = open(p)
                        # except OSError: return None` reads as a leak
                        exc_state = state
                    state = self._acquire(state, action)
            elif action.kind == "release":
                if action.may_raise and exc_state is None:
                    # a release that can itself fail has NOT released
                    # along its own exception edge — the state the exc
                    # path sees is the one before this release ran
                    exc_state = state
                state = self._release(state, action.var, action.protocol)
        if exc_state is not None and conditional is None:
            return {"exc": exc_state, None: state}
        if conditional is not None:
            negated = isinstance(node.ast_node, ast.UnaryOp) and isinstance(
                node.ast_node.op, ast.Not
            )
            acquired = self._acquire(state, conditional)
            if negated:
                return {"true": state, "false": acquired, None: acquired}
            return {"true": acquired, "false": state, None: acquired}
        return state


def _managed_vars(item: ast.withitem, state) -> list[str]:
    """Tracked vars this with-item RELEASES at exit: ``with x:`` hands
    x itself to the context protocol, and ``with closing(x):`` is the
    stdlib spelling of the same. A var merely passed to some other
    callable (``with install(watch):``) is NOT managed — that context
    manager wraps its own thing, and assuming it releases the argument
    turns every later real release into a bogus double-release."""
    tracked = {f[0] for f in state}
    expr = item.context_expr
    out = []
    if isinstance(expr, ast.Name) and expr.id in tracked:
        out.append(expr.id)
    elif isinstance(expr, ast.Call) and terminal_name(expr.func) == "closing":
        for arg in list(expr.args) + [kw.value for kw in expr.keywords]:
            if isinstance(arg, ast.Name) and arg.id in tracked:
                out.append(arg.id)
    return out


def _scan_function(
    scan: ModuleScan,
    func: ast.FunctionDef,
    class_name: str | None,
    table: ProtocolTable,
    factories: frozenset[str],
) -> FunctionAnalysis:
    module = scan.module
    fa = FunctionAnalysis(func, class_name)
    scan.functions.append(fa)
    aliases = _lexical_aliases(func)

    def lock_path(expr: ast.expr) -> str | None:
        path = dotted_from_self(expr, aliases)
        if path is not None and is_lock_path(path):
            return path
        return None

    graph = cfglib.Builder(
        func,
        raising_releases=table.release_names(may_raise=True),
        non_raising=cfglib.NON_RAISING_CALLS | table.release_names(False),
        lock_paths=lock_path,
    ).build()

    _refine_flag_acquires(graph)
    base_held = frozenset(module.holds_for(func))
    lock_in = dataflow.solve(graph, _LockAnalysis(base_held))

    # -- per-node syntactic facts with the solved lock state -----------
    for node in graph.nodes:
        state = lock_in.get(id(node))
        if state is None:
            continue  # unreachable
        held = tuple(sorted(state))
        _extract_facts(fa, scan, node, held, aliases, func, class_name)
    # the CFG builds one finalbody copy per continuation (and one
    # with-exit per unwinding path), so one statement can own several
    # nodes — identical facts from those copies must collapse or every
    # checker reports the same violation 2-3 times
    fa.blocking = _dedupe(fa.blocking, lambda b: (b.name, b.line, b.held))
    fa.deadline_sites = _dedupe(
        fa.deadline_sites,
        lambda s: (s.name, s.line, s.receiver, s.receiver_name, s.timeout),
    )
    fa.thread_spawns = _dedupe(
        fa.thread_spawns, lambda t: (t.line, t.target_name, t.kind)
    )
    fa.call_sites = _dedupe(
        fa.call_sites, lambda c: (c.name, c.line, c.kind, c.recv, c.held)
    )
    # -- lock-order acquisition edges ----------------------------------
    for node in graph.nodes:
        state = lock_in.get(id(node))
        if state is None:
            continue
        for verb, payload in node.events:
            if verb == "lock_acquire":
                fa.acquires.append(
                    LockAcquire(
                        payload,
                        node.line,
                        tuple(sorted(state)),
                        func.name,
                        class_name,
                    )
                )
                state = state | {payload}
            elif verb == "lock_acquire_branch":
                fa.acquires.append(
                    LockAcquire(
                        payload[0],
                        node.line,
                        tuple(sorted(state)),
                        func.name,
                        class_name,
                    )
                )
    fa.acquires = _dedupe(
        fa.acquires, lambda a: (a.path, a.line, a.held)
    )

    # -- explicit-acquire lock balance ---------------------------------
    _explicit_lock_balance(fa, graph, lock_in, base_held)

    # -- typestate ------------------------------------------------------
    _run_typestate(fa, module, func, graph, table, factories, aliases)
    return fa


def _refine_flag_acquires(graph: cfglib.CFG) -> None:
    """The assign-then-check spelling of a guarded acquire:
    ``got = lock.acquire(timeout=t)`` followed by ``if got:`` /
    ``if not got:``. The CFG builder records an unconditional acquire
    on the assignment; when a test on the flag exists, move the
    acquisition onto the matching branch — exactly what the inline
    ``if lock.acquire(...):`` form gets. (The short window between
    the assignment and the test goes untracked — false negatives over
    false positives, as everywhere.) A flag nobody tests keeps the
    unconditional event."""
    # flag name -> assignments, in source order: a flag may be reused
    # for sequential acquires; each test refines the nearest PRECEDING
    # assignment (line-ordered — an approximation, like aliasing)
    flags: dict[str, list] = {}
    for node in graph.nodes:
        stmt = node.ast_node
        if (
            node.kind == "stmt"
            and isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "acquire"
        ):
            acquired = [p for v, p in node.events if v == "lock_acquire"]
            if len(acquired) == 1:
                flags.setdefault(stmt.targets[0].id, []).append(
                    [node, acquired[0], stmt.lineno, False]
                )
    if not flags:
        return
    for entries in flags.values():
        entries.sort(key=lambda e: e[2])
    for node in graph.nodes:
        if node.kind != "test":
            continue
        expr = node.ast_node
        negated = isinstance(expr, ast.UnaryOp) and isinstance(
            expr.op, ast.Not
        )
        inner = expr.operand if negated else expr
        if not (isinstance(inner, ast.Name) and inner.id in flags):
            continue
        test_line = getattr(expr, "lineno", 0)
        preceding = [
            e for e in flags[inner.id] if e[2] <= test_line
        ]
        if not preceding:
            continue
        entry = preceding[-1]
        node.events.append(
            ("lock_acquire_branch", (entry[1], "false" if negated else "true"))
        )
        entry[3] = True
    for entries in flags.values():
        for node, path, _, moved in entries:
            if moved:
                node.events.remove(("lock_acquire", path))


def _explicit_lock_balance(
    fa: FunctionAnalysis,
    graph: cfglib.CFG,
    lock_in: dict,
    base_held: frozenset[str],
) -> None:
    """Balance facts for locks acquired through explicit ``.acquire()``
    calls (``with`` blocks release on every exit by construction, so
    only explicit acquires can leak). MUST-held at the normal exit is
    a deliberate hand-off the caller owes a release for; a path in
    MAY-held but not MUST-held at either exit was released on some
    paths only — the classic lock leak."""
    explicit_sites: dict[str, int] = {}
    releases: set[str] = set()
    for node in graph.nodes:
        if node.kind not in ("stmt", "test"):
            continue
        for verb, payload in node.events:
            if verb == "lock_acquire":
                explicit_sites.setdefault(payload, node.line)
            elif verb == "lock_acquire_branch":
                explicit_sites.setdefault(payload[0], node.line)
            elif verb == "lock_release":
                releases.add(payload)
    fa.lock_releases = tuple(sorted(releases))
    if not explicit_sites:
        return
    may_in = dataflow.solve(graph, _MayLockAnalysis(base_held))
    must_exit = lock_in.get(id(graph.exit)) or frozenset()
    may_exit = may_in.get(id(graph.exit)) or frozenset()
    may_exc = may_in.get(id(graph.exit_exc)) or frozenset()
    explicit = frozenset(explicit_sites)
    fa.exit_held = tuple(sorted((must_exit & explicit) - base_held))
    leaked = ((may_exit | may_exc) - must_exit) & explicit
    fa.lock_imbalances = tuple(
        sorted((path, explicit_sites[path]) for path in leaked)
    )


def _dedupe(items: list, key) -> list:
    seen: set = set()
    out = []
    for item in items:
        k = key(item)
        if k in seen:
            continue
        seen.add(k)
        out.append(item)
    return out


def _extract_facts(
    fa: FunctionAnalysis,
    scan: ModuleScan,
    node: cfglib.Node,
    held: tuple[str, ...],
    aliases: dict[str, str],
    func: ast.FunctionDef,
    class_name: str | None,
) -> None:
    ast_node = node.ast_node
    if ast_node is None:
        return
    if isinstance(ast_node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return
    if isinstance(ast_node, ast.ExceptHandler):
        exprs: list[ast.AST] = [ast_node.type] if ast_node.type else []
    elif isinstance(ast_node, ast.stmt):
        exprs = [ast_node]
        _note_guard_decl(scan, ast_node, class_name)
    else:
        exprs = [ast_node]

    for root in exprs:
        for sub in walk_pruned(root):
            if isinstance(sub, ast.Attribute):
                path = dotted_from_self(sub, aliases)
                if path is not None:
                    fa.accesses.append(
                        AttrAccess(
                            path,
                            sub.lineno,
                            held,
                            func.name,
                            class_name,
                            isinstance(sub.ctx, (ast.Store, ast.Del)),
                        )
                    )
            elif isinstance(sub, ast.Call):
                name = terminal_name(sub.func)
                if name is None:
                    continue
                fa.calls.add(name)
                fa.call_sites.append(_call_site(sub, name, held, aliases))
                if name in BLOCKING_NAMES:
                    # recorded even with no lock held: the bare fact
                    # feeds may-block summaries; the under-lock rule
                    # filters on `held` itself
                    fa.blocking.append(BlockingCall(name, sub.lineno, held))
                if name == "settimeout" or name == "setdefaulttimeout":
                    fa.has_settimeout = True
                if any(kw.arg == "timeout" for kw in sub.keywords):
                    fa.has_timeout_kwarg = True
                if name in DEADLINE_NAMES:
                    fa.deadline_sites.append(
                        _deadline_site(sub, name, aliases, node)
                    )
                if name in ("submit", "_submit") and sub.args:
                    # executor hand-off: the first positional arg runs
                    # on a pool thread — a spawn site for role
                    # purposes (`# thread-role:` applies here too)
                    target = sub.args[0]
                    kind = None
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        kind = "self"
                    elif isinstance(target, ast.Attribute):
                        kind = "method"  # resolved by unique name
                    elif isinstance(target, ast.Name):
                        kind = "name"
                    if kind is not None:
                        fa.thread_spawns.append(
                            ThreadSpawn(
                                sub.lineno,
                                terminal_name(target),
                                kind,
                                class_name,
                                role=scan.module.role_for(
                                    sub.lineno,
                                    getattr(sub, "end_lineno", sub.lineno)
                                    or sub.lineno,
                                ),
                                via="submit",
                            )
                        )
                if name in ("Thread", "Timer"):
                    target = next(
                        (
                            kw.value
                            for kw in sub.keywords
                            if kw.arg == "target"
                        ),
                        None,
                    )
                    if target is not None:
                        if (
                            isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"
                        ):
                            kind = "self"
                        elif isinstance(target, ast.Name):
                            kind = "name"
                        else:
                            kind = "other"
                        fa.thread_spawns.append(
                            ThreadSpawn(
                                sub.lineno,
                                terminal_name(target)
                                if isinstance(
                                    target, (ast.Attribute, ast.Name)
                                )
                                else None,
                                kind,
                                class_name,
                                role=scan.module.role_for(
                                    sub.lineno,
                                    getattr(sub, "end_lineno", sub.lineno)
                                    or sub.lineno,
                                ),
                            )
                        )


def _call_site(
    call: ast.Call, name: str, held: tuple[str, ...], aliases: dict[str, str]
) -> CallSite:
    func = call.func
    kind = "other"
    recv: str | None = None
    if isinstance(func, ast.Name):
        kind = "bare"
    elif isinstance(func, ast.Attribute):
        val = func.value
        if isinstance(val, ast.Name) and val.id == "self":
            kind = "self"
        elif isinstance(val, ast.Name) and val.id == "cls":
            kind = "cls"
        else:
            self_path = dotted_from_self(val, aliases)
            if self_path is not None:
                kind, recv = "selfattr", self_path
            elif isinstance(val, ast.Name):
                kind, recv = "attr", val.id
            elif isinstance(val, ast.Attribute):
                parts: list[str] = []
                cur: ast.AST = val
                while isinstance(cur, ast.Attribute):
                    parts.append(cur.attr)
                    cur = cur.value
                if isinstance(cur, ast.Name):
                    parts.append(cur.id)
                    kind, recv = "dotted", ".".join(reversed(parts))
    pos_names = tuple(
        arg.id if isinstance(arg, ast.Name) else None for arg in call.args
    )
    kw_names = tuple(
        (kw.arg, kw.value.id)
        for kw in call.keywords
        if kw.arg is not None and isinstance(kw.value, ast.Name)
    )
    return CallSite(name, call.lineno, held, kind, recv, pos_names, kw_names)


def _deadline_site(
    call: ast.Call, name: str, aliases: dict[str, str], node: cfglib.Node
) -> DeadlineSite:
    timeout = "missing"
    timeout_expr: ast.expr | None = None
    for kw in call.keywords:
        if kw.arg == "timeout":
            timeout_expr = kw.value
    # positional timeout: wait(t) / join(t) / result(t); queue.get's is
    # arg 1 (after `block`); select's depends on the API — arg 3 for
    # select.select(r, w, x[, t]), arg 0 for selectors' select(t).
    # 2-3 positional args is the r/w/x form with NO timeout, so pos
    # must stay 3 (out of range → missing), not fall back to arg 0
    # (the read list would read as a finite timeout)
    pos = {
        "wait": 0,
        "join": 0,
        "result": 0,
        "select": 3 if len(call.args) >= 2 else 0,
        "get": 1,
        "acquire": 1,  # Lock.acquire(blocking, timeout)
    }.get(name)
    if timeout_expr is None and pos is not None and len(call.args) > pos:
        timeout_expr = call.args[pos]
    if timeout_expr is not None:
        is_none = (
            isinstance(timeout_expr, ast.Constant)
            and timeout_expr.value is None
        )
        timeout = "none" if is_none else "finite"
    receiver = None
    receiver_name = None
    if isinstance(call.func, ast.Attribute):
        receiver = dotted_from_self(call.func.value, aliases)
        receiver_name = (
            call.func.value.attr
            if isinstance(call.func.value, ast.Attribute)
            else call.func.value.id
            if isinstance(call.func.value, ast.Name)
            else None
        )
    return DeadlineSite(
        name,
        call.lineno,
        receiver,
        receiver_name,
        len(call.args),
        timeout,
        is_with_item=node.kind == "expr",
    )


def _note_guard_decl(
    scan: ModuleScan, stmt: ast.stmt, class_name: str | None
) -> None:
    if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        return
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    module = scan.module
    for target in targets:
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        end = getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno
        for line in range(stmt.lineno, end + 1):
            lock = module.guarded_lines.get(line)
            if lock is not None:
                scan.guards.append(
                    GuardDecl(target.attr, lock, stmt.lineno, class_name)
                )
                return
            shared = module.shared_lines.get(line)
            if shared is not None:
                scan.shared.append(
                    SharedDecl(target.attr, shared, stmt.lineno, class_name)
                )
                return


# -- typestate wiring ---------------------------------------------------------


def _call_obligations(
    call: ast.Call, table: ProtocolTable, factories: frozenset[str]
):
    """(kind, spec-like) entries for one call: protocol methods from
    the table plus the builtin resource-factory vocabulary."""
    name = terminal_name(call.func)
    if name is None:
        return []
    out = list(table.by_callsite.get(name, ()))
    if name in factories:
        out.append(
            ProtoMethod(
                protocol="resource",
                kind="acquire",
                method=name,
                callsite=name,
            )
        )
    return out


_RESOURCE_RELEASES = frozenset(
    {
        "close",
        "unlink",
        "remove",
        "rmtree",
        "release",
        "shutdown",
        "terminate",
        "detach",
    }
)


def _run_typestate(
    fa: FunctionAnalysis,
    module: Module,
    func: ast.FunctionDef,
    graph: cfglib.CFG,
    table: ProtocolTable,
    factories: frozenset[str],
    aliases: dict[str, str] | None = None,
) -> None:
    # 1. find acquisition sites and their bound locals
    acquired_vars: dict[tuple[str, str], list[int]] = {}  # (var, proto) -> sites
    actions: dict[int, list[_Action]] = {}
    release_names_by_proto: dict[str, set[str]] = {}
    for m in table.methods:
        if m.kind == "release":
            release_names_by_proto.setdefault(m.protocol, set()).add(m.callsite)
    release_names_by_proto.setdefault("resource", set()).update(
        _RESOURCE_RELEASES
    )

    bind_positions: dict[str, list[ProtoMethod]] = table.by_callsite

    def bound_var(call: ast.Call, m: ProtoMethod) -> str | None:
        """The local a bind=param acquisition/release attaches to."""
        if m.bind is None:
            return None
        if m.param_index is not None and len(call.args) > m.param_index:
            arg = call.args[m.param_index]
            if isinstance(arg, ast.Name):
                return arg.id
            return None
        for kw in call.keywords:
            if kw.arg == m.bind and isinstance(kw.value, ast.Name):
                return kw.value.id
        return None

    immediate: list[ObligationLeak] = []
    # flag var -> the conditional acquire whose truthiness it carries
    # (``ok = ledger.try_charge(...)``); a later ``if ok:`` / ``if not
    # ok:`` test refines the obligation exactly like testing the call
    cond_flags: dict[str, _Action] = {}

    for node in graph.nodes:
        stmt = node.ast_node
        if stmt is None or isinstance(
            stmt,
            (
                ast.FunctionDef,
                ast.AsyncFunctionDef,
                ast.ClassDef,
                # a handler ENTRY node's ast_node is the whole
                # ExceptHandler; its body statements have their own
                # nodes — walking the subtree here would double-count
                ast.ExceptHandler,
            ),
        ):
            continue
        if node.kind == "expr" and isinstance(stmt, ast.expr):
            # with-item context expressions: an acquire call here is
            # managed by the with (released on both exits) — skip
            continue
        calls_here = [
            sub
            for sub in walk_pruned(stmt)
            if isinstance(sub, ast.Call)
        ]
        for call in calls_here:
            for m in _call_obligations(call, table, factories):
                if m.kind == "acquire":
                    if m.bind is not None:
                        var = bound_var(call, m)
                        if var is None:
                            continue
                        acquired_vars.setdefault((var, m.protocol), []).append(
                            call.lineno
                        )
                        action = _Action(
                            "acquire",
                            var,
                            m.protocol,
                            call.lineno,
                            conditional=m.conditional,
                        )
                        actions.setdefault(id(node), []).append(action)
                        if m.conditional:
                            flag = _assign_target(node, call)
                            if flag is not None:
                                cond_flags[flag] = action
                    else:
                        # result binding: `x = acquire(...)`
                        var = _assign_target(node, call)
                        if var is None:
                            if _escapes_at_use(node, call):
                                continue
                            immediate.append(
                                ObligationLeak(
                                    m.protocol,
                                    "<discarded>",
                                    call.lineno,
                                    on_exception=False,
                                    on_normal=True,
                                    never_released=True,
                                    release_names=tuple(
                                        sorted(
                                            release_names_by_proto.get(
                                                m.protocol, ()
                                            )
                                        )
                                    ),
                                )
                            )
                            continue
                        acquired_vars.setdefault((var, m.protocol), []).append(
                            call.lineno
                        )
                        action = _Action(
                            "acquire",
                            var,
                            m.protocol,
                            call.lineno,
                            conditional=m.conditional,
                        )
                        actions.setdefault(id(node), []).append(action)
                        if m.conditional:
                            # result-bound: the obligation var IS the
                            # truthiness flag (`lease = try_acquire()`)
                            cond_flags[var] = action
    if not acquired_vars:
        fa.leaks.extend(immediate)
        return

    # 2. release sites for the tracked vars (collected BEFORE escape
    # analysis: a local release is proof the function retained
    # ownership, which the escape heuristic needs)
    for node in graph.nodes:
        stmt = node.ast_node
        if stmt is None or isinstance(
            stmt,
            (
                ast.FunctionDef,
                ast.AsyncFunctionDef,
                ast.ClassDef,
                ast.ExceptHandler,
            ),
        ):
            continue
        for call in (
            sub for sub in walk_pruned(stmt) if isinstance(sub, ast.Call)
        ):
            name = terminal_name(call.func)
            if name is None:
                continue
            # protocol releases by table binding
            for m in bind_positions.get(name, ()):
                if m.kind != "release":
                    continue
                var = (
                    bound_var(call, m)
                    if m.bind is not None
                    else (
                        receiver_root(call.func.value)
                        if isinstance(call.func, ast.Attribute)
                        else None
                    )
                )
                if var is None or (var, m.protocol) not in acquired_vars:
                    continue
                actions.setdefault(id(node), []).append(
                    _Action(
                        "release",
                        var,
                        m.protocol,
                        call.lineno,
                        may_raise=m.may_raise,
                    )
                )
            # resource releases: close()-family on the receiver or
            # with the var as an argument
            if name in _RESOURCE_RELEASES:
                candidates: set[str] = set()
                if isinstance(call.func, ast.Attribute):
                    root = receiver_root(call.func.value)
                    if root is not None:
                        candidates.add(root)
                for arg in list(call.args) + [kw.value for kw in call.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Name):
                            candidates.add(sub.id)
                for var in candidates:
                    if (var, "resource") in acquired_vars:
                        actions.setdefault(id(node), []).append(
                            _Action("release", var, "resource", call.lineno)
                        )

    has_release: set[tuple[str, str]] = set()
    for acts in actions.values():
        for a in acts:
            if a.kind == "release":
                has_release.add((a.var, a.protocol))

    tracked_vars = {var for var, _ in acquired_vars}
    released_vars = {var for var, _ in has_release}
    escaped: set[str] = set()
    for var in tracked_vars:
        verdict, passes = _escape_verdict(
            func, var, table, retained=var in released_vars, aliases=aliases
        )
        if verdict is None:
            continue
        escaped.add(var)
        if verdict != "passes":
            continue
        # escape granted ONLY because the var was handed to callables:
        # record the passes so the interprocedural protocol pass can
        # re-judge against the callees' ownership summaries
        for (v, proto), sites in sorted(acquired_vars.items()):
            if v != var or (v, proto) in has_release:
                continue
            fa.borrow_escapes.append(
                BorrowEscape(
                    proto,
                    var,
                    min(sites),
                    tuple(sorted(release_names_by_proto.get(proto, ()))),
                    passes=tuple(passes),
                )
            )

    # drop escaped vars from the action stream entirely
    for node_id, acts in list(actions.items()):
        kept = [a for a in acts if a.var not in escaped]
        if kept:
            actions[node_id] = kept
        else:
            del actions[node_id]

    fa.leaks.extend(immediate)
    if not actions:
        return

    refines: dict[int, tuple[_Action, bool]] = {}
    if cond_flags:
        for node in graph.nodes:
            if node.kind != "test":
                continue
            expr = node.ast_node
            negated = isinstance(expr, ast.UnaryOp) and isinstance(
                expr.op, ast.Not
            )
            inner = expr.operand if negated else expr
            if (
                isinstance(inner, ast.Name)
                and inner.id in cond_flags
                and cond_flags[inner.id].var not in escaped
            ):
                refines[id(node)] = (cond_flags[inner.id], negated)

    analysis = _TypestateAnalysis(actions, refines)
    in_state = dataflow.solve(graph, analysis)

    # 3a. leaks at the exits
    leaks: dict[tuple[str, int, str], list[bool]] = {}
    for exit_node, exceptional in (
        (graph.exit, False),
        (graph.exit_exc, True),
    ):
        state = in_state.get(id(exit_node))
        if not state:
            continue
        for var, site, proto, status in state:
            if status != OPEN:
                continue
            flags = leaks.setdefault((var, site, proto), [False, False])
            flags[1 if exceptional else 0] = True
    for (var, site, proto), (normal, exceptional) in sorted(leaks.items()):
        fa.leaks.append(
            ObligationLeak(
                proto,
                var,
                site,
                on_exception=exceptional,
                on_normal=normal,
                never_released=(var, proto) not in has_release,
                release_names=tuple(
                    sorted(release_names_by_proto.get(proto, ()))
                ),
            )
        )

    # 3b. must-closed double releases
    for node in graph.nodes:
        state = in_state.get(id(node))
        if state is None:
            continue
        for action in actions.get(id(node), ()):
            if action.kind != "release":
                continue
            facts = [
                f
                for f in state
                if f[0] == action.var and f[2] == action.protocol
            ]
            if facts and all(f[3] == CLOSED for f in facts):
                fa.double_releases.append(
                    DoubleRelease(
                        action.protocol,
                        action.var,
                        action.line,
                        min(f[1] for f in facts),
                    )
                )


def _assign_target(node: cfglib.Node, call: ast.Call) -> str | None:
    stmt = node.ast_node
    if (
        isinstance(stmt, ast.Assign)
        and stmt.value is call
        and len(stmt.targets) == 1
        and isinstance(stmt.targets[0], ast.Name)
    ):
        return stmt.targets[0].id
    return None


def _escapes_at_use(node: cfglib.Node, call: ast.Call) -> bool:
    """A result-bound acquire whose value flows onward at the use site
    itself — returned, stored onto an object, passed into an enclosing
    expression — moved ownership rather than discarding it. Only a
    bare expression statement whose entire value IS the acquire call
    truly discards the result."""
    stmt = node.ast_node
    return not (isinstance(stmt, ast.Expr) and stmt.value is call)


def _escape_verdict(
    func: ast.FunctionDef,
    var: str,
    table: ProtocolTable,
    retained: bool = False,
    aliases: dict[str, str] | None = None,
) -> tuple[str | None, list]:
    """Function-wide ownership escape for ``var``. Verdicts:

    - ``"moved"`` — returned/yielded, stored beyond a plain local, or
      handed to a constructor: ownership definitively left;
    - ``"passes"`` — the ONLY escape evidence is being passed as an
      argument to callables (listed in the second result): ownership
      may have moved, but the interprocedural protocol pass re-judges
      against the callees' summaries — a callee proven to only borrow
      the value hands the obligation straight back;
    - ``None`` — no escape. Argument passing is a BORROW, not a move,
      when the function releases the var itself somewhere
      (``retained``) — a worker passing its job token into
      ``download(token=...)`` and detaching it on settle still owns
      the obligation, and the rule must check every settle path."""
    vocab = set(table.by_callsite)
    aliases = aliases or {}
    passes: list = []
    for node in own_statements(func):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            value = getattr(node, "value", None)
            if value is not None and _mentions(value, var):
                return "moved", []
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            stores_elsewhere = any(
                not isinstance(t, ast.Name) for t in targets
            )
            value = getattr(node, "value", None)
            if stores_elsewhere and value is not None and _mentions(value, var):
                return "moved", []
        for sub in walk_pruned(node):
            if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                if sub.value is not None and _mentions(sub.value, var):
                    return "moved", []
            if not isinstance(sub, ast.Call):
                continue
            name = terminal_name(sub.func)
            if name in vocab or name in _RESOURCE_RELEASES:
                continue
            receiver_is_var = isinstance(
                sub.func, ast.Attribute
            ) and receiver_root(sub.func.value) == var
            if receiver_is_var:
                continue  # method call on the var itself moves nothing
            is_constructor = isinstance(sub.func, ast.Name) and (
                sub.func.id == "cls" or sub.func.id[:1].isupper()
            )
            if is_constructor and any(
                _mentions(arg, var)
                for arg in list(sub.args) + [kw.value for kw in sub.keywords]
            ):
                # handing the obligation to a constructor (cls(sock),
                # Wrapper(fh)) moves ownership into the built object —
                # even when this function also releases on an early
                # error path before the wrapper exists
                return "moved", []
            if retained:
                continue  # argument passing is a borrow, not a move
            if name is None:
                # dynamic callee (handlers[0](sock), factory()(fh)):
                # nothing to resolve a summary against, so the old
                # benefit of the doubt stands — ownership moved
                if any(
                    _mentions(arg, var)
                    for arg in list(sub.args)
                    + [kw.value for kw in sub.keywords]
                ):
                    return "moved", []
                continue
            for index, arg in enumerate(sub.args):
                if _mentions(arg, var):
                    site = _call_site(sub, name, (), aliases)
                    pos = index if isinstance(arg, ast.Name) else None
                    passes.append(
                        (name, site.kind, site.recv, sub.lineno, pos, None)
                    )
            for kw in sub.keywords:
                if _mentions(kw.value, var):
                    site = _call_site(sub, name, (), aliases)
                    kwarg = kw.arg if isinstance(kw.value, ast.Name) else None
                    passes.append(
                        (name, site.kind, site.recv, sub.lineno, None, kwarg)
                    )
    if passes:
        return "passes", passes
    return None, []


# -- env reads ----------------------------------------------------------------

_ENV_CALL_NAMES = {"getenv", "flag_from_env"}


def _scan_env_reads(scan: ModuleScan) -> None:
    for node in ast.walk(scan.module.tree):
        if isinstance(node, ast.Call):
            name = terminal_name(node.func)
            knob: ast.expr | None = None
            if name in _ENV_CALL_NAMES and node.args:
                knob = node.args[0]
            elif name == "get" and isinstance(node.func, ast.Attribute):
                recv = node.func.value
                recv_name = (
                    recv.attr
                    if isinstance(recv, ast.Attribute)
                    else recv.id
                    if isinstance(recv, ast.Name)
                    else None
                )
                if recv_name in ("environ", "env") and node.args:
                    knob = node.args[0]
            if (
                knob is not None
                and isinstance(knob, ast.Constant)
                and isinstance(knob.value, str)
                and re.fullmatch(r"[A-Z][A-Z0-9_]*", knob.value)
            ):
                scan.env_reads.append(EnvRead(knob.value, node.lineno))
        elif isinstance(node, ast.Subscript):
            recv = node.value
            recv_name = (
                recv.attr
                if isinstance(recv, ast.Attribute)
                else recv.id
                if isinstance(recv, ast.Name)
                else None
            )
            if recv_name == "environ":
                idx = node.slice
                if (
                    isinstance(idx, ast.Constant)
                    and isinstance(idx.value, str)
                    and re.fullmatch(r"[A-Z][A-Z0-9_]*", idx.value)
                    and isinstance(node.ctx, ast.Load)
                ):
                    scan.env_reads.append(EnvRead(idx.value, node.lineno))
