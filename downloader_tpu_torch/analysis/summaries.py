"""Per-function effect summaries: a bottom-up fixpoint over the call
graph's strongly-connected components.

A summary is what a call site needs to know about its callee without
looking inside:

- ``may_block`` — a witness ``(call-name, path, line)`` of a blocking
  call reachable through the function (transitive); blocking sites
  whose line carries a reasoned ``no-blocking-under-lock`` suppression
  do not propagate — the written reason covers the idiom wherever it
  is reached from;
- ``acquires`` — class-qualified lock idents the function (or any
  resolved callee) acquires, with a witness site each: the caller-held
  -> callee-acquired edges the lock-order graph was blind to;
- ``exit_held`` / ``releases`` — explicit ``.acquire()`` balance:
  locks deliberately held across the return (the caller owes a
  release) and locks the function explicitly releases; propagated
  through same-class calls only, because lock paths are spelled
  relative to ``self``;
- ``requires`` — locks a ``# holds:`` annotation declares the caller
  must already hold;
- ``owns_params`` — parameters whose obligation the function takes
  over (releases it, stores it, returns it, or hands it onward to an
  owner): the interprocedural half of the protocol escape analysis. A
  parameter that is only ever *read* is borrowed, and passing an
  obligation to a pure borrower is not an escape;
- ``roles`` — thread roles (``# thread-role:`` spawn annotations)
  whose threads can reach the function; computed top-down after the
  bottom-up pass and consumed by the race rule.

Summaries are recomputed live on every run from the (cacheable)
per-module scans, like every other cross-module judgment — they are
never serialized into the scan cache.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from . import engine
from .callgraph import CallGraph, FuncKey, _key_sort
from .core import Module

_SUPPRESSED_BLOCK_RULE = "no-blocking-under-lock"

# receiver-method names that swallow an argument into a container or
# registry: the value escapes into the receiver's keeping
_CONTAINER_SINKS = frozenset(
    {"append", "add", "put", "insert", "setdefault", "register", "extend",
     "appendleft", "push", "put_nowait", "submit", "send"}
)


@dataclass
class Summary:
    key: FuncKey
    may_block: tuple | None = None  # (name, path, line) witness
    # blocking witnesses whose line carries a no-blocking-under-lock
    # suppression: reported anchored AT the witness, so one reasoned
    # leaf suppression covers every lock-holding caller and is marked
    # used (never stale)
    blocked_suppressed: frozenset = frozenset()
    acquires: dict = field(default_factory=dict)  # ident -> (path, line)
    exit_held: frozenset = frozenset()
    releases: frozenset = frozenset()
    requires: frozenset = frozenset()
    owns_params: frozenset = frozenset()
    roles: frozenset = frozenset()


def lock_ident(class_name: str | None, module_path: str, path: str) -> str:
    """Class-qualified lock ident — MUST mirror the lock-order
    checker's spelling so intra- and inter-procedural edges land in
    one graph."""
    owner = class_name or module_path.rsplit("/", 1)[-1]
    return f"{owner}.{path}"


class Program:
    """The whole-program view: call graph + summaries + role map."""

    def __init__(self, modules: list[Module]):
        self.modules = {m.path: m for m in modules}
        scans = {m.path: engine.scan_cached(m) for m in modules}
        self.scans = scans
        self.graph = CallGraph(modules, scans)
        self.summaries: dict[FuncKey, Summary] = {}
        self._params_cache: dict[FuncKey, list[str]] = {}
        self._compute_bottom_up()
        self.roles: dict[FuncKey, set[str]] = {}
        self.role_spawns: dict[str, list[tuple[str, int]]] = {}
        self._compute_roles()

    # -- plumbing ---------------------------------------------------------

    def function(self, key: FuncKey) -> engine.FunctionAnalysis | None:
        return self.graph.functions.get(key)

    def summary(self, key: FuncKey) -> Summary | None:
        return self.summaries.get(key)

    def params_of(self, key: FuncKey) -> list[str]:
        """Call-site-bindable parameter names (self/cls stripped)."""
        cached = self._params_cache.get(key)
        if cached is not None:
            return cached
        fa = self.function(key)
        names: list[str] = []
        if fa is not None:
            args = fa.node.args
            names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
            if key[1] is not None and names and names[0] in ("self", "cls"):
                names = names[1:]
            names += [a.arg for a in args.kwonlyargs]
        self._params_cache[key] = names
        return names

    # -- SCC condensation -------------------------------------------------

    def _sccs(self) -> list[list[FuncKey]]:
        """Tarjan (iterative), yielding SCCs in reverse topological
        order of the condensation — callees before callers."""
        edges = self.graph.edges
        index_of: dict[FuncKey, int] = {}
        low: dict[FuncKey, int] = {}
        on_stack: set[FuncKey] = set()
        stack: list[FuncKey] = []
        sccs: list[list[FuncKey]] = []
        counter = [0]

        def strongconnect(root: FuncKey) -> None:
            work = [(root, iter(edges.get(root, ())))]
            index_of[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index_of:
                        index_of[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(edges.get(nxt, ()))))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index_of[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index_of[node]:
                    component: list[FuncKey] = []
                    while True:
                        member = stack.pop()
                        on_stack.discard(member)
                        component.append(member)
                        if member == node:
                            break
                    sccs.append(component)

        for key in sorted(self.graph.functions, key=_key_sort):
            if key not in index_of:
                strongconnect(key)
        return sccs

    # -- bottom-up summaries ----------------------------------------------

    def _compute_bottom_up(self) -> None:
        for key in self.graph.functions:
            self.summaries[key] = self._base_summary(key)
        for component in self._sccs():
            changed = True
            while changed:
                changed = False
                for key in component:
                    if self._absorb_callees(key):
                        changed = True
        # ownership fixpoint runs after lock/block effects settle (it
        # shares the SCC order but has its own dependency shape)
        self._compute_ownership()

    def _base_summary(self, key: FuncKey) -> Summary:
        module_path, class_name, _ = key
        module = self.modules[module_path]
        fa = self.graph.functions[key]
        summary = Summary(key)
        witnesses = []
        suppressed = set()
        for call in fa.blocking:
            if module.suppressed(_SUPPRESSED_BLOCK_RULE, call.line):
                # the leaf's written reason covers every reach path —
                # propagated separately so the report anchors at the
                # leaf and the suppression is marked used
                suppressed.add((call.name, module_path, call.line))
                continue
            witnesses.append((call.name, module_path, call.line))
        if witnesses:
            summary.may_block = min(
                witnesses, key=lambda w: (w[1], w[2], w[0])
            )
        summary.blocked_suppressed = frozenset(suppressed)
        for acq in fa.acquires:
            ident = lock_ident(acq.class_name, module_path, acq.path)
            summary.acquires.setdefault(ident, (module_path, acq.line))
        summary.exit_held = frozenset(fa.exit_held)
        summary.releases = frozenset(fa.lock_releases)
        summary.requires = frozenset(module.holds_for(fa.node))
        return summary

    def _absorb_callees(self, key: FuncKey) -> bool:
        summary = self.summaries[key]
        changed = False
        for callee in self.graph.edges.get(key, ()):
            other = self.summaries.get(callee)
            if other is None:
                continue
            if other.may_block is not None and (
                summary.may_block is None
                or (
                    other.may_block[1],
                    other.may_block[2],
                    other.may_block[0],
                )
                < (
                    summary.may_block[1],
                    summary.may_block[2],
                    summary.may_block[0],
                )
            ):
                summary.may_block = other.may_block
                changed = True
            if not other.blocked_suppressed <= summary.blocked_suppressed:
                summary.blocked_suppressed = (
                    summary.blocked_suppressed | other.blocked_suppressed
                )
                changed = True
            for ident, site in other.acquires.items():
                if ident not in summary.acquires:
                    summary.acquires[ident] = site
                    changed = True
            if callee[0] == key[0] and callee[1] == key[1]:
                # same class: self-relative lock paths are comparable
                new_releases = other.releases - summary.releases
                if new_releases:
                    summary.releases = summary.releases | new_releases
                    changed = True
                handed = {
                    path
                    for path in other.exit_held
                    if path not in summary.releases
                }
                if not handed <= summary.exit_held:
                    summary.exit_held = summary.exit_held | handed
                    changed = True
        return changed

    # -- parameter ownership ----------------------------------------------

    def _compute_ownership(self) -> None:
        # first pass: intraprocedural verdicts plus pending
        # pass-through dependencies (param p owned iff callee owns q)
        pending: dict[FuncKey, dict[str, set[tuple[FuncKey, str]]]] = {}
        owned: dict[FuncKey, set[str]] = {}
        for key, fa in self.graph.functions.items():
            owned[key], pending[key] = self._own_params_local(key, fa)
        changed = True
        while changed:
            changed = False
            for key, deps in pending.items():
                for param, targets in list(deps.items()):
                    if param in owned[key]:
                        deps.pop(param, None)
                        continue
                    if any(q in owned.get(t, ()) for t, q in targets):
                        owned[key].add(param)
                        deps.pop(param, None)
                        changed = True
        for key, names in owned.items():
            self.summaries[key].owns_params = frozenset(names)

    def _own_params_local(
        self, key: FuncKey, fa: engine.FunctionAnalysis
    ) -> tuple[set[str], dict[str, set[tuple[FuncKey, str]]]]:
        params = set(self.params_of(key))
        if not params:
            return set(), {}
        module_path = key[0]
        table = getattr(
            self.modules[module_path], "_protocol_table", engine.EMPTY_TABLE
        )
        release_vocab = {
            m.callsite for m in table.methods if m.kind == "release"
        } | set(engine._RESOURCE_RELEASES)
        aliases = engine._lexical_aliases(fa.node)
        owned: set[str] = set()
        deps: dict[str, set[tuple[FuncKey, str]]] = {}
        for stmt in engine.own_statements(fa.node):
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                # `with p:` (or `with closing(p):`) finalizes the
                # param on exit — that IS taking the obligation over
                for item in stmt.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Name) and expr.id in params:
                        owned.add(expr.id)
                    elif (
                        isinstance(expr, ast.Call)
                        and engine.terminal_name(expr.func) == "closing"
                    ):
                        for arg in expr.args:
                            if isinstance(arg, ast.Name) and arg.id in params:
                                owned.add(arg.id)
            if isinstance(stmt, (ast.Return, ast.Yield, ast.YieldFrom)):
                value = getattr(stmt, "value", None)
                if value is not None:
                    for p in params:
                        if engine._mentions(value, p):
                            owned.add(p)
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    stmt.targets
                    if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                if any(not isinstance(t, ast.Name) for t in targets):
                    value = getattr(stmt, "value", None)
                    if value is not None:
                        for p in params:
                            if engine._mentions(value, p):
                                owned.add(p)
            for sub in engine.walk_pruned(stmt):
                if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                    if sub.value is not None:
                        for p in params:
                            if engine._mentions(sub.value, p):
                                owned.add(p)
                if not isinstance(sub, ast.Call):
                    continue
                name = engine.terminal_name(sub.func)
                if name is None:
                    for p in params:
                        if any(
                            engine._mentions(a, p)
                            for a in list(sub.args)
                            + [kw.value for kw in sub.keywords]
                        ):
                            owned.add(p)
                    continue
                receiver_root = (
                    engine.receiver_root(sub.func.value)
                    if isinstance(sub.func, ast.Attribute)
                    else None
                )
                if name in release_vocab:
                    # p.close() / refund(key=p): released here
                    if receiver_root in params:
                        owned.add(receiver_root)
                    for p in params:
                        if any(
                            engine._mentions(a, p)
                            for a in list(sub.args)
                            + [kw.value for kw in sub.keywords]
                        ):
                            owned.add(p)
                    continue
                # (a plain method call on the param itself is a read:
                # receivers are not call arguments, so they never land
                # in `mentioned` below)
                mentioned = [
                    p
                    for p in params
                    if any(
                        engine._mentions(a, p)
                        for a in list(sub.args)
                        + [kw.value for kw in sub.keywords]
                    )
                ]
                if not mentioned:
                    continue
                if name in _CONTAINER_SINKS:
                    owned.update(mentioned)
                    continue
                is_constructor = isinstance(sub.func, ast.Name) and (
                    sub.func.id == "cls" or sub.func.id[:1].isupper()
                )
                if is_constructor:
                    owned.update(mentioned)
                    continue
                site = engine._call_site(sub, name, (), aliases)
                callee = self.graph.resolve(module_path, fa, site)
                if callee is None:
                    owned.update(mentioned)  # unknown callee: assume it owns
                    continue
                callee_params = self.params_of(callee)
                for p in mentioned:
                    bound = self._bound_param(sub, p, callee_params)
                    if bound is None:
                        owned.add(p)  # un-bindable: assume escaped
                    else:
                        deps.setdefault(p, set()).add((callee, bound))
        return owned, {p: t for p, t in deps.items() if p not in owned}

    @staticmethod
    def _bound_param(
        call: ast.Call, var: str, callee_params: list[str]
    ) -> str | None:
        for index, arg in enumerate(call.args):
            if isinstance(arg, ast.Name) and arg.id == var:
                if index < len(callee_params):
                    return callee_params[index]
                return None
        for kw in call.keywords:
            if isinstance(kw.value, ast.Name) and kw.value.id == var:
                if kw.arg in callee_params:
                    return kw.arg
                return None
        return None

    # -- thread roles ------------------------------------------------------

    def _compute_roles(self) -> None:
        seeds: dict[FuncKey, set[str]] = {}
        for key, fa in self.graph.functions.items():
            for spawn in fa.thread_spawns:
                if spawn.role is None:
                    continue
                target = self.graph.resolve_spawn(key[0], fa, spawn)
                self.role_spawns.setdefault(spawn.role, []).append(
                    (key[0], spawn.line)
                )
                if target is not None:
                    seeds.setdefault(target, set()).add(spawn.role)
        for target, names in seeds.items():
            for role in names:
                self._flood_role(target, role)
        for key, roles in self.roles.items():
            self.summaries[key].roles = frozenset(roles)

    def _flood_role(self, start: FuncKey, role: str) -> None:
        work = [start]
        while work:
            key = work.pop()
            have = self.roles.setdefault(key, set())
            if role in have:
                continue
            have.add(role)
            work.extend(self.graph.edges.get(key, ()))

    # -- reachability (blocking-deadline roots) ---------------------------

    def reachable_from(self, roots: list[FuncKey]) -> set[FuncKey]:
        seen: set[FuncKey] = set()
        work = list(roots)
        while work:
            key = work.pop()
            if key in seen:
                continue
            seen.add(key)
            work.extend(self.graph.edges.get(key, ()))
        return seen

    # -- artifact ----------------------------------------------------------

    def to_json(self) -> dict:
        """The call graph + summary table as one JSON-able artifact."""

        def fmt(key: FuncKey) -> str:
            module, cls, name = key
            qual = f"{cls}.{name}" if cls else name
            return f"{module}::{qual}"

        edges = [
            [fmt(src), fmt(dst)]
            for src in sorted(self.graph.edges, key=_key_sort)
            for dst in self.graph.edges[src]
        ]
        table = {}
        for key in sorted(self.summaries, key=_key_sort):
            s = self.summaries[key]
            entry: dict = {}
            if s.may_block:
                entry["may_block"] = {
                    "call": s.may_block[0],
                    "site": f"{s.may_block[1]}:{s.may_block[2]}",
                }
            if s.acquires:
                entry["acquires"] = {
                    ident: f"{site[0]}:{site[1]}"
                    for ident, site in sorted(s.acquires.items())
                }
            if s.exit_held:
                entry["exit_held"] = sorted(s.exit_held)
            if s.releases:
                entry["releases"] = sorted(s.releases)
            if s.requires:
                entry["requires"] = sorted(s.requires)
            if s.owns_params:
                entry["owns_params"] = sorted(s.owns_params)
            if s.roles:
                entry["roles"] = sorted(s.roles)
            if entry:
                table[fmt(key)] = entry
        return {
            "functions": len(self.summaries),
            "edges": edges,
            "summaries": table,
            "roles": {
                role: sorted(f"{p}:{line}" for p, line in spawns)
                for role, spawns in sorted(self.role_spawns.items())
            },
        }


def program_for(modules: list[Module]) -> Program:
    """The (memoized) whole-program view for one Analyzer run. Keyed
    on the module objects themselves: every run loads fresh Modules,
    and all prepare passes finish before the first check, so the
    vocabulary is pinned by the time anyone asks."""
    if not modules:
        return Program([])
    host = modules[0]
    cached = getattr(host, "_ip_program", None)
    if cached is not None:
        return cached
    program = Program(modules)
    host._ip_program = program  # type: ignore[attr-defined]
    return program
