"""Per-function control-flow graphs for the analyzer.

One ``CFG`` per function: statement-granularity nodes linked by
labelled edges, with explicit modelling of the control constructs the
rules care about — branches, loops, ``try/except/finally``, ``with``,
early ``return``/``raise``/``break``/``continue`` — plus *exception
edges* so a dataflow client can reason about the paths an exception
takes out of a function.

Modelling decisions (they bound both the precision and the noise):

- A statement gets an exception edge only when it contains a call (or
  ``raise``/``assert``) AND an exception construct — a ``try`` with
  handlers or a ``finally`` — encloses it in the *same function*.
  Outside any ``try`` the rules treat straight-line calls as
  non-raising: demanding try/finally around every two-line acquire/
  release pair would drown the tree, and the runtime recorder covers
  that residue. An explicit ``raise`` always takes the exception path.
- Calls whose terminal name is a cleanup/release verb (``close``,
  ``unlink``, ``refund``, protocol release methods, ...) do not raise:
  an exception edge out of a release statement would mark the very
  cleanup idiom the rules demand as itself leaky. Release calls that
  genuinely fail (``complete_multipart``) are declared raising by the
  caller via ``raising_releases``.
- An exception inside a ``try`` body goes to every handler, and ALSO
  propagates outward unless some handler is broad (bare /
  ``Exception`` / ``BaseException``) — handler types are not resolved.
- ``finally`` bodies are built once per continuation that actually
  enters them (fall-through, exception propagation, each unwinding
  return/break/continue) and each copy rejoins its own continuation —
  sharing one body would merge the fall-through's state into the
  exception path and turn every try/finally cleanup into a false
  "leaks on some paths". Unwinding continues outward after each copy,
  so a return threads through every enclosing finally in order.
- ``with`` exits are duplicated per continuation (normal fall-through,
  exception, each unwinding return/break/continue) so the context
  manager's release events stay path-precise — they are single event
  nodes, so duplication is free.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

_BROAD_EXCEPTIONS = {"Exception", "BaseException"}

# terminal callee names assumed non-raising (see module docs); the
# protocol checker extends this set with its release vocabulary
NON_RAISING_CALLS = frozenset(
    {
        "close",
        "unlink",
        "remove",
        "release",
        "shutdown",
        "terminate",
        "detach",
        "cancel",
        "debug",
        "info",
        "warning",
        "error",
        "exception",
        "append",
        "add",
        "discard",
        "pop",
        "clear",
        "set",
    }
)


@dataclass
class Node:
    """One CFG node. ``kind`` is one of:

    - ``entry`` / ``exit`` / ``exit_exc`` — function boundaries
      (``exit_exc`` is the exceptional exit: an exception escaping the
      function);
    - ``stmt`` — a simple statement (``ast_node`` set);
    - ``test`` — a branch/loop condition (``ast_node`` is the test
      expr; successors labelled ``true``/``false``);
    - ``iter`` — a for-loop iterator evaluation (successors ``true``
      = next item, ``false`` = exhausted);
    - ``expr`` — an evaluated sub-expression given its own node (with
      items), ``ast_node`` is the expression;
    - ``event`` — a synthetic state event (lock acquire/release,
      context-manager exit); ``events`` is a list of (verb, payload).
    - ``exc_dispatch`` — exception routing point of one ``try``.
    """

    kind: str
    ast_node: ast.AST | None = None
    events: list[tuple[str, object]] = field(default_factory=list)
    succ: list[tuple[str, "Node"]] = field(default_factory=list)
    line: int = 0

    def edge(self, label: str, target: "Node") -> None:
        self.succ.append((label, target))

    def __repr__(self) -> str:  # debugging aid only
        return f"<{self.kind}@{self.line} {self.events or ''}>"


@dataclass
class CFG:
    func: ast.AST
    entry: Node = None  # type: ignore[assignment]
    exit: Node = None  # type: ignore[assignment]
    exit_exc: Node = None  # type: ignore[assignment]
    nodes: list[Node] = field(default_factory=list)

    def preds(self) -> dict[int, list[tuple[str, Node]]]:
        out: dict[int, list[tuple[str, Node]]] = {id(n): [] for n in self.nodes}
        for node in self.nodes:
            for label, target in node.succ:
                out[id(target)].append((label, node))
        return out


class _Level:
    """One entry of the builder's enclosing-construct stack."""

    __slots__ = (
        "kind",
        "node",
        "loop_head",
        "loop_after",
        "entries",
        "with_events",
        "has_broad",
        "line",
    )

    def __init__(self, kind: str, node: Node | None = None):
        self.kind = kind  # "try" | "finally" | "with" | "loop"
        self.node = node  # dispatch node / loop head
        self.loop_head: Node | None = None
        self.loop_after: Node | None = None
        # finally: one entry node per continuation kind that enters it
        # ("next" | "exc" | "return" | "break" | "continue"); each gets
        # its OWN copy of the finalbody so continuation states never mix
        self.entries: dict[str, Node] = {}
        # with: release events replayed on every exit path
        self.with_events: list[tuple[str, object]] = []
        self.has_broad = False
        self.line = 0


class Builder:
    def __init__(
        self,
        func: ast.AST,
        raising_releases: frozenset[str] = frozenset(),
        non_raising: frozenset[str] = NON_RAISING_CALLS,
        lock_paths=None,
    ):
        """``lock_paths(expr) -> str | None`` resolves a with-item
        context expression to a lock path (engine supplies it so alias
        resolution lives in one place)."""
        self.func = func
        self.cfg = CFG(func)
        self._raising_releases = raising_releases
        self._non_raising = non_raising - raising_releases
        self._lock_path = lock_paths or (lambda expr: None)
        self._stack: list[_Level] = []

    # -- public -----------------------------------------------------------

    def build(self) -> CFG:
        cfg = self.cfg
        cfg.entry = self._node("entry", line=getattr(self.func, "lineno", 0))
        cfg.exit = self._node("exit")
        cfg.exit_exc = self._node("exit_exc")
        frontier = [(cfg.entry, "next")]
        frontier = self._seq(self.func.body, frontier)
        for node, label in frontier:
            node.edge(label, cfg.exit)
        return cfg

    # -- plumbing ---------------------------------------------------------

    def _node(self, kind: str, ast_node: ast.AST | None = None, line: int = 0) -> Node:
        node = Node(kind, ast_node, line=line or getattr(ast_node, "lineno", 0))
        self.cfg.nodes.append(node)
        return node

    @staticmethod
    def _connect(frontier: list[tuple[Node, str]], target: Node) -> None:
        for node, label in frontier:
            node.edge(label, target)

    def _lock_method_calls(self, root: ast.AST):
        """Explicit ``<lock>.acquire()`` / ``<lock>.release()`` calls
        inside ``root`` (nested defs/lambdas excluded), in source
        order — the non-``with`` spelling of lock state, modelled as
        the same lock events so the dataflow sees both."""
        out: list[tuple[str, str, ast.Call]] = []
        stack: list[ast.AST] = [root]
        while stack:
            sub = stack.pop()
            if isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("acquire", "release")
            ):
                path = self._lock_path(sub.func.value)
                if path is not None:
                    out.append((sub.func.attr, path, sub))
            stack.extend(ast.iter_child_nodes(sub))
        out.sort(key=lambda item: (item[2].lineno, item[2].col_offset))
        return out

    def _stmt_lock_events(self, node: Node, stmt: ast.stmt) -> None:
        for verb, path, _ in self._lock_method_calls(stmt):
            node.events.append(
                ("lock_acquire" if verb == "acquire" else "lock_release", path)
            )

    def _test_lock_events(self, node: Node, test: ast.expr) -> None:
        """Lock events for a branch condition. The guarded-acquire
        idiom — ``if lock.acquire(timeout=t):`` / ``if not
        lock.acquire(...):`` — acquires only on the matching branch;
        any other acquire/release inside a test is unconditional."""
        inner = test
        negated = False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = test.operand
            negated = True
        if (
            isinstance(inner, ast.BoolOp)
            and isinstance(inner.op, ast.And)
            and not negated
        ):
            # `if lock.acquire(timeout=t) and cond:` — the true branch
            # definitely holds; the acquired-but-cond-false path goes
            # untracked (false negatives over false positives)
            inner = inner.values[0]
        for verb, path, call in self._lock_method_calls(test):
            if verb == "acquire" and call is inner:
                node.events.append(
                    ("lock_acquire_branch", (path, "false" if negated else "true"))
                )
            else:
                node.events.append(
                    (
                        "lock_acquire" if verb == "acquire" else "lock_release",
                        path,
                    )
                )

    def _may_raise(self, stmt: ast.stmt) -> bool:
        if isinstance(stmt, (ast.Raise, ast.Assert)):
            return True
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(sub, ast.Call):
                name = None
                if isinstance(sub.func, ast.Attribute):
                    name = sub.func.attr
                elif isinstance(sub.func, ast.Name):
                    name = sub.func.id
                if name in self._raising_releases:
                    return True
                if name not in self._non_raising:
                    return True
        return False

    def _fin_entry(self, level: _Level, kind: str) -> Node:
        """The entry node of ``level``'s finalbody copy for one
        continuation kind, created on first use."""
        entry = level.entries.get(kind)
        if entry is None:
            entry = self._node("event", line=level.line)
            level.entries[kind] = entry
        return entry

    def _exc_target(self, from_index: int | None = None) -> Node | None:
        """Where an exception raised at the current stack depth (or at
        ``from_index`` while unwinding) flows: the innermost with-exit
        cleanup, finally entry, or try dispatch; None when nothing in
        this function intercepts it (the caller decides whether the
        statement still gets an edge to ``exit_exc``)."""
        start = len(self._stack) if from_index is None else from_index
        for i in range(start - 1, -1, -1):
            level = self._stack[i]
            if level.kind == "with":
                cleanup = self._node("event")
                cleanup.events = list(level.with_events)
                target = self._exc_target(i) or self.cfg.exit_exc
                cleanup.edge("exc", target)
                return cleanup
            if level.kind == "finally":
                return self._fin_entry(level, "exc")
            if level.kind == "try":
                return level.node
        return None

    def _intercepted(self) -> bool:
        return any(level.kind in ("try", "finally") for level in self._stack)

    def _route_exc(self, node: Node) -> None:
        """Give ``node`` its exception edge if the modelling rules call
        for one (see module docs)."""
        if not self._intercepted():
            return
        target = self._exc_target()
        if target is not None:
            node.edge("exc", target)

    def _unwind(self, node: Node, label: str, kind: str, target: Node | None) -> None:
        """Route a return/break/continue from ``node`` through every
        enclosing with-cleanup and finally, then to ``target`` (the
        exit / loop head / loop after node). ``kind`` tags finally
        continuations."""
        current: tuple[Node, str] = (node, label)
        for i in range(len(self._stack) - 1, -1, -1):
            level = self._stack[i]
            if kind in ("break", "continue") and level.kind == "loop":
                break
            if level.kind == "with":
                cleanup = self._node("event")
                cleanup.events = list(level.with_events)
                current[0].edge(current[1], cleanup)
                current = (cleanup, "next")
            elif level.kind == "finally":
                current[0].edge(current[1], self._fin_entry(level, kind))
                return  # the finalbody copy continues the unwinding
        if target is not None:
            current[0].edge(current[1], target)

    def _loop_level(self) -> _Level | None:
        for level in reversed(self._stack):
            if level.kind == "loop":
                return level
        return None

    # -- statement sequencing ---------------------------------------------

    def _seq(
        self, stmts: list[ast.stmt], frontier: list[tuple[Node, str]]
    ) -> list[tuple[Node, str]]:
        for stmt in stmts:
            if not frontier:
                # unreachable code after return/raise/break: skip —
                # dead statements must not leak facts into the solver
                break
            frontier = self._stmt(stmt, frontier)
        return frontier

    def _stmt(
        self, stmt: ast.stmt, frontier: list[tuple[Node, str]]
    ) -> list[tuple[Node, str]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            # nested defs/classes are separate functions for the
            # engine; the def statement itself transfers no state
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            return [(node, "next")]
        if isinstance(stmt, ast.If):
            return self._if(stmt, frontier)
        if isinstance(stmt, ast.While):
            return self._while(stmt, frontier)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, frontier)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, frontier)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, frontier)
        if isinstance(stmt, ast.Match):
            return self._match(stmt, frontier)
        if isinstance(stmt, ast.Return):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            self._route_exc(node)
            self._unwind(node, "next", "return", self.cfg.exit)
            return []
        if isinstance(stmt, ast.Raise):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            target = self._exc_target()
            node.edge("exc", target if target is not None else self.cfg.exit_exc)
            return []
        if isinstance(stmt, ast.Break):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            loop = self._loop_level()
            self._unwind(
                node, "next", "break", loop.loop_after if loop else None
            )
            return []
        if isinstance(stmt, ast.Continue):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            loop = self._loop_level()
            self._unwind(
                node, "next", "continue", loop.loop_head if loop else None
            )
            return []
        # plain statement
        node = self._node("stmt", stmt)
        self._stmt_lock_events(node, stmt)
        self._connect(frontier, node)
        if self._may_raise(stmt):
            self._route_exc(node)
        return [(node, "next")]

    # -- constructs -------------------------------------------------------

    def _if(self, stmt: ast.If, frontier):
        test = self._node("test", stmt.test)
        self._test_lock_events(test, stmt.test)
        self._connect(frontier, test)
        if self._may_raise(ast.Expr(value=stmt.test)):
            self._route_exc(test)
        then = self._seq(stmt.body, [(test, "true")])
        if stmt.orelse:
            other = self._seq(stmt.orelse, [(test, "false")])
        else:
            other = [(test, "false")]
        return then + other

    @staticmethod
    def _const_true(expr: ast.expr) -> bool:
        return isinstance(expr, ast.Constant) and bool(expr.value)

    def _while(self, stmt: ast.While, frontier):
        head = self._node("test", stmt.test)
        self._test_lock_events(head, stmt.test)
        self._connect(frontier, head)
        if self._may_raise(ast.Expr(value=stmt.test)):
            self._route_exc(head)
        after_frontier: list[tuple[Node, str]] = []
        level = _Level("loop")
        level.loop_head = head
        after = self._node("event")  # join point past the loop
        level.loop_after = after
        self._stack.append(level)
        try:
            body = self._seq(stmt.body, [(head, "true")])
        finally:
            self._stack.pop()
        self._connect(body, head)  # back edge
        if not self._const_true(stmt.test):
            exits = [(head, "false")]
            if stmt.orelse:
                exits = self._seq(stmt.orelse, exits)
            self._connect(exits, after)
        # `while True` with no break never reaches the join node
        return [(after, "next")] if self._reachable(after) else []

    def _for(self, stmt, frontier):
        head = self._node("iter", stmt.iter)
        self._connect(frontier, head)
        if self._may_raise(ast.Expr(value=stmt.iter)):
            self._route_exc(head)
        level = _Level("loop")
        level.loop_head = head
        after = self._node("event")
        level.loop_after = after
        self._stack.append(level)
        try:
            body = self._seq(stmt.body, [(head, "true")])
        finally:
            self._stack.pop()
        self._connect(body, head)
        exits = [(head, "false")]
        if stmt.orelse:
            exits = self._seq(stmt.orelse, exits)
        self._connect(exits, after)
        return [(after, "next")] if self._reachable(after) else []

    def _match(self, stmt: ast.Match, frontier):
        subject = self._node("expr", stmt.subject)
        self._connect(frontier, subject)
        if self._may_raise(ast.Expr(value=stmt.subject)):
            self._route_exc(subject)
        out: list[tuple[Node, str]] = []
        has_catch_all = False
        for case in stmt.cases:
            if (
                isinstance(case.pattern, ast.MatchAs)
                and case.pattern.pattern is None
                and case.guard is None
            ):
                has_catch_all = True
            out += self._seq(case.body, [(subject, "true")])
        if not has_catch_all:
            out.append((subject, "false"))  # no case matched
        return out

    def _reachable(self, node: Node) -> bool:
        return any(
            target is node for n in self.cfg.nodes for _, target in n.succ
        )

    def _with(self, stmt, frontier):
        level = _Level("with")
        enter_frontier = frontier
        for item in stmt.items:
            expr_node = self._node("expr", item.context_expr)
            self._connect(enter_frontier, expr_node)
            if self._may_raise(ast.Expr(value=item.context_expr)):
                self._route_exc(expr_node)
            enter_frontier = [(expr_node, "next")]
            lock = self._lock_path(item.context_expr)
            if lock is not None:
                acquire = self._node(
                    "event", line=getattr(stmt, "lineno", 0)
                )
                acquire.events.append(("lock_acquire", lock))
                self._connect(enter_frontier, acquire)
                enter_frontier = [(acquire, "next")]
                level.with_events.append(("lock_release", lock))
            level.with_events.append(("with_exit", item))
        self._stack.append(level)
        try:
            body = self._seq(stmt.body, enter_frontier)
        finally:
            self._stack.pop()
        exit_node = self._node(
            "event", line=getattr(stmt, "lineno", 0)
        )
        exit_node.events = list(level.with_events)
        self._connect(body, exit_node)
        return [(exit_node, "next")]

    def _try(self, stmt: ast.Try, frontier):
        fin_level: _Level | None = None
        if stmt.finalbody:
            fin_level = _Level("finally")
            fin_level.line = stmt.finalbody[0].lineno
            self._stack.append(fin_level)

        dispatch: Node | None = None
        try_level: _Level | None = None
        if stmt.handlers:
            dispatch = self._node("exc_dispatch", line=stmt.lineno)
            try_level = _Level("try", dispatch)
            try_level.has_broad = any(
                self._is_broad(h.type) for h in stmt.handlers
            )
            self._stack.append(try_level)

        body = self._seq(stmt.body, frontier)
        if stmt.orelse:
            body = self._seq(stmt.orelse, body)

        out: list[tuple[Node, str]] = list(body)
        if try_level is not None:
            self._stack.pop()  # handlers run OUTSIDE their own try
            for handler in stmt.handlers:
                entry = self._node("stmt", handler)
                dispatch.edge("exc", entry)
                out += self._seq(handler.body, [(entry, "next")])
            if not try_level.has_broad:
                # an unmatched exception keeps propagating
                outer = self._exc_target()
                dispatch.edge(
                    "exc", outer if outer is not None else self.cfg.exit_exc
                )

        if fin_level is not None:
            self._stack.pop()
            # every normal completion funnels through the fall-through
            # copy of the finalbody
            if out:
                self._connect(out, self._fin_entry(fin_level, "next"))
            fall_through: list[tuple[Node, str]] = []
            # one finalbody copy per continuation that entered; each
            # copy resumes its continuation outward with the enclosing
            # stack intact (an outer finally sees the return too)
            for kind, entry in sorted(fin_level.entries.items()):
                frontier2 = self._seq(stmt.finalbody, [(entry, "next")])
                if kind == "next":
                    fall_through = frontier2
                elif kind == "exc":
                    target = self._exc_target() or self.cfg.exit_exc
                    for node, label in frontier2:
                        node.edge(label, target)
                else:  # return / break / continue keep unwinding
                    join = self._node("event", line=fin_level.line)
                    self._connect(frontier2, join)
                    loop = self._loop_level()
                    if kind == "return":
                        target = self.cfg.exit
                    elif kind == "break":
                        target = loop.loop_after if loop else None
                    else:
                        target = loop.loop_head if loop else None
                    self._unwind(join, "next", kind, target)
            return fall_through
        return out

    @staticmethod
    def _is_broad(type_node: ast.expr | None) -> bool:
        if type_node is None:
            return True
        names: list[str] = []
        if isinstance(type_node, ast.Tuple):
            names = [n.id for n in type_node.elts if isinstance(n, ast.Name)]
        elif isinstance(type_node, ast.Name):
            names = [type_node.id]
        return any(n in _BROAD_EXCEPTIONS for n in names)


def build(func, raising_releases: frozenset[str] = frozenset(), lock_paths=None) -> CFG:
    return Builder(
        func, raising_releases=raising_releases, lock_paths=lock_paths
    ).build()
