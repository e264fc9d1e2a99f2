"""The shipped rule set, all running on the shared CFG/dataflow engine
(``engine.scan_module``). Each checker is grounded in a regression
class this codebase has actually paid for: the analyzer exists to make
those one-time lessons mechanical.
"""

from __future__ import annotations

import ast
from pathlib import Path

from . import engine, protocols, summaries
from .core import Checker, Module, Violation, find_cycles, register

_BROAD_EXCEPTIONS = {"Exception", "BaseException"}

# resource-creating callables recognized by terminal name; functions
# annotated `# resource-factory` on their def line join this set
_RESOURCE_FACTORIES = frozenset(
    {
        "open",
        "socket",
        "create_connection",
        "socketpair",
        "mkstemp",
        "mkdtemp",
        "NamedTemporaryFile",
        "TemporaryFile",
        "SpooledTemporaryFile",
        "makefile",
        "fdopen",
    }
)


def _scan(module: Module) -> engine.ModuleScan:
    # one shared scan per module per Analyzer run; checkers run in
    # sequence on the same thread, so a plain memo on the module works.
    # The protocol/resource prepare passes run before any check, so the
    # vocabulary tables are already pinned on the module by scan time.
    return engine.scan_cached(module)


class InterproceduralChecker(Checker):
    """Base for rules that consume call-site summaries: ``prepare``
    pins the module set, ``_program`` materializes the whole-program
    view lazily — at first *check*, after every prepare pass (protocol
    table, factory vocabulary) has pinned what the scans depend on."""

    cross_module = True  # a summary can change from another module

    def __init__(self) -> None:
        self._modules: list[Module] = []

    def prepare(self, modules: list[Module]) -> None:
        self._modules = modules

    def _program(self) -> summaries.Program:
        return summaries.program_for(self._modules)


def _judge_borrow_escapes(
    checker: InterproceduralChecker,
    module: Module,
    fa: engine.FunctionAnalysis,
    resource: bool,
) -> list[Violation]:
    """The interprocedural half of the escape analysis: an obligation
    whose only escape evidence is argument passing is re-judged
    against the callees' ownership summaries. Ownership moved if ANY
    pass lands in a callee that releases/stores/returns the parameter
    — or in one the call graph cannot resolve (unknowable, so the old
    benefit of the doubt stands). But when EVERY pass is proven a pure
    borrow, the obligation came straight back and the leak is real."""
    program = checker._program()
    out: list[Violation] = []
    for escape in fa.borrow_escapes:
        if (escape.protocol == "resource") is not resource:
            continue
        borrowers: list[str] = []
        proven = True
        for name, kind, recv, line, pos, kwarg in escape.passes:
            site = engine.CallSite(name, line, (), kind, recv, (), ())
            callee = program.graph.resolve(module.path, fa, site)
            if callee is None:
                proven = False  # unknown callee may take ownership
                break
            params = program.params_of(callee)
            if kwarg is not None:
                bound = kwarg if kwarg in params else None
            elif pos is not None and pos < len(params):
                bound = params[pos]
            else:
                bound = None
            if bound is None:
                proven = False  # un-bindable (*args, expression arg)
                break
            summary = program.summary(callee)
            if summary is None or bound in summary.owns_params:
                proven = False  # the callee takes the obligation over
                break
            borrowers.append(f"{name}()")
        if not proven or not borrowers:
            continue
        releases = "/".join(escape.release_names) or "a release method"
        what = (
            f"'{escape.var}' from a resource factory"
            if resource
            else f"protocol {escape.protocol}: '{escape.var}' acquired here"
        )
        out.append(
            Violation(
                checker.rule,
                module.path,
                escape.line,
                f"{what} is only ever lent out — every callee it reaches "
                f"({', '.join(sorted(set(borrowers)))}) merely borrows it "
                f"and never releases or keeps it; release via {releases} "
                "on every path, or move ownership for real",
            )
        )
    return out


@register
class ProtocolChecker(InterproceduralChecker):
    """Lifecycle typestate: a method annotated ``# protocol: <name>
    acquire`` opens an obligation the same function must close through
    a matching ``release`` method on EVERY control-flow path —
    branches, early returns, and the exception edges of ``try``
    blocks — unless ownership explicitly escapes (returned, stored on
    an object, handed to another callable that provably keeps it: a
    callee summary showing the parameter is only borrowed hands the
    obligation straight back). The dual runtime half is
    ``analysis.runtime.ProtocolRecorder``. A release the engine proves
    already-released on every incoming path is a double release."""

    rule = "protocol"

    def prepare(self, modules: list[Module]) -> None:
        super().prepare(modules)
        table = protocols.collect_table(modules)
        for module in modules:
            module._protocol_table = table  # type: ignore[attr-defined]

    def check(self, module: Module) -> list[Violation]:
        out: list[Violation] = []
        for fa in _scan(module).functions:
            out.extend(_judge_borrow_escapes(self, module, fa, resource=False))
            for leak in fa.leaks:
                if leak.protocol == "resource":
                    continue
                releases = (
                    "/".join(leak.release_names) or "a release method"
                )
                if leak.never_released:
                    how = f"is never released (release via {releases})"
                elif leak.on_exception and not leak.on_normal:
                    how = (
                        f"is not released on an exception path "
                        f"(release via {releases} in a finally/handler)"
                    )
                else:
                    how = f"may not be released on every path ({releases})"
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        leak.line,
                        f"protocol {leak.protocol}: '{leak.var}' acquired "
                        f"here {how}, and ownership does not escape",
                    )
                )
            for dbl in fa.double_releases:
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        dbl.line,
                        f"protocol {dbl.protocol}: '{dbl.var}' (acquired at "
                        f"line {dbl.acquire_line}) is already released on "
                        "every path reaching this release — double release",
                    )
                )
        return out


@register
class GuardedByChecker(InterproceduralChecker):
    """Attributes annotated ``# guarded-by: <lock>`` may only be
    touched while that lock is held (per the CFG lock-state analysis,
    or via a ``# holds:`` def annotation). ``__init__`` is exempt: no
    other thread can hold a reference during construction. The
    ``# holds:`` contract is enforced at call sites too: calling an
    annotated method through ``self`` without actually holding its
    declared locks is the caller's violation, summary-checked."""

    rule = "guarded-by"
    # guard declarations, accesses, and (self-call) holds contracts all
    # live in one module, so per-file staleness stays decidable; the
    # base-class-in-another-module holds residue is accepted
    cross_module = False

    def check(self, module: Module) -> list[Violation]:
        scan = _scan(module)
        out: list[Violation] = []
        out.extend(self._check_accesses(module, scan))
        out.extend(self._check_holds_contracts(module, scan))
        return out

    def _check_accesses(self, module, scan) -> list[Violation]:
        guards: dict[tuple[str | None, str], str] = {}
        for decl in scan.guards:
            guards[(decl.class_name, decl.attr)] = decl.lock
        if not guards:
            return []
        out: list[Violation] = []
        seen: set[tuple[int, str]] = set()
        for func in scan.functions:
            if func.node.name == "__init__":
                continue
            for access in func.accesses:
                lock = guards.get((access.class_name, access.attr))
                if lock is None or lock in access.held:
                    continue
                key = (access.line, access.attr)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        access.line,
                        f"'self.{access.attr}' is guarded by '{lock}' but "
                        f"accessed in {access.func_name}() without it "
                        f"(held: {list(access.held) or 'none'})",
                    )
                )
        return out

    def _check_holds_contracts(self, module, scan) -> list[Violation]:
        """A ``# holds: <lock>`` def annotation is a contract the
        CALLER must honor. Only ``self.`` calls are judged — the
        callee's lock paths are spelled relative to the same object
        the caller's held set uses, so the two are comparable."""
        program = self._program()
        out: list[Violation] = []
        seen: set[tuple[int, str]] = set()
        for fa in scan.functions:
            if fa.class_name is None or fa.node.name == "__init__":
                continue
            for site in fa.call_sites:
                if site.kind != "self":
                    continue
                callee = program.graph.resolve(module.path, fa, site)
                if callee is None or callee[0] != module.path:
                    # same-module callees only: it keeps this rule's
                    # findings (and suppression staleness) decidable
                    # per file, which cross_module=False promises
                    continue
                summary = program.summary(callee)
                if summary is None or not summary.requires:
                    continue
                missing = sorted(summary.requires - set(site.held))
                if not missing:
                    continue
                key = (site.line, site.name)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        site.line,
                        f"'{site.name}()' declares `# holds: "
                        f"{', '.join(missing)}` but this call does not "
                        f"hold it (held: {list(site.held) or 'none'})",
                    )
                )
        return out


@register
class BlockingUnderLockChecker(InterproceduralChecker):
    """No sleeps, joins, socket I/O, or future/event waits while any
    lock is held: a blocked holder turns every other thread that needs
    the lock into a convoy, and a blocked holder that also waits on
    one of those threads is a deadlock. Summary-checked through calls:
    a helper that blocks three hops down is flagged at the call made
    under the lock, with the transitive blocking site named."""

    rule = "no-blocking-under-lock"

    def check(self, module: Module) -> list[Violation]:
        out: list[Violation] = []
        program = self._program()
        for func in _scan(module).functions:
            for call in func.blocking:
                if not call.held:
                    continue  # the bare fact only feeds summaries
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        call.line,
                        f"blocking call '{call.name}()' while holding "
                        f"{list(call.held)}",
                    )
                )
            seen: set[tuple[int, str]] = set()
            for site in func.call_sites:
                if not site.held or site.name in engine.BLOCKING_NAMES:
                    continue  # direct blocking is reported above
                callee = program.graph.resolve(module.path, func, site)
                if callee is None:
                    continue
                summary = program.summary(callee)
                if summary is None:
                    continue
                for block_name, block_path, block_line in sorted(
                    summary.blocked_suppressed
                ):
                    # anchored AT the suppressed leaf: the one written
                    # reason there covers this caller too, and the
                    # match keeps the suppression from reading stale
                    out.append(
                        Violation(
                            self.rule,
                            block_path,
                            block_line,
                            f"blocking call '{block_name}()' is reached "
                            f"while holding {list(site.held)} (via "
                            f"'{site.name}()' at {module.path}:{site.line})",
                        )
                    )
                if summary.may_block is None:
                    continue
                key = (site.line, site.name)
                if key in seen:
                    continue
                seen.add(key)
                block_name, block_path, block_line = summary.may_block
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        site.line,
                        f"call to '{site.name}()' while holding "
                        f"{list(site.held)} may block: reaches "
                        f"'{block_name}()' at {block_path}:{block_line}",
                    )
                )
        return out


@register
class LockOrderChecker(InterproceduralChecker):
    """The static lock-acquisition graph must be cycle-free. Nodes are
    class-qualified lock paths; an edge A->B is recorded whenever
    ``with B:`` executes while the engine proves A held (nested
    ``with`` blocks, or a ``# holds: A`` function acquiring B) — and,
    summary-checked, whenever a call made while A is held reaches a
    function that acquires B, however many hops away: the cross-class
    orders only the runtime recorder used to see."""

    rule = "lock-order"
    # a cycle introduced by a changed file can anchor at an OLD edge in
    # an unchanged module — --diff must never filter these out
    global_anchor = True

    def __init__(self) -> None:
        super().__init__()
        # edge -> first (path, line) that exhibits it
        self._edges: dict[tuple[str, str], tuple[str, int]] = {}

    @staticmethod
    def _ident(class_name: str | None, module: Module, path: str) -> str:
        owner = class_name or module.path.rsplit("/", 1)[-1]
        return f"{owner}.{path}"

    def check(self, module: Module) -> list[Violation]:
        program = self._program()
        for func in _scan(module).functions:
            for acq in func.acquires:
                new = self._ident(acq.class_name, module, acq.path)
                for held in acq.held:
                    src = self._ident(acq.class_name, module, held)
                    if src == new:
                        continue
                    self._edges.setdefault(
                        (src, new), (module.path, acq.line)
                    )
            for site in func.call_sites:
                if not site.held:
                    continue
                callee = program.graph.resolve(module.path, func, site)
                if callee is None:
                    continue
                summary = program.summary(callee)
                if summary is None or not summary.acquires:
                    continue
                for held in site.held:
                    src = self._ident(func.class_name, module, held)
                    for acquired in summary.acquires:
                        if src == acquired:
                            continue
                        self._edges.setdefault(
                            (src, acquired), (module.path, site.line)
                        )
        return []

    def finalize(self) -> list[Violation]:
        graph: dict[str, list[str]] = {}
        for src, dst in self._edges:
            graph.setdefault(src, []).append(dst)
        out: list[Violation] = []
        for edge_src, edge_dst, cycle in find_cycles(graph):
            edge = self._edges.get((edge_src, edge_dst)) or next(
                iter(self._edges.values())
            )
            out.append(
                Violation(
                    self.rule,
                    edge[0],
                    edge[1],
                    "lock-order cycle: " + " -> ".join(cycle),
                )
            )
        return out

    def edges(self) -> dict[tuple[str, str], tuple[str, int]]:
        """The collected acquisition edges (introspection/tests)."""
        return dict(self._edges)


@register
class LockBalanceChecker(InterproceduralChecker):
    """Explicit ``.acquire()`` calls must balance. Intraprocedurally: a
    lock acquired explicitly and released on only SOME paths is the
    classic leak (``with`` cannot leak — its exits release by
    construction). Interprocedurally: a helper may deliberately return
    holding (lock chaining), but then every ``self.`` caller owes the
    release — a caller that never releases the handed-over lock,
    directly or through a releasing helper, leaks it for good."""

    rule = "lock-balance"

    def check(self, module: Module) -> list[Violation]:
        program = self._program()
        out: list[Violation] = []
        for fa in _scan(module).functions:
            for path, line in fa.lock_imbalances:
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        line,
                        f"'{path}' is explicitly acquired here but released "
                        "on only some paths (early return, exception, or a "
                        "skipped branch); use `with`, or release in a "
                        "`finally`",
                    )
                )
            if fa.class_name is None:
                continue
            caller_key = (module.path, fa.class_name, fa.node.name)
            caller_summary = program.summary(caller_key)
            releases = (
                caller_summary.releases
                if caller_summary is not None
                else frozenset(fa.lock_releases)
            )
            if program.graph.reverse.get(caller_key):
                # this caller propagates the hand-off upward (its own
                # summary carries exit_held), and SOMEONE calls it —
                # the judgment belongs at the top of the chain, where
                # no caller is left to release. A mid-chain delegator
                # above a releasing top caller is correct code.
                continue
            seen: set[tuple[int, str]] = set()
            for site in fa.call_sites:
                if site.kind != "self":
                    continue
                callee = program.graph.resolve(module.path, fa, site)
                if callee is None:
                    continue
                summary = program.summary(callee)
                if summary is None or not summary.exit_held:
                    continue
                leaked = sorted(summary.exit_held - releases)
                if not leaked:
                    continue
                key = (site.line, site.name)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        site.line,
                        f"'{site.name}()' returns still holding "
                        f"{leaked} and {fa.node.name}() never releases "
                        "it — a cross-function lock leak",
                    )
                )
        return out


@register
class ResourceFinalizationChecker(InterproceduralChecker):
    """A socket/file/tempfile created in a function must reach
    close/unlink on every CFG path — including the exception edges of
    any enclosing ``try`` — unless ownership escapes (summary-checked:
    handing the handle to a callee proven to only borrow it is not an
    escape). This is the protocol typestate machinery applied to the
    builtin "resource" protocol whose acquire set is the factory
    vocabulary."""

    rule = "resource-finalization"

    def prepare(self, modules: list[Module]) -> None:
        super().prepare(modules)
        factories = set(_RESOURCE_FACTORIES)
        for module in modules:
            if not module.factory_lines:
                continue  # nothing annotated: skip the full-tree walk
            for node in ast.walk(module.tree):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and any(
                    line in module.factory_lines
                    for line in range(
                        node.lineno,
                        (node.body[0].lineno if node.body else node.lineno)
                        + 1,
                    )
                ):
                    factories.add(node.name)
        frozen = frozenset(factories)
        for module in modules:
            module._factory_names = frozen  # type: ignore[attr-defined]

    def check(self, module: Module) -> list[Violation]:
        out: list[Violation] = []
        for fa in _scan(module).functions:
            out.extend(_judge_borrow_escapes(self, module, fa, resource=True))
            for leak in fa.leaks:
                if leak.protocol != "resource":
                    continue
                if leak.never_released:
                    what = "never reaches close/unlink in this function"
                elif leak.on_exception and not leak.on_normal:
                    what = (
                        "is not closed on an exception path; close it in "
                        "a finally (or the handler), or use `with`"
                    )
                else:
                    what = (
                        "is closed on some paths only; use `with`, "
                        "try/finally, or close it on every branch"
                    )
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        leak.line,
                        f"'{leak.var}' from a resource factory {what}",
                    )
                )
        return out


@register
class ExceptionHygieneChecker(Checker):
    """No bare ``except:``, no silent broad swallows, and thread
    targets must be shielded. An exception escaping a thread target
    kills the worker with nothing but a stderr traceback — the job
    hangs instead of failing."""

    rule = "exception-hygiene"

    @staticmethod
    def _is_broad(type_node: ast.expr | None) -> bool:
        if type_node is None:
            return True
        names = []
        if isinstance(type_node, ast.Tuple):
            names = [
                n.id for n in type_node.elts if isinstance(n, ast.Name)
            ]
        elif isinstance(type_node, ast.Name):
            names = [type_node.id]
        return any(n in _BROAD_EXCEPTIONS for n in names)

    def check(self, module: Module) -> list[Violation]:
        out: list[Violation] = []
        out.extend(self._check_handlers(module))
        out.extend(self._check_thread_targets(module))
        return out

    def _check_handlers(self, module: Module) -> list[Violation]:
        out = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        node.lineno,
                        "bare 'except:' also swallows KeyboardInterrupt/"
                        "SystemExit; name the exceptions (or Exception)",
                    )
                )
                continue
            body_is_silent = all(
                isinstance(stmt, ast.Pass)
                or (
                    isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Constant)
                )
                for stmt in node.body
            )
            if body_is_silent and self._is_broad(node.type):
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        node.lineno,
                        "silent broad swallow: narrow the exception type "
                        "or log what was ignored",
                    )
                )
        return out

    def _check_thread_targets(self, module: Module) -> list[Violation]:
        scan = _scan(module)
        out = []
        for fa in scan.functions:
            for spawn in fa.thread_spawns:
                if spawn.via == "submit":
                    # an executor captures the exception in its Future;
                    # nothing dies silently — out of this rule's scope
                    continue
                resolved = self._resolve_target(
                    spawn.kind, spawn.target_name, scan.methods,
                    spawn.class_name,
                )
                if resolved is None:
                    continue  # lambda/partial/unknown: out of static reach
                if self._is_shielded(
                    resolved.node, scan.methods, spawn.class_name
                ):
                    continue
                out.append(
                    Violation(
                        self.rule,
                        module.path,
                        spawn.line,
                        f"thread target '{resolved.node.name}' has no broad "
                        "exception handler: an escaped exception kills the "
                        "worker silently",
                    )
                )
        return out

    @staticmethod
    def _resolve_target(kind, name, methods, cls):
        if name is None:
            return None
        if kind == "self":
            # exact class only — a base-class method defined in another
            # module is out of static reach and skipped, never guessed
            return methods.get((cls, name))
        if kind == "name":
            # module-level function, or a helper def nested in this
            # class's methods (indexed under the class)
            return methods.get((None, name)) or methods.get((cls, name))
        return None

    def _is_shielded(
        self,
        func: ast.FunctionDef,
        methods,
        cls: str | None = None,
        depth: int = 0,
    ) -> bool:
        """A broad handler (bare counts) somewhere in the function's
        own statement tree. Thin delegating wrappers — a body that is a
        single call (optionally inside one ``with``) — are followed up
        to three hops so the shield can live in the real worker."""
        stack: list[ast.AST] = list(func.body)
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.ExceptHandler) and self._is_broad(
                node.type
            ):
                # a broad handler that just re-raises is not a shield
                if not (
                    len(node.body) == 1
                    and isinstance(node.body[0], ast.Raise)
                    and node.body[0].exc is None
                ):
                    return True
            stack.extend(ast.iter_child_nodes(node))
        if depth >= 3:
            return False
        delegate = self._delegation_call(func)
        if delegate is not None:
            kind = None
            name = None
            if isinstance(delegate, ast.Attribute) and isinstance(
                delegate.value, ast.Name
            ) and delegate.value.id == "self":
                kind, name = "self", delegate.attr
            elif isinstance(delegate, ast.Name):
                kind, name = "name", delegate.id
            resolved = self._resolve_target(kind, name, methods, cls)
            if resolved is not None and resolved.node is not func:
                return self._is_shielded(
                    resolved.node, methods, cls, depth + 1
                )
        return False

    @staticmethod
    def _delegation_call(func: ast.FunctionDef) -> ast.expr | None:
        """The callee of a pure one-call wrapper body, else None."""
        body = [
            stmt
            for stmt in func.body
            if not (
                isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
            )
        ]
        if len(body) == 1 and isinstance(body[0], ast.With):
            body = body[0].body
        if (
            len(body) == 1
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Call)
        ):
            return body[0].value.func
        return None


@register
class BlockingDeadlineChecker(InterproceduralChecker):
    """Every blocking call reachable from daemon/worker code — socket
    ops, ``wait()``/``join()``/``get()``/``result()``, explicit lock
    ``acquire()`` — must carry a finite deadline or a registered
    cancel hook. Reachability walks the RESOLVED call graph rooted at
    the daemon package and every ``threading.Thread`` target (the old
    name-based walk — any function sharing a name with anything a
    worker called — is gone); an un-cancellable wait anywhere on those
    paths is exactly the wedged-worker class the watchdog PRs spent
    review rounds hunting.

    What satisfies the audit, per call shape:

    - ``wait``/``join``/``result``/``get``/``select``: a finite
      timeout argument (``timeout=None`` does not count; ``get()``
      with positional arguments is assumed to be ``dict.get``);
      ``wait()`` on a cancel token is the cancel mechanism itself.
    - explicit ``acquire()`` on a lock-like receiver: a timeout
      (``with lock:`` is exempt — lock holders cannot block, by the
      no-blocking-under-lock rule, so the wait is bounded).
    - socket ops (``recv``/``accept``/``connect``/...): a
      ``settimeout`` in the same function or class, or a ``timeout=``
      kwarg at the connection constructor in the same class.
    - anything else: a ``# deadline: <reason>`` annotation on the call
      line or the def line, documenting how the wait is bounded (the
      reason is the review artifact, like suppressions)."""

    rule = "blocking-deadline"

    _DAEMON_MARKERS = ("/daemon/", "\\daemon\\")

    def __init__(self) -> None:
        super().__init__()
        self._reachable: set[int] | None = None

    def prepare(self, modules: list[Module]) -> None:
        super().prepare(modules)
        self._reachable = None

    def _reachable_ids(self) -> set[int]:
        """ids of every FunctionAnalysis on a resolved call path from
        a daemon function or a thread target (lazy: the program view
        needs every other prepare pass done first)."""
        if self._reachable is not None:
            return self._reachable
        program = self._program()
        roots: list = []
        for key, fa in program.graph.functions.items():
            if any(marker in key[0] for marker in self._DAEMON_MARKERS):
                roots.append(key)
            for spawn in fa.thread_spawns:
                target = program.graph.resolve_spawn(key[0], fa, spawn)
                if target is not None:
                    roots.append(target)
        self._reachable = {
            id(program.function(k))
            for k in program.reachable_from(roots)
        }
        return self._reachable

    def _class_evidence(self, scan: engine.ModuleScan) -> set[str | None]:
        """Classes with any deadline discipline in view: a settimeout
        call or a timeout= kwarg anywhere in their methods."""
        out: set[str | None] = set()
        for fa in scan.functions:
            if fa.has_settimeout or fa.has_timeout_kwarg:
                out.add(fa.class_name)
        return out

    @staticmethod
    def _annotated(module: Module, fa, line: int) -> bool:
        if module.deadline_reason(line) is not None:
            return True
        # the reason is REQUIRED, like suppressions: an empty
        # `# deadline:` annotates nothing
        func = fa.node
        end = func.body[0].lineno if func.body else func.lineno
        return any(
            module.deadline_lines.get(ln)
            for ln in range(func.lineno, end + 1)
        )

    @staticmethod
    def _is_cancel_receiver(site: engine.DeadlineSite) -> bool:
        name = (site.receiver or site.receiver_name or "").rsplit(
            ".", 1
        )[-1].lower()
        return name.endswith("token") or name in ("cancel", "cancelled")

    def check(self, module: Module) -> list[Violation]:
        scan = _scan(module)
        evidence = self._class_evidence(scan)
        reachable = self._reachable_ids()
        out: list[Violation] = []
        for fa in scan.functions:
            if id(fa) not in reachable:
                continue
            for site in fa.deadline_sites:
                complaint = self._judge(fa, site, evidence)
                if complaint is None:
                    continue
                if self._annotated(module, fa, site.line):
                    continue
                out.append(
                    Violation(self.rule, module.path, site.line, complaint)
                )
        return out

    def _judge(self, fa, site: engine.DeadlineSite, evidence) -> str | None:
        name = site.name
        if name in engine.SOCKET_OPS:
            if (
                fa.has_settimeout
                or fa.class_name in evidence
                or None in evidence
                and fa.class_name is None
            ):
                return None
            return (
                f"socket op '{name}()' reachable from daemon/worker code "
                "with no settimeout/timeout evidence in this class; set a "
                "finite timeout or annotate `# deadline:` with the bound"
            )
        if site.timeout == "finite":
            return None
        if name == "get":
            if site.pos_args > 0:
                return None  # dict.get(key[, default]) shape
            return (
                "queue get() with no timeout blocks forever; pass "
                "timeout= or poll with a cancel check"
            )
        if name in ("wait", "join", "result", "select"):
            if name == "wait" and self._is_cancel_receiver(site):
                return None  # waiting ON the cancel token IS the hook
            return (
                f"'{name}()' with no finite timeout is an un-cancellable "
                "wait; pass a timeout (and loop on a cancel check) or "
                "annotate `# deadline:` naming what bounds it"
            )
        if name == "acquire":
            path = site.receiver or site.receiver_name or ""
            if path and engine.is_lock_path(path):
                return (
                    "explicit lock acquire() without a timeout; use "
                    "`with` for scoped holds or pass timeout="
                )
            return None
        return None


@register
class EnvKnobChecker(Checker):
    """Every env knob the package reads must have a row in the
    README's configuration table: an undocumented knob is operator-
    facing behavior (capacity planning, data paths, feature gates)
    nobody can plan around. Promoted from the test-suite lint so it
    anchors violations at the offending read, file:line."""

    rule = "env-knob-documented"

    # standard platform variables the package honors but did not
    # invent — not operator knobs, no README row expected
    PLATFORM_ENV_VARS = frozenset({"XDG_CACHE_HOME"})

    def __init__(self) -> None:
        self._readme_cache: dict[str, str | None] = {}

    def _readme_for(self, path: str) -> str | None:
        """Contents of the nearest README.md walking up from the
        analyzed file; None when there is none (fixture trees)."""
        current = Path(path).resolve().parent
        for _ in range(6):
            key = str(current)
            if key in self._readme_cache:
                return self._readme_cache[key]
            candidate = current / "README.md"
            if candidate.is_file():
                text = candidate.read_text()
                self._readme_cache[key] = text
                return text
            if current.parent == current:
                break
            current = current.parent
        self._readme_cache[str(Path(path).resolve().parent)] = None
        return None

    def check(self, module: Module) -> list[Violation]:
        scan = _scan(module)
        if not scan.env_reads:
            return []
        readme = self._readme_for(module.path)
        if readme is None:
            return []
        out: list[Violation] = []
        seen: set[tuple[str, int]] = set()
        for read in scan.env_reads:
            if read.name in self.PLATFORM_ENV_VARS:
                continue
            if f"`{read.name}`" in readme:
                continue
            key = (read.name, read.line)
            if key in seen:
                continue
            seen.add(key)
            out.append(
                Violation(
                    self.rule,
                    module.path,
                    read.line,
                    f"env knob '{read.name}' is read here but has no "
                    f"`{read.name}` row in the README configuration table",
                )
            )
        return out
