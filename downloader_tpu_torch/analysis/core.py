"""Analyzer plumbing: parsed-module model, comment side-tables,
checker registry, suppression handling.

Checkers never read files themselves — they get a ``Module`` carrying
the AST plus the comment-derived side tables (``ast`` drops comments,
so annotations and suppressions come from ``tokenize``). Cross-module
rules (the lock-order graph) accumulate state during ``check`` and
emit in ``finalize``.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path

# one comment can carry one suppression; the reason is REQUIRED — an
# empty reason is reported as a `suppression` violation
_SUPPRESS_RE = re.compile(r"analysis:\s*ignore\[([a-z0-9-]+)\]\s*(.*)")
_GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_][\w.]*)")
_HOLDS_RE = re.compile(r"holds:\s*([A-Za-z_][\w.]*(?:\s*,\s*[A-Za-z_][\w.]*)*)")
_FACTORY_RE = re.compile(r"resource-factory\b")
# `# protocol: <name> acquire|release [bind=<param>] [conditional]
# [may-raise]` on a def line declares that method part of a lifecycle
# protocol (see checkers.ProtocolChecker); anchored at the comment
# start so prose mentioning the word "protocol:" cannot declare one
_PROTOCOL_RE = re.compile(
    r"^protocol:\s*([a-z0-9-]+)\s+(acquire|release)\b\s*(.*)$"
)
# `# deadline: <reason>` on a blocking call (or its def) documents how
# the wait is bounded — a cancel hook, a socket timeout set at
# creation, a supervisor. The reason is REQUIRED, like suppressions.
_DEADLINE_RE = re.compile(r"^deadline:\s*(.*)$")
# `# thread-role: <name>` on a threading.Thread(...) spawn site names
# the role of the spawned thread for the thread-role race rule
# (analysis/races.py); functions reachable from the spawn target run
# under that role.
_ROLE_RE = re.compile(r"^thread-role:\s*([A-Za-z0-9_-]+)\s*$")
# `# shared-by-design: <reason>` on a field's initialization declares
# that multi-role access without a common lock is intentional (GIL-
# atomic ops, monotonic flags, torn-read-tolerant diagnostics). The
# reason is REQUIRED, like suppressions.
_SHARED_RE = re.compile(r"^shared-by-design:\s*(.*)$")

SUPPRESSION_RULE = "suppression"


class Violation:
    """One finding: rule id + location + message."""

    __slots__ = ("rule", "path", "line", "message")

    def __init__(self, rule: str, path: str, line: int, message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def __repr__(self) -> str:
        return f"Violation({self!s})"


class Module:
    """One parsed source file + its comment side-tables."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        # line -> comment text (sans '#'), from tokenize: ast drops them
        self.comments: dict[int, str] = {}
        # line -> (rule, reason) suppressions declared on that line; a
        # suppression on a standalone comment line also covers the
        # following line (the noqa-above style for long statements)
        self.suppressions: dict[int, list[tuple[str, str]]] = {}
        self._standalone_suppression_lines: set[int] = set()
        # line -> lock path from a `# guarded-by: <lock>` annotation
        self.guarded_lines: dict[int, str] = {}
        # line -> lock paths from a `# holds: <lock>[, <lock>]` annotation
        self.holds_lines: dict[int, tuple[str, ...]] = {}
        # lines carrying `# resource-factory` (on a def: its calls are
        # treated as resource creations by the finalization checker)
        self.factory_lines: set[int] = set()
        # line -> (protocol, kind, options) protocol declarations
        self.protocol_lines: dict[int, list[tuple[str, str, str]]] = {}
        # line -> reason from a `# deadline:` annotation; a standalone
        # comment line also covers the following line, like suppressions
        self.deadline_lines: dict[int, str] = {}
        self._standalone_deadline_lines: set[int] = set()
        # line -> role name from a `# thread-role:` spawn annotation;
        # a standalone comment line also covers the following line
        self.role_lines: dict[int, str] = {}
        self._standalone_role_lines: set[int] = set()
        # line -> reason from a `# shared-by-design:` field annotation
        self.shared_lines: dict[int, str] = {}
        self._scan_comments()

    @classmethod
    def load(cls, path: str | Path) -> "Module":
        path = Path(path)
        return cls(str(path), path.read_text())

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                text = tok.string.lstrip("#").strip()
                self.comments[line] = text
                match = _SUPPRESS_RE.search(text)
                if match:
                    self.suppressions.setdefault(line, []).append(
                        (match.group(1), match.group(2).strip())
                    )
                    if tok.line[: tok.start[1]].strip() == "":
                        self._standalone_suppression_lines.add(line)
                match = _GUARDED_RE.search(text)
                if match:
                    self.guarded_lines[line] = match.group(1)
                match = _HOLDS_RE.search(text)
                if match:
                    self.holds_lines[line] = tuple(
                        part.strip() for part in match.group(1).split(",")
                    )
                if _FACTORY_RE.search(text):
                    self.factory_lines.add(line)
                match = _PROTOCOL_RE.match(text)
                if match:
                    self.protocol_lines.setdefault(line, []).append(
                        (match.group(1), match.group(2), match.group(3))
                    )
                match = _DEADLINE_RE.match(text)
                if match:
                    self.deadline_lines[line] = match.group(1).strip()
                    if tok.line[: tok.start[1]].strip() == "":
                        self._standalone_deadline_lines.add(line)
                match = _ROLE_RE.match(text)
                if match:
                    self.role_lines[line] = match.group(1)
                    if tok.line[: tok.start[1]].strip() == "":
                        self._standalone_role_lines.add(line)
                match = _SHARED_RE.match(text)
                if match:
                    self.shared_lines[line] = match.group(1).strip()
        except (tokenize.TokenError, IndentationError):
            pass  # ast.parse already succeeded; treat as comment-free

    def deadline_reason(self, line: int) -> str | None:
        """The `# deadline:` reason covering ``line``: on the line
        itself, or on a standalone comment line directly above it."""
        reason = self.deadline_lines.get(line)
        if reason:
            return reason
        if line - 1 in self._standalone_deadline_lines:
            return self.deadline_lines.get(line - 1) or None
        return None

    def role_for(self, start: int, end: int) -> str | None:
        """The `# thread-role:` name covering a spawn statement that
        spans ``start``..``end``: on any of those lines, or on a
        standalone comment line directly above."""
        for line in range(start, end + 1):
            role = self.role_lines.get(line)
            if role:
                return role
        if start - 1 in self._standalone_role_lines:
            return self.role_lines.get(start - 1)
        return None

    def holds_for(self, func: ast.AST) -> tuple[str, ...]:
        """Lock paths a `# holds:` annotation declares on the def line
        (or its decorator lines) of ``func``."""
        start = getattr(func, "lineno", 0)
        end = func.body[0].lineno if getattr(func, "body", None) else start
        held: list[str] = []
        for line in range(start, end + 1):
            held.extend(self.holds_lines.get(line, ()))
        return tuple(held)

    def match_suppression(self, rule: str, line: int) -> int | None:
        """The comment line of the suppression covering (rule, line),
        or None. Callers use the returned line to mark the suppression
        as used — an ignore that never matches anything is stale."""
        if any(r == rule for r, _ in self.suppressions.get(line, ())):
            return line
        # a standalone `# analysis: ignore[...]` comment line covers
        # the statement line right below it
        if line - 1 in self._standalone_suppression_lines and any(
            r == rule for r, _ in self.suppressions.get(line - 1, ())
        ):
            return line - 1
        return None

    def suppressed(self, rule: str, line: int) -> bool:
        return self.match_suppression(rule, line) is not None


def find_cycles(graph: dict[str, list[str]]) -> list[tuple[str, str, list[str]]]:
    """Distinct cycles in a directed graph (iterative coloring DFS).
    Each result is ``(edge_src, edge_dst, cycle)`` where ``cycle`` is
    the node path closing on its first element and the edge is the
    back-edge that closed it. Shared by the static lock-order checker
    and the runtime recorder so the two halves of the rule cannot
    diverge on the subtle parts (path slicing, rotated-cycle dedup)."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    out: list[tuple[str, str, list[str]]] = []
    reported: set[tuple] = set()

    def visit(start: str) -> None:
        stack: list[tuple[str, list[str]]] = [
            (start, list(graph.get(start, ())))
        ]
        path = [start]
        color[start] = GRAY
        while stack:
            node, todo = stack[-1]
            if not todo:
                color[node] = BLACK
                stack.pop()
                path.pop()
                continue
            nxt = todo.pop()
            state = color.get(nxt, WHITE)
            if state == GRAY:
                cycle = path[path.index(nxt):] + [nxt]
                # dedup on the canonical ROTATION of the node sequence,
                # not the node set: A->B->C->A and A->C->B->A are two
                # distinct deadlocks over the same three locks and both
                # must be reported, or fixing one re-fails on the other
                nodes = cycle[:-1]
                pivot = nodes.index(min(nodes))
                key = tuple(nodes[pivot:] + nodes[:pivot])
                if key not in reported:
                    reported.add(key)
                    out.append((node, nxt, cycle))
            elif state == WHITE:
                color[nxt] = GRAY
                path.append(nxt)
                stack.append((nxt, list(graph.get(nxt, ()))))

    for node in list(graph):
        if color.get(node, WHITE) == WHITE:
            visit(node)
    return out


class Checker:
    """Base checker: subclasses set ``rule`` and implement ``check``;
    cross-module rules also implement ``finalize`` and set
    ``cross_module`` so suppression-staleness is only judged when the
    whole scope is in view."""

    rule = ""
    # True when a finding (and therefore the liveness of a suppression)
    # can depend on OTHER modules: analyzing one file alone then cannot
    # prove a suppression stale
    cross_module = False

    def prepare(self, modules: list[Module]) -> None:
        """Optional pre-pass over every module (e.g. to index
        annotated resource factories) before any ``check`` call."""

    def check(self, module: Module) -> list[Violation]:
        raise NotImplementedError

    def finalize(self) -> list[Violation]:
        return []


_REGISTRY: list[type[Checker]] = []


def register(cls: type[Checker]) -> type[Checker]:
    _REGISTRY.append(cls)
    return cls


def all_checkers() -> list[type[Checker]]:
    return list(_REGISTRY)


def iter_package_files(root: str | Path | None = None) -> list[Path]:
    """Every .py file of the installed ``downloader_tpu_torch`` package (the
    default analysis target), sorted for stable output."""
    if root is None:
        root = Path(__file__).resolve().parent.parent
    return sorted(Path(root).rglob("*.py"))


class Analyzer:
    def __init__(
        self,
        checkers: list[type[Checker]] | None = None,
        full_scope: bool = False,
    ):
        self._checkers = [cls() for cls in (checkers or all_checkers())]
        # whether the paths handed to run() cover everything the
        # cross-module rules would ever see (the package gate / a
        # directory run). A partial scope (one file in pre-commit)
        # cannot prove a cross-module suppression stale — the finding
        # it silences may need a module that is not being analyzed.
        self._full_scope = full_scope

    def run(
        self,
        paths: list[str | Path],
        scan_cache=None,
        report_paths: set[str] | None = None,
    ) -> list[Violation]:
        """Analyze ``paths``; returns unsuppressed violations, plus a
        ``suppression`` violation per reasonless ignore and per stale
        ignore (one that matched no finding — judged for cross-module
        rules only under ``full_scope``), sorted by location.

        ``scan_cache`` (a ``cache.ScanCache``) lets unchanged files
        adopt their stored engine scans instead of rebuilding CFGs;
        every checker still runs live, so results are identical.

        ``report_paths`` (the ``--diff`` mode) restricts the REPORT to
        those files while the analysis itself still runs over all of
        ``paths`` — interprocedural judgments (summaries, reachability,
        the lock-order graph) need the whole scope in view, which is
        what makes a diff run agree byte-for-byte with a full run on
        the files both report on. It may be a callable
        ``(modules) -> set[str]`` evaluated after the checks, so the
        caller can fold in reverse call-graph dependents."""
        modules: list[Module] = []
        violations: list[Violation] = []
        for path in paths:
            try:
                modules.append(Module.load(path))
            except SyntaxError as exc:
                violations.append(
                    Violation(
                        "syntax-error", str(path), exc.lineno or 0, exc.msg or ""
                    )
                )
        if scan_cache is not None:
            scan_cache.adopt(modules)
        # exposed so the CLI can emit the call-graph/summary artifact
        # from this run's memoized program instead of re-deriving it
        self.last_modules = modules
        for checker in self._checkers:
            checker.prepare(modules)
        by_path = {m.path: m for m in modules}
        for module in modules:
            for checker in self._checkers:
                violations.extend(checker.check(module))
        for checker in self._checkers:
            violations.extend(checker.finalize())
        if callable(report_paths):
            report_paths = report_paths(modules)

        kept: list[Violation] = []
        used: set[tuple[str, int, str]] = set()
        for violation in violations:
            module = by_path.get(violation.path)
            if module is not None:
                matched = module.match_suppression(
                    violation.rule, violation.line
                )
                if matched is not None:
                    used.add((module.path, matched, violation.rule))
                    continue
            kept.append(violation)
        # two ways a suppression is itself a violation, neither
        # suppressible: an empty reason defeats the point of the syntax
        # (the reason IS the review artifact), and an ignore that
        # matched no finding is stale — the code it excused is gone,
        # and it would silently mask the next real finding on its line.
        # Staleness of a CROSS-MODULE rule's suppression is only
        # decidable with the whole scope in view; per-file runs skip it
        cross_module_rules = {
            c.rule for c in self._checkers if c.cross_module
        }
        for module in modules:
            if report_paths is not None and module.path not in report_paths:
                continue
            for line, entries in sorted(module.suppressions.items()):
                for rule, reason in entries:
                    if not reason:
                        kept.append(
                            Violation(
                                SUPPRESSION_RULE,
                                module.path,
                                line,
                                f"ignore[{rule}] carries no reason; write "
                                "down why the finding is safe",
                            )
                        )
                    elif (
                        rule in cross_module_rules and not self._full_scope
                    ):
                        continue
                    elif (module.path, line, rule) not in used:
                        kept.append(
                            Violation(
                                SUPPRESSION_RULE,
                                module.path,
                                line,
                                f"ignore[{rule}] matched no finding; "
                                "stale suppression — remove it",
                            )
                        )
        kept.sort(key=lambda v: (v.path, v.line, v.rule))
        if scan_cache is not None:
            # a filtered (--diff) report must never land in the replay
            # tier: a later full run would adopt the truncated list
            scan_cache.update(modules, kept, replayable=report_paths is None)
        if report_paths is not None:
            # rules whose violations anchor wherever the whole-program
            # judgment lands (a lock-order cycle at an old edge, a race
            # at a store in an unchanged module) are never filtered: a
            # diff run that hid them would pass pre-commit and fail CI
            global_rules = {
                c.rule
                for c in self._checkers
                if getattr(c, "global_anchor", False)
            }
            kept = [
                v
                for v in kept
                if v.path in report_paths or v.rule in global_rules
            ]
        return kept


def analyze_paths(paths: list[str | Path]) -> list[Violation]:
    """Analyze files and directories with the full registered rule set.
    A directory argument is treated as a full scope (its whole subtree
    is in view, so cross-module suppression staleness is decidable);
    bare-file arguments are a partial scope."""
    files: list[Path] = []
    full_scope = False
    for path in paths:
        path = Path(path)
        if path.is_dir():
            full_scope = True
            files.extend(sorted(path.rglob("*.py")))
        else:
            files.append(path)
    return Analyzer(full_scope=full_scope).run(files)  # type: ignore[arg-type]
