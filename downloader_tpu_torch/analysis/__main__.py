"""CLI: ``python -m downloader_tpu_torch.analysis [paths...] [--json]``.

With no paths, analyzes the installed ``downloader_tpu_torch`` package —
the same scope tier-1 enforces — so CI and pre-commit can run the
gate standalone, with an mtime-keyed scan cache making re-runs cheap
(``--no-cache`` forces the full scan, as CI does).
``--diff <git-ref>`` keeps the whole-program analysis (summaries need
every module in view) but reports only on files changed vs the ref
plus their reverse call-graph dependents — the fast pre-commit mode,
byte-for-byte identical to a full run on the files both report on.
``--emit-summary <path>`` writes the call graph + per-function effect
summary table as a JSON artifact beside the violation report.
``--list-suppressions`` inventories every ``analysis: ignore`` in
scope with its reason for review. Exit status: 0 clean, 1 violations,
2 usage error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .cache import ScanCache, default_cache_path
from .core import Analyzer, Module, iter_package_files


def _list_suppressions(files: list[Path], as_json: bool) -> int:
    entries = []
    for path in files:
        try:
            module = Module.load(path)
        except SyntaxError:
            continue
        for line, declared in sorted(module.suppressions.items()):
            for rule, reason in declared:
                entries.append(
                    {
                        "path": module.path,
                        "line": line,
                        "rule": rule,
                        "reason": reason,
                    }
                )
    if as_json:
        print(json.dumps({"suppressions": entries, "count": len(entries)}, indent=2))
    else:
        for entry in entries:
            print(
                f"{entry['path']}:{entry['line']}: ignore[{entry['rule']}] "
                f"{entry['reason'] or '(no reason!)'}"
            )
        print(f"\n{len(entries)} suppression(s)")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m downloader_tpu_torch.analysis",
        description="concurrency & resource-safety static analysis",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories to analyze (default: the package)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable output (one object, 'violations' list)",
    )
    parser.add_argument(
        "--no-cache",
        action="store_true",
        help="ignore the scan cache and re-analyze everything (CI mode)",
    )
    parser.add_argument(
        "--cache-file",
        default=None,
        help=f"scan cache location (default: {default_cache_path()})",
    )
    parser.add_argument(
        "--list-suppressions",
        action="store_true",
        help="list every `analysis: ignore` with file:line and reason, then exit",
    )
    parser.add_argument(
        "--diff",
        metavar="GIT_REF",
        default=None,
        help="report only on package files changed vs GIT_REF plus their "
        "reverse call-graph dependents (the analysis itself stays "
        "whole-program, so results match a full run on those files)",
    )
    parser.add_argument(
        "--emit-summary",
        metavar="PATH",
        default=None,
        help="also write the call graph + effect summary table as JSON",
    )
    args = parser.parse_args(argv)

    if args.list_suppressions:
        if args.paths:
            files: list[Path] = []
            for path in (Path(p) for p in args.paths):
                files.extend(sorted(path.rglob("*.py")) if path.is_dir() else [path])
        else:
            files = iter_package_files()
        return _list_suppressions(files, args.json)

    if args.paths and args.diff:
        parser.error("--diff analyzes the package; it takes no paths")
    if args.paths:
        from .core import analyze_paths

        violations = analyze_paths(args.paths)
        expanded: list[Path] = []
        for path in (Path(p) for p in args.paths):
            expanded.extend(
                sorted(path.rglob("*.py")) if path.is_dir() else [path]
            )
        _maybe_emit_summary(args.emit_summary, expanded)
    else:
        # whole-package mode: the full scope is in view, so stale
        # suppressions of cross-module rules are decidable too — and
        # the scan cache applies (its vocabulary fingerprint covers
        # this exact scope)
        files = iter_package_files()
        cache = None
        if not args.no_cache:
            cache = ScanCache(args.cache_file or default_cache_path())
            if args.diff is None and args.emit_summary is None:
                replayed = cache.replay(files)
                if replayed is not None:
                    return _emit(replayed, args.json, cached=True)
        report_paths = None
        if args.diff is not None:
            changed = _changed_vs(args.diff, files)
            if changed is None:
                print(
                    f"error: git diff against {args.diff!r} failed",
                    file=sys.stderr,
                )
                return 2
            report_paths = _with_reverse_dependents(changed)
        analyzer = Analyzer(full_scope=True)
        violations = analyzer.run(
            files, scan_cache=cache, report_paths=report_paths  # type: ignore[arg-type]
        )
        _maybe_emit_summary(args.emit_summary, files, analyzer=analyzer)
    return _emit(violations, args.json)


def _changed_vs(ref: str, files: list[Path]) -> set[str] | None:
    """Package files changed vs ``ref`` (absolute-path strings), or
    None when git cannot answer."""
    repo_root = Path(__file__).resolve().parent.parent.parent
    result = subprocess.run(
        ["git", "diff", "--name-only", ref, "--", "*.py"],
        cwd=repo_root,
        capture_output=True,
        text=True,
    )
    if result.returncode != 0:
        return None
    lines = result.stdout.splitlines()
    # untracked files never show in `git diff` but are exactly what a
    # pre-commit run must check — fold them in
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard", "--", "*.py"],
        cwd=repo_root,
        capture_output=True,
        text=True,
    )
    if untracked.returncode == 0:
        lines += untracked.stdout.splitlines()
    in_scope = {str(f) for f in files}
    return {
        str((repo_root / line.strip()).resolve())
        for line in lines
        if line.strip()
    } & in_scope


def _with_reverse_dependents(changed: set[str]):
    """A report filter folding in the transitive reverse call-graph
    dependents of the changed files — a summary change in a helper can
    surface a finding in any caller, however many hops up."""

    def fn(modules) -> set[str]:
        from . import summaries

        program = summaries.program_for(modules)
        targets = set(changed)
        work = [
            key
            for key in program.graph.functions
            if key[0] in changed
        ]
        seen = set(work)
        while work:
            key = work.pop()
            for caller in program.graph.reverse.get(key, ()):
                targets.add(caller[0])
                if caller not in seen:
                    seen.add(caller)
                    work.append(caller)
        return targets

    return fn


def _maybe_emit_summary(
    path: str | None, files: list[Path], analyzer: Analyzer | None = None
) -> None:
    """Write the call graph + summary artifact. With ``analyzer`` (the
    whole-package path) the run's memoized program is reused — the
    artifact costs one JSON dump, not a second scan."""
    if path is None:
        return
    from . import summaries

    modules = getattr(analyzer, "last_modules", None)
    if modules is None:
        from .checkers import ProtocolChecker, ResourceFinalizationChecker

        modules = []
        for file in files:
            try:
                modules.append(Module.load(file))
            except (SyntaxError, OSError):
                continue
        # pin the cross-module vocabulary exactly as an analysis run
        # would, so the artifact matches what the checkers consumed
        ProtocolChecker().prepare(modules)
        ResourceFinalizationChecker().prepare(modules)
    program = summaries.program_for(modules)
    Path(path).write_text(json.dumps(program.to_json(), indent=2))


def _emit(violations, as_json: bool, cached: bool = False) -> int:
    if as_json:
        print(
            json.dumps(
                {
                    "violations": [v.to_dict() for v in violations],
                    "count": len(violations),
                    "cached": cached,
                },
                indent=2,
            )
        )
    else:
        for violation in violations:
            print(violation)
        if violations:
            print(f"\n{len(violations)} violation(s)")
        else:
            print("ok: no violations" + (" (cached)" if cached else ""))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
