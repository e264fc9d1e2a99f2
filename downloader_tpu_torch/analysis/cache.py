"""mtime-keyed scan cache for the analyzer CLI.

The expensive part of a run is ``engine.scan_module`` — per-function
CFG construction and two dataflow fixpoints. Those facts are
deterministic given the file's bytes and the cross-module vocabulary
(the protocol table, the resource-factory set, and the analysis
package's own sources), so the cache stores each file's serialized
scan keyed by ``(mtime_ns, size)`` plus one vocabulary fingerprint for
the whole tree. A cached run loads and tokenizes every module as
usual — suppressions, annotations, and every checker run live, so
results are byte-identical to an uncached run — but unchanged files
adopt their stored scan instead of rebuilding CFGs.

Two tiers:

- nothing changed at all → ``replay`` returns the stored violation
  list without even parsing (the no-op ``make analyze`` path);
- some files changed → parse everything, re-scan only the changed
  files, refresh the cache.

Soundness: scan facts are purely per-module once the vocabulary is
pinned. The fingerprint covers every ``# protocol:`` /
``# resource-factory`` declaration in the tree and the analyzer's own
source signatures, so a vocabulary or engine change discards the
cache wholesale. Cross-module *judgments* (deadline reachability, the
lock-order graph, suppression staleness) are recomputed live on every
run from the adopted facts — they are never cached.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from pathlib import Path

from . import engine
from .core import Module, Violation

CACHE_VERSION = 3  # v3: call sites, spawn roles, lock balance, shared decls


def _sig(path: str) -> list[int] | None:
    try:
        stat = os.stat(path)
    except OSError:
        return None
    return [stat.st_mtime_ns, stat.st_size]


def _readme_sigs(files: list) -> dict[str, list[int] | None]:
    """Signature of the nearest README.md above each analyzed file's
    directory (mirroring the env-knob rule's lookup) — the one
    non-Python input a replayed verdict depends on. A missing README
    records None, so one appearing later also invalidates."""
    out: dict[str, list[int] | None] = {}
    for directory in {Path(f).resolve().parent for f in files}:
        current = directory
        for _ in range(6):
            candidate = current / "README.md"
            key = str(candidate)
            sig = _sig(key) if candidate.is_file() else None
            out.setdefault(key, sig)
            if sig is not None or current.parent == current:
                break
            current = current.parent
    return out


def _vocab_fingerprint(modules: list[Module]) -> str:
    """Hash of everything that lets one file's bytes produce different
    scan facts: protocol/factory annotations anywhere in the tree, and
    the analysis package's own sources (engine changes change facts)."""
    digest = hashlib.sha256()
    for module in sorted(modules, key=lambda m: m.path):
        if module.protocol_lines or module.factory_lines:
            # any edit to a declaring file invalidates wholesale: the
            # annotation text alone would miss a signature change that
            # shifts a bind= parameter's call-site position
            digest.update(module.path.encode())
            digest.update(repr(_sig(module.path)).encode())
    own = Path(__file__).resolve().parent
    for source in sorted(own.glob("*.py")):
        digest.update(source.name.encode())
        digest.update(repr(_sig(str(source))).encode())
    return digest.hexdigest()


# -- scan (de)serialization ---------------------------------------------------


def _dump_scan(scan: engine.ModuleScan) -> dict:
    functions = []
    for fa in scan.functions:
        functions.append(
            {
                "name": fa.node.name,
                "class_name": fa.class_name,
                "lineno": fa.node.lineno,
                "accesses": [
                    [a.attr, a.line, list(a.held), a.is_store]
                    for a in fa.accesses
                ],
                "acquires": [
                    [q.path, q.line, list(q.held)] for q in fa.acquires
                ],
                "blocking": [
                    [b.name, b.line, list(b.held)] for b in fa.blocking
                ],
                "deadline_sites": [
                    [
                        s.name,
                        s.line,
                        s.receiver,
                        s.receiver_name,
                        s.pos_args,
                        s.timeout,
                        s.is_with_item,
                    ]
                    for s in fa.deadline_sites
                ],
                "leaks": [
                    [
                        k.protocol,
                        k.var,
                        k.line,
                        k.on_exception,
                        k.on_normal,
                        k.never_released,
                        list(k.release_names),
                    ]
                    for k in fa.leaks
                ],
                "double_releases": [
                    [d.protocol, d.var, d.line, d.acquire_line]
                    for d in fa.double_releases
                ],
                "thread_spawns": [
                    [t.line, t.target_name, t.kind, t.role, t.via]
                    for t in fa.thread_spawns
                ],
                "call_sites": [
                    [
                        c.name,
                        c.line,
                        list(c.held),
                        c.kind,
                        c.recv,
                        list(c.pos_names),
                        [list(pair) for pair in c.kw_names],
                    ]
                    for c in fa.call_sites
                ],
                "borrow_escapes": [
                    [
                        b.protocol,
                        b.var,
                        b.line,
                        list(b.release_names),
                        [list(p) for p in b.passes],
                    ]
                    for b in fa.borrow_escapes
                ],
                "calls": sorted(fa.calls),
                "has_settimeout": fa.has_settimeout,
                "has_timeout_kwarg": fa.has_timeout_kwarg,
                "exit_held": list(fa.exit_held),
                "lock_releases": list(fa.lock_releases),
                "lock_imbalances": [list(i) for i in fa.lock_imbalances],
            }
        )
    return {
        "functions": functions,
        "guards": [
            [g.attr, g.lock, g.line, g.class_name] for g in scan.guards
        ],
        "shared": [
            [s.attr, s.reason, s.line, s.class_name] for s in scan.shared
        ],
        "env_reads": [[e.name, e.line] for e in scan.env_reads],
    }


def _load_scan(module: Module, data: dict) -> engine.ModuleScan | None:
    """Rebuild a ModuleScan from its serialized facts, re-binding each
    function record to the freshly parsed AST (the file is unchanged,
    so def line numbers still match); None when a record cannot be
    re-anchored (treat as a cache miss and re-scan)."""
    defs_by_line: dict[int, ast.FunctionDef] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_line.setdefault(node.lineno, node)
    scan = engine.ModuleScan(module)
    for record in data["functions"]:
        node = defs_by_line.get(record["lineno"])
        if node is None or node.name != record["name"]:
            return None
        cls = record["class_name"]
        fa = engine.FunctionAnalysis(node, cls)
        fa.accesses = [
            engine.AttrAccess(attr, line, tuple(held), node.name, cls, store)
            for attr, line, held, store in record["accesses"]
        ]
        fa.acquires = [
            engine.LockAcquire(path, line, tuple(held), node.name, cls)
            for path, line, held in record["acquires"]
        ]
        fa.blocking = [
            engine.BlockingCall(name, line, tuple(held))
            for name, line, held in record["blocking"]
        ]
        fa.deadline_sites = [
            engine.DeadlineSite(name, line, recv, recv_name, pos, timeout, wi)
            for name, line, recv, recv_name, pos, timeout, wi in record[
                "deadline_sites"
            ]
        ]
        fa.leaks = [
            engine.ObligationLeak(
                proto, var, line, on_exc, on_norm, never, tuple(names)
            )
            for proto, var, line, on_exc, on_norm, never, names in record[
                "leaks"
            ]
        ]
        fa.double_releases = [
            engine.DoubleRelease(proto, var, line, acq)
            for proto, var, line, acq in record["double_releases"]
        ]
        fa.thread_spawns = [
            engine.ThreadSpawn(line, target, kind, cls, role, via)
            for line, target, kind, role, via in record["thread_spawns"]
        ]
        fa.call_sites = [
            engine.CallSite(
                name,
                line,
                tuple(held),
                kind,
                recv,
                tuple(pos),
                tuple(tuple(pair) for pair in kws),
            )
            for name, line, held, kind, recv, pos, kws in record["call_sites"]
        ]
        fa.borrow_escapes = [
            engine.BorrowEscape(
                proto, var, line, tuple(names), tuple(tuple(p) for p in passes)
            )
            for proto, var, line, names, passes in record["borrow_escapes"]
        ]
        fa.calls = set(record["calls"])
        fa.has_settimeout = record["has_settimeout"]
        fa.has_timeout_kwarg = record["has_timeout_kwarg"]
        fa.exit_held = tuple(record["exit_held"])
        fa.lock_releases = tuple(record["lock_releases"])
        fa.lock_imbalances = tuple(
            tuple(i) for i in record["lock_imbalances"]
        )
        scan.functions.append(fa)
        scan.methods.setdefault((cls, node.name), fa)
    scan.guards = [
        engine.GuardDecl(attr, lock, line, cls)
        for attr, lock, line, cls in data["guards"]
    ]
    scan.shared = [
        engine.SharedDecl(attr, reason, line, cls)
        for attr, reason, line, cls in data["shared"]
    ]
    scan.env_reads = [
        engine.EnvRead(name, line) for name, line in data["env_reads"]
    ]
    return scan


# -- the cache ----------------------------------------------------------------


class ScanCache:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._data: dict = {"version": CACHE_VERSION, "files": {}}
        self.adopted = 0  # files that skipped a re-scan (observability)
        try:
            loaded = json.loads(self.path.read_text())
            if loaded.get("version") == CACHE_VERSION:
                self._data = loaded
        except (OSError, ValueError):
            pass

    # -- tier 1: nothing changed at all -------------------------------

    def replay(self, files: list[Path]) -> list[Violation] | None:
        """The stored violation list, when the file set and every
        signature match exactly — no parsing at all. None otherwise."""
        cached = self._data.get("files", {})
        if "violations" not in self._data:
            return None
        paths = [str(f) for f in files]
        if set(paths) != set(cached):
            return None
        for path in paths:
            if _sig(path) != cached[path].get("sig"):
                return None
        # the env-knob rule's verdict also rides on README.md contents
        if _readme_sigs(files) != self._data.get("readmes"):
            return None
        return [
            Violation(v["rule"], v["path"], v["line"], v["message"])
            for v in self._data["violations"]
        ]

    # -- tier 2: adopt unchanged scans ---------------------------------

    def adopt(self, modules: list[Module]) -> None:
        """Attach cached scans to every unchanged module (the ``_scan``
        memo the checkers share), so only changed files pay for CFG
        construction. A vocabulary-fingerprint mismatch discards the
        whole cache."""
        if self._data.get("vocab") != _vocab_fingerprint(modules):
            self._data = {"version": CACHE_VERSION, "files": {}}
            return
        cached = self._data.get("files", {})
        for module in modules:
            entry = cached.get(module.path)
            if entry is None or _sig(module.path) != entry.get("sig"):
                continue
            scan = _load_scan(module, entry["scan"])
            if scan is not None:
                module._engine_scan = scan  # type: ignore[attr-defined]
                self.adopted += 1

    def update(
        self,
        modules: list[Module],
        violations: list[Violation],
        replayable: bool = True,
    ) -> None:
        """Refresh the cache from a completed run (every module carries
        a scan by then — the interprocedural program build sees to it).
        ``replayable=False`` (a ``--diff`` run, whose report is
        filtered) refreshes the per-file scans but withholds the
        replay tier, so a later full run can never adopt a truncated
        violation list — that is what keeps diff and full runs
        byte-for-byte identical on shared files."""
        files = {}
        for module in modules:
            scan = getattr(module, "_engine_scan", None)
            sig = _sig(module.path)
            if scan is None or sig is None:
                continue
            files[module.path] = {"sig": sig, "scan": _dump_scan(scan)}
        old = self._data
        self._data = {
            "version": CACHE_VERSION,
            "vocab": _vocab_fingerprint(modules),
            "files": files,
            "readmes": _readme_sigs([m.path for m in modules]),
        }
        if replayable:
            self._data["violations"] = [v.to_dict() for v in violations]
        elif (
            old.get("violations") is not None
            and old.get("vocab") == self._data["vocab"]
            and old.get("readmes") == self._data["readmes"]
            and {
                path: entry.get("sig")
                for path, entry in old.get("files", {}).items()
            }
            == {path: entry["sig"] for path, entry in files.items()}
        ):
            # a --diff run on an otherwise-unchanged tree must not
            # destroy the replay tier a prior full run built: the old
            # verdict still describes these exact bytes, so carry it
            self._data["violations"] = old["violations"]
        try:
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._data))
            tmp.replace(self.path)
        except OSError:
            pass  # a cache that cannot persist is just a slow cache


def default_cache_path() -> Path:
    """Next to the package checkout (the repo root in development),
    under a name of this package's own: a checkout that also holds
    ``downloader_tpu`` keeps that analyzer's ``.analysis-cache.json``
    beside it, and neither may replay the other's verdicts."""
    return (
        Path(__file__).resolve().parent.parent.parent
        / ".analysis-cache-torch.json"
    )
