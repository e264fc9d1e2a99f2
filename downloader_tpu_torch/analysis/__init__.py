"""In-tree concurrency & resource-safety static analyzer.

Every recent regression class in this codebase — dangling multipart
uploads, leaked sockets on cancel, stale journal reuse, a worker
thread killed by an escaped exception, a settle hook skipped on one
exception arm — was a cross-thread or cross-path invariant no single
test enumerated. This package turns those invariants into
path-sensitive checkers (stdlib ``ast`` only, over a per-function CFG
with a generic dataflow solver — see ``engine``/``cfg``/``dataflow``)
that run over the whole ``downloader_tpu_torch`` package on every
tier-1 invocation (tests/test_torch_analysis.py) and standalone via
``python -m downloader_tpu_torch.analysis``.

Shipped rules (see README "Static analysis" for the operator-facing
catalog):

The engine is **interprocedural**: ``callgraph.py``
resolves a module-level call graph over the package, ``summaries.py``
computes per-function effect summaries bottom-up over its SCCs (locks
acquired/released/required, may-block witnesses, parameter ownership,
thread-role reachability), and the rules consume summaries at call
sites instead of going blind at every call boundary. ``schedules.py``
is the third half: seeded deterministic yields at the runtime
recorders' patch points, so tier-1 explores perturbed interleavings.

- ``guarded-by`` — attributes annotated ``# guarded-by: _lock`` may
  only be touched while that lock is held (per the CFG lock-state
  analysis, or in a function annotated ``# holds: _lock``); a
  ``# holds:`` contract is also enforced at every resolved ``self.``
  call site.
- ``no-blocking-under-lock`` — no sleeps, joins, socket I/O, or
  future/event waits while any lock is held — including transitively
  through any resolved call chain (the finding names the blocking
  site; a reasoned suppression at that leaf covers every caller).
- ``resource-finalization`` — sockets/files/tempfiles created in a
  function must reach close/unlink on EVERY CFG path, exception edges
  included, unless ownership escapes (callee summaries judge:
  lending to a pure borrower is not an escape).
- ``lock-order`` — the static lock-acquisition graph (nested ``with``
  blocks, ``# holds:`` annotations, and caller-held ->
  callee-acquired summary edges) must be cycle-free; the runtime
  ``LockOrderRecorder`` covers the dynamic residue.
- ``lock-balance`` — explicit ``.acquire()`` calls balance: released
  on every path, and a helper that deliberately returns holding must
  have every ``self.`` caller release what it was handed.
- ``exception-hygiene`` — no bare ``except:``, no silent broad
  ``except Exception: pass``, and ``threading.Thread`` targets must
  not let exceptions escape (they kill the worker silently).
- ``protocol`` — lifecycle typestate: every acquisition of a declared
  protocol (``# protocol: <name> acquire`` / ``release`` on the
  defining methods; ten seeded — delivery-settle, ledger-charge,
  cancel-token, watchdog-watch, tracer-trace, source-claim,
  alert-episode, worker-lifecycle, cache-lease, multipart-upload)
  must reach a release on every path or provably escape ownership;
  proven double releases are violations too. The runtime
  ``ProtocolRecorder`` is the dynamic half.
- ``blocking-deadline`` — every blocking call reachable (through the
  resolved call graph) from daemon/worker code must carry a finite
  timeout, a cancel hook, or a reasoned ``# deadline:`` annotation
  naming what bounds the wait.
- ``thread-role-race`` — threads get roles via ``# thread-role:`` at
  spawn sites; a field touched by two or more roles, written by at
  least one, with no common guarding lock and no
  ``# shared-by-design: <reason>`` declaration, is reported at the
  racing store (races.py).
- ``env-knob-documented`` — every env knob read by the package has a
  row in the README configuration table.

Suppression syntax, inline on the offending line::

    something_flagged()  # analysis: ignore[rule-id] why it is safe

A suppression without a written reason is itself a violation
(``suppression``), and so is a stale one that matches no finding:
the reason IS the review artifact.
"""

from .core import (  # noqa: F401
    Analyzer,
    Module,
    Violation,
    all_checkers,
    analyze_paths,
    iter_package_files,
)
from . import checkers as _checkers  # noqa: F401  (registers the rule set)
from . import races as _races  # noqa: F401  (registers thread-role-race)
