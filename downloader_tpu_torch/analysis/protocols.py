"""Protocol vocabulary: one place where the static typestate rule and
the runtime ``ProtocolRecorder`` agree on what the lifecycles ARE.

A protocol is declared where it is defined, with a comment on the
defining method::

    def child(self) -> "CancelToken":  # protocol: cancel-token acquire
    def detach(self) -> None:          # protocol: cancel-token release

Options after the kind:

- ``bind=<param>`` — the obligation attaches to that argument at call
  sites instead of the result (acquire) / the receiver (release);
  e.g. the ledger charges and refunds by ``key``.
- ``conditional`` — the acquire only takes effect when the call
  returns truthy (``try_charge``); the checker refines the two
  branches of an ``if`` on the call.
- ``may-raise`` — a release that can itself fail
  (``complete_multipart``), so it keeps its exception edge in the CFG
  instead of being treated as cleanup that cannot throw.

``collect_table`` parses those annotations out of a module set into
the ``engine.ProtocolTable`` the checkers and CFG builder consume.
``RUNTIME_PROTOCOLS`` is the runtime half: where each protocol's
classes live so ``analysis.runtime.ProtocolRecorder`` can patch them.
``tests/test_torch_analysis.py`` asserts the two halves agree —
every runtime patch target carries the matching static annotation."""

from __future__ import annotations

import ast

from .core import Module
from .engine import ProtoMethod, ProtocolTable


def _param_index(func: ast.FunctionDef, param: str) -> int | None:
    """Call-site positional index of ``param`` (``self``/``cls``
    excluded — annotations sit on methods)."""
    names = [a.arg for a in func.args.posonlyargs + func.args.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    try:
        return names.index(param)
    except ValueError:
        return None


def _decls_for(module: Module, func: ast.FunctionDef):
    start = func.lineno
    end = func.body[0].lineno if func.body else start
    for line in range(start, end + 1):
        yield from module.protocol_lines.get(line, ())


def collect_table(modules: list[Module]) -> ProtocolTable:
    methods: list[ProtoMethod] = []
    for module in modules:
        if not module.protocol_lines:
            continue

        def visit(body: list[ast.stmt], class_name: str | None) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for name, kind, options in _decls_for(module, node):
                        bind = None
                        conditional = False
                        may_raise = False
                        for token in options.split():
                            if token.startswith("bind="):
                                bind = token[len("bind="):]
                            elif token == "conditional":
                                conditional = True
                            elif token == "may-raise":
                                may_raise = True
                        callsite = node.name
                        if node.name == "__init__" and class_name:
                            callsite = class_name
                        methods.append(
                            ProtoMethod(
                                protocol=name,
                                kind=kind,
                                method=node.name,
                                callsite=callsite,
                                bind=bind,
                                conditional=conditional,
                                may_raise=may_raise,
                                param_index=(
                                    _param_index(node, bind)
                                    if bind is not None
                                    else None
                                ),
                                decl=(module.path, node.lineno),
                            )
                        )
                    visit(node.body, class_name)
                elif isinstance(node, ast.ClassDef):
                    visit(node.body, node.name)

        visit(module.tree.body, None)
    return ProtocolTable(methods)


# -- runtime half -------------------------------------------------------------

# protocol -> where the live classes live and which methods the
# recorder patches. Each method entry names the class, the method, its
# kind, and how the obligation key is computed at call time:
#
# - ``"self"``   — the receiver is the obligation (Delivery settles
#   itself);
# - ``"result"`` — the call's return value is the obligation (a child
#   token, a watch, an upload id);
# - ``"arg:<p>"`` — the named parameter's value is the key (the
#   ledger's ``key``, ``unregister``'s ``watch``).
#
# ``conditional`` acquires count only on a truthy return
# (``try_charge``); ``skip_types`` names result types that carry no
# obligation (the disabled watchdog's shared no-op watch). The
# vocabulary test keeps every entry in lockstep with the
# ``# protocol:`` annotations above — the static rule and the recorder
# must never disagree about what the lifecycles are.
RUNTIME_PROTOCOLS: dict[str, dict] = {
    "delivery-settle": {
        "module": "downloader_tpu_torch.queue.delivery",
        "methods": [
            {"class": "Delivery", "name": "__init__", "kind": "acquire", "key": "self"},
            # every public release (ack/nack/error/shed, and the
            # coalesced ack_batch) funnels through _settle — one
            # patch point covers them all, first-settle-wins included
            {"class": "Delivery", "name": "_settle", "kind": "release", "key": "self"},
        ],
    },
    "ledger-charge": {
        "module": "downloader_tpu_torch.utils.admission",
        "methods": [
            {"class": "Ledger", "name": "charge", "kind": "acquire", "key": "arg:key"},
            {
                "class": "Ledger",
                "name": "try_charge",
                "kind": "acquire",
                "key": "arg:key",
                "conditional": True,
            },
            {"class": "Ledger", "name": "refund", "kind": "release", "key": "arg:key"},
        ],
    },
    "cancel-token": {
        "module": "downloader_tpu_torch.utils.cancel",
        "methods": [
            {"class": "CancelToken", "name": "child", "kind": "acquire", "key": "result"},
            {"class": "CancelToken", "name": "detach", "kind": "release", "key": "self"},
        ],
    },
    "watchdog-watch": {
        "module": "downloader_tpu_torch.utils.watchdog",
        "methods": [
            {
                "class": "Watchdog",
                "name": "job",
                "kind": "acquire",
                "key": "result",
                "skip_types": ("_NoopWatch",),
            },
            {
                "class": "Watchdog",
                "name": "loop",
                "kind": "acquire",
                "key": "result",
                "skip_types": ("_NoopWatch",),
            },
            {"class": "Watchdog", "name": "unregister", "kind": "release", "key": "arg:watch"},
        ],
    },
    "tracer-trace": {
        "module": "downloader_tpu_torch.utils.tracing",
        "methods": [
            {"class": "Tracer", "name": "open_job", "kind": "acquire", "key": "result"},
            {"class": "OpenTrace", "name": "complete", "kind": "release", "key": "self"},
        ],
    },
    "source-claim": {
        "module": "downloader_tpu_torch.fetch.segments",
        "methods": [
            # the span scheduler's claim lifecycle: every
            # claim handed to a worker must reach exactly one of the
            # three release gates — complete, abandon (a rescue twin
            # standing down), or release_failed (the failover path)
            {
                "class": "_FetchState",
                "name": "next_segment",
                "kind": "acquire",
                "key": "result",
                "conditional": True,
            },
            {
                "class": "_FetchState",
                "name": "complete",
                "kind": "release",
                "key": "arg:seg",
            },
            {
                "class": "_FetchState",
                "name": "abandon",
                "kind": "release",
                "key": "arg:seg",
            },
            {
                "class": "_FetchState",
                "name": "release_failed",
                "kind": "release",
                "key": "arg:seg",
            },
        ],
    },
    "alert-episode": {
        "module": "downloader_tpu_torch.utils.alerts",
        "methods": [
            # a firing alert is an open obligation: every
            # pending→firing transition must reach exactly one resolve
            # (_exit_firing), whether through the rule's own clear
            # streak or the engine's reset — a rule stuck "firing"
            # forever with its condition gone is the alerting analogue
            # of a leaked lock
            {
                "class": "AlertRule",
                "name": "_enter_firing",
                "kind": "acquire",
                "key": "result",
            },
            {
                "class": "AlertRule",
                "name": "_exit_firing",
                "kind": "release",
                "key": "self",
            },
        ],
    },
    "worker-lifecycle": {
        "module": "downloader_tpu_torch.daemon.fleet",
        "methods": [
            # the fleet's declared lifecycle (spawn -> ready ->
            # draining -> reaped): every spawned worker process must be
            # collected by exactly one reap — a supervisor path that
            # loses a handle leaks a zombie (and its federation source)
            {
                "class": "WorkerHandle",
                "name": "spawn",
                "kind": "acquire",
                "key": "result",
            },
            {
                "class": "WorkerHandle",
                "name": "reap",
                "kind": "release",
                "key": "self",
            },
        ],
    },
    "cache-lease": {
        "module": "downloader_tpu_torch.fetch.singleflight",
        "methods": [
            # the fleet data plane's cross-process election: every
            # leadership lease a process acquires (fresh or promoted
            # over a stale owner) must reach exactly one release — a
            # path that drops a lease strands every coalesced follower
            # until the TTL expires it
            {
                "class": "LeaseRegistry",
                "name": "acquire_lease",
                "kind": "acquire",
                "key": "result",
                "conditional": True,
            },
            {
                "class": "LeaseRegistry",
                "name": "release_lease",
                "kind": "release",
                "key": "arg:lease",
            },
        ],
    },
    "multipart-upload": {
        "module": "downloader_tpu_torch.store.s3",
        "methods": [
            {
                "class": "S3Client",
                "name": "initiate_multipart",
                "kind": "acquire",
                "key": "result",
            },
            {
                "class": "S3Client",
                "name": "complete_multipart",
                "kind": "release",
                "key": "arg:upload_id",
            },
            {
                "class": "S3Client",
                "name": "abort_multipart",
                "kind": "release",
                "key": "arg:upload_id",
            },
        ],
    },
}
