"""The thread-role race rule: the static half of a race detector.

Threads get *roles* at their spawn sites — a ``# thread-role: <name>``
comment on the ``threading.Thread(...)`` line names the role, and
every function reachable from the spawn target (through the resolved
call graph) runs under it. The rule then looks at every ``self.*``
field: if functions of **two or more distinct roles** touch the same
field, at least one of them writes it, and there is **no lock held in
common** across all those accesses, the field is a data race waiting
for an interleaving — reported at the first racing write.

Two ways out, both explicit:

- guard the field (``# guarded-by:`` + ``with self._lock:`` — the
  guarded-by rule then enforces what this rule assumed), or
- declare the sharing intentional on the field's initialization::

      self._beat = 0.0  # shared-by-design: monotonic float, torn reads self-heal next tick

  The reason is REQUIRED — a reasonless declaration is itself a
  violation, exactly like suppressions.

Lock-named fields are exempt (lock objects exist to be shared), and
``__init__`` stores are exempt (no other thread holds a reference
during construction). Accesses in functions no annotated role reaches
contribute nothing: like every rule here, unresolved reach is a false
negative, not noise — the schedule-perturbation harness
(``analysis/schedules.py``) shakes the residue at runtime.
"""

from __future__ import annotations

from . import engine, summaries
from .core import Checker, Module, Violation, register


@register
class ThreadRoleRaceChecker(Checker):
    rule = "thread-role-race"
    cross_module = True  # roles flood across modules via the call graph
    # a race introduced by a changed file anchors at the racing STORE,
    # which can live in an unchanged module — --diff must not filter it
    global_anchor = True

    def __init__(self) -> None:
        self._modules: list[Module] = []

    def prepare(self, modules: list[Module]) -> None:
        self._modules = modules

    def check(self, module: Module) -> list[Violation]:
        return []  # all judgment needs the whole program: see finalize

    def finalize(self) -> list[Violation]:
        program = summaries.program_for(self._modules)
        # (module_path, class, field) -> role -> [(is_store, held, line, func)]
        fields: dict[tuple, dict[str, list]] = {}
        for key, fa in program.graph.functions.items():
            roles = program.roles.get(key)
            if not roles or fa.class_name is None:
                continue
            if fa.node.name == "__init__":
                continue  # construction precedes sharing
            for access in fa.accesses:
                leaf = access.attr.rsplit(".", 1)[-1]
                if engine.is_lock_path(leaf) or engine.is_lock_path(
                    access.attr.split(".")[0]
                ):
                    continue  # lock objects exist to be shared
                slot = fields.setdefault(
                    (key[0], fa.class_name, access.attr), {}
                )
                for role in roles:
                    slot.setdefault(role, []).append(
                        (
                            access.is_store,
                            frozenset(access.held),
                            access.line,
                            fa.node.name,
                        )
                    )

        shared_decls: dict[tuple, tuple[str, int]] = {}
        for path, module in program.modules.items():
            scan = program.scans[module.path]
            for decl in scan.shared:
                shared_decls[(path, decl.class_name, decl.attr)] = (
                    decl.reason,
                    decl.line,
                )

        out: list[Violation] = []
        # a reasonless declaration is a violation REGARDLESS of whether
        # the field currently races — the reason is the review
        # artifact, exactly like suppressions
        for (path, cls, attr), (reason, decl_line) in sorted(
            shared_decls.items()
        ):
            if not reason:
                out.append(
                    Violation(
                        self.rule,
                        path,
                        decl_line,
                        f"'self.{attr}' is declared shared-by-design "
                        "with no reason; write down why lock-free "
                        "sharing is safe",
                    )
                )
        for (path, cls, attr), by_role in sorted(fields.items()):
            if len(by_role) < 2:
                continue
            stores = [
                (line, func, role)
                for role, accesses in by_role.items()
                for is_store, _, line, func in accesses
                if is_store
            ]
            if not stores:
                continue  # concurrent reads of init-time state are fine
            held_sets = [
                held
                for accesses in by_role.values()
                for _, held, _, _ in accesses
            ]
            common = frozenset.intersection(*held_sets) if held_sets else frozenset()
            if common:
                continue  # one lock covers every touching role
            if (path, cls, attr.split(".")[0]) in shared_decls:
                # declared (the reasonless case was flagged above;
                # like suppressions, the underlying finding does not
                # ALSO fire — the gate fails on the missing reason)
                continue
            line, func, store_role = min(stores)
            others = sorted(set(by_role) - {store_role}) or sorted(by_role)
            out.append(
                Violation(
                    self.rule,
                    path,
                    line,
                    f"field 'self.{attr}' of {cls} is written here by "
                    f"role '{store_role}' ({func}) and also touched by "
                    f"role(s) {', '.join(repr(r) for r in others)} with no "
                    "common guarding lock; guard it or annotate the field "
                    "`# shared-by-design: <reason>`",
                )
            )
        return out
