"""Generic forward dataflow over ``cfg.CFG``.

One worklist solver serves every rule: a client supplies the lattice
(initial state, join, transfer) and gets back the fixpoint IN state of
every node. Transfer functions may return per-edge-label states —
that is what makes conditional acquisition (``if not
ledger.try_charge(...): return``) path-sensitive: the ``true`` and
``false`` edges out of a test node carry different states.

States must be immutable hashable values (frozensets of facts); join
must be monotone. The solver iterates to fixpoint, so lattices must
have finite height — both shipped analyses use finite powersets.
"""

from __future__ import annotations

from .cfg import CFG, Node


class Analysis:
    """Lattice + transfer. ``transfer`` returns either one out-state
    (applied to every outgoing edge) or a dict keyed by edge label
    (missing labels fall back to the ``None`` key, then the in-state).
    """

    def initial(self):
        raise NotImplementedError

    def join(self, states):
        raise NotImplementedError

    def transfer(self, node: Node, state):
        return state


def solve(cfg: CFG, analysis: Analysis) -> dict[int, object]:
    """Fixpoint IN states keyed by ``id(node)``. Unreachable nodes are
    absent from the result."""
    preds = cfg.preds()
    # edge out-states: (id(src), label, id(dst)) -> state
    edge_out: dict[tuple[int, str, int], object] = {}
    in_state: dict[int, object] = {id(cfg.entry): analysis.initial()}
    work = [cfg.entry]
    while work:
        node = work.pop()
        state = in_state.get(id(node))
        if state is None:
            continue
        result = analysis.transfer(node, state)
        per_label = result if isinstance(result, dict) else None
        for label, target in node.succ:
            if per_label is not None:
                out = per_label.get(label, per_label.get(None, state))
            else:
                out = result
            key = (id(node), label, id(target))
            if edge_out.get(key) == out and id(target) in in_state:
                continue
            edge_out[key] = out
            incoming = [
                edge_out[(id(p), plabel, id(target))]
                for plabel, p in preds[id(target)]
                if (id(p), plabel, id(target)) in edge_out
            ]
            joined = (
                analysis.join(incoming) if len(incoming) > 1 else incoming[0]
            )
            if in_state.get(id(target)) != joined or id(target) not in in_state:
                in_state[id(target)] = joined
                work.append(target)
    return in_state
