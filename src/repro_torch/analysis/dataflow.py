"""Generic forward abstract interpretation over :mod:`repro_torch.analysis.cfg`.

A worklist fixpoint for *join-semilattice* domains: an analysis supplies
the entry state, a monotone per-statement transfer function and a join,
and gets back the abstract state at the head of every block (and, via
:func:`walk_states`, before every statement).  RPL005's factor-mask taint
domain and RPL004's tensor-derived-value domain both run on this engine —
the path sensitivity a lexical rule lacks ("mask applied on only one
branch") falls out of the join.

Termination: states must form a finite-height lattice (both shipped
domains map variables into small enums, so height ≤ |vars| × |enum|).
A hard iteration cap guards against a buggy non-monotone transfer —
exceeding it raises :class:`FixpointDiverged` rather than hanging the
linter.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from repro_torch.analysis.cfg import CFG, Block


class FixpointDiverged(RuntimeError):
    """The worklist did not stabilize within the iteration budget."""


class ForwardAnalysis:
    """Interface a dataflow domain implements.  States are treated as
    immutable values: ``transfer`` and ``join`` return fresh states."""

    def initial(self):
        """State on entry to the CFG."""
        raise NotImplementedError

    def transfer(self, state, stmt):
        """State after executing ``stmt`` (an ast.stmt / BranchTest /
        LoopBind) in ``state``."""
        raise NotImplementedError

    def join(self, a, b):
        """Least upper bound of two states."""
        raise NotImplementedError

    def equals(self, a, b) -> bool:
        return a == b


def _block_out(analysis: ForwardAnalysis, state, block: Block):
    for s in block.stmts:
        state = analysis.transfer(state, s)
    return state


def run_forward(
    cfg: CFG,
    analysis: ForwardAnalysis,
    *,
    max_passes: int = 64,
) -> Dict[int, object]:
    """Fixpoint in-states: ``block.id -> state`` at the block's head.

    Only reachable blocks appear.  ``max_passes`` bounds how many times
    any single block may be reprocessed (loops converge in O(lattice
    height); 64 is far beyond any real function here).
    """
    reachable = cfg.reachable()
    in_states: Dict[int, object] = {cfg.entry.id: analysis.initial()}
    visits: Dict[int, int] = {}
    work = [cfg.entry]
    while work:
        block = work.pop(0)
        visits[block.id] = visits.get(block.id, 0) + 1
        if visits[block.id] > max_passes:
            raise FixpointDiverged(
                f"block {block.id} ({block.label!r}) reprocessed more than "
                f"{max_passes} times — non-monotone transfer?"
            )
        out = _block_out(analysis, in_states[block.id], block)
        for succ in block.succs:
            old = in_states.get(succ.id)
            new = out if old is None else analysis.join(old, out)
            if old is None or not analysis.equals(old, new):
                in_states[succ.id] = new
                if succ not in work:
                    work.append(succ)
    return {b.id: s for b, s in ((b, in_states.get(b.id)) for b in reachable)
            if s is not None}


def walk_states(
    cfg: CFG,
    analysis: ForwardAnalysis,
    in_states: Optional[Dict[int, object]] = None,
) -> Iterator[Tuple[object, object]]:
    """Yield ``(stmt, state_before_stmt)`` over every reachable statement.

    Runs (or reuses) the fixpoint, then replays each block's transfer
    chain — the per-statement view sink checks consume.
    """
    if in_states is None:
        in_states = run_forward(cfg, analysis)
    for block in cfg.reachable():
        state = in_states.get(block.id)
        if state is None:
            continue
        for s in block.stmts:
            yield s, state
            state = analysis.transfer(state, s)
