"""Control-flow graphs over Python AST, at function granularity.

The repro-lint rules that guard *semantic* invariants (RPL005's
zero-inactive-columns taint analysis, RPL004's host-sync discipline) need to reason
about **paths**, not lexical scope: "is this factor write
sanitizer-dominated on every way control can reach it?" is a dataflow
question.  This module builds the graph those analyses run on.

Granularity and approximations (deliberate — this is a linter, not a
verifier):

- One CFG per statement list (a function body, or a module's top level).
  Nested ``def``/``class``/``lambda`` bodies are *atomic statements* of
  the enclosing graph; callers analyze them as their own CFGs.
- ``if``/``while``/``for`` (each with ``else``), ``break``/``continue``,
  ``return``/``raise``, ``match`` and ``with`` are modeled exactly.
  Loops get a back edge, so fixpoint iteration sees them.
- ``try`` is modeled conservatively for forward may/must analyses: every
  handler is reachable both from *before* the try body (nothing ran) and
  from its end (everything ran), so a sanitizer inside ``try`` never
  spuriously dominates a handler path.  ``finally`` is on every exit.
- ``with`` bodies execute linearly; each ``as`` target materializes as a
  synthetic assignment statement so transfer functions see the binding.

Blocks are straight-line statement lists; edges carry no conditions
(branch tests appear as a synthetic :class:`BranchTest` statement in the
block that evaluates them, so analyses may inspect the expression).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class BranchTest:
    """Synthetic statement: evaluation of a branch/loop test expression."""

    node: ast.expr  # the test expression
    origin: ast.stmt  # the If/While statement it came from

    @property
    def lineno(self) -> int:  # findings anchor here
        return getattr(self.node, "lineno", getattr(self.origin, "lineno", 0))

    @property
    def col_offset(self) -> int:
        return getattr(
            self.node, "col_offset", getattr(self.origin, "col_offset", 0)
        )


@dataclasses.dataclass
class LoopBind:
    """Synthetic statement: the ``for`` target binding (target ← iter)."""

    target: ast.expr
    iter: ast.expr
    origin: ast.stmt

    @property
    def lineno(self) -> int:
        return getattr(self.origin, "lineno", 0)

    @property
    def col_offset(self) -> int:
        return getattr(self.origin, "col_offset", 0)


class Block:
    """A basic block: straight-line statements plus successor edges."""

    __slots__ = ("id", "stmts", "succs", "preds", "label")

    def __init__(self, bid: int, label: str = ""):
        self.id = bid
        self.stmts: List[object] = []  # ast.stmt | BranchTest | LoopBind
        self.succs: List["Block"] = []
        self.preds: List["Block"] = []
        self.label = label

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Block {self.id} {self.label!r} -> {[s.id for s in self.succs]}>"


class CFG:
    """entry/exit blocks plus the full block list, in creation order."""

    def __init__(self):
        self.blocks: List[Block] = []
        self.entry = self.new_block("entry")
        self.exit = self.new_block("exit")

    def new_block(self, label: str = "") -> Block:
        b = Block(len(self.blocks), label)
        self.blocks.append(b)
        return b

    def add_edge(self, src: Block, dst: Block) -> None:
        if dst not in src.succs:
            src.succs.append(dst)
            dst.preds.append(src)

    def reachable(self) -> List[Block]:
        """Blocks reachable from entry, in a deterministic order."""
        seen: Dict[int, Block] = {}
        stack = [self.entry]
        while stack:
            b = stack.pop()
            if b.id in seen:
                continue
            seen[b.id] = b
            stack.extend(reversed(b.succs))
        return [self.blocks[i] for i in sorted(seen)]


#: statements that terminate a block with a jump (no fallthrough)
_TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)

#: nested definitions treated as atomic statements of the enclosing graph
ATOMIC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


class _Builder:
    def __init__(self):
        self.cfg = CFG()
        # (continue_target, break_target) stack for loop bodies
        self.loops: List[tuple] = []

    # -- helpers ----------------------------------------------------------

    def _seal(self, cur: Optional[Block], dst: Block) -> None:
        if cur is not None:
            self.cfg.add_edge(cur, dst)

    def build(self, stmts: Sequence[ast.stmt]) -> CFG:
        body_head = self.cfg.new_block("body")
        self.cfg.add_edge(self.cfg.entry, body_head)
        tail = self._stmts(stmts, body_head)
        self._seal(tail, self.cfg.exit)
        return self.cfg

    # -- statement walkers -------------------------------------------------
    # Each _X(node, cur) appends to `cur` and returns the block where
    # control continues afterwards (None if this path cannot fall through).

    def _stmts(self, stmts: Sequence[ast.stmt], cur: Optional[Block]):
        for s in stmts:
            if cur is None:  # unreachable code after return/raise/...
                cur = self.cfg.new_block("dead")
            cur = self._stmt(s, cur)
        return cur

    def _stmt(self, s: ast.stmt, cur: Block) -> Optional[Block]:
        if isinstance(s, ast.If):
            return self._if(s, cur)
        if isinstance(s, (ast.While,)):
            return self._while(s, cur)
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return self._for(s, cur)
        if isinstance(s, ast.Try):
            return self._try(s, cur)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            return self._with(s, cur)
        if isinstance(s, ast.Match):
            return self._match(s, cur)
        if isinstance(s, _TERMINATORS):
            cur.stmts.append(s)
            if isinstance(s, (ast.Return, ast.Raise)):
                self.cfg.add_edge(cur, self.cfg.exit)
            elif isinstance(s, ast.Break):
                if self.loops:
                    self.cfg.add_edge(cur, self.loops[-1][1])
                else:  # malformed code: treat as exit
                    self.cfg.add_edge(cur, self.cfg.exit)
            else:  # Continue
                if self.loops:
                    self.cfg.add_edge(cur, self.loops[-1][0])
                else:
                    self.cfg.add_edge(cur, self.cfg.exit)
            return None
        # plain statement (incl. nested defs, which stay atomic)
        cur.stmts.append(s)
        return cur

    def _if(self, s: ast.If, cur: Block) -> Optional[Block]:
        cur.stmts.append(BranchTest(s.test, s))
        after = self.cfg.new_block("if.after")
        then_head = self.cfg.new_block("if.then")
        self.cfg.add_edge(cur, then_head)
        then_tail = self._stmts(s.body, then_head)
        self._seal(then_tail, after)
        if s.orelse:
            else_head = self.cfg.new_block("if.else")
            self.cfg.add_edge(cur, else_head)
            else_tail = self._stmts(s.orelse, else_head)
            self._seal(else_tail, after)
        else:
            self.cfg.add_edge(cur, after)
        return after if after.preds else None

    def _while(self, s: ast.While, cur: Block) -> Optional[Block]:
        head = self.cfg.new_block("while.head")
        self._seal(cur, head)
        head.stmts.append(BranchTest(s.test, s))
        after = self.cfg.new_block("while.after")
        body_head = self.cfg.new_block("while.body")
        self.cfg.add_edge(head, body_head)
        self.loops.append((head, after))
        body_tail = self._stmts(s.body, body_head)
        self.loops.pop()
        self._seal(body_tail, head)  # back edge
        if s.orelse:
            # else runs when the loop exits without break
            else_head = self.cfg.new_block("while.else")
            self.cfg.add_edge(head, else_head)
            else_tail = self._stmts(s.orelse, else_head)
            self._seal(else_tail, after)
        else:
            self.cfg.add_edge(head, after)
        return after if after.preds else None

    def _for(self, s, cur: Block) -> Optional[Block]:
        head = self.cfg.new_block("for.head")
        self._seal(cur, head)
        head.stmts.append(LoopBind(s.target, s.iter, s))
        after = self.cfg.new_block("for.after")
        body_head = self.cfg.new_block("for.body")
        self.cfg.add_edge(head, body_head)
        self.loops.append((head, after))
        body_tail = self._stmts(s.body, body_head)
        self.loops.pop()
        self._seal(body_tail, head)  # back edge
        if s.orelse:
            else_head = self.cfg.new_block("for.else")
            self.cfg.add_edge(head, else_head)
            else_tail = self._stmts(s.orelse, else_head)
            self._seal(else_tail, after)
        else:
            self.cfg.add_edge(head, after)
        return after if after.preds else None

    def _try(self, s: ast.Try, cur: Block) -> Optional[Block]:
        after = self.cfg.new_block("try.after")
        body_head = self.cfg.new_block("try.body")
        self.cfg.add_edge(cur, body_head)
        body_tail = self._stmts(s.body, body_head)
        # success path: orelse then after
        if s.orelse:
            else_head = self.cfg.new_block("try.else")
            self._seal(body_tail, else_head)
            else_tail = self._stmts(s.orelse, else_head)
            success_tail = else_tail
        else:
            success_tail = body_tail
        # handlers: reachable from before the body (nothing ran) and after
        # it (everything ran) — conservative bracketing of "some prefix ran"
        handler_tails: List[Optional[Block]] = []
        for h in s.handlers:
            h_head = self.cfg.new_block("try.handler")
            self.cfg.add_edge(cur, h_head)
            if body_tail is not None:
                self.cfg.add_edge(body_tail, h_head)
            if h.name:  # `except E as name:` binds name
                bind = ast.Assign(
                    targets=[ast.Name(id=h.name, ctx=ast.Store())],
                    value=h.type or ast.Constant(value=None),
                )
                ast.copy_location(bind, h)
                ast.fix_missing_locations(bind)
                h_head.stmts.append(bind)
            handler_tails.append(self._stmts(h.body, h_head))
        # finally runs on every exit path
        if s.finalbody:
            fin_head = self.cfg.new_block("try.finally")
            self._seal(success_tail, fin_head)
            for t in handler_tails:
                self._seal(t, fin_head)
            if not s.handlers:
                # an uncaught exception also reaches finally
                if body_tail is not None:
                    self.cfg.add_edge(body_tail, fin_head)
                self.cfg.add_edge(cur, fin_head)
            fin_tail = self._stmts(s.finalbody, fin_head)
            self._seal(fin_tail, after)
        else:
            self._seal(success_tail, after)
            for t in handler_tails:
                self._seal(t, after)
        return after if after.preds else None

    def _with(self, s, cur: Block) -> Optional[Block]:
        for item in s.items:
            if item.optional_vars is not None:
                bind = ast.Assign(
                    targets=[item.optional_vars], value=item.context_expr
                )
                ast.copy_location(bind, s)
                ast.fix_missing_locations(bind)
                cur.stmts.append(bind)
            else:
                expr = ast.Expr(value=item.context_expr)
                ast.copy_location(expr, s)
                cur.stmts.append(expr)
        return self._stmts(s.body, cur)

    def _match(self, s: ast.Match, cur: Block) -> Optional[Block]:
        cur.stmts.append(BranchTest(s.subject, s))
        after = self.cfg.new_block("match.after")
        exhaustive = False
        for case in s.cases:
            c_head = self.cfg.new_block("match.case")
            self.cfg.add_edge(cur, c_head)
            c_tail = self._stmts(case.body, c_head)
            self._seal(c_tail, after)
            if (
                isinstance(case.pattern, ast.MatchAs)
                and case.pattern.pattern is None
                and case.guard is None
            ):
                exhaustive = True  # bare wildcard `case _:`
        if not exhaustive:
            self.cfg.add_edge(cur, after)  # no case matched
        return after if after.preds else None


def build_cfg(node) -> CFG:
    """CFG for a function def's body, or any explicit statement list.

    ``node`` may be a ``FunctionDef``/``AsyncFunctionDef``, a ``Module``,
    or a plain list of statements.
    """
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
        stmts = node.body
    else:
        stmts = list(node)
    return _Builder().build(stmts)
