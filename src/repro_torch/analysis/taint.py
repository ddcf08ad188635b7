"""Factor-mask taint domain in torch idioms: the dataflow ground for RPL005.

The zero-inactive-columns invariant (ROADMAP "Reference contract") demands
that every tensor *written into* a factor buffer has exactly-zero inactive
columns: U / V columns past ``rank`` and S outside its active block. This
module gives each variable a mask *status* and pushes it through the CFG
with :mod:`repro_torch.analysis.dataflow`, so the rule can ask: is the
written value sanitizer-dominated on **every** path to the write?

Status lattice (a total order by badness; join takes the worst):

- ``MASK``   — the value *is* an inactive-column mask (``rank_mask`` /
  ``augmented_mask`` / ``coeff_grad_mask`` output, or an
  ``arange``-vs-rank comparison).
- ``MASKED`` — a tensor whose inactive columns are provably zero here:
  sanitizer output (``mask_coeff``, ``init_factor``), a factor-leaf read
  (``f.U``: inductively invariant), an all-zeros tensor (``torch.zeros``,
  ``zeros_like``, ``new_zeros``), or anything multiplied by a MASK / MASKED
  value (``*``, ``torch.mul``, ``.mul``: zeros absorb).
- ``CLEAN``  — an existing value moved verbatim (a parameter, a
  subscript, ``.to`` / ``.contiguous`` / ``.clone`` of one) or a known
  non-tensor: fine to *re-wrap* into a factor, but not proof that a
  computed write is masked.
- ``FRESH``  — computed with no dominating sanitizer: the taint.

Sinks (checked by the rule): factor-constructor kwargs and
``dataclasses.replace(f, U=...)`` must not be FRESH; an in-place write
into a factor leaf (``f.U[...] = v``, ``f.S.copy_(v)``,
``.index_copy_(d, i, v)``, ``.masked_scatter_(m, v)``, ``.mul_(v)`` by a
non-mask) requires a MASK / MASKED value.
"""
from __future__ import annotations

import ast
from typing import Dict, Optional, Set, Tuple

from repro_torch.analysis.cfg import BranchTest, LoopBind
from repro_torch.analysis.dataflow import ForwardAnalysis

# badness-ordered statuses (join = max)
MASK, MASKED, CLEAN, FRESH = 0, 1, 2, 3

#: a variable's abstract value: (status, aliases-a-factor-leaf)
Val = Tuple[int, bool]

FACTOR_LEAVES = {"U", "S", "V"}
FACTOR_CTORS = {"LowRankFactor", "AugmentedFactor"}

#: calls producing a mask
MASK_MAKERS = {"rank_mask", "augmented_mask", "coeff_grad_mask"}
#: calls whose output satisfies the invariant by construction
SANITIZERS = {"mask_coeff", "init_factor", "zero_inactive", "check_invariants"}
#: all-zero constructors (vacuously invariant)
ZERO_MAKERS = {"zeros", "zeros_like", "new_zeros"}
#: identity movers: output is the input's data, bit for bit or recast
MOVERS = {"as_tensor", "asarray", "from_numpy", "detach"}
#: products: zeros absorb, so one masked operand masks the product
PRODUCTS = {"mul", "multiply"}
#: constructors of non-tensor values (mesh placements, specs)
NONARRAY_CTORS = {
    "P", "PartitionSpec", "Shard", "Replicate", "Partial", "DeviceMesh", "spec",
}
#: tensor methods that return their receiver's data unchanged (modulo
#: dtype, device or layout), so its status carries over
PRESERVING_METHODS = {
    "to", "float", "double", "half", "bfloat16", "contiguous", "clone",
    "detach", "cpu", "cuda", "reshape", "view", "transpose", "mT", "t",
    "expand", "unsqueeze", "squeeze", "requires_grad_",
}
#: in-place tensor methods whose written operand is the last positional
#: argument (``copy_(v)``, ``index_copy_(dim, idx, v)``,
#: ``masked_scatter_(mask, v)``, ``mul_(v)``)
INPLACE_WRITES = {"copy_", "index_copy_", "masked_scatter_", "mul_"}


def call_leaf(node: ast.Call) -> str:
    """Last dotted component of the callee (``a.b.c(...)`` → ``c``)."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def nonarray_functions(tree: ast.AST) -> Set[str]:
    """Module-level defs whose every ``return`` is a known non-tensor
    (a placement-like constructor or a constant) — calls to them are CLEAN.
    """
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        returns = [n for n in ast.walk(node) if isinstance(n, ast.Return)]
        if not returns:
            continue

        def nonarray(e: Optional[ast.expr]) -> bool:
            if e is None or isinstance(e, ast.Constant):
                return True
            return isinstance(e, ast.Call) and call_leaf(e) in NONARRAY_CTORS

        if all(nonarray(r.value) for r in returns):
            out.add(node.name)
    return out


def _has_arange(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call) and call_leaf(n) == "arange" for n in ast.walk(node)
    )


def is_replace_call(call: ast.Call) -> bool:
    """``dataclasses.replace(f, ...)`` / ``replace(f, ...)``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr == "replace" and isinstance(f.value, ast.Name) \
            and f.value.id == "dataclasses"
    return isinstance(f, ast.Name) and f.id == "replace"


class FactorTaint(ForwardAnalysis):
    """Per-variable mask-status analysis for one scope (function/module).

    ``params`` are the scope's bindings on entry; factor-leaf names
    (``U``/``S``/``V``) enter as MASKED leaves (the invariant holds
    inductively at function boundaries), everything else as CLEAN.
    """

    def __init__(self, params: Tuple[str, ...] = (),
                 nonarray_funcs: Optional[Set[str]] = None):
        self.params = tuple(params)
        self.nonarray_funcs = nonarray_funcs or set()

    # -- lattice ----------------------------------------------------------

    def initial(self) -> Dict[str, Val]:
        state: Dict[str, Val] = {}
        for p in self.params:
            state[p] = (MASKED, True) if p in FACTOR_LEAVES else (CLEAN, False)
        return state

    def join(self, a: Dict[str, Val], b: Dict[str, Val]) -> Dict[str, Val]:
        out = dict(a)
        for k, (st, leaf) in b.items():
            if k in out:
                st0, leaf0 = out[k]
                out[k] = (max(st0, st), leaf0 or leaf)
            else:
                out[k] = (st, leaf)
        return out

    # -- expressions -------------------------------------------------------

    def eval(self, state: Dict[str, Val], e: ast.AST) -> Val:
        """Abstract value of an expression in ``state``."""
        if isinstance(e, ast.Constant):
            return (CLEAN, False)
        if isinstance(e, ast.Name):
            if e.id in state:
                return state[e.id]
            if e.id in FACTOR_LEAVES:
                return (MASKED, True)
            return (CLEAN, False)
        if isinstance(e, ast.Attribute):
            if e.attr in FACTOR_LEAVES:
                return (MASKED, True)
            if e.attr in ("T", "mT", "data"):
                return self.eval(state, e.value)
            return (CLEAN, False)
        if isinstance(e, ast.Subscript):
            return self.eval(state, e.value)
        if isinstance(e, ast.Starred):
            return self.eval(state, e.value)
        if isinstance(e, ast.UnaryOp):
            return self.eval(state, e.operand)
        if isinstance(e, ast.BinOp):
            return self._binop(self.eval(state, e.left), e.op, self.eval(state, e.right))
        if isinstance(e, ast.BoolOp):
            vals = [self.eval(state, v) for v in e.values]
            return (max(v[0] for v in vals), False)
        if isinstance(e, ast.Compare):
            # arange-vs-rank comparisons build masks
            return (MASK, False) if _has_arange(e) else (CLEAN, False)
        if isinstance(e, ast.IfExp):
            b = self.eval(state, e.body)
            o = self.eval(state, e.orelse)
            return (max(b[0], o[0]), b[1] or o[1])
        if isinstance(e, ast.Call):
            return self._call(state, e)
        if isinstance(e, (ast.Tuple, ast.List)):
            if not e.elts:
                return (CLEAN, False)
            vals = [self.eval(state, v) for v in e.elts]
            return (max(v[0] for v in vals), any(v[1] for v in vals))
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.eval(state, e.elt)
        if isinstance(e, ast.DictComp):
            return self.eval(state, e.value)
        if isinstance(e, (ast.Await, ast.NamedExpr)):
            return self.eval(state, e.value)
        # Lambda, Dict, JoinedStr, Slice, ...
        return (CLEAN, False)

    @staticmethod
    def _binop(l: Val, op: ast.operator, r: Val) -> Val:
        if isinstance(op, ast.Mult):
            # elementwise product: zeros absorb — one masked side suffices
            if l[0] <= MASKED or r[0] <= MASKED:
                return (MASKED, False)
            return (FRESH, False)
        if isinstance(op, (ast.BitOr, ast.BitAnd, ast.BitXor)):
            if l[0] == MASK and r[0] == MASK:
                return (MASK, False)
            return (max(l[0], r[0], MASKED), False)
        if isinstance(op, (ast.Add, ast.Sub)):
            # zeros + zeros stays zero; anything else can repopulate them
            if l[0] <= MASKED and r[0] <= MASKED:
                return (MASKED, False)
            return (FRESH, False)
        if isinstance(op, (ast.Div, ast.FloorDiv, ast.Mod)):
            # 0 / x == 0: the left side's zero columns survive
            return (MASKED, False) if l[0] <= MASKED else (FRESH, False)
        # MatMult, Pow, shifts: computed afresh
        return (FRESH, False)

    def _call(self, state: Dict[str, Val], e: ast.Call) -> Val:
        leaf = call_leaf(e)
        if leaf in MASK_MAKERS:
            return (MASK, False)
        if leaf in SANITIZERS or leaf in ZERO_MAKERS or leaf in FACTOR_CTORS:
            # a constructed factor: its kwargs are themselves sink-checked
            return (MASKED, False)
        if leaf in NONARRAY_CTORS or leaf in self.nonarray_funcs:
            return (CLEAN, False)
        if is_replace_call(e) and e.args:
            return self.eval(state, e.args[0])
        if isinstance(e.func, ast.Attribute):
            recv = e.func.value
            if leaf in PRESERVING_METHODS:
                return self.eval(state, recv)
            if leaf in PRODUCTS:
                other = self.eval(state, e.args[0]) if e.args else (CLEAN, False)
                if isinstance(recv, ast.Name) and recv.id == "torch" and len(e.args) > 1:
                    return self._binop(other, ast.Mult(), self.eval(state, e.args[1]))
                return self._binop(self.eval(state, recv), ast.Mult(), other)
        if leaf in MOVERS and e.args:
            return self.eval(state, e.args[0])
        # unknown call: masked inputs propagate (diag/cat/qr of a masked
        # tensor stays column-masked in this codebase's idioms); otherwise
        # the result is freshly computed
        arg_vals = [self.eval(state, a) for a in e.args]
        arg_vals += [self.eval(state, kw.value) for kw in e.keywords]
        if isinstance(e.func, ast.Attribute):
            arg_vals.append(self.eval(state, e.func.value))
        if any(v[0] <= MASKED for v in arg_vals):
            return (MASKED, False)
        return (FRESH, False)

    # -- in-place writes into a factor leaf --------------------------------

    def inplace_sink(self, state: Dict[str, Val], call: ast.Call):
        """If ``call`` writes in place into a factor leaf (``f.U.copy_(v)``,
        ``f.S.index_copy_(0, i, v)``, ``f.V.masked_scatter_(m, v)``,
        ``f.U.mul_(v)``), return ``(method, status of v)``, else None."""
        if not (isinstance(call.func, ast.Attribute) and call.func.attr in INPLACE_WRITES):
            return None
        if not call.args or not self.eval(state, call.func.value)[1]:
            return None
        return call.func.attr, self.eval(state, call.args[-1])[0]

    def store_sink(self, state: Dict[str, Val], target: ast.AST) -> bool:
        """``f.U[...] = v`` / ``U[...] = v``: a subscript store into a factor
        leaf."""
        return isinstance(target, ast.Subscript) and self.eval(state, target.value)[1]

    # -- transfer ----------------------------------------------------------

    def transfer(self, state: Dict[str, Val], stmt) -> Dict[str, Val]:
        if isinstance(stmt, BranchTest):
            return state
        if isinstance(stmt, LoopBind):
            out = dict(state)
            self._bind(out, stmt.target, (CLEAN, False))
            return out
        if isinstance(stmt, ast.Assign):
            out = dict(state)
            val = self.eval(state, stmt.value)
            for t in stmt.targets:
                self._assign(out, t, stmt.value, val)
            return out
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            out = dict(state)
            self._assign(out, stmt.target, stmt.value, self.eval(state, stmt.value))
            return out
        if isinstance(stmt, ast.AugAssign):
            out = dict(state)
            if isinstance(stmt.target, ast.Name):
                out[stmt.target.id] = self._binop(
                    self.eval(state, stmt.target), stmt.op, self.eval(state, stmt.value))
            return out
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out = dict(state)
            out[stmt.name] = (CLEAN, False)
            return out
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            out = dict(state)
            for alias in stmt.names:
                out[(alias.asname or alias.name).split(".")[0]] = (CLEAN, False)
            return out
        if isinstance(stmt, ast.Delete):
            out = dict(state)
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.pop(t.id, None)
            return out
        return state

    def _assign(self, out: Dict[str, Val], target: ast.AST,
                value_expr: ast.AST, val: Val) -> None:
        if isinstance(target, (ast.Tuple, ast.List)) and isinstance(
            value_expr, (ast.Tuple, ast.List)
        ) and len(target.elts) == len(value_expr.elts):
            for t, v in zip(target.elts, value_expr.elts):
                self._assign(out, t, v, self.eval(out, v))
            return
        self._bind(out, target, val)

    def _bind(self, out: Dict[str, Val], target: ast.AST, val: Val) -> None:
        if isinstance(target, ast.Name):
            out[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            # unpacking an opaque value: every element inherits its status
            for t in target.elts:
                self._bind(out, t, (val[0], False))
        elif isinstance(target, ast.Starred):
            self._bind(out, target.value, val)
        # attribute/subscript stores don't (re)bind a local
