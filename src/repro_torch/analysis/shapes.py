"""Static shape/dtype/layout interpreter for the port's kernel path.

Rule RPL009's engine: symbolically executes the *AST* of
``repro_torch/kernels/ops.py`` — no torch tensor, no device — over a
battery of concrete shape cases, and checks every ``xus``/``avt``/``atb``
call against the Hopper kernels' operand contract,
:mod:`repro_torch.kernels.constraints`: operand ranks, one device,
contiguity, the kernels' dtypes, ``U``'s and ``S``'s dtypes against
``x``'s, ``avt``'s and ``atb``'s operand pairs, shape agreement, and the
grid limits the plans (``xus_plan``, ``avt_plan``, ``atb_plan``) enforce.
An abstract tensor carries its shape, its dtype and whether it is
contiguous, so a dropped ``.contiguous()`` or ``.to(dtype)`` / ``.float()``
shows as a broken contract at the call it feeds.

Every ``torch.autograd.Function.apply`` the path makes is followed by its
``backward`` on a non-contiguous cotangent (autograd hands those over),
with every input needing a gradient: each returned gradient must have its
primal's dtype and shape (a mixed-precision case, S in f32 beside bf16
operands, makes a dropped cast visible).

Shape cases come from three sources (:func:`shape_cases`): a synthetic
grid that always runs (ragged dims, decode rows, stacked factors, the
column-major bases ``torch.linalg.qr`` returns, bf16 operands with an f32
``S``), the ``ModelSpec`` presets, and ``examples/configs/*.toml`` read
through the port's own loader.
"""
from __future__ import annotations

import ast
import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import constraints

#: interpreter recursion guard
_MAX_DEPTH = 24

#: dtype attribute names recognized on the ``torch`` module
_DTYPE_NAMES = {
    "float32", "bfloat16", "float16", "float64", "int32", "int64", "int8", "uint8",
    "float8_e4m3fn", "float8_e5m2",
}
#: names ``ops.py`` imports that the interpreter models
_MODULES = {"torch", "math"}
_SINKS = {"xus", "avt", "atb"}
_BUILTINS = {"any", "all", "isinstance", "tuple", "len", "min", "max", "int", "abs"}


class InterpError(Exception):
    """The interpreter hit a construct it cannot evaluate."""


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _CaseAbort(Exception):
    """A reachable ``raise`` (or an operand the kernels refuse) aborted
    this shape case."""


@dataclasses.dataclass(frozen=True)
class Arr:
    """Abstract tensor: a concrete shape, a dtype name, and whether its
    memory is contiguous."""

    shape: Tuple[int, ...]
    dtype: str
    contiguous: bool = True


@dataclasses.dataclass(frozen=True)
class Case:
    """One concrete operand configuration of ``y = ((x U) S) Vᵀ``.

    ``dtype`` is x's, U's and V's (the wrappers require U to match x),
    ``sdtype`` S's (x's or float32); ``G`` stacks the factors (0: 2-D);
    ``colmajor`` gives U and V the column-major layout of a fresh QR basis.
    """

    label: str
    M: int
    K: int
    N: int
    R: int
    dtype: str = "float32"
    sdtype: Optional[str] = None
    G: int = 0
    colmajor: bool = False


@dataclasses.dataclass
class Violation:
    """One contract failure at a specific call site."""

    lineno: int
    col: int
    kind: str  # stable key for dedup across cases
    message: str
    case: str


class _Ctx:
    """The ``ctx`` of an autograd Function: what ``forward`` saved."""

    def __init__(self, n_inputs: int):
        self.saved: tuple = ()
        self.needs = (True,) * n_inputs


@dataclasses.dataclass
class _Applied:
    """One ``Function.apply``: its class, ctx, primal inputs and output."""

    cls: str
    ctx: _Ctx
    primals: tuple
    out: object


# ---------------------------------------------------------------------------
# shape cases
# ---------------------------------------------------------------------------

#: always-on grid
SYNTHETIC_CASES = (
    Case("f32-tiny", M=8, K=64, N=48, R=4),
    Case("f32-ragged", M=37, K=96, N=80, R=23),
    Case("f32-decode", M=1, K=640, N=2560, R=160),
    Case("f32-colmajor-bases", M=16, K=128, N=512, R=32, colmajor=True),
    Case("bf16-ragged", M=40, K=136, N=264, R=24, dtype="bfloat16"),
    Case("bf16-f32-S", M=104, K=128, N=512, R=32, dtype="bfloat16", sdtype="float32"),
    Case("bf16-stacked-experts", M=5, K=2048, N=1024, R=128, dtype="bfloat16", G=64,
         colmajor=True),
    Case("f32-stacked-f32-S", M=64, K=96, N=80, R=24, G=3),
)


def _rank(cfg) -> int:
    lr = cfg.lowrank
    return min(lr.r_cap, max(1, int(lr.rank_frac * cfg.d_model)))


def _preset_cases() -> List[Case]:
    """Cases from the ``ModelSpec`` presets (guarded: presets pull the
    model stack's imports)."""
    try:
        from repro_torch.api.tasks import PRESETS
    except Exception:
        return []
    out: List[Case] = []
    for name, cfg in sorted(PRESETS.items()):
        try:
            out.append(Case(f"preset-{name}", M=4 * 128, K=cfg.d_model, N=cfg.d_ff,
                            R=_rank(cfg), dtype=cfg.compute_dtype, colmajor=True))
        except Exception:
            continue
    return out


def _config_cases() -> List[Case]:
    """Cases from ``examples/configs/*.toml``: the batch geometry each
    shipped experiment feeds the kernels."""
    try:
        from repro_torch.api.serialization import toml_loads
        from repro_torch.api.tasks import PRESETS
    except Exception:
        return []
    for parent in Path(__file__).resolve().parents:
        if (parent / "examples" / "configs").is_dir():
            cfg_dir = parent / "examples" / "configs"
            break
    else:
        return []
    out: List[Case] = []
    for path in sorted(cfg_dir.glob("*.toml")):
        try:
            data = toml_loads(path.read_text())
        except Exception:
            continue
        preset = PRESETS.get(data.get("model", {}).get("preset", ""))
        if preset is None:
            continue
        dspec = data.get("data", {})
        m = int(dspec.get("batch", 4)) * int(dspec.get("seq", 128))
        out.append(Case(f"config-{path.stem}", M=m, K=preset.d_model, N=preset.d_ff,
                        R=_rank(preset), dtype=preset.compute_dtype, colmajor=True))
    return out


def shape_cases(include_derived: bool = True) -> List[Case]:
    cases = list(SYNTHETIC_CASES)
    if include_derived:
        seen = {dataclasses.astuple(c)[1:] for c in cases}
        for c in _preset_cases() + _config_cases():
            key = dataclasses.astuple(c)[1:]
            if key not in seen:
                seen.add(key)
                cases.append(c)
    return cases


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _plans():
    """The kernels' plans (pure Python on the shapes), imported on first
    use: they enforce the grid limits of the contract table."""
    from repro_torch.kernels.coeff_grad import atb_plan
    from repro_torch.kernels.lowrank_matmul import avt_plan, xus_plan

    return {"xus": xus_plan, "avt": avt_plan, "atb": atb_plan}


class ShapeInterp:
    """Abstract interpreter over one module's AST (``kernels/ops.py``)."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.classes: Dict[str, Dict[str, ast.FunctionDef]] = {}
        for n in tree.body:
            if isinstance(n, ast.FunctionDef):
                self.functions[n.name] = n
            elif isinstance(n, ast.ClassDef):
                self.classes[n.name] = {
                    m.name: m for m in n.body if isinstance(m, ast.FunctionDef)
                }
        self.violations: List[Violation] = []
        self.applied: List[_Applied] = []
        self.case = ""

    # -- public entry points ----------------------------------------------

    def run_case(self, case: Case) -> None:
        """Interpret the kernel path's entry points for one shape case, and
        the backward of every Function they apply, accumulating violations
        (never raising for contract failures)."""
        self.case = case.label
        lead = (case.G,) if case.G else ()
        fd, sd = case.dtype, case.sdtype or case.dtype
        x = Arr(lead + (case.M, case.K), fd)
        U = Arr(lead + (case.K, case.R), fd, not case.colmajor)
        S = Arr(lead + (case.R, case.R), sd)
        V = Arr(lead + (case.N, case.R), fd, not case.colmajor)
        dy = Arr(lead + (case.M, case.N), fd)
        A = Arr(lead + (case.M, case.R), fd)
        want = lead + (case.M, case.N)

        self.applied = []
        y = self._entry("lowrank_apply", [x, U, S, V, True])
        self._expect("lowrank_apply", y, want, fd, "forward")
        # activations with two leading batch dims, as the model passes them
        xb = Arr(lead + (2, case.M, case.K), fd)
        y = self._entry("lowrank_apply_nd", [xb, U, S, V, True])
        self._expect("lowrank_apply_nd", y, lead + (2, case.M, case.N), fd, "nd forward")
        g = self._entry("coeff_grad_kernels", [x, dy, U, V])
        self._expect("coeff_grad_kernels", g, lead + (case.R, case.R), fd, "coeff grad")
        a = self._entry("_local_xus", [x, U, S, True])
        self._expect("_local_xus", a, lead + (case.M, case.R), fd, "mesh first half")
        y = self._entry("_local_avt", [A, V, True])
        self._expect("_local_avt", y, want, fd, "mesh second half")
        for app in list(self.applied):
            self._backward(app)

    def _expect(self, fname: str, got, shape, dtype: str, what: str) -> None:
        if not isinstance(got, Arr):
            return
        node = self.functions.get(fname)
        if got.shape != shape:
            self._flag(node, f"{what}-shape",
                       f"{what} output shape {got.shape}, expected {shape}")
        if got.dtype != dtype:
            self._flag(node, f"{what}-dtype",
                       f"{what} output dtype {got.dtype} drifts from the operands' {dtype}")

    def _backward(self, app: _Applied) -> None:
        """``backward(ctx, dy)`` on a non-contiguous cotangent: each
        gradient in its primal's dtype and shape."""
        fn = self.classes[app.cls].get("backward")
        if fn is None or not isinstance(app.out, Arr):
            return
        dy = Arr(app.out.shape, app.out.dtype, contiguous=False)
        try:
            grads = self._call_def(fn, [app.ctx, dy], {}, depth=0)
        except _CaseAbort:
            return
        if not isinstance(grads, tuple):
            grads = (grads,)
        if len(grads) != len(app.primals):
            self._flag(fn, f"{app.cls}-bwd-arity",
                       f"`{app.cls}.backward` returns {len(grads)} gradients for "
                       f"{len(app.primals)} inputs")
            return
        names = [a.arg for a in self.classes[app.cls]["forward"].args.args[1:]]
        for nm, grad, prim in zip(names, grads, app.primals):
            if not isinstance(grad, Arr) or not isinstance(prim, Arr):
                continue
            if grad.dtype != prim.dtype:
                self._flag(fn, f"{app.cls}-bwd-dtype-{nm}",
                           f"`{app.cls}.backward` returns d{nm} in {grad.dtype} but the "
                           f"primal {nm} is {prim.dtype} — dtype promotion leaks out of "
                           f"the backward pass")
            if grad.shape != prim.shape:
                self._flag(fn, f"{app.cls}-bwd-shape-{nm}",
                           f"`{app.cls}.backward`: d{nm} shape {grad.shape} != primal "
                           f"{prim.shape}")

    def _entry(self, name: str, args: list, kwargs: Optional[dict] = None):
        fn = self.functions.get(name)
        if fn is None:
            raise InterpError(f"entry point {name}() not found in module")
        try:
            return self._call_def(fn, args, kwargs or {}, depth=0)
        except _CaseAbort:
            return None

    def _flag(self, node, kind: str, message: str) -> None:
        self.violations.append(Violation(
            lineno=getattr(node, "lineno", 1), col=getattr(node, "col_offset", 0),
            kind=kind, message=message, case=self.case,
        ))

    # -- function application ---------------------------------------------

    def _call_def(self, fn, args: list, kwargs: dict, depth: int, env=None):
        if depth > _MAX_DEPTH:
            raise InterpError(f"recursion depth exceeded in {getattr(fn, 'name', 'lambda')}()")
        env = dict(env or {})
        a = fn.args
        pos = list(a.posonlyargs) + list(a.args)
        if len(args) > len(pos):
            raise InterpError(f"too many positional args to {getattr(fn, 'name', 'lambda')}()")
        for arg_node, value in zip(pos, args):
            env[arg_node.arg] = value
        for arg_node, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
            if arg_node.arg not in env:
                env[arg_node.arg] = self._eval(default, env, depth)
        for arg_node, default in zip(a.kwonlyargs, a.kw_defaults):
            if arg_node.arg not in kwargs and default is not None:
                env[arg_node.arg] = self._eval(default, env, depth)
        env.update(kwargs)
        for arg_node in pos + a.kwonlyargs:
            if arg_node.arg not in env:
                raise InterpError(f"missing argument {arg_node.arg!r}")
        if isinstance(fn, ast.Lambda):
            return self._eval(fn.body, env, depth)
        try:
            self._exec_block(fn.body, env, depth)
        except _Return as r:
            return r.value
        return None

    # -- statements --------------------------------------------------------

    def _exec_block(self, stmts, env, depth) -> None:
        for s in stmts:
            self._exec(s, env, depth)

    def _exec(self, s: ast.stmt, env, depth) -> None:
        if isinstance(s, ast.Return):
            raise _Return(None if s.value is None else self._eval(s.value, env, depth))
        if isinstance(s, ast.Assign):
            val = self._eval(s.value, env, depth)
            for t in s.targets:
                self._bind(t, val, env)
            return
        if isinstance(s, ast.AnnAssign) and s.value is not None:
            self._bind(s.target, self._eval(s.value, env, depth), env)
            return
        if isinstance(s, ast.If):
            self._exec_block(s.body if self._eval(s.test, env, depth) else s.orelse, env, depth)
            return
        if isinstance(s, ast.Assert):
            if not self._eval(s.test, env, depth):
                self._flag(s, f"assert-L{s.lineno}",
                           f"assertion fails statically: {ast.unparse(s.test)}")
            return
        if isinstance(s, ast.Raise):
            self._flag(s, f"raise-L{s.lineno}", "reachable raise on the kernel path: "
                       + (ast.unparse(s.exc) if s.exc else "re-raise"))
            raise _CaseAbort()
        if isinstance(s, ast.Expr):
            self._eval(s.value, env, depth)
            return
        if isinstance(s, (ast.Pass, ast.Import, ast.ImportFrom)):
            return
        raise InterpError(f"unsupported statement {type(s).__name__} at line "
                          f"{getattr(s, 'lineno', '?')}")

    def _bind(self, target, val, env) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            if not isinstance(val, tuple) or len(val) != len(target.elts):
                raise InterpError("tuple unpacking arity mismatch")
            for t, v in zip(target.elts, val):
                self._bind(t, v, env)
        else:
            raise InterpError(f"unsupported assignment target {type(target).__name__}")

    # -- expressions -------------------------------------------------------

    def _name(self, e: ast.Name, env):
        if e.id in env:
            return env[e.id]
        if e.id in self.functions:
            return ("def", e.id)
        if e.id in self.classes:
            return ("class", e.id)
        if e.id in _MODULES:
            return ("module", e.id)
        if e.id in _SINKS:
            return ("sink", e.id)
        if e.id in _BUILTINS:
            return ("builtin", e.id)
        if e.id == "DTensor":
            return ("type", "DTensor")
        raise InterpError(f"unknown name {e.id!r} at line {e.lineno}")

    def _eval(self, e: ast.expr, env, depth):
        if isinstance(e, ast.Constant):
            return e.value
        if isinstance(e, ast.Name):
            return self._name(e, env)
        if isinstance(e, ast.Tuple):
            out: list = []
            for v in e.elts:
                if isinstance(v, ast.Starred):
                    out.extend(self._eval(v.value, env, depth))
                else:
                    out.append(self._eval(v, env, depth))
            return tuple(out)
        if isinstance(e, ast.Attribute):
            return self._attribute(e, env, depth)
        if isinstance(e, ast.Subscript):
            return self._subscript(e, env, depth)
        if isinstance(e, ast.BinOp):
            return self._binop(e.op, self._eval(e.left, env, depth),
                               self._eval(e.right, env, depth), e)
        if isinstance(e, ast.UnaryOp):
            v = self._eval(e.operand, env, depth)
            if isinstance(e.op, ast.USub):
                return -v
            if isinstance(e.op, ast.Not):
                return not v
            raise InterpError("unsupported unary op")
        if isinstance(e, ast.BoolOp):
            if isinstance(e.op, ast.And):
                v = True
                for sub in e.values:
                    v = self._eval(sub, env, depth)
                    if not v:
                        return v
                return v
            v = False
            for sub in e.values:
                v = self._eval(sub, env, depth)
                if v:
                    return v
            return v
        if isinstance(e, ast.Compare):
            left = self._eval(e.left, env, depth)
            for op, rhs_node in zip(e.ops, e.comparators):
                rhs = self._eval(rhs_node, env, depth)
                if not self._compare(op, left, rhs):
                    return False
                left = rhs
            return True
        if isinstance(e, ast.IfExp):
            return (self._eval(e.body, env, depth) if self._eval(e.test, env, depth)
                    else self._eval(e.orelse, env, depth))
        if isinstance(e, ast.Lambda):
            return ("lambda", e, dict(env))
        if isinstance(e, ast.GeneratorExp):
            return self._generator(e, env, depth)
        if isinstance(e, ast.Call):
            return self._call(e, env, depth)
        raise InterpError(f"unsupported expression {type(e).__name__} at line "
                          f"{getattr(e, 'lineno', '?')}")

    def _generator(self, e: ast.GeneratorExp, env, depth) -> list:
        if len(e.generators) != 1 or not isinstance(e.generators[0].target, ast.Name):
            raise InterpError("only single-loop generator expressions are modeled")
        gen = e.generators[0]
        out = []
        for v in self._eval(gen.iter, env, depth):
            inner = dict(env)
            inner[gen.target.id] = v
            if all(self._eval(c, inner, depth) for c in gen.ifs):
                out.append(self._eval(e.elt, inner, depth))
        return out

    @staticmethod
    def _compare(op, a, b):
        ops = {ast.Eq: lambda: a == b, ast.NotEq: lambda: a != b, ast.Lt: lambda: a < b,
               ast.LtE: lambda: a <= b, ast.Gt: lambda: a > b, ast.GtE: lambda: a >= b,
               ast.Is: lambda: a is b, ast.IsNot: lambda: a is not b}
        for cls, fn in ops.items():
            if isinstance(op, cls):
                return fn()
        raise InterpError("unsupported comparison")

    @staticmethod
    def _binop(op, left, right, node):
        if isinstance(left, Arr) or isinstance(right, Arr):
            raise InterpError(f"arithmetic on tensors at line {getattr(node, 'lineno', '?')} "
                              f"(the kernel path calls the kernels)")
        try:
            for cls, fn in ((ast.Add, lambda: left + right), (ast.Sub, lambda: left - right),
                            (ast.Mult, lambda: left * right),
                            (ast.FloorDiv, lambda: left // right),
                            (ast.Mod, lambda: left % right)):
                if isinstance(op, cls):
                    return fn()
        except TypeError:
            raise InterpError(f"arithmetic on abstract values at line "
                              f"{getattr(node, 'lineno', '?')}")
        raise InterpError("unsupported binary operator")

    def _attribute(self, e: ast.Attribute, env, depth):
        val = self._eval(e.value, env, depth)
        if isinstance(val, Arr):
            if e.attr == "shape":
                return val.shape
            if e.attr == "dtype":
                return val.dtype
            if e.attr in ("contiguous", "float", "to", "transpose", "reshape", "dim"):
                return ("method", e.attr, val)
            raise InterpError(f"unmodeled tensor attribute .{e.attr} at line {e.lineno}")
        if isinstance(val, _Ctx):
            if e.attr == "saved_tensors":
                return val.saved
            if e.attr == "needs_input_grad":
                return val.needs
            if e.attr == "save_for_backward":
                return ("save", val)
            raise InterpError(f"unmodeled ctx attribute .{e.attr}")
        if val == ("module", "torch"):
            if e.attr in _DTYPE_NAMES:
                return e.attr
            return ("torch", e.attr)
        if val == ("module", "math") and e.attr == "prod":
            return ("builtin", "prod")
        if isinstance(val, tuple) and val[:1] == ("class",):
            if e.attr == "apply":
                return ("apply", val[1])
            return ("def_in", val[1], e.attr)
        raise InterpError(f"unsupported attribute .{e.attr} at line {e.lineno}")

    def _subscript(self, e: ast.Subscript, env, depth):
        base = self._eval(e.value, env, depth)
        idx = e.slice
        if isinstance(base, tuple) and not (base and base[0] in ("module", "def", "class")):
            if isinstance(idx, ast.Slice):
                lo, hi = (None if b is None else self._eval(b, env, depth)
                          for b in (idx.lower, idx.upper))
                if idx.step is not None:
                    raise InterpError("strided slice unsupported")
                return base[lo:hi]
            i = self._eval(idx, env, depth)
            if not isinstance(i, int):
                raise InterpError("non-integer tuple index")
            return base[i]
        if isinstance(base, Arr):
            if isinstance(idx, (ast.Slice, ast.Tuple)):
                raise InterpError("slicing a tensor on the kernel path is not modeled")
            i = self._eval(idx, env, depth)
            if not isinstance(i, int):
                raise InterpError("non-integer tensor index")
            return Arr(base.shape[1:], base.dtype, base.contiguous)
        raise InterpError("unsupported subscript base")

    # -- calls -------------------------------------------------------------

    def _call(self, e: ast.Call, env, depth):
        fn = self._eval(e.func, env, depth)
        args: list = []
        for a in e.args:
            if isinstance(a, ast.Starred):
                args.extend(self._eval(a.value, env, depth))
            else:
                args.append(self._eval(a, env, depth))
        kwargs = {kw.arg: self._eval(kw.value, env, depth)
                  for kw in e.keywords if kw.arg is not None}
        kind = fn[0] if isinstance(fn, tuple) and fn and isinstance(fn[0], str) else None
        if kind == "def":
            return self._call_def(self.functions[fn[1]], args, kwargs, depth + 1)
        if kind == "lambda":
            return self._call_def(fn[1], args, kwargs, depth + 1, env=fn[2])
        if kind == "apply":
            return self._apply(fn[1], args, depth)
        if kind == "save":
            fn[1].saved = tuple(args)
            return None
        if kind == "builtin":
            return self._builtin(fn[1], args)
        if kind == "method":
            return self._method(fn[1], fn[2], args, kwargs, e)
        if kind == "sink":
            return self._sink(fn[1], e, args)
        raise InterpError(f"uninterpretable call at line {e.lineno}: {ast.unparse(e.func)}")

    def _apply(self, cls: str, args: list, depth: int):
        methods = self.classes.get(cls, {})
        if "forward" not in methods:
            raise InterpError(f"{cls} has no forward")
        ctx = _Ctx(len(args))
        out = self._call_def(methods["forward"], [ctx] + args, {}, depth + 1)
        self.applied.append(_Applied(cls, ctx, tuple(args), out))
        return out

    @staticmethod
    def _builtin(name: str, args: list):
        if name == "isinstance":
            if args[1] == ("type", "DTensor"):
                return False  # the cases run on plain tensors
            raise InterpError(f"isinstance against {args[1]!r}")
        if name == "prod":
            return math.prod(args[0])
        return {"any": any, "all": all, "tuple": tuple, "len": len, "min": min,
                "max": max, "int": int, "abs": abs}[name](*args)

    @staticmethod
    def _method(name: str, t: Arr, args: list, kwargs: dict, e: ast.Call):
        if name == "contiguous":
            return Arr(t.shape, t.dtype, True)
        if name == "float":
            return Arr(t.shape, "float32", t.contiguous)
        if name == "to":
            dtype = kwargs.get("dtype", args[0] if args else None)
            if not isinstance(dtype, str):
                raise InterpError(f".to() with a non-dtype argument at line {e.lineno}")
            return Arr(t.shape, dtype, t.contiguous)
        if name == "dim":
            return len(t.shape)
        if name == "transpose":
            a, b = (d % len(t.shape) for d in args)
            shape = list(t.shape)
            shape[a], shape[b] = shape[b], shape[a]
            return Arr(tuple(shape), t.dtype, t.contiguous and t.shape[a] == t.shape[b] == 1)
        if name == "reshape":
            shape = tuple(args[0]) if len(args) == 1 and isinstance(args[0], tuple) \
                else tuple(args)
            if math.prod(shape) != math.prod(t.shape):
                raise InterpError(f"reshape {t.shape} -> {shape} at line {e.lineno}")
            # a view keeps a non-contiguous layout when only unit dims move;
            # merging or splitting dims of one copies it contiguous
            same = tuple(d for d in shape if d != 1) == tuple(d for d in t.shape if d != 1)
            return Arr(shape, t.dtype, t.contiguous or not same)
        raise InterpError(f"unmodeled tensor method .{name}()")

    # -- kernel sinks ------------------------------------------------------

    def _sink(self, kernel: str, e: ast.Call, args: list) -> Arr:
        names = {"xus": ("x", "U", "S"), "avt": ("A", "V"), "atb": ("A", "B")}[kernel]
        if len(args) < 2 or len(args) > len(names) or not all(
                isinstance(a, Arr) for a in args if a is not None):
            raise InterpError(f"{kernel}() called with non-tensor operands at line {e.lineno}")
        ops = [a for a in args if a is not None]
        first, second = args[0], args[1]
        S = args[2] if len(args) > 2 else None

        def check(key: str, fn, *check_args) -> bool:
            try:
                fn(*check_args)
            except (ValueError, TypeError) as err:
                self._flag(e, f"{kernel}-{key}-L{e.lineno}",
                           f"`{kernel}` call breaks the Hopper contract: {err}")
                return False
            return True

        # ranks and shapes first, as the wrappers check them: the rest
        # needs agreeing operands
        if not all(check("dims", constraints.check_stack_dims, n, a.shape)
                   for n, a in zip(names, args) if a is not None):
            raise _CaseAbort()
        shape_check = {"xus": lambda: constraints.check_xus_shapes(
                           first.shape, second.shape, None if S is None else S.shape),
                       "avt": lambda: constraints.check_avt_shapes(first.shape, second.shape),
                       "atb": lambda: constraints.check_atb_shapes(first.shape, second.shape)}
        if not check("shape", shape_check[kernel]):
            raise _CaseAbort()
        check("operands", constraints.check_operands, kernel, ["cuda"] * len(ops),
              [a.contiguous for a in ops], first.dtype)
        if kernel == "xus":
            check("dtypes", constraints.check_xus_dtypes, first.dtype, second.dtype,
                  None if S is None else S.dtype)
        else:
            check("dtypes", constraints.check_pair_dtypes, kernel, "".join(names), first.dtype,
                  second.dtype)
        G = first.shape[0] if len(first.shape) == 3 else 1
        M, K = first.shape[-2:]
        if kernel == "xus":
            plan_args = (G, M, K, second.shape[-1], S is not None)
            out = first.shape[:-1] + (second.shape[-1],)
        elif kernel == "avt":
            plan_args, out = (G, M, second.shape[-2], K), first.shape[:-1] + (second.shape[-2],)
        else:
            plan_args, out = (G, M, K, second.shape[-1]), first.shape[:-2] + (K, second.shape[-1])
        check("grid", _plans()[kernel], *plan_args)
        return Arr(out, first.dtype, True)


def check_kernel_module(tree: ast.Module, cases: Optional[List[Case]] = None
                        ) -> Tuple[List[Violation], List[str]]:
    """Run every shape case against a ``kernels/ops.py`` module AST.

    Returns ``(violations, errors)``: contract violations deduped by
    site + kind (with the witnessing cases folded into the message), and
    interpreter errors (unsupported constructs — reported as warnings so a
    refactor that breaks the interpreter is visible, not silent).
    """
    interp = ShapeInterp(tree)
    errors: List[str] = []
    for case in cases if cases is not None else shape_cases():
        try:
            interp.run_case(case)
        except InterpError as err:
            errors.append(f"[{case.label}] {err}")
    by_key: Dict[Tuple[int, str], Violation] = {}
    witnesses: Dict[Tuple[int, str], List[str]] = {}
    for v in interp.violations:
        key = (v.lineno, v.kind)
        if key not in by_key:
            by_key[key] = v
            witnesses[key] = []
        if v.case not in witnesses[key]:
            witnesses[key].append(v.case)
    out: List[Violation] = []
    for key, v in sorted(by_key.items()):
        cases_str = ", ".join(witnesses[key][:3])
        extra = len(witnesses[key]) - 3
        if extra > 0:
            cases_str += f", +{extra} more"
        out.append(dataclasses.replace(v, message=f"{v.message} [cases: {cases_str}]"))
    return out, sorted(set(errors))
