"""The port's rule catalog: RPL001–RPL009, in torch idioms.

Each rule keeps the JAX package's id, title and intent
(:mod:`repro.analysis.rules`), grounded in one invariant of the port.
Where the port's idioms differ the rule follows them: RPL003 knows
torch's global RNG, RPL004 is the host-sync discipline of the device-step
modules (the port has no jit: its precondition is a CUDA graph of a
step), RPL005 sees in-place tensor writes, RPL007 ``torch.load`` /
``torch.save``, and RPL009 checks the Hopper kernels' operand contract
(:mod:`repro_torch.kernels.constraints`) instead of the TPU tile table.

The semantic rules run on the dataflow engine (:mod:`.cfg` +
:mod:`.dataflow`): RPL005 is a path-sensitive taint analysis over the
factor-mask lattice (:mod:`.taint`), RPL004 propagates tensor-derived
values through assignments, and RPL009 delegates to the static shape
interpreter (:mod:`.shapes`).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.cfg import ATOMIC_DEFS, BranchTest, LoopBind, build_cfg
from repro_torch.analysis.core import (
    Finding,
    ModuleInfo,
    PathInfo,
    Rule,
    TextEdit,
    call_name,
    dotted_name,
    parse_module,
    register_rule,
)
from repro_torch.analysis.dataflow import FixpointDiverged, ForwardAnalysis, walk_states
from repro_torch.analysis.taint import (
    FACTOR_CTORS,
    FACTOR_LEAVES,
    FRESH,
    MASK,
    MASKED,
    FactorTaint,
    is_replace_call,
    nonarray_functions,
)

# ---------------------------------------------------------------------------
# RPL001 — engines are built in exactly one place
# ---------------------------------------------------------------------------

#: engine constructors / factories with one sanctioned construction site
ENGINE_NAMES = {
    "FederatedEngine",
    "SyncSimEngine",
    "AsyncFederatedEngine",
    "HierarchicalEngine",
    "make_sim_engine",
    "ServeEngine",
    "ContinuousScheduler",
}

#: files of ``repro_torch`` allowed to construct engines: the
#: build()/serve() seams and the engine modules themselves
ENGINE_HOMES = (
    ("api", "experiment.py"),
    ("fed", "engine.py"),
    ("fed", "sim", "engines.py"),
    ("serve",),
)


@register_rule
class NoAdHocEngines(Rule):
    """No engine construction outside ``api.experiment.build()``.

    ``build(spec)`` is the single engine factory, so cohort policy, wire
    codecs, checkpoint stamping and weighting can never be silently
    dropped by a hand-rolled engine; the serving stack (``ServeEngine`` /
    ``ContinuousScheduler``) has ``api.experiment.serve()`` as its seam.
    """

    id = "RPL001"
    title = "engine constructed outside api.experiment.build()/serve()"
    severity = "error"
    hint = (
        "describe the scenario as an ExperimentSpec and call "
        "repro_torch.api.build(spec) / repro_torch.api.serve(spec)"
    )

    def applies_to(self, info: PathInfo) -> bool:
        if info.is_tests:
            return False  # tests may construct engines to probe internals
        return not any(info.under(*home) for home in ENGINE_HOMES)

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                leaf = call_name(node).rsplit(".", 1)[-1]
                if leaf in ENGINE_NAMES:
                    yield self.finding(
                        mod, node, f"`{leaf}(...)` called outside the build() seam",
                    )


# ---------------------------------------------------------------------------
# RPL002 — entry points speak ExperimentSpec, not core primitives
# ---------------------------------------------------------------------------

#: core-layer constructors an entry point must not assemble by hand —
#: each has an ExperimentSpec field / registry that replaces it
SCENARIO_PRIMITIVES = {
    "FedConfig": "FedSpec fields (lr/local_steps/tau/...)",
    "Participation": "ParticipationSpec / participation string",
    "Wire": "WireSpec.codec",
    "make_codec": "WireSpec.codec",
}


@register_rule
class NoAdHocScenarios(Rule):
    """Entry points (``launch/``, ``examples/``, ``benchmarks/``) route
    scenario axes through :class:`ExperimentSpec` fields and registries,
    never hand-assembled core config objects: a scenario that exists only
    as an ad-hoc ``FedConfig(...)`` in a CLI can't be hashed, stamped into
    checkpoints, or replayed from a spec file.
    """

    id = "RPL002"
    title = "ad-hoc scenario construction in an entry point"
    severity = "error"
    hint = "add/use the ExperimentSpec field and let build() resolve it"

    def applies_to(self, info: PathInfo) -> bool:
        return info.is_entry_point and not info.is_tests

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                leaf = call_name(node).rsplit(".", 1)[-1]
                if leaf in SCENARIO_PRIMITIVES:
                    yield self.finding(
                        mod, node, f"`{leaf}(...)` assembled in an entry point",
                        hint=f"route through {SCENARIO_PRIMITIVES[leaf]}",
                    )


# ---------------------------------------------------------------------------
# RPL003 — library code is deterministic
# ---------------------------------------------------------------------------

#: wall-clock reads
NONDET_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
}
NONDET_NP_RANDOM = {
    "rand", "randn", "randint", "random", "choice", "permutation",
    "shuffle", "normal", "uniform", "seed",
}
#: calls that reseed torch's global generators
TORCH_SEEDERS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed", "torch.random.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all", "torch.cuda.seed",
    "torch.cuda.seed_all",
}
#: ``torch.<fn>`` draws that take the global generator unless given one
TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial", "poisson",
}
#: in-place draws (tensor methods and ``torch.nn.init``) that do the same
INPLACE_DRAWS = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_", "geometric_",
    "cauchy_", "log_normal_",
}


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


@register_rule
class NoNondeterminism(Rule):
    """No nondeterminism in library code.

    Same spec + same seed must be the same run bit-for-bit on one host:
    that is what makes resume, the identity-codec and telemetry pins, and
    continuous ≡ static batching exact. Wall-clock reads, ``random.*``,
    legacy global-state ``np.random.*``, seedless ``default_rng()``,
    iteration over unordered containers, and torch's global RNG (a
    ``torch.manual_seed``, a draw without ``generator=``, a
    ``torch.Generator()`` never seeded) all break that. Library code reads
    the wall clock only through :mod:`repro_torch.telemetry.clock` (the
    one file exempt here) and draws from a seeded ``torch.Generator`` or
    ``np.random.default_rng(seed)``.
    """

    id = "RPL003"
    title = "nondeterminism in library code"
    severity = "error"
    hint = (
        "thread a seeded torch.Generator (generator=) / np.random.default_rng(seed); "
        "for timing use repro_torch.telemetry.clock.perf_seconds()"
    )

    def applies_to(self, info: PathInfo) -> bool:
        if info.is_tests or info.is_benchmarks or info.is_examples:
            return False
        if not info.repro:
            return False
        # the one sanctioned wall-clock seam
        if info.under("telemetry", "clock.py"):
            return False
        return not info.under("launch")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        calls = [n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)]
        # calls appearing directly as sorted(...)'s argument are order-safe
        # (this is also what --fix produces, so the repair must lint clean)
        self._sorted_args = {
            id(arg) for node in calls if call_name(node) == "sorted" for arg in node.args
        }
        # generators seeded in the module: the receivers of
        # `.manual_seed(...)`, by node (`torch.Generator().manual_seed(s)`)
        # and by name (`g = torch.Generator(); g.manual_seed(s)`)
        seeds = [n.func.value for n in calls
                 if isinstance(n.func, ast.Attribute) and n.func.attr == "manual_seed"]
        self._seeded_nodes = {id(r) for r in seeds}
        self._seeded_names = {dotted_name(r) for r in seeds} - {""}
        self._bound_to = {
            id(node.value): dotted_name(t)
            for node in ast.walk(mod.tree) if isinstance(node, ast.Assign)
            for t in node.targets
        }
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(mod, node)
            elif isinstance(node, ast.For):
                yield from self._check_loop(mod, node)

    def _check_call(self, mod: ModuleInfo, node: ast.Call) -> Iterator[Finding]:
        name = call_name(node)
        if name in NONDET_CALLS:
            yield self.finding(mod, node, f"wall-clock read `{name}()`")
            return
        parts = name.split(".")
        if parts[0] == "random" and len(parts) == 2:
            yield self.finding(mod, node, f"global-state stdlib RNG `{name}()`")
            return
        if (
            len(parts) >= 3
            and parts[-2] == "random"
            and parts[-1] in NONDET_NP_RANDOM
            and parts[0] in ("np", "numpy")
        ):
            yield self.finding(mod, node, f"legacy global-state `{name}()`")
            return
        if name in TORCH_SEEDERS:
            yield self.finding(mod, node, f"`{name}()` reseeds torch's global generator")
            return
        if (
            len(parts) == 2 and parts[0] == "torch" and parts[1] in TORCH_DRAWS
            and not _has_generator(node)
        ):
            yield self.finding(mod, node, f"`{name}()` draws from torch's global generator")
            return
        if parts[-1] in INPLACE_DRAWS and not _has_generator(node):
            yield self.finding(
                mod, node, f"`.{parts[-1]}()` draws from torch's global generator",
            )
            return
        if name in ("torch.Generator", "Generator") and not self._is_seeded(node):
            yield self.finding(mod, node, "`torch.Generator()` is never seeded")
            return
        if parts[-1] == "default_rng" and not node.args and not node.keywords:
            yield self.finding(
                mod, node, "`default_rng()` without a seed is OS-entropy seeded"
            )
        if parts[-1] == "listdir":
            if id(node) in self._sorted_args:
                return
            fix = None
            src = ast.get_source_segment(mod.source, node)
            if src is not None and hasattr(node, "end_lineno"):
                fix = TextEdit(node.lineno, node.col_offset,
                               node.end_lineno, node.end_col_offset, f"sorted({src})")
            yield self.finding(
                mod, node, "`os.listdir()` order is filesystem-dependent",
                hint="wrap in sorted(...)", fix=fix,
            )

    def _is_seeded(self, node: ast.Call) -> bool:
        """``torch.Generator(...).manual_seed(s)``, or bound to a name that
        the module seeds (``g = torch.Generator(); g.manual_seed(s)``)."""
        if id(node) in self._seeded_nodes:
            return True
        return self._bound_to.get(id(node), "") in self._seeded_names

    def _check_loop(self, mod: ModuleInfo, node: ast.For) -> Iterator[Finding]:
        it = node.iter
        if isinstance(it, ast.Set) or (isinstance(it, ast.Call) and call_name(it) == "set"):
            yield self.finding(
                mod, node,
                "iterating a set: order varies across processes (PYTHONHASHSEED)",
                hint="iterate sorted(...) or keep an ordered container",
            )


# ---------------------------------------------------------------------------
# RPL004 — host-sync discipline in the device-step modules
# ---------------------------------------------------------------------------

#: the port's device-step modules: every function there runs inside a
#: training or serving step, on the card
DEVICE_STEP_MODULES = (("core",), ("kernels",))
#: tensor methods that copy to the host (a device synchronisation)
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: builtins that read a value on the host
SYNC_BUILTINS = {"float", "int", "bool"}
#: tensor attributes and methods that read host-side metadata, not data
META_ATTRS = {
    "shape", "dtype", "device", "ndim", "layout", "is_cuda", "requires_grad",
    "is_floating_point", "dim", "size", "numel", "element_size", "data_ptr",
    "stride", "is_contiguous", "storage_offset", "nbytes", "itemsize", "type",
    "placements", "device_mesh", "is_complex", "get_device",
}
#: ``torch.<fn>`` calls that return host values, not tensors
TORCH_HOST_FNS = {
    "is_tensor", "is_floating_point", "device", "Size", "finfo", "iinfo",
    "get_default_dtype", "is_grad_enabled", "is_inference_mode_enabled", "Generator",
    "no_grad", "inference_mode", "enable_grad", "promote_types", "result_type",
    "can_cast", "is_complex", "numel",
}
#: torch namespaces whose functions manage the host side (devices,
#: streams, process groups, operator registration), never tensor data
TORCH_HOST_NAMESPACES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                         "torch.library.", "torch.utils.", "torch._C.")
#: builtins whose result is a host value whatever their argument
HOST_BUILTINS = {"isinstance", "len", "type", "id", "callable", "hasattr", "getattr", "str",
                 "repr", "tuple", "range", "enumerate", "zip", "sorted", "dict", "list"}


def _target_names(target: ast.AST, out: Set[str]) -> None:
    if isinstance(target, ast.Name):
        out.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for t in target.elts:
            _target_names(t, out)
    elif isinstance(target, ast.Starred):
        _target_names(target.value, out)


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    return ann is not None and ast.unparse(ann).split(".")[-1] in ("Tensor", "DTensor")


def tensor_valued(expr: ast.AST, state) -> bool:
    """Does ``expr`` evaluate to a tensor (or a value derived from one's
    data) when the names in ``state`` are tensors? Host metadata
    (``.shape``, ``.dtype``, ``.dim()``, ``isinstance``) is not."""
    if isinstance(expr, ast.Name):
        return expr.id in state
    if isinstance(expr, ast.Attribute):
        if expr.attr in META_ATTRS:
            return False
        if expr.attr in FACTOR_LEAVES or expr.attr == "rank":
            return True  # a factor's U / S / V / rank
        return tensor_valued(expr.value, state)
    if isinstance(expr, ast.Subscript):
        return tensor_valued(expr.value, state)
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in META_ATTRS or expr.func.attr in SYNC_METHODS:
                return False
            if name.startswith(TORCH_HOST_NAMESPACES):
                return False
            if name.startswith("torch."):
                return name.split(".")[-1] not in TORCH_HOST_FNS
            if tensor_valued(expr.func.value, state):
                return True
        if name in HOST_BUILTINS or name in SYNC_BUILTINS:
            return False
        return any(tensor_valued(a, state) for a in expr.args) or any(
            tensor_valued(k.value, state) for k in expr.keywords)
    if isinstance(expr, (ast.BinOp,)):
        return tensor_valued(expr.left, state) or tensor_valued(expr.right, state)
    if isinstance(expr, ast.UnaryOp):
        return tensor_valued(expr.operand, state)
    if isinstance(expr, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
            return False
        return tensor_valued(expr.left, state) or any(
            tensor_valued(c, state) for c in expr.comparators)
    if isinstance(expr, ast.BoolOp):
        return any(tensor_valued(v, state) for v in expr.values)
    if isinstance(expr, ast.IfExp):
        return tensor_valued(expr.body, state) or tensor_valued(expr.orelse, state)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(tensor_valued(e, state) for e in expr.elts)
    if isinstance(expr, ast.Starred):
        return tensor_valued(expr.value, state)
    return False


class _TensorVars(ForwardAnalysis):
    """Which locals hold tensors (or values derived from their data): the
    parameters annotated ``torch.Tensor`` and every name assigned a
    tensor-valued expression. State: a frozenset of names; join is union
    (a tensor on *any* incoming path is a tensor)."""

    def __init__(self, params):
        self.params = frozenset(params)

    def initial(self):
        return self.params

    def join(self, a, b):
        return a | b

    def _rebind(self, state, target, value_is_tensor: bool):
        names: Set[str] = set()
        _target_names(target, names)
        return (state | names) if value_is_tensor else (state - names)

    def transfer(self, state, stmt):
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                state = self._rebind(state, t, tensor_valued(stmt.value, state))
            return state
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            return self._rebind(state, stmt.target, tensor_valued(stmt.value, state))
        if isinstance(stmt, ast.AugAssign):
            names: Set[str] = set()
            _target_names(stmt.target, names)
            if names & state or tensor_valued(stmt.value, state):
                return state | names
            return state
        if isinstance(stmt, LoopBind):
            return self._rebind(state, stmt.target, tensor_valued(stmt.iter, state))
        return state


@register_rule
class HostSyncDiscipline(Rule):
    """The device-step modules (``core/``, ``kernels/``) must not read
    tensor data on the host: no module-level ``numpy`` import, no
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, no
    ``float()`` / ``int()`` / ``bool()`` of a tensor, no Python ``if`` /
    ``while`` on one.

    Each is a device synchronisation in the middle of a step: it stalls
    the host until the card drains, and it is what a CUDA graph of the
    step (the port's answer to its host-bound steps) cannot capture.
    Tensor-derivedness propagates through assignments via dataflow
    (``y = x * 2; if y:`` is the same sync as ``if x:``); shapes, dtypes
    and devices are host metadata and never sync.
    """

    id = "RPL004"
    title = "host sync in a device-step module"
    severity = "error"
    hint = (
        "keep the value on the device (torch.where, masks, tensor-valued "
        "scalars); read it on the host once per round in the engine, or "
        "suppress with the reason the step needs it"
    )

    def applies_to(self, info: PathInfo) -> bool:
        return not info.is_tests and any(info.under(*m) for m in DEVICE_STEP_MODULES)

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in mod.tree.body:
            if isinstance(node, ast.Import):
                if any(a.name == "numpy" or a.name.startswith("numpy.") for a in node.names):
                    yield self.finding(mod, node, "host `numpy` imported in a device-step module")
            elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "numpy" or node.module.startswith("numpy.")
            ):
                yield self.finding(mod, node, "host `numpy` imported in a device-step module")
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = fn.args
                params = {
                    p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                    if _is_tensor_annotation(p.annotation)
                }
                yield from self._sinks(mod, fn, params)

    def _sinks(self, mod: ModuleInfo, fn, params) -> Iterator[Finding]:
        analysis = _TensorVars(params)
        try:
            pairs = list(walk_states(build_cfg(fn), analysis))
        except (FixpointDiverged, RecursionError):
            yield self.finding(mod, fn, f"dataflow did not converge analyzing `{fn.name}`",
                               severity="warning")
            return
        for stmt, state in pairs:
            if isinstance(stmt, BranchTest):
                if isinstance(stmt.origin, (ast.If, ast.While)) and tensor_valued(
                        stmt.node, state):
                    kw = "if" if isinstance(stmt.origin, ast.If) else "while"
                    yield self.finding(
                        mod, stmt.origin,
                        f"Python `{kw} {ast.unparse(stmt.node)}:` on a tensor in "
                        f"`{fn.name}` syncs the host with the device",
                        hint="use torch.where / a mask, or keep the decision on the host",
                    )
                root = stmt.node
            elif isinstance(stmt, LoopBind):
                root = stmt.iter
            elif isinstance(stmt, ATOMIC_DEFS):
                continue  # nested defs are their own functions
            else:
                root = stmt
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (
                    isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS
                    and tensor_valued(f.value, state)
                ):
                    yield self.finding(
                        mod, node,
                        f"`.{f.attr}()` on a tensor in `{fn.name}` syncs the host with the device",
                    )
                elif (
                    isinstance(f, ast.Name) and f.id in SYNC_BUILTINS and node.args
                    and tensor_valued(node.args[0], state)
                ):
                    yield self.finding(
                        mod, node,
                        f"`{f.id}()` of a tensor in `{fn.name}` syncs the host with the device",
                    )


# ---------------------------------------------------------------------------
# RPL005 — factor-layout writes re-mask inactive columns
# ---------------------------------------------------------------------------


@register_rule
class FactorLayoutWrites(Rule):
    """Writes into factor buffers must re-assert the zero-inactive-columns
    layout **on every control-flow path**.

    The fixed-width masked-rank design (the Hopper kernels ≡ the masked
    chain, lossless ``topk_rank``, sound async Galerkin transport, exact
    rank slicing) rests on U/V columns and S rows/cols beyond ``rank``
    being *exactly* zero. This rule runs the factor-mask taint analysis
    (:mod:`repro_torch.analysis.taint`) over each function's CFG: factor
    leaves and sanitizer outputs are MASKED, freshly computed tensors are
    FRESH, and a write sink (a factor constructor's or
    ``dataclasses.replace``'s ``U=``/``S=``/``V=``, an attribute store to
    ``.U/.S/.V``, an in-place write into a leaf) fires when a FRESH value
    reaches it on *any* path.
    """

    id = "RPL005"
    title = "factor buffer written without an inactive-column re-mask"
    severity = "error"
    hint = (
        "apply rank_mask/augmented_mask/mask_coeff (or build via "
        "init_factor) on every path reaching the write"
    )

    def applies_to(self, info: PathInfo) -> bool:
        return not info.is_tests and bool(info.repro)

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        nonarray = nonarray_functions(mod.tree)
        scopes: List[Tuple[object, Tuple[str, ...]]] = [(mod.tree, ())]
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
                params += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
                scopes.append((node, tuple(params)))
        for scope_node, params in scopes:
            analysis = FactorTaint(params, nonarray)
            try:
                pairs = list(walk_states(build_cfg(scope_node), analysis))
            except (FixpointDiverged, RecursionError) as err:
                yield self.finding(mod, scope_node,
                                   f"factor-mask dataflow did not converge: {err}",
                                   severity="warning")
                continue
            for stmt, state in pairs:
                yield from self._sinks(mod, analysis, stmt, state)

    def _sinks(self, mod: ModuleInfo, analysis: FactorTaint, stmt, state) -> Iterator[Finding]:
        if isinstance(stmt, ATOMIC_DEFS):
            return  # nested defs are their own scope
        if isinstance(stmt, BranchTest):
            roots: List[ast.AST] = [stmt.node]
        elif isinstance(stmt, LoopBind):
            roots = [stmt.iter]
        else:
            roots = [stmt]
        if isinstance(stmt, ast.Assign):
            st, _ = analysis.eval(state, stmt.value)
            for t in stmt.targets:
                if isinstance(t, ast.Attribute) and t.attr in FACTOR_LEAVES and st == FRESH:
                    yield self.finding(
                        mod, stmt,
                        f"freshly computed value stored into factor leaf `.{t.attr}` "
                        "with no dominating mask",
                    )
                elif analysis.store_sink(state, t) and st > MASKED:
                    yield self.finding(
                        mod, stmt,
                        "subscript store writes a value with unproven inactive columns "
                        "into a factor leaf",
                    )
        for root in roots:
            for call in ast.walk(root):
                if isinstance(call, ast.Call):
                    yield from self._call_sinks(mod, analysis, call, state)

    def _call_sinks(self, mod: ModuleInfo, analysis: FactorTaint, call: ast.Call,
                    state) -> Iterator[Finding]:
        leaf = call_name(call).rsplit(".", 1)[-1]
        if leaf in FACTOR_CTORS or is_replace_call(call):
            what = "dataclasses.replace" if is_replace_call(call) else leaf
            for kw in call.keywords:
                if kw.arg not in FACTOR_LEAVES:
                    continue
                st, _ = analysis.eval(state, kw.value)
                if st == FRESH:
                    yield self.finding(
                        mod, call,
                        f"`{what}` built with computed `{kw.arg}=` that no mask "
                        "dominates on every path to this write",
                        fix=self._mask_fix(mod, state, kw),
                    )
        sink = analysis.inplace_sink(state, call)
        if sink is not None:
            method, st = sink
            if st > MASKED or (method == "mul_" and st != MASK and st != MASKED):
                yield self.finding(
                    mod, call,
                    f"in-place `.{method}()` writes a value with unproven inactive "
                    "columns into a factor leaf",
                )

    @staticmethod
    def _mask_fix(mod: ModuleInfo, state, kw: ast.keyword):
        """Mechanical re-mask when a live mask variable exists: wrap the
        kwarg in ``mask_coeff(..., m)`` (S) or ``(...) * m[..., None, :]``
        (U/V)."""
        masks = sorted(name for name, (st, _) in state.items() if st == MASK)
        src = ast.get_source_segment(mod.source, kw.value)
        if not masks or src is None:
            return None
        m = masks[0]
        repl = f"mask_coeff({src}, {m})" if kw.arg == "S" else f"(({src}) * {m}[..., None, :])"
        v = kw.value
        return TextEdit(v.lineno, v.col_offset, v.end_lineno, v.end_col_offset, repl)


# ---------------------------------------------------------------------------
# RPL006 — codec protocol conformance
# ---------------------------------------------------------------------------

#: WireCodec protocol: method -> required positional arity incl. self
CODEC_PROTOCOL = {"encode": 2, "decode": 2, "nbytes": 2}


@register_rule
class CodecConformance(Rule):
    """Every concrete ``*Codec`` implements the full WireCodec protocol
    (``encode``/``decode``/``nbytes``, each ``(self, payload-or-msg)``),
    carries a ``name``, and is registered: the wire layer
    (``fed/wire.py``) dispatches codecs by name through ``make_codec``,
    and a codec missing ``nbytes`` silently reports zero measured
    communication.
    """

    id = "RPL006"
    title = "WireCodec protocol violation"
    severity = "error"
    hint = "define encode/decode/nbytes(self, x), set `name`, and add the codec to the registry"

    def applies_to(self, info: PathInfo) -> bool:
        return bool(info.repro) and not info.is_tests

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef) or not cls.name.endswith("Codec"):
                continue
            if cls.name == "WireCodec":
                continue  # the protocol itself
            bases = {call_name(ast.Call(func=b, args=[], keywords=[]))
                     for b in cls.bases if isinstance(b, (ast.Name, ast.Attribute))}
            if "Protocol" in {b.rsplit(".", 1)[-1] for b in bases}:
                continue
            yield from self._check_codec(mod, cls)

    def _check_codec(self, mod: ModuleInfo, cls: ast.ClassDef) -> Iterator[Finding]:
        methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for meth, arity in CODEC_PROTOCOL.items():
            fn = methods.get(meth)
            if fn is None:
                yield self.finding(mod, cls, f"codec `{cls.name}` is missing `{meth}()`")
                continue
            npos = len(fn.args.posonlyargs) + len(fn.args.args)
            required = npos - len(fn.args.defaults)
            if required > arity or (npos < arity and not fn.args.vararg):
                yield self.finding(
                    mod, fn,
                    f"`{cls.name}.{meth}` signature differs from the protocol's "
                    f"({arity - 1} argument beyond self)",
                )
        if not self._has_name(cls, methods.get("__init__")):
            yield self.finding(mod, cls, f"codec `{cls.name}` defines no `name`")
        if not self._registered(mod, cls):
            yield self.finding(
                mod, cls, f"codec `{cls.name}` is never registered for make_codec dispatch",
            )

    @staticmethod
    def _has_name(cls: ast.ClassDef, init: Optional[ast.FunctionDef]) -> bool:
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign):
                if any(isinstance(t, ast.Name) and t.id == "name" for t in stmt.targets):
                    return True
            elif isinstance(stmt, ast.AnnAssign) and (
                isinstance(stmt.target, ast.Name) and stmt.target.id == "name"
            ):
                return True
        if init is not None:
            for n in ast.walk(init):
                if (
                    isinstance(n, ast.Attribute) and n.attr == "name"
                    and isinstance(n.value, ast.Name) and n.value.id == "self"
                    and isinstance(getattr(n, "ctx", None), ast.Store)
                ):
                    return True
        return False

    @staticmethod
    def _registered(mod: ModuleInfo, cls: ast.ClassDef) -> bool:
        span = set(range(cls.lineno, (cls.end_lineno or cls.lineno) + 1))
        return any(
            isinstance(n, ast.Name) and n.id == cls.name and n.lineno not in span
            for n in ast.walk(mod.tree)
        )


# ---------------------------------------------------------------------------
# RPL007 — pickle only behind the versioned checkpoint sidecar
# ---------------------------------------------------------------------------


@register_rule
class NoRawPickle(Rule):
    """No raw pickle outside the versioned checkpoint sidecar: no
    ``pickle`` load or dump, no ``np.load(..., allow_pickle=True)``, no
    ``torch.save``, no ``torch.load`` without ``weights_only=True``.

    Unversioned pickles are both an arbitrary-code-execution surface and
    a schema time bomb (a dataclass rename breaks every old artifact).
    Checkpoints go through the npz format and its versioned state sidecar;
    anything else should be npz/json.
    """

    id = "RPL007"
    title = "raw pickle serialization"
    severity = "error"
    hint = "use the versioned checkpoint sidecar or npz/json"

    def applies_to(self, info: PathInfo) -> bool:
        return not info.is_tests

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            parts = name.split(".")
            if parts[0] in ("pickle", "cPickle", "dill") and parts[-1] in (
                "load", "loads", "Unpickler", "dump", "dumps", "Pickler",
            ):
                yield self.finding(mod, node, f"raw `{name}()`")
            elif name == "torch.save":
                yield self.finding(mod, node, "`torch.save()` writes a pickle")
            elif name == "torch.load" and not any(
                kw.arg == "weights_only" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in node.keywords
            ):
                yield self.finding(
                    mod, node, "`torch.load()` without `weights_only=True` unpickles",
                )
            elif parts[-1] == "load" and parts[0] in ("np", "numpy"):
                for kw in node.keywords:
                    if (
                        kw.arg == "allow_pickle" and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                    ):
                        yield self.finding(
                            mod, node, "`np.load(..., allow_pickle=True)` deserializes pickles",
                        )


# ---------------------------------------------------------------------------
# RPL008 — every *Spec field participates in validation or build()
# ---------------------------------------------------------------------------


@register_rule
class SpecValidationParity(Rule):
    """Every field declared on a ``*Spec`` dataclass must appear in at
    least one validation rule or ``build()`` branch: two specs that differ
    only in a field nothing reads hash differently while running
    identically, so the checkpoint spec-hash guard rejects resumes that
    are fine — or the scenario silently doesn't vary.
    """

    id = "RPL008"
    title = "*Spec field unused by validation and build()"
    severity = "error"
    hint = (
        "validate it in the spec's __post_init__ (or a _validate_* rule) "
        "or consume it in build()/tasks"
    )

    #: files consuming spec fields, relative to the spec module's directory
    SIBLINGS = ("experiment.py", "tasks.py")

    def applies_to(self, info: PathInfo) -> bool:
        return info.under("api", "spec.py")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        consumers = [mod]
        here = os.path.dirname(mod.path)
        for sib in self.SIBLINGS:
            m, _err = parse_module(os.path.join(here, sib))
            if m is not None:
                consumers.append(m)
        used: Set[str] = set()
        for c in consumers:
            for n in ast.walk(c.tree):
                if isinstance(n, ast.Attribute):
                    used.add(n.attr)
                elif isinstance(n, ast.keyword) and n.arg:
                    used.add(n.arg)
                elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                    used.add(n.value)
        for cls in ast.walk(mod.tree):
            if not (isinstance(cls, ast.ClassDef) and cls.name.endswith("Spec")):
                continue
            for stmt in cls.body:
                if not (isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)):
                    continue
                field = stmt.target.id
                if not field.startswith("_") and field not in used:
                    yield self.finding(
                        mod, stmt,
                        f"`{cls.name}.{field}` appears in no validation rule or build() branch",
                    )


# ---------------------------------------------------------------------------
# RPL009 — the kernel path meets the Hopper operand contract statically
# ---------------------------------------------------------------------------


@register_rule
class KernelShapeContracts(Rule):
    """The kernel path must meet the Hopper kernels' operand contract for
    every shape the repo can feed it — proven statically.

    The static shape interpreter (:mod:`repro_torch.analysis.shapes`)
    symbolically executes ``kernels/ops.py`` over a synthetic grid, the
    ``ModelSpec`` presets and the shipped example configs, checking every
    ``xus``/``avt``/``atb`` call against
    :mod:`repro_torch.kernels.constraints` (2-D or 3-D operands, one
    device, contiguous, the kernels' dtypes, ``U``'s and ``S``'s dtypes
    against ``x``'s, shape agreement, the plans' grid limits), plus
    autograd dtype drift (each ``backward`` must return its gradients in
    the primal dtypes). No tensor executes: a dropped ``.contiguous()`` or
    ``.to(dtype)`` is caught by reading the source, on any machine.
    """

    id = "RPL009"
    title = "kernel path violates the Hopper operand contract"
    severity = "error"
    hint = (
        "pass contiguous operands in the dtypes repro_torch.kernels.constraints "
        "lists, and cast gradients back to the primal dtypes"
    )

    def applies_to(self, info: PathInfo) -> bool:
        return info.under("kernels", "ops.py")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        from repro_torch.analysis.shapes import check_kernel_module

        violations, errors = check_kernel_module(mod.tree)
        for v in violations:
            yield Finding(rule=self.id, path=mod.path, line=v.lineno, col=v.col,
                          message=v.message, severity=self.severity, hint=self.hint)
        for err in errors:
            yield Finding(
                rule=self.id, path=mod.path, line=1, col=0,
                message=f"static shape interpreter could not evaluate the kernel path "
                        f"({err}) — coverage lost, not proven clean",
                severity="warning",
                hint="keep ops.py within the interpreted subset or extend "
                     "repro_torch.analysis.shapes",
            )
