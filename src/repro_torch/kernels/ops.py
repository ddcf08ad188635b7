"""The low-rank chain ``y = ((x U) S) Vᵀ`` for the shapes model code has.

``lowrank_apply(x, U, S, V, use_kernels)`` runs the chain through the
:func:`~repro_torch.kernels.lowrank_matmul.xus` and
:func:`~repro_torch.kernels.lowrank_matmul.avt` wrappers (the Hopper
kernels on CUDA tensors, their plain versions on CPU tensors), or, with
``use_kernels=False``, as the plain working-dtype chain ``(x U) S Vᵀ`` of
the JAX package's ``"off"`` policy, differentiated by autograd.

The kernel path is a :class:`torch.autograd.Function` whose backward is the
chain of the JAX package's custom VJP (``src/repro/kernels/ops.py``), every
term on a kernel::

    dyV = dy V                   [xus, no S]
    xU  = x U                    [xus, no S]
    dA  = dy V Sᵀ                [xus]
    dx  = dA Uᵀ                  [avt]
    dU  = xᵀ dA                  [atb]
    dS  = (x U)ᵀ (dy V)          [atb: the client loop's hot op]
    xUS = x U S                  [xus]
    dV  = dyᵀ (x U S)            [atb]

with the JAX code's rounding points: every ``xus`` output rounds once to
the working type, ``atb`` accumulates in f32 and rounds once to its first
operand's type, and each cotangent is cast to its primal's dtype. Terms
nobody asked for (``ctx.needs_input_grad``) are skipped, as ``jit`` drops
them in JAX: the FeDLRT client loop, which differentiates only S̃ and the
activations, runs 3 ``xus``, 1 ``avt`` and 1 ``atb`` per call.

The Hopper kernels mask their ragged edges themselves, so nothing here pads
the rank to TPU lanes or the rows to TPU sublanes.

Under a mesh (DTensor operands, :mod:`repro_torch.models.sharding`) the
chain runs on the local shards, on the kernels as without one: the JAX
package takes its plain chain there only because ``pallas_call`` has no
SPMD rule. :func:`_sharded_lowrank_nd` picks, per mesh axis of size > 1,
how the product splits:

- ``rows``: x is sharded on a leading (batch or sequence) dim; the bases
  are gathered (FSDP style: O(n·r) bytes, not O(n²)) and each rank runs
  its rows;
- ``stack``: U is sharded on a stack dim (the experts); x, S and V follow;
- ``contract``: U is sharded on n_in; x is split the same way, ``(x U) S``
  is a partial sum over the axis and is all-reduced at width ``r`` before
  ``avt`` (the JAX package's intent, ``models/sharding.py``); V keeps its
  n_out sharding and the output is sharded on N;
- ``cols``: only V is sharded (on n_out): the output is sharded on N.

A mesh axis of size 1 holds every operand whole, so a 1 × 1 mesh runs the
same calls as no mesh. The local gradient of an operand that is whole on an
axis the product splits is a partial sum, and is declared so
(``to_local(grad_placements=…)``).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.coeff_grad import atb
from repro_torch.kernels.lowrank_matmul import avt, xus
from repro_torch.telemetry import get_hub

#: model-level kernel policies (``ModelConfig.kernels``)
KERNEL_POLICIES = ("auto", "off")


def check_kernel_policy(policy: str) -> None:
    """Raise ``ValueError`` unless ``policy`` is one of :data:`KERNEL_POLICIES`."""
    if policy == "interpret":
        raise ValueError(
            "kernels='interpret' runs the JAX package's Pallas interpreter and "
            "has no counterpart in the port: use 'auto' (Hopper kernels on "
            "CUDA tensors, their plain versions on CPU tensors) or 'off'"
        )
    if policy not in KERNEL_POLICIES:
        raise ValueError(
            f"kernels policy must be one of {KERNEL_POLICIES}, got {policy!r}"
        )


def use_kernels_for(policy: str) -> bool:
    """Resolve a kernel policy to the ``lowrank_apply`` flag.

    - ``"auto"``: the kernel wrappers, which launch the Hopper kernels on
      CUDA tensors and take the plain versions on CPU tensors → ``True``;
    - ``"off"``: the plain working-dtype chain → ``False``.

    Each call counts a ``kernels.dispatch`` event on the process-global hub,
    as in the JAX package (which resolves once per trace, where the port
    resolves once per call).
    """
    check_kernel_policy(policy)
    flag = policy == "auto"
    get_hub().counter("kernels.dispatch", policy=policy, resolved=str(flag))
    return flag


class _LowRankApply(torch.autograd.Function):
    """``y = ((x U) S) Vᵀ`` on the kernels, with the kernel-backed backward
    described in the module docstring. Operands are contiguous, 2-D or with
    one leading stack dim."""

    @staticmethod
    def forward(ctx, x, U, S, V):
        ctx.save_for_backward(x, U, S, V)
        return avt(xus(x, U, S), V)

    @staticmethod
    def backward(ctx, dy):
        x, U, S, V = ctx.saved_tensors
        need_x, need_U, need_S, need_V = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = dU = dS = dV = None
        if need_x or need_U:
            dA = xus(dy, V, S.transpose(-1, -2).float().contiguous())  # dy V Sᵀ
            if need_x:
                dx = avt(dA, U).to(x.dtype)
            if need_U:
                dU = atb(x, dA).to(U.dtype)
        if need_S:
            dS = atb(xus(x, U), xus(dy, V)).to(S.dtype)
        if need_V:
            dV = atb(dy, xus(x, U, S.float())).to(V.dtype)
        return dx, dU, dS, dV


class _Xus(torch.autograd.Function):
    """``A = (x U) S`` on ``xus``, the first half of the chain when the mesh
    reduces ``A`` between the halves. Backward: ``dB = dA Sᵀ`` [xus],
    ``dx = dB Uᵀ`` [avt], ``dU = xᵀ dB`` [atb], ``dS = (x U)ᵀ dA`` [xus,
    atb]."""

    @staticmethod
    def forward(ctx, x, U, S):
        ctx.save_for_backward(x, U, S)
        return xus(x, U, S)

    @staticmethod
    def backward(ctx, dA):
        x, U, S = ctx.saved_tensors
        need_x, need_U, need_S = ctx.needs_input_grad
        dA = dA.contiguous()
        dx = dU = dS = None
        if need_x or need_U:
            dB = xus(dA, S.transpose(-1, -2).to(dA.dtype).contiguous())
            if need_x:
                dx = avt(dB, U).to(x.dtype)
            if need_U:
                dU = atb(x, dB).to(U.dtype)
        if need_S:
            dS = atb(xus(x, U), dA).to(S.dtype)
        return dx, dU, dS


class _Avt(torch.autograd.Function):
    """``y = A Vᵀ`` on ``avt``, the second half. Backward: ``dA = dy V``
    [xus], ``dV = dyᵀ A`` [atb]."""

    @staticmethod
    def forward(ctx, A, V):
        ctx.save_for_backward(A, V)
        return avt(A, V)

    @staticmethod
    def backward(ctx, dy):
        A, V = ctx.saved_tensors
        need_A, need_V = ctx.needs_input_grad
        dy = dy.contiguous()
        dA = xus(dy, V).to(A.dtype) if need_A else None
        dV = atb(dy, A).to(V.dtype) if need_V else None
        return dA, dV


def lowrank_apply(x, U, S, V, use_kernels: bool = False) -> torch.Tensor:
    """y = ((x U) S) Vᵀ.  x: ([G,] M, K), U: ([G,] K, R), S: ([G,] R, R),
    V: ([G,] N, R) → ([G,] M, N)."""
    if any(isinstance(t, DTensor) for t in (x, U, S, V)):
        return _sharded_lowrank_nd(x, U, S, V, use_kernels)
    if use_kernels:
        return _LowRankApply.apply(
            x.contiguous(), U.contiguous(), S.contiguous(), V.contiguous()
        )
    return torch.matmul(torch.matmul(x, U), S.to(x.dtype)) @ V.transpose(-1, -2)


def coeff_grad_kernels(x, dy, U, V) -> torch.Tensor:
    """∇_S L = (x U)ᵀ (dy V) through ``xus`` and ``atb`` (the paper's
    client backward). x: (M, K), dy: (M, N), U: (K, R), V: (N, R) → (R, R)."""
    return atb(xus(x.contiguous(), U.contiguous()), xus(dy.contiguous(), V.contiguous()))


def lowrank_apply_nd(x, U, S, V, use_kernels: bool = False) -> torch.Tensor:
    """:func:`lowrank_apply` for activations with leading batch dims and
    for stacked factors.

    - ``x`` may carry leading batch dims (``(B, T, d)`` activations): they
      are flattened into the kernels' M dim and restored on the output.
    - ``U/S/V`` may carry leading stack dims (the stacked
      :class:`~repro_torch.core.factorization.LowRankFactor` layout);
      ``x`` then leads with the same dims, and the stack runs as one grid
      axis of the kernels.
    """
    if any(isinstance(t, DTensor) for t in (x, U, S, V)):
        return _sharded_lowrank_nd(x, U, S, V, use_kernels)
    stack = tuple(U.shape[:-2])
    if x.shape[: len(stack)] != stack:
        raise ValueError(
            f"x {tuple(x.shape)} must lead with the factors' stack dims {stack}"
        )
    G = math.prod(stack)
    lead = tuple(x.shape[len(stack):-1])
    K, R, N = U.shape[-2], U.shape[-1], V.shape[-2]
    x3 = x.reshape(G, math.prod(lead), K)
    y = lowrank_apply(
        x3 if stack else x3[0],
        U.reshape(G, K, R) if stack else U,
        S.reshape(G, R, R) if stack else S,
        V.reshape(G, N, R) if stack else V,
        use_kernels,
    )
    return y.reshape(stack + lead + (N,))


# ---------------------------------------------------------------------------
# the chain on local shards (under a mesh)
# ---------------------------------------------------------------------------


def _flat(x, U, S, V):
    """x, U, S, V with the stack dims folded into one (G) and x's leading
    dims into M, as the kernels take them; and the output's shape."""
    stack = tuple(U.shape[:-2])
    G = math.prod(stack)
    lead = tuple(x.shape[len(stack):-1])
    K, R, N = U.shape[-2], U.shape[-1], V.shape[-2]
    fold = (lambda t, a, b: t.reshape(G, a, b)) if stack else (lambda t, a, b: t)
    x3 = x.reshape(G, math.prod(lead), K)
    return (x3 if stack else x3[0], fold(U, K, R), fold(S, R, R), fold(V, N, R),
            stack + lead)


def _local_xus(x, U, S, use_kernels: bool):
    x3, U3, S3, _, lead = _flat(x, U, S, U)
    A = _Xus.apply(x3.contiguous(), U3.contiguous(), S3.contiguous()) if use_kernels else (
        torch.matmul(torch.matmul(x3, U3), S3.to(x.dtype)))
    return A.reshape(lead + (U.shape[-1],))


def _local_avt(A, V, use_kernels: bool):
    nstack = V.dim() - 2
    stack = tuple(V.shape[:-2])
    lead = tuple(A.shape[nstack:-1])
    G, R, N = math.prod(stack), V.shape[-1], V.shape[-2]
    A3 = A.reshape(G, math.prod(lead), R)
    V3 = V.reshape(G, N, R)
    if not stack:
        A3, V3 = A3[0], V3[0]
    y = _Avt.apply(A3.contiguous(), V3.contiguous()) if use_kernels else (
        A3 @ V3.transpose(-1, -2))
    return y.reshape(stack + lead + (N,))


def _plan_axes(x, U, S, V, mesh):
    """Per mesh dim: the placements x, U, S, V take for the local product,
    the output's, whether ``(x U) S`` is a partial sum there, and the
    gradient placements of x, U, S, V (and of the reduced A)."""
    rep = Replicate()
    ns, xd = U.dim() - 2, x.dim()
    plan = {k: [] for k in ("x", "U", "S", "V", "y", "gx", "gU", "gS", "gV", "gA")}
    contract = []
    for i in range(mesh.ndim):
        px, pU, pV = x.placements[i], U.placements[i], V.placements[i]
        if mesh.size(i) == 1:
            # every operand is whole on this axis, whatever it is tagged
            row = dict(x=px, U=pU, S=S.placements[i], V=pV, y=rep)
            grad = dict(gx=None, gU=None, gS=None, gV=None, gA=None)
        elif isinstance(px, Shard) and ns <= px.dim < xd - 1:
            row = dict(x=px, U=rep, S=rep, V=rep, y=Shard(px.dim))
            grad = dict(gx=None, gU=Partial(), gS=Partial(), gV=Partial(), gA=None)
        elif isinstance(pU, Shard) and pU.dim < ns:
            d = Shard(pU.dim)
            row = dict(x=d, U=d, S=d, V=d, y=d)
            grad = dict(gx=None, gU=None, gS=None, gV=None, gA=None)
        elif isinstance(pU, Shard) and pU.dim == ns:
            v_out = isinstance(pV, Shard) and pV.dim == ns
            row = dict(x=Shard(xd - 1), U=Shard(ns), S=rep, V=Shard(ns) if v_out else rep,
                       y=Shard(xd - 1) if v_out else rep)
            grad = dict(gx=None, gU=None, gS=Partial(), gV=None,
                        gA=Partial() if v_out else None)
            contract.append(i)
        elif isinstance(pV, Shard) and pV.dim == ns:
            row = dict(x=rep, U=rep, S=rep, V=Shard(ns), y=Shard(xd - 1))
            grad = dict(gx=Partial(), gU=Partial(), gS=Partial(), gV=None, gA=Partial())
        else:
            row = dict(x=rep, U=rep, S=rep, V=rep, y=rep)
            grad = dict(gx=None, gU=None, gS=None, gV=None, gA=None)
        for k, v in {**row, **grad}.items():
            plan[k].append(v)
    return plan, contract


def _local(t, mesh, want, grad):
    """``t`` redistributed to ``want`` and unwrapped; its local gradient is
    declared ``grad`` where given (else the placement itself)."""
    want = tuple(want)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    gp = tuple(g if g is not None else (Replicate() if isinstance(w, Partial) else w)
               for g, w in zip(grad, want))
    return t.to_local(grad_placements=gp)


def _from_local(t, mesh, placements, shape):
    """The local tensor ``t`` (made contiguous) as the shard of a DTensor of
    global ``shape``."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _sharded_lowrank_nd(x, U, S, V, use_kernels: bool):
    """:func:`lowrank_apply_nd` on DTensor operands, each rank on its
    shards (see the module docstring)."""
    from repro_torch.utils.meshctx import as_dtensor

    mesh = next(t.device_mesh for t in (x, U, S, V) if isinstance(t, DTensor))
    x, U, S, V = (as_dtensor(t, mesh) for t in (x, U, S, V))
    if any(len(t.placements) != mesh.ndim for t in (U, S, V)):
        raise ValueError(f"lowrank_apply: operands on different meshes: x "
                         f"{x.device_mesh}, U {U.device_mesh}, S {S.device_mesh}, V {V.device_mesh}")
    plan, contract = _plan_axes(x, U, S, V, mesh)
    xl = _local(x, mesh, plan["x"], plan["gx"])
    Ul = _local(U, mesh, plan["U"], plan["gU"])
    Sl = _local(S, mesh, plan["S"], plan["gS"])
    Vl = _local(V, mesh, plan["V"], plan["gV"])
    out_shape = tuple(x.shape[:-1]) + (V.shape[-2],)
    if not contract:
        return _from_local(lowrank_apply_nd(xl, Ul, Sl, Vl, use_kernels), mesh, plan["y"],
                           out_shape)
    # (x U) S is a partial sum over the contract axes: reduce it at width r
    a_shape = tuple(x.shape[:-1]) + (U.shape[-1],)
    pA = [Partial() if i in contract else (p if not isinstance(p, Shard) or p.dim < x.dim() - 1
                                           else Replicate())
          for i, p in enumerate(plan["x"])]
    A = _from_local(_local_xus(xl, Ul, Sl, use_kernels), mesh, pA, a_shape)
    want = [Replicate() if i in contract else p for i, p in enumerate(pA)]
    Al = _local(A, mesh, want, plan["gA"])
    return _from_local(_local_avt(Al, Vl, use_kernels), mesh, plan["y"], out_shape)


def rowwise_local(fn, x, *weights):
    """``fn(x, *weights)`` for a ``fn`` that maps each row of ``x`` (its
    leading dims) on its own, on DTensor ``x``'s local rows: the weights
    are gathered whole (their local gradient then a partial sum wherever
    ``x``'s rows are split), and the output keeps ``x``'s placements. For
    the small dense products DTensor would run on rows flattened across a
    split it cannot express (batch and sequence split on two axes)."""
    mesh = x.device_mesh
    if any(isinstance(p, Shard) and p.dim == x.dim() - 1 for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == x.dim() - 1
                                  else p for p in x.placements])
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(p, Shard) and mesh.size(i) > 1 else None
            for i, p in enumerate(x.placements)]
    from repro_torch.utils.meshctx import as_dtensor

    out = fn(x.to_local(), *(_local(as_dtensor(w, mesh), mesh, rep, grad) for w in weights))
    pl = [p if mesh.size(i) > 1 else Replicate() for i, p in enumerate(x.placements)]
    return _from_local(out, mesh, pl, tuple(x.shape[:-1]) + tuple(out.shape[x.dim() - 1:]))
