"""Analytic compute / memory / communication cost model (paper Table 1),
the JAX package's ``repro.core.cost_model`` in PyTorch.

- :func:`table1`: the closed forms of Table 1 for a square ``n×n`` layer,
  and :func:`amortization_rank`;
- exact per-tree counters: the paper's multi-message protocol bytes
  (:func:`fedlrt_round_comm_bytes`, at ``r_max`` or at the current ranks),
  the wire layer's phase-boundary bytes (:func:`wire_round_bytes`, equal to
  the measured identity-codec bytes), FLOPs per local step and per decoded
  token, and factor storage.

Counts are *per client per round*; bytes are f32 on the wire (``BYTES``), as
in the paper's accounting, but for :func:`wire_round_bytes`, which counts
each tensor at its own element size; ``b`` = local batch size, ``s*`` =
local steps.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.factorization import is_factor
from repro_torch.utils.tree import tree_leaves

BYTES = 4  # f32 on-wire, matching the paper's float accounting


# ---------------------------------------------------------------------------
# Table 1 closed forms (square n×n layer, rank r)
# ---------------------------------------------------------------------------


def table1(method: str, *, n: int, r: int, s_star: int = 1, b: int = 1) -> dict:
    """The Table-1 row for ``method`` as a dict of element counts."""
    fedlrt_common = dict(
        client_memory=4 * (n * r + 2 * r**2),
        server_compute=2 * n * r + (8 + 4 * n) * r**2 + 8 * r**3,
        server_memory=2 * n * r + 4 * r**2,
    )
    client_lr = s_star * b * (4 * n * r + 4 * r**2)
    rows = {
        "fedavg": dict(client_compute=s_star * b * n**2, client_memory=2 * n**2,
                       server_compute=n**2, server_memory=2 * n**2, comm=2 * n**2, rounds=1),
        "fedlin": dict(client_compute=s_star * b * n**2, client_memory=2 * n**2,
                       server_compute=n**2, server_memory=2 * n**2, comm=4 * n**2, rounds=2),
        "fedlrt": dict(client_compute=client_lr, **fedlrt_common,
                       comm=6 * n * r + 6 * r**2, rounds=2),
        "fedlrt_simplified": dict(client_compute=client_lr + r**2, **fedlrt_common,
                                  comm=6 * n * r + 8 * r**2, rounds=2),
        "fedlrt_full": dict(client_compute=client_lr + 4 * r**2, **fedlrt_common,
                            comm=6 * n * r + 10 * r**2, rounds=3),
        "fedlr": dict(  # post-hoc SVD compression baseline [31]
            client_compute=s_star * b * n**2 + n**3, client_memory=2 * n**2,
            server_compute=n**2 + n**3, server_memory=4 * n * r, comm=4 * n * r, rounds=1,
        ),
    }
    if method not in rows:
        raise ValueError(f"unknown method {method!r}")
    return rows[method]


def amortization_rank(n: int) -> float:
    """Rank below which FeDLRT communicates less than FedLin: 6nr+8r² < 4n²."""
    return (-6 * n + math.sqrt(36 * n**2 + 128 * n**2)) / 16.0


# ---------------------------------------------------------------------------
# exact per-tree counters
# ---------------------------------------------------------------------------


def _factor_leaves(params):
    return [x for x in tree_leaves(params, is_leaf=is_factor) if is_factor(x)]


def _dense_leaves(params):
    return [x for x in tree_leaves(params, is_leaf=is_factor) if not is_factor(x)]


def fedlrt_round_comm_bytes(params, correction: str = "simplified") -> int:
    """Per-client on-wire bytes of one FeDLRT round for this param tree.

    Counted (up = client→server, down = server→client):
      down: U, V, S at round start                (2nr + r²)
      up:   G_U, G_V                              (2nr)      [+ G_S simplified]
      down: Ū, V̄                                 (2nr)      [+ G_S simplified]
      full correction only: up G_S̃ / down G_S̃   (2·4r²)
      up:   S̃_c^{s*}                              (4r²)
    Dense leaves follow FedLin: down W, up G, down Ḡ, up W_c  (4·size).
    Stacked factors put every slice on the wire.
    """
    total = 0
    for f in _factor_leaves(params):
        r = f.r_max
        stack = math.prod(f.U.shape[:-2])
        nr = (f.n_in + f.n_out) * r
        per = nr + r * r  # initial broadcast
        per += nr  # basis-gradient upload
        per += nr  # augmented-basis broadcast
        if correction == "simplified":
            per += 2 * r * r  # G_S up + down
        elif correction == "full":
            per += 2 * (2 * r) ** 2  # G_S̃ up + down
        per += (2 * r) ** 2  # coefficient upload
        total += stack * per
    for x in _dense_leaves(params):
        total += 4 * x.numel()
    return total * BYTES


def fedlrt_round_comm_bytes_effective(params, correction: str = "simplified") -> torch.Tensor:
    """:func:`fedlrt_round_comm_bytes` priced at each factor's *current*
    rank instead of the ``r_max`` buffer width: what a deployment that ships
    only active columns puts on the wire. It shrinks as truncation adapts
    ranks. An f32 scalar on the factors' device (no host sync inside the
    round); stacked factors sum their per-slice ranks."""
    factors = list(_factor_leaves(params))
    total = torch.zeros((), dtype=torch.float32,
                        device=factors[0].rank.device if factors else None)
    for f in factors:
        r = f.rank.full_tensor() if isinstance(f.rank, DTensor) else f.rank  # whole on every rank
        r = r.float()
        nr = (f.n_in + f.n_out) * r
        r2 = r * r
        per = nr + r2 + nr + nr
        if correction == "simplified":
            per = per + 2.0 * r2
        elif correction == "full":
            per = per + 2.0 * (2.0 * r) ** 2
        per = per + (2.0 * r) ** 2
        total = total + torch.sum(per)
    for x in _dense_leaves(params):
        total = total + 4.0 * x.numel()
    return total * BYTES


def wire_round_bytes(params, method: str = "fedlrt", *, correction: str = "simplified") -> dict:
    """Analytic per-client bytes of the round's *wire-layer data plane*:
    exactly what :func:`repro_torch.core.round.run_round` transmits under
    the identity codec, per direction, each tensor at its own element size.

    - ``down``: the shared broadcast plus the client's per-client slice: for
      FeDLRT the augmented factors ``Ū, S̃, V̄`` (+ their rank counters) and,
      under correction, the ``2r̂ × 2r̂`` correction block per factor; for
      the dense baselines the global weights (+ FedLin's correction slice).
    - ``up``: FeDLRT's coefficient blocks (+ dense leaves and the drift
      scalar), a dense baseline's full weights.

    The measured ``wire_bytes_{down,up}_per_client`` of the identity codec
    equal these exactly: for an f32 tree the paper's f32 accounting, for a
    tree of mixed dtypes (a bf16 round: f32 bases, a bf16 S̃ and bf16
    dense leaves; a correction block and a client's update take their S's
    and their leaf's dtype) the bytes the identity codec sends.
    :func:`fedlrt_round_comm_bytes` prices the paper's multi-message
    protocol instead.
    """
    fbytes = [
        (math.prod(f.U.shape[:-2]), f.n_in, f.n_out, f.r_max, f.rank.numel() * f.rank.element_size(),
         f.U.element_size(), f.S.element_size())
        for f in _factor_leaves(params)
    ]
    dense = sum(x.numel() * x.element_size() for x in _dense_leaves(params))
    if method.startswith("fedlrt_naive") or method == "naive":
        (stack, n_in, n_out, r, rank_b, ub, sb), = fbytes  # single-factor setting
        down = (n_in + n_out) * r * ub + r * r * sb + rank_b
        up = (n_in + n_out) * 2 * r * ub + 4 * r * r * sb
        return {"down": down, "up": up}
    if method.startswith("fedlrt"):
        aug = sum(
            stack * ((n_in + n_out) * 2 * r * ub + 4 * r * r * sb) + rank_b
            for stack, n_in, n_out, r, rank_b, ub, sb in fbytes
        )
        coeff = sum(stack * 4 * r * r * sb for stack, _, _, r, _, _, sb in fbytes)
        down = aug + dense
        if correction in ("simplified", "full"):
            down += coeff + dense  # per-client correction slice
        up = coeff + dense + BYTES  # + the drift diagnostic scalar (f32)
        return {"down": down, "up": up}
    if method in ("fedavg", "fedlin"):
        total = sum(x.numel() * x.element_size() for x in tree_leaves(params))
        return {"down": total * (2 if method == "fedlin" else 1), "up": total}
    raise ValueError(f"unknown method {method!r}")


def dense_round_comm_bytes(params, method: str = "fedlin") -> int:
    """FedAvg (2×) / FedLin (4×) full-weight bytes for a dense tree."""
    mult = {"fedavg": 2, "fedlin": 4}[method]
    return mult * sum(x.numel() for x in tree_leaves(params)) * BYTES


def round_total_comm_bytes(params, method: str = "fedlrt", *, correction: str = "simplified",
                           cohort_size: int) -> int:
    """Total server-side on-wire bytes of one round: the per-client volume
    times the *active cohort* (under uniform-k sampling a round costs k/C
    of the full-participation round)."""
    if method.startswith("fedlrt"):
        per_client = fedlrt_round_comm_bytes(params, correction)
    else:
        per_client = dense_round_comm_bytes(params, method)
    return per_client * cohort_size


def client_flops_per_local_step(params, batch_tokens: int) -> float:
    """Forward + backward matmul FLOPs of the factor leaves per local step:
    fwd 2·b(n_in·r + r² + r·n_out), bwd ≈ 2× fwd."""
    total = 0.0
    for f in _factor_leaves(params):
        r = f.r_max
        total += 6.0 * batch_tokens * (f.n_in * r + r * r + r * f.n_out)
    return total


def client_step_flops(params, batch_tokens: int) -> float:
    """Fwd + bwd matmul FLOPs of one local step over the *whole* tree: the
    factor leaves, plus the dense 2-D leaves priced as full matmuls (fwd
    ``2·b·n·m``, bwd ≈ 2× fwd). Vectors and scalars are free."""
    total = client_flops_per_local_step(params, batch_tokens)
    for x in _dense_leaves(params):
        if getattr(x, "ndim", 0) >= 2:
            total += 6.0 * batch_tokens * math.prod(x.shape[-2:])
    return total


def lowrank_decode_flops(n_in: int, n_out: int, r: int, *, gather: bool = False) -> float:
    """Per-token matmul FLOPs of one factor-resident linear in the decode
    path: ``2(n_in·r + r² + r·n_out)``; ``gather=True`` prices an embedding
    factor, whose U row is gathered, not multiplied."""
    flops = 2.0 * (r * r + r * n_out)
    if not gather:
        flops += 2.0 * n_in * r
    return flops


def dense_decode_flops(n_in: int, n_out: int, *, gather: bool = False) -> float:
    """Per-token FLOPs of the same linear once ``U S Vᵀ`` is materialized:
    ``2·n_in·n_out``, or zero for an embedding (a pure gather)."""
    return 0.0 if gather else 2.0 * n_in * n_out


def factor_storage_bytes(params) -> int:
    return sum(
        (f.U.numel() + f.S.numel() + f.V.numel()) * f.U.element_size()
        for f in _factor_leaves(params)
    )
