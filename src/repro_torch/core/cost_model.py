"""Analytic communication counters of a round (the communication part of
the JAX package's ``repro.core.cost_model``; its Table-1 closed forms and
FLOP / decode functions are not ported yet, see ROADMAP.md).

Counts are bytes *per client per round*, f32 on the wire (``BYTES``), as
in the paper's accounting.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.factorization import is_factor
from repro_torch.utils.tree import tree_leaves

BYTES = 4  # f32 on-wire, matching the paper's float accounting


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
    ranks. An f32 scalar; stacked factors sum their per-slice ranks."""
    total = torch.zeros((), dtype=torch.float32)
    for f in _factor_leaves(params):
        r = f.rank.float().cpu()
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
