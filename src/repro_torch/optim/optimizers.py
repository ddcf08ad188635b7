"""Minimal optax-style optimizers over the port's parameter trees (the JAX
package's ``repro.optim.optimizers``).

An :class:`Optimizer` is a pair of functions::

    state = opt.init(params)
    updates, state = opt.update(grads, state, step, params)   # new_p = p + updates

Learning rates may be schedules: functions of the (integer) step.

``sgd(weight_decay=w)`` adds the classic L2 term ``w·p`` to the gradient,
as torch's ``SGD(weight_decay=w)`` does; it needs ``params`` in
``update``. (The JAX package's ``sgd`` accepts ``weight_decay`` and
ignores it; no caller there sets it.)
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_map, tree_zeros_like


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def _as_schedule(lr) -> Callable[[int], float]:
    if callable(lr):
        return lr
    return lambda step: float(lr)


def sgd(lr, *, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """SGD with optional heavy-ball momentum and classic L2 weight decay
    folded into the gradient (torch ``SGD(weight_decay=...)``)."""
    lr_fn = _as_schedule(lr)

    def init(params):
        return () if momentum == 0.0 else tree_zeros_like(params)

    def update(grads, state, step, params=None):
        lam = lr_fn(step)
        if weight_decay:
            if params is None:
                raise ValueError("sgd(weight_decay=...) needs params in update()")
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: -lam * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lam * m, new_m), new_m

    return Optimizer(init=init, update=update)


def adam(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    lr_fn = _as_schedule(lr)

    def init(params):
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params)}

    def update(grads, state, step, params=None):
        lam = lr_fn(step)
        t = float(step) + 1.0
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g), state["v"], grads)
        bc1 = 1.0 - math.pow(b1, t)
        bc2 = 1.0 - math.pow(b2, t)
        upd = tree_map(lambda m_, v_: -lam * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps), m, v)
        return upd, {"m": m, "v": v}

    return Optimizer(init=init, update=update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adam":
        kw.pop("momentum", None)  # adam has its own moments
        return adam(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
