"""Tree helpers over the port's parameter trees.

A tree is nested dicts, lists and tuples whose leaves are tensors (or
scalars). Dataclass instances are interior nodes over their fields, so a
:class:`~repro_torch.core.factorization.LowRankFactor` /
``AugmentedFactor`` holds the leaves ``U, S, V, rank`` (the JAX package
registers them as pytrees the same way). ``None`` is an empty subtree. Dict keys are walked in sorted order, as JAX walks them, so
flattened leaves line up between trees of the same structure.

:class:`Cohort` marks a per-client list: what the JAX package stacks along
a leading client axis, the port keeps as one tree per client, in cohort
order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch


class Cohort(list):
    """One tree per client of the active cohort, in cohort order."""


def _children(node):
    """(kind, keys, children) of an interior node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)) and not isinstance(node, Cohort):
        return type(node), None, list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = [f.name for f in dataclasses.fields(node)]
        return type(node), fields, [getattr(node, f) for f in fields]
    return None


def _rebuild(kind, keys, children):
    if kind == "dict":
        return dict(zip(keys, children))
    if kind in (list, tuple):
        return kind(children)
    return kind(**dict(zip(keys, children)))


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (which share
    its structure); ``is_leaf(node)`` stops the walk at a node."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    kind, keys, children = node
    others = [_children(r)[2] for r in rest]
    return _rebuild(kind, keys, [
        tree_map(fn, c, *(o[i] for o in others), is_leaf=is_leaf)
        for i, c in enumerate(children)
    ])


def tree_map_with_path(fn: Callable, tree, *, is_leaf: Optional[Callable] = None,
                       _path: str = ""):
    """:func:`tree_map` with the leaf's key path as first argument, written
    as ``jax.tree_util.keystr`` writes dict paths (``"['blocks']['pos0']"``)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(_path, tree)
    node = _children(tree)
    if node is None:
        return fn(_path, tree)
    kind, keys, children = node
    paths = (
        [f"{_path}[{k!r}]" for k in keys] if kind == "dict"
        else [f"{_path}[{i}]" if keys is None else f"{_path}.{keys[i]}"
              for i in range(len(children))]
    )
    return _rebuild(kind, keys, [
        tree_map_with_path(fn, c, is_leaf=is_leaf, _path=p)
        for c, p in zip(children, paths)
    ])


def tree_leaves(tree, *, is_leaf: Optional[Callable] = None) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_global_norm(tree) -> torch.Tensor:
    """The f32 2-norm of all leaves together: each leaf's sum of squares,
    added in leaf order."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def cohort_slice(tree, c: int):
    """Client ``c``'s part: item ``c`` of a :class:`Cohort`, row ``c`` of
    every leaf of a client-stacked tree (batches)."""
    if tree is None:
        return None
    if isinstance(tree, Cohort):
        return tree[c]
    return tree_map(lambda a: a[c], tree)


def cohort_size(tree) -> int:
    if isinstance(tree, Cohort):
        return len(tree)
    return len(tree_leaves(tree)[0])


def unzip(cohort: Cohort):
    """A cohort of tuples → a tuple of cohorts."""
    return tuple(Cohort(parts) for parts in zip(*cohort))


def tree_mean_leading_axis(cohort: Cohort):
    """Mean over the cohort, leaf by leaf, summed in cohort order."""
    n = len(cohort)

    def mean(*xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return total / n

    return tree_map(mean, cohort[0], *cohort[1:])

