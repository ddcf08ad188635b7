"""Self-describing npz checkpoints of factorized parameter trees, in the
JAX package's format (``repro.checkpoint.io``).

Factor leaves are stored field-wise (``<path>@U/S/V/rank``), nested keys
are joined with ``|`` (``"blocks|pos0|attn|q@U"``) and a JSON ``__meta__``
rides beside them (round index, method, spec hash). :func:`save_checkpoint`
writes that layout from the port's tree (float32 leaves byte for byte as the
JAX package writes them, bfloat16 leaves as the same 2-byte ``V2`` records);
:func:`params_from_numpy` turns such a flat dict of numpy arrays into the
port's tree of tensors and
:class:`~repro_torch.core.factorization.LowRankFactor` leaves, so a model
one package trained serves or trains on in the other. It takes the trees
of all three tasks: the ``lm`` model's nested dict, the ``mlp`` head's
``{"w1": factor, "b1", "w2", "b2"}``, and the ``lsq`` task's bare root
factor (keys ``"@U"``, …) or bare dense matrix (key ``""``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.factorization import LowRankFactor, is_factor

_SEP = "|"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    """The npz member names of a tree, as the JAX package's ``_flatten``."""
    out = {}
    if is_factor(tree):
        for field in ("U", "S", "V", "rank"):
            out[f"{prefix}@{field}"] = getattr(tree, field)
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + _SEP + str(k) if prefix else str(k)))
        return out
    out[prefix] = tree
    return out


def _numpy(t) -> np.ndarray:
    """A leaf as numpy; bfloat16 as the JAX package writes it, 2-byte
    ``V2`` records of the same bits."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_checkpoint(path: str, params, *, meta: Optional[dict] = None) -> None:
    """Write ``params`` (and the JSON-safe ``meta``) to the npz ``path``,
    atomically: a ``.tmp`` file renamed over the target."""
    flat = {k: _numpy(v) for k, v in _flatten(params).items()}
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8).copy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint_meta(path: str) -> dict:
    """The checkpoint's ``__meta__`` dict alone (npz members are read lazily,
    so the parameters are not loaded): the cheap check before a restore."""
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return {}
        return json.loads(bytes(z["__meta__"]).decode())


def _tensor(a: np.ndarray, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    # bfloat16 arrays reach numpy as 2-byte records (JAX's ml_dtypes type, or
    # raw 'V2' from an npz file); reinterpret their bits
    if a.dtype.itemsize == 2 and a.dtype.kind not in "fiu":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(flat: Dict[str, np.ndarray], device, dtype: Optional[torch.dtype] = None):
    """The port's parameter tree from the JAX package's flattened layout.

    ``dtype`` casts every floating leaf (``None`` keeps the stored types);
    a factor's ``rank`` always stays float32. The buffers are moved
    verbatim: masking here would silently repair, and so hide, a corrupted
    checkpoint.
    """
    factors: Dict[str, dict] = {}
    tree: dict = {}

    def insert(path: str, value):
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for k, v in flat.items():
        if k == "__meta__":
            continue
        if "@" in k:
            base, field = k.rsplit("@", 1)
            factors.setdefault(base, {})[field] = v
        else:
            insert(k, _tensor(v, device, dtype))
    for k, fields in factors.items():
        missing = {"U", "S", "V", "rank"} - set(fields)
        if missing:
            raise ValueError(f"factor {k!r} lacks fields {sorted(missing)}")
        # repro-lint: disable=RPL005 -- a saved factor's leaves restored
        # verbatim: the round that wrote them kept the inactive columns zero
        insert(k, LowRankFactor(
            U=_tensor(fields["U"], device, dtype),
            S=_tensor(fields["S"], device, dtype),
            V=_tensor(fields["V"], device, dtype),
            rank=_tensor(fields["rank"], device, torch.float32),
        ))
    if set(tree) == {""}:  # bare root-level leaf (the lsq task's factor or matrix)
        return tree[""]
    return tree


def load_checkpoint(path: str, *, device, dtype: Optional[torch.dtype] = None) -> Tuple[dict, dict]:
    """Returns (params, meta) from an npz written by :func:`save_checkpoint`
    or by the JAX package's ``repro.checkpoint.save_checkpoint``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode()) if "__meta__" in flat else {}
    return params_from_numpy(flat, device, dtype), meta
