"""Load the JAX package's npz checkpoints into the port's parameter tree.

The JAX package stores factor leaves field-wise (``<path>@U/S/V/rank``),
joins nested keys with ``|`` (``"blocks|pos0|attn|q@U"``) and puts a JSON
``__meta__`` beside them. :func:`params_from_numpy` turns such a flat dict
of numpy arrays into the port's tree of tensors and
:class:`~repro_torch.core.factorization.LowRankFactor` leaves, so a model
the JAX engine trained serves or trains on in the port. It takes the trees
of all three tasks: the ``lm`` model's nested dict, the ``mlp`` head's
``{"w1": factor, "b1", "w2", "b2"}``, and the ``lsq`` task's bare root
factor (keys ``"@U"``, …) or bare dense matrix (key ``""``).
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.factorization import LowRankFactor

_SEP = "|"


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
    """Returns (params, meta) from an npz written by the JAX package's
    ``repro.checkpoint.save_checkpoint``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode()) if "__meta__" in flat else {}
    return params_from_numpy(flat, device, dtype), meta
