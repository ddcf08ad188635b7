"""Input stand-ins and their specs for every (arch × input shape), the JAX
package's ``launch/specs.py``.

The stand-ins are ``meta`` tensors: a shape and a dtype, no storage. The
dry run (:mod:`repro_torch.launch.dryrun`) makes fake tensors of them and
lays them out by their specs. The four shapes:

  train_4k     seq 4,096   global_batch 256   → FeDLRT train round
  prefill_32k  seq 32,768  global_batch 32    → serve_prefill
  decode_32k   seq 32,768  global_batch 128   → serve_step (1 new token,
                                                 cache of 32k)
  long_500k    seq 524,288 global_batch 1     → serve_step (sub-quadratic
                                                 archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import batch_axes as _batch_axes
from repro_torch.utils import meshctx
from repro_torch.utils.meshctx import P
from repro_torch.utils.tree import tree_map


def SDS(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (the JAX ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def sanitize_specs(mesh, shapes, specs):
    """Drop sharding on the dims ``mesh`` does not divide (e.g. whisper's
    vocab 51866 on model=16)."""
    return tree_map(lambda s, t: meshctx.fit(s, t.shape, mesh), specs, shapes,
                    is_leaf=meshctx.is_spec)


def shape_applies(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(applies, reason-if-not): the documented skips."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode requires sub-quadratic mixer"
    if cfg.is_encdec and shape.name == "long_500k":
        return False, "enc-dec decoder is full-attention (448-token design)"
    return True, ""


def _extra_inputs(cfg: ModelConfig, B: int, batch_axes) -> Dict[str, Any]:
    """Stub-frontend embeddings (the one sanctioned stub)."""
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = (
            SDS((B, cfg.vision_tokens, cfg.d_model), torch.float32),
            P(batch_axes, None, None),
        )
    if cfg.family == "audio":
        out["frames"] = (
            SDS((B, cfg.encoder.num_frames, cfg.d_model), torch.float32),
            P(batch_axes, None, None),
        )
    return out


def train_specs(cfg: ModelConfig, shape: InputShape, num_clients: int, mesh=None):
    """Client-batched LM batch: tokens (C, B, T+1)."""
    assert shape.global_batch % num_clients == 0
    B = shape.global_batch // num_clients
    T = shape.seq_len
    clients = _batch_axes(mesh) if mesh is not None else ("data",)
    batch = {"tokens": (SDS((num_clients, B, T + 1), torch.int32), P(clients, None, None))}
    for k, (s, spec) in _extra_inputs(cfg, B, None).items():
        batch[k] = (SDS((num_clients,) + tuple(s.shape), s.dtype), P(clients, *spec[1:]))
    # text tokens shrink so that the vision prefix keeps the sequence at T
    if cfg.family == "vlm":
        batch["tokens"] = (
            SDS((num_clients, B, T - cfg.vision_tokens + 1), torch.int32),
            P(clients, None, None),
        )
    return {k: v[0] for k, v in batch.items()}, {k: v[1] for k, v in batch.items()}


def prefill_specs(cfg: ModelConfig, shape: InputShape, mesh=None):
    B, T = shape.global_batch, shape.seq_len
    batch_ax = _batch_axes(mesh) if mesh is not None else ("data",)
    items = {"tokens": (SDS((B, T), torch.int32), P(batch_ax, None))}
    if cfg.family == "vlm":
        items["tokens"] = (SDS((B, T - cfg.vision_tokens), torch.int32), P(batch_ax, None))
    items.update(_extra_inputs(cfg, B, batch_ax))
    return {k: v[0] for k, v in items.items()}, {k: v[1] for k, v in items.items()}


def cache_specs(cfg: ModelConfig, model, B: int, cache_len: int, mesh) -> Tuple[Any, Any]:
    """Stand-ins and specs of the decode cache: the batch on the data axes
    (the cache's sequence dim when the batch is smaller than them), heads
    on "model" where they divide it, else the head dim
    (:func:`repro_torch.models.sharding.cache_spec`)."""
    structs = model.init_cache({"final_norm": SDS((cfg.d_model,), torch.float32)}, B, cache_len)
    return structs, sharding.cache_spec_tree(structs, B, mesh)


def decode_specs(cfg: ModelConfig, model, shape: InputShape, mesh):
    from repro_torch.launch.mesh import data_axis_size

    B = shape.global_batch
    dsize = data_axis_size(mesh)
    batch_ax = _batch_axes(mesh)
    tok_spec = P(batch_ax, None) if B >= dsize else P(None, None)
    cache_len = shape.seq_len if not cfg.sliding_window else min(
        shape.seq_len, cfg.sliding_window
    )
    cstructs, cspecs = cache_specs(cfg, model, B, cache_len, mesh)
    tokens = SDS((B, 1), torch.int32)
    return (cstructs, tokens), (cspecs, tok_spec)
