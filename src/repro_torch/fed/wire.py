"""The wire layer: typed round payloads, pluggable codecs, measured bytes
(the JAX package's ``repro.fed.wire``, in PyTorch).

- :class:`Payload`: one direction's worth of round traffic, a tree of
  tensors plus its protocol name and whether it is per client.
- :class:`WireCodec`: the protocol every wire format implements:
  ``encode(Payload) -> WireMsg``, ``decode(WireMsg) -> Payload``,
  ``nbytes(WireMsg) -> bytes on the wire``.
- :class:`Wire`: the engine-owned object the round runner threads every
  phase-boundary payload through (:func:`repro_torch.core.round.run_round`),
  reporting the measured bytes in the round metrics.

Codecs (:func:`make_codec` spec strings):

==============  =========  =================================================
codec           lossy?     on-wire representation
==============  =========  =================================================
``identity``    no         tensors as they are (bytes = numel × itemsize)
``downcast``    ~eps       floats as bf16 / f16 on the wire, as before at rest
``int8_affine`` bounded    affine int8 per tensor + f32 (lo, scale)
``topk_rank``   no         factor leaves priced at their *effective* rank:
                           only the active columns travel; the zero-inactive-
                           columns invariant makes the zero-padded
                           reconstruction exact
==============  =========  =================================================

A batched payload is a :class:`~repro_torch.utils.tree.Cohort`, one tree per
client, where the JAX package stacks a leading client axis: "per client
slice" there is one tree of the cohort here, and the byte counts are the
same for the same values. Floating leaves of at least
:data:`MIN_COMPRESS_ELEMS` elements per client slice are compressed; smaller
ones (losses, drift, the factor ``rank`` counter) and integer leaves travel
verbatim. ``nbytes`` is a python int, except under ``topk_rank`` where it
follows the ranks: a ``numpy.float32``, summed in f32 as the JAX package
sums it inside its jitted round. The codecs are plain tensor code (the JAX
package has no kernel here).

Under a mesh the leaves are DTensors: ``numel`` counts the global tensor,
int8's range is a DTensor reduction over every shard, and a factor's rank
is read whole, so a payload encodes, decodes and measures as the unsharded
one does. A batched payload there holds the rank's own clients; the round
sums their bytes over the client axes
(:func:`repro_torch.core.round.run_round`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Union, runtime_checkable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.factorization import (
    AugmentedFactor,
    LowRankFactor,
    augmented_mask,
    is_factor,
    mask_coeff,
    rank_mask,
)
from repro_torch.utils.tree import Cohort, tree_leaves, tree_map

Bytes = Union[int, np.float32]

#: leaves below this many elements (per client slice) always pass verbatim
MIN_COMPRESS_ELEMS = 64


@dataclasses.dataclass(frozen=True)
class Payload:
    """One direction's worth of round traffic: ``tensors`` is a tree (factor
    leaves allowed), ``name`` the protocol message (``broadcast`` /
    ``per_client`` / ``client_out``), ``batched`` marks a :class:`Cohort`
    of per-client trees."""

    tensors: Any
    name: str = "payload"
    batched: bool = False


@dataclasses.dataclass(frozen=True)
class WireMsg:
    """An encoded :class:`Payload`: ``buffers`` mirrors the payload with the
    on-wire tensors, ``aux`` holds what decoding needs (dtypes, dequant
    scales), ``nbytes`` the measured size including that metadata."""

    buffers: Any
    aux: Any
    name: str
    batched: bool
    nbytes: Bytes


@runtime_checkable
class WireCodec(Protocol):
    """Wire format: how a payload is serialized and how big it is."""

    name: str

    def encode(self, payload: Payload) -> WireMsg:
        ...

    def decode(self, msg: WireMsg) -> Payload:
        ...

    def nbytes(self, msg: WireMsg) -> Bytes:
        ...


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _slices(payload_tensors, batched: bool):
    """The per-client trees of a payload (one tree when not batched)."""
    if not batched:
        return [payload_tensors]
    if not isinstance(payload_tensors, Cohort):
        raise TypeError(
            f"a batched payload is a Cohort of per-client trees, got "
            f"{type(payload_tensors).__name__}"
        )
    return list(payload_tensors)


def _rebuild(trees, batched: bool):
    return Cohort(trees) if batched else trees[0]


def _compressible(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point() and x.numel() >= MIN_COMPRESS_ELEMS


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def payload_nbytes(tree) -> int:
    """Verbatim (identity-codec) wire size of a payload tree in bytes (a
    :class:`Cohort` counts every client's tree)."""
    trees = list(tree) if isinstance(tree, Cohort) else [tree]
    return int(sum(_nbytes(x) for t in trees for x in tree_leaves(t)))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


class IdentityCodec:
    """Tensors travel verbatim: the reference point every codec is measured
    against, and the engine default (measured accounting, no loss)."""

    name = "identity"

    def encode(self, payload: Payload) -> WireMsg:
        return WireMsg(buffers=payload.tensors, aux=None, name=payload.name,
                       batched=payload.batched, nbytes=payload_nbytes(payload.tensors))

    def decode(self, msg: WireMsg) -> Payload:
        return Payload(tensors=msg.buffers, name=msg.name, batched=msg.batched)

    def nbytes(self, msg: WireMsg) -> Bytes:
        return msg.nbytes


def _float_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"downcast needs a floating dtype name, got {name!r}")
    return dt


class DowncastCodec:
    """Floats cross the wire at a narrower dtype and are restored to their
    rest dtype on arrival."""

    def __init__(self, wire_dtype=torch.bfloat16):
        self.wire_dtype = _float_dtype(wire_dtype) if isinstance(wire_dtype, str) else wire_dtype
        self.name = f"downcast:{str(self.wire_dtype).removeprefix('torch.')}"

    def encode(self, payload: Payload) -> WireMsg:
        wire_dt = self.wire_dtype
        wire_size = torch.empty((), dtype=wire_dt).element_size()

        def enc(x):
            if _compressible(x) and x.element_size() > wire_size:
                return x.to(wire_dt)
            return x

        trees = _slices(payload.tensors, payload.batched)
        dtypes = [tree_map(lambda x: x.dtype if torch.is_tensor(x) else None, t) for t in trees]
        buffers = _rebuild([tree_map(enc, t) for t in trees], payload.batched)
        return WireMsg(buffers=buffers, aux=dtypes, name=payload.name,
                       batched=payload.batched, nbytes=payload_nbytes(buffers))

    def decode(self, msg: WireMsg) -> Payload:
        trees = _slices(msg.buffers, msg.batched)
        out = [
            tree_map(lambda x, dt: x.to(dt) if torch.is_tensor(x) else x, t, dts)
            for t, dts in zip(trees, msg.aux)
        ]
        return Payload(tensors=_rebuild(out, msg.batched), name=msg.name, batched=msg.batched)

    def nbytes(self, msg: WireMsg) -> Bytes:
        return msg.nbytes


class Int8AffineCodec:
    """Affine int8 quantization with f32 dequant scales, per tensor and per
    client slice.

    ``scale = max((hi − lo)/255, tiny)``, ``q = clip(round((x − lo)/scale)
    − 128, −128, 127)``, so the absolute dequantization error is at most
    ``scale/2`` per element. The 8 bytes of (lo, scale) of every quantized
    tensor slice are charged to ``nbytes``.
    """

    name = "int8_affine"
    _TINY = float(torch.finfo(torch.float32).tiny)

    def _encode_tree(self, tree):
        """``(int8 tree, per-leaf aux in walk order, nbytes)`` of one slice."""
        nbytes = 0
        aux = []

        def enc(x):
            nonlocal nbytes
            if not _compressible(x):
                nbytes += _nbytes(x)
                aux.append(None)
                return x
            lo, hi = torch.amin(x), torch.amax(x)
            # (hi − lo)/255 in x's dtype, then f32, as the JAX package
            scale = torch.clamp_min(((hi - lo) / 255.0).float(), self._TINY)
            q = torch.clamp(torch.round((x - lo).float() / scale) - 128.0, -128, 127)
            aux.append((lo.float(), scale, x.dtype))
            nbytes += x.numel() + 2 * 4  # int8 payload + f32 (lo, scale)
            return q.to(torch.int8)

        return tree_map(enc, tree), aux, nbytes

    def encode(self, payload: Payload) -> WireMsg:
        trees = _slices(payload.tensors, payload.batched)
        enc = [self._encode_tree(t) for t in trees]
        return WireMsg(
            buffers=_rebuild([e[0] for e in enc], payload.batched),
            aux=[e[1] for e in enc], name=payload.name, batched=payload.batched,
            nbytes=sum(e[2] for e in enc),
        )

    def decode(self, msg: WireMsg) -> Payload:
        out = []
        for tree, aux in zip(_slices(msg.buffers, msg.batched), msg.aux):
            it = iter(aux)

            def dec(q):
                a = next(it)
                if a is None:
                    return q
                lo, scale, dtype = a
                return ((q.float() + 128.0) * scale + lo).to(dtype)

            out.append(tree_map(dec, tree))
        return Payload(tensors=_rebuild(out, msg.batched), name=msg.name, batched=msg.batched)

    def nbytes(self, msg: WireMsg) -> Bytes:
        return msg.nbytes


class TopKRankCodec:
    """Transmit only the active columns of factor leaves.

    Columns of U / V past ``rank`` (for an :class:`AugmentedFactor`, outside
    its ``2·rank`` active directions) and S outside its active block are
    zero by the factor invariant, so a sender that ships only the active
    part loses nothing: the receiver zero-pads back to the buffer. The
    simulation keeps the buffers (re-masked for safety) and *meters* the
    active bytes, which follow the adaptive rank down. Non-factor leaves
    travel verbatim.
    """

    name = "topk_rank"

    def encode(self, payload: Payload) -> WireMsg:
        trees = _slices(payload.tensors, payload.batched)
        nbytes: Bytes = 0
        # leaf-major over the cohort, as the JAX package walks its stacked tree
        per_tree = [tree_leaves(t, is_leaf=is_factor) for t in trees]
        for leaves in zip(*per_tree):
            if not is_factor(leaves[0]):
                nbytes = nbytes + sum(payload_nbytes(x) for x in leaves)
                continue
            active = np.float32(0)
            ranks = 0
            for f in leaves:
                rank = f.rank.full_tensor() if isinstance(f.rank, DTensor) else f.rank
                cols = rank.float().cpu().numpy().astype(np.float32)
                if isinstance(f, AugmentedFactor):
                    cols = np.float32(2.0) * cols  # active directions
                per_slice = np.float32(f.U.shape[-2] + f.V.shape[-2]) * cols + cols * cols
                active = active + np.sum(per_slice, dtype=np.float32)
                ranks += f.rank.numel()
            itemsize = np.float32(f.U.element_size())
            nbytes = np.float32(nbytes) + itemsize * active
            nbytes = nbytes + np.float32(4 * ranks)  # the rank counters themselves

        def enc(x):
            if isinstance(x, AugmentedFactor):
                m = augmented_mask(x.rank, x.r_max, dtype=x.U.dtype)
            elif isinstance(x, LowRankFactor):
                m = rank_mask(x.rank, x.r_max, dtype=x.U.dtype)
            else:
                return x
            return dataclasses.replace(
                x, U=x.U * m[..., None, :], V=x.V * m[..., None, :], S=mask_coeff(x.S, m),
            )

        buffers = _rebuild([tree_map(enc, t, is_leaf=is_factor) for t in trees], payload.batched)
        return WireMsg(buffers=buffers, aux=None, name=payload.name,
                       batched=payload.batched, nbytes=nbytes)

    def decode(self, msg: WireMsg) -> Payload:
        return Payload(tensors=msg.buffers, name=msg.name, batched=msg.batched)

    def nbytes(self, msg: WireMsg) -> Bytes:
        return msg.nbytes


_CODECS = {
    "identity": IdentityCodec,
    "downcast": DowncastCodec,
    "int8_affine": Int8AffineCodec,
    "topk_rank": TopKRankCodec,
}

CODEC_SPECS = ("identity", "downcast", "downcast:float16", "int8_affine", "topk_rank")


def make_codec(spec: Union[str, WireCodec]) -> WireCodec:
    """Build a codec from a spec string: ``identity`` | ``downcast[:dtype]``
    | ``int8_affine`` | ``topk_rank`` (a built codec passes through)."""
    if not isinstance(spec, str):
        return spec
    kind, _, arg = spec.partition(":")
    if kind not in _CODECS:
        raise ValueError(f"unknown wire codec {spec!r}; expected one of {sorted(_CODECS)}")
    if kind == "downcast":
        return DowncastCodec(arg) if arg else DowncastCodec()
    if arg:
        raise ValueError(f"codec {kind!r} takes no argument, got {spec!r}")
    return _CODECS[kind]()


# ---------------------------------------------------------------------------
# the wire itself
# ---------------------------------------------------------------------------


class Wire:
    """A codec bound to the server↔client boundary. The engine owns one per
    run; :func:`repro_torch.core.round.run_round` threads every
    phase-boundary payload through :meth:`roundtrip`. Stateless across
    rounds."""

    def __init__(self, codec: Union[str, WireCodec] = "identity", telemetry=None):
        self.codec = make_codec(codec)
        # optional TelemetryHub: an enabled one gets encode / decode spans
        # and a bytes counter per roundtrip (only the hier engine's
        # edge-to-cloud wire gets one, as in the JAX package)
        self.telemetry = telemetry

    @property
    def name(self) -> str:
        return self.codec.name

    def roundtrip(self, tree, *, name: str = "payload", batched: bool = False):
        """Encode then decode ``tree``. Returns ``(decoded_tree, nbytes)``:
        what the receiver sees and what the transmission measured. ``None``
        payloads cost nothing and stay ``None``."""
        if tree is None:
            return None, 0
        hub = self.telemetry
        if hub is not None and hub.enabled:
            with hub.span(f"wire.{self.codec.name}.encode", payload=name):
                msg = self.codec.encode(Payload(tensors=tree, name=name, batched=batched))
            with hub.span(f"wire.{self.codec.name}.decode", payload=name):
                decoded = self.codec.decode(msg).tensors
            nbytes = self.codec.nbytes(msg)
            hub.counter(f"wire.{self.codec.name}.bytes", float(nbytes), payload=name)
            return decoded, nbytes
        msg = self.codec.encode(Payload(tensors=tree, name=name, batched=batched))
        return self.codec.decode(msg).tensors, self.codec.nbytes(msg)

    def __repr__(self):
        return f"Wire(codec={self.codec.name!r})"
