"""Roofline terms of one device's program, counted on its local shards,
the JAX package's ``launch/roofline.py`` for an H100 mesh.

    compute term    = FLOPs_per_device / PEAK_FLOPS
    memory term     = bytes_per_device / HBM_BW
    collective term = Σ_collectives wire_bytes / (bandwidth of the slowest
                      link the collective's group crosses)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis`` and
parses collectives out of the optimized HLO. Here :class:`LocalCounter`
counts them while rank 0's program runs on fake tensors: it is the
``FakeTensorMode`` the program runs under, so it sees every operation
DTensor runs on a local shard (a ``FlopCounterMode`` entered above DTensor
would count the whole, logical product), the functional collectives a
redistribution issues among them. Per operation:

- FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  attention, convolutions; the kernels' custom ops register theirs in
  :mod:`repro_torch.kernels.lowrank_matmul` / ``coeff_grad``);
- bytes: every tensor operand read once and every output written once, for
  every operation that is not a view: no fusion, an upper bound of what a
  fused program moves (XLA's count is after fusion);
- collectives: the ring model of the JAX package (per device: all-reduce
  2·S, all-gather S_out, reduce-scatter S_in, all-to-all S), priced at
  NVLink within an 8-card node and at the inter-node rate once the group
  spans nodes;
- memory: the peak of local bytes alive at once among the tensors the
  program allocated (its outputs included).

Hardware constants: NVIDIA H100 SXM (80GB HBM3, 700 W), from NVIDIA's data
sheets: 989e12 bf16 dense tensor-core FLOP/s, 3.35e12 B/s of HBM; NVLink 4
at 450e9 B/s per direction per card, within an 8-card node (DGX H100);
across nodes 50e9 B/s per card (8 × 400 Gb/s NDR InfiniBand per node, one
per card). The JAX package's 16-wide ``model`` axis takes ranks 16k..16k+15,
two nodes, so its collectives are priced at the inter-node rate; so are
the data axis's (stride 16). The terms are estimates from these constants,
not measurements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per card per direction, NVLink 4
INTER_NODE_BW = 50e9  # bytes/s per card across nodes (400 Gb/s NDR)
NODE_CARDS = 8  # cards one NVLink domain joins

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

#: operations that move no bytes of their own
_NO_BYTES = {"detach", "alias", "empty", "empty_strided", "empty_like", "wait_tensor",
             "_local_scalar_dense", "lift_fresh", "device", "set_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def group_link_bw(group_name: str) -> float:
    """The bandwidth of the slowest link a collective's group crosses: NVLink
    when all its ranks share one node of :data:`NODE_CARDS`, else the
    inter-node rate."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) == 1 else INTER_NODE_BW


class LocalCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that counts what each local operation costs (see
    the module docstring). Operations DTensor runs to infer an output's
    shape (on whole, logical tensors) are not counted."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.reset()
        self._depth = 0
        self._paused = 0

    def reset(self):
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collective_seconds = 0.0
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakValueDictionary()

    def _track(self, out):
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = id(st)
            if self._seen.get(key) is st:
                continue
            n = st.nbytes()
            self._seen[key] = st
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or self._depth or self._paused:
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in _KIND:
            kind = _KIND[name]
            if kind == "all-reduce":
                wire = 2.0 * _nbytes(out)
            elif kind == "reduce-scatter":
                wire = float(_nbytes(args[0]))
            else:
                wire = float(_nbytes(out))
            self.collectives[kind] += wire
            group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
            self.collective_seconds += wire / group_link_bw(group)
            self._track(out)
            return out
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    @contextlib.contextmanager
    def counting(self):
        """Count inside the block only (from zero), leaving out the shape
        inference of DTensor's sharding propagation."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name)
        mode = self

        def paused(*a, **k):
            mode._paused += 1
            try:
                return orig(*a, **k)
            finally:
                mode._paused -= 1

        self.reset()
        setattr(ShardingPropagator, name, paused)
        try:
            yield self
        finally:
            setattr(ShardingPropagator, name, orig)

    def roofline(self) -> "Roofline":
        return Roofline(
            flops_per_device=float(self.flops),
            bytes_per_device=float(self.bytes),
            collective_bytes_per_device=float(sum(self.collectives.values())),
            collectives=dict(self.collectives),
            collective_seconds=self.collective_seconds,
        )


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, float]
    #: Σ wire bytes / link rate of each collective (see the module docstring)
    collective_seconds: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_seconds

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collectives": self.collectives,
        }


def model_flops(cfg, tokens: int, *, backward: bool) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), N = parameters.

    Counts the *factorized* parameters when low-rank is on: the useful work
    of the compressed model. The parameter shapes come from building the
    model on fake tensors."""
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map_with_path

    with FakeTensorMode():
        params, _ = build_model(cfg).init(torch.Generator())
    total = [0]

    def leaf(path, t):
        size = t.numel()
        if "moe" in path and ("'up'" in path or "'down'" in path or "'gate'" in path) \
                and "shared" not in path:
            # routed experts: only top_k / E of them are active per token
            size = size * cfg.moe.top_k // cfg.moe.num_experts
        total[0] += size

    tree_map_with_path(leaf, params)
    mult = 6.0 if backward else 2.0
    return mult * total[0] * tokens
