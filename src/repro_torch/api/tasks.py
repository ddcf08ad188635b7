"""Task registry: (ModelSpec, DataSpec) → loss, params, batcher, eval — the
JAX package's ``repro.api.tasks`` in PyTorch.

A *task* is everything below the federated layer: the model/loss pair,
its initial parameters, the per-client data pipeline and an optional
holdout evaluation. ``build(spec)`` resolves ``spec.model.kind`` through
this registry, so new workloads plug in with :func:`register_task`.

Built-ins, on the same numpy data as the JAX package's (the port's copy of
``repro.data``):

- ``lm``: a decoder LM from a named preset or the architecture registry,
  on the planted-low-rank Markov token stream, windows split iid.
- ``mlp``: the fig-5-style CV proxy, a 2-layer MLP head whose hidden
  layer is FeDLRT-factorized (for the low-rank methods), on synthetic
  classification data, with a held-out accuracy eval.
- ``lsq``: the paper's §5.1 homogeneous distributed least-squares problem.

Initial values come from a ``torch.Generator`` seeded with ``spec.seed`` on
the run's device: the same seed does not give the JAX package's values
(``jax.random`` is threefry); to start both from the same parameters, pass
``params`` to ``build``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.config import LowRankPolicy, ModelConfig, reduced
from repro_torch.utils.tree import tree_leaves

#: named LM presets (the JAX package's, same values)
PRESETS = {
    # ~100M-param dense decoder for the end-to-end example
    "llm-100m": ModelConfig(
        name="llm-100m", family="dense", num_layers=12, d_model=640,
        num_heads=10, num_kv_heads=10, head_dim=64, d_ff=2560,
        vocab_size=8192, compute_dtype="float32", param_dtype="float32",
        lowrank=LowRankPolicy(rank_frac=0.25, r_cap=160, min_dim=256),
        attn_q_chunk=256,
    ),
    # CPU-feasible demo (~2M params)
    "llm-tiny": ModelConfig(
        name="llm-tiny", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512,
        vocab_size=512, compute_dtype="float32", param_dtype="float32",
        lowrank=LowRankPolicy(rank_frac=0.25, r_cap=32, min_dim=32),
        attn_q_chunk=64,
    ),
}


@dataclasses.dataclass
class Task:
    """A built task: what the engine trains and how it is judged."""

    loss_fn: Callable
    params: object
    batcher: object  # FederatedBatcher
    client_sizes: np.ndarray  # |X_c| per client (weighted aggregation)
    description: str
    eval_fn: Optional[Callable] = None  # params → float (holdout accuracy)


#: kind → (build_fn(spec, device) → Task, compatible data kinds)
_TASKS: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}


def register_task(kind: str, build_fn: Callable, *, data_kinds: Tuple[str, ...],
                  overwrite: bool = False):
    """Register a task family under ``model.kind == kind``:
    ``build_fn(spec, device) → Task``; ``data_kinds`` lists the ``data.kind``
    values it understands (spec validation rejects the others)."""
    if not overwrite and kind in _TASKS:
        raise ValueError(
            f"task kind {kind!r} is already registered (pass overwrite=True to replace it)"
        )
    _TASKS[kind] = (build_fn, tuple(data_kinds))


def task_data_kinds(kind: str) -> Tuple[str, ...]:
    """The data kinds compatible with task ``kind`` (raises for unknown)."""
    if kind not in _TASKS:
        raise ValueError(f"unknown model.kind {kind!r}; registered tasks: {sorted(_TASKS)}")
    return _TASKS[kind][1]


def build_task(spec, device) -> Task:
    return _TASKS[spec.model.kind][0](spec, device)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _partition(partition: str, labels, n: int, clients: int, seed: int):
    from repro_torch.data import partition_dirichlet, partition_iid

    kind, _, arg = partition.partition(":")
    if kind == "iid":
        return partition_iid(n, clients, seed=seed)
    return partition_dirichlet(labels, clients, alpha=float(arg), seed=seed)


def _nll(logits, labels) -> torch.Tensor:
    """Mean negative log-likelihood; the gold entry is read through a
    one-hot mask (a gather's backward scatters with atomics on CUDA)."""
    logp = torch.log_softmax(logits, dim=-1)
    hit = labels[..., None] == torch.arange(logits.shape[-1], device=labels.device)
    return -torch.mean(torch.sum(torch.where(hit, logp, torch.zeros_like(logp)), dim=-1))


# ---------------------------------------------------------------------------
# lm: decoder LM on the Markov token stream (the train CLI's task)
# ---------------------------------------------------------------------------


def lm_model_config(m) -> ModelConfig:
    """Resolve a ModelSpec's lm architecture (preset/arch × smoke × kernels),
    shared by training and serving, so the two agree on shapes."""
    if m.preset is not None:
        if m.preset not in PRESETS:
            raise ValueError(f"unknown preset {m.preset!r}; known: {sorted(PRESETS)}")
        cfg = PRESETS[m.preset]
    else:
        cfg = get_config(m.arch)
    if m.smoke:
        cfg = reduced(cfg)
    if m.kernels != cfg.kernels:
        cfg = dataclasses.replace(cfg, kernels=m.kernels)
    return cfg


def _build_lm(spec, device) -> Task:
    from repro_torch.core.factorization import training_dtypes
    from repro_torch.data import FederatedBatcher, make_token_stream, partition_sizes
    from repro_torch.models import build_model

    m, d = spec.model, spec.data
    cfg = lm_model_config(m)
    model = build_model(cfg)
    with torch.no_grad():
        params = training_dtypes(model.init(_generator(spec.seed, device))[0])
    n_params = sum(x.numel() for x in tree_leaves(params))
    # Markov stream with planted low-rank transitions: a real loss floor
    tokens = make_token_stream(
        vocab_size=cfg.vocab_size,
        num_tokens=spec.fed.clients * d.tokens_per_client,
        rank=d.stream_rank,
        seed=spec.seed,
    )
    T = d.seq
    windows = np.lib.stride_tricks.sliding_window_view(tokens, T + 1)[:: T // 2]
    parts = _partition(d.partition, None, len(windows), spec.fed.clients, spec.seed)
    batcher = FederatedBatcher({"tokens": windows}, parts, batch_size=d.batch, seed=spec.seed)
    return Task(
        loss_fn=model.loss_fn,
        params=params,
        batcher=batcher,
        client_sizes=np.asarray(partition_sizes(parts)),
        description=f"model={cfg.name} params={n_params/1e6:.1f}M",
    )


# ---------------------------------------------------------------------------
# mlp: the fig-5-style CV proxy head
# ---------------------------------------------------------------------------


def _mlp_init(gen: torch.Generator, m, lowrank: bool) -> dict:
    from repro_torch.core.factorization import init_factor

    dev = gen.device
    w1 = (
        init_factor(gen, m.dim, m.hidden, r_max=m.r_max, init_rank=m.r_max)
        if lowrank
        else 0.18 * torch.randn((m.dim, m.hidden), generator=gen, device=dev)
    )
    return {
        "w1": w1,
        "b1": torch.zeros((m.hidden,), device=dev),
        "w2": 0.06 * torch.randn((m.hidden, m.classes), generator=gen, device=dev),
        "b2": torch.zeros((m.classes,), device=dev),
    }


def _mlp_fwd(p, x, kernels: str):
    """First (possibly factorized) layer through the rank bottleneck:
    ``lr_matmul`` takes the kernel chain under a kernel policy, for the
    LowRankFactor and the client loop's AugmentedFactor alike."""
    from repro_torch.core.factorization import is_factor, lr_matmul

    h = lr_matmul(x, p["w1"], kernels=kernels) if is_factor(p["w1"]) else x @ p["w1"]
    h = torch.relu(h + p["b1"])
    return h @ p["w2"] + p["b2"]


def _build_mlp(spec, device) -> Task:
    from repro_torch.data import FederatedBatcher, make_classification_data, partition_sizes

    m, d = spec.model, spec.data
    x, y = make_classification_data(
        dim=m.dim, num_classes=m.classes, rank=d.planted_rank,
        num_points=d.num_points, noise=d.noise, seed=spec.seed,
    )
    if d.holdout:
        xt = torch.from_numpy(x[-d.holdout:]).to(device)
        yt = torch.from_numpy(y[-d.holdout:]).to(device)
        x, y = x[:-d.holdout], y[:-d.holdout]
    else:
        xt = yt = None
    parts = _partition(d.partition, y, len(y), spec.fed.clients, spec.seed)
    batcher = FederatedBatcher({"x": x, "y": y}, parts, batch_size=d.batch, seed=spec.seed)

    kernels = m.kernels
    lowrank = m.lowrank and spec.fed.method.startswith("fedlrt")

    def loss_fn(p, batch):
        return _nll(_mlp_fwd(p, batch["x"], kernels), batch["y"].long())

    eval_fn = None
    if xt is not None:
        def eval_fn(p):
            with torch.no_grad():
                pred = torch.argmax(_mlp_fwd(p, xt, kernels), -1)
            return float(torch.mean((pred == yt).float()))

    return Task(
        loss_fn=loss_fn,
        params=_mlp_init(_generator(spec.seed, device), m, lowrank),
        batcher=batcher,
        client_sizes=np.asarray(partition_sizes(parts)),
        description=(
            f"mlp head {m.dim}→{m.hidden}→{m.classes} "
            f"({'rank≤' + str(m.r_max) if lowrank else 'dense'})"
        ),
        eval_fn=eval_fn,
    )


# ---------------------------------------------------------------------------
# lsq: the §5.1 homogeneous least-squares convergence testbed
# ---------------------------------------------------------------------------


def _build_lsq(spec, device) -> Task:
    from repro_torch.core.factorization import init_factor, is_factor
    from repro_torch.data import FederatedBatcher, make_homogeneous_lsq

    m, d = spec.model, spec.data
    prob = make_homogeneous_lsq(
        n=m.dim, rank=d.planted_rank, num_points=d.num_points,
        num_clients=spec.fed.clients, seed=spec.seed,
    )
    C, N_c = prob.px.shape[0], prob.px.shape[1]
    arrays = {
        "px": prob.px.reshape(-1, prob.px.shape[-1]),
        "py": prob.py.reshape(-1, prob.py.shape[-1]),
        "t": prob.target.reshape(-1),
    }
    # pre-sharded (homogeneous): client c owns rows [c·N_c, (c+1)·N_c)
    parts = [list(range(c * N_c, (c + 1) * N_c)) for c in range(C)]
    batcher = FederatedBatcher(arrays, parts, batch_size=min(d.batch, N_c), seed=spec.seed)

    lowrank = m.lowrank and spec.fed.method.startswith("fedlrt")
    if lowrank:
        params = init_factor(
            _generator(spec.seed, device), m.dim, m.dim,
            r_max=m.r_max, init_rank=m.r_max, spectrum_scale=1.0,
        )
    else:
        params = torch.zeros((m.dim, m.dim), device=device)

    def loss_fn(p, batch):
        if is_factor(p):
            pred = torch.sum(((batch["px"] @ p.U) @ p.S) * (batch["py"] @ p.V), -1)
        else:
            pred = torch.sum((batch["px"] @ p) * batch["py"], -1)
        return 0.5 * torch.mean((pred - batch["t"]) ** 2)

    return Task(
        loss_fn=loss_fn,
        params=params,
        batcher=batcher,
        client_sizes=np.full(C, N_c),
        description=(
            f"homogeneous lsq n={m.dim} rank*={d.planted_rank} "
            f"({'rank≤' + str(m.r_max) if lowrank else 'dense'}, {N_c}/client)"
        ),
    )


register_task("lm", _build_lm, data_kinds=("token_stream",))
register_task("mlp", _build_mlp, data_kinds=("classification",))
register_task("lsq", _build_lsq, data_kinds=("lsq",))
