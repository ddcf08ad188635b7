"""Synthetic data generators (a copy of the JAX package's
``repro.data.synthetic``: plain numpy, so the port yields the same data,
bit for bit, from the same seed).

Every experiment runs on generated data:

- :func:`make_homogeneous_lsq` / :func:`make_heterogeneous_lsq` — the
  paper's §4.1 convex least-squares problems, reproduced *exactly*
  (Legendre polynomial features, manufactured low-rank target).  These are
  the claim-validation workloads (Figs. 1 and 4).
- :func:`make_classification_data` — Gaussian-blob classification with a
  planted low-rank decision map: the CV-proxy for the Fig.-5 comparison
  (FeDLRT vs FedAvg/FedLin accuracy vs client count).
- :func:`make_token_stream` — Markov-chain language-modeling tokens with a
  planted low-rank transition structure, used by the LM examples and the
  100M-parameter end-to-end training example.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def legendre_basis(x: np.ndarray, n: int, *, normalized: bool = True) -> np.ndarray:
    """Evaluate Legendre polynomials P_0..P_{n-1} at ``x`` — shape (N, n).

    ``normalized=True`` rescales to the orthonormal basis on L²([-1,1])
    (``√((2k+1)/2)·P_k``); this leaves the problem class of §4.1 unchanged
    but makes the quadratic well-conditioned so gradient descent converges
    at the paper's reported pace.
    """
    out = np.zeros(x.shape + (n,), dtype=np.float32)
    out[..., 0] = 1.0
    if n > 1:
        out[..., 1] = x
    for k in range(1, n - 1):
        out[..., k + 1] = ((2 * k + 1) * x * out[..., k] - k * out[..., k - 1]) / (
            k + 1
        )
    if normalized:
        out *= np.sqrt((2 * np.arange(n) + 1) / 2.0).astype(np.float32)
    return out


@dataclasses.dataclass
class LeastSquaresProblem:
    """One federated least-squares instance (paper §4.1).

    ``px[c], py[c]`` are Legendre features of client ``c``'s samples and
    ``target[c]`` the manufactured function values; ``W_star`` the global
    minimizer (the manufactured rank-r matrix for the homogeneous case,
    the average of per-client targets for the heterogeneous one).
    """

    px: np.ndarray  # (C, N_c, n)
    py: np.ndarray  # (C, N_c, n)
    target: np.ndarray  # (C, N_c)
    W_star: np.ndarray  # (n, n)
    n: int
    rank_star: int


def _random_lowrank(rng: np.random.Generator, n: int, r: int) -> np.ndarray:
    a = rng.standard_normal((n, r)).astype(np.float32)
    b = rng.standard_normal((n, r)).astype(np.float32)
    return (a @ b.T) / np.sqrt(n)


def make_homogeneous_lsq(
    *, n: int = 20, rank: int = 4, num_points: int = 10_000, num_clients: int = 4, seed: int = 0
) -> LeastSquaresProblem:
    """Paper §4.1 homogeneous test: shared target, data split across clients."""
    rng = np.random.default_rng(seed)
    W_r = _random_lowrank(rng, n, rank)
    x = rng.uniform(-1, 1, size=num_points).astype(np.float32)
    y = rng.uniform(-1, 1, size=num_points).astype(np.float32)
    px, py = legendre_basis(x, n), legendre_basis(y, n)
    t = np.einsum("ni,ij,nj->n", px, W_r, py).astype(np.float32)
    N_c = num_points // num_clients
    sl = lambda a: a[: N_c * num_clients].reshape(num_clients, N_c, *a.shape[1:])
    return LeastSquaresProblem(
        px=sl(px), py=sl(py), target=sl(t), W_star=W_r, n=n, rank_star=rank
    )


def make_heterogeneous_lsq(
    *,
    n: int = 10,
    rank: int = 1,
    num_points: int = 10_000,
    num_clients: int = 4,
    seed: int = 0,
    shared_data: bool = False,
) -> LeastSquaresProblem:
    """Paper §4.1 heterogeneous test: per-client rank-1 target functions.

    ``shared_data=True`` reproduces the paper's setup literally (all
    clients see all sample points).  Note that with *identical* client
    features the per-client quadratics share one Hessian, local GD is an
    affine map common to all clients, and plain averaging converges to the
    global minimizer even without correction; the drift plateau of Fig. 1
    requires heterogeneous curvature.  The default therefore samples each
    client its *own* points (still uniform on [-1,1]²) — heterogeneous
    Hessians, visible client drift, correction provably needed (this is
    also FedLin's own experimental regime).

    ``W_star`` is the exact global minimizer from the normal equations of
    the pooled problem.
    """
    rng = np.random.default_rng(seed)
    # Per-client targets = common low-rank base + *zero-mean* rank-`rank`
    # perturbations (paired ±Δ).  Heterogeneity (and hence client drift) is
    # as strong as fully independent targets, but the pooled minimizer stays
    # essentially the low-rank base, so convergence-to-W* is measurable on
    # the rank-constrained manifold.
    W_base = _random_lowrank(rng, n, rank + 1)
    deltas = []
    for _ in range(num_clients // 2):
        d = _random_lowrank(rng, n, rank)
        deltas += [d, -d]
    if len(deltas) < num_clients:
        deltas.append(np.zeros((n, n), dtype=np.float32))
    W_c = np.stack([W_base + d for d in deltas[:num_clients]])
    px_c, py_c, t_c = [], [], []
    for c in range(num_clients):
        if shared_data and c > 0:
            px_c.append(px_c[0])
            py_c.append(py_c[0])
        else:
            x = rng.uniform(-1, 1, size=num_points).astype(np.float32)
            y = rng.uniform(-1, 1, size=num_points).astype(np.float32)
            px_c.append(legendre_basis(x, n))
            py_c.append(legendre_basis(y, n))
        t_c.append(
            np.einsum("ni,ij,nj->n", px_c[c], W_c[c], py_c[c]).astype(np.float32)
        )
    px_a, py_a, t_a = np.stack(px_c), np.stack(py_c), np.stack(t_c)
    # exact global minimizer: vec(W) solves the pooled normal equations
    feats = np.einsum("cni,cnj->cnij", px_a, py_a).reshape(-1, n * n)
    w_vec, *_ = np.linalg.lstsq(feats, t_a.reshape(-1), rcond=None)
    W_star = w_vec.reshape(n, n).astype(np.float32)
    return LeastSquaresProblem(
        px=px_a,
        py=py_a,
        target=t_a,
        W_star=W_star,
        n=n,
        rank_star=min(rank * num_clients, n),
    )


def make_classification_data(
    *,
    dim: int = 64,
    num_classes: int = 10,
    rank: int = 6,
    num_points: int = 8_192,
    noise: float = 0.35,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Features + labels with a planted low-rank linear decision map.

    ``logits = x @ (A B) + centers``; labels = argmax.  An MLP head needs a
    rank-≈``rank`` first layer to solve it — giving FeDLRT's rank adaption
    something real to find (Fig.-5-style CV proxy).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dim, rank)).astype(np.float32) / np.sqrt(dim)
    B = rng.standard_normal((rank, num_classes)).astype(np.float32)
    x = rng.standard_normal((num_points, dim)).astype(np.float32)
    logits = x @ A @ B + noise * rng.standard_normal((num_points, num_classes))
    labels = np.argmax(logits, axis=-1).astype(np.int32)
    return x, labels


#: bytes the dense route's three float64 vocab x vocab tables may take each
#: (logits, probabilities, cumulative sums); a larger vocabulary takes the
#: rows route, which forms one row of each per token
DENSE_TABLE_BUDGET = 1 << 30


def make_token_stream(
    *,
    vocab_size: int = 512,
    num_tokens: int = 262_144,
    rank: int = 16,
    temperature: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Markov token stream with a planted low-rank transition matrix.

    Transition logits ``T = A Bᵀ`` (rank ``rank``): a model with enough
    effective rank can drive cross-entropy towards the chain's conditional
    entropy, so LM training on this stream shows genuine loss descent.

    The JAX package forms ``T`` and its softmax and cumulative sums as
    ``vocab × vocab`` tables (float64 under numpy's promotion rules: 185 GB
    each at Qwen2's 152,064 tokens). Up to :data:`DENSE_TABLE_BUDGET` bytes
    a table this does the same; above it, it builds the row of the current
    token only, with the same operations in the same order, so the two
    routes give the same tokens.
    """
    route = _token_stream_dense if vocab_size**2 * 8 <= DENSE_TABLE_BUDGET else _token_stream_rows
    return route(vocab_size=vocab_size, num_tokens=num_tokens, rank=rank,
                 temperature=temperature, seed=seed)


def _token_stream_dense(*, vocab_size, num_tokens, rank, temperature, seed) -> np.ndarray:
    """The JAX package's code: every row of the chain's tables at once."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((vocab_size, rank)).astype(np.float32)
    B = rng.standard_normal((vocab_size, rank)).astype(np.float32)
    logits = (A @ B.T) / (np.sqrt(rank) * temperature)
    logits -= logits.max(axis=-1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=-1, keepdims=True)
    cdf = np.cumsum(probs, axis=-1)
    tokens = np.empty(num_tokens, dtype=np.int32)
    tok = int(rng.integers(vocab_size))
    u = rng.random(num_tokens)
    for i in range(num_tokens):
        tok = int(np.searchsorted(cdf[tok], u[i]))
        tokens[i] = min(tok, vocab_size - 1)
    return tokens


def _token_stream_rows(*, vocab_size, num_tokens, rank, temperature, seed) -> np.ndarray:
    """The dense route one row at a time: the same draws in the same order,
    and each row by the same operations. The row's product takes two copies
    of ``A[tok]`` so that it runs through the same matrix-matrix product as
    ``A @ Bᵀ`` (a one-row product is a matrix-vector product, which sums in
    another order); each entry of a product of two or more rows then matches
    the dense table's bit for bit, as the tests hold it."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((vocab_size, rank)).astype(np.float32)
    B = rng.standard_normal((vocab_size, rank)).astype(np.float32)
    Bt = B.T
    tokens = np.empty(num_tokens, dtype=np.int32)
    tok = int(rng.integers(vocab_size))
    u = rng.random(num_tokens)
    for i in range(num_tokens):
        logits = (A[[tok, tok]] @ Bt)[0] / (np.sqrt(rank) * temperature)
        logits -= logits.max(axis=-1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(axis=-1, keepdims=True)
        cdf = np.cumsum(probs, axis=-1)
        tok = int(np.searchsorted(cdf, u[i]))
        tokens[i] = min(tok, vocab_size - 1)
    return tokens
