"""The port's Markov token stream against the JAX package's.

``repro_torch.data.make_token_stream`` picks one of two routes: the JAX
package's dense tables while a float64 ``vocab × vocab`` table fits
``DENSE_TABLE_BUDGET``, and a route that builds the current token's row
only above it (Qwen2's vocabulary of 152,064 would need three tables of
185 GB). Both routes must give the reference's tokens exactly: the same
draws, the same products and the same float64 row operations.
"""
import functools
import tracemalloc

import numpy as np
import pytest

from repro.data import synthetic as jsynthetic
from repro_torch.data import synthetic

#: (vocab, tokens, rank, temperature, seed)
CASES = [
    (512, 20_000, 16, 1.0, 0),
    (512, 20_000, 4, 0.7, 5),
    (512, 20_000, 16, 1.0, 11),
    (8192, 10_000, 16, 1.0, 1),
    (8192, 10_000, 4, 0.5, 2),
]
ROUTES = {"dense": synthetic._token_stream_dense, "rows": synthetic._token_stream_rows}
#: every case on the rows route; the dense route (the JAX package's code)
#: at 512 and once at 8192, where its tables take 1.8 GB
ROUTE_CASES = [("rows", c) for c in CASES] + [("dense", c) for c in CASES[:4]]


@functools.lru_cache(maxsize=None)
def reference_tokens(vocab, n, rank, temperature, seed):
    return jsynthetic.make_token_stream(vocab_size=vocab, num_tokens=n, rank=rank,
                                        temperature=temperature, seed=seed)


@pytest.mark.parametrize("route, case", ROUTE_CASES,
                         ids=["{}-v{}-n{}-r{}-t{}-s{}".format(r, *c) for r, c in ROUTE_CASES])
def test_routes_give_the_reference_tokens(route, case):
    vocab, n, rank, temperature, seed = case
    got = ROUTES[route](vocab_size=vocab, num_tokens=n, rank=rank, temperature=temperature,
                        seed=seed)
    want = reference_tokens(*case)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab, route", [
    (512, "dense"), (11_585, "dense"), (11_586, "rows"), (152_064, "rows"),
])
def test_public_function_picks_the_route_by_the_budget(monkeypatch, vocab, route):
    """11,585² float64 entries fit the 1 GiB budget, 11,586² do not."""
    assert (vocab**2 * 8 <= synthetic.DENSE_TABLE_BUDGET) == (route == "dense")
    called = []
    for name in ROUTES:
        monkeypatch.setattr(synthetic, f"_token_stream_{name}",
                            lambda name=name, **kw: called.append((name, kw)) or name)
    kw = dict(vocab_size=vocab, num_tokens=7, rank=4, temperature=0.5, seed=3)
    assert synthetic.make_token_stream(**kw) == route
    assert called == [(route, kw)]


def test_public_function_is_the_reference_below_the_budget():
    case = CASES[1]
    vocab, n, rank, temperature, seed = case
    np.testing.assert_array_equal(
        synthetic.make_token_stream(vocab_size=vocab, num_tokens=n, rank=rank,
                                    temperature=temperature, seed=seed),
        reference_tokens(*case))


def test_rows_route_at_qwen2_vocabulary_forms_no_table():
    """200 tokens at 152,064: numpy's allocations (traced by ``tracemalloc``)
    peak far below one dense table (185 GB) and below the budget; each row
    is the one a many-row product of the same chain gives."""
    vocab, n, rank = 152_064, 200, 16
    tracemalloc.start()
    try:
        tokens = synthetic._token_stream_rows(vocab_size=vocab, num_tokens=n, rank=rank,
                                              temperature=1.0, seed=0)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak <= 64 * 2**20 < synthetic.DENSE_TABLE_BUDGET, f"peak {peak} bytes"
    assert tokens.shape == (n,) and tokens.dtype == np.int32
    assert tokens.min() >= 0 and tokens.max() < vocab
    assert len(np.unique(tokens)) > n // 2  # a chain that moves, not a fixed point

    # the first 32 steps again from one 32-row block of the dense product
    rng = np.random.default_rng(0)
    A = rng.standard_normal((vocab, rank)).astype(np.float32)
    B = rng.standard_normal((vocab, rank)).astype(np.float32)
    first = int(rng.integers(vocab))
    u = rng.random(n)
    prev = np.concatenate([[first], tokens[:31]])
    logits = (A[prev] @ B.T) / (np.sqrt(rank) * 1.0)
    logits -= logits.max(axis=-1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=-1, keepdims=True)
    cdf = np.cumsum(probs, axis=-1)
    again = [min(int(np.searchsorted(cdf[i], u[i])), vocab - 1) for i in range(32)]
    np.testing.assert_array_equal(tokens[:32], again)
