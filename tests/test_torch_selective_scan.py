"""The selective-scan kernel's wrapper (``repro_torch.kernels.selective_scan``)
and its plain version, on the CPU, and the kernel against the plain version
on the card (``-m cuda``).

The plain version is Mamba's state recurrence token by token, the JAX
package's ``lax.scan`` order; ``tests/test_torch_ssm.py`` holds the mixer's
state branch to the JAX package in f32 and bf16. Here: a CPU tensor takes
the plain version (no launch); a fake tensor takes the custom op
``repro_torch::selective_scan`` once per mixer call, at Jamba-1.5-Large's
full width over a 32,768-token prefill, with its FLOP count; the recurrence
against a numpy loop (f32 within 1e-6 of the largest entry: ``exp`` and
the sum over the states in another library); a prefix of T − 2 tokens then
two one-token calls equal to the whole call bit for bit (one order for
every step); the operand contract's refusals.

On the card: the kernel against the plain version on the same inputs, the
new state in bf16 bit for bit and within 1e-5 of its largest entry in f32,
the output within 1e-5 (the sum over the states in another order), at
Jamba's width over 1,100 tokens, at a decode step and at ragged channel and
state counts; a repeated call and a prefix plus steps to the same bits.
No JAX here: the file runs on the card as it is.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.kernels import constraints, ref
from repro_torch.kernels.selective_scan import SCAN_OPS, selective_scan
from repro_torch.models import build_model, ssm
from repro_torch.models.transformer import _layer
from torch_threads import one_intra_op_thread  # noqa: F401


def _inputs(B, T, D, N, seed=0, device="cpu"):
    """delta > 0 (a softplus output), x, B, C, A < 0 and a state, f32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    arrays = (np.log1p(np.exp(rng.standard_normal((B, T, D)) - 1.0)).astype(f),
              rng.standard_normal((B, T, D)).astype(f),
              rng.standard_normal((B, T, N)).astype(f),
              rng.standard_normal((B, T, N)).astype(f),
              -np.exp(rng.uniform(0.0, 2.5, (D, N))).astype(f),
              (0.3 * rng.standard_normal((B, D, N))).astype(f))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _numpy_scan(delta, x, Bp, Cp, A, h0):
    """The f32 recurrence in numpy, token by token."""
    d, xx, b, c, a, h = (t.numpy() for t in (delta, x, Bp, Cp, A, h0))
    h, ys = h.copy(), []
    for t in range(d.shape[1]):
        h = np.exp(d[:, t, :, None] * a) * h + (d[:, t] * xx[:, t])[..., None] * b[:, t, None]
        ys.append(np.sum(h * c[:, t, None], axis=-1))
    return np.stack(ys, 1), h


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_cpu_tensors_take_the_plain_version():
    ops = _inputs(2, 9, 12, 16)
    before = selective_scan.launches
    for dt in (torch.float32, torch.bfloat16):
        y, h = selective_scan(*ops, dt)
        wy, wh = ref.selective_scan_ref(*ops, dt)
        assert y.dtype == h.dtype == torch.float32
        assert y.shape == (2, 9, 12) and h.shape == (2, 12, 16)
        assert torch.equal(y, wy) and torch.equal(h, wh)
    assert selective_scan.launches == before


@pytest.mark.parametrize("N", [16, 5])
def test_plain_version_is_the_sequential_recurrence(N):
    ops = _inputs(2, 23, 10, N, seed=1)
    y, h = ref.selective_scan_ref(*ops, torch.float32)
    wy, wh = _numpy_scan(*ops)
    assert _rel(y, wy) <= 1e-6 and _rel(h, wh) <= 1e-6


@pytest.mark.parametrize("scan_dt", [torch.float32, torch.bfloat16])
def test_a_prefix_then_steps_equals_the_whole_scan(scan_dt):
    """T − 2 tokens, then two one-token calls from the returned state: the
    whole call's output and state, bit for bit."""
    delta, x, Bp, Cp, A, h0 = _inputs(2, 11, 12, 16, seed=2)
    y, h = selective_scan(delta, x, Bp, Cp, A, h0, scan_dt)
    cut = lambda t, a, b: t[:, a:b].contiguous()  # noqa: E731
    ys, st = [], h0
    for a, b in ((0, 9), (9, 10), (10, 11)):
        yi, st = selective_scan(cut(delta, a, b), cut(x, a, b), cut(Bp, a, b), cut(Cp, a, b), A,
                                st, scan_dt)
        ys.append(yi)
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(st, h)


def test_the_contract_refuses_what_the_kernel_does_not_take():
    f32, shapes = torch.float32, [(2, 5, 8), (2, 5, 8), (2, 5, 16), (2, 5, 16), (8, 16),
                                  (2, 8, 16)]
    constraints.check_selective_scan(*shapes, [f32] * 6, torch.bfloat16)
    with pytest.raises(ValueError, match="at most 32|1..32"):
        constraints.check_selective_scan(
            (2, 5, 8), (2, 5, 8), (2, 5, 33), (2, 5, 33), (8, 33), (2, 8, 33), [f32] * 6, f32)
    with pytest.raises(ValueError, match="disagree"):
        constraints.check_selective_scan(*shapes[:4], (8, 15), shapes[5], [f32] * 6, f32)
    with pytest.raises(TypeError, match="float32"):
        constraints.check_selective_scan(*shapes, [torch.bfloat16] + [f32] * 5, f32)
    with pytest.raises(TypeError, match="state dtype"):
        constraints.check_selective_scan(*shapes, [f32] * 6, torch.float16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        selective_scan(*(torch.empty(s, device="meta") for s in shapes), f32)


def test_fake_tensors_take_the_custom_op_at_full_width(monkeypatch):
    """Jamba-1.5-Large's layer-0 Mamba mixer at full width (d_inner
    16,384, N 16) on fake tensors: a 32,768-token prefill from a state and
    one decode step, each one call of the custom op (never the plain loop),
    the shapes right and the FLOP count the op's formula."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), num_layers=8)
    d_inner, _, N, _ = ssm.mamba_dims(cfg)
    calls = []

    class Calls(TorchDispatchMode):  # the custom op's calls, inside the fake mode
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket is torch.ops.repro_torch.selective_scan:
                calls.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(ref, "selective_scan_ref", lambda *a: pytest.fail("the plain loop ran"))
    with FakeTensorMode():
        params, _ = build_model(cfg).init(torch.Generator())
        p = _layer(params["blocks"]["pos0"]["mamba"], 0)
        x = torch.empty((1, 32768, cfg.d_model), dtype=torch.bfloat16)
        state = ssm.mamba_init_state(cfg, 1, torch.bfloat16, "cpu")
        with FlopCounterMode(display=False) as flops:
            selective_scan(*(torch.empty(s) for s in
                             [(1, 32768, d_inner)] * 2 + [(1, 32768, N)] * 2
                             + [(d_inner, N), (1, d_inner, N)]), torch.bfloat16)
        with torch.no_grad(), Calls():
            y, new = ssm.mamba_mix(p, x, cfg, state=state)
            y1, new1 = ssm.mamba_mix(p, x[:, :1], cfg, state=new)
    assert calls == [(1, 32768, d_inner), (1, 1, d_inner)]
    assert y.shape == x.shape and y1.shape == (1, 1, cfg.d_model)
    assert new["h"].shape == new1["h"].shape == (1, d_inner, N)
    assert new["h"].dtype == torch.float32
    assert flops.get_total_flops() == SCAN_OPS * 32768 * d_inner * N


#: kernel against plain version on the card: the output within this share
#: of its largest entry (the sum over the states in another order), the new
#: state the same in bf16 and within it in f32
CARD_RTOL = 1e-5


@pytest.mark.cuda
def test_selective_scan_matches_plain_version_on_card():
    """Runs on an H100 (``pytest -m cuda``): Jamba's width over 2 x 1,100
    tokens, a decode step of 4 rows, ragged channel counts and state sizes
    of 1, 5 and 32 (one warp a channel), both state types; a second call
    and a prefix plus two steps give the first call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    for B, T, D, N in [(2, 1100, 16384, 16), (4, 1, 16384, 16), (3, 37, 100, 16),
                       (2, 70, 33, 5), (1, 40, 7, 32), (2, 33, 65, 1)]:
        ops = _inputs(B, T, D, N, seed=B * T + N, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            n0 = selective_scan.launches
            y, h = selective_scan(*ops, dt)
            torch.cuda.synchronize()
            assert selective_scan.launches == n0 + 1
            wy, wh = ref.selective_scan_ref(*ops, dt)
            assert _rel(y.cpu(), wy.cpu()) <= CARD_RTOL, (B, T, D, N, dt)
            if dt == torch.bfloat16:
                assert torch.equal(h, wh), (B, T, D, N)
            else:
                assert _rel(h.cpu(), wh.cpu()) <= CARD_RTOL, (B, T, D, N)
            y2, h2 = selective_scan(*ops, dt)
            assert torch.equal(y, y2) and torch.equal(h, h2)
            if T > 2:
                delta, x, Bp, Cp, A, h0 = ops
                cut = lambda t, a, b: t[:, a:b].contiguous()  # noqa: E731
                ys, st = [], h0
                for a, b in ((0, T - 2), (T - 2, T - 1), (T - 1, T)):
                    yi, st = selective_scan(cut(delta, a, b), cut(x, a, b), cut(Bp, a, b),
                                            cut(Cp, a, b), A, st, dt)
                    ys.append(yi)
                assert torch.equal(torch.cat(ys, 1), y) and torch.equal(st, h)


def _sharded_mixer(rank, world, store):
    """One rank of :func:`test_the_sharded_state_branch_is_the_unsharded_one`."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import reduced, sharding
    from repro_torch.utils import meshctx

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        cfg = reduced(get_config("jamba-1.5-large-398b"))
        model = build_model(cfg)
        with torch.no_grad():
            params, specs = model.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        x = torch.randn((4, 13, cfg.d_model), generator=g)
        state = {k: 0.3 * torch.randn(v.shape, generator=g)
                 for k, v in ssm.mamba_init_state(cfg, 4, torch.float32, "cpu").items()}
        with torch.no_grad():
            y0, s0 = ssm.mamba_mix(_layer(params["blocks"]["pos0"]["mamba"], 0), x, cfg,
                                   state=state)
        mesh = make_host_mesh(2, 2)
        sharding.enable(mesh)
        dp = sharding.distribute(params, sharding.sanitize(mesh, params, specs), mesh)
        rows = lambda t: distribute_tensor(  # noqa: E731
            t, mesh, meshctx.placements(meshctx.P("data", None, None), mesh))
        with torch.no_grad():
            y1, s1 = ssm.mamba_mix(_layer(dp["blocks"]["pos0"]["mamba"], 0), rows(x), cfg,
                                   state={k: rows(v) for k, v in state.items()})
        # the state stays split: its rows on "data", its channels on "model"
        assert isinstance(s1["h"], DTensor) and s1["h"].placements == (Shard(0), Shard(1))
        whole = [t.full_tensor() for t in (y1, s1["h"], s1["conv"])]
        for got, want in zip(whole, (y0, s0["h"], s0["conv"])):
            assert torch.equal(got, want)
    finally:
        sharding.enable(None)
        dist.destroy_process_group()


def test_the_sharded_state_branch_is_the_unsharded_one(tmp_path):
    """Reduced Jamba's Mamba mixer with a state on a 2 x 2 ("data",
    "model") gloo mesh of four CPU ranks, rows split on ``data`` and
    channels on ``model``: each rank scans its own rows and channels, and
    the output and new state are the unsharded call's, bit for bit."""
    import torch.multiprocessing as mp

    mp.spawn(_sharded_mixer, args=(4, str(tmp_path / "store")), nprocs=4)
