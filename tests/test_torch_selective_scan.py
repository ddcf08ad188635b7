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

The gradient: the backward's plain version
(``ref.selective_scan_bwd_ref``, token by token) against autograd through
the plain loop in f64, within 1e-10 of each gradient's largest entry (dh0
and a given dh_T included); a CPU tensor's gradient is the plain
backward's; on fake tensors a training mixer call at Jamba's full width
takes one forward and one backward custom op, with their FLOP counts, and
the scan saves its inputs and a state every ``SCAN_K`` steps, no (B, T,
d_inner, N) tensor; the sharded branch's gradient on the 2 x 2 mesh.

On the card: the kernel against the plain version on the same inputs, the
new state in bf16 bit for bit and within 1e-5 of its largest entry in f32,
the output within 1e-5 (the sum over the states in another order), at
Jamba's width over 1,100 tokens, at a decode step and at ragged channel and
state counts; a repeated call and a prefix plus steps to the same bits; the
checkpoints the plain version's bits, and the backward kernel within 1e-4
of each gradient's largest entry of the plain backward, the same bits
twice. No JAX here: the file runs on the card as it is.
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
from repro_torch.kernels.selective_scan import (SCAN_BWD_OPS, SCAN_K, SCAN_OPS, selective_scan,
                                                selective_scan_bwd)
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


@pytest.mark.parametrize("N", [16, 3])
def test_plain_backward_is_autograd_through_the_plain_loop(N):
    """f64 (no rounding), B 2, T 37, a ragged 5 channels, from a nonzero
    state: ``selective_scan_bwd_ref`` against ``torch.autograd`` through
    ``selective_scan_ref`` of ``<y, dy> + <h_T, dh_T>``, every gradient (dh0
    too) within 1e-10 of its largest entry; without dh_T, of ``<y, dy>``."""
    ops = [t.double() for t in _inputs(2, 37, 5, N, seed=3)]
    rng = np.random.default_rng(4)
    dy = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    dhT = torch.from_numpy(rng.standard_normal((2, 5, N)))
    for h_weight in (dhT, None):
        leaves = [t.clone().requires_grad_(True) for t in ops]
        y, h = ref.selective_scan_ref(*leaves, torch.float64)
        loss = (y * dy).sum() + (0 if h_weight is None else (h * h_weight).sum())
        want = torch.autograd.grad(loss, leaves)
        got = ref.selective_scan_bwd_ref(*ops, dy, h_weight, torch.float64)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float64
            assert _rel(g, w) <= 1e-10


def test_cpu_gradient_takes_the_plain_backward():
    """With an input that requires a gradient the call is the autograd
    Function; on CPU tensors its forward is the plain loop (the outputs
    unchanged) and its backward the plain backward, bit for bit, with no
    launch."""
    ops = _inputs(2, 21, 6, 16, seed=5)
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 21, 6)).astype(np.float32))
    before = (selective_scan.launches, selective_scan_bwd.launches)
    for dt in (torch.float32, torch.bfloat16):
        leaves = [t.clone().requires_grad_(True) for t in ops]
        y, h = selective_scan(*leaves, dt)
        wy, wh = ref.selective_scan_ref(*ops, dt)
        assert torch.equal(y.detach(), wy) and torch.equal(h.detach(), wh)
        got = torch.autograd.grad(y, leaves, dy)
        want = ref.selective_scan_bwd_ref(*ops, dy, None, dt)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (selective_scan.launches, selective_scan_bwd.launches) == before


def test_the_backward_contract_refuses_what_the_kernel_does_not_take():
    f32 = torch.float32
    ins = [(2, 40, 8), (2, 40, 8), (2, 40, 16), (2, 40, 16), (8, 16)]
    ck, dy, dhT = (2, 3, 8, 16), (2, 40, 8), (2, 8, 16)
    constraints.check_selective_scan(*ins, (2, 8, 16), [f32] * 6, f32, ck, SCAN_K)
    constraints.check_selective_scan_bwd(*ins, ck, dy, dhT, [f32] * 8, torch.bfloat16, SCAN_K)
    constraints.check_selective_scan_bwd(*ins, ck, dy, None, [f32] * 7, f32, SCAN_K)
    with pytest.raises(ValueError, match="checkpoints"):
        constraints.check_selective_scan(*ins, (2, 8, 16), [f32] * 6, f32, (2, 2, 8, 16), SCAN_K)
    with pytest.raises(ValueError, match="K in 1..16"):
        constraints.check_selective_scan(*ins, (2, 8, 16), [f32] * 6, f32, (2, 2, 8, 16), 20)
    with pytest.raises(ValueError, match="required"):
        constraints.check_selective_scan_bwd(*ins, None, dy, dhT, [f32] * 7, f32, SCAN_K)
    with pytest.raises(ValueError, match="dy"):
        constraints.check_selective_scan_bwd(*ins, ck, (2, 39, 8), dhT, [f32] * 8, f32, SCAN_K)
    with pytest.raises(ValueError, match="disagree"):
        constraints.check_selective_scan_bwd(*ins, ck, dy, (2, 8, 15), [f32] * 8, f32, SCAN_K)
    with pytest.raises(TypeError, match="float32"):
        constraints.check_selective_scan_bwd(*ins, ck, dy, dhT, [f32] * 7 + [torch.bfloat16],
                                             f32, SCAN_K)
    meta = [torch.empty(s, device="meta") for s in ins + [(2, 8, 16), ck, dy]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        selective_scan_bwd(*meta[:6], meta[6], meta[7], None, f32)


def test_fake_tensors_train_through_both_custom_ops():
    """Jamba-1.5-Large's layer-0 Mamba mixer at full width (d_inner 16,384,
    N 16) training on fake tensors at B 4, T 128, bf16: one forward and one
    backward custom-op call, with their FLOP counts; the scan saves its f32
    inputs and the state every ``SCAN_K`` steps, 4 (2 BTD + 2 BTN + DN +
    BDN + B⌈T/K⌉DN) bytes (106.0 MB here, a (B, T, d_inner, N) f32 tensor
    being 537 MB), and no tensor of B·T·d_inner·N entries."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), num_layers=8)
    D, _, N, _ = ssm.mamba_dims(cfg)
    B, T = 4, 128
    calls, saved = [], []
    ops = (torch.ops.repro_torch.selective_scan, torch.ops.repro_torch.selective_scan_bwd)

    class Calls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket in ops:
                calls.append(func._overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with FakeTensorMode():
        params, _ = build_model(cfg).init(torch.Generator())
        p = _layer(params["blocks"]["pos0"]["mamba"], 0)
        ins = [torch.empty(s, requires_grad=True) for s in
               [(B, T, D)] * 2 + [(B, T, N)] * 2 + [(D, N), (B, D, N)]]
        with FlopCounterMode(display=False) as flops, \
                torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                         lambda t: t):
            y, _ = selective_scan(*ins, torch.bfloat16)
            grads = torch.autograd.grad(y, ins, torch.empty_like(y))
        x = torch.empty((B, T, cfg.d_model), dtype=torch.bfloat16, requires_grad=True)
        with Calls():
            out, state = ssm.mamba_mix(p, x, cfg)
            gx, = torch.autograd.grad(out.float().sum(), x)
    assert calls == ["selective_scan", "selective_scan_bwd"]
    assert state is None and gx.shape == x.shape
    assert [g.shape for g in grads] == [t.shape for t in ins]
    assert flops.get_total_flops() == (SCAN_OPS + SCAN_BWD_OPS) * B * T * D * N
    nbytes = sum(t.numel() * t.element_size() for t in saved)
    assert nbytes == 4 * (2 * B * T * D + 2 * B * T * N + D * N + B * D * N
                          + B * -(-T // SCAN_K) * D * N)
    assert nbytes < 0.2 * 4 * B * T * D * N
    assert max(t.numel() for t in saved) < B * T * D * N


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


#: the backward kernel against the plain backward on the card, of each
#: gradient's largest entry: the kernel's λ takes one fma where the plain
#: version rounds a product and a sum, and dB, dC and dA sum in another order
CARD_BWD_RTOL = 1e-4


@pytest.mark.cuda
def test_selective_scan_bwd_matches_plain_version_on_card():
    """Runs on an H100 (``pytest -m cuda``): Jamba's width at the training
    round's 4 x 128 tokens, and ragged channel counts, state sizes (1, 5, 9
    and 32: one, two and four lanes a channel) and sequence lengths (the last
    checkpoint segment short), both state types, with and without dh_T:
    the forward's checkpoints are the plain version's bits, each gradient
    within ``CARD_BWD_RTOL`` of its largest entry of the plain backward's,
    and a second call the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    from repro_torch.kernels.selective_scan import _launch_forward

    for B, T, D, N in [(4, 128, 16384, 16), (2, 37, 100, 16), (1, 40, 7, 32), (2, 33, 65, 1),
                       (3, 17, 33, 5), (2, 50, 40, 9)]:
        ops = _inputs(B, T, D, N, seed=B * T + N, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(N)
        dy = torch.randn((B, T, D), generator=g, device="cuda")
        dhT = torch.randn((B, D, N), generator=g, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            y, h, ck = _launch_forward(*ops, dt, True)
            wy, wh, wck = ref.selective_scan_ref(*ops, dt, every=SCAN_K)
            assert torch.equal(ck, wck), (B, T, D, N, dt)
            for d_h in (dhT, None):
                n0 = selective_scan_bwd.launches
                got = selective_scan_bwd(*ops, ck, dy, d_h, dt)
                again = selective_scan_bwd(*ops, ck, dy, d_h, dt)
                torch.cuda.synchronize()
                assert selective_scan_bwd.launches == n0 + 2
                want = ref.selective_scan_bwd_ref(*ops, dy, d_h, dt)
                for a, b, w in zip(got, again, want):
                    assert torch.equal(a, b)
                    assert _rel(a.cpu(), w.cpu()) <= CARD_BWD_RTOL, (B, T, D, N, dt)


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
        # training (no state): the gradients of the scan's every operand,
        # with Bp / Cp partial over the channel split and A over the rows'
        names = ("A_log", "D", "dt_bias", "conv_w")
        c = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (4, 13, cfg.d_model)).astype(np.float32))
        grads = []
        for tree, xin in ((params, x), (dp, rows(x))):
            p = _layer(tree["blocks"]["pos0"]["mamba"], 0)
            leaves = {k: p[k].detach().clone().requires_grad_(True) for k in names}
            s = p["x_proj"].S.detach().clone().requires_grad_(True)
            xg = xin.detach().clone().requires_grad_(True)
            mix = dict(p, **leaves, x_proj=dataclasses.replace(p["x_proj"], S=s))
            with meshctx.implicit_replication():  # as the model's loss runs it
                out, _ = ssm.mamba_mix(mix, xg, cfg)
            cw = c if not isinstance(out, DTensor) else rows(c)
            grads.append([t.full_tensor() if isinstance(t, DTensor) else t for t in
                          torch.autograd.grad((out * cw).sum(), [xg, *leaves.values(), s])])
        for got, want in zip(grads[1], grads[0]):
            assert torch.allclose(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    finally:
        sharding.enable(None)
        dist.destroy_process_group()


def test_the_sharded_state_branch_is_the_unsharded_one(tmp_path):
    """Reduced Jamba's Mamba mixer with a state on a 2 x 2 ("data",
    "model") gloo mesh of four CPU ranks, rows split on ``data`` and
    channels on ``model``: each rank scans its own rows and channels, and
    the output and new state are the unsharded call's, bit for bit; then
    the mixer without a state with gradients (the backward on each rank's
    rows and channels): x's, the dense leaves' and x_proj's S's within 1e-5
    of the unsharded ones' largest entries (their sums over the ranks are
    taken in another order)."""
    import torch.multiprocessing as mp

    mp.spawn(_sharded_mixer, args=(4, str(tmp_path / "store")), nprocs=4)
