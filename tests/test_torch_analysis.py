"""The port's lint (``repro_torch.analysis``): one violating and one clean
fixture per rule, laid out under ``tmp_path/src/repro_torch/...``; the
dataflow cases of RPL005; RPL009's mutants of the port's ``ops.py``; the
Hopper contract table the wrappers read; suppressions, SARIF, the
baseline gate, ``--fix`` and the CLI; the exit-0 pin on the port's own
tree; and the step-signature audit (the dynamic twin), including the
demonstration that breaking the dropout zero-weight padding is caught."""
from __future__ import annotations

import dataclasses
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import TraceAudit, get_rules, lint_paths, trace_audit
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.core import classify_path, lint_file
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
TWINS = sorted(str(p) for p in (REPO / "examples").glob("torch_*.py"))


def check(tmp_path, rel, code, rule_id):
    """Lint ``code`` placed at ``rel`` (repo-layout-relative) with one rule."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return lint_file(str(path), [r for r in get_rules() if r.id == rule_id])


def test_paths_are_rooted_at_the_port_package(tmp_path):
    info = classify_path(str(tmp_path / "src" / "repro_torch" / "core" / "round.py"))
    assert info.repro == ("repro_torch", "core", "round.py") and info.under("core")
    assert not classify_path(str(tmp_path / "src" / "repro" / "core" / "round.py")).repro


# ---------------------------------------------------------------------------
# per-rule fixtures: positive (violating) and negative (clean)
# ---------------------------------------------------------------------------


def test_rpl001_flags_engine_outside_build(tmp_path):
    bad = check(
        tmp_path, "tools/driver.py",
        """
        from repro_torch.fed import FederatedEngine

        eng = FederatedEngine(loss, params, cfg, method="fedlrt")
        """,
        "RPL001",
    )
    assert [f.rule for f in bad] == ["RPL001"]
    assert "build() seam" in bad[0].message
    # a port module outside the engine homes is flagged too
    bad = check(tmp_path, "src/repro_torch/launch/x.py", "ServeEngine(model, params)\n", "RPL001")
    assert [f.rule for f in bad] == ["RPL001"]


@pytest.mark.parametrize("home", ["api/experiment.py", "fed/engine.py", "fed/sim/engines.py",
                                  "serve/scheduler.py"])
def test_rpl001_allows_the_build_seam(tmp_path, home):
    ok = check(
        tmp_path, f"src/repro_torch/{home}",
        """
        from repro_torch.fed.engine import FederatedEngine

        def build(spec):
            return FederatedEngine(spec.loss, spec.params, spec.cfg)
        """,
        "RPL001",
    )
    assert ok == []


@pytest.mark.parametrize("rel", ["benchmarks/bench_x.py", "examples/torch_x.py",
                                 "src/repro_torch/launch/cli.py"])
def test_rpl002_flags_adhoc_scenario_in_entry_point(tmp_path, rel):
    bad = check(
        tmp_path, rel,
        """
        from repro_torch.core import FedConfig

        cfg = FedConfig(num_clients=4, s_star=4, lr=0.1)
        """,
        "RPL002",
    )
    assert [f.rule for f in bad] == ["RPL002"]


def test_rpl002_library_code_may_assemble_config(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/api/spec.py",
        """
        from repro_torch.core import FedConfig

        def to_fed_config(self):
            return FedConfig(num_clients=self.clients, s_star=4, lr=self.lr)
        """,
        "RPL002",
    )
    assert ok == []


def test_rpl003_flags_nondeterminism_in_library(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/fed/sched.py",
        """
        import time
        import numpy as np
        import torch

        def pick(clients, x):
            t = time.time()
            rng = np.random.default_rng()
            np.random.shuffle(clients)
            for c in {1, 2, 3}:
                pass
            return t
        """,
        "RPL003",
    )
    assert {f.rule for f in bad} == {"RPL003"}
    assert len(bad) == 4  # wall clock, seedless rng, legacy shuffle, set loop


def test_rpl003_flags_torch_global_rng(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/models/init.py",
        """
        import torch

        def draw(x, n):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            a = torch.randn(n, 4)
            b = torch.randint(0, 9, (n,))
            p = torch.randperm(n)
            x.uniform_(-1, 1)
            torch.nn.init.normal_(x)
            g = torch.Generator()
            return a, b, p, torch.rand(n, generator=g)
        """,
        "RPL003",
    )
    msgs = [f.message for f in bad]
    assert len(bad) == 8, msgs
    assert sum("reseeds" in m for m in msgs) == 2
    assert sum("global generator" in m for m in msgs) == 7  # the two seeders + 5 draws
    assert any("never seeded" in m for m in msgs)


def test_rpl003_seeded_and_launch_are_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/fed/sched.py",
        """
        import numpy as np
        import torch

        def pick(clients, seed, x):
            rng = np.random.default_rng(seed)
            g = torch.Generator().manual_seed(seed)
            h = torch.Generator(device=x.device)
            h.manual_seed(seed + 1)
            x.normal_(generator=h)
            return rng.permutation(clients), torch.randn(3, generator=g)
        """,
        "RPL003",
    )
    assert ok == []
    # identical nondeterminism is fine in the launch/ surface
    ok = check(
        tmp_path, "src/repro_torch/launch/cli.py",
        """
        import time
        import torch

        def main():
            torch.manual_seed(0)
            return time.time()
        """,
        "RPL003",
    )
    assert ok == []


def test_rpl003_telemetry_clock_is_the_one_sanctioned_wall_clock(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/telemetry/clock.py",
        """
        import time

        def perf_seconds():
            return time.perf_counter()
        """,
        "RPL003",
    )
    assert ok == []
    bad = check(
        tmp_path, "src/repro_torch/kernels/build.py",
        """
        import time

        def build():
            return time.perf_counter()
        """,
        "RPL003",
    )
    assert len(bad) == 1
    assert "repro_torch.telemetry.clock" in bad[0].hint


HOST_SYNCS = """
import numpy as np
import torch

def step(x: torch.Tensor, f, lr):
    if x.sum() > 0:
        x = x * 2
    y = x * lr
    v = float(y)
    w = y.item()
    rows = x.tolist()
    while y.any():
        y = y - 1
    r = f.rank
    k = int(r)
    host = x.cpu()
    return v, w, rows, k, host
"""


def test_rpl004_flags_host_syncs_in_device_step_modules(tmp_path):
    bad = check(tmp_path, "src/repro_torch/core/stepper.py", HOST_SYNCS, "RPL004")
    msgs = "\n".join(f.message for f in bad)
    # numpy import, if, float(y), .item(), .tolist(), while, int(r), .cpu()
    assert len(bad) == 8, msgs
    assert "host `numpy` imported" in msgs and "`if x.sum() > 0:`" in msgs
    assert "`while y.any():`" in msgs and "`int()`" in msgs
    # kernels/ is a device-step module too; a host module is not
    assert len(check(tmp_path, "src/repro_torch/kernels/k.py", HOST_SYNCS, "RPL004")) == 8
    assert check(tmp_path, "src/repro_torch/fed/engine2.py", HOST_SYNCS, "RPL004") == []


def test_rpl004_metadata_and_host_values_are_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/core/stepper.py",
        """
        import torch

        def step(x: torch.Tensor, lr: float, use_kernels: bool):
            if x.dim() == 3 and x.shape[0] > 1:
                x = x.reshape(-1, x.shape[-1])
            n = int(x.shape[0])
            if use_kernels and torch.cuda.is_available():
                x = x * float(lr)
            if x.dtype == torch.bfloat16 or x.is_contiguous():
                x = x.float()
            return torch.where(x > 0, x, torch.zeros_like(x)), n
        """,
        "RPL004",
    )
    assert ok == []


def test_rpl005_flags_unmasked_factor_write(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/core/update.py",
        """
        import dataclasses

        def apply(f, g, lr):
            S_new = f.S - lr * g
            out = LowRankFactor(U=f.U, S=S_new - 0, V=f.V, rank=f.rank)
            f.U.copy_(g)
            f.S[:, 0] = g[:, 0]
            f.V.index_copy_(0, idx, g)
            f.U.mul_(g)
            return out, dataclasses.replace(f, S=f.S @ g)
        """,
        "RPL005",
    )
    # the constructor, copy_, the subscript store, index_copy_, mul_, replace
    assert len(bad) == 6, [f.message for f in bad]
    assert all(f.rule == "RPL005" for f in bad)


def test_rpl005_mask_in_scope_is_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/core/update.py",
        """
        import dataclasses
        import torch

        def apply(f, g, lr):
            m = rank_mask(f.rank, f.r_max, dtype=f.S.dtype)
            S_new = mask_coeff(f.S - lr * g, m)
            out = LowRankFactor(U=f.U, S=S_new, V=f.V, rank=f.rank)
            f.U.copy_(g * m)
            f.S[:, 0] = torch.zeros_like(g[:, 0])
            f.V.mul_(m)
            keep = torch.arange(f.r_max) < f.rank
            f.U.masked_scatter_(keep, torch.mul(g, keep))
            return out, dataclasses.replace(f, U=(f.U @ g) * m)
        """,
        "RPL005",
    )
    assert ok == []
    # read-only reconstruction (plumbing existing leaves) needs no mask
    ok = check(
        tmp_path, "src/repro_torch/core/reader.py",
        """
        def rewrap(f):
            return LowRankFactor(U=f.U.to(dev).contiguous(), S=f.S.clone(), V=f.V,
                                 rank=f.rank)
        """,
        "RPL005",
    )
    assert ok == []


# ---------------------------------------------------------------------------
# the dataflow tier: path sensitivity
# ---------------------------------------------------------------------------

BRANCH_ONLY_MASKED = """
def apply(f, g, lr, flag):
    m = rank_mask(f.rank, f.r_max, dtype=f.S.dtype)
    S_new = f.S - lr * g
    if flag:
        S_new = mask_coeff(S_new, m)
    return LowRankFactor(U=f.U, S=S_new, V=f.V, rank=f.rank)
"""


def test_rpl005_dataflow_flags_branch_only_mask(tmp_path):
    bad = check(tmp_path, "src/repro_torch/core/update.py", BRANCH_ONLY_MASKED, "RPL005")
    assert len(bad) == 1
    assert "S=" in bad[0].message


def test_rpl005_mask_on_every_branch_is_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/core/update.py",
        """
        def apply(f, g, lr, flag):
            m = rank_mask(f.rank, f.r_max, dtype=f.S.dtype)
            if flag:
                S_new = mask_coeff(f.S - lr * g, m)
            else:
                S_new = torch.zeros_like(f.S)
            return LowRankFactor(U=f.U, S=S_new, V=f.V, rank=f.rank)
        """,
        "RPL005",
    )
    assert ok == []


def test_rpl005_loop_reassignment_is_path_sensitive(tmp_path):
    # masked before the loop, overwritten unmasked inside it: the back edge
    # carries FRESH into the write on the second iteration
    bad = check(
        tmp_path, "src/repro_torch/core/update.py",
        """
        def apply(f, gs, lr):
            m = rank_mask(f.rank, f.r_max, dtype=f.S.dtype)
            S_new = mask_coeff(f.S, m)
            for g in gs:
                out = LowRankFactor(U=f.U, S=S_new, V=f.V, rank=f.rank)
                S_new = S_new - lr * g
            return out
        """,
        "RPL005",
    )
    assert len(bad) == 1


def test_a_core_violation_is_flagged_by_rpl003_rpl004_and_rpl005(tmp_path):
    path = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent(
        """
        import torch

        def step(f, g: torch.Tensor):
            noise = torch.randn(g.shape)
            if g.max() > 1:
                g = g / g.max()
            return LowRankFactor(U=f.U, S=f.S + g @ noise, V=f.V, rank=f.rank)
        """))
    assert {f.rule for f in lint_paths([str(path)])} == {"RPL003", "RPL004", "RPL005"}


def test_rpl006_flags_incomplete_unregistered_codec(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/fed/mycodec.py",
        """
        class HalfCodec:
            def encode(self, payload):
                return payload

            def decode(self, msg, extra):
                return msg
        """,
        "RPL006",
    )
    msgs = "\n".join(f.message for f in bad)
    assert "missing `nbytes()`" in msgs
    assert "decode` signature differs" in msgs
    assert "defines no `name`" in msgs
    assert "never registered" in msgs


def test_rpl006_conforming_codec_is_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/fed/mycodec.py",
        """
        class GoodCodec:
            name = "good"

            def encode(self, payload):
                return payload

            def decode(self, msg):
                return msg

            def nbytes(self, msg):
                return 0

        _CODECS = {"good": GoodCodec()}
        """,
        "RPL006",
    )
    assert ok == []


def test_rpl007_flags_raw_pickle(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/fed/state.py",
        """
        import pickle
        import numpy as np
        import torch

        def load(path, obj):
            with open(path, "rb") as fh:
                a = pickle.load(fh)
            b = np.load(path, allow_pickle=True)
            torch.save(obj, path)
            c = torch.load(path)
            d = torch.load(path, weights_only=False)
            return a, b, c, d
        """,
        "RPL007",
    )
    assert len(bad) == 5, [f.message for f in bad]
    assert all(f.rule == "RPL007" for f in bad)


def test_rpl007_plain_npz_and_weights_only_are_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/fed/state.py",
        """
        import numpy as np
        import torch

        def load(path):
            return np.load(path, allow_pickle=False), torch.load(path, weights_only=True)
        """,
        "RPL007",
    )
    assert ok == []


def test_rpl008_flags_spec_field_nothing_reads(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/api/spec.py",
        """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class FooSpec:
            used: int = 1
            orphan: int = 2

            def __post_init__(self):
                if self.used < 0:
                    raise ValueError("used")
        """,
        "RPL008",
    )
    assert [f.rule for f in bad] == ["RPL008"]
    assert "orphan" in bad[0].message


def test_rpl008_validated_fields_are_clean(tmp_path):
    ok = check(
        tmp_path, "src/repro_torch/api/spec.py",
        """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class FooSpec:
            used: int = 1
            other: int = 2

            def __post_init__(self):
                if self.used < 0 or self.other < 0:
                    raise ValueError("bad")
        """,
        "RPL008",
    )
    assert ok == []


# ---------------------------------------------------------------------------
# RPL009: the static interpreter over the port's kernel path
# ---------------------------------------------------------------------------

OPS = PORT / "kernels" / "ops.py"


def _lint_ops_variant(tmp_path, source: str):
    path = tmp_path / "src" / "repro_torch" / "kernels" / "ops.py"
    path.parent.mkdir(parents=True)
    path.write_text(source)
    return lint_file(str(path), [r for r in get_rules() if r.id == "RPL009"])


def _mutant(old: str, new: str) -> str:
    src = OPS.read_text()
    assert src.count(old) == 1, old
    return src.replace(old, new)


def test_rpl009_shipped_kernels_are_clean(tmp_path):
    assert _lint_ops_variant(tmp_path, OPS.read_text()) == []


def test_rpl009_catches_a_removed_contiguous_statically(tmp_path):
    """The backward's ``Sᵀ`` handed to ``xus`` without its ``.contiguous()``:
    a transposed view the wrapper would refuse on the card. No tensor runs —
    the interpreter rejects it from the contract table alone."""
    bad = _lint_ops_variant(tmp_path, _mutant(
        "dA = xus(dy, V, S.transpose(-1, -2).float().contiguous())",
        "dA = xus(dy, V, S.transpose(-1, -2).float())"))
    assert len(bad) == 1
    assert "xus: operands must be contiguous" in bad[0].message
    assert "dA = xus(dy, V" in OPS.read_text().splitlines()[bad[0].line - 1] or \
        "xus(dy, V, S.transpose" in (tmp_path / "src/repro_torch/kernels/ops.py").read_text() \
        .splitlines()[bad[0].line - 1]


def test_rpl009_column_major_bases_need_the_apply_contiguous(tmp_path):
    """QR's column-major bases reach ``lowrank_apply`` non-contiguous: the
    cases that carry that layout expose a dropped ``U.contiguous()``."""
    bad = _lint_ops_variant(tmp_path, _mutant(
        "x.contiguous(), U.contiguous(), S.contiguous(), V.contiguous()",
        "x.contiguous(), U, S.contiguous(), V.contiguous()"))
    assert bad and all("operands must be contiguous" in f.message for f in bad)
    assert all("colmajor" in f.message or "preset-" in f.message for f in bad)


def test_rpl009_catches_a_backward_that_drops_its_cast(tmp_path):
    """Mixed precision (bf16 operands, S in f32): dropping dS's cast leaves
    a bf16 gradient against an f32 primal."""
    bad = _lint_ops_variant(tmp_path, _mutant(
        "dS = atb(xus(x, U), xus(dy, V)).to(S.dtype)", "dS = atb(xus(x, U), xus(dy, V))"))
    assert len(bad) == 1
    assert "dS in bfloat16 but the primal S is float32" in bad[0].message
    assert "bf16-f32-S" in bad[0].message


def test_rpl009_catches_a_dtype_mismatch_at_the_call(tmp_path):
    bad = _lint_ops_variant(tmp_path, _mutant(
        "dx = avt(dA, U).to(x.dtype)", "dx = avt(dA, U.float()).to(x.dtype)"))
    assert len(bad) == 1
    assert "avt dtypes: A bfloat16, V float32 must match" in bad[0].message


def test_rpl009_reports_lost_coverage_as_a_warning(tmp_path):
    bad = _lint_ops_variant(tmp_path, _mutant(
        "        dy = dy.contiguous()\n        dx = dU = dS = dV = None",
        "        dy = dy.contiguous().half()\n        dx = dU = dS = dV = None"))
    assert bad and all(f.severity == "warning" for f in bad)
    assert "coverage lost" in bad[0].message


# ---------------------------------------------------------------------------
# the Hopper contract table: one table for the lint and the wrappers
# ---------------------------------------------------------------------------


def test_the_wrappers_raise_what_the_table_raises():
    from repro_torch.kernels import constraints
    from repro_torch.kernels.lowrank_matmul import _batched, _check_cuda

    with pytest.raises(ValueError, match="^xus: operands on different devices cuda:1 / cuda:0$"):
        constraints.check_operands("xus", ["cuda:0", "cuda:1"], [True, True], torch.float32)
    t = torch.zeros(4, 3).t()
    with pytest.raises(ValueError, match="^xus: operands must be contiguous$"):
        _check_cuda("xus", t)
    with pytest.raises(TypeError, match=r"^avt: dtype torch.float16 not supported "
                                        r"\(float32 or bfloat16\)$"):
        _check_cuda("avt", torch.zeros(2, 2, dtype=torch.float16))
    with pytest.raises(ValueError, match=r"x must be 2-D or 3-D \(one stack dim\)"):
        _batched(torch.zeros(2, 2, 2, 2), "x")
    constraints.check_xus_dtypes(torch.bfloat16, torch.bfloat16, torch.float32)
    with pytest.raises(TypeError, match=r"^xus dtypes: x bfloat16, U float32, S bfloat16 \(U "
                                        r"must match x; S must match x or be float32\)$"):
        constraints.check_xus_dtypes("bfloat16", "float32", None)
    with pytest.raises(ValueError, match="atb shapes disagree"):
        constraints.check_atb_shapes((3, 8, 4), (3, 7, 5))
    constraints.check_avt_shapes((8, 4), (9, 4))


def test_the_plans_read_the_grid_limits(monkeypatch):
    from repro_torch.kernels import constraints
    from repro_torch.kernels.coeff_grad import atb_plan
    from repro_torch.kernels.lowrank_matmul import avt_plan, xus_plan

    for plan in (xus_plan, avt_plan, atb_plan):
        plan.cache_clear()
    assert avt_plan(40, 512, 640, 160).route == "tiled"
    monkeypatch.setattr(constraints, "GRID_YZ_MAX", 32)
    for plan in (xus_plan, avt_plan, atb_plan):
        plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="grid too large"):
            avt_plan(40, 512, 640, 160)
        with pytest.raises(ValueError, match="grid too large"):
            atb_plan(40, 512, 640, 160)
        with pytest.raises(ValueError, match="grid too large"):
            xus_plan(40, 512, 640, 160, True)
    finally:
        for plan in (xus_plan, avt_plan, atb_plan):
            plan.cache_clear()


# ---------------------------------------------------------------------------
# autofix: --fix applies mechanical repairs; the round trip is a fixpoint
# ---------------------------------------------------------------------------

MUTANT_TREE = {
    "src/repro_torch/fed/sweep.py": """
        import os

        def shards(d):
            return [f for f in os.listdir(d) if f.endswith(".npz")]
        """,
    "src/repro_torch/core/mutant.py": """
        def apply(f, g, lr):
            m = rank_mask(f.rank, f.r_max, dtype=f.S.dtype)
            S_new = f.S - lr * g
            return LowRankFactor(U=f.U, S=S_new, V=f.V, rank=f.rank)
        """,
}


def _seed_mutants(tmp_path):
    paths = []
    for rel, code in MUTANT_TREE.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
        paths.append(str(p))
    return paths


def test_fix_round_trip_is_a_fixpoint(tmp_path):
    paths = _seed_mutants(tmp_path)
    select = ["--select", "RPL003,RPL005"]
    assert lint_main(paths + select) == 1
    assert lint_main(paths + select + ["--fix"]) == 0
    assert "sorted(os.listdir(d))" in (tmp_path / "src/repro_torch/fed/sweep.py").read_text()
    assert "mask_coeff(S_new, m)" in (tmp_path / "src/repro_torch/core/mutant.py").read_text()
    before = {p: Path(p).read_text() for p in paths}
    assert lint_main(paths + select + ["--fix"]) == 0
    assert {p: Path(p).read_text() for p in paths} == before


def test_fix_scaffold_inserts_auditable_suppression(tmp_path):
    p = tmp_path / "src" / "repro_torch" / "fed" / "t.py"
    p.parent.mkdir(parents=True)
    p.write_text("import torch\n\n\ndef a():\n    return torch.randn(3)\n")
    assert lint_main([str(p), "--select", "RPL003", "--fix"]) == 1
    assert lint_main([str(p), "--select", "RPL003", "--fix", "--scaffold"]) == 0
    assert "# repro-lint: disable=RPL003 -- TODO justify:" in p.read_text()
    assert lint_main([str(p), "--select", "RPL003"]) == 0


# ---------------------------------------------------------------------------
# SARIF emission, fingerprint stability, and the baseline gate
# ---------------------------------------------------------------------------


def _t_py(tmp_path, text):
    p = tmp_path / "src" / "repro_torch" / "fed" / "t.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


def test_sarif_log_shape_and_fingerprints(tmp_path):
    from repro_torch.analysis.sarif import fingerprints, to_sarif

    p = _t_py(tmp_path, "import torch\nT0 = torch.rand(2)\n")
    findings = lint_paths([str(p)], select=["RPL003"])
    assert findings
    log = to_sarif(findings, str(tmp_path))
    assert log["version"] == "2.1.0"
    (run,) = log["runs"]
    assert run["tool"]["driver"]["name"] == "repro-torch-lint"
    assert any(r["id"] == "RPL009" for r in run["tool"]["driver"]["rules"])
    (res,) = run["results"]
    assert res["ruleId"] == "RPL003"
    assert res["locations"][0]["physicalLocation"]["artifactLocation"]["uri"] == \
        "src/repro_torch/fed/t.py"
    assert res["fingerprints"]["reproLint/v1"]
    json.dumps(log)
    fp_before = fingerprints(findings, str(tmp_path))
    p.write_text("# a comment pushed everything down\nimport torch\nT0 = torch.rand(2)\n")
    drifted = lint_paths([str(p)], select=["RPL003"])
    assert [f.line for f in drifted] != [f.line for f in findings]
    assert fingerprints(drifted, str(tmp_path)) == fp_before


def test_baseline_grandfathers_old_findings_only(tmp_path):
    from repro_torch.analysis.sarif import diff_baseline, dump_sarif, load_baseline

    p = _t_py(tmp_path, "import torch\nT0 = torch.rand(2)\n")
    old = lint_paths([str(p)], select=["RPL003"])
    baseline_file = tmp_path / "baseline.sarif"
    baseline_file.write_text(dump_sarif(old, str(tmp_path)))
    new, grand = diff_baseline(old, load_baseline(str(baseline_file)), str(tmp_path))
    assert new == [] and len(grand) == len(old)
    p.write_text("import torch\nT0 = torch.rand(2)\nT1 = torch.manual_seed(1)\n")
    now = lint_paths([str(p)], select=["RPL003"])
    new, grand = diff_baseline(now, load_baseline(str(baseline_file)), str(tmp_path))
    assert len(grand) == 1 and len(new) == 1
    assert "manual_seed" in new[0].message


def test_cli_sarif_output_and_baseline_gate(tmp_path, capsys):
    p = _t_py(tmp_path, "import torch\nT0 = torch.rand(2)\n")
    out = tmp_path / "report.sarif"
    assert lint_main([str(p), "--select", "RPL003", "--format", "sarif",
                      "--output", str(out)]) == 1
    assert len(json.loads(out.read_text())["runs"][0]["results"]) == 1
    assert lint_main([str(p), "--select", "RPL003", "--baseline", str(out)]) == 0
    p.write_text("import torch\nT0 = torch.rand(2)\nT1 = torch.manual_seed(1)\n")
    assert lint_main([str(p), "--select", "RPL003", "--baseline", str(out)]) == 1
    capsys.readouterr()
    assert lint_main([str(p), "--scaffold"]) == 2  # requires --fix
    assert lint_main([str(p), "--baseline", str(tmp_path / "nope.sarif")]) == 2


# ---------------------------------------------------------------------------
# suppressions, CLI, and the shipped-tree pin
# ---------------------------------------------------------------------------


def test_inline_and_next_line_suppressions(tmp_path):
    code = """
    import torch

    def a():
        return torch.rand(2)  # repro-lint: disable=RPL003 -- seeded by the caller

    def b():
        # repro-lint: disable=RPL003 -- justification on the
        # line above the statement it governs
        return torch.rand(2)

    def c():
        return torch.rand(2)
    """
    bad = check(tmp_path, "src/repro_torch/fed/t.py", code, "RPL003")
    assert len(bad) == 1  # only c() survives
    assert bad[0].line == textwrap.dedent(code).splitlines().index("def c():") + 2


def test_file_wide_suppression(tmp_path):
    bad = check(
        tmp_path, "src/repro_torch/core/t.py",
        """
        # repro-lint: disable-file=RPL004 -- a host-side helper module
        import numpy as np
        import torch

        def a(x: torch.Tensor):
            return x.item()
        """,
        "RPL004",
    )
    assert bad == []


def test_one_pragma_serves_both_lints(tmp_path):
    """The reference's RPL001 pragma in the port's api/experiment.py: the
    same grammar, so the port's lint honours it on any path."""
    from repro.analysis import lint_paths as reference_lint

    p = tmp_path / "tools" / "t.py"
    p.parent.mkdir(parents=True)
    p.write_text("# repro-lint: disable=RPL001 -- probe\nServeEngine(model, params)\n")
    assert lint_paths([str(p)], select=["RPL001"]) == []
    assert reference_lint([str(p)], select=["RPL001"]) == []
    assert "repro-lint: disable=RPL001" in (PORT / "api" / "experiment.py").read_text()


def test_cli_list_rules_and_exit_codes(tmp_path, capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    listed = [ln.split()[0] for ln in out.splitlines() if ln.startswith("RPL")]
    assert listed == [f"RPL00{i}" for i in range(1, 10)]
    bad = _t_py(tmp_path, "import torch\nT0 = torch.rand(2)\n")
    assert lint_main([str(bad)]) == 1
    assert lint_main([str(bad), "--select", "RPL007"]) == 0
    assert lint_main([str(bad), "--select", "NOPE"]) == 2


def test_shipped_port_tree_is_clean():
    assert TWINS, "no example twins found"
    findings = lint_paths([str(PORT)] + TWINS)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_the_port_lint_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    code = ("import sys, repro_torch.analysis, repro_torch.analysis.rules, "
            "repro_torch.analysis.shapes; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_effective_comm_bytes_stay_on_the_factors_device():
    """The fault RPL004 found in ``core/cost_model.py``: the round's
    effective comm bytes read each rank back with ``.cpu()``, a host sync
    inside the round. They stay on the factors' device now (a meta tensor
    cannot be copied to the host, so the old code raised here), and keep
    their value on the CPU."""
    from repro_torch.core import cost_model, init_factor
    from repro_torch.utils.tree import tree_map

    f = init_factor(torch.Generator().manual_seed(0), 16, 12, r_max=4)
    on_meta = cost_model.fedlrt_round_comm_bytes_effective(
        tree_map(lambda t: t.to("meta"), {"w": f}))
    assert on_meta.device.type == "meta" and on_meta.shape == ()
    r = 4.0  # (16 + 12) r · 3 + r² + 2 r² (simplified) + (2 r)², f32 bytes
    want = ((16 + 12) * r * 3 + r * r + 2 * r * r + (2 * r) ** 2) * 4
    assert float(cost_model.fedlrt_round_comm_bytes_effective({"w": f})) == want


# ---------------------------------------------------------------------------
# the dynamic twin: step signatures per callsite
# ---------------------------------------------------------------------------


@pytest.fixture
def step_signature_audit():
    """Fail the test if any round callsite saw more than one step signature
    (the port's counterpart of the JAX package's ``jit_trace_audit``)."""
    with trace_audit() as audit:
        yield audit
    audit.assert_within_limit()


def _dropout_spec(rounds=6):
    from repro_torch.api import DataSpec, ExperimentSpec, FedSpec, ModelSpec, ParticipationSpec

    return ExperimentSpec(
        name="trace-audit-dropout", seed=3, rounds=rounds, log_every=0,
        model=ModelSpec(kind="lsq", dim=12, r_max=6),
        data=DataSpec(kind="lsq", num_points=240, planted_rank=3, batch=40, holdout=0),
        fed=FedSpec(method="fedlrt", correction="full", clients=6, local_steps=2,
                    lr=0.05, tau=0.1, eval_after=False),
        participation=ParticipationSpec(mode="dropout", dropout_prob=0.4),
    )


def test_dropout_padding_keeps_one_signature(step_signature_audit):
    from repro_torch.api import build

    hist = build(_dropout_spec(), device="cpu").run()
    assert len({r.cohort_size for r in hist}) >= 2, "dropout drew a constant cohort"
    assert step_signature_audit.total() == 1
    assert step_signature_audit.violations() == []
    ((site, n),) = step_signature_audit.counts.items()
    assert site[0].endswith("engine.py") and n == 1


def test_broken_dropout_padding_is_caught(monkeypatch):
    from repro_torch.api import build
    from repro_torch.fed.participation import Participation

    monkeypatch.setattr(Participation, "padded_size", lambda self, num_clients: None)
    with trace_audit() as audit:
        hist = build(_dropout_spec(), device="cpu").run()
    sizes = {r.cohort_size for r in hist}
    assert len(sizes) >= 2, "dropout drew a constant cohort"
    ((site, n),) = audit.violations()
    assert n == len(sizes)  # one signature per distinct cohort size
    assert "engine.py" in site[0]
    with pytest.raises(AssertionError, match="signature audit failed"):
        audit.assert_within_limit()


def test_trace_audit_counts_per_callsite_and_restores_the_registry():
    from repro_torch.core import FedConfig, init_factor
    from repro_torch.fed import engine

    before = dict(engine.ROUND_METHODS)
    params = init_factor(torch.Generator().manual_seed(0), 8, 8, r_max=2)
    cfg = FedConfig(num_clients=2, s_star=1, lr=0.1)

    def loss(f, b):
        return torch.mean((b["x"] @ f.U @ f.S @ f.V.T) ** 2)

    def batch(n):
        return {"x": torch.from_numpy(np.ones((2, n, 8), np.float32))}

    with trace_audit() as audit:
        rf = engine.ROUND_METHODS["fedlrt"]
        for n in (4, 4, 5):  # one callsite: a repeat, then a new batch shape
            rf(loss, params, batch(n), cfg)
        rf(loss, params, batch(4), dataclasses.replace(cfg))  # another callsite
    assert audit.total() == 3 and sorted(audit.counts.values()) == [1, 2]
    assert len(audit.violations()) == 1 and audit.limit == 1
    audit.limit = 2
    assert audit.violations() == []
    assert engine.ROUND_METHODS == before
    assert isinstance(audit, TraceAudit)


def test_trace_audit_publishes_to_the_hub():
    from repro_torch.telemetry import TelemetryHub
    from repro_torch.telemetry.sinks import MemorySink

    audit = TraceAudit()
    audit.record(("engine.py", 246, "fedlrt_round"), (4, True, ()))
    audit.record(("engine.py", 246, "fedlrt_round"), (3, True, ()))
    sink = MemorySink()
    audit.publish(TelemetryHub([sink]))
    (ev,) = [e for e in sink.events if e.get("name") == "jit.traces"]
    assert ev["value"] == 2.0 and ev["attrs"] == {"site": "engine.py:246", "fn": "fedlrt_round"}
