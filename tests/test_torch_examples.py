"""The example twins (``examples/torch_*.py``): each one's ``main(argv)``
runs on the CPU at small sizes and prints the summary lines of the JAX
package's example of the same stem; without ``--device cpu`` each asks for
the card."""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TWINS = ("torch_quickstart", "torch_train_llm", "torch_serve_llm", "torch_federated_vision")


def _load(stem):
    spec = importlib.util.spec_from_file_location(f"examples_{stem}", REPO / "examples" / f"{stem}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_finds_the_planted_rank(capsys):
    params = _load("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert int(params.rank) == 4
    assert "target rank: 4" in out
    # the reference's per-round line, at rounds 1, 10, ..., 100
    rows = re.findall(r"^round +(\d+)  loss=\S+  rank=(\d+)  ‖W−W\*‖=\S+  comm=[\d.]+ KB/client$",
                      out, re.M)
    assert [int(t) for t, _ in rows] == [1] + list(range(10, 101, 10))
    assert rows[-1][1] == "4"


def test_train_twin_prints_the_reference_summary(capsys):
    hist = _load("torch_train_llm").main(["--rounds", "2", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 2
    assert "device=cpu" in out
    assert re.search(r"^done: loss [\d.]+ → [\d.]+; total comm [\d.]+ MB measured \[identity\] "
                     r"vs [\d.]+ MB analytic \(mean cohort 4\.0/4\)$", out, re.M), out


def test_serve_twin_trains_then_serves(capsys):
    comps = _load("torch_serve_llm").main(["--device", "cpu", "--requests", "3"])
    out = capsys.readouterr().out
    assert len(comps) == 3 and all(len(c.tokens) == 16 for c in comps)
    assert re.search(r"^trained 2 rounds: loss [\d.]+ → [\d.]+$", out, re.M)
    assert re.search(r"^3 requests, 48 tokens; [\d.]+ tok/s aggregate; per-token latency "
                     r"p50 [\d.]+ ms / p99 [\d.]+ ms$", out, re.M)
    assert "first sequence: [" in out


def test_serve_twin_continuous_matches_static(capsys):
    twin = _load("torch_serve_llm")
    runs = {mode: twin.main(["--device", "cpu", "--skip-train", "--mode", mode])
            for mode in ("continuous", "static")}
    capsys.readouterr()
    tokens = {mode: {c.rid: c.tokens.tolist() for c in comps} for mode, comps in runs.items()}
    assert len(tokens["static"]) == 6
    assert tokens["continuous"] == tokens["static"]


def test_federated_vision_twin_prints_the_reference_table(capsys):
    table = _load("torch_federated_vision").main(
        ["--clients", "8", "--rounds", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(table) == ["fedavg", "fedlin", "fedlrt:none", "fedlrt:simplified"]
    assert "participation=full wire_codec=identity engine=sync" in out
    cell = re.compile(r"^acc=[\d.]+ comm= *[\d.]+MB rank=(-|\d+) cohort=8\.0$")
    for method, (c,) in table.items():
        m = cell.match(c)
        assert m, c
        assert (m.group(1) == "-") == (not method.startswith("fedlrt"))


@pytest.mark.parametrize("stem,argv", [
    ("torch_quickstart", []),
    ("torch_train_llm", ["--rounds", "1"]),
    ("torch_serve_llm", ["--skip-train"]),
    ("torch_federated_vision", ["--clients", "2", "--rounds", "1"]),
])
def test_twins_run_on_the_card_unless_asked_for_the_cpu(stem, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        _load(stem).main(argv)
