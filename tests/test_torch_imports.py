"""The port stands alone: no file under ``src/repro_torch/``, no example
twin (``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX or the
JAX package, and the port's entry points never fall back to the CPU on
their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec, serve
from repro_torch.launch import serve as launch_serve

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py"))
              + sorted((REPO / "examples").glob("torch_*.py")) + [REPO / "chip_smoke.py"])


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module"
            and node.args and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value
        elif isinstance(node, ast.JoinedStr) and any(
            isinstance(v, ast.Constant) and str(v.value).startswith("repro.")
            for v in node.values
        ):
            yield "repro."  # an f-string building a JAX-package module path


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
    ]
    assert bad == [], f"{path} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"lowrank_matmul.py", "engine.py", "chip_smoke.py", "torch_quickstart.py",
            "torch_train_llm.py", "torch_serve_llm.py", "torch_federated_vision.py"} <= names


def _cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


def test_serve_without_cpu_device_raises_when_no_cuda():
    _cuda_absent()
    spec = ExperimentSpec(model=ModelSpec(preset="llm-tiny", smoke=True),
                          serve=ServeSpec(max_prompt=16, prompt_bucket=8))
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        serve(spec)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        launch_serve.main(["--preset", "llm-tiny", "--smoke", "--requests", "1"])


def test_launch_serve_runs_on_cpu_when_asked(capsys):
    assert launch_serve.main([
        "--preset", "llm-tiny", "--smoke", "--device", "cpu", "--requests", "2",
        "--prompt-len", "16", "--new-tokens", "3",
    ]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "device cpu" in out


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """Without CUDA, or copied away from the repo, the script exits non-zero
    and prints no result line."""
    _cuda_absent()
    lonely = tmp_path / "chip_smoke.py"
    lonely.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lonely)):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
            timeout=120, env={**os.environ, "PYTHONPATH": ""},
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
