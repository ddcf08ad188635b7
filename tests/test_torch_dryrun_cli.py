"""The port's dry-run CLI end to end (a subprocess: the ``fake`` process
group is process-wide): ``python -m repro_torch.launch.dryrun --device cpu``
on the JAX package's two CLI cases. rwkv6-7b × long_500k traces rank 0's
decode step on a 256-rank 16 × 16 mesh and writes its JSON (the roofline
terms, the per-device memory, the local shapes of its kernel calls);
qwen2-7b × long_500k is the documented skip.
"""
import json
import os
import subprocess
import sys

from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(args, out_dir):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
           "--out", str(out_dir)] + args
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=420)


def test_dryrun_cli_traces_and_reports(tmp_path):
    p = _run(["--arch", "rwkv6-7b", "--shape", "long_500k"], tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "OK    rwkv6-7b × long_500k [16x16] devices=256" in p.stdout
    with open(tmp_path / "16x16__rwkv6-7b__long_500k.json") as f:
        res = json.load(f)
    assert res["devices"] == 256 and res["mesh"] == "16x16"
    rf = res["roofline"]
    assert rf["collective_bytes_per_device"] > 0
    assert rf["flops_per_device"] > 0 and rf["memory_s"] > 0
    assert rf["dominant"] in ("compute", "memory", "collective")
    mem = res["memory"]
    assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert res["lower_s"] >= 0 and res["model_flops_per_device"] > 0
    assert "compile_s" not in res
    kernels = {k[0] for k in res["kernel_shapes"]}
    assert {"xus", "avt"} <= kernels


def test_dryrun_cli_documented_skip(tmp_path):
    p = _run(["--arch", "qwen2-7b", "--shape", "long_500k"], tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "SKIP" in p.stdout
    with open(tmp_path / "skip__qwen2-7b__long_500k.json") as f:
        res = json.load(f)
    assert "sub-quadratic" in res["skipped"]
