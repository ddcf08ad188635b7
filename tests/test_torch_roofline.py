"""The port's roofline (``repro_torch.launch.roofline``): the terms and
their dominance on the H100 table, what ``LocalCounter`` counts for known
redistributions and a sharded product on a ``fake`` 256-rank mesh (a
subprocess: ``tests/torch_fake_mesh_worker.py counts``), and
``model_flops`` against the JAX package's for the ten configurations.

The collective terms follow the JAX package's ring model, per device: an
all-gather moves its result, an all-reduce twice its operand, a
reduce-scatter its operand. A 16-wide axis at stride 1 spans two 8-card
nodes (the inter-node rate); an 8-wide one stays on NVLink. FLOPs are the
local shard's: a (4096 × 3584)·(3584 × 256) product split 16 ways on its
contraction counts 2·4096·224·256 (a ``FlopCounterMode`` entered above
DTensor would count the whole product).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.roofline import model_flops as jax_model_flops
from repro_torch.configs import ALIASES, get_config
from repro_torch.launch import roofline as rl
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_h100_table():
    assert rl.PEAK_FLOPS == 989e12 and rl.HBM_BW == 3.35e12
    assert rl.NVLINK_BW == 450e9 and rl.INTER_NODE_BW == 50e9 and rl.NODE_CARDS == 8


def test_roofline_terms_and_dominance():
    r = rl.Roofline(
        flops_per_device=989e12,  # exactly 1 s of compute
        bytes_per_device=3.35e12,  # exactly 1 s of HBM
        collective_bytes_per_device=100e9,
        collectives={"all-reduce": 100e9},
        collective_seconds=2.0,  # 100 GB over the inter-node links
    )
    assert np.isclose(r.compute_s, 1.0)
    assert np.isclose(r.memory_s, 1.0)
    assert np.isclose(r.collective_s, 2.0)
    assert r.dominant == "collective"
    d = r.to_dict()
    assert d["dominant"] == "collective" and d["collectives"] == {"all-reduce": 100e9}
    assert rl.Roofline(2 * 989e12, 3.35e12, 0.0, {}).dominant == "compute"
    assert rl.Roofline(989e12, 2 * 3.35e12, 0.0, {}, 1.0).dominant == "memory"


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("counts") / "counts.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_fake_mesh_worker.py"),
                        "counts", str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _only(coll, kind, nbytes):
    assert coll[kind] == nbytes
    assert sum(v for k, v in coll.items() if k != kind) == 0


def test_collective_counter_on_known_redistributions(counts):
    S = 1024 * 512 * 4  # the whole f32 tensor
    coll, sec = counts["all_gather_node2"]
    _only(coll, "all-gather", S)
    assert np.isclose(sec, S / rl.INTER_NODE_BW)
    coll, sec = counts["all_gather_node1"]
    _only(coll, "all-gather", S)
    assert np.isclose(sec, S / rl.NVLINK_BW)
    coll, sec = counts["all_reduce"]
    _only(coll, "all-reduce", 2 * S)
    assert np.isclose(sec, 2 * S / rl.INTER_NODE_BW)
    coll, sec = counts["reduce_scatter"]
    _only(coll, "reduce-scatter", S)


def test_flops_are_the_local_shards(counts):
    flops, placements, local = counts["matmul"]
    assert flops == 2 * 4096 * (3584 // 16) * 256
    assert placements == ["R", "P(sum)"] and local == [4096, 256]


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_model_flops_match_reference(arch):
    for backward in (False, True):
        assert rl.model_flops(get_config(arch), 4096, backward=backward) == \
            jax_model_flops(jax_get_config(arch), 4096, backward=backward)
