"""The port's input stand-ins and specs (``repro_torch.launch.specs``):
the JAX package's ``tests/test_specs.py`` cases, then every structure of
``train_specs``, ``prefill_specs`` and ``decode_specs`` (the decode cache's
``cache_specs`` included) held to the JAX package's: the same keys, shapes,
dtypes and specs, for the ten architectures on the 16 × 16 and 2 × 16 × 16
meshes (stub meshes: the functions read only the axis names and sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.launch.specs import (
    SHAPES,
    decode_specs,
    prefill_specs,
    sanitize_specs,
    shape_applies,
    train_specs,
)
from repro_torch.models import build_model
from repro_torch.utils.meshctx import P, is_spec
from repro_torch.utils.tree import tree_map_with_path
from torch_threads import one_intra_op_thread  # noqa: F401

DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


class _JaxStub:
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


class _TorchStub:
    def __init__(self, names, sizes):
        self.mesh_dim_names = names
        self._sizes = sizes

    def size(self, i=None):
        return int(np.prod(self._sizes)) if i is None else self._sizes[i]


MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def test_shapes_table():
    assert SHAPES["train_4k"].seq_len == 4096
    assert SHAPES["train_4k"].global_batch == 256
    assert SHAPES["prefill_32k"].global_batch == 32
    assert SHAPES["decode_32k"].kind == "decode"
    assert SHAPES["long_500k"].seq_len == 524_288
    assert {k: v.__dict__ for k, v in SHAPES.items()} == {
        k: v.__dict__ for k, v in jspecs.SHAPES.items()}


def test_long_context_skip_rules():
    expected_runs = {
        "rwkv6_7b": True,
        "jamba_15_large": True,
        "llava_next_mistral_7b": True,
        "qwen2_7b": False,
        "codeqwen15_7b": False,
        "qwen3_32b": False,
        "qwen15_32b": False,
        "whisper_large_v3": False,
        "deepseek_moe_16b": False,
        "olmoe_1b_7b": False,
    }
    for arch, want in expected_runs.items():
        ok, reason = shape_applies(get_config(arch), SHAPES["long_500k"])
        assert ok == want, (arch, reason)
        assert (ok, reason) == jspecs.shape_applies(jax_get_config(arch),
                                                    jspecs.SHAPES["long_500k"])


def test_all_other_shapes_apply_everywhere():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            ok, _ = shape_applies(cfg, SHAPES[s])
            assert ok, (arch, s)


def test_train_specs_batch_layout():
    structs, specs = train_specs(get_config("qwen2_7b"), SHAPES["train_4k"], 16)
    assert structs["tokens"].shape == (16, 16, 4097)
    assert structs["tokens"].dtype == torch.int32
    assert structs["tokens"].device.type == "meta"
    assert specs["tokens"] == P(("data",), None, None)


def test_train_specs_vlm_accounts_for_vision_prefix():
    cfg = get_config("llava_next_mistral_7b")
    structs, _ = train_specs(cfg, SHAPES["train_4k"], 16)
    text = structs["tokens"].shape[-1] - 1
    assert text + cfg.vision_tokens == 4096
    assert structs["vision_embeds"].shape[-2:] == (2880, 4096)


def test_sanitize_specs_drops_nondivisible():
    mesh = _TorchStub(("data", "model"), (16, 2))
    specs = {"a": P("model", None)}
    assert sanitize_specs(mesh, {"a": torch.empty(7, 4, device="meta")}, specs)["a"] == \
        P(None, None)
    assert sanitize_specs(mesh, {"a": torch.empty(8, 4, device="meta")}, specs)["a"] == \
        P("model", None)


def _norm(spec):
    """A spec as a list; a one-axis tuple is that axis (JAX's PartitionSpec
    writes ("data",) as "data")."""
    return [(a[0] if len(a) == 1 else list(a)) if isinstance(a, tuple) else a for a in spec]


def _jax_flat(structs, specs):
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(structs)[0]
    spec_leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for (path, s), (_, p) in zip(leaves, spec_leaves):
        out[jax.tree_util.keystr(path)] = (tuple(s.shape), DTYPES[jnp.dtype(s.dtype)], _norm(p))
    return out


def _torch_flat(structs, specs):
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p, [tuple(t.shape), t.dtype]), structs)
    tree_map_with_path(lambda p, s: out[p].append(_norm(s)), specs, is_leaf=is_spec)
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_input_structures_match_reference(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    tm, jm = _TorchStub(names, sizes), _JaxStub(names, sizes)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    C = sizes[-2] * (sizes[0] if len(sizes) == 3 else 1)
    got = {"train": train_specs(cfg, SHAPES["train_4k"], C, tm),
           "prefill": prefill_specs(cfg, SHAPES["prefill_32k"], tm)}
    want = {"train": jspecs.train_specs(jcfg, jspecs.SHAPES["train_4k"], C, jm),
            "prefill": jspecs.prefill_specs(jcfg, jspecs.SHAPES["prefill_32k"], jm)}
    for shape in ("decode_32k", "long_500k"):
        if not shape_applies(cfg, SHAPES[shape])[0]:
            continue
        (cs, tok), (cp, tp) = decode_specs(cfg, build_model(cfg), SHAPES[shape], tm)
        (jcs, jtok), (jcp, jtp) = jspecs.decode_specs(jcfg, jax_build_model(jcfg),
                                                      jspecs.SHAPES[shape], jm)
        got[shape] = ({"cache": cs, "tokens": tok}, {"cache": cp, "tokens": tp})
        want[shape] = ({"cache": jcs, "tokens": jtok}, {"cache": jcp, "tokens": jtp})
    for kind in want:
        g, w = _torch_flat(*got[kind]), _jax_flat(*want[kind])
        assert sorted(g) == sorted(w), kind
        for path in w:
            assert g[path] == w[path], (kind, path, g[path], w[path])
