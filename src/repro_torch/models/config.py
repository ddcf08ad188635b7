"""Model configuration dataclasses covering all assigned architectures.

A copy of the JAX package's ``repro.models.config`` (plain dataclasses), so
the two packages describe a model with the same values. One
:class:`ModelConfig` describes any of the six architecture families
(dense / moe / audio-enc-dec / vlm / hybrid / ssm) via optional sub-configs.
``block_pattern`` is the repeating *superblock* of sequence-mixer types;
parameters of each position are stacked over ``num_layers //
len(block_pattern)`` superblocks. The port runs the dense attention family;
the other mixers raise ``NotImplementedError`` where the model is built.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    num_shared_experts: int = 0
    d_shared: int = 0  # hidden size of the always-on shared expert block
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    every_k_layers: int = 1  # MoE on layer i iff i % every_k == offset
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model/16)
    # time-chunk for the selective scan: the (B, chunk, d_inner, N) workspace
    # is the layer's peak memory; the recurrence carries h across chunks.
    scan_chunk: int = 512


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay LoRA (Finch)
    chunk_len: int = 64  # chunked linear-attention block length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Audio (whisper-style) encoder: consumes stub frame embeddings."""

    num_layers: int
    num_frames: int = 1500  # 30 s of audio after the conv frontend (stubbed)


@dataclasses.dataclass(frozen=True)
class LowRankPolicy:
    """Which weight matrices FeDLRT factorizes, and at what rank budget.

    ``r_max = min(rank_frac · min(n_in, n_out), r_cap)`` rounded up to a
    multiple of 8 (as in the JAX package); matrices with ``min(n_in,n_out) < min_dim``
    stay dense (norm scales, tiny routers, biases are always dense).
    """

    enable: bool = True
    rank_frac: float = 0.125
    r_cap: int = 256
    min_dim: int = 256
    factorize_embed: bool = True
    factorize_head: bool = True
    init_rank_frac: float = 1.0  # initial rank as a fraction of r_max

    def r_max_for(self, n_in: int, n_out: int) -> int:
        r = int(self.rank_frac * min(n_in, n_out))
        r = min(r, self.r_cap, min(n_in, n_out) // 2)
        return max(8 * ((r + 7) // 8), 1)

    def applies(self, n_in: int, n_out: int) -> bool:
        return self.enable and min(n_in, n_out) >= self.min_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    gated_mlp: bool = True  # SwiGLU (all assigned LLMs); False → GELU MLP
    sliding_window: int = 0  # 0 → full causal attention
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    block_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision_tokens: int = 0  # >0 → VLM: stub patch embeddings prepended
    tie_embeddings: bool = False
    lowrank: LowRankPolicy = dataclasses.field(default_factory=LowRankPolicy)
    compute_dtype: str = "bfloat16"
    # factor/param storage dtype; server-side QR/SVD always upcasts to f32.
    # bf16 halves the (replicated) factor footprint on the production mesh;
    # reduced smoke configs use f32 end-to-end.
    param_dtype: str = "bfloat16"
    remat: bool = True
    attn_q_chunk: int = 1024  # blockwise-attention query chunk (memory bound)
    loss_seq_chunk: int = 0  # 0 → unchunked cross-entropy
    # low-rank kernel dispatch for every factorized matmul:
    #   "auto"  the Hopper xus/avt kernels on CUDA tensors, their plain
    #           versions (same numerics) on CPU tensors
    #   "off"   the plain working-dtype chain (x U) S Vᵀ (tests, and the
    #           comparison phase of chip_smoke.py)
    kernels: str = "auto"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def superblocks(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            self.name,
            self.num_layers,
            self.block_pattern,
        )
        return self.num_layers // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (500k cache) is supported.

        SSM/linear-RNN and hybrid (Mamba-dominant) architectures qualify,
        as do sliding-window attention archs (per-token cost bounded by the
        window).  Pure full-attention archs are skipped ."""
        mixers = set(self.block_pattern)
        if mixers & {"mamba", "rwkv"}:
            return True
        return self.sliding_window > 0

    def moe_on_layer(self, i: int) -> bool:
        return (
            self.moe is not None
            and i % self.moe.every_k_layers == self.moe.offset
        )


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: ≤2 superblocks, d_model ≤ 512, ≤4 experts."""
    pat = cfg.block_pattern
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    changes = dict(
        num_layers=len(pat) * min(2, cfg.superblocks),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        lowrank=dataclasses.replace(cfg.lowrank, min_dim=32, rank_frac=0.25),
        compute_dtype="float32",
        param_dtype="float32",
        attn_q_chunk=64,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 128),
            d_shared=min(cfg.moe.d_shared, 128) if cfg.moe.d_shared else 0,
        )
    if cfg.mamba is not None:
        changes["mamba"] = dataclasses.replace(cfg.mamba, d_state=8)
    if cfg.rwkv is not None:
        changes["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_dim=32, decay_lora=16, chunk_len=16
        )
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(
            cfg.encoder, num_layers=2, num_frames=32
        )
    if cfg.vision_tokens:
        changes["vision_tokens"] = 16
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
