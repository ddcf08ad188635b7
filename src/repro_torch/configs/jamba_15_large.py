"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: hybrid Mamba+attention at 1:7
interleave (attention at position 4 of each 8-layer block), MoE (16 experts
top-2) on every other layer."""
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=1e4,
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_expert=24576,
        capacity_factor=1.25,
        every_k_layers=2,
        offset=1,
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)
