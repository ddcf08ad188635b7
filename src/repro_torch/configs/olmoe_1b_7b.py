"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts top-8, expert hidden 1024."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    rope_theta=1e4,
    moe=MoEConfig(
        num_experts=64,
        top_k=8,
        d_expert=1024,
        capacity_factor=1.25,
    ),
)
