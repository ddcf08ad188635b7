"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained experts, 2 shared + 64
routed top-6, expert hidden 1408.  (A deviation kept from the JAX package: the
published model keeps layer 0 as a dense FFN; we use MoE on every layer so
the scanned superblock stays homogeneous.)"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=1e4,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared_experts=2,
        d_shared=2816,
        capacity_factor=1.25,
    ),
)
