"""RWKV6-World-7B "Finch" [arXiv:2404.05892]: attention-free linear RNN with
data-dependent decay (LoRA-parameterized).  (Deviations kept from the JAX package:
token-shift mixing coefficients are static rather than ddlerp; channel-mix
uses the shared MLP primitive.)"""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,           # 4096 / 64 head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    gated_mlp=False,
    block_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk_len=64),
)
