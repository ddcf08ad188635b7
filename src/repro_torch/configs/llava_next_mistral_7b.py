"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
ViT tower + anyres projector are a STUB (input_specs provides 4096-d patch
embeddings, 2880 tokens ≈ anyres max).  Mistral sliding window 4096 makes
long_500k decode admissible (O(window) attention per token)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
    vision_tokens=2880,
)
