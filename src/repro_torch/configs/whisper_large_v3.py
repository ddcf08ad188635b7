"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec; conv/mel frontend is a STUB
(input_specs provides 1280-d frame embeddings), per the assignment carve-out."""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    gated_mlp=False,        # whisper uses GELU MLP
    encoder=EncoderConfig(num_layers=32, num_frames=1500),
)
