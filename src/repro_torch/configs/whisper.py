"""Whisper-base: enc-dec transformer; mel+conv frontend stubbed as
precomputed frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    source="[arXiv:2212.04356]",
    n_layers=6,            # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    n_frames=1500,         # stub conv frontend output length
    mlp_type="gelu",
    qkv_bias=True,
)
