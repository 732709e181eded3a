"""Llama-3.1-405B: 126L dense GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    source="[arXiv:2407.21783]",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    mlp_type="swiglu",
)
