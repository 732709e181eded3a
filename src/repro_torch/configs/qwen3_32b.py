"""Qwen3-32B: dense GQA with qk-norm and explicit head_dim=128.
[hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B]",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
)
