"""Qwen1.5-110B: dense GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    source="[hf:Qwen/Qwen1.5-0.5B]",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    mlp_type="swiglu",
)
