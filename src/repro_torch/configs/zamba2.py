"""Zamba2-7B: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="[arXiv:2411.15242]",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    expand=2,
    d_conv=4,
    attn_every=6,  # shared attention block applied every 6 mamba layers
    mlp_type="swiglu",
)
