"""Nemotron-4-15B: dense GQA, squared-ReLU MLP, 256k vocab.
[arXiv:2402.16819]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="[arXiv:2402.16819]",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="relu2",
    rope_theta=10_000.0,
)
