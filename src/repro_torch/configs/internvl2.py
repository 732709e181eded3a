"""InternVL2-1B: InternViT (stubbed) + InternLM2/Qwen2-0.5B LM backbone.
[arXiv:2404.16821]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="[arXiv:2404.16821]",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,  # qwen2 backbone uses qkv bias
    n_patches=256,  # stub ViT patch embeddings per image
    mlp_type="swiglu",
)
