"""Architecture configuration (a copy of ``repro/configs/base.py``).

``ArchConfig`` keeps every field of the reference, so that ``reduced()``
gives the same shapes in both packages. Each architecture has one module
here with its published ``CONFIG`` (the paper's own models share
``paper.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A single architecture configuration (``family`` selects the
    model in ``repro_torch.models.api.build_model``: dense | moe |
    hybrid | ssm | vlm | audio)."""

    name: str
    family: str
    source: str

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    long_context_window: int = 8_192

    mlp_type: str = "swiglu"  # swiglu | relu2 | gelu

    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "densemask"

    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    chunk_size: int = 128
    attn_every: int = 6

    slstm_every: int = 4

    n_frames: int = 0
    n_patches: int = 0
    n_encoder_layers: int = 0

    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    embed_impl: str = "onehot"
    attn_impl: str = "blocked"  # blocked (plain torch) | pallas (flash kernel)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=256 (the reference's
        ``reduced``, field for field)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            chunk_size=8,
            attn_every=2,
            slstm_every=2,
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            long_context_window=64,
            dtype="float32",
        )


_MODULE_FOR = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "zamba2-7b": "zamba2",
    "internvl2-1b": "internvl2",
    "granite-moe-1b-a400m": "granite_moe",
    "whisper-base": "whisper",
    "llama3-405b": "llama3_405b",
    "qwen1.5-110b": "qwen15_110b",
    "xlstm-1.3b": "xlstm",
    "qwen3-32b": "qwen3_32b",
    "nemotron-4-15b": "nemotron4_15b",
    "paper-mlp": "paper",
    "paper-lenet": "paper",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULE_FOR)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    if hasattr(mod, "CONFIGS"):
        return mod.CONFIGS[arch_id]
    return mod.CONFIG
