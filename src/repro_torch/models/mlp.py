"""Feed-forward variants (counterpart of ``repro/models/mlp.py``):
SwiGLU, squared ReLU and GELU (tanh form, as ``jax.nn.gelu``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pdef


def mlp_defs(cfg, d_ff=None):
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": pdef((d, f), ("embed", "ff")),
            "w_up": pdef((d, f), ("embed", "ff")),
            "w_down": pdef((f, d), ("ff", "embed")),
        }
    return {
        "w_up": pdef((d, f), ("embed", "ff")),
        "w_down": pdef((f, d), ("ff", "embed")),
    }


def mlp_forward(p, x, cfg):
    dt = x.dtype
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
        h = F.silu(g) * u
    elif cfg.mlp_type == "relu2":
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
        h = torch.square(F.relu(u))
    elif cfg.mlp_type == "gelu":
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
        h = F.gelu(u, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(dt))
