"""Model assembly for the dense family (counterpart of
``repro/models/api.py``: ``_build_decoder``, ``_embed_lookup``,
``_chunked_ce``, ``Model.loss`` and ``Model.abstract``; ``_logits`` and
``_greedy`` of ``repro/serve/decode.py`` for the serve programs).

    embed -> [rms_norm -> attention -> rms_norm -> mlp] x L -> norm -> lm_head

Params are a nested dict of float32 tensors in the reference's tree
(``blocks/*`` leaves stacked with a leading ``n_layers`` axis). The
embedding is an index gather, which in float32 gives the same values as
the reference's one-hot product. The other families (moe, hybrid, ssm,
vlm, audio) are not ported yet (ROADMAP.md Queue A, "the remaining
model families").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.layers import init_params, pdef, rms_norm, stack_defs

CE_CHUNK = 512


def _embed_lookup(table, tokens, dtype):
    return table[tokens.long()].to(dtype)


def _chunked_ce(x, w_head, labels, mask, chunk=CE_CHUNK):
    """Mean next-token CE over sequence chunks, never holding the full
    (B, S, V) logits. x (B,S,D), w_head (D,V), labels and mask (B,S)."""
    S = x.shape[1]
    if S % chunk:
        chunk = S
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        xb, lb = x[:, c:c + chunk], labels[:, c:c + chunk]
        mb = mask[:, c:c + chunk]
        logits = torch.einsum("bsd,dv->bsv", xb, w_head.to(xb.dtype))
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
        tot = tot + torch.sum((logz - gold) * mb)
        cnt = cnt + torch.sum(mb)
    return tot / torch.clamp(cnt, min=1.0)


def _dense_block_defs(cfg):
    return {"norm1": pdef((cfg.d_model,), ("embed",), init="ones"),
            "attn": attn.attention_defs(cfg),
            "norm2": pdef((cfg.d_model,), ("embed",), init="ones"),
            "mlp": mlpm.mlp_defs(cfg)}


def _dense_block(p, x, cfg, schedule, block):
    h = attn.attention_forward(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                               cfg, schedule=schedule, block=block)
    x = x + h
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlpm.mlp_forward(p["mlp"], h2, cfg)


def _logits(params, x, cfg):
    """Final norm and LM head on one position: x (B,1,D) -> (B,
    padded_vocab) float32."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    return out.to(torch.float32)[:, 0]


def _greedy(logits, vocab: int):
    """(B, padded_vocab) -> (B,) int32 greedy tokens over the real vocab
    (the pad entries excluded); the first index wins a tie."""
    return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)


def _layer_params(blocks, n_layers):
    """The stacked ``blocks`` tree -> one tree per layer (views)."""
    out = [{} for _ in range(n_layers)]
    for k, v in blocks.items():
        parts = (_layer_params(v, n_layers) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    defs: Any                                   # ParamDef tree
    forward: Callable                           # (params, batch) -> x

    def init(self, generator: torch.Generator, device="cpu"):
        return init_params(self.defs, generator, device)

    def abstract(self):
        """The params' shapes and dtypes as a tree of ``meta`` tensors (no
        storage): the structure a checkpoint is restored into."""
        return tree.tree_map(lambda d: torch.empty(
            d.shape, dtype=getattr(torch, d.dtype), device="meta"), self.defs)

    def loss(self, params, batch):
        """Mean next-token CE; the last position has no label and is
        masked. (The reference adds 0.01 * aux, which is 0 for the dense
        family.)"""
        x = self.forward(params, batch)
        labels = batch["tokens"]
        lab = torch.cat([labels[:, 1:], torch.zeros_like(labels[:, :1])], 1)
        mask = torch.ones(lab.shape, dtype=torch.float32, device=lab.device)
        mask[:, -1] = 0.0
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return _chunked_ce(x, head, lab, mask)


def _common_defs(cfg):
    defs = {
        "embed": pdef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                      scale=0.02),
        "final_norm": pdef((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = pdef((cfg.d_model, cfg.padded_vocab),
                               ("embed", "vocab"))
    return defs


def build_model(cfg: ArchConfig, schedule: str = "tri",
                attn_block: int = 512) -> Model:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: only 'dense' is "
            "(ROADMAP.md Queue A, 'the remaining model families')")
    defs = _common_defs(cfg)
    defs["blocks"] = stack_defs(_dense_block_defs(cfg), cfg.n_layers)

    def forward(params, batch):
        dtype = getattr(torch, cfg.dtype)
        x = _embed_lookup(params["embed"], batch["tokens"], dtype)
        for p in _layer_params(params["blocks"], cfg.n_layers):
            x = _dense_block(p, x, cfg, schedule, attn_block)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    return Model(cfg, defs, forward)
