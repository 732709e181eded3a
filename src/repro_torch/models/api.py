"""Model assembly: ArchConfig -> Model (init / forward / loss) for the
dense, moe, hybrid and ssm families (counterpart of
``repro/models/api.py``: ``_build_decoder``, ``_build_hybrid``,
``_build_xlstm``, ``_embed_lookup``, ``_chunked_ce``, ``Model.loss`` and
``Model.abstract``; ``_logits`` and ``_greedy`` of
``repro/serve/decode.py`` for the serve programs).

    dense   embed -> [rms_norm -> attention -> rms_norm -> mlp] x L
    moe     embed -> [rms_norm -> attention -> rms_norm -> moe] x L
    hybrid  embed -> [mamba2] x L, with one SHARED attention block after
            every ``attn_every``-th layer (zamba2)
    ssm     embed -> groups of (slstm_every - 1 mLSTM + 1 sLSTM) (xlstm)
    each    -> final rms_norm -> lm_head

``forward`` returns ``(x, aux)`` (aux: the MoE routers' load-balance
loss summed over layers, 0 for the other families) and ``Model.loss`` is
``ce + 0.01 * aux``, as in the reference. Params are a nested dict of
float32 tensors in the reference's tree (stacked leaves carry a leading
layer axis; the xlstm's mLSTM leaves two, groups and subs). The
embedding is an index gather, which gives the values of the
reference's one-hot product. The vlm and audio builders and the
reference's ring-cache ``init_cache`` / ``decode_step`` / ``prefill``
are not ported yet (ROADMAP.md Queue A item 9b); the serve engine does
not use them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import xlstm as xl
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


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block_defs(cfg):
    d = {"norm1": pdef((cfg.d_model,), ("embed",), init="ones"),
         "attn": attn.attention_defs(cfg),
         "norm2": pdef((cfg.d_model,), ("embed",), init="ones")}
    if cfg.is_moe:
        d["moe"] = moem.moe_defs(cfg)
    else:
        d["mlp"] = mlpm.mlp_defs(cfg)
    return d


def _ffn(p, h2, cfg):
    """The block's feed-forward half: (y, the router's aux loss, None
    without experts)."""
    if cfg.is_moe:
        return moem.moe_forward(p["moe"], h2, cfg)
    return mlpm.mlp_forward(p["mlp"], h2, cfg), None


def _dense_block(p, x, cfg, schedule, block):
    h = attn.attention_forward(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                               cfg, schedule=schedule, block=block)
    x = x + h
    y, aux = _ffn(p, rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + y, aux


def _mamba_block(p, x, cfg):
    return x + mam.mamba_forward(p["mamba"],
                                 rms_norm(x, p["norm"], cfg.norm_eps), cfg)


def _mamba_block_decode(p, x, cfg, cache):
    y, new = mam.mamba_decode(p["mamba"],
                              rms_norm(x, p["norm"], cfg.norm_eps), cfg, cache)
    return x + y, new


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
    forward: Callable                           # (params, batch) -> (x, aux)
    # ssm: (params, cache, tokens (B,1)) -> (logits (B,1,V), cache), the
    # serve programs' token core; the other families' programs run their
    # layers themselves
    decode_fn: Optional[Callable] = None

    def init(self, generator: torch.Generator, device="cpu"):
        return init_params(self.defs, generator, device)

    def abstract(self):
        """The params' shapes and dtypes as a tree of ``meta`` tensors (no
        storage): the structure a checkpoint is restored into."""
        return tree.tree_map(lambda d: torch.empty(
            d.shape, dtype=getattr(torch, d.dtype), device="meta"), self.defs)

    def loss(self, params, batch):
        """Mean next-token CE (the last position has no label and is
        masked) plus 0.01 times the MoE load-balance loss."""
        x, aux = self.forward(params, batch)
        labels = batch["tokens"]
        lab = torch.cat([labels[:, 1:], torch.zeros_like(labels[:, :1])], 1)
        mask = torch.ones(lab.shape, dtype=torch.float32, device=lab.device)
        mask[:, -1] = 0.0
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return _chunked_ce(x, head, lab, mask) + 0.01 * aux


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
    fam = cfg.family
    if fam in ("dense", "moe"):
        return _build_decoder(cfg, schedule, attn_block)
    if fam == "hybrid":
        return _build_hybrid(cfg, schedule, attn_block)
    if fam == "ssm":
        return _build_xlstm(cfg)
    if fam in ("vlm", "audio"):
        raise NotImplementedError(
            f"family {fam!r} is not ported yet: its builder needs the "
            "modality frontends and the ring-cache decode (ROADMAP.md "
            "Queue A item 9b)")
    raise ValueError(f"unknown family {fam!r}")


def _build_decoder(cfg, schedule, attn_block):
    defs = _common_defs(cfg)
    defs["blocks"] = stack_defs(_dense_block_defs(cfg), cfg.n_layers)

    def forward(params, batch):
        x = _embed_lookup(params["embed"], batch["tokens"],
                          getattr(torch, cfg.dtype))
        aux = _zero(x)
        for p in _layer_params(params["blocks"], cfg.n_layers):
            x, a = _dense_block(p, x, cfg, schedule, attn_block)
            if a is not None:
                aux = aux + a
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    return Model(cfg, defs, forward)


def _build_hybrid(cfg, schedule, attn_block):
    defs = _common_defs(cfg)
    defs["blocks"] = stack_defs(
        {"norm": pdef((cfg.d_model,), ("embed",), init="ones"),
         "mamba": mam.mamba_defs(cfg)}, cfg.n_layers)
    # one SHARED attention block (zamba2's): its one set of params is
    # used after every ``attn_every``-th mamba layer
    defs["shared_attn"] = {
        "norm": pdef((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.attention_defs(cfg),
    }
    every = cfg.attn_every

    def forward(params, batch):
        x = _embed_lookup(params["embed"], batch["tokens"],
                          getattr(torch, cfg.dtype))
        sh = params["shared_attn"]
        layers = _layer_params(params["blocks"], cfg.n_layers)
        for idx, p in enumerate(layers):
            x = _mamba_block(p, x, cfg)
            if idx % every == every - 1:
                x = x + attn.attention_forward(
                    sh["attn"], rms_norm(x, sh["norm"], cfg.norm_eps), cfg,
                    schedule=schedule, block=attn_block)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), _zero(x)

    return Model(cfg, defs, forward)


def xlstm_groups(cfg):
    """(n_groups, mLSTM layers a group): each group ends in one sLSTM."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def _xlstm_layers(params, cfg):
    """[(the group's mLSTM layers, its sLSTM layer)] as per-layer trees."""
    n_groups, n_m = xlstm_groups(cfg)
    return [(_layer_params(m, n_m), s) for m, s in zip(
        _layer_params(params["mlstm"], n_groups),
        _layer_params(params["slstm"], n_groups))]


def _build_xlstm(cfg):
    n_groups, n_m = xlstm_groups(cfg)
    defs = _common_defs(cfg)
    m_defs = {"norm": pdef((cfg.d_model,), ("embed",), init="ones"),
              "cell": xl.mlstm_defs(cfg)}
    s_defs = {"norm": pdef((cfg.d_model,), ("embed",), init="ones"),
              "cell": xl.slstm_defs(cfg)}
    defs["mlstm"] = stack_defs(stack_defs(m_defs, n_m, "sub"), n_groups)
    defs["slstm"] = stack_defs(s_defs, n_groups)
    eps = cfg.norm_eps

    def forward(params, batch):
        x = _embed_lookup(params["embed"], batch["tokens"],
                          getattr(torch, cfg.dtype))
        for ms, s in _xlstm_layers(params, cfg):
            for pm in ms:
                x = x + xl.mlstm_forward(pm["cell"],
                                         rms_norm(x, pm["norm"], eps), cfg)
            x = x + xl.slstm_forward(s["cell"], rms_norm(x, s["norm"], eps),
                                     cfg)
        return rms_norm(x, params["final_norm"], eps), _zero(x)

    def decode(params, cache, tokens):
        """One token for every slot; cache leaves (n_groups, n_m, B, ...)
        and (n_groups, B, ...), as the reference's."""
        x = _embed_lookup(params["embed"], tokens, getattr(torch, cfg.dtype))
        new_m, new_s = [], []
        for g, (ms, s) in enumerate(_xlstm_layers(params, cfg)):
            subs = []
            for j, pm in enumerate(ms):
                c = {k: v[g, j] for k, v in cache["mlstm"].items()}
                y, c = xl.mlstm_decode(pm["cell"], rms_norm(x, pm["norm"], eps),
                                       cfg, c)
                x = x + y
                subs.append(c)
            new_m.append({k: torch.stack([c[k] for c in subs])
                          for k in subs[0]})
            c = {k: v[g] for k, v in cache["slstm"].items()}
            y, c = xl.slstm_decode(s["cell"], rms_norm(x, s["norm"], eps),
                                   cfg, c)
            x = x + y
            new_s.append(c)
        x = rms_norm(x, params["final_norm"], eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
        return logits.to(torch.float32), {
            "mlstm": {k: torch.stack([m[k] for m in new_m])
                      for k in new_m[0]},
            "slstm": {k: torch.stack([s[k] for s in new_s])
                      for k in new_s[0]}}

    return Model(cfg, defs, forward, decode)
