"""Model assembly: ArchConfig -> Model (init / forward / loss / logits
and the ring-cache init_cache / decode_step / prefill / encode) for every
family (counterpart of ``repro/models/api.py``; ``_logits`` and
``_greedy`` of ``repro/serve/decode.py`` for the serve programs).

    dense   embed -> [rms_norm -> attention -> rms_norm -> mlp] x L
    moe     embed -> [rms_norm -> attention -> rms_norm -> moe] x L
    hybrid  embed -> [mamba2] x L, with one SHARED attention block after
            every ``attn_every``-th layer (zamba2)
    ssm     embed -> groups of (slstm_every - 1 mLSTM + 1 sLSTM) (xlstm)
    vlm     projected patch embeddings in place of the first
            ``n_patches`` token embeddings -> the dense stack (internvl2)
    audio   projected frame embeddings -> a non-causal encoder without
            RoPE; tokens -> decoder layers of self attention, cross
            attention over the encoder output, mlp (whisper)
    each    -> final rms_norm -> lm_head

``forward`` returns ``(x, aux)`` (aux: the MoE routers' load-balance
loss summed over layers, 0 for the other families) and ``Model.loss`` is
``ce + 0.01 * aux``, as in the reference. Params are a nested dict of
float32 tensors in the reference's tree (stacked leaves carry a leading
layer axis; the xlstm's mLSTM leaves two, groups and subs). The
embedding is an index gather, which gives the values of the
reference's one-hot product.

``decode_step(params, cache, tokens (B,1), pos)`` is the reference's
static-batch decode over the cache of ``init_cache(batch, W)``: per
attention layer a ring of W slots (``attention.decode_attention``), the
recurrent state for hybrid and ssm, and whisper's cross-attention K/V,
which the caller fills from ``encode`` with
``attention.cross_attention_cache``. The dense and moe models also
have ``prefill`` (one forward fills the cache); vlm decodes text only,
as the reference's. The serve engine (``serve/decode.py``) runs its own
paged programs, and reaches ``decode_step`` only as the ssm token core.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.nn import functional as F

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


def _decode_ffn(p, h2, cfg):
    """The decode step's feed-forward half on one token a slot."""
    if cfg.is_moe:
        return moem.moe_decode(p["moe"], h2, cfg)[0]
    return mlpm.mlp_forward(p["mlp"], h2, cfg)


def _dense_block(p, x, cfg, schedule, block):
    h = attn.attention_forward(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                               cfg, schedule=schedule, block=block)
    x = x + h
    y, aux = _ffn(p, rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + y, aux


def _dense_block_decode(p, x, cfg, cache, pos):
    h, kv = attn.decode_attention(p["attn"],
                                  rms_norm(x, p["norm1"], cfg.norm_eps),
                                  cfg, cache, pos)
    x = x + h
    return x + _decode_ffn(p, rms_norm(x, p["norm2"], cfg.norm_eps), cfg), kv


def _mamba_block(p, x, cfg):
    return x + mam.mamba_forward(p["mamba"],
                                 rms_norm(x, p["norm"], cfg.norm_eps), cfg)


def _mamba_block_decode(p, x, cfg, cache):
    y, new = mam.mamba_decode(p["mamba"],
                              rms_norm(x, p["norm"], cfg.norm_eps), cfg, cache)
    return x + y, new


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _project(params, x, cfg):
    """LM head: x (B,S,D), after the final norm -> (B,S,padded_vocab)
    float32 logits."""
    out = torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype))
    return out.to(torch.float32)


def _logits(params, x, cfg):
    """Final norm and LM head on one position: x (B,1,D) -> (B,
    padded_vocab) float32."""
    return _project(params, rms_norm(x, params["final_norm"], cfg.norm_eps),
                    cfg)[:, 0]


def _greedy(logits, vocab: int):
    """(B, padded_vocab) -> (B,) int32 greedy tokens over the real vocab
    (the pad entries excluded); the first index wins a tie."""
    return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)


def _layer_params(blocks, n_layers):
    """A stacked tree (params or a cache, leading layer axis) -> one
    tree per layer (views)."""
    out = [{} for _ in range(n_layers)]
    for k, v in blocks.items():
        parts = (_layer_params(v, n_layers) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _stack_layers(trees):
    """One tree per layer -> the stacked tree (the inverse of
    ``_layer_params``)."""
    return tree.tree_map(lambda *xs: torch.stack(xs), *trees)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    defs: Any                                   # ParamDef tree
    forward: Callable                           # (params, batch) -> (x, aux)
    # (params, cache, tokens (B,1), pos, extras) -> (logits, new cache)
    decode_fn: Callable

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
        return _chunked_ce(x, _head(params, self.cfg), lab, mask) + 0.01 * aux

    def logits(self, params, batch):
        """Full (B, S, padded_vocab) float32 logits: for small inputs."""
        return _project(params, self.forward(params, batch)[0], self.cfg)

    def init_cache(self, batch: int, cache_len: int, device="cpu"):
        """The decode cache of ``batch`` sequences, ``cache_len`` ring
        slots an attention layer: the reference's tree, shapes and
        dtypes, every slot's position -1 (empty)."""
        return _build_cache(self.cfg, batch, cache_len,
                            getattr(torch, self.cfg.dtype), device)

    def decode_step(self, params, cache, tokens, pos, extras=None):
        """tokens (B,1); pos the absolute position -> (logits (B,1,V)
        float32, the new cache)."""
        return self.decode_fn(params, cache, tokens, pos, extras)


def _build_cache(cfg, batch, cache_len, dtype, device):
    def stacked(shapes, lead):
        return {k: torch.zeros(lead + s, dtype=dt, device=device)
                for k, (s, dt) in shapes.items()}

    def kv(n_layers):
        out = stacked(attn.kv_cache_shapes(cfg, batch, cache_len, dtype),
                      (n_layers,))
        out["slot_pos"].fill_(-1)
        return out

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return {"kv": kv(cfg.n_layers)}
    if fam == "hybrid":
        return {"mamba": stacked(mam.mamba_cache_shapes(cfg, batch, dtype),
                                 (cfg.n_layers,)),
                "kv": kv(max(cfg.n_layers // cfg.attn_every, 1))}
    if fam == "ssm":
        n_groups, n_m = xlstm_groups(cfg)
        return {"mlstm": stacked(xl.mlstm_cache_shapes(cfg, batch, dtype),
                                 (n_groups, n_m)),
                "slstm": stacked(xl.slstm_cache_shapes(cfg, batch, dtype),
                                 (n_groups,))}
    if fam == "audio":
        cross = ((cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads,
                  cfg.resolved_head_dim), dtype)
        return {"kv": kv(cfg.n_layers),
                **stacked({"cross_k": cross, "cross_v": cross}, ())}
    raise ValueError(f"unknown family {fam!r}")


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
    if fam == "vlm":
        return _build_vlm(cfg, schedule, attn_block)
    if fam == "audio":
        return _build_whisper(cfg, schedule, attn_block)
    raise ValueError(f"unknown family {fam!r}")


def _decoder_stack(params, x, cfg, schedule, attn_block):
    """The dense/moe layers and the final norm: (x, summed aux)."""
    aux = _zero(x)
    for p in _layer_params(params["blocks"], cfg.n_layers):
        x, a = _dense_block(p, x, cfg, schedule, attn_block)
        if a is not None:
            aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _build_decoder(cfg, schedule, attn_block):
    defs = _common_defs(cfg)
    defs["blocks"] = stack_defs(_dense_block_defs(cfg), cfg.n_layers)
    dtype = getattr(torch, cfg.dtype)
    eps = cfg.norm_eps

    def forward(params, batch):
        x = _embed_lookup(params["embed"], batch["tokens"], dtype)
        return _decoder_stack(params, x, cfg, schedule, attn_block)

    def decode(params, cache, tokens, pos, extras):
        x = _embed_lookup(params["embed"], tokens, dtype)
        new = []
        for p, c in zip(_layer_params(params["blocks"], cfg.n_layers),
                        _layer_params(cache["kv"], cfg.n_layers)):
            x, kv = _dense_block_decode(p, x, cfg, c, pos)
            new.append(kv)
        return _project(params, rms_norm(x, params["final_norm"], eps),
                        cfg), {"kv": _stack_layers(new)}

    def prefill(params, batch, cache_len):
        """Batched prefill: ONE forward fills the cache for every prompt
        position (the tokens (B, S), S <= cache_len, land in slots 0..S-1;
        the rest stay empty). Returns (last-position logits (B,1,V),
        cache). Attention runs as ``attention_forward``'s causal branch,
        so a prompt of two or more 512-blocks under
        ``attn_impl="pallas"`` goes through the flash kernel."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        if S > cache_len:
            raise ValueError(f"prompt of {S} tokens past the cache's "
                             f"{cache_len} slots")
        x = _embed_lookup(params["embed"], tokens, dtype)
        ks, vs = [], []
        for p in _layer_params(params["blocks"], cfg.n_layers):
            h, (k, v) = attn.attention_forward(
                p["attn"], rms_norm(x, p["norm1"], eps), cfg,
                schedule="tri", return_kv=True)
            x = x + h
            x = x + _ffn(p, rms_norm(x, p["norm2"], eps), cfg)[0]
            ks.append(k)
            vs.append(v)
        logits = _project(params, rms_norm(x[:, -1:], params["final_norm"],
                                           eps), cfg)
        pad = (0, 0, 0, 0, 0, cache_len - S)          # the slot axis
        slot_pos = F.pad(torch.arange(S, dtype=torch.int32,
                                      device=x.device),
                         (0, cache_len - S), value=-1)
        return logits, {"kv": {
            "k": F.pad(torch.stack(ks), pad), "v": F.pad(torch.stack(vs), pad),
            "slot_pos": slot_pos.repeat(cfg.n_layers, 1)}}

    m = Model(cfg, defs, forward, decode)
    m.prefill = prefill
    return m


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

    n_attn = max(cfg.n_layers // every, 1)

    def decode(params, cache, tokens, pos, extras):
        """The shared block's ring cache of its use after layer idx sits
        at slot ``min(idx // every, n_attn - 1)``, as the reference's."""
        x = _embed_lookup(params["embed"], tokens, getattr(torch, cfg.dtype))
        sh = params["shared_attn"]
        kvs = _layer_params(cache["kv"], n_attn)
        new_m = []
        for idx, (p, mc) in enumerate(zip(
                _layer_params(params["blocks"], cfg.n_layers),
                _layer_params(cache["mamba"], cfg.n_layers))):
            x, mc = _mamba_block_decode(p, x, cfg, mc)
            new_m.append(mc)
            if idx % every == every - 1:
                slot = min(idx // every, n_attn - 1)
                h, kvs[slot] = attn.decode_attention(
                    sh["attn"], rms_norm(x, sh["norm"], cfg.norm_eps), cfg,
                    kvs[slot], pos)
                x = x + h
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _project(params, x, cfg), {"mamba": _stack_layers(new_m),
                                          "kv": _stack_layers(kvs)}

    return Model(cfg, defs, forward, decode)


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

    def decode(params, cache, tokens, pos, extras):
        """One token for every slot (``pos`` unused: the state carries
        the history); cache leaves (n_groups, n_m, B, ...) and
        (n_groups, B, ...), as the reference's."""
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
        return _project(params, rms_norm(x, params["final_norm"], eps),
                        cfg), {
            "mlstm": {k: torch.stack([m[k] for m in new_m])
                      for k in new_m[0]},
            "slstm": {k: torch.stack([s[k] for s in new_s])
                      for k in new_s[0]}}

    return Model(cfg, defs, forward, decode)


def _proj_defs(cfg):
    """A (d, d) projector with a bias on the stubbed frontend's
    embeddings (the ViT patches, the conv frames)."""
    return {"w": pdef((cfg.d_model, cfg.d_model), ("embed", None)),
            "b": pdef((cfg.d_model,), (None,), init="zeros")}


def _build_vlm(cfg, schedule, attn_block):
    base = _build_decoder(cfg, schedule, attn_block)
    defs = dict(base.defs, projector=_proj_defs(cfg))
    dtype = getattr(torch, cfg.dtype)

    def forward(params, batch):
        x = _embed_lookup(params["embed"], batch["tokens"], dtype)
        if "patches" in batch:
            pr = params["projector"]
            pe = (batch["patches"].to(dtype) @ pr["w"].to(dtype)
                  + pr["b"].to(dtype))
            # the patch prefix replaces the first n_patches token slots,
            # so the sequence length and positions stay fixed
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return _decoder_stack(params, x, cfg, schedule, attn_block)

    # text-only decode through the decoder's layers, and no prefill, as
    # the reference's
    return Model(cfg, defs, forward, base.decode_fn)


def _build_whisper(cfg, schedule, attn_block):
    defs = _common_defs(cfg)
    norm = pdef((cfg.d_model,), ("embed",), init="ones")
    defs["enc"] = stack_defs({"norm1": norm, "attn": attn.attention_defs(cfg),
                              "norm2": norm, "mlp": mlpm.mlp_defs(cfg)},
                             cfg.n_encoder_layers)
    defs["dec"] = stack_defs({
        "norm1": norm, "self_attn": attn.attention_defs(cfg),
        "norm2": norm, "cross_attn": attn.attention_defs(cfg),
        "norm3": norm, "mlp": mlpm.mlp_defs(cfg)}, cfg.n_layers)
    defs["enc_norm"] = norm
    defs["frame_proj"] = _proj_defs(cfg)
    dtype = getattr(torch, cfg.dtype)
    eps = cfg.norm_eps

    def encode(params, frames):
        """frames (B, n_frames, D) -> the encoder output (B, n_frames,
        D): non-causal self attention without RoPE."""
        fp = params["frame_proj"]
        x = frames.to(dtype) @ fp["w"].to(dtype) + fp["b"].to(dtype)
        for p in _layer_params(params["enc"], cfg.n_encoder_layers):
            x = x + attn.attention_forward(
                p["attn"], rms_norm(x, p["norm1"], eps), cfg, causal=False,
                use_rope=False)
            x = x + mlpm.mlp_forward(p["mlp"], rms_norm(x, p["norm2"], eps),
                                     cfg)
        return rms_norm(x, params["enc_norm"], eps)

    def forward(params, batch):
        enc = encode(params, batch["frames"])
        x = _embed_lookup(params["embed"], batch["tokens"], dtype)
        for p in _layer_params(params["dec"], cfg.n_layers):
            x = x + attn.attention_forward(
                p["self_attn"], rms_norm(x, p["norm1"], eps), cfg,
                schedule=schedule, block=attn_block)
            x = x + attn.attention_forward(
                p["cross_attn"], rms_norm(x, p["norm2"], eps), cfg,
                causal=False, x_kv=enc, use_rope=False)
            x = x + mlpm.mlp_forward(p["mlp"], rms_norm(x, p["norm3"], eps),
                                     cfg)
        return rms_norm(x, params["final_norm"], eps), _zero(x)

    def decode(params, cache, tokens, pos, extras):
        """cache["cross_k"] / ["cross_v"] (L, B, n_frames, KV, hd) hold
        each layer's ``attention.cross_attention_cache`` of the encoder
        output; they pass through unchanged."""
        x = _embed_lookup(params["embed"], tokens, dtype)
        new = []
        for p, kv, ck, cv in zip(_layer_params(params["dec"], cfg.n_layers),
                                 _layer_params(cache["kv"], cfg.n_layers),
                                 cache["cross_k"], cache["cross_v"]):
            h, kv = attn.decode_attention(
                p["self_attn"], rms_norm(x, p["norm1"], eps), cfg, kv, pos)
            x = x + h
            x = x + attn.cross_attention_decode(
                p["cross_attn"], rms_norm(x, p["norm2"], eps), cfg, ck, cv)
            x = x + mlpm.mlp_forward(p["mlp"], rms_norm(x, p["norm3"], eps),
                                     cfg)
            new.append(kv)
        x = rms_norm(x, params["final_norm"], eps)
        return _project(params, x, cfg), {"kv": _stack_layers(new),
                                          "cross_k": cache["cross_k"],
                                          "cross_v": cache["cross_v"]}

    m = Model(cfg, defs, forward, decode)
    m.encode = encode
    return m
