"""LM of the port: the dense-attention (with local/global sliding
windows), Mamba-2, MoE, hybrid, VLM-prefix (paligemma) and
encoder-decoder (whisper) paths of ``repro/models/transformer.py``.
Each decoder layer is ``norm1`` + attention or Mamba-2 block, then, in
an encoder-decoder config, ``norm_x`` + cross-attention into the encoder
output, then ``norm2`` + an MoE FFN on the config's MoE layers, else an
MLP when the config has an FFN.  MoE layers add their load-balancing
loss, weighted by the layer's gate, into the aux sum that ``LM.loss``
adds at 0.01.  A VLM's patch embeddings are a prefix of the sequence
that attends bidirectionally (the prefix-LM mask); ``LM.loss`` drops
their positions.

Parameters are a plain tree with the reference's structure and layout:
``{"embed": {"tokens"[, "head"]}, "final_norm": {"scale"}, "layers":
[per period position: leaves stacked [num_periods, ...]], "rem_layers":
[...]}``, plus ``"encoder"`` (a list of per-layer trees) and
``"enc_norm"`` in an encoder-decoder config, so
:mod:`repro_torch.bridge` carries JAX weights across leaf for leaf.  The
reference scans over periods; here that scan is a Python loop over the
stacked leading axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RecomputeConfig
from repro_torch.models import backend as B
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.sharding import gather_at_use, spec_map


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layers(gen, cfg: ModelConfig, n: int, device,
                 idx: int) -> Dict[str, Any]:
    """``n`` decoder layers shaped as layer ``idx`` (its period position
    decides the kind and the FFN) with leaves stacked [n, ...]:
    ``norm1`` and the mixer (attention or Mamba-2), ``norm_x`` and the
    bias-free ``cross``-attention in an encoder-decoder config, then
    ``norm2`` and the MoE FFN on an MoE layer, else the MLP when the
    config has an FFN (``d_ff > 0``; mamba2 has none, jamba's Mamba-2
    layers have one)."""
    dt = _dtype(cfg.param_dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

    def ones():
        return torch.ones((n, d), dtype=dt, device=device)

    def dense(shape, fan_in):
        return L.dense_init(gen, (n,) + shape, fan_in, dt, device)

    layer: Dict[str, Any] = {"norm1": {"scale": ones()}}
    if cfg.layer_kind(idx) == "attn":
        layer["attn"] = _attn_leaves(dense, cfg)
        if cfg.qkv_bias:
            for name, width in (("bq", H * hd), ("bk", G * hd),
                                ("bv", G * hd)):
                layer["attn"][name] = torch.zeros((n, width), dtype=dt,
                                                  device=device)
    else:
        layer["mamba"] = M.init_mamba(gen, n, d, cfg.ssm, dt, device)
    if cfg.encdec is not None:
        layer["norm_x"] = {"scale": ones()}
        layer["cross"] = _attn_leaves(dense, cfg)
    if cfg.layer_is_moe(idx):
        layer["norm2"] = {"scale": ones()}
        layer["moe"] = MOE.init_moe(gen, n, d, cfg.moe, cfg.act, dt,
                                    device)
    elif ff:
        layer["norm2"] = {"scale": ones()}
        layer["mlp"] = L.init_mlp(gen, n, d, ff, cfg.act, dt, device)
    return layer


def layer_specs(cfg: ModelConfig, idx: int) -> Dict[str, Any]:
    """Logical sharding specs of one decoder layer shaped as layer
    ``idx`` (the tree of :func:`_init_layers` without its stacked axis):
    the reference's ``_init_layer`` specs."""
    s: Dict[str, Any] = {"norm1": L.rmsnorm_specs()}
    if cfg.layer_kind(idx) == "attn":
        s["attn"] = L.attention_specs(cfg.qkv_bias)
    else:
        s["mamba"] = M.mamba_specs()
    if cfg.encdec is not None:
        s["norm_x"] = L.rmsnorm_specs()
        s["cross"] = L.attention_specs(False)
    if cfg.layer_is_moe(idx):
        s["norm2"] = L.rmsnorm_specs()
        s["moe"] = MOE.moe_specs(cfg.moe, cfg.act)
    elif cfg.d_ff:
        s["norm2"] = L.rmsnorm_specs()
        s["mlp"] = L.mlp_specs(cfg.act)
    return s


def encoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical specs of :func:`_init_encoder`'s ``encoder`` and
    ``enc_norm`` (the reference's ``LM.init`` encoder specs)."""
    one = {"norm1": L.rmsnorm_specs(), "attn": L.attention_specs(False),
           "norm2": L.rmsnorm_specs(), "mlp": L.mlp_specs(cfg.act)}
    return {"encoder": [dict(one) for _ in
                        range(cfg.encdec.num_encoder_layers)],
            "enc_norm": L.rmsnorm_specs()}


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical sharding specs of :meth:`LM.init`'s tree (the reference's
    ``LM.init`` specs, its ``_specs_only``): each stacked period leaf's
    layer spec behind a None for the stacked axis, the remainder layers'
    own, the embedding's, the final norm's and an encoder-decoder
    config's encoder."""
    nper = cfg.num_layers // cfg.period
    specs: Dict[str, Any] = {
        "embed": L.embed_specs(cfg.tie_embeddings),
        "final_norm": L.rmsnorm_specs(),
        "layers": [spec_map(lambda sp: (None,) + tuple(sp),
                            layer_specs(cfg, j))
                   for j in range(cfg.period) if nper],
        "rem_layers": [layer_specs(cfg, nper * cfg.period + r)
                       for r in range(cfg.num_layers - nper * cfg.period)]}
    if cfg.encdec is not None:
        specs.update(encoder_specs(cfg))
    return specs


def _attn_leaves(dense, cfg: ModelConfig) -> Dict[str, Any]:
    """Bias-free attention projections ``wq``, ``wk``, ``wv``, ``wo``
    drawn by ``dense(shape, fan_in)``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G = cfg.num_heads, cfg.num_kv_heads
    return {"wq": dense((d, H * hd), d), "wk": dense((d, G * hd), d),
            "wv": dense((d, G * hd), d), "wo": dense((H * hd, d), H * hd)}


def _init_encoder(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The encoder of an encoder-decoder config: ``encoder``, a list of
    per-layer trees (``norm1``, bias-free ``attn``, ``norm2``, ``mlp``),
    and ``enc_norm``."""
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model

    def dense(shape, fan_in):
        return L.dense_init(gen, shape, fan_in, dt, device)

    def ones():
        return {"scale": torch.ones((d,), dtype=dt, device=device)}

    enc = [{"norm1": ones(), "attn": _attn_leaves(dense, cfg),
            "norm2": ones(),
            "mlp": _index(L.init_mlp(gen, 1, d, cfg.d_ff, cfg.act, dt,
                                     device), 0)}
           for _ in range(cfg.encdec.num_encoder_layers)]
    return {"encoder": enc, "enc_norm": ones()}


def _init_cache_layer(cfg: ModelConfig, idx: int, batch: int, seq: int,
                      device, enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """Cache of one layer: K/V [batch, seq, G, hd] zeros for attention;
    conv tails and the fp32 state for a Mamba-2 layer; in an
    encoder-decoder config also the cross K/V ``xk``, ``xv`` [batch,
    enc_len, G, hd]."""
    dt = _dtype(cfg.param_dtype)
    if cfg.layer_kind(idx) == "mamba":
        c = M.init_mamba_cache(batch, cfg.d_model, cfg.ssm, dt, device)
    else:
        shape = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.encdec is not None:
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["xk"] = torch.zeros(shape, dtype=dt, device=device)
        c["xv"] = torch.zeros(shape, dtype=dt, device=device)
    return c


def _apply_layer(p, x, positions, cfg: ModelConfig, idx: int, *,
                 cache=None, kv=None, cache_pos: int = 0, enc_out=None,
                 prefix_len: int = 0, aux_sum=0.0, window_override=None,
                 gate=None, backend=None):
    """One decoder layer.  Returns (x, new_cache, aux_sum): an MoE layer
    adds its ``lb_loss`` (times ``gate``) to ``aux_sum``.

    ``cache``: serving's slot cache, written in place; ``kv``: a
    sequence-chunked training step's full-sequence K/V buffer, merged
    out of place (:func:`repro_torch.models.layers.attention`); both at
    ``cache_pos``.  Attention layers only take ``kv``.

    Cross-attention (a layer with ``cross``): with ``enc_out`` (the
    encoder output [B, T, d]) its K/V are projected from it, and written
    into ``cache["xk"]``/``["xv"]`` in place where a cache is given (a
    prefill); without it, a cache's ``xk``/``xv`` are read (decode).
    ``prefix_len``: the bidirectional prefix of the self-attention mask
    (a VLM's patch positions).

    ``window_override``: per-layer sliding window carried as data (the
    pipeline engine's flags).  ``gate``: 0/1 multiplier on the residual
    branches and the aux term (0 = padding layer: passthrough).
    ``backend``: compute backend; None = the default (fused)."""
    bk = backend if backend is not None else B.get_backend()
    kind = cfg.layer_kind(idx)
    scaled = gate is not None and gate != 1.0   # x * 1.0 is x: skip the op
    if window_override is not None:
        window = window_override
        if bk.fuse_attention and cfg.sliding_window == 0:
            # every layer's true window is statically 0, so the per-layer
            # flag carries no information — drop it to keep the flash
            # kernel's mask static
            window = 0
    else:
        window = 0 if cfg.layer_is_global(idx) else cfg.sliding_window
    h = bk.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        y, new_cache = L.attention(
            p["attn"], h, positions, num_heads=cfg.num_heads,
            num_kv=cfg.num_kv_heads, hd=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, causal=True, window=window,
            prefix_len=prefix_len, cache=cache, kv=kv, cache_pos=cache_pos,
            backend=bk)
    else:
        if kv is not None:
            raise ValueError("a KV buffer needs an attention layer; "
                             "sequence chunking is dense-attention only")
        y, new_cache = M.mamba_block(p["mamba"], h, cfg.ssm, cache=cache,
                                     norm_eps=cfg.norm_eps, backend=bk)
    if scaled:
        y = y * gate
    x = x + y
    if "cross" in p and (enc_out is not None
                         or (cache is not None and "xk" in cache)):
        h = bk.rmsnorm(p["norm_x"], x, cfg.norm_eps)
        kw = dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                  hd=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                  causal=False, use_rope=False)
        if enc_out is not None:
            # train / prefill: the cross K/V from the encoder output
            y, (xk, xv) = L.attention(p["cross"], h, positions,
                                      kv_x=enc_out, return_kv=True, **kw)
            if cache is not None:
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
        else:
            # decode: the cached cross K/V
            y, _ = L.attention(p["cross"], h, positions,
                               kv_direct=(cache["xk"], cache["xv"]), **kw)
        if scaled:
            y = y * gate
        x = x + y
    if "moe" in p:
        h = bk.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, aux = MOE.moe_ffn(p["moe"], h, cfg.moe, cfg.act)
        lb = aux["lb_loss"]
        if scaled:
            y, lb = y * gate, lb * gate
        aux_sum = aux_sum + lb
        x = x + y
    elif "mlp" in p:
        h = bk.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y = L.mlp(p["mlp"], h, cfg.act, d_ff=cfg.d_ff)
        if scaled:
            y = y * gate
        x = x + y
    return x, new_cache, aux_sum


def encode(cfg: ModelConfig, params, frame_embeds, backend):
    """The encoder of an encoder-decoder config over precomputed frame
    embeddings [B, T, d]: pre-norm layers of bidirectional self-attention
    (the flash kernel with ``causal=False`` on the fused backend) and an
    MLP, then ``enc_norm``.  ``params`` holds ``encoder`` and
    ``enc_norm``; under a tp env the layers run on their leaves' tp
    shards, as the decoder's, and the output is equal on every tp
    rank."""
    x = frame_embeds.to(_dtype(cfg.compute_dtype))
    Bz, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(Bz, T)
    for pe in params["encoder"]:
        h = backend.rmsnorm(pe["norm1"], x, cfg.norm_eps)
        y, _ = L.attention(
            pe["attn"], h, positions, num_heads=cfg.num_heads,
            num_kv=cfg.num_kv_heads, hd=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, causal=False, backend=backend)
        x = x + y
        h = backend.rmsnorm(pe["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(pe["mlp"], h, cfg.act, d_ff=cfg.d_ff)
    return backend.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _index(tree, i):
    """Leaf-wise ``a[i]`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

class LM:
    """Decoder LM (dense attention, Mamba-2, MoE or hybrid; a VLM's patch
    prefix; an encoder-decoder's encoder).  ``kernels`` selects the
    compute backend ("fused" default, or "plain"); ``device`` where
    parameters and caches live (CUDA unless the caller asks for the
    CPU).

    ``fsdp`` (ZeRO-3 on a mesh): a tree shaped as the parameters giving
    the dimension each leaf is held cut over dp on (None: whole), from
    :meth:`~repro_torch.models.sharding.TreeShard.fsdp_tree`.  Each
    layer's leaves are then gathered where the layer runs, inside its
    period's Chronos-Recomp checkpoint, so the recompute gathers them
    again and only the slices live between forward and backward; the
    embedding, head and encoder leaves are gathered where they are used
    and live until the microbatch's backward."""

    def __init__(self, cfg: ModelConfig, *, kernels=None, device="cuda",
                 fsdp=None):
        self.cfg = cfg
        self.backend = B.get_backend(kernels)
        self.device = resolve_device(device)
        self.period = cfg.period
        self.num_periods = cfg.num_layers // self.period
        self.num_rem = cfg.num_layers - self.num_periods * self.period
        self.fsdp = fsdp

    def _use(self, tree, *path, shift: int = 0):
        """The subtree at ``path`` of a parameter tree's ``tree`` as the
        layers read it: its dp slices gathered under ``fsdp``."""
        dims = self.fsdp
        for k in path:
            dims = None if dims is None else dims[k]
        return gather_at_use(tree, dims, shift)

    # -- init ----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters from ``generator`` (drawn on the generator's
        device, stored on ``self.device``) at ``dense_init``'s scale; the
        draws are not the reference's bits."""
        cfg, dev = self.cfg, self.device
        dt = _dtype(cfg.param_dtype)
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": {"tokens": L.dense_init(generator, (cfg.vocab_size, d),
                                             d, dt, dev)}}
        if not cfg.tie_embeddings:
            params["embed"]["head"] = L.dense_init(
                generator, (d, cfg.vocab_size), d, dt, dev)
        params["final_norm"] = {"scale": torch.ones((d,), dtype=dt,
                                                    device=dev)}
        params["layers"] = [_init_layers(generator, cfg, self.num_periods,
                                         dev, j)
                            for j in range(self.period)
                            if self.num_periods]
        base = self.num_periods * self.period
        params["rem_layers"] = [
            _index(_init_layers(generator, cfg, 1, dev, base + r), 0)
            for r in range(self.num_rem)]
        if cfg.encdec is not None:
            params.update(_init_encoder(generator, cfg, dev))
        return params

    # -- encoder -------------------------------------------------------------
    def encode(self, params, frame_embeds):
        """The encoder over frame embeddings [B, T, d] (:func:`encode`)."""
        enc = {k: self._use(params[k], k) for k in ("encoder", "enc_norm")}
        return encode(self.cfg, enc, frame_embeds, self.backend)

    # -- decoder stack -------------------------------------------------------
    def _stack(self, params, x, positions, *, cache=None, cache_pos=0,
               enc_out=None, prefix_len: int = 0,
               recomp: Optional[RecomputeConfig] = None,
               num_chunks: int = 1):
        """Run all decoder layers; returns ``(x, aux)``, ``aux`` the fp32
        sum of the MoE layers' load-balancing losses (0 without MoE).
        The periods split into ``num_chunks`` Chronos chunks as the
        reference's do; with ``recomp`` (and no cache) every period of
        chunk ``ci`` runs under :func:`_wrap_remat`'s checkpoint.  The
        remainder layers (the deepest, of the last chunk) run unwrapped,
        as in the reference."""
        cfg = self.cfg
        nper = self.num_periods
        chunk_bounds = [round(c * nper / num_chunks)
                        for c in range(num_chunks + 1)]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def period_body(x, aux, i):
            for j in range(self.period):
                c = None if cache is None else _index(cache["periods"][j], i)
                x, _, aux = _apply_layer(
                    self._use(_index(params["layers"][j], i), "layers", j,
                              shift=1), x, positions, cfg, j,
                    cache=c, cache_pos=cache_pos, enc_out=enc_out,
                    prefix_len=prefix_len, aux_sum=aux,
                    backend=self.backend)
            return x, aux

        for ci in range(num_chunks):
            body = period_body
            if recomp is not None and cache is None:
                body = _wrap_remat(period_body, recomp, ci)
            for i in range(chunk_bounds[ci], chunk_bounds[ci + 1]):
                x, aux = body(x, aux, i)
        for r in range(self.num_rem):
            idx = nper * self.period + r
            c = None if cache is None else cache["rem"][r]
            x, _, aux = _apply_layer(self._use(params["rem_layers"][r],
                                               "rem_layers", r), x,
                                     positions, cfg, idx, cache=c,
                                     cache_pos=cache_pos,
                                     enc_out=enc_out, prefix_len=prefix_len,
                                     aux_sum=aux, backend=self.backend)
        return x, aux

    def embed(self, params, tokens):
        """Token embedding scaled by sqrt(d), in the compute dtype.  The
        scale is rounded to the embedding's dtype first, as the
        reference's ``jnp.asarray(d ** 0.5, x.dtype)`` does.  Under a tp
        env that splits the vocab, the vocab-parallel lookup."""
        x = L.embed(self._embed_leaf(params, "tokens"), tokens,
                    vocab=self.cfg.vocab_size)
        mult = torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype).item()
        return (x * mult).to(_dtype(self.cfg.compute_dtype))

    def head(self, params, x):
        """Final norm and logits (under a tp env that splits the vocab,
        the rank's vocab columns)."""
        x = L.rmsnorm(self._use(params["final_norm"], "final_norm"), x,
                      self.cfg.norm_eps)
        key = "head" if "head" in params["embed"] else "tokens"
        return L.unembed(self._embed_leaf(params, key), x,
                         vocab=self.cfg.vocab_size)

    def _embed_leaf(self, params, key):
        """``{key: params["embed"][key]}``, gathered under ``fsdp``: the
        one embedding leaf a lookup or the head reads."""
        return {key: self._use(params["embed"][key], "embed", key)}

    def embed_prefix(self, params, tokens, patch_embeds=None):
        """:meth:`embed`, with a VLM's patch embeddings [B, P, d] ahead of
        the tokens (cast to the embedding's dtype, then with it to the
        compute dtype, as the reference concatenates them)."""
        x = self.embed(params, tokens)
        if patch_embeds is None:
            return x
        patch = patch_embeds.to(params["embed"]["tokens"].dtype)
        return torch.cat([patch.to(x.dtype), x], dim=1)

    def hidden(self, params, tokens, *, positions=None, cache=None,
               cache_pos: int = 0, recomp=None, num_chunks: int = 1,
               patch_embeds=None, frame_embeds=None):
        """tokens [B, S] -> (the last layer's hidden states [B, P + S, d]
        before the head, the MoE aux sum).  ``patch_embeds`` [B, P, d]:
        a VLM's patch prefix (P positions ahead of the tokens, attending
        bidirectionally); ``frame_embeds`` [B, T, d]: the encoder's input,
        encoded once and cross-attended by every decoder layer.  K/V
        (cross K/V too) and SSM state are written into ``cache`` in
        place."""
        x = self.embed_prefix(params, tokens, patch_embeds)
        Bz, S = x.shape[:2]
        if positions is None:
            pos0 = cache_pos if cache is not None else 0
            positions = (pos0 + torch.arange(S, device=tokens.device)
                         )[None].expand(Bz, S)
        enc_out = None
        if frame_embeds is not None:
            enc_out = self.encode(params, frame_embeds)
        return self._stack(params, x, positions, cache=cache,
                           cache_pos=cache_pos, enc_out=enc_out,
                           prefix_len=0 if patch_embeds is None
                           else patch_embeds.shape[1],
                           recomp=recomp, num_chunks=num_chunks)

    # -- public entry points ---------------------------------------------
    def forward(self, params, tokens, *, positions=None, cache=None,
                cache_pos: int = 0, recomp=None, num_chunks: int = 1,
                patch_embeds=None, frame_embeds=None):
        """tokens [B, S] -> (logits [B, P + S, V], cache).  ``recomp`` (a
        :class:`RecomputeConfig`) and ``num_chunks``: Chronos-Recomp over
        the stack's chunks (training only; ignored with a cache);
        ``patch_embeds``, ``frame_embeds``: as :meth:`hidden`."""
        x, _ = self.hidden(params, tokens, positions=positions, cache=cache,
                           cache_pos=cache_pos, recomp=recomp,
                           num_chunks=num_chunks, patch_embeds=patch_embeds,
                           frame_embeds=frame_embeds)
        return self.head(params, x), cache

    def loss(self, params, batch, *, recomp=None, num_chunks: int = 1,
             denom=None):
        """batch: {'tokens': [B, S], 'loss_mask': [B, S] optional,
        'patch_embeds' [B, P, d] / 'frame_embeds' [B, T, d] optional}.
        Next-token CE over the token positions (a VLM's patch positions
        are dropped before the head) plus 0.01 times the MoE layers'
        load-balancing sum (the single-device training loss, and the
        oracle of the pipeline executor).  ``denom``: a fixed normalizer
        of the CE in place of the local mean (a data-parallel rank's
        global-microbatch count, so the ranks' losses sum to the global
        mean).  Returns ``(ce + 0.01 * aux, {"ce": ce, "aux": aux})``."""
        tokens = batch["tokens"]
        patch = batch.get("patch_embeds")
        x, aux = self.hidden(params, tokens[:, :-1], recomp=recomp,
                             num_chunks=num_chunks, patch_embeds=patch,
                             frame_embeds=batch.get("frame_embeds"))
        if patch is not None:
            x = x[:, patch.shape[1]:]
        logits = self.head(params, x)
        mask = batch.get("loss_mask")
        ce = L.softmax_xent(logits, tokens[:, 1:],
                            None if mask is None else mask[:, 1:],
                            denom=denom, vocab=self.cfg.vocab_size)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, seq: int):
        """Zero caches for ``batch`` sequences of ``seq`` positions (an
        encoder-decoder config's layers also hold the cross K/V of its
        ``num_frames`` encoder positions)."""
        cfg = self.cfg
        enc_len = cfg.encdec.num_frames if cfg.encdec is not None else 0

        def layer(idx):
            return _init_cache_layer(cfg, idx, batch, seq, self.device,
                                     enc_len)

        def stacked(j):
            one = layer(j)
            return {k: a[None].repeat((self.num_periods,) + (1,) * a.dim())
                    for k, a in one.items()}
        return {"periods": [stacked(j) for j in range(self.period)],
                "rem": [layer(self.num_periods * self.period + r)
                        for r in range(self.num_rem)]}

    def prefill(self, params, tokens, cache, **kw):
        return self.prefill_chunk(params, tokens, cache, 0, **kw)

    def prefill_chunk(self, params, tokens, cache, pos0: int, **kw):
        """Seq-chunked prefill: run ``tokens`` [B, Sc] at offset ``pos0``
        against an existing cache (the engine's unit of work).  Returns
        the last position's logits [B, V] and the (updated in place)
        cache.  Only the last position goes through the head.  ``kw``:
        ``patch_embeds`` (a VLM prompt's first chunk: the patches take
        the positions from ``pos0``) and ``frame_embeds`` (the encoder
        runs and its cross K/V are cached), as :meth:`hidden`."""
        x, _ = self.hidden(params, tokens, cache=cache, cache_pos=pos0,
                           **kw)
        return self.head(params, x[:, -1:])[:, -1], cache

    def decode_step(self, params, tokens1, cache, pos: int, **kw):
        """tokens1 [B, 1]; pos: host int (same position for the batch).
        An encoder-decoder config reads its cached cross K/V."""
        positions = torch.full((tokens1.shape[0], 1), pos, dtype=torch.int64,
                               device=tokens1.device)
        x, _ = self.hidden(params, tokens1, positions=positions,
                           cache=cache, cache_pos=pos, **kw)
        return self.head(params, x)[:, -1], cache


# ---------------------------------------------------------------------------
# Chronos-Recomp
# ---------------------------------------------------------------------------

#: The 2-D products ``x @ W`` (3-D activations fold onto ``aten.mm``):
#: the ops JAX's ``dots_with_no_batch_dims_saveable`` saves.  The batched
#: products of the attention scores and of the SSD scan lower to
#: ``aten.bmm`` and are recomputed, as JAX recomputes them.
SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default})


def dots_with_no_batch_dims_saveable(ctx, func, *args, **kwargs):
    """Selective-checkpoint policy: save the projection outputs, recompute
    everything else."""
    if func in SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _selective_contexts():
    return create_selective_checkpoint_contexts(
        dots_with_no_batch_dims_saveable)


def _wrap_remat(body, recomp: RecomputeConfig, chunk_idx: int):
    """Chronos-Recomp: rematerialize the shallowest chunks fully
    (``nothing_saveable``: only the period's input survives); other chunks
    keep the projection outputs and recompute the attention and SSD
    internals (the selective policy, the paper's §6.1 default).
    Non-reentrant, so the stacked parameters the body indexes get their
    gradients; the layers draw no random numbers, so no RNG state is
    stashed.

    The recompute stops early, once the last tensor the backward saved is
    rebuilt (torch's default): a period's trailing MLP down-projection and
    its tp all-reduce do not run again
    (:func:`repro_torch.launch.dryrun.train_collective_stats` counts
    so)."""
    if recomp.mode == "full":
        selective = False
    elif recomp.mode == "chronos" and chunk_idx < recomp.num_recomp_chunks:
        selective = recomp.policy != "full"
    else:
        # "none" / "uniform" / deep chunks: flash-attention semantics only
        selective = True
    context_fn = _selective_contexts if selective else noop_context_fn

    def wrapped(x, aux, i):
        return checkpoint(body, x, aux, i, use_reentrant=False,
                          context_fn=context_fn, preserve_rng_state=False)
    return wrapped
