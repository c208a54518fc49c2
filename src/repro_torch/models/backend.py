"""Compute-backend seam (port of ``repro/models/backend.py``).

The layer body calls ``backend.rmsnorm``, ``backend.flash`` and
``backend.ssd``; the backend, chosen by the ``kernels=`` flag, decides
what runs:

- ``"fused"`` (the default): the hand-written CUDA kernels
  (:mod:`repro_torch.kernels`) — RMSNorm rows for every layer norm (the
  split-width pair where tensor parallelism cuts a row), the
  flash-attention forward for every whole-sequence or prefill-chunk
  attention, and the SSD chunk scan for every Mamba-2 scan, from a zero
  state (training) or from a carried one (serving's prefill chunks) —
  through their ``torch.autograd.Function`` s, so gradients flow through
  them (kernel forward, plain-version backward, as the reference's
  ``custom_vjp`` s do).  On CPU tensors the kernel wrappers run their
  plain versions.
- ``"plain"`` (the reference's ``"xla"`` twin): plain PyTorch ops, never
  a kernel of this package.

:func:`chunk_fwd` and :func:`head_loss` are the ChunkBody seam the
pipeline executor runs every F, B and W op through.  Neither takes a
sharding argument: under a mesh the executor installs its
:class:`~repro_torch.models.sharding.ShardEnv` around the tick loop, and
the layers read it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import (rmsnorm_fused,
                                             rmsnorm_split_fused)
from repro_torch.kernels.ssd_scan.ops import ssd as ssd_fused
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_ref
from repro_torch.models import layers as L
from repro_torch.models.sharding import tp_all_reduce


@dataclass(frozen=True)
class ComputeBackend:
    """One implementation of the layer body's kernel-backed ops."""
    name: str = "plain"
    fuse_rmsnorm: bool = False
    fuse_attention: bool = False
    fuse_ssd: bool = False

    def rmsnorm(self, params, x, eps: float = 1e-6):
        if not self.fuse_rmsnorm:
            return L.rmsnorm(params, x, eps)
        return rmsnorm_fused(x, params["scale"], eps)

    def rmsnorm_split(self, params, x, eps: float, d_full: int, env):
        """RMSNorm of rows whose ``d_full`` columns are cut over ``env``'s
        tp ranks: the split-width kernel pair around the all-reduce of the
        rows' sums of squares, or the plain version."""
        if not self.fuse_rmsnorm:
            return L.rmsnorm_split(params, x, eps, d_full, env)
        return rmsnorm_split_fused(x, params["scale"], d_full,
                                   tp_all_reduce(env), eps)

    def flash(self, q, k, v, *, causal: bool, window: int, prefix: int,
              q_offset: int = 0):
        """q [B,S,H,d]; k,v [B,T,G,d]; ``q_offset`` a host int."""
        return flash_attention(q, k, v, causal, window, prefix, q_offset)

    def ssd(self, x, Bc, Cc, dt, A, *, chunk: int, h0=None):
        """The Mamba-2 chunk scan, from a zero state or from a carried
        fp32 ``h0`` [B,H,P,N] (serving's prefill chunks).  The kernel
        takes both, where the reference's Pallas kernel starts only from
        zero and sends a carried state to its XLA scan."""
        if self.fuse_ssd:
            return ssd_fused(x, Bc, Cc, dt, A, chunk=chunk, h0=h0)
        return ssd_chunked_ref(x, Bc, Cc, dt, A, chunk, h0)


PLAIN = ComputeBackend("plain")
FUSED = ComputeBackend("fused", fuse_rmsnorm=True, fuse_attention=True,
                       fuse_ssd=True)

_REGISTRY = {"plain": PLAIN, "fused": FUSED}


def get_backend(kernels=None) -> ComputeBackend:
    """Resolve a ``kernels=`` flag ("fused" | "plain" | ComputeBackend |
    None => fused) to a backend instance."""
    if kernels is None:
        return FUSED
    if isinstance(kernels, ComputeBackend):
        return kernels
    try:
        return _REGISTRY[kernels]
    except KeyError:
        raise ValueError(f"unknown kernels flag {kernels!r}: expected "
                         f"{sorted(_REGISTRY)}") from None


# ---------------------------------------------------------------------------
# the ChunkBody seam
# ---------------------------------------------------------------------------

def chunk_fwd(spec, block_params_c, flags_c, x, aux=None, enc=None, *,
              kv=None, pos0=0):
    """Run one stage's layer chunk over the boundary payload (``x`` [B,
    Sc, d], the fp32 aux sum ``aux`` [1] and, in an encoder-decoder
    config, the encoder output ``enc`` [B, T, d]) and return the new
    boundary ``(x, aux)``: each MoE layer adds its gate-weighted
    load-balancing loss to ``aux`` (None reads as 0); every layer's
    cross-attention reads ``enc``, which the payload carries on
    unchanged.  ``spec.prefix`` leading positions of ``x`` (a VLM's
    patches) attend bidirectionally.

    ``block_params_c``: per period position, leaves [M, ...];
    ``flags_c``: {window, gate} host numpy [M, period] — host values, so
    the layer's ``gate != 1.0`` test costs no device sync.  The
    reference wraps its scan body in ``jax.checkpoint``; here the caller
    recomputes the chunk from its boundary at every B and W op, and the
    flash Function saves only q, k and v.

    Sequence-chunked mode (``kv`` = {"k", "v"} with leaves [M, period,
    B, S, G, hd], the microbatch's full-sequence K/V of every layer of
    the chunk; ``pos0`` the host offset of the chunk's first position):
    the positions are ``pos0 + arange(Sc)``, every layer attends over its
    buffer with the chunk's K/V merged in out of place, and the call
    returns ``(x, aux, kv_out)``, ``kv_out`` the merged buffers stacked
    as ``kv``'s leaves."""
    from repro_torch.models.transformer import _apply_layer, _index
    bk = get_backend(spec.kernels)
    cfg = spec.cfg
    Bz, Sc, _ = x.shape
    positions = (pos0 + torch.arange(Sc, device=x.device))[None].expand(
        Bz, Sc)
    win, gate = flags_c["window"], flags_c["gate"]
    acc = aux[0] if aux is not None else 0.0
    outs = []
    for mi in range(win.shape[0]):
        for j in range(spec.layout.period):
            x, nc, acc = _apply_layer(
                _index(block_params_c[j], mi), x, positions, cfg, j,
                kv=None if kv is None else {"k": kv["k"][mi, j],
                                            "v": kv["v"][mi, j]},
                cache_pos=pos0, enc_out=enc, prefix_len=spec.prefix,
                aux_sum=acc,
                window_override=int(win[mi, j]), gate=float(gate[mi, j]),
                backend=bk)
            outs.append(nc)
    if isinstance(acc, torch.Tensor):
        aux = acc.reshape(1)
    if kv is None:
        return x, aux
    shape = kv["k"].shape
    return x, aux, {n: torch.stack([o[n] for o in outs]).view(shape)
                    for n in ("k", "v")}


def head_loss(spec, params, x, labels, loss_mask=None, denom=None,
              aux=None):
    """Final norm + unembed + CE, plus ``spec.aux_weight`` times the
    payload's MoE aux sum ``aux`` [1] where one is given: the loss of one
    microbatch at the last stage.  The ``spec.prefix`` patch positions
    are dropped before the head.  ``denom``: a fixed normalizer (the
    sequence-chunked executor's whole-microbatch token or mask count, so
    chunk losses sum to the microbatch's mean; a data-parallel rank's
    global-microbatch count, so the ranks' losses sum to it).  Under a
    tensor-parallel env the head is vocab-parallel
    (:func:`repro_torch.models.layers.unembed`, ``softmax_xent``) and
    every tp rank returns the whole loss."""
    bk = get_backend(spec.kernels)
    if spec.prefix:
        x = x[:, spec.prefix:]
    h = bk.rmsnorm(params["final_norm"], x, spec.cfg.norm_eps)
    V = spec.cfg.vocab_size
    logits = L.unembed(params["embed"], h, vocab=V)
    ce = L.softmax_xent(logits, labels, loss_mask, denom=denom, vocab=V)
    if aux is None:
        return ce
    return ce + spec.aux_weight * aux[0]
