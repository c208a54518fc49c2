"""Sequence-chunked pipeline executor (port of the reference's legacy
per-tick interpreter, ``repro/seqpipe/runtime.py``).

:class:`SeqExecutor` is :class:`~repro_torch.core.pipeline_runtime.
_Executor` with the fifth scheduling coordinate: it shares its payload
rings (sized for ``Sc = S / n_seq`` positions), its tick loop and its
routes, and replaces the op.  Every task processes one sequence chunk
of one microbatch, at positions ``[q*Sc, (q+1)*Sc)``, and two rings per
(device, chunk) thread causal attention across the chunks of a
microbatch, one slot per in-flight microbatch (``kv_depth``, the table's
``kv_slot`` column):

- **KV-carry ring**: the full-sequence K/V ``[M, period, mbB, S, G,
  hd]`` of every layer the chunk hosts.  An F op runs under
  ``torch.no_grad`` with the slot as each layer's buffer at offset
  ``q*Sc`` (positions past the causal frontier hold older data and are
  masked: their probability is exactly 0) and writes the merged buffer
  back into the slot in place.
- **dKV ring** (same slots): the K/V cotangents accumulated by the
  later chunks.  Backwards run in reverse chunk order; a B op replays
  its chunk from the boundary payload and the slot's K/V, which enters
  as a detached leaf that requires grad, seeds the cotangent of the
  merged K/V with the dKV slot (the first backward of a microbatch,
  ``q == n_seq-1``, seeds nothing: zeros), adds the weight gradients
  into the accumulators and writes the K/V input's cotangent (the prefix
  positions' sum, plus this chunk's attention to the prefix) back to the
  dKV slot for chunk ``q-1``.

R ops move the boundary to the remat ring as the base executor's do
(``chronos_seq`` with ``recomp_chunks``).  The boundary payloads of
``Sc`` positions travel in the wire's form (``spec.wire``) through the
base executor's rings; the KV-carry and dKV rings stay exact.  Each last-stage chunk's loss
is its partial sum over the whole microbatch's count (``mbB * S``
tokens, or the microbatch's mask sum under ``batch["loss_mask"]``), so
the chunk losses, and their gradient seeds, sum to the unchunked mean.

Scope, as in the reference: dense attention LMs (no SSM or MoE layers,
so the payload's aux sum is not carried), the interleaved placement and
fused backwards (no W ops); ``make_pipeline_spec`` refuses the rest.
"""
from __future__ import annotations

import torch

from repro_torch.core.pipeline_runtime import (PipelineSpec, _at,
                                               _embed_tokens, _Executor,
                                               _with_grad)
from repro_torch.core.tasktable import F_OPS, R_OPS
from repro_torch.models import backend as compute_backend
from repro_torch.models.transformer import _dtype

KV = ("k", "v")


class SeqExecutor(_Executor):
    """The base executor's rings plus the KV-carry and dKV rings, and the
    sequence-chunked op."""

    def __init__(self, spec: PipelineSpec, device):
        super().__init__(spec, device)
        self.x = self.leaves[0]         # the payload: x alone, no aux sum
        tab, cfg, lay = spec.table, spec.cfg, spec.layout
        assert spec.n_seq > 1 and not tab.has_w
        assert tab.placement_name == "interleaved", \
            "the sequence-chunked executor runs the interleaved placement"
        shape = (lay.M, lay.period, spec.mbB, spec.S, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = _dtype(cfg.compute_dtype)

        def ring(depth):
            return {n: torch.zeros((depth,) + shape, dtype=dt,
                                   device=device) for n in KV}

        for name in ("kv", "dkv"):
            self.rings[name] = [{c: ring(k) for c, k in tab.kv_depth.items()}
                                for _ in range(tab.P)]

    def _op(self, d, row, params, shared, batch, acc):
        spec, r, Sc = self.spec, self.rings, self.Sc
        op, c, mb, src, aslot = (int(x) for x in row[:5])
        if op in R_OPS:
            return super()._op(d, row, params, shared, batch, acc)
        rslot, q, kslot = int(row[13]), int(row[14]), int(row[15])
        first, last = self._ends(d, c)
        flags_c = {k: a[d, c] for k, a in self.flags.items()}
        pos0 = q * Sc
        tokens = batch["tokens"][mb]
        tok_in = tokens[:, pos0:pos0 + Sc]
        labels = tokens[:, pos0 + 1:pos0 + Sc + 1]
        if "loss_mask" in batch:           # label-aligned [mbB, S]
            mask_full = batch["loss_mask"][mb]
            mask = mask_full[:, pos0:pos0 + Sc]
            denom = torch.clamp(mask_full.sum(), min=1.0)
        else:
            mask, denom = None, float(spec.mbB * spec.S)
        kv = {n: _at(r["kv"][d][c][n], kslot) for n in KV}
        dkv = {n: r["dkv"][d][c][n][kslot] for n in KV}

        def chunk(blocks_c, x, kv_in):
            return compute_backend.chunk_fwd(spec, blocks_c, flags_c, x,
                                             kv=kv_in, pos0=pos0)

        def head(sh, x):
            return compute_backend.head_loss(spec, sh, x, labels, mask,
                                             denom=denom)

        if op in F_OPS:
            with torch.no_grad():
                x_in = _embed_tokens(spec, shared, tok_in) if first \
                    else self.x.read("fq", d, None, src)
                if aslot >= 0 and not first:   # as the base executor's F
                    self._move(("fq", d, None, src), ("act", d, c, aslot))
                out, _, kv_out = chunk(self._block(params, d, c, False),
                                       x_in, kv)
                for n in KV:
                    kv[n].copy_(kv_out[n])
                if last:
                    acc["loss"] += head(shared, out)
                    if q == 0:
                        acc["n"] += 1
                    return None
                return out, None

        # B: replay the chunk over the slot's K/V; the K/V input needs its
        # cotangent only when an earlier chunk (q > 0) will read it
        blocks_c = self._block(params, d, c, True)
        sh = _with_grad(shared) if (first or last) else shared
        kv_in = {n: kv[n].detach().requires_grad_(q > 0) for n in KV}
        with torch.enable_grad():
            if first:
                x = _embed_tokens(spec, sh, tok_in)
            else:
                x = self._boundary(d, c, aslot, rslot)[0].detach() \
                    .requires_grad_()
            out, _, kv_out = chunk(blocks_c, x, kv_in)
            outs = [head(sh, out) if last else out]
            seeds = [None if last else self.x.read("bq", d, None, src)]
            if q < spec.n_seq - 1:
                outs += [kv_out[n] for n in KV]
                seeds += [dkv[n] for n in KV]
            extra = ([kv_in[n] for n in KV] if q > 0 else []) \
                + ([] if first else [x])
            gs = self._accumulate(acc, d, c, blocks_c, sh, first or last,
                                  outs, seeds, extra)
        if q > 0:
            for n, g in zip(KV, gs):
                dkv[n].copy_(g)
        return None if first else (gs[-1], None)
