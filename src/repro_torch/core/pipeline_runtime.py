"""Pipeline training executor on one device: a lockstep interpreter over
a :class:`~repro_torch.core.tasktable.TaskTable` (port of
``repro/core/pipeline_runtime.py``).

The reference runs the table under ``shard_map`` with one mesh position
per stage.  Here the ``P`` device columns are virtual stages on one
card, run in lockstep: at every tick each column executes its F, B, W
or R op on the chunk body (:func:`repro_torch.models.backend.chunk_fwd`,
plus :func:`~repro_torch.models.backend.head_loss` at the last stage),
then the tick's sends land in their consumers' queue slots.  All of a
tick's ops run before any of its sends land, as the reference's tick
body reads its queues before the route writes them.  The table is built
with ``overlap=False`` (one card has no collective to overlap; the
reference builds the same per-device op order in both modes).

Memory follows the table, not the microbatch count.  Every buffer is
preallocated per device column at the table's depths, in the compute
dtype, ``[depth, mbB, S, d]``, and addressed only by the table's slot
columns: the F and B receive queues (``fq_depth``, ``bq_depth``), the
activation ring per chunk (``act_depth``), the remat ring
(``rmt_depth``) and the W-stash rings (``wstash_depth``: boundary
payload and upstream gradient).  This is where Chronos-Pipe's memory
saving becomes structural.

The payload between virtual stages is the reference's: the boundary
activation ``x`` and the fp32 MoE aux sum ``aux`` [1] (each MoE layer
adds its gate-weighted load-balancing loss; the last stage adds
``aux_weight`` times it to the CE), and in an encoder-decoder config the
encoder output ``enc`` [mbB, enc_len, d].  Every ring has an ``aux``
twin ``[depth, 1]`` fp32 at the same slots (``_Executor.aux_rings``),
and an ``enc`` twin where the payload carries one (``enc_rings``): the
forward rings carry ``aux`` and ``enc``, the backward ones their
cotangents.  ``enc`` rides every chunk unchanged and every decoder
layer's cross-attention reads it, so its cotangent grows on the way
back: each B op sends upstream its chunk's own ``enc`` cotangent plus
the one it received, and the first chunk, which ran the encoder (on
the shared ``encoder`` and ``enc_norm`` parameters), takes the sum back
through it.  A VLM's patch embeddings join ``x`` at the first chunk
(``spec.prefix`` positions ahead of the tokens, attending
bidirectionally) and the head drops them.

Op semantics mirror the reference's phase executor:

- **F** runs under ``torch.no_grad``: the first stage of chunk 0 embeds
  the microbatch (aux 0; the patch prefix; the encoder over the frames),
  the last stage of the last chunk adds the head loss to the loss sum;
  the op's input boundary goes to the activation ring.
- **B, fused** (tables without W): recompute the chunk from its stored
  boundary under autograd and ``torch.autograd.grad`` with explicit
  inputs — the input gradient goes upstream, block gradients accumulate
  in each block leaf's own dtype (bf16 at full width) and the head's or
  the embedding's at the pipeline ends in fp32, as in the reference
  (``zero_blocks_g = zeros_like(blocks)``, fp32 shared accumulators).
- **B, split**: the input gradient only; boundary and upstream gradient
  go to the W-stash.  **W** recomputes from the stash and takes the
  parameter gradients only.
- **R** moves the boundary from the activation ring to the remat ring
  and computes nothing, so ``chronos_recomp`` equals ``chronos``
  bitwise, as in the reference.

No autograd graph outlives its op.  Shared-parameter gradients sum over
stages; the loss is the mean of the microbatches' ``CE + aux_weight *
aux``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import StageLayout
from repro_torch.core.schedules import get_schedule
from repro_torch.core.tasktable import (F_OPS, IDLE, R_OPS, SEND_B_DOWN,
                                        SEND_B_LOC, SEND_BWD, SEND_F_LOC,
                                        SEND_F_UP, SEND_FWD, SEND_HOPB,
                                        SEND_HOPF, SEND_NONE, W_OPS,
                                        TaskTable, build_task_table)
from repro_torch.models import backend as compute_backend
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_dtype, _init_encoder,
                                            _init_layers, encode)
from repro_torch.optim.adamw import adamw_update, cast_like
from repro_torch.tree import tree_leaves, tree_map

# send code -> (device delta, queue, receive column of TaskTable.arrays():
# rcf_dn 6, rcf_up 7, rcf_loc 8, rcb_dn 9, rcb_up 10, rcb_loc 11).  The
# interleaved placement sends on the first four (the wraps land on the
# down / up columns); the V-shape placement's folded chunk moves up the
# devices (F) and down (B), and its chunk hops stay on the device.
_ROUTE = {SEND_FWD: (1, "f", 6), SEND_HOPF: (1, "f", 6),
          SEND_BWD: (-1, "b", 10), SEND_HOPB: (-1, "b", 10),
          SEND_F_UP: (-1, "f", 7), SEND_B_DOWN: (1, "b", 9),
          SEND_F_LOC: (0, "f", 8), SEND_B_LOC: (0, "b", 11)}

# generators that take ``v=``; the V-shape family is a fixed v=2
# construction and ``1f1b`` / ``gpipe`` / ``zb_h1`` / ``seq1f1b`` are v=1
_SCHEDULES_WITH_V = ("chronos", "interleaved", "chronos_zero2",
                     "chronos_zb", "chronos_recomp", "chronos_seq")
SEQ_SCHEDULES = ("seq1f1b", "chronos_seq")


# ---------------------------------------------------------------------------
# parameters (stage-stacked)
# ---------------------------------------------------------------------------

def init_pipeline_params(generator: torch.Generator, cfg: ModelConfig,
                         layout: StageLayout, device) -> Dict[str, Any]:
    """Random parameters at ``dense_init``'s scale (not the reference's
    bits).  Block leaves are ``[P, v, M, ...]`` indexed by (device,
    chunk) under ``layout``'s placement, one tree per period position,
    built for that position's layer kind and FFN (a Mamba-2 tree holds
    fp32 ``A_log``, ``D`` and ``dt_bias``, an MoE tree its fp32 router,
    beside weights of the parameter dtype); embedding, head and final
    norm (and an encoder-decoder config's ``encoder`` and ``enc_norm``)
    are shared by the stages (with tied embeddings the head is
    ``embed.tokens``)."""
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    n = layout.P * layout.v * layout.M
    blocks = [tree_map(lambda a: a.reshape((layout.P, layout.v, layout.M)
                                           + a.shape[1:]),
                       _init_layers(generator, cfg, n, device, j))
              for j in range(layout.period)]
    embed = {"tokens": L.dense_init(generator, (cfg.vocab_size, d), d, dt,
                                    device)}
    if not cfg.tie_embeddings:
        embed["head"] = L.dense_init(generator, (d, cfg.vocab_size), d, dt,
                                     device)
    params = {"blocks": blocks, "embed": embed,
              "final_norm": {"scale": torch.ones((d,), dtype=dt,
                                                 device=device)}}
    if cfg.encdec is not None:
        params.update(_init_encoder(generator, cfg, device))
    return params


def unstage_params(tree, layout: StageLayout) -> Dict[str, Any]:
    """Pipeline tree (parameters or gradients) -> the single-device
    ``LM`` tree: block leaves ``[P, v, M, ...]`` restacked as the LM
    stacks its layers (per position of the model's period, leaves
    ``[num_periods, ...]`` in global layer order, then the remainder
    layers; gemma3's local/global pattern makes that period 6 where the
    layout's is 1), padding layers dropped; shared leaves (the
    encoder's too) as they are."""
    per, lper = layout.period, layout.lm_period
    where = {}
    for d in range(layout.P):
        for c in range(layout.v):
            blk = layout.pl.block(d, c)
            for w in range(layout.K):
                if blk * layout.K + w < layout.L:
                    where[blk * layout.K + w] = (d, c, w)

    def layer(g):
        d, c, w = where[g]
        return tree_map(lambda a: a[d, c, w // per], tree["blocks"][w % per])

    nper = layout.L // lper
    layers = [tree_map(lambda *a: torch.stack(a),
                       *[layer(k * lper + j) for k in range(nper)])
              for j in range(lper) if nper]
    rem = [layer(nper * lper + r) for r in range(layout.L - nper * lper)]
    shared = {k: v for k, v in tree.items() if k != "blocks"}
    return {**shared, "layers": layers, "rem_layers": rem}


def restage_params(tree, src: StageLayout, dst: StageLayout):
    """A pipeline tree under ``src``'s placement moved to ``dst``'s (same
    P, v and block size): the blocks re-indexed by
    :func:`remap_blocks_elastic`; shared leaves stay."""
    return {**tree, "blocks": remap_blocks_elastic(tree["blocks"], src, dst)}


def remap_blocks_elastic(blocks, layout_src: StageLayout,
                         layout_dst: StageLayout, init_blocks=None):
    """Re-index stacked block leaves across *different* layouts — the
    elastic live-migration path (the reference's function, on torch
    leaves).  Source and destination may differ in P, v and placement
    (:func:`restage_params` is the placement-only case): every
    destination position ``(d, c, mi)`` of period
    phase ``j`` holds global layer ``dst.pl.block(d, c) * dst.K + mi *
    period + j`` and is gathered from wherever the source layout stored
    that layer, one shared ``(idx_d, idx_c, idx_m)`` index triple per
    tree.

    Destination positions whose global layer lies beyond the source's
    padded span (L_pad grows when P does not divide it, e.g. 8 layers at
    P=4 -> 12 at P=3, and shrinks back) are padding layers (gate 0, no
    forward effect, zero gradients); they are taken from
    ``init_blocks`` — a freshly initialized parameter / zeroed moment
    tree under ``layout_dst`` — by ``torch.where``, which is required
    exactly then."""
    per = layout_src.period
    assert per == layout_dst.period and layout_src.L == layout_dst.L, \
        "elastic remap requires the same model (period, num_layers)"
    Pd, vd, Md = layout_dst.P, layout_dst.v, layout_dst.M
    Ks = layout_src.K
    src_of = {layout_src.pl.block(d, c): (d, c)
              for d in range(layout_src.P) for c in range(layout_src.v)}
    idx = torch.zeros((3, Pd, vd, Md), dtype=torch.int64)
    have = torch.zeros((Pd, vd, Md), dtype=torch.bool)
    for d in range(Pd):
        for c in range(vd):
            for mi in range(Md):
                g = layout_dst.pl.block(d, c) * layout_dst.K + mi * per
                if g < layout_src.L_pad:
                    blk, within = divmod(g, Ks)
                    idx[0, d, c, mi], idx[1, d, c, mi] = src_of[blk]
                    idx[2, d, c, mi] = within // per
                    have[d, c, mi] = True

    def one(a):
        i = idx.to(a.device)
        return a[i[0], i[1], i[2]]

    if bool(have.all()):
        return [tree_map(one, t) for t in blocks]
    assert init_blocks is not None, \
        "destination has padding positions absent from the source; " \
        "pass init_blocks (freshly-initialized under layout_dst)"

    def one2(a, a0):
        g = one(a)
        mask = have.to(a.device).reshape(have.shape + (1,) * (g.dim() - 3))
        return torch.where(mask, g, a0)

    return [tree_map(one2, t, t0) for t, t0 in zip(blocks, init_blocks)]


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@dataclass
class PipelineSpec:
    cfg: ModelConfig
    layout: StageLayout
    table: TaskTable
    mbB: int                    # microbatch size (sequences)
    S: int                      # positions fed to the stack (patches too)
    kernels: str = "plain"      # compute backend (repro_torch.models.backend)
    prefix: int = 0             # VLM patch prefix length
    enc_len: int = 0            # encoder positions (0 if none)
    n_seq: int = 1              # sequence chunks per microbatch
    aux_weight: float = 0.01    # weight of the MoE aux sum in the loss


def make_pipeline_spec(cfg: ModelConfig, *, P: int, v: int, m: int,
                       microbatch: int, seq_len: int, schedule: str,
                       kernels: str = "plain", n_seq: int = 1,
                       **sched_kw) -> PipelineSpec:
    """Build the schedule, its layout (the schedule's placement decides
    which device holds which layer block) and its task table.  The
    sequence-chunked generators take ``n_seq``; the reference's
    assertions on it raise ValueError here: every other generator needs
    ``n_seq == 1``, and with ``n_seq > 1`` the model must be a dense
    attention LM (the executor carries no state across chunks but K/V),
    ``seq_len - 1`` must split into ``n_seq`` equal chunks, and the
    table must have no W tasks (``seq1f1b(split=True)`` compiles to a
    table, which no executor runs, as in the reference).  A dense
    attention LM here excludes SSM and MoE layers, an encoder and a patch
    prefix, as the reference's assertion does (the seq executor carries
    no aux sum and no encoder output, and its chunks would cut the
    prefix).  ``S`` is ``seq_len - 1`` plus a VLM's patches."""
    if schedule in SEQ_SCHEDULES:
        sched_kw["n_seq"] = n_seq
    elif n_seq != 1:
        raise ValueError(f"{schedule} is not sequence-chunked "
                         f"(n_seq={n_seq})")
    sched = get_schedule(schedule, P, m,
                         **({"v": v} if schedule in _SCHEDULES_WITH_V
                            else {}), **sched_kw)
    if sched.v != v:
        raise ValueError(f"{schedule} constructs v={sched.v}, spec asked "
                         f"for v={v}")
    layout = StageLayout.build(cfg, P, v, sched.pl)
    table = build_task_table(sched, overlap=False)
    if n_seq > 1:
        if cfg.ssm is not None or cfg.moe is not None \
                or cfg.encdec is not None or cfg.vision is not None:
            raise ValueError(f"the sequence-chunked executor runs dense "
                             f"attention LMs, got {cfg.name}")
        if (seq_len - 1) % n_seq:
            raise ValueError(f"seq_len-1 = {seq_len - 1} not divisible by "
                             f"n_seq={n_seq}")
        if table.has_w:
            raise ValueError("split-backward seq schedules compile to a "
                             "table only; no executor runs them")
    compute_backend.get_backend(kernels)        # validate the flag early
    prefix = cfg.vision.num_patches if cfg.vision is not None else 0
    enc_len = cfg.encdec.num_frames if cfg.encdec is not None else 0
    return PipelineSpec(cfg=cfg, layout=layout, table=table, mbB=microbatch,
                        S=seq_len - 1 + prefix, kernels=kernels,
                        n_seq=n_seq, prefix=prefix, enc_len=enc_len)


def _embed_tokens(spec: PipelineSpec, shared, tokens, patch=None):
    """Token embedding scaled by sqrt(d) (the scale rounded to the
    embedding's dtype, as the reference does), with a VLM's patch
    embeddings [mbB, P, d] ahead of it, in the compute dtype."""
    x = L.embed(shared["embed"], tokens)
    mult = torch.tensor(spec.cfg.d_model ** 0.5, dtype=x.dtype).item()
    x = x * mult
    if patch is not None:
        x = torch.cat([patch.to(x.dtype), x], dim=1)
    return x.to(_dtype(spec.cfg.compute_dtype))


def _with_grad(tree):
    """Detached leaves that require grad (views of the same storage)."""
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


class _Executor:
    """One table's rings, allocated once, and the tick loop over them."""

    def __init__(self, spec: PipelineSpec, device):
        self.spec = spec
        tab = spec.table
        self.A = tab.arrays()                           # [T, P, 16]
        self.split = tab.has_w
        self.flags = spec.layout.flags(spec.cfg)        # host numpy
        self.Sc = spec.S // spec.n_seq                  # payload positions
        shape = (spec.mbB, self.Sc, spec.cfg.d_model)
        dt = _dtype(spec.cfg.compute_dtype)

        def rings(shape, dt):
            def ring(depth):
                return torch.zeros((depth,) + shape, dtype=dt, device=device)
            P_ = tab.P
            return {
                "fq": [ring(tab.fq_depth) for _ in range(P_)],
                "bq": [ring(tab.bq_depth) for _ in range(P_)],
                "act": [{c: ring(k) for c, k in tab.act_depth.items()}
                        for _ in range(P_)],
                "rmt": [{c: ring(k) for c, k in tab.rmt_depth.items()}
                        for _ in range(P_)],
                "wx": [{c: ring(k) for c, k in tab.wstash_depth.items()}
                       for _ in range(P_)],
                "wdy": [{c: ring(k) for c, k in tab.wstash_depth.items()}
                        for _ in range(P_)],
            }
        self.rings: Dict[str, Any] = rings(shape, dt)
        # the payload's aux sum and encoder output (forward rings) and
        # their cotangents (backward rings), slot for slot
        self.aux_rings: Dict[str, Any] = rings((1,), torch.float32)
        self.ring_sets = [self.rings, self.aux_rings]
        if spec.enc_len:
            self.enc_rings = rings((spec.mbB, spec.enc_len,
                                    spec.cfg.d_model), dt)
            self.ring_sets.append(self.enc_rings)
        self.aux0 = torch.zeros((1,), dtype=torch.float32, device=device)

    # -- helpers -------------------------------------------------------------
    def _ends(self, d: int, c: int):
        """(first, last): does (device d, chunk c) hold the pipeline's
        first block (chunk 0, stage 0) or its last one?"""
        tab = self.spec.table
        s = self.spec.layout.pl.stage(d, c)
        return (c == 0 and s == 0), (c == tab.v - 1 and s == tab.P - 1)

    def _block(self, params, d: int, c: int, grad: bool):
        blocks = [tree_map(lambda a: a[d, c], t) for t in params["blocks"]]
        return _with_grad(blocks) if grad else blocks

    def _first_input(self, shared, tok_in, batch, mb):
        """The payload entering the pipeline's first block: the embedded
        tokens (after the patch prefix), aux 0, and the encoder output
        where the config has an encoder (from ``shared``'s encoder
        parameters, under autograd where they require grad)."""
        spec = self.spec
        patch = batch["patch_embeds"][mb] if spec.prefix else None
        out = [_embed_tokens(spec, shared, tok_in, patch), self.aux0]
        if spec.enc_len:
            out.append(encode(spec.cfg, shared, batch["frame_embeds"][mb],
                              compute_backend.get_backend(spec.kernels)))
        return out

    def _boundary(self, d, c, aslot, rslot):
        """The stored input payload (``x``, ``aux`` [, ``enc``]) of a
        backward op."""
        if rslot >= 0:
            return self._get("rmt", d, c, rslot)
        return self._get("act", d, c, aslot)

    def _get(self, name, d, c, slot):
        """Slot ``slot`` of ring ``name`` at device ``d`` (chunk ``c``;
        None for the receive queues) and its aux (and enc) twins."""
        out = []
        for r in self.ring_sets:
            ring = r[name][d] if c is None else r[name][d][c]
            out.append(_at(ring, slot))
        return tuple(out)

    def _put(self, name, d, c, slot, payload):
        for r, a in zip(self.ring_sets, payload):
            ring = r[name][d] if c is None else r[name][d][c]
            _at(ring, slot).copy_(a)

    # -- one op --------------------------------------------------------------
    def _op(self, d, row, params, shared, batch, acc):
        """Run one op; returns the payload it sends (``(x, aux[, enc])``
        forward, their cotangents backward) or None."""
        spec = self.spec
        op, c, mb, src, aslot = (int(x) for x in row[:5])
        wslot, rslot = int(row[12]), int(row[13])
        first, last = self._ends(d, c)
        flags_c = {k: a[d, c] for k, a in self.flags.items()}
        tokens = batch["tokens"][mb]
        tok_in, labels = tokens[:, :-1], tokens[:, 1:]
        mask = batch["loss_mask"][mb] if "loss_mask" in batch else None
        enc = bool(spec.enc_len)

        def chunk(blocks_c, x, aux, enc_in=None):
            return compute_backend.chunk_fwd(spec, blocks_c, flags_c, x, aux,
                                             enc_in)

        def head(sh, x, aux):
            return compute_backend.head_loss(spec, sh, x, labels, mask,
                                             aux=aux)

        def terms(out, seed, enc_out=None):
            """Outputs and seeds of a non-last chunk: ``x`` always, the
            aux sum where it depends on what is differentiated, and the
            encoder output ``enc_out`` where this op computed it (the
            first block), seeded with the cotangent the next chunk
            sent."""
            (x, a), (dx, da) = out, seed[:2]
            outs, seeds = ([x, a], [dx, da]) if a.requires_grad \
                else ([x], [dx])
            if enc_out is not None:
                outs.append(enc_out)
                seeds.append(seed[2])
            return outs, seeds

        def upstream(g, recv):
            """The input cotangents ``g`` a B op sends upstream: the enc
            input's is this chunk's own plus the one it received, since
            the payload carried enc on unchanged."""
            if not enc or recv is None:
                return g
            # a copy: ``recv`` is a view of this device's receive slot,
            # which this tick's landings may overwrite before this send
            # lands
            denc = recv[2].clone() if g[2] is None else g[2] + recv[2]
            return tuple(g[:2]) + (denc,)

        if op in F_OPS:
            with torch.no_grad():
                x_in = self._first_input(shared, tok_in, batch, mb) \
                    if first else self._get("fq", d, None, src)
                if aslot >= 0:
                    self._put("act", d, c, aslot, x_in)
                out = chunk(self._block(params, d, c, False), *x_in)
                if last:
                    acc["loss"] += head(shared, *out)
                    acc["n"] += 1
                    return None
                # enc rides on, copied: ``x_in`` views this device's receive
                # slot, which this tick's landings may overwrite before this
                # send lands
                return tuple(out) + tuple(a.clone() for a in x_in[2:])

        if op in R_OPS:
            if rslot >= 0:
                self._put("rmt", d, c, rslot,
                          self._get("act", d, c, aslot))
            return None

        if op in W_OPS:
            # parameter gradients from the stash (input gradient done)
            blocks_c = self._block(params, d, c, True)
            sh = _with_grad(shared) if (first or last) else shared
            with torch.enable_grad():
                x = self._first_input(sh, tok_in, batch, mb) if first \
                    else self._get("wx", d, c, wslot)
                out = chunk(blocks_c, *x)
                if last:
                    outs, seeds = [head(sh, *out)], [None]
                else:
                    outs, seeds = terms(out, self._get("wdy", d, c, wslot),
                                        x[2] if first and enc else None)
                self._accumulate(acc, d, c, blocks_c, sh, first or last,
                                 outs, seeds)
            return None

        # B ops
        if self.split:
            if first:
                # the first block sends nothing upstream: stash dy for W
                if not last:
                    self._put("wdy", d, c, wslot,
                              self._get("bq", d, None, src))
                return None
            bnd = self._boundary(d, c, aslot, rslot)
            self._put("wx", d, c, wslot, bnd)
            if not last:
                self._put("wdy", d, c, wslot, self._get("bq", d, None, src))
            x = [a.detach().requires_grad_() for a in bnd]
            with torch.enable_grad():
                out = chunk(self._block(params, d, c, False), *x)
                if last:
                    return _grad(head(shared, *out), None, x)
                recv = self._get("bq", d, None, src)
                outs, seeds = terms(out, recv)
                return upstream(_grad(outs, seeds, x), recv)

        blocks_c = self._block(params, d, c, True)
        sh = _with_grad(shared) if (first or last) else shared
        recv = None if last else self._get("bq", d, None, src)
        with torch.enable_grad():
            if first:
                x = self._first_input(sh, tok_in, batch, mb)
            else:
                x = [a.detach().requires_grad_()
                     for a in self._boundary(d, c, aslot, rslot)]
            out = chunk(blocks_c, *x)
            if last:
                outs, seeds = [head(sh, *out)], [None]
            else:
                outs, seeds = terms(out, recv,
                                    x[2] if first and enc else None)
            dx = self._accumulate(acc, d, c, blocks_c, sh, first or last,
                                  outs, seeds, () if first else x)
        return None if first else upstream(dx, recv)

    def _accumulate(self, acc, d, c, blocks_c, sh, with_shared, outs,
                    seeds, extra=()):
        """Gradients of the list ``outs`` (seeded by ``seeds``; None for
        a scalar loss) w.r.t. the block's parameters (+ the shared ones
        at the pipeline ends, + the inputs ``extra``): parameter
        gradients add into the accumulators (a block leaf's in its own
        dtype, a shared leaf's in fp32), the gradients of ``extra`` are
        returned."""
        blk = tree_leaves(blocks_c)
        shl = tree_leaves(sh) if with_shared else []
        gs = _grad(outs, seeds, blk + shl + list(extra))
        accs = [a[d, c] for a in tree_leaves(acc["gb"])]
        if with_shared:
            accs += tree_leaves(acc["gs"])
        for a, g in zip(accs, gs):
            if g is not None:          # an untied embedding at the head
                a.add_(g)
        return gs[len(accs):]

    # -- the tick loop -----------------------------------------------------
    def run(self, params, batch):
        tab = self.spec.table
        shared = {k: v for k, v in params.items() if k != "blocks"}
        dev = params["final_norm"]["scale"].device
        acc = {
            "gb": tree_map(torch.zeros_like, params["blocks"]),
            "gs": tree_map(lambda a: torch.zeros(a.shape,
                                                 dtype=torch.float32,
                                                 device=a.device), shared),
            "loss": torch.zeros((), dtype=torch.float32, device=dev),
            "n": 0,
        }
        for t in range(tab.T):
            sends = []
            for d in range(tab.P):
                row = self.A[t, d]
                if row[0] == IDLE:
                    continue
                out = self._op(d, row, params, shared, batch, acc)
                if out is not None and row[5] != SEND_NONE:
                    sends.append((d, int(row[5]), out))
            # the tick's ops have read their queues: land the sends (a
            # payload (x, aux[, enc]); an aux of None is not carried)
            for d, code, out in sends:
                delta, q, col = _ROUTE[code]
                dest = (d + delta) % tab.P
                slot = int(self.A[t, dest, col])
                assert slot >= 0, f"tick {t}: no receive slot at {dest}"
                for r, a in zip(self.ring_sets, out):
                    if a is not None:
                        r[q + "q"][dest][slot].copy_(a)
        grads = {"blocks": acc["gb"], **acc["gs"]}
        n = acc["n"]
        metrics = {"loss": acc["loss"] / max(n, 1), "n_microbatches": n}
        return grads, metrics


def _at(ring, slot: int):
    """Slot ``slot`` of a ring; the table sets every slot an op reads
    (a -1 here would silently index the ring's last slot)."""
    assert slot >= 0, "the task table left a read slot unset"
    return ring[slot]


def _grad(outputs, seeds, inputs):
    """``torch.autograd.grad`` over flat output, seed and input lists; an
    input the graph does not use (an untied embedding at the head) gets
    None."""
    return torch.autograd.grad(outputs, inputs, seeds, allow_unused=True)


def make_train_grads_fn(spec: PipelineSpec, device):
    """Returns ``fn(params, batch) -> (grads, metrics)`` running the full
    schedule.  ``batch``: ``tokens`` [m, mbB, seq_len] (+ optional
    ``loss_mask`` [m, mbB, seq_len - 1], and ``patch_embeds`` [m, mbB,
    prefix, d] for a VLM or ``frame_embeds`` [m, mbB, enc_len, d] for an
    encoder-decoder config) on ``device``.  ``grads`` are summed over
    the microbatches, block leaves in their parameters' dtype and shared
    leaves in fp32: ``{"blocks": [...], "embed": ...,
    "final_norm": ...}``; ``metrics``: ``loss`` (the microbatches' mean
    of CE plus ``aux_weight`` times the MoE aux sum, a device tensor)
    and ``n_microbatches``.  ``fn.rings`` are the executor's
    preallocated buffers.  A sequence-chunked table (``spec.n_seq > 1``)
    runs :class:`repro_torch.seqpipe.runtime.SeqExecutor`, with the same
    gradient semantics."""
    if spec.n_seq > 1:
        from repro_torch.seqpipe.runtime import SeqExecutor
        ex = SeqExecutor(spec, device)
    else:
        ex = _Executor(spec, device)

    def fn(params, batch):
        return ex.run(params, batch)

    fn.rings = ex.rings
    return fn


def make_train_update_fn(spec: PipelineSpec, device, ocfg, m: int, *,
                         use_kernel: bool = True, split=None):
    """Gradients, then the AdamW step on them: returns ``fn(params,
    opt_state, batch) -> (params, opt_state, metrics)``.  The update reads
    each gradient as ``g.float() / m`` (``m`` microbatches), as the
    reference's ``g.astype(f32) / m``, in
    :func:`repro_torch.optim.adamw.adamw_update` — with ``use_kernel``,
    one fused-AdamW kernel launch per parameter leaf.  The optimizer
    state and ``params`` are updated in place (``params`` is returned).

    ``split``: ``tree -> (kept, held)``, applied alike to the gradients
    and the parameters (Chronos-Offload: the shallow chunks and the
    shared leaves, and the deep chunks).  The update then covers the kept
    part only, and ``fn`` returns the held gradients (raw sums, not yet
    divided by ``m``) as a fourth element; the held weights are left as
    they are."""
    grads_fn = make_train_grads_fn(spec, device)
    m_dev = torch.tensor(float(m), dtype=torch.float32, device=device)

    def fn(params, opt_state, batch):
        grads, metrics = grads_fn(params, batch)
        kept = params
        if split is not None:
            (grads, held), kept = split(grads), split(params)[0]
        master, opt_state, om = adamw_update(grads, opt_state, ocfg,
                                             use_kernel=use_kernel,
                                             grad_div=m_dev)
        cast_like(master, kept)
        out = (params, opt_state, {**metrics, **om})
        return out if split is None else out + (held,)

    fn.rings = grads_fn.rings
    return fn
