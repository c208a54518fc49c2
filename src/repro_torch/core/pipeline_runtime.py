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
with ``overlap=False`` unless :func:`make_pipeline_spec` is asked for
the double-buffered exchange (``overlap=True``): then a send to another
device column lands one tick later, after the next tick's ops, and the
device-local channels (``SEND_F_LOC``, ``SEND_B_LOC``) still land in
their own tick, as in the reference's ``route_xdev`` / ``route_local``
split.  The reference builds the same per-device op order in both
modes, so both give the same gradients.

**Ranks** (:class:`_RankExecutor`, ``make_train_grads_fn(mesh=)``): the
same table run with one pipeline stage per ``torch.distributed`` rank,
the reference's ``shard_map`` deployment.  A rank holds its device
column only (its block leaves ``[v, M, ...]`` and its rings), runs its
column's ops with the same ``_op``, and trades payloads with its
neighbours through :class:`repro_torch.core.exchange.Exchange`, each
payload packed into one ``uint16 [mbB, W]`` message
(:func:`pack_payload`, the reference's ``_pack_payload``).  After the
tick loop the shared gradients, the loss and the microbatch count are
summed over the ranks (the exact fp32 sum, or with ``grad_psum_bits``
:func:`~repro_torch.optim.compression.compressed_sum_over`).

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
twin ``[depth, 1]`` fp32 at the same slots, and an ``enc`` twin where
the payload carries one (``_Executor.leaves``: one ring set per leaf):
the forward rings carry ``aux`` and ``enc``, the backward ones their
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

**The wire** (``spec.wire``, the reference's ``_leaf_exact``): the
rings store each payload leaf as the wire delivers it; the byte packing
of ``_pack_payload`` / ``_unpack_payload``, one array per collective,
is :func:`pack_payload` / :func:`unpack_payload`, used where payloads
cross ranks.  On the fp32 wire every leaf is exact and
the rings hold the compute dtype; on the bf16 wire an fp32 leaf is
stored in bf16; on the int8 wire ``x`` and ``enc`` are quantized per
batch row (int8 codes beside an fp32 ``[depth, mbB]`` scale twin).
``aux`` is never quantized.  A send is encoded where it lands, an op
decodes where it reads, and a boundary handed from one ring to another
(receive queue to activation ring, activation to remat ring, to the
W-stash) is copied in its stored form, so B and W recompute at exactly
the point F consumed.  The first block's input (the embedding) and the
last stage's upstream gradient (from the head) never touch the wire.

**The compressed shared-gradient sum** (``spec.grad_psum_bits``): each
stage that writes a shared leaf (:func:`psum_writers`) keeps its own
fp32 partial, and the step ends with
:func:`~repro_torch.optim.compression.compressed_sum` over them against
the caller's error-feedback state (:func:`init_psum_ef`): the
reference's ``compressed_psum`` over the pipe axis (over ranks,
:func:`~repro_torch.optim.compression.compressed_sum_over`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

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
from repro_torch.models.sharding import (TreeShard, gather_at_use,
                                         shard_env, spec_map)
from repro_torch.models.transformer import (_dtype, _init_encoder,
                                            _init_layers, encode,
                                            encoder_specs, layer_specs)
from repro_torch.optim.adamw import (adamw_update, cast_like, drop_fsdp,
                                     leaf_sq_sum, zero_state_specs)
from repro_torch.optim.compression import (compressed_sum, grid_scale,
                                          quantize_with)
from repro_torch.optim.offload import split_deep_shallow
from repro_torch.tree import (tree_leaves, tree_map, tree_paths,
                              tree_unflatten)

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
WIRES = ("fp32", "bf16", "int8")
# the payload's rings, one set per leaf (x, aux, enc)
RING_NAMES = ("fq", "bq", "act", "rmt", "wx", "wdy")


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


def pipeline_logical_specs(cfg: ModelConfig, layout: StageLayout):
    """Logical sharding specs of :func:`init_pipeline_params`' tree (the
    reference's ``init_pipeline_params`` specs): every block leaf
    ``("pp", None, None)`` (device, chunk, layer) ahead of its layer
    spec, the shared leaves' own specs."""
    specs: Dict[str, Any] = {"blocks": [
        spec_map(lambda sp: ("pp", None, None) + tuple(sp),
                 layer_specs(cfg, j)) for j in range(layout.period)],
        "embed": L.embed_specs(cfg.tie_embeddings),
        "final_norm": L.rmsnorm_specs()}
    if cfg.encdec is not None:
        specs.update(encoder_specs(cfg))
    return specs


def pipeline_layout_specs(logical):
    """The pipeline's layout over a mesh, as the reference's pipeline
    step builds it: ``(params, state)`` logical specs, the block leaves
    keeping fsdp x tp and the shared ones (embedding, head, final norm,
    encoder) dropping fsdp; the optimizer state by
    :func:`~repro_torch.optim.adamw.zero_state_specs` (stage 1) on the
    blocks, the shared leaves' as their parameters'."""
    params = {k: (v if k == "blocks" else drop_fsdp(v))
              for k, v in logical.items()}
    state = zero_state_specs(params, 1)
    state = {k: (v if k == "blocks" else params[k])
             for k, v in state.items()}
    return params, state


class RankShard(TreeShard):
    """What one rank of a ``pp x dp x tp`` mesh holds of the pipeline
    tree (a :class:`~repro_torch.models.sharding.TreeShard`), from the
    reference's logical specs (:func:`pipeline_logical_specs`,
    :func:`pipeline_layout_specs`):

    - parameters: the rank's pp column (block leaves ``[v, M, ...]``),
      cut to its tp shard.  At ``zero_stage`` < 3 they are replicated
      over dp; at stage 3 each block leaf the reference keeps fsdp on is
      held as the rank's dp slice (``fsdp_dims``), gathered at its use by
      each F, B and W op, as XLA gathers the reference's.  The shared
      leaves (embedding, head, final norm, encoder) drop fsdp at every
      stage, as the reference's pipeline step drops it;
    - optimizer state (``zero_stage`` >= 1): each leaf whose state spec
      puts "data" on a dimension holds the rank's dp slice of it
      (``zero_dims``); the others whole.  Stage 0 keeps every state
      whole; stage 2 is stage 1 (the reference's ``zero_state_specs``
      does not tell them apart).

    Where the config's K/V heads divide tp and are fewer than it, each
    rank holds the whole K/V head of its query heads, replicated over its
    K/V group (``TreeShard.kv``).

    ``shape``: axis name -> size (``Mesh.shape``); ``coords``: the rank's
    coordinate on each axis.  Per leaf, in ``tree_leaves`` order of the
    pipeline tree, the local dimensions lack a block leaf's pp one.

    ``chunks`` (a slice of the chunk axis) lays out a part of the tree,
    as Chronos-Offload splits it: the block leaves ``[P, v', M, ...]`` of
    those chunks, with the shared leaves (``shared``) or without them
    (the tree ``{"blocks": ...}``).  Each spec is sanitized on the part's
    shapes, as the reference resolves its shallow optimizer state and
    its deep shipment on theirs (``src/repro/launch/steps.py:412-427``,
    ``:536-541``): a state cut over dp on the chunk axis of the whole
    tree is whole on a part of one chunk."""

    def __init__(self, cfg: ModelConfig, layout: StageLayout, shape,
                 rules, coords, zero_stage: int = 1,
                 chunks: Optional[slice] = None, shared: bool = True):
        tree = init_pipeline_params(None, cfg, layout, "meta")
        pspec, sspec = pipeline_layout_specs(
            pipeline_logical_specs(cfg, layout))
        if chunks is not None or not shared:
            cut = slice(None) if chunks is None else chunks

            def part(t, blocks):
                return {"blocks": blocks, **({k: v for k, v in t.items()
                                              if k != "blocks"}
                                             if shared else {})}
            tree = part(tree, tree_map(lambda a: a[:, cut], tree["blocks"]))
            pspec, sspec = (part(s, s["blocks"]) for s in (pspec, sspec))
        self.zero_stage = zero_stage
        self._args = (cfg, layout, shape, rules, coords, zero_stage)
        super().__init__(
            tree, pspec if zero_stage >= 3 else drop_fsdp(pspec),
            sspec if zero_stage >= 1 else drop_fsdp(pspec), shape, rules,
            coords, dropped=lambda path: int(path[0] == "blocks"),
            kv_heads=cfg.num_kv_heads)

    def offload_parts(self, kept_chunks: int):
        """The ``(kept, deep)`` shards of Chronos-Offload's two parts of
        the whole tree's layout: the first ``kept_chunks`` chunks with
        the shared leaves, the rest without them."""
        return (RankShard(*self._args, chunks=slice(0, kept_chunks)),
                RankShard(*self._args, chunks=slice(kept_chunks, None),
                          shared=False))

    def cut(self, tree, pp_rank: Optional[int] = None):
        """A whole pipeline tree (global leaves) -> this rank's: block
        leaves ``[v, M, ...]`` of stage ``pp_rank`` (None: the blocks are
        that column already), every leaf cut to the rank's tp shard (and
        at stage 3 a block leaf to its dp slice), as own contiguous
        copies."""
        leaves = []
        for i, (p, a) in enumerate(zip(self.paths, tree_leaves(tree))):
            if p[0] == "blocks" and pp_rank is not None:
                a = a[pp_rank]
            leaves.append(self.cut_leaf(a, i))
        return tree_unflatten(tree, leaves)


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
    #: boundary-payload wire dtype: "fp32" (exact, the rings in the
    #: compute dtype), "bf16" (cast), or "int8" (per-row symmetric
    #: quantization, an fp32 scale per row beside the codes)
    wire: str = "fp32"
    #: int width of the compressed shared-parameter gradient sum over
    #: the stages (``optim.compression.compressed_sum``), or None for the
    #: exact fp32 sum.  The caller threads persistent error-feedback
    #: state (:func:`init_psum_ef`).
    grad_psum_bits: Optional[int] = None


def make_pipeline_spec(cfg: ModelConfig, *, P: int, v: int, m: int,
                       microbatch: int, seq_len: int, schedule: str,
                       kernels: str = "plain", n_seq: int = 1,
                       wire: str = "fp32",
                       grad_psum_bits: Optional[int] = None,
                       overlap: bool = False,
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
    prefix).  ``S`` is ``seq_len - 1`` plus a VLM's patches.  ``wire``
    must be one of :data:`WIRES` and ``grad_psum_bits`` None, 8 or 16
    (ValueError otherwise).  ``overlap`` builds the table of the
    double-buffered exchange (a device-crossing edge two ticks long);
    per device the ops run in the same order either way."""
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}: expected one of {WIRES}")
    if grad_psum_bits not in (None, 8, 16):
        raise ValueError(f"grad_psum_bits must be None, 8 or 16, got "
                         f"{grad_psum_bits!r}")
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
    table = build_task_table(sched, overlap=overlap)
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
                        n_seq=n_seq, prefix=prefix, enc_len=enc_len,
                        wire=wire, grad_psum_bits=grad_psum_bits)


def _embed_tokens(spec: PipelineSpec, shared, tokens, patch=None):
    """Token embedding scaled by sqrt(d) (the scale rounded to the
    embedding's dtype, as the reference does), with a VLM's patch
    embeddings [mbB, P, d] ahead of it, in the compute dtype."""
    x = L.embed(shared["embed"], tokens, vocab=spec.cfg.vocab_size)
    mult = torch.tensor(spec.cfg.d_model ** 0.5, dtype=x.dtype).item()
    x = x * mult
    if patch is not None:
        x = torch.cat([patch.to(x.dtype), x], dim=1)
    return x.to(_dtype(spec.cfg.compute_dtype))


def _with_grad(tree):
    """Detached leaves that require grad (views of the same storage)."""
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


# ---------------------------------------------------------------------------
# the wire: what a payload leaf's rings store
# ---------------------------------------------------------------------------

def leaf_exact(key: str, dtype: torch.dtype, wire: str) -> bool:
    """True when this payload leaf travels unchanged: the ``aux`` sum
    always (a loss term, never quantized), every leaf on the fp32 wire,
    and 16-bit leaves on the bf16 wire (the cast would be the
    identity) -- the reference's ``_leaf_exact``."""
    return key == "aux" or wire == "fp32" or (
        wire == "bf16" and dtype.itemsize <= 2)


def wire_encode(a: torch.Tensor, wire: str, key: str = "x"):
    """``(stored, scale)``: leaf ``a`` in the wire's storage form.  An
    exact leaf is itself (scale None); on the bf16 wire an fp32 leaf is
    cast to bf16; on the int8 wire each batch row is quantized over its
    whole flattened leaf, ``scale = max(amax_row, 1e-30) / 127`` (fp32
    ``[B]``) and codes ``clamp(round(x / scale), +-127)`` (int8, ``a``'s
    shape), as the reference's ``_pack_payload``."""
    if leaf_exact(key, a.dtype, wire):
        return a, None
    if wire == "bf16":
        return a.to(torch.bfloat16), None
    B = a.shape[0]
    flat = a.reshape(B, -1).float()
    scale = grid_scale(flat.abs().amax(dim=1, keepdim=True), 8)
    return quantize_with(flat, scale, 8).view(a.shape), scale.view(B)


def wire_decode(stored: torch.Tensor, scale: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """What the reader of a stored leaf sees (the reference's
    ``_unpack_payload``): a stored leaf of the compute dtype as it is,
    bf16 widened, int8 codes as ``(codes * scale).to(dtype)`` in fp32."""
    if scale is None:
        return stored if stored.dtype == dtype else stored.to(dtype)
    B = stored.shape[0]
    return (stored.reshape(B, -1).float() * scale.view(B, 1)) \
        .view(stored.shape).to(dtype)


def _wire_storage(key: str, dtype: torch.dtype, wire: str):
    """``(stored dtype, scaled)`` of a payload leaf on ``wire``: an exact
    leaf as it is, bf16 on the bf16 wire, int8 codes with a per-row fp32
    scale on the int8 wire."""
    if leaf_exact(key, dtype, wire):
        return dtype, False
    return (torch.bfloat16, False) if wire == "bf16" else (torch.int8, True)


def _payload_leaves(spec: PipelineSpec):
    """The payload's leaves, ``(key, shape, dtype)``: the boundary
    activation over the payload positions (``S / n_seq``), its fp32 aux
    sum, and the encoder output where the config has an encoder."""
    dt, d = _dtype(spec.cfg.compute_dtype), spec.cfg.d_model
    out = [("x", (spec.mbB, spec.S // spec.n_seq, d), dt),
           ("aux", (1,), torch.float32)]
    if spec.enc_len:
        out.append(("enc", (spec.mbB, spec.enc_len, d), dt))
    return out


def _payload_bytes(spec: PipelineSpec) -> int:
    """Bytes of one payload as the wire stores it: each leaf in its wire
    storage, an int8 leaf with its per-row fp32 scale."""
    n = 0
    for key, shape, dt in _payload_leaves(spec):
        store, scaled = _wire_storage(key, dt, spec.wire)
        n += math.prod(shape) * store.itemsize \
            + (4 * shape[0] if scaled else 0)
    return n


def payload_ring_bytes(spec: PipelineSpec) -> int:
    """Bytes of the executor's payload rings as the wire stores them:
    one payload a slot of every ring (``fq``, ``bq``, ``act``, ``rmt``,
    and the W stash's ``wx`` and ``wdy``) on every device, each leaf in
    its wire storage, an int8 leaf with its per-row fp32 scale."""
    tab = spec.table
    slots = tab.P * (tab.fq_depth + tab.bq_depth
                     + sum(tab.act_depth.values())
                     + sum(tab.rmt_depth.values())
                     + 2 * sum(tab.wstash_depth.values()))
    return slots * _payload_bytes(spec)


def stage_crossing_sends(spec: PipelineSpec):
    """``(sends, bytes)`` of one step's payloads that cross virtual
    stages (a send to another device column; the V-shape's hops stay on
    their device): on P cards these are the point-to-point transfers,
    each payload as the wire stores it."""
    codes = spec.table.arrays()[:, :, 5]
    sends = int(sum((codes == c).sum() for c, (delta, _, _) in
                    _ROUTE.items() if delta))
    return sends, sends * _payload_bytes(spec)


# ---------------------------------------------------------------------------
# the packed payload: one uint16 [mbB, W] message a send
# ---------------------------------------------------------------------------

def _packed_layout(spec: PipelineSpec):
    """``(key, shape, dtype, stored dtype, scaled, row bytes)`` of each
    payload leaf in the packed row, in :func:`_payload_leaves` order: an
    int8 leaf's row is its fp32 scale (4 bytes, the reference's two
    leading words) then its codes; the batch-free ``aux`` fills a row of
    its own bytes, broadcast over the batch rows."""
    B, out = spec.mbB, []
    for key, shape, dt in _payload_leaves(spec):
        store, scaled = _wire_storage(key, dt, spec.wire)
        elts = math.prod(shape) if key == "aux" else math.prod(shape) // B
        if scaled and elts % 2:
            raise ValueError(f"the int8 wire packs code pairs into words: "
                             f"payload leaf {key!r} has an odd row length "
                             f"{elts}")
        out.append((key, shape, dt, store, scaled, elts * store.itemsize))
    return out


def payload_words(spec: PipelineSpec) -> int:
    """Packed row width, uint16 words per batch row (the reference's
    ``_payload_words``): an exact leaf ``itemsize / 2`` words an element,
    a bf16 one one word, an int8 one half a word an element plus the two
    words of its row's fp32 scale, the ``aux`` sum two words."""
    return sum(n + 4 * scaled
               for *_, scaled, n in _packed_layout(spec)) // 2


def pack_payload(spec: PipelineSpec, payload, out=None) -> torch.Tensor:
    """Payload ``(x, aux[, enc])`` -> the packed ``uint16 [mbB, W]``
    words (the reference's ``_pack_payload``): each leaf encoded for
    ``spec.wire`` by :func:`wire_encode`, as the one-device executor
    stores it, and its bytes laid out in the row; a leaf of None (an
    absent cotangent) packs as zeros.  ``out``: a ``uint8 [mbB, 2W]``
    buffer to write into."""
    B = spec.mbB
    dev = next(a.device for a in payload if a is not None)
    buf = torch.empty((B, 2 * payload_words(spec)), dtype=torch.uint8,
                      device=dev) if out is None else out
    off = 0
    for (key, shape, dt, _, scaled, n), a in zip(_packed_layout(spec),
                                                 payload):
        if a is None:
            a = torch.zeros(shape, dtype=dt, device=dev)
        stored, scale = wire_encode(a, spec.wire, key)
        if scaled:
            buf[:, off:off + 4].copy_(_bytes_of(scale, B))
            off += 4
        buf[:, off:off + n].copy_(_bytes_of(stored, 1 if key == "aux"
                                            else B))
        off += n
    return buf.view(torch.uint16)


def _bytes_of(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a``'s bytes as ``uint8 [rows, -1]`` (a view when contiguous)."""
    return a.contiguous().view(torch.uint8).view(rows, -1)


def _unpack_stored(spec: PipelineSpec, words: torch.Tensor):
    """Packed words -> each leaf's ``(stored, scale)`` in the wire's
    storage form, as the one-device executor's rings hold it (``aux``
    read back from row 0)."""
    B = spec.mbB
    buf = words.contiguous().view(torch.uint8)
    out, off = [], 0
    for key, shape, _, store, scaled, n in _packed_layout(spec):
        scale = None
        if scaled:
            scale = buf[:, off:off + 4].contiguous().view(torch.float32) \
                .view(B)
            off += 4
        seg = buf[:1] if key == "aux" else buf
        out.append((seg[:, off:off + n].contiguous().view(store)
                    .view(shape), scale))
        off += n
    return out


def unpack_payload(spec: PipelineSpec, words: torch.Tensor):
    """Inverse of :func:`pack_payload` (the reference's
    ``_unpack_payload``): each leaf as its reader sees it, bitwise for an
    exact leaf, widened from bf16 or dequantized from int8 codes by
    :func:`wire_decode`."""
    return [wire_decode(stored, scale, dt) for (stored, scale), (_, _, dt)
            in zip(_unpack_stored(spec, words), _payload_leaves(spec))]


class _PayloadLeaf:
    """One payload leaf's rings (``RING_NAMES``, each per device; the
    chunked ones per chunk too) in the wire's storage form: the compute
    dtype for an exact leaf, bf16 on the bf16 wire, int8 codes with an
    fp32 ``[depth, mbB]`` scale twin (``scales``) on the int8 wire.
    ``write`` encodes where a send lands, ``read`` decodes where an op
    reads, ``move`` copies a stored slot unchanged (a boundary handed
    from one ring to another stays the bytes the wire delivered)."""

    def __init__(self, key: str, make, shape, dtype, wire: str):
        self.key, self.dtype, self.wire = key, dtype, wire
        self.exact = leaf_exact(key, dtype, wire)
        store, scaled = _wire_storage(key, dtype, wire)
        self.rings = make(shape, store)
        self.scales = make((shape[0],), torch.float32) if scaled else None

    @staticmethod
    def _slot(rings, name, d, c, slot):
        return _at(rings[name][d] if c is None else rings[name][d][c], slot)

    def read(self, name, d, c, slot) -> torch.Tensor:
        a = self._slot(self.rings, name, d, c, slot)
        if self.exact:
            return a                        # a view of the slot
        s = None if self.scales is None else \
            self._slot(self.scales, name, d, c, slot)
        return wire_decode(a, s, self.dtype)

    def write(self, name, d, c, slot, a) -> None:
        stored, s = wire_encode(a, self.wire, self.key)
        self._slot(self.rings, name, d, c, slot).copy_(stored)
        if s is not None:
            self._slot(self.scales, name, d, c, slot).copy_(s)

    def move(self, src, dst) -> None:
        """``src``, ``dst``: ``(name, d, c, slot)``."""
        for rings in (self.rings, self.scales):
            if rings is not None:
                self._slot(rings, *dst).copy_(self._slot(rings, *src))

    def land_packed(self, name, d, slot, buf, off: int, n: int) -> int:
        """Copy this leaf's stored bytes (and its scale's) from the packed
        ``uint8 [mbB, 2W]`` message ``buf``, starting at byte ``off`` of
        the row, into a receive slot; returns the next leaf's offset."""
        B = buf.shape[0]

        def dst(rings, rows):           # a view: ring slots are contiguous
            return self._slot(rings, name, d, None, slot) \
                .view(torch.uint8).view(rows, -1)
        if self.scales is not None:
            dst(self.scales, B).copy_(buf[:, off:off + 4])
            off += 4
        rows = 1 if self.key == "aux" else B
        dst(self.rings, rows).copy_(buf[:rows, off:off + n])
        return off + n


class _Executor:
    """One table's rings, allocated once, and the tick loop over them.
    ``columns``: the device columns whose rings are allocated (every
    column by default; a rank's own one under :class:`_RankExecutor`,
    None in the others' places)."""

    def __init__(self, spec: PipelineSpec, device, columns=None):
        self.spec = spec
        tab = spec.table
        self.A = tab.arrays()                           # [T, P, 16]
        self.split = tab.has_w
        self.flags = spec.layout.flags(spec.cfg)        # host numpy
        self.Sc = spec.S // spec.n_seq                  # payload positions

        cols = range(tab.P) if columns is None else columns

        def rings(shape, dt):
            def ring(depth):
                return torch.zeros((depth,) + shape, dtype=dt, device=device)

            def per_device(make):
                return [make() if d in cols else None for d in range(tab.P)]
            return {
                "fq": per_device(lambda: ring(tab.fq_depth)),
                "bq": per_device(lambda: ring(tab.bq_depth)),
                **{name: per_device(lambda depths=depths: {
                    c: ring(k) for c, k in depths.items()})
                   for name, depths in (("act", tab.act_depth),
                                        ("rmt", tab.rmt_depth),
                                        ("wx", tab.wstash_depth),
                                        ("wdy", tab.wstash_depth))},
            }
        # the payload's leaves (forward rings) and their cotangents
        # (backward rings), slot for slot, each stored in the wire's form
        self.leaves = [_PayloadLeaf(key, rings, shape, dt, spec.wire)
                       for key, shape, dt in _payload_leaves(spec)]
        self.rings: Dict[str, Any] = self.leaves[0].rings
        self.aux0 = torch.zeros((1,), dtype=torch.float32, device=device)
        # per microbatch, the head's fixed normalizer (a data-parallel
        # rank's global-microbatch count), or None: the local mean
        self.denom = None

    # -- helpers -------------------------------------------------------------
    def _ends(self, d: int, c: int):
        """(first, last): does (device d, chunk c) hold the pipeline's
        first block (chunk 0, stage 0) or its last one?"""
        tab = self.spec.table
        s = self.spec.layout.pl.stage(d, c)
        return (c == 0 and s == 0), (c == tab.v - 1 and s == tab.P - 1)

    @staticmethod
    def _dc(a, d: int, c: int):
        """Device ``d``'s chunk ``c`` of a stage-stacked block leaf."""
        return a[d, c]

    def _use(self, blocks_c):
        """A chunk's block leaves as the chunk body reads them (the rank
        executor at ZeRO stage 3 gathers the dp slices here)."""
        return blocks_c

    def _block_accumulators(self, blocks):
        """Zeros for the block gradients, each in its leaf's dtype (the
        reference's ``zeros_like(blocks)``)."""
        return tree_map(torch.zeros_like, blocks)

    def _block(self, params, d: int, c: int, grad: bool):
        blocks = [tree_map(lambda a: self._dc(a, d, c), t)
                  for t in params["blocks"]]
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

    @staticmethod
    def _boundary_at(d, c, aslot, rslot):
        """Where a backward op's stored input payload lies: the remat
        ring's slot where the table sets one, else the activation ring's."""
        return ("rmt", d, c, rslot) if rslot >= 0 else ("act", d, c, aslot)

    def _boundary(self, d, c, aslot, rslot):
        """The stored input payload (``x``, ``aux`` [, ``enc``]) of a
        backward op, as the wire delivered it."""
        return self._get(*self._boundary_at(d, c, aslot, rslot))

    def _get(self, name, d, c, slot):
        """Slot ``slot`` of ring ``name`` at device ``d`` (chunk ``c``;
        None for the receive queues), every payload leaf as its reader
        sees it (decoded from the wire's storage form)."""
        return tuple(leaf.read(name, d, c, slot) for leaf in self.leaves)

    def _put(self, name, d, c, slot, payload):
        """Land ``payload`` in a slot, encoded for the wire (a leaf of
        None is not carried)."""
        for leaf, a in zip(self.leaves, payload):
            if a is not None:
                leaf.write(name, d, c, slot, a)

    def _move(self, src, dst):
        """Copy a stored payload from slot ``src`` to slot ``dst`` (each
        ``(ring, device, chunk, slot)``) unchanged."""
        for leaf in self.leaves:
            leaf.move(src, dst)

    # -- one op --------------------------------------------------------------
    @staticmethod
    def op_key(d, row):
        """What fixes the work of the op in ``row`` (a row of
        ``TaskTable.arrays()``) at device column ``d``, whatever
        microbatch it carries: the column, op code, chunk, send code and
        sequence chunk, and which of its activation, W-stash, remat and
        KV slots it uses.  Two ops of one key run the same aten ops on
        tensors of the same shapes."""
        return (d,) + tuple(int(row[i]) for i in (0, 1, 5, 14)) \
            + tuple(int(row[i]) >= 0 for i in (4, 12, 13, 15))

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
            return compute_backend.chunk_fwd(spec, self._use(blocks_c),
                                             flags_c, x, aux, enc_in)

        def head(sh, x, aux):
            return compute_backend.head_loss(
                spec, sh, x, labels, mask, aux=aux,
                denom=None if self.denom is None else self.denom[mb])

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
                # the input boundary, as the wire delivered it; the first
                # block's B and W recompute the embedding instead, so its
                # slot is never read and nothing goes there
                if aslot >= 0 and not first:
                    self._move(("fq", d, None, src), ("act", d, c, aslot))
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
                self._move(("act", d, c, aslot), ("rmt", d, c, rslot))
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
                    self._move(("bq", d, None, src), ("wdy", d, c, wslot))
                return None
            bnd_at = self._boundary_at(d, c, aslot, rslot)
            self._move(bnd_at, ("wx", d, c, wslot))
            if not last:
                self._move(("bq", d, None, src), ("wdy", d, c, wslot))
            x = [a.detach().requires_grad_() for a in self._get(*bnd_at)]
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
        dtype, a shared leaf's in fp32: the one accumulator, or device
        ``d``'s partial under the compressed sum), the gradients of
        ``extra`` are returned."""
        blk = tree_leaves(blocks_c)
        shl = tree_leaves(sh) if with_shared else []
        gs = _grad(outs, seeds, blk + shl + list(extra))
        accs = [self._dc(a, d, c) for a in tree_leaves(acc["gb"])]
        if with_shared:
            accs += acc["gs_at"][d]
        for a, g in zip(accs, gs):
            if g is not None:          # an untied embedding at the head
                assert a is not None, \
                    f"device {d} wrote a gradient of a shared leaf that " \
                    "psum_writers does not give it"
                a.add_(g)
        return gs[len(accs):]

    # -- the tick loop -----------------------------------------------------
    def run(self, params, batch, psum_ef=None):
        spec = self.spec
        if spec.grad_psum_bits and psum_ef is None:
            raise ValueError("grad_psum_bits needs the error-feedback "
                             "state (init_psum_ef)")
        shared = {k: v for k, v in params.items() if k != "blocks"}
        dev = params["final_norm"]["scale"].device
        acc = {
            "gb": self._block_accumulators(params["blocks"]),
            "loss": torch.zeros((), dtype=torch.float32, device=dev),
            "n": 0,
        }
        parts = self._shared_accumulators(acc, shared)
        self._ticks(params, shared, batch, acc)
        return self._reduce(acc, shared, parts, psum_ef)

    def _shared_accumulators(self, acc, shared):
        """The fp32 accumulators of the shared gradients, and
        ``acc["gs_at"][d]``, the leaves device ``d``'s ops add into: one
        tree for every device, or under the compressed sum one partial
        per writing stage (:func:`psum_writers`), stacked per leaf."""
        P = self.spec.table.P
        if self.spec.grad_psum_bits:
            writers = psum_writers(self.spec, shared)
            parts = [torch.zeros((len(w),) + a.shape, dtype=torch.float32,
                                 device=a.device)
                     for a, w in zip(tree_leaves(shared), writers)]
            acc["gs_at"] = [[p[w.index(d)] if d in w else None
                             for p, w in zip(parts, writers)]
                            for d in range(P)]
            return parts
        gs = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
              for a in tree_leaves(shared)]
        acc["gs_at"] = [gs] * P
        return gs

    def _ticks(self, params, shared, batch, acc):
        tab = self.spec.table
        pending = []        # an overlapped table's device-crossing sends
        for t in range(tab.T):
            sends = []
            for d in range(tab.P):
                row = self.A[t, d]
                if row[0] == IDLE:
                    continue
                out = self._op(d, row, params, shared, batch, acc)
                if out is not None and row[5] != SEND_NONE:
                    sends.append((t, d, int(row[5]), out))
            # the tick's ops have read their queues: land the sends (a
            # payload (x, aux[, enc]); an aux of None is not carried).  On
            # an overlapped table a send to another device column lands
            # after the next tick's ops, before the local ones of that
            # tick, as the reference's deferred route
            now, later = [], []
            for s in sends:
                (later if tab.overlap and _ROUTE[s[2]][0] else now).append(s)
            for ts, d, code, out in pending + now:
                delta, q, col = _ROUTE[code]
                dest = (d + delta) % tab.P
                slot = int(self.A[ts, dest, col])
                assert slot >= 0, f"tick {ts}: no receive slot at {dest}"
                self._put(q + "q", dest, None, slot, out)
            pending = later
        assert not pending, "the table ends with a send in flight"

    def _reduce(self, acc, shared, parts, psum_ef):
        """``(grads, metrics[, psum_ef])``: the shared gradients summed
        over the stages (exactly, or by ``compressed_sum`` of the
        partials against ``psum_ef``), the loss the microbatches' mean."""
        n = acc["n"]
        metrics = {"loss": acc["loss"] / max(n, 1), "n_microbatches": n}
        bits = self.spec.grad_psum_bits
        if not bits:
            return ({"blocks": acc["gb"], **tree_unflatten(shared, parts)},
                    metrics)
        red, scales = [], []
        for p, e in zip(parts, tree_leaves(psum_ef)):
            r, _, sc = compressed_sum(list(p.unbind(0)), e, bits,
                                      with_scales=True)
            red.append(r)
            scales.append(sc)
        metrics["psum_scale"] = tree_unflatten(shared, scales)
        return ({"blocks": acc["gb"], **tree_unflatten(shared, red)},
                metrics, psum_ef)


class _RankExecutor(_Executor):
    """One rank's column of the table: the reference's per-device body
    under ``shard_map``.  ``params`` hold the rank's block leaves ``[v,
    M, ...]`` (:func:`rank_params`) and every shared leaf; the rings hold
    its device column; ``_op`` runs unchanged with ``d`` the rank.  Each
    tick's device-crossing sends go through the rank's
    :class:`~repro_torch.core.exchange.Exchange`, posted as soon as the
    tick's op is launched and landed in the tick (``overlap=False``) or
    just before tick ``t + 2``'s op, the first that reads them
    (``overlap=True``: tick ``t + 1``'s op runs beside the transfer); the
    local channels land in their own tick.  After
    the tick loop the shared gradients (each rank's own fp32 partial:
    the exact sum, or the compressed sum against the rank's
    error-feedback rows), the loss and the microbatch count are summed
    over the ranks.

    The pp view of a ``pp x dp x tp`` mesh (``mesh.parent``) adds the
    other two axes: the tick loop runs under the mesh's env (the layers
    split over tp), the rank reads its dp rows of each microbatch, the
    loss and the count also sum over dp, and every gradient is summed
    over dp.

    ``shard`` (the step's :class:`RankShard`) at ZeRO stage 3: the rank
    holds its dp slice of each block leaf the reference keeps fsdp on.
    Each F, B and W op gathers its chunk's slices over dp before the
    chunk body (:func:`~repro_torch.models.sharding.gather_fsdp`; B and
    W recompute the chunk, so they gather again) and frees the whole
    leaves when it ends; the gradients of a B or W op are reduce-scattered
    over dp by the gather's backward and added into fp32 accumulators of
    the slices, so they need no dp sum after the tick loop.

    ``shard`` with replicated K/V heads (``TreeShard.kv``): after the dp
    sum, each K/V leaf's gradient is summed over its K/V group
    (:meth:`~repro_torch.models.sharding.TreeShard.kv_sum`)."""

    def __init__(self, spec: PipelineSpec, mesh, shard=None):
        if mesh.P != spec.table.P:
            raise ValueError(f"a mesh of {mesh.P} ranks for a table of "
                             f"P={spec.table.P} stages")
        super().__init__(spec, mesh.device, columns=(mesh.rank,))
        from repro_torch.core.exchange import Exchange
        self.mesh = mesh
        self.full = mesh.parent            # the pp x dp x tp mesh, or None
        self.exchange = Exchange(spec, mesh)
        self.layout_bytes = [n for *_, n in _packed_layout(spec)]
        if shard is None and self.full is not None:
            # the stage-1 layout: which leaves hold replicated K/V heads
            shard = RankShard(spec.cfg, spec.layout, self.full.shape,
                              self.full.rules, self.full.coords)
        self.kv_shard = shard if shard is not None and any(shard.kv) \
            else None
        self.shard = shard if shard is not None and shard.sliced else None
        self.block_dims = None if self.shard is None \
            else self.shard.fsdp_tree()["blocks"]

    def _use(self, blocks_c):
        # a block leaf [v, M, ...] of the rank, indexed by chunk: its
        # fsdp dimension less one
        return gather_at_use(blocks_c, self.block_dims, shift=1)

    def _block_accumulators(self, blocks):
        if self.shard is None:
            return super()._block_accumulators(blocks)
        return tree_map(lambda a, k: torch.zeros_like(a) if k is None else
                        torch.zeros(a.shape, dtype=torch.float32,
                                    device=a.device), blocks,
                        self.block_dims)

    def run(self, params, batch, psum_ef=None):
        """On a ``pp x dp x tp`` mesh: the rank's rows of the global batch
        (``[m, mbB * dp, ...]``, dp slice ``d`` of dim 1), the global
        microbatches' normalizers, and the tick loop under the mesh's
        :class:`~repro_torch.models.sharding.ShardEnv`."""
        full = self.full
        if full is None:
            return super().run(params, batch, psum_ef)
        if full.dp > 1:
            d, B = full.coord("data"), self.spec.mbB
            batch = {k: v[:, d * B:(d + 1) * B] for k, v in batch.items()}
            self.denom = self._denominators(batch)
        with shard_env(full, full.rules):
            return super().run(params, batch, psum_ef)

    def _denominators(self, batch):
        """Each microbatch's normalizer over the *global* microbatch, the
        reference's mean: the label count of all dp ranks, or the mask
        count all-reduced over dp (at least 1) -- not the local mean."""
        tok = batch["tokens"]
        if "loss_mask" not in batch:
            n = self.full.dp * tok.shape[1] * (tok.shape[2] - 1)
            return torch.full((tok.shape[0],), float(n),
                              dtype=torch.float32, device=tok.device)
        cnt = batch["loss_mask"].float().sum(dim=(1, 2)).contiguous()
        self.full.all_reduce(cnt, "data")
        return cnt.clamp_(min=1.0)

    @staticmethod
    def _dc(a, d: int, c: int):
        return a[c]                     # the rank's own column

    def _shared_accumulators(self, acc, shared):
        r, P = self.mesh.rank, self.spec.table.P
        leaves = tree_leaves(shared)
        writers = psum_writers(self.spec, shared) \
            if self.spec.grad_psum_bits else [(r,)] * len(leaves)
        parts = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                 if r in w else None for a, w in zip(leaves, writers)]
        acc["gs_at"] = [parts if d == r else None for d in range(P)]
        return parts

    def _land(self, q, slot, words):
        """A packed message into the rank's receive queue ``q``."""
        off = 0
        for leaf, n in zip(self.leaves, self.layout_bytes):
            off = leaf.land_packed(q + "q", self.mesh.rank, slot, words, off,
                                   n)

    def _ticks(self, params, shared, batch, acc):
        tab, r, ex = self.spec.table, self.mesh.rank, self.exchange
        A = self.A
        # the tick whose arrivals the next ops may read first
        lag = 2 if tab.overlap else 0

        def land(t):
            for code, words in ex.complete(t):
                _, q, col = _ROUTE[code]
                slot = int(A[t, r, col])
                assert slot >= 0, f"tick {t}: no receive slot at {r}"
                self._land(q, slot, words)

        for t in range(tab.T):
            if lag and t >= lag:
                land(t - lag)
            row = A[t, r]
            out = None if row[0] == IDLE else \
                self._op(r, row, params, shared, batch, acc)
            code = int(row[5])
            xdev = code != SEND_NONE and _ROUTE[code][0] != 0
            ex.stage(t, out if xdev else None)
            ex.post(t)
            if not lag:
                land(t)
            if out is not None and code != SEND_NONE and not xdev:
                _, q, col = _ROUTE[code]
                self._put(q + "q", r, None, int(A[t, r, col]), out)
        for t in range(max(tab.T - lag, 0), tab.T):
            land(t)

    def _reduce(self, acc, shared, parts, psum_ef):
        mesh, bits = self.mesh, self.spec.grad_psum_bits
        tot = torch.stack([acc["loss"], torch.tensor(
            float(acc["n"]), device=acc["loss"].device)])
        mesh.all_reduce(tot, "sum")
        dp = 1 if self.full is None else self.full.dp
        if dp > 1:
            # the loss sums over pp and dp, never over tp (equal there)
            self.full.all_reduce(tot, "data")
        n = int(round(tot[1].item())) // dp
        metrics = {"loss": tot[0] / max(n, 1), "n_microbatches": n}
        if not bits:
            for p in parts:
                mesh.all_reduce(p, "sum")
            out = ({"blocks": acc["gb"], **tree_unflatten(shared, parts)},
                   metrics)
        else:
            from repro_torch.optim.compression import compressed_sum_over
            red, scales = [], []
            for a, p, e in zip(tree_leaves(shared), parts,
                               tree_leaves(psum_ef)):
                s_, sc = compressed_sum_over(mesh, p,
                                             e[0] if len(e) else None,
                                             bits, like=a)
                red.append(s_)
                scales.append(sc)
            metrics["psum_scale"] = tree_unflatten(shared, scales)
            out = ({"blocks": acc["gb"], **tree_unflatten(shared, red)},
                   metrics, psum_ef)
        if dp > 1:
            # every gradient summed over dp, exactly (the global batch's);
            # a slice's was reduce-scattered where its op made it
            for i, g in enumerate(tree_leaves(out[0])):
                if self.shard is None or self.shard.fsdp_dims[i] is None:
                    self.full.all_reduce(g, "data")
        if self.kv_shard is not None:
            self.kv_shard.kv_sum(self.full, tree_leaves(out[0]))
        return out


def rank_params(tree, rank: int, shard: Optional[RankShard] = None):
    """A stage-stacked tree (parameters, gradients or optimizer moments:
    block leaves ``[P, v, M, ...]``) cut to one rank's column: block
    leaves ``[v, M, ...]`` (own copies, so the whole tree can be freed),
    shared leaves as they are.  With ``shard`` (a rank of a ``pp x dp x
    tp`` mesh) every leaf is also cut to the rank's tp shard
    (:meth:`RankShard.cut`)."""
    if shard is not None:
        return shard.cut(tree, rank)
    return {**tree, "blocks": [tree_map(lambda a: a[rank].clone(), t)
                               for t in tree["blocks"]]}


def psum_writers(spec: PipelineSpec, shared):
    """For each shared leaf (in ``tree_leaves`` order), the devices whose
    ops write a gradient into it: the first block's device (the token
    embedding; an encoder-decoder config's encoder), the last block's
    (the final norm and the head: ``embed.head``, or ``embed.tokens``
    when tied).  Derived from the layout (under ``v_min``'s fold-back the
    last block is device 0's).  Every other stage's partial is zero, and
    so is its error feedback, so the compressed sum over these stages
    equals the one over all ``P`` bitwise; a leaf of no known writer
    keeps a partial on every stage."""
    tab, pl = spec.table, spec.layout.pl
    d_first = next(d for d in range(tab.P) if pl.stage(d, 0) == 0)
    d_last = next(d for d in range(tab.P)
                  if pl.stage(d, tab.v - 1) == tab.P - 1)
    head = "head" if "head" in shared.get("embed", {}) else "tokens"
    every = tuple(range(tab.P))

    def of(path):
        top = path[0]
        if top == "embed" and path[1] in ("tokens", "head"):
            w = ([d_first] if path[1] == "tokens" else []) \
                + ([d_last] if path[1] == head else [])
        elif top == "final_norm":
            w = [d_last]
        elif top in ("encoder", "enc_norm"):
            w = [d_first]
        else:
            w = every
        return tuple(sorted(set(w)))
    return [of(p) for p in tree_paths(shared)]


def init_psum_ef(spec: PipelineSpec, params, rank: Optional[int] = None):
    """Zero error-feedback state for ``spec.grad_psum_bits``: one fp32
    residual per shared leaf and writing stage (:func:`psum_writers`),
    each leaf stacked ``[n_writers, ...]`` -- the rows of the reference's
    ``[P, ...]`` stack that can be nonzero.  Thread it through the grads
    fn: ``grads, metrics, ef = fn(params, batch, ef)``.  With ``rank``
    (a rank's executor) only that stage's rows: ``[1, ...]`` where it
    writes the leaf, ``[0, ...]`` elsewhere."""
    shared = {k: v for k, v in params.items() if k != "blocks"}
    return tree_unflatten(shared, [
        torch.zeros(((len(w) if rank is None else int(rank in w)),)
                    + a.shape, dtype=torch.float32, device=a.device)
        for a, w in zip(tree_leaves(shared), psum_writers(spec, shared))])


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


def make_train_grads_fn(spec: PipelineSpec, device, *, mesh=None,
                        wrap_executor=None, shard=None):
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
    preallocated buffers (the boundary leaf's, in the wire's storage
    form; :func:`payload_ring_bytes` counts every payload ring).  A
    sequence-chunked table (``spec.n_seq > 1``) runs
    :class:`repro_torch.seqpipe.runtime.SeqExecutor`, with the same
    gradient semantics.

    With ``spec.grad_psum_bits`` the shared gradients are summed over
    the stages by :func:`~repro_torch.optim.compression.compressed_sum`
    (the reference's ``compressed_psum`` over the pipe axis): ``fn(params,
    batch, psum_ef) -> (grads, metrics, new_ef)``, ``psum_ef`` from
    :func:`init_psum_ef` and updated in place, ``metrics["psum_scale"]``
    each leaf's shared scale.  Sequence-chunked specs refuse it
    (ValueError), as in the reference.

    ``mesh`` (:class:`repro_torch.launch.mesh.PipeMesh`): run this
    rank's column only (:class:`_RankExecutor`, on ``mesh.device``;
    ``params`` from :func:`rank_params`, ``psum_ef`` from
    ``init_psum_ef(rank=)``).  Block gradients are the rank's ``[v, M,
    ...]``, shared gradients and metrics the sums over the ranks.  A
    :class:`repro_torch.launch.mesh.Mesh` (``pp x dp x tp``) runs its
    pipe: ``params`` the rank's tp shard (``rank_params(shard=)``),
    ``batch`` the global one (``mbB * dp`` rows a microbatch, the rank
    reads its own), the gradients those of the global batch.  A
    sequence-chunked spec raises NotImplementedError under a mesh (ROADMAP
    queue A item 6).

    ``shard`` (a :class:`RankShard`, with a ``pp x dp x tp`` mesh) at
    ZeRO stage 3: ``params`` hold the rank's dp slice of every block leaf
    the reference keeps fsdp on (``rank_params(shard=)``), and so do its
    gradients, in fp32 (:class:`_RankExecutor`).

    ``wrap_executor``: a function of the executor class to the class to
    build (the dry run's, which counts each distinct op once)."""
    if mesh is not None and spec.n_seq > 1:
        raise NotImplementedError(
            "the sequence-chunked executor over ranks is not ported yet "
            "(ROADMAP queue A item 6)")
    if mesh is not None:
        ex = _RankExecutor(spec, getattr(mesh, "pipe", mesh), shard)
    else:
        if spec.n_seq > 1:
            if spec.grad_psum_bits:
                raise ValueError("compressed gradient psum is not "
                                 "implemented for sequence-chunked specs")
            from repro_torch.seqpipe.runtime import SeqExecutor
            cls = SeqExecutor
        else:
            cls = _Executor
        ex = (cls if wrap_executor is None else wrap_executor(cls))(spec,
                                                                    device)

    def fn(params, batch, psum_ef=None):
        return ex.run(params, batch, psum_ef)

    fn.rings = ex.rings
    fn.exchange = getattr(ex, "exchange", None)     # a rank's, else None
    return fn


class TrainStepOut(NamedTuple):
    """What a pipeline training step returns.  ``shipment``: under
    Chronos-Offload what goes to the host, the deep chunks' gradient
    sums (raw, not yet divided by ``m``) or, with a compressed shipment,
    their ``(codes, scales)``; else None.  ``ef``: with
    ``spec.grad_psum_bits`` the new error-feedback state, else None."""
    params: Any
    opt_state: Any
    metrics: Dict[str, Any]
    shipment: Any = None
    ef: Any = None


def make_train_update_fn(spec: PipelineSpec, device, ocfg, m: int, *,
                         use_kernel: bool = True, offload_chunks: int = 0,
                         mesh=None, wrap_executor=None, shard=None):
    """Gradients, then the AdamW step on them: returns ``fn(params,
    opt_state, batch[, psum_ef]) ->`` :class:`TrainStepOut`.  The update
    reads each gradient as ``g.float() / m`` (``m`` microbatches), as the
    reference's ``g.astype(f32) / m``, in
    :func:`repro_torch.optim.adamw.adamw_update` -- with ``use_kernel``,
    one fused-AdamW kernel launch per parameter leaf.  The optimizer
    state and ``params`` are updated in place (``params`` is returned).

    ``offload_chunks`` (Chronos-Offload): the gradients and the
    parameters are split alike on the chunk axis
    (:func:`~repro_torch.optim.offload.split_deep_shallow`) into the kept
    part (the shallow chunks and the shared leaves) and the held one (the
    last ``offload_chunks`` chunks).  The update then covers the kept
    part only (its clip norm too, as the reference clips the device
    update by ``g_dev``'s norm), and the held gradients are the
    ``shipment``; the held weights are left as they are.

    With ``spec.grad_psum_bits`` the step takes the error-feedback state
    ``psum_ef`` and returns the new one as ``ef``.  ``wrap_executor``: as
    :func:`make_train_grads_fn`.

    ``mesh``: one rank's step (``params`` and ``opt_state`` of its
    column, :func:`rank_params`).  The clip norm is the reference's
    in-executor one, ``sqrt(psum(sq_b) + sq_s + 1e-30)``: the rank's
    block square sum summed over the ranks, plus the shared leaves'
    (equal on every rank after the sum).  Each rank updates its block
    leaves and its replica of the shared leaves.

    ``shard`` (a :class:`RankShard`; ``mesh`` then a ``pp x dp x tp``
    :class:`~repro_torch.launch.mesh.Mesh`): ``params`` are the rank's
    tp shard, ``opt_state`` the state of its ZeRO slices
    (``adamw_init(shard.zero_views(params))``).  Every leaf's dp slice
    (or whole leaf) is updated by fused AdamW (one launch a leaf), its
    weights written into the slice and all-gathered over dp; at ZeRO
    stage 3 a leaf held as its dp slice is updated in place and gathered
    only where an op uses it.  The clip
    norm counts every element once (:meth:`RankShard.owned`): the owned
    block squares summed over pp, plus the owned shared ones, summed
    over tp and dp.

    ``offload_chunks`` with ``shard``: ``fn.kept_shard`` and
    ``fn.deep_shard`` lay out the two parts
    (:meth:`RankShard.offload_parts`).  The
    kept leaves are updated as above on the kept shard's slices (the
    clip norm counts only theirs); the held gradients, summed over dp,
    become the rank's shipment in the deep shard's layout: each leaf's
    ZeRO slice (:meth:`RankShard.zero_slice`, own contiguous copies; at
    stage 3 a leaf held as its dp slice is that fp32 slice), which the
    caller's host optimizer updates and whose weights
    :meth:`RankShard.gather_weights` of the deep shard all-gathers over
    dp after the upload."""
    grads_fn = make_train_grads_fn(spec, device, mesh=mesh,
                                   wrap_executor=wrap_executor, shard=shard)
    m_dev = torch.tensor(float(m), dtype=torch.float32, device=device)
    split, kept_shard, deep_shard = None, shard, None
    if offload_chunks:
        v = spec.layout.v
        axis = 0 if mesh is not None else 1     # a rank's column [v, M, ...]

        def split(tree):
            shallow, deep = split_deep_shallow(tree["blocks"], v,
                                               offload_chunks, axis=axis)
            return {**tree, "blocks": shallow}, deep
        if shard is not None:
            kept_shard, deep_shard = shard.offload_parts(v - offload_chunks)

    def norm_over_ranks(grads):
        sq_b = sum(leaf_sq_sum(g, m_dev)
                   for g in tree_leaves(grads["blocks"]))
        sq_s = sum(leaf_sq_sum(g, m_dev) for k, v in grads.items()
                   if k != "blocks" for g in tree_leaves(v))
        mesh.all_reduce(sq_b, "sum")
        return torch.sqrt(sq_b + sq_s + 1e-30)

    def norm_over_mesh(grads):
        zero = torch.zeros((), dtype=torch.float32, device=device)
        sq = {"blocks": zero, "shared": zero}
        for i, (path, g) in enumerate(zip(kept_shard.paths,
                                          tree_leaves(grads))):
            part = kept_shard.owned(g, i)
            if part is not None:
                k = "blocks" if path[0] == "blocks" else "shared"
                sq[k] = sq[k] + leaf_sq_sum(part, m_dev)
        sq_b = sq["blocks"].contiguous()
        mesh.all_reduce(sq_b, "pp")
        tot = (sq_b + sq["shared"]).contiguous()
        mesh.all_reduce(tot, "model")
        mesh.all_reduce(tot, "data")
        return torch.sqrt(tot + 1e-30)

    def fn(params, opt_state, batch, psum_ef=None):
        res = grads_fn(params, batch, psum_ef)
        grads, metrics = res[:2]
        kept, held = params, None
        if split is not None:
            (grads, held), kept = split(grads), split(params)[0]
        if shard is not None:
            norm = norm_over_mesh(grads)
            grads = tree_unflatten(grads, [
                kept_shard.zero_slice(g, i).contiguous()
                for i, g in enumerate(tree_leaves(grads))])
            if held is not None:
                held = tree_unflatten(held, [
                    deep_shard.zero_slice(g, i).contiguous()
                    for i, g in enumerate(tree_leaves(held))])
            kept_views = kept_shard.zero_views(kept)
        else:
            norm = None if mesh is None else norm_over_ranks(grads)
            kept_views = kept
        master, opt_state, om = adamw_update(
            grads, opt_state, ocfg, use_kernel=use_kernel, grad_div=m_dev,
            grad_norm=norm)
        cast_like(master, kept_views)
        if shard is not None:
            kept_shard.gather_weights(mesh, kept)
        return TrainStepOut(params, opt_state, {**metrics, **om}, held,
                            res[2] if spec.grad_psum_bits else None)

    fn.rings = grads_fn.rings
    fn.exchange = getattr(grads_fn, "exchange", None)
    fn.shard = shard
    fn.kept_shard = kept_shard if split is not None else None
    fn.deep_shard = deep_shard
    return fn
