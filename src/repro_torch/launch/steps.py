"""Training steps of the port: the single-device step of the reference's
``train()`` and ``make_pipeline_train_step`` of ``repro/launch/steps.py``,
with its Chronos-Offload path, its compressed boundary wire
(``plan.wire``) and its compressed shared-gradient sum and deep-gradient
shipment (``plan.grad_compression``); the pipeline step runs its ``P``
stages on one device, one stage a rank over a
:class:`~repro_torch.launch.mesh.PipeMesh`, or on a ``pp x dp x tp``
:class:`~repro_torch.launch.mesh.Mesh` with the reference's sharding
(the batch over dp, heads / FFN / vocab, the Mamba-2 channels and the
experts' hidden width over tp, K/V heads split or replicated over tp,
ZeRO-1 over dp)."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig)
from repro_torch.models import LM
from repro_torch.optim import adamw_update, cast_like
from repro_torch.models.sharding import shard_env
from repro_torch.optim.adamw import _slabs, leaf_sq_sum
from repro_torch.optim.compression import (_wire_dtype, grid_scale,
                                          quantize_with)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# plan.grad_compression -> int width of the compressed sum and shipment
PSUM_BITS = {"none": None, "int8_ef": 8, "int16_ef": 16}
# where the rest of ROADMAP queue A item 3 is queued
ITEM_3B = "ROADMAP queue A item 3b"
# what a mesh still refuses, by ROADMAP item
SEQ_OVER_RANKS = ("the sequence-chunked executor over ranks is not ported "
                  "yet (ROADMAP queue A item 6)")


def check_zero_stage(plan: ParallelPlan) -> None:
    """ZeRO stages 0-3 run (ValueError for another): 0 keeps the optimizer
    state whole, 1 and 2 (which the reference's ``zero_state_specs``
    does not tell apart) slice it over dp, 3 also keeps the weights the
    reference shards over fsdp as each dp rank's slice, gathered at
    use."""
    if plan.zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage={plan.zero_stage}: expected 0, 1, 2 "
                         f"or 3")


def check_mesh_model(cfg: ModelConfig, dp: int, tp: int) -> None:
    """Refuse what the mesh does not split yet: under tp > 1, a config
    with attention layers (an encoder's and a cross-attention's too)
    whose query heads tp does not divide, or whose K/V head count ``G``
    and tp divide neither one another (ValueError; an attention-free
    config's unused head counts are not read), and a Mamba-2 config
    whose SSM heads tp does not divide (ValueError).  Where tp divides
    ``G`` each rank holds ``G / tp`` K/V heads; where ``G`` divides tp
    each K/V head is replicated over ``tp / G`` ranks.  Every family
    splits over tp: Mamba-2, MoE, the encoder-decoder and the VLM; MoE
    layers route over the global microbatch under dp."""
    if tp <= 1:
        return
    has_attn = cfg.ssm is None or cfg.ssm.attn_period != 0
    H, G = cfg.num_heads, cfg.num_kv_heads
    if has_attn and (H % tp or (G % tp and tp % G)):
        raise ValueError(
            f"tp={tp} must divide num_heads={H} of {cfg.name}, and tp and "
            f"num_kv_heads={G} must divide one another (whole query heads "
            f"a rank; K/V heads split over tp or replicated over tp / "
            f"num_kv_heads ranks; tp splitting a head: {ITEM_3B}.4')")
    if cfg.ssm is not None:
        heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        if heads % tp:
            raise ValueError(f"tp={tp} must divide the {heads} Mamba-2 "
                             f"heads of {cfg.name} (whole heads a rank)")


def lm_shard(cfg: ModelConfig, shape, rules, coords, zero_stage: int):
    """What one rank of a ``1 x dp x tp`` mesh holds of the ``LM`` tree
    in the reference's ``make_train_step`` (a
    :class:`~repro_torch.models.sharding.TreeShard` of
    :func:`~repro_torch.models.transformer.lm_specs`): the parameters
    keep fsdp at ``zero_stage`` 3 and drop it below; the optimizer state
    (and the fp32 gradient sums beside it) carries fsdp at stages 1-3 and
    is whole at stage 0 (the reference shards it at any stage, as the
    port's pipeline keeps it whole at stage 0)."""
    from repro_torch.models.sharding import TreeShard
    from repro_torch.models.transformer import lm_specs
    from repro_torch.optim.adamw import drop_fsdp, zero_state_specs
    logical = lm_specs(cfg)
    tree = LM(cfg, device="meta").init(None)
    return TreeShard(tree, logical if zero_stage >= 3 else
                     drop_fsdp(logical),
                     zero_state_specs(logical, zero_stage)
                     if zero_stage >= 1 else drop_fsdp(logical),
                     shape, rules, coords, kv_heads=cfg.num_kv_heads)


def make_train_step(cfg: ModelConfig, plan: ParallelPlan,
                    ocfg: OptimizerConfig, m: int, *, device, mesh=None):
    """The step of the reference's single-device ``train()``.  Returns
    ``(step, lm)``: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with every key of ``batch`` [m, mbB, S].

    Each microbatch's loss is ``LM.loss(recomp=plan.recompute,
    num_chunks=plan.num_chunks)`` on the ``plan.kernels`` backend, so each
    period of the stack runs under the Chronos-Recomp checkpoint of its
    chunk; its gradient is added into fp32 buffers (the reference's
    ``a + b.astype(f32)``), and the plain AdamW update reads the sum
    divided by ``m``.  ``params`` and the optimizer state are updated in
    place; ``metrics`` holds device scalars ``loss`` (the microbatch
    mean), ``grad_norm`` and ``lr``.  ``step.grads(params, batch)`` is the
    step's gradient part alone: ``(gsum, lsum)``, the fp32 sums.

    ``mesh`` (a ``1 x dp x tp`` :class:`~repro_torch.launch.mesh.Mesh`):
    the reference's ``make_train_step`` sharding, one rank's step
    (``step.shard``, :func:`lm_shard`; ``params =
    step.shard.cut(whole)``, ``opt_state =
    adamw_init(step.shard.zero_views(params))``).  ``batch`` is the
    global one (``mbB * dp`` rows a microbatch) and the rank reads its dp
    rows (the reference's ``train_batch_specs``), each microbatch's loss
    normalized by the global microbatch's count; the layers split over
    tp.  The fp32 sums are the state's dp slices: each microbatch's
    gradients are reduce-scattered over dp into them (all-reduced where
    the state is whole; a leaf held as its dp slice at ZeRO-3 has its
    gradient reduce-scattered by its gather's backward), and a
    replicated K/V head's summed over its K/V group once a step.  The plain
    AdamW updates the slices, the clip norm counting every element once
    over the mesh, and at stages below 3 the updated slices are
    all-gathered over dp into the weights.  :func:`check_mesh_model`
    refuses what the mesh does not split."""
    check_zero_stage(plan)
    shard = None
    if mesh is not None:
        if mesh.pp != 1:
            raise ValueError(f"train() runs a mesh of pp=1, got "
                             f"pp={mesh.pp} (train_pipeline runs pp > 1)")
        check_mesh_model(cfg, mesh.dp, mesh.tp)
        shard = lm_shard(cfg, mesh.shape, mesh.rules, mesh.coords,
                         plan.zero_stage)
    lm = LM(cfg, kernels=plan.kernels, device=device,
            fsdp=None if shard is None else shard.fsdp_tree())
    dev = lm.device
    m_dev = torch.tensor(float(m), dtype=torch.float32, device=dev)

    def grads(params, batch):
        """``(gsum, lsum)``: the fp32 sums of the microbatches' gradients
        (a list in ``tree_leaves`` order; on a mesh the rank's state
        slices) and of their losses (on a mesh each microbatch's loss the
        global one)."""
        denom, env, sums = [None] * m, contextlib.nullcontext(), params
        if mesh is not None:
            d = mesh.coord("data")
            rows = batch["tokens"].shape[1] // mesh.dp
            batch = {k: v[:, d * rows:(d + 1) * rows]
                     for k, v in batch.items()}
            denom = global_counts(mesh, batch)
            env = shard_env(mesh, mesh.rules)
            sums = shard.zero_views(params)
        gsum = [torch.zeros(a.shape, dtype=torch.float32, device=dev)
                for a in tree_leaves(sums)]
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        with env:
            for i in range(m):
                p = tree_map(lambda a: a.detach().requires_grad_(), params)
                loss = lm.loss(p, {k: v[i] for k, v in batch.items()},
                               recomp=plan.recompute,
                               num_chunks=plan.num_chunks,
                               denom=denom[i])[0]
                gs = torch.autograd.grad(loss, tree_leaves(p))
                for j, (a, g) in enumerate(zip(gsum, gs)):
                    a.add_(g if mesh is None
                           else shard.reduce_grad(mesh, g, j))
                lsum += loss.detach()
                del p, loss, gs     # one microbatch's gradients at a time
        if mesh is not None:
            # the ranks' losses are parts of the global microbatches' means
            mesh.all_reduce(lsum, "data")
            shard.kv_sum(mesh, gsum)
        return gsum, lsum

    def step(params, opt_state, batch):
        gsum, lsum = grads(params, batch)
        if mesh is None:
            master, opt_state, om = adamw_update(
                tree_unflatten(params, gsum), opt_state, ocfg,
                grad_div=m_dev)
            return cast_like(master, params), opt_state, {"loss": lsum / m,
                                                          **om}
        views = shard.zero_views(params)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for j, g in enumerate(gsum):
            if shard.counts(j):
                sq = sq + leaf_sq_sum(g, m_dev)
        mesh.all_reduce(sq, "model")
        mesh.all_reduce(sq, "data")
        master, opt_state, om = adamw_update(
            tree_unflatten(views, gsum), opt_state, ocfg, grad_div=m_dev,
            grad_norm=torch.sqrt(sq + 1e-30))
        cast_like(master, views)
        shard.gather_weights(mesh, params)
        return params, opt_state, {"loss": lsum / m, **om}

    step.shard, step.grads = shard, grads
    return step, lm


def global_counts(mesh, batch) -> torch.Tensor:
    """Each microbatch's label count over the global microbatch (all
    ``dp`` ranks' rows; ``batch`` the rank's, token-aligned as
    ``LM.loss`` reads it), the reference's mean's normalizer: the masked
    positions' count all-reduced over dp (at least 1), else ``dp`` times
    the rows times the labels."""
    tok = batch["tokens"]
    if "loss_mask" not in batch:
        n = mesh.dp * tok.shape[1] * (tok.shape[2] - 1)
        return torch.full((tok.shape[0],), float(n), dtype=torch.float32,
                          device=tok.device)
    cnt = batch["loss_mask"][:, :, 1:].float().sum(dim=(1, 2)).contiguous()
    mesh.all_reduce(cnt, "data")
    return cnt.clamp_(min=1.0)


VSHAPE_SCHEDULES = ("v_min", "v_half", "v_zb")


def plan_schedule_kwargs(plan: ParallelPlan) -> Dict:
    """Schedule-generator kwargs the plan implies: the number of
    rematerialized chunks for ``chronos_recomp`` (any recompute mode but
    "none") and for ``chronos_seq`` (mode "chronos" with
    ``num_recomp_chunks > 0``; ``plan.seq_chunks`` rides separately
    through ``make_pipeline_spec(n_seq=)``), the uniform-recompute
    fraction for ``1f1b``/``gpipe`` (the 1F1B+R baseline); other
    generators need nothing (the V-shape family, :data:`VSHAPE_SCHEDULES`,
    is a fixed v=2 construction that carries its own placement)."""
    rc = plan.recompute
    if (plan.schedule == "chronos_recomp" and rc.mode != "none") or \
            (plan.schedule == "chronos_seq" and rc.mode == "chronos"
             and rc.num_recomp_chunks > 0):
        return {"recomp_chunks": min(rc.num_recomp_chunks,
                                     max(plan.num_chunks - 1, 1))}
    if plan.schedule in ("1f1b", "gpipe") and rc.mode == "uniform" \
            and rc.uniform_frac > 0:
        return {"recomp": rc.uniform_frac}
    return {}


def make_pipeline_train_step(cfg: ModelConfig, shape: ShapeConfig,
                             plan: ParallelPlan, ocfg: OptimizerConfig, *,
                             P: int, device, mesh=None, overlap: bool = False,
                             wrap_executor=None):
    """ChronosPipe train step over ``P`` virtual stages on ``device``.
    Returns ``(step, m, mbB, spec)``: ``step(params, opt_state, batch)
    ->`` :class:`~repro_torch.core.pipeline_runtime.TrainStepOut`
    (``params``, ``opt_state``, ``metrics``, ``shipment``, ``ef``) with
    ``batch["tokens"]`` [m, mbB, seq_len] (and an optional ``loss_mask``
    [m, mbB, seq_len - 1]), and the built ``PipelineSpec``.

    The optimizer is the fused-AdamW kernel (one launch per parameter
    leaf) exactly where the reference fuses its optimizer into the
    executor: ``kernels="fused"`` and a split-backward table (W tasks:
    the zero-bubble and V-shape families); otherwise (the sequence-
    chunked family too) the phase-separate update without the kernel.

    ``plan.seq_chunks`` is the ``n_seq`` of the sequence-chunked
    schedules; a V-shape schedule needs ``num_chunks == 2`` (ValueError
    otherwise, the reference's assertion).

    Chronos-Offload (``plan.offload.enabled``): ``opt_state`` covers only
    the shallow chunks and the shared leaves (``adamw_init`` of
    :func:`offload_kept`), so ``metrics["grad_norm"]`` and the clip do
    too, as in the reference; the step leaves the deep chunks' weights
    untouched and its ``shipment`` is the deep chunks' gradient sums
    (views of the step's accumulators, in the parameters' dtype), which
    the caller hands to a
    :class:`~repro_torch.optim.offload.ChronosOffloadRunner`.  The
    reference turns its in-executor fused optimizer off under offload
    because its update is then split across two programs; the port's
    update always runs after the executor and its kernel equals its
    plain version bitwise, so the shallow update keeps the kernel under
    the rule above.

    ``plan.wire`` reaches the executor (the boundary payloads' storage
    form).  ``plan.grad_compression`` ``"int8_ef"`` / ``"int16_ef"``
    (:data:`PSUM_BITS`) sums the shared gradients over the stages on an
    int wire with error feedback: ``step(params, opt_state, batch,
    psum_ef)``, ``psum_ef`` from
    :func:`~repro_torch.core.pipeline_runtime.init_psum_ef`, the new one
    the result's ``ef``.  Under offload the ``shipment`` is then the
    quantized ``(codes, scales)`` of :func:`ship_deep`.  With
    ``seq_chunks > 1`` it
    raises ValueError, as the reference.  The reference also refuses it
    with ``kernels="fused"``, because its fused AdamW then runs inside
    the executor; the port's update always runs after the executor, so
    it is allowed there (a deliberate divergence).

    ``overlap``: the double-buffered exchange's table
    (``make_pipeline_spec(overlap=)``); per device the same op order, so
    the same gradients.

    ``mesh`` (:class:`~repro_torch.launch.mesh.PipeMesh` of ``P`` ranks):
    the step of one rank, on ``mesh.device``: ``params`` and
    ``opt_state`` are the rank's column
    (:func:`~repro_torch.core.pipeline_runtime.rank_params`), the clip
    norm spans every rank's leaves, and each rank updates its replica of
    the shared leaves.  ``seq_chunks > 1`` raises NotImplementedError
    under a mesh (ROADMAP queue A item 6).  Chronos-Offload runs there:
    ``opt_state`` covers the rank's kept leaves (``adamw_init`` of
    :func:`offload_kept` of its column, ``column=True``: the chunk axis
    is the column's first), the clip norm counts only the kept leaves
    of every rank, and the shipment is the rank's deep gradients (a
    quantized one scaled by each global leaf's amax, :func:`ship_deep`).

    A ``pp x dp x tp`` :class:`~repro_torch.launch.mesh.Mesh` (``pp ==
    P``): ``mbB`` is a dp rank's share of a microbatch (the reference's
    ``microbatch_size``; the global microbatch is ``mbB * dp``) and
    ``batch`` the global one; the step's
    :class:`~repro_torch.core.pipeline_runtime.RankShard` is
    ``step.shard`` (``params = rank_params(..., shard=step.shard)``,
    ``opt_state = adamw_init(step.shard.zero_views(params))``), and
    :func:`check_mesh_model` and :func:`check_zero_stage` refuse what it
    does not run.  Under offload ``step.kept_shard`` and
    ``step.deep_shard`` lay out the two parts (``opt_state =
    adamw_init(step.kept_shard.zero_views(offload_kept(params, plan,
    column=True)[0]))``); the shipment holds the deep leaves' ZeRO slices
    (:func:`~repro_torch.core.pipeline_runtime.make_train_update_fn`).

    ``wrap_executor`` reaches
    :func:`~repro_torch.core.pipeline_runtime.make_train_grads_fn` (the
    dry run's counting executor)."""
    from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                                   make_train_update_fn)
    check_zero_stage(plan)
    full = mesh if hasattr(mesh, "pipe") else None
    dp = 1 if full is None else full.dp
    if full is not None:
        check_mesh_model(cfg, full.dp, full.tp)
        if full.pp != P:
            raise ValueError(f"P={P} stages on a mesh of pp={full.pp}")
    mbB = plan.microbatch_size
    m = plan.num_microbatches or max(2, shape.global_batch // (mbB * dp))
    if plan.schedule in VSHAPE_SCHEDULES and plan.num_chunks != 2:
        raise ValueError(f"{plan.schedule} is a fixed v=2 V-shape "
                         f"construction, got num_chunks={plan.num_chunks}")
    bits = psum_bits_of(plan)
    if mesh is not None and plan.seq_chunks > 1:
        raise NotImplementedError(SEQ_OVER_RANKS)
    if bits and plan.seq_chunks > 1:
        raise ValueError("grad_compression composes with the whole-"
                         "sequence pipeline step only (not seq-chunked "
                         "runs)")
    spec = make_pipeline_spec(
        cfg, P=P, v=plan.num_chunks, m=m, microbatch=mbB,
        seq_len=shape.seq_len, schedule=plan.schedule, kernels=plan.kernels,
        n_seq=plan.seq_chunks, wire=plan.wire, grad_psum_bits=bits,
        overlap=overlap, **plan_schedule_kwargs(plan))
    fuse_opt = plan.kernels == "fused" and spec.table.has_w
    offload_chunks = 0
    if plan.offload.enabled and plan.offload.num_offload_chunks > 0:
        if not plan.offload.num_offload_chunks < plan.num_chunks:
            raise ValueError("offload must leave at least one shallow "
                             "chunk on device")
        offload_chunks = plan.offload.num_offload_chunks
    shard = None
    if full is not None:
        from repro_torch.core.pipeline_runtime import RankShard
        shard = RankShard(cfg, spec.layout, full.shape, full.rules,
                          full.coords, plan.zero_stage)
    step = make_train_update_fn(spec, device, ocfg, m, use_kernel=fuse_opt,
                                offload_chunks=offload_chunks, mesh=mesh,
                                wrap_executor=wrap_executor, shard=shard)
    if not offload_chunks or not bits:
        return step, m, mbB, spec
    update = step
    m_dev = torch.tensor(float(m), dtype=torch.float32, device=device)

    def step(params, opt_state, batch, psum_ef):
        out = update(params, opt_state, batch, psum_ef)
        return out._replace(shipment=ship_deep(out.shipment, m_dev, bits,
                                               mesh=mesh))

    for k in ("rings", "exchange", "shard", "kept_shard", "deep_shard"):
        setattr(step, k, getattr(update, k))
    return step, m, mbB, spec


def psum_bits_of(plan: ParallelPlan) -> Optional[int]:
    """The int width ``plan.grad_compression`` asks for, or None."""
    if plan.grad_compression not in PSUM_BITS:
        raise ValueError(f"unknown grad_compression "
                         f"{plan.grad_compression!r}: expected one of "
                         f"{tuple(PSUM_BITS)}")
    return PSUM_BITS[plan.grad_compression]


def ship_deep(held, m_dev, bits: int, mesh=None):
    """The deep chunks' gradient sums quantized for the host shipment
    (the reference's ``ship_deep``): each leaf read as ``g.float() / m``,
    then one symmetric scale over the whole ``[P, n_off, ...]`` leaf,
    ``max(amax, 1e-30) / qmax``, and codes ``clamp(round(g / scale),
    +-qmax)`` -- int8 (qmax 127) or int16 (32767).  No error feedback:
    a shipment is sent once.  The leaf is read in slabs, a first pass
    for the amax and a second for the codes, so no fp32 copy of a whole
    leaf is held.  Returns ``(codes, scales)``: trees shaped as ``held``
    of contiguous codes and of 0-d fp32 scales.

    ``mesh`` (a rank's shipment: its part of each global leaf): every
    leaf's amax is taken over the whole leaf, as the reference's
    ``jnp.max(jnp.abs(g))`` of the global array -- the ranks' amaxes,
    one fp32 a leaf, all-reduced by max over every axis that holds a
    part of it (pp, and on a ``pp x dp x tp`` mesh dp and tp) before
    the codes are taken; a rank's own amax would scale another grid."""
    leaves = tree_leaves(held)
    amax = [torch.stack([(gs.float() / m_dev).abs().max()
                         for (gs,) in _slabs(g)]).max() for g in leaves]
    if mesh is not None and leaves:
        amax = torch.stack(amax)
        if hasattr(mesh, "pipe"):
            for axis in ("pp", "data", "model"):
                mesh.all_reduce(amax, axis, op="max")
        else:
            mesh.all_reduce(amax, op="max")
        amax = list(amax)
    codes, scales = [], []
    for g, a in zip(leaves, amax):
        q = torch.empty(g.shape, dtype=_wire_dtype(bits), device=g.device)
        scale = grid_scale(a, bits)
        for gs, qs in _slabs(g, q):
            qs.copy_(quantize_with(gs.float() / m_dev, scale, bits))
        codes.append(q)
        scales.append(scale)
    return tree_unflatten(held, codes), tree_unflatten(held, scales)


def offload_kept(tree, plan: ParallelPlan, column: bool = False):
    """``(kept, deep)`` of a pipeline tree under ``plan.offload``: kept is
    the tree with the shallow chunks' block views, deep the deep chunks'
    block views (:func:`~repro_torch.optim.offload.split_deep_shallow`).
    ``column``: the tree is a mesh rank's (:func:`~repro_torch.core.
    pipeline_runtime.rank_params`: block leaves ``[v, M, ...]``, the
    chunk axis first), else the whole ``[P, v, M, ...]``."""
    from repro_torch.optim.offload import split_deep_shallow
    shallow, deep = split_deep_shallow(tree["blocks"], plan.num_chunks,
                                       plan.offload.num_offload_chunks,
                                       axis=0 if column else 1)
    return {**tree, "blocks": shallow}, deep
