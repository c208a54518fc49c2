"""Training entry points of the port, each on one device, with the
reference's checkpointer, health monitor, fault injector and watchdog
(``repro_torch.ft``):

- :func:`train`: the single-device driver (``train`` of
  ``repro/launch/train.py``): every microbatch's loss through
  ``LM.loss`` under Chronos-Recomp, gradients summed in fp32, then AdamW;
- :func:`train_pipeline`: ChronosPipe pipeline training under any
  generator of the schedule registry (the V-shape family with its
  fold-back placement; the sequence-chunked family with
  ``plan.seq_chunks`` chunks per microbatch), with Chronos-Offload (the
  deepest chunks' AdamW on the host) when ``plan.offload.enabled``, and
  the fault seams the elastic driver
  (:func:`repro_torch.ft.elastic_pipeline.train_elastic`) drives.

    from repro_torch.launch.train import train, train_pipeline
    out = train(tc)                                # on the card
    out = train(tc, device="cpu")                  # plain versions
    out = train_pipeline(tc, P=4)                  # on the card
    out = train_pipeline(tc, P=2, device="cpu")    # plain versions

``P`` virtual stages run in lockstep on the device, or with ``mesh=``
one stage a ``torch.distributed`` rank, the reference's deployment
(started by :func:`repro_torch.launch.mesh.spawn`; :func:`train_rank` is
the rank's body)::

    from repro_torch.launch.mesh import spawn
    outs = spawn(4, train_rank, args=(tc, 4),
                 device="cuda")          # four ranks on one card (gloo)
    outs = spawn(4, train_rank, args=(tc, 4), backend="nccl",
                 device="cuda")          # one card a rank

Both run on CUDA unless ``device="cpu"``; a CUDA request without a card
raises.

Checkpoints (``tc.checkpoint_dir``): both drivers restore the latest
checkpoint of the directory at start (parameters, optimizer state, the
data cursor and the step to resume at), save every
``tc.checkpoint_every`` steps and when the health monitor asks for a
snapshot (asynchronously: the copy to host memory ends before the next
step), stop when it sees a persistent straggler, and save synchronously
at the step actually reached, keeping ``tc.keep_checkpoints`` steps, in
the reference's on-disk format (:mod:`repro_torch.ft.checkpoint`).  The
port's default ``checkpoint_dir`` is None, where the reference's is
``"/tmp/repro_ckpt"``: without a directory nothing is saved or restored,
and the monitor's snapshot and restart actions are off (there would be
nothing to restart from).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               init_psum_ef,
                                               payload_ring_bytes,
                                               rank_params)
from repro_torch.data import DataPipeline, synthetic_source
from repro_torch.ft.checkpoint import Checkpointer, LeafPart, MeshCheckpointer
from repro_torch.ft.health import Action, HealthMonitor
from repro_torch.ft.inject import DeviceLossError
from repro_torch.launch.steps import (make_pipeline_train_step,
                                      make_train_step, offload_kept,
                                      psum_bits_of)
from repro_torch.optim import adamw_init
from repro_torch.optim.offload import (ChronosOffloadRunner, host_threads,
                                       merge_deep_shallow)
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

# elements of a leaf read at a time by leaf_digest
_DIGEST_SLAB = 1 << 22


# what a mesh still refuses, by ROADMAP item
FAULT_SEAMS_OVER_RANKS = ("fault injection and lost-process detection "
                          "under a mesh are not ported yet (ROADMAP queue "
                          "A item 7, second part)")


def _checkpointer(tc: TrainConfig) -> Optional[Checkpointer]:
    return Checkpointer(tc.checkpoint_dir, keep=tc.keep_checkpoints) \
        if tc.checkpoint_dir is not None else None


def _mesh_checkpointer(tc: TrainConfig, rank: int,
                       size: int) -> Optional[MeshCheckpointer]:
    """A rank's :class:`MeshCheckpointer` of ``tc.checkpoint_dir`` (None
    without one), its token rank 0's, broadcast to the world group: a
    collective every rank joins (uncounted by the mesh's byte
    counters)."""
    if tc.checkpoint_dir is None:
        return None
    import uuid

    import torch.distributed as dist
    token = [uuid.uuid4().hex[:12] if rank == 0 else None]
    dist.broadcast_object_list(token, src=0)
    return MeshCheckpointer(tc.checkpoint_dir, keep=tc.keep_checkpoints,
                            rank=rank, size=size, token=token[0])


def rank_parts(params, opt_state, shard, state_shard=None, pp: int = 0,
               first: bool = True):
    """Where a mesh rank's checkpoint tree ``{"params", "opt"}`` lies in
    the global one (:class:`~repro_torch.ft.checkpoint.LeafPart` trees of
    the same structure): each parameter leaf of ``shard`` (a
    :class:`~repro_torch.models.sharding.TreeShard`; a block leaf of a
    pipeline rank at stage ``pp`` of its ``[P, ...]``), each state leaf
    of ``state_shard`` (the kept part's under offload, else ``shard``)
    with its ZeRO slice, written by one rank of those holding it
    (:meth:`TreeShard.writes`; a leaf replicated over pp by stage 0);
    the optimizer's step by the ``first`` rank."""
    state_shard = state_shard or shard

    def parts(tree, sh, state):
        return tree_unflatten(tree, [LeafPart(
            tuple(sh.shapes[i]),
            (pp,) * sh.dropped[i] + tuple(sh.part_slices(i, state)),
            sh.writes(i, state) and (sh.dropped[i] > 0 or pp == 0))
            for i in range(len(sh.paths))])
    opt = {k: parts(opt_state[k], state_shard, True)
           for k in ("master", "mu", "nu")}
    opt["step"] = LeafPart((), (), first)
    return {"params": parts(params, shard, False), "opt": opt}


def _pipe_shards(spec, plan, mesh, step_fn):
    """The pipeline rank's ``(shard, kept shard)`` for its checkpoint
    parts: the step's on a ``pp x dp x tp`` mesh, else its column's on a
    pipe alone (every axis but pp of one rank)."""
    if step_fn.shard is not None:
        return step_fn.shard, step_fn.kept_shard or step_fn.shard
    from repro_torch.core.pipeline_runtime import RankShard
    from repro_torch.launch.mesh import MESH_RULES
    shape = {"pp": mesh.P, "data": 1, "model": 1}
    coords = {"pp": mesh.rank, "data": 0, "model": 0}

    shard = RankShard(spec.cfg, spec.layout, shape, MESH_RULES, coords,
                      plan.zero_stage)
    if not (plan.offload.enabled and plan.offload.num_offload_chunks > 0):
        return shard, shard
    return shard, shard.offload_parts(
        plan.num_chunks - plan.offload.num_offload_chunks)[0]


def _wants_save(ck, tc: TrainConfig, step: int, action: Action) -> bool:
    """The reference's rule: a snapshot the monitor asked for, or a
    periodic one (never at step 0)."""
    return ck is not None and (action == Action.CHECKPOINT_NOW or (
        step and step % tc.checkpoint_every == 0))


def _resume(ck, pipe, tree, log, tag, layout=None,
            parts=None) -> Optional[int]:
    """Restore the latest checkpoint of ``ck`` into ``tree`` (``params``
    and ``opt``, in place) and the data cursor into ``pipe``; return the
    step to resume at, or None when there is nothing to restore.  With
    ``layout`` (the pipeline's P, v, schedule and placement), a
    checkpoint written under another (P, v, placement) raises: its block
    leaves would land at the wrong (device, chunk) positions.  ``parts``
    (a mesh rank's, :func:`rank_parts`): only the rank's parts are
    read."""
    latest = ck.latest_step() if ck is not None else None
    if latest is None:
        return None
    meta = ck.read_extra(latest).get("layout")
    key = ("P", "v", "placement")
    if layout is not None and meta is not None and \
            tuple(meta[k] for k in key) != tuple(layout[k] for k in key):
        raise RuntimeError(
            f"checkpoint step {latest} was written under layout "
            f"P={meta['P']} v={meta['v']} ({meta['placement']}) but this "
            f"run uses P={layout['P']} v={layout['v']} "
            f"({layout['placement']}); migrate it first "
            "(repro_torch.ft.elastic_pipeline.migrate_checkpoint)")
    extra = ck.restore_into(tree) if parts is None else \
        ck.restore_into(tree, parts=parts)
    if "data" in extra:
        pipe.load_state(extra["data"])
    start = int(extra.get("step", latest))
    log(f"[{tag}] restored checkpoint step {start}")
    return start


class _LoopState:
    """What the training loops share around their steps: the saves into
    ``ck`` (None: none), and under Chronos-Offload the host update in
    flight.  A step's shipment goes to ``runner`` (:meth:`submit`); its
    update is folded into the device weights by ``fold`` (one device:
    the merge into the whole tree; a mesh rank: the upload into its deep
    parts and the dp all-gather) before the next step (timed into
    ``collect_wait_s``), before every save and after the loop
    (:meth:`fold`).  Every checkpoint records the step to resume at, the
    data cursor of ``data`` and (pipeline runs) the ``layout``;
    ``parts``: a mesh rank's (:func:`rank_parts`)."""

    def __init__(self, ck, data, *, log, tag, runner=None, fold=None,
                 bits=None, m: int = 1, layout=None, injector=None,
                 parts=None):
        self.ck, self.data, self.log, self.tag = ck, data, log, tag
        self.runner, self._fold, self.bits, self.m = runner, fold, bits, m
        self.layout, self.injector, self.parts = layout, injector, parts
        self.pending, self.collect_wait_s = False, 0.0

    def submit(self, shipment) -> None:
        """Hand a step's shipment to the host (a compressed one as its
        codes and scales) and mark its update pending."""
        if self.bits:
            codes, scales = shipment
            self.runner.submit(codes, scales=scales)
        else:
            self.runner.submit(shipment, grad_div=self.m)
        self.pending = True

    def fold(self, timed: bool = False) -> None:
        """Fold the pending host update into the device weights."""
        if not self.pending:
            return
        t0 = time.time()
        self._fold()
        self.pending = False
        if timed:
            self.collect_wait_s += time.time() - t0

    def save(self, save_step, next_step, params, opt_state, *,
             sync=False) -> None:
        """Checkpoint ``params`` and ``opt`` (the pending host update
        folded in first: otherwise the deep chunks are one step stale).
        A write that dies (a fault injector arms the crash) is retried
        synchronously, so LATEST keeps resolving to a complete step; a
        mesh rank's save is one of every rank's (no retry: the ranks'
        saves stay in step)."""
        self.fold()
        ck = self.ck
        if self.injector is not None:
            self.injector.arm_checkpoint_crash(save_step)
        tree = {"params": params, "opt": opt_state}
        extra = {"step": next_step, "data": self.data.state()}
        if self.layout is not None:
            extra["layout"] = self.layout
        if self.parts is not None:
            (ck.save if sync else ck.save_async)(save_step, tree,
                                                 extra=extra,
                                                 parts=self.parts)
            return
        try:
            (ck.save if sync else ck.save_async)(save_step, tree,
                                                 extra=extra)
        except Exception as e:                   # noqa: BLE001
            self.log(f"[{self.tag}] checkpoint write died ({e!r}) -> "
                     "synchronous retry")
            ck.save(save_step, tree, extra=extra)

    def end(self, next_step, params, opt_state, save: bool = True) -> None:
        """After the loop: the last host update folded in, then the final
        save at the step actually reached (an early stop must not
        mislabel the checkpoint as having finished)."""
        self.fold()
        if save and self.ck is not None:
            self.save(next_step, next_step, params, opt_state, sync=True)

    def wait_on_error(self) -> None:
        """When an error leaves the loop: let a write in flight end (the
        next incarnation reads the directory); a failure of that write is
        logged, and the previous checkpoint stands."""
        if self.ck is None:
            return
        try:
            self.ck.wait()
        except Exception as werr:                 # noqa: BLE001
            self.log(f"[{self.tag}] checkpoint write died ({werr!r}); the "
                     "previous checkpoint stands")


def train(tc: TrainConfig, *, device="cuda", steps: Optional[int] = None,
          data_source=None, params=None, mesh=None, after_step=None,
          log: Callable[[str], None] = print) -> Dict:
    """Single-device training: ``steps`` (default
    ``tc.optimizer.total_steps``) steps of ``m = global_batch //
    microbatch_size`` microbatches each, through
    :func:`repro_torch.launch.steps.make_train_step`: every microbatch's
    ``LM.loss`` under the Chronos-Recomp checkpoints of
    ``plan.recompute`` over ``plan.num_chunks`` chunks, its gradient
    added into fp32 buffers, then AdamW on their sum divided by ``m``.
    Every key of a batch (``tokens``, and a ``loss_mask`` where the data
    source gives one) reaches ``LM.loss``.

    Parameters are drawn from a ``torch.Generator`` seeded with
    ``tc.seed`` unless ``params`` (an ``LM`` tree on ``device``, e.g.
    bridged weights) is given; either tree is updated in place at every
    step (the fp32 masters are written into it).  The data come from
    ``data_source`` or ``synthetic_source(cfg, seed=tc.seed)`` (tokens,
    and a VLM's patch or an encoder's frame embeddings) through the
    prefetching :class:`DataPipeline`.

    With ``tc.checkpoint_dir`` set, the reference's checkpoint path (the
    module docstring): the latest checkpoint of the directory (one the
    reference's ``train()`` wrote too) is copied into the tree in place
    and the run goes on from its step; steps ``start .. steps - 1`` run.
    The update is the plain AdamW, as the reference's ``train()`` runs
    it: the fused-AdamW kernel runs only inside the pipeline executor.

    Returns ``losses`` (the steps this call ran), ``final_loss``,
    ``steps``, ``wall_s`` and ``median_step_s`` (the health monitor's) as
    the reference does, plus ``start_step``, per-step ``grad_norms``,
    ``lrs`` and ``step_s``, the final ``params`` and ``opt_state``, and
    ``checkpoint_records`` (:attr:`Checkpointer.records`).

    ``mesh`` (a ``1 x dp x tp`` :class:`~repro_torch.launch.mesh.Mesh`,
    from ``spawn(shape=(1, dp, tp))`` or :meth:`Mesh.regroup`; ``device``
    is then ``mesh.device``): this process is one rank of the
    reference's ``train()`` on a mesh (its ``make_train_step``
    sharding, :func:`repro_torch.launch.steps.make_train_step`).  Every
    rank draws the whole tree from ``tc.seed`` (or takes ``params``, such
    a tree) and keeps its part (``step.shard.cut``: the tp shard, and at
    ``plan.zero_stage`` 3 the dp slice of each leaf the reference keeps
    fsdp on); ``m = global_batch // (microbatch_size * dp)`` microbatches
    of ``microbatch_size * dp`` rows, each rank reading its own.
    ``after_step(step, params, opt_state, shard)``, if given, is called
    after every step (e.g. :func:`replicas_equal`; ``shard`` is None
    without a mesh).  Checkpoints on a mesh (``tc.checkpoint_dir``, a
    directory every rank sees): the same format, written by the ranks
    and read back by each for its own parts
    (:class:`~repro_torch.ft.checkpoint.MeshCheckpointer`,
    :func:`rank_parts`), so a checkpoint of one layout restores on
    another ``dp x tp`` or on one device, and one device's on a mesh.
    The ranks save at the same steps, decided by the step count only
    (every ``checkpoint_every`` and at the end): the health monitor
    still times the steps, but a snapshot or restart it asks for on one
    rank's own step times is not taken (the other ranks would not join
    the save).  The result's ``params`` and
    ``opt_state`` are the rank's; it adds ``rank``, ``coords``,
    ``peak_bytes`` and ``static_bytes`` (on a card, as
    :func:`train_pipeline`'s) and ``exchange["axis_bytes"]``, the bytes
    the rank handed to collectives each step by mesh axis."""
    cfg, shape, plan, ocfg = tc.model, tc.shape, tc.plan, tc.optimizer
    dev = resolve_device(device) if mesh is None else mesh.device
    dp = 1 if mesh is None else mesh.dp
    steps = steps or ocfg.total_steps
    mbB = plan.microbatch_size
    m = max(1, shape.global_batch // (mbB * dp))
    step_fn, lm = make_train_step(cfg, plan, ocfg, m, device=dev, mesh=mesh)
    shard = step_fn.shard
    if params is None:
        params = lm.init(torch.Generator(device=dev).manual_seed(tc.seed))
    if shard is not None:
        params = shard.cut(params)
    opt_state = adamw_init(params if shard is None
                           else shard.zero_views(params))
    cuda = mesh is not None and dev.type == "cuda"
    static = None
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        static = torch.cuda.memory_allocated(dev)

    source = data_source or synthetic_source(cfg, shape.seq_len,
                                             seed=tc.seed)
    pipe = DataPipeline(source, global_batch=mbB * dp * m, microbatches=m,
                        prefetch=2)
    monitor = HealthMonitor()
    tag = "train" if mesh is None else f"train rank 0/{mesh.size}"
    parts = None
    if mesh is None:
        ck = _checkpointer(tc)
    else:
        ck = _mesh_checkpointer(tc, mesh.rank, mesh.size)
        parts = rank_parts(params, opt_state, shard,
                           first=mesh.rank == 0) if ck else None
        log = log if mesh.rank == 0 else _quiet
    resumed = _resume(ck, pipe, {"params": params, "opt": opt_state},
                      log, tag, parts=parts)
    start_step = resumed or 0
    state = _LoopState(ck, pipe, log=log, tag=tag, parts=parts)

    pipe.start()
    losses, gnorms, lrs, step_s, axis_bytes = [], [], [], [], []
    next_step = start_step
    t_start = time.time()
    try:
        if mesh is not None and ck is not None and resumed is None:
            # the durable step-0 snapshot, as train_pipeline's: a restart
            # on another dp x tp finds a whole state before the first
            # periodic save
            state.save(0, 0, params, opt_state, sync=True)
        for step in range(start_step, steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.next().items()}
            before = None if mesh is None else mesh.collective_bytes()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.time() - t0
            if mesh is not None:
                now = mesh.collective_bytes()
                axis_bytes.append({a: now[a] - before[a] for a in now})
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            step_s.append(dt)
            next_step = step + 1
            action = monitor.record_step(dt)
            if after_step is not None:
                after_step(step, params, opt_state, shard)
            if mesh is not None:
                # every rank saves at the same steps: a save decided on
                # one rank's own step time alone would leave the others
                # out of it, so on a mesh the count of steps decides
                action = Action.CONTINUE
            if step % tc.log_every == 0:
                log(f"[{tag}] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s)")
            if _wants_save(ck, tc, step, action):
                state.save(step, step + 1, params, opt_state)
            if ck is not None and action == Action.RESTART:
                log("[train] persistent straggler detected -> checkpoint "
                    "+ abort for elastic restart")
                break
        state.end(next_step, params, opt_state)
    except BaseException:
        state.wait_on_error()
        raise
    finally:
        pipe.stop()
    out = {"losses": losses, "final_loss": losses[-1] if losses else None,
           "steps": len(losses), "wall_s": time.time() - t_start,
           "median_step_s": monitor.median_step, "start_step": start_step,
           "grad_norms": gnorms, "lrs": lrs, "step_s": step_s,
           "params": params, "opt_state": opt_state,
           "checkpoint_records": ck.records if ck is not None else []}
    if mesh is not None:
        out.update(rank=mesh.rank, coords=dict(mesh.coords),
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda
                   else None, static_bytes=static,
                   exchange={"axis_bytes": axis_bytes})
    return out


def train_pipeline(tc: TrainConfig, *, P: int, device="cuda",
                   steps: Optional[int] = None, data_source=None,
                   params=None, injector=None, watchdog=None,
                   mesh=None, overlap: bool = False, after_step=None,
                   log: Callable[[str], None] = print) -> Dict:
    """Train up to ``steps`` (default ``tc.optimizer.total_steps``) steps.
    Parameters are drawn from a ``torch.Generator`` seeded with
    ``tc.seed`` unless ``params`` (a stage-stacked tree on ``device``,
    e.g. bridged weights) is given; either tree is updated in place at
    every step (the fp32 masters are written into it).  The data
    come from ``data_source`` or ``synthetic_source(cfg, seed=tc.seed)``
    (tokens, and a VLM's patch or an encoder's frame embeddings) through
    the prefetching :class:`DataPipeline`; every key of a batch reaches
    the step, a source's ``loss_mask`` (aligned with the tokens, as
    ``LM.loss`` reads it) cut to the label positions (``[..., 1:]``).

    ``plan.schedule`` names any registered generator; the plan's
    ``seq_chunks`` reaches the sequence-chunked ones, and the reference's
    refusals raise ValueError (a V-shape schedule with ``num_chunks !=
    2``, ``seq_chunks > 1`` with another schedule or on a model with SSM
    layers, a sequence length that does not split into the chunks).

    Chronos-Offload (``tc.plan.offload.enabled``), in the reference's
    order: a :class:`ChronosOffloadRunner` over the deep chunks' views of
    ``params``; each step's deep gradients are submitted before the loss
    is read, and the host update is collected (its bf16 weights uploaded
    in place) after the next batch is fetched and before the next step,
    timed into ``collect_wait_s``; a last collect follows the loop.

    Checkpoints and fault seams (``tc.checkpoint_dir`` set; the
    reference's driver):

    - every checkpoint records the layout (P, v, schedule, placement) in
      its ``extra``; restoring one written under another (P, v,
      placement) raises RuntimeError (migrate it first:
      :func:`repro_torch.ft.elastic_pipeline.migrate_checkpoint`);
    - a run that finds no checkpoint saves step 0 synchronously first:
      the stage-stacked init draws positions in order from one
      generator, so a fresh init at another P is another network, and a
      recovery is exact only because every incarnation restores;
    - a checkpoint write that dies is retried synchronously; a write
      still in flight when the run dies is waited for (its failure
      logged: the previous checkpoint stands);
    - ``injector`` (:class:`repro_torch.ft.inject.FaultInjector`): a due
      :class:`~repro_torch.ft.inject.DeviceJoin` saves and returns with
      status ``"preempted"``; device loss raises from ``on_step_start``
      before the step runs; its ``step_time`` is what the health monitor
      reads; a monitor RESTART returns status ``"restart"``;
    - ``watchdog`` (:class:`repro_torch.ft.health.Watchdog`) is armed
      around each step and checked after it: a trip raises
      ``DeviceLossError(-1, "hung_collective", step)``.  A
      :class:`~repro_torch.ft.inject.DeviceLossError` leaving the loop
      carries ``loss_by_step``, ``next_step``, ``first_step_s``,
      ``step_s`` and ``checkpoint_records`` of the steps completed;
    - under offload the pending host update is folded in before any
      checkpoint, and after a restore the host optimizer is built from
      the restored weights (host momenta are not checkpointed, as in the
      reference).

    Compression (``plan.wire``, ``plan.grad_compression``; see
    :func:`~repro_torch.launch.steps.make_pipeline_train_step`): the
    boundary payloads travel in the wire's storage form; with
    ``grad_compression`` the driver holds the error-feedback state of the
    compressed shared-gradient sum, made zero at every start (a restore
    included, so a re-plan to another P starts a fresh one) and never
    checkpointed, as in the reference; under offload the deep gradients
    ship quantized to the same width.

    Returns ``losses``, ``loss_by_step``, ``final_loss``, ``steps``,
    ``start_step``, ``next_step``, ``status`` (``"complete"``,
    ``"restart"`` or ``"preempted"``), ``first_step_s`` (the resume
    cost), ``wall_s``, ``median_step_s`` (the health monitor's) and
    ``schedule`` as the reference does, plus per-step ``grad_norms``,
    ``lrs`` and ``step_s``, the final ``params`` and ``opt_state`` and
    ``checkpoint_records``; under offload also ``offload``
    (:func:`offload_report`) and ``host_optimizer`` (the runner's
    :class:`~repro_torch.optim.offload.HostAdamW`, its numpy state);
    ``wire``: the wire, the payload rings' bytes as it stores them, and
    under ``grad_compression`` the final ``psum_ef``, and per shared
    leaf (``"embed/tokens"``, ...) its ``ef_abs_max`` and the last
    step's shared scale ``psum_scale``.

    ``overlap``: the double-buffered exchange's table
    (``make_pipeline_spec(overlap=)``), the same gradients.

    ``after_step(step, params, opt_state, shard)``, if given, is called
    after every step (e.g. :func:`replicas_equal` under a mesh);
    ``shard`` is the step's
    :class:`~repro_torch.core.pipeline_runtime.RankShard` on a ``pp x dp
    x tp`` :class:`~repro_torch.launch.mesh.Mesh`, else None.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.PipeMesh` of ``P``
    ranks; ``device`` is then ``mesh.device``): this process is one
    stage.  Every rank draws the whole stage-stacked tree from
    ``tc.seed`` (or takes ``params``, such a tree) and keeps its column
    (:func:`~repro_torch.core.pipeline_runtime.rank_params`), so its
    weights are bitwise the one-device run's; it reads the same data,
    runs its column of the table and updates its own leaves and its
    replica of the shared ones.  Rank 0 logs.  The fault injector and
    the watchdog (lost-process detection) raise NotImplementedError
    under a mesh (ROADMAP queue A item 7, second part).

    Chronos-Offload on a mesh: each rank's host optimizer holds the
    fp32 master, mu and nu of its own parts of the deep leaves (their
    ZeRO slices of its tp shards; :func:`~repro_torch.optim.offload.
    host_threads` of the ranks' count as its workers), fed by the
    rank's shipment; each collect uploads the rank's parts in place and
    (below ZeRO-3) all-gathers the deep leaves over dp, on every rank at
    the same point of the loop, its bytes counted in the step that
    submitted the update.  Checkpoints on a mesh: the reference's format
    written by the ranks and read back by each for its own parts
    (:class:`~repro_torch.ft.checkpoint.MeshCheckpointer`,
    :func:`rank_parts`; a directory every rank sees), with the step-0
    snapshot, the (P, v, placement) guard, periodic and final saves; a
    checkpoint of one ``dp x tp`` restores on another (the reference's
    ``reshard``) and on one device.  The ranks save at the same steps,
    decided by the count of steps alone: the health monitor times the
    steps but its snapshot and restart actions, read from one rank's
    own step times, are not taken.  Returns the keys above (``params``
    and ``opt_state`` the rank's) and ``rank``, ``overlap``,
    ``peak_bytes`` (on a card, ``max_memory_allocated`` after a reset
    once the weights and the optimizer state are made),
    ``static_bytes`` (allocated at that reset) and ``exchange`` (the
    rank's ``bytes_sent``, ``bytes_recv``, ``messages`` and ``wait_s``
    per step, and ``reduced_bytes``, the bytes it handed to
    all-reduces)."""
    if mesh is not None:
        return _train_pipeline_ranks(tc, P=P, mesh=mesh, overlap=overlap,
                                     steps=steps, data_source=data_source,
                                     params=params, injector=injector,
                                     watchdog=watchdog,
                                     after_step=after_step, log=log)
    cfg, shape, plan, ocfg = tc.model, tc.shape, tc.plan, tc.optimizer
    dev = resolve_device(device)
    steps = steps or ocfg.total_steps
    step_fn, m, mbB, spec = make_pipeline_train_step(
        cfg, shape, plan, ocfg, P=P, device=dev, overlap=overlap)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tc.seed)
        params = init_pipeline_params(gen, cfg, spec.layout, dev)
    bits = psum_bits_of(plan)
    offload = plan.offload.enabled and plan.offload.num_offload_chunks > 0
    if offload:
        kept, deep = offload_kept(params, plan)
        opt_state = adamw_init(kept)
    else:
        opt_state = adamw_init(params)

    source = data_source or synthetic_source(cfg, shape.seq_len,
                                             seed=tc.seed)
    pipe = DataPipeline(source, global_batch=mbB * m, microbatches=m,
                        prefetch=2)
    ck = _checkpointer(tc)
    monitor = HealthMonitor()
    layout_meta = {"P": spec.table.P, "v": plan.num_chunks,
                   "schedule": plan.schedule,
                   "placement": spec.layout.pl.name}
    resumed = _resume(ck, pipe, {"params": params, "opt": opt_state}, log,
                      "train-pp", layout=layout_meta)
    start_step = resumed or 0
    # built after the restore: the host masters start from the restored
    # deep weights
    runner = ChronosOffloadRunner(deep, ocfg, ship_bits=bits) \
        if offload else None
    # the compressed sum's error feedback: zero at every start, never
    # checkpointed (a restart costs one step's quantization error)
    psum_ef = init_psum_ef(spec, params) if bits else None
    scales = None

    def fold():
        merge_deep_shallow(kept["blocks"], runner.collect(),
                           out=params["blocks"])

    state = _LoopState(ck, pipe, log=log, tag="train-pp", runner=runner,
                       fold=fold, bits=bits, m=m, layout=layout_meta,
                       injector=injector)
    pipe.start()
    losses, gnorms, lrs, step_s = [], [], [], []
    loss_by_step: Dict[int, float] = {}
    status, next_step, first_step_s = "complete", start_step, None
    t_start = time.time()
    try:
        if ck is not None and resumed is None:
            # the durable step-0 snapshot
            state.save(0, 0, params, opt_state, sync=True)
        for step in range(start_step, steps):
            if injector is not None and injector.should_yield(step):
                # a lost device rejoined: publish a clean checkpoint and
                # hand control back for the warm scale-up restart
                if ck is not None:
                    state.save(step, step, params, opt_state, sync=True)
                status = "preempted"
                break
            if injector is not None:
                injector.on_step_start(step)
            t0 = time.time()
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in pipe.next().items()}
            if "loss_mask" in batch:
                batch["loss_mask"] = batch["loss_mask"][..., 1:]
            state.fold(timed=True)            # bf16 upload of the deep chunks
            if watchdog is not None:
                watchdog.arm()
            out = step_fn(params, opt_state, batch, psum_ef)
            params, opt_state, metrics, psum_ef = (
                out.params, out.opt_state, out.metrics, out.ef)
            if offload:                         # grads down, host AdamW
                state.submit(out.shipment)
            scales = metrics.get("psum_scale")
            # the deep gradients are views of the step's accumulators:
            # held here, they would live through the next step
            del out
            loss = float(metrics["loss"])     # waits for the step
            if injector is not None:
                injector.on_step_end(step, watchdog)
            if watchdog is not None:
                if watchdog.check():
                    raise DeviceLossError(-1, "hung_collective", step)
                watchdog.disarm()
            dt = time.time() - t0
            losses.append(loss)
            loss_by_step[step] = loss
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            step_s.append(dt)
            next_step = step + 1
            if first_step_s is None:
                first_step_s = time.time() - t_start
            if after_step is not None:
                after_step(step, params, opt_state, None)
            action = monitor.record_step(
                injector.step_time(step, dt) if injector is not None
                else dt)
            if step % tc.log_every == 0:
                log(f"[train-pp] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s)")
            if _wants_save(ck, tc, step, action):
                state.save(step, step + 1, params, opt_state)
            if ck is not None and action == Action.RESTART:
                log("[train-pp] persistent straggler -> checkpoint + "
                    "abort")
                status = "restart"
                break
        state.end(next_step, params, opt_state, save=status != "preempted")
    except BaseException as e:
        # the incarnation dies: let a write in flight end (the elastic
        # driver reads the directory next), and hand the completed
        # steps to the elastic driver on the error
        state.wait_on_error()
        if isinstance(e, DeviceLossError):
            e.loss_by_step, e.next_step = loss_by_step, next_step
            e.first_step_s, e.step_s = first_step_s, step_s
            e.checkpoint_records = ck.records if ck is not None else []
        raise
    finally:
        pipe.stop()
        if runner is not None:
            runner.close()
    res = {"losses": losses, "loss_by_step": loss_by_step,
           "final_loss": losses[-1] if losses else None,
           "steps": len(losses), "start_step": start_step,
           "next_step": next_step, "status": status,
           "first_step_s": first_step_s, "wall_s": time.time() - t_start,
           "median_step_s": monitor.median_step,
           "schedule": spec.table.name, "grad_norms": gnorms, "lrs": lrs,
           "step_s": step_s, "params": params, "opt_state": opt_state,
           "checkpoint_records": ck.records if ck is not None else []}
    res["wire"] = {"wire": plan.wire,
                   "ring_bytes": payload_ring_bytes(spec)}
    if bits:
        names = ["/".join(map(str, p)) for p in tree_paths(psum_ef)]
        res["wire"].update(
            psum_ef=psum_ef,
            ef_abs_max=dict(zip(names, (float(e.abs().max())
                                        for e in tree_leaves(psum_ef)))),
            psum_scale=None if scales is None else dict(zip(
                names, (float(x) for x in tree_leaves(scales)))))
    if offload:
        res["offload"] = offload_report(
            tc, spec, runner, collect_wait_s=state.collect_wait_s)
        res["host_optimizer"] = runner.opt
    return res


def _train_pipeline_ranks(tc: TrainConfig, *, P: int, mesh, overlap: bool,
                          steps, data_source, params, injector, watchdog,
                          after_step, log) -> Dict:
    """:func:`train_pipeline` as one rank of ``mesh``."""
    if injector is not None or watchdog is not None:
        raise NotImplementedError(FAULT_SEAMS_OVER_RANKS)
    full = mesh if hasattr(mesh, "pipe") else None
    pipe = mesh if full is None else full.pipe
    if pipe.P != P:
        raise ValueError(f"P={P} stages on a mesh of {pipe.P} ranks")
    cfg, shape, plan, ocfg = tc.model, tc.shape, tc.plan, tc.optimizer
    dev, rank = pipe.device, pipe.rank
    steps = steps or ocfg.total_steps
    step_fn, m, mbB, spec = make_pipeline_train_step(
        cfg, shape, plan, ocfg, P=P, device=dev, mesh=mesh, overlap=overlap)
    if params is None:
        # the whole draw, then the column: the one-device run's weights
        gen = torch.Generator(device=dev).manual_seed(tc.seed)
        params = init_pipeline_params(gen, cfg, spec.layout, dev)
    shard = step_fn.shard
    params = rank_params(params, rank, shard)
    offload = plan.offload.enabled and plan.offload.num_offload_chunks > 0
    kept_shard, deep_shard = step_fn.kept_shard, step_fn.deep_shard
    deep = deep_views = None
    if offload:
        kept, deep = offload_kept(params, plan, column=True)
        opt_state = adamw_init(kept if kept_shard is None
                               else kept_shard.zero_views(kept))
        # the rank's parts of the deep leaves: the host updates these
        deep_views = deep if deep_shard is None else \
            deep_shard.zero_views({"blocks": deep})["blocks"]
    else:
        opt_state = adamw_init(params if shard is None
                               else shard.zero_views(params))
    bits = psum_bits_of(plan)
    psum_ef = init_psum_ef(spec, params, rank=rank) if bits else None
    dp = 1 if full is None else full.dp
    me, n_ranks = (rank, P) if full is None else (full.rank, full.size)
    cuda = dev.type == "cuda"
    static = None
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        static = torch.cuda.memory_allocated(dev)

    def say(line):
        if me == 0:
            log(line)
    tag = f"train-pp rank 0/{n_ranks}"
    source = data_source or synthetic_source(cfg, shape.seq_len,
                                             seed=tc.seed)
    data = DataPipeline(source, global_batch=mbB * dp * m, microbatches=m,
                        prefetch=2)
    ck = _mesh_checkpointer(tc, me, n_ranks)
    layout_meta = {"P": spec.table.P, "v": plan.num_chunks,
                   "schedule": plan.schedule,
                   "placement": spec.layout.pl.name}
    parts = None
    if ck is not None:
        parts = rank_parts(params, opt_state,
                           *_pipe_shards(spec, plan, pipe, step_fn),
                           pp=rank, first=me == 0)
    resumed = _resume(ck, data, {"params": params, "opt": opt_state}, say,
                      tag, layout=layout_meta, parts=parts)
    start_step = resumed or 0
    # built after the restore: the host masters start from the restored
    # deep weights (host momenta are not checkpointed, as the reference)
    runner = ChronosOffloadRunner(deep_views, ocfg, ship_bits=bits,
                                  threads=host_threads(n_ranks)) \
        if offload else None
    ex = step_fn.exchange
    monitor = HealthMonitor()
    losses, gnorms, lrs, step_s = [], [], [], []
    loss_by_step: Dict[int, float] = {}
    traffic = {"bytes_sent": [], "bytes_recv": [], "messages": [],
               "wait_s": [], "reduced_bytes": []}
    if full is not None:
        traffic["axis_bytes"] = []
    next_step, first_step_s = start_step, None

    def counted():
        return pipe.reduced_bytes, (None if full is None
                                    else full.collective_bytes())

    def fold():
        """Collect the host update (its weights uploaded into the deep
        parts in place), all-gather the deep leaves over dp below ZeRO-3,
        and count its bytes in the step that submitted it."""
        red0, axis0 = counted()
        runner.collect()
        if deep_shard is not None:
            deep_shard.gather_weights(full, {"blocks": deep})
        red1, axis1 = counted()
        if traffic["reduced_bytes"]:
            traffic["reduced_bytes"][-1] += red1 - red0
            if full is not None:
                for a in axis1:
                    traffic["axis_bytes"][-1][a] += axis1[a] - axis0[a]

    state = _LoopState(ck, data, log=say, tag=tag, runner=runner, fold=fold,
                       bits=bits, m=m, layout=layout_meta, parts=parts)
    t_start = time.time()
    data.start()
    try:
        if ck is not None and resumed is None:
            # the durable step-0 snapshot
            state.save(0, 0, params, opt_state, sync=True)
        for step in range(start_step, steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in data.next().items()}
            if "loss_mask" in batch:
                batch["loss_mask"] = batch["loss_mask"][..., 1:]
            state.fold(timed=True)
            ex.reset_stats()
            reduced0, axis0 = counted()
            out = step_fn(params, opt_state, batch, psum_ef)
            params, opt_state, metrics, psum_ef = (
                out.params, out.opt_state, out.metrics, out.ef)
            if offload:                         # grads down, host AdamW
                state.submit(out.shipment)
            del out
            loss = float(metrics["loss"])     # waits for the step
            dt = time.time() - t0
            for k, v in ex.stats().items():
                traffic[k].append(v)
            traffic["reduced_bytes"].append(pipe.reduced_bytes - reduced0)
            if full is not None:
                # bytes handed to collectives by axis: the pipe's sends
                # and all-reduces, and the dp and tp all-reduces and
                # all-gathers (and under offload, once it is collected,
                # the deep leaves' all-gather)
                now = full.collective_bytes()
                traffic["axis_bytes"].append({
                    a: now[a] - axis0[a] + (ex.bytes_sent if a == "pp"
                                            else 0) for a in now})
            losses.append(loss)
            loss_by_step[step] = loss
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            step_s.append(dt)
            next_step = step + 1
            if first_step_s is None:
                first_step_s = time.time() - t_start
            # timed only: the ranks save at the same steps, by the count
            monitor.record_step(dt)
            if after_step is not None:
                after_step(step, params, opt_state, shard)
            if step % tc.log_every == 0:
                say(f"[{tag}] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s, "
                    f"exchange wait {traffic['wait_s'][-1]:.3f}s)")
            if _wants_save(ck, tc, step, Action.CONTINUE):
                state.save(step, step + 1, params, opt_state)
        state.end(next_step, params, opt_state)
    except BaseException:
        state.wait_on_error()
        raise
    finally:
        data.stop()
        if runner is not None:
            runner.close()
    res = {"losses": losses, "loss_by_step": loss_by_step,
           "final_loss": losses[-1] if losses else None,
           "steps": len(losses), "start_step": start_step,
           "next_step": next_step, "status": "complete",
           "first_step_s": first_step_s, "wall_s": time.time() - t_start,
           "median_step_s": monitor.median_step,
           "schedule": spec.table.name, "grad_norms": gnorms, "lrs": lrs,
           "step_s": step_s, "params": params, "opt_state": opt_state,
           "checkpoint_records": ck.records if ck is not None else [],
           "rank": me,
           "coords": None if full is None else dict(full.coords),
           "overlap": overlap,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
           else None, "static_bytes": static,
           "exchange": traffic,
           "wire": {"wire": plan.wire,
                    "ring_bytes": payload_ring_bytes(spec) // P,
                    "psum_ef": psum_ef}}
    if offload:
        res["offload"] = offload_report(
            tc, spec, runner, collect_wait_s=state.collect_wait_s,
            tp=1 if full is None else full.tp, dp=dp)
        res["host_optimizer"] = runner.opt
    return res


def _quiet(line: str) -> None:
    """A log that drops every line (the ranks other than 0)."""


def leaf_digest(a: torch.Tensor) -> torch.Tensor:
    """int64 ``[2]`` of a 16- or 32-bit leaf: the sum of its bit patterns
    read as integers, and their sum weighted by position (mod 1021), read
    in slabs, exact.  Two tensors that differ in any bit almost surely
    differ here, so equal digests stand for bitwise equality at a few
    bytes' cost."""
    flat = a.detach().reshape(-1).view(
        torch.int16 if a.element_size() == 2 else torch.int32)
    s0 = s1 = torch.zeros((), dtype=torch.int64, device=a.device)
    for i in range(0, flat.numel(), _DIGEST_SLAB):
        x = flat[i:i + _DIGEST_SLAB].long()
        w = torch.arange(i, i + x.numel(), device=a.device) % 1021
        s0 = s0 + x.sum()
        s1 = s1 + (x * w).sum()
    return torch.stack([s0, s1])


def shared_digest(params, opt_state) -> torch.Tensor:
    """The :func:`leaf_digest` of every shared leaf's weight and fp32
    master, stacked."""
    return torch.cat([leaf_digest(a)
                      for tree in (params, opt_state["master"])
                      for k, v in tree.items() if k != "blocks"
                      for a in tree_leaves(v)])


def replicas_equal(mesh, params, opt_state, shard=None) -> bool:
    """Does every rank of ``mesh`` hold the same shared leaves (weights
    and fp32 masters)?  Their :func:`shared_digest` gathered over the
    ranks: a collective every rank must join.  A check for the smoke and
    the tests (``train_pipeline(after_step=)``), not part of a step.

    On a ``pp x dp x tp`` :class:`~repro_torch.launch.mesh.Mesh`: the
    shared leaves over the pipe, every weight the rank holds whole over
    dp (the ZeRO-1 all-gather leaves the dp replicas whole and equal; at
    ZeRO-3 a leaf held as its dp slice differs by design), and the
    weights and masters of the tp-replicated leaves over tp, which
    ``shard`` (the run's
    :class:`~repro_torch.models.sharding.TreeShard`, handed to
    ``after_step``) names, and those of each replicated K/V head within
    its K/V group (:func:`replica_checks` gives each)."""
    return all(replica_checks(mesh, params, opt_state, shard).values())


def replica_checks(mesh, params, opt_state, shard=None) -> Dict[str, bool]:
    """:func:`replicas_equal` axis by axis: ``{"pp": ...}``, and on a
    ``pp x dp x tp`` mesh also ``"data"`` and ``"model"`` (which need
    the run's ``shard``), and where the shard holds replicated K/V heads
    ``"kv"``: their weights and masters equal within each K/V group."""
    if not hasattr(mesh, "pipe"):
        digests = mesh.all_gather(shared_digest(params, opt_state))
        return {"pp": all(torch.equal(d, digests[0]) for d in digests)}
    out = {}
    pipe = mesh.pipe
    d = pipe.all_gather(shared_digest(params, opt_state)) if pipe.P > 1 \
        else []
    out["pp"] = all(torch.equal(x, d[0]) for x in d)
    if shard is None:
        raise ValueError("the dp and tp replicas' checks need the run's "
                         "shard (after_step's)")
    d = mesh.all_gather(torch.cat([leaf_digest(a) for a, k in zip(
        tree_leaves(params), shard.fsdp_dims) if k is None]), "data")
    out["data"] = all(torch.equal(x, d[0]) for x in d)
    split = shard.tp_split
    rep = [leaf_digest(a) for a, sp in zip(tree_leaves(params), split)
           if not sp] + [leaf_digest(a) for a, sp in zip(
               tree_leaves(opt_state["master"]), split) if not sp]
    d = mesh.all_gather(torch.cat(rep), "model") if rep else []
    out["model"] = all(torch.equal(x, d[0]) for x in d)
    if any(shard.kv):
        d = mesh.all_gather(torch.cat([
            leaf_digest(a) for tree in (params, opt_state["master"])
            for a, k in zip(tree_leaves(tree), shard.kv) if k]), "model")
        r = shard.kv_rep
        out["kv"] = all(torch.equal(x, d[t - t % r])
                        for t, x in enumerate(d))
    return out


def train_rank(mesh, tc: TrainConfig, P: int,
               kw: Optional[Dict] = None) -> Dict:
    """One rank's :func:`train_pipeline` (``kw`` its keywords:
    ``overlap``, ``steps``, ...), the body :func:`repro_torch.launch.
    mesh.spawn` runs in each process (``args=(tc, P, kw)``): the result
    without the rank's trees and error feedback (they stay in the rank),
    plus ``launches``, each CUDA kernel's launches in this rank's run
    (counted from 0 at its start), ``replicas_equal``, per step
    whether every rank holds the same shared leaves after it
    (:func:`replicas_equal`), and ``replica_checks``, the same axis by
    axis (:func:`replica_checks`: on a ``pp x dp x tp`` mesh every weight
    over dp and the tp-replicated leaves over tp too).  ``mesh``: a
    :class:`~repro_torch.launch.mesh.PipeMesh` or a ``pp x dp x tp``
    :class:`~repro_torch.launch.mesh.Mesh` (``spawn(shape=)``)."""
    out = _checked_rank(mesh, lambda after: train_pipeline(
        tc, P=P, mesh=mesh, after_step=after, **(kw or {})))
    del out["wire"]["psum_ef"]
    return out


def train_single_rank(mesh, tc: TrainConfig,
                      kw: Optional[Dict] = None) -> Dict:
    """One rank's :func:`train` on a ``1 x dp x tp`` mesh (``kw`` its
    keywords), the body ``spawn(n, train_single_rank, args=(tc, kw),
    shape=(1, dp, tp))`` runs: the result without the rank's trees, with
    ``launches``, ``replica_checks`` and ``replicas_equal`` as
    :func:`train_rank`'s."""
    return _checked_rank(mesh, lambda after: train(
        tc, mesh=mesh, after_step=after, **(kw or {})))


def _checked_rank(mesh, run) -> Dict:
    """``run(after_step)`` with every kernel's launch count from 0 and
    the replicas checked after every step; the result without
    ``params`` and ``opt_state``."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_adamw import fused_adamw_flat
    from repro_torch.kernels.rmsnorm import (rmsnorm_rows,
                                             rmsnorm_scale_rows,
                                             rmsnorm_sumsq_rows)
    from repro_torch.kernels.ssd_scan import ssd_scan
    kernels = {"rmsnorm_rows": rmsnorm_rows,
               "rmsnorm_sumsq_rows": rmsnorm_sumsq_rows,
               "rmsnorm_scale_rows": rmsnorm_scale_rows,
               "flash_attention_fwd": flash_attention_fwd,
               "fused_adamw_flat": fused_adamw_flat, "ssd_scan": ssd_scan}
    for fn in kernels.values():
        fn.launches = 0
    checks = []
    out = run(lambda _, p, o, s: checks.append(replica_checks(mesh, p, o,
                                                              s)))
    out["launches"] = {k: fn.launches for k, fn in kernels.items()}
    out["replica_checks"] = checks
    out["replicas_equal"] = [all(c.values()) for c in checks]
    for k in ("params", "opt_state", "host_optimizer"):
        out.pop(k, None)
    return out


def offload_report(tc: TrainConfig, spec, runner, *,
                   collect_wait_s: float, tp: int = 1, dp: int = 1) -> Dict:
    """Measured offload overlap against the paper's Eq. (5)/(7) model, with
    the reference's keys, plus what the runner measured
    (:meth:`ChronosOffloadRunner.measured`: host update seconds, and on a
    card the copies' milliseconds and GB/s).  The model runs at the
    mesh's ``tp`` (1: one card) and the global microbatch (``spec``'s
    ``mbB``, a dp rank's share, times ``dp``), as the reference's
    (``src/repro/launch/train.py:400``, ``:413``).  Its ``pcie_gbps`` and
    ``cpu_flops`` are the plan's inputs, not measurements."""
    from repro_torch.core.analysis import offload_timing
    plan, shape = tc.plan, tc.shape
    ot = offload_timing(
        tc.model, seq_len=shape.seq_len, microbatch=spec.mbB * dp,
        pp=spec.table.P, tp=tp, pcie_gbps=plan.offload.pcie_gbps,
        cpu_flops=plan.offload.cpu_flops,
        offload_frac=plan.offload.num_offload_chunks / plan.num_chunks)
    submits = max(int(runner.stats["submits"]), 1)
    return {
        "submits": int(runner.stats["submits"]),
        "overlapped": int(runner.stats["overlapped"]),
        "measured_overlap_frac": runner.stats["overlapped"] / submits,
        "collect_wait_s": collect_wait_s,
        "eq5_offload_ok": ot.offload_ok,
        "eq7_upload_ok": ot.upload_ok,
        "predicted_overlap_ratio": ot.overlap_ratio,
        **runner.measured(),
    }
