"""Meshes of ``torch.distributed`` ranks: the counterpart of
``repro/launch/mesh.py``.

Layouts (shape and axis names, no processes), as the reference builds
them: :func:`make_production_mesh`, :func:`make_study_mesh`,
:func:`make_host_study_mesh` (with its rules) and
:func:`production_rules`.

Running meshes:

- :class:`PipeMesh`: the pipe axis alone (one rank a pipeline stage), or
  the pp-axis view of a :class:`Mesh`: the process group of the rank's
  pipe, its place on it, and the global ranks of its stages;
- :class:`Mesh`: ``pp x dp x tp`` ranks in the order of
  ``make_host_study_mesh``'s ``("pp", "data", "model")`` lattice, rank
  ``(p * dp + d) * tp + t``, with one process group per line of each
  axis (every process creates every group, in one fixed order), the
  reference's pipeline rules (:data:`MESH_RULES`), the K/V groups of
  each tp line (:func:`kv_groups`: its runs of consecutive tp ranks that
  share a replicated K/V head), and per-axis collectives that count the
  bytes they are handed (all-reduce, all-gather, reduce-scatter).  A
  mesh of pp 1 serves ``train()``; :meth:`Mesh.regroup` lays the same
  world out again (another ``pp x dp x tp`` of the same size), so one
  spawn can run several layouts.

The transport follows from the backend and the device, never from a
fallback:

- ``device`` (NCCL with CUDA tensors, one card a rank; gloo with CPU
  tensors): the collectives take the tensors as they are;
- ``host`` (gloo with CUDA tensors): the tensors are staged through
  page-locked host memory, since gloo takes CPU tensors only -- the one
  form that runs several ranks on one card (NCCL refuses two ranks on
  one device, and :func:`check_mesh` raises for it).

:func:`spawn` starts ``n`` local processes (the ``spawn`` start method)
that meet over a ``FileStore`` in a temporary directory, so no TCP port
is taken and parallel runs cannot collide::

    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import train_rank, train_single_rank
    outs = spawn(4, train_rank, args=(tc, 4))        # one card (gloo)
    outs = spawn(4, train_rank, args=(tc, 4), backend="nccl",
                 device="cuda")                      # one card a rank
    outs = spawn(2, train_rank, args=(tc, 2), device="cpu")  # gloo, CPU
    outs = spawn(8, train_rank, args=(tc, 2), shape=(2, 2, 2),
                 device="cpu")               # pp 2 x dp 2 x tp 2, gloo
    outs = spawn(4, train_single_rank, args=(tc,), shape=(1, 2, 2),
                 device="cpu")               # train() on dp 2 x tp 2
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
AXES = ("pp", "data", "model")
#: the reference's pipeline rules (``production_rules(multi_pod=True,
#: pipeline=True)``) with its pipe axis under the host study mesh's name:
#: fsdp over "data" shards the optimizer state (ZeRO-1), and at ZeRO-3
#: the weights the reference keeps fsdp on
MESH_RULES = {"dp": "data", "fsdp": "data", "tp": "model", "sp": "data",
              "pp": "pp"}


# ---------------------------------------------------------------------------
# layouts: shape and axis names, as the reference's meshes have them
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes (``shape``: name -> size, in axis
    order, as ``jax.sharding.Mesh.shape``), without processes."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single pod (16, 16) ``("data", "model")``; multi-pod (2, 16, 16)
    ``("pod", "data", "model")``."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_study_mesh(pp: int, dp: int, tp: int) -> MeshLayout:
    """Deeper-pipeline study meshes ``("pod", "data", "model")``."""
    return MeshLayout(("pod", "data", "model"), (pp, dp, tp))


def make_host_study_mesh(pp: int, dp: int = 1, tp: int = 1):
    """``(layout, rules)``: a bare ``("pp",)`` pipe when dp == tp == 1,
    else the ``("pp", "data", "model")`` lattice, with the reference's
    rules for each."""
    if dp == 1 and tp == 1:
        return (MeshLayout(("pp",), (pp,)),
                {"pp": "pp", "dp": None, "tp": None, "fsdp": None})
    return (MeshLayout(AXES, (pp, dp, tp)),
            {"pp": "pp", "dp": "data", "tp": "model", "fsdp": None})


def production_rules(multi_pod: bool, *, serving: bool = False,
                     pipeline: bool = False) -> Dict[str, object]:
    """Logical axis -> physical axes for the production meshes (the
    reference's): single pod FSDP(data) x TP(model); multi-pod
    PP(pod) x FSDP(data) x TP(model) with ``pipeline``, else DP over
    (pod, data)."""
    if not multi_pod:
        return {"dp": "data", "fsdp": "data", "tp": "model", "sp": "data"}
    if pipeline:
        return {"dp": "data", "fsdp": "data", "tp": "model", "sp": "data",
                "pp": "pod"}
    return {"dp": ("pod", "data"), "fsdp": ("pod", "data"), "tp": "model",
            "sp": ("pod", "data")}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _Staging:
    """Page-locked host buffers, one per dtype, grown on demand: the
    ``host`` transport's collectives copy a CUDA tensor down, reduce on
    the host and copy it back up.  Each use synchronizes the stream
    before gloo reads the buffer, which also orders it after the last
    use's copy up.  One per process (:data:`_STAGING`), shared by every
    mesh it lays out: the caching host allocator keeps each freed
    page-locked block, so buffers of their own would pin the largest
    transfer of every layout a process regroups into."""

    def __init__(self):
        self.bufs: Dict[torch.dtype, torch.Tensor] = {}

    def flat(self, dtype: torch.dtype, numel: int) -> torch.Tensor:
        """The first ``numel`` elements of the ``dtype`` buffer."""
        buf = self.bufs.get(dtype)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(max(numel, 1 << 16), dtype=dtype,
                              pin_memory=True)
            self.bufs[dtype] = buf
        return buf[:numel]

    def take(self, t: torch.Tensor) -> torch.Tensor:
        return self.flat(t.dtype, t.numel()).view(t.shape)


_STAGING = _Staging()


def _all_reduce(t: torch.Tensor, group, op: str, staged: bool,
                staging: "_Staging") -> torch.Tensor:
    if not staged:
        dist.all_reduce(t, _OPS[op], group=group)
        return t
    h = staging.take(t)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    dist.all_reduce(h, _OPS[op], group=group)
    return t.copy_(h, non_blocking=True)


def _all_gather_into(outs: List[torch.Tensor], t: torch.Tensor, group,
                     staged: bool, staging: "_Staging") -> None:
    """Every rank's ``t`` of the group into ``outs`` (tensors of ``t``'s
    shape on ``t``'s device), in the group's rank order; staged through
    one page-locked slab: ``t``, then the group's copies."""
    if not staged:
        dist.all_gather(outs, t.contiguous(), group=group)
        return
    n = t.numel()
    slab = staging.flat(t.dtype, n * (len(outs) + 1))
    h = slab[:n].view(t.shape)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    hs = [slab[n * (j + 1):n * (j + 2)].view(t.shape)
          for j in range(len(outs))]
    dist.all_gather(hs, h, group=group)
    for o, x in zip(outs, hs):
        o.copy_(x, non_blocking=True)


def _reduce_scatter(ts: List[torch.Tensor], dims: Sequence[int], n: int,
                    me: int, group, staged: bool,
                    staging: "_Staging") -> List[torch.Tensor]:
    """Each ``ts[i]`` split into ``n`` equal blocks along ``dims[i]``,
    summed over the group's ranks: block ``me`` of each (new contiguous
    tensors), in one collective (the tensors share a dtype and a
    device).  The send buffer holds rank ``j``'s blocks of every tensor
    flat, one after another, at row ``j``; under ``host`` it and the
    result are staged through one page-locked slab."""
    parts = [t.chunk(n, d) for t, d in zip(ts, dims)]
    sizes = [p[0].numel() for p in parts]
    k = sum(sizes)
    t0 = ts[0]
    if staged:
        slab = staging.flat(t0.dtype, k * (n + 1))
    else:
        slab = torch.empty(k * (n + 1), dtype=t0.dtype, device=t0.device)
    rows = [slab[k * j:k * (j + 1)] for j in range(n + 1)]
    for j in range(n):
        off = 0
        for p, m in zip(parts, sizes):
            rows[j][off:off + m].view(p[j].shape).copy_(p[j],
                                                       non_blocking=True)
            off += m
    if staged:
        torch.cuda.current_stream(t0.device).synchronize()
    dist.reduce_scatter(rows[n], rows[:n], group=group)
    out, off = [], 0
    for p, m in zip(parts, sizes):
        o = torch.empty(p[me].shape, dtype=t0.dtype, device=t0.device)
        out.append(o.copy_(rows[n][off:off + m].view(o.shape),
                           non_blocking=True))
        off += m
    return out


def _by_dtype(ts: Sequence[torch.Tensor]) -> List[List[int]]:
    """The indices of ``ts`` grouped by dtype, in first-seen order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


@dataclass
class PipeMesh:
    """One rank's view of the pipe axis: its process group, its place
    ``rank`` on the ``P`` stages, and (the pp view of a :class:`Mesh`)
    the global ranks of the stages, ``ranks``, and the whole mesh,
    ``parent``."""
    group: Any                 # the process group of the P ranks
    rank: int
    P: int
    backend: str
    device: torch.device
    reduced_bytes: int = 0     # bytes this rank handed to all_reduce
    ranks: Optional[Tuple[int, ...]] = None
    parent: Any = None
    _staging: Any = field(default=_STAGING, repr=False)

    @property
    def staged(self) -> bool:
        """Do the collectives go through host memory (the ``host``
        transport: gloo handed CUDA tensors)?"""
        return self.backend == "gloo" and self.device.type == "cuda"

    def global_rank(self, stage: int) -> int:
        """The process rank of pipe stage ``stage``."""
        return stage if self.ranks is None else self.ranks[stage]

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce (``op`` "sum" or "max") of ``t`` over the
        ranks; under ``host`` through a page-locked host copy.  A pipe
        of one stage (a mesh with pp = 1) has nothing to reduce."""
        if self.P == 1:
            return t
        self.reduced_bytes += t.numel() * t.element_size()
        return _all_reduce(t, self.group, op, self.staged, self._staging)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on all), in rank order, on the
        host."""
        h = t.detach().cpu()
        out = [torch.empty_like(h) for _ in range(self.P)]
        if self.staged or self.backend == "gloo":
            dist.all_gather(out, h, group=self.group)
            return out
        dev = [torch.empty_like(t) for _ in range(self.P)]
        dist.all_gather(dev, t.detach(), group=self.group)
        return [a.cpu() for a in dev]


class Mesh:
    """One rank of a ``pp x dp x tp`` mesh: the reference's ``("pp",
    "data", "model")`` lattice, rank ``(p * dp + d) * tp + t``.

    ``shape`` (axis name -> size) and ``rules`` (:data:`MESH_RULES`)
    serve :class:`repro_torch.models.sharding.ShardEnv`; ``coords``
    is this rank's place on each axis; ``groups`` the process group of
    each axis through it; ``pipe`` the :class:`PipeMesh` of its pp group
    (the exchange's, with the stages' global ranks).  The collectives
    over "data" and "model" count what they are handed in
    ``reduced_bytes[axis]`` (a reduce-scatter its whole input, an
    all-gather the rank's part); the pipe's all-reduces count in
    ``pipe.reduced_bytes``.  ``kv_groups``: span -> the process group of
    the rank's K/V group of that span on its tp line
    (:func:`kv_groups`)."""

    def __init__(self, pp: int, dp: int, tp: int, rank: int, backend: str,
                 device, groups: Optional[Dict[str, Any]] = None,
                 kv: Optional[Dict[int, Any]] = None):
        self.sizes = (pp, dp, tp)
        self.pp, self.dp, self.tp = pp, dp, tp
        self.rank, self.backend = rank, backend
        self.device = torch.device(device)
        self.coords = dict(zip(AXES, mesh_coords(rank, pp, dp, tp)))
        self.groups = groups or {a: None for a in AXES}
        self.kv_groups = kv or {}
        self.rules = dict(MESH_RULES)
        self.reduced_bytes = {a: 0 for a in AXES[1:]}
        self._staging = _STAGING
        p, d, t = (self.coords[a] for a in AXES)
        self.pipe = PipeMesh(self.groups["pp"], p, pp, backend, self.device,
                             ranks=tuple(mesh_rank(q, d, t, dp, tp)
                                         for q in range(pp)),
                             parent=self)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.sizes))

    @property
    def size(self) -> int:
        return self.pp * self.dp * self.tp

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   span: Optional[int] = None) -> torch.Tensor:
        """In-place all-reduce of ``t`` over ``axis`` ("pp", "data" or
        "model"); a no-op on an axis of size 1.  ``span`` (on "model"):
        over the rank's K/V group of ``span`` consecutive tp ranks only,
        counted under "model"."""
        if axis == "pp":
            return self.pipe.all_reduce(t, op)
        if self.shape[axis] == 1:
            return t
        group = self.groups[axis]
        if span is not None and span != self.shape[axis]:
            assert axis == "model", "K/V groups lie on the tp axis"
            group = self.kv_groups[span]
        self.reduced_bytes[axis] += t.numel() * t.element_size()
        return _all_reduce(t, group, op, self.staged, self._staging)

    def all_gather_into(self, outs: List[torch.Tensor], t: torch.Tensor,
                        axis: str) -> None:
        """Every rank's ``t`` over ``axis`` into ``outs`` (one tensor a
        rank, in axis order), counting ``t``'s bytes."""
        self.reduced_bytes[axis] += t.numel() * t.element_size()
        _all_gather_into(outs, t, self.groups[axis], self.staged,
                         self._staging)

    def all_gather_cat(self, ts: Sequence[torch.Tensor], axis: str,
                       dims: Sequence[int]) -> List[torch.Tensor]:
        """Every rank's ``ts[i]`` over ``axis`` joined along ``dims[i]``
        in axis order (new tensors): whole leaves from their slices
        (ZeRO-3's gather at use), the leaves of one dtype flat in one
        collective, counting the bytes of ``ts``."""
        n = self.shape[axis]
        out: List[Any] = [None] * len(ts)
        for idx in _by_dtype(ts):
            flat = torch.cat([ts[i].reshape(-1) for i in idx])
            outs = [torch.empty_like(flat) for _ in range(n)]
            self.all_gather_into(outs, flat, axis)
            off = 0
            for i in idx:
                m = ts[i].numel()
                out[i] = torch.cat([o[off:off + m].view(ts[i].shape)
                                    for o in outs], dim=dims[i])
                off += m
        return out

    def reduce_scatter(self, ts: Sequence[torch.Tensor], axis: str,
                       dims: Sequence[int]) -> List[torch.Tensor]:
        """Each ``ts[i]`` summed over ``axis`` and cut into its ranks'
        equal blocks along ``dims[i]``: this rank's blocks (new
        tensors), the tensors of one dtype in one collective, counting
        the bytes of ``ts`` (the gradients of leaves held as dp
        slices)."""
        n = self.shape[axis]
        if n == 1:
            return list(ts)
        out: List[Any] = [None] * len(ts)
        for idx in _by_dtype(ts):
            group = [ts[i] for i in idx]
            self.reduced_bytes[axis] += sum(t.numel() * t.element_size()
                                            for t in group)
            got = _reduce_scatter(group, [dims[i] for i in idx], n,
                                  self.coords[axis], self.groups[axis],
                                  self.staged, self._staging)
            for i, g in zip(idx, got):
                out[i] = g
        return out

    def regroup(self, shape) -> "Mesh":
        """Another layout ``(pp, dp, tp)`` of the same world (the same
        number of ranks), its axis groups made by every process in one
        order, as :func:`init_mesh` makes them: one spawn can then run
        several layouts.  A collective the new mesh's ranks all join."""
        pp, dp, tp = _check_shape(self.size, shape)
        return _make_mesh(pp, dp, tp, self.rank, self.backend, self.device)

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's ``t`` over ``axis``, on the host (uncounted: the
        checks' digests)."""
        if axis == "pp":
            return self.pipe.all_gather(t)
        t = t.detach()
        outs = [torch.empty_like(t) for _ in range(self.shape[axis])]
        _all_gather_into(outs, t, self.groups[axis], self.staged,
                         self._staging)
        return [a.cpu() for a in outs]

    def collective_bytes(self) -> Dict[str, int]:
        """Bytes handed to all-reduces and all-gathers so far, by axis
        (the pipe's sends are the exchange's own count)."""
        return {"pp": self.pipe.reduced_bytes, **self.reduced_bytes}


def mesh_coords(rank: int, pp: int, dp: int, tp: int) -> Tuple[int, ...]:
    """``(p, d, t)`` of process ``rank``."""
    return rank // (dp * tp), (rank // tp) % dp, rank % tp


def mesh_rank(p: int, d: int, t: int, dp: int, tp: int) -> int:
    return (p * dp + d) * tp + t


def mesh_groups(pp: int, dp: int, tp: int) -> Dict[str, List[List[int]]]:
    """Each axis's groups (lists of global ranks, in axis order), in the
    one order every process creates them."""
    out: Dict[str, List[List[int]]] = {a: [] for a in AXES}
    for d in range(dp):
        for t in range(tp):
            out["pp"].append([mesh_rank(p, d, t, dp, tp) for p in range(pp)])
    for p in range(pp):
        for t in range(tp):
            out["data"].append([mesh_rank(p, d, t, dp, tp)
                                for d in range(dp)])
    for p in range(pp):
        for d in range(dp):
            out["model"].append([mesh_rank(p, d, t, dp, tp)
                                 for t in range(tp)])
    return out


def kv_groups(pp: int, dp: int, tp: int) -> Dict[int, List[List[int]]]:
    """span -> the K/V groups of that span (lists of global ranks): on
    every tp line, its runs of ``span`` consecutive tp coordinates, for
    every span that divides tp strictly between 1 and tp (the ranks that
    hold one K/V head of a config with ``tp / span`` K/V heads; a span
    of tp is the line's own group), in the one order every process
    creates them."""
    return {span: [[mesh_rank(p, d, k * span + j, dp, tp)
                    for j in range(span)]
                   for p in range(pp) for d in range(dp)
                   for k in range(tp // span)]
            for span in range(2, tp) if tp % span == 0}


def check_mesh(P: int, *, backend: str, device: str) -> None:
    """Raise on a request no run can honour: an unknown backend, fewer
    than 2 ranks (``P`` the number of processes, ``pp * dp * tp``), NCCL
    on the CPU, NCCL with more ranks than cards (two ranks on one
    device), whose message names the ``host`` transport (gloo), and CUDA
    ranks without a card."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{BACKENDS}")
    if P < 2:
        raise ValueError(f"a mesh needs at least 2 ranks, got P={P}")
    if backend == "nccl":
        cuda = torch.device(device).type == "cuda"
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not cuda or n < P:
            raise RuntimeError(
                f"NCCL needs one card a rank: {P} ranks on {n} card(s) "
                "would put two ranks on one device, which NCCL refuses; "
                "run them with backend='gloo', whose exchange stages CUDA "
                "tensors through host memory (the host transport)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{P} CUDA ranks without a card: pass "
                           "device='cpu' for gloo ranks on the CPU")


def _check_shape(n: int, shape) -> Tuple[int, int, int]:
    pp, dp, tp = shape
    if min(pp, dp, tp) < 1 or pp * dp * tp != n:
        raise ValueError(f"a mesh of shape pp x dp x tp = {tuple(shape)} "
                         f"needs pp * dp * tp ranks, got n={n}")
    return pp, dp, tp


def _rank_device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _join(n: int, rank: int, backend: str, store, device: str,
          timeout_s: float) -> torch.device:
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def init_pipe_mesh(P: int, rank: int, backend: str, store, *,
                   device: str = "cuda", timeout_s: float = 600.0
                   ) -> PipeMesh:
    """Join the ``P``-rank process group through ``store`` (a
    ``torch.distributed`` store, e.g. ``FileStore``) as ``rank`` and
    return its :class:`PipeMesh`.  A CUDA rank uses card ``rank % n``
    (card 0 of one) as its current device.  The group's first collective
    is an all-reduce every rank joins (NCCL wants the first call of a
    group collective before point-to-point traffic)."""
    check_mesh(P, backend=backend, device=device)
    dev = _join(P, rank, backend, store, device, timeout_s)
    mesh = PipeMesh(dist.group.WORLD, rank, P, backend, dev)
    mesh.all_reduce(torch.zeros((1,), device=dev))
    return mesh


def init_mesh(shape, rank: int, backend: str, store, *,
              device: str = "cuda", timeout_s: float = 600.0) -> Mesh:
    """Join the ``pp * dp * tp``-rank world as ``rank`` and create every
    axis group (:func:`mesh_groups`, the same calls in the same order on
    every process); returns the rank's :class:`Mesh`.  Each group's first
    collective is an all-reduce its ranks join."""
    pp, dp, tp = shape
    n = pp * dp * tp
    check_mesh(n, backend=backend, device=device)
    dev = _join(n, rank, backend, store, device, timeout_s)
    return _make_mesh(pp, dp, tp, rank, backend, dev)


def _make_mesh(pp: int, dp: int, tp: int, rank: int, backend: str,
               dev) -> Mesh:
    """Every axis group of a ``pp x dp x tp`` layout of the joined world
    (the same calls in the same order on every process) and the rank's
    :class:`Mesh`; each group's first collective is an all-reduce its
    ranks join."""
    mine, kv = {}, {}
    for axis, lines in mesh_groups(pp, dp, tp).items():
        for ranks in lines:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = g
    for span, lines in kv_groups(pp, dp, tp).items():
        for ranks in lines:
            g = dist.new_group(ranks)
            if rank in ranks:
                kv[span] = g
    mesh = Mesh(pp, dp, tp, rank, backend, dev, mine, kv)
    for g in list(mine.values()) + list(kv.values()):
        dist.all_reduce(torch.zeros((1,), device=dev), group=g)
    return mesh


def _child(rank, n, shape, fn, args, backend, device, store_path, out_dir,
           timeout_s):
    """One spawned rank: join the mesh, run ``fn(mesh, *args)``, save its
    result (or the traceback) under ``out_dir``."""
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        store = dist.FileStore(store_path, n)
        if shape is None:
            mesh = init_pipe_mesh(n, rank, backend, store, device=device,
                                  timeout_s=timeout_s)
        else:
            mesh = init_mesh(shape, rank, backend, store, device=device,
                             timeout_s=timeout_s)
        res = fn(mesh, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(P: int, fn: Callable, *, args: Sequence = (),
          backend: str = "gloo", device: str = "cuda",
          timeout_s: float = 600.0, shape=None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``P`` local ranks and return their
    results in rank order, on the card unless ``device="cpu"``: ``mesh``
    a :class:`PipeMesh` of the ``P``
    ranks, or with ``shape = (pp, dp, tp)`` (``pp * dp * tp == P``) a
    :class:`Mesh`.  ``fn`` and ``args`` cross by pickle (``fn`` a
    module-level function); a result crosses through ``torch.save`` in
    the run's temporary directory, so keep it small (tensors on the
    CPU).  The mesh is checked first (:func:`check_mesh`); on a card the
    kernels are built here once, when ``nvcc`` is present, so the ranks
    only load the library.  The parent waits at most ``timeout_s`` in
    all: a rank that fails stops the others, and a hang ends in a kill;
    either raises RuntimeError with the failed ranks' tracebacks."""
    check_mesh(P, backend=backend, device=device)
    if shape is not None:
        shape = _check_shape(P, shape)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        if build.find_nvcc() is not None:
            build.build()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        procs = [ctx.Process(target=_child, args=(
            r, P, shape, fn, tuple(args), backend, device,
            os.path.join(tmp, "store"), tmp, timeout_s)) for r in range(P)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        why = None
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    why = "a rank failed"
                    break
                if time.monotonic() > deadline:
                    why = f"timed out after {timeout_s:.0f} s"
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if why is not None or any(codes):
            errs = []
            for r in range(P):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"--- rank {r} ---\n{f.read()}")
            raise RuntimeError(f"spawn of {P} ranks: {why or 'a rank failed'}"
                               f" (exit codes {codes})\n" + "\n".join(errs))
        # the ranks' own files, written just above
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(P)]
