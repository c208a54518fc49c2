"""The pipe axis as ``torch.distributed`` ranks: the counterpart of
``repro/launch/mesh.py::make_host_study_mesh``, restricted to the pipe
axis (one rank a pipeline stage; the port's meshes have no dp or tp axis
yet, ROADMAP queue A item 3).

A :class:`PipeMesh` names the process group, the rank, the backend and
the rank's device.  The exchange's transport follows from the backend
and the device, never from a fallback:

- ``device`` (NCCL with CUDA tensors, one card a rank; gloo with CPU
  tensors): the collectives take the tensors as they are;
- ``host`` (gloo with CUDA tensors): the tensors are staged through
  page-locked host memory, since gloo takes CPU tensors only -- the one
  form that runs several ranks on one card (NCCL refuses two ranks on
  one device, and :func:`check_mesh` raises for it).

:func:`spawn` starts ``P`` local processes (the ``spawn`` start method)
that meet over a ``FileStore`` in a temporary directory, so no TCP port
is taken and parallel runs cannot collide::

    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import train_rank
    outs = spawn(4, train_rank, args=(tc, 4), device="cuda")  # one card
    outs = spawn(4, train_rank, args=(tc, 4), backend="nccl",
                 device="cuda")                      # one card a rank
    outs = spawn(2, train_rank, args=(tc, 2), device="cpu")  # gloo, CPU
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass
class PipeMesh:
    """One rank's view of the pipe axis."""
    group: Any                 # the process group of the P ranks
    rank: int
    P: int
    backend: str
    device: torch.device
    reduced_bytes: int = 0     # bytes this rank handed to all_reduce

    @property
    def staged(self) -> bool:
        """Do the collectives go through host memory (the ``host``
        transport: gloo handed CUDA tensors)?"""
        return self.backend == "gloo" and self.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce (``op`` "sum" or "max") of ``t`` over the
        ranks; under ``host`` through a host copy."""
        self.reduced_bytes += t.numel() * t.element_size()
        if not self.staged:
            dist.all_reduce(t, _OPS[op], group=self.group)
            return t
        h = t.cpu()
        dist.all_reduce(h, _OPS[op], group=self.group)
        return t.copy_(h)

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


def check_mesh(P: int, *, backend: str, device: str) -> None:
    """Raise on a request no run can honour: an unknown backend, fewer
    than 2 ranks, NCCL on the CPU, and NCCL with more ranks than cards
    (two ranks on one device), whose message names the ``host``
    transport (gloo)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{BACKENDS}")
    if P < 2:
        raise ValueError(f"a pipe mesh needs at least 2 ranks, got P={P}")
    if backend == "nccl":
        cuda = torch.device(device).type == "cuda"
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not cuda or n < P:
            raise RuntimeError(
                f"NCCL needs one card a rank: {P} ranks on {n} card(s) "
                "would put two ranks on one device, which NCCL refuses; "
                "run them with backend='gloo', whose exchange stages CUDA "
                "tensors through host memory (the host transport)")


def _rank_device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


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
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = PipeMesh(dist.group.WORLD, rank, P, backend, dev)
    mesh.all_reduce(torch.zeros((1,), device=dev))
    return mesh


def _child(rank, P, fn, args, backend, device, store_path, out_dir,
           timeout_s):
    """One spawned rank: join the mesh, run ``fn(mesh, *args)``, save its
    result (or the traceback) under ``out_dir``."""
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
        store = dist.FileStore(store_path, P)
        mesh = init_pipe_mesh(P, rank, backend, store, device=device,
                              timeout_s=timeout_s)
        res = fn(mesh, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(P: int, fn: Callable, *, args: Sequence = (),
          backend: str = "gloo", device: str = "cpu",
          timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``P`` local ranks and return their
    results in rank order.  ``fn`` and ``args`` cross by pickle (``fn``
    a module-level function); a result crosses through ``torch.save`` in
    the run's temporary directory, so keep it small (tensors on the
    CPU).  The mesh is checked first (:func:`check_mesh`); on a card the
    kernels are built here once, when ``nvcc`` is present, so the ranks
    only load the library.  The parent waits at most ``timeout_s`` in
    all: a rank that fails stops the others, and a hang ends in a kill;
    either raises RuntimeError with the failed ranks' tracebacks."""
    check_mesh(P, backend=backend, device=device)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        if build.find_nvcc() is not None:
            build.build()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        procs = [ctx.Process(target=_child, args=(
            r, P, fn, tuple(args), backend, device,
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
