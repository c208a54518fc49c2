"""Topology-independent checkpointing of torch trees in the reference's
on-disk format (port of ``repro/ft/checkpoint.py``; imports neither JAX
nor ``ml_dtypes``).

Layout, byte for byte the reference's:
    <dir>/step_<n>/manifest.json     tree paths + per-leaf metadata
    <dir>/step_<n>/leaf_<i>.bin      raw little-endian bytes per leaf
    <dir>/LATEST                     atomic pointer to the newest step

Leaves come in :func:`repro_torch.tree.tree_leaves` order (dict keys
sorted, lists in order: ``jax.tree.leaves``'s order) and each leaf's
``path`` is the string ``jax.tree_util.keystr`` gives it
(``['params']['blocks'][0]['attn']['wq']``), so each package restores
what the other wrote.  A bfloat16 leaf is written as the raw bytes of
its ``torch.uint16`` view under the dtype name ``"bfloat16"`` (the name
``ml_dtypes`` gives numpy's bfloat16) and read back the same way.  The
reference's per-leaf sharding ``spec`` is always ``null``: nothing is
sharded on one card.

Properties, as the reference's:
- **atomic**: writes land in ``tmp.<uuid>`` then a single ``os.rename``;
  LATEST is updated with write-to-temp + rename.
- **async**: ``save_async`` copies every leaf to host memory before it
  returns — the training drivers write the next step's masters into the
  same tensors, so a copy still in flight would checkpoint a later
  step — and writes in a background thread; ``wait()`` joins and
  re-raises a failed write.  A failed write never corrupts the previous
  checkpoint.
- **topology-independent**: leaves are stored whole with their shapes;
  :meth:`Checkpointer.restore` rebuilds each leaf from the manifest's
  shape and dtype (the elastic driver restores an old layout's blocks
  this way), :meth:`Checkpointer.restore_into` copies each leaf into a
  live tree of the same shapes, in place.

Host side: a card's leaves go through page-locked host buffers from
PyTorch's caching host allocator (a later save or restore of the same
shapes gets them back), and :data:`IO_THREADS` threads write or read the
leaf files at once (file I/O releases the interpreter lock).  On an
NVIDIA H100 80GB HBM3 (700 W) host, ``scripts/torch_host_io.py`` measured
device-to-host copies at 54 GB/s page-locked against 2.5 GB/s pageable,
and leaf files written at 12.3 GB/s from eight threads against 2.9 GB/s
from one.

Every save and restore appends a record to ``Checkpointer.records``:
its bytes, and the device-to-host and disk-write seconds of a save or
the disk-read and host-to-device seconds of a restore.

:class:`MeshCheckpointer` writes and restores the same format from the
ranks of a mesh, each holding parts of the leaves (:class:`LeafPart`):
each rank writes the elements it is the writer of into the pre-sized
leaf files through memory maps, rank 0 publishes, and each rank reads
back only its own parts.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

IO_THREADS = 8          # leaf files written or read concurrently
MESH_WAIT_S = 600.0     # a mesh rank's longest wait for the others' writes


# -- fault-injection seams (repro_torch.ft.inject) ---------------------------
# All leaf-file writes and all renames go through these module-level
# indirections so crash-consistency tests can kill the writer at an
# exact byte offset or between the tmp write and the atomic publish
# (monkeypatch ``_write_file`` / ``_rename``) without patching the
# global ``os`` module.  ``data`` is a flat byte buffer (a memoryview of
# the leaf's host copy: no ``bytes`` copy of a multi-GB leaf is made).

def _write_file(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _rename(src: str, dst: str) -> None:
    os.rename(src, dst)


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over ``tree``'s leaves, keeping its structure;
    ``path`` is ``jax.tree_util.keystr``'s string for the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, t, f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return fn(prefix, tree)


def _flatten(tree, prefix: str = ""):
    """[(path, leaf)] in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _bytes_of(t: torch.Tensor) -> memoryview:
    """Flat byte view of a contiguous host tensor (bf16 through uint16)."""
    arr = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    return memoryview(arr.reshape(-1)).cast("B")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t``, finished when it returns; a card's
    tensor lands in page-locked memory."""
    t = t.detach()
    if t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t)
    return t.to("cpu", memory_format=torch.contiguous_format, copy=True)


def _read_leaf(d: str, m: Dict, pin: bool) -> torch.Tensor:
    """One manifest leaf from disk as a host tensor of its dtype
    (page-locked with ``pin``)."""
    t = torch.empty(m["shape"], dtype=getattr(torch, m["dtype"]), pin_memory=pin)
    buf = _bytes_of(t)
    with open(os.path.join(d, m["file"]), "rb") as f:
        n = f.readinto(buf)
    if n != len(buf):
        raise OSError(f"{m['file']}: {n} bytes on disk, {len(buf)} expected")
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.records: List[Dict] = []

    # -- save --------------------------------------------------------------
    def _snapshot(self, step: int, tree: Any, mode: str):
        """Host copies of ``tree``'s leaves (finished before returning)
        and the save's record."""
        pairs = _flatten(tree)
        paths = [p for p, _ in pairs]
        cuda = any(x.is_cuda for _, x in pairs)
        t0 = time.perf_counter()
        host = [_host_copy(x) for _, x in pairs]
        if cuda:
            torch.cuda.synchronize()
        rec = {"op": "save", "mode": mode, "step": step,
               "bytes": sum(h.numel() * h.element_size() for h in host),
               "d2h_s": time.perf_counter() - t0 if cuda else 0.0,
               "write_s": None}
        self.records.append(rec)
        return paths, host, rec

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        self.wait()
        paths, host, rec = self._snapshot(step, tree, "sync")
        return self._write(step, paths, host, extra or {}, rec)

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        paths, host, rec = self._snapshot(step, tree, "async")

        def work():
            try:
                self._write(step, paths, host, extra or {}, rec)
            except BaseException as e:               # noqa: BLE001
                rec["error"] = repr(e)
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, paths, host, extra: Dict, rec) -> str:
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"tmp.{uuid.uuid4().hex}")
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra,
                    "leaves": [], "paths": paths}
        for i, (path, h) in enumerate(zip(paths, host)):
            manifest["leaves"].append({
                "path": path, "file": f"leaf_{i}.bin", "shape": list(h.shape),
                "dtype": str(h.dtype).removeprefix("torch."), "spec": None})
        with ThreadPoolExecutor(IO_THREADS) as ex:
            futs = [ex.submit(lambda m, h: _write_file(
                os.path.join(tmp, m["file"]), _bytes_of(h)), m, h)
                for m, h in zip(manifest["leaves"], host)]
            for f in futs:
                f.result()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        _rename(tmp, final)
        self._update_latest(step)
        self._gc()
        rec["write_s"] = time.perf_counter() - t0
        return final

    def _update_latest(self, step: int) -> None:
        tmp = os.path.join(self.dir, f".latest.{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        _rename(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        # a writer that died mid-write (or before its rename) leaves an
        # unpublished tmp dir / LATEST temp behind; they are garbage
        for d in os.listdir(self.dir):
            if d.startswith("tmp.") or d.startswith(".latest."):
                p = os.path.join(self.dir, d)
                (shutil.rmtree if os.path.isdir(p)
                 else os.remove)(p)

    # -- restore -----------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(path) as f:
            s = int(f.read().strip())
        return s if s in self.all_steps() else (
            self.all_steps()[-1] if self.all_steps() else None)

    def _manifest(self, step: Optional[int]):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return step, d, json.load(f)

    def read_extra(self, step: Optional[int] = None) -> Dict:
        """The ``extra`` dict of a checkpoint *without* reading leaves —
        the elastic driver peeks at the stored layout metadata here to
        decide whether a cross-topology migration is needed."""
        return self._manifest(step)[2]["extra"]

    def _restore(self, template, step, place, target):
        """Read every leaf of checkpoint ``step`` that ``template`` names
        (``IO_THREADS`` files at once; page-locked where ``target(leaf)``
        is a card), then ``place(path, leaf, host)`` each in order."""
        step, d, manifest = self._manifest(step)
        by_path = {m["path"]: m for m in manifest["leaves"]}
        pairs = _flatten(template)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(IO_THREADS) as ex:
            host = list(ex.map(
                lambda px: _read_leaf(d, by_path[px[0]],
                                      target(px[1]).type == "cuda"), pairs))
        t1 = time.perf_counter()
        out = {p: place(p, x, h) for (p, x), h in zip(pairs, host)}
        if any(target(x).type == "cuda" for _, x in pairs):
            torch.cuda.synchronize()
        self.records.append({
            "op": "restore", "step": step,
            "bytes": sum(h.numel() * h.element_size() for h in host),
            "read_s": t1 - t0, "h2d_s": time.perf_counter() - t1})
        return _map_with_path(lambda p, x: out[p], template), \
            manifest["extra"]

    def restore(self, template: Any, step: Optional[int] = None,
                device=None):
        """Restore into the structure of ``template``: each leaf is
        rebuilt from the manifest's shape and dtype (which may differ
        from the template leaf's: an old layout's blocks) on ``device``,
        or on the template leaf's device.  Returns ``(tree, extra)``."""
        def target(leaf):
            return torch.device(leaf.device if device is None else device)
        return self._restore(template, step,
                             lambda p, leaf, h: h.to(target(leaf)), target)

    def restore_into(self, tree: Any, step: Optional[int] = None) -> Dict:
        """Copy the checkpoint into ``tree``'s tensors in place (views of
        them, e.g. an offload runner's, stay valid).  Raises ValueError
        where a leaf's shape or dtype differs from the checkpoint's.
        Returns ``extra``."""
        def place(path, leaf, host):
            if leaf.shape != host.shape or leaf.dtype != host.dtype:
                raise ValueError(
                    f"{path}: checkpoint holds {host.dtype} "
                    f"{tuple(host.shape)}, the tree {leaf.dtype} "
                    f"{tuple(leaf.shape)}")
            with torch.no_grad():
                leaf.copy_(host)
            return leaf
        return self._restore(tree, step, place, lambda leaf: leaf.device)[1]


# -- checkpoints written and restored by the ranks of a mesh -----------------

@dataclass(frozen=True)
class LeafPart:
    """A rank's part of a checkpoint leaf: the global leaf's ``shape``,
    where the rank's tensor lies in it (``index``: an int or a slice a
    leading dimension, the rank's tensor filling the rest), and whether
    the rank writes it (``writes``: of the ranks holding the same
    elements exactly one does)."""
    shape: Tuple[int, ...]
    index: Tuple[Any, ...]
    writes: bool


_NP = {torch.bfloat16: np.uint16, torch.float32: np.float32,
       torch.float16: np.float16, torch.int32: np.int32,
       torch.int64: np.int64, torch.int8: np.int8, torch.int16: np.int16,
       torch.uint8: np.uint8, torch.bool: np.bool_}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's numpy view (bf16 as its uint16 bits)."""
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def _open_leaf(path: str, dtype: torch.dtype, shape, mode: str):
    """A leaf file as a numpy memory map of its global ``shape`` (``mode``
    "r+" to write, "r" to read)."""
    return np.memmap(path, dtype=_NP[dtype], mode=mode, shape=tuple(shape))


def _read_part(path: str, dtype: torch.dtype, shape, index) -> np.ndarray:
    """The elements of one leaf file at ``index``, copied out of a memory
    map of it: only those pages are read (a seam the tests wrap to see
    what each rank reads)."""
    if math.prod(shape) == 0:
        return np.zeros(shape, _NP[dtype])[index]
    return np.array(_open_leaf(path, dtype, shape, "r")[index])


def _wait_for(paths, what: str, fail=()) -> None:
    """Poll until every path of ``paths`` exists; raise where one of
    ``fail`` appears (another rank's write failed) or after
    :data:`MESH_WAIT_S`."""
    t0 = time.monotonic()
    while True:
        bad = [f for f in fail if os.path.exists(f)]
        if bad:
            raise RuntimeError(f"{what}: a rank's write failed "
                               f"({', '.join(map(os.path.basename, bad))})")
        if all(os.path.exists(p) for p in paths):
            return
        if time.monotonic() - t0 > MESH_WAIT_S:
            raise TimeoutError(f"{what}: waited {MESH_WAIT_S:.0f} s")
        time.sleep(0.005)


class MeshCheckpointer(Checkpointer):
    """The checkpointer of one rank of a mesh (``rank`` of ``size``
    processes), in the reference's format: every leaf stored whole, at
    its global shape, its ``spec`` null, as one device writes it.  The
    tree a rank hands in holds its own tensors, and ``parts`` (a tree of
    the same structure) says where each lies in its global leaf
    (:class:`LeafPart`).

    A save: each rank copies the parts it writes to host memory (before
    the call returns, as :meth:`Checkpointer.save_async`), then writes
    them into the leaf files of ``tmp.<token>.<n>`` (created at their
    global size by the first writer; disjoint elements, so the ranks
    write at once) through memory maps, and leaves a ``done.<rank>``
    marker; rank 0 waits for every marker, then writes the manifest,
    renames the directory to ``step_<n>``, updates LATEST and collects
    old steps, as :class:`Checkpointer` does.  No collective is needed,
    so an asynchronous save's writes run beside the next steps' own
    collectives.  A rank whose write fails leaves ``error.<rank>``
    instead, and rank 0 publishes nothing: the previous checkpoint
    stands.  A synchronous save returns on every rank once rank 0 has
    published.  ``token`` names this run's temporary directories; every
    rank must hold the same one (rank 0's, broadcast), and every rank
    makes the same saves in the same order.

    The directory must lie on a filesystem every rank sees, with memory
    maps coherent between the processes (one host: the ranks of
    :func:`repro_torch.launch.mesh.spawn`).

    :meth:`restore_into` reads only the rank's parts of each leaf file,
    from a memory map of it (:func:`_read_part`), never a whole leaf, and
    copies them into the rank's tensors in place; restoring onto another
    mesh (another ``dp x tp`` of the same pipeline) is the same read with
    that mesh's parts, as the reference's ``reshard``
    (``src/repro/ft/elastic.py:108-112``) places the whole leaves on new
    shardings."""

    def __init__(self, directory: str, keep: int = 3, *, rank: int = 0,
                 size: int = 1, token: str = "mesh"):
        super().__init__(directory, keep)
        self.rank, self.size, self.token = rank, size, token
        self._saves = 0

    # -- save --------------------------------------------------------------
    def _mesh_snapshot(self, step: int, tree, parts, mode: str):
        pairs = _flatten(tree)
        where = [p for _, p in _flatten(parts)]
        assert len(where) == len(pairs), "parts != tree"
        cuda = any(x.is_cuda for _, x in pairs)
        t0 = time.perf_counter()
        host = [_host_copy(x) if w.writes else None
                for (_, x), w in zip(pairs, where)]
        if cuda:
            torch.cuda.synchronize()
        leaves = [{"path": p, "file": f"leaf_{i}.bin", "shape": list(w.shape),
                   "dtype": str(x.dtype).removeprefix("torch."),
                   "spec": None}
                  for i, ((p, x), w) in enumerate(zip(pairs, where))]
        rec = {"op": "save", "mode": mode, "step": step, "rank": self.rank,
               "bytes": sum(h.numel() * h.element_size()
                            for h in host if h is not None),
               "d2h_s": time.perf_counter() - t0 if cuda else 0.0,
               "write_s": None}
        self.records.append(rec)
        self._saves += 1
        tmp = os.path.join(self.dir, f"tmp.{self.token}.{self._saves:06d}")
        return (leaves, [p for p, _ in pairs], where, host, tmp), rec

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             parts: Any = None) -> str:
        self.wait()
        job, rec = self._mesh_snapshot(step, tree, parts, "sync")
        final = self._mesh_write(step, job, extra or {}, rec)
        if self.rank != 0:
            # returns once rank 0 has published the step
            t0 = time.monotonic()
            while os.path.exists(job[4]) or self.latest_step() != step:
                if os.path.exists(os.path.join(job[4], "error.0")) or \
                        time.monotonic() - t0 > MESH_WAIT_S:
                    raise RuntimeError(f"step {step} was not published")
                time.sleep(0.005)
        return final

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None, parts: Any = None) -> None:
        self.wait()
        job, rec = self._mesh_snapshot(step, tree, parts, "async")

        def work():
            try:
                self._mesh_write(step, job, extra or {}, rec)
            except BaseException as e:               # noqa: BLE001
                rec["error"] = repr(e)
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _mesh_write(self, step: int, job, extra: Dict, rec) -> str:
        leaves, paths, where, host, tmp = job
        t0 = time.perf_counter()
        os.makedirs(tmp, exist_ok=True)
        try:
            with ThreadPoolExecutor(IO_THREADS) as ex:
                for f in [ex.submit(self._write_part, tmp, m, w, h)
                          for m, w, h in zip(leaves, where, host)
                          if h is not None]:
                    f.result()
        except BaseException:
            with open(os.path.join(tmp, f"error.{self.rank}"), "w"):
                pass
            raise
        with open(os.path.join(tmp, f"done.{self.rank}"), "w"):
            pass
        final = os.path.join(self.dir, f"step_{step:08d}")
        if self.rank == 0:
            try:
                self._publish(step, tmp, final, leaves, paths, extra)
            except BaseException:
                with open(os.path.join(tmp, "error.0"), "w"):
                    pass
                raise
        rec["write_s"] = time.perf_counter() - t0
        return final

    def _publish(self, step, tmp, final, leaves, paths, extra) -> None:
        """Rank 0: once every rank's marker is there, the manifest, the
        rename, LATEST and the collection of old steps."""
        _wait_for([os.path.join(tmp, f"done.{r}")
                   for r in range(self.size)], f"step {step}",
                  [os.path.join(tmp, f"error.{r}")
                   for r in range(self.size)])
        for m in leaves:      # a leaf of no elements has no writer
            path = os.path.join(tmp, m["file"])
            if not os.path.exists(path):
                open(path, "wb").close()
        for r in range(self.size):
            os.remove(os.path.join(tmp, f"done.{r}"))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "extra": extra, "leaves": leaves,
                       "paths": paths}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        _rename(tmp, final)
        self._update_latest(step)
        self._gc()

    @staticmethod
    def _write_part(tmp: str, m: Dict, where: LeafPart, h: torch.Tensor):
        """The rank's part ``h`` into its place in the leaf file (created,
        or grown, to the global leaf's bytes first), through a memory map
        of it."""
        n = math.prod(where.shape) * h.element_size()
        if n == 0:
            return
        path = os.path.join(tmp, m["file"])
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            if os.fstat(fd).st_size < n:
                os.ftruncate(fd, n)
        finally:
            os.close(fd)
        mm = _open_leaf(path, h.dtype, where.shape, "r+")
        mm[where.index] = _numpy(h)
        mm.flush()
        del mm

    def _gc(self) -> None:
        # another incarnation's unpublished directories only: this run's
        # later saves may be in flight on the other ranks
        mine = f"tmp.{self.token}."
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        for d in os.listdir(self.dir):
            if (d.startswith("tmp.") and not d.startswith(mine)) \
                    or d.startswith(".latest."):
                p = os.path.join(self.dir, d)
                (shutil.rmtree if os.path.isdir(p) else os.remove)(p)

    # -- restore -----------------------------------------------------------
    def restore_into(self, tree: Any, step: Optional[int] = None,
                     parts: Any = None) -> Dict:
        """Copy the rank's parts of checkpoint ``step`` (the latest) into
        ``tree``'s tensors in place: each read from a memory map of its
        leaf file at the part's place (:func:`_read_part`).  Raises
        ValueError where a leaf's global shape or dtype differs from the
        checkpoint's.  Returns ``extra``."""
        step, d, manifest = self._manifest(step)
        by_path = {m["path"]: m for m in manifest["leaves"]}
        pairs = _flatten(tree)
        where = [p for _, p in _flatten(parts)]
        assert len(where) == len(pairs), "parts != tree"

        def read(px):
            (path, x), w = px
            m = by_path[path]
            if list(m["shape"]) != list(w.shape) or \
                    getattr(torch, m["dtype"]) != x.dtype:
                raise ValueError(
                    f"{path}: checkpoint holds {m['dtype']} "
                    f"{tuple(m['shape'])}, the tree {x.dtype} "
                    f"{tuple(w.shape)}")
            a = _read_part(os.path.join(d, m["file"]), x.dtype, w.shape,
                           w.index)
            h = torch.from_numpy(a)
            return h.view(torch.bfloat16) if x.dtype == torch.bfloat16 \
                else h
        t0 = time.perf_counter()
        with ThreadPoolExecutor(IO_THREADS) as ex:
            host = list(ex.map(read, zip(pairs, where)))
        t1 = time.perf_counter()
        cuda = False
        with torch.no_grad():
            for (path, x), h in zip(pairs, host):
                if tuple(h.shape) != tuple(x.shape):
                    raise ValueError(f"{path}: the rank's part is "
                                     f"{tuple(h.shape)}, its tensor "
                                     f"{tuple(x.shape)}")
                x.copy_(h)
                cuda = cuda or x.is_cuda
        if cuda:
            torch.cuda.synchronize()
        self.records.append({
            "op": "restore", "step": step, "rank": self.rank,
            "bytes": sum(h.numel() * h.element_size() for h in host),
            "read_s": t1 - t0, "h2d_s": time.perf_counter() - t1})
        return manifest["extra"]
