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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

IO_THREADS = 8          # leaf files written or read concurrently


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
