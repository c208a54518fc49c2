"""Chronos-Offload: the host optimizer of the *deepest* chunks (port of
``repro/optim/offload.py``).

The paper's §5.1: deep-layer weights have the worst temporal locality
(updated first in backward, needed last in forward), so their optimizer
step runs on the host: gradients down over PCIe, AdamW on the host
CPU, bf16 weights back up.  The device keeps only the bf16 weights of
the offloaded chunks (and their gradients while a step runs), not
their fp32 master and moments.

- :class:`HostAdamW` holds the fp32 master, mu and nu as plain numpy
  arrays in host memory and runs the reference's numpy update, in the
  reference's operation order, split into contiguous slabs over a
  fixed thread pool (numpy drops the interpreter lock; the update is
  elementwise, so any split gives the same bits).  numpy, not torch:
  torch's CPU ``sqrt`` on fp32 can differ from numpy's in the last bit.
- :class:`ChronosOffloadRunner` moves the data.  ``submit`` copies each
  deep gradient leaf, in its own dtype (or, under gradient compression,
  as int8 / int16 codes and a scale), into a pinned host buffer on a
  side stream ordered after the compute stream, then starts the host
  update in a thread that first waits for that copy.  ``collect`` joins
  the thread and uploads the bf16 weights from a pinned staging buffer
  into the device parameters' deep views, in place; the compute stream
  waits for that upload.
- :func:`split_deep_shallow` returns views along the chunk axis of the
  ``[P, v, M, ...]`` block leaves; :func:`merge_deep_shallow` can write
  the two parts back into the full leaves in place.

On the CPU (the tests) the same path runs with plain host buffers and
synchronous copies.
"""
from __future__ import annotations

import math
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.schedules import lr_at
from repro_torch.tree import tree_leaves, tree_map

SLAB = 1 << 18          # elements per host work item: 1 MiB of each fp32 array


def _host_f32(a) -> np.ndarray:
    """A host leaf (or a slab of one) as fp32 numpy: a numpy array as it
    is, a CPU tensor's storage seen by numpy, a bf16 tensor widened
    exactly (its 16 bits shifted into the top of an fp32)."""
    if not isinstance(a, torch.Tensor):
        return a
    if a.dtype == torch.bfloat16:
        u = a.view(torch.int16).numpy().view(np.uint16)
        return (u.astype(np.uint32) << 16).view(np.float32)
    return a.numpy()


def _to_host_f32(a) -> np.ndarray:
    """A fresh contiguous fp32 numpy copy of a leaf on any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().float().contiguous().numpy()
    return np.array(a, np.float32, copy=True)


def host_threads(ranks_on_host: int = 1) -> int:
    """The host update's workers for one of ``ranks_on_host`` processes
    that share the host's CPUs: ``os.cpu_count() // ranks_on_host`` (at
    least 1)."""
    return max(1, (os.cpu_count() or 1) // max(ranks_on_host, 1))


class _HostBuffers:
    """The runner's host buffers: one flat buffer a (role, dtype), grown
    on demand, page-locked where the runner's device is a card.  One set
    a process (:data:`_HOST`), handed to one open runner at a time: the
    caching host allocator keeps every freed page-locked block (rounded
    to a power of two), so buffers of each runner's own would pin the
    largest shipment of every run a process makes.  A runner opened
    while another holds the set gets a set of its own.
    :func:`release_host_buffers` drops the process's set (then torch's
    host cache can return it to the system)."""

    def __init__(self):
        self.bufs: Dict[tuple, torch.Tensor] = {}
        self.owner = None          # a weak reference to the open runner

    def acquire(self, runner) -> bool:
        """Hand the set to ``runner``: False while another runner holds
        it."""
        held = self.owner() if self.owner is not None else None
        if held is not None and held is not runner:
            return False
        self.owner = weakref.ref(runner)
        return True

    def release(self, runner) -> None:
        if self.owner is not None and self.owner() is runner:
            self.owner = None

    def views(self, role: str, shapes, dtypes, pin: bool) -> List:
        """Contiguous tensors of ``shapes`` and ``dtypes``, cut from the
        role's flat buffer of each dtype."""
        need: Dict[torch.dtype, int] = {}
        for sh, dt in zip(shapes, dtypes):
            need[dt] = need.get(dt, 0) + math.prod(sh)
        flat = {}
        for dt, n in need.items():
            key = (role, dt, pin)
            buf = self.bufs.get(key)
            if buf is None or buf.numel() < n:
                buf = torch.empty(n, dtype=dt, pin_memory=pin)
                self.bufs[key] = buf
            flat[dt] = buf
        off = {dt: 0 for dt in need}
        out = []
        for sh, dt in zip(shapes, dtypes):
            n = math.prod(sh)
            out.append(flat[dt][off[dt]:off[dt] + n].view(sh))
            off[dt] += n
        return out


_HOST = _HostBuffers()


def release_host_buffers() -> int:
    """Drop this process's set of the offload runner's host buffers
    (kept while an open runner holds it); returns the bytes dropped."""
    if _HOST.owner is not None and _HOST.owner() is not None:
        return 0
    n = sum(b.numel() * b.element_size() for b in _HOST.bufs.values())
    _HOST.bufs.clear()
    return n


class HostAdamW:
    """Numpy AdamW over a tree of host-resident fp32 states (fp32 master,
    mu, nu as plain numpy arrays), on ``threads`` workers (default: every
    CPU of the host).  Where several processes share the host (the ranks
    of a mesh on one machine), each should take its share,
    :func:`host_threads` of their number: every CPU each would run the
    host's update that many times over."""

    def __init__(self, params_subset, cfg: OptimizerConfig, *,
                 threads: Optional[int] = None):
        self.cfg = cfg
        self.step = 0
        self.master = tree_map(_to_host_f32, params_subset)
        self.mu = tree_map(np.zeros_like, self.master)
        self.nu = tree_map(np.zeros_like, self.master)
        self.threads = threads or os.cpu_count() or 1
        self._pool = ThreadPoolExecutor(self.threads,
                                        thread_name_prefix="host-adamw") \
            if self.threads > 1 else None

    def update(self, grads_host, clip_coef: float = 1.0,
               grad_div: Optional[float] = None, scales=None) -> Any:
        """``grads_host``: a tree of numpy fp32 arrays or CPU tensors (fp32
        or bf16, widened exactly).  With ``grad_div`` each gradient is
        first divided by it in fp32, the reference's device-side
        ``g.astype(f32) / m``.  With ``scales`` (one fp32 scale per leaf,
        in ``tree_leaves`` order) the leaves are int8 or int16 codes of a
        quantized shipment, dequantized slab by slab as ``codes * scale``
        in fp32 (bitwise the reference's ``dequantize_int8``).  Updates
        the state in place and returns the master tree (numpy fp32; the
        caller casts on upload)."""
        cfg = self.cfg
        self.step += 1
        lr = float(lr_at(cfg, self.step))
        b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
        bc1 = 1 - b1 ** self.step
        bc2 = 1 - b2 ** self.step
        div = None if grad_div is None else np.float32(grad_div)

        def upd(g, mu, nu, w, scale=None):
            if scale is None:
                g = np.array(_host_f32(g), np.float32, copy=True)
            else:
                g = _host_f32(g).astype(np.float32) * scale
            if div is not None:
                g /= div
            g *= clip_coef
            mu *= b1
            mu += (1 - b1) * g
            nu *= b2
            nu += (1 - b2) * np.square(g)
            step_ = (mu / bc1) / (np.sqrt(nu / bc2) + eps)
            step_ += cfg.weight_decay * w
            w -= lr * step_

        leaves = list(zip(*([a.reshape(-1) for a in tree_leaves(t)] for t in
                            (grads_host, self.mu, self.nu, self.master))))
        items = [(i, a, min(a + SLAB, len(flat[3])))
                 for i, flat in enumerate(leaves)
                 for a in range(0, len(flat[3]), SLAB)]

        sc = None if scales is None else np.asarray(scales, np.float32)

        def run(item):
            i, a, b = item
            upd(*(x[a:b] for x in leaves[i]),
                scale=None if sc is None else sc[i])

        if self._pool is None:
            for item in items:
                run(item)
        else:
            for f in [self._pool.submit(run, item) for item in items]:
                f.result()
        return self.master

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class ChronosOffloadRunner:
    """Asynchronous deep-chunk optimizer: offload -> host update ->
    upload.  ``deep_params``: the device parameters' deep views
    (:func:`split_deep_shallow`), which ``collect`` overwrites in place.

    Usage per step, as the reference's driver runs it:
        runner.submit(deep_grads, grad_div=m)   # after the step
        ...
        runner.collect()                        # before the next step

    With ``ship_bits`` (8 or 16: ``plan.grad_compression``) the shipment
    is quantized (:func:`repro_torch.launch.steps.ship_deep`): ``submit``
    takes the int8 / int16 codes and their per-leaf scales, copies both
    into pinned buffers of that width (half or the same bytes as a bf16
    shipment) and the host update dequantizes inside its slab workers.
    The reference dequantizes on the device before the copy, so its copy
    moves fp32; the numbers are the same.

    ``stats``: ``submits`` and ``overlapped`` (the host update had ended
    when ``collect`` came).  :meth:`measured` gives the host update's
    seconds and, on a card, the copies' times from CUDA events.

    ``threads``: the host update's workers (:class:`HostAdamW`; a rank of
    a mesh that shares its host passes :func:`host_threads`).  The host
    buffers are the process's one set (:data:`_HOST`) while no other
    runner holds it, and :func:`release_host_buffers` frees them once
    the runner is closed.

    On a mesh rank ``deep_params`` are the rank's parts of the deep
    leaves (their ZeRO slices of its tp shards), and the shipment the
    same parts of the gradients: the host holds the master, mu and nu of
    those slices only; the update is elementwise, so a slice gets the
    bits the same slice of the whole leaf gets."""

    def __init__(self, deep_params, cfg: OptimizerConfig,
                 target_dtype=torch.bfloat16, ship_bits: Optional[int] = None,
                 threads: Optional[int] = None):
        self.deep = deep_params
        self.ship_bits = ship_bits
        dev = tree_leaves(deep_params)[0].device
        self.device = dev
        self.cuda = dev.type == "cuda"
        self._bufs = _HOST if _HOST.acquire(self) else _HostBuffers()
        self.opt = HostAdamW(deep_params, cfg, threads=threads)
        # host buffers (page-locked on a card), the process's one set
        # (_HOST): the gradients in their own dtype (or the shipment's
        # codes and per-leaf scales), cut at the first submit; the upload
        # in the target dtype
        self._ship = None if ship_bits is None else \
            (torch.int8 if ship_bits <= 8 else torch.int16)
        self._grads = None
        shapes = [tuple(a.shape) for a in tree_leaves(deep_params)]
        self._scales = None if self._ship is None else self._bufs.views(
            "scales", [(len(shapes),)], [torch.float32], self.cuda)[0]
        self._staging = self._bufs.views("staging", shapes,
                                    [target_dtype] * len(shapes), self.cuda)
        self._side = torch.cuda.Stream(dev) if self.cuda else None
        self._uploaded: Optional[torch.cuda.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.stats: Dict[str, float] = {"submits": 0, "overlapped": 0}
        self.host_s: List[float] = []          # host update, per submit
        self._down: List[tuple] = []           # (start, end) CUDA events
        self._up: List[tuple] = []
        self.bytes_up = sum(a.numel() * a.element_size()
                            for a in self._staging)

    @property
    def bytes_down(self) -> int:
        """The shipment's bytes: its buffers as the first submit cut them
        (before it, at the deep weights' dtype or the codes' width)."""
        if self._grads is not None:
            n = sum(a.numel() * a.element_size() for a in self._grads)
        else:
            n = sum(a.numel() * (a.element_size() if self._ship is None
                                 else self._ship.itemsize)
                    for a in tree_leaves(self.deep))
        return n + (0 if self._scales is None else 4 * self._scales.numel())

    def _events(self):
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def submit(self, deep_grads, clip_coef: float = 1.0,
               grad_div: Optional[float] = None, scales=None) -> None:
        """Copy ``deep_grads`` (device leaves shaped as ``deep_params``)
        down and start the host update; ``grad_div`` divides each
        gradient on the host (the step's ``m``).  A quantized shipment
        (``ship_bits``) passes its codes as ``deep_grads`` and their
        scales (a tree of 0-d fp32 device tensors) as ``scales``."""
        if self._thread is not None:
            raise RuntimeError("previous offload not collected")
        if (scales is None) != (self.ship_bits is None):
            raise ValueError("a quantized shipment needs its scales, and "
                             "only it takes them")
        grads = tree_leaves(deep_grads)
        dtypes = [self._ship or g.dtype for g in grads]
        if self._grads is None or [b.dtype for b in self._grads] != dtypes:
            # the shipment's own dtypes: a ZeRO-3 rank ships fp32 slices
            self._grads = self._bufs.views("grads", [tuple(g.shape)
                                                for g in grads],
                                      dtypes, self.cuda)
        bufs = self._grads
        sc = None if scales is None else torch.stack(tree_leaves(scales))
        copied = None
        with torch.no_grad():
            if self.cuda:
                compute = torch.cuda.current_stream(self.device)
                copied = self._events()
                with torch.cuda.stream(self._side):
                    self._side.wait_stream(compute)
                    copied[0].record(self._side)
                    for buf, g in zip(bufs, grads):
                        for i in range(g.shape[0]):   # contiguous rows
                            buf[i].copy_(g[i], non_blocking=True)
                        # the step's accumulators go back to the
                        # allocator when the caller drops them: keep
                        # them until this stream has read them
                        g.record_stream(self._side)
                    if sc is not None:
                        self._scales.copy_(sc, non_blocking=True)
                        sc.record_stream(self._side)
                    copied[1].record(self._side)
                self._down.append(copied)
            else:
                for buf, g in zip(bufs, grads):
                    buf.copy_(g)
                if sc is not None:
                    self._scales.copy_(sc)
        uploaded = self._uploaded

        def work():
            try:
                if copied is not None:
                    copied[1].synchronize()
                t0 = time.perf_counter()
                master = self.opt.update(
                    self._grads, clip_coef, grad_div,
                    scales=None if sc is None else self._scales.numpy())
                if uploaded is not None:
                    uploaded.synchronize()      # staging read by the card
                for st, w in zip(self._staging, tree_leaves(master)):
                    st.copy_(torch.from_numpy(w))   # round to nearest even
                self.host_s.append(time.perf_counter() - t0)
            except Exception as e:                        # noqa: BLE001
                self._error = e         # raised again by collect()

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="chronos-offload")
        self._thread.start()
        self.stats["submits"] += 1

    def collect(self):
        """Join the host update and upload its bf16 weights into the
        device's deep views (the compute stream waits for the upload).
        Returns ``deep_params``."""
        if self._thread is None:
            raise RuntimeError("collect() without a submit()")
        busy_before = self._thread.is_alive()
        self._thread.join()
        self._thread = None
        if not busy_before:
            self.stats["overlapped"] += 1
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        dst = tree_leaves(self.deep)
        with torch.no_grad():
            if self.cuda:
                compute = torch.cuda.current_stream(self.device)
                ev = self._events()
                with torch.cuda.stream(self._side):
                    self._side.wait_stream(compute)   # last reads done
                    ev[0].record(self._side)
                    for w, st in zip(dst, self._staging):
                        for i in range(w.shape[0]):
                            w[i].copy_(st[i], non_blocking=True)
                    ev[1].record(self._side)
                compute.wait_stream(self._side)
                self._up.append(ev)
                self._uploaded = ev[1]
            else:
                for w, st in zip(dst, self._staging):
                    w.copy_(st)
        return self.deep

    def measured(self) -> Dict[str, Any]:
        """Host update seconds per submit, and on a card the copy-down
        and upload milliseconds per step (CUDA events on the side stream)
        with their GB/s over ``bytes_down`` / ``bytes_up``."""
        out: Dict[str, Any] = {"host_update_s": list(self.host_s),
                               "bytes_down": self.bytes_down,
                               "bytes_up": self.bytes_up}
        if not self.cuda:
            return out
        torch.cuda.synchronize(self.device)
        for key, evs, n in (("copy_down", self._down, self.bytes_down),
                            ("upload", self._up, self.bytes_up)):
            ms = [a.elapsed_time(b) for a, b in evs]
            out[f"{key}_ms"] = ms
            out[f"{key}_gbps"] = [n / (t * 1e6) for t in ms if t > 0]
        return out

    def close(self) -> None:
        """Wait for a host update still running, then stop the pool."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.opt.close()
        _HOST.release(self)


def split_deep_shallow(blocks_grads_or_params, v: int,
                       num_offload_chunks: int, axis: int = 1):
    """Split stacked block trees along the chunk axis into (shallow,
    deep) views.  Deep = last ``num_offload_chunks``.  ``axis``: the
    chunk axis, 1 for the whole tree's ``[P, v, M, ...]`` leaves, 0 for
    a mesh rank's column ``[v, M, ...]``."""
    cut = v - num_offload_chunks
    lead = (slice(None),) * axis
    return (tree_map(lambda a: a[lead + (slice(None, cut),)],
                     blocks_grads_or_params),
            tree_map(lambda a: a[lead + (slice(cut, None),)],
                     blocks_grads_or_params))


def _same_view(a, b) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def merge_deep_shallow(shallow_tree, deep_tree, *, out=None):
    """The full leaves: concatenated along axis 1, as the reference; or,
    with ``out`` (the full tree), the two parts written into ``out`` in
    place (a part that already is that view of ``out`` is not copied)
    and ``out`` returned: no second copy of the weights."""
    if out is None:
        return tree_map(lambda s, d: torch.cat([s, d], dim=1),
                        shallow_tree, deep_tree)

    def put(s, d, o):
        cut = s.shape[1]
        for part, dst in ((s, o[:, :cut]), (d, o[:, cut:])):
            if not _same_view(part, dst):
                dst.copy_(part)

    with torch.no_grad():
        tree_map(put, shallow_tree, deep_tree, out)
    return out
