"""Roofline terms of the port's steps on one NVIDIA H100 (counterpart of
``repro/roofline/analysis.py``).

    compute term    = flops / (chips * peak_flops)
    memory term     = bytes / (chips * hbm_bw)
    collective term = collective_bytes / (chips * link_bw)

The reference reads its work from the partitioned HLO (``analyze_hlo``).
There is no HLO here: the work is counted while the step runs, by
:func:`count_work`, a dispatch mode over the aten ops it executes:

- **flops**: matrix-product FLOPs, ``2 * M * N * K`` for every ``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` (what ``linear``, ``matmul`` and
  ``einsum`` lower to), as the reference counts ``dot`` FLOPs; an op
  that multiplies matrices by a rule this module does not know (a
  convolution, a library attention) raises;
- **bytes**: every executed op's input and output bytes, each once
  (``copy_``, ``fill_`` and ``zero_`` only write their first argument),
  except the ops that move nothing (:data:`NO_TRAFFIC` and every view:
  reshapes, transposes, expands, slices, bookkeeping), as the reference
  leaves out its ``NO_TRAFFIC`` kinds; ``[.., S, S]`` score-class
  tensors (both trailing dims >= 1024) are counted apart
  (``score_bytes``), as ``bytes_traffic_raw`` / ``score_bytes`` are.
  The port's plain attention backward really moves them on the card,
  so the roofline's memory term reads the raw bytes.
- **kernels**: a kernel wrapper (``rmsnorm_rows``,
  ``flash_attention_fwd``, ``fused_adamw_flat``, ``ssd_scan``) is
  counted once a call by :func:`kernel_cost`, the work of the function
  it computes, whatever implements it: on the card the kernel's launch
  is a ``ctypes`` call no dispatch mode sees, and on the CPU the plain
  version's ops are hidden.  So one step counts the same on the CPU, on
  the meta device and on the card.  The products of flash and of the
  SSD scan join ``flops``; the optimizer's 16 operations an element are
  vector work, recorded under ``kernels`` and kept out of ``flops``, as
  the reference's dot count keeps elementwise work out.

The peaks are an H100 SXM's (:data:`PEAK_FLOPS`, :data:`HBM_BW`,
:data:`LINK_BW`); :class:`Roofline` takes them as fields, so the
reference's TPU peaks give the reference's terms.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12        # H100 SXM, dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12    # H100 SXM, fp32 outside the tensor cores
HBM_BW = 3.35e12           # H100 SXM, HBM3 bytes/s
# NVLink 4 on the H100 SXM: 18 links of 25 GB/s each way, 450 GB/s a
# direction (NVIDIA's H100 datasheet gives 900 GB/s, both directions)
LINK_BW = 450e9


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    #: on a ``pp x dp x tp`` mesh: the bytes handed to collectives by
    #: mesh axis ("pp", "data", "model"), scalars included, summed over
    #: the ranks (what the ranks' counters read); empty otherwise
    by_axis: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclass
class Roofline:
    flops: float                  # per device
    bytes_hbm: float              # per device
    collective_bytes: float       # per-device-sum x chips
    chips: int
    model_flops: float = 0.0      # 6*N*D useful flops (global)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """model_flops / (counted flops x chips): < 1 means recompute,
        redundancy or work the 6*N*D count leaves out (attention)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful compute time over the binding term."""
        t_useful = (self.model_flops / self.chips) / self.peak_flops
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / bound if bound else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.bytes_hbm,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def cost_to_roofline(count: "WorkCount", collectives: CollectiveStats,
                     chips: int, model_flops: float) -> Roofline:
    """A counted step's roofline on ``chips`` cards (the port: one; the
    reference builds it from ``cost_analysis()``), the raw bytes
    (score-class tensors in) in the memory term."""
    return Roofline(flops=count.flops, bytes_hbm=count.bytes_traffic_raw,
                    collective_bytes=collectives.total_bytes * chips,
                    chips=chips, model_flops=model_flops)


def model_flops_for(cfg, shape, kind: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for training; 2*N*D for
    inference forward."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def mfu(model_flops: float, seconds: float,
        peak: float = PEAK_FLOPS) -> float:
    """Model FLOPs utilization: ``model_flops`` done in ``seconds`` over
    what the card's ``peak`` would do in that time."""
    return model_flops / (seconds * peak)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS,
             hbm_bw: float = HBM_BW) -> Tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the least time the card takes for
    ``flops`` at ``peak`` and ``nbytes`` at ``hbm_bw``, and which binds."""
    terms = {"bytes": nbytes / hbm_bw * 1e3, "operations": flops / peak * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


# ---------------------------------------------------------------------------
# each kernel's work, by the function it computes
# ---------------------------------------------------------------------------

ADAMW_STATE_BYTES = 24     # mu, nu and the fp32 master read and written
ADAMW_FLOPS = 16           # operations an element, csrc/fused_adamw.cu
# kernels whose operations are matrix products (they join ``flops``)
PRODUCT_KERNELS = ("flash_attention_fwd", "ssd_scan")


@functools.lru_cache(maxsize=4096)
def visible_pairs(Sq: int, Sk: int, *, causal: bool = True, window: int = 0,
                  prefix: int = 0, q_offset: int = 0) -> Tuple[int, int]:
    """``(pairs, kv_rows)`` of one (batch, head) under ``attention_ref``'s
    mask: query row i at position ``q_offset + i`` sees key k when
    ``(k <= q or not causal or k < prefix) and (not window or q - k <
    window)``; ``kv_rows`` spans the keys some query sees."""
    q = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    if prefix:
        hi = np.maximum(hi, min(prefix, Sk) - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    n = np.clip(hi - lo + 1, 0, None)
    seen = n > 0
    if not seen.any():
        return 0, 0
    return int(n.sum()), int(hi[seen].max() - lo[seen].min() + 1)


def _flash_cost(B, Sq, Sk, H, G, d, itemsize, causal=True, window=0,
                prefix=0, q_offset=0):
    """``4 * H * d`` FLOPs a visible (q, k) pair (QK^T and PV); q and o,
    the K/V rows the visible pairs span and the fp32 lse, each once."""
    pairs, k_rows = visible_pairs(Sq, Sk, causal=bool(causal),
                                  window=int(window), prefix=int(prefix),
                                  q_offset=int(q_offset))
    flops = 4 * B * H * d * pairs
    nbytes = B * (2 * Sq * H * d * itemsize + 2 * k_rows * G * d * itemsize
                  + H * Sq * 4)
    return flops, nbytes


def _rmsnorm_cost(R, d, itemsize):
    """Bytes only: x read and y written once, the scale once."""
    return 0, (2 * R * d + d) * itemsize


def _rmsnorm_sumsq_cost(R, d, itemsize):
    """Bytes only: x read once, the fp32 sums written."""
    return 0, R * d * itemsize + 4 * R


def _rmsnorm_scale_cost(R, d, itemsize):
    """Bytes only: x read and y written once, the fp32 sums and the scale
    once."""
    return 0, (2 * R * d + d) * itemsize + 4 * R


def _adamw_cost(n, g_itemsize):
    """g read once; mu, nu and w read and written once, fp32."""
    return ADAMW_FLOPS * n, (g_itemsize + ADAMW_STATE_BYTES) * n


def _ssd_cost(B, S, H, P, N, Q, itemsize, h0=False):
    """x, B, C, dt and A read once, y and h written once in fp32 (h0 read
    once where the scan carries one); C B^T on and below the diagonal
    once per (batch, chunk), and per (batch, head, chunk) the decay mask
    (4 operations a pair on and below the diagonal), the masked product
    with x, C h^T, the state update and the elementwise scales: the
    three passes' products."""
    nc = S // Q
    tri = Q * (Q + 1) // 2
    nbytes = (B * S * H * P * itemsize + 2 * B * S * N * itemsize
              + B * S * H * 4 + H * 4 + B * S * H * P * 4 + B * H * P * N * 4)
    if h0:
        nbytes += B * H * P * N * 4
    ops = B * nc * 2 * N * tri + B * H * nc * (
        (4 + 2 * P) * tri + 4 * Q * N * P + 2 * Q * P + 2 * P * N)
    return ops, nbytes


_COSTS = {"flash_attention_fwd": _flash_cost, "rmsnorm_rows": _rmsnorm_cost,
          "fused_adamw_flat": _adamw_cost, "ssd_scan": _ssd_cost,
          "rmsnorm_sumsq_rows": _rmsnorm_sumsq_cost,
          "rmsnorm_scale_rows": _rmsnorm_scale_cost}
KERNELS = tuple(_COSTS)


def kernel_cost(name: str, **shapes) -> Tuple[int, int]:
    """``(flops, bytes)`` of one call of kernel wrapper ``name`` at
    ``shapes``: the work of the function, the same whatever implements
    it (these are the bounds of ``PERF.md``'s kernel table).

    - ``flash_attention_fwd``: B, Sq, Sk, H, G, d, itemsize, causal,
      window, prefix, q_offset;
    - ``rmsnorm_rows``, ``rmsnorm_sumsq_rows``, ``rmsnorm_scale_rows``:
      R, d, itemsize;
    - ``fused_adamw_flat``: n, g_itemsize;
    - ``ssd_scan``: B, S, H, P, N, Q (the chunk), itemsize, h0 (bool)."""
    if name not in _COSTS:
        raise KeyError(f"kernel_cost: unknown kernel {name!r}; known: "
                       f"{KERNELS}")
    return _COSTS[name](**shapes)


# ---------------------------------------------------------------------------
# the step counter
# ---------------------------------------------------------------------------

aten = torch.ops.aten

# ops that move no bytes of their own (beside every view op): aliases,
# allocation without a write, bookkeeping, the iota
NO_TRAFFIC = {aten._unsafe_view, aten._reshape_alias, aten.empty,
              aten.empty_like, aten.empty_strided, aten.new_empty,
              aten.new_empty_strided, aten.lift_fresh, aten.arange,
              aten._local_scalar_dense, aten.resize_, aten.set_,
              aten.record_stream}
# ops whose first argument is written, not read
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# ops that multiply matrices by a rule :func:`_product_flops` lacks
_UNCOUNTABLE = tuple(getattr(aten, n) for n in (
    "convolution", "_convolution", "cudnn_convolution",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention", "_flash_attention_forward",
    "_efficient_attention_forward", "_scaled_mm", "_int_mm")
    if hasattr(aten, n))


_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.addbmm,
             aten.mv, aten.addmv, aten.dot, aten.vdot, aten.linear}


def _product_flops(packet, args) -> int:
    """2 * M * N * K of a matrix product (``packet`` in :data:`_PRODUCTS`)."""
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else args[1:3]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm, aten.addbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm else args[1:3]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet in (aten.mv, aten.addmv):
        a = args[0] if packet is aten.mv else args[1]
        return 2 * a.shape[0] * a.shape[1]
    if packet in (aten.dot, aten.vdot):
        return 2 * args[0].shape[0]
    x, w = args[0], args[1]                         # linear
    return 2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1]


@functools.lru_cache(maxsize=None)
def _rule(func):
    """How the counter reads an aten op overload: ``(name, packet if it
    multiplies matrices else None, moves bytes, writes its first argument
    without reading it)``; raises for a product it has no rule for."""
    packet = func.overloadpacket
    if packet in _UNCOUNTABLE:
        raise NotImplementedError(f"count_work: no FLOP rule for {packet}")
    return (str(packet), packet if packet in _PRODUCTS else None,
            not (func.is_view or packet in NO_TRAFFIC), packet in _WRITE_ONLY)


def _score_class(shape) -> bool:
    """``[.., S, S]`` with S >= 1024: attention scores, probabilities and
    masks (the reference's ``is_score_class``)."""
    return len(shape) >= 2 and shape[-1] >= 1024 and shape[-1] == shape[-2]


def _add_bytes(tree, acc: List[int]) -> None:
    """Adds the bytes of every tensor in ``tree`` (tensors in lists,
    tuples and dicts) to ``acc``: ``[bytes, score-class bytes]``."""
    if isinstance(tree, torch.Tensor):
        acc[_score_class(tree.shape)] += tree.numel() * tree.element_size()
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _add_bytes(t, acc)
    elif isinstance(tree, dict):
        for t in tree.values():
            _add_bytes(t, acc)


@dataclass
class WorkCount:
    """What a counted region did.  ``flops``: matrix-product FLOPs (the
    product kernels' too); ``bytes_traffic``: bytes moved, score-class
    tensors apart in ``score_bytes``; ``kernels``: wrapper name ->
    ``[calls, flops, bytes]`` by :func:`kernel_cost`; ``ops``: aten op ->
    ``[calls, flops, bytes]`` (score bytes in) of the ops that move bytes
    or multiply matrices.  Integers, so counts add and compare exactly."""
    flops: int = 0
    bytes_traffic: int = 0
    score_bytes: int = 0
    kernels: Dict[str, List[int]] = field(default_factory=dict)
    ops: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def bytes_traffic_raw(self) -> int:
        return self.bytes_traffic + self.score_bytes

    def add(self, other: "WorkCount", times: int = 1) -> "WorkCount":
        """Adds ``times`` x ``other`` into this count (in place)."""
        self.flops += times * other.flops
        self.bytes_traffic += times * other.bytes_traffic
        self.score_bytes += times * other.score_bytes
        for mine, theirs in ((self.kernels, other.kernels),
                             (self.ops, other.ops)):
            for k, v in theirs.items():
                row = mine.setdefault(k, [0, 0, 0])
                for i in range(3):
                    row[i] += times * v[i]
        return self

    def copy(self) -> "WorkCount":
        return WorkCount().add(self)

    def __sub__(self, other: "WorkCount") -> "WorkCount":
        out = self.copy().add(other, -1)
        for d in (out.kernels, out.ops):
            for k in [k for k, v in d.items() if not any(v)]:
                del d[k]
        return out

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes_traffic": self.bytes_traffic,
                "score_bytes": self.score_bytes,
                "bytes_traffic_raw": self.bytes_traffic_raw,
                "kernels": dict(sorted(self.kernels.items()))}


class _Counter(TorchDispatchMode):
    """The dispatch mode :func:`count_work` runs a region under."""

    def __init__(self):
        super().__init__()
        self.count = WorkCount()
        self.hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.hidden:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        name, product, moves, write_only = _rule(func)
        flops = _product_flops(product, args) if product is not None else 0
        acc = [0, 0]
        if moves:
            _add_bytes(args[1:] if write_only else args, acc)
            _add_bytes(kwargs, acc)
            _add_bytes(out, acc)
        nbytes, score = acc
        if not (flops or nbytes or score):
            return                      # a view or bookkeeping
        c = self.count
        c.flops += flops
        c.bytes_traffic += nbytes
        c.score_bytes += score
        row = c.ops.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes + score

    def kernel(self, name: str, run, shapes):
        flops, nbytes = kernel_cost(name, **shapes)
        c = self.count
        row = c.kernels.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if name in PRODUCT_KERNELS:
            c.flops += flops
        c.bytes_traffic += nbytes
        self.hidden += 1
        try:
            return run()
        finally:
            self.hidden -= 1


ACTIVE: Optional[_Counter] = None     # the running count, if any


@contextlib.contextmanager
def count_work():
    """Counts the work of the aten ops and kernel-wrapper calls the
    enclosed code runs (in this thread and in the autograd engine's):
    yields the :class:`WorkCount` it fills.  Counts do not nest.  Never
    wrap a timed step in it: every op pays a Python call."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("count_work: a count is already running")
    counter = _Counter()
    ACTIVE = counter
    try:
        with counter:
            yield counter.count
    finally:
        ACTIVE = None


def kernel(name: str, run, **shapes):
    """A kernel wrapper's call under the running count: adds
    ``kernel_cost(name, **shapes)`` once, then runs ``run()`` (the
    wrapper's body: the launch on the card, the plain version on the
    CPU, the outputs' shapes on the meta device) with its ops hidden.
    A wrapper calls it only while ``ACTIVE`` is set."""
    return ACTIVE.kernel(name, run, shapes)
