"""Slot-indexed per-request KV caches for the pipelined engine (port of
``repro/serve/kv_slots.py``).

Each pipeline stage owns the caches of its layers only, stacked
``[P, M, n_slots, ...]``: the slot axis sits where ``LM.init_cache``
puts its batch axis, so one slot's view is shaped like a single-host
batch-1 cache.  The cache tree is a list over the period position
``jp``, each entry the leaves of that position's layer kind:

- attention: ``k`` and ``v`` ``[P, M, n_slots, max_seq, G, hd]`` in the
  parameter dtype;
- Mamba-2: the conv tails ``conv_x`` ``[P, M, n_slots, W-1, d_in]``,
  ``conv_B`` and ``conv_C`` ``[P, M, n_slots, W-1, N]`` in the parameter
  dtype, and the SSM state ``h`` ``[P, M, n_slots, H, head_dim, N]`` in
  fp32 (``max_seq`` does not size them).

Unlike the reference, whose arrays are immutable, these buffers are
updated **in place**: :func:`read_slot` returns views into the stacked
tensors, attention writes each step's K/V through them, and
:func:`write_slot` has nothing left to copy when it is handed those
views back.  That keeps one copy of the cache on the card instead of a
read-modify-write of a slot's whole buffer per tick.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.layout import StageLayout
from repro_torch.models.transformer import _init_cache_layer


def init_slot_caches(cfg, layout: StageLayout, n_slots: int, max_seq: int,
                     device) -> List:
    """Zero caches for every (stage, period-group, layer, slot): a list
    over ``jp < layout.period`` of dicts with leaves ``[P, M, n_slots,
    ...]`` (K/V, or conv tails and SSM state, as the module docstring
    lists)."""
    assert layout.v == 1, "serving uses v=1 (no interleaving)"
    out = []
    for jp in range(layout.period):
        one = _init_cache_layer(cfg, jp, n_slots, max_seq, "meta")
        out.append({k: torch.zeros((layout.P, layout.M) + tuple(a.shape),
                                   dtype=a.dtype, device=device)
                    for k, a in one.items()})
    return out


def read_slot(caches_local: List, slot: int) -> List:
    """Stage-local caches (leaves ``[M, n_slots, ...]``) -> the batch-1
    view of one slot (leaves ``[M, 1, ...]``), aliasing the storage."""
    return [{k: a[:, slot:slot + 1] for k, a in t.items()}
            for t in caches_local]


def write_slot(caches_local: List, view: List, slot: int) -> None:
    """Write a slot view back (inverse of :func:`read_slot`).  A view that
    aliases the slot (what :func:`read_slot` returns) is already there."""
    for t, u_t in zip(caches_local, view):
        for k, a in t.items():
            dst = a[:, slot:slot + 1]
            if u_t[k].data_ptr() != dst.data_ptr():
                dst.copy_(u_t[k])


def zero_slot(view: List) -> None:
    """Clear a slot view in place (a request's first prefill chunk): K/V,
    conv tails and SSM state alike."""
    for t in view:
        for a in t.values():
            a.zero_()
