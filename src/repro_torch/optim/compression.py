"""Gradient compression (port of ``repro/optim/compression.py``): int8 or
int16 quantization with error feedback, and the standalone quantizers
of the offload shipment.

The reference's ``compressed_psum`` runs inside ``shard_map`` and
reduces over the pipe axis with ``pmax`` and ``psum``.  Here the P
virtual stages live on one card, so :func:`compressed_sum` takes the
stages' partial gradients as a list and makes both reductions explicit:
one scale shared by every stage (the max of ``|g + e|`` over all of
them, over ``qmax``), each stage's codes rounded on that grid and
summed exactly as int32, the sum times the scale.  The residual each
stage's wire dropped is its new error-feedback state.  With the stages
as ``torch.distributed`` ranks, :func:`compressed_sum_over` makes the
same two reductions collectives (an all-reduce MAX of the amax, an
all-reduce SUM of the int32 codes); both are exact, so its result is
bitwise :func:`compressed_sum`'s.

Every function computes in fp32 in the reference's operation order, so
the results equal the JAX package's bitwise (``torch.round`` rounds half
to even, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def ef_init(grads_proto) -> Any:
    """Zero error-feedback state: an fp32 tree shaped as ``grads_proto``."""
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), grads_proto)


def _wire_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def compressed_sum(partials: List[Any], ef, bits: int = 8, *,
                   with_scales: bool = False):
    """``sum(partials)`` over an int wire with error feedback.

    ``partials``: one gradient tree per stage (any float dtype; an fp32
    leaf is consumed: ``g + e`` is formed in its storage, and the first
    stage's holds the result); ``ef``: the
    matching fp32 tree, each leaf stacked ``[len(partials), ...]``.
    Returns ``(reduced fp32 tree, new_ef)``, and with ``with_scales`` a
    third tree of each leaf's shared scale (0-d fp32); ``new_ef`` is
    ``ef``, updated in place.  A stage whose partial and residual are
    zero contributes nothing: its codes are 0 and its residual stays
    0."""
    def one(e_stack, *gs):
        assert e_stack.shape[0] == len(gs), \
            "ef leaves are stacked over the partials"
        g = [gi.float().add_(e_stack[i]) for i, gi in enumerate(gs)]
        scale = grid_scale(torch.stack([gi.abs().max() for gi in g]).max(),
                           bits)
        summed = None
        for i, gi in enumerate(g):
            codes = quantize_with(gi, scale, bits)
            torch.sub(gi, codes * scale, out=e_stack[i])
            summed = codes.to(torch.int32) if summed is None \
                else summed.add_(codes)
        # the sum, in the first partial's storage (no longer read)
        return g[0].copy_(summed).mul_(scale), scale

    parts = [tree_leaves(p) for p in partials]
    res = [one(e, *gs) for e, gs in zip(tree_leaves(ef), zip(*parts))]
    out = (tree_unflatten(ef, [r[0] for r in res]), ef)
    if with_scales:
        out += (tree_unflatten(ef, [r[1] for r in res]),)
    return out


def compressed_sum_over(group, g, e, bits: int = 8, *, like):
    """One shared leaf's :func:`compressed_sum` over ranks: the
    reference's ``compressed_psum`` (``pmax`` of the amax, then ``psum``
    of the int32 codes) with ``group.all_reduce(tensor, op)`` (a
    :class:`repro_torch.launch.mesh.PipeMesh`) for the two collectives.

    ``g``: this rank's fp32 partial, consumed (``g + e`` is formed in its
    storage, which then holds the sum), and ``e`` its error-feedback
    residual, updated in place; both None on a rank that writes no
    gradient into the leaf (it adds zero codes and keeps no residual).
    ``like``: the leaf (shape and device of the sum).  Every rank calls
    this for every leaf in the same order.  Returns ``(sum fp32, shared
    scale 0-d)``."""
    if g is not None:
        g = g.float().add_(e)
        amax = g.abs().max()
    else:
        amax = torch.zeros((), dtype=torch.float32, device=like.device)
    group.all_reduce(amax, "max")
    scale = grid_scale(amax, bits)
    if g is None:
        summed = torch.zeros(like.shape, dtype=torch.int32,
                             device=like.device)
    else:
        codes = quantize_with(g, scale, bits)
        torch.sub(g, codes * scale, out=e)
        summed = codes.to(torch.int32)
    group.all_reduce(summed, "sum")
    out = summed.float() if g is None else g.copy_(summed)
    return out.mul_(scale), scale


def quantize_int8(g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standalone int8 quantizer (checkpoint / offload transport): one
    symmetric scale ``max(amax, 1e-30) / 127`` over the whole tensor
    (fp32 math); ``scale`` is a 0-d fp32 tensor."""
    g = g.float()
    scale = grid_scale(g.abs().max(), 8)
    return quantize_with(g, scale, 8), scale


def dequantize_int8(q, scale) -> torch.Tensor:
    return q.float() * scale


def grid_scale(amax, bits: int) -> torch.Tensor:
    """The step of the symmetric ``bits``-wide grid over ``[-amax,
    amax]``: ``max(amax, 1e-30) / qmax``, ``qmax = 2**(bits-1) - 1``
    (fp32; ``amax`` a tensor of any shape)."""
    return torch.clamp(amax, min=1e-30) / (2.0 ** (bits - 1) - 1)


def quantize_with(g, scale, bits: int) -> torch.Tensor:
    """The codes of ``g`` on a given symmetric grid: ``clamp(round(g /
    scale), +-qmax)`` in fp32 (``scale`` broadcasts: one per tensor, or
    one per row), in the wire dtype (int8, or int16 for the reference's
    int16 shipment).  Every quantizer of the port rounds here, so a large
    tensor can also be quantized in slabs once its scale is known."""
    qmax = 2.0 ** (bits - 1) - 1
    return torch.div(g.float(), scale).round_().clamp_(-qmax, qmax) \
        .to(_wire_dtype(bits))
