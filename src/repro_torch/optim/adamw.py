"""AdamW with fp32 master weights + model-dtype weights (mixed precision),
global-norm clipping and decoupled weight decay with a rank-based mask
(own copy of ``repro/optim/adamw.py``, with its ZeRO spec helpers
:func:`zero_state_specs` and :func:`drop_fsdp`).

State: ``{"step": int32 0-d tensor, "mu": fp32 tree, "nu": fp32 tree,
"master": fp32 tree}``, all on the parameters' device.

The update runs **in place**: ``mu``, ``nu`` and ``master`` are
overwritten leaf by leaf and the same state dict is returned (the
reference returns new trees; here that would hold two copies of the
optimizer state).  fp32 gradients are scaled by the clip factor in
place too, so the caller's gradient tree is consumed; a gradient leaf of
another dtype is widened to fp32 where the norm and the update read it,
one leaf at a time, so no fp32 copy of a bf16 gradient tree is held.
``use_kernel=True`` runs each leaf's step through the fused CUDA kernel
(:func:`repro_torch.kernels.fused_adamw.adamw_update_leaf`); the default
is the kernel's plain version, which follows the kernel's operation
order, so the two paths agree bitwise on the card.  The plain version
runs over flat slabs of at most :data:`SLAB` elements of each leaf, so
its fp32 temporaries (the widened gradient and the update's
intermediates) are bounded by a slab, not by the stacked leaf; every
element sees the same operations, so the result is bitwise that of one
call over the whole leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.fused_adamw.ops import (adamw_update_leaf,
                                                 fused_adamw_flat_ref)
from repro_torch.optim.schedules import lr_at
from repro_torch.tree import tree_leaves, tree_map


SLAB = 1 << 24          # elements per slab of the plain update (64 MiB fp32)


def _slabs(g, *state):
    """Aligned flat slabs of ``g`` and the same-shape ``state`` tensors
    (contiguous): ``g`` is split along its leading dimension until each
    piece is contiguous (an offload run's shallow gradients are strided
    views), then each piece into runs of :data:`SLAB` elements."""
    if not g.is_contiguous():
        for i in range(g.shape[0]):
            yield from _slabs(g[i], *(t[i] for t in state))
        return
    flat = [t.view(-1) for t in (g,) + state]
    for i in range(0, flat[0].numel(), SLAB):
        yield tuple(t[i:i + SLAB] for t in flat)


def _decay_masks(tree) -> Any:
    """Decay only >=2-D tensors (matmul weights / embeddings); skip norm
    scales, biases, per-head scalars — the classic AdamW rule."""
    return tree_map(lambda a: a.dim() >= 2, tree)


def adamw_init(params) -> Dict[str, Any]:
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                             device=a.device), params),
        "nu": tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                             device=a.device), params),
        # own contiguous copies, also of strided views (an offload run's
        # shallow chunks): the fused kernel reads flat leaves
        "master": tree_map(
            lambda a: a.detach().to(torch.float32, copy=True,
                                    memory_format=torch.contiguous_format),
            params),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(a.float().square().sum()
                          for a in tree_leaves(tree)) + 1e-30)


def leaf_sq_sum(g, grad_div=None) -> torch.Tensor:
    """``sum((g.float() / grad_div) ** 2)`` of one gradient leaf, with the
    operations :func:`adamw_update` runs for its norm (so the same bits),
    leaving ``g`` as it is."""
    w = g.float() if grad_div is None else g.float() / grad_div
    return (w.square() if w is g else w.square_()).sum()


def adamw_update(grads, state, cfg: OptimizerConfig, *,
                 use_kernel: bool = False, grad_div=None, grad_norm=None):
    """Returns ``(master, state, metrics)``; ``state`` is updated in place
    (see the module docstring).  ``grads`` may be any float dtype; the
    math is fp32.  With ``grad_div`` (a device scalar) the update reads
    ``g.float() / grad_div``, the reference's ``g.astype(f32) / m``: fp32
    leaves are divided in place first, other leaves as they are widened.
    ``grad_norm``: the clip norm when the caller reckons it (a rank's
    step: the norm over every rank's leaves), else the norm of
    ``grads``.  ``metrics`` holds ``grad_norm`` and ``lr`` as device
    tensors."""
    if grad_div is not None:
        for g in tree_leaves(grads):
            if g.dtype == torch.float32:
                g.div_(grad_div)

    def f32(g):
        """Leaf ``g`` as the update reads it: an fp32 leaf itself (divided
        above), another dtype widened to a new fp32 tensor, then divided."""
        if g.dtype == torch.float32 or grad_div is None:
            return g.float()
        return g.float().div_(grad_div)

    def sq_sum(g):
        w = f32(g)         # squared in place unless it is the leaf itself
        return (w.square() if w is g else w.square_()).sum()

    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = torch.sqrt(sum(sq_sum(g) for g in tree_leaves(grads)) + 1e-30) \
        if grad_norm is None else grad_norm
    if cfg.grad_clip > 0:
        clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        clip = torch.ones_like(gnorm)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    scalars = torch.stack([lr, bc1, bc2]).to(torch.float32).contiguous()
    masks = _decay_masks(grads)

    def upd(g, mu, nu, w, decay_on):
        kw = dict(b1=b1, b2=b2, eps=cfg.eps,
                  wd=cfg.weight_decay if decay_on else 0.0)
        if use_kernel:
            adamw_update_leaf(f32(g).mul_(clip), mu, nu, w, scalars, **kw)
            return
        for gs, ms, ns, ws in _slabs(g, mu, nu, w):
            fused_adamw_flat_ref(f32(gs).mul_(clip), ms, ns, ws, scalars,
                                 **kw)

    tree_map(upd, grads, state["mu"], state["nu"], state["master"], masks)
    state["step"] = step
    return state["master"], state, {"grad_norm": gnorm, "lr": lr}


def cast_like(tree_fp32, params):
    """Writes each master leaf into its parameter leaf, rounded to the
    parameter's dtype, in place, and returns ``params``: no second copy
    of the weights is made."""
    with torch.no_grad():
        tree_map(lambda m, p: p.copy_(m), tree_fp32, params)
    return params


# ---------------------------------------------------------------------------
# ZeRO sharding-spec derivation (the reference's)
# ---------------------------------------------------------------------------

def zero_state_specs(param_logical_specs, zero_stage: int):
    """Optimizer-state logical specs from parameter logical specs: at
    stage >= 1 every state (mu / nu / master) carries the fsdp axis, on
    the spec's first free (None) axis where the parameter has none (a
    spec without a free axis stays replicated)."""
    from repro_torch.models.sharding import spec_map

    def add_fsdp(spec):
        if spec is None:
            return spec
        spec = tuple(spec)
        if any(ax == "fsdp" or (isinstance(ax, tuple) and "fsdp" in ax)
               for ax in spec):
            return spec
        out = list(spec)
        for i, ax in enumerate(out):
            if ax is None:
                out[i] = "fsdp"
                return tuple(out)
        return spec

    if zero_stage < 1:
        return param_logical_specs
    return spec_map(add_fsdp, param_logical_specs)


def drop_fsdp(param_logical_specs):
    """Parameter specs for ZeRO-1/2 (parameters replicated over dp,
    states sharded): the fsdp axis removed."""
    from repro_torch.models.sharding import spec_map

    def rm(spec):
        if spec is None:
            return spec
        out = []
        for ax in tuple(spec):
            if ax == "fsdp":
                out.append(None)
            elif isinstance(ax, tuple):
                out.append(tuple(a for a in ax if a != "fsdp") or None)
            else:
                out.append(ax)
        return tuple(out)
    return spec_map(rm, param_logical_specs)
