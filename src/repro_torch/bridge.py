"""Carry ``LM.init`` weights between the JAX package and the port.

The tree keeps its structure and layout leaf for leaf:
``{"embed": {"tokens"[, "head"]}, "final_norm": {"scale"}, "layers":
[per period position, leaves stacked [num_periods, ...]], "rem_layers":
[...]}``, and an encoder-decoder's ``encoder`` (a list of layer trees),
``enc_norm`` and each decoder layer's ``cross`` and ``norm_x``.  Leaves cross as numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side), so this module imports neither JAX nor
``ml_dtypes``: a bfloat16 leaf (numpy dtype name ``"bfloat16"``) crosses
as its raw 16-bit pattern.

Every leaf keeps its own dtype, so the reference's fp32 leaves in a bf16
tree (an MoE layer's router, a Mamba-2 layer's ``A_log``, ``D`` and
``dt_bias``) cross as fp32, as the port's ``LM.init`` builds them.

A stage-stacked pipeline tree (``init_pipeline_params``: block leaves
``[P, v, M, ...]``, the shared leaves as above) crosses the same way,
whole, or one rank's column at a time (:func:`rank_params_from_numpy`,
the tree a rank of the port's multi-rank executor holds); an ``LM`` tree
crosses cut to a mesh rank's part with ``lm_params_from_numpy(shard=)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf_to_torch(a, device):
    a = np.array(a, order="C")     # a private, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def lm_params_from_numpy(tree, device, shard=None):
    """numpy tree -> torch tree on ``device``, every leaf's bits and dtype
    kept exactly.  With ``shard`` (a
    :class:`~repro_torch.models.sharding.TreeShard` of the tree, e.g.
    :func:`repro_torch.launch.steps.lm_shard` for an ``LM`` tree on a
    ``1 x dp x tp`` mesh) every leaf is cut to the rank's part (its tp
    shard, its dp slice where the rank holds one) on the host before it
    moves to ``device``."""
    if shard is None:
        return tree_map(lambda a: _leaf_to_torch(a, device), tree)
    return tree_map(lambda a: a.to(device),
                    shard.cut(lm_params_from_numpy(tree, "cpu")))


def rank_params_from_numpy(tree, rank: int, device, shard=None):
    """A stage-stacked numpy tree -> rank ``rank``'s torch tree on
    ``device``: block leaves ``[v, M, ...]`` cut from ``[P, v, M, ...]``
    before they cross (what
    :func:`repro_torch.core.pipeline_runtime.rank_params` cuts from the
    whole tree), the shared leaves whole; bits and dtypes kept.  With
    ``shard`` (a :class:`~repro_torch.core.pipeline_runtime.RankShard`,
    a rank of a ``pp x dp x tp`` mesh) every leaf is also cut to the
    rank's tp shard (and at ZeRO-3 a block leaf to its dp slice) by the
    reference's specs, on the host, before it moves to ``device``."""
    col = {**{k: v for k, v in tree.items() if k != "blocks"},
           "blocks": [tree_map(lambda a: a[rank], t) for t in tree["blocks"]]}
    if shard is None:
        return lm_params_from_numpy(col, device)
    return tree_map(lambda a: a.to(device),
                    shard.cut(lm_params_from_numpy(col, "cpu")))


def _leaf_to_numpy(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16 type; needed only for this case
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_to_numpy(tree):
    """Inverse of :func:`lm_params_from_numpy` (bitwise round trip)."""
    return tree_map(_leaf_to_numpy, tree)
