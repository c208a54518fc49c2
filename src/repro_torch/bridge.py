"""Carry ``LM.init`` weights between the JAX package and the port.

The tree keeps its structure and layout leaf for leaf:
``{"embed": {"tokens"[, "head"]}, "final_norm": {"scale"}, "layers":
[per period position, leaves stacked [num_periods, ...]], "rem_layers":
[...]}``.  Leaves cross as numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side), so this module imports neither JAX nor
``ml_dtypes``: a bfloat16 leaf (numpy dtype name ``"bfloat16"``) crosses
as its raw 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf_to_torch(a, device, dtype):
    a = np.array(a, order="C")     # a private, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def lm_params_from_numpy(tree, device, dtype=None):
    """numpy tree -> torch tree on ``device`` (cast to ``dtype`` if given);
    the bits are kept exactly when ``dtype`` is None."""
    return tree_map(lambda a: _leaf_to_torch(a, device, dtype), tree)


def _leaf_to_numpy(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16 type; needed only for this case
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_to_numpy(tree):
    """Inverse of :func:`lm_params_from_numpy` (bitwise round trip)."""
    return tree_map(_leaf_to_numpy, tree)
