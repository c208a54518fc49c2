"""Logical-axis sharding of the port (own copy of the pure logic of
``repro/models/sharding.py``), and the two autograd Functions that stand
where GSPMD inserts the tensor-parallel collectives.

Model code names *logical* axes ("dp", "tp", "sp", "fsdp", "pp",
"exp"); a :class:`ShardEnv` installed by the launcher resolves them to
physical mesh axes through its rules.  A spec is a tuple of mesh-axis
names (a ``PartitionSpec``'s entries: an axis name, a tuple of them, or
None), and a mesh is anything with a ``.shape`` dict of axis sizes: a
layout of :mod:`repro_torch.launch.mesh` (no processes) or a running
:class:`repro_torch.launch.mesh.Mesh`.

Without an installed env (one process, the tests' references) the model
code runs unsplit, exactly as before.  Under an env whose mesh runs
ranks with a tensor-parallel axis of size > 1, the layers of
:mod:`repro_torch.models.layers` run on their leaves' tp shards and call
:func:`copy_to_tp` (identity forward, all-reduce of the gradient over tp
backward) where a replicated activation enters a split product, and
:func:`reduce_from_tp` (all-reduce over tp forward, identity backward)
where partial products leave it.  Both capture the env when they run
forward, so their backward (on autograd's device thread for CUDA
tensors) reduces over the same group.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

_STACK: list = []


class ShardEnv:
    """``rules``: logical axis -> physical mesh axis (str | tuple |
    None); ``mesh``: anything with a ``.shape`` dict (or None)."""

    def __init__(self, mesh, rules: Dict[str, Axes]):
        self.mesh = mesh
        self.rules = dict(rules)

    def resolve(self, logical: Sequence[Axes]) -> Spec:
        """Logical axes -> a physical spec (duplicate mesh axes dropped,
        trailing Nones stripped), as the reference's ``resolve``."""
        phys = []
        used: set = set()
        for ax in logical:
            r = self._resolve_one(ax)
            # drop duplicate physical axes (a mesh axis may appear once)
            if isinstance(r, tuple):
                r = tuple(a for a in r if a not in used)
                used.update(r)
                phys.append(r if r else None)
            elif r is not None and r in used:
                phys.append(None)
            else:
                if r is not None:
                    used.add(r)
                phys.append(r)
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(phys)

    def _resolve_one(self, ax: Axes) -> Axes:
        if ax is None:
            return None
        if isinstance(ax, tuple):
            out = []
            for a in ax:
                r = self._resolve_one(a)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        return self.rules.get(ax, None)

    # -- the tensor-parallel axis of a running mesh -------------------------
    @property
    def tp_axis(self) -> Axes:
        return self.rules.get("tp")

    @property
    def tp(self) -> int:
        """The size of the tensor-parallel axis (1 without one)."""
        if self.mesh is None or self.tp_axis is None:
            return 1
        return axis_size(self.mesh, self.tp_axis)

    def splits(self, width: int) -> bool:
        """Is a dimension of ``width`` split over tp (the rule of
        :func:`sanitize_spec`: the axis is kept where its size divides
        the dimension)?"""
        return self.tp > 1 and width % self.tp == 0


@contextlib.contextmanager
def shard_env(mesh, rules: Dict[str, Axes]):
    env = ShardEnv(mesh, rules)
    _STACK.append(env)
    try:
        yield env
    finally:
        _STACK.pop()


def current_env() -> Optional[ShardEnv]:
    return _STACK[-1] if _STACK else None


def tp_env() -> Optional[ShardEnv]:
    """The installed env when it splits over a tensor-parallel axis of
    size > 1 on a running mesh, else None (the layers then run
    unsplit)."""
    env = current_env()
    if env is None or env.tp <= 1:
        return None
    return env


def axis_size(mesh, phys: Axes) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        n = 1
        for a in phys:
            n *= mesh.shape[a]
        return n
    return mesh.shape[phys]


def sanitize_spec(spec: Sequence[Axes], shape, mesh) -> Spec:
    """Drop sharded axes whose mesh extent doesn't divide the dim, and
    deduplicate mesh axes (a mesh axis may appear at most once)."""
    out = []
    used: set = set()
    for i, ax in enumerate(tuple(spec)):
        if ax is None or i >= len(shape):
            out.append(None if i >= len(shape) else ax)
            continue
        if isinstance(ax, tuple):
            kept = []
            rem = shape[i]
            for a in ax:
                sz = mesh.shape[a]
                if a not in used and rem % sz == 0:
                    kept.append(a)
                    used.add(a)
                    rem //= sz
            out.append(tuple(kept) if kept else None)
        else:
            if ax in used or shape[i] % mesh.shape[ax] != 0:
                out.append(None)
            else:
                out.append(ax)
                used.add(ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_spec(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(a is None or isinstance(a, (str, tuple))
                                 for a in x))


def spec_map(fn, tree, *rest):
    """``fn`` over the specs of a tree of specs (a spec is a leaf, as the
    reference's ``is_leaf=lambda x: isinstance(x, tuple) or x is None``),
    with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not _is_spec(tree)):
        return type(tree)(spec_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def resolve_tree(logical_tree):
    """A tree of logical specs -> physical specs under the installed env
    (``()`` everywhere without one)."""
    env = current_env()
    return spec_map(lambda s: () if env is None else env.resolve(s or ()),
                    logical_tree)


# ---------------------------------------------------------------------------
# shards of a leaf
# ---------------------------------------------------------------------------

def _shard_index(ax: Axes, coords: Mapping[str, Tuple[int, int]]):
    """``(index, count)`` of the shard a dimension split over ``ax``
    holds at ``coords`` (axis -> (coordinate, size)); axes absent from
    ``coords`` are not cut.  A tuple of axes is row-major, its first
    axis the major one, as a ``PartitionSpec``'s."""
    idx, n = 0, 1
    for a in ((ax,) if isinstance(ax, str) else ax):
        if a in coords:
            c, s = coords[a]
            idx, n = idx * s + c, n * s
    return idx, n


def local_shard(leaf: torch.Tensor, spec: Sequence[Axes],
                coords: Mapping[str, Tuple[int, int]]) -> torch.Tensor:
    """The shard of ``leaf`` (global) that the rank at ``coords`` (mesh
    axis -> ``(coordinate, axis size)``) holds under the physical
    ``spec``: a view, each split dimension narrowed to its block.
    Axes of ``spec`` absent from ``coords`` leave their dimension
    whole."""
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        i, n = _shard_index(ax, coords)
        if n == 1:
            continue
        size = leaf.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return out


def join_shards(shard_of: Callable[[Dict[str, Tuple[int, int]]],
                                   torch.Tensor],
                spec: Sequence[Axes], sizes: Mapping[str, int]
                ) -> torch.Tensor:
    """Inverse of :func:`local_shard` (for tests): the global leaf from
    ``shard_of(coords)``, the shard at each coordinate of the axes that
    ``spec`` names (``sizes``: axis -> size; an axis of ``spec`` absent
    from ``sizes`` is whole)."""
    axes = [a for ax in spec if ax is not None
            for a in ((ax,) if isinstance(ax, str) else ax) if a in sizes]

    def build(dim, coords):
        if dim == len(spec):
            return shard_of(coords)
        ax = spec[dim]
        if ax is None:
            return build(dim + 1, coords)
        names = [a for a in ((ax,) if isinstance(ax, str) else ax)
                 if a in sizes]
        if not names:
            return build(dim + 1, coords)
        parts = []

        def walk(k, cur):
            if k == len(names):
                parts.append(build(dim + 1, cur))
                return
            for c in range(sizes[names[k]]):
                walk(k + 1, {**cur, names[k]: (c, sizes[names[k]])})
        walk(0, coords)
        return torch.cat(parts, dim=dim)
    assert len(set(axes)) == len(axes), f"a mesh axis twice in {spec}"
    return build(0, {})


# ---------------------------------------------------------------------------
# the tensor-parallel collectives
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced (summed) over tp."""

    @staticmethod
    def forward(ctx, x, env):
        ctx.env = env
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        env = ctx.env
        g = g.contiguous().clone()
        env.mesh.all_reduce(g, env.tp_axis)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) over tp forward; identity backward."""

    @staticmethod
    def forward(ctx, x, env):
        y = x.contiguous().clone()
        env.mesh.all_reduce(y, env.tp_axis)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, env: Optional[ShardEnv] = None):
    """A replicated activation entering a tp-split product: the same
    value, and the partial gradients of the tp ranks summed on the way
    back.  Identity without a tp env."""
    env = env or tp_env()
    if env is None:
        return x
    return _CopyToTP.apply(x, env)


def reduce_from_tp(x: torch.Tensor, env: Optional[ShardEnv] = None):
    """Partial products of the tp ranks summed into the replicated
    activation; the gradient passes through unchanged.  Identity without
    a tp env."""
    env = env or tp_env()
    if env is None:
        return x
    return _ReduceFromTP.apply(x, env)


def max_over_tp(x: torch.Tensor, env: ShardEnv) -> torch.Tensor:
    """The elementwise max over tp of a tensor that needs no gradient
    (a stable softmax's shift)."""
    y = x.detach().contiguous().clone()
    env.mesh.all_reduce(y, env.tp_axis, op="max")
    return y
