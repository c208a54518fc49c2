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

ZeRO stage 3 (the reference's fsdp layout, where XLA gathers a sharded
weight at its use): :class:`TreeShard` says which leaves a rank holds
as its dp slice, and :func:`gather_fsdp` (all-gather over the fsdp
axis forward, reduce-scatter of the gradient backward) stands where the
weight is used, :func:`gather_at_use` over a tree.  The gathered leaf
is a temporary of the op that uses it: under a checkpoint the gather
runs again on recompute, and only the slice outlives the op.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

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

    @property
    def dp_axis(self) -> Axes:
        return self.rules.get("dp")

    @property
    def dp(self) -> int:
        """The size of the data-parallel axis (1 without one)."""
        if self.mesh is None or self.dp_axis is None:
            return 1
        return axis_size(self.mesh, self.dp_axis)

    @property
    def fsdp(self) -> int:
        """The size of the fsdp axis on a running mesh (1 without one)."""
        ax = self.rules.get("fsdp")
        if self.mesh is None or ax is None:
            return 1
        return axis_size(self.mesh, ax)

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


def dp_env() -> Optional[ShardEnv]:
    """The installed env when its mesh runs a data-parallel axis of size
    > 1 (a rank then holds its rows of the global microbatch), else
    None."""
    env = current_env()
    if env is None or env.dp <= 1:
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


def shard_slices(shape, spec: Sequence[Axes],
                 coords: Mapping[str, Tuple[int, int]]) -> List[slice]:
    """Where the shard :func:`local_shard` cuts from a leaf of ``shape``
    lies in it: one slice a dimension."""
    out = [slice(0, n) for n in shape]
    for dim, ax in enumerate(spec):
        if ax is None or dim >= len(shape):
            continue
        i, n = _shard_index(ax, coords)
        if n == 1:
            continue
        size = shape[dim] // n
        out[dim] = slice(i * size, (i + 1) * size)
    return out


def local_shard(leaf: torch.Tensor, spec: Sequence[Axes],
                coords: Mapping[str, Tuple[int, int]]) -> torch.Tensor:
    """The shard of ``leaf`` (global) that the rank at ``coords`` (mesh
    axis -> ``(coordinate, axis size)``) holds under the physical
    ``spec``: a view, each split dimension narrowed to its block.
    Axes of ``spec`` absent from ``coords`` leave their dimension
    whole."""
    out = leaf
    for dim, sl in enumerate(shard_slices(leaf.shape, spec, coords)):
        if sl.stop - sl.start != leaf.shape[dim]:
            out = out.narrow(dim, sl.start, sl.stop - sl.start)
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


class _SumOverTP(torch.autograd.Function):
    """All-reduce (sum) over tp forward, and its true gradient backward:
    every rank's input reaches every rank's sum, so each input's gradient
    is the sum of the ranks' output gradients (an all-reduce)."""

    @staticmethod
    def forward(ctx, x, env):
        ctx.env = env
        y = x.contiguous().clone()
        env.mesh.all_reduce(y, env.tp_axis)
        return y

    @staticmethod
    def backward(ctx, g):
        env = ctx.env
        g = g.contiguous().clone()
        env.mesh.all_reduce(g, env.tp_axis)
        return g, None


def sum_over_tp(x: torch.Tensor, env: ShardEnv) -> torch.Tensor:
    """Partial sums of the tp ranks summed, differentiably: the forward and
    the backward each all-reduce over tp (a sum whose every rank's result
    is used, such as a split row's sum of squares)."""
    return _SumOverTP.apply(x, env)


def tp_all_reduce(env: ShardEnv) -> Callable[[torch.Tensor], torch.Tensor]:
    """An in-place sum over ``env``'s tp axis (a kernel Function's
    collective, called in its forward and backward)."""
    return lambda t: env.mesh.all_reduce(t, env.tp_axis)


def max_over_tp(x: torch.Tensor, env: ShardEnv) -> torch.Tensor:
    """The elementwise max over tp of a tensor that needs no gradient
    (a stable softmax's shift)."""
    y = x.detach().contiguous().clone()
    env.mesh.all_reduce(y, env.tp_axis, op="max")
    return y


class _GatherFSDP(torch.autograd.Function):
    """All-gather over the fsdp axis forward (each leaf ``xs[i]`` joined
    along ``dims[i]``, the leaves of one dtype in one collective); the
    gradients reduce-scattered (summed, this rank's slices kept)
    backward, likewise one collective a dtype."""

    @staticmethod
    def forward(ctx, env, dims, *xs):
        ctx.env, ctx.dims = env, dims
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(env.mesh.all_gather_cat(list(xs), env.rules["fsdp"],
                                             dims))

    @staticmethod
    def backward(ctx, *gs):
        env = ctx.env
        n = env.fsdp
        gs = [g if g is not None else
              torch.zeros(_times(shape, d, n), dtype=dt, device=dev)
              for g, (shape, dt, dev), d in zip(gs, ctx.like, ctx.dims)]
        return (None, None) + tuple(env.mesh.reduce_scatter(
            gs, env.rules["fsdp"], ctx.dims))


def _times(shape, dim: int, n: int):
    """``shape`` with dimension ``dim`` ``n`` times as long."""
    return tuple(s * n if i == dim else s for i, s in enumerate(shape))


def gather_fsdp(xs: Sequence[torch.Tensor], dims: Sequence[int],
                env: Optional[ShardEnv] = None) -> list:
    """The whole leaves from their fsdp slices (``xs[i]`` along
    ``dims[i]``; new tensors, one collective a dtype), and on the way
    back the slices of the gradients summed over fsdp.  The leaves
    themselves without an env whose fsdp axis has more than one rank."""
    env = env or current_env()
    if env is None or env.fsdp <= 1 or not xs:
        return list(xs)
    return list(_GatherFSDP.apply(env, tuple(dims), *xs))


def gather_at_use(tree, dims, shift: int = 0):
    """``tree`` with every leaf whose entry of ``dims`` (a tree of the
    same structure: a dimension or None) is set gathered over fsdp
    (:func:`gather_fsdp` along that dimension less ``shift``, the leading
    axes the caller indexed away), in one call; ``dims`` None: ``tree``
    itself."""
    if dims is None:
        return tree
    leaves, ks = tree_leaves(tree), tree_leaves(dims)
    at = [i for i, k in enumerate(ks) if k is not None]
    whole = gather_fsdp([leaves[i] for i in at], [ks[i] - shift for i in at])
    for i, a in zip(at, whole):
        leaves[i] = a
    return tree_unflatten(tree, leaves)


# ---------------------------------------------------------------------------
# one rank's part of a parameter tree
# ---------------------------------------------------------------------------

class TreeShard:
    """What one rank of a mesh holds of a parameter tree under the
    reference's logical specs, resolved by ``rules`` and sanitized on
    the leaves' global shapes (``tree``: the global tree, e.g. on the
    meta device; ``param_logical`` / ``state_logical``: the logical spec
    trees of the parameters as the rank holds them and of their
    optimizer state; ``shape``: axis name -> size; ``coords``: the
    rank's coordinate on each axis; ``dropped(path)``: how many leading
    dimensions of the leaf at ``path`` the rank indexes away, e.g. a
    pipeline block leaf's stage axis).  Per leaf, in ``tree_leaves``
    order, in the rank's local dimensions:

    - ``param_specs``: the physical spec of the rank's parameter;
    - ``tp_split``: is it split over tp;
    - ``fsdp_dims``: the dimension it is cut over dp on (ZeRO-3: the
      rank holds that slice only and gathers the whole at use), or None;
    - ``zero_dims``: the dimension its optimizer state is cut over dp on
      (ZeRO-1; a leaf cut over dp has its state cut the same way), or
      None where the state is whole;
    - ``kv``: is it a K/V projection (``wk``, ``wv``, ``bk``, ``bv`` of
      an ``attn`` or ``cross`` tree) held as whole heads replicated over
      tp: ``kv_heads`` (the config's ``G``) divides tp and is below it,
      so rank ``t`` holds head ``t // kv_rep`` (``kv_rep = tp / G``), the
      group of its ``H / tp`` query heads.  The reference's GSPMD cuts
      such a leaf's columns by its resolved spec (within a head); the
      port cuts whole heads (a deliberate divergence: the same numbers),
      so its ``param_specs`` stay the reference's and the cut is
      ``cut_specs``;
    - ``cut_specs``: the spec the rank's part is cut by (``param_specs``,
      but "model" on a K/V leaf's head columns);
    - ``tp_parts``: how many distinct parts tp cuts the leaf into (tp
      where it is split, ``G`` for a replicated K/V leaf, 1 where it is
      whole).

    The ranks of a K/V group (``kv_rep`` consecutive tp coordinates) hold
    one head alike: :meth:`kv_sum` sums their gradients of it, and the
    clip norm counts it on the group's first rank."""

    def __init__(self, tree, param_logical, state_logical, shape, rules,
                 coords, dropped=lambda path: 0, kv_heads: int = 0):
        self.shape, self.coords = dict(shape), dict(coords)
        mesh = SimpleNamespace(shape=self.shape)   # a layout: no processes
        env = ShardEnv(mesh, rules)
        self.paths = tree_paths(tree)
        self._structure = tree_map(lambda a: None, tree)
        shapes = [tuple(a.shape) for a in tree_leaves(tree)]

        def phys(specs):
            flat = spec_leaves(specs)
            assert len(flat) == len(shapes), "spec tree != parameter tree"
            return [sanitize_spec(env.resolve(sp), sh, mesh)
                    for sp, sh in zip(flat, shapes)]
        cut = [dropped(p) for p in self.paths]
        # the global shapes, and how many leading dimensions the rank
        # indexes away (its local dimensions are the rest)
        self.shapes, self.dropped = shapes, cut
        ps, ss = phys(param_logical), phys(state_logical)
        self.param_specs = [sp[k:] for sp, k in zip(ps, cut)]
        tp_ax, dp_ax = rules.get("tp"), rules.get("dp")
        self.tp = self.shape.get(tp_ax, 1) if tp_ax else 1
        self.kv_rep = self.tp // kv_heads if kv_heads and \
            self.tp > kv_heads and self.tp % kv_heads == 0 else 1
        self.kv = [self.kv_rep > 1 and is_kv_path(p) for p in self.paths]
        self.cut_specs = [
            _on_last(sp, len(sh) - k, tp_ax) if kv else sp
            for sp, sh, k, kv in zip(self.param_specs, shapes, cut, self.kv)]
        self.tp_split = [kv or names_axis(sp, tp_ax)
                         for sp, kv in zip(self.param_specs, self.kv)]
        self.tp_parts = [kv_heads if kv else self.tp if split else 1
                         for kv, split in zip(self.kv, self.tp_split)]

        def dim_of(sp, k):
            i = next((i for i, ax in enumerate(sp)
                      if names_axis((ax,), dp_ax)), None)
            return None if i is None else i - k
        self.dp = self.shape.get(dp_ax, 1) if dp_ax else 1
        # a dp axis of one rank cuts nothing: every leaf is whole
        self.fsdp_dims = [dim_of(sp, 0) if self.dp > 1 else None
                          for sp in self.param_specs]
        self.zero_dims = [dim_of(sp, k) for sp, k in zip(ss, cut)]
        for f, z in zip(self.fsdp_dims, self.zero_dims):
            assert f is None or f == z, "a dp-cut leaf's state cut elsewhere"
        self.dp_coord = self.coords.get(dp_ax, 0) if dp_ax else 0
        self.tp_coord = self.coords.get(tp_ax, 0) if tp_ax else 0
        self._cut = {a: (self.coords[a], self.shape[a]) for a in
                     (tp_ax, dp_ax) if a in self.shape}
        # a K/V leaf: tp cuts its head columns into G parts, the rank's
        # head the one of its query heads
        self._kv_cut = dict(self._cut)
        if self.kv_rep > 1:
            self._kv_cut[tp_ax] = (self.tp_coord // self.kv_rep, kv_heads)
        self.tp_axis = tp_ax

    @property
    def sliced(self) -> bool:
        """Does the rank hold any parameter as its dp slice (ZeRO-3)?"""
        return any(k is not None for k in self.fsdp_dims)

    def fsdp_tree(self):
        """``fsdp_dims`` as a tree shaped as the parameter tree (None
        where a leaf is whole), or None when no leaf is cut over dp."""
        return tree_unflatten(self._structure, self.fsdp_dims) \
            if self.sliced else None

    def cut(self, tree):
        """A whole tree (global leaves) -> this rank's (:meth:`cut_leaf`
        of every leaf)."""
        return tree_unflatten(tree, [self.cut_leaf(a, i) for i, a in
                                     enumerate(tree_leaves(tree))])

    def cut_leaf(self, a: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` (its rank-local dimensions, whole) cut to the rank's
        tp shard and dp slice, as its own contiguous copy."""
        return self.local_view(a, i).clone(
            memory_format=torch.contiguous_format)

    def local_view(self, a: torch.Tensor, i: int) -> torch.Tensor:
        """The rank's part of leaf ``i`` (its rank-local dimensions,
        whole), as a view: :meth:`cut_leaf` without the copy."""
        return local_shard(a, self.cut_specs[i],
                           self._kv_cut if self.kv[i] else self._cut)

    def part_slices(self, i: int, state: bool = False) -> List[slice]:
        """Where the rank's part of leaf ``i`` lies in its local
        dimensions (whole): the slices :meth:`local_view` cuts, and with
        ``state`` also the dp slice :meth:`zero_slice` narrows that to
        (the rank's part of the leaf's optimizer state)."""
        local = self.shapes[i][self.dropped[i]:]
        out = shard_slices(local, self.cut_specs[i],
                           self._kv_cut if self.kv[i] else self._cut)
        k = self.zero_dims[i]
        if state and k is not None and self.fsdp_dims[i] is None \
                and self.dp > 1:
            n = (out[k].stop - out[k].start) // self.dp
            start = out[k].start + self.dp_coord * n
            out[k] = slice(start, start + n)
        return out

    def writes(self, i: int, state: bool = False) -> bool:
        """Is the rank the one of the ranks holding the same elements of
        leaf ``i`` (of its parameter, or with ``state`` of its state
        slice) that writes them, so each element is written once: the
        tp-replicated parts on tp coordinate 0 (a K/V head on its group's
        first rank), the dp-whole ones on dp coordinate 0 (for the state
        :meth:`counts`)."""
        if state:
            return self.counts(i)
        if self.tp_coord % (self.tp // self.tp_parts[i]):
            return False
        return self.fsdp_dims[i] is not None or self.dp_coord == 0

    def zero_slice(self, a: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` (a rank leaf) narrowed to the rank's dp slice where
        its state is sliced (a view), else the leaf; a leaf the rank
        holds as its dp slice is that slice already."""
        k = self.zero_dims[i]
        if k is None or self.fsdp_dims[i] is not None:
            return a
        n = a.shape[k] // self.dp
        return a.narrow(k, self.dp_coord * n, n)

    def zero_views(self, tree):
        """The rank tree's leaves narrowed to the dp slices the rank
        updates (views)."""
        return tree_unflatten(tree, [self.zero_slice(a, i) for i, a in
                                     enumerate(tree_leaves(tree))])

    def owned(self, g: torch.Tensor, i: int) -> Optional[torch.Tensor]:
        """The part of gradient leaf ``i`` the rank counts in the clip
        norm, so that every element counts once over the mesh: its dp
        slice (or the whole leaf on dp coordinate 0 where the state is
        whole), a tp-replicated leaf on tp coordinate 0 only and a
        replicated K/V head on its group's first rank; None where the
        rank counts nothing."""
        return self.zero_slice(g, i) if self.counts(i) else None

    def counts(self, i: int) -> bool:
        """Does the rank count its part of leaf ``i`` in a sum over the
        mesh (:meth:`owned`): not a tp-replicated leaf off tp coordinate
        0, not a K/V head off its group's first rank, not a dp-whole one
        off dp coordinate 0."""
        if self.tp_coord % (self.tp // self.tp_parts[i]):
            return False
        return self.zero_dims[i] is not None or self.dp_coord == 0

    def kv_sum(self, mesh, grads) -> None:
        """Sum, in place, the gradients of the replicated K/V leaves over
        their K/V groups (``grads``: the rank's gradient leaves in
        ``tree_leaves`` order, contiguous; the whole leaf or its dp
        slice): each rank's is the part of its own query heads, and the
        group's ranks share the head.  The weights' gradients, not the
        K/V activations': the input's gradient was summed over tp by its
        ``copy_to_tp``."""
        for g, kv in zip(grads, self.kv):
            if kv:
                mesh.all_reduce(g, self.tp_axis, span=self.kv_rep)

    def reduce_grad(self, mesh, g: torch.Tensor, i: int) -> torch.Tensor:
        """A rank's gradient of leaf ``i`` summed over dp into the part
        its state covers: reduce-scattered to the dp slice where the
        state is sliced, all-reduced where it is whole, as it is where the
        leaf is held as a slice (its gather's backward summed it)."""
        if self.dp == 1 or self.fsdp_dims[i] is not None:
            return g
        k = self.zero_dims[i]
        if k is None:
            return mesh.all_reduce(g.contiguous(), "data")
        return mesh.reduce_scatter([g], "data", [k])[0]

    def gather_weights(self, mesh, params) -> None:
        """After an update of the dp slices: every leaf whose state is
        sliced and whose parameter is whole all-gathered over dp into the
        whole leaf (ZeRO-1's weight all-gather; a leaf held as its slice
        needs none)."""
        if self.dp == 1:
            return
        for i, a in enumerate(tree_leaves(params)):
            k = self.zero_dims[i]
            if k is None or self.fsdp_dims[i] is not None:
                continue
            n = a.shape[k] // self.dp
            mine = a.narrow(k, self.dp_coord * n, n).contiguous()
            outs = [torch.empty_like(mine) for _ in range(self.dp)]
            mesh.all_gather_into(outs, mine, "data")
            for j, o in enumerate(outs):
                if j != self.dp_coord:
                    a.narrow(k, j * n, n).copy_(o)


KV_LEAVES = ("wk", "wv", "bk", "bv")


def is_kv_path(path) -> bool:
    """Is the leaf at ``path`` a K/V projection of an attention
    (``attn``: self-attention, the encoder's too; ``cross``: an
    encoder-decoder's cross-attention)?"""
    return len(path) >= 2 and path[-1] in KV_LEAVES \
        and path[-2] in ("attn", "cross")


def _on_last(spec, ndim: int, axis) -> Spec:
    """``spec`` over ``ndim`` dimensions with ``axis`` on the last one
    (a K/V leaf's head columns)."""
    sp = list(spec) + [None] * (ndim - len(spec))
    sp[-1] = axis
    return tuple(sp)


def names_axis(spec, axis) -> bool:
    """Does ``spec`` put mesh axis ``axis`` on any dimension?"""
    if axis is None:
        return False
    for ax in spec:
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return True
    return False


def spec_leaves(tree):
    """The specs of a spec tree in ``tree_leaves`` order (a spec tuple is
    a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in spec_leaves(t)]
    return [tree]
