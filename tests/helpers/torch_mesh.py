"""Rank bodies for ``tests/test_torch_mesh.py``: what each spawned gloo
rank of a ``pp x dp x tp`` mesh runs (``repro_torch.launch.mesh.spawn``
pickles these by name), and the same computation on one device for the
pairs.  Imports torch and the port only, so a rank starts without JAX.

A case is a dict: ``arch`` (a reduced config), ``cfg`` (fields replaced
in it, e.g. the vocab), ``kw`` (the keywords of ``make_pipeline_spec``,
``microbatch`` a dp rank's share), ``params`` (a stage-stacked numpy
tree, e.g. the JAX package's ``init_pipeline_params`` bits, or None for
the port's own init from seed 0), ``tokens`` (numpy ``[m, mbB * dp,
seq_len]``, the global batch), ``mask`` (numpy ``[m, mbB * dp,
seq_len - 1]`` or None) and ``embeds`` (a VLM's ``patch_embeds`` or an
encoder-decoder's ``frame_embeds``, numpy ``[m, mbB * dp, P or T, d]``
fp32 from seed 2; empty for the other configs)."""
import dataclasses

import numpy as np
import torch

from repro_torch.bridge import lm_params_from_numpy, rank_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.core.pipeline_runtime import (RankShard,
                                               init_pipeline_params,
                                               make_pipeline_spec,
                                               make_train_grads_fn,
                                               rank_params)
from repro_torch.models.sharding import join_shards
from repro_torch.tree import tree_leaves, tree_unflatten


def case(arch="tinyllama-1.1b", dp=2, params=None, tokens=None, mask=None,
         cfg=None, **kw):
    """A case of the reduced ``arch`` (P=2, v=2, m=4, two sequences of
    17 tokens a dp rank a microbatch, chronos_zb, unless ``kw`` says
    otherwise), tokens from numpy seed 1."""
    kw = {**dict(P=2, v=2, m=4, microbatch=2, seq_len=17,
                 schedule="chronos_zb"), **kw}
    c = {"arch": arch, "cfg": cfg or {}, "kw": kw, "params": params,
         "mask": mask}
    if tokens is None:
        tokens = np.random.default_rng(1).integers(
            0, config(c).vocab_size,
            (kw["m"], kw["microbatch"] * dp, kw["seq_len"]))
    c["tokens"] = np.asarray(tokens, dtype=np.int64)
    cf, lead = config(c), c["tokens"].shape[:2]
    rng = np.random.default_rng(2)
    c["embeds"] = {}
    if cf.vision is not None:
        c["embeds"]["patch_embeds"] = rng.standard_normal(
            lead + (cf.vision.num_patches, cf.d_model)).astype(np.float32)
    if cf.encdec is not None:
        c["embeds"]["frame_embeds"] = rng.standard_normal(
            lead + (cf.encdec.num_frames, cf.d_model)).astype(np.float32)
    return c


def config(c):
    return dataclasses.replace(get_reduced(c["arch"]), **c["cfg"])


def spec_of(c, dp=1):
    """The case's spec; ``dp``: the one-device run's global microbatch
    (``microbatch * dp``)."""
    kw = dict(c["kw"])
    kw["microbatch"] *= dp
    return make_pipeline_spec(config(c), kernels="fused", **kw)


def batch_of(c):
    b = {"tokens": torch.from_numpy(c["tokens"]),
         **{k: torch.from_numpy(a) for k, a in c["embeds"].items()}}
    if c["mask"] is not None:
        b["loss_mask"] = torch.from_numpy(np.asarray(c["mask"], np.float32))
    return b


def full_params(c, spec):
    if c["params"] is not None:
        return lm_params_from_numpy(c["params"], "cpu")
    return init_pipeline_params(torch.Generator().manual_seed(0), spec.cfg,
                                spec.layout, "cpu")


def one_device(c, dp):
    """The case on the port's one-device executor, the global batch."""
    spec = spec_of(c, dp)
    g, met = make_train_grads_fn(spec, "cpu")(full_params(c, spec),
                                              batch_of(c))
    return {"g": g, "loss": met["loss"]}


def shard_of(spec, mesh_shape, coords):
    from repro_torch.launch.mesh import MESH_RULES
    return RankShard(spec.cfg, spec.layout, mesh_shape, MESH_RULES, coords)


def grads_on_mesh(mesh, cases):
    """A rank's gradients (its pp column, tp shard), loss, coordinates
    and collective bytes by axis for every case."""
    torch.set_num_threads(1)
    out = []
    for c in cases:
        spec = spec_of(c)
        shard = shard_of(spec, mesh.shape, mesh.coords)
        p = mesh.coord("pp")
        if c["params"] is not None:
            params = rank_params_from_numpy(c["params"], p, "cpu",
                                            shard=shard)
        else:
            params = rank_params(full_params(c, spec), p, shard)
        fn = make_train_grads_fn(spec, "cpu", mesh=mesh)
        before = mesh.collective_bytes()
        g, met = fn(params, batch_of(c))
        after = mesh.collective_bytes()
        ex = fn.exchange.stats()
        out.append({"g": g, "loss": met["loss"], "coords": dict(mesh.coords),
                    "n": met["n_microbatches"],
                    "bytes": {a: after[a] - before[a]
                              + (ex["bytes_sent"] if a == "pp" else 0)
                              for a in after}})
    return out


def gather(spec, mesh_shape, ranks):
    """The global gradient tree from every rank's (``ranks``: one result
    a rank, rank order): each leaf joined over tp from its shards (a
    replicated K/V head from its group's first rank), the block leaves
    stacked over pp, the shared ones from pp 0 (dp 0)."""
    by = {(r["coords"]["pp"], r["coords"]["data"], r["coords"]["model"]): r
          for r in ranks}
    shard = shard_of(spec, mesh_shape, {"pp": 0, "data": 0, "model": 0})
    tp = mesh_shape["model"]
    leaves = []
    for i, (path, sp) in enumerate(zip(shard.paths, shard.cut_specs)):
        parts = shard.tp_parts[i]

        def col(p):
            return join_shards(
                lambda co: tree_leaves(by[p, 0, tp_rank(co, tp, parts)]
                                       ["g"])[i], sp, {"model": parts})
        if path[0] == "blocks":
            leaves.append(torch.stack([col(p)
                                       for p in range(mesh_shape["pp"])]))
        else:
            leaves.append(col(0))
    return tree_unflatten(init_pipeline_params(None, spec.cfg, spec.layout,
                                               "meta"), leaves)


def tp_rank(co, tp, parts):
    """The tp coordinate holding part ``co["model"]`` of a leaf that tp
    cuts into ``parts`` (a replicated K/V head: its group's first
    rank; a whole leaf: rank 0)."""
    return co.get("model", (0, 1))[0] * (tp // parts)


def mesh_suite(mesh, cases, runs):
    """On one rank: :func:`grads_on_mesh` of ``cases``, then each of
    ``runs`` (``(tc, P, kw)``) through ``train_rank`` (losses, norms,
    per-axis replica checks, collective bytes by axis)."""
    from repro_torch.launch.train import train_rank
    torch.set_num_threads(1)
    return {"grads": grads_on_mesh(mesh, cases),
            "train": [train_rank(mesh, tc, P, kw) for tc, P, kw in runs]}


def quiet(line):
    """A log that drops every line (picklable, unlike a lambda)."""
