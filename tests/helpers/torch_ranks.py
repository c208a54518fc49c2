"""Rank bodies for ``tests/test_torch_ranks.py``: what each spawned gloo
rank runs (``repro_torch.launch.mesh.spawn`` pickles these by name), and
the same computation on one device for the pairs.  Imports torch and the
port only, so a rank starts without JAX.

A case is a dict: ``arch`` (a reduced config), ``kw`` (the keywords of
``make_pipeline_spec``), ``params`` (a stage-stacked numpy tree, e.g. the
JAX package's ``init_pipeline_params`` bits, or None for the port's own
init from seed 0), ``tokens`` (numpy ``[m, mbB, seq_len]``) and
``steps`` (calls of the gradient function, the error feedback threaded
through them under ``grad_psum_bits``)."""
import time

import numpy as np
import torch

from repro_torch.bridge import lm_params_from_numpy, rank_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               init_psum_ef,
                                               make_pipeline_spec,
                                               make_train_grads_fn,
                                               rank_params)
from repro_torch.tree import tree_map


def case(arch="tinyllama-1.1b", params=None, tokens=None, steps=1, **kw):
    """A case of the reduced ``arch`` (P=2, v=2, m=4, two sequences of
    17 tokens a microbatch, chronos, unless ``kw`` says otherwise)."""
    kw = {**dict(P=2, v=2, m=4, microbatch=2, seq_len=17,
                 schedule="chronos"), **kw}
    if tokens is None:
        tokens = np.random.default_rng(1).integers(
            0, get_reduced(arch).vocab_size,
            (kw["m"], kw["microbatch"], kw["seq_len"]))
    return {"arch": arch, "kw": kw, "params": params,
            "tokens": np.asarray(tokens, dtype=np.int64), "steps": steps}


def _spec(c):
    return make_pipeline_spec(get_reduced(c["arch"]), kernels="plain",
                              **c["kw"])


def _params(c, spec, rank=None):
    if c["params"] is not None:
        if rank is None:
            return lm_params_from_numpy(c["params"], "cpu")
        return rank_params_from_numpy(c["params"], rank, "cpu")
    full = init_pipeline_params(torch.Generator().manual_seed(0), spec.cfg,
                                spec.layout, "cpu")
    return full if rank is None else rank_params(full, rank)


def _run(c, spec, params, fn, rank=None):
    batch = {"tokens": torch.from_numpy(c["tokens"])}
    ef = init_psum_ef(spec, params, rank=rank) \
        if spec.grad_psum_bits else None
    for _ in range(c["steps"]):
        res = fn(params, batch, ef)
        if ef is not None:
            ef = res[2]
    return {"g": res[0], "loss": res[1]["loss"], "ef": ef,
            "scale": res[1].get("psum_scale")}


def one_device(c):
    """The case on the port's one-device executor."""
    spec = _spec(c)
    return _run(c, spec, _params(c, spec), make_train_grads_fn(spec, "cpu"))


def grads_on_ranks(mesh, cases):
    """A rank's gradients, loss and error feedback for every case (the
    rank's block leaves ``[v, M, ...]``), with the exchange's counters."""
    torch.set_num_threads(1)
    out = []
    for c in cases:
        spec = _spec(c)
        fn = make_train_grads_fn(spec, "cpu", mesh=mesh)
        res = _run(c, spec, _params(c, spec, mesh.rank), fn, mesh.rank)
        out.append({**res, "exchange": fn.exchange.stats()})
    return out


def train_on_rank(mesh, tc, P, kw):
    """``train_pipeline(tc, P=P, mesh=mesh, **kw)`` on one torch thread
    (two ranks share the test worker's cores), the rank's parameters on
    the CPU in the result, and ``replicas_equal`` per step."""
    from repro_torch.launch.train import replicas_equal, train_pipeline
    torch.set_num_threads(1)
    equal = []
    out = train_pipeline(tc, P=P, mesh=mesh, after_step=lambda _, p, o, s: (
        equal.append(replicas_equal(mesh, p, o, s))), **kw)
    return {**{k: v for k, v in out.items()
               if k not in ("params", "opt_state", "wire")},
            "replicas_equal": equal,
            "params": tree_map(lambda a: a.detach().cpu(), out["params"])}


def quiet(line):
    """A log that drops every line (picklable, unlike a lambda)."""


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.all_reduce(torch.ones(1))
    return mesh.rank


def hang(mesh):
    """Every rank sleeps past any test's timeout."""
    time.sleep(600)
