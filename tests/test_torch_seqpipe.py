"""The port's sequence-chunked path against the JAX package: the
``seq1f1b`` and ``chronos_seq`` schedules and tables (every column,
forward-only tables too), chunked flash attention and ``merge_kv``, and
pipeline gradients on the reduced tinyllama (4 layers, d 128, fp32),
P=2, m=4, two sequences of 17 tokens per microbatch (16 positions: 2 or
4 chunks), against ``jax.grad`` of the JAX ``LM.loss`` (the reference's
seq executor is no oracle on this JAX version).  Weights come from the
JAX package's ``init_pipeline_params`` and cross as numpy; tokens, masks
and attention inputs are made with numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.core.schedules import get_schedule as jax_get_schedule
from repro.core.tasktable import build_task_table as jax_build_task_table
from repro.models import LM as JaxLM
from repro.seqpipe.attention import \
    chunked_flash_attention as jax_chunked_flash_attention
from repro.seqpipe.attention import merge_kv as jax_merge_kv
from repro.seqpipe.schedules import forward_only as jax_forward_only
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, RecomputeConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                               make_train_grads_fn,
                                               unstage_params)
from repro_torch.core.schedules import get_schedule
from repro_torch.core.tasktable import build_task_table, validate_table
from repro_torch.launch.train import train_pipeline
from repro_torch.seqpipe.attention import chunked_flash_attention, merge_kv
from repro_torch.seqpipe.schedules import forward_only
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, M, MBB, SEQ = 2, 4, 2, 17
# chunked vs whole-sequence gradients in fp32: the chunk losses are
# partial sums over a fixed denominator and the dK/dV of a prefix adds
# up chunk by chunk (read up to 5.7e-7 on a CPU)
GRAD_TOL = 2e-5
LOSS_TOL = 1e-5           # per-step loss, chunked vs whole-sequence
OFFLOAD_LOSS_TOL = 5e-3   # the offload pairs' bound (test_torch_offload)

CFG = get_reduced("tinyllama-1.1b")
JCFG = jax_get_reduced("tinyllama-1.1b")

# (name, kwargs) of every sequence-chunked generator tested
SEQ_CASES = [("seq1f1b", {"n_seq": 2}), ("seq1f1b", {"n_seq": 4}),
             ("seq1f1b", {"n_seq": 2, "split": True}),
             ("chronos_seq", {"v": 2, "n_seq": 2}),
             ("chronos_seq", {"v": 2, "n_seq": 2, "recomp_chunks": 1})]


def _case_id(c):
    return c[0] + "-" + "-".join(f"{k}{v}" for k, v in c[1].items())


@pytest.mark.parametrize("size", [(2, 4), (4, 8)], ids=["P2m4", "P4m8"])
@pytest.mark.parametrize("case", SEQ_CASES, ids=_case_id)
def test_seq_schedule_and_tables_match_jax(case, size):
    """Tasks (with ``seq``), peak activation and the compiled tables —
    every column of ``arrays()`` including ``seq`` and ``kv_slot``, and
    every ring depth — for the training schedule and its forward-only
    derivation, with both wires."""
    (name, kw), (P_, m) = case, size
    ours, ref = get_schedule(name, P_, m, **kw), jax_get_schedule(
        name, P_, m, **kw)

    def tasks(s):
        return sorted((t.kind, t.mb, t.chunk, t.stage, t.seq, t.start,
                       t.dur, t.recomp) for t in s.tasks)
    assert (ours.name, ours.n_seq, ours.v, ours.w) == \
        (ref.name, ref.n_seq, ref.v, ref.w)
    assert tasks(ours) == tasks(ref) and ours.n_seq == kw["n_seq"]
    assert ours.peak_activation() == ref.peak_activation()
    assert ours.bubble_ratio() == ref.bubble_ratio()
    fo, jfo = forward_only(ours), jax_forward_only(ref)
    assert tasks(fo) == tasks(jfo) and fo.name == jfo.name
    for s, js in ((ours, ref), (fo, jfo)):
        for overlap in (False, True):
            tab = build_task_table(s, overlap=overlap)
            jtab = jax_build_task_table(js, overlap=overlap)
            validate_table(tab)
            np.testing.assert_array_equal(tab.arrays(), jtab.arrays())
            for attr in ("T", "fq_depth", "bq_depth", "act_depth",
                         "kv_depth", "wstash_depth", "rmt_depth", "n_seq",
                         "fwd_only", "placement_name"):
                assert getattr(tab, attr) == getattr(jtab, attr), attr


def test_chunked_flash_attention_and_merge_kv_match_jax():
    """Each query chunk at its offset over the full buffer equals the
    JAX function's rows, and ``merge_kv``'s and the attention's
    gradients (dq, and dK/dV over the whole buffer, exactly zero past
    the causal frontier) equal ``jax.grad`` of the JAX pair."""
    rng = np.random.default_rng(0)
    B, S, H, G, d, Sc = 1, 16, 4, 2, 16, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, H, d), (B, S, G, d), (B, S, G, d)))
    buf = {n: rng.standard_normal((B, S, G, d)).astype(np.float32)
           for n in ("k", "v")}
    do = rng.standard_normal((B, Sc, H, d)).astype(np.float32)
    for q0 in (0, Sc):
        def jax_f(qc, kn, vn, kb, vb):
            kv = jax_merge_kv({"k": kb, "v": vb}, kn, vn, q0)
            return jnp.sum(jax_chunked_flash_attention(
                qc, kv["k"], kv["v"], q_offset=q0) * do)
        args = (q[:, q0:q0 + Sc], k[:, q0:q0 + Sc], v[:, q0:q0 + Sc],
                buf["k"], buf["v"])
        jo = jax_chunked_flash_attention(
            *[jnp.asarray(a) for a in (args[0],)],
            *jax_merge_kv({"k": args[3], "v": args[4]}, args[1], args[2],
                          q0).values(), q_offset=q0)
        jg = jax.grad(jax_f, argnums=(0, 1, 2, 3, 4))(
            *[jnp.asarray(a) for a in args])
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
        kv = merge_kv({"k": ts[3], "v": ts[4]}, ts[1], ts[2], q0)
        o = chunked_flash_attention(ts[0], kv["k"], kv["v"], q_offset=q0)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=0, atol=1e-5)
        (o * torch.from_numpy(do)).sum().backward()
        for t, g in zip(ts, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=0, atol=1e-5)
        # the buffer's cotangent past the frontier, and at the chunk's
        # own rows (taken by the new K/V), is exactly zero
        for t in ts[3:]:
            assert (t.grad[:, q0:] == 0).all()
        # the rows equal full-sequence attention's
        full = chunked_flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_offset=0)
        kvf = merge_kv({n: torch.from_numpy(buf[n]) for n in ("k", "v")},
                       torch.from_numpy(k[:, :q0 + Sc]),
                       torch.from_numpy(v[:, :q0 + Sc]), 0)
        o2 = chunked_flash_attention(torch.from_numpy(q[:, q0:q0 + Sc]),
                                     kvf["k"], kvf["v"], q_offset=q0)
        torch.testing.assert_close(o2, full[:, q0:q0 + Sc], rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the executor against jax.grad
# ---------------------------------------------------------------------------

def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (M, MBB, SEQ)).astype(np.int32)


def _mask(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(M, MBB, SEQ - 1)) > 0.3).astype(np.float32)


_BRIDGED = {}


def _bridged(v):
    if v not in _BRIDGED:
        params, _ = jax_init_pipeline_params(
            jax.random.key(0), JCFG, JaxStageLayout.build(JCFG, P, v))
        _BRIDGED[v] = jax.tree.map(np.asarray, params)
    return lm_params_from_numpy(_BRIDGED[v], "cpu")


def _jax_total_loss(p, tokens, mask):
    lm = JaxLM(JCFG)
    return sum(lm.loss(p, {"tokens": tokens[i], "loss_mask": mask[i]})[0]
               for i in range(tokens.shape[0]))


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_total_loss))

# (schedule, v, n_seq, extra generator kwargs)
EXEC_CASES = [("chronos_seq", 2, 2, {}),
              ("chronos_seq", 2, 2, {"recomp_chunks": 1}),
              ("seq1f1b", 1, 2, {}), ("seq1f1b", 1, 4, {})]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", EXEC_CASES,
                         ids=lambda c: f"{c[0]}-s{c[2]}"
                         + ("-rc1" if c[3] else ""))
def test_seq_grads_match_jax_autodiff(case, masked):
    schedule, v, ns, kw = case
    spec = make_pipeline_spec(CFG, P=P, v=v, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule, n_seq=ns,
                              kernels="fused", **kw)
    assert spec.table.n_seq == ns and spec.table.kv_depth
    params = _bridged(v)
    mask = _mask() if masked else np.ones((M, MBB, SEQ - 1), np.float32)
    batch = {"tokens": torch.from_numpy(_tokens())}
    if masked:
        batch["loss_mask"] = torch.from_numpy(mask)
    fn = make_train_grads_fn(spec, "cpu")
    grads, metrics = fn(params, batch)
    full = np.concatenate([np.ones((M, MBB, 1), np.float32), mask], -1)
    loss, ref = _jax_value_and_grad(
        jax.tree.map(jnp.asarray, tree_map(
            lambda a: a.numpy().copy(), unstage_params(params, spec.layout))),
        _tokens(), full)
    ours = tree_leaves(unstage_params(grads, spec.layout))
    errs = [abs(float(metrics["loss"]) - float(loss) / M)] + [
        float(np.abs(a.numpy() - np.asarray(b)).max())
        for a, b in zip(ours, jax.tree.leaves(ref))]
    print(f"{spec.table.name} {'masked' if masked else 'unmasked'}: max "
          f"|port - jax.grad| = {max(errs):.3e}")
    assert len(ours) == len(jax.tree.leaves(ref))
    assert max(errs) <= GRAD_TOL
    assert metrics["n_microbatches"] == M
    # the KV-carry and dKV rings: one full-sequence slot per in-flight
    # microbatch, per device and chunk
    lay = spec.layout
    kv_shape = (lay.M, lay.period, MBB, SEQ - 1, CFG.num_kv_heads,
                CFG.resolved_head_dim)
    for name in ("kv", "dkv"):
        for d in range(P):
            assert {c: tuple(r["k"].shape) for c, r in
                    fn.rings[name][d].items()} == {
                c: (k,) + kv_shape for c, k in spec.table.kv_depth.items()}
    assert tuple(fn.rings["fq"][0].shape[1:]) == \
        (MBB, (SEQ - 1) // ns, CFG.d_model)


def _tc(schedule, v, ns, **plan):
    return TrainConfig(
        model=CFG, shape=ShapeConfig("t", SEQ, M * MBB, "train"),
        plan=ParallelPlan(schedule=schedule, num_chunks=v, seq_chunks=ns,
                          microbatch_size=MBB, num_microbatches=M,
                          kernels="fused", **plan),
        optimizer=OptimizerConfig(warmup_steps=1, total_steps=2, lr=1e-3,
                                  grad_clip=0.0), seed=5)


def test_train_pipeline_seq_matches_whole_sequence_chronos():
    """``train_pipeline`` with ``seq_chunks=2`` (chronos_seq, v=2) takes
    2 steps whose losses equal the whole-sequence chronos run's."""
    outs = [train_pipeline(_tc(s, 2, ns), P=P, device="cpu", steps=2,
                           params=_bridged(2), log=lambda s: None)
            for s, ns in (("chronos_seq", 2), ("chronos", 1))]
    print(f"chronos_seq {outs[0]['losses']} chronos {outs[1]['losses']}")
    np.testing.assert_allclose(outs[0]["losses"], outs[1]["losses"],
                               rtol=0, atol=LOSS_TOL)
    assert outs[0]["schedule"] == "chronos-seq(v=2,s=2)"
    assert outs[0]["losses"][1] < outs[0]["losses"][0]


def test_seq_offload_matches_on_device_training():
    """chronos_seq (n_seq=2) with the deep chunk's AdamW on the host
    against the same run on the device, 2 steps, clip off: step-1 losses
    equal, then within the offload pairs' 5e-3."""
    off = OffloadConfig(enabled=True, num_offload_chunks=1)
    runs = [train_pipeline(_tc("chronos_seq", 2, 2, **kw), P=P,
                           device="cpu", steps=2, params=_bridged(2),
                           log=lambda s: None)
            for kw in ({}, {"offload": off})]
    base, offl = (r["losses"] for r in runs)
    print(f"chronos_seq on-device {base}, offload {offl}")
    assert base[0] == offl[0]
    assert max(abs(a - b) for a, b in zip(base, offl)) <= OFFLOAD_LOSS_TOL
    assert runs[1]["offload"]["submits"] == 2


def test_recompute_plan_drives_chronos_seq():
    """``RecomputeConfig("chronos")`` gives chronos_seq its R tasks (the
    reference's ``plan_schedule_kwargs`` branch)."""
    from repro_torch.launch.steps import plan_schedule_kwargs
    plan = _tc("chronos_seq", 2, 2, recompute=RecomputeConfig(
        "chronos", num_recomp_chunks=1)).plan
    assert plan_schedule_kwargs(plan) == {"recomp_chunks": 1}
    assert plan_schedule_kwargs(dataclasses.replace(
        plan, recompute=RecomputeConfig("none"))) == {}


@pytest.mark.parametrize("what", ["not-seq", "ssm", "divisible", "split",
                                  "v"])
def test_make_pipeline_spec_refuses_what_the_reference_asserts(what):
    kw = dict(P=P, v=1, m=M, microbatch=MBB, seq_len=SEQ, n_seq=2,
              schedule="seq1f1b")
    cfg, match = CFG, None
    if what == "not-seq":
        kw.update(schedule="chronos", v=2)
        match = "not sequence-chunked"
    elif what == "ssm":
        cfg, match = get_reduced("mamba2-2.7b"), "dense attention"
    elif what == "divisible":
        kw.update(seq_len=16)
        match = "not divisible"
    elif what == "split":
        kw.update(split=True)
        match = "split-backward"
    else:
        kw.update(v=2)
        match = "constructs v=1"
    with pytest.raises(ValueError, match=match):
        make_pipeline_spec(cfg, **kw)
