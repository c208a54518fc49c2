"""The port's AdamW, its learning-rate schedules and the fused-AdamW
kernel's plain version against the JAX package (its Pallas kernel in
interpret mode).  Inputs are made with numpy from a seed and handed to
both sides.

Tolerances: the two sides compute the same fp32 operations in the same
order; they may differ by an ulp where the libraries round ``pow`` /
``cos`` differently (the step's bias corrections and learning rate),
which Adam's normalised step carries into the weights at ~1e-7
relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.kernels.fused_adamw.kernel import \
    fused_adamw_flat as jax_fused_adamw_flat
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.schedules import lr_at as jax_lr_at
from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.fused_adamw import (fused_adamw_flat,
                                             fused_adamw_flat_ref)
from repro_torch.optim import adamw_init, adamw_update, cast_like, lr_at
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR_RTOL = 1e-6
STATE_TOL = 1e-6          # mu, nu, master after 5 steps (atol)
KERNEL_TOL = 1e-6         # one kernel pass (atol)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=3, total_steps=11, schedule=schedule,
              min_lr_ratio=0.1)
    ours = [float(lr_at(OptimizerConfig(**kw), torch.tensor(s)))
            for s in range(14)]
    ref = [float(jax_lr_at(JaxOptimizerConfig(**kw), jnp.int32(s)))
           for s in range(14)]
    np.testing.assert_allclose(ours, ref, rtol=LR_RTOL, atol=0)
    assert ours[0] == 0.0 and max(ours) == pytest.approx(3e-4, rel=1e-6)


def _tree(rng):
    """A parameter tree with fp32 and bf16 leaves, matrices (decayed) and
    vectors (not decayed)."""
    return {"attn": {"wq": rng.standard_normal((16, 24)).astype(np.float32),
                     "scale": (1 + 0.1 * rng.standard_normal(24)
                               ).astype(np.float32)},
            "mlp": [rng.standard_normal((3, 8, 16)).astype(np.float32)],
            "bias": rng.standard_normal(5).astype(np.float32)}


BF16_LEAVES = ("mlp",)        # these leaves are bf16 parameters


def _to_jax(tree):
    return {k: jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.bfloat16 if k in BF16_LEAVES else jnp.float32), v)
        for k, v in tree.items()}


def _to_torch(tree):
    return {k: tree_map(lambda a: torch.from_numpy(a).to(
        torch.bfloat16 if k in BF16_LEAVES else torch.float32), v)
        for k, v in tree.items()}


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel-wrapper", "plain-update"])
def test_adamw_five_steps_match_jax_kernel_path(use_kernel):
    """5 steps with active clipping and the decay mask; the port's kernel
    wrapper (its plain version here) and its plain update both against
    JAX's ``use_kernel=True`` (Pallas interpret)."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5,
              weight_decay=0.1)
    jp = _to_jax(p0)
    jstate = jax_adamw_init(jp)
    tp = _to_torch(p0)
    leaves0 = tree_leaves(tp)
    tstate = adamw_init(tp)
    for step in range(5):
        g = _tree(rng)                          # gradient norm > grad_clip
        jm, jstate, jmet = jax_adamw_update(
            _to_jax(g), jstate, JaxOptimizerConfig(**kw), use_kernel=True)
        jp = jax.tree.map(lambda m, p: m.astype(p.dtype), jm, jp)
        tm, tstate, tmet = adamw_update(_to_torch(g), tstate,
                                        OptimizerConfig(**kw),
                                        use_kernel=use_kernel)
        assert cast_like(tm, tp) is tp
        assert float(jmet["grad_norm"]) > kw["grad_clip"]
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=LR_RTOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    worst = 0.0
    for key in ("mu", "nu", "master"):
        for a, b in zip(tree_leaves(tstate[key]),
                        jax.tree.leaves(jstate[key])):
            worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
    print(f"max |port - jax| over mu, nu, master after 5 steps: {worst:.3e}")
    assert worst <= STATE_TOL
    # model-dtype parameters, written in place: the same leaf tensors,
    # bf16 leaves stay bf16 and hold their master rounded to bf16, fp32
    # leaves equal their master without aliasing it
    assert all(a is b for a, b in zip(tree_leaves(tp), leaves0))
    assert tp["mlp"][0].dtype == torch.bfloat16
    for p_, m_ in zip(tree_leaves(tp), tree_leaves(tstate["master"])):
        assert torch.equal(p_, m_.to(p_.dtype))
    assert tp["attn"]["wq"] is not tstate["master"]["attn"]["wq"]


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_fused_adamw_flat_ref_matches_pallas(g_dtype):
    """n = 70001 is not a multiple of the TPU kernel's 65536 block."""
    n = 70001
    rng = np.random.default_rng(1)
    g = rng.standard_normal(n).astype(np.float32)
    mu = (0.1 * rng.standard_normal(n)).astype(np.float32)
    nu = (0.01 * rng.random(n)).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    lr, bc1, bc2, wd = 3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3, 0.1
    jg = jnp.asarray(g).astype(getattr(jnp, g_dtype))
    jmu, jnu, jw = jax_fused_adamw_flat(
        jg, jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(w),
        lr=jnp.float32(lr), b1=0.9, b2=0.95, eps=1e-8, bc1=bc1, bc2=bc2,
        wd=wd, interpret=True)
    tg = torch.from_numpy(g).to(getattr(torch, g_dtype))
    tmu, tnu, tw = (torch.from_numpy(a.copy()) for a in (mu, nu, w))
    scalars = torch.tensor([lr, bc1, bc2], dtype=torch.float32)
    before = fused_adamw_flat.launches
    out = fused_adamw_flat(tg, tmu, tnu, tw, scalars, b1=0.9, b2=0.95,
                           eps=1e-8, wd=wd)
    assert fused_adamw_flat.launches == before      # plain version, no kernel
    assert out[0] is tmu and out[2] is tw           # updated in place
    worst = max(float(np.abs(a.numpy() - np.asarray(b)).max())
                for a, b in zip((tmu, tnu, tw), (jmu, jnu, jw)))
    print(f"max |port - pallas| = {worst:.3e}")
    assert worst <= KERNEL_TOL


def test_fused_adamw_ref_is_the_wrapper_on_cpu():
    rng = np.random.default_rng(2)
    a = [torch.from_numpy(rng.standard_normal(33).astype(np.float32))
         for _ in range(4)]
    a[2] = a[2].abs()
    b = [x.clone() for x in a]
    sc = torch.tensor([1e-3, 0.1, 0.05])
    fused_adamw_flat(a[0], a[1], a[2], a[3], sc, b1=0.9, b2=0.95, eps=1e-8,
                     wd=0.0)
    fused_adamw_flat_ref(b[0], b[1], b[2], b[3], sc, b1=0.9, b2=0.95,
                         eps=1e-8, wd=0.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_adamw_step_counter_and_metrics_stay_on_device():
    cfg = dataclasses.replace(OptimizerConfig(), warmup_steps=1)
    params = {"w": torch.ones((4, 4))}
    st = adamw_init(params)
    assert st["master"]["w"] is not params["w"]          # a copy
    _, st, met = adamw_update({"w": torch.full((4, 4), 0.5)}, st, cfg)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    assert isinstance(met["lr"], torch.Tensor)
    assert isinstance(met["grad_norm"], torch.Tensor)
    assert float(met["grad_norm"]) == pytest.approx(2.0)


def test_adamw_reads_bf16_grads_as_the_reference_does():
    """``grad_div=m`` on bf16 gradient leaves (the pipeline's bf16 block
    accumulators): the norm and the update read ``g.float() / m`` leaf by
    leaf, bitwise what dividing fp32 copies beforehand gives, and the
    step matches JAX's ``adamw_update`` of ``g.astype(f32) / m``.  The
    bf16 leaves are left as they were."""
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, grad_clip=0.5,
              weight_decay=0.1)
    g = _tree(rng)
    m = 3.0
    tg = _to_torch(jax.tree.map(np.copy, g))    # fp32 leaves divided in place
    kept = {k: tree_map(torch.clone, v) for k, v in tg.items()}
    ours = adamw_update(tg, adamw_init(_to_torch(p0)), OptimizerConfig(**kw),
                        grad_div=torch.tensor(m))
    wide = tree_map(lambda a: a.float() / m, _to_torch(g))
    pre = adamw_update(wide, adamw_init(_to_torch(p0)),
                       OptimizerConfig(**kw))
    jm, _, jmet = jax_adamw_update(
        jax.tree.map(lambda a: a.astype(jnp.float32) / m, _to_jax(g)),
        jax_adamw_init(_to_jax(p0)), JaxOptimizerConfig(**kw),
        use_kernel=True)
    assert float(ours[2]["grad_norm"]) == float(pre[2]["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ours[0]),
                                                 tree_leaves(pre[0])))
    np.testing.assert_allclose(float(ours[2]["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    worst = max(float(np.abs(a.numpy() - np.asarray(b)).max())
                for a, b in zip(tree_leaves(ours[0]), jax.tree.leaves(jm)))
    assert worst <= STATE_TOL
    assert torch.equal(tg["mlp"][0], kept["mlp"][0])


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_plain_update_in_slabs_is_bitwise_the_whole_leaf(monkeypatch,
                                                         g_dtype):
    """The plain update over slabs of 7 elements (leaves of 6 to 300
    elements, one gradient a strided view as an offload run's shallow
    half is, clip and ``grad_div`` on) equals, bitwise, the update over
    whole leaves (``use_kernel=True``: on CPU tensors the kernel's plain
    version over each whole leaf), in mu, nu and the masters, for three
    steps."""
    from repro_torch.optim import adamw as adamw_mod
    gen = torch.Generator().manual_seed(3)

    def rn(*shape):
        return torch.randn(*shape, generator=gen)
    params = {"w": rn(4, 1, 5, 6), "b": rn(6), "e": rn(30, 10)}
    cfg = OptimizerConfig(warmup_steps=1, total_steps=5, grad_clip=0.5)
    states = [adamw_init(params) for _ in range(2)]
    m = torch.tensor(3.0)
    monkeypatch.setattr(adamw_mod, "SLAB", 7)
    for _ in range(3):
        full = {"w": rn(4, 2, 5, 6), "b": rn(6), "e": rn(30, 10)}
        for state, use_kernel in zip(states, (False, True)):
            grads = {k: v.clone().to(g_dtype) for k, v in full.items()}
            grads["w"] = grads["w"][:, :1]            # strided view
            adamw_update(grads, state, cfg, use_kernel=use_kernel,
                         grad_div=m)
    for name in ("mu", "nu", "master"):
        for a, b in zip(tree_leaves(states[0][name]),
                        tree_leaves(states[1][name])):
            assert torch.equal(a, b), name
