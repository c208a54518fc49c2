"""The port's MoE path against the JAX package on the CPU: ``moe_ffn``
(routing, the load-balancing loss, the sort-based capacity dispatch with
its drops), ``LM.loss`` with its aux term for the reduced qwen2-moe,
grok-1 and jamba, and the pipeline executor's gradients with the aux sum
carried between virtual stages, against ``jax.grad`` of ``LM.loss``.

Weights come from the JAX package's inits and cross as numpy; inputs are
made with numpy from a seed.  Everything runs in fp32, where the two
sides differ only in the order of their sums (the combine's scatter-add
adds a token's k outputs in the same order on both CPUs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.models import LM as JaxLM
from repro.models import moe as JMOE
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                               make_train_grads_fn,
                                               unstage_params)
from repro_torch.models import LM
from repro_torch.models import moe as TMOE
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FFN_TOL = 1e-5            # moe_ffn output and gradients, relative to max
LB_TOL = 1e-6             # lb_loss (a mean of probabilities: sum order)
LOSS_TOL = 1e-5           # LM.loss, ce and aux
GRAD_TOL = 2e-5           # pipeline / LM.loss gradients, relative per leaf

D = 128
# name -> (MoEConfig kwargs, act, tokens [B, S]); "drops" routes every
# token's first pick to expert 0, which takes 80 of its 48 slots
FFN_CASES = {
    "qwen2-moe": (dict(num_experts=8, top_k=4, d_ff_expert=64,
                       num_shared_experts=2, d_ff_shared=32,
                       capacity_factor=8.0), "silu", (2, 24)),
    "drops": (dict(num_experts=4, top_k=2, d_ff_expert=64,
                   capacity_factor=1.0), "silu", (2, 40)),
    "grok-gelu": (dict(num_experts=4, top_k=2, d_ff_expert=64,
                       capacity_factor=8.0), "gelu", (2, 24)),
    "ties": (dict(num_experts=8, top_k=3, d_ff_expert=32,
                  num_shared_experts=1, d_ff_shared=32), "silu", (1, 16)),
}


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ffn_inputs(name):
    kw, act, (Bz, S) = FFN_CASES[name]
    p, _ = JMOE.init_moe(jax.random.key(len(name)), D, JaxMoEConfig(**kw),
                         act, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((Bz, S, D)).astype(np.float32)
    if name == "drops":
        x += 1.0
        p["router"] = p["router"].copy()
        p["router"][:, 0] = 0.1
    if name == "ties":
        p["router"] = np.zeros_like(p["router"])
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return kw, act, p, x, cot


@pytest.mark.parametrize("name", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(name):
    """Forward, ``lb_loss``, ``router_fraction_dropped`` (exactly, against
    the JAX function run op by op) and the gradients of ``sum(y * cot) +
    lb_loss`` in every parameter and the input, against the JAX
    ``moe_ffn``."""
    kw, act, p, x, cot = _ffn_inputs(name)
    jcfg, cfg = JaxMoEConfig(**kw), MoEConfig(**kw)

    def jloss(params, x_):
        y, aux = JMOE.moe_ffn(params, x_, jcfg, act)
        return (y * cot).sum() + aux["lb_loss"], (y, aux)
    jp = jax.tree.map(jnp.asarray, p)
    (_, (yj, _)), (gpj, gxj) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    # the aux values op by op, as the function is written (under jit XLA
    # takes the mean as a product with 1/n, one rounding away)
    _, auxj = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg, act)

    tp = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMOE.moe_ffn(tp, tx, cfg, act)
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum()
                                + aux["lb_loss"], leaves + [tx])
    dropped = float(aux["router_fraction_dropped"])
    lb = float(aux["lb_loss"].detach())
    errs = {"y": _rel(y, yj), "x": _rel(grads[-1], gxj)}
    errs.update({f"d{i}": _rel(g, r) for i, (g, r) in enumerate(
        zip(grads, jax.tree.leaves(gpj)))})
    e_lb = abs(lb - float(auxj["lb_loss"]))
    print(f"{name}: dropped {dropped:.4f}, lb |d| {e_lb:.2e}, worst rel "
          f"{max(errs.values()):.2e} ({max(errs, key=errs.get)})")
    assert dropped == float(auxj["router_fraction_dropped"])
    assert (dropped > 0) == (name == "drops")
    assert e_lb <= LB_TOL
    assert max(errs.values()) <= FFN_TOL, errs


def test_ties_pick_the_lower_expert_first():
    """Equal router probabilities: the picks are experts 0..k-1 in order,
    as ``lax.top_k`` returns them, with equal gates."""
    kw, act, p, x, _ = _ffn_inputs("ties")
    xt = torch.from_numpy(x).reshape(-1, D)
    probs, gates, idx = TMOE.route(xt, torch.from_numpy(p["router"]),
                                   kw["top_k"])
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), kw["top_k"])
    assert idx.tolist() == np.asarray(jidx).tolist() == \
        [list(range(kw["top_k"]))] * xt.shape[0]
    assert torch.equal(gates, torch.full_like(gates, 1 / kw["top_k"]))


def test_capacity_rounds_as_the_reference():
    """``capacity`` at the serving and training token counts of the full
    qwen2-moe (60 experts, top 4, factor 1.25): 16 slots for a decode
    token, 256 for a 2048-token microbatch."""
    cfg = get_reduced("qwen2-moe-a2.7b").moe
    full = MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                     num_shared_experts=4, d_ff_shared=1408)
    assert [TMOE.capacity(T, full) for T in (1, 64, 2048)] == [16, 16, 256]
    assert TMOE.capacity(48, cfg) == 256


# ---------------------------------------------------------------------------
# LM.loss and the pipeline executor
# ---------------------------------------------------------------------------

MBB, SEQ, M, P = 2, 17, 4, 2
_VG = {}


def _jax_value_and_grad(arch):
    """jit of ``value_and_grad`` of JAX ``LM.loss`` on one microbatch
    (one compile per arch, shared by the tests below)."""
    if arch not in _VG:
        lm = JaxLM(jax_get_reduced(arch))
        _VG[arch] = jax.jit(jax.value_and_grad(
            lambda p, t: lm.loss(p, {"tokens": t}), has_aux=True))
    return _VG[arch]


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_lm_loss_matches_jax(arch):
    """``LM.loss`` (``ce + 0.01 * aux``, and its ``ce`` and ``aux``) and
    every gradient, fused backend, against JAX ``LM.loss``."""
    params, _ = JaxLM(jax_get_reduced(arch)).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    toks = _tokens((MBB, SEQ), 1)
    (loss_j, parts_j), grads_j = _jax_value_and_grad(arch)(params, toks)
    tp = tree_map(lambda a: a.requires_grad_(),
                  lm_params_from_numpy(tree, "cpu"))
    loss, parts = LM(get_reduced(arch), kernels="fused", device="cpu").loss(
        tp, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    errs = [abs(float(loss) - float(loss_j))] + [
        abs(float(parts[k]) - float(parts_j[k])) for k in ("ce", "aux")]
    g_err = max(_rel(a, b) for a, b in zip(grads, jax.tree.leaves(grads_j)))
    print(f"{arch}: loss {float(loss):.6f} (aux {float(parts['aux']):.4f}) "
          f"|d| {max(errs):.2e}, grads rel {g_err:.2e}")
    assert float(parts["aux"]) > 0
    assert max(errs) <= LOSS_TOL and g_err <= GRAD_TOL


@pytest.mark.parametrize("arch,schedule,v", [
    ("qwen2-moe-a2.7b", "chronos_zb", 2), ("qwen2-moe-a2.7b", "1f1b", 1),
    ("jamba-v0.1-52b", "chronos_zb", 2), ("jamba-v0.1-52b", "chronos", 2)])
def test_pipeline_grads_match_jax_autodiff(arch, schedule, v):
    """The executor (P=2, m=4, the aux sum in the payload, its cotangent
    on the backward ring) against ``jax.grad`` of the mean over the
    microbatches of JAX ``LM.loss`` on the same weights (the JAX
    package's ``init_pipeline_params``, unstaged): the loss and every
    gradient leaf within 2e-5 of its largest element."""
    jcfg = jax_get_reduced(arch)
    jp, _ = jax_init_pipeline_params(jax.random.key(0), jcfg,
                                     JaxStageLayout.build(jcfg, P, v))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    spec = make_pipeline_spec(get_reduced(arch), P=P, v=v, m=M,
                              microbatch=MBB, seq_len=SEQ,
                              schedule=schedule, kernels="fused")
    toks = _tokens((M, MBB, SEQ), 2)
    grads, met = make_train_grads_fn(spec, "cpu")(
        params, {"tokens": torch.from_numpy(toks)})
    lm_p = jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.numpy(), unstage_params(params, spec.layout)))
    vg = _jax_value_and_grad(arch)
    ref_loss, ref_g = 0.0, None
    for i in range(M):
        (loss_i, _), g = vg(lm_p, toks[i])
        ref_loss += float(loss_i) / M
        g = [np.asarray(a) for a in jax.tree.leaves(g)]
        ref_g = g if ref_g is None else [a + b for a, b in zip(ref_g, g)]
    ours = tree_leaves(unstage_params(grads, spec.layout))
    assert len(ours) == len(ref_g)
    e_loss = abs(float(met["loss"]) - ref_loss)
    g_err = max(_rel(a, b) for a, b in zip(ours, ref_g))
    print(f"{arch} {schedule}: loss {float(met['loss']):.6f} |d| "
          f"{e_loss:.2e}, grads rel {g_err:.2e}")
    assert e_loss <= LOSS_TOL and g_err <= GRAD_TOL


def test_seq_executor_refuses_moe():
    """The sequence-chunked executor carries no aux sum: an MoE config
    is refused, as the reference asserts."""
    with pytest.raises(ValueError, match="dense attention"):
        make_pipeline_spec(get_reduced("qwen2-moe-a2.7b"), P=2, v=2, m=4,
                           microbatch=1, seq_len=17, schedule="chronos_seq",
                           n_seq=2)
