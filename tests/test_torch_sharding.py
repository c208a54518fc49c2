"""The port's logical-axis sharding against the JAX package's
(``repro/models/sharding.py``, ``repro/launch/mesh.py``,
``repro/optim/adamw.py``), with no processes: the reference's functions
take a stub with a ``.shape`` dict, so no JAX devices are needed
(``make_mesh`` is replaced by the stub where the reference builds its
meshes).

- every registered config's pipeline leaves: the logical specs equal
  (``init_pipeline_params``' under ``jax.eval_shape``), the shapes equal,
  and on every mesh layout below the resolved and sanitized spec equal
  the reference's ``sanitize_spec(ShardEnv(mesh, rules).resolve(...))``,
  for the parameters and (``zero_state_specs``, ``drop_fsdp``) the
  optimizer state of the reference's pipeline layout;
- the layouts: the host study meshes (2, 2, 2), (4, 1, 4), (1, 8, 1)
  with their rules and with the port's mesh rules (``MESH_RULES``), the
  production (16, 16) and the multi-pod (2, 16, 16);
- ``production_rules``, ``make_*_mesh`` layouts, ``local_shard`` and its
  inverse, ``RankShard``'s slices (K/V heads replicated over tp too),
  the reference's production layout data 16 x model 16 on the meta
  device, and the refusals that need no process."""
import dataclasses

import jax
import pytest
import torch

import repro.launch.mesh as jax_mesh
import repro.models.sharding as jax_sharding
from repro.configs import get_config as jax_get_config
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.optim.adamw import drop_fsdp as jax_drop_fsdp
from repro.optim.adamw import zero_state_specs as jax_zero_state_specs
from repro_torch.configs import _ARCH_MODULES, get_config, get_reduced
from repro_torch.configs.base import ParallelPlan
from repro_torch.core.layout import StageLayout
from repro_torch.core.pipeline_runtime import (RankShard,
                                               init_pipeline_params,
                                               pipeline_layout_specs,
                                               pipeline_logical_specs)
from repro_torch.core.placement import get_placement
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import check_mesh_model, check_zero_stage
from repro_torch.models import sharding as S
from repro_torch.optim.adamw import drop_fsdp, zero_state_specs
from repro_torch.tree import tree_leaves, tree_paths
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = tuple(_ARCH_MODULES)
HOST = ((2, 2, 2), (4, 1, 4), (1, 8, 1))


class Stub:
    """A mesh for the reference's pure functions: its ``.shape`` only."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_mesh(shape, axes):
    return Stub(zip(axes, shape))


def _canon(spec):
    """A physical spec with each one-axis tuple as its axis name (the
    form ``PartitionSpec`` normalizes entries to)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _jax_spec_leaves(specs):
    """The reference's specs as tuples, in ``jax.tree.leaves`` order."""
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple) or x is None)]


_REF = {}


def _reference(arch, P):
    """The reference's pipeline specs and leaf shapes of ``arch`` at P
    (v=2, interleaved), from its ``init_pipeline_params`` under
    ``jax.eval_shape`` (nothing allocated)."""
    if (arch, P) not in _REF:
        cfg = jax_get_config(arch)
        lay = JaxStageLayout.build(cfg, P, 2)
        holder = {}

        def grab():
            p, s = jax_init_pipeline_params(jax.random.key(0), cfg, lay)
            holder["s"] = s
            return p
        shapes = jax.eval_shape(grab)
        _REF[arch, P] = (holder["s"], [tuple(a.shape) for a in
                                       jax.tree.leaves(shapes)])
    return _REF[arch, P]


def _port(arch, P):
    cfg = get_config(arch)
    lay = StageLayout.build(cfg, P, 2, get_placement("interleaved", P, 2))
    tree = init_pipeline_params(None, cfg, lay, "meta")
    return cfg, lay, tree


def _layouts():
    """(name, mesh, reference rules, port rules) of every layout."""
    out = []
    for pp, dp, tp in HOST:
        mesh, rules = M.make_host_study_mesh(pp, dp, tp)
        out.append((f"host{pp}x{dp}x{tp}", mesh, rules))
        out.append((f"mesh{pp}x{dp}x{tp}",
                    M.MeshLayout(M.AXES, (pp, dp, tp)), M.MESH_RULES))
    out.append(("prod16x16", M.make_production_mesh(),
                M.production_rules(False)))
    out.append(("pod2x16x16", M.make_production_mesh(multi_pod=True),
                M.production_rules(True, pipeline=True)))
    return out


LAYOUTS = _layouts()


def _pp_of(mesh, rules):
    ax = rules.get("pp")
    return mesh.shape[ax] if ax in mesh.shape else 2


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_specs_equal_the_reference(arch):
    """Logical specs leaf for leaf and the leaves' shapes, at P 1, 2
    and 4."""
    for P in (1, 2, 4):
        ref, shapes = _reference(arch, P)
        cfg, lay, tree = _port(arch, P)
        ours = pipeline_logical_specs(cfg, lay)
        assert [tuple(a.shape) for a in tree_leaves(tree)] == shapes
        assert S.spec_leaves(ours) == _jax_spec_leaves(ref)
        assert S.spec_leaves(drop_fsdp(ours)) == \
            _jax_spec_leaves(jax_drop_fsdp(ref))
        for stage in (0, 1, 3):
            assert S.spec_leaves(zero_state_specs(ours, stage)) == \
                _jax_spec_leaves(jax_zero_state_specs(ref, stage))


@pytest.mark.parametrize("name,mesh,rules", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_specs_equal_the_reference(arch, name, mesh, rules):
    """The reference's pipeline layout (blocks fsdp x tp, shared leaves
    without fsdp; the state by ``zero_state_specs``) resolved and
    sanitized on every leaf's shape: the port's spec equals the
    reference's ``sanitize_spec(ShardEnv(mesh, rules).resolve(...))``."""
    P = _pp_of(mesh, rules)
    ref, shapes = _reference(arch, P)
    cfg, lay, _ = _port(arch, P)
    params, state = pipeline_layout_specs(pipeline_logical_specs(cfg, lay))
    jparams = {k: (v if k == "blocks" else jax_drop_fsdp(v))
               for k, v in ref.items()}
    jstate = jax_zero_state_specs(jparams, 1)
    jstate = {k: (v if k == "blocks" else jparams[k])
              for k, v in jstate.items()}
    env = S.ShardEnv(mesh, rules)
    jenv = jax_sharding.ShardEnv(Stub(mesh.shape), rules)
    for ours, theirs in ((params, jparams), (state, jstate)):
        a = [_canon(S.sanitize_spec(env.resolve(sp), sh, mesh))
             for sp, sh in zip(S.spec_leaves(ours), shapes)]
        b = [_canon(jax_sharding.sanitize_spec(jenv.resolve(sp), sh,
                                               Stub(mesh.shape)))
             for sp, sh in zip(_jax_spec_leaves(theirs), shapes)]
        assert a == b, name


def test_mesh_layouts_and_rules_equal_the_reference(monkeypatch):
    monkeypatch.setattr(jax_mesh, "make_mesh", _jax_mesh)
    for multi in (False, True):
        for serving in (False, True):
            for pipeline in (False, True):
                assert M.production_rules(multi, serving=serving,
                                          pipeline=pipeline) == \
                    jax_mesh.production_rules(multi, serving=serving,
                                              pipeline=pipeline)
        assert M.make_production_mesh(multi_pod=multi).shape == \
            jax_mesh.make_production_mesh(multi_pod=multi).shape
    assert M.make_study_mesh(8, 2, 16).shape == \
        jax_mesh.make_study_mesh(8, 2, 16).shape
    for shape in HOST + ((4, 1, 1),):
        ours, rules = M.make_host_study_mesh(*shape)
        theirs, jrules = jax_mesh.make_host_study_mesh(*shape)
        assert ours.shape == theirs.shape and rules == jrules
    # the port's mesh rules: the reference's pipeline rules, its pipe
    # axis named as the host study mesh names it
    want = dict(jax_mesh.production_rules(True, pipeline=True), pp="pp")
    assert M.MESH_RULES == want


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_mesh_takes_the_ssm_moe_and_hybrid_families(arch):
    """Full and reduced mamba2-2.7b (attention-free: its unused
    ``num_heads=1`` is not read), qwen2-moe-a2.7b and jamba-v0.1-52b pass
    ``check_mesh_model`` at tp 2 and dp 2 (and both); so do whisper and
    paligemma (full and reduced) at tp 2 and 4 with dp 1 and 2, and tp
    above their query heads raises, naming item 3b.4'."""
    for cfg in (get_config(arch), get_reduced(arch)):
        for dp, tp in ((2, 1), (1, 2), (2, 2)):
            check_mesh_model(cfg, dp, tp)
    assert get_config("mamba2-2.7b").num_heads == 1
    for enc_vlm in ("whisper-base", "paligemma-3b"):
        for cfg in (get_config(enc_vlm), get_reduced(enc_vlm)):
            for dp in (1, 2):
                for tp in (2, 4):
                    check_mesh_model(cfg, dp, tp)
        with pytest.raises(ValueError, match="item 3b.4'"):
            check_mesh_model(get_config(enc_vlm), 1, 16)


@pytest.mark.parametrize("name,mesh,rules", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
def test_exp_resolves_to_no_mesh_axis(name, mesh, rules):
    """The experts' ``exp`` axis is mapped by none of the rule sets (no
    expert parallelism, as in the reference): it resolves to no mesh axis
    in the port and the reference alike, so every MoE expert leaf of
    qwen2-moe-a2.7b and jamba-v0.1-52b keeps its expert dimension whole
    on every layout."""
    env = S.ShardEnv(mesh, rules)
    jenv = jax_sharding.ShardEnv(Stub(mesh.shape), rules)
    assert "exp" not in rules
    assert env.resolve(("exp",)) == () == tuple(jenv.resolve(("exp",)))
    for arch in ("qwen2-moe-a2.7b", "jamba-v0.1-52b"):
        cfg, lay, tree = _port(arch, _pp_of(mesh, rules))
        params, _ = pipeline_layout_specs(pipeline_logical_specs(cfg, lay))
        for path, sp, a in zip(tree_paths(tree), S.spec_leaves(params),
                               tree_leaves(tree)):
            if path[-2] == "moe" and path[-1] in ("wi", "wg", "wo"):
                phys = S.sanitize_spec(env.resolve(sp), a.shape, mesh)
                assert sp[3] == "exp"
                assert len(phys) < 4 or phys[3] is None, (path, phys)


def test_resolve_and_sanitize_corner_cases():
    """Duplicates dropped, tuples resolved, trailing Nones stripped, a
    dimension the axis does not divide left whole (whisper's 51865
    vocab), as the reference."""
    mesh = Stub({"pod": 2, "data": 4, "model": 2})
    rules = {"dp": ("pod", "data"), "fsdp": ("pod", "data"),
             "tp": "model", "sp": "data"}
    for logical in [("dp", "fsdp", None), ("tp", "tp"), ("sp", "dp"),
                    (None, None), (("tp", "fsdp"), None), ("exp", "tp")]:
        ours = S.ShardEnv(mesh, rules).resolve(logical)
        theirs = jax_sharding.ShardEnv(mesh, rules).resolve(logical)
        assert _canon(ours) == _canon(theirs)
        for shape in [(8, 6), (51865, 4), (4, 2), (3,)]:
            assert _canon(S.sanitize_spec(ours, shape, mesh)) == _canon(
                jax_sharding.sanitize_spec(theirs, shape, mesh))
    assert S.axis_size(mesh, ("pod", "data")) == 8
    assert S.current_env() is None
    with S.shard_env(mesh, rules) as env:
        assert S.current_env() is env and env.tp == 2
        assert S.resolve_tree({"a": ("tp", None)}) == {"a": ("model",)}
    assert S.current_env() is None and S.tp_env() is None


def test_local_shard_and_its_inverse():
    """Every rank's shard of a leaf split over two axes (one a tuple),
    joined back, is the leaf; a shard is a view."""
    leaf = torch.arange(8 * 6 * 4, dtype=torch.float32).view(8, 6, 4)
    spec = (("pod", "data"), None, "model")
    sizes = {"pod": 2, "data": 2, "model": 2}
    shards = {}
    for p in range(2):
        for d in range(2):
            for t in range(2):
                co = {"pod": (p, 2), "data": (d, 2), "model": (t, 2)}
                a = S.local_shard(leaf, spec, co)
                assert a.shape == (2, 6, 2)
                assert a.data_ptr() >= leaf.data_ptr()
                shards[p, d, t] = a
                # row-major over the tuple: pod major
                assert torch.equal(a, leaf[(2 * p + d) * 2:(2 * p + d + 1)
                                           * 2, :, 2 * t:2 * t + 2])
    back = S.join_shards(lambda co: shards[co["pod"][0], co["data"][0],
                                           co["model"][0]], spec, sizes)
    assert torch.equal(back, leaf)
    # an axis left out of the coordinates is not cut
    assert S.local_shard(leaf, spec, {"model": (1, 2)}).shape == (8, 6, 2)


# (arch, tp) on pp 2 x dp 2 x tp: tinyllama's 2 K/V heads split at tp 2
# and replicated over pairs at tp 4; paligemma's one K/V head over 2 or 4
SHARD_CASES = (("tinyllama-1.1b", 2), ("tinyllama-1.1b", 4),
               ("paligemma-3b", 2), ("paligemma-3b", 4))


@pytest.mark.parametrize("arch,tp", SHARD_CASES,
                         ids=[f"{a}-tp{t}" for a, t in SHARD_CASES])
def test_rank_shard_slices_and_ownership(arch, tp):
    """``RankShard`` on a reduced config at (2, 2, tp): the tp cut of
    every leaf (tinyllama at tp 2: heads, FFN and vocab split, norms
    whole), the ZeRO-1 slice of every block leaf's state (the first free
    axis when the parameter has no fsdp: a norm's chunk axis), none for
    the shared leaves; where the K/V heads are fewer than tp, each rank's
    ``wk`` / ``wv`` the whole head of its query heads (the same on the
    ``tp / G`` ranks of its K/V group); and an element owned by exactly
    one rank of the mesh."""
    cfg = get_reduced(arch)
    lay = StageLayout.build(cfg, 2, 2, get_placement("interleaved", 2, 2))
    shape = {"pp": 2, "data": 2, "model": tp}
    shards = {(d, t): RankShard(cfg, lay, shape, M.MESH_RULES,
                                {"pp": 0, "data": d, "model": t})
              for d in range(2) for t in range(tp)}
    rs = shards[0, 0]
    by = dict(zip([p[-2:] if p[0] == "blocks" else p for p in rs.paths],
                  zip(rs.param_specs, rs.tp_split, rs.zero_dims)))
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    rep = tp // G if tp > G else 1
    assert rs.kv_rep == rep and any(rs.kv) == (rep > 1)
    if (arch, tp) == ("tinyllama-1.1b", 2):
        assert by["attn", "wq"] == ((None, None, None, "model"), True, 2)
        assert by["attn", "wo"] == ((None, None, "model"), True, 3)
        assert by["mlp", "wi"] == ((None, None, None, "model"), True, 2)
        assert by["norm1", "scale"] == ((), False, 0)
        assert by["embed", "tokens"] == (("model",), True, None)
        assert by["embed", "head"] == ((None, "model"), True, None)
        assert by["final_norm", "scale"] == ((), False, None)
    tree = init_pipeline_params(torch.Generator().manual_seed(0), cfg, lay,
                                "cpu")
    whole = tree_leaves(tree)
    seen = [torch.zeros(a.shape[1:] if p[0] == "blocks" else a.shape)
            for p, a in zip(tree_paths(tree), whole)]
    for (d, t), sh in shards.items():
        mine = sh.cut(tree, 0)
        for i, (p, a) in enumerate(zip(sh.paths, tree_leaves(mine))):
            assert a.is_contiguous()
            if sh.kv[i]:
                # the whole head t // rep: every rank of its group alike
                h = t // rep
                assert torch.equal(a, whole[i][0][..., h * hd:(h + 1) * hd])
            # mark the owned elements in the tp-whole leaf's coordinates
            full = torch.zeros(seen[i].shape)
            parts = sh.tp_parts[i]
            view = S.local_shard(full, sh.cut_specs[i], {"model": (
                t // (tp // parts), parts)})
            assert view.shape == a.shape
            part = sh.owned(torch.ones(view.shape), i)
            if part is not None:
                sh.zero_slice(view, i).add_(1.0)
            seen[i] += full
    assert all(bool((s == 1).all()) for s in seen)


PRODUCTION_TP16 = ("llama70b-paper", "qwen2-72b", "grok-1-314b",
                   "jamba-v0.1-52b", "tinyllama-1.1b")


def test_production_layout_replicates_kv_heads_on_meta():
    """The reference's production mesh, data 16 x model 16
    (``make_production_mesh``) with its rules: ``check_mesh_model``
    admits llama70b-paper, qwen2-72b, grok-1-314b, jamba-v0.1-52b and
    tinyllama-1.1b at tp 16 (their K/V heads divide 16); the
    ``TreeShard`` of llama70b-paper's ``LM`` tree on the meta device (at
    ZeRO stage 3, every leaf a rank's part) gives each of the 16 tp
    ranks one whole K/V head (``wk`` / ``wv`` of 128 columns, head ``t //
    2``, shared by two consecutive ranks and counted on the first), and
    allocates nothing."""
    from repro_torch.launch.steps import lm_shard
    from repro_torch.models import LM
    layout = M.make_production_mesh()
    assert layout.shape == {"data": 16, "model": 16}
    rules = M.production_rules(False)
    for arch in PRODUCTION_TP16:
        cfg = get_config(arch)
        assert 16 % cfg.num_kv_heads == 0 and cfg.num_kv_heads < 16
        check_mesh_model(cfg, 16, 16)
    cfg = get_config("llama70b-paper")
    hd, G = cfg.resolved_head_dim, cfg.num_kv_heads
    leaves = tree_leaves(LM(cfg, device="meta").init(None))
    for t in (0, 1, 6, 7, 15):
        sh = lm_shard(cfg, layout.shape, rules, {"data": 3, "model": t}, 3)
        assert sh.kv_rep == 2 and sh._kv_cut["model"] == (t // 2, G)
        for i, (p, a) in enumerate(zip(sh.paths, leaves)):
            part = sh.local_view(a, i)
            assert part.device.type == "meta"
            if p[-1] in ("wk", "wv"):
                assert sh.kv[i] and sh.tp_parts[i] == G
                assert part.shape == (cfg.num_layers, cfg.d_model // 16, hd)
                assert sh.counts(i) == (t % 2 == 0)
            elif p[-1] == "wq":
                assert part.shape[-1] == cfg.num_heads // 16 * hd


def test_refusals_without_processes():
    """tp not dividing the query heads of a config with attention layers,
    K/V heads and tp dividing neither one another, or tp not dividing
    the Mamba-2 heads (ValueError, the first two naming ROADMAP item
    3b.4'); tp 4 over tinyllama's 2 K/V heads (replicated in pairs) and
    the encoder-decoder and the VLM under tp are taken; ZeRO stages 0-3
    run, another stage raises ValueError."""
    tiny = get_reduced("tinyllama-1.1b")            # 8 heads, 2 K/V heads
    check_mesh_model(tiny, 1, 4)
    with pytest.raises(ValueError, match="num_kv_heads=6.*item 3b.4'"):
        check_mesh_model(dataclasses.replace(tiny, num_heads=12,
                                             num_kv_heads=6), 1, 4)
    with pytest.raises(ValueError, match="num_heads=8"):
        check_mesh_model(dataclasses.replace(tiny, num_kv_heads=8), 1, 3)
    with pytest.raises(ValueError, match="num_heads=8.*item 3b.4'"):
        check_mesh_model(tiny, 1, 16)
    check_mesh_model(tiny, 2, 2)
    check_mesh_model(get_reduced("deepseek-7b"), 1, 4)
    with pytest.raises(ValueError, match="3 must divide the 8 Mamba-2"):
        check_mesh_model(get_reduced("mamba2-2.7b"), 1, 3)
    for arch in ("whisper-base", "paligemma-3b"):
        cfg = get_reduced(arch)
        check_mesh_model(cfg, 1, 2)
        check_mesh_model(cfg, 2, 4)
        check_mesh_model(cfg, 2, 1)
        with pytest.raises(ValueError, match="item 3b.4'"):
            check_mesh_model(cfg, 1, 2 * cfg.num_heads)
    for z in (-1, 4):
        with pytest.raises(ValueError, match=f"zero_stage={z}"):
            check_zero_stage(ParallelPlan(zero_stage=z))
    for z in (0, 1, 2, 3):
        check_zero_stage(ParallelPlan(zero_stage=z))
    with pytest.raises(ValueError, match="pp x dp x tp"):
        M.spawn(8, print, shape=(2, 2, 1), device="cpu")
