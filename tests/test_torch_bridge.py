"""The port's package rules: the weight bridge round-trips bit for bit,
the package imports without JAX or ``repro``, its sources import neither,
and a CUDA request never falls back to the CPU."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import LM as JaxLM
from repro_torch.bridge import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_rows
from repro_torch.models import LM
from repro_torch.serve import PipelinedEngine
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bitwise(dtype):
    cfg = dataclasses.replace(jax_get_reduced("tinyllama-1.1b"),
                              param_dtype=dtype, compute_dtype=dtype)
    params, _ = JaxLM(cfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tt = lm_params_from_numpy(tree, "cpu")
    back = lm_params_to_numpy(tt)
    a, b, t = list(_leaves(tree)), list(_leaves(back)), list(_leaves(tt))
    assert [p for p, _ in a] == [p for p, _ in b] == [p for p, _ in t]
    for (path, x), (_, y), (_, z) in zip(a, b, t):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path
        assert str(z.dtype) == f"torch.{dtype}" and tuple(z.shape) == x.shape
    # the values read through torch equal the JAX values widened to fp32
    emb = tree["embed"]["tokens"]
    np.testing.assert_array_equal(tt["embed"]["tokens"].float().numpy(),
                                  emb.astype(np.float32))


def test_bridge_tree_structure_matches_port_init():
    """A bridged JAX tree and the port's own ``LM.init`` have the same
    structure, shapes and dtypes, leaf for leaf."""
    cfg = get_reduced("tinyllama-1.1b")
    params, _ = JaxLM(jax_get_reduced("tinyllama-1.1b")).init(
        jax.random.key(0))
    bridged = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    own = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    a, b = list(_leaves(bridged)), list(_leaves(own))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path


def test_moe_tree_crosses_with_its_fp32_router():
    """A bf16 qwen2-moe tree (reduced widths) crosses leaf for leaf with
    the port's own ``LM.init`` tree: the same structure, shapes and
    dtypes, the fp32 router beside bf16 experts and shared MLP, and every
    bit kept."""
    dt = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    jcfg = dataclasses.replace(jax_get_reduced("qwen2-moe-a2.7b"), **dt)
    cfg = dataclasses.replace(get_reduced("qwen2-moe-a2.7b"), **dt)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.key(0))[0])
    bridged = lm_params_from_numpy(tree, "cpu")
    own = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    a, b = list(_leaves(bridged)), list(_leaves(own))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path
    dtypes = {p.rsplit("/", 1)[-1]: str(x.dtype) for p, x in a
              if "/moe/" in p and "/shared/" not in p}
    assert dtypes == {"router": "torch.float32", "wi": "torch.bfloat16",
                      "wg": "torch.bfloat16", "wo": "torch.bfloat16"}
    for (path, x), (_, y) in zip(_leaves(tree),
                                 _leaves(lm_params_to_numpy(bridged))):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), path


def test_import_with_jax_and_repro_poisoned():
    mods = sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "print('imported', len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "repro_torch.launch.serve" in mods and "repro_torch.bridge" in mods
    assert {"repro_torch.models.mamba", "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.configs.mamba2_2_7b", "repro_torch.launch.train",
            "repro_torch.launch.steps", "repro_torch.models.transformer",
            "repro_torch.data.pipeline", "repro_torch.models.moe",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.grok1_314b",
            "repro_torch.configs.jamba_v0_1_52b",
            "repro_torch.configs.gemma3_27b",
            "repro_torch.configs.paligemma_3b",
            "repro_torch.configs.whisper_base",
            "repro_torch.ft", "repro_torch.ft.checkpoint",
            "repro_torch.ft.elastic", "repro_torch.ft.elastic_pipeline",
            "repro_torch.ft.health", "repro_torch.ft.inject",
            "repro_torch.data.tokenshards", "repro_torch.serve.resilience",
            "repro_torch.serve.scheduler",
            "repro_torch.serve.traffic"} <= set(mods)


def test_sources_import_no_jax_and_no_repro():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                     re.MULTILINE)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("tinyllama-1.1b")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        PipelinedEngine(cfg, params, P=1, chunk=16, max_seq=64,
                        device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        LM(cfg)                                   # CUDA is the default


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: stands in for a CUDA
    request on a machine that has no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_kernel_wrappers_on_cuda_tensors_launch_or_raise(monkeypatch):
    """For a CUDA tensor a wrapper goes to its kernel (here: the build,
    which is stubbed to fail) and never to the plain version."""
    class Refused(Exception):
        pass

    def refuse():
        raise Refused

    monkeypatch.setattr(build, "load_library", refuse)
    before = (rmsnorm_rows.launches, flash_attention_fwd.launches)
    x = torch.zeros((4, 128)).as_subclass(_CudaLooking)
    s = torch.ones(128).as_subclass(_CudaLooking)
    with pytest.raises(Refused):
        rmsnorm_rows(x, s)
    q = torch.zeros((1, 16, 8, 16)).as_subclass(_CudaLooking)
    kv = torch.zeros((1, 32, 2, 16)).as_subclass(_CudaLooking)
    with pytest.raises(Refused):
        flash_attention_fwd(q, kv, kv, q_offset=8)
    assert (rmsnorm_rows.launches, flash_attention_fwd.launches) == before


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    meta = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError):      # meta x beside a CPU scale
        rmsnorm_rows(meta, torch.ones(128))
    x = torch.zeros((4, 128), dtype=torch.float16).as_subclass(_CudaLooking)
    s = torch.ones(128, dtype=torch.float16).as_subclass(_CudaLooking)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm_rows(x, s)
    q = torch.zeros((1, 16, 8, 24)).as_subclass(_CudaLooking)     # hd 24
    kv = torch.zeros((1, 32, 2, 24)).as_subclass(_CudaLooking)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, kv, kv)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler: the build raises; nothing falls back."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not any(tmp_path.iterdir())
