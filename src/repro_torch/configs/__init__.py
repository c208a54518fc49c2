"""Architecture registry: ``--arch <id>`` resolves here.

Every architecture of the reference's registry: the dense ones
(tinyllama-1.1b, deepseek-7b, qwen2-72b with its q/k/v biases, gemma3-27b
with its 5:1 local/global sliding windows, and the paper's
llama70b-paper), the SSM one (mamba2-2.7b), the MoE ones
(qwen2-moe-a2.7b with shared experts, grok-1-314b with ungated gelu
experts), the hybrid jamba-v0.1-52b (Mamba-2 and attention layers, MoE
on every other layer), the VLM paligemma-3b (a patch prefix) and the
encoder-decoder whisper-base.  Every one trains and is an input of the
memory-budget planner (:mod:`repro_torch.plan`); every decoder family
serves (the reference's engine serves neither the VLM nor the
encoder-decoder).  :data:`SHAPES` are the reference's four input shapes,
and :func:`cell_is_skipped` its rule for which (arch, shape) cells run.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, ModelConfig,
    ShapeConfig)

_ARCH_MODULES: Dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "llama70b-paper": "repro_torch.configs.llama70b_paper",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "llama70b-paper")


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_is_skipped(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """A reason string if this (arch, shape) cell is skipped, else '' (the
    reference's rule): ``long_500k`` needs sub-quadratic attention, so a
    pure full-attention architecture skips it."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return "long_500k skipped: pure full-attention arch (O(S) KV cache " \
               "is fine but the paper-pool rule excludes quadratic-attn archs)"
    return ""
