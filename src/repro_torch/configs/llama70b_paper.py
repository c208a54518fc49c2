"""The paper's own workload: LLAMA2-70B-like, 80 transformer layers with
GQA (the paper varies num_layers to scale model size).  The planner's
benchmarks read it (Figs. 1(a) and 9-16). [arXiv:2307.09288]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama70b-paper",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    rope_theta=10000.0,
    act="silu",
)


def with_layers(n: int) -> ModelConfig:
    return dataclasses.replace(CONFIG, name=f"llama-{n}L", num_layers=n)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama70b-paper-smoke", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=2, d_ff=352, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
