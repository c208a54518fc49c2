"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000. llama2-arch small. [arXiv:2401.02385; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="tinyllama-1.1b-smoke", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=2, d_ff=352, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
