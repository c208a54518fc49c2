"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=11008 vocab=102400. llama-arch. [arXiv:2401.02954; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-7b-smoke", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=8, d_ff=352, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
