"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, d_ff_shared=1408),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-moe-a2.7b-smoke", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=8, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=128,
                      num_shared_experts=2, d_ff_shared=128,
                      capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32")
