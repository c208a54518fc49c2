"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 on every layer.
[hf:xai-org/grok-1; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    rope_theta=10000.0,
    act="gelu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="grok-1-314b-smoke", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=2, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32")
