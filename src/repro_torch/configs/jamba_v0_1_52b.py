"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2. Mamba:attention 1:7 interleave
(attn_layer_period=8, attn_layer_offset=4), MoE every other layer
(expert_layer_period=2, offset=1). [arXiv:2403.19887; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=10000.0,
    act="silu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  layer_period=2, layer_offset=1),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4,
                  chunk_len=64, attn_period=8, attn_offset=4),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-v0.1-52b-smoke", num_layers=8, d_model=128,
        num_heads=8, num_kv_heads=2, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      layer_period=2, layer_offset=1, capacity_factor=8.0),
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                      chunk_len=16, attn_period=8, attn_offset=4),
        param_dtype="float32", compute_dtype="float32")
