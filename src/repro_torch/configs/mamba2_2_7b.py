"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free, ssm_state=128,
SSD (state-space duality). [arXiv:2405.21060; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,                    # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                         # no separate FFN; mamba block only
    vocab_size=50280,
    act="silu",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_len=128, attn_period=0),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-2.7b-smoke", num_layers=4, d_model=128,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                      chunk_len=16, attn_period=0),
        param_dtype="float32", compute_dtype="float32")
