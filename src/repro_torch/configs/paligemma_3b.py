"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216. SigLIP vision tower + gemma LM. [arXiv:2407.07726; hf]

The vision frontend is a stub: the caller hands in precomputed patch
embeddings [batch, 256, d_model]; they form a bidirectional prefix
(prefix-LM attention mask) ahead of the text tokens."""
import dataclasses

from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    rope_theta=10000.0,
    act="geglu",
    tie_embeddings=True,
    vision=VisionStubConfig(num_patches=256),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="paligemma-3b-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        vision=VisionStubConfig(num_patches=16),
        param_dtype="float32", compute_dtype="float32")
