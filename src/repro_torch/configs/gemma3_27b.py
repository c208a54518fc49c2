"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144. 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Pattern: every 6th layer (offset 5) is global full attention; the other
five use a 1024-token sliding window.  head_dim pinned to 128 (gemma uses
a head_dim decoupled from d_model/num_heads)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    rope_theta=1e6,
    sliding_window=1024,
    attn_pattern_period=6,
    global_offsets=(5,),
    act="geglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-27b-smoke", num_layers=6, d_model=128,
        num_heads=8, num_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
        sliding_window=32, param_dtype="float32", compute_dtype="float32")
