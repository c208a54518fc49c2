"""whisper-base [audio] — enc-dec, 6L each, d_model=512 8H (MHA kv=8)
d_ff=2048 vocab=51865, conv mel frontend (stub). [arXiv:2212.04356;
unverified]

The conv frontend is a stub: the caller hands in precomputed frame
embeddings [batch, 1500, d_model].  Decoder layers carry self-attention
(causal) + cross-attention into the encoder output.  As in the reference,
RoPE stands in for whisper's absolute positions (attention cost
identical)."""
import dataclasses

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    encdec=EncDecConfig(num_encoder_layers=6, num_frames=1500),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-base-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        encdec=EncDecConfig(num_encoder_layers=2, num_frames=64),
        param_dtype="float32", compute_dtype="float32")
