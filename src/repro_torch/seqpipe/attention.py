"""Chunked causal attention over the flash kernel (port of
``repro/seqpipe/attention.py``).

The identity the seq-chunked executor relies on: causal attention of a
query chunk at absolute offset ``q0`` over (prefix KV ++ own KV) equals
the corresponding row slice of full-sequence causal attention.  The
flash kernel takes ``q_offset`` as a launch argument (its chunked-
prefill path), so chunked training attention is the same
:class:`~repro_torch.kernels.flash_attention.ops.FlashAttention` call
with a shorter query: the kernel forward, and a backward that returns
dK/dV over the whole KV buffer.

Key positions beyond ``q0 + Sq`` never contribute (the exp of a masked
score is exactly 0.0, so its dK/dV is exactly 0.0), so the key/value
buffer may be the full-sequence KV-carry slot with any content past the
causal frontier.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention


def chunked_flash_attention(q_chunk, k_all, v_all, *, q_offset: int,
                            causal: bool = True, window: int = 0,
                            prefix: int = 0):
    """q_chunk [B, Sq, H, d]; k_all/v_all [B, Sk, G, d] holding the KV
    prefix (positions < q_offset) plus this chunk's own KV (positions
    [q_offset, q_offset+Sq)); positions beyond the frontier are masked.
    Returns [B, Sq, H, d] equal to rows [q_offset, q_offset+Sq) of
    ``flash_attention`` over the full sequence."""
    return flash_attention(q_chunk, k_all, v_all, causal, window, prefix,
                           q_offset)


def merge_kv(kv, k_new, v_new, q_offset: int):
    """Write a chunk's K/V into the full-sequence buffer ``kv`` ({"k",
    "v"} [B, S, G, d]) at ``q_offset``, out of place: the result is the
    concatenation of the prefix, the new rows and the tail, so under
    autograd the cotangent of the result at the prefix and tail
    positions reaches ``kv`` (the dKV carry) and at the chunk's own
    positions reaches ``k_new`` / ``v_new``."""
    def one(buf, new):
        n = new.shape[1]
        return torch.cat([buf[:, :q_offset], new.to(buf.dtype),
                          buf[:, q_offset + n:]], dim=1)
    return {"k": one(kv["k"], k_new), "v": one(kv["v"], v_new)}
