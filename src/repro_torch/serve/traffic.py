"""Synthetic serving traffic + latency summarisation (own copy of
``repro.serve.traffic``).

Poisson arrivals (exponential inter-arrival gaps at ``rate`` requests
per second) with prompt / generation lengths drawn from bounded uniform
grids, all from a seeded ``numpy`` generator so traces are reproducible
and identical to the reference's for the same seed.  Prompt lengths are
rounded up to the prefill chunk so the admission layer accepts them
unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.scheduler import Request


def poisson_requests(n: int, rate: float, *, chunk: int, max_seq: int,
                     prompt_range=(1, 4), gen_range=(4, 16),
                     vocab: int = 256, seed: int = 0) -> List[Request]:
    """``n`` requests with Poisson arrivals at ``rate`` req/s.

    ``prompt_range`` is in *chunks* (inclusive), ``gen_range`` in
    tokens (inclusive); both are clipped so every request fits in
    ``max_seq``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate))
        n_chunks = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        plen = n_chunks * chunk
        gmax = min(gen_range[1], max_seq - plen)
        assert gmax >= gen_range[0], \
            f"prompt of {n_chunks} chunks leaves no room to generate"
        gen = int(rng.integers(gen_range[0], gmax + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(int).tolist()
        out.append(Request(rid=rid, prompt=prompt, max_new=gen,
                           arrival_s=t))
    return out


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input."""
    if not xs:
        return None
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(np.ceil(q / 100.0 * len(xs))) - 1))
    return float(xs[k])


def summarize(result: Dict) -> Dict:
    """Engine ``serve()`` result -> scalar serving metrics: throughput,
    TTFT and per-token latency percentiles (seconds), plus the request
    lifecycle tally."""
    mets = result["metrics"].values()
    ttfts = [m["ttft_s"] for m in mets if m["ttft_s"] is not None]
    per_tok = [dt for m in mets for dt in m["per_token_s"]]
    n_tok = sum(m["n_tokens"] for m in mets)
    counts = result.get("counts") or {}
    return {
        "requests": len(result["metrics"]),
        "output_tokens": n_tok,
        "elapsed_s": result["elapsed_s"],
        "ticks": result["ticks"],
        "tokens_per_s": n_tok / max(result["elapsed_s"], 1e-9),
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p99_s": percentile(ttfts, 99),
        "tok_p50_s": percentile(per_tok, 50),
        "tok_p99_s": percentile(per_tok, 99),
        "completed": counts.get("completed"),
        "expired": counts.get("expired"),
        "shed": counts.get("shed"),
        "preemptions": counts.get("preemptions"),
    }
