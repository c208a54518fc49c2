"""Synthetic serving traffic + latency summarisation (own copy of
``repro.serve.traffic``).

Poisson arrivals (exponential inter-arrival gaps at ``rate`` requests
per second) with prompt / generation lengths drawn from bounded uniform
grids, all from a seeded ``numpy`` generator so traces are reproducible
and identical to the reference's for the same seed.  Prompt lengths are
rounded up to the prefill chunk so the admission layer accepts them
unchanged.

:func:`bursty_requests` is the overload workload: a two-state
Markov-modulated Poisson process (calm and burst phases with exponential
dwell times) whose burst rate exceeds the sustainable service rate, with
a heavier (geometric) generation-length tail: the input that makes load
shedding, deadlines and preemption fire.
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


def bursty_requests(n: int, *, chunk: int, max_seq: int,
                    rate_lo: float = 2.0, rate_hi: float = 20.0,
                    dwell_lo_s: float = 2.0, dwell_hi_s: float = 0.5,
                    prompt_range=(1, 4), gen_range=(4, 16),
                    gen_tail: float = 0.15,
                    deadline_s: Optional[float] = None,
                    vocab: int = 256, seed: int = 0) -> List[Request]:
    """``n`` requests from a two-state modulated Poisson process.

    Arrivals alternate between a *calm* phase (``rate_lo`` req/s, mean
    dwell ``dwell_lo_s``) and a *burst* phase (``rate_hi`` req/s, mean
    dwell ``dwell_hi_s``); phase changes are exponential, so the trace is
    bursty but fully determined by ``seed``.  Generation lengths draw
    from the same bounded grid as :func:`poisson_requests`, except that a
    ``gen_tail`` fraction of requests draw a geometric tail capped only
    by ``max_seq``.  ``deadline_s`` stamps every request with a relative
    completion budget (None: no deadlines)."""
    assert 0.0 <= gen_tail <= 1.0
    rng = np.random.default_rng(seed)
    t = 0.0
    burst = False
    phase_left = float(rng.exponential(dwell_lo_s))
    out = []
    for rid in range(n):
        gap = float(rng.exponential(1.0 / (rate_hi if burst else rate_lo)))
        # walk the phase switches that occur inside this gap
        while gap > phase_left:
            gap = (gap - phase_left) * \
                ((rate_hi / rate_lo) if burst else (rate_lo / rate_hi))
            burst = not burst
            phase_left = float(rng.exponential(
                dwell_hi_s if burst else dwell_lo_s))
        phase_left -= gap
        t += gap
        n_chunks = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        plen = n_chunks * chunk
        gmax = max_seq - plen
        assert gmax >= gen_range[0], \
            f"prompt of {n_chunks} chunks leaves no room to generate"
        if float(rng.random()) < gen_tail:
            # heavy tail: geometric with mean ~2x the grid's upper end
            gen = gen_range[0] + int(rng.geometric(
                1.0 / (2.0 * gen_range[1])))
        else:
            gen = int(rng.integers(gen_range[0],
                                   min(gen_range[1], gmax) + 1))
        gen = min(gen, gmax)
        prompt = rng.integers(0, vocab, size=plen).astype(int).tolist()
        out.append(Request(rid=rid, prompt=prompt, max_new=gen,
                           arrival_s=t, deadline=deadline_s))
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
    lifecycle tally when the result carries one (``goodput_tok_s``
    counts only tokens of *completed* requests; ``deadline_hit_rate`` is
    None when no request set a deadline; every field is None-safe
    against a result without ``counts``)."""
    mets = result["metrics"].values()
    ttfts = [m["ttft_s"] for m in mets if m["ttft_s"] is not None]
    per_tok = [dt for m in mets for dt in m["per_token_s"]]
    n_tok = sum(m["n_tokens"] for m in mets)
    counts = result.get("counts") or {}
    with_dl = counts.get("with_deadline") or 0
    hits = counts.get("deadline_hits")
    return {
        "requests": len(result["metrics"]),
        "output_tokens": n_tok,
        "elapsed_s": result["elapsed_s"],
        "ticks": result["ticks"],
        "tokens_per_s": n_tok / max(result["elapsed_s"], 1e-9),
        "goodput_tok_s": n_tok / max(result["elapsed_s"], 1e-9),
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p99_s": percentile(ttfts, 99),
        "tok_p50_s": percentile(per_tok, 50),
        "tok_p99_s": percentile(per_tok, 99),
        "completed": counts.get("completed"),
        "expired": counts.get("expired"),
        "shed": counts.get("shed"),
        "failed": counts.get("failed"),
        "retries": counts.get("retries"),
        "preemptions": counts.get("preemptions"),
        "deadline_hit_rate": (hits / with_dl)
        if with_dl and hits is not None else None,
        "deadline_miss_rate": (1.0 - hits / with_dl)
        if with_dl and hits is not None else None,
    }
