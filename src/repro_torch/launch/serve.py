"""Serving entry point of the port: the pipelined engine (seq-chunked
prefill + steady-tick decode with continuous batching) on one device,
resilient serving through injected faults, or single-host batched
serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --full --pipelined 1
    PYTHONPATH=src python -m repro_torch.launch.serve --pipelined 2 \
        --requests 8 --rate 4.0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --full --chunk 128 --prompt-chunks 2 --prompt-len 256
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --pipelined 2 --device cpu

Every registered decoder architecture serves (dense, gemma3's sliding
windows among them, Mamba-2, MoE, hybrid); the VLM and the
encoder-decoder are refused, as the reference's engine serves neither.
A config with Mamba-2 layers needs ``--chunk`` a multiple of its SSD
chunk length (128 for the full mamba2-2.7b, 16 reduced).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
        --full --chunk 128 --prompt-chunks 12 --prompt-len 1536

Resilient serving (``--fault``, repeatable, needs ``--pipelined`` >= 2;
the stages are virtual, so a lost stage is one of the ``P`` stage slots)
and the request lifecycle under overload (``--bursty`` arrivals at
``--rate`` calm and 5 x ``--rate`` in bursts, ``--deadline-s``,
``--max-queue``):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --pipelined 3 --fault device_loss@tick=40
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --pipelined 2 --requests 16 --bursty --deadline-s 30 --max-queue 4

``--pipelined 0`` is single-host batched serving: one ``LM.prefill`` of
``--batch`` prompts of ``--prompt-len`` tokens, then ``--gen`` - 1
``decode_step`` s, greedy or sampled at ``--temperature``:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --pipelined 0 --batch 4 --prompt-len 32 --gen 16

Runs on CUDA unless ``--device cpu``; ``--kernels plain`` swaps the
hand-written kernels for plain PyTorch.  Weights are random, drawn from
a ``torch.Generator`` seeded with 0; the traffic is seeded with 0 too,
the batched prompts with 1 (numpy) and the sampling with 2.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="pipelined: sizes the slot buffer, max_seq = "
                         "prompt-len + gen + 4 * chunk; batched: the "
                         "prompt length")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts of batched serving (--pipelined 0)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="batched serving: 0 is greedy, above it sampled")
    ap.add_argument("--prompt-chunks", type=int, default=4,
                    help="most prefill chunks per prompt (prompts are 1 "
                         "to this many chunks long)")
    ap.add_argument("--gen", type=int, default=16,
                    help="most new tokens per request")
    ap.add_argument("--gen-min", type=int, default=4,
                    help="fewest new tokens per request")
    ap.add_argument("--reduced", dest="reduced", action="store_true",
                    help="tiny smoke config (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full-size config")
    ap.set_defaults(reduced=True)
    ap.add_argument("--pipelined", type=int, default=1, metavar="P",
                    help="virtual pipeline stages of the engine (0: "
                         "single-host batched serving)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill sequence-chunk length")
    ap.add_argument("--slots", type=int, default=0,
                    help="request slots (default P)")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic requests to serve")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate, req/s")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=("fused", "plain"), default="fused")
    ap.add_argument("--bursty", action="store_true",
                    help="two-state bursty arrivals instead of stationary "
                         "Poisson")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request completion deadline in seconds "
                         "(default: none)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission queue bound; overload beyond it is "
                         "load-shed (default: unbounded)")
    ap.add_argument("--fault", action="append", default=[], metavar="SPEC",
                    help="inject a serving fault, e.g. device_loss@tick=40, "
                         "slot_corruption@tick=9,slot=1, hung_tick@tick=7, "
                         "straggler@tick=5,n_ticks=4,factor=8 (repeatable; "
                         "needs --pipelined >= 2)")
    return ap


def validate_args(args) -> None:
    """Reject malformed arguments with a one-line error.  The stages are
    virtual, so no device count bounds ``--pipelined``."""
    def die(msg):
        raise SystemExit(f"error: {msg}")
    if args.pipelined < 0:
        die(f"--pipelined must be >= 0, got {args.pipelined}")
    if args.requests < 1:
        die(f"--requests must be >= 1, got {args.requests}")
    if args.rate <= 0:
        die(f"--rate must be > 0 req/s, got {args.rate}")
    if args.chunk < 1:
        die(f"--chunk must be >= 1, got {args.chunk}")
    if args.prompt_chunks < 1:
        die(f"--prompt-chunks must be >= 1, got {args.prompt_chunks}")
    if args.slots < 0:
        die(f"--slots must be >= 0, got {args.slots}")
    if args.batch < 1:
        die(f"--batch must be >= 1, got {args.batch}")
    if not 1 <= args.gen_min <= args.gen:
        die(f"need 1 <= --gen-min <= --gen, got {args.gen_min} and "
            f"{args.gen}")
    if args.deadline_s is not None and args.deadline_s <= 0:
        die(f"--deadline-s must be > 0 seconds, got {args.deadline_s}")
    if args.max_queue is not None and args.max_queue < 0:
        die(f"--max-queue must be >= 0, got {args.max_queue}")
    if args.fault and args.pipelined <= 1:
        die("--fault needs --pipelined P (>= 2)")
    from repro_torch.serve.resilience import parse_fault_spec
    for spec in args.fault:
        try:
            parse_fault_spec(spec)
        except ValueError as e:
            die(str(e))


def serve_batched(lm, params, prompts, gen: int, temperature: float = 0.0,
                  generator=None, keep_logits: bool = False) -> Dict:
    """Single-host batched serving: one ``lm.prefill`` of ``prompts``
    ([batch, prompt_len] token ids, numpy or torch; the flash kernel in
    every attention layer), then ``gen - 1`` ``lm.decode_step`` s, one
    position for the whole batch.  Greedy at ``temperature`` 0; above
    it each token is drawn by ``torch.multinomial`` from the softmax of
    logits / temperature with ``generator`` (the reference draws with
    ``jax.random.categorical``: the same distribution, not the same
    stream).  Returns ``{"tokens": [batch, gen], "logits": [...]
    (each step's [batch, V] with ``keep_logits``), "finite" (every
    step's logits), "prefill_s", "decode_s", "decode_steps"}``; the
    times end in a device synchronize."""
    import torch
    dev = lm.device
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=dev)
    B, S = tokens.shape
    cache = lm.init_cache(B, S + gen)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def sample(logits):
        if temperature <= 0:
            return logits.argmax(-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    sync()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, tokens, cache)
    sync()
    prefill_s = time.perf_counter() - t0
    kept = [logits] if keep_logits else []
    finite = torch.isfinite(logits).all()
    tok = sample(logits)
    out = [tok]
    t0 = time.perf_counter()
    for pos in range(S, S + gen - 1):
        logits, cache = lm.decode_step(params, tok, cache, pos)
        if keep_logits:
            kept.append(logits)
        finite &= torch.isfinite(logits).all()
        tok = sample(logits)
        out.append(tok)
    sync()
    return {"tokens": torch.cat(out, dim=1), "logits": kept,
            "finite": bool(finite), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0, "decode_steps": gen - 1}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv``, build the model, serve and print a summary.
    Pipelined: returns ``{"summary", "result", "requests", "config",
    "engine"}`` (``engine`` None for resilient serving, whose engines
    change with the depth); batched (``--pipelined 0``): ``{"result",
    "prompts", "config", "lm", "params"}``."""
    args = build_parser().parse_args(argv)
    validate_args(args)
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import LM
    from repro_torch.serve import (PipelinedEngine, bursty_requests,
                                   parse_fault_spec, poisson_requests,
                                   serve_resilient, summarize)
    from repro_torch.serve.engine import check_servable

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.pipelined == 0:
        return _main_batched(args, cfg)
    check_servable(cfg, args.chunk)
    lm = LM(cfg, kernels=args.kernels, device=args.device)
    gen = torch.Generator(device=lm.device).manual_seed(0)
    params = lm.init(gen)
    max_seq = args.prompt_len + args.gen + 4 * args.chunk
    if args.bursty:
        reqs = bursty_requests(args.requests, chunk=args.chunk,
                               max_seq=max_seq, rate_lo=args.rate,
                               rate_hi=5 * args.rate,
                               prompt_range=(1, args.prompt_chunks),
                               gen_range=(args.gen_min, args.gen),
                               deadline_s=args.deadline_s,
                               vocab=cfg.vocab_size, seed=0)
    else:
        reqs = poisson_requests(args.requests, args.rate, chunk=args.chunk,
                                max_seq=max_seq,
                                prompt_range=(1, args.prompt_chunks),
                                gen_range=(args.gen_min, args.gen),
                                vocab=cfg.vocab_size, seed=0)
        if args.deadline_s is not None:
            import dataclasses
            reqs = [dataclasses.replace(r, deadline=args.deadline_s)
                    for r in reqs]
    eng = None
    if args.fault:
        # the first engine takes the layer leaves over, as below; later
        # incarnations rebuild from the engine's own blocks
        res = serve_resilient(cfg, params, reqs, P=args.pipelined,
                              chunk=args.chunk, max_seq=max_seq,
                              n_slots=args.slots or None,
                              kernels=args.kernels, device=lm.device,
                              faults=[parse_fault_spec(f)
                                      for f in args.fault],
                              max_queue=args.max_queue,
                              consume_params=True)
        del params
        for r in res["recoveries"]:
            print(f"[serve] recovery @tick {r.tick} ({r.kind}): "
                  f"P {r.p_from}->{r.p_to} readmit={r.n_readmitted} "
                  f"remap={r.remap_s * 1e3:.0f}ms "
                  f"resume={r.resume_s * 1e3:.0f}ms")
    else:
        # the engine takes the layer leaves over: a copying pack (gemma3's
        # period-6 stacking against the layout's 1) frees each as it
        # packs it
        eng = PipelinedEngine(cfg, params, P=args.pipelined,
                              chunk=args.chunk, max_seq=max_seq,
                              n_slots=args.slots or None,
                              kernels=args.kernels, device=lm.device,
                              consume_params=True)
        del params      # the engine holds the stage-packed weights
        res = eng.serve(reqs, max_queue=args.max_queue)
    s = summarize(res)
    print(f"[serve] arch={cfg.name} device={lm.device} kernels="
          f"{args.kernels} P={args.pipelined} slots="
          f"{args.slots or args.pipelined} rate={args.rate}/s "
          f"reqs={s['requests']} toks={s['output_tokens']} "
          f"tok/s={s['tokens_per_s']:.1f}")
    if s["ttft_p50_s"] is not None:
        print(f"[serve] ttft p50={s['ttft_p50_s']:.3f}s "
              f"p99={s['ttft_p99_s']:.3f}s | per-token "
              f"p50={s['tok_p50_s'] * 1e3:.1f}ms "
              f"p99={s['tok_p99_s'] * 1e3:.1f}ms (first tick included)")
    c = res["counts"]
    if c["expired"] or c["shed"] or c["failed"] or c["retries"]:
        print(f"[serve] lifecycle: completed={c['completed']} "
              f"expired={c['expired']} shed={c['shed']} "
              f"failed={c['failed']} retries={c['retries']}")
    if res["finished"]:
        rid0 = min(res["finished"])
        print(f"[serve] sample rid={rid0}: "
              f"{res['finished'][rid0].tokens[:12]}")
    return {"summary": s, "result": res, "requests": reqs, "config": cfg,
            "engine": eng}


def _main_batched(args, cfg) -> Dict:
    """``--pipelined 0``: :func:`serve_batched` on ``--batch`` prompts of
    ``--prompt-len`` tokens drawn by numpy from seed 1."""
    import torch

    from repro_torch.models import LM
    lm = LM(cfg, kernels=args.kernels, device=args.device)
    params = lm.init(torch.Generator(device=lm.device).manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    out = serve_batched(lm, params, prompts, args.gen, args.temperature,
                        torch.Generator(device=lm.device).manual_seed(2))
    n_dec = max(out["decode_steps"], 1)
    print(f"[serve] arch={cfg.name} device={lm.device} kernels="
          f"{args.kernels} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} prefill={out['prefill_s'] * 1e3:.1f}ms "
          f"decode={out['decode_s'] / n_dec * 1e3:.2f}ms/token "
          f"(first call included)")
    print(f"[serve] sample: {out['tokens'][0, :12].tolist()}")
    return {"result": out, "prompts": prompts, "config": cfg, "lm": lm,
            "params": params}


if __name__ == "__main__":
    main(sys.argv[1:])
