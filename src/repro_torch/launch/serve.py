"""Serving entry point of the port: the pipelined engine (seq-chunked
prefill + steady-tick decode with continuous batching) on one device.

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

Runs on CUDA unless ``--device cpu``; ``--kernels plain`` swaps the
hand-written kernels for plain PyTorch.  Weights are random, drawn from
a ``torch.Generator`` seeded with 0; the traffic is seeded with 0 too.
``--fault``, ``--bursty``, ``--deadline-s`` and ``--max-queue``
(resilient serving) and ``--pipelined 0`` (single-host batched serving)
are not ported yet and are rejected.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="sizes the slot buffer: max_seq = prompt-len + "
                         "gen + 4 * chunk")
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
                    help="virtual pipeline stages of the engine")
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
    # resilient serving: not ported yet (rejected by validate_args)
    ap.add_argument("--bursty", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--max-queue", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", action="append", default=[],
                    help=argparse.SUPPRESS)
    return ap


def validate_args(args) -> None:
    """Reject malformed or not-yet-ported arguments with a one-line
    error."""
    def die(msg):
        raise SystemExit(f"error: {msg}")
    for flag, on in (("--fault", args.fault), ("--bursty", args.bursty),
                     ("--deadline-s", args.deadline_s is not None),
                     ("--max-queue", args.max_queue is not None)):
        if on:
            die(f"{flag} (resilient serving) is not ported to repro_torch "
                "yet")
    if args.pipelined < 1:
        die(f"--pipelined must be >= 1 (single-host batched serving is not "
            f"ported yet), got {args.pipelined}")
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
    if not 1 <= args.gen_min <= args.gen:
        die(f"need 1 <= --gen-min <= --gen, got {args.gen_min} and "
            f"{args.gen}")


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv``, build the model and engine, serve the synthetic
    traffic and print a summary.  Returns ``{"summary", "result",
    "requests", "config", "engine"}`` for programmatic callers."""
    args = build_parser().parse_args(argv)
    validate_args(args)
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import LM
    from repro_torch.serve import PipelinedEngine, poisson_requests, summarize
    from repro_torch.serve.engine import check_servable

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_servable(cfg, args.chunk)
    lm = LM(cfg, kernels=args.kernels, device=args.device)
    gen = torch.Generator(device=lm.device).manual_seed(0)
    params = lm.init(gen)
    max_seq = args.prompt_len + args.gen + 4 * args.chunk
    reqs = poisson_requests(args.requests, args.rate, chunk=args.chunk,
                            max_seq=max_seq,
                            prompt_range=(1, args.prompt_chunks),
                            gen_range=(args.gen_min, args.gen),
                            vocab=cfg.vocab_size, seed=0)
    # the engine takes the layer leaves over: a copying pack (gemma3's
    # period-6 stacking against the layout's 1) frees each as it packs it
    eng = PipelinedEngine(cfg, params, P=args.pipelined, chunk=args.chunk,
                          max_seq=max_seq, n_slots=args.slots or None,
                          kernels=args.kernels, device=lm.device,
                          consume_params=True)
    del params      # the engine holds the stage-packed weights
    res = eng.serve(reqs)
    s = summarize(res)
    print(f"[serve] arch={cfg.name} device={lm.device} kernels="
          f"{args.kernels} P={args.pipelined} slots={eng.n_slots} "
          f"rate={args.rate}/s reqs={s['requests']} "
          f"toks={s['output_tokens']} tok/s={s['tokens_per_s']:.1f}")
    if s["ttft_p50_s"] is not None:
        print(f"[serve] ttft p50={s['ttft_p50_s']:.3f}s "
              f"p99={s['ttft_p99_s']:.3f}s | per-token "
              f"p50={s['tok_p50_s'] * 1e3:.1f}ms "
              f"p99={s['tok_p99_s'] * 1e3:.1f}ms (first tick included)")
    if res["finished"]:
        rid0 = min(res["finished"])
        print(f"[serve] sample rid={rid0}: "
              f"{res['finished'][rid0].tokens[:12]}")
    return {"summary": s, "result": res, "requests": reqs, "config": cfg,
            "engine": eng}


if __name__ == "__main__":
    main(sys.argv[1:])
