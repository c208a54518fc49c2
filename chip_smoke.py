#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: the ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc`` for sm_90a;
3. each kernel against its plain PyTorch version on the card, at the
   serving shapes, in bf16 and fp32, and timed beside the plain version,
   a one-call PyTorch yardstick and the card's bound (device time per
   call from CUDA-graph replay; the eager call-to-call time beside it);
4. serve: full-width tinyllama-1.1b (bf16, random weights from seed 0)
   through ``repro_torch.launch.serve.main``: 8 requests, 4 slots,
   64-token chunks; checks every request and the kernels' launch counts;
   a warm re-run on the same engine gives the numbers without start-up
   costs, and a profiled one says where the device time goes;
5. checks: P=2 virtual stages give P=1's token streams, and the fused and
   plain backends agree on fp32 logits (2 layers, full width);
6. a JSON ``kernels`` line, then the JSON result line.

Needs one CUDA card and imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores

SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--full", "--pipelined", "1",
              "--slots", "4", "--chunk", "64", "--requests", "8",
              "--rate", "1e9", "--gen", "32", "--gen-min", "16",
              "--prompt-len", "224", "--device", "cuda",
              "--kernels", "fused"]          # max_seq = 224 + 32 + 4 * 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn`` call, free of host launch overhead:
    ``reps`` calls captured in a CUDA graph, replayed ``iters`` times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rel_ok(got, want, atol: float, rtol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def phase_rmsnorm(torch, gen):
    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    import torch.nn.functional as F
    d, eps = 2048, 1e-6
    # bf16 results may differ by one rounding step: 2^-7 relative
    tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
    worst = 0.0
    for dt, (atol, rtol) in tols.items():
        for R in (1, 64, 300):
            x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device="cuda")).to(dt)
            got = rmsnorm_rows(x, scale, eps)
            torch.cuda.synchronize()
            want = rmsnorm_rows_ref(x, scale, eps)
            err = max_err(got, want)
            ok = rel_ok(got, want, atol, rtol)
            print(f"[kernels] rmsnorm_rows {str(dt)[6:]} R={R} d={d}: "
                  f"max|d|={err:.3e} tol={atol:g}+{rtol:g}*|ref| "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"rmsnorm_rows disagrees with its plain version "
                     f"({dt}, R={R})")
            worst = max(worst, err)
    # main-path shape: one 64-token prefill chunk, bf16
    R, dt = 64, torch.bfloat16
    x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
    scale = torch.ones((d,), dtype=dt, device="cuda")
    ms = graph_ms(lambda: rmsnorm_rows(x, scale, eps))
    eager_ms = time_ms(lambda: rmsnorm_rows(x, scale, eps))
    plain_ms = graph_ms(lambda: rmsnorm_rows_ref(x, scale, eps))
    lib_ms = graph_ms(lambda: F.rms_norm(x, (d,), scale, eps)) \
        if hasattr(F, "rms_norm") else None
    nbytes = (2 * R * d + d) * x.element_size()
    flops = 4 * R * d
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / FP32_FLOPS * 1e3}
    bound_by = max(bounds, key=bounds.get)
    print(f"[kernels] rmsnorm_rows timed at x [{R}, {d}] bf16 (device time "
          f"per call, CUDA graph): kernel {ms * 1e3:.2f} us (eager "
          f"call-to-call {eager_ms * 1e3:.2f} us), plain "
          f"{plain_ms * 1e3:.2f} us, "
          f"F.rms_norm {'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}"
          f", bound {bounds[bound_by] * 1e3:.4f} us ({bound_by})")
    return {"name": "rmsnorm_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:18",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "library_ms": lib_ms, "eager_ms": eager_ms,
            "timed_shape": f"x [{R},{d}] bf16"}


def _visible_pairs(Sq, Sk, q_offset, window, prefix):
    """(visible (q, k) pairs, kv rows the visible pairs touch), causal."""
    pairs, k_rows = 0, 0
    for i in range(Sq):
        qp = q_offset + i
        hi = min(qp, Sk - 1)                        # causal: k <= q
        lo = max(0, qp - window + 1) if window else 0
        ks = set(range(lo, hi + 1)) if hi >= lo else set()
        if prefix:
            ks |= set(range(min(prefix, Sk)))
        pairs += len(ks)
        if ks:
            k_rows = max(k_rows, max(ks) + 1)
    return pairs, k_rows


def phase_flash(torch, gen):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    import torch.nn.functional as F
    tols = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-5)}
    # (Sq, H, Sk, G, d, q_offset, window, prefix)
    cases = [(64, 32, 512, 4, 64, 0, 0, 0), (64, 32, 512, 4, 64, 64, 0, 0),
             (64, 32, 512, 4, 64, 448, 0, 0),
             (64, 32, 500, 4, 64, 436, 0, 0),      # Sk not a tile multiple
             (64, 32, 512, 4, 64, 448, 128, 0),    # sliding window
             (64, 32, 512, 4, 64, 64, 0, 16),      # prefix
             (50, 32, 512, 4, 64, 128, 0, 0),      # ragged q tile
             (64, 8, 512, 2, 16, 64, 0, 0)]        # reduced config's hd
    worst, worst_lse = 0.0, 0.0
    for dt, (tol_o, tol_lse) in tols.items():
        for Sq, H, Sk, G, d, off, win, pre in cases:
            q = torch.randn((1, Sq, H, d), generator=gen,
                            device="cuda").to(dt)
            k = torch.randn((1, Sk, G, d), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((1, Sk, G, d), generator=gen,
                            device="cuda").to(dt)
            o, lse = flash_attention_fwd(q, k, v, causal=True, window=win,
                                         prefix=pre, q_offset=off)
            torch.cuda.synchronize()
            o_ref, lse_ref = attention_ref(q, k, v, causal=True, window=win,
                                           prefix=pre, q_offset=off)
            e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
            ok = e_o <= tol_o and e_l <= tol_lse
            print(f"[kernels] flash_attention_fwd {str(dt)[6:]} q [1,{Sq},"
                  f"{H},{d}] kv [1,{Sk},{G},{d}] off={off} window={win} "
                  f"prefix={pre}: max|d| o={e_o:.3e} (tol {tol_o:g}) "
                  f"lse={e_l:.3e} (tol {tol_lse:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail("flash_attention_fwd disagrees with attention_ref")
            worst, worst_lse = max(worst, e_o), max(worst_lse, e_l)
    # main-path shape: a 64-token prefill chunk at offset 192 (the last
    # chunk of a 256-token prompt) over the 512-slot bf16 cache
    Sq, H, Sk, G, d, off, dt = 64, 32, 512, 4, 64, 192, torch.bfloat16
    q = torch.randn((1, Sq, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, Sk, G, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, Sk, G, d), generator=gen, device="cuda").to(dt)
    ms = graph_ms(lambda: flash_attention_fwd(q, k, v, q_offset=off))
    eager_ms = time_ms(lambda: flash_attention_fwd(q, k, v, q_offset=off))
    plain_ms = graph_ms(lambda: attention_ref(q, k, v, q_offset=off))
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    pos_q = off + torch.arange(Sq, device="cuda")[:, None]
    mask = torch.arange(Sk, device="cuda")[None, :] <= pos_q
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    pairs, k_rows = _visible_pairs(Sq, Sk, off, 0, 0)
    el = q.element_size()
    nbytes = 2 * Sq * H * d * el + 2 * k_rows * G * d * el + H * Sq * 4
    flops = 4 * H * d * pairs
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / BF16_FLOPS * 1e3}
    bound_by = max(bounds, key=bounds.get)
    print(f"[kernels] flash_attention_fwd timed at q [1,{Sq},{H},{d}] kv "
          f"[1,{Sk},{G},{d}] bf16 q_offset={off} (device time per call, "
          f"CUDA graph): kernel {ms * 1e3:.2f} us (eager call-to-call "
          f"{eager_ms * 1e3:.2f} us), "
          f"plain {plain_ms * 1e3:.2f} us, SDPA {lib_ms * 1e3:.2f} us, "
          f"bound {bounds[bound_by] * 1e3:.4f} us ({bound_by}; {pairs} "
          f"visible pairs per head, {k_rows} kv rows)")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
            "max_abs_err": worst, "lse_max_abs_err": worst_lse, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds[bound_by],
            "bound_by": bound_by, "library_ms": lib_ms, "eager_ms": eager_ms,
            "timed_shape": f"q [1,{Sq},{H},{d}] kv [1,{Sk},{G},{d}] bf16 "
                           f"q_offset={off}"}


def phase_serve(torch):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_rows
    from repro_torch.launch.serve import main as serve_main
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_rows.launches = 0
    flash_attention_fwd.launches = 0
    out = serve_main(SERVE_ARGV)
    launches = {"rmsnorm_rows": rmsnorm_rows.launches,
                "flash_attention_fwd": flash_attention_fwd.launches}
    peak = torch.cuda.max_memory_allocated()
    s, res, reqs, cfg = (out["summary"], out["result"], out["requests"],
                         out["config"])
    chunk = 64
    n_prefill = sum(len(r.prompt) // chunk for r in reqs)
    n_decode = sum(r.max_new - 1 for r in reqs)
    print(f"[serve] {cfg.name} full width bf16: requests={s['requests']} "
          f"prefill_chunks={n_prefill} decode_ticks={n_decode} "
          f"ticks={s['ticks']} tokens/s={s['tokens_per_s']:.2f} "
          f"ttft p50={s['ttft_p50_s'] * 1e3:.2f}ms "
          f"p99={s['ttft_p99_s'] * 1e3:.2f}ms per-token "
          f"p50={s['tok_p50_s'] * 1e3:.3f}ms p99={s['tok_p99_s'] * 1e3:.3f}ms"
          f" max_memory_allocated={peak / 2 ** 30:.3f}GiB")
    print(f"[serve] launches {launches}")
    if len(reqs) != 8 or set(res["finished"]) != {r.rid for r in reqs}:
        fail(f"not every request completed: {sorted(res['finished'])}")
    for r in reqs:
        got = len(res["finished"][r.rid].tokens)
        if got != r.max_new:
            fail(f"request {r.rid} got {got} tokens, asked {r.max_new}")
    if res["nonfinite_logits"]:
        fail(f"{res['nonfinite_logits']} sampled waves had non-finite logits")
    if res["stage_runs"] != {"prefill": n_prefill, "decode": n_decode}:
        fail(f"stage runs {res['stage_runs']} != prefill {n_prefill}, "
             f"decode {n_decode}")
    want = {"rmsnorm_rows": 2 * cfg.num_layers * (n_prefill + n_decode),
            "flash_attention_fwd": cfg.num_layers * n_prefill}
    if launches != want:
        fail(f"kernel launches {launches} != expected {want}")
    return launches, out["engine"]


def phase_profile(torch, eng):
    """Where the serve path's time goes, on the warm engine of phase 4:
    4 more requests served once with tracing off (the warm end-to-end
    numbers), then the same 4 again under ``torch.profiler`` for the
    device busy share and the device time by kernel family.  The ratio of
    the two wall times is the profiler's overhead."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import poisson_requests, summarize
    reqs = poisson_requests(4, 1e9, chunk=64, max_seq=eng.max_seq,
                            gen_range=(16, 16), vocab=eng.cfg.vocab_size,
                            seed=1)
    warm = summarize(eng.serve(reqs))
    print(f"[serve-warm] same engine, {warm['requests']} more requests, "
          f"tracing off: tokens/s={warm['tokens_per_s']:.2f} "
          f"ticks={warm['ticks']} wall/tick="
          f"{warm['elapsed_s'] / warm['ticks'] * 1e3:.3f}ms "
          f"ttft p50={warm['ttft_p50_s'] * 1e3:.2f}ms "
          f"per-token p50={warm['tok_p50_s'] * 1e3:.3f}ms "
          f"p99={warm['tok_p99_s'] * 1e3:.3f}ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.serve(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fams = {"rmsnorm_rows (ours)": 0.0, "flash_attention_fwd (ours)": 0.0,
            "matmul": 0.0, "other": 0.0}
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue                  # host ops; their kernels are listed
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev <= 0:
            continue
        rows.append((dev, e.count, e.key))
        name = e.key.lower()
        if "rmsnorm_rows_kernel" in name:
            fams["rmsnorm_rows (ours)"] += dev
        elif "flash_fwd_kernel" in name:
            fams["flash_attention_fwd (ours)"] += dev
        elif any(t in name for t in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet", "cublas")):
            fams["matmul"] += dev
        else:
            fams["other"] += dev
    busy = sum(fams.values())
    ticks = res["ticks"]
    if busy <= 0:
        print("[profile] the profiler reported no device time: device "
              "breakdown not measured")
        return
    print(f"[profile] serve of {len(reqs)} requests, {ticks} ticks, "
          f"{sum(len(r.tokens) for r in res['finished'].values())} tokens: "
          f"wall {wall_us / 1e3:.1f} ms (profiled; "
          f"{wall_us / 1e6 / warm['elapsed_s']:.2f}x the untraced run), "
          f"device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, "
          f"idle {100 - 100 * busy / wall_us:.1f}%; "
          f"{wall_us / ticks / 1e3:.2f} ms wall per tick")
    for fam, us in fams.items():
        print(f"[profile]   {fam}: {us / 1e3:.2f} ms "
              f"({100 * us / busy:.1f}% of device time)")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   top: {dev / 1e3:8.2f} ms x{count:<6d} {key[:90]}")


def phase_checks(torch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import PipelinedEngine, Request
    cfg = get_config("tinyllama-1.1b")
    # (a) P=2 virtual stages vs P=1 on the same card: identical streams
    lm = LM(cfg, device="cuda")
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (64 * (i + 1),), generator=rng).tolist(),
        max_new=8) for i in range(2)]
    streams = {}
    for P in (1, 2):
        eng = PipelinedEngine(cfg, params, P=P, chunk=64, max_seq=256,
                              n_slots=2, device="cuda")
        res = eng.serve(reqs, clock=None)
        streams[P] = {rid: rec.tokens for rid, rec in res["finished"].items()}
        del eng
    print(f"[check] P=2 streams {'==' if streams[1] == streams[2] else '!='}"
          f" P=1 streams: {streams[1]}")
    if streams[1] != streams[2]:
        fail(f"P=2 token streams {streams[2]} differ from P=1 {streams[1]}")
    del params, lm
    # (b) full width, fp32, 2 layers: fused kernels vs plain backend
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    fused = LM(cfg32, kernels="fused", device="cuda")
    plain = LM(cfg32, kernels="plain", device="cuda")
    params = fused.init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=rng
                           ).to("cuda")
    caches = {"fused": fused.init_cache(1, 256),
              "plain": plain.init_cache(1, 256)}
    worst, steps = 0.0, 0
    tok = None
    pos = 0
    for step in range(6):          # 2 prefill chunks, then 4 decode steps
        logits = {}
        for name, lm_ in (("fused", fused), ("plain", plain)):
            if step < 2:
                logits[name], _ = lm_.prefill_chunk(
                    params, prompt[:, 64 * step:64 * (step + 1)],
                    caches[name], pos)
            else:
                logits[name], _ = lm_.decode_step(params, tok, caches[name],
                                                  pos)
        if not bool(torch.isfinite(logits["fused"]).all()):
            fail("non-finite fp32 logits")
        if logits["fused"].shape != (1, cfg.vocab_size):
            fail(f"logits shape {tuple(logits['fused'].shape)}")
        worst = max(worst, max_err(logits["fused"], logits["plain"]))
        pos += 64 if step < 2 else 1
        tok = logits["fused"].argmax(-1, keepdim=True)   # teacher forcing
        steps += 1
    tol = 1e-3
    print(f"[check] fp32 full width 2 layers, fused vs plain logits over "
          f"{steps} steps: max|d|={worst:.3e} (tol {tol:g})")
    if not worst <= tol:
        fail("fused and plain backends disagree on fp32 logits")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    path = build.build()
    how = "built by nvcc" if build.build_seconds is not None \
        else "already built"
    print(f"[build] {os.path.relpath(path, HERE)} {how}, "
          f"{time.perf_counter() - t0:.1f}s")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")
    build.load_library()

    # 3. kernels vs plain at the serving shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [phase_rmsnorm(torch, gen), phase_flash(torch, gen)]

    # 4. serve at full width through the CLI's main(), then a profiled
    #    second run on the same engine
    launches, eng = phase_serve(torch)
    phase_profile(torch, eng)
    del eng

    # 5. serve checks
    phase_checks(torch)

    # 6. kernels line, then the result line
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
