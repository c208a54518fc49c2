#!/usr/bin/env python3
"""Host time of the kernel wrappers with no count running, for the
checkout at ``root``, on one CUDA card.

    python3 scripts/torch_wrapper_host_cost.py <root> <label>

Runs ``<root>/chip_smoke.py``'s phase 3 rmsnorm and flash cases (their
eager call-to-call times, host-bound) and phase 4 (the serving CLI:
per-token p50 and p99, tokens/s), and prints one ``HOST`` line with the
card's name and power limit.  Compare two checkouts in one call, in the
order parent, change, change, parent: host noise between a checkout's
own runs is the yardstick.
"""
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip().splitlines()[0]
build.build()
build.load_library()
gen = torch.Generator(device="cuda").manual_seed(0)
r = cs.phase_rmsnorm(torch, gen)
f = cs.phase_flash(torch, gen)
_, eng, s = cs.phase_serve(torch)
print(f"HOST {sys.argv[2]} {smi}: rmsnorm eager {r['eager_ms'] * 1e3:.3f} "
      f"us, flash eager {f['eager_ms'] * 1e3:.3f} us, serve per-token p50 "
      f"{s['tok_p50_s'] * 1e3:.3f} ms p99 {s['tok_p99_s'] * 1e3:.3f} ms "
      f"tokens/s {s['tokens_per_s']:.2f}", flush=True)
