#!/usr/bin/env python3
"""The plain AdamW update's share of a training peak, on one NVIDIA card.

    python3 scripts/torch_update_peak.py

Trains ``chip_smoke.py``'s phase 16 (b) run (the planner's pick for
deepseek-7b's width at the depth it says fits: 24 layers, chronos_seq
v=2, 4 sequence chunks, the shallow chunk recomputed, the deep chunk's
AdamW on the host; 16 sequences of 2049 tokens, 3 steps) three times, in
turns: with the plain update over whole leaves (each leaf's fp32
temporaries at the size of the stacked leaf), over ``SLAB``-element
slabs (``repro_torch.optim.adamw``, the port's update), then whole
leaves again.  Each run prints, per step, the peak up to the update and
within it (``chip_smoke.planner_run``) and its losses, which agree
bitwise across the three runs (the slabs change no element's
arithmetic).  Needs one card and the checkout's ``src``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))


def main() -> None:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("this measurement needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (OptimizerConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.kernels import build
    from repro_torch.optim import adamw
    from repro_torch.plan import plan_under_budget
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build()
    build.load_library()
    hbm = torch.cuda.get_device_properties(0).total_memory / 4
    cfg = dataclasses.replace(get_config("deepseek-7b"), num_layers=24)
    ep = plan_under_budget(cfg, pp=4, tp=1, hbm_bytes=hbm, microbatch=1,
                           seq_len=cs.TRAIN_SEQ)
    tc = TrainConfig(model=cfg, shape=ShapeConfig(
        "train_2k", seq_len=cs.TRAIN_SEQ, global_batch=ep.m, kind="train"),
        plan=ep.parallel_plan(), optimizer=OptimizerConfig(
            warmup_steps=2, total_steps=4), seed=0, log_every=1)
    slabbed = adamw._slabs

    def whole(g, *state):
        return [(g,) + state]

    peaks = []
    for label, slabs in (("whole-leaf", whole), ("slabbed", slabbed),
                         ("whole-leaf", whole)):
        adamw._slabs = slabs
        try:
            _, peak, med = cs.planner_run(torch, f"update-{label}", tc, 3)
        finally:
            adamw._slabs = slabbed
        peaks.append((label, peak, med))
        cs.done(label)
    for label, peak, med in peaks:
        print(f"[update-peak] {label}: peak {peak / 2 ** 30:.3f} GiB, "
              f"median step {med * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
