#!/usr/bin/env python3
"""Where the multi-rank pipeline's first step and peak memory go, on one
CUDA card (phase 6's configuration of ``chip_smoke.py``: tinyllama-1.1b
at full width, chronos_zb, P=4, v=2, 8 microbatches of one 2049-token
sequence, bf16, fused kernels).

    python3 scripts/torch_rank_probe.py

1. A fresh process trains the one-process pipeline 2 steps: its first
   step against its second is what a cold process pays before its
   first step runs warm (phase 27's four ranks each pay it at once).
2. Four ranks (gloo through page-locked host memory) train 2 steps with
   the overlapped exchange; each rank records its allocated memory and
   its peak since the last mark after every op of its column, around
   the shared-gradient reduction, the AdamW update and the replicas'
   digest.  Ranks 0 and 3 print their largest peaks and where they
   occurred, beside the memory allocated when the weights and the
   optimizer state were made.

Prints the card's name and power limit first.  Needs one CUDA card.
"""
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

GiB = 2 ** 30


def _config():
    from chip_smoke import _train_config
    return _train_config("tinyllama-1.1b")


def fresh_process() -> None:
    """Part 1, in a process of its own."""
    import torch

    from repro_torch.launch.train import train_pipeline
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    up = time.perf_counter() - t
    out = train_pipeline(_config(), P=4, device="cuda", steps=2,
                         log=lambda s: None)
    print(f"[rank-probe] a fresh process (CUDA up in {up:.1f} s), the "
          f"one-process pipeline: steps {[round(s, 2) for s in out['step_s']]}"
          f" s", flush=True)


def rank_body(mesh, tc):
    """Part 2, on each rank."""
    import torch

    from repro_torch.core import pipeline_runtime as rt
    from repro_torch.launch import train as tr
    marks = []

    def mark(what):
        torch.cuda.synchronize()
        marks.append((what, torch.cuda.memory_allocated() / GiB,
                      torch.cuda.max_memory_allocated() / GiB))
        torch.cuda.reset_peak_memory_stats()

    def around(owner, name, label):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            mark(f"before {label}")
            out = fn(*a, **k)
            mark(label)
            return out
        setattr(owner, name, wrapped)

    op = rt._RankExecutor._op

    def op_marked(self, d, row, *a):
        out = op(self, d, row, *a)
        mark(f"op {int(row[0])} chunk {int(row[1])} microbatch "
             f"{int(row[2])}")
        return out
    rt._RankExecutor._op = op_marked
    around(rt._RankExecutor, "_reduce", "the shared-gradient reduction")
    around(rt, "adamw_update", "the AdamW update")
    around(tr, "shared_digest", "the replicas' digest")
    out = tr.train_pipeline(tc, P=4, mesh=mesh, overlap=True, steps=2,
                            after_step=lambda _, p, o, s: tr.replicas_equal(
                                mesh, p, o, s), log=lambda s: None)
    if mesh.rank in (0, 3):
        lines = [f"rank {mesh.rank}: weights and optimizer state "
                 f"{out['static_bytes'] / GiB:.3f} GiB; the largest peaks"]
        for what, alloc, peak in sorted(marks, key=lambda m: -m[2])[:4]:
            lines.append(f"  {peak:.3f} GiB within {what} ({alloc:.3f} "
                         f"allocated after it)")
        for what, alloc, peak in marks[-6:]:
            lines.append(f"  {what}: peak {peak:.3f}, allocated "
                         f"{alloc:.3f} GiB")
        print("\n".join(f"[rank-probe] {x}" for x in lines), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: needs a CUDA card")
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build()
    t = time.perf_counter()
    r = subprocess.run([sys.executable, __file__, "--fresh"])
    if r.returncode:
        sys.exit(r.returncode)
    print(f"[rank-probe] that process took {time.perf_counter() - t:.1f} s",
          flush=True)
    spawn(4, rank_body, args=(_config(),), backend="gloo",
          device="cuda", timeout_s=600)


if __name__ == "__main__":
    fresh_process() if sys.argv[1:] == ["--fresh"] else main()
