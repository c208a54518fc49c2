"""The dry run's table: ``dryrun_torch_summary.md`` beside the results
directory, from the JSONs of :mod:`repro_torch.launch.dryrun`
(counterpart of ``repro/roofline/summarize.py``).

    PYTHONPATH=src python -m repro_torch.roofline.summarize

Every time in it is reckoned from counted work and the H100's peaks
(:mod:`repro_torch.roofline.analysis`), not measured.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS


def analytic_memory_bytes(arch: str, shape_name: str, chips: int = 1,
                          tp: int = 1) -> float:
    """First-principles HBM traffic per device per step (the reference's
    ``analytic_memory_term`` before its division by the bandwidth), for
    ``chips`` devices of which ``tp`` share a tensor-parallel group (the
    reference: 256 or 512 chips at ``tp=16``; one card: 1 and 1).  What
    a fused step moves:

      train:  weights 3 reads/mb (fwd+bwd+remat)  +  activations ~3x
              stored bytes  +  optimizer state read+write  +  fp32 grad
              accum read+write per microbatch  +  logits r/w per mb
      serve:  weights 1 read per step + KV cache read (+write slice)
    """
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.analysis import MemoryModel
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    dp = max(chips // tp, 1)
    mm = MemoryModel.build(cfg, tp=tp)
    n = cfg.param_count()
    nact = cfg.active_param_count()
    if shape.kind == "train":
        mb = dryrun.MICROBATCH                       # default_plan's
        mb_local_tokens = mb * shape.seq_len
        m = max(1, shape.global_batch // (mb * dp))
        w_read = 3 * m * (2 * nact / tp)             # bf16 active weights
        act = 3 * m * mm.act_per_token_layer * mb_local_tokens \
            * cfg.num_layers
        states = 2 * 16 * n / chips
        gacc = 2 * m * 4 * n / chips
        logits = 2 * m * 4 * mb_local_tokens * cfg.vocab_size / tp
        return w_read + act + states + gacc + logits
    if shape.kind == "prefill":
        tokens_local = shape.global_batch * shape.seq_len / dp
        return 2 * nact / tp + mm.act_per_token_layer * tokens_local \
            * cfg.num_layers + 2 * tokens_local * cfg.vocab_size / tp
    hd = cfg.resolved_head_dim                       # decode: one token
    attn_layers = sum(1 for i in range(cfg.num_layers)
                      if cfg.layer_kind(i) == "attn")
    kv = (2 * 2 * attn_layers * cfg.num_kv_heads * hd
          * shape.seq_len * shape.global_batch) / chips
    return 2 * nact / tp + kv


def analytic_memory_term(arch: str, shape_name: str, chips: int = 1,
                         tp: int = 1, hbm_bw: float = HBM_BW) -> float:
    """:func:`analytic_memory_bytes` over ``hbm_bw``, in seconds."""
    return analytic_memory_bytes(arch, shape_name, chips, tp) / hbm_bw


def load(results: str = None):
    """tag -> {(arch, shape): cell dict} of the dry run's JSONs."""
    out = {}
    for p in sorted(glob.glob(os.path.join(results or dryrun.RESULTS,
                                           "*.json"))):
        with open(p) as f:
            d = json.load(f)
        out.setdefault(d.get("tag", "?"), {})[(d["arch"], d["shape"])] = d
    return out


def fmt_cell(d):
    if d["status"] == "skipped":
        return ["skip"] + [""] * 10
    if d["status"] != "ok":
        return ["ERROR"] + [""] * 10
    r, mem = d["roofline"], d["memory"]
    t_an = analytic_memory_term(d["arch"], d["shape"])
    return ["ok", f"{r['flops_per_device']:.4g}",
            f"{r['t_compute_s']:.4g}", f"{r['t_memory_s']:.4g}",
            f"{t_an:.4g}", f"{r['t_collective_s']:.4g}", r["dominant"],
            f"{r['useful_ratio']:.3f}", f"{r['roofline_fraction']:.4f}",
            f"{mem['predicted']['total'] / 1e9:.1f}",
            "yes" if mem["fits_80gb"] else "no"]


def main(results: str = None) -> str:
    results = results or dryrun.RESULTS
    out = os.path.join(os.path.dirname(results), "dryrun_torch_summary.md")
    lines = ["# One-card dry run + roofline (generated)", "",
             f"Reckoned on an H100's peaks ({PEAK_FLOPS / 1e12:g} TFLOP/s "
             f"bf16, {HBM_BW / 1e12:g} TB/s), from work counted on the "
             "meta device: not measured.  t_mem reads every executed "
             "op's bytes (the eager step's traffic, score-class tensors "
             "in); t_mem_fused is the analytic traffic of a fused step.",
             ""]
    for tag, cells in sorted(load(results).items()):
        lines += [f"## {tag}", "",
                  "| arch | shape | status | FLOP | t_comp(s) | t_mem(s) | "
                  "t_mem_fused(s) | t_coll(s) | dominant | useful | "
                  "roofline_frac | predicted GB | fits 80 GB |",
                  "|" + "---|" * 13]
        for (arch, shape), d in sorted(cells.items()):
            lines.append("| " + " | ".join([arch, shape] + fmt_cell(d))
                         + " |")
        n = {s: sum(d["status"] == s for d in cells.values())
             for s in ("ok", "skipped", "error")}
        lines += ["", f"cells: ok={n['ok']} skipped={n['skipped']} "
                  f"error={n['error']}", ""]
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
