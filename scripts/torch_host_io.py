#!/usr/bin/env python3
"""The host-side rates a checkpoint of the port moves at, on one CUDA card.

    python3 scripts/torch_host_io.py

A tree shaped like the elastic drill's P=3 checkpoint of tinyllama-1.1b
at 8 layers (38 leaves, 4.87 GB) is copied device -> host into pageable
and page-locked buffers (three rounds: the first pays the pinning, the
caching host allocator serves the next), written as one file a leaf to
a temporary directory from 1, 4 and 8 threads, read back by
``np.fromfile`` and by ``readinto`` page-locked buffers from 1, 4 and 8
threads, copied host -> device from pageable and page-locked memory, and
flushed with ``os.sync``.  ``repro_torch.ft.checkpoint`` takes its
design from these numbers (page-locked buffers, ``IO_THREADS`` files at
once).  Prints the card's name and power limit first.
"""
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

GB = 1e9
SIZES = [369_098_752] * 8 + [131_072_000] * 6 + [47_185_920] * 24  # bytes


def timed(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def pool(n, fn, items):
    with ThreadPoolExecutor(n) as ex:
        for f in [ex.submit(fn, i) for i in items]:
            f.result()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_host_io: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    tot = sum(SIZES) / GB
    dev = [torch.full((s // 4,), 1.5, device="cuda") for s in SIZES]
    torch.cuda.synchronize()
    print(f"tree {tot:.2f} GB in {len(SIZES)} fp32 leaves")

    def rate(what, s):
        print(f"{what}: {s:.3f} s, {tot / s:.2f} GB/s", flush=True)
    rate("device->host pageable", timed(
        lambda: [d.to("cpu", copy=True) for d in dev]))
    for k in range(3):
        t0 = time.perf_counter()
        host = [torch.empty(d.shape, pin_memory=True) for d in dev]
        alloc = time.perf_counter() - t0
        s = timed(lambda: [h.copy_(d) for h, d in zip(host, dev)])
        rate(f"device->host page-locked, round {k} (allocation "
             f"{alloc:.3f} s)", s)
    d = tempfile.mkdtemp()
    try:
        def write(i):
            with open(f"{d}/l{i}", "wb") as f:
                f.write(memoryview(host[i].numpy()).cast("B"))

        def read(i):
            with open(f"{d}/l{i}", "rb") as f:
                f.readinto(memoryview(host[i].numpy()).cast("B"))
        for n in (1, 4, 8):
            rate(f"write, {n} threads", timed(
                lambda: pool(n, write, range(len(host)))))
        rate("np.fromfile, 1 thread", timed(
            lambda: [np.fromfile(f"{d}/l{i}", np.uint8)
                     for i in range(len(host))]))
        for n in (1, 4, 8):
            rate(f"readinto page-locked, {n} threads", timed(
                lambda: pool(n, read, range(len(host)))))
        pageable = [h.clone() for h in host]
        rate("host->device pageable", timed(
            lambda: [x.copy_(h) for x, h in zip(dev, pageable)]))
        rate("host->device page-locked", timed(
            lambda: [x.copy_(h) for x, h in zip(dev, host)]))
        t0 = time.perf_counter()
        os.sync()
        print(f"os.sync after the writes: {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(d)


if __name__ == "__main__":
    main()
