"""The per-tick exchange of one pipeline rank over ``torch.distributed``:
the counterpart of the reference's rotation pair in ``_build_route``
and its ``_ppermute`` (``repro/core/pipeline_runtime.py``).

Every rank knows every send from the static task table: at tick ``t``
rank ``r`` sends its op's payload to ``r + delta`` where its send code
crosses devices, and it receives from each neighbour ``q`` whose code at
``t`` points at ``r`` (the interleaved placement's chunk wraps are ring
rotations, ``P - 1 -> 0`` and back; the V-shape's chunk hops stay on the
device and never come here).  A device runs one op a tick, so a rank
sends at most one message a tick and receives at most one from each
side: one ``dist.batch_isend_irecv`` a tick, tagged with the tick, each
message one packed payload (:func:`~repro_torch.core.pipeline_runtime.
pack_payload`) sent as its ``uint8`` bytes (neither NCCL's nor gloo's
type table need know ``uint16``).

A tick's traffic goes in three steps:

- :meth:`Exchange.stage` packs the payload after the tick's ops; under
  the ``host`` transport (gloo handed CUDA tensors) it also queues the
  copy of the packed bytes to a page-locked buffer on a side stream,
  ordered after the compute stream by an event;
- :meth:`Exchange.post` hands the tick's sends and receives to the
  rank's one worker thread, which waits for that copy (``host``) and
  posts them, so the caller goes on launching the next tick's ops while
  the copy and the transfer run;
- :meth:`Exchange.complete` waits for them (the time is the rank's
  ``wait_s``) and returns the arrivals, under ``host`` copied up to the
  card on the compute stream.

The executor posts tick ``t`` as soon as its ops are launched; it
completes it in the same tick on the synchronous table, and on the
overlapped one only before tick ``t + 2``'s ops, the first that may read
what arrived (a device-crossing edge is two ticks long there), so tick
``t + 1``'s ops run beside the transfer.  Buffers are double: a tick's
send buffers stay untouched until its sends complete, and a page-locked
receive buffer is not handed to gloo again before the copy out of it
has run.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.tasktable import IDLE, SEND_NONE


class Exchange:
    """One rank's sends and receives for every tick of ``spec``'s table
    over ``mesh`` (:class:`repro_torch.launch.mesh.PipeMesh`: the rank's
    pp group; its stages are translated to the process ranks of a
    ``pp x dp x tp`` mesh by ``mesh.global_rank``).  Counts
    ``bytes_sent``, ``bytes_recv``, ``messages`` and ``wait_s`` (host
    seconds blocked in :meth:`complete`)."""

    def __init__(self, spec, mesh):
        from repro_torch.core.pipeline_runtime import _ROUTE, payload_words
        tab, r, P = spec.table, mesh.rank, mesh.P
        A = tab.arrays()

        def crossing(t, d):
            code = int(A[t, d, 5])
            if A[t, d, 0] == IDLE or code == SEND_NONE or not _ROUTE[code][0]:
                return None
            return code, (d + _ROUTE[code][0]) % P

        self.mesh = mesh
        #: tick -> destination rank of this rank's send
        self.sends: Dict[int, int] = {}
        #: tick -> [(source rank, its send code)], in source order
        self.recvs: Dict[int, List[Tuple[int, int]]] = {}
        for t in range(tab.T):
            mine = crossing(t, r)
            if mine is not None:
                self.sends[t] = mine[1]
            got = [(q, c[0]) for q in range(P) if q != r
                   for c in [crossing(t, q)] if c is not None and c[1] == r]
            if got:
                self.recvs[t] = got
        self.shape = (spec.mbB, 2 * payload_words(spec))
        self.spec = spec
        dev = mesh.device
        self.host = mesh.staged
        srcs = sorted({q for v in self.recvs.values() for q, _ in v})

        def new(**where):
            return torch.empty(self.shape, dtype=torch.uint8, **where)
        # two of each: ticks t and t + 1 are in flight at once
        self.send_buf = [new(device=dev) for _ in range(2)]
        self.recv_buf = [{q: new(device=dev) for q in srcs}
                         for _ in range(2)]
        if self.host:
            self.send_pin = [new(pin_memory=True) for _ in range(2)]
            self.recv_pin = [{q: new(pin_memory=True) for q in srcs}
                             for _ in range(2)]
            self.side = torch.cuda.Stream(device=dev)
            self.copied: Dict[int, torch.cuda.Event] = {}
            self.pin_free: Dict[Tuple[int, int], torch.cuda.Event] = {}
        self.works: Dict[int, Future] = {}
        # one thread posts every tick in order, so the ranks' messages
        # pair up by tick; it blocks on the host copy, not the caller (it
        # exits when the exchange is collected)
        self.poster = ThreadPoolExecutor(
            1, thread_name_prefix=f"exchange-rank{r}",
            initializer=torch.cuda.set_device if dev.type == "cuda" else None,
            initargs=(dev,) if dev.type == "cuda" else ())
        self.bytes_sent = self.bytes_recv = self.messages = 0
        self.wait_s = 0.0

    def stage(self, t: int, payload) -> None:
        """Pack this rank's tick-``t`` payload (None where the rank sends
        nothing across devices at ``t``)."""
        if t not in self.sends:
            assert payload is None, f"tick {t}: a payload with no send"
            return
        if payload is None:
            raise RuntimeError(f"tick {t}: the table sends from rank "
                               f"{self.mesh.rank} but its op gave no "
                               "payload")
        from repro_torch.core.pipeline_runtime import pack_payload
        k = t % 2
        pack_payload(self.spec, payload, out=self.send_buf[k])
        if self.host:
            ready = torch.cuda.Event()
            ready.record()
            with torch.cuda.stream(self.side):
                self.side.wait_event(ready)
                self.send_pin[k].copy_(self.send_buf[k], non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.side)
            self.copied[t] = done

    def post(self, t: int) -> None:
        """Hand tick ``t``'s sends and receives to the worker thread."""
        ops, k = [], t % 2
        if t in self.sends:
            buf = self.send_pin[k] if self.host else self.send_buf[k]
            ops.append(dist.P2POp(dist.isend, buf,
                                  self.mesh.global_rank(self.sends[t]),
                                  self.mesh.group, tag=t))
            self.bytes_sent += buf.numel()
        for q, _ in self.recvs.get(t, ()):
            buf = self.recv_pin[k][q] if self.host else self.recv_buf[k][q]
            ops.append(dist.P2POp(dist.irecv, buf, self.mesh.global_rank(q),
                                  self.mesh.group, tag=t))
            self.bytes_recv += buf.numel()
        if not ops:
            return
        self.messages += len(ops)
        copied = self.copied.pop(t, None) if self.host else None
        free = [self.pin_free.pop((k, q), None)
                for q, _ in self.recvs.get(t, ())] if self.host else []
        self.works[t] = self.poster.submit(self._post, ops, copied, free)

    @staticmethod
    def _post(ops, copied, free):
        """On the worker thread: wait for the send's host copy and for the
        receive buffers' last copies out, then post."""
        for e in [copied, *free]:
            if e is not None:
                e.synchronize()
        return dist.batch_isend_irecv(ops)

    def complete(self, t: int) -> List[Tuple[int, torch.Tensor]]:
        """Wait for tick ``t``'s traffic; returns ``[(send code, packed
        uint8 [mbB, 2W] on the rank's device)]`` of the arrivals."""
        posted = self.works.pop(t, None)
        if posted is None:
            return []
        t0 = time.perf_counter()
        for w in posted.result():
            w.wait()
        self.wait_s += time.perf_counter() - t0
        k, out = t % 2, []
        for q, code in self.recvs.get(t, ()):
            buf = self.recv_buf[k][q]
            if self.host:
                buf.copy_(self.recv_pin[k][q], non_blocking=True)
                free = torch.cuda.Event()
                free.record()
                self.pin_free[k, q] = free
            out.append((code, buf))
        return out

    def stats(self) -> Dict[str, float]:
        return {"bytes_sent": self.bytes_sent, "bytes_recv": self.bytes_recv,
                "messages": self.messages, "wait_s": self.wait_s}

    def reset_stats(self) -> None:
        self.bytes_sent = self.bytes_recv = self.messages = 0
        self.wait_s = 0.0
