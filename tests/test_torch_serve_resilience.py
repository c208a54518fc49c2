"""Resilient serving of the port against the JAX package on the CPU
(reduced sizes, fp32): fault specs, the scheduler's fault re-admission
and request lifecycle decision for decision, the prefill injection
order, bursty traffic and ``summarize``, ``serve_resilient`` through one
and two recoveries, the straggler's health actions, ``rebuild_elastic``
against ``pack_blocks``, a missed re-admission, the CLI's validation and
single-host batched serving.

Weights come from ``repro``'s ``LM.init(jax.random.key(0))`` through
``repro_torch.bridge``.  The stream oracle is the JAX single-host
``prefill_chunk`` / ``decode_step`` (``prefill`` for the batched path)
greedy stream: the JAX pipelined engine is no oracle (it fails on this
container's jax)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import LM as JaxLM
from repro.serve import resilience as jax_res
from repro.serve import scheduler as jax_sched
from repro.serve import traffic as jax_traffic
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.core.layout import StageLayout
from repro_torch.core.placement import Placement
from repro_torch.ft import (FaultInjector, HealthMonitor, HungTick,
                            SlotCorruption, StragglerTicks, TickDeviceLoss)
from repro_torch.launch.serve import build_parser, serve_batched, validate_args
from repro_torch.models import LM
from repro_torch.serve import (PipelinedEngine, Request, pack_blocks,
                               parse_fault_spec, serve_resilient)
from repro_torch.serve import engine as port_engine
from repro_torch.serve import scheduler as port_sched
from repro_torch.serve import traffic as port_traffic
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHUNK = 16
MAX_SEQ = 4 * CHUNK + 32
_MODELS = {}


def _model(arch):
    """(port cfg, bridged params, JAX LM, JAX params, jitted prefill_chunk,
    decode_step, prefill) for a reduced ``arch``, built once."""
    if arch not in _MODELS:
        lm_j = JaxLM(jax_get_reduced(arch))
        params_j, _ = lm_j.init(jax.random.key(0))
        _MODELS[arch] = (
            get_reduced(arch),
            lm_params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"),
            lm_j, params_j, jax.jit(lm_j.prefill_chunk),
            jax.jit(lm_j.decode_step), jax.jit(lm_j.prefill))
    return _MODELS[arch]


def _requests(vocab, P):
    """2 * P + 1 requests of 1-3 chunks and 3-8 new tokens, made as
    ``tests/helpers/serve_resilience_check.py`` makes them."""
    rng = np.random.default_rng(7)
    reqs = []
    for rid in range(2 * P + 1):
        plen = CHUNK * int(rng.integers(1, 4))
        prompt = rng.integers(0, vocab, size=plen).astype(int)
        reqs.append(Request(rid=rid, prompt=prompt.tolist(),
                            max_new=int(rng.integers(3, 9))))
    return reqs


def _reference(arch, req):
    """The JAX single-host greedy stream of ``req``."""
    _, _, lm_j, params_j, prefill_j, decode_j, _ = _model(arch)
    cache = lm_j.init_cache(1, MAX_SEQ)
    toks = np.asarray(req.prompt)[None]
    pos = 0
    for q in range(len(req.prompt) // CHUNK):
        logits, cache = prefill_j(params_j, toks[:, q * CHUNK:(q + 1) * CHUNK],
                                  cache, pos)
        pos += CHUNK
    out = [int(np.argmax(np.asarray(logits)[0]))]
    while len(out) < req.max_new:
        logits, cache = decode_j(params_j, np.asarray([[out[-1]]]), cache,
                                 pos)
        pos += 1
        out.append(int(np.argmax(np.asarray(logits)[0])))
    return out


def _quiet(*_):
    pass


# ---------------------------------------------------------------------------
# (a) fault specs
# ---------------------------------------------------------------------------

VALID_SPECS = ["device_loss@tick=40", "device_loss@tick=3,device=1",
               "device_loss@tick=1,", "slot_corruption@tick=9,slot=1",
               "hung_tick@tick=7", "hung_tick@tick=7,device=2,hang_s=90.5",
               "straggler@tick=5,n_ticks=4,factor=8", "straggler@tick=2"]
BAD_SPECS = ["nope@tick=1", "device_loss@frog=1", "device_loss",
             "device_loss@tick=x", "slot_corruption@tick=1,slot",
             "slot_corruption@slot=1", "straggler@tick=1,factor=fast",
             "slot_corruption@tick=9"]


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_parse_fault_spec_builds_the_reference_fault(spec):
    got, want = parse_fault_spec(spec), jax_res.parse_fault_spec(spec)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_fault_spec_raises_where_the_reference_does(spec):
    with pytest.raises(Exception) as want:
        jax_res.parse_fault_spec(spec)
    with pytest.raises(want.type):
        parse_fault_spec(spec)


# ---------------------------------------------------------------------------
# (b) scheduler decisions with fault re-admission, deadlines, max_queue
# ---------------------------------------------------------------------------

def _drive(mod, cases, *, n_slots, P, max_queue=None, max_retries=3,
           preempt_after=None, fail_slot_at=(), fail_all_at=()):
    """Drive scheduler module ``mod`` against a fake pipeline of depth P
    whose model maps (rid, step) -> 1000 * rid + step.  ``cases`` are
    (rid, prompt chunks, max_new, arrival tick, deadline in ticks);
    ``fail_slot_at`` {tick: slot} corrupts after the tick's injection,
    ``fail_all_at`` {tick: new P} loses a stage before it (the waves in
    flight die with the old pipeline).  Returns the scheduler and the
    log of every decision."""
    sched = mod.SlotScheduler(n_slots, 4, 64, preempt_after=preempt_after,
                              max_queue=max_queue, max_retries=max_retries)
    pending = sorted((mod.Request(rid=rid, prompt=[1] * (4 * nc),
                                  max_new=gen, arrival_s=float(at),
                                  deadline=dl)
                      for rid, nc, gen, at, dl in cases),
                     key=lambda r: (r.arrival_s, r.rid))
    fail_slot_at, fail_all_at = dict(fail_slot_at), dict(fail_all_at)
    log, hist = [], []
    for tick in range(1, 20_000):
        while pending and pending[0].arrival_s <= tick:
            r = pending.pop(0)
            log.append(("submit", r.rid, sched.submit(r)))
        if tick in fail_all_at:
            P, hist = fail_all_at[tick], []
            log.append(("fail_all", sched.fail_all()))
        inj = sched.next_injection()
        log.append(("inj", inj.op, inj.slot, inj.pos, inj.first, inj.tokens,
                    inj.sample, inj.rid, inj.gen))
        hist.insert(0, inj)
        if tick in fail_slot_at:
            log.append(("fail_slot", sched.fail_slot(fail_slot_at[tick])))
        if len(hist) >= P:
            done = hist.pop()
            if done.op != mod.IDLE and done.sample:
                a = sched.active.get(done.slot)
                step = 0 if a is None or a.req.rid != done.rid \
                    else len(a.generated)
                log.append(("result", sched.on_result(
                    done, 1000 * done.rid + step)))
        if not pending and sched.idle and all(h.op == mod.IDLE
                                              for h in hist):
            return sched, log
    raise AssertionError("fake serve did not converge")


def _cases(seed, n, deadlines):
    rng = np.random.default_rng(seed)
    return [(rid, int(rng.integers(1, 4)), int(rng.integers(1, 9)),
             int(rng.integers(0, 12)),
             float(rng.choice([9.0, 25.0, 60.0]))
             if deadlines and rng.random() < 0.5 else None)
            for rid in range(n)]


DECISION_CASES = {
    "corrupt-once": dict(seed=0, n=5, n_slots=2, P=3,
                         fail_slot_at={6: 0}),
    "corrupt-past-budget": dict(seed=1, n=3, n_slots=1, P=2, max_retries=1,
                                fail_slot_at={5: 0, 14: 0, 30: 0}),
    "device-loss": dict(seed=2, n=7, n_slots=3, P=3, fail_all_at={20: 2}),
    "two-losses": dict(seed=3, n=9, n_slots=4, P=3,
                       fail_all_at={15: 2, 40: 1}, fail_slot_at={8: 1}),
    "deadlines": dict(seed=4, n=10, n_slots=2, P=2, deadlines=True),
    "max-queue": dict(seed=5, n=12, n_slots=2, P=3, max_queue=2),
    "all-knobs": dict(seed=6, n=12, n_slots=3, P=3, max_queue=3,
                      deadlines=True, preempt_after=6, max_retries=1,
                      fail_slot_at={7: 0, 9: 2, 19: 1},
                      fail_all_at={25: 2}),
    "empty-slot-corrupt": dict(seed=7, n=2, n_slots=4, P=2,
                               fail_slot_at={3: 3}, fail_all_at={4: 1}),
}


@pytest.mark.parametrize("name", sorted(DECISION_CASES))
def test_scheduler_decides_as_reference_under_faults(name):
    kw = dict(DECISION_CASES[name])
    cases = _cases(kw.pop("seed"), kw.pop("n"), kw.pop("deadlines", False))
    port, log_p = _drive(port_sched, cases, **kw)
    ref, log_r = _drive(jax_sched, cases, **kw)
    assert log_p == log_r
    assert port.outcomes == ref.outcomes
    assert set(port.outcomes) == {c[0] for c in cases}
    assert {r: dataclasses.asdict(f) for r, f in port.finished.items()} == \
        {r: dataclasses.asdict(f) for r, f in ref.finished.items()}
    assert {r: dataclasses.asdict(d) for r, d in port.dropped.items()} == \
        {r: dataclasses.asdict(d) for r, d in ref.dropped.items()}
    assert port.lifecycle_counts() == ref.lifecycle_counts()
    for rid, rec in port.finished.items():
        assert rec.tokens == [1000 * rid + k for k in range(len(rec.tokens))]
    assert not port.active and not port.queue and not port.ready


def test_device_loss_readmission_spends_no_retry_budget():
    """``fail_all`` re-admits with max_retries=0 and nobody fails; a
    corruption past the budget fails the request."""
    sched = port_sched.SlotScheduler(2, 4, 64, max_retries=0)
    for i in range(3):
        sched.submit(Request(rid=i, prompt=[1] * 4, max_new=4))
    for _ in range(5):
        sched.next_injection()
    victims = sched.fail_all()
    assert len(victims) == 2 and not sched.active
    assert list(sched.queue)[0].rid == victims[0]
    sched.next_injection()
    assert sched.fail_slot(0) == victims[0]
    assert sched.outcomes[victims[0]] == port_sched.FAILED


# ---------------------------------------------------------------------------
# (c) the prefill injection order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,m,n_seq", [(2, 2, 1), (2, 4, 3), (3, 3, 2),
                                       (4, 5, 4)])
def test_prefill_injection_order_matches_reference(P, m, n_seq):
    got = port_sched.prefill_injection_order(P, m, n_seq)
    assert got == jax_sched.prefill_injection_order(P, m, n_seq)
    assert got == [(mb, q) for mb in range(m) for q in range(n_seq)]


# ---------------------------------------------------------------------------
# (d) bursty traffic and summarize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (0, {}), (11, dict(deadline_s=3.0)),
    (4, dict(rate_lo=1.0, rate_hi=100.0, gen_tail=0.5)),
    (9, dict(prompt_range=(2, 3), gen_range=(8, 12), vocab=32000))])
def test_bursty_requests_match_reference(seed, kw):
    args = dict(chunk=8, max_seq=128, seed=seed, **kw)
    got = port_traffic.bursty_requests(60, **args)
    want = jax_traffic.bursty_requests(60, **args)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


def _summary_inputs():
    pre = {"metrics": {0: {"ttft_s": 0.5, "per_token_s": [0.1],
                           "n_tokens": 2}},
           "elapsed_s": 1.0, "ticks": 10}
    full = dict(pre, counts={"completed": 1, "expired": 1, "shed": 2,
                             "failed": 0, "retries": 3, "preemptions": 0,
                             "with_deadline": 2, "deadline_hits": 1})
    cfg, params = _model("tinyllama-1.1b")[:2]
    reqs = [dataclasses.replace(r, deadline=25.0 if r.rid % 2 else None)
            for r in _requests(cfg.vocab_size, 2)]
    eng = PipelinedEngine(cfg, params, P=2, chunk=CHUNK, max_seq=MAX_SEQ,
                          n_slots=2, device="cpu")
    served = eng.serve(reqs, clock=None, max_queue=3)
    return {"pre-lifecycle": pre, "counts": full, "served": served}


@pytest.mark.parametrize("which", ["pre-lifecycle", "counts", "served"])
def test_summarize_matches_reference(which):
    res = _summary_inputs()[which]
    got, want = port_traffic.summarize(res), jax_traffic.summarize(res)
    assert got == want
    if which == "counts":
        assert got["deadline_hit_rate"] == pytest.approx(0.5)
        assert got["goodput_tok_s"] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# (e)-(f) serve_resilient through one and two recoveries
# ---------------------------------------------------------------------------

def _done_ticks(arch, P, reqs):
    """The retire ticks of a fault-free resilient run."""
    cfg, params = _model(arch)[:2]
    base = serve_resilient(cfg, params, reqs, P=P, chunk=CHUNK,
                           max_seq=MAX_SEQ, clock=None, device="cpu",
                           log=_quiet)
    assert base["counts"]["completed"] == len(reqs)
    assert base["recoveries"] == [] and base["nonfinite_logits"] == 0
    return sorted(r.done_tick for r in base["finished"].values())


def _assert_streams(arch, reqs, res):
    assert res["outcomes"] == {r.rid: "completed" for r in reqs}
    for r in reqs:
        assert res["finished"][r.rid].tokens == _reference(arch, r), r.rid
    assert res["nonfinite_logits"] == 0


@pytest.mark.parametrize("arch,P", [("tinyllama-1.1b", 3),
                                    ("mamba2-2.7b", 2)])
def test_serve_resilient_one_recovery_pins_streams(arch, P):
    """An early slot corruption, then stage P-1 lost mid-decode (after the
    first completion, before the last), staged as
    ``tests/helpers/serve_resilience_check.py`` stages them."""
    cfg, params = _model(arch)[:2]
    reqs = _requests(cfg.vocab_size, P)
    done = _done_ticks(arch, P, reqs)
    loss_tick = done[0] + max(1, (done[-1] - done[0]) // 3)
    corrupt_tick = P + 3
    assert corrupt_tick < loss_tick
    res = serve_resilient(
        cfg, params, reqs, P=P, chunk=CHUNK, max_seq=MAX_SEQ, clock=None,
        device="cpu", log=_quiet,
        faults=[SlotCorruption(tick=corrupt_tick, slot=0),
                TickDeviceLoss(tick=loss_tick, device=P - 1)])
    _assert_streams(arch, reqs, res)
    ticks = [r.done_tick for r in res["finished"].values()]
    assert any(t <= loss_tick for t in ticks)
    assert any(t > loss_tick for t in ticks)
    assert len(res["recoveries"]) == 1
    rec = res["recoveries"][0]
    assert (rec.p_from, rec.p_to, rec.kind) == (P, P - 1, "device_loss")
    assert rec.n_readmitted >= 1 and rec.tick == loss_tick
    assert res["counts"]["retries"] >= rec.n_readmitted + 1
    assert len(res["events"]) == 2
    assert [i["P"] for i in res["incarnations"]] == [P, P - 1]


@pytest.mark.parametrize("consume", [False, True])
def test_serve_resilient_two_recoveries_with_hung_tick(consume):
    """P=3 -> 2 -> 1: a corruption, stage 1 lost, then a hung tick that
    the watchdog on the injector's clock turns into a second loss.  With
    ``consume_params`` the first engine's copying pack (4 layers pad to 6
    at P=3) takes the layer leaves over, and the later incarnations,
    rebuilt from the engine's own blocks, serve the same streams."""
    arch, P = "tinyllama-1.1b", 3
    cfg, params = _model(arch)[:2]
    reqs = _requests(cfg.vocab_size, P)
    done = _done_ticks(arch, P, reqs)
    if consume:
        params = tree_map(torch.clone, params)
    loss_tick = done[0] + max(1, (done[-1] - done[0]) // 4)
    hung_tick = loss_tick + max(P + 2, (done[-1] - loss_tick) // 2)
    inj = FaultInjector([SlotCorruption(tick=P + 3, slot=0),
                         TickDeviceLoss(tick=loss_tick, device=1),
                         HungTick(tick=hung_tick)])
    res = serve_resilient(cfg, params, reqs, P=P, chunk=CHUNK,
                          max_seq=MAX_SEQ, clock=None, device="cpu",
                          log=_quiet, faults=inj, consume_params=consume)
    _assert_streams(arch, reqs, res)
    assert (tree_leaves(params["layers"]) == []) == consume
    kinds = [(r.kind, r.p_from, r.p_to, r.tick) for r in res["recoveries"]]
    assert kinds == [("device_loss", 3, 2, loss_tick),
                     ("hung_tick", 2, 1, hung_tick)]
    assert all(r.n_readmitted >= 1 for r in res["recoveries"])
    assert res["counts"]["retries"] >= sum(
        r.n_readmitted for r in res["recoveries"]) + 1
    assert len(res["events"]) == 3
    incs = res["incarnations"]
    assert [(i["P"], i["status"]) for i in incs] == [
        (3, "device_loss"), (2, "hung_tick"), (1, "complete")]
    # stage slot 1 left the pool first, then the last one (unknown peer)
    assert [i["devices"] for i in incs] == [[0, 2, 1], [0, 2], [0]]


# ---------------------------------------------------------------------------
# (g) the straggler's health actions
# ---------------------------------------------------------------------------

class _FakeTime:
    """A ``time`` module whose ``perf_counter`` advances 1 ms a call: every
    tick reports the same duration, so the monitor's rule alone decides."""
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1e-3
        return self.now


@pytest.mark.parametrize("tick,n_ticks", [(8, 4), (12, 6)])
def test_straggler_health_actions_follow_the_monitor_rule(monkeypatch,
                                                          tick, n_ticks):
    arch, P = "tinyllama-1.1b", 2
    cfg, params = _model(arch)[:2]
    reqs = _requests(cfg.vocab_size, P)
    monkeypatch.setattr(port_engine, "time", _FakeTime())
    res = serve_resilient(
        cfg, params, reqs, P=P, chunk=CHUNK, max_seq=MAX_SEQ, clock=None,
        device="cpu", log=_quiet,
        faults=[StragglerTicks(tick=tick, n_ticks=n_ticks, factor=10.0)])
    _assert_streams(arch, reqs, res)
    mon, want = HealthMonitor(), []
    for t in range(1, res["ticks"] + 1):
        act = mon.record_step(1e-2 if tick <= t < tick + n_ticks else 1e-3)
        if act.value != "continue":
            want.append((t, act.value))
    assert res["health_actions"] == want
    # a straggler of n ticks: snapshot, then restart on the third
    assert want[:2] == [(tick, "checkpoint_now"), (tick + 2, "restart")]
    assert res["recoveries"] == [] and res["events"] == []


# ---------------------------------------------------------------------------
# (h) rebuild_elastic against pack_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,P_from,P_to", [
    ("tinyllama-1.1b", 3, 2), ("tinyllama-1.1b", 2, 3),
    ("tinyllama-1.1b", 3, 1), ("jamba-v0.1-52b", 2, 1),
    ("jamba-v0.1-52b", 1, 2)])
def test_rebuild_elastic_blocks_equal_pack_blocks(arch, P_from, P_to):
    """Reduced tinyllama's 4 layers pad to 6 at P=3; jamba's period of 8
    pads to 16 at P=2: the remap fills new padding with zeros, as the
    pack does."""
    cfg, params = _model(arch)[:2]
    eng = PipelinedEngine(cfg, params, P=P_from, chunk=CHUNK,
                          max_seq=MAX_SEQ, n_slots=3, device="cpu")
    new = eng.rebuild_elastic(P_to)
    want = pack_blocks(LM(cfg, device="cpu"), params,
                       StageLayout.build(cfg, P_to, 1, Placement(P_to, 1)))
    got_l, want_l = tree_leaves(new.blocks), tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (new.P, new.chunk, new.max_seq, new.n_slots, new.kernels,
            new.device) == (P_to, CHUNK, MAX_SEQ, 3, eng.kernels, eng.device)
    assert all(float(a.abs().sum()) == 0 for a in tree_leaves(new.caches))
    assert all(a is b for a, b in zip(tree_leaves(new.shared),
                                      tree_leaves(eng.shared)))


# ---------------------------------------------------------------------------
# (i) a missed re-admission is loud
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("readmit", [False, True])
def test_corrupted_slot_without_readmission_is_nonfinite(readmit):
    """Corrupting slot 0 mid-decode and not re-admitting its request gives
    non-finite logits on accepted waves; re-admitting (the injector's
    path) gives none, and the reference's streams."""
    arch, P = "tinyllama-1.1b", 2
    cfg, params = _model(arch)[:2]
    reqs = _requests(cfg.vocab_size, P)
    eng = PipelinedEngine(cfg, params, P=P, chunk=CHUNK, max_seq=MAX_SEQ,
                          n_slots=2, device="cpu")
    if readmit:
        res = eng.serve(reqs, clock=None,
                        injector=FaultInjector([SlotCorruption(8, 0)]))
        _assert_streams(arch, reqs, res)
        assert res["counts"]["retries"] == 1
        return
    tick, hit = eng.tick, []
    by_rid = {r.rid: r for r in reqs}

    def corrupting_tick(inj):
        out = tick(inj)
        # once: after a decode wave of slot 0 whose request has at least
        # three more tokens to sample
        if not hit and inj.op == port_sched.DECODE and inj.slot == 0:
            r = by_rid[inj.rid]
            if r.max_new - (inj.pos - len(r.prompt) + 1) >= 3:
                eng.corrupt_slot(0)
                hit.append(inj.rid)
        return out
    eng.tick = corrupting_tick
    res = eng.serve(reqs, clock=None)
    assert hit and res["nonfinite_logits"] >= 2


def test_wall_clock_engine_waits_for_late_arrivals():
    """Under ``clock="wall"`` an empty pipeline waits for the next arrival
    instead of spinning idle ticks, which ran out ``max_ticks`` before a
    late arrival and dropped it from the result."""
    arch, P = "tinyllama-1.1b", 2
    cfg, params = _model(arch)[:2]
    reqs = [dataclasses.replace(r, arrival_s=0.15 * r.rid)
            for r in _requests(cfg.vocab_size, 1)]
    eng = PipelinedEngine(cfg, params, P=P, chunk=CHUNK, max_seq=MAX_SEQ,
                          n_slots=2, device="cpu")
    res = eng.serve(reqs, max_ticks=2000)
    _assert_streams(arch, reqs, res)
    assert res["ticks"] < 2000 and res["occupied_slots"] == []


# ---------------------------------------------------------------------------
# (j) the CLI's validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,ok", [
    (["--pipelined", "2", "--fault", "device_loss@tick=4"], True),
    (["--pipelined", "0", "--batch", "2"], True),
    (["--pipelined", "64"], True),        # virtual stages: no device count
    (["--pipelined", "2", "--bursty", "--deadline-s", "1.5",
      "--max-queue", "0"], True),
    (["--rate", "0"], False), (["--requests", "0"], False),
    (["--pipelined", "-1"], False), (["--deadline-s", "0"], False),
    (["--gen", "2"], False), (["--max-queue", "-3"], False),
    (["--fault", "device_loss@tick=4"], False),
    (["--pipelined", "2", "--fault", "bogus@tick=1"], False),
    (["--pipelined", "0", "--batch", "0"], False)])
def test_launch_serve_validates_args(argv, ok):
    args = build_parser().parse_args(argv)
    if ok:
        validate_args(args)
    else:
        with pytest.raises(SystemExit):
            validate_args(args)


@pytest.mark.parametrize("entry", ["resilient", "cli-fault", "cli-batched"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card, the new entry points raise unless asked for the
    CPU; nothing falls back."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _model("tinyllama-1.1b")[:2]
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "resilient":
            serve_resilient(cfg, params, _requests(cfg.vocab_size, 2), P=2,
                            chunk=CHUNK, max_seq=MAX_SEQ, log=_quiet)
        elif entry == "cli-fault":
            main(["--pipelined", "2", "--fault", "device_loss@tick=4"])
        else:
            main(["--pipelined", "0"])


def test_cli_fault_run_serves_the_fault_free_streams():
    """``--fault`` through the CLI (its first engine consumes the weights):
    stage 1 lost mid-run at P=3, one recovery, and every stream equal to
    the fault-free CLI run's on the same seed."""
    from repro_torch.launch.serve import main
    argv = ["--device", "cpu", "--pipelined", "3", "--requests", "5",
            "--rate", "1e9", "--gen", "6", "--gen-min", "3",
            "--prompt-chunks", "2"]
    clean = main(argv)["result"]
    done = sorted(r.done_tick for r in clean["finished"].values())
    tick = done[0] + max(1, (done[-1] - done[0]) // 3)
    assert tick < done[-1]
    res = main(argv + ["--fault", f"device_loss@tick={tick},device=1"])[
        "result"]
    assert [(r.kind, r.p_from, r.p_to) for r in res["recoveries"]] == [
        ("device_loss", 3, 2)]
    assert res["outcomes"] == clean["outcomes"] == {
        rid: "completed" for rid in clean["finished"]}
    assert {rid: r.tokens for rid, r in res["finished"].items()} == {
        rid: r.tokens for rid, r in clean["finished"].items()}


# ---------------------------------------------------------------------------
# (k) single-host batched serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", ["fused", "plain"])
def test_serve_batched_matches_jax_single_host(kernels):
    arch, B, S, gen = "tinyllama-1.1b", 4, 24, 10
    cfg, params, lm_j, params_j, _, decode_j, prefill_j = _model(arch)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    out = serve_batched(LM(cfg, kernels=kernels, device="cpu"), params,
                        prompts, gen, keep_logits=True)
    cache = lm_j.init_cache(B, S + gen)
    logits, cache = prefill_j(params_j, prompts, cache)
    toks, worst = [], 0.0
    for step in range(gen):
        worst = max(worst, float(np.abs(out["logits"][step].numpy()
                                        - np.asarray(logits)).max()))
        toks.append(np.argmax(np.asarray(logits), axis=-1))
        if step + 1 < gen:
            logits, cache = decode_j(params_j, toks[-1][:, None], cache,
                                     S + step)
    assert out["tokens"].tolist() == np.stack(toks, axis=1).tolist()
    assert out["decode_steps"] == gen - 1
    assert worst <= 1e-4, worst


def test_serve_batched_sampling_follows_its_generator():
    """Above temperature 0 the draws come from the generator: the same
    seed gives the same tokens, another seed other ones."""
    cfg, params = _model("tinyllama-1.1b")[:2]
    lm = LM(cfg, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    runs = [serve_batched(lm, params, prompts, 12, 1.0,
                          torch.Generator().manual_seed(s))["tokens"]
            for s in (2, 2, 5)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
