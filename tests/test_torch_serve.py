"""The port's LM and pipelined engine against the JAX single-host reference
on the CPU (reduced tinyllama: 4 layers, d=128, 8 heads, kv=2, fp32; and
the other served families at their reduced sizes: mamba2, qwen2-moe and
jamba).

Weights come from ``repro``'s ``LM.init(jax.random.key(0))`` and cross
through ``repro_torch.bridge``.  The reference token streams are the
single-host ``LM.prefill_chunk`` / ``LM.decode_step`` greedy streams, as
``tests/helpers/serve_check.py`` computes them (the JAX pipelined engine
itself is not used as an oracle)."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import LM as JaxLM
from repro.serve import scheduler as jax_sched
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.ft import FaultInjector, HealthMonitor, Watchdog
from repro_torch.models import LM
from repro_torch.serve import PipelinedEngine, Request, new_telemetry
from repro_torch.serve import scheduler as port_sched
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHUNK = 16
MAX_SEQ = 4 * CHUNK + 32
N_SLOTS = 2


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_get_reduced("tinyllama-1.1b")
    lm_j = JaxLM(cfg_j)
    params_j, _ = lm_j.init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params_j)
    cfg = get_reduced("tinyllama-1.1b")
    return {"cfg": cfg, "lm_j": lm_j, "params_j": params_j,
            "params": lm_params_from_numpy(params_np, "cpu"),
            "prefill_j": jax.jit(lm_j.prefill_chunk),
            "decode_j": jax.jit(lm_j.decode_step)}


def _requests(vocab):
    """2 * n_slots + 1 requests, made as serve_check.py makes them."""
    rng = np.random.default_rng(7)
    reqs = []
    for rid in range(2 * N_SLOTS + 1):
        plen = CHUNK * int(rng.integers(1, 4))
        prompt = rng.integers(0, vocab, size=plen).astype(int)
        reqs.append(Request(rid=rid, prompt=prompt.tolist(),
                            max_new=int(rng.integers(3, 9))))
    return reqs


@pytest.fixture(scope="module")
def reference(models):
    """rid -> JAX single-host greedy token stream."""
    m = models
    out = {}
    for req in _requests(m["cfg"].vocab_size):
        cache = m["lm_j"].init_cache(1, MAX_SEQ)
        toks = np.asarray(req.prompt)[None]
        pos = 0
        for q in range(len(req.prompt) // CHUNK):
            logits, cache = m["prefill_j"](
                m["params_j"], toks[:, q * CHUNK:(q + 1) * CHUNK], cache, pos)
            pos += CHUNK
        stream = [int(np.argmax(np.asarray(logits)[0]))]
        while len(stream) < req.max_new:
            logits, cache = m["decode_j"](
                m["params_j"], np.asarray([[stream[-1]]]), cache, pos)
            pos += 1
            stream.append(int(np.argmax(np.asarray(logits)[0])))
        out[req.rid] = stream
    return out


@pytest.mark.parametrize("kernels", ["fused", "plain"])
def test_lm_teacher_forced_logits_match_jax(models, kernels):
    """Prefill three chunks, then decode four steps feeding the JAX greedy
    tokens to both; logits agree at every step."""
    m = models
    lm = LM(m["cfg"], kernels=kernels, device="cpu")
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, m["cfg"].vocab_size, size=(1, 3 * CHUNK))
    cache_j = m["lm_j"].init_cache(1, MAX_SEQ)
    cache_t = lm.init_cache(1, MAX_SEQ)
    worst = 0.0
    pos, tok = 0, None
    for step in range(7):
        if step < 3:
            chunk = prompt[:, step * CHUNK:(step + 1) * CHUNK]
            lj, cache_j = m["prefill_j"](m["params_j"], chunk, cache_j, pos)
            lt, cache_t = lm.prefill_chunk(m["params"], torch.from_numpy(chunk),
                                           cache_t, pos)
            pos += CHUNK
        else:
            lj, cache_j = m["decode_j"](m["params_j"], tok, cache_j, pos)
            lt, cache_t = lm.decode_step(m["params"], torch.from_numpy(tok),
                                         cache_t, pos)
            pos += 1
        lj = np.asarray(lj)
        assert lt.shape == lj.shape
        worst = max(worst, float(np.abs(lt.numpy() - lj).max()))
        tok = np.argmax(lj, axis=-1)[:, None]
    assert worst <= 1e-4, worst
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t["periods"][0][name].numpy(),
                                   np.asarray(cache_j["periods"][0][name]),
                                   atol=1e-5)


def _seams(name):
    """serve() keyword arguments: none (the defaults), the caller-owned
    scheduler, telemetry and clock anchor, or those plus a fault injector
    with no faults, a watchdog and a health monitor: every seam off."""
    if name == "default":
        return {}
    kw = {"sched": port_sched.SlotScheduler(N_SLOTS, CHUNK, MAX_SEQ),
          "telemetry": new_telemetry(), "t0": time.perf_counter()}
    if name == "armed":
        inj = FaultInjector([])
        kw.update(injector=inj, watchdog=Watchdog(60.0, clock=inj.clock),
                  monitor=HealthMonitor())
    return kw


@pytest.mark.parametrize("seams", ["default", "owned", "armed"])
@pytest.mark.parametrize("P,kernels", [(1, "fused"), (2, "fused"),
                                       (2, "plain"), (3, "fused")])
def test_engine_streams_match_single_host_jax(models, reference, P, kernels,
                                              seams):
    """P=3 pads the 4 layers to 6: two gate-0 padding layers pass through.
    With the resilience seams present but no fault, the engine makes the
    reference scheduler's decisions (driven through a fake pipeline of the
    same depth) and gives the same streams."""
    m = models
    reqs = _requests(m["cfg"].vocab_size)
    eng = PipelinedEngine(m["cfg"], m["params"], P=P, chunk=CHUNK,
                          max_seq=MAX_SEQ, n_slots=N_SLOTS, kernels=kernels,
                          device="cpu")
    tick, log = eng.tick, []

    def logging_tick(inj):
        log.append((inj.op, inj.slot, inj.pos, inj.first, inj.rid))
        return tick(inj)
    eng.tick = logging_tick
    res = eng.serve(reqs, clock=None, **_seams(seams))
    _, want = _drive(jax_sched, reqs, n_slots=N_SLOTS, P=P, chunk=CHUNK,
                     max_seq=MAX_SEQ)
    assert log == want
    assert res["dropped"] == {} and res["stale_nonfinite_logits"] == 0
    if seams != "armed":        # a monitor may flag real tick times
        assert res["health_actions"] == []
    assert set(res["finished"]) == {r.rid for r in reqs}
    assert res["outcomes"] == {r.rid: "completed" for r in reqs}
    for r in reqs:
        assert res["finished"][r.rid].tokens == reference[r.rid], r.rid
    assert res["nonfinite_logits"] == 0
    n_prefill = sum(len(r.prompt) // CHUNK for r in reqs)
    n_decode = sum(r.max_new - 1 for r in reqs)
    assert res["stage_runs"] == {"prefill": P * n_prefill,
                                 "decode": P * n_decode}
    assert float(eng.flags["gate"].sum()) == m["cfg"].num_layers


def test_engine_with_preemption_matches_reference(models, reference):
    """Preempted requests restart from scratch and regenerate the same
    greedy stream."""
    m = models
    reqs = _requests(m["cfg"].vocab_size)
    eng = PipelinedEngine(m["cfg"], m["params"], P=2, chunk=CHUNK,
                          max_seq=MAX_SEQ, n_slots=N_SLOTS, device="cpu")
    res = eng.serve(reqs, clock=None, preempt_after=3)
    assert sum(r.preemptions for r in res["finished"].values()) > 0
    for r in reqs:
        assert res["finished"][r.rid].tokens == reference[r.rid]
        assert res["finished"][r.rid].preemptions <= 1


# ---------------------------------------------------------------------------
# the other families: Mamba-2 (SSM slot state), MoE, hybrid
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("mamba2-2.7b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
                "gemma3-27b")
LOGIT_TOL = 1e-4          # fp32 logits, engine vs JAX single host
_FAMILY = {}


def _family(arch):
    """Bridged weights, three requests (16 or 32 prompt tokens, a
    multiple of every reduced SSD chunk; 48 or 64 where the config has a
    sliding window, so that prompts pass reduced gemma3's window of 32)
    and the JAX single-host greedy streams with their logits, computed
    once per arch."""
    if arch not in _FAMILY:
        lm_j = JaxLM(jax_get_reduced(arch))
        params_j, _ = lm_j.init(jax.random.key(0))
        prefill_j, decode_j = jax.jit(lm_j.prefill_chunk), \
            jax.jit(lm_j.decode_step)
        cfg = get_reduced(arch)
        rng = np.random.default_rng(5)
        extra = 2 if cfg.sliding_window else 0
        reqs = [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, CHUNK * (1 + extra + i % 2)).tolist(),
            max_new=3 + i) for i in range(3)]
        ref = {}
        for req in reqs:
            cache = lm_j.init_cache(1, MAX_SEQ)
            toks = np.asarray(req.prompt)[None]
            for q in range(len(req.prompt) // CHUNK):
                logits, cache = prefill_j(
                    params_j, toks[:, q * CHUNK:(q + 1) * CHUNK], cache,
                    q * CHUNK)
            pos, stream, lgs = len(req.prompt), [], []
            while True:
                lgs.append(np.asarray(logits)[0])
                stream.append(int(np.argmax(lgs[-1])))
                if len(stream) == req.max_new:
                    break
                logits, cache = decode_j(params_j, np.asarray(
                    [[stream[-1]]]), cache, pos)
                pos += 1
            ref[req.rid] = (stream, lgs)
        _FAMILY[arch] = (cfg, lm_params_from_numpy(
            jax.tree.map(np.asarray, params_j), "cpu"), reqs, ref)
    return _FAMILY[arch]


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_engine_streams_match_single_host_jax(arch, P):
    """Greedy tokens equal and the sampled fp32 logits within 1e-4 of the
    JAX single-host ``prefill_chunk`` / ``decode_step`` streams, at P=1
    and P=2 (jamba's 8-layer period pads to 16 layers at P=2).  Three
    requests share two slots, so a slot is reused: its Mamba-2 conv tails
    and state are cleared on the new request's first chunk, or its stream
    would not be the fresh-cache one."""
    cfg, params, reqs, ref = _family(arch)
    eng = PipelinedEngine(cfg, params, P=P, chunk=CHUNK, max_seq=MAX_SEQ,
                          n_slots=N_SLOTS, kernels="fused", device="cpu")
    got = {}
    tick = eng.tick

    def recording_tick(inj):
        retired, tok, logits, finite = tick(inj)
        if logits is not None:
            got.setdefault(retired.rid, []).append(logits.numpy())
        return retired, tok, logits, finite
    eng.tick = recording_tick
    res = eng.serve(reqs, clock=None)
    worst = 0.0
    for r in reqs:
        stream, lgs = ref[r.rid]
        assert res["finished"][r.rid].tokens == stream, r.rid
        worst = max(worst, max(float(np.abs(a - b).max())
                               for a, b in zip(got[r.rid], lgs)))
    print(f"{arch} P={P}: logits max |d| {worst:.2e}")
    assert worst <= LOGIT_TOL


def test_unported_family_is_refused():
    """A family the port has no fields for (a VLM) is refused before
    anything is built."""
    import dataclasses

    from repro_torch.serve.engine import check_servable
    with pytest.raises(NotImplementedError, match="not ported"):
        check_servable(dataclasses.replace(get_reduced("tinyllama-1.1b"),
                                           family="vlm"), CHUNK)


def test_engine_blocks_alias_the_lm_weights():
    """Where the layout needs no padding the engine's blocks are views of
    the LM's layer leaves (no second copy of the weights); a padded
    layout (P=3 over 4 layers) copies."""
    m = _family("qwen2-moe-a2.7b")
    cfg, params = m[0], m[1]
    leaf = params["layers"][0]["moe"]["wi"]
    for P, shared in ((1, True), (2, True), (3, False)):
        eng = PipelinedEngine(cfg, params, P=P, chunk=CHUNK,
                              max_seq=MAX_SEQ, device="cpu")
        blk = eng.blocks[0]["moe"]["wi"]
        assert (blk.data_ptr() == leaf.data_ptr()) == shared, P
        assert blk.shape[:2] == (P, eng.layout.M)


# ---------------------------------------------------------------------------
# the scheduler copy decides exactly as the reference scheduler
# ---------------------------------------------------------------------------

def _drive(mod, reqs, *, n_slots, P=3, preempt_after=None, chunk=4,
           max_seq=64):
    """Run scheduler module ``mod`` against a depth-P fake pipeline whose
    model maps (rid, step) -> 1000 * rid + step; returns the scheduler and
    the injection sequence."""
    sched = mod.SlotScheduler(n_slots, chunk, max_seq,
                              preempt_after=preempt_after)
    for r in reqs:
        sched.submit(mod.Request(rid=r.rid, prompt=r.prompt,
                                 max_new=r.max_new))
    hist, log = [], []
    for _ in range(10_000):
        inj = sched.next_injection()
        log.append((inj.op, inj.slot, inj.pos, inj.first, inj.rid))
        hist.insert(0, inj)
        if len(hist) == P:
            done = hist.pop()
            if done.op != mod.IDLE and done.sample:
                a = sched.active.get(done.slot)
                step = 0 if a is None or a.req.rid != done.rid \
                    else len(a.generated)
                sched.on_result(done, 1000 * done.rid + step)
        if sched.idle and all(h.op == mod.IDLE for h in hist):
            return sched, log
    raise AssertionError("fake serve did not converge")


@pytest.mark.parametrize("n_slots,n_req,preempt_after",
                         [(1, 3, None), (2, 7, None), (2, 11, 6)])
def test_scheduler_copy_decides_as_reference(n_slots, n_req, preempt_after):
    rng = np.random.default_rng(n_slots + n_req)
    reqs = [Request(rid=i, prompt=[1] * (4 * int(rng.integers(1, 4))),
                    max_new=int(rng.integers(1, 7))) for i in range(n_req)]
    port, log_p = _drive(port_sched, reqs, n_slots=n_slots,
                         preempt_after=preempt_after)
    ref, log_r = _drive(jax_sched, reqs, n_slots=n_slots,
                        preempt_after=preempt_after)
    assert log_p == log_r
    assert port.outcomes == {r.rid: "completed" for r in reqs}
    for r in reqs:
        rec = port.finished[r.rid]
        assert rec.tokens == [1000 * r.rid + k for k in range(r.max_new)]
        assert rec.tokens == ref.finished[r.rid].tokens
        assert rec.preemptions <= 1
    if preempt_after is not None:
        assert sum(r.preemptions for r in port.finished.values()) > 0
