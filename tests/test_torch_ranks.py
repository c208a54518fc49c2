"""The pipeline stages as ``torch.distributed`` ranks, on the CPU: gloo
ranks holding CPU tensors (the exchange's ``device`` transport, the path
that hands tensors straight to the collective, as NCCL would across
cards), each spawned by ``repro_torch.launch.mesh.spawn`` and running
its column of the task table (``tests/helpers/torch_ranks.py`` is the
rank's body).  Reduced tinyllama, two sequences of 17 tokens a
microbatch, m=4.

Tolerances:

- against the port's one-device executor on the same spec: **bitwise**
  (block gradients, shared gradients, loss, error feedback), for every
  schedule, P, ``overlap``, wire and shared-gradient sum here.  The ranks
  run each device's ops in the one-device order, the boundary crosses in
  the bytes the one-device rings store, and tinyllama is untied, so
  every shared leaf has one writer (``psum_writers``) and the sum over
  the ranks adds zeros to it; the compressed sum's max and integer sum
  are exact;
- against the JAX phase executor (two host devices, ``overlap=True``):
  ``tests/test_torch_wire.py``'s ``JAX_GRAD_TOL`` / ``JAX_LOSS_TOL`` /
  ``JAX_CODE_TOL`` / ``JAX_CODES_MOVED`` for the same cases, from that
  file's own child process (its ``pcast`` repair for JAX 0.9);
- ``train_pipeline`` with a mesh against the one-device run: step 1's
  loss bitwise, later losses within ``TRAIN_REL`` (1e-5 relative: the
  clip norm sums the block squares over the ranks, another order than
  one device's), the shared replicas equal on every rank after every
  step.

Each spawn has its own timeout (``SPAWN_TIMEOUT``): a hang or a failed
rank fails the tests of that spawn and kills its processes."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import schedule as jax_schedule
from repro.core.pipeline_runtime import _pack_payload, _payload_words
from repro.core.pipeline_runtime import _unpack_payload
from repro.core.schedules import get_schedule as jax_get_schedule
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                               make_train_grads_fn,
                                               pack_payload, payload_words,
                                               psum_writers, rank_params,
                                               unpack_payload)
from repro_torch.core.schedules import REGISTRY, get_schedule
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PipeMesh, check_mesh, spawn
from repro_torch.launch.steps import make_pipeline_train_step
from repro_torch.launch.train import train_pipeline
from repro_torch.tree import tree_leaves
from helpers import torch_ranks as R
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
import test_torch_wire as W

SPAWN_TIMEOUT = 300          # seconds, each spawn of ranks
TRAIN_REL = 1e-5
EF_STEPS = W.EF_STEPS

# (a) exact, (b) the compressed sum, (c) the compressed wires
P2_CASES = {
    **{f"{s}-overlap{int(o)}": R.case(schedule=s, overlap=o)
       for s in ("chronos", "chronos_zb", "v_min") for o in (False, True)},
    **{f"psum{b}-overlap1": R.case(schedule="chronos_zb", overlap=True,
                                   grad_psum_bits=b, steps=EF_STEPS)
       for b in (8, 16)},
    **{f"wire-{w}-overlap1": R.case(overlap=True, wire=w)
       for w in ("bf16", "int8")},
}
P4_CASES = {f"chronos_zb-P4-overlap{int(o)}":
            R.case(schedule="chronos_zb", overlap=o, P=4, m=8)
            for o in (False, True)}


def _jax_cases():
    """(d): ``tests/test_torch_wire.py``'s cases on the JAX weights and
    tokens, the port's spec with ``overlap=True``."""
    out = {}
    for wire, bits in W.JAX_CASES:
        spec, jspec, jparams, _, tokens = W._jax_pair_setup(wire, bits)
        assert jspec.table.overlap     # the reference's default wire
        out[W._case(wire, bits)] = R.case(
            params=jax.tree.map(np.asarray, jparams), tokens=tokens,
            steps=EF_STEPS if bits else 1, overlap=True, wire=wire,
            grad_psum_bits=bits)
    return out


def _spawn_grads(cases, P):
    names = list(cases)
    outs = spawn(P, R.grads_on_ranks, args=([cases[n] for n in names],),
                 device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {n: [outs[r][i] for r in range(P)] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def p2_runs():
    return _spawn_grads({**P2_CASES, **_jax_cases()}, 2)


@pytest.fixture(scope="module")
def p4_runs():
    return _spawn_grads(P4_CASES, 4)


def _assert_bitwise(c, ranks):
    """Every rank's gradients, loss and error feedback against the
    one-device executor's on the same case."""
    ref = R.one_device(c)
    g0 = ref["g"]
    shared = [k for k in g0 if k != "blocks"]
    for r, got in enumerate(ranks):
        assert torch.equal(got["loss"], ref["loss"]), r
        for a, b in zip(tree_leaves(got["g"]["blocks"]),
                        tree_leaves(g0["blocks"]), strict=True):
            assert torch.equal(a, b[r]), r
        for k in shared:
            for a, b in zip(tree_leaves(got["g"][k]), tree_leaves(g0[k]),
                            strict=True):
                assert torch.equal(a, b), (r, k)
        if ref["ef"] is None:
            assert got["ef"] is None
            continue
        writers = psum_writers(R._spec(c), {k: g0[k] for k in shared})
        for e, e0, w in zip(tree_leaves(got["ef"]), tree_leaves(ref["ef"]),
                            writers, strict=True):
            if r in w:
                assert e.shape[0] == 1 and torch.equal(e[0], e0[w.index(r)])
            else:
                assert e.shape[0] == 0
        for s, s0 in zip(tree_leaves(got["scale"]),
                         tree_leaves(ref["scale"])):
            assert torch.equal(s, s0)


@pytest.mark.parametrize("name", list(P2_CASES))
def test_two_ranks_equal_one_device_bitwise(name, p2_runs):
    """(a)-(c) at P=2: chronos, chronos_zb and v_min (the V-shape's hops
    stay on the rank) with ``overlap`` off and on; the int8 and int16
    compressed sums over 3 steps with the error feedback threaded; the
    bf16 and int8 wires."""
    _assert_bitwise(P2_CASES[name], p2_runs[name])
    sent = [r["exchange"]["bytes_sent"] for r in p2_runs[name]]
    assert sum(sent) == sum(r["exchange"]["bytes_recv"]
                            for r in p2_runs[name])
    spec = R._spec(P2_CASES[name])
    steps = P2_CASES[name]["steps"]
    # the packed messages: one payload a stage-crossing send
    n_sends = dryrun.collective_stats(spec).count_by_kind[
        "collective-permute"]
    assert sum(sent) == steps * n_sends * 2 * payload_words(spec) * spec.mbB


@pytest.mark.parametrize("name", list(P4_CASES))
def test_four_ranks_equal_one_device_bitwise(name, p4_runs):
    """(a) at P=4: chronos_zb, 8 microbatches, ``overlap`` off and on:
    the interleaved chunk wraps (rank 3 -> 0 forward, 0 -> 3 backward)
    are ring rotations."""
    _assert_bitwise(P4_CASES[name], p4_runs[name])


@pytest.mark.parametrize("wire,bits", W.JAX_CASES,
                         ids=[W._case(*c) for c in W.JAX_CASES])
def test_two_ranks_match_jax_phase_executor(wire, bits, p2_runs,
                                            jax_phase_grads):
    """(d) The 2-rank run (``overlap=True``) against the JAX phase
    executor on two host devices with its default ``overlap=True``: the
    block gradients and loss within ``JAX_GRAD_TOL`` / ``JAX_LOSS_TOL``;
    the shared gradients within ``JAX_GRAD_TOL``, or under the
    compressed sum element by element in codes of the shared scale
    (``JAX_CODE_TOL``, at most ``JAX_CODES_MOVED`` past the noise), and
    the error feedback of each writing rank likewise."""
    key = W._case(wire, bits)
    ranks = p2_runs[key]
    ref = {k[len(key) + 1:]: a for k, a in jax_phase_grads.items()
           if k.startswith(key + "/")}
    g0 = ranks[0]["g"]
    shared = sorted(k for k in g0 if k != "blocks")
    # the blocks stacked over the ranks, as the reference's [P, ...]
    blocks = [torch.stack(a) for a in zip(*[tree_leaves(r["g"]["blocks"])
                                            for r in ranks])]
    ours = blocks + [g for k in shared for g in tree_leaves(g0[k])]
    n_blk = len(blocks)
    errs = []
    for i, g in enumerate(ours):
        want = ref[f"g{i}"]
        assert want.shape == tuple(g.shape)
        errs.append(float(np.abs(g.float().numpy() - want).max()
                          / (np.abs(want).max() + 1e-12)))
    e_loss = abs(float(ranks[0]["loss"]) - float(ref["loss"]))
    assert max(errs[:n_blk]) <= W.JAX_GRAD_TOL[wire, bits]
    assert e_loss <= W.JAX_LOSS_TOL[wire, bits]
    if not bits:
        assert max(errs[n_blk:]) <= W.JAX_GRAD_TOL[wire, bits]
        return
    scales = tree_leaves(ranks[0]["scale"])
    writers = psum_writers(R._spec(P2_CASES["psum8-overlap1"]),
                           {k: g0[k] for k in shared})
    codes = [np.abs(g.numpy() - ref[f"g{n_blk + j}"]).ravel() / float(s)
             for j, (g, s) in enumerate(zip(ours[n_blk:], scales))]
    for j, (w, s) in enumerate(zip(writers, scales)):
        want = ref[f"ef{j}"]
        for d in range(2):
            e = tree_leaves(ranks[d]["ef"])[j]
            if d in w:
                codes.append(np.abs(e[0].numpy() - want[d]).ravel()
                             / float(s))
            else:
                assert e.shape[0] == 0 and not want[d].any()
    codes = np.concatenate(codes)
    assert codes.max() <= W.JAX_CODE_TOL
    assert int((codes > W.CODE_NOISE).sum()) <= W.JAX_CODES_MOVED[wire, bits]


@pytest.fixture(scope="module")
def jax_phase_grads(tmp_path_factory):
    """The JAX phase executor's gradients, loss and error feedback for
    ``tests/test_torch_wire.py``'s cases, from that file run as its own
    child (two host devices; the overlapped exchange asked for)."""
    out = tmp_path_factory.mktemp("ranks") / "jax_phase.npz"
    env = dict(os.environ, REPRO_PIPELINE_OVERLAP="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, W.__file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# one device: the overlapped table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,P,m", [
    ("chronos", 2, 4), ("chronos_zb", 2, 4), ("v_min", 2, 4),
    ("chronos_zb", 4, 8), ("chronos_seq", 2, 4)])
def test_one_device_overlap_is_bitwise_the_synchronous_wire(schedule, P, m):
    """The double-buffered table runs each device's ops in the same
    order, its device-crossing sends landing a tick later: the one-device
    executor's gradients and loss are bitwise those of the synchronous
    table (the sequence-chunked executor too)."""
    res = []
    for overlap in (False, True):
        c = R.case(schedule=schedule, overlap=overlap, P=P, m=m,
                   **({"n_seq": 2} if schedule == "chronos_seq" else {}))
        res.append(R.one_device(c))
        assert R._spec(c).table.overlap == overlap
    a, b = res
    assert torch.equal(a["loss"], b["loss"])
    for x, y in zip(tree_leaves(a["g"]), tree_leaves(b["g"]), strict=True):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# (e) train_pipeline with a mesh
# ---------------------------------------------------------------------------

def _tc(**plan):
    return TrainConfig(
        model=get_reduced("tinyllama-1.1b"),
        shape=ShapeConfig("t", 17, 8, "train"),
        plan=ParallelPlan(**{**dict(schedule="chronos_zb", num_chunks=2,
                                    microbatch_size=2, num_microbatches=4,
                                    kernels="fused"), **plan}),
        optimizer=OptimizerConfig(warmup_steps=1, total_steps=3, lr=1e-3),
        log_every=1)


@pytest.mark.parametrize("plan", [{}, {"grad_compression": "int8_ef",
                                       "wire": "int8"}],
                         ids=["exact", "int8"])
def test_train_pipeline_on_ranks_tracks_one_device(plan):
    """(e) Three steps of ``train_pipeline(mesh=)`` on two ranks
    (``overlap=True``) against the one-device run: step 1's loss bitwise,
    the later ones within ``TRAIN_REL``; the gradient norm within it at
    every step; the shared replicas equal on both ranks after every
    step, by digest and leaf for leaf at the end; each rank's blocks the
    one-device run's column within ``TRAIN_REL`` of its largest
    element."""
    tc = _tc(**plan)
    one = train_pipeline(tc, P=2, device="cpu", log=lambda s: None)
    ranks = spawn(2, R.train_on_rank, args=(tc, 2, {"overlap": True,
                                                   "log": R.quiet}),
                  device="cpu", timeout_s=SPAWN_TIMEOUT)
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["steps"] == 3
        assert out["losses"][0] == one["losses"][0]
        np.testing.assert_allclose(out["losses"], one["losses"],
                                   rtol=TRAIN_REL, atol=0)
        np.testing.assert_allclose(out["grad_norms"], one["grad_norms"],
                                   rtol=TRAIN_REL, atol=0)
        assert out["replicas_equal"] == [True] * 3
        assert out["exchange"]["messages"] == [24] * 3
        for a, b in zip(tree_leaves(out["params"]["blocks"]),
                        tree_leaves(rank_params(one["params"], r)["blocks"]),
                        strict=True):
            assert float((a - b).abs().max()) <= TRAIN_REL * max(
                float(b.abs().max()), 1e-12)
    for k in ranks[0]["params"]:
        if k != "blocks":
            for a, b in zip(tree_leaves(ranks[0]["params"][k]),
                            tree_leaves(ranks[1]["params"][k])):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (f) the packed payload against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base"])
def test_pack_payload_matches_jax(arch, wire, bf16):
    """``pack_payload`` gives the reference's ``_pack_payload`` words
    bitwise (int8 codes and their fp32 scale words, bf16 casts, exact
    bitcasts, the aux sum broadcast over the rows, whisper's encoder
    output), ``payload_words`` its ``_payload_words``, and
    ``unpack_payload`` its ``_unpack_payload`` leaf for leaf, on the
    reference's words too."""
    spec, jspec = W._specs(arch, wire, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    pay = W._payload(spec, 11)
    keys = list(pay)
    ours = pack_payload(spec, tuple(
        torch.from_numpy(pay[k]).to(torch.float32 if k == "aux" else dt)
        for k in keys))
    jdt = jax.numpy.bfloat16 if bf16 else jax.numpy.float32
    jpay = {k: jax.numpy.asarray(a).astype(
        jax.numpy.float32 if k == "aux" else jdt) for k, a in pay.items()}
    jw = _pack_payload(jspec, jpay)
    assert payload_words(spec) == _payload_words(jspec) == jw.shape[1]
    assert ours.dtype == torch.uint16 and ours.shape == jw.shape
    np.testing.assert_array_equal(
        ours.view(torch.int16).numpy().view(np.uint16), np.asarray(jw))
    ref = _unpack_payload(jspec, jw)
    theirs = torch.from_numpy(np.asarray(jw).view(np.int16)) \
        .view(torch.uint16)
    for words in (ours, theirs):
        for k, a in zip(keys, unpack_payload(spec, words)):
            assert a.dtype == (torch.float32 if k == "aux" else dt)
            np.testing.assert_array_equal(
                a.float().numpy(),
                np.asarray(ref[k].astype(jax.numpy.float32)))


def test_int8_wire_refuses_an_odd_row():
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), d_model=63)
    spec = make_pipeline_spec(cfg, P=2, v=2, m=4, microbatch=2, seq_len=16,
                              schedule="chronos", wire="int8")
    with pytest.raises(ValueError, match="odd row length"):
        payload_words(spec)


# ---------------------------------------------------------------------------
# (g) the retime's sync mode and comm_calibration against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ((2, 4, 2), (4, 8, 2)),
                         ids=lambda s: "P%d-m%d-v%d" % s)
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_retime_sync_and_comm_calibration_match_jax(name, size):
    """``retime_with_comm(sync=True)`` (each device-crossing edge
    lengthens its producer and consumer by ``tc``) equals the
    reference's task for task, and ``comm_calibration``'s zero / sync /
    async makespans equal its own, at two latencies, for every
    registered generator."""
    P, m, v = size
    kw = {} if name in ("gpipe", "1f1b", "zb_h1", "v_min", "v_half", "v_zb",
                        "seq1f1b") else {"v": v}
    ours, ref = get_schedule(name, P, m, **kw), \
        jax_get_schedule(name, P, m, **kw)
    for tc in (0.25, 1.0):
        a = schedule_mod.retime_with_comm(ours, tc, sync=True)
        b = jax_schedule.retime_with_comm(ref, tc, sync=True)
        assert sorted((t.kind, t.mb, t.chunk, t.stage, t.seq, t.start,
                       t.dur, t.comm) for t in a.tasks) == \
            sorted((t.kind, t.mb, t.chunk, t.stage, t.seq, t.start, t.dur,
                    t.comm) for t in b.tasks)
        assert a.meta["tc"] == tc
        cal = schedule_mod.comm_calibration(ours, tc)
        assert cal == jax_schedule.comm_calibration(ref, tc)
        assert cal["zero"] <= cal["async"] <= cal["sync"]


# ---------------------------------------------------------------------------
# (h) refusals, and a failed or hung rank
# ---------------------------------------------------------------------------

def test_mesh_refusals():
    """NCCL with more ranks than cards (two on one device), or on the
    CPU, raises and names gloo's ``host`` transport, never falling back;
    an unknown backend and a one-rank mesh raise.  (The transport is not
    a choice: gloo with CUDA tensors is ``host``, everything else
    ``device``, as :func:`test_the_transport_follows_backend_and_device`
    checks.)"""
    with pytest.raises(RuntimeError, match="host transport"):
        check_mesh(2, backend="nccl", device="cuda")
    with pytest.raises(RuntimeError, match="two ranks on one device"):
        spawn(4, R.hang, backend="nccl", device="cuda")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        check_mesh(2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        check_mesh(2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        check_mesh(1, backend="gloo", device="cpu")


@pytest.mark.parametrize("backend,device,staged", [
    ("gloo", "cpu", False), ("gloo", "cuda", True), ("nccl", "cuda", False)])
def test_the_transport_follows_backend_and_device(backend, device, staged):
    """``host`` staging exactly where gloo is handed CUDA tensors."""
    mesh = PipeMesh(None, 0, 2, backend, torch.device(device))
    assert mesh.staged is staged


def test_mesh_refuses_seq_and_fault_seams():
    """The sequence-chunked executor (ROADMAP queue A item 6) and the fault
    seams, the injector and the watchdog (item 7, second part), under a
    mesh raise NotImplementedError naming their ROADMAP items, before any
    collective; Chronos-Offload and checkpoints run there
    (``tests/test_torch_mesh_offload.py``,
    ``tests/test_torch_mesh_checkpoint.py``)."""
    mesh = PipeMesh(None, 0, 2, "gloo", torch.device("cpu"))
    tc = _tc(schedule="chronos_seq", seq_chunks=2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 6"):
        make_pipeline_train_step(tc.model, tc.shape, tc.plan, tc.optimizer,
                                 P=2, device="cpu", mesh=mesh)
    seq = R._spec(R.case(schedule="chronos_seq", n_seq=2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 6"):
        make_train_grads_fn(seq, "cpu", mesh=mesh)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue A item 7, second part"):
        train_pipeline(_tc(), P=2, mesh=mesh, watchdog=object())
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue A item 7, second part"):
        train_pipeline(_tc(), P=2, mesh=mesh, injector=object())
    with pytest.raises(ValueError, match="P=4 stages on a mesh of 2"):
        train_pipeline(_tc(), P=4, mesh=mesh)


def test_a_failed_rank_fails_the_spawn():
    """Rank 1 raises while rank 0 waits in a collective: the spawn kills
    rank 0 and raises with rank 1's traceback, well inside its timeout."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(2, R.fail_on_rank_1, device="cpu", timeout_s=SPAWN_TIMEOUT)


def test_a_hung_rank_is_killed_at_the_timeout():
    with pytest.raises(RuntimeError, match="timed out after 10 s"):
        spawn(2, R.hang, device="cpu", timeout_s=10)


# ---------------------------------------------------------------------------
# the dry run's collective bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [None, 8])
def test_collective_stats_count_the_shared_gradient_sum(bits):
    """Beside the boundary payloads, each rank's shared-gradient sum: the
    fp32 leaves (tinyllama: the embedding, the head and the final norm),
    or their int32 codes and an fp32 amax a leaf, with one all-reduce a
    leaf (two compressed)."""
    cfg = get_config("tinyllama-1.1b")
    spec = make_pipeline_spec(cfg, P=4, v=2, m=8, microbatch=1,
                              seq_len=2049, schedule="chronos_zb",
                              grad_psum_bits=bits)
    st = dryrun.collective_stats(spec)
    n = 2 * cfg.vocab_size * cfg.d_model + cfg.d_model
    assert st.bytes_by_kind["all-reduce"] == 4 * (
        4 * n + (3 * 4 if bits else 0))
    assert st.count_by_kind["all-reduce"] == 4 * 3 * (2 if bits else 1)
    assert st.count_by_kind["collective-permute"] == 2 * 8 * (2 * 4 - 1)
