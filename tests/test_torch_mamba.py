"""``repro_torch.kernels.ssd_scan`` and ``repro_torch.models.mamba`` against
the JAX package on the CPU.

Both sides get the same numpy inputs made from a seed.  The JAX chunk
scan runs as the JAX package's own tests run it here: the Pallas kernel
in interpret mode (``ssd_scan(..., interpret=True)`` and the ``ssd`` op,
which picks interpret mode on the CPU), the jnp ``_ssd_chunked`` and the
sequential ``ssd_reference``.  On CPU tensors the port's kernel wrapper
runs its plain version, ``ssd_chunked_ref``."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.models import backend as JB
from repro.models import mamba as JM
from repro_torch.configs import get_reduced
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import (SSDScan, ssd, ssd_chunked_ref,
                                          ssd_reference, ssd_scan,
                                          ssd_scan_route)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import backend as TB
from repro_torch.models import mamba as TM
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHUNK = 16
SSD_TOL = 1e-5            # fp32 chunk scan, port vs JAX (three oracles)
SSD_GRAD_TOL = 1e-4       # SSDScan gradients vs jax.vjp of the JAX op
BLOCK_TOL = 2e-5          # mamba_block forward, port vs JAX
BLOCK_GRAD_TOL = 2e-4     # mamba_block parameter gradients
SSD_ROUTE_TOL = 1e-4      # of max(1, max|ref|): chip_smoke.py's SSD_TOL

CFG = get_reduced("mamba2-2.7b")
JCFG = jax_get_reduced("mamba2-2.7b")


def _ssd_inputs(S, seed, B=2, H=3, P=8, N=16):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((B, S, H, P)).astype(np.float32),
        "Bc": (0.5 * rng.standard_normal((B, S, N))).astype(np.float32),
        "Cc": (0.5 * rng.standard_normal((B, S, N))).astype(np.float32),
        "dt": rng.uniform(0.05, 0.5, (B, S, H)).astype(np.float32),
        "A": -rng.uniform(0.2, 1.5, (H,)).astype(np.float32),
        "h0": (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32),
    }


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [16, 17, 40])
def test_ssd_matches_jax(S, with_h0):
    """``ssd_chunked_ref`` (and, from a zero state, ``ssd``) against the
    JAX Pallas kernel (interpret), ``_ssd_chunked`` and the sequential
    ``ssd_reference``; the port's own ``ssd_reference`` too."""
    inp = _ssd_inputs(S, seed=S + 100 * with_h0)
    names = ("x", "Bc", "Cc", "dt", "A")
    j = [jnp.asarray(inp[k]) for k in names]
    t = [_t(inp[k]) for k in names]
    jh0 = jnp.asarray(inp["h0"]) if with_h0 else None
    th0 = _t(inp["h0"]) if with_h0 else None

    oracles = {"_ssd_chunked": JM._ssd_chunked(*j, CHUNK, jh0),
               "ssd_reference": JM.ssd_reference(*j, h0=jh0)}
    ours = {"ssd_chunked_ref": ssd_chunked_ref(*t, CHUNK, th0),
            "ssd_reference": ssd_reference(*t, h0=th0),
            # the kernel's wrappers take the carried state too (on the
            # CPU they run ssd_chunked_ref)
            "ssd": ssd(*t, chunk=CHUNK, h0=th0),
            "ssd_scan": ssd_scan(*(_ssd_padded(t)), chunk=CHUNK, h0=th0)}
    if not with_h0:
        # the Pallas kernel starts from zero only
        oracles["pallas ssd (interpret)"] = jax_ssd(*j, chunk=CHUNK)
        if S % CHUNK == 0:
            oracles["pallas ssd_scan"] = jax_ssd_scan(*j, chunk=CHUNK,
                                                      interpret=True)
    for on, (yo, ho) in ours.items():
        if on == "ssd_scan":
            yo = yo[:, :S]
        for jn, (yj, hj) in oracles.items():
            ey, eh = _err(yo, yj), _err(ho, hj)
            print(f"S={S} h0={with_h0} {on} vs {jn}: y {ey:.2e} h {eh:.2e}")
            assert yo.shape == yj.shape and ho.shape == hj.shape
            assert ey <= SSD_TOL and eh <= SSD_TOL, (on, jn)


def _ssd_padded(t):
    """x, B, C, dt zero-padded to a chunk multiple (dt = 0 rows), A."""
    x, Bc, Cc, dt, A = t
    pad = (-x.shape[1]) % CHUNK
    z = torch.nn.functional.pad
    return (z(x, (0, 0, 0, 0, 0, pad)), z(Bc, (0, 0, 0, pad)),
            z(Cc, (0, 0, 0, pad)), z(dt, (0, 0, 0, pad)), A)


@pytest.mark.parametrize("S", [17, 40])
def test_ssd_scan_grads_match_jax_vjp(S):
    """Gradients of y and the final h through ``SSDScan`` against
    ``jax.vjp`` of the JAX package's ``ssd`` op (Pallas forward, jnp
    backward), with the same cotangents."""
    _ssd_grads_case(S, with_h0=False)


@pytest.mark.parametrize("S", [17, 40])
def test_ssd_scan_h0_grads_match_jax_vjp(S):
    """With a carried state: ``SSDScan`` against ``jax.vjp`` of
    ``_ssd_chunked(h0=)`` (the reference's route for a carried state),
    h0's gradient included."""
    _ssd_grads_case(S, with_h0=True)


def _ssd_grads_case(S, with_h0):
    inp = _ssd_inputs(S, seed=7 + S)
    rng = np.random.default_rng(S)
    dy = rng.standard_normal(inp["x"].shape).astype(np.float32)
    dh = rng.standard_normal(inp["h0"].shape).astype(np.float32)
    names = ("x", "Bc", "Cc", "dt", "A") + (("h0",) if with_h0 else ())
    if with_h0:
        def jfn(*a):
            return JM._ssd_chunked(*a[:5], CHUNK, a[5])
    else:
        def jfn(*a):
            return jax_ssd(*a, chunk=CHUNK)
    (yj, hj), vjp = jax.vjp(jfn, *(jnp.asarray(inp[k]) for k in names))
    gj = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts = [_t(inp[k]).requires_grad_() for k in names]
    y, h = SSDScan.apply(*ts[:5], ts[5] if with_h0 else None, CHUNK)
    assert y.grad_fn is not None and h.grad_fn is not None
    gt = torch.autograd.grad((y, h), ts, (_t(dy), _t(dh)))
    assert _err(y, yj) <= SSD_TOL and _err(h, hj) <= SSD_TOL
    for k, a, b in zip(names, gt, gj):
        e = _err(a, b)
        print(f"S={S} d{k}: {e:.2e}")
        assert a.shape == b.shape and e <= SSD_GRAD_TOL, k


def test_backend_routes_the_scan():
    """FUSED sends a zero-state scan and a carried state (serving's
    prefill) alike through ``SSDScan``, where the reference sends the
    carried state to its XLA scan; PLAIN never uses the Function.  On
    CPU tensors no kernel launches."""
    inp = _ssd_inputs(17, seed=3)
    t = [_t(inp[k]).requires_grad_() for k in ("x", "Bc", "Cc", "dt", "A")]
    before = ssd_scan.launches
    y, _ = TB.FUSED.ssd(*t, chunk=CHUNK)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    y, _ = TB.FUSED.ssd(*t, chunk=CHUNK, h0=_t(inp["h0"]))
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    y, _ = TB.PLAIN.ssd(*t, chunk=CHUNK)
    assert "SSDScan" not in type(y.grad_fn).__name__
    assert ssd_scan.launches == before


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_ssd_scan_on_cuda_tensors_launches_or_raises(monkeypatch):
    """For a CUDA tensor the wrapper goes to its route's C entry point,
    chosen by dtype (bf16: the tensor-core passes, fp32: the CUDA-core
    kernel), with the build stubbed: a library whose entry points raise
    with their name.  It never falls back to the plain version, and it
    rejects what the kernel does not take before the build."""
    class Refused(Exception):
        pass

    class Library:
        def __getattr__(self, name):
            raise Refused(name)

    builds = []

    def load():
        builds.append(1)
        return Library()

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(build, "load_library", load)
    monkeypatch.setattr(ssd_ops, "ssd_chunked_ref", no_plain)
    inp = _ssd_inputs(32, seed=5)
    before = ssd_scan.launches
    for dtype, entry, route in (
            (torch.float32, "ssd_scan_f32_launch", "cuda_cores"),
            (torch.bfloat16, "ssd_scan_bf16_launch", "tensor_cores")):
        assert ssd_scan_route(dtype) == route
        cl = {k: torch.from_numpy(v).to(dtype if k in ("x", "Bc", "Cc")
                                        else torch.float32)
              .as_subclass(_CudaLooking) for k, v in inp.items()}
        args = [cl[k] for k in ("x", "Bc", "Cc", "dt", "A")]
        with pytest.raises(Refused, match=f"^{entry}$"):
            ssd_scan(*args, chunk=CHUNK)
        with pytest.raises(Refused, match=f"^{entry}$"):
            ssd(*args, chunk=CHUNK)             # the Function's forward
        with pytest.raises(Refused, match=f"^{entry}$"):
            ssd(*args, chunk=CHUNK, h0=cl["h0"].float())  # a carried state
        n = len(builds)
        with pytest.raises(ValueError, match="h0"):
            ssd_scan(*args, chunk=CHUNK, h0=cl["h0"][:, :1].contiguous())
        with pytest.raises(ValueError, match="h0"):
            ssd_scan(*args, chunk=CHUNK, h0=cl["h0"].double())
        with pytest.raises(ValueError, match="multiple"):
            ssd_scan(*args, chunk=24)           # 32 % 24: not padded
        with pytest.raises(ValueError, match="float32"):
            ssd_scan(args[0], args[1], args[2], args[3].double(), args[4],
                     chunk=CHUNK)
        with pytest.raises(ValueError, match="the same"):
            ssd_scan(args[0], args[1].double(), args[2], args[3], args[4],
                     chunk=CHUNK)
        long = [torch.zeros(s, dtype=dt).as_subclass(_CudaLooking)
                for s, dt in (((1, 256, 1, 8), dtype), ((1, 256, 16), dtype),
                              ((1, 256, 16), dtype),
                              ((1, 256, 1), torch.float32),
                              ((1,), torch.float32))]
        with pytest.raises(ValueError, match="kernel's"):
            ssd_scan(*long, chunk=256)          # chunk above 128
        wide = [torch.zeros(s, dtype=dt).as_subclass(_CudaLooking)
                for s, dt in (((1, 32, 1, 8), dtype), ((1, 32, 264), dtype),
                              ((1, 32, 264), dtype),
                              ((1, 32, 1), torch.float32),
                              ((1,), torch.float32))]
        with pytest.raises(ValueError, match="kernel's"):
            ssd_scan(*wide, chunk=CHUNK)        # state above 256
        assert len(builds) == n                 # refused before the build
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan_route(torch.float16)
    assert ssd_scan.launches == before


def test_route_kernels_are_the_sources_kernels():
    """``ROUTE_KERNELS``, by which a profile tells the routes apart, names
    exactly the ``__global__`` functions of ``csrc/ssd_scan.cu``, and no
    name of one route is a name of the other."""
    src = (Path(ssd_ops.__file__).parents[2] / "csrc" / "ssd_scan.cu"
           ).read_text()
    defined = set(re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src))
    named = [k for ks in ssd_ops.ROUTE_KERNELS.values() for k in ks]
    assert sorted(named) == sorted(defined)
    assert set(ssd_ops.ROUTE_KERNELS) == {ssd_scan_route(torch.bfloat16),
                                          ssd_scan_route(torch.float32)}


# ---------------------------------------------------------------------------
# a mirror of the bf16 route's arithmetic (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

def _bf16(a):
    """Round to bf16 (nearest even) and widen back to fp32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _split(a):
    """The kernel's hi / lo pair of an fp32 operand: hi = bf16(a), lo =
    bf16(a - hi); with ``single`` the lo half is dropped (one rounding)."""
    hi = _bf16(a)
    return hi, _bf16(a.astype(np.float32) - hi)


def _mma(acc, a, b, k_axis_a, k_axis_b, spec):
    """``acc += a b`` the way mma.sync m16n8k16 sums: bf16 operands, each
    16-deep k-slab's products summed exactly (float64 here) and added to
    the fp32 accumulator."""
    K = a.shape[k_axis_a]
    for k0 in range(0, K, 16):
        sa = np.take(a, range(k0, min(k0 + 16, K)), axis=k_axis_a)
        sb = np.take(b, range(k0, min(k0 + 16, K)), axis=k_axis_b)
        acc = (acc + np.einsum(spec, sa.astype(np.float64),
                               sb.astype(np.float64))).astype(np.float32)
    return acc


def _mma_split(acc, a32, b, k_axis_a, k_axis_b, spec, single):
    """``acc += a32 b`` for an fp32 operand ``a32``: the hi product then
    the lo product for each k-slab, as the kernel issues them (only the
    hi one with ``single``)."""
    hi, lo = _split(a32)
    K = a32.shape[k_axis_a]
    for k0 in range(0, K, 16):
        ks = range(k0, min(k0 + 16, K))
        sb = np.take(b, ks, axis=k_axis_b).astype(np.float64)
        for part in ((hi,) if single else (hi, lo)):
            acc = (acc + np.einsum(spec, np.take(part, ks, axis=k_axis_a)
                                   .astype(np.float64), sb)).astype(
                                       np.float32)
    return acc


def _ssd_bf16_route_mirror(x, Bm, Cm, dt, A, Q, single=False):
    """The three passes of the bf16 route on one batch row at a time:
    x, B, C already bf16 (held as fp32), dt and A fp32.  Pass a: cum per
    chunk and head, the state contribution (x o w)^T B with w = exp(cum_end
    - cum) dt split hi / lo; pass b: the carry over the chunks; pass c:
    exp(cum_i) (C h_in^T) with h_in split, plus (C B^T o L) x with C B^T o
    L split.  Returns y [B,S,H,P] and h [B,H,P,N], fp32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // Q
    f32 = np.float32
    y = np.zeros((Bsz, S, H, P), f32)
    hout = np.zeros((Bsz, H, P, N), f32)
    tri = np.tril(np.ones((Q, Q), bool))
    for b in range(Bsz):
        xc = x[b].reshape(nc, Q, H, P).transpose(0, 2, 1, 3)    # [c,H,Q,P]
        Bc_, Cc_ = Bm[b].reshape(nc, Q, N), Cm[b].reshape(nc, Q, N)
        dtc = dt[b].reshape(nc, Q, H).transpose(0, 2, 1)        # [c,H,Q]
        cum = np.cumsum(dtc * A[None, :, None], axis=-1, dtype=f32)
        w = (np.exp(cum[..., -1:] - cum) * dtc).astype(f32)
        # pass a: add[c, h] = (x o w)^T B  -> [c,H,P,N]
        add = np.zeros((nc, H, P, N), f32)
        add = _mma_split(add, (xc * w[..., None]).astype(f32), Bc_, 2, 1,
                         "chqp,cqn->chpn", single)
        # pass b
        h_in = np.zeros((nc, H, P, N), f32)
        st = np.zeros((H, P, N), f32)
        for c in range(nc):
            h_in[c] = st
            st = (np.exp(cum[c, :, -1])[:, None, None] * st
                  + add[c]).astype(f32)
        hout[b] = st
        # pass c
        yc = np.zeros((nc, H, Q, P), f32)
        yc = _mma_split(yc, h_in, Cc_, 3, 2, "chpn,cqn->chqp", single)
        yc = (yc * np.exp(cum)[..., None]).astype(f32)
        s = _mma(np.zeros((nc, Q, Q), f32), Cc_, Bc_, 2, 2,
                 "cin,cjn->cij")[:, None]                     # [c,1,Q,Q]
        L = np.where(tri, np.exp(np.where(tri, cum[..., :, None]
                                          - cum[..., None, :], 0)), 0)
        sl = (s * (L * dtc[..., None, :]).astype(f32)).astype(f32)
        yc = _mma_split(yc, sl, xc, 3, 2, "chij,chjp->chip", single)
        y[b] = yc.transpose(0, 2, 1, 3).reshape(S, H, P)
    return y, hout


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 48, 3, 8, 16, 16),            # the reduced config's widths
    (2, 96, 3, 24, 40, 48),           # P, N, Q off the 16-multiples
    (1, 256, 80, 64, 128, 128),       # mamba2-2.7b's widths, two chunks
])
def test_ssd_bf16_route_mirror_matches_the_references(B, S, H, P, N, Q):
    """The bf16 route's arithmetic, mirrored in numpy (bf16 x, B, C; the
    fp32 operands as bf16 hi + lo; fp32 accumulation of 16-deep k-slabs),
    against ``ssd_chunked_ref`` and the JAX Pallas ``ssd_scan`` (interpret
    mode) on the same inputs, within 1e-4 * max(1, max|ref|), the bound
    the card's check holds the kernel to.  One bf16 rounding of the fp32
    operand instead of the split is printed beside it: it misses that
    bound, which is why the split is there."""
    rng = np.random.default_rng(S + H)
    x = _bf16(rng.standard_normal((B, S, H, P)))
    Bm = _bf16(0.5 * rng.standard_normal((B, S, N)))
    Cm = _bf16(0.5 * rng.standard_normal((B, S, N)))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)).astype(
        np.float32)
    A = -np.exp(rng.uniform(-0.5, 0.5, H)).astype(np.float32)
    refs = {"ssd_chunked_ref": [a.numpy() for a in ssd_chunked_ref(
                *(_t(a) for a in (x, Bm, Cm, dt, A)), Q)],
            "pallas ssd_scan": [np.asarray(a) for a in jax_ssd_scan(
                *(jnp.asarray(a) for a in (x, Bm, Cm, dt, A)), chunk=Q,
                interpret=True)]}
    split = _ssd_bf16_route_mirror(x, Bm, Cm, dt, A, Q)
    single = _ssd_bf16_route_mirror(x, Bm, Cm, dt, A, Q, single=True)
    for name, (yr, hr) in refs.items():
        scale = max(1.0, float(np.abs(yr).max()), float(np.abs(hr).max()))
        e = max(_err(split[0], yr), _err(split[1], hr)) / scale
        e1 = max(_err(single[0], yr), _err(single[1], hr)) / scale
        print(f"x [{B},{S},{H},{P}] N={N} Q={Q} vs {name}: hi + lo "
              f"{e:.2e}, one bf16 rounding {e1:.2e} (of max(1, max|ref|); "
              f"bound {SSD_ROUTE_TOL:g})")
        assert split[0].shape == yr.shape and split[1].shape == hr.shape
        assert e <= SSD_ROUTE_TOL, name
        assert e1 > SSD_ROUTE_TOL, name


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

def _block_params(seed=0):
    """One reduced Mamba-2 block's weights: JAX ``init_mamba`` with the
    per-head leaves and norm scale redrawn, so no gradient is trivially
    zero and no value is the init constant."""
    p, _ = JM.init_mamba(jax.random.key(seed), JCFG.d_model, JCFG.ssm,
                         jnp.float32)
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    H = p["A_log"].shape[0]
    p["A_log"] = rng.uniform(-0.5, 0.5, H).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["dt_bias"] = rng.uniform(-3.0, -1.0, H).astype(np.float32)
    p["norm_scale"] = rng.uniform(0.5, 1.5,
                                  p["norm_scale"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("kernels", ["fused", "plain"])
def test_mamba_block_matches_jax(kernels):
    """Forward and every parameter (and input) gradient of one block: the
    port's fused backend against JAX ``backend=FUSED`` (Pallas scan in
    interpret mode), the plain backend against JAX's default XLA path."""
    p = _block_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 17, JCFG.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jbk = JB.FUSED if kernels == "fused" else None

    def jf(params, x_):
        return (JM.mamba_block(params, x_, JCFG.ssm, backend=jbk)[0]
                * cot).sum()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    yj, _ = JM.mamba_block(jp, jnp.asarray(x), JCFG.ssm, backend=jbk)
    gpj, gxj = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    y, cache = TM.mamba_block(tp, tx, CFG.ssm,
                              backend=TB.get_backend(kernels))
    assert cache is None
    names = sorted(tp)
    grads = torch.autograd.grad(y, [tp[k] for k in names] + [tx], _t(cot))
    e_y = _err(y, yj)
    e_g = {k: _err(g, gpj[k]) for k, g in zip(names, grads)}
    e_g["x"] = _err(grads[-1], gxj)
    print(f"{kernels}: y {e_y:.2e}, grads max {max(e_g.values()):.2e}")
    assert e_y <= BLOCK_TOL
    assert max(e_g.values()) <= BLOCK_GRAD_TOL, e_g


def test_mamba_block_cache_streams_match_jax():
    """Serving's cache branches: two 16-token prefill chunks from a zero
    cache, then four decode steps, each fed the JAX block's previous
    output row; outputs and the cache (conv tails, state) after every step
    against the JAX block's stream.  The port writes the cache in
    place."""
    p = _block_params(seed=2)
    rng = np.random.default_rng(3)
    d = JCFG.d_model
    prompt = rng.standard_normal((2, 32, d)).astype(np.float32)
    jc = JM.init_mamba_cache(2, d, JCFG.ssm, jnp.float32)
    tc = TM.init_mamba_cache(2, d, CFG.ssm, torch.float32, "cpu")
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tuple(jc[k].shape) == tuple(tc[k].shape), k
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    steps = [prompt[:, :16], prompt[:, 16:]]
    worst = 0.0
    for i in range(6):
        xin = steps[i] if i < 2 else nxt
        yj, jc = JM.mamba_block(jp, jnp.asarray(xin), JCFG.ssm, cache=jc,
                                backend=JB.FUSED)
        with torch.no_grad():
            yt, tc2 = TM.mamba_block(tp, _t(xin), CFG.ssm, cache=tc,
                                     backend=TB.FUSED)
        assert tc2 is tc
        errs = [_err(yt, yj)] + [_err(tc[k], jc[k]) for k in jc]
        worst = max(worst, *errs)
        nxt = np.asarray(yj)[:, -1:]
    print(f"prefill x2 + decode x4: max |port - jax| {worst:.2e}")
    assert worst <= BLOCK_TOL


def test_chunked_prefill_equals_the_full_pass():
    """Two prefill chunks through the cache equal one pass over the whole
    prompt (the conv tail and the state carry across the chunk edge)."""
    p = {k: _t(v) for k, v in _block_params(seed=4).items()}
    x = _t(np.random.default_rng(5).standard_normal(
        (1, 32, CFG.d_model)).astype(np.float32))
    cache = TM.init_mamba_cache(1, CFG.d_model, CFG.ssm, torch.float32,
                                "cpu")
    y1, _ = TM.mamba_block(p, x[:, :16], CFG.ssm, cache=cache)
    y2, _ = TM.mamba_block(p, x[:, 16:], CFG.ssm, cache=cache)
    full, _ = TM.mamba_block(p, x, CFG.ssm)
    e = _err(torch.cat([y1, y2], dim=1), full.numpy())
    print(f"chunked vs full prefill: {e:.2e}")
    assert e <= 1e-6          # bitwise on this CPU; rows of other GEMMs
