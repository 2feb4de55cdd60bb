"""One tick of the port's ``make_step_fn`` equals the JAX package's tick,
run op by op under ``jax.disable_jit()``, bit for bit.

3,000 random lanes per controller code and partition count, on a plain
tick and on a controller tick (Slow Start, the SLA tuners and Algorithm 3
run there).  The lanes cover drained and nearly drained partitions
(whose arithmetic underflows into float32 subnormals, which XLA flushes to
zero), finished transfers, out-of-range operating points, empty
accumulation windows and every FSM state.  Jitted JAX is not the oracle here: XLA's fused kernels round
differently from its op-by-op semantics (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import controllers as jc
from repro.api import environments as jenv
from repro.core import engine as jengine
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.api import controllers as tc
from repro_torch.api import environments as tenv
from repro_torch.core import engine as tengine
from repro_torch.core import types as ttypes

N = 3000
DT = 0.1
CTRL_EVERY = 10

# name -> (JAX controller code, port controller code)
CODES = {
    "ME": (jc.TunerController(jtypes.SLA(jtypes.SLAPolicy.MIN_ENERGY)),
           tc.TunerController(ttypes.SLA(ttypes.SLAPolicy.MIN_ENERGY))),
    "EEMT": (jc.TunerController(jtypes.SLA()), tc.TunerController(ttypes.SLA())),
    "EETT": (jc.TunerController(jtypes.SLA(jtypes.SLAPolicy.TARGET_THROUGHPUT)),
             tc.TunerController(ttypes.SLA(ttypes.SLAPolicy.TARGET_THROUGHPUT))),
    "ME-noscale": (
        jc.TunerController(jtypes.SLA(jtypes.SLAPolicy.MIN_ENERGY), scaling=False),
        tc.TunerController(ttypes.SLA(ttypes.SLAPolicy.MIN_ENERGY), scaling=False)),
    "EEMT-noscale": (jc.TunerController(jtypes.SLA(), scaling=False),
                     tc.TunerController(ttypes.SLA(), scaling=False)),
    "EETT-noscale": (
        jc.TunerController(jtypes.SLA(jtypes.SLAPolicy.TARGET_THROUGHPUT),
                           scaling=False),
        tc.TunerController(ttypes.SLA(ttypes.SLAPolicy.TARGET_THROUGHPUT),
                           scaling=False)),
    "ismail-target": (jc.IsmailTargetController(), tc.IsmailTargetController()),
    "static": (jc.StaticBaselineController(label="<static>"),
               tc.StaticBaselineController(label="<static>")),
}


def _u(rng, lo, hi, shape=N):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def random_lanes(rng, p):
    """Random (ScanInputs, SimState, TunerState, bw_scale), numpy, [N]."""
    remaining = _u(rng, 0, 1e4, (N, p)) * (rng.random((N, p)) > 0.3)
    # Nearly drained partitions: normal floats whose shares, rates and
    # remainders underflow — XLA flushes those subnormals to zero.
    tiny = rng.random((N, p)) < 0.15
    remaining[tiny] = (10.0 ** rng.uniform(-37.9, -33, tiny.sum())).astype(
        np.float32)
    remaining[rng.random(N) < 0.1] = 0.0          # finished transfers
    acc_s = _u(rng, 0, 2) * (rng.random(N) > 0.05)  # some empty windows
    avg = _u(rng, 0, 2000)
    acc_mb = acc_s * avg
    acc_j = acc_s * _u(rng, 5, 60)
    net = jtypes.NetParams(_u(rng, 50, 2000), _u(rng, 0.005, 0.1),
                           _u(rng, 0.3, 8), _u(rng, 0.5, 16), _u(rng, 1, 2),
                           _u(rng, 0, 0.5))
    sla = jtypes.SLAParams(
        _u(rng, 0, 1500) * (rng.random(N) > 0.2), _u(rng, 0, 0.3),
        _u(rng, 0, 0.3), rng.integers(1, 9, N).astype(np.float32),
        rng.integers(2, 129, N).astype(np.float32), _u(rng, 0.6, 0.95),
        _u(rng, 0.1, 0.5))
    ts = jtypes.TunerState(
        fsm=rng.integers(0, 5, N).astype(np.int32),
        num_ch=_u(rng, 0.5, 128), prev_num_ch=_u(rng, 0.5, 128),
        # references around the measured window, so every feedback branch
        # (better / worse / within the band) is taken
        ref=avg * _u(rng, 0.5, 1.5) * rng.choice(
            np.float32([1.0, 10.0, 1000.0]), N),
        cores=rng.integers(-1, 11, N).astype(np.int32),
        freq_idx=rng.integers(-2, 9, N).astype(np.int32),
        acc_mb=acc_mb, acc_j=acc_j, acc_s=acc_s)
    sim = jtypes.SimState(remaining, _u(rng, 0, 8, (N, p)),
                          _u(rng, 0, 3600), _u(rng, 0, 1e5), _u(rng, 0, 1e6))
    inp = jengine.ScanInputs(
        net=net, sla=sla, pp=_u(rng, 0.5, 128, (N, p)),
        par=_u(rng, 0.5, 10, (N, p)), total_mb=_u(rng, 0, 1e4, (N, p)),
        avg_file_mb=_u(rng, 1e-3, 300, (N, p)), state0=ts,
        static_w=_u(rng, 0, 1, (N, p)), bw=_u(rng, 0, 1.2))
    return inp, sim, ts, inp.bw


def jax_step(ctrl, inp, sim, ts, bw, step_idx):
    cpu = jtypes.CpuProfile()

    def one(inp, sim, ts, bw):
        step = jengine.make_step_fn(ctrl, jenv.REFERENCE_ENV, cpu, inp,
                                    dt=DT, ctrl_every=CTRL_EVERY)
        return step((sim, ts), (jnp.int32(step_idx), bw))

    with jax.disable_jit():
        out = jax.vmap(one)(inp, sim, ts, bw)
    return jax.tree.map(np.asarray, out)


def torch_step(ctrl, inp, sim, ts, bw, step_idx):
    step = tengine.make_step_fn(ctrl, tenv.REFERENCE_ENV, ttypes.CpuProfile(),
                                convert.to_torch(inp), dt=DT,
                                ctrl_every=CTRL_EVERY)
    (sim2, ts2), m = step((convert.to_torch(sim), convert.to_torch(ts)),
                          (step_idx, convert.to_torch(bw)))
    return (convert.to_numpy(sim2), convert.to_numpy(ts2)), convert.to_numpy(m)


@pytest.mark.parametrize("p", [1, 2, 3, 5])
@pytest.mark.parametrize("code", sorted(CODES))
def test_step_bit_exact_vs_jax_eager(code, p):
    jctrl, tctrl = CODES[code]
    rng = np.random.default_rng(100 * sorted(CODES).index(code) + p)
    inp, sim, ts, bw = random_lanes(rng, p)
    for step_idx in (3, CTRL_EVERY - 1):          # plain tick, controller tick
        (jsim, jts), jm = jax_step(jctrl, inp, sim, ts, bw, step_idx)
        (tsim, tts), tm = torch_step(tctrl, inp, sim, ts, bw, step_idx)
        for group, want, got in (("sim", jsim, tsim), ("ts", jts, tts),
                                 ("metrics", jm, tm)):
            for field, w, g in zip(want._fields, want, got):
                bad = np.flatnonzero(np.asarray(w != g).reshape(N, -1)
                                     .any(axis=1))
                assert bad.size == 0, (
                    f"{code} P={p} step {step_idx}: {group}.{field} differs "
                    f"in {bad.size} lanes, e.g. lane {bad[0]}: "
                    f"{w[bad[0]]} vs {g[bad[0]]}")
