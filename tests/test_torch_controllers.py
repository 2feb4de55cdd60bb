"""Algorithm 1 and the controllers' host-side ``init`` in the port equal
the JAX package's bit for bit: initial parameters, tuner state, numeric
SLA view, static weights and the chunked dataset specs, for every ported
controller on the three testbeds and the four Figure 2 datasets."""
import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro.core import types as jtypes
from repro_torch import api as tapi
from repro_torch.core import types as ttypes

DATASETS = {"small": ("SMALL_FILES",), "medium": ("MEDIUM_FILES",),
            "large": ("LARGE_FILES",),
            "mixed": ("SMALL_FILES", "MEDIUM_FILES", "LARGE_FILES")}

# (registry name, kwargs): every controller the port ships.
CONTROLLERS = [
    ("ME", {}), ("EEMT", {}), ("EETT", {}), ("EETT", {"target_tput_mbps": 400.0}),
    ("ME", {"scaling": False}), ("EEMT", {"scaling": False, "max_ch": 16}),
    ("EETT", {"scaling": False, "target_tput_mbps": 90.0}),
    ("ismail-target", {"target_tput_mbps": 400.0}), ("wget/curl", {}),
    ("http/2", {}), ("ismail-min-energy", {}), ("ismail-max-tput", {}),
]


def test_registries_list_the_ported_controllers():
    assert set(tapi.list_controllers()) == set(japi.list_controllers())


def test_constants_match_jax():
    for name in ("SMALL_FILES", "MEDIUM_FILES", "LARGE_FILES", "CHAMELEON",
                 "CLOUDLAB", "DIDCLAB"):
        assert (dataclasses.astuple(getattr(ttypes, name))
                == dataclasses.astuple(getattr(jtypes, name))), name
    for cls in ("CpuProfile", "SLA", "NetworkProfile"):
        assert (dataclasses.astuple(getattr(ttypes, cls)())
                == dataclasses.astuple(getattr(jtypes, cls)())), cls


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("testbed", ["chameleon", "cloudlab", "didclab"])
@pytest.mark.parametrize("ctrl", range(len(CONTROLLERS)),
                         ids=[f"{n}{sorted(k.items())}" for n, k in CONTROLLERS])
def test_controller_init_bit_exact(ctrl, testbed):
    name, kw = CONTROLLERS[ctrl]
    jctrl = japi.make_controller(name, **kw)
    tctrl = tapi.make_controller(name, **kw)
    assert tctrl.name == jctrl.name and tctrl.tunes == jctrl.tunes
    assert tctrl.timeout_s == jctrl.timeout_s
    cpu_j, cpu_t = jtypes.CpuProfile(), ttypes.CpuProfile()
    for ds, members in DATASETS.items():
        want = jctrl.init(tuple(getattr(jtypes, m) for m in members),
                          jtypes.TESTBEDS[testbed], cpu_j)
        got = tctrl.init(tuple(getattr(ttypes, m) for m in members),
                         ttypes.TESTBEDS[testbed], cpu_t)
        where = f"{name} {kw} {testbed}/{ds}"
        for f in want.params._fields:
            assert _same(getattr(want.params, f), getattr(got.params, f)), \
                (where, "params", f)
        for f in want.state._fields:
            assert _same(getattr(want.state, f), getattr(got.state, f)), \
                (where, "state", f)
        for f in want.sla._fields:
            assert _same(getattr(want.sla, f), getattr(got.sla, f)), \
                (where, "sla", f)
        assert _same(want.static_weights, got.static_weights), where
        assert ([dataclasses.astuple(s) for s in want.specs]
                == [dataclasses.astuple(s) for s in got.specs]), where
