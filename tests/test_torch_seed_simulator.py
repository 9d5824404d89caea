"""The port's seed engine (``repro_torch.core.seed_simulator``, the
per-chunk ``OrderedDict`` parity oracle) against the port's vectorized
engine, as tests/test_simulator_parity.py holds the reference's two, and
against the reference's seed engine on the same cells.

Counters (faults, evictions, drops, bytes) must be int-equal and times
within 1e-9 relative: the two engines sum the same per-chunk float
contributions in different associations.  The two seed engines run the
same code and must agree exactly, residency order included.
"""
import dataclasses

import pytest

from repro.core import seed_simulator as r_seed
from repro.umbench import harness as rh
from repro.umbench import platforms as r_plat
from repro_torch.core import seed_simulator
from repro_torch.core import simulator as vec
from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.core.simulator import GB, OversubscriptionError
from repro_torch.umbench import platforms as plat
from repro_torch.umbench.harness import APPS, REGIMES

# tests/test_simulator_parity.py's sample: (app, platform, variant, regime);
# grace-hopper stays in_memory because the seed oracle is O(nchunks) per op
SAMPLE = [
    ("bs", "intel-pascal-pcie", "explicit", "in_memory"),
    ("bs", "intel-pascal-pcie", "um", "oversubscribed"),
    ("bs", "intel-pascal-pcie", "um_advise", "oversubscribed"),
    ("bs", "intel-pascal-pcie", "um_prefetch", "oversubscribed"),
    ("bs", "intel-pascal-pcie", "um_both", "oversubscribed"),
    ("bs", "intel-pascal-pcie", "explicit", "oversubscribed"),   # N/A parity
    ("bs", "intel-pascal-pcie", "um", "oversubscribed_2x"),
    ("cg", "intel-pascal-pcie", "um_advise", "oversubscribed_2x"),
    ("bs", "intel-volta-pcie", "um_prefetch", "in_memory"),
    ("cg", "intel-volta-pcie", "um_both", "oversubscribed"),     # own-thrash
    ("cg", "p9-volta-nvlink", "um_advise", "oversubscribed"),    # ping-pong
    ("cg", "p9-volta-nvlink", "um_advise", "in_memory"),         # remote init
    ("fdtd3d", "p9-volta-nvlink", "um_advise", "in_memory"),
    ("fdtd3d", "p9-volta-nvlink", "um_both", "oversubscribed"),
    ("graph500", "intel-pascal-pcie", "um_both", "oversubscribed"),  # pinned
    ("graph500", "intel-pascal-pcie", "um_prefetch", "oversubscribed"),
    ("conv0", "intel-volta-pcie", "um_both", "in_memory"),
    ("conv1", "intel-pascal-pcie", "um_advise", "oversubscribed"),
    ("cublas", "intel-pascal-pcie", "explicit", "in_memory"),
    ("cublas", "p9-volta-nvlink", "um", "oversubscribed"),
    ("bs", "grace-hopper-c2c", "um", "in_memory"),
    ("bs", "grace-hopper-c2c", "um_advise", "in_memory"),
]
# the port's own host-attach platform (no fault latency; the card reads the
# host, the host cannot read the card)
H100_SAMPLE = [
    ("bs", "h100-host", "um", "in_memory"),
    ("cg", "h100-host", "um_advise", "in_memory"),
    ("fdtd3d", "h100-host", "um_prefetch", "in_memory"),
]

COUNTERS = ("htod_bytes", "dtoh_bytes", "remote_bytes",
            "n_faults", "n_evictions", "n_dropped")
TIMES = ("compute_s", "fault_stall_s", "htod_s", "dtoh_s", "remote_s",
         "total_s")


def _run(engine, apps, platform, app, variant, regime):
    sim = engine.UMSimulator(platform)
    try:
        apps[app](sim, REGIMES[regime] * platform.device_mem_gb * GB, variant)
        return sim.finish()
    except OversubscriptionError:
        return None
    except r_seed.OversubscriptionError:
        return None


def assert_parity(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for k in COUNTERS:
        assert int(g[k]) == int(w[k]), (k, g[k], w[k])
    for k in TIMES:
        assert abs(g[k] - w[k]) <= 1e-9 * max(1.0, abs(w[k])), (k, g[k], w[k])


@pytest.mark.parametrize("app,pname,variant,regime", SAMPLE + H100_SAMPLE)
def test_vectorized_matches_seed(app, pname, variant, regime):
    platform = plat.PLATFORMS[pname]
    got = _run(vec, APPS, platform, app, variant, regime)
    want = _run(seed_simulator, APPS, platform, app, variant, regime)
    assert_parity(got, want)


@pytest.mark.parametrize("app,pname,variant,regime", SAMPLE)
def test_seed_matches_reference_seed(app, pname, variant, regime):
    """The port's seed engine against the reference's on the same cell:
    the same code, so the same report field for field."""
    got = _run(seed_simulator, APPS, plat.PLATFORMS[pname], app, variant, regime)
    want = _run(r_seed, rh.APPS, r_plat.PLATFORMS[pname], app, variant, regime)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_seed_variants_cover_all_paths():
    """The sample crosses every variant, every regime, and every simulated
    GPU platform."""
    variants = {v for _, _, v, _ in SAMPLE}
    regimes = {r for _, _, _, r in SAMPLE}
    platforms = {p for _, p, _, _ in SAMPLE}
    assert variants == {"explicit", "um", "um_advise", "um_prefetch", "um_both"}
    assert regimes == {"in_memory", "oversubscribed", "oversubscribed_2x"}
    assert platforms == {"intel-pascal-pcie", "intel-volta-pcie",
                         "p9-volta-nvlink", "grace-hopper-c2c"}


def _drive(engine, advise, platform):
    """A short call sequence over every advise and the eviction path;
    returns the simulator."""
    sim = engine.UMSimulator(platform)
    cap = int(platform.device_mem_gb * GB)
    sim.alloc("a", int(cap * 0.5), role="input")
    sim.alloc("b", int(cap * 0.4), role="input")
    sim.alloc("c", int(cap * 0.3), role="output")
    sim.host_write("a")
    sim.host_write("b")
    sim.advise_read_mostly("b")
    sim.advise_preferred_location("a", advise.DEVICE)
    sim.advise_accessed_by("c", advise.HOST)
    sim.prefetch("a")
    sim.kernel("k0", flops=1e10, reads=["a", "b"], writes=["c"])
    sim.kernel("k1", flops=1e10, reads=["c"], writes=["a"])
    sim.host_read("c")
    return sim


@pytest.mark.parametrize("pname", ("intel-pascal-pcie", "p9-volta-nvlink"))
def test_seed_residency_order_equals_reference(pname):
    """The literal residency queues after an oversubscribing sequence with
    every advise: equal in the two seed engines, and the port's vectorized
    engine reports the same counters."""
    class Port:
        DEVICE, HOST = MemorySpace.DEVICE, Accessor.HOST

    from repro.core.advise import Accessor as RAccessor
    from repro.core.advise import MemorySpace as RMemorySpace

    class Ref:
        DEVICE, HOST = RMemorySpace.DEVICE, RAccessor.HOST

    got = _drive(seed_simulator, Port, plat.PLATFORMS[pname])
    want = _drive(r_seed, Ref, r_plat.PLATFORMS[pname])
    assert got.residency_snapshot() == want.residency_snapshot()
    assert got.residency_snapshot()
    g, w = got.finish(), want.finish()
    assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert g.n_evictions > 0
    assert_parity(_drive(vec, Port, plat.PLATFORMS[pname]).finish(), g)
