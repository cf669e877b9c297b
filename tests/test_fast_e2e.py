"""Fast-tier end-to-end smoke: single-chip driver + CPUTracker oracle.

Round-3 shipped with the Python oracle broken at HEAD because every test
touching it was nightly-only (`@pytest.mark.slow`).  This file keeps a
minimal driver end-to-end run and a CPUTracker smoke in the per-push tier
so a broken driver/oracle chain cannot ship silently again.  Budget:
~1-2 min on the single-core CI host (one tiny-pool engine compile).
"""

import jax
import numpy as np
import pytest

from grmonty.transport import engine as engine_mod


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    from grmonty.models import torus
    from grmonty.transport import driver

    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    cfg = engine_mod.EngineConfig(
        n_pool=64, m_period=8, sec_cap=512, max_outer=40000, stall_steps=40000
    )
    return driver.Simulation(
        str(path), photon_n=30, mass_unit=4.0e18, config=cfg,
        emit_chunk=1024, warmup=0,
    )


def test_driver_end_to_end(sim):
    """The single-chip driver runs a tiny budget to completion and the
    spectrum/counter accounting holds (mirrors harm_model.cpp:362-414)."""
    spec, stats = sim.run()
    assert stats["n_recorded"] > 0
    assert np.isfinite(spec[: engine_mod.N_BINS]).all()
    nph = spec[: engine_mod.N_BINS, 2].sum()
    assert nph == stats["n_recorded"]
    assert spec[: engine_mod.N_BINS, 1].sum() > 0  # nonzero luminosity


def test_cpu_tracker_smoke(sim):
    """CPUTracker tracks emitted photons end-to-end (the oracle chain's
    middle link; regression coverage for the round-3 prims-closure break)."""
    from grmonty.transport import cpu_reference

    plan = sim.plan()
    b = jax.device_get(sim.emit(plan, 0, 1024))
    w = np.asarray(b.w, np.float64) / sim.cfg.weight_scale
    b = b._replace(w=w)
    assert int(np.sum(np.asarray(b.w) > 0)) > 0

    tr = cpu_reference.CPUTracker(sim.mc, sim.tables, sim.prims, seed=5)
    spec = tr.run(b, limit=2)
    assert np.isfinite(spec).all()
    assert tr.n_recorded > 0


def test_warm_pilot_accounting(sim, tmp_path):
    """Counters == spectrum with the host-oracle pilot ACTIVE (warmup > 0).

    Round-4 shipped with `run()` over-reporting n_recorded by the pilot's
    records in every single-chip run: the host-oracle pilot injects its
    n_recorded/n_scatt_rec into the engine counters (bias warmup) while
    its spectrum is deliberately dropped, and only the SHARDED driver
    subtracted the baseline.  The then-fast-tier e2e pinned warmup=0 and
    was blind to the class.  This test pins the invariant with the pilot
    on: every photon binned in the spectrum is counted exactly once
    (harm_model.cpp:409-413 counter reconciliation).
    """
    from grmonty.models import torus
    from grmonty.transport import driver
    from grmonty.transport.oracle_native import NativeTracker  # noqa: F401

    path = tmp_path / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    cfg = engine_mod.EngineConfig(
        n_pool=64, m_period=8, sec_cap=512, max_outer=40000, stall_steps=40000
    )
    s = driver.Simulation(
        str(path), photon_n=30, mass_unit=4.0e18, config=cfg,
        emit_chunk=1024, warmup=64,
    )
    spec, stats = s.run()
    # the host-oracle pilot must actually have run (else this test is not
    # exercising the accounting class it exists for)
    assert s._warm_counts is not None and s._warm_counts[0] > 0
    assert stats["n_recorded"] > 0
    nph = spec[: engine_mod.N_BINS, 2].sum()
    assert nph == stats["n_recorded"]
