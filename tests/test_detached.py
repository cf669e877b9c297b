"""detached_events sanity: immediate parent continuation after scatter.

With EngineConfig.detached_events, a parent photon captures its scatter
event into per-lane shadow registers and keeps moving instead of parking
at_event until the next periodic phase.  The physics is identical (the
event record is the same pre-sampling state process_scatters would have
read from the parked lane; the parent's fate and opacity refresh depend
only on parent state) — only the RNG trajectory differs, so parity with
the default path is statistical.  This drives a full tiny simulation both
ways and asserts the global observables agree while event parking
actually disappears from the lane-slot census.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from grmonty.transport import engine as engine_mod

# Heavy tier: multi-minute engine compiles / long transport runs on the
# single-core CI host (tests/conftest.py tiering).
pytestmark = pytest.mark.slow


def _run(tmp_path_factory, detached):
    from grmonty.models import torus
    from grmonty.transport import driver

    path = tmp_path_factory.mktemp("dumps") / f"torus_d{int(detached)}"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    cfg = engine_mod.EngineConfig(
        n_pool=256, m_period=8, sec_cap=4096, max_outer=40000,
        stall_steps=40000, detached_events=bool(detached),
    )
    sim = driver.Simulation(
        str(path), photon_n=60, mass_unit=4.0e18, config=cfg,
        emit_chunk=2048, warmup=128,
    )
    spec, stats = sim.run()
    return np.asarray(spec), stats


@pytest.mark.slow
def test_detached_events_preserves_observables(tmp_path_factory):
    spec0, st0 = _run(tmp_path_factory, False)
    spec1, st1 = _run(tmp_path_factory, True)

    assert np.isfinite(spec1).all()
    assert st1["n_recorded"] > 0
    # same photon accounting within loose MC bounds (different RNG path)
    r0 = st0["n_recorded"] / max(st0["n_created"], 1)
    r1 = st1["n_recorded"] / max(st1["n_created"], 1)
    assert 0.7 < r1 / r0 < 1.4, (r0, r1)
    # luminosity per created photon within 25% (few-thousand-photon MC)
    l0 = spec0[:, 1].sum() / max(st0["n_created"], 1)
    l1 = spec1[:, 1].sum() / max(st1["n_created"], 1)
    assert 0.75 < l1 / l0 < 1.33, (l0, l1)
    # scattering actually happened in both runs (the deviation under test)
    assert st0["n_scatt_recorded"] > 0 and st1["n_scatt_recorded"] > 0
    # Event parking becomes negligible.  It does not vanish at THIS scale:
    # the tiny pool's auto EV_K (n_pool/8 = 32) lets consumed-per-phase lag
    # events-per-phase, so pending registers linger and second events park.
    # Both runs are chaotic few-photon trajectories, so the two parked
    # fractions individually vary across hosts (FP reassociation differs by
    # CPU codegen); require a real reduction only when the baseline parks a
    # substantial fraction, and otherwise just bound the detached residual.
    assert (
        st1["util_parked"] < 0.6 * st0["util_parked"]
        or st1["util_parked"] < 0.02
    ), (st0["util_parked"], st1["util_parked"])


@pytest.mark.slow
def test_detached_flush_terminates_with_pending_event(tmp_path_factory):
    """A lane that is record_pending AND still holds an unconsumed detached
    event must not spin the end-of-dispatch flush loop.

    Regression: engine.run()'s final flush looped on ``any(record_pending)``
    while spectrum_add (correctly) refuses to record lanes whose event
    registers are unconsumed — an infinite on-device while_loop that hung
    the dispatch (reproduced twice on hardware: wave 2 slice 0 of any
    detached run at real occupancy).  The flush must skip such lanes and leave them
    occupied for the next dispatch's periodic phase.

    Runs in a subprocess so a regression fails by timeout instead of
    hanging the suite.
    """
    dump = tmp_path_factory.mktemp("dumps") / "torus_flush"
    from grmonty.models import torus

    torus.write_torus_dump(str(dump), n1=64, n2=32)
    child = textwrap.dedent(
        """
        import sys
        import jax
        import jax.numpy as jnp
        import numpy as np
        from jax import random

        from grmonty.transport import driver, engine as engine_mod

        cfg = engine_mod.EngineConfig(
            n_pool=256, m_period=8, sec_cap=1024, max_outer=64,
            stall_steps=1000, detached_events=True)
        sim = driver.Simulation(sys.argv[1], photon_n=60, mass_unit=4e18,
                                config=cfg, emit_chunk=256, warmup=16)
        eng = sim.engine
        state = eng["fresh_state"](random.PRNGKey(0))
        one = jnp.zeros(256, bool).at[0].set(True)
        pool = state.pool._replace(
            occupied=one, record_pending=one, ev_pending=one,
            alive=jnp.zeros(256, bool),
            # plausible event/record payloads so nothing NaNs
            w=jnp.where(one, 1.0, 0.0).astype(pool_dt := state.pool.w.dtype),
            e=jnp.where(one, 1e-6, 0.0).astype(pool_dt),
        )
        state = state._replace(pool=pool)
        rows = jnp.zeros((1, engine_mod.ROW_WIDTH), cfg.dtype)
        # tail_exit = n_pool and an empty, fully-consumed backlog: the main
        # while_loop exits immediately and control reaches the flush loop.
        out = jax.block_until_ready(
            jax.jit(eng["run"])(state, rows, jnp.asarray(256, jnp.int32),
                                jnp.asarray(0, jnp.int32)))
        assert bool(out.pool.occupied[0]), "lane must stay occupied"
        assert bool(out.pool.record_pending[0])
        assert bool(out.pool.ev_pending[0])
        print("FLUSH-OK")
        """
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", child, str(dump)],
        capture_output=True, text=True, timeout=1500, env=env,
    )
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "FLUSH-OK" in res.stdout
