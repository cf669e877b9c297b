"""fluid_cache parity: the lane corner-row cache must reproduce the plain
pool-wide gather path exactly (same RNG stream, same physics; residual is
FP reassociation only — see EngineConfig.fluid_cache and
fluid.get_fluid_params_frow).

The cache path re-gathers only lanes whose bilinear cell changed, staging
the refresh as compacted per-component lane scatters; this test drives both
engines from an identical loaded state through hot steps and periodic
phases and requires the pools to stay numerically locked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import random

from grmonty.transport import engine as engine_mod

# Heavy tier: multi-minute engine compiles / long transport runs on the
# single-core CI host (tests/conftest.py tiering).
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from grmonty.models import torus
    from grmonty.transport import driver

    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    mk = lambda fc: driver.Simulation(
        str(path), photon_n=60, mass_unit=4.0e18,
        config=engine_mod.EngineConfig(
            n_pool=256, m_period=8, sec_cap=4096, max_outer=40000,
            stall_steps=40000, fluid_cache=fc),
        emit_chunk=2048, warmup=128,
    )
    return mk(False), mk(True)


def _advance(sim, backlog, n_phases=3, n_hot=16):
    eng = sim.engine
    state = eng["fresh_state"](random.PRNGKey(7))
    per = jax.jit(eng["periodic_phase"])
    hot = jax.jit(eng["hot_step"])
    for _ in range(n_phases):
        state = per(state, backlog)
        for _ in range(n_hot):
            state = hot(state)
    return jax.device_get(state)


def test_fluid_cache_matches_gather_path(pair):
    sim_off, sim_on = pair
    plan = sim_off.plan()
    batch = sim_off.emit(plan, 0, 512)
    backlog = jnp.asarray(
        engine_mod.pack_rows(batch, sim_off.cfg.dtype))

    s_off = _advance(sim_off, backlog)
    s_on = _advance(sim_on, backlog)

    p_off, p_on = s_off.pool, s_on.pool
    # Lane masks must be identical (any marginal decision flip would
    # desynchronize the streams).
    for f in ("occupied", "alive", "interacting", "pend_push", "at_event",
              "record_pending"):
        np.testing.assert_array_equal(
            np.asarray(getattr(p_off, f)), np.asarray(getattr(p_on, f)), f)

    occ = np.asarray(p_off.occupied)
    assert occ.any(), "test needs live lanes to be meaningful"

    def close(a, b, name, rtol=1e-9, atol=1e-300):
        np.testing.assert_allclose(
            np.asarray(a)[..., occ], np.asarray(b)[..., occ],
            rtol=rtol, atol=atol, err_msg=name)

    for m in range(4):
        close(p_off.x[m], p_on.x[m], f"x[{m}]")
        close(p_off.k[m], p_on.k[m], f"k[{m}]", rtol=1e-8)
    close(p_off.w, p_on.w, "w", rtol=1e-8)
    close(p_off.tau_abs, p_on.tau_abs, "tau_abs", rtol=1e-6, atol=1e-30)
    close(p_off.tau_scatt, p_on.tau_scatt, "tau_scatt", rtol=1e-6, atol=1e-30)
    np.testing.assert_array_equal(
        np.asarray(p_off.n_step), np.asarray(p_on.n_step), "n_step")

    # Spectrum accumulators agree (recorded lanes carried the same state).
    np.testing.assert_allclose(
        np.asarray(s_off.spec), np.asarray(s_on.spec), rtol=1e-8, atol=0,
        err_msg="spec")
