"""Transport engine tests: geodesic integrity, scattering kinematics,
end-to-end conservation, engine-vs-oracle statistical parity."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import random

from grmonty import consts
from grmonty.ops import emission, fluid, geometry, scattering, tetrads
from grmonty.transport import engine as engine_mod

# Heavy tier: multi-minute engine compiles / long transport runs on the
# single-core CI host (tests/conftest.py tiering).
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    from grmonty.models import torus
    from grmonty.transport import driver

    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    cfg = engine_mod.EngineConfig(
        n_pool=256, m_period=8, sec_cap=4096, max_outer=40000, stall_steps=40000
    )
    return driver.Simulation(
        str(path), photon_n=60, mass_unit=4.0e18, config=cfg, emit_chunk=2048,
        warmup=128,
    )


@pytest.fixture(scope="module")
def engine_run(sim):
    """One full driver run shared by the engine-level assertions."""
    spec, stats = sim.run()
    return spec, stats


def _null_residual(sim, x, k):
    g = geometry.gcov(x, sim.mc.a, sim.mc.h_slope, sim.mc.r_0)
    kk = jnp.einsum("...i,...ij,...j->...", k, g, k)
    return np.asarray(kk / (k[..., 0] ** 2 * jnp.abs(g[..., 0, 0]) + 1e-300))


def test_emitted_photons_are_null(sim):
    plan = sim.plan()
    batch = sim.emit(plan, 0, 1024)
    live = np.asarray(batch.w) > 0
    res = _null_residual(sim, batch.x, batch.k)[live]
    assert np.abs(res).max() < 1e-8


def test_push_preserves_nullness_and_energy(sim):
    """March emitted photons 400 steps with the engine's push; k.k stays on
    the light cone and the conserved energy drifts < tolerance."""
    plan = sim.plan()
    batch = sim.emit(plan, 0, 256)
    live = np.asarray(batch.w) > 0

    x, k = batch.x, batch.k
    conn = geometry.connection(x, sim.mc.a, sim.mc.h_slope)
    dk = geometry.geodesic_rhs(conn, k)
    e0s = batch.e
    push = sim.engine["push_batch"]
    active = jnp.asarray(live)

    @jax.jit
    def step(carry):
        x, k, dk, e0s, active = carry
        dl = geometry.step_size(x, k, sim.mc.x_stop[2])
        x, k, dk, e0s, _ = push(x, k, dk, e0s, dl, active)
        active = active & (x[:, 1] > sim.mc.x1_min) & (x[:, 1] < consts.X1_MAX)
        return x, k, dk, e0s, active

    carry = (x, k, dk, e0s, active)
    snap = carry
    for i in range(400):
        carry = step(carry)
        if i % 25 == 24:
            if int(np.asarray(carry[4]).sum()) < 16:
                break  # keep the last snapshot with a usable sample
            snap = carry
    x, k, dk, e0s, active = snap
    act = np.asarray(active)
    if act.sum() == 0:
        pytest.skip("all photons left the domain early")
    res = np.abs(_null_residual(sim, x, k)[act])
    # The implicit-midpoint scheme (reference tolerances: 2 fixed-point
    # iterations, e_tol 1e-3, energy drift 1e-4/step) random-walks the null
    # residual at ~1e-4/step; after 400 steps the survivors (a biased,
    # long-lived subset) sit at the 1e-3 level — same class as the reference.
    assert np.median(res) < 2e-2
    assert res.max() < 0.5
    # conserved energy tracks the initial energy-at-infinity
    e_drift = np.abs(np.asarray(e0s)[act] / np.asarray(batch.e)[act] - 1.0)
    assert np.median(e_drift) < 1e-2


def test_scatter_event_preserves_nullness(sim):
    """Secondary wave vectors from scatter_event are null."""
    plan = sim.plan()
    batch = sim.emit(plan, 0, 512)
    live = np.asarray(batch.w) > 0
    x = batch.x
    g_cov = geometry.gcov(x, sim.mc.a, sim.mc.h_slope, sim.mc.r_0)
    fs = fluid.get_fluid_params(x, g_cov, sim.prims, sim.mc)
    res = scattering.scatter_event(random.PRNGKey(0), batch.k, fs, g_cov, sim.mc.b_unit)
    made = np.asarray(res.made) & live & (np.asarray(fs.n_e) > 0)
    assert made.sum() > 50
    nres = _null_residual(sim, x, res.k_sec)[made]
    assert np.abs(nres).max() < 1e-6
    # scattered energies positive
    assert (np.asarray(res.e_sec)[made] > 0).all()


def test_scattered_energy_shift_direction(sim):
    """Hot electrons on soft photons: inverse-Compton up-scattering on
    average (mean secondary energy > mean parent energy)."""
    plan = sim.plan()
    batch = sim.emit(plan, 0, 1024)
    live = np.asarray(batch.w) > 0
    x = batch.x
    g_cov = geometry.gcov(x, sim.mc.a, sim.mc.h_slope, sim.mc.r_0)
    fs = fluid.get_fluid_params(x, g_cov, sim.prims, sim.mc)
    hot = np.asarray(fs.theta_e) > 3.0
    res = scattering.scatter_event(random.PRNGKey(1), batch.k, fs, g_cov, sim.mc.b_unit)
    sel = np.asarray(res.made) & live & hot & (np.asarray(fs.n_e) > 0)
    assert sel.sum() > 30
    ratio = np.asarray(res.e_sec)[sel] / np.asarray(batch.e)[sel]
    assert np.mean(np.log(ratio)) > 0.5  # strong mean amplification


def test_engine_end_to_end(sim, engine_run):
    """Full driver run: terminates, records, conserves photon accounting."""
    spec, stats = engine_run
    assert stats["n_recorded"] > 0
    nph = spec[: engine_mod.N_BINS, 2].sum()
    assert nph == stats["n_recorded"]  # every recorded photon binned once
    assert np.isfinite(spec[: engine_mod.N_BINS]).all()
    assert spec[: engine_mod.N_BINS, 1].sum() > 0  # positive luminosity


def test_engine_vs_oracle_statistics(sim, engine_run):
    """The batch engine agrees statistically with the scalar CPU oracle on
    per-primary recorded counts and luminosity."""
    from grmonty.transport import cpu_reference

    spec, stats = engine_run
    eng_rec = stats["n_recorded"] / stats["n_created"]
    eng_lum = spec[: engine_mod.N_BINS, 1].sum() / stats["n_created"]

    plan = sim.plan()
    # Apples-to-apples oracle sample (two r5 fixes — the old first-2048
    # slice compared a COLD-counter oracle on innermost-zone photons
    # against the warm-converged full-plan engine, and only passed while
    # the r4 warm-pilot counter inflation held eng_rec up):
    #  1. STRIDED photons (the driver pilot's zone mix), not the plan head
    #     whose inner-zone photons scatter far above the plan average;
    #  2. WARM-SEEDED bias counters: records-per-primary is bias-feedback
    #     dependent by design (harm_model.cpp:1391-1404 — cold counters
    #     run a Compton storm: measured 14.2 rec/primary cold vs 5.4 for
    #     the warm engine), so the oracle gets the same native-pilot
    #     warmup the engine got before measuring.
    from grmonty.transport.oracle_native import NativeTracker

    n_orc = 40
    warm_batch = sim._pilot_batch(plan, 128)
    nt = NativeTracker(sim.mc, sim.tables, np.asarray(sim.prims),
                       seed=sim.seed + 7)
    nt.run(warm_batch._replace(w=np.asarray(warm_batch.w, np.float64)),
           progress_every=0)
    batch = sim._pilot_batch(plan, n_orc)  # raw (unscaled) weights
    tr = cpu_reference.CPUTracker(sim.mc, sim.tables, sim.prims, seed=17)
    tr.n_recorded = nt.n_recorded
    tr.n_scatt_rec = nt.n_scatt_rec
    tr.max_tau_scatt = nt.max_tau_scatt
    tr.run(batch, limit=n_orc)
    orc_rec = (tr.n_recorded - nt.n_recorded) / n_orc
    orc_lum = tr.spec[:, :, 1].sum() / n_orc

    # Coarse statistical agreement (small samples, heavy-tailed weights,
    # different bias-feedback trajectories).
    assert eng_rec == pytest.approx(orc_rec, rel=0.6)
    assert math.log10(eng_lum) == pytest.approx(math.log10(orc_lum), abs=0.6)
