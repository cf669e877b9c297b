"""Native-oracle parity: the C++ mirror of the Python validation oracle.

Three layers, strongest first:

1. ``oracle_probe`` — every deterministic sub-function (metric, inverse
   metric, 40 Christoffels, bilinear fluid state, opacities, step size,
   implicit-midpoint segment incl. its error metrics, Gram-Schmidt tetrad,
   initial dk/dlambda) evaluated at emitted-photon states and compared
   against the exact JAX functions the Python oracle calls, ~1e-8 relative.
2. Sampler distributions — electron and Compton draws compared in moments
   against the Python transcriptions.
3. End-to-end — a shared emission sample tracked by both oracles; global
   observables agree within the MC spread of the scattering randomness.
"""

import math

import numpy as np
import pytest

from grmonty import consts
from grmonty.ops import fluid, geometry, radiation
from grmonty.transport import cpu_reference
from grmonty.transport.oracle_native import NativeTracker

# Heavy tier: multi-minute engine compiles / long transport runs on the
# single-core CI host (tests/conftest.py tiering).
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    from grmonty.models import torus
    from grmonty.transport import driver
    from grmonty.transport import engine as engine_mod

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
def batch(sim):
    """Emitted photons with the driver's weight scaling undone (the oracles
    track reference-scale weights, as validate_accuracy does)."""
    import jax

    plan = sim.plan()
    b = jax.device_get(sim.emit(plan, 0, 2048))
    w = np.asarray(b.w, np.float64) / sim.cfg.weight_scale
    live = np.asarray(b.w) > 0
    return b._replace(w=w), live


@pytest.fixture(scope="module")
def native(sim):
    return NativeTracker(sim.mc, sim.tables, np.asarray(sim.prims), seed=7)


@pytest.fixture(scope="module")
def pytracker(sim):
    return cpu_reference.CPUTracker(sim.mc, sim.tables, sim.prims, seed=11)


def _close(a, b, rtol, name, atol=0.0):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64),
        rtol=rtol, atol=atol, err_msg=name)


def test_probe_parity(sim, batch, native, pytracker):
    """Every deterministic sub-function matches the JAX path at ~1e-8."""
    import jax.numpy as jnp

    b, live = batch
    idx = np.nonzero(live)[0][:40]
    mc = sim.mc
    rng = np.random.default_rng(3)

    for n, i in enumerate(idx):
        x = np.asarray(b.x[i], np.float64).copy()
        k = np.asarray(b.k[i], np.float64).copy()
        if n % 2 == 1:
            # perturb off the zone center to exercise the bilinear stencil
            x[1] = float(np.clip(x[1] + (rng.uniform() - 0.5) * mc.dx[1],
                                 mc.x_start[1], mc.x_stop[1]))
            x[2] = float(np.clip(x[2] + (rng.uniform() - 0.5) * mc.dx[2],
                                 mc.x_start[2], mc.x_stop[2]))

        dk = np.asarray(pytracker._init_dk(jnp.asarray(x), jnp.asarray(k)))
        e0s = float(b.e[i])
        dl = float(geometry.step_size(jnp.asarray(x), jnp.asarray(k),
                                      mc.x_stop[2]))
        out = native.probe(x, k, dk, e0s, dl)

        g7 = [float(v) for v in geometry.gcov_c(x[1], x[2], mc.a, mc.h_slope, mc.r_0)]
        _close(out[0:7], g7, 1e-9, "gcov7")
        gc6 = [float(v) for v in geometry.gcon_c(x[1], x[2], mc.a, mc.h_slope, mc.r_0)]
        _close(out[7:13], gc6, 1e-9, "gcon6")
        c40 = [float(v) for v in geometry.connection_c(x[1], x[2], mc.a, mc.h_slope)]
        _close(out[13:53], c40, 1e-7, "connection", atol=1e-12)

        g_cov, fs = pytracker._fluid(jnp.asarray(x))
        _close(out[53], float(fs.n_e), 1e-9, "n_e")
        _close(out[54], float(fs.theta_e), 1e-9, "theta_e")
        _close(out[55], float(fs.b), 1e-9, "b")
        _close(out[56:60], np.asarray(fs.u_con), 1e-9, "u_con")
        _close(out[60:64], np.asarray(fs.u_cov), 1e-9, "u_cov")
        _close(out[64:68], np.asarray(fs.b_con), 1e-8, "b_con", atol=1e-18)
        _close(out[68:72], np.asarray(fs.b_cov), 1e-8, "b_cov", atol=1e-18)

        theta, nu, a_sc, a_ab = (float(v) for v in pytracker._alphas(jnp.asarray(k), fs))
        _close(out[72], theta, 1e-7, "theta")
        _close(out[73], nu, 1e-9, "nu")
        _close(out[74], a_sc, 1e-8, "a_sc", atol=1e-280)
        _close(out[75], a_ab, 1e-6, "a_ab", atol=1e-280)
        _close(out[76], dl, 1e-9, "step_size")

        xs, ks, dks, e1, err, err_e = pytracker._seg(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(dk), e0s, dl)
        _close(out[77:81], np.asarray(xs), 1e-9, "seg x")
        _close(out[81:85], np.asarray(ks), 1e-9, "seg k")
        _close(out[85:89], np.asarray(dks), 1e-8, "seg dk", atol=1e-14)
        _close(out[89], float(e1), 1e-9, "seg e1")
        _close(out[90], float(err), 1e-4, "seg err", atol=1e-10)
        _close(out[91], float(err_e), 1e-4, "seg err_e", atol=1e-10)

        # tetrad with the scatter trial rule (cpu_reference._scatter)
        b_gauss = float(fs.b)
        if b_gauss > 0.0:
            trial = np.asarray(fs.b_con) / (b_gauss / mc.b_unit)
        else:
            trial = np.array([0.0, 1.0, 0.0, 0.0])
        e_con, e_cov = pytracker._tetrad(
            jnp.asarray(fs.u_con), jnp.asarray(trial), g_cov)
        _close(out[92:108], np.asarray(e_con).reshape(-1), 1e-7, "e_con",
               atol=1e-12)
        _close(out[108:124], np.asarray(e_cov).reshape(-1), 1e-7, "e_cov",
               atol=1e-12)

        _close(out[124:128], dk, 1e-8, "init dkdlam", atol=1e-14)


def test_sampler_distributions(sim, native, pytracker):
    """Electron/Compton draws match the Python transcriptions in moments."""
    k_tet = np.array([1.1e-4, 0.8e-4, 0.5e-4, 0.4e-4])
    k_tet[0] = math.sqrt(np.sum(k_tet[1:] ** 2))

    for theta_e in (0.6, 5.0):
        n = 400
        pc = native.sample_electron(k_tet, theta_e, n, seed=5)
        pp = np.stack([pytracker._sample_electron(k_tet, theta_e)
                       for _ in range(n)])
        # gamma_e = p[0]; MJ mean scales with theta_e
        se = pc[:, 0].std() / math.sqrt(n) + pp[:, 0].std() / math.sqrt(n)
        assert abs(pc[:, 0].mean() - pp[:, 0].mean()) < 5.0 * se, (
            theta_e, pc[:, 0].mean(), pp[:, 0].mean())
        # spatial isotropy scale: |p| moments
        nc = np.linalg.norm(pc[:, 1:], axis=1)
        npy = np.linalg.norm(pp[:, 1:], axis=1)
        sn = nc.std() / math.sqrt(n) + npy.std() / math.sqrt(n)
        assert abs(nc.mean() - npy.mean()) < 5.0 * sn

    p = np.array([1.25, 0.5, 0.3, 0.2])
    n = 400
    kc = native.sample_scattered(k_tet, p, n, seed=9)
    kp = np.stack([pytracker._sample_scattered(k_tet, p) for _ in range(n)])
    s0 = kc[:, 0].std() / math.sqrt(n) + kp[:, 0].std() / math.sqrt(n)
    assert abs(kc[:, 0].mean() - kp[:, 0].mean()) < 5.0 * s0


@pytest.mark.slow
def test_end_to_end_vs_python_oracle(sim, batch, native, pytracker):
    """Both oracles track the same photons; observables agree within the
    spread of the scattering/roulette randomness (trajectories and
    deterministic weight decay are identical by the probe test)."""
    b, live = batch
    n = 15

    spec_p = pytracker.run(b, limit=n).copy()
    rec_p, scat_p = pytracker.n_recorded, pytracker.n_scatt_rec

    spec_c = native.run(b, limit=n, progress_every=0).copy()
    rec_c, scat_c = native.n_recorded, native.n_scatt_rec

    assert rec_c > 0 and rec_p > 0
    # The recorded count of a biased-scattering cascade has huge per-seed
    # variance at 15 primaries (measured native spread over 12 seeds:
    # 198..429, a 2.2x min-to-max ratio).  Gate the Python oracle against
    # the native oracle's *measured* seed distribution rather than a fixed
    # ratio: the native tracker costs milliseconds per seed.
    recs, lums = [rec_c], [spec_c[:, :, 1].sum()]
    for seed in range(8):
        nt = NativeTracker(sim.mc, sim.tables, np.asarray(sim.prims),
                           seed=100 + seed)
        s = nt.run(b, limit=n, progress_every=0)
        recs.append(nt.n_recorded)
        lums.append(s[:, :, 1].sum())
    rec_mu, rec_sd = np.mean(recs), np.std(recs) + 1.0
    lum_mu, lum_sd = np.mean(lums), np.std(lums) + 1e-300
    assert abs(rec_p - rec_mu) < 4.0 * rec_sd, (rec_p, recs)
    lum_p = spec_p[:, :, 1].sum()
    assert abs(lum_p - lum_mu) < 5.0 * lum_sd, (lum_p, lums)

    # the native oracle at 30x the sample in (milli)seconds: stays finite,
    # records proportionally
    big = NativeTracker(sim.mc, sim.tables, np.asarray(sim.prims), seed=13)
    nb = min(450, int(np.sum(b.w > 0)))
    spec_big = big.run(b, limit=nb, progress_every=0)
    assert np.isfinite(spec_big).all()
    assert big.n_recorded > rec_c
