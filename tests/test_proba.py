"""Distribution tests for the Monte Carlo samplers.

The reference has no sampler tests (and even doubts its own chi^2 device
path at proba.cuh:229); these validate ours against analytic moments.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import scipy.special
from jax import random

from grmonty.ops import proba


def test_maxwell_juettner_mean_gamma():
    """<gamma> of sample_beta_distr matches the MJ expectation K-function ratio."""
    for theta_e in (0.5, 2.0, 10.0):
        key = random.PRNGKey(42)
        n = 40000
        gamma, beta = proba.sample_beta_distr(key, jnp.full((n,), theta_e))
        got = float(jnp.mean(gamma))
        # <gamma> = K1/K2 + 3 theta  (Maxwell-Juettner)
        ref = scipy.special.kv(1, 1 / theta_e) / scipy.special.kv(2, 1 / theta_e) + 3 * theta_e
        assert got == pytest.approx(ref, rel=0.02)


def test_mu_distr_cdf():
    """sample_mu_distr has pdf ~ (1 - beta mu)/2 (relative flux weighting)."""
    beta = 0.6
    key = random.PRNGKey(1)
    n = 100000
    mu = np.asarray(proba.sample_mu_distr(key, jnp.full((n,), beta)))
    assert (mu >= -1 - 1e-9).all() and (mu <= 1 + 1e-9).all()
    # analytic mean of mu under pdf (1 - beta mu)/2 on [-1, 1]: -beta/3
    assert np.mean(mu) == pytest.approx(-beta / 3, abs=0.01)


def test_thomson_moments():
    """Thomson phase function 3/8 (1 + mu^2): <mu>=0, <mu^2>=3/5... no: 2/5."""
    key = random.PRNGKey(3)
    c = np.asarray(proba.sample_thomson(key, (100000,), jnp.float64))
    # normalized pdf p(mu) = 3/8 (1+mu^2) on [-1,1]: <mu>=0, <mu^2> = 2/5
    assert np.mean(c) == pytest.approx(0.0, abs=0.01)
    assert np.mean(c**2) == pytest.approx(0.4, abs=0.01)


def test_klein_nishina_sampling():
    """Energies fall in [k0/(1+2k0), k0]; mean matches numeric expectation."""
    k0 = 2.0
    key = random.PRNGKey(7)
    n = 60000
    k0p = np.asarray(proba.sample_klein_nishina(key, jnp.full((n,), k0)))
    assert (k0p >= k0 / (1 + 2 * k0) - 1e-9).all() and (k0p <= k0 + 1e-9).all()

    def kn(ap):
        ch = 1.0 + 1.0 / k0 - 1.0 / ap
        return (k0 / ap + ap / k0 - 1.0 + ch * ch) / (k0 * k0)

    lo, hi = k0 / (1 + 2 * k0), k0
    norm, _ = scipy.integrate.quad(kn, lo, hi)
    mean_ref, _ = scipy.integrate.quad(lambda ap: ap * kn(ap) / norm, lo, hi)
    assert np.mean(k0p) == pytest.approx(mean_ref, rel=0.01)


def test_rand_dir_isotropy():
    key = random.PRNGKey(11)
    x, y, z = proba.sample_rand_dir(key, (50000,), jnp.float64)
    v = np.stack([np.asarray(x), np.asarray(y), np.asarray(z)], -1)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-12)
    assert np.abs(v.mean(0)).max() < 0.02


def test_electron_sampling_low_energy_photon():
    """For k0 -> 0 the KN weighting is ~1 and <gamma> is the MJ mean."""
    theta_e = 1.0
    key = random.PRNGKey(5)
    n = 30000
    k = jnp.tile(jnp.array([1e-8, 1e-8, 0.0, 0.0]), (n, 1))
    p = np.asarray(proba.sample_electron_distr_p(key, k, jnp.full((n,), theta_e)))
    gamma = p[:, 0]
    ref = scipy.special.kv(1, 1 / theta_e) / scipy.special.kv(2, 1 / theta_e) + 3 * theta_e
    assert np.mean(gamma) == pytest.approx(ref, rel=0.03)
    # p is a valid 4-momentum: p0^2 - |p|^2 = 1
    norm = gamma**2 - (p[:, 1:] ** 2).sum(-1)
    np.testing.assert_allclose(norm, 1.0, rtol=1e-9)


def test_electron_sampling_kn_suppresses_hot_electrons():
    """For energetic photons, high-gamma electrons are KN-suppressed."""
    theta_e = 5.0
    n = 20000
    k_soft = jnp.tile(jnp.array([1e-8, 1e-8, 0.0, 0.0]), (n, 1))
    k_hard = jnp.tile(jnp.array([1.0, 1.0, 0.0, 0.0]), (n, 1))
    g_soft = float(jnp.mean(
        proba.sample_electron_distr_p(random.PRNGKey(8), k_soft, jnp.full((n,), theta_e))[:, 0]
    ))
    g_hard = float(jnp.mean(
        proba.sample_electron_distr_p(random.PRNGKey(9), k_hard, jnp.full((n,), theta_e))[:, 0]
    ))
    assert g_hard < g_soft


def test_flat_electron_sampler_matches_nested():
    """The flat joint-acceptance sampler (sample_electron_distr_p_c, used by
    the engine's deferring event phase) draws from the same distribution as
    the nested reference-shaped rejection (sample_electron_distr_p):
    proposal x P_MJ x P_KN == {y ~ MJ via inner loop} x P_KN."""
    n = 120_000
    for theta_e, k0 in [(0.5, 1e-3), (5.0, 1e-2), (20.0, 0.5)]:
        th = jnp.full((n,), theta_e)
        k = jnp.zeros((n, 4)).at[:, 0].set(k0).at[:, 1].set(k0)
        p_ref = np.asarray(
            proba.sample_electron_distr_p(random.PRNGKey(21), k, th))
        kc = (k[:, 0], k[:, 1], k[:, 2], k[:, 3])
        (g, px, py, pz), ok = proba.sample_electron_distr_p_c(
            random.PRNGKey(22), kc, th, cap=256)
        g = np.asarray(g)
        ok = np.asarray(ok)
        gr = p_ref[:, 0]
        assert ok.mean() > 0.999
        assert np.mean(g[ok]) == pytest.approx(np.mean(gr), rel=0.02)
        assert np.std(g[ok]) == pytest.approx(np.std(gr), rel=0.03)
        # pitch-angle cosine relative to the photon axis (x)
        ps = np.stack([np.asarray(px), np.asarray(py), np.asarray(pz)], -1)
        mu_new = ps[:, 0] / np.linalg.norm(ps, axis=-1)
        pr = p_ref[:, 1:4]
        mu_ref = pr[:, 0] / np.linalg.norm(pr, axis=-1)
        assert np.mean(mu_new[ok]) == pytest.approx(np.mean(mu_ref), abs=0.01)


def test_capped_kn_sampler_matches_uncapped():
    """sample_klein_nishina_c at a generous cap reproduces the uncapped
    KN energy distribution and reports near-full acceptance."""
    n = 120_000
    for k0v in (0.1, 1.0, 10.0):
        k0 = jnp.full((n,), k0v)
        ref = np.asarray(proba.sample_klein_nishina(random.PRNGKey(31), k0))
        new, ok = proba.sample_klein_nishina_c(random.PRNGKey(32), k0, cap=256)
        new = np.asarray(new)
        ok = np.asarray(ok)
        assert ok.mean() > 0.999
        assert np.mean(new[ok]) == pytest.approx(np.mean(ref), rel=0.02)
        assert np.quantile(new[ok], 0.9) == pytest.approx(
            np.quantile(ref, 0.9), rel=0.03)
