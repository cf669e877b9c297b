"""Physics-table tests: hotcross, synchrotron emissivity, opacities."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import scipy.special

from grmonty import consts
from grmonty.ops import hotcross, jnu, radiation


class TestHotcross:
    def test_thomson_limit(self, hotcross_table):
        # w * theta_e < 1e-6 -> exactly Thomson (hotcross.cpp:82-84)
        t = jnp.asarray(hotcross_table)
        val = float(hotcross.lookup(jnp.array(1e-8), jnp.array(1e-2), t))
        assert val == pytest.approx(consts.SIGMA_THOMSON)

    def test_cold_klein_nishina(self, hotcross_table):
        # theta_e below table -> KN(w) * sigma_T (hotcross.cpp:86-88)
        t = jnp.asarray(hotcross_table)
        w = 0.5
        val = float(hotcross.lookup(jnp.array(w), jnp.array(1e-5), t))
        kn = float(hotcross._hc_klein_nishina(jnp.array(w)))
        assert val == pytest.approx(kn * consts.SIGMA_THOMSON, rel=1e-10)

    def test_interpolation_matches_numeric(self, hotcross_table):
        # table lookup ~ direct numeric integral at off-grid points
        t = jnp.asarray(hotcross_table)
        rng = np.random.default_rng(5)
        for _ in range(5):
            w = 10 ** rng.uniform(-3, 2)
            theta_e = 10 ** rng.uniform(-1, 2)
            got = float(hotcross.lookup(jnp.array(w), jnp.array(theta_e), t))
            ref = float(hotcross.total_compton_cross_num(w, theta_e)[0])
            assert got == pytest.approx(ref, rel=0.02)

    def test_kn_total_series_continuity(self):
        lo = float(hotcross._hc_klein_nishina(jnp.array(0.99e-3)))
        hi = float(hotcross._hc_klein_nishina(jnp.array(1.01e-3)))
        assert lo == pytest.approx(hi, rel=1e-3)

    def test_hot_cross_exceeds_kn_suppression(self, hotcross_table):
        # hot electrons see boosted photons -> more KN suppression than cold
        t = jnp.asarray(hotcross_table)
        cold = float(hotcross.lookup(jnp.array(1e-4), jnp.array(1e-5), t))
        hot = float(hotcross.lookup(jnp.array(1e-4), jnp.array(100.0), t))
        assert hot < cold


class TestJnu:
    def test_k2_matches_scipy(self, jnu_tables):
        _, k2_t = jnu_tables
        k2_t = jnp.asarray(k2_t)
        for theta_e in (0.5, 1.0, 5.0, 50.0):
            got = float(jnu.k2_eval(jnp.array(theta_e), k2_t))
            ref = scipy.special.kv(2, 1.0 / theta_e)
            assert got == pytest.approx(ref, rel=1e-3)

    def test_k2_asymptote(self, jnu_tables):
        _, k2_t = jnu_tables
        got = float(jnu.k2_eval(jnp.array(500.0), jnp.asarray(k2_t)))
        assert got == pytest.approx(2 * 500.0**2, rel=1e-2)

    def test_k2_below_min_is_zero(self, jnu_tables):
        _, k2_t = jnu_tables
        assert float(jnu.k2_eval(jnp.array(0.1), jnp.asarray(k2_t))) == 0.0

    def test_f_eval_matches_direct_integral(self, jnu_tables):
        f_t, _ = jnu_tables
        f_t = jnp.asarray(f_t)
        # F(k) = 4 pi Int_0^{pi/2} sin^2 th (sqrt(x)+cst x^(1/6))^2 e^{-x^(1/3)} dth
        for k in (0.01, 1.0, 100.0):
            def integrand(th):
                x = k / math.sin(th)
                return (
                    math.sin(th) ** 2
                    * (math.sqrt(x) + consts.jnu.CST * x ** (1 / 6)) ** 2
                    * math.exp(-(x ** (1 / 3)))
                )
            ref, _ = scipy.integrate.quad(integrand, 1e-8, math.pi / 2)
            ref *= 4 * math.pi
            theta_e, b = 10.0, 100.0
            nu = k * b * theta_e**2 / consts.jnu.K_FAC
            got = float(jnu.f_eval(jnp.array(theta_e), jnp.array(b), jnp.array(nu), f_t))
            assert got == pytest.approx(ref, rel=2e-3)

    def test_f_eval_small_k_series(self, jnu_tables):
        f_t, _ = jnu_tables
        # below MIN_K the closed-form small-argument series is used
        theta_e, b = 10.0, 10.0
        nu = 1e-4 * b * theta_e**2 / consts.jnu.K_FAC
        got = float(jnu.f_eval(jnp.array(theta_e), jnp.array(b), jnp.array(nu), jnp.asarray(f_t)))
        x = 1e-4 ** (1 / 3)
        assert got == pytest.approx(x * (37.67503800178 + 2.240274341836 * x), rel=1e-9)

    def test_synch_cutoffs(self, jnu_tables):
        f_t, k2_t = jnu_tables
        k2_t = jnp.asarray(k2_t)
        # cold plasma emits nothing
        assert float(jnu.synch(jnp.array(1e12), jnp.array(1e6), jnp.array(0.1),
                               jnp.array(10.0), jnp.array(1.0), k2_t)) == 0.0
        # far above the synchrotron peak: exponential cutoff to zero
        assert float(jnu.synch(jnp.array(1e30), jnp.array(1e6), jnp.array(10.0),
                               jnp.array(10.0), jnp.array(1.0), k2_t)) == 0.0
        # normal conditions: positive
        assert float(jnu.synch(jnp.array(1e11), jnp.array(1e6), jnp.array(10.0),
                               jnp.array(10.0), jnp.array(1.0), k2_t)) > 0.0


class TestRadiation:
    def test_b_nu_inv_is_planck(self):
        # b_nu_inv = B_nu / nu^3 with T = theta_e m_e c^2 / k
        # (the reference's frequency-invariant form, radiation.cpp:121-129)
        nu, theta_e = 1e12, 5.0
        got = float(radiation.b_nu_inv(jnp.array(nu), jnp.array(theta_e)))
        T = theta_e * consts.ME * consts.CL**2 / consts.KBOL
        x = consts.HPL * nu / (consts.KBOL * T)
        b_nu = 2 * consts.HPL * nu**3 / consts.CL**2 / math.expm1(x)
        assert got == pytest.approx(b_nu / nu**3, rel=1e-10)

    def test_b_nu_inv_series_continuity(self):
        theta_e = 10.0
        nu_edge = 1.0e-3 * theta_e * consts.ME * consts.CL**2 / consts.HPL
        lo = float(radiation.b_nu_inv(jnp.array(nu_edge * 0.99), jnp.array(theta_e)))
        hi = float(radiation.b_nu_inv(jnp.array(nu_edge * 1.01), jnp.array(theta_e)))
        assert lo == pytest.approx(hi, rel=1e-3)

    def test_alpha_scatt_thomson_limit(self, hotcross_table):
        # low-energy photons on cool electrons: alpha = nu sigma_T n_e
        nu, theta_e, n_e = 1e9, 1e-3, 1e7
        got = float(radiation.alpha_inv_scatt(
            jnp.array(nu), jnp.array(theta_e), jnp.array(n_e), jnp.asarray(hotcross_table)
        ))
        assert got == pytest.approx(nu * consts.SIGMA_THOMSON * n_e, rel=1e-6)

    def test_kirchhoff_consistency(self, jnu_tables):
        # alpha_inv_abs * B_nu_inv == j_nu_inv by construction
        f_t, k2_t = jnu_tables
        nu, theta_e, n_e, b, th = 2e11, 8.0, 1e7, 30.0, 1.0
        alpha = float(radiation.alpha_inv_abs(
            jnp.array(nu), jnp.array(theta_e), jnp.array(n_e), jnp.array(b),
            jnp.array(th), jnp.asarray(k2_t)
        ))
        j_inv = float(jnu.synch(jnp.array(nu), jnp.array(n_e), jnp.array(theta_e),
                                jnp.array(b), jnp.array(th), jnp.asarray(k2_t))) / nu**2
        b_inv = float(radiation.b_nu_inv(jnp.array(nu), jnp.array(theta_e)))
        assert alpha == pytest.approx(j_inv / b_inv, rel=1e-10)

    def test_bk_angle_range_and_unmagnetized(self):
        k = jnp.array([[1.0, 0.5, 0.1, 0.2]])
        u_cov = jnp.array([[-1.0, 0.0, 0.0, 0.0]])
        b_cov = jnp.array([[0.0, 1.0, 0.0, 0.0]])
        th = float(radiation.bk_angle(k, u_cov, b_cov, jnp.array([2.0]), 1.0)[0])
        assert 0.0 <= th <= math.pi
        th0 = float(radiation.bk_angle(k, u_cov, b_cov, jnp.array([0.0]), 1.0)[0])
        assert th0 == pytest.approx(math.pi / 2)


class TestGoldenPins:
    """Bit-stability pins for the built tables.

    The values are frozen from a build whose accuracy is independently
    verified above (k2 vs scipy.special.kv, f vs the direct GK integral,
    hotcross vs the numeric double integral); the pins catch silent
    rebuild drift — e.g. a quadrature or grid change — at 1e-12.
    Reference tables: jnu_mixed.cpp:57-73, hotcross.cpp:60-79.
    """

    def test_f_table_golden(self, jnu_tables):
        f_t = np.asarray(jnu_tables[0])
        assert f_t.shape == (201,)
        got = f_t[[0, 50, 100, 150, 200]]
        want = [1.5605272828913115, 3.3038574227620114, 2.481547901571418,
                -21.38150912697371, -198.70020106804728]
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_k2_table_golden(self, jnu_tables):
        k2_t = np.asarray(jnu_tables[1])
        assert k2_t.shape == (201,)
        got = k2_t[[0, 50, 100, 150, 200]]
        want = [-3.2210660818603043, 1.0571406359174718, 4.086156654955269,
                6.998460355500046, 9.90346255564318]
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_hotcross_table_golden(self, hotcross_table):
        h = np.asarray(hotcross_table)
        assert h.shape == (221, 81)
        got = [h[0, 0], h[55, 20], h[110, 40], h[165, 60], h[220, 80]]
        want = [-24.17661838387355, -24.168604894687906, -24.180789228680627,
                -27.432351050056166, -33.5176335039284]
        np.testing.assert_allclose(got, want, rtol=1e-12)
