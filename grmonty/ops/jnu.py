"""Thermal synchrotron emissivity: tables and evaluators.

Equivalent of ``cuda_grmonty/jnu_mixed.cpp:57-168``.

Two init-time tables (built host-side with numpy/scipy, used on device via
log-linear interpolation):

* ``f_table[i] = ln( 4 pi * Int_0^{pi/2} sin^2(th) (sqrt(x) + 2^{11/12} x^{1/6})^2
  exp(-x^{1/3}) dth )`` with x = k / sin(th), over 201 log-spaced k
  (the angle-integrated fitting function of Leung, Gammie & Noble 2011).
* ``k2_table[i] = ln K_2(1/theta_e)`` over 201 log-spaced theta_e.

``synch`` is the angle-dependent emissivity j_nu used for emission sampling
and (via Kirchhoff) absorption.
"""

import math

import jax.numpy as jnp
import numpy as np
import scipy.special

from grmonty import consts
from grmonty.ops.integration import adaptive_gauss_quad

PI = math.pi


def _jnu_integrand(th, k):
    """Pitch-angle integrand (jnu_mixed.cpp:127-137), numpy-vectorized."""
    sin_th = np.sin(th)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        x = k / sin_th
        val = (
            sin_th
            * sin_th
            * (np.sqrt(x) + consts.jnu.CST * x ** (1.0 / 6.0)) ** 2
            * np.exp(-(x ** (1.0 / 3.0)))
        )
    return np.where((sin_th < 1.0e-150) | (x > 2.0e8), 0.0, val)


def build_tables():
    """Build (f_table, k2_table), each shape (N_E_SAMP + 1,), float64."""
    n = consts.N_E_SAMP
    f_table = np.empty(n + 1)
    for i in range(n + 1):
        k = math.exp(i * consts.jnu.D_L_K + consts.jnu.L_MIN_K)
        integral = adaptive_gauss_quad(
            lambda th: _jnu_integrand(th, k),
            0.0,
            PI / 2.0,
            eps_abs=consts.jnu.EPS_ABS,
            eps_rel=consts.jnu.EPS_REL,
            limit=1000,
        )
        f_table[i] = math.log(4.0 * PI * integral)

    t = np.exp(np.arange(n + 1) * consts.jnu.D_L_T + consts.jnu.L_MIN_T)
    k2_table = np.log(scipy.special.kv(2, 1.0 / t))
    return f_table, k2_table


# ---------------------------------------------------------------------------
# Device-side evaluators (jnp, batched)
# ---------------------------------------------------------------------------

def _interp_log(l_v, l_min, d_l, table):
    """Linear interpolation of ln-valued ``table`` on a log-spaced axis."""
    d_i = (l_v - l_min) / d_l
    i = jnp.clip(jnp.floor(d_i).astype(jnp.int32), 0, table.shape[0] - 2)
    frac = d_i - i
    return jnp.exp((1.0 - frac) * table[i] + frac * table[i + 1])


def k2_eval(theta_e, k2_table):
    """K_2(1/theta_e) with asymptote above the table (jnu_mixed.cpp:102-111)."""
    interp = _interp_log(jnp.log(jnp.maximum(theta_e, consts.jnu.MIN_T)),
                         consts.jnu.L_MIN_T, consts.jnu.D_L_T, k2_table)
    out = jnp.where(theta_e > consts.jnu.MAX_T, 2.0 * theta_e * theta_e, interp)
    return jnp.where(theta_e < consts.THETA_E_MIN, 0.0, out)


def f_eval(theta_e, b_mag, nu, f_table):
    """Angle-integrated emissivity shape F(k) (jnu_mixed.cpp:113-125)."""
    k = consts.jnu.K_FAC * nu / (b_mag * theta_e * theta_e + consts.EPS)
    small = jnp.cbrt(jnp.maximum(k, consts.EPS))
    small_val = small * (37.67503800178 + 2.240274341836 * small)
    interp = _interp_log(jnp.log(jnp.maximum(k, consts.jnu.MIN_K)),
                         consts.jnu.L_MIN_K, consts.jnu.D_L_K, f_table)
    out = jnp.where(k < consts.jnu.MIN_K, small_val, interp)
    return jnp.where(k > consts.jnu.MAX_K, 0.0, out)


def ln_f_eval(theta_e, b_mag, nu, f_table):
    """ln F(k) — :func:`f_eval` without leaving log space.

    Rationale: F spans ~1e-70..1e2 on the emission rejection path, far
    outside the f32 exponent range of the float32 device sampler; the
    emission sampler therefore runs its
    accept tests on ln F (see emission.sample_photons).  Out-of-table
    k > MAX_K returns -inf (certain reject), matching f_eval's 0.
    """
    k = consts.jnu.K_FAC * nu / (b_mag * theta_e * theta_e + consts.EPS)
    small = jnp.cbrt(jnp.maximum(k, consts.EPS))
    ln_small = jnp.log(small * (37.67503800178 + 2.240274341836 * small))
    d_i = (jnp.log(jnp.maximum(k, consts.jnu.MIN_K)) - consts.jnu.L_MIN_K) / consts.jnu.D_L_K
    i = jnp.clip(jnp.floor(d_i).astype(jnp.int32), 0, f_table.shape[0] - 2)
    frac = d_i - i
    interp = (1.0 - frac) * f_table[i] + frac * f_table[i + 1]
    out = jnp.where(k < consts.jnu.MIN_K, ln_small, interp)
    return jnp.where(k > consts.jnu.MAX_K, -jnp.inf, out)


def ln_synch_ratio(nu, theta_e, b, sin_th):
    """ln[ j(theta) / j(pi/2) ] of the thermal synchrotron emissivity.

    The n_e, K2 and constant prefactors of j (jnu_mixed.cpp:75-100) cancel
    in the ratio, leaving sin(theta) * f(x_th)/f(x_90) * exp(x90^{1/3} -
    x_th^{1/3}) — every factor f32-safe, so the emission direction
    rejection needs neither the K2 table nor huge-range arithmetic.
    Returns -inf where the reference emissivity is zero at theta (the
    nu > 1e12 nu_s cutoff); the caller handles the j(pi/2) = 0 case.
    """
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    nu_s90 = (2.0 / 9.0) * nu_c * theta_e * theta_e
    x90 = nu / (nu_s90 + consts.EPS)
    x_th = nu / (nu_s90 * sin_th + consts.EPS)

    def ln_f(x):
        xp6 = jnp.power(jnp.maximum(x, 1e-30), 1.0 / 6.0)
        xx = xp6 * xp6 * xp6 + consts.jnu.CST * xp6
        return 2.0 * jnp.log(xx)

    out = (
        jnp.log(jnp.maximum(sin_th, 1e-30))
        + ln_f(x_th) - ln_f(x90)
        + jnp.cbrt(x90) - jnp.cbrt(x_th)
    )
    return jnp.where(nu > 1.0e12 * nu_s90 * sin_th, -jnp.inf, out)


def synch_c(nu, n_e, theta_e, b, theta, k2_coeffs):
    """:func:`synch` with the Chebyshev K2 surrogate (transport hot path)."""
    from grmonty.ops import cheb

    return _synch_from_k2(nu, n_e, theta_e, b, theta,
                          cheb.k2_eval(theta_e, k2_coeffs))


def synch_sin_c(nu, n_e, theta_e, b, sin_th, k2_coeffs):
    """:func:`synch_c` taking sin(theta) directly (no arccos/sin pair;
    see radiation.kinematics_sin_c)."""
    from grmonty.ops import cheb

    return _synch_from_sin(nu, n_e, theta_e, b, sin_th,
                           cheb.k2_eval(theta_e, k2_coeffs))


def synch(nu, n_e, theta_e, b, theta, k2_table):
    """Angle-dependent thermal synchrotron emissivity j_nu (jnu_mixed.cpp:75-100).

    Zero below THETA_E_MIN and beyond nu > 1e12 nu_s (exponential cutoff).
    """
    return _synch_from_k2(nu, n_e, theta_e, b, theta, k2_eval(theta_e, k2_table))


def _synch_from_k2(nu, n_e, theta_e, b, theta, k2):
    return _synch_from_sin(nu, n_e, theta_e, b, jnp.sin(theta), k2)


def _cbrt_pos(x):
    """cbrt for x >= 0 as exp(log(x)/3) — identical math on a positive
    domain, but lowers through ops Mosaic implements (the fused Pallas
    hot-step kernel evaluates the synchrotron emissivity in-kernel and
    Mosaic has no cbrt primitive)."""
    return jnp.exp(jnp.log(jnp.maximum(x, 1e-37)) * (1.0 / 3.0))


def _synch_from_sin(nu, n_e, theta_e, b, sin_th, k2):
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    nu_s = (2.0 / 9.0) * nu_c * theta_e * theta_e * sin_th

    x = nu / (nu_s + consts.EPS)
    xp = _cbrt_pos(x)
    xx = jnp.sqrt(x) + consts.jnu.CST * jnp.sqrt(xp)
    f = xx * xx
    val = (
        (math.sqrt(2.0) * PI * consts.EE * consts.EE / (3.0 * consts.CL))
        * n_e
        * nu_s
        / (k2 + consts.EPS)
        * f
        * jnp.exp(-xp)
    )
    bad = (theta_e < consts.THETA_E_MIN) | (nu > 1.0e12 * nu_s) | (k2 <= 0.0)
    return jnp.where(bad, 0.0, val)
