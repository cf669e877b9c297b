"""Frequency-invariant opacities and photon-fluid kinematics.

Equivalent of ``cuda_grmonty/radiation.cpp:59-146``.  All functions are pure
jnp and batched; tables come in as arrays.
"""

import math

import jax.numpy as jnp

from grmonty import consts
from grmonty.ops import hotcross, jnu

PI = math.pi


def bk_angle(k, u_cov, b_cov, b, b_unit):
    """Pitch angle between photon k and magnetic field (radiation.cpp:59-87).

    Returns pi/2 where b == 0.
    """
    k_u = jnp.abs(jnp.sum(k * u_cov, axis=-1))
    k_b = jnp.sum(k * b_cov, axis=-1)
    mu = k_b / (k_u * b / b_unit + consts.EPS)
    mu = jnp.clip(mu, -1.0, 1.0)
    return jnp.where(b == 0.0, PI / 2.0, jnp.arccos(mu))


def fluid_nu(k, u_cov):
    """Fluid-frame photon frequency [Hz] (radiation.cpp:89-101)."""
    energy = -jnp.sum(k * u_cov, axis=-1)
    return energy * consts.ME * consts.CL * consts.CL / consts.HPL


def alpha_inv_scatt(nu, theta_e, n_e, hotcross_table):
    """Invariant scattering opacity nu * sigma_hot * n_e (radiation.cpp:103-107).

    The reference routes through kappa_es = sigma/m_p and multiplies m_p
    back; the proton mass cancels and we fold it out.
    """
    e_g = consts.HPL * nu / (consts.ME * consts.CL * consts.CL)
    sigma = hotcross.lookup(e_g, theta_e, hotcross_table)
    return nu * sigma * n_e


def b_nu(nu, theta_e):
    """Planck function B_nu with the reference's small-x series
    (radiation.cpp:121-129 computes B_nu/nu^2; we keep B_nu itself because
    the 2h/c^2 ~ 1.5e-47 prefactor of B_nu/nu^2 underflows the float32
    engine's exponent range — the nu^2 factors cancel in Kirchhoff's law
    anyway)."""
    x = consts.HPL * nu / (consts.ME * consts.CL * consts.CL * theta_e + consts.EPS)
    # Factor so every intermediate stays inside the f32 exponent range of
    # the float32 engine (2h/c^2 alone is 1.47e-47 -> flushes to 0).
    pref = (2.0 * consts.HPL * nu) * (nu / consts.CL) * (nu / consts.CL)
    series = pref / (x / 24.0 * (24.0 + x * (12.0 + x * (4.0 + x))) + consts.EPS)
    # exp(x)-1 instead of expm1: the x < 1e-3 branch below uses the series
    # anyway, so expm1's small-x accuracy is never needed.
    full = pref / (jnp.exp(jnp.minimum(x, 80.0)) - 1.0 + consts.EPS)
    return jnp.where(x < 1.0e-3, series, full)


def b_nu_inv(nu, theta_e):
    """B_nu / nu^3 (the reference's invariant form; CPU/test use only)."""
    return b_nu(nu, theta_e) / (nu * nu * nu)


def alpha_inv_abs(nu, theta_e, n_e, b, theta, k2_table):
    """Invariant absorption opacity via Kirchhoff's law (radiation.cpp:109-119).

    alpha_inv = (j_nu/nu^2) / (B_nu/nu^3) = nu * j_nu / B_nu — evaluated
    without the underflowing small intermediates (2h/c^2 ~ 1.5e-47 is below
    float32's exponent range).
    """
    j = jnu.synch(nu, n_e, theta_e, b, theta, k2_table)
    return nu * j / (b_nu(nu, theta_e) + consts.EPS)


# ---------------------------------------------------------------------------
# component layer (transport hot path; see geometry module docstring)
# ---------------------------------------------------------------------------

def kinematics_c(k, u_cov, b_cov, b, b_unit):
    """Shared photon-fluid kinematics: (bk_angle, fluid_nu) from component
    tuples, computing k.u_cov once (radiation.cpp:59-101)."""
    k_u = k[0] * u_cov[0] + k[1] * u_cov[1] + k[2] * u_cov[2] + k[3] * u_cov[3]
    k_b = k[0] * b_cov[0] + k[1] * b_cov[1] + k[2] * b_cov[2] + k[3] * b_cov[3]
    mu = k_b / (jnp.abs(k_u) * b / b_unit + consts.EPS)
    theta = jnp.where(b == 0.0, PI / 2.0, jnp.arccos(jnp.clip(mu, -1.0, 1.0)))
    nu = -k_u * consts.ME * consts.CL * consts.CL / consts.HPL
    return theta, nu


def kinematics_sin_c(k, u_cov, b_cov, b, b_unit):
    """:func:`kinematics_c` returning (sin(bk_angle), nu) instead of the
    angle itself: the only consumer of the angle in the hot path is the
    synchrotron emissivity, which needs sin(theta) — computing
    sqrt(1 - mu^2) directly avoids an arccos+sin transcendental pair
    (and keeps the fused Pallas hot-step kernel within Mosaic's op set)."""
    k_u = k[0] * u_cov[0] + k[1] * u_cov[1] + k[2] * u_cov[2] + k[3] * u_cov[3]
    k_b = k[0] * b_cov[0] + k[1] * b_cov[1] + k[2] * b_cov[2] + k[3] * b_cov[3]
    mu = jnp.clip(k_b / (jnp.abs(k_u) * b / b_unit + consts.EPS), -1.0, 1.0)
    sin_th = jnp.where(b == 0.0, 1.0, jnp.sqrt(1.0 - mu * mu))
    nu = -k_u * consts.ME * consts.CL * consts.CL / consts.HPL
    return sin_th, nu


def alpha_inv_scatt_c(nu, theta_e, n_e, hc_coeffs):
    """Invariant scattering opacity with the Chebyshev hotcross surrogate."""
    from grmonty.ops import cheb

    e_g = consts.HPL * nu / (consts.ME * consts.CL * consts.CL)
    sigma = cheb.hotcross_eval(e_g, theta_e, hc_coeffs)
    return nu * sigma * n_e


def alpha_inv_abs_c(nu, theta_e, n_e, b, theta, k2_coeffs):
    """Invariant absorption opacity with the Chebyshev K2 surrogate."""
    j = jnu.synch_c(nu, n_e, theta_e, b, theta, k2_coeffs)
    return nu * j / (b_nu(nu, theta_e) + consts.EPS)


def alpha_inv_abs_sin_c(nu, theta_e, n_e, b, sin_th, k2_coeffs):
    """:func:`alpha_inv_abs_c` taking sin(pitch angle) directly
    (pairs with :func:`kinematics_sin_c`)."""
    j = jnu.synch_sin_c(nu, n_e, theta_e, b, sin_th, k2_coeffs)
    return nu * j / (b_nu(nu, theta_e) + consts.EPS)
