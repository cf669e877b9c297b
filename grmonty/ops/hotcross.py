"""Angle-averaged hot-electron Compton cross-section ("hotcross").

Equivalent of ``cuda_grmonty/hotcross.cpp:60-179`` and the GPU table builder
(``hotcross_table.cu:35-65``).

The table stores log10 of the thermally-averaged total Compton cross-section
sigma(w, theta_e) [cm^2] on a (N_W+1, N_T+1) log10 grid over photon energy
w = h nu / m_e c^2 in [1e-12, 1e6] and electron temperature theta_e in
[1e-4, 1e4].  Entries are computed by a fixed-grid midpoint double integral
over electron pitch-cosine mu_e and Lorentz factor gamma_e of the
Maxwell-Juettner distribution times the rest-frame Klein-Nishina
cross-section with the flux boost factor.

Device lookup uses bilinear interpolation in log-log space with the same
analytic fallbacks as the reference: Thomson for w*theta_e < 1e-6 and cold
Klein-Nishina for theta_e below the table.  The host-side :func:`lookup_np`
mirrors hotcross.cpp:81-106 exactly, INCLUDING the numeric-integral
fallback for the out-of-table region (bit-pinned against the compiled
reference in tests/test_vs_reference.py); the device ``lookup`` clamps to
the table edge there instead — the region is unreachable for any photon
the transport loop can carry (w spans 5e-7 eV .. 511 TeV), and a masked
9600-point integral per lane would not fuse.
"""

import math

import jax.numpy as jnp
import numpy as np
import scipy.special

from grmonty import consts

HC = consts.hotcross


def _hc_klein_nishina_np(w):
    """Total KN cross-section / sigma_T for photon energy w (hotcross.cpp:144-151)."""
    w = np.asarray(w, dtype=np.float64)
    series = 1.0 - 2.0 * w
    with np.errstate(divide="ignore", invalid="ignore"):
        full = 0.75 * (
            2.0 / (w * w)
            + (1.0 / (2.0 * w) - (1.0 + w) / (w**3)) * np.log1p(2.0 * w)
            + (1.0 + w) / ((1.0 + 2.0 * w) ** 2)
        )
    return np.where(w < 1.0e-3, series, full)


def _dnd_gamma_e_np(theta_e, gamma_e):
    """Maxwell-Juettner dN/dgamma_e (hotcross.cpp:153-163).

    Uses the exponentially-scaled Bessel function kve(2, 1/theta) which
    equals the reference's K_2(1/theta) * exp(1/theta) in one stable call.
    """
    small = theta_e <= 1.0e-2
    k2f = np.where(
        small,
        np.sqrt(np.pi * np.maximum(theta_e, 1e-300) / 2.0),
        scipy.special.kve(2, 1.0 / np.maximum(theta_e, 1e-300)),
    )
    return (
        gamma_e
        * np.sqrt(np.maximum(gamma_e * gamma_e - 1.0, 0.0))
        / (theta_e * k2f)
        * np.exp(-(gamma_e - 1.0) / theta_e)
    )


def total_compton_cross_num(w, theta_e):
    """Numeric thermal average (hotcross.cpp:108-142), vectorized over w.

    ``w`` may be scalar or 1D; ``theta_e`` is a scalar.  Returns sigma [cm^2].
    """
    w = np.atleast_1d(np.asarray(w, dtype=np.float64))
    if theta_e < HC.MIN_T:
        if np.all(w < HC.MIN_W):
            return np.full_like(w, consts.SIGMA_THOMSON)
        return _hc_klein_nishina_np(w) * consts.SIGMA_THOMSON

    # Midpoint grids: mu_e over [-1, 1] step D_MU_E; gamma_e = 1 + theta_e*u
    # with u over (0, MAX_GAMMA) step D_GAMMA_E (jacobian theta_e folded in).
    n_mu = int(round(2.0 / HC.D_MU_E))
    mu = -1.0 + (np.arange(n_mu) + 0.5) * HC.D_MU_E
    n_g = int(round(HC.MAX_GAMMA / HC.D_GAMMA_E))
    u = (np.arange(n_g) + 0.5) * HC.D_GAMMA_E
    gamma = 1.0 + theta_e * u

    f = 0.5 * _dnd_gamma_e_np(theta_e, gamma)  # (n_g,)
    v = np.sqrt(gamma * gamma - 1.0) / gamma  # (n_g,)

    # boostcross(w, mu, gamma) = KN(w') * (1 - mu v), w' = w gamma (1 - mu v)
    one_minus = 1.0 - mu[None, :, None] * v[None, None, :]  # (1, n_mu, n_g)
    we = w[:, None, None] * gamma[None, None, :] * one_minus
    boost = _hc_klein_nishina_np(we) * one_minus  # (n_w, n_mu, n_g)

    cross = theta_e * HC.D_MU_E * HC.D_GAMMA_E * np.einsum("wmg,g->w", boost, f)
    return cross * consts.SIGMA_THOMSON


def build_table():
    """Build the (N_W+1, N_T+1) log10 cross-section table (hotcross.cpp:60-79)."""
    l_w = HC.L_MIN_W + np.arange(HC.N_W + 1) * HC.D_L_W
    l_t = HC.L_MIN_T + np.arange(HC.N_T + 1) * HC.D_L_T
    w = 10.0**l_w
    table = np.empty((HC.N_W + 1, HC.N_T + 1))
    for j, lt in enumerate(l_t):
        table[:, j] = np.log10(total_compton_cross_num(w, 10.0**lt))
    return table


def lookup_np(w, theta_e, table):
    """EXACT host-side lookup mirroring hotcross.cpp:81-106 branch for
    branch — including the numeric-integral fallback for the out-of-table
    region (the device ``lookup`` clamps there instead; this is the
    reference-semantics path used by the scalar oracle and the
    vs-reference bit-pin tests).  Vectorized over ``w``/``theta_e``.
    """
    w = np.atleast_1d(np.asarray(w, np.float64))
    theta_e = np.broadcast_to(
        np.asarray(theta_e, np.float64), w.shape).copy()
    table = np.asarray(table)
    out = np.empty_like(w)

    thomson = w * theta_e < 1.0e-6
    out[thomson] = consts.SIGMA_THOMSON
    cold = ~thomson & (theta_e < HC.MIN_T)
    out[cold] = _hc_klein_nishina_np(w[cold]) * consts.SIGMA_THOMSON
    numeric = ~thomson & ~cold & (
        (w <= HC.MIN_W) | (w >= HC.MAX_W)
        | (theta_e <= HC.MIN_T) | (theta_e >= HC.MAX_T)
    )
    for idx in np.nonzero(numeric)[0]:
        out[idx] = total_compton_cross_num(w[idx], theta_e[idx])[0]

    interp = ~thomson & ~cold & ~numeric
    if np.any(interp):
        l_w = (np.log10(w[interp]) - HC.L_MIN_W) / HC.D_L_W
        l_t = (np.log10(theta_e[interp]) - HC.L_MIN_T) / HC.D_L_T
        i = l_w.astype(np.int64)
        j = l_t.astype(np.int64)
        di = l_w - i
        dj = l_t - j
        l_cross = (
            (1.0 - di) * (1.0 - dj) * table[i, j]
            + di * (1.0 - dj) * table[i + 1, j]
            + (1.0 - di) * dj * table[i, j + 1]
            + di * dj * table[i + 1, j + 1]
        )
        out[interp] = 10.0**l_cross
    return out


# ---------------------------------------------------------------------------
# Device-side lookup (jnp, batched)
# ---------------------------------------------------------------------------

def _hc_klein_nishina(w):
    series = 1.0 - 2.0 * w
    ws = jnp.maximum(w, 1.0e-6)
    full = 0.75 * (
        2.0 / (ws * ws)
        + (1.0 / (2.0 * ws) - (1.0 + ws) / (ws**3)) * jnp.log1p(2.0 * ws)
        + (1.0 + ws) / ((1.0 + 2.0 * ws) ** 2)
    )
    return jnp.where(w < 1.0e-3, series, full)


def clamp_hit(w, theta_e):
    """True where the device lookup CLAMPS to the table edge.

    Mirrors the ``numeric`` branch condition of :func:`lookup_np`
    (hotcross.cpp:81-106): inputs outside the table domain that are served
    by neither the Thomson nor the cold-KN analytic branch.  The reference
    re-runs the numeric integral there; the device path clamps instead
    (documented deviation) — the transport engine counts these so the
    accuracy harness can assert the clamped region is never actually
    reached in production runs.
    """
    thomson = w * theta_e < 1.0e-6
    cold = theta_e < HC.MIN_T
    return ~thomson & ~cold & (
        (w <= HC.MIN_W) | (w >= HC.MAX_W)
        | (theta_e <= HC.MIN_T) | (theta_e >= HC.MAX_T))


def lookup(w, theta_e, table):
    """sigma(w, theta_e) [cm^2] by bilinear log-log interpolation.

    Fallback branches follow hotcross.cpp:81-106 (see module docstring for
    the out-of-range deviation).
    """
    l_w = (jnp.log10(jnp.maximum(w, 1e-30)) - HC.L_MIN_W) / HC.D_L_W
    l_t = (jnp.log10(jnp.maximum(theta_e, 1e-30)) - HC.L_MIN_T) / HC.D_L_T
    l_w = jnp.clip(l_w, 0.0, HC.N_W - 1.0e-9)
    l_t = jnp.clip(l_t, 0.0, HC.N_T - 1.0e-9)
    i = jnp.floor(l_w).astype(jnp.int32)
    j = jnp.floor(l_t).astype(jnp.int32)
    di = l_w - i
    dj = l_t - j

    l_cross = (
        (1.0 - di) * (1.0 - dj) * table[i, j]
        + di * (1.0 - dj) * table[i + 1, j]
        + (1.0 - di) * dj * table[i, j + 1]
        + di * dj * table[i + 1, j + 1]
    )
    interp = 10.0**l_cross

    cold = _hc_klein_nishina(w) * consts.SIGMA_THOMSON
    out = jnp.where(theta_e < HC.MIN_T, cold, interp)
    return jnp.where(w * theta_e < 1.0e-6, consts.SIGMA_THOMSON, out)
