"""Chebyshev surrogates for the physics lookup tables.

Each exact table lookup in the transport hot loop costs dynamic gathers
(hotcross bilinear = 4 per lane, K2 = 2).  The surrogates were chosen before the
port, where each gathered index was expensive; whether they still pay on the
H100, where the 221x81 hotcross table stays in cache, is not yet measured.
The looked-up quantities are smooth functions on log axes, so they are
fitted once at init with Chebyshev polynomials and evaluated with pure FMA
chains (1-D Clenshaw) or one small matmul (2-D).  The fitted domain and the
out-of-domain fallbacks exactly mirror the reference lookups:

* hotcross ``sigma(w, theta_e)`` — log10 surface over the reference table
  grid (``hotcross.cpp:60-106``); Thomson / cold-KN branches stay analytic.
* ``ln K2(1/theta_e)`` over the k2 table span (``jnu_mixed.cpp:66-70``).

Fits are checked against the exact table interpolation in
``tests/test_cheb.py``; residuals are far below the bilinear interpolation
error of the tables themselves.
"""

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from grmonty import consts


def cheb_nodes(n, lo, hi):
    """Chebyshev points of the first kind mapped to [lo, hi] (numpy)."""
    k = np.arange(n)
    t = np.cos(math.pi * (k + 0.5) / n)
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * t


def fit1d(f, lo, hi, deg):
    """Fit f on [lo, hi] with a degree-``deg`` Chebyshev series (numpy).

    ``f``: vectorized callable.  Returns coefficients (deg + 1,) float64.
    Uses the discrete orthogonality of values at Chebyshev nodes (exact
    projection, no least squares).
    """
    n = deg + 1
    xk = cheb_nodes(n, lo, hi)
    fk = np.asarray(f(xk), dtype=np.float64)
    k = np.arange(n)
    theta = math.pi * (k + 0.5) / n
    # c_j = (2/n) sum_k f(x_k) cos(j theta_k); c_0 halved.
    c = (2.0 / n) * np.cos(np.outer(np.arange(n), theta)) @ fk
    c[0] *= 0.5
    return c


def fit2d(f, xlo, xhi, ylo, yhi, degx, degy):
    """Fit f(x, y) with a tensor Chebyshev series; returns (degx+1, degy+1)."""
    nx, ny = degx + 1, degy + 1
    xk = cheb_nodes(nx, xlo, xhi)
    yk = cheb_nodes(ny, ylo, yhi)
    fk = np.asarray(f(xk[:, None], yk[None, :]), dtype=np.float64)  # (nx, ny)
    tx = math.pi * (np.arange(nx) + 0.5) / nx
    ty = math.pi * (np.arange(ny) + 0.5) / ny
    px = (2.0 / nx) * np.cos(np.outer(np.arange(nx), tx))
    py = (2.0 / ny) * np.cos(np.outer(np.arange(ny), ty))
    c = px @ fk @ py.T
    c[0, :] *= 0.5
    c[:, 0] *= 0.5
    return c


def eval1d(c, x, lo, hi):
    """Clenshaw evaluation of a Chebyshev series; ``c`` is a host ndarray
    (static coefficients — unrolled into the jitted FMA chain)."""
    t = (2.0 * x - (hi + lo)) / (hi - lo)
    t2 = 2.0 * t
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = float(c[k]) + t2 * b1 - b2, b1
    return float(c[0]) + t * b1 - b2


def _t_matrix(t, n):
    """Chebyshev basis values T_0..T_{n-1}(t) stacked to (..., n)."""
    ts = [jnp.ones_like(t), t]
    for _ in range(n - 2):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return jnp.stack(ts[:n], axis=-1)


def eval2d(c, x, y, xlo, xhi, ylo, yhi):
    """Tensor Chebyshev evaluation via one small matmul and a row dot.

    ``c``: (nx, ny) device array; ``x``/``y``: (N,).  Cost: one
    (N, nx) @ (nx, ny) matmul + a row dot — microseconds at nx, ny < 64.
    The product is pinned to full precision: a float32 matmul at default
    precision may run in TF32 on a GPU, whose ~1e-3 relative error in
    log10(sigma) is a several-percent error in sigma.
    """
    tx = (2.0 * x - (xhi + xlo)) / (xhi - xlo)
    ty = (2.0 * y - (yhi + ylo)) / (yhi - ylo)
    bx = _t_matrix(tx, c.shape[0])  # (N, nx)
    by = _t_matrix(ty, c.shape[1])  # (N, ny)
    u = jnp.matmul(bx, jnp.asarray(c, bx.dtype),
                   precision=lax.Precision.HIGHEST)  # (N, ny)
    return jnp.sum(u * by, axis=-1)


# ---------------------------------------------------------------------------
# Fitted physics surrogates
# ---------------------------------------------------------------------------

HC = consts.hotcross

# Fit domains (log10 for hotcross, ln for k2) — the reference table spans.
HC_XLO, HC_XHI = HC.L_MIN_W, HC.L_MIN_W + HC.N_W * HC.D_L_W
HC_YLO, HC_YHI = HC.L_MIN_T, HC.L_MIN_T + HC.N_T * HC.D_L_T
K2_LO, K2_HI = consts.jnu.L_MIN_T, consts.jnu.L_MIN_T + consts.N_E_SAMP * consts.jnu.D_L_T


def fit_hotcross(table, degx=40, degy=30):
    """Chebyshev fit of the log10 hotcross table surface (hotcross.cpp:60-79).

    Samples a cubic spline through the (N_W+1, N_T+1) table at Chebyshev
    nodes; the spline is closer to the underlying integral than the
    reference's bilinear lookup, and the Chebyshev residual is ~1e-5.
    """
    import scipy.interpolate

    l_w = HC.L_MIN_W + np.arange(HC.N_W + 1) * HC.D_L_W
    l_t = HC.L_MIN_T + np.arange(HC.N_T + 1) * HC.D_L_T
    sp = scipy.interpolate.RectBivariateSpline(l_w, l_t, np.asarray(table), kx=3, ky=3)

    def f(x, y):
        # Chebyshev nodes arrive in decreasing order; the spline wants
        # ascending — evaluate sorted, then undo the permutation.
        xs, ys = x.ravel(), y.ravel()
        xo, yo = np.argsort(xs), np.argsort(ys)
        vals = sp(xs[xo], ys[yo], grid=True)
        return vals[np.argsort(xo)][:, np.argsort(yo)]

    return fit2d(f, HC_XLO, HC_XHI, HC_YLO, HC_YHI, degx, degy)


def fit_k2(deg=24):
    """Chebyshev fit of ln K2(1/theta_e) over the k2 table span."""
    import scipy.special

    def f(l_t):
        return np.log(scipy.special.kv(2, 1.0 / np.exp(l_t)))

    return fit1d(f, K2_LO, K2_HI, deg)


def hotcross_eval(w, theta_e, coeffs):
    """sigma(w, theta_e) [cm^2] — drop-in for ``hotcross.lookup``.

    Same branch structure as hotcross.cpp:81-106: Thomson for
    w*theta_e < 1e-6, cold Klein-Nishina below the table temperature,
    fitted surface (inputs clamped to the table domain) otherwise.
    """
    from grmonty.ops import hotcross as hc_mod

    l_w = jnp.clip(jnp.log10(jnp.maximum(w, 1e-30)), HC_XLO, HC_XHI)
    l_t = jnp.clip(jnp.log10(jnp.maximum(theta_e, 1e-30)), HC_YLO, HC_YHI)
    l_sigma = eval2d(coeffs, l_w, l_t, HC_XLO, HC_XHI, HC_YLO, HC_YHI)
    # 10**x = exp(x ln 10).
    interp = jnp.exp(l_sigma * math.log(10.0))

    cold = hc_mod._hc_klein_nishina(w) * consts.SIGMA_THOMSON
    out = jnp.where(theta_e < HC.MIN_T, cold, interp)
    return jnp.where(w * theta_e < 1.0e-6, consts.SIGMA_THOMSON, out)


def k2_eval(theta_e, coeffs):
    """K2(1/theta_e) — drop-in for ``jnu.k2_eval`` (jnu_mixed.cpp:102-111)."""
    l_t = jnp.clip(jnp.log(jnp.maximum(theta_e, consts.jnu.MIN_T)), K2_LO, K2_HI)
    interp = jnp.exp(eval1d(coeffs, l_t, K2_LO, K2_HI))
    out = jnp.where(theta_e > consts.jnu.MAX_T, 2.0 * theta_e * theta_e, interp)
    return jnp.where(theta_e < consts.THETA_E_MIN, 0.0, out)
