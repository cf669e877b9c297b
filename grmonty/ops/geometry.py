"""Kerr geometry in modified Kerr-Schild (MKS) coordinates, vectorized.

Equivalent of the reference's geometry layer (``cuda_grmonty/harm_model.cpp``:
``gcov_func`` :499-530, ``gcon_func`` :473-497, ``get_connection`` :1436-1569,
``get_bl_coord`` :1632-1637, ``get_coord`` :1639-1644, ``x_to_ij`` :1406-1434,
``d_omega_func`` :532-536, ``step_size`` :1620-1630).

Coordinates: x0 = t, x1 = ln r, x2 in [0, 1] with
theta = pi*x2 + (1 - h_slope)/2 * sin(2 pi x2), x3 = phi.

Two API layers:

* ``*_c`` **component functions** — take/return separate (N,) arrays per
  tensor component.  This is the transport hot path: every operation is a
  flat elementwise map over the photon axis (a layout chosen before the
  port to the H100; not yet measured against (N, 4) layouts on it).
  Metric/connection sparsity is also explicit (7 nonzero metric entries
  instead of 16).
* array wrappers (``gcov``, ``connection``, ...) — stack the component
  results for tests, host-side init, and the CPU oracle, where layout
  doesn't matter.

The affine connection is a 40-tuple: for each upper index i, the 10
independent lower components in the order (0,0) (0,1) (0,2) (0,3) (1,1)
(1,2) (1,3) (2,2) (2,3) (3,3) — exactly the reference GPU's flattened
symmetric storage (``super_photon.cu:393-402``).
"""

import math

import jax.numpy as jnp

from grmonty import consts

PI = math.pi


# ---------------------------------------------------------------------------
# component layer (hot path)
# ---------------------------------------------------------------------------

def bl_coord_c(x1, x2, a, h_slope, r_0):
    """Boyer-Lindquist (r, theta) from MKS x1/x2 (harm_model.cpp:1632-1637)."""
    r = jnp.exp(x1) + r_0
    theta = PI * x2 + 0.5 * (1.0 - h_slope) * jnp.sin(2.0 * PI * x2)
    return r, theta


def theta_deriv(x2, h_slope):
    """d theta / d x2 (the reference's ``hfac``/``dthdx2``)."""
    return PI * (1.0 + (1.0 - h_slope) * jnp.cos(2.0 * PI * x2))


def gcov_c(x1, x2, a, h_slope, r_0):
    """The 7 independent nonzero covariant MKS metric components
    (g00, g01, g03, g11, g13, g22, g33) (harm_model.cpp:499-530)."""
    r, th = bl_coord_c(x1, x2, a, h_slope, r_0)
    sth = jnp.abs(jnp.sin(th)) + consts.EPS
    cth = jnp.cos(th)
    s2 = sth * sth
    rho2 = r * r + a * a * cth * cth
    tworr = 2.0 * r / rho2

    rfac = r - r_0  # dr/dx1 = exp(x1)
    hfac = theta_deriv(x2, h_slope)

    g00 = -1.0 + tworr
    g01 = tworr * rfac
    g03 = -a * s2 * tworr
    g11 = (1.0 + tworr) * rfac * rfac
    g13 = -a * s2 * (1.0 + tworr) * rfac
    g22 = rho2 * hfac * hfac
    g33 = s2 * (rho2 + a * a * s2 * (1.0 + tworr))
    return g00, g01, g03, g11, g13, g22, g33


def gcon_c(x1, x2, a, h_slope, r_0):
    """The 6 independent nonzero contravariant components
    (g00, g01, g11, g13, g22, g33) (harm_model.cpp:473-497)."""
    r, th = bl_coord_c(x1, x2, a, h_slope, r_0)
    sth = jnp.abs(jnp.sin(th)) + consts.EPS
    cth = jnp.cos(th)
    irho2 = 1.0 / (r * r + a * a * cth * cth)
    hfac = theta_deriv(x2, h_slope)

    g00 = -1.0 - 2.0 * r * irho2
    g01 = 2.0 * irho2
    g11 = irho2 * (r * (r - 2.0) + a * a) / (r * r)
    g13 = a * irho2 / r
    g22 = irho2 / (hfac * hfac)
    g33 = irho2 / (sth * sth)
    return g00, g01, g11, g13, g22, g33


def gcov_row0_c(x1, x2, a, h_slope, r_0):
    """Row 0 of the covariant metric only (conserved-energy check).

    Mirrors the GPU reference's ``gcov_0_func`` (harm_model.cuh:164-179).
    """
    r, th = bl_coord_c(x1, x2, a, h_slope, r_0)
    sth = jnp.abs(jnp.sin(th)) + consts.EPS
    cth = jnp.cos(th)
    rho2 = r * r + a * a * cth * cth
    tworr = 2.0 * r / rho2
    g00 = -1.0 + tworr
    g01 = tworr * (r - r_0)
    g03 = -a * sth * sth * tworr
    return g00, g01, g03


def dot_cov_c(g, u, v):
    """g_{mu nu} u^mu v^nu from the 7-component metric tuple and two
    4-component vector tuples."""
    g00, g01, g03, g11, g13, g22, g33 = g
    u0, u1, u2, u3 = u
    v0, v1, v2, v3 = v
    return (
        g00 * u0 * v0
        + g01 * (u0 * v1 + u1 * v0)
        + g03 * (u0 * v3 + u3 * v0)
        + g11 * u1 * v1
        + g13 * (u1 * v3 + u3 * v1)
        + g22 * u2 * v2
        + g33 * u3 * v3
    )


def lower_c(g, v):
    """v_mu = g_{mu nu} v^nu with the 7-component metric tuple."""
    g00, g01, g03, g11, g13, g22, g33 = g
    v0, v1, v2, v3 = v
    return (
        g00 * v0 + g01 * v1 + g03 * v3,
        g01 * v0 + g11 * v1 + g13 * v3,
        g22 * v2,
        g03 * v0 + g13 * v1 + g33 * v3,
    )


def connection_c(x1, x2, a, h_slope):
    """Affine connection as a 40-tuple of component arrays.

    Closed-form MKS Christoffel symbols (harm_model.cpp:1436-1569; these are
    the standard grmonty expressions, verified against autodiff in
    tests/test_geometry.py).  Note the reference takes r = exp(x1) here,
    i.e. r_0 is assumed zero in the connection — we reproduce that.
    """
    r1 = jnp.exp(x1)
    r2 = r1 * r1
    r3 = r2 * r1
    r4 = r3 * r1

    sx = jnp.sin(2.0 * PI * x2)
    cx = jnp.cos(2.0 * PI * x2)
    th = PI * x2 + 0.5 * (1.0 - h_slope) * sx
    dth = PI * (1.0 + (1.0 - h_slope) * cx)  # d theta / d x2
    d2th = -2.0 * PI * PI * (1.0 - h_slope) * sx  # d^2 theta / d x2^2
    dth2 = dth * dth

    sth = jnp.sin(th)
    cth = jnp.cos(th)
    sth2 = sth * sth
    sth4 = sth2 * sth2
    cth2 = cth * cth
    cth4 = cth2 * cth2
    s2th = 2.0 * sth * cth
    c2th = 2.0 * cth2 - 1.0
    r1sth2 = r1 * sth2

    a2 = a * a
    a3 = a2 * a
    a4 = a3 * a
    a2sth2 = a2 * sth2
    a2cth2 = a2 * cth2
    a4cth4 = a4 * cth4

    rho2 = r2 + a2cth2
    rho22 = rho2 * rho2
    rho23 = rho22 * rho2
    ir2 = 1.0 / rho2
    ir22 = ir2 * ir2
    ir23 = ir22 * ir2
    ir23_dth = ir23 / dth

    fac1 = r2 - a2cth2
    f1r3 = fac1 * ir23
    fac2 = a2 + 2.0 * r2 + a2 * c2th
    fac3 = a2 + r1 * (r1 - 2.0)
    zero = jnp.zeros_like(r1)

    # --- upper index 0 -------------------------------------------------
    c000 = 2.0 * r1 * f1r3
    c001 = r1 * (2.0 * r1 + rho2) * f1r3
    c002 = -a2 * r1 * s2th * dth * ir22
    c003 = -2.0 * a * r1sth2 * f1r3
    c011 = 2.0 * r2 * (r4 + r1 * fac1 - a4cth4) * ir23
    c012 = -a2 * r2 * s2th * dth * ir22
    c013 = a * r1 * (-r1 * (r3 + 2.0 * fac1) + a4cth4) * sth2 * ir23
    c022 = -2.0 * r2 * dth2 * ir2
    c023 = a3 * r1sth2 * s2th * dth * ir22
    c033 = 2.0 * r1sth2 * (-r1 * rho22 + a2sth2 * fac1) * ir23

    # --- upper index 1 -------------------------------------------------
    c100 = fac3 * fac1 / (r1 * rho23)
    c101 = fac1 * (-2.0 * r1 + a2sth2) * ir23
    c102 = zero
    c103 = -a * sth2 * fac3 * fac1 / (r1 * rho23)
    c111 = (
        r4 * (r1 - 2.0) * (1.0 + r1)
        + a2
        * (
            a2 * r1 * (1.0 + 3.0 * r1) * cth4
            + a4cth4 * cth2
            + r3 * sth2
            + r1 * cth2 * (2.0 * r1 + 3.0 * r3 - a2sth2)
        )
    ) * ir23
    c112 = -a2 * dth * s2th / fac2
    c113 = (
        a
        * sth2
        * (
            a4 * r1 * cth4
            + r2 * (2.0 * r1 + r3 - a2sth2)
            + a2cth2 * (2.0 * r1 * (r2 - 1.0) + a2sth2)
        )
        * ir23
    )
    c122 = -fac3 * dth2 * ir2
    c123 = zero
    c133 = -fac3 * sth2 * (r1 * rho22 - a2 * fac1 * sth2) / (r1 * rho23)

    # --- upper index 2 -------------------------------------------------
    c200 = -a2 * r1 * s2th * ir23_dth
    c201 = r1 * c200
    c202 = zero
    c203 = a * r1 * (a2 + r2) * s2th * ir23_dth
    c211 = r2 * c200
    c212 = r2 * ir2
    c213 = (
        a
        * r1
        * cth
        * sth
        * (r3 * (2.0 + r1) + a2 * (2.0 * r1 * (1.0 + r1) * cth2 + a2 * cth4 + 2.0 * r1sth2))
    ) * ir23_dth
    c222 = -a2 * cth * sth * dth * ir2 + d2th / dth
    c223 = zero
    c233 = (
        -cth
        * sth
        * (rho23 + a2sth2 * rho2 * (r1 * (4.0 + r1) + a2cth2) + 2.0 * r1 * a4 * sth4)
        * ir23_dth
    )

    # --- upper index 3 -------------------------------------------------
    c300 = a * f1r3
    c301 = r1 * c300
    c302 = -2.0 * a * r1 * cth * dth / (sth * rho22)
    c303 = -a2sth2 * f1r3
    c311 = a * r2 * f1r3
    c312 = (
        -2.0 * a * r1 * (a2 + 2.0 * r1 * (2.0 + r1) + a2 * c2th) * cth * dth
        / (sth * fac2 * fac2)
    )
    c313 = r1 * (r1 * rho22 - a2sth2 * fac1) * ir23
    c322 = -a * r1 * dth2 * ir2
    c323 = dth * (0.25 * fac2 * fac2 * cth / sth + a2 * r1 * s2th) * ir22
    c333 = (-a * r1sth2 * rho22 + a3 * sth4 * fac1) * ir23

    return (
        c000, c001, c002, c003, c011, c012, c013, c022, c023, c033,
        c100, c101, c102, c103, c111, c112, c113, c122, c123, c133,
        c200, c201, c202, c203, c211, c212, c213, c222, c223, c233,
        c300, c301, c302, c303, c311, c312, c313, c322, c323, c333,
    )


def geodesic_rhs_c(conn, k0, k1, k2, k3):
    """dk^i/dlambda = -Gamma^i_{lm} k^l k^m from the 40-tuple connection.

    The symmetrized quadratic monomials match the reference's unrolled
    contraction (harm_model.cpp:1578-1586).
    """
    q = (
        k0 * k0, 2.0 * k0 * k1, 2.0 * k0 * k2, 2.0 * k0 * k3,
        k1 * k1, 2.0 * k1 * k2, 2.0 * k1 * k3,
        k2 * k2, 2.0 * k2 * k3, k3 * k3,
    )
    out = []
    for i in range(4):
        s = conn[10 * i] * q[0]
        for j in range(1, 10):
            s = s + conn[10 * i + j] * q[j]
        out.append(-s)
    return tuple(out)


def step_size_c(x1, x2, k1, k2, k3, x2_stop):
    """Geodesic step: harmonic mean of per-axis limits (harm_model.cpp:1620-1630)."""
    eps = consts.EPS
    dl1 = consts.STEP_EPS * x1 / (jnp.abs(k1) + eps)
    dl2 = consts.STEP_EPS * jnp.minimum(x2, x2_stop - x2) / (jnp.abs(k2) + eps)
    dl3 = consts.STEP_EPS / (jnp.abs(k3) + eps)
    return 1.0 / (
        1.0 / (jnp.abs(dl1) + eps) + 1.0 / (jnp.abs(dl2) + eps) + 1.0 / (jnp.abs(dl3) + eps)
    )


# ---------------------------------------------------------------------------
# array wrappers (tests, init, CPU oracle)
# ---------------------------------------------------------------------------

def bl_coord(x, a, h_slope, r_0):
    """Boyer-Lindquist (r, theta) from MKS x (harm_model.cpp:1632-1637)."""
    return bl_coord_c(x[..., 1], x[..., 2], a, h_slope, r_0)


def gcov(x, a, h_slope, r_0):
    """Covariant MKS metric, shape (..., 4, 4) (harm_model.cpp:499-530)."""
    g00, g01, g03, g11, g13, g22, g33 = gcov_c(x[..., 1], x[..., 2], a, h_slope, r_0)
    zero = jnp.zeros_like(g00)
    return jnp.stack(
        [
            jnp.stack([g00, g01, zero, g03], axis=-1),
            jnp.stack([g01, g11, zero, g13], axis=-1),
            jnp.stack([zero, zero, g22, zero], axis=-1),
            jnp.stack([g03, g13, zero, g33], axis=-1),
        ],
        axis=-2,
    )


def gcov_row0(x, a, h_slope, r_0):
    """Row 0 of the covariant metric only (for the conserved-energy check)."""
    return gcov_row0_c(x[..., 1], x[..., 2], a, h_slope, r_0)


def gcon(x, a, h_slope, r_0):
    """Contravariant MKS metric, shape (..., 4, 4) (harm_model.cpp:473-497)."""
    g00, g01, g11, g13, g22, g33 = gcon_c(x[..., 1], x[..., 2], a, h_slope, r_0)
    zero = jnp.zeros_like(g00)
    return jnp.stack(
        [
            jnp.stack([g00, g01, zero, zero], axis=-1),
            jnp.stack([g01, g11, zero, g13], axis=-1),
            jnp.stack([zero, zero, g22, zero], axis=-1),
            jnp.stack([zero, g13, zero, g33], axis=-1),
        ],
        axis=-2,
    )


def connection(x, a, h_slope):
    """Affine connection Gamma^i_{lm}, packed (..., 4, 10)."""
    c = connection_c(x[..., 1], x[..., 2], a, h_slope)
    rows = [jnp.stack(c[10 * i : 10 * (i + 1)], axis=-1) for i in range(4)]
    return jnp.stack(rows, axis=-2)


def geodesic_rhs(conn, k):
    """dk^i/dlambda from the packed (..., 4, 10) connection and k (..., 4)."""
    k0, k1, k2, k3 = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    q = jnp.stack(
        [
            k0 * k0, 2.0 * k0 * k1, 2.0 * k0 * k2, 2.0 * k0 * k3,
            k1 * k1, 2.0 * k1 * k2, 2.0 * k1 * k3,
            k2 * k2, 2.0 * k2 * k3, k3 * k3,
        ],
        axis=-1,
    )
    return -jnp.sum(conn * q[..., None, :], axis=-1)


def conn_dense(conn):
    """Unpack (..., 4, 10) -> full symmetric (..., 4, 4, 4) (for tests)."""
    idx = {
        (0, 0): 0, (0, 1): 1, (0, 2): 2, (0, 3): 3,
        (1, 1): 4, (1, 2): 5, (1, 3): 6, (2, 2): 7, (2, 3): 8, (3, 3): 9,
    }
    rows = []
    for l in range(4):
        cols = []
        for m in range(4):
            key = (l, m) if (l, m) in idx else (m, l)
            cols.append(conn[..., idx[key]])
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def d_omega(x2i, x2f, h_slope):
    """Solid angle between polar coordinates x2i..x2f (harm_model.cpp:532-536)."""
    def mu(x2):
        return jnp.cos(PI * x2 + 0.5 * (1.0 - h_slope) * jnp.sin(2.0 * PI * x2))

    return 2.0 * PI * (mu(x2i) - mu(x2f))


def zone_center(i, j, x_start, dx):
    """MKS coordinates of zone center (i, j) (harm_model.cpp:1639-1644)."""
    i = jnp.asarray(i)
    x0 = jnp.full(i.shape, x_start[0], dtype=jnp.result_type(float))
    x1 = x_start[1] + (i + 0.5) * dx[1]
    x2 = x_start[2] + (j + 0.5) * dx[2]
    x3 = jnp.full(i.shape, x_start[3], dtype=jnp.result_type(float))
    return jnp.stack([x0, x1, x2, x3], axis=-1)


def x_to_ij_c(x1, x2, x_start, dx, n):
    """Grid cell + bilinear offsets (harm_model.cpp:1406-1434), component form.

    Returns (i, j, del_i, del_j) with i in [0, n1-2], j in [0, n2-2] and the
    offsets clamped to [0, 1] at the boundaries, exactly as the reference.
    """
    fi = jnp.floor((x1 - x_start[1]) / dx[1] - 0.5).astype(jnp.int32)
    fj = jnp.floor((x2 - x_start[2]) / dx[2] - 0.5).astype(jnp.int32)

    i = jnp.clip(fi, 0, n[0] - 2)
    j = jnp.clip(fj, 0, n[1] - 2)

    del_i = (x1 - ((i + 0.5) * dx[1] + x_start[1])) / dx[1]
    del_j = (x2 - ((j + 0.5) * dx[2] + x_start[2])) / dx[2]
    del_i = jnp.where(fi < 0, 0.0, jnp.where(fi > n[0] - 2, 1.0, del_i))
    del_j = jnp.where(fj < 0, 0.0, jnp.where(fj > n[1] - 2, 1.0, del_j))
    return i, j, del_i, del_j


def x_to_ij(x, x_start, dx, n):
    """Array wrapper of :func:`x_to_ij_c`."""
    return x_to_ij_c(x[..., 1], x[..., 2], x_start, dx, n)


def step_size(x, k, x2_stop):
    """Array wrapper of :func:`step_size_c`."""
    return step_size_c(x[..., 1], x[..., 2], k[..., 1], k[..., 2], k[..., 3], x2_stop)
