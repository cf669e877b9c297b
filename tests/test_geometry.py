"""Kerr/MKS geometry identity tests.

These go beyond the reference's test suite (which has no geometry tests):
metric inverse identity, Christoffel symbols vs automatic differentiation of
the metric, horizon values, and solid-angle normalization.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grmonty.ops import geometry

A = 0.9375
H_SLOPE = 0.3
R_0 = 0.0


def _sample_points(n=64):
    rng = np.random.default_rng(7)
    x = np.zeros((n, 4))
    x[:, 1] = rng.uniform(math.log(1.5), math.log(90.0), n)
    x[:, 2] = rng.uniform(0.05, 0.95, n)
    x[:, 3] = rng.uniform(0, 2 * math.pi, n)
    return jnp.asarray(x)


def test_metric_inverse_identity():
    x = _sample_points()
    g_cov = geometry.gcov(x, A, H_SLOPE, R_0)
    g_con = geometry.gcon(x, A, H_SLOPE, R_0)
    prod = jnp.einsum("nij,njk->nik", g_cov, g_con)
    eye = jnp.broadcast_to(jnp.eye(4), prod.shape)
    np.testing.assert_allclose(np.asarray(prod), np.asarray(eye), atol=1e-10)


def test_metric_symmetry_and_signature():
    x = _sample_points()
    g = np.asarray(geometry.gcov(x, A, H_SLOPE, R_0))
    np.testing.assert_allclose(g, np.swapaxes(g, -1, -2), atol=0)
    # Lorentzian signature: determinant negative, g_22/g_33 positive outside horizon
    det = np.linalg.det(g)
    assert (det < 0).all()
    assert (g[:, 2, 2] > 0).all() and (g[:, 3, 3] > 0).all()


def test_gcov_row0_matches_full():
    x = _sample_points()
    g = geometry.gcov(x, A, H_SLOPE, R_0)
    g00, g01, g03 = geometry.gcov_row0(x, A, H_SLOPE, R_0)
    np.testing.assert_allclose(np.asarray(g[:, 0, 0]), np.asarray(g00), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(g[:, 0, 1]), np.asarray(g01), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(g[:, 0, 3]), np.asarray(g03), rtol=1e-14)


def test_connection_vs_autodiff():
    """Gamma^l_{mn} = 1/2 g^{ls} (d_m g_{sn} + d_n g_{sm} - d_s g_{mn})."""
    x = _sample_points(16)
    conn = geometry.conn_dense(geometry.connection(x, A, H_SLOPE))

    def gcov_single(xi):
        return geometry.gcov(xi, A, H_SLOPE, R_0)

    d = jax.vmap(jax.jacfwd(gcov_single))(x)  # d[n, i, j, k] = d_k g_{ij}
    g_con = geometry.gcon(x, A, H_SLOPE, R_0)
    # Gamma_low[n, s, m, nn] = 0.5*(d_m g_{s nn} + d_nn g_{s m} - d_s g_{m nn})
    #                        = 0.5*(d[n,s,nn,m] + d[n,s,m,nn] - d[n,m,nn,s])
    gamma_low = 0.5 * (
        jnp.transpose(d, (0, 1, 3, 2)) + d - jnp.transpose(d, (0, 3, 1, 2))
    )
    gamma = jnp.einsum("nls,nsmk->nlmk", g_con, gamma_low)

    np.testing.assert_allclose(
        np.asarray(conn), np.asarray(gamma), rtol=2e-6, atol=1e-9
    )


def test_geodesic_rhs_matches_dense_contraction():
    x = _sample_points(8)
    k = jnp.asarray(np.random.default_rng(3).normal(size=(8, 4)))
    conn = geometry.connection(x, A, H_SLOPE)
    rhs = geometry.geodesic_rhs(conn, k)
    dense = geometry.conn_dense(conn)
    expected = -jnp.einsum("nlmk,nm,nk->nl", dense, k, k)
    np.testing.assert_allclose(np.asarray(rhs), np.asarray(expected), rtol=1e-12)


def test_bl_coord_and_horizon():
    x = jnp.array([[0.0, math.log(2.0), 0.5, 0.0]])
    r, th = geometry.bl_coord(x, A, H_SLOPE, R_0)
    assert float(r[0]) == pytest.approx(2.0)
    assert float(th[0]) == pytest.approx(math.pi / 2.0)  # x2=0.5 is the equator


def test_d_omega_full_sphere():
    # Sum of all polar bins (both hemispheres) must be 4 pi.
    total = 0.0
    nb = 6
    for j in range(2 * nb):
        total += float(geometry.d_omega(j / (2 * nb), (j + 1) / (2 * nb), H_SLOPE))
    assert total == pytest.approx(4 * math.pi, rel=1e-12)


def test_x_to_ij_center_and_clamp():
    x_start = (0.0, 1.0, 0.0, 0.0)
    dx = (1.0, 0.1, 0.05, 2 * math.pi)
    n = (10, 8)
    # interior point between centers of zones 3 and 4: i=3, del_i=0.2
    x = jnp.array([[0.0, 1.0 + 3.7 * 0.1, 2.8 * 0.05, 0.0]])
    i, j, di, dj = geometry.x_to_ij(x, x_start, dx, n)
    assert int(i[0]) == 3 and int(j[0]) == 2
    assert float(di[0]) == pytest.approx(0.2, abs=1e-9)
    assert float(dj[0]) == pytest.approx(0.3, abs=1e-9)
    # below the first zone center: clamped with del = 0
    x = jnp.array([[0.0, 1.0 + 0.01, 0.001, 0.0]])
    i, j, di, dj = geometry.x_to_ij(x, x_start, dx, n)
    assert int(i[0]) == 0 and float(di[0]) == 0.0
    assert int(j[0]) == 0 and float(dj[0]) == 0.0
    # beyond the last: clamped with del = 1
    x = jnp.array([[0.0, 1.0 + 9.9 * 0.1, 7.9 * 0.05, 0.0]])
    i, j, di, dj = geometry.x_to_ij(x, x_start, dx, n)
    assert int(i[0]) == n[0] - 2 and float(di[0]) == 1.0
    assert int(j[0]) == n[1] - 2 and float(dj[0]) == 1.0


def test_step_size_positive_and_small():
    x = _sample_points(32)
    k = jnp.asarray(np.random.default_rng(5).normal(size=(32, 4)))
    dl = np.asarray(geometry.step_size(x, k, 1.0))
    assert (dl > 0).all()
    # harmonic mean is smaller than each individual limit
    from grmonty import consts

    dl1 = consts.STEP_EPS * np.asarray(x[:, 1]) / (np.abs(np.asarray(k[:, 1])) + 1e-40)
    assert (dl <= dl1 + 1e-12).all()


def test_closed_form_det_matches_numpy():
    from grmonty.ops import linalg as gl

    rng = np.random.default_rng(9)
    for n in (2, 3, 4):
        m = jnp.asarray(rng.normal(size=(16, n, n)))
        np.testing.assert_allclose(
            np.asarray(gl.det(m)), np.linalg.det(np.asarray(m)), rtol=1e-10
        )
    # on the actual metric
    x = _sample_points(16)
    g = geometry.gcov(x, A, H_SLOPE, R_0)
    np.testing.assert_allclose(
        np.asarray(gl.det(g)), np.linalg.det(np.asarray(g)), rtol=1e-10
    )
