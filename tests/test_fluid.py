"""Fluid-state reconstruction tests on the synthetic torus."""

import jax.numpy as jnp
import numpy as np

from grmonty.ops import fluid, geometry, tetrads


def _setup(torus_model):
    mc = fluid.make_model_consts(torus_model)
    prims = jnp.asarray(torus_model.data.stacked())
    zone_x, g_cov, g_con, g_det = fluid.precompute_zone_geometry(mc)
    return mc, prims, zone_x, g_cov, g_con, g_det


def test_u_normalization(torus_model):
    """u.u = -1 for the reconstructed 4-velocity in every zone."""
    mc, prims, zone_x, g_cov, g_con, _ = _setup(torus_model)
    fz = fluid.get_fluid_zone(prims, g_cov, g_con, mc)
    norm = np.asarray(tetrads.dot(fz.u_con, fz.u_con, g_cov))
    np.testing.assert_allclose(norm, -1.0, atol=1e-10)


def test_b_orthogonal_to_u(torus_model):
    """b.u = 0 by construction of the magnetic 4-vector."""
    mc, prims, zone_x, g_cov, g_con, _ = _setup(torus_model)
    fz = fluid.get_fluid_zone(prims, g_cov, g_con, mc)
    bu = np.asarray(jnp.einsum("...i,...ij,...j->...", fz.b_con, g_cov, fz.u_con))
    scale = np.abs(np.asarray(fz.b_con)).max(-1) + 1e-30
    np.testing.assert_allclose(bu / scale, 0.0, atol=1e-9)


def test_params_match_zone_at_centers(torus_model):
    """Bilinear interpolation at zone centers reproduces the zone state."""
    mc, prims, zone_x, g_cov, g_con, _ = _setup(torus_model)
    fz = fluid.get_fluid_zone(prims, g_cov, g_con, mc)

    # interior zone centers (avoid the clamped boundary ring)
    idx = [(10, 10), (31, 16), (50, 5), (20, 25)]
    for i, j in idx:
        x = zone_x[i, j]
        fp = fluid.get_fluid_params(x, g_cov[i, j], prims, mc)
        assert np.isclose(float(fp.n_e), float(fz.n_e[i, j]), rtol=1e-8)
        assert np.isclose(float(fp.theta_e), float(fz.theta_e[i, j]), rtol=1e-8)
        assert np.isclose(float(fp.b), float(fz.b[i, j]), rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(fp.u_con), np.asarray(fz.u_con[i, j]), rtol=1e-7, atol=1e-12
        )


def test_outside_grid_sentinel(torus_model):
    """n_e = 0 outside the grid (harm_model.cpp:599-603)."""
    mc, prims, zone_x, g_cov_z, _, _ = _setup(torus_model)
    x = jnp.array([0.0, mc.x_stop[1] + 1.0, 0.5, 0.0])
    g_cov = geometry.gcov(x, mc.a, mc.h_slope, mc.r_0)
    fp = fluid.get_fluid_params(x, g_cov, prims, mc)
    assert float(fp.n_e) == 0.0


def test_zone_geometry_det(torus_model):
    """sqrt|det g| from linalg matches an independent product formula check."""
    mc, prims, zone_x, g_cov, g_con, g_det = _setup(torus_model)
    # det(g_cov) * det(g_con) == 1
    d1 = np.linalg.det(np.asarray(g_cov))
    d2 = np.linalg.det(np.asarray(g_con))
    np.testing.assert_allclose(d1 * d2, 1.0, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(g_det), np.sqrt(np.abs(d1)), rtol=1e-12)


def test_geom_blend_accuracy(torus_model):
    """The gather-everything geometry blend (biquadratic connection with
    pole regularization + bilinear fluid) tracks the analytic connection
    and the reference-style interpolated fluid on a coarse 64x32 grid;
    production grids (256^2) are ~2 orders of magnitude finer still."""
    mc, prims, zone_x, g_cov_z, g_con_z, _ = _setup(torus_model)
    fz = fluid.get_fluid_zone(prims, g_cov_z, g_con_z, mc)
    geom9 = jnp.asarray(fluid.pack_geom9(fluid.make_geom_table(mc, fz),
                                         mc.n1, mc.n2))
    rng = np.random.default_rng(3)
    n = 4096
    x1 = jnp.asarray(rng.uniform(mc.x_start[1] + mc.dx[1],
                                 mc.x_stop[1] - mc.dx[1], n))
    x2 = jnp.asarray(rng.uniform(mc.x_start[2] + mc.dx[2],
                                 mc.x_stop[2] - mc.dx[2], n))
    conn_b, flu_b, inside = fluid.blend_geom_rows(geom9, x1, x2, mc)
    assert bool(np.asarray(inside).all())

    conn_a = np.stack([np.asarray(c) for c in
                       geometry.connection_c(x1, x2, mc.a, mc.h_slope)])
    scale = np.abs(conn_a).max(axis=0) + 1e-12
    err = (np.abs(np.asarray(conn_b) - conn_a) / scale).max(axis=0)
    assert np.median(err) < 2e-3
    assert np.percentile(err, 99) < 5e-2
    assert err.max() < 0.2

    # fluid block vs the reference-style bilinear primitive interpolation
    x = jnp.stack([jnp.zeros_like(x1), x1, x2, jnp.zeros_like(x1)], axis=-1)
    g_cov = geometry.gcov(x, mc.a, mc.h_slope, mc.r_0)
    fp = fluid.get_fluid_params(x, g_cov, prims, mc)
    ne_b = np.asarray(flu_b[0])
    ne_a = np.asarray(fp.n_e)
    m = ne_a > 0
    # interp-of-derived vs derive-of-interp: both second order; agree to a
    # few percent wherever there is plasma
    rel = np.abs(ne_b[m] - ne_a[m]) / (ne_a[m] + 1e-300)
    assert np.median(rel) < 0.05
    ucov_b = np.stack([np.asarray(flu_b[3 + i]) for i in range(4)], axis=-1)
    du = np.abs(ucov_b - np.asarray(fp.u_cov)).max(-1)
    assert np.median(du / (np.abs(np.asarray(fp.u_cov)).max(-1) + 1e-30)) < 0.02


def test_mxu_transpose_rows_exact(torus_model):
    """The one-hot dot transpose is bitwise the plain transpose.

    (EngineConfig.mxu_extract relies on this: the layout change must not
    perturb the gathered corner rows at all.)"""
    mc, prims, *_ = _setup(torus_model)
    table = jnp.asarray(
        fluid.make_corner_table(np.asarray(prims), mc.n1, mc.n2), jnp.float32)
    idx = jnp.asarray([0, 7, 129, mc.n1 * mc.n2 - 1, 512], jnp.int32)
    rows = table[idx]
    rt = fluid.onehot_transpose(rows)
    assert rt.shape == (32, idx.shape[0])
    np.testing.assert_array_equal(np.asarray(rt), np.asarray(rows).T)


def test_params_mxu_matches_column_path(torus_model):
    """get_fluid_params_c(mxu=True) == the column-extraction path.

    The blend applies identical products/sums in identical order, so the
    only permitted difference is compiler FMA contraction — bounded to a
    few ulps here."""
    mc, prims, *_ = _setup(torus_model)
    table = jnp.asarray(
        fluid.make_corner_table(np.asarray(prims), mc.n1, mc.n2), jnp.float32)
    rng = np.random.default_rng(7)
    n = 257
    x1 = jnp.asarray(rng.uniform(mc.x_start[1], mc.x_stop[1], n), jnp.float32)
    x2 = jnp.asarray(rng.uniform(mc.x_start[2], mc.x_stop[2], n), jnp.float32)
    a = fluid.get_fluid_params_c(x1, x2, table, mc, mxu=False)
    b = fluid.get_fluid_params_c(x1, x2, table, mc, mxu=True)
    for fa, fb in zip(a, b):
        for ca, cb in zip(jnp.atleast_1d(fa) if not isinstance(fa, tuple) else fa,
                          jnp.atleast_1d(fb) if not isinstance(fb, tuple) else fb):
            np.testing.assert_allclose(np.asarray(ca), np.asarray(cb),
                                       rtol=5e-6, atol=0.0)
