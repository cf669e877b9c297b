"""Tetrad construction and frame-transform tests."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from grmonty.ops import fluid, geometry, tetrads

A = 0.9375
H_SLOPE = 0.3

ETA = np.diag([-1.0, 1.0, 1.0, 1.0])


def _setup(n=32):
    rng = np.random.default_rng(11)
    x = np.zeros((n, 4))
    x[:, 1] = rng.uniform(math.log(2.5), math.log(50.0), n)
    x[:, 2] = rng.uniform(0.1, 0.9, n)
    x = jnp.asarray(x)
    g_cov = geometry.gcov(x, A, H_SLOPE, 0.0)
    g_con = geometry.gcon(x, A, H_SLOPE, 0.0)

    # A guaranteed-timelike u via the HARM velocity-primitive reconstruction
    # (valid even inside the ergosphere, unlike naive (1, v) guesses).
    v_sp = jnp.asarray(rng.normal(0, 0.1, (n, 3)))
    v_dot_v = jnp.einsum("ni,nij,nj->n", v_sp, g_cov[:, 1:, 1:], v_sp)
    v_fac = jnp.sqrt(-1.0 / g_con[:, 0, 0] * (1.0 + jnp.abs(v_dot_v)))
    u = jnp.concatenate([jnp.zeros((n, 1)), v_sp], axis=1) - v_fac[:, None] * g_con[:, 0, :]
    u = u.at[:, 0].set(-v_fac * g_con[:, 0, 0])
    trial = jnp.asarray(rng.normal(size=(n, 4)))
    return x, g_cov, g_con, u, trial


def test_tetrad_orthonormality():
    x, g_cov, g_con, u, trial = _setup()
    e_con, e_cov = tetrads.make_tetrad(u, trial, g_cov)
    # g_{ij} e_mu^i e_nu^j = eta_{mu nu}
    gram = jnp.einsum("nmi,nij,nkj->nmk", e_con, g_cov, e_con)
    np.testing.assert_allclose(
        np.asarray(gram), np.broadcast_to(ETA, gram.shape), atol=1e-8
    )


def test_tetrad_round_trip():
    x, g_cov, g_con, u, trial = _setup()
    e_con, e_cov = tetrads.make_tetrad(u, trial, g_cov)
    k = jnp.asarray(np.random.default_rng(2).normal(size=u.shape))
    k_tet = tetrads.coordinate_to_tetrad(e_cov, k)
    k_back = tetrads.tetrad_to_coordinate(e_con, k_tet)
    # Error scales with the tetrad conditioning (random trial vectors can be
    # nearly parallel to u; physical trials are field directions and benign).
    scale = 1.0 + np.abs(np.asarray(e_cov)).max(axis=(1, 2), keepdims=True)
    err = np.abs(np.asarray(k_back) - np.asarray(k)) / scale[:, 0, :]
    assert err.max() < 1e-9


def test_tetrad_e0_is_u():
    x, g_cov, g_con, u, trial = _setup()
    e_con, _ = tetrads.make_tetrad(u, trial, g_cov)
    np.testing.assert_allclose(np.asarray(e_con[:, 0]), np.asarray(u), atol=1e-8)


def test_degenerate_trial_falls_back():
    x, g_cov, g_con, u, _ = _setup(4)
    trial = jnp.zeros_like(u)
    e_con, e_cov = tetrads.make_tetrad(u, trial, g_cov)
    gram = jnp.einsum("nmi,nij,nkj->nmk", e_con, g_cov, e_con)
    np.testing.assert_allclose(
        np.asarray(gram), np.broadcast_to(ETA, gram.shape), atol=1e-8
    )


def test_lower_matches_einsum():
    x, g_cov, g_con, u, _ = _setup(8)
    v_cov = tetrads.lower(u, g_cov)
    expected = jnp.einsum("nij,nj->ni", g_cov, u)
    np.testing.assert_allclose(np.asarray(v_cov), np.asarray(expected))


def test_boost_preserves_minkowski_norm():
    rng = np.random.default_rng(4)
    n = 64
    # timelike u in flat space
    sp = rng.normal(0, 0.5, (n, 3))
    g = np.sqrt(1.0 + (sp**2).sum(-1))
    u = jnp.asarray(np.concatenate([g[:, None], sp], axis=1))
    # null photon vectors
    kv = rng.normal(size=(n, 3))
    k0 = np.sqrt((kv**2).sum(-1))
    k = jnp.asarray(np.concatenate([k0[:, None], kv], axis=1))

    kp = tetrads.boost(k, u)
    norm = -np.asarray(kp[:, 0]) ** 2 + (np.asarray(kp[:, 1:]) ** 2).sum(-1)
    np.testing.assert_allclose(norm, 0.0, atol=1e-9)
    # boosting into the frame of u: energy = -eta u k
    e_expected = np.asarray(
        u[:, 0] * k[:, 0] - jnp.sum(u[:, 1:] * k[:, 1:], axis=1)
    )
    np.testing.assert_allclose(np.asarray(kp[:, 0]), e_expected, rtol=1e-12)
