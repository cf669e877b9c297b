"""Chebyshev surrogate accuracy vs the exact table lookups they replace."""

import numpy as np
import jax.numpy as jnp

from grmonty import consts
from grmonty.ops import cheb, hotcross, jnu


def test_fit1d_exactness():
    c = cheb.fit1d(lambda x: 3.0 + 2.0 * x - x**2, -1.0, 4.0, deg=6)
    x = np.linspace(-1.0, 4.0, 101)
    y = np.asarray(cheb.eval1d(c, jnp.asarray(x), -1.0, 4.0))
    assert np.abs(y - (3.0 + 2.0 * x - x**2)).max() < 1e-12


def test_fit2d_exactness():
    c = cheb.fit2d(lambda x, y: x * y + y**2, 0.0, 2.0, -1.0, 1.0, 5, 5)
    x = np.linspace(0.0, 2.0, 17)
    y = np.linspace(-1.0, 1.0, 13)
    xv, yv = np.meshgrid(x, y, indexing="ij")
    got = np.asarray(
        cheb.eval2d(jnp.asarray(c), jnp.asarray(xv.ravel()), jnp.asarray(yv.ravel()),
                    0.0, 2.0, -1.0, 1.0)
    )
    assert np.abs(got - (xv * yv + yv**2).ravel()).max() < 1e-10


def test_hotcross_surrogate_matches_table(hotcross_table, rng):
    coeffs = cheb.fit_hotcross(hotcross_table)
    n = 4096
    w = 10.0 ** rng.uniform(np.log10(1e-10), np.log10(1e4), n)
    th = 10.0 ** rng.uniform(np.log10(2e-4), np.log10(5e3), n)
    exact = np.asarray(hotcross.lookup(jnp.asarray(w), jnp.asarray(th),
                                       jnp.asarray(hotcross_table)))
    fit = np.asarray(cheb.hotcross_eval(jnp.asarray(w), jnp.asarray(th),
                                        jnp.asarray(coeffs)))
    rel = np.abs(fit / exact - 1.0)
    # bilinear-vs-spline difference dominates; both approximate the same
    # integral — the MC acceptance bar is ~1% per spectral bin
    assert np.median(rel) < 2e-3
    assert rel.max() < 3e-2


def test_hotcross_surrogate_fallback_branches(hotcross_table):
    coeffs = jnp.asarray(cheb.fit_hotcross(hotcross_table))
    # Thomson branch
    s = float(cheb.hotcross_eval(jnp.asarray(1e-9), jnp.asarray(0.5), coeffs))
    assert s == consts.SIGMA_THOMSON
    # cold branch
    w = jnp.asarray(0.1)
    got = float(cheb.hotcross_eval(w, jnp.asarray(1e-5), coeffs))
    ref = float(hotcross.lookup(w, jnp.asarray(1e-5), jnp.asarray(hotcross_table)))
    assert got == ref


def test_k2_surrogate_matches_table(jnu_tables, rng):
    _, k2_table = jnu_tables
    coeffs = cheb.fit_k2()
    th = 10.0 ** rng.uniform(np.log10(0.31), np.log10(99.0), 4096)
    exact = np.asarray(jnu.k2_eval(jnp.asarray(th), jnp.asarray(k2_table)))
    fit = np.asarray(cheb.k2_eval(jnp.asarray(th), coeffs))
    rel = np.abs(fit / exact - 1.0)
    assert rel.max() < 2e-3
    # branch parity below/above the table
    for t in (0.1, 0.299, 150.0, 1e3):
        e = float(jnu.k2_eval(jnp.asarray(t), jnp.asarray(k2_table)))
        f = float(cheb.k2_eval(jnp.asarray(t), coeffs))
        assert f == e or abs(f / (e + 1e-300) - 1.0) < 2e-3
