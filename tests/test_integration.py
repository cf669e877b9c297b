"""Adaptive quadrature tests.

Mirror of the reference's integration suite
(``cuda_grmonty/tests/integration_test.cpp:18-116``): the same ten analytic
integrals at 1e-6 tolerance.
"""

import math

import numpy as np
import pytest

from grmonty.ops.integration import adaptive_gauss_quad

CASES = [
    ("const", lambda x: np.full_like(x, 3.0), 0.0, 2.0, 6.0),
    ("linear", lambda x: x, 0.0, 1.0, 0.5),
    ("square", lambda x: x * x, 0.0, 1.0, 1.0 / 3.0),
    ("sin", np.sin, 0.0, math.pi, 2.0),
    ("abs", np.abs, -1.0, 1.0, 1.0),
    ("sqrt", np.sqrt, 0.0, 1.0, 2.0 / 3.0),
    ("log", np.log, 1.0, math.e, 1.0),
    ("osc20", lambda x: np.sin(20.0 * x), 0.0, math.pi, (1.0 - math.cos(20.0 * math.pi)) / 20.0),
    ("peak", lambda x: 1.0 / (1.0e-4 + x * x), -1.0, 1.0, 2.0 / 1.0e-2 * math.atan(1.0 / 1.0e-2)),
    ("step", lambda x: (x > 0.5).astype(float), 0.0, 1.0, 0.5),
]


@pytest.mark.parametrize("name,f,a,b,expected", CASES, ids=[c[0] for c in CASES])
def test_analytic_integrals(name, f, a, b, expected):
    got = adaptive_gauss_quad(f, a, b, eps_abs=0.0, eps_rel=1.0e-9, limit=2000)
    assert got == pytest.approx(expected, rel=1.0e-6, abs=1.0e-6)


def test_empty_interval():
    assert adaptive_gauss_quad(np.sin, 1.0, 1.0) == 0.0


def test_matches_scipy():
    import scipy.integrate

    f = lambda x: np.exp(-np.cbrt(x)) * np.sqrt(x)
    ours = adaptive_gauss_quad(f, 0.0, 50.0, eps_rel=1e-9)
    ref, _ = scipy.integrate.quad(f, 0.0, 50.0, epsrel=1e-10)
    assert ours == pytest.approx(ref, rel=1e-8)
