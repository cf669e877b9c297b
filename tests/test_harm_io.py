"""HARM dump I/O tests.

Mirror of the reference's golden-file fixture
(``cuda_grmonty/tests/harm_model_test.cpp``): write a synthetic dump, read
it back, and assert every header field and all 8 primitive arrays round-trip.
"""

import math

import numpy as np
import pytest

from grmonty.models import harm


def _sample_header():
    h = harm.Header()
    h.t = 1.0
    h.n = (2, 3)
    h.x_start = (0.0, 4.0, 5.0, 0.0)
    h.dx = (1.0, 8.0, 9.0, 2.0 * math.pi)
    h.x_stop = (1.0, 4.0 + 2 * 8.0, 5.0 + 3 * 9.0, 2.0 * math.pi)
    h.t_final = 10.0
    h.n_step = 11
    h.a = 0.5
    h.gamma = 13.0 / 9.0
    h.courant = 14.0
    h.dt_dump = 15.0
    h.dt_log = 16.0
    h.dt_img = 17.0
    h.dt_rdump = 18
    h.cnt_dump = 19
    h.cnt_img = 20
    h.cnt_rdump = 21
    h.dt = 22.0
    h.lim = 23
    h.failed = 24
    h.r_in = 25.0
    h.r_out = 26.0
    h.h_slope = 0.3
    h.r_0 = 0.0
    return h


def _sample_data(n1, n2, rng):
    arrs = [rng.uniform(0.5, 2.0, (n1, n2)) for _ in range(8)]
    return harm.Data(*arrs)


def test_round_trip(tmp_path, rng):
    h = _sample_header()
    data = _sample_data(*h.n, rng)
    extras = np.zeros((h.n[0] * h.n[1], 22))
    extras[:, 21] = 1.0  # unit g_det so bias_norm is finite
    path = str(tmp_path / "dump")
    harm.write_dump(path, h, data, extras)

    model = harm.read_dump(path, mass_unit=4.0e19)
    rh = model.header

    for field in ("t", "t_final", "a", "gamma", "courant", "dt_dump", "dt_log",
                  "dt_img", "dt", "r_in", "r_out", "h_slope", "r_0"):
        assert getattr(rh, field) == pytest.approx(getattr(h, field)), field
    for field in ("n", "n_step", "dt_rdump", "cnt_dump", "cnt_img", "cnt_rdump",
                  "lim", "failed"):
        assert getattr(rh, field) == getattr(h, field), field
    assert rh.x_start == pytest.approx(h.x_start)
    assert rh.x_stop == pytest.approx(h.x_stop)
    assert rh.dx == pytest.approx(h.dx)

    for name in ("k_rho", "u", "u_1", "u_2", "u_3", "b_1", "b_2", "b_3"):
        np.testing.assert_allclose(
            getattr(model.data, name), getattr(data, name), rtol=0, atol=0
        )


def test_derived_quantities(tmp_path, rng):
    h = _sample_header()
    data = _sample_data(*h.n, rng)
    extras = np.zeros((h.n[0] * h.n[1], 22))
    extras[:, 21] = 2.0
    path = str(tmp_path / "dump")
    harm.write_dump(path, h, data, extras)
    model = harm.read_dump(path, mass_unit=4.0e19)

    # Horizon radius and x1_min (harm_model.cpp:228-229).
    assert model.rh == pytest.approx(1.0 + math.sqrt(1.0 - h.a**2))
    assert model.x1_min == pytest.approx(math.log(model.rh))

    # bias_norm = volume-avg of (u/rho * theta_e_unit)^2 (harm_model.cpp:206,219)
    # with constant g_det it reduces to the plain average.
    expected = np.mean((data.u / data.k_rho * model.units.theta_e_unit) ** 2)
    assert model.bias_norm == pytest.approx(expected)


def test_units(tmp_path):
    u = harm.make_units(4.0e19)
    from grmonty import consts

    assert u.l_unit == pytest.approx(consts.G_NEWT * consts.M_BH / consts.CL**2)
    assert u.rho_unit == pytest.approx(4.0e19 / u.l_unit**3)
    assert u.b_unit == pytest.approx(consts.CL * math.sqrt(4 * math.pi * u.rho_unit))
    # theta_e_unit for gamma = 13/9 and tp/te = 3 (harm_model.cpp:139-141)
    te = harm.theta_e_unit(13.0 / 9.0)
    two_temp = 0.5 * ((1.0 + (2.0 / 3.0) * 4.0 / 5.0) + 13.0 / 9.0)
    assert te == pytest.approx((two_temp - 1.0) * (consts.MP / consts.ME) / 4.0)


def test_native_parser_matches_numpy():
    from grmonty.models import harmio_native

    text = "1.5 2e3 -0.25\n nan 7 "
    arr = harmio_native.parse_doubles(text)
    if arr is None:
        pytest.skip("native parser unavailable")
    expected = np.array([1.5, 2e3, -0.25, np.nan, 7.0])
    np.testing.assert_array_equal(np.isnan(arr), np.isnan(expected))
    np.testing.assert_allclose(arr[~np.isnan(arr)], expected[~np.isnan(expected)])


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        harm.read_dump("/nonexistent/path", 4.0e19)
