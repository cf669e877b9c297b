"""GPU bring-up: what stays testable on the CPU.

The checks chip_smoke.py runs on the card (device refusal, the numerics
helpers, the sharded comparison's statistics), the compile-cache placement,
the benchmark's peak table, and the matrix products whose precision is
pinned (a float32 product at default precision may run in TF32 on a GPU,
which a CPU run cannot show; these tests hold each call site to float64
numpy at float32 tolerance).  The gpu-marked cases rerun the numerics
helpers on the card.
"""

import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench_micro
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)


# ----------------------------------------------------------------------
# compile cache
# ----------------------------------------------------------------------
@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, it is the cache and the package
    sets none; unset, the cache sits at <checkout>/.cache/jax/<host>."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import grmonty, jax; print(jax.config.jax_compilation_cache_dir);"
            " print(grmonty.default_cache_dir())")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    used, default = out[-2], out[-1]
    if env_dir:
        assert used == str(tmp_path / env_dir)
    else:
        assert used == default
        assert os.path.dirname(default) == os.path.join(REPO, ".cache", "jax")


# ----------------------------------------------------------------------
# chip_smoke: device refusal and gate helpers
# ----------------------------------------------------------------------
def test_device_info_refuses_cpu():
    with pytest.raises(chip_smoke.PhaseFailed, match="no GPU"):
        chip_smoke.device_info(jax.devices("cpu"))


def test_device_info_reports_gpu():
    fake = [types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    assert chip_smoke.device_info(fake) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_chip_smoke_fails_without_gpu(capsys):
    """On a CPU-only machine the script raises before any phase and prints
    no result line."""
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_lum_and_sigma():
    from grmonty.transport import engine

    spec = np.zeros((engine.N_BINS + 1, engine.N_SPEC_CHAN))
    spec[:4, 1] = [1.0, 2.0, 3.0, 4.0]
    spec[:4, 13] = [1.0, 4.0, 9.0, 16.0]
    spec[engine.N_BINS, 1] = 1e9  # the overflow row is not counted
    lum, sig = chip_smoke.lum_and_sigma(spec)
    assert lum == 10.0
    assert sig == pytest.approx(math.sqrt(30.0) / 10.0)


# ----------------------------------------------------------------------
# benchmark peak table
# ----------------------------------------------------------------------
def test_hbm_peak_known_device():
    assert bench_micro.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_hbm_peak_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peak"):
        bench_micro.hbm_peak(kind)


# ----------------------------------------------------------------------
# pinned-precision call sites against float64 numpy
# ----------------------------------------------------------------------
def test_cheb_eval2d_matches_float64():
    """cheb.eval2d (the hot loop's hotcross surrogate product) in float32
    against numpy's float64 Chebyshev series."""
    from grmonty.ops import cheb

    rng = np.random.default_rng(3)
    c = rng.normal(size=(41, 31)) / (1.0 + np.add.outer(np.arange(41),
                                                         np.arange(31)))
    x = rng.uniform(-2.0, 3.0, 2048)
    y = rng.uniform(1.0, 4.0, 2048)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    got = np.asarray(cheb.eval2d(f32(c), f32(x), f32(y), -2.0, 3.0, 1.0, 4.0),
                     np.float64)
    xs = np.float32(x).astype(np.float64)
    ys = np.float32(y).astype(np.float64)
    tx = (2.0 * xs - 1.0) / 5.0
    ty = (2.0 * ys - 5.0) / 3.0
    c64 = np.float32(c).astype(np.float64)
    ref = np.polynomial.chebyshev.chebval2d(tx, ty, c64)
    # |T_i| <= 1 on the fit domain, so sum |c| bounds every term's size.
    assert np.all(np.abs(got - ref) <= 64 * EPS32 * np.abs(c64).sum())


def test_four_vectors_matches_float64():
    """fluid._four_vectors (the v.g.v contraction) in float32 against the
    same reconstruction in float64 numpy."""
    from grmonty.ops import fluid

    g_cov, g_con = _metric_pair(512)
    rng = np.random.default_rng(5)
    v = rng.normal(0.0, 0.1, (512, 3)).astype(np.float32)
    bp = rng.normal(0.0, 0.1, (512, 3)).astype(np.float32)
    mc = types.SimpleNamespace(b_unit=1.0)
    u_con = np.asarray(fluid._four_vectors(
        jnp.asarray(v), jnp.asarray(bp), jnp.asarray(g_cov),
        jnp.asarray(g_con), mc)[0], np.float64)
    g64, gc64, v64 = (np.asarray(a, np.float64) for a in (g_cov, g_con, v))
    vv = np.einsum("ni,nij,nj->n", v64, g64[:, 1:, 1:], v64)
    vfac = np.sqrt(-1.0 / gc64[:, 0, 0] * (1.0 + np.abs(vv)))
    ref = np.concatenate([np.zeros((512, 1)), v64], 1) - vfac[:, None] * gc64[:, 0]
    ref[:, 0] = -vfac * gc64[:, 0, 0]
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(u_con - ref) <= 64 * EPS32 * scale)


def _metric_pair(n):
    """float32 (g_cov, g_con) at n random points of the Kerr domain the
    tetrad checks use."""
    from grmonty.ops import geometry

    rng = np.random.default_rng(9)
    x = np.zeros((n, 4))
    x[:, 1] = rng.uniform(math.log(2.5), math.log(50.0), n)
    x[:, 2] = rng.uniform(0.1, 0.9, n)
    g_cov = np.asarray(geometry.gcov(jnp.asarray(x), 0.9375, 0.3, 0.0), np.float32)
    g_con = np.asarray(geometry.gcon(jnp.asarray(x), 0.9375, 0.3, 0.0), np.float32)
    return g_cov, g_con


# ----------------------------------------------------------------------
# chip_smoke numerics helpers at small widths (CPU) and on the card
# ----------------------------------------------------------------------
def _tables(rng):
    corner = rng.normal(size=(300, 32))
    corner[rng.random(corner.shape) < 0.05] = -0.0  # signed zeros allowed
    derived = rng.normal(size=(300, 44))
    stag = rng.normal(size=(300, 17))
    stag[:, 16] = rng.integers(0, 2, 300)
    return {"corner_rows": corner, "hot_tab": derived, "refill_rows": stag}


HELPERS = {
    "hotcross": lambda n, dev: chip_smoke.check_hotcross(n, dev),
    "onehot": lambda n, dev: chip_smoke.check_onehot(
        _tables(np.random.default_rng(2)), n, dev),
    "tetrads": lambda n, dev: chip_smoke.check_tetrads(n, dev),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_numerics_helpers_cpu(name):
    res = HELPERS[name](512, jax.devices("cpu")[0])
    assert res


@pytest.mark.parametrize("width", [17, 32, 44])
def test_onehot_transpose_exact_widths(width):
    from grmonty.ops import fluid

    rows = np.random.default_rng(width).normal(size=(257, width)).astype(np.float32)
    got = np.asarray(fluid.onehot_transpose(jnp.asarray(rows)))
    assert got.shape == (width, 257)
    np.testing.assert_array_equal(got, rows.T)


def test_onehot_check_rejects_a_wrong_transpose(monkeypatch):
    """The one-hot gate fails when the product is not exact."""
    from grmonty.ops import fluid

    monkeypatch.setattr(fluid, "onehot_transpose",
                        lambda r: (r * (1.0 + 1e-3)).T)
    with pytest.raises(chip_smoke.PhaseFailed, match="one-hot"):
        chip_smoke.check_onehot(_tables(np.random.default_rng(4)), 64,
                                jax.devices("cpu")[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(HELPERS))
def test_numerics_helpers_gpu(name, gpu_device):
    res = HELPERS[name](chip_smoke.BENCH_POOL, gpu_device)
    assert res
