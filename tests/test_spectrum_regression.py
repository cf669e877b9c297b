"""Fixed-input golden-spectrum regression (SURVEY §7 stage 9).

A deterministic small CPU run is compared against committed golden
statistics.  A fixed seed does NOT reproduce bitwise across hosts:
trajectories are chaotic, so any FP-codegen difference (compiler version,
AVX512 vs AVX2 reassociation) exponentially diverges individual photons and
the run re-randomizes.  What IS host-stable is the statistics — so the
golden stores the per-group mean and standard deviation over several
independent seeds, and the test gates the current host's single run against
that measured scatter.  The Compton bands' weighted sums are dominated by a
few heavy superphotons (weight spread of decades), which is exactly what
the seed-to-seed std captures and a Poisson-count tolerance would not.

Regenerate after an *intentional* physics change with:
    python tests/test_spectrum_regression.py --regen
and justify the diff in the commit message.
"""

import json
import os
import sys

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "spectrum_torus64x32.json")

RUN = dict(photon_n=180, mass_unit=4.0e18)
REGEN_SEEDS = (123, 207, 311, 401, 509, 613, 701, 811)


def _run(seed=123):
    from grmonty import consts
    from grmonty.models import torus
    from grmonty.transport import driver, engine

    import tempfile

    d = tempfile.mkdtemp()
    path = os.path.join(d, "torus_dump")
    torus.write_torus_dump(path, n1=64, n2=32)
    cfg = engine.EngineConfig(
        n_pool=256, m_period=8, sec_cap=4096, max_outer=40000, stall_steps=40000
    )
    sim = driver.Simulation(path, config=cfg, emit_chunk=2048, warmup=128,
                            seed=seed, **RUN)
    spec, stats = sim.run()

    nb = consts.N_TH_BINS * consts.N_E_BINS
    e_by_bin = spec[:nb, 1].reshape(consts.N_TH_BINS, consts.N_E_BINS).sum(0)
    n_by_bin = spec[:nb, 2].reshape(consts.N_TH_BINS, consts.N_E_BINS).sum(0)
    g = 25  # coarse groups of 25 energy bins
    e_g = e_by_bin[: (200 // g) * g].reshape(-1, g).sum(1)
    n_g = n_by_bin[: (200 // g) * g].reshape(-1, g).sum(1)
    return {
        "luminosity_w": float(spec[:nb, 1].sum()),
        "n_created": int(stats["n_created"]),
        "n_recorded": int(stats["n_recorded"]),
        "n_scatt_recorded": int(stats["n_scatt_recorded"]),
        "coarse_e": [float(v) for v in e_g],
        "coarse_n": [float(v) for v in n_g],
    }


def _regen():
    runs = [_run(seed=s) for s in REGEN_SEEDS]
    e = np.asarray([r["coarse_e"] for r in runs])
    n = np.asarray([r["coarse_n"] for r in runs])
    lum = np.asarray([r["luminosity_w"] for r in runs])
    rec = np.asarray([r["n_recorded"] for r in runs], float)
    scat = np.asarray([r["n_scatt_recorded"] for r in runs], float)
    return {
        "seeds": list(REGEN_SEEDS),
        "n_created": runs[0]["n_created"],
        "luminosity_mean": float(lum.mean()),
        "luminosity_std": float(lum.std(ddof=1)),
        "n_recorded_mean": float(rec.mean()),
        "n_recorded_std": float(rec.std(ddof=1)),
        "n_scatt_recorded_mean": float(scat.mean()),
        "n_scatt_recorded_std": float(scat.std(ddof=1)),
        "coarse_e_mean": [float(v) for v in e.mean(0)],
        "coarse_e_std": [float(v) for v in e.std(0, ddof=1)],
        "coarse_n_mean": [float(v) for v in n.mean(0)],
        "coarse_n_std": [float(v) for v in n.std(0, ddof=1)],
    }


@pytest.fixture(scope="module")
def current():
    return _run(seed=123)


@pytest.fixture(scope="module")
def gold():
    assert os.path.exists(GOLDEN), (
        "run `python tests/test_spectrum_regression.py --regen`")
    with open(GOLDEN) as f:
        return json.load(f)


def _gate(value, mean, std, n_sigma, rel_floor):
    """|value - mean| <= max(n_sigma * std, rel_floor * |mean|)."""
    tol = max(n_sigma * std, rel_floor * abs(mean))
    return abs(value - mean) <= tol, tol


def test_luminosity(current, gold):
    assert current["n_created"] == gold["n_created"]
    ok, tol = _gate(current["luminosity_w"], gold["luminosity_mean"],
                    gold["luminosity_std"], n_sigma=3.5, rel_floor=0.05)
    assert ok, (
        f"luminosity {current['luminosity_w']:.4e} outside "
        f"{gold['luminosity_mean']:.4e} +- {tol:.2e}")


def test_accounting(current, gold):
    ok, tol = _gate(current["n_recorded"], gold["n_recorded_mean"],
                    gold["n_recorded_std"], n_sigma=5.0, rel_floor=0.05)
    assert ok, (
        f"n_recorded {current['n_recorded']} outside "
        f"{gold['n_recorded_mean']:.0f} +- {tol:.0f}")
    ok, tol = _gate(current["n_scatt_recorded"],
                    gold["n_scatt_recorded_mean"],
                    gold["n_scatt_recorded_std"], n_sigma=5.0, rel_floor=0.10)
    assert ok, (
        f"n_scatt_recorded {current['n_scatt_recorded']} outside "
        f"{gold['n_scatt_recorded_mean']:.0f} +- {tol:.0f}")


def test_spectrum_shape(current, gold):
    e_now = np.asarray(current["coarse_e"])
    e_mean = np.asarray(gold["coarse_e_mean"])
    e_std = np.asarray(gold["coarse_e_std"])
    n_mean = np.asarray(gold["coarse_n_mean"])
    use = n_mean >= 50
    assert use.any()
    # 5-sigma of the measured seed-to-seed scatter, floored at 10% of the
    # band mean: catches a global factor error (sqrt(2) = 41%) on the
    # well-populated synchrotron peak, tolerates re-randomization of the
    # heavy-tailed Compton bands.
    tol = np.maximum(5.0 * e_std[use], 0.10 * np.abs(e_mean[use]))
    bad = np.abs(e_now[use] - e_mean[use]) > tol
    assert not bad.any(), (
        f"groups {np.nonzero(use)[0][bad]} drifted beyond 5 sigma: "
        f"now={e_now[use][bad]}, mean={e_mean[use][bad]}, tol={tol[bad]}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        data = _regen()
        with open(GOLDEN, "w") as f:
            json.dump(data, f, indent=2)
        print(f"golden written to {GOLDEN}")
        print(json.dumps(data, indent=2)[:600])
    else:
        print(__doc__)
