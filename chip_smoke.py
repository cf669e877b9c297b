#!/usr/bin/env python
"""Bring-up check: the shipped transport, compiled for one GPU, end to end.

Runs in one process, phase by phase, and stops at the first failure:

1. device    — JAX's platform, device kind and count, and the card's name
               and power limit as nvidia-smi reports them.  Anything but a
               GPU as JAX's first device fails the run.
2. main path — the bench deployment through ``driver.Simulation.run()`` and
               ``report()``: synthetic 256x256 torus, photon_n 1e6 (about
               15.9M superphotons), M_unit 4e19, float32, pool 65,536, the
               shipped profile (``profiles.bench_config`` +
               ``bench_sim_kwargs``), no checkpoint.  Gates: finite
               spectrum, luminosity > 0, no dropped secondary, no hotcross
               clamp hit.
3. numerics  — the engine's matrix products as compiled for the card, at
               the widths the engine uses, against float64 references: the
               hotcross Chebyshev surrogate against the exact table, the
               one-hot transposes against ``rows.T``, the tetrad transforms
               against numpy.
4. accuracy  — the engine at the shipped profile against the native C++
               oracle on the same 20,000 photons at frozen bias
               (``transport.accuracy``).

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A failed phase raises, so the script exits non-zero without that line.

    python chip_smoke.py                  # phases 1-4 on one card
    python chip_smoke.py --photon_n 2e5   # a shortened main path (says so)
    python chip_smoke.py --devices 4      # only the sharded path over four
                                          # cards and a one-card run of the
                                          # same budget, compared
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BENCH_PHOTON_N = 1_000_000
BENCH_POOL = 65536
MASS_UNIT = 4.0e19
SEED = 123

# Accuracy phase: the frozen-bias comparison recorded on the CPU in
# ACCURACY_r5_M4e19_frozen_sc06.json, with one oracle replicate.
GATE_PHOTONS = 20000
GATE_PHOTON_N = 2000
GATE_FREEZE = (0.0025, 2.6)

# Tolerances of the numerics phase.  The hotcross bounds are those of
# tests/test_cheb.py (the surrogate against the exact bilinear table).  A
# float32 contraction of n terms carries a rounding error below
# n * eps32 * sum(|terms|); TOL_ULPS bounds it with room for the order of
# summation, and is ~250x tighter than what a TF32 product (10-bit
# mantissa) can meet.
HC_MEDIAN_MAX, HC_MAX = 2e-3, 3e-2
TOL_ULPS = 16
EPS32 = float(2.0 ** -23)


class PhaseFailed(RuntimeError):
    """A gate of a phase did not hold."""


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def say(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------------
# 1. device
# ----------------------------------------------------------------------
def device_info(devices):
    """Platform, kind and count of a JAX device list; refuses a list whose
    first device is not a GPU (no phase may run on the CPU instead)."""
    d = devices[0]
    if d.platform != "gpu":
        raise PhaseFailed(
            f"no GPU: JAX's first device is {d.platform!r} "
            f"({d.device_kind}); this check runs only on the card")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ----------------------------------------------------------------------
# 2. main path
# ----------------------------------------------------------------------
def bench_simulation(photon_n, **extra):
    """The bench deployment as ``bench.py`` builds it, without its env knobs."""
    import bench
    from grmonty.transport import driver, profiles

    cfg = profiles.bench_config(pool=BENCH_POOL, env={})
    kw = profiles.bench_sim_kwargs(BENCH_POOL, env={})
    kw.update(extra)
    return driver.Simulation(bench.find_dump(), photon_n=photon_n,
                             mass_unit=MASS_UNIT, config=cfg, seed=SEED, **kw)


def peak_bytes():
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def main_path(photon_n):
    import numpy as np

    t0 = time.time()
    sim = bench_simulation(photon_n)
    setup_s = time.time() - t0
    spec, stats = sim.run()
    rows = sim.report(os.path.join(REPO, ".cache", "chip_smoke_spectrum"))
    peak = peak_bytes()
    say(f"main path: n_created {stats['n_created']}, table set-up "
        f"{setup_s:.1f} s")
    say(f"main path: wall rate {stats['photon_rate']} ph/s, device-window "
        f"rate {stats['photon_rate_device']} ph/s")
    say(f"main path: compile_s {stats['compile_s']}, elapsed_s "
        f"{stats['elapsed_s']}, device_s {stats['device_s']}")
    say(f"main path: n_recorded {stats['n_recorded']}, n_sec_drop "
        f"{stats['n_secondary_dropped']}, n_stall {stats['n_stall_killed']}, "
        f"n_hc_clamp {stats['n_hc_clamp']}, steps/photon "
        f"{stats['steps_per_photon']}")
    say(f"main path: peak_bytes_in_use {peak}, luminosity "
        f"{rows['luminosity']}")
    check(np.isfinite(np.asarray(spec)).all(), "spectrum is not finite")
    check(rows["luminosity"] > 0, f"luminosity {rows['luminosity']} <= 0")
    check(stats["n_secondary_dropped"] == 0,
          f"{stats['n_secondary_dropped']} secondaries dropped")
    check(stats["n_hc_clamp"] == 0,
          f"{stats['n_hc_clamp']} hotcross clamp hits")
    return sim


# ----------------------------------------------------------------------
# 3. numerics
# ----------------------------------------------------------------------
def check_hotcross(n, device, seed=0):
    """The hot loop's hotcross surrogate (float32, on ``device``) against
    the exact bilinear table lookup (float64, host CPU)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from grmonty.ops import cheb, hotcross
    from grmonty.utils import cache

    table = cache.hotcross_table()
    coeffs = cheb.fit_hotcross(np.asarray(table))
    rng = np.random.default_rng(seed)
    w = 10.0 ** rng.uniform(-10.0, 4.0, n)
    th = 10.0 ** rng.uniform(math.log10(2e-4), math.log10(5e3), n)
    put = lambda a: jax.device_put(np.asarray(a, np.float32), device)
    fit = np.asarray(jax.jit(cheb.hotcross_eval)(put(w), put(th),
                                                 put(coeffs)), np.float64)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        exact = np.asarray(hotcross.lookup(
            jnp.asarray(np.float32(w).astype(np.float64)),
            jnp.asarray(np.float32(th).astype(np.float64)),
            jnp.asarray(table)))
    rel = np.abs(fit / exact - 1.0)
    res = {"n": n, "dtype": "float32", "precision": "HIGHEST",
           "median_rel": float(np.median(rel)), "max_rel": float(rel.max()),
           "bounds": [HC_MEDIAN_MAX, HC_MAX]}
    check(res["median_rel"] < HC_MEDIAN_MAX and res["max_rel"] < HC_MAX,
          f"hotcross surrogate off the table: {res}")
    return res


def check_onehot(tables, n, device, seed=0):
    """``fluid.onehot_transpose`` on ``device`` against ``rows.T`` for rows
    gathered from each (Z, C) table: equal bit for bit, signed zeros
    aside (a sum that starts at +0.0 turns -0.0 into +0.0)."""
    import jax
    import numpy as np

    from grmonty.ops import fluid

    rng = np.random.default_rng(seed)
    tr = jax.jit(fluid.onehot_transpose)
    res = {}
    for name, tab in tables.items():
        tab = np.asarray(tab, np.float32)
        rows = tab[rng.integers(0, tab.shape[0], n)]
        got = np.asarray(tr(jax.device_put(rows, device)))
        ref = np.ascontiguousarray(rows.T)
        same = got.view(np.uint32) == ref.view(np.uint32)
        zeros = (got == 0) & (ref == 0)
        res[name] = {"shape": list(rows.shape), "precision": "HIGHEST",
                     "bit_mismatches": int((~same).sum()),
                     "signed_zero_only": int((~same & zeros).sum())}
        check(got.shape == ref.shape and bool((same | zeros).all()),
              f"one-hot transpose differs from rows.T for {name}: "
              f"{res[name]}")
    return res


def _tetrad_inputs(n, seed):
    """Float32 metrics, timelike four-velocities, field trials and photon
    wave vectors at ``n`` random points of a Kerr (a=0.9375) domain."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from grmonty.ops import geometry, tetrads

    rng = np.random.default_rng(seed)
    x = np.zeros((n, 4))
    x[:, 1] = rng.uniform(math.log(2.5), math.log(50.0), n)
    x[:, 2] = rng.uniform(0.1, 0.9, n)
    with jax.default_device(jax.devices("cpu")[0]):
        xj = jnp.asarray(x)
        g_cov = np.asarray(geometry.gcov(xj, 0.9375, 0.3, 0.0))
        g_con = np.asarray(geometry.gcon(xj, 0.9375, 0.3, 0.0))
        v = rng.normal(0.0, 0.1, (n, 3))
        vv = np.einsum("ni,nij,nj->n", v, g_cov[:, 1:, 1:], v)
        vfac = np.sqrt(-1.0 / g_con[:, 0, 0] * (1.0 + np.abs(vv)))
        u = np.concatenate([np.zeros((n, 1)), v], 1) - vfac[:, None] * g_con[:, 0]
        u[:, 0] = -vfac * g_con[:, 0, 0]
        trial = rng.normal(size=(n, 4))
        e_con, e_cov = (np.asarray(a) for a in tetrads.make_tetrad(
            jnp.asarray(u), jnp.asarray(trial), jnp.asarray(g_cov)))
    k = rng.normal(size=(n, 4))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(g_cov), f32(u), f32(e_con), f32(e_cov), f32(k)


def check_tetrads(n, device, seed=0):
    """The tetrad contractions (tetrads.lower / dot / coordinate_to_tetrad /
    tetrad_to_coordinate), float32 on ``device``, against numpy float64 of
    the same float32 inputs.  Each output may
    differ from the exact sum by TOL_ULPS * eps32 * sum(|terms|)."""
    import jax
    import numpy as np

    from grmonty.ops import tetrads

    g, u, e_con, e_cov, k = _tetrad_inputs(n, seed)
    d = lambda a: jax.device_put(a, device)
    f64 = lambda a: np.asarray(a, np.float64)
    cases = {
        "lower": (tetrads.lower, (u, g), "...ij,...j->...i", (g, u)),
        "dot": (tetrads.dot, (u, k, g), "...i,...ij,...j->...", (u, g, k)),
        "coordinate_to_tetrad": (tetrads.coordinate_to_tetrad, (e_cov, k),
                                 "...mj,...j->...m", (e_cov, k)),
        "tetrad_to_coordinate": (tetrads.tetrad_to_coordinate, (e_con, k),
                                 "...mi,...m->...i", (e_con, k)),
    }
    res = {}
    for name, (fn, args, spec, ref_args) in cases.items():
        got = f64(jax.jit(fn)(*(d(a) for a in args)))
        ref = np.einsum(spec, *(f64(a) for a in ref_args))
        mag = np.einsum(spec, *(np.abs(f64(a)) for a in ref_args))
        err = np.abs(got - ref) / np.maximum(mag, np.finfo(np.float32).tiny)
        res[name] = {"n": n, "dtype": "float32", "precision": "HIGHEST",
                     "max_err_ulps": float(err.max() / EPS32),
                     "bound_ulps": TOL_ULPS}
        check(np.isfinite(got).all() and err.max() <= TOL_ULPS * EPS32,
              f"tetrad contraction {name} off float64: {res[name]}")
    return res


def engine_widths(sim):
    """The tables whose rows the engine transposes: the corner table, the
    hot-step table (derived rows when the profile ships them) and the
    refill phase's (N, 17) staging rows, for which random rows with 0/1
    flags and integer counts stand in."""
    import numpy as np

    from grmonty.transport import engine

    rng = np.random.default_rng(1)
    stag = rng.normal(size=(4096, engine.ROW_WIDTH + 1))
    stag[:, engine.ROW_NSCATT] = rng.integers(0, 40, 4096)
    stag[:, engine.ROW_WIDTH] = rng.integers(0, 2, 4096)
    return {"corner_rows": sim._engine_tabs.corner_rows,
            "hot_tab": sim._engine_tabs.hot_tab, "refill_rows": stag}


def numerics(tables, n, device):
    out = {"hotcross": check_hotcross(n, device),
           "onehot": check_onehot(tables, n, device),
           "tetrads": check_tetrads(n, device)}
    for name, r in out.items():
        say(f"numerics {name}: {json.dumps(r)}")
    return out


# ----------------------------------------------------------------------
# 4. accuracy against the native oracle
# ----------------------------------------------------------------------
def accuracy_phase():
    from grmonty.models import torus
    from grmonty.transport import accuracy, driver

    dump = os.path.join(REPO, ".cache", "torus_64x32_dump")
    if not os.path.exists(dump):
        os.makedirs(os.path.dirname(dump), exist_ok=True)
        torus.write_torus_dump(dump, n1=64, n2=32)
    cfg, sim_kw = accuracy.gate_profile()
    cfg = cfg._replace(bias_fixed_tau=GATE_FREEZE[0],
                       bias_fixed_avg=GATE_FREEZE[1])
    sim = driver.Simulation(dump, photon_n=GATE_PHOTON_N, mass_unit=MASS_UNIT,
                            config=cfg, emit_chunk=4096, seed=SEED,
                            warmup=256, **sim_kw)
    out, _, _ = accuracy.compare_to_oracle(
        sim, GATE_PHOTONS, seed=SEED, oracle_reps=1, freeze_bias=GATE_FREEZE)
    dec = out["origin_decomp"]
    summary = {k: out[k] for k in (
        "n_engine", "engine_s", "oracle_s", "lum_ratio", "lum_ratio_rel_sigma",
        "chi2_per_dof", "dof", "rec_ratio", "n_hc_clamp_engine",
        "n_stall_engine")}
    summary.update(n_prim_engine=dec["n_prim_engine"],
                   n_prim_oracle=dec["n_prim_oracle"])
    say(f"accuracy: {json.dumps(summary)}")
    sig = out["lum_ratio_rel_sigma"]
    check(abs(out["lum_ratio"] - 1.0) < 3.0 * sig,
          f"lum_ratio {out['lum_ratio']} outside 1 +- 3 x {sig}")
    check(out["chi2_per_dof"] < 2.0, f"chi2/dof {out['chi2_per_dof']} >= 2")
    # Primaries never meet the scattering bias, so their count depends only
    # on the integrator: bit-exact on the CPU, within 1% on the GPU, whose
    # float32 transcendentals and FMA contraction differ in the last bits
    # and can flip a photon grazing the horizon or the recording radius.
    p_e, p_o = dec["n_prim_engine"], dec["n_prim_oracle"]
    check(abs(p_e - p_o) <= 0.01 * p_o,
          f"recorded primaries {p_e} vs oracle {p_o}: more than 1% apart")
    check(out["n_hc_clamp_engine"] == 0,
          f"{out['n_hc_clamp_engine']} hotcross clamp hits")
    return out


# ----------------------------------------------------------------------
# --devices N: the sharded path against one card
# ----------------------------------------------------------------------
def lum_and_sigma(spec):
    """Luminosity sum (channel 1) and its relative MC sigma (channel 13 is
    sum((w e)^2)) over the binned rows of an unscaled spectrum."""
    import numpy as np

    from grmonty.transport import engine

    s = np.asarray(spec)[: engine.N_BINS]
    lum = float(s[:, 1].sum())
    return lum, float(math.sqrt(s[:, 13].sum()) / max(lum, 1e-300))


def sharded_phase(n_dev, photon_n):
    import jax
    import numpy as np

    from grmonty.parallel import sharding
    from grmonty.transport import profiles

    devices = jax.devices()
    check(len(devices) >= n_dev, f"need {n_dev} devices, have {len(devices)}")
    import bench

    cfg = profiles.bench_config(pool=BENCH_POOL, env={})
    kw = profiles.bench_sim_kwargs(BENCH_POOL, env={})
    sim4 = sharding.ShardedSimulation(
        bench.find_dump(), photon_n=photon_n, mass_unit=MASS_UNIT,
        config=cfg, seed=SEED, n_devices=n_dev, devices=devices[:n_dev], **kw)
    spec4, st4 = sim4.run()
    spec1, st1 = bench_simulation(photon_n).run()
    (l4, s4), (l1, s1) = lum_and_sigma(spec4), lum_and_sigma(spec1)
    dlog = abs(math.log(l4 / l1))
    bound = 3.0 * math.hypot(s4, s1)
    for tag, st in ((f"{n_dev} cards", st4), ("1 card", st1)):
        say(f"sharded phase [{tag}]: n_created {st['n_created']}, n_recorded "
            f"{st['n_recorded']}, n_sec_drop {st['n_secondary_dropped']}, "
            f"n_hc_clamp {st['n_hc_clamp']}, elapsed_s {st['elapsed_s']}, "
            f"wall rate {st['photon_rate']} ph/s")
    say(f"sharded phase: |ln(L{n_dev}/L1)| {dlog} (bound {bound}; "
        f"rel sigma {s4} / {s1})")
    check(st4["n_created"] == st1["n_created"],
          f"n_created {st4['n_created']} != {st1['n_created']}")
    check(np.isfinite(spec4).all() and l4 > 0, "sharded spectrum invalid")
    check(dlog < bound, f"luminosities differ: |ln ratio| {dlog} >= {bound}")
    for st in (st4, st1):
        check(st["n_secondary_dropped"] == 0 and st["n_hc_clamp"] == 0,
              f"censuses not zero: {st}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--photon_n", type=float, default=BENCH_PHOTON_N,
                    help="photon budget of the main path (default: the bench "
                    "deployment's 1e6)")
    ap.add_argument("--devices", type=int, default=1,
                    help="with N > 1, run only the sharded path over N cards "
                    "and its one-card comparison")
    args = ap.parse_args(argv)
    photon_n = int(args.photon_n)

    sys.path.insert(0, REPO)
    import jax

    import grmonty  # noqa: F401  (x64, compile cache)
    from grmonty.utils.logging import setup

    t_all = time.time()
    dev = device_info(jax.devices())
    say(f"device: platform {dev['platform']}, kind {dev['kind']}, "
        f"count {dev['count']}")
    for line in nvidia_smi():
        say(f"card: {line}")

    setup("warning")
    if photon_n != BENCH_PHOTON_N:
        say(f"NOTE: shortened run, photon_n {photon_n} instead of "
            f"{BENCH_PHOTON_N}")

    if args.devices > 1:
        t = time.time()
        sharded_phase(args.devices, photon_n)
        say(f"phase sharded: passed in {time.time() - t:.1f} s")
    else:
        t = time.time()
        sim = main_path(photon_n)
        say(f"phase main path: passed in {time.time() - t:.1f} s")
        t = time.time()
        numerics(engine_widths(sim), BENCH_POOL, jax.devices()[0])
        say(f"phase numerics: passed in {time.time() - t:.1f} s")
        del sim
        t = time.time()
        accuracy_phase()
        say(f"phase accuracy: passed in {time.time() - t:.1f} s")
    say(f"all phases passed in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
