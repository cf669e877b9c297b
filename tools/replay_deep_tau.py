#!/usr/bin/env python
"""Deep-tau path-replay harness.

Question: the engine's recorded max_tau_scatt at M_unit=4e20 is 20-80x the
scalar oracle's seed-stable value (0.54 / 1.96 / 14.8 across seeds vs
0.025).  Are those deep-tau realizations the TRUE tail of the distribution
(admitted by the r4 patient samplers, merely unreachable by the oracle's
depth-first budget at this photon count), or do they carry residual
per-step trapezoid overestimates from GROWN steps (EngineConfig.grow_cap)?

Method: run the engine with ``EngineConfig.trace_birth`` — it captures the
BIRTH state (x, k, w, generation) of the photon holding the max_tau
ratchet (Counters.mt_*).  A photon's trajectory is deterministic given its
birth state (biased scattering never deflects the parent,
harm_model.cpp:1005-1051; roulette only kills), so REPLAYING that birth
state through the NATIVE ORACLE's nominal-step integrator
(reference-semantics stepping, no growth) yields the reference-discretized
optical depth of the same geodesic:

    replay tau ~= engine tau  ->  true tail (stepping exonerated)
    replay tau << engine tau  ->  grown-step trapezoid artifact

A second replay with the engine itself at grow_cap=1 (nominal steps)
triangulates.  Writes one JSON blob (--json).

Usage:
    python tools/replay_deep_tau.py [--photons 2000] [--mass-unit 4e20]
        [--seed 123] [--bench-profile] [--json REPLAY_r5.json]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--photons", type=int, default=2000)
    ap.add_argument("--mass-unit", type=float, default=4e20)
    ap.add_argument("--n1", type=int, default=64)
    ap.add_argument("--n2", type=int, default=32)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--json", default=None)
    ap.add_argument("--bench-profile", action="store_true",
                    help="trace the shipped bench profile (f32 + deviation "
                    "knobs) instead of reference-semantics f64")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax import random as jrandom

    from grmonty.models import torus
    from grmonty.ops import emission, fluid, geometry
    from grmonty.transport import driver, engine
    from grmonty.utils.logging import setup

    setup("info")
    cache = os.path.join(REPO, ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, f"torus_{args.n1}x{args.n2}_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=args.n1, n2=args.n2)

    sim_kw = {}
    if args.bench_profile:
        from grmonty.transport import profiles

        cfg = profiles.bench_config(pool=1024, env={})
        cfg = cfg._replace(sec_cap=16384, max_outer=200000)
        bk = profiles.bench_sim_kwargs(1024, env={})
        sim_kw = dict(tail_grow_cap=bk["tail_grow_cap"],
                      tail_stall_steps=bk["tail_stall_steps"])
    else:
        cfg = engine.EngineConfig(n_pool=1024, m_period=8, sec_cap=16384,
                                  max_outer=200000, stall_steps=100000)
    cfg = cfg._replace(trace_birth=True)

    def run_engine(cfg):
        sim = driver.Simulation(dump, photon_n=args.photons,
                                mass_unit=args.mass_unit, config=cfg,
                                emit_chunk=4096, seed=args.seed, warmup=256,
                                **sim_kw)
        t0 = time.time()
        spec, stats = sim.run()
        c = jax.device_get(sim.state.counters)
        return sim, stats, c, time.time() - t0

    sim, stats, c, t_eng = run_engine(cfg)
    mt_bx = np.asarray(c.mt_bx, np.float64)
    mt_bk = np.asarray(c.mt_bk, np.float64)
    out = {
        "photons": args.photons,
        "mass_unit": args.mass_unit,
        "seed": args.seed,
        "bench_profile": bool(args.bench_profile),
        "engine_max_tau": float(c.max_tau_scatt),
        "engine_s": round(t_eng, 1),
        "mt_birth_x": mt_bx.tolist(),
        "mt_birth_k": mt_bk.tolist(),
        "mt_birth_w": float(c.mt_bw),
        "mt_birth_nsc0": int(c.mt_nsc0),
    }

    # ---- replay the captured birth state through the native oracle ------
    mc = sim.mc
    g = np.asarray(geometry.gcov(jnp.asarray(mt_bx[None, :]), mc.a,
                                 mc.h_slope, mc.r_0))[0]
    k_cov = g @ mt_bk
    e_ph = -k_cov[0]
    l_ph = k_cov[3]
    g7 = np.asarray(geometry.gcov(jnp.asarray(mt_bx[None, :]), mc.a,
                                  mc.h_slope, mc.r_0))
    fs = fluid.get_fluid_params(jnp.asarray(mt_bx[None, :]),
                                jnp.asarray(g7), sim.prims, mc)
    batch = emission.InitPhotons(
        x=np.asarray(mt_bx[None, :]),
        k=np.asarray(mt_bk[None, :]),
        w=np.asarray([max(float(c.mt_bw) / sim.cfg.weight_scale, 1.0)]),
        e=np.asarray([e_ph]),
        l=np.asarray([l_ph]),
        n_e_0=np.asarray(fs.n_e, np.float64),
        theta_e_0=np.asarray(fs.theta_e, np.float64),
        b_0=np.asarray(fs.b, np.float64),
        e_0=np.asarray([e_ph]),
        n_scatt=np.asarray([int(c.mt_nsc0)], np.int32),
    )

    from grmonty.transport.oracle_native import NativeTracker

    replays = []
    for rseed in (args.seed + 7, args.seed + 101, args.seed + 503):
        tr = NativeTracker(mc, sim.tables, np.asarray(sim.prims), seed=rseed)
        t0 = time.time()
        tr.run(batch, progress_every=0)
        replays.append({
            "seed": rseed,
            "replay_max_tau": float(tr.max_tau_scatt),
            "n_recorded_family": int(tr.n_recorded),
            "replay_s": round(time.time() - t0, 1),
        })
    out["replays"] = replays
    best = max(r["replay_max_tau"] for r in replays)
    out["replay_max_tau"] = best
    out["tau_ratio_engine_over_replay"] = float(c.max_tau_scatt) / max(
        best, 1e-300)

    # ---- triangulate: same engine at grow_cap=1 (nominal steps) ---------
    if cfg.grow_cap > 1.0:
        cfg1 = cfg._replace(grow_cap=1.0, grow_tau_cap=0.0)
        _, stats1, c1, t1 = run_engine(cfg1)
        out["engine_max_tau_nominal_steps"] = float(c1.max_tau_scatt)
        out["engine_nominal_s"] = round(t1, 1)

    ratio = out["tau_ratio_engine_over_replay"]
    if ratio < 3.0:
        verdict = "true-tail (replay reproduces the depth)"
    elif (out.get("engine_max_tau_nominal_steps", 0.0)
          > 10.0 * out["replay_max_tau"]):
        # The engine WITHOUT step growth also reaches depths far beyond
        # the replay: growth/trapezoid stepping is exonerated, and the
        # per-photon replay is non-probative — deep-tau photons live on
        # near-photon-orbit trajectories where any two integrators (or
        # any two step segmentations of the same integrator) diverge
        # chaotically from identical birth states.  Combined with the
        # oracle's own deep ratchet realizations (measured r5: oracle
        # max_tau 2.38 / 0.61 at M4e19-20k vs its 2k-stable 0.0025), the
        # deep tail is REAL and reachable by both integrators; which
        # realization a given run samples is chaos + RNG.
        verdict = ("true-tail (nominal-step engine reaches comparable "
                   "depth; per-photon replay non-probative on chaotic "
                   "near-orbit trajectories)")
    else:
        verdict = "stepping-artifact-suspected"
    out["verdict"] = verdict
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
