#!/usr/bin/env python
"""Engine-vs-oracle accuracy validation with per-bin chi^2 tooling.

Runs the batched engine and the scalar CPU oracle (a direct
transcription of the reference's recursive tracker) on the same dump and
photon budget, then compares:

* luminosity ratio
* recorded-fraction ratio
* per-bin chi^2 over the coarse-grained spectrum (energy bins grouped so
  every group has enough oracle photons for Poisson statistics)

Usage:
    python tools/validate_accuracy.py [--photons 2000] [--mass-unit 4e19]
                                      [--n1 64 --n2 32] [--json out.json]

The oracle is ~1e3x slower than the engine; 2000 photons is ~1-2 h on one
CPU core.  Results are written as JSON so the numbers can be quoted in the
README and tracked across rounds.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--photons", type=int, default=2000)
    ap.add_argument("--mass-unit", type=float, default=4e19)
    ap.add_argument("--photon-n", type=int, default=2000,
                    help="photon_n used to build weight tables")
    ap.add_argument("--n1", type=int, default=64)
    ap.add_argument("--n2", type=int, default=32)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--engine-seed", type=int, default=None,
                    help="vary ONLY the engine's tracking RNG stream "
                    "(emission + oracle unchanged, so a cached "
                    "--oracle-npz stays valid): measures the engine-side "
                    "per-band count variance, incl. cascade clustering "
                    "that the Poisson model underestimates")
    ap.add_argument("--json", default=None)
    ap.add_argument("--group", type=int, default=10,
                    help="energy bins per chi^2 group")
    ap.add_argument("--oracle-npz", default=None,
                    help="persist/reuse the oracle spectrum here: if the "
                    "file exists it is loaded instead of re-running the "
                    "~hours-long oracle (valid for the same dump/photons/"
                    "seed), otherwise the oracle runs and saves to it")
    ap.add_argument("--grow-cap", type=float, default=1.0,
                    help="engine grow_cap to validate against the oracle "
                    "(the oracle always integrates at reference semantics)")
    ap.add_argument("--grow-rate", type=float, default=2.0,
                    help="engine per-commit step growth rate (see "
                    "EngineConfig.grow_rate)")
    ap.add_argument("--detached", action="store_true",
                    help="engine detached_events to validate against the "
                    "oracle (parking-free parent continuation)")
    ap.add_argument("--bench-profile", action="store_true",
                    help="gate the EXACT shipped bench configuration "
                    "(grmonty.transport.profiles.bench_config at a "
                    "1024-lane pool): float32 engine, grow_cap/rate, "
                    "detached_events, derived_fluid, refill_period, "
                    "mxu_extract, gather_split — overrides the individual "
                    "knob flags")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64",
                    help="engine compute dtype (ignored with "
                    "--bench-profile, which ships float32)")
    ap.add_argument("--derived-fluid", action="store_true",
                    help="engine derived_fluid corner table")
    ap.add_argument("--refill-period", type=int, default=0)
    ap.add_argument("--bias-ema", type=float, default=0.0)
    ap.add_argument("--stall-steps", type=int, default=100000)
    ap.add_argument("--oracle", choices=("python", "native"), default="native",
                    help="oracle backend: 'native' (C++ mirror, seconds; "
                    "parity-tested in tests/test_oracle_native.py) or "
                    "'python' (the original transcription, ~hours at 2000 "
                    "photons)")
    ap.add_argument("--freeze-bias", type=float, default=0.0,
                    help="pin BOTH trackers' bias normalization to this "
                    "max_tau value (with --freeze-avg): the live ratchet "
                    "is an unstable extreme-value statistic whose "
                    "trajectory diverges between trackers (measured: "
                    "oracle 2.38 vs engine 0.15 at M4e19/20k), making "
                    "count-level gates meaningless; the bias is a pure "
                    "variance-reduction knob, so pinning it makes "
                    "secondary populations directly comparable")
    ap.add_argument("--freeze-avg", type=float, default=2.6)
    ap.add_argument("--oracle-reps", type=int, default=1,
                    help="run the oracle this many times (seeds seed+1..)"
                    " and gate against the replicate MEAN with the "
                    "MEASURED per-band count variance: secondary cascades "
                    "cluster (one hot gen-2 event spawns correlated "
                    "descendants), inflating per-band count variance 4-8x "
                    "over Poisson in the Compton bands — a single-"
                    "realization comparison at Poisson error bars "
                    "misreads that noise as bias (measured r5: the "
                    "oracle's own top-band counts swing +-5-10%, flux "
                    "+-20-40%, across seeds)")
    ap.add_argument("--save-spec", default=None,
                    help="also dump both raw spectra (engine + oracle, "
                    "(6,200,13) each) to this .npz for band-level diagnosis")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from grmonty.models import torus
    from grmonty.transport import accuracy, driver, engine
    from grmonty.utils.logging import setup

    setup("info")

    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, f"torus_{args.n1}x{args.n2}_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=args.n1, n2=args.n2)

    sim_kw = {}
    if args.bench_profile:
        cfg, sim_kw = accuracy.gate_profile()
        if os.environ.get("GRMONTY_EV_HALVE"):
            cfg = cfg._replace(ev_halve=int(os.environ["GRMONTY_EV_HALVE"]))
        if os.environ.get("GRMONTY_EV_FORCE"):
            cfg = cfg._replace(ev_force=int(os.environ["GRMONTY_EV_FORCE"]))
        if os.environ.get("GRMONTY_STEP_CTRL"):
            cfg = cfg._replace(
                step_ctrl=float(os.environ["GRMONTY_STEP_CTRL"]))
        if os.environ.get("GRMONTY_GROW_CAP"):
            cfg = cfg._replace(
                grow_cap=float(os.environ["GRMONTY_GROW_CAP"]))
    else:
        cfg = engine.EngineConfig(
            n_pool=1024, m_period=8, sec_cap=16384, max_outer=200000,
            stall_steps=100000, grow_cap=args.grow_cap,
            grow_rate=args.grow_rate,
            detached_events=args.detached,
            derived_fluid=args.derived_fluid,
            refill_period=args.refill_period,
            bias_ema=args.bias_ema,
            dtype=jnp.float32 if args.dtype == "float32" else jnp.float64,
        )
        cfg = cfg._replace(stall_steps=args.stall_steps)
    if args.freeze_bias > 0.0:
        cfg = cfg._replace(bias_fixed_tau=args.freeze_bias,
                           bias_fixed_avg=args.freeze_avg)
    sim = driver.Simulation(dump, photon_n=args.photon_n,
                            mass_unit=args.mass_unit, config=cfg,
                            emit_chunk=4096, seed=args.seed, warmup=256,
                            **sim_kw)

    out, se, so = accuracy.compare_to_oracle(
        sim, args.photons, seed=args.seed, engine_seed=args.engine_seed,
        oracle=args.oracle, oracle_reps=args.oracle_reps,
        freeze_bias=((args.freeze_bias, args.freeze_avg)
                     if args.freeze_bias > 0.0 else None),
        group=args.group, oracle_npz=args.oracle_npz)
    decomp = out["origin_decomp"]
    out.update({
        "mass_unit": args.mass_unit,
        "oracle": args.oracle,
        "oracle_reps": args.oracle_reps,
        "freeze_bias": ([args.freeze_bias, args.freeze_avg]
                        if args.freeze_bias > 0.0 else None),
        "engine_config": {
            "dtype": str(np.dtype(cfg.dtype)),
            "grow_cap": cfg.grow_cap, "grow_rate": cfg.grow_rate,
            "detached_events": cfg.detached_events,
            "derived_fluid": cfg.derived_fluid,
            "refill_period": cfg.refill_period,
            "light_k": cfg.light_k,
            "bias_ema": cfg.bias_ema,
            "mxu_extract": cfg.mxu_extract,
            "gather_split": cfg.gather_split,
            "stall_steps": cfg.stall_steps,
            "bench_profile": bool(args.bench_profile),
        },
    })
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if decomp and "chi2_sec_gen_per_dof" in decomp:
        if args.freeze_bias > 0.0:
            # HARD gate — valid only with the bias pinned on both sides:
            # live-bias count comparisons measure feedback-trajectory
            # divergence (an unstable extreme-value random walk), not
            # physics (see --freeze-bias help and ACCURACY.md r5).
            assert decomp["chi2_sec_gen_per_dof"] < 5.0, (
                f"secondary count shape fails the per-generation kappa^g "
                f"model at FROZEN bias: chi2/dof "
                f"{decomp['chi2_sec_gen_per_dof']:.1f} >= 5 "
                f"(kappa_gen {decomp['kappa_gen_fit']:.3f})")
        elif decomp["chi2_sec_gen_per_dof"] >= 5.0:
            print(f"note: live-bias secondary count shape chi2/dof "
                  f"{decomp['chi2_sec_gen_per_dof']:.1f} (diagnostic only "
                  "- the hard gate runs with --freeze-bias)",
                  file=sys.stderr)
    assert out["n_hc_clamp_engine"] == 0, (
        f"hotcross clamp path reached {out['n_hc_clamp_engine']} times — "
        "the device sigma deviates from the reference's numeric fallback "
        "(hotcross.cpp:81-106); widen the table or add a device fallback")
    if args.save_spec:
        np.savez(args.save_spec, spec_engine=se, spec_oracle=so,
                 n_engine=out["n_engine"], n_oracle=out["n_oracle"])


if __name__ == "__main__":
    main()
