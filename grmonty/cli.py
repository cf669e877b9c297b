"""Command-line entry point.

Equivalent of the reference's ``main.cpp:19-56``: the same five flags with
the same defaults (--photon_n, --mass_unit, --harm_dump_path,
--spectrum_path, --verbosity), driving read -> init -> run -> report.
Extra engine knobs are grouped under the tuning section.
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="grmonty",
        description="General-relativistic Monte Carlo radiative transport in JAX",
    )
    p.add_argument("--photon_n", type=float, default=5_000_000,
                   help="estimate of the number of superphotons to emit")
    p.add_argument("--mass_unit", type=float, default=4.0e19,
                   help="mass unit [g] scaling the dump's density")
    p.add_argument("--harm_dump_path", type=str, required=True,
                   help="path to the HARM dump file")
    p.add_argument("--spectrum_path", type=str, default="spectrum",
                   help="output spectrum file path")
    p.add_argument("--verbosity", type=str, default="info",
                   help="log level: trace|debug|info|warn|err|critical|off")
    # engine tuning
    p.add_argument("--pool", type=int, default=16384, help="photon pool size")
    p.add_argument("--period", type=int, default=8,
                   help="iterations between refill/record/scatter phases")
    p.add_argument("--dtype", type=str, default="float64",
                   choices=["float32", "float64"], help="transport compute dtype")
    p.add_argument("--seed", type=int, default=123, help="RNG seed")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the photon pool over this many devices (0 = single)")
    p.add_argument("--backend", choices=("accel", "cpu"), default="accel",
                   help="transport backend: 'accel' = batched engine on the "
                   "accelerator (default); 'cpu' = native C++ scalar tracker "
                   "(the reference CPU build's equivalent, harm_model.cpp:"
                   "362-404; forces the JAX CPU platform for emission)")
    p.add_argument("--grow_cap", type=float, default=1.0,
                   help="adaptive step growth cap (1.0 = reference step "
                   "semantics; >1 enables accuracy-gated step growth, see "
                   "README deviations)")
    p.add_argument("--no_mxu_extract", action="store_true",
                   help="disable the one-hot corner-row transpose (pure layout "
                   "optimization, exact physics; on by default — disable "
                   "only to A/B the XLA column-extraction path)")
    p.add_argument("--detach", action="store_true",
                   help="detached scatter events: parents continue "
                   "immediately after an event instead of parking until "
                   "the periodic phase (see README deviations)")
    p.add_argument("--cdf_sampler", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="emission via the inverse-CDF sampler (default: on; "
                   "distribution-equivalence pinned by "
                   "tests/test_emission_cdf.py and chi2-gated in the "
                   "accuracy harness).  --no-cdf_sampler restores the "
                   "reference's rejection-loop emission (harm_model.cpp:"
                   "736-751), which pays the batch-max draw count (~1.5x "
                   "slower end-to-end)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="write a disk resume point here after every wave "
                   "and resume from it if it exists (single-device runs; "
                   "a completed run deletes it)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a jax.profiler trace of the transport run here "
                   "(view with tensorboard/xprof; the reference's analogue is "
                   "nvcc --generate-line-info + Nsight, .bazelrc:9)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from grmonty.utils.logging import setup

    log = setup(args.verbosity)

    if args.backend == "cpu":
        # must precede first backend use; the env var alone is not honored
        # once an accelerator plugin is installed
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from grmonty.transport import driver, engine

    cfg = engine.EngineConfig(
        n_pool=args.pool,
        m_period=args.period,
        dtype=jnp.float32 if args.dtype == "float32" else jnp.float64,
        grow_cap=args.grow_cap,
        detached_events=args.detach,
        mxu_extract=not args.no_mxu_extract,
    )
    if args.devices > 1:
        if args.backend == "cpu":
            raise SystemExit("--backend cpu is single-process (the scalar "
                             "tracker has no sharded mode); drop --devices")
        if args.checkpoint:
            raise SystemExit("--checkpoint is not supported with --devices>1 "
                             "(the sharded run loop has its own drain logic)")
        from grmonty.parallel import sharding

        sim = sharding.ShardedSimulation(
            args.harm_dump_path, photon_n=int(args.photon_n),
            mass_unit=args.mass_unit, seed=args.seed, config=cfg,
            n_devices=args.devices, cdf_sampler=args.cdf_sampler,
        )
    else:
        sim = driver.Simulation(
            args.harm_dump_path, photon_n=int(args.photon_n),
            mass_unit=args.mass_unit, seed=args.seed, config=cfg,
            cdf_sampler=args.cdf_sampler,
        )
    import contextlib

    if args.profile_dir:
        import jax

        prof = jax.profiler.trace(args.profile_dir)
    else:
        prof = contextlib.nullcontext()
    with prof:
        if args.backend == "cpu":
            if args.checkpoint:
                raise SystemExit("--checkpoint applies to the accelerator "
                                 "engine only (cpu backend runs are "
                                 "restartable by rerunning)")
            spec, stats = sim.run_native_cpu()
        elif args.checkpoint and args.devices <= 1:
            spec, stats = sim.run(checkpoint_path=args.checkpoint)
        else:
            spec, stats = sim.run()
    sim.report(args.spectrum_path)
    log.info("Done: %.0f photons/s", stats["photon_rate"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
