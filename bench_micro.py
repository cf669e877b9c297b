#!/usr/bin/env python
"""Micro-benchmarks for the transport engine's hot pieces.

Prints ONE JSON line with the quantities the macro rate is built from
(reference analogue: ``benchmarks/ndarray_benchmark.cpp``):

* ``hot_step_ms``        — one full hot iteration (pool-wide) in the real
                           mid-wave regime
* ``lane_steps_per_sec`` — pool size / hot_step time
* ``periodic_ms``        — one periodic phase (scatter events, record,
                           refill) in the same regime
* ``push_rounds``        — batch-max halving rounds of one geodesic push
* ``slice_ms_per_iter``  — full engine run() amortized per iteration
                           (what the macro bench actually pays)

Env knobs: MICRO_POOL (65536), MICRO_DTYPE (float32).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Published peak device-memory bandwidth per device kind (as JAX reports
# ``device_kind``), bytes/s.  Source: NVIDIA H100 data sheet, SXM part
# (80 GB HBM3 at 3.35 TB/s).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak(device_kind):
    """Peak memory bandwidth of ``device_kind``; a device missing from the
    table is an error, not a skipped roofline field."""
    try:
        return HBM_PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak bandwidth for device kind {device_kind!r}; "
            "add it to HBM_PEAK_BYTES_PER_S with its source") from None


def main():
    import jax

    # Opt-in PRNG implementation A/B (e.g. MICRO_PRNG=rbg instead of
    # software threefry — the hot step draws 2 pool-wide uniforms per
    # iteration).
    if os.environ.get("MICRO_PRNG"):
        jax.config.update("jax_default_prng_impl", os.environ["MICRO_PRNG"])
    import jax.numpy as jnp
    from jax import random

    from grmonty.models import torus
    from grmonty.transport import driver, engine
    from grmonty.utils.logging import setup

    setup("warning")
    # Fail before any work on a device without a published peak.
    peak = hbm_peak(jax.devices()[0].device_kind)
    pool = int(os.environ.get("MICRO_POOL", "65536"))
    dtype = (jnp.float32 if os.environ.get("MICRO_DTYPE", "float32") == "float32"
             else jnp.float64)

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=256, n2=256)

    cfg = engine.EngineConfig(
        n_pool=pool, m_period=int(os.environ.get("MICRO_PERIOD", "32")),
        sec_cap=pool, stall_steps=150000,
        dtype=dtype, fp_iters=int(os.environ.get("MICRO_FP_ITERS", "2")),
        interp_geom=os.environ.get("MICRO_INTERP", "0") == "1",
        dbg_skip=os.environ.get("MICRO_SKIP", ""),
        fluid_cache=os.environ.get("MICRO_FLUID_CACHE", "0") == "1",
        ev_k=int(os.environ.get("MICRO_EV_K", "0")),
        refill_k=int(os.environ.get("MICRO_REFILL_K", "0")),
        grow_cap=float(os.environ.get("MICRO_GROW_CAP", "1.0")),
        grow_rate=float(os.environ.get("MICRO_GROW_RATE", "2.0")),
        detached_events=os.environ.get("MICRO_DETACH", "0") == "1",
        col_gather=os.environ.get("MICRO_COL_GATHER", "0") == "1",
        mxu_extract=os.environ.get("MICRO_MXU", "0") == "1",
        gather_split=int(os.environ.get("MICRO_GATHER_SPLIT", "1")),
        hot_halves=int(os.environ.get("MICRO_HALVES", "1")),
        refill_period=int(os.environ.get("MICRO_REFILL_PERIOD", "0")),
        light_k=int(os.environ.get("MICRO_LIGHT_K", "0")),
        bias_ema=float(os.environ.get("MICRO_BIAS_EMA", "0")),
        derived_fluid=os.environ.get("MICRO_DERIVED", "0") == "1",
    )
    # photon_n matches the macro bench so the zone sweep (and therefore the
    # regime at a given row offset) is the same plan the bench runs.
    sim = driver.Simulation(dump, photon_n=1_000_000, mass_unit=4e19,
                            config=cfg, emit_chunk=pool * 8)
    plan = sim.plan()
    # Row offset picks the measurement regime.  The plan is a row-major
    # zone sweep: the first ~1M rows are near-horizon photons that die in
    # a handful of steps (an idle-pool regime that flattered this bench by
    # 6x), rows ~1.5-4M are the Compton-storm segment where the macro
    # bench spends most of its wall time.  Default: the storm.
    start = int(os.environ.get("MICRO_START", str(2 << 20)))
    start = max(0, min(start, plan.total - pool * 8))
    if jax.default_backend() == "cpu":
        backlog = sim.emit_packed(plan, start, pool * 8)
    else:
        backlog = sim.emit_packed_dev(plan, start, pool * 8)
    state = sim.engine["fresh_state"](random.PRNGKey(0))
    state = jax.jit(sim.engine["periodic_phase"])(state, backlog)
    # advance into the real mid-wave regime (counters warm, pool loaded
    # with the storm's secondary mix)
    state = sim._run_jit(state, backlog)
    state = sim._run_jit(state._replace(it=jnp.zeros((), jnp.int32)), backlog)
    jax.block_until_ready(state)

    def timed(f, *a, reps=3):
        out = f(*a)
        jax.block_until_ready(out)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = f(*a)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        return min(ts), out

    # full slice (ground truth per-iteration cost); verify it actually ran
    # its full iteration budget with a loaded pool (a drained wave makes the
    # while_loop exit early and the number meaningless).
    t_slice, s_out = timed(
        lambda s: sim._run_jit(s._replace(it=jnp.zeros((), jnp.int32)), backlog),
        state,
    )
    slice_iters = int(s_out.it)
    occ_after = int(jax.device_get(s_out.pool.occupied.sum()))

    # hot_step marginal via two fori lengths.
    from jax import lax
    hot = sim.engine["hot_step"]
    f64 = jax.jit(lambda s: lax.fori_loop(0, 64, lambda i, s_: hot(s_), s))
    f512 = jax.jit(lambda s: lax.fori_loop(0, 512, lambda i, s_: hot(s_), s))
    t64, _ = timed(f64, state)
    t512, _ = timed(f512, state)
    hot_ms = (t512 - t64) / (512 - 64) * 1e3

    # MICRO_TRACE=<dir>: capture an xplane profile of one 512-iteration
    # hot-step loop at exactly this configuration (decode with
    # tools/xplane_ops.py <dir>/**/*.xplane.pb).
    if os.environ.get("MICRO_TRACE"):
        tdir = os.environ["MICRO_TRACE"]
        os.system(f"rm -rf {tdir}")
        with jax.profiler.trace(tdir):
            jax.block_until_ready(f512(state))

    # Stationary periodic-phase timing: each fori iteration runs the phase
    # on the SAME pool state (so the event/refill load doesn't decay across
    # iterations, which made the old evolving-state differencing go
    # negative), with a folded key so the compiler cannot CSE the calls.
    per = sim.engine["periodic_phase"]

    def per_probe(n):
        def body(i, acc):
            s2 = per(state._replace(key=random.fold_in(state.key, i)),
                     backlog)
            return acc + s2.backlog_pos.astype(jnp.int64)
        return jax.jit(lambda _: lax.fori_loop(0, n, body, jnp.int64(0)))

    tp8, _ = timed(per_probe(8), 0)
    tp32, _ = timed(per_probe(32), 0)
    per_ms = (tp32 - tp8) / 24 * 1e3

    rounds = int(jax.jit(sim.engine["push_rounds"])(state))

    # Roofline anchor: XLA's own cost analysis of the 512-iteration hot
    # loop gives the compiler's FLOP count and bytes-accessed estimate;
    # dividing by the measured time yields achieved GFLOP/s and GB/s.  The
    # hot loop is elementwise + one row gather, so the relevant ceiling is
    # memory BANDWIDTH; pct_hbm_peak is its share of the published peak.
    an = f512.lower(state).compile().cost_analysis()
    if isinstance(an, list):
        an = an[0]
    flops_it = float(an.get("flops", 0.0)) / 512
    bytes_it = float(an.get("bytes accessed", 0.0)) / 512
    t_it = (t512 - t64) / (512 - 64)
    roof = {
        "device_kind": jax.devices()[0].device_kind,
        "flops_per_iter": round(flops_it),
        "bytes_per_iter": round(bytes_it),
        "achieved_gflops": round(flops_it / t_it / 1e9, 1),
        "achieved_gbps": round(bytes_it / t_it / 1e9, 1),
        "pct_hbm_peak": round(bytes_it / t_it / peak * 100, 1),
    }

    # Lane-slot utilization over the measured slice.
    dc = jax.device_get(s_out.counters)
    c0 = jax.device_get(state.counters)
    d_iters = int(dc.ls_iters - c0.ls_iters)
    util = {}
    if d_iters > 0:
        slots = float(d_iters * pool)
        util = {
            "util_occupied": round(float(dc.ls_occupied - c0.ls_occupied) / slots, 3),
            "util_moving": round(float(dc.ls_moving - c0.ls_moving) / slots, 3),
            "util_committed": round(float(dc.ls_committed - c0.ls_committed) / slots, 3),
            "util_parked": round(float(dc.ls_parked - c0.ls_parked) / slots, 3),
        }

    print(json.dumps({
        "metric": "hot_step_ms",
        "value": round(hot_ms, 3),
        "unit": "ms/iter",
        "pool": pool,
        "lane_steps_per_sec": round(pool / (t_slice / max(slice_iters, 1))),
        "periodic_ms": round(per_ms, 3),
        "push_rounds": rounds,
        "slice_ms_per_iter": round(t_slice / max(slice_iters, 1) * 1e3, 3),
        "slice_iters": slice_iters,
        "occ_after": occ_after,
        **util,
        **roof,
    }))


if __name__ == "__main__":
    main()
