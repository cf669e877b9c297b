"""The shipped engine profiles — single source of truth.

``bench.py`` (the macro benchmark), ``chip_smoke.py`` and the chi^2
deviation gate (``transport/accuracy.py``) must agree on the EXACT
EngineConfig being shipped: a float32 bench once ran while every chi^2 gate
ran the f64 default dtype, and the bench's grow_cap drifted from the gated
value.  All of them build their config here.

Every value below was tuned before the port to the H100 and is chi^2-gated
on the CPU; none is yet measured on the H100.

``BENCH_*`` environment knobs override individual fields (A/B probes);
``ref_mode`` restores strict reference-scheduling semantics wholesale.
"""

import os

import jax.numpy as jnp

from grmonty.transport import engine


def bench_config(pool=65536, dtype=None, ref_mode=False, env=None,
                 stall_steps=None):
    """The accelerated, accuracy-gated profile the macro bench ships.

    Pool width 65536: a wider pool ran half-empty before the port
    (occupancy 0.71/0.51 at 131072) because the refill/event widths below
    do not scale with the pool; a future widening must scale
    ev_k/refill_k/light_k with it.

    Every deviation knob here is chi2-gated against the reference-semantics
    oracle (ACCURACY.md); see EngineConfig for the rationale of
    each.  ``ref_mode`` (BENCH_REFERENCE=1) restores reference semantics:
    no step growth, no detached events, everything on the m_period cadence.
    """
    env = os.environ if env is None else env
    if dtype is None:
        dtype = (jnp.float32 if env.get("BENCH_DTYPE", "float32") == "float32"
                 else jnp.float64)
    if stall_steps is None:
        stall_steps = int(env.get("BENCH_STALL_STEPS", "150000"))

    def knob(name, default, refdefault):
        return env.get(name, refdefault if ref_mode else default)

    return engine.EngineConfig(
        n_pool=pool,
        m_period=int(knob("BENCH_PERIOD", "16", "32")),
        # 2x pool: process_scatters emits bursts of up to ev_k secondaries
        # per phase while refill drains at most refill_k into free lanes —
        # at sec_cap=pool the Compton-storm segment overflowed the ring
        # (98k dropped secondaries = 0.7% of recorded).
        sec_cap=2 * pool,
        stall_steps=stall_steps,
        dtype=dtype,
        fp_iters=int(env.get("BENCH_FP_ITERS", "2")),
        # ev_k: auto (n_pool/8 = 8192) starves refill against ~15k
        # lane-deaths per period in the Compton-storm segment (occupancy
        # ~43%); 16384 lifted occupancy to ~80%.
        ev_k=min(pool, int(env.get("BENCH_EV_K", "16384"))),
        refill_k=min(pool, int(knob("BENCH_REFILL_K", "32768", "0") or 0)),
        # Light record+refill phase every 4 hot iterations: retired lanes
        # reload within ~2 iterations instead of idling out the m_period
        # block (EngineConfig.refill_period; occupancy 0.6 -> 0.9 of the
        # main waves).
        refill_period=int(knob("BENCH_REFILL_PERIOD", "4", "0")),
        # Light-phase working width: only deaths since the last maintenance
        # point need absorbing (~n_pool*refill_period/steps_per_photon ~
        # 10k), so the light gathers/scatters run narrower than the full
        # phase's refill.
        light_k=int(knob("BENCH_LIGHT_K", "12288", "0")),
        grow_cap=float(knob("BENCH_GROW_CAP", "8.0", "1.0")),
        # Windowed bias feedback: forgets the cold-start Compton storm
        # within ~4 full phases instead of carrying it for millions of
        # records (EngineConfig.bias_ema).
        bias_ema=float(knob("BENCH_BIAS_EMA", "0.25", "0")),
        grow_rate=float(knob("BENCH_GROW_RATE", "1.1892", "2.0")),
        # Error-proportional step controller (EngineConfig.step_ctrl):
        # safety 0.6 (committed 0.828, 21.7 steps/photon) passes the
        # frozen-bias accuracy gates (ACCURACY_r5_M4e19_frozen_sc06:
        # primaries bit-exact, weighted chi2/dof 0.27, kappa^gen count
        # gate 3.3 < 5).  0 = legacy halve/grow ladder; reference
        # semantics is always 0.
        step_ctrl=float(knob("BENCH_STEP_CTRL", "0.6", "0")),
        detached_events=knob("BENCH_DETACH", "1", "0") == "1",
        # Hot-step interaction physics reads the DERIVED fluid corner table
        # (no per-step metric pair / four-vector reconstruction).
        derived_fluid=knob("BENCH_DERIVED", "1", "0") == "1",
        # One-hot corner-row transpose: pure layout change (exact same
        # blend math; EngineConfig.mxu_extract).
        mxu_extract=env.get("BENCH_MXU", "1") == "1",
        # Corner gather as 8 overlapped sub-gathers (EngineConfig
        # .gather_split).
        gather_split=int(env.get("BENCH_GATHER_SPLIT", "8")),
        hot_halves=int(env.get("BENCH_HALVES", "1")),
    )


def knob_b(env, name, ref_mode):
    """Boolean knob: default on, off in ref_mode."""
    return env.get(name, "0" if ref_mode else "1") == "1"


def bench_sim_kwargs(pool, ref_mode=False, env=None):
    """Driver-level pieces of the shipped profile (tail-cascade overrides,
    pool-full wave handoff, slicing) — shared by bench.py and the gate."""
    env = os.environ if env is None else env
    return dict(
        emit_chunk=int(env.get("BENCH_EMIT_CHUNK", str(1 << 20))),
        # Strided pilot size: the scattering-bias counters must approach
        # the bulk equilibrium BEFORE the full-width waves launch — a
        # small pilot leaves avg_n_scatt several x too high and the early
        # waves run a Compton storm whose magnitude varies run-to-run
        # (recorded-count swings of 1.5x observed at warmup=1024).
        warmup=int(env.get("BENCH_WARMUP", "8192")),
        # 8192-iteration dispatch slices: each slice boundary costs a host
        # round trip and a telemetry fetch (scheduling-only; the physics
        # does not depend on the slice size).  Not yet measured on the
        # H100.
        slice_iters=int(env.get("BENCH_SLICE", "8192")),
        # Inverse-CDF emission sampler (emission.SamplerTables): the
        # batched rejection loops pay the batch-max draw count (~73
        # full-width rounds per wave).
        cdf_sampler=knob_b(env, "BENCH_CDF", ref_mode),
        # Strided emission order (driver.Simulation.emit_stride): every
        # wave sees a representative zone mix instead of the row-major
        # sweep's front-loaded Compton-heavy inner zones — uniform
        # per-wave work, fast bias convergence, and ~2x less run-to-run
        # scattering-work variance.
        emit_stride=knob_b(env, "BENCH_STRIDE", ref_mode),
        wave_tail_exit=pool,
        tail_grow_cap=(float(env["BENCH_TAIL_GROW"])
                       if "BENCH_TAIL_GROW" in env
                       else None if ref_mode else 16.0),
        tail_stall_steps=(int(env["BENCH_TAIL_STALL"])
                          if "BENCH_TAIL_STALL" in env
                          else None if ref_mode else 50000),
    )
