#!/usr/bin/env python
"""Capture a jax.profiler trace of the real hot loop (_run_jit) mid-wave.

Writes an xplane capture under /tmp/grmonty_profile; decode with
tools/xplane_ops.py for the top device ops.

Usage: [PROF_POOL=65536] python tools/profile_trace.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import random

from grmonty.transport import driver, engine
from grmonty.utils.logging import setup

POOL = int(os.environ.get("PROF_POOL", "65536"))


def main():
    setup("warning")
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        from grmonty.models import torus

        torus.write_torus_dump(dump, n1=256, n2=256)
    cfg = engine.EngineConfig(
        n_pool=POOL, m_period=16, sec_cap=POOL, stall_steps=150000,
        dtype=jnp.float32, ev_k=16384, grow_cap=8.0, grow_rate=1.1892,
        detached_events=True,
        refill_k=32768,
        col_gather=os.environ.get("BENCH_COL_GATHER", "0") == "1",
        mxu_extract=os.environ.get("BENCH_MXU", "1") == "1",
        gather_split=int(os.environ.get("BENCH_GATHER_SPLIT", "4")),
    )
    sim = driver.Simulation(dump, photon_n=1_000_000, mass_unit=4e19,
                            config=cfg, emit_chunk=POOL * 8)
    plan = sim.plan()
    start = max(0, min(2 << 20, plan.total - POOL * 8))
    backlog = sim.emit_packed_dev(plan, start, POOL * 8)
    state = sim.engine["fresh_state"](random.PRNGKey(0))
    state = jax.block_until_ready(
        jax.jit(sim.engine["periodic_phase"])(state, backlog))
    te, nv = jnp.asarray(0, jnp.int32), None
    # warm up + reach steady-state occupancy
    for _ in range(2):
        state = state._replace(it=jnp.zeros((), jnp.int32))
        state = jax.block_until_ready(sim._run_jit(state, backlog))
    print(f"occ={int(jnp.sum(state.pool.occupied))}", flush=True)
    import time
    with jax.profiler.trace("/tmp/grmonty_profile"):
        state = state._replace(it=jnp.zeros((), jnp.int32))
        t0 = time.perf_counter()
        state = jax.block_until_ready(sim._run_jit(state, backlog))
        dt = time.perf_counter() - t0
    print(f"slice wall {dt*1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
