#!/usr/bin/env python
"""Pool-composition census in the storm regime: who holds the lanes?

Advances the engine into the same mid-wave regime bench_micro measures,
then fetches the pool and prints one JSON line with the lane breakdown
(moving / at_event / record_pending / dead-waiting / free) and the n_step
distribution over occupied lanes (orbiter stragglers vs through-flow).
Diagnostic only — answers "is the pool full of long-lived orbiters, and
how much of the lane-step budget do they own?"

Env knobs: CENSUS_POOL (65536), CENSUS_EV_K (16384), CENSUS_START (2<<20).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import random

    from grmonty.models import torus
    from grmonty.transport import driver, engine
    from grmonty.utils.logging import setup

    setup("warning")
    pool = int(os.environ.get("CENSUS_POOL", "65536"))

    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache")
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=256, n2=256)

    cfg = engine.EngineConfig(
        n_pool=pool, m_period=int(os.environ.get("CENSUS_PERIOD", "32")),
        sec_cap=pool, stall_steps=150000, dtype=jnp.float32, fp_iters=2,
        ev_k=int(os.environ.get("CENSUS_EV_K", "16384")),
    )
    sim = driver.Simulation(dump, photon_n=1_000_000, mass_unit=4e19,
                            config=cfg, emit_chunk=pool * 8)
    plan = sim.plan()
    start = int(os.environ.get("CENSUS_START", str(2 << 20)))
    start = max(0, min(start, plan.total - pool * 8))
    if jax.default_backend() == "cpu":
        backlog = sim.emit_packed(plan, start, pool * 8)
    else:
        backlog = sim.emit_packed_dev(plan, start, pool * 8)
    state = sim.engine["fresh_state"](random.PRNGKey(0))
    state = jax.jit(sim.engine["periodic_phase"])(state, backlog)
    for _ in range(3):  # ~1.5k iters: storm mix incl. secondary cascade
        state = sim._run_jit(state._replace(it=jnp.zeros((), jnp.int32)),
                             backlog)
    p = jax.device_get(state.pool)

    occ = np.asarray(p.occupied)
    alive = np.asarray(p.alive)
    at_ev = np.asarray(p.at_event)
    rp = np.asarray(p.record_pending)
    ns = np.asarray(p.n_step)
    nsc = np.asarray(p.n_scatt)

    moving = alive & ~at_ev
    dead_wait = occ & ~alive & ~rp
    edges = [0, 30, 100, 300, 1000, 3000, 10000, 30000, 150001]
    hist = {}
    step_budget = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = occ & (ns >= lo) & (ns < hi)
        hist[f"{lo}-{hi}"] = int(m.sum())
        step_budget[f"{lo}-{hi}"] = int(ns[m].sum())
    print(json.dumps({
        "pool": pool,
        "occupied": int(occ.sum()),
        "moving": int(moving.sum()),
        "at_event": int((occ & at_ev).sum()),
        "record_pending": int((occ & rp).sum()),
        "dead_waiting": int(dead_wait.sum()),
        "n_step_hist": hist,
        "n_step_budget": step_budget,
        "n_step_mean_occ": round(float(ns[occ].mean()), 1),
        "n_step_max": int(ns[occ].max()) if occ.any() else 0,
        "n_scatt_mean_occ": round(float(nsc[occ].mean()), 2),
        "backlog_pos": int(state.backlog_pos),
        "sec_count": int(state.sec.count),
    }))


if __name__ == "__main__":
    main()
