#!/usr/bin/env python
"""Decompose the bench's warm-start cost: trace/lower vs compile vs load.

A warm start can pay "compile_s" even with a HOT persistent XLA cache, in
which case the time is NOT XLA compilation.  This probe times the main
engine's jit stages separately on the real backend:

    lower   = trace + StableHLO lowering (pure host Python, 1 core)
    compile = XLA compile OR persistent-cache hit (deserialize+load)
    first   = first dispatch (device warmup)

Run twice back-to-back to see the hot-cache numbers.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    t0 = time.time()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from grmonty.transport import driver, engine as engine_mod, profiles
    from grmonty.utils.logging import setup

    setup("info")
    pool = int(os.environ.get("BENCH_POOL", "65536"))
    cfg = profiles.bench_config(pool=pool)
    kw = profiles.bench_sim_kwargs(pool)
    print(f"imports: {time.time() - t0:.1f} s", flush=True)

    t = time.time()
    sim = driver.Simulation(
        ".cache/torus_256x256_dump", photon_n=10**6, mass_unit=4e19,
        config=cfg, **kw)
    print(f"Simulation init (tables + device put): {time.time() - t:.1f} s",
          flush=True)

    from jax import random
    state = sim.engine["fresh_state"](random.PRNGKey(0))
    zero_backlog = jnp.zeros((1, engine_mod.ROW_WIDTH), cfg.dtype)

    t = time.time()
    lowered = sim._run_jit.lower(state, zero_backlog, np.int32(0), np.int32(0))
    t_lower = time.time() - t
    print(f"main engine LOWER (trace+StableHLO): {t_lower:.1f} s", flush=True)

    t = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t
    print(f"main engine COMPILE (or cache load): {t_compile:.1f} s", flush=True)

    t = time.time()
    jax.block_until_ready(compiled(state, zero_backlog))
    t_first = time.time() - t
    print(f"main engine FIRST DISPATCH: {t_first:.1f} s", flush=True)
    print(f"total: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
