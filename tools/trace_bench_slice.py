#!/usr/bin/env python
"""Capture an xplane trace of ONE mid-wave slice of the exact shipped
bench profile, reusing the persistently-cached executables (no new big
compiles).  Prints the top device ops via tools/xplane_ops.

Usage: python tools/trace_bench_slice.py [logdir=/tmp/grmonty_trace]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import random

    from grmonty.models import torus
    from grmonty.transport import driver, profiles
    from grmonty.utils.logging import setup

    setup("warning")
    logdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/grmonty_trace"

    pool = int(os.environ.get("BENCH_POOL", "65536"))
    cfg = profiles.bench_config(pool=pool)
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=256, n2=256)
    sim = driver.Simulation(
        dump, photon_n=1_000_000, mass_unit=4e19, config=cfg,
        **profiles.bench_sim_kwargs(pool))
    plan = sim.plan()
    start = max(0, min(2 << 20, plan.total - sim.emit_chunk))
    backlog = sim.emit_packed_dev(plan, start, sim.emit_chunk)
    state = sim.engine["fresh_state"](random.PRNGKey(0))
    te, nv = np.int32(pool), np.int32(sim.emit_chunk)
    state = sim._run_jit(state, backlog, te, nv)  # load + warm
    state = sim._run_jit(state._replace(it=jnp.zeros((), jnp.int32)),
                         backlog, te, nv)
    jax.block_until_ready(state)
    occ = int(jax.device_get(state.pool.occupied.sum()))
    print(f"pool={pool} occ={occ} (tracing one slice)", file=sys.stderr)

    os.system(f"rm -rf {logdir}")
    with jax.profiler.trace(logdir):
        s = sim._run_jit(state._replace(it=jnp.zeros((), jnp.int32)),
                         backlog, te, nv)
        jax.block_until_ready(s)
    print(f"iters={int(jax.device_get(s.it))}", file=sys.stderr)

    import glob
    import subprocess

    paths = glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True)
    if paths:
        subprocess.run([sys.executable,
                        os.path.join(os.path.dirname(__file__),
                                     "xplane_ops.py"), paths[0], "30"])


if __name__ == "__main__":
    main()
