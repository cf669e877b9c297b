#!/usr/bin/env python
"""Dump the compiled (post-optimization) HLO of the engine's run dispatch.

Writes the full optimized-HLO text to /tmp/engine_hlo.txt and prints an op
census of the largest fusions (what actually landed in the two giant
hot-step fusions the profile shows).  Diagnostic only.

Env knobs: same engine knobs as bench_micro (MICRO_POOL, MICRO_EV_K, ...).
"""

import collections
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty.models import torus
    from grmonty.transport import driver, engine
    from grmonty.utils.logging import setup

    setup("warning")
    pool = int(os.environ.get("MICRO_POOL", "65536"))
    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache")
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=256, n2=256)
    cfg = engine.EngineConfig(
        n_pool=pool, m_period=32, sec_cap=pool, stall_steps=150000,
        dtype=jnp.float32, fp_iters=2,
        ev_k=int(os.environ.get("MICRO_EV_K", "16384")),
    )
    sim = driver.Simulation(dump, photon_n=1_000_000, mass_unit=4e19,
                            config=cfg, emit_chunk=pool * 8)
    state = sim.engine["fresh_state"](random.PRNGKey(0))
    backlog = jnp.zeros((pool * 8, engine.ROW_WIDTH), cfg.dtype)
    import numpy as np
    lowered = sim._run_jit.lower(state, backlog, np.int32(0), np.int32(0))
    txt = lowered.compile().as_text()
    with open("/tmp/engine_hlo.txt", "w") as f:
        f.write(txt)
    print(f"wrote {len(txt)} bytes to /tmp/engine_hlo.txt", file=sys.stderr)

    # Census: per fusion computation, count ops by kind.
    blocks = re.split(r"\n(?=%?\S+ \([^)]*\) -> )", txt)
    sizes = []
    for b in blocks:
        name = b.split(" ", 1)[0].lstrip("%")
        ops = collections.Counter(
            m.group(1) for m in re.finditer(r"= \S+ (\w+)\(", b))
        total = sum(ops.values())
        sizes.append((total, name, ops))
    sizes.sort(reverse=True)
    for total, name, ops in sizes[:8]:
        top = ", ".join(f"{k}:{v}" for k, v in ops.most_common(14))
        print(f"{total:5d} ops  {name}\n       {top}")


if __name__ == "__main__":
    main()
