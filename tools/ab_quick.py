#!/usr/bin/env python
"""Quick A/B sanity: run a small wave on the CPU backend with a given
EngineConfig override set and print accounting + luminosity.

Usage: JAX_PLATFORMS=cpu python tools/ab_quick.py key=val key=val ...
Keys are EngineConfig fields (int/float/bool parsed), plus:
    photons=<n>   (default 2000)
    dump=<path>   (default .cache/torus_64x32_dump)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax.numpy as jnp

    from grmonty.models import torus
    from grmonty.transport import driver, engine
    from grmonty.utils.logging import setup

    setup("info")
    overrides = {}
    photons = 2000
    dump = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "torus_64x32_dump")
    for arg in sys.argv[1:]:
        k, v = arg.split("=", 1)
        if k == "photons":
            photons = int(float(v))
            continue
        if k == "dump":
            dump = v
            continue
        fld = engine.EngineConfig._field_defaults[k]
        if isinstance(fld, bool):
            overrides[k] = v in ("1", "true", "True")
        elif isinstance(fld, int):
            overrides[k] = int(v)
        elif isinstance(fld, float):
            overrides[k] = float(v)
        else:
            overrides[k] = v
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=64, n2=32)

    base = dict(n_pool=2048, m_period=16, sec_cap=4096, stall_steps=20000,
                dtype=jnp.float64)
    base.update(overrides)
    cfg = engine.EngineConfig(**base)
    sim = driver.Simulation(dump, photon_n=photons, mass_unit=4e19,
                            config=cfg, emit_chunk=4096, slice_iters=4096)
    spec, stats = sim.run()
    lum = float(np.sum(spec[:engine.N_BINS, 1]))
    print({
        "created": stats["n_created"], "recorded": stats["n_recorded"],
        "steps_per_photon": round(stats["steps_per_photon"], 2),
        "lum_we": lum,
        "rate": round(stats["photon_rate"], 1),
    })


if __name__ == "__main__":
    main()
