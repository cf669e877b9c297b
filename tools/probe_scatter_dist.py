#!/usr/bin/env python
"""Distribution-level A/B of the full scatter-sampling chain.

Context (r5): the engine's top Compton bands sit at 0.64x/0.48x its OWN
scalar oracle at 20k photons (VSREF_r5.json bands 5/6), and the anti-stall
escalation was exonerated (census zero, bit-identical bands with it
disabled).  The remaining sampler-side suspects are the batched flat-loop
joint (electron, KN) rejection redesign (ops/proba) vs the reference's
nested scalar rejection (proba.cpp:30-112,174-189) — equivalence is argued
analytically; this probe MEASURES it where the top bands live: hot
theta_e, with tail quantiles, through the complete chain
(electron draw -> boost -> KN energy -> angular -> boost back).

ENGINE side: exactly the periodic-phase semantics — capped rounds with
defer-and-redraw (process_scatters), so the compared object is the
distribution the engine actually samples, caps included.
ORACLE side: the native C++ scalar samplers (bit-pinned transcriptions of
the reference, tests/test_oracle_native.py).

Output: one JSON blob of per-(theta_e, k0) amplification quantiles
(A = k'_tet[0] / k_tet[0]) and tail probabilities, with a verdict per cell
(agree within MC error / engine low / engine high).
"""

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def engine_chain(theta_e, k0, n, seed):
    """Sample n scattered photons through the ENGINE's deferring chain."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty.ops import proba, scattering

    k_tet = (jnp.full((n,), k0), jnp.full((n,), k0),
             jnp.zeros((n,)), jnp.zeros((n,)))
    th = jnp.full((n,), theta_e)
    key = random.PRNGKey(seed)
    out = np.zeros(n)
    done = np.zeros(n, bool)
    # defer-and-redraw: exactly process_scatters' retry semantics (fresh
    # key per phase, same caps); 64 phases is far beyond the observed
    # defer depth at these parameters
    for _ in range(64):
        key, ke, ks = random.split(key, 3)
        p_el, ok_el = proba.sample_electron_distr_p_c(ke, k_tet, th)
        k_p, ok_kn = scattering.sample_scattered_photon_c(ks, k_tet, p_el)
        ok = np.asarray(ok_el & ok_kn)
        take = ok & ~done
        out[take] = np.asarray(k_p[0])[take]
        done |= take
        if done.all():
            break
    return out[done]


def oracle_chain(native, theta_e, k0, n, seed):
    """Sample n scattered photons through the native scalar samplers."""
    k_tet = np.array([k0, k0, 0.0, 0.0])
    electrons = native.sample_electron(k_tet, theta_e, n, seed=seed)
    out = np.empty(n)
    for i in range(n):
        out[i] = native.sample_scattered(k_tet, electrons[i], 1,
                                         seed=seed + 1 + i)[0, 0]
    return out


def stats(a, k0):
    amp = a / k0
    qs = np.quantile(amp, [0.5, 0.9, 0.99, 0.999])
    return {
        "mean_amp": float(amp.mean()),
        "q50": float(qs[0]), "q90": float(qs[1]),
        "q99": float(qs[2]), "q999": float(qs[3]),
        "p_amp_gt10": float((amp > 10).mean()),
        "p_amp_gt100": float((amp > 100).mean()),
        "n": int(amp.size),
    }


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from grmonty.models import torus
    from grmonty.transport import driver, engine
    from grmonty.transport.oracle_native import NativeTracker

    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache")
    dump = os.path.join(cache, "torus_64x32_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=64, n2=32)
    sim = driver.Simulation(
        dump, photon_n=100, mass_unit=4e19,
        config=engine.EngineConfig(n_pool=64, m_period=8, sec_cap=256),
        emit_chunk=256, warmup=0)
    native = NativeTracker(sim.mc, sim.tables, np.asarray(sim.prims), seed=3)

    n = int(os.environ.get("PROBE_N", "40000"))
    cells = []
    for theta_e in (2.0, 8.0, 20.0):
        for k0 in (1e-6, 1e-3, 1e-1):
            e = engine_chain(theta_e, k0, n, seed=11)
            o = stats(oracle_chain(native, theta_e, k0, n, seed=77), k0)
            se = stats(e, k0)
            # MC error on the mean amplification (heavy-tailed: use the
            # empirical std of amp)
            cell = {"theta_e": theta_e, "k0": k0,
                    "engine": se, "oracle": o,
                    "mean_ratio": se["mean_amp"] / max(o["mean_amp"], 1e-300),
                    "q99_ratio": se["q99"] / max(o["q99"], 1e-300),
                    "p10_ratio": (se["p_amp_gt10"]
                                  / max(o["p_amp_gt10"], 1e-300)
                                  if o["p_amp_gt10"] > 1e-4 else None)}
            cells.append(cell)
            print(json.dumps(cell), flush=True)
    out_path = sys.argv[1] if len(sys.argv) > 1 else None
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"cells": cells}, f, indent=2)


if __name__ == "__main__":
    main()
