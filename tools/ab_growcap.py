#!/usr/bin/env python
"""grow_cap accuracy A/B: engine spectra at grow_cap=1 (reference
semantics) vs grow_cap>1 (accuracy-gated step growth), same seed/plan.

The growth is gated by the same two per-step error tests that gate
halving, so the hypothesis is that the spectrum shift is far below MC
noise while steps/photon drops materially.  Prints one JSON line with
luminosity ratio, coarse-band L2 shift, and steps/photon for both runs.

Usage: python tools/ab_growcap.py [--grow 4] [--photon-n 2000]
Env:   AB_N1/AB_N2 (64x32 default), AB_POOL (1024)
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(dump, photon_n, grow, pool):
    import numpy as np

    from grmonty import consts
    from grmonty.transport import driver, engine

    cfg = engine.EngineConfig(
        n_pool=pool, m_period=8, sec_cap=16384, max_outer=200000,
        stall_steps=100000, grow_cap=float(grow),
    )
    sim = driver.Simulation(dump, photon_n=photon_n, mass_unit=4e19,
                            config=cfg, emit_chunk=4096, seed=123,
                            warmup=256)
    spec, stats = sim.run()
    NB, NE = consts.N_TH_BINS, consts.N_E_BINS
    se = np.asarray(spec)[: NB * NE].reshape(NB, NE, -1)
    return se, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grow", type=float, default=4.0)
    ap.add_argument("--photon-n", type=int, default=2000)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from grmonty.models import torus
    from grmonty.utils.logging import setup

    setup("warning")
    n1 = int(os.environ.get("AB_N1", "64"))
    n2 = int(os.environ.get("AB_N2", "32"))
    pool = int(os.environ.get("AB_POOL", "1024"))
    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, f"torus_{n1}x{n2}_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=n1, n2=n2)

    se1, st1 = run_one(dump, args.photon_n, 1.0, pool)
    seg, stg = run_one(dump, args.photon_n, args.grow, pool)

    lum1 = se1[:, :, 1].sum() / st1["n_created"]
    lumg = seg[:, :, 1].sum() / stg["n_created"]
    # coarse 10-bin energy-band shape shift, theta-summed
    e1 = se1[:, :, 1].sum(0)
    eg = seg[:, :, 1].sum(0)
    ne_g = e1.shape[0] // 20
    b1 = e1[: ne_g * 20].reshape(ne_g, 20).sum(1) / max(e1.sum(), 1e-300)
    bg = eg[: ne_g * 20].reshape(ne_g, 20).sum(1) / max(eg.sum(), 1e-300)
    l2 = float(np.sqrt(((b1 - bg) ** 2).sum() / max((b1 ** 2).sum(), 1e-300)))

    out = {
        "grow": args.grow,
        "lum_ratio": float(lumg / lum1),
        "band_shape_l2": l2,
        "steps_per_photon_1": round(st1.get("steps_per_photon", 0.0), 1),
        "steps_per_photon_g": round(stg.get("steps_per_photon", 0.0), 1),
        "rate_1": round(st1["photon_rate"], 1),
        "rate_g": round(stg["photon_rate"], 1),
        "n_recorded_1": st1["n_recorded"],
        "n_recorded_g": stg["n_recorded"],
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
