#!/usr/bin/env python
"""Probe the geodesic-push cost structure on the current accelerator.

Times, at transport-pool width, the pieces push_once is made of:
connection eval, geodesic RHS, energy row, the fixed-point loop at 2 and 4
iterations, and the full push_once — plus a couple of layout experiments.
Diagnostic tool only; prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax, random

    from grmonty.ops import geometry

    n = int(os.environ.get("PROBE_N", "65536"))
    dt = jnp.float32
    key = random.PRNGKey(0)
    a, hs, r0 = 0.9375, 0.3, 0.0

    x1 = random.uniform(key, (n,), dt, 0.3, 5.0)
    x2 = random.uniform(key, (n,), dt, 0.05, 0.95)
    k = tuple(random.normal(random.fold_in(key, i), (n,), dt) for i in range(4))
    dk = tuple(random.normal(random.fold_in(key, 4 + i), (n,), dt) * 0.01
               for i in range(4))
    seg = jnp.full((n,), 1e-2, dt)

    def timed(f, *args, reps=5):
        """Marginal per-iteration cost: (t(n_long) - t(n_short)) / delta.

        Differencing two device-side fori_loop lengths cancels the fixed
        dispatch cost, which otherwise dominates any per-op measurement
        here.
        """
        def chain(iters):
            def g(*args):
                def body(i, s):
                    out = f(*s)
                    return out if isinstance(out, tuple) else (out,) + s[1:]
                return lax.fori_loop(0, iters, body, args)
            return jax.jit(g)

        def best(g):
            out = g(*args)
            jax.block_until_ready(out)
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = g(*args)
                jax.block_until_ready(out)
                ts.append(time.perf_counter() - t0)
            return min(ts)

        short, long_ = 64, 512
        t_s = best(chain(short))
        t_l = best(chain(long_))
        return (t_l - t_s) / (long_ - short) * 1e3  # ms per call

    results = {"n": n}

    # connection eval: returns 40-tuple; keep x1 as carry to defeat DCE
    def conn_only(x1, x2):
        c = geometry.connection_c(x1, x2, a, hs)
        return (x1 + c[0] * 1e-20, x2)

    results["conn_ms"] = round(timed(conn_only, x1, x2), 4)

    # energy row only
    def row0_only(x1, x2):
        g00, g01, g03 = geometry.gcov_row0_c(x1, x2, a, hs, r0)
        return (x1 + (g00 + g01 + g03) * 1e-20, x2)

    results["row0_ms"] = round(timed(row0_only, x1, x2), 4)

    # geodesic RHS on a fixed connection (pre-evaluated)
    conn_fixed = geometry.connection_c(x1, x2, a, hs)

    def rhs_only(k0, k1, k2, k3):
        d = geometry.geodesic_rhs_c(conn_fixed, k0, k1, k2, k3)
        return (k0 + d[0] * 1e-20, k1 + d[1] * 1e-20, k2 + d[2] * 1e-20,
                k3 + d[3] * 1e-20)

    results["rhs_ms"] = round(timed(rhs_only, *k), 4)

    # full push-like body at fp iterations 2 and 4
    def push_like(fp_iters):
        def f(x1, x2, k0, k1, k2, k3):
            kk = (k0, k1, k2, k3)
            dl2 = 0.5 * seg
            k_half = tuple(q + d * dl2 for q, d in zip(kk, dk))
            k_pred = tuple(q + d * dl2 for q, d in zip(k_half, dk))
            x1n = x1 + k_half[1] * seg
            x2n = x2 + k_half[2] * seg
            conn = geometry.connection_c(x1n, x2n, a, hs)
            g00, g01, g03 = geometry.gcov_row0_c(x1n, x2n, a, hs, r0)
            for _ in range(fp_iters):
                dkn = geometry.geodesic_rhs_c(conn, *k_pred)
                k_pred = tuple(q + dl2 * d for q, d in zip(k_half, dkn))
            e1 = -(k_pred[0] * g00 + k_pred[1] * g01 + k_pred[3] * g03)
            return (x1n + e1 * 1e-20, x2n, *k_pred)

        return f

    results["push_fp2_ms"] = round(timed(push_like(2), x1, x2, *k), 4)
    results["push_fp4_ms"] = round(timed(push_like(4), x1, x2, *k), 4)

    # RNG: one uniform draw at pool width (key in the carry so the draw
    # cannot be hoisted out of the loop)
    def rng_only(k0, x1):
        k0, sub = random.split(k0)
        u = random.uniform(sub, (n,), dt)
        return (k0, x1 + u * 1e-20)

    results["uniform_ms"] = round(timed(rng_only, key, x1), 4)

    # corner-table style row gather (N, 32); indices depend on the carry
    table = random.normal(key, (65536, 32), dt)
    idx0 = random.randint(key, (n,), 0, 60000, jnp.int32)

    def gather32(acc, x1):
        idx = idx0 + (acc.astype(jnp.int32) & 1)
        rows = table[idx]
        s = jnp.sum(rows, axis=1)
        return (acc + s * 1e-20, x1)

    results["gather32_ms"] = round(timed(gather32, x1 * 0, x1), 4)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
