"""Disk cache for the init-time physics tables.

The hotcross and synchrotron tables depend only on compile-time constants,
so they are built once (numpy/scipy, host-side) and cached under
``grmonty/data/``; the cache key hashes the parameters that shape the
table, so changing ``consts`` invalidates it.  Equivalent in spirit to the
reference's GPU-accelerated init (``hotcross_table.cu``): there the table is
rebuilt every run because C++ has nowhere cheap to cache it; here init cost
is paid once per checkout.
"""

import hashlib
import logging
import os

import numpy as np

from grmonty import consts

log = logging.getLogger("grmonty")

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _key(*parts) -> str:
    h = hashlib.sha256(repr(parts).encode()).hexdigest()[:12]
    return h


def _cached(name, key, builder):
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, f"{name}_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return tuple(z[k] for k in z.files) if len(z.files) > 1 else z[z.files[0]]
    log.info("Building %s table (one-time, cached to %s)", name, path)
    result = builder()
    if isinstance(result, tuple):
        np.savez(path, *result)
    else:
        np.savez(path, result)
    return result


def hotcross_table() -> np.ndarray:
    from grmonty.ops import hotcross

    hc = consts.hotcross
    key = _key(hc.MIN_W, hc.MAX_W, hc.MIN_T, hc.MAX_T, hc.N_W, hc.N_T,
               hc.MAX_GAMMA, hc.D_MU_E, hc.D_GAMMA_E)
    return _cached("hotcross", key, hotcross.build_table)


def jnu_tables() -> tuple:
    from grmonty.ops import jnu

    j = consts.jnu
    key = _key(j.MIN_K, j.MAX_K, j.MIN_T, j.MAX_T, consts.N_E_SAMP, j.EPS_REL)
    return _cached("jnu", key, jnu.build_tables)


def dump_init(dump_path, mass_unit, photon_n, builder):
    """Cache the per-dump init products (weight/nint/budget tables, zone
    geometry/tetrads) keyed on the dump content hash and run parameters."""
    h = hashlib.sha256()
    with open(dump_path, "rb") as f:
        h.update(f.read())
    h.update(repr((mass_unit, photon_n, consts.NU_MIN, consts.NU_MAX,
                   consts.N_E_SAMP, consts.NINT, "v8-nucdf")).encode())
    key = h.hexdigest()[:12]
    path = os.path.join(DATA_DIR, f"dumpinit_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    log.info("Building per-dump init tables (cached to %s)", path)
    host = builder()
    os.makedirs(DATA_DIR, exist_ok=True)
    np.savez(path, **host)
    return dict(host)


def theta_quantiles():
    """Global direction-sampler quantile table (emission.build_theta_quantiles)."""
    from grmonty.ops import emission

    key = _key(emission.TH_X_NODES, emission.TH_U_NODES, emission.TH_LX_MIN,
               emission.TH_LX_MAX, consts.jnu.CST, "v1")
    return _cached("theta_q", key, emission.build_theta_quantiles)
