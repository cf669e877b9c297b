"""Fluid state evaluation: zone-centred and bilinear-interpolated plasma.

Equivalent of ``cuda_grmonty/harm_model.cpp``: ``get_fluid_zone`` :538-593,
``get_fluid_params`` :595-671, ``interp_scalar`` :1646-1656 (the GPU mirror
``harm_model.cuh:246-335`` is the branch-free template we follow).

The 8 primitives live on device as one (8, n1, n2) float array in the order
rho, u, u1, u2, u3, B1, B2, B3.  Both entry points reconstruct the fluid
4-velocity from the HARM velocity primitives (u^0 from v.v and g^00), build
the magnetic 4-vector b^mu, and return everything batched.
"""

import math
import typing

import jax
import jax.numpy as jnp

from grmonty import consts
from grmonty.ops import geometry, linalg, tetrads


class ModelConsts(typing.NamedTuple):
    """Static per-dump scalars threaded through the physics (hashable)."""

    a: float
    h_slope: float
    r_0: float
    x_start: tuple  # (4,)
    x_stop: tuple  # (4,)
    dx: tuple  # (4,)
    n1: int
    n2: int
    n_e_unit: float
    theta_e_unit: float
    b_unit: float
    x1_min: float  # ln(horizon radius)
    bias_norm: float
    d_tau_k: float
    max_tau_scatt0: float  # initial bias normalisation depth (harm_model.cpp:72)


class FluidState(typing.NamedTuple):
    n_e: jnp.ndarray
    theta_e: jnp.ndarray
    b: jnp.ndarray  # field magnitude [gauss]
    u_con: jnp.ndarray  # (..., 4)
    u_cov: jnp.ndarray
    b_con: jnp.ndarray  # (..., 4), code units
    b_cov: jnp.ndarray


def _four_vectors(v_con_sp, bp_sp, g_cov, g_con, mc):
    """Shared reconstruction of u^mu and b^mu from spatial primitives.

    ``v_con_sp``/``bp_sp``: (..., 3) spatial primitives; metrics (..., 4, 4).
    """
    zeros = jnp.zeros_like(v_con_sp[..., :1])
    v_con = jnp.concatenate([zeros, v_con_sp], axis=-1)
    bp = jnp.concatenate([zeros, bp_sp], axis=-1)

    v_dot_v = jnp.einsum("...i,...ij,...j->...", v_con[..., 1:], g_cov[..., 1:, 1:],
                         v_con[..., 1:], precision=jax.lax.Precision.HIGHEST)
    v_fac = jnp.sqrt(-1.0 / g_con[..., 0, 0] * (1.0 + jnp.abs(v_dot_v)))

    u_con = v_con - v_fac[..., None] * g_con[..., 0, :]
    u_con = u_con.at[..., 0].set(-v_fac * g_con[..., 0, 0])
    u_cov = tetrads.lower(u_con, g_cov)

    u_dot_bp = jnp.sum(u_cov[..., 1:] * bp[..., 1:], axis=-1)
    b_con = (bp + u_con * u_dot_bp[..., None]) / u_con[..., 0:1]
    b_con = b_con.at[..., 0].set(u_dot_bp)
    b_cov = tetrads.lower(b_con, g_cov)

    b_mag = jnp.sqrt(jnp.abs(jnp.sum(b_con * b_cov, axis=-1))) * mc.b_unit
    return u_con, u_cov, b_con, b_cov, b_mag


def get_fluid_zone(prims, g_cov, g_con, mc):
    """Zone-centred fluid state for every zone at once (harm_model.cpp:538-593).

    ``prims``: (8, n1, n2); ``g_cov``/``g_con``: (n1, n2, 4, 4).
    Returns a FluidState of (n1, n2[, 4]) arrays.
    """
    rho, uu = prims[0], prims[1]
    n_e = rho * mc.n_e_unit
    theta_e = uu / rho * mc.theta_e_unit

    v_con_sp = jnp.moveaxis(prims[2:5], 0, -1)  # (n1, n2, 3)
    bp_sp = jnp.moveaxis(prims[5:8], 0, -1)
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors(v_con_sp, bp_sp, g_cov, g_con, mc)
    return FluidState(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)


def get_fluid_params(x, g_cov, prims, mc, prims_rows=None):
    """Bilinearly interpolated fluid state at arbitrary x (harm_model.cpp:595-671).

    ``x``: (..., 4); ``g_cov``: (..., 4, 4) evaluated at x by the caller.
    Outside the grid the electron density is zeroed (sentinel), matching the
    reference's early return.

    ``prims_rows`` (optional): the primitives pre-transposed to
    (n1*n2, 8) so each bilinear corner is one contiguous row gather
    instead of 32 scalar gathers.
    """
    inside = (
        (x[..., 1] >= mc.x_start[1])
        & (x[..., 1] <= mc.x_stop[1])
        & (x[..., 2] >= mc.x_start[2])
        & (x[..., 2] <= mc.x_stop[2])
    )

    i, j, del_i, del_j = geometry.x_to_ij(x, mc.x_start, mc.dx, (mc.n1, mc.n2))

    if prims_rows is not None:
        base = i * mc.n2 + j
        p00 = jnp.moveaxis(prims_rows[base], -1, 0)
        p01 = jnp.moveaxis(prims_rows[base + 1], -1, 0)
        p10 = jnp.moveaxis(prims_rows[base + mc.n2], -1, 0)
        p11 = jnp.moveaxis(prims_rows[base + mc.n2 + 1], -1, 0)
    else:
        # Bilinear gather of all 8 primitives at once: (8, ...) per corner.
        p00 = prims[:, i, j]
        p01 = prims[:, i, j + 1]
        p10 = prims[:, i + 1, j]
        p11 = prims[:, i + 1, j + 1]
    c00 = (1.0 - del_i) * (1.0 - del_j)
    c01 = (1.0 - del_i) * del_j
    c10 = del_i * (1.0 - del_j)
    c11 = del_i * del_j
    p = p00 * c00 + p01 * c01 + p10 * c10 + p11 * c11  # (8, ...)

    rho, uu = p[0], p[1]
    n_e = jnp.where(inside, rho * mc.n_e_unit, 0.0)
    theta_e = uu / rho * mc.theta_e_unit

    g_con = geometry.gcon(x, mc.a, mc.h_slope, mc.r_0)
    v_con_sp = jnp.moveaxis(p[2:5], 0, -1)
    bp_sp = jnp.moveaxis(p[5:8], 0, -1)
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors(v_con_sp, bp_sp, g_cov, g_con, mc)
    return FluidState(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)


class FluidC(typing.NamedTuple):
    """Component-form fluid state for the transport hot path (see the
    geometry module docstring for the layout rationale)."""

    n_e: jnp.ndarray
    theta_e: jnp.ndarray
    b: jnp.ndarray  # field magnitude [gauss]
    u_con: tuple  # 4x (N,)
    u_cov: tuple
    b_con: tuple  # code units
    b_cov: tuple


def make_corner_table(prims, n1, n2):
    """Pack the bilinear stencil into one gather-friendly table.

    The four corner gathers of ``get_fluid_params`` are folded into one
    (one index per lane instead of four): row z of the
    returned (n1*n2, 32) array holds the 8 primitives at zones z, z+1, z+n2,
    z+n2+1 (the reference's p00/p01/p10/p11 corners, harm_model.cpp:617-641).
    Out-of-range corners on the last row/column are never selected (the
    bilinear cell index is clamped to n-2) but are padded validly anyway.
    """
    import numpy as np

    p = np.asarray(prims).reshape(8, n1 * n2).T  # (Z, 8)
    z = np.arange(n1 * n2)
    c00 = p[z]
    c01 = p[np.minimum(z + 1, n1 * n2 - 1)]
    c10 = p[np.minimum(z + n2, n1 * n2 - 1)]
    c11 = p[np.minimum(z + n2 + 1, n1 * n2 - 1)]
    return np.concatenate([c00, c01, c10, c11], axis=1)  # (Z, 32)


DERIVED_COMPS = 11  # n_e, theta_e, |B|, u_cov(4), b_cov(4)


def make_derived_corner_table(prims, mc):
    """Pack the DERIVED fluid state at the 4 bilinear corners per cell.

    Hot-loop economics (found before the port; not yet measured on the
    H100): the transport interaction phase (phase B) spent most of its time
    NOT on the gather but on what follows it — ``gcov_c`` + ``gcon_c`` at
    the photon position plus the
    ``_four_vectors_c`` u0/b^mu reconstruction, all transcendental/division
    chains per lane per step.  The hot loop only ever consumes
    (n_e, theta_e, |B|, u_cov, b_cov); those are smooth per-zone fields, so
    precompute them at zone centers (exactly :func:`get_fluid_zone`, the
    reference's zone-centred path harm_model.cpp:538-593) and blend the
    DERIVED components bilinearly, eliminating the per-step metric pair and
    reconstruction entirely.

    Deviation from the reference (harm_model.cpp:595-671 interpolates the 8
    primitives, then reconstructs at the photon position): blending derived
    quantities differs from deriving blended ones at second order in the
    grid spacing — same class as the geom-table fluid blend, pinned by
    tests/test_fluid.py and chi2-gated like every other deviation knob.

    Row z: the 11 components at zones z, z+1, z+n2, z+n2+1 (the same
    corner layout as :func:`make_corner_table`).  Returns (n1*n2, 44) f64
    numpy; built host-side (jitted once on the CPU backend).
    """
    import numpy as np

    cpu = jax.devices("cpu")[0]

    def build(p):
        zone_x, g_cov_z, g_con_z, _ = precompute_zone_geometry(mc)
        fz = get_fluid_zone(p, g_cov_z, g_con_z, mc)
        z = mc.n1 * mc.n2
        # [1] = theta_e * n_e: theta_e is recovered as a ratio of blends
        # (engine.hot_phase_b derived branch) — exactly the reference's
        # uu/rho ratio of interpolated primitives.
        return jnp.concatenate(
            [fz.n_e.reshape(z, 1), (fz.theta_e * fz.n_e).reshape(z, 1),
             fz.b.reshape(z, 1), fz.u_cov.reshape(z, 4),
             fz.b_cov.reshape(z, 4)], axis=1)  # (Z, 11)

    with jax.default_device(cpu):
        comp = np.asarray(jax.jit(build)(
            jax.device_put(np.asarray(prims, np.float64), cpu)))
    return pack_corner_rows(comp, mc.n2)


def pack_corner_rows(comp, n2):
    """(Z, C) per-zone components -> (Z, 4C) bilinear corner rows (the
    make_corner_table layout: zones z, z+1, z+n2, z+n2+1)."""
    import numpy as np

    comp = np.asarray(comp)
    zmax = comp.shape[0] - 1
    z = np.arange(comp.shape[0])
    c00 = comp[z]
    c01 = comp[np.minimum(z + 1, zmax)]
    c10 = comp[np.minimum(z + n2, zmax)]
    c11 = comp[np.minimum(z + n2 + 1, zmax)]
    return np.concatenate([c00, c01, c10, c11], axis=1)


GEOM_WIDTH = 51  # per-zone geometry row: conn(40) + fluid(11)
GEOM_STENCIL = 9  # 3x3 zone-center stencil packed per gatherable row
GEOM_POLE_COMPS = (32, 35, 38)  # cot(theta)-divergent connection components,
# stored pre-multiplied by sin(theta) (see make_geom_table)


def make_geom_table(mc, fluid_zone):
    """Per-zone geometry+fluid rows for the gather-everything hot loop.

    Rationale (from before the port, where a row gather's cost was nearly
    independent of row width): the transport hot loop fetches EVERYTHING
    position-dependent in one gather:
    the 40 affine-connection components and the derived fluid state are
    smooth functions of (x1, x2), precomputed here at every zone center,
    replacing the per-segment closed-form Christoffel evaluation (~200
    flops + sin/cos/exp per lane, harm_model.cpp:1436-1569) and the
    u^mu/b^mu reconstruction (harm_model.cpp:560-593) with FMA blends.

    Interpolation orders (see :func:`blend_geom_rows`): the connection is
    blended *biquadratically* (3x3 stencil, O(dx^3) error — bilinear noise
    on coarse grids measurably bends geodesics), the fluid state
    *bilinearly* from the same stencil (matching the reference's
    interpolation order for fluid quantities, harm_model.cpp:1646-1656).
    Deviation from the reference (analytic geometry at the photon position;
    four-vectors reconstructed from interpolated primitives): residuals are
    second/third order in the grid spacing and sit below the integrator's
    truncation error at STEP_EPS = 0.04 on production-size (256^2) grids;
    accuracy is pinned by tests/test_fluid.py::test_geom_blend_accuracy.

    Layout per zone z (float64, cast by the engine):
      [0:40)  connection 40-tuple at the zone center (geometry.connection_c)
      [40]    n_e   [41] theta_e   [42] |B| [gauss]
      [43:47) u_cov  [47:51) b_cov
    Returns the UNPACKED (n1*n2, 51) table; pack with :func:`pack_geom9`.
    Pure jnp (jit-friendly): the driver builds it inside the one jitted
    init-products function on the host CPU backend.
    """
    z = mc.n1 * mc.n2
    ii, jj = jnp.meshgrid(
        jnp.arange(mc.n1, dtype=jnp.float64),
        jnp.arange(mc.n2, dtype=jnp.float64),
        indexing="ij",
    )
    x1 = mc.x_start[1] + (ii.reshape(z) + 0.5) * mc.dx[1]
    x2 = mc.x_start[2] + (jj.reshape(z) + 0.5) * mc.dx[2]
    conn = list(geometry.connection_c(x1, x2, mc.a, mc.h_slope))

    # Pole regularization: components 32 (c302), 35 (c312), 38 (c323)
    # diverge as cot(theta); store them multiplied by sin(theta) — a smooth
    # field — and divide by the analytic sin(theta) at blend time.
    th = jnp.pi * x2 + 0.5 * (1.0 - mc.h_slope) * jnp.sin(2.0 * jnp.pi * x2)
    sth = jnp.sin(th)
    for m in GEOM_POLE_COMPS:
        conn[m] = conn[m] * sth

    fz = fluid_zone
    flat = lambda a: jnp.asarray(a, jnp.float64).reshape(z, -1)
    p = jnp.concatenate(
        [jnp.stack([jnp.broadcast_to(c, (z,)) for c in conn], axis=1),
         flat(fz.n_e), flat(fz.theta_e), flat(fz.b), flat(fz.u_cov),
         flat(fz.b_cov)],
        axis=1,
    )  # (Z, 51)
    assert p.shape[1] == GEOM_WIDTH
    return p


def pack_geom9(table, n1, n2):
    """Pack the (n1*n2, 51) table into 3x3-stencil rows (n1*n2, 459).

    Row z holds the 51-wide entries of the 9 zones (i+di, j+dj) for
    di, dj in row-major {-1,0,1}^2, edge-clamped (the stencil centre is
    clamped to the interior in :func:`blend_geom_rows`, so clamped entries
    are only reachable as unused zero-weight corners).
    """
    import numpy as np

    t = np.asarray(table).reshape(n1, n2, GEOM_WIDTH)
    blocks = []
    for di in (-1, 0, 1):
        i = np.clip(np.arange(n1) + di, 0, n1 - 1)
        for dj in (-1, 0, 1):
            j = np.clip(np.arange(n2) + dj, 0, n2 - 1)
            blocks.append(t[i[:, None], j[None, :], :])
    out = np.concatenate(blocks, axis=-1)  # (n1, n2, 459)
    return out.reshape(n1 * n2, GEOM_STENCIL * GEOM_WIDTH)


def blend_geom_rows(geom9, x1, x2, mc):
    """Stencil blend of the packed geometry table at (x1, x2).

    The transport hot loop's single dynamic gather: one (N,) row gather of
    the 3x3-stencil table (:func:`pack_geom9`), then two FMA blends —
    biquadratic axis weights for the connection block (O(dx^3)), linear hat
    weights for the fluid block (bilinear, the reference's order for fluid
    interpolation).  Returns (conn (40, N), flu (11, N), inside mask).
    """
    inside = (
        (x1 >= mc.x_start[1]) & (x1 <= mc.x_stop[1])
        & (x2 >= mc.x_start[2]) & (x2 <= mc.x_stop[2])
    )
    dt = x1.dtype
    fi = (x1 - mc.x_start[1]) / mc.dx[1] - 0.5  # zone-center coordinates
    fj = (x2 - mc.x_start[2]) / mc.dx[2] - 0.5
    i0 = jnp.clip(jnp.round(fi).astype(jnp.int32), 1, mc.n1 - 2)
    j0 = jnp.clip(jnp.round(fj).astype(jnp.int32), 1, mc.n2 - 2)
    ti = jnp.asarray(fi, dt) - i0.astype(dt)  # |t| <= 0.5 in the interior
    tj = jnp.asarray(fj, dt) - j0.astype(dt)

    def axis_weights(t):
        # quadratic (Lagrange on -1, 0, +1) and linear-hat weight triples
        q = (0.5 * t * (t - 1.0), 1.0 - t * t, 0.5 * t * (t + 1.0))
        lin = (jnp.maximum(-t, 0.0), jnp.maximum(1.0 - jnp.abs(t), 0.0),
               jnp.maximum(t, 0.0))
        return q, lin

    qi, li = axis_weights(ti)
    qj, lj = axis_weights(tj)

    rows = geom9[i0 * mc.n2 + j0]  # (N, 459): THE gather
    conn = None
    flu = None
    for a in range(3):
        for b in range(3):
            blk = rows[:, (3 * a + b) * GEOM_WIDTH : (3 * a + b + 1) * GEOM_WIDTH]
            wq = (qi[a] * qj[b])[:, None]
            wl = (li[a] * lj[b])[:, None]
            c = blk[:, :40] * wq
            f = blk[:, 40:] * wl
            conn = c if conn is None else conn + c
            flu = f if flu is None else flu + f
    # components into the sublane dim (one relayout each)
    conn = conn.T
    flu = flu.T
    # undo the pole regularization (see make_geom_table)
    th = jnp.pi * x2 + 0.5 * (1.0 - mc.h_slope) * jnp.sin(2.0 * jnp.pi * x2)
    inv_sth = 1.0 / (jnp.sin(th) + jnp.asarray(1e-30, dt))
    for m in GEOM_POLE_COMPS:
        conn = conn.at[m].multiply(inv_sth)
    return conn, flu, inside


def _four_vectors_c(v1, v2, v3, b1, b2, b3, g7, gc6, mc):
    """Component-form u^mu / b^mu reconstruction (harm_model.cpp:560-593)."""
    g00, g01, g03, g11, g13, g22, g33 = g7
    gc00, gc01, gc11, gc13, gc22, gc33 = gc6

    v_dot_v = (
        g11 * v1 * v1 + g22 * v2 * v2 + g33 * v3 * v3 + 2.0 * g13 * v1 * v3
    )
    v_fac = jnp.sqrt(-1.0 / gc00 * (1.0 + jnp.abs(v_dot_v)))

    u0 = -v_fac * gc00
    u1 = v1 - v_fac * gc01
    u2 = v2
    u3 = v3  # gcon row 0 has only (00, 01) nonzero
    u_con = (u0, u1, u2, u3)
    u_cov = geometry.lower_c(g7, u_con)

    u_dot_bp = u_cov[1] * b1 + u_cov[2] * b2 + u_cov[3] * b3
    bc0 = u_dot_bp
    bc1 = (b1 + u1 * u_dot_bp) / u0
    bc2 = (b2 + u2 * u_dot_bp) / u0
    bc3 = (b3 + u3 * u_dot_bp) / u0
    b_con = (bc0, bc1, bc2, bc3)
    b_cov = geometry.lower_c(g7, b_con)

    bsq = bc0 * b_cov[0] + bc1 * b_cov[1] + bc2 * b_cov[2] + bc3 * b_cov[3]
    b_mag = jnp.sqrt(jnp.abs(bsq)) * mc.b_unit
    return u_con, u_cov, b_con, b_cov, b_mag


def onehot_transpose(rows):
    """(N, C) rows -> (C, N) through one dot_general against the identity.

    The layout trick was chosen before the port, where it replaced a costly
    column extraction; whether it pays on the H100 is not yet measured
    (EngineConfig.mxu_extract).  Exact for finite rows: products are x1.0
    or x0.0 and each output sums one nonzero term, so out[k, n] ==
    rows[n, k] provided the product runs at full float32 precision, which
    HIGHEST requests (a TF32 product would round the mantissa).
    """
    eye = jnp.eye(rows.shape[1], dtype=rows.dtype)
    return jax.lax.dot_general(
        eye, rows, dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def get_fluid_params_c(x1, x2, corner_rows, mc, g7=None, gc6=None,
                       mxu=False):
    """Bilinear fluid state at (x1, x2) via ONE wide-row gather.

    Hot-path equivalent of :func:`get_fluid_params` (harm_model.cpp:595-671):
    the 4 corner gathers collapse into one gather of the packed
    ``corner_rows`` (see :func:`make_corner_table`); everything else is
    component math.  ``g7``/``gc6``: optional precomputed metric component
    tuples at (x1, x2) — computed here if omitted.  ``mxu``: transpose the
    gathered rows to (32, N) with :func:`onehot_transpose` and blend
    component-major (bitwise-identical result; see EngineConfig.mxu_extract).
    """
    inside = (
        (x1 >= mc.x_start[1])
        & (x1 <= mc.x_stop[1])
        & (x2 >= mc.x_start[2])
        & (x2 <= mc.x_stop[2])
    )
    i, j, del_i, del_j = geometry.x_to_ij_c(x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
    z = i * mc.n2 + j
    rows = corner_rows[z]  # (N, 32) — the single hot-loop gather

    c00 = (1.0 - del_i) * (1.0 - del_j)
    c01 = (1.0 - del_i) * del_j
    c10 = del_i * (1.0 - del_j)
    c11 = del_i * del_j
    if mxu:
        rt = onehot_transpose(rows)  # (32, N)
        p = jnp.stack([
            rt[m] * c00 + rt[8 + m] * c01 + rt[16 + m] * c10 + rt[24 + m] * c11
            for m in range(8)
        ])  # (8, N)
    else:
        p = (
            rows[:, 0:8] * c00[:, None]
            + rows[:, 8:16] * c01[:, None]
            + rows[:, 16:24] * c10[:, None]
            + rows[:, 24:32] * c11[:, None]
        ).T  # (8, N): components back into the sublane dim

    rho, uu = p[0], p[1]
    n_e = jnp.where(inside, rho * mc.n_e_unit, 0.0)
    theta_e = uu / rho * mc.theta_e_unit

    if g7 is None:
        g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    if gc6 is None:
        gc6 = geometry.gcon_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors_c(
        p[2], p[3], p[4], p[5], p[6], p[7], g7, gc6, mc
    )
    return FluidC(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)


def get_fluid_params_frow(x1, x2, frow, cell, mc, g7=None, gc6=None):
    """Bilinear fluid state from a lane-cached corner row — NO gather.

    Rationale: the (N,)-index gather of ``corner_rows`` was the transport
    hot step's floor cost before the port.  But the gathered row is a
    function of the
    bilinear CELL, which changes only when a photon crosses a zone-center
    boundary — a few percent of lanes per step at STEP_EPS = 0.04.  The
    engine therefore carries each lane's corner row (``frow``: (32, N)) and
    its cell id (``cell``: (N,)) in the pool state, refreshing only crossing
    lanes with a compacted gather; this function evaluates the same bilinear
    blend as :func:`get_fluid_params_c` from the cache.

    The blend offsets are computed relative to the CACHED cell, so if a
    refresh ever overflows its compaction budget the stale lane degrades to
    (one step of) linear extrapolation from the neighbouring cell instead of
    reading wrong data; with the cache fresh (cell == x_to_ij cell) the
    result is bit-identical to the gather path.
    """
    inside = (
        (x1 >= mc.x_start[1])
        & (x1 <= mc.x_stop[1])
        & (x2 >= mc.x_start[2])
        & (x2 <= mc.x_stop[2])
    )
    i_c = cell // mc.n2
    j_c = cell - i_c * mc.n2
    # Boundary clamps follow the reference (harm_model.cpp:1406-1434): the
    # unclamped floor decides the 0/1 pinning, the cell decides the offset.
    fi = jnp.floor((x1 - mc.x_start[1]) / mc.dx[1] - 0.5)
    fj = jnp.floor((x2 - mc.x_start[2]) / mc.dx[2] - 0.5)
    del_i = (x1 - ((i_c + 0.5) * mc.dx[1] + mc.x_start[1])) / mc.dx[1]
    del_j = (x2 - ((j_c + 0.5) * mc.dx[2] + mc.x_start[2])) / mc.dx[2]
    del_i = jnp.where(fi < 0, 0.0, jnp.where(fi > mc.n1 - 2, 1.0, del_i))
    del_j = jnp.where(fj < 0, 0.0, jnp.where(fj > mc.n2 - 2, 1.0, del_j))

    c00 = (1.0 - del_i) * (1.0 - del_j)
    c01 = (1.0 - del_i) * del_j
    c10 = del_i * (1.0 - del_j)
    c11 = del_i * del_j
    p = [
        frow[m] * c00 + frow[8 + m] * c01 + frow[16 + m] * c10
        + frow[24 + m] * c11
        for m in range(8)
    ]

    rho, uu = p[0], p[1]
    n_e = jnp.where(inside, rho * mc.n_e_unit, 0.0)
    theta_e = uu / rho * mc.theta_e_unit

    if g7 is None:
        g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    if gc6 is None:
        gc6 = geometry.gcon_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors_c(
        p[2], p[3], p[4], p[5], p[6], p[7], g7, gc6, mc
    )
    return FluidC(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)


def precompute_zone_geometry(mc, dtype=jnp.float64):
    """gcov/gcon/sqrt|det g| at every zone center (harm_model.cpp:242-266)."""
    ii, jj = jnp.meshgrid(
        jnp.arange(mc.n1, dtype=dtype), jnp.arange(mc.n2, dtype=dtype), indexing="ij"
    )
    x = geometry.zone_center(ii, jj, mc.x_start, mc.dx)
    g_cov = geometry.gcov(x, mc.a, mc.h_slope, mc.r_0)
    g_con = geometry.gcon(x, mc.a, mc.h_slope, mc.r_0)
    g_det = jnp.sqrt(jnp.abs(linalg.det(g_cov)))  # closed-form 4x4 determinant
    return x, g_cov, g_con, g_det


def make_model_consts(model) -> ModelConsts:
    """Build ModelConsts from a parsed models.harm.HARMModel.

    All scalars are plain python floats (weakly typed under JAX) so they
    never promote a float32 engine to f64.
    """
    h = model.header
    return ModelConsts(
        a=float(h.a),
        h_slope=float(h.h_slope),
        r_0=float(h.r_0),
        x_start=tuple(float(v) for v in h.x_start),
        x_stop=tuple(float(v) for v in h.x_stop),
        dx=tuple(float(v) for v in h.dx),
        n1=int(h.n[0]),
        n2=int(h.n[1]),
        n_e_unit=float(model.units.n_e_unit),
        theta_e_unit=float(model.units.theta_e_unit),
        b_unit=float(model.units.b_unit),
        x1_min=float(model.x1_min),
        bias_norm=float(model.bias_norm),
        d_tau_k=float(model.d_tau_k),
        max_tau_scatt0=float(model.max_tau_scatt_init),
    )
