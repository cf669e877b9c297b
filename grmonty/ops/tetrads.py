"""Orthonormal tetrads and frame transforms, vectorized.

Equivalent of ``cuda_grmonty/tetrads.cpp:46-194`` (Gram-Schmidt tetrad
construction, index lowering, frame transforms) and the Lorentz ``boost``
helper (``harm_model.cpp:1658-1671``).

A tetrad is stored as ``e_con`` with shape (..., 4, 4): ``e_con[..., mu, i]``
is coordinate component i of basis vector mu (mu=0 along the fluid
4-velocity, mu=1 along the field direction).  ``e_cov`` is the dual basis.
"""

import jax.numpy as jnp
from jax import lax

from grmonty import consts

# Every contraction below names full precision: at default precision a
# float32 einsum may run in TF32 on a GPU (~3 decimal digits).
_HI = lax.Precision.HIGHEST


def lower(v_con, g_cov):
    """v_mu = g_{mu nu} v^nu for batched vectors (tetrads.cpp:126-155)."""
    return jnp.einsum("...ij,...j->...i", g_cov, v_con, precision=_HI)


def dot(u, v, g_cov):
    """Metric inner product g_{mu nu} u^mu v^nu."""
    return jnp.einsum("...i,...ij,...j->...", u, g_cov, v, precision=_HI)


def _normalize(v, g_cov):
    norm = jnp.sqrt(jnp.abs(dot(v, v, g_cov)))
    return v / norm[..., None]


def _project_out(va, vb, g_cov):
    """Remove vb component from va (tetrads.cpp:173-194)."""
    vb_sq = dot(vb, vb, g_cov)
    a_dot_b = dot(va, vb, g_cov)
    return va - vb * (a_dot_b / vb_sq)[..., None]


def make_tetrad(u_con, trial, g_cov):
    """Gram-Schmidt orthonormal tetrad (tetrads.cpp:68-124).

    e0 = u (normalized), e1 from the trial vector (the field direction;
    replaced by the x1 axis when degenerate), e2/e3 from coordinate axes.
    Returns (e_con, e_cov), each (..., 4, 4), with ``e_cov`` built by
    lowering each basis vector and flipping the sign of the time row.
    """
    dtype = u_con.dtype
    batch = u_con.shape[:-1]

    e0 = _normalize(u_con, g_cov)

    trial_norm = dot(trial, trial, g_cov)
    axis1 = jnp.zeros(batch + (4,), dtype).at[..., 1].set(1.0)
    t1 = jnp.where((trial_norm < 1.0e-30)[..., None], axis1, trial)
    e1 = _normalize(_project_out(t1, e0, g_cov), g_cov)

    axis2 = jnp.zeros(batch + (4,), dtype).at[..., 2].set(1.0)
    e2 = _normalize(_project_out(_project_out(axis2, e0, g_cov), e1, g_cov), g_cov)

    axis3 = jnp.zeros(batch + (4,), dtype).at[..., 3].set(1.0)
    e3 = _project_out(axis3, e0, g_cov)
    e3 = _project_out(e3, e1, g_cov)
    e3 = _normalize(_project_out(e3, e2, g_cov), g_cov)

    e_con = jnp.stack([e0, e1, e2, e3], axis=-2)
    e_cov = jnp.einsum("...mi,...ij->...mj", e_con, g_cov, precision=_HI)
    e_cov = e_cov.at[..., 0, :].multiply(-1.0)
    return e_con, e_cov


def coordinate_to_tetrad(e_cov, k):
    """k^(mu-hat) = e_cov[mu, j] k^j (tetrads.cpp:46-55)."""
    return jnp.einsum("...mj,...j->...m", e_cov, k, precision=_HI)


def tetrad_to_coordinate(e_con, k_tetrad):
    """k^i = e_con[mu, i] k^(mu-hat) (tetrads.cpp:57-66)."""
    return jnp.einsum("...mi,...m->...i", e_con, k_tetrad, precision=_HI)


# ---------------------------------------------------------------------------
# component layer (transport hot path; see geometry module docstring)
# ---------------------------------------------------------------------------

def _normalize_c(v, g7):
    from grmonty.ops import geometry

    norm = jnp.sqrt(jnp.abs(geometry.dot_cov_c(g7, v, v)))
    return tuple(c / norm for c in v)


def _project_out_c(va, vb, g7):
    from grmonty.ops import geometry

    vb_sq = geometry.dot_cov_c(g7, vb, vb)
    fac = geometry.dot_cov_c(g7, va, vb) / vb_sq
    return tuple(a - b * fac for a, b in zip(va, vb))


def make_tetrad_c(u_con, trial, g7):
    """Component-form Gram-Schmidt tetrad (tetrads.cpp:68-124).

    ``u_con``/``trial``: 4-tuples of (N,) arrays; ``g7``: the 7-component
    covariant metric tuple.  Returns (e_con, e_cov): each a 4-tuple (over
    basis index mu) of 4-tuples (over coordinate index) of (N,) arrays.
    """
    from grmonty.ops import geometry

    zero = jnp.zeros_like(u_con[0])
    one = jnp.ones_like(u_con[0])

    e0 = _normalize_c(u_con, g7)

    trial_norm = geometry.dot_cov_c(g7, trial, trial)
    degen = trial_norm < 1.0e-30
    t1 = (
        jnp.where(degen, zero, trial[0]),
        jnp.where(degen, one, trial[1]),
        jnp.where(degen, zero, trial[2]),
        jnp.where(degen, zero, trial[3]),
    )
    e1 = _normalize_c(_project_out_c(t1, e0, g7), g7)

    axis2 = (zero, zero, one, zero)
    e2 = _normalize_c(_project_out_c(_project_out_c(axis2, e0, g7), e1, g7), g7)

    axis3 = (zero, zero, zero, one)
    e3 = _project_out_c(axis3, e0, g7)
    e3 = _project_out_c(e3, e1, g7)
    e3 = _normalize_c(_project_out_c(e3, e2, g7), g7)

    e_con = (e0, e1, e2, e3)
    # e_cov[mu] = lower(e_con[mu]); time row sign-flipped (tetrads.cpp:126-155)
    low0 = geometry.lower_c(g7, e0)
    e_cov = (
        tuple(-c for c in low0),
        geometry.lower_c(g7, e1),
        geometry.lower_c(g7, e2),
        geometry.lower_c(g7, e3),
    )
    return e_con, e_cov


def coordinate_to_tetrad_c(e_cov, k):
    """k^(mu-hat) = e_cov[mu][j] k^j, component form (tetrads.cpp:46-55)."""
    return tuple(
        e[0] * k[0] + e[1] * k[1] + e[2] * k[2] + e[3] * k[3] for e in e_cov
    )


def tetrad_to_coordinate_c(e_con, k_tet):
    """k^i = e_con[mu][i] k^(mu-hat), component form (tetrads.cpp:57-66)."""
    return tuple(
        k_tet[0] * e_con[0][i]
        + k_tet[1] * e_con[1][i]
        + k_tet[2] * e_con[2][i]
        + k_tet[3] * e_con[3][i]
        for i in range(4)
    )


def boost_c(v, u):
    """Component-form Lorentz boost (harm_model.cpp:1658-1671)."""
    g = u[0]
    vel = jnp.sqrt(jnp.abs(1.0 - 1.0 / (g * g)))
    denom = g * vel + consts.EPS
    n1 = u[1] / denom
    n2 = u[2] / denom
    n3 = u[3] / denom
    gm1 = g - 1.0

    v0, v1, v2, v3 = v
    vp0 = u[0] * v0 - u[1] * v1 - u[2] * v2 - u[3] * v3
    vp1 = -u[1] * v0 + (1.0 + n1 * n1 * gm1) * v1 + n1 * n2 * gm1 * v2 + n1 * n3 * gm1 * v3
    vp2 = -u[2] * v0 + n2 * n1 * gm1 * v1 + (1.0 + n2 * n2 * gm1) * v2 + n2 * n3 * gm1 * v3
    vp3 = -u[3] * v0 + n3 * n1 * gm1 * v1 + n3 * n2 * gm1 * v2 + (1.0 + n3 * n3 * gm1) * v3
    return (vp0, vp1, vp2, vp3)


def boost(v, u):
    """General Lorentz boost of v into the frame of 4-velocity u.

    Flat-space boost used inside the scattering kinematics in the local
    tetrad frame (harm_model.cpp:1658-1671).
    """
    g = u[..., 0]
    vel = jnp.sqrt(jnp.abs(1.0 - 1.0 / (g * g)))
    denom = g * vel + consts.EPS
    n1 = u[..., 1] / denom
    n2 = u[..., 2] / denom
    n3 = u[..., 3] / denom
    gm1 = g - 1.0

    v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    vp0 = u[..., 0] * v0 - u[..., 1] * v1 - u[..., 2] * v2 - u[..., 3] * v3
    vp1 = -u[..., 1] * v0 + (1.0 + n1 * n1 * gm1) * v1 + n1 * n2 * gm1 * v2 + n1 * n3 * gm1 * v3
    vp2 = -u[..., 2] * v0 + n2 * n1 * gm1 * v1 + (1.0 + n2 * n2 * gm1) * v2 + n2 * n3 * gm1 * v3
    vp3 = -u[..., 3] * v0 + n3 * n1 * gm1 * v1 + n3 * n2 * gm1 * v2 + (1.0 + n3 * n3 * gm1) * v3
    return jnp.stack([vp0, vp1, vp2, vp3], axis=-1)
