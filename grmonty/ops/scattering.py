"""Compton scattering event kinematics, vectorized over a photon batch.

Equivalent of ``cuda_grmonty/harm_model.cpp``: ``scatter_super_photon``
:1071-1145 and ``sample_scattered_photon`` :1147-1215 (GPU mirror
``super_photon.cu:1474-1571``).

Given photons at a scattering event, build the local fluid tetrad, sample a
thermal electron weighted by the Klein-Nishina cross-section, sample the
scattered photon energy/direction (KN for hot photons in the electron rest
frame, Thomson phase function otherwise), and return the secondary photon's
coordinate-frame wave vector and conserved quantities.  All lanes compute;
the ``ok``/validity masks tell the caller which results to use.
"""

import math
import typing

import jax.numpy as jnp
from jax import random

from grmonty.ops import proba, tetrads

PI = math.pi


class ScatterResult(typing.NamedTuple):
    parent_die: jnp.ndarray  # (N,) bool: parent weight must be zeroed
    made: jnp.ndarray  # (N,) bool: a valid secondary was produced
    k_sec: jnp.ndarray  # (N, 4) secondary wave vector (coordinate frame)
    e_sec: jnp.ndarray  # (N,) secondary energy -k_t
    l_sec: jnp.ndarray  # (N,) secondary angular momentum k_phi
    sec_w_zero: jnp.ndarray  # (N,) bool: secondary created with zero weight


def sample_scattered_photon(key, k_tet, p):
    """Scattered photon tetrad wave vector given incident k and electron p
    (harm_model.cpp:1147-1215).  All inputs (N, 4) in the local tetrad frame.
    """
    shape = k_tet.shape[:-1]
    dtype = k_tet.dtype

    ke = tetrads.boost(k_tet, p)
    ke0 = ke[..., 0]

    key, k_kn, k_th, k_dir, k_phi = random.split(key, 5)
    # Hot branch: Klein-Nishina energy sampling in the electron rest frame.
    k0_safe = jnp.maximum(ke0, 1.0e-4)
    k0p_kn = proba.sample_klein_nishina(k_kn, k0_safe)
    c_th_kn = 1.0 - 1.0 / k0p_kn + 1.0 / k0_safe
    # Cold branch: elastic with Thomson angular distribution.
    c_th_t = proba.sample_thomson(k_th, shape, dtype)

    hot = ke0 > 1.0e-4
    k0p = jnp.where(hot, k0p_kn, ke0)
    c_th = jnp.where(hot, c_th_kn, c_th_t)
    s_th = jnp.sqrt(jnp.abs(1.0 - c_th * c_th))

    v0 = ke[..., 1:4] / ke0[..., None]
    n0x, n0y, n0z = proba.sample_rand_dir(k_dir, shape, dtype)
    n0 = jnp.stack([n0x, n0y, n0z], axis=-1)
    n0dotv0 = jnp.sum(n0 * v0, axis=-1, keepdims=True)
    v1 = n0 - n0dotv0 * v0
    v1 = v1 / jnp.linalg.norm(v1, axis=-1, keepdims=True)
    v2 = jnp.cross(v0, v1)

    phi = 2.0 * PI * random.uniform(k_phi, shape, dtype)
    direction = (
        c_th[..., None] * v0
        + s_th[..., None] * (jnp.cos(phi)[..., None] * v1 + jnp.sin(phi)[..., None] * v2)
    )
    kpe = jnp.concatenate([k0p[..., None], k0p[..., None] * direction], axis=-1)

    # Boost back to the tetrad frame: flip the electron's spatial momentum.
    p_rev = p.at[..., 1:4].multiply(-1.0)
    return tetrads.boost(kpe, p_rev)


# ---------------------------------------------------------------------------
# component layer (transport hot path; see geometry module docstring)
# ---------------------------------------------------------------------------

class ScatterResultC(typing.NamedTuple):
    parent_die: jnp.ndarray  # (N,) bool
    made: jnp.ndarray  # (N,) bool
    k_sec: tuple  # 4x (N,) coordinate-frame secondary wave vector
    e_sec: jnp.ndarray
    l_sec: jnp.ndarray
    sampled: jnp.ndarray  # (N,) bool: all rejection samplers accepted —
    #   lanes with sampled=False must be DEFERRED to the next periodic
    #   phase (retried with a fresh key), not consumed


def sample_scattered_photon_c(key, k_tet, p, force=None):
    """Component-form :func:`sample_scattered_photon`; ``k_tet``/``p``
    are 4-tuples of (N,) arrays.  Returns ``(k_tet_p, ok)`` where ok
    reports KN-sampler acceptance within the deferring round cap (cold
    Thomson lanes are always ok; see proba.sample_klein_nishina_c)."""
    shape = k_tet[0].shape
    dtype = k_tet[0].dtype

    ke = tetrads.boost_c(k_tet, p)
    ke0 = ke[0]

    key, k_kn, k_th, k_dir, k_phi = random.split(key, 5)
    k0_safe = jnp.maximum(ke0, 1.0e-4)
    k0p_kn, ok_kn = proba.sample_klein_nishina_c(k_kn, k0_safe, force=force)
    c_th_kn = 1.0 - 1.0 / k0p_kn + 1.0 / k0_safe
    c_th_t = proba.sample_thomson(k_th, shape, dtype, cap=proba._THOMSON_CAP)

    hot = ke0 > 1.0e-4
    k0p = jnp.where(hot, k0p_kn, ke0)
    c_th = jnp.where(hot, c_th_kn, c_th_t)
    s_th = jnp.sqrt(jnp.abs(1.0 - c_th * c_th))

    phi = 2.0 * PI * random.uniform(k_phi, shape, dtype)
    dx, dy, dz = proba._dir_about_axis_c(
        (ke[1], ke[2], ke[3]), k_dir, c_th, s_th, phi, shape, dtype
    )
    kpe = (k0p, k0p * dx, k0p * dy, k0p * dz)

    p_rev = (p[0], -p[1], -p[2], -p[3])
    return tetrads.boost_c(kpe, p_rev), ok_kn | ~hot


def scatter_event_c(key, k_coord, fl, g7, b_unit, active=None,
                    force=None) -> ScatterResultC:
    """Component-form :func:`scatter_event` (harm_model.cpp:1071-1145).

    ``k_coord``: 4-tuple of (N,) wave-vector components; ``fl``: FluidC at
    the event; ``g7``: covariant metric component tuple.  ``active`` masks
    the lanes actually at a scatter event: inactive lanes get placeholder
    sampler inputs so they accept immediately — otherwise a single
    high-energy bystander lane (sigma_KN ~ 1e-2) drags every masked
    rejection loop to its round cap, which the whole batch pays.

    The rejection samplers run with small round caps; a lane that fails a
    cap comes back with ``sampled=False`` and must be retried at the next
    periodic phase (the engine keeps it at_event).  ``force`` lanes accept
    their final draw at the caps (anti-stall escalation after repeated
    defers).
    """
    k0 = k_coord[0]
    parent_die = (
        (k0 > 1.0e5)
        | (k0 < 0.0)
        | jnp.isnan(k0)
        | jnp.isnan(k_coord[1])
        | jnp.isnan(k_coord[3])
    )

    # Field-direction trial vector; x1 axis when unmagnetized (:1083-1094).
    b_code = fl.b / b_unit
    mag = fl.b > 0.0
    inv_b = 1.0 / jnp.maximum(b_code, 1e-30)
    zero = jnp.zeros_like(fl.b)
    b_hat = (
        jnp.where(mag, fl.b_con[0] * inv_b, zero),
        jnp.where(mag, fl.b_con[1] * inv_b, jnp.ones_like(fl.b)),
        jnp.where(mag, fl.b_con[2] * inv_b, zero),
        jnp.where(mag, fl.b_con[3] * inv_b, zero),
    )

    e_con, e_cov = tetrads.make_tetrad_c(fl.u_con, b_hat, g7)
    k_tet = tetrads.coordinate_to_tetrad_c(e_cov, k_coord)

    kt0 = k_tet[0]
    invalid_frame = (kt0 > 1.0e5) | (kt0 < 0.0) | jnp.isnan(k_tet[1])

    key, k_el, k_sc = random.split(key, 3)
    guard = invalid_frame | parent_die
    if active is not None:
        guard = guard | ~active
    k_tet_safe = (
        jnp.where(guard, 1.0e-6, k_tet[0]),
        jnp.where(guard, 1.0e-6, k_tet[1]),
        jnp.where(guard, 0.0, k_tet[2]),
        jnp.where(guard, 0.0, k_tet[3]),
    )
    theta_safe = jnp.maximum(fl.theta_e, 1e-4)
    p_el, ok_el = proba.sample_electron_distr_p_c(
        k_el, k_tet_safe, theta_safe, force=force)
    k_tet_p, ok_kn = sample_scattered_photon_c(
        k_sc, k_tet_safe, p_el, force=force)

    k_sec = tetrads.tetrad_to_coordinate_c(e_con, k_tet_p)
    sec_w_zero = jnp.isnan(k_sec[1])

    # Conserved quantities from the dual basis with the time sign flipped
    # (harm_model.cpp:1123-1129).
    k_tet_flip = (-k_tet_p[0], k_tet_p[1], k_tet_p[2], k_tet_p[3])
    tmp = tetrads.tetrad_to_coordinate_c(e_cov, k_tet_flip)
    e_sec = -tmp[0]
    l_sec = tmp[3]

    # Guarded/invalid lanes never defer (their event resolves as a
    # parent-death or no-secondary outcome regardless of sampler luck).
    sampled = ok_el & ok_kn | guard
    made = ~(parent_die | invalid_frame | sec_w_zero)
    return ScatterResultC(parent_die, made, k_sec, e_sec, l_sec, sampled)


def scatter_event(key, k_coord, fluid, g_cov, b_unit) -> ScatterResult:
    """Full scattering event for a batch of photons (harm_model.cpp:1071-1145).

    ``k_coord``: (N, 4) coordinate-frame wave vectors at the event;
    ``fluid``: FluidState at the event; ``g_cov``: (N, 4, 4).
    """
    k0 = k_coord[..., 0]
    parent_die = (
        (k0 > 1.0e5)
        | (k0 < 0.0)
        | jnp.isnan(k0)
        | jnp.isnan(k_coord[..., 1])
        | jnp.isnan(k_coord[..., 3])
    )

    # Field-direction trial vector; x1 axis when unmagnetized
    # (harm_model.cpp:1083-1094).
    b_code = fluid.b / b_unit
    b_hat = jnp.where(
        (fluid.b > 0.0)[..., None],
        fluid.b_con / jnp.maximum(b_code, 1e-30)[..., None],
        jnp.zeros_like(fluid.b_con).at[..., 1].set(1.0),
    )

    e_con, e_cov = tetrads.make_tetrad(fluid.u_con, b_hat, g_cov)
    k_tet = tetrads.coordinate_to_tetrad(e_cov, k_coord)

    kt0 = k_tet[..., 0]
    invalid_frame = (kt0 > 1.0e5) | (kt0 < 0.0) | jnp.isnan(k_tet[..., 1])

    key, k_el, k_sc = random.split(key, 3)
    # Guard the sampler inputs on invalid lanes (results are masked out).
    k_tet_safe = jnp.where(
        invalid_frame[..., None] | parent_die[..., None],
        jnp.zeros_like(k_tet).at[..., 0].set(1.0e-6).at[..., 1].set(1.0e-6),
        k_tet,
    )
    theta_safe = jnp.maximum(fluid.theta_e, 1e-4)
    p_el = proba.sample_electron_distr_p(k_el, k_tet_safe, theta_safe)
    k_tet_p = sample_scattered_photon(k_sc, k_tet_safe, p_el)

    k_sec = tetrads.tetrad_to_coordinate(e_con, k_tet_p)
    sec_w_zero = jnp.isnan(k_sec[..., 1])

    # Conserved quantities from the dual basis with the time sign flipped
    # (harm_model.cpp:1123-1129).
    k_tet_flip = k_tet_p.at[..., 0].multiply(-1.0)
    tmp = tetrads.tetrad_to_coordinate(e_cov, k_tet_flip)
    e_sec = -tmp[..., 0]
    l_sec = tmp[..., 3]

    made = ~(parent_die | invalid_frame | sec_w_zero)
    return ScatterResult(parent_die, made, k_sec, e_sec, l_sec, sec_w_zero)
