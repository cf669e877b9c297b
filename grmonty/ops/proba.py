"""Monte Carlo samplers for Compton scattering, vectorized with masked
rejection loops.

Equivalent of ``cuda_grmonty/proba.cpp:30-215`` (host mt19937 version) and
``proba.cuh:197-294`` (Philox device version).  Design differences, both
batch-friendly and statistically equivalent:

* RNG is JAX threefry.  Each call site draws a whole batch from one key
  (photons are exchangeable; acceptance is per-lane masked), instead of one
  sequential stream per photon.
* Rejection loops are ``lax.while_loop``s over the full batch with an
  accepted mask; iteration caps replace the reference's unbounded loops.
  The caps are generous enough that truncation is statistically invisible
  (the reference itself halves theta_e after 1e7 failed tries as an
  anti-stall, proba.cpp:59-64; we halve every ``_STALL_ITERS`` rounds).
* chi-squared variates come from ``jax.random.chisquare`` (Gamma sampler)
  rather than summing squared normals.
"""

import math
import os

import jax
import jax.numpy as jnp
from jax import lax
from jax import random

PI = math.pi

_MAX_REJECT_ITERS = 256  # cap on masked rejection rounds
_STALL_ITERS = 64  # rounds between anti-stall theta_e halvings
# The electron sampler's acceptance is sigma_KN(k_eff) which can sit at a few
# percent for the hottest lanes; the whole batch pays the max round count, so
# its loop gets a tighter cap with an earlier anti-stall (the reference's
# anti-stall is the same mechanism at scalar cost, proba.cpp:59-64).  At the
# cap the last draw is kept: ~0.1% of electrons from the p99.9 acceptance
# tail get a slightly under-weighted KN rejection — statistically invisible
# next to the MC noise (validated by the sampler-distribution tests).
_MAX_ELECTRON_ITERS = 64
_ELECTRON_STALL_ITERS = 32
# Round caps for the deferring event samplers (engine periodic phase): a
# lane that fails all rounds is NOT truncated — its event retries at the
# next phase with a fresh key.  Each sampler's while_loop exits as soon as
# every lane accepted, so a high cap costs nothing in typical phases.
#
# The KN cap must be HIGH: a deferred event redraws the ELECTRON next
# phase, and KN acceptance falls with the electron-frame photon energy
# k0p ~ gamma — so KN-stage defers reweight the joint (electron, KN)
# sample toward low-gamma electrons (the reference never redraws the
# electron, proba.cpp:30-112/174-189).  At cap 16 this soft bias showed as
# part of the top-Compton-band flux deficit vs the compiled reference
# binary (VSREF r4); at 128 rounds KN defers are ~extinct.
_ELECTRON_CAP_DEFER = 16
_KN_CAP_DEFER = int(os.environ.get("GRMONTY_KN_CAP", "128"))
_THOMSON_CAP = 16


def sample_y_distr(key, theta_e):
    """Sample y with gamma_e = y^2 theta_e + 1 from the Maxwell-Juettner
    distribution via Canfield-style chi^2 mixture + rejection (proba.cpp:123-166).

    ``theta_e``: (N,).  Returns y: (N,).
    """
    pi_3 = math.sqrt(PI) / 4.0 * jnp.ones_like(theta_e)
    pi_4 = jnp.sqrt(0.5 * theta_e) / 2.0
    pi_5 = 3.0 * math.sqrt(PI) * theta_e / 8.0
    pi_6 = theta_e * jnp.sqrt(0.5 * theta_e)
    s3 = pi_3 + pi_4 + pi_5 + pi_6
    c1 = pi_3 / s3
    c2 = (pi_3 + pi_4) / s3
    c3 = (pi_3 + pi_4 + pi_5) / s3

    shape = theta_e.shape
    dtype = theta_e.dtype

    def body(state):
        key, y, accepted, it = state
        key, k1, k2, k3 = random.split(key, 4)
        x1 = random.uniform(k1, shape, dtype)
        dof = jnp.where(
            x1 < c1, 3, jnp.where(x1 < c2, 4, jnp.where(x1 < c3, 5, 6))
        )
        # chi^2(dof) as a masked sum of squared normals — the GPU reference's
        # construction (proba.cuh:229), and loop-free on device unlike the
        # gamma rejection sampler inside jax.random.chisquare.
        nrm = random.normal(k2, (6,) + shape, dtype)
        use = jax.lax.broadcasted_iota(jnp.int32, (6,) + shape, 0) < dof[None, ...]
        x = jnp.sum(jnp.where(use, nrm * nrm, 0.0), axis=0)
        y_new = jnp.sqrt(x / 2.0)

        x2 = random.uniform(k3, shape, dtype)
        num = jnp.sqrt(1.0 + 0.5 * theta_e * y_new * y_new)
        den = 1.0 + y_new * jnp.sqrt(0.5 * theta_e)
        accept = x2 < num / den

        take = accept & ~accepted
        y = jnp.where(take, y_new, y)
        return key, y, accepted | accept, it + 1

    def cond(state):
        _, _, accepted, it = state
        return (~jnp.all(accepted)) & (it < _MAX_REJECT_ITERS)

    key, y, accepted, _ = lax.while_loop(
        cond, body, (key, jnp.ones(shape, dtype), jnp.zeros(shape, bool), 0)
    )
    return y


def sample_beta_distr(key, theta_e):
    """(gamma_e, beta_e) of a thermal electron (proba.cpp:114-121)."""
    y = sample_y_distr(key, theta_e)
    gamma_e = y * y * theta_e + 1.0
    beta_e = jnp.sqrt(1.0 - 1.0 / (gamma_e * gamma_e))
    return gamma_e, beta_e


def sample_mu_distr(key, beta_e):
    """Pitch-angle cosine weighted by relative flux (proba.cpp:168-172)."""
    x1 = random.uniform(key, beta_e.shape, beta_e.dtype)
    det = 1.0 + 2.0 * beta_e + beta_e * beta_e - 4.0 * beta_e * x1
    return (1.0 - jnp.sqrt(det)) / (beta_e + 1e-30)


def sample_rand_dir(key, shape, dtype):
    """Isotropic unit vector (proba.cpp:202-210)."""
    k1, k2 = random.split(key)
    z = random.uniform(k1, shape, dtype) * 2.0 - 1.0
    phi = random.uniform(k2, shape, dtype) * 2.0 * PI
    s = jnp.sqrt(1.0 - z * z)
    return s * jnp.cos(phi), s * jnp.sin(phi), z


def _sigma_kn_total(k_eff):
    """Total KN cross-section / sigma_T at photon energy k_eff (proba.cpp:50-55)."""
    k = jnp.maximum(k_eff, 1e-30)
    full = (3.0 / (4.0 * k * k)) * (
        2.0
        + k * k * (1.0 + k) / ((1.0 + 2.0 * k) ** 2)
        + (k * k - 2.0 * k - 2.0) / (2.0 * k) * jnp.log1p(2.0 * k)
    )
    return jnp.where(k_eff < 1.0e-3, 1.0 - 2.0 * k_eff, full)


def sample_electron_distr_p(key, k, theta_e):
    """Sample a thermal electron 4-momentum p, weighted by the Klein-Nishina
    cross-section at the boosted photon energy (proba.cpp:30-112).

    ``k``: (N, 4) photon wave vector in the tetrad frame; ``theta_e``: (N,).
    Returns p: (N, 4) with p^0 = gamma_e.
    """
    shape = theta_e.shape
    dtype = theta_e.dtype

    def body(state):
        key, th_e, gamma, beta, mu, accepted, it = state
        key, k1, k2, k3 = random.split(key, 4)
        g_new, b_new = sample_beta_distr(k1, th_e)
        mu_new = jnp.clip(sample_mu_distr(k2, b_new), -1.0, 1.0)

        k_eff = g_new * (1.0 - b_new * mu_new) * k[..., 0]
        sigma_kn = _sigma_kn_total(k_eff)
        accept = random.uniform(k3, shape, dtype) < sigma_kn

        take = accept & ~accepted
        gamma = jnp.where(take, g_new, gamma)
        beta = jnp.where(take, b_new, beta)
        mu = jnp.where(take, mu_new, mu)
        # Anti-stall: halve theta_e for lanes still rejecting (proba.cpp:59-64).
        stall = ((it + 1) % _STALL_ITERS == 0) & ~(accepted | accept)
        th_e = jnp.where(stall, th_e * 0.5, th_e)
        return key, th_e, gamma, beta, mu, accepted | accept, it + 1

    def cond(state):
        *_, accepted, it = state
        return (~jnp.all(accepted)) & (it < _MAX_REJECT_ITERS)

    init = (
        key,
        theta_e,
        jnp.ones(shape, dtype),
        jnp.zeros(shape, dtype),
        jnp.zeros(shape, dtype),
        jnp.zeros(shape, bool),
        0,
    )
    key, _, gamma_e, beta_e, mu, _, _ = lax.while_loop(cond, body, init)

    # Build the electron momentum direction about the photon axis
    # (proba.cpp:67-107).
    v0 = k[..., 1:4]
    v0 = v0 / jnp.linalg.norm(v0, axis=-1, keepdims=True)

    key, kd, kp = random.split(key, 3)
    n0x, n0y, n0z = sample_rand_dir(kd, shape, dtype)
    n0 = jnp.stack([n0x, n0y, n0z], axis=-1)
    n0dotv0 = jnp.sum(n0 * v0, axis=-1, keepdims=True)
    v1 = n0 - n0dotv0 * v0
    v1 = v1 / jnp.linalg.norm(v1, axis=-1, keepdims=True)
    v2 = jnp.cross(v0, v1)

    phi = random.uniform(kp, shape, dtype) * 2.0 * PI
    c_th = mu
    s_th = jnp.sqrt(1.0 - mu * mu)
    direction = (
        c_th[..., None] * v0
        + s_th[..., None] * (jnp.cos(phi)[..., None] * v1 + jnp.sin(phi)[..., None] * v2)
    )
    p_spatial = (gamma_e * beta_e)[..., None] * direction
    return jnp.concatenate([gamma_e[..., None], p_spatial], axis=-1)


def sample_electron_distr_p_c(key, k, theta_e, force=None,
                              cap=_ELECTRON_CAP_DEFER):
    """Component-form :func:`sample_electron_distr_p` for the hot path.

    ``k``: 4-tuple of (N,) tetrad-frame wave-vector components.
    Returns ``(p_tuple, ok)``: the electron 4-momentum as a 4-tuple and a
    per-lane acceptance mask.

    Batched redesign of the reference's nested rejection (proba.cpp:30-112,
    which loops {draw MJ electron via its own rejection loop; accept with
    prob sigma_KN}): ONE flat loop whose proposal is (chi2-mixture y,
    flux-weighted mu) and whose acceptance is the product of the
    Maxwell-Juettner correction and the KN test.  The accepted joint
    density is proposal x both acceptance factors — identical to the
    nested version — but each round is one fused batch body instead of a
    nested while_loop with its own all-lane reductions, and the round cap
    can be small: lanes not accepted within ``cap`` rounds report
    ok=False and the caller DEFERS the event to the next periodic phase
    (a fresh key), so the cap truncates nothing.  ``force`` lanes accept
    their final proposal at the cap (the anti-stall escalation after
    repeated defers; the reference's analogue halves theta_e after 1e7
    scalar tries, proba.cpp:59-64).
    """
    shape = theta_e.shape
    dtype = theta_e.dtype
    k0c, k1c, k2c, k3c = k
    if force is None:
        force = jnp.zeros(shape, bool)

    pi_3 = math.sqrt(PI) / 4.0 * jnp.ones_like(theta_e)
    pi_4 = jnp.sqrt(0.5 * theta_e) / 2.0
    pi_5 = 3.0 * math.sqrt(PI) * theta_e / 8.0
    pi_6 = theta_e * jnp.sqrt(0.5 * theta_e)
    s3 = pi_3 + pi_4 + pi_5 + pi_6
    c1 = pi_3 / s3
    c2 = (pi_3 + pi_4) / s3
    c3 = (pi_3 + pi_4 + pi_5) / s3

    def body(state):
        key, gamma, beta, mu, accepted, it = state
        key, k1, k2, k3, k4, k5 = random.split(key, 6)
        x1 = random.uniform(k1, shape, dtype)
        dof = jnp.where(
            x1 < c1, 3, jnp.where(x1 < c2, 4, jnp.where(x1 < c3, 5, 6))
        )
        nrm = random.normal(k2, (6,) + shape, dtype)
        use = jax.lax.broadcasted_iota(jnp.int32, (6,) + shape, 0) < dof[None, ...]
        y_new = jnp.sqrt(jnp.sum(jnp.where(use, nrm * nrm, 0.0), axis=0) / 2.0)

        num = jnp.sqrt(1.0 + 0.5 * theta_e * y_new * y_new)
        den = 1.0 + y_new * jnp.sqrt(0.5 * theta_e)
        accept_y = random.uniform(k3, shape, dtype) < num / den

        g_new = y_new * y_new * theta_e + 1.0
        b_new = jnp.sqrt(1.0 - 1.0 / (g_new * g_new))
        mu_new = jnp.clip(sample_mu_distr(k4, b_new), -1.0, 1.0)

        k_eff = g_new * (1.0 - b_new * mu_new) * k0c
        sigma_kn = _sigma_kn_total(k_eff)
        accept_kn = random.uniform(k5, shape, dtype) < sigma_kn

        accept = accept_y & accept_kn
        take = (accept | ((it + 1 >= cap) & force)) & ~accepted
        gamma = jnp.where(take, g_new, gamma)
        beta = jnp.where(take, b_new, beta)
        mu = jnp.where(take, mu_new, mu)
        return key, gamma, beta, mu, accepted | take, it + 1

    def cond(state):
        *_, accepted, it = state
        return (~jnp.all(accepted)) & (it < cap)

    init = (
        key,
        jnp.ones(shape, dtype), jnp.zeros(shape, dtype), jnp.zeros(shape, dtype),
        jnp.zeros(shape, bool), 0,
    )
    key, gamma_e, beta_e, mu, ok, _ = lax.while_loop(cond, body, init)

    key, kd, kp = random.split(key, 3)
    c_th, s_th = mu, jnp.sqrt(1.0 - mu * mu)
    phi = random.uniform(kp, shape, dtype) * 2.0 * PI
    dx, dy, dz = _dir_about_axis_c((k1c, k2c, k3c), kd, c_th, s_th, phi, shape, dtype)
    gb = gamma_e * beta_e
    return (gamma_e, gb * dx, gb * dy, gb * dz), ok


def _dir_about_axis_c(axis, key_dir, c_th, s_th, phi, shape, dtype):
    """Unit vector at polar angle (c_th, s_th, phi) about ``axis`` (3-tuple),
    with a random azimuthal frame (proba.cpp:67-107, component form)."""
    ax, ay, az = axis
    inv = 1.0 / jnp.sqrt(ax * ax + ay * ay + az * az + 1e-300)
    v0x, v0y, v0z = ax * inv, ay * inv, az * inv

    n0x, n0y, n0z = sample_rand_dir(key_dir, shape, dtype)
    ndv = n0x * v0x + n0y * v0y + n0z * v0z
    v1x, v1y, v1z = n0x - ndv * v0x, n0y - ndv * v0y, n0z - ndv * v0z
    inv1 = 1.0 / jnp.sqrt(v1x * v1x + v1y * v1y + v1z * v1z + 1e-300)
    v1x, v1y, v1z = v1x * inv1, v1y * inv1, v1z * inv1
    v2x = v0y * v1z - v0z * v1y
    v2y = v0z * v1x - v0x * v1z
    v2z = v0x * v1y - v0y * v1x

    cp, sp = jnp.cos(phi), jnp.sin(phi)
    dx = c_th * v0x + s_th * (cp * v1x + sp * v2x)
    dy = c_th * v0y + s_th * (cp * v1y + sp * v2y)
    dz = c_th * v0z + s_th * (cp * v1z + sp * v2z)
    return dx, dy, dz


def klein_nishina(a, ap):
    """KN differential cross-section kernel (proba.cpp:212-215)."""
    ch = 1.0 + 1.0 / a - 1.0 / ap
    return (a / ap + ap / a - 1.0 + ch * ch) / (a * a)


def sample_klein_nishina(key, k0):
    """Scattered photon energy from the KN differential distribution
    (rejection over k0p, proba.cpp:174-189).  ``k0``: (N,)."""
    shape = k0.shape
    dtype = k0.dtype
    k0pmin = k0 / (1.0 + 2.0 * k0)
    k0pmax = k0
    envelope = 2.0 * (1.0 + 2.0 * k0 + 2.0 * k0 * k0) / (k0 * k0 * (1.0 + 2.0 * k0))

    def body(state):
        key, k0p, accepted, it = state
        key, k1, k2 = random.split(key, 3)
        tent = k0pmin + (k0pmax - k0pmin) * random.uniform(k1, shape, dtype)
        x1 = envelope * random.uniform(k2, shape, dtype)
        accept = x1 < klein_nishina(k0, tent)
        k0p = jnp.where(accept & ~accepted, tent, k0p)
        return key, k0p, accepted | accept, it + 1

    def cond(state):
        _, _, accepted, it = state
        return (~jnp.all(accepted)) & (it < _MAX_REJECT_ITERS)

    _, k0p, _, _ = lax.while_loop(cond, body, (key, k0pmax, jnp.zeros(shape, bool), 0))
    return k0p


def sample_klein_nishina_c(key, k0, force=None, cap=_KN_CAP_DEFER):
    """Deferring-capped :func:`sample_klein_nishina` for the engine's
    periodic event phase: returns ``(k0p, ok)``.  Lanes not accepted
    within ``cap`` rounds report ok=False (the caller defers the whole
    scatter event to the next phase); ``force`` lanes take their final
    tentative draw at the cap instead."""
    shape = k0.shape
    dtype = k0.dtype
    if force is None:
        force = jnp.zeros(shape, bool)
    k0pmin = k0 / (1.0 + 2.0 * k0)
    k0pmax = k0
    envelope = 2.0 * (1.0 + 2.0 * k0 + 2.0 * k0 * k0) / (k0 * k0 * (1.0 + 2.0 * k0))

    def body(state):
        key, k0p, accepted, it = state
        key, k1, k2 = random.split(key, 3)
        tent = k0pmin + (k0pmax - k0pmin) * random.uniform(k1, shape, dtype)
        x1 = envelope * random.uniform(k2, shape, dtype)
        accept = x1 < klein_nishina(k0, tent)
        take = (accept | ((it + 1 >= cap) & force)) & ~accepted
        k0p = jnp.where(take, tent, k0p)
        return key, k0p, accepted | take, it + 1

    def cond(state):
        _, _, accepted, it = state
        return (~jnp.all(accepted)) & (it < cap)

    _, k0p, ok, _ = lax.while_loop(
        cond, body, (key, k0pmax, jnp.zeros(shape, bool), 0))
    return k0p, ok


def sample_thomson(key, shape, dtype, cap=_MAX_REJECT_ITERS):
    """Scattering cosine from the Thomson phase function (proba.cpp:191-200)."""

    def body(state):
        key, c_th, accepted, it = state
        key, k1, k2 = random.split(key, 3)
        x1 = 2.0 * random.uniform(k1, shape, dtype) - 1.0
        x2 = (3.0 / 4.0) * random.uniform(k2, shape, dtype)
        accept = x2 < (3.0 / 8.0) * (1.0 + x1 * x1)
        c_th = jnp.where(accept & ~accepted, x1, c_th)
        return key, c_th, accepted | accept, it + 1

    def cond(state):
        _, _, accepted, it = state
        return (~jnp.all(accepted)) & (it < cap)

    _, c_th, _, _ = lax.while_loop(
        cond, body, (key, jnp.zeros(shape, dtype), jnp.zeros(shape, bool), 0)
    )
    return c_th
