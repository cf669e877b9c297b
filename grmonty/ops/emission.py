"""Superphoton emission: importance tables, zone budgets, batched sampling.

Equivalent of the reference's emission subsystem:

* ``init_weight_table``  (harm_model.cpp:268-306)  -> :func:`weight_table`
* ``init_nint_table``    (harm_model.cpp:308-338)  -> :func:`nint_table`
* ``init_zone``          (harm_model.cpp:1337-1389)-> :func:`zone_budgets`
* ``get_zone`` stochastic rounding (:693-697)      -> :func:`zone_counts`
* ``sample_zone_photon`` (harm_model.cpp:706-782)  -> :func:`sample_photons`

The reference feeds zones one at a time through a producer thread + 4
sampling workers + a bounded queue (harm_model.cpp:813-892, utils.hpp).
Here the whole emission pass is three vectorized device computations: per-zone
expected counts for all zones at once, stochastically rounded counts, then
one masked-rejection sampling pass over the full photon batch (each photon
carries its zone id; per-zone state is gathered).
"""

import math
import typing

import jax.numpy as jnp
import numpy as np
from jax import lax, random

from grmonty import consts
from grmonty.ops import jnu, tetrads

PI = math.pi

_MAX_REJECT_ITERS = 1024

# Inverse-CDF sampler tables (see build_nu_cdf / build_theta_quantiles).
NU_CDF_NODES = 512
TH_X_NODES = 384  # log10(x90) grid of the direction quantile table
TH_U_NODES = 513  # quantile nodes per x90 row
TH_LX_MIN, TH_LX_MAX = -14.0, 13.0


class SamplerTables(typing.NamedTuple):
    """Device tables for the inverse-CDF emission sampler.

    Rationale: the reference's rejection sampling (harm_model.cpp:736-751)
    costs a scalar CPU a mean ~1/p draws per photon, but a lockstep batch
    pays the batch-MAX draw count — the masked nu-rejection while_loop ran
    73 full-width rounds per 1M photons.  Both rejection densities are
    known functions of tabulated
    quantities, so they are sampled by inverse transform instead:

    * nu: per emitting zone, the accepted density is
      dN/dlnnu ~ F(k(nu))/W(nu) — evaluated on a 512-node lnnu grid and
      treated as log-linear between nodes (exact at nodes; chord error
      < 0.1% of the local density, far below MC noise).  Bin masses of a
      log-linear density integrate in closed form and invert exactly
      (truncated exponential), so the spectral TAIL is preserved.
    * direction: the accepted density over cos(theta) depends only on
      x90 = nu/nu_s(pi/2) (jnu.ln_synch_ratio), so ONE global quantile
      table over (log10 x90, u) serves every lane; |cos theta| is read by
      bilinear interpolation and signed with a fair coin.

    Statistical equivalence to the rejection sampler is pinned by
    tests/test_emission_cdf.py; end-to-end spectra by the chi^2 gates.
    """

    zone_map: jnp.ndarray  # (n1*n2,) int32 -> cdf row, -1 for dead zones
    lnrho: jnp.ndarray  # (Z_em, M) f32 ln density at the lnnu nodes
    cdf: jnp.ndarray  # (Z_em, M) f32 cumulative mass, [0, 1]
    theta_q: jnp.ndarray  # (TH_X_NODES, TH_U_NODES) f32 |cos theta| quantiles


def build_nu_cdf(fluid_zone, weights, f_table, nz):
    """Per-zone inverse-CDF tables for the frequency sampler (host numpy).

    ``nz``: (n1, n2) expected photon counts — zones with nz == 0 never
    receive photons and get no row.  Returns (zone_map, lnrho, cdf) as
    numpy (f32 tables; the node grid is implied by consts).
    """
    te = np.asarray(fluid_zone.theta_e, np.float64).reshape(-1)
    bb = np.asarray(fluid_zone.b, np.float64).reshape(-1)
    nz = np.asarray(nz).reshape(-1)
    emit = (nz > 0) & (te >= consts.THETA_E_MIN)
    rows = np.nonzero(emit)[0]
    zone_map = np.full(te.shape[0], -1, np.int32)
    zone_map[rows] = np.arange(rows.size, dtype=np.int32)
    zone_map = zone_map.reshape(np.asarray(fluid_zone.theta_e).shape)

    m = NU_CDF_NODES
    lnnu = consts.L_NU_MIN + (consts.N_L_N / (m - 1)) * np.arange(m)
    nu = np.exp(lnnu)
    # ln F at nodes (vectorized, numpy mirror of jnu.ln_f_eval)
    te_r = te[rows][:, None]
    b_r = bb[rows][:, None]
    k = consts.jnu.K_FAC * nu[None, :] / (b_r * te_r * te_r + consts.EPS)
    small = np.cbrt(np.maximum(k, consts.EPS))
    ln_small = np.log(small * (37.67503800178 + 2.240274341836 * small))
    f_table = np.asarray(f_table, np.float64)
    d_i = (np.log(np.maximum(k, consts.jnu.MIN_K)) - consts.jnu.L_MIN_K) / consts.jnu.D_L_K
    i = np.clip(np.floor(d_i).astype(np.int64), 0, f_table.shape[0] - 2)
    frac = d_i - i
    ln_f = (1.0 - frac) * f_table[i] + frac * f_table[i + 1]
    ln_f = np.where(k < consts.jnu.MIN_K, ln_small, ln_f)
    ln_f = np.where(k > consts.jnu.MAX_K, -np.inf, ln_f)
    # ln W at nodes (numpy mirror of _interp_weight_ln)
    weights = np.asarray(weights, np.float64)
    d_w = (lnnu - consts.L_NU_MIN) / (consts.N_L_N / consts.N_E_SAMP)
    iw = np.clip(d_w.astype(np.int64), 0, weights.shape[0] - 2)
    fw = d_w - iw
    ln_w = (1.0 - fw) * weights[iw] + fw * weights[iw + 1]

    lnr = ln_f - ln_w[None, :]
    # Frequency bins where the GLOBAL weight table holds its zero-
    # emissivity sentinel (ln 1e-300): F/W spikes there by e^+300 and the
    # rejection acceptance saturates — but the sampled photons carry
    # weight W -> 0 and are dropped on load (both here and in the
    # reference).  A CDF built on the raw ratio would give such a spike
    # ~all of a hot zone's mass (observed: zone (44,8) of the test torus
    # emitted ONLY zero-weight duds).  Zero the density wherever the
    # weight interp touches a sentinel entry.
    sentinel = (weights[iw] < -600.0) | (weights[iw + 1] < -600.0)
    lnr = np.where(sentinel[None, :], -np.inf, lnr)
    lnr = np.where(np.isfinite(lnr), lnr, -745.0)
    lnr = np.maximum(lnr - lnr.max(axis=1, keepdims=True), -745.0)

    # closed-form bin masses of the log-linear density
    r0 = np.exp(lnr[:, :-1])
    r1 = np.exp(lnr[:, 1:])
    bslope = lnr[:, 1:] - lnr[:, :-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mass = np.where(np.abs(bslope) > 1e-9, (r1 - r0) / bslope,
                        0.5 * (r0 + r1))
    mass = np.maximum(mass, 0.0)
    cum = np.concatenate(
        [np.zeros((mass.shape[0], 1)), np.cumsum(mass, axis=1)], axis=1)
    tot = cum[:, -1:]
    cdf = cum / np.maximum(tot, 1e-300)
    return zone_map, lnr.astype(np.float32), cdf.astype(np.float32)


def build_theta_quantiles():
    """Global |cos theta| quantile table over log10(x90) (host numpy).

    Row X: the CDF of the direction density sin(th) * [f(x_th)/f(x90)]^2 *
    exp(x90^(1/3) - x_th^(1/3)) with x_th = x90/sin(th) (the exact
    jnu.ln_synch_ratio density), inverted at TH_U_NODES uniform quantiles
    over a 8192-point fine grid in |cos theta|.
    """
    lx = np.linspace(TH_LX_MIN, TH_LX_MAX, TH_X_NODES)
    x90 = 10.0**lx
    c = (np.arange(8192) + 0.5) / 8192.0  # |cos theta| midpoints
    s = np.sqrt(1.0 - c * c)

    def ln_f(x):
        xp6 = np.power(np.maximum(x, 1e-30), 1.0 / 6.0)
        xx = xp6**3 + consts.jnu.CST * xp6
        return 2.0 * np.log(xx)

    x_th = x90[:, None] / s[None, :]
    lnr = (np.log(s)[None, :] + ln_f(x_th) - ln_f(x90)[:, None]
           + np.cbrt(x90)[:, None] - np.cbrt(x_th))
    lnr = np.maximum(lnr - lnr.max(axis=1, keepdims=True), -745.0)
    rho = np.exp(lnr)
    cum = np.cumsum(rho, axis=1)
    cdf = cum / np.maximum(cum[:, -1:], 1e-300)
    u = np.linspace(0.0, 1.0, TH_U_NODES)
    q = np.empty((TH_X_NODES, TH_U_NODES))
    grid = np.concatenate([[0.0], c + 0.5 / 8192.0])
    for ix in range(TH_X_NODES):
        q[ix] = np.interp(u, np.concatenate([[0.0], cdf[ix]]), grid)
    return q.astype(np.float32)


def sample_nu_cdf(key, row, tabs: SamplerTables, weights, dtype):
    """(key, nu, lnw, alive): inverse-CDF frequency draw per lane."""
    alive = row >= 0
    r = jnp.maximum(row, 0)
    cdf_rows = tabs.cdf[r]  # (N, M)
    lnr_rows = tabs.lnrho[r]  # (N, M)
    key, ku = random.split(key)
    u = random.uniform(ku, row.shape, dtype)
    idx = jnp.clip(
        jnp.sum((cdf_rows < u[:, None]), axis=1) - 1, 0, NU_CDF_NODES - 2
    )
    take = lambda a, j: jnp.take_along_axis(a, j[:, None], axis=1)[:, 0]
    c0 = take(cdf_rows, idx).astype(dtype)
    c1 = take(cdf_rows, idx + 1).astype(dtype)
    v = jnp.clip((u - c0) / jnp.maximum(c1 - c0, 1e-12), 0.0, 1.0)
    r0 = take(lnr_rows, idx).astype(dtype)
    r1 = take(lnr_rows, idx + 1).astype(dtype)
    slope = jnp.clip(r1 - r0, -60.0, 60.0)
    t = jnp.where(
        jnp.abs(slope) > 1e-5,
        jnp.log1p(v * jnp.expm1(slope)) / slope,
        v,
    )
    dlnnu = consts.N_L_N / (NU_CDF_NODES - 1)
    lnnu = consts.L_NU_MIN + (idx.astype(dtype) + t) * dlnnu
    nu = jnp.exp(lnnu)
    lnw = _interp_weight_ln(nu, weights)
    return key, nu, jnp.where(alive, lnw, -jnp.inf), alive


def sample_costh_cdf(key, nu, theta_e, b, tabs: SamplerTables, dtype):
    """cos(theta) via the global (x90, u) quantile table, bilinear."""
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    nu_s90 = (2.0 / 9.0) * nu_c * theta_e * theta_e
    lx = jnp.log10(jnp.maximum(nu / (nu_s90 + consts.EPS), 1e-300))
    xg = jnp.clip(
        (lx - TH_LX_MIN) / (TH_LX_MAX - TH_LX_MIN) * (TH_X_NODES - 1),
        0.0, TH_X_NODES - 1.0001,
    )
    xi = jnp.floor(xg).astype(jnp.int32)
    xf = (xg - xi).astype(dtype)
    key, ku, ks = random.split(key, 3)
    u = random.uniform(ku, nu.shape, dtype)
    ug = u * (TH_U_NODES - 1)
    ui = jnp.clip(jnp.floor(ug).astype(jnp.int32), 0, TH_U_NODES - 2)
    uf = (ug - ui).astype(dtype)
    q = tabs.theta_q

    def at(i, j):
        return q[i, j].astype(dtype)

    q00 = at(xi, ui)
    q01 = at(xi, ui + 1)
    q10 = at(xi + 1, ui)
    q11 = at(xi + 1, ui + 1)
    cabs = ((1 - xf) * ((1 - uf) * q00 + uf * q01)
            + xf * ((1 - uf) * q10 + uf * q11))
    sign = jnp.where(random.uniform(ks, nu.shape, dtype) < 0.5, -1.0, 1.0)
    return key, jnp.clip(cabs, 0.0, 1.0) * sign


def weight_table(fluid_zone, g_det, mc, photon_n, f_table, k2_table):
    """ln(photon weight) vs frequency, (N_E_SAMP + 1,) (harm_model.cpp:268-306).

    Sums the per-zone emissivity proxy over all zones at each table frequency.
    ``fluid_zone``: FluidState of (n1, n2) arrays; ``g_det``: (n1, n2).
    """
    nu = jnp.exp(jnp.arange(consts.N_E_SAMP + 1) * consts.D_L_NU + consts.L_NU_MIN)

    s_fac = mc.dx[1] * mc.dx[2] * mc.dx[3]  # times l_unit^3 below
    l_unit3 = (mc_l_unit(mc)) ** 3

    k2 = jnu.k2_eval(fluid_zone.theta_e, k2_table)  # (n1, n2)
    live = (fluid_zone.n_e > 0.0) & (fluid_zone.theta_e >= consts.THETA_E_MIN) & (k2 > 0.0)
    fac = jnp.where(
        live,
        (consts.JCST * fluid_zone.n_e * fluid_zone.b * fluid_zone.theta_e**2 / (k2 + consts.EPS))
        * s_fac
        * l_unit3
        * g_det,
        0.0,
    )

    f = jnu.f_eval(
        fluid_zone.theta_e[..., None], fluid_zone.b[..., None], nu, f_table
    )  # (n1, n2, S+1)
    f = jnp.where(live[..., None], f, 0.0)
    sums = jnp.einsum("ij,ijk->k", fac, f, precision=lax.Precision.HIGHEST)
    return jnp.log(sums / (consts.HPL * photon_n) + 1e-300)


def mc_l_unit(mc):
    """l_unit recovered from d_tau_k (kept out of ModelConsts to avoid dupes)."""
    return mc.d_tau_k * (consts.ME * consts.CL * consts.CL / consts.HBAR) / (2.0 * PI)


def nint_table(weights, mc, f_table):
    """(ln nint, ln dndlnu_max) vs ln(B theta_e^2), each (NINT + 1,)
    (harm_model.cpp:308-338)."""
    b_mag = jnp.exp(jnp.arange(consts.NINT + 1) * consts.D_L_B + consts.L_B_MIN)
    nu = jnp.exp(jnp.arange(consts.N_E_SAMP) * consts.D_L_NU + consts.L_NU_MIN)

    dn = jnu.f_eval(1.0, b_mag[:, None], nu[None, :], f_table) / (
        jnp.exp(weights[: consts.N_E_SAMP])[None, :] + 1.0e-100
    )
    dndlnu_max = jnp.max(dn, axis=1)
    nint = jnp.sum(consts.D_L_NU * dn, axis=1)
    nint = nint * (
        mc.dx[1]
        * mc.dx[2]
        * mc.dx[3]
        * mc_l_unit(mc) ** 3
        * math.sqrt(2.0)
        * consts.EE**3
        / (27.0 * consts.ME * consts.CL * consts.CL)
        / consts.HPL
    )
    return jnp.log(nint + 1e-300), jnp.log(dndlnu_max + 1e-300)


def zone_budgets(fluid_zone, g_det, nint_tab, dndlnu_max_tab, k2_table, photon_n):
    """Expected photon count nz and rejection envelope dn_max for every zone
    (harm_model.cpp:1337-1389).  Returns (nz, dn_max), each (n1, n2)."""
    theta_e = fluid_zone.theta_e
    b = fluid_zone.b

    l_bth = jnp.log(jnp.maximum(b * theta_e * theta_e, 1e-300))
    d_l = (l_bth - consts.L_B_MIN) / consts.D_L_B
    # Truncation toward zero (C++ int cast): d_l in (-1, 0) lands in bin 0
    # with a negative fraction (mild extrapolation), as in the reference.
    l_idx = jnp.trunc(d_l).astype(jnp.int32)
    frac = d_l - l_idx
    # Deviation: the reference recomputes out-of-table zones with a direct
    # sweep (and its own index bug, harm_model.cpp:1358-1369); we clamp into
    # the 12-decade table instead (l >= NINT is unreachable for sane dumps).
    li = jnp.clip(l_idx, 0, consts.NINT - 1)
    ninterp = jnp.exp((1.0 - frac) * nint_tab[li] + frac * nint_tab[li + 1])
    dn_max = jnp.exp((1.0 - frac) * dndlnu_max_tab[li] + frac * dndlnu_max_tab[li + 1])

    k2 = jnu.k2_eval(theta_e, k2_table)
    nz = g_det * fluid_zone.n_e * b * theta_e * theta_e * ninterp / (k2 + consts.EPS)

    bad = (
        (fluid_zone.n_e <= 0.0)
        | (theta_e < consts.THETA_E_MIN)
        | (l_idx < 0)
        | (k2 <= 0.0)
        | (nz > photon_n * math.log(consts.NU_MAX / consts.NU_MIN))
    )
    return jnp.where(bad, 0.0, nz), jnp.where(bad, 0.0, dn_max)


def zone_counts(key, nz):
    """Stochastically round expected counts to integers (harm_model.cpp:693-697)."""
    u = random.uniform(key, nz.shape, nz.dtype)
    frac = nz - jnp.floor(nz)
    return (jnp.floor(nz) + (frac > u)).astype(jnp.int32)


class EmissionPlan(typing.NamedTuple):
    """Host-side plan: one entry per photon to create."""

    zone_i: np.ndarray  # (T,) int32
    zone_j: np.ndarray  # (T,) int32
    total: int


def plan_emission(counts: np.ndarray) -> EmissionPlan:
    """Expand per-zone counts into a flat photon -> zone map (host).

    Replaces the reference's zone sweep + producer queue: the 'queue' is just
    an index array.
    """
    counts = np.asarray(counts)
    flat = counts.reshape(-1)
    zone_ids = np.repeat(np.arange(flat.size, dtype=np.int64), flat)
    n2 = counts.shape[1]
    return EmissionPlan(
        zone_i=(zone_ids // n2).astype(np.int32),
        zone_j=(zone_ids % n2).astype(np.int32),
        total=int(flat.sum()),
    )


class InitPhotons(typing.NamedTuple):
    """SoA batch of freshly emitted photons (photon.hpp:41-52)."""

    x: jnp.ndarray  # (T, 4)
    k: jnp.ndarray  # (T, 4)
    w: jnp.ndarray
    e: jnp.ndarray
    l: jnp.ndarray
    n_e_0: jnp.ndarray
    theta_e_0: jnp.ndarray
    b_0: jnp.ndarray
    e_0: jnp.ndarray
    n_scatt: jnp.ndarray  # int32


def _interp_weight_ln(nu, weights):
    """ln(photon weight) at frequency nu from the log table
    (harm_model.cpp:784-792, kept in log space for float32 range safety)."""
    d_i = (jnp.log(nu) - consts.L_NU_MIN) / consts.D_L_NU
    i = jnp.clip(jnp.floor(d_i).astype(jnp.int32), 0, consts.N_E_SAMP - 1)
    frac = d_i - i
    return (1.0 - frac) * weights[i] + frac * weights[i + 1]


def _interp_weight(nu, weights):
    """Photon weight at frequency nu (harm_model.cpp:784-792)."""
    return jnp.exp(_interp_weight_ln(nu, weights))


def sample_photons(
    key,
    zone_i,
    zone_j,
    zone_x,
    fluid_zone,
    e_con_zone,
    e_cov_zone,
    ln_dn_max_zone,
    weights,
    f_table,
    dtype=jnp.float64,
    ln_w_offset=0.0,
    tabs: SamplerTables | None = None,
) -> InitPhotons:
    """Sample one photon per (zone_i, zone_j) entry (harm_model.cpp:706-782).

    Per-zone precomputes (fluid state, tetrads from the field direction,
    rejection envelope) are gathered through the zone index arrays; the two
    rejection loops (frequency against the weight envelope, direction against
    the pitch-angle emissivity) run masked over the whole batch.

    Both accept tests run in LOG space — the envelope quantities span
    ~1e-70..1e50, far outside the f32 exponent range of the float32 device
    sampler, so the sampler takes
    ``ln_dn_max_zone`` = ln(dn_max) and compares ln U against
    ln F - ln w - ln dn_max; the direction test uses the prefactor-free
    ln[j(th)/j(pi/2)] (jnu.ln_synch_ratio), which also removes the K2 table
    from the sampler entirely.  The produced photon weight is
    exp(ln w + ln_w_offset): the driver passes ln(weight_scale) here so the
    weight leaves the sampler already in the engine's representable range.
    """
    zi, zj = zone_i, zone_j
    theta_e = fluid_zone.theta_e[zi, zj].astype(dtype)
    n_e = fluid_zone.n_e[zi, zj].astype(dtype)
    b = fluid_zone.b[zi, zj].astype(dtype)
    ln_dn_max = ln_dn_max_zone[zi, zj].astype(dtype)
    e_con = e_con_zone[zi, zj].astype(dtype)
    e_cov = e_cov_zone[zi, zj].astype(dtype)
    x = zone_x[zi, zj].astype(dtype)

    shape = theta_e.shape
    # Lanes pointing at dead zones (padding, or zones with no emission
    # budget) can never accept a draw; start them accepted so they don't
    # drive the masked loops to the iteration cap.
    dead = jnp.isneginf(ln_dn_max) | (theta_e < consts.THETA_E_MIN)

    if tabs is not None:
        # Inverse-CDF sampling (see SamplerTables): same densities as the
        # rejection loops below, at ~1/70th the batch cost.
        row = jnp.where(dead, -1, tabs.zone_map[zi, zj])
        key, nu, lnw, _ = sample_nu_cdf(key, row, tabs, weights, dtype)
        w = jnp.exp(lnw + ln_w_offset)
        nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
        j90_zero = nu > 1.0e12 * (2.0 / 9.0) * nu_c * theta_e * theta_e
        key, cos_th = sample_costh_cdf(key, nu, theta_e, b, tabs, dtype)
        cos_th = jnp.where(dead | j90_zero, 0.0, cos_th)
        return _finish_photon(key, x, nu, w, cos_th, n_e, theta_e, b,
                              e_con, e_cov, shape, dtype)

    # --- frequency rejection against the weight envelope (:736-740) -------
    def nu_body(state):
        key, nu, lnw, accepted, it = state
        key, k1, k2_ = random.split(key, 3)
        nu_new = jnp.exp(random.uniform(k1, shape, dtype) * consts.N_L_N + consts.L_NU_MIN)
        lnw_new = _interp_weight_ln(nu_new, weights)
        ln_ratio = (jnu.ln_f_eval(theta_e, b, nu_new, f_table)
                    - lnw_new - ln_dn_max)
        ln_u = jnp.log(random.uniform(k2_, shape, dtype) + 1e-300)
        accept = ln_u <= ln_ratio
        take = accept & ~accepted
        nu = jnp.where(take, nu_new, nu)
        lnw = jnp.where(take, lnw_new, lnw)
        return key, nu, lnw, accepted | accept, it + 1

    def nu_cond(state):
        *_, accepted, it = state
        return (~jnp.all(accepted)) & (it < _MAX_REJECT_ITERS)

    key, nu, lnw, _, _ = lax.while_loop(
        nu_cond,
        nu_body,
        (key, jnp.full(shape, consts.NU_MIN, dtype),
         jnp.full(shape, -jnp.inf, dtype), dead, 0),
    )
    w = jnp.exp(lnw + ln_w_offset)

    # --- direction rejection against j(theta)/j(pi/2) (:743-751) ----------
    # j(pi/2) = 0 exactly when the nu > 1e12 nu_s cutoff trips at sin = 1.
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    j90_zero = nu > 1.0e12 * (2.0 / 9.0) * nu_c * theta_e * theta_e

    def th_body(state):
        key, cth, accepted, it = state
        key, k1, k2_ = random.split(key, 3)
        cth_new = 2.0 * random.uniform(k1, shape, dtype) - 1.0
        s_th = jnp.sqrt(jnp.maximum(1.0 - cth_new * cth_new, 1e-30))
        ln_ratio = jnu.ln_synch_ratio(nu, theta_e, b, s_th)
        ln_u = jnp.log(random.uniform(k2_, shape, dtype) + 1e-300)
        accept = ln_u <= ln_ratio
        cth = jnp.where(accept & ~accepted, cth_new, cth)
        return key, cth, accepted | accept, it + 1

    def th_cond(state):
        *_, accepted, it = state
        return (~jnp.all(accepted)) & (it < _MAX_REJECT_ITERS)

    key, cos_th, _, _ = lax.while_loop(
        th_cond, th_body, (key, jnp.zeros(shape, dtype), dead | j90_zero, 0)
    )

    return _finish_photon(key, x, nu, w, cos_th, n_e, theta_e, b,
                          e_con, e_cov, shape, dtype)


def _finish_photon(key, x, nu, w, cos_th, n_e, theta_e, b, e_con, e_cov,
                   shape, dtype):
    """Azimuth draw + tetrad->coordinate transform + conserved quantities
    (harm_model.cpp:753-781), shared by the rejection and CDF samplers."""
    sin_th = jnp.sqrt(1.0 - cos_th * cos_th)
    key, kp = random.split(key)
    phi = 2.0 * PI * random.uniform(kp, shape, dtype)

    e = nu * consts.HPL / (consts.ME * consts.CL * consts.CL)
    k_tetrad = jnp.stack(
        [e, e * cos_th, e * sin_th * jnp.cos(phi), e * sin_th * jnp.sin(phi)], axis=-1
    )
    k = tetrads.tetrad_to_coordinate(e_con, k_tetrad)

    k_tetrad = k_tetrad.at[..., 0].multiply(-1.0)
    tmp = tetrads.tetrad_to_coordinate(e_cov, k_tetrad)

    return InitPhotons(
        x=x,
        k=k,
        w=w,
        e=-tmp[..., 0],
        l=tmp[..., 3],
        n_e_0=n_e,
        theta_e_0=theta_e,
        b_0=b,
        e_0=-tmp[..., 0],
        n_scatt=jnp.zeros(shape, jnp.int32),
    )


def zone_tetrads(fluid_zone, g_cov, b_unit):
    """Per-zone emission tetrads from the field direction (harm_model.cpp:717-730).

    Trial vector: b_con * b_unit / b when magnetized, else the time axis
    (which make_tetrad's degeneracy fallback turns into the x1 axis).
    """
    b_code_mag = fluid_zone.b / b_unit
    b_hat = jnp.where(
        (fluid_zone.b > 0.0)[..., None],
        fluid_zone.b_con / jnp.maximum(b_code_mag, 1e-30)[..., None],
        jnp.zeros_like(fluid_zone.b_con).at[..., 0].set(1.0),
    )
    return tetrads.make_tetrad(fluid_zone.u_con, b_hat, g_cov)
