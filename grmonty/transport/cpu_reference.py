"""Scalar reference tracker: the CPU backend / validation oracle.

Faithful re-implementation of the reference's single-threaded recursive CPU
transport path (``harm_model.cpp:362-404,894-1069``): one photon at a time,
Python-level recursion for secondaries and for adaptive step halving, a
sequential numpy RNG.  The per-step math is evaluated through jitted
single-photon versions of the same physics modules the batch engine uses,
but the control flow is an independent, direct transcription of the
reference semantics — which is exactly what makes it a useful oracle: the
batch engine's masked/deferred control flow is validated statistically
against this tracker on identical dumps.

This is a test/validation backend; it is orders of magnitude slower than
the batched engine (as the reference's CPU backend is vs its GPU backend).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from grmonty import consts
from grmonty.ops import fluid, geometry, radiation, tetrads
from grmonty.transport.engine import N_SPEC_CHAN, Tables

PI = math.pi


class CPUTracker:
    def __init__(self, mc: fluid.ModelConsts, tables: Tables, prims, seed=consts.RNG_SEED):
        self.mc = mc
        self.tables = tables
        # Device copy: the driver keeps its prims as HOST numpy
        # (driver.py `_build_device`), but `fluid_at` below is jitted and
        # indexes prims with tracers — a numpy closure raises
        # TracerArrayConversionError.
        prims = jnp.asarray(prims)
        self.prims = prims
        self.rng = np.random.default_rng(seed)
        self.spec = np.zeros((consts.N_TH_BINS, consts.N_E_BINS, N_SPEC_CHAN))
        self.n_recorded = 0
        self.n_scatt_rec = 0
        self.max_tau_scatt = mc.max_tau_scatt0

        a, hs, r0 = mc.a, mc.h_slope, mc.r_0

        @jax.jit
        def seg_step(x, k, dk, e0s, dl):
            """One implicit-midpoint trial segment (harm_model.cpp:1217-1277)."""
            dl_2 = 0.5 * dl
            dkh = dk * dl_2
            k_half = k + dkh
            k_pred = k_half + dkh
            x_new = x + k_half * dl

            conn = geometry.connection(x_new, a, hs)
            err = 0.0
            for _ in range(consts.MAX_ITER):
                dk_new = geometry.geodesic_rhs(conn, k_pred)
                k_next = k_half + dl_2 * dk_new
                err = jnp.sum(jnp.abs((k_pred - k_next) / (k_next + consts.EPS)))
                k_pred = k_next
            g00, g01, g03 = geometry.gcov_row0(x_new, a, hs, r0)
            e_1 = -(k_pred[0] * g00 + k_pred[1] * g01 + k_pred[3] * g03)
            err_e = jnp.abs((e_1 - e0s) / (e0s + consts.EPS))
            return x_new, k_pred, dk_new, e_1, err, err_e

        @jax.jit
        def fluid_at(x):
            g_cov = geometry.gcov(x, a, hs, r0)
            fs = fluid.get_fluid_params(x, g_cov, prims, mc)
            return g_cov, fs

        @jax.jit
        def alphas_at(k, fs):
            theta = radiation.bk_angle(k, fs.u_cov, fs.b_cov, fs.b, mc.b_unit)
            nu = radiation.fluid_nu(k, fs.u_cov)
            nu_s = jnp.abs(nu) + consts.EPS
            a_sc = radiation.alpha_inv_scatt(nu_s, fs.theta_e, fs.n_e, tables.hotcross)
            a_ab = radiation.alpha_inv_abs(
                nu_s, fs.theta_e, fs.n_e, fs.b, theta, tables.k2_table
            )
            return theta, nu, a_sc, a_ab

        @jax.jit
        def init_dkdlam(x, k):
            conn = geometry.connection(x, a, hs)
            return geometry.geodesic_rhs(conn, k)

        @jax.jit
        def make_tetrad_at(u_con, trial, g_cov):
            return tetrads.make_tetrad(u_con, trial, g_cov)

        self._seg = seg_step
        self._fluid = fluid_at
        self._alphas = alphas_at
        self._init_dk = init_dkdlam
        self._tetrad = make_tetrad_at

    # ------------------------------------------------------------------
    def bias(self, theta_e, w):
        cap = 0.5 * w / consts.WEIGHT_MIN
        if getattr(self, "bias_fixed", None):
            # frozen-bias comparison mode (see EngineConfig.bias_fixed_tau)
            denom = self.bias_fixed[0] * (self.bias_fixed[1] + 2.0)
        else:
            avg = self.n_scatt_rec / (self.n_recorded + 1.0)
            denom = self.max_tau_scatt * (avg + 2.0)
        b = 100.0 * theta_e**2 / (self.mc.bias_norm * denom)
        b = max(b, consts.TP_OVER_TE)
        b = min(b, cap)
        return b / consts.TP_OVER_TE

    def push(self, ph, dl, n=0):
        """Adaptive-halving geodesic push (harm_model.cpp:1217-1289)."""
        if ph["x"][1] < self.mc.x_start[1]:
            return
        saved = {f: np.array(ph[f]) for f in ("x", "k", "dkdlam")}
        e0s_saved = ph["e_0_s"]
        x, k, dk, e1, err, err_e = self._seg(
            jnp.asarray(ph["x"]), jnp.asarray(ph["k"]), jnp.asarray(ph["dkdlam"]),
            ph["e_0_s"], dl,
        )
        err, err_e = float(err), float(err_e)
        if n < consts.MAX_HALVING_DEPTH and (
            err_e > consts.E_DRIFT_TOL or err > consts.E_TOL
            or not np.isfinite(err)
        ):
            ph["x"], ph["k"], ph["dkdlam"] = saved["x"], saved["k"], saved["dkdlam"]
            ph["e_0_s"] = e0s_saved
            self.push(ph, 0.5 * dl, n + 1)
            self.push(ph, 0.5 * dl, n + 1)
        else:
            ph["x"], ph["k"], ph["dkdlam"] = np.array(x), np.array(k), np.array(dk)
            ph["e_0_s"] = float(e1)

    # -- scalar samplers (independent numpy transcription) --------------
    def _sample_y(self, theta_e):
        p3 = math.sqrt(PI) / 4.0
        p4 = math.sqrt(0.5 * theta_e) / 2.0
        p5 = 3.0 * math.sqrt(PI) * theta_e / 8.0
        p6 = theta_e * math.sqrt(0.5 * theta_e)
        s = p3 + p4 + p5 + p6
        while True:
            x1 = self.rng.uniform()
            if x1 < p3 / s:
                dof = 3
            elif x1 < (p3 + p4) / s:
                dof = 4
            elif x1 < (p3 + p4 + p5) / s:
                dof = 5
            else:
                dof = 6
            y = math.sqrt(self.rng.chisquare(dof) / 2.0)
            num = math.sqrt(1.0 + 0.5 * theta_e * y * y)
            den = 1.0 + y * math.sqrt(0.5 * theta_e)
            if self.rng.uniform() < num / den:
                return y

    def _sample_electron(self, k_tet, theta_e):
        cnt = 0
        while True:
            y = self._sample_y(theta_e)
            gamma_e = y * y * theta_e + 1.0
            beta_e = math.sqrt(1.0 - 1.0 / gamma_e**2)
            x1 = self.rng.uniform()
            det = 1.0 + 2.0 * beta_e + beta_e**2 - 4.0 * beta_e * x1
            mu = (1.0 - math.sqrt(det)) / (beta_e + 1e-300)
            mu = min(1.0, max(-1.0, mu))
            k_ = gamma_e * (1.0 - beta_e * mu) * k_tet[0]
            if k_ < 1e-3:
                sigma = 1.0 - 2.0 * k_
            else:
                sigma = (3.0 / (4.0 * k_ * k_)) * (
                    2.0
                    + k_**2 * (1.0 + k_) / (1.0 + 2.0 * k_) ** 2
                    + (k_**2 - 2.0 * k_ - 2.0) / (2.0 * k_) * math.log(1.0 + 2.0 * k_)
                )
            cnt += 1
            if self.rng.uniform() < sigma:
                break
            if cnt > 10_000_000:
                theta_e *= 0.5
                cnt = 0
        v0 = k_tet[1:4] / np.linalg.norm(k_tet[1:4])
        z = self.rng.uniform() * 2.0 - 1.0
        phi0 = self.rng.uniform() * 2 * PI
        n0 = np.array(
            [math.sqrt(1 - z * z) * math.cos(phi0), math.sqrt(1 - z * z) * math.sin(phi0), z]
        )
        v1 = n0 - np.dot(n0, v0) * v0
        v1 /= np.linalg.norm(v1)
        v2 = np.cross(v0, v1)
        phi = self.rng.uniform() * 2 * PI
        s_th = math.sqrt(1 - mu * mu)
        d = mu * v0 + s_th * (math.cos(phi) * v1 + math.sin(phi) * v2)
        return np.concatenate([[gamma_e], gamma_e * beta_e * d])

    @staticmethod
    def _boost(v, u):
        g = u[0]
        vel = math.sqrt(abs(1.0 - 1.0 / (g * g)))
        n = u[1:4] / (g * vel + consts.EPS)
        gm1 = g - 1.0
        vp = np.empty(4)
        vp[0] = u[0] * v[0] - np.dot(u[1:4], v[1:4])
        for i in range(3):
            vp[1 + i] = -u[1 + i] * v[0] + v[1 + i] + n[i] * gm1 * np.dot(n, v[1:4])
        return vp

    def _sample_scattered(self, k_tet, p):
        ke = self._boost(k_tet, p)
        if ke[0] > 1e-4:
            # KN rejection (proba.cpp:174-189)
            k0 = ke[0]
            k0pmin = k0 / (1.0 + 2.0 * k0)
            env = 2.0 * (1.0 + 2.0 * k0 + 2.0 * k0 * k0) / (k0 * k0 * (1.0 + 2.0 * k0))
            while True:
                tent = k0pmin + (k0 - k0pmin) * self.rng.uniform()
                ch = 1.0 + 1.0 / k0 - 1.0 / tent
                kn = (k0 / tent + tent / k0 - 1.0 + ch * ch) / (k0 * k0)
                if env * self.rng.uniform() < kn:
                    break
            k0p = tent
            c_th = 1.0 - 1.0 / k0p + 1.0 / k0
        else:
            k0p = ke[0]
            while True:
                x1 = 2.0 * self.rng.uniform() - 1.0
                if (3.0 / 4.0) * self.rng.uniform() < (3.0 / 8.0) * (1.0 + x1 * x1):
                    break
            c_th = x1
        s_th = math.sqrt(abs(1.0 - c_th * c_th))
        v0 = ke[1:4] / ke[0]
        z = self.rng.uniform() * 2.0 - 1.0
        phi0 = self.rng.uniform() * 2 * PI
        n0 = np.array(
            [math.sqrt(1 - z * z) * math.cos(phi0), math.sqrt(1 - z * z) * math.sin(phi0), z]
        )
        v1 = n0 - np.dot(n0, v0) * v0
        v1 /= np.linalg.norm(v1)
        v2 = np.cross(v0, v1)
        phi = 2 * PI * self.rng.uniform()
        d = c_th * v0 + s_th * (math.cos(phi) * v1 + math.sin(phi) * v2)
        kpe = np.concatenate([[k0p], k0p * d])
        p2 = np.array(p)
        p2[1:4] *= -1.0
        return self._boost(kpe, p2)

    def _scatter(self, ph, fs, g_cov):
        """scatter_super_photon (harm_model.cpp:1071-1145). Returns secondary or None."""
        k = ph["k"]
        if k[0] > 1e5 or k[0] < 0 or np.isnan(k[0]) or np.isnan(k[1]) or np.isnan(k[3]):
            ph["k"][0] = abs(k[0])
            ph["w"] = 0.0
            return None
        b_code = float(fs.b) / self.mc.b_unit
        if float(fs.b) > 0.0:
            trial = np.asarray(fs.b_con) / b_code
        else:
            trial = np.array([0.0, 1.0, 0.0, 0.0])
        e_con, e_cov = self._tetrad(
            jnp.asarray(fs.u_con), jnp.asarray(trial), g_cov
        )
        e_con, e_cov = np.asarray(e_con), np.asarray(e_cov)
        k_tet = e_cov @ k
        if k_tet[0] > 1e5 or k_tet[0] < 0 or np.isnan(k_tet[1]):
            return None
        p = self._sample_electron(k_tet, float(fs.theta_e))
        k_tet_p = self._sample_scattered(k_tet, p)
        k_sec = e_con.T @ k_tet_p
        sec = dict(ph)
        sec["k"] = k_sec
        if np.isnan(k_sec[1]):
            sec["w"] = 0.0
            return None
        k_tet_p2 = np.array(k_tet_p)
        k_tet_p2[0] *= -1.0
        tmp = e_con  # placeholder; real transform below
        tmp = e_cov.T @ k_tet_p2
        sec["x"] = np.array(ph["x"])
        sec["e"] = -tmp[0]
        sec["e_0_s"] = -tmp[0]
        sec["l"] = tmp[3]
        sec["tau_abs"] = 0.0
        sec["tau_scatt"] = 0.0
        sec["b_0"] = float(fs.b)
        sec["x1i"] = ph["x"][1]
        sec["x2i"] = ph["x"][2]
        sec["n_scatt"] = ph["n_scatt"] + 1
        sec["dkdlam"] = np.zeros(4)
        return sec

    # ------------------------------------------------------------------
    def stop(self, ph):
        if ph["x"][1] < self.mc.x1_min:
            return True
        if ph["x"][1] > consts.X1_MAX:
            if ph["w"] < consts.WEIGHT_MIN:
                if self.rng.uniform() <= 1.0 / consts.ROULETTE:
                    ph["w"] *= consts.ROULETTE
                else:
                    ph["w"] = 0.0
            return True
        if ph["w"] < consts.WEIGHT_MIN:
            if self.rng.uniform() <= 1.0 / consts.ROULETTE:
                ph["w"] *= consts.ROULETTE
            else:
                ph["w"] = 0.0
                return True
        return False

    def record(self, ph):
        """record_super_photon (harm_model.cpp:1291-1335)."""
        if np.isnan(ph["w"]) or np.isnan(ph["e"]):
            return
        if ph["tau_scatt"] > self.max_tau_scatt:
            self.max_tau_scatt = ph["tau_scatt"]
        mc = self.mc
        dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
        if ph["x"][2] < 0.5 * (mc.x_start[2] + mc.x_stop[2]):
            ix2 = int(ph["x"][2] / dx2)
        else:
            ix2 = int((mc.x_stop[2] - ph["x"][2]) / dx2)
        if not (0 <= ix2 < consts.N_TH_BINS):
            return
        l_e = math.log(max(ph["e"], 1e-300))
        i_e = int((l_e - consts.spectrum.L_E_0) / consts.spectrum.D_L_E + 2.5) - 2
        if not (0 <= i_e < consts.N_E_BINS):
            return
        self.n_recorded += 1
        self.n_scatt_rec += ph["n_scatt"]
        w = ph["w"]
        row = self.spec[ix2, i_e]
        row[0] += w
        row[1] += w * ph["e"]
        row[2] += 1.0
        row[3] += ph["n_scatt"]
        row[4] += w * ph["x1i"]
        row[5] += w * ph["x2i"] ** 2
        row[6] += w * ph["x"][3] ** 2
        row[7] += w * ph["tau_abs"]
        row[8] += w * ph["tau_scatt"]
        row[9] += w * ph["n_e_0"]
        row[10] += w * ph["theta_e_0"]
        row[11] += w * ph["b_0"]
        row[12] += w * ph["e_0"]
        row[13] += (w * ph["e"]) ** 2  # MC variance of the energy channel
        row[14] += 1.0 if ph.get("_sec") else 0.0  # secondary-origin count
        row[15] += ph.get("_nsc0", 0)  # summed birth generation (kappa^g)

    def track(self, ph, depth=0):
        """track_super_photon (harm_model.cpp:894-1069)."""
        if np.any(np.isnan(ph["x"])) or np.any(np.isnan(ph["k"])) or ph["w"] == 0.0:
            return
        ph["_sec"] = depth > 0  # origin tag for spectrum channel 14
        ph["_nsc0"] = ph["n_scatt"] if depth > 0 else 0  # birth generation
        mc = self.mc
        g_cov, fs = self._fluid(jnp.asarray(ph["x"]))
        theta, nu, a_sc, a_ab = self._alphas(jnp.asarray(ph["k"]), fs)
        alpha_scatti, alpha_absi = float(a_sc), float(a_ab)
        bi = self.bias(float(fs.theta_e), ph["w"])
        ph["dkdlam"] = np.asarray(self._init_dk(jnp.asarray(ph["x"]), jnp.asarray(ph["k"])))

        n_step = 0
        while not self.stop(ph):
            saved = {
                "x": np.array(ph["x"]), "k": np.array(ph["k"]),
                "dkdlam": np.array(ph["dkdlam"]), "e_0_s": ph["e_0_s"],
            }
            dl = float(
                geometry.step_size(jnp.asarray(ph["x"]), jnp.asarray(ph["k"]), mc.x_stop[2])
            )
            self.push(ph, dl)
            if self.stop(ph):
                break
            if alpha_absi > 0.0 or alpha_scatti > 0.0 or float(fs.n_e) > 0.0:
                g_cov, fs = self._fluid(jnp.asarray(ph["x"]))
                bound = float(fs.n_e) == 0.0
                if not bound:
                    theta, nu, a_scf, a_abf = self._alphas(jnp.asarray(ph["k"]), fs)
                    nu = float(nu)
                if bound or nu < 0.0:
                    d_tau_scatt = 0.5 * alpha_scatti * mc.d_tau_k * dl
                    d_tau_abs = 0.5 * alpha_absi * mc.d_tau_k * dl
                    alpha_scatti = alpha_absi = 0.0
                    bias_ = 0.0
                    bi = 0.0
                else:
                    d_tau_scatt = 0.5 * (alpha_scatti + float(a_scf)) * mc.d_tau_k * dl
                    alpha_scatti = float(a_scf)
                    d_tau_abs = 0.5 * (alpha_absi + float(a_abf)) * mc.d_tau_k * dl
                    alpha_absi = float(a_abf)
                    bf = self.bias(float(fs.theta_e), ph["w"])
                    bias_ = 0.5 * (bi + bf)
                    bi = bf
                x1r = -math.log(self.rng.uniform() + 1e-300)
                sec_w = ph["w"] / bias_ if bias_ > 0 else math.inf
                if bias_ * d_tau_scatt > x1r and sec_w > consts.WEIGHT_MIN:
                    frac = x1r / (bias_ * d_tau_scatt)
                    d_tau_abs *= frac
                    if d_tau_abs > 100:
                        return
                    d_tau_scatt *= frac
                    d_tau = d_tau_abs + d_tau_scatt
                    if d_tau_abs < 1e-3:
                        ph["w"] *= 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)))
                    else:
                        ph["w"] *= math.exp(-d_tau)
                    # interpolate to the scattering event
                    for f in ("x", "k", "dkdlam"):
                        ph[f] = saved[f]
                    ph["e_0_s"] = saved["e_0_s"]
                    self.push(ph, dl * frac)
                    g_cov, fs = self._fluid(jnp.asarray(ph["x"]))
                    if float(fs.n_e) > 0.0:
                        sec = dict(ph)
                        sec["w"] = sec_w
                        sec = self._scatter_parent(ph, sec, fs, g_cov)
                        if ph["w"] < 1e-100:
                            return
                        if sec is not None:
                            self.track(sec, depth + 1)
                    theta, nu, a_scf, a_abf = self._alphas(jnp.asarray(ph["k"]), fs)
                    if float(nu) < 0.0:
                        alpha_scatti = alpha_absi = 0.0
                    else:
                        alpha_scatti, alpha_absi = float(a_scf), float(a_abf)
                    bi = self.bias(float(fs.theta_e), ph["w"])
                else:
                    if d_tau_abs > 100:
                        return
                    d_tau = d_tau_abs + d_tau_scatt
                    if d_tau < 1e-3:
                        ph["w"] *= 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)))
                    else:
                        ph["w"] *= math.exp(-d_tau)
                ph["tau_abs"] += d_tau_abs
                ph["tau_scatt"] += d_tau_scatt
            n_step += 1
            if n_step > consts.MAX_N_STEP:
                break
        if ph["x"][1] > consts.X1_MAX and n_step <= consts.MAX_N_STEP:
            self.record(ph)

    def _scatter_parent(self, ph, sec, fs, g_cov):
        """Wrapper matching scatter_super_photon's parent/secondary contract."""
        w_sec = sec["w"]
        out = self._scatter(ph, fs, g_cov)
        if out is None:
            return None
        out["w"] = w_sec
        out["e_0"] = ph["e_0"]
        out["n_e_0"] = ph["n_e_0"]
        out["theta_e_0"] = ph["theta_e_0"]
        return out

    def run(self, init_photons, limit=None, progress_every=60.0):
        """Track a batch of InitPhotons (host numpy) sequentially.

        Logs photon-index progress at most every ``progress_every``
        seconds: oracle runs take hours (each photon is a recursive
        scalar walk of up to max_n_step steps) and are otherwise silent.
        """
        import logging
        import time

        log = logging.getLogger("grmonty")
        t0 = t_last = time.time()
        n = init_photons.w.shape[0] if limit is None else min(limit, init_photons.w.shape[0])
        for i in range(n):
            now = time.time()
            if progress_every and now - t_last >= progress_every:
                t_last = now
                log.info("oracle: photon %d/%d (%.0f s elapsed, "
                         "%d recorded)", i, n, now - t0, self.n_recorded)
            ph = {
                "x": np.asarray(init_photons.x[i], float).copy(),
                "k": np.asarray(init_photons.k[i], float).copy(),
                "dkdlam": np.zeros(4),
                "w": float(init_photons.w[i]),
                "e": float(init_photons.e[i]),
                "l": float(init_photons.l[i]),
                "x1i": float(init_photons.x[i, 1]),
                "x2i": float(init_photons.x[i, 2]),
                "tau_abs": 0.0,
                "tau_scatt": 0.0,
                "n_e_0": float(init_photons.n_e_0[i]),
                "theta_e_0": float(init_photons.theta_e_0[i]),
                "b_0": float(init_photons.b_0[i]),
                "e_0": float(init_photons.e_0[i]),
                "e_0_s": float(init_photons.e[i]),
                "n_scatt": int(init_photons.n_scatt[i]),
            }
            self.track(ph)
        return self.spec
