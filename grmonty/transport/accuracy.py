"""Engine-vs-oracle spectrum comparison: the statistics of the accuracy gate.

Runs the batched engine (on whatever device JAX uses by default) and the
native C++ scalar oracle (a transcription of the reference's recursive
tracker) on the SAME emission sample, then compares luminosity, recorded
fractions, a per-group chi^2 of the energy spectrum with exact MC variances,
and the origin-decomposed (primary/secondary) count channels.

Used by ``tools/validate_accuracy.py`` (CPU records, ``ACCURACY_*.json``) and
by ``chip_smoke.py`` (the same comparison with the engine compiled for the
GPU).
"""

import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from grmonty import consts
from grmonty.transport import cpu_reference, driver, engine, profiles

# Pool width of the gated engine: the shipped profile verbatim (float32,
# step growth, detached events, derived fluid, light refills, ...) at a
# width a 20,000-photon comparison keeps busy.
GATE_POOL = 1024


def gate_profile():
    """``(EngineConfig, Simulation kwargs)`` of the shipped profile at the
    gate's pool width, with the driver-level tail overrides it ships."""
    cfg = profiles.bench_config(pool=GATE_POOL, env={})
    cfg = cfg._replace(sec_cap=16384, max_outer=200000)
    bk = profiles.bench_sim_kwargs(GATE_POOL, env={})
    return cfg, dict(tail_grow_cap=bk["tail_grow_cap"],
                     tail_stall_steps=bk["tail_stall_steps"])


def compare_to_oracle(sim, photons, *, seed, engine_seed=None,
                      oracle="native", oracle_reps=1, freeze_bias=None,
                      group=10, oracle_npz=None):
    """Track the first ``photons`` of ``sim``'s emission plan with both the
    engine and the oracle; return ``(out, spec_engine, spec_oracle)``.

    ``out`` is the JSON-ready summary (ratios, chi^2 per dof, censuses);
    the spectra are the (6, 200, C) energy-by-angle accumulators.
    ``freeze_bias``: ``(max_tau, avg)`` pins BOTH trackers' scattering-bias
    normalization (the engine's must already be set in ``sim.cfg``);
    ``oracle_npz``: persist/reuse the oracle's spectra there.
    """
    # --- identical emission sample for BOTH sides -----------------------
    # (the zone sweep is ordered, so any "first K photons" prefix is a
    # zone-biased subsample — comparing it against a full-plan run mixes
    # populations and the ratios become meaningless; both trackers must
    # consume the same photons)
    plan = sim.plan()
    n_orc = min(photons, plan.total)
    batch = sim.emit(plan, 0, n_orc)  # engine-scaled weights

    # --- engine run on that sample --------------------------------------
    from jax import random as jrandom

    rows = engine.pack_rows(jax.device_get(batch), sim.cfg.dtype)
    rows_dev = jnp.asarray(rows)
    eng = sim.engine
    run = jax.jit(eng["run"])
    state = eng["fresh_state"](jrandom.PRNGKey(
        engine_seed if engine_seed is not None else seed + 2))
    t0 = time.time()

    # Drain to low occupancy at full width, then hand the straggler
    # orbiters (up to the 1e5-step cap each) to the driver's shrinking
    # tail cascade — a full-width pool paying 1e5 iterations for a few
    # lanes dominates the wall clock otherwise.
    def drive(state, n_valid, tail_exit):
        te = jnp.asarray(tail_exit, jnp.int32)
        nv = jnp.asarray(n_valid, jnp.int32)
        while True:
            state = run(state._replace(it=jnp.zeros((), jnp.int32)),
                        rows_dev, te, nv)
            if (int(state.backlog_pos) >= int(n_valid)
                    and int(state.sec.count) == 0
                    and int(jnp.sum(state.pool.occupied)) <= int(tail_exit)):
                break
        return state

    # Pilot warmup, exactly like driver.run(): the production driver warms
    # the bias-feedback counters with a SEQUENTIAL host-oracle pilot
    # (driver._host_warm_counters) whose per-photon feedback mirrors the
    # reference's own warmup dynamics.  The old batch-parallel pilot here
    # equilibrated at a different (higher-bias) operating point: in the
    # optically-thick regime (M=4e20) the engine recorded 2.2x the
    # oracle's photon count (ACCURACY_r2_thick.json rec_ratio 2.21) purely
    # from that warmup mismatch.  The warmup oracle runs at seed+7; the
    # comparison oracle below at seed+1 — independent streams.
    warm = min(512, n_orc)
    wbatch = jax.tree.map(lambda a: np.asarray(a)[:warm],
                          jax.device_get(batch))
    wbatch = wbatch._replace(
        w=np.asarray(wbatch.w, np.float64) / sim.cfg.weight_scale)
    warmed = sim._host_warm_counters(wbatch, state.counters)
    if warmed is not None:
        state = state._replace(counters=jax.device_put(warmed))
    else:  # no native oracle: fall back to the old batch pilot
        if warm < n_orc:
            state = drive(state, warm, max(1, sim.cfg.n_pool // 16))
    state = drive(state, rows.shape[0], min(256, sim.cfg.n_pool))
    state = sim._drain_tail(state)
    t_eng = time.time() - t0
    n_eng = n_orc
    # counters started at the warmup-oracle's totals; engine-only count:
    warm_rec = int(warmed.n_recorded) if warmed is not None else 0
    n_rec_e = int(state.counters.n_recorded) - warm_rec
    spec_e = driver.unscale_spectrum(
        np.asarray(jax.device_get(state.spec), np.float64),
        sim.cfg.weight_scale,
    )

    # --- oracle run on the same sample (persisted: ~hours) ---------------
    NB, NE = consts.N_TH_BINS, consts.N_E_BINS
    so_reps = None
    if oracle_npz and os.path.exists(oracle_npz):
        dat = np.load(oracle_npz)
        so, n_rec_o, t_orc = dat["spec"], int(dat["n_recorded"]), float(dat["seconds"])
        if int(dat["n_photons"]) != n_orc:
            raise ValueError(f"oracle cache {oracle_npz} holds "
                             f"{int(dat['n_photons'])} photons, not {n_orc}")
        max_tau_o = float(dat["max_tau_scatt"]) if "max_tau_scatt" in dat else None
        if "specs" in dat:
            so_reps = np.asarray(dat["specs"])
    else:
        backlog = jax.device_get(batch)
        # f64 BEFORE unscaling: raw grmonty weights (~1e50) overflow the
        # engine's f32 batch dtype once the 1e-25 scale is removed.
        backlog = backlog._replace(
            w=np.asarray(backlog.w, np.float64) / sim.cfg.weight_scale)
        bf = freeze_bias
        t0 = time.time()
        specs = []
        n_recs = []
        max_taus = []
        for r in range(max(1, oracle_reps)):
            if oracle == "native":
                from grmonty.transport.oracle_native import NativeTracker

                tr = NativeTracker(sim.mc, sim.tables, np.asarray(sim.prims),
                                   seed=seed + 1 + r, bias_fixed=bf)
            else:
                tr = cpu_reference.CPUTracker(sim.mc, sim.tables, sim.prims,
                                              seed=seed + 1 + r)
                tr.bias_fixed = bf
            tr.run(backlog, limit=n_orc)
            specs.append(np.asarray(tr.spec).copy())
            n_recs.append(int(tr.n_recorded))
            max_taus.append(float(tr.max_tau_scatt))
        t_orc = time.time() - t0
        so_reps = np.stack(specs)  # (R, NB, NE, C)
        so = so_reps.mean(0)
        n_rec_o = int(round(float(np.mean(n_recs))))
        max_tau_o = float(np.max(max_taus))
        if oracle_npz:
            np.savez(oracle_npz, spec=so, specs=so_reps,
                     n_recorded=n_rec_o,
                     seconds=t_orc, n_photons=n_orc, seed=seed,
                     max_tau_scatt=max_tau_o)

    # --- comparisons ----------------------------------------------------
    se = spec_e[: NB * NE].reshape(NB, NE, -1)
    so = so.reshape(NB, NE, -1)

    lum_e = se[:, :, 1].sum() / n_eng
    lum_o = so[:, :, 1].sum() / n_orc
    # Honest MC error bars on the luminosity ratio (spectrum channel 13 =
    # sum((w e)^2)): in the thick regime the luminosity is carried by few
    # heavy Compton photons and the per-run sigma reaches ~5-10% — a
    # lum_ratio quoted without it reads as bias when it is variance.
    lum_sig_e = float(np.sqrt(se[:, :, 13].sum()) / max(se[:, :, 1].sum(), 1e-300))
    lum_sig_o = float(np.sqrt(so[:, :, 13].sum()) / max(so[:, :, 1].sum(), 1e-300))
    rec_e = n_rec_e / n_eng
    rec_o = n_rec_o / n_orc

    # chi^2 over coarse groups of the theta-summed energy spectrum,
    # using per-group MC variance estimated from photon counts.
    g = group
    ne_g = NE // g
    e_e = se[:, :, 1].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1) / n_eng
    e_o = so[:, :, 1].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1) / n_orc
    n_e = se[:, :, 2].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1)
    n_o = so[:, :, 2].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1)
    use = (n_o >= 10) & (n_e >= 10)
    # Per-group MC variance from the sum((w*e)^2) accumulator (spectrum
    # channel 13): Var(sum w_i e_i) ~= sum (w_i e_i)^2 for a compound-
    # Poisson record stream.  The old e^2/n estimate assumed uniform
    # weights and UNDERestimated the variance by the weight-spread factor
    # (recorded weights span decades via the scattering bias), inflating
    # chi^2 by the same factor.
    v_e = se[:, :, 13].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1) / n_eng**2
    v_o = so[:, :, 13].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1) / n_orc**2
    var = v_e + v_o
    chi2 = float((((e_e - e_o) ** 2)[use] / var[use]).sum())
    dof = int(use.sum())

    # Recorded-count SHAPE channel: raw
    # per-group counts differ systematically by the bias-equilibrium
    # rec_ratio, so compare count FRACTIONS per group (engine vs oracle)
    # with Poisson variances — a pure Poisson statistic, independent of
    # the weighted channel's variance model.  A lum-flat but count-skewed
    # deviation (e.g. mis-binned secondaries) shows up here.
    f_e = n_e / max(n_e.sum(), 1)
    f_o = n_o / max(n_o.sum(), 1)
    var_f = n_e / max(n_e.sum(), 1) ** 2 + n_o / max(n_o.sum(), 1) ** 2
    chi2_counts = float((((f_e - f_o) ** 2)[use] / var_f[use]).sum())

    # Bias-feedback equilibria per side (the counters the scattering bias
    # is built from): a systematic rec_ratio offset usually traces here.
    avg_scatt_e = float(se[:, :, 3].sum() / max(n_rec_e, 1))
    avg_scatt_o = float(so[:, :, 3].sum() / max(n_rec_o, 1))
    # --- origin-decomposed count gate ------------------------------------
    # Spectrum channel 14 counts recorded SECONDARIES (photons born at a
    # scatter event).  Biased scattering never deflects the parent
    # (harm_model.cpp:1005-1051), so per-band PRIMARY counts are invariant
    # under any bias-equilibrium offset: engine-vs-oracle primaries must
    # agree within pure Poisson noise.  Secondary counts scale ~linearly
    # with the bias, so after fitting ONE global population factor
    # kappa = sum(S_e)/sum(S_o) their band SHAPE must also agree.  This
    # replaces the old loose "rec_ratio < 1.4" diagnostic with a
    # quantitative model of the documented equilibrium offset.
    decomp = None
    if se.shape[2] > 14 and so.shape[2] > 14:
        s_e = se[:, :, 14].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1)
        s_o = so[:, :, 14].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1)
        p_e, p_o = n_e - s_e, n_o - s_o
        use_p = (p_e + p_o) >= 10
        chi2_p = float((((p_e - p_o) ** 2)[use_p]
                        / np.maximum(p_e + p_o, 1)[use_p]).sum())
        dof_p = int(use_p.sum())
        kappa = float(s_e.sum() / max(s_o.sum(), 1))
        use_s = (s_e + s_o) >= 10
        var_s = np.maximum(s_e + kappa * kappa * s_o, 1.0)
        chi2_s = float((((s_e - kappa * s_o) ** 2)[use_s] / var_s[use_s]).sum())
        dof_s = max(int(use_s.sum()) - 1, 1)  # kappa fitted from the data
        # Bias-equilibrium prediction of the same factor: bias ~
        # 1/(max_tau_scatt * (avg_scatt + 2)) (harm_model.cpp:1391-1404).
        kappa_pred = None
        if max_tau_o is not None and max_tau_o > 0:
            kappa_pred = (max_tau_o * (avg_scatt_o + 2.0)) / (
                float(state.counters.max_tau_scatt) * (avg_scatt_e + 2.0))
        decomp = {
            "n_prim_engine": int(p_e.sum()), "n_prim_oracle": int(p_o.sum()),
            "n_sec_engine": int(s_e.sum()), "n_sec_oracle": int(s_o.sum()),
            "chi2_prim_per_dof": chi2_p / max(dof_p, 1), "dof_prim": dof_p,
            "kappa_fit": kappa, "kappa_pred_from_bias": kappa_pred,
            "chi2_sec_shape_per_dof": chi2_s / max(dof_s, 1),
            "dof_sec": dof_s,
        }
        # --- per-GENERATION kappa^g count model ----------------------------
        # Under a bias-equilibrium offset kappa, generation-g secondaries
        # scale as kappa^g (each cascade level multiplies by the bias),
        # so the single global kappa flattens only gbar=1 bands.  Channel
        # 15 sums the birth generation: gbar(band) = ch15/ch14, and the
        # model N_e(b) = N_o(b) * kappa^gbar_o(b) is fit by weighted LSQ
        # in log space; tools/validate_accuracy.py gates it at chi2/dof < 5.
        if se.shape[2] > 15 and so.shape[2] > 15:
            g_e = se[:, :, 15].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1)
            g_o = so[:, :, 15].sum(0)[: ne_g * g].reshape(ne_g, g).sum(1)
            gbar = g_o / np.maximum(s_o, 1.0)
            use_g = use_s & (s_e > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                log_r = np.log(np.maximum(s_e, 1e-300)
                               / np.maximum(s_o, 1e-300))
            w_b = 1.0 / (1.0 / np.maximum(s_e, 1.0)
                         + 1.0 / np.maximum(s_o, 1.0))
            # Robust replicate target (oracle_reps >= 3): per-band MEDIAN
            # and MAD-sigma across oracle replicates.  Secondary cascades
            # cluster, and at FROZEN bias the population is heavy-tailed
            # to the point of rare supercritical explosions (measured r5:
            # seeds {124..128} gave 100-117k secondaries except seed 127's
            # 564k — one hot chain branching above unity, unregulated
            # because the live feedback that normally damps it is pinned).
            # A mean target is dragged by such realizations; the median
            # with MAD-derived sigma (Poisson floor) is the honest
            # comparison.  Engine-side variance is taken equal to the
            # oracle's (same physics).
            s_o_t = s_o
            var_meas_note = "poisson"
            var_band = None
            if so_reps is not None and so_reps.shape[0] >= 3:
                R = so_reps.shape[0]
                sreps = so_reps[:, :, :, 14].sum(1)  # (R, NE)
                sb = sreps[:, : ne_g * g].reshape(R, ne_g, g).sum(2)
                s_o_t = np.median(sb, axis=0)
                mad = np.median(np.abs(sb - s_o_t), axis=0)
                var_band = np.square(1.4826 * mad)
                var_meas_note = f"replicate median/MAD (R={R})"
                greps = so_reps[:, :, :, 15].sum(1)
                gb_r = greps[:, : ne_g * g].reshape(R, ne_g, g).sum(2)
                with np.errstate(divide="ignore", invalid="ignore"):
                    gbar = np.median(gb_r / np.maximum(sb, 1.0), axis=0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    log_r = np.log(np.maximum(s_e, 1e-300)
                                   / np.maximum(s_o_t, 1e-300))
                w_b = 1.0 / (1.0 / np.maximum(s_e, 1.0)
                             + 1.0 / np.maximum(s_o_t, 1.0))
                use_g = use_s & (s_e > 0) & (s_o_t > 0)
            num = float((w_b * gbar * log_r)[use_g].sum())
            den = float((w_b * gbar * gbar)[use_g].sum())
            kappa_g = math.exp(num / max(den, 1e-300))
            pred = s_o_t * np.power(kappa_g, gbar)
            var_g = np.maximum(
                s_e + np.power(kappa_g, gbar) ** 2 * s_o_t, 1.0)
            if var_band is not None:
                var_g = np.maximum(
                    var_band * (1.0 + kappa_g**2 / so_reps.shape[0]), var_g)
            chi2_gen = float((((s_e - pred) ** 2)[use_g]
                              / var_g[use_g]).sum())
            dof_gen = max(int(use_g.sum()) - 1, 1)
            gbar_e = g_e / np.maximum(s_e, 1.0)
            decomp.update({
                "kappa_gen_fit": kappa_g,
                "gbar_oracle": [float(x) for x in gbar[use_g]],
                "gbar_engine": [float(x) for x in gbar_e[use_g]],
                "sec_counts_engine": [int(x) for x in s_e[use_g]],
                "sec_counts_oracle": [int(x) for x in s_o_t[use_g]],
                "chi2_sec_gen_per_dof": chi2_gen / dof_gen,
                "dof_sec_gen": dof_gen,
                "sec_gen_variance_model": var_meas_note,
            })

    groups = [
        {"g": int(i), "lum_ratio": float(e_e[i] / e_o[i]) if e_o[i] else None,
         "nph_engine": int(n_e[i]), "nph_oracle": int(n_o[i])}
        for i in range(ne_g) if (n_e[i] or n_o[i])
    ]

    out = {
        "n_engine": int(n_eng),
        "n_oracle": int(n_orc),
        "engine_s": t_eng,
        "oracle_s": t_orc,
        "lum_per_photon_engine": float(lum_e),
        "lum_per_photon_oracle": float(lum_o),
        "lum_ratio": float(lum_e / lum_o),
        "lum_ratio_rel_sigma": math.sqrt(lum_sig_e**2 + lum_sig_o**2),
        "recorded_frac_engine": float(rec_e),
        "recorded_frac_oracle": float(rec_o),
        "rec_ratio": float(rec_e / rec_o),
        "chi2": chi2,
        "dof": dof,
        "chi2_per_dof": chi2 / max(dof, 1),
        "chi2_counts_per_dof": chi2_counts / max(dof, 1),
        "avg_scatt_engine": avg_scatt_e,
        "avg_scatt_oracle": avg_scatt_o,
        "max_tau_scatt_engine": float(state.counters.max_tau_scatt),
        "max_tau_scatt_oracle": max_tau_o,
        "origin_decomp": decomp,
        # Step-cap truncation: photons the engine killed at
        # stall_steps and the weight they carried out, as a fraction of
        # recorded weight (both in scaled units).  Gate: << 1%.
        "n_stall_engine": int(state.counters.n_stall),
        "w_stall_frac_engine": float(state.counters.w_stall) / max(
            float(jax.device_get(state.spec)[:, 0].sum())
            + float(state.counters.w_stall), 1e-300),
        # Hotcross clamp census: interacting steps
        # whose sigma input left the table domain, where the device clamps
        # but the reference integrates numerically (hotcross.cpp:81-106).
        # Both callers gate it at 0: the clamp path must be unreachable.
        "n_hc_clamp_engine": int(state.counters.n_hc_clamp),
        # Anti-stall census: consumed events with halved-theta_e (soft) or
        # forced draws — should be ~0 with the shipped patient settings.
        "n_ev_soft_engine": int(state.counters.n_ev_soft),
        "n_ev_forced_engine": int(state.counters.n_ev_forced),
        "groups": groups,
    }
    return out, se, so
