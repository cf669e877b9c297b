"""Host-side simulation driver: the orchestrator tying I/O, tables,
emission, and the transport engine together.

Equivalent of the reference's ``harm::HARMModel`` 5-phase pipeline
(``main.cpp:26-56``: construct -> read_file -> init -> run_simulation ->
report_spectrum) re-drawn for JAX: all init products are device arrays, the
emission producer/worker machinery is a vectorized sampler, and the
simulation loop is a sequence of jitted engine waves over photon backlogs.

The engine's spectrum accumulator is drained to a host float64 accumulator
every few dispatch slices.  An optional disk checkpoint after each wave
(``run(checkpoint_path=...)``, absent in the reference) lets a long run
resume; a device error is not caught here and ends the run.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random

from grmonty import consts
from grmonty.models import harm
from grmonty.ops import emission, fluid, spectrum as spectrum_ops
from grmonty.transport import engine as engine_mod
from grmonty.utils import cache

log = logging.getLogger("grmonty")

# Spectrum accumulator channels carrying photon weight (all but nph, nscatt).
_W_CHANNELS = [0, 1, 4, 5, 6, 7, 8, 9, 10, 11, 12]
_W2_CHANNELS = [13]  # sum((w*e)^2) — quadratic in the weight scale


class _ImmediateFuture:
    """Future-shaped wrapper that runs the call lazily at .result() time
    (the GRMONTY_EMIT_OVERLAP=0 serial-emission path)."""

    def __init__(self, fn, args):
        self._fn, self._args = fn, args

    def result(self):
        return self._fn(*self._args)


def unscale_spectrum(spec: np.ndarray, weight_scale: float) -> np.ndarray:
    """Undo the engine's weight scaling on the weighted accumulator channels."""
    if weight_scale == 1.0:
        return spec
    spec = spec.copy()
    spec[:, _W_CHANNELS] /= weight_scale
    spec[:, _W2_CHANNELS] /= weight_scale * weight_scale
    return spec


class Simulation:
    """One HARM snapshot + photon budget -> spectrum."""

    def __init__(
        self,
        dump_path: str,
        photon_n: int = 5_000_000,
        mass_unit: float = 4.0e19,
        seed: int = consts.RNG_SEED,
        config: engine_mod.EngineConfig | None = None,
        emit_chunk: int = 1 << 20,
        wave_tail_exit: int | None = None,
        slice_iters: int = 512,  # per-dispatch hot-iteration budget: the
        # host logs progress and drains the spectrum between slices
        warmup: int = 1024,
        tail_grow_cap: float | None = None,  # grow_cap override for the
        # tail-drain cascade engines only.  The drain is dominated by a
        # handful of step-cap-bound photon-sphere orbiters (~1e-5 of all
        # photons) whose per-iteration cost is dispatch-overhead-bound at
        # tiny pool widths; letting THEIR error-gated step grow harder
        # divides the drain wall time while the same two per-step error
        # tests bound the integration error.  None = inherit cfg.grow_cap
        # (no deviation).
        tail_stall_steps: int | None = None,  # stall_steps override for the
        # tail cascade; None = inherit.
        cdf_sampler: bool = False,  # emission: inverse-CDF sampling
        # (emission.SamplerTables) instead of the reference's rejection
        # loops — the batched rejection pays the batch-MAX draw count
        # (~73 full-width rounds per batch).  Distribution-equivalence
        # pinned by tests/test_emission_cdf.py; off = reference semantics.
        emit_stride: bool = False,  # emit photons in a strided permutation
        # of the zone sweep instead of zone order.  The reference's
        # row-major sweep (harm_model.cpp:673-704) front-loads the
        # Compton-heavy inner-torus zones into the first waves: they run
        # a scattering storm against the still-cold bias-feedback
        # counters whose magnitude varies ~2x run-to-run (measured
        # n_scatt_rec 8.6M vs 15.7M at identical physics), while the
        # late waves do no scattering at all.  A stride coprime to the
        # total makes every wave a representative zone mix: the bias
        # converges within the first wave and per-wave work is uniform.
        # Scheduling-only deviation (every photon is still emitted
        # exactly once; photon->zone assignment and sampling physics are
        # unchanged, only the ORDER and therefore the RNG stream/bias
        # trajectory differ); chi2-gated like every other knob.
    ):
        self.photon_n = photon_n
        self.emit_chunk = emit_chunk
        self.warmup = warmup
        self.tail_grow_cap = tail_grow_cap
        self.tail_stall_steps = tail_stall_steps
        self._cdf_sampler = cdf_sampler
        self._emit_stride = emit_stride
        self._stride = 0  # set by plan()
        self._total = 0
        self.cfg = config or engine_mod.EngineConfig()
        dt = self.cfg.dtype

        self.model = harm.read_dump(dump_path, mass_unit)
        self.mc = fluid.make_model_consts(self.model)

        log.info("Initializing tables")

        def _build_host():
            f_table, k2_table = cache.jnu_tables()
            hc = cache.hotcross_table()
            # All init-time table construction runs as ONE jitted function on
            # the host CPU backend (native f64; eager op-by-op dispatch of
            # the same math costs minutes on big grids), mirroring the
            # reference's host-side init; only the results ship to the
            # accelerator.
            cpu = jax.devices("cpu")[0]
            mc = self.mc

            def build(prims, f_t, k2_t):
                zone_x, g_cov_z, g_con_z, g_det_z = fluid.precompute_zone_geometry(mc)
                fluid_zone = fluid.get_fluid_zone(prims, g_cov_z, g_con_z, mc)
                weights = emission.weight_table(
                    fluid_zone, g_det_z, mc, photon_n, f_t, k2_t
                )
                nint_t, dndmax_t = emission.nint_table(weights, mc, f_t)
                nz, dn_max = emission.zone_budgets(
                    fluid_zone, g_det_z, nint_t, dndmax_t, k2_t, photon_n
                )
                e_con_z, e_cov_z = emission.zone_tetrads(
                    fluid_zone, g_cov_z, mc.b_unit
                )
                geom = fluid.make_geom_table(mc, fluid_zone)
                z = mc.n1 * mc.n2
                # [0]=n_e, [1]=theta_e*n_e: the hot loop recovers theta_e
                # as a RATIO of blends — bitwise-equivalent to the
                # reference's ratio of bilinearly-interpolated primitives
                # (uu/rho).  Blending theta_e directly overestimates the
                # temperature in low-density corners at the torus edge and,
                # through bias ~ theta_e^2, TRIPLED the scattering load
                # (measured: n_scatt_rec 21.3M vs 7.9M on the bench torus).
                derived11 = jnp.concatenate(
                    [fluid_zone.n_e.reshape(z, 1),
                     (fluid_zone.theta_e * fluid_zone.n_e).reshape(z, 1),
                     fluid_zone.b.reshape(z, 1),
                     fluid_zone.u_cov.reshape(z, 4),
                     fluid_zone.b_cov.reshape(z, 4)], axis=1)
                return {
                    "derived11": derived11,
                    "geom": geom.astype(jnp.float32),
                    "g_det_z": g_det_z,
                    "weights": weights,
                    "zone_x": zone_x,
                    "g_cov_z": g_cov_z,
                    "g_con_z": g_con_z,
                    "fz_ne": fluid_zone.n_e,
                    "fz_te": fluid_zone.theta_e,
                    "fz_b": fluid_zone.b,
                    "fz_ucon": fluid_zone.u_con,
                    "fz_ucov": fluid_zone.u_cov,
                    "fz_bcon": fluid_zone.b_con,
                    "fz_bcov": fluid_zone.b_cov,
                    "dn_max": dn_max,
                    "e_con_z": e_con_z,
                    "e_cov_z": e_cov_z,
                    "nz": nz,
                }

            prims = np.asarray(self.model.data.stacked())
            with jax.default_device(cpu):
                out = jax.jit(build)(
                    jax.device_put(prims, cpu),
                    jax.device_put(np.asarray(f_table), cpu),
                    jax.device_put(np.asarray(k2_table), cpu),
                )
            host = {k: np.asarray(v) for k, v in out.items()}
            host.update(prims=prims, f_t=np.asarray(f_table),
                        k2_t=np.asarray(k2_table), hc=np.asarray(hc))
            # Inverse-CDF emission tables (emission.SamplerTables): pure
            # numpy from the products above; cached with them.
            import types

            fzh = types.SimpleNamespace(theta_e=host["fz_te"],
                                        b=host["fz_b"])
            zm, lnr, cdfs = emission.build_nu_cdf(
                fzh, host["weights"], host["f_t"], host["nz"])
            host.update(nu_zone_map=zm, nu_lnrho=lnr, nu_cdf=cdfs)
            return host

        # The per-dump init products are pure functions of (dump, mass_unit,
        # photon_n, consts); disk-cache them so repeated runs skip the
        # host-side table construction.
        host = cache.dump_init(dump_path, mass_unit, photon_n, _build_host)
        self.nz = host.pop("nz")
        host["fluid_zone"] = fluid.FluidState(
            n_e=host.pop("fz_ne"), theta_e=host.pop("fz_te"), b=host.pop("fz_b"),
            u_con=host.pop("fz_ucon"), u_cov=host.pop("fz_ucov"),
            b_con=host.pop("fz_bcon"), b_cov=host.pop("fz_bcov"),
        )
        self._host = host

        self.seed = seed
        self.key = random.PRNGKey(seed)
        # Main engine exits each wave once the backlog is drained and only a
        # small tail of stragglers remains (they roll into the next wave);
        # a narrow tail engine finishes the final stragglers so a handful of
        # long-lived photons never hold the full-width pool hostage.
        if wave_tail_exit is None:
            wave_tail_exit = max(1, self.cfg.n_pool // 16)
        self._wave_tail_exit = wave_tail_exit
        # Each engine call runs at most slice_iters hot iterations so the
        # host can checkpoint the spectrum and log progress between slices.
        self._slice_iters = slice_iters
        # Straggler drain runs as a cascade of shrinking pools (see
        # _drain_tail); engines are built lazily and cached per pool size.
        self._tail_engines = {}
        self._drain_fns = {}
        # Host-side float64 spectrum accumulator, drained per slice.
        self.spec_acc = np.zeros((engine_mod.N_BINS + 1, engine_mod.N_SPEC_CHAN))
        # Device-window clock (seconds inside transport dispatches +
        # mandatory telemetry; see _run_wave): excludes host emission,
        # spectrum drains and checkpoint I/O.
        self.device_s = 0.0
        # Host-oracle pilot baseline (n_recorded, n_scatt_rec) injected into
        # the engine counters by _run_pilot; run() subtracts it so reported
        # stats count only this run's photons (the pilot's spectrum is
        # dropped, so counters and spectrum must be debited symmetrically —
        # the reference's counters reconcile, harm_model.cpp:409-413).
        self._warm_counts = None
        self._build_device()
        log.info("Initializing done")

    def _build_device(self):
        """Place arrays on devices and build the jitted engines."""
        h = self._host
        cpu = jax.devices("cpu")[0]
        self._cpu_dev = cpu
        put = jax.device_put
        # prims stay HOST numpy: every consumer (corner-table builds, the
        # native oracle, tests) reads them via np.asarray.
        self.prims = np.asarray(h["prims"])
        self.g_det_z = put(h["g_det_z"])
        if self.cfg.interp_geom:
            geom9 = fluid.pack_geom9(h["geom"], self.mc.n1, self.mc.n2)
            self.geom = put(np.asarray(geom9, np.dtype(self.cfg.dtype)))
        else:
            self.geom = None
        self.tables = engine_mod.Tables(
            f_table=put(h["f_t"]), k2_table=put(h["k2_t"]),
            hotcross=put(h["hc"]), weights=put(h["weights"]),
        )
        # Emission sampling inputs stay on the host CPU backend: the zone
        # sampler is init-adjacent host work in the reference too
        # (producer threads, harm_model.cpp:813-892), and the engine only
        # ever sees the finished InitPhotons batches.
        cput = lambda a: jax.device_put(np.asarray(a), cpu)
        self.zone_x = cput(h["zone_x"])
        self.g_cov_z = cput(h["g_cov_z"])
        self.g_con_z = cput(h["g_con_z"])
        self.fluid_zone = jax.tree.map(cput, h["fluid_zone"])
        self.dn_max = cput(h["dn_max"])
        self.e_con_z = cput(h["e_con_z"])
        self.e_cov_z = cput(h["e_cov_z"])
        self._weights_cpu = cput(h["weights"])
        self._f_cpu = cput(h["f_t"])
        self._k2_cpu = cput(h["k2_t"])

        # Derived-fluid corner rows: packed host-side from the CACHED
        # zone-state components (not rebuilt per make_engine — that would
        # repeat a host jit for every tail-cascade engine).
        self._derived_rows = (fluid.pack_corner_rows(h["derived11"], self.mc.n2)
                              if self.cfg.derived_fluid else None)
        wave_cfg = self.cfg._replace(
            tail_exit=self._wave_tail_exit,
            max_outer=min(self.cfg.max_outer, self._slice_iters),
        )
        # One set of device tables shared by the main + pilot + tail
        # engines (engine_mod.EngineTables).
        self._engine_tabs = engine_mod.build_engine_tables(
            self.mc, self.tables, self.prims, wave_cfg,
            derived_rows=self._derived_rows)
        self.engine = engine_mod.make_engine(self.mc, self.tables, self.prims,
                                             wave_cfg, geom_rows=self.geom,
                                             derived_rows=self._derived_rows,
                                             prebuilt=self._engine_tabs)
        # No buffer donation (whether to donate is not yet measured).
        self._run_jit = jax.jit(self.engine["run"])
        self._tail_engines = {}  # rebuilt lazily (per pool size)
        self._drain_fns = {}
        # Per-slice telemetry summary, jitted so the slice loop makes ONE
        # dispatch + ONE device_get.  The spectrum accumulator (~170 KB) is
        # fetched separately and only every few slices (_run_wave).  f32
        # on-device accumulation over a few-slice window is precision-safe
        # (~1e-5 relative; the f64 host accumulator takes over at drain).
        self._slice_stats = jax.jit(lambda s: (
            s.counters, s.pool.occupied.sum(),
            (s.pool.alive & ~s.pool.at_event).sum(),
            s.pool.record_pending.sum(), s.backlog_pos, s.sec.count))
        self._spec_get = jax.jit(lambda s: s.spec)
        self._spec_zero = None  # device-resident zero spectrum, made lazily
        # Sampler runs on CPU (f64) regardless of the engine dtype; inputs
        # are committed to the CPU device so jit compiles there.  The accept
        # tests run in log space (see emission.sample_photons), so the
        # envelope ships as ln(dn_max).
        self._ln_dn_cpu = jax.device_put(
            np.log(np.maximum(np.asarray(self.dn_max, np.float64), 1e-300))
            + np.where(np.asarray(self.dn_max) > 0.0, 0.0, -np.inf), cpu)
        # Host sampler: inverse-CDF tables when the profile ships them
        # (so CPU-backend runs exercise the same emission pipeline);
        # rejection otherwise (reference semantics).
        host_tabs = None
        if self._cdf_sampler:
            h2 = self._host
            cput2 = lambda a: jax.device_put(np.asarray(a), cpu)
            host_tabs = emission.SamplerTables(
                zone_map=cput2(h2["nu_zone_map"]),
                lnrho=cput2(h2["nu_lnrho"]),
                cdf=cput2(h2["nu_cdf"]),
                theta_q=cput2(cache.theta_quantiles()),
            )
        self._sample_jit = jax.jit(
            lambda key, zi, zj: emission.sample_photons(
                key, zi, zj, self.zone_x, self.fluid_zone, self.e_con_z,
                self.e_cov_z, self._ln_dn_cpu, self._weights_cpu,
                self._f_cpu, dtype=jnp.float64, tabs=host_tabs,
            )
        )
        # Accelerator-side emission (see run()): built lazily because it
        # device_puts ~100 MB of plan/zone tables.
        self._dev_sampler = None
        self._plan_dev = None

    # ------------------------------------------------------------------
    def plan(self) -> emission.EmissionPlan:
        """Per-zone photon counts -> flat photon->zone map (harm_model.cpp:673-704)."""
        self.key, k = random.split(self.key)
        with jax.default_device(jax.devices("cpu")[0]):
            counts = np.asarray(emission.zone_counts(k, jnp.asarray(self.nz)))
        plan = emission.plan_emission(counts)
        log.info("Emission plan: %d superphotons from %d zones",
                 plan.total, int((counts > 0).sum()))
        self._total = plan.total
        self._stride = self._pick_stride(plan.total) if self._emit_stride else 0
        if self._stride:
            log.info("Emission order: strided permutation (stride %d)",
                     self._stride)
        return plan

    @staticmethod
    def _pick_stride(total):
        """A stride coprime to ``total`` near the golden-ratio fraction
        (maximally uniform zone coverage within every window)."""
        import math

        s = max(1, int(total * 0.6180339887498949)) | 1
        while math.gcd(s, total) != 1:
            s += 2
        return s

    def _plan_index(self, start, count):
        """Global photon indices for a [start, start+count) wave window
        under the emission ordering (identity, or the strided permutation)."""
        t = np.arange(start, start + count, dtype=np.int64)
        if not self._stride:
            return t
        return (t * self._stride) % np.int64(self._total)

    def _sample(self, plan, start, count, limit=None):
        """Sample a [start, start+min(count, limit)) slice of the plan into an
        InitPhotons batch of shape ``count`` (padded with zero-weight photons
        that the engine drops on load; fixed shape = one engine compile).
        Returns host numpy arrays with weights pre-scaled by weight_scale."""
        stop = start + (count if limit is None else min(count, limit))
        # Clamp to the plan like the old [start:stop] slice did (the last
        # wave's window may overhang the total; overhang rows become
        # zero-weight padding below).
        n_real = max(0, min(stop, plan.total) - start)
        idx = self._plan_index(start, n_real)
        zi = plan.zone_i[idx]
        zj = plan.zone_j[idx]
        pad = count - zi.shape[0]
        if pad:
            zi = np.concatenate([zi, np.zeros(pad, np.int32)])
            zj = np.concatenate([zj, np.zeros(pad, np.int32)])
        self.key, k = random.split(self.key)
        batch = jax.device_get(self._sample_jit(
            jax.device_put(np.asarray(k), self._cpu_dev),
            jax.device_put(zi, self._cpu_dev),
            jax.device_put(zj, self._cpu_dev),
        ))
        w = np.asarray(batch.w) * self.cfg.weight_scale
        if pad:
            w[count - pad:] = 0.0
        return batch._replace(w=w)

    def emit(self, plan, start, count, limit=None):
        """InitPhotons batch on the accelerator (engine dtype) — test/oracle
        interface; the run loop ships packed rows via :meth:`emit_packed`."""
        batch = self._sample(plan, start, count, limit)
        dt = self.cfg.dtype
        cast = lambda a: jax.device_put(np.asarray(a, dtype=dt))
        return emission.InitPhotons(
            x=cast(batch.x), k=cast(batch.k), w=cast(batch.w),
            e=cast(batch.e), l=cast(batch.l), n_e_0=cast(batch.n_e_0),
            theta_e_0=cast(batch.theta_e_0), b_0=cast(batch.b_0),
            e_0=cast(batch.e_0),
            n_scatt=jax.device_put(np.asarray(batch.n_scatt, np.int32)),
        )

    def emit_packed_host(self, plan, start, count, limit=None):
        """Packed (count, 16) backlog rows as host numpy (thread-safe to
        prefetch: the sampler runs on the CPU backend and releases the GIL,
        overlapping with accelerator tracking — the reference's
        producer-thread design, harm_model.cpp:842-892)."""
        batch = self._sample(plan, start, count, limit)
        return engine_mod.pack_rows(batch, self.cfg.dtype)

    def emit_packed(self, plan, start, count, limit=None):
        """Packed (count, 16) backlog rows on the accelerator."""
        return jax.device_put(self.emit_packed_host(plan, start, count, limit))

    # ------------------------------------------------------------------
    # accelerator-side emission
    #
    # The host path above exists for the CPU backend and the oracle tests;
    # on an accelerator, host sampling would leave the device waiting for
    # emission.  The sampler is pure jitted JAX, so the device path runs
    # the same code on the accelerator (engine dtype, log-space accept
    # tests for f32 range safety) with the plan's zone-index arrays
    # resident on device, and packs rows there — no host<->device photon
    # traffic at all.
    # ------------------------------------------------------------------
    def _ensure_dev_sampler(self, plan):
        if self._plan_dev is None:
            # The flat photon->zone map is ~100 MB at bench scale.  Ship the
            # (Z+1,) cumulative per-zone counts instead (256 KB) and recover
            # each photon's zone on device with a binary search over its
            # global index.
            counts = np.zeros(self.mc.n1 * self.mc.n2, np.int64)
            zflat = plan.zone_i.astype(np.int64) * self.mc.n2 + plan.zone_j
            np.add.at(counts, zflat, 1)
            cum = np.zeros(counts.size + 1, np.int32)
            np.cumsum(counts, out=cum[1:])
            self._plan_dev = jax.device_put(cum)
        if self._dev_sampler is not None:
            return
        dt = self.cfg.dtype
        dput = lambda a: jax.device_put(np.asarray(a, np.float64).astype(dt))
        zone_x = dput(self.zone_x)
        flz = jax.tree.map(dput, self.fluid_zone)
        e_con = dput(self.e_con_z)
        e_cov = dput(self.e_cov_z)
        ln_dn = dput(jax.device_get(self._ln_dn_cpu))
        weights = dput(self._weights_cpu)
        f_t = dput(self._f_cpu)
        ln_w_off = float(np.log(self.cfg.weight_scale))
        chunk = self.emit_chunk
        tabs = None
        if self._cdf_sampler:
            h = self._host
            tabs = emission.SamplerTables(
                zone_map=jax.device_put(np.asarray(h["nu_zone_map"])),
                lnrho=jax.device_put(np.asarray(h["nu_lnrho"])),
                cdf=jax.device_put(np.asarray(h["nu_cdf"])),
                theta_q=jax.device_put(cache.theta_quantiles()),
            )

        n2 = self.mc.n2
        cum_dev = self._plan_dev
        stride = self._stride
        total = self._total

        def emit(key, start, limit):
            lane64 = jnp.arange(chunk, dtype=jnp.int64)
            if stride:
                # Strided emission order (Simulation.emit_stride): the
                # window's global indices are scattered over the whole
                # plan, so each lane recovers its zone with a vectorized
                # binary search over the cumulative zone counts.
                g = ((start.astype(jnp.int64) + lane64) * stride) % total
                zflat = jnp.clip(
                    jnp.searchsorted(cum_dev.astype(jnp.int64), g,
                                     side="right") - 1,
                    0, cum_dev.shape[0] - 2)
            else:
                # Zone-ordered plan: photon t's zone z satisfies
                # cum[z] <= t < cum[z+1] and the window's indices are
                # consecutive, so instead of a searchsorted per lane:
                # find the window's first zone with one scalar search,
                # scatter a mark at every zone boundary inside the
                # window, and cumsum the marks.
                z0 = jnp.searchsorted(cum_dev, start, side="right") - 1
                off = cum_dev - start  # boundary positions in the window
                in_win = (off > 0) & (off < chunk)
                marks = jnp.zeros((chunk,), jnp.int32).at[
                    jnp.where(in_win, off, chunk)].add(1, mode="drop")
                zflat = jnp.clip(z0 + jnp.cumsum(marks), 0,
                                 cum_dev.shape[0] - 2)
            zi = zflat // n2
            zj = zflat - zi * n2
            b = emission.sample_photons(
                key, zi, zj, zone_x, flz, e_con, e_cov, ln_dn, weights,
                f_t, dtype=dt, ln_w_offset=ln_w_off, tabs=tabs,
            )
            lane = jnp.arange(chunk)
            valid = lane < limit
            w = jnp.where(valid, b.w.astype(dt), 0.0)
            cols = ([b.x[:, i].astype(dt) for i in range(4)]
                    + [b.k[:, i].astype(dt) for i in range(4)]
                    + [w, b.e.astype(dt), b.l.astype(dt),
                       b.n_e_0.astype(dt), b.theta_e_0.astype(dt),
                       b.b_0.astype(dt), b.e_0.astype(dt),
                       b.n_scatt.astype(dt)])
            return jnp.stack(cols, axis=1)

        self._dev_sampler = jax.jit(emit)

    def emit_packed_dev(self, plan, start, limit):
        """Packed (emit_chunk, 16) backlog rows sampled ON the accelerator."""
        self._ensure_dev_sampler(plan)
        self.key, k = random.split(self.key)
        return self._dev_sampler(k, jnp.asarray(start, jnp.int32),
                                 jnp.asarray(limit, jnp.int32))

    # ------------------------------------------------------------------
    def _spec_zero_dev(self):
        """Cached device-resident zero spectrum (avoids one eager
        zeros-upload per slice)."""
        if self._spec_zero is None:
            self._spec_zero = jax.device_put(
                np.zeros((engine_mod.N_BINS + 1, engine_mod.N_SPEC_CHAN),
                         jnp.dtype(self.cfg.dtype)))
        return self._spec_zero

    def _drain_spec(self, state):
        """Move the device spectrum accumulator into the host f64 one."""
        self.spec_acc += np.asarray(jax.device_get(state.spec), np.float64)
        return state._replace(spec=self._spec_zero_dev())

    def save_checkpoint(self, path, waves_done, state, spec_acc=None,
                        key=None):
        """Write an atomic disk resume point after a completed wave.

        The reference has no checkpointing (its runs are minutes,
        ``SURVEY.md`` §5); a long run here can resume from the last
        completed wave: engine state pytree + host spectrum accumulator +
        the driver RNG key (already advanced past every consumed wave
        split, so resumed waves replay bit-identically).

        ``spec_acc``/``key`` are snapshots captured on the MAIN thread at
        submit time when this runs on the async checkpoint worker: the
        live ``self.spec_acc``/``self.key`` are mutated by the next
        wave's spectrum drain / key split, so reading them at
        thread-run time would mislabel wave c+1 state as waves_done=c.
        """
        state_h = jax.device_get(state)
        leaves = jax.tree_util.tree_leaves(state_h)
        payload = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
        payload["spec_acc"] = self.spec_acc if spec_acc is None else spec_acc
        payload["key"] = np.asarray(self.key if key is None else key)
        w_rec, w_scatt = self._warm_counts or (0, 0)
        payload["meta"] = np.asarray(
            [waves_done, len(leaves), self.photon_n, self.cfg.n_pool,
             self.emit_chunk,
             1 if os.environ.get("GRMONTY_RAMP", "1") == "1" else 0,
             w_rec, w_scatt],
            np.int64)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        log.info("checkpoint: %d wave(s) done -> %s", waves_done, path)

    def load_checkpoint(self, path, template_state):
        """Restore (waves_done, device state) written by save_checkpoint.

        ``template_state`` supplies the pytree structure (it depends on
        EngineConfig: fluid_cache / detached_events change the Pool
        fields); identity metadata guards against resuming a checkpoint
        from a different run setup.
        """
        dat = np.load(path, allow_pickle=False)
        meta = [int(x) for x in dat["meta"]]
        waves_done, n_leaves, photon_n, n_pool, emit_chunk = meta[:5]
        # Checkpoints predating the ramp metadata were written with the
        # NON-ramped wave schedule — default 0 so they only load when
        # GRMONTY_RAMP=0 reproduces the wave list they were written with.
        ramp = meta[5] if len(meta) > 5 else 0
        ramp_now = 1 if os.environ.get("GRMONTY_RAMP", "1") == "1" else 0
        if (photon_n, n_pool, emit_chunk, ramp) != (
                self.photon_n, self.cfg.n_pool, self.emit_chunk, ramp_now):
            raise ValueError(
                f"checkpoint {path} was written by a different run setup: "
                f"photon_n/n_pool/emit_chunk/ramp "
                f"{(photon_n, n_pool, emit_chunk, ramp)} != "
                f"{(self.photon_n, self.cfg.n_pool, self.emit_chunk, ramp_now)}")
        treedef = jax.tree_util.tree_structure(template_state)
        if treedef.num_leaves != n_leaves:
            raise ValueError(
                f"checkpoint {path} state structure mismatch "
                f"({n_leaves} leaves vs {treedef.num_leaves}) — "
                "EngineConfig differs from the run that wrote it")
        leaves = [dat[f"leaf_{i}"] for i in range(n_leaves)]
        state = jax.device_put(jax.tree_util.tree_unflatten(treedef, leaves))
        self.spec_acc = dat["spec_acc"].astype(np.float64)
        self.key = jnp.asarray(dat["key"])
        # Restore the host-oracle pilot baseline: a resume skips the pilot
        # but its records are baked into the checkpointed counters.
        self._warm_counts = ((meta[6], meta[7]) if len(meta) > 7
                             and (meta[6] or meta[7]) else None)
        return waves_done, state

    def _run_wave(self, state, backlog_np, t0, c, n_chunks, total, start=0,
                  tail_exit=None, n_valid=None):
        """Run one backlog wave in bounded slices with rate telemetry
        (the reference's 1 Hz photon-rate logging, harm_model.cpp:397-403)
        and spectrum draining.

        ``backlog_np`` may be host numpy or an already-device rows array.
        ``tail_exit`` overrides the wave's exit occupancy (traced engine
        arg — no recompile): n_pool = hand off with the pool still full."""
        if tail_exit is None:
            tail_exit = self._wave_tail_exit
        te = np.int32(tail_exit)
        backlog = jax.device_put(backlog_np)
        # Valid-row horizon: device backlogs are emit_chunk-padded (rows
        # past the wave limit carry w=0); stop the cursor there.
        if n_valid is None:
            n_valid = backlog.shape[0]
        nv = np.int32(min(n_valid, backlog.shape[0]))
        s = 0
        while True:
            # Device-window clock: dispatch + the one mandatory telemetry
            # fetch, summed into self.device_s (excludes spectrum drains,
            # checkpoint I/O and host emission stalls).
            t_sl = time.monotonic()
            state = self._run_jit(state, backlog, te, nv)
            # One jitted dispatch + one device_get for everything the
            # slice loop needs.
            counters, occupied, moving, rpend, pos, sec = (
                jax.device_get(self._slice_stats(state)))
            self.device_s += time.monotonic() - t_sl
            occupied, moving, rpend = int(occupied), int(moving), int(rpend)
            pos, sec = int(pos), int(sec)
            finished = (
                pos >= int(nv)
                and sec == 0
                and occupied <= tail_exit
            )
            # Spectrum drain every few slices / at wave end (see
            # _slice_stats note) — always BEFORE a wave handoff so
            # spec_acc + a zeroed device spec stay the one consistent
            # accounting.
            if finished or (s + 1) % 4 == 0:
                spec_h = jax.device_get(self._spec_get(state))
                self.spec_acc += np.asarray(spec_h, np.float64)
                state = state._replace(spec=self._spec_zero_dev())
            s += 1
            elapsed = time.time() - t0
            done = min(start + pos, total)
            log.info(
                "wave %d/%d: it=%d pos=%d occ=%d mov=%d rp=%d sec=%d "
                "rec=%d scatt=%d mt=%.2e avg=%.2f | %.0f ph/s",
                c + 1, n_chunks, int(state.it), done, occupied, moving,
                rpend, sec,
                int(counters.n_recorded), int(counters.n_scatt_rec),
                float(counters.max_tau_scatt), float(counters.avg_ema),
                done / max(elapsed, 1e-9),
            )
            if finished:
                break
            state = state._replace(it=jnp.zeros((), jnp.int32))
        return state

    def _pilot_pool(self):
        """Pilot-engine width.  The pilot's 8192 strided primaries amplify
        through the cold-start Compton storm into ~6x their count of
        tracked photons (50k recorded / 110k scatters measured on the
        bench torus), so a 1024-lane choice — sized for the primaries
        alone — serialized the storm cohort; 4096 lanes keeps the same
        narrow-engine economy at ~4x the storm throughput."""
        return min(int(os.environ.get("GRMONTY_PILOT_POOL", "4096")),
                   self.cfg.n_pool)

    def _pilot_engine(self):
        """The pilot's own engine (compiled in _warm_compile, outside the
        measured window).

        The tail-drain engines are the wrong shape for the pilot: their
        no-backlog cadence (m_period=64, refill_period=0) starves the pool
        during the pilot's Compton storm — thousands of lanes die within a
        few iterations of each far-apart maintenance phase and idle empty
        until the next one.  The pilot engine
        keeps the main engine's storm-capable cadence at the narrow width,
        and caps orbiters early (GRMONTY_PILOT_STALL): a pilot photon
        orbiting past ~20k steps either dies at the cap (unrecorded -> no
        counter effect) or contributes negligibly to the warmup
        statistics, while costing stall_steps iterations of drain time.
        """
        n_pilot = self._pilot_pool()
        key = ("pilot", n_pilot)
        if key not in self._tail_engines:
            cfg = self.cfg._replace(
                n_pool=n_pilot, tail_exit=256, m_period=8,
                refill_period=(4 if self.cfg.refill_period else 0),
                ev_k=min(n_pilot, self.cfg.ev_k or n_pilot),
                refill_k=min(n_pilot, self.cfg.refill_k or n_pilot),
                light_k=min(n_pilot, self.cfg.light_k or n_pilot),
                max_outer=min(self.cfg.max_outer, 64 * self._slice_iters),
                grow_cap=(self.tail_grow_cap if self.tail_grow_cap is not None
                          else self.cfg.grow_cap),
                stall_steps=int(os.environ.get("GRMONTY_PILOT_STALL",
                                               "20000")),
            )
            eng = engine_mod.make_engine(self.mc, self.tables, self.prims,
                                         cfg, geom_rows=self.geom,
                                         derived_rows=self._derived_rows,
                                         prebuilt=self._engine_tabs)
            self._tail_engines[key] = (eng, jax.jit(eng["run"]))
        return self._tail_engines[key]

    def _tail_sizes(self):
        """Tail-cascade pool-size ladder.

        A straggler cohort's wall time is (iterations the longest straggler
        still needs) x (per-iteration cost at the stage width), so the
        cascade must shrink FAST: before the port the per-iteration cost
        was roughly linear in width down to ~1k lanes and flat below
        (fusion launch overhead).  A 4096-wide stage carrying ~300 near-photon-orbit
        stragglers for 50k iterations costs ~10x what a 512-wide stage
        would.  Ladder: full width (drains the bulk at best efficiency),
        then 4096 / 512, each exiting at the next stage's size.

        Two mid stages, not three: each extra stage is a whole extra
        engine compile plus a gather/merge/census jit triple; 512 sat in
        the flat-cost region before the port, so one stage there covered
        the old 1024+256 pair at the same per-iteration price.  The ladder
        is not yet measured on the H100.
        """
        ladder = [self.cfg.n_pool, 4096, 512]
        return sorted({s for s in ladder if s <= self.cfg.n_pool},
                      reverse=True)

    def _tail_engine(self, n_pool, exit_occ):
        key = (n_pool, exit_occ)
        if key not in self._tail_engines:
            cfg = self.cfg._replace(
                n_pool=n_pool, tail_exit=exit_occ, m_period=64,
                max_outer=min(self.cfg.max_outer, 64 * self._slice_iters),
                # No backlog to load in the drain: light refill phases are
                # pure overhead there.  The every-64-iteration full phase
                # still consumes secondaries and frees retired lanes.
                refill_period=0,
                grow_cap=(self.tail_grow_cap if self.tail_grow_cap is not None
                          else self.cfg.grow_cap),
                stall_steps=(self.tail_stall_steps
                             if self.tail_stall_steps is not None
                             else self.cfg.stall_steps),
            )
            eng = engine_mod.make_engine(self.mc, self.tables, self.prims, cfg,
                                         geom_rows=self.geom,
                                         derived_rows=self._derived_rows,
                                         prebuilt=self._engine_tabs)
            self._tail_engines[key] = (eng, jax.jit(eng["run"]))
        return self._tail_engines[key]

    def _drain_jits(self, n_t):
        """Jitted (gather, merge, census) for one tail-cascade stage size.

        One jitted dispatch each way instead of eager per-leaf ops over
        the ~45-leaf pool pytree.
        """
        if n_t in self._drain_fns:
            return self._drain_fns[n_t]
        n_pool = self.cfg.n_pool
        detached = self.cfg.detached_events

        def gather(pool):
            """First-n_t occupied lanes -> (small pool, emptied wide pool)."""
            occ = pool.occupied
            rank = jnp.cumsum(occ.astype(jnp.int32)) - 1
            take = occ & (rank < n_t)
            slot = jnp.where(take, rank, n_t)
            lane = jax.lax.broadcasted_iota(jnp.int32, (n_pool,), 0)
            idx = jnp.full((n_t,), n_pool, jnp.int32).at[slot].set(
                lane, mode="drop")
            valid = idx < n_pool
            gi = jnp.minimum(idx, n_pool - 1)
            small = jax.tree.map(
                lambda a: a if a.shape[-1] == 0 else a[..., gi], pool)
            small = small._replace(
                occupied=small.occupied & valid,
                alive=small.alive & valid,
                pend_push=small.pend_push & valid,
                at_event=small.at_event & valid,
                record_pending=small.record_pending & valid,
            )
            if detached:
                # padding lanes are copies of a real lane — mask their
                # pending-event flag or its event would duplicate
                small = small._replace(ev_pending=small.ev_pending & valid)
            wide = pool._replace(occupied=occ & ~take, alive=pool.alive & ~take)
            return small, wide

        def merge(wide, small):
            """Scatter leftover small-pool lanes into free wide slots."""
            free = ~wide.occupied
            frank = jnp.cumsum(free.astype(jnp.int32)) - 1
            lane = jax.lax.broadcasted_iota(jnp.int32, (n_pool,), 0)
            slot = jnp.where(free & (frank < n_t), frank, n_t)
            free_idx = jnp.full((n_t,), n_pool, jnp.int32).at[slot].set(
                lane, mode="drop")
            lrank = jnp.cumsum(small.occupied.astype(jnp.int32)) - 1
            dest = jnp.where(
                small.occupied,
                free_idx[jnp.minimum(jnp.where(small.occupied, lrank, 0),
                                     n_t - 1)],
                n_pool,
            )

            def put(aw, al):
                if aw.shape[-1] == 0:
                    return aw
                return aw.at[..., dest].set(al, mode="drop")

            return jax.tree.map(put, wide, small)

        fns = (jax.jit(gather), jax.jit(merge),
               jax.jit(lambda p, sec: (p.occupied.sum(), sec.count)))
        self._drain_fns[n_t] = fns
        return fns

    def _drain_tail(self, state):
        """Finish leftover stragglers in a cascade of shrinking pools.

        A wave leaves unfinished lanes — up to the full pool when
        wave_tail_exit >= n_pool (the pool-full handoff mode, where waves
        end at backlog exhaustion without draining occupancy).  Most need
        only a few thousand more steps, but a handful sit on near-photon-
        orbit trajectories and run to the per-photon step cap (~1e5-1e6
        steps; the reference pays the same per photon, consts.hpp:55).
        Draining everyone in one tiny pool serializes those orbiters cohort
        by cohort, so the cascade shrinks: a full-width stage drains the
        bulk at full occupancy down to n_pool/16, a n_pool/16 pool takes
        that down to 256, and a 256 pool finishes the orbiters where each
        iteration is ~250x cheaper than a full-width one.
        """
        sizes = self._tail_sizes()
        zero_backlog = jnp.zeros((1, engine_mod.ROW_WIDTH), self.cfg.dtype)
        for si, n_t in enumerate(sizes):
            exit_occ = sizes[si + 1] if si + 1 < len(sizes) else 0
            _, run = self._tail_engine(n_t, exit_occ)
            gather_fn, merge_fn, census = self._drain_jits(n_t)
            while True:
                occ_n, sec_n = (int(x) for x in jax.device_get(
                    census(state.pool, state.sec)))
                if occ_n <= exit_occ and sec_n == 0:
                    break
                small, wide = gather_fn(state.pool)
                tstate = engine_mod.State(
                    pool=small, spec=state.spec, counters=state.counters,
                    sec=state.sec, backlog_pos=jnp.zeros((), jnp.int32),
                    key=state.key, it=jnp.zeros((), jnp.int32),
                )
                log.info("tail drain [pool %d]: %d stragglers (+%d queued secondaries)",
                         n_t, occ_n, sec_n)
                t_sl = time.monotonic()
                tstate = run(tstate, zero_backlog)
                while True:
                    t_occ, t_sec = (int(x) for x in jax.device_get(
                        census(tstate.pool, tstate.sec)))
                    self.device_s += time.monotonic() - t_sl
                    if t_occ <= exit_occ and t_sec == 0:
                        break
                    log.info("tail drain: slice continues (occ=%d)", t_occ)
                    t_sl = time.monotonic()
                    tstate = run(
                        tstate._replace(it=jnp.zeros((), jnp.int32)), zero_backlog
                    )
                state = state._replace(
                    pool=merge_fn(wide, tstate.pool), spec=tstate.spec,
                    counters=tstate.counters, sec=tstate.sec, key=tstate.key,
                )
        return state

    def _host_warm_counters(self, batch, counters_dev):
        """Sequential host-oracle warmup: track a pilot InitPhotons batch
        with the native C++ tracker and return the engine Counters with
        the converged bias-feedback state injected (None on failure — the
        caller falls back to the device pilot).  Shared by the single-chip
        and the sharded drivers."""
        try:
            from grmonty.transport.oracle_native import NativeTracker

            t_p = time.time()
            tracker = NativeTracker(self.mc, self.tables,
                                    np.asarray(self.prims),
                                    seed=self.seed + 7)
            oracle_batch = batch._replace(w=np.asarray(batch.w, np.float64))
            tracker.run(oracle_batch, progress_every=0)
            c = jax.device_get(counters_dev)
            dt_c = np.asarray(c.max_tau_scatt).dtype
            avg = tracker.n_scatt_rec / max(tracker.n_recorded, 1)
            c = c._replace(
                n_recorded=np.int64(tracker.n_recorded),
                n_scatt_rec=np.int64(tracker.n_scatt_rec),
                max_tau_scatt=np.asarray(tracker.max_tau_scatt, dt_c),
                avg_ema=np.asarray(avg, dt_c),
                ema_scatt_mark=np.int64(tracker.n_scatt_rec),
                ema_rec_mark=np.int64(tracker.n_recorded),
            )
            log.info(
                "pilot done (host oracle, %.1f s): rec=%d scatt=%d "
                "max_tau=%.3g", time.time() - t_p, tracker.n_recorded,
                tracker.n_scatt_rec, tracker.max_tau_scatt)
            return c
        except Exception as err:  # noqa: BLE001 - fall back to device
            log.warning("host-oracle pilot unavailable (%s); "
                        "falling back to device pilot", err)
            return None

    def _pilot_batch(self, plan, warm):
        """Strided pilot sample (host numpy InitPhotons, raw weights).

        (A deep-zone booster — 1/8 of the pilot drawn from the densest 1%
        of zones to pre-warm the max_tau ratchet — was tried and did NOT
        move it: deep-born photons die absorbed instead of
        recording deep taus; the bulk ratchet is driven by rare
        scattering-cascade realizations no pilot-sized sample reaches.)
        """
        idx = np.asarray(np.linspace(0, plan.total - 1, warm), np.int64)
        zi = plan.zone_i[idx]
        zj = plan.zone_j[idx]
        self.key, k = random.split(self.key)
        return jax.device_get(self._sample_jit(
            jax.device_put(np.asarray(k), self._cpu_dev),
            jax.device_put(zi, self._cpu_dev),
            jax.device_put(zj, self._cpu_dev)))

    def _run_pilot(self, state, plan, warm, t0):
        """Bias-feedback warmup: track a STRIDED sample of the emission
        plan until the pool drains, so the scattering-bias counters
        (max_tau_scatt, avg n_scatt via n_recorded) equilibrate on
        actually-RECORDED photons before the bulk waves launch.

        Why strided + drained: a contiguous
        [0, warm) pilot holds only innermost-zone photons, which die
        absorbed long before reaching the recording radius (~100+ steps
        away), and the old pilot exited after one 16-iteration superstep
        with n_recorded == 0 — so the bulk waves launched with the bias at
        its huge cold value and ran a Compton storm (3.6M surplus
        scatters, 7x the straggler count).
        The stride makes the pilot a representative zone mix whose
        escapers record within a few hundred iterations.

        The strided photons are re-emitted by their bulk waves later
        (the reference's sequential warmup has no such overlap): a
        warm/total ~ 1e-4 weight double-count, far below MC noise.
        """
        batch = self._pilot_batch(plan, warm)
        w = np.asarray(batch.w) * self.cfg.weight_scale
        rows = engine_mod.pack_rows(batch._replace(w=w), self.cfg.dtype)
        log.info("pilot wave: %d strided photons (bias warmup)", warm)
        # Host-sequential warmup (default): track the pilot sample with the
        # native C++ oracle, whose per-photon counter feedback makes the
        # cold-start storm SELF-LIMITING exactly like the reference's
        # sequential warmup (harm_model.cpp:1391-1404 reads the counters
        # per photon) — a batched engine launches every pilot photon at the
        # ~6x-inflated cold bias instead and multiplies the population 16x
        # before any feedback arrives; the oracle does the same
        # statistical job on the host with no device time at all.
        # Counters are plain numbers, so they
        # transfer into the engine state directly; the pilot spectrum is
        # dropped (its photons are re-emitted by the bulk waves anyway, so
        # this REMOVES the old double-count).  GRMONTY_PILOT=device
        # restores the staged on-device pilot (also the fallback when the
        # native oracle is unavailable).
        if os.environ.get("GRMONTY_PILOT", "host") == "host":
            warmed = self._host_warm_counters(batch, state.counters)
            if warmed is not None:
                # Remember the injected baseline so run() can subtract it
                # from the final counters: the pilot's spectrum is dropped,
                # so leaving its records in n_recorded would break the
                # counters==spectrum invariant.
                self._warm_counts = (int(warmed.n_recorded),
                                     int(warmed.n_scatt_rec))
                return state._replace(counters=jax.device_put(warmed))
        # The pilot runs in a NARROW engine (the 1024-wide tail-cascade
        # size): its only product is warmed counters, and full-width
        # iterations for <= warm photons would pay for a whole pool of
        # mostly empty lanes.  Counters are
        # pool-shape-independent, so they transfer into the main state
        # directly; pilot stragglers past the exit occupancy are simply
        # abandoned (the strided photons are re-emitted by their bulk
        # waves anyway — abandoning reduces the warm/total double-count).
        if self.cfg.n_pool > 2048:
            eng, run = self._pilot_engine()
            self.key, kp = random.split(self.key)
            pstate = eng["fresh_state"](kp)
            pstate = pstate._replace(counters=state.counters)
            # Two-stage warmup.  Launching all `warm` photons at once runs
            # the ENTIRE batch at the ~6x-inflated cold-start bias
            # (max_tau_scatt0 is 3.8x below its converged value and
            # avg_n_scatt starts at 0): every pilot photon scattered ~36
            # times (296k scatters / 16x population multiplication for
            # 8192 primaries).  The reference
            # never pays this: its SEQUENTIAL warmup converges the
            # counters within the first ~100 recorded photons
            # (harm_model.cpp:1391-1404 reads them per photon).  Stage 1
            # reproduces that: a tiny strided batch storms cheaply and
            # converges the counters; stage 2 then runs the remaining
            # pilot photons at the warmed bias for statistical power.
            stage1 = min(256, rows.shape[0])
            rows_dev = jnp.asarray(rows)
            # Stage 1 runs in the NARROWEST drain-cascade engine (already
            # compiled): its cold-start storm holds only a few hundred
            # live lanes, and a 4096-wide engine pays full-width
            # maintenance-phase gathers for them.  Stage 2 (warm bias, ~5x the
            # population) runs in the 4096-wide pilot engine.
            sizes = self._tail_sizes()
            eng1, run1 = self._tail_engine(sizes[-1], 0)
            stages = [(eng1, run1, 0, stage1, np.int32(32))]
            if rows.shape[0] > stage1:
                stages.append((eng, run, stage1, rows.shape[0],
                               np.int32(max(16, warm // 64))))
            counters = pstate.counters
            spec_carry = None
            for s_i, (s_eng, s_run, lo, hi, te) in enumerate(stages):
                self.key, ks = random.split(self.key)
                pstate = s_eng["fresh_state"](ks)._replace(
                    counters=counters,
                    backlog_pos=jnp.asarray(lo, jnp.int32))
                if spec_carry is not None:
                    pstate = pstate._replace(spec=pstate.spec + spec_carry)
                nv = np.int32(hi)
                it = 0
                while True:
                    pstate = s_run(
                        pstate._replace(it=jnp.zeros((), jnp.int32)),
                        rows_dev, te, nv)
                    occ, pos, sec = (int(x) for x in jax.device_get(
                        (pstate.pool.occupied.sum(), pstate.backlog_pos,
                         pstate.sec.count)))
                    it += 1
                    log.info("pilot stage %d slice %d: occ=%d pos=%d sec=%d",
                             s_i + 1, it, occ, pos, sec)
                    if (pos >= int(nv) and sec == 0 and occ <= int(te)) \
                            or it > 64:
                        break
                counters = pstate.counters
                spec_carry = pstate.spec
            self.spec_acc += np.asarray(
                jax.device_get(pstate.spec), np.float64)
            counters = jax.device_get(pstate.counters)
            log.info("pilot done: rec=%d scatt=%d",
                     int(counters.n_recorded), int(counters.n_scatt_rec))
            return state._replace(counters=jax.device_put(counters))
        # Small pools: run the pilot in the main engine (pad the backlog
        # to the bulk shape so no extra compile is paid).
        if rows.shape[0] < self.emit_chunk:
            rows = np.concatenate(
                [rows, np.zeros((self.emit_chunk - rows.shape[0],
                                 engine_mod.ROW_WIDTH), rows.dtype)])
        state = state._replace(backlog_pos=jnp.zeros((), jnp.int32))
        return self._run_wave(state, rows, t0, -1, 0, warm,
                              tail_exit=max(16, warm // 64), n_valid=warm)

    def _warm_compile(self, plan):
        """Execute every jitted program the run will need, once, on dummy
        state — so compiles (disk-cached across runs) land before the
        transport clock starts.
        The reference's analogue is nvcc: its kernels are compiled at build
        time and its photon rate never pays compilation."""
        t_w = time.time()
        stage = lambda name: (log.info("warmup: %s done (+%.1f s)", name,
                                       time.time() - t_w), time.time())[1]
        k0 = random.PRNGKey(0)
        zero_backlog = jnp.zeros((self.emit_chunk, engine_mod.ROW_WIDTH),
                                 self.cfg.dtype)
        # Warm CONCURRENTLY where possible: XLA compiles release the GIL,
        # so the sampler's and the tail engines' compiles overlap the main
        # engine's (the dispatches themselves still serialize on the one
        # device).
        warm_pool = ThreadPoolExecutor(max_workers=4)
        fut_sampler = None
        if (jax.default_backend() != "cpu"
                and os.environ.get("GRMONTY_EMIT_DEVICE", "1") == "1"):
            self._ensure_dev_sampler(plan)
            fut_sampler = warm_pool.submit(
                lambda: jax.block_until_ready(self._dev_sampler(
                    k0, jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))))
        state = self.engine["fresh_state"](k0)
        jax.block_until_ready(
            self._run_jit(state, zero_backlog, np.int32(0), np.int32(0)))
        t_w = stage("main engine")
        if fut_sampler is not None:
            fut_sampler.result()
            t_w = stage("device sampler")
        # The tail-drain cascade engines (driver._drain_tail stage sizes)
        # AND their gather/merge/census jits: the three per-stage drain
        # programs gather/scatter ~45 pool leaves each, and their cold
        # compiles would otherwise land INSIDE the measured window.
        one_row = jnp.zeros((1, engine_mod.ROW_WIDTH), self.cfg.dtype)
        sizes = self._tail_sizes()
        # The FULL-WIDTH drain stage only engages when _drain_tail enters
        # with occupancy above the next stage's size (or queued
        # secondaries) — but the last wave's exit condition already drains
        # the MAIN engine to min(n_pool/16, wave_tail_exit) with sec == 0
        # (run()/wave_te), so when that bound is <= sizes[1] the stage is
        # structurally unreachable: don't pay its warm compile (a whole
        # full-width engine).  It stays lazily built (_tail_engine cache)
        # for non-default drain entries.
        last_te = min(max(1, self.cfg.n_pool // 16), self._wave_tail_exit)
        skip_full = (len(sizes) > 1 and sizes[0] == self.cfg.n_pool
                     and last_te <= sizes[1])
        tail_futs = []
        for si, n_t in enumerate(sizes):
            if si == 0 and skip_full:
                log.info("warmup: tail engine %d skipped (unreachable: "
                         "last wave drains to %d <= %d)",
                         n_t, last_te, sizes[1])
                continue
            exit_occ = sizes[si + 1] if si + 1 < len(sizes) else 0
            # build serially (mutates the engine caches); warm in threads
            eng, run = self._tail_engine(n_t, exit_occ)
            gather_fn, merge_fn, census = self._drain_jits(n_t)

            def _warm(run=run, eng=eng, g=gather_fn, m=merge_fn, c=census):
                jax.block_until_ready(run(eng["fresh_state"](k0), one_row))
                small, wide = g(state.pool)
                jax.block_until_ready(m(wide, small))
                jax.block_until_ready(c(state.pool, state.sec))

            tail_futs.append((n_t, warm_pool.submit(_warm)))
        for n_t, f in tail_futs:
            f.result()
            t_w = stage(f"tail engine {n_t}")
        # The host emission sampler at the pilot's (warm,) shape: its CPU
        # jit compile otherwise lands between the transport clock start
        # and the pilot.
        warm = min(self.warmup, plan.total)
        if warm > 0:
            z0 = jax.device_put(np.zeros(warm, np.int32), self._cpu_dev)
            jax.block_until_ready(self._sample_jit(
                jax.device_put(np.asarray(random.PRNGKey(0)), self._cpu_dev),
                z0, z0))
            t_w = stage("host sampler")
        # The device-pilot engine at its (warm, 16) backlog shape — only
        # when the device pilot is selected: the default host-oracle
        # warmup (see _run_pilot) needs no engine at all, and this compile
        # is a whole extra engine.
        if (self.cfg.n_pool > 2048 and warm > 0
                and os.environ.get("GRMONTY_PILOT", "host") != "host"):
            eng, run = self._pilot_engine()
            jax.block_until_ready(run(
                eng["fresh_state"](k0),
                jnp.zeros((warm, engine_mod.ROW_WIDTH), self.cfg.dtype)))
        warm_pool.shutdown(wait=True)

    def run_native_cpu(self, progress_every=5000):
        """Emit + track everything on the native C++ CPU backend.

        The structural counterpart of the reference's CPU build
        (``harm_model.cpp:362-404``): the vectorized sampler emits on the
        JAX CPU device, the scalar C++ tracker (native/oracle.cpp —
        parity-tested against the Python transcription) tracks
        sequentially with bias-feedback state carried across chunks.
        Returns (spec, stats) shaped like :meth:`run`.
        """
        from grmonty.transport.oracle_native import NativeTracker

        t0 = time.time()
        plan = self.plan()
        tracker = NativeTracker(self.mc, self.tables, np.asarray(self.prims),
                                seed=self.seed + 1)
        done = 0
        while done < plan.total:
            n = int(min(self.emit_chunk, plan.total - done))
            batch = jax.device_get(self.emit(plan, done, n))
            batch = batch._replace(
                w=np.asarray(batch.w, np.float64) / self.cfg.weight_scale)
            tracker.run(batch, progress_every=progress_every)
            done += n
            log.info("cpu backend: %d/%d emitted, %d recorded | %.0f ph/s",
                     done, plan.total, tracker.n_recorded,
                     done / max(time.time() - t0, 1e-9))
        elapsed = time.time() - t0
        stats = {
            "n_created": int(plan.total),
            "n_recorded": int(tracker.n_recorded),
            "n_scatt_recorded": int(tracker.n_scatt_rec),
            "max_tau_scatt": float(tracker.max_tau_scatt),
            "elapsed_s": elapsed,
            "compile_s": 0.0,
            "photon_rate": plan.total / max(elapsed, 1e-9),
        }
        log.info("Final rate %.2f ph/s", stats["photon_rate"])
        log.info("Super photons: created %d, recorded %d",
                 stats["n_created"], stats["n_recorded"])
        self.spec = tracker.spec
        return tracker.spec, stats

    def run(self, checkpoint_path=None, checkpoint_every=1):
        """Emit + track everything; returns (spectrum_rows, stats).

        With ``checkpoint_path``, a resume point is written to disk every
        ``checkpoint_every`` completed waves (and deleted on success); if
        the file already exists, the run resumes from it — completed
        waves are skipped and the remainder replays bit-identically.
        """
        t_init = time.time()
        plan = self.plan()
        self.key, k_eng = random.split(self.key)
        state = self.engine["fresh_state"](k_eng)
        self._warm_compile(plan)
        self._warm_counts = None  # set by the host-oracle pilot or resume
        self.device_s = 0.0
        resume_waves = 0
        resumed = False
        if checkpoint_path and os.path.exists(checkpoint_path):
            resume_waves, state = self.load_checkpoint(checkpoint_path, state)
            resumed = True
            log.info("Resuming from %s: %d wave(s) already done",
                     checkpoint_path, resume_waves)
        t0 = time.time()
        compile_s = t0 - t_init

        chunk = self.emit_chunk
        # Warmup: a strided pilot wave equilibrates the bias-feedback
        # counters (max_tau_scatt, avg_num_scatt) before the bulk waves
        # (see _run_pilot).  The sequential reference gets this for free
        # (its counters warm within the first few hundred recursively-
        # tracked photons); launching the full batch cold runs the
        # scattering bias at its huge initial value and explodes the
        # secondary population.
        warm = min(self.warmup, plan.total)
        # First-wave ramp: the bias-feedback counters (max_tau_scatt
        # ratchet, avg-scatters EMA) converge DURING the first bulk wave —
        # the pilot's 8192 strided photons cannot sample the max_tau tail
        # of a 16M-superphoton run, so every wave-1 photon launches at an
        # inflated bias and the cohort runs a Compton storm (wave 1 once
        # carried 7.4M of a run's 9.9M scatters).  The reference never
        # pays this: its
        # SEQUENTIAL tracker exposes one photon at a time to the
        # still-converging counters (harm_model.cpp:1391-1404).  Ramping
        # the first emit_chunk in sub-waves (1/8, 1/8, 1/4, rest) bounds
        # the population exposed to the cold counters the same way;
        # per-wave boundaries cost one sampler call each (pool-full
        # handoff).  GRMONTY_RAMP=0 disables.
        waves = []
        if (os.environ.get("GRMONTY_RAMP", "1") == "1"
                and plan.total > chunk >= 8):
            cs = 0
            for part in (chunk // 8, chunk // 8, chunk // 4):
                waves.append((cs, part))
                cs += part
            waves.append((cs, chunk - cs))
            cs = chunk
        else:
            cs = 0
        waves += [(c0, min(chunk, plan.total - c0))
                  for c0 in range(cs, plan.total, chunk)]
        # Emission placement: on an accelerator backend the sampler runs ON
        # the device (see emit_packed_dev), so the device never waits for
        # host sampling.
        # The host path remains for the CPU backend (and GRMONTY_EMIT_DEVICE=0
        # A/B runs), where emission overlaps tracking via a prefetch thread
        # (GRMONTY_EMIT_OVERLAP=0 serializes it).
        emit_dev = (jax.default_backend() != "cpu"
                    and os.environ.get("GRMONTY_EMIT_DEVICE", "1") == "1")
        # Per-wave exit occupancy: the final wave (at full width, where
        # iterations are cheapest per lane) drains so the tail cascade
        # starts small; interior waves use wave_tail_exit (n_pool = hand
        # off with the pool full, so interior boundaries never track at
        # sinking occupancy).
        drain_occ = max(1, self.cfg.n_pool // 16)

        def wave_te(c):
            if c + 1 == len(waves):
                return min(drain_occ, self._wave_tail_exit)
            return self._wave_tail_exit

        if resume_waves > len(waves):
            raise ValueError(
                f"checkpoint claims {resume_waves} waves done but this run "
                f"has {len(waves)} — emit_chunk/photon_n mismatch")

        # Async checkpointing: save_checkpoint device_gets ~20 MB of engine
        # state and writes it to disk, inside the measured window.
        # The engine never donates buffers, so the state pytree passed
        # here is immutable once the next wave's dispatch produced its new
        # state: a worker thread can fetch+write it while tracking
        # continues.  One in-flight save at a time (joined before the next
        # submit and at run end); the atomic tmp+rename in save_checkpoint
        # keeps a crash mid-write harmless.
        ck_pool = ThreadPoolExecutor(max_workers=1)
        ck_fut = [None]

        def _ck_reap():
            if ck_fut[0] is not None:
                try:
                    ck_fut[0].result()
                except OSError as err:  # checkpoint I/O is best-effort;
                    # a device error raises here and ends the run
                    log.warning("async checkpoint failed: %s", err)
                ck_fut[0] = None

        def ck_submit(waves_done, state):
            # Snapshot the host-mutable pieces (spectrum accumulator, RNG
            # key) NOW: the next wave mutates self.spec_acc in place and
            # splits self.key before the worker runs.
            # The device state pytree is immutable once dispatched, so its
            # device_get can stay on the worker thread.
            _ck_reap()
            ck_fut[0] = ck_pool.submit(
                self.save_checkpoint, checkpoint_path, waves_done, state,
                self.spec_acc.copy(), np.asarray(self.key))

        def maybe_checkpoint(c, state):
            if checkpoint_path and (c + 1) % checkpoint_every == 0:
                ck_submit(c + 1, state)

        def ck_join():
            _ck_reap()
            ck_pool.shutdown(wait=True)

        if not resumed and warm > 0:
            state = self._run_pilot(state, plan, warm, t0)
            # Checkpoint the warmed counters: a crash in wave 1 must
            # resume AFTER the pilot (resuming with waves_done=0 skips it
            # — the saved key is already advanced past the pilot split,
            # so re-running it would break bit-identical replay).
            if checkpoint_path:
                ck_submit(0, state)

        if emit_dev:
            for c, (start, limit) in enumerate(waves):
                if c < resume_waves:
                    continue  # key was saved already advanced past these
                backlog = self.emit_packed_dev(plan, start, limit)
                state = state._replace(backlog_pos=jnp.zeros((), jnp.int32))
                state = self._run_wave(state, backlog, t0, c, len(waves),
                                       plan.total, start=start,
                                       tail_exit=wave_te(c), n_valid=limit)
                maybe_checkpoint(c, state)
        else:
            # Overlapped prefetch consumes the NEXT wave's key split before
            # the current wave's checkpoint is written, so a resume would
            # re-split it — serialize emission when checkpointing to keep
            # the resume bit-identical (the device-emission path splits
            # per-wave serially and needs no such carve-out).
            overlap = (os.environ.get("GRMONTY_EMIT_OVERLAP", "1") == "1"
                       and not checkpoint_path)
            pool = ThreadPoolExecutor(max_workers=1)
            submit = pool.submit if overlap else (
                lambda f, *a: _ImmediateFuture(f, a))
            try:
                w0 = min(resume_waves, len(waves) - 1)
                fut = submit(self.emit_packed_host, plan, waves[w0][0], chunk,
                             waves[w0][1])
                for c, (start, limit) in enumerate(waves):
                    if c < resume_waves:
                        continue
                    backlog_np = fut.result()
                    if c + 1 < len(waves):
                        fut = submit(self.emit_packed_host, plan,
                                     waves[c + 1][0], chunk, waves[c + 1][1])
                    state = state._replace(backlog_pos=jnp.zeros((), jnp.int32))
                    state = self._run_wave(state, backlog_np, t0, c, len(waves),
                                           plan.total, start=start,
                                           tail_exit=wave_te(c),
                                           n_valid=limit)
                    maybe_checkpoint(c, state)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        ck_join()  # last async checkpoint lands before the file is deleted
        # Snapshot the census before the tail cascade so utilization can be
        # reported per stage (pilot+waves vs whole run incl. tail drain).
        c_waves = jax.device_get(state.counters)
        state = self._drain_tail(state)
        if checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # run completed; resume point stale
        state = self._drain_spec(state)
        elapsed = time.time() - t0
        counters = jax.device_get(state.counters)
        # Debit the host-oracle pilot baseline (its spectrum was dropped;
        # the sharded driver does the same subtraction — sharding.py run()).
        w_rec, w_scatt = self._warm_counts or (0, 0)
        stats = {
            "n_created": plan.total,
            "n_recorded": max(0, int(counters.n_recorded) - w_rec),
            "n_scatt_recorded": max(0, int(counters.n_scatt_rec) - w_scatt),
            "max_tau_scatt": float(counters.max_tau_scatt),
            "n_secondary_dropped": int(counters.n_sec_drop),
            "elapsed_s": elapsed,
            "compile_s": compile_s,
            "photon_rate": plan.total / max(elapsed, 1e-9),
            # Device-window rate: photons over the summed transport
            # dispatch windows (see device_s in __init__).
            "device_s": self.device_s,
            "photon_rate_device": plan.total / max(self.device_s, 1e-9),
            "steps_per_photon": float(counters.n_steps_retired)
            / max(float(counters.n_retired), 1.0),
        }
        # Step-cap truncation: weight killed at stall_steps
        # as a fraction of all escaped-and-recorded weight (spec channel 0,
        # incl. the out-of-bin dump row — both in scaled units).  The
        # reference caps at max_n_step=1.28e6 (consts.hpp:55); the bench
        # profile's far lower cap is only admissible while this stays <<1%.
        w_rec = float(self.spec_acc[:, 0].sum())
        w_stall = float(counters.w_stall)
        stats["n_stall_killed"] = int(counters.n_stall)
        stats["w_stall_frac"] = w_stall / max(w_rec + w_stall, 1e-300)
        # Hotcross clamp census (ops/hotcross.clamp_hit): must stay 0 or
        # the device sigma deviates from the reference's numeric fallback.
        stats["n_hc_clamp"] = int(counters.n_hc_clamp)
        # Anti-stall census: events consumed with a softened/forced draw.
        stats["n_ev_soft"] = int(counters.n_ev_soft)
        stats["n_ev_forced"] = int(counters.n_ev_forced)
        if stats["n_hc_clamp"]:
            log.warning("hotcross clamp hits: %d interacting steps left the "
                        "sigma table domain", stats["n_hc_clamp"])
        if stats["n_stall_killed"]:
            log.info("step-cap truncation: %d photons, %.3g of recorded "
                     "weight", stats["n_stall_killed"], stats["w_stall_frac"])
        # Lane-slot utilization decomposition.  ls_slots is the true
        # denominator — counters accumulate across engine stages with
        # different pool widths (pilot, waves, 4096/1024/256 tail cascade),
        # so slots offered = sum of n_pool over iterations, not
        # ls_iters * n_pool (which once reported 9.5% "occupancy" for a run
        # whose wave logs showed ~85%).  util = whole run;
        # util_waves = pilot+main waves only (pre-tail-drain snapshot).
        def _util(c):
            slots = float(c.ls_slots)
            if slots <= 0:
                return None
            return {
                "hot_iters": int(c.ls_iters),
                "occupied": float(c.ls_occupied) / slots,
                "moving": float(c.ls_moving) / slots,
                "committed": float(c.ls_committed) / slots,
                "parked": float(c.ls_parked) / slots,
            }

        u_all, u_w = _util(counters), _util(c_waves)
        if u_all:
            stats["hot_iters"] = u_all["hot_iters"]
            stats["util_occupied"] = u_all["occupied"]
            stats["util_moving"] = u_all["moving"]
            stats["util_committed"] = u_all["committed"]
            stats["util_parked"] = u_all["parked"]
        if u_w:
            stats["util_waves"] = [u_w["occupied"], u_w["moving"],
                                   u_w["committed"], u_w["parked"]]
        log.info("Final rate %.2f ph/s", stats["photon_rate"])
        log.info("Super photons: created %d, recorded %d",
                 stats["n_created"], stats["n_recorded"])
        spec = unscale_spectrum(self.spec_acc, self.cfg.weight_scale)
        self.state = state
        self.spec = spec
        return spec, stats

    def report(self, spectrum_path: str, spec=None):
        spec = self.spec if spec is None else spec
        rows = spectrum_ops.write_spectrum(spectrum_path, np.asarray(spec), self.mc)
        log.info("Spectrum written to %s", spectrum_path)
        log.info("\tluminosity: %g", rows["luminosity"])
        log.info("\tmax_tau_scatt: %g", rows["max_tau_scatt"])
        return rows
