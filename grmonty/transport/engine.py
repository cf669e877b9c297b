"""The batched geodesic transport engine — the hot loop.

A JAX re-design of the reference's transport backends (CPU recursive
tracker ``harm_model.cpp:894-1069`` and the CUDA persistent photon-pool
pipeline ``super_photon.cu:505-1037``):

* Photons are an SoA pool stepped in lockstep inside one ``lax.while_loop``;
  boolean masks replace the CUDA ``PhotonState`` enum.
* **Layout**: all physics runs on separate (N,) component arrays, one per
  4-vector component, so every operation is a flat elementwise map over
  the pool (a layout chosen before the port to the H100; not yet measured
  against other layouts on it).
* **One gather per step**: each iteration does ONE dynamic row gather of
  the packed bilinear corner table (derived fluid state with
  ``derived_fluid``); the hotcross/K2 table lookups are Chebyshev
  surrogates (``ops/cheb.py``) that evaluate as FMA chains and one small
  matmul.
* Every iteration makes exactly one implicit-midpoint attempt per lane; the
  reference's recursive step halving (``harm_model.cpp:1217-1289``) becomes
  a persistent per-lane ``dl_shrink`` retry (see :func:`push_once`) so a
  single misbehaving lane never forces batch-wide extra geometry rounds.
  The trapezoid opacity/scatter-decision update runs for lanes that
  advanced.
* Scattering is deferred: a lane that draws a scatter event rolls back to
  its pre-step state, re-pushes by ``frac*dl``, then idles until the
  periodic phase (every ``m_period`` iterations) runs the event kinematics
  for all pending lanes at once.  This mirrors the reference GPU driver's
  every-7th-iteration cadence for refill + record (``super_photon.cu:656``).
* Secondaries and the emission backlog live in packed (., 16) row buffers
  so refill costs two row gathers + one row scatter per periodic phase
  (replacing the GPU->host->queue feedback loop, ``super_photon.cu:858-958``).
* Escaped photons are recorded into the (6 x 200 x 13) spectrum with a
  masked scatter-add (replacing spectrum atomics, ``super_photon.cu:1586``).
  The spectrum accumulator is engine-dtype; the driver drains it to a host
  float64 accumulator every dispatch slice.
* The bias-feedback scalars (max_tau_scatt, n_recorded, n_scatt) ride in
  the loop carry and refresh each periodic phase — the reference reads them
  racily mid-flight (``super_photon.cu:36-46,1649``), so the staleness is
  equivalent by design.

RNG: one threefry key in the carry; each draw site consumes a split and
draws the whole batch (photons are exchangeable, so per-lane streams are
unnecessary; statistical parity is the acceptance criterion).
"""

import math
import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random

from grmonty import consts
from grmonty.ops import cheb, emission, fluid, geometry, radiation, scattering

PI = math.pi

N_SPEC_CHAN = 16  # Spectrum struct channels (harm_data.hpp:129-143) + three:
#   extra: channel 13 accumulates sum((w*e)^2), the per-bin MC variance of
#   the energy channel (not in the reference; powers the accuracy harness'
#   chi^2 error bars).  It is quadratic in the weight scale — see
#   driver.unscale_spectrum.  channel 14 counts recorded SECONDARIES
#   (photons born at a scatter event, Pool.nsc0 > 0) for the
#   bias-equilibrium count-shape gate.  channel 15 sums
#   the birth GENERATION nsc0 over recorded secondaries — generation-g
#   populations scale as kappa^g under a bias-equilibrium offset kappa,
#   so gbar(band) = ch15/ch14 powers the per-generation count-shape model.
# channel order: dn_dle, de_dle, nph, nscatt, x1i_av, x2i_sq, x3f_sq,
#                tau_abs, tau_scatt, ne_0, theta_e_0, b_0, e_0
N_BINS = consts.N_TH_BINS * consts.N_E_BINS
DUMP_BIN = N_BINS  # overflow row for masked-out scatter-adds

# Packed photon-row schema shared by the backlog and the secondary buffer
# (the InitPhoton struct, photon.hpp:41-52, as one gatherable row).
ROW_X = slice(0, 4)
ROW_K = slice(4, 8)
(ROW_W, ROW_E, ROW_L, ROW_NE0, ROW_THETAE0, ROW_B0, ROW_E0, ROW_NSCATT) = range(8, 16)
ROW_WIDTH = 16


class EngineConfig(typing.NamedTuple):
    n_pool: int = 16384  # concurrently tracked photons
    m_period: int = 16  # iterations between periodic (refill/record/scatter) phases
    sec_cap: int = 65536  # secondary ring-buffer capacity
    max_inner: int = 256  # cap on push sub-segment rounds
    max_outer: int = 50_000_000  # hard safety cap on hot iterations per wave
    tail_exit: int = 0  # exit the wave once backlog is drained and at most
    #   this many lanes remain occupied (they carry over to the next wave)
    stall_steps: int = consts.MAX_N_STEP  # per-photon step cap (reference value)
    fp_iters: int = consts.MAX_ITER  # implicit-midpoint fixed-point iterations
    interp_geom: bool = False  # EXPERIMENTAL gather-everything hot loop: the
    #   connection (biquadratic) and derived fluid state (bilinear) come from
    #   ONE 3x3-stencil row gather per geodesic attempt
    #   (fluid.make_geom_table) instead of closed-form Christoffels + a
    #   separate fluid gather per step; the conserved-energy metric row stays
    #   analytic.  It lost to the analytic path before the port: 22% of lanes
    #   stuck in shrink-retry (the interpolated connection is inconsistent
    #   with the analytic energy row, tripping the drift test) vs ~0.1%
    #   analytically.  Not yet measured on the H100; default stays
    #   analytic.
    ref_err_metric: bool = False  # fixed-point convergence test for halving:
    #   False (default): sum_i |dk_i| / (sum_i |k_i|) — scale-invariant and
    #     zero-crossing-safe.  The reference's per-component relative error
    #     (harm_model.cpp:1264) diverges whenever a k component crosses zero,
    #     sending that lane down the full depth-7 halving tree (255 segment
    #     rounds); harmless for a scalar CPU photon, catastrophic in lockstep
    #     where the batch-max round count is what everyone pays.  The energy
    #     drift check (err_e, the actual physics guard) is kept exactly.
    #   True: the reference formula, for A/B parity runs.
    dbg_skip: str = ""  # comma-set of hot-loop pieces to stub out, for the
    #   micro-benchmarks only: "fluid" (interaction physics incl. the corner
    #   gather), "push" (geodesic step), "scatter" (periodic event phase),
    #   "record", "refill".  Never set in production runs.
    ev_k: int = 0  # compacted working-set width of the periodic phase
    #   (scatter events, spectrum record, refill+init batches per phase);
    #   0 = auto (n_pool/8).  This caps how many lanes can retire+reload
    #   and how many deferred scatter events can be served per periodic
    #   phase: in the Compton-storm regime (inner-torus zones) deaths and
    #   events per phase exceed n_pool/8 and the pool starves at ~50%
    #   occupancy with ~20% of occupied lanes parked at_event — raise
    #   ev_k (or lower m_period) so ev_k >= deaths_per_iter * m_period.
    bias_fixed_tau: float = 0.0  # frozen-bias comparison mode (with
    #   bias_fixed_avg): when > 0 the scattering-bias normalization reads
    #   these CONSTANTS instead of the live feedback counters
    #   (harm_model.cpp:1391-1404).  The live ratchet (max_tau_scatt) is
    #   an unstable extreme-value statistic — measured at M4e19/20k the
    #   ORACLE jumped to 2.38 while the engine sat at 0.15, making count-
    #   level comparisons meaningless; pinning the bias (a pure variance-
    #   reduction parameter — the estimator is unbiased in it) lets the
    #   accuracy harness hard-gate secondary populations per band.
    #   Validation-only; production runs use the live feedback.
    bias_fixed_avg: float = 2.0
    trace_birth: bool = False  # diagnostic: carry each lane's BIRTH state
    #   (x, k, w at load — Pool.bx/bk/bw) and capture, at record time, the
    #   birth state of the photon holding the max_tau_scatt ratchet
    #   (Counters.mt_*).  Powers the deep-tau path-replay harness
    #   (tools/replay_deep_tau.py): the captured birth
    #   state replays through the scalar oracle's nominal-step integrator
    #   to classify engine deep-tau records as true tail vs grown-step
    #   trapezoid artifact.  Off in production (9 extra (N,) carries).
    step_ctrl: float = 0.0  # error-PROPORTIONAL step controller safety
    #   factor (0 = off, legacy halve/grow ladder).  >0: the per-lane step
    #   factor is driven by the MEASURED error of each attempt,
    #   fac = step_ctrl / sqrt(err/tol), clamped to [0.25, 2] per step —
    #   standard adaptive-ODE step control (the implicit midpoint's local
    #   error is ~O(h^2) in the fixed-point-convergence metric, so the
    #   1/2-power targets the tolerance boundary in one move).  The commit
    #   gate (fixed-point convergence + conserved-energy drift, identical
    #   tests/tolerances to the reference's halving recursion,
    #   harm_model.cpp:1217-1289) is UNCHANGED — this only decides the
    #   next attempt's size.  Measured motivation: the geometric ladder
    #   wastes ~15% of moving slots on rejected boundary probes and takes
    #   ~12 commits to regrow to grow_cap=8 (half a typical photon
    #   lifetime); the controller removes both.  Safety is a real knob:
    #   0.9 rides the boundary (committed 0.706, 28.3 steps/photon); 0.6
    #   keeps a margin (equilibrium err ~ 0.36 tol; committed 0.828, 21.7
    #   steps/photon); 0.7 over-grows into a different (heavier) scattering
    #   equilibrium.  0.6 was chosen before the port to the H100 and is
    #   chi2-gated; its speed is not yet measured on the H100.
    grow_rate: float = 2.0  # per-commit multiplier of the per-lane step
    #   factor dl_shrink (the halving side stays x0.5, matching the
    #   reference's bisection).  2.0 = symmetric double/halve, which at the
    #   error-test boundary ping-pongs commit/fail and wastes ~1/3 of push
    #   attempts (micro: util_committed 0.36 vs util_moving 0.55 at
    #   grow_cap=4).  A gentler rate (e.g. 2^0.25 ~ 1.19) approaches the
    #   boundary in small increments so most attempts commit; the same two
    #   error tests still gate every step.
    refill_k: int = 0  # compacted working-set width of the REFILL half of
    #   the periodic phase (backlog/secondary load + init_fresh), decoupled
    #   from ev_k.  0 = same as ev_k.  Refill is far cheaper per lane than
    #   the scatter-event samplers, so when deaths-per-phase exceed
    #   events-per-phase (fast-retiring regimes: grow_cap > 1 and/or
    #   detached_events) the pool can be kept full by raising refill_k
    #   alone instead of paying a wider event phase.
    bias_ema: float = 0.0  # EMA weight for the scattering-bias feedback's
    #   avg-scatters-per-recorded statistic.  0 (default) = the reference's
    #   cumulative n_scatt/n_recorded ratio (harm_model.cpp:1391-1404).
    #   >0: avg is an exponential moving average of the per-full-phase
    #   MARGINAL ratio.  Why: the cumulative ratio relaxes from the cold-
    #   start Compton storm like 1/t, so the storm's history depresses the
    #   bias for millions of subsequent records — measured on the bench
    #   torus, total scattering work varies 2.3x run-to-run depending on
    #   the storm's random magnitude (n_scatt_rec 5.9M vs 13.8M at
    #   identical physics).  The EMA tracks the current-regime equilibrium
    #   within ~1/alpha full phases and forgets the transient; the bias is
    #   a variance-reduction knob (the estimator is unbiased in it), and
    #   the deviation is chi2-gated like every other knob.
    light_k: int = 0  # compacted working-set width of the LIGHT phases
    #   (record + refill widths both); 0 = inherit ev_k/refill_k.  The
    #   light phase only needs to absorb deaths since the last maintenance
    #   point (~n_pool * refill_period / steps_per_photon lanes), so its
    #   gathers/scatters can run far narrower than the full phase's.
    refill_period: int = 0  # cadence (hot iterations) of LIGHT record+refill
    #   phases run between the full periodic phases.  0 = off (legacy: all
    #   pool maintenance happens every m_period iterations).  Rationale
    #   (Little's law): a lane whose photon retires
    #   mid-period idles until the next periodic phase — with m_period=16
    #   and ~28 steps/photon mean lifetime that is ~30% of all occupied
    #   lane-slots spent holding finished photons, and pool occupancy saws
    #   between full and ~55%.  A light phase (spectrum record + free dead
    #   lanes + refill + init; NO scatter-event samplers, NO extra RNG
    #   splits) costs ~1/6 of a hot iteration and keeps the pool full.
    #   Scheduling-only deviation: photons' physics is untouched (same
    #   trajectories modulo RNG stream assignment); chi2-gated like every
    #   other knob.  Must divide m_period; 4 was chosen before the port to
    #   the H100 and is not yet measured on it.
    grow_tau_cap: float = 0.01  # when grow_cap > 1, bound the optical
    #   depth a GROWN step may carry, three ways (all off at 0):
    #   (1) a-priori: cap the grown segment so the per-step BIASED
    #   scattering depth bias * alpha_scatt * d_tau_k * seg stays below
    #   this value (hot_phase_a; the geodesic error tests gate growth
    #   geometrically, but the scatter decision and trapezoid opacity are
    #   per-step linearizations whose accuracy degrades with dtau per
    #   step: at 20k-photon chi^2 power the f32+grow_cap=8 profile showed
    #   a +4% luminosity bias concentrated in the Compton-tail groups
    #   without it);
    #   (2) a-posteriori: a lane whose REALIZED step depth exceeded the
    #   cap loses its growth next step (the a-priori cap reads the stale
    #   start-of-step alpha);
    #   (3) vacuum->matter ENTRY rollback: a grown step from zero
    #   opacities landing in matter is rolled back and retried at nominal
    #   size — its trapezoid (0 + alpha_landing)/2 * grown_seg
    #   overestimates the true path depth by up to the growth factor, and
    #   those inflated depths on rare recorded deep photons ratchet
    #   max_tau_scatt (the bias normalization) far above the oracle's
    #   seed-stable value (measured 0.019 vs 0.0024 at M=4e19, halving
    #   the recorded-secondary population).  Thin regions (where growth
    #   pays) are untouched.
    #   Default 0.01 (was 0.25): a single in-matter grown step at the old
    #   cap could legitimately add dtau 0.25 — 100x the oracle's
    #   seed-stable MAX total path depth at M=4e19 — so deep-core
    #   orbiters still produced ratchet outliers (a recorded tau 0.22).
    #   At 0.01 the cap binds only lanes whose step would carry >= 4x the
    #   oracle's whole-path maximum; typical in-core steps carry
    #   1e-5..1e-4 and keep their full growth.
    grow_cap: float = 1.0  # upper clamp on the per-lane adaptive step
    #   factor dl_shrink.  1.0 (default) = reference semantics: a lane's
    #   step never exceeds the nominal step_size (harm_model.cpp:1620-30).
    #   >1 lets well-behaved lanes GROW their step beyond nominal, still
    #   gated by the same two error tests (fixed-point convergence and
    #   conserved-energy drift) that gate halving — an accuracy-controlled
    #   deviation that directly divides steps/photon.  Pend-push segments
    #   are clamped to the remaining re-push length so scatter events still
    #   land exactly.  Validate spectrum drift (validate_accuracy) before
    #   adopting a value.
    derived_fluid: bool = False  # hot-step interaction phase gathers the
    #   DERIVED fluid state (n_e, theta_e, |B|, u_cov, b_cov — 11 comps x 4
    #   corners, fluid.make_derived_corner_table) instead of the 8 raw
    #   primitives, and blends those bilinearly.  Removes the per-step
    #   gcov_c + gcon_c metric pair and the _four_vectors_c u0/b^mu
    #   reconstruction from phase B entirely (the gather moves 44 values
    #   per lane instead of 32).  Second-order
    #   interpolation deviation (blend-of-derived vs derive-of-blended);
    #   chi2-gated.  XLA shared hot path only.
    hot_halves: int = 1  # run the hot iteration as this many independent
    #   pool-part chains (a -> corner gather -> b each), so XLA may overlap
    #   one part's gather with another part's arithmetic.  Exact — same
    #   per-lane math on the same uniforms, concatenated in order.  Must
    #   divide n_pool.  It tied with gather_split before the port; not yet
    #   measured on the H100; default 1.
    ev_halve: int = 16  # scatter-event anti-stall: halve the sampler
    #   theta_e every this many deferred phases (see process_scatters —
    #   the old value 2 softened the electron spectrum in exactly the
    #   low-acceptance hot zones that produce the top Compton bands;
    #   measured 20-46% band deficit vs the compiled reference at 20k
    #   photons, VSREF r4)
    ev_force: int = 32  # force-accept the final sampler draw at this many
    #   deferred phases (livelock backstop; ~512 total rejection rounds)
    detached_events: bool = False  # parent photons continue IMMEDIATELY
    #   after a scatter event instead of parking at_event until the next
    #   periodic phase (an average m_period/2-iteration stall per event).
    #   The event's pre-sampling record (position, parent momentum,
    #   secondary weight) is captured into per-lane shadow registers at
    #   arrival — everything the deferred secondary sampler needs, since
    #   the parent's fate (harm_model.cpp:1071-1081 k0 checks) and its
    #   post-event opacity refresh (:1026-1039) depend only on parent
    #   state, never on the sampled secondary.  A lane that scatters AGAIN
    #   before its pending event is consumed parks as before (rare).
    #   Physically identical semantics, different RNG trajectory.
    #   Works on the sharded path (the shadow registers shard like every
    #   other pool array, parallel/sharding._state_specs; exercised by
    #   tests/test_sharding.py).
    col_gather: bool = False  # gather the bilinear corner rows from the
    #   TRANSPOSED (32, n_zones) table so the hot step receives the 32
    #   components as rows of a (32, N) array instead of extracting
    #   columns of the gathered (N, 32) rows.  Physically exact (same
    #   values, same order).  It lost before the port; not yet measured on
    #   the H100; kept OFF as an A/B knob.
    gather_split: int = 1  # issue the hot-step corner gather as this many
    #   independent sub-gathers over pool slices, which XLA may overlap.
    #   The sub-gathers are exact (same rows, concatenated in order);
    #   phases a/b stay pool-wide.  Chosen before the port, for a row
    #   gather that was latency-bound; not yet measured on the H100.
    #   1 = one gather.
    mxu_extract: bool = False  # transpose the gathered (N, C) corner rows
    #   to (C, N) with ONE one-hot dot_general (fluid.onehot_transpose)
    #   before phase_b, handing the physics C component vectors instead
    #   of letting XLA fuse C column extractions into the physics fusions.
    #   Exact at Precision.HIGHEST (one-hot products), so the blend math
    #   downstream is bitwise identical to the column path.  Chosen before
    #   the port, where the column extraction was expensive; not yet
    #   measured on the H100.
    fluid_cache: bool = False  # carry each lane's bilinear corner row in
    #   the pool and re-gather only lanes whose cell changed (a few % per
    #   step), compacted (see fluid.get_fluid_params_frow).  Physically
    #   exact (residual = FP reassociation, ~1e-15 rel).  It lost in the
    #   engine before the port: the (32, N) column scatter into the large
    #   while_loop carry defeated XLA's in-place aliasing.  Not yet
    #   measured on the H100; kept as a tested option; default stays the
    #   plain pool-wide gather.
    dtype: typing.Any = jnp.float64
    # Global factor applied to photon weights on emission.  Raw grmonty
    # weights reach ~1e50, past float32's range (~3.4e38), so the float32
    # engine would overflow them to inf.  All weight comparisons scale with
    # this factor and the spectrum is unscaled at report time, so it is
    # physically inert.
    weight_scale: float = 1.0e-25


class Tables(typing.NamedTuple):
    f_table: jnp.ndarray  # (201,) ln F(k)
    k2_table: jnp.ndarray  # (201,) ln K2
    hotcross: jnp.ndarray  # (221, 81) log10 sigma
    weights: jnp.ndarray  # (201,) ln photon weight vs frequency


class Pool(typing.NamedTuple):
    # 4-vectors live as tuples of 4 independent (N,) component arrays, NOT
    # (4, N) stacks, so the hot phases consume and produce them with no
    # stack/unstack traffic (chosen before the port to the H100; not yet
    # measured against a stacked layout on it).
    x: tuple  # 4 x (N,)
    k: tuple  # 4 x (N,)
    dkdlam: tuple  # 4 x (N,)
    w: jnp.ndarray  # all below: (N,)
    e: jnp.ndarray
    l: jnp.ndarray
    x1i: jnp.ndarray
    x2i: jnp.ndarray
    tau_abs: jnp.ndarray
    tau_scatt: jnp.ndarray
    n_e_0: jnp.ndarray
    theta_e_0: jnp.ndarray
    b_0: jnp.ndarray
    e_0: jnp.ndarray
    e_0_s: jnp.ndarray
    alpha_scatti: jnp.ndarray
    alpha_absi: jnp.ndarray
    bi: jnp.ndarray
    pend_dl: jnp.ndarray  # remaining re-push length for a decided scatter
    dl_shrink: jnp.ndarray  # per-lane adaptive step shrink in [2^-7, 1]
    sec_w: jnp.ndarray  # secondary weight frozen at decision time
    frow: tuple  # 32 x (N,) cached bilinear corner row components
    #   (fluid_cache only; () when disabled).  Component arrays — not a
    #   (32, N) stack — so the compacted refresh is 32 in-place 1D lane
    #   scatters instead of a column scatter that defeats carry aliasing.
    cell: jnp.ndarray  # (N,) int32 cell id the cache was gathered for (-1 none)
    bx: tuple  # 4 x (N,) BIRTH position (trace_birth only; ())
    bk: tuple  # 4 x (N,) birth wave vector (trace_birth only; ())
    bw: jnp.ndarray  # (N,) birth weight (trace_birth only; (0,))
    ev_x: tuple  # 4 x (N,) event-point position (detached_events only; ())
    ev_k: tuple  # 4 x (N,) parent momentum at the event point
    ev_w: jnp.ndarray  # (N,) secondary weight captured at the event
    ev_pending: jnp.ndarray  # (N,) bool: shadow registers hold an
    #   unconsumed scatter event; the lane may keep moving but cannot be
    #   freed/reused until the periodic phase consumes it
    n_scatt: jnp.ndarray  # int32
    nsc0: jnp.ndarray  # int32: n_scatt at LOAD time (0 = primary photon,
    #   >=1 = secondary born at a scatter event).  Biased scattering never
    #   deflects the parent (harm_model.cpp:1005-1051: the secondary gets
    #   the sampled direction, the parent continues), so recorded PRIMARY
    #   counts are invariant under any bias-equilibrium offset while
    #   secondary counts scale ~linearly with the bias — spectrum channel
    #   14 splits the two so the accuracy harness can gate the
    #   thick-regime count shape against that model.
    n_step: jnp.ndarray  # int32
    ev_tries: jnp.ndarray  # int32: periodic phases this lane's scatter event
    #   has been deferred by sampler round caps (see process_scatters)
    occupied: jnp.ndarray  # slot holds a photon (possibly awaiting record)
    alive: jnp.ndarray  # still being tracked
    interacting: jnp.ndarray  # opacity coupling still possible
    pend_push: jnp.ndarray  # next hot iteration is the partial re-push
    at_event: jnp.ndarray  # waiting for the periodic scatter phase
    record_pending: jnp.ndarray  # escaped; record at the periodic phase


class SecBuf(typing.NamedTuple):
    """On-device secondary-photon buffer: packed rows + count."""

    rows: jnp.ndarray  # (S, 16)
    count: jnp.ndarray  # scalar int32


class Counters(typing.NamedTuple):
    n_recorded: jnp.ndarray  # int64
    n_scatt_rec: jnp.ndarray  # int64: sum of n_scatt over recorded photons
    max_tau_scatt: jnp.ndarray  # float: running max over recorded photons
    n_created: jnp.ndarray  # int64: primaries consumed from the backlog
    n_sec_drop: jnp.ndarray  # int64: secondaries lost to buffer overflow
    n_retired: jnp.ndarray  # int64: lanes retired (recorded or died)
    n_steps_retired: jnp.ndarray  # int64: sum of n_step over retired lanes
    # Lane-slot utilization accounting.  One pool-iteration offers n_pool
    # lane-slots; these decompose where they go: occupied (lane holds a
    # photon), moving (alive and not parked at a scatter event), committed
    # (the geodesic attempt passed both error tests and advanced).
    ls_iters: jnp.ndarray  # int64: hot iterations accumulated
    ls_slots: jnp.ndarray  # int64: lane-slots offered = sum of n_pool over
    #   iterations.  The census denominator: counters carry across engine
    #   stages with different pool widths (pilot, main waves, tail cascade
    #   at 4096/1024/256), so dividing the sums below by ls_iters * any one
    #   n_pool misstates utilization wildly (a run once reported 9.5%
    #   occupancy while the wave logs showed ~85% — the tail cascade's
    #   thousands of narrow iterations were multiplied by the 65536-wide
    #   main pool).
    ls_occupied: jnp.ndarray  # int64: sum over iterations of occupied lanes
    ls_moving: jnp.ndarray  # int64: sum of moving lanes
    ls_committed: jnp.ndarray  # int64: sum of committed (useful) pushes
    ls_parked: jnp.ndarray  # int64: sum of at_event lanes (scatter parking)
    # EMA bias feedback (EngineConfig.bias_ema > 0): the windowed
    # avg-scatters-per-recorded estimate and the marks of the cumulative
    # counters at the last EMA update (to form marginal deltas).
    avg_ema: jnp.ndarray  # engine-dtype scalar
    ema_scatt_mark: jnp.ndarray  # int64
    ema_rec_mark: jnp.ndarray  # int64
    # Step-cap truncation accounting: photons killed at
    # EngineConfig.stall_steps (the reference kills at max_n_step=1.28e6,
    # consts.hpp:55; the bench profile caps far lower) carry unrecorded
    # weight out of the simulation.  These quantify that truncated flux so
    # the accuracy harness can gate it (w_stall is in SCALED weight units,
    # comparable to the spectrum's channel-0 sums).
    n_stall: jnp.ndarray  # int64: lanes killed at the step cap
    w_stall: jnp.ndarray  # engine-dtype: summed remaining weight of those
    # Deep-tau trace capture (EngineConfig.trace_birth only; zeros
    # otherwise): the BIRTH state of the recorded photon currently holding
    # the max_tau_scatt ratchet, for the path-replay harness
    # (tools/replay_deep_tau.py).
    mt_bx: jnp.ndarray  # (4,) birth position
    mt_bk: jnp.ndarray  # (4,) birth wave vector
    mt_bw: jnp.ndarray  # scalar birth weight
    mt_nsc0: jnp.ndarray  # int64 birth generation
    # Scatter-event anti-stall census: events CONSUMED with a softened
    # (>= ev_halve defers, theta_e halved at least once) or force-accepted
    # (>= ev_force defers) sampler draw.  The anti-stall distorts exactly
    # the hot-zone events that build the top Compton bands (the reference
    # only halves after 1e7 scalar tries, proba.cpp:59-64), so the
    # accuracy harness needs to SEE how many events it touched.
    n_ev_soft: jnp.ndarray  # int64
    n_ev_forced: jnp.ndarray  # int64
    # Hotcross table-domain clamp census (XLA shared hot path): interacting
    # lane-steps whose (w, theta_e) fell in the region where the reference
    # re-runs the numeric integral (hotcross.cpp:81-106) but the device
    # lookup clamps (ops/hotcross.clamp_hit).  The accuracy harness asserts
    # this stays 0 — proving the documented deviation is unreachable.
    n_hc_clamp: jnp.ndarray  # int64


class State(typing.NamedTuple):
    pool: Pool
    spec: jnp.ndarray  # (N_BINS + 1, N_SPEC_CHAN) engine-dtype accumulators (+1 dump row)
    counters: Counters
    sec: SecBuf
    backlog_pos: jnp.ndarray  # int32: next unconsumed primary
    key: jnp.ndarray
    it: jnp.ndarray  # int32 hot-iteration counter


def isnan4(v):
    """Any-NaN mask over a 4-tuple of (N,) components."""
    return (jnp.isnan(v[0]) | jnp.isnan(v[1])
            | jnp.isnan(v[2]) | jnp.isnan(v[3]))


def where4(m, a, b):
    """Per-component select over 4-tuples of (N,) components."""
    return tuple(jnp.where(m, ai, bi) for ai, bi in zip(a, b))


def empty_pool(n, dtype, fluid_cache=False, detached_events=False,
               trace_birth=False):
    z = lambda: jnp.zeros((n,), dtype)
    zi = lambda: jnp.zeros((n,), jnp.int32)
    zb = lambda: jnp.zeros((n,), bool)
    z4 = lambda: (z(), z(), z(), z())
    # The corner-row cache fields exist only when the fluid_cache path is
    # on: 32 x (N,) f32 is 8 MB at the bench pool size, and a dead carry of
    # that size still costs memory traffic in the hot while_loop.  Same for
    # the detached-event shadow registers
    # (10 x (N,)).
    nc = n if fluid_cache else 0
    ne = n if detached_events else 0
    return Pool(
        x=z4(), k=z4(), dkdlam=z4(), w=z(), e=z(), l=z(), x1i=z(), x2i=z(),
        tau_abs=z(), tau_scatt=z(), n_e_0=z(), theta_e_0=z(), b_0=z(), e_0=z(),
        e_0_s=z(), alpha_scatti=z(), alpha_absi=z(), bi=z(), pend_dl=z(),
        dl_shrink=jnp.ones((n,), dtype), sec_w=z(),
        frow=(tuple(z() for _ in range(32)) if fluid_cache else ()),
        cell=jnp.full((nc,), -1, jnp.int32),
        bx=(z4() if trace_birth else ()),
        bk=(z4() if trace_birth else ()),
        bw=jnp.zeros((n if trace_birth else 0,), dtype),
        ev_x=(z4() if detached_events else ()),
        ev_k=(z4() if detached_events else ()),
        ev_w=jnp.zeros((ne,), dtype),
        ev_pending=jnp.zeros((ne,), bool),
        n_scatt=zi(), nsc0=zi(), n_step=zi(), ev_tries=zi(),
        occupied=zb(), alive=zb(), interacting=zb(), pend_push=zb(),
        at_event=zb(), record_pending=zb(),
    )


def empty_secbuf(s, dtype):
    return SecBuf(rows=jnp.zeros((s, ROW_WIDTH), dtype),
                  count=jnp.zeros((), jnp.int32))


def init_counters(max_tau_scatt_init, dtype):
    zi = lambda: jnp.zeros((), jnp.int64)
    return Counters(
        n_recorded=zi(), n_scatt_rec=zi(),
        max_tau_scatt=jnp.asarray(max_tau_scatt_init, dtype),
        n_created=zi(), n_sec_drop=zi(),
        n_retired=zi(), n_steps_retired=zi(),
        ls_iters=zi(), ls_slots=zi(), ls_occupied=zi(), ls_moving=zi(),
        ls_committed=zi(), ls_parked=zi(),
        avg_ema=jnp.zeros((), dtype), ema_scatt_mark=zi(), ema_rec_mark=zi(),
        n_stall=zi(), w_stall=jnp.zeros((), dtype),
        mt_bx=jnp.zeros((4,), dtype), mt_bk=jnp.zeros((4,), dtype),
        mt_bw=jnp.zeros((), dtype), mt_nsc0=zi(),
        n_ev_soft=zi(), n_ev_forced=zi(),
        n_hc_clamp=zi(),
    )


def _util_counters(counters, occupied, moving, commit, parked):
    """Accumulate the per-iteration lane-slot census (5 cheap reductions)."""
    i64 = counters.ls_iters.dtype
    return counters._replace(
        ls_iters=counters.ls_iters + 1,
        ls_slots=counters.ls_slots + occupied.shape[0],
        ls_occupied=counters.ls_occupied + jnp.sum(occupied).astype(i64),
        ls_moving=counters.ls_moving + jnp.sum(moving).astype(i64),
        ls_committed=counters.ls_committed + jnp.sum(commit).astype(i64),
        ls_parked=counters.ls_parked + jnp.sum(parked).astype(i64),
    )


def pack_rows(b: emission.InitPhotons, dtype) -> np.ndarray:
    """Pack an InitPhotons batch into (T, 16) rows (host-side numpy)."""
    x = np.asarray(b.x, np.float64)
    k = np.asarray(b.k, np.float64)
    cols = [x[:, i] for i in range(4)] + [k[:, i] for i in range(4)] + [
        np.asarray(b.w, np.float64), np.asarray(b.e, np.float64),
        np.asarray(b.l, np.float64), np.asarray(b.n_e_0, np.float64),
        np.asarray(b.theta_e_0, np.float64), np.asarray(b.b_0, np.float64),
        np.asarray(b.e_0, np.float64),
        np.asarray(b.n_scatt, np.float64),
    ]
    return np.stack(cols, axis=1).astype(np.dtype(dtype))


def push_attempt_c(x, k, dkdlam, e_0_s, seg_dl, active, at_floor,
                   a, hs, r0, fp_iters, ref_err_metric=False):
    """ONE implicit-midpoint geodesic attempt (analytic geometry), pure.

    Module-level so the shared and legacy hot paths use the exact same
    math (harm_model.cpp:1217-1289; iterative
    form super_photon.cu:1826-1929).  ``x``/``k``/``dkdlam``: 4-tuples of
    (N,) components.  Returns (x, k, dk, e0s, commit, err_ratio) where
    ``err_ratio`` = max(err/E_TOL, err_e/E_DRIFT_TOL) — the normalized
    worst error test (>1 means the attempt failed); the error-proportional
    step controller (EngineConfig.step_ctrl) feeds on it.
    """
    dl_2 = 0.5 * seg_dl
    k_half = tuple(kk + dd * dl_2 for kk, dd in zip(k, dkdlam))
    k_pred = tuple(kh + dd * dl_2 for kh, dd in zip(k_half, dkdlam))
    x_new = tuple(xx + kh * seg_dl for xx, kh in zip(x, k_half))

    conn = geometry.connection_c(x_new[1], x_new[2], a, hs)
    row0 = geometry.gcov_row0_c(x_new[1], x_new[2], a, hs, r0)

    err = jnp.zeros_like(e_0_s)
    dk_new = dkdlam
    for _ in range(fp_iters):
        dk_new = geometry.geodesic_rhs_c(conn, *k_pred)
        k_next = tuple(kh + dl_2 * dd for kh, dd in zip(k_half, dk_new))
        if ref_err_metric:
            err = sum(
                jnp.abs((kp - kn) / (kn + consts.EPS))
                for kp, kn in zip(k_pred, k_next)
            )
        else:
            kscale = sum(jnp.abs(kn) for kn in k_next) + consts.EPS
            err = sum(
                jnp.abs(kp - kn) for kp, kn in zip(k_pred, k_next)
            ) / kscale
        k_pred = k_next
    k_new = k_pred

    g00, g01, g03 = row0
    e_1 = -(k_new[0] * g00 + k_new[1] * g01 + k_new[3] * g03)
    err_e = jnp.abs((e_1 - e_0_s) / (e_0_s + consts.EPS))

    bad = (err_e > consts.E_DRIFT_TOL) | (err > consts.E_TOL) | ~jnp.isfinite(err)
    commit = active & (~bad | at_floor)

    x = tuple(jnp.where(commit, xn, xx) for xn, xx in zip(x_new, x))
    k = tuple(jnp.where(commit, kn, kk) for kn, kk in zip(k_new, k))
    dk = tuple(jnp.where(commit, dn, dd) for dn, dd in zip(dk_new, dkdlam))
    e0s = jnp.where(commit, e_1, e_0_s)
    err_ratio = jnp.maximum(err / consts.E_TOL, err_e / consts.E_DRIFT_TOL)
    return x, k, dk, e0s, commit, err_ratio


def _capture_events(p, arrived, at_event, x, k, w, sec_w, alive,
                    alpha_scatti, alpha_absi, bi, a_scf, a_abf, bf, nu):
    """Detached-events capture at scatter arrival (pure, elementwise).

    ``p`` supplies the pre-iteration shadow registers/occupancy; the rest
    are this iteration's post-phase-b values.  A parent whose registers
    are free captures its event and continues immediately; a parent
    arriving with a still-pending first event parks (at_event) as in the
    default path.  parent_die (harm_model.cpp:1071-1081 — k0-only checks)
    is decidable here, so doomed parents die at once with the event
    dropped, exactly as process_scatters would have ruled.  The surviving
    parent's post-event opacity refresh (:1026-1039) uses the raw values
    phase_b already evaluated at the arrival position.

    Returns a dict of pool-field overrides.
    """
    k0, k1, _, k3 = k
    pdie = arrived & (
        (k0 > 1.0e5) | (k0 < 0.0) | jnp.isnan(k0)
        | jnp.isnan(k1) | jnp.isnan(k3)
    )
    cap = arrived & ~p.ev_pending & ~pdie
    neg = nu < 0.0
    return dict(
        ev_x=where4(cap, x, p.ev_x),
        ev_k=where4(cap, k, p.ev_k),
        ev_w=jnp.where(cap, sec_w, p.ev_w),
        ev_pending=p.ev_pending | cap,
        at_event=at_event & ~cap & ~pdie,
        alive=alive & ~pdie,
        # a doomed parent still holding an unconsumed FIRST event keeps its
        # lane (the event's birth-constant fields live there) until the
        # periodic phase consumes it; the free line there releases it
        occupied=p.occupied & ~(pdie & ~p.ev_pending),
        w=jnp.where(pdie, jnp.zeros((), w.dtype), w),
        alpha_scatti=jnp.where(
            cap, jnp.where(neg, jnp.zeros((), w.dtype), a_scf), alpha_scatti),
        alpha_absi=jnp.where(
            cap, jnp.where(neg, jnp.zeros((), w.dtype), a_abf), alpha_absi),
        bi=jnp.where(cap, bf, bi),
    )


def hot_phase_a(x, k, dkdlam, e_0_s, dl_shrink, pend_dl, pend_push, at_event,
                alive, w, record_pending, u_roul,
                mc, fp_iters, weight_min, shrink_floor, ref_err_metric=False,
                grow_cap=1.0, grow_rate=2.0, grow_tau_cap=0.0,
                alpha_scatti=None, bi=None, step_ctrl=0.0):
    """Pre-gather half of the hot iteration, pure and elementwise.

    step_size -> geodesic push attempt -> per-lane shrink control ->
    partial-re-push bookkeeping -> stop criterion with Russian roulette ->
    bilinear cell index for the corner gather.  ``x``/``k``/``dkdlam``:
    4-tuples of (N,) components; ``u_roul``: (N,) uniforms (the roulette
    draw, generated by the caller's threefry stream).

    Everything here is lane-local math, which XLA fuses.

    Returns a dict of updated fields plus the masks/values the post-gather
    half (:func:`hot_phase_b`) needs: seg, commit, moving, was_pend,
    arrived, stopped, and the flattened cell index ``z``.
    """
    moving = alive & ~at_event

    dl_full = jnp.where(
        pend_push,
        pend_dl,
        geometry.step_size_c(x[1], x[2], k[1], k[2], k[3], mc.x_stop[2]),
    )
    seg = dl_full * dl_shrink
    # A growing step (grow_cap > 1) must not overshoot a decided scatter
    # event: the re-push segment is capped at the remaining pend length.
    # Exact no-op at grow_cap = 1 (seg <= dl_full always holds there).
    seg = jnp.where(pend_push, jnp.minimum(seg, dl_full), seg)
    if grow_cap > 1.0 and grow_tau_cap > 0.0 and alpha_scatti is not None:
        # Biased-optical-depth growth cap (EngineConfig.grow_tau_cap):
        # the scatter decision is a per-step linearization; never let a
        # GROWN step carry bias*dtau_scatt beyond the cap.  Nominal-size
        # steps are always allowed (reference semantics).
        seg_tau = grow_tau_cap / (
            0.5 * mc.d_tau_k * alpha_scatti * bi + consts.EPS)
        seg = jnp.where(pend_push, seg,
                        jnp.minimum(seg, jnp.maximum(seg_tau, dl_full)))
    at_floor = dl_shrink <= shrink_floor
    act = moving & ~(x[1] < mc.x_start[1])

    xn, kn, dkn, e0sn, commit, err_r = push_attempt_c(
        x, k, dkdlam, e_0_s, seg, act, at_floor,
        mc.a, mc.h_slope, mc.r_0, fp_iters, ref_err_metric,
    )
    if step_ctrl > 0.0:
        # Error-PROPORTIONAL step controller (EngineConfig.step_ctrl —
        # classic adaptive-ODE control replacing the reference's blind
        # halve/grow ladder): the next step factor tracks the measured
        # error toward the tolerance boundary, fac = safety / sqrt(err),
        # clamped to [0.25, 2].  Two wins over the geometric ladder:
        # (1) failed attempts nearly vanish (the ladder pays ~15% of
        # moving slots on rejected pushes probing the boundary);
        # (2) a fresh photon reaches its equilibrium step in ~2-3 commits
        # instead of log_1.19(8) ~ 12 — half a typical 26-step photon
        # lifetime was ramp.  The COMMIT GATE IS UNCHANGED: every accepted
        # step still passes the same two error tests, so the trajectory
        # accuracy class is identical; chi2-gated like every deviation.
        err_eff = jnp.where(jnp.isfinite(err_r), err_r, 1e12)
        err_eff = jnp.where(act, err_eff, 1e-12)  # idle lanes re-grow
        fac = jnp.clip(step_ctrl * lax.rsqrt(jnp.maximum(err_eff, 1e-12)),
                       0.25, 2.0)
        dl_shrink_n = jnp.clip(dl_shrink * fac, shrink_floor, grow_cap)
    else:
        dl_shrink_n = jnp.where(
            act & ~commit,
            jnp.maximum(dl_shrink * 0.5, shrink_floor),
            jnp.minimum(dl_shrink * grow_rate, grow_cap),
        )

    was_pend = pend_push
    pend_rem = jnp.where(pend_push & commit, pend_dl - seg, pend_dl)
    arrived = moving & pend_push & commit & (pend_rem <= 0.0)
    pend_push_n = pend_push & ~arrived
    at_event_n = at_event | arrived

    # Stop criterion + roulette (harm_model.cpp:1589-1616) at the new x.
    checkable = (moving & commit & ~arrived) | (moving & ~act)
    horizon = xn[1] < mc.x1_min
    escaped = xn[1] > consts.X1_MAX
    small = w < weight_min
    win = u_roul <= (1.0 / consts.ROULETTE)
    w_roul = jnp.where(win, w * consts.ROULETTE, 0.0)
    w_n = jnp.where(checkable & small & ~horizon, w_roul, w)
    killed_inside = checkable & small & ~horizon & ~escaped & ~win
    stopped = checkable & (horizon | escaped | killed_inside)
    record = checkable & escaped & ~horizon

    alive_n = alive & ~stopped
    record_pending_n = record_pending | record

    ii, jj, _, _ = geometry.x_to_ij_c(
        xn[1], xn[2], mc.x_start, mc.dx, (mc.n1, mc.n2))
    z = (ii * mc.n2 + jj).astype(jnp.int32)

    return dict(
        x=xn, k=kn, dkdlam=dkn, e_0_s=e0sn, dl_shrink=dl_shrink_n,
        pend_dl=pend_rem, pend_push=pend_push_n, at_event=at_event_n,
        alive=alive_n, w=w_n, record_pending=record_pending_n,
        seg=seg, commit=commit, moving=moving, was_pend=was_pend,
        arrived=arrived, stopped=stopped, z=z,
        # Whether this step ran GROWN (input dl_shrink above nominal) —
        # phase B's vacuum->matter entry rollback needs it (see tau_cap).
        grown=~pend_push & (dl_shrink > 1.0),
    )


def hot_phase_b(rows, x, k, dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi,
                tau_abs, tau_scatt, interacting, pend_dl, pend_push, sec_w,
                n_step, alive,
                x_pre, k_pre, dk_pre, e0s_pre,
                seg, commit, moving, was_pend, stopped, u_x1, bias_scale,
                mc, hc_coeffs, k2_coeffs, weight_min, stall_steps,
                derived=False, tau_cap=0.0, grown=None):
    """Post-gather half of the hot iteration (harm_model.cpp:937-1056).

    ``rows``: the gathered bilinear corner rows at the new position — a
    32-tuple of (N,) component vectors (the production layout, see
    ``EngineConfig.col_gather``) or an (N, 32) array;
    ``x_pre``/... : the pre-step state for scatter rollback; ``u_x1``:
    (N,) uniforms for the optical-depth draw; ``bias_scale``: the
    counters-derived scalar 100/(bias_norm * max_tau_scatt * (avg+2)).

    Pure and elementwise given the gathered rows.  Returns a dict of the
    final field values.

    The interaction gate is per-step (landing-position fluid state), NOT
    the carried ``interacting`` flag: the reference re-evaluates
    ``n_e > 0`` at every step (harm_model.cpp:937-956), so a photon that
    leaves the torus and re-enters on a lensed orbit resumes interacting.
    The old sticky flag (cleared at the first outside step, never re-set)
    silently froze re-entrant orbiters' opacities — they accumulated no
    further tau and could never scatter again.  The flag still rides in
    the pool for the dead-branch trailing-edge bookkeeping below.
    """
    inter = moving & commit & ~was_pend & ~stopped

    # Bilinear fluid blend (fluid.get_fluid_params_c without the gather).
    # ``rows``: a C-tuple of (N,) columns (the shipped mxu_extract layout)
    # or an (..., C) array.
    col = (rows.__getitem__ if isinstance(rows, tuple)
           else lambda m: rows[..., m])
    x1, x2 = x[1], x[2]
    inside = (
        (x1 >= mc.x_start[1]) & (x1 <= mc.x_stop[1])
        & (x2 >= mc.x_start[2]) & (x2 <= mc.x_stop[2])
    )
    _, _, del_i, del_j = geometry.x_to_ij_c(
        x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
    c00 = (1.0 - del_i) * (1.0 - del_j)
    c01 = (1.0 - del_i) * del_j
    c10 = del_i * (1.0 - del_j)
    c11 = del_i * del_j
    nc = 11 if derived else 8
    pr = [
        col(m) * c00 + col(nc + m) * c01
        + col(2 * nc + m) * c10 + col(3 * nc + m) * c11
        for m in range(nc)
    ]
    if derived:
        # Corner rows carry the derived state (EngineConfig.derived_fluid /
        # fluid.make_derived_corner_table): no metric pair, no u0/b^mu
        # reconstruction per step.  Row layout: [0]=n_e, [1]=theta_e*n_e —
        # theta_e comes out as a ratio of blends, matching the reference's
        # uu/rho ratio of interpolated primitives exactly (blending
        # theta_e directly inflates it at the torus edge and, via
        # bias ~ theta_e^2, tripled the scattering load).
        n_e = jnp.where(inside, pr[0], 0.0)
        theta_e = pr[1] / pr[0]
        b_mag = pr[2]
        u_cov = (pr[3], pr[4], pr[5], pr[6])
        b_cov = (pr[7], pr[8], pr[9], pr[10])
    else:
        rho, uu = pr[0], pr[1]
        n_e = jnp.where(inside, rho * mc.n_e_unit, 0.0)
        theta_e = uu / rho * mc.theta_e_unit
        g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
        gc6 = geometry.gcon_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
        _, u_cov, _, b_cov, b_mag = fluid._four_vectors_c(
            pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], g7, gc6, mc)

    bound = n_e == 0.0
    sin_th, nu = radiation.kinematics_sin_c(k, u_cov, b_cov, b_mag, mc.b_unit)
    nu_safe = jnp.abs(nu) + consts.EPS
    a_scf = radiation.alpha_inv_scatt_c(nu_safe, theta_e, n_e, hc_coeffs)
    # Hotcross clamp census: lanes whose sigma input left the table domain
    # (where the reference re-runs the numeric integral; the surrogate
    # clamps — ops/hotcross.clamp_hit).  Masked to lanes whose opacity
    # value actually enters the transport below.
    from grmonty.ops import hotcross as _hc

    e_gamma = consts.HPL * nu_safe / (consts.ME * consts.CL * consts.CL)
    hc_hit = _hc.clamp_hit(e_gamma, theta_e) & (n_e > 0.0)
    a_abf = radiation.alpha_inv_abs_sin_c(nu_safe, theta_e, n_e, b_mag,
                                          sin_th, k2_coeffs)
    # Scattering bias (harm_model.cpp:1391-1404) from the scalar factor.
    cap = 0.5 * w / weight_min
    bf = jnp.minimum(
        jnp.maximum(bias_scale * theta_e * theta_e, consts.TP_OVER_TE), cap
    ) / consts.TP_OVER_TE

    dead_branch = bound | (nu < 0.0)

    # Vacuum->matter ENTRY rollback for grown steps (EngineConfig
    # .grow_tau_cap rationale): a lane flying with zero opacities whose
    # GROWN (up to grow_cap x nominal) step lands inside the torus gets
    # its optical depth from the trapezoid (0 + alpha_landing)/2 * seg —
    # overestimating the true path contribution by up to the growth
    # factor, since only the tail of the stride was in matter.  These
    # inflated depths ratchet the global max_tau_scatt (the bias
    # normalization) through rare recorded deep photons: measured at
    # M=4e19, engine max_tau 0.019 vs a seed-stable oracle 0.0024, which
    # halves the recorded-secondary population.  Entry steps are RARE per
    # lane lifetime, so the committed stride is simply rolled back and
    # retried at nominal size next iteration (phase A's reference-size
    # trapezoid then bounds the entry error exactly as the reference's
    # own does); in-matter growth stays bounded by the a-priori cap with
    # a valid (nonzero) start-of-step alpha.
    entry_roll = jnp.zeros_like(inter)
    if tau_cap > 0.0 and grown is not None:
        entry_roll = (inter & grown & ~dead_branch
                      & (alpha_scatti <= 0.0) & (alpha_absi <= 0.0)
                      & (n_e > 0.0))
        inter = inter & ~entry_roll

    half = 0.5 * mc.d_tau_k * seg
    d_tau_scatt = jnp.where(
        dead_branch, alpha_scatti * half, (alpha_scatti + a_scf) * half)
    d_tau_abs = jnp.where(
        dead_branch, alpha_absi * half, (alpha_absi + a_abf) * half)
    bias = jnp.where(dead_branch, 0.0, 0.5 * (bi + bf))

    alpha_scatti_n = jnp.where(
        inter, jnp.where(dead_branch, 0.0, a_scf), alpha_scatti)
    alpha_absi_n = jnp.where(
        inter, jnp.where(dead_branch, 0.0, a_abf), alpha_absi)
    bi_n = jnp.where(inter, jnp.where(dead_branch, 0.0, bf), bi)

    x1r = -jnp.log(u_x1 + 1e-30)
    sec_w_new = w / jnp.maximum(bias, consts.EPS)
    scatter = inter & (bias * d_tau_scatt > x1r) & (sec_w_new > weight_min)

    frac = jnp.where(scatter, x1r / (bias * d_tau_scatt + consts.EPS), 1.0)
    d_tau_abs_eff = d_tau_abs * frac
    d_tau_scatt_eff = d_tau_scatt * frac

    absorbed = inter & (d_tau_abs_eff > 100.0)

    d_tau = d_tau_abs_eff + d_tau_scatt_eff
    decay_taylor = 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)))
    decay = jnp.where(d_tau < 1.0e-3, decay_taylor,
                      jnp.exp(-jnp.minimum(d_tau, 200.0)))
    w_n = jnp.where(inter & ~absorbed, w * decay, w)

    roll = scatter & ~absorbed
    roll_any = roll | entry_roll  # both restore the pre-step state
    x_n = tuple(jnp.where(roll_any, xp, xc) for xp, xc in zip(x_pre, x))
    k_n = tuple(jnp.where(roll_any, kp, kc) for kp, kc in zip(k_pre, k))
    dk_n = tuple(jnp.where(roll_any, dp, dc)
                 for dp, dc in zip(dk_pre, dkdlam))
    e0s_n = jnp.where(roll_any, e0s_pre, e_0_s)

    n_step_n = n_step + moving.astype(jnp.int32)
    over = moving & (n_step_n > stall_steps)

    # A-posteriori growth revocation (EngineConfig.grow_tau_cap): the
    # a-priori cap in hot_phase_a bounds the step by the START-of-step
    # opacity, which a lane ENTERING the torus from vacuum sees as ~0 —
    # its grown (up to grow_cap x) step then crosses the dense edge in one
    # stride where the trapezoid overestimates the optical depth (measured
    # at M=4e18: an orbiter recorded tau_scatt 26x the oracle's maximum,
    # which ratchets max_tau_scatt and crushes the global bias; rec_ratio
    # 0.53).  A lane whose REALIZED step depth exceeded the cap loses its
    # growth immediately, so edge-crossers and core orbiters integrate at
    # nominal (reference-size) steps while vacuum flight stays grown.
    tau_over = (inter & (jnp.maximum(d_tau_scatt, d_tau_abs) > tau_cap)
                if tau_cap > 0.0 else jnp.zeros_like(inter))

    return dict(
        tau_over=tau_over,
        entry_roll=entry_roll,
        x=x_n, k=k_n, dkdlam=dk_n, e_0_s=e0s_n,
        pend_dl=jnp.where(roll, seg * frac, pend_dl),
        sec_w=jnp.where(roll, sec_w_new, sec_w),
        pend_push=pend_push | roll,
        w=w_n,
        tau_abs=jnp.where(inter & ~absorbed, tau_abs + d_tau_abs_eff, tau_abs),
        tau_scatt=jnp.where(inter & ~absorbed, tau_scatt + d_tau_scatt_eff,
                            tau_scatt),
        alpha_scatti=alpha_scatti_n,
        alpha_absi=alpha_absi_n,
        bi=bi_n,
        interacting=(
            inter & ((alpha_scatti_n > 0.0) | (alpha_absi_n > 0.0)
                     | (n_e > 0.0))
        ) | (~inter & interacting),
        alive=alive & ~absorbed & ~over,
        n_step=n_step_n,
        # Raw per-lane refresh values at the NEW position, for the
        # detached-events capture (the parent's post-event opacity refresh,
        # harm_model.cpp:1026-1039, evaluated here where the corner rows
        # for the arrival point are already in hand).  Dead outputs
        # otherwise (DCE'd by XLA).
        a_scf=a_scf, a_abf=a_abf, bf=bf, nu=nu, n_e=n_e,
        hc_clamp=hc_hit & inter,
    )


class EngineTables(typing.NamedTuple):
    """Device-resident per-dump tables shared by every engine instance.

    A production run builds 4-6 engines (main + pilot + tail cascade);
    building these tables inside each make_engine would copy ~28 MB of
    device arrays to the device per engine.  The driver builds them once
    and passes
    ``prebuilt=``; engines differing only in scheduling knobs (pool width,
    cadence, caps) share the same tables.
    """

    hc_coeffs: jnp.ndarray  # Chebyshev hotcross surrogate, device
    k2_coeffs: np.ndarray  # host (unrolled into the FMA chain)
    corner_rows: jnp.ndarray  # (Z, 32) packed bilinear corners, device
    corner_rowsT: jnp.ndarray | None  # transposed copy (col_gather only)
    hot_tab: jnp.ndarray  # hot-step table (derived or primitive corners)


def build_engine_tables(mc, tables: Tables, prims, cfg: EngineConfig,
                        derived_rows=None) -> EngineTables:
    """Build the device tables one make_engine needs (see EngineTables).

    ``prims`` may be host numpy (preferred: avoids a device_get) or a
    device array.  The tables depend only on (dump, dtype,
    derived_fluid/col_gather flags) — engines differing in scheduling
    knobs share them.
    """
    dt = cfg.dtype
    hc_coeffs = jnp.asarray(cheb.fit_hotcross(np.asarray(tables.hotcross)),
                            dt)
    k2_coeffs = np.asarray(cheb.fit_k2())
    corner_np = fluid.make_corner_table(np.asarray(prims), mc.n1, mc.n2)
    corner_rows = jnp.asarray(corner_np, dt)
    # Transposed copy only when the col_gather A/B knob wants it (8 MB
    # otherwise wasted on a default-off path).
    corner_rowsT = (jnp.asarray(np.ascontiguousarray(corner_np.T), dt)
                    if cfg.col_gather else None)
    # Hot-step table: the derived-fluid rows replace the primitive corners
    # in the hot iteration only; the periodic-phase physics (scatter
    # kinematics, init) keeps the exact primitive path.
    if cfg.derived_fluid:
        if derived_rows is None:  # standalone fallback (tests); the driver
            # passes the rows packed from its cached zone-state products
            derived_rows = fluid.make_derived_corner_table(
                np.asarray(prims), mc)
        hot_tab = jnp.asarray(derived_rows, dt)
    else:
        hot_tab = corner_rows
    return EngineTables(hc_coeffs, k2_coeffs, corner_rows, corner_rowsT,
                        hot_tab)


def make_engine(mc: fluid.ModelConsts, tables: Tables, prims, cfg: EngineConfig,
                geom_rows=None, derived_rows=None, prebuilt=None):
    """Build the jitted transport step functions for one dump.

    ``prims``: (8, n1, n2) primitives on device.  ``geom_rows``: the
    (n1*n2, 459) stencil-packed geometry table (:func:`fluid.pack_geom9`
    over :func:`fluid.make_geom_table`), required when ``cfg.interp_geom``.
    Returns a dict of functions;
    ``run(state, backlog_rows)`` drives the while_loop until the iteration
    budget or completion.  ``backlog_rows``: (T, 16) packed rows
    (see :func:`pack_rows`).
    """
    dt = cfg.dtype
    if cfg.interp_geom and geom_rows is None:
        raise ValueError("interp_geom engine needs the fluid.make_geom_table rows")
    if cfg.interp_geom:
        geom_rows = jnp.asarray(geom_rows, dt)
    dbg = frozenset(s for s in cfg.dbg_skip.split(",") if s)
    a, hs, r0 = mc.a, mc.h_slope, mc.r_0
    x2_stop = mc.x_stop[2]
    d_tau_k = mc.d_tau_k
    weight_min = consts.WEIGHT_MIN * cfg.weight_scale

    if prebuilt is None:
        prebuilt = build_engine_tables(mc, tables, prims, cfg,
                                       derived_rows=derived_rows)
    hc_coeffs = prebuilt.hc_coeffs
    k2_coeffs = prebuilt.k2_coeffs
    corner_rows = prebuilt.corner_rows
    corner_rowsT = prebuilt.corner_rowsT
    if cfg.col_gather and corner_rowsT is None:
        corner_rowsT = jnp.asarray(corner_rows).T  # prebuilt lacked it
    hot_tab = prebuilt.hot_tab
    if cfg.derived_fluid and (cfg.col_gather or cfg.interp_geom
                              or cfg.fluid_cache or dbg):
        raise ValueError("derived_fluid supports only the shared XLA "
                         "hot path")
    hot_w = int(hot_tab.shape[1])

    # ------------------------------------------------------------------
    # physics helpers (component layer)
    # ------------------------------------------------------------------
    def x_comps(x):
        return (x[0], x[1], x[2], x[3])

    def _raw_gather(z, tab=None):
        """``tab[z]`` (default: the hot-step table) issued as
        ``cfg.gather_split`` independent sub-gathers over contiguous index
        slices (EngineConfig.gather_split); the concatenation restores the
        exact single-gather result."""
        if tab is None:
            tab = hot_tab
        s = max(1, int(cfg.gather_split))
        n = z.shape[0]
        if s == 1 or n % s:
            return tab[z]
        h = n // s
        return jnp.concatenate(
            [tab[z[c * h:(c + 1) * h]] for c in range(s)], axis=0)

    def eval_fluid_xy(x1, x2):
        """FluidC + metric tuple at arbitrary positions (one row gather)."""
        g7 = geometry.gcov_c(x1, x2, a, hs, r0)
        fl = fluid.get_fluid_params_c(x1, x2, corner_rows, mc, g7=g7,
                                      mxu=cfg.mxu_extract)
        return g7, fl

    def eval_fluid(p: Pool):
        """FluidC + metric tuple at the pool positions (the hot-step gather)."""
        return eval_fluid_xy(p.x[1], p.x[2])

    def eval_fluid_hot(x1, x2):
        """FluidC via the HOT-path table (derived rows when enabled) — for
        consumers needing only (n_e, theta_e, b, u_cov, b_cov), e.g. the
        fresh-lane opacity init: skips the per-lane metric pair and
        four-vector reconstruction entirely."""
        if not cfg.derived_fluid:
            _, fl = eval_fluid_xy(x1, x2)
            return fl
        ii, jj, di, dj = geometry.x_to_ij_c(
            x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
        z = (ii * mc.n2 + jj).astype(jnp.int32)
        rows = hot_tab[z]
        rt = fluid.onehot_transpose(rows)
        c00 = (1.0 - di) * (1.0 - dj)
        c01 = (1.0 - di) * dj
        c10 = di * (1.0 - dj)
        c11 = di * dj
        pr = [rt[m] * c00 + rt[11 + m] * c01 + rt[22 + m] * c10
              + rt[33 + m] * c11 for m in range(11)]
        inside = (
            (x1 >= mc.x_start[1]) & (x1 <= mc.x_stop[1])
            & (x2 >= mc.x_start[2]) & (x2 <= mc.x_stop[2])
        )
        return fluid.FluidC(
            n_e=jnp.where(inside, pr[0], 0.0), theta_e=pr[1] / pr[0],
            b=pr[2], u_con=None, u_cov=(pr[3], pr[4], pr[5], pr[6]),
            b_con=None, b_cov=(pr[7], pr[8], pr[9], pr[10]),
        )

    def eval_alphas(k, fl):
        """(sin theta, nu, alpha_scatt, alpha_abs) from component tuples.

        Uses the sin-angle kinematics (radiation.kinematics_sin_c): the
        synchrotron emissivity only needs sin(pitch angle), so the
        arccos+sin pair collapses to a sqrt."""
        sin_th, nu = radiation.kinematics_sin_c(
            k, fl.u_cov, fl.b_cov, fl.b, mc.b_unit)
        nu_safe = jnp.abs(nu) + consts.EPS
        a_sc = radiation.alpha_inv_scatt_c(nu_safe, fl.theta_e, fl.n_e, hc_coeffs)
        a_ab = radiation.alpha_inv_abs_sin_c(nu_safe, fl.theta_e, fl.n_e, fl.b,
                                             sin_th, k2_coeffs)
        return sin_th, nu, a_sc, a_ab

    def _avg_scatt(counters):
        """avg scatters per recorded photon, for the bias feedback: the
        reference's cumulative ratio, or the windowed EMA
        (EngineConfig.bias_ema)."""
        if cfg.bias_ema > 0.0:
            return counters.avg_ema
        return counters.n_scatt_rec.astype(dt) / (
            counters.n_recorded.astype(dt) + 1.0
        )

    def _bias_denom(counters):
        """max_tau * (avg_scatt + 2), or the frozen constants
        (EngineConfig.bias_fixed_tau — validation comparison mode)."""
        if cfg.bias_fixed_tau > 0.0:
            return cfg.bias_fixed_tau * (cfg.bias_fixed_avg + 2.0)
        return counters.max_tau_scatt * (_avg_scatt(counters) + 2.0)

    def bias_func(theta_e, w, counters):
        """Scattering bias (harm_model.cpp:1391-1404) from loop-carried counters."""
        cap = 0.5 * w / weight_min
        bias = (
            100.0
            * theta_e
            * theta_e
            / (mc.bias_norm * _bias_denom(counters))
        )
        # Clamp order verified against harm_model.cpp:1396-1401: the
        # reference floors to tp_over_te first, then caps to 0.5*w/w_min,
        # so the cap wins when cap < floor — identical to max-then-min here.
        bias = jnp.maximum(bias, consts.TP_OVER_TE)
        bias = jnp.minimum(bias, cap)
        return bias / consts.TP_OVER_TE

    # ------------------------------------------------------------------
    # geodesic push: one full step with a bounded halving stack per lane
    # (harm_model.cpp:1217-1289; iterative form super_photon.cu:1826-1929)
    #
    # interp_geom mode: each segment round does ONE bilinear row gather at
    # the predicted end position; the gathered row carries the connection,
    # the energy-check metric row AND the derived fluid state, so the whole
    # hot iteration has no closed-form geometry and no second gather.  The
    # fluid state at the finally-committed position rides out of the loop
    # as an 11-component carry for the interaction phase.
    # ------------------------------------------------------------------
    def blend_geom(x1n, x2n):
        """(conn40, fl11) stencil-blended at (x1n, x2n)."""
        conn, flu, inside = fluid.blend_geom_rows(geom_rows, x1n, x2n, mc)
        flc = fluid.FluidC(
            n_e=jnp.where(inside, flu[0], 0.0),
            theta_e=flu[1],
            b=flu[2],
            u_con=None,  # not needed in the hot loop
            u_cov=(flu[3], flu[4], flu[5], flu[6]),
            b_con=None,
            b_cov=(flu[7], flu[8], flu[9], flu[10]),
        )
        return tuple(conn[m] for m in range(40)), flc

    def _zero_flc(n):
        z = lambda: jnp.zeros((n,), dt)
        return fluid.FluidC(n_e=z(), theta_e=z(), b=z(), u_con=None,
                            u_cov=(z(), z(), z(), z()), b_con=None,
                            b_cov=(z(), z(), z(), z()))

    def _flc_where(m, new, old):
        pick = lambda a, b: jnp.where(m, a, b)
        return fluid.FluidC(
            n_e=pick(new.n_e, old.n_e), theta_e=pick(new.theta_e, old.theta_e),
            b=pick(new.b, old.b), u_con=None,
            u_cov=tuple(pick(a, b) for a, b in zip(new.u_cov, old.u_cov)),
            b_con=None,
            b_cov=tuple(pick(a, b) for a, b in zip(new.b_cov, old.b_cov)),
        )

    SHRINK_FLOOR = float(2.0 ** (-consts.MAX_HALVING_DEPTH))

    def push_once(x, k, dkdlam, e_0_s, seg_dl, active, at_floor):
        """ONE implicit-midpoint attempt over ``seg_dl`` per lane.

        Lockstep redesign of the reference's recursive step halving
        (harm_model.cpp:1217-1289): instead of an inner subdivision loop —
        whose round count is a batch *max*, so one misbehaving lane out of
        65k forces full-width geometry rounds on everyone — each lane makes
        exactly one attempt per hot iteration.  A lane whose error test
        fails simply does not advance this iteration; its persistent
        ``dl_shrink`` halves and it retries next iteration (the accepted
        sub-segment sequence is a valid adaptive discretisation of the same
        geodesic, guarded by the same two error tests).  At the shrink
        floor (2^-MAX_HALVING_DEPTH) the attempt commits unconditionally,
        exactly like the reference at its recursion-depth cap.

        Returns (x, k, dk, e0s, commit, flc).
        """
        if not cfg.interp_geom:
            x, k, dk, e0s, commit, _err = push_attempt_c(
                x, k, dkdlam, e_0_s, seg_dl, active, at_floor,
                a, hs, r0, cfg.fp_iters, cfg.ref_err_metric,
            )
            return x, k, dk, e0s, commit, _zero_flc(e_0_s.shape[0])

        dl_2 = 0.5 * seg_dl
        # half-step predictor (harm_model.cpp:1233-1238)
        k_half = tuple(kk + dd * dl_2 for kk, dd in zip(k, dkdlam))
        k_pred = tuple(kh + dd * dl_2 for kh, dd in zip(k_half, dkdlam))
        x_new = tuple(xx + kh * seg_dl for xx, kh in zip(x, k_half))

        conn, fl_new = blend_geom(x_new[1], x_new[2])
        # The conserved-energy row stays analytic even in interp_geom mode:
        # e_0_s is a running conservation ledger, and bilinear noise in g_0mu
        # would random-walk it across thousands of steps (and trip the
        # halving test).  Three transcendentals per iteration buy an exact
        # ledger; the trajectory itself only feels the (second-order) conn
        # interpolation error.
        row0 = geometry.gcov_row0_c(x_new[1], x_new[2], a, hs, r0)

        # Fixed-point iterations, unrolled.
        err = jnp.zeros_like(e_0_s)
        dk_new = dkdlam
        for _ in range(cfg.fp_iters):
            dk_new = geometry.geodesic_rhs_c(conn, *k_pred)
            k_next = tuple(kh + dl_2 * dd for kh, dd in zip(k_half, dk_new))
            if cfg.ref_err_metric:
                err = sum(
                    jnp.abs((kp - kn) / (kn + consts.EPS))
                    for kp, kn in zip(k_pred, k_next)
                )
            else:
                kscale = sum(jnp.abs(kn) for kn in k_next) + consts.EPS
                err = sum(
                    jnp.abs(kp - kn) for kp, kn in zip(k_pred, k_next)
                ) / kscale
            k_pred = k_next
        k_new = k_pred

        g00, g01, g03 = row0
        e_1 = -(k_new[0] * g00 + k_new[1] * g01 + k_new[3] * g03)
        err_e = jnp.abs((e_1 - e_0_s) / (e_0_s + consts.EPS))

        bad = (err_e > consts.E_DRIFT_TOL) | (err > consts.E_TOL) | ~jnp.isfinite(err)
        commit = active & (~bad | at_floor)

        x = tuple(jnp.where(commit, xn, xx) for xn, xx in zip(x_new, x))
        k = tuple(jnp.where(commit, kn, kk) for kn, kk in zip(k_new, k))
        dk = tuple(jnp.where(commit, dn, dd) for dn, dd in zip(dk_new, dkdlam))
        e0s = jnp.where(commit, e_1, e_0_s)
        return x, k, dk, e0s, commit, fl_new

    def push_batch(x, k, dkdlam, e_0_s, dl, active, n_iter=8):
        """Array-facade push for tests/oracle parity: (N, 4) in/out.

        Drives :func:`push_once` with the per-lane retry policy until every
        active lane has advanced its full ``dl`` (or the attempt budget is
        spent), reproducing the committed trajectory of one reference-style
        adaptively-halved step."""
        xc = tuple(x[:, i] for i in range(4))
        kc = tuple(k[:, i] for i in range(4))
        dkc = tuple(dkdlam[:, i] for i in range(4))
        frozen = xc[1] < mc.x_start[1]
        remaining = jnp.where(active & ~frozen, dl, 0.0)
        shrink = jnp.ones_like(dl)
        e0s = e_0_s
        failed = jnp.zeros_like(active)

        def body(i, s):
            xc, kc, dkc, e0s, remaining, shrink, failed = s
            act = remaining > 0.0
            seg = remaining * shrink
            at_floor = shrink <= SHRINK_FLOOR
            xc, kc, dkc, e0s, commit, _ = push_once(
                xc, kc, dkc, e0s, seg, act, at_floor
            )
            remaining = jnp.where(commit, remaining - seg, remaining)
            shrink = jnp.where(
                act & ~commit, jnp.maximum(shrink * 0.5, SHRINK_FLOOR),
                jnp.minimum(shrink * 2.0, 1.0),
            )
            failed = failed | (act & ~commit)
            return xc, kc, dkc, e0s, remaining, shrink, failed

        xc, kc, dkc, e0s, remaining, _, failed = lax.fori_loop(
            0, n_iter, body, (xc, kc, dkc, e0s, remaining, shrink, failed)
        )
        return (jnp.stack(xc, axis=-1), jnp.stack(kc, axis=-1),
                jnp.stack(dkc, axis=-1), e0s, failed & (remaining > 0.0))

    # ------------------------------------------------------------------
    # stop / record criteria (harm_model.cpp:1589-1618)
    # ------------------------------------------------------------------
    def stop_and_roulette(key, p: Pool, mask):
        """Apply the stop criterion with Russian roulette to masked lanes.

        Returns (new w, stopped, record) — stopped lanes leave the hot loop;
        record lanes escaped through r_max (recorded even at w == 0).
        """
        u = random.uniform(key, p.w.shape, dt)
        horizon = p.x[1] < mc.x1_min
        escaped = p.x[1] > consts.X1_MAX
        small = p.w < weight_min

        win = u <= (1.0 / consts.ROULETTE)
        w_roul = jnp.where(win, p.w * consts.ROULETTE, 0.0)
        w = jnp.where(mask & small & ~horizon, w_roul, p.w)

        killed_inside = mask & small & ~horizon & ~escaped & ~win
        stopped = mask & (horizon | escaped | killed_inside)
        record = mask & escaped & ~horizon
        return w, stopped, record

    # ------------------------------------------------------------------
    # the hot iteration
    # ------------------------------------------------------------------
    # The default configuration (analytic geometry, no fluid cache, no dbg
    # stubs) runs through the module-level hot_phase_a/b pair.  Optioned
    # configs take the legacy inline path.
    _shared_hot = not cfg.interp_geom and not cfg.fluid_cache and not dbg

    def _bias_scale(counters):
        # jnp-wrap: in frozen-bias mode the denominator is a Python float
        return jnp.asarray(100.0 / (mc.bias_norm * _bias_denom(counters)))

    # For the f32 engine, trace the shared phases with x64 disabled so
    # python-float literals bind as f32 and no f64 arithmetic creeps into
    # the f32 hot loop; the f64 engine keeps x64 semantics.
    import contextlib

    def _phase_ctx():
        return (jax.enable_x64(False) if dt == jnp.float32
                else contextlib.nullcontext())

    # Lane-axis fields the hot part-chains read — an explicit whitelist,
    # NOT trailing-dim matching: a non-lane leaf whose width happens to
    # equal n_pool (e.g. event-queue capacity) must never be part-sliced.
    _HOT_FIELDS = ("x", "k", "dkdlam", "w", "e_0_s", "dl_shrink", "pend_dl",
                   "pend_push", "at_event", "alive", "record_pending",
                   "alpha_scatti", "alpha_absi", "bi", "interacting",
                   "sec_w", "tau_abs", "tau_scatt", "n_step")

    def _slice_pool(p, sl):
        """Slice the hot-phase lane-axis pool fields; leave the rest."""
        f = lambda a: a[..., sl] if hasattr(a, "ndim") and a.ndim else a
        return p._replace(**{
            name: jax.tree.map(f, getattr(p, name)) for name in _HOT_FIELDS
        })

    def _cat_dicts(ds):
        """Concatenate a list of phase-output dicts along the lane axis."""
        out = {}
        for k, v0 in ds[0].items():
            if isinstance(v0, tuple):
                out[k] = tuple(
                    jnp.concatenate([d[k][i] for d in ds])
                    for i in range(len(v0)))
            else:
                out[k] = jnp.concatenate([d[k] for d in ds])
        return out

    def _hot_part(q, u_roul, u_x1, bias_s):
        """One a -> gather -> b chain over a pool part ``q``.

        With EngineConfig.hot_halves > 1 the pool runs as independent
        part-chains, so XLA may overlap one part's corner gather with
        another part's arithmetic.  Exact: the same per-lane math on the
        same uniforms, concatenated in order.
        """
        with _phase_ctx():
            A = hot_phase_a(
                x_comps(q.x), x_comps(q.k), x_comps(q.dkdlam), q.e_0_s,
                q.dl_shrink, q.pend_dl, q.pend_push, q.at_event, q.alive,
                q.w, q.record_pending, u_roul,
                mc, cfg.fp_iters, weight_min, SHRINK_FLOOR, cfg.ref_err_metric,
                cfg.grow_cap, cfg.grow_rate, cfg.grow_tau_cap,
                q.alpha_scatti, q.bi, cfg.step_ctrl,
            )
        if cfg.col_gather:
            # Transposed-table gather: (32, N) with lanes along the pool
            # axis, handed to phase_b as 32 per-component vectors (see
            # EngineConfig.col_gather for the measured layout rationale).
            rt = jnp.take(corner_rowsT, A["z"], axis=1)
            rows = tuple(rt[m] for m in range(corner_rowsT.shape[0]))
        elif cfg.mxu_extract:
            raw = _raw_gather(A["z"])
            rt = fluid.onehot_transpose(raw)  # (W, N), exact
            rows = tuple(rt[m] for m in range(hot_w))
        else:
            rows = _raw_gather(A["z"])
        with _phase_ctx():
            B = hot_phase_b(
                rows, A["x"], A["k"], A["dkdlam"], A["e_0_s"], A["w"],
                q.alpha_scatti, q.alpha_absi, q.bi, q.tau_abs, q.tau_scatt,
                q.interacting, A["pend_dl"], A["pend_push"], q.sec_w, q.n_step,
                A["alive"],
                x_comps(q.x), x_comps(q.k), x_comps(q.dkdlam), q.e_0_s,
                A["seg"], A["commit"], A["moving"], A["was_pend"], A["stopped"],
                u_x1, bias_s,
                mc, hc_coeffs, k2_coeffs, weight_min, cfg.stall_steps,
                derived=cfg.derived_fluid,
                tau_cap=(cfg.grow_tau_cap if cfg.grow_cap > 1.0 else 0.0),
                grown=A["grown"],
            )
        return A, B

    def hot_step_shared(state: State) -> State:
        p = state.pool
        key, k_roul2, k_x1 = random.split(state.key, 3)
        u_roul = random.uniform(k_roul2, p.w.shape, dt)
        u_x1 = random.uniform(k_x1, p.w.shape, dt)
        bias_s = _bias_scale(state.counters).astype(dt)

        hn = max(1, cfg.hot_halves)
        if hn > 1 and cfg.n_pool % hn != 0:
            # the contract is "must divide n_pool" — fail loudly instead of
            # silently running serial
            raise ValueError(
                f"EngineConfig.hot_halves={hn} must divide n_pool={cfg.n_pool}")
        if hn > 1:
            hsz = cfg.n_pool // hn
            parts = [
                _hot_part(_slice_pool(p, slice(i * hsz, (i + 1) * hsz)),
                          u_roul[i * hsz:(i + 1) * hsz],
                          u_x1[i * hsz:(i + 1) * hsz], bias_s)
                for i in range(hn)
            ]
            A = _cat_dicts([a for a, _ in parts])
            B = _cat_dicts([b for _, b in parts])
        else:
            A, B = _hot_part(p, u_roul, u_x1, bias_s)
        dl_shrink_n = A["dl_shrink"]
        if cfg.grow_cap > 1.0 and cfg.grow_tau_cap > 0.0:
            dl_shrink_n = jnp.where(B["tau_over"] | B["entry_roll"],
                                    jnp.minimum(dl_shrink_n, 1.0),
                                    dl_shrink_n)
        p = p._replace(
            x=B["x"], k=B["k"],
            dkdlam=B["dkdlam"], e_0_s=B["e_0_s"],
            dl_shrink=dl_shrink_n, pend_dl=B["pend_dl"],
            pend_push=B["pend_push"], at_event=A["at_event"], w=B["w"],
            alive=B["alive"], record_pending=A["record_pending"],
            tau_abs=B["tau_abs"], tau_scatt=B["tau_scatt"],
            alpha_scatti=B["alpha_scatti"], alpha_absi=B["alpha_absi"],
            bi=B["bi"], interacting=B["interacting"], sec_w=B["sec_w"],
            n_step=B["n_step"],
        )
        if cfg.detached_events:
            with _phase_ctx():
                p = p._replace(**_capture_events(
                    state.pool, A["arrived"], A["at_event"], B["x"], B["k"],
                    B["w"], B["sec_w"], B["alive"],
                    B["alpha_scatti"], B["alpha_absi"], B["bi"],
                    B["a_scf"], B["a_abf"], B["bf"], B["nu"],
                ))
        counters = _util_counters(state.counters, p.occupied, A["moving"],
                                  A["commit"], p.at_event)
        counters = counters._replace(
            n_hc_clamp=counters.n_hc_clamp
            + jnp.sum(B["hc_clamp"]).astype(jnp.int64))
        return state._replace(pool=p, counters=counters, key=key,
                              it=state.it + 1)

    def hot_step(state: State) -> State:
        if _shared_hot:
            return hot_step_shared(state)
        return hot_step_legacy(state)

    def hot_step_legacy(state: State) -> State:
        p = state.pool
        key, k_roul2, k_x1 = random.split(state.key, 3)

        moving = p.alive & ~p.at_event

        # Save pre-step state for scatter rollback.
        x_pre, k_pre, dk_pre, e0s_pre = p.x, p.k, p.dkdlam, p.e_0_s

        dl_full = jnp.where(
            p.pend_push,
            p.pend_dl,
            geometry.step_size_c(p.x[1], p.x[2], p.k[1], p.k[2], p.k[3], x2_stop),
        )
        seg = dl_full * p.dl_shrink
        grown_leg = ~p.pend_push & (p.dl_shrink > 1.0)
        # grow_cap > 1: never overshoot a decided scatter's re-push length
        seg = jnp.where(p.pend_push, jnp.minimum(seg, dl_full), seg)
        at_floor = p.dl_shrink <= SHRINK_FLOOR
        # The reference freezes photons with x1 < x_start1 (horizon plunge).
        act = moving & ~(p.x[1] < mc.x_start[1])

        if "push" in dbg:
            xc, kc, dkc, e0sn = x_comps(p.x), x_comps(p.k), x_comps(p.dkdlam), p.e_0_s
            commit = act
            flc = _zero_flc(p.w.shape[0])
        else:
            xc, kc, dkc, e0sn, commit, flc = push_once(
                x_comps(p.x), x_comps(p.k), x_comps(p.dkdlam), p.e_0_s,
                seg, act, at_floor,
            )
        p = p._replace(
            x=xc,
            k=kc,
            dkdlam=dkc,
            e_0_s=e0sn,
            dl_shrink=jnp.where(
                act & ~commit,
                jnp.maximum(p.dl_shrink * 0.5, SHRINK_FLOOR),
                jnp.minimum(p.dl_shrink * cfg.grow_rate, cfg.grow_cap),
            ),
        )

        # Partial re-push bookkeeping: a pend lane advances seg of its
        # remaining pend_dl; it is at the event point once nothing remains.
        was_pend = p.pend_push  # tau for the re-push segment was accounted
        # at scatter-decision time — pend lanes never re-enter interaction
        pend_rem = jnp.where(p.pend_push & commit, p.pend_dl - seg, p.pend_dl)
        arrived = moving & p.pend_push & commit & (pend_rem <= 0.0)
        p = p._replace(
            pend_dl=pend_rem,
            pend_push=p.pend_push & ~arrived,
            at_event=p.at_event | arrived,
        )

        # Stop check (harm_model.cpp:932-934).  One check per iteration,
        # post-push, for lanes that moved: the reference's top-of-loop check
        # for iteration n+1 is this iteration's post-push check; fresh lanes
        # (the only ones the reference checks pre-push) can never trip it —
        # they are inside the domain with w >> weight_min by construction.
        checkable = (moving & commit & ~arrived) | (moving & ~act)
        w, stopped, record = stop_and_roulette(k_roul2, p, checkable)
        p = p._replace(
            w=w,
            alive=p.alive & ~stopped,
            record_pending=p.record_pending | record,
        )

        # ------------------------------------------------------------------
        # interaction (harm_model.cpp:937-1056) — only lanes that advanced
        # ------------------------------------------------------------------
        # Per-step interaction gate (see hot_phase_b: the reference
        # re-evaluates n_e>0 every step; the old sticky flag froze
        # re-entrant orbiters).
        inter = moving & commit & ~was_pend & ~stopped
        if "fluid" in dbg:
            n_step = p.n_step + moving.astype(jnp.int32)
            over = moving & (n_step > cfg.stall_steps)
            p = p._replace(n_step=n_step, alive=p.alive & ~over)
            return state._replace(pool=p, key=key, it=state.it + 1)

        if cfg.interp_geom:
            fl = flc  # blended at the committed position inside the push
        elif cfg.fluid_cache:
            # Refresh the lane corner-row cache for lanes whose bilinear
            # cell changed this step (compacted — see get_fluid_params_frow).
            ii, jj, _, _ = geometry.x_to_ij_c(
                p.x[1], p.x[2], mc.x_start, mc.dx, (mc.n1, mc.n2))
            z_new = (ii * mc.n2 + jj).astype(jnp.int32)
            need = p.occupied & (z_new != p.cell)
            valid_g, gi_g, sidx_g = compact_idx(need, EV_K)
            zg = z_new[gi_g]
            rows_g = corner_rows[jnp.where(valid_g, zg, 0)]  # (EV_K, 32)
            p = p._replace(
                frow=tuple(
                    p.frow[m].at[sidx_g].set(
                        jnp.where(valid_g, rows_g[:, m], p.frow[m][gi_g]),
                        mode="drop")
                    for m in range(32)),
                cell=p.cell.at[sidx_g].set(
                    jnp.where(valid_g, zg, p.cell[gi_g]), mode="drop"),
            )
            g7h = geometry.gcov_c(p.x[1], p.x[2], a, hs, r0)
            fl = fluid.get_fluid_params_frow(p.x[1], p.x[2], p.frow, p.cell,
                                             mc, g7=g7h)
        else:
            _, fl = eval_fluid(p)
        bound = fl.n_e == 0.0
        theta, nu, a_scf, a_abf = eval_alphas(x_comps(p.k), fl)
        bf = bias_func(fl.theta_e, p.w, state.counters)

        dead_branch = bound | (nu < 0.0)
        # Vacuum->matter entry rollback for grown steps (see hot_phase_b).
        entry_roll = jnp.zeros_like(inter)
        if cfg.grow_cap > 1.0 and cfg.grow_tau_cap > 0.0:
            entry_roll = (inter & grown_leg & ~dead_branch
                          & (p.alpha_scatti <= 0.0) & (p.alpha_absi <= 0.0)
                          & (fl.n_e > 0.0))
            inter = inter & ~entry_roll
        half = 0.5 * d_tau_k * seg
        d_tau_scatt = jnp.where(
            dead_branch,
            p.alpha_scatti * half,
            (p.alpha_scatti + a_scf) * half,
        )
        d_tau_abs = jnp.where(
            dead_branch, p.alpha_absi * half, (p.alpha_absi + a_abf) * half
        )
        bias = jnp.where(dead_branch, 0.0, 0.5 * (p.bi + bf))

        alpha_scatti = jnp.where(inter, jnp.where(dead_branch, 0.0, a_scf), p.alpha_scatti)
        alpha_absi = jnp.where(inter, jnp.where(dead_branch, 0.0, a_abf), p.alpha_absi)
        bi = jnp.where(inter, jnp.where(dead_branch, 0.0, bf), p.bi)

        x1r = -jnp.log(random.uniform(k_x1, p.w.shape, dt) + 1e-30)
        sec_w = p.w / jnp.maximum(bias, consts.EPS)
        scatter = inter & (bias * d_tau_scatt > x1r) & (sec_w > weight_min)

        frac = jnp.where(scatter, x1r / (bias * d_tau_scatt + consts.EPS), 1.0)
        d_tau_abs_eff = d_tau_abs * frac
        d_tau_scatt_eff = d_tau_scatt * frac

        absorbed = inter & (d_tau_abs_eff > 100.0)  # dies unrecorded (:991-994,1041-1044)

        d_tau = d_tau_abs_eff + d_tau_scatt_eff
        decay_taylor = 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)))
        decay = jnp.where(d_tau < 1.0e-3, decay_taylor, jnp.exp(-jnp.minimum(d_tau, 200.0)))
        # (reference uses the taylor branch below dtau_abs<1e-3 on the scatter
        # path and dtau<1e-3 otherwise; the scales are equal to rounding)
        w_new = jnp.where(inter & ~absorbed, p.w * decay, p.w)

        # Scatter lanes roll back to the pre-step state and re-push by frac*dl.
        roll = scatter & ~absorbed
        roll_any = roll | entry_roll
        p = p._replace(
            x=where4(roll_any, x_pre, p.x),
            k=where4(roll_any, k_pre, p.k),
            dkdlam=where4(roll_any, dk_pre, p.dkdlam),
            e_0_s=jnp.where(roll_any, e0s_pre, p.e_0_s),
            pend_dl=jnp.where(roll, seg * frac, p.pend_dl),
            sec_w=jnp.where(roll, sec_w, p.sec_w),
            pend_push=p.pend_push | roll,
            w=w_new,
            tau_abs=jnp.where(inter & ~absorbed, p.tau_abs + d_tau_abs_eff, p.tau_abs),
            tau_scatt=jnp.where(inter & ~absorbed, p.tau_scatt + d_tau_scatt_eff, p.tau_scatt),
            alpha_scatti=alpha_scatti,
            alpha_absi=alpha_absi,
            bi=bi,
            interacting=jnp.where(
                inter, (alpha_scatti > 0.0) | (alpha_absi > 0.0) | (fl.n_e > 0.0),
                p.interacting,
            ),
            alive=p.alive & ~absorbed,
        )

        # Step count bookkeeping (consts.hpp:55; the cap is configurable —
        # the reference tolerates 1.28e6-step stragglers at scalar cost, but
        # in lockstep batches they dominate wall-clock).
        n_step = p.n_step + moving.astype(jnp.int32)
        over = moving & (n_step > cfg.stall_steps)
        p = p._replace(n_step=n_step, alive=p.alive & ~over)
        if cfg.grow_cap > 1.0 and cfg.grow_tau_cap > 0.0:
            # A-posteriori growth revocation (see hot_phase_b tau_over).
            tau_over = inter & (jnp.maximum(d_tau_scatt, d_tau_abs)
                                > cfg.grow_tau_cap)
            p = p._replace(dl_shrink=jnp.where(
                tau_over | entry_roll,
                jnp.minimum(p.dl_shrink, 1.0), p.dl_shrink))

        if cfg.detached_events:
            p = p._replace(**_capture_events(
                state.pool, arrived, p.at_event, p.x, p.k,
                p.w, p.sec_w, p.alive,
                p.alpha_scatti, p.alpha_absi, p.bi,
                a_scf, a_abf, bf, nu,
            ))
        counters = _util_counters(state.counters, p.occupied, moving, commit,
                                  p.at_event)
        return state._replace(pool=p, counters=counters, key=key,
                              it=state.it + 1)

    # ------------------------------------------------------------------
    # periodic phase: scatter events, record, refill, init
    # ------------------------------------------------------------------
    def spectrum_add(spec, counters, p: Pool, width=None):
        """Record escaped photons (harm_model.cpp:1291-1335), compacted.

        Up to ``width`` (default EV_K) pending lanes are recorded per call;
        the rest stay record_pending for the next phase (frozen,
        semantically free — see the compaction note above).  NaN-poisoned
        pending lanes are freed unrecorded (the reference's NaN
        validation, harm_model.cpp:895-900).
        """
        bad = p.record_pending & (jnp.isnan(p.w) | jnp.isnan(p.e))
        rec = p.record_pending & ~bad
        if cfg.detached_events:
            # A lane with an unconsumed event cannot be freed (its birth
            # constants feed the secondary row); it records next phase,
            # after process_scatters consumes the registers.
            rec = rec & ~p.ev_pending
        valid, gi, sidx = compact_idx(rec, EV_K if width is None else width)

        (x2g, x3g, w, e, nsc, nsc0_g, x1ig, x2ig, tabs_g, tsc_g, ne0_g,
         te0_g, b0_g, e0_g, occ_g, rp_g) = take_cols(
            gi, [p.x[2], p.x[3], p.w, p.e, p.n_scatt, p.nsc0, p.x1i, p.x2i,
                 p.tau_abs, p.tau_scatt, p.n_e_0, p.theta_e_0, p.b_0,
                 p.e_0, p.occupied, p.record_pending])

        dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
        mid = 0.5 * (mc.x_start[2] + mc.x_stop[2])
        ix2 = jnp.where(
            x2g < mid,
            jnp.floor(x2g / dx2),
            jnp.floor((mc.x_stop[2] - x2g) / dx2),
        ).astype(jnp.int32)
        l_e = jnp.log(jnp.maximum(e, 1e-30))
        i_e = (
            jnp.floor((l_e - consts.spectrum.L_E_0) / consts.spectrum.D_L_E + 2.5).astype(
                jnp.int32
            )
            - 2
        )
        in_bins = (ix2 >= 0) & (ix2 < consts.N_TH_BINS) & (i_e >= 0) & (i_e < consts.N_E_BINS)
        ok = valid & in_bins

        idx = jnp.where(ok, ix2 * consts.N_E_BINS + i_e, DUMP_BIN)
        vals = jnp.stack(
            [
                w,
                w * e,
                jnp.ones_like(w),
                nsc.astype(dt),
                w * x1ig,
                w * x2ig * x2ig,
                w * x3g * x3g,
                w * tabs_g,
                w * tsc_g,
                w * ne0_g,
                w * te0_g,
                w * b0_g,
                w * e0_g,
                jnp.square(w * e),
                # ch 14: recorded SECONDARY count (born at a scatter event;
                # see Pool.nsc0) — primary counts are bias-invariant, so
                # the split lets the accuracy harness gate the thick-regime
                # count shape quantitatively.
                (nsc0_g > 0).astype(dt),
                # ch 15: summed birth generation (kappa^g model); 0 for
                # primaries by construction.
                nsc0_g.astype(dt),
            ],
            axis=-1,
        )
        vals = jnp.where(ok[:, None], vals, 0.0)
        spec = spec.at[idx].add(vals)

        if cfg.trace_birth:
            # Deep-tau trace: when this batch advances the max_tau ratchet,
            # capture the advancing photon's BIRTH state (compared against
            # the PRE-update ratchet, mirroring the update just below).
            bcols = take_cols(gi, [*p.bx, *p.bk, p.bw])
            tvals = jnp.where(valid, tsc_g, -1.0)
            am = jnp.argmax(tvals)
            better = tvals[am] > counters.max_tau_scatt
            sel = lambda new, cur: jnp.where(better, new, cur)
            counters = counters._replace(
                mt_bx=sel(jnp.stack([bcols[i][am] for i in range(4)]),
                          counters.mt_bx),
                mt_bk=sel(jnp.stack([bcols[4 + i][am] for i in range(4)]),
                          counters.mt_bk),
                mt_bw=sel(bcols[8][am], counters.mt_bw),
                mt_nsc0=sel(nsc0_g[am].astype(jnp.int64), counters.mt_nsc0),
            )

        counters = counters._replace(
            n_recorded=counters.n_recorded + jnp.sum(ok).astype(jnp.int64),
            n_scatt_rec=counters.n_scatt_rec
            + jnp.sum(jnp.where(ok, nsc, 0)).astype(jnp.int64),
            # max over all record-criterion lanes processed this call, not
            # only in-bin ones (harm_model.cpp:1297-1299 updates before the
            # bin-range checks).
            max_tau_scatt=jnp.maximum(
                counters.max_tau_scatt,
                jnp.max(jnp.where(valid, tsc_g, 0.0)),
            ),
        )
        # Free the lanes processed this call (+ NaN-poisoned ones).
        occ_n, rp_n = put_cols(
            sidx, [(p.occupied, occ_g & ~valid),
                   (p.record_pending, rp_g & ~valid)])
        p = p._replace(
            occupied=occ_n & ~bad,
            record_pending=rp_n & ~bad,
        )
        if cfg.detached_events:
            # NaN-poisoned lanes freed above drop any pending event with
            # them (recorded lanes have ~ev_pending by construction, so
            # only the pool-wide bad mask matters here).
            p = p._replace(ev_pending=p.ev_pending & ~bad)
        return spec, counters, p

    # The periodic phase runs everything COMPACTED: each of its jobs
    # (scatter events, spectrum recording, fresh-lane init) touches only a
    # small fraction of the pool per phase, but the naive pool-wide
    # formulation made the phase cost as much as 32 hot iterations before
    # the port.  Lanes beyond a job's compaction width simply stay
    # flagged until the next phase — at_event/record_pending lanes are
    # frozen, and the refill cap below bounds fresh lanes — so compaction
    # is semantically free (the reference processes these one photon at a
    # time with the same event-time state).
    #
    # Compaction is expressed as a sort of sentinel-padded lane keys
    # (compact_idx) rather than jnp.nonzero(size=K), which failed to
    # compile at production pool sizes before the port.
    EV_K = (min(cfg.n_pool, cfg.ev_k) if cfg.ev_k
            else min(cfg.n_pool, max(256, cfg.n_pool // 8)))
    RF_K = min(cfg.n_pool, cfg.refill_k) if cfg.refill_k else EV_K

    def compact_idx(mask, k):
        """First-k lane indices where mask, ascending; k-padded.

        Returns (valid, gi, sidx): validity mask, gather indices (clamped
        for reads), scatter indices (pool-size padded for mode="drop").

        Implemented as one sort of (lane | n_pool-sentinel) keys, which
        beat a cumsum-rank + 1-D scatter formulation before the port; not
        yet measured on the H100.
        """
        lane = jax.lax.broadcasted_iota(jnp.int32, (cfg.n_pool,), 0)
        keys = jnp.where(mask, lane, cfg.n_pool)
        idx = jax.lax.sort(keys)[:k]
        valid = idx < cfg.n_pool
        gi = jnp.minimum(idx, cfg.n_pool - 1)
        sidx = jnp.where(valid, idx, cfg.n_pool)
        return valid, gi, sidx

    # ------------------------------------------------------------------
    # Packed compact-set access: instead of one 1-D gather/scatter per
    # field, pack the fields into one (N, C) matrix, move whole rows, and
    # unpack columns with the exact one-hot transpose
    # (fluid.onehot_transpose; the same trick as EngineConfig.mxu_extract).
    # Chosen before the port, where per-field gathers were latency-bound;
    # not yet measured on the H100.  Bools ride as 0/1 and
    # int32 values < 2^24 are exact in the f32 engine (all packed ints
    # here are step/try/scatter counts and cell ids, far below that).
    # ------------------------------------------------------------------

    def _unpack(mat_t, dts):
        """(C, M) matrix -> C per-field (M,) arrays with original dtypes."""
        outs = []
        for i, d in enumerate(dts):
            col = mat_t[i]
            if d == jnp.bool_:
                outs.append(col > 0.5)
            else:
                outs.append(col.astype(d))
        return outs

    def take_cols(gi, arrs):
        """[(N,)-arrays] gathered at gi via ONE packed row gather."""
        dts = [a.dtype for a in arrs]
        mat = jnp.stack([a.astype(dt) for a in arrs], axis=1)  # (N, C)
        rows = mat[gi]  # (K, C) row gather
        rt = fluid.onehot_transpose(rows)  # (C, K) exact transpose
        return _unpack(rt, dts)

    def put_cols(sidx, updates):
        """[(dst (N,), val (K,))] -> new dsts via ONE packed row scatter.

        dst[sidx[j]] = val[j]; sidx == n_pool rows drop.  The caller
        pre-blends val with the gathered current value wherever a lane
        must keep it (exactly like the old per-field put_where).
        """
        dts = [d.dtype for d, _ in updates]
        stag = jnp.stack([d.astype(dt) for d, _ in updates], axis=1)
        rows = jnp.stack([v.astype(dt) for _, v in updates], axis=1)
        stag = stag.at[sidx].set(rows, mode="drop")
        rt = fluid.onehot_transpose(stag)  # (C, N)
        return _unpack(rt, dts)

    def process_scatters(key, p: Pool, sec: SecBuf, counters):
        """Run deferred scatter events (compacted); pack secondaries.

        The rejection samplers inside the event run with small round caps
        (proba._ELECTRON_CAP_DEFER / _KN_CAP_DEFER): a lane whose samplers
        did not all accept stays at_event and retries next phase with a
        fresh key — so per-phase sampler cost is bounded with NO
        distribution truncation.  ``ev_tries`` counts the defers.

        Anti-stall escalation (EngineConfig.ev_halve / ev_force): halve
        the sampler theta_e every ev_halve defers, force-accept the final
        draw at ev_force defers.  The r1-r3 values (2 / 4, ~64 total
        rounds) were FAR too eager: in hot zones the KN-weighted electron
        sampler's acceptance is low, so a large fraction of exactly the
        events that produce the highest Compton bands sampled a halved
        (softened) theta_e or took a forced draw — measured against the
        compiled reference binary at 20k photons as a 20-46% flux deficit
        in the top energy bands (VSREF r4: bands 4/5 at 0.81/0.54 with
        the oracle at 1.02/0.79).  The reference's own anti-stall halves
        after 1e7 scalar tries (proba.cpp:59-64); the patient defaults
        (16/32 defers = 256/512 sampler rounds) keep livelock protection
        while leaving the sampled distribution effectively untouched —
        deferring costs only lane-parking (with detached_events the
        parent continues; the event waits in shadow registers).
        """
        if cfg.detached_events:
            # Two event sources, one compaction: shadow-register events
            # (parent long gone) and parked lanes (double-event fallback,
            # processed from lane state once their register event cleared).
            ev = p.ev_pending | p.at_event
        else:
            ev = p.at_event
        valid, gi, sidx = compact_idx(ev, EV_K)
        # Nursery backpressure: never sample more events than the
        # secondary ring has room for — the surplus events stay pending
        # (registers/parked) and are consumed on later phases once refill
        # drains the ring.  Physics-preserving replacement for sampling
        # and then DROPPING secondaries at the ring cap (n_sec_drop was
        # 0.25% of recorded in the storm segment without this; the
        # reference never drops — its recursion applies the same
        # backpressure through the call stack).
        #
        # Deadlock breaker (the reference's force_enqueue, utils.hpp:79-83):
        # if the ring is full AND the pool has no free lane, refill can
        # never drain the ring and event-holding lanes can never retire —
        # the run livelocks (every lane parked at_event/ev_pending, occ and
        # sec.count frozen; reproduced on the 8-shard CPU-mesh dryrun,
        # once hit an external timeout).  In that state the backpressure is lifted:
        # events consume, and overflow secondaries are dropped and counted
        # (n_sec_drop), which is exactly the pre-backpressure lossy
        # behavior — progress over purity, only in the state where the
        # pure path cannot progress at all.
        room = jnp.maximum(sec.rows.shape[0] - sec.count, 0)
        rank_e = jax.lax.broadcasted_iota(jnp.int32, (EV_K,), 0)
        wedged = (room == 0) & ~jnp.any(~p.occupied)
        valid = valid & ((rank_e < room) | wedged)

        # One packed row gather for every compact-set field (take_cols).
        base = [*p.x, *p.k, p.sec_w, p.w, p.ev_tries,
                p.n_e_0, p.theta_e_0, p.e_0, p.n_scatt,
                p.alive, p.occupied, p.at_event,
                p.alpha_scatti, p.alpha_absi, p.bi]
        if cfg.detached_events:
            cols = take_cols(gi, [p.ev_pending, *p.ev_x, *p.ev_k, p.ev_w,
                                  *base])
            (evp_g, evx0, evx1, evx2, evx3, evk0, evk1, evk2, evk3,
             evw_g) = cols[:10]
            cols = cols[10:]
        else:
            cols = take_cols(gi, base)
        (x0g, x1g, x2g, x3g, k0g, k1g, k2g, k3g, secw_g, wg, tries_g,
         ne0_g, te0_g, e0_g, nsc_g, alive_g, occ_g, atev_g,
         asc_g, aab_g, bi_g) = cols

        if cfg.detached_events:
            reg_g = evp_g & valid
            pick = lambda a, b: jnp.where(reg_g, a, b)
            xg = (pick(evx0, x0g), pick(evx1, x1g), pick(evx2, x2g),
                  pick(evx3, x3g))
            kg = (pick(evk0, k0g), pick(evk1, k1g), pick(evk2, k2g),
                  pick(evk3, k3g))
            secw_g = pick(evw_g, secw_g)
        else:
            reg_g = jnp.zeros_like(valid)
            xg = (x0g, x1g, x2g, x3g)
            kg = (k0g, k1g, k2g, k3g)
        force_g = valid & (tries_g >= cfg.ev_force)

        g7, fl = eval_fluid_xy(xg[1], xg[2])
        fl_s = fl._replace(
            theta_e=fl.theta_e
            * jnp.exp2(-(tries_g // cfg.ev_halve).astype(dt)))
        res = scattering.scatter_event_c(key, kg, fl_s, g7, mc.b_unit,
                                         active=valid, force=force_g)

        # Only lanes whose samplers all accepted consume their event;
        # the rest defer (stay at_event) and retry next phase.
        defer_g = valid & ~(res.sampled | res.parent_die)
        valid = valid & ~defer_g
        # Register-source events have no waiting parent: the parent was
        # cleared or killed at capture (_capture_events), so parent-side
        # updates below apply only to lane-source (parked) events.
        parent_die = valid & res.parent_die & ~reg_g
        make = valid & res.made & (fl.n_e > 0.0) & ~res.parent_die

        # Post-event opacity refresh for surviving parents (:1026-1039).
        theta, nu, a_scf, a_abf = eval_alphas(kg, fl)
        neg = nu < 0.0
        surv = valid & ~res.parent_die & ~reg_g

        # One packed row scatter for every field update (put_cols); each
        # val is the exact where(mask, new, gathered-current) blend the
        # old per-field put_where computed.
        blend = lambda m, v, cur: jnp.where(m, v, cur)
        updates = [
            (p.alpha_scatti, blend(surv, jnp.where(neg, 0.0, a_scf), asc_g)),
            (p.alpha_absi, blend(surv, jnp.where(neg, 0.0, a_abf), aab_g)),
            (p.bi, blend(surv, bias_func(fl.theta_e, wg, counters), bi_g)),
            (p.w, blend(parent_die, jnp.zeros_like(wg), wg)),
            (p.ev_tries, jnp.where(defer_g, tries_g + 1,
                                   jnp.where(valid, 0, tries_g))),
            (p.alive, alive_g & ~parent_die),
            (p.occupied, occ_g & ~parent_die),
            (p.at_event, atev_g & ~(valid & ~reg_g)),
        ]
        if cfg.detached_events:
            updates.append((p.ev_pending, evp_g & ~(valid & reg_g)))
        news = put_cols(sidx, updates)
        rep = dict(zip(("alpha_scatti", "alpha_absi", "bi", "w", "ev_tries",
                        "alive", "occupied", "at_event"), news[:8]))
        if cfg.detached_events:
            rep["ev_pending"] = news[8]
        p = p._replace(**rep)

        # Pack secondaries at sec.count + prefix ranks (one row scatter).
        sec_cap = sec.rows.shape[0]
        rank = jnp.cumsum(make.astype(jnp.int32)) - 1
        pos = sec.count + rank
        room = pos < sec_cap
        put = make & room
        dropped = jnp.sum(make & ~room)
        slot = jnp.where(put, pos, sec_cap)  # mode="drop" discards these

        new_rows = jnp.stack(
            [
                xg[0], xg[1], xg[2], xg[3],
                res.k_sec[0], res.k_sec[1], res.k_sec[2], res.k_sec[3],
                secw_g, res.e_sec, res.l_sec, ne0_g,
                te0_g, fl.b, e0_g,
                (nsc_g + 1).astype(dt),
            ],
            axis=-1,
        )
        sec = sec._replace(
            rows=sec.rows.at[slot].set(new_rows, mode="drop"),
            count=sec.count + jnp.sum(put).astype(jnp.int32),
        )
        counters = counters._replace(
            n_sec_drop=counters.n_sec_drop + dropped.astype(jnp.int64),
            # Anti-stall census: consumed events whose draw came from a
            # HALVED theta_e (>= ev_halve defers) or was force-accepted.
            n_ev_soft=counters.n_ev_soft + jnp.sum(
                valid & (tries_g >= cfg.ev_halve)).astype(jnp.int64),
            n_ev_forced=counters.n_ev_forced + jnp.sum(
                valid & force_g).astype(jnp.int64),
        )
        return p, sec, counters

    def refill(p: Pool, sec: SecBuf, backlog_rows, backlog_pos, counters,
               n_valid=None, width=None, use_sec=True):
        """Fill free slots: secondaries (LIFO) first, then backlog primaries.

        Two packed-row gathers replace the 13 per-field gathers of a naive
        SoA refill, and both run EV_K-wide on the compacted set of loading
        lanes (a pool-wide double gather — 2 x n_pool row fetches from the
        secondary buffer AND the backlog, then a select — would fetch rows
        for lanes that cannot load: only <=EV_K lanes load per phase by
        construction).
        """
        free = ~p.occupied
        t_total = backlog_rows.shape[0]
        # Valid-row horizon: device-sampled backlogs are emit_chunk-padded
        # (rows past the wave's limit carry w=0); stopping the cursor at
        # n_valid skips consuming the padding 8192 rows/phase (the round-2
        # pilot wave burned ~26 s chewing ~1M pad rows for 1024 photons).
        nv = t_total if n_valid is None else n_valid

        # Cap loads per phase at the refill width so the fresh-lane init
        # can run compacted (init_fresh); in steady state retirements per
        # phase are far below the cap, and at wave start the pool just
        # ramps over n_pool/width phases instead of one.
        k_w = RF_K if width is None else width
        valid_g, gi_g, sidx_g = compact_idx(free, k_w)
        # compact_idx keeps lane order, so working-set entry j is the j-th
        # free lane: its rank among free slots is j.
        rank_g = jax.lax.broadcasted_iota(jnp.int32, (k_w,), 0)
        n_sec = sec.count if use_sec else jnp.zeros((), jnp.int32)
        from_sec_g = valid_g & (rank_g < n_sec)
        sec_idx_g = jnp.clip(n_sec - 1 - rank_g, 0, sec.rows.shape[0] - 1)

        bl_off_g = rank_g - n_sec
        bl_idx_g = backlog_pos + jnp.maximum(bl_off_g, 0)
        from_bl_g = valid_g & (rank_g >= n_sec) & (bl_idx_g < nv)
        bl_idx_g = jnp.clip(bl_idx_g, 0, t_total - 1)
        load_g = from_sec_g | from_bl_g

        rows_g = jnp.where(
            from_sec_g[:, None], sec.rows[sec_idx_g],
            backlog_rows[bl_idx_g]
        )  # (k_w, 16)

        # Scatter the compact rows to lane positions, then merge pool-wide
        # with cheap elementwise selects.  The load-indicator mask rides
        # as a 17th staging column so it costs no separate 1-D scatter.
        stag = jnp.zeros((cfg.n_pool, ROW_WIDTH + 1), dt).at[sidx_g].set(
            jnp.concatenate(
                [rows_g, load_g[:, None].astype(dt)], axis=1),
            mode="drop")
        # (17, N) with components in the leading dim, through the exact
        # one-hot transpose (chosen over .T before the port; not yet
        # measured on the H100).
        rows = fluid.onehot_transpose(stag)
        load = rows[ROW_WIDTH] > 0.5

        x_new = tuple(rows[m] for m in range(0, 4))
        k_new = tuple(rows[m] for m in range(4, 8))
        w = rows[ROW_W]
        e = rows[ROW_E]

        # Invalid photons are dropped on load (harm_model.cpp:895-900).
        bad = isnan4(x_new) | isnan4(k_new) | (w == 0.0)
        ok = load & ~bad

        zero = jnp.zeros_like(w)
        pick = lambda row, cur: jnp.where(load, row, cur)
        p = p._replace(
            x=where4(load, x_new, p.x),
            k=where4(load, k_new, p.k),
            w=pick(w, p.w),
            e=pick(e, p.e),
            l=pick(rows[ROW_L], p.l),
            n_e_0=pick(rows[ROW_NE0], p.n_e_0),
            theta_e_0=pick(rows[ROW_THETAE0], p.theta_e_0),
            b_0=pick(rows[ROW_B0], p.b_0),
            e_0=pick(rows[ROW_E0], p.e_0),
            e_0_s=pick(e, p.e_0_s),
            x1i=pick(x_new[1], p.x1i),
            x2i=pick(x_new[2], p.x2i),
            tau_abs=pick(zero, p.tau_abs),
            tau_scatt=pick(zero, p.tau_scatt),
            n_scatt=jnp.where(load, rows[ROW_NSCATT].astype(jnp.int32), p.n_scatt),
            nsc0=jnp.where(load, rows[ROW_NSCATT].astype(jnp.int32), p.nsc0),
            n_step=jnp.where(load, 0, p.n_step),
            ev_tries=jnp.where(load, 0, p.ev_tries),
            pend_dl=pick(zero, p.pend_dl),
            dl_shrink=pick(jnp.ones_like(w), p.dl_shrink),
            sec_w=pick(zero, p.sec_w),
            cell=(jnp.where(load, -1, p.cell) if cfg.fluid_cache
                  else p.cell),  # cache invalid until init_fresh
            occupied=p.occupied | ok,
            alive=p.alive | ok,
            pend_push=p.pend_push & ~load,
            at_event=p.at_event & ~load,
            record_pending=p.record_pending & ~load,
        )

        n_from_sec = jnp.sum(from_sec_g).astype(jnp.int32)
        n_from_bl = jnp.sum(from_bl_g).astype(jnp.int32)
        sec = sec._replace(count=sec.count - n_from_sec)
        counters = counters._replace(
            n_created=counters.n_created + n_from_bl.astype(jnp.int64)
        )
        # Hand init_fresh the already-compacted fresh set so it does not
        # pay a second pool-wide compact_idx pass.
        bad_g = (
            jnp.any(jnp.isnan(rows_g[:, 0:8]), axis=1)
            | (rows_g[:, ROW_W] == 0.0)
        )
        fresh_c = (load_g & ~bad_g, sidx_g)
        return p, sec, backlog_pos + n_from_bl, counters, fresh_c

    def init_fresh(p: Pool, fresh_c, counters):
        """Track-start initialisation (harm_model.cpp:902-915), compacted.

        ``fresh_c = (valid, sidx)`` is refill's already-compacted load set
        (at most EV_K lanes), so the connection/fluid/opacity evaluation
        runs on an EV_K-wide working set with no extra compaction pass.
        """
        valid, sidx = fresh_c
        gi = jnp.minimum(sidx, cfg.n_pool - 1)
        (x0g, x1g, x2g, x3g, k0g, k1g, k2g, k3g, wg,
         dkc0, dkc1, dkc2, dkc3, asc_c, aab_c, bi_c, int_c) = take_cols(
            gi, [*p.x, *p.k, p.w, *p.dkdlam,
                 p.alpha_scatti, p.alpha_absi, p.bi, p.interacting])
        xg = (x0g, x1g, x2g, x3g)
        kg = (k0g, k1g, k2g, k3g)

        conn = geometry.connection_c(xg[1], xg[2], a, hs)
        dk0 = geometry.geodesic_rhs_c(conn, *kg)

        fl = eval_fluid_hot(xg[1], xg[2])
        theta, nu, a_sc, a_ab = eval_alphas(kg, fl)
        inside = fl.n_e > 0.0
        b0 = bias_func(fl.theta_e, wg, counters)

        keep = lambda new, cur: jnp.where(valid, new, cur)
        news = put_cols(sidx, [
            (p.dkdlam[0], keep(dk0[0], dkc0)),
            (p.dkdlam[1], keep(dk0[1], dkc1)),
            (p.dkdlam[2], keep(dk0[2], dkc2)),
            (p.dkdlam[3], keep(dk0[3], dkc3)),
            (p.alpha_scatti, keep(jnp.where(inside, a_sc, 0.0), asc_c)),
            (p.alpha_absi, keep(jnp.where(inside, a_ab, 0.0), aab_c)),
            (p.bi, keep(jnp.where(inside, b0, 0.0), bi_c)),
            (p.interacting, keep(inside, int_c)),
        ])
        p = p._replace(
            dkdlam=tuple(news[:4]),
            alpha_scatti=news[4], alpha_absi=news[5], bi=news[6],
            interacting=news[7],
        )
        if cfg.trace_birth:
            # Birth-state capture for the deep-tau replay harness: the
            # freshly-loaded lanes' (x, k, w) ARE their birth state.
            bcur = take_cols(gi, [*p.bx, *p.bk, p.bw])
            bnews = put_cols(sidx, [
                (p.bx[0], keep(xg[0], bcur[0])),
                (p.bx[1], keep(xg[1], bcur[1])),
                (p.bx[2], keep(xg[2], bcur[2])),
                (p.bx[3], keep(xg[3], bcur[3])),
                (p.bk[0], keep(kg[0], bcur[4])),
                (p.bk[1], keep(kg[1], bcur[5])),
                (p.bk[2], keep(kg[2], bcur[6])),
                (p.bk[3], keep(kg[3], bcur[7])),
                (p.bw, keep(wg, bcur[8])),
            ])
            p = p._replace(bx=tuple(bnews[0:4]), bk=tuple(bnews[4:8]),
                           bw=bnews[8])
        if cfg.fluid_cache:
            # Prime the corner-row cache so fresh lanes never hit the
            # hot-step refresh with a stale/garbage row.
            ii, jj, _, _ = geometry.x_to_ij_c(
                xg[1], xg[2], mc.x_start, mc.dx, (mc.n1, mc.n2))
            zf = (ii * mc.n2 + jj).astype(jnp.int32)
            rows_f = corner_rows[jnp.where(valid, zf, 0)]
            p = p._replace(
                frow=tuple(
                    p.frow[m].at[sidx].set(
                        jnp.where(valid, rows_f[:, m], p.frow[m][gi]),
                        mode="drop")
                    for m in range(32)),
                cell=p.cell.at[sidx].set(
                    jnp.where(valid, zf, p.cell[gi]), mode="drop"),
            )
        return p

    def _poison_sweep(p: Pool) -> Pool:
        """NaN insurance: poisoned lanes die unrecorded."""
        poison = p.occupied & (
            isnan4(p.x) | isnan4(p.k) | jnp.isnan(p.w)
        )
        p = p._replace(
            alive=p.alive & ~poison,
            occupied=p.occupied & ~poison,
            record_pending=p.record_pending & ~poison,
            at_event=p.at_event & ~poison,
        )
        if cfg.detached_events:
            p = p._replace(ev_pending=p.ev_pending & ~poison)
        return p

    def _record_free_refill(p, spec, counters, sec, backlog_rows,
                            backlog_pos, n_valid, width=None, use_sec=True):
        """Record escaped lanes, free dead ones, reload from sec/backlog.

        The maintenance half shared by the full periodic phase and the
        light phase (EngineConfig.refill_period); ``width``/``use_sec``
        narrow the light phase's working sets."""
        occ0 = p.occupied  # for the retired-steps accounting below
        rec0 = p.record_pending  # pre-record snapshot for the stall census
        if "record" not in dbg:
            spec, counters, p = spectrum_add(spec, counters, p, width=width)
        # Free dead-but-unrecorded lanes (horizon, roulette, absorbed) —
        # except lanes still holding an unconsumed detached event.
        keep = p.alive | p.record_pending
        if cfg.detached_events:
            keep = keep | p.ev_pending
        p = p._replace(occupied=p.occupied & keep)
        # Step-economics accounting: per-photon step counts at retirement
        # (drives the steps/photon diagnostic in the benches).
        freed = occ0 & ~p.occupied
        # Step-cap truncation census: a freed lane with n_step past the cap
        # was killed by the stall check (hot_phase_b `over`), not physics —
        # its remaining weight left the simulation unrecorded.  Lanes that
        # ESCAPED on the crossing step (record_pending consumed by
        # spectrum_add just above) were recorded, not truncated — exclude
        # them or the census double-counts.
        stalled = (freed & (p.n_step > cfg.stall_steps)
                   & ~(rec0 & ~p.record_pending))
        counters = counters._replace(
            n_retired=counters.n_retired + jnp.sum(freed).astype(jnp.int64),
            n_steps_retired=counters.n_steps_retired
            + jnp.sum(jnp.where(freed, p.n_step, 0)).astype(jnp.int64),
            n_stall=counters.n_stall + jnp.sum(stalled).astype(jnp.int64),
            w_stall=counters.w_stall
            + jnp.sum(jnp.where(stalled, p.w, 0.0)).astype(dt),
        )
        if "refill" not in dbg:
            p, sec, backlog_pos, counters, fresh = refill(
                p, sec, backlog_rows, backlog_pos, counters, n_valid,
                width=width, use_sec=use_sec,
            )
            p = init_fresh(p, fresh, counters)
        return p, spec, counters, sec, backlog_pos

    def periodic_phase(state: State, backlog_rows, n_valid=None) -> State:
        p, spec, counters, sec = state.pool, state.spec, state.counters, state.sec
        key, k_sc = random.split(state.key)
        p = _poison_sweep(p)
        if "scatter" not in dbg:
            p, sec, counters = process_scatters(k_sc, p, sec, counters)
        p, spec, counters, sec, backlog_pos = _record_free_refill(
            p, spec, counters, sec, backlog_rows, state.backlog_pos, n_valid)
        if cfg.bias_ema > 0.0:
            # Windowed bias feedback (EngineConfig.bias_ema): fold the
            # since-last-full-phase marginal scatters/recorded ratio into
            # the EMA; windows with no records leave it unchanged.
            d_s = (counters.n_scatt_rec - counters.ema_scatt_mark).astype(dt)
            d_r = (counters.n_recorded - counters.ema_rec_mark).astype(dt)
            a = jnp.where(d_r > 0.0, jnp.asarray(cfg.bias_ema, dt), 0.0)
            ema = ((1.0 - a) * counters.avg_ema
                   + a * d_s / jnp.maximum(d_r, 1.0))
            counters = counters._replace(
                avg_ema=ema,
                ema_scatt_mark=counters.n_scatt_rec,
                ema_rec_mark=counters.n_recorded,
            )
        return state._replace(
            pool=p, spec=spec, counters=counters, sec=sec,
            backlog_pos=backlog_pos, key=key,
        )

    def light_phase(state: State, backlog_rows, n_valid=None) -> State:
        """Record + free + refill only — no scatter-event samplers, no RNG.

        Run between full periodic phases (EngineConfig.refill_period) so
        retired lanes reload within a few iterations instead of idling to
        the end of the m_period block.  Detached events stay pending in
        their shadow registers until the next full phase (their holders
        keep moving); parked lanes stay parked."""
        lk = min(cfg.n_pool,
                 cfg.light_k if cfg.light_k else min(EV_K, RF_K))
        p = _poison_sweep(state.pool)
        p, spec, counters, sec, backlog_pos = _record_free_refill(
            p, state.spec, state.counters, state.sec, backlog_rows,
            state.backlog_pos, n_valid, width=lk)
        return state._replace(
            pool=p, spec=spec, counters=counters, sec=sec,
            backlog_pos=backlog_pos,
        )

    # ------------------------------------------------------------------
    # drivers
    # ------------------------------------------------------------------
    def run(state: State, backlog_rows, tail_exit=None, n_valid=None) -> State:
        """One engine dispatch.  ``tail_exit`` may be a traced scalar — the
        occupancy below which the wave may end once its backlog is spent —
        so ONE compiled executable serves pool-full wave handoff
        (tail_exit=n_pool), the pilot-wave counter-warmup drain, and the
        final full-width drain; None falls back to the static
        cfg.tail_exit (the tail-cascade engines and the sharded path).
        ``n_valid`` (traced scalar) is the count of real rows in a padded
        backlog; the cursor stops there instead of chewing the padding."""
        t_total = backlog_rows.shape[0]
        n_super = max(1, cfg.m_period)
        te = cfg.tail_exit if tail_exit is None else tail_exit
        nv = t_total if n_valid is None else n_valid
        # Hot-iteration blocks between pool-maintenance phases: block 0
        # follows the FULL periodic phase, later blocks a light phase each.
        rp = cfg.refill_period if cfg.refill_period > 0 else n_super
        blocks = [rp] * (n_super // rp)
        if n_super % rp:
            blocks.append(n_super % rp)

        def cond(state):
            return (
                (jnp.sum(state.pool.occupied) > te)
                | (state.backlog_pos < nv)
                | (state.sec.count > 0)
            ) & (state.it < cfg.max_outer)

        def body(state):
            state = periodic_phase(state, backlog_rows, n_valid)
            state = lax.fori_loop(0, blocks[0],
                                  lambda i, s: hot_step(s), state)
            for nb in blocks[1:]:
                state = light_phase(state, backlog_rows, n_valid)
                state = lax.fori_loop(0, nb, lambda i, s: hot_step(s), state)
            return state

        state = lax.while_loop(cond, body, state)
        # Final flush of any pending records (all lanes are dead here).
        # spectrum_add drains at most EV_K lanes per call, so loop.  A lane
        # that is record_pending AND still holds an unconsumed detached
        # event is NOT flushable (spectrum_add skips it until
        # process_scatters consumes the event registers) — counting it in
        # the condition makes this while_loop infinite, which hangs the
        # dispatch.  Such
        # lanes stay occupied and record on a later dispatch's periodic
        # phase.
        def flush_cond(s):
            spec, counters, p = s
            pend = p.record_pending
            if cfg.detached_events:
                pend = pend & ~p.ev_pending
            return jnp.any(pend)

        def flush_body(s):
            spec, counters, p = s
            return spectrum_add(spec, counters, p)

        spec, counters, p = lax.while_loop(
            flush_cond, flush_body,
            (state.spec, state.counters, state.pool),
        )
        return state._replace(pool=p, spec=spec, counters=counters)

    def fresh_state(key):
        return State(
            pool=empty_pool(cfg.n_pool, dt, fluid_cache=cfg.fluid_cache,
                            detached_events=cfg.detached_events,
                            trace_birth=cfg.trace_birth),
            spec=jnp.zeros((N_BINS + 1, N_SPEC_CHAN), dt),
            counters=init_counters(mc.max_tau_scatt0, dt),
            sec=empty_secbuf(cfg.sec_cap, dt),
            backlog_pos=jnp.zeros((), jnp.int32),
            key=key,
            it=jnp.zeros((), jnp.int32),
        )

    def push_rounds(state: State):
        """Diagnostic: halving pressure — the count of occupied lanes whose
        adaptive per-lane step is currently shrunk below the nominal dl
        (the retry-push analogue of the old batch-max halving-round count;
        0 means every lane commits full steps)."""
        p = state.pool
        return jnp.sum(p.occupied & (p.dl_shrink < 1.0)).astype(jnp.int32)

    return {
        "run": run,
        "push_rounds": push_rounds,
        "hot_step": hot_step,
        "hot_step_legacy": hot_step_legacy,  # A/B parity checks only
        "periodic_phase": periodic_phase,
        "light_phase": light_phase,
        "push_batch": push_batch,
        "fresh_state": fresh_state,
        "bias_func": bias_func,
    }
