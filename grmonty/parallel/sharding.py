"""Multi-chip scale-out: data-parallel photon transport over a device mesh.

The reference is strictly single-GPU (SURVEY §2: no NCCL/MPI anywhere); its
scale-out analogue is the fixed 16384-photon pool per CUDA stream.  Here we
shard the photon pool and emission backlog over a 1D ``jax.sharding.Mesh``
axis ``'ph'`` with ``jax.shard_map``: every chip runs the full transport
engine on its own photon shard (photons are independent), and the only
cross-chip communication is the reduction of the per-shard spectrum
accumulators and counters when the run completes — photon transport needs no
other collective.  The reduction is expressed as jitted ``jnp.sum``/``max``
over the mesh-sharded leading axis, which XLA lowers to the all-reduce over
ICI; nothing rides DCN.

Design deviation (documented): the bias-feedback scalars (n_recorded,
n_scatt, max_tau_scatt) are per-shard during flight rather than globally
synchronized each superstep.  The reference itself reads these racily from
device globals while kernels update them (super_photon.cu:36-46,1649-1662),
so per-shard staleness is the same class of approximation, and it keeps the
hot loop collective-free so shards never wait on each other.
"""

from __future__ import annotations

import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import random
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grmonty.transport import driver as driver_mod
from grmonty.transport import engine as engine_mod

log = logging.getLogger("grmonty")


def _state_specs(detached_events=False):
    """PartitionSpec pytree for the sharded engine State.

    Pool arrays shard their lane axis (the last); per-shard scalars are
    carried as (n_dev,)-shaped arrays sharded over 'ph' so each shard sees a
    (1,) view it owns (squeezed at the shard_map boundary) — per-shard
    progress (backlog_pos, sec.count) is then visible to the host without
    any replication assumption.

    ``detached_events``: the event shadow registers (ev_x/ev_k/ev_w/
    ev_pending) are plain per-lane state, sharded like every other pool
    array.  (fluid_cache stays unsupported sharded — it loses on a single
    chip anyway, see EngineConfig.)
    """
    vec4 = lambda: (P("ph"),) * 4  # 4-tuples of (N,) components
    pool = engine_mod.Pool(
        x=vec4(), k=vec4(), dkdlam=vec4(),
        frow=(),
        # trace_birth is a single-chip diagnostic (tools/replay_deep_tau);
        # sharded engines run with it off, so the birth-trace fields are
        # always the empty tuple / (0,)-array here.
        bx=(), bk=(), bw=P("ph"),
        ev_x=(vec4() if detached_events else ()),
        ev_k=(vec4() if detached_events else ()),
        **{f: P("ph") for f in engine_mod.Pool._fields
           if f not in ("x", "k", "dkdlam", "frow", "ev_x", "ev_k",
                        "bx", "bk", "bw")},
    )
    sec = engine_mod.SecBuf(rows=P("ph", None), count=P("ph"))
    counters = engine_mod.Counters(*([P("ph")] * len(engine_mod.Counters._fields)))
    return engine_mod.State(
        pool=pool, spec=P("ph", None, None), counters=counters, sec=sec,
        backlog_pos=P("ph"), key=P("ph", None), it=P("ph"),
    )


def _squeeze_state(state):
    """(1,)-leading per-shard arrays -> the scalar state the engine expects."""
    return state._replace(
        spec=state.spec[0],
        counters=jax.tree.map(lambda a: a[0], state.counters),
        sec=state.sec._replace(count=state.sec.count[0]),
        backlog_pos=state.backlog_pos[0],
        key=state.key[0],
        it=state.it[0],
    )


def _unsqueeze_state(state):
    return state._replace(
        spec=state.spec[None],
        counters=jax.tree.map(lambda a: a[None], state.counters),
        sec=state.sec._replace(count=state.sec.count[None]),
        backlog_pos=state.backlog_pos[None],
        key=state.key[None],
        it=state.it[None],
    )


class ShardedSimulation(driver_mod.Simulation):
    """Simulation with the photon pool sharded over ``n_devices`` chips.

    ``cfg.n_pool``/``cfg.sec_cap`` are per-shard sizes; the emission chunk is
    split evenly across shards and every shard consumes its slice to
    completion (slices of ``slice_iters`` hot iterations, like the
    single-chip driver, so the host can log progress and checkpoint).
    """

    def __init__(self, *args, n_devices: int = 0, devices=None, **kwargs):
        devices = devices or jax.devices()
        n_devices = n_devices or len(devices)
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        cfg = kwargs.get("config")
        if cfg is not None and getattr(cfg, "fluid_cache", False):
            raise ValueError("fluid_cache is not supported on the sharded path")
        self.n_devices = n_devices
        self.mesh = Mesh(np.array(devices[:n_devices]), ("ph",))
        # Interior chunks hand off with the pool still full (the single-chip
        # driver's pool-full handoff); the final drain runs tail_exit=0.
        _cfg = cfg if cfg is not None else engine_mod.EngineConfig()
        kwargs.setdefault("wave_tail_exit", _cfg.n_pool)
        super().__init__(*args, **kwargs)

        run = self.engine["run"]
        specs = _state_specs(self.cfg.detached_events)
        self._specs = specs

        def _run_shard(state, backlog, tail_exit, n_valid):
            state = _squeeze_state(state)._replace(it=jnp.zeros((), jnp.int32))
            state = run(state, backlog, tail_exit, n_valid)
            return _unsqueeze_state(state)

        self._sharded_run = jax.jit(
            jax.shard_map(
                _run_shard,
                mesh=self.mesh,
                in_specs=(specs, P("ph", None), P(), P()),
                out_specs=specs,
                check_vma=False,
            )
        )

        @jax.jit
        def _reduce(spec, counters):
            # jnp reductions over the sharded leading axis: XLA inserts the
            # cross-chip all-reduce (the run's only collective).
            spec_tot = jnp.sum(spec, axis=0)
            return spec_tot, engine_mod.Counters(
                n_recorded=jnp.sum(counters.n_recorded),
                n_scatt_rec=jnp.sum(counters.n_scatt_rec),
                max_tau_scatt=jnp.max(counters.max_tau_scatt),
                n_created=jnp.sum(counters.n_created),
                n_sec_drop=jnp.sum(counters.n_sec_drop),
                n_retired=jnp.sum(counters.n_retired),
                n_steps_retired=jnp.sum(counters.n_steps_retired),
                ls_iters=jnp.sum(counters.ls_iters),
                ls_slots=jnp.sum(counters.ls_slots),
                ls_occupied=jnp.sum(counters.ls_occupied),
                ls_moving=jnp.sum(counters.ls_moving),
                ls_committed=jnp.sum(counters.ls_committed),
                ls_parked=jnp.sum(counters.ls_parked),
                n_stall=jnp.sum(counters.n_stall),
                w_stall=jnp.sum(counters.w_stall),
                avg_ema=jnp.max(counters.avg_ema),
                ema_scatt_mark=jnp.sum(counters.ema_scatt_mark),
                ema_rec_mark=jnp.sum(counters.ema_rec_mark),
                # diagnostics: birth-trace capture is single-chip only
                # (take shard 0's values); the censuses sum.
                mt_bx=counters.mt_bx[0], mt_bk=counters.mt_bk[0],
                mt_bw=counters.mt_bw[0], mt_nsc0=counters.mt_nsc0[0],
                n_ev_soft=jnp.sum(counters.n_ev_soft),
                n_ev_forced=jnp.sum(counters.n_ev_forced),
                n_hc_clamp=jnp.sum(counters.n_hc_clamp),
            )

        self._reduce = _reduce

    # -- sharded state/backlog construction ------------------------------
    def _fresh_sharded_state(self, key):
        n = self.n_devices
        sh = lambda spec: NamedSharding(self.mesh, spec)
        specs = self._specs
        single = jax.tree.map(np.asarray, self.engine["fresh_state"](key))
        keys = np.asarray(random.split(key, n))

        pool = jax.tree.map(
            lambda a, s: jax.device_put(
                np.concatenate([a] * n, axis=-1), sh(s)
            ),
            single.pool, specs.pool,
        )
        state = engine_mod.State(
            pool=pool,
            spec=jax.device_put(np.stack([np.asarray(single.spec)] * n), sh(specs.spec)),
            counters=jax.tree.map(
                lambda a, s: jax.device_put(np.stack([np.asarray(a)] * n), sh(s)),
                single.counters, specs.counters,
            ),
            sec=engine_mod.SecBuf(
                rows=jax.device_put(
                    np.concatenate([np.asarray(single.sec.rows)] * n, axis=0)
                    .reshape(n * single.sec.rows.shape[0], engine_mod.ROW_WIDTH),
                    sh(specs.sec.rows),
                ),
                count=jax.device_put(np.zeros(n, np.int32), sh(specs.sec.count)),
            ),
            backlog_pos=jax.device_put(np.zeros(n, np.int32), sh(specs.backlog_pos)),
            key=jax.device_put(keys, sh(specs.key)),
            it=jax.device_put(np.zeros(n, np.int32), sh(specs.it)),
        )
        return state

    def _put_backlog(self, rows):
        return jax.device_put(
            np.asarray(rows), NamedSharding(self.mesh, P("ph", None))
        )

    def save_checkpoint(self, path, chunks_done, state):
        """Disk resume point after a completed chunk (sharded flavour of
        driver.Simulation.save_checkpoint: same leaf-list npz layout, with
        the mesh width recorded so a resume can't silently change it)."""
        state_h = jax.device_get(state)
        leaves = jax.tree_util.tree_leaves(state_h)
        payload = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
        payload["spec_acc"] = self.spec_acc
        payload["key"] = np.asarray(self.key)
        payload["meta"] = np.asarray(
            [chunks_done, len(leaves), self.photon_n, self.cfg.n_pool,
             self.emit_chunk, self.n_devices,
             1 if os.environ.get("GRMONTY_RAMP", "1") == "1" else 0],
            np.int64)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        log.info("sharded checkpoint: %d chunk(s) done -> %s",
                 chunks_done, path)

    def load_checkpoint(self, path, template_state):
        dat = np.load(path, allow_pickle=False)
        meta = [int(x) for x in dat["meta"]]
        chunks_done, n_leaves, photon_n, n_pool, emit_chunk, n_dev = meta[:6]
        # Pre-ramp-metadata checkpoints were written with the non-ramped
        # chunk schedule — default 0 so they only load under GRMONTY_RAMP=0.
        ramp = meta[6] if len(meta) > 6 else 0
        ramp_now = 1 if os.environ.get("GRMONTY_RAMP", "1") == "1" else 0
        if (photon_n, n_pool, emit_chunk, n_dev, ramp) != (
                self.photon_n, self.cfg.n_pool, self.emit_chunk,
                self.n_devices, ramp_now):
            raise ValueError(
                f"sharded checkpoint {path} from a different run setup: "
                f"photon_n/n_pool/emit_chunk/n_dev/ramp {meta[2:]} != "
                f"{(self.photon_n, self.cfg.n_pool, self.emit_chunk, self.n_devices, ramp_now)}")
        treedef = jax.tree_util.tree_structure(template_state)
        if treedef.num_leaves != n_leaves:
            raise ValueError("sharded checkpoint state structure mismatch")
        leaves = [dat[f"leaf_{i}"] for i in range(n_leaves)]
        host_state = jax.tree_util.tree_unflatten(treedef, leaves)
        state = jax.tree.map(
            lambda a, s: jax.device_put(
                np.asarray(a), NamedSharding(self.mesh, s)),
            host_state, self._specs)
        self.spec_acc = dat["spec_acc"].astype(np.float64)
        self.key = jnp.asarray(dat["key"])
        return chunks_done, state

    def run(self, checkpoint_path=None, checkpoint_every=1):
        t0 = time.time()
        plan = self.plan()
        self.key, k_eng = random.split(self.key)
        state = self._fresh_sharded_state(k_eng)
        self.spec_acc = np.zeros_like(self.spec_acc)

        # Bias warmup (driver parity): the sharded path
        # previously launched its full-width shards with cold bias
        # counters and ran the same Compton storm the single-chip driver's
        # pilot exists to prevent (round 1 measured 3.6M surplus
        # scatters).  The host-oracle sequential warmup converges the
        # counters in ~1-3 s with no device work; the converged values are
        # REPLICATED to every shard — the bias reads ratios (n_scatt_rec /
        # n_recorded) and a max, both of which replicate correctly.  The
        # warm counts are subtracted again before the final reduce so the
        # reported totals count only this run's photons.
        warm = min(self.warmup, plan.total)
        self._warm_base = None
        if warm > 0:
            batch = self._pilot_batch(plan, warm)
            warmed = self._host_warm_counters(
                batch, jax.tree.map(lambda a: a[0], state.counters))
            if warmed is not None:
                n = self.n_devices
                sh = lambda spec: NamedSharding(self.mesh, spec)
                state = state._replace(counters=jax.tree.map(
                    lambda v, s: jax.device_put(
                        np.stack([np.asarray(v)] * n), sh(s)),
                    warmed, self._specs.counters))
                self._warm_base = warmed

        n = self.n_devices
        # chunk must divide evenly across shards
        chunk = -(-self.emit_chunk // n) * n
        per_shard = chunk // n
        # First-chunk ramp (driver.run parity): converge the bias-feedback
        # ratchet on small cohorts instead of storming the full first
        # chunk (see driver.run).  Sub-chunks keep the full backlog SHAPE
        # (zero-padded) so the sharded executable is not re-specialized;
        # only the traced n_valid shrinks.
        sched = []
        if (os.environ.get("GRMONTY_RAMP", "1") == "1"
            and plan.total > chunk >= 8 * n):
            cs = 0
            for part in (chunk // 8 // n * n, chunk // 8 // n * n,
                         chunk // 4 // n * n):
                sched.append((cs, part))
                cs += part
            sched.append((cs, chunk - cs))
            cs = chunk
        else:
            cs = 0
        sched += [(c0, min(chunk, plan.total - c0))
                  for c0 in range(cs, plan.total, chunk)]
        n_chunks = len(sched)
        resume = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            resume, state = self.load_checkpoint(checkpoint_path, state)
            log.info("sharded resume from %s: %d chunk(s) done",
                     checkpoint_path, resume)
        # Interior chunks exit at pool-full handoff; the last chunk drains
        # to zero so the final all-reduce sees completed transport.
        pool_sh = NamedSharding(self.mesh, P("ph"))
        for c in range(resume, n_chunks):
            start, limit = sched[c]
            if limit < chunk and limit % n == 0:
                # Ramp sub-chunk: keep the full backlog shape (no
                # executable re-specialization) AND give every shard its
                # fair share — each shard's ps_c valid rows sit at the
                # START of its per_shard block, zero-padded behind (the
                # per-shard cursor stops at n_valid = ps_c).
                batch = self._sample(plan, start, limit)
                rows = engine_mod.pack_rows(batch, self.cfg.dtype)
                ps_c = limit // n
                blocks = np.zeros((n, per_shard, rows.shape[1]), rows.dtype)
                blocks[:, :ps_c] = rows.reshape(n, ps_c, rows.shape[1])
                rows = blocks.reshape(chunk, rows.shape[1])
            else:
                # Full chunk (the last one may overhang the plan: sampler
                # zero-pads, the engine drops w=0 rows on load).
                batch = self._sample(plan, start, chunk, limit=limit)
                rows = engine_mod.pack_rows(batch, self.cfg.dtype)
                ps_c = per_shard
            backlog = self._put_backlog(rows)
            # reset every shard's backlog cursor for the fresh chunk
            state = state._replace(
                backlog_pos=jax.device_put(np.zeros(n, np.int32), pool_sh)
            )
            te = np.int32(0 if c + 1 == n_chunks else self._wave_tail_exit)
            nv = np.int32(ps_c)
            # Run the chunk to completion in bounded slices on every shard.
            # No-progress watchdog: each dispatch runs at most
            # min(max_outer, slice_iters) hot iterations (the engine is
            # built slice-bounded, driver.py), so a live straggler retires
            # (stall_steps cap) within stall_steps/per_dispatch dispatches
            # even when its per-lane n_step is the only thing advancing; a
            # progress signature frozen for several times that means the
            # engine is wedged (e.g. the pre-r3 ring-full/pool-full
            # livelock, which once ran into an external timeout) — fail loudly instead of
            # spinning until an external timeout.
            stagnant, last_sig = 0, None
            per_dispatch = max(1, min(self.cfg.max_outer, self._slice_iters))
            max_stagnant = 16 + 4 * max(
                1, -(-self.cfg.stall_steps // per_dispatch))
            while True:
                state = self._sharded_run(state, backlog, te, nv)
                occ = int(jax.device_get(jnp.sum(state.pool.occupied)))
                pos = np.asarray(jax.device_get(state.backlog_pos))
                secs = np.asarray(jax.device_get(state.sec.count))
                rec, steps = (int(np.sum(x)) for x in jax.device_get(
                    (state.counters.n_recorded,
                     state.counters.n_steps_retired)))
                log.info(
                    "sharded chunk %d/%d: occ=%d pos_min=%d sec=%d",
                    c + 1, n_chunks, occ, int(pos.min()), int(secs.sum()),
                )
                if ((pos >= ps_c).all() and secs.sum() == 0
                        and occ <= int(te) * n):
                    break
                sig = (occ, pos.tobytes(), secs.tobytes(), rec, steps)
                stagnant = stagnant + 1 if sig == last_sig else 0
                last_sig = sig
                if stagnant >= max_stagnant:
                    self.state = state  # post-mortem access for debugging
                    raise RuntimeError(
                        f"sharded chunk {c + 1}/{n_chunks} made no progress "
                        f"for {stagnant} dispatches (occ={occ}, "
                        f"pos={pos.tolist()}, sec={secs.tolist()}): engine "
                        "wedged")
            if checkpoint_path and (c + 1) % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_path, c + 1, state)
        if checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)

        spec, counters = self._reduce(state.spec, state.counters)
        spec = driver_mod.unscale_spectrum(
            np.asarray(jax.device_get(spec), np.float64), self.cfg.weight_scale
        )
        counters = jax.device_get(counters)
        elapsed = time.time() - t0
        # Remove the replicated warmup baseline from the summed counters
        # (each shard started with the warm values; see run() above).
        w_rec = w_scatt = 0
        if self._warm_base is not None:
            w_rec = int(self._warm_base.n_recorded) * self.n_devices
            w_scatt = int(self._warm_base.n_scatt_rec) * self.n_devices
        stats = {
            "n_created": plan.total,
            "n_recorded": max(0, int(counters.n_recorded) - w_rec),
            "n_scatt_recorded": max(0, int(counters.n_scatt_rec) - w_scatt),
            "max_tau_scatt": float(counters.max_tau_scatt),
            "n_secondary_dropped": int(counters.n_sec_drop),
            "elapsed_s": elapsed,
            "photon_rate": plan.total / max(elapsed, 1e-9),
            "n_devices": self.n_devices,
            "n_stall_killed": int(counters.n_stall),
            "n_hc_clamp": int(counters.n_hc_clamp),
        }
        # Step-cap truncation fraction (see driver.run): scaled-weight units
        # on both sides; spec here is already unscaled, so rescale.
        w_rec_spec = float(spec[:, 0].sum()) * self.cfg.weight_scale
        w_stall = float(counters.w_stall)
        stats["w_stall_frac"] = w_stall / max(w_rec_spec + w_stall, 1e-300)
        log.info("Final rate %.2f ph/s over %d devices",
                 stats["photon_rate"], self.n_devices)
        self.spec = spec
        self.state = state
        return np.asarray(spec), stats
