"""Checkpoint/resume: a run interrupted between waves resumes from the
disk checkpoint and produces the identical spectrum.

The reference has no checkpointing (runs are minutes, SURVEY.md §5); here
it lets a long run resume after an interruption, so the contract tested is
strict: resumed waves replay bit-identically (the checkpoint's RNG key is
saved already advanced past every consumed wave split)."""

import os

import numpy as np
import pytest

from grmonty.transport import engine as engine_mod


def _make_sim(dump, **kw):
    from grmonty.transport import driver

    cfg = engine_mod.EngineConfig(
        n_pool=256, m_period=8, sec_cap=4096, max_outer=40000,
        stall_steps=40000,
    )
    args = dict(photon_n=60, mass_unit=4.0e18, config=cfg,
                emit_chunk=512, warmup=128)
    args.update(kw)
    return driver.Simulation(str(dump), **args)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    from grmonty.models import torus

    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return path


def test_resume_reproduces_uninterrupted_run(dump, tmp_path):
    # Baseline: uninterrupted, no checkpointing.
    spec_ref, stats_ref = _make_sim(dump).run()

    # Interrupted run: crash injected after one completed wave (the plan
    # splits into >=2 waves: the warmup pilot wave plus the bulk chunks).
    ck = str(tmp_path / "resume.npz")
    sim2 = _make_sim(dump)

    class _Boom(Exception):
        pass

    orig = sim2._run_wave
    calls = []

    def crashing(*a, **kw):
        if len(calls) == 1:
            raise _Boom()
        calls.append(1)
        return orig(*a, **kw)

    sim2._run_wave = crashing
    with pytest.raises(_Boom):
        sim2.run(checkpoint_path=ck)
    assert os.path.exists(ck), "checkpoint should survive the crash"

    # Fresh process stand-in: new Simulation, same arguments, resumes.
    sim3 = _make_sim(dump)
    spec_res, stats_res = sim3.run(checkpoint_path=ck)

    np.testing.assert_allclose(spec_res, spec_ref, rtol=1e-6, atol=0)
    assert stats_res["n_recorded"] == stats_ref["n_recorded"]
    assert not os.path.exists(ck), "completed run must delete the checkpoint"


def test_checkpoint_refuses_mismatched_setup(dump, tmp_path):
    ck = str(tmp_path / "mismatch.npz")
    sim = _make_sim(dump)
    state = sim.engine["fresh_state"](__import__("jax").random.PRNGKey(0))
    sim.save_checkpoint(ck, 1, state)

    other = _make_sim(dump, photon_n=61)
    with pytest.raises(ValueError, match="different run setup"):
        other.load_checkpoint(ck, state)
