"""grow_cap sanity: accuracy-gated step growth must keep physics sane.

grow_cap > 1 is an opt-in deviation (EngineConfig.grow_cap): lanes that
keep passing the fixed-point and conserved-energy tests may grow their
step beyond the reference's nominal step_size.  This test drives a full
tiny simulation at grow_cap=4 against grow_cap=1 and asserts the global
observables stay consistent while steps/photon actually drops —
statistical accuracy at scale is validated separately
(tools/ab_growcap.py)."""

import numpy as np
import pytest

from grmonty.transport import engine as engine_mod

# Heavy tier: multi-minute engine compiles / long transport runs on the
# single-core CI host (tests/conftest.py tiering).
pytestmark = pytest.mark.slow


def _run(tmp_path_factory, grow):
    from grmonty.models import torus
    from grmonty.transport import driver

    path = tmp_path_factory.mktemp("dumps") / f"torus_g{grow}"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    cfg = engine_mod.EngineConfig(
        n_pool=256, m_period=8, sec_cap=4096, max_outer=40000,
        stall_steps=40000, grow_cap=float(grow),
    )
    sim = driver.Simulation(
        str(path), photon_n=60, mass_unit=4.0e18, config=cfg,
        emit_chunk=2048, warmup=128,
    )
    spec, stats = sim.run()
    return np.asarray(spec), stats


@pytest.mark.slow
def test_growcap_preserves_observables(tmp_path_factory):
    spec1, st1 = _run(tmp_path_factory, 1)
    spec4, st4 = _run(tmp_path_factory, 4)

    assert np.isfinite(spec4).all()
    assert st4["n_recorded"] > 0
    # recorded fraction consistent within loose MC bounds
    r1 = st1["n_recorded"] / max(st1["n_created"], 1)
    r4 = st4["n_recorded"] / max(st4["n_created"], 1)
    assert 0.7 < r4 / r1 < 1.4, (r1, r4)
    # luminosity per created photon within 25% (few-thousand-photon MC)
    l1 = spec1[:, 1].sum() / max(st1["n_created"], 1)
    l4 = spec4[:, 1].sum() / max(st4["n_created"], 1)
    assert 0.75 < l4 / l1 < 1.33, (l1, l4)
    # the knob actually reduces work
    s1 = st1.get("steps_per_photon", 0.0)
    s4 = st4.get("steps_per_photon", 0.0)
    assert s4 < s1, (s1, s4)
