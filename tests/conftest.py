"""Test configuration: force CPU with an 8-device virtual mesh.

Multi-device sharding is validated on a virtual CPU mesh; set
platform/device-count before JAX is imported anywhere.  Tests that need the
GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them where JAX finds no GPU (run them on the card with
``python -m pytest tests/ -m gpu``).
"""

import os

# GRMONTY_TEST_GPU=1 keeps the GPU (and the CPU backend the driver needs)
# for a run of the gpu-marked tests on the card.
_GPU_RUN = os.environ.get("GRMONTY_TEST_GPU") == "1"
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _GPU_RUN else "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Force the CPU backend explicitly: an installed accelerator plugin would
# otherwise take over the default device.
if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy tier (multi-minute engine compiles / long transport "
        "runs); deselected by default — run with GRMONTY_SLOW=1 or "
        "-m slow.  The fast tier (everything unmarked) must stay under "
        "~10 min on a single core and keeps full shipped-configuration "
        "coverage (incl. the sharded bench-knob regression test).",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (takes the gpu_device fixture, which "
        "skips where JAX finds none); run on the card with "
        "GRMONTY_TEST_GPU=1 python -m pytest tests/ -m gpu",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("GRMONTY_SLOW", "0") == "1":
        return  # run everything
    if config.getoption("-m"):
        return  # explicit marker selection wins
    skip_slow = pytest.mark.skip(
        reason="slow tier: set GRMONTY_SLOW=1 or use -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def gpu_device():
    """JAX's first GPU device; skips the test where there is none.  Decided
    here, at run time, so every worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: run on the card with GRMONTY_TEST_GPU=1 "
                    "python -m pytest tests/ -m gpu")
    return gpus[0]


@pytest.fixture(scope="session")
def jnu_tables():
    from grmonty.utils import cache

    return cache.jnu_tables()


@pytest.fixture(scope="session")
def hotcross_table():
    from grmonty.utils import cache

    return cache.hotcross_table()


@pytest.fixture(scope="session")
def torus_model(tmp_path_factory):
    """A small synthetic torus dump, parsed, for end-to-end tests."""
    from grmonty.models import torus, harm

    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return harm.read_dump(str(path), mass_unit=4.0e19)


@pytest.fixture
def rng():
    return np.random.default_rng(123)
