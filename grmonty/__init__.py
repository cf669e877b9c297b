"""grmonty — general-relativistic Monte Carlo radiative transport in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of cuda-grmonty (a CUDA
port of grmonty, Dolence et al. 2009, arXiv:0909.0708).  Photons are
tracked as SoA batches stepped inside a `lax.while_loop`; all physics is
expressed as pure, vectorized functions so XLA can fuse the entire
transport superstep.

Layout:
    models/     HARM GRMHD snapshot I/O, units, synthetic torus generator
    ops/        physics kernels: geometry, tetrads, fluid interpolation,
                synchrotron emissivity, Compton cross sections, opacities,
                Monte Carlo samplers, emission, spectrum binning
    transport/  the batched geodesic transport engine (the hot loop)
    parallel/   multi-device sharding (shard_map over a photon-axis Mesh)
    utils/      logging, table caching

Precision: double precision is required for parity with the reference
(which is entirely `double`); we enable x64 at import.  The transport
engine's compute dtype is configurable (see
`grmonty.transport.engine.EngineConfig`); float64 is the parity
default, and the shipped profile runs float32, which passes the same
statistical spectrum checks (ACCURACY.md).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it itself and the package sets nothing.  Otherwise the cache sits at
# a fixed path inside the checkout (the path is part of what makes a cache
# hit), in a subdirectory keyed by a host fingerprint (machine arch + CPU
# model/flags): XLA:CPU caches AOT executables whose cache key does NOT
# include the host's CPU features, so a cache populated on one machine and
# read on another — a checkout copied between hosts — loads code compiled
# for the wrong feature set ("Machine type used for XLA:CPU compilation
# doesn't match ... could lead to execution errors such as SIGILL").
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_fingerprint():
    import hashlib
    import platform

    bits = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    bits.append(line.strip())
                    if len(bits) >= 3:
                        break
    except OSError:  # pragma: no cover - non-Linux
        bits.append(platform.processor())
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


def default_cache_dir():
    """The compile-cache directory used when JAX_COMPILATION_CACHE_DIR is
    unset: ``<checkout>/.cache/jax/<host fingerprint>``."""
    return os.path.join(_REPO, ".cache", "jax", _host_fingerprint())


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", default_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.2.0"
