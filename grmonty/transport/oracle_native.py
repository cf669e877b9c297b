"""ctypes binding for the native C++ validation oracle (native/oracle.cpp).

``NativeTracker`` mirrors :class:`cpu_reference.CPUTracker`'s interface
(same constructor arguments, same ``run``/``spec``/``n_recorded`` surface)
but runs the identical scalar physics ~10^4-10^5x faster: the Python oracle
pays ~1 ms of JAX dispatch per photon step, which makes a 2,000-photon
validation run a ~20-hour job; the C++ mirror does it in seconds, so
oracle-based accuracy gates (M_unit sweeps, large-N oracle spectra) become
interactive.

Parity is enforced by tests/test_oracle_native.py: every deterministic
sub-function is compared against the JAX ops at ~1e-10 relative via
``oracle_probe``, the samplers are compared distributionally, and a full
tracked batch is compared statistically against the Python oracle.

Built on demand with g++ into a hash-keyed cache (same pattern as
models/harmio_native.py); raises at construction if the toolchain is
unavailable — unlike the dump parser there is no slow fallback worth
hiding behind (the Python oracle IS the fallback, and the caller should
choose it explicitly).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

from grmonty import consts

log = logging.getLogger("grmonty")

_lock = threading.Lock()
_lib = None

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "oracle.cpp")

N_SPEC_CHAN = 16
PROBE_LEN = 128


class _Consts(ctypes.Structure):
    _fields_ = [
        ("a", ctypes.c_double),
        ("h_slope", ctypes.c_double),
        ("r_0", ctypes.c_double),
        ("x_start", ctypes.c_double * 4),
        ("x_stop", ctypes.c_double * 4),
        ("dx", ctypes.c_double * 4),
        ("n1", ctypes.c_int64),
        ("n2", ctypes.c_int64),
        ("n_e_unit", ctypes.c_double),
        ("theta_e_unit", ctypes.c_double),
        ("b_unit", ctypes.c_double),
        ("x1_min", ctypes.c_double),
        ("bias_norm", ctypes.c_double),
        ("d_tau_k", ctypes.c_double),
        ("max_tau_scatt0", ctypes.c_double),
        # frozen-bias comparison mode (0 = live feedback counters)
        ("bias_fixed_tau", ctypes.c_double),
        ("bias_fixed_avg", ctypes.c_double),
    ]


class _Out(ctypes.Structure):
    _fields_ = [
        ("max_tau_scatt", ctypes.c_double),
        ("n_recorded", ctypes.c_int64),
        ("n_scatt_rec", ctypes.c_int64),
    ]


def _so_path():
    import hashlib

    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get(
        "GRMONTY_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "grmonty_native"),
    )
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"liboracle_{h}.so")


_DP = ctypes.POINTER(ctypes.c_double)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", so, _SRC],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(so)
        lib.oracle_run.restype = ctypes.c_int
        # 12 double pointers: hc, k2, prims, x, k, w, e, l, n_e_0,
        # theta_e_0, b_0, e_0
        lib.oracle_run.argtypes = (
            [ctypes.POINTER(_Consts)] + [_DP] * 12
            + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_uint64,
               _DP, ctypes.POINTER(_Out), ctypes.c_int64]
        )
        lib.oracle_probe.restype = ctypes.c_int
        lib.oracle_probe.argtypes = (
            [ctypes.POINTER(_Consts)] + [_DP] * 6
            + [ctypes.c_double, ctypes.c_double, _DP]
        )
        lib.oracle_sample_electron.restype = ctypes.c_int
        lib.oracle_sample_electron.argtypes = [
            ctypes.POINTER(_Consts), _DP, ctypes.c_double, ctypes.c_uint64,
            ctypes.c_int64, _DP,
        ]
        lib.oracle_sample_scattered.restype = ctypes.c_int
        lib.oracle_sample_scattered.argtypes = [
            ctypes.POINTER(_Consts), _DP, _DP, ctypes.c_uint64,
            ctypes.c_int64, _DP,
        ]
        _lib = lib
        return _lib


def _c_consts(mc) -> _Consts:
    c = _Consts()
    c.a = float(mc.a)
    c.h_slope = float(mc.h_slope)
    c.r_0 = float(mc.r_0)
    for i in range(4):
        c.x_start[i] = float(mc.x_start[i])
        c.x_stop[i] = float(mc.x_stop[i])
        c.dx[i] = float(mc.dx[i])
    c.n1 = int(mc.n1)
    c.n2 = int(mc.n2)
    c.n_e_unit = float(mc.n_e_unit)
    c.theta_e_unit = float(mc.theta_e_unit)
    c.b_unit = float(mc.b_unit)
    c.x1_min = float(mc.x1_min)
    c.bias_norm = float(mc.bias_norm)
    c.d_tau_k = float(mc.d_tau_k)
    c.max_tau_scatt0 = float(mc.max_tau_scatt0)
    return c


def _f64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _ptr(a):
    return a.ctypes.data_as(_DP)


class NativeTracker:
    """Drop-in native counterpart of cpu_reference.CPUTracker."""

    def __init__(self, mc, tables, prims, seed=consts.RNG_SEED,
                 bias_fixed=None):
        self._lib = _load()
        self.mc = mc
        self._c = _c_consts(mc)
        if bias_fixed is not None:
            # (tau, avg): pin the bias normalization for the frozen-bias
            # comparison mode (see Consts.bias_fixed_tau in oracle.cpp)
            self._c.bias_fixed_tau = float(bias_fixed[0])
            self._c.bias_fixed_avg = float(bias_fixed[1])
        self._hc = _f64(tables.hotcross)
        assert self._hc.shape == (221, 81), self._hc.shape
        self._k2 = _f64(tables.k2_table)
        assert self._k2.shape == (201,), self._k2.shape
        self._prims = _f64(prims)
        assert self._prims.shape == (8, mc.n1, mc.n2), self._prims.shape
        self.seed = int(seed)
        self.spec = np.zeros((consts.N_TH_BINS, consts.N_E_BINS, N_SPEC_CHAN))
        self.n_recorded = 0
        self.n_scatt_rec = 0
        self.max_tau_scatt = float(mc.max_tau_scatt0)
        # IN/OUT counter block: carries the bias-feedback state across
        # chunked run() calls (mirrors CPUTracker's persistent attributes)
        self._out = _Out(float(mc.max_tau_scatt0), 0, 0)
        self._calls = 0

    def run(self, init_photons, limit=None, progress_every=1000):
        """Track an InitPhotons batch (host numpy); accumulates into .spec."""
        n = init_photons.w.shape[0]
        if limit is not None:
            n = min(limit, n)
        x = _f64(init_photons.x[:n])
        k = _f64(init_photons.k[:n])
        args1 = [_f64(np.asarray(getattr(init_photons, f))[:n])
                 for f in ("w", "e", "l", "n_e_0", "theta_e_0", "b_0", "e_0")]
        n_scatt = np.ascontiguousarray(
            np.asarray(init_photons.n_scatt)[:n], dtype=np.int32)
        # distinct stream per chunked call; state carries via self._out
        seed = self.seed + 0x9E37_79B9 * self._calls
        self._calls += 1
        rc = self._lib.oracle_run(
            ctypes.byref(self._c), _ptr(self._hc), _ptr(self._k2),
            _ptr(self._prims), _ptr(x), _ptr(k), *[_ptr(a) for a in args1],
            n_scatt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, seed, _ptr(self.spec), ctypes.byref(self._out),
            int(progress_every),
        )
        if rc != 0:
            raise RuntimeError(f"oracle_run failed rc={rc}")
        self.n_recorded = int(self._out.n_recorded)
        self.n_scatt_rec = int(self._out.n_scatt_rec)
        self.max_tau_scatt = float(self._out.max_tau_scatt)
        return self.spec

    # ---- test hooks -----------------------------------------------------
    def probe(self, x, k, dk, e0s, dl):
        """All deterministic sub-functions at one state (see oracle.cpp)."""
        out = np.zeros(PROBE_LEN)
        rc = self._lib.oracle_probe(
            ctypes.byref(self._c), _ptr(self._hc), _ptr(self._k2),
            _ptr(self._prims), _ptr(_f64(x)), _ptr(_f64(k)), _ptr(_f64(dk)),
            float(e0s), float(dl), _ptr(out),
        )
        if rc != 0:
            raise RuntimeError(f"oracle_probe failed rc={rc}")
        return out

    def sample_electron(self, k_tet, theta_e, n, seed=1):
        out = np.zeros((n, 4))
        self._lib.oracle_sample_electron(
            ctypes.byref(self._c), _ptr(_f64(k_tet)), float(theta_e),
            int(seed), int(n), _ptr(out.reshape(-1)),
        )
        return out

    def sample_scattered(self, k_tet, p, n, seed=1):
        out = np.zeros((n, 4))
        self._lib.oracle_sample_scattered(
            ctypes.byref(self._c), _ptr(_f64(k_tet)), _ptr(_f64(p)),
            int(seed), int(n), _ptr(out.reshape(-1)),
        )
        return out
