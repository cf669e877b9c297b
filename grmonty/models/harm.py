"""HARM GRMHD snapshot model: dump I/O, unit system, derived quantities.

Equivalent of the reference's dump reader and unit setup
(``cuda_grmonty/harm_model.cpp:64-232``, ``harm_data.hpp:19-143``).

A HARM dump is a whitespace text file: one header line of 25 fields followed
by ``n1 * n2`` rows of 34 columns, of which 8 primitive variables are kept
(rho, u, u^1..u^3, B^1..B^3).  The grid is 2D axisymmetric in modified
Kerr-Schild coordinates: x1 = ln r, theta = pi*x2 + (1-h_slope)/2 sin(2 pi x2).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os

import numpy as np

from grmonty import consts

log = logging.getLogger("grmonty")


@dataclasses.dataclass
class Header:
    """Dump header (reference harm_data.hpp:19-44, parse order harm_model.cpp:103-136)."""

    t: float = 0.0
    n: tuple[int, int] = (0, 0)
    x_start: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    x_stop: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    dx: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    t_final: float = 0.0
    n_step: int = 0
    a: float = 0.0  # dimensionless BH spin
    gamma: float = 0.0  # adiabatic index
    courant: float = 0.0
    dt_dump: float = 0.0
    dt_log: float = 0.0
    dt_img: float = 0.0
    dt_rdump: int = 0
    cnt_dump: int = 0
    cnt_img: int = 0
    cnt_rdump: int = 0
    dt: float = 0.0
    lim: int = 0
    failed: int = 0
    r_in: float = 0.0
    r_out: float = 0.0
    h_slope: float = 0.0
    r_0: float = 0.0


@dataclasses.dataclass
class Data:
    """Primitive fluid variables on the (n1, n2) grid, float64 numpy arrays."""

    k_rho: np.ndarray  # rest-mass density
    u: np.ndarray  # internal energy density
    u_1: np.ndarray  # velocity primitives (HARM \tilde{u}^i)
    u_2: np.ndarray
    u_3: np.ndarray
    b_1: np.ndarray  # magnetic field primitives B^i
    b_2: np.ndarray
    b_3: np.ndarray

    def stacked(self) -> np.ndarray:
        """All 8 primitives as one (8, n1, n2) array (device upload order)."""
        return np.stack(
            [self.k_rho, self.u, self.u_1, self.u_2, self.u_3, self.b_1, self.b_2, self.b_3]
        )


@dataclasses.dataclass
class Units:
    """CGS unit system derived from the mass unit (harm_model.cpp:64-79,139-141)."""

    mass_unit: float
    l_unit: float
    t_unit: float
    rho_unit: float
    u_unit: float
    b_unit: float
    n_e_unit: float
    theta_e_unit: float = 0.0  # set once the header's adiabatic index is known


def make_units(mass_unit: float) -> Units:
    l_unit = consts.G_NEWT * consts.M_BH / (consts.CL * consts.CL)
    rho_unit = mass_unit / l_unit**3
    return Units(
        mass_unit=mass_unit,
        l_unit=l_unit,
        t_unit=l_unit / consts.CL,
        rho_unit=rho_unit,
        u_unit=rho_unit * consts.CL * consts.CL,
        b_unit=consts.CL * math.sqrt(4.0 * math.pi * rho_unit),
        n_e_unit=rho_unit / (consts.MP + consts.ME),
    )


def theta_e_unit(gamma: float) -> float:
    """Two-temperature electron temperature unit (harm_model.cpp:139-141)."""
    two_temp_gamma = 0.5 * (
        (1.0 + 2.0 / 3.0 * (consts.TP_OVER_TE + 1.0) / (consts.TP_OVER_TE + 2.0)) + gamma
    )
    return (two_temp_gamma - 1.0) * (consts.MP / consts.ME) / (1.0 + consts.TP_OVER_TE)


@dataclasses.dataclass
class HARMModel:
    """A parsed HARM snapshot plus the derived quantities the transport needs."""

    header: Header
    data: Data
    units: Units
    bias_norm: float  # volume-averaged (u/rho * theta_e_unit)^2, harm_model.cpp:206,219
    d_mact: float  # accretion-rate diagnostic, harm_model.cpp:209-221
    l_adv: float  # advected-luminosity diagnostic, harm_model.cpp:212-223
    rh: float  # event horizon radius 1 + sqrt(1 - a^2)
    x1_min: float  # ln(rh): inner tracking boundary

    @property
    def max_tau_scatt_init(self) -> float:
        """Initial bias normalisation depth 6 * l_unit * rho_unit * 0.4 (harm_model.cpp:72)."""
        return 6.0 * self.units.l_unit * self.units.rho_unit * 0.4

    @property
    def d_tau_k(self) -> float:
        """Optical-depth conversion per unit affine parameter (harm_model.cpp:73)."""
        return 2.0 * math.pi * self.units.l_unit / (
            consts.ME * consts.CL * consts.CL / consts.HBAR
        )


def _parse_header(line: str) -> Header:
    tok = line.split()
    f = [float(t) for t in tok]
    h = Header()
    h.t = f[0]
    n1, n2 = int(f[1]), int(f[2])
    h.n = (n1, n2)
    x_start1, x_start2 = f[3], f[4]
    dx1, dx2 = f[5], f[6]
    # Derived grid extents exactly as the reference (harm_model.cpp:106-117):
    h.x_start = (0.0, x_start1, x_start2, 0.0)
    h.dx = (1.0, dx1, dx2, 2.0 * math.pi)
    h.x_stop = (1.0, x_start1 + n1 * dx1, x_start2 + n2 * dx2, 2.0 * math.pi)
    h.t_final = f[7]
    h.n_step = int(f[8])
    h.a = f[9]
    h.gamma = f[10]
    h.courant = f[11]
    h.dt_dump = f[12]
    h.dt_log = f[13]
    h.dt_img = f[14]
    h.dt_rdump = int(f[15])
    h.cnt_dump = int(f[16])
    h.cnt_img = int(f[17])
    h.cnt_rdump = int(f[18])
    h.dt = f[19]
    h.lim = int(f[20])
    h.failed = int(f[21])
    h.r_in = f[22]
    h.r_out = f[23]
    h.h_slope = f[24]
    h.r_0 = f[25] if len(f) > 25 else 0.0
    return h


# Column layout of a dump row (34 columns, harm_model.cpp:185-204):
#  0: x1   1: x2   2: r   3: h
#  4..11: k_rho u u_1 u_2 u_3 b_1 b_2 b_3   (the 8 primitives we keep)
# 12: div_b
# 13..16: u_con   17..20: u_cov   21..24: b_con   25..28: b_cov
# 29..32: vmin[0] vmax[0] vmin[1] vmax[1]
# 33: g_det
_N_COLS = 34


def _parse_body(text: str, n_cells: int) -> np.ndarray:
    from grmonty.models import harmio_native

    arr = harmio_native.parse_doubles(text)
    if arr is None:  # native parser unavailable -> numpy fallback
        arr = np.fromstring(text, dtype=np.float64, sep=" ")
    if arr.size != n_cells * _N_COLS:
        raise ValueError(
            f"HARM dump body has {arr.size} values, expected {n_cells}x{_N_COLS}"
        )
    return arr.reshape(n_cells, _N_COLS)


def read_dump(filepath: str, mass_unit: float) -> HARMModel:
    """Read a HARM dump file (reference read_file, harm_model.cpp:81-232)."""
    log.info("Reading HARM dump %s", filepath)
    if not os.path.exists(filepath):
        raise FileNotFoundError(f"File does not exist {filepath}")

    with open(filepath) as fh:
        first = fh.readline()
        rest = fh.read()

    header = _parse_header(first)
    n1, n2 = header.n
    n_cells = n1 * n2

    units = make_units(mass_unit)
    units.theta_e_unit = theta_e_unit(header.gamma)

    body = _parse_body(rest, n_cells)

    prims = body[:, 4:12].reshape(n1, n2, 8)
    data = Data(*[np.ascontiguousarray(prims[:, :, i]) for i in range(8)])

    # Volume-averaged bias normalisation and diagnostics (harm_model.cpp:142-223).
    g_det = body[:, 33].reshape(n1, n2)
    u_con = body[:, 13:17].reshape(n1, n2, 4)
    d_v = header.dx[1] * header.dx[2] * header.dx[3]

    w = g_det * (data.u / data.k_rho * units.theta_e_unit) ** 2
    v_tot = d_v * g_det.sum()
    bias_norm = d_v * w.sum() / v_tot

    d_mact = (g_det[:21] * data.k_rho[:21] * u_con[:21, :, 1]).sum()
    l_adv = (g_det[20:40] * data.u[20:40] * u_con[20:40, :, 1] * u_con[20:40, :, 0]).sum()
    d_mact *= header.dx[3] * header.dx[2] / 21.0
    l_adv *= header.dx[3] * header.dx[2] / 21.0
    log.debug("d_mact=%g l_adv=%g", d_mact, l_adv)

    rh = 1.0 + math.sqrt(max(0.0, 1.0 - header.a * header.a))

    log.info("Reading HARM dump done (%dx%d zones, a=%.4f)", n1, n2, header.a)
    return HARMModel(
        header=header,
        data=data,
        units=units,
        bias_norm=bias_norm,
        d_mact=d_mact,
        l_adv=l_adv,
        rh=rh,
        x1_min=math.log(rh),
    )


def write_dump(filepath: str, header: Header, data: Data, extras: np.ndarray | None = None):
    """Write a HARM dump (used by tests and the synthetic torus generator).

    ``extras`` optionally supplies the 22 trailing diagnostic columns
    (div_b..g_det) as an (n1*n2, 22) array; zeros otherwise.  This mirrors
    the reference's test fixture writer (tests/harm_model_test.cpp:224-262),
    which doubles as the executable spec of the format.
    """
    h = header
    n1, n2 = h.n
    hdr = (
        f"{h.t} {n1} {n2} {h.x_start[1]} {h.x_start[2]} {h.dx[1]} {h.dx[2]} "
        f"{h.t_final} {h.n_step} {h.a} {h.gamma} {h.courant} {h.dt_dump} "
        f"{h.dt_log} {h.dt_img} {h.dt_rdump} {h.cnt_dump} {h.cnt_img} "
        f"{h.cnt_rdump} {h.dt} {h.lim} {h.failed} {h.r_in} {h.r_out} "
        f"{h.h_slope} {h.r_0}"
    )
    rows = np.zeros((n1 * n2, _N_COLS))
    rows[:, 4:12] = data.stacked().reshape(8, -1).T
    if extras is not None:
        rows[:, 12:34] = extras
    with open(filepath, "w") as fh:
        fh.write(hdr + "\n")
        np.savetxt(fh, rows, fmt="%.17g")
