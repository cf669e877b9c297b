"""Physical constants and compile-time simulation parameters.

Equivalent of the reference's ``cuda_grmonty/consts.hpp:12-173``.  Values are
plain Python floats (f64); device code casts as needed.  All quantities are
CGS unless noted.
"""

import math

RNG_SEED = 123  # reproducibility seed (reference consts.hpp:14)

N_DIM = 4  # spacetime dimensions (t, r, theta, phi)
N_PRIM = 8  # primitive fluid variables kept from a HARM dump

# Tiny value guarding divisions.  The reference uses 1e-40 (consts.hpp:21);
# the float32 engine flushes anything below ~1.2e-38 to zero — 1e-30 keeps
# the guards alive in both dtypes (every guarded quantity is >> 1e-30 or
# exactly 0).
EPS = 1.0e-30

# ---------------------------------------------------------------------------
# Photon frequency sampling and spectrum binning (consts.hpp:23-36)
# ---------------------------------------------------------------------------
N_E_SAMP = 200  # table resolution for frequency/temperature tables
N_E_BINS = 200  # photon energy bins in the output spectrum
N_TH_BINS = 6  # observer inclination bins in the output spectrum

NU_MIN = 1.0e9  # minimum sampled photon frequency [Hz]
NU_MAX = 1.0e16  # maximum sampled photon frequency [Hz]

L_NU_MIN = math.log(NU_MIN)
L_NU_MAX = math.log(NU_MAX)
N_L_N = L_NU_MAX - L_NU_MIN  # log-frequency span
D_L_NU = (L_NU_MAX - L_NU_MIN) / N_E_SAMP  # log-frequency table step

# ---------------------------------------------------------------------------
# Electron temperature limits (consts.hpp:39-41)
# ---------------------------------------------------------------------------
THETA_E_MIN = 0.3  # min electron temperature [m_e c^2 / k_B]
THETA_E_MAX = 1000.0
TP_OVER_TE = 3.0  # proton-to-electron temperature ratio

# Russian roulette (consts.hpp:43-45)
WEIGHT_MIN = 1.0e31
ROULETTE = 1.0e4

# Spatial domain (consts.hpp:48-49)
R_MAX = 100.0
X1_MAX = math.log(R_MAX)

# Geodesic integration (consts.hpp:52-55)
STEP_EPS = 0.04  # max fractional step for geodesic integration
E_TOL = 1.0e-3  # fixed-point relative tolerance
MAX_ITER = 2  # fixed-point iterations in the implicit midpoint step
MAX_N_STEP = 1_280_000  # per-photon step cap
E_DRIFT_TOL = 1.0e-4  # conserved-energy drift triggering step halving
MAX_HALVING_DEPTH = 7  # adaptive halving recursion depth cap

# ---------------------------------------------------------------------------
# Physical constants, CGS (consts.hpp:58-83)
# ---------------------------------------------------------------------------
EE = 4.80320680e-10  # electron charge [statC]
CL = 2.99792458e10  # speed of light [cm/s]
ME = 9.1093826e-28  # electron mass [g]
MP = 1.67262171e-24  # proton mass [g]
MN = 1.67492728e-24  # neutron mass [g]
AMU = 1.66053886e-24  # atomic mass unit [g]
HPL = 6.6260693e-27  # Planck constant [erg s]
HBAR = HPL / (2.0 * math.pi)
KBOL = 1.3806505e-16  # Boltzmann constant [erg/K]
G_NEWT = 6.6742e-8  # gravitational constant
SIG_SB = 5.670400e-5  # Stefan-Boltzmann
RGAS = 8.3143e7
EV = 1.60217653e-12
SIGMA_THOMSON = 0.665245873e-24  # Thomson cross-section [cm^2]
JY = 1.0e-23

PC = 3.085678e18
AU = 1.49597870691e13

M_SUN = 1.989e33
R_SUN = 6.96e10
L_SUN = 3.827e33
T_SUN = 5.78e3
M_BH = 4.0e6 * M_SUN  # fiducial black hole mass (Sgr A*-like)

# ---------------------------------------------------------------------------
# Zone-emission (nint) table over b*theta_e^2 (consts.hpp:86-90)
# ---------------------------------------------------------------------------
NINT = 20000
BTHSQ_MIN = 1.0e-4
BTHSQ_MAX = 1.0e8
L_B_MIN = math.log(BTHSQ_MIN)
D_L_B = math.log(BTHSQ_MAX / BTHSQ_MIN) / NINT


class hotcross:
    """Angle-averaged hot Compton cross-section table (consts.hpp:95-114)."""

    MIN_W = 1.0e-12  # min photon energy [m_e c^2]
    MAX_W = 1.0e6
    MIN_T = 1.0e-4  # min electron temperature (dimensionless)
    MAX_T = 1.0e4
    N_W = 220  # photon-energy grid intervals (table has N_W+1 rows)
    N_T = 80  # temperature grid intervals (table has N_T+1 cols)

    MAX_GAMMA = 12.0  # integrate gamma_e over [1, 1 + MAX_GAMMA*theta_e]
    D_MU_E = 0.05  # pitch-cosine quadrature step
    D_GAMMA_E = 0.05  # Lorentz-factor quadrature step (units of theta_e)

    L_MIN_W = math.log10(MIN_W)
    L_MIN_T = math.log10(MIN_T)
    D_L_W = math.log10(MAX_W / MIN_W) / N_W
    D_L_T = math.log10(MAX_T / MIN_T) / N_T


class jnu:
    """Thermal synchrotron emissivity tables (consts.hpp:119-139)."""

    EPS_ABS = 0.0  # quadrature absolute tolerance
    EPS_REL = 1.0e-6  # quadrature relative tolerance

    MIN_K = 0.002  # dimensionless frequency range of the F(k) table
    MAX_K = 1.0e7
    L_MIN_K = math.log(MIN_K)
    D_L_K = math.log(MAX_K / MIN_K) / N_E_SAMP

    MIN_T = THETA_E_MIN  # temperature range of the K2 table
    MAX_T = 1.0e2
    L_MIN_T = math.log(MIN_T)
    D_L_T = math.log(MAX_T / MIN_T) / N_E_SAMP

    CST = 1.88774862536  # 2^(11/12)
    K_FAC = 9.0 * math.pi * ME * CL / EE  # nu -> dimensionless k scaling


# Emissivity prefactor sqrt(2) e^3 / (27 m_e c^2) (consts.hpp:146)
JCST = math.sqrt(2.0) * EE**3 / (27.0 * ME * CL * CL)


class spectrum:
    """Output spectrum binning (consts.hpp:153-158)."""

    D_L_E = 0.25  # log-energy bin width [ln units]
    L_E_0 = math.log(1.0e-12)  # first bin edge, energy in m_e c^2
