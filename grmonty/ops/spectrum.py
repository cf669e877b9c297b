"""Spectrum post-processing and text report.

Equivalent of ``HARMModel::report_spectrum`` (``harm_model.cpp:416-471``).
The accumulator layout is (N_TH_BINS * N_E_BINS + 1, 13) — see
``transport.engine`` for the channel order; the last row is the masked-
scatter dump and is ignored here.  The text format is column-compatible with
the reference (and with upstream grmonty's spectrum files): 200 rows of
1 + 6*6 columns.
"""

import math

import numpy as np

from grmonty import consts
from grmonty.ops import geometry

# accumulator channel indices (channel 13, DE2 = sum((w*e)^2), is the MC
# variance accumulator for DE_DLE — not in the reference's 13-field struct)
DN_DLE, DE_DLE, NPH, NSCATT, X1I_AV, X2I_SQ, X3F_SQ, TAU_ABS, TAU_SCATT, NE_0, THETA_E_0, B_0, E_0, DE2 = range(14)


def spectrum_rows(spec, mc):
    """Physical per-bin quantities from raw accumulators.

    Returns a dict of (N_TH_BINS, N_E_BINS) arrays plus scalars
    (luminosity, max mean scattering depth).
    """
    s = np.asarray(spec)[: consts.N_TH_BINS * consts.N_E_BINS]
    s = s.reshape(consts.N_TH_BINS, consts.N_E_BINS, -1)

    dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
    j = np.arange(consts.N_TH_BINS)
    d_omega = 2.0 * np.asarray(
        geometry.d_omega(j * dx2, (j + 1) * dx2, mc.h_slope)
    )

    nu_lnu = (
        (consts.ME * consts.CL**2)
        * (4.0 * math.pi / d_omega)[:, None]
        / consts.spectrum.D_L_E
        * s[:, :, DE_DLE]
        / consts.L_SUN
    )
    denom = s[:, :, DN_DLE] + consts.EPS
    tau_abs = s[:, :, TAU_ABS] / denom
    tau_scatt = s[:, :, TAU_SCATT] / denom
    x1i_av = s[:, :, X1I_AV] / denom
    x2i_rms = np.sqrt(np.abs(s[:, :, X2I_SQ] / denom))
    x3f_rms = np.sqrt(np.abs(s[:, :, X3F_SQ] / denom))

    luminosity = float((nu_lnu * d_omega[:, None] * consts.spectrum.D_L_E).sum())
    return {
        "nu_lnu": nu_lnu,
        "tau_abs": tau_abs,
        "tau_scatt": tau_scatt,
        "x1i_av": x1i_av,
        "x2i_rms": x2i_rms,
        "x3f_rms": x3f_rms,
        "luminosity": luminosity,
        "max_tau_scatt": float(tau_scatt.max()),
        "raw": s,
    }


def format_spectrum(spec, mc) -> str:
    """Render the reference's text format (harm_model.cpp:433-464)."""
    rows = spectrum_rows(spec, mc)
    out = []
    for i in range(consts.N_E_BINS):
        cols = [
            "%10.5g " % ((i * consts.spectrum.D_L_E + consts.spectrum.L_E_0) / math.log(10.0))
        ]
        for j in range(consts.N_TH_BINS):
            cols.append("%10.5g " % rows["nu_lnu"][j, i])
            cols.append("%10.5g " % rows["tau_abs"][j, i])
            cols.append("%10.5g " % rows["tau_scatt"][j, i])
            cols.append("%10.5g " % rows["x1i_av"][j, i])
            cols.append("%10.5g " % rows["x2i_rms"][j, i])
            cols.append("%10.5g " % rows["x3f_rms"][j, i])
        out.append("".join(cols))
    return "\n".join(out) + "\n"


def write_spectrum(path, spec, mc):
    with open(path, "w") as fh:
        fh.write(format_spectrum(spec, mc))
    return spectrum_rows(spec, mc)
