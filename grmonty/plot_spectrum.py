"""Plot a grmonty spectrum file.

Equivalent of the reference's ``plot_spectrum.py`` (which shells out to the
nmmn package's grmonty parser); this version parses the text format directly
so it has no exotic dependencies.  Usage:

    python -m grmonty.plot_spectrum --spectrum_path spectrum \\
        --plot_path spectrum.png [--i_bin 3]
"""

import argparse
import math

import numpy as np

from grmonty import consts

ME_C2 = consts.ME * consts.CL * consts.CL


def load_spectrum(path):
    """Parse a spectrum text file -> (log10_nu, nu_lnu[th_bin, e_bin], extras).

    Column layout per row (harm_model.cpp:433-455): log10(E/me c^2), then 6
    columns per inclination bin: nuLnu/Lsun, tau_abs, tau_scatt, x1i_av,
    x2i_rms, x3f_rms.
    """
    data = np.loadtxt(path)
    l_e = data[:, 0]  # log10 of photon energy in electron rest-mass units
    log_nu = l_e + math.log10(ME_C2 / consts.HPL)
    n_bins = (data.shape[1] - 1) // 6
    nu_lnu = np.stack([data[:, 1 + 6 * j] for j in range(n_bins)], axis=0)
    extras = {
        "tau_abs": np.stack([data[:, 2 + 6 * j] for j in range(n_bins)]),
        "tau_scatt": np.stack([data[:, 3 + 6 * j] for j in range(n_bins)]),
    }
    return log_nu, nu_lnu, extras


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spectrum_path", type=str, required=True)
    parser.add_argument("--plot_path", type=str, required=True)
    parser.add_argument("--i_bin", type=int, default=-1,
                        help="inclination bin to plot (-1 = all)")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    log_nu, nu_lnu, _ = load_spectrum(args.spectrum_path)
    fig, ax = plt.subplots(figsize=(7, 5))
    bins = range(nu_lnu.shape[0]) if args.i_bin < 0 else [args.i_bin]
    for j in bins:
        mask = nu_lnu[j] > 0
        ax.plot(log_nu[mask], np.log10(nu_lnu[j][mask] * consts.L_SUN),
                label=f"bin {j}")
    ax.set_xlabel(r"$\log_{10} \nu$ [Hz]")
    ax.set_ylabel(r"$\log_{10} \nu L_\nu$ [erg/s]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.plot_path, dpi=150)
    print(f"wrote {args.plot_path}")


if __name__ == "__main__":
    main()
