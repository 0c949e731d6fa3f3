"""Posterior visualization and tabulation.

Equivalent of reference plot_results (reference inference.py:491-581):
20% burn-in discard, corner plot with 16/50/84 quantiles and adaptive
scientific-notation titles, optional trace plots, and a tabulated summary
of median +- asymmetric uncertainties. The `corner` package is replaced by
a self-contained matplotlib pair-plot (same panels: diagonal histograms
with quantile lines, lower-triangle 2D histograms).

Port of cha1_mcmc_tpu/pipeline/plotting.py. matplotlib and tabulate are
optional here: the summary table falls back to plain prints, and the
corner plot is written only where matplotlib imports.
"""

from __future__ import annotations

import numpy as np

from cha1_mcmc_tpu_torch.constants import GRAY, RESET
from cha1_mcmc_tpu_torch.sampler.diagnostics import summarize_convergence

__all__ = ["plot_results", "summarize_posterior", "corner_plot", "report_convergence"]


def _mpl():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    matplotlib.rcParams["text.usetex"] = False
    import matplotlib.pyplot as plt

    return plt


def _flatten_chain(chain: np.ndarray, burn_in_frac: float = 0.2) -> np.ndarray:
    """Discard burn-in and flatten to (W*S', D) (reference inference.py:501-506)."""
    burn_in = int(burn_in_frac * chain.shape[1])
    return chain[:, burn_in:, :].reshape((-1, chain.shape[-1]))


def _title(samples_1d: np.ndarray) -> str:
    """Adaptive sci-notation quantile title (reference inference.py:517-536;
    a zero median — where log10 diverges — falls back to plain formatting)."""
    p16, p50, p84 = np.percentile(samples_1d, [16, 50, 84])
    lower, upper = p50 - p16, p84 - p50
    if p50 != 0.0 and (abs(p50) < 1e-3 or abs(p50) > 1e3):
        exp = int(np.floor(np.log10(abs(p50))))
        scale = 10.0 ** exp
        return (f"({p50 / scale:.2f}_-{lower / scale:.2f}^+{upper / scale:.2f})"
                f"x10^{exp}")
    return f"{p50:.2f}^+{upper:.2f}_-{lower:.2f}"


def summarize_posterior(chain: np.ndarray, param_labels: list[str],
                        burn_in_frac: float = 0.2, print_table: bool = True):
    """Median and asymmetric 16/84 uncertainties per parameter
    (reference inference.py:564-581). Returns list of
    (label, median, lower, upper)."""
    samples = _flatten_chain(chain, burn_in_frac)
    rows = []
    for i, label in enumerate(param_labels[: samples.shape[1]]):
        p16, p50, p84 = np.percentile(samples[:, i], [16, 50, 84])
        rows.append((label, p50, p50 - p16, p84 - p50))
    if print_table:
        try:
            from tabulate import tabulate

            table = []
            for label, med, lo, up in rows:
                fmt = ".2e" if (abs(med) < 1e-3 or abs(med) > 1e3) else ".5f"
                table.append([label, f"{med:{fmt}}", f"{lo:{fmt}}", f"{up:{fmt}}"])
            headers = ["Parameter", "Median Estimate", "Lower Uncertainty",
                       "Upper Uncertainty"]
            print("\n" + tabulate(table, headers=headers, tablefmt="grid",
                                  colalign=["center"] * 4) + "\n")
        except ImportError:
            for label, med, lo, up in rows:
                print(f"{label}: {med:.6g} -{lo:.3g} +{up:.3g}")
    return rows


def report_convergence(chain: np.ndarray, param_labels: list[str], n_chains: int) -> dict:
    """summarize_convergence of a multi-chain fit's pooled (K*W, S, D)
    chain, with its cross-chain R-hat printed per parameter (JAX
    fit.py:379-385)."""
    conv = summarize_convergence(chain)
    rhat = ", ".join(f"{lbl}={r:.3f}" for lbl, r in zip(param_labels, conv["r_hat"]))
    print(f"{GRAY}Cross-chain R-hat ({n_chains} chains): {rhat}{RESET}")
    return conv


def corner_plot(samples: np.ndarray, labels_latex: list[str], bins: int = 40):
    """Self-contained corner-style pair plot (replaces the `corner` package).

    Uses mathtext (not an external TeX install) regardless of global
    rcParams; the reference instead requires usetex (inference.py:493).
    """
    plt = _mpl()
    if plt is None:
        raise ImportError("corner_plot needs matplotlib")

    ndim = samples.shape[1]
    fig, axes = plt.subplots(ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim))
    axes = np.atleast_2d(axes)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(samples[:, i], bins=bins, color="k", histtype="step")
                for q in np.percentile(samples[:, i], [16, 50, 84]):
                    ax.axvline(q, color="k", ls="--", lw=0.8)
                ax.set_title(f"{labels_latex[i]}: {_title(samples[:, i])}", fontsize=9)
                ax.set_yticks([])
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins, cmap="Greys")
            if i < ndim - 1:
                ax.set_xticklabels([])
            else:
                ax.set_xlabel(labels_latex[j], fontsize=9)
            if j > 0 or i == 0:
                ax.set_yticklabels([])
            elif i > 0:
                ax.set_ylabel(labels_latex[i], fontsize=9)
    fig.tight_layout()
    return fig


def plot_results(chain_path: str, param_labels: list[str],
                 param_labels_latex: list[str] | None = None,
                 include_trace: bool = False, burn_in_frac: float = 0.2,
                 dpi: int = 200):
    """Summary table, plus the corner plot (<chain>_corner.png) and
    optional trace plots where matplotlib imports (reference
    inference.py:491-581). Prints which of the two happened."""
    plt = _mpl()

    chain = np.load(chain_path)
    samples = _flatten_chain(chain, burn_in_frac)
    ndim = samples.shape[1]
    labels = list(param_labels)[:ndim]
    labels_latex = list(param_labels_latex or param_labels)[:ndim]

    if plt is None:
        print(f"\n{GRAY}matplotlib is not installed: no corner plot; "
              f"summary table only.{RESET}")
        return summarize_posterior(chain, labels, burn_in_frac)

    fig = corner_plot(samples, labels_latex)
    out = f"{chain_path[:-4]}_corner.png"
    print(f"\n{GRAY}Saving corner plot to {out}{RESET}")
    fig.savefig(out, dpi=dpi)
    plt.close(fig)

    if include_trace:
        burn_in = int(burn_in_frac * chain.shape[1])
        trimmed = chain[:, burn_in:, :]
        fig, axes = plt.subplots(nrows=ndim, figsize=(10, 2 * ndim), squeeze=False)
        for i in range(ndim):
            ax = axes[i, 0]
            ax.plot(trimmed[:, :, i].T, color="k", alpha=0.3)
            ax.set_title(f"Parameter {i + 1}: {labels_latex[i]}")
            ax.set_xlabel("Step Number")
        fig.tight_layout()
        fig.savefig(f"{chain_path[:-4]}_trace.png", dpi=dpi)
        plt.close(fig)

    return summarize_posterior(chain, labels, burn_in_frac)
