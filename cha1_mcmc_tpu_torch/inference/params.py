"""Parameter-vector layout.

The reference hand-unpacks tuples in three layouts:
  * 4-dim  [Ncol, Tex, vlsr, dV]               — fixed source size
    (reference inference.py:133-137)
  * 5-dim  [ss, Ncol, Tex, vlsr, dV]           — free source size
    (reference inference.py:137)
  * 14-dim [ss x4, Ncol x4, Tex, vlsr x4, dV]  — 4 velocity components with
    shared Tex/dV (reference scripts/MCMC/TMC1_four_component.py:189)

:class:`ParamSpec` generalizes these to any component count with the same
ordering convention, and provides a batched unpack on tensors. Port of
cha1_mcmc_tpu/inference/params.py.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ParamSpec"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Layout: [ss_1..ss_n]? , Ncol_1..Ncol_n , Tex , vlsr_1..vlsr_n , dV.

    The source-size block is omitted when `fixed_source_size` is set
    (reference inference.py:87-96 adjusts ndim 5 -> 4 the same way).
    """

    ncomp: int = 1
    fixed_source_size: float | None = None

    def __post_init__(self):
        if self.fixed_source_size is not None and self.ncomp != 1:
            raise ValueError("fixed source size is only defined for 1 component")

    @property
    def free_source_size(self) -> bool:
        return self.fixed_source_size is None

    @property
    def ndim(self) -> int:
        n = self.ncomp
        return (n if self.free_source_size else 0) + n + 1 + n + 1

    def unpack(self, theta):
        """theta (..., ndim) tensor -> (ss, Ncol, Tex, vlsr, dV).

        ss, Ncol, vlsr have shape (..., ncomp); Tex, dV shape (...,).
        """
        n = self.ncomp
        if self.free_source_size:
            ss = theta[..., 0:n]
            off = n
        else:
            ss = torch.full(theta.shape[:-1] + (n,), self.fixed_source_size,
                            dtype=theta.dtype, device=theta.device)
            off = 0
        Ncol = theta[..., off:off + n]
        Tex = theta[..., off + n]
        vlsr = theta[..., off + n + 1:off + 2 * n + 1]
        dV = theta[..., off + 2 * n + 1]
        return ss, Ncol, Tex, vlsr, dV

    @property
    def labels(self) -> list[str]:
        if self.ncomp == 1:
            base = ["Ncol [cm⁻²]", "Tex [K]", "vlsr [km s⁻¹]", "dV [km s⁻¹]"]
            return (["Source Size [″]"] if self.free_source_size else []) + base
        n = self.ncomp
        return (
            [f"Source Size {i+1} [″]" for i in range(n)]
            + [f"Ncol {i+1} [cm⁻²]" for i in range(n)]
            + ["Tex [K]"]
            + [f"vlsr {i+1} [km s⁻¹]" for i in range(n)]
            + ["dV [km s⁻¹]"]
        )

    @property
    def labels_latex(self) -> list[str]:
        if self.ncomp == 1:
            base = [
                r"N$_{\mathrm{col}}$ [cm$^{-2}$]",
                r"T$_{\mathrm{ex}}$ [K]",
                r"v$_{\mathrm{lsr}}$ [km s$^{-1}$]",
                r"$\Delta v$ [km s$^{-1}$]",
            ]
            return ([r'Source Size ["]'] if self.free_source_size else []) + base
        n = self.ncomp
        return (
            [rf'Source Size$_{i+1}$ ["]' for i in range(n)]
            + [rf"N$_{{\mathrm{{col}}_{i+1}}}$ [cm$^{{-2}}$]" for i in range(n)]
            + [r"T$_{\mathrm{ex}}$ [K]"]
            + [rf"v$_{{\mathrm{{lsr}}_{i+1}}}$ [km s$^{{-1}}$]" for i in range(n)]
            + [r"$\Delta v$ [km s$^{-1}$]"]
        )
