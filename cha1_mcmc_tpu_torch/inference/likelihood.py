"""Likelihood and posterior log-probability functions, batched over walkers.

Port of cha1_mcmc_tpu/inference/likelihood.py. `build_lnlike` /
`build_lnprob` evaluate the dense forward model; the JAX package returns
scalar functions that callers vmap, here they return explicitly batched
(N, D) -> (N,) functions, so one call evaluates every proposal of a
half-step. `build_lnprob_batched` / `build_lnlike_batched` add the choice
of opacity formulation: dense, or the channel-major gather tables of
models/sparse_opacity.py (the multifit's general path). The Pallas
block-sparse and CSR formulations (`pallas_kernel="block"` / `"csr"`)
are ROADMAP P11 and raise NotImplementedError here.

Failure semantics: the reference converts exceptions and non-finite values
to -inf so the sampler rejects the proposal (reference inference.py:145-147,
153-155, 162-164, 241-245); here non-finite values map to -inf.
"""

from __future__ import annotations

import torch

from cha1_mcmc_tpu_torch.models.forward import SpectralModel
from cha1_mcmc_tpu_torch.models.sparse_opacity import (
    build_opacity_gather, build_opacity_gather_split, opacity_gather,
    opacity_gather_split)
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu_torch.inference.params import ParamSpec

__all__ = ["build_lnlike", "build_lnprob", "build_lnlike_batched",
           "build_lnprob_batched", "batched_model_gather",
           "batched_model_gather_split"]


def _rt_tail(opac, ss, Tex, grid_freq, dish_size, Tbg):
    """Radiative transfer + beam dilution over per-component opacity
    (reference inference.py:54-60): (N, K, C) opacity -> (N, C) model."""
    J_T = planck_J(torch, grid_freq, Tex[:, None, None], guard=1e-10)
    J_Tbg = planck_J(torch, grid_freq, Tbg, guard=1e-10)
    dil = beam_dilution(torch, grid_freq, ss[..., None], dish_size)
    return torch.sum(dil * (J_T - J_Tbg) * (1.0 - torch.exp(-opac)), dim=1)


def _batched_opacity_model(opacity_fn, line_freq, line_elower, line_aij,
                           line_gup, line_glow, q_fn, grid_freq, dish_size,
                           Tbg, spec, thetas):
    """Walker-batched body shared by the opacity formulations: unpack
    theta, per-line stick opacities, the formulation's opacity
    (`opacity_fn` over the (N*K)-flattened taus/vlsr/dV), then the
    radiative-transfer tail. The line arrays are whatever subset
    `opacity_fn` was built against; `q_fn` maps Tex (N,) to Q (N,)."""
    N = thetas.shape[0]
    K = spec.ncomp
    ss, Ncol, Tex, vlsr, dV = spec.unpack(thetas)
    Q = q_fn(Tex)
    taus = tau_sticks(torch, line_freq, line_elower, line_aij, line_gup,
                      line_glow, Q[:, None, None], Ncol[..., None],
                      Tex[:, None, None], dV[:, None, None])      # (N, K, L)
    opac = opacity_fn(taus.reshape(N * K, -1), vlsr.reshape(N * K),
                      dV[:, None].expand(N, K).reshape(N * K)).reshape(N, K, -1)
    return _rt_tail(opac, ss, Tex, grid_freq, dish_size, Tbg)


def batched_model_gather(line_freq, line_elower, line_aij, line_gup,
                         line_glow, q_fn, grid_freq, mask_center, dish_size,
                         Tbg, spec, thetas, line_table, vel_t):
    """(N, C) walker-batched forward model via the channel-major gather
    opacity (models/sparse_opacity.py:opacity_gather). The line arrays are
    the *active subset* selected by build_opacity_gather."""
    return _batched_opacity_model(
        lambda t, v, d: opacity_gather(t, v, d, line_table, vel_t,
                                       mask_center=mask_center),
        line_freq, line_elower, line_aij, line_gup, line_glow, q_fn,
        grid_freq, dish_size, Tbg, spec, thetas)


def batched_model_gather_split(line_freq, line_elower, line_aij, line_gup,
                               line_glow, q_fn, grid_freq, mask_center,
                               dish_size, Tbg, spec, thetas, split_tables):
    """(N, C) walker-batched forward model via the two-class split gather
    (models/sparse_opacity.py:opacity_gather_split); split_tables =
    (table1, vel1, table2, vel2, heavy). The line arrays are the active
    subset from build_opacity_gather_split."""
    table1, vel1, table2, vel2, heavy = split_tables
    return _batched_opacity_model(
        lambda t, v, d: opacity_gather_split(
            t, v, d, table1, vel1, table2, vel2, heavy,
            mask_center=mask_center),
        line_freq, line_elower, line_aij, line_gup, line_glow, q_fn,
        grid_freq, dish_size, Tbg, spec, thetas)


def build_lnlike(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs):
    """Batched lnlike(thetas (N, D)) -> (N,) (reference inference.py:127-166).

    chi^2 form: -0.5 * sum[(y - m)^2 / sigma^2 - ln(1/sigma^2)].
    """
    y = torch.as_tensor(grid_ints, dtype=model.dtype, device=model.device)
    yerrs = torch.as_tensor(grid_yerrs, dtype=model.dtype, device=model.device)
    inv_sigma2 = 1.0 / (yerrs ** 2)

    def lnlike(thetas):
        ss, Ncol, Tex, vlsr, dV = spec.unpack(thetas)
        m = model(ss, Ncol, Tex, vlsr, dV)
        ll = model.chi2_lnlike(m, y, inv_sigma2)
        # Non-finite model/likelihood -> reject (reference inference.py:162-164).
        return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))

    return lnlike


def build_lnprob(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs,
                 lnprior_fn):
    """Batched lnprob(thetas (N, D)) = lnprior + lnlike -> (N,)
    (reference inference.py:239-246).

    Both terms are computed for every walker and -inf propagates through
    the sum, with a guard so that -inf prior + NaN likelihood still yields
    -inf.
    """
    lnlike = build_lnlike(model, spec, grid_ints, grid_yerrs)

    def lnprob(thetas):
        lp = lnprior_fn(thetas)
        ll = lnlike(thetas)
        total = lp + ll
        return torch.where(torch.isfinite(lp) & torch.isfinite(ll), total,
                           torch.full_like(total, -torch.inf))

    return lnprob


def _build_batched_model(model: SpectralModel, spec: ParamSpec, *,
                         use_pallas: bool = False, dv_max: float | None = None,
                         pallas_kernel: str = "gather"):
    """Batched forward model, thetas (N, D) -> (N, C): the dense
    model, or (use_pallas=True, pallas_kernel="gather") the channel-major
    gather tables built for the prior's dV bound `dv_max` — the split
    tables where they save >= 1.3x of the element work."""
    if not use_pallas:
        def model_batch(thetas):
            return model(*spec.unpack(thetas))
        return model_batch
    if pallas_kernel != "gather":
        raise NotImplementedError(
            f"pallas_kernel={pallas_kernel!r}: the Pallas block-sparse and CSR "
            "opacity kernels (K4a/K4b) are ROADMAP P11, not ported yet")
    if dv_max is None:
        raise ValueError("use_pallas=True requires dv_max (from prior bounds)")
    def index(a):
        return torch.as_tensor(a, dtype=torch.long, device=model.device)

    def vel(a):
        return torch.as_tensor(a, dtype=model.dtype, device=model.device)

    vel_grid = model.vel_grid.cpu().numpy()
    split = build_opacity_gather_split(vel_grid, model.mask_center, dv_max)
    if split is not None:
        t1, v1, t2, v2, heavy, active = split
        tables = (index(t1), vel(v1), index(t2), vel(v2), index(heavy))
    else:
        table, vel_t, active = build_opacity_gather(vel_grid, model.mask_center,
                                                    dv_max)
        table, vel_t = index(table), vel(vel_t)
    lines = tuple(getattr(model, name)[index(active)] for name in
                  ("line_freq", "line_elower", "line_aij", "line_gup", "line_glow"))
    common = (model.q, model.grid_freq, model.mask_center, model.dish_size,
              model.Tbg, spec)

    def model_batch(thetas):
        if split is not None:
            return batched_model_gather_split(*lines, *common, thetas, tables)
        return batched_model_gather(*lines, *common, thetas, table, vel_t)

    return model_batch


def build_lnlike_batched(model: SpectralModel, spec: ParamSpec, grid_ints,
                         grid_yerrs, **kwargs):
    """Batched lnlike(thetas (N, D)) -> (N,): the chi^2 of build_lnlike
    over the forward model `_build_batched_model` selects (same kwargs
    as build_lnprob_batched)."""
    y = torch.as_tensor(grid_ints, dtype=model.dtype, device=model.device)
    inv_sigma2 = 1.0 / torch.as_tensor(grid_yerrs, dtype=model.dtype,
                                       device=model.device) ** 2
    model_batch = _build_batched_model(model, spec, **kwargs)

    def lnlike_batch(thetas):
        ll = model.chi2_lnlike(model_batch(thetas), y, inv_sigma2)
        return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))

    return lnlike_batch


def build_lnprob_batched(model: SpectralModel, spec: ParamSpec, grid_ints,
                         grid_yerrs, lnprior_fn, *, use_pallas: bool = False,
                         dv_max: float | None = None,
                         pallas_kernel: str = "gather"):
    """Batched lnprob(thetas (N, D)) -> (N,) with a choice of opacity
    formulation: dense (use_pallas=False), or the channel-major gather
    tables (use_pallas=True, pallas_kernel="gather", the default) built
    for `dv_max` — the upper bound on dV the prior enforces, so the static
    window structure is exact for every in-bounds walker. "csr" and
    "block" are ROADMAP P11. `lnprior_fn` is batched, (N, D) -> (N,)."""
    y = torch.as_tensor(grid_ints, dtype=model.dtype, device=model.device)
    inv_sigma2 = 1.0 / torch.as_tensor(grid_yerrs, dtype=model.dtype,
                                       device=model.device) ** 2
    model_batch = _build_batched_model(model, spec, use_pallas=use_pallas,
                                       dv_max=dv_max, pallas_kernel=pallas_kernel)

    def lnprob_batch(thetas):
        ll = model.chi2_lnlike(model_batch(thetas), y, inv_sigma2)
        lp = lnprior_fn(thetas)
        return torch.where(torch.isfinite(lp) & torch.isfinite(ll), lp + ll,
                           torch.full_like(ll, -torch.inf))

    return lnprob_batch
