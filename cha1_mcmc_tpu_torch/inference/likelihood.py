"""Likelihood and posterior log-probability functions, batched over walkers.

Port of cha1_mcmc_tpu/inference/likelihood.py. `build_lnlike` /
`build_lnprob` evaluate the dense forward model; the JAX package returns
scalar functions that callers vmap, here they return explicitly batched
(N, D) -> (N,) functions, so one call evaluates every proposal of a
half-step. `build_lnprob_batched` / `build_lnlike_batched` add the choice
of opacity formulation: dense, the channel-major gather tables of
models/sparse_opacity.py (`pallas_kernel="gather"`, the general path of
the multifit and of dense fits), or the block-sparse and CSR kernels K4a
/ K4b of models/opacity_kernels.py (`"block"` / `"csr"`), each with one
formula on every device.

Failure semantics: the reference converts exceptions and non-finite values
to -inf so the sampler rejects the proposal (reference inference.py:145-147,
153-155, 162-164, 241-245); here non-finite values map to -inf.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cha1_mcmc_tpu_torch.models.forward import SpectralModel
from cha1_mcmc_tpu_torch.models.opacity_kernels import (
    opacity_planned, plan_opacity_block, plan_opacity_csr, unmasked_is_exact)
from cha1_mcmc_tpu_torch.models.sparse_opacity import (
    block_activity_mask, build_opacity_csr, build_opacity_gather,
    build_opacity_gather_split, opacity_gather, opacity_gather_split)
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu_torch.inference.params import ParamSpec

__all__ = ["build_lnlike", "build_lnprob", "build_lnlike_batched",
           "build_lnprob_batched", "batched_model_pallas",
           "batched_model_gather",
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
                           Tbg, spec, thetas, group=None):
    """Walker-batched body shared by the opacity formulations: unpack
    theta, per-line stick opacities, the formulation's opacity
    (`opacity_fn` over the (N*K)-flattened taus/vlsr/dV), an optional sum
    of the partial opacities over the line shards of `group`
    (all_reduce), then the radiative-transfer tail. The line arrays are
    whatever subset `opacity_fn` was built against — a rank's line shard,
    or the active subset of a gather table; `q_fn` maps Tex (N,) to Q
    (N,)."""
    N = thetas.shape[0]
    K = spec.ncomp
    ss, Ncol, Tex, vlsr, dV = spec.unpack(thetas)
    Q = q_fn(Tex)
    taus = tau_sticks(torch, line_freq, line_elower, line_aij, line_gup,
                      line_glow, Q[:, None, None], Ncol[..., None],
                      Tex[:, None, None], dV[:, None, None])      # (N, K, L)
    opac = opacity_fn(taus.reshape(N * K, -1), vlsr.reshape(N * K),
                      dV[:, None].expand(N, K).reshape(N * K)).reshape(N, K, -1)
    if group is not None:
        opac = opac.contiguous()
        dist.all_reduce(opac, group=group)
    return _rt_tail(opac, ss, Tex, grid_freq, dish_size, Tbg)


def batched_model_pallas(line_freq, line_elower, line_aij, line_gup, line_glow,
                         q_fn, grid_freq, dish_size, Tbg, spec, thetas, plan, *,
                         unmasked: bool = False, group=None):
    """(N, C) walker-batched forward model with the opacity of an
    OpacityPlan (models/opacity_kernels.py), in the exp2 form: the
    block-sparse kernel K4a over the (L, C) velocity grid
    (plan_opacity_block) or the compacted kernel K4b (plan_opacity_csr).
    The plan, built once by the caller, holds every table. unmasked must
    only be set when unmasked_is_exact() holds for the parameter box. The
    line arrays may be a rank's line shard (with a K4a plan over its
    velocity rows): `group` then sums the partial opacities over the line
    shards."""
    return _batched_opacity_model(
        lambda t, v, d: opacity_planned(plan, t, v.contiguous(), d.contiguous(),
                                        masked=not unmasked),
        line_freq, line_elower, line_aij, line_gup, line_glow, q_fn,
        grid_freq, dish_size, Tbg, spec, thetas, group=group)


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
                         pallas_kernel: str = "gather",
                         dv_min: float | None = None,
                         vlsr_bounds: tuple | None = None):
    """Batched forward model, thetas (N, D) -> (N, C): the dense model, or
    (use_pallas=True) a sparse opacity formulation built for the prior's
    dV bound `dv_max`: "gather" — the channel-major gather tables, split
    where that saves >= 1.3x of the element work; "csr" — K4b; "block" —
    K4a. With the prior's dv_min and vlsr_bounds, the K4 kernels drop the
    per-element window select where unmasked_is_exact holds for that box."""
    if not use_pallas:
        def model_batch(thetas):
            return model(*spec.unpack(thetas))
        return model_batch
    if pallas_kernel not in ("gather", "csr", "block"):
        raise ValueError(f"pallas_kernel={pallas_kernel!r}: one of 'gather', "
                         "'csr', 'block'")
    if dv_max is None:
        raise ValueError("use_pallas=True requires dv_max (from prior bounds)")
    unmasked = (dv_min is not None and vlsr_bounds is not None
                and unmasked_is_exact(
                    dv_min, max(abs(vlsr_bounds[0] - model.mask_center),
                                abs(vlsr_bounds[1] - model.mask_center)),
                    model.dtype))

    def index(a, dtype=torch.long):
        return torch.as_tensor(a, dtype=dtype, device=model.device)

    def vel(a):
        return torch.as_tensor(a, dtype=model.dtype, device=model.device)

    vel_grid = model.vel_grid.cpu().numpy()
    all_lines = (model.line_freq, model.line_elower, model.line_aij,
                 model.line_gup, model.line_glow)
    common = (model.q, model.grid_freq, model.mask_center, model.dish_size,
              model.Tbg, spec)
    # the K4 tables are checked and packed once, into a plan per model
    if pallas_kernel in ("csr", "block"):
        if pallas_kernel == "csr":
            line_table, vel_compact, tile_counts = build_opacity_csr(
                vel_grid, model.mask_center, dv_max)
            plan = plan_opacity_csr(index(line_table, torch.int32), vel(vel_compact),
                                    index(tile_counts, torch.int32),
                                    mask_center=model.mask_center,
                                    n_channels=model.n_channels)
        else:
            block_mask = index(block_activity_mask(vel_grid, model.mask_center, dv_max),
                               torch.int32)
            plan = plan_opacity_block(model.vel_grid, block_mask,
                                      mask_center=model.mask_center)
        return lambda thetas: batched_model_pallas(
            *all_lines, model.q, model.grid_freq, model.dish_size, model.Tbg, spec,
            thetas, plan, unmasked=unmasked)

    split = build_opacity_gather_split(vel_grid, model.mask_center, dv_max)
    if split is not None:
        t1, v1, t2, v2, heavy, active = split
        tables = (index(t1), vel(v1), index(t2), vel(v2), index(heavy))
    else:
        table, vel_t, active = build_opacity_gather(vel_grid, model.mask_center,
                                                    dv_max)
        table, vel_t = index(table), vel(vel_t)
    lines = tuple(x[index(active)] for x in all_lines)

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
                         pallas_kernel: str = "gather",
                         dv_min: float | None = None,
                         vlsr_bounds: tuple | None = None):
    """Batched lnprob(thetas (N, D)) -> (N,) with a choice of opacity
    formulation: dense (use_pallas=False), or (use_pallas=True) the
    channel-major gather tables (pallas_kernel="gather", the default), the
    CSR kernel K4b ("csr") or the block-sparse kernel K4a ("block"), built
    for `dv_max` — the upper bound on dV the prior enforces, so the static
    window structure is exact for every in-bounds walker. dv_min /
    vlsr_bounds: optional prior-box bounds; when unmasked_is_exact holds
    for them, K4a / K4b drop the per-element window select. `lnprior_fn`
    is batched, (N, D) -> (N,)."""
    y = torch.as_tensor(grid_ints, dtype=model.dtype, device=model.device)
    inv_sigma2 = 1.0 / torch.as_tensor(grid_yerrs, dtype=model.dtype,
                                       device=model.device) ** 2
    model_batch = _build_batched_model(model, spec, use_pallas=use_pallas,
                                       dv_max=dv_max, pallas_kernel=pallas_kernel,
                                       dv_min=dv_min, vlsr_bounds=vlsr_bounds)

    def lnprob_batch(thetas):
        ll = model.chi2_lnlike(model_batch(thetas), y, inv_sigma2)
        lp = lnprior_fn(thetas)
        return torch.where(torch.isfinite(lp) & torch.isfinite(ll), lp + ll,
                           torch.full_like(ll, -torch.inf))

    return lnprob_batch
