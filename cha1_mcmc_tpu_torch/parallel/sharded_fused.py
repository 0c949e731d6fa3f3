"""K5a, K5b, K5c: the sharded half-step kernels, their plain PyTorch
versions and the fused sharded runners.

Port of cha1_mcmc_tpu/parallel/sharded_fused.py. The whole-step kernels
(K1, K2, K3) pair walkers within their own resident ensemble, so on a
walker-sharded mesh the step is split at the one point that needs
communication. Per ensemble step, per half:

  index_select(complement rows)  -- the rank's h = W_l / 2 complement
                                    walkers into a contiguous buffer
  all_gather over the walker group -- the (h * n_walker, D) complement
  one half-step launch            -- proposals against comp[pair], the
                                    lnprob, acceptance, the write-back

The half-step is K5a (csrc/fused_step.cu: K1's lnprob over its entry
tables), K5c (csrc/multi_step.cu: K2's multi-component lnprob), each K1's
or K2's cluster half-update on one cluster of 16 or 8 CTAs, launched by
the cluster binding (sampler/cluster.py:launch_half), or K5b
(csrc/gather_step.cu: K3's persistent cooperative half-step over the
channel-major gather tables, spread over the card). The runners are
ShardedRunner's (parallel/sharded.py): the same split, pairing,
randomness and global outputs as the general sharded runner; only the
half-update differs.

Each wrapper (`sharded_half`, `sharded_gather_half`, `sharded_multi_half`)
updates the (W_l, D+1) state (coordinates || lnp) in place and returns
the half's accepted count, (1,) float32: for a CUDA tensor it launches
the kernel, for a CPU tensor it takes the plain version beside it
(`*_plain`: stretch.half_step over the whole-step kernel's plain lnprob,
the kernels' order of operations). `LAUNCHES` counts one per C call, each
one kernel launch.

Entry lnps: K5a and K5c start from the general formulation
(sharded.shard_lnprob, as the JAX runners start from forward_from_lines),
K5b from K3's own lnprob entry; in-chain lnps come from the kernels. No
-inf clamp: a walker that never accepts reports -inf.

Line sharding (n_line_shards > 1) stays on the general path: the fused
half-steps evaluate the whole lnprob on each rank.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cha1_mcmc_tpu_torch.parallel.sharded import (CHAIN_AXIS, LINE_AXIS, WALKER_AXIS,
                                                  Mesh, ShardedRunner, shard_lnprob)
from cha1_mcmc_tpu_torch.sampler import cluster, fused, fused_gather, fused_multi
from cha1_mcmc_tpu_torch.sampler.cluster import (_SUFFIX, check_half, launch_half, raise_on,
                                                 route)
from cha1_mcmc_tpu_torch.sampler.stretch import half_step
from cha1_mcmc_tpu_torch.utils.metrics import register_launches

__all__ = ["fused_sharded_supported", "fused_multi_sharded_supported",
           "plan_fused_gather_sharded", "half_update_plain", "sharded_half_plain",
           "sharded_gather_half_plain", "sharded_multi_half_plain", "sharded_half",
           "sharded_gather_half", "sharded_multi_half", "make_fused_sharded_runner",
           "make_fused_gather_sharded_runner", "make_fused_multi_sharded_runner",
           "LAUNCHES"]

#: Kernel launches per K5 wrapper, counted where the C entry is called and
#: nowhere else (plain-version calls do not count): K5a, K5b, K5c.
LAUNCHES = register_launches({"sharded_half": 0, "sharded_gather_half": 0,
                               "sharded_multi_half": 0})


def _local_walkers(mesh: Mesh, nwalkers: int) -> int | None:
    """A rank's walker count on a mesh the fused half-steps take (one line
    shard, nwalkers divisible by 2 x chains x walker shards), else None."""
    n_c, n_w = mesh.shape[CHAIN_AXIS], mesh.shape[WALKER_AXIS]
    if mesh.shape[LINE_AXIS] != 1 or nwalkers % (2 * n_c * n_w):
        return None
    return nwalkers // (n_c * n_w)


def fused_sharded_supported(model, mesh: Mesh, nwalkers: int, *, ndim: int = 4) -> bool:
    """Can K5a run this mesh's half-steps? One line shard, and K1's gate
    (cluster.admits) at the rank's walker count with K5a's cluster plan
    (the state stays in device memory; the JAX version tests VMEM)."""
    w_local = _local_walkers(mesh, nwalkers)
    return w_local is not None and cluster.admits(fused.FAMILY, w_local, 1, ndim,
                                                  model.n_lines, model.dtype,
                                                  resident_state=False)


def fused_multi_sharded_supported(model, spec, dv_max: float, mesh: Mesh,
                                  nwalkers: int) -> bool:
    """Can K5c run this mesh's half-steps? One line shard, and K2's
    conditions (fused_multi_supported) at the rank's walker count, with
    K5c's cluster plan (the state stays in device memory)."""
    w_local = _local_walkers(mesh, nwalkers)
    return w_local is not None and fused_multi.fused_multi_supported(
        model, spec, dv_max, nwalkers=w_local, resident_state=False)


def plan_fused_gather_sharded(model, spec, mesh: Mesh, nwalkers: int, dv_max: float, *,
                              min_saving: float = 1.3):
    """K3's plan (plan_fused_gather: the channel-major tables and the grid
    geometry) at the rank's walker count, or None where K5b does not take
    the problem; it replaces the JAX version's VMEM replan_chunks."""
    w_local = _local_walkers(mesh, nwalkers)
    if w_local is None:
        return None
    return fused_gather.plan_fused_gather(model, spec, dv_max, w_local,
                                          min_saving=min_saving)


# -- plain PyTorch versions --------------------------------------------------

def half_update_plain(lnprob, a: float, state, active, comp, z_u, pair, acc_u):
    """One half-update of the (W_l, D+1) state in place (stretch.half_step
    on its column views, the kernels' order of operations): walkers
    `active` (h,) against partners comp[pair] of the gathered complement
    (n, D), with stretch uniforms z_u and acceptance uniforms acc_u (h,).
    Returns the accepted count, (1,) float32."""
    D = comp.shape[1]
    n = half_step(lnprob, D, a, state[:, :D], state[:, D], active.long(), comp, z_u,
                  pair.long(), acc_u)
    return n.to(torch.float32).reshape(1)


def sharded_half_plain(state, active, comp, z_u, pair, acc_u, tables, st):
    """K5a with torch ops: half_update_plain around K1's plain lnprob."""
    lnprob = functools.partial(fused.fused_lnprob_plain, tables=tables, st=st)
    return half_update_plain(lnprob, st.a, state, active, comp, z_u, pair, acc_u)


def sharded_multi_half_plain(state, active, comp, z_u, pair, acc_u, tables, st):
    """K5c with torch ops: half_update_plain around K2's plain lnprob."""
    lnprob = functools.partial(fused_multi.multi_lnprob_plain, tables=tables, st=st)
    return half_update_plain(lnprob, st.a, state, active, comp, z_u, pair, acc_u)


def sharded_gather_half_plain(state, active, comp, z_u, pair, acc_u, tables, st, geom):
    """K5b with torch ops: half_update_plain around K3's plain lnprob."""
    lnprob = functools.partial(fused_gather.gather_lnprob_plain, tables=tables, st=st,
                               geom=geom)
    return half_update_plain(lnprob, st.a, state, active, comp, z_u, pair, acc_u)


# -- the CUDA kernels --------------------------------------------------------

def _launch_gather_half(state, active, comp, z_u, pair, acc_u, tables, st, geom):
    lib, _ = fused_gather.load_kernel_library()
    W, D, _ = check_half("K5b", state, active, comp, z_u, pair, acc_u, st.ndim)
    dtype, dev = state.dtype, state.device
    if W > fused_gather._MAX_WALKERS:
        raise ValueError(f"K5b: {W} local walkers (takes up to "
                         f"{fused_gather._MAX_WALKERS})")
    ptrs, buf, scratch, ints = fused_gather.kernel_operands(tables, geom, dtype, dev,
                                                            W // 2, D, 1)
    out_acc = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k5b_half_{_SUFFIX[dtype]}")(
            *(t.data_ptr() for t in (state, active, comp, z_u, pair, acc_u)), *ptrs, *scratch,
            out_acc.data_ptr(), ctypes.addressof(fused._pack_statics(st, dtype)), W, D,
            *ints, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k3_error_string, "sharded_gather_half", "K5b")
    LAUNCHES["sharded_gather_half"] += 1
    return out_acc


def sharded_half(state, active, comp, z_u, pair, acc_u, tables, st, plan=None):
    """K5a: one half-step of the (W_l, D+1) state in place (operands as in
    half_update_plain; K1's tables and statics). One kernel launch for
    CUDA tensors — with cluster.cluster_plan's geometry, or `plan`, one of
    cluster.plan_cluster(fused.FAMILY, ..., resident_state=False) — the plain
    version for CPU tensors. Returns the accepted count, (1,) float32."""
    if route(state, "K5a") == "cuda":
        return launch_half(fused.FAMILY, LAUNCHES, state, active, comp, z_u, pair, acc_u,
                           tables, st, plan)
    return sharded_half_plain(state, active, comp, z_u, pair, acc_u, tables, st)


def sharded_multi_half(state, active, comp, z_u, pair, acc_u, tables, st, plan=None):
    """K5c: sharded_half over K2's tables and statics (`plan`: one of
    cluster.plan_cluster(fused_multi.FAMILY, ..., resident_state=False)
    instead of cluster_plan's)."""
    if route(state, "K5c") == "cuda":
        return launch_half(fused_multi.FAMILY, LAUNCHES, state, active, comp, z_u, pair,
                           acc_u, tables, st, plan)
    return sharded_multi_half_plain(state, active, comp, z_u, pair, acc_u, tables, st)


def sharded_gather_half(state, active, comp, z_u, pair, acc_u, tables, st, geom):
    """K5b: sharded_half over K3's tables, statics and GatherPlan (one
    cooperative kernel launch for CUDA tensors)."""
    if route(state, "K5b") == "cuda":
        return _launch_gather_half(state, active, comp, z_u, pair, acc_u, tables, st,
                                   geom)
    return sharded_gather_half_plain(state, active, comp, z_u, pair, acc_u, tables, st,
                                     geom)


# -- runners -------------------------------------------------------------------

def _require_local(mesh: Mesh, nwalkers: int | None, what: str) -> None:
    if mesh.shape[LINE_AXIS] != 1:
        raise ValueError(f"{what} requires n_line_shards == 1 (line-sharded "
                         "meshes use the general path)")
    if nwalkers is not None and _local_walkers(mesh, nwalkers) is None:
        raise ValueError(f"nwalkers={nwalkers} must be divisible by 2 * "
                         f"{mesh.shape[CHAIN_AXIS]} chains * "
                         f"{mesh.shape[WALKER_AXIS]} walker shards")


def _kernel_half(fn, *args):
    """ShardedRunner's half-update around a K5 wrapper."""
    def half(state, active, comp, z_u, pair, acc_u):
        return state, fn(state, active, comp, z_u, pair, acc_u, *args)
    return half


def make_fused_sharded_runner(model, spec, grid_ints, grid_yerrs, lnprior_fn, bounds,
                              prior_means, prior_stds, mesh: Mesh, nsteps: int,
                              a: float = 2.0) -> ShardedRunner:
    """The general sharded runner's contract (ShardedRunner), each
    half-update one K5a launch per rank. Entry lnp: the general
    formulation (shard_lnprob); bounds / prior_means / prior_stds are
    single_component_lnprior's, for the in-kernel prior."""
    _require_local(mesh, None, "the fused sharded runner (K5a)")
    model = model.to(mesh.device)
    statics, tables = fused.single_statics_tables(model, spec, grid_ints, grid_yerrs,
                                                  bounds, prior_means, prior_stds, a=a)
    entry = shard_lnprob(model, spec, grid_ints, grid_yerrs, lnprior_fn, mesh)
    return ShardedRunner(mesh, nsteps, model.dtype, entry,
                         _kernel_half(sharded_half, tables, statics))


def make_fused_multi_sharded_runner(model, spec, grid_ints, grid_yerrs, lnprior_fn,
                                    prior_means, prior_stds, mesh: Mesh, nsteps: int,
                                    nwalkers: int, dv_max: float,
                                    a: float = 2.0) -> ShardedRunner:
    """The multi-component analogue (K5c): K2's statics and tables for the
    ordered-velocity prior family, entry lnp from the general formulation
    with `lnprior_fn` (ordered_velocity_lnprior)."""
    _require_local(mesh, nwalkers, "the fused multi sharded runner (K5c)")
    model = model.to(mesh.device)
    statics, tables = fused_multi.multi_statics_tables(
        model, spec, grid_ints, grid_yerrs, prior_means, prior_stds, dv_max=dv_max, a=a)
    entry = shard_lnprob(model, spec, grid_ints, grid_yerrs, lnprior_fn, mesh)
    return ShardedRunner(mesh, nsteps, model.dtype, entry,
                         _kernel_half(sharded_multi_half, tables, statics),
                         nwalkers=nwalkers)


def make_fused_gather_sharded_runner(model, spec, grid_ints, grid_yerrs, bounds,
                                     prior_means, prior_stds, mesh: Mesh, nsteps: int,
                                     nwalkers: int, dv_max: float, a: float = 2.0,
                                     plan=None) -> ShardedRunner:
    """The dense-catalog analogue (K5b): K3's tables and geometry from
    `plan` (plan_fused_gather_sharded, built here when None); entry lnp
    from K3's own lnprob entry."""
    _require_local(mesh, nwalkers, "the fused gather sharded runner (K5b)")
    model = model.to(mesh.device)
    if plan is None:
        plan = plan_fused_gather_sharded(model, spec, mesh, nwalkers, dv_max)
    if plan is None:
        raise ValueError("K5b does not take this (model, spec, mesh, nwalkers): "
                         "check plan_fused_gather_sharded first")
    statics, tables, geom = fused_gather.gather_statics_tables(
        model, spec, grid_ints, grid_yerrs, bounds, prior_means, prior_stds, plan, a=a)
    entry = functools.partial(fused_gather.gather_lnprob, tables=tables, st=statics,
                              geom=geom)
    return ShardedRunner(mesh, nsteps, model.dtype, entry,
                         _kernel_half(sharded_gather_half, tables, statics, geom),
                         nwalkers=nwalkers)
