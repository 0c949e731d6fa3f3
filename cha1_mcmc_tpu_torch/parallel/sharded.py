"""Ensemble sampling over a ('chains', 'walkers', 'lines') mesh of
torch.distributed ranks.

Port of cha1_mcmc_tpu/parallel/sharded.py. Each rank is one process with
one device (cuda:LOCAL_RANK, or the CPU under gloo). Collective pattern
per ensemble step:

  all_gather(complement half)   — 2x per step over the walker group,
                                  (W_local/2, D) each (D <= 14)
  all_reduce(partial opacity)   — inside each lnprob evaluation, over the
                                  line group, only if the lines axis has
                                  more than one shard
  all_reduce(accepted counts)   — once per block over the chain x walker
                                  ranks
  all_gather(chain block)       — once per block over every rank, so the
                                  runner returns global arrays everywhere

Split semantics (the JAX version's): emcee's RedBlueMove shuffles the
*global* walker index vector each step. A global shuffle does not shard,
so each rank draws an independent random permutation of its local
walkers per step (every rank contributes exactly W_local/2 walkers to each
half), and each active walker pairs with a uniform draw from the globally
gathered complement, `comp[pair]` with pair in [0, W_local/2 * n_walker).
A valid Goodman–Weare partition scheme that differs from emcee only in
constraining the split to be balanced per shard.

Randomness: each (chain, walker shard) draws its four arrays (perms, z_u,
pair, acc_u), in the JAX package's layout, from its own torch.Generator
seeded from (seed, w_idx), w_idx = chain * n_walker + walker. The ranks of
one walker shard across the lines axis share the seed, so they see the
same randomness and stay in lockstep. A runner also takes each shard's
arrays directly (`randomness=`), which is how the tests replay the JAX
package's streams.

The global walker axis is ordered (chains, walkers)-contiguous: rank
(c, w, l) holds walkers [(c * n_walker + w) * W_local, ...), as the JAX
package's W_SPEC partitions them, and rank r sits where JAX device r sits
in np.array(devices).reshape(n_chain, n_walker, n_line).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cha1_mcmc_tpu_torch.constants import GRAY, RESET
from cha1_mcmc_tpu_torch.inference.likelihood import batched_model_pallas
from cha1_mcmc_tpu_torch.inference.params import ParamSpec
from cha1_mcmc_tpu_torch.models.forward import SpectralModel, forward_from_lines
from cha1_mcmc_tpu_torch.models.opacity_kernels import plan_opacity_block
from cha1_mcmc_tpu_torch.models.sparse_opacity import block_activity_mask_traced
from cha1_mcmc_tpu_torch.parallel.multihost import local_rank
from cha1_mcmc_tpu_torch.sampler.stretch import (EnsembleSampler, draw_randomness,
                                                 half_step, to_host)
from cha1_mcmc_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "sharded_device", "writes_files", "make_mesh", "pad_model_lines",
           "shard_generator", "ShardedRunner", "shard_lnprob", "run_ensemble_sharded",
           "make_sharded_runner", "make_sharded_sampler", "ShardedEnsembleSampler"]

CHAIN_AXIS = "chains"
WALKER_AXIS = "walkers"
LINE_AXIS = "lines"

_LINE_FIELDS = ("line_freq", "line_elower", "line_aij", "line_gup", "line_glow")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ('chains', 'walkers', 'lines') mesh."""

    shape: dict             # {"chains": n_c, "walkers": n_w, "lines": n_l}
    rank: int
    coords: tuple           # this rank's (chain, walker, line) index
    device: torch.device
    walker_group: object    # the ranks of this rank's chain and line index
    line_group: object      # the ranks of this rank's chain and walker index
    ensemble_group: object  # the ranks of this rank's line index (chain x walker)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def w_idx(self) -> int:
        """This rank's walker shard across chains: chain * n_walker + walker."""
        return self.coords[0] * self.shape[WALKER_AXIS] + self.coords[1]


def sharded_device(device) -> torch.device:
    """This rank's device: "cuda" without an index means cuda:LOCAL_RANK."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    return device


def writes_files(sharded: bool) -> bool:
    """Whether this process writes a fit's files: every process of a
    single-device fit, rank 0 of a sharded one."""
    return not sharded or not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_walker_shards: int | None = None, n_line_shards: int = 1,
              devices=None, n_chain_shards: int = 1) -> Mesh:
    """Build this rank's ('chains', 'walkers', 'lines') mesh over the
    torch.distributed world. `devices` is this rank's device: None or
    "cuda" for cuda:LOCAL_RANK, or e.g. "cpu". n_walker_shards None takes
    the rest of the world. Rank r has the coordinates of index r in C
    order, where JAX device r sits in the JAX package's mesh.

    The world must hold exactly the mesh's ranks. With no group
    initialized, a mesh of one rank starts a world of one itself (NCCL on
    CUDA, gloo on the CPU; an in-process store, as one rank needs no
    file), so a one-card run goes through the same collectives as a
    multi-card one. The chains axis carries independent ensembles: no
    collective crosses it."""
    device = resolve_device(sharded_device(devices if devices is not None else "cuda"),
                            "make_mesh")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        n = n_chain_shards * (n_walker_shards or 1) * n_line_shards
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs torch.distributed "
                               f"initialized with {n} ranks first "
                               "(initialize_multihost under torchrun)")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_walker_shards is None:
        n_walker_shards = world // (n_line_shards * n_chain_shards)
    dims = (n_chain_shards, n_walker_shards, n_line_shards)
    if int(np.prod(dims)) != world:
        raise ValueError(f"a mesh of {dims[0]} chains x {dims[1]} walker shards x "
                         f"{dims[2]} line shards needs {int(np.prod(dims))} ranks; "
                         f"the torch.distributed world holds {world}")
    rank = dist.get_rank()
    coords = tuple(int(i) for i in np.unravel_index(rank, dims))
    grid = np.arange(world).reshape(dims)

    def groups(rank_lists):
        """Create every group on every rank in one order (new_group is
        collective); return the one holding this rank."""
        mine = None
        for ranks in rank_lists:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                mine = g
        return mine

    walker = groups([grid[i, :, j] for i in range(dims[0]) for j in range(dims[2])])
    line = groups([grid[i, j, :] for i in range(dims[0]) for j in range(dims[1])])
    ensemble = groups([grid[:, :, j].ravel() for j in range(dims[2])])
    return Mesh(shape={CHAIN_AXIS: dims[0], WALKER_AXIS: dims[1], LINE_AXIS: dims[2]},
                rank=rank, coords=coords, device=device, walker_group=walker,
                line_group=line, ensemble_group=ensemble)


def pad_model_lines(model: SpectralModel, multiple: int) -> SpectralModel:
    """Pad the line axis to a multiple so it splits evenly across shards.

    Padding lines carry aij = 0, hence tau = 0: they contribute nothing to
    the accumulated opacity (frequency 1 avoids a division by 0; their
    velocity row repeats the last line's)."""
    L = model.n_lines
    pad = -(-L // multiple) * multiple - L
    if pad == 0:
        return model

    def pad1(x, value):
        return torch.cat([x, torch.full((pad,), value, dtype=x.dtype, device=x.device)])

    arrays = {name: pad1(getattr(model, name), value) for name, value in
              zip(_LINE_FIELDS, (1.0, 0.0, 0.0, 1.0, 1.0))}
    arrays["grid_freq"] = model.grid_freq
    arrays["vel_grid"] = torch.cat([model.vel_grid,
                                    model.vel_grid[-1:].expand(pad, model.n_channels)])
    return SpectralModel(**arrays, q_model=model.q_model, mask_center=model.mask_center,
                         dish_size=model.dish_size, Tbg=model.Tbg,
                         vel_offset=model.vel_offset, device=model.device,
                         dtype=model.dtype)


def shard_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """The generator of this rank's walker shard, on the mesh's device,
    seeded from (seed, w_idx): equal across the lines axis, independent
    across walker shards and chains."""
    state = np.random.SeedSequence([int(seed), mesh.w_idx]).generate_state(1, np.uint64)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(int(state[0]))
    return gen


def _all_gather(t, group):
    """Concatenate `t` of every rank of `group`, in rank order (dim 0)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class ShardedRunner:
    """`runner(pos0, generator=None, *, lnp0=None, randomness=None) ->
    (chain (nsteps, W, D), lnps (nsteps, W), accepted (nsteps,),
    (pos (W, D), lnp (W,)))`, global arrays on every rank.

    pos0 / lnp0 are global (W, D) / (W,); without lnp0 each rank computes
    its walkers' entry lnp with `entry_lnprob`. `randomness` is this
    shard's (perms (nsteps, W_l), z_u, pair, acc_u (nsteps, 2, h)), or it
    is drawn from `generator`, this shard's generator (shard_generator).
    Each half-step gathers the complement rows into a contiguous buffer,
    all_gathers it over the walker group and calls `half(state, active,
    comp, z_u, pair, acc_u) -> (state, accepted (1,))` on the (W_l, D+1)
    state (coordinates || lnp)."""

    def __init__(self, mesh: Mesh, nsteps: int, dtype, entry_lnprob, half,
                 nwalkers: int | None = None):
        self.mesh, self.nsteps, self.dtype = mesh, nsteps, dtype
        self.entry_lnprob, self.half, self.nwalkers = entry_lnprob, half, nwalkers

    def _local(self, W):
        mesh = self.mesh
        n_c, n_w = mesh.shape[CHAIN_AXIS], mesh.shape[WALKER_AXIS]
        if self.nwalkers is not None and W != self.nwalkers:
            raise ValueError(f"pos0 carries {W} walkers but the runner was built "
                             f"for nwalkers={self.nwalkers}; rebuild the runner")
        if W % (2 * n_c * n_w):
            raise ValueError(f"nwalkers={W} must be divisible by 2 * {n_c} chains "
                             f"* {n_w} walker shards")
        W_l = W // (n_c * n_w)
        return slice(mesh.w_idx * W_l, (mesh.w_idx + 1) * W_l), W_l

    @torch.no_grad()
    def __call__(self, pos0, generator=None, *, lnp0=None, randomness=None):
        mesh, dev, dt, nsteps = self.mesh, self.mesh.device, self.dtype, self.nsteps
        W, D = pos0.shape
        sl, W_l = self._local(W)
        h, n_w = W_l // 2, mesh.shape[WALKER_AXIS]
        pos = torch.as_tensor(pos0, dtype=dt, device=dev)[sl]
        lnp = (self.entry_lnprob(pos) if lnp0 is None
               else torch.as_tensor(lnp0, dtype=dt, device=dev)[sl])
        if randomness is None:
            if generator is None:
                raise ValueError("a sharded runner needs a generator or randomness")
            randomness = draw_randomness(nsteps, W_l, generator, device=dev,
                                         dtype=dt, n_pair=h * n_w)
        perms, z_u, pair, acc_u = (torch.as_tensor(x, device=dev) for x in randomness)
        if perms.shape != (nsteps, W_l) or z_u.shape != (nsteps, 2, h):
            raise ValueError(f"randomness shaped {tuple(perms.shape)} / "
                             f"{tuple(z_u.shape)} does not cover {nsteps} steps of "
                             f"{W_l} local walkers")
        perms, pair = perms.to(torch.int32), pair.to(torch.int32).contiguous()
        z_u, acc_u = z_u.to(dt).contiguous(), acc_u.to(dt).contiguous()

        state = torch.cat([pos, lnp[:, None]], dim=1).contiguous()
        chain = torch.empty((nsteps, W_l, D), dtype=dt, device=dev)
        lnps = torch.empty((nsteps, W_l), dtype=dt, device=dev)
        accs = torch.empty((nsteps, 2), dtype=torch.float32, device=dev)
        for i in range(nsteps):
            for half in range(2):
                active = perms[i, half * h:(half + 1) * h]
                comp_idx = perms[i, (1 - half) * h:(2 - half) * h]
                comp = _all_gather(state[:, :D].index_select(0, comp_idx),
                                   mesh.walker_group)
                state, acc = self.half(state, active, comp, z_u[i, half],
                                       pair[i, half], acc_u[i, half])
                accs[i, half:half + 1].copy_(acc)
            chain[i] = state[:, :D]
            lnps[i] = state[:, D]
        accepted = accs.sum(dim=1)
        dist.all_reduce(accepted, group=mesh.ensemble_group)
        # one all_gather of the block over every rank; the ranks of line
        # index 0 hold the (chains, walkers)-ordered walker shards
        flat = torch.cat([chain.reshape(-1), lnps.reshape(-1), state.reshape(-1)])
        parts = _all_gather(flat, None).reshape(mesh.size, -1)[::mesh.shape[LINE_AXIS]]
        n_chain, n_lnps = nsteps * W_l * D, nsteps * W_l
        chain = parts[:, :n_chain].reshape(-1, nsteps, W_l, D).transpose(0, 1)
        lnps = parts[:, n_chain:n_chain + n_lnps].reshape(-1, nsteps, W_l).transpose(0, 1)
        final = parts[:, n_chain + n_lnps:].reshape(W, D + 1)
        return (chain.reshape(nsteps, W, D), lnps.reshape(nsteps, W), accepted,
                (final[:, :D].contiguous(), final[:, D].contiguous()))


def _general_half(lnprob, a: float):
    """The general path's half-update (stretch.half_step) on the (W_l,
    D+1) state, in place through its column views."""
    def half(state, active, comp, z_u, pair, acc_u):
        D = comp.shape[1]
        n = half_step(lnprob, D, a, state[:, :D], state[:, D], active.long(), comp,
                      z_u, pair.long(), acc_u)
        return state, n.to(torch.float32).reshape(1)
    return half


def shard_lnprob(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs,
                 lnprior_fn, mesh: Mesh, use_pallas: bool = False,
                 dv_max: float | None = None):
    """This rank's batched lnprob, (N, D) -> (N,), over its line shard:
    the dense forward model, or (use_pallas) the block-sparse opacity
    kernel K4a over the shard with the shard's own block mask; the
    partial opacities are summed over the line group when the lines axis
    has more than one shard (every rank of the group must call it with
    the same thetas). `lnprior_fn` is batched, (N, D) -> (N,)."""
    n_l, l_idx = mesh.shape[LINE_AXIS], mesh.coords[2]
    if use_pallas and dv_max is None:
        raise ValueError("use_pallas=True requires dv_max (from prior bounds)")
    model = pad_model_lines(model.to(mesh.device), n_l)
    dt, dev = model.dtype, mesh.device
    L_l = model.n_lines // n_l
    rows = slice(l_idx * L_l, (l_idx + 1) * L_l)
    lines = tuple(getattr(model, name)[rows] for name in _LINE_FIELDS)
    vel = model.vel_grid[rows]
    group = mesh.line_group if n_l > 1 else None
    y = torch.as_tensor(grid_ints, dtype=dt, device=dev)
    inv_sigma2 = 1.0 / torch.as_tensor(grid_yerrs, dtype=dt, device=dev) ** 2

    if use_pallas:
        # static per run: the shard's block mask and K4a's plan are built once
        block_mask = block_activity_mask_traced(vel, model.mask_center, dv_max)
        plan = plan_opacity_block(vel, block_mask, mask_center=model.mask_center)

        def model_batch(thetas):
            return batched_model_pallas(*lines, vel, model.q, model.grid_freq,
                                        model.mask_center, model.dish_size, model.Tbg,
                                        dt, spec, thetas, block_mask, group=group,
                                        plan=plan)
    else:
        def model_batch(thetas):
            return forward_from_lines(*lines, vel, model.q, model.grid_freq,
                                      model.mask_center, model.dish_size, model.Tbg,
                                      dt, *spec.unpack(thetas), group=group)

    def lnprob(thetas):
        ll = model.chi2_lnlike(model_batch(thetas), y, inv_sigma2)
        lp = lnprior_fn(thetas)
        return torch.where(torch.isfinite(lp) & torch.isfinite(ll), lp + ll,
                           torch.full_like(ll, -torch.inf))

    return lnprob


def make_sharded_runner(
    model: SpectralModel,
    spec: ParamSpec,
    grid_ints,
    grid_yerrs,
    lnprior_fn,
    mesh: Mesh,
    nsteps: int,
    a: float = 2.0,
    use_pallas: bool = False,
    dv_max: float | None = None,
) -> ShardedRunner:
    """The general sharded runner (ShardedRunner's contract): each rank
    evaluates the batched lnprob of its proposals over its line shard
    (shard_lnprob) and updates its walkers with stretch.half_step."""
    lnprob = shard_lnprob(model, spec, grid_ints, grid_yerrs, lnprior_fn, mesh,
                          use_pallas=use_pallas, dv_max=dv_max)
    return ShardedRunner(mesh, nsteps, model.dtype, lnprob, _general_half(lnprob, a))


def run_ensemble_sharded(model, spec, grid_ints, grid_yerrs, lnprior_fn, pos0,
                         generator, nsteps: int, mesh: Mesh, a: float = 2.0,
                         use_pallas: bool = False, dv_max: float | None = None):
    """Run `nsteps` stretch-move steps with walkers and catalog lines
    sharded: one-shot convenience over make_sharded_runner (generator:
    this shard's, from shard_generator). Returns global (chain, lnps,
    accepted, (pos, lnp))."""
    runner = make_sharded_runner(model, spec, grid_ints, grid_yerrs, lnprior_fn,
                                 mesh, nsteps, a=a, use_pallas=use_pallas,
                                 dv_max=dv_max)
    return runner(pos0, generator)


@dataclasses.dataclass
class ShardedEnsembleSampler(EnsembleSampler):
    """EnsembleSampler over a mesh: the single-device sampler's chain-file
    contract — blocks of checkpoint_every steps, the cumulative (W, S, D)
    .npy, the .state.npz sidecar, preload, load_state and exact thinning —
    with every rank running the same calls (SPMD). Rank 0 writes the
    files; the sidecar holds every rank's shard generator state
    (`rng_states`, in rank order), and load_state gives each rank its own
    back. A device error is raised, not retried (run_mcmc). What
    `FitConfig.n_devices` routes to — the replacement for the reference's
    multiprocessing pool fan-out (reference inference.py:456-463).

    Runners by flag: use_fused_multi K5c, use_fused_gather K5b (with
    gather_plan), use_fused K5a (parallel/sharded_fused.py), else the
    general runner. `device` follows the mesh."""

    _: dataclasses.KW_ONLY
    mesh: Mesh = None
    model: SpectralModel = None
    spec: ParamSpec = None
    grid_ints: object = None
    grid_yerrs: object = None
    lnprior_fn: object = None
    use_pallas: bool = False
    dv_max: float | None = None
    use_fused: bool = False
    bounds: dict | None = None
    prior_means: object = None
    prior_stds: object = None
    use_fused_gather: bool = False
    gather_plan: object = None
    use_fused_multi: bool = False

    #: One block in flight: the runner waits on the host every half-step,
    #: so there is nothing to overlap, and the sidecar's generator states
    #: are gathered collectively after each block.
    queue_ahead = 0

    def __post_init__(self):
        if self.mesh is None or self.model is None:
            raise ValueError("ShardedEnsembleSampler requires mesh and model")
        self.device = self.mesh.device
        super().__post_init__()
        if (self.use_fused or self.use_fused_gather) and self.bounds is None:
            raise ValueError("use_fused requires bounds/prior_means/prior_stds for "
                             "the in-kernel prior")
        if self.use_fused_multi and self.prior_means is None:
            raise ValueError("use_fused_multi requires prior_means/prior_stds for "
                             "the in-kernel ordered prior")
        self._runners: dict[int, ShardedRunner] = {}
        self._generator: torch.Generator | None = None

    @property
    def writes_files(self) -> bool:
        return self.mesh.rank == 0

    def _runner(self, nsteps: int) -> ShardedRunner:
        if nsteps not in self._runners:
            from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

            common = (self.model, self.spec, self.grid_ints, self.grid_yerrs)
            if self.use_fused_multi:
                runner = sf.make_fused_multi_sharded_runner(
                    *common, self.lnprior_fn, self.prior_means, self.prior_stds,
                    self.mesh, nsteps, nwalkers=self.nwalkers, dv_max=self.dv_max,
                    a=self.a)
            elif self.use_fused_gather:
                runner = sf.make_fused_gather_sharded_runner(
                    *common, self.bounds, self.prior_means, self.prior_stds, self.mesh,
                    nsteps, nwalkers=self.nwalkers, dv_max=self.dv_max, a=self.a,
                    plan=self.gather_plan)
            elif self.use_fused:
                runner = sf.make_fused_sharded_runner(
                    *common, self.lnprior_fn, self.bounds, self.prior_means,
                    self.prior_stds, self.mesh, nsteps, a=self.a)
            else:
                runner = make_sharded_runner(
                    *common, self.lnprior_fn, self.mesh, nsteps, a=self.a,
                    use_pallas=self.use_pallas, dv_max=self.dv_max)
            self._runners[nsteps] = runner
        return self._runners[nsteps]

    def lnp0(self, pos):
        # Each runner computes its shard's entry lnp from the positions
        # (deterministic); later blocks continue with the carried lnp.
        return None

    def shard_generator(self, generator: torch.Generator) -> torch.Generator:
        """This rank's shard generator: restored by load_state, else seeded
        from (generator's seed, w_idx) at the first block."""
        if self._generator is None:
            self._generator = shard_generator(generator.initial_seed(), self.mesh)
        return self._generator

    def _run_block(self, pos, lnp, generator, nsteps: int, thin: int):
        # Thinning is exact subsampling of the raw trajectory: run nsteps *
        # thin raw moves and keep every thin-th state.
        chain, lnps, acc, final = self._runner(nsteps * thin)(
            pos, self.shard_generator(generator), lnp0=lnp)
        chain, lnps, acc = self.thin(chain, lnps, acc, thin)
        return chain, lnps, acc, final

    def _rng_state(self, generator) -> torch.Tensor:
        return self.shard_generator(generator).get_state()

    def _rng_sidecar(self, state, counted) -> dict:
        # collective: every rank's shard generator state, in rank order
        state = state.to(self.mesh.device)
        return dict(rng_states=to_host(_all_gather(state[None], None), counted))

    def _rng_restore(self, state, state_path: str):
        world = self.mesh.size
        if "rng_states" not in state.files or state["rng_states"].shape[0] != world:
            raise ValueError(f"{state_path} holds no generator state for each of "
                             f"{world} ranks (written by another mesh or by a "
                             "single-device run): remove it to restart from the "
                             "chain's last positions")
        rng = torch.from_numpy(state["rng_states"][self.mesh.rank].copy())
        self._generator = torch.Generator(device=self.mesh.device)
        self._generator.set_state(rng)
        return rng

    def run_mcmc(self, pos, nsteps: int, generator: torch.Generator, **kwargs):
        """EnsembleSampler.run_mcmc with no retry: a device error is raised
        on the rank that meets it. That rank has left the block's
        collectives midway, so the ranks cannot run the block again
        together; the other ranks' pending collective fails once its
        process group goes down."""
        return super().run_mcmc(pos, nsteps, generator, **{**kwargs, "max_retries": 0})


def make_sharded_sampler(*, n_devices: int, n_line_shards: int, nwalkers: int,
                         ndim: int, a: float, dtype, model, spec, grid_ints,
                         grid_yerrs, lnprior_fn, use_pallas: bool = False,
                         dv_max: float | None = None, n_chains: int = 1,
                         use_fused: bool = False, bounds: dict | None = None,
                         prior_means=None, prior_stds=None, device=None,
                         verbose: bool = True) -> ShardedEnsembleSampler:
    """Validate the mesh request and construct a ShardedEnsembleSampler —
    the single construction point shared by the single-component
    (pipeline/fit.py) and multi-component (pipeline/multifit.py) fits.
    n_devices must equal the torch.distributed world size (1 with no
    group: make_mesh starts one); `device` is this rank's (None:
    cuda:LOCAL_RANK).

    The fused step (use_fused) is taken on a CUDA device in float32, as
    the single-device selection takes it: K5c for ncomp > 1, K5b for
    use_pallas (a dense catalog), else K5a — each where the problem fits
    the kernel at the local walker count; otherwise the general runner.
    n_chains > 1 composes independent ensembles with the mesh (a 'chains'
    axis no collective crosses), whole chains contiguous in the walker
    axis."""
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the torch.distributed world "
                         f"holds {world} ranks: launch one process per device "
                         "(torchrun --nproc_per_node) and initialize_multihost()")
    if n_devices % (n_line_shards * n_chains):
        raise ValueError(f"n_devices={n_devices} must be divisible by "
                         f"n_line_shards={n_line_shards} * n_chains={n_chains}")
    if nwalkers % n_chains:
        raise ValueError(f"nwalkers={nwalkers} must be divisible by n_chains={n_chains}")
    mesh = make_mesh(n_devices // (n_line_shards * n_chains), n_line_shards,
                     devices=device, n_chain_shards=n_chains)
    model = model.to(mesh.device)
    fused_ok = use_fused and mesh.device.type == "cuda" and dtype == torch.float32
    use_fused_gather, gather_plan, use_fused_multi = False, None, False
    if spec.ncomp > 1:
        use_fused_multi = (fused_ok and prior_means is not None and dv_max is not None
                           and spec.free_source_size
                           and sf.fused_multi_sharded_supported(model, spec, dv_max,
                                                                mesh, nwalkers))
        use_fused = False
    elif use_pallas:
        if fused_ok and bounds is not None and dv_max is not None:
            gather_plan = sf.plan_fused_gather_sharded(model, spec, mesh, nwalkers,
                                                       dv_max)
        use_fused_gather, use_fused = gather_plan is not None, False
    else:
        use_fused = (fused_ok and bounds is not None
                     and sf.fused_sharded_supported(model, mesh, nwalkers, ndim=ndim))
    if verbose and mesh.rank == 0:
        chains_txt = f"chains={n_chains}, " if n_chains > 1 else ""
        fused_txt = (", fused half-step kernel K5a" if use_fused else
                     ", fused gather half-step kernel K5b" if use_fused_gather else
                     ", fused multi half-step kernel K5c" if use_fused_multi else "")
        print(f"{GRAY}Sampling on a {n_devices}-device mesh ({chains_txt}"
              f"walkers={mesh.shape[WALKER_AXIS]}, lines={mesh.shape[LINE_AXIS]}"
              f"{fused_txt}).{RESET}")
    return ShardedEnsembleSampler(
        lnprob_fn=None, nwalkers=nwalkers, ndim=ndim, a=a, dtype=dtype,
        mesh=mesh, model=model, spec=spec, grid_ints=grid_ints,
        grid_yerrs=grid_yerrs, lnprior_fn=lnprior_fn, use_pallas=use_pallas,
        dv_max=dv_max, use_fused=use_fused, bounds=bounds, prior_means=prior_means,
        prior_stds=prior_stds, use_fused_gather=use_fused_gather,
        gather_plan=gather_plan, use_fused_multi=use_fused_multi)
