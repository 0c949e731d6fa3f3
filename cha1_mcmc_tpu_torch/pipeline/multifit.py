"""Multi-component (GOTHAM / TMC-1 style) fit pipeline.

Port of cha1_mcmc_tpu/pipeline/multifit.py, the equivalent of the
reference's 4-component TMC-1 pipeline (reference
scripts/MCMC/TMC1_four_component.py): N velocity components with
per-component source size / column density / vlsr and shared Tex / dV,
ordered-velocity priors, GOTHAM-variant data reduction, and the
median-of-last-200-steps restart convention.

Sampler selection follows the JAX package: on a CUDA device a float32 fit
whose problem K2 supports (sampler/fused_multi.py:fused_multi_supported)
runs through the fused whole-step kernel K2 (FusedEnsembleSampler);
elsewhere, or with use_fused_step=False, the general EnsembleSampler over
the batched gather lnprob (use_sparse_opacity=True) or the dense lnprob.
With n_chains = K > 1 the fit runs K independent ensembles of nwalkers /
K walkers (MultiChainSampler) over the batched gather lnprob, all K
through one K2 launch per k steps where K2 takes the per-chain ensemble
(JAX multifit.py:264-287), and prints the cross-chain R-hat.
With n_devices > 1 the fit runs on a mesh of torch.distributed ranks
(parallel/sharded.py: make_sharded_sampler, through the half-step kernel
K5c where it applies); every rank runs the fit, only rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import CYAN, GRAY, RESET
from cha1_mcmc_tpu_torch.catalogs import load_catalog
from cha1_mcmc_tpu_torch.catalogs.partition import fit_device_cheb
from cha1_mcmc_tpu_torch.models.forward import SpectralModel, simulate_sticks_host
from cha1_mcmc_tpu_torch.inference import (ParamSpec, build_lnprob,
                                           build_lnprob_batched,
                                           ordered_velocity_lnprior)
from cha1_mcmc_tpu_torch.sampler import (EnsembleSampler, FusedEnsembleSampler,
                                         MultiChainSampler, chain_to_priors, load_chain)
from cha1_mcmc_tpu_torch.sampler.fused_multi import (fused_multi_supported,
                                                     make_fused_ensemble_multi)
from cha1_mcmc_tpu_torch.parallel.sharded import (make_sharded_sampler, sharded_device,
                                                  writes_files)
from cha1_mcmc_tpu_torch.reduce.datagrid import (Datagrid, read_spectrum_gotham,
                                                 save_datagrid)
from cha1_mcmc_tpu_torch.pipeline.plotting import plot_results, report_convergence
from cha1_mcmc_tpu_torch.utils import Throughput

__all__ = ["MultiFitConfig", "MultiComponentFit"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Reference hardcoded HC9N template priors (TMC1_four_component.py:292-294).
_HC9N_MEANS = (37.0, 25.0, 56.0, 22.0, 2.47e12, 11.19e12, 2.20e12, 5.64e12,
               6.7, 5.624, 5.790, 5.910, 6.033, 0.117)
_HC9N_STDS = (2.5, 2.0, 6.5, 2.0, 0.30e12, 1.75e12, 0.265e12, 1.185e12,
              0.1, 0.0015, 0.001, 0.0035, 0.002, 0.002)
# Walker-ball perturbation (TMC1_four_component.py:330).
_PERTURBATION = (1e-1, 1e-1, 1e-1, 1e-1, 1e10, 1e10, 1e10, 1e10,
                 1e-3, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3)


@dataclasses.dataclass
class MultiFitConfig:
    """Mirrors the TMC-1 script's input_dict
    (reference TMC1_four_component.py:393-403) plus model geometry."""

    mol_name: str
    fit_folder: str = "GOTHAM_fit_results"
    cat_folder: str = "catalog"
    data_path: str | None = None
    block_interlopers: bool = True
    nruns: int = 10_000
    nwalkers: int = 128
    template_run: bool = False
    restart: bool = True
    prior_path: str | None = None

    ncomp: int = 4
    # Observation geometry (reference TMC1_four_component.py:122,160,173,367)
    dish_size: float = 100.0
    lower_limit: float = 7000.0
    upper_limit: float = 30000.0
    source_velocity: float = 5.8       # mask center (reference :160)
    # Fiducial sim for covered-line selection (reference :367)
    fiducial: tuple = (7.0e11, 0.37, 8.0, 40.0)  # (C, dV, T, source_size)

    template_means: tuple = _HC9N_MEANS
    template_stds: tuple = _HC9N_STDS
    initial: tuple | None = None       # overrides template means as start
    perturbation: tuple = _PERTURBATION

    seed: int = 0
    checkpoint_every: int = 512
    dtype: str = "float32"
    device: str = "cuda"             # torch device the fit runs on; "cuda"
                                     # with no CUDA device raises
    stretch_a: float = 2.0
    use_sparse_opacity: bool = True  # channel-major gather opacity on the
                                     # general path (False: dense model)
    use_fused_step: bool = True      # the whole-step kernel K2 when the
                                     # problem supports it (CUDA, float32)
    dv_bound: float = 0.3            # hard upper bound on dV, shared by the
                                     # prior box (ordered_velocity_lnprior)
                                     # and the static window tables
                                     # (reference TMC1_four_component.py:224)
    n_devices: int | None = None     # shard the fit over this many devices:
                                     # a torch.distributed world of that
                                     # size, one rank per device, each
                                     # running the fit (rank 0 writes)
    n_line_shards: int = 1           # of which, this many shard the line axis
    n_chains: int = 1                # independent ensembles (nwalkers is the
                                     # total; enables cross-chain R-hat)

    @property
    def ndim(self) -> int:
        return 3 * self.ncomp + 2

    @property
    def catfile_path(self) -> str:
        return os.path.join(self.cat_folder, f"{self.mol_name}.cat")

    @property
    def mol_folder(self) -> str:
        return os.path.join(self.fit_folder, self.mol_name)

    @property
    def chain_path(self) -> str:
        return os.path.join(self.mol_folder, "chain.npy")

    @property
    def datagrid_path(self) -> str:
        return os.path.join(
            self.mol_folder, f"all_{self.mol_name}_lines_GOTHAM_freq_space.npy")


class MultiComponentFit:
    """End-to-end N-component GOTHAM fit on one torch device."""

    def __init__(self, config: MultiFitConfig):
        self.config = config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"MultiFitConfig(device={config.device!r}) but no "
                               "CUDA device is available")
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.sharded = config.n_devices is not None and config.n_devices > 1
        if self.sharded:
            self.device = sharded_device(self.device)
        self.spec = ParamSpec(ncomp=config.ncomp)
        self.dtype = _DTYPES[config.dtype]
        self.catalog = None
        self.sampler: EnsembleSampler | None = None

    def init_setup(self) -> Datagrid:
        """Reduce the GOTHAM spectrum once
        (reference TMC1_four_component.py:353-383)."""
        cfg = self.config
        print(f"{CYAN}Running setup for: {cfg.mol_name}, "
              f"block interlopers = {cfg.block_interlopers}.{RESET}")
        if not os.path.exists(cfg.catfile_path):
            raise FileNotFoundError(f"No catalog file found at {cfg.catfile_path}.")
        os.makedirs(cfg.mol_folder, exist_ok=True)
        self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        C, dV, T, ss = cfg.fiducial
        freq_sim, int_sim, _ = simulate_sticks_host(
            self.catalog, C=[C], dV=[dV], T=[T],
            ll=[cfg.lower_limit], ul=[cfg.upper_limit],
            source_size=ss, dish_size=cfg.dish_size)
        data = np.load(cfg.data_path, allow_pickle=True)
        grid = read_spectrum_gotham(
            data, freq_sim, int_sim, block_interlopers=cfg.block_interlopers)
        if writes_files(self.sharded):
            save_datagrid(cfg.datagrid_path, grid)
            print(f"{GRAY}Saved reduced spectrum to: {cfg.datagrid_path}{RESET}")
        return grid

    def _fused_eligible(self, model: SpectralModel) -> bool:
        """The K2 selection rule (JAX multifit.py:151-165, and :275-286 for
        K chains): CUDA, float32, and a problem K2 supports at one
        ensemble's walker count, nwalkers / n_chains."""
        cfg = self.config
        return (cfg.use_fused_step and self.device.type == "cuda"
                and self.dtype == torch.float32
                and fused_multi_supported(model, self.spec, cfg.dv_bound,
                                          nwalkers=cfg.nwalkers // cfg.n_chains))

    def build_model(self, grid: Datagrid) -> SpectralModel:
        cfg = self.config
        if self.catalog is None:
            self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        return SpectralModel.build(
            self.catalog, grid.covered_trans, grid.freqs,
            ll=cfg.lower_limit, ul=cfg.upper_limit,
            dish_size=cfg.dish_size,
            vel_offset=0.0, mask_center=cfg.source_velocity,
            device=self.device, dtype=self.dtype)

    def _attach_device_q(self, model: SpectralModel,
                         prior_means, prior_stds) -> SpectralModel:
        """Device Chebyshev surrogate for a state-sum Q (as
        SpectralFit.build_model). The multifit Tex prior has no hard upper
        bound (reference TMC1_four_component.py bounds Tex below only), so
        the fit interval is sized from the Gaussian prior: out to 16 sigma,
        and at least 60 K (the reference's hottest Q-validity warning,
        functions.py:256-261). fit_device_cheb keeps the exact state sum
        when the interval cannot be fit to tolerance."""
        if model.q_model.kind != "states":
            return model
        n = self.config.ncomp
        mean_tex = float(np.asarray(prior_means)[2 * n])
        std_tex = float(np.asarray(prior_stds)[2 * n])
        t_hi = max(60.0, mean_tex + 16.0 * std_tex)
        return model.with_q_model(fit_device_cheb(model.q_model, 2.7, t_hi))

    def fit(self, grid: Datagrid) -> np.ndarray:
        """Sample the N-component posterior; returns the (W, S, D) chain
        (reference fit_multi_gaussian, TMC1_four_component.py:280-350)."""
        cfg = self.config
        print(f"{CYAN}Fitting column densities for {cfg.mol_name}. "
              f"Restart = {cfg.restart}.{RESET}")
        model = self.build_model(grid)

        if cfg.template_run:
            initial = np.asarray(cfg.template_means, dtype=np.float64)
            prior_means, prior_stds = initial, np.asarray(cfg.template_stds)
        else:
            prior_means, prior_stds = chain_to_priors(load_chain(cfg.prior_path))
            if prior_means.shape != (cfg.ndim,):
                raise ValueError(
                    f"prior chain has ndim {prior_means.shape}, expected {cfg.ndim}")
            if cfg.restart:
                initial = np.asarray(cfg.initial if cfg.initial is not None
                                     else cfg.template_means, dtype=np.float64)
            else:
                # Continue from the median of the last 200 steps
                # (reference TMC1_four_component.py:325-327).
                chain_data = load_chain(cfg.chain_path)[:, -200:, :].reshape(-1, cfg.ndim).T
                initial = np.median(chain_data, axis=1)

        model = self._attach_device_q(model, prior_means, prior_stds)
        lnprior = ordered_velocity_lnprior(self.spec, prior_means, prior_stds,
                                           dv_max=cfg.dv_bound, dtype=self.dtype)

        # Fixed-perturbation walker ball, no rejection
        # (reference TMC1_four_component.py:330-331).
        rng = np.random.default_rng(cfg.seed)
        perturbation = np.asarray(cfg.perturbation, dtype=np.float64)
        pos = initial + perturbation * rng.standard_normal((cfg.nwalkers, cfg.ndim))

        common = dict(nwalkers=cfg.nwalkers, ndim=cfg.ndim, a=cfg.stretch_a,
                      dtype=self.dtype, device=self.device)
        if self.sharded:
            # Walkers (and optionally lines) sharded over a mesh of ranks,
            # every rank running this same call, through the
            # multi-component half-step kernel K5c on a CUDA float32 fit
            # that K2 takes at the local walker count; else the general
            # sharded runner over the dense model (the JAX multifit's
            # sharded formulation).
            self.sampler = make_sharded_sampler(
                n_devices=cfg.n_devices, n_line_shards=cfg.n_line_shards,
                nwalkers=cfg.nwalkers, ndim=cfg.ndim, a=cfg.stretch_a,
                dtype=self.dtype, model=model, spec=self.spec, grid_ints=grid.ints,
                grid_yerrs=grid.yerrs, lnprior_fn=lnprior,
                n_chains=cfg.n_chains, use_fused=cfg.use_fused_step, dv_max=cfg.dv_bound,
                prior_means=prior_means, prior_stds=prior_stds, device=self.device)
        elif cfg.n_chains > 1:
            # K independent ensembles over the batched gather lnprob; all K
            # through one K2 launch per k steps where K2 takes the per-chain
            # ensemble.
            lnprob = build_lnprob_batched(
                model, self.spec, grid.ints, grid.yerrs, lnprior,
                use_pallas=True, pallas_kernel="gather", dv_max=cfg.dv_bound)
            run_fn = None
            if self._fused_eligible(model):
                run_fn = make_fused_ensemble_multi(
                    model, self.spec, grid.ints, grid.yerrs, prior_means,
                    prior_stds, dv_max=cfg.dv_bound, a=cfg.stretch_a)
            self.sampler = MultiChainSampler(lnprob_fn=lnprob, n_chains=cfg.n_chains,
                                             run_fn=run_fn, **common)
        elif self._fused_eligible(model):
            # K2: one CUDA kernel launch per k ensemble steps
            # (sampler/fused_multi.py, csrc/multi_step.cu).
            lnprob = build_lnprob_batched(
                model, self.spec, grid.ints, grid.yerrs, lnprior,
                use_pallas=True, pallas_kernel="gather", dv_max=cfg.dv_bound)
            run_fn = make_fused_ensemble_multi(
                model, self.spec, grid.ints, grid.yerrs, prior_means,
                prior_stds, dv_max=cfg.dv_bound, a=cfg.stretch_a)
            self.sampler = FusedEnsembleSampler(lnprob_fn=lnprob, run_fn=run_fn,
                                                **common)
        elif cfg.use_sparse_opacity:
            # Channel-major gather opacity: each covered GOTHAM line touches
            # a few percent of the channels at the dV prior bound, and
            # cfg.dv_bound feeds both the prior's hard bound and the static
            # table's window, so the table is exact for every in-bounds walker.
            lnprob = build_lnprob_batched(
                model, self.spec, grid.ints, grid.yerrs, lnprior,
                use_pallas=True, pallas_kernel="gather", dv_max=cfg.dv_bound)
            self.sampler = EnsembleSampler(lnprob_fn=lnprob, **common)
        else:
            lnprob = build_lnprob(model, self.spec, grid.ints, grid.yerrs, lnprior)
            self.sampler = EnsembleSampler(lnprob_fn=lnprob, **common)
        print(f"{GRAY}Sampler: {type(self.sampler).__name__} on {self.device}.{RESET}")

        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed)
        throughput = Throughput()
        with throughput.setup():
            lnp0 = self.sampler.prepare(pos)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with throughput:
            self.sampler.run_mcmc(
                pos, cfg.nruns, generator, lnp0=lnp0, checkpoint_every=cfg.checkpoint_every,
                chain_file=cfg.chain_path, progress=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        throughput.add(cfg.nruns, cfg.nwalkers)
        device_name = (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu")
        if writes_files(self.sharded):
            throughput.save(os.path.join(cfg.mol_folder, "throughput.json"),
                            device=device_name, sampler=type(self.sampler).__name__)
        self.throughput = throughput
        print(f"{GRAY}Acceptance fraction: "
              f"{self.sampler.acceptance_fraction:.3f}  |  "
              f"{throughput.walker_steps_per_sec:,.0f} walker-steps/s on "
              f"{device_name} (wall, incl. checkpoints){RESET}")
        if cfg.n_chains > 1:
            self.convergence = report_convergence(self.sampler.chain, self.spec.labels,
                                                  cfg.n_chains)
        return self.sampler.chain

    def run(self) -> np.ndarray:
        grid = self.init_setup()
        chain = self.fit(grid)
        if writes_files(self.sharded):
            plot_results(self.config.chain_path, self.spec.labels, self.spec.labels_latex)
        return chain
