"""The single-molecule fit of the reference's SpectralFitMCMC
orchestration (reference inference.py:63-488). Port of
cha1_mcmc_tpu/pipeline/fit.py.

Flow (reference run(), inference.py:475-488):
  init_setup (reduce data once) -> choose priors (template or
  posterior-as-prior from a previous chain) -> optional MLE Ncol init ->
  rejection-init the walker ball -> sample with per-block checkpoints ->
  summary table + corner plot.

Sampler selection follows the JAX package. A dense catalog (n_lines x
n_channels > 4e6, or use_pallas=True) takes the sparse opacity path: the
channel-major gather lnprob, and on a CUDA device, for a float32
single-component fit, the dense whole-step kernel K3
(FusedEnsembleSampler over sampler/fused_gather.py). Otherwise on a CUDA
device a single-component float32 fit runs through the fused whole-step
kernel K1. Elsewhere, or with use_fused_step=False, the general
EnsembleSampler over the batched lnprob. With n_chains = K > 1 the fit
runs K independent ensembles of nwalkers / K walkers
(MultiChainSampler): on a CUDA device, for a float32 fit K1 takes at the
per-chain walker count, all K chains in one K1 launch per k steps;
otherwise the general sampler chain by chain (the sparse path included,
as in the JAX package); the cross-chain R-hat is printed after sampling.
With n_devices > 1 the fit runs
on a mesh of torch.distributed ranks (parallel/sharded.py:
make_sharded_sampler, through the half-step kernels K5a / K5b where they
apply): every rank runs SpectralFit.run() on the same config, the
reduction, MLE and walker initialisation come out identical on each, and
only rank 0 writes files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import CYAN, GRAY, GREEN, RED, RESET
from cha1_mcmc_tpu_torch.catalogs import load_catalog
from cha1_mcmc_tpu_torch.catalogs.partition import fit_device_cheb
from cha1_mcmc_tpu_torch.models.forward import SpectralModel
from cha1_mcmc_tpu_torch.inference import (
    ParamSpec,
    single_component_lnprior,
    build_lnlike,
    build_lnlike_batched,
    build_lnprob,
    build_lnprob_batched,
    estimate_ncol_mle,
)
from cha1_mcmc_tpu_torch.sampler import (
    EnsembleSampler,
    FusedEnsembleSampler,
    MultiChainSampler,
    chain_to_priors,
    initialize_walkers,
    load_chain,
    make_fused_ensemble,
)
from cha1_mcmc_tpu_torch.parallel.sharded import (make_sharded_sampler, sharded_device,
                                                  writes_files)
from cha1_mcmc_tpu_torch.sampler.fused import fused_fits
from cha1_mcmc_tpu_torch.sampler.fused_gather import (make_fused_ensemble_gather,
                                                      plan_fused_gather)
from cha1_mcmc_tpu_torch.reduce.datagrid import (
    Datagrid,
    reduce_spectrum,
    save_datagrid,
)
from cha1_mcmc_tpu_torch.pipeline.config import FitConfig
from cha1_mcmc_tpu_torch.pipeline.plotting import plot_results, report_convergence
from cha1_mcmc_tpu_torch.utils import Throughput, trace_profile

__all__ = ["SpectralFit"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

#: use_pallas=None takes the sparse opacity path above this n_lines x
#: n_channels (the JAX package's rule, JAX fit.py:187).
DENSE_AUTO_THRESHOLD = 4_000_000


class SpectralFit:
    """End-to-end single-molecule fit on one torch device."""

    def __init__(self, config: FitConfig):
        self.config = config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"FitConfig(device={config.device!r}) but no "
                               "CUDA device is available")
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.sharded = config.n_devices is not None and config.n_devices > 1
        if self.sharded:
            self.device = sharded_device(self.device)
        self.spec = ParamSpec(ncomp=1, fixed_source_size=config.fixed_source_size)
        self.dtype = _DTYPES[config.dtype]
        self.catalog = None
        self.sampler: EnsembleSampler | None = None
        self._gather_plan = None

    # -- data reduction ----------------------------------------------------
    def init_setup(self) -> Datagrid:
        """Reduce the observed spectrum once (reference inference.py:305-342)."""
        cfg = self.config
        print(f"\n{CYAN}Reducing spectral data for {cfg.mol_name}.{RESET}")
        if not os.path.exists(cfg.catfile_path):
            raise FileNotFoundError(f"No catalog file found at {cfg.catfile_path}.")
        os.makedirs(cfg.mol_folder, exist_ok=True)
        self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        source_size = (cfg.fixed_source_size if cfg.fixed_source_size is not None
                       else cfg.template_means[0])
        grid = reduce_spectrum(
            self.catalog, cfg.data_path,
            ll=cfg.lower_limit, ul=cfg.upper_limit,
            aligned_velocity=cfg.aligned_velocity,
            dish_size=cfg.dish_size, source_size=source_size,
            block_interlopers=cfg.block_interlopers,
        )
        if writes_files(self.sharded):
            save_datagrid(cfg.datagrid_path, grid)
            print(f"{GRAY}Saved reduced spectrum to: {cfg.datagrid_path}{RESET}\n")
        return grid

    # -- model assembly ----------------------------------------------------
    def build_model(self, grid: Datagrid) -> SpectralModel:
        cfg = self.config
        if self.catalog is None:
            self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        model = SpectralModel.build(
            self.catalog, grid.covered_trans, grid.freqs,
            ll=cfg.lower_limit, ul=cfg.upper_limit,
            dish_size=cfg.dish_size,
            vel_offset=cfg.aligned_velocity,
            mask_center=cfg.aligned_velocity,
            device=self.device, dtype=self.dtype,
        )
        if model.q_model.kind == "states":
            # Chebyshev surrogate of the state sum over the sampler's Tex
            # prior box (partition.py:fit_device_cheb) for the device
            # paths; host_eval keeps the exact state sum. Out-of-box Tex
            # is -inf by the prior before Q's value matters.
            t_lo, t_hi = cfg.bounds["Tex"]
            model = model.with_q_model(fit_device_cheb(model.q_model, t_lo, t_hi))
        return model

    def _is_within_bounds(self, theta) -> bool:
        """Host-side box check for walker init (reference inference.py:169-190)."""
        b = self.config.bounds
        keys = (["Ncol", "Tex", "vlsr", "dV"] if self.spec.fixed_source_size is not None
                else ["source_size", "Ncol", "Tex", "vlsr", "dV"])
        return all(b[k][0] < v < b[k][1] for k, v in zip(keys, theta))

    def _use_fused(self, model: SpectralModel) -> bool:
        """The K1 selection rule (JAX fit.py:319-339, and :275-281 for K
        chains): CUDA, one component, float32, and K1's cluster plan for
        one ensemble (nwalkers / n_chains walkers) at 8 CTAs within a CTA's
        shared memory (fused_fits: no channel limit)."""
        cfg = self.config
        return (cfg.use_fused_step and self.device.type == "cuda"
                and self.spec.ncomp == 1 and self.dtype == torch.float32
                and fused_fits(cfg.nwalkers // cfg.n_chains, self.spec.ndim,
                               model.n_lines, self.dtype))

    def _use_fused_gather(self, model: SpectralModel) -> bool:
        """The K3 selection rule (JAX fit.py:292-296), for the sparse
        path: CUDA, use_fused_step, one component, float32, and a plan
        within the kernel's limits. The plan (the channel-major tables) is
        kept, so the check and the kernel build share one construction."""
        cfg = self.config
        if not (cfg.use_fused_step and self.device.type == "cuda"
                and self.spec.ncomp == 1 and self.dtype == torch.float32):
            return False
        self._gather_plan = plan_fused_gather(model, self.spec, cfg.bounds["dV"][1],
                                              nwalkers=cfg.nwalkers)
        return self._gather_plan is not None

    # -- fitting -----------------------------------------------------------
    def fit(self, grid: Datagrid) -> np.ndarray:
        """Sample the posterior; returns the (W, S, D) chain
        (reference fit_multi_gaussian, inference.py:379-473)."""
        cfg = self.config
        print(f"{CYAN}Estimating free parameters for {cfg.mol_name}.{RESET}")
        model = self.build_model(grid)

        if cfg.template_run:
            initial = np.asarray(cfg.template_means, dtype=np.float64)
            prior_means, prior_stds = initial, np.asarray(cfg.template_stds)
            print(f"{GRAY}Using template priors and initial positions for {cfg.mol_name}.{RESET}")
        else:
            prior_chain = load_chain(cfg.prior_path)
            prior_means, prior_stds = chain_to_priors(prior_chain)
            initial = prior_means.copy()
            print(f"{GRAY}Loaded priors from previous chain: {cfg.prior_path}{RESET}")

        lnprior = single_component_lnprior(self.spec, cfg.bounds, prior_means,
                                           prior_stds, dtype=self.dtype)
        use_pallas = cfg.use_pallas
        if use_pallas is None:
            # Auto-select the sparse opacity path for dense catalogs: the
            # dense model materialises a (W/2, L, C) Gaussian per half-step.
            use_pallas = model.n_lines * model.n_channels > DENSE_AUTO_THRESHOLD
            if use_pallas:
                print(f"{GRAY}Dense catalog ({model.n_lines} lines x "
                      f"{model.n_channels} channels): auto-selected the "
                      f"sparse opacity path.{RESET}")
        sparse = dict(use_pallas=True, dv_max=cfg.bounds["dV"][1],
                      dv_min=cfg.bounds["dV"][0], vlsr_bounds=cfg.bounds["vlsr"])
        if use_pallas:
            lnprob = build_lnprob_batched(model, self.spec, grid.ints, grid.yerrs,
                                          lnprior, **sparse)
            # the dense lnlike closes over the (L, C) grid; the MLE takes
            # the gather tables' batched lnlike instead
            lnlike = build_lnlike_batched(model, self.spec, grid.ints, grid.yerrs,
                                          **sparse)
        else:
            lnprob = build_lnprob(model, self.spec, grid.ints, grid.yerrs, lnprior)
            lnlike = build_lnlike(model, self.spec, grid.ints, grid.yerrs)

        resuming = cfg.resume and os.path.exists(cfg.chain_path)
        if cfg.MLE_for_Ncol and not resuming:  # resume discards `initial`
            print(f"{GRAY}Initializing Ncol via MLE.{RESET}")
            try:
                est = estimate_ncol_mle(lnlike, self.spec, initial,
                                        cfg.bounds["Ncol"], device=self.device,
                                        dtype=self.dtype)
                ncol_index = 0 if cfg.fixed_source_size is not None else 1
                initial = np.array(initial, dtype=np.float64)
                initial[ncol_index] = est
                print(f"{GREEN}Successful MLE fit for column density. "
                      f"Prior Ncol: {est:.3e}{RESET}")
            except RuntimeError as e:
                print(f"{RED}Failed to initialize Ncol via MLE: {e}{RESET}")
                raise

        if self.sharded:
            # Walkers (and optionally catalog lines) sharded over a mesh of
            # torch.distributed ranks, every rank running this same call
            # (SPMD), with the single-device chain-file contract; the fused
            # half-step kernels K5a / K5b on a CUDA float32 fit where they
            # take the problem. Replaces the reference's multiprocessing
            # pool (inference.py:456-463).
            self.sampler = make_sharded_sampler(
                n_devices=cfg.n_devices, n_line_shards=cfg.n_line_shards,
                nwalkers=cfg.nwalkers, ndim=self.spec.ndim, a=cfg.stretch_a,
                dtype=self.dtype, model=model, spec=self.spec, grid_ints=grid.ints,
                grid_yerrs=grid.yerrs, lnprior_fn=lnprior, use_pallas=use_pallas,
                dv_max=cfg.bounds["dV"][1], n_chains=cfg.n_chains,
                use_fused=cfg.use_fused_step, bounds=cfg.bounds, prior_means=prior_means,
                prior_stds=prior_stds, device=self.device)
        elif cfg.n_chains > 1:
            # K independent ensembles; all K through one K1 launch per k
            # steps where K1 takes the per-chain ensemble (JAX fit.py:271-291).
            run_fn = None
            if not use_pallas and self._use_fused(model):
                run_fn = make_fused_ensemble(
                    model, self.spec, grid.ints, grid.yerrs, cfg.bounds,
                    prior_means, prior_stds, a=cfg.stretch_a)
            self.sampler = MultiChainSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=self.spec.ndim,
                a=cfg.stretch_a, dtype=self.dtype, device=self.device,
                n_chains=cfg.n_chains, run_fn=run_fn)
        elif use_pallas and self._use_fused_gather(model):
            # K3: the dense whole-step kernel over the channel-major tables,
            # one call per k ensemble steps spread over the card
            # (sampler/fused_gather.py, csrc/gather_step.cu).
            print(f"{GRAY}Dense catalog: fused channel-major step kernel (K3) "
                  f"selected.{RESET}")
            run_fn = make_fused_ensemble_gather(
                model, self.spec, grid.ints, grid.yerrs, cfg.bounds, prior_means,
                prior_stds, dv_max=cfg.bounds["dV"][1], a=cfg.stretch_a,
                nwalkers=cfg.nwalkers, plan=self._gather_plan)
            self.sampler = FusedEnsembleSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=self.spec.ndim,
                a=cfg.stretch_a, dtype=self.dtype, device=self.device,
                run_fn=run_fn)
        elif not use_pallas and self._use_fused(model):
            # K1: one CUDA kernel launch per k ensemble steps
            # (sampler/fused.py, csrc/fused_step.cu).
            run_fn = make_fused_ensemble(
                model, self.spec, grid.ints, grid.yerrs, cfg.bounds,
                prior_means, prior_stds, a=cfg.stretch_a)
            self.sampler = FusedEnsembleSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=self.spec.ndim,
                a=cfg.stretch_a, dtype=self.dtype, device=self.device,
                run_fn=run_fn)
        else:
            self.sampler = EnsembleSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=self.spec.ndim,
                a=cfg.stretch_a, dtype=self.dtype, device=self.device)
        print(f"{GRAY}Sampler: {type(self.sampler).__name__} on {self.device}.{RESET}")

        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed)
        if resuming:
            # Continue an existing chain from its last positions
            # (reference inference.py:463 / TMC1 restart=False convention).
            prev = np.load(cfg.chain_path)
            pos = self.sampler.preload(prev)
            print(f"{GRAY}Resuming from {cfg.chain_path} "
                  f"({prev.shape[1]} existing steps).{RESET}")
            state = self.sampler.load_state(cfg.chain_path)
            if state is not None:
                pos, lnp0, rng_state = state  # exact random-stream continuation
                generator.set_state(rng_state)
            else:
                lnp0 = None
                generator.manual_seed(cfg.seed + prev.shape[1])
        else:
            rng = np.random.default_rng(cfg.seed)
            pos = initialize_walkers(initial, prior_stds, cfg.nwalkers,
                                     self._is_within_bounds, rng=rng)
            lnp0 = None

        throughput = Throughput()
        with throughput.setup():
            lnp0 = self.sampler.prepare(pos, lnp0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with trace_profile(cfg.profile_dir), throughput:
            self.sampler.run_mcmc(
                pos, cfg.nruns, generator, lnp0=lnp0,
                checkpoint_every=cfg.checkpoint_every,
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

    # -- full run ----------------------------------------------------------
    def run(self) -> np.ndarray:
        cfg = self.config
        grid = self.init_setup()
        chain = self.fit(grid)
        if writes_files(self.sharded):
            cfg.to_json(os.path.join(cfg.mol_folder, "config.json"))
            plot_results(cfg.chain_path, self.spec.labels, self.spec.labels_latex)
        return chain
