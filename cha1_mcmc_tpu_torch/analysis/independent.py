"""Independent-engine MCMC cross-validation: adaptive random-walk
Metropolis.

Port of cha1_mcmc_tpu/analysis/independent.py. The reference validates
its emcee pipeline against CASSIS's *independent* MCMC engine (reference
scripts/CASSIS/Cha1_HC5N_CASSIS.py:133 `computeChi2MinUsingMCMC`) — a
sampler that shares nothing with emcee but the posterior it targets. This
module plays that role: an adaptive random-walk Metropolis engine whose
move machinery shares NOTHING with the stretch sampler — no ensemble
coupling, no complementary halves, no stretch draws, no walker pairing.
Each chain is an independent classic Metropolis walker with a Gaussian
proposal whose per-dimension widths are adapted during a warmup phase
(empirical spread + acceptance-targeted global scale, Haario-style) and
then FROZEN, so the sampling phase is exact fixed-kernel
Metropolis-Hastings and its stationary distribution is the posterior
with no adaptation bias.

The W chains are the batch axis of every tensor op: a round is a loop of
batched (propose, lnprob, accept) steps on the chains' device, its normal
proposals (nsteps, W, D) and log-uniforms (nsteps, W) drawn in bulk from
an explicit torch.Generator before the loop, as sampler/stretch.py draws
its randomness. `randomness=` replays given draws instead (one pair per
round), e.g. the JAX package's, which splits its key once per round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["draw_round", "run_adaptive_metropolis"]


def draw_round(nsteps: int, nchains: int, ndim: int, generator: torch.Generator, *,
               device=None, dtype=torch.float32):
    """One round's draws: zs (nsteps, W, D) standard normals and lnus
    (nsteps, W) log-uniforms. A -inf proposal (out of the prior box or a
    non-finite model) makes lnpp - lnp = -inf (or NaN from a -inf start),
    so `lnu < lnpp - lnp` is false and it is always rejected."""
    zs = torch.randn((nsteps, nchains, ndim), generator=generator, device=device,
                     dtype=dtype)
    lnus = torch.log(torch.rand((nsteps, nchains), generator=generator, device=device,
                                dtype=dtype))
    return zs, lnus


@torch.no_grad()
def _mh_round(lnprob_batch, pos, lnp, sigma, zs, lnus):
    """Fixed-proposal Metropolis: len(zs) x (propose, accept) for all W
    chains at once. Returns (chain (n, W, D), lnps (n, W), accepted count
    (a 0-dim tensor), final (pos, lnp))."""
    n = zs.shape[0]
    chain = torch.empty((n,) + tuple(pos.shape), dtype=pos.dtype, device=pos.device)
    lnps = torch.empty((n,) + tuple(lnp.shape), dtype=lnp.dtype, device=pos.device)
    accepted = torch.zeros((), dtype=torch.int64, device=pos.device)
    for i in range(n):
        # pos + sigma * z in one rounding, as the JAX package's compiled
        # scan rounds it (hazard F6)
        prop = torch.addcmul(pos, sigma, zs[i])
        lnpp = lnprob_batch(prop)
        ok = lnus[i] < (lnpp - lnp)
        pos = torch.where(ok[:, None], prop, pos)
        lnp = torch.where(ok, lnpp, lnp)
        chain[i] = pos
        lnps[i] = lnp
        accepted += ok.sum()
    return chain, lnps, accepted, (pos, lnp)


@torch.no_grad()
def run_adaptive_metropolis(lnprob_fn, pos0, generator: torch.Generator | None = None, *,
                            nsteps: int, init_sigma, warmup_rounds: int = 8,
                            round_len: int = 128, target_accept: float = 0.3,
                            batched: bool = False, randomness=None):
    """Sample the posterior with W independent adaptive-Metropolis chains.

    lnprob_fn: scalar theta (D,) -> lnprob (vmapped internally with
    torch.func.vmap), or — with batched=True — a batched (W, D) -> (W,)
    function such as build_lnprob_batched(...).
    pos0: (W, D) tensor of initial chain positions (e.g. a prior-mean
    ball); the chains run on its device and in its dtype.
    init_sigma: (D,) initial proposal widths (prior stds / 10 works).
    Warmup runs `warmup_rounds` rounds of `round_len` frozen-sigma steps,
    after each blending the proposal widths toward the empirical
    per-dimension spread scaled by 2.38/sqrt(D) (the classic optimal-RWM
    rule) and nudging a global scale toward `target_accept`. The final
    `nsteps` phase runs with the proposal FROZEN (exact MH).
    Randomness: each round draws `draw_round` from `generator`, or
    `randomness` gives the warmup_rounds + 1 rounds' (zs, lnus) pairs.

    Returns (chain (nsteps, W, D), lnps (nsteps, W), acceptance_fraction)
    — same chain layout as sampler.run_ensemble for direct comparison.
    """
    pos = torch.as_tensor(pos0)
    W, D = pos.shape
    lnprob_batch = lnprob_fn if batched else torch.func.vmap(lnprob_fn)
    lengths = [round_len] * warmup_rounds + [nsteps]
    if randomness is None:
        if generator is None:
            raise ValueError("run_adaptive_metropolis needs a generator or randomness")
    elif len(randomness) != len(lengths) or any(
            tuple(zs.shape) != (n, W, D) or tuple(lnus.shape) != (n, W)
            for (zs, lnus), n in zip(randomness, lengths)):
        raise ValueError(f"randomness must hold {len(lengths)} (zs, lnus) pairs shaped "
                         f"(n, {W}, {D}) / (n, {W}), n = {lengths}")

    def draws(r):
        if randomness is not None:
            return randomness[r]
        return draw_round(lengths[r], W, D, generator, device=pos.device, dtype=pos.dtype)

    def widths(sigma):
        return torch.as_tensor(sigma, dtype=pos.dtype, device=pos.device)

    lnp = lnprob_batch(pos)
    sigma = np.asarray(init_sigma, dtype=np.float64).copy()
    if sigma.shape != (D,):
        raise ValueError(f"init_sigma must have shape ({D},)")
    scale = 1.0
    rwm = 2.38 / math.sqrt(D)
    for r in range(warmup_rounds):
        chain, _, acc, (pos, lnp) = _mh_round(lnprob_batch, pos, lnp,
                                              widths(sigma * scale), *draws(r))
        afrac = float(acc) / (round_len * W)
        # Multiplicative acceptance targeting, clipped so one bad round
        # (e.g. afrac = 0 from an over-wide start) cannot overshoot.
        scale *= float(np.clip(math.exp(2.0 * (afrac - target_accept)), 0.5, 2.0))
        emp = chain.cpu().numpy()[round_len // 2:].reshape(-1, D).std(axis=0)
        # Geometric blend damps round-to-round noise; zero spread (a
        # dimension that never accepted this round) keeps its width.
        sigma = np.where(emp > 0, np.sqrt(sigma * rwm * emp), sigma)

    chain, lnps, acc, _ = _mh_round(lnprob_batch, pos, lnp, widths(sigma * scale),
                                    *draws(warmup_rounds))
    acceptance = float(acc) / (nsteps * W)
    return chain, lnps, acceptance
