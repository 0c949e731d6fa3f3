"""The stretch move (Goodman & Weare; emcee v3's StretchMove with its
random half-split), replayed from the benchmark's seed and followed one
step at a time from the program's own states.

The random stream is the one the program's contract states: a
`torch.Generator` on the run's device seeded with the run's seed, drawn
block by block (one block of `n` steps per checkpoint block, in the
order uniforms for the split (n, W) whose argsort is each step's
permutation, z_u (n, 2, W/2), partner indices (n, 2, W/2) into the other
half, acceptance uniforms (n, 2, W/2)). Step j of a run uses row j -
start of the block that holds it.

A step moves the first half of the permutation against the second, then
the second against the moved first: walker s proposes Y = c + z (s - c)
with c its partner in the other half and z = ((a - 1) u + 1)^2 / a, and
takes Y where ln U < (D - 1) ln z + lnp(Y) - lnp(s).
"""

from __future__ import annotations

import numpy as np
import torch


class Stream:
    """A run's random stream: `seed` on `device`, checkpoint blocks of
    the lengths in `blocks`, `nwalkers` walkers."""

    def __init__(self, seed: int, blocks, nwalkers: int, device):
        self.seed, self.blocks, self.W, self.device = seed, list(blocks), nwalkers, device

    def _draws(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        h = self.W // 2
        start = 0
        for n in self.blocks:
            kw = dict(generator=gen, device=self.device)
            perms = torch.argsort(torch.rand((n, self.W), **kw), dim=1)
            z_u = torch.rand((n, 2, h), **kw, dtype=torch.float32)
            pair = torch.randint(0, h, (n, 2, h), **kw)
            acc_u = torch.rand((n, 2, h), **kw, dtype=torch.float32)
            yield start, n, (perms, z_u, pair, acc_u)
            start += n
        self.final_state = gen.get_state()

    def steps(self, wanted) -> dict:
        """{step j: (perm (W,), z_u (2, h), pair (2, h), acc_u (2, h))} as
        NumPy arrays (z_u, acc_u float64 from their float32 draws)."""
        wanted = set(int(j) for j in wanted)
        out = {}
        for start, n, arrays in self._draws():
            for j in [j for j in wanted if start <= j < start + n]:
                perm, z_u, pair, acc_u = (a[j - start].cpu().numpy() for a in arrays)
                out[j] = (perm, z_u.astype(np.float64), pair, acc_u.astype(np.float64))
        return out

    def end_state(self) -> np.ndarray:
        """The generator's state once every block is drawn (uint8)."""
        for _ in self._draws():
            pass
        return self.final_state.numpy()


def follow(post, x_t, x_t1, lnp_t, lnp_t1, rnd, a: float = 2.0) -> dict:
    """Judge one recorded step x_t -> x_t1 ((W, D) states in the
    program's precision, with their recorded lnprobs) against the
    reference's step from x_t under the same randomness `rnd`. Half 1's
    partners are the program's moved first half, so each walker's update
    is judged alone. Returns the step's largest

    * lnp_rel: |recorded lnp - reference lnp| / scale over both states;
    * pos_rel: |moved position - reference proposal| / |proposal| over
      the walkers the program moved;
    * flip_rel: |reference log-ratio - ln U| / (the proposal's scale +
      the walker's) over the walkers the program moved where the
      reference stays, or kept where it moves (0 where none; inf where
      that margin or its scale is not finite, as when the program takes
      a proposal outside the prior box).

    scale is the reference's (Posterior.lnprob): the size of the terms
    that depend on theta."""
    perm, z_u, pair, acc_u = rnd
    W, D = x_t.shape
    h = W // 2
    xt, xt1 = np.asarray(x_t, np.float64), np.asarray(x_t1, np.float64)
    ref_t, scale_t = post.lnprob(xt)
    ref_t1, scale_t1 = post.lnprob(xt1)
    lnp_rel = max(_rel(np.asarray(lnp_t, np.float64), ref_t, scale_t),
                  _rel(np.asarray(lnp_t1, np.float64), ref_t1, scale_t1))
    out = dict(lnp_rel=lnp_rel, pos_rel=0.0, flip_rel=0.0)
    first, second = perm[:h], perm[h:]
    for half, (act, comp) in enumerate(((first, xt[second]), (second, xt1[first]))):
        s = xt[act]
        c = comp[pair[half]]
        z = ((a - 1.0) * z_u[half] + 1.0) ** 2 / a
        Y = c + z[:, None] * (s - c)
        lnp_y, scale_y = post.lnprob(Y)
        with np.errstate(invalid="ignore"):
            ratio = (D - 1.0) * np.log(z) + lnp_y - ref_t[act]
            ref_move = np.log(acc_u[half]) < ratio
        moved = np.any(np.asarray(x_t1)[act] != np.asarray(x_t)[act], axis=1)
        if moved.any():
            gap = np.abs(xt1[act][moved] - Y[moved]) / np.maximum(np.abs(Y[moved]), 1e-300)
            out["pos_rel"] = max(out["pos_rel"], float(gap.max()))
        differ = moved != ref_move
        if differ.any():
            margin = np.abs(ratio[differ] - np.log(acc_u[half][differ]))
            size = scale_y[differ] + scale_t[act][differ]
            with np.errstate(invalid="ignore"):
                rel = np.where(np.isfinite(margin) & np.isfinite(size), margin / size, np.inf)
            out["flip_rel"] = max(out["flip_rel"], float(rel.max()))
    return out


def _rel(got, ref, scale):
    both_inf = np.isneginf(got) & np.isneginf(ref)
    with np.errstate(invalid="ignore"):
        gap = np.where(both_inf, 0.0, np.abs(got - ref) / scale)
    gap = np.where(np.isnan(gap), np.inf, gap)
    return float(gap.max()) if gap.size else 0.0


def control_step(post_in, x_t, rnd, a: float = 2.0, lnz: bool = True):
    """The reference put in the program's place in a lower precision
    (`post_in` computes in it, and so does the move): one step from x_t.
    With `lnz` false the acceptance leaves out the (D - 1) ln z term (a
    planted fault: the reference in float64 serves as its program).
    Returns (x_t as held, x_t1, lnp_t, lnp_t1), as `follow` takes them."""
    perm, z_u, pair, acc_u = rnd
    dt, dev = post_in.dtype, post_in.device
    x = torch.as_tensor(np.asarray(x_t, np.float64), device=dev).to(dt)
    W, D = x.shape
    h = W // 2
    lnp = torch.as_tensor(post_in.lnprob(x.double().cpu().numpy())[0], device=dev).to(dt)
    x0, lnp0 = x.clone(), lnp.clone()
    first, second = (torch.as_tensor(p, device=dev) for p in (perm[:h], perm[h:]))
    for half, (act, oth) in enumerate(((first, second), (second, first))):
        s, c = x[act], x[oth][torch.as_tensor(pair[half], device=dev)]
        u = torch.as_tensor(z_u[half], device=dev).to(dt)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        Y = c + z[:, None] * (s - c)
        lnp_y = torch.as_tensor(post_in.lnprob(Y.double().cpu().numpy())[0],
                                device=dev).to(dt)
        ratio = ((D - 1.0) * torch.log(z) if lnz else 0.0) + lnp_y - lnp[act]
        take = torch.log(torch.as_tensor(acc_u[half], device=dev).to(dt)) < ratio
        x[act] = torch.where(take[:, None], Y, s)
        lnp[act] = torch.where(take, lnp_y, lnp[act])
    return tuple(v.double().cpu().numpy() for v in (x0, x, lnp0, lnp))
