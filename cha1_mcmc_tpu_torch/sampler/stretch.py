"""Goodman & Weare affine-invariant stretch-move ensemble sampler.

Port of cha1_mcmc_tpu/sampler/stretch.py (single ensemble). Semantics
match emcee v3's StretchMove + RedBlueMove (reference
inference.py:456-473, emcee==3.1.6):

  * per step the ensemble is split into two random halves
    (RedBlueMove randomize_split);
  * halves update sequentially — the second half sees the first half's
    *updated* coordinates;
  * each active walker draws a partner uniformly from the complementary
    half, a stretch factor z with density g(z) = 1/sqrt(z) on [1/a, a]
    via z = ((a-1) u + 1)^2 / a, and proposes Y = c + z (s - c);
  * acceptance: ln U < (ndim - 1) ln z + lnprob(Y) - lnprob(s).

All randomness of a run is drawn up front in the JAX package's stream
layout: per raw step a permutation of the W walkers, then z_u, pair and
acc_u, each (n_raw, 2, W/2). Passing the four arrays in (`randomness=`)
replays any stream exactly, e.g. one generated by the JAX package.

K independent ensembles (`run_ensemble_chains`, `MultiChainSampler`,
the JAX package's counterparts at stretch.py:134 and :299) draw their
randomness from one generator in chain order: chain 0's four arrays,
then chain 1's, and so on (`draw_chain_randomness`). The JAX package
splits a key into K keys instead; the port's order is its own, and it
keeps a run's random state one generator state, so a split-and-resumed
multi-chain run equals an unsplit one bitwise.

A checkpoint block that raises a device error (the kernel wrappers'
DeviceError or torch's AcceleratorError) is run again from the
generator state saved before it, on the same path, up to `max_retries`
times (JAX stretch.py:213-261), so a recovered chain equals an unfaulted
one bitwise; any other error propagates at once.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os

import numpy as np
import torch

from cha1_mcmc_tpu_torch.sampler.chain import last_position
from cha1_mcmc_tpu_torch.utils.device import DEFAULT_DEVICE, DEVICE_ERRORS, resolve_device
from cha1_mcmc_tpu_torch.utils.metrics import BlockTimer, innermost_span, span, trace

__all__ = ["draw_randomness", "draw_chain_randomness", "run_ensemble",
           "run_ensemble_chains", "half_step", "EnsembleSampler", "MultiChainSampler",
           "PACKAGE_TAG"]

logger = logging.getLogger(__name__)

#: Written into every `.state.npz` sidecar; a sidecar without it (e.g. one
#: holding a JAX PRNG key) cannot continue a stream here.
PACKAGE_TAG = "cha1_mcmc_tpu_torch"


def _state_path(chain_file: str) -> str:
    root, _ = os.path.splitext(chain_file)
    return root + ".state.npz"


def draw_randomness(n_raw: int, nwalkers: int, generator: torch.Generator, *,
                    device=None, dtype=torch.float32, n_pair: int | None = None):
    """The four bulk random arrays of `n_raw` raw ensemble steps, in the
    JAX package's layout: perms (n_raw, W) int64 (argsort of uniforms: a
    uniformly random half-split per step), z_u (n_raw, 2, h) and acc_u
    (n_raw, 2, h) uniforms in `dtype`, pair (n_raw, 2, h) int64 partner
    indices into the complementary half — or, with `n_pair`, into the
    n_pair walkers of a complement gathered over a walker-sharded mesh
    (parallel/sharded.py)."""
    h = nwalkers // 2
    perms = torch.argsort(torch.rand((n_raw, nwalkers), generator=generator,
                                     device=device), dim=1)
    z_u = torch.rand((n_raw, 2, h), generator=generator, device=device, dtype=dtype)
    pair = torch.randint(0, h if n_pair is None else n_pair, (n_raw, 2, h),
                         generator=generator, device=device)
    acc_u = torch.rand((n_raw, 2, h), generator=generator, device=device, dtype=dtype)
    return perms, z_u, pair, acc_u


def draw_chain_randomness(n_chains: int, n_raw: int, nwalkers: int,
                          generator: torch.Generator, *, device=None,
                          dtype=torch.float32):
    """draw_randomness for K = n_chains ensembles of `nwalkers` each, from
    one generator in chain order (chain 0's four arrays, then chain
    1's, ...), stacked on a leading chain axis: perms (K, n_raw, W), z_u /
    pair / acc_u (K, n_raw, 2, W/2)."""
    per_chain = [draw_randomness(n_raw, nwalkers, generator, device=device, dtype=dtype)
                 for _ in range(n_chains)]
    return tuple(torch.stack(arrays) for arrays in zip(*per_chain))


def stretch_z(z_u, a: float):
    """Stretch factor z = ((a-1) u + 1)^2 / a from uniforms u."""
    return ((a - 1.0) * z_u + 1.0) ** 2 / a


def propose(c, z, s):
    """Y = c + z (s - c), with the multiply-add fused into one rounding,
    as the JAX package's compiled step rounds it."""
    return torch.addcmul(c, z, s - c)


def half_step(lnprob_batch, ndim, a, coords, lnp, active_idx, comp,
              z_u, pair, acc_u):
    """Update walkers `active_idx` (in place) against the complement
    walkers `comp` (n, D) — the other half of this ensemble, or the
    complement gathered over a walker-sharded mesh (parallel/sharded.py)
    — each with partner comp[pair], from pre-drawn uniforms. Returns the
    number accepted."""
    s = coords[active_idx]
    c = comp[pair]
    z = stretch_z(z_u, a)
    proposal = propose(c, z[:, None], s)

    lnp_new = lnprob_batch(proposal)
    lnpdiff = (ndim - 1.0) * torch.log(z) + lnp_new - lnp[active_idx]
    accept = torch.log(acc_u) < lnpdiff

    coords[active_idx] = torch.where(accept[:, None], proposal, s)
    lnp[active_idx] = torch.where(accept, lnp_new, lnp[active_idx])
    return accept.sum()


@torch.no_grad()
def run_ensemble(lnprob_fn, pos0, lnp0, generator: torch.Generator | None,
                 nsteps: int, a: float = 2.0, thin: int = 1, *, randomness=None):
    """Run `nsteps` ensemble steps from (pos0, lnp0).

    lnprob_fn: batched (N, D) -> (N,) log-probability.
    pos0: (W, D) initial walker coordinates; lnp0: (W,) their lnprob.
    Each of the `nsteps` recorded steps advances the ensemble by `thin`
    raw ensemble moves. Randomness is `randomness=(perms, z_u, pair,
    acc_u)` for n_raw = nsteps * thin raw moves (see draw_randomness), or
    is drawn from `generator` (in the JAX version's slot of the key; None
    with `randomness`). Returns (chain (nsteps, W, D), lnps
    (nsteps, W), accepted (nsteps,), final (pos, lnp)).
    """
    W, D = pos0.shape
    if W % 2:
        raise ValueError(f"nwalkers={W} must be even (complementary halves)")
    h = W // 2
    n_raw = nsteps * thin
    if randomness is None:
        if generator is None:
            raise ValueError("run_ensemble needs a generator or randomness")
        randomness = draw_randomness(n_raw, W, generator, device=pos0.device,
                                     dtype=pos0.dtype)
    perms, z_u, pair, acc_u = randomness
    if perms.shape != (n_raw, W) or z_u.shape != (n_raw, 2, h):
        raise ValueError(f"randomness shaped {tuple(perms.shape)} / "
                         f"{tuple(z_u.shape)} does not cover {n_raw} raw "
                         f"steps of {W} walkers")

    coords, lnp = pos0.clone(), lnp0.clone()
    chain = torch.empty((nsteps, W, D), dtype=pos0.dtype, device=pos0.device)
    lnps = torch.empty((nsteps, W), dtype=lnp0.dtype, device=pos0.device)
    accepted = torch.zeros(nsteps, dtype=torch.int64, device=pos0.device)
    for i in range(nsteps):
        for r in range(i * thin, (i + 1) * thin):
            first, second = perms[r, :h], perms[r, h:]
            accepted[i] += half_step(lnprob_fn, D, a, coords, lnp, first,
                                     coords[second], z_u[r, 0], pair[r, 0], acc_u[r, 0])
            accepted[i] += half_step(lnprob_fn, D, a, coords, lnp, second,
                                     coords[first], z_u[r, 1], pair[r, 1], acc_u[r, 1])
        chain[i] = coords
        lnps[i] = lnp
    return chain, lnps, accepted, (coords, lnp)


@torch.no_grad()
def run_ensemble_chains(lnprob_fn, pos0, lnp0, randomness, nsteps: int,
                        a: float = 2.0, thin: int = 1):
    """Run K independent ensembles: pos0 (K, W, D), lnp0 (K, W).

    `randomness` is the four arrays of each chain stacked on a leading
    chain axis (draw_chain_randomness). Each chain runs `run_ensemble` on
    its own randomness with its own lnprob calls, so it equals that chain
    run alone bitwise (the batched gather lnprob's index_add has no
    guaranteed order on CUDA, so the chains' proposals are not pooled into
    one call). Returns chain (K, nsteps, W, D), lnps (K, nsteps, W),
    accepted (K, nsteps), final (pos (K, W, D), lnp (K, W))."""
    K = pos0.shape[0]
    if pos0.dim() != 3 or tuple(lnp0.shape) != (K, pos0.shape[1]):
        raise ValueError(f"run_ensemble_chains takes pos0 (K, W, D) and lnp0 (K, W), "
                         f"not {tuple(pos0.shape)} and {tuple(lnp0.shape)}")
    runs = [run_ensemble(lnprob_fn, pos0[c], lnp0[c], None, nsteps, a=a, thin=thin,
                         randomness=tuple(t[c] for t in randomness)) for c in range(K)]
    chain, lnps, accepted, finals = zip(*runs)
    return (torch.stack(chain), torch.stack(lnps), torch.stack(accepted),
            tuple(torch.stack(f) for f in zip(*finals)))


def to_host(tensor: torch.Tensor, counted: span) -> np.ndarray:
    """`tensor` copied to the host, which waits for the device: one host
    synchronisation, counted on the span `counted` (`syncs`, and the bytes
    in `d2h_bytes`) where it happens."""
    out = tensor.cpu().numpy()
    counted.add(syncs=1, d2h_bytes=out.nbytes)
    return out


class HostCopies:
    """The copies of run_mcmc's blocks to the host, queued with a block and
    waited on once it is due (`queue`, then `wait`).

    On a CUDA device a block's tensors are copied as the block is queued,
    without blocking, into pinned host buffers of their shape (a transposed
    view is made contiguous on the card, not on the host), and an event is
    recorded after them; `wait` is one host synchronisation, on that event,
    then one memcpy a buffer out of the pinned memory. Two sets of buffers,
    made at the first block of a call and reused, serve the two blocks in
    flight in turn: a set is copied out before it is queued into again. On
    the CPU `wait` makes to_host's copies, one synchronisation each."""

    def __init__(self, device):
        device = torch.device(device)
        self._cuda = device.type == "cuda"
        self._sets = ({}, {})
        self._next = 0
        if self._cuda:
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(), torch.cuda.Event())

    def queue(self, tensors: dict):
        """Queue the copies of `tensors` (name -> tensor, in the layout the
        host keeps); returns what `wait` takes. The tensors are referenced
        until then."""
        if not self._cuda:
            return tensors
        i, self._next = self._next, 1 - self._next
        buffers, pinned = self._sets[i], {}
        for name, t in tensors.items():
            buf = buffers.get(name)
            if buf is None or buf.dtype != t.dtype or buf.numel() < t.numel():
                buf = buffers[name] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            pinned[name] = buf[:t.numel()].view(t.shape)
            pinned[name].copy_(t, non_blocking=True)
        self._events[i].record(self._stream)
        return i, pinned, tensors

    def wait(self, queued, counted: span) -> dict:
        """Wait for copies `queue` made; returns name -> C-contiguous host
        array, counting the synchronisations and bytes on `counted`."""
        if not self._cuda:
            return {name: to_host(t.contiguous(), counted) for name, t in queued.items()}
        i, pinned, _ = queued
        self._events[i].synchronize()
        counted.add(syncs=1, d2h_bytes=sum(t.nbytes for t in pinned.values()))
        return {name: t.numpy().copy() for name, t in pinned.items()}


class _Block:
    """A block of run_mcmc queued on the device and not yet recorded: its
    first step and length, its `sampler/block` span, the generator state
    before its draws (`saved`) and after them (`rng`, for the sidecar),
    where it started and ended, and its queued copies."""

    __slots__ = ("start", "nsteps", "span", "saved", "rng", "pos0", "lnp0", "final", "copies")

    def __init__(self, start, nsteps, blk, saved, pos0, lnp0):
        self.start, self.nsteps, self.span, self.saved = start, nsteps, blk, saved
        self.pos0, self.lnp0 = pos0, lnp0
        self.rng = self.final = self.copies = None


@dataclasses.dataclass
class EnsembleSampler:
    """Stateful wrapper with the reference chain-file contract.

    The reference drives emcee one step at a time, saving the cumulative
    chain as a (nwalkers, nsteps, ndim) .npy after every step and resuming
    from chain[:, -1, :] (reference inference.py:460-473). Here steps run
    on the device in blocks of `checkpoint_every` and the same .npy
    contract is honored at block boundaries, with a `.state.npz` sidecar
    (positions, lnprob, acceptance counters and the generator state) for
    an exact continuation of the random stream.
    """

    lnprob_fn: callable
    nwalkers: int
    ndim: int
    a: float = 2.0
    dtype: torch.dtype = torch.float32
    # keyword-only: JAX's next positional is its vmap switch `batched`
    _: dataclasses.KW_ONLY
    device: torch.device | str = DEFAULT_DEVICE

    #: Blocks run_mcmc queues on the device beyond the one it waits on.
    queue_ahead = 1

    def __post_init__(self):
        self.device = resolve_device(self.device, type(self).__name__)
        self._chain_blocks: list[np.ndarray] = []   # each (W, K, D)
        self._lnp_blocks: list[np.ndarray] = []
        self.accepted = 0
        self.total_proposals = 0

    def preload(self, chain: np.ndarray, lnprobability: np.ndarray | None = None):
        """Seed the sampler with an existing (W, S, D) chain so further
        run_mcmc calls append to it — the cross-run resume convention
        (reference inference.py:462-463 re-saves the cumulative chain and
        restarts from chain[:, -1, :])."""
        chain = np.asarray(chain)
        if chain.shape[0] != self.nwalkers or chain.shape[2] != self.ndim:
            raise ValueError(f"chain shaped {chain.shape} does not hold "
                             f"{self.nwalkers} walkers of {self.ndim} dims")
        self._chain_blocks = [chain]
        self._lnp_blocks = ([np.asarray(lnprobability)] if lnprobability is not None
                            else [np.full(chain.shape[:2], np.nan)])
        return last_position(chain)

    @property
    def chain(self) -> np.ndarray:
        """(nwalkers, nsteps, ndim), emcee layout (reference inference.py:462)."""
        if not self._chain_blocks:
            return np.empty((self.nwalkers, 0, self.ndim))
        return np.concatenate(self._chain_blocks, axis=1)

    @property
    def lnprobability(self) -> np.ndarray:
        if not self._lnp_blocks:
            return np.empty((self.nwalkers, 0))
        return np.concatenate(self._lnp_blocks, axis=1)

    @property
    def acceptance_fraction(self) -> float:
        return self.accepted / max(self.total_proposals, 1)

    def lnp0(self, pos: torch.Tensor) -> torch.Tensor:
        """lnprob of the starting positions."""
        with torch.no_grad():
            return self.lnprob_fn(pos)

    def prepare(self, pos, lnp0=None):
        """What the first block of run_mcmc would pay once a process, done
        ahead so a caller can time it apart as set-up: one step's
        draw_randomness from a generator of its own (the random kernels'
        first launch; the run's stream is untouched) and the starting
        lnprob (`lnp0(pos)`, unless `lnp0` is given; a kernel's first
        launch loads its library). Returns the lnp0 to pass to run_mcmc."""
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        with span("sampler/prepare"):
            draw_randomness(1, self.nwalkers, torch.Generator(device=self.device),
                            device=self.device, dtype=self.dtype)
            if lnp0 is not None:
                return torch.as_tensor(lnp0, dtype=self.dtype, device=self.device)
            return self.lnp0(pos)

    def thin(self, chain, lnps, accepted, thin: int):
        """Keep every thin-th of the raw steps of a (n_raw, W, D) block
        ending each group of `thin` raw moves: bitwise what
        run_ensemble(nsteps, thin=thin) records from the same stream."""
        if thin == 1:
            return chain, lnps, accepted
        n = chain.shape[0] // thin
        return (chain[thin - 1::thin], lnps[thin - 1::thin],
                accepted.reshape(n, thin).sum(dim=1))

    def _run_block(self, pos, lnp, generator, nsteps: int, thin: int):
        """One checkpoint block, (nsteps, W, D) layout."""
        return run_ensemble(self.lnprob_fn, pos, lnp, generator, nsteps, a=self.a,
                            thin=thin)

    @trace()
    def run_mcmc(self, pos, nsteps: int, generator: torch.Generator,
                 checkpoint_every: int = 256, chain_file: str | None = None,
                 progress: bool = False, thin: int = 1, max_retries: int = 2,
                 lnp0=None):
        """Run `nsteps` steps, checkpointing the cumulative chain per block.

        Alongside the chain .npy, a `<chain>.state.npz` sidecar records the
        exact sampler state (positions, lnprob, generator state, acceptance
        counters) so a later run can continue the random stream exactly
        (load_state). Randomness is drawn from `generator` block by block,
        so a run split at a block boundary and resumed equals the unsplit
        run bitwise. `lnp0` (from load_state) continues with the saved lnp
        rather than recomputing it.

        Blocks run one ahead (`queue_ahead`): block b + 1 is queued on the
        device, from block b's final state, before the host waits for block
        b's copies, so the card runs it while the host records block b and
        writes its checkpoint. The draws come from `generator` in block
        order all the same, and the sidecar written after block b holds the
        generator state as it was right after block b's draws.

        A block that raises a device error (DEVICE_ERRORS: a kernel
        wrapper's DeviceError or torch's AcceleratorError, raised as it is
        queued or, at the latest, at the wait for its copies) is run again
        on the same path from the generator state saved before it, up to
        `max_retries` times a block, so a recovered chain equals an
        unfaulted one bitwise; then the error is raised, the chain file
        holding the blocks before it. A block queued behind a faulted one
        is thrown away and queued again after it; a fault met while queuing
        the next block leaves the block before it to be recorded first.
        Shape, type and value errors propagate at once. A fault that
        poisons the CUDA context fails again and is raised.
        """
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        lnp = (self.lnp0(pos) if lnp0 is None
               else torch.as_tensor(lnp0, dtype=self.dtype, device=self.device))
        timer, copies = BlockTimer(self.device), HostCopies(self.device)
        outer = innermost_span()
        open_spans: dict[int, span] = {}        # first step -> its sampler/block span
        faults = collections.Counter()          # first step -> device errors met
        queue: collections.deque[_Block] = collections.deque()
        queued = done = 0
        try:
            while done < nsteps:
                while queued < nsteps and len(queue) <= self.queue_ahead:
                    n = min(checkpoint_every, nsteps - queued)
                    if queued not in open_spans:
                        open_spans[queued] = span("sampler/block", parent=outer).__enter__()
                    block = _Block(queued, n, open_spans[queued], generator.get_state(),
                                   pos, lnp)
                    try:
                        self._queue_block(block, generator, thin, timer, copies,
                                          chain_file is not None)
                    except DEVICE_ERRORS:
                        if not self._retry(faults, block, max_retries):
                            raise
                        generator.set_state(block.saved)
                        if queue:
                            break           # the blocks before it go first
                        continue
                    queue.append(block)
                    pos, lnp = block.final
                    queued += n
                block = queue.popleft()
                try:
                    with span("sampler/fetch", parent=block.span):
                        host = copies.wait(block.copies, block.span)
                except DEVICE_ERRORS:
                    if not self._retry(faults, block, max_retries):
                        raise
                    timer.drop()            # the blocks behind it are thrown away
                    queue.clear()
                    generator.set_state(block.saved)
                    pos, lnp, queued = block.pos0, block.lnp0, block.start
                    continue
                block.span.add(ahead=int(bool(queue) and not faults[block.start]),
                               **timer.read())
                with span("sampler/record", host=True, parent=block.span):
                    self._chain_blocks.append(host["chain"])
                    self._lnp_blocks.append(host["lnps"])
                    self.accepted += int(host["accepted"])
                    self.total_proposals += block.nsteps * thin * self.nwalkers
                    done += block.nsteps
                if chain_file is not None:
                    rng = self._rng_sidecar(block.rng, block.span)
                    if self.writes_files:
                        self._save_checkpoint(chain_file, dict(pos=host["pos"], lnp=host["lnp"]),
                                              rng, block.span)
                open_spans.pop(block.start).__exit__(None, None, None)
                if progress:
                    print(f"MCMC sampling: {done}/{nsteps} steps "
                          f"(acceptance {self.acceptance_fraction:.3f})", flush=True)
        finally:
            for blk in open_spans.values():     # the blocks an error left open
                blk.__exit__(None, None, None)
        return pos.cpu().numpy(), lnp.cpu().numpy()

    def _queue_block(self, block: _Block, generator, thin: int, timer: BlockTimer,
                     copies: HostCopies, sidecar: bool):
        """Queue `block` on the device and its copies to the host: the
        chain and lnps in the emcee layout ((W, K, D), (W, K)), the
        accepted count, and the final positions and lnprob where a
        sidecar is written. Records in `block` its final state, its copies
        and, for a sidecar, the generator state after its draws."""
        with span("sampler/enqueue", parent=block.span):
            with timer:
                chain, lnps, accepted, block.final = self._run_block(
                    block.pos0, block.lnp0, generator, block.nsteps, thin)
            if sidecar:
                block.rng = self._rng_state(generator)
            tensors = dict(chain=chain.transpose(0, 1), lnps=lnps.transpose(0, 1),
                           accepted=accepted.sum())
            if sidecar and self.writes_files:
                tensors.update(pos=block.final[0], lnp=block.final[1])
            block.copies = copies.queue(tensors)

    @staticmethod
    def _retry(faults: collections.Counter, block: _Block, max_retries: int) -> bool:
        """Count a device error met by `block`; whether it may run again."""
        faults[block.start] += 1
        if faults[block.start] > max_retries:
            return False
        logger.warning("device error in the MCMC block at step %d; running it again from "
                       "its saved random state (%d/%d)", block.start, faults[block.start],
                       max_retries)
        return True

    def _save_checkpoint(self, chain_file: str, state: dict, rng: dict, blk: span):
        """Write the cumulative chain and the sidecar (`state`: the block's
        last positions and lnprob on the host; `rng`: _rng_sidecar's),
        under the block's span `blk`."""
        with span("sampler/checkpoint", host=True, parent=blk) as ckpt:
            np.save(chain_file, self.chain)
            np.savez(_state_path(chain_file), **state, accepted=self.accepted,
                     total_proposals=self.total_proposals, package=PACKAGE_TAG, **rng)
            chain_path = os.fspath(chain_file)
            if not chain_path.endswith(".npy"):   # np.save's suffix
                chain_path += ".npy"
            ckpt.add(bytes=os.path.getsize(chain_path)
                     + os.path.getsize(_state_path(chain_file)))

    def load_state(self, chain_file: str):
        """Restore (pos, lnp, generator_state) from a `.state.npz` sidecar
        for an exact continuation (pass lnp to run_mcmc's lnp0 and the
        state to `generator.set_state`); returns None if no sidecar
        exists. Refuses a sidecar this package did not write: its random
        state (e.g. a JAX PRNG key) cannot continue a stream here."""
        state_path = _state_path(chain_file)
        if not os.path.exists(state_path):
            return None
        state = np.load(state_path)
        if "package" not in state.files or str(state["package"]) != PACKAGE_TAG:
            raise ValueError(
                f"{state_path} was not written by {PACKAGE_TAG} (no package "
                "tag): its random state cannot continue a stream here; "
                "remove the sidecar to restart from the chain's last "
                "positions with a fresh stream")
        self.accepted = int(state["accepted"])
        self.total_proposals = int(state["total_proposals"])
        return state["pos"], state["lnp"], self._rng_restore(state, state_path)

    # Hooks of the chain-file contract; the sharded sampler
    # (parallel/sharded.py) overrides them.
    @property
    def writes_files(self) -> bool:
        """Whether this process writes the chain and the sidecar."""
        return True

    def _rng_state(self, generator) -> torch.Tensor:
        """The state to continue from after a block, taken right after the
        block's draws."""
        return generator.get_state()

    def _rng_sidecar(self, state: torch.Tensor, counted: span) -> dict:
        """The sidecar's random-state fields from `_rng_state`'s `state` (a
        copy from the device is counted on `counted`, as to_host counts
        it)."""
        return dict(rng_state=state.numpy())

    def _rng_restore(self, state, state_path: str):
        """The generator state to continue with, from a loaded sidecar."""
        return torch.from_numpy(state["rng_state"].copy())


@dataclasses.dataclass
class MultiChainSampler(EnsembleSampler):
    """K = n_chains independent ensembles with the chain-file contract
    (JAX stretch.py:299). `nwalkers` is the total, K * W.

    run_mcmc takes pos (K, W, D), or pooled (K*W, D) as a resumed chain's
    tail gives it. The recorded chain is the emcee (K*W, S, D) layout with
    whole chains contiguous, so `chain.reshape(K, W, S, D)` recovers each
    chain and `diagnostics.gelman_rubin` on the pooled chain measures
    cross-chain mixing. Each block draws chain 0's randomness, then chain
    1's, ..., from the one generator (draw_chain_randomness), so the
    sidecar's one generator state continues every chain.

    A block runs `run_fn` over the chain axis — a chain-batched whole-step
    runner (FusedEnsemble called with (K, W, D) positions: K1 or K2, one
    launch per k steps for all K chains), thinned by keeping every
    thin-th raw step — or, without one, run_ensemble_chains over
    `lnprob_fn`. The starting lnp comes from run_fn's lnprob where there
    is one (as FusedEnsembleSampler's), chain by chain.
    """

    _: dataclasses.KW_ONLY
    n_chains: int = 2
    run_fn: object = None
    k_steps: int = 16

    def __post_init__(self):
        super().__post_init__()
        if self.n_chains < 1 or self.nwalkers % self.n_chains:
            raise ValueError(f"nwalkers={self.nwalkers} must be divisible by "
                             f"n_chains={self.n_chains}")
        self.walkers_per_chain = self.nwalkers // self.n_chains

    def _shape_pos(self, pos):
        """(K, W, D) positions on the sampler's device, from (K, W, D) or
        pooled (K*W, D)."""
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        if pos.dim() == 2:
            pos = pos.reshape(self.n_chains, self.walkers_per_chain, -1)
        return pos

    def lnp0(self, pos):
        lnprob = self.run_fn.lnprob if self.run_fn is not None else self.lnprob_fn
        with torch.no_grad():
            return torch.stack([lnprob(p) for p in self._shape_pos(pos)])

    def _run_block(self, pos, lnp, generator, nsteps: int, thin: int):
        pos = self._shape_pos(pos)
        lnp = lnp.reshape(self.n_chains, self.walkers_per_chain)
        K, W, D = pos.shape
        n_raw = nsteps * thin
        rnd = draw_chain_randomness(K, n_raw, W, generator, device=pos.device,
                                    dtype=pos.dtype)
        if self.run_fn is not None:
            chain, lnps, acc, final = self.run_fn(pos, lnp, n_raw, self.k_steps,
                                                  randomness=rnd)
            n = n_raw
        else:
            chain, lnps, acc, final = run_ensemble_chains(
                self.lnprob_fn, pos, lnp, rnd, nsteps, a=self.a, thin=thin)
            n = nsteps
        # (K, n, W, D) -> (n, K*W, D): the base class transposes each block
        # to the pooled (K*W, n, D) emcee layout
        chain = chain.transpose(0, 1).reshape(n, K * W, D)
        lnps = lnps.transpose(0, 1).reshape(n, K * W)
        acc = acc.sum(dim=0)
        if n != nsteps:
            chain, lnps, acc = self.thin(chain, lnps, acc, thin)
        return chain, lnps, acc, final

    def run_mcmc(self, pos, nsteps: int, generator: torch.Generator, **kwargs):
        """EnsembleSampler.run_mcmc with pos (K, W, D) or pooled (K*W, D);
        returns the final (K, W, D) positions and (K, W) lnp."""
        return super().run_mcmc(self._shape_pos(pos), nsteps, generator, **kwargs)
