"""The launch geometry of the cluster step kernels.

K1 and its sharded half-step K5a (csrc/fused_step.cu) and K2 and K5c
(csrc/multi_step.cu) spread one ensemble over a thread-block cluster
(csrc/cluster_step.cuh): n CTAs of 512 threads, CTA r owning proposals
[r h / n, (r + 1) h / n) of every half-update, four warps a proposal
(K2 also has a wide path of h CTAs a chain, sampler/fused_multi.py).
This module is the one place that sizes those launches: `smem_layout`
lays out each launch's shared-memory regions (the kernels only apply the
offsets), `ClusterPlan` is one launch's geometry, `cluster_plan` takes the
largest cluster size the card can place and `checked_plan` checks a plan a
caller hands in. `bind_cluster_entries` checks, when a library loads, that
its kernels were built with the constants the layout is sized by.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cha1_mcmc_tpu_torch.utils.device import DeviceError

__all__ = ["THREADS", "GROUPS", "GROUP_WARPS", "CHAN_CONSTS", "CHAN_ROWS", "LINE_ROWS",
           "CLUSTER_SIZES", "SMEM_LIMIT", "REGIONS", "itemsize", "SmemLayout",
           "smem_layout", "ClusterPlan", "make_plan", "bind_cluster_entries", "occupancy",
           "cluster_plan", "checked_plan"]

#: What the layouts are sized by (checked against each library's
#: `<prefix>_geometry` entry when it loads): threads a CTA, warp groups a
#: CTA (the proposals of one round), warps a proposal, per-channel
#: constants (h nu / k, J(Tbg), ln(1 / sigma^2) and the beam term); the
#: rows of the chans (3, C) and lines (5, La) tables; the cluster sizes
#: tried, largest first (above 8 is non-portable); a Hopper CTA's dynamic
#: shared memory.
THREADS, GROUPS, GROUP_WARPS, CHAN_CONSTS = 512, 4, 4, 4
CHAN_ROWS, LINE_ROWS = 3, 5
CLUSTER_SIZES = (16, 8)
SMEM_LIMIT = 232_448
#: The regions of a launch's dynamic shared memory in the kernels' order
#: (csrc/cluster_step.cuh: SmemLayout): values of the walkers' dtype, then
#: int32.
T_REGIONS = ("state", "chans", "cc", "vel", "lines", "tau", "part", "prop", "zz")
I_REGIONS = ("line_idx", "group", "flag", "acc")
REGIONS = T_REGIONS + I_REGIONS


def itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class SmemLayout:
    """The dynamic shared memory of one launch: the byte offset of each of
    REGIONS (size 0 where the launch has none), the total, and whether the
    tables are staged (copied into shared memory with the per-channel
    constants) or read from device memory."""

    offsets: tuple
    bytes: int
    staged: bool

    @property
    def fits(self) -> bool:
        """Within a Hopper CTA's 232,448 bytes of shared memory?"""
        return self.bytes <= SMEM_LIMIT

    @functools.cached_property
    def packed(self):
        """The kernels' SmemLayout struct: every offset, the total and the
        staging, each an int32."""
        return (ctypes.c_int32 * (len(REGIONS) + 2))(*self.offsets, self.bytes,
                                                     int(self.staged))


@functools.lru_cache(maxsize=512)
def smem_layout(dtype, ncomp: int, n_lines: int, n_channels: int, n_entries: int, *,
                state_rows: int = 0, ndim: int = 0, per_cta: int = 0,
                stage: bool | None = None, group_table: bool = True, groups: int = GROUPS,
                partials: int = GROUP_WARPS) -> SmemLayout:
    """The shared memory of a launch over `ncomp` components, La = n_lines
    active lines, C = n_channels and M = n_entries table entries a channel:
    [the (state_rows, D+1) state,] [the staged tables: chans (3, C), the
    per-channel constants (4, C), the entry velocities (M, C), lines (5,
    La),] each of the `groups` warp groups' (K, La) tau and `partials`
    chi^2 partials (one a warp for K1), the owned
    proposals (per_cta, D+1) and their stretch factors; [the entry line
    indices (M, C) and, with `group_table` (K2), hfs groups (M, C),]
    per_cta flags and two counters. Each region starts where the last
    ends, so every region is aligned to its type. `stage` None stages the
    tables where the staged layout fits a CTA, else not: the unstaged
    layout does not grow with the channels."""
    if stage is None:
        kw = dict(state_rows=state_rows, ndim=ndim, per_cta=per_cta, group_table=group_table,
                  groups=groups, partials=partials)
        staged = smem_layout(dtype, ncomp, n_lines, n_channels, n_entries, stage=True, **kw)
        return staged if staged.fits else smem_layout(
            dtype, ncomp, n_lines, n_channels, n_entries, stage=False, **kw)
    t, C, MC, D1 = int(stage), n_channels, n_entries * n_channels, ndim + 1
    sizes = dict(state=state_rows * D1, chans=t * CHAN_ROWS * C, cc=t * CHAN_CONSTS * C,
                 vel=t * MC, lines=t * LINE_ROWS * n_lines, tau=groups * ncomp * n_lines,
                 part=groups * partials, prop=per_cta * D1, zz=per_cta,
                 line_idx=t * MC, group=t * MC * int(group_table), flag=per_cta, acc=2)
    offsets, at = [], 0
    for names, item in ((T_REGIONS, itemsize(dtype)), (I_REGIONS, 4)):
        for name in names:
            offsets.append(at)
            at += item * sizes[name]
    return SmemLayout(tuple(offsets), at, bool(stage))


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The geometry of one step launch: `cluster` CTAs a chain, each
    owning a slice of the `proposals` (h = W / 2) of every half-update — at
    most `per_cta` — evaluated by `warps_per_proposal` warps each, with the
    shared memory `layout`. `shape` is what the plan was made for (the
    kernel's sizes, the itemsize and whether the state is resident),
    checked by the wrapper that launches it. `wide` (K2 only): the h CTAs
    of a chain run as one cooperative launch with no thread-block cluster,
    one proposal each (sampler/fused_multi.py:plan_multi_wide)."""

    cluster: int
    proposals: int
    per_cta: int
    warps_per_proposal: int
    layout: SmemLayout
    shape: tuple
    wide: bool = False

    def owned(self, rank: int) -> range:
        """The proposals CTA `rank` owns (csrc/cluster_step.cuh:owned_slice)."""
        h, n = self.proposals, self.cluster
        return range(rank * h // n, (rank + 1) * h // n)

    @property
    def smem_bytes(self) -> int:
        return self.layout.bytes

    @property
    def staged(self) -> bool:
        return self.layout.staged

    @property
    def fits(self) -> bool:
        return self.layout.fits


def make_plan(nwalkers: int, cluster: int, layout_of, shape: tuple) -> ClusterPlan:
    """The plan of a cluster of `cluster` CTAs over nwalkers walkers: P =
    ceil(h / cluster) proposals a CTA at most, and `layout_of(P)`."""
    h = nwalkers // 2
    per_cta = -(-h // cluster)
    return ClusterPlan(cluster, h, per_cta, GROUP_WARPS, layout_of(per_cta), shape)


def bind_cluster_entries(lib, prefix: str, source: str, partials: int = GROUP_WARPS) -> None:
    """Bind `<prefix>_cluster_occupancy_{f32,f64}` of a loaded library and
    check `<prefix>_geometry` — threads a CTA, warp groups a CTA, chi^2
    partials a group (`partials`: K1's one a warp by default),
    per-channel constants and sizeof(SmemLayout) — against what
    smem_layout sizes the library's regions by."""
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"{prefix}_cluster_occupancy_{sfx}")
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    geometry = (ctypes.c_int * 5)()
    fn = getattr(lib, f"{prefix}_geometry")
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    fn(geometry)
    want = (THREADS, GROUPS, partials, CHAN_CONSTS, 4 * (len(REGIONS) + 2))
    if tuple(geometry) != want:
        raise RuntimeError(f"{source}: (threads, groups, partials a group, channel constants, "
                           f"sizeof(SmemLayout)) are {tuple(geometry)} in the library but "
                           f"{want} in the binding")


def occupancy(fn, error_string, what: str, entry: int, plan: ClusterPlan, device) -> int:
    """cudaOccupancyMaxActiveClusters of kernel `entry` of a library's
    occupancy entry `fn` for `plan` (0: the card cannot place a cluster of
    that size). Raises DeviceError with `error_string`'s message on a CUDA
    error."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(entry, plan.cluster, ctypes.addressof(plan.layout.packed),
                 ctypes.byref(active))
    if err:
        raise DeviceError(f"{what} cluster occupancy failed: CUDA error {err} "
                           f"({error_string(err).decode()})")
    return active.value


def cluster_plan(what: str, plan_of, occupancy_of) -> tuple[ClusterPlan, int]:
    """The plan of the largest cluster size (CLUSTER_SIZES) whose plan
    `plan_of(n)` fits shared memory and of which the card places a cluster
    (`occupancy_of(plan)` > 0: cudaOccupancyMaxActiveClusters), with that
    count. Raises naming what it tried where no size can run; `what` names
    the launch."""
    tried = []
    for n in CLUSTER_SIZES:
        plan = plan_of(n)
        if not plan.fits:
            tried.append(f"{n} CTAs need {plan.smem_bytes} B of shared memory each")
            continue
        active = occupancy_of(plan)
        if active > 0:
            return plan, active
        tried.append(f"the card places no cluster of {n} CTAs")
    raise ValueError(f"{what}: no cluster geometry runs it ({'; '.join(tried)})")


def checked_plan(what: str, plan: ClusterPlan | None, shape: tuple, default) -> ClusterPlan:
    """The plan a launch runs: `default()` (the cached cluster_plan), or
    the caller's `plan` after checking that it was made for `shape` and
    fits a CTA (the card tests hand in 8 CTAs or unstaged tables)."""
    if plan is None:
        return default()
    if plan.shape != shape or not plan.fits:
        raise ValueError(f"{what}: a plan for {plan.shape} ({plan.smem_bytes} B a "
                         f"CTA) cannot launch {shape}")
    return plan
