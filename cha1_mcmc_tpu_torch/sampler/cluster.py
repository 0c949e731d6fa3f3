"""The one binding of the cluster step kernels.

K1 and its sharded half-step K5a (csrc/fused_step.cu) and K2 and K5c
(csrc/multi_step.cu) spread one ensemble over a thread-block cluster
(csrc/cluster_step.cuh): n CTAs of 512 threads, CTA r owning proposals
[r h / n, (r + 1) h / n) of every half-update, four warps a proposal. Both
step kernels also have a wide path: h = W / 2 CTAs a chain in one
cooperative launch, CTA j owning proposal j of every half-update with all
its 16 warps. Each library is declared once, as a `Family` of what differs
(sampler/fused.py's and sampler/fused_multi.py's FAMILY), and this module
does the rest for either: `load_library` builds and binds it,
`smem_layout` lays out each launch's shared memory (the kernels only apply
the offsets), `plan_cluster` / `plan_wide` make a launch's geometry,
`admits` is the admission gate, `cluster_plan` takes the largest cluster
size the card can place, `steps_plan` decides a step launch's geometry —
the one place that chooses between the wide and the cluster path —
`checked_plan` checks a plan a caller hands in, and `launch_steps`,
`launch_lnprob` and `launch_half` launch the three entries. The helpers
every kernel binding of the port shares (K3 and K4 too) live here as well:
`bind_kernel_library`, `check_tensor`, `raise_on` and `route`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from cha1_mcmc_tpu_torch.utils.cuda_build import build_library
from cha1_mcmc_tpu_torch.utils.device import DeviceError

__all__ = ["THREADS", "GROUPS", "GROUP_WARPS", "LANE_WARPS", "CHAN_CONSTS", "CHAN_ROWS",
           "LINE_ROWS", "CLUSTER_SIZES", "SMEM_LIMIT", "REGIONS", "itemsize",
           "bind_kernel_library", "check_tensor", "raise_on", "route", "check_step_block",
           "check_half", "Family",
           "Library", "load_library", "SmemLayout", "smem_layout", "ClusterPlan",
           "plan_cluster", "plan_wide", "admits", "occupancy", "wide_capacity",
           "cluster_plan", "steps_plan", "checked_plan", "launch_steps", "launch_lnprob",
           "launch_half"]

#: What the layouts are sized by (checked against each library's
#: `<prefix>_geometry` entry when it loads): threads a CTA, warp groups a
#: CTA (the proposals of one round), warps a proposal, the warps of lanes
#: of a family's lnprob (csrc/cluster_step.cuh: kLaneWarps, one chi^2
#: partial each), per-channel constants (h nu / k, J(Tbg), ln(1 / sigma^2)
#: and the beam term); the rows of the chans (3, C) and lines (5, La)
#: tables; the cluster sizes tried, largest first (above 8 is
#: non-portable); a Hopper CTA's dynamic shared memory.
THREADS, GROUPS, GROUP_WARPS, LANE_WARPS, CHAN_CONSTS = 512, 4, 4, 16, 4
CHAN_ROWS, LINE_ROWS = 3, 5
CLUSTER_SIZES = (16, 8)
SMEM_LIMIT = 232_448
#: The regions of a launch's dynamic shared memory in the kernels' order
#: (csrc/cluster_step.cuh: SmemLayout): values of the walkers' dtype, then
#: int32.
T_REGIONS = ("state", "chans", "cc", "vel", "lines", "tau", "part", "prop", "zz")
I_REGIONS = ("line_idx", "group", "flag", "acc")
REGIONS = T_REGIONS + I_REGIONS
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# -- what every kernel binding shares ------------------------------------------

def bind_kernel_library(source_name: str, prefix: str, steps_args, lnprob_args,
                        statics_types, half_entry: str, half_args):
    """Build `csrc/<source_name>` (at first use) and bind its C entries:
    <prefix>_fused_steps_{f32,f64}, <prefix>_lnprob_{f32,f64} and the
    sharded half-step <half_entry>_{f32,f64} (K5), each taking (pointers,
    ints) = steps_args / lnprob_args / half_args counts then the stream
    and returning a CUDA error code; <prefix>_statics_size_*, checked
    against the ctypes statics struct per dtype; and
    <prefix>_error_string. Returns (library, nvcc build log, empty when a
    cached build was loaded)."""
    path, log = build_library(source_name)
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    for dtype, sfx in _SUFFIX.items():
        for entry, (n_ptr, n_int) in ((f"{prefix}_fused_steps", steps_args),
                                      (f"{prefix}_lnprob", lnprob_args),
                                      (half_entry, half_args)):
            fn = getattr(lib, f"{entry}_{sfx}")
            fn.argtypes, fn.restype = [P] * n_ptr + [I] * n_int + [P], I
        size = getattr(lib, f"{prefix}_statics_size_{sfx}")
        size.argtypes, size.restype = [], I
        if size() != ctypes.sizeof(statics_types[dtype]):
            raise RuntimeError(f"{source_name}: the {sfx} statics struct is "
                               f"{size()} bytes in the library but "
                               f"{ctypes.sizeof(statics_types[dtype])} in the binding")
    error_string = getattr(lib, f"{prefix}_error_string")
    error_string.argtypes, error_string.restype = [I], ctypes.c_char_p
    return lib, log


def check_tensor(t, name, dtype, shape, device, kernel: str = "K1"):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}; the kernel takes {dtype} {tuple(shape)} "
                         f"on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def raise_on(err: int, error_string, entry: str, kernel: str = "K1"):
    """Raise DeviceError if a C entry returned a CUDA error (`error_string`
    maps the code to its message)."""
    if err:
        raise DeviceError(f"{kernel} {entry} launch failed: CUDA error {err} "
                          f"({error_string(err).decode()})")


def route(t, kernel: str = "K1") -> str:
    """'cuda' (launch the kernel) or 'cpu' (the plain version) for a
    tensor; any other device raises."""
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{kernel} runs on CUDA (kernel) or on the CPU (plain "
                     f"version), not on {t.device}")


def check_step_block(coords, lnp, perm, z_u, pair, acc_u, kernel: str):
    """(K, W, D, k) of a step kernel's block of K chains — coords (K, W,
    D), lnp (K, W), perm (K, k*W) int32, z_u / pair (int32) / acc_u (K, 2k,
    W/2), each contiguous on coords' device in its dtype — after checking
    it."""
    dtype, dev = coords.dtype, coords.device
    if dtype not in _SUFFIX:
        raise ValueError(f"{kernel} takes float32 or float64 walkers, not {dtype}")
    if coords.dim() != 3:
        raise ValueError(f"{kernel}: coords {tuple(coords.shape)} is not (K, W, D)")
    K, W, D = coords.shape
    h, k = W // 2, z_u.shape[-2] // 2
    if W % 2 or not 1 <= K <= 65535:
        raise ValueError(f"{kernel}: {K} chains of {W} walkers (an even count, "
                         "1 to 65535 chains)")
    check_tensor(coords, "coords", dtype, (K, W, D), dev, kernel)
    check_tensor(lnp, "lnp", dtype, (K, W), dev, kernel)
    check_tensor(perm, "perm", torch.int32, (K, k * W), dev, kernel)
    check_tensor(z_u, "z_u", dtype, (K, 2 * k, h), dev, kernel)
    check_tensor(pair, "pair", torch.int32, (K, 2 * k, h), dev, kernel)
    check_tensor(acc_u, "acc_u", dtype, (K, 2 * k, h), dev, kernel)
    return K, W, D, k


def check_half(kernel, state, active, comp, z_u, pair, acc_u, ndim):
    """Check a sharded half-step's operands (K5a / K5b / K5c); returns
    (W_l, D, n_comp)."""
    dtype, dev = state.dtype, state.device
    if dtype not in _SUFFIX:
        raise ValueError(f"{kernel} takes float32 or float64 walkers, not {dtype}")
    W, D1 = state.shape
    D, h, n = D1 - 1, W // 2, comp.shape[0]
    if W % 2 or D != ndim:
        raise ValueError(f"{kernel}: a ({W}, {D1}) state for a {ndim}-dim problem "
                         "(takes an even walker count)")
    check_tensor(state, "state", dtype, (W, D1), dev, kernel)
    check_tensor(active, "active", torch.int32, (h,), dev, kernel)
    check_tensor(comp, "comp", dtype, (n, D), dev, kernel)
    for name, t in (("z_u", z_u), ("acc_u", acc_u)):
        check_tensor(t, name, dtype, (h,), dev, kernel)
    check_tensor(pair, "pair", torch.int32, (h,), dev, kernel)
    return W, D, n


# -- a family and its library ----------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Family:
    """A cluster step kernel library as the binding sees it. `steps` and
    `half` name its step kernel and its sharded half-step (K1 / K5a, K2 /
    K5c; their lowercase forms prefix the C entries), `source` is its file
    under csrc/, `args` the (pointers, ints) that its steps, lnprob and
    half-step entries take before the stream. `statics` maps a dtype to
    the ctypes statics struct that `pack(statics, dtype)` fills;
    `tables(tables, dtype, device, kernel)` checks a launch's tables and
    returns the ones the kernels read with (La, M, C, S). The layouts hold
    `partials` chi^2 partials a warp group and, with `group_table`, the
    entries' hfs groups. `launches` is the family module's launch counter,
    `counters` the keys of its steps, lnprob and half-step entries (the
    half-step's counted in the caller's dict). `wide`: the (pointers,
    ints) of the wide step entry, where the family has one."""

    steps: str
    half: str
    source: str
    args: tuple
    statics: dict
    pack: Callable
    tables: Callable
    partials: int
    group_table: bool
    launches: dict
    counters: tuple
    wide: tuple | None = None


class Library(NamedTuple):
    """A family's bound library: its C entries by (entry, dtype), entry
    one of "steps", "lnprob", "half", "occupancy" and, with a wide path,
    "wide" and "wide_capacity"; its CUDA error-string entry; and the nvcc
    build log (empty where a cached build was loaded)."""

    entries: dict
    error_string: Callable
    log: str


@functools.cache
def load_library(family: Family) -> Library:
    """Build the family's library (at first use), bind its entries, and
    check its `<prefix>_geometry` — threads a CTA, warp groups a CTA,
    chi^2 partials a group, per-channel constants and sizeof(SmemLayout) —
    against what smem_layout sizes its regions by."""
    prefix, half = family.steps.lower(), f"{family.half.lower()}_half"
    lib, log = bind_kernel_library(family.source, prefix, *family.args[:2], family.statics,
                                   half, family.args[2])
    P, I = ctypes.c_void_p, ctypes.c_int
    names = dict(steps=f"{prefix}_fused_steps", lnprob=f"{prefix}_lnprob", half=half,
                 occupancy=f"{prefix}_cluster_occupancy")
    types = dict(occupancy=([I] * 2 + [P, ctypes.POINTER(I)], I))
    if family.wide is not None:
        names.update(wide=f"{prefix}_wide_steps", wide_capacity=f"{prefix}_wide_capacity")
        types.update(wide=([P] * family.wide[0] + [I] * family.wide[1] + [P], I),
                     wide_capacity=([P, ctypes.POINTER(I)], I))
    entries = {}
    for entry, name in names.items():
        for dtype, sfx in _SUFFIX.items():
            fn = entries[entry, dtype] = getattr(lib, f"{name}_{sfx}")
            if entry in types:
                fn.argtypes, fn.restype = types[entry]
    geometry = (ctypes.c_int * 5)()
    fn = getattr(lib, f"{prefix}_geometry")
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    fn(geometry)
    want = (THREADS, GROUPS, family.partials, CHAN_CONSTS, 4 * (len(REGIONS) + 2))
    if tuple(geometry) != want:
        raise RuntimeError(f"{family.source}: (threads, groups, partials a group, channel "
                           f"constants, sizeof(SmemLayout)) are {tuple(geometry)} in the "
                           f"library but {want} in the binding")
    return Library(entries, getattr(lib, f"{prefix}_error_string"), log)


# -- shared memory and geometry ----------------------------------------------------

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
def smem_layout(family: Family, dtype, ncomp: int, n_lines: int, n_channels: int,
                n_entries: int, *, state_rows: int = 0, ndim: int = 0, per_cta: int = 0,
                stage: bool | None = None, groups: int = GROUPS) -> SmemLayout:
    """The shared memory of one of the family's launches over `ncomp`
    components, La = n_lines active lines, C = n_channels and M =
    n_entries table entries a channel: [the (state_rows, D+1) state,] [the
    staged tables: chans (3, C), the per-channel constants (4, C), the
    entry velocities (M, C), lines (5, La),] each of the `groups` warp
    groups' (K, La) tau and the family's chi^2 partials, the owned
    proposals (per_cta, D+1) and their stretch factors; [the entry line
    indices (M, C) and, with the family's group table (K2), hfs groups (M,
    C),] per_cta flags and two counters. Each region starts where the last
    ends, so every region is aligned to its type. `stage` None stages the
    tables where the staged layout fits a CTA, else not: the unstaged
    layout does not grow with the channels."""
    if stage is None:
        kw = dict(state_rows=state_rows, ndim=ndim, per_cta=per_cta, groups=groups)
        staged = smem_layout(family, dtype, ncomp, n_lines, n_channels, n_entries,
                             stage=True, **kw)
        return staged if staged.fits else smem_layout(
            family, dtype, ncomp, n_lines, n_channels, n_entries, stage=False, **kw)
    t, C, MC, D1 = int(stage), n_channels, n_entries * n_channels, ndim + 1
    sizes = dict(state=state_rows * D1, chans=t * CHAN_ROWS * C, cc=t * CHAN_CONSTS * C,
                 vel=t * MC, lines=t * LINE_ROWS * n_lines, tau=groups * ncomp * n_lines,
                 part=groups * family.partials, prop=per_cta * D1, zz=per_cta,
                 line_idx=t * MC, group=t * MC * int(family.group_table), flag=per_cta,
                 acc=2)
    offsets, at = [], 0
    for names, item in ((T_REGIONS, itemsize(dtype)), (I_REGIONS, 4)):
        for name in names:
            offsets.append(at)
            at += item * sizes[name]
    return SmemLayout(tuple(offsets), at, bool(stage))


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The geometry of one launch: `cluster` CTAs a chain, each owning a
    slice of the `proposals` (h = W / 2) of every half-update — at most
    `per_cta` — evaluated by `warps_per_proposal` warps each, with the
    shared memory `layout`. `shape` is what the plan was made for (the
    family, its sizes, the itemsize and whether the state is resident),
    checked by checked_plan. `wide`: the h CTAs of a chain run as one
    cooperative launch with no thread-block cluster, one proposal each
    (plan_wide)."""

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


def _shape(family, nwalkers, ncomp, ndim, n_lines, n_channels, n_entries, dtype,
           resident_state) -> tuple:
    return (family.steps, nwalkers, ncomp, ndim, n_lines, n_channels, n_entries,
            itemsize(dtype), resident_state)


def plan_cluster(family: Family, nwalkers: int, ncomp: int, ndim: int, n_lines: int,
                 n_channels: int, n_entries: int, dtype, *, cluster: int = 16,
                 resident_state: bool = True, stage: bool | None = None) -> ClusterPlan:
    """The cluster geometry of one of the family's step launches
    (`resident_state`: each CTA holds the (W, D+1) state) or half-step
    launches (the state stays in device memory) over `ncomp` components
    of `ndim` dims, La = n_lines active lines, C = n_channels and M =
    n_entries table entries a channel: P = ceil(h / cluster) proposals a
    CTA at most, and its smem_layout — the tables staged where that fits
    (`stage` None), so the channel count sets only how fast it runs."""
    h = nwalkers // 2
    per_cta = -(-h // cluster)
    layout = smem_layout(family, dtype, ncomp, n_lines, n_channels, n_entries,
                         state_rows=nwalkers if resident_state else 0, ndim=ndim,
                         per_cta=per_cta, stage=stage)
    return ClusterPlan(cluster, h, per_cta, GROUP_WARPS, layout, _shape(
        family, nwalkers, ncomp, ndim, n_lines, n_channels, n_entries, dtype,
        resident_state))


def plan_wide(family: Family, nwalkers: int, ncomp: int, ndim: int, n_lines: int,
              n_channels: int, n_entries: int, dtype, *,
              stage: bool | None = None) -> ClusterPlan:
    """The geometry of a step launch on the wide path: h = W / 2 CTAs
    a chain and no thread-block cluster, CTA j owning proposal j of every
    half-update (owned(j) is [j, j + 1)) with all its 16 warps, one lnprob
    group; no copy of the state in shared memory (the kernel reads the
    rows it needs from the chain output), the tables staged where they fit
    (`stage` None)."""
    h = nwalkers // 2
    layout = smem_layout(family, dtype, ncomp, n_lines, n_channels, n_entries, ndim=ndim,
                         per_cta=1, stage=stage, groups=1)
    return ClusterPlan(h, h, 1, THREADS // 32, layout, _shape(
        family, nwalkers, ncomp, ndim, n_lines, n_channels, n_entries, dtype, True),
        wide=True)


def admits(family: Family, nwalkers: int, ncomp: int, ndim: int, n_lines: int, dtype, *,
           resident_state: bool = True) -> bool:
    """The admission gate: does the family's step kernel (its half-step
    with resident_state False) take `nwalkers` walkers of `ncomp`
    components and `ndim` dims over at most `n_lines` active lines? Its
    cluster plan at the portable size of 8 CTAs — the larger share per
    CTA — within a Hopper CTA's 232,448 bytes of shared memory. The tables
    are staged where they fit and read from device memory otherwise, a
    layout that grows with the walkers and the lines but not with the
    channels, so the answer is that unstaged layout's."""
    return plan_cluster(family, nwalkers, ncomp, ndim, n_lines, 1, 1, dtype,
                        cluster=min(CLUSTER_SIZES), resident_state=resident_state,
                        stage=False).fits


# -- the card's choice -------------------------------------------------------------

def occupancy(family: Family, entry: str, plan: ClusterPlan, dtype, device) -> int | None:
    """cudaOccupancyMaxActiveClusters of the family's step ("steps") or
    half-step ("half") kernel for `plan` (0: the card cannot place a
    cluster of that size); None off the card, where it is not asked.
    Raises DeviceError on a CUDA error."""
    if device.type != "cuda":
        return None
    lib = load_library(family)
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.entries["occupancy", dtype](int(entry != "steps"), plan.cluster,
                                              ctypes.addressof(plan.layout.packed),
                                              ctypes.byref(active))
    if err:
        raise DeviceError(f"{family.steps} {entry} cluster occupancy failed: CUDA error "
                          f"{err} ({lib.error_string(err).decode()})")
    return active.value


@functools.lru_cache(maxsize=64)
def wide_capacity(family: Family, layout: SmemLayout, dtype, device) -> int:
    """The CTAs of the family's wide step kernel at `layout` that the card
    keeps resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    x SMs); 0 where the card has no cooperative launch, and off the card,
    where nothing is launched."""
    if device.type != "cuda":
        return 0
    lib = load_library(family)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.entries["wide_capacity", dtype](ctypes.addressof(layout.packed),
                                                  ctypes.byref(out))
    raise_on(err, lib.error_string, "wide capacity", family.steps)
    return out.value


@functools.lru_cache(maxsize=64)
def cluster_plan(family: Family, entry: str, nwalkers: int, ncomp: int, ndim: int,
                 n_lines: int, n_channels: int, n_entries: int, dtype,
                 device: torch.device) -> tuple[ClusterPlan, int | None]:
    """The cluster geometry a step ("steps") or half-step ("half") launch
    takes on `device`: the plan of the largest cluster size
    (CLUSTER_SIZES) that fits shared memory and of which the card places a
    cluster, with cudaOccupancyMaxActiveClusters for it; off the card,
    where it is not asked, the largest size that fits, with None. Raises
    naming what it tried where no size can run."""
    tried = []
    for n in CLUSTER_SIZES:
        plan = plan_cluster(family, nwalkers, ncomp, ndim, n_lines, n_channels, n_entries,
                            dtype, cluster=n, resident_state=entry == "steps")
        if not plan.fits:
            tried.append(f"{n} CTAs need {plan.smem_bytes} B of shared memory each")
            continue
        active = occupancy(family, entry, plan, dtype, device)
        if active is None or active > 0:
            return plan, active
        tried.append(f"the card places no cluster of {n} CTAs")
    raise ValueError(f"{family.steps if entry == 'steps' else family.half} {entry}: "
                     f"{nwalkers} walkers x {ncomp} components x {ndim} dims x {n_lines} "
                     f"lines x {n_channels} channels x {n_entries} entries: no cluster "
                     f"geometry runs it ({'; '.join(tried)})")


@functools.lru_cache(maxsize=64)
def steps_plan(family: Family, nwalkers: int, chains: int, ncomp: int, ndim: int,
               n_lines: int, n_channels: int, n_entries: int, dtype,
               device: torch.device) -> ClusterPlan:
    """The plan a step launch of `chains` chains takes on `device`: the
    wide plan where the family has a wide path, the plan fits a CTA and
    the chains' h CTAs each fit the CTAs the card keeps resident at once
    (wide_capacity), else cluster_plan's. The one choice of a step
    launch's geometry: the launch takes it (checked_plan) and the fits'
    spans report it (FusedEnsemble.plan_counts: K1's sampler-choice
    `pipeline/model`, K2's `pipeline/k2_plan`).
    Off the card the card's answers are absent: capacity 0, and the
    largest cluster size that fits."""
    sizes = (nwalkers, ncomp, ndim, n_lines, n_channels, n_entries, dtype)
    if family.wide is not None:
        wide = plan_wide(family, *sizes)
        if wide.fits and chains * wide.cluster <= wide_capacity(family, wide.layout, dtype,
                                                                device):
            return wide
    return cluster_plan(family, "steps", *sizes, device)[0]


def checked_plan(family: Family, entry: str, plan: ClusterPlan | None, nwalkers: int,
                 chains: int, ncomp: int, ndim: int, n_lines: int, n_channels: int,
                 n_entries: int, dtype, device) -> ClusterPlan:
    """The plan a step ("steps", of `chains` chains) or half-step ("half")
    launch runs: steps_plan's / cluster_plan's, or the caller's `plan`
    (made with plan_cluster or plan_wide, as the card tests choose the
    wide path, 8 CTAs or unstaged tables) after checking that it was made
    for this family, entry and these sizes and fits a CTA."""
    sizes = (nwalkers, ncomp, ndim, n_lines, n_channels, n_entries, dtype)
    if plan is None:
        if entry == "steps":
            return steps_plan(family, nwalkers, chains, *sizes[1:], device)
        return cluster_plan(family, entry, *sizes, device)[0]
    shape = _shape(family, *sizes, entry == "steps")
    if plan.shape != shape or not plan.fits:
        raise ValueError(f"{family.steps if entry == 'steps' else family.half} {entry}: a "
                         f"plan for {plan.shape} ({plan.smem_bytes} B a CTA) cannot launch "
                         f"{shape}")
    return plan


# -- the launches ------------------------------------------------------------------

def launch_steps(family: Family, coords, lnp, perm, z_u, pair, acc_u, tables, st, plan):
    """One launch of the family's step kernel over K chains
    (check_step_block's layout; a (W, D) block is one chain) on
    checked_plan's path: one cluster a chain, or h CTAs a chain on a wide
    plan. Returns chain (K, k*W, D), lnps (K, k*W), acc (K, k), without
    the chain axis for one chain. A wide launch the card refuses raises."""
    if coords.dim() == 2:
        out = launch_steps(family, *(t.unsqueeze(0) for t in (coords, lnp, perm, z_u, pair,
                                                              acc_u)), tables, st, plan)
        return tuple(t[0] for t in out)
    lib = load_library(family)
    dtype, dev = coords.dtype, coords.device
    K, W, D, k = check_step_block(coords, lnp, perm, z_u, pair, acc_u, family.steps)
    if D != st.ndim:
        raise ValueError(f"{family.steps}: {D}-dim walkers for a {st.ndim}-dim problem")
    tb, (La, M, C, S) = family.tables(tables, dtype, dev, family.steps)
    plan = checked_plan(family, "steps", plan, W, K, st.ncomp, D, La, C, M, dtype, dev)
    out_chain = torch.empty((K, k * W, D), dtype=dtype, device=dev)
    out_lnps = torch.empty((K, k * W), dtype=dtype, device=dev)
    out_acc = torch.empty((K, k), dtype=torch.float32, device=dev)
    entry, tail = ("wide", ()) if plan.wide else ("steps", (plan.cluster,))
    with torch.cuda.device(dev):
        err = lib.entries[entry, dtype](
            coords.data_ptr(), lnp.data_ptr(), perm.data_ptr(), z_u.data_ptr(),
            pair.data_ptr(), acc_u.data_ptr(), *(t.data_ptr() for t in tb),
            out_chain.data_ptr(), out_lnps.data_ptr(), out_acc.data_ptr(),
            ctypes.addressof(family.pack(st, dtype)), ctypes.addressof(plan.layout.packed),
            W, D, La, M, C, S, k, K, *tail, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.error_string, family.counters[0], family.steps)
    family.launches[family.counters[0]] += 1
    return out_chain, out_lnps, out_acc


def launch_lnprob(family: Family, theta, tables, st, plan=None):
    """One launch of the family's lnprob entry, (N, D) -> (N,): its tables
    staged where they fit, or as `plan` stages them."""
    lib = load_library(family)
    dtype, dev = theta.dtype, theta.device
    if dtype not in _SUFFIX:
        raise ValueError(f"{family.steps} takes float32 or float64 thetas, not {dtype}")
    N, D = theta.shape
    if D != st.ndim:
        raise ValueError(f"{family.steps}: {D}-dim thetas for a {st.ndim}-dim problem")
    check_tensor(theta, "theta", dtype, (N, D), dev, family.steps)
    tb, (La, M, C, S) = family.tables(tables, dtype, dev, family.steps)
    layout = smem_layout(family, dtype, st.ncomp, La, C, M,
                         stage=None if plan is None else plan.staged)
    if not layout.fits:
        raise ValueError(f"{family.steps} lnprob: {st.ncomp} components x {La} lines need "
                         f"{layout.bytes} B of shared memory (> {SMEM_LIMIT})")
    out = torch.empty(N, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.entries["lnprob", dtype](
            theta.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tb),
            ctypes.addressof(family.pack(st, dtype)), ctypes.addressof(layout.packed),
            N, D, La, M, C, S, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.error_string, family.counters[1], family.steps)
    family.launches[family.counters[1]] += 1
    return out


def launch_half(family: Family, counts: dict, state, active, comp, z_u, pair, acc_u, tables,
                st, plan):
    """One launch of the family's sharded half-step (operands as in
    parallel/sharded_fused.py:half_update_plain) on checked_plan's
    cluster, counted in `counts`: updates the (W_l, D+1) state in place
    and returns the accepted count, (1,) float32."""
    lib = load_library(family)
    W, D, _ = check_half(family.half, state, active, comp, z_u, pair, acc_u, st.ndim)
    dtype, dev = state.dtype, state.device
    tb, (La, M, C, S) = family.tables(tables, dtype, dev, family.half)
    plan = checked_plan(family, "half", plan, W, 1, st.ncomp, D, La, C, M, dtype, dev)
    out_acc = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.entries["half", dtype](
            *(t.data_ptr() for t in (state, active, comp, z_u, pair, acc_u)),
            *(t.data_ptr() for t in tb), out_acc.data_ptr(),
            ctypes.addressof(family.pack(st, dtype)), ctypes.addressof(plan.layout.packed),
            W, D, La, M, C, S, plan.cluster, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.error_string, family.counters[2], family.half)
    counts[family.counters[2]] += 1
    return out_acc
