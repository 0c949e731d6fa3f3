"""The CUDA kernels K1, K2, K3, K4a / K4b, K5a / K5b / K5c and T3 against
their plain PyTorch versions, on an NVIDIA GPU.

The same checks as phase 3 of chip_smoke.py, through its check functions:
K1 on the synthetic flagship problem (128 walkers; analytic, Chebyshev
and state-sum Q; 4- and 5-dim), K2 on the full-size synthetic GOTHAM
problem (128 walkers; K=4 with the three Q kinds, and the K=1 ordered
family), K3 on the full-size synthetic dense problem (128 walkers;
Chebyshev and state-sum Q on the split tables, Chebyshev on the
rectangular table, analytic Q in 5 dims): the f32 lnprob entry (rtol
2e-5), the f64 whole-step kernel over 64 steps (chain and acceptances
bitwise, lnps rtol 1e-12) and the f32 whole-step kernel over 1024 (K1) /
512 (K2) / 1024 (K3) steps (acceptance fraction within 0.02); K4a / K4b's
opacity on the dense problem in both formulas, masked and unmasked, at
64, 100, 128 and 256 walkers, at the prior's dV bound, with narrow
windows and outside the prior box, and one launch per K4 call; the
sharded half-steps K5a / K5c / K5b at world size 1, against their plain
versions and against K1 / K2 / K3; T3's probes. K3 also at channel blocks
of 128, 256 and 512, each at the card's grid, at a grid of a few CTAs and
with its taus in device memory (K5b at world size 1 against it), and one
kernel launch per K3 / K5b call. Beyond chip_smoke, the
cluster launches of K1 and K2 over walker counts whose proposals split
raggedly over their CTAs, at 16 CTAs, 8 CTAs and 16 CTAs with the tables
in device memory: f64 64-step chains bitwise against the plain version —
K1 at W = 64, 96, 100, 256 and 2048 in analytic 4 dims and state-sum 5
dims, K2 at W = 64, 96, 100 and 256 for K = 1, 2 and 4, each also on its
wide path of W / 2 CTAs (not K1 at 2048) (lnps rtol 1e-12; the lnprob
entry equal to the in-chain lnps; K5a / K5c at the same W) — and K5a /
K5c at W_l = 32, 40 and 64 bitwise against their plain versions and
against K1 / K2; K1's and K2's float32 paths bitwise against each other;
K2 and K5c on a problem too wide for their f64 tables to be staged; the
path K1 and K2 take by the chains the card holds at once, and a wide
launch too large for the card raising. K chains of 128 walkers in one K1 / K2 launch (one
cluster a chain) at K = 1, 3 and one past the clusters the card holds at
once: each chain bitwise equal to it launched alone (f32, f64) and to the
plain version (f64), the -inf walkers per chain, one kernel event a block
for all K chains; and the general run_ensemble_chains in f64 against K1
launched over the same chains (chains and acceptances bitwise, lnps rtol
1e-12). The analysis toolkit on the card (chip_smoke's phase 6):
grid_chi2 in f64 equal to the CPU call (625 flagship points, rtol 1e-12),
run_adaptive_metropolis in f64 bitwise equal to the CPU run on the same
injected draws, and the dense Metropolis through the K4a block lnprob
launching K4a once a proposal batch. The sampler's block loop on the card:
FusedEnsembleSampler.run_mcmc one block ahead through K1 and K3, bitwise
against the same blocks run one at a time, one host synchronisation a
block; BlockTimer's device time. A float32 multifit through K2 records one
`pipeline/k2_plan` span counting the cluster plan its launches took, and
a float32 fit through K1 counts its plan in its sampler-choice
`pipeline/model` span. Every test here needs a CUDA device and nvcc, and skips without
them; on the card run

    python -m pytest tests/test_torch_cuda.py --noconftest

(--noconftest: tests/conftest.py imports jax, which the GPU machine
does not need or have.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from cha1_mcmc_tpu_torch.utils.cuda_build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("no nvcc: the kernels cannot be built here")


@pytest.fixture(scope="module")
def cuda_cases(tmp_path_factory):
    _require_card()
    import chip_smoke
    from tests.port_problems import write_hc5n_problem

    prob = write_hc5n_problem(str(tmp_path_factory.mktemp("hc5n")))
    return {c[0]: c for c in chip_smoke.cases(prob)}


@pytest.fixture(scope="module")
def gotham_cases(tmp_path_factory):
    _require_card()
    import chip_smoke
    from tests.port_problems import write_hc9n_problem

    prob = write_hc9n_problem(str(tmp_path_factory.mktemp("hc9n")))
    return {c[0]: c for c in chip_smoke.multi_cases(prob)}


@pytest.mark.parametrize("label", ["analytic-4d", "states-4d", "cheb-4d",
                                   "analytic-5d", "states-5d", "cheb-5d"])
def test_k1_kernel_matches_plain(cuda_cases, label):
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import fused

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    before = fused.LAUNCHES["fused_steps"]
    fracs = chip_smoke.check_case(*cuda_cases[label], gen, {})
    assert fused.LAUNCHES["fused_steps"] > before
    assert 0.1 < fracs["kernel"] < 0.9


@pytest.mark.parametrize("label", ["analytic-4c", "cheb-4c", "states-4c",
                                   "analytic-1c"])
def test_k2_kernel_matches_plain(gotham_cases, label):
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import fused_multi

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    before = fused_multi.LAUNCHES["multi_steps"]
    fracs = chip_smoke.check_multi_case(*gotham_cases[label], gen, {})
    assert fused_multi.LAUNCHES["multi_steps"] > before
    assert 0.1 < fracs["kernel"] < 0.9


def _k2_case(gotham_cases, ncomp):
    """A GOTHAM case with `ncomp` components: the K=4 and K=1 cases of
    chip_smoke, and for K=2 components 2 and 3 of the K=4 template."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec

    if ncomp in (1, 4):
        return gotham_cases[f"analytic-{ncomp}c"]
    label, m32, m64, _, means, stds, pert, grid = gotham_cases["analytic-4c"]
    idx = [1, 2, 5, 6, 8, 10, 11, 13]      # ss, Ncol, Tex, vlsr, dV
    return ("analytic-2c", m32, m64, ParamSpec(ncomp=2), means[idx], stds[idx], pert[idx],
            grid)


#: The cluster geometries the card tests run K1 / K5a and K2 / K5c at: the
#: size the H100 takes, the portable size taken where a card places no
#: cluster of 16, and 16 CTAs with the tables read from device memory (the
#: layout of problems too wide to stage).
GEOMETRIES = {"16": (16, True), "8": (8, True), "16-unstaged": (16, False)}
#: The step kernels' besides: their wide path (h CTAs a chain, one
#: cooperative launch).
K2_GEOMETRIES = {**GEOMETRIES, "wide": ("wide", None)}
#: K1's walker counts at each geometry: the wide path at h = 32, 48, 50
#: (ragged) and 128 CTAs, not at 2048 walkers (1,024 CTAs, more than an
#: H100 keeps resident).
K1_CHAIN_CASES = [(w, g) for g in K2_GEOMETRIES for w in (64, 96, 100, 256, 2048)
                  if not (g == "wide" and w == 2048)]


@pytest.mark.parametrize("label", ["analytic-4d", "states-5d"])
@pytest.mark.parametrize("nwalkers,geometry", K1_CHAIN_CASES)
def test_k1_cluster_chains_bitwise(cuda_cases, k5_cases, nwalkers, label, geometry):
    """K1's cluster launch against the plain version, f64, 64 steps, at
    walker counts whose h = W / 2 proposals split over 16 CTAs as 2, 3,
    3 or 4 (W = 100: ragged), 8 (W = 256: two rounds of four a CTA) and 64
    (W = 2048: sixteen rounds), over 8 CTAs as 4, 6, 6 or 7, 16 and 128;
    and on its wide path, h = 32, 48, 50 (ragged) and 128 CTAs of one
    proposal: chains and acceptances bitwise, lnps rtol 1e-12; the lnprob
    entry (at the plan's staging) gives the in-chain lnps of every walker
    that moved bitwise (one device lnprob); K5a at the same walker count
    (at its cluster geometry, or the card's choice beside the wide path)
    bitwise against its plain version and K1
    (chip_smoke.check_cluster_chains)."""
    import chip_smoke

    case = cuda_cases[label]
    _, (st, tb) = chip_smoke.flagship_tables(case)
    pos0 = chip_smoke.flagship_pos0(case[3].ndim, nwalkers=nwalkers, seed=nwalkers)
    plans = chip_smoke.cluster_plans("K1", tb, st, nwalkers, *K2_GEOMETRIES[geometry])
    assert (plans[0] is not None and plans[0].wide) == (geometry == "wide")
    chip_smoke.check_cluster_chains("K1", label, tb, st, pos0, 11, [(geometry, *plans)], {})


@pytest.mark.parametrize("label", ["analytic-4d", "states-5d", "cheb-4d"])
@pytest.mark.parametrize("nwalkers", [100, 128])
def test_k1_f32_paths_bitwise(cuda_cases, k5_cases, nwalkers, label):
    """K1's float32 paths, 64 steps: the wide path (one group of 16 warps,
    a lnprob lane a thread), the 16- and 8-CTA clusters and K5a (groups of
    four warps, four lanes a thread) give the same chains, lnps and
    acceptances bitwise, and the lnprob entry the in-chain lnps of the
    walkers that moved (chip_smoke.check_f32_paths)."""
    import chip_smoke

    errs = {}
    assert chip_smoke.check_f32_paths("K1", cuda_cases[label], errs, nwalkers=nwalkers) == [
        "wide", "16 CTAs", "8 CTAs", "K5a"]
    assert 0 < errs["K1 f32 paths"] <= 1     # the share of walkers that moved


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("w_local", [32, 40, 64])
def test_k5a_cluster_chains_bitwise(k5_cases, w_local, geometry):
    """K5a's cluster launch at W_l = 32, 40 (20 proposals over 16 CTAs:
    ragged) and 64 on the world-1 mesh, at each geometry: f64 64-step
    chains bitwise against its plain version and against K1 at the same
    walker count (lnps too: one device lnprob)."""
    import chip_smoke

    case = k5_cases["sharded_half"]
    tb, st = case["args64"]
    pos0 = case["pos0"][:w_local].contiguous()
    plans = chip_smoke.cluster_plans("K1", tb, st, w_local, *GEOMETRIES[geometry])
    chip_smoke.check_cluster_chains("K1", case["label"], tb, st, pos0, 13,
                                    [(geometry, *plans)], {})


@pytest.mark.parametrize("geometry", list(K2_GEOMETRIES))
@pytest.mark.parametrize("ncomp", [1, 2, 4])
@pytest.mark.parametrize("nwalkers", [64, 96, 100, 256])
def test_k2_cluster_chains_bitwise(gotham_cases, k5_cases, nwalkers, ncomp, geometry):
    """K2's cluster launch against the plain version, f64, 64 steps, at
    walker counts whose h = W / 2 proposals split over 16 CTAs as 2, 3,
    3 or 4 (W = 100: ragged) and 8 (W = 256: eight rounds of one a CTA),
    over 8 CTAs as 4, 6, 6 or 7 and 16; and on its wide path, h = 32, 48,
    50 (ragged) and 128 CTAs of one proposal: chains and acceptances
    bitwise, lnps rtol 1e-12; the lnprob entry gives the in-chain lnps of
    every walker that moved bitwise (one device lnprob); K5c at the same
    walker count (at its cluster geometry, or the card's choice beside the
    wide path) bitwise against its plain version and K2
    (chip_smoke.check_cluster_chains)."""
    import chip_smoke

    label, m32, m64, spec, means, stds, pert, grid = _k2_case(gotham_cases, ncomp)
    _, (st, tb) = chip_smoke.multi_tables(m32, m64, spec, means, stds, grid)
    rng = np.random.default_rng(nwalkers + ncomp)
    pos0 = torch.as_tensor(means + pert * rng.standard_normal((nwalkers, means.size)),
                           dtype=torch.float64, device="cuda")
    plans = chip_smoke.cluster_plans("K2", tb, st, nwalkers, *K2_GEOMETRIES[geometry])
    assert (plans[0] is not None and plans[0].wide) == (geometry == "wide")
    chip_smoke.check_cluster_chains("K2", label, tb, st, pos0, 11, [(geometry, *plans)], {})


@pytest.mark.parametrize("label", ["analytic-4c", "states-4c", "analytic-1c"])
@pytest.mark.parametrize("nwalkers", [100, 128])
def test_k2_f32_paths_bitwise(gotham_cases, k5_cases, nwalkers, label):
    """K2's float32 paths, 64 steps: the wide path (one group of 16 warps,
    a lnprob lane a thread), the 16- and 8-CTA clusters and K5c (groups of
    four warps, four lanes a thread) give the same chains, lnps and
    acceptances bitwise, and the lnprob entry the in-chain lnps of the
    walkers that moved (chip_smoke.check_f32_paths)."""
    import chip_smoke

    errs = {}
    assert chip_smoke.check_f32_paths("K2", gotham_cases[label], errs, nwalkers=nwalkers) == [
        "wide", "16 CTAs", "8 CTAs", "K5c"]
    assert 0 < errs["K2 f32 paths"] <= 1     # the share of walkers that moved


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("w_local", [32, 40, 64])
def test_k5c_cluster_chains_bitwise(k5_cases, w_local, geometry):
    """K5c's cluster launch at W_l = 32, 40 (20 proposals over 16 CTAs:
    ragged) and 64 on the world-1 mesh, at each geometry: f64 64-step
    chains bitwise against its plain version and against K2 at the same
    walker count (lnps too: one device lnprob)."""
    import chip_smoke

    case = k5_cases["sharded_multi_half"]
    tb, st = case["args64"]
    pos0 = case["pos0"][:w_local].contiguous()
    plans = chip_smoke.cluster_plans("K2", tb, st, w_local, *GEOMETRIES[geometry])
    chip_smoke.check_cluster_chains("K2", case["label"], tb, st, pos0, 13,
                                    [(geometry, *plans)], {})


@pytest.fixture(scope="module")
def wide_case(tmp_path_factory):
    _require_card()
    import chip_smoke
    from tests.port_problems import write_hc9n_problem

    prob = write_hc9n_problem(str(tmp_path_factory.mktemp("hc9n_wide")),
                              n_multiplets=chip_smoke.WIDE_MULTIPLETS)
    return chip_smoke.multi_cases(prob, labels=("analytic-4c",))[0]


def test_k2_k5c_read_the_tables_from_device_memory_past_the_staging_limit(
        cuda_cases, gotham_cases, k5_cases, wide_case):
    """On a GOTHAM-shaped problem of ~2,100 channels, whose f64 tables do
    not fit a cluster CTA's shared memory, K5c and the lnprob entry read
    them from device memory, K2's wide path (the card's choice, its CTA
    holding no state) stages them, and the chains stay bitwise, the wide
    path unstaged too (chip_smoke.check_geometries, as phase 3 runs it:
    the flagship's and the GOTHAM case's 8-CTA and unstaged geometries and
    K2's 16-CTA cluster included)."""
    import chip_smoke

    errs = {}
    chip_smoke.check_geometries(cuda_cases["analytic-4d"], gotham_cases["analytic-4c"],
                                wide_case, errs)
    assert set(errs) == {"K1 16 CTAs, staged", "K1 8 CTAs, staged", "K1 16 CTAs, unstaged",
                         "K1 wide, unstaged", "K2 16 CTAs, staged",
                         "K2 8 CTAs, staged", "K2 16 CTAs, unstaged", "K2 wide, unstaged",
                         "K2 the card's choice"}


@pytest.fixture(scope="module")
def dense_cases(tmp_path_factory):
    _require_card()
    import chip_smoke
    from tests.port_problems import write_dense_problem

    prob = write_dense_problem(str(tmp_path_factory.mktemp("dense")), scale="full")
    return {c[0]: c for c in chip_smoke.dense_cases(prob)}


@pytest.mark.parametrize("label", ["cheb-split-4d", "states-split-4d", "cheb-rect-4d",
                                   "analytic-split-5d"])
def test_k3_kernel_matches_plain(dense_cases, label):
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import fused_gather

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    before = fused_gather.LAUNCHES["gather_steps"]
    fracs, geom = chip_smoke.check_dense_case(dense_cases[label], gen, {})
    assert fused_gather.LAUNCHES["gather_steps"] > before
    assert geom.n_blk > 1 and 0.1 < fracs["kernel"] < 0.9


@pytest.mark.parametrize("cblock", [128, 256, 512])
@pytest.mark.parametrize("label", ["cheb-split-4d", "states-split-4d", "cheb-rect-4d",
                                   "analytic-split-5d"])
def test_k3_chains_bitwise_at_every_block_and_grid(dense_cases, k5_cases, label, cblock):
    """K3's one cooperative launch at channel blocks of 128, 256 and 512,
    each at the grid the card takes, at a grid of a few CTAs and with the
    taus in device memory (the path past the shared-memory limit): f64
    64-step chains and acceptances bitwise against gather_steps_plain,
    lnps rtol 1e-12, the lnprob entry equal to the in-chain lnps, and K5b
    at world size 1 bitwise against K3 (chip_smoke.check_dense_geometries)."""
    import chip_smoke

    errs = {}
    chip_smoke.check_dense_geometries(dense_cases[label], errs, cblocks=(cblock,))
    assert set(errs) == {f"cblock {cblock}"}


def test_k3_k5b_one_launch_per_call(dense_cases, k5_cases):
    """Each C call of K3's steps, its lnprob entry and K5b launches exactly
    one kernel on the card (torch.profiler's device events named after the
    kernel), whatever the steps in the call."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf
    from cha1_mcmc_tpu_torch.sampler import fused_gather as fg
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    case = dense_cases["cheb-split-4d"]
    _, (st, tb), _, plans = chip_smoke.dense_tables(case)
    geom = plans[torch.float32]
    pos = chip_smoke.dense_pos0(case).to(torch.float32)
    lnp = fg.gather_lnprob(pos, tb, st, geom)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    pb, zb, prb, ab = block_randomness(draw_randomness(16, 128, gen, device="cuda"),
                                       chip_smoke.K_STEPS)
    h = 64
    ops = (pb[0][:h].contiguous(), pos[pb[0][h:].long()].contiguous(), zb[0][0].contiguous(),
           prb[0][0].contiguous(), ab[0][0].contiguous())
    state = torch.cat([pos, lnp[:, None]], dim=1).contiguous()
    calls = {"gather_steps": functools.partial(fg.gather_step_block, pos, lnp, pb[0], zb[0],
                                               prb[0], ab[0], tb, st, geom),
             "gather_lnprob": functools.partial(fg.gather_lnprob, pos, tb, st, geom),
             "sharded_gather_half": functools.partial(sf.sharded_gather_half, state, *ops,
                                                      tb, st, geom)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "gather_kernel" in e.name]
        assert len(kernels) == 1, (name, kernels)


@pytest.mark.parametrize("label", ["W=64", "W=100", "W=128", "W=256", "dV at the bound",
                                   "narrow windows", "outside the prior box",
                                   "C - 1 channels"])
def test_k4_kernels_match_plain(dense_cases, label):
    """K4a (exp; exp2 masked and unmasked) and K4b (masked and unmasked)
    against their plain versions on the dense problem, f64 rtol 1e-12 and
    f32 rtol 1e-5, on one of chip_smoke.k4_cases (the last over the grid
    less a channel, whose rows K4a's plan pads); two calls bitwise
    (chip_smoke.check_opacity)."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.models import opacity_kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    before = dict(opacity_kernels.LAUNCHES)
    errs = {}
    empty = chip_smoke.check_opacity(dense_cases["cheb-split-4d"], gen, errs, labels=(label,))
    assert all(opacity_kernels.LAUNCHES[k] > before[k] for k in before)
    assert set(errs) == {"block", "csr"}
    assert (empty > 0) == (label == "narrow windows")


def test_k4_one_launch_per_call(dense_cases):
    """Each K4 call, in every form, launches exactly one kernel on the card
    (torch.profiler's device events named after it: chip_smoke.
    kernel_events raises unless a window of one call shows exactly one)."""
    import chip_smoke

    case = dense_cases["cheb-split-4d"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    taus, vlsr, dV, m = chip_smoke.opacity_inputs(case, gen, torch.float32)
    for name, (kern, _, _) in chip_smoke.opacity_calls(m, torch.float32).items():
        kern(taus, vlsr, dV)
        torch.cuda.synchronize()
        assert len(chip_smoke.kernel_events(lambda: kern(taus, vlsr, dV),
                                            "opacity_kernel", 1)) == 1, name


@pytest.fixture(scope="module")
def k5_cases(cuda_cases, gotham_cases, dense_cases):
    """chip_smoke's K5 cases over a world-1 mesh (an NCCL group of one
    rank, destroyed after the module)."""
    import torch.distributed as dist

    import chip_smoke
    from cha1_mcmc_tpu_torch.parallel import make_mesh

    chip_smoke.MESH = make_mesh(1, 1)
    yield {c["name"]: c for c in chip_smoke.k5_cases(
        cuda_cases["analytic-4d"], gotham_cases["analytic-4c"], dense_cases["cheb-split-4d"])}
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["sharded_half", "sharded_multi_half",
                                  "sharded_gather_half"])
def test_k5_kernel_matches_plain_and_whole_step(k5_cases, name):
    """K5a / K5c / K5b at world size 1: f64 chains bitwise against the
    plain version and against K1 / K2 / K3; f32 lnprob and acceptance."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.parallel import sharded_fused

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    before = sharded_fused.LAUNCHES[name]
    fracs = chip_smoke.check_sharded(k5_cases[name], gen, {})
    assert sharded_fused.LAUNCHES[name] > before
    assert 0.1 < fracs["kernel"] < 0.9


def test_t3_probes_match_plain():
    _require_card()
    import chip_smoke
    from cha1_mcmc_tpu_torch.utils import construct_probe

    before = construct_probe.LAUNCHES["construct_probe"]
    errs = {}
    chip_smoke.check_probe(errs)
    assert construct_probe.LAUNCHES["construct_probe"] == before + 1
    assert construct_probe.run_probes("cuda", verbose=False) == dict.fromkeys("ABCDEFG",
                                                                               True)


def test_t3_packed_output_and_empty_launch():
    """T3 into a given packed output equals a fresh call, bitwise, and
    counts one launch; the empty kernel through the same path writes
    nothing and counts none."""
    _require_card()
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    xs = t3.probe_inputs("cuda", seed=9)
    fresh = t3.probes(*xs)
    out = t3.empty_outputs("cuda").fill_(float("nan"))
    before = t3.LAUNCHES["construct_probe"]
    packed = t3.probes(*xs, out=out)
    assert t3.LAUNCHES["construct_probe"] == before + 1
    for k in t3.PROBES:
        assert torch.equal(packed[k], fresh[k]), k
    out.fill_(float("nan"))
    t3.empty_launch(*xs, out=out)
    torch.cuda.synchronize()
    assert t3.LAUNCHES["construct_probe"] == before + 1
    assert bool(torch.isnan(out).all())


# -- K chains in one K1 / K2 launch (MultiChainSampler) ------------------------

@pytest.mark.parametrize("kind,label", [("K1", "analytic-4d"), ("K1", "states-5d"),
                                        ("K2", "analytic-4c"), ("K2", "analytic-1c")])
def test_chains_in_one_launch_equal_each_chain_alone(cuda_cases, gotham_cases, kind, label):
    """K chains of 128 walkers in one K1 / K2 launch (one cluster a chain)
    at K = 1, 3 and one past the clusters the card holds at once: each
    chain bitwise equal to it launched alone in f32 and f64 and to the
    plain version in f64, the -inf walkers per chain (F4), one launch a
    block (chip_smoke.check_chains)."""
    import chip_smoke

    case = (cuda_cases if kind == "K1" else gotham_cases)[label]
    ks = chip_smoke.check_chains(kind, case, {})
    assert len(ks) == 3 and ks[-1] > 3


@pytest.mark.parametrize("chains", ["2", "4", "past capacity"])
def test_k2_chains_take_the_path_their_ctas_fit(gotham_cases, chains):
    """K chains of 128 walkers in one K2 launch take the wide path exactly
    where their K x 64 CTAs fit the card's co-resident CTAs of the wide
    kernel (2 chains on an H100's 132 SMs; 4 chains where the card holds
    fewer than 256), else the cluster path (the least K past the capacity
    always): each chain bitwise equal to it launched alone (the wide path
    at K = 1) in f32 and f64 and to the plain version in f64, the -inf
    walker per chain, one launch a block (chip_smoke.check_chains)."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi as fm

    case = gotham_cases["analytic-4c"]
    (st, tb), _ = chip_smoke.multi_tables(*case[1:6], case[7])
    wide = chip_smoke.cluster_family("K2")["plan"](tb, st, chip_smoke.W, "wide", None, True)
    capacity = cluster.wide_capacity(fm.FAMILY, wide.layout, torch.float32, tb[0].device)
    assert capacity >= 2 * wide.cluster, capacity
    K = capacity // wide.cluster + 1 if chains == "past capacity" else int(chains)
    path = chip_smoke.steps_path("K2", tb, st, chip_smoke.W, K)
    assert path == ("wide" if K * wide.cluster <= capacity else "cluster")
    assert chip_smoke.steps_path("K2", tb, st, chip_smoke.W, 1) == "wide"
    assert chip_smoke.check_chains("K2", case, {}, ks=(1, K)) == (1, K)


@pytest.mark.parametrize("chains", ["2", "4", "past capacity"])
def test_k1_chains_take_the_path_their_ctas_fit(cuda_cases, chains):
    """K chains of 128 walkers in one K1 launch take the wide path exactly
    where their K x 64 CTAs fit the card's co-resident CTAs of K1's wide
    kernel, else the cluster path (the least K past the capacity always),
    in float32 and float64 alike: each chain bitwise equal to it launched
    alone (the wide path at K = 1) in f32 and f64 and to the plain version
    in f64, the -inf walker per chain, one launch a block
    (chip_smoke.check_chains)."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import cluster, fused

    case = cuda_cases["analytic-4d"]
    capacities = []
    for st, tb in chip_smoke.flagship_tables(case):
        wide = chip_smoke.cluster_family("K1")["plan"](tb, st, chip_smoke.W, "wide", None, True)
        capacity = cluster.wide_capacity(fused.FAMILY, wide.layout, tb[0].dtype, tb[0].device)
        assert capacity >= 2 * wide.cluster, capacity
        capacities.append(capacity)
        assert chip_smoke.steps_path("K1", tb, st, chip_smoke.W, 1) == "wide"
    K = max(capacities) // wide.cluster + 1 if chains == "past capacity" else int(chains)
    for (st, tb), capacity in zip(chip_smoke.flagship_tables(case), capacities):
        path = chip_smoke.steps_path("K1", tb, st, chip_smoke.W, K)
        assert path == ("wide" if K * wide.cluster <= capacity else "cluster")
    assert chip_smoke.check_chains("K1", case, {}, ks=(1, K)) == (1, K)


def test_k2_wide_launch_past_the_card_raises(gotham_cases):
    """A wide plan handed in for more chains than the card holds at once is
    refused by the card (a cooperative launch too large): the wrapper
    raises DeviceError, counts no launch and runs nothing else."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi as fm
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_chain_randomness
    from cha1_mcmc_tpu_torch.utils import DeviceError

    case = gotham_cases["analytic-4c"]
    (st, tb), _ = chip_smoke.multi_tables(*case[1:6], case[7])
    wide = chip_smoke.cluster_family("K2")["plan"](tb, st, chip_smoke.W, "wide", None, True)
    K = cluster.wide_capacity(fm.FAMILY, wide.layout, torch.float32, tb[0].device) \
        // wide.cluster + 1
    pos0 = chip_smoke.chain_starts("K2", case, K, stuck=False).to(torch.float32)
    lnp0 = torch.stack([fm.multi_lnprob(p, tb, st) for p in pos0])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rnd = draw_chain_randomness(K, chip_smoke.K_STEPS, chip_smoke.W, gen, device="cuda")
    rb = tuple(t[0] for t in block_randomness(rnd, chip_smoke.K_STEPS))
    before = fm.LAUNCHES["multi_steps"]
    with pytest.raises(DeviceError, match="multi_steps"):
        fm.multi_step_block(pos0, lnp0, *rb, tb, st, plan=wide)
    assert fm.LAUNCHES["multi_steps"] == before
    out = fm.multi_step_block(pos0, lnp0, *rb, tb, st)      # the card's choice runs
    assert fm.LAUNCHES["multi_steps"] == before + 1 and out[0].shape[0] == K


@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_chains_one_launch_per_block(cuda_cases, gotham_cases, kind):
    """A FusedEnsemble call over 4 chains of 128 walkers and one 16-step
    block shows one K1 / K2 kernel in the device trace
    (chip_smoke.kernel_events: one named event a call), not four."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import FusedEnsemble, MultiFusedEnsemble
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_chain_randomness

    if kind == "K1":
        case = cuda_cases["analytic-4d"]
        (st, tb), _ = chip_smoke.flagship_tables(case)
        run, name = FusedEnsemble(tb, st), "k1_cluster_steps_kernel"
    else:
        case = gotham_cases["analytic-4c"]
        (st, tb), _ = chip_smoke.multi_tables(*case[1:6], case[7])
        run, name = MultiFusedEnsemble(tb, st), "multi_cluster_steps_kernel"
    pos0 = chip_smoke.chain_starts(kind, case, 4, stuck=False).to(torch.float32)
    lnp0 = torch.stack([run.lnprob(p) for p in pos0])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rnd = draw_chain_randomness(4, chip_smoke.K_STEPS, chip_smoke.W, gen, device="cuda")
    events = chip_smoke.kernel_events(
        lambda: run(pos0, lnp0, chip_smoke.K_STEPS, chip_smoke.K_STEPS, randomness=rnd),
        name, 3)
    assert len(events) == 3


def test_general_chains_equal_k1_chains_on_the_card(cuda_cases):
    """run_ensemble_chains over the flagship's f64 general lnprob on the
    card against the hand-written K1 launched over the same 3 chains
    (FusedEnsemble, one launch a block) on the same randomness: chains
    and acceptances bitwise, lnps rtol 1e-12 (the two sum the channels in
    another order), as K1 against its plain version."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.inference import build_lnprob, single_component_lnprior
    from cha1_mcmc_tpu_torch.sampler import FusedEnsemble, run_ensemble_chains
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_chain_randomness

    case = cuda_cases["analytic-4d"]
    _, _, m64, spec, cfg, grid = case
    lnprob = build_lnprob(m64, spec, grid.ints, grid.yerrs, single_component_lnprior(
        spec, cfg.bounds, cfg.template_means, cfg.template_stds, dtype=torch.float64))
    pos0 = chip_smoke.chain_starts("K1", case, 3)
    lnp0 = torch.stack([lnprob(p) for p in pos0])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rnd = draw_chain_randomness(3, 32, chip_smoke.W, gen, device="cuda", dtype=torch.float64)
    general = run_ensemble_chains(lnprob, pos0, lnp0, rnd, 32)
    st, tb = chip_smoke.flagship_tables(case)[1]
    k1 = FusedEnsemble(tb, st)(pos0, lnp0, 32, chip_smoke.K_STEPS, randomness=rnd)
    assert torch.equal(general[0], k1[0]) and torch.equal(general[3][0], k1[3][0])
    assert torch.equal(general[2], k1[2].to(general[2].dtype))
    fin = torch.isfinite(general[1])
    assert torch.equal(torch.isfinite(k1[1]), fin)
    np.testing.assert_allclose(k1[1][fin].cpu().numpy(), general[1][fin].cpu().numpy(),
                               rtol=1e-12)
    assert 0 < int(general[2].sum()) < 3 * 32 * chip_smoke.W


# -- the analysis toolkit on the card (phase 6 of chip_smoke) -------------------

def _flagship_grid_625():
    from tests.port_problems import TRUTH

    t = np.asarray(TRUTH)
    return {"Ncol": t[0] * np.linspace(0.6, 1.4, 5), "Tex": np.linspace(5.0, 11.0, 5),
            "vlsr": t[2] + np.linspace(-0.08, 0.08, 5), "dV": t[3] + np.linspace(-0.2, 0.2, 5)}


def test_grid_chi2_on_the_card_equals_cpu(cuda_cases):
    """grid_chi2 on the card equals the same call on the CPU in f64: 625
    flagship grid points (ragged batches of 100) to 1e-12 relative, the
    same thetas and argmin."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.analysis import grid_chi2

    _, _, m64, spec, _, grid = cuda_cases["analytic-4d"]
    grids = _flagship_grid_625()
    t_card, c_card, b_card = grid_chi2(m64, spec, grid.ints, grid.yerrs, grids, batch=100)
    t_cpu, c_cpu, b_cpu = grid_chi2(chip_smoke.cpu_copy(m64), spec, grid.ints, grid.yerrs,
                                    grids, batch=100)
    np.testing.assert_array_equal(t_card, t_cpu)
    np.testing.assert_allclose(c_card, c_cpu, rtol=1e-12)
    assert np.argmin(c_card) == np.argmin(c_cpu)
    np.testing.assert_array_equal(b_card, b_cpu)


def test_metropolis_on_the_card_equals_cpu_bitwise(cuda_cases):
    """run_adaptive_metropolis over the flagship's f64 lnprob on the card
    equals the CPU run on the same injected per-round draws: chains
    bitwise, the same acceptance, lnps rtol 1e-12 (the two devices sum the
    channels in another order)."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis
    from cha1_mcmc_tpu_torch.analysis.independent import draw_round
    from cha1_mcmc_tpu_torch.inference import build_lnprob, single_component_lnprior

    _, _, m64, spec, cfg, grid = cuda_cases["analytic-4d"]
    rounds, round_len, nsteps, W = 3, 64, 256, 32
    stds = np.asarray(cfg.template_stds)
    gen = torch.Generator().manual_seed(9)
    rnd = [draw_round(n, W, 4, gen, dtype=torch.float64)
           for n in [round_len] * rounds + [nsteps]]
    runs = []
    for model, device in ((m64, "cuda"), (chip_smoke.cpu_copy(m64), "cpu")):
        lnprob = build_lnprob(model, spec, grid.ints, grid.yerrs, single_component_lnprior(
            spec, cfg.bounds, cfg.template_means, cfg.template_stds, dtype=torch.float64))
        pos0 = chip_smoke.flagship_pos0(4, W, seed=3).to(device)
        chain, lnps, acc = run_adaptive_metropolis(
            lnprob, pos0, nsteps=nsteps, init_sigma=stds / 10, warmup_rounds=rounds,
            round_len=round_len, batched=True,
            randomness=[(z.to(device), u.to(device)) for z, u in rnd])
        runs.append((chain.cpu().numpy(), lnps.cpu().numpy(), acc))
    (c_card, l_card, a_card), (c_cpu, l_cpu, a_cpu) = runs
    np.testing.assert_array_equal(c_card, c_cpu)
    assert a_card == a_cpu and 0.0 < a_card < 1.0
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-12)


def test_dense_block_metropolis_launches_k4a_once_a_batch(dense_cases):
    """run_adaptive_metropolis over the full dense problem through the
    K4a block lnprob (build_lnprob_batched(..., pallas_kernel="block"))
    launches K4a once a proposal batch, and nothing else."""
    import chip_smoke
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis
    from cha1_mcmc_tpu_torch.inference import build_lnprob_batched, single_component_lnprior
    from cha1_mcmc_tpu_torch.utils.metrics import kernel_launches

    case = dense_cases["cheb-split-4d"]
    _, d32, _, spec, bounds, means, stds, grid, _ = case
    lnprob = build_lnprob_batched(
        d32, spec, grid.ints, grid.yerrs, single_component_lnprior(spec, bounds, means, stds),
        use_pallas=True, pallas_kernel="block", dv_max=chip_smoke.DENSE_DV_MAX,
        dv_min=bounds["dV"][0], vlsr_bounds=bounds["vlsr"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    before = kernel_launches()
    chain, _, acc = run_adaptive_metropolis(
        lnprob, chip_smoke.dense_pos0(case, seed=2).to(torch.float32), gen, nsteps=64,
        init_sigma=np.asarray(stds) / 10, warmup_rounds=2, round_len=32, batched=True)
    after = kernel_launches()
    counts = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert counts == {"opacity_block": 2 * 32 + 64 + 1}, counts
    assert torch.isfinite(chain).all() and 0.0 < acc < 1.0


@pytest.mark.parametrize("kind", ["K1", "K3"])
def test_run_mcmc_one_block_ahead_equals_blocks_run_one_at_a_time(cuda_cases, dense_cases,
                                                                 kind, tmp_path):
    """FusedEnsembleSampler.run_mcmc queues block b + 1 before it waits on
    block b's copies, which go to pinned host buffers: over 4 blocks (three
    of 32 steps, one of 16) through K1 and through K3, its chain, its
    lnprobability, its acceptance and the checkpoint equal bitwise the same
    blocks run one at a time through run_fn from the same generator; the
    chain is C-contiguous; each block counts one host synchronisation,
    `ahead` 1 but the last, and its device time."""
    from cha1_mcmc_tpu_torch.sampler import FusedEnsemble, FusedEnsembleSampler
    from cha1_mcmc_tpu_torch.sampler.fused_gather import GatherFusedEnsemble
    from cha1_mcmc_tpu_torch.utils import metrics

    import chip_smoke

    if kind == "K1":
        case = cuda_cases["analytic-4d"]
        (st, tb), _ = chip_smoke.flagship_tables(case)
        run = FusedEnsemble(tb, st)
        pos0 = chip_smoke.flagship_pos0(case[3].ndim, dtype=torch.float32)
    else:
        case = dense_cases["cheb-split-4d"]
        _, (st, tb), _, plans = chip_smoke.dense_tables(case)
        run = GatherFusedEnsemble(tb, st, plans[torch.float32])
        pos0 = chip_smoke.dense_pos0(case).to(torch.float32)
    W, D = pos0.shape
    sizes = [32, 32, 32, 16]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2 ** 33 + 17)
    pos, lnp, chains, lnpss, accepted = pos0, run.lnprob(pos0), [], [], 0
    for n in sizes:
        chain, lnps, acc, (pos, lnp) = run(pos, lnp, n, 16, generator=gen)
        chains.append(chain.transpose(0, 1).cpu().numpy())
        lnpss.append(lnps.transpose(0, 1).cpu().numpy())
        accepted += int(acc.sum())
    rng_after = gen.get_state().numpy()

    sampler = FusedEnsembleSampler(lnprob_fn=None, nwalkers=W, ndim=D, dtype=torch.float32,
                                   device="cuda", run_fn=run, k_steps=16)
    gen.manual_seed(2 ** 33 + 17)
    chain_file = str(tmp_path / "chain.npy")
    with metrics.span("test/run_mcmc") as caller:
        final = sampler.run_mcmc(pos0, sum(sizes), gen, checkpoint_every=32,
                                 chain_file=chain_file)
    assert sampler.chain.flags.c_contiguous and sampler.chain.shape == (W, sum(sizes), D)
    np.testing.assert_array_equal(sampler.chain, np.concatenate(chains, axis=1))
    np.testing.assert_array_equal(sampler.lnprobability, np.concatenate(lnpss, axis=1))
    assert sampler.accepted == accepted > 0
    np.testing.assert_array_equal(np.load(chain_file), sampler.chain)
    side = np.load(str(tmp_path / "chain.state.npz"))
    np.testing.assert_array_equal(side["pos"], pos.cpu().numpy())
    np.testing.assert_array_equal(side["lnp"], lnp.cpu().numpy())
    np.testing.assert_array_equal(side["rng_state"], rng_after)
    np.testing.assert_array_equal(final[0], pos.cpu().numpy())

    blocks = [r for r in metrics.spans() if r.name == "sampler/block" and r.parent == caller.id]
    assert [b.counts["syncs"] for b in blocks] == [1, 1, 1, 1]
    assert [b.counts["ahead"] for b in blocks] == [1, 1, 1, 0]
    for b, n in zip(blocks, sizes):          # chain, lnps, the float32 sum, pos, lnp
        assert b.counts["d2h_bytes"] == 4 * (n * W * D + n * W + 1 + W * D + W)
        assert b.counts["device_s"] > 0.0
    assert all(b.counts["gap_s"] >= 0.0 for b in blocks[1:])


def test_block_timer_spans_a_block_from_its_first_launch():
    """utils/metrics.py:BlockTimer on the card: a block's device_s runs from
    first_launch() (not from the host's work before it, when the card
    idles) to its last kernel; gap_s from the previous block's last kernel
    to that launch; a block whose runner marks no launch starts at its
    first enqueue."""
    import time

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA events run only on the card")
    from cha1_mcmc_tpu_torch.utils.metrics import BlockTimer, first_launch

    cycles = 20_000_000            # ~10 ms at the H100's 1.98 GHz
    ref = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(1000)
    ref[0].record()
    torch.cuda._sleep(cycles)
    ref[1].record()
    torch.cuda.synchronize()
    kernel_s = ref[0].elapsed_time(ref[1]) * 1e-3
    def blocks(marked: bool) -> list[dict]:
        timer, reads = BlockTimer("cuda"), []
        for _ in range(3):
            time.sleep(0.01)       # the host between blocks
            with timer:
                time.sleep(0.02)   # the host's preparation, the card idle
                if marked:
                    first_launch()
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            reads.append(timer.read())
        assert "gap_s" not in reads[0] and all("gap_s" in r for r in reads[1:])
        return reads

    for r in blocks(marked=True):
        assert abs(r["device_s"] - kernel_s) < 0.2 * kernel_s + 1e-3, (r, kernel_s)
        assert r.get("gap_s", 0.03) > 0.025, r    # 10 ms between + 20 ms before the launch
    for r in blocks(marked=False):
        assert r["device_s"] > kernel_s + 0.015, (r, kernel_s)
        assert 0.005 < r.get("gap_s", 0.01) < 0.02, r
    first_launch()                 # outside a timed block: nothing to move


def test_multifit_k2_plan_span_counts_the_plan_k2_launches(tmp_path):
    """A float32 MultiComponentFit through K2 on the card (the real
    factory, the configuration's 66 lines x 1,138 channels) records one
    `pipeline/k2_plan` inside a `pipeline/model`: its counts are the wide
    plan's at 128 walkers (64 CTAs, `wide` 1), the plan every launch took
    (cluster.steps_plan's, cached: the span and the launches read one
    object)."""
    _require_card()
    import contextlib
    import io

    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig
    from cha1_mcmc_tpu_torch.sampler import FusedEnsembleSampler, cluster
    from cha1_mcmc_tpu_torch.sampler.fused_multi import FAMILY, LAUNCHES
    from cha1_mcmc_tpu_torch.utils import metrics
    from tests.port_problems import write_hc9n_problem

    p = write_hc9n_problem(str(tmp_path))
    cfg = MultiFitConfig(mol_name="hc9n_hfs", template_run=True,
                         cat_folder=p["cat_folder"], data_path=p["data_path"],
                         fit_folder=str(tmp_path / "fit"), nwalkers=128, nruns=64,
                         checkpoint_every=64, device="cuda")
    fit = MultiComponentFit(cfg)
    before = LAUNCHES["multi_steps"]
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    assert isinstance(fit.sampler, FusedEnsembleSampler)
    assert LAUNCHES["multi_steps"] == before + 4
    tables = fit.sampler.run_fn.tables
    lines, vel = tables[:2]
    shape = (lines.shape[1], vel.shape[1], vel.shape[0])
    assert shape[:2] == (66, 1138)
    plan = cluster.plan_wide(FAMILY, 128, 4, 14, *shape, torch.float32)
    launched = cluster.checked_plan(FAMILY, "steps", None, 128, 1, 4, 14, *shape,
                                    torch.float32, vel.device)
    assert launched == plan and launched.wide
    assert launched is cluster.steps_plan(FAMILY, 128, 1, 4, 14, *shape, torch.float32,
                                          vel.device)
    want = dict(components=4, ctas=64, wide=1, staged=int(plan.staged),
                smem_bytes=plan.smem_bytes,
                table_bytes=sum(t.numel() * t.element_size() for t in tables))
    ours = [r for r in metrics.spans() if r.trace == fit.throughput.trace_id]
    (k2,) = [r for r in ours if r.name == "pipeline/k2_plan"]
    parent = next(r for r in ours if r.id == k2.parent)
    assert parent.name == "pipeline/model" and parent.t0 <= k2.t0 <= k2.t1 <= parent.t1
    assert k2.counts == want


def test_fit_k1_counts_the_plan_k1_launches_in_its_sampler_choice_span(tmp_path):
    """A float32 SpectralFit through K1 on the card (the flagship's 9
    lines x 561 channels, 128 walkers, one chain): the `pipeline/model`
    span in which it chooses its sampler counts the wide plan (`wide` 1,
    64 `ctas`, `staged` 1), the plan every step launch took
    (cluster.steps_plan's, cached: the span and the launches read one
    object)."""
    _require_card()
    import contextlib
    import io

    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit
    from cha1_mcmc_tpu_torch.sampler import FusedEnsembleSampler, cluster
    from cha1_mcmc_tpu_torch.sampler.fused import FAMILY, LAUNCHES
    from cha1_mcmc_tpu_torch.utils import metrics
    from tests.port_problems import write_hc5n_problem

    p = write_hc5n_problem(str(tmp_path))
    cfg = FitConfig(mol_name="hc5n_hfs", cat_folder=p["cat_folder"], data_path=p["data_path"],
                    fit_folder=str(tmp_path / "fit"), nwalkers=128, nruns=64,
                    checkpoint_every=64, device="cuda")
    fit = SpectralFit(cfg)
    before = LAUNCHES["fused_steps"]
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    assert isinstance(fit.sampler, FusedEnsembleSampler)
    assert LAUNCHES["fused_steps"] == before + 4
    tables = fit.sampler.run_fn.tables
    _, (La, M, C, _) = FAMILY.tables(tables, torch.float32, tables[0].device, "K1")
    assert (La, C) == (9, 561)
    st = fit.sampler.run_fn.statics
    launched = cluster.checked_plan(FAMILY, "steps", None, 128, 1, 1, st.ndim, La, C, M,
                                    torch.float32, tables[0].device)
    assert launched.wide and launched == cluster.plan_wide(FAMILY, 128, 1, st.ndim, La, C, M,
                                                           torch.float32)
    ours = [r for r in metrics.spans() if r.trace == fit.throughput.trace_id]
    (choice,) = [r for r in ours if "ctas" in r.counts]
    assert choice.name == "pipeline/model"
    assert choice.counts == dict(wide=1, ctas=64, staged=1)
