"""The cluster binding's planning (sampler/cluster.py) for both of its
families, on the CPU: K1 / K5a (sampler/fused.py) and K2 / K5c
(sampler/fused_multi.py). Each test is one property checked for each
family at its own sizes: the flagship's for K1 (9 lines x 561 channels x 3
entries), GOTHAM's for K2 (4 components, 66 lines x 1,138 channels x 3
entries)."""

import pytest
import torch

from cha1_mcmc_tpu_torch.sampler import cluster, fused, fused_multi
from cha1_mcmc_tpu_torch.sampler.cluster import I_REGIONS, REGIONS, T_REGIONS

#: kind -> (family, components, dims, active lines, channels, entries a channel)
FAMILIES = {"K1": (fused.FAMILY, 1, 5, 9, 561, 3),
            "K2": (fused_multi.FAMILY, 4, 14, 66, 1138, 3)}


@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,nwalkers", [("K1", 100), ("K2", 96)])
def test_layout_regions_tile_the_bytes(kind, nwalkers, dtype, resident, stage):
    """The layout the kernels apply (csrc/cluster_step.cuh:carve) of a
    step launch (`resident`) or a half-step launch at 16 and 8 CTAs and of
    the lnprob entry: regions in order, each the size of what it holds,
    the values aligned to their dtype and the int32 regions after them,
    ending at `bytes`, within a CTA; K1's hfs group table empty; without
    staging no region grows with the channels."""
    fam, K, D, La, C, M = FAMILIES[kind]
    item = torch.empty((), dtype=dtype).element_size()
    t = int(stage)
    W = nwalkers

    def sizes(rows, ndim, per_cta):
        return dict(state=rows * (ndim + 1), chans=t * 3 * C, cc=t * 4 * C, vel=t * M * C,
                    lines=t * 5 * La, tau=4 * K * La, part=4 * fam.partials,
                    prop=per_cta * (ndim + 1), zz=per_cta, line_idx=t * M * C,
                    group=t * M * C * int(fam.group_table), flag=per_cta, acc=2)

    layouts = []
    for n in (16, 8):
        plan = cluster.plan_cluster(fam, W, K, D, La, C, M, dtype, cluster=n,
                                    resident_state=resident, stage=stage)
        assert plan.per_cta == -(-(W // 2) // n)
        layouts.append((plan.layout, sizes(W * resident, D, plan.per_cta)))
        wider = cluster.plan_cluster(fam, W, K, D, La, 10 * C, M, dtype, cluster=n,
                                     resident_state=resident, stage=stage)
        assert (wider.smem_bytes == plan.smem_bytes) == (not stage)
    layouts.append((cluster.smem_layout(fam, dtype, K, La, C, M, stage=stage),
                    sizes(0, -1, 0)))
    for layout, want in layouts:
        at = 0
        for name, off in zip(REGIONS, layout.offsets):
            size = item if name in T_REGIONS else 4
            assert off == at and off % size == 0, name
            at += size * want[name]
        assert layout.bytes == at and layout.staged == stage and layout.fits
    assert set(REGIONS) == set(T_REGIONS + I_REGIONS)


@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_explicit_plan_is_checked_against_the_launch(kind):
    """A plan handed to a family's step or half-step wrapper must have been
    made for that family, the launch's sizes and entry, and fit a CTA;
    else the wrapper raises before it launches anything."""
    fam, K, D, La, C, M = FAMILIES[kind]
    other = FAMILIES["K2" if kind == "K1" else "K1"][0]
    cpu = torch.device("cpu")
    args = (64, 1, K, D, La, C, M, torch.float32, cpu)
    steps = cluster.plan_cluster(fam, 64, K, D, La, C, M, torch.float32, cluster=8)
    half = cluster.plan_cluster(fam, 64, K, D, La, C, M, torch.float32, cluster=8,
                                resident_state=False)
    assert cluster.checked_plan(fam, "steps", steps, *args) is steps
    assert cluster.checked_plan(fam, "half", half, *args) is half
    with pytest.raises(ValueError, match=f"{fam.half} half: a plan .* cannot launch"):
        cluster.checked_plan(fam, "half", steps, *args)
    with pytest.raises(ValueError, match=f"{fam.steps} steps: a plan .* cannot launch"):
        cluster.checked_plan(fam, "steps", steps, 96, *args[1:])
    with pytest.raises(ValueError, match="cannot launch"):
        cluster.checked_plan(fam, "steps", steps, 64, 1, K, D + 1, *args[4:])
    with pytest.raises(ValueError, match="cannot launch"):
        cluster.checked_plan(fam, "steps", steps, *args[:7], torch.float64, cpu)
    with pytest.raises(ValueError, match="cannot launch"):
        cluster.checked_plan(other, "steps", steps, *args)
    too_big = cluster.plan_cluster(fam, 64, K, D, La, 200_000, M, torch.float32, cluster=8,
                                   stage=True)
    with pytest.raises(ValueError, match="cannot launch"):
        cluster.checked_plan(fam, "steps", too_big, 64, 1, K, D, La, 200_000, M,
                             torch.float32, cpu)


@pytest.mark.parametrize("kind,nwalkers,n", [
    ("K1", 128, 16), ("K1", 128, 8), ("K1", 100, 16), ("K1", 2048, 16), ("K1", 40, 8),
    ("K1", 8, 16),
    ("K2", 128, 16), ("K2", 128, 8), ("K2", 96, 16), ("K2", 96, 8), ("K2", 64, 16),
    ("K2", 32, 16), ("K2", 32, 8), ("K2", 8, 16), ("K2", 250, 16), ("K2", 250, 8)])
def test_cluster_plan_owns_each_proposal_once(kind, nwalkers, n):
    """The ragged split of a half-update's h = W / 2 proposals over the
    cluster's CTAs (csrc/cluster_step.cuh:owned_slice): every proposal has
    exactly one owner, contiguous, at most per_cta = ceil(h / n) each,
    sizes differing by at most one, and the layout holds per_cta owned
    proposals (K1 in f64 at 5 dims, K2 in f32)."""
    fam, K, D, La, C, M = FAMILIES[kind]
    dtype = torch.float64 if kind == "K1" else torch.float32
    plan = cluster.plan_cluster(fam, nwalkers, K, D, La, C, M, dtype, cluster=n)
    h = nwalkers // 2
    slices = [plan.owned(r) for r in range(n)]
    assert [j for sl in slices for j in sl] == list(range(h))
    sizes = [len(sl) for sl in slices]
    assert max(sizes) == plan.per_cta == -(-h // n)
    assert max(sizes) - min(sizes) <= 1
    assert plan.proposals == h
    offsets = dict(zip(REGIONS, plan.layout.offsets))
    assert offsets["zz"] - offsets["prop"] == dtype.itemsize * plan.per_cta * (D + 1)


@pytest.fixture
def card_capacity(monkeypatch):
    """Stand in for the card's answer of how many wide CTAs it keeps
    resident: card_capacity(n) makes cluster.wide_capacity answer n;
    cluster.steps_plan's cache is emptied before and after."""
    cluster.steps_plan.cache_clear()
    yield lambda n: monkeypatch.setattr(cluster, "wide_capacity", lambda *args: n)
    cluster.steps_plan.cache_clear()


@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_family_declares_a_wide_path_and_one_lnprob_over_512_lanes(kind):
    """Both families declare the wide step entry, (pointers, ints) of its C
    signature (their steps entry less the cluster size), and size the chi^2
    partials of a group by the 16 warps of lanes of their lnprob (the
    `<prefix>_geometry` the library is checked against)."""
    fam = FAMILIES[kind][0]
    assert fam.wide == (fam.args[0][0], fam.args[0][1] - 1)
    assert fam.partials == cluster.LANE_WARPS == cluster.THREADS // 32 == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,nwalkers", [("K1", 128), ("K1", 100), ("K2", 128)])
def test_wide_plan_is_one_proposal_a_cta(kind, nwalkers, dtype):
    """plan_wide: h = W / 2 CTAs a chain (64 at the flagship's 128
    walkers), each owning one proposal with all 16 warps in one lnprob
    group; no state in shared memory, one group's tau and partials, one
    proposal row, stretch factor and flag; the tables staged, and the
    layout within a CTA, at each family's sizes in f32 and f64 (K1: 9
    lines x 561 channels)."""
    fam, K, D, La, C, M = FAMILIES[kind]
    plan = cluster.plan_wide(fam, nwalkers, K, D, La, C, M, dtype)
    h = nwalkers // 2
    assert plan.wide and (plan.cluster, plan.proposals, plan.per_cta) == (h, h, 1)
    assert plan.warps_per_proposal == 16 and plan.staged and plan.fits
    assert [plan.owned(j) for j in range(h)] == [range(j, j + 1) for j in range(h)]
    offsets = dict(zip(REGIONS, plan.layout.offsets))
    item = dtype.itemsize
    assert offsets["state"] == 0 and offsets["chans"] == 0
    assert offsets["part"] - offsets["tau"] == item * K * La
    assert offsets["prop"] - offsets["part"] == item * fam.partials
    assert offsets["zz"] - offsets["prop"] == item * (D + 1)
    assert plan.layout == cluster.smem_layout(fam, dtype, K, La, C, M, ndim=D, per_cta=1,
                                              groups=1)


@pytest.mark.parametrize("kind", ["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_steps_plan_off_the_card_is_the_cluster_plan(kind, dtype):
    """Off the card the card is not asked: the wide capacity is 0, so a
    step launch's plan is the cluster plan of 16 CTAs, for one chain of
    128 walkers as for four."""
    fam, K, D, La, C, M = FAMILIES[kind]
    cpu = torch.device("cpu")
    wide = cluster.plan_wide(fam, 128, K, D, La, C, M, dtype)
    assert cluster.wide_capacity(fam, wide.layout, dtype, cpu) == 0
    for chains in (1, 4):
        plan = cluster.steps_plan(fam, 128, chains, K, D, La, C, M, dtype, cpu)
        assert not plan.wide and plan.cluster == 16
        assert plan == cluster.plan_cluster(fam, 128, K, D, La, C, M, dtype, cluster=16)


@pytest.mark.parametrize("nwalkers,chains,capacity,wide", [
    (128, 1, 132, True), (128, 2, 132, True), (128, 3, 132, False), (128, 4, 264, True),
    (128, 5, 264, False), (100, 2, 100, True), (100, 2, 99, False), (256, 1, 132, True),
    (2048, 1, 264, False), (128, 1, 0, False)])
def test_k1_wide_path_is_taken_exactly_when_the_chains_fit(card_capacity, nwalkers, chains,
                                                            capacity, wide):
    """cluster.steps_plan takes K1's wide plan exactly where the launch's
    chains x h CTAs fit the co-resident CTAs the card answers (0: a card
    with no cooperative launch), else K1's cluster plan (16 CTAs here,
    where no card is asked whether it places them)."""
    fam, K, D, La, C, M = FAMILIES["K1"]
    card_capacity(capacity)
    chosen = cluster.steps_plan(fam, nwalkers, chains, K, D, La, C, M, torch.float32,
                                torch.device("cpu"))
    want = (cluster.plan_wide(fam, nwalkers, K, D, La, C, M, torch.float32) if wide else
            cluster.plan_cluster(fam, nwalkers, K, D, La, C, M, torch.float32, cluster=16))
    assert chosen == want and chosen.wide == wide
    assert wide == (chains * (nwalkers // 2) <= capacity)


@pytest.mark.parametrize("n_chains", [1, 2])
def test_k1_fit_counts_its_plan_in_the_sampler_choice_span(tmp_path, monkeypatch, n_chains):
    """A K1 fit on the CPU, K1 forced (its runner's tables and plain steps
    run there): the `pipeline/model` span in which the fit chooses its
    sampler counts the plan of K1's step launch for n_chains ensembles of
    16 walkers — off the card, where nothing is launched, the cluster plan:
    `wide` 0, 16 `ctas`, `staged` 1 — on the one-ensemble path and the
    K-chain path; the fit's other spans count nothing of it."""
    import contextlib
    import io

    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit
    from cha1_mcmc_tpu_torch.utils import metrics
    from tests.port_problems import write_hc5n_problem

    p = write_hc5n_problem(str(tmp_path))
    cfg = FitConfig(mol_name="hc5n_hfs", cat_folder=p["cat_folder"], data_path=p["data_path"],
                    fit_folder=str(tmp_path / "fit"), nwalkers=16 * n_chains,
                    n_chains=n_chains, nruns=4, checkpoint_every=4, seed=0, device="cpu")
    fit = SpectralFit(cfg)
    monkeypatch.setattr(fit, "_use_fused", lambda model: True)
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    assert fit.sampler.run_fn.family is fused.FAMILY
    ours = [r for r in metrics.spans() if r.trace == fit.throughput.trace_id]
    counted = [r for r in ours if r.counts]
    assert [r.name for r in counted if "ctas" in r.counts] == ["pipeline/model"]
    (choice,) = [r for r in counted if "ctas" in r.counts]
    assert choice.counts == dict(wide=0, ctas=16, staged=1)
