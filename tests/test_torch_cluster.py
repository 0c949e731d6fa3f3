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
