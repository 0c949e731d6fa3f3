"""The tables K3 and K5b read (sampler/fused_gather.py: block_line_tables,
GatherPlan), derived by the port from the same gather analysis as the JAX
package's channel-major tables, on the synthetic dense problem of
tests/port_problems.py: gathered through each channel block's line list
and each entry's slot they give back build_dense_tables' expanded line
constants bitwise, every slot lies in its block's list, the plan reports
the largest list (u_max) that the tables hold, and the plan puts the taus
in shared memory exactly where u_max x 8 of them fit a CTA. The kernel
itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from tests.port_problems import (DENSE_BOUNDS, DENSE_CENTER, DENSE_DISH,
                                 DENSE_SOURCE_SIZE, write_dense_problem)

DV_MAX = 1.5


def _model(problem, dtype):
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.models import SpectralModel
    from cha1_mcmc_tpu_torch.reduce import reduce_spectrum

    cat = load_catalog(problem["cat_path"])
    with contextlib.redirect_stdout(io.StringIO()):
        grid = reduce_spectrum(cat, problem["data_path"], ll=problem["ll"],
                               ul=problem["ul"], aligned_velocity=DENSE_CENTER,
                               dish_size=DENSE_DISH, source_size=DENSE_SOURCE_SIZE,
                               verbose=False)
    model = SpectralModel.build(cat, grid.covered_trans, grid.freqs, ll=problem["ll"],
                                ul=problem["ul"], dish_size=DENSE_DISH,
                                vel_offset=DENSE_CENTER, mask_center=DENSE_CENTER,
                                device="cpu", dtype=dtype)
    return model, grid


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The dense problem at the CPU tests' size (228 lines x 858 channels,
    a split gather table), float32 and float64 models."""
    with contextlib.redirect_stdout(io.StringIO()):
        problem = write_dense_problem(str(tmp_path_factory.mktemp("dense")), scale="small")
    return problem, {dt: _model(problem, dt) for dt in (torch.float32, torch.float64)}


def _plan(small, dtype, min_saving, cblock):
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler.fused_gather import (gather_statics_tables,
                                                          plan_fused_gather)

    problem, models = small
    model, grid = models[dtype]
    spec = ParamSpec(ncomp=1, fixed_source_size=DENSE_SOURCE_SIZE)
    plan = plan_fused_gather(model, spec, DV_MAX, 16, min_saving=min_saving, cblock=cblock)
    ncol = problem["truth"][0]
    means = np.array([1.2 * ncol, 8.0, DENSE_CENTER, 0.7575])
    stds = np.array([0.5 * ncol, 3.0, 0.06, 0.22])
    _, tables, kplan = gather_statics_tables(model, spec, grid.ints, grid.yerrs,
                                             dict(DENSE_BOUNDS), means, stds, plan)
    return plan, tables, kplan


def _blocks_of(n_channels, cblock):
    return torch.arange(n_channels) // cblock


@pytest.mark.parametrize("cblock", [32, 128, 256, 512])
@pytest.mark.parametrize("min_saving", [1.3, 1e9], ids=["split", "rect"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_block_lists_and_slots_give_back_the_expanded_tables(small, dtype, min_saving,
                                                             cblock):
    """lines[:, block_lines[b, slot]] equals build_dense_tables' lines1 /
    lines2 at every entry (padding included) of the main and overflow
    tables, for split and rectangular tables and every channel block; each
    slot lies inside its block's list, the list is sorted and distinct and
    holds exactly the lines its entries reference."""
    plan, tables, kp = _plan(small, dtype, min_saving, cblock)
    lines1, _, lines2, _, _, _ = tables
    geom = plan["geometry"]
    assert (kp.cblock, kp.cb0, kp.n_blk) == (geom.cblock, geom.cb0, geom.n_blk)
    assert (geom.cb0 > 0) == (min_saving == 1.3)
    counts = (kp.block_lines >= 0).sum(dim=1)
    assert int(counts.max()) == kp.u_max
    for b in range(kp.n_blk):
        lst = kp.block_lines[b, :counts[b]]
        assert (kp.block_lines[b, counts[b]:] == -1).all()
        assert torch.equal(lst, torch.unique(lst))           # sorted, distinct
    for lines_x, slot, idx, width in ((lines1, kp.slot1, kp.idx1, lines1.shape[2]),
                                      (lines2, kp.slot2, kp.idx2, geom.cb0)):
        if width == 0:
            continue
        slot, idx = slot[:, :width].long(), idx[:, :width].long()
        blk = _blocks_of(width, cblock)[None, :].expand_as(slot)
        assert (slot >= 0).all() and (slot < counts[blk]).all()
        assert torch.equal(kp.block_lines[blk, slot].long(), idx)
        assert torch.equal(kp.lines[:, idx], lines_x[:, :, :width])
    for b in range(kp.n_blk):   # each list holds only lines its entries reference
        cols = slice(b * cblock, (b + 1) * cblock)
        used = [kp.idx1[:, cols].ravel()]
        if geom.cb0:
            used.append(kp.idx2[:, cols].ravel())
        assert torch.equal(torch.unique(torch.cat(used)), kp.block_lines[b, :counts[b]])
    assert kp.tau_shared and kp.grid == 0


def test_taus_go_to_device_memory_past_the_shared_limit(small, monkeypatch):
    """The plan puts a tile's taus in shared memory exactly where u_max x
    ROWS of them fit the budget, at each dtype; past it (here a budget one
    byte short) the taus go to device memory and every problem is still
    taken; block lists too long for int16 slots carry none."""
    from cha1_mcmc_tpu_torch.sampler import fused_gather as fg

    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        _, _, kp = _plan(small, dtype, 1.3, 128)
        need = kp.u_max * fg.ROWS * size
        assert kp.tau_smem_bytes(dtype) == need and kp.tau_shared
        monkeypatch.setattr(fg, "_TAU_SMEM_BYTES", need)
        assert _plan(small, dtype, 1.3, 128)[2].tau_shared
        monkeypatch.setattr(fg, "_TAU_SMEM_BYTES", need - 1)
        plan, _, kp = _plan(small, dtype, 1.3, 128)
        assert plan is not None and not kp.tau_shared and kp.idx1 is not None
        monkeypatch.undo()
    many = np.arange(40_000, dtype=np.int32)[None, :]         # one block, 40,000 lines
    kn = fg.block_line_tables(many, np.zeros((1, 1), np.int32),
                              fg.GatherGeometry(40_000, 0, 1))
    assert kn["u_max"] == 40_000 and kn["slot1"] is None and kn["slot2"] is None


@pytest.mark.parametrize("min_saving", [1.3, 1e9], ids=["split", "rect"])
def test_plan_checks_its_tables_once_and_a_launch_reads_only_its_own(small, monkeypatch,
                                                                      min_saving):
    """GatherPlan checks its derived tables when it is made (a slot table
    of the wrong dtype or width, a short block list or a channel block off
    the kernel's limits is refused there); kernel_operands then hands the
    kernel the velocities, chans and qst of the call's tables (never the
    expanded lines1 / lines2, which only the plain version reads) with the
    slots where the taus are shared and the active-line indices where they
    are not, and lays the scratch out in one buffer."""
    import dataclasses

    from cha1_mcmc_tpu_torch.sampler import fused_gather as fg

    _, tables, kp = _plan(small, torch.float64, min_saving, 128)
    bad = (dict(slot1=kp.slot1.int()), dict(slot2=kp.slot2[:, :-1]),
           dict(block_lines=kp.block_lines[:, :-1]), dict(cblock=100),
           dict(idx1=kp.idx1.long()))
    for change in bad:
        with pytest.raises(ValueError):
            dataclasses.replace(kp, **change)
    monkeypatch.setattr(fg, "launch_grid", lambda geom, n, dtype, device: 7)
    reads = (None, *tables[1:2], None, *tables[3:])       # no lines1 / lines2
    n_rows, ndim = 8, 4
    for plan, keys in ((kp, (kp.slot1, kp.slot2)),
                       (dataclasses.replace(kp, tau_shared=False), (kp.idx1, kp.idx2))):
        ptrs, buf, scratch, ints = fg.kernel_operands(reads, plan, torch.float64,
                                                      torch.device("cpu"), n_rows, ndim, 2)
        assert ptrs == [t.data_ptr() for t in (kp.lines, tables[1], tables[3], *keys,
                                               kp.block_lines, tables[4], tables[5])]
        La, (M1, C), (M2, _) = kp.lines.shape[1], kp.idx1.shape, kp.idx2.shape
        assert ints == (La, M1, M2, C, kp.cb0, tables[5].shape[1], kp.u_max, 128, kp.n_blk,
                        7, int(plan.tau_shared))
        taus = 8 * (1 if plan.tau_shared else n_rows * La)
        assert scratch[-1] - scratch[-2] == -(-taus // 16) * 16
        assert buf.numel() >= scratch[-1] - buf.data_ptr() + 4 * 2
    with pytest.raises(ValueError):
        fg.kernel_operands(reads, kp, torch.float32, torch.device("cpu"), n_rows, ndim, 2)


def test_u_max_on_the_full_dense_problem(tmp_path):
    """At the dense fit's size (2,232 lines x 10,924 channels, split
    tables at dV 1.5, channel blocks of 128) no block references more than
    56 distinct lines (padding's line included), counted here from the
    gather analysis itself, and the plan reports that u_max; the 86 lists
    hold 2,910 (block, line) pairs against 114,453 table entries a
    proposal walks."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.models.sparse_opacity import build_opacity_gather_split
    from cha1_mcmc_tpu_torch.sampler.fused_gather import plan_fused_gather

    with contextlib.redirect_stdout(io.StringIO()):
        problem = write_dense_problem(str(tmp_path), scale="full")
    model, _ = _model(problem, torch.float32)
    assert (model.n_lines, model.n_channels) == (2232, 10924)
    spec = ParamSpec(ncomp=1, fixed_source_size=DENSE_SOURCE_SIZE)
    plan = plan_fused_gather(model, spec, DV_MAX, 128)
    t1, _, t2, _, heavy, _ = build_opacity_gather_split(model.vel_grid.numpy(),
                                                        model.mask_center, DV_MAX)
    C = model.n_channels
    perm = np.concatenate([heavy, np.setdiff1d(np.arange(C), heavy)])
    t1 = t1[:, perm]
    assert t1.size + t2.size == 114_453
    geom = plan["geometry"]
    cb0 = geom.cb0
    t2 = np.pad(t2, ((0, 0), (0, cb0 - t2.shape[1])))
    sizes = []
    for b in range(geom.n_blk):
        cols = slice(b * 128, (b + 1) * 128)
        sizes.append(np.unique(np.concatenate([t1[:, cols].ravel(),
                                               t2[:, cols].ravel()])).size)
    assert geom.n_blk == 86 and cb0 == 1536
    assert plan["kernel"]["u_max"] == max(sizes) == 56
    assert sum(sizes) == 2910
