"""The K4 kernels' design, checked on the CPU: the prefilter of
csrc/opacity.cu (models/opacity_kernels.py: walker_radius, candidates) and
the K4 plan.

* Masked: summing, per channel and in line order, only the terms of the
  prefilter's candidates that pass each walker's own window test — what
  the kernels do — gives opacity_block_plain's and opacity_csr_plain's
  sums in float64 (rtol 1e-12: the plain versions reduce in another
  order), and every term the prefilter drops is exactly 0 in the plain
  versions. Walkers at the prior's dV bound and at the vlsr box's edges.
* Unmasked: every term the kernels drop (|v - mc| at or past a walker's
  radius) is exactly 0.0 in the plain version's exp2, in float32 and
  float64, for walkers inside and far outside any prior box, including
  velocities within a few ulps of each radius.
* The plan (plan_opacity_block / plan_opacity_csr) raises on tables of
  the wrong shape, type or device, hands the kernel velocity rows 16
  bytes apart and 16-byte aligned (kernel_rows: a NaN-padded copy where
  the table lacks them), and its CPU route equals the JAX Pallas kernels
  in interpret mode.

The kernels themselves are held to the plain versions on the card
(chip_smoke.py phase 3, tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cha1_mcmc_tpu_torch.models import opacity_kernels as ok
from cha1_mcmc_tpu_torch.models.sparse_opacity import (TC, TL, block_activity_mask,
                                                       build_opacity_csr)

torch.set_num_threads(1)

CENTER, DV_MAX = 4.10, 1.5


def _problem(seed, dtype=np.float64, W=12, L=700, C=300, edges=True):
    """Ragged tiles (700 lines: two 512-line tiles; 300 channels: three
    128-channel tiles); walkers with dV in [0.5, 1.5], a quarter of them
    exactly at the bound, and vlsr uniform in [center - 0.3, center +
    0.3], a quarter at each edge — or, edges=False, tests/test_torch_dense's
    walkers (dV in [0.5, 1.2], vlsr in [center - 0.1, center + 0.2])."""
    rng = np.random.default_rng(seed)
    line_freq = np.sort(rng.uniform(18e3, 25e3, L))
    grid_freq = np.sort(rng.uniform(18e3, 25e3, C))
    vel = ((line_freq[:, None] - grid_freq[None, :]) / line_freq[:, None]
           * 2.998e5 + CENTER).astype(dtype)
    taus = rng.uniform(0, 0.1, (W, L)).astype(dtype)
    if edges:
        dV = rng.uniform(0.5, DV_MAX, W)
        dV[: W // 4] = DV_MAX
        vlsr = rng.uniform(CENTER - 0.3, CENTER + 0.3, W)
        vlsr[W // 4: W // 2] = CENTER - 0.3
        vlsr[W // 2: 3 * W // 4] = CENTER + 0.3
    else:
        vlsr = rng.uniform(CENTER - 0.1, CENTER + 0.2, W)
        dV = rng.uniform(0.5, 1.2, W)
    return [torch.from_numpy(np.asarray(x, dtype=dtype)) for x in (vel, taus, vlsr, dV)]


def _rows_per_tile(kind, vel, mask_or_csr):
    """{channel tile: (rows (n, 128-wide velocities), their lines)} in the
    order the kernels walk them: the lines of the active 512-line tiles
    (K4a), or the tile's compacted lines (K4b)."""
    L, C = vel.shape
    out = {}
    for ct in range(-(-C // TC)):
        if kind == "block":
            tiles = np.flatnonzero(mask_or_csr[:, ct])
            lines = np.concatenate([np.arange(t * TL, min((t + 1) * TL, L))
                                    for t in tiles]) if tiles.size else np.zeros(0, int)
            rows = vel[lines, ct * TC:(ct + 1) * TC]
        else:
            lt, vc, tc = mask_or_csr
            K = lt.shape[1]
            lines = lt[ct, :tc[ct]]
            rows = torch.from_numpy(vc[ct * K:ct * K + tc[ct], :min(TC, C - ct * TC)])
        out[ct] = (rows, torch.as_tensor(lines, dtype=torch.long))
    return out


def _kernel_sum(kind, vel, taus, vlsr, dV, tables, form, masked):
    """The kernels' sum in torch: per channel, the candidates in line
    order; per walker, its own radius test, the Gaussian and tau * g added
    one term at a time."""
    W, C = taus.shape[0], vel.shape[1]
    radius = ok.walker_radius(vlsr, dV, CENTER, masked=masked)
    out = torch.zeros((W, C), dtype=taus.dtype)
    for ct, (rows, lines) in _rows_per_tile(kind, vel, tables).items():
        cand = ok.candidates(rows, vlsr, dV, CENTER, masked=masked)
        for j in range(rows.shape[1]):
            k = torch.nonzero(cand[:, j]).flatten()
            if k.numel() == 0:
                continue
            v = rows[k, j]
            g = ok._gauss(v[:, None], vlsr, dV, CENTER, form, masked)[..., 0]   # (W, n)
            keep = torch.abs(v - torch.tensor(CENTER, dtype=v.dtype))[None] < radius[:, None]
            terms = torch.where(keep, taus[:, lines[k]] * g, torch.zeros((), dtype=g.dtype))
            acc = torch.zeros(W, dtype=taus.dtype)
            for t in range(terms.shape[1]):
                acc = acc + terms[:, t]
            out[:, ct * TC + j] = acc
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["block", "csr"])
def test_masked_candidates_alone_give_the_plain_sum(kind, seed):
    vel, taus, vlsr, dV = _problem(seed)
    if kind == "block":
        tables = block_activity_mask(vel.numpy(), CENTER, DV_MAX)
        want = ok.opacity_block_plain(taus, vlsr, dV, vel, torch.from_numpy(tables),
                                      mask_center=CENTER, form="exp2")
    else:
        tables = build_opacity_csr(vel.numpy(), CENTER, DV_MAX)
        want = ok.opacity_csr_plain(taus, vlsr, dV,
                                    *(torch.from_numpy(x) for x in tables),
                                    mask_center=CENTER, n_channels=vel.shape[1])
    got = _kernel_sum(kind, vel, taus, vlsr, dV, tables, "exp2", True)
    assert want.max() > 0 and (got > 0).sum() > 0.1 * got.numel()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)

    # every term the prefilter drops is exactly 0 in the plain version, and
    # the candidates are a small part of the active elements
    for rows, lines in _rows_per_tile(kind, vel, tables).values():
        cand = ok.candidates(rows, vlsr, dV, CENTER, masked=True)
        terms = taus[:, lines, None] * ok._gauss(rows, vlsr, dV, CENTER, "exp2", True)
        assert not terms[:, ~cand].any()
        assert cand.float().mean() < 0.5


def test_masked_radius_is_the_window_and_the_prefilter_its_widest():
    _, _, vlsr, dV = _problem(3, dtype=np.float32)
    radius = ok.walker_radius(vlsr, dV, CENTER, masked=True)
    assert torch.equal(radius, 10.0 * dV) and radius.dtype == torch.float32
    v = torch.linspace(CENTER - 20.0, CENTER + 20.0, 40001, dtype=torch.float32)
    cand = ok.candidates(v, vlsr, dV, CENTER, masked=True)
    window = torch.abs(v - CENTER)[None] < (10.0 * dV)[:, None]
    assert torch.equal(cand, window.any(dim=0))


def _far_walkers(dtype, rng):
    """Walkers inside and far outside any prior box: vlsr up to 60 km/s off
    the centre, dV from 1e-3 to 50, and the degenerate dV = 0."""
    W = 64
    vlsr = CENTER + rng.uniform(-60.0, 60.0, W)
    dV = np.exp(rng.uniform(np.log(1e-3), np.log(50.0), W))
    vlsr[:8] = CENTER + rng.uniform(-0.2, 0.2, 8)
    dV[:8] = rng.uniform(0.5, 1.2, 8)
    dV[8] = 0.0
    return (torch.from_numpy(vlsr.astype(dtype)), torch.from_numpy(dV.astype(dtype)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_unmasked_skip_drops_only_exact_zeros(dtype):
    rng = np.random.default_rng(7)
    vlsr, dV = _far_walkers(dtype, rng)
    radius = ok.walker_radius(vlsr, dV, CENTER, masked=False)
    assert torch.isinf(radius[8]) and torch.isfinite(radius[9:]).all()
    # velocities on a wide grid and within a few ulps of every radius
    r = radius[torch.isfinite(radius)].numpy()
    edge = np.concatenate([CENTER + s * r * f for s in (-1, 1)
                           for f in (1 - 1e-6, 1 - 4e-7, 1.0, 1 + 4e-7, 1 + 1e-6)])
    v = np.concatenate([np.linspace(CENTER - 400.0, CENTER + 400.0, 20001), edge])
    v = torch.from_numpy(v.astype(dtype))
    g = ok._gauss(v[None, :], vlsr, dV, CENTER, "exp2", False)[:, 0, :]   # (W, n)
    dropped = ~(torch.abs(v - torch.tensor(CENTER, dtype=v.dtype))[None] < radius[:, None])
    assert dropped.sum() > 0.5 * dropped.numel()
    assert not g[dropped].any(), "a dropped term is not exactly 0"
    # the prefilter drops an element only where every walker drops it
    cand = ok.candidates(v, vlsr, dV, CENTER, masked=False)
    assert not cand.all() or torch.isinf(radius).any()
    assert not g[:, ~cand].any()
    # and what the walkers keep is not all zero: the test has teeth
    assert (g[~dropped] > 0).sum() > 1000


def test_unmasked_radius_is_tight_enough_to_skip_most_of_a_tile():
    """In the prior box of the dense fit (|vlsr - mc| <= 0.2, dV >= 0.5),
    the unmasked radius lies inside the masked window: the unmasked forms
    evaluate no more candidates than the masked ones."""
    rng = np.random.default_rng(11)
    vlsr = torch.from_numpy(CENTER + rng.uniform(-0.2, 0.2, 32)).float()
    dV = torch.from_numpy(rng.uniform(0.5, DV_MAX, 32)).float()
    assert (ok.walker_radius(vlsr, dV, CENTER, masked=False)
            < ok.walker_radius(vlsr, dV, CENTER, masked=True)).all()


def _block_tables(dtype=torch.float64):
    vel, _, _, _ = _problem(0)
    vel = vel.to(dtype)
    mask = torch.from_numpy(block_activity_mask(vel.numpy(), CENTER, DV_MAX))
    return vel, mask


def _csr_tables(dtype=np.float64):
    vel, _, _, _ = _problem(0, dtype=dtype)
    return [torch.from_numpy(x) for x in build_opacity_csr(vel.numpy(), CENTER, DV_MAX)]


_BAD_BLOCK = {
    "vel_grid 1-D": lambda v, m: (v[0], m),
    "vel_grid int": lambda v, m: (v.to(torch.int32), m),
    "vel_grid not contiguous": lambda v, m: (v.t().contiguous().t(), m),
    "mask int64": lambda v, m: (v, m.long()),
    "mask one tile short": lambda v, m: (v, m[:, :-1].contiguous()),
    "mask on another device": lambda v, m: (v, m.to("meta")),
}


@pytest.mark.parametrize("bad", list(_BAD_BLOCK))
def test_block_plan_raises_on_bad_tables(bad):
    vel, mask = _block_tables()
    ok.plan_opacity_block(vel, mask, mask_center=CENTER)          # the good tables
    with pytest.raises(ValueError):
        ok.plan_opacity_block(*_BAD_BLOCK[bad](vel, mask), mask_center=CENTER)


_BAD_CSR = {
    "line_table int64": lambda lt, vc, tc: (lt.long(), vc, tc),
    "line_table 1-D": lambda lt, vc, tc: (lt.reshape(-1), vc, tc),
    "vel_compact 64 wide": lambda lt, vc, tc: (lt, vc[:, :64].contiguous(), tc),
    "vel_compact float16": lambda lt, vc, tc: (lt, vc.half(), tc),
    "tile_counts one short": lambda lt, vc, tc: (lt, vc, tc[:-1]),
    "tile_counts on another device": lambda lt, vc, tc: (lt, vc, tc.to("meta")),
}


@pytest.mark.parametrize("bad", list(_BAD_CSR))
def test_csr_plan_raises_on_bad_tables(bad):
    lt, vc, tc = _csr_tables()
    ok.plan_opacity_csr(lt, vc, tc, mask_center=CENTER, n_channels=300)
    with pytest.raises(ValueError):
        ok.plan_opacity_csr(*_BAD_CSR[bad](lt, vc, tc), mask_center=CENTER, n_channels=300)


@pytest.mark.parametrize("n_channels", [385, 0, -1, 1000])
def test_csr_plan_raises_on_channels(n_channels):
    with pytest.raises(ValueError):
        ok.plan_opacity_csr(*_csr_tables(), mask_center=CENTER, n_channels=n_channels)


def _misaligned(vel):
    """vel's float32 values in a contiguous tensor that starts 4 bytes past
    a 16-byte boundary."""
    flat = torch.empty(vel.numel() + 4, dtype=torch.float32)
    k = (4 - flat.data_ptr() % 16) % 16 // 4
    out = flat[k:k + vel.numel()].view(vel.shape)
    out.copy_(vel)
    return out


@pytest.mark.parametrize("dtype, C, copied", [
    (torch.float32, 300, False), (torch.float32, 301, True), (torch.float32, 303, True),
    (torch.float64, 300, False), (torch.float64, 301, True), ("misaligned", 300, True)])
def test_kernel_rows_are_16_bytes_apart(dtype, C, copied):
    """kernel_rows gives the kernels' 16-byte copies what they need: the
    table itself where its base and row pitch are multiples of 16 bytes,
    else a copy with the same values, a pitch rounded up to 16 bytes and
    NaN past the last channel."""
    vel = _problem(0, C=C)[0]
    vel = _misaligned(vel.float()) if dtype == "misaligned" else vel.to(dtype)
    rows, pitch = ok.kernel_rows(vel)
    assert (rows is not vel) == copied
    assert rows.data_ptr() % 16 == 0 and pitch * rows.element_size() % 16 == 0
    assert rows.shape == (vel.shape[0], pitch) and C <= pitch < C + 16 // vel.element_size()
    assert torch.equal(rows[:, :C], vel) and torch.isnan(rows[:, C:]).all()


@pytest.mark.parametrize("C", [300, 301])
def test_plans_pack_the_kernel_rows(C):
    """The plans pass the kernels the padded rows and their pitch (K4a) or
    vel_compact's 128-value rows (K4b), and keep the rows alive."""
    vel = _problem(0, dtype=np.float32, C=C)[0]
    mask = torch.from_numpy(block_activity_mask(vel.numpy(), CENTER, DV_MAX)).to(torch.int32)
    plan = ok.plan_opacity_block(vel, mask, mask_center=CENTER)
    assert plan.packed.vel == plan.rows.data_ptr() and plan.packed.pitch == plan.rows.shape[1]
    assert (plan.rows is vel) == (C % 4 == 0) and plan.packed.C == C
    lt, vc, tc = (torch.from_numpy(x) for x in build_opacity_csr(vel.numpy(), CENTER, DV_MAX))
    plan = ok.plan_opacity_csr(lt, vc.float(), tc, mask_center=CENTER, n_channels=C)
    assert plan.packed.pitch == TC and plan.packed.vel == plan.rows.data_ptr()


def test_planned_call_refuses_a_form_the_kernels_lack():
    vel, taus, vlsr, dV = _problem(0)
    plan = ok.plan_opacity_csr(*_csr_tables(), mask_center=CENTER, n_channels=300)
    with pytest.raises(ValueError):
        ok.opacity_planned(plan, taus, vlsr, dV, form="exp")
    plan = ok.plan_opacity_block(*_block_tables(), mask_center=CENTER)
    with pytest.raises(ValueError):
        ok.opacity_planned(plan, taus, vlsr, dV, form="exp", masked=False)


@pytest.mark.parametrize("kind", ["block", "csr"])
def test_planned_cpu_route_matches_jax(kind):
    """The plan's CPU route (the plain version over the plan's tables)
    against the JAX Pallas kernels in interpret mode, float32 masked exp2
    (opacity_pallas_mxu / opacity_pallas_csr), rtol 1e-5 (another order),
    atol 1e-5 of the largest opacity: a sum made of tail terms only
    (exp2 arguments of -60 to -150) carries the relative error of its
    argument's rounding, |x| times 2^-24, up to ~1e-5, on
    tests/test_torch_dense's walkers."""
    from cha1_mcmc_tpu.models import pallas_kernels as jk

    vel, taus, vlsr, dV = _problem(2, dtype=np.float32, edges=False)
    args = [jnp.asarray(x.numpy()) for x in (taus, vlsr, dV)]
    if kind == "block":
        vel_t, mask = _block_tables(torch.float32)
        plan = ok.plan_opacity_block(vel_t, mask, mask_center=CENTER)
        want = jk.opacity_pallas_mxu(*args, jnp.asarray(vel_t.numpy()),
                                     jnp.asarray(mask.numpy()), mask_center=CENTER,
                                     interpret=True)
    else:
        lt, vc, tc = _csr_tables(np.float32)
        plan = ok.plan_opacity_csr(lt, vc, tc, mask_center=CENTER, n_channels=300)
        want = jk.opacity_pallas_csr(*args, *(jnp.asarray(x.numpy()) for x in (lt, vc, tc)),
                                     mask_center=CENTER, n_channels=300, interpret=True)
    got = ok.opacity_planned(plan, taus, vlsr, dV)
    want = np.asarray(want)
    assert got.shape == want.shape and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(want.max()))
