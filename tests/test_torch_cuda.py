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
opacity on the dense problem in both formulas, masked and unmasked; the
sharded half-steps K5a / K5c / K5b at world size 1, against their plain
versions and against K1 / K2 / K3; T3's probes. Every test here needs a CUDA device and nvcc, and skips without them; on
the card run

    python -m pytest tests/test_torch_cuda.py --noconftest

(--noconftest: tests/conftest.py imports jax, which the GPU machine
does not need or have.)
"""

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


def test_k4_kernels_match_plain(dense_cases):
    import chip_smoke
    from cha1_mcmc_tpu_torch.models import opacity_kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    before = dict(opacity_kernels.LAUNCHES)
    errs = {}
    chip_smoke.check_opacity(dense_cases["cheb-split-4d"], gen, errs)
    assert all(opacity_kernels.LAUNCHES[k] > before[k] for k in before)
    assert set(errs) == {"block", "csr"}


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
