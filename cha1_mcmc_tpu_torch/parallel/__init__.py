"""Multi-device sampling over torch.distributed.

Port of cha1_mcmc_tpu/parallel. The reference's entire distributed story
is a CPython multiprocessing pool mapping walker lnprob evaluations onto
CPU processes (reference inference.py:456-463). Here each process is one
rank with one device, and the ranks form a ('chains', 'walkers', 'lines')
mesh (sharded.make_mesh):

  * 'walkers' — ensemble data parallelism. Each rank owns a walker shard;
    the stretch move's complementary half is all_gathered over the walker
    group once per half-step (a few KB).
  * 'lines' — model parallelism over catalog transitions: each rank
    accumulates the opacity over its line shard and the partials are
    all_reduced over the line group.
  * 'chains' — independent ensembles; no collective crosses it.

NCCL on the cards, gloo on the CPU; a launcher (torchrun) starts one
process per device and multihost.initialize_multihost joins them.
Independent molecules distribute across hosts
(multihost.host_molecule_assignment).
"""

from cha1_mcmc_tpu_torch.parallel.multihost import (host_molecule_assignment,
                                                    initialize_multihost)
from cha1_mcmc_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedEnsembleSampler,
    make_mesh,
    make_sharded_runner,
    make_sharded_sampler,
    pad_model_lines,
    run_ensemble_sharded,
)
from cha1_mcmc_tpu_torch.parallel.sharded_fused import (
    fused_multi_sharded_supported,
    fused_sharded_supported,
    make_fused_gather_sharded_runner,
    make_fused_multi_sharded_runner,
    make_fused_sharded_runner,
    plan_fused_gather_sharded,
)

__all__ = ["Mesh", "ShardedEnsembleSampler", "make_mesh", "make_sharded_runner",
           "make_sharded_sampler", "make_fused_sharded_runner",
           "make_fused_gather_sharded_runner", "plan_fused_gather_sharded",
           "make_fused_multi_sharded_runner", "fused_multi_sharded_supported",
           "fused_sharded_supported", "pad_model_lines", "run_ensemble_sharded",
           "initialize_multihost", "host_molecule_assignment"]
