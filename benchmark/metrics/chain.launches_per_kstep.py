"""chain.launches_per_kstep (launches/kstep): kernel launches of the
program's kernel wrappers (`cha1_mcmc_tpu_torch.utils.kernel_launches`,
every entry) across the window, per 1,000 ensemble steps."""


def read(run):
    if not run.steps:
        return None
    return sum(run.launches.values()) / (run.steps / 1000.0)
