"""torch.distributed ranks for the tests of the port's sharded path
(tests/test_torch_parallel.py, tests/test_torch_sharded_fused.py).

`spawn(fn, world, tmp_path, *args)` starts `world` processes with
torch.multiprocessing.spawn (start method spawn: the test process holds
JAX, which a forked child must not inherit), joins them in a gloo group
over a FileStore under tmp_path, and calls fn(rank, *args) in each, with
one CPU thread per rank. `fn` must be a module-level function; its module
is imported in each rank, so a test file that holds rank functions
imports torch and the port at the top, and JAX only inside its tests.
Ranks hand their results back through files under tmp_path.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _rank_main(rank: int, world: int, store_path: str | None, fn, args,
               timeout: float | None):
    torch.set_num_threads(1)
    if store_path is not None:
        kw = {} if timeout is None else dict(timeout=datetime.timedelta(seconds=timeout))
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world, **kw)
    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, init: bool = True,
          timeout: float | None = None) -> None:
    """Run fn(rank, *args) on `world` gloo ranks; raises if a rank fails.
    With init=False a single process starts with no group (what
    make_mesh then does itself); `timeout` (seconds) bounds the group's
    collectives (torch's default otherwise)."""
    store = os.path.join(str(tmp_path), f"store-{fn.__name__}-{world}") if init else None
    mp.spawn(_rank_main, args=(world, store, fn, args, timeout), nprocs=world, join=True)
