"""Parallel execution layer: batched (vmap) and sharded (shard_map) solves.

The reference is a single-process CPU solver (SURVEY.md section 2.5); its
only scale-out is running benchmark instances as separate processes.  On
an accelerator these become first-class:

  * `batched`: a fully-on-device LP solver (outer IPM loop included) that
    `vmap`s over stacked instances -- a whole benchmark suite as one XLA
    program, instances masked as they converge.  The batch axis shards over
    a mesh with `shard_map` for multi-device suite runs.
  * `sharded`: block-row sharding of A across a mesh axis with
    `shard_map`; SpMV partials and CG/residual reductions ride `psum`
    (SURVEY.md section 3.4's "would-be distributed boundary").
  * `sparse_batched`: whole-solve-on-device COO+PCG driver for
    same-pattern SPARSE families (graph LPs) -- the reference's indirect
    regime (`indirect.c`) as one vmapped program.
  * `host_pool`: thread-parallel suite driver for host backends (the
    reference's xargs batch-runner role, in-process with a shared jit
    cache).
"""
from .batched import device_solve_lp, solve_lp_batch, solve_lp_suite
from .batched_qcp import (pad_conic_instances, prepare_conic_batch,
                          solve_qcp_batch, solve_qcp_device,
                          solve_qcp_het_batch)
from .sparse_batched import solve_lp_batch_coo
from .host_pool import pool_map, solve_lp_pool
from .sharded import sharded_normal_matvec, sharded_pcg

__all__ = [
    "device_solve_lp",
    "solve_lp_batch",
    "solve_lp_batch_coo",
    "solve_lp_suite",
    "pad_conic_instances",
    "prepare_conic_batch",
    "solve_qcp_batch",
    "solve_qcp_device",
    "solve_qcp_het_batch",
    "pool_map",
    "solve_lp_pool",
    "sharded_normal_matvec",
    "sharded_pcg",
]
