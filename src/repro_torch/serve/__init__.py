"""Continuous-batching serve engine (counterpart of ``repro/serve``:
the dense, moe, hybrid and ssm families).

  paging   one f32 pool (n_pages, page_elems) of KV pages and recurrent-
           state rows on the device, updated in place; host FreeList
  decode   the per-layer decode step and the prefill of each family,
           through the paged decode-attention and flash-attention kernels
  engine   the host scheduler: admit into freed slots every step, retire
           without changing a shape; static-batch policy for baselines
  handoff  restore trained params (pytree or packed flat buffer) from
           checkpoint/io.py of either package
"""
from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                      drive_workload, poisson_workload)
from repro_torch.serve.handoff import restore_params
from repro_torch.serve.paging import PageGeom

__all__ = ["Engine", "EngineConfig", "Request", "PageGeom",
           "drive_workload", "poisson_workload", "restore_params"]
