"""Fused AdamW update (counterpart of ``repro/kernels/fused_adamw.py``).

Moment updates, bias correction, decoupled weight decay and write-back
in one pass over the (G, N) buffers, in place. The bias correction
``[1 - b1**c, 1 - b2**c]`` is formed on the device in float32 from the
post-increment count, one pair per row, so a per-group count (the t_i
mask) needs no host round trip. On a CUDA tensor it launches
``repro_fused_adamw`` (``csrc/fused_update.cu``); on a CPU tensor it
takes ``ref.adamw_ref``.
"""
from __future__ import annotations

from repro_torch.kernels import (assign_rows, blocks_per_row, build,
                                 check_active, check_rows, ptr, resolve_impl,
                                 stream_of)
from repro_torch.kernels.ref import adamw_bias_correction, adamw_ref

launches = 0     # kernel launches since the count was last set to 0


def fused_adamw(p, g, m, v, count, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                wd=0.0, active=None, impl="auto"):
    """In place on ``p``, ``m`` and ``v``. ``count`` is the post-increment
    step count: a scalar tensor, or one per row. Inactive rows keep all
    three buffers. Returns ``(p, m, v)``."""
    global launches
    rows, n = check_rows("fused_adamw", p, g, m, v)
    check_active("fused_adamw", active, rows, p.device)
    if count.shape not in ((), (rows,)) or count.device != p.device:
        raise ValueError(f"fused_adamw: count must be a scalar or ({rows},) "
                         f"tensor on {p.device}, got {tuple(count.shape)} "
                         f"on {count.device}")
    bc = adamw_bias_correction(count.expand(rows), b1, b2).contiguous()
    if resolve_impl(impl, p.device) == "torch":
        assign_rows(active, (p, m, v),
                    adamw_ref(p, g, m, v, bc, lr=lr, b1=b1, b2=b2, eps=eps,
                              wd=wd))
        return p, m, v
    build.launch("fused_update", "repro_fused_adamw", p.data_ptr(),
                 g.data_ptr(), m.data_ptr(), v.data_ptr(), bc.data_ptr(),
                 ptr(active), rows, n, blocks_per_row(p), stream_of(p),
                 lr, b1, 1 - b1, b2, 1 - b2, eps, wd)
    launches += 1
    return p, m, v

