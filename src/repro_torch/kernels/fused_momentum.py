"""Fused heavy-ball momentum update (counterpart of
``repro/kernels/fused_momentum.py``).

``mu <- beta*mu + g; p <- p - lr*mu`` over the (G, N) buffers in one
pass, in place, both outputs written from one read of p, g and mu. On a
CUDA tensor it launches ``repro_fused_momentum``
(``csrc/fused_update.cu``); on a CPU tensor it takes ``ref.momentum_ref``.
"""
from __future__ import annotations

from repro_torch.kernels import (assign_rows, blocks_per_row, build,
                                 check_active, check_rows, ptr, resolve_impl,
                                 stream_of)
from repro_torch.kernels.ref import momentum_ref

launches = 0     # kernel launches since the count was last set to 0


def fused_momentum(p, g, mu, *, lr, beta=0.9, active=None, impl="auto"):
    """In place on ``p`` and ``mu``; inactive rows keep both. Returns
    ``(p, mu)``."""
    global launches
    rows, n = check_rows("fused_momentum", p, g, mu)
    check_active("fused_momentum", active, rows, p.device)
    if resolve_impl(impl, p.device) == "torch":
        assign_rows(active, (p, mu), momentum_ref(p, g, mu, lr=lr, beta=beta))
        return p, mu
    build.launch("fused_update", "repro_fused_momentum", p.data_ptr(),
                 g.data_ptr(), mu.data_ptr(), ptr(active), rows, n,
                 blocks_per_row(p), stream_of(p), lr, beta)
    launches += 1
    return p, mu
