"""Fused SGD update (counterpart of ``repro/kernels/fused_sgd.py``).

The packed round's ``--opt sgd`` step: ``p <- p - lr*g`` over the whole
(G, N) buffer in one pass, in place. On a CUDA tensor it launches
``repro_fused_sgd`` (``csrc/fused_update.cu``: one block a strip of the
active rows, the mask read on the device); on a CPU tensor it takes
``ref.sgd_ref``.
"""
from __future__ import annotations

from repro_torch.kernels import (assign_rows, build, check_active,
                                 check_rows, ptr, resolve_impl, stream_of)
from repro_torch.kernels.ref import sgd_ref

launches = 0     # kernel launches since the count was last set to 0


def fused_sgd(p, g, *, lr, active=None, impl="auto"):
    """In place on the (G, N) float32 buffer ``p``; rows where the (G,)
    bool ``active`` is False are left untouched. Returns ``p``."""
    global launches
    rows, n = check_rows("fused_sgd", p, g)
    check_active("fused_sgd", active, rows, p.device)
    if resolve_impl(impl, p.device) == "torch":
        assign_rows(active, (p,), (sgd_ref(p, g, lr=lr),))
        return p
    build.launch("fused_update", "repro_fused_sgd", p.data_ptr(),
                 g.data_ptr(), ptr(active), rows, n, stream_of(p), lr)
    launches += 1
    return p

