"""The lossy exchange's fused epilogue and its int8 codec core
(counterpart of ``repro/kernels/exchange_epilogue.py``; DESIGN.md §11).

``codec_mix`` runs one stream's whole replicated exchange in one pass
over the (G, N) buffer: encode and decode of the round delta (int8,
bf16, fp16), the exact G-mean or ``hops`` hops of a (G, G) W with a
re-encode per hop, or top-k's threshold selection with its
error-feedback residual (``thresh``, mean only). ``qdq_int8`` is the
staged int8 codec's quantize+dequantize on (rows, 256).

On a CUDA tensor each launches its kernel of ``csrc/exchange_epilogue.cu``
(``codec_mix`` takes at most ``MAX_G`` groups and the int8 chunk 256;
``qdq_int8`` rows of 256) or raises; on a CPU tensor it takes
``ref.codec_mix_ref`` / ``ref.qdq_int8_ref``. The kernels are written to
round like the plain versions, so the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (build, check_buffer, grid_blocks,
                                 resolve_impl, stream_of)
from repro_torch.kernels.ref import codec_mix_ref, qdq_int8_ref

KINDS = ("int8", "bf16", "fp16", "thresh")
MAX_G = 16        # the kernel keeps all G rows of a column in registers
CHUNK = 256       # the int8 chunk the kernels take (one block width)

# kernel launches since a count was last set to 0
launches = {"codec_mix": 0, "qdq_int8": 0}


def qdq_int8(rows, u, *, impl="auto"):
    """(rows, chunk) float32 + noise in [0, 1) of the same shape -> the
    decoded (rows, chunk) float32 (a new tensor)."""
    if rows.dim() != 2:
        raise ValueError(f"qdq_int8: expected (rows, chunk), got "
                         f"{tuple(rows.shape)}")
    check_buffer("qdq_int8", rows, rows.shape, rows.device)
    check_buffer("qdq_int8", u, rows.shape, rows.device)
    if resolve_impl(impl, rows.device) == "torch":
        return qdq_int8_ref(rows, u)
    if rows.shape[1] != CHUNK:
        raise ValueError(f"qdq_int8: the kernel takes rows of {CHUNK}, got "
                         f"{rows.shape[1]}")
    if rows.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("qdq_int8: the kernel reads float4: buffers must "
                         "be 16-byte aligned")
    out = torch.empty_like(rows)
    n_rows = rows.shape[0]
    build.launch("exchange_epilogue", "repro_qdq_int8", rows.data_ptr(),
                 u.data_ptr(), out.data_ptr(), n_rows,
                 grid_blocks(rows.device, -(-n_rows // 8)), stream_of(rows))
    launches["qdq_int8"] += 1
    return out


def codec_mix(x, x0, *, kind, u=None, w=None, hops=1, chunk=0,
              residual=None, tau=None, out=None, residual_out=None,
              impl="auto"):
    """One stream's fused exchange epilogue over (G, N) float32 ``x``
    (the round's result) against ``x0`` (the round start). Returns
    ``(mixed, residual_out)``, residual_out None except for thresh.

    ``u``: (hops, G*ceil(N/chunk), chunk) int8 noise, one slice per hop
    (one on the mean); ``w``: the (G, G) mixing matrix (None = the exact
    mean, which always runs one hop); ``residual``: (G, N) and ``tau``:
    (G, 1) for thresh. ``out`` / ``residual_out`` receive the results
    (they may be ``x`` / ``residual`` themselves: the kernel reads every
    value of a column before it writes one); new tensors when None."""
    if kind not in KINDS:
        raise ValueError(f"codec_mix: unknown kind {kind!r} (have {KINDS})")
    if x.dim() != 2:
        raise ValueError(f"codec_mix: expected (G, N) buffers, got "
                         f"{tuple(x.shape)}")
    g, n = x.shape
    dev = x.device
    for t in (x0, out, residual, residual_out):
        if t is not None:
            check_buffer("codec_mix", t, x.shape, dev)
    check_buffer("codec_mix", x, x.shape, dev)
    n_hops = hops if w is not None else 1
    if kind == "thresh":
        if w is not None or residual is None or tau is None:
            raise ValueError("codec_mix: thresh takes mean mixing only, "
                             "with a residual and a (G, 1) tau")
        check_buffer("codec_mix tau", tau, (g, 1), dev)
    if kind == "int8":
        if u is None or chunk <= 0:
            raise ValueError("codec_mix: int8 needs the noise u and chunk")
        check_buffer("codec_mix u", u, (n_hops, g * -(-n // chunk), chunk),
                     dev)
    if w is not None and (np.shape(w) != (g, g) or hops < 1):
        raise ValueError(f"codec_mix: w must be ({g}, {g}) and hops >= 1")
    if resolve_impl(impl, dev) == "torch":
        w_t = (None if w is None else
               torch.as_tensor(np.asarray(w, np.float32), device=dev))
        mixed, res = codec_mix_ref(x, x0, kind=kind, u=u, w=w_t, hops=hops,
                                   chunk=chunk, residual=residual, tau=tau)
        if out is not None:
            mixed = out.copy_(mixed)
        if residual_out is not None and res is not None:
            res = residual_out.copy_(res)
        return mixed, res
    if g > MAX_G:
        raise ValueError(f"codec_mix: the kernel takes at most {MAX_G} "
                         f"groups, got {g}")
    if kind == "int8" and chunk != CHUNK:
        raise ValueError(f"codec_mix: the kernel takes the int8 chunk "
                         f"{CHUNK}, got {chunk}")
    if out is None:
        out = torch.empty_like(x)
    if kind == "thresh" and residual_out is None:
        residual_out = torch.empty_like(x)
    w_host = (None if w is None else
              np.ascontiguousarray(np.asarray(w, np.float32)))
    nchunks = -(-n // CHUNK)
    build.launch("exchange_epilogue", "repro_codec_mix", x.data_ptr(),
                 x0.data_ptr(), 0 if u is None else u.data_ptr(),
                 0 if residual is None else residual.data_ptr(),
                 0 if tau is None else tau.data_ptr(), out.data_ptr(),
                 0 if residual_out is None else residual_out.data_ptr(),
                 None if w_host is None else w_host.ctypes.data, g, n,
                 n_hops, KINDS.index(kind), grid_blocks(dev, nchunks),
                 stream_of(x))
    launches["codec_mix"] += 1
    return out, (residual_out if kind == "thresh" else None)
