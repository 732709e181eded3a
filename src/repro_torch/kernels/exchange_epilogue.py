"""The lossy exchange's fused epilogue and its int8 codec core
(counterpart of ``repro/kernels/exchange_epilogue.py``; DESIGN.md §11).

``codec_mix`` runs one stream's whole replicated exchange in one pass
over the (G, N) buffer: encode and decode of the round delta (int8,
bf16, fp16), the exact G-mean or ``hops`` hops of a (G, G) W with a
re-encode per hop, or top-k's threshold selection with its
error-feedback residual (``thresh``, mean only). ``qdq_int8`` is the
staged int8 codec's quantize+dequantize on (rows, chunk), any chunk.

On a CUDA tensor each launches its kernel of ``csrc/exchange_epilogue.cu``
or raises. ``codec_mix`` takes any G and int8 chunk, as the reference's
does: up to ``MAX_G`` groups at the int8 chunk 256 (and every other kind)
it keeps a column's rows in registers; any other stream runs the
general kernel, which walks the rows one at a time over a scratch of the
grid's windows. On a CPU tensor each takes ``ref.codec_mix_ref`` /
``ref.qdq_int8_ref``. The kernels are written to round like the plain
versions, so the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (build, check_buffer, grid_blocks,
                                 resolve_impl, sm_count, stream_of)
from repro_torch.kernels.ref import codec_mix_ref, qdq_int8_ref

KINDS = ("int8", "bf16", "fp16", "thresh")
MAX_G = 16        # the register kernel keeps all G rows of a column
CHUNK = 256       # its int8 chunk (one block width)
WIDE_SCRATCH = 1 << 26   # floats of the general kernel's scratch, at most

# kernel launches since a count was last set to 0
launches = {"codec_mix": 0, "qdq_int8": 0}
_w_dev: dict = {}   # (device index, W's bytes) -> W on the device


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
    out = torch.empty_like(rows)
    n_rows, chunk = rows.shape
    build.launch("exchange_epilogue", "repro_qdq_int8", rows.data_ptr(),
                 u.data_ptr(), out.data_ptr(), n_rows, chunk,
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
    if out is None:
        out = torch.empty_like(x)
    if kind == "thresh" and residual_out is None:
        residual_out = torch.empty_like(x)
    w_host = (None if w is None else
              np.ascontiguousarray(np.asarray(w, np.float32)))
    ptrs = (x.data_ptr(), x0.data_ptr(), 0 if u is None else u.data_ptr(),
            0 if residual is None else residual.data_ptr(),
            0 if tau is None else tau.data_ptr(), out.data_ptr(),
            0 if residual_out is None else residual_out.data_ptr())
    if g <= MAX_G and (kind != "int8" or chunk == CHUNK):
        build.launch("exchange_epilogue", "repro_codec_mix", *ptrs,
                     None if w_host is None else w_host.ctypes.data, g, n,
                     n_hops, KINDS.index(kind),
                     grid_blocks(dev, -(-n // CHUNK)), stream_of(x))
    else:
        win = chunk if kind == "int8" else CHUNK
        per_block = win if w is None else 2 * g * win
        blocks = min(grid_blocks(dev, -(-n // win)),
                     max(sm_count(dev.index), WIDE_SCRATCH // per_block))
        ws = torch.empty((blocks * per_block,), dtype=torch.float32,
                         device=dev)
        build.launch("exchange_epilogue", "repro_codec_mix_wide", *ptrs,
                     0 if w_host is None else _w_on(dev, w_host).data_ptr(),
                     ws.data_ptr(), g, n, chunk, n_hops, KINDS.index(kind),
                     blocks, stream_of(x))
    launches["codec_mix"] += 1
    return out, (residual_out if kind == "thresh" else None)


def _w_on(dev, w_host):
    """The (G, G) float32 W on ``dev``, copied once per W and device (the
    exchange's W is fixed for its lifetime)."""
    key = (dev.index, w_host.shape, w_host.tobytes())
    w_dev = _w_dev.get(key)
    if w_dev is None:
        if len(_w_dev) >= 16:
            _w_dev.clear()
        w_dev = _w_dev[key] = torch.from_numpy(w_host.copy()).to(dev)
    return w_dev
