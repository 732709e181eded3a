"""Kernel dispatch for the port (counterpart of ``repro/kernels/__init__.py``).

Every kernel module fronts one CUDA C++ kernel (``csrc/``) with a plain
PyTorch version (``ref.py``). ``resolve_impl`` is the single decision
point: ``"auto"`` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor; an explicit ``"cuda"`` on a CPU tensor
raises. ``"torch"`` is allowed on either device, for comparisons. There
is no silent fallback: a CUDA tensor under ``"auto"`` or ``"cuda"``
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

IMPLS = ("auto", "torch", "cuda")
MAX_ROWS = 65535      # CUDA's limit on gridDim.y, which indexes the rows


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"cuda"`` (launch the kernel) or ``"torch"`` (plain version)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (have {IMPLS})")
    if not isinstance(device, torch.device):
        device = torch.device(device)
    on_cuda = device.type == "cuda"
    if impl == "auto":
        return "cuda" if on_cuda else "torch"
    if impl == "cuda" and not on_cuda:
        raise ValueError(
            f"impl='cuda' launches a CUDA kernel, but the tensor is on "
            f"{torch.device(device)} — move it to a CUDA device, or pass "
            "impl='torch' (the plain version) or impl='auto'")
    return impl


def check_rows(name: str, *tensors: torch.Tensor) -> tuple:
    """Validate the (G, N) f32 buffers of one kernel call: same shape,
    same device, contiguous, and one shared alignment (the kernels read
    16-byte vectors from the same element offsets of every buffer).
    Returns (G, N)."""
    x = tensors[0]
    shape, device = x.shape, x.device
    if len(shape) != 2:
        raise ValueError(f"{name}: expected (G, N) buffers, got {tuple(shape)}")
    for t in tensors:
        if t.dtype is not torch.float32 or t.shape != shape or \
                not t.is_contiguous() or (t is not x and t.device != device):
            _bad_buffer(name, t, shape, device)
    if len(tensors) > 1 and device.type == "cuda":
        grain = x.data_ptr() % 16
        if any(t.data_ptr() % 16 != grain for t in tensors):
            raise ValueError(
                f"{name}: buffers must share one 16-byte alignment")
    if shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: at most {MAX_ROWS} rows (one grid row each)")
    return shape[0], shape[1]


def _bad_buffer(name, t, shape, device):
    """Raise for a buffer ``check_rows`` refuses, saying why."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    raise ValueError(f"{name}: buffers must be contiguous")


def check_buffer(name: str, t, shape, device, dtype=torch.float32) -> None:
    """Validate one buffer of a kernel call: its dtype, shape and device,
    and that it is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: buffers must be contiguous")


def check_active(name: str, active, rows: int, device: torch.device) -> None:
    if active is None:
        return
    if active.dtype != torch.bool or active.shape != (rows,):
        raise ValueError(f"{name}: active must be a ({rows},) bool tensor, "
                         f"got {active.dtype} {tuple(active.shape)}")
    if active.device != device or not active.is_contiguous():
        raise ValueError(f"{name}: active must be contiguous on {device}")


def assign_rows(active, outs, news) -> None:
    """Plain-version epilogue of the in-place kernels: copy each new value
    into its buffer, on the active rows only."""
    for out, new in zip(outs, news):
        out.copy_(new if active is None
                  else torch.where(active[:, None], new, out))


def ptr(t) -> int:
    """Device pointer for a launcher; 0 (NULL) for an absent tensor."""
    return 0 if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def blocks_per_row(x: torch.Tensor, per_sm: int = 8) -> int:
    """Grid width of one row for the streaming kernels: enough 256-thread
    blocks over all rows to keep ``per_sm`` blocks resident on every SM,
    and never more than one float4 per thread."""
    rows, n = x.shape
    want = -(-sm_count(x.device.index) * per_sm // max(rows, 1))
    return max(1, min(want, -(-n // (4 * 256))))


def grid_blocks(device: torch.device, units: int) -> int:
    """Blocks of a grid-stride launch over ``units`` pieces of work: 8
    resident on every SM, at most one per unit."""
    return max(1, min(units, sm_count(device.index) * 8))


def stream_of(x: torch.Tensor) -> int:
    """Handle of the current stream on ``x``'s device, for a launcher
    (``torch._C._cuda_getCurrentRawStream``, the handle alone, which
    ``torch.cuda.current_stream`` wraps in a Stream object first)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)
