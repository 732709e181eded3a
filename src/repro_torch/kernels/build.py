"""Build the CUDA C++ kernels of ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<stem>.cu`` exposes ``extern "C"`` launchers that take raw
device pointers, sizes, scalars and a stream, launch on that stream, and
return ``cudaGetLastError()``. Each source is compiled on its own into
``_build/<stem>-<hash>.so`` for ``sm_90a`` (Hopper); the hash covers the
source text, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header gets a fresh build and a stale library is never
loaded. At first use every missing library is compiled at once, one nvcc
process per source, and nothing is built when a module is imported.
``_build/`` lies inside the package and is listed in ``.gitignore``.

Several processes may share ``_build/`` (the ranks of a sharded run; the
launcher and ``chip_smoke.py`` build every library before they start
them). The lock below guards one process's threads only, so each build
writes its library and its log under names of its own (the process id)
and ``os.replace`` moves them into place: no process ever loads a
half-written library, and two concurrent builds of one source both
leave a whole one.

No ``--use_fast_math``: the kernels keep IEEE division and square root so
that they agree with the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# launcher name -> argtypes, per source. Pointers and the stream are
# c_void_p (a plain int would be cut to 32 bits), sizes c_int64.
SIGNATURES = {
    "fused_update": {
        # p, g, active, rows, n, stream, lr
        "repro_fused_sgd": (_P, _P, _P, _I64, _I64, _P, _F),
        # p, g, mu, active, rows, n, blocks, stream, lr, beta
        "repro_fused_momentum": (_P, _P, _P, _P, _I64, _I64, _I64, _P,
                                 _F, _F),
        # p, g, m, v, bc, active, rows, n, blocks, stream,
        # lr, b1, 1-b1, b2, 1-b2, eps, wd
        "repro_fused_adamw": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P,
                              _F, _F, _F, _F, _F, _F, _F),
    },
    "exchange_epilogue": {
        # x, x0, u, res, tau, out, res_out, w (host), g, n, hops, kind,
        # blocks, stream
        "repro_codec_mix": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                            _I64, _I64, _I64, _P),
        # x, x0, u, res, tau, out, res_out, w (device), ws, g, n, chunk,
        # hops, kind, blocks, stream
        "repro_codec_mix_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                 _I64, _I64, _I64, _I64, _I64, _P),
        # x, u, out, rows, chunk, blocks, stream
        "repro_qdq_int8": (_P, _P, _P, _I64, _I64, _I64, _P),
    },
    "decode_attention": {
        # q, pool, rows_k, rows_v, lengths, out, partials, tickets, B, n_kv,
        # g, hd, page_size, nblk, page_elems, pages a span, stream, scale
        "repro_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P,
                                         _I64, _I64, _I64, _I64, _I64, _I64,
                                         _I64, _I64, _P, _F),
    },
    "flash_attention": {
        # q, k, v, out, B, H, KV, S, hd, bf16, stream, scale
        "repro_flash_attention": (_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                  _I64, _I64, _P, _F),
    },
    "sq_norm": {
        # x, partials, tickets, out, rows, n, capacity, stream
        "repro_sq_norm_groups": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    },
    "rmsnorm": {
        # x, w, out, rows, d, bf16, tpr, nv, threads, stream, eps
        "repro_rmsnorm": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                          _P, _F),
    },
    "quantize": {
        # x, u, q, scales, rows, chunk, blocks, stream
        "repro_quantize_int8": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
        # q, scales, out, rows, chunk, blocks, stream
        "repro_dequantize_int8": (_P, _P, _P, _I64, _I64, _I64, _P),
    },
    "mamba_scan": {
        # xh, bmat, cmat, dt, a, y, states, decay, cum, B*c, L, H, N, P,
        # bf16, stream
        "repro_mamba_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                              _I64, _I64, _I64, _I64, _P),
    },
}

_lock = threading.Lock()
_libs: dict = {}
_bound: dict = {}     # (stem, name) -> launcher, bound at first use


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under the CUDA
    toolkit PyTorch was pointed at (``CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of repro_torch are compiled at first use and need the "
        "CUDA toolkit")


def library_path(stem: str) -> Path:
    """The library of ``csrc/<stem>.cu``, named by a hash of its source,
    the headers of ``csrc/`` (which a source may include) and the flags."""
    text = b"".join(p.read_bytes() for p in [CSRC / f"{stem}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    text += " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{stem}-{hashlib.sha256(text).hexdigest()[:16]}.so"


def nvcc_command(stem: str, out: Path) -> list:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{stem}.cu")]


def build_log(stem: str) -> str:
    """nvcc's output (ptxas registers and spills) of the current build."""
    log = library_path(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile_all(stems) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for stem in stems:
        out = library_path(stem)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        tmp_log = tmp.with_suffix(".log")
        log = open(tmp_log, "w")
        proc = subprocess.Popen(nvcc_command(stem, tmp), stdout=log,
                                stderr=subprocess.STDOUT)
        jobs.append((stem, proc, tmp, out, log, tmp_log))
    failed = []
    for stem, proc, tmp, out, log, tmp_log in jobs:
        rc = proc.wait()
        log.close()
        # atomic: readers never see half a file
        os.replace(tmp_log, out.with_suffix(".log"))
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{stem}.cu (nvcc exit {rc}):\n{build_log(stem)}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def load_all() -> dict:
    """Build (where needed) and load every kernel library -> {stem: CDLL}."""
    with _lock:
        if not _libs:
            stems = sorted(SIGNATURES)
            _compile_all([s for s in stems if not library_path(s).exists()])
            for stem in stems:
                lib = ctypes.CDLL(str(library_path(stem)))
                for name, argtypes in SIGNATURES[stem].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fn.errcheck = _raise_on_error
                _libs[stem] = lib
        return _libs


def _raise_on_error(err, fn, _args):
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: cudaError_t {err}")


def launcher(stem: str, name: str):
    """The ctypes function of one launcher, which raises if it reports a
    CUDA error. Bound once (the libraries are built and loaded at the
    first call); later calls are one dict lookup."""
    fn = _bound.get((stem, name))
    if fn is None:
        fn = _bound[stem, name] = getattr(load_all()[stem], name)
    return fn


def launch(stem: str, name: str, *args) -> None:
    """Call one launcher; raise if it reports a CUDA error."""
    launcher(stem, name)(*args)
