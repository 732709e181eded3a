#!/usr/bin/env python3
"""Times the port's ``rmsnorm`` and ``flash_attention`` kernels of one
checkout on the GPU, beside the one PyTorch call that computes the same
function, at ``chip_smoke.py``'s shapes, with its timing and its
tolerances, and holds each against its plain version.

    python3 benchmarks/torch_kernel_ab.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is timed (default: this checkout's), so that two trees can be compared on
one card in turns (parent, change, change, parent), one process each.
Each result is one JSON line on stdout with the card's name and power
limit: ``ms`` and ``library_ms`` are the call's time, ``device_ms`` and
``library_device_ms`` the device's alone
(``chip_smoke.call_and_device_ms``). Needs one CUDA GPU; exits 1
without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    src = os.path.abspath(args.src)
    if not all(m.__file__.startswith(src) for m in (build, fa, rn)):
        raise RuntimeError(f"repro_torch was not imported from {src}")
    build.load_all()

    def emit(**rec):
        print(json.dumps(dict(tag=args.tag, card=card, **rec)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (rows, d), dt in [(s, torch.float32)
                          for s in cs.RMS_FULL + cs.RMS_WIDE] + [
            (s, torch.bfloat16) for s in cs.RMS_BF16]:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(dt)
        w = torch.randn((d,), generator=gen, device="cuda") + 1.0
        err = cs.compare(f"rmsnorm ({rows}, {d}) {dt}",
                         rn.rmsnorm(x, w, impl="cuda").float(),
                         rn.rmsnorm(x, w, impl="torch").float(),
                         **(cs.RMS_F32 if dt == torch.float32
                            else cs.BF16_STEP))
        t = cs.call_and_device_ms(
            torch, lambda: rn.rmsnorm(x, w, impl="cuda"),
            lambda: torch.nn.functional.rms_norm(x, (d,), w.to(dt), 1e-5))
        emit(kernel="rmsnorm", shape=[rows, d], dtype=str(dt),
             max_abs_err=err, **t)
        del x, w
    for shape in cs.FLASH_TIMED:
        q, k, v, t = cs._flash_times(torch, fa, shape, gen)
        err = cs.compare(f"flash_attention {shape}",
                         fa.flash_attention(q, k, v, impl="cuda").double(),
                         ref.flash_attention_ref(q.double(), k.double(),
                                                 v.double()), **cs.ATTN_TOL)
        emit(kernel="flash_attention", shape=list(shape), dtype="float32",
             max_abs_err=err, bound_ms=t.pop("bound")[0],
             f32_bound_ms=t.pop("f32_bound")[0], **t)
        del q, k, v
        torch.cuda.empty_cache()
    # bfloat16 at paper-lenet's prefill
    q, k, v = (torch.randn(cs.FLASH_TIMED[0][:2] + cs.FLASH_TIMED[0][3:],
                           generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    err = cs.compare("flash_attention bf16",
                     fa.flash_attention(q, k, v, impl="cuda").float(),
                     fa.flash_attention(q.float(), k.float(), v.float(),
                                        impl="torch").to(q.dtype).float(),
                     **cs.BF16_STEP)
    t = cs.call_and_device_ms(
        torch, lambda: fa.flash_attention(q, k, v, impl="cuda"),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    emit(kernel="flash_attention", shape=list(cs.FLASH_TIMED[0]),
         dtype="bfloat16", max_abs_err=err, **t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
