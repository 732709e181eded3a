#!/usr/bin/env python3
"""Times the port's ``paged_decode_attention`` and ``mamba_chunk`` kernels
of one checkout on the GPU, at ``chip_smoke.py``'s timed shapes, with its
timing and its tolerances, and holds each against its plain version.

    python3 tools/torch_decode_mamba_ab.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is timed (default: this checkout's), so that two trees can be compared on
one card in turns (parent, change, change, parent), one process each.
Each result is one JSON line on stdout with the card's name and power
limit: ``ms`` is the call's time (the ``kernels`` line's measure),
``device_ms`` the device's alone (``chip_smoke.time_ms``), ``bound_ms``
the least time the card could take (``chip_smoke``'s bounds; for
``mamba_chunk`` its design's, with the 3xTF32 and float32 operation
bounds beside it). Decode is checked bit-equal on a rerun. The first
line gives the registers and spills of both kernels' builds. Needs one
CUDA GPU; exits 1 without.
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
        print("torch_decode_mamba_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mamba_scan as ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    src = os.path.abspath(args.src)
    if not all(m.__file__.startswith(src) for m in (build, da, ms)):
        raise RuntimeError(f"repro_torch was not imported from {src}")
    build.load_all()

    def emit(**rec):
        print(json.dumps(dict(tag=args.tag, card=card, **rec)), flush=True)

    emit(build={stem: [line.split(":", 1)[-1].strip()
                       for line in build.build_log(stem).splitlines()
                       if "registers" in line or "spill" in line]
                for stem in ("decode_attention", "mamba_scan")})
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, kw, lengths in cs.decode_timed(torch):
        t = cs.decode_times(torch, da, gen, kw, lengths)
        emit(kernel="paged_decode_attention", shape=name, geometry=kw,
             ms=t["ms"], device_ms=t["device_ms"], bound_ms=t["bound"][0],
             bound_by=t["bound"][1], max_abs_err=t["err"])
        torch.cuda.empty_cache()
    for xdtype in (None, torch.bfloat16):
        inputs = cs._mamba_inputs(torch, gen, cs.MAMBA_FULL, xdtype=xdtype)

        def run(impl="cuda"):
            return ms.mamba_chunk(*inputs, impl=impl)
        ys = cs.MAMBA_YS if xdtype is None else dict(rtol=2.0 ** -7,
                                                     atol=1e-4)
        err = cs._mamba_compare(torch, "timed", run(), run("torch"), ys)
        bound, by = cs._mamba_bound(*cs.MAMBA_FULL)
        emit(kernel="mamba_chunk", shape=cs.MAMBA_FULL,
             dtype=str(inputs[0].dtype), ms=cs.time_ms(run, torch),
             device_ms=cs.time_ms(run, torch, device_only=True),
             bound_ms=bound, bound_by=by,
             tf32_ops_ms=3 * cs._mamba_ops(*cs.MAMBA_FULL)
             / cs.TF32_OPS_PER_S * 1e3,
             f32_bound_ms=cs._mamba_bound(*cs.MAMBA_FULL,
                                          tensor_cores=False)[0],
             max_abs_err=err)
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
