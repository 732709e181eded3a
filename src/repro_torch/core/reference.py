"""Host-side driver of Alg 1 on analytic (convex) problems (counterpart of
``repro/core/reference.py``): the paper-figure problems of
``data/convex.py``.

Each node's local GD steps run as a loop of PyTorch ops on ``device``
(the reference runs them inside one jitted ``lax.scan`` /
``lax.while_loop``), with gradients from autograd. A fixed-T run reads
nothing back to the host until the round ends. The threshold (T_i = inf)
run reads its stopping test on the host after every step.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def grad_of(f: Callable) -> Callable:
    """w -> grad f(w), by autograd on a detached copy of ``w``."""
    def g(w):
        with torch.enable_grad():
            wr = w.detach().requires_grad_()
            return torch.autograd.grad(f(wr), wr)[0]

    return g


def _sq(g):
    return torch.sum(g ** 2)


def make_local_T(f: Callable, lr: float, T: int):
    """w -> (w_T, gsq_traj (T,)) after T local GD steps."""
    g = grad_of(f)

    def run(w):
        traj = []
        for _ in range(T):
            gi = g(w)
            traj.append(_sq(gi))
            w = w - lr * gi
        return w, torch.stack(traj)

    return run


def make_local_threshold(f: Callable, lr: float, eps: float,
                         max_inner: int):
    """w -> (w_out, steps): local GD until ||grad||^2 <= eps (T_i = inf),
    the test made on the gradient at the new iterate after each step, as
    the reference's ``while_loop`` makes it."""
    g = grad_of(f)

    def run(w):
        gi = g(w)
        n = 0
        # the comparison runs in float32 on the device, as the reference's
        while n < max_inner and bool(_sq(gi) > eps):
            w = w - lr * gi
            gi = g(w)
            n += 1
        return w, n

    return run


def run_alg1(losses: List[Callable], w0, lr: float, T: Optional[int],
             rounds: int, threshold: Optional[float] = None,
             max_inner: int = 100_000, record_local_traj: bool = False,
             stop_below: Optional[float] = None, device="cuda") -> dict:
    """Model averaging (paper Alg 1) on a list of local losses (torch
    functions of a 1-D float32 tensor on ``device``).

    T=None + threshold=eps -> the paper's T_i = infinity mode. Returns per-round
    global ||grad f||^2 and f values (Python floats), inner-step counts,
    the final iterate (a tensor on ``device``), and node 0's local gsq
    trajectory if requested."""
    if threshold is not None:
        runners = [make_local_threshold(f, lr, threshold, max_inner)
                   for f in losses]
    else:
        runners = [make_local_T(f, lr, T) for f in losses]
    grads = [grad_of(f) for f in losses]

    w = torch.as_tensor(w0, dtype=torch.float32, device=device)
    gsq, fvals, inner, local_traj = [], [], [], []
    for _ in range(rounds):
        locals_, counts = [], []
        for i, run in enumerate(runners):
            if threshold is not None:
                wi, n = run(w)
                counts.append(n)
            else:
                wi, traj = run(w)
                counts.append(T)
                if record_local_traj and i == 0:
                    local_traj.append(traj)
            locals_.append(wi)
        w = torch.mean(torch.stack(locals_), dim=0)
        g_glob = torch.mean(torch.stack([g(w) for g in grads]), dim=0)
        gsq.append(_sq(g_glob))
        with torch.no_grad():
            fvals.append(torch.stack([f(w) for f in losses]))
        inner.append(counts)
        if stop_below is not None and float(gsq[-1]) <= stop_below:
            break
    # one read at the end; f is the float32 mean over nodes taken by numpy
    # on the host, as the reference takes it
    gsq = [float(v) for v in torch.stack(gsq).cpu()]
    fs = [float(np.mean(row)) for row in torch.stack(fvals).cpu().numpy()]
    if local_traj:
        local_traj = torch.cat(local_traj).cpu().tolist()
    return {"gsq": gsq, "f": fs, "inner": inner, "w": w,
            "local_traj": local_traj}


def rounds_to(gsq_list, tol) -> Optional[int]:
    for i, g in enumerate(gsq_list):
        if g <= tol:
            return i + 1
    return None
