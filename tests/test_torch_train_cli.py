"""The port's launcher, as a user runs it: on the CPU when asked, and a
clear refusal (naming CUDA) when it defaults to the card and there is
none. Decides nothing at import time: whether CUDA exists is read inside
the test."""
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
TREE_CMD = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "paper-mlp", "--reduced", "--rounds", "2", "--groups", "2",
            "--t-inner", "2", "--seq", "32"]
CMD = TREE_CMD + ["--packed"]


def _run(args, cmd=CMD, **env_extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env_extra)
    return subprocess.run(cmd + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_runs_on_cpu_when_asked():
    out = _run(["--device", "cpu", "--opt", "adamw", "--t-i", "1,2"])
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines() if l.startswith("round ")]
    assert len(rounds) == 2
    assert "T 2" in rounds[0] and "wire " in rounds[0]
    assert "comm server/fp32" in out.stdout


def test_cli_defaults_to_cuda_and_refuses_without_it():
    out = _run([])
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
    else:
        assert out.returncode != 0
        assert "CUDA" in out.stderr
        assert "round " not in out.stdout


def test_cli_refuses_flags_outside_the_slice():
    for extra in (["--adaptive-t", "online"], ["--comm", "push_sum"],
                  ["--overlap"], ["--trace", "x.jsonl"]):
        out = _run(["--device", "cpu"] + extra)
        assert out.returncode != 0
        assert "not ported yet" in out.stderr, (extra, out.stderr)
    out = _run(["--device", "cpu", "--comm", "push_sum"])
    assert "push_sum" in out.stderr and "Queue A item 4" in out.stderr
    # the pytree round: int8 needs the flat buffer (the reference refuses
    # it too); fp16 on the tree path is not ported yet
    out = _run(["--device", "cpu", "--codec", "int8"], TREE_CMD)
    assert out.returncode != 0 and "packed" in out.stderr, out.stderr
    out = _run(["--device", "cpu", "--codec", "fp16"], TREE_CMD)
    assert out.returncode != 0 and "Queue A item 1b" in out.stderr
    out = _run(["--device", "cpu", "--impl", "torch"], TREE_CMD)
    assert out.returncode != 0 and "add --packed" in out.stderr
    out = _run(["--device", "cpu", "--mode", "sync", "--comm", "ring"])
    assert out.returncode != 0 and "no exchange" in out.stderr


def _lines(out, head):
    assert out.returncode == 0, out.stderr
    return [l for l in out.stdout.splitlines() if l.startswith(head)]


def test_cli_runs_sync_mode_on_cpu():
    """--mode sync: the packed step (fused update, sq_norm) and the
    pytree step, on the global batch of groups x per-group sequences."""
    for cmd, kind in ((CMD, "packed"), (TREE_CMD, "pytree")):
        out = _run(["--device", "cpu", "--mode", "sync", "--opt", "adamw",
                    "--lr", "1e-3"], cmd)
        steps = _lines(out, "step ")
        assert len(steps) == 2 and "gsq" in steps[0]
        assert f"mode=sync {kind}" in out.stdout


def test_cli_runs_threshold_on_the_pytree_round():
    """--threshold without --packed: T_i = inf, at most 500 steps a group
    (the reference launcher's max_inner). One intra-op thread: the run is
    ~200 steps of small ops, whose parallel regions stall for a scheduler
    slice each when the machine is loaded (as under the parallel suite)."""
    out = _run(["--device", "cpu", "--threshold", "1e-1"], TREE_CMD,
               OMP_NUM_THREADS="1")
    rounds = _lines(out, "round ")
    assert len(rounds) == 2 and "mode=localsgd pytree" in out.stdout
    steps = [int(l.split(" T ")[1].split()[0]) for l in rounds]
    assert all(1 < t <= 500 for t in steps), steps
    out = _run(["--device", "cpu", "--threshold", "1e-1"])
    assert out.returncode != 0 and "pytree path" in out.stderr


def test_cli_adaptive_t_changes_t():
    """--adaptive-t (static): the round after the first runs the T the
    controller fitted from the first round's trajectory (4 -> 16 here)."""
    out = _run(["--device", "cpu", "--adaptive-t", "--t-inner", "4"])
    rounds = _lines(out, "round ")
    steps = [int(l.split(" T ")[1].split()[0]) for l in rounds]
    assert steps[0] == 4 and steps[1] != 4, steps


def test_cli_runs_lossy_exchanges_on_cpu():
    """The lossy exchange flags: ring int8 at two hops over 4 groups,
    async_stale with int8z moments and an int8 downlink; a downlink codec
    on the ring is refused with the reference's reason."""
    out = _run(["--device", "cpu", "--comm", "ring", "--codec", "int8",
                "--mix-rounds", "2", "--groups", "4"])
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines() if l.startswith("round ")]
    assert len(rounds) == 2
    assert "comm ring/int8" in out.stdout
    out = _run(["--device", "cpu", "--comm", "async_stale", "--codec",
                "int8", "--opt", "adamw", "--lr", "1e-3", "--moment-codec",
                "int8z", "--downlink-codec", "int8", "--staleness", "1"])
    assert out.returncode == 0, out.stderr
    assert "comm async_stale/int8" in out.stdout
    out = _run(["--device", "cpu", "--comm", "ring", "--downlink-codec",
                "int8"])
    assert out.returncode != 0 and "no separate downlink" in out.stderr


def test_checkpoint_hands_off_to_the_serve_launcher(tmp_path):
    """--checkpoint saves the averaged server params with the reference's
    metadata; the serve launcher restores them on the CPU and passes its
    parity check (each request replayed alone gives the same tokens)."""
    import json

    import numpy as np

    path = str(tmp_path / "ck")
    out = _run(["--device", "cpu", "--checkpoint", path])
    assert out.returncode == 0, out.stderr
    assert f"checkpoint -> {path}.npz" in out.stdout
    with open(path + ".json") as f:
        assert json.load(f) == {"arch": "paper-mlp-reduced", "rounds": 2,
                                "mode": "localsgd"}
    with np.load(path + ".npz") as data:
        keys = list(data.keys())
    assert keys == sorted(keys) and "blocks/attn/wq" in keys
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "paper-mlp", "--reduced", "--from-checkpoint", path,
         "--requests", "4", "--check-parity"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr
    assert f"params <- {path}.npz" in serve.stdout
    assert "4 requests" in serve.stdout
    assert "parity OK: 4 requests identical" in serve.stdout


def test_serve_cli_defaults_to_cuda_and_refuses_unported_archs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def serve(args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "paper-mlp", "--reduced", "--requests", "2"] + args,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)

    out = serve([])
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
    else:
        assert out.returncode != 0 and "CUDA" in out.stderr
        assert "requests" not in out.stdout
    out = serve(["--device", "cpu", "--arch", "qwen3-32b"])
    assert out.returncode != 0 and "not ported yet" in out.stderr
