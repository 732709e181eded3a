"""The port's launcher, as a user runs it: on the CPU when asked, and a
clear refusal (naming CUDA) when it defaults to the card and there is
none. Decides nothing at import time: whether CUDA exists is read inside
the test. The runs call the launchers' ``main`` in this process; a new
interpreter runs only where a fresh one is the point (the default device
read at start-up)."""
import math
import os
import subprocess
import sys
import types

import pytest
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


def test_cli_runs_on_cpu_when_asked(capsys):
    out = _inproc(["--device", "cpu", "--opt", "adamw", "--t-i", "1,2"],
                  capsys)
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


def _main(args, capsys, cmd=CMD, launcher="train"):
    """A launcher's ``main`` in this process (its refusals and small CPU
    runs, without a new interpreter each): (exit code, stdout, stderr).
    One intra-op thread: the runs are many small ops, whose parallel
    regions stall for a scheduler slice each when the machine is loaded
    (as under the parallel suite)."""
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{launcher}").main
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(cmd[3:] + args)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr()
    return code, out.out, out.err


def _inproc(args, capsys, cmd=CMD, launcher="train"):
    """``_main`` as ``_run``'s result: returncode, stdout, stderr."""
    code, out, err = _main(args, capsys, cmd, launcher)
    return types.SimpleNamespace(returncode=code, stdout=out, stderr=err)


def test_cli_refuses_flags_outside_the_slice(capsys):
    # --trace, --profile and --adaptive-t online run since the telemetry
    # slice (tests/test_torch_obs.py); --shard since the sharding slice
    # (tests/test_torch_shard_launch.py), with every exchange but a
    # downlink codec, and not off the packed round
    code, _, err = _main(["--device", "cpu", "--shard", "2",
                          "--downlink-codec", "bf16"], capsys)
    assert code != 0 and "downlink_codec" in err
    code, _, err = _main(["--device", "cpu", "--shard", "2"], capsys,
                         TREE_CMD)
    assert code != 0 and "needs --packed" in err
    code, _, err = _main(["--device", "cpu", "--hop-impl", "bogus"], capsys)
    assert code != 0 and "--hop-impl" in err
    # the pytree round: overlap and int8 need the flat buffer (the
    # reference refuses them too); push_sum, faults and fp16 run there
    # (test_cli_runs_the_exchanges_on_the_pytree_round)
    code, _, err = _main(["--device", "cpu", "--overlap"], capsys, TREE_CMD)
    assert code != 0 and "add --packed" in err
    for extra in (["--codec", "int8"], ["--moment-codec", "int8z"],
                  ["--codec", "topk"]):
        code, _, err = _main(["--device", "cpu"] + extra, capsys, TREE_CMD)
        assert code != 0 and "packed" in err, err
    code, _, err = _main(["--device", "cpu", "--impl", "torch"], capsys,
                         TREE_CMD)
    assert code != 0 and "add --packed" in err
    code, _, err = _main(["--device", "cpu", "--mode", "sync", "--comm",
                          "ring"], capsys)
    assert code != 0 and "no exchange" in err


def _lines(out, head):
    assert out.returncode == 0, out.stderr
    return [l for l in out.stdout.splitlines() if l.startswith(head)]


def test_cli_runs_sync_mode_on_cpu(capsys):
    """--mode sync: the packed step (fused update, sq_norm) and the
    pytree step, on the global batch of groups x per-group sequences."""
    for cmd, kind in ((CMD, "packed"), (TREE_CMD, "pytree")):
        out = _inproc(["--device", "cpu", "--mode", "sync", "--opt",
                       "adamw", "--lr", "1e-3"], capsys, cmd)
        steps = _lines(out, "step ")
        assert len(steps) == 2 and "gsq" in steps[0]
        assert f"mode=sync {kind}" in out.stdout


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-base"])
def test_cli_runs_the_vlm_and_audio_archs(arch, capsys):
    """The vlm and audio reductions, their patch or frame embeddings
    beside every batch's tokens: the packed round, the pytree round and
    --mode sync, each with finite losses."""
    for cmd, extra, head in ((CMD, [], "round "), (TREE_CMD, [], "round "),
                             (CMD, ["--mode", "sync"], "step ")):
        out = _inproc(["--device", "cpu", "--arch", arch] + extra, capsys,
                      cmd)
        assert out.returncode == 0, out.stderr
        assert f"arch={arch}-reduced" in out.stdout
        lines = _lines(out, head)
        assert len(lines) == 2, out.stdout
        assert all(math.isfinite(float(l.split(" loss ")[1].split()[0]))
                   for l in lines), lines


def test_cli_runs_threshold_on_the_pytree_round(capsys):
    """--threshold without --packed: T_i = inf, at most 500 steps a group
    (the reference launcher's max_inner)."""
    out = _inproc(["--device", "cpu", "--threshold", "1e-1"], capsys,
                  TREE_CMD)
    rounds = _lines(out, "round ")
    assert len(rounds) == 2 and "mode=localsgd pytree" in out.stdout
    steps = [int(l.split(" T ")[1].split()[0]) for l in rounds]
    assert all(1 < t <= 500 for t in steps), steps
    out = _inproc(["--device", "cpu", "--threshold", "1e-1"], capsys)
    assert out.returncode != 0 and "pytree path" in out.stderr


def test_cli_adaptive_t_changes_t(capsys):
    """--adaptive-t (static): the round after the first runs the T the
    controller fitted from the first round's trajectory (4 -> 16 here)."""
    out = _inproc(["--device", "cpu", "--adaptive-t", "--t-inner", "4"],
                  capsys)
    rounds = _lines(out, "round ")
    steps = [int(l.split(" T ")[1].split()[0]) for l in rounds]
    assert steps[0] == 4 and steps[1] != 4, steps


def test_cli_runs_lossy_exchanges_on_cpu(capsys):
    """The lossy exchange flags: ring int8 at two hops over 4 groups,
    async_stale with int8z moments and an int8 downlink; a downlink codec
    on the ring is refused with the reference's reason."""
    out = _inproc(["--device", "cpu", "--comm", "ring", "--codec", "int8",
                   "--mix-rounds", "2", "--groups", "4"], capsys)
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines() if l.startswith("round ")]
    assert len(rounds) == 2
    assert "comm ring/int8" in out.stdout
    out = _inproc(["--device", "cpu", "--comm", "async_stale", "--codec",
                   "int8", "--opt", "adamw", "--lr", "1e-3",
                   "--moment-codec", "int8z", "--downlink-codec", "int8",
                   "--staleness", "1"], capsys)
    assert out.returncode == 0, out.stderr
    assert "comm async_stale/int8" in out.stdout
    out = _inproc(["--device", "cpu", "--comm", "ring", "--downlink-codec",
                   "int8"], capsys)
    assert out.returncode != 0 and "no separate downlink" in out.stderr


def test_checkpoint_hands_off_to_the_serve_launcher(tmp_path, capsys):
    """--checkpoint saves the averaged server params with the reference's
    metadata; the serve launcher restores them on the CPU and passes its
    parity check (each request replayed alone gives the same tokens)."""
    import json

    import numpy as np

    path = str(tmp_path / "ck")
    out = _inproc(["--device", "cpu", "--checkpoint", path], capsys)
    assert out.returncode == 0, out.stderr
    assert f"checkpoint -> {path}.npz" in out.stdout
    with open(path + ".json") as f:
        assert json.load(f) == {"arch": "paper-mlp-reduced", "rounds": 2,
                                "mode": "localsgd"}
    with np.load(path + ".npz") as data:
        keys = list(data.keys())
    assert keys == sorted(keys) and "blocks/attn/wq" in keys
    serve = _inproc(["--device", "cpu", "--arch", "paper-mlp", "--reduced",
                     "--from-checkpoint", path, "--requests", "4",
                     "--check-parity"], capsys, ["python", "-m", "serve"],
                    "serve")
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
    # the engine refuses the vlm family with the reference's message
    out = serve(["--device", "cpu", "--arch", "internvl2-1b"])
    assert out.returncode != 0
    assert "serve does not support family 'vlm'" in out.stderr


def test_cli_runs_faults_tiers_and_overlap_on_cpu(capsys):
    """push_sum under drops, the two tiers over a lossy DCN and the
    overlapped ring with int8, as the reference launcher takes them; each
    round prints its participation; the reference's refusals by name."""
    for extra, name in (
            (["--comm", "push_sum", "--drop-rate", "0.3", "--stall-rate",
              "0.1", "--fault-seed", "1"], "push_sum/fp32+drop0.3@1"),
            (["--comm", "hierarchical", "--groups", "4", "--n-pods", "2",
              "--drop-rate", "0.075", "--intra-drop-rate", "0.05"],
             "hier[ringx2|push_sum]/fp32+drop[i0.05@1,x0.075@2]"),
            (["--comm", "hierarchical", "--groups", "4", "--n-pods", "2",
              "--intra-topology", "server", "--inter-topology", "server",
              "--inter-codec", "int8"], "hier[serverx2|server]/fp32+x:int8"),
            (["--comm", "ring", "--codec", "int8", "--groups", "4",
              "--overlap"], "ring/int8+ov")):
        code, out, err = _main(["--device", "cpu"] + extra, capsys)
        assert code == 0, err
        rounds = [l for l in out.splitlines() if l.startswith("round ")]
        assert len(rounds) == 2 and " part " in rounds[1]
        assert f"comm {name}:" in out, out
    code, out, _ = _main(["--device", "cpu", "--comm", "server",
                          "--drop-rate", "0.5", "--rounds", "4",
                          "--fault-seed", "3"], capsys)
    parts = [float(l.split(" part ")[1].split()[0])
             for l in out.splitlines() if l.startswith("round ")]
    assert code == 0 and len(parts) == 4
    assert min(parts) < 1.0 and all(0.0 <= p <= 1.0 for p in parts)
    for extra, why in ((["--comm", "push_sum", "--codec", "int8"],
                        "valid push_sum codecs"),
                       (["--comm", "hierarchical", "--n-pods", "3"],
                        "divide"),
                       (["--comm", "ring", "--overlap", "--mix-rounds", "2"],
                        "mix_rounds"),
                       (["--comm", "server", "--n-pods", "2"],
                        "hierarchical"),
                       (["--mode", "sync", "--drop-rate", "0.1"],
                        "no exchange")):
        code, _, err = _main(["--device", "cpu"] + extra, capsys)
        assert code != 0 and why in err, (extra, err)


def test_cli_runs_the_exchanges_on_the_pytree_round(capsys):
    """Without --packed the launcher takes what the reference's pytree
    round takes: push_sum under drops, the two tiers, a faulty server,
    the cast codecs on the params, moments and downlink, async_stale;
    each round prints its participation (below 1 where faults fire)."""
    for extra, name in (
            (["--comm", "push_sum", "--drop-rate", "0.1"],
             "push_sum/fp32+drop0.1@0"),
            (["--comm", "hierarchical", "--n-pods", "2", "--groups", "8"],
             "hier[ringx2|push_sum]/fp32"),
            (["--codec", "bf16", "--moment-codec", "bf16", "--opt",
              "adamw"], "server/bf16+m:bf16"),
            (["--drop-rate", "0.5", "--fault-seed", "3", "--codec", "fp16"],
             "server/fp16+drop0.5@3"),
            (["--comm", "async_stale", "--downlink-codec", "bf16", "--opt",
              "momentum"], "async_stale/fp32+d:bf16")):
        code, out, err = _main(["--device", "cpu"] + extra, capsys,
                               TREE_CMD)
        assert code == 0, (extra, err)
        rounds = [l for l in out.splitlines() if l.startswith("round ")]
        assert len(rounds) == 2 and "mode=localsgd pytree" in out
        assert f"comm {name}:" in out, out
        parts = [float(l.split(" part ")[1].split()[0]) for l in rounds]
        assert all(0.0 <= p <= 1.0 for p in parts), parts
        if "--drop-rate" in extra:
            assert min(parts) < 1.0, parts
