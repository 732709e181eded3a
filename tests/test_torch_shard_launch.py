"""The train launcher's sharded run, as a user starts it: ``--shard 2
--groups 4 --packed`` on paper-mlp's reduction for 2 rounds, with the
server exchange, the two tiers (``--comm hierarchical --n-pods 2``) and
the overlapped ring int8 (``--overlap``, its fences calibrated on the
ranks). The launcher starts its 8 gloo ranks on the CPU itself (one
world) and rank 0 prints and saves the checkpoint, gathered to the
unsharded layout. Held against the unsharded launcher in this process
(one intra-op thread): the same round lines to their printed digits
(loss, grad_sq, T, participation, consensus), and the same averaged
params within rtol 1e-5 / atol 1e-6 (the sharded mean's all_reduce sums
in another order); the wire bytes are the padded buffer's
(``ShardedLayout``), as in the reference launcher."""
import re

import numpy as np
import pytest
import torch

from repro_torch.launch import train

ARGS = ["--device", "cpu", "--arch", "paper-mlp", "--reduced", "--packed",
        "--rounds", "2", "--groups", "4", "--t-inner", "2", "--seq", "32"]


def _rounds(out):
    """(loss, gsq, T, cons) of each printed round line."""
    pat = re.compile(r"round +\d+ loss (\S+) gsq (\S+) T (\d+) wire (\S+)B "
                     r"part (\S+) cons (\S+)")
    got = [pat.match(l) for l in out.splitlines() if l.startswith("round ")]
    assert got and all(got), out
    return ([(m[1], m[2], m[3], m[5], m[6]) for m in got],
            [m[4] for m in got])


def _sharded_vs_unsharded(capfd, tmp_path, extra=()):
    """The sharded launcher beside the unsharded one on the same flags."""
    sharded, plain = str(tmp_path / "sharded"), str(tmp_path / "plain")
    train.main(ARGS + list(extra) + ["--shard", "2", "--world-timeout",
                                     "300", "--checkpoint", sharded])
    out = capfd.readouterr().out
    assert "sharded execution: G=4 x 2 shards on 8 ranks" in out
    assert "transport gloo-cpu" in out
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(ARGS + list(extra) + ["--checkpoint", plain])
    finally:
        torch.set_num_threads(threads)
    ref = capfd.readouterr().out
    (got, wire), (want, wire_ref) = _rounds(out), _rounds(ref)
    assert got == want
    # every stream is the padded buffer on the sharded run
    assert all(int(w.replace(",", "")) > int(r.replace(",", ""))
               for w, r in zip(wire, wire_ref))
    a, b = np.load(sharded + ".npz"), np.load(plain + ".npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)


def test_sharded_launcher_matches_unsharded(capfd, tmp_path):
    _sharded_vs_unsharded(capfd, tmp_path)


@pytest.mark.parametrize("extra", [
    ["--comm", "hierarchical", "--n-pods", "2"],
    ["--comm", "ring", "--codec", "int8", "--overlap"]],
    ids=["hierarchical", "overlap"])
def test_sharded_launcher_tiers_and_overlap_match_unsharded(capfd, tmp_path,
                                                            extra):
    _sharded_vs_unsharded(capfd, tmp_path, extra)
