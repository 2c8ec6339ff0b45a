"""``tools/torch_ckpt_inspect.py`` against ``tools/ckpt_inspect.py``: the same
checkpoints (written by either package) through both tools, loaded in
this process as the JAX tests load theirs.  Every command gives the same
exit code and names the same arrays; where no error text is printed
(everything but ``CORRUPT``), the output is the same text.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu.checkpoint import CheckpointManager as JaxManager

from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.online import compat_stamp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _keep_port_random_state():
    """Restore the port's global key sequence and device generators after
    the test, so the test files that run after this one in the same
    process draw what they would draw without it."""
    from mxnet_tpu_torch import random as port_random
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _tool("ckpt_inspect"), _tool("torch_ckpt_inspect")


W = np.arange(24, dtype=np.float32).reshape(4, 6)
B = np.zeros((3,), np.float32)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Step directories: ``jax`` and ``port`` hold the same values
    (written by each package), ``changed`` other values of ``w``,
    ``reshaped`` a new shape of ``b`` and an extra array, ``corrupt`` a
    flipped byte in a shard."""
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    mgr = JaxManager(str(root / "jax"))
    mgr.save(7, {"w": W, "b": B}, meta={"num_update": 7}, blocking=True)
    out["jax"] = mgr.step_path(7)
    mgr.close()
    mgr = CheckpointManager(str(root / "port"), keep_last=4)
    mgr.save(7, {"w": torch.from_numpy(W), "b": torch.from_numpy(B)},
             meta={"num_update": 7}, blocking=True)
    out["port"] = mgr.step_path(7)
    mgr.save(9, {"w": torch.ones(4, 6), "b": torch.from_numpy(B)},
             blocking=True)
    out["changed"] = mgr.step_path(9)
    params = {"w": torch.from_numpy(W), "b": torch.zeros(5),
              "extra": torch.arange(4, dtype=torch.int32)}
    mgr.save(11, params, meta={"compat": compat_stamp(params)},
             blocking=True)
    out["reshaped"] = mgr.step_path(11)
    mgr.save(13, {"w": torch.from_numpy(W), "b": torch.from_numpy(B)},
             blocking=True)
    out["corrupt"] = mgr.step_path(13)
    mgr.close()
    out["root"] = str(root / "port")
    shard = next(f for f in sorted(os.listdir(out["corrupt"]))
                 if f != "manifest.json")
    path = os.path.join(out["corrupt"], shard)
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))
    return out


def _both(tools, argv, capsys):
    got = []
    for tool in tools:
        rc = tool.main(argv)
        got.append((rc, capsys.readouterr().out))
    return got


@pytest.mark.parametrize("argv", [
    ["show", "{jax}", "--verify", "--shards"],
    ["show", "{port}", "--verify"],
    ["show", "{reshaped}"],
    ["list", "{root}"],
    ["diff", "{jax}", "{port}"],
    ["diff", "{port}", "{jax}"],
    ["diff", "{jax}", "{changed}"],
    ["diff", "{port}", "{reshaped}"],
    ["diff", "{port}", "{changed}", "--compat"],
    ["diff", "{jax}", "{reshaped}", "--compat"],
], ids=lambda a: "-".join(x.strip("{}-") for x in a))
def test_same_exit_codes_and_output(tools, ckpts, capsys, argv):
    (jrc, jout), (trc, tout) = _both(
        tools, [a.format(**ckpts) for a in argv], capsys)
    assert trc == jrc, (jout, tout)
    assert tout == jout
    if argv[0] != "diff":
        assert trc == 0
    elif "--compat" in argv:
        verdict = json.loads(tout)
        assert trc == (1 if argv[2] == "{reshaped}" else 0)
        assert verdict["compatible"] == (trc == 0)
        if trc:
            assert verdict["added"] == ["extra"]
            assert [c["name"] for c in verdict["changed"]] == ["b"]
            assert verdict["stamp_b"] is not None
    else:
        named = sorted(line.split()[1] for line in tout.splitlines()
                       if line[0] in "-+!~")
        assert named == {"{port}": [], "{jax}": [], "{changed}": ["w"],
                         "{reshaped}": ["b", "extra"]}[argv[2]]
        assert trc == (1 if named else 0)
    if argv[0] == "show" and "--verify" in argv:
        assert tout.count("[OK]") == 2


def test_corrupt_shard_found_by_both(tools, ckpts, capsys):
    (jrc, jout), (trc, tout) = _both(
        tools, ["show", ckpts["corrupt"], "--verify"], capsys)
    assert jrc == trc == 2

    def verdicts(out):
        return {line.split()[0]: line.split("[", 1)[1].split()[0].strip("]")
                for line in out.splitlines() if "[" in line}

    assert verdicts(tout) == verdicts(jout)
    assert sorted(verdicts(tout).values()) == ["CORRUPT", "OK"]
