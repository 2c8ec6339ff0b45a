"""``tools/torch_compile_cache_inspect.py``, the port's twin of
``tools/compile_cache_inspect.py``, over a cache directory that the
port's ``ProgramCache`` filled on the CPU: ``list``, ``show``, ``size``,
``evict`` and ``clear`` through the tool's ``main``, in process.

The tool reads the JSON sidecars under ``<dir>/programs`` (a captured
graph is not serialized, so a sidecar is the whole entry) and counts the
kernel builds under ``<dir>/cuda`` where the JAX tool counts
``<dir>/xla``; it imports neither torch nor jax.
"""
import importlib.util
import json
import os

import pytest

from mxnet_tpu_torch import compile_cache as cc

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO_ROOT, "tools", "torch_compile_cache_inspect.py")


def _tool():
    spec = importlib.util.spec_from_file_location("torch_cc_inspect", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cache_dir(tmp_path):
    """Two programs resolved through a ProgramCache with a disk layer,
    and a kernel build file under ``cuda/``."""
    cache = cc.ProgramCache(cache_dir=str(tmp_path))
    digests = []
    for label, n in (("trainer.train", 4), ("serve.decode.8", 8)):
        key = cc.program_key(f"fp:{label}", {"x": cc.torch.zeros(n)},
                             extra={"kind": label})
        prog, info = cache.get_or_compile(
            key, lambda: cc.CapturedProgram(label, lambda: None, "cpu")
            .build(), label=label)
        assert info["source"] == "eager"
        digests.append(key.digest)
    (tmp_path / "cuda").mkdir()
    (tmp_path / "cuda" / "libk.so").write_bytes(b"\0" * 1000)
    return str(tmp_path), digests


def _run(capsys, *argv):
    rc = _tool().main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_list_and_show_read_the_sidecars(cache_dir, capsys):
    root, digests = cache_dir
    rc, out, _ = _run(capsys, "--cache-dir", root, "list")
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].split()[:4] == ["digest", "label", "capture_s", "age"]
    assert sorted(line.split()[0] for line in lines[1:]) == sorted(
        d[:12] for d in digests)
    assert {line.split()[1] for line in lines[1:]} == {
        "trainer.train", "serve.decode.8"}
    rc, out, _ = _run(capsys, "--cache-dir", root, "show", digests[0][:10])
    assert rc == 0
    entry = json.loads(out)
    assert entry["digest"] == digests[0]
    assert entry["label"] == "trainer.train"
    assert entry["fields"]["x:kind"] == "trainer.train"
    assert entry == cc.ProgramCache(cache_dir=root).entries()[
        sorted(digests).index(digests[0])]
    rc, _, err = _run(capsys, "--cache-dir", root, "show", "zzzz")
    assert rc == 1 and "no entry matching" in err


def test_size_counts_sidecars_and_kernel_builds(cache_dir, capsys):
    root, _ = cache_dir
    side = sum(os.path.getsize(os.path.join(root, "programs", f))
               for f in os.listdir(os.path.join(root, "programs")))
    rc, out, _ = _run(capsys, "--cache-dir", root, "size")
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("programs: 2 entries, ")
    assert lines[1] == "cuda:     1 files, 1000 B"
    assert lines[2] == f"total:    {_tool()._fmt_bytes(side + 1000)}"


def test_evict_and_clear_remove_sidecars(cache_dir, capsys, monkeypatch):
    root, digests = cache_dir
    rc, out, _ = _run(capsys, "--cache-dir", root, "evict", digests[1][:8])
    assert rc == 0 and out.startswith("evicted 1 file(s): ")
    left = cc.ProgramCache(cache_dir=root).entries()
    assert [e["digest"] for e in left] == [digests[0]]
    rc, _, err = _run(capsys, "--cache-dir", root, "evict", digests[1][:8])
    assert rc == 1 and "no entry matching" in err
    monkeypatch.setenv("MXNET_TPU_CACHE_DIR", root)
    rc, out, _ = _run(capsys, "clear")
    assert rc == 0 and out.startswith("removed 1 file(s)")
    assert cc.ProgramCache(cache_dir=root).entries() == []
    assert os.path.exists(os.path.join(root, "cuda", "libk.so"))


def test_no_cache_dir_exits_two(capsys, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_CACHE_DIR", raising=False)
    rc, _, err = _run(capsys, "list")
    assert rc == 2 and "no cache dir" in err


def test_the_tool_imports_neither_torch_nor_jax():
    import ast
    tree = ast.parse(open(TOOL).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names == {"argparse", "json", "os", "sys", "time"}
