"""``tools/torch_im2rec.py`` against ``tools/im2rec.py`` on one image folder:
for the same options the ``.lst``, ``.rec`` and ``.idx`` files are the same
bytes.  Both tools run in this process (``--num-thread 1``) except one
run of the port's tool as a script with two spawned workers.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
cv2 = pytest.importorskip("cv2")


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
    return _tool("im2rec"), _tool("torch_im2rec")


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Two classes of PNGs, landscape and portrait, in nested folders."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        for sub in ("", "more"):
            d = root / cls / sub
            d.mkdir(parents=True, exist_ok=True)
            for i, (h, w) in enumerate(((18, 26), (25, 15), (20, 20))):
                img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                cv2.imwrite(str(d / f"img{i}.png"), img)
    (root / "cat" / "notes.txt").write_text("not an image")
    return root


def _run_jax(tool, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["im2rec.py", *argv])
    tool.main()


def _files(prefix_dir):
    return {f: (prefix_dir / f).read_bytes()
            for f in sorted(os.listdir(prefix_dir))}


def _both(tools, tmp_path, root, opts, monkeypatch, lst=None):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    jlst = ["--lst", str(lst)] if lst else []
    _run_jax(tools[0], [str(jdir / "data"), str(root), *jlst, *opts],
             monkeypatch)
    tools[1].main([str(tdir / "data"), str(root), *jlst, *opts])
    return _files(jdir), _files(tdir)


def test_lists_are_the_same_bytes(tools, image_root, tmp_path, monkeypatch):
    jax_files, port_files = _both(
        tools, tmp_path, image_root,
        ["--make-list", "--chunks", "2", "--train-ratio", "0.5"],
        monkeypatch)
    assert sorted(port_files) == ["data_train_0.lst", "data_train_1.lst",
                                  "data_val_0.lst", "data_val_1.lst"]
    assert port_files == jax_files
    rows = port_files["data_train_0.lst"].decode().splitlines()
    assert rows[0] == "0\t0.0\tcat/img0.png"


@pytest.mark.parametrize("opts", [
    ["--encoding", ".png", "--resize", "12", "--center-crop"],
    ["--encoding", ".raw", "--resize", "10"],
    ["--encoding", ".raw", "--center-crop"],
], ids=["png-resize-crop", "raw-resize", "raw-crop"])
def test_packed_records_are_the_same_bytes(tools, image_root, tmp_path,
                                           monkeypatch, opts):
    jax_files, port_files = _both(tools, tmp_path, image_root,
                                  [*opts, "--num-thread", "1"], monkeypatch)
    assert sorted(port_files) == ["data.idx", "data.rec"]
    assert port_files == jax_files
    from mxnet_tpu_torch import recordio
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "port" / "data.idx"),
                                     str(tmp_path / "port" / "data.rec"),
                                     "r")
    header, img = recordio.unpack_img(rec.read_idx(11))
    rec.close()
    assert header.label == 1.0 and header.id == 11
    if "--center-crop" in opts:
        assert img.shape[0] == img.shape[1]


def test_workers_pack_a_list_to_the_same_bytes(tools, image_root, tmp_path,
                                               monkeypatch):
    """The port's tool as a script, two spawned workers, packing a list
    made by the JAX tool."""
    lst_dir = tmp_path / "lst"
    lst_dir.mkdir()
    _run_jax(tools[0], [str(lst_dir / "all"), str(image_root),
                        "--make-list"], monkeypatch)
    lst = lst_dir / "all.lst"
    jdir = tmp_path / "jax"
    jdir.mkdir()
    _run_jax(tools[0], [str(jdir / "data"), str(image_root), "--lst",
                        str(lst), "--encoding", ".png", "--resize", "16",
                        "--num-thread", "1"], monkeypatch)
    tdir = tmp_path / "port"
    tdir.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_im2rec.py"),
         str(tdir / "data"), str(image_root), "--lst", str(lst),
         "--encoding", ".png", "--resize", "16", "--num-thread", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith(
        f"packed 12 images -> {tdir}/data.rec")
    assert _files(tdir) == _files(jdir)
