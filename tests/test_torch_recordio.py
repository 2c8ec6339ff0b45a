"""RecordIO of the PyTorch port (``mxnet_tpu_torch/recordio.py``) and its
corruption helpers (``mxnet_tpu_torch/chaos.py``) against the JAX
package's, on the CPU.

The same payloads go through both packages' writers: the files must be
byte for byte equal, and a file written by either package must read in
the other, record for record.  Each package has two engines: the JAX
package its native one (``native/libmxtpu.so``, where it loads) and its
pure-Python one, the port its native one (``csrc/recordio.cc``, built
with g++ at first use by ``_build.build_recordio``) and its pure-Python
one; every pair of engines is crossed.  Records longer than one frame
are made by shrinking the Python writers' frame length limit to 7 bytes
(the native engines read them with their own 29-bit mask; a 2^29-byte
payload is too large for a test).  The native engine's ``tell``/``seek``
and its indexed reads match the Python engine's, and the tolerant reader
resynchronizes over either engine; two processes that start together on
a clean build directory both load the library one of them built.  ``pack``/
``unpack`` headers (scalar and vector labels) and ``pack_img`` bytes
(``.raw``, ``.jpg``, ``.png``, with the same cv2) are equal, and
``unpack_img`` gives the same pixels.  The tolerant reader skips a
flipped record, counts it (``corrupt_count``, the
``recordio.corrupt_records`` counter, one ``recordio-corrupt`` event) and
warns once, raises under ``strict`` or ``MXNET_TPU_RECORDIO_STRICT=1``,
and handles corruption running through EOF, as
``tests/test_recordio.py`` holds the JAX reader.  All comparisons are
exact.
"""
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import recordio as jrec
from mxnet_tpu.base import MXNetError as JaxError

from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError

PAYLOADS = [b"", b"a", b"abc", b"abcd", b"abcde",
            bytes(range(256)) * 4 + b"xyz"]
ENGINES = ["native", "python"]


@pytest.fixture(params=ENGINES)
def port_engine(request, monkeypatch):
    """The port's record engine for the test: its native library (built
    here with g++) or its pure-Python engine."""
    if request.param == "native":
        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the native engine")
        assert trec.engine() == "native"
    else:
        monkeypatch.setattr(trec, "_native", False)
        assert trec.engine() == "python"
    return request.param


@pytest.fixture(params=ENGINES)
def jax_engine(request, monkeypatch):
    """The JAX package's record engine for the test: its native library
    (skipped where it did not build) or its pure-Python engine."""
    if request.param == "native":
        if jrec._LIB is None:
            pytest.skip("native/libmxtpu.so did not build here")
    else:
        monkeypatch.setattr(jrec, "_LIB", None)
    return request.param


def _write(mod, path, payloads):
    w = mod.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(r):
    got = []
    while True:
        rec = r.read()
        if rec is None:
            return got
        got.append(rec)


def _read(mod, path, **kw):
    r = mod.MXRecordIO(path, "r", **kw)
    try:
        return _read_all(r)
    finally:
        r.close()


def test_written_bytes_equal_jax(tmp_path, jax_engine, port_engine):
    _write(jrec, str(tmp_path / "j.rec"), PAYLOADS)
    w = trec.MXRecordIO(str(tmp_path / "t.rec"), "w")
    assert w.engine == port_engine
    offsets = []
    for p in PAYLOADS:
        offsets.append(w.tell())
        w.write(p)
    w.close()
    raw = (tmp_path / "t.rec").read_bytes()
    assert raw == (tmp_path / "j.rec").read_bytes()
    assert offsets == tchaos.record_offsets(str(tmp_path / "t.rec"))


def test_files_cross_packages(tmp_path, jax_engine, port_engine):
    _write(jrec, str(tmp_path / "j.rec"), PAYLOADS)
    _write(trec, str(tmp_path / "t.rec"), PAYLOADS)
    r = trec.MXRecordIO(str(tmp_path / "j.rec"), "r")
    assert r.engine == port_engine
    r.close()
    assert _read(trec, str(tmp_path / "j.rec")) == PAYLOADS
    assert _read(jrec, str(tmp_path / "t.rec")) == PAYLOADS


@pytest.mark.parametrize("writer", ENGINES)
def test_port_engines_read_each_other(tmp_path, writer, port_engine,
                                      monkeypatch):
    """A file the port's native (python) engine wrote reads in its
    python (native) engine, and both engines' files are equal."""
    with monkeypatch.context() as m:
        if writer == "python":
            m.setattr(trec, "_native", False)
        else:
            m.setattr(trec, "_native", None)
        _write(trec, str(tmp_path / "w.rec"), PAYLOADS)
        assert trec.engine() == writer or shutil.which("g++") is None
    assert _read(trec, str(tmp_path / "w.rec")) == PAYLOADS


def test_tell_and_seek_match_the_python_engine(tmp_path, monkeypatch):
    """The native reader's ``tell`` after each record and its ``seek``
    back to any record's offset give the Python engine's offsets and
    records; a seek to the end reads nothing."""
    if trec.engine() != "native":
        pytest.skip("the native engine did not build here")
    path = str(tmp_path / "s.rec")
    payloads = [bytes([i]) * (i * 5 + 1) for i in range(20)]
    _write(trec, path, payloads)

    def walk(r):
        seen = [r.tell()]
        while r.read() is not None:
            seen.append(r.tell())
        return seen

    native = trec.MXRecordIO(path, "r")
    got = walk(native)
    monkeypatch.setattr(trec, "_native", False)
    python = trec.MXRecordIO(path, "r")
    assert python.engine == "python"
    assert got == walk(python) == tchaos.record_offsets(path) + [
        os.path.getsize(path)]
    for i in (13, 0, 19, 7):
        native._rec.seek(got[i])
        assert native.read() == payloads[i]
        assert native.tell() == got[i + 1]
    native._rec.seek(got[-1])
    assert native.read() is None
    native.close()
    python.close()


def test_multi_frame_records_cross(tmp_path, jax_engine, port_engine,
                                   monkeypatch):
    """A record past the frame limit spans frames flagged 1, 2, 3: the
    port's Python writer writes the JAX Python writer's bytes and every
    engine of both packages reads them (the native ones join the frames
    with their own 29-bit mask)."""
    payloads = [bytes(range(20)), b"short", bytes(range(7)),
                bytes(range(15))]
    monkeypatch.setattr(trec, "_LEN_MASK", 7)
    with monkeypatch.context() as m:
        m.setattr(jrec, "_LEN_MASK", 7)
        m.setattr(jrec, "_LIB", None)
        _write(jrec, str(tmp_path / "j.rec"), payloads)
        m.setattr(trec, "_native", False)
        _write(trec, str(tmp_path / "t.rec"), payloads)
    raw = (tmp_path / "t.rec").read_bytes()
    assert raw == (tmp_path / "j.rec").read_bytes()
    assert tchaos.record_offsets(str(tmp_path / "t.rec")) == \
        jchaos.record_offsets(str(tmp_path / "t.rec"))
    assert len(tchaos.record_offsets(str(tmp_path / "t.rec"))) == 4
    assert _read(trec, str(tmp_path / "t.rec")) == payloads
    if jax_engine == "python":
        monkeypatch.setattr(jrec, "_LEN_MASK", 7)
    assert _read(jrec, str(tmp_path / "t.rec")) == payloads


@pytest.mark.parametrize("key_type", [int, str])
def test_indexed_random_access_cross(tmp_path, jax_engine, port_engine,
                                     key_type):
    def write(mod, stem):
        w = mod.MXIndexedRecordIO(str(tmp_path / f"{stem}.idx"),
                                  str(tmp_path / f"{stem}.rec"), "w",
                                  key_type=key_type)
        for i in range(12):
            w.write_idx(key_type(i * 3), f"record-{i}".encode() * (i + 1))
        w.close()

    write(jrec, "j")
    write(trec, "t")
    for ext in (".rec", ".idx"):
        assert ((tmp_path / f"t{ext}").read_bytes()
                == (tmp_path / f"j{ext}").read_bytes())
    for reader, stem in ((trec, "j"), (jrec, "t")):
        r = reader.MXIndexedRecordIO(str(tmp_path / f"{stem}.idx"),
                                     str(tmp_path / f"{stem}.rec"), "r",
                                     key_type=key_type)
        assert r.keys == [key_type(i * 3) for i in range(12)]
        for i in (7, 0, 11, 3):
            assert r.read_idx(key_type(i * 3)) == \
                f"record-{i}".encode() * (i + 1)
        r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.0, 3.5], np.arange(
    4, dtype=np.float32)])
def test_pack_unpack_headers_equal_jax(label):
    header = (0, label, 42, 7)
    s = trec.pack(header, b"payload")
    assert s == jrec.pack(header, b"payload")
    th, tbody = trec.unpack(s)
    jh, jbody = jrec.unpack(s)
    assert tbody == jbody == b"payload"
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    assert np.asarray(th.label).tobytes() == np.asarray(jh.label).tobytes()


@pytest.mark.parametrize("fmt", [".raw", ".jpg", ".png"])
def test_pack_img_equal_jax(fmt):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (9, 13, 3), np.uint8)
    header = trec.IRHeader(0, [1.0, 2.0], 5, 0)
    s = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(header, img, quality=90, img_fmt=fmt)
    th, timg = trec.unpack_img(s)
    jh, jimg = jrec.unpack_img(s)
    assert timg.shape == jimg.shape == img.shape
    assert timg.tobytes() == jimg.tobytes()
    if fmt != ".jpg":
        assert timg.tobytes() == img.tobytes()
    gray = rng.randint(0, 255, (5, 6), np.uint8)
    assert trec.unpack_img(trec.pack_img(header, gray, img_fmt=".raw")
                           )[1].shape == (5, 6, 1)
    with pytest.raises(MXNetError):
        trec.pack_img(header, img, img_fmt=".bmp")


def _plain_rec(tmp_path, n):
    path = str(tmp_path / "chaos.rec")
    payloads = [bytes([i]) * (i * 7 + 1) for i in range(n)]
    _write(trec, path, payloads)
    return path, payloads


def test_bitflip_skipped_counted_once_warned(tmp_path, caplog,
                                             monkeypatch, port_engine):
    path, payloads = _plain_rec(tmp_path, 30)
    offsets = tchaos.record_offsets(path)
    assert offsets == jchaos.record_offsets(path)
    assert tchaos.flip_byte(path, offsets[7], 0x01) == 0x0a
    tchaos.flip_byte(path, offsets[23], 0x01)
    metrics = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("MXNET_TPU_METRICS_FILE", str(metrics))
    ttel.reset_for_tests()
    try:
        r = trec.MXRecordIO(path, "r")
        with caplog.at_level(logging.WARNING,
                             logger="mxnet_tpu_torch.recordio"):
            got = _read_all(r)
        # the reader goes on in the engine it opened with
        assert r.engine == port_engine
        r.close()
        assert got == payloads[:7] + payloads[8:23] + payloads[24:]
        assert r.corrupt_count == 2
        assert tprof.counter("recordio.corrupt_records") == 2
        ttel.flush_metrics()
        rows = [json.loads(line) for line in metrics.read_text().splitlines()]
        events = [row for row in rows
                  if row.get("event") == "recordio-corrupt"]
        assert [(e["uri"], e["count"]) for e in events] == [(path, 1),
                                                              (path, 2)]
    finally:
        monkeypatch.delenv("MXNET_TPU_METRICS_FILE")
        ttel.reset_for_tests()
    warns = [rec for rec in caplog.records
             if "corrupt record" in rec.getMessage()]
    assert len(warns) == 1
    # the JAX reader skips the same records
    assert _read(jrec, path) == got


def test_strict_raises_and_env_flips_default(tmp_path, monkeypatch,
                                             port_engine):
    path, payloads = _plain_rec(tmp_path, 10)
    before = tchaos.record_offsets(path)
    assert tchaos.corrupt_record(path, 4) == before[4]
    r = trec.MXRecordIO(path, "r", strict=True)
    for _ in range(4):
        assert r.read() is not None
    with pytest.raises(MXNetError):
        r.read()
    r.close()
    monkeypatch.setenv("MXNET_TPU_RECORDIO_STRICT", "1")
    r2 = trec.MXRecordIO(path, "r")
    assert r2.strict
    with pytest.raises(MXNetError):
        _read_all(r2)
    r2.close()
    with pytest.raises(JaxError):
        _read(jrec, path)
    monkeypatch.setenv("MXNET_TPU_RECORDIO_STRICT", "0")
    assert _read(trec, path) == payloads[:4] + payloads[5:]


def test_corruption_through_eof(tmp_path, port_engine):
    path, payloads = _plain_rec(tmp_path, 12)
    jpath = str(tmp_path / "copy.rec")
    with open(jpath, "wb") as f:
        f.write(open(path, "rb").read())
    assert tchaos.corrupt_record(path, 11) == jchaos.corrupt_record(jpath,
                                                                    11)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    r = trec.MXRecordIO(path, "r")
    assert _read_all(r) == payloads[:11]
    assert r.corrupt_count == 1
    # the reader stays at EOF (the JAX reader's next read returns the
    # bytes where its last failed candidate stopped)
    assert r.read() is None and r.read() is None
    r.close()
    assert r.engine == port_engine


_BUILD_CHILD = """
import sys
from mxnet_tpu_torch import _build, recordio
path = sys.argv[1]
w = recordio.MXRecordIO(path, "w")
for i in range(50):
    w.write(bytes([i]) * (3 * i + 1))
w.close()
r = recordio.MXRecordIO(path, "r")
n = 0
while r.read() is not None:
    n += 1
print(recordio.engine(), r.engine, n, _build.build_recordio()["lib"])
"""


def test_clean_build_in_two_processes_at_once(tmp_path):
    """Two processes that start together on an empty build directory
    both build or load the native engine, both read and write through
    it, and one library is left in place (no half-written file, no
    temporary directory)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native engine")
    cache = tmp_path / "cache"
    env = dict(os.environ, MXNET_TPU_CACHE_DIR=str(cache),
               MXNET_TPU_CACHE="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               str(tmp_path / f"c{i}.rec")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [o.split() for o, _ in outs]
    assert [ln[:3] for ln in lines] == [["native", "native", "50"]] * 2
    assert lines[0][3] == lines[1][3]
    built = sorted(os.listdir(cache / "cuda" / "recordio"))
    assert len(built) == 1 and ".tmp" not in built[0]
    assert os.listdir(cache / "cuda" / "recordio" / built[0]) == \
        ["librecordio.so"]
    assert ((tmp_path / "c0.rec").read_bytes()
            == (tmp_path / "c1.rec").read_bytes())


def test_failed_build_warns_and_the_python_engine_serves(tmp_path, caplog,
                                                         monkeypatch):
    """A build that fails logs one warning with the compiler's output;
    the Python engine then reads and writes."""
    from mxnet_tpu_torch import _build

    def broken():
        raise MXNetError("record engine build failed (g++ exited 1):\n"
                         "recordio.cc:1:1: error: planted")
    monkeypatch.setattr(_build, "build_recordio", broken)
    monkeypatch.setattr(trec, "_native", None)
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.recordio"):
        assert trec.engine() == "python"
        path = str(tmp_path / "f.rec")
        _write(trec, path, PAYLOADS)
        assert _read(trec, path) == PAYLOADS
    warns = [rec.getMessage() for rec in caplog.records
             if "native recordio engine" in rec.getMessage()]
    assert len(warns) == 1 and "error: planted" in warns[0]
