"""``ImageRecordIter`` of the PyTorch port (``mxnet_tpu_torch/image_io.py``)
against the JAX package's, on the CPU.

The records are packed by the JAX package (18 images of 20x20, ``.jpg``
and ``.raw``, each with a two-value label and an ``.idx``), and both
packages' iterators read the same file with the same arguments.  Every
batch (data, label, pad) of two epochs must be bitwise equal: the port
keeps the JAX iterator's random draws (``RandomState(seed +
part_index)``, one seed per record, a ``RandomState`` per image) and the
same cv2 calls.  Covered: scanned offsets and ``.idx``, shuffle,
``num_parts``/``part_index`` shards (disjoint, covering every record),
``round_batch`` with its wrap-around pad and without it, the mean image
computed, saved and then loaded, ``mean_r/g/b`` with ``scale``,
``label_width`` 2, and augmentation with resize, crop, mirror, rotation,
scale, aspect ratio, illumination and contrast.  The port's batches are
host tensors.  A corrupt record is skipped and surfaced on
``corrupt_records`` in both packages.
"""
import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import recordio as jrec
from mxnet_tpu.image_io import ImageRecordIter as JaxIter

from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch.image_io import ImageRecordIter
from mxnet_tpu_torch.ndarray import NDArray

N, SIZE = 18, 20
AUG = dict(resize=22, rand_crop=True, rand_mirror=True, max_rotate_angle=15,
           min_random_scale=0.8, max_random_scale=1.2, max_aspect_ratio=0.2,
           max_random_illumination=10.0, max_random_contrast=0.2)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """``{fmt: (rec, idx)}``: the dataset packed by the JAX package."""
    root = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (N, SIZE, SIZE, 3)).astype(np.uint8)
    out = {}
    for fmt in (".jpg", ".raw"):
        rec, idx = str(root / f"d{fmt}.rec"), str(root / f"d{fmt}.idx")
        w = jrec.MXIndexedRecordIO(idx, rec, "w")
        for i, img in enumerate(imgs):
            header = jrec.IRHeader(0, [float(i % 5), float(i)], i, 0)
            w.write_idx(i, jrec.pack_img(header, img, img_fmt=fmt))
        w.close()
        out[fmt] = (rec, idx)
    return out


def _epochs(it, n=2, host=False):
    got = []
    for _ in range(n):
        for b in it:
            if host:
                for arr in b.data + b.label:
                    assert (isinstance(arr, NDArray)
                            and arr.data.device.type == "cpu")
            got.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in b.label], b.pad))
        it.reset()
    return got


def _assert_same(t_it, j_it, epochs=2):
    assert t_it.provide_data == j_it.provide_data
    assert t_it.provide_label == j_it.provide_label
    assert t_it.steps_per_epoch == j_it.steps_per_epoch
    t, j = _epochs(t_it, epochs, host=True), _epochs(j_it, epochs)
    assert len(t) == len(j) == epochs * j_it.steps_per_epoch
    for (td, tl, tp), (jd, jl, jp) in zip(t, j):
        assert tp == jp
        for a, c in zip(td + tl, jd + jl):
            assert a.dtype == c.dtype and a.shape == c.shape
            assert a.tobytes() == c.tobytes()
    return t


CASES = {
    "scanned": dict(idx=False, batch_size=4),
    "shuffle": dict(batch_size=4, shuffle=True, seed=3),
    "pad": dict(batch_size=5, shuffle=True),
    "no_round": dict(batch_size=5, round_batch=False),
    "mean_rgb_scale": dict(batch_size=6, mean_r=120.0, mean_g=110.0,
                           mean_b=100.0, scale=1.0 / 255),
    "label_width_2": dict(batch_size=6, label_width=2),
    "augment_jpg": dict(batch_size=6, shuffle=True, seed=5, **AUG),
    "augment_raw": dict(fmt=".raw", batch_size=6, shuffle=True, seed=7,
                        **AUG),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_bitwise_jax(packed, case):
    kw = dict(CASES[case])
    rec, idx = packed[kw.pop("fmt", ".jpg")]
    if not kw.pop("idx", True):
        idx = None
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
                preprocess_threads=3, **kw)
    got = _assert_same(ImageRecordIter(**args), JaxIter(**args))
    if case == "pad":
        assert [p for _, _, p in got] == [0, 0, 0, 2] * 2
    if case == "no_round":
        assert [p for _, _, p in got] == [0, 0, 0] * 2


def test_shards_cover_disjointly(packed):
    rec, idx = packed[".raw"]
    seen = []
    for part in range(3):
        args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
                    batch_size=3, num_parts=3, part_index=part, shuffle=True,
                    label_width=2)
        got = _assert_same(ImageRecordIter(**args), JaxIter(**args),
                           epochs=1)
        seen.extend(int(v) for _, (lab,), _ in got for v in lab[:, 1])
    assert sorted(seen) == list(range(N))


def test_mean_image_computed_then_loaded(packed, tmp_path):
    rec, idx = packed[".jpg"]
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
                batch_size=6, scale=0.5)
    t_it = ImageRecordIter(mean_img=tpath, **args)
    j_it = JaxIter(mean_img=jpath, **args)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert t["mean"].tobytes() == j["mean"].tobytes()
    _assert_same(t_it, j_it, epochs=1)
    # a second iterator loads the saved file (the JAX package's too)
    _assert_same(ImageRecordIter(mean_img=jpath, **args),
                 JaxIter(mean_img=tpath, **args), epochs=1)


def test_corrupt_record_surfaced(packed, tmp_path):
    rec, _ = packed[".raw"]
    path = str(tmp_path / "c.rec")
    with open(rec, "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    offsets = jchaos.record_offsets(path)
    assert tchaos.corrupt_record(path, 5) == offsets[5]
    args = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=6)
    t_it, j_it = ImageRecordIter(**args), JaxIter(**args)
    assert t_it.num_data == j_it.num_data == N - 1
    assert t_it.corrupt_records == j_it.corrupt_records == 1
    _assert_same(t_it, j_it, epochs=1)
