#!/usr/bin/env python
"""Create .lst lists and pack images into RecordIO datasets.

The port's twin of ``tools/im2rec.py``: the same lists, options and
records, written through ``mxnet_tpu_torch.recordio`` (whose records are
the JAX package's byte for byte), so for one image folder and one set of
options the ``.lst``, ``.rec`` and ``.idx`` files of the two tools are
the same bytes.  Worker processes (spawned, not forked) do the
decode/resize/encode; ``--encoding .raw`` writes uncompressed pixels
(decode-free reading, see ``recordio.pack_img``).  It imports the port's
``recordio`` and cv2, nothing else of the port.

List mode:   python tools/torch_im2rec.py prefix root --make-list \
                 [--train-ratio 0.9] [--test-ratio 0.05] [--chunks N] \
                 [--shuffle]
Pack mode:   python tools/torch_im2rec.py prefix root [--lst prefix.lst] \
                 [--resize 256] [--quality 95] [--num-thread 8] \
                 [--encoding .jpg|.png|.raw] [--center-crop] [--shuffle]
"""
import argparse
import os
import random
import sys
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def find_images(root):
    """Walk root; yield (label, relpath) with subdir name as class id
    (classes sorted, reference list_image behavior)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    items = []
    for label, cls in enumerate(classes):
        for dirpath, dirs, files in os.walk(os.path.join(root, cls)):
            dirs.sort()  # deterministic walk -> reproducible splits
            for fn in sorted(files):
                if fn.lower().endswith(_EXTS):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    items.append((float(label), rel))
    if not classes:  # flat directory: label 0
        for fn in sorted(os.listdir(root)):
            if fn.lower().endswith(_EXTS):
                items.append((0.0, fn))
    return items


def write_list(prefix, items, chunks=1, train_ratio=1.0, test_ratio=0.0):
    """Write prefix[_train|_val|_test][_k].lst (reference make_list)."""
    n = len(items)
    chunk_size = (n + chunks - 1) // chunks
    for k in range(chunks):
        chunk = items[k * chunk_size:(k + 1) * chunk_size]
        suffix = f"_{k}" if chunks > 1 else ""
        # train_ratio + test_ratio partition the chunk, remainder = val;
        # an explicit test split always wins over the train default
        eff_train = min(train_ratio, 1.0 - test_ratio)
        n_train = int(len(chunk) * eff_train)
        n_test = int(len(chunk) * test_ratio)
        parts = {"_train": chunk[:n_train],
                 "_test": chunk[n_train:n_train + n_test],
                 "_val": chunk[n_train + n_test:]}
        if eff_train >= 1.0:
            parts = {"": chunk}
        for tag, rows in parts.items():
            if not rows:
                continue
            path = f"{prefix}{tag}{suffix}.lst"
            with open(path, "w") as f:
                for i, (label, rel) in enumerate(rows):
                    f.write(f"{i}\t{label}\t{rel}\n")
            print(f"wrote {len(rows)} entries -> {path}")


def read_list(path):
    items = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(float(parts[0]))
            labels = [float(x) for x in parts[1:-1]]
            items.append((idx, labels[0] if len(labels) == 1 else labels,
                          parts[-1]))
    return items


def _encode_one(task):
    """Worker: read + resize(+crop) + encode one image; returns packed
    record bytes (or (idx, None, path) for unreadable files)."""
    idx, label, path, resize, center_crop, quality, encoding = task
    import cv2
    from mxnet_tpu_torch import recordio
    img = cv2.imread(path)
    if img is None:
        return idx, None, path
    if resize > 0:
        h, w = img.shape[:2]
        if h < w:
            size = (max(1, int(w * resize / h)), resize)
        else:
            size = (resize, max(1, int(h * resize / w)))
        img = cv2.resize(img, size)
    if center_crop:
        h, w = img.shape[:2]
        s = min(h, w)
        y, x = (h - s) // 2, (w - s) // 2
        img = img[y:y + s, x:x + s]
    header = recordio.IRHeader(0, label, idx, 0)
    return idx, recordio.pack_img(header, img, quality=quality,
                                  img_fmt=encoding), path


def pack(args):
    from mxnet_tpu_torch import recordio
    items = (read_list(args.lst) if args.lst
             else [(i, lab, rel)
                   for i, (lab, rel) in enumerate(find_images(args.root))])
    if args.shuffle:
        random.shuffle(items)
    tasks = [(idx, label, os.path.join(args.root, rel), args.resize,
              args.center_crop, args.quality, args.encoding)
             for idx, label, rel in items]
    writer = recordio.MXIndexedRecordIO(args.prefix + ".idx",
                                        args.prefix + ".rec", "w")
    n, skipped = 0, 0
    nproc = max(1, args.num_thread)
    pool = None
    if nproc == 1:
        results = map(_encode_one, tasks)
    else:
        # spawned workers: the parent may hold threads (a fork would copy
        # their locks); each worker imports this file and the recordio
        pool = ProcessPoolExecutor(
            max_workers=nproc, mp_context=multiprocessing.get_context("spawn"))
        # chunked map keeps IPC amortized; order preserved
        results = pool.map(_encode_one, tasks, chunksize=32)
    for idx, rec, path in results:
        if rec is None:
            print(f"skip unreadable {path}", file=sys.stderr)
            skipped += 1
            continue
        writer.write_idx(idx, rec)
        n += 1
    if pool is not None:
        pool.shutdown()
    writer.close()
    msg = f"packed {n} images -> {args.prefix}.rec"
    if skipped:
        msg += f" ({skipped} unreadable skipped)"
    print(msg)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("prefix", help="output prefix")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--make-list", action="store_true",
                    help="write .lst file(s) instead of packing")
    ap.add_argument("--lst", help=".lst file to pack; default: scan root")
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--train-ratio", type=float, default=1.0)
    ap.add_argument("--test-ratio", type=float, default=0.0)
    ap.add_argument("--resize", type=int, default=0,
                    help="resize short side before packing")
    ap.add_argument("--center-crop", action="store_true",
                    help="crop to square after resize")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--encoding", default=".jpg",
                    choices=(".jpg", ".png", ".raw"),
                    help=".raw = uncompressed (decode-free reading)")
    ap.add_argument("--num-thread", type=int, default=os.cpu_count() or 1,
                    help="worker processes for decode/encode")
    ap.add_argument("--shuffle", action="store_true")
    args = ap.parse_args(argv)

    if args.make_list:
        items = find_images(args.root)
        if args.shuffle:
            random.shuffle(items)
        write_list(args.prefix, items, args.chunks, args.train_ratio,
                   args.test_ratio)
        return
    pack(args)


if __name__ == "__main__":
    main()
