"""fairdiff_torch's face-recognition data layer against the JAX package's:
the batch stream of `ClassDataset.batches(image_size=)` against the JAX
`ClassDataset` on its native loader (fairdiff/native/imageloader.cpp), the
item path against its cv2 path, label noise, `verification_metrics` against
the JAX function (sklearn's ROC), IJB template evaluation, and the
5-point alignment warp against cv2.warpAffine.

Tolerances: order, flips and labels exactly; pixels exactly on the
size-matched fast path and within 1e-6 when resized or warped by the
native loader's arithmetic; metrics within 1e-9. The alignment: cv2's
fixed-point warp may snap sample coordinates to 1/32 pixel (INTER_BITS =
5), which would allow up to (the image's steepest neighbour step) x 2/32 /
127.5, ~1e-2 on these images, where all four taps lie inside the image;
the cv2 5.0 build the tests run with does not snap float images, and reads within 4.2e-5
of the port on every pixel, so the check is 1e-4 on every pixel and the
grid bound inside.
"""

import random
import sys

import numpy as np
import pytest
import torch

from fairdiff.facerec import datasets as jds
from fairdiff.native import imageloader_lib
from fairdiff_torch.facerec import datasets as tds
from fairdiff_torch.io.images import write_png

torch.set_num_threads(1)

SRC_LANDMARK = [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
                [41.5493, 92.3655], [70.7299, 92.2041]]


def _smooth(rng, h, w):
    """A smooth uint8 image: a few low-frequency waves per channel."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            fx, fy, ph = rng.uniform(0.01, 0.05), rng.uniform(0.01, 0.05), rng.uniform(0, 6.3)
            out[..., c] += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
    return np.clip(127.5 + 40 * out, 0, 255).round().astype(np.uint8)


def _tree(tmp_path, sizes, seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    lines = []
    for i, (h, w) in enumerate(sizes):
        img = _smooth(rng, h, w) if smooth else rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        write_png(img, tmp_path / "data" / f"id{i % 3}" / f"im{i}.png")
        lines.append(f"id{i % 3}/im{i}.png {i % 3}")
    ann = tmp_path / "ann.txt"
    ann.write_text("\n".join(lines) + "\n")
    return str(tmp_path / "data"), str(ann)


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("resize", [False, True])
def test_batch_stream_matches_native_loader(tmp_path, resize, test_mode):
    assert imageloader_lib.native_available()  # the JAX CLI's path wherever it builds
    sizes = [(40, 36), (24, 28), (32, 32), (50, 20)] * 3 if resize else [(32, 32)] * 11
    data_dir, ann = _tree(tmp_path, sizes)
    jstream = jds.ClassDataset(data_dir, ann, test_mode=test_mode).batches(4, seed=3, image_size=32, n_threads=3)
    tstream = tds.ClassDataset(data_dir, ann, test_mode=test_mode).batches(4, seed=3, image_size=32, n_threads=3)
    for _ in range(7):  # more than two epochs: the permutations and flips of every epoch
        (ji, jl), (ti, tl) = next(jstream), next(tstream)
        np.testing.assert_array_equal(tl, jl)
        assert ti.shape == ji.shape == (4, 32, 32, 3) and ti.dtype == np.float32
        if resize:
            np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(ti, ji)


def test_load_batch_warps_like_native_and_raises(tmp_path):
    data_dir, _ = _tree(tmp_path, [(40, 36), (32, 32), (48, 48)])
    paths = [f"{data_dir}/id{i % 3}/im{i}.png" for i in range(3)]
    mats = np.asarray([[[0.8, 0.1, 2.0], [-0.05, 0.9, 1.0]], [[0, 0, 0], [0, 0, 0]],
                       [[1.1, -0.2, -3.5], [0.2, 1.1, -2.0]]], np.float32)
    flips = np.asarray([True, False, True])
    want = imageloader_lib.load_batch(paths, (24, 28), mats=mats, flips=flips, n_threads=2)
    got = tds.load_batch(paths, (24, 28), mats=mats, flips=flips, n_threads=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    with pytest.raises(OSError, match="im_missing.png"):
        tds.load_batch([paths[0], f"{data_dir}/im_missing.png"], (8, 8))
    with pytest.raises(ValueError, match="singular"):
        tds.load_batch(paths[:1], (8, 8), mats=np.asarray([[1, 2, 0, 2, 4, 0]], np.float32))


def test_jpeg_without_pil_names_the_file(tmp_path, monkeypatch):
    """The port's codec needs no PIL: a broken JPEG raises OSError naming it
    in the item path and the batch loader alike."""
    path = tmp_path / "face.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0 not a real jpeg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(OSError, match="face.jpg"):
        tds.image_pipeline({"path": str(path)}, True)
    with pytest.raises(OSError, match="face.jpg"):
        tds.load_batch([str(path)], (8, 8))


def test_item_path_matches_cv2_path(tmp_path):
    data_dir, ann = _tree(tmp_path, [(20, 24), (32, 32), (17, 9), (8, 8), (30, 12)])
    jset, tset = jds.ClassDataset(data_dir, ann, test_mode=True), tds.ClassDataset(data_dir, ann, test_mode=True)
    for i in range(len(tset)):
        np.testing.assert_array_equal(tset[i][0], jset[i][0])
        assert tset[i][1] == jset[i][1]
    # train mode: the flips draw from the given random.Random, as in the JAX package
    for seed in range(4):
        for i, (path, _) in enumerate(tset.items):
            np.testing.assert_array_equal(tds.image_pipeline({"path": path}, False, random.Random(seed + i)),
                                          jds.image_pipeline({"path": path}, False, random.Random(seed + i)))
    # the item-by-item stream (no image_size): the same images, labels and order
    data_dir, ann = _tree(tmp_path / "same", [(16, 16)] * 5, seed=1)
    jb = jds.ClassDataset(data_dir, ann, test_mode=True).batches(2, seed=1)
    tb = tds.ClassDataset(data_dir, ann, test_mode=True).batches(2, seed=1)
    for _ in range(5):
        (j_img, j_lab), (t_img, t_lab) = next(jb), next(tb)
        np.testing.assert_array_equal(t_lab, j_lab)
        np.testing.assert_array_equal(t_img, j_img)


@pytest.mark.parametrize("ratio,seed", [(0.3, 7), (0.6, 0), (1.0, 3)])
def test_label_noise_matches_jax(tmp_path, ratio, seed):
    lines = [f"x{i}.png {i % 13}" for i in range(200)]
    (tmp_path / "ann.txt").write_text("\n".join(lines))
    j = jds.ClassDataset(str(tmp_path), str(tmp_path / "ann.txt"), noise_ratio=ratio, noise_seed=seed)
    t = tds.ClassDataset(str(tmp_path), str(tmp_path / "ann.txt"), noise_ratio=ratio, noise_seed=seed)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.num_classes == j.num_classes == 13 and t.items == j.items
    assert (t.labels != np.arange(200) % 13).sum() > 0


def _metric_cases():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 500)
    cont = rng.normal(size=500) + labels * 1.2
    yield "continuous", labels.tolist(), cont.tolist()
    yield "ties", labels.tolist(), (np.round(cont * 4) / 4).tolist()
    yield "few-ties", [1, 0, 1, 1, 0, 0, 1, 0], [0.5, 0.5, 0.9, 0.1, 0.3, 0.3, 0.3, 0.8]
    yield "perfect", [1] * 50 + [0] * 50, [0.9] * 50 + [0.1] * 50
    yield "random", rng.integers(0, 2, 300).tolist(), rng.random(300).tolist()


@pytest.mark.parametrize("name,labels,scores", list(_metric_cases()), ids=[c[0] for c in _metric_cases()])
def test_verification_metrics_match_jax(name, labels, scores):
    from sklearn.metrics import roc_curve

    fpr, tpr, thr = tds.roc_curve(labels, scores)
    sfpr, stpr, sthr = roc_curve(labels, scores, pos_label=1)
    np.testing.assert_array_equal(fpr, sfpr)
    np.testing.assert_array_equal(tpr, stpr)
    np.testing.assert_array_equal(thr, sthr)
    fprs = [1e-3, 1e-2, 0.1, 0.5]
    got = tds.verification_metrics(labels, scores, fprs)
    want = jds.verification_metrics(labels, scores, fprs)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-9, (k, g, w)


def _ijb_tree(tmp_path, n_img=24, seed=0):
    """A small IJB layout: 112x112 faces, 5-point landmarks near the ArcFace
    template, 6 templates over 4 subjects, media shared within templates."""
    rng = np.random.default_rng(seed)
    meta = tmp_path / "meta"
    meta.mkdir()
    data_lines, tid_lines = [], []
    for i in range(n_img):
        write_png(_smooth(rng, 112, 112), tmp_path / "img" / f"{i}.png")
        lm = np.asarray(SRC_LANDMARK) * rng.uniform(0.8, 1.1) + rng.uniform(-6, 6, 2) + rng.normal(0, 1, (5, 2))
        data_lines.append(f"img/{i}.png " + " ".join(f"{v:.4f}" for v in lm.reshape(-1))
                          + f" {rng.uniform(0.3, 1.0):.3f}")
        tid_lines.append(f"img/{i}.png {i % 6} {100 + (i % 6) * 10 + (i // 12)}")
    (meta / "data.txt").write_text("\n".join(data_lines))
    (meta / "tid_mid.txt").write_text("\n".join(tid_lines))
    (meta / "gallery.csv").write_text("TEMPLATE_ID,SUBJECT_ID\n0,0\n1,1\n2,2\n0,0\n")
    (meta / "probe.csv").write_text("TEMPLATE_ID,SUBJECT_ID\n3,0\n4,1\n5,3\n")
    (meta / "pairs.txt").write_text("0 3 1\n1 4 1\n2 5 0\n0 4 0\n1 3 0\n2 2 1\n")
    kwargs = dict(data_dir=str(tmp_path), meta_dir=str(meta), data_ann_file="data.txt", tmpl_ann_file="tid_mid.txt",
                  gallery_ann_files=["gallery.csv"], probe_ann_files=["probe.csv"], pair_ann_file="pairs.txt",
                  src_landmark=SRC_LANDMARK)
    return jds.IJBDataset(**kwargs), tds.IJBDataset(**kwargs)


def test_ijb_evaluate_matches_jax(tmp_path):
    jset, tset = _ijb_tree(tmp_path)
    feats = np.random.default_rng(1).normal(size=(len(tset), 16)).astype(np.float32)
    np.testing.assert_array_equal(tset.feat2template(feats), jset.feat2template(feats))
    assert tset.iden_info["g"]["posn_ids"].tolist() == jset.iden_info["g"]["posn_ids"].tolist() == [0, 1, 2]
    got, want = tset.evaluate(feats), jset.evaluate(feats)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-9, (k, g, w)


def _tap_inside(item, crop):
    """Output pixels whose four bilinear taps lie inside the source image."""
    m = tds.estimate_similarity(torch.tensor(item["tgz_landmark"]), torch.tensor(np.asarray(SRC_LANDMARK, np.float32)))
    inv = np.linalg.inv(np.vstack([m.numpy().astype(np.float64), [0, 0, 1]]))
    yy, xx = np.mgrid[0:crop, 0:crop]
    sx = inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]
    sy = inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]
    return (sx >= 1) & (sx <= 110) & (sy >= 1) & (sy <= 110)


def test_alignment_warp_matches_cv2(tmp_path):
    """The IJB path: similarity from the landmarks, warp with the inverse,
    bilinear, border 0, against the JAX package's cv2.warpAffine."""
    from fairdiff_torch.io.images import read_rgb8

    jset, tset = _ijb_tree(tmp_path)
    for i in range(len(tset)):
        pixels = read_rgb8(tset.info(i)["path"]).astype(np.float64)
        step = max(np.abs(np.diff(pixels, axis=0)).max(), np.abs(np.diff(pixels, axis=1)).max())
        got, want = tset[i][0], jset[i][0]
        assert got.shape == want.shape == (112, 112, 3)
        inside = _tap_inside(tset.data_items[i], 112)
        assert inside.mean() > 0.5
        assert np.abs(got - want)[inside].max() <= step * 2 / 32 / 127.5
        assert np.abs(got - want).max() <= 1e-4, (i, np.abs(got - want).max())
