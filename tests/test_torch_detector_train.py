"""fairdiff_torch's detector training against the JAX package's: the scene
renderers bit for bit, the anchor targets exactly, the loss and its
gradients, three Adam steps of `train_detector`, and the benchmark of
`eval_detector` on `assets/detector.npz`.

Carries tests/test_detector_train.py, test_detector_shifts.py and
test_train_detector_cli.py over to the port. Tolerances: the loss and every
gradient within 1e-5 (fp32 convolutions summed in other orders, relative
1e-5 on gradients of magnitude above 1); after three Adam steps every
weight within 1e-4; benchmark rates equal and mean IoU and landmark error
within 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.guidance import detector_train as jdt
from fairdiff.guidance.faces import FaceDetections as JaxFaceDetections
from fairdiff.io.adapters_io import load_adapters as jax_load_adapters
from fairdiff.models.face_detector import DetectorConfig as JaxDetectorConfig
from fairdiff.models.face_detector import FaceDetectorNet as JaxFaceDetectorNet
from fairdiff.tools import eval_detector as jax_eval_detector
from fairdiff.tools import train_detector as jax_train_detector
from fairdiff_torch.guidance import detector_train as tdt
from fairdiff_torch.guidance.faces import FaceDetections
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params, state_dict_from_jax
from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet, load_detector_npz
from fairdiff_torch.tools import eval_detector, train_detector

torch.set_num_threads(1)


def _equal_scenes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


RENDERERS = {
    "face": lambda m, rng, size: m.render_face_scene(rng, size, distractors=2),
    "face_plain": lambda m, rng, size: m.render_face_scene(rng, size),
    "negative": lambda m, rng, size: m.render_negative_scene(rng, size),
    "negative_none": lambda m, rng, size: m.render_negative_scene(rng, size, distractors=0),
    "face_dr": lambda m, rng, size: m.render_face_scene_dr(rng, size),
    "face_dr_small": lambda m, rng, size: m.render_face_scene_dr(rng, size, lead_scale_range=(0.12, 0.30)),
    "negative_dr": lambda m, rng, size: m.render_negative_scene_dr(rng, size),
    "structured": lambda m, rng, size: (m._structured_background(rng, size),),
    "blur": lambda m, rng, size: (m._gaussian_blur(rng.normal(0, 1, (size, size, 3)).astype(np.float32),
                                                   float(rng.uniform(0.5, 2.5))),),
}


@pytest.mark.parametrize("name", RENDERERS)
@pytest.mark.parametrize("size", [64, 128])
def test_renderers_bit_equal(name, size):
    for seed in range(3):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):  # several scenes from one generator: the draws stay in step
            _equal_scenes(RENDERERS[name](tdt, ra, size), RENDERERS[name](jdt, rb, size))


@pytest.mark.parametrize("shift", sorted(jdt.shifted_scene_fns(96)))
def test_shifted_scenes_bit_equal(shift):
    ours, theirs = tdt.shifted_scene_fns(96), jdt.shifted_scene_fns(96)
    assert set(ours) == set(theirs)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        img, bbox, lms = ours[shift](ra)
        _equal_scenes((img, bbox, lms), theirs[shift](rb))
        # the ground-truth contract (test_detector_shifts.py)
        assert img.shape == (96, 96, 3) and -1.0001 <= img.min() and img.max() <= 1.0001
        assert bbox[2] > bbox[0] and bbox[3] > bbox[1] and lms.shape == (5, 2)


@pytest.mark.parametrize("shift", sorted(jdt.shifted_negative_fns(96)))
def test_shifted_negatives_bit_equal(shift):
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        got = tdt.shifted_negative_fns(96)[shift](ra)
        _equal_scenes(got, jdt.shifted_negative_fns(96)[shift](rb))
        assert (got[1] == -1).all() and (got[2] == -1).all()


@pytest.mark.parametrize("scenes,neg_frac", [("base", 0.0), ("base", 0.5), ("dr", 0.25)])
def test_synthetic_batches_bit_equal(scenes, neg_frac):
    a = tdt.synthetic_batches(3, 64, 5, neg_frac=neg_frac, distractors=2, scenes=scenes)
    b = jdt.synthetic_batches(3, 64, 5, neg_frac=neg_frac, distractors=2, scenes=scenes)
    for _ in range(3):
        _equal_scenes(next(a), next(b))


def test_scenes_flag_selects_the_renderer_and_edge_landmarks_stay_local():
    a = next(tdt.synthetic_batches(2, 64, 0, scenes="dr"))[0]
    b = next(tdt.synthetic_batches(2, 64, 0, scenes="base"))[0]
    assert a.shape == b.shape and not np.allclose(a, b)
    rng = np.random.default_rng(42)
    for _ in range(100):
        img = tdt.render_face_scene_dr(rng, 128)[0]
        assert int((img == -0.7).all(axis=2).sum(axis=1).max()) <= 60


TARGET_CASES = [
    # boxes, stride, hw, rescue: the JAX test's small, tight, micro and face-free cases, and a batch
    ([[60.0, 60.0, 74.0, 75.0]], 8, (16, 16), None),
    ([[60.0, 60.0, 74.0, 75.0]], 8, (16, 16), 10.0),
    ([[61.0, 61.0, 78.0, 78.0]], 8, (16, 16), 10.0),
    ([[60.0, 60.0, 68.0, 68.0]], 8, (16, 16), 10.0),
    ([[-1.0, -1.0, -1.0, -1.0]], 8, (16, 16), 10.0),
    ([[10.0, 12.0, 50.0, 58.0], [-1, -1, -1, -1], [30.0, 30.0, 43.4, 43.4]], 4, (16, 16), 5.0),
    ([[10.0, 12.0, 50.0, 58.0], [0.0, 0.0, 63.0, 63.0]], 16, (4, 4), None),
]


@pytest.mark.parametrize("boxes,stride,hw,rescue", TARGET_CASES)
def test_level_targets_equal_jax(boxes, stride, hw, rescue):
    boxes = np.asarray(boxes, np.float32)
    lms = np.random.default_rng(0).uniform(0, 64, (len(boxes), 5, 2)).astype(np.float32)
    want = jdt._level_targets(jnp.asarray(boxes), jnp.asarray(lms), hw, stride, 2, rescue_floor=rescue)
    got = tdt._level_targets(torch.from_numpy(boxes), torch.from_numpy(lms), hw, stride, 2, rescue_floor=rescue)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_init(cfg, size, seed=0):
    # jitted: flax's eager init dispatches op by op (~18 s on one CPU core)
    return jax.jit(JaxFaceDetectorNet(cfg).init)(jax.random.key(seed), jnp.zeros((1, size, size, 3)))["params"]


@pytest.mark.parametrize("scenes", ["dr", "small_face"])
def test_detection_loss_and_grads_match_jax(scenes):
    jcfg, tcfg = JaxDetectorConfig.tiny(), DetectorConfig.tiny()
    params = _jax_init(jcfg, 64)
    if scenes == "dr":
        imgs, boxes, lms = next(tdt.synthetic_batches(4, 64, 1, neg_frac=0.25, scenes="dr"))
    else:  # a 13.4 px face: positives only through the stride-4 rescue; on a blank
        # image some residuals are exactly 0, where |r|' is 1 as in jax.numpy
        imgs = np.zeros((1, 64, 64, 3), np.float32)
        boxes = np.asarray([[30.0, 30.0, 43.4, 43.4]], np.float32)
        lms = np.full((1, 5, 2), 36.0, np.float32)
    net = JaxFaceDetectorNet(jcfg)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdt.detection_loss(net, p, *map(jnp.asarray, (imgs, boxes, lms)), jcfg), has_aux=True))(params)
    tnet = load_jax_params(FaceDetectorNet(tcfg), params)
    loss, aux = tdt.detection_loss(tnet, *map(torch.from_numpy, (imgs, boxes, lms)), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=1e-5)
    for k in ("cls", "box", "kps", "n_pos"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert aux["n_pos"].item() >= 1
    want_grads = state_dict_from_jax(jgrads)
    got_grads = {n: p.grad for n, p in tnet.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for n, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), rtol=1e-5, atol=1e-5, err_msg=n)
    for leaf in ZERO_GRAD_LEAVES:  # analytically 0 (see ZERO_GRAD_LEAVES)
        name = ".".join(leaf)
        assert got_grads[name].abs().max() < 1e-5 and want_grads[name].abs().max() < 1e-5, name


# The tiny detector's c2_block has 8 channels in 8 GroupNorm groups: each
# GroupNorm subtracts its one channel's mean, so the biases of the two
# convolutions in front of them have a gradient of exactly 0, and both
# packages see only rounding noise there (below 1e-5; held in
# test_detection_loss_and_grads_match_jax). Adam turns noise into an update
# of up to lr a step (1.004 lr by step 3), of either sign, so after three
# steps those leaves are held to 2 * 3 * 1.01 * lr, the most two Adam runs
# can part; every other leaf to 1e-4.
ZERO_GRAD_LEAVES = {("c2_block", "conv1", "bias"), ("c2_block", "conv2", "bias")}


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


def test_three_adam_steps_match_the_jax_cli(tmp_path):
    """`train_detector --tiny` from the JAX init: dr scenes, mining from
    step 1 (with the small-face positives), three Adam steps."""
    kw = dict(tiny=True, steps=3, batch_size=4, image_size=64, eval_scenes=0, log_every=1, mine_pool=8, seed=2)
    jax_train_detector.main(jax_train_detector.DetTrainConfig(out=str(tmp_path / "jax.npz"), **kw))
    init = _jax_init(JaxDetectorConfig.tiny(), 64, seed=2)
    params, metrics, history = train_detector.main(
        train_detector.DetTrainConfig(device="cpu", out=str(tmp_path / "port.npz"), **kw), init_params=init)
    assert metrics is None and history["mine_start"] == 1 and len(history["loss"]) == 3
    want, got = dict(_flat(jax_load_adapters(tmp_path / "jax.npz"))), dict(_flat(load_adapters(tmp_path / "port.npz")))
    assert want.keys() == got.keys() and ZERO_GRAD_LEAVES <= want.keys()
    for k in want:
        atol = 2 * kw["steps"] * 1.01 * 3e-4 if k in ZERO_GRAD_LEAVES else 1e-4
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg="|".join(k))
    # the returned tree is what was saved, and the weights moved
    for k, v in _flat(params):
        np.testing.assert_array_equal(v, got[k])
    assert any(not np.array_equal(got[k], v) for k, v in _flat(jax.tree_util.tree_map(np.asarray, init)))


def test_full_config_weights_load_in_both_packages(tmp_path):
    out = tmp_path / "det.npz"
    _, metrics, history = train_detector.main(train_detector.DetTrainConfig(
        device="cpu", steps=1, batch_size=2, image_size=64, out=str(out), eval_scenes=4, mine_k=0))
    assert set(metrics) >= {"recall", "det_rate", "fp_rate"} and all(0 <= metrics[k] <= 1 for k in metrics
                                                                    if k != "n_scenes" and k != "lm_err_112px")
    assert np.isfinite(history["loss"]).all()
    net = load_detector_npz(out)  # the port's reader of assets/detector.npz's layout
    raw = JaxFaceDetectorNet(JaxDetectorConfig()).apply({"params": jax_load_adapters(out)}, jnp.zeros((1, 64, 64, 3)))
    with torch.no_grad():
        got = net(torch.zeros(1, 64, 64, 3))
    np.testing.assert_allclose(got["score"][0].numpy(), np.asarray(raw["score"][0]), atol=1e-5)


def _oracle(kind, fw):
    box = [24.0, 24.0, 72.0, 72.0]
    if fw == "jax":
        return lambda im: JaxFaceDetections(
            indicators=jnp.full(im.shape[0], kind == "always"), bboxes=jnp.tile(jnp.asarray(box), (im.shape[0], 1)),
            landmarks=jnp.zeros((im.shape[0], 5, 2)), scores=jnp.ones(im.shape[0]))
    return lambda im: FaceDetections(
        indicators=torch.full((im.shape[0],), kind == "always"), bboxes=torch.tensor(box).expand(im.shape[0], 4),
        landmarks=torch.zeros(im.shape[0], 5, 2), scores=torch.ones(im.shape[0]))


@pytest.mark.parametrize("kind", ["always", "never"])
def test_evaluate_and_fp_rate_plumbing_match_jax(kind):
    fns_t, fns_j = tdt.shifted_scene_fns(96), jdt.shifted_scene_fns(96)
    for shift in (None, "multiface"):
        for neg in (None, False):
            kw = dict(n_scenes=8, size=96, batch=4, neg_fn=neg)
            got = tdt.evaluate_detector(_oracle(kind, "torch"), scene_fn=shift and fns_t[shift], device="cpu", **kw)
            want = jdt.evaluate_detector(_oracle(kind, "jax"), scene_fn=shift and fns_j[shift], **kw)
            assert got == pytest.approx(want, rel=1e-6)
            assert ("fp_rate" in got) == (neg is None)
    for name in jdt.shifted_negative_fns(96):
        got = tdt.false_positive_rate(_oracle(kind, "torch"), n_scenes=4, size=96, batch=4, device="cpu",
                                      neg_fn=tdt.shifted_negative_fns(96)[name])
        assert got == jdt.false_positive_rate(_oracle(kind, "jax"), n_scenes=4, size=96, batch=4,
                                              neg_fn=jdt.shifted_negative_fns(96)[name])


def test_eval_detector_matches_the_jax_tool(tmp_path):
    """assets/detector.npz on every shift and background family, 16 scenes
    (one batch of 32) each, seed 777."""
    want = jax_eval_detector.main(jax_eval_detector.DetEvalConfig(n_scenes=16, json_out=str(tmp_path / "j.json")))
    got = eval_detector.main(eval_detector.DetEvalConfig(device="cpu", n_scenes=16,
                                                         json_out=str(tmp_path / "p.json")))
    assert json.loads((tmp_path / "p.json").read_text()) == got
    assert got.keys() == want.keys() and "fp_rates" in got and len(got) == 11
    assert got["fp_rates"] == want["fp_rates"]
    for shift in want:
        if shift == "fp_rates":
            continue
        for k in ("n_scenes", "recall", "det_rate"):
            assert got[shift][k] == want[shift][k], (shift, k)
        for k in ("mean_iou", "lm_err_112px"):
            assert got[shift][k] == pytest.approx(want[shift][k], abs=1e-4), (shift, k)
    assert got["train_dist"]["recall"] > 0.8  # the shipped weights find the training scenes
    thr = eval_detector.main(eval_detector.DetEvalConfig(device="cpu", n_scenes=16, shifts="blur",
                                                         score_threshold=0.9))
    assert set(thr) == {"blur", "fp_rates"} and thr["blur"]["det_rate"] <= got["blur"]["det_rate"]
    assert eval_detector.DetEvalConfig().weights == "assets/detector.npz"
