"""fairdiff_torch guidance and fairness modules against their JAX twins.

Geometry, face analysis, attribute heads, face features, the fairness
weights, losses and targets, and the synthetic guidance stack: the same
seeded numpy inputs go into both packages, and both the values and the
gradients with respect to the images are compared. Float32 on the CPU;
tolerances 1e-5 absolute unless stated (the same fp32 arithmetic in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.fairness import losses as jlosses
from fairdiff.fairness import targets as jtargets
from fairdiff.fairness import weights as jweights
from fairdiff.guidance import attributes as jattr
from fairdiff.guidance import face_feats as jff
from fairdiff.guidance import faces as jfaces
from fairdiff.guidance import geometry as jgeo
from fairdiff.models.face_detector import FaceDetections as JDetections
from fairdiff.training import metrics as jmetrics
from fairdiff.training import synthetic as jsyn
from fairdiff_torch.fairness import losses as tlosses
from fairdiff_torch.fairness import targets as ttargets
from fairdiff_torch.fairness import weights as tweights
from fairdiff_torch.guidance import attributes as tattr
from fairdiff_torch.guidance import face_feats as tff
from fairdiff_torch.guidance import faces as tfaces
from fairdiff_torch.guidance import geometry as tgeo
from fairdiff_torch.training import metrics as tmetrics
from fairdiff_torch.training import synthetic as tsyn

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _images(n=3, hw=64, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, hw, hw, 3)).astype(np.float32)


def _value_and_grad(jfn, tfn, images, seed=1):
    """(JAX out, port out, JAX d<out, w>/dimages, port d<out, w>/dimages)
    for one seeded weight tensor w shaped like the output."""
    jout = np.asarray(jfn(jnp.asarray(images)))
    w = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(images)))
    timg = torch.from_numpy(images).requires_grad_()
    tout = tfn(timg)
    (tout * torch.from_numpy(w)).sum().backward()
    return jout, tout.detach().numpy(), jg, timg.grad.numpy()


def _boxes():
    return np.array([[10.0, 12.0, 40.0, 50.0], [-5.0, 3.0, 20.0, 15.0], [30.0, 30.0, 70.0, 60.0]], np.float32)


def _landmarks(seed=2):
    base = (jgeo.ARCFACE_TEMPLATE - 56.0) * 0.3 + 32.0
    return (base[None] + np.random.default_rng(seed).normal(size=(3, 5, 2)) * 2.0).astype(np.float32)


def test_expand_bbox_matches_jax():
    boxes = np.concatenate([_boxes(), [[0.0, 0.0, 0.0, 9.0], [1.0, 1.0, 2.5, 2.5]]]).astype(np.float32)
    for coef, ratio in ((0.5, 1.0), (1.1, 1.3)):
        want = np.asarray(jgeo.expand_bbox(jnp.asarray(boxes), coef, ratio))
        got = tgeo.expand_bbox(torch.from_numpy(boxes), coef, ratio)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["crop", "warp", "align"])
def test_warps_match_jax_values_and_image_grads(which):
    images = _images()
    boxes, lms = _boxes(), _landmarks()
    mats = np.stack([np.asarray(jgeo.estimate_similarity(jnp.asarray(l), jnp.asarray(jgeo.ARCFACE_TEMPLATE)))
                     for l in lms]) * 0.4
    fns = {
        "crop": (lambda x: jgeo.crop_and_resize(x, jnp.asarray(boxes), 24, -1.0),
                 lambda x: tgeo.crop_and_resize(x, torch.from_numpy(boxes), 24, -1.0)),
        "warp": (lambda x: jgeo.warp_affine(x, jnp.asarray(mats), (20, 28), 0.5),
                 lambda x: tgeo.warp_affine(x, torch.from_numpy(mats), (20, 28), 0.5)),
        "align": (lambda x: jgeo.align_faces(x, jnp.asarray(lms), 32, -1.0),
                  lambda x: tgeo.align_faces(x, torch.from_numpy(lms), 32, -1.0)),
    }[which]
    jout, tout, jg, tg = _value_and_grad(*fns, images)
    np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-5)  # sampling at ~1e-4 px
    np.testing.assert_allclose(tg, jg, atol=1e-4, rtol=1e-5)


def test_estimate_similarity_matches_jax():
    lms = _landmarks(3)
    template = jnp.asarray(jgeo.ARCFACE_TEMPLATE)
    want = np.stack([np.asarray(jgeo.estimate_similarity(jnp.asarray(l), template)) for l in lms])
    got = tgeo.estimate_similarity(torch.from_numpy(lms), torch.from_numpy(jgeo.ARCFACE_TEMPLATE).expand(3, 5, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def _detections(ind):
    boxes, lms = _boxes(), _landmarks(4)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    j = JDetections(jnp.asarray(ind), jnp.asarray(boxes), jnp.asarray(lms), jnp.asarray(scores))
    t = tfaces.FaceDetections(*(torch.from_numpy(np.asarray(a)) for a in (ind, boxes, lms, scores)))
    return j, t


def test_analyze_faces_matches_jax():
    ind = np.array([True, False, True])
    jdet, tdet = _detections(ind)
    images = _images(seed=5)
    kw = dict(chip_size=32, aligned_size=24)
    for field in ("chips", "aligned"):
        jout, tout, jg, tg = _value_and_grad(
            lambda x: getattr(jfaces.analyze_faces(x, jdet, **kw), field),
            lambda x: getattr(tfaces.analyze_faces(x, tdet, **kw), field), images,
        )
        np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-5, err_msg=field)
        np.testing.assert_allclose(tg, jg, atol=1e-4, rtol=1e-5, err_msg=field)
    jres = jfaces.analyze_faces(jnp.asarray(images), jdet, **kw)
    tres = tfaces.analyze_faces(torch.from_numpy(images), tdet, **kw)
    np.testing.assert_array_equal(tres.bboxes.numpy(), np.asarray(jres.bboxes))
    np.testing.assert_allclose(tres.landmarks.numpy(), np.asarray(jres.landmarks), **TOL)


def test_classify_faces_and_metrics_match_jax():
    chips = _images(4, 16, seed=6)
    ind = np.array([True, True, False, True])
    for jsl, tsl, fn_j, fn_t in (
        (jsyn.synthetic_slices(("gender", "race", "age")), tsyn.synthetic_slices(("gender", "race", "age")),
         jsyn.synthetic_classifier(), tsyn.synthetic_classifier),
        (jattr.celeba_slices(), tattr.celeba_slices(),
         lambda c: jnp.tile(c.mean(axis=(1, 2)), (1, 27))[:, :80], lambda c: c.mean(dim=(1, 2)).tile(1, 27)[:, :80]),
    ):
        jout = jattr.classify_faces(fn_j, jnp.asarray(chips), jnp.asarray(ind), jsl)
        tout = tattr.classify_faces(fn_t, torch.from_numpy(chips), torch.from_numpy(ind), tsl)
        assert sorted(jout) == sorted(tout)
        for name in jout:
            np.testing.assert_array_equal(tout[name].preds.numpy(), np.asarray(jout[name].preds))
            np.testing.assert_allclose(tout[name].probs.numpy(), np.asarray(jout[name].probs), **TOL)
            np.testing.assert_allclose(tout[name].logits.numpy(), np.asarray(jout[name].logits), **TOL)
        probs = {k: np.asarray(v.probs) for k, v in jout.items()}
        preds = {k: np.asarray(v.preds) for k, v in jout.items()}
        assert tmetrics.multi_attr_metrics(probs, preds) == jmetrics.multi_attr_metrics(probs, preds)


def test_face_embeddings_and_search_match_jax():
    aligned = _images(3, 12, seed=7)
    backbone_j = lambda a: a.mean(axis=(1, 2)) + a[:, 0, :, :].mean(axis=1)
    backbone_t = lambda a: a.mean(dim=(1, 2)) + a[:, 0, :, :].mean(dim=1)
    jout, tout, jg, tg = _value_and_grad(
        lambda x: jff.face_embeddings(backbone_j, x), lambda x: tff.face_embeddings(backbone_t, x), aligned
    )
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(tg, jg, atol=1e-4, rtol=1e-5)
    feats = np.random.default_rng(8).normal(size=(6, 3)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    jidx, jrows = jff.FaceFeatsDB(jnp.asarray(feats), None, {}).semantic_search(jnp.asarray(jout))
    tidx, trows = tff.FaceFeatsDB(torch.from_numpy(feats), None, {}).semantic_search(torch.from_numpy(tout))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))


def _targets_preds():
    targets = {"gender": np.array([0, 1, -1, 1, 0]), "race": np.array([2, 2, 1, -1, 3])}
    preds = {"gender": np.array([0, 0, 1, 1, -1]), "race": np.array([2, 1, 1, 0, 3])}
    return targets, preds


def test_dynamic_weights_match_jax():
    targets, preds = _targets_preds()
    ind = np.array([True, True, True, False, True])
    factors = {"gender": 0.2, "race": 0.6}
    for no_face in (1.0, None):
        want = jweights.dynamic_weights_multi(
            jnp.asarray(ind), {k: jnp.asarray(v) for k, v in targets.items()},
            {k: jnp.asarray(v) for k, v in preds.items()}, factors, no_face_weight=no_face)
        got = tweights.dynamic_weights_multi(
            torch.from_numpy(ind), {k: torch.from_numpy(v) for k, v in targets.items()},
            {k: torch.from_numpy(v) for k, v in preds.items()}, factors, no_face_weight=no_face)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_face_region_grad_scale_matches_jax():
    """Identity forward; the image gradient is scaled inside the box
    intersection (the JAX custom_vjp and the port's autograd Function)."""
    targets, preds = _targets_preds()
    images = _images(5, 24, seed=9)
    boxes = np.array([[2, 3, 15, 20], [-1, -1, -1, -1], [0, 0, 30, 30], [5, 5, 10, 10], [4, 2, 20, 12]], np.int32)
    boxes_ori = np.array([[4, 1, 18, 16], [3, 3, 9, 9], [-1, -1, -1, -1], [6, 4, 22, 9], [0, 0, 24, 24]], np.int32)
    factors = {"gender": 0.2, "race": 0.6}
    jout, tout, jg, tg = _value_and_grad(
        lambda x: jweights.face_region_grad_scale_multi(
            x, jnp.asarray(boxes), jnp.asarray(boxes_ori), {k: jnp.asarray(v) for k, v in targets.items()},
            {k: jnp.asarray(v) for k, v in preds.items()}, factors),
        lambda x: tweights.face_region_grad_scale_multi(
            x, torch.from_numpy(boxes), torch.from_numpy(boxes_ori),
            {k: torch.from_numpy(v) for k, v in targets.items()},
            {k: torch.from_numpy(v) for k, v in preds.items()}, factors),
        images,
    )
    np.testing.assert_array_equal(tout, images)
    np.testing.assert_allclose(tg, jg, **TOL)


@pytest.mark.parametrize("factor", [0.2, 0.5, 1.5])
def test_single_attribute_dynamic_weights_match_jax(factor):
    """`dynamic_weights` (exp-1's one attribute), exact: 1 without a face or
    where the target keeps the prediction, else `factor`."""
    targets, preds = _targets_preds()
    ind = np.array([True, True, True, False, True])
    for name in ("gender", "race"):
        want = jweights.dynamic_weights(jnp.asarray(ind), jnp.asarray(targets[name]), jnp.asarray(preds[name]), factor)
        got = tweights.dynamic_weights(torch.from_numpy(ind), torch.from_numpy(targets[name]),
                                       torch.from_numpy(preds[name]), factor)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("factor", [0.1, 0.35, 1.5])
def test_single_attribute_face_region_grad_scale_matches_jax(factor):
    """`face_region_grad_scale`: identity forward, and its VJP scales the
    image gradient by `factor` inside the box intersection (a factor above
    1 too, which the multi-attribute rule would cap at 1); within TOL."""
    targets, preds = _targets_preds()
    images = _images(5, 24, seed=19)
    boxes = np.array([[2, 3, 15, 20], [-1, -1, -1, -1], [0, 0, 30, 30], [5, 5, 10, 10], [4, 2, 20, 12]], np.int32)
    boxes_ori = np.array([[4, 1, 18, 16], [3, 3, 9, 9], [-1, -1, -1, -1], [6, 4, 22, 9], [0, 0, 24, 24]], np.int32)
    for name in ("gender", "race"):
        t, p = targets[name], preds[name]
        jout, tout, jg, tg = _value_and_grad(
            lambda x: jweights.face_region_grad_scale(
                x, jnp.asarray(boxes), jnp.asarray(boxes_ori), jnp.asarray(t), jnp.asarray(p), factor),
            lambda x: tweights.face_region_grad_scale(
                x, torch.from_numpy(boxes), torch.from_numpy(boxes_ori), torch.from_numpy(t),
                torch.from_numpy(p), factor),
            images, seed=20,
        )
        np.testing.assert_array_equal(tout, images)
        np.testing.assert_array_equal(jout, images)
        np.testing.assert_allclose(tg, jg, **TOL)
        assert not np.allclose(tg, np.random.default_rng(20).normal(size=images.shape).astype(np.float32))


@pytest.mark.parametrize("with_db", [True, False])
def test_face_realism_loss_matches_jax(with_db):
    """`face_realism_loss`: against the original embedding where the
    identity is kept with confidence >= 0.9, else the database's top-1 match
    (the current embedding without a database); values, valid mask and the
    gradient of a weighted sum in the embeddings, within TOL."""
    rng = np.random.default_rng(21)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    emb, emb_ori, feats = unit(6, 8), unit(6, 8), unit(9, 8)
    ind = np.array([True, True, True, False, True, True])
    targets = np.array([1, 0, -1, 1, 2, 2])
    preds = np.array([1, 1, 0, 1, 2, 2])
    conf = np.array([0.95, 0.99, 0.97, 0.99, 0.5, 0.9], np.float32)
    w = rng.normal(size=6).astype(np.float32)
    jdb = jff.FaceFeatsDB(jnp.asarray(feats), None, {}) if with_db else None
    tdb = tff.FaceFeatsDB(torch.from_numpy(feats), None, {}) if with_db else None

    def jloss(e):
        return jlosses.face_realism_loss(e, jnp.asarray(emb_ori), jnp.asarray(ind), jnp.asarray(targets),
                                         jnp.asarray(preds), jnp.asarray(conf), jdb)

    jl, jv = jloss(jnp.asarray(emb))
    jg = jax.grad(lambda e: jnp.sum(jloss(e)[0] * w))(jnp.asarray(emb))
    te = torch.from_numpy(emb).requires_grad_()
    tl, tv = tlosses.face_realism_loss(te, torch.from_numpy(emb_ori), torch.from_numpy(ind),
                                       torch.from_numpy(targets), torch.from_numpy(preds), torch.from_numpy(conf), tdb)
    (tl * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg), **TOL)
    assert (tl.detach().numpy()[~np.asarray(jv)] == 0).all() and tl[0] != 0  # lane 0 against its original


def test_get_face_matches_jax():
    """`get_face`: a detector that reads the images (a face where an
    image's mean is above -0.5: lanes 0 and 2), then `analyze_faces`; chips
    and aligned faces and their image gradients within atol 1e-4, rtol 1e-5
    (the warps' bilinear weights), boxes and indicators exact."""
    boxes, lms, scores = _boxes(), _landmarks(4), np.array([0.9, 0.8, 0.7], np.float32)
    kw = dict(chip_size=32, aligned_size=24)

    def jdetect(x):
        ind = x.mean(axis=(1, 2, 3)) > -0.5
        return JDetections(ind, jnp.asarray(boxes), jnp.asarray(lms), jnp.asarray(scores))

    def tdetect(x):
        ind = x.mean(dim=(1, 2, 3)) > -0.5
        return tfaces.FaceDetections(ind, torch.from_numpy(boxes), torch.from_numpy(lms), torch.from_numpy(scores))

    images = _images(seed=22)
    images[1] -= 1.0
    for field in ("chips", "aligned"):
        jout, tout, jg, tg = _value_and_grad(
            lambda x: getattr(jfaces.get_face(x, jdetect, **kw), field),
            lambda x: getattr(tfaces.get_face(x, tdetect, **kw), field), images,
        )
        np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-5, err_msg=field)
        np.testing.assert_allclose(tg, jg, atol=1e-4, rtol=1e-5, err_msg=field)
    jres = jfaces.get_face(jnp.asarray(images), jdetect, **kw)
    tres = tfaces.get_face(torch.from_numpy(images), tdetect, **kw)
    np.testing.assert_array_equal(tres.indicators.numpy(), [True, False, True])
    np.testing.assert_array_equal(tres.indicators.numpy(), np.asarray(jres.indicators))
    np.testing.assert_array_equal(tres.bboxes.numpy(), np.asarray(jres.bboxes))
    np.testing.assert_allclose(tres.landmarks.numpy(), np.asarray(jres.landmarks), **TOL)


def test_losses_match_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(5, 2)).astype(np.float32)
    targets = np.array([0, 1, -1, 1, 0])
    ind = np.array([True, True, True, False, True])
    a, b = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2))
    jf, jv = jlosses.fair_ce_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(ind))
    tf, tv = tlosses.fair_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(ind))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tlosses.cosine_loss(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jlosses.cosine_loss(jnp.asarray(a), jnp.asarray(b))), **TOL)
    parts = {k: rng.normal(size=5).astype(np.float32) for k in ("loss_fair", "loss_clip", "loss_dino", "loss_face", "dynamic_w")}
    jout = jlosses.composite_loss(**{k: jnp.asarray(v) for k, v in parts.items()}, fair_valid=jnp.asarray(ind))
    tout = tlosses.composite_loss(**{k: torch.from_numpy(v) for k, v in parts.items()}, fair_valid=torch.from_numpy(ind))
    np.testing.assert_allclose(tout.total.numpy(), np.asarray(jout.total), **TOL)
    for k in jout.logs:
        np.testing.assert_allclose(tout.logs[k].numpy(), np.asarray(jout.logs[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("n,seed", [(4, 0), (24, 1), (24, 2)])
def test_binary_targets_match_jax(n, seed):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(size=n)
    probs = np.stack([1 - p1, p1], -1)
    probs[rng.uniform(size=n) < 0.2] = -1.0  # lanes without a face
    want, got = jtargets.binary_rank_targets(probs), ttargets.binary_rank_targets(probs)
    np.testing.assert_array_equal(got.targets, want.targets)
    np.testing.assert_array_equal(got.uncertainty, want.uncertainty)
    np.testing.assert_array_equal(
        ttargets.gate_targets_by_uncertainty(got, 0.2), jtargets.gate_targets_by_uncertainty(want, 0.2)
    )


def test_synthetic_stack_matches_jax():
    """The whole synthetic analysis at image size 128 (2x the detector's
    reference frame): attribute logits, face features and CLIP/DINO
    features, values and image gradients of a weighted sum of them."""
    jstack = jsyn.synthetic_stack(("gender",))
    tstack = tsyn.synthetic_stack(("gender",), db_feats=np.asarray(jstack.face_db.feats), device="cpu")
    np.testing.assert_allclose(tstack.face_db.feats.numpy(), np.asarray(jstack.face_db.feats), **TOL)
    images = _images(3, 128, seed=11)

    def summary(res, xp):
        cat = jnp.concatenate if xp is jnp else torch.cat
        return cat([res.attrs["gender"].logits, res.face_feats, res.clip_feats, res.dino_feats], -1)

    jout, tout, jg, tg = _value_and_grad(
        lambda x: summary(jstack.analyze(x), jnp), lambda x: summary(tstack.analyze(x), torch), images
    )
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=1e-4)
    jres, tres = jstack.analyze(jnp.asarray(images)), tstack.analyze(torch.from_numpy(images))
    np.testing.assert_array_equal(tres.faces.bboxes.numpy(), np.asarray(jres.faces.bboxes))
    np.testing.assert_array_equal(tres.faces.indicators.numpy(), np.asarray(jres.faces.indicators))
