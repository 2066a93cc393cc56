"""One fairdiff_torch exp-1 `train_step` against one JAX
`DebiasTrainer.train_step` at `SDConfig.tiny()` with a tiny
real-architecture guidance zoo: the detector (tiny config, its heads set so
that every lane detects a face, as bench.py sets them), MobileNetV3-Large,
the tiny CLIP-vision and DINOv2 (behind the `img_size_small` resize and
their own resizes, to CLIP's 28 and DINOv2's 224) and the tiny SFNet, with a face database. The same
seeded weights on both sides (`io.from_jax`), the same adapters, noises and
step count; float32 on the CPU. Unlike the synthetic stack, every loss term
here runs through a real model and its gradient reaches the images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fairdiff.guidance import attributes as jattr
from fairdiff.guidance import face_feats as jff
from fairdiff.models import clip_vision as jclip
from fairdiff.models import dinov2 as jdino
from fairdiff.models import face_detector as jdet
from fairdiff.models import mobilenet_v3 as jmnv3
from fairdiff.models import sfnet as jsfnet
from fairdiff.sampling import pipeline as jpipe
from fairdiff.training import debias as jdebias
from fairdiff.training import stack as jstack_lib
from fairdiff.utils import rng as jrng
from fairdiff_torch.guidance.attributes import celeba_slices
from fairdiff_torch.guidance.face_feats import FaceFeatsDB
from fairdiff_torch.io.from_jax import adapters_from_jax, load_jax_params
from fairdiff_torch.models import clip_vision as tclip
from fairdiff_torch.models import dinov2 as tdino
from fairdiff_torch.models import face_detector as tdet
from fairdiff_torch.models import mobilenet_v3 as tmnv3
from fairdiff_torch.models import sfnet as tsfnet
from fairdiff_torch.sampling import pipeline as tpipe
from fairdiff_torch.training import debias as tdebias
from fairdiff_torch.training import model_zoo as tzoo
from fairdiff_torch.training.stack import GuidanceStack
from fairdiff_torch.utils.tree import tree_leaves
from test_torch_trainer import CFG, COND, UNCOND, _jax_setup, _rel
from test_torch_zoo import zoo_tree

torch.set_num_threads(1)

SMALL = 32  # img_size_small, the chip and the aligned-face size


def _zoo_weights():
    det_cfg = jdet.DetectorConfig.tiny()
    nets = {
        "detector": (jdet.FaceDetectorNet(det_cfg), 64),
        "classifier": (jmnv3.MobileNetV3Large(num_classes=80), SMALL),
        "clip": (jclip.CLIPVisionModel(jclip.CLIPVisionConfig.tiny()), 28),
        "dino": (jdino.DINOv2Model(jdino.DINOv2Config.tiny()), 28),
        "face_embed": (jsfnet.SFNet(jsfnet.SFNetConfig.tiny()), SMALL),
    }
    trees = {k: zoo_tree(net, jnp.zeros((1, size, size, 3)), seed=20 + i)
             for i, (k, (net, size)) in enumerate(nets.items())}
    for head in chip_smoke.EVERY_LANE_DETECTS:
        node = trees["detector"][head]
        node["kernel"] = np.zeros_like(node["kernel"])
        node["bias"] = chip_smoke.every_lane_detects_bias(head, node["bias"].shape[0])
    db = np.random.default_rng(25).normal(size=(8, 32)).astype(np.float32)
    return det_cfg, {k: net for k, (net, _) in nets.items()}, trees, db


def _jax_stack(det_cfg, nets, trees, db):
    def feat(name, normalize, pick, size):
        def fn(p, images):
            x = jax.image.resize(normalize(images), (images.shape[0], size, size, 3), "bilinear")
            e = pick(nets[name].apply({"params": p}, x)).astype(jnp.float32)
            return e / jnp.linalg.norm(e, axis=-1, keepdims=True).clip(1e-6)
        return fn

    feats = jnp.asarray(db) / jnp.linalg.norm(jnp.asarray(db), axis=-1, keepdims=True)
    return jstack_lib.GuidanceStack(
        detect_fn=jdet.make_detect_fn(nets["detector"], det_cfg),
        classify_fn=lambda p, chips: nets["classifier"].apply({"params": p}, chips),
        slices=jattr.celeba_slices(),
        clip_feat_fn=feat("clip", jstack_lib.normalize_for_clip, lambda o: o["image_embeds"], 28),
        dino_feat_fn=feat("dino", jstack_lib.normalize_for_dino, lambda o: o, 224),
        face_embed_fn=lambda p, a: nets["face_embed"].apply({"params": p}, a),
        chip_size=SMALL, aligned_size=SMALL, img_size_small=SMALL,
        params={**trees, "face_db": jff.FaceFeatsDB(feats, jnp.zeros(8, jnp.int32), {})},
    )


def _port_stack(trees, db):
    frozen = lambda module, name: load_jax_params(module, trees[name]).eval().requires_grad_(False)
    det = frozen(tdet.FaceDetectorNet(tdet.DetectorConfig.tiny()), "detector")
    feats = torch.from_numpy(db)
    return GuidanceStack(
        detect_fn=tdet.make_detect_fn(det, tdet.DetectorConfig.tiny()),
        classify_fn=frozen(tmnv3.MobileNetV3Large(80), "classifier"),
        slices=celeba_slices(),
        clip_feat_fn=tzoo.clip_feature_fn(frozen(tclip.CLIPVisionModel(tclip.CLIPVisionConfig.tiny()), "clip")),
        dino_feat_fn=tzoo.dino_feature_fn(frozen(tdino.DINOv2Model(tdino.DINOv2Config.tiny()), "dino")),
        face_embed_fn=frozen(tsfnet.SFNet(tsfnet.SFNetConfig.tiny()), "face_embed"),
        face_db=FaceFeatsDB(feats / feats.norm(dim=-1, keepdim=True), torch.zeros(8, dtype=torch.int32), {}),
        chip_size=SMALL, aligned_size=SMALL, img_size_small=SMALL,
    )


def test_train_step_with_real_zoo_matches_jax_trainer():
    """One exp-1 step (4 lanes, micro-batch 2, 2 denoising steps, linearized
    phase 4) on both sides. Targets exact; per leaf the grads within 2e-4
    relative L2 and the updated adapters and EMA within 1e-7 + 1e-6 relative,
    as the synthetic-stack test (fp32 summation-order noise through the tiny
    SD models, the sampler and now the zoo); the logged losses within 1e-4
    relative."""
    det_cfg, nets, trees, db = _zoo_weights()
    _, params, _, jstate = _jax_setup()
    jtr = jdebias.DebiasTrainer(jpipe.StableDiffusion(jpipe.SDConfig.tiny()), params,
                                _jax_stack(det_cfg, nets, trees, db), jdebias.DebiasConfig(**CFG))
    jtr.keep_pair_inputs = True
    key = jax.random.key(42)
    jnew, jlogs = jtr.train_step(jstate, (jnp.asarray(COND), jnp.asarray(UNCOND)), key)
    noises = np.asarray(jtr._last_pair_inputs["noises"])
    n_steps = jrng.sample_num_denoising_steps(key, 0, 2, 2)

    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").load_jax(params)
    ttr = tdebias.DebiasTrainer(tsd, _port_stack(trees, db), tdebias.DebiasConfig(**CFG))
    tstate = ttr.init_state(adapters=adapters_from_jax(jstate.adapters))
    tnew, tlogs = ttr.train_step(tstate, (COND, UNCOND), noises=noises, n_steps=n_steps)

    assert tlogs["face_rate"] == jlogs["face_rate"] == 1.0
    for a, v in jtr._last_pair_inputs["targets"].items():
        np.testing.assert_array_equal(ttr._last_targets[a].numpy(), np.asarray(v))
    jg, tg = tree_leaves(jtr._last_grads), tree_leaves(ttr._last_grads)
    assert len(jg) == len(tg) > 0 and any(float(np.abs(g).max()) > 0 for g in jg)
    for j, t in zip(jg, tg):
        assert _rel(t.numpy(), j) < 2e-4
    for jtree, ttree in ((jnew.adapters, tnew.adapters), (jnew.ema, tnew.ema)):
        for j, t in zip(tree_leaves(jtree), tree_leaves(ttree)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-7, rtol=1e-6)
    for k in ("train_loss", "train_loss_fair", "train_loss_face", "train_loss_CLIP", "train_loss_DINO",
              "grad_norm"):
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-7), k
