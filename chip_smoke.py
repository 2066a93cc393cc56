#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (fairdiff_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: name, power limit, TF32 off for matmuls and convolutions;
  2. build: the three CUDA sources of fairdiff_torch/csrc with nvcc (sm_90a)
     and the host codec (csrc/imageio.cpp) with c++, all started together;
     then imageio: the codec without PIL on the committed fixtures
     (PIL-written JPEGs decoded to PIL's pixels exactly, the encoder's
     quality-95 bytes against PIL's, an entropy byte flipped and the restart
     markers stripped as controls that must fail), and the batch loader's
     img/s at 512 x 112x112 on JPEG and filtered PNG beside the numpy loader
     it replaced, with the host's core count; then emd: the native EMD
     solver (csrc/emd.cpp, built with the codec) on the committed plans of
     the JAX package's native solver, bit-equal (ties included), the two
     saturated target cases' targets equal and uncertainties within 1e-12,
     controls that must fail (a NaN cost and a mass mismatch raise; a plan
     with two rows swapped fails the comparison), and `emd_batch` ms on both
     routes at exp-3's and exp-6's shapes, with the host's core count;
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     the shapes the SD-1.5 path gives it (CFG batch of N=2 images; K1 also
     at [8,576,8,160], the 1280-channel blocks at 768 px, and at the
     short-key shapes, the masked K1 with eos key masks), both against an
     fp32 reference, with a dropped-tile control, K1 run twice (bit-equal),
     and with kernel, plain and library times, the datasheet bound and the
     kernel's factor over both;
  4. one full-width SD-1.5 UNet forward in fp32 on the card (kernels)
     against the same weights and inputs on the CPU (plain versions), then
     the same forward in bf16 on the card, kernels against the plain routes;
     then unet-768: a bf16 CFG forward at 768 px (sample_size 96, 2 rows)
     with the same limits against the plain routes' fp32 output, 32 K1
     launches (17 short-key or masked) of which 12 at head dim 160, then a
     merged pair VJP on those
     2 rows with phase 12's limits: 14 K6 launches, 5 at head dim 160, each
     held to its plain version, no K2 or K3;
  5. the slice: `fairdiff_torch.tools.gen_images.main` at full width on
     random weights, 2 prompts x 2 images, batch 2, 30 steps, with the
     kernel launch counts checked against 32 K1 (22 short-key or masked)
     and 16 GEGLU per UNet call; its `img_j.jpg` files read back by the port's decoder;
  6. throughput: one 50-step CFG generate at batch 4, in img/s;
  7. kernels-bwd: the training kernels K1 with lse, K2 (dq), K3 (dk/dv) and
     K5 (GEGLU dx), bf16 and fp32, each against its plain version at the
     phase-4 shapes (a pair VJP's CFG batch of 2p = 8 rows; the flash
     kernels also at [8,576,8,160], where K6 runs 64-key blocks)
     and a ragged shape, with phase 3's limits and dropped-tile controls, K1
     with lse, K2, K3, K5 and K6 each run twice (o, lse, dq, dk, dv, dx
     bit-equal; K6's dq within its summation order), and with kernel, plain
     and library times, the bound and the kernel's factor over both (K5's
     dproj and split-K bytes logged beside the bound; K6 also timed alone,
     without its wrapper's delta, zeroed buffer and cast, and beside the
     split route);
  8. unet-vjp: one full-width SD-1.5 pair VJP (8 rows, bf16, remat), every
     K2, K3 and K5 launch held against its plain version on its operands,
     the context gradient against the plain routes and an fp32 run, launch
     counts and peak memory;
  9. train: `fairdiff_torch.tools.train_debias.main` at full width for 2
     optimizer steps (4 lanes, micro-batch 2, 4 denoising steps): finite
     non-zero grads, moved adapters, logged losses, exact launch counts;
 10. train-step: one timed exp-1 step after a warm-up step (24 lanes,
     micro-batch 4, 19 denoising steps): s/step, the phase split, peak
     memory;
 11. kernels-gn: K7 (GroupNorm+SiLU) through `FusedGroupNorm`, forward and
     backward, at every distinct GroupNorm shape of one SD-1.5 CFG UNet call
     at batch 8, bf16 and fp32, against its plain version with phase 3's
     limits, a control that leaves the last CTA's slice of rows out of the
     statistics and a bit-equal rerun, with times beside F.group_norm (+
     F.silu) (phase 7 also holds K6, the merged backward, against its plain
     version and K2/K3);
 12. unet-vjp-merged: phase 8 with flash_bwd="merged": K6 9 launches, K2
     and K3 none, the context gradient against the plain routes and fp32;
 13. zoo: each real-architecture guidance model (detector, MobileNetV3,
     CLIP-ViT-H/14, DINOv2 ViT-B/14, SFNet-20) at full width, bf16 against
     fp32 on the card; the detector on assets/detector.npz, card vs CPU;
 14. train-zoo: phase 10 with bench.py's filled real-architecture zoo, at
     8 lanes;
 15. train-cli-zoo: phase 9 with --guidance_dir (a directory the phase
     writes) and --flash_bwd merged: K6 launch counts, moved adapters;
 16. train-exp3: phase 10 for exp-3 (gender x race, sampled OT with 200
     draws; 16 lanes, micro-batch 4, 19 denoising steps, synthetic stack):
     s/step, the phase split with phase 2 on its own line (its OT problems
     all on the native EMD solver), peak memory,
     exact launch counts, finite non-zero grads, a lane with a target for
     each attribute, race_gap and gender_race_gap logged;
 17. train-exps: phase 9 for exp-2 to exp-6 at 2 denoising steps (exp-3 to
     exp-6: every OT problem on the native EMD solver; exp-2: the exported prefix
     table moved and `gen_images` reads it back; exp-5: two prompt files
     the phase writes, repeats 1 and 6);
 18. unet-vjp-lora: phase 8 with a rank-4 UNet LoRA through the merged
     weights: the LoRA and context gradients with remat on against off
     (rel L2 1e-3) and against the plain routes and fp32, exact launch
     counts (K1 with lse, K2 and K3 at all 10 flash sites), kernel time,
     idle share, peak memory with remat on and off;
 19. train-lifecycle: `train_debias.main` on a config file the phase
     writes (UNet and text-encoder LoRA; 2 denoising steps), 4 steps unbroken against 2 steps
     resumed to 4 from a checkpoint (adapters, EMA, AdamW moments, step,
     update count and prompt order), evaluation of the adapters and their
     EMA every 2 steps (metrics.jsonl, grids), `export_checkpoint` (.npz,
     .pth) and `gen_images` reading unet_lora.pth, exact launch counts;
 20. train-unet-lora: phase 10 with the UNet LoRA trained too, at 8 lanes;
 21. weights: real-weight loading at full width through the reference's
     file layouts: SD-1.5 (the seed `[slice]` uses) written as diffusers
     files, `convert_sd`, the loaded weights bit-equal to the init,
     `gen_images --model_dir` JPEGs byte-equal to `[slice]`'s with its launch
     counts; CLIP-ViT-H/14 and DINOv2 in the HF layouts and a det_10g-shaped
     SCRFD `.onnx` through `convert_guidance`, SCRFD on the card against the
     CPU (fp32, rel L2 1e-4, equal faces), `load_guidance_stack` with CLIP,
     DINO and SCRFD composed over FaceDetectorNet, and `train_debias
     --model_dir --guidance_dir` as phase 9 with the CLIP and DINO terms;
     the write, convert and load seconds; with `[tokenizer]`'s directory,
     `gen_images --model_dir --tokenizer_dir` byte-equal to its JPEGs and the
     train run tokenizing with it;
 22. tokenizer (before weights): a CLIP tokenizer directory in the published
     layout (49408 entries, merges learned from the phases' prompts), then
     `gen_images --tokenizer_dir` ([slice]'s settings) at full width,
     `transformers` never imported ([weights] trains with the directory);
 23. eval: the reference's bias-evaluation protocol: `gen_images` at its
     defaults but 30 images a prompt (2 prompts, 512x512, batch 10, 30 steps) and 64
     `render_face_scene_dr` scenes at 128 px, each folder scored by
     `eval_images` at batch 32 (SCRFD composed over assets/detector.npz,
     three seeded MobileNetV3-Large heads): pickles' shapes and dtypes, faces
     in at least half of the face scenes, card vs CPU on the first 32 of each
     folder (indicators equal, boxes within 1e-3 px, logits rel L2 1e-4),
     decode and scoring times;
 24. unet-vjp-recompute: phase 8 with flash_bwd="recompute": K1 without lse
     only (20 launches), the context gradient against the plain routes, fp32
     and the split route, wall, kernel time and peak memory beside phase 8's;
 25. train-profile: `train_debias --profile_steps 1` as phase 9: the
     profiled step's trace, summed by `utils.trace_summary`, holds as many
     flash-fwd, flash-dq, flash-dkv and GEGLU kernels as the launch counters
     counted; the device total against the step's wall;
 26. facerec: the face-recognition path at full width on data the phase
     draws (8631 one-face class folders of 112x112 JPEGs at quality 95, the
     port's encoder, listed by
     `create_facerec_list`, 256 verification pairs, 512 IJB loose crops with
     5-point landmarks): `train_facerec` on vggface2_sfnet20_sphereface.yml
     through base.yml (sfnet20_deprecated, SphereFace, batch 512, head
     [512, 8631]) for 10 steps with validation and checkpoints at 5 and 10:
     s/step with and without the loader, the loader's img/s alone, peak
     memory; two steps at batch 16 from the trained weights on the card and
     the CPU (loss and every leaf within 1e-3) and the first step's gradients
     at the seeded init against fp64 (the card's worst leaf within 1.5x the
     CPU's); IResNet-100 for 3 steps at batch 256 with an MS1M head; all 11
     heads at x [512, 512], w [512, 8631] on the card and the CPU (1e-4);
     `eval_facerec` with the trained weights (img/s, metrics), and at a small
     size on the card and the CPU (metrics within 1e-6);
 27. detector: `train_detector` at the shipped recipe's shapes for 100 steps
     (mining from step 40): s/step without and with mining, a falling finite
     loss; `eval_detector` on assets/detector.npz at 256 scenes a shift on the
     card beside docs/DETECTOR.md's table, and at 32 on the card and the CPU
     (rates within 1/32);
 28. mesh (after facerec): at SD-1.5 width, exp-1 (4 lanes, micro-batch 2,
     4 denoising steps): a 1x1 mesh on NCCL at world size 1 bit-equal to the
     same step without a mesh; `train_debias --distributed 1
     --num_processes 1 --mesh_data 1` over a tcp rendezvous; two ranks on
     the one card over gloo (data=2, 2 lanes each), their all-reduced
     gradients at most 1.5x as far from the one-process step as the same
     step re-chunked, and each rank's own gradients at most 1.5x as far from
     the fp32 one-process step over its lanes as the bf16 one-process step's
     share of those lanes (the ranks' lanes swapped must fail); inside facerec, `train_facerec
     --data_mesh 2` at batch 512 as two gloo ranks against one process
     (every leaf within 1e-3);
 29. tp: model=2 as two gloo ranks on the card against the replicated model
     and its fp32 twin: the CFG UNet forward at 2 rows and the text encoder
     as the bf16 UNet parity holds them, K1 at 4 local heads per launch, one
     pair VJP's LoRA gradients (1.25x the replicated error against fp32);
 30. tools: bench_gen (batches 10, 16), bench_attention (and --grad),
     bench_geglu, roofline (flash, programs, report), tp_scaling
     (trainer_pair at lanes 4-24, unet_vjp), setup_data (synthesize, check),
     convergence_demo (20 steps on the card) and plot_curves, each with its
     kernel launches and a JSON row with the card's name and power limit.

The line before the last is the card's name and power limit from
nvidia-smi; the one before that is the per-kernel JSON summary; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import torch

from fairdiff_torch.bench import EVERY_LANE_DETECTS, every_lane_detects_bias, filled_zoo_stack
from fairdiff_torch.tools.roofline import bound, flash_bound, time_ms

# peak rates and bounds: the roofline tool's, so its flash rows and this
# script's `bound_ms` are one computation
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (datasheet); facerec runs fp32 without TF32
N_IMAGES = 2  # CFG batch 2N = 4 in phase 3
# phase-4 shapes: a pair VJP's CFG batch, 2p = 8 rows (exp-1 micro-batch 4)
PAIR_ROWS = 8

# bf16 kernel vs its plain version on the same inputs. Both round their
# output to bf16 and round the probabilities (K1) or the projection (K4) at
# different points, so they differ by bf16 rounding noise: ~2e-3 of the
# output's scale. The limits are stated against that scale, not in absolute
# units, because K1's outputs at 4096 keys are only ~0.03 in size:
#   every element |got - ref| <= ELEM_ATOL_RMS * rms(ref) + ELEM_RTOL * |ref|;
#   the whole output ||got - ref|| / ||ref|| <= KERNEL_REL_L2_TOL;
#   against an fp32 reference on the same inputs, the kernel's rel L2 error
#   is at most ACCURACY_RATIO times the plain bf16 version's.
# A control drops the last tile (the kernel's last key tile for K1, its last
# 64-deep K slot of d for K4) from the plain version; its rel L2 must exceed
# KERNEL_REL_L2_TOL, so the check is shown to see a kernel that skips a tile.
ELEM_ATOL_RMS = 0.1
ELEM_RTOL = 1e-2
KERNEL_REL_L2_TOL = 1e-2
ACCURACY_RATIO = 1.5
# fp32 UNet, card vs CPU: the same maths summed in different orders through
# ~100 layers of random weights
UNET_REL_L2_TOL = 1e-3
# bf16 UNet on the card, kernels vs the plain routes on the same weights
# and inputs, each launch also held against its plain version with the
# limits above. Against the fp32 output both routes carry bf16 noise of
# ~1.5e-2 (NVIDIA H100 80GB HBM3: kernels 1.457e-2, plain 1.466e-2) and
# differ from each other by ~1.5e-2; attention that drops its last 64-key
# tile reads 1.93e-2, 1.31x the plain route's error. So the whole output
# is held to a sanity bound on kernels vs plain and to an error against
# fp32 of at most 1.1x the plain route's, which the dropped-tile control
# must break.
UNET_BF16_REL_L2_TOL = 3e-2
UNET_BF16_ACCURACY_RATIO = 1.1
# the timed steps of [train-zoo] and [train-unet-lora] at 8 lanes and of
# [train-exp3] at 16 (their presets: 24 and 32), cut to keep the script
# inside its time limit with [mesh], [tp] and [tools]; [train-step] keeps
# exp-1's 24
CUT_LANES = 8
CUT_LANES_EXP3 = 16
# and likewise [train-exps] and [train-lifecycle] at 2 denoising steps (were
# 4), [eval] at 30 images a prompt (the protocol's 60) and [facerec]'s
# training run at 10 steps (was 20)
CUT_DENOISING_STEPS = 2
CUT_FACEREC_STEPS = 10
# one no-grad CFG UNet call at 512 px (phases 1 and 3, generation): every
# attention takes K1 (`models/layers.py attention_route`), the 10
# self-attentions over 4096 and 1024 tokens and, short-key or masked, the 6
# over 256 and 64 tokens and the 16 masked cross-attentions over 77 keys
UNET_CALL_LAUNCHES = {"flash_attention": 32, "flash_attention_short": 22, "geglu": 16}


def key_tile(d: int) -> int:
    """Keys a tile of the query-block kernels' K/V ring at head dim `d`
    (csrc/flash_attention.cu `qb::KEY_TILE`): 128 up to 80, 64 above. The
    dropped-tile controls of o and dq drop the kernel's last tile."""
    return 128 if d <= 80 else 64


def kept_keys(t: int, tile: int = 64) -> int:
    """The keys a dropped-tile control keeps: all but the last `tile`-key
    tile, or, where the keys fit one tile (the 77-key cross-attention, the
    64-token mid block), all but the keys past the first 64, or past half."""
    return (t - 1) // tile * tile or (t - 1) // 64 * 64 or t // 2


def plain_attention(q, k, v, flash_bwd="split", key_mask=None):
    """The plain version in the kernels' place (`routes`)."""
    from fairdiff_torch.ops import flash_attention as fa

    return fa.flash_attention_plain(q, k, v, key_mask)


def drop_last_tile(q, k, v, flash_bwd="split", key_mask=None):
    """The dropped-tile control in the kernels' place (`routes`): the plain
    version over `kept_keys` of the keys."""
    from fairdiff_torch.ops import flash_attention as fa

    last = kept_keys(k.shape[1])
    mask = None if key_mask is None else key_mask[:, :last]
    return fa.flash_attention_plain(q, k[:, :last].contiguous(), v[:, :last].contiguous(), mask)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def compare(got: torch.Tensor, ref: torch.Tensor, exact: torch.Tensor,
            dropped: torch.Tensor | None = None, control_by_accuracy: bool = False) -> dict:
    """Kernel output `got` against the plain version `ref` (same inputs and
    type), both against the fp32 reference `exact`, and the dropped-tile
    control `dropped`, where given, against `ref`: it must break the rel L2
    limit, or, with `control_by_accuracy`, the rel L2 limit or the accuracy
    ratio against `exact` (the two limits every kernel output is held to).
    `failed` names the limits that broke."""
    g, r = got.float(), ref.float()
    rms = r.pow(2).mean().sqrt().item()
    diff = (g - r).abs()
    elem_use = (diff / (ELEM_ATOL_RMS * rms + ELEM_RTOL * r.abs())).max().item()
    out = dict(
        max_abs_err=diff.max().item(), ref_rms=rms, elem_use=elem_use,
        rel_l2=rel_l2(got, ref), kernel_vs_f32=rel_l2(got, exact),
        plain_vs_f32=rel_l2(ref, exact),
        control_rel_l2=None if dropped is None else rel_l2(dropped, ref),
        control_vs_f32=None if dropped is None else rel_l2(dropped, exact),
    )
    control_seen = dropped is None or out["control_rel_l2"] > KERNEL_REL_L2_TOL or (
        control_by_accuracy and out["control_vs_f32"] > ACCURACY_RATIO * out["plain_vs_f32"])
    out["failed"] = [
        name for name, ok in (
            ("finite", bool(torch.isfinite(g).all())),
            ("element", elem_use <= 1.0),
            ("rel L2", out["rel_l2"] <= KERNEL_REL_L2_TOL),
            ("accuracy", out["kernel_vs_f32"] <= ACCURACY_RATIO * out["plain_vs_f32"]),
            ("control", control_seen),
        ) if not ok
    ]
    return out


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} | nvidia-smi: {smi_name_power()} | count {torch.cuda.device_count()}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name


def phase_build() -> None:
    from fairdiff_torch.kernels import build

    seconds = build.build(build.KERNELS + build.HOST_LIBRARIES)
    log(f"[build] {', '.join(build.KERNELS)} for sm_90a (nvcc) and {', '.join(build.HOST_LIBRARIES)} for the host "
        f"(c++), all started together: " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name in build.KERNELS:
        lib = build.library_path(name)
        log_file = lib.with_name(lib.name + ".log")
        for line in log_file.read_text().splitlines() if log_file.exists() else []:
            if "registers" in line or "spill" in line or "wgmma" in line:  # ptxas serialising wgmma warns
                log(f"[build] {name}: {line.strip()}")


IMAGEIO_FIXTURES = Path(__file__).resolve().parent / "fairdiff_torch" / "testdata" / "imageio_fixtures.npz"
IMAGEIO_BATCH = 512  # sfnet20's batch of 112x112 faces
IMAGEIO_THREADS = 8  # the loader's default
IMAGEIO_JPEG_ERR = 6.0  # mean |decoded - drawn| of a quality-95 face, of 255 (noise and 4:2:0 chroma: ~3)


def write_filtered_png(pixels, path: Path) -> None:
    """[H, W, 3] uint8 as an RGB PNG whose every row takes the filter with
    the least sum of |signed residual| (libpng's heuristic, which PIL's PNGs
    carry), zlib level 6: what the loader meets in a PNG dataset."""
    import numpy as np

    h, w, _ = pixels.shape
    rows = pixels.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), rows[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int16), rows[:, :-3]], axis=1)
    upleft = np.concatenate([np.zeros((h, 3), np.int16), up[:, :-3]], axis=1)
    p_ = left + up - upleft
    pa, pb, pc = np.abs(p_ - left), np.abs(p_ - up), np.abs(p_ - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = np.stack([rows, rows - left, rows - up, rows - (left + up) // 2, rows - paeth]).astype(np.uint8)
    cost = np.abs(cands.astype(np.int8).astype(np.int32)).sum(-1)  # [5, h]
    kind = cost.argmin(0)
    raw = np.concatenate([kind[:, None].astype(np.uint8), cands[kind, np.arange(h)]], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _plain_png_batch(paths, threads: int):
    """The numpy loader the port had before its codec: the Python PNG
    decoder, (u8 - 127.5) / 127.5, on a thread pool (size-matched files)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from fairdiff_torch.io.images import decode_png

    def one(path):
        return (decode_png(Path(path).read_bytes(), str(path)).astype(np.float32) - np.float32(127.5)) / np.float32(127.5)

    with ThreadPoolExecutor(threads) as pool:
        return np.stack(list(pool.map(one, paths)))


def _loader_rate(fn, n: int) -> float:
    """img/s of `fn()` (which loads n images): the median of 3 timed calls
    after one warm call."""
    import numpy as np

    fn()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return n / float(np.median(times))


def strip_png_chunk(data: bytes, tag: bytes) -> bytes:
    """PNG bytes without their chunks of type `tag` (at least one)."""
    out, pos = data[:8], 8
    while pos < len(data):
        n = 12 + struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] != tag:
            out += data[pos:pos + n]
        pos += n
    assert len(out) < len(data), f"no {tag!r} chunk to strip"
    return out


def phase_imageio(power: str) -> dict:
    """[imageio]: the host codec (csrc/imageio.cpp) on the card's host, no
    PIL and no libpng. Every committed JPEG fixture (PIL-written: 4:4:4,
    4:2:2, 4:2:0, grey, progressive, restart markers, optimised tables, Adobe
    RGB, odd sizes; cv2-written 4:4:0, baseline and progressive) decodes to
    PIL's stored pixels exactly; every PNG fixture (sBIT, sRGB and gAMA near
    1/2.2, sRGB/gAMA precedence, ancillary chunks with a bad CRC, an sRGB
    ICC profile, a rejected one, a palette longer than its bit depth allows,
    an Adler-32 libpng never reaches) decodes under "native" to the native
    loader's (libpng's) stored pixels exactly; the encoder's quality-95 file
    against PIL's bytes (equal, else the pixel error of the two decoded, at
    most 1); five corrupted fixtures, one entropy-coded byte flipped, the
    restart markers stripped, a PNG's sBIT, another's gAMA and a third's
    iCCP stripped, each of which must fail its check; then the
    batch loader at 512 x 112x112 (sfnet20's batch) on JPEG (quality 95) and
    on libpng-filtered PNG, against the numpy loader it replaced (PNG only:
    that loader read JPEG through PIL), with the host's core count."""
    import numpy as np

    from fairdiff_torch.facerec.datasets import load_batch
    from fairdiff_torch.io import imageio

    t_start = time.perf_counter()
    failed = []
    fx = dict(np.load(IMAGEIO_FIXTURES))
    names = sorted(k[:-4] for k in fx if k.endswith(".jpg"))
    pngs = sorted(k[:-4] for k in fx if k.endswith(".png"))

    def decodes_exactly(data: bytes, want, convention: str = "pil") -> tuple[bool, str]:
        try:
            got = imageio.decode(data, convention)
        except OSError as err:
            return False, f"raises ({err})"
        if got.shape != want.shape:
            return False, f"shape {got.shape}"
        diff = int(np.abs(got.astype(np.int16) - want).max())
        return diff == 0, f"max |diff| {diff}"

    results = {n: decodes_exactly(fx[f"{n}.jpg"].tobytes(), fx[f"{n}.pixels"]) for n in names}
    log(f"[imageio] {len(names)} fixtures decoded against PIL's pixels (exact): "
        + ", ".join(f"{n} {ok}" for n, (ok, _) in results.items()))
    failed += [f"fixture {n}: {why}" for n, (ok, why) in results.items() if not ok]
    png_results = {n: decodes_exactly(fx[f"{n}.png"].tobytes(), fx[f"{n}.native"], "native") for n in pngs}
    log(f"[imageio] {len(pngs)} PNG fixtures decoded under \"native\" against the native loader's pixels (exact): "
        + ", ".join(f"{n} {ok}" for n, (ok, _) in png_results.items()))
    failed += [f"PNG fixture {n}: {why}" for n, (ok, why) in png_results.items() if not ok]

    source, want_bytes = fx["encode.source"], fx["encode.q95"].tobytes()
    got_bytes = imageio.encode_jpeg(source, 95)
    pixel_err = int(np.abs(imageio.decode(got_bytes).astype(np.int16) - imageio.decode(want_bytes)).max())
    log(f"[imageio] encoder, {source.shape[0]}x{source.shape[1]} at quality 95: "
        + ("bytes equal to PIL's" if got_bytes == want_bytes else f"bytes differ from PIL's, decoded max |diff| {pixel_err}"))
    if got_bytes != want_bytes and pixel_err > 1:
        failed.append(f"encoder: decoded max |diff| {pixel_err}")

    # controls: a corrupted file must fail the decode check
    data = bytearray(fx["420_q95.jpg"].tobytes())
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    at = next(i for i in range((start + len(data)) // 2, len(data) - 2)
              if data[i - 1] != 0xFF and data[i] != 0xFF and data[i] ^ 0x5A != 0xFF)
    data[at] ^= 0x5A
    flipped = decodes_exactly(bytes(data), fx["420_q95.pixels"])
    raw = fx["restart_q80.jpg"].tobytes()
    sos = raw.index(b"\xff\xda")
    n_restarts = len(re.findall(rb"\xff[\xd0-\xd7]", raw[sos:]))
    stripped_bytes = raw[:sos] + re.sub(rb"\xff[\xd0-\xd7]", b"", raw[sos:])
    stripped = decodes_exactly(stripped_bytes, fx["restart_q80.pixels"])
    log(f"[imageio] controls: 420_q95 with entropy byte {at} flipped: {flipped[1]}; restart_q80 with its "
        f"{n_restarts} restart markers stripped: {stripped[1]} (each must fail)")
    no_sbit = decodes_exactly(strip_png_chunk(fx["f2_rgb16_sbit8.png"].tobytes(), b"sBIT"),
                              fx["f2_rgb16_sbit8.native"], "native")
    no_gama = decodes_exactly(strip_png_chunk(fx["f1_rgb16_adam7_gama43200.png"].tobytes(), b"gAMA"),
                              fx["f1_rgb16_adam7_gama43200.native"], "native")
    no_iccp = decodes_exactly(strip_png_chunk(fx["f6_rgb16_iccp_srgb.png"].tobytes(), b"iCCP"),
                              fx["f6_rgb16_iccp_srgb.native"], "native")
    log(f"[imageio] controls: f2_rgb16_sbit8 without its sBIT: {no_sbit[1]}; f1_rgb16_adam7_gama43200 without its "
        f"gAMA: {no_gama[1]}; f6_rgb16_iccp_srgb without its iCCP: {no_iccp[1]} (each must fail)")
    failed += [f"control {n} passed the decode check" for n, r in (
        ("flipped", flipped), ("stripped", stripped), ("no sBIT", no_sbit), ("no gAMA", no_gama),
        ("no iCCP", no_iccp)) if r[0]]

    # the loader on the card's host
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    cores = os.cpu_count()
    rates: dict = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        rng = np.random.default_rng(7)
        ident = np.arange(IMAGEIO_BATCH)
        faces = draw_faces(rng, ident, face_identities(IMAGEIO_BATCH, 8), jittered_landmarks(rng, IMAGEIO_BATCH), 112)
        jpgs = [str(Path(tmp) / f"{i}.jpg") for i in ident]
        pngs = [str(Path(tmp) / f"{i}.png") for i in ident]
        t0 = time.perf_counter()
        write_images(list(zip(map(Path, jpgs), faces)), threads=IMAGEIO_THREADS)
        t_jpg = time.perf_counter() - t0
        for path, img in zip(pngs, faces):
            write_filtered_png(img, Path(path))
        size_jpg = sum(Path(p).stat().st_size for p in jpgs) / IMAGEIO_BATCH
        size_png = sum(Path(p).stat().st_size for p in pngs) / IMAGEIO_BATCH
        got_j = load_batch(jpgs, (112, 112), n_threads=IMAGEIO_THREADS)
        got_p = load_batch(pngs, (112, 112), n_threads=IMAGEIO_THREADS)
        jpeg_err = float(np.abs(got_j - (faces.astype(np.float32) - 127.5) / 127.5).mean() * 127.5)
        rates = {
            "jpeg": _loader_rate(lambda: load_batch(jpgs, (112, 112), n_threads=IMAGEIO_THREADS), IMAGEIO_BATCH),
            "png": _loader_rate(lambda: load_batch(pngs, (112, 112), n_threads=IMAGEIO_THREADS), IMAGEIO_BATCH),
        }
        t0 = time.perf_counter()  # the numpy loader: one call (no warm-up to amortise)
        plain_p = _plain_png_batch(pngs, IMAGEIO_THREADS)
        rates["png_plain"] = IMAGEIO_BATCH / (time.perf_counter() - t0)
        png_equal = bool(np.array_equal(got_p, plain_p))
    log(f"[imageio] loader, {IMAGEIO_BATCH} x 112x112 faces, {IMAGEIO_THREADS} threads on a host of {cores} cores "
        f"(card {power}): JPEG q95 ({size_jpg / 1024:.1f} KiB, {IMAGEIO_BATCH} written by the port's encoder in "
        f"{t_jpg:.2f} s) {rates['jpeg']:.1f} img/s; filtered PNG ({size_png / 1024:.1f} KiB) {rates['png']:.1f} "
        f"img/s, the numpy loader {rates['png_plain']:.1f} img/s ({rates['png'] / rates['png_plain']:.1f}x), "
        f"equal outputs {png_equal}; JPEG q95 vs the drawn pixels mean |err| {jpeg_err:.3f} of 255")
    if not png_equal or jpeg_err > IMAGEIO_JPEG_ERR:
        failed.append(f"loader: PNG equal to the numpy loader {png_equal}, JPEG mean |err| {jpeg_err}")
    log(f"[imageio] {time.perf_counter() - t_start:.1f} s")
    if failed:
        raise AssertionError(f"[imageio] failed: {failed}")
    return dict(rates, cores=cores)


EMD_FIXTURES = Path(__file__).resolve().parent / "fairdiff_torch" / "testdata" / "emd_fixtures.npz"
EMD_UNC_ATOL = 1e-12  # the same float64 sums over the same plans
EMD_DRAWS = 200  # exp-3's OT draws a step (100 a device, 2 devices)


def _emd_ms(fn) -> float:
    """ms of `fn()`: the median of 5 calls after one warm call."""
    import numpy as np

    fn()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_emd(power: str) -> dict:
    """[emd]: the native EMD solver (csrc/emd.cpp through fairness/emd.py)
    on the card's host, no JAX. Every committed fixture (plans the JAX
    package's native solver wrote: the saturated exp-3 and exp-6 target
    cases, identical rows at 8 and 16 lanes, exp-3's 200 draws x 8 classes
    and exp-6's enumerated combinations at 16 lanes, 20 random problems
    with N 4..40 and C 2..16) is solved to the same plan, bit for bit; the
    two saturated cases' targets through the port's target functions equal
    the JAX package's and their uncertainties are within 1e-12. Controls,
    each of which must fail: a NaN cost raises (and the library itself
    returns 2 and writes nothing), a mass mismatch raises, a fixture plan
    with two rows swapped (an equally optimal plan of identical rows) fails
    the comparison. Then `emd_batch` ms on both routes: exp-3's 200 draws x
    8 classes at 16 and 32 lanes and exp-6's enumerated combinations at 16
    and 24 lanes, with the host's core count."""
    import ctypes

    import numpy as np

    from fairdiff_torch.fairness import emd, targets

    t_start = time.perf_counter()
    failed = []
    fx = dict(np.load(EMD_FIXTURES))
    cases = sorted(k[:-len(".plans")] for k in fx if k.endswith(".plans"))
    equal = {c: bool(np.array_equal(emd.emd_batch(fx[f"{c}.bs"], fx[f"{c}.cost"]),
                                    fx[f"{c}.plans"].astype(np.float64))) for c in cases}
    problems = sum(len(fx[f"{c}.bs"]) for c in cases)
    log(f"[emd] {len(cases)} fixtures, {problems} problems, plans bit-equal to the JAX native solver's: "
        + ", ".join(f"{c} {ok}" for c, ok in equal.items()))
    failed += [f"fixture {c}" for c, ok in equal.items() if not ok]

    seed, draws = int(fx["ot_seed"]), int(fx["ot_draws"])
    got = {
        "tied_ot2": targets.sampled_ot_targets_2attr(fx["tied_ot2.probs_gender"], fx["tied_ot2.probs_race"],
                                                     np.random.default_rng(seed), draws),
        "tied_enum": (targets.enumerated_ot_targets(fx["tied_enum.probs"]),),
    }
    for case, ts in got.items():
        same = all(np.array_equal(t.targets, w) for t, w in zip(ts, fx[f"{case}.targets"]))
        unc = max(float(np.abs(t.uncertainty - w).max()) for t, w in zip(ts, fx[f"{case}.uncertainty"]))
        log(f"[emd] {case}: targets {[t.targets.tolist() for t in ts]} equal to the JAX package's {same}, "
            f"uncertainty max |diff| {unc:.3e} (limit {EMD_UNC_ATOL:.0e})")
        if not same or unc > EMD_UNC_ATOL:
            failed.append(f"{case} targets")

    # controls
    def raises(bs, cost) -> str:
        try:
            emd.emd_batch(bs, cost)
        except ValueError as err:
            return f"raises ({err})"
        return "solved"

    cost, bs = fx["identical8.cost"], fx["identical8.bs"][8:9]
    nan_cost = cost.copy()
    nan_cost[3] = np.nan
    nan_py = raises(bs, nan_cost)
    plan = np.full(cost.shape, 7.0)
    f64p, i64p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    b0 = np.ascontiguousarray(bs[0], np.int64)
    nan_rc = emd._lib().emd_assignment(nan_cost.ctypes.data_as(f64p), b0.ctypes.data_as(i64p), *cost.shape,
                                       plan.ctypes.data_as(f64p))
    mass = bs.copy()
    mass[0, 0] += 1
    mass_py = raises(mass, cost)
    want = fx["identical8.plans"][8].astype(np.float64)
    i = 0
    j = int(np.flatnonzero((want != want[i]).any(axis=1))[0])  # a row in another class
    swapped = want.copy()
    swapped[[i, j]] = swapped[[j, i]]
    swapped_equal = bool(np.array_equal(emd.emd_batch(bs, cost)[0], swapped))
    swap_cost = float((swapped * cost).sum() - (want * cost).sum())
    log(f"[emd] controls: NaN cost row {nan_py}, the library returns {nan_rc} with the plan untouched "
        f"{bool((plan == 7.0).all())}; mass mismatch {mass_py}; identical8 plan 8 with rows {i} and {j} swapped "
        f"(cost change {swap_cost:.1e}): equal {swapped_equal} (each must fail)")
    if not nan_py.startswith("raises") or nan_rc != 2 or not (plan == 7.0).all():
        failed.append("control: NaN cost")
    if not mass_py.startswith("raises"):
        failed.append("control: mass mismatch")
    if swapped_equal:
        failed.append("control: swapped rows passed the comparison")

    # times at the path's shapes, both routes
    rng = np.random.default_rng(30)
    eg, er = np.repeat(np.eye(2), 4, axis=0), np.tile(np.eye(4), (2, 1))
    cores = os.cpu_count()
    times = {}
    for kind, n in (("exp3", 16), ("exp3", 32), ("exp6", 16), ("exp6", 24)):
        pr = rng.dirichlet(np.ones(4), n)
        if kind == "exp3":  # sampled_ot_targets_2attr's problems
            pg = rng.dirichlet(np.ones(2), n)
            cost = np.sqrt(((pg[:, None] - eg[None]) ** 2).sum(-1) + ((pr[:, None] - er[None]) ** 2).sum(-1))
            joint = (rng.random((EMD_DRAWS, n)) > 0.5) * 4 + rng.integers(0, 4, (EMD_DRAWS, n))
            bs = np.stack([np.bincount(row, minlength=8) for row in joint])
        else:  # enumerated_ot_targets'
            cost = np.sqrt(((pr[:, None] - np.eye(4)[None]) ** 2).sum(-1))
            bs = targets.enumerate_multinomial_combs(n, 4, 0.95)[0]
        native = _emd_ms(lambda: emd.emd_batch(bs, cost))
        scipy = _emd_ms(lambda: emd.emd_batch(bs, cost, native=False))
        optima = [(emd.emd_batch(bs, cost, native=r) * cost).sum(axis=(1, 2)) for r in (True, False)]
        same_cost = bool(np.allclose(*optima, rtol=0, atol=1e-9))
        times[f"{kind}_{n}"] = {"problems": len(bs), "classes": bs.shape[1], "native_ms": native, "scipy_ms": scipy}
        log(f"[emd] emd_batch {kind}, {n} lanes, {len(bs)} problems x {bs.shape[1]} classes: native {native:.3f} ms, "
            f"scipy {scipy:.3f} ms ({scipy / native:.2f}x), equal optima {same_cost}; host of {cores} cores "
            f"(card {power})")
        if not same_cost:
            failed.append(f"{kind} {n}: optima differ between the routes")
    log(f"[emd] {time.perf_counter() - t_start:.1f} s")
    if failed:
        raise AssertionError(f"[emd] failed: {failed}")
    return dict(times, cores=cores)


# K4's shapes on the path: x [M, d] of the feed-forwards at 4096, 1024, 256
# and 64 tokens a row (d = 320, 640, 1280, 1280), at generation's CFG batch
# (2N = 4 rows) and at a pair VJP's 8 rows
GEGLU_SHAPES = [(f"{label}{tag}", rows_ * tokens, d)
                for tag, rows_ in (("", 2 * N_IMAGES), ("-vjp", PAIR_ROWS))
                for label, tokens, d in (("d320", 4096, 320), ("d640", 1024, 640), ("d1280", 256, 1280),
                                         ("d1280mid", 64, 1280))]
GEGLU_SLOT = 64  # K4's K slot: 64 deep
# SDXL at 1024 px, CFG batch 10 (20 rows): self-attention at D = 64 and its
# feed-forwards at d = 640 (4096 tokens) and 1280 (1024 tokens)
SDXL_FLASH_SHAPES = [("sdxl4096", (20, 4096, 10, 64)), ("sdxl1024", (20, 1024, 20, 64))]
SDXL_GEGLU_SHAPES = [("sdxl-d640", 20 * 4096, 640), ("sdxl-d1280", 20 * 1024, 1280)]
# the short-key attention K1 takes without a gradient, as (label, q, k/v, the
# key mask's valid lengths or None): the 77-key cross-attention at generation's
# CFG batch (SD-1.5 with eos masks, SDXL at 1024 px unmasked) and SD-1.5's
# 256-token self-attention (D = 160)
SHORT_FLASH_SHAPES = [
    ("cross4096", (2 * N_IMAGES, 4096, 8, 40), (2 * N_IMAGES, 77, 8, 40), [1, 9, 77, 12]),
    ("cross256", (2 * N_IMAGES, 256, 8, 160), (2 * N_IMAGES, 77, 8, 160), [1, 9, 77, 12]),
    ("self256", (2 * N_IMAGES, 256, 8, 160), (2 * N_IMAGES, 256, 8, 160), None),
    ("sdxl-cross1024", (20, 1024, 20, 64), (20, 77, 20, 64), None),
    ("sdxl-cross4096", (20, 4096, 10, 64), (20, 77, 10, 64), None),
]


def geglu_drop_last_slot(x: torch.Tensor) -> torch.Tensor:
    """x with K4's last 64-deep K slot of d zeroed: the dropped-tile control."""
    x_drop = x.clone()
    x_drop[..., (x.shape[-1] - 1) // GEGLU_SLOT * GEGLU_SLOT:] = 0
    return x_drop


def phase_kernels() -> dict[str, dict]:
    """Each kernel against its plain version at the path shapes (bf16)."""
    import torch.nn.functional as F

    from fairdiff_torch.models.layers import expand_padding_mask
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    rows: dict[str, dict] = {}
    B = 2 * N_IMAGES
    for label, qs, kvs, lengths in (
        ("self4096", (B, 4096, 8, 40), (B, 4096, 8, 40), None),
        ("self1024", (B, 1024, 8, 80), (B, 1024, 8, 80), None),
        ("self576", (PAIR_ROWS, 576, 8, 160), (PAIR_ROWS, 576, 8, 160), None),  # 768 px, 1280 channels
        ("ragged", (1, 600, 2, 40), (1, 300, 2, 40), None),
        *((label, shape, shape, None) for label, shape in SDXL_FLASH_SHAPES),
        *SHORT_FLASH_SHAPES,
    ):
        q = torch.randn(qs, generator=g, device="cuda", dtype=bf)
        k = torch.randn(kvs, generator=g, device="cuda", dtype=bf)
        v = torch.randn(kvs, generator=g, device="cuda", dtype=bf)
        t = kvs[1]
        mask = None if lengths is None else (torch.arange(t, device="cuda")[None] < torch.tensor(
            lengths, device="cuda")[:, None]).int()
        got, ref = fa.flash_attention(q, k, v, key_mask=mask), fa.flash_attention_plain(q, k, v, mask)
        last = kept_keys(t, key_tile(qs[3]))  # the first key of the kernel's last tile
        checks = compare(
            got, ref, fa.flash_attention_plain(q.float(), k.float(), v.float(), mask),
            fa.flash_attention_plain(q, k[:, :last].contiguous(), v[:, :last].contiguous(),
                                     None if mask is None else mask[:, :last]),
        )
        # each output element is written once by one block: a second run is bit-equal
        checks["rerun_equal"] = bool(torch.equal(fa.flash_attention(q, k, v, key_mask=mask), got))
        if not checks["rerun_equal"]:
            checks["failed"].append("rerun not bit-equal")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        b, s, h, d = qs
        bias = None if mask is None else expand_padding_mask(mask).to(bf)
        bound_ms, bound_by = flash_bound(b, s, t, h, d, "fwd")
        rows[f"flash_attention/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16{'' if mask is None else ' masked'}", **checks,
            ms=time_ms(lambda: fa.flash_attention(q, k, v, key_mask=mask)),
            plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, mask)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, bias)),
            bound_ms=bound_ms, bound_by=bound_by,
        )
    tile_checks: dict[str, dict] = {}
    for label, m, d in GEGLU_SHAPES + SDXL_GEGLU_SHAPES:
        inner = 4 * d
        x = torch.randn(m, d, generator=g, device="cuda", dtype=bf)
        w = (torch.randn(2 * inner, d, generator=g, device="cuda") * d**-0.5).to(bf)
        b_ = (torch.randn(2 * inner, generator=g, device="cuda") * 0.1).to(bf)
        got, ref = gg.geglu(x, w, b_), gg.geglu_plain(x, w, b_)
        exact = gg.geglu_plain(x.float(), w.float(), b_.float())
        checks = compare(got, ref, exact, gg.geglu_plain(geglu_drop_last_slot(x), w, b_))
        # each y element is written once by one tile: a second run is bit-equal
        checks["rerun_equal"] = bool(torch.equal(gg.geglu(x, w, b_), got))
        if not checks["rerun_equal"]:
            checks["failed"].append("rerun not bit-equal")
        bound_ms, bound_by = bound(
            2.0 * m * d * 2 * inner, 2.0 * (m * d + 2 * inner * d + 2 * inner + m * inner)
        )
        # every tile the kernel offers, each held to the same limits and timed
        # beside the one `fwd_tile` chooses
        tiles = {}
        for tile in gg.FWD_TILES:
            c = compare(gg.geglu_with_tile(x, w, b_, tile), ref, exact)
            tile_checks[f"geglu/{label} tile {tile}"] = c
            tiles[tile] = time_ms(lambda: gg.geglu_with_tile(x, w, b_, tile))
        rows[f"geglu/{label}"] = dict(
            shape=f"x[{m},{d}] w[{2 * inner},{d}] bf16", **checks,
            ms=time_ms(lambda: gg.geglu(x, w, b_)),
            plain_ms=time_ms(lambda: gg.geglu_plain(x, w, b_)),
            # product only, the [M, 2I] projection written (K4 never writes it)
            library_ms=time_ms(lambda: F.linear(x, w, b_)),
            bound_ms=bound_ms, bound_by=bound_by,
            tile=gg.fwd_tile(m, d, inner), tile_ms=tiles,
            # the kernel alone (torch.profiler): at the mid block `ms` is the
            # wrapper's host time, which the kernel runs under
            device_ms=kernel_split(lambda: gg.geglu(x, w, b_), {"k4::": "k4"}).get("k4"),
        )
        del x, w, b_, got, ref, exact
        torch.cuda.empty_cache()
    log(f"[kernels] limits: element {ELEM_ATOL_RMS} * rms(ref) + {ELEM_RTOL} * |ref| "
        f"(elem_use = worst element's share of it), rel L2 {KERNEL_REL_L2_TOL}, kernel vs "
        f"fp32 <= {ACCURACY_RATIO} x plain vs fp32, dropped-tile control > {KERNEL_REL_L2_TOL} "
        f"(K1: its last key tile, {key_tile(40)} keys at D <= 80; GEGLU: its last 64-deep K slot "
        f"of d); K1 and K4 run twice must be bit-equal; GEGLU library: F.linear, the product "
        f"only, [M, 2I] written")
    for key, r in rows.items():
        rerun = f" | rerun bit-equal {r['rerun_equal']}" if "rerun_equal" in r else ""
        log(f"[kernels] {key:22s} {r['shape']:34s} max_abs {r['max_abs_err']:.3e} "
            f"(ref rms {r['ref_rms']:.3e}, elem_use {r['elem_use']:.3f}) rel_l2 "
            f"{r['rel_l2']:.3e} | vs fp32: kernel {r['kernel_vs_f32']:.3e} plain "
            f"{r['plain_vs_f32']:.3e} | control {r['control_rel_l2']:.3e}{rerun} | {_times(r)}")
        if "tile_ms" in r:
            dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
            log(f"[kernels] {key:22s} tiles (rows x columns, ms; rows 64 ping-pong, 128 cooperative): "
                + ", ".join(f"{a}x{b} {t:.4f}" for (a, b), t in r["tile_ms"].items())
                + f" | chosen {r['tile'][0]}x{r['tile'][1]}, its device ms (profiler) {dev}")
    failed = {key: r["failed"] for key, r in rows.items() if r["failed"]}
    failed.update({key: c["failed"] for key, c in tile_checks.items() if c["failed"]})
    if failed:
        raise AssertionError(f"kernel checks failed: {failed}")
    return rows


def phase_unet_parity() -> float:
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    torch.set_num_threads(os.cpu_count() or 1)
    g = torch.Generator().manual_seed(1)
    unet_cpu = init_weights(UNet2DCondition(UNetConfig.sd15()), g).eval()
    unet_gpu = copy.deepcopy(unet_cpu).cuda()
    lat = torch.randn(2, 64, 64, 4, generator=g)
    t = torch.tensor([999, 500])
    ctx = torch.randn(2, 77, 768, generator=g)
    mask = (torch.arange(77)[None] < torch.tensor([[9], [77]])).int()
    reset_counts()
    with torch.no_grad():
        out_gpu = unet_gpu(lat.cuda(), t.cuda(), ctx.cuda(), mask.cuda()).cpu()
        ran = {k: launch_counts()[k] for k in UNET_CALL_LAUNCHES}
        out_cpu = unet_cpu(lat, t, ctx, mask)
    if ran != UNET_CALL_LAUNCHES:
        raise AssertionError(f"fp32 UNet forward launched {ran}, want {UNET_CALL_LAUNCHES}")
    rel = rel_l2(out_gpu, out_cpu)
    log(f"[unet-fp32] SD-1.5 UNet batch 2, card (kernels) vs CPU (plain): rel L2 {rel:.3e} "
        f"(tol {UNET_REL_L2_TOL:.0e}), |eps| rms {out_cpu.pow(2).mean().sqrt().item():.4f}")
    if not (rel <= UNET_REL_L2_TOL and torch.isfinite(out_gpu).all()):
        raise AssertionError(f"fp32 UNet parity failed: rel L2 {rel:.3e}")
    unet_bf16_parity(unet_gpu, (lat.cuda(), t.cuda(), ctx.cuda(), mask.cuda()), out_cpu)
    return rel


@contextlib.contextmanager
def routes(attention, geglu):
    """Route the UNet's flash attention and GEGLU through other functions on
    the card, for comparison runs only."""
    from fairdiff_torch.models import layers, unet2d

    saved = layers.flash_attention, unet2d.geglu
    layers.flash_attention, unet2d.geglu = attention, geglu
    try:
        yield
    finally:
        layers.flash_attention, unet2d.geglu = saved


def unet_bf16_parity(unet_f32, inputs, exact: torch.Tensor, want=UNET_CALL_LAUNCHES,
                     tag: str = "[unet-bf16]", control_by_accuracy: bool = False) -> list[int]:
    """The bf16 kernels that generation runs, inside one full-width UNet
    forward. Every launch is held against its plain version on the
    activations it was given (the limits of phase 3); the output is held
    against the plain routes on the same weights and inputs and, with them,
    against the fp32 output `exact`, beside a control whose attention drops
    the last 64-key tile; `want` is the (flash, GEGLU) launch count;
    `control_by_accuracy` as in `compare`, for the flash launches. Returns
    the head dim of every flash launch."""
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    unet = copy.deepcopy(unet_f32).to(torch.bfloat16)
    per_launch: dict[str, list[dict]] = {"flash_attention": [], "geglu": []}
    head_dims: list[int] = []

    def checked_attention(q, k, v, flash_bwd="split", key_mask=None):
        got = fa.flash_attention(q, k, v, key_mask=key_mask)
        head_dims.append(q.shape[-1])
        per_launch["flash_attention"].append(compare(
            got, fa.flash_attention_plain(q, k, v, key_mask),
            fa.flash_attention_plain(q.float(), k.float(), v.float(), key_mask),
            drop_last_tile(q, k, v, key_mask=key_mask), control_by_accuracy))
        return got

    def checked_geglu(x, w, b):
        got = gg.geglu(x, w, b)
        per_launch["geglu"].append(compare(
            got, gg.geglu_plain(x, w, b), gg.geglu_plain(x.float(), w.float(), b.float()),
            gg.geglu_plain(geglu_drop_last_slot(x), w, b)))
        return got

    with torch.no_grad():
        reset_counts()
        with routes(checked_attention, checked_geglu):
            kern = unet(*inputs).float().cpu()
        ran = {k: launch_counts()[k] for k in want}
        with routes(plain_attention, gg.geglu_plain):
            plain = unet(*inputs).float().cpu()
        with routes(drop_last_tile, gg.geglu_plain):
            dropped = unet(*inputs).float().cpu()
    for name, rows in per_launch.items():
        if not rows:
            continue  # the launch count check below fails
        log(f"{tag} {name}: {len(rows)} launches in the forward, each against its plain "
            f"version: worst elem_use {max(r['elem_use'] for r in rows):.3f}, worst rel_l2 "
            f"{max(r['rel_l2'] for r in rows):.3e}, worst kernel/plain error vs fp32 "
            f"{max(r['kernel_vs_f32'] / r['plain_vs_f32'] for r in rows):.3f}, weakest "
            f"dropped-tile control {min(r['control_rel_l2'] for r in rows):.3e} (vs fp32: "
            f"{min(r['control_vs_f32'] / r['plain_vs_f32'] for r in rows):.3f}x the plain version's error)")
    e_kp, e_k, e_p = rel_l2(kern, plain), rel_l2(kern, exact), rel_l2(plain, exact)
    e_dp, e_d = rel_l2(dropped, plain), rel_l2(dropped, exact)
    log(f"{tag} SD-1.5 UNet, {inputs[0].shape[0]} rows of {tuple(inputs[0].shape[1:3])} latents: "
        f"kernels vs plain routes rel L2 {e_kp:.3e} "
        f"(tol {UNET_BF16_REL_L2_TOL:.0e}); vs fp32: kernels {e_k:.3e}, plain {e_p:.3e} "
        f"(kernels <= {UNET_BF16_ACCURACY_RATIO} x plain); dropped-tile control: vs plain "
        f"{e_dp:.3e}, vs fp32 {e_d:.3e} (must exceed {UNET_BF16_ACCURACY_RATIO} x plain); "
        f"launches {ran} (want {want}), flash head dims {head_dims}")
    failed = [f"{name} launch {i}: {r['failed']}" for name, rows in per_launch.items()
              for i, r in enumerate(rows) if r["failed"]]
    failed += [name for name, ok in (
        ("launches", ran == want),
        ("finite", bool(torch.isfinite(kern).all())),
        ("rel L2", e_kp <= UNET_BF16_REL_L2_TOL),
        ("accuracy", e_k <= UNET_BF16_ACCURACY_RATIO * e_p),
        ("control", e_d > UNET_BF16_ACCURACY_RATIO * e_p),
    ) if not ok]
    if failed:
        raise AssertionError(f"{tag} bf16 UNet parity failed: {failed}")
    return head_dims


# one no-grad CFG UNet call at 768 px (sample_size 96): every attention takes
# K1, the self-attention over 9216 (D = 40), 2304 (D = 80) and 576 tokens
# (D = 160, the 1280-channel blocks: down_2's 2 and up_1's 3) and, short-key
# or masked, mid's over 144 tokens and the 16 masked cross-attentions;
# UNET_768_K1_D160 of them at D = 160 (the 576- and 144-token blocks' self-
# and cross-attention). A pair VJP runs K6 at D = 160 UNET_768_D160 times
UNET_768_LAUNCHES = {"flash_attention": 32, "flash_attention_short": 17, "geglu": 16}
UNET_768_K1_D160 = 12
UNET_768_D160 = 5


def phase_unet_768(power: str) -> list[int]:
    """One bf16 CFG UNet forward at 768 px (sample_size 96; one image, so 2
    rows) on the card, with the limits of phase 4's bf16 forward against the
    plain routes' fp32 output on the card (the 576-token attention of the
    1280-channel blocks, head dim 160, raised ValueError before K1 took
    D = 160), and exactly UNET_768_K1_D160 K1 launches at D = 160; then one
    merged pair VJP on the same 2 rows (`phase_unet_vjp` with its limits and
    each K6 launch's checks), exactly UNET_768_D160 of its K6 launches at
    D = 160 and none of K2 or K3."""
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    g = torch.Generator().manual_seed(6)
    cfg = dataclasses.replace(UNetConfig.sd15(), sample_size=96)
    unet = init_weights(UNet2DCondition(cfg), g).eval().cuda()
    lat = torch.randn(1, cfg.sample_size, cfg.sample_size, 4, generator=g)
    ctx = torch.randn(2, 77, 768, generator=g)
    mask = (torch.arange(77)[None] < torch.tensor([[77], [11]])).int()
    inputs = (torch.cat([lat, lat]).cuda(), torch.tensor([500, 500]).cuda(), ctx.cuda(), mask.cuda())

    with torch.no_grad(), routes(plain_attention, gg.geglu_plain):
        exact = unet(*inputs).float().cpu()
    # at 9216 keys a dropped 64-key tile moves K1's output by rel L2 ~5e-3,
    # under the 1e-2 limit, so there the control must break either limit
    # (rel L2, or the accuracy ratio against fp32) that each launch is held to
    head_dims = unet_bf16_parity(unet, inputs, exact, UNET_768_LAUNCHES, "[unet-768]", control_by_accuracy=True)
    n160 = sum(d == 160 for d in head_dims)
    log(f"[unet-768] K1 launches at head dim 160: {n160} (want {UNET_768_K1_D160})")
    if n160 != UNET_768_K1_D160:
        raise AssertionError(f"[unet-768] {n160} K1 launches at D = 160, want {UNET_768_K1_D160}")
    del unet
    torch.cuda.empty_cache()
    vjp = phase_unet_vjp(power, flash_bwd="merged", sample_size=96, rows=2, tag="[unet-768]",
                         want=UNET_768_VJP_LAUNCHES_MERGED, profile=False)
    k6_160 = sum(d == 160 for d in vjp["head_dims"])
    log(f"[unet-768] merged pair VJP: K6 launches at head dim 160: {k6_160} (want {UNET_768_D160}); "
        f"K6 head dims {vjp['head_dims']}")
    if k6_160 != UNET_768_D160:
        raise AssertionError(f"[unet-768] {k6_160} K6 launches at D = 160, want {UNET_768_D160}")
    return head_dims


def read_jpg(path: Path):
    """A 512x512 JPEG that gen_images wrote, decoded by the port's codec ->
    [512, 512, 3] uint8."""
    from fairdiff_torch.io.imageio import decode

    pixels = decode(path)
    if pixels.shape != (512, 512, 3):
        raise AssertionError(f"{path}: {pixels.shape}")
    return pixels


SLICE_PROMPTS = ["a photo of the face of a firefighter, a person", "a photo of the face of a nurse, a person"]


def phase_slice() -> tuple[dict[str, int], dict[str, str]]:
    """-> the launch counts and each JPEG's sha256 by its path under the
    output directory (`[weights]` holds its own JPEGs to them)."""
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg
    from fairdiff_torch.tools import gen_images

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prompts = Path(tmp) / "prompts.json"
        prompts.write_text(json.dumps({"test_prompts": SLICE_PROMPTS}))
        cfg = gen_images.GenImagesConfig(
            prompts_json=str(prompts), num_imgs_per_prompt=2, batch_size=2,
            save_dir=str(Path(tmp) / "out"),
        )
        reset_counts()
        t0 = time.perf_counter()
        written = gen_images.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: launch_counts()[k] for k in UNET_CALL_LAUNCHES}
        expect_paths = [Path(cfg.save_dir) / f"prompt_{p}" / f"img_{j}.jpg" for p in (0, 1) for j in (0, 1)]
        if sorted(written) != sorted(expect_paths):
            raise AssertionError(f"wrote {written}")
        for p in expect_paths:
            pixels = read_jpg(p)
            if pixels.min() == pixels.max():
                raise AssertionError(f"{p} is constant")
        # one UNet call per step serves both CFG halves
        calls = 2 * cfg.num_denoising_steps  # 2 generate calls (2 prompts, batch 2)
        want = {k: n * calls for k, n in UNET_CALL_LAUNCHES.items()}
        log(f"[slice] gen_images.main: 4 JPEGs (quality 95) at 512x512, read back by the port's decoder, "
            f"{cfg.num_denoising_steps} steps, "
            f"{seconds:.2f} s incl. setup; launches {counts} (want {want})")
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
        jpgs = {str(p.relative_to(cfg.save_dir)): hashlib.sha256(p.read_bytes()).hexdigest() for p in expect_paths}
    return counts, jpgs


def phase_throughput(power: str) -> float:
    from fairdiff_torch.io.tokenizer import HashTokenizer
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    sd = StableDiffusion(SDConfig.sd15()).init_random(0)
    tok = HashTokenizer()
    cond = tok(["a photo of the face of a doctor, a person"], padding="max_length").input_ids
    uncond = tok([""], padding="max_length").input_ids
    noises = torch.randn(4, 64, 64, 4, generator=torch.Generator().manual_seed(2))
    sd.generate(noises, cond, uncond, 1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = sd.generate(noises, cond, uncond, 50)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if images.shape != (4, 512, 512, 3) or not torch.isfinite(images).all():
        raise AssertionError(f"generate gave {tuple(images.shape)}, finite={torch.isfinite(images).all()}")
    if images.std().item() == 0.0:
        raise AssertionError("generate gave constant images")
    rate = 4 / seconds
    log(f"[throughput] SD-1.5 bf16, 50-step CFG generate, batch 4: {seconds:.3f} s, "
        f"{rate:.4f} img/s on {power}")
    profile_unet_call(sd, noises, cond, uncond)
    return rate


def profile_unet_call(sd, noises: torch.Tensor, cond, uncond) -> None:
    """Where one CFG UNet call's device time goes (batch 4 -> 8 rows)."""
    from torch.profiler import ProfilerActivity, profile

    context, key_mask, _ = sd.build_context(cond, uncond, noises.shape[0])
    lat2 = torch.cat([noises, noises]).to(sd.device)
    with torch.no_grad():
        wall = time_ms(lambda: sd.unet_eps(lat2, 500, context, key_mask), iters=3, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sd.unet_eps(lat2, 500, context, key_mask)
            torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3  # us -> ms
    if busy == 0.0:
        log(f"[profile] one UNet call, CFG batch 8: {wall:.3f} ms wall; kernel time not measured "
            "(the profiler recorded no device time)")
        return
    log(f"[profile] one UNet call, CFG batch 8: {wall:.3f} ms wall (CUDA events), "
        f"{busy:.3f} ms kernel time, device idle share {max(0.0, 1 - busy / wall):.3f}")
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x "
            f"{100 * e.self_device_time_total / 1e3 / busy:5.1f}%  {e.key[:90]}")


# K1 with lse: lse is fp32 from the fp32 scores of the same inputs in both
# the kernel and the plain version, which differ only in summation order
# (~1e-6 of lse's ~10)
LSE_ATOL = 1e-4
# fp32 kernel bodies against the plain fp32 versions on the same inputs:
# summation order only
F32_REL_L2_TOL = 1e-4


def _flash_bwd_checks(q, k, v, do, fwd=None, grads=None):
    """K1 with lse, K2 and K3 on one input set, each against its plain
    version; controls drop the kernel's last key tile (o: K1's, dq: K2's,
    the same size) or the last 64-row q tile (dk, dv) from the plain
    version. `fwd` = (o, lse) and `grads` = (dq, dk, dv) are the kernels'
    outputs where the caller has them; else the kernels run here."""
    from fairdiff_torch.ops import flash_attention as fa

    S, T = q.shape[1], k.shape[1]
    last_k, last_q = (T - 1) // key_tile(q.shape[3]) * key_tile(q.shape[3]), (S - 1) // 64 * 64
    o, lse = fwd if fwd is not None else fa.flash_attention_lse(q, k, v)
    o_p, lse_p = fa.flash_attention_lse_plain(q, k, v)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o_x, lse_x = fa.flash_attention_lse_plain(qf, kf, vf)
    out = {"lse": compare(o, o_p, o_x, fa.flash_attention_lse_plain(q, k[:, :last_k], v[:, :last_k])[0])}
    lse_err = (lse - lse_p).abs().max().item()
    out["lse"]["lse_max_abs_err"] = lse_err
    if not lse_err <= LSE_ATOL:
        out["lse"]["failed"].append("lse")
    delta = fa.attention_delta(o, do)
    delta_x = fa.attention_delta(o_x, dof)
    if grads is None:
        grads = (fa.flash_attention_dq(q, k, v, do, lse, delta), *fa.flash_attention_dkv(q, k, v, do, lse, delta))
    dq, dk, dv = grads
    dq_x = fa.flash_attention_dq_plain(qf, kf, vf, dof, lse_x, delta_x)
    dk_x, dv_x = fa.flash_attention_dkv_plain(qf, kf, vf, dof, lse_x, delta_x)
    out["dq"] = compare(dq, fa.flash_attention_dq_plain(q, k, v, do, lse, delta), dq_x,
                        fa.flash_attention_dq_plain(q, k[:, :last_k], v[:, :last_k], do, lse, delta))
    dk_p, dv_p = fa.flash_attention_dkv_plain(q, k, v, do, lse, delta)
    dk_c, dv_c = fa.flash_attention_dkv_plain(
        q[:, :last_q], k, v, do[:, :last_q], lse[..., :last_q].contiguous(), delta[..., :last_q].contiguous())
    out["dk"] = compare(dk, dk_p, dk_x, dk_c)
    out["dv"] = compare(dv, dv_p, dv_x, dv_c)
    return out, (o, lse, delta), grads


def merged_tiles(d: int) -> tuple[int, int]:
    """K6's (keys a block, q rows a tile) at head dim `d`
    (csrc/flash_attention.cu `kv::Smem<DP, true>`): (128, 64) up to 128,
    (64, 32) above. A block's keys are its unit of key work, whose dq tile
    one bulk reduce-add adds for each q tile."""
    return (128, 64) if d <= 128 else (64, 32)


def _merged_checks(q, k, v, o, lse, do, got, split=None):
    """K6's (dq, dk, dv) `got` against the plain version
    (`flash_attention_bwd_plain`, the same rounding points) and, where given,
    against K2/K3's outputs `split` on the same inputs, with the limits of
    phase 3. Controls drop the last key block (dq: the keys whose
    contribution one bulk reduce-add adds) or the last q tile (dk, dv: the
    block's loop unit) from the plain version (`merged_tiles`)."""
    from fairdiff_torch.ops import flash_attention as fa

    S, T = q.shape[1], k.shape[1]
    block_keys, q_tile = merged_tiles(q.shape[-1])
    last_k = (T - 1) // block_keys * block_keys
    last_q = (S - 1) // q_tile * q_tile
    delta = fa.attention_delta(o, do)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o_x, lse_x = fa.flash_attention_lse_plain(qf, kf, vf)
    exact = fa.flash_attention_bwd_plain(qf, kf, vf, o_x, lse_x, dof)
    controls = (
        fa.flash_attention_dq_plain(q, k[:, :last_k], v[:, :last_k], do, lse, delta),
        *fa.flash_attention_dkv_plain(q[:, :last_q], k, v, do[:, :last_q],
                                      lse[..., :last_q].contiguous(), delta[..., :last_q].contiguous()),
    )
    out = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        c = compare(got[i], plain[i], exact[i], controls[i])
        if split is not None:
            vs = compare(got[i], split[i], exact[i])
            c["vs_split_rel_l2"] = vs["rel_l2"]
            c["failed"] += [f"vs split: {f}" for f in vs["failed"]]
        out[f"merged_{name}"] = c
    return out


def _merged_rerun(got, again, t: int) -> dict:
    """K6's second run `again` on the same inputs (T = `t` keys) against its
    first run `got`. A block
    keeps its key tile's dk and dv in registers and sums them over the q
    tiles in a fixed order, so they must be bit-equal. dq's fp32 reduce-adds add
    the key blocks' contributions in any order: two runs may differ by the
    fp32 reordering of that sum (allowed: blocks x fp32 eps x max|dq|, with
    64-key blocks counted, the fp32 body's unit) plus one ulp of dq's type
    where the sum sits near a rounding boundary. A contribution lost or
    added twice moves dq by one block's term, about max|dq| / sqrt(blocks)."""
    a, b = got[0].float(), again[0].float()
    ulp = torch.ldexp(torch.full_like(a, torch.finfo(got[0].dtype).eps), torch.frexp(torch.maximum(a.abs(), b.abs())).exponent - 1)
    diff = (a - b).abs()
    allow = ulp + -(-t // 64) * torch.finfo(torch.float32).eps * a.abs().max()
    r = dict(dk_equal=bool(torch.equal(got[1], again[1])), dv_equal=bool(torch.equal(got[2], again[2])),
             dq_n=a.numel(), dq_differ=int((diff > 0).sum()), dq_over_ulp=int((diff > ulp).sum()),
             dq_worst=(diff / allow).max().item())
    r["failed"] = [f for f, bad in (("dk not bit-equal", not r["dk_equal"]), ("dv not bit-equal", not r["dv_equal"]),
                                    (f"dq diff {r['dq_worst']:.3f}x its allowance", not r["dq_worst"] <= 1.0)) if bad]
    return r


def _dkv_rerun(got, again) -> dict:
    """K3's second run on the same inputs: each block writes its keys' dk and
    dv once, summed over the q tiles in a fixed order, so both are
    bit-equal."""
    r = dict(dk_equal=bool(torch.equal(got[0], again[0])), dv_equal=bool(torch.equal(got[1], again[1])))
    r["failed"] = [f for f, bad in (("dk not bit-equal", not r["dk_equal"]),
                                    ("dv not bit-equal", not r["dv_equal"])) if bad]
    return r


def _query_block_rerun(q, k, v, do, o, lse, delta, dq) -> dict:
    """K1 with lse and K2 run again on the same inputs: every o, lse and dq
    element is written once, by one block, summed over the key tiles in a
    fixed order, so both runs are bit-equal."""
    from fairdiff_torch.ops import flash_attention as fa

    o2, lse2 = fa.flash_attention_lse(q, k, v)
    r = dict(o_equal=bool(torch.equal(o, o2)), lse_equal=bool(torch.equal(lse, lse2)),
             dq_equal=bool(torch.equal(dq, fa.flash_attention_dq(q, k, v, do, lse, delta))))
    r["failed"] = [f"{name} not bit-equal" for name in ("o", "lse", "dq") if not r[f"{name}_equal"]]
    return r


def kernel_split(fn, names: dict[str, str]) -> dict[str, float]:
    """Device ms of each CUDA kernel that one call of `fn` launches
    (torch.profiler), keyed by the first of `names` (substring -> label)
    found in the kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        label = next((v for k, v in names.items() if k in e.key), None)
        if label is not None and e.self_device_time_total > 0:
            out[label] = out.get(label, 0.0) + e.self_device_time_total / 1e3
    return out


# K5's CUDA kernels (csrc/geglu.cu `gm`) by the epilogue in their names
K5_KERNELS = {"DprojEpi": "dproj", "DxEpi": "dx", "dx_reduce": "split-K sum"}


def _times(r: dict) -> str:
    """A row's times, its bound and the kernel's factor over the bound and
    over the library call."""
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    return (f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) | {r['ms'] / r['bound_ms']:.1f}x bound"
            + ("" if r["library_ms"] is None else f", {r['ms'] / r['library_ms']:.2f}x library"))


def _rerun_line(r: dict) -> str:
    return (f"dk, dv bit-equal {r['dk_equal']}, {r['dv_equal']}; dq differs in {r['dq_differ']} of {r['dq_n']} "
            f"elements, {r['dq_over_ulp']} by more than 1 ulp, worst diff {r['dq_worst']:.3f}x its allowance")


def _geglu_dx_checks(dx, x, w, b, dy):
    """K5's output `dx` against the plain version; the control leaves the
    last 64 columns of I (one column tile of the kernel's dproj, and one
    64-deep K tile of each half of its dx product) out of dproj, by zeroing
    them in dy for the plain version."""
    from fairdiff_torch.ops import geglu as gg

    dy_drop = dy.clone()
    dy_drop[..., -64:] = 0
    return compare(dx, gg.geglu_dx_plain(x, w, b, dy),
                   gg.geglu_dx_plain(x.float(), w.float(), b.float(), dy.float()),
                   gg.geglu_dx_plain(x, w, b, dy_drop))


def phase_kernels_bwd() -> dict[str, dict]:
    """K1 with lse, K2, K3 and K5 against their plain versions at the
    phase-4 shapes, in bf16 (limits of phase 3) and fp32, with times."""
    import torch.nn.functional as F

    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    rows: dict[str, dict] = {}
    checks: dict[str, dict] = {}
    f32_rel: dict[str, float] = {}
    reruns: dict[str, dict] = {}  # K6 run twice on the same inputs
    dkv_reruns: dict[str, dict] = {}  # K3 run twice
    q_reruns: dict[str, dict] = {}  # K1 with lse and K2 run twice
    dx_reruns: dict[str, bool] = {}  # K5 run twice: bit-equal
    B = PAIR_ROWS
    for label, qs, kvs in (
        ("self4096", (B, 4096, 8, 40), (B, 4096, 8, 40)),
        ("self1024", (B, 1024, 8, 80), (B, 1024, 8, 80)),
        ("self576", (B, 576, 8, 160), (B, 576, 8, 160)),  # 768 px, 1280 channels
        ("ragged", (1, 600, 2, 40), (1, 300, 2, 40)),
    ):
        q, do = (torch.randn(qs, generator=g, device="cuda", dtype=bf) for _ in range(2))
        k, v = (torch.randn(kvs, generator=g, device="cuda", dtype=bf) for _ in range(2))
        got, (o, lse, delta), split = _flash_bwd_checks(q, k, v, do)
        dkv_reruns[label] = _dkv_rerun(split[1:], fa.flash_attention_dkv(q, k, v, do, lse, delta))
        q_reruns[label] = _query_block_rerun(q, k, v, do, o, lse, delta, split[0])
        merged = fa.flash_attention_bwd_merged(q, k, v, o, lse, do)
        got.update(_merged_checks(q, k, v, o, lse, do, merged, split))
        reruns[f"bf16/{label}"] = _merged_rerun(merged, fa.flash_attention_bwd_merged(q, k, v, o, lse, do), kvs[1])
        del merged
        for name, c in got.items():
            checks[f"{name}/{label}"] = c
        # the fp32 bodies against the fp32 plain versions
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        o32, lse32 = fa.flash_attention_lse(q32, k32, v32)
        d32 = fa.attention_delta(o32, do32)
        o32p, _ = fa.flash_attention_lse_plain(q32, k32, v32)
        f32_rel[f"lse/{label}"] = rel_l2(o32, o32p)
        f32_rel[f"dq/{label}"] = rel_l2(fa.flash_attention_dq(q32, k32, v32, do32, lse32, d32),
                                        fa.flash_attention_dq_plain(q32, k32, v32, do32, lse32, d32))
        dk32, dv32 = fa.flash_attention_dkv(q32, k32, v32, do32, lse32, d32)
        dk32p, dv32p = fa.flash_attention_dkv_plain(q32, k32, v32, do32, lse32, d32)
        f32_rel[f"dk/{label}"], f32_rel[f"dv/{label}"] = rel_l2(dk32, dk32p), rel_l2(dv32, dv32p)
        merged32 = fa.flash_attention_bwd_merged(q32, k32, v32, o32, lse32, do32)
        for name, m32, p32 in zip(("dq", "dk", "dv"), merged32,
                                  fa.flash_attention_bwd_plain(q32, k32, v32, o32, lse32, do32)):
            f32_rel[f"merged_{name}/{label}"] = rel_l2(m32, p32)
        reruns[f"fp32/{label}"] = _merged_rerun(
            merged32, fa.flash_attention_bwd_merged(q32, k32, v32, o32, lse32, do32), kvs[1])
        del q32, k32, v32, do32, o32, o32p, dk32, dv32, dk32p, dv32p, merged32

        b, s, h, d = qs
        t = kvs[1]
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        rows[f"flash_attention_lse/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_lse(q, k, v)),
            plain_ms=time_ms(lambda: fa.flash_attention_lse_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt.detach(), kt.detach(), vt.detach())),
            **dict(zip(("bound_ms", "bound_by"), flash_bound(b, s, t, h, d, "fwd_lse"))),
        )
        rows[f"flash_attention_dq/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, delta)),
            plain_ms=time_ms(lambda: fa.flash_attention_dq_plain(q, k, v, do, lse, delta), iters=3),
            library_ms=sdpa_bwd,  # SDPA's whole backward (dq, dk and dv)
            **dict(zip(("bound_ms", "bound_by"), flash_bound(b, s, t, h, d, "dq"))),
        )
        rows[f"flash_attention_dkv/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta)),
            plain_ms=time_ms(lambda: fa.flash_attention_dkv_plain(q, k, v, do, lse, delta), iters=3),
            library_ms=sdpa_bwd,
            **dict(zip(("bound_ms", "bound_by"), flash_bound(b, s, t, h, d, "dkv"))),
        )
        # K6's function reads q, k, v, dO, lse and delta once and writes dq,
        # dk and dv once. Its fp32 dq reduce-adds (one [q tile, D] tile a key
        # block and q tile: `merged_tiles`) are this design's cost, not bytes
        # the function needs: they stay out of the bound and are logged
        # beside it
        block_keys, q_tile = merged_tiles(d)
        # the kernel alone, launched on the wrapper's operands (its fp32 dq
        # buffer summing on), beside the wrapper (delta, the zeroed buffer
        # and the cast around it) and the split route (delta, K2, K3)
        dq32 = torch.zeros(b, h, -(-s // fa.DQ_ROWS) * fa.DQ_ROWS, d, dtype=torch.float32, device="cuda")
        dk_, dv_ = torch.empty_like(k), torch.empty_like(v)
        k6_args = [q, k, v, do, lse, delta, dk_, dv_, dq32]
        rows[f"flash_attention_bwd_merged/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_bwd_merged(q, k, v, o, lse, do)),
            plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do), iters=3),
            library_ms=sdpa_bwd,
            reduce_gb=4.0 * -(-t // block_keys) * b * h * -(-s // q_tile) * q_tile * d / 1e9,
            route=f"K6, {block_keys}-key blocks",
            kernel_alone_ms=time_ms(lambda: fa._launch("bwd_merged", k6_args, q, t)),
            split_route_ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)),
            **dict(zip(("bound_ms", "bound_by"), flash_bound(b, s, t, h, d, "merged"))),
        )
        del qt, kt, vt, sdpa_out, dq32, dk_, dv_, k6_args
        torch.cuda.empty_cache()
    for label, m, d in (
        ("d320", PAIR_ROWS * 4096, 320),
        ("d640", PAIR_ROWS * 1024, 640),
        ("d1280", PAIR_ROWS * 256, 1280),
        ("d1280mid", PAIR_ROWS * 64, 1280),
    ):
        inner = 4 * d
        x = torch.randn(m, d, generator=g, device="cuda", dtype=bf)
        w = (torch.randn(2 * inner, d, generator=g, device="cuda") * d**-0.5).to(bf)
        b_ = (torch.randn(2 * inner, generator=g, device="cuda") * 0.1).to(bf)
        dy = torch.randn(m, inner, generator=g, device="cuda", dtype=bf)
        dx = gg.geglu_dx(x, w, b_, dy)
        checks[f"geglu_dx/{label}"] = _geglu_dx_checks(dx, x, w, b_, dy)
        # dproj is written once and the dx product (and its split-K partials)
        # summed in a fixed order: a second run is bit-equal
        dx_reruns[label] = bool(torch.equal(gg.geglu_dx(x, w, b_, dy), dx))
        splits = gg.dx_splits(m, d, inner)
        x32, w32, b32, dy32 = (t_.float() for t_ in (x, w, b_, dy))
        f32_rel[f"geglu_dx/{label}"] = rel_l2(gg.geglu_dx(x32, w32, b32, dy32), gg.geglu_dx_plain(x32, w32, b32, dy32))
        dproj_lib = torch.randn(m, 2 * inner, device="cuda", dtype=bf)  # off `g`: the inputs stay as they were
        rows[f"geglu_dx/{label}"] = dict(
            shape=f"x[{m},{d}] w[{2 * inner},{d}] dy[{m},{inner}] bf16",
            ms=time_ms(lambda: gg.geglu_dx(x, w, b_, dy)),
            plain_ms=time_ms(lambda: gg.geglu_dx_plain(x, w, b_, dy)),
            # K5's two products by cuBLAS: F.linear (the [M, 2I] projection
            # written), then a [M, 2I] dproj times W (read)
            library_ms=time_ms(lambda: (F.linear(x, w, b_), dproj_lib @ w)),
            # the design's own traffic, outside the bound: dproj [M, 2 Ip] bf16
            # written and read, and at split K the fp32 partials likewise
            dproj_gb=2 * 2.0 * m * 2 * gg.dx_inner_pad(inner) / 1e9,
            split=kernel_split(lambda: gg.geglu_dx(x, w, b_, dy), K5_KERNELS),
            part_gb=(2 * 4.0 * splits * m * d / 1e9) if splits > 1 else 0.0,
            **dict(zip(("bound_ms", "bound_by"), bound(
                8.0 * m * d * inner, 2.0 * (2 * m * d + 2 * inner * d + 2 * inner + m * inner), float(m * inner)))),
        )
    log(f"[kernels-bwd] limits as [kernels]; lse max abs error <= {LSE_ATOL}; fp32 bodies vs fp32 plain "
        f"rel L2 <= {F32_REL_L2_TOL}; controls drop the kernel's last key tile (o: K1's, dq: K2's; "
        f"{key_tile(40)} keys at D <= 80, {key_tile(96)} above), the last 64-row q tile "
        f"(dk, dv) or the last 64 columns of I from dproj (GEGLU dx); merged (K6) controls drop the last "
        f"key block (dq: {merged_tiles(40)[0]} keys, {merged_tiles(160)[0]} above D = 128) or the last q tile "
        f"(dk, dv: {merged_tiles(40)[1]} rows, {merged_tiles(160)[1]} above), and K6 is also held to the "
        f"limits against K2/K3's outputs; K1 with lse, K2, K3 and K5 run twice must be bit-equal")
    for key, c in checks.items():
        extra = f" lse max abs {c['lse_max_abs_err']:.3e} |" if "lse_max_abs_err" in c else ""
        extra += f" vs K2/K3 rel_l2 {c['vs_split_rel_l2']:.3e} |" if "vs_split_rel_l2" in c else ""
        log(f"[kernels-bwd] {key:18s} max_abs {c['max_abs_err']:.3e} (ref rms {c['ref_rms']:.3e}, "
            f"elem_use {c['elem_use']:.3f}) rel_l2 {c['rel_l2']:.3e} |{extra} vs fp32: kernel "
            f"{c['kernel_vs_f32']:.3e} plain {c['plain_vs_f32']:.3e} | control {c['control_rel_l2']:.3e} "
            f"| fp32 body rel L2 {f32_rel[key]:.3e}")
    for key, r in rows.items():
        reduce = (f" | {r['route']}, dq reduce-adds {r['reduce_gb']:.3f} GB (not in the bound) | the kernel "
                  f"alone {r['kernel_alone_ms']:.4f} ms; the split route (delta, K2, K3) {r['split_route_ms']:.4f} ms"
                  if "reduce_gb" in r else "")
        reduce += (f" | dproj {r['dproj_gb']:.3f} GB, split-K partials {r['part_gb']:.3f} GB "
                   f"(not in the bound) | kernels (profiler): "
                   + ", ".join(f"{k} {v:.4f} ms" for k, v in r["split"].items()) if "dproj_gb" in r else "")
        log(f"[kernels-bwd] {key:28s} {r['shape']:44s} {_times(r)}{reduce}")
    for key, r in q_reruns.items():
        log(f"[kernels-bwd] K1 with lse and K2 run twice, bf16/{key}: o, lse, dq bit-equal {r['o_equal']}, "
            f"{r['lse_equal']}, {r['dq_equal']}")
    for key, r in dkv_reruns.items():
        log(f"[kernels-bwd] K3 run twice, bf16/{key}: dk, dv bit-equal {r['dk_equal']}, {r['dv_equal']}")
    for key, equal in dx_reruns.items():
        log(f"[kernels-bwd] K5 run twice, bf16/{key}: dx bit-equal {equal}")
    for key, r in reruns.items():
        log(f"[kernels-bwd] K6 run twice, {key}: {_rerun_line(r)}")
    failed = {key: c["failed"] for key, c in checks.items() if c["failed"]}
    failed.update({key: f"fp32 body rel L2 {v:.3e}" for key, v in f32_rel.items() if not v <= F32_REL_L2_TOL})
    failed.update({f"K6 rerun {key}": r["failed"] for key, r in reruns.items() if r["failed"]})
    failed.update({f"K3 rerun {key}": r["failed"] for key, r in dkv_reruns.items() if r["failed"]})
    failed.update({f"K1/K2 rerun {key}": r["failed"] for key, r in q_reruns.items() if r["failed"]})
    failed.update({f"K5 rerun {key}": "dx not bit-equal" for key, equal in dx_reruns.items() if not equal})
    if failed:
        raise AssertionError(f"backward kernel checks failed: {failed}")
    # the summary's max_abs_err: the kernel's worst element against its plain version
    for key, r in rows.items():
        name, label = key.split("/")
        part = {"flash_attention_lse": ["lse"], "flash_attention_dq": ["dq"],
                "flash_attention_dkv": ["dk", "dv"], "geglu_dx": ["geglu_dx"],
                "flash_attention_bwd_merged": ["merged_dq", "merged_dk", "merged_dv"]}[name]
        r["max_abs_err"] = max(checks[f"{p_}/{label}"]["max_abs_err"] for p_ in part)
    return rows


# The distinct GroupNorm shapes of one SD-1.5 CFG UNet call at batch 8, as
# (channels, H*W, SiLU, eps): the resnet norms (SiLU, eps 1e-5), then the
# spatial transformers' norms (no SiLU, eps 1e-6)
GN_SHAPES = [(c, hw, True, 1e-5) for c, hw in (
    (320, 4096), (320, 1024), (640, 1024), (640, 256), (1280, 256), (1280, 64), (2560, 64),
    (2560, 256), (1920, 256), (1920, 1024), (1280, 1024), (960, 1024), (960, 4096), (640, 4096))]
GN_SHAPES += [(c, hw, False, 1e-6) for c, hw in ((320, 4096), (640, 1024), (1280, 256), (1280, 64))]
GN_ROWS, GN_GROUPS = 8, 32


def _gn_drop_last_chunk(x, scale, bias, groups, eps, silu):
    """The plain version with statistics that leave out the last CTA's slice
    of each sample's rows (the control of [kernels-gn])."""
    from fairdiff_torch.ops import group_norm as gn

    B, C = x.shape[0], x.shape[-1]
    rows = x.numel() // (B * C)
    per, n_chunks = gn.row_chunks(B, rows)
    xs = x.float().reshape(B, rows, groups, C // groups)[:, : per * (n_chunks - 1)]
    n = xs.shape[1] * xs.shape[3]
    mean = xs.sum(dim=(1, 3)) / n
    var = ((xs * xs).sum(dim=(1, 3)) / n - mean * mean).clamp_min(0.0)
    w = scale.float().reshape(groups, -1) * torch.rsqrt(var + eps)[..., None]
    b = bias.float().reshape(groups, -1) - mean[..., None] * w
    y = x.float().reshape(B, rows, groups, C // groups) * w[:, None] + b[:, None]
    return (torch.nn.functional.silu(y) if silu else y).reshape(x.shape).to(x.dtype)


def phase_kernels_gn() -> tuple[dict[str, dict], int]:
    """K7 through `FusedGroupNorm`, forward and backward, at every distinct
    GroupNorm shape of one SD-1.5 CFG UNet call at batch 8, in bf16 (the
    limits of phase 3) and fp32, with times. The input carries a trend along
    the rows, as activations do, so that the statistics depend on which rows
    they cover and the dropped-chunk control is seen. Returns the rows and
    the number of K7 launches the checks made."""
    import torch.nn.functional as F

    from fairdiff_torch.models.layers import FusedGroupNorm
    from fairdiff_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(5)
    rows: dict[str, dict] = {}
    reset_counts()
    for c, hw, silu, eps in GN_SHAPES:
        side = int(round(hw**0.5))
        key = f"group_norm/{'res' if silu else 'attn'}{c}x{hw}"
        module = FusedGroupNorm(c, GN_GROUPS, eps, use_silu=silu).cuda()
        with torch.no_grad():
            module.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g, device="cuda"))
            module.bias.copy_(0.1 * torch.randn(c, generator=g, device="cuda"))
        w, b = module.weight.detach(), module.bias.detach()
        ramp = torch.linspace(0.0, 4.0, hw, device="cuda").reshape(1, side, side, 1)
        x32 = torch.randn(GN_ROWS, side, side, c, generator=g, device="cuda") + ramp
        x = x32.to(torch.bfloat16)
        args = (w, b, GN_GROUPS, eps, silu)
        with torch.no_grad():
            got = module(x)
            checks = compare(got, gn.group_norm_silu_plain(x, *args),
                             gn.group_norm_silu_plain(x32, *args), _gn_drop_last_chunk(x, *args))
            checks["f32_rel_l2"] = rel_l2(module(x32), gn.group_norm_silu_plain(x32, *args))
            # the cluster sums its CTAs' partials in rank order: a second run is bit-equal
            checks["rerun_equal"] = bool(torch.equal(module(x), got))
        if not checks["rerun_equal"]:
            checks["failed"].append("rerun not bit-equal")
        if not checks["f32_rel_l2"] <= F32_REL_L2_TOL:
            checks["failed"].append("fp32 body")
        # backward: the kernel's forward, then the plain version's autograd
        # recomputed; the plain route's gradients on the same inputs
        dy = torch.randn(x.shape, generator=g, device="cuda", dtype=torch.bfloat16)
        xg = x.clone().requires_grad_()
        module.zero_grad()
        module(xg).backward(dy)
        got = (xg.grad, module.weight.grad, module.bias.grad)
        xp, wp, bp = (t.clone().requires_grad_() for t in (x, w, b))
        gn.group_norm_silu_plain(xp, wp, bp, GN_GROUPS, eps, silu).backward(dy)
        checks["grad_rel_l2"] = max(rel_l2(a, r) for a, r in zip(got, (xp.grad, wp.grad, bp.grad)))
        if not (all(bool(torch.isfinite(t).all()) for t in got) and checks["grad_rel_l2"] <= KERNEL_REL_L2_TOL):
            checks["failed"].append("backward")
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        with torch.no_grad():
            rows[key] = dict(
                shape=f"x[{GN_ROWS},{side},{side},{c}] bf16 silu={silu}", **checks,
                ms=None, plain_ms=None,
                # one PyTorch call for the function: F.group_norm, and F.silu after
                # it where the row fuses SiLU
                library_ms=time_ms((lambda: F.silu(F.group_norm(x_nchw, GN_GROUPS, wb, bb, eps))) if silu
                                   else (lambda: F.group_norm(x_nchw, GN_GROUPS, wb, bb, eps))),
                **dict(zip(("bound_ms", "bound_by"), bound(0.0, 2.0 * 2 * x.numel()))),
            )
            rows[key]["_timed"] = (x, args)
        del x32, xg, xp, x_nchw
    n_launches = launch_counts()["group_norm"]
    for key, r in rows.items():
        x, args = r.pop("_timed")
        with torch.no_grad():
            r["ms"] = time_ms(lambda: gn.fused_group_norm_silu(x, *args))
            r["plain_ms"] = time_ms(lambda: gn.group_norm_silu_plain(x, *args))
    log(f"[kernels-gn] limits as [kernels]; fp32 body rel L2 <= {F32_REL_L2_TOL}; gradients (K7 forward, "
        f"plain backward) against the plain route's rel L2 <= {KERNEL_REL_L2_TOL}; the control leaves the "
        f"last CTA's slice of each sample's rows out of the statistics; library_ms is F.group_norm "
        f"(+ F.silu on the SiLU rows) on NCHW; K7 run twice must be bit-equal; {n_launches} K7 launches "
        f"in the checks")
    for key, r in rows.items():
        log(f"[kernels-gn] {key:24s} {r['shape']:38s} max_abs {r['max_abs_err']:.3e} (ref rms "
            f"{r['ref_rms']:.3e}, elem_use {r['elem_use']:.3f}) rel_l2 {r['rel_l2']:.3e} | vs fp32: kernel "
            f"{r['kernel_vs_f32']:.3e} plain {r['plain_vs_f32']:.3e} | control {r['control_rel_l2']:.3e} | "
            f"fp32 body {r['f32_rel_l2']:.3e} | grads {r['grad_rel_l2']:.3e} | rerun bit-equal "
            f"{r['rerun_equal']} | kernel_ms {r['ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    failed = {key: r["failed"] for key, r in rows.items() if r["failed"]}
    if failed or n_launches == 0:
        raise AssertionError(f"group norm checks failed: {failed}, {n_launches} launches")
    return rows, n_launches


def launch_counts() -> dict[str, int]:
    """The kernel launches that ran since `reset_counts`: a launch under a
    CUDA graph's capture is counted where the graph replays (phase 4b's
    pair VJPs, `training.debias.PairGraph`)."""
    from fairdiff_torch import ops

    return ops.launch_counts()


def reset_counts() -> None:
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg
    from fairdiff_torch.ops import group_norm as gn

    from fairdiff_torch.fairness import emd

    fa.launches = fa.launches_short = fa.launches_lse = fa.launches_dq = fa.launches_dkv = fa.launches_merged = 0
    gg.launches = gg.launches_dx = gn.launches = 0
    emd.solves = 0  # the native EMD solver's problems (a host library: not in launch_counts)


def native_ot_problems(cfg, steps: int, ot_draws: int, lanes: int) -> tuple[int, int]:
    """(problems the native EMD solver solved since `reset_counts`, the
    problems `steps` training steps hand it when every lane has a face)."""
    from fairdiff_torch.fairness import emd, targets

    per_step = {"ot2": ot_draws, "ot3": ot_draws,
                "enum": len(targets.enumerate_multinomial_combs(lanes, 4, 0.95)[0])}.get(cfg.target_kind, 0)
    return emd.solves, steps * per_step


# Launches of one pair VJP (a single-step UNet forward and backward, remat
# on), as the code implies. SD-1.5 has 10 flash sites (self-attention at 4096
# and 1024 tokens) and 16 feed-forwards. The first transformer block's input
# does not depend on the context, so its self-attention needs no gradient:
# it runs the lse-free forward (K1) and has no K2/K3; the other 9 sites run
# K1 with lse and K2 and K3. Every feed-forward input depends on the context
# (through its own block's cross-attention), so all 16 run K4 and K5. Remat
# runs each block's forward twice (the forward, then the recompute in the
# backward), so the forward kernels count twice.
PAIR_VJP_LAUNCHES = {"flash_attention": 2, "flash_attention_short": 0, "flash_attention_lse": 18,
                     "flash_attention_dq": 9, "flash_attention_dkv": 9, "flash_attention_bwd_merged": 0,
                     "geglu": 32, "geglu_dx": 16, "group_norm": 0}
# the same with a UNet LoRA on every attention projection: the first
# transformer block's self-attention now depends on trained weights, so it
# runs K1 with lse and K2 and K3 like the other 9 sites
PAIR_VJP_LAUNCHES_LORA = dict(PAIR_VJP_LAUNCHES, flash_attention=0, flash_attention_lse=20,
                              flash_attention_dq=10, flash_attention_dkv=10)
# the same with flash_bwd="merged": K6 takes K2's and K3's 9 launches
PAIR_VJP_LAUNCHES_MERGED = dict(PAIR_VJP_LAUNCHES, flash_attention_dq=0, flash_attention_dkv=0,
                                flash_attention_bwd_merged=9)
# `[unet-768]`'s merged pair VJP (2 rows at 768 px, remat on): of the 15 flash
# sites the first transformer block's self-attention does not depend on the
# context (K1 without lse, in the forward and in remat's recompute); the
# other 14 run K1 with lse twice and K6 once, UNET_768_D160 of the K6
# launches at D = 160; no K2 or K3. The 16 feed-forwards run K4 twice and K5
# once, as at 512 px
UNET_768_VJP_LAUNCHES_MERGED = dict(PAIR_VJP_LAUNCHES_MERGED, flash_attention_lse=28,
                                    flash_attention_bwd_merged=14)
# two runs of the merged pair VJP differ where K6's reduce-adds summed dq in
# another order and a bf16 rounding of dq flipped; every bf16 rounding after
# that point then differs too, so two runs differ by the bf16 noise of the
# whole backward, as the kernels and the plain routes do (rel L2 1.4e-2 on an
# NVIDIA H100 80GB HBM3, against 2.5e-2 for kernels vs plain routes): the
# same sanity bound holds, and the accuracy check against fp32 (each run
# within 1.1x the plain routes' error) keeps its discrimination. The witness
# that K6's run-to-run difference is only that rounding: every K6 launch is
# run twice on its operands (`_merged_rerun`: dk and dv bit-equal, dq within
# its fp32 reordering plus 1 ulp), here and in [kernels-bwd]
MERGED_RERUN_REL_L2_TOL = UNET_BF16_REL_L2_TOL
# the same with flash_bwd="recompute": every flash site runs K1 without lse,
# in the forward and again in remat's recompute (10 sites x 2), and the
# backward differentiates the plain attention, so no K1-lse, K2, K3 or K6
PAIR_VJP_LAUNCHES_RECOMPUTE = dict(PAIR_VJP_LAUNCHES, flash_attention=20, flash_attention_lse=0,
                                   flash_attention_dq=0, flash_attention_dkv=0)


def phase_unet_vjp(power: str, flash_bwd: str = "split", beside: dict | None = None, sample_size: int = 64,
                   rows: int = PAIR_ROWS, tag: str = "", want: dict | None = None, profile: bool = True) -> dict:
    """One full-width SD-1.5 pair VJP on the card, as phase 4 runs it, with
    the flash backward `flash_bwd` ("split": K2 + K3, "merged": K6,
    "recompute": autograd through the plain attention), on `rows` rows of
    `sample_size` latents (`[unet-768]` runs 2 rows at 96). The recompute
    route is also held against the split route's gradient on the same
    weights (within the sanity bound two bf16 backward routes are held to),
    and its time and peak memory are printed beside `beside`
    (`[unet-vjp]`'s). The result's `head_dims` are those of the flash
    backward launches, in order."""
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    merged, recompute = flash_bwd == "merged", flash_bwd == "recompute"
    tag = tag or {"split": "[unet-vjp]", "merged": "[unet-vjp-merged]", "recompute": "[unet-vjp-recompute]"}[flash_bwd]
    want = want or {"split": PAIR_VJP_LAUNCHES, "merged": PAIR_VJP_LAUNCHES_MERGED,
                    "recompute": PAIR_VJP_LAUNCHES_RECOMPUTE}[flash_bwd]
    parts = ("merged_dq", "merged_dk", "merged_dv") if merged else ("lse", "dq", "dk", "dv")
    g = torch.Generator().manual_seed(4)
    cfg = dataclasses.replace(UNetConfig.sd15(), sample_size=sample_size)
    unet = init_weights(UNet2DCondition(cfg, remat=True, flash_bwd=flash_bwd), g)
    unet = unet.cuda().requires_grad_(False)
    p = rows // 2
    x = torch.randn(p, sample_size, sample_size, 4, generator=g).cuda()
    cot = torch.randn(p, sample_size, sample_size, 4, generator=g).cuda() * 1e-2
    ctx0 = torch.randn(rows, 77, 768, generator=g).cuda()
    mask = (torch.arange(77)[None] < torch.tensor([[9]] * p + [[12]] * p)).int().cuda()
    per_launch: dict[str, list[dict]] = {"flash_attention_bwd": [], "geglu_dx": []}
    reruns: list[dict] = []  # merged: each K6 launch run again on its operands
    head_dims: list[int] = []  # of each flash backward launch (the checked run)

    def context_grad(model, dtype):
        ctx = ctx0.to(dtype).requires_grad_()
        eps2 = model(torch.cat([x, x]), 500, ctx, mask).float()
        eps_u, eps_c = eps2.chunk(2)
        (grad,) = torch.autograd.grad(((eps_u + 7.5 * (eps_c - eps_u)) * cot).sum(), ctx)
        return grad.float()

    bwd_name = "flash_attention_bwd_merged" if merged else "flash_attention_bwd"
    real_bwd, real_dx = getattr(fa, bwd_name), gg.geglu_dx

    def checked_bwd(q, k, v, o, lse, do):
        got = real_bwd(q, k, v, o, lse, do)
        head_dims.append(q.shape[-1])
        if merged:
            per_launch["flash_attention_bwd"].append(_merged_checks(q, k, v, o, lse, do, got))
            reruns.append(_merged_rerun(got, real_bwd(q, k, v, o, lse, do), k.shape[1]))
        else:
            per_launch["flash_attention_bwd"].append(_flash_bwd_checks(q, k, v, do, (o, lse), got)[0])
        return got

    def checked_dx(x_, w, b, dy):
        got = real_dx(x_, w, b, dy)
        per_launch["geglu_dx"].append(_geglu_dx_checks(got, x_, w, b, dy))
        return got

    unet_bf16 = copy.deepcopy(unet).to(torch.bfloat16)
    context_grad(unet_bf16, torch.bfloat16)  # warm-up (cuDNN and cuBLAS plans)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    kern = context_grad(unet_bf16, torch.bfloat16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    ran = launch_counts()
    # per-launch checks on a second run (keeps the timed run clean)
    setattr(fa, bwd_name, checked_bwd)
    gg.geglu_dx = checked_dx
    try:
        kern2 = context_grad(unet_bf16, torch.bfloat16)
    finally:
        setattr(fa, bwd_name, real_bwd)
        gg.geglu_dx = real_dx

    with routes(plain_attention, gg.geglu_plain):
        plain = context_grad(unet_bf16, torch.bfloat16)
        exact = context_grad(unet, torch.float32)
    with routes(drop_last_tile, gg.geglu_plain):
        dropped = context_grad(unet_bf16, torch.bfloat16)
    for name, rs in per_launch.items():
        pts = parts if name == "flash_attention_bwd" else (None,)
        flat = [r[pt] if pt else r for r in rs for pt in pts]
        if flat:
            log(f"{tag} {name}: {len(rs)} launches, each against its plain version: worst elem_use "
                f"{max(r['elem_use'] for r in flat):.3f}, worst rel_l2 {max(r['rel_l2'] for r in flat):.3e}, "
                f"worst kernel/plain error vs fp32 "
                f"{max(r['kernel_vs_f32'] / r['plain_vs_f32'] for r in flat):.3f}, weakest dropped-tile "
                f"control {min(r['control_rel_l2'] for r in flat):.3e}")
    if reruns:
        log(f"{tag} each K6 launch run twice on its operands: dk, dv bit-equal in "
            f"{sum(r['dk_equal'] and r['dv_equal'] for r in reruns)} of {len(reruns)}; dq differs in "
            f"{sum(r['dq_differ'] for r in reruns)} of {sum(r['dq_n'] for r in reruns)} elements, "
            f"{sum(r['dq_over_ulp'] for r in reruns)} by more than 1 ulp, worst diff "
            f"{max(r['dq_worst'] for r in reruns):.3f}x its allowance")
    e_kp, e_k, e_p = rel_l2(kern, plain), rel_l2(kern, exact), rel_l2(plain, exact)
    e_d = rel_l2(dropped, exact)
    # the split kernels sum in a fixed order: two runs agree bit for bit; K6's
    # reduce-adds do not, so the merged route is held to a tolerance instead
    e_rerun = rel_l2(kern2, kern)
    rerun_ok = (e_rerun <= MERGED_RERUN_REL_L2_TOL and rel_l2(kern2, exact) <= UNET_BF16_ACCURACY_RATIO * e_p
                if merged else bool(torch.equal(kern, kern2)))
    log(f"{tag} SD-1.5 pair VJP ({rows} rows of {sample_size}x{sample_size} latents, bf16, remat, "
        f"flash_bwd={flash_bwd!r}), d surrogate / d context: "
        f"kernels vs plain routes rel L2 {e_kp:.3e}; vs fp32: kernels {e_k:.3e}, plain {e_p:.3e} (kernels "
        f"<= {UNET_BF16_ACCURACY_RATIO} x plain); dropped-tile control vs fp32 {e_d:.3e} (ratio "
        f"{e_d / e_p:.3f}, must exceed {UNET_BF16_ACCURACY_RATIO}); two runs of the kernels: rel L2 "
        f"{e_rerun:.3e}, bit-equal {bool(torch.equal(kern, kern2))}"
        + (f" (tol {MERGED_RERUN_REL_L2_TOL:.0e}: K6's dq summation order)" if merged else ""))
    log(f"{tag} {seconds:.3f} s for one VJP after a warm-up, peak memory {peak_gib:.2f} GiB "
        f"above the weights; launches {ran} (want {want}) on {power}")
    e_split = None
    if recompute:
        attn = [m for m in unet_bf16.modules() if hasattr(m, "flash_bwd")]
        for m in attn:
            m.flash_bwd = "split"
        try:
            e_split = rel_l2(kern, context_grad(unet_bf16, torch.bfloat16))
        finally:
            for m in attn:
                m.flash_bwd = flash_bwd
        log(f"{tag} against the split route (K1-lse, K2, K3) on the same weights: rel L2 {e_split:.3e} "
            f"(tol {UNET_BF16_REL_L2_TOL:.0e})")
    failed = [f"{name} launch {i} {pt}: {r[pt]['failed'] if pt else r['failed']}"
              for name, rs in per_launch.items() for i, r in enumerate(rs)
              for pt in (parts if name == "flash_attention_bwd" else (None,))
              if (r[pt]["failed"] if pt else r["failed"])]
    failed += [f"K6 launch {i} rerun: {r['failed']}" for i, r in enumerate(reruns) if r["failed"]]
    failed += [name for name, ok in (
        ("launches", ran == want),
        ("checked launches", [len(per_launch["flash_attention_bwd"]), len(per_launch["geglu_dx"])] == [
            want["flash_attention_bwd_merged" if merged else "flash_attention_dq"], want["geglu_dx"]]),
        ("recompute vs split", e_split is None or e_split <= UNET_BF16_REL_L2_TOL),
        ("finite", bool(torch.isfinite(kern).all())),
        ("non-zero", kern.abs().max().item() > 0),
        ("rerun", rerun_ok),
        ("rel L2", e_kp <= UNET_BF16_REL_L2_TOL),
        ("accuracy", e_k <= UNET_BF16_ACCURACY_RATIO * e_p),
        ("control", e_d > UNET_BF16_ACCURACY_RATIO * e_p),
    ) if not ok]
    if failed:
        raise AssertionError(f"{tag} pair VJP checks failed: {failed}")
    kernel_ms = profile_pair_vjp(lambda: context_grad(unet_bf16, torch.bfloat16), seconds, tag) if profile else None
    if beside:
        ms = lambda x: "not measured" if x is None else f"{x:.3f}"
        log(f"{tag} beside [unet-vjp]: wall {seconds:.3f} vs {beside['seconds']:.3f} s, kernel time "
            f"{ms(kernel_ms)} vs {ms(beside['kernel_ms'])} ms, peak {peak_gib:.2f} vs {beside['peak_gib']:.2f} GiB "
            f"above the weights on {power}")
    return {"seconds": seconds, "peak_gib": peak_gib, "launches": ran, "kernel_ms": kernel_ms, "head_dims": head_dims}


# host calls that wait for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
              "aten::_local_scalar_dense", "aten::nonzero", "aten::equal")


def profile_pair_vjp(run, wall_s: float, tag: str = "[unet-vjp]") -> float | None:
    """Where one pair VJP's device time goes, by kernel name, and its host
    time, by op; -> the kernel time in ms (None where the profiler recorded
    no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0.0:
        log(f"{tag} kernel time not measured (the profiler recorded no device time)")
        return None
    log(f"{tag} profile of one pair VJP: {busy:.3f} ms kernel time, device idle share "
        f"{max(0.0, 1 - busy / (wall_s * 1e3)):.3f} against the timed run's wall")
    # the port's kernels by family, from their CUDA names (K4: `k4::` and the
    # fp32 body; K5: the dproj and dx GEMMs `gm::`, the split-K sum and the
    # fp32 body)
    for family, keys in (("K1-K3/K6 flash", ("flash",)), ("K4 geglu fwd", ("k4::", "geglu_fwd")),
                         ("K5 geglu dx", ("gm::", "dx_reduce", "geglu_dx"))):
        hits = [e for e in events if any(k in e.key for k in keys)]
        log(f"{tag}   {family}: {sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms in "
            f"{sum(e.count for e in hits)} kernel launches")
    for e in events[:14]:
        log(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
            f"{100 * e.self_device_time_total / 1e3 / busy:5.1f}%  {e.key[:90]}")
    # the host side, in a second run: the ops that hold the host longest and
    # every call that waits for the device
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    waits = {e.key: e.count for e in host if e.key in HOST_WAITS and e.count}
    log(f"{tag} host profile of one pair VJP ({wall:.3f} s wall, profiler on): waits for the device {waits}")
    for e in host[:12]:
        log(f"{tag}   host {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return busy


# bench.py's detector heads for the costliest case: with zero head kernels
# the heads output their biases, so every anchor scores sigmoid(4) > 0.6, its
# box spans 2 stride units each side and its landmarks form a face pattern
# (in stride units) that keeps the alignment well posed
DETECTOR_NPZ = Path(__file__).resolve().parent / "assets" / "detector.npz"


def seed_guidance_dir(directory: str | Path, *, seed: int = 0, detector_npz: str | Path = DETECTOR_NPZ) -> Path:
    """Write a guidance directory that `load_guidance_stack` reads for
    exp-1's attributes, in the JAX package's file format: the detector
    `.npz` with its three output heads set as bench.py sets them
    (`EVERY_LANE_DETECTS`; random-weight SD images hold no face the trained
    detector finds, and without a face the fairness loss is 0), and a
    CelebA-head classifier and an SFNet-20 face embedder with seeded random
    weights (`init_weights`)."""
    import numpy as np

    from fairdiff_torch.io.adapters_io import load_adapters, save_adapters
    from fairdiff_torch.io import from_jax
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
    from fairdiff_torch.models.sfnet import SFNet, SFNetConfig

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tree = load_adapters(detector_npz)
    for head in EVERY_LANE_DETECTS:
        tree[head]["kernel"] = np.zeros_like(tree[head]["kernel"])
        tree[head]["bias"] = every_lane_detects_bias(head, tree[head]["bias"].shape[0])
    save_adapters(d / "detector.npz", tree)
    g = torch.Generator().manual_seed(seed)
    save_adapters(d / "classifier.npz", from_jax.jax_tree_from_module(init_weights(MobileNetV3Large(80), g)))
    save_adapters(d / "face_embedder.npz", from_jax.jax_tree_from_module(init_weights(SFNet(SFNetConfig.sfnet20()), g)))
    (d / "face_embedder_variant.txt").write_text("sfnet20\n")
    return d


_SD15: dict = {}  # (flash_bwd, seed) -> the SD-1.5 that `random_trainer` shares


def random_trainer(cfg):
    """`train_debias.build_trainer(cfg)` for a run on seeded random SD
    weights and the synthetic guidance, on one SD-1.5 for each backward
    route and seed: the first call builds it through `build_trainer`, later
    ones put a new trainer on it, so the seeded init of about a billion
    weights runs once. A trainer changes no weight of its model."""
    from fairdiff_torch.tools import train_debias
    from fairdiff_torch.training.debias import DebiasTrainer
    from fairdiff_torch.training.synthetic import synthetic_stack

    if cfg.model_dir or cfg.guidance_dir or cfg.distributed:
        raise ValueError("random_trainer builds runs on random weights and the synthetic guidance only")
    key = (cfg.flash_bwd, cfg.seed)
    if key not in _SD15:
        trainer = train_debias.build_trainer(cfg)
        _SD15[key] = trainer.sd
        return trainer
    dcfg = train_debias.debias_config(cfg)
    sd = _SD15[key]
    return DebiasTrainer(sd, synthetic_stack(dcfg.attributes, device=sd.device), dcfg)


def phase_train(flash_bwd: str = "split", zoo: bool = False, experiment: str = "exp1",
                steps: int = 4, model_dir: str = "", guidance_dir: str = "", tokenizer_dir: str = "") -> dict[str, int]:
    """The slice: train_debias.main at full width for 2 optimizer steps of
    `experiment` (4 lanes, micro-batch 2, `steps` denoising steps); with
    `zoo`, on a guidance directory this phase writes (`seed_guidance_dir`:
    assets/detector.npz with bench.py's every-lane-detects heads, seeded
    classifier.npz and face_embedder.npz), and with `flash_bwd`. exp-5 reads
    two prompt files this phase writes (repeats 1 and 6). With `model_dir`
    and `guidance_dir` (`[weights]`), on converted SD weights and a converted
    guidance directory, whose CLIP and DINO terms are logged. With
    `tokenizer_dir`, the prompts go through that CLIP tokenizer. The adapters moved:
    every LoRA `up` leaf (0 at the start) is non-zero, or the exported
    prefix table differs from its initial rows, and `gen_images` reads it
    back."""
    import io

    import numpy as np

    from fairdiff_torch.io.adapters_io import load_adapters
    from fairdiff_torch.tools import gen_images, train_debias
    from fairdiff_torch.utils.tree import tree_leaves

    tag = ("[weights] train" if model_dir else "[train-cli-zoo]" if zoo else "[train]" if experiment == "exp1"
           else f"[train-exps] {experiment}")
    root = Path(__file__).resolve().parent
    scratch = root / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        if zoo:
            guidance_dir = str(seed_guidance_dir(Path(tmp) / "guidance", seed=7))
        multi = ""
        if experiment == "exp5":
            domains = {"occupation": ["a photo of the face of a doctor, a person"],
                       "sports": ["a photo of the face of a tennis player, a person",
                                  "a photo of the face of a swimmer, a person"]}
            for name, prompts in domains.items():
                (Path(tmp) / f"{name}.json").write_text(json.dumps({"train_prompts": prompts}))
            multi = ",".join(str(Path(tmp) / f"{name}.json") for name in domains)
        cfg = train_debias.TrainCLIConfig(
            experiment=experiment, max_train_steps=2, train_images_per_prompt=4, train_micro_batch=2,
            steps=steps, output_dir=str(Path(tmp) / "out"), model_dir=model_dir, guidance_dir=guidance_dir,
            flash_bwd=flash_bwd, tokenizer_dir=tokenizer_dir,
            multi_prompts_json=multi, multi_prompts_repeats="1,6",
        )
        trainer = (train_debias.build_trainer(cfg) if model_dir or guidance_dir else random_trainer(cfg))
        prefix = trainer.cfg.train_prefix
        if prefix:  # the rows main's init_state draws (the same seed)
            init_rows = trainer.init_state(cfg.seed).adapters["prefix"].detach().cpu().numpy()
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_debias.main(cfg, trainer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = launch_counts()
        solved, want_solved = native_ot_problems(trainer.cfg, 2, trainer.ot_draws, 4)
        lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
        for x in lines:
            log(f"{tag} {json.dumps(x)}")
        export = Path(cfg.output_dir) / "exported"
        if prefix:
            saved = load_adapters(export / "prefix.npz")
            moved = list(saved) == ["prefix"] and not np.array_equal(saved["prefix"], init_rows)
            written = gen_images.main(gen_images.GenImagesConfig(
                load_prefix_embedding_from=str(export / "prefix.npz"), num_imgs_per_prompt=1, batch_size=1,
                num_denoising_steps=2, save_dir=str(Path(tmp) / "gen")))
            moved = moved and len(written) == 1 and written[0].stat().st_size > 0
            what = f"prefix table {saved['prefix'].shape} moved and read back by gen_images: {moved}"
        else:
            saved = load_adapters(export / "te_lora.npz")
            ups = [a for path, a in _npz_leaves(saved) if path[-1] == "up"]
            moved = bool(ups) and all(np.abs(a).max() > 0 for a in ups)  # `up` starts at 0
            what = f"{len(tree_leaves(saved))} LoRA leaves saved, every `up` moved: {moved}"
    pairs = steps * (4 // 2)  # pair VJPs a step (steps x lane chunks)
    calls = 2 * steps  # no-grad CFG UNet calls a step (phases 1 and 3)
    per_pair = PAIR_VJP_LAUNCHES_MERGED if flash_bwd == "merged" else PAIR_VJP_LAUNCHES
    want = {k: 2 * (calls * UNET_CALL_LAUNCHES.get(k, 0) + pairs * v) for k, v in per_pair.items()}
    log(f"{tag} train_debias.main --experiment {experiment}: SD-1.5, 2 steps x 4 lanes, micro-batch 2, "
        f"{steps} denoising steps, SD weights {'from ' + repr(model_dir) if model_dir else 'random'}, "
        f"guidance {'from ' + repr(Path(guidance_dir).name) if guidance_dir else 'synthetic'}, "
        f"tokenizer {'CLIP BPE' if tokenizer_dir else 'hash'}, "
        f"flash_bwd={flash_bwd!r}, {seconds:.2f} s incl. setup; {what}; launches {ran} (want {want}); "
        f"OT problems on the native EMD solver {solved} (want {want_solved})")
    failed = [name for name, ok in (
        ("two steps", [x["step"] for x in lines] == [1, 2]),
        ("finite grads", all(x["grads_finite"] and x["grad_norm"] > 0 for x in lines)),
        ("logged", all("face_rate" in x and np.isfinite(x.get("train_loss", np.nan)) for x in lines)),
        ("faces", all(x["face_rate"] == 1.0 for x in lines)),
        ("clip and dino logged", not model_dir or all(
            np.isfinite(x.get("train_loss_CLIP", np.nan)) and np.isfinite(x.get("train_loss_DINO", np.nan))
            for x in lines)),
        ("adapters moved", moved),
        ("launches", ran == want),
        ("native OT", solved == want_solved),
    ) if not ok]
    if failed:
        raise AssertionError(f"{tag} failed: {failed}")
    return ran


TRAIN_EXPS = ("exp2", "exp3", "exp4", "exp5", "exp6")


def phase_train_exps(steps: int = 4) -> None:
    """`phase_train` for exp-2 to exp-6 on the synthetic stack."""
    for experiment in TRAIN_EXPS:
        phase_train(experiment=experiment, steps=steps)


def _npz_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _npz_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# each zoo model in bf16 against the same seeded weights in fp32 on the card:
# bf16 rounding noise carried through the model's depth
ZOO_BF16_REL_L2_TOL = 5e-2
# the detector on its trained weights, fp32 on the card (TF32 off) against
# fp32 on the CPU: summation order only
DET_CPU_REL_L2_TOL = 1e-4


def _zoo_out(name: str, out) -> torch.Tensor:
    """A zoo model's output as one [N, -1] fp32 tensor."""
    if name == "face_detector":
        return torch.cat([t.flatten(1).float() for maps in out.values() for t in maps], dim=1)
    return (out["image_embeds"] if name == "clip_vision" else out).float()


def phase_zoo() -> dict[str, dict]:
    """Each real-architecture guidance model at full width on the card in
    bf16 against the same seeded weights in fp32 on the card, with its bf16
    forward time at batch 8; then the detector on assets/detector.npz, card
    against CPU in fp32, raw heads and the selected faces."""
    from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
    from fairdiff_torch.models.face_detector import (
        DetectorConfig, FaceDetectorNet, load_detector_npz, make_detect_fn,
    )
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
    from fairdiff_torch.models.sfnet import SFNet, SFNetConfig

    g = torch.Generator().manual_seed(6)
    rows: dict[str, dict] = {}
    for name, ctor, size in (
        ("face_detector", lambda: FaceDetectorNet(DetectorConfig()), 512),
        ("mobilenet_v3", lambda: MobileNetV3Large(80), 224),
        ("clip_vision", lambda: CLIPVisionModel(CLIPVisionConfig.vit_h14()), 224),
        ("dinov2", lambda: DINOv2Model(DINOv2Config.vitb14()), 224),
        ("sfnet", lambda: SFNet(SFNetConfig.sfnet20()), 112),
    ):
        m32 = init_weights(ctor(), g).cuda().eval().requires_grad_(False)
        x = (torch.rand(8, size, size, 3, generator=g) * 2 - 1).cuda()
        with torch.no_grad():
            ref = _zoo_out(name, m32(x))
            m16 = copy.deepcopy(m32).to(torch.bfloat16)
            got = _zoo_out(name, m16(x))
            ms = time_ms(lambda: m16(x), iters=5, warmup=1)
        rows[name] = dict(rel_l2=rel_l2(got, ref), finite=bool(torch.isfinite(got).all()), ms=ms,
                          ref_rms=ref.pow(2).mean().sqrt().item())
        log(f"[zoo] {name:14s} x[8,{size},{size},3]: bf16 vs fp32 on the card rel L2 {rows[name]['rel_l2']:.3e} "
            f"(tol {ZOO_BF16_REL_L2_TOL:.0e}, out rms {rows[name]['ref_rms']:.3e}), bf16 forward {ms:.3f} ms")
        del m32, m16
        torch.cuda.empty_cache()
    cfg = DetectorConfig()
    weights = Path(__file__).resolve().parent / "assets" / "detector.npz"
    x = torch.rand(2, 512, 512, 3, generator=g) * 2 - 1
    nets = {dev: load_detector_npz(weights, torch.float32, dev) for dev in ("cpu", "cuda")}
    with torch.no_grad():
        raw = {dev: _zoo_out("face_detector", net(x.to(dev))).cpu() for dev, net in nets.items()}
        faces = {dev: make_detect_fn(net, cfg)(x.to(dev)) for dev, net in nets.items()}
    det_rel = rel_l2(raw["cuda"], raw["cpu"])
    score_err = (faces["cuda"].scores.cpu() - faces["cpu"].scores).abs().max().item()
    same_faces = bool(torch.equal(faces["cuda"].indicators.cpu(), faces["cpu"].indicators))
    log(f"[zoo] detector on assets/detector.npz, x[2,512,512,3] fp32: card vs CPU raw heads rel L2 {det_rel:.3e} "
        f"(tol {DET_CPU_REL_L2_TOL:.0e}); selected faces {faces['cpu'].indicators.tolist()} on both: {same_faces}, "
        f"score max abs diff {score_err:.3e}")
    failed = [f"{name}: rel L2 {r['rel_l2']:.3e}" for name, r in rows.items()
              if not (r["finite"] and r["rel_l2"] <= ZOO_BF16_REL_L2_TOL and r["ref_rms"] > 0)]
    if not (det_rel <= DET_CPU_REL_L2_TOL and same_faces and score_err <= 1e-4):
        failed.append(f"detector card vs CPU: rel L2 {det_rel:.3e}, faces {same_faces}, scores {score_err:.3e}")
    if failed:
        raise AssertionError(f"zoo checks failed: {failed}")
    return rows


def phase_train_step(power: str, zoo: bool = False, experiment: str = "exp1", unet: bool = False,
                     lanes: int = 0) -> dict:
    """One timed step of `experiment` at its preset's shape (exp-1: 24
    lanes, exp-3: 32 and 200 OT draws; micro-batch 4; 19 denoising steps)
    after a warm-up step of 2 denoising steps (every shape the step runs),
    on the synthetic guidance stack or, with `zoo`,
    bench.py's filled real-architecture zoo (`filled_zoo_stack`); with
    `unet`, the UNet LoRA trains too (its gradient finite and non-zero).
    exp-3 stays on the synthetic stack: the filled zoo gives every lane the
    same probabilities, so every OT problem would be one tie."""
    import numpy as np

    from fairdiff_torch.io.tokenizer import HashTokenizer
    from fairdiff_torch.tools import train_debias
    from fairdiff_torch.utils.tree import tree_leaves

    tag = ("[train-zoo]" if zoo else "[train-unet-lora]" if unet else "[train-step]" if experiment == "exp1"
           else f"[train-{experiment}]")
    cfg = train_debias.TrainCLIConfig(experiment=experiment, steps=19, train_images_per_prompt=lanes)
    trainer = random_trainer(cfg)
    if unet:
        trainer.cfg = dataclasses.replace(trainer.cfg, train_unet=True)
    if zoo:
        trainer.guidance = filled_zoo_stack()
    ids = train_debias.tokenize_prompts(trainer.sd, HashTokenizer(), list(train_debias.DEFAULT_PROMPTS))
    state = trainer.init_state(cfg.seed)
    state, _ = trainer.train_step(state, ids[0], n_steps=2)  # warm-up: every shape of the step, 2 denoising steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, logs = trainer.train_step(state, ids[1])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ran = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    split = {k: round(v, 3) for k, v in trainer.timers.last.items()}
    dcfg = trainer.cfg
    steps, lanes, p = 19, dcfg.train_images_per_prompt, dcfg.train_micro_batch
    want = {k: 2 * steps * UNET_CALL_LAUNCHES.get(k, 0) + steps * (lanes // p) * v
            for k, v in (PAIR_VJP_LAUNCHES_LORA if unet else PAIR_VJP_LAUNCHES).items()}
    ot = f", {trainer.ot_draws} OT draws" if dcfg.target_kind in ("ot2", "ot3") else ""
    log(f"{tag} {experiment} step, SD-1.5 bf16, {lanes} lanes, micro-batch {p}, 19 denoising steps{ot}, "
        f"{'filled real-architecture zoo' if zoo else 'synthetic'} guidance: {seconds:.3f} s/step on {power}; "
        f"peak memory {peak_gib:.2f} GiB; phases (s) {split}")
    solved, want_solved = native_ot_problems(dcfg, 1, trainer.ot_draws, lanes)
    log(f"{tag} phase 2 ({dcfg.target_kind} targets, host): {trainer.timers.last['phase2_targets']:.4f} s; "
        f"OT problems on the native EMD solver {solved} (want {want_solved})")
    log(f"{tag} launches in the step {ran} (want {want})")
    log(f"{tag} logs {json.dumps(logs)}")
    kept = {a: int((t != -1).sum()) for a, t in trainer._last_targets.items()}
    log(f"{tag} lanes with a target: {kept} of {lanes}")
    # the filled zoo's outputs are its biases, whatever the images, so its
    # step's gradients are 0 by construction (as in bench.py): that step is
    # held to finite gradients, a finite loss, a face in every lane and the
    # launch counts; the synthetic step to non-zero gradients too
    moved = logs["grad_norm"] > 0 if not zoo else logs["face_rate"] == 1.0 and np.isfinite(logs["train_loss"])
    # every attribute keeps a lane, and the multi-attribute metrics are logged
    targeted = all(n > 0 for n in kept.values()) if dcfg.target_kind != "binary" else True
    metrics = {"ot2": ("race_gap", "gender_race_gap"), "ot3": ("race_gap", "gender_race_gap", "age_gap"),
               "enum": ("race_gap",)}.get(dcfg.target_kind, ())
    if unet:
        g_unet = torch.cat([t.flatten() for t in tree_leaves(trainer._last_grads["unet_lora"])])
        log(f"{tag} unet_lora gradient: {g_unet.numel()} elements, norm {g_unet.norm().item():.4e}")
        moved = moved and bool(torch.isfinite(g_unet).all()) and g_unet.abs().max().item() > 0
    if not (logs["grads_finite"] and moved and logs["num_denoising_steps"] == 19 and ran == want
            and targeted and all(k in logs for k in metrics) and solved == want_solved):
        raise AssertionError(f"{tag} failed: {logs}, launches {ran}, lanes with a target {kept}")
    return {"seconds": seconds, "peak_gib": peak_gib, "split": split}


# remat on against off: the recompute is the forward's own kernels on the
# same operands, so the gradients agree to the bf16 rounding of the
# backward's sums at most
REMAT_REL_L2_TOL = 1e-3


def phase_unet_vjp_lora(power: str) -> dict:
    """One full-width SD-1.5 pair VJP (8 rows, bf16, split backward) with a
    UNet LoRA of rank 4 on every attention projection (`up` drawn non-zero,
    so `down` gets a gradient), through `functional_call` with the merged
    weights as `StableDiffusion.unet_eps` runs it: the LoRA gradient and the
    context gradient with remat on against remat off, and both against the
    plain routes and an fp32 run (within 1.1x the plain routes' error);
    exact launch counts, kernel time and idle share, peak memory."""
    from torch.func import functional_call

    from fairdiff_torch.adapters import lora as lora_lib
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg
    from fairdiff_torch.utils.tree import tree_leaves, tree_map

    tag = "[unet-vjp-lora]"
    g = torch.Generator().manual_seed(5)
    unet = init_weights(UNet2DCondition(UNetConfig.sd15(), remat=True), g).cuda().requires_grad_(False)
    lora = lora_lib.init_lora(unet, lora_lib.unet_attention_targets, 4, g)
    lora = tree_map(lambda x: (torch.randn(x.shape, generator=g) * 0.02 if x.abs().max() == 0 else x).cuda(),
                    lora)
    leaves = [x.requires_grad_() for x in tree_leaves(lora)]
    p = PAIR_ROWS // 2
    x = torch.randn(p, 64, 64, 4, generator=g).cuda()
    cot = torch.randn(p, 64, 64, 4, generator=g).cuda() * 1e-2
    ctx0 = torch.randn(PAIR_ROWS, 77, 768, generator=g).cuda()
    mask = (torch.arange(77)[None] < torch.tensor([[9]] * p + [[12]] * p)).int().cuda()

    def grads(model, dtype):
        ctx = ctx0.to(dtype).requires_grad_()
        weights = lora_lib.apply_lora(model, lora)
        eps2 = functional_call(model, weights, (torch.cat([x, x]), 500, ctx, mask), {"weights": weights}).float()
        eps_u, eps_c = eps2.chunk(2)
        out = torch.autograd.grad(((eps_u + 7.5 * (eps_c - eps_u)) * cot).sum(), [ctx, *leaves])
        return out[0].float(), torch.cat([o.flatten() for o in out[1:]])

    unet_bf16 = copy.deepcopy(unet).to(torch.bfloat16)
    runs: dict[bool, dict] = {}
    for remat in (True, False):
        unet_bf16.remat = remat
        grads(unet_bf16, torch.bfloat16)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        out = grads(unet_bf16, torch.bfloat16)
        torch.cuda.synchronize()
        runs[remat] = {"grads": out, "seconds": time.perf_counter() - t0, "launches": launch_counts(),
                       "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    unet_bf16.remat = True
    (ctx_on, lora_on), (ctx_off, lora_off) = runs[True]["grads"], runs[False]["grads"]
    e_ctx, e_lora = rel_l2(ctx_on, ctx_off), rel_l2(lora_on, lora_off)
    equal = bool(torch.equal(ctx_on, ctx_off) and torch.equal(lora_on, lora_off))

    with routes(plain_attention, gg.geglu_plain):
        ctx_plain, lora_plain = grads(unet_bf16, torch.bfloat16)
        ctx_exact, lora_exact = grads(unet, torch.float32)
    acc = {}
    for what, kern, plain, exact in (("context", ctx_on, ctx_plain, ctx_exact),
                                     ("LoRA", lora_on, lora_plain, lora_exact)):
        acc[what] = (rel_l2(kern, exact), rel_l2(plain, exact), rel_l2(kern, plain))
        log(f"{tag} {what} gradient: kernels vs fp32 {acc[what][0]:.3e}, plain routes vs fp32 "
            f"{acc[what][1]:.3e} (kernels <= {UNET_BF16_ACCURACY_RATIO} x plain), kernels vs plain "
            f"{acc[what][2]:.3e}; norm {kern.norm().item():.4e}")
    on, off = runs[True], runs[False]
    log(f"{tag} SD-1.5 pair VJP (8 rows, bf16, split backward) with a rank-4 UNet LoRA on "
        f"{len(leaves) // 2} projections: remat on vs off rel L2 context {e_ctx:.3e}, LoRA {e_lora:.3e} "
        f"(tol {REMAT_REL_L2_TOL:.0e}), bit-equal {equal}")
    log(f"{tag} remat on: {on['seconds']:.3f} s, peak {on['peak_gib']:.2f} GiB above the weights; remat off: "
        f"{off['seconds']:.3f} s, peak {off['peak_gib']:.2f} GiB; launches {on['launches']} (want "
        f"{PAIR_VJP_LAUNCHES_LORA}; remat off {off['launches']}) on {power}")
    want_off = dict(PAIR_VJP_LAUNCHES_LORA, flash_attention_lse=10, geglu=16)  # no recompute
    failed = [name for name, ok in (
        ("launches", on["launches"] == PAIR_VJP_LAUNCHES_LORA),
        ("launches remat off", off["launches"] == want_off),
        ("finite", bool(torch.isfinite(ctx_on).all() and torch.isfinite(lora_on).all())),
        ("non-zero", ctx_on.abs().max().item() > 0 and lora_on.abs().max().item() > 0),
        ("remat context", e_ctx <= REMAT_REL_L2_TOL),
        ("remat LoRA", e_lora <= REMAT_REL_L2_TOL),
        ("accuracy context", acc["context"][0] <= UNET_BF16_ACCURACY_RATIO * acc["context"][1]),
        ("accuracy LoRA", acc["LoRA"][0] <= UNET_BF16_ACCURACY_RATIO * acc["LoRA"][1]),
    ) if not ok]
    if failed:
        raise AssertionError(f"{tag} failed: {failed}")
    profile_pair_vjp(lambda: grads(unet_bf16, torch.bfloat16), on["seconds"], tag)
    return {"seconds": on["seconds"], "peak_gib": on["peak_gib"], "peak_gib_no_remat": off["peak_gib"]}


def _opt_moments(state) -> list[torch.Tensor]:
    return [v for st in state.opt.state_dict()["state"].values() for k, v in sorted(st.items())
            if k in ("exp_avg", "exp_avg_sq")]


def phase_train_lifecycle(steps: int = 4) -> dict[str, int]:
    """`train_debias.main` over a config file this phase writes (UNet and
    text-encoder LoRA), at full width (4 lanes, micro-batch 2, `steps`
    denoising steps, evaluation every 2 steps on 2 images at 4 denoising
    steps, a checkpoint every 2 steps): run A takes 4 steps unbroken; run B
    takes 2, then a second `main` resumes it from its checkpoint to step 4.
    B's step, update count, adapters, EMA and AdamW moments against A's
    (rel L2 1e-3; bit-equality printed), the same prompt order, `eval_` and
    `eval_ema_` keys at steps 2 and 4 in metrics.jsonl, the grids, then
    `export_checkpoint` (.npz and .pth) and `gen_images` reading
    unet_lora.pth; exact launch counts, evaluation's generations
    included."""
    import io

    import numpy as np

    from fairdiff_torch.io.adapters_io import load_adapters
    from fairdiff_torch.tools import export_checkpoint, gen_images, train_debias
    from fairdiff_torch.utils.tree import tree_leaves

    tag = "[train-lifecycle]"
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        config = Path(tmp) / "run.yaml"  # JSON syntax, which is YAML too
        config.write_text(json.dumps({"train_unet": True, "train_text_encoder": True,
                                      "val_images_per_prompt": 2, "eval_denoising_steps": 4}))
        base = train_debias.TrainCLIConfig(
            max_train_steps=4, train_images_per_prompt=4, train_micro_batch=2, steps=steps, eval_interval=2,
            checkpoint_tmp_every=2, debias_config=str(config),
        )
        trainer = random_trainer(base)
        seen: list[int] = []
        real_step = trainer.train_step

        def recording_step(state, prompt_ids, **kw):
            seen.append(int(torch.as_tensor(prompt_ids[0]).sum()))  # identifies the prompt
            return real_step(state, prompt_ids, **kw)

        trainer.train_step = recording_step
        runs: dict[str, tuple] = {}
        reset_counts()
        t0 = time.perf_counter()
        for name, plan in (("A", [(4, False)]), ("B", [(2, False), (4, True)])):
            seen.clear()
            out_dir = str(Path(tmp) / name)
            for max_steps, resume in plan:
                trainer._ori_grid_cache.clear()  # as a new process would start
                trainer.cfg = dataclasses.replace(trainer.cfg, max_train_steps=max_steps, output_dir=out_dir)
                with contextlib.redirect_stdout(io.StringIO()):
                    state = train_debias.main(dataclasses.replace(
                        base, max_train_steps=max_steps, output_dir=out_dir, resume_from_checkpoint=resume), trainer)
            runs[name] = (state, list(seen), out_dir)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = launch_counts()
        (sa, order_a, dir_a), (sb, order_b, dir_b) = runs["A"], runs["B"]
        compared = {}
        for what, a, b in (("adapters", tree_leaves(sa.adapters), tree_leaves(sb.adapters)),
                           ("ema", tree_leaves(sa.ema), tree_leaves(sb.ema)),
                           ("adamw moments", _opt_moments(sa), _opt_moments(sb))):
            va, vb = torch.cat([t.detach().flatten() for t in a]), torch.cat([t.detach().flatten() for t in b])
            compared[what] = (rel_l2(vb, va), bool(torch.equal(va, vb)))
        log(f"{tag} run A 4 steps unbroken, run B 2 steps then resumed to 4: "
            + "; ".join(f"{w} rel L2 {e:.3e} bit-equal {eq}" for w, (e, eq) in compared.items())
            + f"; step {sa.step}/{sb.step}, updates {sa.updates}/{sb.updates}; prompt order {order_a} / {order_b}")
        records = [json.loads(x) for x in (Path(dir_b) / "metrics.jsonl").read_text().splitlines()]
        evals = {(r["step"], "eval_ema_" if k.startswith("eval_ema_") else "eval_")
                 for r in records for k in r if k.startswith("eval_")}
        grids = sorted(p.name for p in (Path(dir_b) / "imgs").glob("*.jpg"))
        log(f"{tag} run B metrics.jsonl: {len(records)} records, evaluations {sorted(evals)}; "
            f"{len(grids)} grids: {grids}")
        exported = export_checkpoint.main(export_checkpoint.ExportConfig(
            debias_config=str(config), checkpoint_dir=str(Path(dir_b) / "checkpoints"), reference_format=True))
        files = sorted(p.name for p in exported.iterdir())
        same_export = all(np.array_equal(a, b) for a, b in zip(
            _npz_leaves_list(load_adapters(exported / "unet_lora.npz")),
            _npz_leaves_list(load_adapters(Path(dir_b) / "exported" / "unet_lora.npz"))))
        reset_gen = launch_counts()
        written = gen_images.main(gen_images.GenImagesConfig(
            load_unet_lora_from=str(exported / "unet_lora.pth"), num_imgs_per_prompt=1, batch_size=1,
            num_denoising_steps=2, save_dir=str(Path(tmp) / "gen")))
        gen_calls = {k: launch_counts()[k] - reset_gen[k] for k in reset_gen}
        gen_ok = len(written) == 1 and written[0].stat().st_size > 0
        log(f"{tag} export_checkpoint of step 4: {files}; unet_lora.npz equal to the run's export: {same_export}; "
            f"gen_images read unet_lora.pth and wrote {[w.name for w in written]} ({written[0].stat().st_size} bytes)")
    # CFG UNet calls: 2 a denoising step of a training step (phases 1, 3);
    # an evaluation samples its prompt with the adapters and with their EMA,
    # and the frozen model once a process (its grid is copied later)
    per_step_calls, per_step_pairs, ev = 2 * steps, steps * 2, 4
    train_steps = 4 + 2 + 2
    calls = train_steps * per_step_calls + (3 * ev + 2 * ev) + 3 * ev + 3 * ev
    pairs = train_steps * per_step_pairs
    want = {k: calls * UNET_CALL_LAUNCHES.get(k, 0) + pairs * v for k, v in PAIR_VJP_LAUNCHES_LORA.items()}
    log(f"{tag} {seconds:.2f} s for the three runs; launches {ran} (want {want}); gen_images {gen_calls}")
    evals_want = {(s, pre) for s in (2, 4) for pre in ("eval_", "eval_ema_")}
    grids_want = {f"eval_{n}_{s}_a_photo_of_the_face_of_a_doctor,_a_person_{kind}.jpg"
                  for s in (2, 4) for n, kind in (("main", "generated"), ("main", "ori"), ("ema", "generated"))}
    failed = [name for name, ok in (
        ("state", all(e <= REMAT_REL_L2_TOL for e, _ in compared.values())),
        ("step", sa.step == sb.step == 4 and sa.updates == sb.updates == 4),
        ("prompt order", order_a == order_b and len(order_a) == 4),
        ("evaluations", evals >= evals_want),
        ("grids", set(grids) == grids_want),
        ("export", {"unet_lora.npz", "unet_lora.pth", "text_encoder_lora.pth", "te_lora_EMA.npz"} <= set(files)
         and same_export),
        ("gen_images", gen_ok),
        ("launches", ran == want),
        ("gen_images launches", gen_calls == {k: 2 * UNET_CALL_LAUNCHES.get(k, 0) for k in gen_calls}),
    ) if not ok]
    if failed:
        raise AssertionError(f"{tag} failed: {failed}")
    return ran


# -- [weights]: the reference's external layouts, written from the port's modules --
#
# Each writer inverts a converter of fairdiff_torch/io on names: the port's
# modules are named after the JAX package's tree paths, and a torch Linear or
# Conv2d weight is already in the external [out, in] / OIHW layout. A CPU test
# (tests/test_torch_weight_layouts.py) holds each writer's key set and shapes
# at full width against diffusers' and transformers' own modules.

_UNET_NAMES = (  # port module path -> diffusers UNet2DConditionModel / AutoencoderKL
    (r"^(down|up)_(\d+)_resnet_(\d+)\.", r"\1_blocks.\2.resnets.\3."),
    (r"^(down|up)_(\d+)_attn_(\d+)\.", r"\1_blocks.\2.attentions.\3."),
    (r"^down_(\d+)_downsample\.(conv\.)?", r"down_blocks.\1.downsamplers.0.conv."),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0."),
    (r"^mid_resnet_(\d+)\.", r"mid_block.resnets.\1."),
    (r"^mid_attn(_0)?\.", "mid_block.attentions.0."),
    (r"\.transformer_blocks_0\.", ".transformer_blocks.0."),
    (r"\.to_out\.", ".to_out.0."),
    (r"\.ff\.proj\.", ".ff.net.0.proj."),
    (r"\.ff\.out\.", ".ff.net.2."),
)
_CLIP_NAMES = (  # port -> transformers CLIPTextModel / CLIPVisionModelWithProjection
    (r"^layers_(\d+)\.", r"encoder.layers.\1."),
    (r"^(token_embedding|position_embedding|patch_embedding|class_embedding)", r"embeddings.\1"),
    (r"^embeddings\.position_embedding$", "embeddings.position_embedding.weight"),
)
_DINO_NAMES = (  # port -> transformers Dinov2Model
    (r"^layers_(\d+)\.", r"encoder.layer.\1."),
    (r"\.attention\.q_proj\.", ".attention.attention.query."),
    (r"\.attention\.k_proj\.", ".attention.attention.key."),
    (r"\.attention\.v_proj\.", ".attention.attention.value."),
    (r"\.attention\.out_proj\.", ".attention.output.dense."),
    (r"\.(layer_scale[12])$", r".\1.lambda1"),
    (r"^patch_embedding\.", "embeddings.patch_embeddings.projection."),
    (r"^(cls_token|position_embeddings)$", r"embeddings.\1"),
    (r"^norm\.", "layernorm."),
)


def _renamed(state: dict, rules, prefix: str = "") -> dict:
    out = {}
    for key, value in state.items():
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        out[prefix + key] = value
    return out


def diffusers_unet(state: dict) -> dict:
    """The port's UNet state dict in diffusers' UNet2DConditionModel layout."""
    return _renamed(state, _UNET_NAMES)


def diffusers_vae(state: dict) -> dict:
    """The port's VAE state dict in diffusers' AutoencoderKL layout (the
    current attention naming, to_q/to_k/to_v/to_out.0)."""
    out = {}
    for half in ("encoder", "decoder"):
        sub = {k.removeprefix(half + "."): v for k, v in state.items() if k.startswith(half + ".")}
        out.update(_renamed(sub, _UNET_NAMES, half + "."))
    out.update({k: v for k, v in state.items() if k.split(".")[0] in ("quant_conv", "post_quant_conv")})
    return out


def hf_clip_text(state: dict) -> dict:
    """The port's CLIP text encoder in transformers' CLIPTextModel layout."""
    return _renamed(state, _CLIP_NAMES, "text_model.")


def hf_clip_vision(state: dict) -> dict:
    """The port's CLIP vision tower in transformers'
    CLIPVisionModelWithProjection layout."""
    out = _renamed({k: v for k, v in state.items() if not k.startswith("visual_projection.")},
                   _CLIP_NAMES, "vision_model.")
    out["visual_projection.weight"] = state["visual_projection.weight"]
    return out


def hf_dinov2(state: dict) -> dict:
    """The port's DINOv2 in transformers' Dinov2Model layout (its position
    table with the leading 1, and the mask token the model does not use,
    as zeros)."""
    out = _renamed(state, _DINO_NAMES)
    out["embeddings.position_embeddings"] = out["embeddings.position_embeddings"][None]
    cls = out["embeddings.cls_token"]
    out["embeddings.mask_token"] = torch.zeros(1, cls.shape[-1], dtype=cls.dtype, device=cls.device)
    return out


_SAFETENSORS_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
                       torch.int64: "I64", torch.int32: "I32"}


def save_safetensors(tensors: dict, path: str | Path, metadata: dict | None = None) -> None:
    """Write `.safetensors` without the safetensors package (the card's
    machine has none): the header length, the JSON header padded with spaces
    to 8 bytes, then each tensor's bytes in order."""
    tensors = {k: v.detach().cpu().contiguous() for k, v in tensors.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())


def write_sd_checkpoint(sd, root: str | Path) -> Path:
    """A diffusers-layout SD directory from a StableDiffusion's weights: the
    UNet as `.safetensors` in its own dtype, the VAE and text encoder as
    torch `.bin` in fp32 (both hold bf16 values exactly)."""
    root = Path(root)
    for sub in ("unet", "vae", "text_encoder"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    save_safetensors(diffusers_unet(sd.unet.state_dict()), root / "unet" / "diffusion_pytorch_model.safetensors",
                     {"format": "pt"})
    fp32 = lambda state: {k: v.float().cpu() for k, v in state.items()}
    torch.save(fp32(diffusers_vae(sd.vae.state_dict())), root / "vae" / "diffusion_pytorch_model.bin")
    torch.save(fp32(hf_clip_text(sd.text_encoder.state_dict())), root / "text_encoder" / "pytorch_model.bin")
    return root


# ONNX protobuf writer (the wire format; tests/test_onnx_bridge.py has the same)

def _vint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _tag(field: int, wire: int) -> bytes:
    return _vint(field << 3 | wire)


def _lfield(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _vint(len(payload)) + payload


def _sfield(field: int, s: str) -> bytes:
    return _lfield(field, s.encode())


def onnx_tensor(name: str, arr) -> bytes:
    import numpy as np

    dt = {np.dtype("float32"): 1, np.dtype("int64"): 7}[arr.dtype]
    out = b"".join(_tag(1, 0) + _vint(d) for d in arr.shape)
    return out + _tag(2, 0) + _vint(dt) + _sfield(8, name) + _lfield(9, arr.tobytes())


def onnx_ints(name: str, vals) -> bytes:
    return _sfield(1, name) + _lfield(8, b"".join(_vint(v & (2**64 - 1)) for v in vals))


def onnx_float(name: str, v: float) -> bytes:
    return _sfield(1, name) + _tag(2, 5) + struct.pack("<f", v)


def onnx_node(op: str, inputs, outputs, *attrs) -> bytes:
    out = b"".join(_sfield(1, i) for i in inputs) + b"".join(_sfield(2, o) for o in outputs)
    return out + _sfield(4, op) + b"".join(_lfield(5, a) for a in attrs)


def onnx_model(nodes, inits: dict, inputs, outputs, opset: int = 11) -> bytes:
    g = b"".join(_lfield(1, n) for n in nodes)
    g += b"".join(_lfield(5, onnx_tensor(n, a)) for n, a in inits.items())
    g += b"".join(_lfield(11, _sfield(1, i)) for i in inputs)
    g += b"".join(_lfield(12, _sfield(1, o)) for o in outputs)
    return _lfield(7, g) + _lfield(8, _sfield(1, "") + _tag(2, 0) + _vint(opset))


def scrfd_onnx(width: int = 16, seed: int = 0, head_scale: float = 0.01) -> bytes:
    """A det_10g-shaped SCRFD graph, any input size divisible by 32: a
    backbone of five 3x3 stride-2 convolutions (BatchNorm, ReLU) to stride
    32; an FPN (1x1 laterals, top-down nearest x2 Resize and Add); at strides
    8, 16 and 32 a 3x3 conv and ReLU, then 1x1 heads for 2 anchors' scores
    (Sigmoid), boxes and landmarks, each transposed and reshaped to [N,
    h*w*2, C] and output as insightface orders them, [scores x3, boxes x3,
    landmarks x3]. Head weights are N(0, head_scale^2) and head biases are
    `EVERY_LANE_DETECTS` (score +4: sigmoid 0.98, above SCRFD's 0.5), so
    every image holds a face."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nodes, inits = [], {}

    def conv(x, out, cin, cout, k, stride=1, relu=True, bn=True):
        w = f"{out}_w"
        inits[w] = (rng.normal(size=(cout, cin, k, k)) * (cin * k * k) ** -0.5).astype(np.float32)
        inits[f"{out}_b"] = np.zeros(cout, np.float32)
        p = k // 2
        y = f"{out}_conv" if (bn or relu) else out
        nodes.append(onnx_node("Conv", [x, w, f"{out}_b"], [y], onnx_ints("kernel_shape", [k, k]),
                               onnx_ints("strides", [stride, stride]), onnx_ints("pads", [p, p, p, p])))
        if bn:
            for name, v in (("s", 1 + 0.1 * rng.normal(size=cout)), ("o", 0.1 * rng.normal(size=cout)),
                            ("m", 0.1 * rng.normal(size=cout)), ("v", rng.uniform(0.5, 1.5, cout))):
                inits[f"{out}_bn{name}"] = v.astype(np.float32)
            z = f"{out}_bn" if relu else out
            nodes.append(onnx_node("BatchNormalization", [y] + [f"{out}_bn{n}" for n in "somv"], [z],
                                   onnx_float("epsilon", 1e-5)))
            y = z
        if relu:
            nodes.append(onnx_node("Relu", [y], [out]))
        return out

    w = width
    x = conv("input.1", "c1", 3, w, 3, 2)
    x = conv(x, "c2", w, w, 3, 2)
    c3 = conv(x, "c3", w, 2 * w, 3, 2)
    c4 = conv(c3, "c4", 2 * w, 4 * w, 3, 2)
    c5 = conv(c4, "c5", 4 * w, 4 * w, 3, 2)
    inits["up_scales"] = np.asarray([1, 1, 2, 2], np.float32)
    p5 = conv(c5, "lat32", 4 * w, w, 1, relu=False, bn=False)
    levels = {32: p5}
    for stride, c, cin in ((16, c4, 4 * w), (8, c3, 2 * w)):
        lat = conv(c, f"lat{stride}", cin, w, 1, relu=False, bn=False)
        nodes.append(onnx_node("Resize", [levels[2 * stride], "", "up_scales"], [f"up{stride}"],
                               _sfield(1, "mode") + _sfield(4, "nearest")))
        nodes.append(onnx_node("Add", [lat, f"up{stride}"], [f"p{stride}"]))
        levels[stride] = f"p{stride}"
    outputs = {"cls": [], "box": [], "kps": []}
    for stride in (8, 16, 32):
        h = conv(levels[stride], f"head{stride}", w, w, 3, bn=False)
        for head, ch in (("cls", 1), ("box", 4), ("kps", 10)):
            wname, raw = f"{head}{stride}_w", f"{head}{stride}_raw"
            inits[wname] = (rng.normal(size=(2 * ch, w, 1, 1)) * head_scale).astype(np.float32)
            inits[f"{head}{stride}_b"] = every_lane_detects_bias(head, 2 * ch)
            nodes.append(onnx_node("Conv", [h, wname, f"{head}{stride}_b"], [raw]))
            nodes.append(onnx_node("Transpose", [raw], [f"{raw}_t"], onnx_ints("perm", [0, 2, 3, 1])))
            inits[f"{head}{stride}_shape"] = np.asarray([0, -1, ch], np.int64)
            name = f"{head}_{stride}"
            if head == "cls":  # det_10g's score heads end in Sigmoid
                nodes.append(onnx_node("Reshape", [f"{raw}_t", f"{head}{stride}_shape"], [f"{raw}_r"]))
                nodes.append(onnx_node("Sigmoid", [f"{raw}_r"], [name]))
            else:
                nodes.append(onnx_node("Reshape", [f"{raw}_t", f"{head}{stride}_shape"], [name]))
            outputs[head].append(name)
    return onnx_model(nodes, inits, ["input.1"], outputs["cls"] + outputs["box"] + outputs["kps"])


# the SCRFD graph in fp32 with TF32 off, card against CPU: summation order only
SCRFD_CPU_REL_L2_TOL = 1e-4


def phase_weights(slice_jpgs: dict[str, str], tokenizer_dir: str = "",
                  tokenizer_jpgs: dict[str, str] | None = None) -> dict[str, int]:
    """Real-weight loading at full width, through the files a user has:
    SD-1.5 from `StableDiffusion(SDConfig.sd15()).init_random(42)` (the
    weights `[slice]` generates with) written in the diffusers layout
    (UNet `.safetensors` in bf16, VAE and text encoder `.bin` in fp32),
    converted by `convert_sd`, loaded bit-equal to the init, and `gen_images
    --model_dir` with `[slice]`'s settings writing byte-equal JPEGs with 10 K1
    and 16 K4 launches a UNet call. Then the guidance zoo: CLIP-ViT-H/14 and
    DINOv2 ViT-B/14 from seeded port modules in the HF layouts, a
    det_10g-shaped SCRFD `.onnx` at 640x640 (`scrfd_onnx`) and
    `seed_guidance_dir`'s classifier, SFNet and detector, converted by
    `convert_guidance`; SCRFD through the bridge on the card against the
    CPU; `load_guidance_stack` with SCRFD composed over FaceDetectorNet; and
    `train_debias --model_dir --guidance_dir` for 2 steps as `[train]`. With
    `tokenizer_dir` (`[tokenizer]`'s CLIP tokenizer), `gen_images --model_dir
    --tokenizer_dir` writes JPEGs byte-equal to `tokenizer_jpgs` (`[tokenizer]`'s
    run on the same seeded weights), and `train_debias` takes the directory too."""
    from fairdiff_torch.io.onnx_bridge import build_onnx_fn, load_scrfd, parse_onnx
    from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
    from fairdiff_torch.tools import convert_guidance, convert_sd, gen_images
    from fairdiff_torch.training.model_zoo import load_guidance_stack
    from fairdiff_torch.utils.resize import resize

    power = smi_name_power()
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    failed = []
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        init = StableDiffusion(SDConfig.sd15()).init_random(42)
        t0 = time.perf_counter()
        write_sd_checkpoint(init, tmp / "sd15")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_sd.main(convert_sd.ConvertConfig(sd_dir=str(tmp / "sd15"), out_dir=str(tmp / "store")))
        t_convert = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = StableDiffusion(SDConfig.sd15()).load_params(tmp / "store")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        unequal = [f"{name}.{k}" for name, m in init.models().items()
                   for k, v in m.state_dict().items() if not torch.equal(v, loaded.models()[name].state_dict()[k])]
        n_tensors = sum(len(m.state_dict()) for m in init.models().values())
        log(f"[weights] SD-1.5 in the diffusers layout written in {t_write:.1f} s; convert_sd {t_convert:.1f} s; "
            f"load onto the card {t_load:.2f} s ({power}); {n_tensors - len(unequal)} of {n_tensors} tensors "
            f"bit-equal to the init")
        if unequal:
            failed.append(f"loaded weights differ from the init: {unequal[:5]}")
        del init, loaded
        torch.cuda.empty_cache()

        prompts = tmp / "prompts.json"
        prompts.write_text(json.dumps({"test_prompts": SLICE_PROMPTS}))
        cfg = gen_images.GenImagesConfig(model_dir=str(tmp / "store"), prompts_json=str(prompts),
                                         num_imgs_per_prompt=2, batch_size=2, save_dir=str(tmp / "gen"))
        reset_counts()
        t0 = time.perf_counter()
        written = gen_images.main(cfg)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        ran = launch_counts()
        calls = 2 * cfg.num_denoising_steps
        want = {k: calls * UNET_CALL_LAUNCHES.get(k, 0) for k in ran}
        jpgs = {str(p.relative_to(cfg.save_dir)): hashlib.sha256(p.read_bytes()).hexdigest() for p in written}
        decoded = [read_jpg(p) for p in written]  # each 512x512 through the port's decoder
        log(f"[weights] gen_images --model_dir: {len(written)} JPEGs ({len(decoded)} decoded) in {t_gen:.2f} s incl. load, byte-equal to "
            f"[slice]'s: {jpgs == slice_jpgs}; launches {ran} (want {want})")
        if jpgs != slice_jpgs or len(jpgs) != 4:
            failed.append("gen_images --model_dir JPEGs differ from [slice]'s")
        if ran != want:
            failed.append(f"gen launches {ran} != {want}")
        if tokenizer_dir:
            tok_cfg = dataclasses.replace(cfg, tokenizer_dir=tokenizer_dir, save_dir=str(tmp / "gen-tok"))
            written = gen_images.main(tok_cfg)
            jpgs = {str(p.relative_to(tok_cfg.save_dir)): hashlib.sha256(p.read_bytes()).hexdigest() for p in written}
            log(f"[weights] gen_images --model_dir --tokenizer_dir: {len(written)} JPEGs byte-equal to "
                f"[tokenizer]'s: {jpgs == tokenizer_jpgs}")
            if jpgs != tokenizer_jpgs or len(jpgs) != 4:
                failed.append("gen_images --model_dir --tokenizer_dir JPEGs differ from [tokenizer]'s")

        g = torch.Generator().manual_seed(11)
        towers = {"clip_vision": CLIPVisionModel(CLIPVisionConfig.vit_h14()), "dinov2": DINOv2Model(DINOv2Config.vitb14())}
        for m in towers.values():
            init_weights(m, g)
        (tmp / "clip").mkdir()
        t0 = time.perf_counter()
        save_safetensors(hf_clip_vision(towers["clip_vision"].state_dict()), tmp / "clip" / "model.safetensors")
        torch.save(hf_dinov2(towers["dinov2"].state_dict()), tmp / "dinov2_vitb14.pth")
        (tmp / "det_10g.onnx").write_bytes(scrfd_onnx())
        guidance = seed_guidance_dir(tmp / "guidance", seed=7)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_guidance.main(convert_guidance.GuidanceConvertConfig(
            out_dir=str(guidance), clip_vision_dir=str(tmp / "clip"), dinov2_pth=str(tmp / "dinov2_vitb14.pth"),
            detector_onnx=str(tmp / "det_10g.onnx")))
        t_convert = time.perf_counter() - t0

        # SCRFD on the card against the CPU, fp32 (TF32 off since [device])
        x = (torch.rand(2, 512, 512, 3, generator=g) * 2 - 1)
        graph = parse_onnx(str(guidance / "det_10g.onnx"))
        fn, params = build_onnx_fn(graph)
        feed = resize(x, (2, 640, 640, 3), "bilinear").flip(-1).mul(127.5 / 128.0).permute(0, 3, 1, 2)
        raw, faces = {}, {}
        for dev in ("cpu", "cuda"):
            with torch.no_grad():
                outs = fn({k: v.to(dev) for k, v in params.items()}, {graph.inputs[0]: feed.to(dev)})
                raw[dev] = torch.cat([outs[n].flatten(1).cpu() for n in graph.outputs], dim=1)
                detect, p = load_scrfd(guidance / "det_10g.onnx", device=dev)
                faces[dev] = detect(p, x.to(dev))
        scrfd_rel = rel_l2(raw["cuda"], raw["cpu"])
        same = bool(torch.equal(faces["cuda"].indicators.cpu(), faces["cpu"].indicators))
        box_err = (faces["cuda"].bboxes.cpu() - faces["cpu"].bboxes).abs().max().item()
        log(f"[weights] CLIP-ViT-H/14, DINOv2 ViT-B/14 (HF layouts), det_10g-shaped SCRFD (640x640) written in "
            f"{t_write:.1f} s; convert_guidance {t_convert:.1f} s; SCRFD fp32 card vs CPU: 9 outputs rel L2 "
            f"{scrfd_rel:.3e} (tol {SCRFD_CPU_REL_L2_TOL:.0e}), faces {faces['cpu'].indicators.tolist()} on both: "
            f"{same}, box max abs diff {box_err:.3e} px")
        if not (scrfd_rel <= SCRFD_CPU_REL_L2_TOL and same and bool(faces["cpu"].indicators.all())
                and box_err <= 1e-2):
            failed.append(f"SCRFD card vs CPU: rel L2 {scrfd_rel:.3e}, faces {same}, boxes {box_err:.3e}")

        t0 = time.perf_counter()
        stack = load_guidance_stack(guidance, ("gender",), device="cuda")
        torch.cuda.synchronize()
        t_stack = time.perf_counter() - t0
        composed = stack.detect_fn.__qualname__.startswith("compose_detectors")
        log(f"[weights] load_guidance_stack in {t_stack:.2f} s: clip {stack.clip_feat_fn is not None}, "
            f"dino {stack.dino_feat_fn is not None}, SCRFD composed over FaceDetectorNet {composed}")
        if not (stack.clip_feat_fn and stack.dino_feat_fn and composed):
            failed.append("the guidance stack lacks CLIP, DINOv2 or the composed detector")
        del stack, towers
        torch.cuda.empty_cache()
        if failed:
            raise AssertionError(f"[weights] failed: {failed}")
        counts = phase_train(model_dir=str(tmp / "store"), guidance_dir=str(guidance), tokenizer_dir=tokenizer_dir)
    if tokenizer_dir:
        log(f"[weights] transformers imported: {'transformers' in sys.modules}")
        if "transformers" in sys.modules:
            raise AssertionError("[weights] transformers was imported")
    return counts


CLIP_VOCAB_SIZE = 49408  # SD-1.5's tokenizer: <|startoftext|> 49406, <|endoftext|> 49407


def write_clip_tokenizer(directory: str | Path, texts: list[str], vocab_size: int | None = CLIP_VOCAB_SIZE) -> Path:
    """A CLIP tokenizer directory in the published format (`vocab.json`,
    `merges.txt` with its version line, `tokenizer_config.json`) whose
    merges are learned from `texts` by byte-level BPE until every word of
    them is one token: the 256 byte symbols and their `</w>` forms first,
    as in CLIP's vocabulary, then each merge's token, then (with
    `vocab_size`) filler entries up to the two special tokens at its end."""
    from fairdiff_torch.io.tokenizer import BOS, EOS, bytes_to_unicode, clean_text, split_words

    byte_map = bytes_to_unicode()
    base = list(byte_map.values())
    vocab = base + [c + "</w>" for c in base]
    counts: dict[tuple[str, ...], int] = {}
    for t in texts:
        for w in split_words(clean_text(t)):
            mapped = "".join(byte_map[b] for b in w.encode("utf-8"))
            key = (*mapped[:-1], mapped[-1] + "</w>")
            counts[key] = counts.get(key, 0) + 1
    merges = []
    while True:
        pairs: dict[tuple[str, str], int] = {}
        for word, n in counts.items():
            for pair in zip(word, word[1:]):
                pairs[pair] = pairs.get(pair, 0) + n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        if best[0] + best[1] not in vocab:  # two merges may spell one token
            vocab.append(best[0] + best[1])
        merged = {}
        for word, n in counts.items():
            out, i = [], 0
            while i < len(word):
                if word[i: i + 2] == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        counts = merged
    if vocab_size is not None:
        vocab += [f"<|fill{i}|>" for i in range(vocab_size - 2 - len(vocab))]
    vocab += [BOS, EOS]
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps({tok: i for i, tok in enumerate(vocab)}), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 77}))
    return d


TOKENIZER_DIR = Path(__file__).resolve().parent / "build" / "clip-tokenizer"


def phase_tokenizer(power: str) -> tuple[str, dict[str, str]]:
    """A CLIP tokenizer directory in the published layout (49408 entries,
    merges learned from the prompts the phases use), then `gen_images
    --tokenizer_dir` with `[slice]`'s settings at full SD-1.5 width on the
    card, without `transformers` -> (the directory, the JPEGs' sha256 by
    path). `[weights]` runs `train_debias --tokenizer_dir` for `[train]`'s 2
    steps (on the converted weights) and checks again that `transformers`
    was never imported."""
    from fairdiff_torch.io.tokenizer import load_tokenizer
    from fairdiff_torch.tools import gen_images, train_debias

    t0 = time.perf_counter()
    d = write_clip_tokenizer(TOKENIZER_DIR, SLICE_PROMPTS + list(train_debias.DEFAULT_PROMPTS))
    tok = load_tokenizer(d)
    ids = tok(SLICE_PROMPTS, padding="max_length").input_ids
    t_tok = time.perf_counter() - t0
    # every word of the prompts is one token of its own: bos, words, eos, pad
    words = [len(p.replace(",", " ,").split()) for p in SLICE_PROMPTS]
    framed = all(r[0] == 49406 and r[n + 1] == 49407 and (r[n + 1:] == 49407).all() for r, n in zip(ids, words))
    log(f"[tokenizer] {tok.vocab_size} entries, {len(tok.ranks)} merges written and read in {t_tok:.2f} s; "
        f"SLICE_PROMPTS -> {[r[:n + 2].tolist() for r, n in zip(ids, words)]}")
    scratch = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prompts = Path(tmp) / "prompts.json"
        prompts.write_text(json.dumps({"test_prompts": SLICE_PROMPTS}))
        cfg = gen_images.GenImagesConfig(tokenizer_dir=str(d), prompts_json=str(prompts), num_imgs_per_prompt=2,
                                         batch_size=2, save_dir=str(Path(tmp) / "out"))
        reset_counts()
        t0 = time.perf_counter()
        written = gen_images.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = launch_counts()
        calls = 2 * cfg.num_denoising_steps
        want = {k: calls * UNET_CALL_LAUNCHES.get(k, 0) for k in ran}
        jpgs = {str(p.relative_to(cfg.save_dir)): hashlib.sha256(p.read_bytes()).hexdigest() for p in written}
        varied = all(read_jpg(p).min() < read_jpg(p).max() for p in written)
        log(f"[tokenizer] gen_images --tokenizer_dir: {len(written)} JPEGs at 512x512, {cfg.num_denoising_steps} "
            f"steps, {seconds:.2f} s incl. setup on {power}; launches {ran} (want {want})")
    imported = "transformers" in sys.modules
    log(f"[tokenizer] transformers imported: {imported}")
    if imported or not (framed and tok.vocab_size == CLIP_VOCAB_SIZE and len(jpgs) == 4 and varied and ran == want):
        raise AssertionError(f"[tokenizer] failed: ids framed {framed}, {len(jpgs)} JPEGs, varied {varied}, "
                             f"launches {ran}, transformers imported {imported}")
    return str(d), jpgs


def _eval_heads(directory: Path) -> dict[str, str]:
    """Three seeded full-width MobileNetV3-Large heads (gender 2, race 4, age
    2 classes) written as the JAX package's `.npz` trees."""
    from fairdiff_torch.io.adapters_io import save_adapters
    from fairdiff_torch.io import from_jax
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
    from fairdiff_torch.tools.eval_images import HEADS

    g = torch.Generator().manual_seed(13)
    paths = {}
    for name, n_cls in HEADS:
        paths[f"{name}_classifier"] = str(directory / f"{name}.npz")
        save_adapters(paths[f"{name}_classifier"], from_jax.jax_tree_from_module(init_weights(MobileNetV3Large(n_cls), g)))
    return paths


EVAL_PROMPTS = ["a photo of the face of a doctor, a person", "a photo of the face of a firefighter, a person"]
EVAL_IMAGES = 30  # a prompt: the protocol's 60 halved, cut with the timed steps
EVAL_FACE_SCENES = 64  # render_face_scene_dr at 128 px, the detector's training size
EVAL_BOX_TOL_PX = 1e-3
EVAL_LOGIT_REL_L2_TOL = 1e-4


def phase_eval(power: str) -> dict:
    """The reference's bias-evaluation protocol at full width: `gen_images`
    with its defaults but `EVAL_IMAGES` a prompt (2 prompts, 512x512, batch 10, 30 steps)
    into one folder, and a folder of `render_face_scene_dr` scenes; both
    scored by `eval_images` at batch 32 with SCRFD (`scrfd_onnx`) composed
    over assets/detector.npz and three seeded heads. Checks the pickles'
    shapes and dtypes, a face in at least half of the face scenes, and the
    card against the CPU on the first batch of 32 of each folder."""
    import io
    import pickle

    import numpy as np

    from fairdiff_torch.guidance.detector_train import render_face_scene_dr
    from fairdiff_torch.io.images import load_image, save_png
    from fairdiff_torch.tools import eval_images, gen_images

    scratch = Path(__file__).resolve().parent / "build"
    failed = []
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        prompts = tmp / "prompts.json"
        prompts.write_text(json.dumps({"test_prompts": EVAL_PROMPTS}))
        gcfg = gen_images.GenImagesConfig(prompts_json=str(prompts), save_dir=str(tmp / "gen"),
                                          num_imgs_per_prompt=EVAL_IMAGES)
        reset_counts()
        t0 = time.perf_counter()
        written = gen_images.main(gcfg)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        ran = launch_counts()
        calls = len(EVAL_PROMPTS) * -(-gcfg.num_imgs_per_prompt // gcfg.batch_size) * gcfg.num_denoising_steps
        want = {k: calls * UNET_CALL_LAUNCHES.get(k, 0) for k in ran}
        log(f"[eval] gen_images (reference defaults, {EVAL_IMAGES} images a prompt): {len(written)} JPEGs at 512x512, batch {gcfg.batch_size}, "
            f"{gcfg.num_denoising_steps} steps in {t_gen:.1f} s incl. setup ({len(written) / t_gen:.3f} img/s) on "
            f"{power}; launches {ran} (want {want})")
        if len(written) != len(EVAL_PROMPTS) * EVAL_IMAGES or ran != want:
            failed.append(f"gen_images wrote {len(written)} JPEGs, launches {ran}")

        rng = np.random.default_rng(21)
        for i in range(EVAL_FACE_SCENES):
            save_png(render_face_scene_dr(rng, 128)[0], tmp / "faces" / "scenes" / f"img_{i}.png")
        zoo = tmp / "zoo"
        zoo.mkdir()
        (zoo / "det_10g.onnx").write_bytes(scrfd_onnx())
        heads = _eval_heads(zoo)
        common = dict(scrfd_onnx=str(zoo / "det_10g.onnx"), detector_params=str(DETECTOR_NPZ), batch_size=32, **heads)

        for folder, n_imgs in (("gen", len(EVAL_PROMPTS) * EVAL_IMAGES), ("faces", EVAL_FACE_SCENES)):
            files = [f for d in sorted((tmp / folder).iterdir()) for f in eval_images.list_images(d)]
            t0 = time.perf_counter()
            imgs = np.stack([load_image(f) for f in files])
            t_decode = time.perf_counter() - t0
            cfg = eval_images.EvalImagesConfig(generated_imgs_dir=str(tmp / folder),
                                               save_dir=str(tmp / f"eval-{folder}"), **common)
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                summary = eval_images.main(cfg)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
            for line in printed.getvalue().splitlines():
                log(line)
            scored = sum(float(m.group(1)) for m in re.finditer(r"scored in ([0-9.]+) s", printed.getvalue()))
            pkls = {}
            for name in summary:
                with open(tmp / f"eval-{folder}" / f"{name}_test_results.pkl", "rb") as f:
                    pkls[name] = pickle.load(f)
            shapes_ok = all(
                p[0].dtype == np.bool_ and p[0].shape == (len(p[0]),) and p[1].dtype == np.int32
                and p[1].shape == (len(p[0]), 4)
                and all(x.dtype == np.float32 and x.shape == (len(p[0]), n) for x, n in zip(p[2:], (2, 4, 2)))
                for p in pkls.values())
            inds = np.concatenate([p[0] for p in pkls.values()])
            log(f"[eval] {folder}: {len(files)} images ({imgs.shape[1]}x{imgs.shape[2]}) decoded in {t_decode:.2f} s; "
                f"eval_images.main {t_main:.2f} s (scoring {scored:.2f} s, {len(files) / scored:.1f} img/s) on "
                f"{power}; faces {int(inds.sum())} of {len(inds)}; pickles {list(pkls)} shapes and dtypes ok "
                f"{shapes_ok}; summary {json.dumps({k: {m: round(v, 4) for m, v in d.items()} for k, d in summary.items()})}")
            if len(inds) != n_imgs or not shapes_ok:
                failed.append(f"{folder}: {len(inds)} indicators, shapes ok {shapes_ok}")
            if folder == "faces" and inds.mean() < 0.5:
                failed.append(f"faces found in {inds.mean():.2f} of the face scenes")
            out[folder] = {"decode_s": t_decode, "score_s": scored, "faces": float(inds.mean())}

            # the card against the CPU on the first batch of 32
            batch = imgs[:32]
            res = {}
            for dev in ("cuda", "cpu"):
                detect, hs = eval_images._load_stack(dataclasses.replace(cfg, device=dev), torch.device(dev))
                with torch.no_grad():
                    det = detect(torch.as_tensor(batch, device=dev))
                    res[dev] = (det.indicators.cpu(), det.bboxes.float().cpu(),
                                eval_images.analyze(detect, hs, batch, cfg.chip_size, torch.device(dev))[2])
            same = bool(torch.equal(res["cuda"][0], res["cpu"][0]))
            box = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
            logit = max(rel_l2(torch.from_numpy(res["cuda"][2][k]), torch.from_numpy(res["cpu"][2][k]))
                        for k in res["cpu"][2])
            log(f"[eval] {folder}: first batch of 32, card vs CPU: indicators equal {same}, boxes max abs diff "
                f"{box:.3e} px (tol {EVAL_BOX_TOL_PX:.0e}), logits worst rel L2 {logit:.3e} "
                f"(tol {EVAL_LOGIT_REL_L2_TOL:.0e})")
            if not (same and box <= EVAL_BOX_TOL_PX and logit <= EVAL_LOGIT_REL_L2_TOL):
                failed.append(f"{folder} card vs CPU: indicators {same}, boxes {box:.3e}, logits {logit:.3e}")
    if failed:
        raise AssertionError(f"[eval] failed: {failed}")
    return out


def phase_train_profile(power: str) -> dict:
    """`train_debias --profile_steps 1` on `[train]`'s configuration: the
    profiled step's Chrome trace, summed by `summarize_trace`, holds as many
    launches of each port kernel as the launch counters counted in that
    step; the device total against the step's wall time."""
    import io

    from fairdiff_torch.tools import train_debias
    from fairdiff_torch.utils.trace_summary import launches_by_bucket, summarize_trace

    scratch = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        cfg = train_debias.TrainCLIConfig(max_train_steps=2, train_images_per_prompt=4, train_micro_batch=2,
                                          steps=4, output_dir=str(Path(tmp) / "out"), profile_steps=1)
        trainer = random_trainer(cfg)
        fit, counts = trainer.fit, []

        def counted_fit(*args, **kw):  # the launch counters of each fit call
            reset_counts()
            state = fit(*args, **kw)
            counts.append(launch_counts())
            return state

        trainer.fit = counted_fit
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_debias.main(cfg, trainer)
        seconds = time.perf_counter() - t0
        lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
        t0 = time.perf_counter()
        summary = summarize_trace(Path(cfg.output_dir) / "trace", top=10**6)
        t_summary = time.perf_counter() - t0
        trace_mb = sum(f.stat().st_size for f in (Path(cfg.output_dir) / "trace").glob("*.gz")) / 2**20
    per_bucket = launches_by_bucket(summary)
    by_name = lambda key: sum(c for name, _, c in summary["top_ops"] if key in name)
    k = counts[0]
    k4, gm, reduce = by_name("k4::fwd_kernel"), by_name("gm::gemm_kernel"), by_name("gm::dx_reduce_kernel")
    # K5's wrapper launches two GEMMs (dproj, dx), and a reduce below a wave
    checks = {
        "flash-fwd": (per_bucket.get("flash-fwd", 0), k["flash_attention"] + k["flash_attention_lse"]),
        "flash-dq": (per_bucket.get("flash-dq", 0), k["flash_attention_dq"]),
        "flash-dkv": (per_bucket.get("flash-dkv", 0), k["flash_attention_dkv"]),
        "geglu": (per_bucket.get("geglu", 0), k["geglu"] + 2 * k["geglu_dx"] + reduce),
        "geglu K4": (k4, k["geglu"]),
        "geglu K5 GEMMs": (gm, 2 * k["geglu_dx"]),
    }
    step = lines[0]
    device_s = summary["total_s"]
    log(f"[train-profile] train_debias --profile_steps 1 ([train]'s configuration): {seconds:.2f} s incl. setup; "
        f"trace {trace_mb:.1f} MiB gzipped, summarized in {t_summary:.1f} s; launch counters of the profiled step "
        f"{k}")
    for name, (got, want) in checks.items():
        log(f"[train-profile]   {name}: {got} device events in the trace, {want} by the counters")
    log(f"[train-profile] profiled step: device total {device_s:.3f} s against {step['step_time_s']:.3f} s wall "
        f"(device idle share {max(0.0, 1 - device_s / step['step_time_s']):.3f}, profiler on); the next step "
        f"unprofiled {lines[1]['step_time_s']:.3f} s wall, on {power}")
    for bucket, sec in list(summary["by_bucket"].items())[:10]:
        log(f"[train-profile]   {sec:8.4f} s {100 * sec / device_s:5.1f}% {per_bucket.get(bucket, 0):7d}x  {bucket}")
    for name, sec, count in summary["top_ops"][:8]:
        log(f"[train-profile]   top {sec:8.4f} s {count:6d}x  {name[:100]}")
    bad = [name for name, (got, want) in checks.items() if got != want]
    if bad or len(counts) != 2 or [x["step"] for x in lines] != [1, 2] or device_s <= 0:
        raise AssertionError(f"[train-profile] failed: {bad}, {len(counts)} fit calls, steps "
                             f"{[x['step'] for x in lines]}, device {device_s}")
    return {"device_s": device_s, "wall_s": step["step_time_s"], "counts": k}


# ----- [facerec]: the face-recognition trainer and evaluation at full width -----

FACEREC_CLASSES = 8631  # VGGFace2's training identities
MS1M_CLASSES = 85742  # MS1M's, for the IResNet-100 head
ARCFACE_112 = ((38.2946, 51.6963), (73.5318, 51.5014), (56.0252, 71.7366), (41.5493, 92.3655), (70.7299, 92.2041))
FACEREC_TRAIN_TOL = 1e-3  # card vs CPU, two steps at batch 16 from the trained weights: loss and every leaf, rel L2
# fp32 gradients at the seeded init carry up to ~4e-3 of error on either device (the ReLU net's features
# start nearly parallel, and the weight gradients cancel across the batch; measured against fp64 on the
# CPU): the card's worst leaf against fp64 may be at most this times the CPU's worst (the leaves' errors
# are random in size, so one leaf's pair says little)
FACEREC_GRAD_RATIO = 1.5
FACEREC_HEAD_TOL = 1e-4  # card vs CPU, every head's loss (rel) and gradients (rel L2), fp32 without TF32
FACEREC_EVAL_TOL = 1e-6  # card vs CPU, every evaluation metric (percentages)
FACEREC_FEAT_TOL = 1e-5  # card vs CPU, the trained weights' flip-sum features, rel L2 (fp32 without TF32)
IRESNET100_EST_GB = 25.0  # a rough estimate of IResNet-100's activations at batch 256 (fp32, ~0.1 GB an image)


def face_identities(n: int, seed: int):
    """Per-identity drawing parameters: skin and background colours, face
    proportions, eye size, mouth colour."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"skin": rng.uniform(90, 230, (n, 3)), "bg": rng.uniform(20, 200, (n, 3)),
            "face_w": rng.uniform(1.05, 1.45, n), "face_h": rng.uniform(1.45, 1.95, n),
            "eye_r": rng.uniform(0.10, 0.20, n), "mouth": rng.uniform(30, 140, (n, 3))}


def draw_faces(rng, ident, params, landmarks, size: int):
    """uint8 [N, size, size, 3] faces drawn in numpy around 5-point
    `landmarks` [N, 5, 2] (eyes, nose, mouth corners): a background
    gradient, an ellipse of skin, dark eyes, a nose and a mouth, with the
    identity's colours and proportions and a little pixel noise."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    yy, xx = yy[None], xx[None]
    p = {k: v[ident].astype(np.float32) for k, v in params.items()}
    lm = landmarks.astype(np.float32)
    eye_d = np.linalg.norm(lm[:, 1] - lm[:, 0], axis=-1)[:, None, None]

    def disc(cx, cy, rx, ry):
        return (((xx - cx[:, None, None]) / rx) ** 2 + ((yy - cy[:, None, None]) / ry) ** 2) <= 1.0

    # one region label a pixel, later regions on top: 0 background, 1 skin, 2 eyes, 3 nose, 4 mouth
    center = lm.mean(axis=1)
    region = disc(center[:, 0], center[:, 1] - 0.2 * eye_d[:, 0, 0], p["face_w"][:, None, None] * eye_d,
                  p["face_h"][:, None, None] * eye_d).astype(np.uint8)
    r = p["eye_r"][:, None, None] * eye_d
    region[disc(lm[:, 0, 0], lm[:, 0, 1], r, r) | disc(lm[:, 1, 0], lm[:, 1, 1], r, r)] = 2
    region[disc(lm[:, 2, 0], lm[:, 2, 1], 0.12 * eye_d, 0.16 * eye_d)] = 3
    mc = 0.5 * (lm[:, 3] + lm[:, 4])
    half = 0.5 * np.linalg.norm(lm[:, 4] - lm[:, 3], axis=-1)[:, None, None]
    region[disc(mc[:, 0], mc[:, 1], half, 0.14 * eye_d)] = 4
    n = len(ident)
    palette = np.stack([p["bg"], p["skin"], np.full((n, 3), 25.0, np.float32), 0.75 * p["skin"], p["mouth"]], 1)
    img = palette[np.arange(n)[:, None, None], region]
    shade = (0.6 + 0.4 * yy / size)[..., None] * (region == 0)[..., None] + (region != 0)[..., None]
    img = img * shade + rng.integers(-4, 5, img.shape, dtype=np.int8)
    return np.clip(img, 0, 255).astype(np.uint8)


def jittered_landmarks(rng, n: int, scale=(1.0, 1.0), angle: float = 0.0, shift: float = 3.0, center: float = 56.0):
    """The ArcFace template under a random similarity (scale range, angle
    range in radians, shift in pixels) about `center`, plus 1-px jitter."""
    import numpy as np

    t = np.asarray(ARCFACE_112, np.float64) - 56.0
    s = rng.uniform(*scale, n)[:, None, None]
    a = rng.uniform(-angle, angle, n)
    rot = np.stack([np.stack([np.cos(a), -np.sin(a)], -1), np.stack([np.sin(a), np.cos(a)], -1)], -2)
    lm = s * np.einsum("nij,kj->nki", rot, t) + center + rng.uniform(-shift, shift, (n, 1, 2))
    return (lm + rng.normal(0.0, 1.0, lm.shape)).astype(np.float32)


def write_images(items, threads: int = 8) -> None:
    """(path, uint8 image) pairs written in the format each suffix names (a
    `.jpg` at quality 95 by the port's encoder, as VGGFace2, MS1M, LFW and
    IJB ship their faces) on a thread pool (the codec releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from fairdiff_torch.io.images import write_image

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda it: write_image(it[1], it[0]), items))


def write_facerec_data(root: Path, seed: int = 0, classes: int = FACEREC_CLASSES, pairs: int = 256,
                       ijb_subjects: int = 64, chunk: int = 512) -> dict:
    """The phase's data, drawn from `seed`: a class-folder tree of 112x112
    faces (one a class) listed by `create_facerec_list`, a verification
    pair list (half mated: two draws of one identity), and an IJB layout of
    144x144 loose crops with their 5-point landmarks (4 images a template,
    2 media a template, a gallery and a probe template a subject, mated and
    non-mated template pairs), plus a small IJB meta set over its first 4
    subjects."""
    import io

    import numpy as np

    from fairdiff_torch.tools.create_facerec_list import CreateListConfig, create_list

    rng = np.random.default_rng(seed)
    ids = face_identities(classes, seed + 1)
    train = root / "train"
    for s in range(0, classes, chunk):
        ident = np.arange(s, min(s + chunk, classes))
        imgs = draw_faces(rng, ident, ids, jittered_landmarks(rng, len(ident)), 112)
        write_images([(train / f"id{k:05d}" / "0.jpg", img) for k, img in zip(ident, imgs)])
    with contextlib.redirect_stdout(io.StringIO()):
        train_ann = create_list(CreateListConfig(dataset_dir=str(train), list_path=str(root / "train_ann.txt")))

    # verification pairs: mated pairs are two draws of one identity
    half = pairs // 2
    ident = np.concatenate([rng.choice(classes, half, replace=False)] * 2
                           + [rng.choice(classes, half), rng.choice(classes, half)])
    ident[3 * half:] = np.where(ident[3 * half:] == ident[2 * half:3 * half], (ident[3 * half:] + 1) % classes,
                                ident[3 * half:])
    imgs = draw_faces(rng, ident, ids, jittered_landmarks(rng, len(ident)), 112)
    names = [f"p{i:04d}.jpg" for i in range(len(ident))]
    write_images([(root / "val" / n, img) for n, img in zip(names, imgs)])
    lines = [f"{names[i]} {names[i + half]} 1" for i in range(half)]
    lines += [f"{names[2 * half + i]} {names[3 * half + i]} 0" for i in range(half)]
    (root / "pairs.txt").write_text("\n".join(lines) + "\n")

    # IJB: subject s has gallery template 2s and probe template 2s+1
    meta = root / "ijb_meta"
    meta.mkdir(parents=True, exist_ok=True)
    n_img = ijb_subjects * 8
    subj = np.repeat(np.arange(ijb_subjects), 8)
    lms = jittered_landmarks(rng, n_img, scale=(0.85, 1.2), angle=0.25, shift=8.0, center=72.0)
    imgs = draw_faces(rng, rng.choice(classes, ijb_subjects, replace=False)[subj], ids, lms, 144)
    write_images([(root / "ijb" / f"{i:05d}.jpg", img) for i, img in enumerate(imgs)])
    data = [f"{i:05d}.jpg " + " ".join(f"{v:.3f}" for v in lms[i].reshape(-1)) + f" {rng.uniform(0.5, 1.0):.3f}"
            for i in range(n_img)]
    tmpl = [i // 4 for i in range(n_img)]
    tid = [f"{i:05d}.jpg {tmpl[i]} {2 * tmpl[i] + (i % 4) // 2}" for i in range(n_img)]

    def write_meta(tag: str, n_subj: int) -> dict:
        n = n_subj * 8
        (meta / f"data{tag}.txt").write_text("\n".join(data[:n]) + "\n")
        (meta / f"tid{tag}.txt").write_text("\n".join(tid[:n]) + "\n")
        (meta / f"gallery{tag}.csv").write_text("TEMPLATE_ID,SUBJECT_ID\n" + "".join(
            f"{2 * s},{s}\n" for s in range(n_subj)))
        (meta / f"probe{tag}.csv").write_text("TEMPLATE_ID,SUBJECT_ID\n" + "".join(
            f"{2 * s + 1},{s}\n" for s in range(n_subj)))
        (meta / f"pairs{tag}.txt").write_text("".join(
            f"{2 * s} {2 * s + 1} 1\n{2 * s} {2 * ((s + 1) % n_subj) + 1} 0\n" for s in range(n_subj)))
        return {"type": "IJBDataset", "name": f"IJB-synthetic{tag}", "data_dir": str(root / "ijb"),
                "meta_dir": str(meta), "data_ann_file": f"data{tag}.txt", "tmpl_ann_file": f"tid{tag}.txt",
                "gallery_ann_files": [f"gallery{tag}.csv"], "probe_ann_files": [f"probe{tag}.csv"],
                "pair_ann_file": f"pairs{tag}.txt", "src_landmark": [list(p) for p in ARCFACE_112]}

    pair_entry = {"type": "PairDataset", "name": "pairs", "data_dir": str(root / "val"),
                  "ann_path": str(root / "pairs.txt")}
    (root / "pairs_small.txt").write_text("\n".join(lines[:8] + lines[half:half + 8]) + "\n")
    return {"train": str(train), "train_ann": str(train_ann), "pair": pair_entry, "ijb": write_meta("", ijb_subjects),
            "pair_small": dict(pair_entry, name="pairs-small", ann_path=str(root / "pairs_small.txt")),
            "ijb_small": write_meta("_small", 4), "n_pair_images": len(names), "n_ijb_images": n_img}


def facerec_recipe(name: str, tree: dict, **over) -> dict:
    """A shipped recipe of the port's copy, read raw, with its `base:` made
    absolute (so base.yml's trainer block, `lr_decay_gamma` included, stays
    on the path) and its data pointed at the phase's tree; `over` replaces
    top-level blocks (deep-merged)."""
    import yaml

    from fairdiff_torch.facerec.builder import CONFIG_DIR, deep_merge

    recipe = yaml.safe_load((CONFIG_DIR / name).read_text())
    recipe["base"] = str(CONFIG_DIR / recipe["base"])
    train = {"dataset": {"type": "ClassDataset", "data_dir": tree["train"], "ann_path": tree["train_ann"]}}
    recipe["data"] = deep_merge(recipe.get("data", {}), {"train": train, "val": {"dataset": {
        k: v for k, v in tree["pair"].items() if k != "name"}}})
    return deep_merge(recipe, over)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device: torch.device) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")


def train_flop_per_image(backbone, in_size: int) -> float:
    """Convolution and linear operations of one training image through
    `backbone` (2 per multiply-add), counted on the meta device from the
    shapes: the forward's, times 3 for the backward's two products."""
    count = [0.0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.Conv2d):
            kh, kw = m.kernel_size
            count[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * kh * kw
        else:
            count[0] += 2.0 * out.numel() * m.in_features

    net = copy.deepcopy(backbone).to("meta")
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    net(torch.empty(1, in_size, in_size, 3, device="meta"))
    for h in handles:
        h.remove()
    return 3.0 * count[0]


def _facerec_grads(trainer, tree, images, labels, dtype) -> dict:
    """The gradient of the trainer's loss (weight decay included) in every
    trained leaf at the parameters `tree`, computed in `dtype` on the
    trainer's device -> name -> fp64 CPU tensor."""
    st = trainer.init_state(params=tree)
    params = {"backbone": {k: v.detach().to(dtype).requires_grad_() for k, v in st["params"]["backbone"].items()},
              "head_w": st["params"]["head_w"].detach().to(dtype).requires_grad_()}
    x = torch.as_tensor(images, device=trainer.device, dtype=dtype)
    total, _ = trainer.loss(params, x, torch.as_tensor(labels, device=trainer.device))
    names = [f"backbone/{k}" for k in params["backbone"]] + ["head_w"]
    grads = torch.autograd.grad(total, [*params["backbone"].values(), params["head_w"]])
    return {n: g.detach().double().cpu() for n, g in zip(names, grads)}


def _params_tree(trainer, state) -> dict:
    """A trainer state's parameters as the JAX package's tree (numpy)."""
    tree = {"backbone": trainer.backbone_tree(state),
            "head_w": state["params"]["head_w"].detach().cpu().numpy()}
    if "head_b" in state["params"]:
        tree["head_b"] = state["params"]["head_b"].detach().cpu().numpy()
    return tree


def phase_facerec(power: str, classes: int = FACEREC_CLASSES, steps: int = 20, batch: int = 512,
                  batch_100: int = 256, ms1m_classes: int = MS1M_CLASSES, pairs: int = 256,
                  ijb_subjects: int = 64) -> dict:
    """The face-recognition path of the port at full width: `train_facerec`
    on vggface2_sfnet20_sphereface.yml (through base.yml; sfnet20_deprecated,
    512-d, 112 px, SphereFace s=30 m=1.5, batch 512, head [512, 8631]) for
    `steps` steps (10 in the script) with validation and a checkpoint halfway; two steps at batch
    16 on the card and the CPU from one init; IResNet-100
    (ms1m_iresnet100_sphereface.yml) for 3 steps at batch 256 with an MS1M
    head [512, 85742]; all 11 heads (SphereFace2 in C, A and M) at x [512,
    512], w [512, 8631] on the card and the CPU; `eval_facerec` with the
    trained weights on 256 pairs and a 512-image synthetic IJB set, and at a
    small size on the card and the CPU. The keyword arguments cut the sizes
    for a rehearsal; the defaults are the run's."""
    import io

    import numpy as np
    import yaml

    from fairdiff_torch.device import resolve_device
    from fairdiff_torch.facerec.builder import build_backbone
    from fairdiff_torch.facerec.datasets import ClassDataset, PairDataset, image_pipeline
    from fairdiff_torch.facerec.trainer import FaceRecTrainer
    from fairdiff_torch.fairness import margin_heads
    from fairdiff_torch.guidance.face_feats import face_embeddings
    from fairdiff_torch.io.adapters_io import load_adapters
    from fairdiff_torch.io.from_jax import load_jax_params
    from fairdiff_torch.tools import eval_facerec, train_facerec

    failed = []
    card = resolve_device("")
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    out: dict = {}
    half = steps // 2
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = write_facerec_data(root / "data", classes=classes, pairs=pairs, ijb_subjects=ijb_subjects)
        log(f"[facerec] data: {classes} class folders of one 112x112 face (JPEG, quality 95, the port's encoder), "
            f"{data['n_pair_images']} pair images, {data['n_ijb_images']} IJB loose crops, written in "
            f"{time.perf_counter() - t0:.1f} s")

        # 1. train_facerec at full width
        cfg_path = root / "sfnet20.yml"
        cfg_path.write_text(yaml.safe_dump(facerec_recipe(
            "vggface2_sfnet20_sphereface.yml", data, trainer={"max_iters": steps, "val_interval": half},
            data={"train": {"batch_size": batch}})))
        cli = train_facerec.FaceRecCLIConfig(config=str(cfg_path), output_dir=str(root / "run"), log_every=1,
                                             save_every=half)
        trainer, train_ds, _, batch_read, _ = train_facerec.build_all(cli)
        tcfg = trainer.cfg
        _reset_peak(card)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = train_facerec.main(cli)
        wall = time.perf_counter() - t0
        peak = _peak_gib(card)
        recs = [json.loads(line) for line in (root / "run" / "metrics.jsonl").read_text().splitlines()]
        recs_steps = [r for r in recs if "loss" in r]
        val = [r for r in recs if "EER" in r]
        loss = np.asarray([r["loss"] for r in recs_steps])
        timed = [r for r in recs_steps if r["step"] >= 3]
        step_s = float(np.median([r["step_s"] for r in timed]))
        dev_s = float(np.median([r["step_s"] - r["data_s"] for r in timed]))
        data_s = float(np.median([r["data_s"] for r in timed]))
        t0 = time.perf_counter()
        stream = ClassDataset(data["train"], data["train_ann"]).batches(batch, seed=1, image_size=112)
        for _ in range(4):
            next(stream)
        loader = 4 * batch / (time.perf_counter() - t0)
        head_shape = tuple(state["params"]["head_w"].shape)
        log(f"[facerec] train_facerec vggface2_sfnet20_sphereface.yml: {trainer.backbone.__class__.__name__} "
            f"sfnet20_deprecated 512-d 112 px, {tcfg.head} {dict(tcfg.head_kwargs)}, batch {batch}, head "
            f"{list(head_shape)}, lr {tcfg.lr} (x{tcfg.lr_decay_rate} at {list(tcfg.lr_decay_steps)}: base.yml's "
            f"lr_decay_gamma), fp32 without TF32, {state['step']} steps in {wall:.1f} s incl. setup, validation and "
            f"checkpoints, on {power}")
        flop = train_flop_per_image(trainer.backbone, 112) * batch_read
        log(f"[facerec]   s/step (median of steps 3-{steps}, host clock, synchronised): {step_s:.4f} with the loader "
            f"inside, {dev_s:.4f} without it (loader {data_s:.4f} s a batch in the step, "
            f"{data_s / step_s:.1%} of the step); loader alone {loader:.1f} img/s ({batch_read / loader:.4f} s a batch "
            f"of {batch_read}); backbone {flop / 1e12:.2f} TFLOP a step (3x the forward's convolutions and linears), "
            f"{flop / dev_s / 1e12:.1f} TFLOP/s without the loader, {flop / dev_s / PEAK_FP32_FLOPS:.1%} of the fp32 "
            f"peak; peak {peak:.2f} GiB")
        log(f"[facerec]   loss: first 5 steps {loss[:5].mean():.4f}, last 5 {loss[-5:].mean():.4f}")
        for v in val:
            log(f"[facerec]   validation ({pairs} pairs) at step {v['step']}: "
                + "  ".join(f"{k}={x:.4f}" for k, x in v.items() if k not in ("step", "time")))
        saved = {n: (root / "run" / n).exists() for n in (f"backbone_{half}.npz", f"backbone_{steps}.npz",
                                                           "backbone_final.npz")}
        tree = load_adapters(root / "run" / "backbone_final.npz")
        if not (state["step"] == steps and len(recs_steps) == steps and np.isfinite(loss).all()
                and head_shape == (512, classes) and [v["step"] for v in val] == [half, steps] and all(saved.values())
                and tcfg.lr_decay_rate == 0.1 and batch_read == batch and set(tree) >= {"layer1_0", "fc"}):
            failed.append(f"train_facerec: steps {state['step']}, finite {np.isfinite(loss).all()}, head "
                          f"{head_shape}, val {val}, saved {saved}")
        out.update(step_s=step_s, device_step_s=dev_s, loader_img_s=loader, peak_gib=peak,
                   loss_first=float(loss[:5].mean()), loss_last=float(loss[-5:].mean()), val=val)

        # 2. card vs CPU: two steps at batch 16 from the trained weights, on the same batches; and the
        # first step's gradients at the seeded init, each device's fp32 against fp64 on the CPU
        stream = train_ds.batches(16, seed=2, image_size=112)
        batches = [next(stream) for _ in range(2)]
        backbone_block = facerec_recipe("vggface2_sfnet20_sphereface.yml", data)["model"]["backbone"]
        on_card = FaceRecTrainer(build_backbone(backbone_block), tcfg, device=card)
        on_cpu = FaceRecTrainer(build_backbone(backbone_block), tcfg, device="cpu")
        trained = _params_tree(trainer, state)
        runs = {}
        for dev, tr in (("card", on_card), ("cpu", on_cpu)):
            st, losses = tr.init_state(params=trained), []
            for images, labels in batches:
                st, l_ = tr.train_step(st, images, labels)
                losses.append(l_)
            runs[dev] = (losses, _params_tree(tr, st))
        (lc, pc), (lh, ph) = runs["card"], runs["cpu"]
        errs = {"/".join(k): float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
                for (k, a), (_, b) in zip(sorted(_npz_leaves(pc)), sorted(_npz_leaves(ph)))}
        worst_loss = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        worst = sorted(errs, key=errs.get, reverse=True)[:3]
        log(f"[facerec] card vs CPU, 2 steps at batch 16 from the {steps}-step weights: losses "
            f"{[round(v, 6) for v in lc]} / {[round(v, 6) for v in lh]} (worst rel {worst_loss:.3e}); every trained "
            f"leaf rel L2 <= {errs[worst[0]]:.3e} over {len(errs)} leaves (tol {FACEREC_TRAIN_TOL}; worst "
            + ", ".join(f"{k} {errs[k]:.2e}" for k in worst) + ")")
        if not (worst_loss <= FACEREC_TRAIN_TOL and errs[worst[0]] <= FACEREC_TRAIN_TOL):
            failed.append(f"card vs CPU train steps: loss {worst_loss}, leaves {[(k, errs[k]) for k in worst]}")
        seeded = _params_tree(on_card, on_card.init_state(torch.Generator().manual_seed(5)))
        images, labels = batches[0]
        g_card = _facerec_grads(on_card, seeded, images, labels, torch.float32)
        g_cpu = _facerec_grads(on_cpu, seeded, images, labels, torch.float32)
        g_f64 = _facerec_grads(on_cpu, seeded, images, labels, torch.float64)
        acc = {k: (rel_l2(g_card[k], g_f64[k]), rel_l2(g_cpu[k], g_f64[k])) for k in g_f64}
        card_worst, cpu_worst = max(a for a, _ in acc.values()), max(b for _, b in acc.values())
        log(f"[facerec] first-step gradients at the seeded init vs fp64 on the CPU, worst of {len(acc)} leaves: "
            f"card fp32 {card_worst:.2e} ({max(acc, key=lambda k: acc[k][0])}), CPU fp32 {cpu_worst:.2e} "
            f"({max(acc, key=lambda k: acc[k][1])}; fp32's own limit here), ratio {card_worst / cpu_worst:.3f} "
            f"(tol {FACEREC_GRAD_RATIO})")
        if not card_worst <= FACEREC_GRAD_RATIO * cpu_worst:
            failed.append(f"card gradient accuracy: {card_worst} vs the CPU's {cpu_worst}")
        del on_card, on_cpu, runs
        mesh_facerec(power, root, cfg_path, trained)

        # 3. IResNet-100 at batch 256 with an MS1M-sized head
        ann100 = root / "ms1m_ann.txt"
        lines = Path(data["train_ann"]).read_text().splitlines()
        ann100.write_text("".join(f"{ln.split()[0]} {round(int(ln.split()[1]) * (ms1m_classes - 1) / (len(lines) - 1))}\n"
                                  for ln in lines))
        cfg100 = root / "iresnet100.yml"
        recipe = facerec_recipe("ms1m_iresnet100_sphereface.yml", data, trainer={"max_iters": 3})
        recipe["data"]["train"] = {"dataset": {"type": "ClassDataset", "data_dir": data["train"],
                                               "ann_path": str(ann100)}, "batch_size": batch_100}
        cfg100.write_text(yaml.safe_dump(recipe))
        tr100, ds100, _, b100, _ = train_facerec.build_all(train_facerec.FaceRecCLIConfig(config=str(cfg100),
                                                                                         device=str(card)))
        st = tr100.init_state(torch.Generator().manual_seed(0))
        n_params = sum(v.numel() for v in st["params"]["backbone"].values())
        _reset_peak(card)
        logs100 = []
        st = tr100.fit(st, ds100.batches(b100, seed=0, image_size=112), log_every=1,
                       logger=lambda s, l: logs100.append(l))
        peak100 = _peak_gib(card)
        s100 = [l["step_s"] for l in logs100]
        d100 = [l["step_s"] - l["data_s"] for l in logs100]
        flop100 = train_flop_per_image(tr100.backbone, 112) * b100
        log(f"[facerec] IResNet-100 (ms1m_iresnet100_sphereface.yml, {n_params / 1e6:.1f} M backbone leaves), batch "
            f"{b100}, head {list(st['params']['head_w'].shape)}: s/step {[round(v, 4) for v in s100]} "
            f"(without the loader {[round(v, 4) for v in d100]}), loss {[round(l['loss'], 4) for l in logs100]}; "
            f"{flop100 / 1e12:.2f} TFLOP a step, {flop100 / min(d100) / 1e12:.1f} TFLOP/s at the fastest step without "
            f"the loader; peak {peak100:.2f} GiB (estimate ~{IRESNET100_EST_GB:.0f} GB of activations) on {power}")
        if not (st["step"] == 3 and b100 == batch_100 and all(np.isfinite(l["loss"]) for l in logs100)
                and tuple(st["params"]["head_w"].shape) == (512, ms1m_classes)):
            failed.append(f"IResNet-100: steps {st['step']}, losses {[l['loss'] for l in logs100]}")
        out.update(iresnet100_step_s=s100, iresnet100_peak_gib=peak100)
        del tr100, st

        # 4. every head on the card against the CPU
        g = torch.Generator().manual_seed(11)
        x = torch.randn(512, 512, generator=g) * 3
        w = torch.randn(512, classes, generator=g)
        y = torch.randint(0, classes, (512,), generator=g)
        y[256:] = y[:256]  # repeated classes in the batch (SphereFace+'s pair mask)
        cases = [(n, {}) for n in margin_heads.HEADS if n != "sphereface2"]
        cases += [("sphereface2", {"magn_type": m}) for m in ("C", "A", "M")]
        worst_head = 0.0
        t0 = time.perf_counter()
        for name, kw in cases:
            res = {}
            for dev in (card, "cpu"):
                xs, ws = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
                args = [ws, xs, y.to(dev)]
                if name == "sphereface2":
                    bs = torch.tensor(margin_heads.sphereface2_bias_init(classes, **kw), device=dev,
                                      requires_grad=True)
                    args = [ws, bs, xs, y.to(dev)]
                loss_ = margin_heads.HEADS[name](*args, **kw)
                grads = torch.autograd.grad(loss_, [a for a in args if a.requires_grad])
                res[dev] = (loss_.item(), [gr.cpu() for gr in grads])
            (lc_, gc_), (lh_, gh_) = res[card], res["cpu"]
            errs = [abs(lc_ - lh_) / max(abs(lh_), 1e-30)] + [rel_l2(a, b) for a, b in zip(gc_, gh_)]
            worst_head = max(worst_head, *errs)
            log(f"[facerec]   head {name}{'-' + kw['magn_type'] if kw else ''}: loss {lc_:.6f} (CPU {lh_:.6f}); "
                f"loss rel {errs[0]:.2e}, grads rel L2 {' '.join(f'{e:.2e}' for e in errs[1:])}")
            if not (np.isfinite(lc_) and max(errs) <= FACEREC_HEAD_TOL):
                failed.append(f"head {name} {kw}: {errs}")
        log(f"[facerec] {len(cases)} heads at x [512, 512], w [512, {classes}] on the card vs the CPU: worst "
            f"{worst_head:.2e} (tol {FACEREC_HEAD_TOL}), {time.perf_counter() - t0:.1f} s")

        # 5. eval_facerec with the trained weights
        weights = str(root / "run" / "backbone_final.npz")
        ecfg = root / "eval.yml"
        ecfg.write_text(yaml.safe_dump({"data": {"val": [{"dataset": data["pair"]}, {"dataset": data["ijb"]}]},
                                        "model": {"backbone": backbone_block}}))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            results = eval_facerec.main(eval_facerec.EvalFaceRecCLIConfig(device=str(card), config=str(ecfg),
                                                                          weights=weights))
        t_eval = time.perf_counter() - t0
        n_eval = data["n_pair_images"] + data["n_ijb_images"]
        for line in buf.getvalue().splitlines():
            log(f"[facerec]   {line}")
        log(f"[facerec] eval_facerec: {n_eval} images ({data['n_pair_images']} pair images, "
            f"{data['n_ijb_images']} IJB crops aligned on the host) in {t_eval:.1f} s, {n_eval / t_eval:.1f} img/s "
            f"incl. decode, alignment and flip-sum features, on {power}")
        ok_eval = list(results) == ["pairs", "IJB-synthetic"] and all(
            np.isfinite(v) for m in results.values() for _, v in m)
        scfg = root / "eval_small.yml"
        scfg.write_text(yaml.safe_dump({"data": {"val": [{"dataset": data["pair_small"]},
                                                         {"dataset": data["ijb_small"]}]},
                                        "model": {"backbone": backbone_block}}))
        # The metrics are step functions of the scores' order, and the 20-step weights crowd the scores (a
        # TPR@FPR over 4 non-mated pairs moved 25 points between card and CPU in one run): the metrics are
        # compared on the seeded backbone (eval_facerec without --weights), whose scores spread, and the
        # trained weights by their features on the same images.
        small = {}
        for dev in (str(card), "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                small[dev] = eval_facerec.main(eval_facerec.EvalFaceRecCLIConfig(device=dev, config=str(scfg), seed=3))
        on, off = small[str(card)], small["cpu"]
        worst_eval = max(abs(a - b) for name in on for (_, a), (_, b) in zip(on[name], off[name]))
        same_keys = all([k for k, _ in on[n]] == [k for k, _ in off[n]] for n in on)
        small_pairs = PairDataset(**{k: v for k, v in data["pair_small"].items() if k not in ("type", "name")})
        imgs = np.stack([image_pipeline({"path": q}, True)
                         for q in sorted({q for pair in small_pairs.pairs for q in pair[:2]})])
        feats = {}
        for dev in (card, torch.device("cpu")):
            net = load_jax_params(build_backbone(backbone_block), load_adapters(weights)).to(dev).eval()
            with torch.no_grad():
                feats[dev.type] = face_embeddings(net, torch.as_tensor(imgs, device=dev)).cpu()
        feat_err = rel_l2(feats[card.type], feats["cpu"])
        log(f"[facerec] eval_facerec small (16 pairs, 32 IJB crops, seeded backbone) card vs CPU: worst metric "
            f"difference {worst_eval:.2e} (tol {FACEREC_EVAL_TOL}); the trained weights' flip-sum features of its "
            f"{len(imgs)} pair images card vs CPU rel L2 {feat_err:.2e} (tol {FACEREC_FEAT_TOL}); card "
            + "; ".join(f"{n}: " + " ".join(f"{k}={v:.4f}" for k, v in m) for n, m in on.items()))
        if not (ok_eval and same_keys and worst_eval <= FACEREC_EVAL_TOL and feat_err <= FACEREC_FEAT_TOL):
            failed.append(f"eval_facerec: ok {ok_eval}, keys {same_keys}, card vs CPU {worst_eval}, features {feat_err}")
        out.update(eval_img_s=n_eval / t_eval, results=results)
    if failed:
        raise AssertionError(f"[facerec] failed: {failed}")
    return out


# the shipped detector's recall on 256 scenes a shift and its fp rates
# (docs/DETECTOR.md, r5, measured with the JAX package on a TPU)
DETECTOR_MD_R5 = {"train_dist": 1.000, "blur": 0.992, "offcenter": 0.996, "scale_large": 1.000,
                  "textured_bg": 0.992, "multiface": 0.961, "occlusion": 0.961, "skin_tone": 0.996,
                  "low_contrast": 1.000, "scale_small": 0.914}
DETECTOR_MD_R5_FP = {"base": 0.016, "blur": 0.070, "low_contrast": 0.055, "textured_bg": 0.039}


def phase_detector(power: str) -> dict:
    """`train_detector` on the card at the shipped recipe's shapes
    (`DetectorConfig()`, batch 16, 128 px, dr scenes) for 100 steps, mining
    from step 40; then `eval_detector` on assets/detector.npz, 256 scenes a
    shift, seed 777, on the card, and at 32 scenes on the card and on the
    CPU (each rate within 1/32)."""
    import io

    import numpy as np

    from fairdiff_torch.tools import eval_detector, train_detector

    scratch = Path(__file__).resolve().parent / "build"
    failed = []
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        cfg = train_detector.DetTrainConfig(steps=100, out=str(Path(tmp) / "detector.npz"), log_every=20,
                                            eval_scenes=64)
        t0 = time.perf_counter()
        _, metrics, hist = train_detector.main(cfg)
        seconds = time.perf_counter() - t0
        saved = Path(cfg.out).exists()
    m0 = hist["mine_start"]
    plain_s = float(np.mean(hist["step_s"][1:m0]))
    mined_s = float(np.mean(hist["step_s"][m0:]))
    loss = np.asarray(hist["loss"])
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"[detector] train_detector: DetectorConfig(), batch {cfg.batch_size}, {cfg.image_size} px, {cfg.scenes} "
        f"scenes, {cfg.steps} steps, mining from step {m0}: {seconds:.1f} s incl. the held-out eval; s/step "
        f"{plain_s:.4f} without mining, {mined_s:.4f} with (the scenes rendered on the host included) on {power}; "
        f"loss {first:.4f} over the first 10 steps -> {last:.4f} over the last 10; held-out "
        f"{json.dumps({k: round(v, 4) for k, v in metrics.items()})}")
    if not (saved and np.isfinite(loss).all() and last < first and m0 == 40):
        failed.append(f"train_detector: saved {saved}, finite {np.isfinite(loss).all()}, loss {first} -> {last}")

    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        full = eval_detector.main(eval_detector.DetEvalConfig(n_scenes=256))
        t_full = time.perf_counter() - t0
        small = {dev: eval_detector.main(eval_detector.DetEvalConfig(device=dev, n_scenes=32)) for dev in ("", "cpu")}
    log(f"[detector] eval_detector assets/detector.npz, 256 scenes a shift, seed 777, on the card: {t_full:.1f} s "
        f"on {power}")
    log("[detector]   shift          recall  (DETECTOR.md r5)  det_rate  mean_iou  lm_err  | 32 scenes card / CPU")
    worst = 0.0
    for shift, m in full.items():
        if shift == "fp_rates":
            continue
        card, cpu = small[""][shift], small["cpu"][shift]
        worst = max(worst, abs(card["recall"] - cpu["recall"]), abs(card["det_rate"] - cpu["det_rate"]))
        log(f"[detector]   {shift:<14} {m['recall']:.4f}  ({DETECTOR_MD_R5.get(shift, float('nan')):.3f})"
            f"           {m['det_rate']:.4f}    {m['mean_iou']:.4f}    {m['lm_err_112px']:.3f}   | "
            f"{card['recall']:.4f} / {cpu['recall']:.4f}")
    for fam, rate in full["fp_rates"].items():
        card, cpu = small[""]["fp_rates"][fam], small["cpu"]["fp_rates"][fam]
        worst = max(worst, abs(card - cpu))
        log(f"[detector]   fp {fam:<12} {rate:.4f}  ({DETECTOR_MD_R5_FP[fam]:.3f})  | {card:.4f} / {cpu:.4f}")
    log(f"[detector] 32 scenes a shift, card vs CPU: worst rate difference {worst:.4f} (tol {1 / 32:.4f})")
    if worst > 1 / 32 + 1e-9:
        failed.append(f"eval_detector card vs CPU differ by {worst}")
    if failed:
        raise AssertionError(f"[detector] failed: {failed}")
    return {"plain_s": plain_s, "mined_s": mined_s, "full": full}


def _npz_leaves_list(tree) -> list:
    return [a for _, a in sorted(_npz_leaves(tree))]


# -- the mesh, tensor parallelism and the last tools -------------------------

# two ranks on the one card over gloo against one process (NCCL refuses two
# ranks on one device), rel L2 over the gradients or outputs together. In
# bf16 the step's adapter gradients move by 1.75e-2 when one process merely
# re-chunks its lanes (micro-batch 4 for 2; NVIDIA H100 80GB HBM3, 700 W;
# the split step reads 1.803e-2), so a data-split step's distance from the
# one-process step is held to MESH_REBATCH_RATIO times the re-chunked
# step's; three faults of the split must break that limit (each rank left
# with its own gradients, the sum halved, the sum doubled), and the
# all-reduced gradients must be the sum of the ranks' own (MESH_SUM_TOL). The
# model-split pair VJP's error against fp32 is held to
# MESH_ACCURACY_RATIO times the replicated one's. Forwards as the bf16 UNet
# parity phase: within UNET_BF16_REL_L2_TOL of the replicated model and at
# most UNET_BF16_ACCURACY_RATIO times its error against fp32.
MESH_ACCURACY_RATIO = 1.25
MESH_REBATCH_RATIO = 1.5
MESH_SUM_TOL = 1e-6  # all-reduced vs the sum of the ranks' own gradients, rel L2 (fp32 rounding)
MESH_FACEREC_TOL = 1e-3  # train_facerec --data_mesh 2 vs one process at batch 512, every leaf (fp32)
MESH_TIMEOUT = 600  # seconds a two-rank launch may take before its ranks are killed
# the [mesh] step: exp-1, 4 lanes in chunks of 2, 4 denoising steps
MESH_STEP = dict(max_train_steps=1, train_images_per_prompt=4, train_micro_batch=2, steps=4)


def _rank_setup() -> None:
    """What `phase_device` sets, in a spawned rank: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _save_sd(sd, path: Path) -> None:
    torch.save({name: m.state_dict() for name, m in sd.models().items()}, path)


def _load_sd(weights: str, dtype: str = "bfloat16"):
    """SD-1.5 (remat, as the trainer runs it) on the card from `_save_sd`'s
    file, in `dtype`."""
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    sd = StableDiffusion(dataclasses.replace(SDConfig.sd15(), dtype=dtype), remat=True)
    state = torch.load(weights, mmap=True, weights_only=True)
    for name, m in sd.models().items():
        m.load_state_dict(state[name])
    return sd


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_launches(steps: int, lanes: int, p: int, per_pair: dict) -> dict[str, int]:
    """Launches of one train step: two no-grad CFG UNet calls a denoising
    step (phases 1 and 3) and a pair VJP a step and lane chunk."""
    return {k: 2 * steps * UNET_CALL_LAUNCHES.get(k, 0) + steps * (lanes // p) * v for k, v in per_pair.items()}


@contextlib.contextmanager
def lane_shares(trainer, spans, chunks=(None,)):
    """While open, each train_step of `trainer` runs its phase-4 pair VJPs
    on each span of lanes alone (`spans` cover the lanes, each a whole
    number of chunks), on the step's own trajectories and cotangents: the
    share of the step's gradient those lanes carry, the other lanes' chunks
    left out (what a data rank holding those lanes sums before the
    all-reduce). The step takes the sum of the shares in its own chunk size
    (None); each size in `chunks` is run too. Yields {(span index, chunk):
    flat fp32 gradients on the CPU}."""
    from fairdiff_torch.utils.tree import tree_leaves, tree_unflatten

    shares, real = {}, trainer._pair_grads

    def split(adapters, traj, cot, ts, cond_ids, uncond_ids, p):
        total = None
        for i, span in enumerate(spans):
            for q in chunks:
                g = real(adapters, traj[:, span], cot[:, span], ts, cond_ids, uncond_ids, q or p)
                shares[(i, q)] = torch.cat([x.detach().float().flatten().cpu() for x in tree_leaves(g)])
                if q is None:
                    total = g if total is None else tree_unflatten(
                        total, [a + b for a, b in zip(tree_leaves(total), tree_leaves(g))])
        return total

    trainer._pair_grads = split
    try:
        yield shares
    finally:
        del trainer._pair_grads


def rel_l2_or_zero(got: torch.Tensor, ref: torch.Tensor) -> float:
    """rel_l2, with a zero reference read as 0 when `got` is zero too."""
    if not ref.norm():
        return 0.0 if not got.norm() else float("inf")
    return rel_l2(got, ref)


def mesh_debias_rank(weights: str, fields: dict, noises, n_steps: int, ids) -> dict:
    """[mesh] rank: the exp-1 step of `fields` on a data mesh of the whole
    world, on this rank's lanes of the global noise bank."""
    import torch.distributed as dist

    from fairdiff_torch.parallel.mesh import MeshConfig, create_mesh
    from fairdiff_torch.training.debias import DebiasConfig, DebiasTrainer
    from fairdiff_torch.training.synthetic import synthetic_stack
    from fairdiff_torch.utils.tree import tree_leaves

    _rank_setup()
    sd = _load_sd(weights)
    dcfg = DebiasConfig(**fields)
    mesh = create_mesh(MeshConfig(data=dist.get_world_size()), device=sd.device, backend="gloo")
    trainer = DebiasTrainer(sd, synthetic_stack(dcfg.attributes, device=sd.device), dcfg, mesh=mesh)
    state = trainer.init_state(dcfg.seed)
    local, reduce = {}, trainer._reduce_grads

    def keep_local(grads):  # this rank's gradients before the all-reduce
        local["grads"] = [g.detach().float().clone() for g in tree_leaves(grads)]
        return reduce(grads)

    trainer._reduce_grads = keep_local
    reset_counts()
    t0 = time.perf_counter()
    state, logs = trainer.train_step(state, ids, noises=noises, n_steps=n_steps)
    torch.cuda.synchronize()
    return {"grads": [g.float() for g in tree_leaves(trainer._last_grads)], "local": local["grads"], "logs": logs,
            "launches": launch_counts(), "seconds": time.perf_counter() - t0}


def phase_mesh(power: str, work: Path):
    """[mesh]: the data mesh at full SD-1.5 width (exp-1, 4 lanes, 4
    denoising steps): a 1x1 mesh on NCCL at world size 1 against the same
    step without a mesh (bit-equal), `train_debias --distributed 1` at world
    size 1 over a tcp rendezvous, and two ranks on the card over gloo (data=2,
    2 lanes each) against the one-process step and the same step re-chunked
    (`MESH_REBATCH_RATIO`), with three faults of the split as controls that
    must fail that check; then each rank's own gradients against the fp32
    one-process step over its lanes (`lane_shares`), at most
    `MESH_REBATCH_RATIO` x as far as the one-process bf16 share is, the
    ranks' lanes swapped as a control that must fail (the share re-chunked,
    which sees phase 4b's rounding only, is logged beside it). -> (the
    one-process trainer, its fp32 twin, their weights file, the prompt ids)
    for `[tp]`."""
    import io

    import torch.distributed as dist

    from fairdiff_torch.io.tokenizer import HashTokenizer
    from fairdiff_torch.parallel.launch import spawn
    from fairdiff_torch.parallel.mesh import MeshConfig, create_mesh
    from fairdiff_torch.tools import train_debias
    from fairdiff_torch.training.debias import DebiasTrainer
    from fairdiff_torch.utils import rng as rng_lib
    from fairdiff_torch.utils.tree import tree_leaves

    failed = []
    plain = train_debias.build_trainer(train_debias.TrainCLIConfig(**MESH_STEP))
    sd, dcfg = plain.sd, plain.cfg
    ids = train_debias.tokenize_prompts(sd, HashTokenizer(), list(train_debias.DEFAULT_PROMPTS))[0]
    noises = rng_lib.train_noises(dcfg.seed, 0, sd.latent_shape(4))
    steps = MESH_STEP["steps"]
    want = _step_launches(steps, 4, 2, PAIR_VJP_LAUNCHES)

    def one_step(tr):
        reset_counts()
        t0 = time.perf_counter()
        st, logs = tr.train_step(tr.init_state(dcfg.seed), ids, noises=noises, n_steps=steps)
        torch.cuda.synchronize()
        return dict(adapters=tree_leaves(st.adapters), grads=tree_leaves(tr._last_grads), logs=logs,
                    launches=launch_counts(), seconds=time.perf_counter() - t0,
                    targets={a: t.cpu() for a, t in tr._last_targets.items()})

    # 1. world size 1 on NCCL: the 1x1 mesh's step, bit for bit the plain step
    dist.init_process_group("nccl", init_method=f"file://{work / 'store'}", world_size=1, rank=0)
    try:
        meshed = DebiasTrainer(sd, plain.guidance, dcfg, mesh=create_mesh(MeshConfig(data=1, model=1), device=sd.device))
        dist.barrier()
        runs = {"plain": one_step(plain), "mesh": one_step(meshed)}
    finally:
        dist.destroy_process_group()
    p_, m_ = runs["plain"], runs["mesh"]
    equal = (all(torch.equal(a, b) for a, b in zip(p_["adapters"], m_["adapters"]))
             and all(torch.equal(a, b) for a, b in zip(p_["grads"], m_["grads"])) and p_["logs"] == m_["logs"])
    log(f"[mesh] world 1 on nccl, 1x1 mesh vs no mesh, one exp-1 step (4 lanes, micro-batch 2, {steps} denoising "
        f"steps, SD-1.5 bf16): adapters, gradients and logs bit-equal {equal}; {m_['seconds']:.3f} s (no mesh "
        f"{p_['seconds']:.3f} s) on {power}; launches {m_['launches']} (want {want})")
    if not (equal and m_["launches"] == want and p_["logs"]["grads_finite"] and p_["logs"]["grad_norm"] > 0):
        failed.append(f"world-1 mesh step: bit-equal {equal}, launches {m_['launches']}, logs {m_['logs']}")

    # 2. the CLI at world size 1 on NCCL over a tcp rendezvous
    argv = ["--distributed", "1", "--coordinator_address", f"127.0.0.1:{_free_port()}", "--num_processes", "1",
            "--process_id", "0", "--mesh_data", "1", "--output_dir", str(work / "cli")]
    for k, v in MESH_STEP.items():
        argv += [f"--{k}", str(v)]
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            train_debias.main(train_debias.parse_args(argv))
        torch.cuda.synchronize()
        joined = (dist.get_backend(), dist.get_world_size())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ran = launch_counts()
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    log(f"[mesh] train_debias --distributed 1 --num_processes 1 --mesh_data 1: joined {joined}, "
        f"{time.perf_counter() - t0:.2f} s incl. setup; logs {lines}; launches {ran} (want {want})")
    if not (joined == ("nccl", 1) and [x["step"] for x in lines] == [1] and lines[0]["grads_finite"]
            and (work / "cli" / "exported" / "te_lora.npz").exists() and ran == want):
        failed.append(f"CLI at world 1: joined {joined}, logs {lines}, launches {ran}")

    # 3. the split step's reference: the same step re-chunked (micro-batch 4)
    runs["rebatched"] = one_step(DebiasTrainer(sd, plain.guidance, dataclasses.replace(dcfg, train_micro_batch=4)))
    # and each data rank's share of the one-process step: its 2 lanes' pair
    # VJPs alone, in chunks of 2 (as the rank) and of 1 (that share's own
    # re-chunking error, at its own scale)
    spans = [slice(0, 2), slice(2, 4)]
    with lane_shares(plain, spans, chunks=(None, 1)) as lane_grads:
        one_step(plain)
    flat = {k: torch.cat([g.float().flatten().cpu() for g in r["grads"]]) for k, r in runs.items()}
    rebatched = rel_l2(flat["rebatched"], flat["plain"])
    same_targets = torch.equal(runs["rebatched"]["targets"]["gender"], p_["targets"]["gender"])
    log(f"[mesh] reference: the step re-chunked (micro-batch 4) vs micro-batch 2 rel L2 {rebatched:.3e}; "
        f"targets equal {same_targets}")
    if not same_targets:
        failed.append("the re-chunked step's targets differ")
    weights = work / "sd15.pt"
    _save_sd(sd, weights)
    exact = DebiasTrainer(_load_sd(str(weights), "float32"), plain.guidance, dcfg)
    # the same shares of the step in fp32: each rank's yardstick
    t0 = time.perf_counter()
    with lane_shares(exact, spans) as lane_fp32:
        one_step(exact)
    log(f"[mesh] the fp32 step with its lane shares {time.perf_counter() - t0:.1f} s")

    # 4. two ranks on the card over gloo, 2 lanes each
    torch.cuda.empty_cache()  # the ranks share the card
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_debias_rank", 2, backend="gloo", device="cuda", threads=4, workdir=work,
                  timeout=MESH_TIMEOUT, kwargs=dict(weights=str(weights), fields=dataclasses.asdict(dcfg),
                                                    noises=noises, n_steps=steps, ids=ids))
    wall = time.perf_counter() - t0
    want_rank = _step_launches(steps, 2, 2, PAIR_VJP_LAUNCHES)
    flat_local = [torch.cat([g.flatten() for g in res["local"]]) for res in ranks]
    summed = flat_local[0] + flat_local[1]
    reduced = torch.cat([g.flatten() for g in ranks[0]["grads"]])
    sum_err = rel_l2(reduced, summed)
    limit = MESH_REBATCH_RATIO * rebatched
    # faults the check must catch: no all-reduce (each rank keeps its own
    # gradients; caught if any rank's check fails), a mean over ranks on top
    # of the chunk norm, and the chunk norm taken from the local lanes
    controls = {"each rank its own (worst rank)": max(rel_l2(x, flat["plain"]) for x in flat_local),
                "sum / 2": rel_l2(summed / 2, flat["plain"]), "sum x 2": rel_l2(summed * 2, flat["plain"])}
    shares = [round((x.norm() / summed.norm()).item(), 4) for x in flat_local]
    log(f"[mesh] data=2: all-reduced gradients vs the sum of the ranks' own rel L2 {sum_err:.3e} (tol "
        f"{MESH_SUM_TOL}; bit-equal {torch.equal(reduced, summed)}); each rank's share of the sum's norm "
        f"{shares}; controls vs the one-process step " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
        + f" (each must exceed {limit:.3e})")
    if not sum_err <= MESH_SUM_TOL:
        failed.append(f"data=2: all-reduced vs summed rel L2 {sum_err}")
    failed += [f"data=2 control {k} passed the check ({v})" for k, v in controls.items() if not v > limit]
    for r, res in enumerate(ranks):
        vs_one = rel_l2(torch.cat([g.flatten() for g in res["grads"]]), flat["plain"])
        same = all(torch.equal(a, b) for a, b in zip(res["grads"], ranks[0]["grads"]))
        log(f"[mesh] data=2 over gloo on the one card, rank {r}: step {res['seconds']:.3f} s; all-reduced gradients "
            f"vs the one-process step rel L2 {vs_one:.3e} (<= {MESH_REBATCH_RATIO} x the re-chunked step's "
            f"{rebatched:.3e}), equal to rank 0's {same}; train_loss {res['logs'].get('train_loss')} vs "
            f"{p_['logs'].get('train_loss')}; launches {res['launches']} (want {want_rank})")
        if not (vs_one <= MESH_REBATCH_RATIO * rebatched and same and res["launches"] == want_rank
                and res["logs"]["grads_finite"]):
            failed.append(f"data=2 rank {r}: rel L2 {vs_one}, same {same}, launches {res['launches']}")
    # each rank's own gradients (before the all-reduce) against the
    # one-process step over that rank's lanes: in fp32, at most 1.5x as far
    # as the one-process bf16 share is; its lanes swapped as a control
    for r in range(2):
        share = (lane_grads[(r, None)].norm() / flat["plain"].norm()).item()
        own = rel_l2_or_zero(flat_local[r], lane_grads[(r, None)])
        rechunk = rel_l2_or_zero(lane_grads[(r, 1)], lane_grads[(r, None)])
        err_rank = rel_l2_or_zero(flat_local[r], lane_fp32[(r, None)])
        err_one = rel_l2_or_zero(lane_grads[(r, None)], lane_fp32[(r, None)])
        limit = MESH_REBATCH_RATIO * err_one
        swapped = rel_l2_or_zero(flat_local[r], lane_fp32[(1 - r, None)])
        log(f"[mesh] data=2 rank {r} (lanes {spans[r].start}-{spans[r].stop - 1}, {share:.4%} of the step's gradient "
            f"norm): its own gradients vs the fp32 one-process step over its lanes rel L2 {err_rank:.3e} (<= "
            f"{MESH_REBATCH_RATIO} x the one-process bf16 share's {err_one:.3e}); vs the bf16 share {own:.3e} "
            f"({own / max(rechunk, 1e-30):.2f}x that share re-chunked, {rechunk:.3e}); control, against rank "
            f"{1 - r}'s lanes in fp32: {swapped:.3e} (must exceed {limit:.3e})")
        if not err_rank <= limit:
            failed.append(f"data=2 rank {r} vs its lanes in fp32: rel L2 {err_rank}, limit {limit}")
        if not swapped > limit:
            failed.append(f"data=2 rank {r} swapped-lanes control passed ({swapped})")
    log(f"[mesh] two ranks' launch {wall:.1f} s (process start, weights, step)")
    if failed:
        raise AssertionError(f"[mesh] failed: {failed}")
    return plain, exact, weights, ids


def _tp_inputs(sd, dcfg, ids):
    """[tp]'s inputs: a CFG batch of 2 rows for the UNet, both prompts for
    the text encoder, a rank-4 UNet LoRA and the text-encoder LoRA (`up`
    seeded non-zero) and one pair VJP's trajectory and cotangent (2 lanes)."""
    from fairdiff_torch.training.debias import init_adapters

    g = torch.Generator().manual_seed(13)
    cfg = dataclasses.replace(dcfg, train_unet=True, lora_rank=4)
    adapters = init_adapters(cfg, sd.text_encoder, sd.unet, 5)

    def seed_ups(node):  # `up` is 0 at init, and then no gradient reaches `down`
        if "up" in node:
            node["up"] = torch.randn(node["up"].shape, generator=g) * 0.01
        for v in node.values():
            if isinstance(v, dict):
                seed_ups(v)

    seed_ups(adapters)
    return dict(
        fields=dataclasses.asdict(cfg), adapters=adapters,
        lat=torch.randn(2, 64, 64, 4, generator=g), t=torch.tensor([999, 500]),
        ctx=torch.randn(2, 77, 768, generator=g), mask=(torch.arange(77)[None] < torch.tensor([[9], [77]])).int(),
        te_ids=torch.cat([ids[0], ids[1]]).cpu(),
        traj=torch.randn(1, 2, 64, 64, 4, generator=g), cot=torch.randn(1, 2, 64, 64, 4, generator=g) * 1e-2,
        ids=tuple(x.cpu() for x in ids),
    )


def _tp_run(trainer, inputs: dict, checked_attention=None) -> dict:
    """The UNet forward, the text encoder and one pair VJP of `_tp_inputs`
    on `trainer`'s (possibly split) SD; the LoRA gradients summed over the
    model axis."""
    from fairdiff_torch.ops import geglu as gg
    from fairdiff_torch.ops.flash_attention import flash_attention
    from fairdiff_torch.training.debias import new_state
    from fairdiff_torch.utils.tree import tree_leaves

    sd, dev = trainer.sd, trainer.device
    cuda = lambda x: x.to(dev)  # noqa: E731
    reset_counts()
    with torch.no_grad(), routes(checked_attention or flash_attention, gg.geglu):
        eps = sd.unet(*(cuda(inputs[k]) for k in ("lat", "t", "ctx", "mask"))).float()
        hidden = sd.text_encoder(cuda(inputs["te_ids"]))["last_hidden_state"].float()
    fwd = launch_counts()
    adapters = new_state(trainer.cfg, inputs["adapters"], dev).adapters
    reset_counts()
    t0 = time.perf_counter()
    grads = trainer._reduce_grads(trainer._pair_grads(
        adapters, cuda(inputs["traj"]), cuda(inputs["cot"]), torch.tensor([500]), *(cuda(x) for x in inputs["ids"]), 2))
    torch.cuda.synchronize()
    return {"eps": eps.cpu(), "hidden": hidden.cpu(), "forward_launches": fwd, "vjp_launches": launch_counts(),
            "vjp_s": time.perf_counter() - t0,
            "lora_grads": [g.float().cpu() for k in ("te_lora", "unet_lora") for g in tree_leaves(grads[k])]}


def tp_rank(weights: str, inputs: dict) -> dict:
    """[tp] rank: the SD split over a model axis of the whole world; every K1
    launch of the UNet forward held against its plain version."""
    import torch.distributed as dist

    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.parallel.mesh import MeshConfig, create_mesh
    from fairdiff_torch.training.debias import DebiasConfig, DebiasTrainer
    from fairdiff_torch.training.synthetic import synthetic_stack

    _rank_setup()
    sd = _load_sd(weights)
    dcfg = DebiasConfig(**inputs["fields"])
    mesh = create_mesh(MeshConfig(data=1, model=dist.get_world_size()), device=sd.device, backend="gloo")
    trainer = DebiasTrainer(sd, synthetic_stack(dcfg.attributes, device=sd.device), dcfg, mesh=mesh)
    checks, heads = [], []

    def checked(q, k, v, flash_bwd="split", key_mask=None):
        got = fa.flash_attention(q, k, v, key_mask=key_mask)
        heads.append(q.shape[2])
        checks.append(compare(got, fa.flash_attention_plain(q, k, v, key_mask),
                              fa.flash_attention_plain(q.float(), k.float(), v.float(), key_mask),
                              drop_last_tile(q, k, v, key_mask=key_mask)))
        return got

    out = _tp_run(trainer, inputs, checked)
    return dict(out, checks=checks, heads=heads)


def phase_tp(power: str, trainer, exact, weights: Path, ids, work: Path) -> None:
    """[tp]: the text encoder's and the UNet's attention (and the TE MLP)
    split over model=2, as two processes on the card over gloo, against the
    replicated model on the same weights and its fp32 twin `exact`: the
    UNet's CFG forward at batch 2 and the text encoder as the bf16 UNet
    parity phase holds them, every K1 launch (at 4 local heads) against its
    plain version, and one pair VJP's LoRA gradients (UNet and text encoder)
    to `MESH_ACCURACY_RATIO` of the replicated model's error against fp32."""
    from fairdiff_torch.parallel.launch import spawn
    from fairdiff_torch.training.debias import DebiasConfig, DebiasTrainer

    failed = []
    inputs = _tp_inputs(trainer.sd, trainer.cfg, ids)
    cfg = DebiasConfig(**inputs["fields"])
    ref = _tp_run(DebiasTrainer(trainer.sd, trainer.guidance, cfg), inputs)
    f32 = _tp_run(DebiasTrainer(exact.sd, exact.guidance, cfg), inputs)
    torch.cuda.empty_cache()  # the ranks share the card
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:tp_rank", 2, backend="gloo", device="cuda", threads=4, workdir=work,
                  timeout=MESH_TIMEOUT, kwargs=dict(weights=str(weights), inputs=inputs))
    wall = time.perf_counter() - t0
    flat = lambda r: torch.cat([g.flatten() for g in r["lora_grads"]])  # noqa: E731
    want_vjp = PAIR_VJP_LAUNCHES_LORA
    for r, res in enumerate(ranks):
        e = {k: (rel_l2(res[k], ref[k]), rel_l2(res[k], f32[k]), rel_l2(ref[k], f32[k])) for k in ("eps", "hidden")}
        lora = (rel_l2(flat(res), flat(ref)), rel_l2(flat(res), flat(f32)), rel_l2(flat(ref), flat(f32)))
        bad = [i for i, c in enumerate(res["checks"]) if c["failed"]]
        log(f"[tp] model=2 over gloo, rank {r}: rel L2 vs replicated / vs fp32 (replicated vs fp32): UNet CFG forward "
            f"(2 rows, bf16) {e['eps'][0]:.3e} / {e['eps'][1]:.3e} ({e['eps'][2]:.3e}), text encoder "
            f"{e['hidden'][0]:.3e} / {e['hidden'][1]:.3e} ({e['hidden'][2]:.3e}) (tol {UNET_BF16_REL_L2_TOL:.0e}, "
            f"{UNET_BF16_ACCURACY_RATIO} x); K1 {len(res['checks'])} launches at {sorted(set(res['heads']))} local "
            f"heads, each against its plain version: worst elem_use {max(c['elem_use'] for c in res['checks']):.3f}, "
            f"worst rel_l2 {max(c['rel_l2'] for c in res['checks']):.3e}, weakest control "
            f"{min(c['control_rel_l2'] for c in res['checks']):.3e}, failed {bad}; pair VJP (rank-4 UNet LoRA and the "
            f"TE LoRA, 2 lanes) {res['vjp_s']:.3f} s (replicated {ref['vjp_s']:.3f} s), LoRA gradients "
            f"{lora[0]:.3e} / {lora[1]:.3e} ({lora[2]:.3e}; {MESH_ACCURACY_RATIO} x); launches forward "
            f"{res['forward_launches']}, VJP {res['vjp_launches']} (want {want_vjp})")
        if not (all(a <= UNET_BF16_REL_L2_TOL and b <= UNET_BF16_ACCURACY_RATIO * c for a, b, c in e.values())
                and lora[1] <= MESH_ACCURACY_RATIO * lora[2]
                and not bad and len(res["checks"]) == UNET_CALL_LAUNCHES["flash_attention"]
                and set(res["heads"]) == {4} and res["vjp_launches"] == want_vjp
                and res["forward_launches"]["flash_attention"] == UNET_CALL_LAUNCHES["flash_attention"]):
            failed.append(f"model=2 rank {r}: {e}, lora {lora}, bad launches {bad}, heads {set(res['heads'])}, "
                          f"launches {res['vjp_launches']}")
    log(f"[tp] two ranks' launch {wall:.1f} s (process start, weights, checks); replicated launches "
        f"forward {ref['forward_launches']}, VJP {ref['vjp_launches']}")
    if ref["vjp_launches"] != want_vjp:
        failed.append(f"replicated pair VJP launches {ref['vjp_launches']}")
    if failed:
        raise AssertionError(f"[tp] failed: {failed}")


def facerec_rank(cli_fields: dict, init_params) -> int:
    """[mesh] rank of `train_facerec --data_mesh`: the CLI's main from the
    given weights."""
    from fairdiff_torch.tools import train_facerec

    _rank_setup()
    return train_facerec.main(train_facerec.FaceRecCLIConfig(**cli_fields), init_params=init_params)["step"]


def mesh_facerec(power: str, root: Path, cfg_path: Path, trained: dict, steps: int = 2) -> None:
    """[mesh] `train_facerec --data_mesh 2` (two processes on the card over
    gloo, 256 rows each) against one process at the recipe's batch 512,
    `steps` steps from `[facerec]`'s trained weights: every backbone leaf
    within `MESH_FACEREC_TOL`."""
    import io

    import numpy as np

    from fairdiff_torch.io.adapters_io import load_adapters
    from fairdiff_torch.parallel.launch import spawn
    from fairdiff_torch.tools import train_facerec

    fields = dict(config=str(cfg_path), max_iters=steps, log_every=1, save_every=steps)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_facerec.main(train_facerec.FaceRecCLIConfig(output_dir=str(root / "one"), **fields), init_params=trained)
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()  # the ranks share the card
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:facerec_rank", 2, backend="gloo", device="cuda", threads=4, workdir=root,
                  timeout=MESH_TIMEOUT, kwargs=dict(cli_fields=dict(fields, output_dir=str(root / "two"), data_mesh=2),
                                                    init_params=trained))
    two_s = time.perf_counter() - t0
    one, two = (dict(_npz_leaves(load_adapters(root / d / "backbone_final.npz"))) for d in ("one", "two"))
    errs = {"/".join(k): float(np.linalg.norm(two[k] - a) / max(np.linalg.norm(a), 1e-30)) for k, a in one.items()}
    worst = max(errs, key=errs.get)
    losses = [[json.loads(x)["loss"] for x in (root / d / "metrics.jsonl").read_text().splitlines() if '"loss"' in x]
              for d in ("one", "two")]
    log(f"[mesh] train_facerec --data_mesh 2 (two ranks over gloo on the card, 256 rows each) vs one process, "
        f"batch 512, {steps} steps from [facerec]'s weights: every backbone leaf rel L2 <= {errs[worst]:.3e} "
        f"({worst}; tol {MESH_FACEREC_TOL}) over {len(errs)} leaves; losses {losses[1]} vs {losses[0]}; wall "
        f"{two_s:.1f} s incl. process start (one process {one_s:.1f} s) on {power}")
    if not (ranks == [steps, steps] and set(one) == set(two) and errs[worst] <= MESH_FACEREC_TOL
            and np.allclose(losses[1], losses[0], rtol=MESH_FACEREC_TOL)):
        raise AssertionError(f"[mesh] train_facerec --data_mesh 2 failed: {worst} {errs[worst]}, steps {ranks}")


def phase_tools(power: str, work: Path) -> None:
    """[tools]: every tool of this slice once at the shapes it defaults to,
    each with its kernel launches counted around it (every kernel its path
    runs must launch) and one JSON row: its seconds and launches beside the
    card's name and power limit (each tool's own rows carry the card too)."""
    import io

    import numpy as np

    from fairdiff_torch.tools import (bench_attention, bench_gen, bench_geglu, convergence_demo, plot_curves,
                                      roofline, setup_data, tp_scaling)

    failed = []

    def run(name: str, fn, kernels: tuple[str, ...] = ()):
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = {k: v for k, v in launch_counts().items() if v}
        for line in out.getvalue().splitlines():
            log(f"[tools] {name} | {line}")
        log(json.dumps({"tool": name, "seconds": round(seconds, 3), "launches": ran, "card": power}))
        missing = [k for k in kernels if not ran.get(k)]
        if missing:
            failed.append(f"{name}: no launch of {missing}")
        return result

    lse = ("flash_attention_lse", "flash_attention_dq", "flash_attention_dkv")
    rows = run("bench_gen --batches 10,16 --timed 1", lambda: bench_gen.main(["--batches", "10,16", "--timed", "1"]),
               ("flash_attention", "geglu"))
    if [r["batch"] for r in rows] != [10, 16] or not all(r["img_per_s"] > 0 for r in rows):
        failed.append(f"bench_gen rows {rows}")
    fwd = run("bench_attention", lambda: bench_attention.main([]), ("flash_attention",))
    grad = run("bench_attention --grad", lambda: bench_attention.main(["--grad"]),
               lse + ("flash_attention_bwd_merged",))
    if len(fwd) != 4 or len(grad) != 4 or max(r["max_abs_err"] for r in fwd) > 0.1:
        failed.append(f"bench_attention rows {fwd} {grad}")
    run("bench_geglu", lambda: bench_geglu.main([]), ("geglu", "geglu_dx"))
    rdir = str(work / "roofline")
    run("roofline --mode flash", lambda: roofline.main(roofline.RooflineConfig(mode="flash", out_dir=rdir)), lse)
    run("roofline --mode programs --prog_iters 3", lambda: roofline.main(
        roofline.RooflineConfig(mode="programs", out_dir=rdir, prog_iters=3)),
        ("flash_attention",) + lse + ("geglu", "geglu_dx"))
    run("roofline --mode report", lambda: roofline.main(roofline.RooflineConfig(mode="report", out_dir=rdir)))
    run("tp_scaling --mode trainer_pair --lanes 4,8,12,24", lambda: tp_scaling.main(
        tp_scaling.TPScalingConfig(mode="trainer_pair", lanes=(4, 8, 12, 24))), lse + ("geglu_dx",))
    # its ranks count their own launches
    torch.cuda.empty_cache()
    run("tp_scaling --mode unet_vjp --lanes 4", lambda: tp_scaling.main(
        tp_scaling.TPScalingConfig(mode="unet_vjp", lanes=(4,))))
    bundle = work / "data-dev"
    run("setup_data --synthetic_out", lambda: setup_data.main(setup_data.SetupDataConfig(synthetic_out=str(bundle))))
    missing = run("setup_data --data_dir", lambda: setup_data.main(setup_data.SetupDataConfig(data_dir=str(bundle))))
    if set(missing) != {"exp1", "exp2", "exp3", "exp4", "exp5", "exp6", "eval"}:
        failed.append(f"setup_data check: {missing}")
    conv = work / "convergence"
    run("convergence_demo --steps 20", lambda: convergence_demo.main(
        convergence_demo.DemoConfig(steps=20, output_dir=str(conv), plot=False)), ("geglu", "geglu_dx"))
    written = run("plot_curves", lambda: plot_curves.main(plot_curves.PlotConfig(
        metrics_jsonl=str(conv / "metrics.jsonl"), save_dir=str(conv / "curves"))))
    recs = [json.loads(x) for x in (conv / "metrics.jsonl").read_text().splitlines()]
    gaps = [r["gender_gap_abs"] for r in recs]
    log(f"[tools] convergence_demo on {power}: gender_gap_abs first 5 {np.mean(gaps[:5]):.3f}, last 10 "
        f"{np.mean(gaps[-10:]):.3f}; {len(written)} panels")
    if len(recs) != 20 or not written or not all(r["grads_finite"] for r in recs):
        failed.append(f"convergence_demo: {len(recs)} records, {len(written)} panels")
    if failed:
        raise AssertionError(f"[tools] failed: {failed}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = phase_device()
    power = smi_name_power()
    t = time.perf_counter()
    phase_build()
    log(f"[time] build {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_imageio(power)
    log(f"[time] imageio {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_emd(power)
    log(f"[time] emd {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows = phase_kernels()
    log(f"[time] kernels {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_parity()
    log(f"[time] unet-fp32 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_768(power)
    log(f"[time] unet-768 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts_gen, slice_jpgs = phase_slice()
    log(f"[time] slice {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_throughput(power)
    log(f"[time] throughput {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows.update(phase_kernels_bwd())
    log(f"[time] kernels-bwd {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    vjp_split = phase_unet_vjp(power)
    log(f"[time] unet-vjp {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    train_counts = phase_train()
    log(f"[time] train {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_step(power)
    log(f"[time] train-step {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    gn_rows, gn_launches = phase_kernels_gn()
    rows.update(gn_rows)
    log(f"[time] kernels-gn {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_vjp(power, flash_bwd="merged")
    log(f"[time] unet-vjp-merged {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_zoo()
    log(f"[time] zoo {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_step(power, zoo=True, lanes=CUT_LANES)
    log(f"[time] train-zoo {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cli_zoo_counts = phase_train(flash_bwd="merged", zoo=True)
    log(f"[time] train-cli-zoo {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_step(power, experiment="exp3", lanes=CUT_LANES_EXP3)
    log(f"[time] train-exp3 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_exps(steps=CUT_DENOISING_STEPS)
    log(f"[time] train-exps {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_vjp_lora(power)
    log(f"[time] unet-vjp-lora {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_lifecycle(steps=CUT_DENOISING_STEPS)
    log(f"[time] train-lifecycle {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_step(power, unet=True, lanes=CUT_LANES)
    log(f"[time] train-unet-lora {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tokenizer_dir, tokenizer_jpgs = phase_tokenizer(power)
    log(f"[time] tokenizer {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_weights(slice_jpgs, tokenizer_dir, tokenizer_jpgs)
    log(f"[time] weights {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_eval(power)
    log(f"[time] eval {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_vjp(power, flash_bwd="recompute", beside=vjp_split)
    log(f"[time] unet-vjp-recompute {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_profile(power)
    _SD15.clear()  # the last run on the shared SD-1.5
    torch.cuda.empty_cache()
    log(f"[time] train-profile {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_facerec(power, steps=CUT_FACEREC_STEPS)
    log(f"[time] facerec {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as work:
        trainer, exact, weights, ids = phase_mesh(power, Path(work))
        log(f"[time] mesh {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_tp(power, trainer, exact, weights, ids, Path(work))
        del trainer, exact
        log(f"[time] tp {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_tools(power, Path(work))
        log(f"[time] tools {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_detector(power)
    log(f"[time] detector {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    summary = []
    for kname, main_shape, source, replaces, launches in (
        ("flash_attention", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:190", counts_gen),
        ("geglu", "d320", "geglu", "fairdiff/ops/geglu.py:156", counts_gen),
        ("flash_attention_lse", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:190", train_counts),
        ("flash_attention_dq", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:539", train_counts),
        ("flash_attention_dkv", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:566", train_counts),
        ("geglu_dx", "d320", "geglu", "fairdiff/ops/geglu.py:179", train_counts),
        ("flash_attention_bwd_merged", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:417",
         cli_zoo_counts),
        ("group_norm", "res960x4096", "group_norm", "fairdiff/ops/group_norm.py:147", {"group_norm": gn_launches}),
    ):
        r = rows[f"{kname}/{main_shape}"]
        summary.append({
            "name": kname, "route": "cuda", "source": f"fairdiff_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches[kname], "shape": r["shape"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": summary}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
