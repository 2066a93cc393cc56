"""The generation cells: the per-batch loop of tools/gen_images.py (the
noise bank `prompt_noise_generator`, `StableDiffusion.generate` with the
configuration's LoRA (merged in every call), then `save_image` as JPEG at the mix's
quality into the run's TMPDIR), fed by the "gen" traffic generator.

Set-up draws the weights and the adapter from the seed and runs one batch
of the protocol (warming every shape of the window). The window runs whole
batches until `seconds` have passed; gen_img_per_s is the images written
over its wall time. After the window the program is freed and the
reference (fp32, TF32 off) regenerates a sample of the window's images,
drawn from the seed, from the same prompts and noise bank: each is held to
it by its relative L2 distance, and each file is checked to be a whole
JPEG.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import compare, models
from benchmark.harness import traffic as traffic_lib
from benchmark.harness.record import RunRecord
from benchmark.harness.trace import DeviceTrace, TraceResult


def noise_bank(seed: int, prompt: str, index: int, shape) -> torch.Tensor:
    """The protocol's noise of (seed, prompt, image index): a frozen copy of
    fairdiff_torch/utils/rng.py `prompt_noise_generator` (blake2b of the
    text, a CPU generator)."""
    def h(text: str, bits: int) -> int:
        return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8).digest(), "little") % (1 << bits)

    g = torch.Generator(device="cpu")
    g.manual_seed(h(f"{seed}/{h(prompt, 31)}/{index}", 63))
    return torch.randn(shape, generator=g)


def whole_jpeg(path: Path) -> bool:
    data = path.read_bytes() if path.exists() else b""
    return len(data) > 1000 and data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def reference_images(ctx, batches: list[dict], picks: list[tuple[int, int]], fp8: bool = False) -> list[np.ndarray]:
    """The reference's images of `picks` ((batch position, image position))."""
    from benchmark.reference import lowp

    config, mix, dev = ctx.cell["config"], ctx.cell["traffic"], ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    w = models.Weights(config, ctx.seed, dev, ctx.dtype)
    sd = models.reference_sd(config, w, dev)
    adapters = w.adapters()
    s = sd.config.unet.sample_size
    out = []
    with lowp.fp8() if fp8 else contextlib.nullcontext():
        for b, i in picks:
            batch = batches[b]
            z = noise_bank(ctx.seed, batch["prompt"], batch["images"][i], (s, s, 4))[None]
            img = sd.generate(z, batch["cond_ids"], batch["uncond_ids"], mix["denoising_steps"], mix["guidance_scale"],
                              **adapters)
            out.append(img[0].cpu().numpy())
    return out



def pick(seed: int, n_batches: int, batch: int, count: int) -> list[tuple[int, int]]:
    r = traffic_lib.rng(seed, "sample")
    flat = r.choice(n_batches * batch, size=min(count, n_batches * batch), replace=False)
    return sorted((int(k) // batch, int(k) % batch) for k in flat)


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def control_gap(ctx, n_batches: int = 18) -> float:
    """The control's number: the widest relative L2 distance of the fp8
    reference's images from the fp32 reference's, over the sample a window
    of `n_batches` batches would draw."""
    batches = [b for b, _ in zip(traffic_lib.gen_batches(ctx.cell["traffic"], ctx.seed,
                                                         *models.text_shape(ctx.cell["config"])), range(n_batches + 1))]
    batches = batches[1:]  # the first batch is set-up's
    picks = pick(ctx.seed, len(batches), ctx.cell["traffic"]["batch"], ctx.cell["traffic"]["reference_images"])
    ref = reference_images(ctx, batches, picks)
    low = reference_images(ctx, batches, picks, fp8=True)
    return max(rel_l2(a, b) for a, b in zip(low, ref))


def run(ctx) -> dict:
    from fairdiff_torch.io.images import save_image
    from fairdiff_torch.utils.rng import prompt_noise_generator

    config, mix, dev, spans = ctx.cell["config"], ctx.cell["traffic"], ctx.device, ctx.spans
    out_dir = Path(tempfile.mkdtemp(prefix="gen-", dir=os.environ.get("TMPDIR")))
    try:
        with spans.span("build"):
            w = models.Weights(config, ctx.seed, dev, ctx.dtype)
            sd = models.program_sd(config, w, dev)
            adapters = w.adapters()  # {"unet_lora": tree} or {"te_lora": tree}, as gen_images passes it
            del w
        latent = sd.latent_shape(1)[1:]

        def one_batch(batch: dict) -> np.ndarray:
            with spans.span("noise_bank"):
                noises = torch.stack([torch.randn(latent, generator=prompt_noise_generator(ctx.seed, batch["prompt"], j))
                                      for j in batch["images"]])
            with spans.span("generate"):
                imgs = sd.generate(noises, batch["cond_ids"], batch["uncond_ids"], mix["denoising_steps"],
                                   guidance_scale=mix["guidance_scale"], **adapters).cpu().numpy()
            prompt_dir = out_dir / f"prompt_{batch['prompt_index']}"
            for j, img in zip(batch["images"], imgs):
                with spans.span("save_image"):
                    save_image(img, prompt_dir / f"img_{j}.jpg", quality=mix["quality"])
            return imgs

        feed = traffic_lib.gen_batches(mix, ctx.seed, *models.text_shape(config))
        with spans.span("warmup"):
            one_batch(next(feed))
        ctx.sync()
        setup_s = time.perf_counter() - ctx.t_start
        print(f"[gen] set-up {setup_s:.1f} s: models {spans.total_s('build'):.1f} s, first batch "
              f"{spans.total_s('warmup'):.1f} s", file=sys.stderr)

        batches, images = [], []
        with DeviceTrace(ctx.trace) as tracer:
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                batch = next(feed)
                images.append(one_batch(batch))
                batches.append(batch)
            ctx.sync()
            window_s, t1_ns = time.perf_counter() - t0, time.time_ns()
        peak = ctx.peak_bytes()
        written = sum(len(b["images"]) for b in batches)
        files = [out_dir / f"prompt_{b['prompt_index']}" / f"img_{j}.jpg" for b in batches for j in b["images"]]
        del sd, adapters
        gc.collect()
        ctx.empty_cache()

        picks = pick(ctx.seed, len(batches), mix["batch"], mix["reference_images"])
        t_ref = time.perf_counter()
        ref = reference_images(ctx, batches, picks)
        print(f"[gen] reference of {len(picks)} images in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
        gaps = [rel_l2(images[b][i], r) for (b, i), r in zip(picks, ref)]
        bad_files = sum(not whole_jpeg(f) for f in files)
        print(f"[gen] sample {picks}: rel L2 {['%.4g' % g for g in gaps]}; {bad_files} of {len(files)} files not "
              f"whole JPEGs", file=sys.stderr)
        ok, checks = compare.judge({"image_rel_l2": max(gaps)}, ctx.cell["limits"])
        work = [{"images": len(b["images"]), "n_steps": mix["denoising_steps"]} for b in batches]
        record = RunRecord("gen", config, mix, window_s, work, spans, (t0_ns, t1_ns), peak,
                           TraceResult(tracer.read(), t0_ns, t1_ns, spans.items) if ctx.trace else None)
        return {
            "correct": ok and bad_files == 0, "checks": checks, "attempted": written, "failed": bad_files,
            "end_to_end": {"gen_img_per_s": written / window_s, "setup_s": setup_s},
            "record": record,
        }
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
