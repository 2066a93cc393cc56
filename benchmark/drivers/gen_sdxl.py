"""The SDXL generation cells: the per-batch loop of drivers/gen.py on the
program's SDXL pipeline (`SDConfig.sdxl()`: both text encoders, the
text_time conditioning, the UNet LoRA merged in every call, the decode at
1024 px, then `save_image` as JPEG at the mix's quality into the run's
TMPDIR), fed by the "gen" traffic generator (a mix of kind "gen_sdxl" holds
the same keys as a "gen" mix).

Set-up draws the weights and the adapter from the seed and runs one batch
of the protocol (warming every shape of the window). The window runs whole
batches until `seconds` have passed; gen_img_per_s is the images written
over its wall time. After the window the program is freed and the
reference (`reference/sdxl.py`, fp32, TF32 off) regenerates a sample of the
window's images, drawn from the seed, from the same prompts and noise bank:
each is held to it by its relative L2 distance, and each file is checked to
be a whole JPEG.

A program without `SDConfig.sdxl` cannot run the cell: the run says so,
kills the kernels' background build (every process this one started, with
their own children) and exits with code 1 at once, leaving no process
behind.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.drivers.gen import noise_bank, pick, rel_l2, whole_jpeg
from benchmark.harness import compare
from benchmark.harness import traffic as traffic_lib
from benchmark.harness import weights as wlib
from benchmark.harness.models import _tuples
from benchmark.harness.record import RunRecord
from benchmark.harness.trace import DeviceTrace, TraceResult

PR_SET_CHILD_SUBREAPER = 36  # prctl(2), <linux/prctl.h>


def ref_config(config: dict):
    """The reference's `SDXLConfig` of the configuration ("sd": "sdxl", or
    "tiny": `SDConfig.tiny_xl()`'s sizes)."""
    from benchmark.reference.autoencoder_kl import VAEConfig
    from benchmark.reference.sdxl import SDXLConfig, TextConfig, UNetConfig

    if config["sd"] == "tiny":
        text = TextConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=16, eos_token_id=63)
        return SDXLConfig(
            text=text,
            text_2=dataclasses.replace(text, hidden_size=16, intermediate_size=32, num_attention_heads=2,
                                       hidden_act="gelu", projection_dim=16),
            unet=UNetConfig(sample_size=8, block_out_channels=(32, 64, 64), cross_attention_dim=48,
                            attention_head_dim=(2, 2, 4), norm_num_groups=8, transformer_layers_per_block=(1, 1, 2),
                            addition_time_embed_dim=8, projection_class_embeddings_input_dim=64),
            vae=VAEConfig(block_out_channels=(16, 16, 32, 32), norm_num_groups=8))
    return SDXLConfig(text=TextConfig(**config["text_encoder"]), text_2=TextConfig(**config["text_encoder_2"]),
                      unet=UNetConfig(**_tuples(config["unet"])), vae=VAEConfig(**_tuples(config["vae"])))


def text_shape(config: dict) -> tuple[int, int]:
    t = ref_config(config).text
    return t.vocab_size, t.max_position_embeddings


class Weights:
    """The seeded weights of the four models, named as both sides name them
    (the reference's modules on the `meta` device), made on `device` in
    `dtype` when asked for; the UNet-attention LoRA in fp32."""

    def __init__(self, config: dict, seed: int, device, dtype: torch.dtype):
        from benchmark.reference.sdxl import RefSDXL

        self.config, self.seed, self.device, self.dtype = config, seed, device, dtype
        with torch.device("meta"):
            self.sd = RefSDXL(ref_config(config), "meta")

    def model(self, name: str) -> dict[str, torch.Tensor]:
        return wlib.seeded_weights(self.sd.models()[name], self.seed, name, self.device, self.dtype)

    def adapters(self) -> dict:
        if self.config["lora"]["target"] != "unet":
            raise ValueError("the SDXL cells take the UNet-attention LoRA")
        tree = wlib.lora_tree(self.sd.unet, wlib.LORA_TARGETS["unet"], self.config["lora"]["rank"], self.seed,
                              "lora/unet", self.device)
        return {"unet_lora": tree}


def program_sd(config: dict, w: Weights, device):
    """The program's SDXL pipeline with the seeded weights; its
    architecture is checked against the configuration file."""
    from fairdiff_torch.sampling import pipeline

    arch = pipeline.SDConfig.tiny_xl() if config["sd"] == "tiny" else pipeline.SDConfig.sdxl()
    if config["sd"] != "tiny":
        for key, ours in (("text_encoder", arch.text), ("text_encoder_2", arch.text_2), ("unet", arch.unet),
                          ("vae", arch.vae)):
            theirs = _tuples(config[key])
            mine = {k: v for k, v in dataclasses.asdict(ours).items() if k in theirs}
            if mine != theirs:
                raise ValueError(f"the program's SDXL {key} is not the configuration's")
    sd = pipeline.StableDiffusion(arch, device=str(device), remat=config["remat"], flash_bwd=config["flash_bwd"])
    for name, module in sd.models().items():
        wlib.load_weights(module, w.model(name))
    return sd


def reference_images(ctx, batches: list[dict], picks: list[tuple[int, int]], fp8: bool = False) -> list[np.ndarray]:
    """The reference's images of `picks` ((batch position, image position))."""
    from benchmark.reference import lowp
    from benchmark.reference.sdxl import RefSDXL

    config, mix, dev = ctx.cell["config"], ctx.cell["traffic"], ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    w = Weights(config, ctx.seed, dev, ctx.dtype)
    with torch.device(dev):
        sd = RefSDXL(ref_config(config), dev)
    for name, module in sd.models().items():
        wlib.load_weights(module, w.model(name))
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


def control_gap(ctx, n_batches: int = 5) -> float:
    """The control's number: the widest relative L2 distance of the fp8
    reference's images from the fp32 reference's, over the sample a window
    of `n_batches` batches would draw."""
    feed = traffic_lib.gen_batches(ctx.cell["traffic"], ctx.seed, *text_shape(ctx.cell["config"]))
    batches = [b for b, _ in zip(feed, range(n_batches + 1))][1:]  # the first batch is set-up's
    picks = pick(ctx.seed, len(batches), ctx.cell["traffic"]["batch"], ctx.cell["traffic"]["reference_images"])
    ref = reference_images(ctx, batches, picks)
    low = reference_images(ctx, batches, picks, fp8=True)
    return max(rel_l2(a, b) for a, b in zip(low, ref))


def descendants(pid: int) -> set[int]:
    """The processes below `pid` (children, theirs, ...), read from /proc."""
    below: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except OSError:  # it ended meanwhile
            continue
        below.setdefault(int(stat.rsplit(")", 1)[1].split()[1]), []).append(int(entry))
    found, todo = set(), [pid]
    while todo:
        for child in below.get(todo.pop(), []):
            found.add(child)
            todo.append(child)
    return found


def exit_alone(code: int) -> None:
    """Exit at once with `code`, leaving no process behind. The kernels'
    background build (compilers and their own children) is killed first: this
    process becomes the subreaper of its descendants, so that one whose parent
    is killed comes back here instead of leaving, and it kills and reaps them
    until none is left. A raise would wait for that build instead, and a bare
    exit would leave it running. Where /proc numbers processes otherwise than
    this process does (another pid namespace), nothing is killed: the exit
    waits for the build."""
    if os.readlink("/proc/self") != str(os.getpid()):
        for t in threading.enumerate():
            if t is not threading.current_thread() and not t.daemon:
                t.join()
    else:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
        deadline = time.perf_counter() + 10
        while (left := descendants(os.getpid())) and time.perf_counter() < deadline:
            for p in left:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(p, signal.SIGKILL)
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0]:
                    pass
            time.sleep(0.02)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def run(ctx) -> dict:
    config, mix, dev, spans = ctx.cell["config"], ctx.cell["traffic"], ctx.device, ctx.spans
    from fairdiff_torch.sampling import pipeline

    if not hasattr(pipeline.SDConfig, "sdxl"):
        print("[gen_sdxl] this program has no SDConfig.sdxl: it cannot run an SDXL cell", file=sys.stderr)
        exit_alone(1)
    with spans.span("build"):
        w = Weights(config, ctx.seed, dev, ctx.dtype)
        sd = program_sd(config, w, dev)
        adapters = w.adapters()
        del w
    from fairdiff_torch.io.images import save_image
    from fairdiff_torch.utils.rng import prompt_noise_generator

    out_dir = Path(tempfile.mkdtemp(prefix="gen-sdxl-", dir=os.environ.get("TMPDIR")))
    try:
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

        feed = traffic_lib.gen_batches(mix, ctx.seed, *text_shape(config))
        with spans.span("warmup"):
            one_batch(next(feed))
        ctx.sync()
        setup_s = time.perf_counter() - ctx.t_start
        print(f"[gen_sdxl] set-up {setup_s:.1f} s: models {spans.total_s('build'):.1f} s, first batch "
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
        print(f"[gen_sdxl] reference of {len(picks)} images in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
        gaps = [rel_l2(images[b][i], r) for (b, i), r in zip(picks, ref)]
        bad_files = sum(not whole_jpeg(f) for f in files)
        print(f"[gen_sdxl] sample {picks}: rel L2 {['%.4g' % g for g in gaps]}; {bad_files} of {len(files)} files "
              f"not whole JPEGs", file=sys.stderr)
        ok, checks = compare.judge({"image_rel_l2": max(gaps)}, ctx.cell["limits"])
        work = [{"images": len(b["images"]), "n_steps": mix["denoising_steps"]} for b in batches]
        record = RunRecord("gen_sdxl", config, mix, window_s, work, spans, (t0_ns, t1_ns), peak,
                           TraceResult(tracer.read(), t0_ns, t1_ns, spans.items) if ctx.trace else None)
        return {
            "correct": ok and bad_files == 0, "checks": checks, "attempted": written, "failed": bad_files,
            "end_to_end": {"gen_img_per_s": written / window_s, "setup_s": setup_s},
            "record": record,
        }
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
