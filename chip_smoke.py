#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (fairdiff_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: name, power limit, TF32 off for matmuls and convolutions;
  2. build: both CUDA kernels from fairdiff_torch/csrc with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     the shapes the SD-1.5 path gives it (CFG batch of N=2 images), both
     against an fp32 reference, with a dropped-tile control, and with
     kernel, plain and library times and the datasheet bound;
  4. one full-width SD-1.5 UNet forward in fp32 on the card (kernels)
     against the same weights and inputs on the CPU (plain versions), then
     the same forward in bf16 on the card, kernels against the plain routes;
  5. the slice: `fairdiff_torch.tools.gen_images.main` at full width on
     random weights, 2 prompts x 2 images, batch 2, 30 steps, with the
     kernel launch counts checked against 10 (flash) and 16 (GEGLU) per
     UNet call;
  6. throughput: one 50-step CFG generate at batch 4, in img/s;
  7. kernels-bwd: the training kernels K1 with lse, K2 (dq), K3 (dk/dv) and
     K5 (GEGLU dx), bf16 and fp32, each against its plain version at the
     phase-4 shapes (a pair VJP's CFG batch of 2p = 8 rows) and a ragged
     shape, with phase 3's limits and dropped-tile controls, and with
     kernel, plain and library times and the bound;
  8. unet-vjp: one full-width SD-1.5 pair VJP (8 rows, bf16, remat), every
     K2, K3 and K5 launch held against its plain version on its operands,
     the context gradient against the plain routes and an fp32 run, launch
     counts and peak memory;
  9. train: `fairdiff_torch.tools.train_debias.main` at full width for 2
     optimizer steps (4 lanes, micro-batch 2, 4 denoising steps): finite
     non-zero grads, moved adapters, logged losses, exact launch counts;
 10. train-step: one timed exp-1 step after a warm-up step (24 lanes,
     micro-batch 4, 19 denoising steps): s/step, the phase split, peak
     memory.

The line before the last is the card's name and power limit from
nvidia-smi; the one before that is the per-kernel JSON summary; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (datasheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth (datasheet)
# exponentials a second on the H100 SXM's special-function units (16 per SM
# per clock, 132 SMs, 1.83 GHz): at head dim 40 they bound flash attention
# harder than the tensor cores
PEAK_EXP = 3.9e12
N_IMAGES = 2  # CFG batch 2N = 4 in phase 3

# bf16 kernel vs its plain version on the same inputs. Both round their
# output to bf16 and round the probabilities (K1) or the projection (K4) at
# different points, so they differ by bf16 rounding noise: ~2e-3 of the
# output's scale. The limits are stated against that scale, not in absolute
# units, because K1's outputs at 4096 keys are only ~0.03 in size:
#   every element |got - ref| <= ELEM_ATOL_RMS * rms(ref) + ELEM_RTOL * |ref|;
#   the whole output ||got - ref|| / ||ref|| <= KERNEL_REL_L2_TOL;
#   against an fp32 reference on the same inputs, the kernel's rel L2 error
#   is at most ACCURACY_RATIO times the plain bf16 version's.
# A control drops the last tile (64 keys for K1, a 32-deep slice of d for
# K4) from the plain version; its rel L2 must exceed KERNEL_REL_L2_TOL, so
# the check is shown to see a kernel that skips a tile.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the largest of tensor-core operations,
    device-memory bytes and exponentials over their peak rates (ms, and which
    bound it; the exp unit counts as operations)."""
    t_ops = max(flops / PEAK_BF16_FLOPS, exps / PEAK_EXP)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def compare(got: torch.Tensor, ref: torch.Tensor, exact: torch.Tensor,
            dropped: torch.Tensor | None = None) -> dict:
    """Kernel output `got` against the plain version `ref` (same inputs and
    type), both against the fp32 reference `exact`, and the dropped-tile
    control `dropped`, where given, against `ref`. `failed` names the limits
    that broke."""
    g, r = got.float(), ref.float()
    rms = r.pow(2).mean().sqrt().item()
    diff = (g - r).abs()
    elem_use = (diff / (ELEM_ATOL_RMS * rms + ELEM_RTOL * r.abs())).max().item()
    out = dict(
        max_abs_err=diff.max().item(), ref_rms=rms, elem_use=elem_use,
        rel_l2=rel_l2(got, ref), kernel_vs_f32=rel_l2(got, exact),
        plain_vs_f32=rel_l2(ref, exact),
        control_rel_l2=None if dropped is None else rel_l2(dropped, ref),
    )
    out["failed"] = [
        name for name, ok in (
            ("finite", bool(torch.isfinite(g).all())),
            ("element", elem_use <= 1.0),
            ("rel L2", out["rel_l2"] <= KERNEL_REL_L2_TOL),
            ("accuracy", out["kernel_vs_f32"] <= ACCURACY_RATIO * out["plain_vs_f32"]),
            ("control", dropped is None or out["control_rel_l2"] > KERNEL_REL_L2_TOL),
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

    seconds = build.build()
    log(f"[build] {', '.join(build.KERNELS)} for sm_90a in {seconds:.2f} s")
    for name in build.KERNELS:
        lib = build.library_path(name)
        log_file = lib.with_name(lib.name + ".log")
        for line in log_file.read_text().splitlines() if log_file.exists() else []:
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels() -> dict[str, dict]:
    """Each kernel against its plain version at the path shapes (bf16)."""
    import torch.nn.functional as F

    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    rows: dict[str, dict] = {}
    B = 2 * N_IMAGES
    for label, qs, kvs in (
        ("self4096", (B, 4096, 8, 40), (B, 4096, 8, 40)),
        ("self1024", (B, 1024, 8, 80), (B, 1024, 8, 80)),
        ("ragged", (1, 600, 2, 40), (1, 300, 2, 40)),
    ):
        q = torch.randn(qs, generator=g, device="cuda", dtype=bf)
        k = torch.randn(kvs, generator=g, device="cuda", dtype=bf)
        v = torch.randn(kvs, generator=g, device="cuda", dtype=bf)
        got, ref = fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)
        t = kvs[1]
        last = (t - 1) // 64 * 64  # first key of the kernel's last 64-key tile
        checks = compare(
            got, ref, fa.flash_attention_plain(q.float(), k.float(), v.float()),
            fa.flash_attention_plain(q, k[:, :last].contiguous(), v[:, :last].contiguous()),
        )
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        b, s, h, d = qs
        bound_ms, bound_by = bound(
            4.0 * b * h * s * t * d, 2.0 * (2 * b * s * h * d + 2 * b * t * h * d), b * h * s * t
        )
        rows[f"flash_attention/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16", **checks,
            ms=time_ms(lambda: fa.flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            bound_ms=bound_ms, bound_by=bound_by,
        )
    for label, m, d in (
        ("d320", 2 * N_IMAGES * 4096, 320),
        ("d640", 2 * N_IMAGES * 1024, 640),
        ("d1280", 2 * N_IMAGES * 256, 1280),
        ("d1280mid", 2 * N_IMAGES * 64, 1280),
    ):
        inner = 4 * d
        x = torch.randn(m, d, generator=g, device="cuda", dtype=bf)
        w = (torch.randn(2 * inner, d, generator=g, device="cuda") * d**-0.5).to(bf)
        b_ = (torch.randn(2 * inner, generator=g, device="cuda") * 0.1).to(bf)
        got, ref = gg.geglu(x, w, b_), gg.geglu_plain(x, w, b_)
        x_drop = x.clone()
        x_drop[..., -32:] = 0  # the kernel's last 32-deep stage of d
        checks = compare(
            got, ref, gg.geglu_plain(x.float(), w.float(), b_.float()),
            gg.geglu_plain(x_drop, w, b_),
        )
        bound_ms, bound_by = bound(
            2.0 * m * d * 2 * inner, 2.0 * (m * d + 2 * inner * d + 2 * inner + m * inner)
        )
        rows[f"geglu/{label}"] = dict(
            shape=f"x[{m},{d}] w[{2 * inner},{d}] bf16", **checks,
            ms=time_ms(lambda: gg.geglu(x, w, b_)),
            plain_ms=time_ms(lambda: gg.geglu_plain(x, w, b_)),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        )
    log(f"[kernels] limits: element {ELEM_ATOL_RMS} * rms(ref) + {ELEM_RTOL} * |ref| "
        f"(elem_use = worst element's share of it), rel L2 {KERNEL_REL_L2_TOL}, kernel vs "
        f"fp32 <= {ACCURACY_RATIO} x plain vs fp32, dropped-tile control > {KERNEL_REL_L2_TOL}")
    for key, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernels] {key:22s} {r['shape']:34s} max_abs {r['max_abs_err']:.3e} "
            f"(ref rms {r['ref_rms']:.3e}, elem_use {r['elem_use']:.3f}) rel_l2 "
            f"{r['rel_l2']:.3e} | vs fp32: kernel {r['kernel_vs_f32']:.3e} plain "
            f"{r['plain_vs_f32']:.3e} | control {r['control_rel_l2']:.3e} | kernel_ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    failed = {key: r["failed"] for key, r in rows.items() if r["failed"]}
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
    f0, g0 = fa.launches, gg.launches
    with torch.no_grad():
        out_gpu = unet_gpu(lat.cuda(), t.cuda(), ctx.cuda(), mask.cuda()).cpu()
        ran = (fa.launches - f0, gg.launches - g0)
        out_cpu = unet_cpu(lat, t, ctx, mask)
    if ran != (10, 16):
        raise AssertionError(f"fp32 UNet forward launched (flash, geglu) = {ran}, want (10, 16)")
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


def unet_bf16_parity(unet_f32, inputs, exact: torch.Tensor) -> None:
    """The bf16 kernels that generation runs, inside one full-width UNet
    forward. Every launch is held against its plain version on the
    activations it was given (the limits of phase 3); the output is held
    against the plain routes on the same weights and inputs and, with them,
    against the fp32 output `exact`, beside a control whose attention drops
    the last 64-key tile."""
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    unet = copy.deepcopy(unet_f32).to(torch.bfloat16)
    per_launch: dict[str, list[dict]] = {"flash_attention": [], "geglu": []}

    def drop_last_tile(q, k, v):
        last = (k.shape[1] - 1) // 64 * 64
        return fa.flash_attention_plain(q, k[:, :last].contiguous(), v[:, :last].contiguous())

    def checked_attention(q, k, v):
        got = fa.flash_attention(q, k, v)
        per_launch["flash_attention"].append(compare(
            got, fa.flash_attention_plain(q, k, v),
            fa.flash_attention_plain(q.float(), k.float(), v.float()), drop_last_tile(q, k, v)))
        return got

    def checked_geglu(x, w, b):
        got = gg.geglu(x, w, b)
        x_drop = x.clone()
        x_drop[..., -32:] = 0
        per_launch["geglu"].append(compare(
            got, gg.geglu_plain(x, w, b), gg.geglu_plain(x.float(), w.float(), b.float()),
            gg.geglu_plain(x_drop, w, b)))
        return got

    with torch.no_grad():
        f0, g0 = fa.launches, gg.launches
        with routes(checked_attention, checked_geglu):
            kern = unet(*inputs).float().cpu()
        ran = (fa.launches - f0, gg.launches - g0)
        with routes(fa.flash_attention_plain, gg.geglu_plain):
            plain = unet(*inputs).float().cpu()
        with routes(drop_last_tile, gg.geglu_plain):
            dropped = unet(*inputs).float().cpu()
    for name, rows in per_launch.items():
        if not rows:
            continue  # the launch count check below fails
        log(f"[unet-bf16] {name}: {len(rows)} launches in the forward, each against its plain "
            f"version: worst elem_use {max(r['elem_use'] for r in rows):.3f}, worst rel_l2 "
            f"{max(r['rel_l2'] for r in rows):.3e}, worst kernel/plain error vs fp32 "
            f"{max(r['kernel_vs_f32'] / r['plain_vs_f32'] for r in rows):.3f}, weakest "
            f"dropped-tile control {min(r['control_rel_l2'] for r in rows):.3e}")
    e_kp, e_k, e_p = rel_l2(kern, plain), rel_l2(kern, exact), rel_l2(plain, exact)
    e_dp, e_d = rel_l2(dropped, plain), rel_l2(dropped, exact)
    log(f"[unet-bf16] SD-1.5 UNet batch 2 output: kernels vs plain routes rel L2 {e_kp:.3e} "
        f"(tol {UNET_BF16_REL_L2_TOL:.0e}); vs fp32: kernels {e_k:.3e}, plain {e_p:.3e} "
        f"(kernels <= {UNET_BF16_ACCURACY_RATIO} x plain); dropped-tile control: vs plain "
        f"{e_dp:.3e}, vs fp32 {e_d:.3e} (must exceed {UNET_BF16_ACCURACY_RATIO} x plain); "
        f"launches {ran}")
    failed = [f"{name} launch {i}: {r['failed']}" for name, rows in per_launch.items()
              for i, r in enumerate(rows) if r["failed"]]
    failed += [name for name, ok in (
        ("launches", ran == (10, 16)),
        ("finite", bool(torch.isfinite(kern).all())),
        ("rel L2", e_kp <= UNET_BF16_REL_L2_TOL),
        ("accuracy", e_k <= UNET_BF16_ACCURACY_RATIO * e_p),
        ("control", e_d > UNET_BF16_ACCURACY_RATIO * e_p),
    ) if not ok]
    if failed:
        raise AssertionError(f"bf16 UNet parity failed: {failed}")


def read_png(path: Path) -> bytes:
    """Pixel bytes of an 8-bit RGB PNG with unfiltered scanlines (what
    fairdiff_torch.io.images.save_png writes)."""
    data = path.read_bytes()
    pos, idat, width, height = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            width, height = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = 1 + 3 * width
    if len(raw) != stride * height or width != 512 or height != 512:
        raise AssertionError(f"{path}: {width}x{height}, {len(raw)} bytes")
    return b"".join(raw[r * stride + 1:(r + 1) * stride] for r in range(height))


def phase_slice() -> dict[str, int]:
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg
    from fairdiff_torch.tools import gen_images

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prompts = Path(tmp) / "prompts.json"
        prompts.write_text(json.dumps({"test_prompts": [
            "a photo of the face of a firefighter, a person",
            "a photo of the face of a nurse, a person",
        ]}))
        cfg = gen_images.GenImagesConfig(
            prompts_json=str(prompts), num_imgs_per_prompt=2, batch_size=2,
            save_dir=str(Path(tmp) / "out"),
        )
        fa.launches = 0
        gg.launches = 0
        t0 = time.perf_counter()
        written = gen_images.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"flash_attention": fa.launches, "geglu": gg.launches}
        expect_paths = [Path(cfg.save_dir) / f"prompt_{p}" / f"img_{j}.png" for p in (0, 1) for j in (0, 1)]
        if sorted(written) != sorted(expect_paths):
            raise AssertionError(f"wrote {written}")
        for p in expect_paths:
            pixels = read_png(p)
            if len(set(pixels)) < 2:
                raise AssertionError(f"{p} is constant")
        # one UNet call per step serves both CFG halves
        calls = 2 * cfg.num_denoising_steps  # 2 generate calls (2 prompts, batch 2)
        want = {"flash_attention": 10 * calls, "geglu": 16 * calls}
        log(f"[slice] gen_images.main: 4 PNGs at 512x512, {cfg.num_denoising_steps} steps, "
            f"{seconds:.2f} s incl. setup; launches {counts} (want {want})")
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
    return counts


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

    context, key_mask = sd.build_context(cond, uncond, noises.shape[0])
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
# phase-4 shapes: a pair VJP's CFG batch, 2p = 8 rows (exp-1 micro-batch 4)
PAIR_ROWS = 8


def _flash_bwd_checks(q, k, v, do, fwd=None, grads=None):
    """K1 with lse, K2 and K3 on one input set, each against its plain
    version; controls drop the last 64-key tile (o, dq) or the last 64-row q
    tile (dk, dv) from the plain version. `fwd` = (o, lse) and `grads` =
    (dq, dk, dv) are the kernels' outputs where the caller has them; else
    the kernels run here."""
    from fairdiff_torch.ops import flash_attention as fa

    S, T = q.shape[1], k.shape[1]
    last_k, last_q = (T - 1) // 64 * 64, (S - 1) // 64 * 64
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
    return out, (o, lse, delta)


def _geglu_dx_checks(dx, x, w, b, dy):
    """K5's output `dx` against the plain version; the control drops the
    last 64-wide n tile of I (the kernel's unit of work) from the plain
    version."""
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
    B = PAIR_ROWS
    for label, qs, kvs in (
        ("self4096", (B, 4096, 8, 40), (B, 4096, 8, 40)),
        ("self1024", (B, 1024, 8, 80), (B, 1024, 8, 80)),
        ("ragged", (1, 600, 2, 40), (1, 300, 2, 40)),
    ):
        q, do = (torch.randn(qs, generator=g, device="cuda", dtype=bf) for _ in range(2))
        k, v = (torch.randn(kvs, generator=g, device="cuda", dtype=bf) for _ in range(2))
        got, (o, lse, delta) = _flash_bwd_checks(q, k, v, do)
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
        del q32, k32, v32, do32, o32, o32p, dk32, dv32, dk32p, dv32p

        b, s, h, d = qs
        t = kvs[1]
        qkv_bytes = 2.0 * (b * s * h * d + 2 * b * t * h * d)
        flops, exps = 2.0 * b * h * s * t * d, float(b * h * s * t)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        rows[f"flash_attention_lse/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_lse(q, k, v)),
            plain_ms=time_ms(lambda: fa.flash_attention_lse_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt.detach(), kt.detach(), vt.detach())),
            **dict(zip(("bound_ms", "bound_by"), bound(2 * flops, qkv_bytes + 2.0 * b * s * h * d + 4.0 * b * h * s, exps))),
        )
        rows[f"flash_attention_dq/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, delta)),
            plain_ms=time_ms(lambda: fa.flash_attention_dq_plain(q, k, v, do, lse, delta), iters=3),
            library_ms=sdpa_bwd,  # SDPA's whole backward (dq, dk and dv)
            **dict(zip(("bound_ms", "bound_by"), bound(
                3 * flops, qkv_bytes + 2.0 * 2 * b * s * h * d + 8.0 * b * h * s, exps))),
        )
        rows[f"flash_attention_dkv/{label}"] = dict(
            shape=f"q{list(qs)} kv{list(kvs)} bf16",
            ms=time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta)),
            plain_ms=time_ms(lambda: fa.flash_attention_dkv_plain(q, k, v, do, lse, delta), iters=3),
            library_ms=sdpa_bwd,
            **dict(zip(("bound_ms", "bound_by"), bound(
                4 * flops, qkv_bytes + 2.0 * b * s * h * d + 2.0 * 2 * b * t * h * d + 8.0 * b * h * s, exps))),
        )
        del qt, kt, vt, sdpa_out
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
        checks[f"geglu_dx/{label}"] = _geglu_dx_checks(gg.geglu_dx(x, w, b_, dy), x, w, b_, dy)
        x32, w32, b32, dy32 = (t_.float() for t_ in (x, w, b_, dy))
        f32_rel[f"geglu_dx/{label}"] = rel_l2(gg.geglu_dx(x32, w32, b32, dy32), gg.geglu_dx_plain(x32, w32, b32, dy32))
        rows[f"geglu_dx/{label}"] = dict(
            shape=f"x[{m},{d}] w[{2 * inner},{d}] dy[{m},{inner}] bf16",
            ms=time_ms(lambda: gg.geglu_dx(x, w, b_, dy)),
            plain_ms=time_ms(lambda: gg.geglu_dx_plain(x, w, b_, dy)),
            library_ms=None,
            **dict(zip(("bound_ms", "bound_by"), bound(
                8.0 * m * d * inner, 2.0 * (2 * m * d + 2 * inner * d + 2 * inner + m * inner), float(m * inner)))),
        )
    log(f"[kernels-bwd] limits as [kernels]; lse max abs error <= {LSE_ATOL}; fp32 bodies vs fp32 plain "
        f"rel L2 <= {F32_REL_L2_TOL}; controls drop the last 64-key tile (o, dq), the last 64-row "
        f"q tile (dk, dv) or the last 64-wide n tile of I (GEGLU dx)")
    for key, c in checks.items():
        extra = f" lse max abs {c['lse_max_abs_err']:.3e} |" if "lse_max_abs_err" in c else ""
        log(f"[kernels-bwd] {key:18s} max_abs {c['max_abs_err']:.3e} (ref rms {c['ref_rms']:.3e}, "
            f"elem_use {c['elem_use']:.3f}) rel_l2 {c['rel_l2']:.3e} |{extra} vs fp32: kernel "
            f"{c['kernel_vs_f32']:.3e} plain {c['plain_vs_f32']:.3e} | control {c['control_rel_l2']:.3e} "
            f"| fp32 body rel L2 {f32_rel[key]:.3e}")
    for key, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernels-bwd] {key:28s} {r['shape']:44s} kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    failed = {key: c["failed"] for key, c in checks.items() if c["failed"]}
    failed.update({key: f"fp32 body rel L2 {v:.3e}" for key, v in f32_rel.items() if not v <= F32_REL_L2_TOL})
    if failed:
        raise AssertionError(f"backward kernel checks failed: {failed}")
    # the summary's max_abs_err: the kernel's worst element against its plain version
    for key, r in rows.items():
        name, label = key.split("/")
        part = {"flash_attention_lse": ["lse"], "flash_attention_dq": ["dq"],
                "flash_attention_dkv": ["dk", "dv"], "geglu_dx": ["geglu_dx"]}[name]
        r["max_abs_err"] = max(checks[f"{p_}/{label}"]["max_abs_err"] for p_ in part)
    return rows


def launch_counts() -> dict[str, int]:
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    return {"flash_attention": fa.launches, "flash_attention_lse": fa.launches_lse,
            "flash_attention_dq": fa.launches_dq, "flash_attention_dkv": fa.launches_dkv,
            "geglu": gg.launches, "geglu_dx": gg.launches_dx}


def reset_counts() -> None:
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    fa.launches = fa.launches_lse = fa.launches_dq = fa.launches_dkv = 0
    gg.launches = gg.launches_dx = 0


# Launches of one pair VJP (a single-step UNet forward and backward, remat
# on), as the code implies. SD-1.5 has 10 flash sites (self-attention at 4096
# and 1024 tokens) and 16 feed-forwards. The first transformer block's input
# does not depend on the context, so its self-attention needs no gradient:
# it runs the lse-free forward (K1) and has no K2/K3; the other 9 sites run
# K1 with lse and K2 and K3. Every feed-forward input depends on the context
# (through its own block's cross-attention), so all 16 run K4 and K5. Remat
# runs each block's forward twice (the forward, then the recompute in the
# backward), so the forward kernels count twice.
PAIR_VJP_LAUNCHES = {"flash_attention": 2, "flash_attention_lse": 18, "flash_attention_dq": 9,
                     "flash_attention_dkv": 9, "geglu": 32, "geglu_dx": 16}
# one no-grad CFG UNet call (phases 1 and 3, generation)
UNET_CALL_LAUNCHES = {"flash_attention": 10, "geglu": 16}


def phase_unet_vjp(power: str) -> dict:
    """One full-width SD-1.5 pair VJP on the card, as phase 4 runs it."""
    from fairdiff_torch.models.layers import init_weights
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
    from fairdiff_torch.ops import flash_attention as fa
    from fairdiff_torch.ops import geglu as gg

    g = torch.Generator().manual_seed(4)
    unet = init_weights(UNet2DCondition(UNetConfig.sd15(), remat=True), g).cuda().requires_grad_(False)
    p = PAIR_ROWS // 2
    x = torch.randn(p, 64, 64, 4, generator=g).cuda()
    cot = torch.randn(p, 64, 64, 4, generator=g).cuda() * 1e-2
    ctx0 = torch.randn(PAIR_ROWS, 77, 768, generator=g).cuda()
    mask = (torch.arange(77)[None] < torch.tensor([[9]] * p + [[12]] * p)).int().cuda()
    per_launch: dict[str, list[dict]] = {"flash_attention_bwd": [], "geglu_dx": []}

    def context_grad(model, dtype):
        ctx = ctx0.to(dtype).requires_grad_()
        eps2 = model(torch.cat([x, x]), 500, ctx, mask).float()
        eps_u, eps_c = eps2.chunk(2)
        (grad,) = torch.autograd.grad(((eps_u + 7.5 * (eps_c - eps_u)) * cot).sum(), ctx)
        return grad.float()

    real_bwd, real_dx = fa.flash_attention_bwd, gg.geglu_dx

    def checked_bwd(q, k, v, o, lse, do):
        got = real_bwd(q, k, v, o, lse, do)
        c, _ = _flash_bwd_checks(q, k, v, do, (o, lse), got)
        per_launch["flash_attention_bwd"].append(c)
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
    fa.flash_attention_bwd, gg.geglu_dx = checked_bwd, checked_dx
    try:
        kern2 = context_grad(unet_bf16, torch.bfloat16)
    finally:
        fa.flash_attention_bwd, gg.geglu_dx = real_bwd, real_dx

    def plain_attention(q, k, v):
        return fa.flash_attention_plain(q, k, v)

    def drop_last_tile(q, k, v):
        last = (k.shape[1] - 1) // 64 * 64
        return fa.flash_attention_plain(q, k[:, :last], v[:, :last])

    with routes(plain_attention, gg.geglu_plain):
        plain = context_grad(unet_bf16, torch.bfloat16)
        exact = context_grad(unet, torch.float32)
    with routes(drop_last_tile, gg.geglu_plain):
        dropped = context_grad(unet_bf16, torch.bfloat16)
    for name, rs in per_launch.items():
        parts = ("lse", "dq", "dk", "dv") if name == "flash_attention_bwd" else (None,)
        flat = [r[pt] if pt else r for r in rs for pt in parts]
        if flat:
            log(f"[unet-vjp] {name}: {len(rs)} launches, each against its plain version: worst elem_use "
                f"{max(r['elem_use'] for r in flat):.3f}, worst rel_l2 {max(r['rel_l2'] for r in flat):.3e}, "
                f"worst kernel/plain error vs fp32 "
                f"{max(r['kernel_vs_f32'] / r['plain_vs_f32'] for r in flat):.3f}, weakest dropped-tile "
                f"control {min(r['control_rel_l2'] for r in flat):.3e}")
    e_kp, e_k, e_p = rel_l2(kern, plain), rel_l2(kern, exact), rel_l2(plain, exact)
    e_d = rel_l2(dropped, exact)
    log(f"[unet-vjp] SD-1.5 pair VJP (8 rows, bf16, remat), d surrogate / d context: kernels vs plain "
        f"routes rel L2 {e_kp:.3e}; vs fp32: kernels {e_k:.3e}, plain {e_p:.3e} (kernels <= "
        f"{UNET_BF16_ACCURACY_RATIO} x plain); dropped-tile control vs fp32 {e_d:.3e} (ratio "
        f"{e_d / e_p:.3f}, must exceed {UNET_BF16_ACCURACY_RATIO}); kernels run twice agree: "
        f"{bool(torch.equal(kern, kern2))}")
    log(f"[unet-vjp] {seconds:.3f} s for one VJP after a warm-up, peak memory {peak_gib:.2f} GiB "
        f"above the weights; launches {ran} (want {PAIR_VJP_LAUNCHES}) on {power}")
    failed = [f"{name} launch {i} {pt}: {r[pt]['failed'] if pt else r['failed']}"
              for name, rs in per_launch.items() for i, r in enumerate(rs)
              for pt in (("lse", "dq", "dk", "dv") if name == "flash_attention_bwd" else (None,))
              if (r[pt]["failed"] if pt else r["failed"])]
    failed += [name for name, ok in (
        ("launches", ran == PAIR_VJP_LAUNCHES),
        ("checked launches", [len(per_launch["flash_attention_bwd"]), len(per_launch["geglu_dx"])] == [9, 16]),
        ("finite", bool(torch.isfinite(kern).all())),
        ("non-zero", kern.abs().max().item() > 0),
        ("deterministic", bool(torch.equal(kern, kern2))),
        ("rel L2", e_kp <= UNET_BF16_REL_L2_TOL),
        ("accuracy", e_k <= UNET_BF16_ACCURACY_RATIO * e_p),
        ("control", e_d > UNET_BF16_ACCURACY_RATIO * e_p),
    ) if not ok]
    if failed:
        raise AssertionError(f"pair VJP checks failed: {failed}")
    profile_pair_vjp(lambda: context_grad(unet_bf16, torch.bfloat16), seconds)
    return {"seconds": seconds, "peak_gib": peak_gib}


def profile_pair_vjp(run, wall_s: float) -> None:
    """Where one pair VJP's device time goes, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0.0:
        log("[unet-vjp] kernel time not measured (the profiler recorded no device time)")
        return
    log(f"[unet-vjp] profile of one pair VJP: {busy:.3f} ms kernel time, device idle share "
        f"{max(0.0, 1 - busy / (wall_s * 1e3)):.3f} against the timed run's wall")
    for e in events[:14]:
        log(f"[unet-vjp]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
            f"{100 * e.self_device_time_total / 1e3 / busy:5.1f}%  {e.key[:90]}")


def phase_train() -> dict[str, int]:
    """The slice: train_debias.main at full width for 2 optimizer steps."""
    import io

    import numpy as np

    from fairdiff_torch.io.adapters_io import load_adapters
    from fairdiff_torch.tools import train_debias
    from fairdiff_torch.utils.tree import tree_leaves

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        cfg = train_debias.TrainCLIConfig(
            max_train_steps=2, train_images_per_prompt=4, train_micro_batch=2, steps=4, output_dir=tmp,
        )
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_debias.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = launch_counts()
        lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
        for x in lines:
            log(f"[train] {json.dumps(x)}")
        saved = load_adapters(Path(tmp) / "exported" / "te_lora.npz")
        ups = [a for path, a in _npz_leaves(saved) if path[-1] == "up"]
        moved = bool(ups) and all(np.abs(a).max() > 0 for a in ups)  # `up` starts at 0
        n_leaves = len(tree_leaves(saved))
    steps, pairs = 4, 4 * (4 // 2)  # denoising steps; pair VJPs a step (steps x lane chunks)
    calls = 2 * steps  # no-grad CFG UNet calls a step (phases 1 and 3)
    want = {k: 2 * (calls * UNET_CALL_LAUNCHES.get(k, 0) + pairs * v) for k, v in PAIR_VJP_LAUNCHES.items()}
    log(f"[train] train_debias.main: SD-1.5, 2 steps x 4 lanes, micro-batch 2, 4 denoising steps, "
        f"{seconds:.2f} s incl. setup; {n_leaves} LoRA leaves saved, every `up` moved: {moved}; "
        f"launches {ran} (want {want})")
    failed = [name for name, ok in (
        ("two steps", [x["step"] for x in lines] == [1, 2]),
        ("finite grads", all(x["grads_finite"] and x["grad_norm"] > 0 for x in lines)),
        ("logged", all("face_rate" in x and np.isfinite(x.get("train_loss", np.nan)) for x in lines)),
        ("adapters moved", moved),
        ("launches", ran == want),
    ) if not ok]
    if failed:
        raise AssertionError(f"train phase failed: {failed}")
    return ran


def _npz_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _npz_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def phase_train_step(power: str) -> dict:
    """One timed exp-1 step at the preset's shape after a warm-up step."""
    from fairdiff_torch.io.tokenizer import HashTokenizer
    from fairdiff_torch.tools import train_debias

    cfg = train_debias.TrainCLIConfig(steps=19)  # 24 lanes, micro-batch 4 (the exp-1 preset)
    trainer = train_debias.build_trainer(cfg)
    ids = train_debias.tokenize_prompts(trainer.sd, HashTokenizer(), list(train_debias.DEFAULT_PROMPTS))
    state = trainer.init_state(cfg.seed)
    state, _ = trainer.train_step(state, ids[0])  # warm-up
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
    steps, lanes, p = 19, 24, 4
    want = {k: 2 * steps * UNET_CALL_LAUNCHES.get(k, 0) + steps * (lanes // p) * v
            for k, v in PAIR_VJP_LAUNCHES.items()}
    log(f"[train-step] exp-1 step, SD-1.5 bf16, 24 lanes, micro-batch 4, 19 denoising steps, synthetic "
        f"guidance: {seconds:.3f} s/step on {power}; peak memory {peak_gib:.2f} GiB; phases (s) {split}")
    log(f"[train-step] launches in the step {ran} (want {want})")
    log(f"[train-step] logs {json.dumps(logs)}")
    if not (logs["grads_finite"] and logs["grad_norm"] > 0 and logs["num_denoising_steps"] == 19
            and ran == want):
        raise AssertionError(f"train step failed: {logs}, launches {ran}")
    return {"seconds": seconds, "peak_gib": peak_gib, "split": split}


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
    rows = phase_kernels()
    log(f"[time] kernels {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_parity()
    log(f"[time] unet-fp32 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts_gen = phase_slice()
    log(f"[time] slice {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_throughput(power)
    log(f"[time] throughput {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows.update(phase_kernels_bwd())
    log(f"[time] kernels-bwd {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_unet_vjp(power)
    log(f"[time] unet-vjp {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    train_counts = phase_train()
    log(f"[time] train {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_train_step(power)
    log(f"[time] train-step {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    summary = []
    for kname, main_shape, source, replaces, launches in (
        ("flash_attention", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:190", counts_gen),
        ("geglu", "d320", "geglu", "fairdiff/ops/geglu.py:156", counts_gen),
        ("flash_attention_lse", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:190", train_counts),
        ("flash_attention_dq", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:539", train_counts),
        ("flash_attention_dkv", "self4096", "flash_attention", "fairdiff/ops/flash_attention.py:566", train_counts),
        ("geglu_dx", "d320", "geglu", "fairdiff/ops/geglu.py:179", train_counts),
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
