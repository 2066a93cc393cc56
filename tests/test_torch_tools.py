"""The port's last tools against the JAX package's, on the CPU.

- `setup_data`: the synthesized bundle equal to the JAX one file by file,
  and `check` reporting the same on both bundles;
- `plot_curves`: the series, the EMA and the backing CSV equal to JAX's;
  the PNGs decode to the panel's size and the drawn line passes through
  every data point's pixel;
- `convergence_demo`: two steps equal to the JAX demo's committed log
  (docs/convergence/metrics.jsonl) on its weights, adapters, face database
  and draws (rel 1e-4), then the port's run of 20 steps from there with
  |gender_gap| falling from its degenerate start;
- `roofline`: useful FLOPs, shapes and the report equal to JAX's (JAX's
  peak constants set to the port's H100 ones), the conv/dense inventory of
  a UNet forward equal to JAX's `layer_inventory`; the bounds the chip
  script states for the flash kernels;
- `tp_scaling`: the skip and fit rows, as tests/test_tp_scaling_cli.py
  asks of JAX, and the unet_vjp rows at model 1 and 2 (two processes);
- `bench`: `GenBench` and `build` on the tiny model; the bench tools'
  shapes equal to the JAX tools'.
fp32.
"""

from __future__ import annotations

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.tools import bench_attention as jax_bench_attention
from fairdiff.tools import bench_geglu as jax_bench_geglu
from fairdiff.tools import plot_curves as jax_plot
from fairdiff.tools import roofline as jax_roofline
from fairdiff.tools import setup_data as jax_setup
from fairdiff_torch.io.images import load_png
from fairdiff_torch.tools import bench_attention, bench_geglu, plot_curves, roofline, setup_data, tp_scaling

torch.set_num_threads(1)


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_setup_data_bundle_and_check_match_jax(tmp_path):
    jout = jax_setup.synthesize(jax_setup.SetupDataConfig(synthetic_out=str(tmp_path / "jax"), seed=3))
    tout = setup_data.synthesize(setup_data.SetupDataConfig(synthetic_out=str(tmp_path / "port"), seed=3))
    want, got = _files(jout), _files(tout)
    assert set(got) == set(want) and len(want) == 7
    for name in want:
        assert got[name] == want[name], name
    outputs = []
    for mod, root in ((jax_setup, jout), (setup_data, tout)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            missing = mod.check(mod.SetupDataConfig(data_dir=str(root)))
        outputs.append((missing, buf.getvalue().replace(str(root), "ROOT")))
    assert outputs[0] == outputs[1]
    assert "held-out test classifiers" in outputs[1][0]["eval"][0]


def test_setup_data_assets_check_names_the_ports_files(tmp_path):
    (tmp_path / "detector.npz").write_bytes(b"")
    (tmp_path / "clip_vision.pt").write_bytes(b"")
    missing = setup_data.check(setup_data.SetupDataConfig(assets_dir=str(tmp_path)))
    assert "CLIP-ViT-H state dict (clip_vision.pt)" not in missing["assets"]
    assert "DINOv2 state dict (dinov2.pt)" in missing["assets"]
    with pytest.raises(SystemExit, match="nothing to do"):
        setup_data.main(setup_data.SetupDataConfig())


def _write_jsonl(path, rows, torn=False):
    text = "".join(json.dumps(r) + "\n" for r in rows)
    path.write_text(text + ('{"step": 9, "gender_ga' if torn else ""))


@pytest.mark.parametrize("smooth", [0.0, 0.6])
def test_plot_curves_series_csv_and_pixels(tmp_path, smooth):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _write_jsonl(a, [{"step": s, "time": 1.0, "train_loss": 1.0 / (s + 1) + 0.1 * (s % 3), "gender_gap": 0.5,
                      "note": "x"} for s in range(12)], torn=True)
    # run b and the overlay lie above run a, so nothing is drawn over a's line
    _write_jsonl(b, [{"step": s, "train_loss": 3.0 + 2.0 / (s + 1)} for s in range(0, 12, 2)])
    ref = tmp_path / "ref.csv"
    ref.write_text("Step,run - val\n0,4.9\n5,bad\n10,4.3\n")
    assert plot_curves.load_jsonl_series(a) == jax_plot.load_jsonl_series(a)
    assert plot_curves.load_csv_series(ref) == jax_plot.load_csv_series(ref)
    vals = plot_curves.load_jsonl_series(a)["train_loss"][1]
    assert plot_curves.ema_smooth(vals, smooth) == jax_plot.ema_smooth(vals, smooth)

    spec = dict(runs=f"a={a},b={b}", csv=f"reference={ref}", keys="train_loss,gender_gap", smooth=smooth)
    jwritten = jax_plot.main(jax_plot.PlotConfig(save_dir=str(tmp_path / "jax"), **spec))
    twritten = plot_curves.main(plot_curves.PlotConfig(save_dir=str(tmp_path / "port"), **spec))
    assert [p.name for p in twritten] == [p.name for p in jwritten] == ["train_loss.png", "gender_gap.png"]
    for key in ("train_loss", "gender_gap"):
        assert (tmp_path / "port" / f"{key}.csv").read_bytes() == (tmp_path / "jax" / f"{key}.csv").read_bytes()

    # the panel: its size, and run a's smoothed line through each point
    img = np.round((load_png(tmp_path / "port" / "train_loss.png") + 1.0) * 127.5)
    assert img.shape == (plot_curves.HEIGHT, plot_curves.WIDTH, 3)
    series = [(*plot_curves.load_jsonl_series(p)["train_loss"], False) for p in (a, b)]
    series.append((*plot_curves.load_csv_series(ref), True))
    panel = plot_curves.render_panel(series, smooth)
    color = plot_curves._rgb(plot_curves.SERIES_COLORS[0])
    steps, raw = plot_curves.load_jsonl_series(a)["train_loss"]
    for x, y in zip(steps, plot_curves.ema_smooth(raw, smooth)):
        col, row = (int(round(v)) for v in panel.to_px(x, y))
        patch = img[row - 1:row + 2, col - 1:col + 2].reshape(-1, 3)
        assert np.abs(patch - color).sum(axis=1).min() <= 3, (x, y)
    assert np.array_equal(img, np.round(panel.pixels))


def test_plot_curves_draws_no_matplotlib(tmp_path):
    import sys

    _write_jsonl(tmp_path / "m.jsonl", [{"step": 0, "face_rate": 1.0}])
    before = set(sys.modules)
    plot_curves.main(plot_curves.PlotConfig(metrics_jsonl=str(tmp_path / "m.jsonl"), save_dir=str(tmp_path / "c")))
    assert not any(m.startswith("matplotlib") for m in set(sys.modules) - before)
    assert load_png(tmp_path / "c" / "face_rate.png").shape == (plot_curves.HEIGHT, plot_curves.WIDTH, 3)


def test_convergence_demo_matches_jax_then_converges(tmp_path):
    """The JAX demo's exp-1 run is committed (docs/convergence/metrics.jsonl,
    its default 120 steps); the port's demo on the JAX demo's weights,
    adapters, face database and draws logs its first two steps within rel
    1e-4, and over 20 steps drives |gender_gap| down from the degenerate
    start, as tests/test_trainer.py asks of JAX."""
    from pathlib import Path

    from fairdiff.sampling.pipeline import SDConfig as JSDConfig, StableDiffusion as JSD
    from fairdiff.training.debias import DebiasConfig as JDebiasConfig, DebiasTrainer as JTrainer
    from fairdiff.training.synthetic import synthetic_stack as jstack
    from fairdiff.utils import rng as jrng
    from fairdiff_torch.io.from_jax import adapters_from_jax
    from fairdiff_torch.tools import convergence_demo

    log = Path(__file__).resolve().parents[1] / "docs" / "convergence" / "metrics.jsonl"
    jlogs = [json.loads(x) for x in log.read_text().splitlines()[:2]]
    # the JAX demo's weights, adapters, face database and draws
    jsd = JSD(JSDConfig.tiny())
    params = jax.device_get(jsd.init_params(jax.random.key(0)))
    stack = jstack(("gender",))
    jtr = JTrainer(jsd, params, stack, JDebiasConfig(train_text_encoder=True, lora_rank=2))
    adapters = adapters_from_jax(jax.device_get(jtr.init_state(jax.random.key(1)).adapters))

    def draws(step):
        key = jax.random.fold_in(jax.random.key(7), step)
        noises = jax.random.normal(jrng.noise_key(key, step), jsd.latent_shape(8))
        return np.asarray(noises), jrng.sample_num_denoising_steps(key, step, 2, 2)

    cfg = convergence_demo.DemoConfig(steps=20, device="cpu", output_dir=str(tmp_path), plot=False)
    trainer, state, gap = convergence_demo.build(cfg, params=params, adapters=adapters,
                                                 db_feats=np.asarray(stack.face_db.feats))
    with contextlib.redirect_stdout(io.StringIO()):
        convergence_demo.run(cfg, trainer, state, gap, draws=draws)
    tlogs = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(tlogs) == 20 and gap == "gender_gap_abs"
    for j, t in zip(jlogs, tlogs[:2]):
        assert set(t) - {"grads_finite"} == set(j)
        for k, v in j.items():
            if k != "time":
                assert t[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    gaps = [r["gender_gap_abs"] for r in tlogs]
    fair = [r["train_loss_fair"] for r in tlogs if "train_loss_fair" in r]
    assert np.mean(gaps[:5]) >= 0.9, gaps  # the degenerate start
    assert np.mean(gaps[-10:]) <= np.mean(gaps[:5]) - 0.2, gaps
    assert np.mean(fair[-10:]) < np.mean(fair[:5]), fair


def test_roofline_flops_and_report_match_jax(tmp_path, monkeypatch):
    assert roofline.ATTN_SHAPES == jax_roofline.ATTN_SHAPES
    for _, B, S, T, H, D in roofline.ATTN_SHAPES:
        for kind in ("fwd", "dq", "dkv"):
            assert roofline.flash_flops(B, S, T, H, D, kind)[0] == jax_roofline._flash_flops(B, S, T, H, D, kind)[0]
        assert roofline.flash_flops(B, S, T, H, D, "fwd")[1] == roofline.flash_flops(B, S, T, H, -(-D // 16) * 16,
                                                                                      "fwd")[0]
    rows = []
    for name, B, S, T, H, D in roofline.ATTN_SHAPES:
        for kind, ms in (("fwd", 0.3), ("dq", 0.7), ("dkv", 1.1)):
            useful, billed = roofline.flash_flops(B, S, T, H, D, kind)
            rows.append({"shape": name, "kernel": kind, "ms": ms, "useful_tflops": useful / ms / 1e9,
                         "billed_tflops": billed / ms / 1e9, "pct_mxu_roof": 100 * billed / ms / 1e9 / 989.0,
                         "gbs": 123.4, "pct_hbm_roof": 3.7})
    (tmp_path / "flash.json").write_text(json.dumps(rows))
    prog = {"inventory": {"conv_flops": 3e12, "dense_flops": 1e12, "conv_calls": 60, "dense_calls": 200},
            "fwd": {"s_per_call": 0.05, "cost_analysis": {"flops": 1.1e13, "bytes": -1.0},
                    "bucket_s_per_call": {"conv": 0.02, "matmul": 0.01}},
            "ctx_vjp": {"s_per_call": 0.15, "cost_analysis": {"flops": 3.2e13, "bytes": -1.0},
                        "bucket_s_per_call": {"matmul": 0.05}}}
    (tmp_path / "programs.json").write_text(json.dumps(prog))
    monkeypatch.setattr(jax_roofline, "PEAK_TFLOPS", roofline.PEAK_TFLOPS)
    monkeypatch.setattr(jax_roofline, "PEAK_GBS", roofline.PEAK_GBS)
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_roofline.mode_report(str(tmp_path / "flash.json"), str(tmp_path / "programs.json"))
        got = roofline.main(roofline.RooflineConfig(mode="report", out_dir=str(tmp_path)))
    assert got == want


def test_roofline_inventory_matches_jax_layer_inventory():
    from fairdiff.models.unet2d import UNet2DCondition as JUNet, UNetConfig as JUNetConfig
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig

    jcfg = JUNetConfig.tiny()
    jnet = JUNet(jcfg)
    x = jax.ShapeDtypeStruct((2, 8, 8, 4), jnp.float32)
    t = jax.ShapeDtypeStruct((2,), jnp.int32)
    ctx = jax.ShapeDtypeStruct((2, 7, jcfg.cross_attention_dim), jnp.float32)
    params = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.zeros(x.shape), jnp.zeros(2, jnp.int32),
                                              jnp.zeros(ctx.shape)))
    want = jax_roofline.layer_inventory(lambda p, x, t, c: jnet.apply(p, x, t, c), params, x, t, ctx)
    net = UNet2DCondition(UNetConfig.tiny())
    got = roofline.layer_inventory(net, lambda: net(torch.zeros(2, 8, 8, 4), torch.zeros(2, dtype=torch.long),
                                                    torch.zeros(2, 7, jcfg.cross_attention_dim)))
    assert got == want


def test_flash_bounds_are_the_chip_scripts():
    """`flash_bound` is what chip_smoke states as each flash row's bound:
    the useful FLOPs, each input read once and each output written once
    (lse and delta [B, H, S] fp32), the exponentials, over the H100's peaks."""
    b, s, t, h, d = 4, 4096, 4096, 8, 40
    flops, qkv = 2.0 * b * h * s * t * d, 2.0 * (b * s * h * d + 2 * b * t * h * d)
    exps = float(b * h * s * t)
    assert roofline.flash_cost(b, s, t, h, d, "fwd")["bytes"] == 2.0 * (2 * b * s * h * d + 2 * b * t * h * d)
    assert roofline.flash_cost(b, s, t, h, d, "dq")["bytes"] == qkv + 2.0 * 2 * b * s * h * d + 8.0 * b * h * s
    assert roofline.flash_bound(b, s, t, h, d, "dkv") == roofline.bound(
        4 * flops, qkv + 2.0 * b * s * h * d + 2.0 * 2 * b * t * h * d + 8.0 * b * h * s, exps)
    ms, by = roofline.flash_bound(b, s, t, h, d, "fwd")
    assert by == "operations" and ms == pytest.approx(exps / roofline.PEAK_EXP * 1e3)  # D = 40: the exp unit
    assert roofline.padded_head_dim(40) == 48 and roofline.padded_head_dim(160) == 160


def test_bench_tool_shapes_match_jax():
    assert bench_attention.SHAPES == jax_bench_attention.SHAPES
    assert bench_geglu.SHAPES == jax_bench_geglu.SHAPES


def test_bench_tools_need_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench_attention.main, bench_geglu.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.main(roofline.RooflineConfig(mode="flash", out_dir=str(tmp_path)))


def test_tp_scaling_trainer_pair_rows_skip_and_fit(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = tp_scaling.main(tp_scaling.TPScalingConfig(mode="trainer_pair", tiny=True, lanes=(2, 3, 4),
                                                      device="cpu", json_out=str(out)))
    measured = [r for r in rows if "saved_gb" in r]
    skipped = [r for r in rows if "skipped" in r]
    assert [r["lanes"] for r in measured] == [2, 4]
    assert len(skipped) == 1 and skipped[0]["lanes"] == 3
    assert json.loads(out.read_text()) == rows
    # saved bytes grow with lanes; the arguments (frozen weights) barely do
    assert measured[1]["saved_gb"] > measured[0]["saved_gb"]
    assert measured[1]["arg_gb"] == pytest.approx(measured[0]["arg_gb"], rel=0.05)
    assert all(r["peak_gb"] is None and r["device"] == "cpu" for r in measured)
    fit = json.loads([x for x in capsys.readouterr().out.splitlines() if "trainer_pair_fit" in x][-1])
    assert fit["gb_per_lane"] > 0 and fit["hbm_budget_gb"] == 80.0
    assert fit["max_lanes_2chip_dp"] == 2 * fit["max_lanes_1chip"]
    assert "max_lanes_tp2_projected" not in fit


def test_tp_scaling_saved_bytes_leave_out_the_arguments():
    # a frozen linear saves its weight for the input's gradient; tanh saves
    # its output: only the output is a temporary once the weight and the
    # input are counted as arguments
    lin = torch.nn.Linear(64, 32, bias=False).requires_grad_(False)
    x = torch.randn(8, 64, requires_grad=True)
    with tp_scaling.saved_bytes() as every:
        torch.tanh(lin(x))
    with tp_scaling.saved_bytes([*lin.parameters(), x]) as temps:
        torch.tanh(lin(x))
    assert every["bytes"] == (64 * 32 + 8 * 32) * 4
    assert temps["bytes"] == 8 * 32 * 4


def test_tp_scaling_unet_vjp_over_model_axes(tmp_path):
    rows = tp_scaling.main(tp_scaling.TPScalingConfig(mode="unet_vjp", tiny=True, lanes=(2, 4), lora_rank=2,
                                                      device="cpu"))
    assert [(r["mesh"], r["rank"], r["lanes"]) for r in rows] == [
        ("data=1 model=1", 0, 2), ("data=1 model=1", 0, 4),
        ("data=1 model=2", 0, 2), ("data=1 model=2", 0, 4), ("data=1 model=2", 1, 2), ("data=1 model=2", 1, 4)]
    by = {(r["mesh"], r["rank"], r["lanes"]): r for r in rows}
    for m in ("data=1 model=1", "data=1 model=2"):
        assert by[(m, 0, 4)]["saved_gb"] > by[(m, 0, 2)]["saved_gb"]
    # each model rank holds half the attention weights
    assert by[("data=1 model=2", 0, 2)]["arg_gb"] < by[("data=1 model=1", 0, 2)]["arg_gb"]


def test_gen_bench_and_build_on_the_tiny_model(capsys):
    from fairdiff_torch import bench
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    sd, guidance, cfg = bench.build(True, device="cpu")
    assert sd.config == SDConfig.tiny() and cfg.train_images_per_prompt == 4 and cfg.lora_rank == 2
    tiny = bench.fill_tree(StableDiffusion(SDConfig.tiny(), device="cpu").init_random(0).unet)
    assert all(torch.equal(p, torch.full_like(p, 0.0 if p.dim() >= 2 else 0.02)) for p in tiny.parameters())
    ips = bench.GenBench(2, device="cpu", steps=2, sd=sd).run(n_timed=1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "gen_images_per_sec_50step_dpm" and line["value"] == ips > 0
    assert line["device"] == "cpu" and "vs_baseline" not in line
