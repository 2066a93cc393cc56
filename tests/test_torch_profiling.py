"""fairdiff_torch's profiling tools against the JAX package's:
`summarize_trace` (a port of tests/test_trace_summary.py on CUDA-trace
events), `_bucket` on XLA and CUDA kernel names, `tree_fingerprint`, and
`train_debias --profile_steps`; and the port's span recorder on the CPU:
nesting and ids, the bounded buffer, the profiler's clock, the phases as
spans, and the spans a tiny `train_step`, `generate` and `save_image`
record (its CUDA events are tested on the card, in
tests/test_torch_kernels_gpu.py)."""

import collections
import gzip
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.utils import profiling as jax_profiling
from fairdiff.utils import trace_summary as jax_trace_summary
from fairdiff_torch.adapters import lora as lora_lib
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.images import save_image, write_image
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.tools import train_debias
from fairdiff_torch.utils import profiling, trace_summary
from fairdiff_torch.utils.trace_summary import _bucket, launches_by_bucket, summarize_trace

torch.set_num_threads(1)


def _write_trace(directory, events, name="host.trace.json.gz"):
    directory.mkdir(parents=True, exist_ok=True)
    with gzip.open(directory / name, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_trace(tmp_path):
    fwd = "void (anonymous namespace)::qb::flash_fwd_kernel<48>((anonymous namespace)::qb::Maps, int)"
    events = [
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        # a range on the stream wraps its kernels: only its SELF time (0.5 s) counts
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "range", "ts": 0, "dur": 3_000_000},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": fwd, "ts": 100, "dur": 2_000_000},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "sm90_xmma_fprop_implicit_gemm_bf16",
         "ts": 2_100_000, "dur": 500_000},
        # a sibling after the range, and a copy on another stream
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": fwd, "ts": 3_100_000, "dur": 1_000_000},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 8, "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 0, "dur": 250_000},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 8, "name": "Memset (Device)", "ts": 300_000,
         "dur": 250_000},
        # host events must NOT count, nor events without a phase X
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 3, "name": fwd, "ts": 0, "dur": 9_000_000},
        {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 3, "name": "cudaLaunchKernel", "ts": 0, "dur": 5},
        {"ph": "i", "cat": "kernel", "pid": 0, "tid": 7, "name": fwd, "ts": 0},
    ]
    _write_trace(tmp_path / "run1", events)
    s = summarize_trace(tmp_path)
    # total = 3.0 (flash) + 0.5 (conv) + 0.5 (range self) + 0.5 (copies) = 4.5
    assert s["total_s"] == pytest.approx(4.5)
    assert s["by_bucket"]["flash-fwd"] == pytest.approx(3.0)
    assert s["by_bucket"]["conv"] == pytest.approx(0.5)
    assert s["by_bucket"]["other"] == pytest.approx(0.5)  # the range's self time
    assert s["by_bucket"]["copy/transpose"] == pytest.approx(0.5)
    assert s["top_ops"][0][0] == fwd and s["top_ops"][0][2] == 2
    assert set(s) == {"trace_file", "total_s", "by_bucket", "top_ops"}
    assert launches_by_bucket(summarize_trace(tmp_path, top=100)) == {
        "flash-fwd": 2, "conv": 1, "other": 1, "copy/transpose": 2}


def test_newest_trace_wins_and_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="trace.json.gz"):
        summarize_trace(tmp_path)
    ev = lambda name: [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 1, "name": name, "ts": 0, "dur": 10}]
    _write_trace(tmp_path / "a", ev("old"))
    import os
    import time

    os.utime(tmp_path / "a" / "host.trace.json.gz", (time.time() - 100, time.time() - 100))
    _write_trace(tmp_path / "b", ev("new"))
    assert summarize_trace(tmp_path)["top_ops"][0][0] == "new"


# XLA op names as the JAX package's traces name them
XLA_NAMES = [
    "fusion.123", "convolution.7", "%convolution.1", "while.1", "dot.4", "%dot.1", "dot_general.2",
    "copy.2", "copy-start.1", "transpose.3", "bitcast.1", "reshape.9", "reduce.5", "convert_reduce_fusion.2",
    "multiply_reduce_fusion", "all-reduce.1", "all-gather.3", "reduce-scatter.2", "psum", "custom-call.3",
    "tpu_custom_call.1", "_flash_kernel", "_flash_kernel_pipe", "_bwd_dq_kernel", "_bwd_dkv_kernel",
    "_bwd_merged_kernel", "_fwd_kernel", "_dx_kernel", "_gn_silu_kernel", "geglu_fwd", "attn_fusion",
    "multiply_add_fusion", "gemm_fusion", "cublas-gemm.1", "select_and_scatter.3", "broadcast.4",
    "dynamic-update-slice.5", "conditional.1", "sort.1", "exponential.2", "flash_attention.1",
]

# the port's kernels as CUPTI records them (demangled), and library kernels
CUDA_NAMES = {
    "void (anonymous namespace)::qb::flash_fwd_kernel<48>((anonymous namespace)::qb::Maps, __nv_bfloat16 const*)":
        "flash-fwd",
    "void (anonymous namespace)::qb::flash_dq_kernel<160>((anonymous namespace)::qb::Maps, float const*)":
        "flash-dq",
    "void (anonymous namespace)::kv::flash_bwd_kv_kernel<48, false>((anonymous namespace)::kv::Maps, int)":
        "flash-dkv",
    "void (anonymous namespace)::kv::flash_bwd_kv_kernel<80, true>((anonymous namespace)::kv::Maps, int)":
        "flash-merged",
    "void (anonymous namespace)::flash_fwd_f32_kernel(float const*, float const*)": "flash-fwd",
    "void (anonymous namespace)::flash_dq_f32_kernel(float const*)": "flash-dq",
    "void (anonymous namespace)::flash_dkv_f32_kernel(float const*)": "flash-dkv",
    "void (anonymous namespace)::flash_bwd_merged_f32_kernel(float const*)": "flash-merged",
    "void (anonymous namespace)::k4::fwd_kernel<64, 128>((anonymous namespace)::k4::Maps, int)": "geglu",
    "void (anonymous namespace)::gm::gemm_kernel<320, true, (anonymous namespace)::gm::DxEpi>(int)": "geglu",
    "void (anonymous namespace)::gm::dx_reduce_kernel(float const*, __nv_bfloat16*, long, int)": "geglu",
    "void (anonymous namespace)::geglu_fwd_f32_kernel(float const*)": "geglu",
    "void (anonymous namespace)::geglu_dx_f32_kernel(float const*)": "geglu",
    "void (anonymous namespace)::gn_cluster_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float const*)":
        "group-norm",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas":  # noqa: E501
        "matmul",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT": "matmul",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x64x64": "conv",
    "sm80_xmma_dgrad_implicit_gemm_indexed_wo_smem_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "conv",
    "void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true>(int)": "copy/transpose",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >(int)":  # noqa: E501
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper_t<float>, unsigned int, float, 4> >(int)":  # noqa: E501
        "reduce",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 4, 64, 64>(int)":
        "copy/transpose",
    "void at::native::(anonymous namespace)::softmax_warp_forward<float, float, float, 10, false, false>(int)":
        "aten",
    "Memcpy HtoD (Pageable -> Device)": "copy/transpose",
    "Memset (Device)": "copy/transpose",
}


@pytest.mark.parametrize("name", XLA_NAMES)
def test_bucket_agrees_with_jax_on_xla_names(name):
    assert _bucket(name) == jax_trace_summary._bucket(name)


@pytest.mark.parametrize("name,label", list(CUDA_NAMES.items()))
def test_bucket_maps_cuda_kernels(name, label):
    assert _bucket(name) == label
    # every label the port uses for its kernels is one of the JAX package's
    if label in ("flash-fwd", "flash-dq", "flash-dkv", "flash-merged", "geglu", "matmul", "conv"):
        assert label in {lab for lab, _ in jax_trace_summary._BUCKET_RES}


def test_tree_fingerprint_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"b": {"up": rng.normal(size=(3, 4)).astype(np.float32), "down": rng.normal(size=(4,)).astype(np.float32)},
            "a": [rng.normal(size=(2, 2)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]}
    to = lambda f: {"b": {k: f(v) for k, v in tree["b"].items()}, "a": [f(v) for v in tree["a"]]}
    want = jax_profiling.tree_fingerprint(to(jnp.asarray))
    got = profiling.tree_fingerprint(to(torch.from_numpy))
    assert got["first"] == want["first"]
    assert got["norm"] == pytest.approx(want["norm"], rel=1e-6)
    assert profiling.tree_fingerprint({}) == jax_profiling.tree_fingerprint({}) == {"first": 0.0, "norm": 0.0}


def test_phase_timers_stay_importable_from_the_trainer():
    from fairdiff_torch.training.debias import PhaseTimers

    assert PhaseTimers is profiling.PhaseTimers
    timers = PhaseTimers(torch.device("cpu"))
    with timers("phase1"):
        pass
    assert set(timers.last) == {"phase1"} and timers.last["phase1"] >= 0


def test_trace_to_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace_to(tmp_path / "trace", device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "") for e in events)
    s = summarize_trace(tmp_path / "trace")
    assert s["total_s"] == 0.0 and s["trace_file"] == str(path)  # no device on the CPU


def test_train_debias_profile_steps_writes_a_trace_and_the_same_adapters(tmp_path, capsys):
    runs = {}
    for name, extra in (("plain", []), ("profiled", ["--profile_steps", "1"])):
        out = tmp_path / name
        cfg = train_debias.parse_args(["--device", "cpu", "--tiny_smoke", "1", "--max_train_steps", "2",
                                       "--output_dir", str(out), *extra])
        train_debias.main(cfg)
        runs[name] = load_adapters(out / "exported" / "te_lora.npz")
    assert cfg.profile_steps == 1
    assert "trace written to" in capsys.readouterr().out
    (trace,) = (tmp_path / "profiled" / "trace").glob("*.trace.json.gz")
    assert trace.stat().st_size > 0 and not (tmp_path / "plain" / "trace").exists()
    # the program's spans appear in the trace under their names
    with gzip.open(trace, "rt") as f:
        names = collections.Counter(e.get("name") for e in json.load(f)["traceEvents"])
    assert names["train_step"] == 1 and names["pair_vjp"] == names["unet_backward"] > 0
    flat = lambda t, p=(): [x for k in sorted(t) for x in (flat(t[k], p + (k,)) if isinstance(t[k], dict)
                                                             else [(p + (k,), t[k])])]
    for (pa, a), (pb, b) in zip(flat(runs["plain"]), flat(runs["profiled"]), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_cli_main_prints_usage_without_a_directory(capsys):
    with pytest.raises(SystemExit):
        trace_summary.main([])
    assert "Usage" in capsys.readouterr().out


# -- the span recorder -------------------------------------------------------


def test_spans_nest_with_parent_and_root_ids():
    rec = profiling.SpanRecorder()
    with rec.span("a", key=7) as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
        with rec.span("d") as d:
            pass
    with rec.span("e") as e:
        pass
    spans = rec.spans()
    assert [s.name for s in spans] == ["c", "b", "d", "a", "e"]  # in the order they ended
    assert len({s.id for s in spans}) == 5
    assert (a.parent, a.root, a.key) == (None, a.id, 7)
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert b.root == c.root == d.root == a.id
    assert (e.parent, e.root, e.key) == (None, e.id, None)
    assert a.t0_ns <= b.t0_ns <= c.t0_ns <= c.t1_ns <= b.t1_ns <= d.t0_ns <= d.t1_ns <= a.t1_ns <= e.t0_ns
    # on the CPU a span's device duration is its host duration
    assert all(s.device_ns == s.t1_ns - s.t0_ns for s in spans)


def test_a_span_left_by_an_exception_is_recorded_and_each_thread_has_its_own_stack():
    rec = profiling.SpanRecorder()
    with pytest.raises(ValueError):
        with rec.span("outer") as outer:
            with rec.span("failing"):
                raise ValueError
    seen = {}

    def worker():
        with rec.span("in_thread") as t:
            seen["span"] = t

    with rec.span("main") as main:
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    by_name = {s.name: s for s in rec.spans()}
    assert by_name["failing"].parent == outer.id
    assert main.parent is None  # the failed spans left the stack
    assert seen["span"].parent is None and seen["span"].root == seen["span"].id


def test_the_span_buffer_stays_bounded():
    rec = profiling.SpanRecorder()
    n = profiling.CAPACITY + 1000
    for i in range(n):
        with rec.span("s", key=i):
            pass
    spans = rec.spans()
    assert len(spans) == profiling.CAPACITY and [s.key for s in spans] == list(range(1000, n))
    assert len(rec._pending) == 0 and rec._made == 0  # no CUDA event on the CPU


def test_module_spans_go_to_the_programs_recorder():
    with profiling.span("module_probe", key=3) as sp:
        pass
    assert profiling.recorded_spans()[-1] is sp and sp.recorder is profiling.RECORDER


def test_a_profiled_mm_lies_inside_its_span_on_the_shared_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm_probe") as sp:
            torch.mm(a, a)
    events = list(prof.profiler.kineto_results.events())
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    assert sp.t0_ns <= mm.start_ns() and mm.start_ns() + mm.duration_ns() <= sp.t1_ns
    # while the profiler runs, the span opens a record_function of its name
    assert [e.name() for e in events].count("mm_probe") == 1


def test_phase_timers_keep_their_last_times_and_record_spans():
    timers = profiling.PhaseTimers(torch.device("cpu"))
    with profiling.span("step_probe") as root:
        with timers("phase1"):
            with profiling.span("inner_probe") as inner:
                pass
        with pytest.raises(RuntimeError):
            with timers("phase2"):
                raise RuntimeError
    assert set(timers.last) == {"phase1", "phase2"} and min(timers.last.values()) >= 0
    spans = {s.name: s for s in profiling.recorded_spans() if s.root == root.id}
    assert spans["phase1"].parent == spans["phase2"].parent == root.id
    assert inner.parent == spans["phase1"].id
    assert spans["phase1"].t1_ns - spans["phase1"].t0_ns >= timers.last["phase1"] * 1e9 * 0.5


def _tree(root_id):
    spans = [s for s in profiling.recorded_spans() if s.root == root_id]
    by_id = {s.id: s for s in spans}
    parent = lambda s: by_id[s.parent].name if s.parent in by_id else None
    return spans, by_id, parent


def test_a_tiny_train_step_records_its_spans():
    cfg = train_debias.parse_args(["--device", "cpu", "--tiny_smoke", "1"])
    trainer = train_debias.build_trainer(cfg)
    state = trainer.init_state(0)
    n_text = trainer.sd.config.text.max_position_embeddings
    ids = (torch.arange(n_text)[None] % 60, torch.zeros(1, n_text, dtype=torch.long))
    state, logs = trainer.train_step(state, ids)
    root = profiling.recorded_spans()[-1]
    assert (root.name, root.key, root.parent) == ("train_step", 0, None)
    spans, by_id, parent = _tree(root.id)
    n_steps = logs["num_denoising_steps"]
    chunks = trainer.cfg.train_images_per_prompt // trainer.cfg.train_micro_batch
    named = lambda n: [s for s in spans if s.name == n]
    phases = ("phase1_sample_analyze", "phase3_frozen_sample", "phase2_targets", "phase4_backward", "update")
    assert {parent(s) for s in spans if s.name in phases} == {"train_step"}
    assert {parent(s) for s in named("phase4_loss_vjp") + named("phase4_pair_vjp")} == {"phase4_backward"}
    assert set(trainer.timers.last) == set(phases) | {"phase4_loss_vjp", "phase4_pair_vjp"}
    pairs = named("pair_vjp")
    assert len(pairs) == n_steps * chunks and {parent(s) for s in pairs} == {"phase4_pair_vjp"}
    kids = collections.Counter((s.parent, s.name) for s in spans if parent(s) == "pair_vjp")
    assert kids == {(p.id, n): 1 for p in pairs for n in ("unet_forward", "unet_backward")}
    assert [parent(s) for s in named("merge_vjp")] == ["phase4_pair_vjp"]
    assert sorted(parent(s) for s in named("encode_prompt")) == ["generate", "generate", "phase4_pair_vjp"]
    assert [parent(s) for s in named("loss_vjp")] == ["phase4_loss_vjp"] * chunks
    # the guidance analysis of phases 1 and 3 (phase 4's loss analyses its chunks too)
    analyze = [parent(s) for s in named("analyze")]
    assert sorted(a for a in analyze if a != "loss_vjp") == ["phase1_sample_analyze", "phase3_frozen_sample"]
    gens = named("generate")
    assert sorted(parent(s) for s in gens) == ["phase1_sample_analyze", "phase3_frozen_sample"]
    for g in gens:
        stages = [s for s in spans if s.parent == g.id]
        assert [s.name for s in sorted(stages, key=lambda s: s.t0_ns)] == ["encode_prompt", "denoise", "decode"]
        (denoise,) = [s for s in stages if s.name == "denoise"]
        assert [s.name for s in spans if s.parent == denoise.id] == ["unet_call"] * n_steps
    for s in spans:
        if s.parent in by_id:
            assert by_id[s.parent].t0_ns <= s.t0_ns <= s.t1_ns <= by_id[s.parent].t1_ns


def test_a_tiny_generate_and_save_image_record_their_trees(tmp_path):
    sd = StableDiffusion(SDConfig.tiny(), device="cpu").init_random(0)
    lora = lora_lib.init_lora(sd.unet, lora_lib.unet_attention_targets, 2, torch.Generator().manual_seed(1))
    n_text = sd.config.text.max_position_embeddings
    noises = torch.randn(2, *sd.latent_shape(1)[1:], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        images = sd.generate(noises, torch.arange(n_text)[None] % 60, torch.zeros(1, n_text, dtype=torch.long), 3,
                             unet_lora=lora)
    (gen,) = [s for s in profiling.recorded_spans()[-16:] if s.name == "generate"]
    assert gen.parent is None and gen.root == gen.id  # called alone, it is the root
    spans, _, parent = _tree(gen.id)
    # the two encoder calls (cond, uncond) and the UNet's 16 spatial transformers a call
    assert collections.Counter(s.name for s in spans) == {
        "generate": 1, "encode_prompt": 1, "merge_lora": 1, "denoise": 1, "unet_call": 3, "decode": 1,
        "text_encoder": 2, "transformer_stack": 3 * 16}
    inner = {"unet_call": "denoise", "text_encoder": "encode_prompt", "transformer_stack": "unet_call"}
    assert {parent(s) for s in spans if s.name not in inner} == {None, "generate"}
    for name, outer in inner.items():
        assert {parent(s) for s in spans if s.name == name} == {outer}
    save_image(images[0].numpy(), tmp_path / "img_0.jpg")
    (saved,) = [s for s in profiling.recorded_spans()[-3:] if s.name == "save_image"]
    spans, _, parent = _tree(saved.id)
    assert sorted((s.name, parent(s)) for s in spans) == [
        ("encode_jpeg", "save_image"), ("save_image", None), ("write_file", "save_image")]
    # a PNG records no JPEG stage
    before = len(profiling.recorded_spans())
    write_image(np.zeros((4, 4, 3), np.uint8), tmp_path / "x.png")
    assert len(profiling.recorded_spans()) == before


@pytest.mark.parametrize("preset, encoders, stacks", [
    ("tiny", [0, 0], {1: 16}),  # SD-1.5's topology: one layer in each of 16 stacks
    # SDXL's: none at the first level, 2 + 2 at the second and third, 1 mid, 3 + 3 up
    ("tiny_xl", [0, 1, 0, 1], {1: 5, 2: 6}),
])
def test_transformer_stack_and_text_encoder_spans_carry_their_keys(preset, encoders, stacks):
    """One "text_encoder" span an encoder call under "encode_prompt" (key:
    the encoder's index), one "transformer_stack" span a `Transformer2D`
    call under "unet_call" (key: its depth)."""
    sd = StableDiffusion(SDConfig.preset(preset), device="cpu").init_random(0)
    n_text = sd.config.text.max_position_embeddings
    eos = sd.config.text.eos_token_id
    noises = torch.randn(2, *sd.latent_shape(1)[1:], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        sd.generate(noises, torch.tensor([[0, 5, 7] + [eos] * (n_text - 3)]),
                    torch.tensor([[0] + [eos] * (n_text - 1)]), 2)
    (gen,) = [s for s in profiling.recorded_spans()[-4:] if s.name == "generate"]
    spans, by_id, parent = _tree(gen.id)
    (enc,) = [s for s in spans if s.name == "encode_prompt"]
    assert [s.key for s in sorted(spans, key=lambda s: s.t0_ns) if s.name == "text_encoder"] == encoders
    assert {s.parent for s in spans if s.name == "text_encoder"} == {enc.id}
    calls = [s for s in spans if s.name == "unet_call"]
    assert len(calls) == 2
    for call in calls:
        keys = collections.Counter(s.key for s in spans if s.name == "transformer_stack" and s.parent == call.id)
        assert keys == stacks
    assert all(s.device_ns is not None for s in spans if s.name == "transformer_stack")  # the CPU: host time
