"""fairdiff_torch's profiling tools against the JAX package's:
`summarize_trace` (a port of tests/test_trace_summary.py on CUDA-trace
events), `_bucket` on XLA and CUDA kernel names, `tree_fingerprint`, and
`train_debias --profile_steps`."""

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.utils import profiling as jax_profiling
from fairdiff.utils import trace_summary as jax_trace_summary
from fairdiff_torch.io.adapters_io import load_adapters
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
    flat = lambda t, p=(): [x for k in sorted(t) for x in (flat(t[k], p + (k,)) if isinstance(t[k], dict)
                                                             else [(p + (k,), t[k])])]
    for (pa, a), (pb, b) in zip(flat(runs["plain"]), flat(runs["profiled"]), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_cli_main_prints_usage_without_a_directory(capsys):
    with pytest.raises(SystemExit):
        trace_summary.main([])
    assert "Usage" in capsys.readouterr().out
