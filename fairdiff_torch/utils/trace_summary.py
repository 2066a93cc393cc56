"""Summarise a `torch.profiler` Chrome trace without tensorboard
(counterpart of fairdiff/utils/trace_summary.py).

Parses the newest `*.trace.json.gz` under a directory (what
`utils.profiling.trace_to` writes) and sums the device time of the CUDA
trace's events (`"cat"` of `"kernel"`, `"gpu_memcpy"` or `"gpu_memset"`) by
kernel name and by bucket. Host events (`cpu_op`, `cuda_runtime`, ...) do
not count.

Usage:
    python -m fairdiff_torch.utils.trace_summary outputs/debias/trace [--top 30]

or programmatically:
    from fairdiff_torch.utils.trace_summary import summarize_trace
    rows = summarize_trace("outputs/debias/trace")
"""

from __future__ import annotations

import collections
import gzip
import json
import re
import sys
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _latest_trace_file(log_dir: str | Path) -> Path:
    files = sorted(Path(log_dir).rglob("*.trace.json.gz"), key=lambda p: p.stat().st_mtime)
    if not files:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    return files[-1]


# the port's CUDA kernels (csrc/*.cu, demangled as CUPTI records them) and
# the cuBLAS, cuDNN and PyTorch kernels, onto the JAX package's labels; every
# pattern needs a CUDA-only token ("::", a library prefix), so no XLA op name
# reaches them and the JAX rules below bucket XLA names as the JAX package does
_CUDA_RES = [
    ("flash-fwd", re.compile(r"qb::flash_fwd_kernel|flash_fwd_f32_kernel")),
    ("flash-dq", re.compile(r"qb::flash_dq_kernel|flash_dq_f32_kernel")),
    ("flash-dkv", re.compile(r"kv::flash_bwd_kv_kernel<[^<>]*\bfalse>|flash_dkv_f32_kernel")),
    ("flash-merged", re.compile(r"kv::flash_bwd_kv_kernel<[^<>]*\btrue>|flash_bwd_merged_f32_kernel")),
    ("geglu", re.compile(r"k4::fwd_kernel|gm::(gemm|dx_reduce)_kernel|geglu_(fwd|dx)_f32_kernel")),
    ("group-norm", re.compile(r"gn_cluster_kernel")),
    ("copy/transpose", re.compile(r"^Memcpy|^Memset|nchwToNhwc|nhwcToNchw|at::native::.*(copy|transpose|CatArray)",
                                  re.I)),
    ("conv", re.compile(r"fprop|dgrad|wgrad|convolve|cudnn|conv2d", re.I)),
    ("matmul", re.compile(r"gemm|gemv|nvjet|xmma|cublas|cutlass", re.I)),
    ("reduce", re.compile(r"at::native::.*reduce_kernel")),
    ("elementwise", re.compile(r"at::native::.*elementwise")),
    ("aten", re.compile(r"at::native::")),
]

# the JAX package's rules, as they are
_BUCKET_RES = [
    ("conv", re.compile(r"^%?(convolution|conv)")),
    ("matmul", re.compile(r"^%?(dot|cublas|gemm)")),
    ("flash-dq", re.compile(r"bwd_dq", re.I)),
    ("flash-dkv", re.compile(r"bwd_dkv", re.I)),
    ("flash-merged", re.compile(r"bwd_merged", re.I)),
    ("flash-fwd", re.compile(r"flash_kernel", re.I)),
    ("geglu", re.compile(r"geglu|_dx_kernel", re.I)),
    ("attention-pallas", re.compile(r"flash|attn", re.I)),
    ("pallas", re.compile(r"custom-call|tpu_custom_call", re.I)),
    ("reduce", re.compile(r"^%?(reduce|convert_reduce)|_reduce_fusion")),
    ("fusion", re.compile(r"fusion")),
    ("copy/transpose", re.compile(r"^%?(copy|transpose|bitcast|reshape)")),
    ("collective", re.compile(r"all-reduce|all-gather|reduce-scatter|psum")),
]


def _bucket(name: str) -> str:
    for label, rx in _CUDA_RES + _BUCKET_RES:
        if rx.search(name):
            return label
    return "other"


def summarize_trace(log_dir: str | Path, top: int = 30) -> dict[str, object]:
    """Aggregate device time from the newest trace under `log_dir`.

    Returns {"trace_file", "total_s", "by_bucket": {bucket: s}, "top_ops":
    [(name, s, count)]}. Only the CUDA trace's device events count, each by
    its self time."""
    path = _latest_trace_file(log_dir)
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])

    # self time: events of one stream may nest (a range around the kernels
    # it holds); subtract each event's children so none counts twice. Stack
    # sweep over the start-sorted events of each (device, stream)
    per_tid: dict[tuple, list] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        per_tid[(e.get("pid"), e.get("tid"))].append((e.get("ts", 0), e.get("dur", 0), e.get("name", "?")))

    per_op: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for rows in per_tid.values():
        rows.sort(key=lambda r: (r[0], -r[1]))
        stack: list[list] = []  # [end_ts, name, dur_us, child_us]

        def finalize(entry):
            _, name, dur_us, child_us = entry
            per_op[name][0] += max(dur_us - child_us, 0) / 1e6
            per_op[name][1] += 1

        for ts, dur, name in rows:
            while stack and ts >= stack[-1][0]:
                done = stack.pop()
                finalize(done)
                if stack:
                    stack[-1][3] += done[2]
            stack.append([ts + dur, name, dur, 0.0])
        while stack:
            done = stack.pop()
            finalize(done)
            if stack:
                stack[-1][3] += done[2]

    by_bucket: dict[str, float] = collections.defaultdict(float)
    for name, (sec, _) in per_op.items():
        by_bucket[_bucket(name)] += sec
    top_ops = sorted(((n, s, c) for n, (s, c) in per_op.items()), key=lambda r: -r[1])[:top]
    return {
        "trace_file": str(path),
        "total_s": sum(s for s, _ in per_op.values()),
        "by_bucket": dict(sorted(by_bucket.items(), key=lambda kv: -kv[1])),
        "top_ops": top_ops,
    }


def launches_by_bucket(summary: dict[str, object]) -> dict[str, int]:
    """Device events a bucket, from a summary whose `top_ops` hold every
    name (`summarize_trace(..., top=<at least the number of names>)`)."""
    out: dict[str, int] = collections.defaultdict(int)
    for name, _, count in summary["top_ops"]:
        out[_bucket(name)] += count
    return dict(out)


def main(argv: list[str]) -> None:
    if not argv or argv[0].startswith("-"):
        print(__doc__)
        raise SystemExit(2)
    top = 30
    if "--top" in argv:
        top = int(argv[argv.index("--top") + 1])
    s = summarize_trace(argv[0], top=top)
    print(f"# {s['trace_file']}")
    print(f"device total: {s['total_s']:.3f} s")
    print("\nby bucket:")
    for k, v in s["by_bucket"].items():
        print(f"  {k:>18}: {v:8.3f} s  ({100 * v / max(s['total_s'], 1e-9):.1f}%)")
    print(f"\ntop {top} ops:")
    for name, sec, count in s["top_ops"]:
        print(f"  {sec:8.3f} s  x{count:<6} {name[:100]}")


if __name__ == "__main__":
    main(sys.argv[1:])
