// Fused GroupNorm (+ SiLU) for Hopper, sm_90a (K7).
//
// Replaces: fairdiff/ops/group_norm.py `_gn_forward` (Pallas body
// `_gn_silu_kernel`). Computes, for x [B, rows, C] channel-last (rows = the
// product of the spatial dims) and groups of C / groups neighbouring
// channels, per (sample, group): fp32 sum s and sum of squares ss over
// rows x channels, mean = s / n, var = max(ss / n - mean^2, 0),
// inv = rsqrt(var + eps); then y = x * w + b with w = scale * inv and
// b = bias - mean * w per channel, SiLU where asked, written in x's type.
// The same formula as the TPU kernel (not Welford), so the plain version
// and this kernel differ only in summation order.
//
// What bounds it on this card: one read and one write of x (plus a second
// read in the normalising pass, from L2 where it fits): bytes, at ~2
// operations a byte. On the TPU one grid step held a whole sample in VMEM;
// here a sample is cut into row chunks so that the card has ~2 blocks an SM:
//   1. gn_stats: one block per (row chunk, sample), one thread per channel
//      (threads stride over C), rows read coalesced full C wide; writes the
//      chunk's per-channel fp32 sum and sum of squares;
//   2. gn_finalize: one warp per (sample, group) sums the chunks' channel
//      partials of its group in a fixed order (deterministic, no atomics)
//      into mean and inv;
//   3. gn_apply: the same row chunks again, one thread per channel, each
//      computing its channel's w and b once, then normalise, SiLU, write.
// No applicability rule of the TPU kernel carries over (3 MB block cap,
// rows >= 1024): every shape with C % groups == 0 runs.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// part [B, n_chunks, C, 2]: the chunk's per-channel sum and sum of squares
template <typename T>
__global__ void __launch_bounds__(NT)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int rows, int C,
                    int rows_per_chunk, int n_chunks) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const T* xb = x + (long)b * rows * C;
  float* pb = part + ((long)b * n_chunks + chunk) * C * 2;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.0f, ss = 0.0f;
    #pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float v = to_f32(xb[(long)r * C + c]);
      s += v;
      ss = fmaf(v, v, ss);
    }
    pb[2 * c] = s;
    pb[2 * c + 1] = ss;
  }
}

// stats [B, groups, 2] = (mean, inv) from the partials; one warp a group
__global__ void __launch_bounds__(NT)
    gn_finalize_kernel(const float* __restrict__ part, float* __restrict__ stats, int rows, int C,
                       int groups, int n_chunks, float eps) {
  const int b = blockIdx.x;
  const int g = blockIdx.y * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (g >= groups) return;
  const int cg = C / groups;
  const int n = n_chunks * cg;
  float s = 0.0f, ss = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const long idx = ((long)b * n_chunks + i / cg) * C + g * cg + i % cg;
    s += part[2 * idx];
    ss += part[2 * idx + 1];
  }
  #pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) {
    const float cnt = (float)rows * (float)cg;
    const float mean = s / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.0f);
    stats[2 * ((long)b * groups + g)] = mean;
    stats[2 * ((long)b * groups + g) + 1] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ stats,
                    T* __restrict__ out, int rows, int C, int groups, int rows_per_chunk,
                    bool silu) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const long base = (long)b * rows * C;
  const int cg = C / groups;
  for (int c = threadIdx.x; c < C; c += NT) {
    const float* st = stats + 2 * ((long)b * groups + c / cg);
    const float w = scale[c] * st[1];
    const float bb = bias[c] - st[0] * w;
    #pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const long off = base + (long)r * C + c;
      float y = fmaf(to_f32(x[off]), w, bb);
      if (silu) y = y / (1.0f + expf(-y));
      store(out + off, y);
    }
  }
}

template <typename T>
int group_norm(const void* x, const void* scale, const void* bias, void* out, void* part,
               void* stats, int B, int rows, int C, int groups, int rows_per_chunk, int n_chunks,
               int silu, float eps, void* stream) {
  if (B < 1 || rows < 1 || C < 1 || groups < 1 || C % groups != 0 || B > 65535 ||
      rows_per_chunk < 1 || n_chunks < 1 || n_chunks > 65535 ||
      (long)rows_per_chunk * (n_chunks - 1) >= rows || (long)rows_per_chunk * n_chunks < rows)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const T*>(x);
  auto* pp = static_cast<float*>(part);
  auto* ss = static_cast<float*>(stats);
  gn_stats_kernel<T><<<dim3(n_chunks, B), NT, 0, st>>>(xx, pp, rows, C, rows_per_chunk, n_chunks);
  if (int err = (int)cudaGetLastError()) return err;
  gn_finalize_kernel<<<dim3(B, (groups + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      pp, ss, rows, C, groups, n_chunks, eps);
  if (int err = (int)cudaGetLastError()) return err;
  gn_apply_kernel<T><<<dim3(n_chunks, B), NT, 0, st>>>(
      xx, static_cast<const float*>(scale), static_cast<const float*>(bias), ss,
      static_cast<T*>(out), rows, C, groups, rows_per_chunk, silu != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, rows, C] (bf16 or fp32); scale, bias [C] fp32; part
// [B, n_chunks, C, 2] and stats [B, groups, 2] fp32 scratch
extern "C" int fd_group_norm_bf16(const void* x, const void* scale, const void* bias, void* out,
                                  void* part, void* stats, int B, int rows, int C, int groups,
                                  int rows_per_chunk, int n_chunks, int silu, float eps,
                                  void* stream) {
  return group_norm<bf16>(x, scale, bias, out, part, stats, B, rows, C, groups, rows_per_chunk,
                          n_chunks, silu, eps, stream);
}

extern "C" int fd_group_norm_f32(const void* x, const void* scale, const void* bias, void* out,
                                 void* part, void* stats, int B, int rows, int C, int groups,
                                 int rows_per_chunk, int n_chunks, int silu, float eps,
                                 void* stream) {
  return group_norm<float>(x, scale, bias, out, part, stats, B, rows, C, groups, rows_per_chunk,
                           n_chunks, silu, eps, stream);
}
