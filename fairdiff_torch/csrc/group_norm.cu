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
// What bounds it on this card: one read and one write of x, at ~2
// operations a byte: bytes. On the TPU one grid step held a whole sample in
// VMEM; here a sample is shared out over a thread-block cluster, and the
// design spends one launch and keeps every partial on chip:
// - One cluster per sample, of up to 16 CTAs (the non-portable size; the
//   wrapper's `row_chunks` picks 8 at batch 8, which measured faster than
//   16, 4 and 2), each owning a slice of the sample's rows.
// - A thread owns 8 neighbouring channels (one 16-byte load in bf16, two in
//   fp32) of every RL-th row of the slice, the block's RL row lanes side by
//   side, and issues eight rows' loads (four in fp32) before it sums any, so
//   128 bytes a thread are in flight. It keeps per-channel fp32 sums and
//   sums of squares in registers, then in shared memory; the block sums them
//   per group, in a fixed order.
// - The cluster sums the CTAs' group partials through distributed shared
//   memory, every CTA reading all of them in rank order, between two
//   cluster barriers: no atomics and no partials in device memory, so every
//   CTA holds the same mean and inv and two runs are bit-equal.
// - Each CTA then normalises its slice, re-reading it in reverse row order
//   so that the rows it read last come from L2 (x at batch 8 x 4096 x 960
//   is 63 MB, more than the 50 MB L2), and writes it.
// - Where C % 8 != 0 or x or out is not 16-byte aligned, the same kernel
//   loads and stores channel by channel.
// No applicability rule of the TPU kernel carries over (3 MB block cap,
// rows >= 1024): every shape with C % groups == 0 runs.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;
// rows in flight a thread: 8 in bf16 and 4 in fp32, 32 registers of loads
template <typename T>
constexpr int UNROLL = sizeof(T) == 2 ? 8 : 4;

// SiLU with the SFU's exponential and division (a few ulp of fp32, far below
// the output's bf16 rounding); y -> -inf gives 0
__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.0f + __expf(-y)); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// channels c0 .. c0 + 7 of one row as loaded (n valid of them): one 16-byte
// vector in bf16, two in fp32; `vec` false loads them one by one
template <typename T>
struct Row8;
template <>
struct Row8<bf16> {
  uint4 u;
};
template <>
struct Row8<float> {
  float4 a, b;
};

__device__ __forceinline__ void load8(const bf16* p, Row8<bf16>& r, bool vec, int n) {
  if (vec) {
    r.u = __ldg(reinterpret_cast<const uint4*>(p));
    return;
  }
  const auto* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (2 * i < n ? h[2 * i] : 0u) | ((2 * i + 1 < n ? (uint32_t)h[2 * i + 1] : 0u) << 16);
  r.u = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void load8(const float* p, Row8<float>& r, bool vec, int n) {
  if (vec) {
    r.a = __ldg(reinterpret_cast<const float4*>(p));
    r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return;
  }
  float v[8];
  #pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < n ? p[i] : 0.0f;
  r.a = make_float4(v[0], v[1], v[2], v[3]);
  r.b = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void unpack(const Row8<bf16>& r, float (&v)[8]) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Row8<float>& r, float (&v)[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8], bool vec, int n) {
  if (vec) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
    #pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = fd::pack_bf16(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    #pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) store(p + i, v[i]);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8], bool vec, int n) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    #pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = v[i];
  }
}

// one cluster a sample (blockIdx.y), CTA `rank` of it owning rows
// [rank * per, min(rows, (rank + 1) * per)); the block is RL row lanes of
// CVT threads (then idle threads up to a whole warp), thread (rl, cvt)
// owning the 8-channel vectors cvt, cvt + CVT, ... of rows r0 + rl,
// r0 + rl + RL, ...
// shared memory: part [RL][C][2] (per-lane channel sums), then grp [groups][2]
// (the CTA's group sums, read by the cluster), then stats [groups][2]
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    gn_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out, int rows, int C,
                      int groups, int per, int lanes, int CVT, int apply_silu, float eps, int vec) {
  constexpr int U = UNROLL<T>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_cta = (int)cluster.num_blocks();
  const int RL = lanes;
  const int rl = threadIdx.x / CVT, cvt = threadIdx.x % CVT;
  const int ncv = rl < RL ? (C + 7) / 8 : 0, cg_ = C / groups;  // idle threads own no vector
  const int r0 = rank * per, r1 = min(rows, r0 + per);
  const T* xb = x + (long)blockIdx.y * rows * C;
  T* ob = out + (long)blockIdx.y * rows * C;
  float* part = smem;                        // [RL][C][2]
  float* grp = part + 2 * (long)RL * C;      // [groups][2]
  float* stats = grp + 2 * groups;           // [groups][2]: mean, inv

  // 1. per-channel sums of this lane's rows, U rows' loads in flight
  for (int cv = cvt; cv < ncv; cv += CVT) {
    const int c0 = 8 * cv, n = min(8, C - c0);
    float s[8], ss[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = ss[i] = 0.0f;
    int r = r0 + rl;
    for (; r + (U - 1) * RL < r1; r += U * RL) {
      Row8<T> raw[U];
      #pragma unroll
      for (int u = 0; u < U; ++u) load8(xb + (long)(r + u * RL) * C + c0, raw[u], vec, n);
      #pragma unroll
      for (int u = 0; u < U; ++u) {
        float v[8];
        unpack(raw[u], v);
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] += v[i];
          ss[i] = fmaf(v[i], v[i], ss[i]);
        }
      }
    }
    for (; r < r1; r += RL) {
      Row8<T> raw;
      float v[8];
      load8(xb + (long)r * C + c0, raw, vec, n);
      unpack(raw, v);
      #pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += v[i];
        ss[i] = fmaf(v[i], v[i], ss[i]);
      }
    }
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n) {
        part[2 * ((long)rl * C + c0 + i)] = s[i];
        part[2 * ((long)rl * C + c0 + i) + 1] = ss[i];
      }
    }
  }
  __syncthreads();

  // 2. the CTA's group sums: one warp a group, lanes over (lane, channel) in
  // a fixed order, then a fixed shuffle tree
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int g = warp; g < groups; g += n_warps) {
    float s = 0.0f, ss = 0.0f;
    for (int i = lane; i < RL * cg_; i += 32) {
      const long idx = (long)(i / cg_) * C + g * cg_ + i % cg_;
      s += part[2 * idx];
      ss += part[2 * idx + 1];
    }
    #pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      grp[2 * g] = s;
      grp[2 * g + 1] = ss;
    }
  }
  cluster.sync();  // every CTA's group sums are in its shared memory

  // 3. the sample's statistics: every CTA sums all CTAs' group sums in rank
  // order through distributed shared memory, so all hold the same values
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.0f, ss = 0.0f;
    for (int k = 0; k < n_cta; ++k) {
      const float* remote = cluster.map_shared_rank(grp, k);
      s += remote[2 * g];
      ss += remote[2 * g + 1];
    }
    const float cnt = (float)rows * (float)cg_;
    const float mean = s / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.0f);
    stats[2 * g] = mean;
    stats[2 * g + 1] = rsqrtf(var + eps);
  }
  cluster.sync();  // no CTA's shared memory is read any more; stats are visible

  // 4. normalise the slice, rows in reverse order (the last read are in L2)
  for (int cv = cvt; cv < ncv; cv += CVT) {
    const int c0 = 8 * cv, n = min(8, C - c0);
    float w[8], b[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = min(c0 + i, C - 1);  // clamped read; channels past C are not stored
      const float* st = stats + 2 * (c / cg_);
      w[i] = scale[c] * st[1];
      b[i] = bias[c] - st[0] * w[i];
    }
    const int last = r1 - 1 - rl;
    int r = last;
    for (; r - (U - 1) * RL >= r0; r -= U * RL) {
      Row8<T> raw[U];
      #pragma unroll
      for (int u = 0; u < U; ++u) load8(xb + (long)(r - u * RL) * C + c0, raw[u], vec, n);
      #pragma unroll
      for (int u = 0; u < U; ++u) {
        float v[8];
        unpack(raw[u], v);
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float y = fmaf(v[i], w[i], b[i]);
          v[i] = apply_silu ? silu(y) : y;
        }
        store8(ob + (long)(r - u * RL) * C + c0, v, vec, n);
      }
    }
    for (; r >= r0; r -= RL) {
      Row8<T> raw;
      float v[8];
      load8(xb + (long)r * C + c0, raw, vec, n);
      unpack(raw, v);
      #pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = fmaf(v[i], w[i], b[i]);
        v[i] = apply_silu ? silu(y) : y;
      }
      store8(ob + (long)r * C + c0, v, vec, n);
    }
  }
}

template <typename T>
int group_norm(const void* x, const void* scale, const void* bias, void* out, int B, int rows, int C,
               int groups, int per, int cluster, int silu, float eps, void* stream) {
  if (B < 1 || rows < 1 || C < 1 || groups < 1 || C % groups != 0 || B > 65535 || per < 1 ||
      cluster < 1 || cluster > MAX_CLUSTER || (long)per * (cluster - 1) >= rows ||
      (long)per * cluster < rows)
    return (int)cudaErrorInvalidValue;
  const int ncv = (C + 7) / 8;
  const int cvt = min(ncv, MAX_THREADS), lanes = max(1, MAX_THREADS / cvt);
  const size_t smem = sizeof(float) * (2 * (size_t)lanes * C + 4 * (size_t)groups);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = C % 8 == 0 && aligned(x) && aligned(out);
  auto kernel = gn_cluster_kernel<T>;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return err;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3((cvt * lanes + 31) / 32 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int err = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                        static_cast<const float*>(scale), static_cast<const float*>(bias),
                                        static_cast<T*>(out), rows, C, groups, per, lanes, cvt, silu, eps, vec))
    return err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, rows, C] (bf16 or fp32); scale, bias [C] fp32; each sample's
// rows cut into `cluster` slices of `per` rows (the last may be shorter)
extern "C" int fd_group_norm_bf16(const void* x, const void* scale, const void* bias, void* out, int B,
                                  int rows, int C, int groups, int per, int cluster, int silu, float eps,
                                  void* stream) {
  return group_norm<bf16>(x, scale, bias, out, B, rows, C, groups, per, cluster, silu, eps, stream);
}

extern "C" int fd_group_norm_f32(const void* x, const void* scale, const void* bias, void* out, int B,
                                 int rows, int C, int groups, int per, int cluster, int silu, float eps,
                                 void* stream) {
  return group_norm<float>(x, scale, bias, out, B, rows, C, groups, per, cluster, silu, eps, stream);
}
