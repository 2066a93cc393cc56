// Fused GEGLU forward for Hopper, sm_90a.
//
// Replaces: fairdiff/ops/geglu.py `_geglu_forward` (Pallas body `_fwd_kernel`).
//
// Computes y[M, I] = (x.Wh^T + bh) * gelu(x.Wg^T + bg) with x [M, d] and the
// feed-forward's own `proj` Linear: w [2I, d] (torch layout, rows [0, I) are
// the h half, rows [I, 2I) the gate half) and b [2I]. Both halves come from
// this kernel's own products with fp32 accumulation; the bias, the exact
// erf gelu (CUDA's erff, not the TPU kernel's A&S polynomial, which exists
// only because Mosaic has no erf) and the product run in fp32; only the
// [M, I] product is written, so the [M, 2I] projection never reaches device
// memory.
//
// What bounds it on this card: at the UNet shapes (d = 320..1280, I = 4d,
// M = 2N*64..2N*4096) it does 4*M*d*I flops against 2*(M*d + 2*I*d + M*I)
// bytes, hundreds of flops per byte, so the tensor cores bound it. The bf16
// kernel is a tiled GEMM with a fused epilogue: one block of eight warps per
// [128 x 64] output tile (each warp 32 rows x 32 columns of both halves),
// x, Wh and Wg tiles 32 deep copied with 16-byte cp.async into a two-stage
// shared-memory ring so the next stage loads while this one multiplies,
// ldmatrix + mma.sync m16n8k16 into fp32 registers, and the gelu product
// computed from those registers and stored as bf16 pairs. Edges in M and I
// are zero-filled on load and masked on store; d must be a multiple of 8
// (16-byte rows), which every SD-1.5 width is. Not yet done: wgmma/TMA.
//
// The fp32 kernel is the simple version (CUDA-core fmaf over shared-memory
// tiles, any d); it serves the full-precision parity check.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync with a cp.async double buffer
// ---------------------------------------------------------------------------

constexpr int BM = 128;       // rows of x per block
constexpr int BN = 64;        // output columns per block (of each half)
constexpr int BK = 32;        // depth per stage
constexpr int LDS = BK + 8;   // padded shared row: ldmatrix rows hit distinct banks
constexpr int NTHREADS = 256; // eight warps: 4 along M x 2 along N
constexpr int STAGE = (BM + 2 * BN) * LDS;  // bf16 elements of one stage

__global__ void __launch_bounds__(NTHREADS)
    geglu_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, bf16* __restrict__ y, int M,
                          int d, int I) {
  __shared__ __align__(128) bf16 smem[2 * STAGE];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;

  // stage s: x rows [m0, m0+128), Wh rows [n0, n0+64), Wg rows [I+n0, I+n0+64)
  const auto load_stage = [&](int s, int k0) {
    bf16* sX = smem + s * STAGE;
    bf16* sWh = sX + BM * LDS;
    bf16* sWg = sWh + BN * LDS;
    for (int idx = tid; idx < BM * (BK / 8); idx += NTHREADS) {
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < d;
      fd::cp_async16(sX + r * LDS + c, ok ? x + (long)(m0 + r) * d + k0 + c : x, ok);
    }
    for (int idx = tid; idx < BN * (BK / 8); idx += NTHREADS) {
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const bool ok = n0 + r < I && k0 + c < d;
      fd::cp_async16(sWh + r * LDS + c, ok ? w + (long)(n0 + r) * d + k0 + c : w, ok);
      fd::cp_async16(sWg + r * LDS + c, ok ? w + (long)(I + n0 + r) * d + k0 + c : w, ok);
    }
    fd::cp_async_commit();
  };

  float ch[2][4][4] = {}, cg[2][4][4] = {};  // [m16 tile][n8 tile][fragment]
  const int nk = (d + BK - 1) / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      fd::cp_async_wait<1>();  // stage kt has landed, kt + 1 may be in flight
    } else {
      fd::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sX = smem + (kt & 1) * STAGE;
    const bf16* sWh = sX + BM * LDS;
    const bf16* sWg = sWh + BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        fd::ldmatrix_x4(af[mi], sX + (wm * 32 + mi * 16 + lane % 16) * LDS + kk + (lane / 16) * 8);
#pragma unroll
      for (int nj2 = 0; nj2 < 2; ++nj2) {  // two 8-wide column tiles a load
        const int row = wn * 32 + nj2 * 16 + lane % 8 + (lane / 16) * 8;
        const int col = kk + ((lane / 8) % 2) * 8;
        uint32_t bh[4], bg[4];
        fd::ldmatrix_x4(bh, sWh + row * LDS + col);
        fd::ldmatrix_x4(bg, sWg + row * LDS + col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          fd::mma_16816(ch[mi][2 * nj2], af[mi], bh[0], bh[1]);
          fd::mma_16816(ch[mi][2 * nj2 + 1], af[mi], bh[2], bh[3]);
          fd::mma_16816(cg[mi][2 * nj2], af[mi], bg[0], bg[1]);
          fd::mma_16816(cg[mi][2 * nj2 + 1], af[mi], bg[2], bg[3]);
        }
      }
    }
    __syncthreads();  // everyone is done with stage kt before it is refilled
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int col = n0 + wn * 32 + nj * 8 + (lane % 4) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // fragment rows lane/4 and lane/4 + 8
        const int row = m0 + wm * 32 + mi * 16 + lane / 4 + half * 8;
        if (row >= M) continue;
        float out[2];
        for (int e = 0; e < 2; ++e) {
          const int n = min(col + e, I - 1);  // clamped read; masked on store
          out[e] = (ch[mi][nj][2 * half + e] + __bfloat162float(bias[n])) *
                   gelu_erf(cg[mi][nj][2 * half + e] + __bfloat162float(bias[I + n]));
        }
        bf16* dst = y + (long)row * I + col;
        if (col + 1 < I && I % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(out[0], out[1]);
        } else {
          for (int e = 0; e < 2; ++e)
            if (col + e < I) dst[e] = __float2bfloat16(out[e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the simple version
// ---------------------------------------------------------------------------

constexpr int FB = 64;        // rows and output columns per block
constexpr int FK = 32;        // depth per stage
constexpr int FLD = FK + 1;   // padded shared row
constexpr int FTHREADS = 128;

__global__ void __launch_bounds__(FTHREADS)
    geglu_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ y, int M,
                         int d, int I) {
  __shared__ float sX[FB * FLD], sWh[FB * FLD], sWg[FB * FLD];
  const int n0 = blockIdx.x * FB, m0 = blockIdx.y * FB;
  // thread (ty, tx) owns rows [4ty, 4ty + 4) and columns [8tx, 8tx + 8)
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float ah[4][8] = {}, ag[4][8] = {};
  for (int k0 = 0; k0 < d; k0 += FK) {
    for (int idx = threadIdx.x; idx < FB * FK; idx += FTHREADS) {
      const int r = idx / FK, c = idx % FK, k = k0 + c;
      sX[r * FLD + c] = (m0 + r < M && k < d) ? x[(long)(m0 + r) * d + k] : 0.0f;
      const bool ok = n0 + r < I && k < d;
      sWh[r * FLD + c] = ok ? w[(long)(n0 + r) * d + k] : 0.0f;
      sWg[r * FLD + c] = ok ? w[(long)(I + n0 + r) * d + k] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < FK; ++kk) {
      for (int i = 0; i < 4; ++i) {
        const float a = sX[(4 * ty + i) * FLD + kk];
        for (int j = 0; j < 8; ++j) {
          ah[i][j] = fmaf(a, sWh[(8 * tx + j) * FLD + kk], ah[i][j]);
          ag[i][j] = fmaf(a, sWg[(8 * tx + j) * FLD + kk], ag[i][j]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + 4 * ty + i, n = n0 + 8 * tx + j;
      if (m < M && n < I) y[(long)m * I + n] = (ah[i][j] + bias[n]) * gelu_erf(ag[i][j] + bias[I + n]);
    }
  }
}

bool bad_shape(int M, int d, int I) { return M < 1 || d < 1 || I < 1; }

}  // namespace

extern "C" int fd_geglu_fwd_bf16(const void* x, const void* w, const void* b, void* y,
                                 int M, int d, int I, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (bad_shape(M, d, I) || d % 8 != 0 || !aligned(x) || !aligned(w) ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((I + BN - 1) / BN, (M + BM - 1) / BM);
  geglu_fwd_bf16_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), M, d, I);
  return (int)cudaGetLastError();
}

extern "C" int fd_geglu_fwd_f32(const void* x, const void* w, const void* b, void* y,
                                int M, int d, int I, void* stream) {
  if (bad_shape(M, d, I) || (M + FB - 1) / FB > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((I + FB - 1) / FB, (M + FB - 1) / FB);
  geglu_fwd_f32_kernel<<<grid, FTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), M, d, I);
  return (int)cudaGetLastError();
}
