// Fused GEGLU for Hopper, sm_90a: the forward (K4) and the input gradient
// (K5, described above its kernels below).
//
// Replaces: fairdiff/ops/geglu.py `_geglu_forward` (Pallas body `_fwd_kernel`)
// and `_geglu_dx` (Pallas body `_dx_kernel`).
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

// d gelu / d g = Phi(g) + g phi(g)
__device__ __forceinline__ float gelu_erf_grad(float g) {
  return 0.5f * (1.0f + erff(g * 0.70710678118654752f)) +
         g * 0.3989422804014327f * expf(-0.5f * g * g);
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

// ---------------------------------------------------------------------------
// GEGLU dx (K5)
// ---------------------------------------------------------------------------
//
// dx[M, d] = sum_n dh[:, n] Wh[n, :] + dg[:, n] Wg[n, :] with h = x Wh^T + bh,
// g = x Wg^T + bg recomputed per tile, dh = dy * gelu(g) and
// dg = dy * h * gelu'(g) rounded to the input type (the TPU kernel's rounding
// points), dx accumulated in fp32 and written once. dW and db are not
// computed here (the UNet's feed-forward is frozen; the wrapper computes
// them in plain PyTorch when asked).
//
// The TPU kernel carries dx in a scratch buffer across a sequential grid
// axis over n; here one block owns a tile of BM rows of x and loops over all
// 64-wide n tiles of I itself, so nothing is carried between blocks. The x
// tile [BM x d] is copied into shared memory once; for each n tile the
// block (1) computes h and g [BM x 64] with mma.sync, streaming the Wh/Wg
// rows of the tile in 64-deep chunks of d through a two-stage cp.async
// ring, (2) forms dh and dg in registers and stores them as bf16 in shared
// memory, (3) streams the same W chunks again and accumulates
// dx += dh.Wh + dg.Wg in registers: warp w owns dx columns 64c + 8w .. + 8
// of every 64-column chunk c of d. The dx accumulator is NCH * MT * 4 fp32
// registers a thread (NCH = d / 64 chunks, MT = BM / 16 row tiles), so BM
// shrinks as d grows: 64 rows at d = 320, 32 at 640, 16 at 1280.
//
// What bounds it on this card: 8*M*d*I flops (two products to recompute h
// and g, two for dx) against M*d + 2*I*d + M*I reads and M*d writes, so the
// tensor cores bound it; at BM = 16 the W tiles are re-read from L2 by every
// block, which is what this simple design pays. Not yet done: wgmma/TMA,
// larger row tiles with dx in shared memory.

constexpr int DXN = 64;         // n (I) columns per tile, also the d chunk width
constexpr int WLD = DXN + 8;    // padded shared row of a W chunk
constexpr int DX_THREADS = 256; // eight warps

template <int NCH>
__host__ __device__ constexpr int dx_mt() { return NCH <= 5 ? 4 : NCH <= 10 ? 2 : 1; }

template <int NCH>
__global__ void __launch_bounds__(DX_THREADS)
    geglu_dx_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, const bf16* __restrict__ dy,
                         bf16* __restrict__ dx, int M, int d, int I) {
  constexpr int MT = dx_mt<NCH>();
  constexpr int BMX = 16 * MT;
  constexpr int DPAD = DXN * NCH;
  constexpr int XLD = DPAD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // [BMX x XLD]
  bf16* sW = sX + BMX * XLD;                 // 2 stages x {Wh, Wg} [DXN x WLD]
  bf16* sDh = sW + 4 * DXN * WLD;            // [BMX x WLD]
  bf16* sDg = sDh + BMX * WLD;               // [BMX x WLD]

  const int m0 = blockIdx.x * BMX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // x rows [m0, m0 + BMX), all of d, zero past M and d
  for (int idx = tid; idx < BMX * (DPAD / 8); idx += DX_THREADS) {
    const int r = idx / (DPAD / 8), c = (idx % (DPAD / 8)) * 8;
    const bool ok = m0 + r < M && c < d;
    fd::cp_async16(sX + r * XLD + c, ok ? x + (long)(m0 + r) * d + c : x, ok);
  }
  fd::cp_async_commit();

  // W rows [n0, n0 + 64) of both halves, d columns [64c, 64c + 64)
  const auto load_w = [&](int stage, int n0, int c) {
    bf16* sWh = sW + stage * 2 * DXN * WLD;
    bf16* sWg = sWh + DXN * WLD;
    for (int idx = tid; idx < DXN * (DXN / 8); idx += DX_THREADS) {
      const int r = idx / (DXN / 8), col = c * DXN + (idx % (DXN / 8)) * 8;
      const bool ok = n0 + r < I && col < d;
      fd::cp_async16(sWh + r * WLD + (idx % (DXN / 8)) * 8, ok ? w + (long)(n0 + r) * d + col : w, ok);
      fd::cp_async16(sWg + r * WLD + (idx % (DXN / 8)) * 8,
                     ok ? w + (long)(I + n0 + r) * d + col : w, ok);
    }
    fd::cp_async_commit();
  };
  // wait for chunk c (c + 1 may be in flight), then barrier
  const auto next_w = [&](int n0, int c) {
    if (c + 1 < NCH) {
      load_w((c + 1) & 1, n0, c + 1);
      fd::cp_async_wait<1>();
    } else {
      fd::cp_async_wait<0>();
    }
    __syncthreads();
  };

  float dxacc[NCH][MT][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) dxacc[c][mt][0] = dxacc[c][mt][1] = dxacc[c][mt][2] = dxacc[c][mt][3] = 0.0f;
  }

  for (int n0 = 0; n0 < I; n0 += DXN) {
    // (1) h, g for this warp's 8 columns n0 + 8w .. + 8, all BMX rows
    float hacc[MT][4], gacc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[mt][e] = gacc[mt][e] = 0.0f;
    }
    load_w(0, n0, 0);
    for (int c = 0; c < NCH; ++c) {
      next_w(n0, c);
      const bf16* sWh = sW + (c & 1) * 2 * DXN * WLD;
      const bf16* sWg = sWh + DXN * WLD;
#pragma unroll
      for (int kk = 0; kk < DXN / 16; ++kk) {
        uint32_t b[4];  // Wh rows (k 0-7, 8-15), then Wg rows
        fd::ldmatrix_x4(b, (lane < 16 ? sWh : sWg) + (8 * warp + lane % 8) * WLD + kk * 16 +
                               ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          fd::ldmatrix_x4(a, sX + (mt * 16 + lane % 16) * XLD + c * DXN + kk * 16 + (lane / 16) * 8);
          fd::mma_16816(hacc[mt], a, b[0], b[1]);
          fd::mma_16816(gacc[mt], a, b[2], b[3]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    // (2) dh, dg in registers -> bf16 in shared memory
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + lane / 4 + half * 8;
        const int cl = 8 * warp + (lane % 4) * 2;
        float dh[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + cl + e;
          const bool ok = m0 + r < M && n < I;
          const int nc = min(n, I - 1);  // clamped read; dy is 0 where !ok
          const float gy = ok ? __bfloat162float(dy[(long)(m0 + r) * I + n]) : 0.0f;
          const float hh = hacc[mt][2 * half + e] + __bfloat162float(bias[nc]);
          const float gg = gacc[mt][2 * half + e] + __bfloat162float(bias[I + nc]);
          dh[e] = gy * gelu_erf(gg);
          dg[e] = gy * hh * gelu_erf_grad(gg);
        }
        *reinterpret_cast<__nv_bfloat162*>(sDh + r * WLD + cl) = __floats2bfloat162_rn(dh[0], dh[1]);
        *reinterpret_cast<__nv_bfloat162*>(sDg + r * WLD + cl) = __floats2bfloat162_rn(dg[0], dg[1]);
      }
    }
    // (3) dx += dh . Wh + dg . Wg over the d chunks (sDh/sDg are visible
    // after the barrier inside next_w)
    load_w(0, n0, 0);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      next_w(n0, c);
      const bf16* sWh = sW + (c & 1) * 2 * DXN * WLD;
      const bf16* sWg = sWh + DXN * WLD;
#pragma unroll
      for (int kk = 0; kk < DXN / 16; ++kk) {
        uint32_t b[4];  // W as [k = n rows, n = d columns 8w .. + 8], transposed load
        fd::ldmatrix_x4_trans(b, (lane < 16 ? sWh : sWg) +
                                     (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * WLD + 8 * warp);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t ah[4], ag[4];
          const int off = (mt * 16 + lane % 16) * WLD + kk * 16 + (lane / 16) * 8;
          fd::ldmatrix_x4(ah, sDh + off);
          fd::ldmatrix_x4(ag, sDg + off);
          fd::mma_16816(dxacc[c][mt], ah, b[0], b[1]);
          fd::mma_16816(dxacc[c][mt], ag, b[2], b[3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mt * 16 + lane / 4 + half * 8;
        const int col = c * DXN + 8 * warp + (lane % 4) * 2;  // d % 8 == 0: both or neither valid
        if (row < M && col < d)
          *reinterpret_cast<__nv_bfloat162*>(dx + (long)row * d + col) =
              __floats2bfloat162_rn(dxacc[c][mt][2 * half], dxacc[c][mt][2 * half + 1]);
      }
    }
  }
}

template <int NCH>
int launch_dx_bf16(const bf16* x, const bf16* w, const bf16* b, const bf16* dy, bf16* dx, int M,
                   int d, int I, cudaStream_t stream) {
  constexpr int BMX = 16 * dx_mt<NCH>();
  const size_t smem = sizeof(bf16) * (BMX * (DXN * NCH + 8) + 4 * DXN * WLD + 2 * BMX * WLD);
  if (int err = (int)cudaFuncSetAttribute(geglu_dx_bf16_kernel<NCH>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return err;
  const int blocks = (M + BMX - 1) / BMX;
  geglu_dx_bf16_kernel<NCH><<<blocks, DX_THREADS, smem, stream>>>(x, w, b, dy, dx, M, d, I);
  return (int)cudaGetLastError();
}

// fp32 dx: the simple version. One block of 256 threads per 16 rows; h, g
// and dh, dg through shared memory, dx in registers (thread t owns columns
// t, t + 256, ... of all 16 rows), CUDA-core fmaf. d <= 1280.
constexpr int FDX_ROWS = 16;
constexpr int FDX_N = 32;
constexpr int FDX_COLS = 5;  // column groups of 256: d <= 1280

__global__ void __launch_bounds__(DX_THREADS)
    geglu_dx_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ dy,
                        float* __restrict__ dx, int M, int d, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem);  // [FDX_ROWS x d]
  float* sDh = sX + FDX_ROWS * d;              // [FDX_ROWS x FDX_N]
  float* sDg = sDh + FDX_ROWS * FDX_N;         // [FDX_ROWS x FDX_N]
  const int m0 = blockIdx.x * FDX_ROWS, tid = threadIdx.x;
  for (int idx = tid; idx < FDX_ROWS * d; idx += DX_THREADS) {
    const int r = idx / d;
    sX[idx] = m0 + r < M ? x[(long)(m0 + r) * d + idx % d] : 0.0f;
  }
  float acc[FDX_COLS][FDX_ROWS] = {};
  for (int n0 = 0; n0 < I; n0 += FDX_N) {
    __syncthreads();  // sX loaded; the previous tile's dh/dg consumed
    for (int idx = tid; idx < FDX_ROWS * FDX_N; idx += DX_THREADS) {
      const int r = idx / FDX_N, n = n0 + idx % FDX_N;
      float dh = 0.0f, dg = 0.0f;
      if (n < I && m0 + r < M) {
        float h = bias[n], g = bias[I + n];
        for (int k = 0; k < d; ++k) {
          h = fmaf(sX[r * d + k], w[(long)n * d + k], h);
          g = fmaf(sX[r * d + k], w[(long)(I + n) * d + k], g);
        }
        const float gy = dy[(long)(m0 + r) * I + n];
        dh = gy * gelu_erf(g);
        dg = gy * h * gelu_erf_grad(g);
      }
      sDh[idx] = dh;
      sDg[idx] = dg;
    }
    __syncthreads();
    const int nn = min(FDX_N, I - n0);
#pragma unroll
    for (int cg = 0; cg < FDX_COLS; ++cg) {
      const int col = tid + cg * DX_THREADS;
      if (col >= d) continue;
      for (int j = 0; j < nn; ++j) {
        const float wh = w[(long)(n0 + j) * d + col], wg = w[(long)(I + n0 + j) * d + col];
#pragma unroll
        for (int r = 0; r < FDX_ROWS; ++r)
          acc[cg][r] = fmaf(sDh[r * FDX_N + j], wh, fmaf(sDg[r * FDX_N + j], wg, acc[cg][r]));
      }
    }
  }
#pragma unroll
  for (int cg = 0; cg < FDX_COLS; ++cg) {
    const int col = tid + cg * DX_THREADS;
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < FDX_ROWS; ++r)
      if (m0 + r < M) dx[(long)(m0 + r) * d + col] = acc[cg][r];
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

extern "C" int fd_geglu_dx_bf16(const void* x, const void* w, const void* b, const void* dy,
                                void* dx, int M, int d, int I, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (bad_shape(M, d, I) || d % 8 != 0 || d > 20 * DXN || !aligned(x) || !aligned(w) ||
      !aligned(dx))
    return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const bf16*>(x);
  const auto* ww = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(b);
  const auto* gy = static_cast<const bf16*>(dy);
  auto* out = static_cast<bf16*>(dx);
  auto st = static_cast<cudaStream_t>(stream);
  // d padded up to the next instantiated multiple of 64
  const int nch = (d + DXN - 1) / DXN;
  if (nch <= 1) return launch_dx_bf16<1>(xx, ww, bb, gy, out, M, d, I, st);
  if (nch <= 2) return launch_dx_bf16<2>(xx, ww, bb, gy, out, M, d, I, st);
  if (nch <= 4) return launch_dx_bf16<4>(xx, ww, bb, gy, out, M, d, I, st);
  if (nch <= 5) return launch_dx_bf16<5>(xx, ww, bb, gy, out, M, d, I, st);
  if (nch <= 10) return launch_dx_bf16<10>(xx, ww, bb, gy, out, M, d, I, st);
  return launch_dx_bf16<20>(xx, ww, bb, gy, out, M, d, I, st);
}

extern "C" int fd_geglu_dx_f32(const void* x, const void* w, const void* b, const void* dy,
                               void* dx, int M, int d, int I, void* stream) {
  if (bad_shape(M, d, I) || d > FDX_COLS * DX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (FDX_ROWS * d + 2 * FDX_ROWS * FDX_N);
  if (int err = (int)cudaFuncSetAttribute(geglu_dx_f32_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return err;
  const int blocks = (M + FDX_ROWS - 1) / FDX_ROWS;
  geglu_dx_f32_kernel<<<blocks, DX_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(dy), static_cast<float*>(dx), M, d, I);
  return (int)cudaGetLastError();
}
