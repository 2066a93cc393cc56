// Fused GEGLU for Hopper, sm_90a: the forward (K4) and the input gradient
// (K5, two wgmma GEMMs, described above their kernels below).
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
// (16-byte rows), which every SD-1.5 width is. Not yet done: wgmma/TMA (the
// dproj GEMM of K5 below is the mainloop to move it onto).
//
// The fp32 kernel is the simple version (CUDA-core fmaf over shared-memory
// tiles, any d); it serves the full-precision parity check.
#include <cstring>

#include "tma.cuh"
#include "wgmma.cuh"

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
// GEGLU dx (K5): two wgmma GEMMs fed by TMA
// ---------------------------------------------------------------------------
//
// Replaces `_geglu_dx` (Pallas body `_dx_kernel`), which computes
//   h = x Wh^T + bh, g = x Wg^T + bg        (recomputed, fp32 sums)
//   dh = dy gelu(g), dg = dy h gelu'(g)     rounded to the input type
//   dx = dh Wh + dg Wg                      fp32 sums, rounded once
// The TPU kernel carries dx in VMEM scratch across a sequential grid axis
// over I. Here the two products are two GEMM kernels on one mainloop:
// 1. dproj: [h | g] = x [Wh | Wg]^T over K = d. A block's [128 x 128] tile
//    holds 64 matching h and g columns (Wh rows n0.. and Wg rows n0.. side
//    by side in the B tile, as K4's tile pairs them). Its epilogue reads the
//    dy tile (loaded by TMA while the products run) and the bias, and
//    stages dh and dg, rounded to bf16, in shared memory, whence TMA stores
//    them as whole lines into the scratch dproj [M, 2 Ip] = [dh | dg] (Ip: I
//    rounded up to 64, columns past I zero): the JAX kernel's rounding
//    point.
// 2. dx: dx = dproj [Wh; Wg] over K = 2 Ip, one product, with W read as it
//    lies (torch layout [2I, d]: the B operand MN-major, rows past I zero by
//    TMA's fill). Tiles of [128 x 320] where d is a multiple of 320 (every
//    UNet width: A is then read once at d = 320), else [128 x 160]; where
//    they do not fill the card (M = 512 or 2048 at d = 1280) K is split
//    across blocks, each writing an fp32 partial, and a third launch sums
//    the partials in split order and rounds once. No atomics: two runs are
//    bit-equal.
//
// The mainloop (`gemm_kernel`, a template on the epilogue) is a
// warp-specialised block: one producer thread streams A and B tiles 64 deep
// by TMA through a ring of STAGES slots (mbarriers full and empty); two
// consumer warpgroups of 64 rows each issue m64nNk16 wgmma (N = 128, or
// 160 per 160-column part of a dx tile) with both operands in shared memory
// and keep one product in flight while they release the slot before it.
// Tiles are column blocks of 16 values (32-byte rows, 32-byte swizzle), the
// layout of the flash kernels (tma.cuh), so K- and MN-major operands take
// the same descriptors.
//
// What bounds it on this card: 8 M d I flops (dproj's two products and dx's
// two) against reads of x, W, dy and writes of dx: the tensor cores, at
// every UNet shape. The design's cost beyond the function's own traffic is
// dproj's round trip through device memory, 8 M I bytes (336 MB at
// [32768, 320]), and at split K the partials' 8 splits M d bytes.
namespace gm {

constexpr int BM = 128;              // rows a block: two consumer warpgroups of 64
constexpr int BK = 64;               // depth of a ring slot: four 16-deep column blocks
constexpr int NCB = BK / 16;
constexpr int NCONS = 256;
constexpr int NTHR = NCONS + 128;    // + the producer warpgroup (one thread works)
constexpr int DPROJ_N = 128;         // dproj: 64 h and 64 g columns a tile
constexpr int DX_PART = 160;         // dx: columns a wgmma (a tile is 1 or 2 parts)
constexpr int STAGES = 4;

// shared memory: the ring (A then B a slot), then dproj's dy tile and its
// staged [dh | dg] output, then the barriers
template <int BN, bool B_MN>
struct Smem {
  static constexpr int A = BM * BK * 2;   // NCB column blocks of [BM x 16]
  static constexpr int B = BN * BK * 2;   // K-major: NCB blocks of [BN x 16]; MN-major: BN/16 of [BK x 16]
  static constexpr int STAGE = A + B;
  static constexpr int DY = STAGES * STAGE;                  // dproj: dy [BM x 64]
  static constexpr int OUT = DY + (B_MN ? 0 : BM * 64 * 2);  // dproj: dh, dg [BM x 64] each
  static constexpr int BAR = OUT + (B_MN ? 0 : 2 * BM * 64 * 2);
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "shared memory");
};

// a: x (dproj) or dproj (dx), box [128 rows x 16]; wh, wg: the two halves
// of W [I, d] each, box [64 rows x 16]; dproj's dy [M, I] and its output
// dproj [M, 2 Ip], box [128 rows x 16] each
struct Maps {
  CUtensorMap a, wh, wg, dy, out;
};

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// dproj's epilogue: dh, dg for the tile's rows and its 64 columns n0.. of
// each half, rounded to bf16 and staged for the TMA store (`stage`: dh, then
// dg 16 KB on); dy from the shared tile `s_dy` where TMA loaded it (I a
// multiple of 8), else from device memory
struct DprojEpi {
  const bf16* dy;
  const bf16* bias;
  int M, I, Ip;
  bool dy_tma;
  template <int NS, int N>
  __device__ __forceinline__ void operator()(const float (&acc)[NS][N], int row0, int n0, int t, uint32_t s_dy,
                                             uint32_t stage) const {
    static_assert(NS == 1 && N == DPROJ_N / 2, "64 h and 64 g columns");
    const int lane = t % 32, r_lo = row0 % BM + 16 * (t / 32) + lane / 4;  // rows within the tile
    const int m0 = row0 - row0 % BM;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4), n = n0 + c;
      float bh[2], bg[2];
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nc = min(n + e, I - 1);  // clamped read; dy is 0 past I
        bh[e] = __bfloat162float(bias[nc]);
        bg[e] = __bfloat162float(bias[I + nc]);
      }
      #pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_lo + 8 * hf, row = m0 + r;
        const uint32_t off = fd::swz(r, c, BM);
        float gy[2];
        if (dy_tma) {
          const uint32_t u = ld_shared(s_dy + off);
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
          gy[0] = f.x;
          gy[1] = f.y;
        } else {
          #pragma unroll
          for (int e = 0; e < 2; ++e) gy[e] = row < M && n + e < I ? __bfloat162float(dy[(long)row * I + n + e]) : 0.0f;
        }
        float dh[2], dg[2];
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h = acc[0][4 * j + 2 * hf + e] + bh[e], g = acc[0][4 * (j + 8) + 2 * hf + e] + bg[e];
          dh[e] = gy[e] * gelu_erf(g);
          dg[e] = gy[e] * h * gelu_erf_grad(g);
        }
        fd::st_shared(stage + off, fd::pack_bf16(dh[0], dh[1]));
        fd::st_shared(stage + BM * 64 * 2 + off, fd::pack_bf16(dg[0], dg[1]));
      }
    }
  }
};

// dx's epilogue: the tile rounded to bf16 into dx [M, d], or, at split K,
// its fp32 partial into part [splits, M, d]
struct DxEpi {
  bf16* dx;
  float* part;
  int M, d;
  template <int NS, int N>
  __device__ __forceinline__ void operator()(const float (&acc)[NS][N], int row0, int n0, int t, uint32_t,
                                             uint32_t) const {
    const int lane = t % 32, r_lo = row0 + 16 * (t / 32) + lane / 4;
    #pragma unroll
    for (int p = 0; p < NS; ++p) {
      #pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const int col = n0 + 2 * N * p + 8 * j + 2 * (lane % 4);  // d % 8 == 0: both columns or neither
        #pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r_lo + 8 * hf;
          if (row >= M || col >= d) continue;
          const float a = acc[p][4 * j + 2 * hf], b = acc[p][4 * j + 2 * hf + 1];
          if (part != nullptr)
            *reinterpret_cast<float2*>(part + ((long)blockIdx.z * M + row) * d + col) = make_float2(a, b);
          else
            *reinterpret_cast<uint32_t*>(dx + (long)row * d + col) = fd::pack_bf16(a, b);
        }
      }
    }
  }
};

// C [BM x BN] tile (rows blockIdx.y, columns blockIdx.x) = A B summed over
// the block's share of the K tiles (blockIdx.z of `splits`), then `epi`.
// B_MN false (dproj): A = x [M, K = d], B = [Wh rows n0.. ; Wg rows n0..],
// both K-major; the epilogue's staged tile leaves by TMA (maps.out). B_MN
// true (dx): A = dproj [M, K = 2 Ip], B = W rows k (Wh for k < Ip, Wg for
// k >= Ip) read MN-major, `n_cols` = d columns, in BN / DX_PART parts.
template <int BN, bool B_MN, class Epi>
__global__ void __launch_bounds__(NTHR, 1)
    gemm_kernel(const __grid_constant__ Maps maps, const Epi epi, int K, int splits, int n_cols, int Ip) {
  using L = Smem<BN, B_MN>;
  constexpr int NS = B_MN ? BN / DX_PART : 1, PN = BN / NS;  // wgmma parts and their N
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = fd::smem_addr(smem_raw);
  const uint32_t base = raw + (1024 - raw % 1024) % 1024;
  const auto sa = [&](int s) { return base + s * L::STAGE; };
  const auto sb = [&](int s) { return base + s * L::STAGE + L::A; };
  const auto full = [&](int s) { return base + L::BAR + 8 * s; };
  const auto empty = [&](int s) { return base + L::BAR + 8 * (STAGES + s); };
  const uint32_t bar_dy = base + L::BAR + 16 * STAGES;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * (B_MN ? BN : BN / 2);
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = (int)((long)blockIdx.z * k_tiles / splits);
  const int nt = (int)((long)(blockIdx.z + 1) * k_tiles / splits) - kt0;
  bool dy_tma = false;
  if constexpr (!B_MN) dy_tma = epi.dy_tma;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      fd::mbar_init(full(s), 1);
      fd::mbar_init(empty(s), NCONS);
    }
    fd::mbar_init(bar_dy, 1);
    fd::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0 && dy_tma) {
      // dproj's dy tile, for the epilogue, ahead of the ring
      fd::mbar_expect_tx(bar_dy, BM * 64 * 2);
      for (int cb = 0; cb < 4; ++cb) fd::tma_load_2d(base + L::DY + cb * BM * 32, maps.dy, n0 + 16 * cb, m0, bar_dy);
    }
    for (int it = 0; it < nt; ++it) {
      const int s = it % STAGES, k0 = (kt0 + it) * BK;
      fd::mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
      if constexpr (!B_MN) {
        // column blocks wholly past K are not loaded: the warp zeroes them
        // (they hold an earlier tile), so the consumers' products need no
        // condition
        const int ncb = min(NCB, (K - k0 + 15) / 16);
        if (ncb < NCB) {
          for (int i = lane; i < (NCB - ncb) * (BM + BN) * 2; i += 32) {
            const int cb = ncb + i / ((BM + BN) * 2), r = i % ((BM + BN) * 2);
            const uint32_t at = r < BM * 2 ? sa(s) + cb * BM * 32 + 16 * r : sb(s) + cb * BN * 32 + 16 * (r - BM * 2);
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
          }
          fd::fence_async_smem();
          __syncwarp();
        }
        if (lane != 0) continue;
        fd::mbar_expect_tx(full(s), ncb * (BM + BN) * 32);
        for (int cb = 0; cb < ncb; ++cb) {
          fd::tma_load_2d(sa(s) + cb * BM * 32, maps.a, k0 + 16 * cb, m0, full(s));
          fd::tma_load_2d(sb(s) + cb * BN * 32, maps.wh, k0 + 16 * cb, n0, full(s));
          fd::tma_load_2d(sb(s) + cb * BN * 32 + (BN / 2) * 32, maps.wg, k0 + 16 * cb, n0, full(s));
        }
      } else {
        // columns of d wholly past n_cols are not loaded: they feed only
        // output columns that are not stored
        if (lane != 0) continue;
        const int half = K / 2, ncb = min(BN / 16, (n_cols - n0 + 15) / 16);
        const bool gate = k0 >= half;
        fd::mbar_expect_tx(full(s), NCB * BM * 32 + ncb * BK * 32);
        for (int cb = 0; cb < NCB; ++cb) fd::tma_load_2d(sa(s) + cb * BM * 32, maps.a, k0 + 16 * cb, m0, full(s));
        for (int cb = 0; cb < ncb; ++cb)
          fd::tma_load_2d(sb(s) + cb * BK * 32, gate ? maps.wg : maps.wh, n0 + 16 * cb, gate ? k0 - half : k0,
                          full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 64 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[NS][PN / 2];
  #pragma unroll
  for (int p = 0; p < NS; ++p) {
    #pragma unroll
    for (int i = 0; i < PN / 2; ++i) acc[p][i] = 0.0f;
  }
  const uint32_t a_off = wg * 64 * 32;
  for (int it = 0; it < nt; ++it) {
    const int s = it % STAGES;
    fd::mbar_wait(full(s), (it / STAGES) & 1);
    #pragma unroll
    for (int p = 0; p < NS; ++p) fd::keep(acc[p]);
    fd::wg_fence();
    #pragma unroll
    for (int ks = 0; ks < NCB; ++ks) {
      const uint64_t da = fd::desc(sa(s) + a_off + ks * BM * 32, 16, 256);
      if constexpr (B_MN) {
        #pragma unroll
        for (int p = 0; p < NS; ++p)
          fd::Gmma<PN>::template ss<0, 1>(acc[p], da, fd::desc(sb(s) + p * (PN / 16) * BK * 32 + ks * 512, BK * 32, 256), 1);
      } else {
        fd::Gmma<PN>::template ss<0, 0>(acc[0], da, fd::desc(sb(s) + ks * BN * 32, 16, 256), 1);
      }
    }
    fd::wg_commit();
    fd::wg_wait<1>();  // the slot before this one is read
    #pragma unroll
    for (int p = 0; p < NS; ++p) fd::keep(acc[p]);
    if (it > 0) fd::mbar_arrive(empty((it - 1) % STAGES));
  }
  fd::wg_wait<0>();
  #pragma unroll
  for (int p = 0; p < NS; ++p) fd::keep(acc[p]);
  if (dy_tma) fd::mbar_wait(bar_dy, 0);
  epi(acc, m0 + 64 * wg, n0, threadIdx.x % 128, base + L::DY, base + L::OUT);
  if constexpr (!B_MN) {
    // the staged [dh | dg] tile leaves by TMA, whole lines, rows past M clipped
    fd::fence_async_smem();
    fd::named_sync(1, NCONS);
    if (threadIdx.x == 0) {
      for (int h = 0; h < 2; ++h) {
        for (int cb = 0; cb < 4; ++cb)
          fd::tma_store_2d(maps.out, h * Ip + n0 + 16 * cb, m0, base + L::OUT + h * BM * 64 * 2 + cb * BM * 32);
      }
      fd::bulk_commit();
      fd::bulk_wait();  // shared memory outlives the stores that read it
    }
  }
}

// dx = the split-K partials [splits, n] summed in split order, rounded once
__global__ void __launch_bounds__(256)
    dx_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dx, long n, int splits) {
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(part + z * n + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  uint2 u;
  u.x = fd::pack_bf16(s.x, s.y);
  u.y = fd::pack_bf16(s.z, s.w);
  *reinterpret_cast<uint2*>(dx + i) = u;
}

template <int BN, bool B_MN, class Epi>
int launch_gemm(const Maps& maps, const Epi& epi, dim3 grid, int K, int splits, int n_cols, int Ip,
                cudaStream_t stream) {
  const auto kernel = gemm_kernel<BN, B_MN, Epi>;
  constexpr int bytes = Smem<BN, B_MN>::BYTES;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) return err;
  kernel<<<grid, NTHR, bytes, stream>>>(maps, epi, K, splits, n_cols, Ip);
  return (int)cudaGetLastError();
}

// K5: dproj (scratch [M, 2 Ip] bf16), then dx; at splits > 1 the fp32
// partials part [splits, M, d] and their sum
int dx_bf16(const bf16* x, const bf16* w, const bf16* b, const bf16* dy, bf16* dx, bf16* dproj, float* part,
            int M, int d, int I, int splits, cudaStream_t stream) {
  const int Ip = (I + 63) / 64 * 64, m_tiles = (M + BM - 1) / BM;
  const bool dy_tma = I % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!(fd::tensor_map_2d(&maps.a, x, M, d, d, BM) && fd::tensor_map_2d(&maps.wh, w, I, d, d, 64) &&
        fd::tensor_map_2d(&maps.wg, w + (long)I * d, I, d, d, 64) &&
        fd::tensor_map_2d(&maps.out, dproj, M, 2 * Ip, 2 * Ip, BM) &&
        (!dy_tma || fd::tensor_map_2d(&maps.dy, dy, M, I, I, BM))))
    return (int)cudaErrorInvalidValue;
  if (int err = launch_gemm<DPROJ_N, false>(maps, DprojEpi{dy, b, M, I, Ip, dy_tma}, dim3(Ip / 64, m_tiles, 1), d,
                                            1, d, Ip, stream))
    return err;
  maps.a = maps.out;
  const DxEpi epi{dx, splits > 1 ? part : nullptr, M, d};
  const int err = d % (2 * DX_PART) == 0
                      ? launch_gemm<2 * DX_PART, true>(maps, epi, dim3(d / (2 * DX_PART), m_tiles, splits), 2 * Ip,
                                                       splits, d, Ip, stream)
                      : launch_gemm<DX_PART, true>(maps, epi, dim3((d + DX_PART - 1) / DX_PART, m_tiles, splits),
                                                   2 * Ip, splits, d, Ip, stream);
  if (err) return err;
  if (splits > 1) {
    const long n = (long)M * d;
    dx_reduce_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(part, dx, n, splits);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace gm

// fp32 dx: the simple version. One block of 256 threads per 16 rows; h, g
// and dh, dg through shared memory, dx in registers (thread t owns columns
// t, t + 256, ... of all 16 rows), CUDA-core fmaf. d <= 1280.
constexpr int DX_THREADS = 256;
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

// K5: dx [M, d] from x [M, d], w [2I, d], b [2I], dy [M, I]; scratch dproj
// [M, 2 Ip] bf16 (Ip = I rounded up to 64) and, at splits > 1, part
// [splits, M, d] fp32 (the fp32 body ignores all three)
extern "C" int fd_geglu_dx_bf16(const void* x, const void* w, const void* b, const void* dy,
                                void* dx, void* dproj, void* part, int M, int d, int I, int splits,
                                void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int k_tiles = 2 * ((I + gm::BK - 1) / gm::BK);
  if (bad_shape(M, d, I) || d % 8 != 0 || !aligned(x) || !aligned(w) || !aligned(dx) || !aligned(dproj) ||
      (M + gm::BM - 1) / gm::BM > 65535 || splits < 1 || splits > k_tiles || (splits > 1 && !aligned(part)))
    return (int)cudaErrorInvalidValue;
  return gm::dx_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
                     static_cast<const bf16*>(dy), static_cast<bf16*>(dx), static_cast<bf16*>(dproj),
                     static_cast<float*>(part), M, d, I, splits, static_cast<cudaStream_t>(stream));
}

extern "C" int fd_geglu_dx_f32(const void* x, const void* w, const void* b, const void* dy,
                               void* dx, void*, void*, int M, int d, int I, int, void* stream) {
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
