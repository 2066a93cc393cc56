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
// only because Mosaic has no erf) and the product run in fp32, rounded once
// to bf16 (the JAX kernel's rounding point); only the [M, I] product is
// written, so the [M, 2I] projection never reaches device memory.
//
// What bounds it on this card: at the UNet shapes (d = 320..1280, I = 4d,
// M = 2N*64..2N*4096) it does 4*M*d*I flops against 2*(M*d + 2*I*d + M*I)
// bytes, hundreds of flops per byte, so the tensor cores bound it: 4 M d I
// / 989 TFLOP/s, 0.0271 ms at [16384, 320], [4096, 640] and [1024, 1280].
// Beside the products, the epilogue's erff costs about 40 instructions an
// output on the CUDA cores, as long as a tile's products at d = 320.
// The bf16 kernel (namespace k4) is a persistent, warp-specialised wgmma
// GEMM with the gelu product as its epilogue:
// - One block an SM walks a static list of y tiles. A producer thread
//   streams 64-deep K slots by TMA through a ring of mbarrier-guarded slots:
//   each slot is one box of x [rows x 64] and one B tile of Wh rows n0.. and
//   Wg rows n0.. side by side, all in 128-byte lines with the 128-byte
//   swizzle. TMA zero-fills a last slot past d and rows past M and I, so
//   every slot runs the same wgmma (none is skipped).
// - Each consumer warpgroup issues m64nNk16 wgmma with N = 2 COLS (256 for
//   the 128-column tiles), so one thread's accumulators hold h and g of the
//   same outputs: the epilogue needs no exchange.
// - Two layouts of the two consumer warpgroups (ops/geglu.py `fwd_tile`
//   picks): cooperative, both on one 128-row tile (64 rows each), products
//   at the full rate, the epilogue after them; ping-pong, each on its own
//   64-row tile, mainloops in turns (named barriers), so one's epilogue runs
//   while the other's products do. The overlap is partial (the erff work
//   and the products slow each other), so ping-pong pays only where the
//   epilogue is as long as the products: d = 320.
// - Epilogue: the tile's biases are read once into shared memory and added
//   into the accumulators; the product is staged in the store map's
//   swizzled layout and leaves by TMA store (rows past M, columns past I
//   clipped), whose read of the staging buffer is awaited before its next
//   use. Where TMA cannot address y (I % 8 != 0) it is stored plainly.
// - Tiles: 128 outputs (wgmma N = 256) or, where that spreads the tiles
//   over the SMs better (the mid block), 64. No split K: gelu is not linear
//   in a partial sum, so a split would need a second pass over fp32
//   partials of both halves.
// Every y element is written once by one tile: two runs are bit-equal. d
// must be a multiple of 8 (16-byte rows), which every SD-1.5 width is.
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
// bf16 forward (K4): a persistent wgmma GEMM fed by TMA, gelu epilogue
// ---------------------------------------------------------------------------
namespace k4 {

constexpr int BK = 64;             // depth of a K slot: one 128-byte line of x and of W
constexpr int NCONS = 256;         // two consumer warpgroups
constexpr int NTHR = NCONS + 128;  // + the producer warpgroup (one thread works)
constexpr int SMEM_MAX = 232448;
constexpr int MAX_STAGES = 6;

// shared memory: the ring (a slot: the x tile, then Wh rows n0.. and Wg
// rows n0.. as one [2 COLS x 64] B tile), each consumer warpgroup's staged y
// [64 x COLS] and its bf16 biases (h, then g), then the barriers
template <int ROWS, int COLS>
struct Smem {
  static constexpr int A = ROWS * BK * 2;
  static constexpr int B = 2 * COLS * BK * 2;
  static constexpr int STAGE = A + B;
  static constexpr int OUT = 64 * COLS * 2;
  static constexpr int BIAS = 2 * COLS * 2;
  static constexpr int FIT = (SMEM_MAX - 1024 - 2 * (OUT + BIAS) - 16 * MAX_STAGES) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int Y = STAGES * STAGE;
  static constexpr int BIAS_AT = Y + 2 * OUT;
  static constexpr int BAR = BIAS_AT + 2 * BIAS;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + alignment slack
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "shared memory");
};

// x [M, d], box [ROWS x 64]; the two halves of W [I, d] each, box [COLS x
// 64]; y [M, I], box [64 x 64]; all with the 128-byte swizzle
struct Maps {
  CUtensorMap x, wh, wg, y;
};

__device__ __forceinline__ void st_shared_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ float2 ld_shared_bf16x2(uint32_t addr) {
  uint32_t u;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(u) : "r"(addr) : "memory");
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// y = (h + bh) gelu(g + bg) for a warpgroup's 64 rows (r = 16 warp +
// lane / 4, + 8) and COLS columns of accumulators [h | g] (the biases are
// added in place), rounded to bf16: staged for the TMA store at `s_out` in
// the store map's swizzled layout (TMA), or stored to y [M, I] rows m0..,
// columns n0.., masked
template <int COLS, bool TMA>
__device__ __forceinline__ void epilogue(float (&acc)[COLS], uint32_t s_bias, uint32_t s_out, int t,
                                         bf16* __restrict__ y, int M, int I, int m0, int n0) {
  const int lane = t % 32, r_lo = 16 * (t / 32) + lane / 4;
  // the biases first, added into the accumulators: a shared load between
  // the stores below would fence each column group's erff chains from the
  // next, and biases held in registers would leave too few for the chains
  #pragma unroll
  for (int j8 = 0; j8 < COLS / 8; ++j8) {
    const int c = 8 * j8 + 2 * (lane % 4);
    const float2 bh = ld_shared_bf16x2(s_bias + 2 * c), bg = ld_shared_bf16x2(s_bias + 2 * (COLS + c));
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int e = 4 * j8 + 2 * hf, eg = 4 * (j8 + COLS / 8) + 2 * hf;
      acc[e] += bh.x;
      acc[e + 1] += bh.y;
      acc[eg] += bg.x;
      acc[eg + 1] += bg.y;
    }
  }
  #pragma unroll
  for (int j8 = 0; j8 < COLS / 8; ++j8) {
    const int c = 8 * j8 + 2 * (lane % 4);
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r_lo + 8 * hf, e = 4 * j8 + 2 * hf, eg = 4 * (j8 + COLS / 8) + 2 * hf;
      const float v0 = acc[e] * gelu_erf(acc[eg]), v1 = acc[e + 1] * gelu_erf(acc[eg + 1]);
      if (TMA) {
        fd::st_shared(s_out + (c / 64) * 64 * 128 + fd::swz128(r, c % 64), fd::pack_bf16(v0, v1));
      } else {
        const int row = m0 + r, col = n0 + c;
        if (row < M && col < I) y[(long)row * I + col] = __float2bfloat16(v0);
        if (row < M && col + 1 < I) y[(long)row * I + col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ping-pong: the two consumer warpgroups run their tiles' mainloops in turns
// (named barriers 3 and 4), so one's epilogue runs while the other's
// products are on the tensor cores
__device__ __forceinline__ void my_turn(int wg) { fd::named_sync(3 + wg, NCONS); }
__device__ __forceinline__ void your_turn(int wg) { fd::named_arrive(3 + (wg ^ 1), NCONS); }

// y tiles of [ROWS x COLS]; ROWS 128: cooperative (each tile's rows split
// between the two consumer warpgroups, 64 each), ROWS 64: ping-pong (the
// warpgroups take the block's tiles in turn). Block b walks tiles b, b +
// gridDim.x, ...; tile t is row block t % m_tiles of column block t /
// m_tiles, so the blocks in flight share the W tiles of a few column
// blocks while all of x streams past them (L2 holds both at every UNet
// width).
template <int ROWS, int COLS>
__global__ void __launch_bounds__(NTHR, 1)
    fwd_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int d,
               int I, int m_tiles, int n_tiles, bool y_tma) {
  using L = Smem<ROWS, COLS>;
  constexpr bool PINGPONG = ROWS == 64;
  constexpr int N = 2 * COLS;  // the wgmma's width: COLS h columns, then the same COLS g columns
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = fd::smem_addr(smem_raw);
  const uint32_t base = raw + (1024 - raw % 1024) % 1024;
  const auto sa = [&](int s) { return base + s * L::STAGE; };
  const auto sb = [&](int s) { return base + s * L::STAGE + L::A; };
  const auto full = [&](int s) { return base + L::BAR + 8 * s; };
  const auto empty = [&](int s) { return base + L::BAR + 8 * (L::STAGES + s); };
  const int k_tiles = (d + BK - 1) / BK;
  const int n_local = (m_tiles * n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;  // this block's tiles
  // the block's j-th tile: its first row and column
  const auto tile_of = [&](int j, int& m0, int& n0) {
    const int tile = blockIdx.x + j * gridDim.x;
    m0 = tile % m_tiles * ROWS;
    n0 = tile / m_tiles * COLS;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      fd::mbar_init(full(s), 1);
      fd::mbar_init(empty(s), PINGPONG ? 128 : NCONS);
    }
    fd::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread streams every K slot of the block's tiles,
    // running ahead into the next tile while the consumers finish this one.
    // A last slot past d is zero-filled by TMA, as are rows past M and I.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 != 0) return;
    int it = 0;
    for (int j = 0; j < n_local; ++j) {
      int m0, n0;
      tile_of(j, m0, n0);
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % L::STAGES;
        fd::mbar_wait(empty(s), ((it / L::STAGES) & 1) ^ 1);
        fd::mbar_expect_tx(full(s), L::STAGE);
        fd::tma_load_2d(sa(s), maps.x, kt * BK, m0, full(s));
        fd::tma_load_2d(sb(s), maps.wh, kt * BK, n0, full(s));
        fd::tma_load_2d(sb(s) + COLS * 128, maps.wg, kt * BK, n0, full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns 64 rows of a tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = threadIdx.x % 128;
  const uint32_t s_out = base + L::Y + wg * L::OUT, s_bias = base + L::BIAS_AT + wg * L::BIAS;
  const uint32_t a_off = PINGPONG ? 0 : wg * 64 * 128;
  float acc[N / 2] = {};  // each tile's first wgmma overwrites it
  int it = 0;             // the block's ring slots, counted over all its tiles
  for (int j = 0; j < n_local; ++j) {
    if (PINGPONG && j % 2 != wg) {
      it += k_tiles;
      continue;
    }
    int m0, n0;
    tile_of(j, m0, n0);
    if (!PINGPONG) m0 += 64 * wg;
    // the tile's biases (h, then g): loaded now, stored for the epilogue
    // after the products, which hide the load
    unsigned short bv[2 * COLS / 128];
    #pragma unroll
    for (int q = 0; q < 2 * COLS / 128; ++q) {
      const int i = t + 128 * q, n = n0 + i % COLS;
      bv[q] = n < I ? __bfloat16_as_ushort(bias[(i < COLS ? 0 : I) + n]) : 0;
    }
    if (PINGPONG && j > 0) my_turn(wg);
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % L::STAGES;
      fd::mbar_wait(full(s), (it / L::STAGES) & 1);
      fd::keep(acc);
      fd::wg_fence();
      #pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        fd::Gmma<N>::template ss<0, 0>(acc, fd::desc128(sa(s) + a_off + 32 * ks), fd::desc128(sb(s) + 32 * ks),
                                       kt > 0 || ks > 0);
      fd::wg_commit();
      fd::wg_wait<1>();  // the slot before this one is read
      fd::keep(acc);
      if (kt > 0) fd::mbar_arrive(empty((it - 1) % L::STAGES));
    }
    if (PINGPONG && j + 1 < n_local) your_turn(wg);
    fd::wg_wait<0>();
    fd::keep(acc);
    fd::mbar_arrive(empty((it - 1) % L::STAGES));

    // ---- epilogue: y = (h + bh) gelu(g + bg) in fp32, rounded once to bf16,
    // staged in the store map's swizzled layout and stored by TMA (rows past
    // M and columns past I clipped), or stored plainly where TMA cannot
    // address y (I % 8 != 0)
    #pragma unroll
    for (int q = 0; q < 2 * COLS / 128; ++q) st_shared_u16(s_bias + 2 * (t + 128 * q), bv[q]);
    if (y_tma && t == 0) fd::bulk_wait_read();  // the last tile's store has read the staging buffer
    fd::named_sync(1 + wg, 128);                // ... and every bias is in
    // one branch for the whole tile: a branch per output pair would cut the
    // unrolled loop into blocks of two erff chains, which ptxas does not
    // interleave
    if (y_tma)
      epilogue<COLS, true>(acc, s_bias, s_out, t, y, M, I, m0, n0);
    else
      epilogue<COLS, false>(acc, s_bias, s_out, t, y, M, I, m0, n0);
    fd::fence_async_smem();
    fd::named_sync(1 + wg, 128);  // the staged tile is whole; the biases are read
    if (y_tma && t == 0 && m0 < M) {
      for (int cb = 0; cb < COLS / 64; ++cb) fd::tma_store_2d(maps.y, n0 + 64 * cb, m0, s_out + cb * 64 * 128);
      fd::bulk_commit();
    }
  }
  if (y_tma && t == 0) fd::bulk_wait();  // shared memory outlives the stores that read it
}

// one launch of the persistent kernel: min(tiles, SMs) blocks
template <int ROWS, int COLS>
int launch(const bf16* x, const bf16* w, const bf16* b, bf16* y, int M, int d, int I, cudaStream_t stream) {
  using L = Smem<ROWS, COLS>;
  const bool y_tma = I % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int m_tiles = (M + ROWS - 1) / ROWS, n_tiles = (I + COLS - 1) / COLS;
  const long tiles = (long)m_tiles * n_tiles;
  int dev = 0, sms = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return err;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!(fd::tensor_map_2d(&maps.x, x, M, d, d, ROWS, true) && fd::tensor_map_2d(&maps.wh, w, I, d, d, COLS, true) &&
        fd::tensor_map_2d(&maps.wg, w + (long)I * d, I, d, d, COLS, true) &&
        (!y_tma || fd::tensor_map_2d(&maps.y, y, M, I, I, 64, true))))
    return (int)cudaErrorInvalidValue;
  const auto kernel = fwd_kernel<ROWS, COLS>;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES)) return err;
  kernel<<<(unsigned)(tiles < sms ? tiles : sms), NTHR, L::BYTES, stream>>>(maps, b, y, M, d, I, m_tiles, n_tiles,
                                                                            y_tma);
  return (int)cudaGetLastError();
}

}  // namespace k4

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

// K4: y [M, I] from x [M, d], w [2I, d], b [2I] in y tiles of tile_rows
// (128: cooperative, 64: ping-pong) x tile_cols (128 or 64) rows and
// columns; the fp32 body ignores the tile
extern "C" int fd_geglu_fwd_bf16(const void* x, const void* w, const void* b, void* y,
                                 int M, int d, int I, int tile_rows, int tile_cols, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (bad_shape(M, d, I) || d % 8 != 0 || !aligned(x) || !aligned(w)) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(b);
  auto* yb = static_cast<bf16*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile_rows == 64 && tile_cols == 128) return k4::launch<64, 128>(xb, wb, bb, yb, M, d, I, st);
  if (tile_rows == 128 && tile_cols == 128) return k4::launch<128, 128>(xb, wb, bb, yb, M, d, I, st);
  if (tile_rows == 128 && tile_cols == 64) return k4::launch<128, 64>(xb, wb, bb, yb, M, d, I, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fd_geglu_fwd_f32(const void* x, const void* w, const void* b, void* y,
                                int M, int d, int I, int, int, void* stream) {
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
