// Flash attention (non-causal) for Hopper, sm_90a: the forward (K1, with or
// without lse), the split backward (K2 dq, K3 dk/dv) and the merged backward
// (K6 dq+dk+dv in one pass).
//
// Replaces: fairdiff/ops/flash_attention.py `_flash_forward` (Pallas bodies
// `_flash_kernel` and `_flash_kernel_pipe`, identical maths; `with_lse` for
// the backward), `_dq_pallas` (`_bwd_dq_kernel`), `_dkv_pallas`
// (`_bwd_dkv_kernel`) and `_flash_backward_merged` (`_bwd_merged_kernel`).
// The bf16 kernels are two Hopper designs on wgmma and TMA, described above
// each: the query-block kernels (K1, K2: a block owns q rows and streams
// every key tile past them) and the key-block kernels (K3, K6: a block owns
// keys and streams every q tile past them). Their building blocks are
// `tma.cuh`, their products `wgmma.cuh`.
//
// Computes o = softmax(scale * q k^T) v for q [B,S,H,D], k/v [B,T,H,D], all
// contiguous, read in place with a row stride of H*D (no relayout copy and no
// padded copy in device memory). Numerics follow the TPU kernel: fp32 scores
// with `scale` applied to them (not to q), fp32 running max m, sum l and
// accumulator, p rounded to the input type before p.v, keys >= T masked to
// -inf, l clamped at 1e-30. The masked K1 (`fd_flash_fwd_masked_*`, no lse)
// also masks to -inf each key whose entry in a key mask [B, T] is 0: the
// UNet's cross-attention over a padded 77-token context.
//
// The fp32 kernels are the simple versions (every tile through shared
// memory, CUDA-core fmaf); they serve the full-precision parity checks, not
// the hot path.
#include <cstring>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace fd;

// fp32 simple versions: 64-row q (or key) tiles, four warps
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int NTHREADS = 128;
constexpr int MAX_D = 160;

// K6's fp32 dq buffer [B, H, S_pad, D]: S_pad is S rounded up to 64 rows
constexpr int DQ_ROWS = 64;

// mode bits of a bf16 launch
constexpr int TMA = 1;        // tiles by TMA, outputs by TMA stores
constexpr int LSE_BULK = 2;   // K3/K6: lse and delta rows by 1-D bulk copies
constexpr int PAIRS = 4;      // fallback: 4-byte cp.async (even D, aligned)

// ---------------------------------------------------------------------------
// bf16 query-block kernels on wgmma and TMA: K1 (forward) and K2 (dq)
// ---------------------------------------------------------------------------
//
// K1 replaces `_flash_forward` (with and without lse: one kernel, lse
// written where its pointer is not null); K2 replaces `_dq_pallas`, which
// computes, for o = softmax(scale q k^T) v with lse = m + log l from the
// forward, dO the output cotangent and delta = rowsum(dO * o) (computed
// outside, as in the JAX package's `_bwd_operands`):
//   p  = exp(scale q k^T - lse)            fp32, recomputed per tile
//   dp = dO v^T                            fp32 accumulate
//   ds = p * (dp - delta)                  rounded to bf16
//   dq = scale * ds k                      fp32 accumulate, rounded once
// the rounding points of the TPU kernel.
//
// What bounds them on this card: K1 does two products (S = Q K^T, O += P V)
// and K2 three (S, dP = dO V^T, dQ += dS K), 2*S*T*D flops each, against
// reads of q, k, v (and dO) once. At D = 80 the tensor cores bound them; at
// D = 40 the exp unit bounds K1 (S*T exponentials at ~3.9 T/s, 1.6x the
// tensor time) and ties with the tensor cores in K2. So every score element
// costs one FFMA (scale * log2 e and the row max, or lse, folded together)
// and one ex2; the key mask is applied on the last tile only, where T is
// not a multiple of the tile; and the design's point is that exponentials
// run while the tensor cores work.
//
// Design (a warp-specialised block of three warpgroups):
// - One block owns BM = 128 q rows; each of two consumer warpgroups owns 64
//   of them (wgmma's M). Its q tile (and K2's dO tile) comes in once, by
//   TMA, and stays in shared memory; K2's lse and delta are two registers a
//   row, read once.
// - One producer warp streams the K and V tiles of BN keys (TMA) through a
//   ring of STAGES slots, each marked full and empty by an mbarrier, as in
//   the key-block kernels.
// - Every product is a wgmma: S = Q K^T (and dP = dO V^T) with both operands
//   K-major in shared memory; O += bf16(P) V and dQ += bf16(dS) K with A from
//   registers (the accumulator layout of S is the A-fragment layout of P, one
//   bf16 pack) and B the same K or V tile read MN-major, so no tile is
//   stored twice.
// - Overlap, two ways at once. Within a warpgroup, K1 issues tile j+1's S
//   with tile j's P.V and waits for S only (`wgmma.wait_group 1`), so tile
//   j+1's softmax runs while P.V is on the tensor cores; K2 likewise issues
//   tile j+1's S and dP before tile j's dS.K and computes tile j+1's ds
//   while dS.K runs. Between the warpgroups, named barriers give them the
//   tensor cores in turns (ping-pong), so one's exponentials run while the
//   other's products do. Measured on an H100 (chip_smoke.py `[kernels]`,
//   `[kernels-bwd]`): at D = 40 both together beat in-warpgroup
//   pipelining alone by 12% in K1 and 3% in K2, and beat products and
//   exponentials in turn (the warpgroups only drifting apart) by 7% in both;
//   at D = 80 the three are within run-to-run noise.
// - The online softmax keeps the running max in log2 units: p = ex2(s *
//   scale * log2e - m2), alpha = ex2(m2_old - m2_new); each row's four
//   values sit on one quad of the wgmma accumulator layout, so the row max
//   is two shuffles and l stays a per-thread partial sum (fp32 p, as the
//   TPU kernel) until the end. lse = m + log l is written in natural-log
//   units, fp32 [B, H, S], as K2, K3 and K6 read it.
// - Layout: tiles are column blocks of 16 head-dim values (32-byte rows,
//   32-byte swizzle) loaded by TMA from 4-D maps over (D, H, rows, B), as in
//   the key-block kernels, so D = 40 pads to 48 with zeros that TMA fills
//   and rows past S or T read as zero. Each warpgroup stages its output
//   tile (o, or dq = scale dQ, rounded once) in its own q rows, which no
//   wgmma reads any more, and stores it by TMA through a map that clips rows
//   past S and columns past D. No atomics: every output element is written
//   once by one block, so two runs are bit-equal.
// - A layout TMA cannot address (a row stride that is not a multiple of 16
//   bytes, as D = 20 at H = 3, an odd D, an unaligned base) takes the same
//   kernel with the producer issuing zero-filling cp.async (plain loads for
//   an odd D) and the output leaving by plain stores.
// - Sizes: BN = 128 keys a tile up to DP = 80 (64 above, for the registers
//   of O and dQ; K2 holds S and dP too), which beat 64 by 17% in K1 and 12%
//   in K2 at D = 40 (H100, `[kernels]`, `[kernels-bwd]`); 3 ring slots;
//   128 q rows a block give 1024 blocks at [4,4096,8,40] (7.8 waves of 132
//   SMs) and 256 at [4,1024,8,80] (1.9 waves), so no shape of the path is
//   tail-bound; one block an SM (the q warpgroups hold 232 registers a
//   thread, the producer 40). Up to DP = 160 (SD-1.5's 1280-channel
//   transformers at 768 px): K1 holds O (80 fp32 registers a thread) and S
//   (32), K2 dQ (80), S and dP (32 each), under the 232; K2's shared memory
//   at DP = 160 is q and dO (40 KB each) and three K + V slots (40 KB each).
namespace qb {

constexpr int BM = 128;             // q rows a block
constexpr int NWG = 2;              // consumer warpgroups, 64 q rows each
constexpr int NCONS = NWG * 128;
constexpr int NTHR = NCONS + 128;   // + the producer warpgroup (one warp works)
constexpr int STAGES = 3;           // K/V ring slots

// keys a tile of the K/V ring: 64 above DP = 80, for the registers of O
// and dQ
template <int DP>
constexpr int KEY_TILE = DP <= 80 ? 128 : 64;

// shared memory of one block, in bytes from a 1024-aligned base
template <int DP, bool BWD>
struct Smem {
  static constexpr int NB = DP / 16;                    // column blocks
  static constexpr int BN = KEY_TILE<DP>;
  static constexpr int Q = DP * BM * 2;                 // q (or dO) [BM x DP]
  static constexpr int KV = DP * BN * 2;                // K (or V) [BN x DP]
  static constexpr int RING = (BWD ? 2 : 1) * Q;        // K2: dO after q
  static constexpr int BAR = RING + STAGES * 2 * KV;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "shared memory");
};

// out: o (K1) or dq (K2), through the same 64-row box as q; kmask: the
// masked K1's key mask [B, T] (int32, 0 masks the key), else null
struct Maps {
  CUtensorMap q, k, v, dout, out;
  const int* kmask;
};

template <int DP, bool BWD>
struct Block {
  using L = Smem<DP, BWD>;
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t dout() const { return base + L::Q; }
  __device__ uint32_t k(int s) const { return base + L::RING + s * 2 * L::KV; }
  __device__ uint32_t v(int s) const { return k(s) + L::KV; }
  __device__ uint32_t bar_q() const { return base + L::BAR; }
  __device__ uint32_t full(int s) const { return base + L::BAR + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return base + L::BAR + 8 * (1 + STAGES + s); }
};

// the block's shared memory, its barriers initialised
template <int DP, bool BWD>
__device__ __forceinline__ Block<DP, BWD> start(unsigned char* smem_raw, int mode) {
  const uint32_t raw = fd::smem_addr(smem_raw);
  const Block<DP, BWD> sm{raw + (1024 - raw % 1024) % 1024};
  if (threadIdx.x == 0) {
    const uint32_t loads = mode & TMA ? 1 : 32;  // lane 0's expect_tx, or every lane's arrive
    mbar_init(sm.bar_q(), loads);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), loads);
      mbar_init(sm.empty(s), NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// the producer warp: the block's q (and dO) rows once, then every K and V
// tile through the ring
template <int DP, bool BWD>
__device__ __forceinline__ void produce(const Block<DP, BWD>& sm, const Maps& maps, const bf16* q,
                                        const bf16* k, const bf16* v, const bf16* dout, int S, int T_,
                                        int H, int D, int mode) {
  using L = Smem<DP, BWD>;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BM;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D, koff = (long)b * T_ * stride + (long)h * D;
  const bool tma = mode & TMA, pairs = mode & PAIRS;
  if (tma) {
    if (lane == 0) {
      // a warpgroup's 64-row box wholly past S is not loaded: its rows are
      // never stored, and nothing reads across rows
      const int boxes = q0 + 64 < S ? 2 : 1;
      mbar_expect_tx(sm.bar_q(), (BWD ? 2 : 1) * boxes * L::Q / NWG);
      for (int cb = 0; cb < L::NB; ++cb) {
        for (int w = 0; w < boxes; ++w) {
          const uint32_t off = cb * BM * 32 + w * 64 * 32;
          tma_load(sm.q() + off, maps.q, 16 * cb, h, q0 + 64 * w, b, sm.bar_q());
          if constexpr (BWD) tma_load(sm.dout() + off, maps.dout, 16 * cb, h, q0 + 64 * w, b, sm.bar_q());
        }
      }
    }
  } else {
    copy_tile<DP, BM>(sm.q(), q + qoff, stride, q0, S, D, pairs, lane);
    if constexpr (BWD) copy_tile<DP, BM>(sm.dout(), dout + qoff, stride, q0, S, D, pairs, lane);
    cp_async_wait_all();
    fence_async_smem();
    mbar_arrive(sm.bar_q());
  }
  const int n_tiles = (T_ + L::BN - 1) / L::BN;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, k0 = it * L::BN;
    mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(sm.full(s), 2 * L::KV);
        for (int cb = 0; cb < L::NB; ++cb) {
          tma_load(sm.k(s) + cb * L::BN * 32, maps.k, 16 * cb, h, k0, b, sm.full(s));
          tma_load(sm.v(s) + cb * L::BN * 32, maps.v, 16 * cb, h, k0, b, sm.full(s));
        }
      }
    } else {
      copy_tile<DP, L::BN>(sm.k(s), k + koff, stride, k0, T_, D, pairs, lane);
      copy_tile<DP, L::BN>(sm.v(s), v + koff, stride, k0, T_, D, pairs, lane);
      cp_async_wait_all();
      fence_async_smem();
      mbar_arrive(sm.full(s));
    }
  }
}

// acc = A B^T for this warpgroup's 64 rows of a [BM x DP] tile at `a` and a
// key tile [BN x DP] at `b`, both K-major (S = Q K^T, dP = dO V^T)
template <int DP, int BN>
__device__ __forceinline__ void gemm_ss(float (&acc)[BN / 2], uint32_t a, uint32_t b) {
  #pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    fd::Gmma<BN>::template ss<0, 0>(acc, desc(a + ks * BM * 32, 16, 256), desc(b + ks * BN * 32, 16, 256),
                                    ks > 0);
}

// acc += A B for A [64 x BN] in registers (bf16 fragments) and the key tile
// [BN x DP] at `b` read MN-major (O += P V, dQ += dS K)
template <int DP, int BN>
__device__ __forceinline__ void gemm_rs(float (&acc)[DP / 2], const uint32_t (&a)[BN / 16][4], uint32_t b) {
  #pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    fd::Gmma<DP>::template rs<1>(acc, a[kk], desc(b + kk * 512, BN * 32, 256), 1);
}

// a [64 x N] fp32 accumulator as the bf16 A fragments of the next product
template <int N>
__device__ __forceinline__ void pack(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
  #pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    #pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = fd::pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
  }
}

// the masked K1's valid keys of one key tile for this thread's BN / 4
// columns (bit 2j + e: column 8j + 2 (lane % 4) + e of the accumulator
// layout): key < T and its mask entry not 0. Read from global memory (L1),
// loaded while the tile's S product runs
template <int BN>
__device__ __forceinline__ uint32_t valid_keys(const int* __restrict__ kmask, int k0, int T_, int lane) {
  static_assert(BN <= 128, "BN / 4 bits");
  uint32_t bits = 0;
  #pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    #pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * (lane % 4) + e;
      if (key < T_ && __ldg(kmask + key) != 0) bits |= 1u << (2 * j + e);
    }
  }
  return bits;
}

// one score tile of the online softmax, in place: s -> p = ex2(s sl2 - m2)
// with m2 the running row max in log2 units; keys at or past `limit` (< BN
// on the last tile only) masked to -inf, or (MASK) every key whose bit in
// `valid` is 0. alpha: each row's rescale of the running sums; l: this
// thread's partial row sums. With MASK a tile can mask a row's every key:
// while its running max is still -inf the exponents subtract 0 instead, so
// p and alpha are 0, not NaN. MASK false compiles to the unmasked code
template <int BN, bool MASK = false>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m2)[2], float (&l)[2],
                                               float (&alpha)[2], float sl2, int limit, int lane,
                                               uint32_t valid = 0) {
  if constexpr (MASK) {
    #pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!((valid >> (2 * j + (e & 1))) & 1u)) s[4 * j + e] = -INFINITY;
    }
  } else if (limit < BN) {
    #pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * (lane % 4) + (e & 1) >= limit) s[4 * j + e] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, msub[2];
  #pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r] * sl2);  // unmasked: finite, key 0 of tile 0 is valid
    msub[r] = MASK && m_new == -INFINITY ? 0.0f : m_new;
    alpha[r] = ex2(m2[r] - msub[r]);                // 0 on the first tile
    m2[r] = m_new;
    l[r] *= alpha[r];
  }
  #pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], sl2, -msub[e / 2]));
      l[e / 2] += p;  // fp32 p in the sum, as the TPU kernel
      s[4 * j + e] = p;
    }
  }
}

// this warpgroup's [64 x DP] output tile, acc times its row's factor `f`,
// rounded to bf16: staged in the warpgroup's own q rows (no wgmma reads them
// any more) and stored by TMA through the clipping map, or stored plainly
template <int DP, bool BWD>
__device__ __forceinline__ void store_out(const Block<DP, BWD>& sm, const Maps& maps, bf16* out,
                                          const float (&acc)[DP / 2], const float (&f)[2], int S, int H,
                                          int D, int mode) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BM;
  const int r_lo = 64 * wg + 16 * (t / 32) + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  if (mode & TMA) {
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      #pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        st_shared(sm.q() + swz(r_lo + 8 * hf, 8 * j + 2 * (lane % 4), BM),
                  fd::pack_bf16(acc[4 * j + 2 * hf] * f[hf], acc[4 * j + 2 * hf + 1] * f[hf]));
    }
    fence_async_smem();
    named_sync(1 + wg, 128);  // the warpgroup's tile is in shared memory
    if (t == 0 && q0 + 64 * wg < S) {
      for (int cb = 0; cb < DP / 16; ++cb)
        tma_store(maps.out, 16 * cb, h, q0 + 64 * wg, b, sm.q() + cb * BM * 32 + wg * 64 * 32);
      bulk_commit();
      bulk_wait();  // shared memory outlives the stores that read it
    }
  } else {
    const long stride = (long)H * D, qoff = (long)b * S * stride + (long)h * D;
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r_lo + (e / 2) * 8, col = 8 * j + 2 * (lane % 4) + (e & 1);
        if (row < S && col < D) out[qoff + (long)row * stride + col] = __float2bfloat16(acc[4 * j + e] * f[e / 2]);
      }
    }
  }
}

// the two consumer warpgroups issue their products in turns (named
// barriers 3 and 4): while one's are on the tensor cores, the other runs
// its exponentials
__device__ __forceinline__ void my_turn(int wg) { named_sync(3 + wg, NCONS); }
__device__ __forceinline__ void your_turn(int wg, bool last) {
  if (!(last && wg == 1)) named_arrive(3 + (wg ^ 1), NCONS);  // warpgroup 1's last pass has no taker
}

// K1 (lse written where `lse` is not null); MASK: keys masked by
// `maps.kmask` too (the UNet's cross-attention key mask), launched without
// lse only
template <int DP, bool MASK>
__device__ __forceinline__ void fwd_body(const Maps& maps, const bf16* __restrict__ q,
                                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                                         bf16* __restrict__ o, float* __restrict__ lse, int S, int T_,
                                         int H, int D, float scale, int mode) {
  constexpr int BN = KEY_TILE<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const auto sm = start<DP, false>(smem_raw, mode);
  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 < 32) produce(sm, maps, q, k, v, nullptr, S, T_, H, D, mode);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = threadIdx.x % 128, lane = t % 32;
  const uint32_t a_q = sm.q() + wg * 64 * 32;
  const int n_tiles = (T_ + BN - 1) / BN;
  const float sl2 = scale * LOG2E;
  float oacc[DP / 2], sacc[BN / 2];
  uint32_t pa[BN / 16][4];
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  #pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.0f;
  if (wg == 1) named_arrive(3, NCONS);  // warpgroup 0 issues first
  mbar_wait(sm.bar_q(), 0);

  // the masked K1's key mask row of this block's batch element
  const int* kmask = MASK ? maps.kmask + (long)(blockIdx.y / H) * T_ : nullptr;
  uint32_t valid = 0;

  // tile 0's scores; then each step issues tile it's S and tile it-1's P.V
  // together and runs tile it's softmax while P.V is in flight
  mbar_wait(sm.full(0), 0);
  keep(sacc);
  my_turn(wg);
  wg_fence();
  gemm_ss<DP, BN>(sacc, a_q, sm.k(0));
  wg_commit();
  your_turn(wg, false);
  if constexpr (MASK) valid = valid_keys<BN>(kmask, 0, T_, lane);
  wg_wait();
  keep(sacc);
  online_softmax<BN, MASK>(sacc, m2, l, alpha, sl2, T_, lane, valid);
  pack<BN>(sacc, pa);  // o is still 0: nothing to rescale
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % STAGES, sp = (it - 1) % STAGES;
    mbar_wait(sm.full(s), (it / STAGES) & 1);
    my_turn(wg);
    wg_fence();
    gemm_ss<DP, BN>(sacc, a_q, sm.k(s));
    wg_commit();
    gemm_rs<DP, BN>(oacc, pa, sm.v(sp));
    wg_commit();
    your_turn(wg, false);
    if constexpr (MASK) valid = valid_keys<BN>(kmask, it * BN, T_, lane);
    wg_wait<1>();  // S is done; P.V may still run
    keep(sacc);
    online_softmax<BN, MASK>(sacc, m2, l, alpha, sl2, T_ - it * BN, lane, valid);
    wg_wait();
    keep(oacc);
    keep(pa);
    mbar_arrive(sm.empty(sp));
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      oacc[4 * j] *= alpha[0];
      oacc[4 * j + 1] *= alpha[0];
      oacc[4 * j + 2] *= alpha[1];
      oacc[4 * j + 3] *= alpha[1];
    }
    pack<BN>(sacc, pa);
  }
  const int sl = (n_tiles - 1) % STAGES;
  my_turn(wg);
  wg_fence();
  gemm_rs<DP, BN>(oacc, pa, sm.v(sl));
  wg_commit();
  your_turn(wg, true);
  wg_wait();
  keep(oacc);
  keep(pa);
  mbar_arrive(sm.empty(sl));

  // l over the row's quad, clamped; lse = m + log l (natural log, fp32)
  float inv[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    const int row = blockIdx.x * BM + 64 * wg + 16 * (t / 32) + lane / 4 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < S)
      lse[(long)blockIdx.y * S + row] = m2[r] * (1.0f / LOG2E) + logf(l[r]);
    inv[r] = 1.0f / l[r];
  }
  store_out(sm, maps, o, oacc, inv, S, H, D, mode);
}

template <int DP>
__global__ void __launch_bounds__(NTHR, 1)
    flash_fwd_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ q,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse_in,
                     const float* __restrict__ delta, bf16* __restrict__ o, float* __restrict__ lse,
                     int S, int T_, int H, int D, float scale, int mode) {
  fwd_body<DP, false>(maps, q, k, v, o, lse, S, T_, H, D, scale, mode);
}

// the masked K1: instantiated at the UNets' head dims only (MASKED_DP)
template <int DP>
__global__ void __launch_bounds__(NTHR, 1)
    flash_fwd_kernel_masked(const __grid_constant__ Maps maps, const bf16* __restrict__ q,
                            const bf16* __restrict__ k, const bf16* __restrict__ v,
                            const bf16* __restrict__ dout, const float* __restrict__ lse_in,
                            const float* __restrict__ delta, bf16* __restrict__ o, float* __restrict__ lse,
                            int S, int T_, int H, int D, float scale, int mode) {
  fwd_body<DP, true>(maps, q, k, v, o, lse, S, T_, H, D, scale, mode);
}

// ds = p (dp - delta) in place of dp, p = ex2(s sl2 - lse2); keys at or
// past `limit` (< BN on the last tile only) give 0
template <int BN>
__device__ __forceinline__ void dscore(const float (&s)[BN / 2], float (&dp)[BN / 2], const float (&lse2)[2],
                                       const float (&dlt)[2], float sl2, int limit, int lane) {
  #pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], sl2, -lse2[e / 2]));
      const float ds = p * (dp[4 * j + e] - dlt[e / 2]);
      dp[4 * j + e] = limit < BN && 8 * j + 2 * (lane % 4) + (e & 1) >= limit ? 0.0f : ds;
    }
  }
}

// K2: dq = scale dS K, with dS = bf16(p (dO V^T - delta)), p = exp(scale Q
// K^T - lse). Tile j+1's S and dP are issued before tile j's dS.K, and its
// ds is computed while dS.K runs; the warpgroups issue in turns, as in K1
template <int DP>
__global__ void __launch_bounds__(NTHR, 1)
    flash_dq_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ q,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, float* __restrict__ lse_out,
                    int S, int T_, int H, int D, float scale, int mode) {
  constexpr int BN = KEY_TILE<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const auto sm = start<DP, true>(smem_raw, mode);
  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 < 32) produce(sm, maps, q, k, v, dout, S, T_, H, D, mode);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = threadIdx.x % 128, lane = t % 32;
  const uint32_t a_q = sm.q() + wg * 64 * 32, a_do = sm.dout() + wg * 64 * 32;
  const int n_tiles = (T_ + BN - 1) / BN;
  const float sl2 = scale * LOG2E;
  // this thread's two rows: lse in log2 units and delta (0 past S, where q
  // and dO are zero, so ds = 0 there)
  float lse2[2], dlt[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = blockIdx.x * BM + 64 * wg + 16 * (t / 32) + lane / 4 + 8 * r;
    lse2[r] = row < S ? lse[(long)blockIdx.y * S + row] * LOG2E : 0.0f;
    dlt[r] = row < S ? delta[(long)blockIdx.y * S + row] : 0.0f;
  }
  float dqacc[DP / 2], sacc[BN / 2], dpacc[BN / 2];
  uint32_t da[BN / 16][4];
  #pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqacc[i] = 0.0f;
  // issues S and dP of tile `it` (its slot full), in this warpgroup's turn
  auto scores = [&](int it) {
    const int s = it % STAGES;
    mbar_wait(sm.full(s), (it / STAGES) & 1);
    my_turn(wg);
    wg_fence();
    gemm_ss<DP, BN>(sacc, a_q, sm.k(s));
    gemm_ss<DP, BN>(dpacc, a_do, sm.v(s));
    wg_commit();
  };
  if (wg == 1) named_arrive(3, NCONS);  // warpgroup 0 issues first
  mbar_wait(sm.bar_q(), 0);
  keep(sacc);
  keep(dpacc);

  scores(0);
  your_turn(wg, false);
  wg_wait();
  keep(sacc);
  keep(dpacc);
  dscore<BN>(sacc, dpacc, lse2, dlt, sl2, T_, lane);
  pack<BN>(dpacc, da);
  for (int it = 0; it + 1 < n_tiles; ++it) {
    scores(it + 1);  // tile it's ds is packed: S and dP are free
    gemm_rs<DP, BN>(dqacc, da, sm.k(it % STAGES));
    wg_commit();
    your_turn(wg, false);
    wg_wait<1>();  // tile it+1's S and dP are done; dS.K may still run
    keep(sacc);
    keep(dpacc);
    dscore<BN>(sacc, dpacc, lse2, dlt, sl2, T_ - (it + 1) * BN, lane);
    wg_wait();
    keep(dqacc);
    keep(da);
    mbar_arrive(sm.empty(it % STAGES));
    pack<BN>(dpacc, da);
  }
  const int sl = (n_tiles - 1) % STAGES;
  my_turn(wg);
  wg_fence();
  gemm_rs<DP, BN>(dqacc, da, sm.k(sl));
  wg_commit();
  your_turn(wg, true);
  wg_wait();
  keep(dqacc);
  keep(da);
  mbar_arrive(sm.empty(sl));
  const float f[2] = {scale, scale};
  store_out(sm, maps, dq, dqacc, f, S, H, D, mode);
}

}  // namespace qb

// ---------------------------------------------------------------------------
// bf16 key-block backward on wgmma and TMA: K3 (dk, dv) and K6 (dq, dk, dv)
// ---------------------------------------------------------------------------
//
// Replaces `_dkv_pallas` (Pallas body `_bwd_dkv_kernel`) as K3 and
// `_flash_backward_merged` (`_bwd_merged_kernel`) as K6: one template,
// `WITH_DQ` false or true. K6 is K3 plus the dq product.
//
// What bounds it on this card: K3 does four products per (key, q) tile pair
// (S^T, dP^T, P^T.dO, dS^T.Q) and K6 five (plus dS.K), 2*S*T*D flops each,
// against reads of q, k, v, dO once and writes of dk, dv (and dq) once, so
// the tensor cores bound it at D = 80; at D = 40 the exp unit (S*T exp) is
// within 1.3-1.6x of that bound, so the exponentials are one MUFU op each
// (exp2 with log2(e) folded into the scale and into lse).
//
// Design (a warp-specialised block: two key warpgroups, K6's dq warpgroup,
// a producer warpgroup):
// - One block owns BK = 128 keys (64 for K6 above DP = 128, below). Their K
//   and V tiles come into shared memory once, by TMA, and stay there. Each
//   key warpgroup owns 64 keys, wgmma's M.
// - One producer warp streams the 64-row q and dO tiles (TMA) and the lse
//   and delta rows (1-D bulk copies) through a ring of STAGES slots, each
//   marked full and empty by an mbarrier, so no consumer waits on a load it
//   could have overlapped.
// - Every product is a wgmma: S^T = K Q^T and dP^T = V dO^T with both
//   operands in shared memory; dV += bf16(P^T) dO and dK += bf16(dS^T) Q
//   with A from registers (the accumulator of the first pair becomes the A
//   fragment of the second with one bf16 pack). The two
//   warpgroups drift apart where nothing joins them, so one's exponentials
//   run beside the other's products.
// - K6: the key warpgroups write dS^T (bf16, the plain version's rounding)
//   into one of two shared buffers, each marked full and empty by an
//   mbarrier, and go on; a warpgroup of its own computes dQ_tile = dS K
//   over all BK keys (one wgmma chain, both operands read MN-major), stages
//   the fp32 tile in shared memory and adds it into dq's fp32 buffer
//   [B, H, S_pad, D] with one bulk reduce-add (cp.reduce.async.bulk, in
//   L2). No barrier joins the
//   two key warpgroups, as in K3. The reduce-adds' order across key blocks,
//   and so dq's last bits, change from run to run; dk and dv are written
//   once, by one block, in a fixed order, and are bit-equal.
// - Layout (the D = 40 crux): a bf16 row of D = 40 is 80 bytes, which fits
//   no swizzle span. Tiles are kept as column blocks of 16 head-dim values
//   (32 bytes a row, 32-byte swizzle), each loaded by TMA from a 4-D map
//   over (D, H, rows, B) with a 16-wide box at d = 0, 16, 32, ...; the last
//   box's columns past D are out of bounds, and TMA fills them with zeros,
//   the zero pad the products need. Rows past S or T are zero too. dk and
//   dv leave by TMA stores through the same maps, which clip rows and
//   columns. A layout TMA cannot address (a row stride that is not a
//   multiple of 16 bytes, as D = 20 at H = 3, or an unaligned base) takes
//   the same kernel with the producer issuing zero-filling cp.async (plain
//   loads for an odd D) and plain stores of dk and dv.
// - Keys at or past T and q rows at or past S get p = 0 and ds = 0.
// - Sizes, from runs on an H100: BK = 128 (two warpgroups at wgmma's M of
//   64; a third does not fit the registers at D = 40), BQ = 64 (the score
//   products' N; 128 would need 64 more accumulator registers a thread;
//   32 above DP = 128), a ring of 3 slots (2 and 4 were no faster; 2 at DP
//   112-128, for shared memory). K6's dq in a warpgroup of its own beat the key warpgroups
//   computing it between two block-wide barriers, each taking half its
//   columns; each key warpgroup adding its own keys' dq (twice the
//   reduce-add bytes) was slower. Registers (setmaxnreg): key warpgroups
//   232 in K3 and 192 in K6 up to DP = 128 (the dq warpgroup 96, the
//   producer 40 or 32); K6 above, below.
// - K6 above DP = 128 (DP 144 and 160: SD-1.5's 1280-channel transformers
//   at 768 px) is one key warpgroup of 64 keys a block (BK = 64), the dq
//   warpgroup and the producer: 384 threads. The budget, per thread of a
//   warpgroup, of the 512 registers that the warpgroups share (65,536 over
//   128 threads each): two key warpgroups would each hold dK and dV (2 x 80
//   at DP = 160) beside S^T and dP^T (2 x 16 at 32-row q tiles), 232 as in
//   K3, so two of them and an 80-register dQ tile would not fit. One key
//   warpgroup takes its 232, the producer 40, and the dq warpgroup 128 of
//   the 240 left. That warpgroup computes the tile transposed, dQ^T [DP x
//   BQ] = K^T dS^T (M over the head dim in tiles of 64, 3 at DP 144-160; N
//   the 32 q rows of the tile; both operands MN-major, as the same buffers
//   are read for dS K below DP 144), so its accumulator is 3 x 16
//   registers, and it writes the fp32 tile to shared memory transposed
//   back, for the same bulk reduce-add. Its third M tile runs past DP into
//   V's first column blocks; those rows of dQ^T are never stored. It stages
//   the tiles in two fp32 buffers, so that one tile's reduce-add reads one
//   while the next tile is written to the other. Shared memory at DP = 160:
//   K and V 40 KB, three ring slots of 21 KB, two dS^T buffers of 4 KB, two
//   fp32 dQ tiles of 20 KB: 153 KB. The cost of the design:
//   twice the blocks of a 128-key block (576 at [8,576,8,160]: 9 x 64, 4.4
//   waves of 132 SMs, one block an SM) and twice its dq reduce-add bytes.
namespace kv {

// q rows a tile of the ring: 64 up to DP = 128, 32 above, where dK and dV
// take 2 x 80 registers a thread and S^T and dP^T at 64 columns would take
// 64 more than the key warpgroups' 232 hold
template <int DP>
constexpr int Q_TILE = DP <= 128 ? 64 : 32;
// key warpgroups a block, 64 keys each: 2, or 1 for K6 above DP = 128
template <int DP, bool WITH_DQ>
constexpr int KEY_WGS = WITH_DQ && DP > 128 ? 1 : 2;
// + K6's dq warpgroup, + the producer warpgroup (one warp works)
template <int DP, bool WITH_DQ>
constexpr int NTHR = KEY_WGS<DP, WITH_DQ> * 128 + (WITH_DQ ? 256 : 128);

// shared memory of one block, in bytes from a 1024-aligned base
template <int DP, bool WITH_DQ>
struct Smem {
  static constexpr int NWG = KEY_WGS<DP, WITH_DQ>;
  static constexpr int BK = 64 * NWG;                         // keys a block
  static constexpr int NB = DP / 16;                          // column blocks
  static constexpr int BQ = Q_TILE<DP>;
  // 2 slots at DP 112-128 (shared memory); above, the 32-row q tiles leave
  // room for 3 again (K and V 80 KB, a slot 21 KB at DP = 160)
  static constexpr int STAGES = DP <= 96 || DP > 128 ? 3 : 2;
  static constexpr int KV = DP * BK * 2;                      // K (or V) tile
  static constexpr int TILE = DP * BQ * 2;                    // q (or dO) tile
  static constexpr int STAGE = 2 * TILE + 1024;               // q, dO, lse, delta
  static constexpr int K = 0, V = KV, RING = 2 * KV;
  static constexpr int DS = RING + STAGES * STAGE;            // K6: 2 x dS^T [BK x BQ]
  static constexpr int DQ = DS + (WITH_DQ ? 2 * BK * BQ * 2 : 0);  // K6: fp32 [BQ x D], two above DP 128
  static constexpr int BAR = DQ + (WITH_DQ ? (NWG == 1 ? 2 : 1) * BQ * DP * 4 : 0);
  static constexpr int BYTES = BAR + 8 * (5 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "shared memory");
};

struct Maps {
  CUtensorMap q, dout, k, v, dk, dv;
};

template <int DP, bool WITH_DQ>
__global__ void __launch_bounds__(NTHR<DP, WITH_DQ>, 1)
    flash_bwd_kv_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, float* __restrict__ dq32, int S, int T_, int H,
                        int D, float scale, int mode) {
  using L = Smem<DP, WITH_DQ>;
  constexpr int NB = L::NB, STAGES = L::STAGES, BQ = L::BQ, BK = L::BK, NWG = L::NWG;
  constexpr int NCONS = NWG * 128;
  constexpr int PRODUCER = NWG + (WITH_DQ ? 1 : 0);  // warpgroup index
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - fd::smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t base = fd::smem_addr(smem);
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t bar_kv = base + L::BAR;
  auto bar_full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8 * (1 + STAGES + s); };
  // K6: dS^T buffer b written by the key warpgroups / read by the dq warpgroup
  auto bar_ds_full = [&](int b) { return bar_kv + 8 * (1 + 2 * STAGES + b); };
  auto bar_ds_empty = [&](int b) { return bar_kv + 8 * (3 + 2 * STAGES + b); };
  auto s_ds = [&](int b) { return base + L::DS + b * BK * BQ * 2; };
  auto s_q = [&](int s) { return base + L::RING + s * L::STAGE; };
  auto s_do = [&](int s) { return s_q(s) + L::TILE; };
  auto s_lse = [&](int s) { return reinterpret_cast<float*>(smem + L::RING + s * L::STAGE + 2 * L::TILE); };
  auto s_dlt = [&](int s) { return s_lse(s) + BQ; };

  const bool tma = mode & TMA, lse_bulk = mode & LSE_BULK;
  const bool lanes_arrive = !tma || !lse_bulk;  // the producer's lanes arrive on `full`
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BK;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const long koff = (long)b * T_ * stride + (long)h * D;
  const int n_tiles = (S + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, tma ? 1 : 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), (tma ? 1 : 0) + (lanes_arrive ? 32 : 0));
      mbar_init(bar_empty(s), NCONS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_ds_full(b), NCONS);
      mbar_init(bar_ds_empty(b), 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == PRODUCER) {
    // ---- producer ----
    if constexpr (WITH_DQ && NWG == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    }
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    const bool pairs = mode & PAIRS;
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::KV);
        for (int cb = 0; cb < NB; ++cb) {
          tma_load(sK + cb * BK * 32, maps.k, 16 * cb, h, k0, b, bar_kv);
          tma_load(sV + cb * BK * 32, maps.v, 16 * cb, h, k0, b, bar_kv);
        }
      }
    } else {
      copy_tile<DP, BK>(sK, k + koff, stride, k0, T_, D, pairs, lane);
      copy_tile<DP, BK>(sV, v + koff, stride, k0, T_, D, pairs, lane);
      cp_async_wait_all();
      fence_async_smem();
      mbar_arrive(bar_kv);
    }
    const float* lse_b = lse + (long)blockIdx.y * S;
    const float* dlt_b = delta + (long)blockIdx.y * S;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, q0 = it * BQ, rows = min(BQ, S - q0);
      mbar_wait(bar_empty(s), ((it / STAGES) & 1) ^ 1);
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(bar_full(s), 2 * L::TILE + (lse_bulk ? 8 * rows : 0));
          for (int cb = 0; cb < NB; ++cb) {
            tma_load(s_q(s) + cb * BQ * 32, maps.q, 16 * cb, h, q0, b, bar_full(s));
            tma_load(s_do(s) + cb * BQ * 32, maps.dout, 16 * cb, h, q0, b, bar_full(s));
          }
          if (lse_bulk) {
            bulk_load(fd::smem_addr(s_lse(s)), lse_b + q0, 4 * rows, bar_full(s));
            bulk_load(fd::smem_addr(s_dlt(s)), dlt_b + q0, 4 * rows, bar_full(s));
          }
        }
      } else {
        copy_tile<DP, BQ>(s_q(s), q + qoff, stride, q0, S, D, pairs, lane);
        copy_tile<DP, BQ>(s_do(s), dout + qoff, stride, q0, S, D, pairs, lane);
      }
      if (!lse_bulk) {
        for (int r = lane; r < BQ; r += 32) {
          s_lse(s)[r] = r < rows ? lse_b[q0 + r] : 0.0f;
          s_dlt(s)[r] = r < rows ? dlt_b[q0 + r] : 0.0f;
        }
      }
      if (lanes_arrive) {
        if (!tma) {
          cp_async_wait_all();
          fence_async_smem();
        }
        mbar_arrive(bar_full(s));
      }
    }
    return;
  }

  if constexpr (WITH_DQ) {
    if (wg == NWG) {
      // ---- K6's dq warpgroup: dq[tile] = scale dS K over the block's BK
      // keys, A = dS^T and B = K both read MN-major (above DP = 128 the
      // transposed product dQ^T = K^T dS^T, A = K and B = dS^T read
      // MN-major); the fp32 tile is staged in shared memory and added into
      // dq32 by one bulk reduce-add ----
      if constexpr (NWG == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n");
      } else {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 128;\n");
      }
      const int t = threadIdx.x % 128, wi = t / 32, lane = t % 32;
      float* s_dq = reinterpret_cast<float*>(smem + L::DQ);
      const long dq_row0 = (long)blockIdx.y * ((S + DQ_ROWS - 1) / DQ_ROWS * DQ_ROWS);  // dq32: [B, H, S_pad, D]
      for (int it = 0; it < n_tiles; ++it) {
        const int b = it & 1;
        float* stage = s_dq;  // this tile's fp32 staging tile
        mbar_wait(bar_ds_full(b), (it >> 1) & 1);
        if constexpr (NWG == 2) {
          float acc[DP / 2];
          #pragma unroll
          for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
          keep(acc);
          wg_fence();
          #pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            fd::Gmma<DP>::template ss<1, 1>(acc, desc(s_ds(b) + kk * 512, BK * 32, 256),
                                            desc(sK + kk * 512, BK * 32, 256), 1);
          wg_commit();
          wg_wait();
          keep(acc);
          mbar_arrive(bar_ds_empty(b));  // the key warpgroups may overwrite dS^T buffer b
          if (t == 0) bulk_wait_read();  // the previous tile's reduce-add has read s_dq
          named_sync(1, 128);
          // a thread holds column pairs: 8-byte stores (conflict-free at D = 40) where D is even
          #pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            #pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = 16 * wi + lane / 4 + hf * 8, col = 8 * j + 2 * (lane % 4);
              const float x = acc[4 * j + 2 * hf] * scale, y = acc[4 * j + 2 * hf + 1] * scale;
              if (D % 2 == 0) {
                if (col < D) *reinterpret_cast<float2*>(s_dq + row * D + col) = make_float2(x, y);
              } else {
                if (col < D) s_dq[row * D + col] = x;
                if (col + 1 < D) s_dq[row * D + col + 1] = y;
              }
            }
          }
        } else {
          // dQ^T [DP x BQ]: M tile mt holds head-dim rows 64 mt .. + 64, the
          // K tile's column blocks 4 mt .. + 4 (past DP: V's, never stored)
          constexpr int MT = (DP + 63) / 64;
          float acc[MT][BQ / 2];
          #pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            #pragma unroll
            for (int i = 0; i < BQ / 2; ++i) acc[mt][i] = 0.0f;
            keep(acc[mt]);
          }
          wg_fence();
          #pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            #pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              fd::Gmma<BQ>::template ss<1, 1>(acc[mt], desc(sK + 4 * mt * BK * 32 + kk * 512, BK * 32, 256),
                                              desc(s_ds(b) + kk * 512, BK * 32, 256), 1);
          }
          wg_commit();
          wg_wait();
          #pragma unroll
          for (int mt = 0; mt < MT; ++mt) keep(acc[mt]);
          mbar_arrive(bar_ds_empty(b));  // the key warpgroups may overwrite dS^T buffer b
          stage = s_dq + b * BQ * DP;  // two staging tiles: tile it - 1's reduce-add may still read the other
          if (t == 0) bulk_wait_read<1>();  // tile it - 2's reduce-add has read this one
          named_sync(1, 128);
          // transposed back: element (d, q) of dQ^T to row q, column d
          #pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            #pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
              #pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int d = 64 * mt + 16 * wi + lane / 4 + (e / 2) * 8, q = 8 * j + 2 * (lane % 4) + (e & 1);
                if (d < D) stage[q * D + d] = acc[mt][4 * j + e] * scale;
              }
            }
          }
        }
        fence_async_smem();
        named_sync(2, 128);  // the fp32 dq tile is in shared memory
        if (t == 0) {
          bulk_reduce_add(dq32 + (dq_row0 + it * BQ) * D, fd::smem_addr(stage), BQ * D * 4);
          bulk_commit();
        }
      }
      if (t == 0) bulk_wait();  // shared memory outlives the last reduce-add
      return;
    }
  }

  // ---- key warpgroups: warpgroup `wg` owns keys k0 + 64 wg .. + 64 ----
  if constexpr (WITH_DQ && NWG == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  }
  const int ct = threadIdx.x;  // 0 .. NCONS - 1
  const int wi = (ct % 128) / 32, lane = ct % 32;
  const int r_lo = 64 * wg + 16 * wi + lane / 4;  // this thread's two key rows: r_lo, r_lo + 8
  const bool key_ok[2] = {k0 + r_lo < T_, k0 + r_lo + 8 < T_};
  const bool k_partial = k0 + BK > T_;
  const float sl2 = scale * LOG2E;
  const uint32_t a_k = sK + wg * 64 * 32, a_v = sV + wg * 64 * 32;

  float dkacc[DP / 2], dvacc[DP / 2];
  #pragma unroll
  for (int i = 0; i < DP / 2; ++i) dkacc[i] = dvacc[i] = 0.0f;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, q0 = it * BQ;
    mbar_wait(bar_full(s), (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: rows this warpgroup's keys, columns the tile's q rows
    float sacc[BQ / 2], dpacc[BQ / 2];
    keep(sacc);
    keep(dpacc);
    wg_fence();
    #pragma unroll
    for (int ks = 0; ks < NB; ++ks)
      fd::Gmma<BQ>::template ss<0, 0>(sacc, desc(a_k + ks * BK * 32, 16, 256),
                                      desc(s_q(s) + ks * BQ * 32, 16, 256), ks > 0);
    #pragma unroll
    for (int ks = 0; ks < NB; ++ks)
      fd::Gmma<BQ>::template ss<0, 0>(dpacc, desc(a_v + ks * BK * 32, 16, 256),
                                      desc(s_do(s) + ks * BQ * 32, 16, 256), ks > 0);
    wg_commit();
    wg_wait();
    keep(sacc);
    keep(dpacc);

    // p = exp2(scale log2e s - log2e lse), ds = p (dp - delta); masked where a
    // key or a q row is out of range (select, not product: the stale lse and
    // delta past S are not finite for sure)
    const float* lse_s = s_lse(s);
    const float* dlt_s = s_dlt(s);
    const bool masked = k_partial || q0 + BQ > S;
    #pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 lv = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(dlt_s + c);
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = (e & 1) ? lv.y : lv.x, dd = (e & 1) ? dl.y : dl.x;
        float p = ex2(fmaf(sacc[4 * j + e], sl2, -l2 * LOG2E));
        float ds = p * (dpacc[4 * j + e] - dd);
        if (masked) {
          const bool ok = q0 + c + (e & 1) < S && key_ok[e / 2];
          p = ok ? p : 0.0f;
          ds = ok ? ds : 0.0f;
        }
        sacc[4 * j + e] = p;
        dpacc[4 * j + e] = ds;
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    #pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = fd::pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
        da[kk][i] = fd::pack_bf16(dpacc[8 * kk + 2 * i], dpacc[8 * kk + 2 * i + 1]);
      }
    }
    if constexpr (WITH_DQ) {
      // dS^T [BK keys x BQ q] to buffer it % 2, column blocks of 16 q, once
      // the dq warpgroup is done with the tile that used it before
      const int b = it & 1;
      mbar_wait(bar_ds_empty(b), ((it >> 1) & 1) ^ 1);
      #pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          st_shared(s_ds(b) + swz(r_lo + (i & 1) * 8, 16 * kk + (i / 2) * 8 + 2 * (lane % 4), BK), da[kk][i]);
      }
      fence_async_smem();
      mbar_arrive(bar_ds_full(b));
    }
    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: A from registers, B (dO, Q) MN-major
    wg_fence();
    #pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      fd::Gmma<DP>::template rs<1>(dvacc, pa[kk], desc(s_do(s) + kk * 512, BQ * 32, 256), 1);
    #pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      fd::Gmma<DP>::template rs<1>(dkacc, da[kk], desc(s_q(s) + kk * 512, BQ * 32, 256), 1);
    wg_commit();

    wg_wait();
    keep(pa);
    keep(da);
    keep(dvacc);
    keep(dkacc);
    mbar_arrive(bar_empty(s));  // q, dO, lse and delta of slot s are free
  }

  // ---- epilogue: dk = scale dK, dv = dV, bf16, each written once ----
  if constexpr (WITH_DQ) {
    // the dq warpgroup's last product, the last reader of K, is done
    mbar_wait(bar_ds_empty((n_tiles - 1) & 1), ((n_tiles - 1) >> 1) & 1);
  }
  if (tma) {
    named_sync(3, NCONS);  // no wgmma reads K or V any more: their tiles take dk and dv
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      #pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t off = swz(r_lo + 8 * hf, 8 * j + 2 * (lane % 4), BK);
        st_shared(sK + off, fd::pack_bf16(dkacc[4 * j + 2 * hf] * scale, dkacc[4 * j + 2 * hf + 1] * scale));
        st_shared(sV + off, fd::pack_bf16(dvacc[4 * j + 2 * hf], dvacc[4 * j + 2 * hf + 1]));
      }
    }
    fence_async_smem();
    named_sync(4, NCONS);
    if (ct == 0) {
      for (int cb = 0; cb < NB; ++cb) {
        tma_store(maps.dk, 16 * cb, h, k0, b, sK + cb * BK * 32);
        tma_store(maps.dv, 16 * cb, h, k0, b, sV + cb * BK * 32);
      }
      bulk_commit();
    }
  } else {
    #pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = k0 + r_lo + (e / 2) * 8, col = 8 * j + 2 * (lane % 4) + (e & 1);
        if (row < T_ && col < D) {
          const long off = koff + (long)row * stride + col;
          dk[off] = __float2bfloat16(dkacc[4 * j + e] * scale);
          dv[off] = __float2bfloat16(dvacc[4 * j + e]);
        }
      }
    }
  }
  if (ct == 0) bulk_wait();  // shared memory outlives the TMA stores that read it
}

}  // namespace kv

// ---------------------------------------------------------------------------
// fp32: the simple versions, every tile through shared memory
// ---------------------------------------------------------------------------

// C[M x N] (+)= A[M x K] . B[N x K]^T
__device__ void mm_nt(const float* A, int lda, const float* B, int ldb, float* C,
                      int ldc, int M, int N, int K, bool accumulate = false) {
  for (int idx = threadIdx.x; idx < M * N; idx += NTHREADS) {
    const int i = idx / N, j = idx % N;
    float s = accumulate ? C[i * ldc + j] : 0.0f;
    for (int kk = 0; kk < K; ++kk) s = fmaf(A[i * lda + kk], B[j * ldb + kk], s);
    C[i * ldc + j] = s;
  }
}

// C[M x N] (+)= A[M x K] . B[K x N]
__device__ void mm_nn(const float* A, int lda, const float* B, int ldb, float* C,
                      int ldc, int M, int N, int K, bool accumulate = false) {
  for (int idx = threadIdx.x; idx < M * N; idx += NTHREADS) {
    const int i = idx / N, j = idx % N;
    float s = accumulate ? C[i * ldc + j] : 0.0f;
    for (int kk = 0; kk < K; ++kk) s = fmaf(A[i * lda + kk], B[kk * ldb + j], s);
    C[i * ldc + j] = s;
  }
}

__device__ void load_tile_f32(float* dst, const float* src, long stride, int row0,
                              int rows, int n_rows, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    dst[idx] = row0 + r < n_rows ? src[(long)(row0 + r) * stride + c] : 0.0f;
  }
}

size_t smem_f32(int D) { return sizeof(float) * (5 * BM * D + BM * BN + 3 * BM); }

// kmask: a key mask [B, T] (int32, 0 masks the key) or null
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, const int* __restrict__ kmask, int S, int T_, int H,
                         int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [BM x D]
  float* sK = sQ + BM * D;                     // [BN x D]
  float* sV = sK + BN * D;                     // [BN x D]
  float* sS = sV + BN * D;                     // [BM x BN] scores, then p
  float* sO = sS + BM * BN;                    // [BM x D] output accumulator
  float* sT = sO + BM * D;                     // [BM x D] this tile's p.v
  float* sM = sT + BM * D;                     // [BM] running max
  float* sL = sM + BM;                         // [BM] running sum
  float* sAlpha = sL + BM;                     // [BM] rescale of this tile

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const long stride = (long)H * D;
  const float* qb = q + (long)b * S * stride + (long)h * D;
  const float* kb = k + (long)b * T_ * stride + (long)h * D;
  const float* vb = v + (long)b * T_ * stride + (long)h * D;
  float* ob = o + (long)b * S * stride + (long)h * D;
  const int* km = kmask != nullptr ? kmask + (long)b * T_ : nullptr;
  const int tid = threadIdx.x;

  load_tile_f32(sQ, qb, stride, q0, BM, S, D);
  for (int idx = tid; idx < BM * D; idx += NTHREADS) sO[idx] = 0.0f;
  for (int r = tid; r < BM; r += NTHREADS) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }
  for (int k0 = 0; k0 < T_; k0 += BN) {
    __syncthreads();
    load_tile_f32(sK, kb, stride, k0, BN, T_, D);
    load_tile_f32(sV, vb, stride, k0, BN, T_, D);
    __syncthreads();
    mm_nt(sQ, D, sK, D, sS, BN, BM, BN, D);
    __syncthreads();
    {
      // two neighbouring threads share a row, 32 keys each
      const int r = tid >> 1, c0 = (tid & 1) * (BN / 2);
      float* srow = sS + r * BN;
      float mx = -INFINITY;
      for (int c = c0; c < c0 + BN / 2; ++c) {
        const bool valid = k0 + c < T_ && (km == nullptr || km[k0 + c] != 0);
        const float s = valid ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      // a key mask can mask a row's every key so far: subtract 0, not -inf
      const float m_sub = m_new == -INFINITY ? 0.0f : m_new;
      float sum = 0.0f;
      for (int c = c0; c < c0 + BN / 2; ++c) {
        srow[c] = expf(srow[c] - m_sub);
        sum += srow[c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both threads of the row have read sM[r]
      if ((tid & 1) == 0) {
        const float alpha = expf(m_prev - m_sub);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    mm_nn(sS, BN, sV, D, sT, D, BM, D, BN);
    __syncthreads();
    for (int idx = tid; idx < BM * D; idx += NTHREADS)
      sO[idx] = sO[idx] * sAlpha[idx / D] + sT[idx];
  }
  __syncthreads();
  for (int idx = tid; idx < BM * D; idx += NTHREADS) {
    const int r = idx / D;
    if (q0 + r < S) ob[(long)(q0 + r) * stride + idx % D] = sO[idx] / fmaxf(sL[r], 1e-30f);
  }
  if (lse != nullptr)
    for (int r = tid; r < BM; r += NTHREADS)
      if (q0 + r < S) lse[(long)blockIdx.y * S + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

// QM q rows a block: 64, or 32 above D = 128 (shared memory)
template <int QM>
size_t smem_dq_f32(int D) { return sizeof(float) * (2 * QM * D + 2 * BN * D + QM * D + 2 * QM * BN + 2 * QM); }

template <int QM>
__global__ void __launch_bounds__(NTHREADS)
    flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int T_, int H, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [QM x D]
  float* sDO = sQ + QM * D;                    // [QM x D]
  float* sK = sDO + QM * D;                    // [BN x D]
  float* sV = sK + BN * D;                     // [BN x D]
  float* sAcc = sV + BN * D;                   // [QM x D] dq accumulator
  float* sS = sAcc + QM * D;                   // [QM x BN] scores, then ds
  float* sDP = sS + QM * BN;                   // [QM x BN] dO v^T
  float* sLse = sDP + QM * BN;                 // [QM]
  float* sDlt = sLse + QM;                     // [QM]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * QM;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const float* kb = k + (long)b * T_ * stride + (long)h * D;
  const float* vb = v + (long)b * T_ * stride + (long)h * D;
  const int tid = threadIdx.x;

  load_tile_f32(sQ, q + qoff, stride, q0, QM, S, D);
  load_tile_f32(sDO, dout + qoff, stride, q0, QM, S, D);
  for (int idx = tid; idx < QM * D; idx += NTHREADS) sAcc[idx] = 0.0f;
  for (int r = tid; r < QM; r += NTHREADS) {
    sLse[r] = q0 + r < S ? lse[(long)blockIdx.y * S + q0 + r] : 0.0f;
    sDlt[r] = q0 + r < S ? delta[(long)blockIdx.y * S + q0 + r] : 0.0f;
  }
  for (int k0 = 0; k0 < T_; k0 += BN) {
    __syncthreads();
    load_tile_f32(sK, kb, stride, k0, BN, T_, D);
    load_tile_f32(sV, vb, stride, k0, BN, T_, D);
    __syncthreads();
    mm_nt(sQ, D, sK, D, sS, BN, QM, BN, D);
    mm_nt(sDO, D, sV, D, sDP, BN, QM, BN, D);
    __syncthreads();
    for (int idx = tid; idx < QM * BN; idx += NTHREADS) {
      const int r = idx / BN, c = idx % BN;
      const float p = k0 + c < T_ ? expf(sS[idx] * scale - sLse[r]) : 0.0f;
      sS[idx] = p * (sDP[idx] - sDlt[r]);
    }
    __syncthreads();
    mm_nn(sS, BN, sK, D, sAcc, D, QM, D, BN, true);
  }
  __syncthreads();
  for (int idx = tid; idx < QM * D; idx += NTHREADS) {
    const int r = idx / D;
    if (q0 + r < S) dq[qoff + (long)(q0 + r) * stride + idx % D] = sAcc[idx] * scale;
  }
}

constexpr int FQ = 32;  // q rows per step of the fp32 dk/dv kernel
size_t smem_dkv_f32(int D) { return sizeof(float) * (4 * BN * D + 2 * FQ * D + 2 * BN * FQ + 2 * FQ); }

__global__ void __launch_bounds__(NTHREADS)
    flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int T_, int H,
                         int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [BN x D]
  float* sV = sK + BN * D;                     // [BN x D]
  float* sDK = sV + BN * D;                    // [BN x D] accumulators
  float* sDV = sDK + BN * D;                   // [BN x D]
  float* sQ = sDV + BN * D;                    // [FQ x D]
  float* sDO = sQ + FQ * D;                    // [FQ x D]
  float* sP = sDO + FQ * D;                    // [BN x FQ] p^T
  float* sDS = sP + BN * FQ;                   // [BN x FQ] dp^T, then ds^T
  float* sLse = sDS + BN * FQ;                 // [FQ]
  float* sDlt = sLse + FQ;                     // [FQ]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BN;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const long koff = (long)b * T_ * stride + (long)h * D;
  const int tid = threadIdx.x;

  load_tile_f32(sK, k + koff, stride, k0, BN, T_, D);
  load_tile_f32(sV, v + koff, stride, k0, BN, T_, D);
  for (int idx = tid; idx < BN * D; idx += NTHREADS) sDK[idx] = sDV[idx] = 0.0f;
  for (int q0 = 0; q0 < S; q0 += FQ) {
    __syncthreads();
    load_tile_f32(sQ, q + qoff, stride, q0, FQ, S, D);
    load_tile_f32(sDO, dout + qoff, stride, q0, FQ, S, D);
    for (int r = tid; r < FQ; r += NTHREADS) {
      sLse[r] = q0 + r < S ? lse[(long)blockIdx.y * S + q0 + r] : 0.0f;
      sDlt[r] = q0 + r < S ? delta[(long)blockIdx.y * S + q0 + r] : 0.0f;
    }
    __syncthreads();
    mm_nt(sK, D, sQ, D, sP, FQ, BN, FQ, D);
    mm_nt(sV, D, sDO, D, sDS, FQ, BN, FQ, D);
    __syncthreads();
    for (int idx = tid; idx < BN * FQ; idx += NTHREADS) {
      const int c = idx % FQ;
      const float p = q0 + c < S ? expf(sP[idx] * scale - sLse[c]) : 0.0f;
      sP[idx] = p;
      sDS[idx] = p * (sDS[idx] - sDlt[c]);
    }
    __syncthreads();
    mm_nn(sP, FQ, sDO, D, sDV, D, BN, D, FQ, true);
    mm_nn(sDS, FQ, sQ, D, sDK, D, BN, D, FQ, true);
  }
  __syncthreads();
  for (int idx = tid; idx < BN * D; idx += NTHREADS) {
    const int r = idx / D;
    if (k0 + r < T_) {
      const long off = koff + (long)(k0 + r) * stride + idx % D;
      dk[off] = sDK[idx] * scale;
      dv[off] = sDV[idx];
    }
  }
}

// K6 in fp32: the dk/dv kernel above (64 keys a block, shared-memory
// limited) plus each q step's dq contribution scale * ds k, added with
// atomicAdd into dq32 [B, H, S_pad, D] (S_pad: S rounded up to 64, the
// layout of the bf16 body's bulk adds)
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_merged_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                float* __restrict__ dq32, int S, int T_, int H, int D,
                                float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [BN x D]
  float* sV = sK + BN * D;                     // [BN x D]
  float* sDK = sV + BN * D;                    // [BN x D] accumulators
  float* sDV = sDK + BN * D;                   // [BN x D]
  float* sQ = sDV + BN * D;                    // [FQ x D]
  float* sDO = sQ + FQ * D;                    // [FQ x D]
  float* sP = sDO + FQ * D;                    // [BN x FQ] p^T
  float* sDS = sP + BN * FQ;                   // [BN x FQ] dp^T, then ds^T
  float* sLse = sDS + BN * FQ;                 // [FQ]
  float* sDlt = sLse + FQ;                     // [FQ]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BN;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const long koff = (long)b * T_ * stride + (long)h * D;
  const int tid = threadIdx.x;
  const long s_pad = (S + DQ_ROWS - 1) / DQ_ROWS * DQ_ROWS;

  load_tile_f32(sK, k + koff, stride, k0, BN, T_, D);
  load_tile_f32(sV, v + koff, stride, k0, BN, T_, D);
  for (int idx = tid; idx < BN * D; idx += NTHREADS) sDK[idx] = sDV[idx] = 0.0f;
  for (int q0 = 0; q0 < S; q0 += FQ) {
    __syncthreads();
    load_tile_f32(sQ, q + qoff, stride, q0, FQ, S, D);
    load_tile_f32(sDO, dout + qoff, stride, q0, FQ, S, D);
    for (int r = tid; r < FQ; r += NTHREADS) {
      sLse[r] = q0 + r < S ? lse[(long)blockIdx.y * S + q0 + r] : 0.0f;
      sDlt[r] = q0 + r < S ? delta[(long)blockIdx.y * S + q0 + r] : 0.0f;
    }
    __syncthreads();
    mm_nt(sK, D, sQ, D, sP, FQ, BN, FQ, D);
    mm_nt(sV, D, sDO, D, sDS, FQ, BN, FQ, D);
    __syncthreads();
    for (int idx = tid; idx < BN * FQ; idx += NTHREADS) {
      const int r = idx / FQ, c = idx % FQ;
      const float p = (q0 + c < S && k0 + r < T_) ? expf(sP[idx] * scale - sLse[c]) : 0.0f;
      sP[idx] = p;
      sDS[idx] = p * (sDS[idx] - sDlt[c]);
    }
    __syncthreads();
    mm_nn(sP, FQ, sDO, D, sDV, D, BN, D, FQ, true);
    mm_nn(sDS, FQ, sQ, D, sDK, D, BN, D, FQ, true);
    for (int idx = tid; idx < FQ * D; idx += NTHREADS) {
      const int c = idx / D, d = idx % D;
      if (q0 + c >= S) continue;
      float s = 0.0f;
      for (int r = 0; r < BN; ++r) s = fmaf(sDS[r * FQ + c], sK[r * D + d], s);
      atomicAdd(dq32 + ((long)blockIdx.y * s_pad + q0 + c) * D + d, s * scale);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BN * D; idx += NTHREADS) {
    const int r = idx / D;
    if (k0 + r < T_) {
      const long off = koff + (long)(k0 + r) * stride + idx % D;
      dk[off] = sDK[idx] * scale;
      dv[off] = sDV[idx];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K1 (lse_out may be null), the masked K1 (MASK: kmask [B, T], no lse) or
// K2 (BWD): TMA where every tensor is 16-byte aligned and its row stride
// (H * D * 2 bytes) and head stride (D * 2) are multiples of 16 bytes;
// otherwise the same kernel's cp.async producer
template <int DP, bool BWD, bool MASK = false>
int launch_q(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse_in,
             const float* delta, bf16* out, float* lse_out, int B, int S, int T_, int H, int D, float scale,
             cudaStream_t stream, const int* kmask = nullptr) {
  using L = qb::Smem<DP, BWD>;
  const auto kernel = [] {
    if constexpr (BWD) return qb::flash_dq_kernel<DP>;
    else if constexpr (MASK) return qb::flash_fwd_kernel_masked<DP>;
    else return qb::flash_fwd_kernel<DP>;
  }();
  if (int err = set_smem(kernel, L::BYTES)) return err;
  const auto aligned4 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; };
  const bool tma = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
                   (!BWD || aligned16(dout));
  const bool pairs = D % 2 == 0 && aligned4(q) && aligned4(k) && aligned4(v) && (!BWD || aligned4(dout));
  qb::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (tma && !(tensor_map(&maps.q, q, B, S, H, D, 64) && tensor_map(&maps.out, out, B, S, H, D, 64) &&
               tensor_map(&maps.k, k, B, T_, H, D, L::BN) && tensor_map(&maps.v, v, B, T_, H, D, L::BN) &&
               (!BWD || tensor_map(&maps.dout, dout, B, S, H, D, 64))))
    return (int)cudaErrorInvalidValue;
  maps.kmask = kmask;
  const int mode = (tma ? TMA : 0) | (pairs ? PAIRS : 0);
  const dim3 grid((S + qb::BM - 1) / qb::BM, B * H);
  kernel<<<grid, qb::NTHR, L::BYTES, stream>>>(maps, q, k, v, dout, lse_in, delta, out, lse_out, S, T_, H, D,
                                              scale, mode);
  return (int)cudaGetLastError();
}

// K3 (dq32 == nullptr) or K6: TMA where every tensor is 16-byte aligned and
// its row stride (H * D * 2 bytes) and head stride (D * 2) are multiples of
// 16 bytes; otherwise the same kernel's cp.async producer
template <int DP, bool WITH_DQ>
int launch_bwd_kv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                  const float* delta, bf16* dk, bf16* dv, float* dq32, int B, int S, int T_, int H,
                  int D, float scale, cudaStream_t stream) {
  using L = kv::Smem<DP, WITH_DQ>;
  auto kernel = kv::flash_bwd_kv_kernel<DP, WITH_DQ>;
  const size_t smem = L::BYTES;
  if (int err = set_smem(kernel, smem)) return err;
  const auto aligned4 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; };
  const bool tma = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                   aligned16(dk) && aligned16(dv);
  const bool lse_bulk = tma && S % 4 == 0 && aligned16(lse) && aligned16(delta);
  const bool pairs = D % 2 == 0 && aligned4(q) && aligned4(k) && aligned4(v) && aligned4(dout);
  kv::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (tma && !(tensor_map(&maps.q, q, B, S, H, D, L::BQ) && tensor_map(&maps.dout, dout, B, S, H, D, L::BQ) &&
               tensor_map(&maps.k, k, B, T_, H, D, L::BK) && tensor_map(&maps.v, v, B, T_, H, D, L::BK) &&
               tensor_map(&maps.dk, dk, B, T_, H, D, L::BK) && tensor_map(&maps.dv, dv, B, T_, H, D, L::BK)))
    return (int)cudaErrorInvalidValue;
  const int mode = (tma ? TMA : 0) | (lse_bulk ? LSE_BULK : 0) | (pairs ? PAIRS : 0);
  const dim3 grid((T_ + L::BK - 1) / L::BK, B * H);
  kernel<<<grid, kv::NTHR<DP, WITH_DQ>, smem, stream>>>(maps, q, k, v, dout, lse, delta, dk, dv, dq32, S, T_, H, D,
                                           scale, mode);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int T_, int H, int D) {
  return B < 1 || S < 1 || T_ < 1 || H < 1 || D < 1 || D > MAX_D || (long)B * H > 65535;
}

// one instantiation per head dim padded to the mma depth: 16 .. 160
#define FD_DISPATCH_DP(D, CALL)                      \
  switch (((D) + 15) / 16) {                         \
    case 1: { constexpr int DP = 16; return CALL; }  \
    case 2: { constexpr int DP = 32; return CALL; }  \
    case 3: { constexpr int DP = 48; return CALL; }  \
    case 4: { constexpr int DP = 64; return CALL; }  \
    case 5: { constexpr int DP = 80; return CALL; }  \
    case 6: { constexpr int DP = 96; return CALL; }  \
    case 7: { constexpr int DP = 112; return CALL; } \
    case 8: { constexpr int DP = 128; return CALL; } \
    case 9: { constexpr int DP = 144; return CALL; } \
    default: { constexpr int DP = 160; return CALL; } \
  }

// the masked K1's instantiations: the UNets' head dims padded to the mma
// depth (SD's 40, 80 and 160, SDXL's 64; the CPU-sized UNets' 16 and 32)
#define FD_DISPATCH_MASKED_DP(D, CALL)               \
  switch (((D) + 15) / 16) {                         \
    case 1: { constexpr int DP = 16; return CALL; }  \
    case 2: { constexpr int DP = 32; return CALL; }  \
    case 3: { constexpr int DP = 48; return CALL; }  \
    case 4: { constexpr int DP = 64; return CALL; }  \
    case 5: { constexpr int DP = 80; return CALL; }  \
    case 10: { constexpr int DP = 160; return CALL; } \
    default: return (int)cudaErrorInvalidValue;      \
  }

int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
             int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  FD_DISPATCH_DP(D, (launch_q<DP, false>(qq, kk, vv, nullptr, nullptr, nullptr, oo, lse, B, S, T, H, D, scale, st)));
}

int fwd_masked_bf16(const void* q, const void* k, const void* v, void* o, const int* kmask, int B,
                    int S, int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D) || kmask == nullptr) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  FD_DISPATCH_MASKED_DP(D, (launch_q<DP, false, true>(qq, kk, vv, nullptr, nullptr, nullptr, oo, nullptr, B, S, T,
                                                       H, D, scale, st, kmask)));
}

int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, const int* kmask, int B,
            int S, int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_f32(D);
  if (int err = set_smem(flash_fwd_f32_kernel, smem)) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_f32_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kmask, S, T, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fd_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                 int B, int S, int T, int H, int D, float scale,
                                 void* stream) {
  return fwd_bf16(q, k, v, o, nullptr, B, S, T, H, D, scale, stream);
}

extern "C" int fd_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                int B, int S, int T, int H, int D, float scale,
                                void* stream) {
  return fwd_f32(q, k, v, o, nullptr, nullptr, B, S, T, H, D, scale, stream);
}

// the forward with a key mask [B, T] (int32, 0 masks the key; a row keeps
// at least one key), without lse
extern "C" int fd_flash_fwd_masked_bf16(const void* q, const void* k, const void* v, void* o,
                                        const void* kmask, int B, int S, int T, int H, int D,
                                        float scale, void* stream) {
  return fwd_masked_bf16(q, k, v, o, static_cast<const int*>(kmask), B, S, T, H, D, scale, stream);
}

extern "C" int fd_flash_fwd_masked_f32(const void* q, const void* k, const void* v, void* o,
                                       const void* kmask, int B, int S, int T, int H, int D,
                                       float scale, void* stream) {
  return fwd_f32(q, k, v, o, nullptr, static_cast<const int*>(kmask), B, S, T, H, D, scale, stream);
}

// the forward that also writes lse [B, H, S] fp32 (the backward's input)
extern "C" int fd_flash_fwd_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int S, int T, int H, int D, float scale,
                                     void* stream) {
  return fwd_bf16(q, k, v, o, static_cast<float*>(lse), B, S, T, H, D, scale, stream);
}

extern "C" int fd_flash_fwd_lse_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int S, int T, int H, int D, float scale,
                                    void* stream) {
  return fwd_f32(q, k, v, o, static_cast<float*>(lse), nullptr, B, S, T, H, D, scale, stream);
}

extern "C" int fd_flash_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int S,
                                int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  const auto* dd = static_cast<const bf16*>(dout);
  const auto* ll = static_cast<const float*>(lse);
  const auto* de = static_cast<const float*>(delta);
  auto* out = static_cast<bf16*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  FD_DISPATCH_DP(D, (launch_q<DP, true>(qq, kk, vv, dd, ll, de, out, nullptr, B, S, T, H, D, scale, st)));
}

extern "C" int fd_flash_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B,
                                 int S, int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  const auto* dd = static_cast<const bf16*>(dout);
  const auto* ll = static_cast<const float*>(lse);
  const auto* de = static_cast<const float*>(delta);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  FD_DISPATCH_DP(D, (launch_bwd_kv<DP, false>(qq, kk, vv, dd, ll, de, gk, gv, nullptr, B, S, T, H,
                                                  D, scale, st)));
}

template <int QM>
int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int B, int S, int T, int H, int D, float scale, void* stream) {
  const size_t smem = smem_dq_f32<QM>(D);
  if (int err = set_smem(flash_dq_f32_kernel<QM>, smem)) return err;
  const dim3 grid((S + QM - 1) / QM, B * H);
  flash_dq_f32_kernel<QM><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, T, H, D, scale);
  return (int)cudaGetLastError();
}

extern "C" int fd_flash_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int S,
                               int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  return D <= 128 ? dq_f32<BM>(q, k, v, dout, lse, delta, dq, B, S, T, H, D, scale, stream)
                  : dq_f32<BM / 2>(q, k, v, dout, lse, delta, dq, B, S, T, H, D, scale, stream);
}

extern "C" int fd_flash_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int S, int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_dkv_f32(D);
  if (int err = set_smem(flash_dkv_f32_kernel, smem)) return err;
  const dim3 grid((T + BN - 1) / BN, B * H);
  flash_dkv_f32_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S, T,
      H, D, scale);
  return (int)cudaGetLastError();
}

// K6: dk, dv and the fp32 dq sum in one pass; dq32 [B, H, S_pad, D] (S_pad: S
// rounded up to 64) must be zero
extern "C" int fd_flash_bwd_merged_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, void* dq32, int B, int S, int T,
                                        int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  const auto* dd = static_cast<const bf16*>(dout);
  const auto* ll = static_cast<const float*>(lse);
  const auto* de = static_cast<const float*>(delta);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  auto* gq = static_cast<float*>(dq32);
  auto st = static_cast<cudaStream_t>(stream);
  FD_DISPATCH_DP(D, (launch_bwd_kv<DP, true>(qq, kk, vv, dd, ll, de, gk, gv, gq, B, S, T, H, D, scale, st)));
}

extern "C" int fd_flash_bwd_merged_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, void* dq32, int B, int S, int T, int H,
                                       int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_dkv_f32(D);
  if (int err = set_smem(flash_bwd_merged_f32_kernel, smem)) return err;
  const dim3 grid((T + BN - 1) / BN, B * H);
  flash_bwd_merged_f32_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq32), S, T, H, D, scale);
  return (int)cudaGetLastError();
}
