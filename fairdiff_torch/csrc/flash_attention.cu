// Flash attention (non-causal) for Hopper, sm_90a: the forward (K1, with or
// without lse), the split backward (K2 dq, K3 dk/dv) and the merged backward
// (K6 dq+dk+dv in one pass).
//
// Replaces: fairdiff/ops/flash_attention.py `_flash_forward` (Pallas bodies
// `_flash_kernel` and `_flash_kernel_pipe`, identical maths; `with_lse` for
// the backward), `_dq_pallas` (`_bwd_dq_kernel`), `_dkv_pallas`
// (`_bwd_dkv_kernel`) and `_flash_backward_merged` (`_bwd_merged_kernel`).
// The backward kernels are described above them below; K3 and K6 are one
// Hopper kernel (wgmma products, tiles fed by TMA).
//
// Computes o = softmax(scale * q k^T) v for q [B,S,H,D], k/v [B,T,H,D], all
// contiguous, read in place with a row stride of H*D (no relayout copy and no
// padded copy in device memory). Numerics follow the TPU kernel: fp32 scores
// with `scale` applied to them (not to q), fp32 running max m, sum l and
// accumulator, p rounded to the input type before p.v, keys >= T masked to
// -inf, l clamped at 1e-30.
//
// What bounds it on this card: at the UNet shapes (S = T = 4096, D = 40 and
// S = T = 1024, D = 80) the two products are 4*S*T*D flops per (b, h) against
// 2*(2*S + 2*T)*D bytes, several hundred flops per byte, so the tensor cores
// bound it. The bf16 kernel keeps everything but the K/V tiles in registers
// (the FlashAttention-2 arrangement): one block of four warps per (b*h,
// 64-row q tile), each warp owning 16 q rows; q fragments are loaded once,
// then for every 64-key tile the scores come from mma.sync m16n8k16 with
// ldmatrix operands, the online softmax runs on each row's four threads with
// shuffles, and the rounded probabilities feed the p.v mma.sync straight from
// the score registers. D is zero-padded to a multiple of 16 (the MMA depth)
// in shared memory only: 40 -> 48, 80 -> 80. Not yet done: cp.async/TMA
// double buffering of K/V and wgmma.
//
// The fp32 kernel is the simple version (every tile through shared memory,
// CUDA-core fmaf); it serves the full-precision parity check, not the hot
// path.
#include <cuda.h>  // CUtensorMap (the encoder is found at run time)

#include <cstring>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fd::ldmatrix_x4;
using fd::ldmatrix_x4_trans;
using fd::mma_16816;
using fd::pack_bf16;

constexpr int BM = 64;         // q rows per block (16 per warp)
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // four warps
constexpr int MAX_D = 128;

// ---------------------------------------------------------------------------
// bf16: register-resident tiles on mma.sync
// ---------------------------------------------------------------------------

// rows [row0, row0 + BM) of a [*, D] bf16 slab (row stride `stride`) into a
// [BM x LD] shared tile whose first DP columns are written; rows >= n_rows
// and columns >= D are zero. `vec`: D % 8 == 0 and 16-byte aligned rows.
template <int DP, int LD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long stride,
                                               int row0, int n_rows, int D, bool vec) {
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < BM * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      const bf16* g = src + (long)(row0 + r) * stride + c;
      if (vec) {
        if (c < D) val = *reinterpret_cast<const uint4*>(g);
      } else {
        union { uint4 u; bf16 e[8]; } tmp;
        for (int e = 0; e < 8; ++e) tmp.e[e] = (c + e < D) ? g[e] : __float2bfloat16(0.0f);
        val = tmp.u;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int S, int T_, int H, int D, float scale,
                          bool vec) {
  constexpr int LD = DP + 8;   // padded shared row: ldmatrix rows hit distinct banks
  constexpr int KS = DP / 16;  // mma depth steps over the head dim
  constexpr int NO = DP / 8;   // 8-wide output column tiles
  constexpr int NS = BN / 8;   // 8-wide score column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BM x LD]
  bf16* sK = sQ + BM * LD;                   // [BN x LD]
  bf16* sV = sK + BN * LD;                   // [BN x LD]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const long stride = (long)H * D;
  const bf16* qb = q + (long)b * S * stride + (long)h * D;
  const bf16* kb = k + (long)b * T_ * stride + (long)h * D;
  const bf16* vb = v + (long)b * T_ * stride + (long)h * D;
  bf16* ob = o + (long)b * S * stride + (long)h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad_row = lane / 4, quad_col = (lane % 4) * 2;

  load_tile_bf16<DP, LD>(sQ, qb, stride, q0, S, D, vec);
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 q rows as mma A fragments
  #pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], sQ + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);

  float oacc[NO][4];
  #pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.0f;
  // this thread's two rows: quad_row and quad_row + 8 of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  for (int k0 = 0; k0 < T_; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<DP, LD>(sK, kb, stride, k0, T_, D, vec);
    load_tile_bf16<DP, LD>(sV, vb, stride, k0, T_, D, vec);
    __syncthreads();

    float sacc[NS][4];
    #pragma unroll
    for (int j = 0; j < NS; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      #pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {  // two 8-key column tiles a load
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + (j2 * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 +
                            ((lane / 8) % 2) * 8);
        mma_16816(sacc[2 * j2], qf[ks], kf[0], kf[1]);
        mma_16816(sacc[2 * j2 + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask, online softmax (each row's values sit on one quad)
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int j = 0; j < NS; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + quad_col + (e & 1);
        sacc[j][e] = col < T_ ? sacc[j][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], sacc[j][e]);
      }
    }
    float alpha[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key 0 is always valid
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    #pragma unroll
    for (int j = 0; j < NS; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[j][e] - m_run[e / 2]);
        l_run[e / 2] += p;  // fp32 p in the sum, as the TPU kernel
        sacc[j][e] = p;
      }
    }
    #pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // o += p . v, p rounded to bf16 straight from the score registers
    #pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pf[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]),
      };
      #pragma unroll
      for (int np = 0; np < NO / 2; ++np) {  // two 8-wide output tiles a load
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                  np * 16 + (lane / 16) * 8);
        mma_16816(oacc[2 * np], pf, vf[0], vf[1]);
        mma_16816(oacc[2 * np + 1], pf, vf[2], vf[3]);
      }
    }
  }

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
    // lse = m + log l, fp32, one value per valid row ([B, H, S])
    const int row = q0 + warp * 16 + quad_row + r * 8;
    if (lse != nullptr && lane % 4 == 0 && row < S)
      lse[(long)blockIdx.y * S + row] = m_run[r] + logf(l_run[r]);
    l_run[r] = 1.0f / l_run[r];
  }
  #pragma unroll
  for (int n = 0; n < NO; ++n) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + warp * 16 + quad_row + (e / 2) * 8;
      const int col = n * 8 + quad_col + (e & 1);
      if (row < S && col < D) ob[(long)row * stride + col] = __float2bfloat16(oacc[n][e] * l_run[e / 2]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward: K2 (dq) here, K3 and K6 in the key-block section below
// ---------------------------------------------------------------------------
//
// Computes, for o = softmax(scale q k^T) v with lse = m + log l from the
// forward, dO the output cotangent and delta = rowsum(dO * o) (computed
// outside, as in the JAX package's `_bwd_operands`):
//   p  = exp(scale q k^T - lse)            fp32, recomputed per tile
//   dp = dO v^T                            fp32 accumulate
//   ds = p * (dp - delta)                  rounded to bf16
//   dq = scale * ds k        (K2, K6)      fp32 accumulate, rounded once
//   dv = bf16(p)^T dO,  dk = scale * ds^T q   (K3, K6)
// the rounding points of the TPU kernels. The split design of the JAX
// package is kept: K2 owns a 64-row q tile and loops over key tiles, K3
// owns a key tile and loops over q tiles, so every output is written once
// by one block, with no atomics and a fixed summation order.
//
// K2: three products per tile pair (S, dP, dS.K), 2*S*T*D flops each,
// against reads of q, k, v, dO once and a write of dq once, so the tensor
// cores bound it at D = 80; at D = 40 the exp unit (S*T exp, at ~3.9 T/s)
// is the larger bound. It keeps its operand fragments and accumulators in
// registers (mma.sync m16n8k16 with ldmatrix, as K1): the accumulator
// layout of one product is the A-operand layout of the next, so ds goes
// from registers to the next mma with one bf16 pack. D is zero-padded to a
// multiple of 16 in shared memory only; keys past T get p = 0. Not yet
// done: cp.async/TMA double buffering and wgmma.

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
    flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int T_, int H, int D, float scale,
                         bool vec) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int NO = DP / 8;
  constexpr int NS = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BM x LD]
  bf16* sDO = sQ + BM * LD;                  // [BM x LD]
  bf16* sK = sDO + BM * LD;                  // [BN x LD]
  bf16* sV = sK + BN * LD;                   // [BN x LD]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const bf16* kb = k + (long)b * T_ * stride + (long)h * D;
  const bf16* vb = v + (long)b * T_ * stride + (long)h * D;
  const float* lseb = lse + (long)blockIdx.y * S;
  const float* dltb = delta + (long)blockIdx.y * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad_row = lane / 4, quad_col = (lane % 4) * 2;

  load_tile_bf16<DP, LD>(sQ, q + qoff, stride, q0, S, D, vec);
  load_tile_bf16<DP, LD>(sDO, dout + qoff, stride, q0, S, D, vec);
  __syncthreads();
  uint32_t qf[KS][4], dof[KS][4];
  #pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8;
    ldmatrix_x4(qf[ks], sQ + off);
    ldmatrix_x4(dof[ks], sDO + off);
  }
  float row_lse[2], row_dlt[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + quad_row + r * 8;
    row_lse[r] = row < S ? lseb[row] : 0.0f;
    row_dlt[r] = row < S ? dltb[row] : 0.0f;
  }

  float acc[NO][4];
  #pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int k0 = 0; k0 < T_; k0 += BN) {
    __syncthreads();
    load_tile_bf16<DP, LD>(sK, kb, stride, k0, T_, D, vec);
    load_tile_bf16<DP, LD>(sV, vb, stride, k0, T_, D, vec);
    __syncthreads();

    float sacc[NS][4], dpacc[NS][4];
    #pragma unroll
    for (int j = 0; j < NS; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.0f;
    }
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      #pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        const int off = (j2 * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 + ((lane / 8) % 2) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, sK + off);
        ldmatrix_x4(vf, sV + off);
        mma_16816(sacc[2 * j2], qf[ks], kf[0], kf[1]);
        mma_16816(sacc[2 * j2 + 1], qf[ks], kf[2], kf[3]);
        mma_16816(dpacc[2 * j2], dof[ks], vf[0], vf[1]);
        mma_16816(dpacc[2 * j2 + 1], dof[ks], vf[2], vf[3]);
      }
    }
    // ds = p * (dp - delta), p = exp(scale s - lse); keys >= T give p = 0
    #pragma unroll
    for (int j = 0; j < NS; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + quad_col + (e & 1);
        const float p = col < T_ ? expf(sacc[j][e] * scale - row_lse[e / 2]) : 0.0f;
        sacc[j][e] = p * (dpacc[j][e] - row_dlt[e / 2]);
      }
    }
    // acc += ds . k, ds rounded to bf16 straight from the registers
    #pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t af[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]),
      };
      #pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sK + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                  np * 16 + (lane / 16) * 8);
        mma_16816(acc[2 * np], af, bf[0], bf[1]);
        mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }

  bf16* dqb = dq + qoff;
  #pragma unroll
  for (int n = 0; n < NO; ++n) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + warp * 16 + quad_row + (e / 2) * 8;
      const int col = n * 8 + quad_col + (e & 1);
      if (row < S && col < D) dqb[(long)row * stride + col] = __float2bfloat16(acc[n][e] * scale);
    }
  }
}

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
// - One block owns BK = 128 keys. Their K and V tiles come into shared
//   memory once, by TMA, and stay there. Each of the two key warpgroups
//   owns 64 keys, wgmma's M.
// - One producer warp streams the 64-row q and dO tiles (TMA) and the lse
//   and delta rows (1-D bulk copies) through a ring of STAGES slots, each
//   marked full and empty by an mbarrier, so no consumer waits on a load it
//   could have overlapped.
// - Every product is a wgmma: S^T = K Q^T and dP^T = V dO^T with both
//   operands in shared memory; dV += bf16(P^T) dO and dK += bf16(dS^T) Q
//   with A from registers (the accumulator of the first pair becomes the A
//   fragment of the second with one bf16 pack, as on mma.sync). The two
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
//   products' N; 128 would need 64 more accumulator registers a thread), a
//   ring of 3 slots (2 and 4 were no faster; 2 above DP = 96, for shared
//   memory). K6's dq in a warpgroup of its own beat the key warpgroups
//   computing it between two block-wide barriers, each taking half its
//   columns; each key warpgroup adding its own keys' dq (twice the
//   reduce-add bytes) was slower. Registers (setmaxnreg): key warpgroups
//   232 in K3 and 192 in K6 (the dq warpgroup 96, the producer 40 or 32).
namespace kv {

constexpr int BK = 128;      // keys a block
constexpr int BQ = 64;       // q rows a tile of the ring
constexpr int NWG = 2;       // key warpgroups, 64 keys each
constexpr int NCONS = NWG * 128;
// + K6's dq warpgroup, + the producer warpgroup (one warp works)
template <bool WITH_DQ>
constexpr int NTHR = NCONS + (WITH_DQ ? 256 : 128);
constexpr float LOG2E = 1.4426950408889634f;
// mode bits of a launch
constexpr int TMA = 1;        // tiles by TMA, dk/dv by TMA stores
constexpr int LSE_BULK = 2;   // lse and delta rows by 1-D bulk copies
constexpr int PAIRS = 4;      // fallback: 4-byte cp.async (even D, aligned)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// one box of a 4-D tensor map (d, h, row, b) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int d, int h, int row,
                                         int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(d), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap& map, int d, int h, int row, int b,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(d), "r"(h), "r"(row), "r"(b), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// generic-proxy shared-memory writes made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// pins registers that an in-flight wgmma reads or writes in place: the
// compiler may neither move their other uses across this point nor reuse them
template <int R>
__device__ __forceinline__ void keep(float (&r)[R]) {
  #pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&r)[R][4]) {
  #pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// wgmma shared-memory descriptor for the 32-byte swizzle (layout type 3);
// lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}
// byte offset of element (r, c) in a tile of `rows` rows kept as column
// blocks of 16 bf16 (32-byte rows) with TMA's 32-byte swizzle: address bit
// 4 (which 16-byte half) flips with bit 7 (r / 4 odd)
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c / 16) * rows * 32 + r * 32 + ((((c % 16) / 8) ^ ((r >> 2) & 1)) << 4) + (c % 8) * 2;
}

// the fallback producer: rows [row0, row0 + ROWS) of a [*, D] slab (row
// stride `stride`) into the swizzled tile at `dst` by the 32 lanes of one
// warp; zero outside the slab and past D
template <int DP, int ROWS>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, long stride, int row0,
                                          int n_rows, int D, bool pairs, int lane) {
  constexpr int NP = DP / 2;  // bf16 pairs a row
  for (int idx = lane; idx < ROWS * NP; idx += 32) {
    const int r = idx / NP, c = (idx % NP) * 2;
    const bool row_ok = row0 + r < n_rows;
    const bf16* g = src + (long)(row0 + r) * stride + c;
    const uint32_t a = dst + swz(r, c, ROWS);
    if (pairs) {
      cp_async4(a, row_ok && c < D ? g : src, row_ok && c < D);
    } else {
      const auto* u = reinterpret_cast<const unsigned short*>(g);
      const uint32_t lo = row_ok && c < D ? u[0] : 0u, hi = row_ok && c + 1 < D ? u[1] : 0u;
      st_shared(a, lo | (hi << 16));
    }
  }
}

// shared memory of one block, in bytes from a 1024-aligned base
template <int DP, bool WITH_DQ>
struct Smem {
  static constexpr int NB = DP / 16;                          // column blocks
  static constexpr int STAGES = DP <= 96 ? 3 : 2;
  static constexpr int KV = DP * BK * 2;                      // K (or V) tile
  static constexpr int TILE = DP * BQ * 2;                    // q (or dO) tile
  static constexpr int STAGE = 2 * TILE + 1024;               // q, dO, lse, delta
  static constexpr int K = 0, V = KV, RING = 2 * KV;
  static constexpr int DS = RING + STAGES * STAGE;            // K6: 2 x dS^T [BK x BQ]
  static constexpr int DQ = DS + (WITH_DQ ? 2 * BK * BQ * 2 : 0);  // K6: fp32 [BQ x D]
  static constexpr int BAR = DQ + (WITH_DQ ? BQ * DP * 4 : 0);
  static constexpr int BYTES = BAR + 8 * (5 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "shared memory");
};

struct Maps {
  CUtensorMap q, dout, k, v, dk, dv;
};

template <int DP, bool WITH_DQ>
__global__ void __launch_bounds__(NTHR<WITH_DQ>, 1)
    flash_bwd_kv_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, float* __restrict__ dq32, int S, int T_, int H,
                        int D, float scale, int mode) {
  using L = Smem<DP, WITH_DQ>;
  constexpr int NB = L::NB, STAGES = L::STAGES;
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == PRODUCER) {
    // ---- producer ----
    if constexpr (WITH_DQ) {
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
      asm volatile("cp.async.wait_all;\n" ::: "memory");
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
          asm volatile("cp.async.wait_all;\n" ::: "memory");
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
      // keys, A = dS^T and B = K both read MN-major; the fp32 tile is staged
      // in shared memory and added into dq32 by one bulk reduce-add ----
      asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n");
      const int t = threadIdx.x % 128, wi = t / 32, lane = t % 32;
      float* s_dq = reinterpret_cast<float*>(smem + L::DQ);
      const long dq_row0 = (long)blockIdx.y * n_tiles * BQ;  // dq32 is [B, H, S_pad, D]
      for (int it = 0; it < n_tiles; ++it) {
        const int b = it & 1;
        mbar_wait(bar_ds_full(b), (it >> 1) & 1);
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
        fence_async_smem();
        named_sync(2, 128);  // the fp32 dq tile is in shared memory
        if (t == 0) {
          bulk_reduce_add(dq32 + (dq_row0 + it * BQ) * D, fd::smem_addr(s_dq), BQ * D * 4);
          bulk_commit();
        }
      }
      if (t == 0) bulk_wait();  // shared memory outlives the last reduce-add
      return;
    }
  }

  // ---- key warpgroups: warpgroup `wg` owns keys k0 + 64 wg .. + 64 ----
  if constexpr (WITH_DQ) {
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

__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int T_, int H, int D, float scale) {
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
        const float s = (k0 + c < T_) ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = c0; c < c0 + BN / 2; ++c) {
        srow[c] = expf(srow[c] - m_new);
        sum += srow[c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both threads of the row have read sM[r]
      if ((tid & 1) == 0) {
        const float alpha = expf(m_prev - m_new);
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

size_t smem_dq_f32(int D) { return sizeof(float) * (5 * BM * D + 2 * BM * BN + 2 * BM); }

__global__ void __launch_bounds__(NTHREADS)
    flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int T_, int H, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [BM x D]
  float* sDO = sQ + BM * D;                    // [BM x D]
  float* sK = sDO + BM * D;                    // [BN x D]
  float* sV = sK + BN * D;                     // [BN x D]
  float* sAcc = sV + BN * D;                   // [BM x D] dq accumulator
  float* sS = sAcc + BM * D;                   // [BM x BN] scores, then ds
  float* sDP = sS + BM * BN;                   // [BM x BN] dO v^T
  float* sLse = sDP + BM * BN;                 // [BM]
  float* sDlt = sLse + BM;                     // [BM]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const float* kb = k + (long)b * T_ * stride + (long)h * D;
  const float* vb = v + (long)b * T_ * stride + (long)h * D;
  const int tid = threadIdx.x;

  load_tile_f32(sQ, q + qoff, stride, q0, BM, S, D);
  load_tile_f32(sDO, dout + qoff, stride, q0, BM, S, D);
  for (int idx = tid; idx < BM * D; idx += NTHREADS) sAcc[idx] = 0.0f;
  for (int r = tid; r < BM; r += NTHREADS) {
    sLse[r] = q0 + r < S ? lse[(long)blockIdx.y * S + q0 + r] : 0.0f;
    sDlt[r] = q0 + r < S ? delta[(long)blockIdx.y * S + q0 + r] : 0.0f;
  }
  for (int k0 = 0; k0 < T_; k0 += BN) {
    __syncthreads();
    load_tile_f32(sK, kb, stride, k0, BN, T_, D);
    load_tile_f32(sV, vb, stride, k0, BN, T_, D);
    __syncthreads();
    mm_nt(sQ, D, sK, D, sS, BN, BM, BN, D);
    mm_nt(sDO, D, sV, D, sDP, BN, BM, BN, D);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
      const int r = idx / BN, c = idx % BN;
      const float p = k0 + c < T_ ? expf(sS[idx] * scale - sLse[r]) : 0.0f;
      sS[idx] = p * (sDP[idx] - sDlt[r]);
    }
    __syncthreads();
    mm_nn(sS, BN, sK, D, sAcc, D, BM, D, BN, true);
  }
  __syncthreads();
  for (int idx = tid; idx < BM * D; idx += NTHREADS) {
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
  const long s_pad = (S + kv::BQ - 1) / kv::BQ * kv::BQ;

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

template <int DP>
int launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                    int S, int T_, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 3 * BM * (DP + 8);
  if (int err = set_smem(flash_fwd_bf16_kernel<DP>, smem)) return err;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_bf16_kernel<DP><<<grid, NTHREADS, smem, stream>>>(q, k, v, o, lse, S, T_, H, D,
                                                              scale, vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, bf16* dq, int B, int S, int T_, int H,
                   int D, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 4 * BM * (DP + 8);
  if (int err = set_smem(flash_dq_bf16_kernel<DP>, smem)) return err;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_dq_bf16_kernel<DP><<<grid, NTHREADS, smem, stream>>>(q, k, v, dout, lse, delta, dq, S,
                                                             T_, H, D, scale, vec);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's driver entry point, so the library links no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// a bf16 [B, N, H, D] tensor as a 4-D map (d, h, row, b) with a box of 16
// head-dim values x `rows` rows and the 32-byte swizzle; out-of-bounds
// elements read as zero and are not written
bool tensor_map(CUtensorMap* map, const void* base, int B, int N, int H, int D, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * N * H * D};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K3 (dq32 == nullptr) or K6: TMA where every tensor is 16-byte aligned and
// its row stride (H * D * 2 bytes) and head stride (D * 2) are multiples of
// 16 bytes; otherwise the same kernel's cp.async producer
template <int DP, bool WITH_DQ>
int launch_bwd_kv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                  const float* delta, bf16* dk, bf16* dv, float* dq32, int B, int S, int T_, int H,
                  int D, float scale, cudaStream_t stream) {
  auto kernel = kv::flash_bwd_kv_kernel<DP, WITH_DQ>;
  const size_t smem = kv::Smem<DP, WITH_DQ>::BYTES;
  if (int err = set_smem(kernel, smem)) return err;
  const auto aligned4 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; };
  const bool tma = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                   aligned16(dk) && aligned16(dv);
  const bool lse_bulk = tma && S % 4 == 0 && aligned16(lse) && aligned16(delta);
  const bool pairs = D % 2 == 0 && aligned4(q) && aligned4(k) && aligned4(v) && aligned4(dout);
  kv::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (tma && !(tensor_map(&maps.q, q, B, S, H, D, kv::BQ) && tensor_map(&maps.dout, dout, B, S, H, D, kv::BQ) &&
               tensor_map(&maps.k, k, B, T_, H, D, kv::BK) && tensor_map(&maps.v, v, B, T_, H, D, kv::BK) &&
               tensor_map(&maps.dk, dk, B, T_, H, D, kv::BK) && tensor_map(&maps.dv, dv, B, T_, H, D, kv::BK)))
    return (int)cudaErrorInvalidValue;
  const int mode = (tma ? kv::TMA : 0) | (lse_bulk ? kv::LSE_BULK : 0) | (pairs ? kv::PAIRS : 0);
  const dim3 grid((T_ + kv::BK - 1) / kv::BK, B * H);
  kernel<<<grid, kv::NTHR<WITH_DQ>, smem, stream>>>(maps, q, k, v, dout, lse, delta, dk, dv, dq32, S, T_, H, D,
                                           scale, mode);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int T_, int H, int D) {
  return B < 1 || S < 1 || T_ < 1 || H < 1 || D < 1 || D > MAX_D || (long)B * H > 65535;
}

// one instantiation per head dim padded to the mma depth (16 .. 128)
#define FD_DISPATCH_DP(D, CALL)                    \
  switch (((D) + 15) / 16) {                       \
    case 1: { constexpr int DP = 16; return CALL; } \
    case 2: { constexpr int DP = 32; return CALL; } \
    case 3: { constexpr int DP = 48; return CALL; } \
    case 4: { constexpr int DP = 64; return CALL; } \
    case 5: { constexpr int DP = 80; return CALL; } \
    case 6: { constexpr int DP = 96; return CALL; } \
    case 7: { constexpr int DP = 112; return CALL; } \
    default: { constexpr int DP = 128; return CALL; } \
  }

int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
             int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  FD_DISPATCH_DP(D, launch_fwd_bf16<DP>(qq, kk, vv, oo, lse, B, S, T, H, D, scale, st));
}

int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
            int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_f32(D);
  if (int err = set_smem(flash_fwd_f32_kernel, smem)) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_f32_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, T, H, D, scale);
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
  return fwd_f32(q, k, v, o, nullptr, B, S, T, H, D, scale, stream);
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
  return fwd_f32(q, k, v, o, static_cast<float*>(lse), B, S, T, H, D, scale, stream);
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
  FD_DISPATCH_DP(D, launch_dq_bf16<DP>(qq, kk, vv, dd, ll, de, out, B, S, T, H, D, scale, st));
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

extern "C" int fd_flash_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int S,
                               int T, int H, int D, float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_dq_f32(D);
  if (int err = set_smem(flash_dq_f32_kernel, smem)) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_dq_f32_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, T, H, D, scale);
  return (int)cudaGetLastError();
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
  FD_DISPATCH_DP(D, (launch_bwd_kv<DP, true>(qq, kk, vv, dd, ll, de, gk, gv, gq, B, S, T, H, D,
                                             scale, st)));
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
