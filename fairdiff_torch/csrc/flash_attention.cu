// Flash attention (non-causal) for Hopper, sm_90a: the forward (K1, with or
// without lse) and the split backward (K2 dq, K3 dk/dv).
//
// Replaces: fairdiff/ops/flash_attention.py `_flash_forward` (Pallas bodies
// `_flash_kernel` and `_flash_kernel_pipe`, identical maths; `with_lse` for
// the backward), `_dq_pallas` (`_bwd_dq_kernel`) and `_dkv_pallas`
// (`_bwd_dkv_kernel`). The backward is described above its kernels below.
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
#include "common.cuh"

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

// rows [row0, row0 + 64) of a [*, D] bf16 slab (row stride `stride`) into a
// [64 x LD] shared tile whose first DP columns are written; rows >= n_rows and
// columns >= D are zero. `vec`: D % 8 == 0 and 16-byte aligned rows.
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
// bf16 backward (K2, K3)
// ---------------------------------------------------------------------------
//
// Computes, for o = softmax(scale q k^T) v with lse = m + log l from the
// forward, dO the output cotangent and delta = rowsum(dO * o) (computed
// outside, as in the JAX package's `_bwd_operands`):
//   p  = exp(scale q k^T - lse)            fp32, recomputed per tile
//   dp = dO v^T                            fp32 accumulate
//   ds = p * (dp - delta)                  rounded to bf16
//   dq = scale * ds k        (K2)          fp32 accumulate, rounded once
//   dv = bf16(p)^T dO,  dk = scale * ds^T q   (K3)
// the rounding points of the TPU kernels. The split design of the JAX
// package is kept: K2 owns a 64-row q tile and loops over key tiles, K3
// owns a 64-key tile and loops over q tiles, so every output is written
// once by one block, with no atomics and a fixed summation order.
//
// What bounds them on this card: K2 does three products per tile pair (S,
// dP, dS.K) and K3 four (S^T, dP^T, P^T.dO, dS^T.Q), 2*S*T*D flops each,
// against reads of q, k, v, dO once and writes of dq or dk/dv once, so the
// tensor cores bound them at D = 80; at D = 40 the exp unit (S*T exp, at
// ~3.9 T/s) is the larger bound. Both keep their operand fragments and
// accumulators in registers (mma.sync m16n8k16 with ldmatrix, as K1):
// the accumulator layout of one product is the A-operand layout of the
// next, so p and ds go from registers to the next mma with one bf16 pack.
// D is zero-padded to a multiple of 16 in shared memory only; keys past T
// and q rows past S get p = 0, and neither is stored. Not yet done:
// cp.async/TMA double buffering and wgmma.

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

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
    flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int T_, int H,
                          int D, float scale, bool vec) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int NO = DP / 8;
  constexpr int NS = BM / 8;  // 8-wide q column tiles of the transposed scores
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [BN x LD]
  bf16* sV = sK + BN * LD;                   // [BN x LD]
  bf16* sQ = sV + BN * LD;                   // [BM x LD]
  bf16* sDO = sQ + BM * LD;                  // [BM x LD]
  float* sLse = reinterpret_cast<float*>(sDO + BM * LD);  // [BM]
  float* sDlt = sLse + BM;                                // [BM]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BN;
  const long stride = (long)H * D;
  const long qoff = (long)b * S * stride + (long)h * D;
  const long koff = (long)b * T_ * stride + (long)h * D;
  const float* lseb = lse + (long)blockIdx.y * S;
  const float* dltb = delta + (long)blockIdx.y * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad_row = lane / 4, quad_col = (lane % 4) * 2;

  load_tile_bf16<DP, LD>(sK, k + koff, stride, k0, T_, D, vec);
  load_tile_bf16<DP, LD>(sV, v + koff, stride, k0, T_, D, vec);
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];  // this warp's 16 keys as A fragments
  #pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8;
    ldmatrix_x4(kf[ks], sK + off);
    ldmatrix_x4(vf[ks], sV + off);
  }

  float dkacc[NO][4], dvacc[NO][4];
  #pragma unroll
  for (int n = 0; n < NO; ++n) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.0f;
  }

  for (int q0 = 0; q0 < S; q0 += BM) {
    __syncthreads();  // every warp is done with the previous q tile
    load_tile_bf16<DP, LD>(sQ, q + qoff, stride, q0, S, D, vec);
    load_tile_bf16<DP, LD>(sDO, dout + qoff, stride, q0, S, D, vec);
    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
      sLse[r] = q0 + r < S ? lseb[q0 + r] : 0.0f;
      sDlt[r] = q0 + r < S ? dltb[q0 + r] : 0.0f;
    }
    __syncthreads();

    // transposed scores s^t = k q^T and dp^t = v dO^T: rows are this warp's
    // keys, columns the tile's q rows
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
        uint32_t qb[4], ob[4];
        ldmatrix_x4(qb, sQ + off);
        ldmatrix_x4(ob, sDO + off);
        mma_16816(sacc[2 * j2], kf[ks], qb[0], qb[1]);
        mma_16816(sacc[2 * j2 + 1], kf[ks], qb[2], qb[3]);
        mma_16816(dpacc[2 * j2], vf[ks], ob[0], ob[1]);
        mma_16816(dpacc[2 * j2 + 1], vf[ks], ob[2], ob[3]);
      }
    }
    #pragma unroll
    for (int j = 0; j < NS; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + quad_col + (e & 1);  // q row within the tile
        const float p = q0 + c < S ? expf(sacc[j][e] * scale - sLse[c]) : 0.0f;
        sacc[j][e] = p;
        dpacc[j][e] = p * (dpacc[j][e] - sDlt[c]);
      }
    }
    // dv += bf16(p)^T dO, dk += bf16(ds)^T q, both A operands from registers
    #pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]),
      };
      const uint32_t da[4] = {
          pack_bf16(dpacc[2 * kk][0], dpacc[2 * kk][1]),
          pack_bf16(dpacc[2 * kk][2], dpacc[2 * kk][3]),
          pack_bf16(dpacc[2 * kk + 1][0], dpacc[2 * kk + 1][1]),
          pack_bf16(dpacc[2 * kk + 1][2], dpacc[2 * kk + 1][3]),
      };
      #pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        const int off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + np * 16 + (lane / 16) * 8;
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, sDO + off);
        ldmatrix_x4_trans(qb, sQ + off);
        mma_16816(dvacc[2 * np], pa, ob[0], ob[1]);
        mma_16816(dvacc[2 * np + 1], pa, ob[2], ob[3]);
        mma_16816(dkacc[2 * np], da, qb[0], qb[1]);
        mma_16816(dkacc[2 * np + 1], da, qb[2], qb[3]);
      }
    }
  }

  #pragma unroll
  for (int n = 0; n < NO; ++n) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + warp * 16 + quad_row + (e / 2) * 8;
      const int col = n * 8 + quad_col + (e & 1);
      if (row < T_ && col < D) {
        const long off = koff + (long)row * stride + col;
        dk[off] = __float2bfloat16(dkacc[n][e] * scale);
        dv[off] = __float2bfloat16(dvacc[n][e]);
      }
    }
  }
}

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

template <int DP>
int launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                    const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int S,
                    int T_, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 4 * BM * (DP + 8) + sizeof(float) * 2 * BM;
  if (int err = set_smem(flash_dkv_bf16_kernel<DP>, smem)) return err;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const dim3 grid((T_ + BN - 1) / BN, B * H);
  flash_dkv_bf16_kernel<DP><<<grid, NTHREADS, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                                              S, T_, H, D, scale, vec);
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
  FD_DISPATCH_DP(D, launch_dkv_bf16<DP>(qq, kk, vv, dd, ll, de, gk, gv, B, S, T, H, D, scale, st));
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
