// Flash-attention backward for Hopper (sm_90a), bf16 or f32, d_head 32/64/128:
// two kernels, dK/dV and dQ, with no atomics and a fixed summation order.
//
// Replaces the Pallas TPU kernels kubeflow_tpu/ops/attention.py
// `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel` (launched by
// `_flash_backward`). Both rebuild the probabilities from the forward's
// residuals instead of storing them (`_recompute_p_ds`):
//   logits = (q . k) * scale            (scaled after the product)
//   P      = exp(logits - lse), 0 where masked causally or past the edge
//   dS     = P * (dO . v - delta) * scale,  delta = rowsum(dO * O)
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K       (f32 sums)
// and cast dQ/dK/dV to the inputs' dtype at the end.
//
// Layout: q, k, v, dO, dQ, dK, dV are (b, s, h, d), read and written through
// their batch/seq/head strides (d contiguous); lse and delta are (b, h, s)
// f32. The bf16 kernels read q, k, v, dO with TMA, so their base and
// strides must be multiples of 16 bytes (the wrapper copies a tensor that
// is not). GQA callers repeat K/V heads before the call, as in the
// reference.
//
// The TPU grid carries the dK/dV (or dQ) sum in VMEM scratch across its
// sequential inner grid axis; CUDA blocks run in no order, so that axis
// becomes a loop inside one block and the sum lives in registers. Each
// output has one owner block, so no atomics, and the result is the same on
// every run. The ragged edge (s not a multiple of a tile) is masked here.
//
// dK/dV, bf16: tensor cores. One block of one warpgroup (128 threads) per
// (batch, head, tile of 64 keys); K and V come in once by TMA. The block
// loops over query tiles of 32 rows from the diagonal (causal), Q and dO
// coming through a two-stage TMA ring (bf16, swizzled, mbarriers). Per
// query tile the four products run on wgmma in the transposed form, the key
// tile as the 64-row M side: S^T = K.Q^T and dP^T = V.dO^T (operands in
// shared memory), P^T = exp2(S^T * scale * log2(e) - lse[q] * log2(e)) and
// dS^T = P^T * (dP^T - delta[q]) * scale in f32 on the accumulator
// fragments, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T rounded
// to bf16 as register A operands and dO, Q read transposed from shared
// memory. dK and dV stay in f32 registers and are rounded to bf16 once.
// Rounding P and dS to bf16 for the two accumulating products is what the
// reference does on its own chip: an f32 `dot` at default precision on a
// TPU multiplies in bf16. The plain version keeps them in f32, so the two
// differ by that rounding (chip_smoke.py states the bound). 32-query tiles
// keep S^T and dP^T at 16 registers a thread each beside the 128 of dK and
// dV at d=128 (ptxas's report is in PERF.md). What bounds it: four
// (s x s x d) products per (b, h) against ~12 bytes per (s, d) element,
// above the ridge at s = 1024, so the floor is the tensor-core rate.
//
// dQ, bf16: tensor cores, the forward's structure with three changes: P
// is rebuilt from lse instead of a running softmax, a second SS product
// dP = dO.V^T runs beside S = Q.K^T, and K takes V's place in the
// accumulating product. One block of one warpgroup per (batch, head, tile
// of 64 query rows), the causal tiles heaviest first (grid y reversed); Q
// and dO come in once by TMA, the lse and delta of the thread's two rows
// into registers, and K/V tiles of 64 keys through a two-stage TMA ring up
// to the diagonal. Per key tile: S and dP on wgmma (operands in shared
// memory, two 64x64 f32 accumulators), P = exp2(S * scale * log2(e) -
// lse * log2(e)) masked on the diagonal and ragged tiles only, dS = P *
// (dP - delta) * scale on the fragments, then dQ += dS.K with dS rounded
// to bf16 as the register A operand and K read transposed from shared
// memory (as the forward reads V for P.V). dQ stays in f32 registers (64
// a thread at d=128) and is rounded to bf16 once. Each dQ tile has one
// owner block, so no atomics: the bits are the same on every run. What
// bounds it: three (s x s x d) products per (b, h) against ~10 bytes per
// (s, d) element, above the ridge at s = 1024: the tensor-core rate.
//
// f32: CUDA cores (scalar f32 FMAs, 67 TFLOP/s), for dK/dV and dQ alike:
// TF32 tensor cores would lose the 2e-5 agreement the f32 checks hold.
//  - dK/dV f32: one block per (batch, head, tile of BK keys). Each key row
//    is owned by TPR = D/DPT adjacent threads that split d_head; a row's k
//    and v slices and its dK/dV accumulators stay in registers. The block
//    loops over query tiles of BQ rows, staging q, dO, lse and delta in
//    shared memory as f32.
//  - dQ f32: one block per (batch, head, tile of BQ queries); a query row's
//    q and dO slices, lse, delta and dQ accumulator stay in registers, and
//    the block loops over key tiles of BK keys (up to the diagonal when
//    causal), staging k and v in shared memory, accumulating dQ += dS k.
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;    // f32: keys per dK/dV block, keys per dQ tile
constexpr int BQ = 32;    // f32: query rows per dQ block, rows per dK/dV tile
constexpr int DPT = 16;   // head dims per thread: a row spans D / DPT threads

struct Strides {  // element strides of one (b, s, h, d) tensor
  int64_t b, s, h;
};

template <int TPR>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

template <int D>
__global__ void __launch_bounds__(BK * (D / DPT))
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int S, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, float scale, int causal) {
  constexpr int TPR = D / DPT;
  constexpr int THREADS = BK * TPR;
  __shared__ float qs[BQ][D];
  __shared__ float dos[BQ][D];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int kpos = k0 + row;
  const bool live = kpos < S;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (int64_t)bh * S;
  const float* deltab = delta + (int64_t)bh * S;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  {
    const float* kb = k + b * sk.b + h * sk.h + kpos * sk.s;
    const float* vb = v + b * sv.b + h * sv.h + kpos * sv.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      kr[i] = live ? kb[i * TPR + t] : 0.f;
      vr[i] = live ? vb[i * TPR + t] : 0.f;
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
  }

  // query tiles wholly above this key tile's first key see none of it
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < S; q0 += BQ) {
    for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
      const int j = idx / D, c = idx % D;
      const int qp = q0 + j;
      qs[j][c] = qp < S ? qb[qp * sq.s + c] : 0.f;
      dos[j][c] = qp < S ? dob[qp * sdo.s + c] : 0.f;
    }
    for (int j = threadIdx.x; j < BQ; j += THREADS) {
      const int qp = q0 + j;
      lse_s[j] = qp < S ? lseb[qp] : 0.f;
      delta_s[j] = qp < S ? deltab[qp] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < BQ; ++j) {
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        sdot += qs[j][i * TPR + t] * kr[i];
        pdot += dos[j][i * TPR + t] * vr[i];
      }
      sdot = row_sum<TPR>(sdot);
      pdot = row_sum<TPR>(pdot);
      const int qp = q0 + j;
      const bool valid = live && qp < S && (!causal || kpos <= qp);
      const float p = valid ? expf(sdot * scale - lse_s[j]) : 0.f;
      const float ds = p * (pdot - delta_s[j]) * scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dva[i] += p * dos[j][i * TPR + t];
        dka[i] += ds * qs[j][i * TPR + t];
      }
    }
    __syncthreads();
  }

  if (live) {
    float* dkb = dk + b * sdk.b + h * sdk.h + kpos * sdk.s;
    float* dvb = dv + b * sdv.b + h * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dkb[i * TPR + t] = dka[i];
      dvb[i * TPR + t] = dva[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BQ * (D / DPT))
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int TPR = D / DPT;
  constexpr int THREADS = BQ * TPR;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qpos = q0 + row;
  const bool live = qpos < S;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[DPT], dor[DPT], dqa[DPT];
  {
    const float* qrow = q + b * sq.b + h * sq.h + qpos * sq.s;
    const float* dorow = dout + b * sdo.b + h * sdo.h + qpos * sdo.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = live ? qrow[i * TPR + t] : 0.f;
      dor[i] = live ? dorow[i * TPR + t] : 0.f;
      dqa[i] = 0.f;
    }
  }
  const float lse_r = live ? lse[(int64_t)bh * S + qpos] : 0.f;
  const float delta_r = live ? delta[(int64_t)bh * S + qpos] : 0.f;

  // keys past the last query row of this tile are all masked when causal
  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      ks[j][c] = kp < S ? kb[kp * sk.s + c] : 0.f;
      vs[j][c] = kp < S ? vb[kp * sv.s + c] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        sdot += qr[i] * ks[j][i * TPR + t];
        pdot += dor[i] * vs[j][i * TPR + t];
      }
      sdot = row_sum<TPR>(sdot);
      pdot = row_sum<TPR>(pdot);
      const int kp = k0 + j;
      const bool valid = live && kp < S && (!causal || kp <= qpos);
      const float p = valid ? expf(sdot * scale - lse_r) : 0.f;
      const float ds = p * (pdot - delta_r) * scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dqa[i] += ds * ks[j][i * TPR + t];
    }
    __syncthreads();
  }

  if (live) {
    float* dqb = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dqb[i * TPR + t] = dqa[i];
  }
}

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int S, int H, int D,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  dim3 grid((S + BK - 1) / BK, B * H);
  auto go = [&](auto kern, int threads) {
    kern<<<grid, threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), H, S,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), scale,
        causal);
  };
  switch (D) {
    case 32: go(flash_bwd_dkv_kernel<32>, BK * (32 / DPT)); break;
    case 64: go(flash_bwd_dkv_kernel<64>, BK * (64 / DPT)); break;
    case 128: go(flash_bwd_dkv_kernel<128>, BK * (128 / DPT)); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 paths
using kft::bf16;
constexpr int WG = 128;     // one warpgroup
constexpr int TKV = 64;     // keys per block: wgmma's M
constexpr int TQW = 32;     // queries per tile: N of K.Q^T, K of P^T.dO
constexpr int STAGES = 2;   // depth of the TMA rings (Q/dO, or K/V in dQ)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * TKV + 2 * STAGES * TQW) * D * 2 + 1024;  // + alignment slack
}

template <int D>
__device__ __forceinline__ void load_qdo(bf16* qd, bf16* dod, uint64_t* bar,
                                         const CUtensorMap* tq,
                                         const CUtensorMap* tdo, int q0,
                                         int h, int b) {
  kft::mbar_expect_tx(bar, 2 * TQW * D * 2);
  kft::tma_tile<D, TQW>(qd, tq, bar, q0, h, b);
  kft::tma_tile<D, TQW>(dod, tdo, bar, q0, h, b);
}

template <int D>
__global__ void __launch_bounds__(WG)
flash_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int S, Strides sdk, Strides sdv,
                           float scale, int causal) {
  constexpr int QTILE = TQW * D;
  extern __shared__ uint8_t raw[];
  bf16* ks = reinterpret_cast<bf16*>(kft::align1024(raw));
  bf16* vs = ks + TKV * D;
  bf16* qs = vs + TKV * D;
  bf16* dos = qs + STAGES * QTILE;
  __shared__ uint64_t kvbar, qbar[STAGES];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * TKV;  // causal: the early key tiles, which
                                    // see the most queries, go first
  // query tiles wholly above this key tile's first key see none of it
  const int qstart = causal ? k0 : 0;
  const int ntiles = (S - qstart + TQW - 1) / TQW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    kft::mbar_init(&kvbar, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) kft::mbar_init(&qbar[i], 1);
    kft::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    kft::mbar_expect_tx(&kvbar, 2 * TKV * D * 2);
    kft::tma_tile<D, TKV>(ks, &tk, &kvbar, k0, h, b);
    kft::tma_tile<D, TKV>(vs, &tv, &kvbar, k0, h, b);
    for (int i = 0; i < STAGES && i < ntiles; ++i)
      load_qdo<D>(qs + i * QTILE, dos + i * QTILE, &qbar[i], &tq, &tdo,
                  qstart + i * TQW, h, b);
  }

  // this thread's key rows r0, r0 + 8; its query columns in each 8-column
  // group c0, c0 + 1
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float* lseb = lse + (int64_t)bh * S;
  const float* deltab = delta + (int64_t)bh * S;
  const float scale_log2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  kft::mbar_wait(&kvbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % STAGES;
    const int q0 = qstart + it * TQW;
    bf16* qt = qs + slot * QTILE;
    bf16* dot = dos + slot * QTILE;
    kft::mbar_wait(&qbar[slot], (it / STAGES) & 1);

    float st[TQW / 2], dpt[TQW / 2];
    kft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      kft::wgmma_ss(st, kft::desc_k<D, TKV>(ks, kk),
                    kft::desc_k<D, TQW>(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      kft::wgmma_ss(dpt, kft::desc_k<D, TKV>(vs, kk),
                    kft::desc_k<D, TQW>(dot, kk), kk > 0);
    kft::wgmma_commit();
    // lse and delta of this thread's query columns, read while the
    // products run
    float lq[TQW / 4], dl[TQW / 4];
#pragma unroll
    for (int c = 0; c < TQW / 4; ++c) {
      const int qpos = q0 + 8 * (c / 2) + c0 + c % 2;
      lq[c] = qpos < S ? lseb[qpos] * LOG2E : 0.f;
      dl[c] = qpos < S ? deltab[qpos] : 0.f;
    }
    kft::wgmma_wait<0>();
    kft::reg_fence(st);
    kft::reg_fence(dpt);

    const bool edge = (causal && q0 < k0 + TKV) || q0 + TQW > S;
#pragma unroll
    for (int i = 0; i < TQW / 2; ++i) {
      const int c = 2 * (i / 4) + i % 2;
      float p = exp2f(st[i] * scale_log2 - lq[c]);
      if (edge) {
        const int key = k0 + r0 + 8 * ((i / 2) % 2);
        const int qpos = q0 + 8 * (i / 4) + c0 + i % 2;
        if (qpos >= S || (causal && key > qpos)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - dl[c]) * scale;
    }
    uint32_t pa[TQW / 16][4], da[TQW / 16][4];
    kft::to_a_frags(st, pa);
    kft::to_a_frags(dpt, da);
    kft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQW / 16; ++kk)
      kft::wgmma_rs_tb(dva, pa[kk], kft::desc_mn<D, TQW>(dot, kk), 1);
#pragma unroll
    for (int kk = 0; kk < TQW / 16; ++kk)
      kft::wgmma_rs_tb(dka, da[kk], kft::desc_mn<D, TQW>(qt, kk), 1);
    kft::wgmma_commit();
    kft::wgmma_wait<0>();
    kft::reg_fence(dka);
    kft::reg_fence(dva);

    __syncthreads();  // every warp is done with this slot: refill it
    if (tid == 0 && it + STAGES < ntiles)
      load_qdo<D>(qt, dot, &qbar[slot], &tq, &tdo, q0 + STAGES * TQW, h, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + r0 + 8 * r;
    if (kpos >= S) continue;
    bf16* dkr = dk + b * sdk.b + h * sdk.h + kpos * sdk.s;
    bf16* dvr = dv + b * sdv.b + h * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int i = 4 * jn + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * jn + c0) =
          __floats2bfloat162_rn(dka[i], dka[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * jn + c0) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

template <int D>
int launch_dkv_wgmma_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H,
                       const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = kft::encode_bshd(&tq, q, B, S, H, D, st[0], st[1], st[2], TQW);
  if (!err)
    err = kft::encode_bshd(&tk, k, B, S, H, D, st[3], st[4], st[5], TKV);
  if (!err)
    err = kft::encode_bshd(&tv, v, B, S, H, D, st[6], st[7], st[8], TKV);
  if (!err)
    err = kft::encode_bshd(&tdo, dout, B, S, H, D, st[9], st[10], st[11],
                           TQW);
  if (err) return err;
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_wgmma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + TKV - 1) / TKV);
  flash_bwd_dkv_kernel_wgmma<D><<<grid, WG, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, S, strides_at(st, 4), strides_at(st, 5),
      scale, causal);
  return (int)cudaGetLastError();
}

int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int H, int D,
                     const int64_t* st, float scale, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dkv_wgmma_d<32>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                    H, st, scale, causal, stream);
    case 64:
      return launch_dkv_wgmma_d<64>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                    H, st, scale, causal, stream);
    case 128:
      return launch_dkv_wgmma_d<128>(q, k, v, dout, lse, delta, dk, dv, B,
                                     S, H, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int S, int H, int D, const int64_t* st,
                  float scale, int causal, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  auto go = [&](auto kern, int threads) {
    kern<<<grid, threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), H, S, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), scale,
        causal);
  };
  switch (D) {
    case 32: go(flash_bwd_dq_kernel<32>, BQ * (32 / DPT)); break;
    case 64: go(flash_bwd_dq_kernel<64>, BQ * (64 / DPT)); break;
    case 128: go(flash_bwd_dq_kernel<128>, BQ * (128 / DPT)); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- dQ, bf16 path
constexpr int TQD = 64;   // query rows per dQ block: wgmma's M
constexpr int TKD = 64;   // keys per K/V tile: N of Q.K^T, K of dS.K

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * TQD + 2 * STAGES * TKD) * D * 2 + 1024;  // + alignment slack
}

template <int D>
__device__ __forceinline__ void load_kv(bf16* kd, bf16* vd, uint64_t* bar,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int k0, int h,
                                        int b) {
  kft::mbar_expect_tx(bar, 2 * TKD * D * 2);
  kft::tma_tile<D, TKD>(kd, tk, bar, k0, h, b);
  kft::tma_tile<D, TKD>(vd, tv, bar, k0, h, b);
}

template <int D>
__global__ void __launch_bounds__(WG)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int H, int S, Strides sdq,
                          float scale, int causal) {
  constexpr int TILE = TKD * D;
  extern __shared__ uint8_t raw[];
  bf16* qs = reinterpret_cast<bf16*>(kft::align1024(raw));
  bf16* dos = qs + TQD * D;
  bf16* ks = dos + TQD * D;
  bf16* vs = ks + STAGES * TILE;
  __shared__ uint64_t qbar, kvbar[STAGES];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // causal: the last query tiles, which see the most keys, go first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TQD;
  // keys past the last query row of this tile are all masked when causal
  const int kend = causal ? min(S, q0 + TQD) : S;
  const int ntiles = (kend + TKD - 1) / TKD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    kft::mbar_init(&qbar, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) kft::mbar_init(&kvbar[i], 1);
    kft::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    kft::mbar_expect_tx(&qbar, 2 * TQD * D * 2);
    kft::tma_tile<D, TQD>(qs, &tq, &qbar, q0, h, b);
    kft::tma_tile<D, TQD>(dos, &tdo, &qbar, q0, h, b);
    for (int j = 0; j < STAGES && j < ntiles; ++j)
      load_kv<D>(ks + j * TILE, vs + j * TILE, &kvbar[j], &tk, &tv, j * TKD,
                 h, b);
  }

  // this thread's query rows r0, r0 + 8; its key columns in each 8-column
  // group c0, c0 + 1
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;
  float lq[2], dl[2];  // lse * log2(e) and delta of rows r0, r0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r0 + 8 * r;
    lq[r] = qpos < S ? lse[(int64_t)bh * S + qpos] * LOG2E : 0.f;
    dl[r] = qpos < S ? delta[(int64_t)bh * S + qpos] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  kft::mbar_wait(&qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % STAGES;
    bf16* kt = ks + slot * TILE;
    bf16* vt = vs + slot * TILE;
    kft::mbar_wait(&kvbar[slot], (j / STAGES) & 1);

    float st[TKD / 2], dpt[TKD / 2];
    kft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      kft::wgmma_ss(st, kft::desc_k<D, TQD>(qs, kk),
                    kft::desc_k<D, TKD>(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      kft::wgmma_ss(dpt, kft::desc_k<D, TQD>(dos, kk),
                    kft::desc_k<D, TKD>(vt, kk), kk > 0);
    kft::wgmma_commit();
    kft::wgmma_wait<0>();
    kft::reg_fence(st);
    kft::reg_fence(dpt);

    const int k0 = j * TKD;
    const bool edge = (causal && j == ntiles - 1) || k0 + TKD > S;
#pragma unroll
    for (int i = 0; i < TKD / 2; ++i) {
      const int r = (i / 2) % 2;
      float p = exp2f(st[i] * scale_log2 - lq[r]);
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c0 + i % 2;
        const int qpos = q0 + r0 + 8 * r;
        if (key >= S || (causal && key > qpos)) p = 0.f;
      }
      st[i] = p * (dpt[i] - dl[r]) * scale;  // dS
    }
    uint32_t da[TKD / 16][4];
    kft::to_a_frags(st, da);
    kft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TKD / 16; ++kk)
      kft::wgmma_rs_tb(dqa, da[kk], kft::desc_mn<D, TKD>(kt, kk), 1);
    kft::wgmma_commit();
    kft::wgmma_wait<0>();
    kft::reg_fence(dqa);

    __syncthreads();  // every warp is done with this slot: refill it
    if (tid == 0 && j + STAGES < ntiles)
      load_kv<D>(kt, vt, &kvbar[slot], &tk, &tv, (j + STAGES) * TKD, h, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r0 + 8 * r;
    if (qpos >= S) continue;
    bf16* dqr = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int i = 4 * jn + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * jn + c0) =
          __floats2bfloat162_rn(dqa[i], dqa[i + 1]);
    }
  }
}

template <int D>
int launch_dq_wgmma_d(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, const int64_t* st,
                      float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = kft::encode_bshd(&tq, q, B, S, H, D, st[0], st[1], st[2], TQD);
  if (!err)
    err = kft::encode_bshd(&tk, k, B, S, H, D, st[3], st[4], st[5], TKD);
  if (!err)
    err = kft::encode_bshd(&tv, v, B, S, H, D, st[6], st[7], st[8], TKD);
  if (!err)
    err = kft::encode_bshd(&tdo, dout, B, S, H, D, st[9], st[10], st[11],
                           TQD);
  if (err) return err;
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_wgmma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + TQD - 1) / TQD);
  flash_bwd_dq_kernel_wgmma<D><<<grid, WG, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, S,
      strides_at(st, 4), scale, causal);
  return (int)cudaGetLastError();
}

int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int S, int H, int D, const int64_t* st,
                    float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dq_wgmma_d<32>(q, k, v, dout, lse, delta, dq, B, S, H,
                                   st, scale, causal, stream);
    case 64:
      return launch_dq_wgmma_d<64>(q, k, v, dout, lse, delta, dq, B, S, H,
                                   st, scale, causal, stream);
    case 128:
      return launch_dq_wgmma_d<128>(q, k, v, dout, lse, delta, dq, B, S, H,
                                    st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: int64[18] = (b, s, h) element strides of q, k, v, dO, dK, dV.
// dtype: 0 = float32 (scalar path), 1 = bfloat16 (tensor-core path).
// lse, delta: (b, h, s) f32, contiguous.
extern "C" int kft_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* strides, int B, int S, int H, int D, int dtype, int causal,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, B, S, H, D, st,
                          scale, causal, s);
  if (dtype == 1)
    return launch_dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, B, S, H, D,
                            st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// strides: int64[15] = (b, s, h) element strides of q, k, v, dO, dQ.
// dtype: 0 = float32 (scalar path), 1 = bfloat16 (tensor-core path).
extern "C" int kft_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* strides, int B,
    int S, int H, int D, int dtype, int causal, float scale, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq_f32(q, k, v, dout, lse, delta, dq, B, S, H, D, st,
                         scale, causal, s);
  if (dtype == 1)
    return launch_dq_wgmma(q, k, v, dout, lse, delta, dq, B, S, H, D, st,
                           scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
