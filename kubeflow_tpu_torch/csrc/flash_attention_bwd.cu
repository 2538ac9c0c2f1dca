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
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K       (all f32)
// and cast dQ/dK/dV to the inputs' dtype at the end.
//
// Layout: q, k, v, dO, dQ, dK, dV are (b, s, h, d), read and written through
// their batch/seq/head strides (d contiguous); lse and delta are (b, h, s)
// f32.
// GQA callers repeat K/V heads before the call, as in the reference.
//
// Design. The TPU grid carries the dK/dV (or dQ) sum in VMEM scratch across
// its sequential inner grid axis; CUDA blocks run in no order, so that axis
// becomes a loop inside one block and the sum lives in registers.
//  - dK/dV: one block per (batch, head, tile of BK keys). Each key row is
//    owned by TPR = D/DPT adjacent threads that split d_head (thread t owns
//    dims t, t+TPR, ...); a row's k and v slices and its dK/dV accumulators
//    stay in registers. The block loops over query tiles of BQ rows (from the
//    diagonal when causal), staging q, dO, lse and delta in shared memory as
//    f32; per query row it forms the two dots (q.k and dO.v, xor-shuffle sums
//    of the TPR partials), P and dS, and accumulates dV += P dO, dK += dS q.
//  - dQ: one block per (batch, head, tile of BQ queries); a query row's q and
//    dO slices, lse, delta and dQ accumulator stay in registers, and the block
//    loops over key tiles of BK keys (up to the diagonal when causal), staging
//    k and v in shared memory, accumulating dQ += dS k.
//  The split into two kernels is the reference's: each output has one owner
//  block, so no atomics, and the result is the same on every run. The ragged
//  edge (s not a multiple of BQ or BK) is masked here, so any length works.
//
// What bounds it on the card: dK/dV does four (s x s x d) products per
// (b, h), dQ three, against ~10-12 bytes per (s, d) element moved: at the
// flagship's s = 1024 both are above the H100's ~295 FLOP/byte ridge, so the
// floor is the tensor-core rate. These first kernels do the products as
// scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak, not 989): the CUDA
// cores bound them. mma/wgmma with TMA-fed tiles is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;    // keys per dK/dV block, keys per dQ tile
constexpr int BQ = 32;    // query rows per dQ block, rows per dK/dV tile
constexpr int DPT = 16;   // head dims per thread: a row spans D / DPT threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(BK * (D / DPT))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, Strides sq,
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (int64_t)bh * S;
  const float* deltab = delta + (int64_t)bh * S;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  {
    const T* kb = k + b * sk.b + h * sk.h + kpos * sk.s;
    const T* vb = v + b * sv.b + h * sv.h + kpos * sv.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      kr[i] = live ? to_f32(kb[i * TPR + t]) : 0.f;
      vr[i] = live ? to_f32(vb[i * TPR + t]) : 0.f;
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
      qs[j][c] = qp < S ? to_f32(qb[qp * sq.s + c]) : 0.f;
      dos[j][c] = qp < S ? to_f32(dob[qp * sdo.s + c]) : 0.f;
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
    T* dkb = dk + b * sdk.b + h * sdk.h + kpos * sdk.s;
    T* dvb = dv + b * sdv.b + h * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dkb[i * TPR + t] = from_f32<T>(dka[i]);
      dvb[i * TPR + t] = from_f32<T>(dva[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D / DPT))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[DPT], dor[DPT], dqa[DPT];
  {
    const T* qrow = q + b * sq.b + h * sq.h + qpos * sq.s;
    const T* dorow = dout + b * sdo.b + h * sdo.h + qpos * sdo.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = live ? to_f32(qrow[i * TPR + t]) : 0.f;
      dor[i] = live ? to_f32(dorow[i * TPR + t]) : 0.f;
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
      ks[j][c] = kp < S ? to_f32(kb[kp * sk.s + c]) : 0.f;
      vs[j][c] = kp < S ? to_f32(vb[kp * sv.s + c]) : 0.f;
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
    T* dqb = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dqb[i * TPR + t] = from_f32<T>(dqa[i]);
  }
}

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, int D, const int64_t* st, float scale,
               int causal, cudaStream_t stream) {
  dim3 grid((S + BK - 1) / BK, B * H);
  auto go = [&](auto kern, int threads) {
    kern<<<grid, threads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, S, strides_at(st, 0),
        strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
        strides_at(st, 4), strides_at(st, 5), scale, causal);
  };
  switch (D) {
    case 32: go(flash_bwd_dkv_kernel<T, 32>, BK * (32 / DPT)); break;
    case 64: go(flash_bwd_dkv_kernel<T, 64>, BK * (64 / DPT)); break;
    case 128: go(flash_bwd_dkv_kernel<T, 128>, BK * (128 / DPT)); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, int D, const int64_t* st, float scale, int causal,
              cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  auto go = [&](auto kern, int threads) {
    kern<<<grid, threads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), H, S, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), scale,
        causal);
  };
  switch (D) {
    case 32: go(flash_bwd_dq_kernel<T, 32>, BQ * (32 / DPT)); break;
    case 64: go(flash_bwd_dq_kernel<T, 64>, BQ * (64 / DPT)); break;
    case 128: go(flash_bwd_dq_kernel<T, 128>, BQ * (128 / DPT)); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// strides: int64[18] = (b, s, h) element strides of q, k, v, dO, dK, dV.
// dtype: 0 = float32, 1 = bfloat16. lse, delta: (b, h, s) f32, contiguous.
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
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, S, H, D,
                             st, scale, causal, s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                     H, D, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// strides: int64[15] = (b, s, h) element strides of q, k, v, dO, dQ.
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
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, S, H, D, st,
                            scale, causal, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, S, H,
                                    D, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
