// Flash-attention forward for Hopper (sm_90a), bf16 or f32, d_head 32/64/128.
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/attention.py
// `_flash_kernel` (launched by `_flash_forward`): FlashAttention-2 forward,
// causal or not, with an f32 online softmax (running max, running sum,
// f32 accumulator), the -1e30 mask, the max(l, 1e-30) denominator and an
// optional per-row log-sum-exp for the backward.
//
// Layout: q, k, v, o are (b, s, h, d) read and written through their
// batch/seq/head strides (d contiguous), so the wrapper copies nothing.
// GQA callers repeat K/V heads before the call, as in the reference.
//
// Design. One block per (batch, head, tile of BQ query rows). The TPU's
// sequential kv grid axis becomes a loop inside the block over kv tiles of
// BK keys, staged in shared memory as f32; the loop stops at the diagonal
// when causal. Each query row is owned by TPR adjacent threads that split
// d_head between them (thread t owns dims t, t+TPR, ...: neighbouring
// threads read neighbouring shared-memory words, no bank conflicts); a row's
// q slice, accumulator slice and the tile's logits live in registers, and a
// logit is the xor-shuffle sum of the TPR partial dots. The ragged edge
// (s not a multiple of BQ or BK) is masked here, so any length works and
// the caller needs no fall-back path.
//
// What bounds it on the card: causal bf16 work is 2*s*s*d FLOPs per
// (b, h) against 8*s*d bytes of q, k, v and o, i.e. s/4 FLOP per byte, so
// below s ~ 1200 (the H100's ~295 FLOP/byte ridge) the floor is the bytes
// and above it the tensor-core rate. This first kernel does its products
// as scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak, not 989), so the
// CUDA cores, not either floor, bound it; mma/wgmma with TMA-fed K/V tiles
// and warp specialisation is the later step. In bf16 the
// probabilities are rounded to bf16 before the PV product, as the reference
// casts p to v's dtype (attention.py:86-88).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile
constexpr int TPR = 4;         // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG_INF = -1e30f;

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
// p rounded to v's dtype before the PV product (identity for f32)
template <typename T> __device__ __forceinline__ float round_like(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int S,
                 int64_t sqb, int64_t sqs, int64_t sqh,
                 int64_t skb, int64_t sks, int64_t skh,
                 int64_t svb, int64_t svs, int64_t svh,
                 int64_t sob, int64_t sos, int64_t soh,
                 float scale, int causal) {
  constexpr int DPT = D / TPR;  // dims per thread
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qpos = q0 + row;
  const bool live = qpos < S;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = live ? to_f32(qb[qpos * sqs + i * TPR + t]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // keys past the last query row of this tile are all masked when causal
  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      ks[j][c] = kp < S ? to_f32(kb[kp * sks + c]) : 0.f;
      vs[j][c] = kp < S ? to_f32(vb[kp * svs + c]) : 0.f;
    }
    __syncthreads();

    float sc[BK];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][i * TPR + t];
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kp = k0 + j;
      const bool valid = kp < S && (!causal || kp <= qpos);
      sc[j] = valid ? part : NEG_INF;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kp = k0 + j;
      const bool valid = kp < S && (!causal || kp <= qpos);
      const float p = valid ? __expf(sc[j] - m_new) : 0.f;
      psum += p;
      sc[j] = round_like<T>(p);
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) a += sc[j] * vs[j][i * TPR + t];
      acc[i] = a;
    }
    __syncthreads();
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + b * sob + h * soh + qpos * sos;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[i * TPR + t] = from_f32<T>(acc[i] / denom);
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * H + h) * S + qpos] = m + logf(denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int D, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  auto args = [&](auto kern) {
    kern<<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), H, S, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  };
  switch (D) {
    case 32: args(flash_fwd_kernel<T, 32>); break;
    case 64: args(flash_fwd_kernel<T, 64>); break;
    case 128: args(flash_fwd_kernel<T, 128>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// strides: int64[12] = (b, s, h) element strides of q, k, v, o in order.
// dtype: 0 = float32, 1 = bfloat16. lse: (b, h, s) f32 or NULL.
extern "C" int kft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const void* strides, int B, int S,
                                       int H, int D, int dtype, int causal,
                                       float scale, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, B, S, H, D, st, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, S, H, D, st, scale,
                                 causal, s);
  return (int)cudaErrorInvalidValue;
}
