// Flash-decode attention for Hopper (sm_90a): one query token per row
// against the un-repeated KV cache; bf16/f32 cache, or int8 with scales.
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/decode_attention.py
// `_decode_kernel` (launched by `flash_decode_attention`): q (B, G, rep, D)
// contracts against the (B, S, G, D) cache without repeating it; entries
// s > pos[b] are dead; int8 K/V carry per-position (B, S, G) f32 scales
// folded outside the products — the K scale onto the logits, the V scale
// onto P after the softmax-denominator sum (decode_attention.py:65-87).
//
// Design. One block per (batch row, kv head): a GQA group's rep query
// heads share every K/V read. The loop runs over s = 0 .. pos[b] only, so
// the step's cost follows pos, not max_seq_len (the reference skips whole
// blocks past pos; here nothing past pos is read at all). The block's four
// warps take keys round-robin; in a warp each lane owns D/32 dims, a
// logit is a warp-shuffle sum, and each warp keeps its own f32 online
// softmax (running max, sum, accumulator) for every rep head. The warps'
// states merge once at the end through shared memory, with the reference's
// -1e30 start and max(l, 1e-30) denominator. The cache is read through its
// batch/seq/head strides, so a layer's slice of the stacked (L, B, S, G, D)
// cache goes in without a copy.
//
// What bounds it on the card: bytes. Each live cache entry is read once and
// used for 4*rep FLOPs per element, far below the ~295 FLOP/byte ridge, so
// the floor is (live K/V bytes) / 3.35 TB/s. This kernel does not split the
// kv axis: at flagship serving (B = 8, G = 4) it runs 32 blocks, which
// leaves about 100 of the 132 SMs idle and caps the reachable bandwidth to
// what 32 SMs can pull. Split-KV with a combine pass (flash-decoding) is the
// later step; at the cache lengths served today a call is a few
// microseconds and the launch costs about as much.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {
  int64_t kb, ks, kg;   // k cache (B, S, G, D)
  int64_t vb, vs, vg;   // v cache
  int64_t sb, ss, sg;   // k_scale / v_scale (B, S, G)
  int64_t tb, ts, tg;
};

// TQ: q/out dtype; TKV: cache dtype; QUANT: int8 cache with scales
template <typename TQ, typename TKV, int D, int REP, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ pos, TQ* __restrict__ out,
                    int G, int S, Strides st, float scale) {
  constexpr int DPL = D / 32;  // dims per lane
  __shared__ float sm_m[WARPS][REP];
  __shared__ float sm_l[WARPS][REP];
  __shared__ float sm_acc[WARPS][REP][D];

  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int last = min(pos[b], S - 1);

  const TQ* qg = q + ((int64_t)b * G + g) * REP * D;
  float qr[REP][DPL], acc[REP][DPL], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[r][i] = to_f32(qg[r * D + lane * DPL + i]) * scale;
      acc[r][i] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const TKV* kb = k + b * st.kb + g * st.kg + lane * DPL;
  const TKV* vb = v + b * st.vb + g * st.vg + lane * DPL;
  for (int s = warp; s <= last; s += WARPS) {
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kr[i] = to_f32(kb[s * st.ks + i]);
      vr[i] = to_f32(vb[s * st.vs + i]);
    }
    float ksc = 1.f, vsc = 1.f;
    if (QUANT) {
      ksc = k_scale[b * st.sb + s * st.ss + g * st.sg];
      vsc = v_scale[b * st.tb + s * st.ts + g * st.tg];
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qr[r][i] * kr[i];
      float logit = warp_sum(part);
      if (QUANT) logit *= ksc;
      const float m_new = fmaxf(m[r], logit);
      const float alpha = __expf(m[r] - m_new);
      float p = __expf(logit - m_new);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
      if (QUANT) p *= vsc;  // V's scale joins after the denominator sum
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + p * vr[i];
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();

  TQ* og = out + ((int64_t)b * G + g) * REP * D;
  for (int idx = threadIdx.x; idx < REP * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][c] * f;
    }
    og[r * D + c] = from_f32<TQ>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool QUANT, int D>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, int B, int G,
             int S, int rep, const Strides& st, float scale,
             cudaStream_t stream) {
  auto go = [&](auto kern) {
    kern<<<B * G, THREADS, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pos),
        static_cast<TQ*>(out), G, S, st, scale);
  };
  switch (rep) {
    case 1: go(flash_decode_kernel<TQ, TKV, D, 1, QUANT>); break;
    case 2: go(flash_decode_kernel<TQ, TKV, D, 2, QUANT>); break;
    case 4: go(flash_decode_kernel<TQ, TKV, D, 4, QUANT>); break;
    case 8: go(flash_decode_kernel<TQ, TKV, D, 8, QUANT>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, int B, int G, int S,
           int rep, int D, const Strides& st, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 32: return launch_d<TQ, TKV, QUANT, 32>(q, k, v, ks, vs, pos, out,
                                                 B, G, S, rep, st, scale,
                                                 stream);
    case 64: return launch_d<TQ, TKV, QUANT, 64>(q, k, v, ks, vs, pos, out,
                                                 B, G, S, rep, st, scale,
                                                 stream);
    case 128: return launch_d<TQ, TKV, QUANT, 128>(q, k, v, ks, vs, pos,
                                                   out, B, G, S, rep, st,
                                                   scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: int64[12] = (b, s, g) element strides of k, v, k_scale, v_scale.
// q_dtype: 0 = float32, 1 = bfloat16; quant: 0 = cache in q's dtype,
// 1 = int8 cache with k_scale / v_scale. q and out are contiguous
// (B, G, rep, D); pos is (B,) int32 on the device.
extern "C" int kft_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* pos, void* out,
                                const void* strides, int B, int G, int S,
                                int rep, int D, int q_dtype, int quant,
                                float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || G <= 0 || S <= 0) return 0;
  const int64_t* p = static_cast<const int64_t*>(strides);
  const Strides st{p[0], p[1], p[2], p[3], p[4],  p[5],
                   p[6], p[7], p[8], p[9], p[10], p[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !quant)
    return launch<float, float, false>(q, k, v, k_scale, v_scale, pos, out,
                                       B, G, S, rep, D, st, scale, s);
  if (q_dtype == 1 && !quant)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, k_scale, v_scale, pos, out, B, G, S, rep, D, st, scale, s);
  if (q_dtype == 0 && quant)
    return launch<float, int8_t, true>(q, k, v, k_scale, v_scale, pos, out,
                                       B, G, S, rep, D, st, scale, s);
  if (q_dtype == 1 && quant)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k, v, k_scale, v_scale, pos, out, B, G, S, rep, D, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
