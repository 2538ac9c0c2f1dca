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
// What bounds it on the card: bytes and latency. Each live cache entry is
// read once and used for 4 * rep FLOPs per element, far below the ~295
// FLOP/byte ridge, so the floor is (live K/V bytes) / 3.35 TB/s; rep <= 8
// query rows are far below wgmma's M of 64, so the kernel stays on the
// CUDA cores. At the served sizes a (b, g) holds a few hundred live keys,
// so what costs is the latency of each read, not the bandwidth.
//
// Design: split-KV (flash-decoding), two launches.
//  1. flash_decode_kernel, grid (B * G, NSPLIT), NSPLIT = ceil(S / CHUNK)
//     from the cache length alone (pos is read on the device only, so the
//     launch needs no host sync). A block takes CHUNK keys of one (b, kv
//     head); a GQA group's rep query heads share every K/V read. A block
//     whose chunk starts past min(pos[b], S - 1) exits at once, writing
//     nothing, so the step's cost follows pos. A live block issues every 16-byte copy of its K and V chunk at once
//     (cp.async into shared memory: 2 bf16 keys of 128, or 4 int8 keys, a
//     warp-wide copy), then: logits of every (key, rep head) from K, each
//     the shuffle sum over the lanes of one key row; one max and one sum
//     per rep head over the chunk; P.V with threads over pairs of dims.
//     It writes its f32 partial (m, l, acc[rep][D]) to a workspace.
//  2. flash_decode_kernel_combine, one block per (b, kv head), merges the
//     partials of the live splits (min(pos[b], S - 1) / CHUNK + 1 of them,
//     none for pos[b] < 0, which gives zeros) in split order with the
//     reference's max(l, 1e-30) denominator and writes q's dtype.
// Every sum runs in a fixed order, so the bits are the same on every run.
// The cache is read through its batch/seq/head strides, so a layer's
// slice of the stacked (L, B, S, G, D) cache goes in without a copy; the
// copies need a 16-byte base and (b, s, g) strides (the wrapper copies a
// cache that has not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 64;  // keys per split (PERF.md: 32 against 64)
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

// 16 bytes of the cache as floats: 4 f32, 8 bf16 or 16 int8 values
__device__ __forceinline__ void unpack(uint4 w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(uint4 w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 w, float (&x)[16]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = (float)((int)(u[i] << (24 - 8 * j)) >> 24);
}

// two adjacent cache values as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
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

// One partial per (b, g, split): m[REP], l[REP], acc[REP][D], f32.
template <int D, int REP>
__host__ __device__ constexpr int partial_floats() {
  return REP * (D + 2);
}

template <typename TKV, int D, int REP>
struct Layout {
  static constexpr int EPL = 16 / (int)sizeof(TKV);  // values a 16-byte copy
  static constexpr int LPK = D / EPL;                 // lanes of a key row
  static constexpr int NKS = THREADS / LPK;           // key rows a pass
  static constexpr int KPT = (CHUNK + NKS - 1) / NKS; // passes over a chunk
  static constexpr int DP = D / 2;                    // P.V: dim pairs
  static constexpr int KG = THREADS / DP;             // P.V: key groups
  // shared memory: K and V chunks, then f32 q, logits, scales, the P.V
  // groups' sums, and the chunk's (m, l)
  static constexpr int KV_BYTES = 2 * CHUNK * D * (int)sizeof(TKV);
  static constexpr int F32S = REP * D + CHUNK * REP + 2 * CHUNK +
                              KG * REP * D + 2 * REP;
  static constexpr int BYTES = KV_BYTES + 4 * F32S;
};

// TQ: q/out dtype; TKV: cache dtype; QUANT: int8 cache with scales
template <typename TQ, typename TKV, int D, int REP, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ pos, float* __restrict__ ws,
                    int G, int S, Strides st, float scale) {
  using L = Layout<TKV, D, REP>;
  extern __shared__ uint4 smem[];
  TKV* kc = reinterpret_cast<TKV*>(smem);
  TKV* vc = kc + CHUNK * D;
  float* qsm = reinterpret_cast<float*>(vc + CHUNK * D);  // [REP][D], scaled
  float* lg = qsm + REP * D;          // [CHUNK][REP] logits, then P
  float* ksc = lg + CHUNK * REP;      // [CHUNK]
  float* vsc = ksc + CHUNK;           // [CHUNK]
  float* red = vsc + CHUNK;           // [KG][REP][D]
  float* ml = red + L::KG * REP * D;  // m[REP], l[REP]

  const int bg = blockIdx.x, split = blockIdx.y;
  const int b = bg / G, g = bg % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int last = min(pos[b], S - 1);
  const int c0 = split * CHUNK;
  if (c0 > last) return;  // past pos[b] (or pos[b] < 0): the combine skips it
  const int nk = min(CHUNK, last - c0 + 1);
  float* part = ws + ((int64_t)bg * gridDim.y + split) *
                         partial_floats<D, REP>();

  // every copy of the chunk in flight before any arithmetic: K, then V
  const TKV* kb = k + b * st.kb + g * st.kg + c0 * st.ks;
  const TKV* vb = v + b * st.vb + g * st.vg + c0 * st.vs;
  for (int i = tid; i < nk * L::LPK; i += THREADS) {
    const int j = i / L::LPK, c = (i % L::LPK) * L::EPL;
    cp_async16(kc + j * D + c, kb + j * st.ks + c);
  }
  cp_async_commit();
  for (int i = tid; i < nk * L::LPK; i += THREADS) {
    const int j = i / L::LPK, c = (i % L::LPK) * L::EPL;
    cp_async16(vc + j * D + c, vb + j * st.vs + c);
  }
  cp_async_commit();
  const TQ* qg = q + (int64_t)bg * REP * D;
  for (int i = tid; i < REP * D; i += THREADS)
    qsm[i] = to_f32(qg[i]) * scale;
  if (QUANT) {
    for (int j = tid; j < nk; j += THREADS) {
      ksc[j] = k_scale[b * st.sb + (c0 + j) * st.ss + g * st.sg];
      vsc[j] = v_scale[b * st.tb + (c0 + j) * st.ts + g * st.tg];
    }
  }
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();

  // logits: LPK lanes own a key row, EPL dims each
  {
    const int kr = tid / L::LPK, dl = tid % L::LPK;
    float kx[L::KPT][L::EPL];
#pragma unroll
    for (int t = 0; t < L::KPT; ++t) {
      const int j = min(kr + t * L::NKS, nk - 1);
      unpack(*reinterpret_cast<const uint4*>(kc + j * D + dl * L::EPL),
             kx[t]);
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float qx[L::EPL];
#pragma unroll
      for (int e = 0; e < L::EPL; e += 4) {
        const float4 f =
            *reinterpret_cast<const float4*>(qsm + r * D + dl * L::EPL + e);
        qx[e] = f.x;
        qx[e + 1] = f.y;
        qx[e + 2] = f.z;
        qx[e + 3] = f.w;
      }
#pragma unroll
      for (int t = 0; t < L::KPT; ++t) {
        float part_dot = 0.f;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) part_dot += qx[e] * kx[t][e];
#pragma unroll
        for (int off = 1; off < L::LPK; off <<= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
        const int j = kr + t * L::NKS;
        if (dl == 0 && j < nk)
          lg[j * REP + r] = QUANT ? part_dot * ksc[j] : part_dot;
      }
    }
  }
  cp_async_wait<0>();  // and the V copies
  __syncthreads();

  // one max and one sum per rep head over the chunk; P in place of the
  // logits, times the V scale after the sum
  for (int r = warp; r < REP; r += WARPS) {
    float mx = NEG_INF;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, lg[j * REP + r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(lg[j * REP + r] - mx);
      sum += p;
      lg[j * REP + r] = QUANT ? p * vsc[j] : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[r] = mx;
      ml[REP + r] = sum;
    }
  }
  __syncthreads();

  // P.V: a thread owns a pair of dims for every rep head, over the keys of
  // its group; the groups' sums meet in shared memory
  {
    const int dp = tid % L::DP, kgrp = tid / L::DP;
    float a[REP][2];
#pragma unroll
    for (int r = 0; r < REP; ++r) a[r][0] = a[r][1] = 0.f;
    for (int j = kgrp; j < nk; j += L::KG) {
      const float2 x = load2(vc + j * D + 2 * dp);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = lg[j * REP + r];
        a[r][0] += p * x.x;
        a[r][1] += p * x.y;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      red[(kgrp * REP + r) * D + 2 * dp] = a[r][0];
      red[(kgrp * REP + r) * D + 2 * dp + 1] = a[r][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < REP * D; i += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int kg = 0; kg < L::KG; ++kg) sum += red[kg * REP * D + i];
    part[2 * REP + i] = sum;
  }
  if (tid < 2 * REP) part[tid] = ml[tid];
}

// Merges the live partials of one (b, g) in split order.
template <typename TQ, int D, int REP>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel_combine(const float* __restrict__ ws,
                            const int* __restrict__ pos, TQ* __restrict__ out,
                            int G, int S, int nsplit) {
  constexpr int PF = partial_floats<D, REP>();
  const int bg = blockIdx.x;
  const int last = min(pos[bg / G], S - 1);
  const int nlive = last < 0 ? 0 : last / CHUNK + 1;
  const float* parts = ws + (int64_t)bg * nsplit * PF;
  TQ* og = out + (int64_t)bg * REP * D;
  for (int i = threadIdx.x; i < REP * D; i += THREADS) {
    const int r = i / D;
    float mx = NEG_INF;
    for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, parts[s * PF + r]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < nlive; ++s) {
      const float* p = parts + s * PF;
      const float w = expf(p[r] - mx);
      l += p[REP + r] * w;
      acc += p[2 * REP + i] * w;
    }
    og[i] = from_f32<TQ>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool QUANT, int D, int REP>
int launch_dr(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pos, void* out, void* ws, int B,
              int G, int S, const Strides& st, float scale,
              cudaStream_t stream) {
  constexpr int smem = Layout<TKV, D, REP>::BYTES;
  auto kern = flash_decode_kernel<TQ, TKV, D, REP, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (S + CHUNK - 1) / CHUNK;
  kern<<<dim3(B * G, nsplit), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<float*>(ws), G, S, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_kernel_combine<TQ, D, REP><<<B * G, THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(pos),
      static_cast<TQ*>(out), G, S, nsplit);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT, int D>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* ws, int B,
             int G, int S, int rep, const Strides& st, float scale,
             cudaStream_t stream) {
  switch (rep) {
    case 1: return launch_dr<TQ, TKV, QUANT, D, 1>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, st, scale, stream);
    case 2: return launch_dr<TQ, TKV, QUANT, D, 2>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, st, scale, stream);
    case 4: return launch_dr<TQ, TKV, QUANT, D, 4>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, st, scale, stream);
    case 8: return launch_dr<TQ, TKV, QUANT, D, 8>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, void* ws, int B,
           int G, int S, int rep, int D, const Strides& st, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 32: return launch_d<TQ, TKV, QUANT, 32>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, rep, st, scale, stream);
    case 64: return launch_d<TQ, TKV, QUANT, 64>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, rep, st, scale, stream);
    case 128: return launch_d<TQ, TKV, QUANT, 128>(
        q, k, v, ks, vs, pos, out, ws, B, G, S, rep, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Keys per split: the workspace of kft_flash_decode holds
// B * G * ceil(S / CHUNK) * rep * (D + 2) f32.
extern "C" int kft_flash_decode_chunk() { return CHUNK; }

// strides: int64[12] = (b, s, g) element strides of k, v, k_scale, v_scale.
// q_dtype: 0 = float32, 1 = bfloat16; quant: 0 = cache in q's dtype,
// 1 = int8 cache with k_scale / v_scale. q and out are contiguous
// (B, G, rep, D); pos is (B,) int32 on the device; workspace is f32 scratch
// of the size above. k and v: 16-byte base and (b, s, g) strides.
extern "C" int kft_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* pos, void* out, void* workspace,
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
  void* ws = workspace;
  if (q_dtype == 0 && !quant)
    return launch<float, float, false>(q, k, v, k_scale, v_scale, pos, out,
                                       ws, B, G, S, rep, D, st, scale, s);
  if (q_dtype == 1 && !quant)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, k_scale, v_scale, pos, out, ws, B, G, S, rep, D, st, scale,
        s);
  if (q_dtype == 0 && quant)
    return launch<float, int8_t, true>(q, k, v, k_scale, v_scale, pos, out,
                                       ws, B, G, S, rep, D, st, scale, s);
  if (q_dtype == 1 && quant)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k, v, k_scale, v_scale, pos, out, ws, B, G, S, rep, D, st, scale,
        s);
  return (int)cudaErrorInvalidValue;
}
