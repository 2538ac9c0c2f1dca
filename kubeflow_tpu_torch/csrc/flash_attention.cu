// Flash-attention forward for Hopper (sm_90a), bf16 or f32, d_head 32/64/128.
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/attention.py
// `_flash_kernel` (launched by `_flash_forward`): FlashAttention-2 forward,
// causal or not, with an f32 online softmax (running max, running sum,
// f32 accumulator), the -1e30 mask, the max(l, 1e-30) denominator and an
// optional per-row log-sum-exp for the backward.
//
// Layout: q, k, v, o are (b, s, h, d) read and written through their
// batch/seq/head strides (d contiguous). The bf16 path reads q, k, v with
// TMA, so their base and strides must be multiples of 16 bytes (the
// wrapper copies a tensor that is not). GQA callers repeat K/V heads
// before the call, as in the reference.
//
// Two paths, chosen by dtype inside the one C entry point:
//
// bf16: tensor cores. One block of one warpgroup (128 threads) per
// (batch, head, tile of 64 query rows); the causal query tiles are
// launched heaviest first (grid y reversed), so the short tiles fill the
// tail. Q comes in once by TMA; K and V tiles of 64 keys come through a
// two-stage ring in shared memory (bf16, swizzled, filled by TMA onto
// mbarriers), the next tile landing while this one is used. Per tile:
// S = Q.K^T by wgmma (both operands in shared memory, f32 accumulator in
// registers), scaled in f32 by scale * log2(e) after the product (q is
// never rounded after scaling), the online softmax on the accumulator
// fragments (row max and sum over the quad of threads that owns a row;
// l sums the unrounded p, as the reference does), then O += P.V by wgmma
// with P rounded to bf16 in registers as the A operand (the reference
// casts p to v's dtype, attention.py:86-88) and V read transposed from
// shared memory. Only the diagonal tile (causal) and the ragged last tile
// (s not a multiple of 64) pay for the mask; tiles right of the diagonal
// are never loaded. What bounds it on the card: causal work is 2*s*s*d
// FLOPs per (b, h) against 8*s*d bytes, s/4 FLOP per byte, so below
// s ~ 1200 the floor is the bytes and above it the tensor-core rate
// (989 TFLOP/s); at the train shape (s 1024) the kernel is far from
// both, held back by the softmax between two dependent products, which a
// single warpgroup cannot overlap (ptxas's registers and the measured
// times are in PERF.md).
//
// f32: CUDA cores. TF32 tensor cores would lose the 2e-5 agreement the f32
// checks hold, so f32 keeps the scalar kernel: one block per (batch, head,
// 64 query rows), each row owned by TPR adjacent threads that split d_head
// (neighbouring threads read neighbouring shared-memory words), K/V tiles
// of 32 keys staged in shared memory as f32, a logit the xor-shuffle sum of
// the TPR partial dots. Bound by the CUDA cores' 67 TFLOP/s.
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile
constexpr int TPR = 4;         // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = live ? qb[qpos * sqs + i * TPR + t] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // keys past the last query row of this tile are all masked when causal
  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      ks[j][c] = kp < S ? kb[kp * sks + c] : 0.f;
      vs[j][c] = kp < S ? vb[kp * svs + c] : 0.f;
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
      sc[j] = p;
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
    float* ob = o + b * sob + h * soh + qpos * sos;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[i * TPR + t] = acc[i] / denom;
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * H + h) * S + qpos] = m + logf(denom);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int D, const int64_t* st,
               float scale, int causal, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  auto args = [&](auto kern) {
    kern<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), H, S, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  };
  switch (D) {
    case 32: args(flash_fwd_kernel<32>); break;
    case 64: args(flash_fwd_kernel<64>); break;
    case 128: args(flash_fwd_kernel<128>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 path
using kft::bf16;
constexpr int WG = 128;      // one warpgroup
constexpr int TQ = 64;       // query rows per block: wgmma's M
constexpr int TK = 64;       // keys per K/V tile
constexpr int STAGES = 2;    // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr int fwd_smem_bytes() {
  return (TQ + 2 * STAGES * TK) * D * 2 + 1024;  // + alignment slack
}

template <int D>
__device__ __forceinline__ void load_kv(bf16* kd, bf16* vd, uint64_t* bar,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int k0, int h,
                                        int b) {
  kft::mbar_expect_tx(bar, 2 * TK * D * 2);
  kft::tma_tile<D, TK>(kd, tk, bar, k0, h, b);
  kft::tma_tile<D, TK>(vd, tv, bar, k0, h, b);
}

template <int D>
__global__ void __launch_bounds__(WG)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse, int H,
                       int S, int64_t sob, int64_t sos, int64_t soh,
                       float scale_log2, int causal) {
  constexpr int TILE = TK * D;
  extern __shared__ uint8_t raw[];
  bf16* qs = reinterpret_cast<bf16*>(kft::align1024(raw));
  bf16* ks = qs + TQ * D;
  bf16* vs = ks + STAGES * TILE;
  __shared__ uint64_t qbar, kvbar[STAGES];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TQ;
  // keys past the last query row of this tile are all masked when causal
  const int kend = causal ? min(S, q0 + TQ) : S;
  const int ntiles = (kend + TK - 1) / TK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    kft::mbar_init(&qbar, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) kft::mbar_init(&kvbar[i], 1);
    kft::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    kft::mbar_expect_tx(&qbar, TQ * D * 2);
    kft::tma_tile<D, TQ>(qs, &tq, &qbar, q0, h, b);
    for (int j = 0; j < STAGES && j < ntiles; ++j)
      load_kv<D>(ks + j * TILE, vs + j * TILE, &kvbar[j], &tk, &tv, j * TK,
                 h, b);
  }

  // this thread's rows of the tile: r0 and r0 + 8; its columns in each
  // 8-column group: c0 and c0 + 1
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of scale*log2(e)*q.k
  float l[2] = {0.f, 0.f};        // this thread's share of the running sum

  kft::mbar_wait(&qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % STAGES;
    bf16* kt = ks + slot * TILE;
    bf16* vt = vs + slot * TILE;
    kft::mbar_wait(&kvbar[slot], (j / STAGES) & 1);

    float s[TK / 2];
    kft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      kft::wgmma_ss(s, kft::desc_k<D, TQ>(qs, kk), kft::desc_k<D, TK>(kt, kk),
                    kk > 0);
    kft::wgmma_commit();
    kft::wgmma_wait<0>();
    kft::reg_fence(s);

    const int k0 = j * TK;
    const bool edge = j == ntiles - 1 && (causal || S % TK != 0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c0 + i % 2;
        const int qpos = q0 + r0 + 8 * ((i / 2) % 2);
        if (key >= S || (causal && key > qpos)) x = -INFINITY;
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const float p = exp2f(s[i] - m[(i / 2) % 2]);  // 0 where masked
      l[(i / 2) % 2] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) % 2];

    uint32_t a[TK / 16][4];
    kft::to_a_frags(s, a);
    kft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      kft::wgmma_rs_tb(oacc, a[kk], kft::desc_mn<D, TK>(vt, kk), 1);
    kft::wgmma_commit();
    kft::wgmma_wait<0>();
    kft::reg_fence(oacc);

    __syncthreads();  // every warp is done with this slot: refill it
    if (tid == 0 && j + STAGES < ntiles)
      load_kv<D>(kt, vt, &kvbar[slot], &tk, &tv, (j + STAGES) * TK, h, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = q0 + r0 + 8 * r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = o + b * sob + h * soh + qpos * sos;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int i = 4 * jn + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jn + c0) =
          __floats2bfloat162_rn(oacc[i] / denom, oacc[i + 1] / denom);
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * H + h) * S + qpos] = m[r] * LN2 + logf(denom);
  }
}

template <int D>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = kft::encode_bshd(&tq, q, B, S, H, D, st[0], st[1], st[2], TQ);
  if (!err) err = kft::encode_bshd(&tk, k, B, S, H, D, st[3], st[4], st[5], TK);
  if (!err) err = kft::encode_bshd(&tv, v, B, S, H, D, st[6], st[7], st[8], TK);
  if (err) return err;
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + TQ - 1) / TQ);
  flash_fwd_kernel_wgmma<D><<<grid, WG, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, S,
      st[9], st[10], st[11], scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int S, int H, int D, const int64_t* st,
                 float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wgmma_d<32>(q, k, v, o, lse, B, S, H, st, scale, causal,
                                stream);
    case 64:
      return launch_wgmma_d<64>(q, k, v, o, lse, B, S, H, st, scale, causal,
                                stream);
    case 128:
      return launch_wgmma_d<128>(q, k, v, o, lse, B, S, H, st, scale, causal,
                                 stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: int64[12] = (b, s, h) element strides of q, k, v, o in order.
// dtype: 0 = float32 (scalar path), 1 = bfloat16 (tensor-core path).
// lse: (b, h, s) f32 or NULL.
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
    return launch_f32(q, k, v, o, lse, B, S, H, D, st, scale, causal, s);
  if (dtype == 1)
    return launch_wgmma(q, k, v, o, lse, B, S, H, D, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
