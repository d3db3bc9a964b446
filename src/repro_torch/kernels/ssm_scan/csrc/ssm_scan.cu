// Chunked linear-recurrence scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel ssm_scan_pallas
// (src/repro/kernels/ssm_scan/ssm_scan.py:49, body _kernel): per (batch,
// head) the recurrence S_t = a_t S_{t-1} + k_t v_t^T, y_t = S_t^T q_t, with
// a_t = exp(log_a_t), evaluated chunk by chunk with the fp32 (K x V) state
// carried across chunks.  Every input is upcast to fp32 and all arithmetic
// is fp32 (CUDA-core FMAs, expf without fast math); y is written in v's
// dtype.  Within a sub-chunk of T = 64 steps with cum = cumsum(log_a):
//
//   P[i,j] = (q_i . k_j) exp(cum_i - cum_j)  for j <= i, else 0
//   y_i    = sum_j P[i,j] v_j + exp(cum_i) q_i S
//   S      = exp(cum_T) S + sum_j exp(cum_T - cum_j) k_j v_j^T
//
// The reference chunks by 128 (or by S when 128 does not divide S); the
// kernel's 64-step sub-chunks give the same function up to fp32 rounding,
// and a ragged last sub-chunk is masked, so S may be any length.  The
// masked decay is computed only for j <= i (as jnp.where in the oracle), so
// exp never overflows above the diagonal.
//
// Work split.  One head's xLSTM state (K = V = 1024) is 4 MB of fp32,
// against 227 KB of shared memory, but its columns are independent:
// y[:, slab] needs only S[:, slab] and v[:, slab].  So the grid is (V /
// VT column slabs, B * H), and each block keeps its K x VT slab of S
// resident in shared memory while it walks the sub-chunks in order.  Per
// sub-chunk, 256 threads:
//   A. stream q and k through K-tiles of 32 (transposed in shared memory);
//      each thread accumulates a 4 x 4 tile of q k^T and the same 4 rows of
//      q S[:, slab] (4 x VT/16) in registers;
//   B. mask and decay P into shared memory, add P v[:, slab], store y;
//   C. stream k again through K-tiles of 128, weighted by exp(cum_T -
//      cum_j), and update the slab: each thread owns 4 x VT/8 of S.
// VT is 32 or 64, chosen per call by the wrapper: 64 where its slab fits
// and the grid still covers the SMs (Zamba2: K = 64, 32 heads), else 32
// (xLSTM: a 1024 x 32 slab is 128 KB; 187 KB of shared memory per block).
//
// Cost of the split: q k^T is recomputed by each of the V / VT slabs of a
// head.  At xLSTM's prefill (K = V = 1024, VT = 32) that is T^2 K per slab
// and sub-chunk against 2 T K VT for q S and the state update, so the block
// does 2x the useful work of the chunked form; at Zamba2's (K = 64, V =
// 128, VT = 64) 1.25x.
//
// Bound on the H100.  At xLSTM's prefill (B = 4, S = 2048, 4 heads, K = V
// = 1024, bf16) q, k, v and y are 268 MB, 0.080 ms at 3.35 TB/s.  The
// least work is the step-by-step recurrence's 4 K V FLOP per step and head
// (k_t v_t^T into S, S^T q_t; the chunked forms add their masked L x L
// products), 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s bf16, so operations
// bound it.  This kernel runs on the CUDA cores in fp32 (67
// TFLOP/s at most), with no overlap of loads and compute; tensor cores
// (with a split of the fp32 operands), TMA and a persistent schedule are
// later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SUB 64          // steps per sub-chunk
#define KT 32           // K-tile of phase A
#define KC 128          // K-tile of phase C (and the padding of S's rows)
#define LDT (SUB + 4)   // leading dimension of the transposed q/k and P tiles
#define LDC (KC + 4)    // leading dimension of phase C's k tile
#define WORK (SUB * LDC > 2 * KT * LDT ? SUB * LDC : 2 * KT * LDT)
#define THREADS 256

struct ScanParams {
  int64_t B, S, H, K, V, Kpad;
  int64_t qs[3], ks[3], vs[3], ls[3];   // (batch, seq, head) strides
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const __half* p) {
  return __half2float(*p);
}

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void st(__half* p, float x) {
  *p = __float2half(x);
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* x) {
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float* x) {
  if constexpr (N == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// shared memory of one block, in floats
__host__ __device__ inline int64_t smem_floats(int64_t kpad, int vt) {
  return kpad * vt + WORK + SUB * LDT + SUB * vt + 4 * SUB;
}

template <typename T, int VT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ la,
                T* __restrict__ y, const ScanParams p) {
  constexpr int CV = VT / 16;   // y columns per thread (phases A, B)
  constexpr int CC = VT / 8;    // S columns per thread (phase C)
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);   // [Kpad][VT]
  float* work = Ss + p.Kpad * VT;
  float* qs = work;                              // [KT][LDT]: qs[kk][i]
  float* ks = work + KT * LDT;                   // [KT][LDT]: ks[kk][j]
  float* kc = work;                              // [SUB][LDC]: kc[j][kk]
  float* Pt = work + WORK;                       // [SUB][LDT]: Pt[j][i]
  float* vsl = Pt + SUB * LDT;                   // [SUB][VT]
  float* cum = vsl + SUB * VT;                   // [SUB]
  float* ein = cum + SUB;                        // exp(cum_i)
  float* wj = ein + SUB;                         // exp(cum_T - cum_j)
  float* etot = wj + SUB;                        // exp(cum_T)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;        // phases A, B
  const int vx = tid & 7, ky = tid >> 3;         // phase C
  const int64_t b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int64_t c0 = (int64_t)blockIdx.x * VT;
  const T* qb = q + b * p.qs[0] + h * p.qs[2];
  const T* kb = k + b * p.ks[0] + h * p.ks[2];
  const T* vb = v + b * p.vs[0] + h * p.vs[2];
  const float* lb = la + b * p.ls[0] + h * p.ls[2];
  const int64_t ka = (p.K + KT - 1) / KT * KT;   // phase A's rows of S

  for (int64_t e = tid; e < p.Kpad * VT; e += THREADS) Ss[e] = 0.f;

  for (int64_t t0 = 0; t0 < p.S; t0 += SUB) {
    const int tn = (int)min((int64_t)SUB, p.S - t0);
    __syncthreads();   // the previous sub-chunk is done with every buffer
    if (tid < SUB) cum[tid] = tid < tn ? lb[(t0 + tid) * p.ls[1]] : 0.f;
    for (int e = tid; e < SUB * VT; e += THREADS) {
      const int j = e / VT, c = e % VT;
      vsl[e] = (j < tn && c0 + c < p.V) ? ld(vb + (t0 + j) * p.vs[1] + c0 + c)
                                         : 0.f;
    }
    __syncthreads();
    if (tid == 0) {    // in step order, as the oracle's cumsum
      for (int i = 1; i < SUB; ++i) cum[i] += cum[i - 1];
    }
    __syncthreads();
    if (tid < SUB) {
      const float total = cum[tn - 1];
      ein[tid] = expf(cum[tid]);
      wj[tid] = tid < tn ? expf(total - cum[tid]) : 0.f;
      if (tid == 0) *etot = expf(total);
    }

    // A. q k^T (4 x 4 per thread) and q S[:, slab] (4 x CV per thread)
    float s[4][4], o[4][CV];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < CV; ++c) o[r][c] = 0.f;
    }
    for (int64_t k0 = 0; k0 < ka; k0 += KT) {
      __syncthreads();
      for (int e = tid; e < SUB * KT; e += THREADS) {
        const int i = e / KT, kk = e % KT;
        const bool ok = i < tn && k0 + kk < p.K;
        qs[kk * LDT + i] = ok ? ld(qb + (t0 + i) * p.qs[1] + k0 + kk) : 0.f;
        ks[kk * LDT + i] = ok ? ld(kb + (t0 + i) * p.ks[1] + k0 + kk) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float a[4], bb[4], sv[CV];
        lds<4>(qs + kk * LDT + 4 * ty, a);
        lds<4>(ks + kk * LDT + 4 * tx, bb);
        lds<CV>(Ss + (k0 + kk) * VT + CV * tx, sv);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
#pragma unroll
          for (int c = 0; c < CV; ++c) o[r][c] = fmaf(a[r], sv[c], o[r][c]);
        }
      }
    }

    // B. P = (q k^T) * decay below the diagonal, stored as Pt[j][i]; then
    //    y = exp(cum_i) q S + P v
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * tx + c;
      float pc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        pc[r] = (j <= i && i < tn) ? s[r][c] * expf(cum[i] - cum[j]) : 0.f;
      }
      sts<4>(Pt + j * LDT + 4 * ty, pc);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = ein[4 * ty + r];
#pragma unroll
      for (int c = 0; c < CV; ++c) o[r][c] *= d;
    }
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      float pp[4], vv[CV];
      lds<4>(Pt + j * LDT + 4 * ty, pp);
      lds<CV>(vsl + j * VT + CV * tx, vv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CV; ++c) o[r][c] = fmaf(pp[r], vv[c], o[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      if (i >= tn) continue;
      T* yrow = y + ((b * p.S + t0 + i) * p.H + h) * p.V + c0 + CV * tx;
#pragma unroll
      for (int c = 0; c < CV; ++c)
        if (c0 + CV * tx + c < p.V) st(yrow + c, o[r][c]);
    }

    // C. S = exp(cum_T) S + sum_j (exp(cum_T - cum_j) k_j) v_j^T
    const float et = *etot;
    for (int64_t k0 = 0; k0 < p.Kpad; k0 += KC) {
      __syncthreads();
      for (int e = tid; e < SUB * KC; e += THREADS) {
        const int j = e / KC, kk = e % KC;
        kc[j * LDC + kk] = (j < tn && k0 + kk < p.K)
            ? ld(kb + (t0 + j) * p.ks[1] + k0 + kk) * wj[j] : 0.f;
      }
      __syncthreads();
      float acc[4][CC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
      for (int j = 0; j < tn; ++j) {
        float kw[4], vv[CC];
        lds<4>(kc + j * LDC + 4 * ky, kw);
        lds<CC>(vsl + j * VT + CC * vx, vv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CC; ++c)
            acc[r][c] = fmaf(kw[r], vv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* srow = Ss + (k0 + 4 * ky + r) * VT + CC * vx;
        float cur[CC];
        lds<CC>(srow, cur);
#pragma unroll
        for (int c = 0; c < CC; ++c) cur[c] = fmaf(et, cur[c], acc[r][c]);
        sts<CC>(srow, cur);
      }
    }
  }
}

static const int kMaxSmem = 232448;   // opt-in shared memory per block

template <typename T, int VT>
static int launch(const ScanParams& p, const void* q, const void* k,
                  const void* v, const float* la, void* y,
                  cudaStream_t stream) {
  const int64_t smem = smem_floats(p.Kpad, VT) * (int64_t)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<T, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.V + VT - 1) / VT), (unsigned)(p.B * p.H));
  ssm_scan_kernel<T, VT><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), la, static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_vt(int vt, const ScanParams& p, const void* q,
                     const void* k, const void* v, const float* la, void* y,
                     cudaStream_t stream) {
  switch (vt) {
    case 32: return launch<T, 32>(p, q, k, v, la, y, stream);
    case 64: return launch<T, 64>(p, q, k, v, la, y, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory in bytes that a block needs for head dim K and slab VT.
extern "C" int64_t repro_ssm_scan_smem(int64_t K, int vt) {
  const int64_t kpad = (K + KC - 1) / KC * KC;
  return smem_floats(kpad, vt) * (int64_t)sizeof(float);
}

// dtype of q, k, v and y: 0 float32, 1 bfloat16, 2 float16; log_a is
// float32.  vt: 32 or 64.  dims (int64): B, S, H, K, V, then the (batch,
// seq, head) strides of q, k, v and log_a in elements (the last dimension
// of q, k and v is contiguous).  y is contiguous (B, S, H, V).  Returns a
// cudaError_t.
extern "C" int repro_ssm_scan(int dtype, int vt, const void* q, const void* k,
                              const void* v, const float* la, void* y,
                              const int64_t* dims, void* stream) {
  ScanParams p;
  p.B = dims[0]; p.S = dims[1]; p.H = dims[2]; p.K = dims[3]; p.V = dims[4];
  p.Kpad = (p.K + KC - 1) / KC * KC;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = dims[5 + i];
    p.ks[i] = dims[8 + i];
    p.vs[i] = dims[11 + i];
    p.ls[i] = dims[14 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_vt<float>(vt, p, q, k, v, la, y, st);
    case 1: return launch_vt<__nv_bfloat16>(vt, p, q, k, v, la, y, st);
    case 2: return launch_vt<__half>(vt, p, q, k, v, la, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
