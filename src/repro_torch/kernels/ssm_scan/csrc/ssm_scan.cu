// Chunked linear-recurrence scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel ssm_scan_pallas
// (src/repro/kernels/ssm_scan/ssm_scan.py:49, body _kernel): per (batch,
// head) the recurrence S_t = a_t S_{t-1} + k_t v_t^T, y_t = S_t^T q_t, with
// a_t = exp(log_a_t), evaluated chunk by chunk with the fp32 (K x V) state
// carried across chunks; y is written in v's dtype.  Within a chunk of T =
// 64 steps with cum = cumsum(log_a):
//
//   P[i,j] = (q_i . k_j) exp(cum_i - cum_j)  for j <= i, else 0
//   y_i    = sum_j P[i,j] v_j + exp(cum_i) q_i S
//   S      = exp(cum_T) S + sum_j exp(cum_T - cum_j) k_j v_j^T
//
// The reference chunks by 128 (or by S when 128 does not divide S); the
// kernels' 64-step chunks give the same function up to fp32 rounding, and a
// ragged last chunk is masked, so S may be any length.  The decay is formed
// only for j <= i (as jnp.where in the oracle), so exp never overflows.
//
// Bound on the H100.  At xLSTM's prefill (B = 4, S = 2048, 4 heads, K = V
// = 1024, bf16) q, k, v and y are 268 MB, 0.080 ms at 3.35 TB/s.  The
// least work is the step-by-step recurrence's 4 K V FLOP per step and head
// (k_t v_t^T into S, S^T q_t), 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s bf16,
// so operations bound it.  At Zamba2's (32 heads, K = 64, V = 128, q and k
// broadcast over the heads) bytes bound it: 0.041 ms.
//
// Two routes, chosen by dtype.
//
// bf16 (the models' path): two kernels on the tensor cores (mma.sync
// m16n8k16 bf16 -> fp32).
//   scan_intra_kernel, grid (chunk, batch * head): the intra-chunk part,
//     once per (batch, head, chunk) and fully parallel over chunks.  q k^T
//     on the tensor cores (bf16 operands are exact, fp32 sums; the blocks
//     above the diagonal are skipped), cum by a warp scan, the masked
//     decay, and P written to a scratch as two bf16 halves (P = hi + lo,
//     lo = bf16(P - hi)), beside exp(cum_i), w_j = exp(cum_T - cum_j) and
//     exp(cum_T).  At xLSTM's prefill the scratch is 8 MB.
//   scan_state_kernel, grid (column slab of S, batch * head): the state
//     pass.  Each block keeps S^T for its VT = 32 or 128 columns of V
//     (rows of S^T) in mma accumulator registers across the chunk loop: 8
//     warps, each a 16-row slice of S^T times a K / WK slice of its
//     columns (WK = 8 / (VT / 16)).  Per chunk, in sub-steps of at most 64
//     columns of K:
//       y^T  += S^T q^T       (S^T's accumulators are the A fragments,
//                              split into bf16 hi and lo: two products)
//       S^T   = exp(cum_T) S^T + (v^T . w) k   (v^T w split the same way)
//     then y^T = exp(cum_i) y^T + v^T P^T (P's two halves from the
//     scratch), a sum over the WK warps of a slice through shared memory,
//     and y stored.  q, k and v tiles and the chunk's P come in by
//     cp.async (16-byte rows where K, V and the strides allow, else
//     element by element), double-buffered: the next sub-step's tiles load
//     while this one computes.  Every fp32 operand is a hi + lo pair, so
//     products carry about 16 bits of mantissa beyond bf16, near fp32
//     rounding.  K up to 1024 at VT = 32, 64 at VT = 128.
//
// fp32 and fp16: ssm_scan_kernel, on the CUDA cores in fp32 (inputs
// upcast, expf without fast math).  fp16 stays here because hi/lo splits
// of fp32 values in fp16 lose range and underflow.  One block per (column
// slab of VT = 32 or 64 columns of S, batch * head) keeps its K x VT slab
// of S in shared memory and walks 64-step sub-chunks: A. q k^T and q S
// over K-tiles of 32, B. the masked decay and P v, C. the state update over
// K-tiles of 128.  q k^T is recomputed by each slab (2x the useful work at
// xLSTM's shape); 67 TFLOP/s is the most the CUDA cores give.

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
__device__ __forceinline__ float ld(const __half* p) {
  return __half2float(*p);
}

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
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

// ------------------------------------------------------------- bf16 route
#define T2 64                 // steps per chunk of the bf16 route
#define LDP (T2 + 8)          // row of a P tile in shared memory (bf16)
#define CREC (2 * T2 + 4)     // coefficients of one (head, chunk), floats
#define KT1 64                // K-tile of scan_intra_kernel
#define LDK1 (KT1 + 8)
#define STHREADS 256

typedef __nv_bfloat16 bf16;

struct MmaParams {
  int64_t B, S, H, K, V, NC;              // NC chunks of T2 steps
  int64_t qs[3], ks[3], vs[3], ls[3];     // (batch, seq, head) strides
  int y32;                                // y float32 (else bf16)
};

__device__ __forceinline__ uint32_t s_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) as a bf16 pair hi and the pair of what hi leaves, lo
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                           y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Rows [0, T2) x columns [c0, c0 + ncols) of a strided bf16 matrix (row r
// at src + r * rs) into a shared tile with leading dimension ld; rows from
// tn on and columns from climit on read as 0.  VEC: 16-byte cp.async
// copies (ncols, c0, climit, rs and src 8-element aligned), else loads and
// stores element by element.
template <bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int64_t rs, int tn, int ncols,
                                          int64_t c0, int64_t climit) {
  if constexpr (VEC) {
    const int cpr = ncols / 8;
    for (int e = threadIdx.x; e < T2 * cpr; e += blockDim.x) {
      const int r = e / cpr, c = (e - r * cpr) * 8;
      const bool ok = r < tn && c0 + c < climit;
      cp16(s_addr(dst + r * ld + c), ok ? src + r * rs + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < T2 * ncols; e += blockDim.x) {
      const int r = e / ncols, c = e - r * ncols;
      dst[r * ld + c] = (r < tn && c0 + c < climit)
          ? src[r * rs + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

// The intra-chunk part of one (chunk, batch * head): P = q k^T masked and
// decayed, as bf16 hi and lo halves (T2 x T2 each) into P, and exp(cum_i),
// w_j = exp(cum_T - cum_j), exp(cum_T) into coef.  4 warps, each 16 rows
// of P; the K dimension in tiles of KT1, double-buffered.
template <bool VEC>
__global__ void __launch_bounds__(128)
scan_intra_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const float* __restrict__ la, uint32_t* __restrict__ P,
                  float* __restrict__ coef, const MmaParams p) {
  __shared__ __align__(128) bf16 qs[2][T2 * LDK1];
  __shared__ __align__(128) bf16 ks[2][T2 * LDK1];
  __shared__ float cum[T2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t ch = blockIdx.x, bh = blockIdx.y;
  const int64_t b = bh / p.H, h = bh % p.H, t0 = ch * T2;
  const int tn = (int)min((int64_t)T2, p.S - t0);
  const bf16* qb = q + b * p.qs[0] + t0 * p.qs[1] + h * p.qs[2];
  const bf16* kb = k + b * p.ks[0] + t0 * p.ks[1] + h * p.ks[2];
  const int nk = (int)((p.K + KT1 - 1) / KT1);

  load_tile<VEC>(qs[0], LDK1, qb, p.qs[1], tn, KT1, 0, p.K);
  load_tile<VEC>(ks[0], LDK1, kb, p.ks[1], tn, KT1, 0, p.K);
  cp_commit();
  if (warp == 0) {   // cum by a warp scan, two steps a lane
    const float* lb = la + b * p.ls[0] + t0 * p.ls[1] + h * p.ls[2];
    const float x0 = 2 * lane < tn ? lb[2 * lane * p.ls[1]] : 0.f;
    const float x1 = 2 * lane + 1 < tn ? lb[(2 * lane + 1) * p.ls[1]] : 0.f;
    float s = x0 + x1;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    const float ex = s - (x0 + x1);
    cum[2 * lane] = ex + x0;
    cum[2 * lane + 1] = ex + x0 + x1;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int it = 0; it < nk; ++it) {
    cp_wait_all();
    __syncthreads();
    if (it + 1 < nk) {
      load_tile<VEC>(qs[(it + 1) & 1], LDK1, qb, p.qs[1], tn, KT1,
                     (int64_t)(it + 1) * KT1, p.K);
      load_tile<VEC>(ks[(it + 1) & 1], LDK1, kb, p.ks[1], tn, KT1,
                     (int64_t)(it + 1) * KT1, p.K);
    }
    cp_commit();
    const bf16* qa = qs[it & 1];
    const bf16* ka = ks[it & 1];
#pragma unroll
    for (int kk = 0; kk < KT1 / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK1
                     + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > warp) continue;          // above the diagonal: P is 0
        uint32_t bb[4];
        ldsm_x4(bb, ka + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK1
                        + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }
  __syncthreads();   // cum written

  const int64_t rec = bh * p.NC + ch;
  uint32_t* Ph = P + rec * (T2 * T2);     // hi rows, then lo rows
  uint32_t* Pl = Ph + T2 * T2 / 2;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = 8 * n + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = warp * 16 + g + 8 * half;
      const bool live = i < tn;
      const float ci = cum[i];
      const float v0 = (live && j <= i)
          ? acc[n][2 * half] * expf(ci - cum[j]) : 0.f;
      const float v1 = (live && j + 1 <= i)
          ? acc[n][2 * half + 1] * expf(ci - cum[j + 1]) : 0.f;
      uint32_t hi, lo;
      split2(v0, v1, hi, lo);
      Ph[(i * T2 + j) / 2] = hi;
      Pl[(i * T2 + j) / 2] = lo;
    }
  }
  if (tid < T2) {
    float* cr = coef + rec * CREC;
    const float total = cum[tn - 1];
    cr[tid] = tid < tn ? expf(cum[tid]) : 0.f;
    cr[T2 + tid] = tid < tn ? expf(total - cum[tid]) : 0.f;
    if (tid == 0) cr[2 * T2] = expf(total);
  }
}

// Shared memory layout of scan_state_kernel, in bytes.
template <int WM, int KW>
struct StateLayout {
  static constexpr int WK = 8 / WM, VT = 16 * WM;
  static constexpr int KS = KW < 64 ? KW : 64;     // K columns a sub-step
  static constexpr int NS = KW / KS;               // sub-steps a chunk
  static constexpr int QKW = WK * KS;              // tile columns a sub-step
  static constexpr int LDQ = QKW + 8, LDV = VT + 8, LDR = VT + 4;
  static constexpr int QK = 0;                               // [2][2][T2][LDQ]
  static constexpr int VS = QK + 2 * 2 * T2 * LDQ * 2;       // [2][T2][LDV]
  static constexpr int PS = VS + 2 * T2 * LDV * 2;           // [2][2][T2][LDP]
  static constexpr int CS = PS + 2 * 2 * T2 * LDP * 2;       // [2][CREC]
  static constexpr int RED = CS + 2 * CREC * 4;              // [WK][T2][LDR]
  static constexpr int BYTES = RED + WK * T2 * LDR * 4;
};

// The state pass of one (column slab of VT columns of V, batch * head):
// S^T (VT x K) in accumulator registers across the chunks, y from S^T, q,
// v and the scratch's P (see the note at the top).
template <int WM, int KW, bool VEC>
__global__ void __launch_bounds__(STHREADS, 1)
scan_state_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const uint32_t* __restrict__ P,
                  const float* __restrict__ coef, void* __restrict__ y,
                  const MmaParams p) {
  using L = StateLayout<WM, KW>;
  constexpr int WK = L::WK, VT = L::VT, KS = L::KS, NS = L::NS;
  constexpr int LDQ = L::LDQ, LDV = L::LDV, LDR = L::LDR;
  constexpr int NT = KW / 8, NTS = KS / 8;   // n8 tiles of S^T a warp / step
  constexpr int PB = T2 / 16 / WK;           // 16-column blocks of P v a warp
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* qk = reinterpret_cast<bf16*>(smem + L::QK);
  bf16* vsm = reinterpret_cast<bf16*>(smem + L::VS);
  bf16* psm = reinterpret_cast<bf16*>(smem + L::PS);
  float* csm = reinterpret_cast<float*>(smem + L::CS);
  float* red = reinterpret_cast<float*>(smem + L::RED);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wk = warp / WM;
  const int64_t bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int64_t c0 = (int64_t)blockIdx.x * VT;
  const bf16* qb = q + b * p.qs[0] + h * p.qs[2];
  const bf16* kb = k + b * p.ks[0] + h * p.ks[2];
  const bf16* vb = v + b * p.vs[0] + h * p.vs[2];

  // tiles of stage (chunk ch, sub-step s) into q/k buffer buf; at s == 0
  // also the chunk's v slab, P halves and coefficients (buffer ch & 1)
  auto issue = [&](int64_t ch, int s, int buf) {
    const int64_t t0 = ch * T2;
    const int tn = (int)min((int64_t)T2, p.S - t0);
    bf16* qt = qk + (2 * buf) * T2 * LDQ;
    bf16* kt = qt + T2 * LDQ;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const int64_t col = (int64_t)w * KW + s * KS;
      load_tile<VEC>(qt + w * KS, LDQ, qb + t0 * p.qs[1], p.qs[1], tn, KS,
                     col, p.K);
      load_tile<VEC>(kt + w * KS, LDQ, kb + t0 * p.ks[1], p.ks[1], tn, KS,
                     col, p.K);
    }
    if (s == 0) {
      const int cb = (int)(ch & 1);
      load_tile<VEC>(vsm + cb * T2 * LDV, LDV, vb + t0 * p.vs[1], p.vs[1],
                     tn, VT, c0, p.V);
      const int64_t rec = bh * p.NC + ch;
      const bf16* pg = reinterpret_cast<const bf16*>(P + rec * (T2 * T2));
      bf16* pd = psm + cb * 2 * T2 * LDP;
      for (int e = tid; e < 2 * T2 * T2 / 8; e += STHREADS) {
        const int r = e / (T2 / 8), c = (e % (T2 / 8)) * 8;
        cp16(s_addr(pd + r * LDP + c), pg + r * T2 + c, true);
      }
      const float* cg = coef + rec * CREC;
      for (int e = tid; e < CREC / 4; e += STHREADS)
        cp16(s_addr(csm + cb * CREC + 4 * e), cg + 4 * e, true);
    }
  };

  float S[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[n][e] = 0.f;

  issue(0, 0, 0);
  cp_commit();
  for (int64_t ch = 0; ch < p.NC; ++ch) {
    const int cb = (int)(ch & 1);
    const int64_t t0 = ch * T2;
    const int tn = (int)min((int64_t)T2, p.S - t0);
    const bf16* vc = vsm + cb * T2 * LDV;
    const float* cc = csm + cb * CREC;
    float ya[8][4];                  // y^T: 16 rows (V) x 64 steps
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[n][e] = 0.f;

#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int buf = (int)((ch * NS + s) & 1);
      cp_wait_all();
      __syncthreads();    // this stage landed; the last one is done with
                          // the other buffers
      if (s + 1 < NS) issue(ch, s + 1, buf ^ 1);
      else if (ch + 1 < p.NC) issue(ch + 1, 0, buf ^ 1);
      cp_commit();
      const bf16* qt = qk + (2 * buf) * T2 * LDQ + wk * KS;
      const bf16* kt = qt + T2 * LDQ;

      // y^T += S^T q^T over this sub-step's columns, with S before the
      // chunk's update
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int n0 = s * NTS + 2 * kk;
        uint32_t ah[4], al[4];
        split2(S[n0][0], S[n0][1], ah[0], al[0]);
        split2(S[n0][2], S[n0][3], ah[1], al[1]);
        split2(S[n0 + 1][0], S[n0 + 1][1], ah[2], al[2]);
        split2(S[n0 + 1][2], S[n0 + 1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bq[4];
          ldsm_x4(bq, qt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ
                          + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(ya[2 * np], ah, bq[0], bq[1]);
          mma_bf16(ya[2 * np], al, bq[0], bq[1]);
          mma_bf16(ya[2 * np + 1], ah, bq[2], bq[3]);
          mma_bf16(ya[2 * np + 1], al, bq[2], bq[3]);
        }
      }

      // S^T = exp(cum_T) S^T + (v^T . w) k over the same columns
      const float et = cc[2 * T2];
#pragma unroll
      for (int n = 0; n < NTS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[s * NTS + n][e] *= et;
#pragma unroll
      for (int kk = 0; kk < T2 / 16; ++kk) {
        uint32_t av[4], ah[4], al[4];
        ldsm_x4_t(av, vc + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDV
                         + wm * 16 + ((lane >> 3) & 1) * 8);
        const float* wv = cc + T2 + kk * 16 + 2 * t;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack2(av[r]);
          const int o = r < 2 ? 0 : 8;
          split2(f.x * wv[o], f.y * wv[o + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < NTS / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bk, kt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3))
                               * LDQ + np * 16 + ((lane >> 4) << 3));
          float* s0 = S[s * NTS + 2 * np];
          float* s1 = S[s * NTS + 2 * np + 1];
          mma_bf16(s0, ah, bk[0], bk[1]);
          mma_bf16(s0, al, bk[0], bk[1]);
          mma_bf16(s1, ah, bk[2], bk[3]);
          mma_bf16(s1, al, bk[2], bk[3]);
        }
      }
    }

    // y^T = exp(cum_i) y^T + v^T P^T, this warp's columns of P v
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float e0 = cc[8 * n + 2 * t], e1 = cc[8 * n + 2 * t + 1];
      ya[n][0] *= e0;
      ya[n][1] *= e1;
      ya[n][2] *= e0;
      ya[n][3] *= e1;
    }
    const bf16* ph = psm + cb * 2 * T2 * LDP;
    const bf16* pl = ph + T2 * LDP;
#pragma unroll
    for (int kk = 0; kk < T2 / 16; ++kk) {
      uint32_t av[4];
      ldsm_x4_t(av, vc + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDV
                       + wm * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        // 16-column block nb of P v belongs to warp slice nb / PB; steps
        // j > i carry P = 0
        if (nb / PB != wk || kk > nb) continue;
        const int r = (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDP
                      + kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bh4[4], bl4[4];
        ldsm_x4(bh4, ph + r);
        ldsm_x4(bl4, pl + r);
        mma_bf16(ya[2 * nb], av, bh4[0], bh4[1]);
        mma_bf16(ya[2 * nb], av, bl4[0], bl4[1]);
        mma_bf16(ya[2 * nb + 1], av, bh4[2], bh4[3]);
        mma_bf16(ya[2 * nb + 1], av, bl4[2], bl4[3]);
      }
    }

    // sum over the WK warps of a row slice, then store y
    float* rw = red + wk * T2 * LDR;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 8 * n + 2 * t, c = wm * 16 + g;
      rw[i * LDR + c] = ya[n][0];
      rw[(i + 1) * LDR + c] = ya[n][1];
      rw[i * LDR + c + 8] = ya[n][2];
      rw[(i + 1) * LDR + c + 8] = ya[n][3];
    }
    __syncthreads();
    for (int e = tid; e < T2 * VT / 2; e += STHREADS) {
      const int i = e / (VT / 2), c = 2 * (e % (VT / 2));
      if (i >= tn || c0 + c >= p.V) continue;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) {
        s0 += red[(w * T2 + i) * LDR + c];
        s1 += red[(w * T2 + i) * LDR + c + 1];
      }
      const int64_t yo = ((b * p.S + t0 + i) * p.H + h) * p.V + c0 + c;
      if (p.y32) {                 // the backward's dq and dk, unrounded
        float* yr = static_cast<float*>(y) + yo;
        yr[0] = s0;
        if (c0 + c + 1 < p.V) yr[1] = s1;
      } else if (p.V % 2 == 0) {
        bf16* yr = static_cast<bf16*>(y) + yo;
        *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(s0, s1);
      } else {
        bf16* yr = static_cast<bf16*>(y) + yo;
        yr[0] = __float2bfloat16(s0);
        if (c0 + c + 1 < p.V) yr[1] = __float2bfloat16(s1);
      }
    }
  }
}

template <int WM, int KW>
static int launch_state(const MmaParams& p, bool vec, const bf16* q,
                        const bf16* k, const bf16* v, const uint32_t* P,
                        const float* coef, void* y, cudaStream_t stream) {
  constexpr int smem = StateLayout<WM, KW>::BYTES;
  constexpr int VT = 16 * WM;
  auto kern = vec ? scan_state_kernel<WM, KW, true>
                  : scan_state_kernel<WM, KW, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.V + VT - 1) / VT), (unsigned)(p.B * p.H));
  kern<<<grid, STHREADS, smem, stream>>>(q, k, v, P, coef, y, p);
  return (int)cudaGetLastError();
}

// K columns a warp of scan_state_kernel takes at slab width vt for head
// dim K, or 0 where the route does not take (vt, K).
static int state_kw(int vt, int64_t K) {
  if (vt == 32) {
    for (int kw = 16; kw <= 256; kw *= 2)
      if (4 * (int64_t)kw >= K) return kw;
  } else if (vt == 128) {
    if (K <= 64) return 64;
  }
  return 0;
}
static int state_smem(int vt, int kw) {
  switch (vt * 1000 + kw) {
    case 32016: return StateLayout<2, 16>::BYTES;
    case 32032: return StateLayout<2, 32>::BYTES;
    case 32064: return StateLayout<2, 64>::BYTES;
    case 32128: return StateLayout<2, 128>::BYTES;
    case 32256: return StateLayout<2, 256>::BYTES;
    case 128064: return StateLayout<8, 64>::BYTES;
    default: return -1;
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

// fp32/fp16 route.  dtype of q, k, v and y: 0 float32, 2 float16 (bf16
// takes repro_ssm_scan_bf16); log_a is float32.  vt: 32 or 64.  dims
// (int64): B, S, H, K, V, then the (batch, seq, head) strides of q, k, v
// and log_a in elements (the last dimension of q, k and v is contiguous).
// y is contiguous (B, S, H, V).  Returns a cudaError_t.
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
    case 2: return launch_vt<__half>(vt, p, q, k, v, la, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 route.  vt: 32 or 128; vec: 16-byte copies of q, k and v (K, V
// and every stride a multiple of 8 elements, pointers 16-byte aligned);
// y32: y is float32 (the backward's dq and dk), else bf16.
// dims as repro_ssm_scan's.  P: (B * H * NC, T2 * T2) uint32 scratch (each
// P's bf16 hi and lo halves), coef: (B * H * NC, CREC) float scratch, NC =
// ceil(S / T2).  Launches scan_intra_kernel, then scan_state_kernel;
// returns a cudaError_t.
extern "C" int repro_ssm_scan_bf16(int vt, int vec, int y32, const void* q,
                                   const void* k, const void* v,
                                   const float* la, void* y, void* P,
                                   void* coef, const int64_t* dims,
                                   void* stream) {
  MmaParams p;
  p.B = dims[0]; p.S = dims[1]; p.H = dims[2]; p.K = dims[3]; p.V = dims[4];
  p.NC = (p.S + T2 - 1) / T2;
  p.y32 = y32;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = dims[5 + i];
    p.ks[i] = dims[8 + i];
    p.vs[i] = dims[11 + i];
    p.ls[i] = dims[14 + i];
  }
  const int kw = state_kw(vt, p.K);
  if (!kw || p.NC < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  uint32_t* pp = static_cast<uint32_t*>(P);
  float* cf = static_cast<float*>(coef);
  dim3 g1((unsigned)p.NC, (unsigned)(p.B * p.H));
  if (vec) scan_intra_kernel<true><<<g1, 128, 0, st>>>(qq, kk, la, pp, cf, p);
  else scan_intra_kernel<false><<<g1, 128, 0, st>>>(qq, kk, la, pp, cf, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (vt * 1000 + kw) {
    case 32016: return launch_state<2, 16>(p, vec, qq, kk, vv, pp, cf, y, st);
    case 32032: return launch_state<2, 32>(p, vec, qq, kk, vv, pp, cf, y, st);
    case 32064: return launch_state<2, 64>(p, vec, qq, kk, vv, pp, cf, y, st);
    case 32128: return launch_state<2, 128>(p, vec, qq, kk, vv, pp, cf, y, st);
    case 32256: return launch_state<2, 256>(p, vec, qq, kk, vv, pp, cf, y, st);
    case 128064: return launch_state<8, 64>(p, vec, qq, kk, vv, pp, cf, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory in bytes of scan_state_kernel at slab width vt for head
// dim K, or -1 where the bf16 route does not take (vt, K).
extern "C" int64_t repro_ssm_scan_bf16_smem(int vt, int64_t K) {
  const int kw = state_kw(vt, K);
  return kw ? state_smem(vt, kw) : -1;
}

// The scratch's geometry: steps per chunk and floats per coefficient record.
extern "C" int repro_ssm_scan_bf16_geometry(int what) {
  return what == 0 ? T2 : CREC;
}


extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
