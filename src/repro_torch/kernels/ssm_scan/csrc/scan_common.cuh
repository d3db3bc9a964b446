// Device code shared by the scan's forward (ssm_scan.cu) and backward
// (ssm_scan_bw.cu) libraries; the design notes are at the top of each.
//
// Every kernel here evaluates one chunked "scan pass" with operands X, Z
// (T x Kc, the contraction dim) and W (T x Vo, the output dim):
//
//   forward in time (REV false):  out_t = sum_{s<=t} e^{b_t-b_s} (X_t.Z_s) W_s
//   reverse in time (REV true):   out_s = sum_{t>=s} e^{b_t-b_s} (X_s.Z_t) W_t
//
// with b = cumsum(log_a).  The forward scan is (X, Z, W) = (q, k, v) forward
// in time; the backward runs dq = (dy, v, k) forward, dv = (k, q, dy) and
// dk = (v, dy, q) in reverse.  Per chunk with cum the in-chunk cumsum and
// cum_T its last value, the forward pass scales the state's term of row t
// by e^{cum_t} and updates the state with e^{cum_T - cum_s} Z_s W_s^T; the
// reverse pass scales row s by e^{cum_T - cum_s} and updates with
// e^{cum_t} Z_t W_t^T, walking the chunks from the last: the two
// coefficient vectors swap roles, and the intra-chunk matrix is used
// transposed.  A pass may also write, per row and per column slab of the
// output, the dot of its fp32 output row with a row R (the backward's
// u_t = q_t . dq_t and w_t = k_t . dk_t), before any rounding.

#pragma once

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
  int64_t B, S, H, K, V, Kpad;          // K contraction, V output dim
  int64_t qs[3], ks[3], vs[3], ls[3];   // (batch, seq, head) strides
  const void* rd;                       // R rows (or null: no row dots)
  int64_t rs[3];                        // R's strides
  float* part;                          // row dots, (slab, B, H, S)
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

// One scan pass on the CUDA cores (fp32 arithmetic): X = q, Z = k, W = v
// in the names below; y (B, S, H, Vo) contiguous.  REV: reverse in time.
template <typename T, int VT, bool REV>
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

  const int64_t nsub = (p.S + SUB - 1) / SUB;
  for (int64_t it = 0; it < nsub; ++it) {
    const int64_t t0 = (REV ? nsub - 1 - it : it) * SUB;
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
      ein[tid] = tid < tn ? expf(cum[tid]) : 0.f;
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

    // the output rows' and the state update's coefficients
    const float* cout = REV ? wj : ein;
    const float* cupd = REV ? ein : wj;

    // B. P = (q k^T) * decay below the diagonal (above it in reverse),
    //    stored as Pt[j][i]; then y = cout_i q S + P v
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * tx + c;
      float pc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        const bool live = REV ? (i <= j && j < tn) : (j <= i && i < tn);
        pc[r] = live ? s[r][c] * expf(REV ? cum[j] - cum[i] : cum[i] - cum[j])
                     : 0.f;
      }
      sts<4>(Pt + j * LDT + 4 * ty, pc);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = cout[4 * ty + r];
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
    if (p.part) {      // row dots with R over this slab, from fp32 o
      const T* rb = static_cast<const T*>(p.rd) + b * p.rs[0] + h * p.rs[2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        float d = 0.f;
        if (i < tn) {
#pragma unroll
          for (int c = 0; c < CV; ++c) {
            const int64_t col = c0 + CV * tx + c;
            if (col < p.V) d = fmaf(o[r][c], ld(rb + (t0 + i) * p.rs[1] + col),
                                    d);
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)      // the 16 lanes of a row
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (tx == 0 && i < tn)
          p.part[((int64_t)blockIdx.x * p.B * p.H + blockIdx.y) * p.S + t0 + i]
              = d;
      }
    }

    // C. S = exp(cum_T) S + sum_j (cupd_j k_j) v_j^T
    const float et = *etot;
    for (int64_t k0 = 0; k0 < p.Kpad; k0 += KC) {
      __syncthreads();
      for (int e = tid; e < SUB * KC; e += THREADS) {
        const int j = e / KC, kk = e % KC;
        kc[j * LDC + kk] = (j < tn && k0 + kk < p.K)
            ? ld(kb + (t0 + j) * p.ks[1] + k0 + kk) * cupd[j] : 0.f;
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
  int64_t B, S, H, K, V, NC;              // NC chunks of T2 steps; K the
                                          // contraction, V the output dim
  int64_t qs[3], ks[3], vs[3], ls[3];     // (batch, seq, head) strides
  const bf16* rd;                         // R rows (or null: no row dots)
  int64_t rs[3];                          // R's strides
  float* part;                            // row dots, (slab, B, H, S)
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
// w_j = exp(cum_T - cum_j), exp(cum_T) into coef (unless coef is null).
// 4 warps, each 16 rows of P; the K dimension in tiles of KT1,
// double-buffered.
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
  if (coef && tid < T2) {
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
  static constexpr int NG = VT / 32;        // 16-lane groups of a y row
  static constexpr int RD = RED + WK * T2 * LDR * 4;         // [T2][NG]
  static constexpr int RS = RD + T2 * NG * 4;                // [2][T2][LDV]
  static constexpr int BYTES = RS + 2 * T2 * LDV * 2;
};

// The state pass of one (column slab of VT columns of V, batch * head):
// S^T (VT x K) in accumulator registers across the chunks, y from S^T, q,
// v and the scratch's P (see the note at the top of ssm_scan.cu).  REV:
// reverse in time (the chunks from the last, P used transposed, the
// coefficient vectors swapped; see the note at the top of this file).
// DOTS: also the dot of each fp32 y row with R over the slab, into p.part.
template <int WM, int KW, bool VEC, bool REV, bool DOTS>
__global__ void __launch_bounds__(STHREADS, 1)
scan_state_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const uint32_t* __restrict__ P,
                  const float* __restrict__ coef, bf16* __restrict__ y,
                  const MmaParams p) {
  using L = StateLayout<WM, KW>;
  constexpr int WK = L::WK, VT = L::VT, KS = L::KS, NS = L::NS;
  constexpr int LDQ = L::LDQ, LDV = L::LDV, LDR = L::LDR, NG = L::NG;
  constexpr int NT = KW / 8, NTS = KS / 8;   // n8 tiles of S^T a warp / step
  constexpr int PB = T2 / 16 / WK;           // 16-column blocks of P v a warp
  // offsets in a coefficient record of the output rows' scale and of the
  // state update's weight
  constexpr int OUT = REV ? T2 : 0, UPD = REV ? 0 : T2;
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* qk = reinterpret_cast<bf16*>(smem + L::QK);
  bf16* vsm = reinterpret_cast<bf16*>(smem + L::VS);
  bf16* psm = reinterpret_cast<bf16*>(smem + L::PS);
  float* csm = reinterpret_cast<float*>(smem + L::CS);
  float* red = reinterpret_cast<float*>(smem + L::RED);
  float* rdp = reinterpret_cast<float*>(smem + L::RD);
  bf16* rsm = reinterpret_cast<bf16*>(smem + L::RS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wk = warp / WM;
  const int64_t bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int64_t c0 = (int64_t)blockIdx.x * VT;
  const bf16* qb = q + b * p.qs[0] + h * p.qs[2];
  const bf16* kb = k + b * p.ks[0] + h * p.ks[2];
  const bf16* vb = v + b * p.vs[0] + h * p.vs[2];
  const bf16* rb = DOTS ? p.rd + b * p.rs[0] + h * p.rs[2] : nullptr;

  // tiles of stage (chunk ch, sub-step s) into q/k buffer buf; at s == 0
  // also the chunk's v slab, P halves, coefficients and R slab (buffer cb)
  auto issue = [&](int64_t ch, int s, int buf, int cb) {
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
      load_tile<VEC>(vsm + cb * T2 * LDV, LDV, vb + t0 * p.vs[1], p.vs[1],
                     tn, VT, c0, p.V);
      if constexpr (DOTS)
        load_tile<VEC>(rsm + cb * T2 * LDV, LDV, rb + t0 * p.rs[1], p.rs[1],
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

  issue(REV ? p.NC - 1 : 0, 0, 0, 0);
  cp_commit();
  for (int64_t it = 0; it < p.NC; ++it) {
    const int64_t ch = REV ? p.NC - 1 - it : it;
    const int cb = (int)(it & 1);
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
      const int buf = (int)((it * NS + s) & 1);
      cp_wait_all();
      __syncthreads();    // this stage landed; the last one is done with
                          // the other buffers
      if (s + 1 < NS) issue(ch, s + 1, buf ^ 1, cb);
      else if (it + 1 < p.NC) issue(REV ? ch - 1 : ch + 1, 0, buf ^ 1, cb ^ 1);
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

      // S^T = exp(cum_T) S^T + (v^T . w) k over the same columns, w the
      // update's weights
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
        const float* wv = cc + UPD + kk * 16 + 2 * t;
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

    // y^T = c_i y^T + v^T P^T (forward) or v^T P (reverse), this warp's
    // columns, c the output rows' scale
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float e0 = cc[OUT + 8 * n + 2 * t];
      const float e1 = cc[OUT + 8 * n + 2 * t + 1];
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
        // 16-column block nb of the product belongs to warp slice nb / PB;
        // P is 0 above the diagonal: step blocks kk > nb forward, kk < nb
        // in reverse (P^T's k index is P's row)
        if (nb / PB != wk || (REV ? kk < nb : kk > nb)) continue;
        uint32_t bh4[4], bl4[4];
        if constexpr (REV) {
          const int r = (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3))
                        * LDP + nb * 16 + ((lane >> 4) << 3);
          ldsm_x4_t(bh4, ph + r);
          ldsm_x4_t(bl4, pl + r);
        } else {
          const int r = (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDP
                        + kk * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(bh4, ph + r);
          ldsm_x4(bl4, pl + r);
        }
        mma_bf16(ya[2 * nb], av, bh4[0], bh4[1]);
        mma_bf16(ya[2 * nb], av, bl4[0], bl4[1]);
        mma_bf16(ya[2 * nb + 1], av, bh4[2], bh4[3]);
        mma_bf16(ya[2 * nb + 1], av, bl4[2], bl4[3]);
      }
    }

    // sum over the WK warps of a row slice, then store y (and the row
    // dots: each 16-lane group of a warp covers 32 columns of one row)
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
    const bf16* rc = rsm + cb * T2 * LDV;
    for (int e = tid; e < T2 * VT / 2; e += STHREADS) {
      const int i = e / (VT / 2), c = 2 * (e % (VT / 2));
      const bool live = i < tn && c0 + c < p.V;
      const bool two = c0 + c + 1 < p.V;
      float s0 = 0.f, s1 = 0.f;
      if (live) {
#pragma unroll
        for (int w = 0; w < WK; ++w) {
          s0 += red[(w * T2 + i) * LDR + c];
          s1 += red[(w * T2 + i) * LDR + c + 1];
        }
        bf16* yr = y + ((b * p.S + t0 + i) * p.H + h) * p.V + c0 + c;
        if (p.V % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(s0,
                                                                        s1);
        } else {
          yr[0] = __float2bfloat16(s0);
          if (two) yr[1] = __float2bfloat16(s1);
        }
      }
      if constexpr (DOTS) {   // every lane of the group takes part
        const bf16* rr = rc + i * LDV + c;    // 0 past V and tn
        float d = live ? s0 * __bfloat162float(rr[0]) : 0.f;
        if (live && two) d = fmaf(s1, __bfloat162float(rr[1]), d);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if ((lane & 15) == 0) rdp[i * NG + c / 32] = d;
      }
    }
    if constexpr (DOTS) {
      __syncthreads();
      if (tid < tn) {
        float d = 0.f;
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) d += rdp[tid * NG + gi];
        p.part[((int64_t)blockIdx.x * p.B * p.H + bh) * p.S + t0 + tid] = d;
      }
    }
  }
}

template <int WM, int KW, bool REV, bool DOTS>
static int launch_state(const MmaParams& p, bool vec, const bf16* q,
                        const bf16* k, const bf16* v, const uint32_t* P,
                        const float* coef, bf16* y, cudaStream_t stream) {
  constexpr int smem = StateLayout<WM, KW>::BYTES;
  constexpr int VT = 16 * WM;
  auto kern = vec ? scan_state_kernel<WM, KW, true, REV, DOTS>
                  : scan_state_kernel<WM, KW, false, REV, DOTS>;
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

// One state pass at slab width vt (32 or 128) over contraction dim p.K;
// DOTS: with row dots (p.rd, p.rs and p.part set).
template <bool REV, bool DOTS>
static int state_pass(int vt, const MmaParams& p, bool vec, const bf16* q,
                      const bf16* k, const bf16* v, const uint32_t* P,
                      const float* coef, bf16* y, cudaStream_t st) {
  switch (vt * 1000 + state_kw(vt, p.K)) {
    case 32016:
      return launch_state<2, 16, REV, DOTS>(p, vec, q, k, v, P, coef, y, st);
    case 32032:
      return launch_state<2, 32, REV, DOTS>(p, vec, q, k, v, P, coef, y, st);
    case 32064:
      return launch_state<2, 64, REV, DOTS>(p, vec, q, k, v, P, coef, y, st);
    case 32128:
      return launch_state<2, 128, REV, DOTS>(p, vec, q, k, v, P, coef, y, st);
    case 32256:
      return launch_state<2, 256, REV, DOTS>(p, vec, q, k, v, P, coef, y, st);
    case 128064:
      return launch_state<8, 64, REV, DOTS>(p, vec, q, k, v, P, coef, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The intra-chunk kernel over every (chunk, batch * head) of p.
static int intra_pass(const MmaParams& p, bool vec, const bf16* q,
                      const bf16* k, const float* la, uint32_t* P,
                      float* coef, cudaStream_t st) {
  dim3 grid((unsigned)p.NC, (unsigned)(p.B * p.H));
  if (vec) scan_intra_kernel<true><<<grid, 128, 0, st>>>(q, k, la, P, coef, p);
  else scan_intra_kernel<false><<<grid, 128, 0, st>>>(q, k, la, P, coef, p);
  return (int)cudaGetLastError();
}

static const int kMaxSmem = 232448;   // opt-in shared memory per block

template <typename T, int VT, bool REV>
static int launch_core(const ScanParams& p, const void* q, const void* k,
                       const void* v, const float* la, void* y,
                       cudaStream_t stream) {
  const int64_t smem = smem_floats(p.Kpad, VT) * (int64_t)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<T, VT, REV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.V + VT - 1) / VT), (unsigned)(p.B * p.H));
  ssm_scan_kernel<T, VT, REV><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), la, static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

// One pass of the fp32/fp16 route at slab width vt (32 or 64); dtype 0
// float32, 2 float16.
template <bool REV>
static int core_pass(int dtype, int vt, const ScanParams& p, const void* q,
                     const void* k, const void* v, const float* la, void* y,
                     cudaStream_t st) {
  switch (dtype * 1000 + vt) {
    case 32: return launch_core<float, 32, REV>(p, q, k, v, la, y, st);
    case 64: return launch_core<float, 64, REV>(p, q, k, v, la, y, st);
    case 2032: return launch_core<__half, 32, REV>(p, q, k, v, la, y, st);
    case 2064: return launch_core<__half, 64, REV>(p, q, k, v, la, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The (batch, seq, head) strides at dims[at..at+3) into s.
static inline void strides(int64_t* s, const int64_t* dims, int at) {
  for (int i = 0; i < 3; ++i) s[i] = dims[at + i];
}
