// Causal GQA flash attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:73, body _kernel):
// softmax(Q K^T / sqrt(d)) V with an online max and sum, GQA (query head h
// reads kv head h / g), causal against absolute query positions
// (q_offset + i), and no work on kv tiles above the diagonal.  Two kernels
// compute it:
//
// * flash_mma_kernel (bf16 and fp16 at d = 64 and 128, the LM path) runs
//   both products on the tensor cores with mma.sync; see its note below.
// * flash_kernel (fp32, and d = 16 or 32) runs them on the CUDA cores in
//   fp32.
//
// Work split of both.  One block per (batch, kv head, tile of 64 query
// rows), where a query row is one (position, group head) pair: row r of kv
// head j is position r / g of query head j * g + r % g.  A tile therefore
// covers whole positions for any group size g (GQA 4:1, 3:1, MHA), and the
// block reads each K/V tile once for all g heads that share it.  Tiles with
// late (causal, heavy) rows are issued first so the last wave is short.
//
// Numerics follow the TPU kernel, not the unfused oracle: q is scaled in
// the input dtype (in bf16 q * scale rounds, and scale itself is the bf16
// value the wrapper passes), products accumulate and statistics are kept in
// fp32, scores masked by causality are -1e30 (not -inf), and the output
// divides by max(l, 1e-30) before the cast back to the input dtype.  Keys
// past Sk (the ragged last tile) are excluded outright (-inf, so exp gives
// 0), as are query rows past Sq * g (computed, never stored).  The tiles are
// the kernel's own; the TPU's blk_q/blk_k do not carry over.
//
// Bound on the H100.  At Granite-8B prefill (B=4, S=2048, 32 heads on 8 kv
// heads, d=128) one call needs 2*B*H*S^2*d = 1.37e11 FLOP with the causal
// half skipped: 0.139 ms at 989 TFLOP/s bf16, against 168 MB of q, k, v and
// o, 0.050 ms at 3.35 TB/s.  Operations bound it, so the bf16 path goes
// through the tensor cores; wgmma, TMA and a persistent schedule are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define BM 64          // query rows per block
#define BN 64          // keys per kv tile
#define THREADS 256
#define NEG_BIG -1e30f

struct FlashParams {
  int64_t B, Sq, Sk, H, KV, q_offset, causal;
  int64_t qs[3], ks[3], vs[3];   // (batch, seq, head) strides in elements
  float scale;                   // 1/sqrt(d) rounded to the input dtype
};

__device__ __forceinline__ void load4(const float* p, float* x) {
  float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(t.x << 16);
  x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16);
  x[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const __half* p, float* x) {
  const __half2* h = reinterpret_cast<const __half2*>(p);
  float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// x rounded to the input dtype and back: the TPU kernel's (q * scale) is a
// product in that dtype.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, const __half*) {
  return __half2float(__float2half(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

template <int CW>
__device__ __forceinline__ void lds(const float* p, float* x) {
  if constexpr (CW == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (CW == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// flash_kernel: CUDA cores, fp32.  The block stages its scaled Q tile in
// shared memory as fp32 (transposed, d-major), then walks 64-key tiles: K
// (transposed) and V are staged as fp32, the 64x64 score tile is computed in
// registers, P goes through shared memory to the P.V product.  256 threads:
// thread (ty, tx) owns score rows 4ty..4ty+3 and columns 4tx..4tx+3, and the
// same rows of the output accumulator, so the fp32 m, l and accumulator of a
// row stay in the registers of the 16 threads of one half-warp; row max and
// row sum are reduced across them with xor shuffles, which leave every lane
// with the same bits.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const FlashParams p) {
  // accumulator columns: NCH chunks of CW adjacent columns per thread
  constexpr int CW = D >= 64 ? 4 : D / 16;
  constexpr int NCH = D / (16 * CW);
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [D][BM]
  float* kT = qT + D * BM;                        // [D][BN]
  float* vS = kT + D * BN;                        // [BN][D]
  float* pT = vS + BN * D;                        // [BN][BM]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t g = p.H / p.KV;
  const int64_t rows = p.Sq * g;
  const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * BM;
  const int64_t b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const T* kb = k + b * p.ks[0] + kvh * p.ks[2];
  const T* vb = v + b * p.vs[0] + kvh * p.vs[2];

  // Q tile: row r -> (position r / g, head kvh * g + r % g), scaled in T
  for (int i = tid; i < BM * D / 4; i += THREADS) {
    const int r = i % BM, dq = i / BM;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    const int64_t rr = r0 + r;
    if (rr < rows) {
      load4(q + b * p.qs[0] + (rr / g) * p.qs[1] + (kvh * g + rr % g) * p.qs[2]
            + 4 * dq, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = round_to(x[e] * p.scale, q);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) qT[(4 * dq + e) * BM + r] = x[e];
  }

  int64_t qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + 4 * ty + i) / g + p.q_offset;
  const int64_t n_kt = (p.Sk + BN - 1) / BN;
  int64_t last = n_kt;
  if (p.causal) {
    // the tile's largest position; keys above it contribute nothing
    const int64_t qmax = (min(r0 + BM, rows) - 1) / g + p.q_offset;
    last = min(n_kt, qmax / BN + 1);
  }

  float m[4], l[4], acc[4][NCH * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH * CW; ++c) acc[i][c] = 0.f;
  }

  for (int64_t kt = 0; kt < last; ++kt) {
    const int64_t c0 = kt * BN;
    for (int i = tid; i < BN * D / 4; i += THREADS) {   // K -> kT[d][c]
      const int c = i % BN, dq = i / BN;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + c < p.Sk) load4(kb + (c0 + c) * p.ks[1] + 4 * dq, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) kT[(4 * dq + e) * BN + c] = x[e];
    }
    for (int i = tid; i < BN * D / 4; i += THREADS) {   // V -> vS[c][d]
      const int dq = i % (D / 4), c = i / (D / 4);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + c < p.Sk) load4(vb + (c0 + c) * p.vs[1] + 4 * dq, x);
      *reinterpret_cast<float4*>(&vS[c * D + 4 * dq]) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * BM + 4 * ty]);
      const float4 bb = *reinterpret_cast<const float4*>(&kT[d * BN + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = c0 + 4 * tx + j;
        if (kpos >= p.Sk) s[i][j] = -INFINITY;
        else if (p.causal && kpos > qpos[i]) s[i][j] = NEG_BIG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH * CW; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pT[(4 * tx + j) * BM + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(&pT[c * BM + 4 * ty]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float vv[CW];
        lds<CW>(&vS[c * D + ch * 16 * CW + tx * CW], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < CW; ++e)
            acc[i][ch * CW + e] = fmaf(pv[i], vv[e], acc[i][ch * CW + e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t rr = r0 + 4 * ty + i;
    if (rr >= rows) continue;
    T* orow = o + ((b * p.Sq + rr / g) * p.H + kvh * g + rr % g) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        store(orow + ch * 16 * CW + tx * CW + e, acc[i][ch * CW + e] / den);
  }
}

template <typename T, int D>
static int launch(const FlashParams& p, const void* q, const void* k,
                  const void* v, void* o, cudaStream_t stream) {
  const int smem = (D * BM + D * BN + BN * D + BN * BM) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = p.Sq * (p.H / p.KV);
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)(p.B * p.KV));
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ tensor cores
// flash_mma_kernel: the same function for bf16 and fp16 at d = 64 and 128
// (Granite-8B, SmolLM-360M), on the tensor cores with mma.sync m16n8k16.
// One block of 4 warps per (batch, kv head, tile of 64 query rows); each
// warp owns 16 rows (rows map to (position, group head) as above) and keeps
// its scaled Q fragments in registers.  K and V tiles of 64 keys are staged
// in shared memory by cp.async, two stages deep, in rows of 16-byte chunks
// swizzled by (chunk ^ row % 8) so that ldmatrix reads no bank twice.  S =
// Q K^T accumulates in fp32 (bf16 products are exact in fp32, as the TPU
// kernel's fp32 matmul of bf16-valued operands); m, l and the output
// accumulator are fp32.  The TPU kernel multiplies fp32 P by V: here P is
// split into a high and a low half in the input dtype (P = hi + lo to about
// 16 significant bits) and both go through the tensor cores, so P V keeps
// nearly fp32 weights for 1.5x the products of a single rounded P.
#define MBM 64          // query rows per block, 16 per warp
#define MBN 64          // keys per kv tile
#define MTHREADS 128

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros (keys past Sk)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1, const __nv_bfloat16*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1, const __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a packed pair of T (x in the low half), and the pair of
// what rounding left over
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo, const __nv_bfloat16*) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                           y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo, const __half*) {
  __half2 h = __floats2half2_rn(x, y);
  __half2 r = __floats2half2_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack2(float x, float y,
                                          const __nv_bfloat16*) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float x, float y, const __half*) {
  __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// element offset of 16-byte chunk c of row r in a swizzled [rows][D] tile
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

template <typename T, int D>
__global__ void __launch_bounds__(MTHREADS)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const FlashParams p) {
  constexpr int CH = D / 8;              // 16-byte chunks per row
  constexpr int NB = MBN / 8;            // 8-key column blocks of S
  constexpr int ND = D / 8;              // 8-wide column blocks of O
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);   // [MBM][D]
  T* sK = sQ + MBM * D;                  // [2][MBN][D]
  T* sV = sK + 2 * MBN * D;              // [2][MBN][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma row group, pair index
  const int64_t g = p.H / p.KV;
  const int64_t rows = p.Sq * g;
  const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * MBM;
  const int64_t b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const T* kb = k + b * p.ks[0] + kvh * p.ks[2];
  const T* vb = v + b * p.vs[0] + kvh * p.vs[2];

  const int64_t n_kt = (p.Sk + MBN - 1) / MBN;
  int64_t last = n_kt;
  if (p.causal) {
    const int64_t qmax = (min(r0 + MBM, rows) - 1) / g + p.q_offset;
    last = min(n_kt, qmax / MBN + 1);
  }

  auto load_kv = [&](int64_t kt, int stage) {
    const int64_t c0 = kt * MBN;
    T* dk = sK + stage * MBN * D;
    T* dv = sV + stage * MBN * D;
    for (int i = tid; i < MBN * CH; i += MTHREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = c0 + r < p.Sk;
      const int64_t key = ok ? c0 + r : 0;
      cp_async16(smem_addr(dk + swz<D>(r, c)), kb + key * p.ks[1] + 8 * c, ok);
      cp_async16(smem_addr(dv + swz<D>(r, c)), vb + key * p.vs[1] + 8 * c, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // Q tile: row r -> (position r / g, head kvh * g + r % g), scaled in T
  for (int i = tid; i < MBM * CH; i += MTHREADS) {
    const int r = i / CH, c = i % CH;
    const int64_t rr = r0 + r;
    uint4 pk = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows) {
      pk = *reinterpret_cast<const uint4*>(
          q + b * p.qs[0] + (rr / g) * p.qs[1] + (kvh * g + rr % g) * p.qs[2]
          + 8 * c);
      T* e = reinterpret_cast<T*>(&pk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store(e + j, to_float(e[j]) * p.scale);   // rounds to T
      }
    }
    *reinterpret_cast<uint4*>(sQ + swz<D>(r, c)) = pk;
  }
  __syncthreads();

  uint32_t qf[D / 16][4];              // A fragments of this warp's 16 rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = warp * 16 + (lane & 15);
    ldsm_x4(qf[kk], smem_addr(sQ + swz<D>(r, 2 * kk + (lane >> 4))));
  }

  // this thread's two rows: gq and gq + 8 of the warp's 16
  const int64_t row0 = r0 + warp * 16 + gq;
  const int64_t qpos[2] = {row0 / g + p.q_offset, (row0 + 8) / g + p.q_offset};
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int64_t kt = 0; kt < last; ++kt) {
    if (kt + 1 < last) {
      load_kv(kt + 1, (int)((kt + 1) & 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tk = sK + (kt & 1) * MBN * D;
    const T* tv = sV + (kt & 1) * MBN * D;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bf[4];
        const int r = nb * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bf, smem_addr(tk + swz<D>(r, 2 * kk + ((lane >> 3) & 1))));
        mma(s[nb], qf[kk], bf[0], bf[1], q);
        mma(s[nb + 1], qf[kk], bf[2], bf[3], q);
      }
    }

    // masks, then the online softmax of rows gq (e = 0, 1) and gq + 8
    const int64_t c0 = kt * MBN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = c0 + nb * 8 + 2 * tq + (e & 1);
        if (key >= p.Sk) s[nb][e] = -INFINITY;
        else if (p.causal && key > qpos[e >> 1]) s[nb][e] = NEG_BIG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        rs[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = alpha[i] * l[i] + rs[i];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0]; acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1]; acc[nd][3] *= alpha[1];
    }

    // O += P V, 16 keys per step; P's S fragments are the A fragments
#pragma unroll
    for (int kk = 0; kk < MBN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0], q);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1], q);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2], q);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3], q);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(bf, smem_addr(tv + swz<D>(r, nd + (lane >> 4))));
        mma(acc[nd], ph, bf[0], bf[1], q);
        mma(acc[nd], pl, bf[0], bf[1], q);
        mma(acc[nd + 1], ph, bf[2], bf[3], q);
        mma(acc[nd + 1], pl, bf[2], bf[3], q);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t rr = row0 + 8 * i;
    if (rr >= rows) continue;
    T* orow = o + ((b * p.Sq + rr / g) * p.H + kvh * g + rr % g) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * tq) =
          pack2(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv, q);
  }
}

template <typename T, int D>
static int launch_mma(const FlashParams& p, const void* q, const void* k,
                      const void* v, void* o, cudaStream_t stream) {
  const int smem = (MBM * D + 4 * MBN * D) * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = p.Sq * (p.H / p.KV);
  dim3 grid((unsigned)((rows + MBM - 1) / MBM), (unsigned)(p.B * p.KV));
  flash_mma_kernel<T, D><<<grid, MTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

// fp32, and d = 16 or 32, on the CUDA cores; bf16 and fp16 at d = 64 and
// 128 on the tensor cores
template <typename T>
static int launch_d(int d, const FlashParams& p, const void* q,
                    const void* k, const void* v, void* o,
                    cudaStream_t stream) {
  constexpr bool tc = !std::is_same<T, float>::value;
  switch (d) {
    case 16: return launch<T, 16>(p, q, k, v, o, stream);
    case 32: return launch<T, 32>(p, q, k, v, o, stream);
    case 64:
      if constexpr (tc) return launch_mma<T, 64>(p, q, k, v, o, stream);
      else return launch<T, 64>(p, q, k, v, o, stream);
    case 128:
      if constexpr (tc) return launch_mma<T, 128>(p, q, k, v, o, stream);
      else return launch<T, 128>(p, q, k, v, o, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  dims (int64): B, Sq, Sk, H, KV,
// q_offset, causal, then the (batch, seq, head) strides of q, k and v.
// The output o is contiguous (B, Sq, H, d).  Returns a cudaError_t.
extern "C" int repro_flash_attention(int dtype, int d, const void* q,
                                     const void* k, const void* v, void* o,
                                     const int64_t* dims, float scale,
                                     void* stream) {
  FlashParams p;
  p.B = dims[0]; p.Sq = dims[1]; p.Sk = dims[2]; p.H = dims[3];
  p.KV = dims[4]; p.q_offset = dims[5]; p.causal = dims[6];
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = dims[7 + i];
    p.ks[i] = dims[10 + i];
    p.vs[i] = dims[13 + i];
  }
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(d, p, q, k, v, o, st);
    case 1: return launch_d<__nv_bfloat16>(d, p, q, k, v, o, st);
    case 2: return launch_d<__half>(d, p, q, k, v, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
