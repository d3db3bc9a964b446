// Causal GQA flash attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:73, body _kernel):
// softmax(Q K^T / sqrt(d)) V with an online max and sum, GQA (query head h
// reads kv head h / g), causal against absolute query positions
// (q_offset + i), and no work on kv tiles above the diagonal.  Two kernels
// compute it:
//
// * flash_wgmma_kernel (bf16 and fp16 at d = 64 and 128, the LM path) runs
//   both products on the tensor cores with wgmma, its K/V tiles fed by TMA;
//   see its note below.
// * flash_kernel (fp32, and d = 16 or 32) runs them on the CUDA cores in
//   fp32.
//
// Work split of both.  A work item is (batch, kv head, tile of query
// rows), where a query row is one (position, group head) pair: row r of kv
// head j is position r / g of query head j * g + r % g.  A tile therefore
// covers whole positions for any group size g (GQA 4:1, 3:1, MHA), and
// each K/V tile is read once for all g heads that share it.  Items with
// late (causal, heavy) rows go first so the last wave is short:
// flash_kernel runs one block per item, flash_wgmma_kernel's persistent
// blocks walk them in that order.
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
// o, 0.050 ms at 3.35 TB/s.  Operations bound it.  The bf16 kernel's own
// tensor work is 1.5x that (P V runs twice, on the two halves of P: 6 d
// FLOP per kept (query, key) pair), 0.208 ms at peak, so its design is the
// one that reaches the tensor cores' full rate: wgmma from shared memory,
// TMA copies the threads spend no instructions on, and warpgroups that
// specialise (one loads, two compute and overlap each other's softmax and
// products).

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
// flash_wgmma_kernel: the same function for bf16 and fp16 at d = 64 and 128
// (Granite-8B, SmolLM-360M) on the tensor cores, with Hopper's wgmma.
//
// Work items are (tile of 128 query rows, batch x kv head), heaviest row
// tiles first; the grid is persistent, one block per SM taking every
// gridDim.x-th item.  A block has three warpgroups:
//
// * the producer (warpgroup 0, setmaxnreg down to 24 registers): one
//   thread keeps a ring of two stages of 128-key K and V tiles in flight
//   with TMA (cp.async.bulk.tensor, 4-D tensor maps over (d, kv head, key,
//   batch), 128-byte swizzle; keys past Sk arrive as zeros), each tile
//   signalled by an mbarrier and freed by both consumers, K as soon as S
//   has read it; its warps 1-3 load the next item's Q rows (rows map to
//   (position, group head) as above, any g), scale them in the input
//   dtype and store them 128-byte swizzled, two Q buffers deep, so an
//   item's set-up overlaps the last one's products.
// * two consumers (setmaxnreg up to 240), 64 query rows each.  Per kv tile:
//   S = Q K^T as m64n128k16 wgmmas with both operands in shared memory
//   (fp32 S: bf16 products are exact in fp32, as in the TPU kernel's fp32
//   matmul of bf16-valued operands); masks (in a copy of the loop that
//   only edge tiles run: predicated-off masking costs issue slots on every
//   tile) and the online softmax in registers, in the base-2 domain (one
//   ex2 per score); O += P V as
//   m64n{d}k16 wgmmas with P from registers and V read transposed from
//   shared memory by the descriptor.  The TPU kernel multiplies fp32 P by
//   V: P is split into a high and a low half in the input dtype (P = hi +
//   lo to about 16 significant bits) and both halves go through the
//   tensor cores, so P V keeps nearly fp32 weights.
//
// Overlap: the consumers take turns to issue their products (named
// barriers), so one's softmax runs while the other's products do; within a
// consumer, S of tile j + 1 is issued with P V of tile j and its softmax
// runs while that P V does.  Shared memory at d = 128: two Q buffers of 32
// KB and two stages of 32 KB K and 32 KB V tiles, 192 KB.
#define WBM 128          // query rows per item: 64 per consumer warpgroup
#define WBN 128          // keys per kv tile
#define WSTAGES 2        // K/V ring depth
#define QLOADERS 96      // producer threads that load Q (warps 1-3)
#define QUNROLL 2        // Q loads a loader keeps in flight
#define WTHREADS 384     // producer warpgroup + two consumer warpgroups
#define PANEL_ROW 128    // bytes of a swizzled row: 64 bf16/fp16 values
#define LOG2E 1.4426950408889634f
#define BAD_TENSOR_MAP (-2)

#include <cuda.h>        // CUtensorMap and its enums; the driver function is
                         // reached through the runtime's entry-point query

struct WgBarriers {
  uint64_t full_k[WSTAGES], full_v[WSTAGES], empty_k[WSTAGES],
      empty_v[WSTAGES], q_full[2], q_empty[2];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3fff) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {   // 2^x, 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// pins a register between the asynchronous wgmma and its wait: reads of an
// accumulator, and reuse of an A operand register, stay after the wait
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// wgmma.mma_async m64nNk16, fp32 accumulators d (N / 2 per thread; the
// value of row 16 w + lane / 4 + 8 i and column 8 j + 2 (lane % 4) + c is
// d[4 j + 2 i + c] in warp w of the warpgroup).  wgmma_ss: A and B from
// K-major shared memory; acc = 0 overwrites d.  wgmma_rs: A from registers
// (the mma.sync m16n8k16 A fragment of the warp's 16 rows), B transposed
// (N-major, the V tile's rows are keys), always accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc,
                                         const __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, const __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc,
                                         const __half*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, const __half*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc,
                                         const __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, const __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc,
                                         const __half*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, const __half*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

template <typename T, int D>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                   const __grid_constant__ CUtensorMap tmap_v,
                   const T* __restrict__ q, T* __restrict__ o,
                   const FlashParams p) {
  constexpr int CH = D / 8;                       // 16-byte chunks per row
  constexpr uint32_t Q_PANEL = WBM * PANEL_ROW;   // 64 columns of the Q tile
  constexpr uint32_t Q_BYTES = Q_PANEL * (D / 64);
  constexpr uint32_t KV_PANEL = WBN * PANEL_ROW;  // 64 columns of a K/V tile
  constexpr uint32_t KV_BYTES = KV_PANEL * (D / 64);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the swizzle's period)
  uint8_t* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + 2 * Q_BYTES;                 // [stage][panel][key][128B]
  uint8_t* sV = sK + WSTAGES * KV_BYTES;
  WgBarriers* bars = reinterpret_cast<WgBarriers*>(sV + WSTAGES * KV_BYTES);

  // rows, positions and keys fit in 32 bits (Sq * g, Sk + q_offset < 2^31)
  const int g = (int)(p.H / p.KV);
  const int rows = (int)(p.Sq * g);
  const int n_rt = (rows + WBM - 1) / WBM;
  const int n_bh = (int)(p.B * p.KV);
  const int n_items = n_rt * n_bh;
  const int sk = (int)p.Sk, q_offset = (int)p.q_offset;
  const int n_kt = (sk + WBN - 1) / WBN;
  // work item i: row tile n_rt - 1 - i / n_bh (heaviest first) of batch x
  // kv head i % n_bh; the block takes items blockIdx.x, + gridDim.x, ...
  struct Item {
    int r0;
    int b, kvh, last;
  };
  auto item = [&](int i) {
    Item it;
    it.r0 = (n_rt - 1 - i / n_bh) * WBM;
    it.b = (i % n_bh) / (int)p.KV;
    it.kvh = (i % n_bh) % (int)p.KV;
    it.last = n_kt;
    if (p.causal) {
      // the tile's largest position; keys above it contribute nothing
      const int qmax = (min(it.r0 + WBM, rows) - 1) / g + q_offset;
      it.last = min(n_kt, qmax / WBN + 1);
    }
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(smem_addr(&bars->full_k[s]), 1);
      mbar_init(smem_addr(&bars->full_v[s]), 1);
      mbar_init(smem_addr(&bars->empty_k[s]), 2);   // one per consumer
      mbar_init(smem_addr(&bars->empty_v[s]), 2);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_addr(&bars->q_full[s]), QLOADERS);
      mbar_init(smem_addr(&bars->q_empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // K and V tiles of every item, through the ring
      int n = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item it = item(i);
        for (int kt = 0; kt < it.last; ++kt, ++n) {
          const int st = (int)(n % WSTAGES);
          const uint32_t reuse = (uint32_t)((n / WSTAGES - 1) & 1);
          const uint32_t fk = smem_addr(&bars->full_k[st]);
          const uint32_t fv = smem_addr(&bars->full_v[st]);
          if (n >= WSTAGES) mbar_wait(smem_addr(&bars->empty_k[st]), reuse);
          mbar_expect_tx(fk, KV_BYTES);
#pragma unroll
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(smem_addr(sK + st * KV_BYTES + pn * KV_PANEL),
                        &tmap_k, fk, 64 * pn, it.kvh, kt * WBN, it.b);
          if (n >= WSTAGES) mbar_wait(smem_addr(&bars->empty_v[st]), reuse);
          mbar_expect_tx(fv, KV_BYTES);
#pragma unroll
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(smem_addr(sV + st * KV_BYTES + pn * KV_PANEL),
                        &tmap_v, fv, 64 * pn, it.kvh, kt * WBN, it.b);
        }
      }
    } else if (threadIdx.x >= 32) {
      // Q tiles of every item, two buffers deep: row r -> (position r / g,
      // head kvh * g + r % g), scaled in T, stored 128-byte swizzled
      // (chunk c of row r at chunk c ^ (r % 8)); QUNROLL loads in flight
      const int t = threadIdx.x - 32;
      int j = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++j) {
        const Item it = item(i);
        const int qb = j & 1;
        if (j >= 2)
          mbar_wait(smem_addr(&bars->q_empty[qb]), (uint32_t)((j / 2 - 1) & 1));
        const T* qrow = q + it.b * p.qs[0] + (int64_t)it.kvh * g * p.qs[2];
        uint8_t* dst = sQ + qb * Q_BYTES;
        for (int base = t; base < WBM * CH; base += QLOADERS * QUNROLL) {
          uint4 pk[QUNROLL];
#pragma unroll
          for (int u = 0; u < QUNROLL; ++u) {
            const int idx = base + QLOADERS * u;
            const int rr = it.r0 + idx / CH, pos = rr / g;
            pk[u] = make_uint4(0u, 0u, 0u, 0u);
            if (idx < WBM * CH && rr < rows)
              pk[u] = *reinterpret_cast<const uint4*>(
                  qrow + pos * p.qs[1] + (rr - pos * g) * p.qs[2]
                  + 8 * (idx % CH));
          }
#pragma unroll
          for (int u = 0; u < QUNROLL; ++u) {
            const int idx = base + QLOADERS * u;
            if (idx >= WBM * CH) break;
            const int r = idx / CH, c = idx % CH;
            T* e = reinterpret_cast<T*>(&pk[u]);
#pragma unroll
            for (int k = 0; k < 8; ++k) store(e + k, to_float(e[k]) * p.scale);
            *reinterpret_cast<uint4*>(dst + (c >> 3) * Q_PANEL + r * PANEL_ROW
                                      + (((c & 7) ^ (r & 7)) << 4)) = pk[u];
          }
        }
        // the generic-proxy stores become visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(smem_addr(&bars->q_full[qb]));
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                      // rows 64 cw .. 64 cw + 63
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int gq = lane >> 2, tq = lane & 3;

    // Ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 3 and 4), so one's products run while the
    // other does its softmax.  Inside a warpgroup, S of tile kt + 1 runs
    // ahead of P V of tile kt, and its softmax overlaps that P V.
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + cw) : "memory");
    };
    auto turn_pass = [&](bool final) {
      if (!(final && cw == 1))
        asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - cw) : "memory");
    };
    if (cw == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

    // statistics in the base-2 domain: m and the scores are log2(e) times
    // the natural ones, so exp(x - m) is one ex2 of their difference
    float m[2], l[2], scale_o[2];
    float acc[D / 2], s[WBN / 2];
    uint32_t ph[WBN / 16][4], pl[WBN / 16][4];
    int n = 0;                                  // ring position of tile 0
    int j = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++j) {
      const Item it = item(i);
      const bool final_item = i + (int)gridDim.x >= n_items;
      const int qb = j & 1;
      // this thread's two rows: gq and gq + 8 of its warp's 16
      const int row0 = it.r0 + cw * 64 + warp * 16 + gq;
      const int qpos[2] = {row0 / g + q_offset, (row0 + 8) / g + q_offset};
      const uint32_t q_base = smem_addr(sQ + qb * Q_BYTES)
                              + cw * 64 * PANEL_ROW;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = NEG_BIG;
        l[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;

      // S = Q K^T: 16 columns of d a step, 32 bytes into a 128-byte row
      auto issue_s = [&](int kt) {
        const int st = (int)((n + kt) % WSTAGES);
        const uint32_t k_base = smem_addr(sK + st * KV_BYTES);
        mbar_wait(smem_addr(&bars->full_k[st]),
                  (uint32_t)(((n + kt) / WSTAGES) & 1));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks & 3) * 32;
          wgmma_ss(s,
                   sw128_desc(q_base + (ks >> 2) * Q_PANEL + off, 16, 1024),
                   sw128_desc(k_base + (ks >> 2) * KV_PANEL + off, 16,
                              1024),
                   ks > 0, q);
        }
        wgmma_commit();
      };
      // O += P V: 16 keys a step, 16 rows of 128 bytes into each V panel
      auto issue_pv = [&](int kt) {
        const int st = (int)((n + kt) % WSTAGES);
        const uint32_t v_base = smem_addr(sV + st * KV_BYTES);
        mbar_wait(smem_addr(&bars->full_v[st]),
                  (uint32_t)(((n + kt) / WSTAGES) & 1));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBN / 16; ++kk) {
          const uint64_t dv = sw128_desc(v_base + kk * 16 * PANEL_ROW,
                                         KV_PANEL, 1024);
          wgmma_rs(acc, ph[kk], dv, q);
          wgmma_rs(acc, pl[kk], dv, q);
        }
        wgmma_commit();
      };
      auto release_k = [&](int kt) {
        if (t == 0)
          mbar_arrive(smem_addr(&bars->empty_k[(n + kt) % WSTAGES]));
      };
      auto release_v = [&](int kt) {
        if (t == 0)
          mbar_arrive(smem_addr(&bars->empty_v[(n + kt) % WSTAGES]));
      };
      auto keep_pv = [&]() {
#pragma unroll
        for (int r = 0; r < D / 2; ++r) keep(acc[r]);
#pragma unroll
        for (int kk = 0; kk < WBN / 16; ++kk)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            keep(ph[kk][a]);
            keep(pl[kk][a]);
          }
      };

      // masks and the online softmax of rows gq (e = 0, 1) and gq + 8: P
      // left in s, O's rescale in scale_o.  Then P's hi and lo halves: S's
      // accumulator layout is wgmma's A fragment layout, 16 keys (two
      // 8-column blocks) per step
      auto softmax = [&](int kt) {
#pragma unroll
        for (int i = 0; i < WBN / 2; ++i) keep(s[i]);
        const int c0 = kt * WBN;
        // keys from sk_rel on are past Sk; keys above q_rel[i] are causally
        // masked for row i; only edge tiles have either
        const int sk_rel = sk - c0 < WBN ? sk - c0 : WBN;
        int q_rel[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = qpos[i] - c0;
          q_rel[i] = !p.causal || d >= WBN ? WBN : (d < -1 ? -1 : (int)d);
        }
        const bool edge = sk_rel < WBN || q_rel[0] < WBN - 1
                          || q_rel[1] < WBN - 1;
        float mx[2] = {-INFINITY, -INFINITY};
        // two copies of the loop, so that tiles off the edges issue no
        // masking instructions at all
        auto scale_max = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = s[4 * j + e] * LOG2E;
              if constexpr (decltype(masked)::value) {
                const int key = j * 8 + 2 * tq + (e & 1);
                if (key >= sk_rel) x = -INFINITY;
                else if (key > q_rel[e >> 1]) x = NEG_BIG;
              }
              s[4 * j + e] = x;
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        };
        if (edge) scale_max(std::true_type{});
        else scale_max(std::false_type{});
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          alpha[i] = ex2(m[i] - m_new);
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * j + e];
            x = ex2(x - m[e >> 1]);
            rs[e >> 1] += x;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
          l[i] = alpha[i] * l[i] + rs[i];
          scale_o[i] = alpha[i];
        }
      };
      // after P V of the previous tile: O rescaled, P split into A fragments
      auto rescale_split = [&]() {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= scale_o[0]; acc[4 * j + 1] *= scale_o[0];
          acc[4 * j + 2] *= scale_o[1]; acc[4 * j + 3] *= scale_o[1];
        }
#pragma unroll
        for (int kk = 0; kk < WBN / 16; ++kk)
#pragma unroll
          for (int a = 0; a < 4; ++a)
            split2(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], ph[kk][a],
                   pl[kk][a], q);
      };

      // the loop is peeled (first S before it, last P V after it) so that
      // every wgmma group is issued and retired on one path: ptxas then
      // keeps the two groups of an iteration in flight together
      mbar_wait(smem_addr(&bars->q_full[qb]), (uint32_t)((j / 2) & 1));
      turn_wait();
      issue_s(0);
      turn_pass(false);
      wgmma_wait<0>();
      release_k(0);
      softmax(0);
      rescale_split();
      for (int kt = 0; kt + 1 < it.last; ++kt) {
        turn_wait();
        issue_s(kt + 1);
        issue_pv(kt);
        turn_pass(false);
        wgmma_wait<1>();           // S of tile kt + 1 is done, P V runs on
        release_k(kt + 1);
        softmax(kt + 1);
        wgmma_wait<0>();
        keep_pv();
        release_v(kt);
        rescale_split();
      }
      turn_wait();
      issue_pv(it.last - 1);
      turn_pass(final_item);
      wgmma_wait<0>();
      keep_pv();
      release_v(it.last - 1);
      if (t == 0) mbar_arrive(smem_addr(&bars->q_empty[qb]));
      n += it.last;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row0 + 8 * r, pos = rr / g;
        if (rr >= rows) continue;
        T* orow = o + ((it.b * p.Sq + pos) * p.H + it.kvh * g + rr - pos * g)
                      * D;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * tq) = pack2(
              acc[4 * c + 2 * r] / den, acc[4 * c + 2 * r + 1] / den, q);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (the library links only the runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 4-D map of k or v, dims (d, kv head, key, batch) innermost first, boxes
// of 64 values x 1 head x WBN keys x 1 batch, 128-byte swizzle; keys past
// Sk read as zeros
static bool tensor_map(CUtensorMap* map, const void* base, const int64_t* s,
                       const FlashParams& p, int d, bool bf16) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)p.KV,
                              (cuuint64_t)p.Sk, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {64, 1, WBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
static int launch_wgmma(const FlashParams& p, const void* q, const void* k,
                        const void* v, void* o, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, p.ks, p, D, bf16) ||
      !tensor_map(&tv, v, p.vs, p, D, bf16))
    return BAD_TENSOR_MAP;
  const int smem = 2 * (WBM + WSTAGES * WBN) * D * (int)sizeof(T) + 1024
                   + (int)sizeof(WgBarriers);
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // persistent: one block per SM, or one per work item where fewer
  const int64_t rows = p.Sq * (p.H / p.KV);
  const int64_t items = (rows + WBM - 1) / WBM * (p.B * p.KV);
  const unsigned grid = (unsigned)(items < n_sm ? items : n_sm);
  flash_wgmma_kernel<T, D><<<grid, WTHREADS, smem, stream>>>(
      tk, tv, static_cast<const T*>(q), static_cast<T*>(o), p);
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
      if constexpr (tc) return launch_wgmma<T, 64>(p, q, k, v, o, stream);
      else return launch<T, 64>(p, q, k, v, o, stream);
    case 128:
      if constexpr (tc) return launch_wgmma<T, 128>(p, q, k, v, o, stream);
      else return launch<T, 128>(p, q, k, v, o, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  dims (int64): B, Sq, Sk, H, KV,
// q_offset, causal, then the (batch, seq, head) strides of q, k and v, then
// the query rows and keys of a block's tile that the launcher planned for
// (ops.tile_plan), which must be the kernel's.  The output o is contiguous
// (B, Sq, H, d).  Returns a cudaError_t, or BAD_TENSOR_MAP.
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
  const bool tc = dtype != 0 && (d == 64 || d == 128);
  if (dims[16] != (tc ? WBM : BM) || dims[17] != (tc ? WBN : BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(d, p, q, k, v, o, st);
    case 1: return launch_d<__nv_bfloat16>(d, p, q, k, v, o, st);
    case 2: return launch_d<__half>(d, p, q, k, v, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int rc) {
  if (rc == BAD_TENSOR_MAP) return "cuTensorMapEncodeTiled refused k or v";
  return cudaGetErrorString((cudaError_t)rc);
}
