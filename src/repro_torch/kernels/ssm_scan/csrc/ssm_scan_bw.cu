// Backward of the chunked linear-recurrence scan for Hopper (sm_90a), bound
// with ctypes.
//
// Replaces no TPU kernel: ssm_scan_pallas (src/repro/kernels/ssm_scan/
// ssm_scan.py:49) has no backward, and the reference differentiates its
// plain jnp scan.  Before this library the port ran the forward kernels
// three more times on time-reversed copies (dq, dk, dv) and reduced
// d log_a in torch; this library replaces that composition.
//
// With b_t = sum_{r<=t} log a_r the forward is y_t = sum_{s<=t}
// e^{b_t - b_s} (q_t . k_s) v_s.  For an upstream gradient dy:
//
//   dq_t = sum_{s<=t} e^{b_t-b_s} (dy_t . v_s) k_s    = S_t dy_t
//   dk_s = sum_{t>=s} e^{b_t-b_s} (v_s . dy_t) q_t    = G_s v_s
//   dv_s = sum_{t>=s} e^{b_t-b_s} (k_s . q_t) dy_t    = G_s^T k_s
//   d log_a_t = sum_{r>=t} (q_r . dq_r - k_r . dk_r)
//
// with S the forward state and G_s = sum_{t>=s} e^{b_t-b_s} q_t dy_t^T the
// reverse one.  In 64-step chunks (cum the in-chunk cumsum of log a, so
// decays are formed only for t >= s and exp never overflows), with the
// intra-chunk matrices P[t,s] = (q_t . k_s) e^{cum_t-cum_s} and D[t,s] =
// (dy_t . v_s) e^{cum_t-cum_s} for t >= s:
//
//   1. forward in time:  dq_t = sum_s D[t,s] k_s + e^{cum_t} S dy_t,
//      S <- e^{cum_T} S + sum_s e^{cum_T-cum_s} k_s v_s^T; in the epilogue,
//      from fp32 dq, u_t = q_t . dq_t;
//   2. reverse in time (the chunks from the last, so a ragged last chunk is
//      the first masked; nothing is flipped or copied):
//      dk_s = sum_t D[t,s] q_t + e^{cum_T-cum_s} G v_s,
//      dv_s = sum_t P[t,s] dy_t + e^{cum_T-cum_s} G^T k_s,
//      G <- e^{cum_T} G + sum_t e^{cum_t} q_t dy_t^T; from fp32 dk,
//      w_t = k_t . dk_t;
//   3. d log_a_t = sum_{r>=t} (u_r - w_r) in fp32 (scan_dla_kernel).  The
//      diagonal terms (s = t) of u and w cancel: neither is rounded before
//      the difference.
//
// dq and dk are written once in q's and k's dtype, dv in v's; q and k are
// read through their strides (Zamba2's one head broadcast with stride 0 is
// never copied).
//
// Design.  Each pass is the forward's kernel (scan_common.cuh) with other
// operands and, for step 2, the other direction.  A block keeps a column
// slab of its pass's state (32 or 128 output columns), so its output
// columns are complete and its sums over the contraction dim stay in the
// block.  dk and dv contract over different dims of G (V for dk, K for
// dv), so one slab of G gives whole dv columns but only a partial dk sum
// over its V columns.  Of the three ways out (split-K partials of dk
// reduced by a second pass: 32 slabs at xLSTM's V = 1024 would write 32 fp32
// copies of dk, 2 GB at 2x2048; atomics: an order that changes from run to
// run; two reverse passes, dk sliced by rows of K and dv by columns of V),
// this takes the third at every shape: the reverse step runs as two
// launches, dv = (X, Z, W) = (k, q, dy) over slabs of V and dk = (v, dy, q)
// over slabs of K, each carrying its own layout of G.  D and P are formed
// once each by scan_intra_kernel (D from (dy, v), P from (q, k)), as bf16
// hi and lo halves in a scratch: D serves pass 1 and dk, P serves dv (16
// KB per (head, chunk) each: 67 MB for the pair at Zamba2's 2x2048 shape,
// 4 MB at xLSTM's).  The row dots u and w are sums over K, which pass 1 and
// dk slice too: each block writes its slab's partial dot per row, fp32,
// into a (slab, B, H, S) buffer, and scan_dla_kernel sums the slabs in a
// fixed order before its reverse cumsum, so the result does not change
// from run to run.  R (q or k) comes into shared memory with the chunk's
// other tiles: read from device memory in the epilogue, its latency sat on
// every chunk's critical path.
//
// At Zamba2's shape the dv pass could take slabs of 32 or 128: it takes
// 128 (one slab, G^T whole in a block), as the forward does.  The three
// state passes cost about the same there (chip_smoke.py phase 11 prints
// each kernel's device time; PERF.md keeps them), so a reverse pass that
// gave dk from the dv pass's G^T (possible only where one slab covers V,
// and then summing G^T's contribution over the 8 warps of a block) would
// save at most one pass; it is not built.
//
// Routes.  bf16: the tensor cores (mma.sync m16n8k16 bf16 -> fp32), every
// fp32 operand (the state, D and P, the coefficient-weighted rows) split
// into bf16 hi and lo halves, as in the forward, so the gradients stay
// near fp32 rounding.  fp32 and fp16: ssm_scan_kernel on the CUDA cores in
// fp32 (fp16 upcast), forming each chunk's P or D itself.
//
// Bound on the H100 (the function's least work: q, k, v, dy, log_a read
// once, dq, dk, dv, d log_a written once; 10 K V FLOP per step and head).
// Zamba2-1.2B at 2x2048 (32 heads, K = 64, V = 128, q and k one head):
// 103.8 MB, 0.031 ms at 3.35 TB/s.  xLSTM-1.3B at 2x2048 (4 heads, K = V =
// 1024): 1.72e11 FLOP, 0.174 ms at 989 TFLOP/s.  This design moves more:
// the D and P scratch (written once, D read twice), and three state passes
// whose hi/lo products do about 24 K V FLOP per step and head.

#include "scan_common.cuh"

#define DTHREADS 1024

// d log_a of one (batch, head): the slabs' partial u summed, minus the
// partial w summed, each in slab order, then the sum over r >= t by tiles
// of DTHREADS steps from the end (a suffix scan by warp shuffles, the warp
// totals through shared memory, a carry between tiles).  part: (nu + nw,
// B * H, S); dla: (B, S, H) contiguous.
__global__ void __launch_bounds__(DTHREADS)
scan_dla_kernel(const float* __restrict__ part, int nu, int nw,
                float* __restrict__ dla, int64_t S, int64_t H, int64_t BH) {
  __shared__ float wsum[DTHREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh % H;
  float carry = 0.f;
  for (int64_t end = S; end > 0; end -= DTHREADS) {
    const int64_t t = end - DTHREADS + tid;
    float x = 0.f;
    if (t >= 0) {
      float u = 0.f, w = 0.f;
#pragma unroll 8
      for (int j = 0; j < nu; ++j) u += part[(j * BH + bh) * S + t];
#pragma unroll 8
      for (int j = 0; j < nw; ++j) w += part[((nu + j) * BH + bh) * S + t];
      x = u - w;
    }
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {   // sum over this lane and later
      const float y = __shfl_down_sync(0xffffffffu, x, off);
      if (lane + off < 32) x += y;
    }
    if (lane == 0) wsum[warp] = x;
    __syncthreads();
    float later = carry;
    for (int w = warp + 1; w < DTHREADS / 32; ++w) later += wsum[w];
    if (t >= 0) dla[(b * S + t) * H + h] = x + later;
    float tile = 0.f;
    for (int w = 0; w < DTHREADS / 32; ++w) tile += wsum[w];
    carry += tile;
    __syncthreads();   // wsum is rewritten by the next tile
  }
}

static int dla_pass(const float* part, int nu, int nw, float* dla,
                    int64_t B, int64_t S, int64_t H, cudaStream_t st) {
  scan_dla_kernel<<<(unsigned)(B * H), DTHREADS, 0, st>>>(part, nu, nw, dla,
                                                          S, H, B * H);
  return (int)cudaGetLastError();
}

// dims (int64): B, S, H, K, V, then the (batch, seq, head) strides of q, k,
// v, log_a and dy in elements (the last dimension of q, k, v and dy is
// contiguous).  vts: the slab widths of the dq, dv and dk passes.  dq, dk
// (B, S, H, K), dv (B, S, H, V) and dla (B, S, H) contiguous; part: (nu +
// nw, B, H, S) float scratch, nu = ceil(K / vts[0]), nw = ceil(K / vts[2]).

// fp32/fp16 route: dtype 0 float32, 2 float16; vts of 32 or 64.  Launches
// ssm_scan_kernel three times (dq forward, dv and dk in reverse), then
// scan_dla_kernel; returns a cudaError_t.
extern "C" int repro_ssm_scan_bw(int dtype, const int* vts, const void* q,
                                 const void* k, const void* v,
                                 const float* la, const void* dy, void* dq,
                                 void* dk, void* dv, float* dla, float* part,
                                 const int64_t* dims, void* stream) {
  const int64_t B = dims[0], S = dims[1], H = dims[2], K = dims[3],
                V = dims[4];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nu = (int)((K + vts[0] - 1) / vts[0]);
  const int nw = (int)((K + vts[2] - 1) / vts[2]);
  ScanParams p = {};
  p.B = B; p.S = S; p.H = H;
  strides(p.ls, dims, 14);
  // 1. dq = (dy, v, k) forward; u against q
  p.K = V; p.V = K; p.Kpad = (V + KC - 1) / KC * KC;
  strides(p.qs, dims, 17); strides(p.ks, dims, 11); strides(p.vs, dims, 8);
  p.rd = q; strides(p.rs, dims, 5); p.part = part;
  int rc = core_pass<false>(dtype, vts[0], p, dy, v, k, la, dq, st);
  if (rc) return rc;
  // 2a. dv = (k, q, dy) in reverse
  p.K = K; p.V = V; p.Kpad = (K + KC - 1) / KC * KC;
  strides(p.qs, dims, 8); strides(p.ks, dims, 5); strides(p.vs, dims, 17);
  p.rd = nullptr; p.part = nullptr;
  rc = core_pass<true>(dtype, vts[1], p, k, q, dy, la, dv, st);
  if (rc) return rc;
  // 2b. dk = (v, dy, q) in reverse; w against k
  p.K = V; p.V = K; p.Kpad = (V + KC - 1) / KC * KC;
  strides(p.qs, dims, 11); strides(p.ks, dims, 17); strides(p.vs, dims, 5);
  p.rd = k; strides(p.rs, dims, 8); p.part = part + (int64_t)nu * B * H * S;
  rc = core_pass<true>(dtype, vts[2], p, v, dy, q, la, dk, st);
  if (rc) return rc;
  return dla_pass(part, nu, nw, dla, B, S, H, st);
}

// bf16 route: vts of 32 or 128; vec: 16-byte copies of q, k, v and dy (K,
// V and every stride a multiple of 8 elements, pointers 16-byte aligned).
// P, D: (B * H * NC, T2 * T2) uint32 scratch, coef: (B * H * NC, CREC)
// float scratch, NC = ceil(S / T2).  Launches scan_intra_kernel twice (P,
// D), scan_state_kernel three times (dq forward, dv and dk in reverse), then
// scan_dla_kernel; returns a cudaError_t.
extern "C" int repro_ssm_scan_bw_bf16(const int* vts, int vec, const void* q,
                                      const void* k, const void* v,
                                      const float* la, const void* dy,
                                      void* dq, void* dk, void* dv,
                                      float* dla, float* part, void* P,
                                      void* D, void* coef,
                                      const int64_t* dims, void* stream) {
  const int64_t B = dims[0], S = dims[1], H = dims[2], K = dims[3],
                V = dims[4];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nu = (int)((K + vts[0] - 1) / vts[0]);
  const int nw = (int)((K + vts[2] - 1) / vts[2]);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* gg = static_cast<const bf16*>(dy);
  uint32_t* pp = static_cast<uint32_t*>(P);
  uint32_t* dd = static_cast<uint32_t*>(D);
  float* cf = static_cast<float*>(coef);
  MmaParams p = {};
  p.B = B; p.S = S; p.H = H; p.NC = (S + T2 - 1) / T2;
  strides(p.ls, dims, 14);
  if (p.NC < 1 || !state_kw(vts[0], V) || !state_kw(vts[1], K) ||
      !state_kw(vts[2], V))
    return (int)cudaErrorInvalidValue;
  // P = q k^T (decayed, below the diagonal) and the coefficients
  p.K = K;
  strides(p.qs, dims, 5); strides(p.ks, dims, 8);
  int rc = intra_pass(p, vec, qq, kk, la, pp, cf, st);
  if (rc) return rc;
  // D = dy v^T
  p.K = V;
  strides(p.qs, dims, 17); strides(p.ks, dims, 11);
  rc = intra_pass(p, vec, gg, vv, la, dd, nullptr, st);
  if (rc) return rc;
  // 1. dq = (dy, v, k) forward with D; u against q
  p.K = V; p.V = K;
  strides(p.qs, dims, 17); strides(p.ks, dims, 11); strides(p.vs, dims, 8);
  p.rd = qq; strides(p.rs, dims, 5); p.part = part;
  rc = state_pass<false, true>(vts[0], p, vec, gg, vv, kk, dd, cf,
                         static_cast<bf16*>(dq), st);
  if (rc) return rc;
  // 2a. dv = (k, q, dy) in reverse with P
  p.K = K; p.V = V;
  strides(p.qs, dims, 8); strides(p.ks, dims, 5); strides(p.vs, dims, 17);
  p.rd = nullptr; p.part = nullptr;
  rc = state_pass<true, false>(vts[1], p, vec, kk, qq, gg, pp, cf,
                        static_cast<bf16*>(dv), st);
  if (rc) return rc;
  // 2b. dk = (v, dy, q) in reverse with D; w against k
  p.K = V; p.V = K;
  strides(p.qs, dims, 11); strides(p.ks, dims, 17); strides(p.vs, dims, 5);
  p.rd = kk; strides(p.rs, dims, 8); p.part = part + (int64_t)nu * B * H * S;
  rc = state_pass<true, true>(vts[2], p, vec, vv, gg, qq, dd, cf,
                        static_cast<bf16*>(dk), st);
  if (rc) return rc;
  return dla_pass(part, nu, nw, dla, B, S, H, st);
}

extern "C" const char* repro_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
