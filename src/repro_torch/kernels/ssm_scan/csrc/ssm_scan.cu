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
//
// The kernels live in scan_common.cuh, templated on the direction in time:
// this library runs them forward.  ssm_scan_bw.cu is the backward (the TPU
// kernel has none): one pass forward in time for dq, two in reverse for dv
// and dk, and a d log_a kernel, in place of the three runs of this
// library's scan on time-reversed copies that the port used before; its
// note gives the design and the bound (0.031 ms at Zamba2's 2x2048 shape,
// 0.174 ms at xLSTM's).

#include "scan_common.cuh"

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
  ScanParams p = {};
  p.B = dims[0]; p.S = dims[1]; p.H = dims[2]; p.K = dims[3]; p.V = dims[4];
  p.Kpad = (p.K + KC - 1) / KC * KC;
  strides(p.qs, dims, 5);
  strides(p.ks, dims, 8);
  strides(p.vs, dims, 11);
  strides(p.ls, dims, 14);
  return core_pass<false>(dtype, vt, p, q, k, v, la, y,
                          static_cast<cudaStream_t>(stream));
}

// bf16 route.  vt: 32 or 128; vec: 16-byte copies of q, k and v (K, V
// and every stride a multiple of 8 elements, pointers 16-byte aligned).
// dims as repro_ssm_scan's; y bf16.  P: (B * H * NC, T2 * T2) uint32
// scratch (each P's bf16 hi and lo halves), coef: (B * H * NC, CREC) float
// scratch, NC = ceil(S / T2).  Launches scan_intra_kernel, then
// scan_state_kernel; returns a cudaError_t.
extern "C" int repro_ssm_scan_bf16(int vt, int vec, const void* q,
                                   const void* k, const void* v,
                                   const float* la, void* y, void* P,
                                   void* coef, const int64_t* dims,
                                   void* stream) {
  MmaParams p = {};
  p.B = dims[0]; p.S = dims[1]; p.H = dims[2]; p.K = dims[3]; p.V = dims[4];
  p.NC = (p.S + T2 - 1) / T2;
  strides(p.qs, dims, 5);
  strides(p.ks, dims, 8);
  strides(p.vs, dims, 11);
  strides(p.ls, dims, 14);
  if (!state_kw(vt, p.K) || p.NC < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  uint32_t* pp = static_cast<uint32_t*>(P);
  float* cf = static_cast<float*>(coef);
  int rc = intra_pass(p, vec, qq, kk, la, pp, cf, st);
  if (rc) return rc;
  return state_pass<false, false>(vt, p, vec, qq, kk,
                                  static_cast<const bf16*>(v), pp, cf,
                                  static_cast<bf16*>(y), st);
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
