// Fused int8 conv kernels for Hopper (sm_90a), bound with ctypes.
//
// chain_kernel replaces the TPU kernel fused_chain_pallas
// (src/repro/kernels/conv_fused/conv_fused.py, body _chain_kernel): one
// lowered op chain (conv / max-avg-global pool / eltwise-add stages) runs as
// one launch.  One block computes one (image, row tile, width tile, OC tile)
// of the final output.  It loads its halo'd input window into shared memory
// and walks the stages, ping-ponging between two shared buffers, so no
// intermediate feature map touches device memory.  Intermediates are stored
// as int8: every stage output is already clipped to [-128, 127], so int8
// storage is exact and a quarter of int32's size.  Rows and columns outside
// a stage's true extent are written as the next stage's pad identity (-128
// before a max pool, else 0), which reproduces zero-padded convs, -128-padded
// and ceil-extended max pools and count-include-pad avg pools exactly, at any
// tile.  Image borders are padded virtually: a load outside the input reads
// the first stage's pad identity, so the launcher never pads in memory.
// A window whose halo reaches past all that its stage's true outputs read
// (a small tile's receptive field beyond a small map, as in VGG16's 9-stage
// chains on 16x16 maps) is cut to that range (ops._windows); a stage then
// reads its input at an offset, clamped to the window, and the outputs
// whose reads the clamp moves are ones the tile's final output does not
// depend on.
//
// Each conv stage is an implicit GEMM on the int8 tensor cores (mma.sync
// m16n8k32 s8 x s8 -> s32): M = the stage's output pixels, N = its output
// channels (the block's OC tile from the last conv on), K = kh * kw * cin.
// The launcher packs each conv's weights once (ops.pack_chain_weights):
// OC-major, K contiguous in (kh, kw, ic) order with ic padded to a multiple
// of 4, K padded to 32 with zeros.  The block stages the rows of its OC
// tile into shared memory by cp.async, the next conv's panel loading while
// this stage computes, and reads B fragments with ldmatrix from rows padded
// to an odd number of 16-byte chunks (no bank conflicts).  A fragments are
// 4-byte loads from the int8 window itself: a table of each K group's
// offset in the window (tap row, tap column, input channel) is built once
// per stage, so an A register is one load at pixel offset + table entry.
// Windows keep a pixel stride of the channels rounded up to 4 (plus 16
// bytes where that stride is a multiple of 32 words, which would put the 8
// pixel rows of a fragment in one bank); the bytes past the channels are
// never written and meet only zero weights.  conv1's 3-channel input takes
// the same path with its pixels padded to 4 channels.  A warp takes
// (16-pixel tile, 8 * NT-channel block) items in turn, NT = 4, 2 or 1 by
// the stage's channels.  The epilogue, the pool and eltwise stages and the
// window's pad-identity masking are those of the reference; the input
// window is loaded in 16- or 4-byte words where channels and strides allow.
//
// horizontal_mma_kernel replaces fused_horizontal_pallas (same file, body
// _horizontal_kernel): sibling convs over OC-stacked weights as one
// implicit GEMM (M = output pixels, K = KH*KW*IC, N = sum of OC) on the
// int8 tensor cores (mma.sync m16n8k32), weights packed once by the
// launcher, K steps pipelined through shared memory, and split-K so that
// small images still fill the SMs; see its note below.
//
// What bounds them on an H100: at batch 1 the 51 launches of a GoogLeNet-224
// image read and write about 14 MB (each launch's inputs, weights and output
// once) and do about 1.6 G int8 MACs, so the card's bound is bytes: about
// 4 us at 3.35 TB/s, against about 1.6 us of int8 tensor-core work at
// 1,979 TOP/s.  Both kernels sit far below a launch's own latency there, so
// they are built for latency: tensor cores, weights staged in 16-byte
// copies, no index arithmetic per byte in the inner loops, and (chain) a
// tile planner that trades per-block work against waves of blocks over the
// 132 SMs (ops.choose_chain_tile).
//
// Numerics are exactly the reference's int8_ops: int32 accumulation,
// round-half-away-from-zero shifts (a negative shift is a left shift, done
// through uint32_t), saturation to int8, and avg pools' sign-magnitude
// rounded divide (abs taken before dividing).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Stages a chain may have (ops.MAX_STAGES): the records and pointers below
// are kernel parameters, and 24 stages keep them within 4 KB.
#define MAX_STAGES 24
#define HDR 34
#define STG 34
#define THREADS 256

// One stage record; field order matches ops.chain_plan.
struct Stage {
  int type;     // 0 conv, 1 pool, 2 elt
  int kh, kw, sh, sw, dh, dw;
  int shift;    // conv: requantization shift; elt: shift of the main input
  int relu;     // conv: ReLU; elt: ReLU of the sum
  int pkind;    // pool: 0 max, 1 avg (global pools are avg over the window)
  int cnt;      // pool: divisor
  int s_side;   // elt: shift of the side input
  int rows, cols, cin, cout;   // this block's output window and channels
  int kp;       // conv: packed K (a multiple of 32), the weight row length
  int sliced;   // output channels are the block's OC tile
  int q0, q1, true_h, true_w;  // padded-coordinate offset and true extent
  int fout, foutw;             // window step between neighbouring tiles
  int fill_next;               // pad identity of the next stage
  int out_buf;                 // 0 buffer A, 1 buffer B, 2 the output
  int side_h, side_w, side_sn, side_sh, side_sw;
  int ps;       // pixel stride in bytes of this stage's output window
  int or0, oc0; // origin of a cut output window (-1: the tile's own)
};
static_assert(sizeof(Stage) == STG * 4, "stage record size");

struct Header {
  int n_stages, N, H, W, C, x_sn, x_sh, x_sw;
  int in_rows, in_cols, in_c, in_sliced, f_in, fw_in, q_in0, q_in1, fill0;
  int th, tw, toc, n_h, n_w, n_k, OH, OW, OC, buf_b;
  int in_ps;    // pixel stride in bytes of the input window
  int w_off;    // shared offset of the even convs' weight panels
  int w1_off;   // shared offset of the odd convs' weight panels
  int koff;     // shared offset of the K-group offset table
  int global_b; // bit i: conv stage i reads its weights from device memory
  int in_or, in_oc;  // origin of a cut input window (-1: the tile's own)
};
static_assert(sizeof(Header) == HDR * 4, "header size");

struct ChainParams {
  Header h;
  Stage st[MAX_STAGES];
  const int8_t* x;
  int8_t* out;
  const int8_t* w[MAX_STAGES];   // packed (rows, kp) weights of each conv
  const int32_t* b[MAX_STAGES];
  const int8_t* side[MAX_STAGES];
};
static_assert(sizeof(ChainParams) <= 4096, "kernel parameters past 4 KB");

// The reference's int32 arithmetic (src/repro/core/int8_ops.py round_shift)
// under XLA's rules, with every wrap done on uint32_t so that it is defined:
// |x| of -2^31 is -2^31, |x| + 2^(s-1) wraps (1 << 31 is -2^31, a shift by
// 32 or more gives 0), and an arithmetic right shift by 32 or more fills
// with the sign bit, as one by 31 does.  sign(x) * r cannot wrap: a right
// shift by at least 1 leaves |r| <= 2^30.
__device__ __forceinline__ int round_shift(int x, int s) {
  const uint32_t ux = (uint32_t)x;
  if (s > 0) {
    const uint32_t ax = x < 0 ? 0u - ux : ux;
    const uint32_t half = s > 32 ? 0u : 1u << (s - 1);
    const int r = (int)(ax + half) >> (s < 31 ? s : 31);
    return x < 0 ? -r : (x > 0 ? r : 0);
  }
  const int l = -s;
  return l >= 32 ? 0 : (int)(ux << l);
}

// a + b wrapped to int32, as the reference's int32 addition wraps.
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int clamp8(int v) {
  return v < -128 ? -128 : (v > 127 ? 127 : v);
}

__device__ __forceinline__ int rounded_div(int s, int cnt) {
  int a = s < 0 ? -s : s;
  int q = (a + cnt / 2) / cnt;
  return s < 0 ? -q : q;
}

__device__ __forceinline__ uint32_t hsmem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void hcp16(uint32_t dst, const void* src,
                                      bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void hldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void hldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where one stage's windows sit for this block: its input window's extent
// and pixel stride, the input row and column that output (0, 0) reads at tap
// (0, 0), and the padded position of its output window's (0, 0).
struct Place {
  int src_rows, src_cols, ps_in;
  int dr, dc;
  int out_r, out_c;
};

// The input window's row (col) where output row r (col c) starts reading,
// clamped so that its taps stay inside the window.
__device__ __forceinline__ const int8_t* tap0(const Stage& s, const Place& pl,
                                              const int8_t* src, int r,
                                              int c) {
  const int rr = min(max(r * s.sh + pl.dr, 0),
                     pl.src_rows - s.dh * (s.kh - 1) - 1);
  const int cc = min(max(c * s.sw + pl.dc, 0),
                     pl.src_cols - s.dw * (s.kw - 1) - 1);
  return src + (rr * pl.src_cols + cc) * pl.ps_in;
}

// Writes one stage output value: to the output tensor for the last stage
// (inside (OH, OW) only), else to the next window, masked to the next
// stage's pad identity outside this stage's true extent.
__device__ __forceinline__ void put(const ChainParams& p, const Stage& s,
                                    const Place& pl, int8_t* dst, int idx,
                                    int n, int j, int jw, int r, int c,
                                    int ch, int v) {
  const Header& h = p.h;
  if (s.out_buf == 2) {
    const int orow = j * h.th + r;
    const int ocol = jw * h.tw + c;
    if (orow < h.OH && ocol < h.OW)
      p.out[(((long long)n * h.OH + orow) * h.OW + ocol) * h.OC + ch] =
          (int8_t)v;
  } else {
    const int pr = pl.out_r + r;
    const int pc = pl.out_c + c;
    const bool valid = pr >= s.q0 && pr < s.q0 + s.true_h &&
                       pc >= s.q1 && pc < s.q1 + s.true_w;
    dst[idx] = (int8_t)(valid ? v : s.fill_next);
  }
}

// Output channels a warp item of a conv stage covers, in n8 tiles.
__host__ __device__ __forceinline__ int conv_nt(int cout) {
  return cout >= 32 ? 4 : (cout > 8 ? 2 : 1);
}

// A conv stage as an implicit GEMM on the int8 tensor cores; wsm holds the
// block's rows of the packed weights (rows of kp + 16 bytes), or with GB
// the B fragments come from the packed weights in device memory (a panel
// too large for shared memory); koff holds each K group's byte offset in
// the source window.
template <int NT, bool GB>
__device__ void conv_stage_mma(const ChainParams& p, int i, const Stage& s,
                               const Place& pl, const int8_t* src,
                               int8_t* dst, const int8_t* wsm,
                               const int* koff, int k, int j, int jw, int n) {
  const int ch0 = s.sliced ? k * p.h.toc : 0;
  const int M = s.rows * s.cols;
  const int mt = (M + 15) / 16;
  const int items = mt * ((s.cout + 8 * NT - 1) / (8 * NT));
  const int kpr = s.kp + 16, ksteps = s.kp / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t wbase = hsmem(wsm);
  const int32_t* bias = p.b[i] + ch0;
  for (int item = warp; item < items; item += THREADS / 32) {
    const int m0 = (item % mt) * 16, n0 = (item / mt) * 8 * NT;
    const int8_t* px[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = min(m0 + g + 8 * hh, M - 1);
      const int r = m / s.cols, c = m - r * s.cols;
      px[hh] = tap0(s, pl, src, r, c);
    }
    int acc[NT][4];
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0;
    uint32_t baddr = 0;
    const int8_t* wg = p.w[i] + (long long)(ch0 + n0 + g) * s.kp + 4 * t;
    if constexpr (GB) {
    } else if constexpr (NT >= 2)
      baddr = wbase + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kpr
              + ((lane >> 3) & 1) * 16;
    else
      baddr = wbase + (n0 + (lane & 7)) * kpr + ((lane >> 3) & 1) * 16;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const int o0 = koff[8 * ks + t], o1 = koff[8 * ks + 4 + t];
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(px[0] + o0);
      a[1] = *reinterpret_cast<const uint32_t*>(px[1] + o0);
      a[2] = *reinterpret_cast<const uint32_t*>(px[0] + o1);
      a[3] = *reinterpret_cast<const uint32_t*>(px[1] + o1);
      if constexpr (GB) {
#pragma unroll
        for (int a2 = 0; a2 < NT; ++a2) {
          const int8_t* wr = wg + (long long)8 * a2 * s.kp + 32 * ks;
          mma_s8(acc[a2], a, __ldg(reinterpret_cast<const uint32_t*>(wr)),
                 __ldg(reinterpret_cast<const uint32_t*>(wr + 16)));
        }
      } else if constexpr (NT >= 2) {
#pragma unroll
        for (int b2 = 0; b2 < NT / 2; ++b2) {
          uint32_t bf[4];
          hldsm_x4(bf, baddr + b2 * 16 * kpr + ks * 32);
          mma_s8(acc[2 * b2], a, bf[0], bf[1]);
          mma_s8(acc[2 * b2 + 1], a, bf[2], bf[3]);
        }
      } else {
        uint32_t bf[2];
        hldsm_x2(bf, baddr + ks * 32);
        mma_s8(acc[0], a, bf[0], bf[1]);
      }
    }
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e >> 1);
        const int col = n0 + 8 * a + 2 * t + (e & 1);
        if (m >= M || col >= s.cout) continue;
        const int r = m / s.cols, c = m - r * s.cols;
        int v = round_shift(add32(acc[a][e], bias[col]), s.shift);
        if (s.relu) v = max(v, 0);
        put(p, s, pl, dst, m * s.ps + col, n, j, jw, r, c, ch0 + col,
            clamp8(v));
      }
  }
}

// A pool or eltwise stage, one output value per thread.
__device__ void stage_scalar(const ChainParams& p, int i, const Stage& s,
                             const Place& pl, const int8_t* src, int8_t* dst,
                             int k, int j, int jw, int n) {
  const int src_cols = pl.src_cols, ps_in = pl.ps_in;
  const int ch0 = s.sliced ? k * p.h.toc : 0;
  const int total = s.rows * s.cols * s.cout;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int o = idx % s.cout;
    const int rc = idx / s.cout;
    const int c = rc % s.cols;
    const int r = rc / s.cols;
    int v;
    if (s.type == 1) {  // pool: channelwise, cin == cout
      const int8_t* sp = tap0(s, pl, src, r, c) + o;
      if (s.pkind == 0) {
        int best = -128;
        for (int ki = 0; ki < s.kh; ++ki)
          for (int kj = 0; kj < s.kw; ++kj)
            best = max(best, (int)sp[(ki * src_cols + kj) * ps_in]);
        v = best;
      } else {
        int sum = 0;
        for (int ki = 0; ki < s.kh; ++ki)
          for (int kj = 0; kj < s.kw; ++kj)
            sum += (int)sp[(ki * src_cols + kj) * ps_in];
        v = clamp8(rounded_div(sum, s.cnt));
      }
    } else {  // elt: a 1x1 window at stride 1
      const int a = tap0(s, pl, src, r, c)[o];
      const int sr = pl.out_r + r - s.q0;
      const int sc = pl.out_c + c - s.q1;
      int b = 0;
      if (sr >= 0 && sr < s.side_h && sc >= 0 && sc < s.side_w)
        b = p.side[i][(long long)n * s.side_sn + (long long)sr * s.side_sh
                      + (long long)sc * s.side_sw + ch0 + o];
      v = add32(round_shift(a, s.shift), round_shift(b, s.s_side));
      if (s.relu) v = max(v, 0);
      v = clamp8(v);
    }
    put(p, s, pl, dst, rc * s.ps + o, n, j, jw, r, c, ch0 + o, v);
  }
}

// cp.async of the block's rows of conv stage i's packed weights into wsm.
__device__ void stage_panel(const ChainParams& p, int i, int k,
                            int8_t* wsm) {
  const Stage& s = p.st[i];
  const int ch0 = s.sliced ? k * p.h.toc : 0;
  const int nt = conv_nt(s.cout);
  const int rows = (s.cout + 8 * nt - 1) / (8 * nt) * 8 * nt;
  const int cpr = s.kp / 16, kpr = s.kp + 16;
  const int8_t* w = p.w[i] + (long long)ch0 * s.kp;
  for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, c = e - r * cpr;
    hcp16(hsmem(wsm + r * kpr + 16 * c), w + (long long)r * s.kp + 16 * c,
          true);
  }
}

__global__ void __launch_bounds__(THREADS)
chain_kernel(const __grid_constant__ ChainParams p) {
  extern __shared__ __align__(16) int8_t smem[];
  const Header& h = p.h;
  // the two window buffers and the two weight panel buffers, picked by
  // selects rather than indexed arrays (which would live in local memory)
  int8_t* const buf_a = smem;
  int8_t* const buf_b = smem + h.buf_b;
  int8_t* const w_even = smem + h.w_off;
  int8_t* const w_odd = smem + h.w1_off;
  int* koff = reinterpret_cast<int*>(smem + h.koff);
  int bid = blockIdx.x;
  const int k = bid % h.n_k;
  bid /= h.n_k;
  const int jw = bid % h.n_w;
  bid /= h.n_w;
  const int j = bid % h.n_h;
  const int n = bid / h.n_h;

  // the first conv's weights load while the window does
  int next_conv = 0;
  while (next_conv < h.n_stages && p.st[next_conv].type != 0) ++next_conv;
  if (next_conv < h.n_stages && !((h.global_b >> next_conv) & 1))
    stage_panel(p, next_conv, k, w_even);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // padded position of the input window's (0, 0)
  const int in_r = h.in_or >= 0 ? h.in_or : j * h.f_in;
  const int in_c = h.in_oc >= 0 ? h.in_oc : jw * h.fw_in;
  {  // halo'd input window -> buffer A, pixel stride in_ps
    const int ch0 = h.in_sliced ? k * h.toc : 0;
    const int8_t* xn = p.x + (long long)n * h.x_sn + ch0;
    const int px = h.in_rows * h.in_cols;
    const uintptr_t al = reinterpret_cast<uintptr_t>(xn) | h.x_sh | h.x_sw
                         | h.in_c | h.in_ps;
    // words of 16 or 4 bytes where channels, strides and pointer allow
    const int wb = (al & 15) == 0 ? 16 : ((al & 3) == 0 ? 4 : 1);
    const int per = h.in_c / wb;
    for (int idx = threadIdx.x; idx < px * per; idx += THREADS) {
      const int pix = idx / per, cw = (idx - pix * per) * wb;
      const int c = pix % h.in_cols, r = pix / h.in_cols;
      const int xr = in_r + r - h.q_in0;
      const int xc = in_c + c - h.q_in1;
      const bool in = xr >= 0 && xr < h.H && xc >= 0 && xc < h.W;
      const int8_t* sp = xn + (long long)xr * h.x_sh + (long long)xc * h.x_sw
                         + cw;
      int8_t* dp = buf_a + pix * h.in_ps + cw;
      if (wb == 16) {
        const uint32_t f = (uint8_t)h.fill0 * 0x01010101u;
        *reinterpret_cast<uint4*>(dp) =
            in ? *reinterpret_cast<const uint4*>(sp) : make_uint4(f, f, f, f);
      } else if (wb == 4) {
        *reinterpret_cast<uint32_t*>(dp) =
            in ? *reinterpret_cast<const uint32_t*>(sp)
               : (uint8_t)h.fill0 * 0x01010101u;
      } else {
        *dp = in ? *sp : (int8_t)h.fill0;
      }
    }
  }

  int src_buf = 0;
  Place pl;
  pl.src_rows = h.in_rows;
  pl.src_cols = h.in_cols;
  pl.ps_in = h.in_ps;
  pl.out_r = in_r;
  pl.out_c = in_c;
  int conv_i = 0;
  for (int i = 0; i < h.n_stages; ++i) {
    const Stage& s = p.st[i];
    {  // this stage's output window: cut, or the tile's own (the last's)
      const int out_r = s.or0 >= 0 ? s.or0 : j * s.fout;
      const int out_c = s.oc0 >= 0 ? s.oc0 : jw * s.foutw;
      pl.dr = out_r * s.sh - pl.out_r;   // pl.out_* is still the input's
      pl.dc = out_c * s.sw - pl.out_c;
      pl.out_r = out_r;
      pl.out_c = out_c;
    }
    const int8_t* src = src_buf ? buf_b : buf_a;
    int8_t* dst = s.out_buf == 2 ? nullptr : (s.out_buf ? buf_b : buf_a);
    if (s.type == 0) {
      // issue the next conv's panel, then wait for this one's
      next_conv = i + 1;
      while (next_conv < h.n_stages && p.st[next_conv].type != 0) ++next_conv;
      if (next_conv < h.n_stages) {
        if (!((h.global_b >> next_conv) & 1))
          stage_panel(p, next_conv, k, (conv_i & 1) ? w_even : w_odd);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      // K-group offsets in the window: (tap row, tap column, channel)
      const int cinp = (s.cin + 3) & ~3;
      const int kreal = s.kh * s.kw * cinp;
      for (int e = threadIdx.x; e < s.kp / 4; e += THREADS) {
        int off = 0;
        if (4 * e < kreal) {
          const int tap = 4 * e / cinp, ic = 4 * e - tap * cinp;
          const int ki = tap / s.kw, kj = tap - ki * s.kw;
          off = (ki * s.dh * pl.src_cols + kj * s.dw) * pl.ps_in + ic;
        }
        koff[e] = off;
      }
    }
    __syncthreads();   // window, panel and table ready
    if (s.type == 0) {
      const int8_t* wsm = (conv_i & 1) ? w_odd : w_even;
      const int sel = conv_nt(s.cout) + 8 * ((h.global_b >> i) & 1);
      switch (sel) {
#define CONV_CASE(NT_, GB_)                                                \
  case NT_ + 8 * (int)GB_:                                                 \
    conv_stage_mma<NT_, GB_>(p, i, s, pl, src, dst, wsm, koff, k, j, jw,  \
                             n);                                           \
    break;
        CONV_CASE(4, false) CONV_CASE(2, false) CONV_CASE(1, false)
        CONV_CASE(4, true) CONV_CASE(2, true) CONV_CASE(1, true)
#undef CONV_CASE
      }
      ++conv_i;
    } else {
      stage_scalar(p, i, s, pl, src, dst, k, j, jw, n);
    }
    __syncthreads();
    src_buf = s.out_buf;
    pl.src_rows = s.rows;
    pl.src_cols = s.cols;
    pl.ps_in = s.ps;
  }
}

// ------------------------------------------------------------- horizontal
// horizontal_mma_kernel: sibling convs over OC-stacked weights as one
// implicit GEMM (M = output pixels, K = KH*KW*IC, N = sum of OC) on the
// int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32.  The weights come
// packed once by the launcher (ops.pack_horizontal): OC-major, K
// contiguous, K padded to HBK and OC to HBN with zeros, bias/shift/ReLU
// padded to match, so B tiles are whole 16-byte rows.  A block of 4 warps
// (2 x 2) computes a BM x 64 output tile (BM = 64 or 32) over its share of
// K: K steps of 64 staged three deep in shared memory by cp.async, rows of
// 16-byte chunks swizzled by (chunk ^ (row / 2) % 4) so that ldmatrix reads
// no bank twice.  Where IC is a multiple of 16 and x 16-byte aligned (every
// GoogLeNet launch) an A row is 16-byte cp.async copies of the NHWC input,
// the pixel's (n, iy, ix) computed once per row and zero-fill standing for
// padding and ragged M and K; any other shape gathers A byte by byte.
// With split > 1, blockIdx.z takes a slice of the K steps, adds its int32
// partial tile into a zeroed scratch with atomicAdd, and the last block of
// each tile (a counter beside the scratch) applies the epilogue; integer
// sums are exact in any order, so the result is bit-exact.
#define HBK 64          // K bytes per step
#define HBN 64          // output channels per tile
#define HSTAGES 3
#define HTHREADS 128

struct HorizontalParams {
  int N, H, W, IC, x_sn, x_sh, x_sw, KH, KW, SH, SW, PH, PW, OH, OW, OC;
  int Kp, Np, split;
  const int8_t* x;
  const int8_t* w;      // (Np, Kp): packed, OC-major, K contiguous
  const int32_t* b;     // (Np,) each
  const int32_t* shift;
  const int32_t* relu;
  int8_t* out;
  int32_t* scratch;     // split > 1: (M, Np) partial sums, then counters
};

// byte offset of 16-byte chunk c of row r in a [rows][HBK] tile
__device__ __forceinline__ int hswz(int r, int c) {
  return r * HBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// MT: 16-row MMA tiles per warp (BM = 32 MT); VEC: 16-byte A copies
template <int MT, bool VEC>
__global__ void __launch_bounds__(HTHREADS)
horizontal_mma_kernel(const __grid_constant__ HorizontalParams p) {
  constexpr int BM = 32 * MT;
  __shared__ __align__(128) int8_t As[HSTAGES][BM * HBK];
  __shared__ __align__(128) int8_t Bs[HSTAGES][HBN * HBK];
  __shared__ int last_block;
  const int M = p.N * p.OH * p.OW;
  const int K = p.KH * p.KW * p.IC;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * HBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_steps = p.Kp / HBK / p.split;
  const int kb0 = blockIdx.z * n_steps;

  // A rows this thread copies (VEC): row tid / 4 (+ 32), chunk tid % 4
  int a_n[MT], a_iy[MT], a_ix[MT];
  bool a_ok[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + tid / 4 + 32 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int ox = mm % p.OW, t2 = mm / p.OW;
    a_n[i] = t2 / p.OH;
    a_iy[i] = (t2 % p.OH) * p.SH - p.PH;
    a_ix[i] = ox * p.SW - p.PW;
  }

  auto load = [&](int kb, int st) {
    const int k0 = kb * HBK;
    int8_t* as = As[st];
    if constexpr (VEC) {
      const int c = tid & 3;
      const int k = k0 + 16 * c;
      const int t = k / p.IC, ic = k - t * p.IC;
      const int kj = t % p.KW, ki = t / p.KW;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = tid / 4 + 32 * i;
        const int iy = a_iy[i] + ki, ix = a_ix[i] + kj;
        const bool ok = a_ok[i] && k < K && iy >= 0 && iy < p.H && ix >= 0
                        && ix < p.W;
        const int8_t* src = ok ? p.x + (long long)a_n[i] * p.x_sn
                                     + (long long)iy * p.x_sh
                                     + (long long)ix * p.x_sw + ic
                               : p.x;
        hcp16(hsmem(as + hswz(r, c)), src, ok);
      }
    } else {
      for (int e = tid; e < BM * HBK; e += HTHREADS) {
        const int r = e / HBK, kk = e % HBK;
        const int m = m0 + r, k = k0 + kk;
        int8_t v = 0;
        if (m < M && k < K) {
          const int ic = k % p.IC, t = k / p.IC;
          const int kj = t % p.KW, ki = t / p.KW;
          const int ox = m % p.OW, t2 = m / p.OW;
          const int oy = t2 % p.OH, nn = t2 / p.OH;
          const int iy = oy * p.SH - p.PH + ki, ix = ox * p.SW - p.PW + kj;
          if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
            v = p.x[(long long)nn * p.x_sn + (long long)iy * p.x_sh
                    + (long long)ix * p.x_sw + ic];
        }
        as[hswz(r, kk >> 4) + (kk & 15)] = v;
      }
    }
    int8_t* bs = Bs[st];
    for (int i = tid; i < HBN * HBK / 16; i += HTHREADS) {
      const int r = i >> 2, c = i & 3;
      hcp16(hsmem(bs + hswz(r, c)),
            p.w + (long long)(n0 + r) * p.Kp + k0 + 16 * c, true);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < HSTAGES - 1; ++s) {
    if (s < n_steps) load(kb0 + s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < n_steps; ++it) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(HSTAGES - 2) : "memory");
    __syncthreads();
    if (it + HSTAGES - 1 < n_steps)
      load(kb0 + it + HSTAGES - 1, (it + HSTAGES - 1) % HSTAGES);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int st = it % HSTAGES;
    const uint32_t a_base = hsmem(As[st]), b_base = hsmem(Bs[st]);
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {              // two K halves of 32
      uint32_t af[MT][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * 16 * MT + i * 16 + (lane & 7)
                      + ((lane >> 3) & 1) * 8;
        hldsm_x4(af[i], a_base + hswz(r, 2 * kh + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3);
        hldsm_x4(bf[j], b_base + hswz(r, 2 * kh + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][2 * (j & 1)],
                 bf[j >> 1][2 * (j & 1) + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  if (p.split > 1) {
    // partial sums into the scratch; the tile's last block finishes it
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * 16 * MT + i * 16 + gq + 8 * (e >> 1);
          const int col = n0 + wn * 32 + j * 8 + 2 * tq + (e & 1);
          if (m < M) atomicAdd(p.scratch + (long long)m * p.Np + col,
                               acc[i][j][e]);
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counter = p.scratch + (long long)M * p.Np
                     + blockIdx.y * gridDim.x + blockIdx.x;
      last_block = atomicAdd(counter, 1) == p.split - 1;
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * 16 * MT + i * 16 + gq + 8 * (e >> 1);
          const int col = n0 + wn * 32 + j * 8 + 2 * tq + (e & 1);
          if (m < M)
            acc[i][j][e] = __ldcg(p.scratch + (long long)m * p.Np + col);
        }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 16 * MT + i * 16 + gq + 8 * (e >> 1);
        const int col = n0 + wn * 32 + j * 8 + 2 * tq + (e & 1);
        if (m >= M || col >= p.OC) continue;
        int v = round_shift(add32(acc[i][j][e], p.b[col]), p.shift[col]);
        if (p.relu[col]) v = max(v, 0);
        p.out[(long long)m * p.OC + col] = (int8_t)clamp8(v);
      }
}

// ------------------------------------------------------------- C interface
#define BAD_DESCRIPTOR (-1)

extern "C" int repro_fused_chain(const int32_t* desc, int n_desc,
                                 const int64_t* ptrs, int n_blocks, int smem,
                                 void* stream) {
  ChainParams p;
  memset(&p, 0, sizeof(p));
  if (n_desc < HDR) return BAD_DESCRIPTOR;
  memcpy(&p.h, desc, HDR * sizeof(int32_t));
  const int m = p.h.n_stages;
  if (m < 1 || m > MAX_STAGES || n_desc != HDR + STG * m)
    return BAD_DESCRIPTOR;
  memcpy(p.st, desc + HDR, (size_t)STG * m * sizeof(int32_t));
  p.x = reinterpret_cast<const int8_t*>(ptrs[0]);
  p.out = reinterpret_cast<int8_t*>(ptrs[1]);
  for (int i = 0; i < MAX_STAGES; ++i) {
    p.w[i] = reinterpret_cast<const int8_t*>(ptrs[2 + 3 * i]);
    p.b[i] = reinterpret_cast<const int32_t*>(ptrs[3 + 3 * i]);
    p.side[i] = reinterpret_cast<const int8_t*>(ptrs[4 + 3 * i]);
  }
  if (n_blocks <= 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_kernel<<<n_blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims (int32): N, H, W, IC, the x strides (n, h, w), KH, KW, SH, SW, PH,
// PW, OH, OW, OC, then the packed weights' Kp and Np, the split of the K
// steps, the tile rows BM (32 or 64) and whether A rows are 16-byte copies
// (ops.horizontal_plan).  ptrs: x, packed w, b, shift, relu, out, scratch
// (split > 1: M * Np partial sums and one counter per tile, zeroed).
extern "C" int repro_fused_horizontal(const int32_t* dims, const int64_t* ptrs,
                                      void* stream) {
  HorizontalParams p;
  memcpy(&p, dims, 19 * sizeof(int32_t));
  const int bm = dims[19], vec = dims[20];
  p.x = reinterpret_cast<const int8_t*>(ptrs[0]);
  p.w = reinterpret_cast<const int8_t*>(ptrs[1]);
  p.b = reinterpret_cast<const int32_t*>(ptrs[2]);
  p.shift = reinterpret_cast<const int32_t*>(ptrs[3]);
  p.relu = reinterpret_cast<const int32_t*>(ptrs[4]);
  p.out = reinterpret_cast<int8_t*>(ptrs[5]);
  p.scratch = reinterpret_cast<int32_t*>(ptrs[6]);
  const int M = p.N * p.OH * p.OW;
  if (M <= 0 || p.OC <= 0) return 0;
  if ((bm != 32 && bm != 64) || p.split < 1 || p.Kp % HBK || p.Np % HBN
      || (p.Kp / HBK) % p.split || p.Np < p.OC
      || p.Kp < p.KH * p.KW * p.IC || (p.split > 1 && !p.scratch))
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + bm - 1) / bm, p.Np / HBN, p.split);
  cudaStream_t st = (cudaStream_t)stream;
  if (bm == 64) {
    if (vec) horizontal_mma_kernel<2, true><<<grid, HTHREADS, 0, st>>>(p);
    else horizontal_mma_kernel<2, false><<<grid, HTHREADS, 0, st>>>(p);
  } else {
    if (vec) horizontal_mma_kernel<1, true><<<grid, HTHREADS, 0, st>>>(p);
    else horizontal_mma_kernel<1, false><<<grid, HTHREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int rc) {
  if (rc == BAD_DESCRIPTOR) return "bad chain descriptor";
  return cudaGetErrorString((cudaError_t)rc);
}
