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
// m16n8k32 s8 x s8 -> s32): M = the stage's output pixels over the block's
// images, N = its output channels (the block's OC tile from the last conv
// on), K = kh * kw * cin.  The launcher packs each conv's weights once
// (ops.pack_chain_weights): OC-major, K contiguous in (kh, kw, ic) order
// with ic padded to a multiple of 4, K padded to 32 with zeros.  A fragments
// are 4-byte loads from the int8 window itself: a table of each K group's
// offset in the window (tap row, tap column, input channel) is built once
// per stage, so an A register is one load at pixel offset + table entry.
// Windows keep a pixel stride of the channels rounded up to 4 (plus 16
// bytes where that stride is a multiple of 32 words, which would put the 8
// pixel rows of a fragment in one bank); the bytes past the channels are
// never written and meet only zero weights.  conv1's 3-channel input takes
// the same path with its pixels padded to 4 channels.
//
// A block takes ni images of the batch at one spatial tile (the last group
// ragged), each image's windows one after the other in each buffer, so that
// M spans the images.  The B operand reaches the tensor cores on one of two
// paths, chosen by the planner from the shapes alone (ops._layout): a panel
// that fits beside the windows is staged whole, the next conv's panel
// loading by cp.async while this stage computes, and warps take (16-pixel,
// 8 * NT-channel) items in turn, NT = 4, 2 or 1 by the stage's channels,
// reading B with ldmatrix from rows padded to an odd number of 16-byte
// chunks (no bank conflicts).  A panel that does not fit (bit i of ring_b)
// streams through a ring of RING_SLOTS slots in shared memory, each
// ring_ks bytes of K (128, or 64 where the windows leave less room) of up
// to RING_ROWS weight rows: the stage runs as passes of a block-wide tile
// (128 pixels x 128 channels, or 256 x 64 for 64 channels or fewer; each
// warp 32 x 64) over the stage's full K.  Every thread copies its share of
// a slot RING_AHEAD steps ahead with 16-byte cp.async and arrives on the
// slot's "full" mbarrier when its copies land (cp.async.mbarrier.arrive);
// each warp releases a slot on its "empty" mbarrier once its ldmatrix reads
// are done; inside a step the next K step's fragments load while this
// one's MMAs issue.  Each fetched weight byte so feeds a pass's pixels
// (across the block's images), where a per-MMA load from device memory fed
// one 16-pixel tile.  (One producer issuing cp.async.bulk copies a row at
// a time measured about 6 us a slot, most likely the copy engine taking
// the 128 small copies in turn; so every thread copies.)  The epilogue, the
// pool and eltwise stages and the window's pad-identity masking are those
// of the reference; the input window is loaded in 16- or 4-byte words where
// channels and strides allow.
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
// 132 SMs (ops.choose_chain_tile).  At batch 64 (VGG16-224 served) the
// chains do about 1 T int8 MACs a batch, so the card's bound is operations
// (about 1 ms).  What paced them was the weight operand of the convs whose
// panels do not fit in shared memory, fetched from device memory once per
// 16-pixel tile (2.4 to 3.4 TB/s, about 80 GB a batch).  The ring and
// blocks of ni images make each fetched byte feed a pass's pixels (about
// 11 GB a batch for VGG16's items 1-7), and the planner charges each
// block's fetched weight bytes when it picks (th, tw, toc, ni).  What bounds
// each path now: the staged path, its warps' latency (few K steps an item,
// an epilogue per output); the ring, the L2's stream of weight rows to the
// blocks (about 2 TB/s measured with no MMA at all) and the MMA issue of
// eight warps a block, which the stream overlaps in part.
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
#define HDR 37
#define STG 34
#define THREADS 256
#define WARPS (THREADS / 32)

// The weight ring (ops.RING_*): RING_SLOTS slots of ring_ks bytes of K
// (the header's: 128, or 64 where the windows leave less room) of up to
// RING_ROWS weight rows, rows ring_ks + 16 bytes apart (an odd number of
// 16-byte chunks, so ldmatrix reads no bank twice), filled RING_AHEAD slots
// ahead of the consumers; a full and an empty mbarrier per slot follow the
// slots.
#define RING_KS_MAX 128
#define RING_SLOTS 4
#define RING_AHEAD 2
#define RING_ROWS 128
#define RING_NT 8        // n8 tiles of a warp's 32 x 64 tile

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
  int ring_b;   // bit i: conv stage i streams its weights through the ring
  int in_or, in_oc;  // origin of a cut input window (-1: the tile's own)
  int ni;       // images a block takes (the last group may hold fewer)
  int ring_off; // shared offset of the ring's slots, then its mbarriers
  int ring_ks;  // K bytes of a ring slot
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
// a 4-byte load from a window, which no thread writes while it is read:
// not volatile, so the compiler may schedule it ahead of the MMAs
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
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
// an arrival on the mbarrier bar once this thread's cp.async copies so far
// have landed (counted against the arrivals the barrier was set up with)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// The warp waits for barrier bar's phase of the given parity to complete:
// lane 0 polls, the others follow it past __syncwarp.
__device__ __forceinline__ void warp_wait(uint32_t bar, uint32_t parity) {
  if ((threadIdx.x & 31) == 0) mbar_wait(bar, parity);
  __syncwarp();
}

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
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

// The block's images and where their windows sit: image g's input window
// of a stage at src + g * src_img, its output window at dst + g * dst_img.
struct Images {
  int n0, count;
  int src_img, dst_img;
};

// Writes one stage output value of image n: to the output tensor for the
// last stage (inside (OH, OW) only), else to the image's next window,
// masked to the next stage's pad identity outside this stage's true extent.
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

// Where conv output pixel m (over the block's images) goes: its image's
// output window (dst for the last stage), its offset there, image, row and
// column.
struct Out {
  int8_t* dst;
  int idx, n, r, c;
};

__device__ __forceinline__ Out out_pixel(const Stage& s, int8_t* dst,
                                         const Images& im, int m) {
  int g = 0;
  if (im.count > 1) {
    const int rc = s.rows * s.cols;
    g = m / rc;
    m -= g * rc;
  }
  Out o;
  o.dst = s.out_buf == 2 ? dst : dst + g * im.dst_img;
  o.idx = m * s.ps;
  o.n = im.n0 + g;
  o.r = m / s.cols;
  o.c = m - o.r * s.cols;
  return o;
}

// The epilogue of one conv output: bias, shift, ReLU and saturation of
// accumulator acc at pixel o and channel col.
__device__ __forceinline__ void conv_out(const ChainParams& p, const Stage& s,
                                         const Place& pl, const Out& o,
                                         const int32_t* bias, int ch0, int j,
                                         int jw, int col, int acc) {
  int v = round_shift(add32(acc, bias[col]), s.shift);
  if (s.relu) v = max(v, 0);
  put(p, s, pl, o.dst, o.idx + col, o.n, j, jw, o.r, o.c, ch0 + col,
      clamp8(v));
}

// The window address pixel m (over the block's images, clamped to the
// last) reads at tap (0, 0).
__device__ __forceinline__ const int8_t* pixel(const Stage& s,
                                               const Place& pl,
                                               const int8_t* src,
                                               const Images& im, int m) {
  const int rc = s.rows * s.cols;
  m = min(m, im.count * rc - 1);
  if (im.count > 1) {
    const int g = m / rc;
    m -= g * rc;
    src += g * im.src_img;
  }
  const int r = m / s.cols;
  return tap0(s, pl, src, r, m - r * s.cols);
}

// Output channels a warp item of a staged conv stage covers, in n8 tiles.
__host__ __device__ __forceinline__ int conv_nt(int cout) {
  return cout >= 32 ? 4 : (cout > 8 ? 2 : 1);
}

// A conv stage whose panel is staged: wsm holds the block's rows of the
// packed weights (rows of kp + 16 bytes); koff holds each K group's byte
// offset in the source window.
template <int NT>
__device__ void conv_stage_mma(const ChainParams& p, int i, const Stage& s,
                               const Place& pl, const int8_t* src,
                               int8_t* dst, const Images& im,
                               const int8_t* wsm, const int* koff, int k,
                               int j, int jw) {
  const int ch0 = s.sliced ? k * p.h.toc : 0;
  const int M = im.count * s.rows * s.cols;
  const int mt = (M + 15) / 16;
  const int items = mt * ((s.cout + 8 * NT - 1) / (8 * NT));
  const int kpr = s.kp + 16, ksteps = s.kp / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t wbase = hsmem(wsm);
  const int32_t* bias = p.b[i] + ch0;
  for (int item = warp; item < items; item += WARPS) {
    const int m0 = (item % mt) * 16, n0 = (item / mt) * 8 * NT;
    const int8_t* px[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      px[hh] = pixel(s, pl, src, im, m0 + g + 8 * hh);
    int acc[NT][4];
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0;
    uint32_t baddr;
    if constexpr (NT >= 2)
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
      if constexpr (NT >= 2) {
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
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + g + 8 * hh;
      if (m >= M) continue;
      const Out o = out_pixel(s, dst, im, m);
#pragma unroll
      for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * a + 2 * t + e;
          if (col < s.cout)
            conv_out(p, s, pl, o, bias, ch0, j, jw, col, acc[a][2 * hh + e]);
        }
    }
  }
}

// The ring: the shared addresses of slot 0 and of the mbarriers (full[s],
// then empty[s]), and the ring steps the block has taken so far (the same
// in every thread), from which each step's slot and phase follow.
struct Ring {
  uint32_t slots, bars;
  int ks, rs, slot_bytes;   // K bytes a slot, row stride, slot stride
  unsigned q;
};

// How a ring stage runs at this block's images: passes of a BM x BN tile
// (MP along the pixels inside NP along the channels), each over the S
// K slices of the stage; T = MP * NP * S ring steps in all.  The tile is
// 128 x 128, or 256 x 64 for 64 channels or fewer: WM warps along the
// pixels, each computing 32 pixels x 64 channels.  A block takes the K
// slices from slice rot on (rot = the block's index mod S), so that the
// blocks on the card do not all ask the L2 for the same weight rows at
// once (integer sums are exact in any order).
struct RingPlan {
  int bn, wm, mp, np, s, t, rot;
};

__device__ __forceinline__ RingPlan ring_plan(const Stage& s, int count,
                                              int ks) {
  RingPlan rp;
  rp.bn = s.cout > 8 * RING_NT ? RING_ROWS : 8 * RING_NT;
  rp.wm = WARPS / (rp.bn / (8 * RING_NT));
  const int M = count * s.rows * s.cols;
  rp.mp = (M + 32 * rp.wm - 1) / (32 * rp.wm);
  rp.np = (s.cout + rp.bn - 1) / rp.bn;
  rp.s = (s.kp + ks - 1) / ks;
  rp.t = rp.mp * rp.np * rp.s;
  rp.rot = blockIdx.x % rp.s;
  return rp;
}

// Every thread issues its share of ring step q, step u of conv stage i
// (K slice u % S of the weight rows of pass u / S), as 16-byte cp.async
// copies, and arrives on the slot's full barrier once they have landed;
// first the warp waits until every warp has released the step that used
// the slot before (RING_SLOTS steps earlier).
__device__ __forceinline__ void ring_issue(const ChainParams& p, int i,
                                           const Stage& s, const RingPlan& rp,
                                           const Ring& rg, unsigned q, int u,
                                           int ch0) {
  const int slot = q % RING_SLOTS;
  if (q >= RING_SLOTS)
    warp_wait(rg.bars + 8 * (RING_SLOTS + slot), (q / RING_SLOTS - 1) & 1);
  const int pass = u / rp.s;
  int sl = u - pass * rp.s + rp.rot;
  sl -= sl >= rp.s ? rp.s : 0;
  const int row0 = (pass / rp.mp) * rp.bn;
  const int rows = min(rp.bn, s.cout - row0);
  const int cpr = min(rg.ks, s.kp - sl * rg.ks) / 16;   // chunks a row
  const int8_t* w = p.w[i] + (long long)(ch0 + row0) * s.kp + sl * rg.ks;
  const uint32_t dst = rg.slots + slot * rg.slot_bytes;
  for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, c = e - r * cpr;
    hcp16(dst + r * rg.rs + 16 * c, w + (long long)r * s.kp + 16 * c, true);
  }
  cp_async_arrive(rg.bars + 8 * slot);
}

// One K step of 32 of a ring stage's warp tile: A words of its 32 pixels
// (K groups o0 and o1 of the window table) and B fragments of its
// 8 * RING_NT channels from the slot (ldmatrix at sb).
struct Frag {
  uint32_t a[2][4];
  uint32_t b[RING_NT / 2][4];
};

__device__ __forceinline__ void ring_frag(Frag& f, const uint32_t (&pa)[2][2],
                                          int o0, int o1, uint32_t sb,
                                          int rs) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    f.a[mt][0] = lds32(pa[mt][0] + o0);
    f.a[mt][1] = lds32(pa[mt][1] + o0);
    f.a[mt][2] = lds32(pa[mt][0] + o1);
    f.a[mt][3] = lds32(pa[mt][1] + o1);
  }
#pragma unroll
  for (int b2 = 0; b2 < RING_NT / 2; ++b2)
    hldsm_x4(f.b[b2], sb + b2 * 16 * rs);
}

// A conv stage whose panel streams through the ring (its first RING_AHEAD
// steps already issued).  Warp (wm, wn) of a pass computes pixels
// [mb * BM + 32 wm, + 32) and channels [nb * BN + 64 wn, + 64); a warp
// whose pixels or channels lie past the stage's only fills and releases.
// Inside a step the next K step's fragments load while this one's MMAs
// issue.
__device__ void conv_stage_ring(const ChainParams& p, int i, const Stage& s,
                                const Place& pl, const int8_t* src,
                                int8_t* dst, const Images& im,
                                const int* koff, Ring& rg, int k, int j,
                                int jw) {
  const int ch0 = s.sliced ? k * p.h.toc : 0;
  const RingPlan rp = ring_plan(s, im.count, rg.ks);
  const int M = im.count * s.rows * s.cols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % rp.wm, wn = warp / rp.wm;
  const int32_t* bias = p.b[i] + ch0;
  const uint32_t brow = (wn * 8 * RING_NT + (lane & 7) + ((lane >> 4) << 3))
                        * rg.rs + ((lane >> 3) & 1) * 16;
  const unsigned q0 = rg.q;
  int u = 0;
  for (int pass = 0; pass < rp.mp * rp.np; ++pass) {
    const int nb = pass / rp.mp, mb = pass - nb * rp.mp;
    const int m_w = mb * 32 * rp.wm + 32 * wm;
    const int n_w = nb * rp.bn + 8 * RING_NT * wn;
    const bool active = m_w < M && n_w < s.cout;
    uint32_t pa[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pa[mt][hh] = hsmem(pixel(s, pl, src, im, m_w + 16 * mt + g + 8 * hh));
    int acc[2][RING_NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int a = 0; a < RING_NT; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][a][e] = 0;
    for (int s0 = 0; s0 < rp.s; ++s0, ++u) {
      const int sl = s0 + rp.rot - (s0 + rp.rot >= rp.s ? rp.s : 0);
      const unsigned q = q0 + u;
      if (u + RING_AHEAD < rp.t)
        ring_issue(p, i, s, rp, rg, q + RING_AHEAD, u + RING_AHEAD, ch0);
      const int slot = q % RING_SLOTS;
      warp_wait(rg.bars + 8 * slot, (q / RING_SLOTS) & 1);
      if (active) {
        const int kb = min(rg.ks, s.kp - sl * rg.ks) / 32;
        const uint32_t sb = rg.slots + slot * rg.slot_bytes + brow;
        const int* ko = koff + sl * (rg.ks / 4) + t;   // K groups
        Frag f[2];
        ring_frag(f[0], pa, ko[0], ko[4], sb, rg.rs);
#pragma unroll
        for (int kk = 0; kk < RING_KS_MAX / 32; ++kk) {
          if (kk >= kb) break;
          if (kk + 1 < kb)
            ring_frag(f[(kk + 1) & 1], pa, ko[8 * (kk + 1)],
                      ko[8 * (kk + 1) + 4], sb + 32 * (kk + 1), rg.rs);
          const Frag& c = f[kk & 1];
#pragma unroll
          for (int b2 = 0; b2 < RING_NT / 2; ++b2)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_s8(acc[mt][2 * b2], c.a[mt], c.b[b2][0], c.b[b2][1]);
              mma_s8(acc[mt][2 * b2 + 1], c.a[mt], c.b[b2][2], c.b[b2][3]);
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(rg.bars + 8 * (RING_SLOTS + slot));
    }
    if (!active) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m_w + 16 * mt + g + 8 * hh;
        if (m >= M) continue;
        const Out o = out_pixel(s, dst, im, m);
#pragma unroll
        for (int a = 0; a < RING_NT; ++a)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n_w + 8 * a + 2 * t + e;
            if (col < s.cout)
              conv_out(p, s, pl, o, bias, ch0, j, jw, col,
                       acc[mt][a][2 * hh + e]);
          }
      }
  }
  rg.q = q0 + rp.t;
}

// A pool or eltwise stage, one output value per thread.
__device__ void stage_scalar(const ChainParams& p, int i, const Stage& s,
                             const Place& pl, const int8_t* src, int8_t* dst,
                             const Images& im, int k, int j, int jw) {
  const int src_cols = pl.src_cols, ps_in = pl.ps_in;
  const int ch0 = s.sliced ? k * p.h.toc : 0;
  const int per = s.rows * s.cols * s.cout;
  for (int g = 0; g < im.count; ++g)
  for (int idx = threadIdx.x; idx < per; idx += THREADS) {
    const int o = idx % s.cout;
    const int rc = idx / s.cout;
    const int c = rc % s.cols;
    const int r = rc / s.cols;
    const int8_t* sg = src + g * im.src_img;
    const int n = im.n0 + g;
    int v;
    if (s.type == 1) {  // pool: channelwise, cin == cout
      const int8_t* sp = tap0(s, pl, sg, r, c) + o;
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
      const int a = tap0(s, pl, sg, r, c)[o];
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
    put(p, s, pl, dst + (s.out_buf == 2 ? 0 : g * im.dst_img), rc * s.ps + o,
        n, j, jw, r, c, ch0 + o, v);
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

// RING: the launch has ring stages (ring_b set).  Without, the ring's code
// and registers stay out of the kernel, so that four blocks fit an SM.
template <bool RING>
__global__ void __launch_bounds__(THREADS, RING ? 2 : 4)
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
  Ring rg;
  rg.ks = h.ring_ks;
  rg.rs = rg.ks + 16;
  rg.slot_bytes = RING_ROWS * rg.rs;
  rg.slots = hsmem(smem + h.ring_off);
  rg.bars = rg.slots + RING_SLOTS * rg.slot_bytes;
  rg.q = 0;
  int bid = blockIdx.x;
  const int k = bid % h.n_k;
  bid /= h.n_k;
  const int jw = bid % h.n_w;
  bid /= h.n_w;
  const int j = bid % h.n_h;
  Images im;
  im.n0 = (bid / h.n_h) * h.ni;
  im.count = min(h.ni, h.N - im.n0);

  if (RING && threadIdx.x == 0) {
    for (int s = 0; s < RING_SLOTS; ++s) {
      mbar_init(rg.bars + 8 * s, THREADS);    // full: each thread's copies
      mbar_init(rg.bars + 8 * (RING_SLOTS + s), WARPS);   // empty: each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first conv's weights load while the window does
  int next_conv = 0;
  while (next_conv < h.n_stages && p.st[next_conv].type != 0) ++next_conv;
  if (next_conv < h.n_stages && !((h.ring_b >> next_conv) & 1))
    stage_panel(p, next_conv, k, w_even);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // padded position of the input window's (0, 0)
  const int in_r = h.in_or >= 0 ? h.in_or : j * h.f_in;
  const int in_c = h.in_oc >= 0 ? h.in_oc : jw * h.fw_in;
  const int in_img = align16(h.in_rows * h.in_cols * h.in_ps);
  {  // halo'd input windows of the block's images -> buffer A
    const int ch0 = h.in_sliced ? k * h.toc : 0;
    const int8_t* x0 = p.x + (long long)im.n0 * h.x_sn + ch0;
    const int px = h.in_rows * h.in_cols;
    const uintptr_t al = reinterpret_cast<uintptr_t>(x0) | h.x_sn | h.x_sh
                         | h.x_sw | h.in_c | h.in_ps;
    // words of 16 or 4 bytes where channels, strides and pointer allow
    const int wb = (al & 15) == 0 ? 16 : ((al & 3) == 0 ? 4 : 1);
    const int per = h.in_c / wb;
    for (int g = 0; g < im.count; ++g)
    for (int idx = threadIdx.x; idx < px * per; idx += THREADS) {
      const int pix = idx / per, cw = (idx - pix * per) * wb;
      const int c = pix % h.in_cols, r = pix / h.in_cols;
      const int xr = in_r + r - h.q_in0;
      const int xc = in_c + c - h.q_in1;
      const bool in = xr >= 0 && xr < h.H && xc >= 0 && xc < h.W;
      const int8_t* sp = x0 + (long long)g * h.x_sn + (long long)xr * h.x_sh
                         + (long long)xc * h.x_sw + cw;
      int8_t* dp = buf_a + g * in_img + pix * h.in_ps + cw;
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
  __syncthreads();   // the ring's barriers initialised

  int src_buf = 0;
  Place pl;
  pl.src_rows = h.in_rows;
  pl.src_cols = h.in_cols;
  pl.ps_in = h.in_ps;
  pl.out_r = in_r;
  pl.out_c = in_c;
  im.src_img = in_img;
  int conv_i = 0;
  for (int i = 0; i < h.n_stages; ++i) {
    const Stage& s = p.st[i];
    const bool ring = (h.ring_b >> i) & 1;
    {  // this stage's output window: cut, or the tile's own (the last's)
      const int out_r = s.or0 >= 0 ? s.or0 : j * s.fout;
      const int out_c = s.oc0 >= 0 ? s.oc0 : jw * s.foutw;
      pl.dr = out_r * s.sh - pl.out_r;   // pl.out_* is still the input's
      pl.dc = out_c * s.sw - pl.out_c;
      pl.out_r = out_r;
      pl.out_c = out_c;
    }
    im.dst_img = align16(s.rows * s.cols * s.ps);
    const int8_t* src = src_buf ? buf_b : buf_a;
    int8_t* dst = s.out_buf == 2 ? nullptr : (s.out_buf ? buf_b : buf_a);
    if (s.type == 0) {
      // issue the next conv's panel, then wait for this one's
      next_conv = i + 1;
      while (next_conv < h.n_stages && p.st[next_conv].type != 0) ++next_conv;
      if (next_conv < h.n_stages) {
        if (!((h.ring_b >> next_conv) & 1))
          stage_panel(p, next_conv, k, (conv_i & 1) ? w_even : w_odd);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      if (RING && ring) {   // the ring's first steps
        const RingPlan rp = ring_plan(s, im.count, rg.ks);
        const int ch0 = s.sliced ? k * h.toc : 0;
        for (int u = 0; u < min(RING_AHEAD, rp.t); ++u)
          ring_issue(p, i, s, rp, rg, rg.q + u, u, ch0);
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
      if (RING && ring) {
        conv_stage_ring(p, i, s, pl, src, dst, im, koff, rg, k, j, jw);
      } else {
        const int8_t* wsm = (conv_i & 1) ? w_odd : w_even;
        switch (conv_nt(s.cout)) {
          case 4: conv_stage_mma<4>(p, i, s, pl, src, dst, im, wsm, koff, k,
                                    j, jw); break;
          case 2: conv_stage_mma<2>(p, i, s, pl, src, dst, im, wsm, koff, k,
                                    j, jw); break;
          default: conv_stage_mma<1>(p, i, s, pl, src, dst, im, wsm, koff,
                                     k, j, jw);
        }
      }
      ++conv_i;
    } else {
      stage_scalar(p, i, s, pl, src, dst, im, k, j, jw);
    }
    __syncthreads();
    src_buf = s.out_buf;
    pl.src_rows = s.rows;
    pl.src_cols = s.cols;
    pl.ps_in = s.ps;
    im.src_img = im.dst_img;
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
  void (*kernel)(ChainParams) =
      p.h.ring_b ? chain_kernel<true> : chain_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
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
