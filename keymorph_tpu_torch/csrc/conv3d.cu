// Fused per-channel affine + 3x3x3 SAME conv + bias + ReLU (+ output stats)
// on the flat (Z, C, Y*X) layout: conv3x3_fused_flat, its parts and upconv
// forms, and the conv's input gradient, as ONE implicit GEMM on the H100's
// bf16 tensor cores (wgmma), plus an FMA kernel for the forward conv at Cin < 8;
// and the conv's weight gradient, a split-voxel wgmma product on the same
// staged halo tile (wgrad3x3_mma_kernel<TX>, below the FMA kernel). The same
// implicit GEMM serves the residual U-Nets' forward (models/fast_resunet.py)
// in two more modes: conv3x3_res_mma_kernel<NB>, a block's last conv with the
// residual sum and the ReLU after it in the epilogue, and tconv3_mma_kernel<NB>,
// the decoders' transposed 3x3x3 stride-2 conv over the zero-dilated
// half-resolution input, its skip summed in the epilogue (both at NB 32 or
// 64; see Mode). The transposed conv's backward takes two kernels of its own:
// tconv3_dgrad_mma_kernel<NB> (its input gradient, a fourth mode of the
// implicit GEMM) and tconv3_wgrad_mma_kernel<TX> (its weight gradient, the
// weight-gradient kernel over the zero-dilated input). One entry, km_conv3x3,
// launches every one of these products in the form its caller names;
// km_conv3x3_weight_grad launches the weight gradients.
//
// Replaces keymorph_tpu/ops/pallas/conv3d.py:_kernel_flat + _cell_compute
// (reached through _conv_pallas_group_flat <- _conv_pallas_flat /
// _conv_pallas_flat_parts / _conv_pallas_flat_upconv) and, for the input
// gradient, keymorph_tpu/ops/pallas/conv3d.py:_kernel (reached through
// _conv_pallas_group <- _conv_pallas <- _conv_bwd). The input is the channel
// concat [A, B] of two sources split at channel Ca, where B is absent
// (flat), at full resolution (parts), or at half resolution and read at
// (z>>1, y>>1, x>>1) (upconv: the decoder's nearest-x2 upsample + concat,
// neither materialized).
//
//   y[z, co, y, x] = relu?(bias[co] + sum_{ci, taps} W[tap, ci, co] *
//                          pad0(bf16(a[ci] * x[ci] + b[ci]))[tap-shifted])
//
// Operands are bf16 values, products are exact in fp32, sums are fp32 (taken
// by the tensor cores in their own order): the arithmetic of keymorph_tpu's
// _conv_xla up to the order of the fp32 sum. Out-of-volume taps are 0 AFTER
// the affine (pad0(a*x+b)); the affine is a separately rounded multiply and
// add, as in the plain version. The stored output is bf16. With stats, each
// block writes per-Cout partial (sum y, sum y^2) of its stored bf16 values
// to a (n_tiles, Cout, 2) buffer that the wrapper reduces: no atomics, so
// results are deterministic. The input gradient
//
//   g_u[z, ci, y, x] = sum_{co, taps} W[2-dz, 2-dy, 2-dx, ci, co] *
//                      pad0(g_v)[z+dz-1, co, y+dy-1, x+dx-1]
//
// is the same device code on the wrapper's flipped, channel-swapped weight
// pack, with no affine, bias, ReLU or stats, its channels written to two
// tensors split at Csplit (the halves of a two-source conv's gradient). The
// weight gradient
//
//   dW[tap, ci, co] = sum_{z,y,x} pad0(bf16(a*x + b))[tap-shifted, ci] *
//                     g_v[z, co, y, x]
//
// replaces no TPU kernel: keymorph_tpu's _conv_bwd computes it by 27 XLA
// einsums with fp32 sums (keymorph_tpu/ops/pallas/conv3d.py:1199-1232). Its
// design, and why:
//  * GEMM view per tap: M = 64 cotangent channels (a block of Cout, padded),
//    N = 16 input channels (one staged chunk), K = output voxels. 27 taps x
//    64 x 16 fp32 sums are 27 x 8 registers a thread of one warpgroup: a
//    block has three warpgroups of products, warpgroup dz holding the 9 taps
//    (dz, dy, dx) (72 registers), and a fourth that stages.
//  * A block walks a run of tile planes (8 x 32 or 16 x 16 output voxels
//    of one z, along z then to the next tile): each input plane is staged
//    once by stage_halo (the forward's staging: affine, bf16, pad0, the
//    upconv source at half resolution), a ring of 4 holds planes z - 1, z,
//    z + 1 and the one being staged. In its [ci/8][halo voxel][8] layout, 8
//    voxels x 8 channels are one 128-byte core matrix with the channels
//    contiguous: wgmma's B operand, MN-major (the transpose bit), and tap
//    (dy, dx) of 16 output voxels is the descriptor's start moved by
//    (ly + dy) * HX + lx + dx voxels. Warpgroup dz reads plane z - 1 + dz.
//  * The cotangent is the A operand from registers: per 16 voxels a
//    warpgroup loads its 64 x 16 fragment once (ldmatrix.x4.trans) for its 9
//    products. With both operands in shared memory a m64n16k16 product took
//    ~36 cycles (the fragments of A read anew for every tap), from registers
//    ~20. The cotangent plane is staged with 16-byte loads into a layout
//    skewed by one 16-byte unit every 8 voxels, so that the stores of a
//    phase and the 8 rows of an ldmatrix both fall on 8 distinct bank groups.
//  * The stager runs one step ahead, onto named barriers (FULL and EMPTY, two
//    of each by step parity, so that no barrier is ever two phases ahead).
//  * Split-K: the wrapper cuts the tile planes into nsplit runs, one block per
//    (run, Cout block, chunk), each writing its 27 x 16 x 64 fp32 partial
//    sums to its own slice; wgrad3x3_reduce_kernel adds the runs in order. No
//    atomics: the same inputs give the same bits.
//
// What bounds it on the H100: tensor-core operations (2*27*Cin*Cout FLOP per
// voxel against 2*(Cin+Cout) bytes), except at e0c1 (Cin = 1), which is bound
// by bytes and takes the FMA instantiation. The weight gradient has the same
// operations and is as near its bound as the products allow: wgmma's M is
// 64, so a Cout of 16 or 32 pays for 64, and a Cin of 1 for 16 (e0c1 stays
// on the tensor cores: the kernel is bound by its products, not its bytes).
//
// The tensor-core design (conv3x3_mma_kernel<NB>, every conv with Cin >= 8):
//  * GEMM view: M = voxels, N = Cout (NB = 8, 16, 32 or 64 per block, the
//    smallest that holds Cout, else 64 and Cout/64 blocks), K = 27 taps x Cin,
//    walked as (16-channel chunk, tap). wgmma.mma_async m64nNBk16, bf16 x
//    bf16 -> fp32 registers, A and B both from shared memory.
//  * A block (256 threads, 2 warpgroups) owns a 2 (z) x TY x TX output tile
//    and stages its 4 x (TY+2) x (TX+2) halo tile ONCE per chunk, already
//    affined, rounded to bf16 and zeroed outside the volume, in the
//    un-swizzled K-major core-matrix layout [ci/8][halo voxel][8 channels]:
//    8 consecutive voxels x 8 channels are one contiguous 128-byte core
//    matrix, so tap (dz, dy, dx) is just the A descriptor's start address
//    moved by 16 * ((dz*HY + dy)*HX + dx) bytes. M runs over the linearised
//    halo tile of one z slab; each warpgroup owns one slab as four 64-row
//    blocks. For X > 32 (TX 64, TY 4) a block of rows is one x row (start
//    oy*HX, nothing wasted); for smaller X (TX 32 / TY 7, TX 16 / TY 14)
//    blocks start every 64 rows and the rows that fall on halo columns are
//    computed and masked in the epilogue (a waste of 2/HX).
//  * Weights come packed by the wrapper as bf16 [Cout block][chunk][ci/8]
//    [tap][NB][8] (the B operand's K-major core matrices); one
//    cp.async.bulk per chunk brings the 27 x 16 x NB slab in onto an
//    mbarrier, two stages deep, started a whole chunk ahead.
//  * Activations cannot come by TMA: the affine, the rounding and pad0 sit
//    between device memory and shared memory, and the upconv source is read
//    at half resolution. They go through registers. A lane takes one aligned
//    x octet of one halo row in all 8 channels of a group: 8 loads of 16
//    bytes in flight at once, then per voxel the row of 8 channels, where the
//    affine's cvt.bf16x2 packs two channels into a word (so the transpose is
//    free; without an affine one byte-permute per word does it), written with
//    ONE 16-byte store. Octets side by side in a warp would put the 8 lanes
//    of a store phase on the same four banks (an 8-way conflict, since a
//    voxel octet is 128 bytes); instead lanes 2r and 2r + 1 take two
//    neighbouring octets of halo row r0 + r: 32-byte sectors of device memory
//    are still read whole, and a halo row being 32 bytes more than a multiple
//    of 128 long, a phase's 8 lanes fall on 4 distinct bank groups (a 2-way
//    conflict). Giving a lane one channel and 2-byte stores instead costs
//    13 instructions per value against 4 and makes the staging as long as
//    the wgmmas. The wgmmas of chunk c are launched asynchronously, then the
//    same threads stage chunk c+1 into the other halo buffer while the last
//    of them run, then wait (a warp stalls launching them until most are
//    worked off, so the overlap is partial; the 216 wgmmas of a chunk are
//    6,900 cycles at NB 64). Sizes not a multiple of 8 in X (16 for the upconv)
//    take a scalar staging loop with the same result.
//  * Epilogue from the accumulator fragments: bias, ReLU, bf16 store, stats
//    partials by warp shuffles and one shared-memory pass, split store for
//    the gradient.
//
// Shared memory per stage: halo 2 x 1600 voxels x 16 B = 51,200 B; weights
// 27 x 16 x NB x 2 B = 55,296 B at NB 64 (27,648 at 32; 13,824 at 16; 6,912
// at 8). Two stages when Cin > 16, else one: 213,008 B at NB 64 (one block
// per SM), 78,864 B for e0c2 (16 -> 32, one chunk: two blocks per SM, whose
// staging and wgmmas overlap each other).
// Registers and spill (nvcc -Xptxas -v, sm_90a, CUDA 12.8; build/.../nvcc.log):
// conv3x3_mma_kernel<64> 226 registers, no spill (128 of them accumulators);
// <32> 128 registers with 60 bytes of spill, <16> 126, <8> 112 (NB <= 32 is
// held to 128 registers so that two blocks fit an SM; the staging's 8 loads
// in flight and 16 affine constants press on that); conv3x3_res_mma_kernel
// <64> 224, no spill, <32> 128 with 4 bytes; tconv3_mma_kernel<64> 233, no
// spill, <32> 128 with 12 bytes; tconv3_dgrad_mma_kernel<64> 248, <32> 128,
// no spill; conv3x3_fma_kernel 128 registers with 28 bytes of spill;
// wgrad3x3_mma_kernel<32>, <16> 128 registers (512 threads) with 36 bytes of
// spill stores, 120 of loads (tconv3_wgrad_mma_kernel: 40 and 124);
// wgrad3x3_reduce_kernel and tconv3_wgrad_reduce_kernel 32. Shared memory of the
// weight gradient: 4 input planes x 16 channels x 340 voxels x 2 B (43,520)
// and 2 cotangent planes x 8 channel groups x 288 units x 16 B (73,728).
//
// Which shapes take which instantiation (the caller's rule, FMA_BELOW in
// ops/cuda/conv3d.py): every input gradient, and the
// forward conv at Cin >= 8 -> conv3x3_mma_kernel<NB> with NB from Cout
// (channel counts that are no multiple of 8 are zero-padded by the pack);
// forward at Cin < 8 (the U-Net's e0c1, 1 -> 16) -> conv3x3_fma_kernel, the fp32-FMA
// kernel of the first slices (a block owns a 4 x 8 x 32 tile and 16 output
// channels, operands widened to fp32 in shared memory, 192 FMAs per thread
// and (ci, dy, dx), only over a chunk's real channels): with K = 27 there is
// no tensor-core shape along channels, and it runs ahead of the library's
// bf16 conv there, 6x above its bytes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// the tensor-core implicit GEMM
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;  // two warpgroups, one z slab each
constexpr int TZ = 2, HZ = TZ + 2;
constexpr int MBZ = 4;            // 64-row blocks per slab (per warpgroup)
constexpr int NVOX_ALLOC = 1600;  // halo voxels a stage holds (>= every read)
constexpr int HBYTES = 2 * NVOX_ALLOC * 16;

struct MmaArgs {
  const __nv_bfloat16* xa;  // (Z, Ca, Y*X)
  const __nv_bfloat16* xb;  // (Z, Cb, Y*X) or (Z/2, Cb, Y/2*X/2), may be null
  const float* scale;       // (Cin,) or null: no affine
  const float* shift;       // (Cin,) or null
  const __nv_bfloat16* w;   // packed [nb][chunk][2][27][NB][8]
  const float* bias;        // (Cout,) or null
  __nv_bfloat16* out;       // (Z, Csplit, Y*X): output channels [0, Csplit)
  __nv_bfloat16* out_b;     // (Z, Cout - Csplit, Y*X): the rest, or null
  float* stats;             // (n_tiles, Cout, 2) or null
  const __nv_bfloat16* res; // (Z, Cout, Y*X), added in the RES and TCONV modes, or null
  int Z, Y, X, Ca, Cb, CaP, nchunks, Cout, Csplit, b_lowres, relu;
  int TX, TY, HX, HY, MSTRIDE, ntx, nty, nb, vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// one chunk's weight slab, device memory -> shared memory, onto the barrier
__device__ __forceinline__ void load_weights(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// D (64 x N fp32, in registers) += A (64 x 16) * B (16 x N), both bf16 in
// shared memory behind their descriptors
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
}

// Stage 8 channels [cs0, cs0 + 8) of one source into dst ([voxel][8]) with
// 16-byte loads along x. An item is one aligned x octet of one halo row in
// all 8 channels: a lane has its 8 loads in flight at once, then builds each
// voxel's row of 8 channels (the affine's cvt.bf16x2 packs two channels into a
// word, so the transpose costs nothing; without an affine one byte-permute per
// word does it) and writes it with one 16-byte store. Lanes 2r and 2r + 1 of
// a warp take two neighbouring octets of halo row r0 + r: 32-byte sectors of
// device memory are read whole, and since a halo row is 32 bytes more than a
// multiple of 128 long, the 8 lanes of a store phase fall on 4 distinct bank
// groups (a 2-way conflict; octets side by side would make it 8-way).
template <bool LOW, bool AFF, int NT = MMA_THREADS, bool DIL = false>
__device__ __forceinline__ void stage_group_vec(const MmaArgs& p,
                                                const __nv_bfloat16* __restrict__ src, int Cs,
                                                int cs0, int aff0, int zlo, int nz, int y0,
                                                int x0, unsigned char* dst) {
  const int Ys = LOW ? p.Y >> 1 : p.Y, Xs = LOW ? p.X >> 1 : p.X;
  const int plane = (Ys * Xs) >> 3;  // a channel's 16-byte units
  const int noct = (LOW ? p.TX >> 4 : p.TX >> 3) + 2;
  const int nrows = nz * p.HY;
  const int xs0 = (LOW ? x0 >> 1 : x0) - 8;
  const int nch = min(max(Cs - cs0, 0), 8);  // real channels of this group
  const unsigned hx = static_cast<unsigned>(p.HX);
  float a[8], b[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c] = AFF && c < nch ? p.scale[aff0 + c] : 1.0f;
    b[c] = AFF && c < nch ? p.shift[aff0 + c] : 0.0f;
  }
  const int nitems = nrows * ((noct + 1) & ~1);
  for (int idx = threadIdx.x % NT; idx < nitems; idx += NT) {
    const int row = (idx >> 1) % nrows;
    const int o = 2 * ((idx >> 1) / nrows) + (idx & 1);
    if (o >= noct) continue;
    const int z = zlo + row / p.HY, y = y0 - 1 + row % p.HY, xs = xs0 + 8 * o;
    const bool inside = z >= 0 && z < p.Z && y >= 0 && y < p.Y && xs >= 0 && xs < Xs &&
                        !(DIL && ((z | y) & 1));
    uint4 v[8];
    const uint4* at = reinterpret_cast<const uint4*>(src) +
                      (static_cast<long long>(LOW ? z >> 1 : z) * Cs + cs0) * plane +
                      (((LOW ? y >> 1 : y) * Xs + xs) >> 3);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = inside && c < nch ? __ldg(at + c * plane) : make_uint4(0u, 0u, 0u, 0u);
    unsigned char* drow = dst + row * p.HX * 16;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      uint32_t out[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint4 &e = v[2 * m], &f = v[2 * m + 1];
        const uint32_t we = x < 2 ? e.x : x < 4 ? e.y : x < 6 ? e.z : e.w;
        const uint32_t wf = x < 2 ? f.x : x < 4 ? f.y : x < 6 ? f.z : f.w;
        if (AFF) {  // pad0 after the affine: outside the volume stays 0
          float lo = __uint_as_float((x & 1) ? (we & 0xffff0000u) : (we << 16));
          float hi = __uint_as_float((x & 1) ? (wf & 0xffff0000u) : (wf << 16));
          if (inside) {
            lo = __fadd_rn(__fmul_rn(a[2 * m], lo), b[2 * m]);
            hi = __fadd_rn(__fmul_rn(a[2 * m + 1], hi), b[2 * m + 1]);
          }
          const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
          out[m] = *reinterpret_cast<const uint32_t*>(&r);
        } else {
          out[m] = __byte_perm(we, wf, (x & 1) ? 0x7632 : 0x5410);
        }
      }
      const uint4 o4 = make_uint4(out[0], out[1], out[2], out[3]);
      if (!LOW) {
        const int lx = 8 * o + x - 7;
        if (static_cast<unsigned>(lx) < hx) *reinterpret_cast<uint4*>(drow + lx * 16) = o4;
      } else {
        const int lx = 16 * o + 2 * x - 15;
        if (static_cast<unsigned>(lx) < hx) *reinterpret_cast<uint4*>(drow + lx * 16) = o4;
        if (static_cast<unsigned>(lx + 1) < hx)
          *reinterpret_cast<uint4*>(drow + (lx + 1) * 16) = DIL ? make_uint4(0u, 0u, 0u, 0u) : o4;
      }
    }
  }
}

// The same, one value at a time: any X.
template <int NT = MMA_THREADS, bool DIL = false>
__device__ __forceinline__ void stage_group_scalar(const MmaArgs& p,
                                                   const __nv_bfloat16* __restrict__ src, int Cs,
                                                   int cs0, int aff0, bool low, int zlo, int nz,
                                                   int y0, int x0, uint16_t* dst) {
  const bool aff = p.scale != nullptr;
  const int Ys = low ? p.Y >> 1 : p.Y, Xs = low ? p.X >> 1 : p.X;
  const int nvox = nz * p.HY * p.HX;
  for (int idx = threadIdx.x % NT; idx < nvox * 8; idx += NT) {
    const int c = idx & 7, vox = idx >> 3;
    const int lx = vox % p.HX, r = vox / p.HX;
    const int ly = r % p.HY, lz = r / p.HY;
    const int z = zlo + lz, y = y0 - 1 + ly, x = x0 - 1 + lx;
    const int ch = cs0 + c;
    uint16_t bits = 0;
    if (ch < Cs && z >= 0 && z < p.Z && y >= 0 && y < p.Y && x >= 0 && x < p.X &&
        !(DIL && low && ((z | y | x) & 1))) {
      const int zs = low ? z >> 1 : z, ys = low ? y >> 1 : y, xs = low ? x >> 1 : x;
      __nv_bfloat16 v = src[(static_cast<long long>(zs) * Cs + ch) * Ys * Xs +
                            static_cast<long long>(ys) * Xs + xs];
      if (aff)
        v = __float2bfloat16_rn(
            __fadd_rn(__fmul_rn(p.scale[aff0 + c], __bfloat162float(v)), p.shift[aff0 + c]));
      bits = __bfloat16_as_ushort(v);
    }
    dst[vox * 8 + c] = bits;
  }
}

// One 16-channel chunk of the halo tile's planes [zlo, zlo + nz):
// pad0(bf16(a*x + b)) as [ci/8][halo voxel][8], the two 8-channel groups
// gstride bytes apart. Packed channel kk is source A's channel kk below CaP
// (Ca rounded up to 8), else source B's channel kk - CaP; channels past a
// source's end are zeros. NT threads (a whole number of warpgroups) stage.
// With DIL the half-resolution source is zero-dilated instead of repeated:
// full-resolution (z, y, x) holds source (z/2, y/2, x/2) where all three are
// even, else 0 (the transposed conv's input, below).
template <int NT = MMA_THREADS, bool DIL = false>
__device__ __forceinline__ void stage_halo(const MmaArgs& p, int chunk, int zlo, int nz, int y0,
                                           int x0, unsigned char* dst, int gstride) {
#pragma unroll 1
  for (int kg = 0; kg < 2; ++kg) {
    const int kk0 = chunk * 16 + kg * 8;
    const bool is_a = kk0 < p.CaP;
    const int cs0 = is_a ? kk0 : kk0 - p.CaP;
    const int Cs = is_a ? p.Ca : p.Cb;
    const __nv_bfloat16* src = is_a ? p.xa : p.xb;
    const int aff0 = is_a ? kk0 : p.Ca + cs0;
    const bool low = !is_a && p.b_lowres;
    unsigned char* d = dst + kg * gstride;
    const bool aff = p.scale != nullptr;
    if (!p.vec)
      stage_group_scalar<NT, DIL>(p, src, Cs, cs0, aff0, low, zlo, nz, y0, x0,
                                  reinterpret_cast<uint16_t*>(d));
    else if (low)
      aff ? stage_group_vec<true, true, NT, DIL>(p, src, Cs, cs0, aff0, zlo, nz, y0, x0, d)
          : stage_group_vec<true, false, NT, DIL>(p, src, Cs, cs0, aff0, zlo, nz, y0, x0, d);
    else
      aff ? stage_group_vec<false, true, NT>(p, src, Cs, cs0, aff0, zlo, nz, y0, x0, d)
          : stage_group_vec<false, false, NT>(p, src, Cs, cs0, aff0, zlo, nz, y0, x0, d);
  }
}

// The residual's tile of a block's outputs (two z slabs x TY x TX, NB
// columns from Cout block nbi) into shared memory in two halves by column,
// columns [0, NB/2) at rt0 and the rest at rt1, each [z slab][column][y]
// [x]: 16-byte loads along x by all threads at once (cp.async with async,
// which needs 16-byte loads), value by value where x is not a multiple of 8
// or the pointers are not aligned. Outside the volume nothing is written: the
// epilogue reads only its valid rows.
template <int NB>
__device__ __forceinline__ void stage_residual(const MmaArgs& p, __nv_bfloat16* rt0,
                                               __nv_bfloat16* rt1, int z0, int y0, int x0,
                                               int nbi, bool async) {
  constexpr int NH = NB / 2;
  const long long YX = static_cast<long long>(p.Y) * p.X;
  const int noct = p.TX >> 3;
  for (int idx = threadIdx.x; idx < 2 * NB * p.TY * noct; idx += MMA_THREADS) {
    const int oct = idx % noct, r = idx / noct;
    const int oy = r % p.TY, col = (r / p.TY) % NB, zz = r / (p.TY * NB);
    const int zr = z0 + zz, yr = y0 + oy, xr = x0 + 8 * oct, co = nbi * NB + col;
    if (zr >= p.Z || yr >= p.Y || xr >= p.X || co >= p.Cout) continue;
    __nv_bfloat16* d = (col < NH ? rt0 : rt1) + ((zz * NH + col % NH) * p.TY + oy) * p.TX + 8 * oct;
    const __nv_bfloat16* src = p.res + (static_cast<long long>(zr) * p.Cout + co) * YX +
                               static_cast<long long>(yr) * p.X + xr;
    if (async)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(d)), "l"(src)
                   : "memory");
    else if (p.vec && xr + 8 <= p.X)
      *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(src));
    else
      for (int k = 0; k < 8 && xr + k < p.X; ++k) d[k] = src[k];
  }
}

// What a launch of the implicit GEMM computes: the fused conv (PLAIN); the
// fused conv whose rounded output has the residual operand added before the
// ReLU (RES: relu(bf16(bf16(conv + bias) + res)), a residual block's third
// conv with the sum and the non-linearity after it); the transposed 3^3
// stride-2 conv as that conv over the zero-dilated half-resolution source
// (TCONV, below), its rounded output summed with the skip in the same way;
// the transposed conv's input gradient (TDGRAD, below): the conv kept at the
// even voxels and stored at half resolution. (3 is the FMA kernel's form.)
enum Mode { PLAIN = 0, RES = 1, TCONV = 2, TDGRAD = 4 };

template <int NB, int MODE>
__device__ __forceinline__ void mma_conv(const MmaArgs& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool DIL = MODE == TCONV;
  constexpr bool SUM = MODE == RES || MODE == TCONV;  // the epilogue adds res
  constexpr int WBYTES = 2 * 27 * NB * 16;
  constexpr int NR = NB / 2;  // accumulator registers per 64-row block
  const int nst = p.nchunks > 1 ? 2 : 1;
  unsigned char* wbuf = smem;
  unsigned char* hbuf = smem + nst * WBYTES;
  const uint32_t bar0 = smem_u32(hbuf + nst * HBYTES);

  const int tid = threadIdx.x;
  const int nbi = blockIdx.x % p.nb, tile = blockIdx.x / p.nb;
  const int x0 = (tile % p.ntx) * p.TX;
  const int y0 = ((tile / p.ntx) % p.nty) * p.TY;
  const int z0 = (tile / (p.ntx * p.nty)) * TZ;
  const unsigned char* wsrc =
      reinterpret_cast<const unsigned char*>(p.w) + static_cast<size_t>(nbi) * p.nchunks * WBYTES;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < nst; ++s)
      load_weights(smem_u32(wbuf + s * WBYTES), wsrc + static_cast<size_t>(s) * WBYTES, WBYTES,
                   bar0 + 8 * s);
  }
  stage_halo<MMA_THREADS, DIL>(p, 0, z0 - 1, HZ, y0, x0, hbuf, NVOX_ALLOC * 16);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float acc[MBZ][NR];
#pragma unroll
  for (int i = 0; i < MBZ; ++i)
#pragma unroll
    for (int k = 0; k < NR; ++k) acc[i][k] = 0.0f;

  // descriptors: no swizzle, K-major; the two 8-channel core matrices of a
  // k16 step lie LBO apart, 8-row groups 128 bytes (SBO) apart
  const int wg = tid >> 7;
  constexpr uint64_t A_HI = (static_cast<uint64_t>(NVOX_ALLOC) << 16) | (8ull << 32);
  constexpr uint64_t B_HI = (static_cast<uint64_t>(27 * NB) << 16) | (8ull << 32);
  const uint32_t a_lo = (smem_u32(hbuf) >> 4) + wg * p.HY * p.HX;  // this warpgroup's slab
  const uint32_t b_lo = smem_u32(wbuf) >> 4;
  // TDGRAD keeps the even voxels: the products of the odd z slab (warpgroup
  // 1: z0 is even), and where a 64-row block is one x row (MSTRIDE == HX) of
  // the odd rows, are not issued
  bool live[MBZ];
#pragma unroll
  for (int i = 0; i < MBZ; ++i)
    live[i] = MODE != TDGRAD ||
              (((z0 + wg) & 1) == 0 && (p.MSTRIDE != p.HX || ((y0 + i) & 1) == 0));

  // RES, TCONV: the residual's tile goes to shared memory before the
  // epilogue (stage_residual): during the last chunk's products into the idle
  // weight and halo buffers of the other stage (a half each; the halo half
  // behind the stats scratch), else after them behind the scratch. Read value
  // by value in the epilogue instead, a thread's eight columns were eight
  // round trips to device memory with one block an SM: +4 ms on a 32-channel
  // 256^3 conv.
  constexpr int RED_BYTES = MMA_THREADS / 32 * NB * 2 * 4;  // (8 warps, NB, 2) floats
  const int tvox = p.TY * p.TX;
  const int half = NB * tvox * 2;  // bytes of a half tile
  const bool staged = SUM && p.res != nullptr && RED_BYTES + 2 * half <= nst * HBYTES;
  const bool early = staged && p.vec && nst == 2 && half <= WBYTES && RED_BYTES + half <= HBYTES;
  const int so = ((p.nchunks - 1) & 1) ^ 1;  // the stage idle during the last chunk
  __nv_bfloat16* const rt0 =
      reinterpret_cast<__nv_bfloat16*>(early ? wbuf + so * WBYTES : hbuf + RED_BYTES);
  __nv_bfloat16* const rt1 = early
      ? reinterpret_cast<__nv_bfloat16*>(hbuf + so * HBYTES + RED_BYTES) : rt0 + NB * tvox;

#pragma unroll 1
  for (int c = 0; c < p.nchunks; ++c) {
    const int s = c & 1;
    mbar_wait(bar0 + 8 * s, (c >> 1) & 1);
#pragma unroll
    for (int i = 0; i < MBZ; ++i)
#pragma unroll
      for (int k = 0; k < NR; ++k) asm volatile("" : "+f"(acc[i][k])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t a_s = a_lo + s * (HBYTES >> 4);
    const uint32_t b_s = b_lo + s * (WBYTES >> 4);
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int tap = (dz * 3 + dy) * 3 + dx;
          const uint64_t db = B_HI | static_cast<uint64_t>(b_s + tap * NB);
          const uint32_t a_t = a_s + (dz * p.HY + dy) * p.HX + dx;
#pragma unroll
          for (int i = 0; i < MBZ; ++i)
            if (live[i]) wgmma<NB>(acc[i], A_HI | static_cast<uint64_t>(a_t + i * p.MSTRIDE), db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the tensor cores work on chunk c; stage chunk c + 1 meanwhile, or in the
    // last chunk the residual's tile into the idle halo buffer
    if (c + 1 < p.nchunks)
      stage_halo<MMA_THREADS, DIL>(p, c + 1, z0 - 1, HZ, y0, x0, hbuf + (s ^ 1) * HBYTES,
                                   NVOX_ALLOC * 16);
    else if (early)
      stage_residual<NB>(p, rt0, rt1, z0, y0, x0, nbi, true);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < MBZ; ++i)
#pragma unroll
      for (int k = 0; k < NR; ++k) asm volatile("" : "+f"(acc[i][k])::"memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage s is free, the other halo buffer is written
    if (tid == 0 && c + 2 < p.nchunks)
      load_weights(smem_u32(wbuf + s * WBYTES), wsrc + static_cast<size_t>(c + 2) * WBYTES, WBYTES,
                   bar0 + 8 * s);
  }

  // epilogue. Accumulator fragment of a 64-row block: this thread holds rows
  // r0 = 16 * (warp in group) + lane / 4 and r0 + 8, columns 8j + 2 * (lane % 4) + e
  const int lane = tid & 31, warp = tid >> 5;
  const int z = z0 + wg;
  const long long YX = static_cast<long long>(p.Y) * p.X;
  int yx[MBZ][2], tl[MBZ][2];
  bool ok[MBZ][2];
#pragma unroll
  for (int i = 0; i < MBZ; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lin = i * p.MSTRIDE + 16 * (warp & 3) + (lane >> 2) + 8 * h;
      const int oy = lin / p.HX, ox = lin - oy * p.HX;
      const int y = y0 + oy, x = x0 + ox;
      ok[i][h] = ox < p.TX && oy < p.TY && z < p.Z && y < p.Y && x < p.X &&
                 (MODE != TDGRAD || ((z | y | x) & 1) == 0);
      yx[i][h] = MODE == TDGRAD ? (y >> 1) * (p.X >> 1) + (x >> 1) : y * p.X + x;
      tl[i][h] = oy * p.TX + ox;
    }
  float* red = reinterpret_cast<float*>(hbuf);  // (8 warps, NB, 2); the halo is done with
  if (early) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  } else if (staged) {
    stage_residual<NB>(p, rt0, rt1, z0, y0, x0, nbi, false);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane & 3) + e;
      const int co = nbi * NB + col;
      const bool cok = co < p.Cout;
      const float bias = (cok && p.bias != nullptr) ? p.bias[co] : 0.0f;
      __nv_bfloat16* base = nullptr;
      const __nv_bfloat16* rbase = nullptr;  // RES, TCONV: Csplit == Cout
      if (cok) {
        if (MODE == TDGRAD)  // (Z/2, Cout, Y/2*X/2)
          base = p.out + (static_cast<long long>(z >> 1) * p.Cout + co) * (YX >> 2);
        else
          base = co < p.Csplit
                     ? p.out + (static_cast<long long>(z) * p.Csplit + co) * YX
                     : p.out_b + (static_cast<long long>(z) * (p.Cout - p.Csplit) + co - p.Csplit) * YX;
        if (SUM && p.res != nullptr)
          rbase = p.res + (static_cast<long long>(z) * p.Cout + co) * YX;
      }
      float rv[MBZ][2];  // the residual's values of this column
      if constexpr (SUM) {
        const __nv_bfloat16* rcol =
            (col < NB / 2 ? rt0 : rt1) + (wg * (NB / 2) + col % (NB / 2)) * tvox;
#pragma unroll
        for (int i = 0; i < MBZ; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rv[i][h] = rbase == nullptr || !ok[i][h] ? 0.0f
                       : staged ? __bfloat162float(rcol[tl[i][h]])
                                : __bfloat162float(__ldg(rbase + yx[i][h]));
      }
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int i = 0; i < MBZ; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(cok && ok[i][h])) continue;
          float v = acc[i][4 * j + 2 * h + e] + bias;
          if (SUM && rbase != nullptr)
            v = __bfloat162float(__float2bfloat16_rn(v)) + rv[i][h];
          if (p.relu) v = fmaxf(v, 0.0f);
          const __nv_bfloat16 hv = __float2bfloat16_rn(v);
          base[yx[i][h]] = hv;
          const float f = __bfloat162float(hv);
          s1 += f;
          s2 = fmaf(f, f, s2);
        }
      if (p.stats != nullptr) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (lane < 4) {
          red[(warp * NB + col) * 2 + 0] = s1;
          red[(warp * NB + col) * 2 + 1] = s2;
        }
      }
    }
  }
  if (p.stats != nullptr) {
    __syncthreads();
    if (tid < 2 * NB) {
      const int col = tid >> 1, k = tid & 1;
      float sum = 0.0f;
      for (int w = 0; w < MMA_THREADS / 32; ++w) sum += red[(w * NB + col) * 2 + k];
      const int co = nbi * NB + col;
      if (co < p.Cout) p.stats[(static_cast<long long>(tile) * p.Cout + co) * 2 + k] = sum;
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(MMA_THREADS, NB <= 32 ? 2 : 1)
    conv3x3_mma_kernel(const MmaArgs p) {
  mma_conv<NB, PLAIN>(p);
}

template <int NB>
__global__ void __launch_bounds__(MMA_THREADS, NB <= 32 ? 2 : 1)
    conv3x3_res_mma_kernel(const MmaArgs p) {
  mma_conv<NB, RES>(p);
}

// The transposed 3^3 conv, stride 2, padding 1, output padding 1 (torch's
// ConvTranspose3d as the residual decoder builds it): out[o] = sum over i, k
// with o = 2i - 1 + k of x[i] W[k], per axis. With D the half-resolution
// input zero-dilated to full resolution (D[2i] = x[i], D[2i + 1] = 0), that
// is sum_d W[2 - d] D[o + d - 1]: the SAME 3^3 conv of D with the taps flipped
// and Cin/Cout swapped (the wrapper's pack). The staging builds D in shared
// memory straight from the half-resolution source (DIL), so D never exists
// in device memory; 7 of 8 staged values are zeros, and the tensor cores
// multiply them: 8x the useful operations. Its own name keeps its time apart
// from the 3^3 convs' in a profile.
template <int NB>
__global__ void __launch_bounds__(MMA_THREADS, NB <= 32 ? 2 : 1)
    tconv3_mma_kernel(const MmaArgs p) {
  mma_conv<NB, TCONV>(p);
}

// The transposed conv's input gradient, g_x[ci, i] = sum_{k, co} Wt[ci, co, k]
// g_y[co, 2i + k - 1] per axis: the SAME 3^3 conv of g_y (taps as they are,
// Cin/Cout swapped: the wrapper's pack) at full resolution, kept at the even
// voxels (2i) and stored at half resolution. Only a warpgroup whose z slab is
// even issues products, and with a block a row (X > 32) only for even rows:
// a quarter of the products are issued there (half for X <= 32, where blocks
// straddle rows), twice or four times the useful ones. Its own name keeps its
// time apart in a profile.
template <int NB>
__global__ void __launch_bounds__(MMA_THREADS, NB <= 32 ? 2 : 1)
    tconv3_dgrad_mma_kernel(const MmaArgs p) {
  mma_conv<NB, TDGRAD>(p);
}

// the kernel of (NB, MODE), instantiating no other
template <int NB, int MODE>
auto mma_kernel() {
  if constexpr (MODE == PLAIN)
    return conv3x3_mma_kernel<NB>;
  else if constexpr (MODE == RES)
    return conv3x3_res_mma_kernel<NB>;
  else if constexpr (MODE == TCONV)
    return tconv3_mma_kernel<NB>;
  else
    return tconv3_dgrad_mma_kernel<NB>;
}

template <int NB, int MODE>
int launch_mma(const MmaArgs& p, int tiles, cudaStream_t stream) {
  const int nst = p.nchunks > 1 ? 2 : 1;
  const int smem = nst * (2 * 27 * NB * 16 + HBYTES) + 16;
  const auto kernel = mma_kernel<NB, MODE>();
  // once per instantiation and device, for its larger (two-stage) size
  static bool allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * (2 * 27 * NB * 16 + HBYTES) + 16);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = true;
  }
  kernel<<<tiles * p.nb, MMA_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tile geometry (tx, ty, mstride) is the caller's choice (tile_geometry in
// ops/cuda/conv3d.py owns the table); here it is only derived from and held
// against what this file fixes at compile time: refuses a geometry the
// kernel's buffers and its eight 64-row blocks do not cover, or a tile count
// that is not the caller's (its stats buffer has one row per tile).
// RES, TCONV and TDGRAD take NB 32 or 64 only (n_block in ops/cuda/conv3d.py
// pads a smaller Cout).
int run_mma(MmaArgs p, int nblk, int tx, int ty, int mstride, int n_tiles, cudaStream_t stream,
            int mode) {
  p.TX = tx;
  p.TY = ty;
  p.HX = tx + 2;
  p.HY = ty + 2;
  p.MSTRIDE = mstride;
  p.ntx = km::ceil_div(p.X, tx);
  p.nty = km::ceil_div(p.Y, ty);
  p.nb = km::ceil_div(p.Cout, nblk);
  p.CaP = (p.Ca + 7) / 8 * 8;
  p.nchunks = (p.CaP + (p.Cb + 7) / 8 * 8 + 15) / 16;
  const int slab = p.HY * p.HX;
  const int last_read = slab + (MBZ - 1) * mstride + 63 + (2 * p.HY + 2) * p.HX + 2;
  const bool rows = mstride == p.HX && tx <= 64 && ty <= MBZ;          // a block per x row
  const bool linear = mstride == 64 && (ty - 1) * p.HX + tx <= 64 * MBZ;  // blocks every 64
  const int tiles = p.ntx * p.nty * km::ceil_div(p.Z, TZ);
  if (tx % 16 != 0 || tx < 16 || ty < 1 || !(rows || linear) || HZ * slab > NVOX_ALLOC ||
      last_read >= NVOX_ALLOC || tiles != n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == RES) {
    if (nblk == 32) return launch_mma<32, RES>(p, tiles, stream);
    if (nblk == 64) return launch_mma<64, RES>(p, tiles, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == TCONV) {
    if (nblk == 32) return launch_mma<32, TCONV>(p, tiles, stream);
    if (nblk == 64) return launch_mma<64, TCONV>(p, tiles, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == TDGRAD) {
    if (nblk == 32) return launch_mma<32, TDGRAD>(p, tiles, stream);
    if (nblk == 64) return launch_mma<64, TDGRAD>(p, tiles, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (nblk) {
    case 8: return launch_mma<8, PLAIN>(p, tiles, stream);
    case 16: return launch_mma<16, PLAIN>(p, tiles, stream);
    case 32: return launch_mma<32, PLAIN>(p, tiles, stream);
    case 64: return launch_mma<64, PLAIN>(p, tiles, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// the FMA kernel (forward, Cin < 8)
// ---------------------------------------------------------------------------

constexpr int FTX = 32, FTY = 8, FTZ = 4;  // output tile (x, y, z)
constexpr int FCO = 16;                    // output channels per block
constexpr int FCI = 4;                     // input channels per shared-memory chunk
constexpr int FHX = FTX + 2, FHY = FTY + 2, FHZ = FTZ + 2;
constexpr int FHALO = FHZ * FHY * FHX;
constexpr int FMA_THREADS = FTX * FTY;

struct FmaArgs {
  const __nv_bfloat16* xa;  // (Z, Ca, Y*X)
  const __nv_bfloat16* xb;  // (Z, Cb, Y*X) or (Z/2, Cb, Y/2*X/2), may be null
  const float* scale;       // (Cin,) or null
  const float* shift;       // (Cin,) or null
  const float* w;           // (Cin, 27, CoutP) bf16-rounded values
  const float* bias;        // (Cout,) or null
  __nv_bfloat16* out;       // (Z, Cout, Y*X)
  float* stats;             // (n_tiles, Cout, 2) or null
  int Z, Y, X, Ca, Cb, Cout, CoutP, b_lowres, relu;
};

__device__ __forceinline__ float load_in(const FmaArgs& p, int c, int z, int y, int x) {
  // pad0(bf16(a*x + b)): out-of-volume taps and padded channels are 0
  const int Cin = p.Ca + p.Cb;
  if (c >= Cin || z < 0 || z >= p.Z || y < 0 || y >= p.Y || x < 0 || x >= p.X) return 0.0f;
  float v;
  if (c < p.Ca) {
    const long long off = (static_cast<long long>(z) * p.Ca + c) * p.Y * p.X +
                          static_cast<long long>(y) * p.X + x;
    v = __bfloat162float(p.xa[off]);
  } else if (p.b_lowres) {
    const int Yl = p.Y >> 1, Xl = p.X >> 1;
    const long long off = (static_cast<long long>(z >> 1) * p.Cb + (c - p.Ca)) * Yl * Xl +
                          static_cast<long long>(y >> 1) * Xl + (x >> 1);
    v = __bfloat162float(p.xb[off]);
  } else {
    const long long off = (static_cast<long long>(z) * p.Cb + (c - p.Ca)) * p.Y * p.X +
                          static_cast<long long>(y) * p.X + x;
    v = __bfloat162float(p.xb[off]);
  }
  if (p.scale == nullptr) return v;  // no affine: bf16(1 * x + 0) is x
  const float u = __fadd_rn(__fmul_rn(p.scale[c], v), p.shift[c]);
  return __bfloat162float(__float2bfloat16_rn(u));
}

__global__ void __launch_bounds__(FMA_THREADS, 2) conv3x3_fma_kernel(FmaArgs p) {
  __shared__ __align__(16) float in_s[FCI * FHALO];
  __shared__ __align__(16) float w_s[FCI * 27 * FCO];

  const int ntx = (p.X + FTX - 1) / FTX, nty = (p.Y + FTY - 1) / FTY;
  const int tile = blockIdx.x;
  const int x0 = (tile % ntx) * FTX;
  const int y0 = ((tile / ntx) % nty) * FTY;
  const int z0 = (tile / (ntx * nty)) * FTZ;
  const int co0 = blockIdx.y * FCO;
  const int tx = threadIdx.x % FTX, ty = threadIdx.x / FTX;
  const int Cin = p.Ca + p.Cb;

  float acc[FTZ][FCO];
#pragma unroll
  for (int i = 0; i < FTZ; ++i)
#pragma unroll
    for (int j = 0; j < FCO; ++j) acc[i][j] = 0.0f;

  for (int ci0 = 0; ci0 < Cin; ci0 += FCI) {
    const int nc = min(FCI, Cin - ci0);  // real channels of this chunk (1 at e0c1)
    __syncthreads();  // the previous chunk's compute is done with in_s/w_s
    for (int i = threadIdx.x; i < nc * FHALO; i += FMA_THREADS) {
      const int lx = i % FHX;
      int r = i / FHX;
      const int ly = r % FHY;
      r /= FHY;
      const int lz = r % FHZ;
      const int c = r / FHZ;
      in_s[i] = load_in(p, ci0 + c, z0 - 1 + lz, y0 - 1 + ly, x0 - 1 + lx);
    }
    for (int i = threadIdx.x; i < nc * 27 * FCO; i += FMA_THREADS) {
      const int co = i % FCO;
      const int tap = (i / FCO) % 27;
      const int c = i / (FCO * 27);
      w_s[i] = p.w[(static_cast<long long>(ci0 + c) * 27 + tap) * p.CoutP + co0 + co];
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const float* in_c = in_s + c * FHALO;
      const float* w_c = w_s + c * 27 * FCO;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float col[FTZ + 2];
#pragma unroll
          for (int lz = 0; lz < FTZ + 2; ++lz) col[lz] = in_c[(lz * FHY + ty + dy) * FHX + tx + dx];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float4* wp = reinterpret_cast<const float4*>(w_c + ((dz * 3 + dy) * 3 + dx) * FCO);
            float wv[FCO];
#pragma unroll
            for (int q = 0; q < FCO / 4; ++q) {
              const float4 t = wp[q];
              wv[4 * q + 0] = t.x;
              wv[4 * q + 1] = t.y;
              wv[4 * q + 2] = t.z;
              wv[4 * q + 3] = t.w;
            }
#pragma unroll
            for (int zo = 0; zo < FTZ; ++zo)
#pragma unroll
              for (int co = 0; co < FCO; ++co) acc[zo][co] = fmaf(col[zo + dz], wv[co], acc[zo][co]);
          }
        }
      }
    }
  }

  // epilogue: bias, ReLU, bf16 store, stats of the stored values
  const int y = y0 + ty, x = x0 + tx;
  const long long YX = static_cast<long long>(p.Y) * p.X;
  float s1[FCO], s2[FCO];
#pragma unroll
  for (int co = 0; co < FCO; ++co) {
    s1[co] = 0.0f;
    s2[co] = 0.0f;
  }
#pragma unroll
  for (int zo = 0; zo < FTZ; ++zo) {
    const int z = z0 + zo;
    if (z >= p.Z || y >= p.Y || x >= p.X) continue;
#pragma unroll
    for (int co = 0; co < FCO; ++co) {
      const int cg = co0 + co;
      if (cg >= p.Cout) continue;
      const long long yx = static_cast<long long>(y) * p.X + x;
      float v = acc[zo][co] + (p.bias != nullptr ? p.bias[cg] : 0.0f);
      if (p.relu) v = fmaxf(v, 0.0f);
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      p.out[(static_cast<long long>(z) * p.Cout + cg) * YX + yx] = h;
      const float f = __bfloat162float(h);
      s1[co] += f;
      s2[co] = fmaf(f, f, s2[co]);
    }
  }
  if (p.stats == nullptr) return;
  // block reduction: warp shuffles, then one value per warp in shared memory
#pragma unroll
  for (int co = 0; co < FCO; ++co) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1[co] += __shfl_xor_sync(0xffffffffu, s1[co], o);
      s2[co] += __shfl_xor_sync(0xffffffffu, s2[co], o);
    }
  }
  __syncthreads();  // in_s is free: reuse it for the per-warp partials
  float* red = in_s;  // (FMA_THREADS / 32, FCO, 2)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int co = 0; co < FCO; ++co) {
      red[(warp * FCO + co) * 2 + 0] = s1[co];
      red[(warp * FCO + co) * 2 + 1] = s2[co];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * FCO) {
    const int co = threadIdx.x / 2, k = threadIdx.x % 2;
    float s = 0.0f;
    for (int w = 0; w < FMA_THREADS / 32; ++w) s += red[(w * FCO + co) * 2 + k];
    const int cg = co0 + co;
    if (cg < p.Cout) p.stats[(static_cast<long long>(tile) * p.Cout + cg) * 2 + k] = s;
  }
}

// km_conv3x3's form of this kernel, beside the implicit GEMM's Mode values
constexpr int FMA = 3;

int run_fma(const FmaArgs& p, int n_tiles, cudaStream_t stream) {
  const int tiles = km::ceil_div(p.X, FTX) * km::ceil_div(p.Y, FTY) * km::ceil_div(p.Z, FTZ);
  if (tiles != n_tiles || p.CoutP % FCO != 0 || p.CoutP < p.Cout)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles, p.CoutP / FCO);
  conv3x3_fma_kernel<<<grid, FMA_THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the weight gradient
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 512;              // 3 warpgroups of products (one dz each), 1 stager
constexpr int WVOX = 256;                    // output voxels of a plane tile (TY x TX)
constexpr int WCO = 64;                      // cotangent channels a block takes (wgmma M)
constexpr int UPL = 340;                     // halo voxels a staged input plane holds
constexpr int UBYTES = 2 * UPL * 16;         // one input plane, 16 channels
constexpr int GSTR = WVOX + WVOX / 8;        // units of a staged cotangent group (skewed)
constexpr int GBYTES = WCO / 8 * GSTR * 16;  // one cotangent plane, 64 channels
constexpr int WG_SMEM = 4 * UBYTES + 2 * GBYTES;
constexpr int BAR_FULL = 1, BAR_EMPTY = 3;   // named barriers, two of each (by step parity)

struct WgradArgs {
  MmaArgs in;               // the conv's input, its affine and the plane tile (TZ unused)
  const __nv_bfloat16* gv;  // (Z, Cout, Y*X)
  float* part;              // (nsplit, 27, 16 * nchunks, WCO * nco)
  int nco, nsplit, planes;  // planes: the ntx * nty * Z tile planes, cut into nsplit runs
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(WG_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(WG_THREADS) : "memory");
}

// D (64 x 16 fp32, in registers) += A (64 x 16 bf16, in registers) * B (16 x
// 16 bf16 in shared memory as MN-major core matrices: the transpose bit)
__device__ __forceinline__ void wgmma_rs16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Plane z of the cotangent's channels [co0, co0 + 64) over the plane tile at
// (y0, x0): voxel v of 8-channel group grp is 16 bytes at unit
// grp * GSTR + v + v / 8 (one unit of skew every 8 voxels), zeros outside
// the volume; groups past Cout are left as they are (their rows of the
// product are never stored). An item is one x octet of one group: 8 loads of
// 16 bytes (two items' in flight a thread), then per voxel one 16-byte store
// of its 8 channels (the byte-permute transposes); the skew puts the 8
// lanes of a store phase, 9 units apart, on 8 distinct bank groups, and keeps
// the 8 voxels an ldmatrix row set reads contiguous. Without 16-byte loads
// (X not a multiple of 8) an item is one voxel, loaded value by value.
template <int TX, int NT>
__device__ __forceinline__ void stage_cotangent(const WgradArgs& w, int z, int y0, int x0,
                                                int co0, unsigned char* dst) {
  const MmaArgs& p = w.in;
  const long long YX = static_cast<long long>(p.Y) * p.X;
  const int ngrp = min(8, (p.Cout - co0 + 7) >> 3);
  const __nv_bfloat16* gz = w.gv + (static_cast<long long>(z) * p.Cout + co0) * YX;
  if (!p.vec) {
    for (int idx = threadIdx.x % NT; idx < ngrp * WVOX; idx += NT) {
      const int grp = idx / WVOX, v = idx % WVOX;
      const int y = y0 + v / TX, x = x0 + v % TX;
      const __nv_bfloat16* at = gz + 8LL * grp * YX + static_cast<long long>(y) * p.X + x;
      uint32_t o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const bool in = y < p.Y && x < p.X;
        const int c = co0 + 8 * grp + 2 * m;
        const uint32_t lo = in && c < p.Cout ? __bfloat16_as_ushort(at[(2 * m) * YX]) : 0u;
        const uint32_t hi = in && c + 1 < p.Cout ? __bfloat16_as_ushort(at[(2 * m + 1) * YX]) : 0u;
        o[m] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + (grp * GSTR + v + (v >> 3)) * 16) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    return;
  }
  constexpr int NOCT = WVOX / 8;
  const int nitems = ngrp * NOCT;
  for (int i0 = threadIdx.x % NT; i0 < nitems; i0 += 2 * NT) {
    uint4 v[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = i0 + u * NT;
      const int grp = idx / NOCT, o = idx % NOCT;
      const int y = y0 + 8 * o / TX, x = x0 + 8 * o % TX;
      const uint4* at = reinterpret_cast<const uint4*>(gz + 8LL * grp * YX +
                                                       static_cast<long long>(y) * p.X + x);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[u][c] = idx < nitems && y < p.Y && x < p.X && co0 + 8 * grp + c < p.Cout
                      ? __ldg(at + c * (YX >> 3))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = i0 + u * NT;
      if (idx >= nitems) break;
      const int grp = idx / NOCT, o = idx % NOCT;
      unsigned char* d = dst + (grp * GSTR + 9 * o) * 16;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        uint32_t out[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint4 &e = v[u][2 * m], &f = v[u][2 * m + 1];
          const uint32_t we = x < 2 ? e.x : x < 4 ? e.y : x < 6 ? e.z : e.w;
          const uint32_t wf = x < 2 ? f.x : x < 4 ? f.y : x < 6 ? f.z : f.w;
          out[m] = __byte_perm(we, wf, (x & 1) ? 0x7632 : 0x5410);
        }
        *reinterpret_cast<uint4*>(d + x * 16) = make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  }
}

// A block owns one 64-channel block of the cotangent, one 16-channel chunk
// of the input and one run of tile planes (split-K over voxels), and walks
// the run plane by plane. Warpgroup 3 stages: input plane z + 1 and
// cotangent plane z of step z while warpgroups 0-2 work on step z - 1, onto
// named barriers (FULL: a step's operands are staged; EMPTY: a step's
// products are done, its buffers free). Warpgroup dz holds the 9 taps
// (dz, dy, dx) as 9 accumulators of 64 x 16 (72 registers) and reads input
// plane z - 1 + dz; a tap is the B descriptor's start moved by
// (ly + dy) * HX + lx + dx halo voxels. Per 16 voxels it loads the
// cotangent's 64 x 16 fragment once (ldmatrix.trans from the staged plane)
// for its 9 products, two fragments in flight. Partial sums go to the
// block's own slice of part: no atomics. With DIL the input is the
// zero-dilated half-resolution source (the transposed conv's, see
// tconv3_wgrad_mma_kernel): a product whose input plane or halo row is odd,
// all zeros, is not issued.
template <int TX, bool DIL>
__device__ __forceinline__ void wgrad_mma(const WgradArgs& w) {
  constexpr int TY = WVOX / TX, HX = TX + 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ubuf = smem;               // a ring of 4 input planes: plane zz in slot (zz + 1) & 3
  unsigned char* gbuf = smem + 4 * UBYTES;  // 2 cotangent planes, step z in (z - zb) & 1
  const MmaArgs& p = w.in;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int cob = blockIdx.x % w.nco;
  const int chunk = (blockIdx.x / w.nco) % p.nchunks;
  const int split = blockIdx.x / (w.nco * p.nchunks);
  const int start = static_cast<int>(static_cast<long long>(split) * w.planes / w.nsplit);
  const int end = static_cast<int>(static_cast<long long>(split + 1) * w.planes / w.nsplit);

  if (wg == 3) {  // the stager
#pragma unroll 1
    for (int idx = start; idx < end;) {
      const int tile = idx / p.Z, zb = idx - tile * p.Z;
      const int ze = min(p.Z, zb + (end - idx));
      const int x0 = (tile % p.ntx) * TX, y0 = (tile / p.ntx) * TY;
#pragma unroll 1
      for (int zz = zb - 1; zz <= zb; ++zz)
        stage_halo<128, DIL>(p, chunk, zz, 1, y0, x0, ubuf + ((zz + 1) & 3) * UBYTES, UPL * 16);
#pragma unroll 1
      for (int z = zb; z < ze; ++z) {
        const int par = (z - zb) & 1;
        if (z >= zb + 2) bar_sync(BAR_EMPTY + par);  // step z - 2 is done with these buffers
        stage_halo<128, DIL>(p, chunk, z + 1, 1, y0, x0, ubuf + ((z + 2) & 3) * UBYTES,
                             UPL * 16);
        stage_cotangent<TX, 128>(w, z, y0, x0, cob * WCO, gbuf + par * GBYTES);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(BAR_FULL + par);
      }
#pragma unroll 1
      for (int z = max(zb, ze - 2); z < ze; ++z) bar_sync(BAR_EMPTY + ((z - zb) & 1));
      idx += ze - zb;
    }
    return;
  }

  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[t][k] = 0.0f;
  uint32_t frag[2][4];

  // B descriptor: no swizzle, MN-major; core matrices lie 128 bytes (LBO)
  // apart along K (voxels) and a staged plane's group (SBO) apart along N
  // (8 input channels)
  constexpr uint64_t B_HI = (8ull << 16) | (static_cast<uint64_t>(UPL) << 32);
  const uint32_t u_lo = smem_u32(ubuf) >> 4;
  // ldmatrix.x4.trans: lane l gives row l % 8 of 8 x 8 matrix l / 8 = (k half,
  // 8-channel group of this warp's 16 rows); the fragment is wgmma's A
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const uint32_t g_lane = smem_u32(gbuf) + ((2 * wq + ((lane >> 3) & 1)) * GSTR +
                                            9 * (lane >> 4) + (lane & 7)) * 16;

#pragma unroll 1
  for (int idx = start; idx < end;) {
    const int tile = idx / p.Z, zb = idx - tile * p.Z;
    const int ze = min(p.Z, zb + (end - idx));
    const int y0 = (tile / p.ntx) * TY;
#pragma unroll 1
    for (int z = zb; z < ze; ++z) {
      const int par = (z - zb) & 1;
      const bool zlive = !DIL || ((z - 1 + wg) & 1) == 0;  // input plane z - 1 + dz is even
      bar_sync(BAR_FULL + par);
      const uint32_t g_z = g_lane + par * GBYTES;
      const uint32_t b_z = u_lo + ((z + wg) & 3) * (UBYTES >> 4);  // input plane z - 1 + dz
#pragma unroll
      for (int ks = 0; ks < WVOX / 16; ++ks) {
        uint32_t* a = frag[ks & 1];
        if (ks >= 2) {  // the products of step ks - 2 are done with this fragment
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
          for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
        }
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
            : "r"(g_z + ks * 18 * 16));
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int k = 0; k < 8; ++k) asm volatile("" : "+f"(acc[t][k])::"memory");
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const int ly = ks * 16 / TX, lx = ks * 16 % TX;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          if (!zlive || (DIL && ((y0 + ly + dy - 1) & 1))) continue;  // an all-zero row
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            wgmma_rs16(acc[dy * 3 + dx], a,
                       B_HI | static_cast<uint64_t>(b_z + (ly + dy) * HX + lx + dx));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int k = 0; k < 8; ++k) asm volatile("" : "+f"(acc[t][k])::"memory");
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(frag[s][i])::"memory");
      bar_arrive(BAR_EMPTY + par);
    }
    idx += ze - zb;
  }

  // Accumulator fragment: this thread holds rows (cotangent channels)
  // 16 * (warp in group) + lane / 4 and + 8, columns (input channels)
  // 8j + 2 * (lane % 4) + e
  const int CiP = 16 * p.nchunks, CoP = WCO * w.nco;
  float* base = w.part + static_cast<long long>(split) * 27 * CiP * CoP;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cob * WCO + 16 * wq + (lane >> 2) + 8 * h;
          const int ci = chunk * 16 + 8 * j + 2 * (lane & 3) + e;
          base[(static_cast<long long>(9 * wg + t) * CiP + ci) * CoP + co] =
              acc[t][4 * j + 2 * h + e];
        }
}

template <int TX>
__global__ void __launch_bounds__(WG_THREADS, 1) wgrad3x3_mma_kernel(const WgradArgs w) {
  wgrad_mma<TX, false>(w);
}

// The transposed conv's weight gradient: its forward is the SAME conv of the
// zero-dilated input D with flipped taps (tconv3_mma_kernel), so dW'[tap] =
// sum_o D[o + tap - 1] g_y[o] is this kernel over D (the wrapper flips the
// taps back). 7 of 8 staged values are zeros; of the 27 products a step, those
// whose input plane or row is odd are not issued, which leaves a quarter of
// them: twice the useful operations (the odd columns remain). Its own name
// keeps its time apart in a profile.
template <int TX>
__global__ void __launch_bounds__(WG_THREADS, 1) tconv3_wgrad_mma_kernel(const WgradArgs w) {
  wgrad_mma<TX, true>(w);
}

// dW[tap, ci, co]: the splits' partial sums added in split order (the same
// inputs give the same bits). Input channel ci is packed channel ci below
// Ca, else CaP + ci - Ca.
__device__ __forceinline__ void wgrad_reduce(const float* __restrict__ part,
                                             float* __restrict__ out, int nsplit, int Ca, int CaP,
                                             int Cin, int CiP, int Cout, int CoP) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 27LL * Cin * Cout) return;
  const int co = static_cast<int>(i % Cout);
  const long long r = i / Cout;
  const int ci = static_cast<int>(r % Cin), tap = static_cast<int>(r / Cin);
  const int cip = ci < Ca ? ci : CaP + ci - Ca;
  const long long stride = 27LL * CiP * CoP;
  const float* src = part + (static_cast<long long>(tap) * CiP + cip) * CoP + co;
  float s = 0.0f;
  for (int k = 0; k < nsplit; ++k) s += src[k * stride];
  out[i] = s;
}

__global__ void wgrad3x3_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int nsplit, int Ca, int CaP, int Cin, int CiP, int Cout,
                                       int CoP) {
  wgrad_reduce(part, out, nsplit, Ca, CaP, Cin, CiP, Cout, CoP);
}

__global__ void tconv3_wgrad_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int nsplit, int Ca, int CaP,
                                           int Cin, int CiP, int Cout, int CoP) {
  wgrad_reduce(part, out, nsplit, Ca, CaP, Cin, CiP, Cout, CoP);
}

template <int TX, bool DIL>
int launch_wgrad(const WgradArgs& w, cudaStream_t stream) {
  const auto kernel = DIL ? tconv3_wgrad_mma_kernel<TX> : wgrad3x3_mma_kernel<TX>;
  static bool allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = true;
  }
  kernel<<<w.nco * w.in.nchunks * w.nsplit, WG_THREADS, WG_SMEM, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every product of the conv family but the weight gradients, in the form the
// caller chooses (ops/cuda/conv3d.py: FMA_BELOW picks FMA or PLAIN for a
// forward conv): FMA and PLAIN are the fused conv over the sources [xa, xb]
// (xb absent, at full resolution, or at half resolution with b_lowres); RES
// adds res (Z, Cout, Y*X), laid out as out, to the rounded conv before the
// ReLU; TCONV is the transposed 3^3 stride-2 conv of the half-resolution xb
// alone (Ca = 0, b_lowres; w the pack of the flipped taps, W'[dz, dy, dx,
// ci, co] = Wt[ci, co, 2 - dz, 2 - dy, 2 - dx]), res its skip or null;
// TDGRAD is the transposed conv's input gradient, the conv of the cotangent
// xa alone (w the pack of W'[dz, dy, dx, co, ci] = Wt[ci, co, dz, dy, dx])
// at the even sizes (Z, Y, X), out (Z/2, Cout, Y/2*X/2), with no affine,
// bias, ReLU or stats. The
// input gradient is PLAIN over the cotangent xa with the flipped,
// channel-swapped pack w'[tap, co, ci] = W[26 - tap, ci, co], its output
// channels [0, Csplit) in out (Z, Csplit, Y*X) and the rest in out_b (null
// when Csplit == Cout). FMA: w is the fp32 (Cin, 27, nblk) tensor of
// bf16-rounded values with nblk = Cout padded to 16, and n_tiles counts 4 x 8
// x 32 tiles. Otherwise w is the bf16 pack [Cout block][chunk][2][27][nblk][8],
// (tx, ty, mstride) the tile geometry, n_tiles its 2 x ty x tx tiles, and vec
// says that 16-byte loads along x are aligned (res's too). stats, if given,
// is (n_tiles, Cout, 2). Refuses what no instantiation computes: another
// form, a residual outside RES and TCONV, a split outside PLAIN, TCONV over
// another source, TDGRAD with more than its one source or an epilogue
// operand, a half-resolution source or TDGRAD at odd sizes, and (run_mma,
// run_fma) an nblk the form does not build.
KM_EXPORT int km_conv3x3(const void* xa, const void* xb, const void* scale, const void* shift,
                         const void* w, const void* bias, const void* res, void* out, void* out_b,
                         void* stats, int Z, int Y, int X, int Ca, int Cb, int Cout, int Csplit,
                         int nblk, int form, int b_lowres, int relu, int tx, int ty, int mstride,
                         int vec, int n_tiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = Csplit != Cout || out_b != nullptr;
  if (form < PLAIN || form > TDGRAD || (res != nullptr && form != RES && form != TCONV) ||
      (split && (form != PLAIN || Csplit < 1 || Csplit >= Cout || out_b == nullptr)) ||
      (form == TCONV && (Ca != 0 || !b_lowres)) ||
      (form == TDGRAD && (Ca < 1 || Cb != 0 || xb != nullptr || b_lowres || scale != nullptr ||
                          shift != nullptr || bias != nullptr || relu || stats != nullptr)) ||
      ((b_lowres || form == TDGRAD) && ((Z | Y | X) & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == FMA) {
    FmaArgs p;
    p.xa = static_cast<const __nv_bfloat16*>(xa);
    p.xb = static_cast<const __nv_bfloat16*>(xb);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.w = static_cast<const float*>(w);
    p.bias = static_cast<const float*>(bias);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.stats = static_cast<float*>(stats);
    p.Z = Z; p.Y = Y; p.X = X; p.Ca = Ca; p.Cb = Cb;
    p.Cout = Cout; p.CoutP = nblk; p.b_lowres = b_lowres; p.relu = relu;
    return run_fma(p, n_tiles, st);
  }
  MmaArgs p{};
  p.xa = static_cast<const __nv_bfloat16*>(xa);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_b = static_cast<__nv_bfloat16*>(out_b);
  p.stats = static_cast<float*>(stats);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.Z = Z; p.Y = Y; p.X = X; p.Ca = Ca; p.Cb = Cb;
  p.Cout = Cout; p.Csplit = Csplit; p.b_lowres = b_lowres; p.relu = relu; p.vec = vec;
  return run_mma(p, nblk, tx, ty, mstride, n_tiles, st, form);
}

// The weight gradient dW[tap, ci, co] of the conv km_conv3x3 computes, into
// out (27, Ca + Cb, Cout) fp32: its inputs as km_conv3x3 takes them (the
// affine, pad0, the half-resolution source) against the bf16 cotangent gv
// (Z, Cout, Y*X) of its pre-ReLU output. With dil, the form TCONV's: the
// half-resolution xb alone (Ca = 0, b_lowres, no affine), zero-dilated, with
// tconv3_wgrad_mma_kernel and tconv3_wgrad_reduce_kernel. tx is the plane
// tile's width (16 or 32; 256 / tx rows), vec as for km_conv3x3 (and gv
// aligned alike), nsplit the runs of tile planes the voxels are cut into, and
// part their (nsplit, 27, CiP, CoP) fp32 partial sums (CiP the packed
// channels, CoP Cout rounded up to 64), summed in order by a second kernel.
KM_EXPORT int km_conv3x3_weight_grad(const void* xa, const void* xb, const void* scale,
                                     const void* shift, const void* gv, void* part, void* out,
                                     int Z, int Y, int X, int Ca, int Cb, int Cout, int b_lowres,
                                     int dil, int tx, int vec, int nsplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WgradArgs w{};
  MmaArgs& p = w.in;
  p.xa = static_cast<const __nv_bfloat16*>(xa);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.Z = Z; p.Y = Y; p.X = X; p.Ca = Ca; p.Cb = Cb;
  p.Cout = Cout; p.Csplit = Cout; p.b_lowres = b_lowres; p.vec = vec;
  p.TX = tx; p.TY = WVOX / tx; p.HX = tx + 2; p.HY = p.TY + 2;
  p.ntx = km::ceil_div(X, tx);
  p.nty = km::ceil_div(Y, p.TY);
  p.CaP = (Ca + 7) / 8 * 8;
  p.nchunks = (p.CaP + (Cb + 7) / 8 * 8 + 15) / 16;
  w.gv = static_cast<const __nv_bfloat16*>(gv);
  w.part = static_cast<float*>(part);
  w.nco = km::ceil_div(Cout, WCO);
  w.nsplit = nsplit;
  const long long planes = static_cast<long long>(p.ntx) * p.nty * Z;
  if ((tx != 16 && tx != 32) || p.HY * p.HX > UPL || Cb < 0 || Cout < 1 || nsplit < 1 ||
      nsplit > planes || planes > 0x7fffffffLL || (b_lowres && ((Z | Y | X) & 1)) ||
      (dil ? Ca != 0 || Cb < 1 || !b_lowres || scale != nullptr || shift != nullptr : Ca < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  w.planes = static_cast<int>(planes);
  const int err = dil ? (tx == 16 ? launch_wgrad<16, true>(w, st) : launch_wgrad<32, true>(w, st))
                      : (tx == 16 ? launch_wgrad<16, false>(w, st) : launch_wgrad<32, false>(w, st));
  if (err != 0) return err;
  const long long n = 27LL * (Ca + Cb) * Cout;
  const auto reduce = dil ? tconv3_wgrad_reduce_kernel : wgrad3x3_reduce_kernel;
  reduce<<<km::ceil_div(n, 256), 256, 0, st>>>(w.part, static_cast<float*>(out), nsplit, Ca, p.CaP,
                                               Ca + Cb, 16 * p.nchunks, Cout, WCO * w.nco);
  return static_cast<int>(cudaGetLastError());
}
