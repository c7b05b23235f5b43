// The heatmaps' producer and their consumer: the U-Nets' final 1x1 conv
// (final1x1_mma_kernel, ops/cuda/heatmap.py:final_conv1x1), which writes them,
// and the keypoint head (heatmap_moments_kernel, heatmap_finish_kernel,
// ops/cuda/heatmap.py:heatmap_com), which reads them once.
//
// final1x1_mma_kernel: for each voxel v of a volume's flat (Z, Cin, Y*X)
// bf16 features x and each output channel k,
//
//   heat[v, k] = bf16(sum_c bf16(x[c, v]) * bf16(W[k, c]) + b[k])
//
// bf16 operands, fp32 products and sums, the fp32 bias, one rounding (what
// both executors' plain route computes, but for the order of the fp32 sum),
// written channel-last (Z, Y, X, K) straight into the heatmaps the executor
// returns. It replaces no TPU kernel: keymorph_tpu leaves the final conv to
// XLA (an einsum, keymorph_tpu/models/fast_unet.py:504). It exists because
// the torch form of that einsum made an fp32 copy of the features, an fp32
// product of the whole heatmaps (2.15 GB for 256 channels at 128^3), an fp32
// bias pass over it and a bf16 cast, then stacked the volumes: five passes
// over heatmaps that need one write.
//
// Bound: bytes. 32 -> 256 channels is 2 Cin K = 16,384 operations a voxel
// for 2 Cin + 2 K = 576 bytes moved, ~28 a byte against the ~295 at which
// the tensor cores would be the limit; at 128^3 the features are 134 MB, the
// heatmaps 1.07 GB, 0.36 ms at 3.35 TB/s. So the design streams the output:
//   * a persistent grid (the blocks that fit an SM, times the SMs); W
//     (rounded to bf16) and the fp32 bias are staged once a block;
//   * a block walks tiles of 1024 voxels of one plane (8 warps, 4 tiles of
//     32 voxels each), one ahead: the next tile's Cin x 1024 features come
//     in by cp.async (16-byte chunks, a warp's 32 a 512-byte run of one
//     channel row; zero-filled past the plane) while this tile is computed;
//   * mma.sync m16n8k16 (bf16 in, fp32 sums): A from the staged features by
//     ldmatrix.trans (the features lie a channel row at a time, A's rows are
//     voxels), B from the staged W by ldmatrix; 64 output channels a pass,
//     64 fp32 sums a thread. wgmma would need a warpgroup and 64-voxel tiles
//     for a product that takes a few percent of the time the writes do;
//     with mma.sync each warp computes and stores its own tiles;
//   * the epilogue adds the bias in fp32, rounds once, stages the 32 x 64
//     block in shared memory (rows 144 bytes apart: the stores of a quad's
//     eight rows fall on 32 distinct banks) and writes it back as 16-byte
//     streaming stores (st.global.cs), eight lanes a 128-byte run of one
//     voxel's channels: every heatmap byte is written once, by full,
//     coalesced stores.
// Measured on an NVIDIA H100 80GB HBM3 (700 W), 32 -> 256: the same kernel
// without its feature loads writes at 2.85 TB/s, 97% of the write bound
// (torch's zero_ of the heatmaps: 3.26 TB/s); with them it runs at 73-76% of
// the whole bound: the 11% of the bytes that are read cost three times their
// share. Reading each channel row in 2-KB runs (1024-voxel tiles) took 2% off
// 32-voxel tiles at 256^3; a deeper ring of tiles (3 to 8) and TMA tensor
// stores of 128-byte-swizzled boxes each measured within 2% of the 32-voxel
// form; a 128-register cap (two blocks an SM) spilled and lost 13%, so a
// block of 8 warps takes the SM.
// Rows of staged features are 2 * (tile + 8) bytes apart and rows of staged
// W Cin + 8 bf16 (odd numbers of 16-byte units), so the eight rows of an
// ldmatrix fall on eight distinct bank groups. Cin is zero-padded to a
// multiple of 16 in shared memory; a ragged plane tail and K that is not a
// multiple of 8 take masked (element) stores, a plane whose Y*X is not a
// multiple of 8 element loads. The caller's plan
// (ops/cuda/heatmap.py:final_conv_plan) sets the warps a block, the warp
// tiles a block tile and the output channels a launch, so that they fit.
//
// The keypoint head: for each channel c of each batch item, the
// four fp32 moments of r = relu(v) (NaN propagating, as torch.relu),
//
//   S0 = sum r,   S_k = sum r * t_k(i_k)   (k each spatial axis),
//
// t_k the fp32 linspace(0, 1, N_k) the plain version weights by (a table the
// wrapper passes in), then the keypoints S_k / (S0 + 1e-8) * 2 - 1, (B, C, d)
// fp32. It replaces no TPU kernel: keymorph_tpu takes the centre of mass as
// plain XLA (keymorph_tpu/models/layers.py:19). The plain version writes a
// ReLU copy of the heatmaps and reads it three times, once a marginal sum.
//
// Bound: bytes. The heatmaps are read once (256 bf16 channels at 256^3 are
// 8.59 GB, 2.56 ms at 3.35 TB/s); the work is two fp32 operations an element.
//
// heatmap_moments_kernel: the input is channel-last (B, Z, Y, X, C), so a
// voxel's C values are one contiguous row. A thread owns E consecutive
// channels, one 16-byte load (E = 8 bf16 or 4 fp32; element loads where a
// voxel row is not 16-byte aligned), and neighbouring threads own
// neighbouring chunks, then the next voxel's: a block's loads are one
// contiguous stretch. A block walks a fixed run of x-rows (z, y) of one item,
// the row's (z, y) from one division a row. Bytes in flight decide the rate:
// a thread issues HM_UNROLL loads (128 bytes) before it sums any, and keeps
// only the row's sums of r and r * t_x in registers; its four moments live in
// shared memory, updated once a row (S0, S_x, and with t_y, t_z, S_y, S_z):
// two operations an element. (Register-held moments cost 127 registers, two
// blocks an SM and 2.05 TB/s; in shared memory, with 8 loads in flight, the
// read runs at 3.07 TB/s on an NVIDIA H100 80GB HBM3, the rate of one
// torch.sum over the same tensor.) The block's threads then reduce their
// moments in a fixed order into one row of partial moments (4, C) in scratch.
//
// heatmap_finish_kernel: sums each item's partial rows in a fixed order
// (FIN_SLICES strided slices, then the slices in order) and writes the
// keypoints. No atomics: the same input gives the same bits, and the row runs
// depend on the item's shape alone, so a batch gives each item the bits it
// gets alone.
#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int HM_THREADS = 256;
constexpr int HM_UNROLL = 8;    // voxel loads a thread keeps in flight (128 bytes)
constexpr int FIN_CH = 8;        // channels a finish block
constexpr int FIN_SLICES = 32;   // slices of the partial rows a finish block sums apart

__device__ __forceinline__ float relu_nan(float v) { return v != v ? v : fmaxf(v, 0.0f); }

template <typename T>
struct Elems;

template <>
struct Elems<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static float one(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  // a 16-byte word of 8 bf16 values: each is the high half of its fp32 value
  __device__ static void unpack(const uint4& w, float* f) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <>
struct Elems<float> {
  static constexpr int E = 4;
  __device__ static float one(const float* p) { return *p; }
  __device__ static void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};

// x (B, Z*Y rows, X, C); t: t_z (Z), t_y (Y), t_x (X); part (B, P, 4, C): a
// block's moments (S0, S_z, S_y, S_x) of rows [blockIdx.x * rows, +rows) and
// channel chunks [blockIdx.y * nchb, +nchb).
template <typename T, bool VEC>
__global__ void __launch_bounds__(HM_THREADS)
    heatmap_moments_kernel(const T* __restrict__ x, const float* __restrict__ t,
                           float* __restrict__ part, int B, int Z, int Y, int X, int C, int rows,
                           int P) {
  constexpr int E = Elems<T>::E;
  __shared__ float red[4 * E * HM_THREADS];
  const int nch = (C + E - 1) / E;             // channel chunks a voxel
  const int nchb = min(nch, HM_THREADS);       // ... a block
  const int vpar = HM_THREADS / nchb;          // voxels a step
  const int tid = threadIdx.x;
  const int lane = tid / nchb;
  const int chunk = blockIdx.y * nchb + (tid - lane * nchb);
  const bool active = lane < vpar && chunk < nch;
  const int nvalid = C - chunk * E;            // channels of the chunk that exist
  const long long R = static_cast<long long>(Z) * Y;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = min(R, r0 + rows);
  const float* tz = t;
  const float* ty = t + Z;
  const float* tx = t + Z + Y;
  const int step = HM_UNROLL * vpar;
  // the thread's moments, (moment, channel of the chunk) major and thread
  // minor: updated once a row, then the block's reduction reads them (a
  // lane's values for one chunk lie nchb apart)
  float* acc = red + tid;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
#pragma unroll
    for (int i = 0; i < 4 * E; ++i) acc[i * HM_THREADS] = 0.0f;
    if (active) {
      for (long long r = r0; r < r1; ++r) {
        const int z = static_cast<int>(r / Y);
        const int y = static_cast<int>(r - static_cast<long long>(z) * Y);
        const T* row = x + ((static_cast<long long>(b) * R + r) * X) * C +
                       static_cast<long long>(chunk) * E;
        float rs[E], rx[E];
#pragma unroll
        for (int e = 0; e < E; ++e) rs[e] = rx[e] = 0.0f;
        // one voxel's chunk into the row's sums
        auto add = [&](const float* f, int xi) {
          const float wx = xi < X ? __ldg(tx + xi) : 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float rv = relu_nan(f[e]);
            rs[e] += rv;
            rx[e] = fmaf(rv, wx, rx[e]);
          }
        };
        for (int x0 = lane; x0 < X; x0 += step) {
          if constexpr (VEC) {
            uint4 w[HM_UNROLL];
#pragma unroll
            for (int j = 0; j < HM_UNROLL; ++j) {
              const int xi = x0 + j * vpar;
              w[j] = xi < X ? __ldg(reinterpret_cast<const uint4*>(
                                  row + static_cast<long long>(xi) * C))
                            : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int j = 0; j < HM_UNROLL; ++j) {
              float f[E];
              Elems<T>::unpack(w[j], f);
              add(f, x0 + j * vpar);
            }
          } else {
#pragma unroll
            for (int j = 0; j < HM_UNROLL; ++j) {
              const int xi = x0 + j * vpar;
              const T* p = row + static_cast<long long>(xi) * C;
              float f[E];
#pragma unroll
              for (int e = 0; e < E; ++e)
                f[e] = (xi < X && e < nvalid) ? Elems<T>::one(p + e) : 0.0f;
              add(f, xi);
            }
          }
        }
        const float wy = __ldg(ty + y), wz = __ldg(tz + z);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc[(0 * E + e) * HM_THREADS] += rs[e];
          acc[(1 * E + e) * HM_THREADS] = fmaf(rs[e], wz, acc[(1 * E + e) * HM_THREADS]);
          acc[(2 * E + e) * HM_THREADS] = fmaf(rs[e], wy, acc[(2 * E + e) * HM_THREADS]);
          acc[(3 * E + e) * HM_THREADS] += rx[e];
        }
      }
    }
    __syncthreads();
    float* out = part + (static_cast<long long>(b) * P + blockIdx.x) * 4 * C;
    for (int o = tid; o < 4 * E * nchb; o += HM_THREADS) {
      const int ke = o / nchb, ch = o - ke * nchb;
      const int k = ke / E, e = ke - k * E;
      const int c = (blockIdx.y * nchb + ch) * E + e;
      if (c >= C) continue;
      float s = 0.0f;
      for (int l = 0; l < vpar; ++l) s += red[ke * HM_THREADS + l * nchb + ch];
      out[static_cast<long long>(k) * C + c] = s;
    }
    __syncthreads();
  }
}

// part (B, P, 4, C) -> out (B, C, d): the last d of (z, y, x), in that order.
__global__ void __launch_bounds__(4 * FIN_CH * FIN_SLICES)
    heatmap_finish_kernel(const float* __restrict__ part, float* __restrict__ out, int B, int C,
                          int P, int d) {
  __shared__ float red[FIN_SLICES][4 * FIN_CH + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // tx: moment * FIN_CH + channel
  const int k = tx / FIN_CH, cc = tx - k * FIN_CH;
  const int c = blockIdx.x * FIN_CH + cc;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float s = 0.0f;
    if (c < C) {
      const float* p =
          part + static_cast<long long>(b) * P * 4 * C + static_cast<long long>(k) * C + c;
#pragma unroll 8
      for (int i = ty; i < P; i += FIN_SLICES) s += p[static_cast<long long>(i) * 4 * C];
    }
    red[ty][tx] = s;
    __syncthreads();
    if (ty == 0 && k == 0 && c < C) {
      float m[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a = 0.0f;
        for (int j = 0; j < FIN_SLICES; ++j) a += red[j][kk * FIN_CH + cc];
        m[kk] = a;
      }
      const float den = m[0] + 1e-8f;
      for (int i = 0; i < d; ++i)
        out[(static_cast<long long>(b) * C + c) * d + i] = m[4 - d + i] / den * 2.0f - 1.0f;
    }
    __syncthreads();
  }
}

template <typename T, bool VEC>
void launch_moments(const void* x, const float* t, float* part, int B, int Z, int Y, int X, int C,
                    int rows, int P, int groups, cudaStream_t stream) {
  const dim3 grid(P, groups, std::min(B, km::kMaxGridY));
  heatmap_moments_kernel<T, VEC><<<grid, HM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), t, part, B, Z, Y, X, C, rows, P);
}

// ---------------------------------------------------------------------------
// final1x1_mma_kernel

constexpr int FC_VOX = 32;           // voxels a warp tile: two m16 row blocks
constexpr int FC_NCH = 64;           // output channels a pass: eight n8 tiles
constexpr int FC_SROW = FC_NCH + 8;  // bf16 a staged output row (144 bytes)
constexpr int FC_MAX_WARPS = 8;
constexpr int FC_MAX_TPW = 4;
constexpr int FC_MAX_SMEM = 232448;  // shared bytes a block may opt in to

__host__ __device__ inline int fc_cinp(int cin) { return (cin + 15) / 16 * 16; }
__host__ __device__ inline int fc_nkp(int nk) { return (nk + FC_NCH - 1) / FC_NCH * FC_NCH; }
// bf16 a staged feature row: the block tile's voxels and 8 more, an odd
// number of 16-byte units (the tile is a multiple of 32 voxels)
__host__ __device__ inline int fc_xrow(int warps, int tpw) { return warps * tpw * FC_VOX + 8; }

// Shared bytes of a block of `warps` warps, `tpw` warp tiles each a block
// tile, for Cin and a launch of nk output channels: the fp32 bias and bf16 W
// of the launch's channels (padded to FC_NCH), two block tiles of features,
// and a staged output block a warp (ops/cuda/heatmap.py:final_conv_smem
// mirrors it).
inline long long fc_smem_bytes(int cin, int nk, int warps, int tpw) {
  const long long cinp = fc_cinp(cin), nkp = fc_nkp(nk);
  return nkp * 4 + nkp * (cinp + 8) * 2 + 2 * cinp * fc_xrow(warps, tpw) * 2 +
         static_cast<long long>(warps) * FC_VOX * FC_SROW * 2;
}

__device__ __forceinline__ uint32_t fc_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fc_ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void fc_ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void fc_mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block tile's Cin x bv features of plane z from voxel v0 into dst (rows
// xrow apart), by all the block's threads: 16-byte cp.async chunks (VIN: the
// volume 16-byte aligned and Y*X a multiple of 8, so a chunk lies wholly
// inside the plane or wholly past it, and is then zero-filled), a warp's 32
// a 512-byte run of one channel row, each asking L2 for its 256-byte line;
// else element loads. Rows past Cin are left as they are (zero).
template <bool VIN>
__device__ __forceinline__ void fc_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                             long long z, long long v0, int bv, int xrow, int Cin,
                                             long long YX) {
  const __nv_bfloat16* src = x + z * Cin * YX + v0;
  if constexpr (VIN) {
    const int chunks = bv / 8;
    for (int i = threadIdx.x; i < Cin * chunks; i += blockDim.x) {
      const int c = i / chunks, q = i - c * chunks;
      const bool in = v0 + q * 8 < YX;
      const __nv_bfloat16* s = in ? src + c * YX + q * 8 : x;
      asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                       fc_smem_u32(dst + c * xrow + q * 8)),
                   "l"(s), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < Cin * bv; i += blockDim.x) {
      const int c = i / bv, v = i - c * bv;
      dst[c * xrow + v] = v0 + v < YX ? src[c * YX + v] : __float2bfloat16_rn(0.0f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// heat (Z, Y*X, K) channels [n0, n0 + nk) <- x (Z, Cin, Y*X) and w (K, Cin)
// fp32 (rounded to bf16 here), b (K,) fp32; blocks of blockDim.x / 32 warps,
// tpw warp tiles each a block tile. VOUT: 16-byte stores (heat 16-byte
// aligned, K, n0 and nk multiples of 8).
template <bool VIN, bool VOUT>
__global__ void __launch_bounds__(FC_MAX_WARPS * 32, 1)
    final1x1_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, __nv_bfloat16* __restrict__ heat, int Z,
                        int Cin, long long YX, int K, int n0, int nk, int tpw) {
  extern __shared__ __align__(16) unsigned char fc_raw[];
  const int cinp = fc_cinp(Cin), wrow = cinp + 8, nkp = fc_nkp(nk);
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bv = nwarps * tpw * FC_VOX, xrow = fc_xrow(nwarps, tpw);
  float* bs = reinterpret_cast<float*>(fc_raw);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(bs + nkp);
  __nv_bfloat16* xs = ws + nkp * wrow;                               // [2][cinp][xrow]
  __nv_bfloat16* st = xs + 2 * cinp * xrow + warp * FC_VOX * FC_SROW;  // this warp's block

  for (int i = threadIdx.x; i < nkp * wrow; i += blockDim.x) {
    const int n = i / wrow, c = i - n * wrow;
    ws[i] = __float2bfloat16_rn(n < nk && c < Cin ? w[static_cast<long long>(n0 + n) * Cin + c]
                                                  : 0.0f);
  }
  for (int n = threadIdx.x; n < nkp; n += blockDim.x) bs[n] = n < nk ? b[n0 + n] : 0.0f;
  for (int i = threadIdx.x; i < 2 * cinp * xrow; i += blockDim.x)
    xs[i] = __float2bfloat16_rn(0.0f);
  __syncthreads();

  const long long per_plane = (YX + bv - 1) / bv;
  const long long tiles = Z * per_plane;
  long long t = blockIdx.x;
  if (t < tiles) fc_load_tile<VIN>(xs, x, t / per_plane, t % per_plane * bv, bv, xrow, Cin, YX);
  const int g = lane >> 2, tq = lane & 3;  // the mma fragments' row and column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: the lane's matrix and row
  int buf = 0;
  for (; t < tiles; t += gridDim.x, buf ^= 1) {
    if (t + gridDim.x < tiles) {
      const long long tn = t + gridDim.x;
      fc_load_tile<VIN>(xs + (buf ^ 1) * cinp * xrow, x, tn / per_plane, tn % per_plane * bv, bv,
                        xrow, Cin, YX);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const long long z = t / per_plane;
    for (int j = 0; j < tpw; ++j) {
      // the block's warps take neighbouring 32-voxel tiles, then the next run
      const int sub = (j * nwarps + warp) * FC_VOX;
      const long long v0 = t % per_plane * bv + sub;
      if (v0 >= YX) break;
      const int rows = static_cast<int>(YX - v0 < FC_VOX ? YX - v0 : FC_VOX);
      const __nv_bfloat16* xb = xs + buf * cinp * xrow + sub;
      __nv_bfloat16* out = heat + (z * YX + v0) * K + n0;
      for (int nc = 0; nc < nkp; nc += FC_NCH) {
        float acc[2][8][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int jn = 0; jn < 8; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][jn][e] = 0.0f;
        for (int k0 = 0; k0 < cinp; k0 += 16) {
          // A (voxels x channels): matrix mi holds voxels (mi & 1) * 8.. and
          // channels k0 + (mi >> 1) * 8.., stored channel-major: transposed
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            fc_ldmatrix_x4_trans(
                a[m], fc_smem_u32(xb + (k0 + (mi >> 1) * 8 + mr) * xrow + m * 16 + (mi & 1) * 8));
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            // B (channels x outputs) of two n8 tiles: matrix mi holds outputs
            // nc + jp * 16 + (mi >> 1) * 8.. and channels k0 + (mi & 1) * 8..
            uint32_t bb[4];
            fc_ldmatrix_x4(bb, fc_smem_u32(ws + (nc + jp * 16 + (mi >> 1) * 8 + mr) * wrow + k0 +
                                           (mi & 1) * 8));
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              fc_mma(acc[m][2 * jp], a[m], bb[0], bb[1]);
              fc_mma(acc[m][2 * jp + 1], a[m], bb[2], bb[3]);
            }
          }
        }
        // the bias in fp32, one rounding, into the warp's staged block
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int col = jn * 8 + 2 * tq;
          const float b0 = bs[nc + col], b1 = bs[nc + col + 1];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            *reinterpret_cast<__nv_bfloat162*>(st + (m * 16 + g) * FC_SROW + col) =
                __floats2bfloat162_rn(acc[m][jn][0] + b0, acc[m][jn][1] + b1);
            *reinterpret_cast<__nv_bfloat162*>(st + (m * 16 + g + 8) * FC_SROW + col) =
                __floats2bfloat162_rn(acc[m][jn][2] + b0, acc[m][jn][3] + b1);
          }
        }
        __syncwarp();
        // 32 voxels x 64 channels out: eight lanes a voxel's 128 bytes
        const int ch = (lane & 7) * 8, n = nc + ch;
#pragma unroll
        for (int i = 0; i < FC_VOX / 4; ++i) {
          const int r = i * 4 + (lane >> 3);
          if (r >= rows) break;
          const __nv_bfloat16* s = st + r * FC_SROW + ch;
          __nv_bfloat16* d = out + static_cast<long long>(r) * K + n;
          if constexpr (VOUT) {
            if (n < nk) __stcs(reinterpret_cast<uint4*>(d), *reinterpret_cast<const uint4*>(s));
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (n + e < nk) d[e] = s[e];
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool VIN, bool VOUT>
int launch_final1x1(const __nv_bfloat16* x, const float* w, const float* b, __nv_bfloat16* heat,
                    int Z, int Cin, long long YX, int K, int n0, int nk, int warps, int tpw,
                    cudaStream_t stream) {
  const auto kernel = final1x1_mma_kernel<VIN, VOUT>;
  static bool allowed[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FC_MAX_SMEM);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = true;
  }
  const int smem = static_cast<int>(fc_smem_bytes(Cin, nk, warps, tpw));
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int bv = warps * tpw * FC_VOX;
  const long long tiles = static_cast<long long>(Z) * ((YX + bv - 1) / bv);
  const int blocks = static_cast<int>(std::min<long long>(tiles, static_cast<long long>(per_sm) * sms[dev]));
  kernel<<<blocks, warps * 32, smem, stream>>>(x, w, b, heat, Z, Cin, YX, K, n0, nk, tpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, Z, Y, X, C) contiguous, bf16 (fp32 = 0) or fp32 (fp32 = 1); vec = 1:
// 16-byte loads (x 16-byte aligned and C * itemsize a multiple of 16); t
// (Z + Y + X,) fp32: linspace(0, 1, N) of each axis; part (B, P, 4, C) fp32
// scratch with P = ceil(Z * Y / rows); out (B, C, d) fp32, the keypoints of
// the last d axes (a 2D heatmap is Z = 1, a 1D one Z = Y = 1).
KM_EXPORT int km_heatmap_com(const void* x, int fp32, int vec, const void* t, void* part,
                             void* out, int B, int Z, int Y, int X, int C, int d, int rows, int P,
                             void* stream) {
  const long long R = static_cast<long long>(Z) * Y;
  const int E = fp32 ? 4 : 8;
  const int nch = (C + E - 1) / E;
  const int groups = km::ceil_div(nch, HM_THREADS);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (static_cast<long long>(C) * (fp32 ? 4 : 2)) % 16 == 0;
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || C < 1 || d < 1 || d > 3 || rows < 1 ||
      P != (R + rows - 1) / rows || groups > km::kMaxGridY || (vec && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(t);
  float* pf = static_cast<float*>(part);
  if (fp32) {
    if (vec)
      launch_moments<float, true>(x, tf, pf, B, Z, Y, X, C, rows, P, groups, s);
    else
      launch_moments<float, false>(x, tf, pf, B, Z, Y, X, C, rows, P, groups, s);
  } else {
    if (vec)
      launch_moments<__nv_bfloat16, true>(x, tf, pf, B, Z, Y, X, C, rows, P, groups, s);
    else
      launch_moments<__nv_bfloat16, false>(x, tf, pf, B, Z, Y, X, C, rows, P, groups, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(km::ceil_div(C, FIN_CH), std::min(B, km::kMaxGridY));
  heatmap_finish_kernel<<<grid, dim3(4 * FIN_CH, FIN_SLICES), 0, s>>>(pf, static_cast<float*>(out),
                                                                       B, C, P, d);
  return static_cast<int>(cudaGetLastError());
}

// heat (Z, Y, X, K) bf16, channels [n0, n0 + nk) <- the final 1x1 conv of x
// (Z, Cin, Y*X) bf16 with w (K, Cin) fp32 (each rounded to bf16) and b (K,)
// fp32, on a grid of blocks of `warps` warps, `tpw` warp tiles each a block
// tile (final_conv_plan's). Refuses sizes out of range and a launch whose
// shared memory a block cannot hold.
KM_EXPORT int km_final_conv1x1(const void* x, const void* w, const void* b, void* heat, int Z,
                               int Cin, long long YX, int K, int n0, int nk, int warps, int tpw,
                               void* stream) {
  if (Z < 1 || Cin < 1 || YX < 1 || K < 1 || n0 < 0 || nk < 1 ||
      static_cast<long long>(n0) + nk > K || warps < 1 || warps > FC_MAX_WARPS || tpw < 1 ||
      tpw > FC_MAX_TPW || fc_smem_bytes(Cin, nk, warps, tpw) > FC_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vin = reinterpret_cast<uintptr_t>(x) % 16 == 0 && YX % 8 == 0;
  const bool vout = reinterpret_cast<uintptr_t>(heat) % 16 == 0 && K % 8 == 0 && n0 % 8 == 0 &&
                    nk % 8 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* hb = static_cast<__nv_bfloat16*>(heat);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vin && vout)
    return launch_final1x1<true, true>(xb, wf, bf, hb, Z, Cin, YX, K, n0, nk, warps, tpw, s);
  if (vin)
    return launch_final1x1<true, false>(xb, wf, bf, hb, Z, Cin, YX, K, n0, nk, warps, tpw, s);
  if (vout)
    return launch_final1x1<false, true>(xb, wf, bf, hb, Z, Cin, YX, K, n0, nk, warps, tpw, s);
  return launch_final1x1<false, false>(xb, wf, bf, hb, Z, Cin, YX, K, n0, nk, warps, tpw, s);
}
