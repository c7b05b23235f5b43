// Trilinear / nearest warp from ij-ordered coordinate planes (warp_planes)
// and its gradient to the planes (warp_planes_grad).
//
// Replaces keymorph_tpu/ops/pallas/resample3d.py:_kernel (reached through
// _warp_pallas <- _warp_planes_fwd_impl <- warp_planes / warp_grid).
//
//   out[b, c, n] = sum over the 8 clamped corners of img[b, c, corner] * w
//
// with torch grid_sample semantics: padding_mode="border",
// align_corners=False (v = ((p + 1) * N - 1) / 2, clipped to [0, N-1]);
// nearest rounds half to even (rintf). fp32.
//
// warp_planes_grad: the gradient of the trilinear warp to the planes.
// Replaces keymorph_tpu/ops/pallas/resample3d.py:_grad_kernel (reached through
// _grad_pallas <- _grad_planes_impl <- _warp_planes_bwd) together with the
// elementwise chain of _chain_planes. Per output voxel n and axis a,
//
//   g_planes[b, a, n] = mask_a * S_a / 2 * sum_c g[b, c, n] *
//       sum over the other two axes' corners of w_other *
//       (img[b, c, hi_a, ...] - img[b, c, lo_a, ...])
//
// with lo = floor(v), hi = min(lo + 1, S - 1) (the top edge gives exactly 0)
// and mask_a the derivative of the border clamp as jnp.clip defines it: 0
// where the unclamped voxel coordinate lies outside [0, S_a - 1], 0.5 at an
// exact tie with either end, 1 inside. Nearest mode has zero gradient and
// launches nothing.
//
// What bounds both on the H100: memory, and the gathers' round trips. Per
// output voxel the forward reads 12 bytes of planes, gathers 8 * C source
// values and writes 4 * C bytes; the gradient reads 12 bytes of planes and
// 4 * C bytes of cotangent, gathers 8 * C values and writes 12 bytes. The
// planes, the cotangent and the output are streamed once; the source volume
// is the only array read again (a smooth registration flow makes neighbouring
// voxels gather neighbouring source voxels, so most gathers hit L1/L2). The
// time is not the streamed bytes' alone: the 8 gathers a voxel and channel
// are each a round trip the thread waits for before it can store, and with
// many channels they take most of it. PERF.md section 6 has the times
// beside the bound (chip_smoke.py phase 1) and the forms that were tried.
// The TPU kernel's span prepass, window ladder and bf16 one-hot contraction
// existed because Mosaic has no gather; here each thread gathers directly,
// which is exact for any flow.
//
// The design: as many gathers in flight as the registers hold.
//  - A thread owns kVox = 4 output voxels, kThreads apart, so that for each
//    of them a warp's plane loads, gathers and stores cover 32 consecutive
//    voxels, and it has 4 x 8 independent gathers in flight a channel.
//  - Two blocks a SM (128 registers a thread): the weights are formed from
//    the three fractions where they are used, not kept for all corners.
//  - A block walks a contiguous range of tiles (kTile = 1024 voxels: 4 output
//    rows at 256^3, 8 at 128^3) on a grid of as many blocks as are resident
//    at once, and loads the next tile's planes into registers while the
//    current tile gathers.
//  - Cache policy by role: the streamed arrays are read with __ldcs and
//    written with __stcs (evict first), which leaves L1 and L2 to the source
//    volume; the gathers take the read-only path (__ldg).
//  - Offsets within one channel are 32-bit (the wrapper refuses 2^31 voxels
//    a channel); the batch and channel bases are formed once in 64 bits.
//  - Every shape takes the same path: the ragged last tile is masked, and no
//    access needs more than 4-byte alignment. The batch is the grid's y
//    dimension, at most 65535 blocks: a larger batch is walked in steps of
//    that, so any B runs in one launch.
// The forward rounds every operation explicitly (no FMA contraction) in the
// plain version's order, so kernel and plain results agree bit for bit. The
// gradient is the same fp32 terms, FMA-contracted. Every output element has
// one writer: no atomics, deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;           // threads a block
constexpr int kVox = 4;                 // output voxels a thread, kThreads apart
constexpr int kTile = kThreads * kVox;  // output voxels a block step
constexpr int kBlocksPerSM = 2;         // 128 registers a thread: 32 gathers, no spills

using Offset = unsigned;  // a voxel's offset within one channel

__device__ __forceinline__ float unnormalize(float p, int n) {
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(p, 1.0f), static_cast<float>(n)), 1.0f), 0.5f);
  return fminf(fmaxf(v, 0.0f), static_cast<float>(n - 1));
}

// The 8 corners of a voxel coordinate (each axis already clipped to
// [0, S - 1]): flat offsets within one channel, k = 4 cz + 2 cy + cx in
// itertools.product order (the upper corner clamped to S - 1), and the
// fractions t = v - floor(v), which are exact.
struct Corners {
  Offset off[8];
  float tz, ty, tx;
};

__device__ __forceinline__ Corners corners(float vz, float vy, float vx, int Z, int Y, int X) {
  Corners q;
  const float fz = floorf(vz), fy = floorf(vy), fx = floorf(vx);
  q.tz = __fsub_rn(vz, fz);
  q.ty = __fsub_rn(vy, fy);
  q.tx = __fsub_rn(vx, fx);
  const int z0 = static_cast<int>(fz), y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
  const int z1 = min(z0 + 1, Z - 1), y1 = min(y0 + 1, Y - 1), x1 = min(x0 + 1, X - 1);
  const int r00 = (z0 * Y + y0) * X, r01 = (z0 * Y + y1) * X;
  const int r10 = (z1 * Y + y0) * X, r11 = (z1 * Y + y1) * X;
  q.off[0] = r00 + x0;
  q.off[1] = r00 + x1;
  q.off[2] = r01 + x0;
  q.off[3] = r01 + x1;
  q.off[4] = r10 + x0;
  q.off[5] = r10 + x1;
  q.off[6] = r11 + x0;
  q.off[7] = r11 + x1;
  return q;
}

// A thread's kVox voxels are n0 + j * kThreads (n0 = tile start + thread):
// for each j a warp's loads, gathers and stores cover 32 consecutive voxels.
// Streamed arrays are read once (__ldcs) and written once (__stcs); a voxel
// at or above N reads 0 (for the planes a voxel inside the volume) and is
// never stored.
__device__ __forceinline__ void load_stream(const float* d, long long n0, long long N,
                                            float (&r)[kVox]) {
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const long long n = n0 + j * kThreads;
    r[j] = n < N ? __ldcs(d + n) : 0.0f;
  }
}

__device__ __forceinline__ void store_stream(float* d, long long n0, long long N,
                                             const float (&r)[kVox]) {
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const long long n = n0 + j * kThreads;
    if (n < N) __stcs(d + n, r[j]);
  }
}

__device__ __forceinline__ void load_planes(const float* pb, long long n0, long long N,
                                            float (&p)[3][kVox]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) load_stream(pb + a * N, n0, N, p[a]);
}

// Walks this block's tiles, a contiguous range of the batch item's
// ceil(N / kTile), calling tile(planes, n0) for each; the next tile's planes
// are in flight while this tile gathers.
template <typename Tile>
__device__ __forceinline__ void walk(const float* pb, long long N, Tile&& tile) {
  const long long tiles = (N + kTile - 1) / kTile;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  float p[3][kVox];
  if (t0 < t1) load_planes(pb, t0 * kTile + threadIdx.x, N, p);
  for (long long t = t0; t < t1; ++t) {
    const long long n0 = t * kTile + threadIdx.x;
    float cur[3][kVox];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int j = 0; j < kVox; ++j) cur[a][j] = p[a][j];
    if (t + 1 < t1) load_planes(pb, n0 + kTile, N, p);
    if (n0 < N) tile(cur, n0);
  }
}

template <bool kNearest>
__device__ __forceinline__ void warp_tile(const float* __restrict__ src, float* __restrict__ dst,
                                          const float (&p)[3][kVox], long long n0, int C,
                                          int Z, int Y, int X, long long N, long long V) {
  if (kNearest) {
    Offset off[kVox];
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      const int iz = min(max(static_cast<int>(rintf(unnormalize(p[0][j], Z))), 0), Z - 1);
      const int iy = min(max(static_cast<int>(rintf(unnormalize(p[1][j], Y))), 0), Y - 1);
      const int ix = min(max(static_cast<int>(rintf(unnormalize(p[2][j], X))), 0), X - 1);
      off[j] = (iz * Y + iy) * X + ix;
    }
    for (int c = 0; c < C; ++c) {
      const float* s = src + c * V;
      float r[kVox];
#pragma unroll
      for (int j = 0; j < kVox; ++j) r[j] = __ldg(s + off[j]);
      store_stream(dst + c * N, n0, N, r);
    }
    return;
  }
  Corners q[kVox];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
    q[j] = corners(unnormalize(p[0][j], Z), unnormalize(p[1][j], Y), unnormalize(p[2][j], X), Z,
                   Y, X);
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * V;
    float v[kVox][8];
#pragma unroll
    for (int j = 0; j < kVox; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = __ldg(s + q[j].off[k]);
    float r[kVox];
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      const float wz[2] = {__fsub_rn(1.0f, q[j].tz), q[j].tz};
      const float wy[2] = {__fsub_rn(1.0f, q[j].ty), q[j].ty};
      const float wx[2] = {__fsub_rn(1.0f, q[j].tx), q[j].tx};
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // the plain version's product order: z, then y, then x
        const float w = __fmul_rn(__fmul_rn(wz[k >> 2], wy[(k >> 1) & 1]), wx[k & 1]);
        acc = __fadd_rn(acc, __fmul_rn(v[j][k], w));
      }
      r[j] = acc;
    }
    store_stream(dst + c * N, n0, N, r);
  }
}

template <bool kNearest>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    warp_planes_kernel(const float* __restrict__ img,     // (B, C, Z, Y, X)
                       const float* __restrict__ planes,  // (B, 3, N)
                       float* __restrict__ out,           // (B, C, N)
                       int B, int C, int Z, int Y, int X, long long N) {
  const long long V = static_cast<long long>(Z) * Y * X;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {  // one pass unless B > kMaxGridY
    const float* pb = planes + static_cast<long long>(b) * 3 * N;
    const float* src = img + static_cast<long long>(b) * C * V;
    float* dst = out + static_cast<long long>(b) * C * N;
    walk(pb, N, [&](const float (&p)[3][kVox], long long n0) {
      warp_tile<kNearest>(src, dst, p, n0, C, Z, Y, X, N, V);
    });
  }
}

// d clamp(v, 0, n - 1) / dv with jnp.clip's tie convention, times dv/dp = n/2
__device__ __forceinline__ float chain(float p, int n) {
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(p, 1.0f), static_cast<float>(n)), 1.0f), 0.5f);
  const float hi = static_cast<float>(n - 1);
  const float mask = (v < 0.0f || v > hi) ? 0.0f : ((v == 0.0f || v == hi) ? 0.5f : 1.0f);
  return mask * (static_cast<float>(n) * 0.5f);
}

__device__ __forceinline__ void grad_tile(const float* __restrict__ src,
                                          const float* __restrict__ gb, float* __restrict__ ob,
                                          const float (&p)[3][kVox], long long n0, int C,
                                          int Z, int Y, int X, long long N, long long V) {
  Corners q[kVox];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
    q[j] = corners(unnormalize(p[0][j], Z), unnormalize(p[1][j], Y), unnormalize(p[2][j], X), Z,
                   Y, X);
  float az[kVox] = {}, ay[kVox] = {}, ax[kVox] = {};
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * V;
    float gc[kVox];
    load_stream(gb + c * N, n0, N, gc);
    float v[kVox][8];
#pragma unroll
    for (int j = 0; j < kVox; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = __ldg(s + q[j].off[k]);
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      const float tz = q[j].tz, ty = q[j].ty, tx = q[j].tx;
      const float uz = 1.0f - tz, uy = 1.0f - ty, ux = 1.0f - tx;
      const float* e = v[j];  // e[k]: k = 4 cz + 2 cy + cx
      const float dz = uy * (ux * (e[4] - e[0]) + tx * (e[5] - e[1])) +
                       ty * (ux * (e[6] - e[2]) + tx * (e[7] - e[3]));
      const float dy = uz * (ux * (e[2] - e[0]) + tx * (e[3] - e[1])) +
                       tz * (ux * (e[6] - e[4]) + tx * (e[7] - e[5]));
      const float dx = uz * (uy * (e[1] - e[0]) + ty * (e[3] - e[2])) +
                       tz * (uy * (e[5] - e[4]) + ty * (e[7] - e[6]));
      az[j] = fmaf(gc[j], dz, az[j]);
      ay[j] = fmaf(gc[j], dy, ay[j]);
      ax[j] = fmaf(gc[j], dx, ax[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    az[j] *= chain(p[0][j], Z);
    ay[j] *= chain(p[1][j], Y);
    ax[j] *= chain(p[2][j], X);
  }
  store_stream(ob, n0, N, az);
  store_stream(ob + N, n0, N, ay);
  store_stream(ob + 2 * N, n0, N, ax);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    warp_planes_grad_kernel(const float* __restrict__ img,     // (B, C, Z, Y, X)
                            const float* __restrict__ g,       // (B, C, N)
                            const float* __restrict__ planes,  // (B, 3, N)
                            float* __restrict__ out,           // (B, 3, N)
                            int B, int C, int Z, int Y, int X, long long N) {
  const long long V = static_cast<long long>(Z) * Y * X;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {  // one pass unless B > kMaxGridY
    const float* pb = planes + static_cast<long long>(b) * 3 * N;
    const float* src = img + static_cast<long long>(b) * C * V;
    const float* gb = g + static_cast<long long>(b) * C * N;
    float* ob = out + static_cast<long long>(b) * 3 * N;
    walk(pb, N, [&](const float (&p)[3][kVox], long long n0) {
      grad_tile(src, gb, ob, p, n0, C, Z, Y, X, N, V);
    });
  }
}

// Blocks of K resident on the device at once (SMs x blocks a SM), once per
// kernel and device: the grid's width, so that each block walks a range.
template <auto K>
int resident_blocks() {
  static int blocks[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (!blocks[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kThreads, 0) != cudaSuccess)
      return 0;
    blocks[dev] = sms * per_sm;
  }
  return blocks[dev];
}

// (blocks a batch item, batch items at once): the resident blocks shared
// among the batch items, never more than a batch item has tiles; past
// kMaxGridY batch items a block takes items blockIdx.y, blockIdx.y +
// kMaxGridY, ...
dim3 walk_grid(int resident, long long N, int B) {
  const long long tiles = (N + kTile - 1) / kTile;
  const long long per_item = (resident + B - 1) / B;
  return dim3(static_cast<unsigned>(max(1LL, min(tiles, per_item))), min(B, km::kMaxGridY));
}

template <bool kNearest>
int launch_warp(const float* img, const float* planes, float* out, int B, int C, int Z, int Y,
                int X, long long N, cudaStream_t stream) {
  const int resident = resident_blocks<&warp_planes_kernel<kNearest>>();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  warp_planes_kernel<kNearest><<<walk_grid(resident, N, B), kThreads, 0, stream>>>(
      img, planes, out, B, C, Z, Y, X, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

KM_EXPORT int km_warp_planes_grad(const void* img, const void* g, const void* planes,
                                  void* out, int B, int C, int Z, int Y, int X,
                                  int D, int H, int W, void* stream) {
  const long long N = static_cast<long long>(D) * H * W;
  if (B == 0 || N == 0) return 0;  // nothing to write
  const int resident = resident_blocks<&warp_planes_grad_kernel>();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  warp_planes_grad_kernel<<<walk_grid(resident, N, B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(g),
      static_cast<const float*>(planes), static_cast<float*>(out), B, C, Z, Y, X, N);
  return static_cast<int>(cudaGetLastError());
}

KM_EXPORT int km_warp_planes(const void* img, const void* planes, void* out,
                             int B, int C, int Z, int Y, int X,
                             int D, int H, int W, int nearest, void* stream) {
  const long long N = static_cast<long long>(D) * H * W;
  const auto* im = static_cast<const float*>(img);
  const auto* pl = static_cast<const float*>(planes);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0) return 0;  // nothing to write
  return nearest ? launch_warp<true>(im, pl, o, B, C, Z, Y, X, N, s)
                 : launch_warp<false>(im, pl, o, B, C, Z, Y, X, N, s);
}
