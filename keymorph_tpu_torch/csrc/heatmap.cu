// The keypoint head in one read of the heatmaps (models/layers.py:center_of_mass,
// ops/cuda/heatmap.py:heatmap_com). For each channel c of each batch item, the
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
