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
// What bounds it on the H100: memory. Per output voxel it reads 12 bytes of
// planes, 8 * C gathered source values and writes 4 * C bytes; with a smooth
// registration flow neighbouring threads gather neighbouring source voxels,
// so the gathers hit L1/L2 and the kernel runs near DRAM streaming speed.
// The TPU kernel's span prepass, window ladder and XLA fallback existed
// because Mosaic has no gather; here one thread per output voxel gathers
// directly, which is exact for any flow. Each thread computes its corners
// and weights once and reuses them across the C channels. Arithmetic uses
// explicitly rounded operations (no FMA contraction) in the plain version's
// order, so kernel and plain results agree bit for bit.
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
// What bounds it on the H100: memory, as the forward: 12 bytes of planes and
// 4 * C bytes of cotangent read, 8 * C gathered source values, 12 bytes
// written per output voxel. One thread per output voxel gathers its 8 corners
// once per channel and forms all three axes' differences from them; every
// output element has one writer, so there are no atomics and the result is
// deterministic.
#include "common.cuh"

namespace {

__device__ __forceinline__ float unnormalize(float p, int n) {
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(p, 1.0f), static_cast<float>(n)), 1.0f), 0.5f);
  return fminf(fmaxf(v, 0.0f), static_cast<float>(n - 1));
}

__global__ void warp_planes_kernel(const float* __restrict__ img,     // (B, C, Z, Y, X)
                                   const float* __restrict__ planes,  // (B, 3, N)
                                   float* __restrict__ out,           // (B, C, N)
                                   int C, int Z, int Y, int X, long long N,
                                   int nearest) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const long long V = static_cast<long long>(Z) * Y * X;
  const float* pb = planes + static_cast<long long>(b) * 3 * N + n;
  const float vz = unnormalize(pb[0], Z);
  const float vy = unnormalize(pb[N], Y);
  const float vx = unnormalize(pb[2 * N], X);
  const float* src = img + static_cast<long long>(b) * C * V;
  float* dst = out + static_cast<long long>(b) * C * N + n;

  if (nearest) {
    const long long iz = min(max(static_cast<int>(rintf(vz)), 0), Z - 1);
    const long long iy = min(max(static_cast<int>(rintf(vy)), 0), Y - 1);
    const long long ix = min(max(static_cast<int>(rintf(vx)), 0), X - 1);
    const long long off = (iz * Y + iy) * X + ix;
    for (int c = 0; c < C; ++c) dst[c * N] = src[c * V + off];
    return;
  }

  const float fz = floorf(vz), fy = floorf(vy), fx = floorf(vx);
  const float tz = vz - fz, ty = vy - fy, tx = vx - fx;  // exact
  const int z0 = static_cast<int>(fz), y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
  long long off[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // corner (cz, cy, cx) in itertools.product order
    const int cz = (k >> 2) & 1, cy = (k >> 1) & 1, cx = k & 1;
    const long long iz = min(z0 + cz, Z - 1);
    const long long iy = min(y0 + cy, Y - 1);
    const long long ix = min(x0 + cx, X - 1);
    off[k] = (iz * Y + iy) * X + ix;
    float wk = cz ? tz : __fsub_rn(1.0f, tz);
    wk = __fmul_rn(wk, cy ? ty : __fsub_rn(1.0f, ty));
    w[k] = __fmul_rn(wk, cx ? tx : __fsub_rn(1.0f, tx));
  }
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * V;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(__ldg(s + off[k]), w[k]));
    dst[c * N] = acc;
  }
}

// d clamp(v, 0, n - 1) / dv with jnp.clip's tie convention, times dv/dp = n/2
__device__ __forceinline__ float chain(float p, int n) {
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(p, 1.0f), static_cast<float>(n)), 1.0f), 0.5f);
  const float hi = static_cast<float>(n - 1);
  const float mask = (v < 0.0f || v > hi) ? 0.0f : ((v == 0.0f || v == hi) ? 0.5f : 1.0f);
  return mask * (static_cast<float>(n) * 0.5f);
}

__global__ void warp_planes_grad_kernel(const float* __restrict__ img,     // (B, C, Z, Y, X)
                                        const float* __restrict__ g,       // (B, C, N)
                                        const float* __restrict__ planes,  // (B, 3, N)
                                        float* __restrict__ out,           // (B, 3, N)
                                        int C, int Z, int Y, int X, long long N) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const long long V = static_cast<long long>(Z) * Y * X;
  const float* pb = planes + static_cast<long long>(b) * 3 * N + n;
  const float pz = pb[0], py = pb[N], px = pb[2 * N];
  const float vz = unnormalize(pz, Z), vy = unnormalize(py, Y), vx = unnormalize(px, X);
  const float fz = floorf(vz), fy = floorf(vy), fx = floorf(vx);
  const float tz = vz - fz, ty = vy - fy, tx = vx - fx;
  const float uz = 1.0f - tz, uy = 1.0f - ty, ux = 1.0f - tx;
  const int z0 = static_cast<int>(fz), y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
  long long off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // corner (cz, cy, cx), as the forward
    const long long iz = min(z0 + ((k >> 2) & 1), Z - 1);
    const long long iy = min(y0 + ((k >> 1) & 1), Y - 1);
    const long long ix = min(x0 + (k & 1), X - 1);
    off[k] = (iz * Y + iy) * X + ix;
  }
  const float* src = img + static_cast<long long>(b) * C * V;
  const float* gb = g + static_cast<long long>(b) * C * N + n;
  float az = 0.0f, ay = 0.0f, ax = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * V;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(s + off[k]);
    // v[k]: k = 4 cz + 2 cy + cx
    const float dz = uy * (ux * (v[4] - v[0]) + tx * (v[5] - v[1])) +
                     ty * (ux * (v[6] - v[2]) + tx * (v[7] - v[3]));
    const float dy = uz * (ux * (v[2] - v[0]) + tx * (v[3] - v[1])) +
                     tz * (ux * (v[6] - v[4]) + tx * (v[7] - v[5]));
    const float dx = uz * (uy * (v[1] - v[0]) + ty * (v[3] - v[2])) +
                     tz * (uy * (v[5] - v[4]) + ty * (v[7] - v[6]));
    const float gc = gb[c * N];
    az = fmaf(gc, dz, az);
    ay = fmaf(gc, dy, ay);
    ax = fmaf(gc, dx, ax);
  }
  float* ob = out + static_cast<long long>(b) * 3 * N + n;
  ob[0] = az * chain(pz, Z);
  ob[N] = ay * chain(py, Y);
  ob[2 * N] = ax * chain(px, X);
}

}  // namespace

KM_EXPORT int km_warp_planes_grad(const void* img, const void* g, const void* planes,
                                  void* out, int B, int C, int Z, int Y, int X,
                                  int D, int H, int W, void* stream) {
  const long long N = static_cast<long long>(D) * H * W;
  const int threads = 256;
  dim3 grid(km::ceil_div(N, threads), B);
  warp_planes_grad_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(g),
      static_cast<const float*>(planes), static_cast<float*>(out), C, Z, Y, X, N);
  return static_cast<int>(cudaGetLastError());
}

KM_EXPORT int km_warp_planes(const void* img, const void* planes, void* out,
                             int B, int C, int Z, int Y, int X,
                             int D, int H, int W, int nearest, void* stream) {
  const long long N = static_cast<long long>(D) * H * W;
  const int threads = 256;
  dim3 grid(km::ceil_div(N, threads), B);
  warp_planes_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(planes),
      static_cast<float*>(out), C, Z, Y, X, N, nearest);
  return static_cast<int>(cudaGetLastError());
}
