// Trilinear / nearest warp from ij-ordered coordinate planes: warp_planes.
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

}  // namespace

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
