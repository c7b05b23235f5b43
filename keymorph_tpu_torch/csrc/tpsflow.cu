// Dense TPS flow at the identity grid, plane-major: tps_planes.
//
// Replaces keymorph_tpu/ops/pallas/tpsflow.py:_kernel (identity-grid mode,
// reached through _tps_flow_pallas <- _tps_planes <- tps_planes).
//
//   out[b, k, n] = A[b] . [p_n; 1] + sum_t w[b, t, k] * U(|p_n - c[b, t]|)
//   U(r) = r^2 log(r + 1e-6),  r = sqrt(|p - c|^2 + 1e-6)
//
// p_n is regenerated from the flat index n as the inclusive-linspace grid
// coordinate idx * (2 / (S - 1)) - 1 (0 when S == 1), ij order, so no points
// tensor is read. fp32 throughout.
//
// What bounds it on the H100: the special functions. At 256^3 with T = 128
// control points there are 2.1e9 (sqrtf, logf) pairs and only 16.7e6 * 12
// bytes written, so the kernel is arithmetic-bound on the accurate (not
// fast-math) logf/sqrtf sequences. The design keeps everything else out of
// the way: control points and weights sit in shared memory (read as
// broadcasts), each thread owns one grid point and keeps its three sums in
// registers, and the (T, N) RBF matrix never exists anywhere. Writes are
// coalesced along n, one plane at a time.
#include "common.cuh"

namespace {

__global__ void tps_planes_kernel(const float* __restrict__ theta,  // (B, T+4, 3)
                                  const float* __restrict__ ctrl,   // (B, T, 3)
                                  float* __restrict__ out,          // (B, 3, N)
                                  int T, int D, int H, int W,
                                  float sd, float sh, float sw) {
  extern __shared__ float smem[];
  float* c_s = smem;          // (T, 3) control points
  float* w_s = smem + 3 * T;  // (T, 3) spline weights
  const int b = blockIdx.y;
  const float* th = theta + static_cast<long long>(b) * (T + 4) * 3;
  const float* cb = ctrl + static_cast<long long>(b) * T * 3;
  for (int i = threadIdx.x; i < 3 * T; i += blockDim.x) {
    c_s[i] = cb[i];
    w_s[i] = th[i];
  }
  __syncthreads();

  const long long N = static_cast<long long>(D) * H * W;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long hw = static_cast<long long>(H) * W;
  const int iz = static_cast<int>(n / hw);
  const int iy = static_cast<int>((n / W) % H);
  const int ix = static_cast<int>(n % W);
  // separate multiply and subtract (no FMA contraction): the same two
  // roundings as the plain version's idx * step - 1
  const float p0 = __fsub_rn(__fmul_rn(static_cast<float>(iz), sd), 1.0f);
  const float p1 = __fsub_rn(__fmul_rn(static_cast<float>(iy), sh), 1.0f);
  const float p2 = __fsub_rn(__fmul_rn(static_cast<float>(ix), sw), 1.0f);

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int t = 0; t < T; ++t) {
    const float d0 = c_s[3 * t + 0] - p0;
    const float d1 = c_s[3 * t + 1] - p1;
    const float d2 = c_s[3 * t + 2] - p2;
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                               __fmul_rn(d2, d2));
    const float r = sqrtf(sq + 1e-6f);
    const float u = __fmul_rn(__fmul_rn(r, r), logf(r + 1e-6f));
    a0 = fmaf(w_s[3 * t + 0], u, a0);
    a1 = fmaf(w_s[3 * t + 1], u, a1);
    a2 = fmaf(w_s[3 * t + 2], u, a2);
  }
  // affine rows: theta[T] is the constant row, theta[T+1+j] scales p_j
  const float* af = th + 3 * T;
  float* ob = out + static_cast<long long>(b) * 3 * N + n;
  const float p[3] = {p0, p1, p2};
  const float acc[3] = {a0, a1, a2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float z = af[k];
    z = __fadd_rn(z, __fmul_rn(p[0], af[3 + k]));
    z = __fadd_rn(z, __fmul_rn(p[1], af[6 + k]));
    z = __fadd_rn(z, __fmul_rn(p[2], af[9 + k]));
    ob[k * N] = z + acc[k];
  }
}

}  // namespace

KM_EXPORT int km_tps_planes(const void* theta, const void* ctrl, void* out,
                            int B, int T, int D, int H, int W,
                            float sd, float sh, float sw, void* stream) {
  const long long N = static_cast<long long>(D) * H * W;
  const int threads = 256;
  dim3 grid(km::ceil_div(N, threads), B);
  const size_t smem = static_cast<size_t>(6) * T * sizeof(float);
  tps_planes_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(ctrl),
      static_cast<float*>(out), T, D, H, W, sd, sh, sw);
  return static_cast<int>(cudaGetLastError());
}
