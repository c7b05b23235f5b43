// Dense TPS flow and its backward: tps_planes (identity grid, plane-major),
// tps_flow (given points) and the backward of tps_planes.
//
// Forward kernels. Replace keymorph_tpu/ops/pallas/tpsflow.py:_kernel, in its
// identity-grid mode (reached through _tps_flow_pallas <- _tps_planes <-
// tps_planes) and in its points mode (<- _tps_flow <- tps_flow).
//
//   out[b, k, n] = A[b] . [p_n; 1] + sum_t w[b, t, k] * U(|p_n - c[b, t]|)
//   U(r) = r^2 log(r + 1e-6),  r = sqrt(|p - c|^2 + 1e-6)
//
// In identity-grid mode p_n is regenerated from the flat index n as the
// inclusive-linspace grid coordinate idx * (2 / (S - 1)) - 1 (0 when S == 1),
// ij order, so no points tensor is read and the result is plane-major
// (B, 3, N). In points mode p_n is read from a (B, N, 3) tensor and the
// result is (B, N, 3); any N (the ragged last block is masked). fp32
// throughout; both modes share one device function.
//
// What bounds them on the H100: the special functions. At 256^3 with T = 128
// control points there are 2.1e9 (sqrtf, logf) pairs and only 16.7e6 * 12
// bytes written, so the kernels are arithmetic-bound on the accurate (not
// fast-math) logf/sqrtf sequences. The design keeps everything else out of
// the way: control points and weights sit in shared memory (read as
// broadcasts), each thread owns one point and keeps its three sums in
// registers, and the (T, N) RBF matrix never exists anywhere. Plane writes
// are coalesced along n, one plane at a time.
//
// Backward kernel. Replaces keymorph_tpu/ops/pallas/tpsflow.py:_bwd_kernel
// (reached through _tps_planes_bwd_pallas <- _tps_planes_bwd). For every
// control point t it sums over all N grid points seven values,
//
//   sum_n g_k U        (k = 0..2)   -> cotangent of the spline weights
//   sum_n m, sum_n m p_j (j = 0..2) -> cotangent of the control points,
//   m = (sum_k w[t, k] g_k) * dU/dsq,  dU/dsq = log(r+1e-6) + r / (2 (r+1e-6))
//
// with U recomputed and the grid regenerated as in the forward. It is bound
// by the same special functions (T * N evaluations of sqrtf, logf and one
// division) and reads only the cotangent (12 bytes per point). Blocks run in
// no order, so nothing is accumulated across them: a block stages 1024 grid
// points and their cotangents in shared memory, each thread owns one control
// point and one slice of the block's points and keeps its seven sums in
// registers (all lanes of a warp read the same point: a broadcast, no
// shuffles in the loop), the slices are added in a fixed order, and the
// block writes its (T, 7) partial sums. The wrapper adds the partials of all
// blocks in a second pass. No atomics: the result is deterministic.
#include "common.cuh"

namespace {

// |c - p|^2 with every operation rounded on its own (no FMA contraction), as
// the plain version sums the squared differences
__device__ __forceinline__ float sq_dist(float c0, float c1, float c2,
                                         float p0, float p1, float p2) {
  const float d0 = c0 - p0, d1 = c1 - p1, d2 = c2 - p2;
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// identity-grid coordinate of flat index n: idx * step - 1, separate multiply
// and subtract: the same two roundings as the plain version
__device__ __forceinline__ void grid_point(long long n, int H, int W, float sd, float sh,
                                           float sw, float& p0, float& p1, float& p2) {
  const long long hw = static_cast<long long>(H) * W;
  const int iz = static_cast<int>(n / hw);
  const int iy = static_cast<int>((n / W) % H);
  const int ix = static_cast<int>(n % W);
  p0 = __fsub_rn(__fmul_rn(static_cast<float>(iz), sd), 1.0f);
  p1 = __fsub_rn(__fmul_rn(static_cast<float>(iy), sh), 1.0f);
  p2 = __fsub_rn(__fmul_rn(static_cast<float>(ix), sw), 1.0f);
}

// Stage control points and spline weights of batch item b in shared memory.
__device__ __forceinline__ void stage_spline(const float* th, const float* cb, int T,
                                             float* c_s, float* w_s) {
  for (int i = threadIdx.x; i < 3 * T; i += blockDim.x) {
    c_s[i] = cb[i];
    w_s[i] = th[i];
  }
  __syncthreads();
}

// The spline at one point: z[k] = affine + sum_t w[t, k] U(|p - c_t|).
__device__ __forceinline__ void tps_point(const float* c_s, const float* w_s,
                                          const float* af, int T, float p0, float p1,
                                          float p2, float z[3]) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int t = 0; t < T; ++t) {
    const float sq = sq_dist(c_s[3 * t + 0], c_s[3 * t + 1], c_s[3 * t + 2], p0, p1, p2);
    const float r = sqrtf(sq + 1e-6f);
    const float u = __fmul_rn(__fmul_rn(r, r), logf(r + 1e-6f));
    a0 = fmaf(w_s[3 * t + 0], u, a0);
    a1 = fmaf(w_s[3 * t + 1], u, a1);
    a2 = fmaf(w_s[3 * t + 2], u, a2);
  }
  // affine rows: af[0] is the constant row, af[1 + j] scales p_j
  const float acc[3] = {a0, a1, a2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = af[k];
    v = __fadd_rn(v, __fmul_rn(p0, af[3 + k]));
    v = __fadd_rn(v, __fmul_rn(p1, af[6 + k]));
    v = __fadd_rn(v, __fmul_rn(p2, af[9 + k]));
    z[k] = v + acc[k];
  }
}

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
  stage_spline(th, ctrl + static_cast<long long>(b) * T * 3, T, c_s, w_s);

  const long long N = static_cast<long long>(D) * H * W;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float p0, p1, p2, z[3];
  grid_point(n, H, W, sd, sh, sw, p0, p1, p2);
  tps_point(c_s, w_s, th + 3 * T, T, p0, p1, p2, z);
  float* ob = out + static_cast<long long>(b) * 3 * N + n;
#pragma unroll
  for (int k = 0; k < 3; ++k) ob[k * N] = z[k];
}

__global__ void tps_flow_kernel(const float* __restrict__ theta,   // (B, T+4, 3)
                                const float* __restrict__ ctrl,    // (B, T, 3)
                                const float* __restrict__ points,  // (B, N, 3)
                                float* __restrict__ out,           // (B, N, 3)
                                int T, long long N) {
  extern __shared__ float smem[];
  float* c_s = smem;
  float* w_s = smem + 3 * T;
  const int b = blockIdx.y;
  const float* th = theta + static_cast<long long>(b) * (T + 4) * 3;
  stage_spline(th, ctrl + static_cast<long long>(b) * T * 3, T, c_s, w_s);

  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* pp = points + (static_cast<long long>(b) * N + n) * 3;
  float z[3];
  tps_point(c_s, w_s, th + 3 * T, T, pp[0], pp[1], pp[2], z);
  float* ob = out + (static_cast<long long>(b) * N + n) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) ob[k] = z[k];
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_POINTS = 1024;  // grid points staged per block

__global__ void __launch_bounds__(BWD_THREADS)
tps_planes_bwd_kernel(const float* __restrict__ theta,  // (B, T+4, 3)
                      const float* __restrict__ ctrl,   // (B, T, 3)
                      const float* __restrict__ g,      // (B, 3, N)
                      float* __restrict__ part,         // (B, n_blocks, T, 7)
                      int T, int TL, int D, int H, int W,
                      float sd, float sh, float sw) {
  __shared__ float4 pa_s[BWD_POINTS];  // p0, p1, p2, g0
  __shared__ float2 pb_s[BWD_POINTS];  // g1, g2
  __shared__ float red_s[BWD_THREADS * 7];
  const int b = blockIdx.y;
  const long long N = static_cast<long long>(D) * H * W;
  const long long n0 = static_cast<long long>(blockIdx.x) * BWD_POINTS;
  const float* gb = g + static_cast<long long>(b) * 3 * N;
  for (int i = threadIdx.x; i < BWD_POINTS; i += BWD_THREADS) {
    const long long n = n0 + i;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float2 c = make_float2(0.f, 0.f);
    if (n < N) {  // past the end: a zero cotangent adds 0 to every sum
      grid_point(n, H, W, sd, sh, sw, a.x, a.y, a.z);
      a.w = gb[n];
      c.x = gb[N + n];
      c.y = gb[2 * N + n];
    }
    pa_s[i] = a;
    pb_s[i] = c;
  }
  __syncthreads();

  // TL lanes of control points x (BWD_THREADS / TL) slices of the points
  const int groups = BWD_THREADS / TL;
  const int grp = threadIdx.x / TL, tl = threadIdx.x % TL;
  const int per = BWD_POINTS / groups;
  const float* th = theta + static_cast<long long>(b) * (T + 4) * 3;
  const float* cb = ctrl + static_cast<long long>(b) * T * 3;
  float* pout = part + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * T * 7;

  for (int t0 = 0; t0 < T; t0 += TL) {
    const int t = t0 + tl;
    const bool on = t < T;
    const float c0 = on ? cb[3 * t + 0] : 0.f, c1 = on ? cb[3 * t + 1] : 0.f,
                c2 = on ? cb[3 * t + 2] : 0.f;
    const float w0 = on ? th[3 * t + 0] : 0.f, w1 = on ? th[3 * t + 1] : 0.f,
                w2 = on ? th[3 * t + 2] : 0.f;
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = grp * per; i < (grp + 1) * per; ++i) {
      const float4 a = pa_s[i];
      const float2 c = pb_s[i];
      const float sq = sq_dist(c0, c1, c2, a.x, a.y, a.z);
      const float r = sqrtf(sq + 1e-6f);
      const float re = r + 1e-6f;
      const float lg = logf(re);
      const float u = __fmul_rn(__fmul_rn(r, r), lg);
      const float du = lg + r / (2.0f * re);
      const float m = (w0 * a.w + w1 * c.x + w2 * c.y) * du;
      acc[0] = fmaf(a.w, u, acc[0]);
      acc[1] = fmaf(c.x, u, acc[1]);
      acc[2] = fmaf(c.y, u, acc[2]);
      acc[3] += m;
      acc[4] = fmaf(m, a.x, acc[4]);
      acc[5] = fmaf(m, a.y, acc[5]);
      acc[6] = fmaf(m, a.z, acc[6]);
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) red_s[threadIdx.x * 7 + k] = acc[k];
    __syncthreads();
    if (grp == 0 && on) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        float s = 0.f;
        for (int q = 0; q < groups; ++q) s += red_s[(q * TL + tl) * 7 + k];
        pout[t * 7 + k] = s;
      }
    }
    __syncthreads();  // red_s is reused by the next tile of control points
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

KM_EXPORT int km_tps_flow(const void* theta, const void* ctrl, const void* points,
                          void* out, int B, int T, long long N, void* stream) {
  const int threads = 256;
  dim3 grid(km::ceil_div(N, threads), B);
  const size_t smem = static_cast<size_t>(6) * T * sizeof(float);
  tps_flow_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(ctrl),
      static_cast<const float*>(points), static_cast<float*>(out), T, N);
  return static_cast<int>(cudaGetLastError());
}

// Number of per-block partial sums the backward writes per batch item.
KM_EXPORT int km_tps_planes_bwd_blocks(int D, int H, int W) {
  return km::ceil_div(static_cast<long long>(D) * H * W, BWD_POINTS);
}

// part: (B, km_tps_planes_bwd_blocks, T, 7) fp32, every element written.
KM_EXPORT int km_tps_planes_bwd(const void* theta, const void* ctrl, const void* g,
                                void* part, int B, int T, int D, int H, int W,
                                float sd, float sh, float sw, void* stream) {
  dim3 grid(km_tps_planes_bwd_blocks(D, H, W), B);
  const int TL = T <= 32 ? 32 : 64;  // control-point lanes per block
  tps_planes_bwd_kernel<<<grid, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(ctrl),
      static_cast<const float*>(g), static_cast<float*>(part), T, TL, D, H, W, sd, sh, sw);
  return static_cast<int>(cudaGetLastError());
}
