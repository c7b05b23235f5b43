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
// In identity-grid mode p_n is regenerated from its indices as the
// inclusive-linspace grid coordinate idx * (2 / (S - 1)) - 1 (0 when S == 1),
// ij order, so no points tensor is read and the result is plane-major
// (B, 3, N). In points mode p_n is read from a (B, N, 3) tensor and the
// result is (B, N, 3); any N (the ragged last block is masked). fp32
// throughout; both modes share rbf() and the staging of the spline.
//
// What bounds them on the H100: the instruction rate, and only then the
// special-function unit. At 256^3 with T = 128 control points there are 2.1e9
// evaluations of U and only 16.7e6 * 12 bytes written. With one point per
// thread, six scalar shared loads per evaluation and the accurate sqrtf and
// logf sequences (tens of instructions each), the kernel took 4.2 ms, 4.1x
// the 1.027 ms that two special-function instructions per evaluation need on
// 132 SMs x 16 lanes at 1.98 GHz. The design cuts the instructions per
// evaluation; it takes 1.27 ms, 1.2x that bound (chip_smoke.py phase 1 on an
// NVIDIA H100 80GB HBM3, 700.00 W):
//   - a thread owns several points and keeps their sums in registers; a
//     control point and its weights are one float4 and one float2 in shared
//     memory, read as broadcasts, so an evaluation costs 2 / P shared loads
//     and P independent sqrt -> log chains are in flight per thread;
//   - on the identity grid a thread's points are consecutive x positions of
//     one grid row, where d0^2 + d1^2 does not depend on x: it is taken once
//     per (row, control point), and sq = (d0^2 + d1^2) + d2^2 is the sum in
//     the plain version's order, bit for bit. These two steps alone bought a
//     sixth of the time; the accurate functions were most of the rest;
//   - rbf() takes sqrt, log2 and the backward's reciprocal as one
//     special-function instruction each, written as such in the source (the
//     build has no --use_fast_math), and r^2 as the sqrt's own argument. The
//     formula itself is the plain version's, step by step. The kernels stay
//     as near to the float64 value of the formula as the plain version is
//     (7e-7 at lmbda 1, 4e-5 at lmbda 1e-4, where the spline's weights are
//     large and cancel): the error is the fp32 sum's, not the functions'.
// T is walked in tiles of T_TILE control points, so any T fits the static
// shared memory. The (T, N) RBF matrix never exists anywhere.
//
// Backward kernel. Replaces keymorph_tpu/ops/pallas/tpsflow.py:_bwd_kernel
// (reached through _tps_planes_bwd_pallas <- _tps_planes_bwd). For every
// control point t it sums over all N grid points seven values,
//
//   sum_n g_k U        (k = 0..2)   -> cotangent of the spline weights
//   sum_n m, sum_n m p_j (j = 0..2) -> cotangent of the control points,
//   m = (sum_k w[t, k] g_k) * dU/dsq,  dU/dsq = log(r+1e-6) + r / (2 (r+1e-6))
//
// with U recomputed and the grid regenerated as in the forward; and, since it
// reads the cotangent anyway, the twelve sums of the affine rows' cotangent
// (sum_n g_k and sum_n p_j g_k). It has the forward's chain plus a reciprocal
// (three special-function instructions per evaluation) and reads only the
// cotangent (12 bytes per point). The grid is cut into groups of a few rows
// (at most BWD_POINTS points); a block takes groups blockIdx.x, blockIdx.x +
// gridDim.x, ... and stages each as one float4 {p2, g0, g1, g2} per point and
// (p0, p1) per row. A warp covers 32 * TC control points, TC of them per
// lane, so each point loaded (one 128-bit broadcast) feeds TC evaluations;
// the block's eight warps take different pieces of a group's rows. Along a
// piece of a row d0^2 + d1^2 is fixed, and sum m p0 and sum m p1 are p0 and
// p1 times the piece's sum of m, so the inner loop keeps five sums per
// control point. A lane's sums stay in registers over all of its block's
// groups; then the warps' sums are added in a fixed order and the block
// writes one row of partial sums, at most BWD_BLOCKS_MAX rows whatever the
// volume; the wrapper adds the rows in a second pass. No atomics: the result
// is deterministic.
#include "common.cuh"

namespace {

constexpr float EPS = 1e-6f;  // both the distance's and the log's

// |c - p|^2 with every operation rounded on its own (no FMA contraction), as
// the plain version sums the squared differences
__device__ __forceinline__ float sq_dist(float c0, float c1, float c2,
                                         float p0, float p1, float p2) {
  const float d0 = c0 - p0, d1 = c1 - p1, d2 = c2 - p2;
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// identity-grid coordinate idx * step - 1, separate multiply and subtract: the
// same two roundings as the plain version
__device__ __forceinline__ float grid_coord(int idx, float step) {
  return __fsub_rn(__fmul_rn(static_cast<float>(idx), step), 1.0f);
}

// sqrt, log and reciprocal as one special-function instruction each
__device__ __forceinline__ float sqrt_approx(float s) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r;
}

// log2 * ln 2: absolute error 2^-22 of log2 for arguments in (0.5, 2), else
// relative
__device__ __forceinline__ float log_approx(float x) {
  float l;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));
  return __fmul_rn(l, 0.693147180559945f);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float rc;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rc) : "f"(x));
  return rc;
}

// U = r^2 log(r + 1e-6) at squared distance sq and, with GRAD, dU/dsq. r^2 is
// taken as the sqrt's own argument sq + 1e-6.
template <bool GRAD>
__device__ __forceinline__ float rbf(float sq, float& du) {
  const float s = __fadd_rn(sq, EPS);
  const float r = sqrt_approx(s);
  const float re = __fadd_rn(r, EPS);
  const float lg = log_approx(re);
  if constexpr (GRAD) du = fmaf(r, 0.5f * rcp_approx(re), lg);
  return __fmul_rn(s, lg);
}

constexpr int FWD_THREADS = 256;
constexpr int PLANES_P = 8;   // x positions per thread on the identity grid (4: 5% slower)
constexpr int FLOW_P = 4;    // points per thread in points mode (8 measured 3% slower)
constexpr int T_TILE = 512;  // control points staged at a time

// Stage control points [t0, t0 + tn) of one batch item and their spline
// weights: {c0, c1, c2, w0} and {w1, w2}.
__device__ __forceinline__ void stage_spline(const float* th, const float* cb, int t0, int tn,
                                             float4* cw_s, float2* ww_s) {
  for (int i = threadIdx.x; i < tn; i += blockDim.x) {
    const float* c = cb + 3 * (t0 + i);
    const float* w = th + 3 * (t0 + i);
    cw_s[i] = make_float4(c[0], c[1], c[2], w[0]);
    ww_s[i] = make_float2(w[1], w[2]);
  }
}

// z[k] = affine part at p + spline sum acc[k]; af[0..2] is the constant row,
// af[3 + 3 j + k] scales p_j
__device__ __forceinline__ void add_affine(const float* af, float p0, float p1, float p2,
                                           const float acc[3], float z[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = af[k];
    v = __fadd_rn(v, __fmul_rn(p0, af[3 + k]));
    v = __fadd_rn(v, __fmul_rn(p1, af[6 + k]));
    v = __fadd_rn(v, __fmul_rn(p2, af[9 + k]));
    z[k] = v + acc[k];
  }
}

// A thread owns P consecutive x positions of one grid row.
template <int P>
__global__ void __launch_bounds__(FWD_THREADS)
tps_planes_kernel(const float* __restrict__ theta,  // (B, T+4, 3)
                  const float* __restrict__ ctrl,   // (B, T, 3)
                  float* __restrict__ out,          // (B, 3, N)
                  int T, int D, int H, int W, float sd, float sh, float sw) {
  __shared__ float4 cw_s[T_TILE];
  __shared__ float2 ww_s[T_TILE];
  const int b = blockIdx.y;
  const float* th = theta + static_cast<long long>(b) * (T + 4) * 3;
  const float* cb = ctrl + static_cast<long long>(b) * T * 3;

  const int per_row = (W + P - 1) / P;  // threads along one row
  const long long rows = static_cast<long long>(D) * H;
  const long long item = static_cast<long long>(blockIdx.x) * FWD_THREADS + threadIdx.x;
  // a thread past the end keeps pace with its block (it stages, it syncs) on
  // row 0 and stores nothing
  const bool live = item < rows * per_row;
  const long long row = live ? item / per_row : 0;
  const int ix = live ? static_cast<int>(item % per_row) * P : 0;
  const float p0 = grid_coord(static_cast<int>(row / H), sd);
  const float p1 = grid_coord(static_cast<int>(row % H), sh);
  float p2[P], acc[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    p2[j] = grid_coord(ix + j, sw);
    acc[j][0] = acc[j][1] = acc[j][2] = 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += T_TILE) {
    const int tn = min(T_TILE, T - t0);
    if (t0) __syncthreads();  // the tile before is used up
    stage_spline(th, cb, t0, tn, cw_s, ww_s);
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < tn; ++t) {
      const float4 cw = cw_s[t];
      const float2 ww = ww_s[t];
      const float d0 = cw.x - p0, d1 = cw.y - p1;
      const float dd = __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float d2 = cw.z - p2[j];
        float unused;
        const float u = rbf<false>(__fadd_rn(dd, __fmul_rn(d2, d2)), unused);
        acc[j][0] = fmaf(cw.w, u, acc[j][0]);
        acc[j][1] = fmaf(ww.x, u, acc[j][1]);
        acc[j][2] = fmaf(ww.y, u, acc[j][2]);
      }
    }
  }
  if (!live) return;

  const long long N = rows * W;
  float z[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j) add_affine(th + 3 * T, p0, p1, p2[j], acc[j], z[j]);
  float* ob = out + static_cast<long long>(b) * 3 * N + row * W + ix;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int q = 0; q < P; q += 4) {
      // W % 4 == 0: every address below is a multiple of 4 floats and a group
      // of four lies inside the row or outside it
      if (W % 4 == 0 && P % 4 == 0) {
        if (ix + q < W)
          *reinterpret_cast<float4*>(ob + k * N + q) =
              make_float4(z[q][k], z[q + 1][k], z[q + 2][k], z[q + 3][k]);
      } else {
#pragma unroll
        for (int j = q; j < q + 4 && j < P; ++j)
          if (ix + j < W) ob[k * N + j] = z[j][k];
      }
    }
  }
}

// A thread owns P points, FWD_THREADS apart (neighbouring lanes read
// neighbouring points).
template <int P>
__global__ void __launch_bounds__(FWD_THREADS)
tps_flow_kernel(const float* __restrict__ theta,   // (B, T+4, 3)
                const float* __restrict__ ctrl,    // (B, T, 3)
                const float* __restrict__ points,  // (B, N, 3)
                float* __restrict__ out,           // (B, N, 3)
                int T, long long N) {
  __shared__ float4 cw_s[T_TILE];
  __shared__ float2 ww_s[T_TILE];
  const int b = blockIdx.y;
  const float* th = theta + static_cast<long long>(b) * (T + 4) * 3;
  const float* cb = ctrl + static_cast<long long>(b) * T * 3;

  const long long n0 = static_cast<long long>(blockIdx.x) * (FWD_THREADS * P) + threadIdx.x;
  float p[P][3], acc[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long n = n0 + j * FWD_THREADS;
    const float* pp = points + (static_cast<long long>(b) * N + n) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[j][k] = n < N ? pp[k] : 0.f;  // past the end: computed, not stored
      acc[j][k] = 0.f;
    }
  }

  for (int t0 = 0; t0 < T; t0 += T_TILE) {
    const int tn = min(T_TILE, T - t0);
    if (t0) __syncthreads();
    stage_spline(th, cb, t0, tn, cw_s, ww_s);
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < tn; ++t) {
      const float4 cw = cw_s[t];
      const float2 ww = ww_s[t];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float unused;
        const float u =
            rbf<false>(sq_dist(cw.x, cw.y, cw.z, p[j][0], p[j][1], p[j][2]), unused);
        acc[j][0] = fmaf(cw.w, u, acc[j][0]);
        acc[j][1] = fmaf(ww.x, u, acc[j][1]);
        acc[j][2] = fmaf(ww.y, u, acc[j][2]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long n = n0 + j * FWD_THREADS;
    if (n >= N) continue;
    float z[3];
    add_affine(th + 3 * T, p[j][0], p[j][1], p[j][2], acc[j], z);
    float* ob = out + (static_cast<long long>(b) * N + n) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) ob[k] = z[k];
  }
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_POINTS = 1024;      // grid points of one group, at most
constexpr int BWD_XC_MAX = 512;       // x positions of one row in a group, at most
constexpr int BWD_ROWS_MAX = 32;      // rows of a group, at most
constexpr int BWD_BLOCKS_MAX = 2112;  // blocks (rows of partial sums) per batch item, at most
constexpr int BWD_AFF = 12;           // sums of the affine rows' cotangent
constexpr int BWD_TC_MAX = 4;         // control points per lane, at most

// How the backward cuts the grid: a group is R rows x XC x positions (nxc
// such chunks cover a row), and each of its rows is walked in S pieces of L x
// positions so that a block's warps all have a piece. The groups are dealt
// to the blocks in turn.
struct BwdPlan {
  int nxc, XC, R, S, L, groups, blocks;
};

inline BwdPlan bwd_plan(int D, int H, int W) {
  BwdPlan p;
  p.nxc = km::ceil_div(W, BWD_XC_MAX);
  p.XC = km::ceil_div(W, p.nxc);
  p.R = BWD_POINTS / p.XC;
  if (p.R > BWD_ROWS_MAX) p.R = BWD_ROWS_MAX;
  p.S = p.R >= BWD_WARPS ? 1 : BWD_WARPS / p.R;
  p.L = km::ceil_div(p.XC, p.S);
  p.groups = km::ceil_div(static_cast<long long>(D) * H, p.R) * p.nxc;
  p.blocks = p.groups < BWD_BLOCKS_MAX ? p.groups : BWD_BLOCKS_MAX;
  return p;
}

// One row of partial sums per block, 7 T + 12 floats:
//   [0, 3T)           sum g_k U              -> g_theta's spline rows (t, k)
//   [3T, 3T + 12)     sum g_k, sum p_j g_k   -> g_theta's affine rows
//   [3T + 12, 4T+12)  2 sum m                (t)
//   [4T + 12, 7T+12)  -2 sum m p_j           (t, j)
// so that g_ctrl = ctrl * (2 sum m) + (-2 sum m p) once the rows are added.
template <int TC>
__global__ void __launch_bounds__(BWD_THREADS)
tps_planes_bwd_kernel(const float* __restrict__ theta,  // (B, T+4, 3)
                      const float* __restrict__ ctrl,   // (B, T, 3)
                      const float* __restrict__ g,      // (B, 3, N)
                      float* __restrict__ part,         // (B, blocks, 7T + 12)
                      int T, int D, int H, int W, float sd, float sh, float sw,
                      BwdPlan plan) {
  __shared__ float4 pt_s[BWD_POINTS];     // p2, g0, g1, g2
  __shared__ float2 row_s[BWD_ROWS_MAX];  // p0, p1
  __shared__ float red_s[BWD_WARPS][7 * TC][32];
  __shared__ float aff_s[BWD_WARPS][BWD_AFF];
  const int XC = plan.XC, R = plan.R, S = plan.S, L = plan.L;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(D) * H;
  const long long N = rows * W;
  const float* gb = g + static_cast<long long>(b) * 3 * N;
  const float* th = theta + static_cast<long long>(b) * (T + 4) * 3;
  const float* cb = ctrl + static_cast<long long>(b) * T * 3;
  float* pout = part + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * (7 * T + BWD_AFF);
  const int units = R * S;  // pieces of a group's rows; warp w takes pieces w, w + 8, ...

  // The control points are walked in tiles of 32 * TC, and for each tile the
  // block's groups are staged anew (T <= 128 is one tile). The affine rows'
  // sums are taken while the first tile stages.
  float aff[BWD_AFF];
#pragma unroll
  for (int k = 0; k < BWD_AFF; ++k) aff[k] = 0.f;
  for (int t0 = 0; t0 < T || t0 == 0; t0 += 32 * TC) {
    // lane l owns control points t0 + 32 j + l; one past T sums garbage that
    // is never written
    float c0[TC], c1[TC], c2[TC], w0[TC], w1[TC], w2[TC];
    float gu[TC][3], am[TC], a0[TC], a1[TC], a2[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int t = t0 + 32 * j + lane;
      const bool on = t < T;
      c0[j] = on ? cb[3 * t + 0] : 0.f;
      c1[j] = on ? cb[3 * t + 1] : 0.f;
      c2[j] = on ? cb[3 * t + 2] : 0.f;
      w0[j] = on ? th[3 * t + 0] : 0.f;
      w1[j] = on ? th[3 * t + 1] : 0.f;
      w2[j] = on ? th[3 * t + 2] : 0.f;
      gu[j][0] = gu[j][1] = gu[j][2] = am[j] = a0[j] = a1[j] = a2[j] = 0.f;
    }

    for (int grp = blockIdx.x; grp < plan.groups; grp += gridDim.x) {
      const long long r0 = static_cast<long long>(grp / plan.nxc) * R;
      const int x0 = (grp % plan.nxc) * XC;
      __syncthreads();  // the group before is used up
      // stage the group's points; a point past the end of a row or of the
      // grid gets a zero cotangent, which adds 0 to every sum
      if (threadIdx.x < R) {
        const long long row = min(r0 + threadIdx.x, rows - 1);
        row_s[threadIdx.x] = make_float2(grid_coord(static_cast<int>(row / H), sd),
                                         grid_coord(static_cast<int>(row % H), sh));
      }
      for (int i = threadIdx.x; i < R * XC; i += BWD_THREADS) {
        const int rr = i / XC, xx = i - rr * XC;
        const long long row = r0 + rr;
        const int x = x0 + xx;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < rows && x < W) {
          const long long n = row * W + x;
          q = make_float4(grid_coord(x, sw), gb[n], gb[N + n], gb[2 * N + n]);
          if (t0 == 0) {
            const float p0 = grid_coord(static_cast<int>(row / H), sd);
            const float p1 = grid_coord(static_cast<int>(row % H), sh);
            const float gk[3] = {q.y, q.z, q.w};
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              aff[k] += gk[k];
              aff[3 + k] = fmaf(p0, gk[k], aff[3 + k]);
              aff[6 + k] = fmaf(p1, gk[k], aff[6 + k]);
              aff[9 + k] = fmaf(q.x, gk[k], aff[9 + k]);
            }
          }
        }
        pt_s[i] = q;
      }
      __syncthreads();

      for (int u = warp; u < units; u += BWD_WARPS) {
        const int rr = u / S, sub = u - rr * S;
        const int xa = sub * L, xb = min(XC, xa + L);
        const float2 p01 = row_s[rr];
        const float4* q_s = pt_s + rr * XC;
        float dd[TC], rm[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const float d0 = c0[j] - p01.x, d1 = c1[j] - p01.y;
          dd[j] = __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
          rm[j] = 0.f;
        }
        for (int xx = xa; xx < xb; ++xx) {
          const float4 q = q_s[xx];  // all lanes read one point: a broadcast
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const float d2 = c2[j] - q.x;
            float du;
            const float uu = rbf<true>(__fadd_rn(dd[j], __fmul_rn(d2, d2)), du);
            const float m = (w0[j] * q.y + w1[j] * q.z + w2[j] * q.w) * du;
            gu[j][0] = fmaf(q.y, uu, gu[j][0]);
            gu[j][1] = fmaf(q.z, uu, gu[j][1]);
            gu[j][2] = fmaf(q.w, uu, gu[j][2]);
            rm[j] += m;
            a2[j] = fmaf(m, q.x, a2[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          am[j] += rm[j];
          a0[j] = fmaf(p01.x, rm[j], a0[j]);
          a1[j] = fmaf(p01.y, rm[j], a1[j]);
        }
      }
    }

    // add the eight warps' sums in a fixed order; warp w adds values w, w + 8, ...
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      red_s[warp][7 * j + 0][lane] = gu[j][0];
      red_s[warp][7 * j + 1][lane] = gu[j][1];
      red_s[warp][7 * j + 2][lane] = gu[j][2];
      red_s[warp][7 * j + 3][lane] = am[j];
      red_s[warp][7 * j + 4][lane] = a0[j];
      red_s[warp][7 * j + 5][lane] = a1[j];
      red_s[warp][7 * j + 6][lane] = a2[j];
    }
    if (t0 == 0) {
#pragma unroll
      for (int k = 0; k < BWD_AFF; ++k) {
        float v = aff[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) aff_s[warp][k] = v;
      }
    }
    // red_s is written again only behind the next tile's staging barriers
    __syncthreads();
    if (t0 == 0 && threadIdx.x < BWD_AFF) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < BWD_WARPS; ++q) s += aff_s[q][threadIdx.x];
      pout[3 * T + threadIdx.x] = s;
    }
    for (int v = warp; v < 7 * TC; v += BWD_WARPS) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < BWD_WARPS; ++q) s += red_s[q][v][lane];
      const int j = v / 7, k = v - 7 * j;
      const int t = t0 + 32 * j + lane;
      if (t >= T) continue;
      if (k < 3) pout[3 * t + k] = s;
      else if (k == 3) pout[3 * T + BWD_AFF + t] = 2.0f * s;
      else pout[4 * T + BWD_AFF + 3 * t + (k - 4)] = -2.0f * s;
    }
  }
}

template <int TC>
int launch_bwd(const float* theta, const float* ctrl, const float* g, float* part, int B, int T,
               int D, int H, int W, float sd, float sh, float sw, cudaStream_t stream) {
  const BwdPlan plan = bwd_plan(D, H, W);
  tps_planes_bwd_kernel<TC><<<dim3(plan.blocks, B), BWD_THREADS, 0, stream>>>(
      theta, ctrl, g, part, T, D, H, W, sd, sh, sw, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

KM_EXPORT int km_tps_planes(const void* theta, const void* ctrl, void* out,
                            int B, int T, int D, int H, int W,
                            float sd, float sh, float sw, void* stream) {
  const long long items = static_cast<long long>(D) * H * km::ceil_div(W, PLANES_P);
  dim3 grid(km::ceil_div(items, FWD_THREADS), B);
  tps_planes_kernel<PLANES_P><<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(ctrl),
      static_cast<float*>(out), T, D, H, W, sd, sh, sw);
  return static_cast<int>(cudaGetLastError());
}

KM_EXPORT int km_tps_flow(const void* theta, const void* ctrl, const void* points,
                          void* out, int B, int T, long long N, void* stream) {
  dim3 grid(km::ceil_div(N, FWD_THREADS * FLOW_P), B);
  tps_flow_kernel<FLOW_P><<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(ctrl),
      static_cast<const float*>(points), static_cast<float*>(out), T, N);
  return static_cast<int>(cudaGetLastError());
}

// Number of rows of partial sums the backward writes per batch item.
KM_EXPORT int km_tps_planes_bwd_blocks(int D, int H, int W) { return bwd_plan(D, H, W).blocks; }

// part: (B, km_tps_planes_bwd_blocks, 7 T + 12) fp32, every element written.
KM_EXPORT int km_tps_planes_bwd(const void* theta, const void* ctrl, const void* g,
                                void* part, int B, int T, int D, int H, int W,
                                float sd, float sh, float sw, void* stream) {
  // control points per lane: the fewest padded control points, then the most
  // reuse of each loaded point
  int tc = 1;
  long long best = -1;
  for (int c = 1; c <= BWD_TC_MAX; ++c) {
    const long long padded = static_cast<long long>(km::ceil_div(T, 32 * c)) * 32 * c;
    if (best < 0 || padded <= best) { best = padded; tc = c; }
  }
  const float* th = static_cast<const float*>(theta);
  const float* cb = static_cast<const float*>(ctrl);
  const float* gp = static_cast<const float*>(g);
  float* pp = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc) {
    case 1: return launch_bwd<1>(th, cb, gp, pp, B, T, D, H, W, sd, sh, sw, st);
    case 2: return launch_bwd<2>(th, cb, gp, pp, B, T, D, H, W, sd, sh, sw, st);
    case 3: return launch_bwd<3>(th, cb, gp, pp, B, T, D, H, W, sd, sh, sw, st);
    default: return launch_bwd<4>(th, cb, gp, pp, B, T, D, H, W, sd, sh, sw, st);
  }
}
