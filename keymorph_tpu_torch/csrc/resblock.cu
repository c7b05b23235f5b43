// The residual U-Nets' one-pass kernels on the flat (Z, C, Y*X) bf16 layout
// (models/fast_resunet.py), beside the convs of conv3d.cu: the block's lift,
// its scSE gate and the gate's backward, and the encoders' 2x max-pool.
//
// lift1x1_kernel: the block's 1x1 lift where the widths change, with its bias,
//
//   out[co, v] = bf16(sum_ci w[co, ci] x[ci, v] + b[co])
//
// bf16 operands, an fp32 sum, one rounding (the bf16 Conv3d module's), and the
// per-channel partial (sum, sum of squares) of the stored bf16 values, one
// row a block, for the next GroupNorm. A thread owns four voxels of one z
// plane, 256 apart (a warp's loads and stores contiguous), and walks the
// output channels eight at a time: per input channel four loads of x and two
// 16-byte loads of the transposed weights feed 32 products (the lift is 2 Cin
// Cout operations a voxel, at most 128 x 256 here). Each channel's partial
// sums over a warp's 128 voxels go to shared memory and are added in warp
// order: no atomics, the same inputs give the same bits.
//
// maxpool2_kernel: 2x max-pool (VALID, floor), a thread an output voxel of
// one channel, NaN propagating (torch's amax, fast_unet's reshape-and-amax);
// bound by reading the input once.
//
// scse_gate_kernel: the concurrent spatial and channel squeeze-and-excitation
// gate (scSE; Roy, Navab and Wachinger, MICCAI 2018) of the block's output,
//
//   g_s[v]    = bf16(sigmoid(bf16(sum_c w_s[c] x[c, v] + b_s)))
//   out[c, v] = max(bf16(x[c, v] * g_c[c]), bf16(x[c, v] * g_s[v]))
//
// the rounding order of the bf16 ChannelSpatialSE module (models/unet.py):
// the 1x1 conv C -> 1 on bf16 operands with an fp32 sum and a bf16 result,
// the sigmoid of that value rounded to bf16, each gated product rounded to
// bf16, their maximum. The channel gate g_c (C,) comes in as bf16 values:
// the squeeze (the per-channel mean) is the previous conv's emitted stats and
// the C -> C -> C MLP is tiny, so both stay with the caller. A thread owns
// one voxel of one z plane: it reads the voxel's C values (neighbouring
// threads read neighbouring voxels of each channel plane, so a warp's loads
// are contiguous), forms g_s, then reads them again (from L1/L2: a block's
// 256 voxels x C channels were just read) and writes the gated values once.
//
// scse_gate_bwd_kernel: the gate's backward for the output's cotangent G,
// every rounding passed straight through, ties of the two gated values split
// evenly (torch.maximum's autograd): with w = [a > b] + [a == b] / 2,
//
//   dg_s[v]   = sum_c G (1 - w) x;   dss[v] = dg_s g_s (1 - g_s)
//   g_x[c, v] = bf16(G w g_c[c] + G (1 - w) g_s[v] + w_s[c] dss[v])
//   dg_c[c]   = sum_v G w x,  dw_s[c] = sum_v dss x,  db_s = sum_v dss
//
// One pass, a thread a voxel as in the forward: it forms g_s again from its
// voxel's C values, then reads x and G to form dg_s and its terms of dg_c,
// then again to write g_x and its terms of dw_s (the repeated reads come from
// L1/L2: a block's 256 voxels x C channels were just read). The per-channel
// sums go over a warp by shuffles and over a block's warps in order, one row
// of (dg_c, dw_s, db_s) partials a block, which the wrapper adds in block
// order: no atomics. The squeeze's cotangent (the MLP's backward on (C,))
// reaches x through the conv stats it came from, so no second pass is needed.
//
// The lift, the gate and its backward are bound by bytes: their inputs read
// once from device memory and their output written once (the backward: 32
// registers, no spill; nvcc -Xptxas -v, sm_90a, CUDA 12.8).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int RB_THREADS = 256;
constexpr int RB_WARPS = RB_THREADS / 32;

constexpr int LIFT_VT = 4;  // voxels a thread, 256 apart
constexpr int LIFT_CT = 8;  // output channels a pass

__global__ void __launch_bounds__(RB_THREADS)
    lift1x1_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ b, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ stats, int Cin, int Cout, int CoutP, long long YX) {
  extern __shared__ float red[];  // (RB_WARPS, Cout, 2)
  const long long v0 = static_cast<long long>(blockIdx.x) * RB_THREADS * LIFT_VT + threadIdx.x;
  const long long z = blockIdx.y;
  const __nv_bfloat16* xin = x + z * Cin * YX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int co0 = 0; co0 < Cout; co0 += LIFT_CT) {
    float acc[LIFT_VT][LIFT_CT];
#pragma unroll
    for (int k = 0; k < LIFT_VT; ++k)
#pragma unroll
      for (int c = 0; c < LIFT_CT; ++c) acc[k][c] = 0.0f;
    for (int ci = 0; ci < Cin; ++ci) {
      const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + ci * CoutP + co0));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + ci * CoutP + co0 + 4));
      const float wv[LIFT_CT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int k = 0; k < LIFT_VT; ++k) {
        const long long v = v0 + k * RB_THREADS;
        const float xv = v < YX ? __bfloat162float(xin[ci * YX + v]) : 0.0f;
#pragma unroll
        for (int c = 0; c < LIFT_CT; ++c) acc[k][c] = fmaf(wv[c], xv, acc[k][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < LIFT_CT; ++c) {
      const int co = co0 + c;
      if (co >= Cout) break;  // the same for every thread
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < LIFT_VT; ++k) {
        const long long v = v0 + k * RB_THREADS;
        if (v >= YX) continue;
        const __nv_bfloat16 y = __float2bfloat16_rn(acc[k][c] + b[co]);
        out[(z * Cout + co) * YX + v] = y;
        const float f = __bfloat162float(y);
        s1 += f;
        s2 = fmaf(f, f, s2);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      }
      if (lane == 0) {
        red[(warp * Cout + co) * 2 + 0] = s1;
        red[(warp * Cout + co) * 2 + 1] = s2;
      }
    }
  }
  __syncthreads();
  float* row = stats + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * Cout * 2;
  for (int i = threadIdx.x; i < 2 * Cout; i += RB_THREADS) {
    float sum = 0.0f;
    for (int k = 0; k < RB_WARPS; ++k) sum += red[k * Cout * 2 + i];
    row[i] = sum;
  }
}

// 2x max-pool (VALID, floor) of one channel plane pair: out (Zh, C, Yh*Xh) from
// x (Z, C, Y*X), a thread an output voxel; NaN propagates, as torch's amax.
__global__ void __launch_bounds__(RB_THREADS)
    maxpool2_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int C,
                    int Y, int X, int Yh, int Xh) {
  const int v = blockIdx.x * RB_THREADS + threadIdx.x;
  if (v >= Yh * Xh) return;
  const int yh = v / Xh, xh = v - yh * Xh;
  const long long c = blockIdx.y, zh = blockIdx.z;
  const long long YX = static_cast<long long>(Y) * X;
  const __nv_bfloat16* p = x + (2 * zh * C + c) * YX + (2LL * yh) * X + 2 * xh;
  float m = __bfloat162float(p[0]);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float f = __bfloat162float(p[dz * C * YX + dy * X + dx]);
        m = (f != f || f > m) ? f : m;
      }
  out[(zh * C + c) * Yh * Xh + v] = __float2bfloat16_rn(m);
}

__global__ void __launch_bounds__(RB_THREADS)
    scse_gate_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gc,
                     const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int C,
                     long long YX) {
  const long long v = static_cast<long long>(blockIdx.x) * RB_THREADS + threadIdx.x;
  if (v >= YX) return;
  const long long base = static_cast<long long>(blockIdx.y) * C * YX + v;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) s = fmaf(ws[c], __bfloat162float(x[base + c * YX]), s);
  const float ss = __bfloat162float(__float2bfloat16_rn(s + ws[C]));
  const float gs = __bfloat162float(__float2bfloat16_rn(1.0f / (1.0f + expf(-ss))));
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const float xv = __bfloat162float(x[base + c * YX]);
    const float a = __bfloat162float(__float2bfloat16_rn(xv * gc[c]));
    const float g = __bfloat162float(__float2bfloat16_rn(xv * gs));
    out[base + c * YX] = __float2bfloat16_rn(fmaxf(a, g));
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__global__ void __launch_bounds__(RB_THREADS)
    scse_gate_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ gc, const float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ gx, float* __restrict__ part, int C,
                         long long YX) {
  extern __shared__ float red[];  // (RB_WARPS, 2C + 1)
  const int W = 2 * C + 1;
  const long long v = static_cast<long long>(blockIdx.x) * RB_THREADS + threadIdx.x;
  const bool in = v < YX;
  const long long base = static_cast<long long>(blockIdx.y) * C * YX + (in ? v : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) s = fmaf(ws[c], __bfloat162float(x[base + c * YX]), s);
  const float gs = bf16r(1.0f / (1.0f + expf(-bf16r(s + ws[C]))));
  float dgs = 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float xv = in ? __bfloat162float(x[base + c * YX]) : 0.0f;
    const float gv = in ? __bfloat162float(g[base + c * YX]) : 0.0f;
    const float a = bf16r(xv * gc[c]), b = bf16r(xv * gs);
    const float w = a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
    dgs = fmaf(gv * (1.0f - w), xv, dgs);
    const float t = warp_sum(gv * w * xv);
    if (lane == 0) red[warp * W + c] = t;
  }
  const float dss = dgs * gs * (1.0f - gs);
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float xv = in ? __bfloat162float(x[base + c * YX]) : 0.0f;
    const float gv = in ? __bfloat162float(g[base + c * YX]) : 0.0f;
    const float a = bf16r(xv * gc[c]), b = bf16r(xv * gs);
    const float w = a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
    if (in) gx[base + c * YX] = __float2bfloat16_rn(gv * w * gc[c] + gv * (1.0f - w) * gs + ws[c] * dss);
    const float t = warp_sum(dss * xv);
    if (lane == 0) red[warp * W + C + c] = t;
  }
  const float tb = warp_sum(dss);
  if (lane == 0) red[warp * W + 2 * C] = tb;
  __syncthreads();
  float* row = part + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * W;
  for (int i = threadIdx.x; i < W; i += RB_THREADS) {
    float sum = 0.0f;
    for (int k = 0; k < RB_WARPS; ++k) sum += red[k * W + i];
    row[i] = sum;
  }
}

bool grid_ok(int Z, int C, long long YX) {
  return Z >= 1 && Z <= km::kMaxGridY && C >= 1 && YX >= 1;
}

}  // namespace

// x (Z, Cin, Y*X) bf16 -> out (Z, Cout, Y*X) bf16; wt (Cin, CoutP) and b
// (CoutP,): the weights transposed and both zero-padded to CoutP, a multiple
// of 8, fp32 holding bf16 values; stats (ceil(Y*X / 1024) * Z, Cout, 2) fp32:
// each block's (sum, sum of squares) of its stored outputs, blocks in (z,
// voxel block) order.
KM_EXPORT int km_lift1x1(const void* x, const void* wt, const void* b, void* out, void* stats,
                         int Z, int Cin, int Cout, int CoutP, long long YX, void* stream) {
  if (!grid_ok(Z, Cin, YX) || Cout < 1 || Cout > 1024 || CoutP % LIFT_CT || CoutP < Cout)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(km::ceil_div(YX, RB_THREADS * LIFT_VT), Z);
  const size_t smem = static_cast<size_t>(RB_WARPS) * Cout * 2 * sizeof(float);
  lift1x1_kernel<<<grid, RB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), static_cast<float*>(stats),
      Cin, Cout, CoutP, YX);
  return static_cast<int>(cudaGetLastError());
}

// x (Z, C, Y*X) bf16 -> out (Z/2, C, (Y/2)*(X/2)) bf16, floor.
KM_EXPORT int km_maxpool2(const void* x, void* out, int Z, int C, int Y, int X, void* stream) {
  const int Zh = Z / 2, Yh = Y / 2, Xh = X / 2;
  if (Zh < 1 || Yh < 1 || Xh < 1 || C > km::kMaxGridY || Zh > km::kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(km::ceil_div(static_cast<long long>(Yh) * Xh, RB_THREADS), C, Zh);
  maxpool2_kernel<<<grid, RB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), C, Y, X, Yh, Xh);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (Z, C, Y*X) bf16 (out may not alias x); gc (C,) and ws (C + 1,):
// fp32 holding bf16 values, ws the spatial gate's 1x1 weights then its bias.
KM_EXPORT int km_scse_gate(const void* x, const void* gc, const void* ws, void* out, int Z, int C,
                           long long YX, void* stream) {
  if (!grid_ok(Z, C, YX)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(km::ceil_div(YX, RB_THREADS), Z);
  scse_gate_kernel<<<grid, RB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gc),
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), C, YX);
  return static_cast<int>(cudaGetLastError());
}

// The gate's backward: x, g, gx (Z, C, Y*X) bf16 (gx may not alias them); gc
// (C,) and ws (C + 1,) as km_scse_gate takes them; part (Z * blocks, 2C + 1)
// fp32, blocks = ceil(Y*X / 256): each block's partial (dg_c, dw_s, db_s),
// blocks in (z, voxel block) order.
KM_EXPORT int km_scse_gate_bwd(const void* x, const void* g, const void* gc, const void* ws,
                               void* gx, void* part, int Z, int C, int blocks, long long YX,
                               void* stream) {
  if (!grid_ok(Z, C, YX) || C > 512 || blocks != km::ceil_div(YX, RB_THREADS))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, Z);
  const size_t smem = static_cast<size_t>(RB_WARPS) * (2 * C + 1) * sizeof(float);
  scse_gate_bwd_kernel<<<grid, RB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(gc), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(gx), static_cast<float*>(part), C, YX);
  return static_cast<int>(cudaGetLastError());
}
