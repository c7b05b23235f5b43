// The residual U-Nets' one-pass kernels on the flat (Z, C, Y*X) bf16 layout
// (models/fast_resunet.py), beside the convs of conv3d.cu: the block's lift,
// its scSE gate, and the encoders' 2x max-pool.
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
// The lift and the gate are bound by bytes: their input read once from
// device memory and their output written once.
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
