// Fused per-channel affine + 3x3x3 SAME conv + bias + ReLU (+ output stats)
// on the flat (Z, C, Y*X) layout: conv3x3_fused_flat and its parts and
// upconv forms.
//
// Replaces keymorph_tpu/ops/pallas/conv3d.py:_kernel_flat + _cell_compute
// (reached through _conv_pallas_group_flat <- _conv_pallas_flat /
// _conv_pallas_flat_parts / _conv_pallas_flat_upconv). One kernel serves
// all three: the input is the channel concat [A, B] of two sources split at
// channel Ca, where B is absent (plain), at full resolution (parts), or at
// half resolution and read at (z>>1, y>>1, x>>1) (upconv: the decoder's
// nearest-x2 upsample + concat, neither materialized).
//
//   y[z, co, y, x] = relu?(bias[co] + sum_{ci, taps} W[tap, ci, co] *
//                          pad0(bf16(a[ci] * x[ci] + b[ci]))[tap-shifted])
//
// Operands are bf16 values held in fp32 (bf16 x bf16 products are exact in
// fp32) and the sum accumulates in fp32: the arithmetic of keymorph_tpu's
// _conv_xla. Out-of-volume taps are 0 AFTER the affine (pad0(a*x+b)); the
// affine is applied with separate rounded multiply and add, as the plain
// version does. The stored output is bf16. With stats, each block writes
// per-Cout partial (sum y, sum y^2) of its stored bf16 values to a
// (n_tiles, Cout, 2) buffer that the wrapper reduces: no atomics, so results
// are deterministic.
//
// What bounds it on the H100: fp32 FMA issue. The U-Net's convs are 2-700
// GMAC each at 256^3 input, far above the bytes they move, and this simple
// port does not use the tensor cores. The design keeps the FMA pipes fed:
// a block owns a 4 (z) x 8 (y) x 32 (x) output tile and 16 output channels;
// each Cin chunk's halo tile (6 x 10 x 34 x 4 values, already affined and
// rounded) and its bf16 weights are staged once in shared memory; each
// thread owns one (y, x) column of 4 z outputs x 16 channels in registers
// and, per (ci, dy, dx), loads 6 input values (conflict-free: a warp reads
// 32 consecutive x) and broadcast weights for 3 * 4 * 16 = 192 FMAs.
// Tensor cores (wgmma), TMA staging and the TPU's 2^3 parity folding for
// the upconv are later speed-ups.
//
// The conv's input gradient (conv3x3_input_grad) runs the same device code
// in its GRAD instantiation. It replaces keymorph_tpu/ops/pallas/conv3d.py:
// _kernel (reached through _conv_pallas_group <- _conv_pallas <- _conv_bwd),
// which on the training path computes
//
//   g_u[z, ci, y, x] = sum_{co, taps} W[2-dz, 2-dy, 2-dx, ci, co] *
//                      pad0(g_v)[z+dz-1, co, y+dy-1, x+dx-1]
//
// i.e. the same 3x3x3 SAME conv over the cotangent with the taps flipped and
// the channel roles swapped (the wrapper repacks the weights so), bf16
// operands, fp32 sums, bf16 result. The GRAD instantiation stages the
// cotangent as it is (no affine, no rounding step), adds no bias, applies no
// ReLU, emits no stats, and writes its channels to two tensors split at
// channel Csplit: the two halves of a two-source conv's input gradient. The
// same bound applies (fp32 FMA throughput); the work is that of the forward
// conv.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int TX = 32, TY = 8, TZ = 4;  // output tile (x, y, z)
constexpr int CO = 16;                  // output channels per block
constexpr int CI = 4;                   // input channels per shared-memory chunk
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int HALO = HZ * HY * HX;
constexpr int THREADS = TX * TY;

struct ConvArgs {
  const __nv_bfloat16* xa;  // (Z, Ca, Y*X)
  const __nv_bfloat16* xb;  // (Z, Cb, Y*X) or (Z/2, Cb, Y/2*X/2), may be null
  const float* scale;       // (Cin,)
  const float* shift;       // (Cin,)
  const float* w;           // (Cin, 27, CoutP) bf16-rounded values
  const float* bias;        // (Cout,)
  __nv_bfloat16* out;       // (Z, Csplit, Y*X): output channels [0, Csplit)
  __nv_bfloat16* out_b;     // (Z, Cout - Csplit, Y*X): the rest, or null
  float* stats;             // (n_tiles, Cout, 2) or null
  int Z, Y, X, Ca, Cb, Cout, CoutP, Csplit, b_lowres, relu;
};

template <bool GRAD>
__device__ __forceinline__ float load_in(const ConvArgs& p, int c, int z, int y, int x) {
  // pad0(bf16(a*x + b)): out-of-volume taps and padded channels are 0
  const int Cin = p.Ca + p.Cb;
  if (c >= Cin || z < 0 || z >= p.Z || y < 0 || y >= p.Y || x < 0 || x >= p.X) return 0.0f;
  float v;
  if (c < p.Ca) {
    const long long off = (static_cast<long long>(z) * p.Ca + c) * p.Y * p.X +
                          static_cast<long long>(y) * p.X + x;
    v = __bfloat162float(p.xa[off]);
    if (GRAD) return v;  // the cotangent as it is: one source, no affine
  } else if (p.b_lowres) {
    const int Yl = p.Y >> 1, Xl = p.X >> 1;
    const long long off = (static_cast<long long>(z >> 1) * p.Cb + (c - p.Ca)) * Yl * Xl +
                          static_cast<long long>(y >> 1) * Xl + (x >> 1);
    v = __bfloat162float(p.xb[off]);
  } else {
    const long long off = (static_cast<long long>(z) * p.Cb + (c - p.Ca)) * p.Y * p.X +
                          static_cast<long long>(y) * p.X + x;
    v = __bfloat162float(p.xb[off]);
  }
  const float u = __fadd_rn(__fmul_rn(p.scale[c], v), p.shift[c]);
  return __bfloat162float(__float2bfloat16_rn(u));
}

template <bool GRAD>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_kernel(ConvArgs p) {
  __shared__ __align__(16) float in_s[CI * HALO];
  __shared__ __align__(16) float w_s[CI * 27 * CO];

  const int ntx = (p.X + TX - 1) / TX, nty = (p.Y + TY - 1) / TY;
  const int tile = blockIdx.x;
  const int x0 = (tile % ntx) * TX;
  const int y0 = ((tile / ntx) % nty) * TY;
  const int z0 = (tile / (ntx * nty)) * TZ;
  const int co0 = blockIdx.y * CO;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int Cin = p.Ca + p.Cb;

  float acc[TZ][CO];
#pragma unroll
  for (int i = 0; i < TZ; ++i)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.0f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI) {
    __syncthreads();  // the previous chunk's compute is done with in_s/w_s
    for (int i = threadIdx.x; i < CI * HALO; i += THREADS) {
      const int lx = i % HX;
      int r = i / HX;
      const int ly = r % HY;
      r /= HY;
      const int lz = r % HZ;
      const int c = r / HZ;
      in_s[i] = load_in<GRAD>(p, ci0 + c, z0 - 1 + lz, y0 - 1 + ly, x0 - 1 + lx);
    }
    for (int i = threadIdx.x; i < CI * 27 * CO; i += THREADS) {
      const int co = i % CO;
      const int tap = (i / CO) % 27;
      const int c = i / (CO * 27);
      const int cg = ci0 + c;
      w_s[i] = cg < Cin ? p.w[(static_cast<long long>(cg) * 27 + tap) * p.CoutP + co0 + co] : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < CI; ++c) {
      const float* in_c = in_s + c * HALO;
      const float* w_c = w_s + c * 27 * CO;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float col[TZ + 2];
#pragma unroll
          for (int lz = 0; lz < TZ + 2; ++lz) col[lz] = in_c[(lz * HY + ty + dy) * HX + tx + dx];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float4* wp = reinterpret_cast<const float4*>(w_c + ((dz * 3 + dy) * 3 + dx) * CO);
            float wv[CO];
#pragma unroll
            for (int q = 0; q < CO / 4; ++q) {
              const float4 t = wp[q];
              wv[4 * q + 0] = t.x;
              wv[4 * q + 1] = t.y;
              wv[4 * q + 2] = t.z;
              wv[4 * q + 3] = t.w;
            }
#pragma unroll
            for (int zo = 0; zo < TZ; ++zo)
#pragma unroll
              for (int co = 0; co < CO; ++co) acc[zo][co] = fmaf(col[zo + dz], wv[co], acc[zo][co]);
          }
        }
      }
    }
  }

  // epilogue: bias, ReLU, bf16 store, stats of the stored values
  const int y = y0 + ty, x = x0 + tx;
  const long long YX = static_cast<long long>(p.Y) * p.X;
  float s1[CO], s2[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    s1[co] = 0.0f;
    s2[co] = 0.0f;
  }
#pragma unroll
  for (int zo = 0; zo < TZ; ++zo) {
    const int z = z0 + zo;
    if (z >= p.Z || y >= p.Y || x >= p.X) continue;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      const int cg = co0 + co;
      if (cg >= p.Cout) continue;
      const long long yx = static_cast<long long>(y) * p.X + x;
      if (GRAD) {
        const __nv_bfloat16 h = __float2bfloat16_rn(acc[zo][co]);
        if (cg < p.Csplit)
          p.out[(static_cast<long long>(z) * p.Csplit + cg) * YX + yx] = h;
        else
          p.out_b[(static_cast<long long>(z) * (p.Cout - p.Csplit) + cg - p.Csplit) * YX + yx] = h;
        continue;
      }
      float v = acc[zo][co] + p.bias[cg];
      if (p.relu) v = fmaxf(v, 0.0f);
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      p.out[(static_cast<long long>(z) * p.Cout + cg) * YX + yx] = h;
      const float f = __bfloat162float(h);
      s1[co] += f;
      s2[co] = fmaf(f, f, s2[co]);
    }
  }
  if constexpr (!GRAD) {
    if (p.stats == nullptr) return;
    // block reduction: warp shuffles, then one value per warp in shared memory
#pragma unroll
    for (int co = 0; co < CO; ++co) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1[co] += __shfl_xor_sync(0xffffffffu, s1[co], o);
        s2[co] += __shfl_xor_sync(0xffffffffu, s2[co], o);
      }
    }
    __syncthreads();  // in_s is free: reuse it for the per-warp partials
    float* red = in_s;  // (THREADS / 32, CO, 2)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
#pragma unroll
      for (int co = 0; co < CO; ++co) {
        red[(warp * CO + co) * 2 + 0] = s1[co];
        red[(warp * CO + co) * 2 + 1] = s2[co];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * CO) {
      const int co = threadIdx.x / 2, k = threadIdx.x % 2;
      float s = 0.0f;
      for (int w = 0; w < THREADS / 32; ++w) s += red[(w * CO + co) * 2 + k];
      const int cg = co0 + co;
      if (cg < p.Cout) p.stats[(static_cast<long long>(tile) * p.Cout + cg) * 2 + k] = s;
    }
  }
}

}  // namespace

KM_EXPORT int km_conv3x3_tiles(int Z, int Y, int X) {
  return ((X + TX - 1) / TX) * ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
}

KM_EXPORT int km_conv3x3_cout_block() { return CO; }

KM_EXPORT int km_conv3x3(const void* xa, const void* xb, const void* scale,
                         const void* shift, const void* w, const void* bias,
                         void* out, void* stats, int Z, int Y, int X, int Ca,
                         int Cb, int Cout, int CoutP, int b_lowres, int relu,
                         void* stream) {
  ConvArgs p;
  p.xa = static_cast<const __nv_bfloat16*>(xa);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_b = nullptr;
  p.stats = static_cast<float*>(stats);
  p.Z = Z; p.Y = Y; p.X = X; p.Ca = Ca; p.Cb = Cb;
  p.Cout = Cout; p.CoutP = CoutP; p.Csplit = Cout; p.b_lowres = b_lowres; p.relu = relu;
  dim3 grid(km_conv3x3_tiles(Z, Y, X), (Cout + CO - 1) / CO);
  conv3x3_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// g_v (Z, Cg, Y*X) bf16 -> g_u: channels [0, Ca) into out_a (Z, Ca, Y*X) and
// [Ca, Ca + Cb) into out_b (Z, Cb, Y*X; null when Cb == 0). w is the repacked
// (Cg, 27, CinP) fp32 tensor w[co, tap, ci] = W[26 - tap, ci, co], CinP being
// Ca + Cb padded to the block's channel count.
KM_EXPORT int km_conv3x3_input_grad(const void* gv, const void* w, void* out_a,
                                    void* out_b, int Z, int Y, int X, int Cg,
                                    int Ca, int Cb, int CinP, void* stream) {
  ConvArgs p;
  p.xa = static_cast<const __nv_bfloat16*>(gv);
  p.xb = nullptr;
  p.scale = nullptr;
  p.shift = nullptr;
  p.w = static_cast<const float*>(w);
  p.bias = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out_a);
  p.out_b = static_cast<__nv_bfloat16*>(out_b);
  p.stats = nullptr;
  p.Z = Z; p.Y = Y; p.X = X; p.Ca = Cg; p.Cb = 0;
  p.Cout = Ca + Cb; p.CoutP = CinP; p.Csplit = Ca; p.b_lowres = 0; p.relu = 0;
  dim3 grid(km_conv3x3_tiles(Z, Y, X), (p.Cout + CO - 1) / CO);
  conv3x3_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
