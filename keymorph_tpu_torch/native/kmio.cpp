// libkmio — host-side IO and preprocessing helper of keymorph_tpu_torch's
// data layer (a copy of keymorph_tpu/native/kmio.cpp). It runs on the host
// that feeds the GPU, not on the device: gzip inflation of .nii.gz volumes
// and a trilinear / nearest volume resize.
//
// Built at first use by kmio.py (g++ -O3 -fPIC -shared -lz) into
// build/keymorph_tpu_torch/<hash>/libkmio.so at the repository root.
//
// Exports (C ABI, consumed via ctypes in kmio.py):
//   km_gunzip(path, &out)                 — whole-file gzip inflate
//   km_free(ptr)                          — release km_gunzip buffer
//   km_resize_trilinear(src, d0,d1,d2,
//                       dst, t0,t1,t2, nearest)
//       — volume resize with align_corners=False voxel-center mapping,
//         matching keymorph_tpu_torch.data.preprocess.resize_volume.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// Inflate an entire .gz file into a malloc'd buffer. Returns byte count or
// a negative error code. Caller frees with km_free.
long long km_gunzip(const char* path, char** out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  // large internal buffer: fewer syscalls on big volumes
  gzbuffer(f, 1 << 20);
  size_t cap = 16 << 20, len = 0;
  char* buf = static_cast<char*>(malloc(cap));
  if (!buf) { gzclose(f); return -2; }
  for (;;) {
    if (len == cap) {
      cap *= 2;
      char* nb = static_cast<char*>(realloc(buf, cap));
      if (!nb) { free(buf); gzclose(f); return -2; }
      buf = nb;
    }
    int n = gzread(f, buf + len, static_cast<unsigned>(cap - len));
    if (n < 0) { free(buf); gzclose(f); return -3; }
    if (n == 0) break;
    len += static_cast<size_t>(n);
  }
  gzclose(f);
  *out = buf;
  return static_cast<long long>(len);
}

void km_free(char* p) { free(p); }

static inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Resize (d0,d1,d2) -> (t0,t1,t2), C-ordered float32 volumes.
// Output voxel j maps to input coordinate (j + 0.5) * (n_in / n_out) - 0.5.
int km_resize_trilinear(const float* src, int d0, int d1, int d2,
                        float* dst, int t0, int t1, int t2, int nearest) {
  if (!src || !dst) return 1;
  const double s0 = static_cast<double>(d0) / t0;
  const double s1 = static_cast<double>(d1) / t1;
  const double s2 = static_cast<double>(d2) / t2;
  const long long str0 = static_cast<long long>(d1) * d2;
  const long long str1 = d2;

  // precompute per-axis indices/weights once (separable mapping)
  std::vector<int> lo0(t0), lo1(t1), lo2(t2), hi0(t0), hi1(t1), hi2(t2);
  std::vector<float> w0(t0), w1(t1), w2(t2);
  auto prep = [nearest](int t, int d, double s, std::vector<int>& lo,
                        std::vector<int>& hi, std::vector<float>& w) {
    for (int j = 0; j < t; ++j) {
      double c = (j + 0.5) * s - 0.5;
      if (nearest) {
        // round half to even, matching numpy/torch nearest semantics
        int r = static_cast<int>(std::nearbyint(c));
        if (r < 0) r = 0;
        if (r > d - 1) r = d - 1;
        lo[j] = hi[j] = r;
        w[j] = 0.f;
      } else {
        double fl = std::floor(c);
        int l = static_cast<int>(fl);
        int h = l + 1;
        w[j] = static_cast<float>(c - fl);
        lo[j] = l < 0 ? 0 : (l > d - 1 ? d - 1 : l);
        hi[j] = h < 0 ? 0 : (h > d - 1 ? d - 1 : h);
      }
    }
  };
  prep(t0, d0, s0, lo0, hi0, w0);
  prep(t1, d1, s1, lo1, hi1, w1);
  prep(t2, d2, s2, lo2, hi2, w2);

  for (int i = 0; i < t0; ++i) {
    const float wi = w0[i];
    const long long a0 = lo0[i] * str0, b0 = hi0[i] * str0;
    for (int j = 0; j < t1; ++j) {
      const float wj = w1[j];
      const long long a1 = lo1[j] * str1, b1 = hi1[j] * str1;
      float* drow = dst + (static_cast<long long>(i) * t1 + j) * t2;
      if (nearest) {
        const float* srow = src + a0 + a1;
        for (int k = 0; k < t2; ++k) drow[k] = srow[lo2[k]];
        continue;
      }
      const float* p00 = src + a0 + a1;
      const float* p01 = src + a0 + b1;
      const float* p10 = src + b0 + a1;
      const float* p11 = src + b0 + b1;
      for (int k = 0; k < t2; ++k) {
        const float wk = w2[k];
        const int l2 = lo2[k], h2 = hi2[k];
        const float c00 = p00[l2] * (1 - wk) + p00[h2] * wk;
        const float c01 = p01[l2] * (1 - wk) + p01[h2] * wk;
        const float c10 = p10[l2] * (1 - wk) + p10[h2] * wk;
        const float c11 = p11[l2] * (1 - wk) + p11[h2] * wk;
        const float c0 = c00 * (1 - wj) + c01 * wj;
        const float c1 = c10 * (1 - wj) + c11 * wj;
        drow[k] = c0 * (1 - wi) + c1 * wi;
      }
    }
  }
  (void)clampf;
  return 0;
}

}  // extern "C"
