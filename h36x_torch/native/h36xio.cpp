// h36x_torch native host runtime: threaded uint8 crop + bilinear resize
// and the photometric jitter for the extraction decode workers. A copy of
// h36x/native/h36xio.cpp: the two libraries give the same bytes, which is
// what lets a store written by either package match the other's.
//
// A whole clip per call on the library's own worker threads, no per-frame
// Python dispatch. Sampling convention: bilinear align_corners=False
// (half-pixel centers), i.e. torchvision's resize(antialias=False) on the
// cropped tensor.
//
// Build: h36x_torch/native/__init__.py runs g++ at first use into
// build/h36x_torch/ (the flags are there).
// ABI: plain C functions, loaded via ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Grid {
  std::vector<int> lo, hi;
  std::vector<float> frac;
};

// Sampling grid for crop [start, start+size) resized to out (half-pixel).
Grid make_grid(int start, int size, int in_size, int out) {
  Grid g;
  g.lo.resize(out);
  g.hi.resize(out);
  g.frac.resize(out);
  const double scale = static_cast<double>(size) / out;
  for (int i = 0; i < out; ++i) {
    double src = start + (i + 0.5) * scale - 0.5;
    src = std::min(std::max(src, static_cast<double>(start)),
                   static_cast<double>(start + size - 1));
    src = std::min(std::max(src, 0.0), static_cast<double>(in_size - 1));
    int lo = static_cast<int>(std::floor(src));
    g.lo[i] = lo;
    g.hi[i] = std::min(lo + 1, in_size - 1);
    g.frac[i] = static_cast<float>(src - lo);
  }
  return g;
}

void resize_frame(const uint8_t* src, int H, int W, const Grid& gy,
                  const Grid& gx, int out, uint8_t* dst) {
  // Two-pass separable: rows first into a float scratch, then columns.
  // The vertical pass only materializes the column window the horizontal
  // pass will read ([x0, x1] = the crop's x-support), not the full width.
  const int x0 = *std::min_element(gx.lo.begin(), gx.lo.end());
  const int x1 = *std::max_element(gx.hi.begin(), gx.hi.end());
  const int wc = x1 - x0 + 1;
  std::vector<float> rows(static_cast<size_t>(out) * wc * 3);
  for (int oy = 0; oy < out; ++oy) {
    const uint8_t* r0 = src + (static_cast<size_t>(gy.lo[oy]) * W + x0) * 3;
    const uint8_t* r1 = src + (static_cast<size_t>(gy.hi[oy]) * W + x0) * 3;
    const float fy = gy.frac[oy];
    float* dr = rows.data() + static_cast<size_t>(oy) * wc * 3;
    for (int x = 0; x < wc * 3; ++x) {
      dr[x] = (1.0f - fy) * r0[x] + fy * r1[x];
    }
  }
  for (int oy = 0; oy < out; ++oy) {
    const float* dr = rows.data() + static_cast<size_t>(oy) * wc * 3;
    uint8_t* out_row = dst + static_cast<size_t>(oy) * out * 3;
    for (int ox = 0; ox < out; ++ox) {
      const float fx = gx.frac[ox];
      const float* p0 = dr + static_cast<size_t>(gx.lo[ox] - x0) * 3;
      const float* p1 = dr + static_cast<size_t>(gx.hi[ox] - x0) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1.0f - fx) * p0[c] + fx * p1[c];
        out_row[ox * 3 + c] =
            static_cast<uint8_t>(std::min(std::max(v + 0.5f, 0.0f), 255.0f));
      }
    }
  }
}

// HSV hue shift over deinterleaved channel planes, mirroring
// augment._np_hue op-for-op (see h36x_jitter_clip_u8). A free function with
// __restrict planes so the vectorizer sees independent unit-stride streams;
// `#pragma omp simd` if-converts the select chains.
void hue_shift_planar(float* __restrict R, float* __restrict G,
                      float* __restrict B, size_t npix, float fh) {
#pragma omp simd
  for (size_t i = 0; i < npix; ++i) {
    const float r = R[i], g = G[i], b = B[i];
    const float maxc = std::max(r, std::max(g, b));
    const float minc = std::min(r, std::min(g, b));
    const float rng = maxc - minc;
    const float sat = maxc > 0.0f ? rng / std::max(maxc, 1e-12f) : 0.0f;
    const float safe = std::max(rng, 1e-12f);
    const float rc = (maxc - r) / safe;
    const float gc = (maxc - g) / safe;
    const float bc = (maxc - b) / safe;
    float h = (maxc == r)   ? bc - gc
              : (maxc == g) ? 2.0f + rc - bc
                            : 4.0f + gc - rc;
    h = rng > 0.0f ? (h / 6.0f) - std::floor(h / 6.0f) : 0.0f;
    h = (h + fh) - std::floor(h + fh);
    const float h6 = h * 6.0f;
    const float fi = std::floor(h6);
    const float f = h6 - fi;
    const float pp = maxc * (1.0f - sat);
    const float q = maxc * (1.0f - f * sat);
    const float tt = maxc * (1.0f - (1.0f - f) * sat);
    const float k = fi >= 6.0f ? 0.0f : fi;  // h==1 edge, as (int)%6
    // choose tables: r=[v,q,p,p,t,v] g=[t,v,v,q,p,p] b=[p,p,t,v,v,q].
    // Flat single-condition select chains: GCC 12 if-converts these into
    // vector blends, but gives up on nested/compound-condition ternaries
    // ("no vectype" — verified with -fopt-info-vec-all).
    float r_o = maxc;
    r_o = (k == 1.0f) ? q : r_o;
    r_o = (k == 2.0f) ? pp : r_o;
    r_o = (k == 3.0f) ? pp : r_o;
    r_o = (k == 4.0f) ? tt : r_o;
    float g_o = maxc;
    g_o = (k == 0.0f) ? tt : g_o;
    g_o = (k == 3.0f) ? q : g_o;
    g_o = (k == 4.0f) ? pp : g_o;
    g_o = (k == 5.0f) ? pp : g_o;
    float b_o = maxc;
    b_o = (k == 0.0f) ? pp : b_o;
    b_o = (k == 1.0f) ? pp : b_o;
    b_o = (k == 2.0f) ? tt : b_o;
    b_o = (k == 5.0f) ? q : b_o;
    R[i] = r_o;
    G[i] = g_o;
    B[i] = b_o;
  }
}

// One frame of the full jitter chain on planar scratch (R/G/B are npix
// floats each). A free function (not the parallel_for lambda body): GCC 12
// does not vectorize loops inside lambdas with captured state ("no
// vectype" — verified with -fopt-info-vec-all), and the planar unit-stride
// form is what makes every op loop vectorizable at all.
void jitter_frame_planar(const uint8_t* __restrict in, uint8_t* __restrict out,
                         float* __restrict R, float* __restrict G,
                         float* __restrict B, size_t npix, const int* order,
                         int n_ops, float fb, float fc, float fs, float fh) {
  for (size_t i = 0; i < npix; ++i) {
    R[i] = in[i * 3] * (1.0f / 255.0f);
    G[i] = in[i * 3 + 1] * (1.0f / 255.0f);
    B[i] = in[i * 3 + 2] * (1.0f / 255.0f);
  }
  for (int oi = 0; oi < n_ops; ++oi) {
    const int op = order[oi];
    if (op == 0) {  // brightness: clip(v*fb)
#pragma omp simd
      for (size_t i = 0; i < npix; ++i) {
        R[i] = std::min(std::max(R[i] * fb, 0.0f), 1.0f);
        G[i] = std::min(std::max(G[i] * fb, 0.0f), 1.0f);
        B[i] = std::min(std::max(B[i] * fb, 0.0f), 1.0f);
      }
    } else if (op == 1) {  // contrast: blend with the frame's mean gray
      double acc = 0.0;
      for (size_t i = 0; i < npix; ++i) {
        acc += 0.2989f * R[i] + 0.587f * G[i] + 0.114f * B[i];
      }
      const float mean = static_cast<float>(acc / static_cast<double>(npix));
      const float w0 = 1.0f - fc;
#pragma omp simd
      for (size_t i = 0; i < npix; ++i) {
        R[i] = std::min(std::max(fc * R[i] + w0 * mean, 0.0f), 1.0f);
        G[i] = std::min(std::max(fc * G[i] + w0 * mean, 0.0f), 1.0f);
        B[i] = std::min(std::max(fc * B[i] + w0 * mean, 0.0f), 1.0f);
      }
    } else if (op == 2) {  // saturation: blend with per-pixel gray
      const float w0 = 1.0f - fs;
#pragma omp simd
      for (size_t i = 0; i < npix; ++i) {
        const float gray = 0.2989f * R[i] + 0.587f * G[i] + 0.114f * B[i];
        R[i] = std::min(std::max(fs * R[i] + w0 * gray, 0.0f), 1.0f);
        G[i] = std::min(std::max(fs * G[i] + w0 * gray, 0.0f), 1.0f);
        B[i] = std::min(std::max(fs * B[i] + w0 * gray, 0.0f), 1.0f);
      }
    } else {  // hue: HSV shift, mirroring augment._np_hue exactly
      hue_shift_planar(R, G, B, npix, fh);
    }
  }
  for (size_t i = 0; i < npix; ++i) {
    // round-half-even == np.rint; quantize once, like the numpy chain
    out[i * 3] = static_cast<uint8_t>(
        std::min(std::max(std::nearbyintf(R[i] * 255.0f), 0.0f), 255.0f));
    out[i * 3 + 1] = static_cast<uint8_t>(
        std::min(std::max(std::nearbyintf(G[i] * 255.0f), 0.0f), 255.0f));
    out[i * 3 + 2] = static_cast<uint8_t>(
        std::min(std::max(std::nearbyintf(B[i] * 255.0f), 0.0f), 255.0f));
  }
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&] {
    int i;
    while ((i = next.fetch_add(1)) < n) fn(i);
  };
  std::vector<std::thread> threads;
  const int k = std::min(n_threads, n);
  threads.reserve(k);
  for (int t = 0; t < k; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Crop [top,left,side,side] out of every (H,W,3) frame and bilinear-resize
// to (out,out,3). src: (T,H,W,3) u8 contiguous; dst: (T,out,out,3) u8.
// Returns 0 on success.
int h36x_crop_resize_clip_u8(const uint8_t* src, int T, int H, int W, int top,
                             int left, int side, uint8_t* dst, int out,
                             int n_threads) {
  if (side <= 0 || out <= 0 || top < 0 || left < 0 || top + side > H ||
      left + side > W) {
    return 1;
  }
  const Grid gy = make_grid(top, side, H, out);
  const Grid gx = make_grid(left, side, W, out);
  const size_t frame_in = static_cast<size_t>(H) * W * 3;
  const size_t frame_out = static_cast<size_t>(out) * out * 3;
  parallel_for(T, n_threads, [&](int t) {
    resize_frame(src + t * frame_in, H, W, gy, gx, out, dst + t * frame_out);
  });
  return 0;
}

// In-place horizontal flip of (T,H,W,3) u8 frames.
int h36x_hflip_clip_u8(uint8_t* data, int T, int H, int W, int n_threads) {
  const size_t frame = static_cast<size_t>(H) * W * 3;
  parallel_for(T, n_threads, [&](int t) {
    uint8_t* f = data + t * frame;
    for (int y = 0; y < H; ++y) {
      uint8_t* row = f + static_cast<size_t>(y) * W * 3;
      for (int x = 0; x < W / 2; ++x) {
        for (int c = 0; c < 3; ++c) {
          std::swap(row[x * 3 + c], row[(W - 1 - x) * 3 + c]);
        }
      }
    }
  });
  return 0;
}

// Brightness/contrast/saturation on u8 frames (hue stays in numpy — it is
// rare in the op ordering to dominate). factors: b, c, s applied in the
// order given by order[0..2] (0=brightness, 1=contrast, 2=saturation).
int h36x_bcs_jitter_u8(uint8_t* data, int T, int H, int W, float fb, float fc,
                       float fs, const int* order, int n_ops, int n_threads) {
  // reject unknown ops up front: sample_jitter_params orderings include
  // hue (op 3), which this b/c/s-only kernel must not silently run as a
  // second saturation pass
  for (int oi = 0; oi < n_ops; ++oi) {
    if (order[oi] < 0 || order[oi] > 2) return 1;
  }
  const size_t npix = static_cast<size_t>(H) * W;
  const size_t frame = npix * 3;
  parallel_for(T, n_threads, [&](int t) {
    uint8_t* f = data + t * frame;
    for (int oi = 0; oi < n_ops; ++oi) {
      const int op = order[oi];
      if (op == 0) {  // brightness: v*fb
        for (size_t i = 0; i < frame; ++i) {
          float v = f[i] * fb;
          f[i] = static_cast<uint8_t>(std::min(std::max(v, 0.0f), 255.0f) + 0.5f);
        }
      } else if (op == 1) {  // contrast: blend with mean gray
        double acc = 0.0;
        for (size_t i = 0; i < npix; ++i) {
          const uint8_t* p = f + i * 3;
          acc += 0.2989 * p[0] + 0.587 * p[1] + 0.114 * p[2];
        }
        const float mean = static_cast<float>(acc / npix);
        for (size_t i = 0; i < frame; ++i) {
          float v = fc * f[i] + (1.0f - fc) * mean;
          f[i] = static_cast<uint8_t>(std::min(std::max(v, 0.0f), 255.0f) + 0.5f);
        }
      } else {  // op == 2 (validated above) — saturation: per-pixel gray blend
        for (size_t i = 0; i < npix; ++i) {
          uint8_t* p = f + i * 3;
          const float gray = 0.2989f * p[0] + 0.587f * p[1] + 0.114f * p[2];
          for (int c = 0; c < 3; ++c) {
            float v = fs * p[c] + (1.0f - fs) * gray;
            p[c] = static_cast<uint8_t>(std::min(std::max(v, 0.0f), 255.0f) + 0.5f);
          }
        }
      }
    }
  });
  return 0;
}

// Full photometric jitter: brightness/contrast/saturation/hue applied in
// the order given by order[0..n_ops-1] (0=b, 1=c, 2=s, 3=hue), chained in
// f32 like the numpy reference path (augment.apply_jitter_params) and
// quantized ONCE at the end with round-half-even (numpy rint semantics).
// This is the hot host op of the default (--jitter-key clip) extraction
// schedule: the clip-keyed factor set means every clip jitters all seq_len
// frames, and the numpy chain pays ~6 full-clip f32 temporaries per op.
// src/dst: (T,H,W,3) u8 contiguous, must NOT alias (the per-frame body
// declares both __restrict; callers allocate a fresh dst). Returns 0 on
// success.
int h36x_jitter_clip_u8(const uint8_t* src, uint8_t* dst, int T, int H, int W,
                        float fb, float fc, float fs, float fh,
                        const int* order, int n_ops, int n_threads) {
  for (int oi = 0; oi < n_ops; ++oi) {
    if (order[oi] < 0 || order[oi] > 3) return 1;
  }
  const size_t npix = static_cast<size_t>(H) * W;
  const size_t frame = npix * 3;
  // Whole-kernel planar form: deinterleave once per frame, run every op on
  // unit-stride channel planes (the stride-3 interleaved loops defeat the
  // vectorizer), reinterleave in the final quantize. Per-pixel f32 math is
  // identical to the interleaved form (-ffp-contract=off, same op order),
  // so the layout change is byte-invisible — verified 20/20 param draws.
  parallel_for(T, n_threads, [&](int t) {
    // one scratch per worker thread, reused across its frames: a per-frame
    // vector would malloc + zero ~600 KB (224px) for every frame of the hot
    // path. parallel_for joins its threads per call, so nothing outlives
    // the kernel (the serial path's buffer lives on the caller's thread).
    static thread_local std::vector<float> plan;
    if (plan.size() < npix * 3) plan.resize(npix * 3);
    jitter_frame_planar(src + t * frame, dst + t * frame, plan.data(),
                        plan.data() + npix, plan.data() + 2 * npix, npix,
                        order, n_ops, fb, fc, fs, fh);
  });
  return 0;
}

int h36x_native_abi_version() { return 2; }

}  // extern "C"
