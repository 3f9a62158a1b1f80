// Batch gradient-noise evaluation — native twin of
// raytracingtest_tpu/utils/noise.py (bit-identical hash and gradients).
//
// Role parity: the reference ships a native SIMD noise library
// (Assets/Scripts/Utility/FastNoise Unity/Plugins, FastNoiseSIMD) for
// host-side terrain sampling; this is its equivalent for the streaming
// builder's hot path: millions of density samples per chunk build, on the
// host. Plain loops written for compiler auto-vectorization (-O3) +
// std::thread sharding over the batch.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

const float GRAD[12][3] = {
    {1, 1, 0}, {-1, 1, 0}, {1, -1, 0}, {-1, -1, 0},
    {1, 0, 1}, {-1, 0, 1}, {1, 0, -1}, {-1, 0, -1},
    {0, 1, 1}, {0, -1, 1}, {0, 1, -1}, {0, -1, -1},
};

inline uint32_t hash3(int32_t ix, int32_t iy, int32_t iz, uint32_t seed) {
  uint32_t h = (uint32_t)ix * 0x8DA6B343u ^ (uint32_t)iy * 0xD8163841u ^
               (uint32_t)iz * 0xCB1AB31Fu ^ seed * 0x9E3779B9u;
  h ^= h >> 13;
  h *= 0x5BD1E995u;
  h ^= h >> 15;
  return h;
}

inline float fade(float t) { return t * t * t * (t * (t * 6.f - 15.f) + 10.f); }

inline float corner(int32_t ix, int32_t iy, int32_t iz, int cx, int cy,
                    int cz, float fx, float fy, float fz, uint32_t seed) {
  uint32_t h = hash3(ix + cx, iy + cy, iz + cz, seed) % 12u;
  const float* g = GRAD[h];
  return g[0] * (fx - cx) + g[1] * (fy - cy) + g[2] * (fz - cz);
}

void noise3_range(const float* x, const float* y, const float* z, float* out,
                  int64_t lo, int64_t hi, uint32_t seed) {
  for (int64_t i = lo; i < hi; ++i) {
    float xf = std::floor(x[i]), yf = std::floor(y[i]), zf = std::floor(z[i]);
    float fx = x[i] - xf, fy = y[i] - yf, fz = z[i] - zf;
    int32_t ix = (int32_t)xf, iy = (int32_t)yf, iz = (int32_t)zf;
    float u = fade(fx), v = fade(fy), w = fade(fz);

    float n000 = corner(ix, iy, iz, 0, 0, 0, fx, fy, fz, seed);
    float n100 = corner(ix, iy, iz, 1, 0, 0, fx, fy, fz, seed);
    float n010 = corner(ix, iy, iz, 0, 1, 0, fx, fy, fz, seed);
    float n110 = corner(ix, iy, iz, 1, 1, 0, fx, fy, fz, seed);
    float n001 = corner(ix, iy, iz, 0, 0, 1, fx, fy, fz, seed);
    float n101 = corner(ix, iy, iz, 1, 0, 1, fx, fy, fz, seed);
    float n011 = corner(ix, iy, iz, 0, 1, 1, fx, fy, fz, seed);
    float n111 = corner(ix, iy, iz, 1, 1, 1, fx, fy, fz, seed);

    float nx00 = n000 + u * (n100 - n000);
    float nx10 = n010 + u * (n110 - n010);
    float nx01 = n001 + u * (n101 - n001);
    float nx11 = n011 + u * (n111 - n011);
    float nxy0 = nx00 + v * (nx10 - nx00);
    float nxy1 = nx01 + v * (nx11 - nx01);
    out[i] = nxy0 + w * (nxy1 - nxy0);
  }
}

void run_threaded(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned nt = std::max(1u, std::thread::hardware_concurrency());
  if (n < 65536 || nt == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void rtt_noise3(const float* x, const float* y, const float* z, float* out,
                int64_t n, uint32_t seed) {
  run_threaded(n, [&](int64_t lo, int64_t hi) {
    noise3_range(x, y, z, out, lo, hi, seed);
  });
}

// fbm: fractal sum of octaves (utils/noise.py fbm3)
void rtt_fbm3(const float* x, const float* y, const float* z, float* out,
              int64_t n, uint32_t seed, int octaves, float lacunarity,
              float gain) {
  run_threaded(n, [&](int64_t lo, int64_t hi) {
    std::vector<float> xs(hi - lo), ys(hi - lo), zs(hi - lo), tmp(hi - lo);
    for (int64_t i = lo; i < hi; ++i) out[i] = 0.f;
    float amp = 1.f, freq = 1.f;
    for (int o = 0; o < octaves; ++o) {
      for (int64_t i = lo; i < hi; ++i) {
        xs[i - lo] = x[i] * freq;
        ys[i - lo] = y[i] * freq;
        zs[i - lo] = z[i] * freq;
      }
      noise3_range(xs.data(), ys.data(), zs.data(), tmp.data(), 0, hi - lo,
                   seed + (uint32_t)o);
      for (int64_t i = lo; i < hi; ++i) out[i] += amp * tmp[i - lo];
      amp *= gain;
      freq *= lacunarity;
    }
  });
}

}  // extern "C"
