// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) and the per-env random rows the drift kernels draw from it.
//
// The Pallas TPU kernel `wheeledlab_tpu/tasks/drift/fused.py::_kernel_krng`
// seeds the TPU's hardware generator per (seed, grid block), which ties its
// numbers to the tiling. Here the generator is counter-based: a draw depends
// only on (seed, env index, draw index), never on the block size or on B.
//
//   key     = (seed, kPhiloxKey1)
//   counter = (env index b, call index q, 0, 0)
//   draw j  = word j % 4 of call q = j / 4
//
// Draw order, as the reference slices its bits (`fused.py:428-432`): j 0-11
// the 12 uniform rows; 12-25 `u1` of the 14 normal rows; 26-39 `u2` of the 14
// normal rows. The plain PyTorch version, word for word, is
// `wheeledlab_torch/ops/kernel_rng.py::philox_blocks`.
#pragma once

#include <math.h>
#include <stdint.h>

namespace wl {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
// second key word of every stream of the port ("WLRG")
constexpr uint32_t kPhiloxKey1 = 0x574C5247u;
constexpr int kRngUniformRows = 12;
constexpr int kRngNormalRows = 14;

// out = Philox4x32-10(counter (c0, c1, c2, c3), key (k0, k1))
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The reference's extraction: 24 bits of the word -> [0, 1), exact in float32.
__device__ __forceinline__ float bits_to_uniform(uint32_t word) {
  return static_cast<float>((word >> 7) & 0x00FFFFFFu) *
         (1.0f / static_cast<float>(1 << 24));
}

// Box-Muller with the reference's clamp, in precise float32 functions.
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.f * logf(fmaxf(u1, 1e-7f))) * cosf(6.2831855f * u2);
}

// One env's random rows, drawn when asked for: a row that the step never
// reads costs nothing. Two 4-word blocks are cached, one for the uniform rows
// and the `u1` draws, one for the `u2` draws, so that walking the rows in
// order calls Philox 10 times per env (3 + 3 + 4) and not twice per normal.
// Row indices must be compile-time constants after unrolling, so that the
// cached words stay in registers.
struct PhiloxRows {
  uint32_t seed, env;
  int qa, qb;
  uint32_t wa[4], wb[4];

  __device__ __forceinline__ PhiloxRows(uint32_t seed_, uint32_t env_)
      : seed(seed_), env(env_), qa(-1), qb(-1) {}

  __device__ __forceinline__ uint32_t word_a(int j) {
    const int q = j >> 2;
    if (q != qa) {
      philox4x32_10(env, static_cast<uint32_t>(q), 0u, 0u, seed, kPhiloxKey1,
                    wa);
      qa = q;
    }
    return wa[j & 3];
  }
  __device__ __forceinline__ uint32_t word_b(int j) {
    const int q = j >> 2;
    if (q != qb) {
      philox4x32_10(env, static_cast<uint32_t>(q), 0u, 0u, seed, kPhiloxKey1,
                    wb);
      qb = q;
    }
    return wb[j & 3];
  }
  __device__ __forceinline__ float uniform(int row) {
    return bits_to_uniform(word_a(row));
  }
  __device__ __forceinline__ float normal(int row) {
    const float u1 = bits_to_uniform(word_a(kRngUniformRows + row));
    const float u2 =
        bits_to_uniform(word_b(kRngUniformRows + kRngNormalRows + row));
    return box_muller(u1, u2);
  }
};

}  // namespace wl
