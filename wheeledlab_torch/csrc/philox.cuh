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

#include "substep.cuh"

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

// The draws of one env, worked by its group of kLanesPerEnv lanes
// (`substep.cuh`), in three rounds of one Philox call a lane: the uniform
// rows, the `u1` draws and the `u2` draws. In the round whose first draw is
// F, lane L computes call (F >> 2) + L, so the 4 lanes cover draws
// 4 (F >> 2) .. 4 (F >> 2) + 15: the rows of the block and the next block's
// first words. Calls 3 (in the uniform round; the u1 round's first) and 6 (in
// the u1 and the u2 round, whose words each takes half of) are computed
// twice; a lane idle in a round would save nothing, since its warp issues
// the round for the other lanes.
constexpr int kUniformDraw = 0;
constexpr int kU1Draw = kUniformDraw + kRngUniformRows;
constexpr int kU2Draw = kU1Draw + kRngNormalRows;
// draw-block slots a lane holds: the rows 4 k + w, k < kGroupSlots
constexpr int kGroupSlots = 4;

// p ? a : b as one `selp`. Written as a C++ select, the word a lane sends
// was made a branch around each shuffle, which split the warp by lane.
__device__ __forceinline__ uint32_t select_u32(bool p, uint32_t a,
                                               uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t"
      "selp.b32 %0, %1, %2, q;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(static_cast<uint32_t>(p)));
  return r;
}

// Transpose a group's 4 x 4 words in registers: lane w's v[x] becomes lane
// x's v[w]. Two butterfly stages (lanes w ^ 2, then w ^ 1), each sending two
// words a lane: 4 shuffles, the words picked and placed by selects on w.
__device__ __forceinline__ void group_transpose(uint32_t v[4], int w) {
#pragma unroll
  for (int m = 2; m >= 1; m >>= 1) {
    const bool hi = (w & m) != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j & m) continue;
      const uint32_t send = select_u32(hi, v[j], v[j | m]);
      const uint32_t got =
          __shfl_xor_sync(kFullMask, send, m, kLanesPerEnv);
      v[j] = select_u32(hi, got, v[j]);
      v[j | m] = select_u32(hi, v[j | m], got);
    }
  }
}

// One round: lane w computes call (kFirst >> 2) + w, and the group hands
// lane w the words of its own draws: col[k] = draw kFirst + 4 k + w. Lane w
// reads word (w + kFirst) & 3 of every lane's call, so each lane renames its
// words by kFirst & 3 before the transpose (no instruction); where w +
// (kFirst & 3) passes 3, lane w's draw of slot k is in call k + 1, one
// position on (the u2 round: lanes 2 and 3). A slot past the round's calls
// is 0.
template <int kFirst>
__device__ __forceinline__ void philox_round(uint32_t seed, uint32_t env,
                                             int w, uint32_t col[4]) {
  constexpr int kShift = kFirst & 3;
  uint32_t v[4], m[4];
  philox4x32_10(env, static_cast<uint32_t>((kFirst >> 2) + w), 0u, 0u, seed,
                kPhiloxKey1, v);
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = v[(j + kShift) & 3];
  group_transpose(m, w);
  const bool carry = w + kShift > 3;
#pragma unroll
  for (int k = 0; k < kGroupSlots; ++k)
    col[k] = select_u32(carry, k + 1 < 4 ? m[(k + 1) & 3] : 0u, m[k]);
}

// One env's random rows, drawn by the env's 4 lanes together, each draw in
// one lane (`philox_round`). The caller draws a block before it reads it,
// once: the rows of a block that nobody reads are then never computed, and
// a row read from a block not drawn is 0. Row indices must be compile-time
// constants after unrolling, so that the words stay in registers.
//  - `draw_uniform()`, then `uniform(row)`: the same bits in every lane of
//    the group (the step's pushes, timers and spawn are computed by all 4
//    lanes alike): the lane whose call holds the draw sends it, one shuffle
//    a row.
//  - `draw_own_uniform()`, then `own_uniform(k)`: uniform row 4 k + w of
//    lane w (K5b's stores).
//  - `draw_normals<kSlots>()`, then `own_normal(k)`, k < kSlots: the normal
//    of row 4 k + w; and `normal(row)`, exact on lane row & 3, which alone
//    stores observation row `row` (`drift_step.cuh`; another lane gets its
//    own row of the same slot). A lane computes the Box-Muller normals of
//    its own rows only.
struct PhiloxGroupRows {
  uint32_t seed, env;
  int w;
  uint32_t u[4];    // this lane's call of the uniform round, as computed
  uint32_t uc[4];   // the uniform round transposed: rows 4 k + w
  float nrm[kGroupSlots];

  __device__ __forceinline__ PhiloxGroupRows(uint32_t seed_, uint32_t env_,
                                             int w_)
      : seed(seed_), env(env_), w(w_), u{}, uc{}, nrm{} {}

  __device__ __forceinline__ void draw_uniform() {
    philox4x32_10(env, static_cast<uint32_t>((kUniformDraw >> 2) + w), 0u, 0u,
                  seed, kPhiloxKey1, u);
  }
  __device__ __forceinline__ void draw_own_uniform() {
    philox_round<kUniformDraw>(seed, env, w, uc);
  }
  template <int kSlots>
  __device__ __forceinline__ void draw_normals() {
    static_assert(kSlots <= kGroupSlots, "a lane has kGroupSlots rows");
    uint32_t c1[4], c2[4];  // u1 and u2 draws of rows 4 k + w
    philox_round<kU1Draw>(seed, env, w, c1);
    philox_round<kU2Draw>(seed, env, w, c2);
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      nrm[k] = box_muller(bits_to_uniform(c1[k]), bits_to_uniform(c2[k]));
  }

  __device__ __forceinline__ float uniform(int row) const {
    const int j = kUniformDraw + row;
    return bits_to_uniform(__shfl_sync(kFullMask, u[j & 3],
                                       (j >> 2) - (kUniformDraw >> 2),
                                       kLanesPerEnv));
  }
  __device__ __forceinline__ float own_uniform(int k) const {
    return bits_to_uniform(uc[k]);
  }
  __device__ __forceinline__ float own_normal(int k) const { return nrm[k]; }
  __device__ __forceinline__ float normal(int row) const {
    return nrm[row >> 2];
  }
};

}  // namespace wl
