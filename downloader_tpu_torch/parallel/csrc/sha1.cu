// Batched SHA-1 compression for Hopper (sm_90a): one piece a lane; each
// group of 32 pieces is a pair of warps, one computing the message
// schedule from blocks staged by asynchronous copies, one running the
// rounds.
//
// Replaces the JAX package's Pallas kernel
// downloader_tpu/parallel/sha1_pallas.py:_sha1_kernel (launched by
// sha1_tiled). It computes the same function: the final SHA-1 chaining
// state of every piece in a ragged batch of padded messages.
//
// Layout (built by parallel/pack.py):
//   blocks  (B, 16, P) 32-bit big-endian message words, word-major with
//           the pieces contiguous: word t of block b of piece p sits at
//           (b * 16 + t) * P + p. Row 16 * b + t of a group's 32 pieces
//           is 128 contiguous bytes.
//   nblocks (P,) valid block count of each piece.
//   out     (5, P) final state words; H0 for a piece with nblocks == 0,
//           as sha1_tiled gives for its padding lanes.
// Each piece's state takes its own min(nblocks[p], B) blocks, which gives
// the same result as the Pallas kernel's per-lane freeze mask.
//
// Three bounds on an H100 SXM (chip_smoke.py computes and prints each):
//   - bytes: every valid block read once, 1 GiB / 3.35 TB/s = 0.32 ms;
//   - operations: a block is some 790 instructions over both warps, about
//     450 of them on the integer ALU pipe, which takes 64 lanes an SM and
//     clock (chip_smoke.py counts them in this kernel's SASS): 0.46 ms
//     for 1 GiB over 132 SMs;
//   - the chain: SHA-1 is 80 dependent rounds a block, and the blocks of
//     a piece run in turn. The only parallelism is across pieces: 1024
//     pieces (make_torrent of 1 GiB at 1 MiB pieces) are 32 warp pairs
//     on 32 of 132 SMs, a 64-piece resume flush two pairs. So a launch
//     takes B times one round warp's time a block, whatever P is, and the
//     two bounds above are out of reach at these shapes. Two dependent
//     instructions a round (see sha1_round) at about 5 clocks each is
//     some 0.42 us a block: chain_floor_kernel below runs that path alone.
// What the kernel does about the chain:
//
//   1. No load on it. The schedule warp keeps a ring of kStages stages of
//      kStageBlocks blocks in shared memory ([16 words][32 lanes], 2 KiB a
//      block), filled kStages - 1 stages ahead with cp.async copies
//      (LDGSTS) under commit_group / wait_group. A lane reads column
//      `lane` of each row: no bank conflict. Rows are copied 16 bytes a
//      lane when every row starts on 16 bytes (P % 4 == 0, the main
//      path's shapes), else 4 bytes a lane, some 2 % slower at the main
//      path's shapes (PERF.md); lanes past P take the zero-fill form
//      (src-size 0) and read nothing.
//   2. Nothing but rounds beside it. With the schedule in the same
//      thread, one warp issued about 520 ALU-pipe instructions a block;
//      a sub-partition's ALU pipe is 16 lanes wide, so that is 1040
//      clocks, above the chain. The schedule warp, on another
//      sub-partition, computes W[t] + K_t and stores it, 16 bytes a lane
//      for four rounds, in a ring of kScheduleSlots slots; named barriers
//      (full and empty, one pair a slot) hand the slots over. The round
//      warp loads two quads ahead, across block boundaries, and issues
//      about 240 ALU-pipe instructions a block.
//   3. Two instructions a round on it. e is the previous round's d, so
//      e + W[t] + K_t is summed before the round starts; what is left is
//      rotl5(a) + that (one LEA.HI) and + f(b, c, d) (one IMAD.IADD, with
//      f's LOP3 beside the LEA.HI).
//   4. Uniform warps. Both warps run to the group's largest block count;
//      a lane keeps a block's sum only if the block is its own, so copy
//      groups, __syncwarp and the barriers stay uniform and no lane leaves
//      while another waits. A lane with nblocks == 0 writes H0.
//
// The C entry launches on the caller's stream, does not synchronise and
// returns the first CUDA error (of the shared-memory attribute or the
// launch); the Python wrapper (parallel/sha1_cuda.py) checks the arguments
// and raises on a non-zero return. sha1_chain_floor is a second entry, not
// on the main path: it runs only the rounds for B blocks on one lane, so
// that chip_smoke.py can time the chain alone.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// kStages and kStageBlocks are also RING in parallel/sha1_cuda.py, for
// the tests and chip_smoke.py.
constexpr int kThreads = 64;  // warp 0 schedules, warp 1 runs the rounds
constexpr int kStages = 4;  // depth of the message ring
constexpr int kStageBlocks = 4;
constexpr int kScheduleSlots = 4;  // blocks of W + K
constexpr int kBlockWords = 16 * 32;  // one block of a group's 32 pieces
constexpr int kStageWords = kStageBlocks * kBlockWords;
constexpr int kRingWords = kStages * kStageWords;
constexpr int kSlotWords = 80 * 32;  // W[t] + K_t of one block
constexpr int kSharedBytes = (kRingWords + kScheduleSlots * kSlotWords) * 4;
static_assert(kStages >= 2 && kStageBlocks >= 1, "a ring needs two stages");
// the round warp waits for block b + 1's slot while it still holds
// block b's, so the two must differ
static_assert(kScheduleSlots >= 2 && 2 * kScheduleSlots < 16,
              "two slots or more; two named barriers a slot, barrier 0 left alone");
static_assert(kSharedBytes <= 232448, "the rings exceed a CTA's shared memory");

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ uint32_t round_f(int t, uint32_t b, uint32_t c,
                                            uint32_t d) {
  if (t < 20) return d ^ (b & (c ^ d));
  if (t < 40 || t >= 60) return b ^ c ^ d;
  return (b & c) | (d & (b | c));
}

__device__ __forceinline__ uint32_t round_k(int t) {
  return t < 20 ? 0x5A827999u
         : t < 40 ? 0x6ED9EBA1u
         : t < 60 ? 0x8F1BBCDCu
                  : 0xCA62C1D6u;
}

// One round; wk = W[t] + K_t. e + wk depends on nothing this round makes,
// so only rotl5(a) and f(b, c, d), side by side, and the add after them
// lie on the chain from one round's a to the next.
__device__ __forceinline__ void sha1_round(int t, uint32_t wk, uint32_t& a,
                                           uint32_t& b, uint32_t& c,
                                           uint32_t& d, uint32_t& e) {
  const uint32_t ewk = e + wk;
  const uint32_t next = rotl(a, 5) + round_f(t, b, c, d) + ewk;
  e = d;
  d = c;
  c = rotl(b, 30);
  b = a;
  a = next;
}

// The schedule of one block: W[t] + K_t for t < 80 from the block's words
// (`words`: this lane's column, word t at words[32 * t]) into a slot,
// four rounds to a lane's 16 bytes (`quads`: this lane's, quad i at
// quads[32 * i]).
__device__ __forceinline__ void schedule(const uint32_t* words, uint4* quads) {
  uint32_t w[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) w[t] = words[32 * t];
  uint32_t wk[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    if (t >= 16) {
      // W[t] = rotl1(W[t-3] ^ W[t-8] ^ W[t-14] ^ W[t-16]) on a ring of 16
      w[t & 15] = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^
                           w[t & 15],
                       1);
    }
    wk[t & 3] = w[t & 15] + round_k(t);
    if ((t & 3) == 3) quads[32 * (t / 4)] = make_uint4(wk[0], wk[1], wk[2], wk[3]);
  }
}

template <int kBytes>
__device__ __forceinline__ void copy_async(uint32_t dst, const uint32_t* src,
                                           uint32_t src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    static_assert(kBytes == 4, "cp.async copies 4 or 16 bytes here");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Named barriers between the CTA's two warps: one arrives, the other
// waits; what the first stored to shared memory before it arrived, the
// second sees after its wait. Slot i is full at barrier 1 + i and empty at
// 1 + kScheduleSlots + i.
__device__ __forceinline__ void barrier_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void barrier_wait(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// A lane's part of the copies of a group's rows into the message ring: kVec
// words from every (32 / kVec)-th row, from `src` on, `step` words apart
// (row r of the group starts at blocks + p0 + r * P).
template <int kVec>
struct Copier {
  static constexpr int kLanesPerRow = 32 / kVec;
  static constexpr int kRowsPerCopy = 32 / kLanesPerRow;  // rows a warp copy
  const uint32_t* src;  // this lane's words of the next block
  size_t step;          // words between rows kRowsPerCopy apart
  uint32_t dst;         // this lane's shared address in slot 0
  uint32_t bytes;       // kVec * 4, or 0 (zero-fill) for a lane past P
  int group_blocks;     // rows of later blocks are read by no lane

  // Issue the copies of stage s, whose first block is s * kStageBlocks.
  __device__ __forceinline__ void fill(int s) {
    const uint32_t slot = dst + 4u * (s % kStages) * kStageWords;
    const int first = s * kStageBlocks;
#pragma unroll
    for (int j = 0; j < kStageBlocks; ++j) {
      if (first + j < group_blocks) {
#pragma unroll
        for (int q = 0; q < 16 / kRowsPerCopy; ++q) {
          copy_async<kVec * 4>(
              slot + 4u * (j * kBlockWords + q * kRowsPerCopy * 32), src,
              bytes);
          src += step;
        }
      }
    }
  }
};

// The round warp: the 80 rounds of each block from its W + K in the
// schedule slots, two quads (eight rounds) loaded ahead.
__device__ __forceinline__ void run_rounds(const uint4* quads, int lane, int n,
                                          int group_blocks, uint32_t h[5]) {
  // quad i of the block in slot s, this lane's
  auto quad = [&](int s, int i) {
    return quads[s * (kSlotWords / 4) + 32 * i + lane];
  };
  uint4 q0 = {}, q1 = {};
  if (group_blocks > 0) {
    barrier_wait(1);
    q0 = quad(0, 0);
    q1 = quad(0, 1);
  }
#pragma unroll 1
  for (int b = 0; b < group_blocks; ++b) {
    const int slot = b % kScheduleSlots;
    const int next = (b + 1) % kScheduleSlots;
    uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4];
#pragma unroll
    for (int i = 0; i < 20; ++i) {
      const uint4 q = q0;
      q0 = q1;
      if (i < 18) {
        q1 = quad(slot, i + 2);
      } else {  // the next block's first quads; after the last block, unused
        if (i == 18 && b + 1 < group_blocks) barrier_wait(1 + next);
        q1 = quad(next, i - 18);
      }
      sha1_round(4 * i, q.x, a, bb, c, d, e);
      sha1_round(4 * i + 1, q.y, a, bb, c, d, e);
      sha1_round(4 * i + 2, q.z, a, bb, c, d, e);
      sha1_round(4 * i + 3, q.w, a, bb, c, d, e);
    }
    // the slot is read: free it if the schedule warp fills it again
    if (b + kScheduleSlots < group_blocks)
      barrier_arrive(1 + kScheduleSlots + slot);
    if (b < n) {  // a lane keeps only its own blocks
      h[0] += a;
      h[1] += bb;
      h[2] += c;
      h[3] += d;
      h[4] += e;
    }
  }
}

// The schedule warp: the message ring, and W + K of each block into the
// schedule slots.
template <int kVec>
__device__ __forceinline__ void run_schedule(uint32_t* smem, int lane,
                                             int live, int group_blocks,
                                             const uint32_t* blocks, int p0,
                                             int P) {
  const size_t pitch = static_cast<size_t>(P);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint4* quads = reinterpret_cast<uint4*>(smem + kRingWords) + lane;
  // a lane copies kVec words at column `col` of rows `row`, `row` + rows
  // a copy, ...; a lane past P points at `blocks` and reads nothing
  Copier<kVec> copier;
  const int row = lane / Copier<kVec>::kLanesPerRow;
  const int col = lane % Copier<kVec>::kLanesPerRow * kVec;
  copier.bytes = col < live ? 4u * kVec : 0u;
  copier.src = copier.bytes ? blocks + p0 + row * pitch + col : blocks;
  copier.step = copier.bytes ? Copier<kVec>::kRowsPerCopy * pitch : 0;
  copier.dst = ring + 4u * (row * 32 + col);
  copier.group_blocks = group_blocks;
  const int stages = (group_blocks + kStageBlocks - 1) / kStageBlocks;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) copier.fill(s);
    commit_copies();  // one group a stage, empty or not: the count stays
  }
  for (int s = 0; s < stages; ++s) {
    wait_copies<kStages - 2>();  // this lane's copies of stage s are in
    __syncwarp();  // and every lane's; and stage s - 1 is read by all
    if (s + kStages - 1 < stages) copier.fill(s + kStages - 1);
    commit_copies();
    const uint32_t* stage = smem + (s % kStages) * kStageWords + lane;
#pragma unroll 1
    for (int j = 0; j < kStageBlocks; ++j) {
      const int b = s * kStageBlocks + j;
      if (b >= group_blocks) break;
      const int slot = b % kScheduleSlots;
      if (b >= kScheduleSlots) barrier_wait(1 + kScheduleSlots + slot);
      schedule(stage + j * kBlockWords, quads + slot * (kSlotWords / 4));
      barrier_arrive(1 + slot);
    }
  }
}

// kVec: words a lane copies at once, 4 when every row starts on 16 bytes.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    sha1_kernel(const uint32_t* __restrict__ blocks,
                const int32_t* __restrict__ nblocks,
                uint32_t* __restrict__ out, int P, int B) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * 32;
  const int p = p0 + lane;
  const int live = min(32, P - p0);  // pieces of this group
  const int n = lane < live ? max(0, min(nblocks[p], B)) : 0;
  const int group_blocks = __reduce_max_sync(0xFFFFFFFFu, n);
  if (threadIdx.x < 32) {
    run_schedule<kVec>(smem, lane, live, group_blocks, blocks, p0, P);
    return;
  }
  uint32_t h[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u,
                   0xC3D2E1F0u};
  run_rounds(reinterpret_cast<const uint4*>(smem + kRingWords), lane, n,
             group_blocks, h);
  if (lane < live) {
#pragma unroll
    for (int i = 0; i < 5; ++i) out[i * static_cast<size_t>(P) + p] = h[i];
  }
}

// The rounds alone, for B blocks on one lane: the state runs through
// sha1_round with wk fixed in a register, no schedule and no loads; the
// final state is stored so that nothing is left out.
__global__ void chain_floor_kernel(uint32_t* __restrict__ out, int B,
                                   uint32_t wk) {
  uint32_t a = 0x67452301u, b = 0xEFCDAB89u, c = 0x98BADCFEu,
           d = 0x10325476u, e = 0xC3D2E1F0u;
#pragma unroll 1
  for (int i = 0; i < B; ++i) {
#pragma unroll
    for (int t = 0; t < 80; ++t) sha1_round(t, wk, a, b, c, d, e);
  }
  out[0] = a;
  out[1] = b;
  out[2] = c;
  out[3] = d;
  out[4] = e;
}

template <int kVec>
int launch(const uint32_t* blocks, const int32_t* nblocks, uint32_t* out,
           int P, int B, cudaStream_t stream) {
  const cudaError_t status = cudaFuncSetAttribute(
      sha1_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const unsigned grid = static_cast<unsigned>((P + 31) / 32);
  sha1_kernel<kVec><<<grid, kThreads, kSharedBytes, stream>>>(blocks, nblocks,
                                                              out, P, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sha1_batch(const uint32_t* blocks, const int32_t* nblocks,
                          uint32_t* out, int P, int B, void* stream) {
  if (P <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      P % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return aligned ? launch<4>(blocks, nblocks, out, P, B, s)
                 : launch<1>(blocks, nblocks, out, P, B, s);
}

extern "C" int sha1_chain_floor(uint32_t* out, int B, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  chain_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      out, B, 0x5A827999u ^ static_cast<uint32_t>(B));
  return static_cast<int>(cudaGetLastError());
}
