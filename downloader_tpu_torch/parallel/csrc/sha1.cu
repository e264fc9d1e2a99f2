// Batched SHA-1 compression for Hopper (sm_90a), one thread per piece.
//
// Replaces the JAX package's Pallas kernel
// downloader_tpu/parallel/sha1_pallas.py:_sha1_kernel (launched by
// sha1_tiled). It computes the same function: the final SHA-1 chaining
// state of every piece in a ragged batch of padded messages.
//
// Layout (built by parallel/pack.py):
//   blocks  (B, 16, P) 32-bit big-endian message words, word-major with
//           the pieces contiguous: word t of block b of piece p sits at
//           (b * 16 + t) * P + p, so the 32 threads of a warp load 32
//           neighbouring words (one 128-byte transaction per word).
//   nblocks (P,) valid block count of each piece.
//   out     (5, P) final state words; H0 for a piece with nblocks == 0,
//           as sha1_tiled gives for its padding lanes.
// Each thread runs its own piece's min(nblocks[p], B) blocks, which gives
// the same result as the Pallas kernel's per-lane freeze mask. The state
// a..e and a 16-word rolling message schedule stay in registers.
//
// What bounds it on an H100 SXM:
//   - operations: as written below, one 64-byte block is 961 two-input
//     32-bit operations (80 rounds x (rotl5 + 4 adds + rotl30) = 480,
//     the round functions 20 x 3 + 20 x 2 + 20 x 4 + 20 x 2 = 220, the
//     schedule 64 x (3 xor + rotl1) = 256, 5 chaining adds). ptxas fuses
//     them into three-input LOP3 and IADD3 and into LEA.HI (a shift with
//     an add): built by nvcc 12.9 for sm_90a, a block issues 647
//     instructions, 527 of them on the integer ALU pipe (LOP3 208, SHF
//     140, IADD3 94, LEA 84, ISETP 1), 103 that may go to the FMA pipe
//     (VIADD 80, IMAD 23) and 16 loads. The ALU pipe takes 64 lanes per
//     SM and clock, so a block costs an SM 527 / 64 = 8.2 clocks, and a
//     1 GiB payload (16.8 M blocks) over 132 SMs at 1.98 GHz needs at
//     least 0.53 ms. chip_smoke.py counts these in the built kernel's
//     SASS on every run;
//   - memory: every block is read once, 1 GiB / 3.35 TB/s = 0.32 ms.
// The operation bound is the larger.
//
// Where trouble is expected: the only parallelism is across pieces, and
// each piece is a chain of dependent compressions. make_torrent of a
// 1 GiB file at 1 MiB pieces gives P = 1024 threads (8 blocks of 128 on
// 8 of 132 SMs), each running 16,385 compressions back to back; a resume
// flush at the default 64 MiB batch gives 64 threads, one SM. The
// rounds are a serial dependency chain, so a warp waits on instruction
// latency with few other warps to hide it: this simple design is
// latency-bound, far from either bound. Filling the card needs more
// lanes per launch (larger or merged batches), not a faster round.
//
// The C entry launches on the caller's stream, does not synchronise and
// returns cudaGetLastError(); the Python wrapper (parallel/sha1_cuda.py)
// checks the arguments and raises on a non-zero return.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__global__ void __launch_bounds__(kThreads)
    sha1_kernel(const uint32_t* __restrict__ blocks,
                const int32_t* __restrict__ nblocks,
                uint32_t* __restrict__ out, int P, int B) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t pitch = static_cast<size_t>(P);
  uint32_t h0 = 0x67452301u;
  uint32_t h1 = 0xEFCDAB89u;
  uint32_t h2 = 0x98BADCFEu;
  uint32_t h3 = 0x10325476u;
  uint32_t h4 = 0xC3D2E1F0u;
  const int n = min(nblocks[p], B);
  const uint32_t* word = blocks + p;
  for (int b = 0; b < n; ++b, word += 16 * pitch) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = word[t * pitch];
    uint32_t a = h0, bb = h1, c = h2, d = h3, e = h4;
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        // W[t] = rotl1(W[t-3] ^ W[t-8] ^ W[t-14] ^ W[t-16]) on a ring of 16
        wt = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^
                      w[t & 15],
                  1);
        w[t & 15] = wt;
      }
      uint32_t f, k;
      if (t < 20) {
        f = d ^ (bb & (c ^ d));
        k = 0x5A827999u;
      } else if (t < 40) {
        f = bb ^ c ^ d;
        k = 0x6ED9EBA1u;
      } else if (t < 60) {
        f = (bb & c) | (d & (bb | c));
        k = 0x8F1BBCDCu;
      } else {
        f = bb ^ c ^ d;
        k = 0xCA62C1D6u;
      }
      const uint32_t temp = rotl(a, 5) + f + e + k + wt;
      e = d;
      d = c;
      c = rotl(bb, 30);
      bb = a;
      a = temp;
    }
    h0 += a;
    h1 += bb;
    h2 += c;
    h3 += d;
    h4 += e;
  }
  out[p] = h0;
  out[pitch + p] = h1;
  out[2 * pitch + p] = h2;
  out[3 * pitch + p] = h3;
  out[4 * pitch + p] = h4;
}

}  // namespace

extern "C" int sha1_batch(const uint32_t* blocks, const int32_t* nblocks,
                          uint32_t* out, int P, int B, void* stream) {
  if (P <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((P + kThreads - 1) / kThreads);
  sha1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, nblocks, out, P, B);
  return static_cast<int>(cudaGetLastError());
}
