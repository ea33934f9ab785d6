// CMUX front half: rotate -> diff -> gadget-decompose -> byte-split.
//
// Replaces the TPU kernel dct_cryptonets_tpu/fhe/pallas_kernels.py
// rotate_decompose / _rotate_decompose_kernel, in both of its layouts.
//
// Per sample m with amount a = g*N + r in [0, 2N):
//   rot[x]  = acc[(x - r) mod N], negated where (x < r) XOR g   (X^a * acc)
//   diff    = rot - acc                                          (mod 2^64)
//   top     = round-half-up of diff to its top blog*levels bits
//   digits  = `levels` balanced base-2^blog digits, most significant first,
//             each in [-B/2, B/2]; the carry out of the top digit wraps
//   bytes   = each digit as 2 balanced int8 bytes (out0: low, out1: high)
// Plane-major (the fused engine's layout): acc (J, M, N) -> output row
// j*levels + lev of (J*levels, M, N) int8 planes.  Sample-major (the s2d
// engine's layout): acc (M, J, N) -> row j*levels + lev of (M, J*levels, N).
//
// Bound on the card: memory.  Each element reads two int64 words (one of
// them at the rotated index, which stays in L1/L2 because the whole
// N-coefficient row of a sample is read by neighbouring threads) and
// writes 2*levels bytes; there is no arithmetic worth counting.  Design:
// one thread per coefficient, the rotation as index arithmetic (the TPU
// kernel needs log2(N) masked rolls because its vector unit has no
// gather), all integer work in 64-bit registers.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void rotate_decompose_kernel(const long long* __restrict__ acc,
                                        const int* __restrict__ amounts,
                                        signed char* __restrict__ out0,
                                        signed char* __restrict__ out1,
                                        int J, int M, int N, int log2n,
                                        int blog, int levels,
                                        int plane_major) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)J * M * N;
  if (idx >= total) return;
  int x = (int)(idx & (N - 1));
  long long poly = idx >> log2n;          // j * M + m, or m * J + j
  int m = plane_major ? (int)(poly % M) : (int)(poly / J);
  int j = plane_major ? (int)(poly / M) : (int)(poly % J);
  int a = amounts[m];
  int r = a & (N - 1);
  int g = (a >> log2n) & 1;
  const long long* row = acc + poly * N;
  uint64_t v = (uint64_t)row[(x - r) & (N - 1)];
  if ((x < r) != (g == 1)) v = 0ull - v;
  uint64_t diff = v - (uint64_t)row[x];

  int ksh = 64 - blog * levels;
  uint64_t top = (diff + (1ull << (ksh - 1))) >> ksh;
  uint64_t mask = (1ull << blog) - 1ull;
  long long half = 1ll << (blog - 1);
  long long carry = 0;
  for (int i = 0; i < levels; ++i) {
    long long d = (long long)((top >> (i * blog)) & mask) + carry;
    carry = (d + half) >> blog;
    long long ds = d - (carry << blog);
    long long b0 = ((ds + 128) & 255) - 128;
    long long d1 = (ds - b0) >> 8;
    long long b1 = ((d1 + 128) & 255) - 128;
    int lev = levels - 1 - i;
    long long o = plane_major
                      ? ((long long)(j * levels + lev) * M + m) * N + x
                      : ((long long)m * J * levels + j * levels + lev) * N + x;
    out0[o] = (signed char)b0;
    out1[o] = (signed char)b1;
  }
}

extern "C" int dctc_rotate_decompose(const void* acc, const void* amounts,
                                     void* out0, void* out1, int J, int M,
                                     int N, int log2n, int blog, int levels,
                                     int plane_major, void* stream) {
  long long total = (long long)J * M * N;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  rotate_decompose_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const long long*)acc, (const int*)amounts, (signed char*)out0,
      (signed char*)out1, J, M, N, log2n, blog, levels, plane_major);
  return (int)cudaGetLastError();
}
