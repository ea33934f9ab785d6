// Negacyclic rotate-and-diff: out = X^a * acc - acc.
//
// Replaces the TPU kernel dct_cryptonets_tpu/fhe/pallas_kernels.py
// rotate_diff / _rotate_diff_kernel.  Neither package calls it; it is the
// first half of the CMUX front (rotate_decompose.cu fuses it with the
// gadget decomposition).
//
// Per sample m with amount a = g*N + r in [0, 2N), on acc (M, J, N), the
// int64 bit patterns of torus elements:
//   rot[x] = acc[(x - r) mod N], negated where (x < r) XOR g
//   out    = rot - acc                                    (mod 2^64)
//
// Bound on the card: memory (two int64 reads, one of them at the rotated
// index inside the same row, and one int64 write per element).  Design:
// one thread per coefficient with the rotation as index arithmetic, as in
// rotate_decompose.cu.  The TPU kernel's doubled [p, -p] buffer and its
// log2(2N) masked rolls exist because its vector unit has no gather; they
// have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void rotate_diff_kernel(const long long* __restrict__ acc,
                                   const int* __restrict__ amounts,
                                   long long* __restrict__ out, int M, int J,
                                   int log2n) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = ((long long)M * J) << log2n;
  if (idx >= total) return;
  int N = 1 << log2n;
  int x = (int)(idx & (N - 1));
  long long poly = idx >> log2n;          // m * J + j
  int a = amounts[poly / J];
  int r = a & (N - 1);
  int g = (a >> log2n) & 1;
  const long long* row = acc + (poly << log2n);
  uint64_t v = (uint64_t)row[(x - r) & (N - 1)];
  if ((x < r) != (g == 1)) v = 0ull - v;
  out[idx] = (long long)(v - (uint64_t)row[x]);
}

extern "C" int dctc_rotate_diff(const void* acc, const void* amounts,
                                void* out, int M, int J, int log2n,
                                void* stream) {
  long long total = ((long long)M * J) << log2n;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  rotate_diff_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)acc, (const int*)amounts, (long long*)out, M, J,
      log2n);
  return (int)cudaGetLastError();
}
