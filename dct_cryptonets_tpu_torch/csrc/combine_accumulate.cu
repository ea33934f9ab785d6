// The s2d engine's CMUX back half: recombine the external product's int32
// byte-scale buckets into the 64-bit accumulator.
//
// Replaces the TPU kernel dct_cryptonets_tpu/fhe/pallas_kernels.py
// combine_accumulate / _combine_kernel:
//
//   out[m, j, c] = acc[m, j, c]
//                + sum_s bucket_s[m, j, c] * 2^(8 s)            (mod 2^64)
//   bucket_s     = sum of o_u[m, j*L + vi, c] over u in {0, 1}, vi < L,
//                  with u + vi + drop == s, s < 8 and u + vi >= cross
//
// o0/o1 (M, J*L, N) int32 are the two digit bytes' external products
// (one int8 GEMM each, fhe/pbs.py conv_external_s2d); acc and out are
// (M, J, N) int64 bit patterns of torus elements.  As in the TPU kernel,
// the terms of one scale are summed in int32 (wrapping) and only then
// widened and shifted; the shift is done on uint64, because a left shift
// of a negative signed value is undefined in C++17.
//
// Bound on the card: memory.  Each output word reads 2*L int32 terms and
// one int64, and writes one int64; there is no arithmetic worth counting.
// Design: one thread per output coefficient, neighbouring threads on
// neighbouring coefficients so every load and store is coalesced; the
// TPU kernel's VMEM tile has no counterpart to build.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void combine_accumulate_kernel(const int* __restrict__ o0,
                                          const int* __restrict__ o1,
                                          const long long* __restrict__ acc,
                                          long long* __restrict__ out, int M,
                                          int J, int log2n, int L, int drop,
                                          int cross) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = ((long long)M * J) << log2n;
  if (idx >= total) return;
  int N = 1 << log2n;
  int c = (int)(idx & (N - 1));
  long long poly = idx >> log2n;          // m * J + j
  long long base = (poly * L << log2n) + c;
  uint64_t v = (uint64_t)acc[idx];
  for (int s = drop; s < 8; ++s) {
    uint32_t b = 0;
    for (int u = 0; u < 2; ++u) {
      int vi = s - drop - u;
      if (vi < 0 || vi >= L || u + vi < cross) continue;
      const int* o = u ? o1 : o0;
      b += (uint32_t)o[base + ((long long)vi << log2n)];
    }
    v += (uint64_t)(int64_t)(int32_t)b << (8 * s);
  }
  out[idx] = (long long)v;
}

extern "C" int dctc_combine_accumulate(const void* o0, const void* o1,
                                       const void* acc, void* out, int M,
                                       int J, int log2n, int L, int drop,
                                       int cross, void* stream) {
  long long total = ((long long)M * J) << log2n;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  combine_accumulate_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const int*)o0, (const int*)o1, (const long long*)acc,
      (long long*)out, M, J, log2n, L, drop, cross);
  return (int)cudaGetLastError();
}
