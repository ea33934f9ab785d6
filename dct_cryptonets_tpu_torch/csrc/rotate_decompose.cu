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
// Bound on the card: memory. Each coefficient is one int64 read and 2*levels
// bytes written. Design: one block of N/4 threads (32 to 256) per (m, j)
// row, grid (M, J), so no thread divides by a runtime size and a small row
// still leaves enough blocks on each SM. The block copies its row of N int64
// into shared memory once (16-byte cp.async, every copy of the row in flight
// together), so the rotated read acc[(x - r) mod N] comes from shared
// memory; consecutive threads take consecutive x, so neither read conflicts
// on banks. Each thread writes its digit bytes into byte planes in shared
// memory, and the block then writes each output row with 16-byte stores (a
// warp stores 512 contiguous bytes). The rounding is 64-bit; the digits are
// taken from the 32-bit `top` in 32-bit registers: top < 2^(blog*levels) <=
// 2^32, every digit, carry and byte is below 2^16 in magnitude, so the
// result is the 64-bit arithmetic's bit for bit (the card has no 64-bit
// integer unit: each 64-bit step is two or more 32-bit instructions). When
// the planes of all levels do not fit beside the row (large N and many
// levels), the block makes one pass per group of levels, recomputing the
// short carry chain. The 2-level gadget (both flagship lattices) is compiled
// on its own, its digit loop unrolled.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoefPerThread = 4;         // blocks of N / 4 threads, 32..256
constexpr int kPlaneBudget = 48 * 1024;   // shared bytes for byte planes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// LEV: the number of levels when known at compile time, else 0
template <int LEV>
__global__ void __launch_bounds__(kThreads)
    rotate_decompose_kernel(const long long* __restrict__ acc,
                            const int* __restrict__ amounts,
                            signed char* __restrict__ out0,
                            signed char* __restrict__ out1, int J, int M,
                            int N, int log2n, int blog, int levels_rt,
                            int plane_major, int lev_group, int vec) {
  const int levels = LEV ? LEV : levels_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* row = (long long*)smem;                       // N int64
  signed char* planes = (signed char*)(smem + 8 * (size_t)N);
  const int m = blockIdx.x, j = blockIdx.y;
  const long long in_row =
      plane_major ? (long long)j * M + m : (long long)m * J + j;
  const long long* src = acc + in_row * N;
  if (vec) {
    for (int i = threadIdx.x; i < N / 2; i += blockDim.x)
      cp_async16(row + 2 * i, src + 2 * i);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x) row[i] = src[i];
  }
  const int a = amounts[m];
  const int r = a & (N - 1);
  const bool g = (a >> log2n) & 1;
  const int ksh = 64 - blog * levels;                      // >= 32
  const uint64_t rnd = 1ull << (ksh - 1);
  const uint32_t dmask = (1u << blog) - 1u;
  const int half = 1 << (blog - 1);
  __syncthreads();

  for (int l0 = 0; l0 < levels; l0 += lev_group) {
    const int lg = min(lev_group, levels - l0);
    for (int x = threadIdx.x; x < N; x += blockDim.x) {
      uint64_t v = (uint64_t)row[(x - r) & (N - 1)];
      if ((x < r) != g) v = 0ull - v;
      const uint64_t diff = v - (uint64_t)row[x];
      const uint32_t top = (uint32_t)((diff + rnd) >> ksh);
      int carry = 0;
#pragma unroll
      for (int i = 0; i < levels; ++i) {
        const int d = (int)((top >> (i * blog)) & dmask) + carry;
        carry = (d + half) >> blog;
        const int ds = d - (carry << blog);
        const int b0 = ((ds + 128) & 255) - 128;
        const int d1 = (ds - b0) >> 8;
        const int b1 = ((d1 + 128) & 255) - 128;
        const int p = levels - 1 - i - l0;                 // level in group
        if ((unsigned)p < (unsigned)lg) {
          planes[(2 * p) * N + x] = (signed char)b0;
          planes[(2 * p + 1) * N + x] = (signed char)b1;
        }
      }
    }
    __syncthreads();
    // plane q = 2*p + byte holds level l0 + p of out<byte>
    const int per_plane = N >= 16 ? N / 16 : N;            // store units
    const int log2u = N >= 16 ? log2n - 4 : log2n;
    for (int u = threadIdx.x; u < 2 * lg * per_plane; u += blockDim.x) {
      const int q = u >> log2u, off = u & (per_plane - 1);
      const int lev = l0 + (q >> 1);
      const long long out_row =
          plane_major ? (long long)(j * levels + lev) * M + m
                      : ((long long)m * J + j) * levels + lev;
      signed char* dst = ((q & 1) ? out1 : out0) + out_row * N;
      const signed char* s = planes + q * N;
      if (N >= 16)
        *(uint4*)(dst + 16 * off) = *(const uint4*)(s + 16 * off);
      else
        dst[off] = s[off];
    }
    if (l0 + lev_group < levels) __syncthreads();
  }
}

}  // namespace

extern "C" int dctc_rotate_decompose(const void* acc, const void* amounts,
                                     void* out0, void* out1, int J, int M,
                                     int N, int log2n, int blog, int levels,
                                     int plane_major, void* stream) {
  int lev_group = kPlaneBudget / (2 * N);
  lev_group = lev_group < 1 ? 1 : (lev_group > levels ? levels : lev_group);
  const size_t smem = 8 * (size_t)N + 2 * (size_t)lev_group * N;
  // both flagship lattices' gadgets have 2 levels
  auto kernel = levels == 2 ? rotate_decompose_kernel<2>
                            : rotate_decompose_kernel<0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = N / kCoefPerThread;
  threads = threads > kThreads ? kThreads : (threads < 32 ? 32 : threads);
  const int vec = N % 2 == 0 && (uintptr_t)acc % 16 == 0;
  kernel<<<dim3((unsigned)M, (unsigned)J), threads, smem,
           (cudaStream_t)stream>>>(
      (const long long*)acc, (const int*)amounts, (signed char*)out0,
      (signed char*)out1, J, M, N, log2n, blog, levels, plane_major,
      lev_group, vec);
  return (int)cudaGetLastError();
}
