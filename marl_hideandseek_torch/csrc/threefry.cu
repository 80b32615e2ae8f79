// Threefry2x32-20 over a batch of keys: the block cipher behind every
// random draw of the port (prng.py), with the rounds, rotations and key
// schedule of Random123 and of JAX's threefry2x32 lowering
// (jax/_src/prng.py, _threefry2x32_lowering).
//
// keys [k, 2] u32; counters [k or 1, n, 2] u32, or none: then counter j
// of every key is (0, j), JAX's iota_2x32_shape over a flat shape of n.
// One thread per (key, counter); item i = b * n + j. Modes:
//   0 (pairs)   out [k, n, 2] u32: both output words (split, fold_in);
//   1 (bits)    out [k, n] u32: word0 ^ word1, JAX's partitionable
//               32-bit random bits;
//   2 (uniform) out [k, n] f32: those bits as a float in [0, 1), JAX's
//               _uniform: (bits >> 9) | 0x3F800000 read as a float, less 1.
//
// Built by ops/build.py (plain nvcc, C interface). As host C++
// (g++ -x c++ -DMHS_HOST_BUILD) the same item function runs in a loop,
// so tests/test_torch_kernels_host.py holds it to JAX on the CPU.

#include <stdint.h>
#include <string.h>

#ifdef MHS_HOST_BUILD
#define MHS_TF_HD inline
#else
#include <cuda_runtime.h>
#define MHS_TF_HD __host__ __device__ __forceinline__
#endif

namespace {

MHS_TF_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Four rounds of add, rotate, xor.
MHS_TF_HD void rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                      int r3) {
  x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

MHS_TF_HD void threefry2x32_20(uint32_t k0, uint32_t k1, uint32_t& x0,
                               uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

struct Args {
  const uint32_t* keys;
  const uint32_t* ctr;    // null: counter j is (0, j)
  long long ctr_stride;   // words between keys' counter rows: 0 or 2n
  long long k, n;
  int mode;
  void* out;
};

MHS_TF_HD void item(const Args& a, long long i) {
  const long long b = i / a.n;
  const long long j = i - b * a.n;
  const uint32_t k0 = a.keys[2 * b], k1 = a.keys[2 * b + 1];
  uint32_t x0, x1;
  if (a.ctr) {
    const uint32_t* c = a.ctr + b * a.ctr_stride + 2 * j;
    x0 = c[0];
    x1 = c[1];
  } else {
    x0 = (uint32_t)((unsigned long long)j >> 32);
    x1 = (uint32_t)j;
  }
  threefry2x32_20(k0, k1, x0, x1);
  if (a.mode == 0) {
    uint32_t* o = static_cast<uint32_t*>(a.out) + 2 * i;
    o[0] = x0;
    o[1] = x1;
    return;
  }
  const uint32_t v = x0 ^ x1;
  if (a.mode == 1) {
    static_cast<uint32_t*>(a.out)[i] = v;
    return;
  }
  const uint32_t fb = (v >> 9) | 0x3F800000u;
  float f;
  memcpy(&f, &fb, sizeof(f));
  static_cast<float*>(a.out)[i] = f - 1.0f;
}

bool valid(const Args& a) {
  return a.keys && a.out && a.k >= 0 && a.n >= 0 && a.mode >= 0 &&
         a.mode <= 2 && (a.ctr_stride == 0 || a.ctr_stride == 2 * a.n);
}

}  // namespace

#ifndef MHS_HOST_BUILD
namespace {
constexpr int BLOCK_THREADS = 256;

__global__ void __launch_bounds__(BLOCK_THREADS)
    threefry_kernel(const Args a, long long total) {
  const long long stride = (long long)gridDim.x * BLOCK_THREADS;
  for (long long i = (long long)blockIdx.x * BLOCK_THREADS + threadIdx.x;
       i < total; i += stride)
    item(a, i);
}
}  // namespace

// Returns a cudaError_t code (0 on success); 1 for bad arguments.
extern "C" int mhs_threefry(const void* keys, const void* ctr,
                            long long ctr_stride, long long k, long long n,
                            int mode, void* out, void* stream) {
  Args a{static_cast<const uint32_t*>(keys),
         static_cast<const uint32_t*>(ctr), ctr_stride, k, n, mode, out};
  if (!valid(a)) return 1;
  const long long total = k * n;
  if (total == 0) return 0;
  long long blocks = (total + BLOCK_THREADS - 1) / BLOCK_THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  threefry_kernel<<<(unsigned)blocks, BLOCK_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, total);
  return (int)cudaGetLastError();
}
#else
// Host rehearsal entry: the same item function, items one after another.
extern "C" int mhs_threefry_host(const void* keys, const void* ctr,
                                 long long ctr_stride, long long k,
                                 long long n, int mode, void* out) {
  Args a{static_cast<const uint32_t*>(keys),
         static_cast<const uint32_t*>(ctr), ctr_stride, k, n, mode, out};
  if (!valid(a)) return 1;
  for (long long i = 0; i < k * n; ++i) item(a, i);
  return 0;
}
#endif
