// Threefry-2x32 draws for Hopper (sm_90a), each fused into one pass: the
// keyed sampler's keys and Gumbel-max, and the burns' normal and randint
// inputs.
//
// Replaces no Pallas kernel: the reference draws with jax.random, which
// XLA fuses into the program that uses the draw. The port's plain versions
// (tpumon_torch/prng.py's torch functions, held to jax.random bit for bit
// by the CPU tests) are eager torch: a normal is ~200 elementwise launches
// over int64 words. Here one thread computes one element from its key and
// index, and only the result is written:
// - tpumon_threefry_keys: keys, by fold_in (counter (0, data)) or split
//   (counter i);
// - tpumon_threefry_draw: 32-bit draws masked to a width, uniform,
//   normal, gumbel or randint;
// - tpumon_threefry_categorical: per row, the first index of the largest
//   gumbel + logit, one CTA a row.
//
// Threefry (jax's threefry2x32 with partitionable counters): a key is two
// uint32 words, element i of a draw is Threefry-2x32 (20 rounds) of the
// key over the 64-bit counter i as (hi, lo) words, and its 32 bits are the
// XOR of the two output words.
//
// The float draws equal the plain versions bit for bit:
// - every float32 step is an explicitly rounded intrinsic, so nvcc fuses
//   no product and sum into an FMA the plain version does not have;
// - XLA's CPU log, log1p and erf_inv are copied as the plain version
//   copies them, each of their FMAs one float64 product and sum rounded
//   once to float32;
// - bfloat16 draws round to bfloat16 after each step, as torch's
//   bfloat16 arithmetic does;
// - the constants are the plain version's decimal values rounded to
//   double and then to float (F32 below), as Python rounds them.
//
// Bound: the integer and float operations on the CUDA cores (~78 32-bit
// integer operations a Threefry call, two calls a randint element; XLA's
// log and erf_inv in float64 products and sums, each with its float32 <->
// float64 conversions), against bytes written once (2 bytes a bf16
// normal, 1 an int8 randint). A bf16 normal takes one of 128 values, so
// the draw kernel computes those once a CTA and looks elements up: its
// cost is the Threefry call. The categorical reads each logit once and
// writes one index a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define F32(x) static_cast<float>(x)

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Threefry-2x32 of the key (k0, k1) over the counter (x0, x1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// The 32 bits of element i under the key (k0, k1).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// An FMA of XLA's emitter as the plain version computes it.
__device__ __forceinline__ float fma_d(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// XLA's f32 log (Cephes), for positive normal floats.
__device__ __forceinline__ float xla_log(float v) {
  constexpr float kLogP[9] = {F32(7.0376836292e-2),  F32(-1.1514610310e-1), F32(1.1676998740e-1),
                              F32(-1.2420140846e-1), F32(1.4249322787e-1),  F32(-1.6668057665e-1),
                              F32(2.0000714765e-1),  F32(-2.4999993993e-1), F32(3.3333331174e-1)};
  constexpr float kLogQ1 = F32(-2.12194440e-4), kLogQ2 = F32(0.693359375);
  constexpr float kSqrtHalf = F32(0.707106781186547524);
  const int32_t b = __float_as_int(v);
  float e = __fsub_rn(static_cast<float>((b >> 23) & 0xFF), 126.0f);
  const float xm = __int_as_float((b & 0x7FFFFF) | 0x3F000000);
  const bool small = xm < kSqrtHalf;
  const float x = __fadd_rn(__fsub_rn(xm, 1.0f), small ? xm : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = fma_d(fma_d(kLogP[0], x, kLogP[1]), x, kLogP[2]);
  const float y1 = fma_d(fma_d(kLogP[3], x, kLogP[4]), x, kLogP[5]);
  const float y2 = fma_d(fma_d(kLogP[6], x, kLogP[7]), x, kLogP[8]);
  y = fma_d(fma_d(y, x3, y1), x3, y2);
  y = fma_d(y, x3, __fmul_rn(e, kLogQ1));
  return fma_d(e, kLogQ2, __fadd_rn(fma_d(x2, -0.5f, x), y));
}

// XLA's f32 log1p: Cephes' rational form below sqrt(2) - 1, else log(1 + x).
__device__ __forceinline__ float xla_log1p(float x) {
  constexpr float kLog1pNum[7] = {
      F32(4.5270000862445199635215e-5), F32(4.9854102823193375972212e-1),
      F32(6.5787325942061044846969e0),  F32(2.9911919328553073277375e1),
      F32(6.0949667980987787057556e1),  F32(5.7112963590585538103336e1),
      F32(2.0039553499201281259648e1)};
  constexpr float kLog1pDen[7] = {
      F32(1.0),                         F32(1.5062909083469192043167e1),
      F32(8.3047565967967209469434e1),  F32(2.2176239823732856465394e2),
      F32(3.0909872225312059774938e2),  F32(2.1642788614495947685003e2),
      F32(6.0118660497603843919306e1)};
  constexpr float kLog1pSmall = F32(0.41421356237309504880);
  if (!(fabsf(x) < kLog1pSmall)) return xla_log(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float num = kLog1pNum[0], den = kLog1pDen[0];
#pragma unroll
  for (int j = 1; j < 7; ++j) {
    num = fma_d(num, x, kLog1pNum[j]);
    den = fma_d(den, x, kLog1pDen[j]);
  }
  const float s = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  return __fadd_rn(x, fma_d(x2, -0.5f, s));
}

// XLA's f32 erf_inv (Giles).
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr float kErfInvLt5[9] = {F32(2.81022636e-08), F32(3.43273939e-07), F32(-3.5233877e-06),
                                   F32(-4.39150654e-06), F32(0.00021858087),  F32(-0.00125372503),
                                   F32(-0.00417768164), F32(0.246640727),     F32(1.50140941)};
  constexpr float kErfInvGe5[9] = {F32(-0.000200214257), F32(0.000100950558), F32(0.00134934322),
                                   F32(-0.00367342844),  F32(0.00573950773),  F32(-0.0076224613),
                                   F32(0.00943887047),   F32(1.00167406),     F32(2.83297682)};
  float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kErfInvLt5[0] : kErfInvGe5[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) p = fma_d(p, w, lt ? kErfInvLt5[j] : kErfInvGe5[j]);
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

enum Kind { kBits = 0, kUniform = 1, kNormal = 2, kGumbel = 3, kRandint = 4 };

struct DrawArgs {
  const long long* keys;  // [rows, 2]; randint: [rows, 2, 2], split(key, 2)
  long long rows, n;      // n elements under each key
  float lo, scale;        // uniform: max(u * scale + lo, lo), in the output type
  float mul;              // normal: sqrt(2) in the output type
  uint32_t mask;          // bits: the width's mask
  uint32_t span, mult, ilo;  // randint: hi - lo, jax's multiplier, lo's bits
};

// uniform's float32 value of 32 bits: 23 mantissa bits under 1.0's
// exponent, minus 1, scaled, raised to lo.
__device__ __forceinline__ float uniform_f32(uint32_t bits, float lo, float scale) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(__fadd_rn(__fmul_rn(f, scale), lo), lo);
}

// The same in bfloat16 from the low 8 bits, rounded after each step.
__device__ __forceinline__ float uniform_bf16(uint32_t bits, float lo, float scale) {
  const uint32_t h = ((bits & 0xFFu) >> 1) | 0x3F80u;
  const float f = round_bf16(__fsub_rn(__uint_as_float(h << 16), 1.0f));
  return fmaxf(round_bf16(__fadd_rn(round_bf16(__fmul_rn(f, scale)), lo)), lo);
}

__device__ __forceinline__ float gumbel_at(uint32_t k0, uint32_t k1, uint64_t i, float lo,
                                           float scale) {
  return -xla_log(-xla_log(uniform_f32(bits_at(k0, k1, i), lo, scale)));
}

// A bfloat16 normal depends on 7 of its 32 bits: uniform_bf16 keeps only
// (bits & 0xFF) >> 1, one of 128 mantissas.
__device__ __forceinline__ __nv_bfloat16 normal_bf16(uint32_t mantissa, const DrawArgs& a) {
  const float u = uniform_bf16(mantissa << 1, a.lo, a.scale);
  return __float2bfloat16_rn(__fmul_rn(round_bf16(xla_erf_inv(u)), a.mul));
}

template <int K, typename T>
__device__ __forceinline__ T draw_one(const DrawArgs& a, const long long* key, uint64_t i) {
  const uint32_t k0 = static_cast<uint32_t>(key[0]), k1 = static_cast<uint32_t>(key[1]);
  if constexpr (K == kBits) {
    return static_cast<T>(bits_at(k0, k1, i) & a.mask);
  } else if constexpr (K == kRandint) {
    const uint32_t hi = bits_at(k0, k1, i);
    const uint32_t lo = bits_at(static_cast<uint32_t>(key[2]), static_cast<uint32_t>(key[3]), i);
    const uint32_t off = (hi % a.span) * a.mult + lo % a.span;
    return static_cast<T>(static_cast<int32_t>(off % a.span + a.ilo));
  } else if constexpr (K == kGumbel) {
    return gumbel_at(k0, k1, i, a.lo, a.scale);
  } else if constexpr (std::is_same<T, float>::value) {
    const float u = uniform_f32(bits_at(k0, k1, i), a.lo, a.scale);
    return K == kUniform ? u : __fmul_rn(xla_erf_inv(u), a.mul);
  } else if constexpr (K == kUniform) {
    return __float2bfloat16_rn(uniform_bf16(bits_at(k0, k1, i), a.lo, a.scale));
  } else {
    return normal_bf16((bits_at(k0, k1, i) & 0xFFu) >> 1, a);
  }
}

// grid (element blocks, rows): a row's elements grid-strided along x.
// bfloat16 normals: each CTA computes the 128 values once into shared
// memory and looks each element's up by its mantissa, so an element costs
// one Threefry call and XLA's erf_inv runs 128 times a CTA.
template <int K, typename T>
__global__ void draw_kernel(DrawArgs a, T* __restrict__ out) {
  constexpr int kKeyWords = K == kRandint ? 4 : 2;
  constexpr bool kTable = K == kNormal && std::is_same<T, __nv_bfloat16>::value;
  __shared__ unsigned short table[kTable ? 128 : 1];
  if constexpr (kTable) {
    for (int m = threadIdx.x; m < 128; m += blockDim.x)
      table[m] = __bfloat16_as_ushort(normal_bf16(m, a));
    __syncthreads();
  }
  for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
    const long long* key = a.keys + r * kKeyWords;
    T* row = out + r * a.n;
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < a.n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
      if constexpr (kTable) {
        const uint32_t bits = bits_at(static_cast<uint32_t>(key[0]),
                                      static_cast<uint32_t>(key[1]), static_cast<uint64_t>(i));
        row[i] = __ushort_as_bfloat16(table[(bits & 0xFFu) >> 1]);
      } else {
        row[i] = draw_one<K, T>(a, key, static_cast<uint64_t>(i));
      }
    }
  }
}

// New keys [rows, n, 2]: under key r (at keys + r * key_stride), element
// (r, i) is Threefry over (hi(i), lo(i)) (split) or, with data, over
// (0, data[r * n + i] mod 2**32) (fold_in); data_kind 0: none, 1: int32,
// 2: int64, 3: the scalar.
__global__ void keys_kernel(const long long* __restrict__ keys, long long key_stride,
                            const void* __restrict__ data, int data_kind, long long scalar,
                            long long rows, long long n, long long* __restrict__ out) {
  const long long total = rows * n;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = t / n, i = t - r * n;
    const long long* key = keys + r * key_stride;
    uint32_t x0, x1;
    if (data_kind == 0) {
      x0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
      x1 = static_cast<uint32_t>(i);
    } else {
      const long long d = data_kind == 1   ? static_cast<const int32_t*>(data)[t]
                          : data_kind == 2 ? static_cast<const long long*>(data)[t]
                                           : scalar;
      x0 = 0;
      x1 = static_cast<uint32_t>(d);
    }
    threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]), x0, x1);
    out[2 * t] = x0;
    out[2 * t + 1] = x1;
  }
}

// torch.argmax's order: the larger value, NaN above all, the first index
// on ties.
__device__ __forceinline__ bool better(float a, long long ia, float b, long long ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

constexpr int kCatThreads = 512;

// One CTA a row: the first index of the largest gumbel(key, [v]) + logit.
__global__ void __launch_bounds__(kCatThreads)
    categorical_kernel(const long long* __restrict__ keys, const float* __restrict__ logits,
                       long long v, float lo, float scale, long long* __restrict__ out) {
  __shared__ float s_val[kCatThreads / 32];
  __shared__ long long s_idx[kCatThreads / 32];
  const long long row = blockIdx.x;
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * row]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * row + 1]);
  const float* lg = logits + row * v;
  float best = -INFINITY;
  long long idx = LLONG_MAX;
  for (long long i = threadIdx.x; i < v; i += kCatThreads) {
    const float val = __fadd_rn(gumbel_at(k0, k1, static_cast<uint64_t>(i), lo, scale), lg[i]);
    if (better(val, i, best, idx)) {
      best = val;
      idx = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const long long oi = __shfl_down_sync(0xFFFFFFFFu, idx, off);
    if (better(ov, oi, best, idx)) {
      best = ov;
      idx = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCatThreads / 32; ++w) {
      if (better(s_val[w], s_idx[w], best, idx)) {
        best = s_val[w];
        idx = s_idx[w];
      }
    }
    out[row] = idx;
  }
}

constexpr int kThreads = 256;

int grid_x(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 2048 ? blocks : 2048);
}

template <int K, typename T>
cudaError_t launch_draw(const DrawArgs& a, void* out, cudaStream_t s) {
  const dim3 grid(grid_x(a.n), static_cast<unsigned>(a.rows < 65535 ? a.rows : 65535));
  draw_kernel<K, T><<<grid, kThreads, 0, s>>>(a, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output types: 0 float32, 1 bfloat16, 2 int8, 3 int16, 4 int32, 5 int64.
// kind 0 bits (int64), 1 uniform and 2 normal (float32, bfloat16), 3
// gumbel (float32), 4 randint (int8 .. int64). keys int64 [rows, 2]
// ([rows, 2, 2] for randint) and out [rows, n] contiguous on the current
// device; rows and n at least 1. Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing.
int tpumon_threefry_draw(const void* keys, long long rows, long long n, int kind, int dtype,
                         float lo, float scale, float mul, unsigned mask, unsigned span,
                         unsigned mult, unsigned ilo, void* out, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const DrawArgs a{static_cast<const long long*>(keys), rows, n, lo, scale, mul, mask, span,
                   mult, ilo};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind * 8 + dtype) {
    case kBits * 8 + 5: return (int)launch_draw<kBits, long long>(a, out, s);
    case kUniform * 8 + 0: return (int)launch_draw<kUniform, float>(a, out, s);
    case kUniform * 8 + 1: return (int)launch_draw<kUniform, __nv_bfloat16>(a, out, s);
    case kNormal * 8 + 0: return (int)launch_draw<kNormal, float>(a, out, s);
    case kNormal * 8 + 1: return (int)launch_draw<kNormal, __nv_bfloat16>(a, out, s);
    case kGumbel * 8 + 0: return (int)launch_draw<kGumbel, float>(a, out, s);
    case kRandint * 8 + 2: return (int)launch_draw<kRandint, int8_t>(a, out, s);
    case kRandint * 8 + 3: return (int)launch_draw<kRandint, int16_t>(a, out, s);
    case kRandint * 8 + 4: return (int)launch_draw<kRandint, int32_t>(a, out, s);
    case kRandint * 8 + 5: return (int)launch_draw<kRandint, long long>(a, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Keys int64 [rows, n, 2] into out; keys at keys + r * key_stride (0: one
// key for every row); data as keys_kernel takes it, [rows * n] when given.
int tpumon_threefry_keys(const void* keys, long long key_stride, const void* data, int data_kind,
                         long long scalar, long long rows, long long n, void* out,
                         void* stream) {
  if (rows < 1 || n < 1 || data_kind < 0 || data_kind > 3 || (data_kind == 1 && !data) ||
      (data_kind == 2 && !data))
    return (int)cudaErrorInvalidValue;
  keys_kernel<<<grid_x(rows * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), key_stride, data, data_kind, scalar, rows, n,
      static_cast<long long*>(out));
  return cudaGetLastError();
}

// out int64 [rows]: per row, argmax of gumbel(keys[row], [v]) + logits[row]
// (float32 [rows, v]); lo and scale: uniform(tiny, 1)'s constants.
int tpumon_threefry_categorical(const void* keys, const void* logits, long long rows, long long v,
                                float lo, float scale, void* out, void* stream) {
  if (rows < 1 || rows > 2147483647LL || v < 1) return (int)cudaErrorInvalidValue;
  categorical_kernel<<<static_cast<unsigned>(rows), kCatThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const float*>(logits), v, lo, scale,
      static_cast<long long*>(out));
  return cudaGetLastError();
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
