// Device exponentials shared by every kernel of the port.
//
// vexp_f32, vexp_hw and exact_exp reproduce repro_torch/core/vexp.py (and
// through it repro/core/vexp.py) bit for bit, except exact_exp, which is
// the toolkit's expf (within 2 ulp of torch.exp). What keeps them exact:
//   * every f32 step of the polynomial is a rounded intrinsic
//     (__fmul_rn / __fadd_rn / __fsub_rn), in the reference's association
//     order, so nvcc cannot contract a multiply and an add into an FMA;
//   * LOG2E and the saturation thresholds are float constants rounded once
//     from the double the reference's Python expression produces, so no
//     comparison is promoted to double;
//   * logical shifts are shifts of unsigned, arithmetic ones of int;
//   * the library is built without --use_fast_math (no __expf, no FTZ).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vexp {

constexpr float kAlpha = 0.21875f;   // 7/32
constexpr float kBeta = 0.4375f;     // 7/16
constexpr float kGamma1 = 3.296875f; // 211/64
constexpr float kGamma2 = 2.171875f; // 139/64
constexpr float kLog2e = (float)1.4426950408889634;
constexpr float kSatLo = (float)(-126.0 * 0.6931471805599453);
constexpr float kSatHi = (float)(128.0 * 0.6931471805599453);

// Backend codes shared with the Python wrappers (kernels/build.py).
enum Backend : int { kExact = 0, kVexp = 1, kVexpHw = 2 };

__device__ __forceinline__ float exact_exp(float x) { return expf(x); }

// Schraudolph + two-branch P(f) in f32 (core/vexp.py: vexp_f32).
__device__ __forceinline__ float vexp_f32(float x) {
  if (isnan(x)) return __int_as_float(0x7FC00000);
  const float xc = fminf(fmaxf(x, -200.0f), 200.0f);
  const float xp = __fmul_rn(xc, kLog2e);
  const float fi = floorf(xp);
  const float f = __fsub_rn(xp, fi);
  const float lo = __fmul_rn(__fmul_rn(kAlpha, f), __fadd_rn(f, kGamma1));
  const float hi = __fsub_rn(
      1.0f, __fmul_rn(__fmul_rn(kBeta, __fsub_rn(1.0f, f)),
                      __fadd_rn(f, kGamma2)));
  const float m = __fadd_rn(1.0f, f < 0.5f ? lo : hi);   // in [1, 2)
  const int ii = min(max((int)fi, -127), 128);           // |fi| <= 289
  float out = __int_as_float(__float_as_int(m) +
                             (int)((unsigned)ii << 23));
  if (ii <= -127) out = 0.0f;
  if (ii >= 128) out = __int_as_float(0x7F800000);
  if (x <= kSatLo) out = 0.0f;
  if (x >= kSatHi) out = __int_as_float(0x7F800000);
  return out;
}

__device__ __forceinline__ int round_shift_right(int v, int k) {
  k = min(max(k, 0), 30);
  const int bias = k > 0 ? (1 << (k - 1)) : 0;
  return (v + bias) >> k;   // v >= 0
}

// Fixed-point P(f), f in Q0.15 (core/vexp.py: _pcorr_q15). Every operand
// is non-negative and every product below 2^31.
__device__ __forceinline__ int pcorr_q15(int f) {
  const int fl = min(f, (1 << 14) - 1);
  const int fh = max(f, 1 << 14);
  const int t1 = (int)((unsigned)(fl * (fl + 108032)) >> 15);
  const int lo = (int)((unsigned)(7168 * t1) >> 15);
  const int nf = 0x7FFF - fh;
  const int t2 = (int)((unsigned)(nf * (fh + 71168)) >> 15);
  const int hi = 0x7FFF - (int)((unsigned)(14336 * t2) >> 15);
  return f < (1 << 14) ? lo : hi;
}

// Bit-level model of the paper's BF16 EXP block on a bf16 bit pattern
// (core/vexp.py: vexp_bf16_fixedpoint).
__device__ __forceinline__ uint16_t vexp_hw_bits(uint16_t b) {
  const int bits = b;
  const int sign = (bits >> 15) & 1;
  const int e = (bits >> 7) & 0xFF;
  const int mant = (bits & 0x7F) | 0x80;
  const int prod = mant * 47274;                 // mant * LOG2E_Q15
  const int k = 134 - min(e, 134);
  int xq = round_shift_right(prod, k);
  if (sign == 1) xq = -xq;
  const int i = xq >> 15;                        // arithmetic: floor(x')
  const int f = xq & 0x7FFF;
  const int p = pcorr_q15(f);
  int m7 = (int)((unsigned)(p + (1 << 7)) >> 8);
  const int carry = (int)((unsigned)m7 >> 7);
  if (carry == 1) m7 = 0;
  const int new_e = i + 127 + carry;
  int out = (int)(((unsigned)new_e << 7) | (unsigned)m7);
  const bool pos_over = sign == 0 && (e >= 135 || new_e >= 255);
  const bool under = (sign == 1 && (e >= 135 || new_e <= 0)) ||
                     (sign == 0 && new_e <= 0);
  if (pos_over) out = 0x7F80;
  if (under) out = 0;
  const int mb = bits & 0x7F;
  if (e == 255 && mb != 0) out = 0x7FC0;                 // qNaN
  if (e == 255 && mb == 0 && sign == 1) out = 0;         // exp(-inf)
  if (e == 255 && mb == 0 && sign == 0) out = 0x7F80;    // exp(+inf)
  return (uint16_t)out;
}

// Any f32 through the hardware model: round to bf16, run, widen (exact).
__device__ __forceinline__ float vexp_hw(float x) {
  const uint16_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return __bfloat162float(__ushort_as_bfloat16(vexp_hw_bits(b)));
}

// The policy's exponential; `backend` is uniform across the launch.
__device__ __forceinline__ float apply_exp(int backend, float x) {
  if (backend == kExact) return exact_exp(x);
  if (backend == kVexp) return vexp_f32(x);
  return vexp_hw(x);
}

}  // namespace vexp
