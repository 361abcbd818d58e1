// Clean-room LiteMath-compatible shim, written from the reference renderer's
// observed usage (HydraCore3 includes "LiteMath.h" from the not-checked-out
// msu-graphics-group/LiteMath submodule).  Only exists so the reference CPU
// binary (-DUSE_VULKAN=OFF) can be built in this environment to produce
// golden images for validating hydracore3.  NOT part of the framework.
//
// Conventions (matching hydracore3/utils/lmath.py, which round-1 derived
// from the reference's call sites):
//   * float4x4 is a logically row-major matrix stored as 4 columns m_col[4]
//     with get_row/set_row/get_col/set_col accessors.
//   * operator*(m, v) = rows-of-m dot v.
//   * lookAt / perspectiveMatrix follow the classic GL forms.
#ifndef LITEMATH_SHIM_H
#define LITEMATH_SHIM_H

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <initializer_list>

#ifndef MAXFLOAT
#define MAXFLOAT 1e37f
#endif

typedef unsigned int uint;
typedef unsigned short ushort;
typedef unsigned char uchar;

// cmath's M_PI macro would otherwise stomp the namespace constants below
#ifdef M_PI
#undef M_PI
#endif
#ifdef M_TWOPI
#undef M_TWOPI
#endif

namespace LiteMath
{
  constexpr float M_PI       = 3.14159265358979323846f;
  constexpr float M_TWOPI    = 6.28318530717958647692f;
  constexpr float INV_PI     = 0.31830988618379067154f;
  constexpr float INV_TWOPI  = 0.15915494309189533577f;
  constexpr float DEG_TO_RAD = M_PI / 180.0f;
  constexpr float EPSILON    = 1e-6f;
  constexpr float INF_POSITIVE = +1e37f;
  constexpr float INF_NEGATIVE = -1e37f;

  using std::min;
  using std::max;
  using std::sqrt;
  using std::abs;

  static inline int   as_int32(float x)  { int v;  std::memcpy(&v, &x, 4); return v; }
  static inline uint  as_uint32(float x) { uint v; std::memcpy(&v, &x, 4); return v; }
  static inline float as_float(int x)    { float v; std::memcpy(&v, &x, 4); return v; }
  static inline float as_float(uint x)   { float v; std::memcpy(&v, &x, 4); return v; }
  static inline float as_float(unsigned long x)      { return as_float(uint(x)); }
  static inline float as_float(unsigned long long x) { return as_float(uint(x)); }
  static inline int   as_int(float x)    { return as_int32(x); }
  static inline uint  as_uint(float x)   { return as_uint32(x); }

  static inline float clamp(float x, float a, float b) { return x < a ? a : (x > b ? b : x); }
  static inline uint  clamp(uint x, uint a, uint b)    { return x < a ? a : (x > b ? b : x); }
  static inline int   clamp(int x, int a, int b)       { return x < a ? a : (x > b ? b : x); }
  static inline float lerp(float a, float b, float t)  { return a + t * (b - a); }
  static inline float mix(float a, float b, float t)   { return a + t * (b - a); }
  static inline float fract(float x)                   { return x - std::floor(x); }
  static inline float sign(float x)                    { return x < 0.0f ? -1.0f : (x > 0.0f ? 1.0f : 0.0f); }
  static inline float smoothstep(float e0, float e1, float x)
  {
    float t = clamp((x - e0) / (e1 - e0), 0.0f, 1.0f);
    return t * t * (3.0f - 2.0f * t);
  }
  static inline float inversesqrt(float x) { return 1.0f / std::sqrt(x); }
  static inline float rsqrt(float x)       { return 1.0f / std::sqrt(x); }

  // ------------------------------------------------------------------ float2
  struct float2
  {
    float2() : x(0), y(0) {}
    float2(float a, float b) : x(a), y(b) {}
    explicit float2(float a) : x(a), y(a) {}
    float x, y;
    float& operator[](int i)       { return (&x)[i]; }
    float  operator[](int i) const { return (&x)[i]; }
  };
  static inline float2 operator+(float2 a, float2 b) { return float2(a.x + b.x, a.y + b.y); }
  static inline float2 operator-(float2 a, float2 b) { return float2(a.x - b.x, a.y - b.y); }
  static inline float2 operator*(float2 a, float2 b) { return float2(a.x * b.x, a.y * b.y); }
  static inline float2 operator/(float2 a, float2 b) { return float2(a.x / b.x, a.y / b.y); }
  static inline float2 operator*(float2 a, float s)  { return float2(a.x * s, a.y * s); }
  static inline float2 operator*(float s, float2 a)  { return float2(a.x * s, a.y * s); }
  static inline float2 operator/(float2 a, float s)  { return float2(a.x / s, a.y / s); }
  static inline float2 operator+(float2 a, float s)  { return float2(a.x + s, a.y + s); }
  static inline float2 operator+(float s, float2 a)  { return float2(a.x + s, a.y + s); }
  static inline float2 operator-(float2 a, float s)  { return float2(a.x - s, a.y - s); }
  static inline float2 operator-(float2 a)           { return float2(-a.x, -a.y); }
  static inline float2& operator+=(float2& a, float2 b) { a.x += b.x; a.y += b.y; return a; }
  static inline float2& operator-=(float2& a, float2 b) { a.x -= b.x; a.y -= b.y; return a; }
  static inline float2& operator*=(float2& a, float s)  { a.x *= s; a.y *= s; return a; }
  static inline float2& operator*=(float2& a, float2 b) { a.x *= b.x; a.y *= b.y; return a; }
  static inline float dot(float2 a, float2 b)   { return a.x * b.x + a.y * b.y; }
  static inline float length(float2 a)          { return std::sqrt(dot(a, a)); }
  static inline float2 normalize(float2 a)      { return a / length(a); }
  static inline float2 min(float2 a, float2 b)  { return float2(std::min(a.x, b.x), std::min(a.y, b.y)); }
  static inline float2 max(float2 a, float2 b)  { return float2(std::max(a.x, b.x), std::max(a.y, b.y)); }
  static inline float2 clamp(float2 v, float a, float b) { return float2(clamp(v.x, a, b), clamp(v.y, a, b)); }
  static inline float2 abs(float2 a) { return float2(std::abs(a.x), std::abs(a.y)); }
  static inline float2 floor(float2 a) { return float2(std::floor(a.x), std::floor(a.y)); }
  static inline float2 lerp(float2 a, float2 b, float t) { return a + (b - a) * t; }
  static inline float2 mix(float2 a, float2 b, float t)  { return a + (b - a) * t; }

  // ------------------------------------------------------------------ float3
  struct float3
  {
    float3() : x(0), y(0), z(0) {}
    float3(float a, float b, float c) : x(a), y(b), z(c) {}
    explicit float3(float a) : x(a), y(a), z(a) {}
    explicit float3(const float* p) : x(p[0]), y(p[1]), z(p[2]) {}
    union { struct { float x, y, z; }; float M[3]; };
    float& operator[](int i)       { return M[i]; }
    float  operator[](int i) const { return M[i]; }
  };
  static inline float3 operator+(float3 a, float3 b) { return float3(a.x + b.x, a.y + b.y, a.z + b.z); }
  static inline float3 operator-(float3 a, float3 b) { return float3(a.x - b.x, a.y - b.y, a.z - b.z); }
  static inline float3 operator*(float3 a, float3 b) { return float3(a.x * b.x, a.y * b.y, a.z * b.z); }
  static inline float3 operator/(float3 a, float3 b) { return float3(a.x / b.x, a.y / b.y, a.z / b.z); }
  static inline float3 operator*(float3 a, float s)  { return float3(a.x * s, a.y * s, a.z * s); }
  static inline float3 operator*(float s, float3 a)  { return float3(a.x * s, a.y * s, a.z * s); }
  static inline float3 operator/(float3 a, float s)  { return float3(a.x / s, a.y / s, a.z / s); }
  static inline float3 operator/(float s, float3 a)  { return float3(s / a.x, s / a.y, s / a.z); }
  static inline float3 operator+(float3 a, float s)  { return float3(a.x + s, a.y + s, a.z + s); }
  static inline float3 operator+(float s, float3 a)  { return float3(a.x + s, a.y + s, a.z + s); }
  static inline float3 operator-(float3 a, float s)  { return float3(a.x - s, a.y - s, a.z - s); }
  static inline float3 operator-(float s, float3 a)  { return float3(s - a.x, s - a.y, s - a.z); }
  static inline float3 operator-(float3 a)           { return float3(-a.x, -a.y, -a.z); }
  static inline float3& operator+=(float3& a, float3 b) { a.x += b.x; a.y += b.y; a.z += b.z; return a; }
  static inline float3& operator-=(float3& a, float3 b) { a.x -= b.x; a.y -= b.y; a.z -= b.z; return a; }
  static inline float3& operator*=(float3& a, float s)  { a.x *= s; a.y *= s; a.z *= s; return a; }
  static inline float3& operator*=(float3& a, float3 b) { a.x *= b.x; a.y *= b.y; a.z *= b.z; return a; }
  static inline float3& operator/=(float3& a, float s)  { a.x /= s; a.y /= s; a.z /= s; return a; }
  static inline bool operator==(float3 a, float3 b) { return a.x == b.x && a.y == b.y && a.z == b.z; }
  static inline bool operator!=(float3 a, float3 b) { return !(a == b); }
  static inline float dot(float3 a, float3 b)   { return a.x * b.x + a.y * b.y + a.z * b.z; }
  static inline float3 cross(float3 a, float3 b)
  { return float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x); }
  static inline float length(float3 a)          { return std::sqrt(dot(a, a)); }
  static inline float lengthSq(float3 a)        { return dot(a, a); }
  static inline float3 normalize(float3 a)      { return a / length(a); }
  static inline float3 min(float3 a, float3 b)  { return float3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)); }
  static inline float3 max(float3 a, float3 b)  { return float3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)); }
  static inline float3 clamp(float3 v, float a, float b)
  { return float3(clamp(v.x, a, b), clamp(v.y, a, b), clamp(v.z, a, b)); }
  static inline float3 clamp(float3 v, float3 a, float3 b)
  { return float3(clamp(v.x, a.x, b.x), clamp(v.y, a.y, b.y), clamp(v.z, a.z, b.z)); }
  static inline float3 abs(float3 a)   { return float3(std::abs(a.x), std::abs(a.y), std::abs(a.z)); }
  static inline float3 floor(float3 a) { return float3(std::floor(a.x), std::floor(a.y), std::floor(a.z)); }
  static inline float3 sqrt(float3 a)  { return float3(std::sqrt(a.x), std::sqrt(a.y), std::sqrt(a.z)); }
  static inline float3 exp(float3 a)   { return float3(std::exp(a.x), std::exp(a.y), std::exp(a.z)); }
  static inline float3 pow(float3 a, float p) { return float3(std::pow(a.x, p), std::pow(a.y, p), std::pow(a.z, p)); }
  static inline float3 lerp(float3 a, float3 b, float t) { return a + (b - a) * t; }
  static inline float3 mix(float3 a, float3 b, float t)  { return a + (b - a) * t; }
  static inline float hmin(float3 a) { return std::min(a.x, std::min(a.y, a.z)); }
  static inline float hmax(float3 a) { return std::max(a.x, std::max(a.y, a.z)); }
  static inline float3 reflect(float3 d, float3 n) { return d - 2.0f * dot(d, n) * n; }
  static inline float3 sign(float3 a) { return float3(sign(a.x), sign(a.y), sign(a.z)); }

  // ------------------------------------------------------------------ float4
  struct float4
  {
    float4() : x(0), y(0), z(0), w(0) {}
    float4(float a, float b, float c, float d) : x(a), y(b), z(c), w(d) {}
    explicit float4(float a) : x(a), y(a), z(a), w(a) {}
    float4(float3 v, float d) : x(v.x), y(v.y), z(v.z), w(d) {}
    explicit float4(const float* p) : x(p[0]), y(p[1]), z(p[2]), w(p[3]) {}
    explicit inline float4(const struct int4& v);   // defined after int4
    explicit inline float4(const struct uint4& v);  // defined after uint4
    union { struct { float x, y, z, w; }; float M[4]; };
    float& operator[](int i)       { return M[i]; }
    float  operator[](int i) const { return M[i]; }
  };
  static inline float4 operator+(float4 a, float4 b) { return float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }
  static inline float4 operator-(float4 a, float4 b) { return float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w); }
  static inline float4 operator*(float4 a, float4 b) { return float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w); }
  static inline float4 operator/(float4 a, float4 b) { return float4(a.x / b.x, a.y / b.y, a.z / b.z, a.w / b.w); }
  static inline float4 operator*(float4 a, float s)  { return float4(a.x * s, a.y * s, a.z * s, a.w * s); }
  static inline float4 operator*(float s, float4 a)  { return float4(a.x * s, a.y * s, a.z * s, a.w * s); }
  static inline float4 operator/(float4 a, float s)  { return float4(a.x / s, a.y / s, a.z / s, a.w / s); }
  static inline float4 operator/(float s, float4 a)  { return float4(s / a.x, s / a.y, s / a.z, s / a.w); }
  static inline float4 operator+(float4 a, float s)  { return float4(a.x + s, a.y + s, a.z + s, a.w + s); }
  static inline float4 operator+(float s, float4 a)  { return float4(a.x + s, a.y + s, a.z + s, a.w + s); }
  static inline float4 operator-(float4 a, float s)  { return float4(a.x - s, a.y - s, a.z - s, a.w - s); }
  static inline float4 operator-(float s, float4 a)  { return float4(s - a.x, s - a.y, s - a.z, s - a.w); }
  static inline float4 operator-(float4 a)           { return float4(-a.x, -a.y, -a.z, -a.w); }
  static inline float4& operator+=(float4& a, float4 b) { a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w; return a; }
  static inline float4& operator-=(float4& a, float4 b) { a.x -= b.x; a.y -= b.y; a.z -= b.z; a.w -= b.w; return a; }
  static inline float4& operator*=(float4& a, float s)  { a.x *= s; a.y *= s; a.z *= s; a.w *= s; return a; }
  static inline float4& operator*=(float4& a, float4 b) { a.x *= b.x; a.y *= b.y; a.z *= b.z; a.w *= b.w; return a; }
  static inline float4& operator/=(float4& a, float s)  { a.x /= s; a.y /= s; a.z /= s; a.w /= s; return a; }
  static inline float4& operator/=(float4& a, float4 b) { a.x /= b.x; a.y /= b.y; a.z /= b.z; a.w /= b.w; return a; }
  static inline float dot(float4 a, float4 b)   { return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w; }
  static inline float dot3(float4 a, float4 b)  { return a.x * b.x + a.y * b.y + a.z * b.z; }
  static inline float dot4(float4 a, float4 b)  { return dot(a, b); }
  static inline float dot3f(float4 a, float4 b) { return dot3(a, b); }
  static inline float length(float4 a)          { return std::sqrt(dot(a, a)); }
  static inline float length3f(float4 a)        { return std::sqrt(dot3(a, a)); }
  static inline float length3(float4 a)         { return std::sqrt(dot3(a, a)); }
  static inline float4 normalize(float4 a)      { return a / length(a); }
  static inline float4 normalize3(float4 a)     { float l = length3f(a); return float4(a.x / l, a.y / l, a.z / l, a.w); }
  static inline float4 cross3(float4 a, float4 b)
  { return float4(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x, 0.0f); }
  static inline float4 cross(float4 a, float4 b) { return cross3(a, b); }
  static inline float4 min(float4 a, float4 b)
  { return float4(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z), std::min(a.w, b.w)); }
  static inline float4 max(float4 a, float4 b)
  { return float4(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z), std::max(a.w, b.w)); }
  static inline float4 clamp(float4 v, float a, float b)
  { return float4(clamp(v.x, a, b), clamp(v.y, a, b), clamp(v.z, a, b), clamp(v.w, a, b)); }
  static inline float4 abs(float4 a)   { return float4(std::abs(a.x), std::abs(a.y), std::abs(a.z), std::abs(a.w)); }
  static inline float4 floor(float4 a) { return float4(std::floor(a.x), std::floor(a.y), std::floor(a.z), std::floor(a.w)); }
  static inline float4 sqrt(float4 a)  { return float4(std::sqrt(a.x), std::sqrt(a.y), std::sqrt(a.z), std::sqrt(a.w)); }
  static inline float4 exp(float4 a)   { return float4(std::exp(a.x), std::exp(a.y), std::exp(a.z), std::exp(a.w)); }
  static inline float4 log(float4 a)   { return float4(std::log(a.x), std::log(a.y), std::log(a.z), std::log(a.w)); }
  static inline float4 pow(float4 a, float p)
  { return float4(std::pow(a.x, p), std::pow(a.y, p), std::pow(a.z, p), std::pow(a.w, p)); }
  static inline float4 lerp(float4 a, float4 b, float t) { return a + (b - a) * t; }
  static inline float4 mix(float4 a, float4 b, float t)  { return a + (b - a) * t; }
  static inline float hmin(float4 a) { return std::min(std::min(a.x, a.y), std::min(a.z, a.w)); }
  static inline float hmax(float4 a) { return std::max(std::max(a.x, a.y), std::max(a.z, a.w)); }
  static inline float hmin3(float4 a) { return std::min(a.x, std::min(a.y, a.z)); }
  static inline float hmax3(float4 a) { return std::max(a.x, std::max(a.y, a.z)); }
  static inline float4 rcp(float4 a) { return float4(1.0f / a.x, 1.0f / a.y, 1.0f / a.z, 1.0f / a.w); }
  static inline float4 reflect(float4 d, float4 n) { return d - 2.0f * dot3(d, n) * n; }
  // comparisons return component masks (0xFFFFFFFF / 0), OpenCL-style
  static inline float4 sign(float4 a) { return float4(sign(a.x), sign(a.y), sign(a.z), sign(a.w)); }

  static inline float3 to_float3(float4 v) { return float3(v.x, v.y, v.z); }
  static inline float4 to_float4(float3 v, float w) { return float4(v, w); }
  static inline float2 to_float2(float4 v) { return float2(v.x, v.y); }
  static inline float2 to_float2(float3 v) { return float2(v.x, v.y); }

  static inline float2 make_float2(float x, float y) { return float2(x, y); }
  static inline float3 make_float3(float x, float y, float z) { return float3(x, y, z); }
  static inline float4 make_float4(float x, float y, float z, float w) { return float4(x, y, z, w); }

  // --------------------------------------------------------------- int/uint vecs
  struct int2
  {
    int2() : x(0), y(0) {}
    int2(int a, int b) : x(a), y(b) {}
    int x, y;
  };
  static inline int2 operator+(int2 a, int2 b) { return int2(a.x + b.x, a.y + b.y); }
  static inline int2 operator-(int2 a, int2 b) { return int2(a.x - b.x, a.y - b.y); }

  struct int3
  {
    int3() : x(0), y(0), z(0) {}
    int3(int a, int b, int c) : x(a), y(b), z(c) {}
    int x, y, z;
    int& operator[](int i)       { return (&x)[i]; }
    int  operator[](int i) const { return (&x)[i]; }
  };

  struct int4
  {
    int4() : x(0), y(0), z(0), w(0) {}
    int4(int a, int b, int c, int d) : x(a), y(b), z(c), w(d) {}
    explicit int4(int a) : x(a), y(a), z(a), w(a) {}
    explicit int4(const float4& v)
      : x(int(v.x)), y(int(v.y)), z(int(v.z)), w(int(v.w)) {}
    union { struct { int x, y, z, w; }; int M[4]; };
    int& operator[](int i)       { return M[i]; }
    int  operator[](int i) const { return M[i]; }
  };
  static inline int4 operator+(int4 a, int4 b) { return int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }
  static inline int4 operator-(int4 a, int4 b) { return int4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w); }
  static inline int4 operator*(int4 a, int s)  { return int4(a.x * s, a.y * s, a.z * s, a.w * s); }
  static inline int4 min(int4 a, int4 b)
  { return int4(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z), std::min(a.w, b.w)); }
  static inline int4 max(int4 a, int4 b)
  { return int4(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z), std::max(a.w, b.w)); }
  static inline int4 clamp(int4 v, int a, int b)
  { return int4(clamp(v.x, a, b), clamp(v.y, a, b), clamp(v.z, a, b), clamp(v.w, a, b)); }

  struct uint2
  {
    uint2() : x(0), y(0) {}
    uint2(uint a, uint b) : x(a), y(b) {}
    uint x, y;
    bool operator==(const uint2& o) const { return x == o.x && y == o.y; }
  };

  struct uint3
  {
    uint3() : x(0), y(0), z(0) {}
    uint3(uint a, uint b, uint c) : x(a), y(b), z(c) {}
    uint x, y, z;
    uint& operator[](int i)       { return (&x)[i]; }
    uint  operator[](int i) const { return (&x)[i]; }
  };

  struct uint4
  {
    uint4() : x(0), y(0), z(0), w(0) {}
    uint4(uint a, uint b, uint c, uint d) : x(a), y(b), z(c), w(d) {}
    explicit uint4(uint a) : x(a), y(a), z(a), w(a) {}
    union { struct { uint x, y, z, w; }; uint M[4]; };
    uint& operator[](int i)       { return M[i]; }
    uint  operator[](int i) const { return M[i]; }
  };

  static inline uint4 cmp_mask(bool a, bool b, bool c, bool d)
  { return uint4(a ? 0xFFFFFFFFu : 0u, b ? 0xFFFFFFFFu : 0u,
                 c ? 0xFFFFFFFFu : 0u, d ? 0xFFFFFFFFu : 0u); }
  static inline uint4 operator==(float4 a, float4 b)
  { return cmp_mask(a.x == b.x, a.y == b.y, a.z == b.z, a.w == b.w); }
  static inline uint4 operator!=(float4 a, float4 b)
  { return cmp_mask(a.x != b.x, a.y != b.y, a.z != b.z, a.w != b.w); }
  static inline uint4 operator<(float4 a, float4 b)
  { return cmp_mask(a.x < b.x, a.y < b.y, a.z < b.z, a.w < b.w); }
  static inline uint4 operator<=(float4 a, float4 b)
  { return cmp_mask(a.x <= b.x, a.y <= b.y, a.z <= b.z, a.w <= b.w); }
  static inline uint4 operator>(float4 a, float4 b)
  { return cmp_mask(a.x > b.x, a.y > b.y, a.z > b.z, a.w > b.w); }
  static inline uint4 operator>=(float4 a, float4 b)
  { return cmp_mask(a.x >= b.x, a.y >= b.y, a.z >= b.z, a.w >= b.w); }

  inline float4::float4(const int4& v)
    : x(float(v.x)), y(float(v.y)), z(float(v.z)), w(float(v.w)) {}
  inline float4::float4(const uint4& v)
    : x(float(v.x)), y(float(v.y)), z(float(v.z)), w(float(v.w)) {}
  static inline uint4 operator+(uint4 a, uint4 b) { return uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }
  static inline uint4 operator&(uint4 a, uint4 b) { return uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w); }
  static inline uint4 operator|(uint4 a, uint4 b) { return uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w); }
  static inline uint4 operator>>(uint4 a, uint s) { return uint4(a.x >> s, a.y >> s, a.z >> s, a.w >> s); }
  static inline uint4 operator<<(uint4 a, uint s) { return uint4(a.x << s, a.y << s, a.z << s, a.w << s); }

  static inline int3 to_int3(int4 v)    { return int3(v.x, v.y, v.z); }
  static inline float4 to_float4(uint4 v) { return float4(float(v.x), float(v.y), float(v.z), float(v.w)); }
  static inline float4 to_float4(int4 v)  { return float4(float(v.x), float(v.y), float(v.z), float(v.w)); }
  static inline int4  to_int4(float4 v)   { return int4(int(v.x), int(v.y), int(v.z), int(v.w)); }
  static inline uint4 to_uint4(float4 v)  { return uint4(uint(v.x), uint(v.y), uint(v.z), uint(v.w)); }

  // all/any over comparison results are expressed with explicit predicates in
  // the reference; provide the vec-mask helpers it actually calls:
  static inline bool all_of(float3 a) { return a.x != 0 && a.y != 0 && a.z != 0; }
  static inline bool all_of(float4 a) { return a.x != 0 && a.y != 0 && a.z != 0 && a.w != 0; }

  // ---------------------------------------------------------------- float4x4
  // Logically row-major; stored as 4 columns so that m_col[j] is column j.
  struct float4x4
  {
    float4x4()
    {
      m_col[0] = float4(1, 0, 0, 0);
      m_col[1] = float4(0, 1, 0, 0);
      m_col[2] = float4(0, 0, 1, 0);
      m_col[3] = float4(0, 0, 0, 1);
    }
    // 16 scalars in ROW-major order
    float4x4(float a00, float a01, float a02, float a03,
             float a10, float a11, float a12, float a13,
             float a20, float a21, float a22, float a23,
             float a30, float a31, float a32, float a33)
    {
      m_col[0] = float4(a00, a10, a20, a30);
      m_col[1] = float4(a01, a11, a21, a31);
      m_col[2] = float4(a02, a12, a22, a32);
      m_col[3] = float4(a03, a13, a23, a33);
    }
    explicit float4x4(const float rowMajor[16])
      : float4x4(rowMajor[0], rowMajor[1], rowMajor[2], rowMajor[3],
                 rowMajor[4], rowMajor[5], rowMajor[6], rowMajor[7],
                 rowMajor[8], rowMajor[9], rowMajor[10], rowMajor[11],
                 rowMajor[12], rowMajor[13], rowMajor[14], rowMajor[15]) {}

    float4 get_col(int i) const { return m_col[i]; }
    float4 col(int i) const     { return m_col[i]; }
    void   set_col(int i, float4 v) { m_col[i] = v; }
    float4 get_row(int i) const
    { return float4(m_col[0][i], m_col[1][i], m_col[2][i], m_col[3][i]); }
    void   set_row(int i, float4 v)
    { m_col[0][i] = v.x; m_col[1][i] = v.y; m_col[2][i] = v.z; m_col[3][i] = v.w; }

    float& operator()(int row, int col)       { return m_col[col][row]; }
    float  operator()(int row, int col) const { return m_col[col][row]; }

    float4 m_col[4];
  };

  static inline float4 operator*(const float4x4& m, float4 v)
  { return m.m_col[0] * v.x + m.m_col[1] * v.y + m.m_col[2] * v.z + m.m_col[3] * v.w; }
  static inline float4 mul(const float4x4& m, float4 v) { return m * v; }
  static inline float3 operator*(const float4x4& m, float3 v)
  { float4 r = m * float4(v, 1.0f); return float3(r.x, r.y, r.z); }
  static inline float3 mul4x3(const float4x4& m, float3 v) { return m * v; }
  static inline float3 mul3x3(const float4x4& m, float3 v)
  { float4 r = m * float4(v, 0.0f); return float3(r.x, r.y, r.z); }

  static inline float4x4 operator*(const float4x4& a, const float4x4& b)
  {
    float4x4 r;
    for (int j = 0; j < 4; j++)
      r.m_col[j] = a * b.m_col[j];
    return r;
  }
  static inline float4x4 mul(const float4x4& a, const float4x4& b) { return a * b; }

  static inline float4x4 transpose(const float4x4& m)
  {
    float4x4 r;
    for (int i = 0; i < 4; i++)
      r.set_row(i, m.get_col(i));
    return r;
  }

  float4x4 inverse4x4(const float4x4& m);  // defined below (general inverse)

  static inline float4x4 translate4x4(float3 t)
  {
    float4x4 m;
    m.m_col[3] = float4(t, 1.0f);
    return m;
  }
  static inline float4x4 scale4x4(float3 s)
  {
    float4x4 m;
    m(0, 0) = s.x; m(1, 1) = s.y; m(2, 2) = s.z;
    return m;
  }
  static inline float4x4 rotate4x4X(float a)
  {
    float4x4 m;
    m(1, 1) = std::cos(a); m(1, 2) = -std::sin(a);
    m(2, 1) = std::sin(a); m(2, 2) = std::cos(a);
    return m;
  }
  static inline float4x4 rotate4x4Y(float a)
  {
    float4x4 m;
    m(0, 0) = std::cos(a); m(0, 2) = std::sin(a);
    m(2, 0) = -std::sin(a); m(2, 2) = std::cos(a);
    return m;
  }
  static inline float4x4 rotate4x4Z(float a)
  {
    float4x4 m;
    m(0, 0) = std::cos(a); m(0, 1) = -std::sin(a);
    m(1, 0) = std::sin(a); m(1, 1) = std::cos(a);
    return m;
  }

  inline float4x4 inverse4x4(const float4x4& m)
  {
    // cofactor expansion on the row-major scalar array
    float a[16], inv[16];
    for (int r = 0; r < 4; r++)
      for (int c = 0; c < 4; c++)
        a[r * 4 + c] = m(r, c);

    inv[0] = a[5]*a[10]*a[15] - a[5]*a[11]*a[14] - a[9]*a[6]*a[15]
           + a[9]*a[7]*a[14] + a[13]*a[6]*a[11] - a[13]*a[7]*a[10];
    inv[4] = -a[4]*a[10]*a[15] + a[4]*a[11]*a[14] + a[8]*a[6]*a[15]
           - a[8]*a[7]*a[14] - a[12]*a[6]*a[11] + a[12]*a[7]*a[10];
    inv[8] = a[4]*a[9]*a[15] - a[4]*a[11]*a[13] - a[8]*a[5]*a[15]
           + a[8]*a[7]*a[13] + a[12]*a[5]*a[11] - a[12]*a[7]*a[9];
    inv[12] = -a[4]*a[9]*a[14] + a[4]*a[10]*a[13] + a[8]*a[5]*a[14]
            - a[8]*a[6]*a[13] - a[12]*a[5]*a[10] + a[12]*a[6]*a[9];
    inv[1] = -a[1]*a[10]*a[15] + a[1]*a[11]*a[14] + a[9]*a[2]*a[15]
           - a[9]*a[3]*a[14] - a[13]*a[2]*a[11] + a[13]*a[3]*a[10];
    inv[5] = a[0]*a[10]*a[15] - a[0]*a[11]*a[14] - a[8]*a[2]*a[15]
           + a[8]*a[3]*a[14] + a[12]*a[2]*a[11] - a[12]*a[3]*a[10];
    inv[9] = -a[0]*a[9]*a[15] + a[0]*a[11]*a[13] + a[8]*a[1]*a[15]
           - a[8]*a[3]*a[13] - a[12]*a[1]*a[11] + a[12]*a[3]*a[9];
    inv[13] = a[0]*a[9]*a[14] - a[0]*a[10]*a[13] - a[8]*a[1]*a[14]
            + a[8]*a[2]*a[13] + a[12]*a[1]*a[10] - a[12]*a[2]*a[9];
    inv[2] = a[1]*a[6]*a[15] - a[1]*a[7]*a[14] - a[5]*a[2]*a[15]
           + a[5]*a[3]*a[14] + a[13]*a[2]*a[7] - a[13]*a[3]*a[6];
    inv[6] = -a[0]*a[6]*a[15] + a[0]*a[7]*a[14] + a[4]*a[2]*a[15]
           - a[4]*a[3]*a[14] - a[12]*a[2]*a[7] + a[12]*a[3]*a[6];
    inv[10] = a[0]*a[5]*a[15] - a[0]*a[7]*a[13] - a[4]*a[1]*a[15]
            + a[4]*a[3]*a[13] + a[12]*a[1]*a[7] - a[12]*a[3]*a[5];
    inv[14] = -a[0]*a[5]*a[14] + a[0]*a[6]*a[13] + a[4]*a[1]*a[14]
            - a[4]*a[2]*a[13] - a[12]*a[1]*a[6] + a[12]*a[2]*a[5];
    inv[3] = -a[1]*a[6]*a[11] + a[1]*a[7]*a[10] + a[5]*a[2]*a[11]
           - a[5]*a[3]*a[10] - a[9]*a[2]*a[7] + a[9]*a[3]*a[6];
    inv[7] = a[0]*a[6]*a[11] - a[0]*a[7]*a[10] - a[4]*a[2]*a[11]
           + a[4]*a[3]*a[10] + a[8]*a[2]*a[7] - a[8]*a[3]*a[6];
    inv[11] = -a[0]*a[5]*a[11] + a[0]*a[7]*a[9] + a[4]*a[1]*a[11]
            - a[4]*a[3]*a[9] - a[8]*a[1]*a[7] + a[8]*a[3]*a[5];
    inv[15] = a[0]*a[5]*a[10] - a[0]*a[6]*a[9] - a[4]*a[1]*a[10]
            + a[4]*a[2]*a[9] + a[8]*a[1]*a[6] - a[8]*a[2]*a[5];

    float det = a[0]*inv[0] + a[1]*inv[4] + a[2]*inv[8] + a[3]*inv[12];
    float idet = det != 0.0f ? 1.0f / det : 0.0f;
    float4x4 r;
    for (int rr = 0; rr < 4; rr++)
      for (int cc = 0; cc < 4; cc++)
        r(rr, cc) = inv[rr * 4 + cc] * idet;
    return r;
  }

  // GL-style projection (matches hydracore3/utils/lmath.py:146)
  static inline float4x4 perspectiveMatrix(float fovYDeg, float aspect,
                                           float zNear, float zFar)
  {
    const float ymax = zNear * std::tan(fovYDeg * M_PI / 360.0f);
    const float xmax = ymax * aspect;
    const float left = -xmax, right = +xmax, bottom = -ymax, top = +ymax;
    const float t = 2.0f * zNear;
    const float t2 = right - left, t3 = top - bottom, t4 = zFar - zNear;
    float4x4 m;
    m(0, 0) = t / t2;  m(1, 1) = t / t3;
    m(0, 2) = (right + left) / t2;
    m(1, 2) = (top + bottom) / t3;
    m(2, 2) = (-zFar - zNear) / t4;
    m(3, 2) = -1.0f;
    m(2, 3) = (-t * zFar) / t4;
    m(3, 3) = 0.0f;
    return m;
  }

  // world->camera (matches hydracore3/utils/lmath.py:167)
  static inline float4x4 lookAt(float3 eye, float3 center, float3 up)
  {
    float3 z = normalize(eye - center);
    float3 x = normalize(cross(up, z));
    float3 y = normalize(cross(z, x));
    float4x4 m;
    m.set_row(0, float4(x, -dot(x, eye)));
    m.set_row(1, float4(y, -dot(y, eye)));
    m.set_row(2, float4(z, -dot(z, eye)));
    m.set_row(3, float4(0, 0, 0, 1));
    return m;
  }

  static inline float4 mul4x4x4(const float4x4& m, float4 v) { return m * v; }

  // ---------------------------------------------------------------- float3x3
  // rows-major little matrix (make_float3x3(a,b,c) sets rows a, b, c)
  struct float3x3
  {
    float3x3()
    {
      row[0] = float3(1, 0, 0); row[1] = float3(0, 1, 0); row[2] = float3(0, 0, 1);
    }
    float3 row[3];
  };
  static inline float3x3 make_float3x3(float3 a, float3 b, float3 c)
  { float3x3 m; m.row[0] = a; m.row[1] = b; m.row[2] = c; return m; }
  static inline float3x3 make_float3x3_by_columns(float3 a, float3 b, float3 c)
  {
    float3x3 m;
    m.row[0] = float3(a.x, b.x, c.x);
    m.row[1] = float3(a.y, b.y, c.y);
    m.row[2] = float3(a.z, b.z, c.z);
    return m;
  }
  static inline float3 operator*(const float3x3& m, float3 v)
  { return float3(dot(m.row[0], v), dot(m.row[1], v), dot(m.row[2], v)); }
  static inline float3 mul3x3x3(const float3x3& m, float3 v) { return m * v; }
  static inline float3x3 inverse3x3(const float3x3& m)
  {
    const float3 a = m.row[0], b = m.row[1], c = m.row[2];
    const float3 r0 = cross(b, c), r1 = cross(c, a), r2 = cross(a, b);
    const float det = dot(a, r0);
    const float id = det != 0.0f ? 1.0f / det : 0.0f;
    // inverse of row-major M is [r0 r1 r2] as COLUMNS scaled by 1/det
    return make_float3x3(float3(r0.x, r1.x, r2.x) * id,
                         float3(r0.y, r1.y, r2.y) * id,
                         float3(r0.z, r1.z, r2.z) * id);
  }
  static inline float3x3 transpose3x3(const float3x3& m)
  {
    return make_float3x3(float3(m.row[0].x, m.row[1].x, m.row[2].x),
                         float3(m.row[0].y, m.row[1].y, m.row[2].y),
                         float3(m.row[0].z, m.row[1].z, m.row[2].z));
  }

  // ------------------------------------------------------------------- Box4f
  struct Box4f
  {
    Box4f() : boxMin(+1e37f, +1e37f, +1e37f, +1e37f),
              boxMax(-1e37f, -1e37f, -1e37f, -1e37f) {}
    Box4f(float4 a, float4 b) : boxMin(a), boxMax(b) {}
    void include(float4 p) { boxMin = min(boxMin, p); boxMax = max(boxMax, p); }
    void include(const Box4f& b) { boxMin = min(boxMin, b.boxMin); boxMax = max(boxMax, b.boxMax); }
    float4 boxMin, boxMax;
  };

  // ----------------------------------------------------------------- complex
  struct complex
  {
    complex() : re(0), im(0) {}
    complex(float r) : re(r), im(0) {}
    complex(float r, float i) : re(r), im(i) {}
    float re, im;
  };
  static inline complex operator+(complex a, complex b) { return complex(a.re + b.re, a.im + b.im); }
  static inline complex operator-(complex a, complex b) { return complex(a.re - b.re, a.im - b.im); }
  static inline complex operator-(complex a)            { return complex(-a.re, -a.im); }
  static inline complex operator*(complex a, complex b)
  { return complex(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re); }
  static inline complex operator/(complex a, complex b)
  {
    float d = b.re * b.re + b.im * b.im;
    return complex((a.re * b.re + a.im * b.im) / d, (a.im * b.re - a.re * b.im) / d);
  }
  static inline complex& operator+=(complex& a, complex b) { a = a + b; return a; }
  static inline complex& operator*=(complex& a, complex b) { a = a * b; return a; }
  static inline float real(complex z) { return z.re; }
  static inline float imag(complex z) { return z.im; }
  static inline float complex_norm(complex z) { return z.re * z.re + z.im * z.im; }
  static inline float complex_abs(complex z) { return std::sqrt(complex_norm(z)); }
  static inline complex complex_sqrt(complex z)
  {
    float n = complex_abs(z);
    float t1 = std::sqrt(0.5f * (n + std::abs(z.re)));
    float t2 = 0.5f * z.im / t1;
    if (n == 0.0f) return complex(0.0f);
    if (z.re >= 0.0f) return complex(t1, t2);
    return complex(std::abs(t2), z.im >= 0.0f ? t1 : -t1);
  }
  static inline complex exp(complex z)
  {
    float e = std::exp(z.re);
    return complex(e * std::cos(z.im), e * std::sin(z.im));
  }
  static inline complex sqrt(complex z) { return complex_sqrt(z); }

  // ------------------------------------------------------------ color packing
  static inline uint color_pack_rgba(float4 c)
  {
    uint r = (uint)(clamp(c.x, 0.0f, 1.0f) * 255.0f + 0.5f);
    uint g = (uint)(clamp(c.y, 0.0f, 1.0f) * 255.0f + 0.5f);
    uint b = (uint)(clamp(c.z, 0.0f, 1.0f) * 255.0f + 0.5f);
    uint a = (uint)(clamp(c.w, 0.0f, 1.0f) * 255.0f + 0.5f);
    return r | (g << 8) | (b << 16) | (a << 24);
  }
  static inline uint color_pack_bgra(float4 c)
  { return color_pack_rgba(float4(c.z, c.y, c.x, c.w)); }
  static inline float4 color_unpack_rgba(uint c)
  {
    return float4(float(c & 0xFF), float((c >> 8) & 0xFF),
                  float((c >> 16) & 0xFF), float((c >> 24) & 0xFF)) * (1.0f / 255.0f);
  }
  static inline float4 color_unpack_bgra(uint c)
  { float4 r = color_unpack_rgba(c); return float4(r.z, r.y, r.x, r.w); }
}

#endif
