// Fused conservative Cahn-Hilliard finite-difference rhs, 2D and 3D,
// hand-written for Hopper (sm_90a): K8.
//
// Replaces the TPU kernels of pde_opt_tpu/ops/fused.py: make_ch_rhs_fd_fused
// (`kernel` :123, launched at :154) and make_ch3d_rhs_fd_fused (`kernel`
// :223, launched at :264).  Per env with its own kappa, periodic in every
// axis, with inv_a = 1/h_a and inv2_a = 1/h_a^2 rounded to f32:
//
//   lap  = sum_a ((u[+a] - 2u) + u[-a]) * inv2_a
//   m    = mu(u) - kappa * lap,   d = D(u)
//   F_a  = 0.5 (d + d[+a]) * ((m[+a] - m) * inv_a)          (2D)
//   F_a  = (0.5 (d + d[+a]) * (m[+a] - m)) * inv_a          (3D)
//   out  = sum_a (F_a - F_a[-a]) * inv_a
//
// in the JAX kernels' order of operations (the 2D and 3D bodies associate the
// face flux differently), with _rn intrinsics so that nvcc contracts no
// product and sum into one fused multiply-add, an accurate expf and IEEE
// division.  mu and D are read from coefficients in device memory, one of a
// closed set of forms (Form below): the Pallas kernel traces any elementwise
// callable; a CUDA kernel cannot.
//
// The TPU kernels roll whole VMEM blocks (pltpu.roll) and, in 3D, fold the
// N2 x N3 plane into one lane axis with seam masks; here a thread indexes
// its neighbours with a periodic wrap.  Bound: each pixel needs u within two
// cells (the Laplacian, then the face gradient of m), and the work is ~100
// f32 operations a pixel against 8 bytes of traffic, so a kernel that reads
// u once and writes out once is bound by memory traffic and by its own
// barriers.  Design:
//
// * 2D: a row march in registers, no shared memory but the coefficients and
//   no barrier in the march.  One warp walks a run of rows of one env; each
//   lane owns V adjacent columns of every row (V = 1, 2, 4, 8: the fewest
//   that put a row of up to 256 on 32 lanes, the last lane owning the rest
//   of the row).  A lane carries u of rows i .. i + 2 with the next kAhead
//   rows in flight (loads issued that many steps before their use), m and
//   d of row i, and the H faces between rows i - 1 and i.  One
//   step, for row i: m, d of row i + 1 (the W neighbours of u by warp
//   shuffle, with the wrap at the seam as the lane index); the H faces
//   between rows i and i + 1 (carried to the next step, so each is computed
//   once); the W face left of each own column (the face right of the last
//   column is the next lane's, by shuffle: each computed once); out of row
//   i.  A run of R rows reads R + 4 u rows and computes m, d of R + 2.  Runs
//   per env: as many as fill the resident warps (the occupancy API's count,
//   asked once per device and width by the caller), at most H.  At 4096
//   envs x 64^2, 55 registers leave nine blocks (36 warps) an SM and one run
//   an env; more rows in flight ran no faster, mu and D evaluated a row at
//   a time (71 registers) ran slower, and the 3D march's shape run in 2D at
//   less than half the speed (an A/B on the card, CHANGES.md).
// * 3D: a plane march.  One block walks along N1 over a run of R planes of
//   one env (the N2 x N3 planes are whole, so the in-plane wrap is an index).
//   Shared memory holds a ring of five u planes and two planes of (m, d)
//   pairs, 8-byte aligned: 9 planes (and a float of padding where N2 N3 is
//   odd), 36 KB at 32^2.  Each thread owns the fixed in-plane pixels
//   q = t, t + 256, ..., whose (j, k) it carries by increments (no integer
//   division after the block's start).  One step, for plane p:
//     - issue the copy of u plane p + 3 with cp.async (async_copy.cuh) into
//       the slot of plane p - 2, which no thread reads any more; it is
//       consumed one step later, so the load overlaps this step's arithmetic
//       (faster than synchronous copies, CHANGES.md);
//     - at each own pixel q: m, d of plane p + 1 from u planes p, p + 1,
//       p + 2 (computed once: a plane's m and d are not computed again by
//       the next step);
//     - out of plane p at q: the N1 face fluxes need m, d of planes p - 1
//       and p + 1 only at q, which this thread wrote or computes, the
//       in-plane fluxes m, d of plane p at q's neighbours (written by other
//       threads last step).  So m, d of plane p + 1 overwrite those of plane
//       p - 1 in their slot, pixel by pixel by the pixel's own thread, and
//       one barrier a step suffices.
//   The run's first step needs m, d of planes p0 - 1 and p0 (a prologue) and
//   u planes p0 - 2 .. p0 + 2, so a run reads R + 4 u planes and computes
//   R + 2 planes of m, d for R planes out.  The wrap in N1 is the plane index
//   of each copy (mod N1), so N1 = 1, 2 or 3, where a plane is its own
//   neighbour, march as any other.  Runs per env: as many as make the grid
//   one wave of resident blocks (the occupancy API's count, asked once per
//   device and plane size by the caller), at most N1;
//   at 256 envs x 32^3 the kernel's 55 registers leave four blocks an SM
//   (528 on the card), so two runs of 16 planes (512 blocks).  The kernel is
//   bound by its instruction issue, not by memory (L2-cold launches take as
//   long as L2-warm ones): capping it at 40 registers for six blocks an SM,
//   or unrolling the pixel loop, ran slower (PERF.md, section 6).
//
// Either way u is read from device memory once (plus, in 3D, four planes a
// run) and out is written once.

#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "kernel_error.cuh"

namespace {

constexpr int kThreads = 256;            // a 3D block
constexpr int kRowThreads = 128;         // a 2D block: four warps, each marching its own rows
constexpr int kAhead = 1;                 // u rows a 2D lane has in flight (2, 4: no faster)
constexpr int kMaxRowLanes = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCoeffs = 16;
constexpr int kRing = 5;                  // u planes in a 3D block's ring

// Floats before a 3D block's two planes of (m, d) pairs: the ring, rounded
// up to an even count so that each 8-byte pair is aligned (N2 N3 may be odd).
__host__ __device__ constexpr int md_offset(int n23) { return (kRing * n23 + 1) & ~1; }

// A 3D block's shared memory: the ring and the (m, d) pairs.
constexpr long long smem3d_bytes(int n23) {
  return (static_cast<long long>(md_offset(n23)) + 4LL * n23) * 4;
}

// How a coefficient function is evaluated from c[0..n).  The Python side
// (pde_opt_tpu_torch/ops/fused.py, kernel_form) keeps the same numbering.
enum Form : int {
  kPoly = 0,               // PolynomialMu: sum_i c[i] x^i by Horner's rule
  kLegendre = 1,           // LegendrePolynomialExpansion: legval(c, x)
  kLegendreScaled = 2,     // ChemicalPotentialLegendrePolynomials: legval(c, 2x - 1)
  kExpLegendreScaled = 3,  // DiffusionLegendrePolynomials: exp(legval(c, 2x - 1))
};

struct Coeff {
  const float* c;   // device memory, n floats
  int n, form;
};

struct CoeffSmem {
  float c[kMaxCoeffs];
  int n, form;
};

// legval: p_prev = 1, acc = c0 * 1, p_cur = x, acc += c1 * x, then
// p_{k+1} = ((2k+1) x p_k - k p_{k-1}) / (k+1), acc += c_{k+1} p_{k+1}.  The
// first step's division by 2 is a multiplication by 0.5: the same correctly
// rounded value, without the IEEE division's instruction sequence.
__device__ __forceinline__ float legval(const float* c, int n, float x) {
  float acc = c[0];
  if (n >= 2) {
    float p_prev = 1.0f, p_cur = x;
    acc = __fadd_rn(acc, __fmul_rn(c[1], p_cur));
    for (int k = 1; k < n - 1; ++k) {
      const float t = __fsub_rn(__fmul_rn(__fmul_rn(static_cast<float>(2 * k + 1), x), p_cur),
                                __fmul_rn(static_cast<float>(k), p_prev));
      p_prev = p_cur;
      p_cur = k == 1 ? __fmul_rn(t, 0.5f) : __fdiv_rn(t, static_cast<float>(k + 1));
      acc = __fadd_rn(acc, __fmul_rn(c[k + 1], p_cur));
    }
  }
  return acc;
}

__device__ __forceinline__ float coeff_eval(const CoeffSmem& f, float x) {
  switch (f.form) {
    case kPoly: {
      float p = f.c[f.n - 1];
      for (int k = f.n - 2; k >= 0; --k) p = __fadd_rn(__fmul_rn(p, x), f.c[k]);
      return p;
    }
    case kLegendre:
      return legval(f.c, f.n, x);
    case kLegendreScaled:
      return legval(f.c, f.n, __fsub_rn(__fmul_rn(2.0f, x), 1.0f));
    default:
      return expf(legval(f.c, f.n, __fsub_rn(__fmul_rn(2.0f, x), 1.0f)));
  }
}

__device__ __forceinline__ void load_coeffs(CoeffSmem& dst, const Coeff& src) {
  const int t = static_cast<int>(threadIdx.x);
  if (t < src.n) dst.c[t] = src.c[t];
  if (t == 0) {
    dst.n = src.n;
    dst.form = src.form;
  }
}

// ((a_plus - 2 c) + a_minus) * inv2
__device__ __forceinline__ float second_diff(float a_plus, float c, float a_minus, float inv2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(a_plus, __fmul_rn(2.0f, c)), a_minus), inv2);
}

struct Inv2d {
  float hx, hy, hx2, hy2;
};

// 2D (see the header note): the warp `warp` of the grid marches rows p0 ..
// p0 + np - 1 of one env; lane l owns the V columns l V .. l V + V - 1 of
// every row (the last lane of `lanes` may own fewer, the rest none).
template <int V>
__global__ void __launch_bounds__(kRowThreads)
ch_rhs_fd_2d_kernel(const float* __restrict__ u, const float* __restrict__ kappa,
                    float* __restrict__ out, int B, int H, int W, int R, int runs, int lanes,
                    bool vec, Coeff mu_g, Coeff d_g, Inv2d inv) {
  __shared__ CoeffSmem mu, dd;
  load_coeffs(mu, mu_g);
  load_coeffs(dd, d_g);
  __syncthreads();
  const int warp = static_cast<int>(blockIdx.x) * (kRowThreads / 32) +
                   static_cast<int>(threadIdx.x) / 32;
  if (warp >= B * runs) return;
  const int env = warp / runs;
  const int p0 = (warp - env * runs) * R;               // first row of the run
  const int np = H - p0 < R ? H - p0 : R;               // rows of this run
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int c0 = lane * V;
  const int nown = lane >= lanes ? 0 : (W - c0 < V ? W - c0 : V);   // columns owned
  // The lanes that own the columns right of this lane's last and left of its
  // first, with the periodic wrap.
  const int src_r = lane + 1 >= lanes ? 0 : lane + 1;
  const int src_l = lane == 0 ? lanes - 1 : lane - 1;
  const float* ue = u + static_cast<size_t>(env) * H * W + c0;
  float* oe = out + static_cast<size_t>(env) * H * W + c0;
  const float kap = kappa[env];

  // Row r (0 <= r < H) at this lane's columns; zeros where it owns none.
  auto load_row = [&](int r, float (&x)[V]) {
    const float* p = ue + static_cast<size_t>(r) * W;
    if (vec && nown == V) {
      if constexpr (V == 1) {
        x[0] = p[0];
      } else if constexpr (V == 2) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        x[0] = q.x;
        x[1] = q.y;
      } else {
#pragma unroll
        for (int v = 0; v < V; v += 4) {
          const float4 q = *reinterpret_cast<const float4*>(p + v);
          x[v] = q.x;
          x[v + 1] = q.y;
          x[v + 2] = q.z;
          x[v + 3] = q.w;
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = v < nown ? p[v] : 0.f;
    }
  };
  // The value at the column right of this lane's last column (lane src_r's
  // first) and left of its first (lane src_l's last).  Every lane calls them.
  auto right_of = [&](const float (&x)[V]) { return __shfl_sync(kFullMask, x[0], src_r); };
  auto left_of = [&](const float (&x)[V]) {
    float last = x[0];
#pragma unroll
    for (int v = 1; v < V; ++v) last = v < nown ? x[v] : last;
    return __shfl_sync(kFullMask, last, src_l);
  };
  // The neighbours of column v, given the halo values xl, xr.
  auto left = [&](const float (&x)[V], int v, float xl) {
    return v > 0 ? x[v > 0 ? v - 1 : 0] : xl;
  };
  auto right = [&](const float (&x)[V], int v, float xr) {
    return v + 1 < nown ? x[v + 1 < V ? v + 1 : v] : xr;
  };

  // m and d of the row whose u is b, between rows a (above) and c (below).
  auto m_d = [&](const float (&a)[V], const float (&b)[V], const float (&c)[V], float (&m)[V],
                 float (&d)[V]) {
    const float bl = left_of(b), br = right_of(b);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float ctr = b[v];
      const float lap = __fadd_rn(second_diff(c[v], ctr, a[v], inv.hx2),
                                  second_diff(right(b, v, br), ctr, left(b, v, bl), inv.hy2));
      m[v] = __fsub_rn(coeff_eval(mu, ctr), __fmul_rn(kap, lap));
      d[v] = coeff_eval(dd, ctr);
    }
  };
  // The face flux 0.5 (d_a + d_b) ((m_b - m_a) iv) between cells a and b
  // (b = a + 1 along the axis), in the JAX 2D kernel's association.
  auto flux = [](float ma, float da, float mb, float db, float iv) {
    return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(da, db)), __fmul_rn(__fsub_rn(mb, ma), iv));
  };

  // The march: u rows i, i + 1, i + 2 in ua, ub, uc and the next kAhead
  // rows in flight (ahead[k] is row i + 3 + k; the last is loaded at the
  // step's start); m, d of row i in mc, dc; the faces between rows i - 1 and
  // i in fxp.  Rows past p0 + np + 1 are not loaded.
  auto wrap = [&](int r) { return r >= H ? r - H : r; };
  int g = p0 + 2 * H - 2;                               // row p0 - 2, kept in [0, H)
  while (g >= H) g -= H;
  float ua[V], ub[V], uc[V], ahead[kAhead][V] = {}, mc[V], dc[V], mn[V], dn[V], fxp[V];
  load_row(g, ua);                                      // row p0 - 2
  load_row(g = wrap(g + 1), ub);                        // p0 - 1
  load_row(g = wrap(g + 1), uc);                        // p0
  load_row(g = wrap(g + 1), ahead[0]);                  // p0 + 1
  m_d(ua, ub, uc, mn, dn);                              // m, d of row p0 - 1
  m_d(ub, uc, ahead[0], mc, dc);                        // m, d of row p0
#pragma unroll
  for (int v = 0; v < V; ++v) {
    fxp[v] = flux(mn[v], dn[v], mc[v], dc[v], inv.hx);
    ua[v] = uc[v];                                      // row p0
    ub[v] = ahead[0][v];                                // p0 + 1
  }
  load_row(g = wrap(g + 1), uc);                        // p0 + 2
#pragma unroll
  for (int k = 0; k + 1 < kAhead; ++k)                  // p0 + 3 + k
    if (k + 2 <= np) load_row(g = wrap(g + 1), ahead[k]);
  for (int i = 0; i < np; ++i) {
    if (i + kAhead + 1 <= np) load_row(g = wrap(g + 1), ahead[kAhead - 1]);
    m_d(ua, ub, uc, mn, dn);                            // row p0 + i + 1
    // The faces left of each own column of row p0 + i, and the one right of
    // the last (lane src_r's first left face): each face computed once.
    const float ml = left_of(mc), dl = left_of(dc);
    float fyl[V], o[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      fyl[v] = flux(left(mc, v, ml), left(dc, v, dl), mc[v], dc[v], inv.hy);
    const float fyr = right_of(fyl);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float fx = flux(mc[v], dc[v], mn[v], dn[v], inv.hx);
      const float gx = __fmul_rn(__fsub_rn(fx, fxp[v]), inv.hx);
      const float gy = __fmul_rn(__fsub_rn(right(fyl, v, fyr), fyl[v]), inv.hy);
      o[v] = __fadd_rn(gx, gy);
      fxp[v] = fx;
      mc[v] = mn[v];
      dc[v] = dn[v];
      ua[v] = ub[v];
      ub[v] = uc[v];
      uc[v] = ahead[0][v];
#pragma unroll
      for (int k = 0; k + 1 < kAhead; ++k) ahead[k][v] = ahead[k + 1][v];
    }
    float* po = oe + static_cast<size_t>(p0 + i) * W;
    if (vec && nown == V) {
      if constexpr (V == 1) {
        po[0] = o[0];
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(po) = make_float2(o[0], o[1]);
      } else {
#pragma unroll
        for (int v = 0; v < V; v += 4)
          *reinterpret_cast<float4*>(po + v) = make_float4(o[v], o[v + 1], o[v + 2], o[v + 3]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < nown) po[v] = o[v];
    }
  }
}

struct Inv3d {
  float h[3], h2[3];
};

// The face flux (0.5 (d_a + d_b) (m_b - m_a)) iv between cells a and b along
// an axis (b = a + 1), in the JAX 3D kernel's association.
__device__ __forceinline__ float flux3(float ma, float da, float mb, float db, float iv) {
  return __fmul_rn(__fmul_rn(__fmul_rn(0.5f, __fadd_rn(da, db)), __fsub_rn(mb, ma)), iv);
}

// Queue the copy of one N2 x N3 plane into shared memory: 16-byte copies when
// the planes are 16-byte aligned (vec), else 4-byte ones.
__device__ __forceinline__ void copy_plane(float* dst, const float* src, int n23, bool vec) {
  const int t = static_cast<int>(threadIdx.x);
  if (vec) {
    for (int c = 4 * t; c < n23; c += 4 * kThreads) cp_async16(dst + c, src + c);
  } else {
    for (int c = t; c < n23; c += kThreads) cp_async4(dst + c, src + c);
  }
}

__device__ __forceinline__ int wrap_ring(int s) { return s >= kRing ? s - kRing : s; }

// One block marches over planes p0 .. p0 + np - 1 of one env (see the header
// note).  March position s holds u plane p0 - 2 + s (mod N1) in ring slot
// s mod kRing; m and d of plane p0 + i sit in slot i mod 2 (plane p0 - 1 in
// slot 1) as (m, d) pairs, one 8-byte load a neighbour.
__global__ void __launch_bounds__(kThreads)
ch_rhs_fd_3d_kernel(const float* __restrict__ u, const float* __restrict__ kappa,
                    float* __restrict__ out, int N1, int N2, int N3, int R, int runs,
                    bool vec, Coeff mu_g, Coeff d_g, Inv3d inv) {
  extern __shared__ float4 smem3[];
  __shared__ CoeffSmem mu, dd;
  const int n23 = N2 * N3;
  const int env = blockIdx.x / runs;
  const int p0 = (blockIdx.x - env * runs) * R;         // first plane of the run
  const int np = N1 - p0 < R ? N1 - p0 : R;             // planes of this run
  float* ring = reinterpret_cast<float*>(smem3);
  float2* md = reinterpret_cast<float2*>(ring + md_offset(n23));   // (m, d) pairs
  const float* ue = u + static_cast<size_t>(env) * N1 * n23;
  float* oe = out + (static_cast<size_t>(env) * N1 + p0) * n23;

  // The next u plane to copy, advanced with the wrap in N1.
  int g = ((p0 - 2) % N1 + N1) % N1;
  auto copy_next = [&](int slot) {
    copy_plane(ring + slot * n23, ue + static_cast<size_t>(g) * n23, n23, vec);
    g = g + 1 == N1 ? 0 : g + 1;
  };
  load_coeffs(mu, mu_g);
  load_coeffs(dd, d_g);
  for (int s = 0; s < kRing; ++s) copy_next(s);        // planes p0 - 2 .. p0 + 2
  cp_async_wait_all();
  __syncthreads();

  // This thread's first pixel and the step to its next one, by increments.
  const int t = static_cast<int>(threadIdx.x);
  const int j0 = t / N3, k0 = t - j0 * N3;
  const int dj = kThreads / N3, dk = kThreads - dj * N3;
  const int wrap2 = (N2 - 1) * N3;
  const float kap = kappa[env];

  // (m, d) at pixel q of the plane centred at ring slot sc (u planes in
  // slots sm1, sc, sp1); up/dn/rt/lf are q's in-plane neighbours.
  auto m_d = [&](int sm1, int sc, int sp1, int q, int up, int dn, int rt, int lf) {
    const float* pl = ring + sc * n23;
    const float c = pl[q];
    float lap = second_diff(ring[sp1 * n23 + q], c, ring[sm1 * n23 + q], inv.h2[0]);
    lap = __fadd_rn(lap, second_diff(pl[up], c, pl[dn], inv.h2[1]));
    lap = __fadd_rn(lap, second_diff(pl[rt], c, pl[lf], inv.h2[2]));
    return make_float2(__fsub_rn(coeff_eval(mu, c), __fmul_rn(kap, lap)), coeff_eval(dd, c));
  };
  // Calls body(q, up, dn, rt, lf) for each pixel this thread owns.
  auto for_pixels = [&](auto body) {
    for (int q = t, j = j0, k = k0; q < n23; q += kThreads) {
      const int up = j + 1 == N2 ? q - wrap2 : q + N3, dn = j == 0 ? q + wrap2 : q - N3;
      const int rt = k + 1 == N3 ? q - (N3 - 1) : q + 1, lf = k == 0 ? q + (N3 - 1) : q - 1;
      body(q, up, dn, rt, lf);
      k += dk;
      j += dj;
      if (k >= N3) {
        k -= N3;
        ++j;
      }
    }
  };

  // Prologue: m, d of planes p0 - 1 (at own pixels only) and p0.
  for_pixels([&](int q, int up, int dn, int rt, int lf) {
    md[n23 + q] = m_d(0, 1, 2, q, up, dn, rt, lf);
    md[q] = m_d(1, 2, 3, q, up, dn, rt, lf);
  });
  __syncthreads();

  for (int i = 0, s0 = 0; i < np; ++i, s0 = wrap_ring(s0 + 1)) {
    // s0 is the slot of march position i (plane p - 2): free since the last
    // barrier; the copy lands there for the next step.
    if (i + 1 < np) copy_next(s0);
    const float2* mdc = md + (i & 1) * n23;              // plane p
    float2* mdx = md + ((i + 1) & 1) * n23;              // plane p - 1, then p + 1
    const int sa = wrap_ring(s0 + 2), sb = wrap_ring(s0 + 3), sc = wrap_ring(s0 + 4);
    for_pixels([&](int q, int up, int dn, int rt, int lf) {
      const float2 b = m_d(sa, sb, sc, q, up, dn, rt, lf);  // plane p + 1
      const float2 a = mdx[q];                              // plane p - 1
      mdx[q] = b;
      const float2 c = mdc[q], n_up = mdc[up], n_dn = mdc[dn], n_rt = mdc[rt], n_lf = mdc[lf];
      float acc = __fmul_rn(__fsub_rn(flux3(c.x, c.y, b.x, b.y, inv.h[0]),
                                      flux3(a.x, a.y, c.x, c.y, inv.h[0])), inv.h[0]);
      acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(flux3(c.x, c.y, n_up.x, n_up.y, inv.h[1]),
                                               flux3(n_dn.x, n_dn.y, c.x, c.y, inv.h[1])),
                                     inv.h[1]));
      acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(flux3(c.x, c.y, n_rt.x, n_rt.y, inv.h[2]),
                                               flux3(n_lf.x, n_lf.y, c.x, c.y, inv.h[2])),
                                     inv.h[2]));
      oe[static_cast<size_t>(i) * n23 + q] = acc;
    });
    cp_async_wait_all();
    __syncthreads();
  }
}

bool bad_coeff(const Coeff& f) {
  return f.c == nullptr || f.n < 1 || f.n > kMaxCoeffs || f.form < kPoly ||
         f.form > kExpLegendreScaled;
}

cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Columns a lane owns in 2D for a width W: 1, 2, 4 or 8, the fewest that
// fit a row on one warp; 0 for a width above 256.
int cols_per_lane(int W) {
  for (int v = 1; v <= 8; v *= 2)
    if (W <= v * kMaxRowLanes) return v;
  return 0;
}

template <int V>
cudaError_t resident_2d(int* warps) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ch_rhs_fd_2d_kernel<V>,
                                                           kRowThreads, 0)) != cudaSuccess)
    return err;
  *warps = sms * (per_sm > 0 ? per_sm : 1) * (kRowThreads / 32);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The K8 (2D) warps that the current device holds at once for rows of width
// W, into *resident: the caller asks once per device and width and passes
// the count to every launch.
int ch_rhs_fd_2d_resident(int W, int* resident) {
  switch (cols_per_lane(W)) {
    case 1: return static_cast<int>(resident_2d<1>(resident));
    case 2: return static_cast<int>(resident_2d<2>(resident));
    case 4: return static_cast<int>(resident_2d<4>(resident));
    case 8: return static_cast<int>(resident_2d<8>(resident));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K8 (2D) on `stream`: u and out (B, H, W) f32, kappa (B,) f32;
// mu and D each as (coefficients in device memory, count, form); resident
// as ch_rhs_fd_2d_resident gives it for this device and width.  One warp
// marches a run of rows of one env: as many runs an env as fill the
// resident warps, at most H.  Returns a cudaError_t value, 0 on success
// (cudaErrorInvalidValue for shapes or coefficients it does not take: W
// above 256).
int ch_rhs_fd_2d_launch(const float* u, const float* kappa, float* out, int B, int H, int W,
                        const float* mu_c, int mu_n, int mu_form, const float* d_c, int d_n,
                        int d_form, float inv_hx, float inv_hy, float inv_hx2, float inv_hy2,
                        int resident, void* stream) {
  const Coeff mu{mu_c, mu_n, mu_form}, dd{d_c, d_n, d_form};
  const int V = cols_per_lane(W);
  if (B < 1 || H < 1 || W < 1 || V == 0 || resident < 1 || bad_coeff(mu) || bad_coeff(dd))
    return static_cast<int>(cudaErrorInvalidValue);
  long long runs = resident / B;
  runs = runs < 1 ? 1 : (runs > H ? H : runs);
  const int R = static_cast<int>((H + runs - 1) / runs);
  runs = (H + R - 1) / R;                               // no empty run
  const long long warps = static_cast<long long>(B) * runs;
  const long long grid = (warps + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = (W + V - 1) / V;
  const bool vec = W % V == 0 && reinterpret_cast<uintptr_t>(u) % (4 * V) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * V) == 0;
  const Inv2d inv{inv_hx, inv_hy, inv_hx2, inv_hy2};
  const auto st = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(grid), r = static_cast<int>(runs);
  switch (V) {
    case 1: {
      const auto kernel = ch_rhs_fd_2d_kernel<1>;
      kernel<<<g, kRowThreads, 0, st>>>(u, kappa, out, B, H, W, R, r, lanes, vec, mu, dd, inv);
      break;
    }
    case 2: {
      const auto kernel = ch_rhs_fd_2d_kernel<2>;
      kernel<<<g, kRowThreads, 0, st>>>(u, kappa, out, B, H, W, R, r, lanes, vec, mu, dd, inv);
      break;
    }
    case 4: {
      const auto kernel = ch_rhs_fd_2d_kernel<4>;
      kernel<<<g, kRowThreads, 0, st>>>(u, kappa, out, B, H, W, R, r, lanes, vec, mu, dd, inv);
      break;
    }
    default: {
      const auto kernel = ch_rhs_fd_2d_kernel<8>;
      kernel<<<g, kRowThreads, 0, st>>>(u, kappa, out, B, H, W, R, r, lanes, vec, mu, dd, inv);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The K8 (3D) blocks with N2 x N3 planes that the current device holds at
// once, into *resident.  Also allows the kernel all the dynamic shared memory
// a block can opt in to (beside its static coefficients), so that a launch
// needs no attribute call: the caller asks once per device and plane size
// and passes the count to every launch.
int ch_rhs_fd_3d_resident(int N2, int N3, int* resident) {
  if (N2 < 1 || N3 < 1) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, ch_rhs_fd_3d_kernel)) != cudaSuccess)
    return static_cast<int>(err);
  const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
  const long long bytes = smem3d_bytes(N2 * N3);
  if (bytes > dynamic) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = allow_smem(ch_rhs_fd_3d_kernel, dynamic)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ch_rhs_fd_3d_kernel, kThreads,
                                                           static_cast<size_t>(bytes))) !=
          cudaSuccess)
    return static_cast<int>(err);
  *resident = sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(cudaSuccess);
}

// Launches K8 (3D) on `stream`: u and out (B, N1, N2, N3) f32, kappa (B,)
// f32; inv and inv2 the three inverse spacings and their squares; resident
// as ch_rhs_fd_3d_resident gives it for this device and plane.  Each env is
// cut into runs of R planes: as many runs as fill one wave of resident
// blocks, at most N1 (one run an env once the envs fill a wave).
int ch_rhs_fd_3d_launch(const float* u, const float* kappa, float* out, int B, int N1, int N2,
                        int N3, const float* mu_c, int mu_n, int mu_form, const float* d_c,
                        int d_n, int d_form, const float* inv, const float* inv2, int resident,
                        void* stream) {
  const Coeff mu{mu_c, mu_n, mu_form}, dd{d_c, d_n, d_form};
  if (B < 1 || N1 < 1 || N2 < 1 || N3 < 1 || resident < 1 || bad_coeff(mu) || bad_coeff(dd))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = smem3d_bytes(N2 * N3);
  long long runs = resident / B;
  runs = runs < 1 ? 1 : (runs > N1 ? N1 : runs);
  const int R = static_cast<int>((N1 + runs - 1) / runs);
  runs = (N1 + R - 1) / R;                              // no empty run
  if (static_cast<long long>(B) * runs > 0x7fffffffLL || bytes > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Inv3d iv;
  for (int a = 0; a < 3; ++a) {
    iv.h[a] = inv[a];
    iv.h2[a] = inv2[a];
  }
  const bool vec = (N2 * N3) % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  ch_rhs_fd_3d_kernel<<<static_cast<int>(B * runs), kThreads, static_cast<int>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(
      u, kappa, out, N1, N2, N3, R, static_cast<int>(runs), vec, mu, dd, iv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
