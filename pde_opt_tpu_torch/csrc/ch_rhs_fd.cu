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
// barriers.  Design, simple first:
//
// * 2D: one block per env; u, m and d live in shared memory (48 KB at 64^2).
//   Phases: load u; compute m and d per pixel; compute fluxes and
//   divergence (each face flux is computed by both pixels beside it, rather
//   than stored).
// * 3D: one block per slab of P planes along N1 of one env; u with a
//   2-plane halo each side, m and d with a 1-plane halo (the N2 x N3 planes
//   are whole, so the in-plane wrap is an index): 80 KB at 32^3 with P = 4.
//   The halo planes' m and d are computed by both slabs beside them.
//
// Either way u is read from device memory once (plus the halo) and out is
// written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCoeffs = 16;
constexpr int kMaxPlanes = 4;   // 3D slab depth when shared memory allows

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
// p_{k+1} = ((2k+1) x p_k - k p_{k-1}) / (k+1), acc += c_{k+1} p_{k+1}.
__device__ __forceinline__ float legval(const float* c, int n, float x) {
  float acc = c[0];
  if (n >= 2) {
    float p_prev = 1.0f, p_cur = x;
    acc = __fadd_rn(acc, __fmul_rn(c[1], p_cur));
    for (int k = 1; k < n - 1; ++k) {
      const float t = __fsub_rn(__fmul_rn(__fmul_rn(static_cast<float>(2 * k + 1), x), p_cur),
                                __fmul_rn(static_cast<float>(k), p_prev));
      p_prev = p_cur;
      p_cur = __fdiv_rn(t, static_cast<float>(k + 1));
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

__global__ void __launch_bounds__(kThreads)
ch_rhs_fd_2d_kernel(const float* __restrict__ u, const float* __restrict__ kappa,
                    float* __restrict__ out, int H, int W, Coeff mu_g, Coeff d_g, Inv2d inv) {
  extern __shared__ float smem[];
  __shared__ CoeffSmem mu, dd;
  const int n = H * W;
  float* us = smem;
  float* ms = us + n;
  float* ds = ms + n;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;

  load_coeffs(mu, mu_g);
  load_coeffs(dd, d_g);
  for (int p = threadIdx.x; p < n; p += kThreads) us[p] = u[off + p];
  __syncthreads();

  const float kap = kappa[blockIdx.x];
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int i = p / W, j = p - i * W;
    const int ip = i + 1 == H ? 0 : i + 1, im = i == 0 ? H - 1 : i - 1;
    const int jp = j + 1 == W ? 0 : j + 1, jm = j == 0 ? W - 1 : j - 1;
    const float c = us[p];
    const float lap = __fadd_rn(second_diff(us[ip * W + j], c, us[im * W + j], inv.hx2),
                                second_diff(us[i * W + jp], c, us[i * W + jm], inv.hy2));
    ms[p] = __fsub_rn(coeff_eval(mu, c), __fmul_rn(kap, lap));
    ds[p] = coeff_eval(dd, c);
  }
  __syncthreads();

  // F at the face between cells a and b (b = a + 1 along the axis).
  auto flux = [&](int a, int b, float iv) {
    return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(ds[a], ds[b])),
                     __fmul_rn(__fsub_rn(ms[b], ms[a]), iv));
  };
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int i = p / W, j = p - i * W;
    const int ip = i + 1 == H ? 0 : i + 1, im = i == 0 ? H - 1 : i - 1;
    const int jp = j + 1 == W ? 0 : j + 1, jm = j == 0 ? W - 1 : j - 1;
    const float gx = __fmul_rn(__fsub_rn(flux(p, ip * W + j, inv.hx),
                                         flux(im * W + j, p, inv.hx)), inv.hx);
    const float gy = __fmul_rn(__fsub_rn(flux(p, i * W + jp, inv.hy),
                                         flux(i * W + jm, p, inv.hy)), inv.hy);
    out[off + p] = __fadd_rn(gx, gy);
  }
}

struct Inv3d {
  float h[3], h2[3];
};

// Shared floats of a 3D block with slab depth P: u on P + 4 planes, m and d
// on P + 2 planes each.
__host__ __device__ __forceinline__ int smem_floats_3d(int P, int n23) {
  return (3 * P + 8) * n23;
}

__global__ void __launch_bounds__(kThreads)
ch_rhs_fd_3d_kernel(const float* __restrict__ u, const float* __restrict__ kappa,
                    float* __restrict__ out, int N1, int N2, int N3, int P, int slabs,
                    Coeff mu_g, Coeff d_g, Inv3d inv) {
  extern __shared__ float smem[];
  __shared__ CoeffSmem mu, dd;
  const int n23 = N2 * N3;
  const int env = blockIdx.x / slabs;
  const int p0 = (blockIdx.x - env * slabs) * P;        // first plane of the slab
  const int np = min(P, N1 - p0);                       // planes of this slab
  float* us = smem;                                     // planes p0-2 .. p0+np+1
  float* ms = us + (P + 4) * n23;                       // planes p0-1 .. p0+np
  float* ds = ms + (P + 2) * n23;
  const size_t off = static_cast<size_t>(env) * N1 * n23;

  load_coeffs(mu, mu_g);
  load_coeffs(dd, d_g);
  for (int e = threadIdx.x; e < (np + 4) * n23; e += kThreads) {
    const int l = e / n23, q = e - l * n23;
    const int g = ((p0 - 2 + l) % N1 + N1) % N1;
    us[e] = u[off + static_cast<size_t>(g) * n23 + q];
  }
  __syncthreads();

  const float kap = kappa[env];
  for (int e = threadIdx.x; e < (np + 2) * n23; e += kThreads) {
    const int m = e / n23, q = e - m * n23;
    const int j = q / N3, k = q - j * N3;
    const int jp = j + 1 == N2 ? 0 : j + 1, jm = j == 0 ? N2 - 1 : j - 1;
    const int kp = k + 1 == N3 ? 0 : k + 1, km = k == 0 ? N3 - 1 : k - 1;
    const float* pl = us + (m + 1) * n23;               // u plane of this m plane
    const float c = pl[q];
    float lap = second_diff(pl[q + n23], c, pl[q - n23], inv.h2[0]);
    lap = __fadd_rn(lap, second_diff(pl[jp * N3 + k], c, pl[jm * N3 + k], inv.h2[1]));
    lap = __fadd_rn(lap, second_diff(pl[j * N3 + kp], c, pl[j * N3 + km], inv.h2[2]));
    ms[e] = __fsub_rn(coeff_eval(mu, c), __fmul_rn(kap, lap));
    ds[e] = coeff_eval(dd, c);
  }
  __syncthreads();

  auto flux = [&](int a, int b, float iv) {
    return __fmul_rn(__fmul_rn(__fmul_rn(0.5f, __fadd_rn(ds[a], ds[b])),
                               __fsub_rn(ms[b], ms[a])), iv);
  };
  for (int e = threadIdx.x; e < np * n23; e += kThreads) {
    const int l = e / n23, q = e - l * n23;
    const int j = q / N3, k = q - j * N3;
    const int jp = j + 1 == N2 ? 0 : j + 1, jm = j == 0 ? N2 - 1 : j - 1;
    const int kp = k + 1 == N3 ? 0 : k + 1, km = k == 0 ? N3 - 1 : k - 1;
    const int base = (l + 1) * n23;                     // this plane in ms, ds
    const int c = base + q;
    float acc = __fmul_rn(__fsub_rn(flux(c, c + n23, inv.h[0]),
                                    flux(c - n23, c, inv.h[0])), inv.h[0]);
    acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(flux(c, base + jp * N3 + k, inv.h[1]),
                                             flux(base + jm * N3 + k, c, inv.h[1])),
                                   inv.h[1]));
    acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(flux(c, base + j * N3 + kp, inv.h[2]),
                                             flux(base + j * N3 + km, c, inv.h[2])),
                                   inv.h[2]));
    out[off + static_cast<size_t>(p0 + l) * n23 + q] = acc;
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

}  // namespace

extern "C" {

// Launches K8 (2D) on `stream`: u and out (B, H, W) f32, kappa (B,) f32;
// mu and D each as (coefficients in device memory, count, form).  Returns a
// cudaError_t value, 0 on success (cudaErrorInvalidValue for shapes or
// coefficients it does not take).
int ch_rhs_fd_2d_launch(const float* u, const float* kappa, float* out, int B, int H, int W,
                        const float* mu_c, int mu_n, int mu_form, const float* d_c, int d_n,
                        int d_form, float inv_hx, float inv_hy, float inv_hx2, float inv_hy2,
                        void* stream) {
  const Coeff mu{mu_c, mu_n, mu_form}, dd{d_c, d_n, d_form};
  if (B < 1 || H < 1 || W < 1 || bad_coeff(mu) || bad_coeff(dd))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = 3LL * H * W * static_cast<long long>(sizeof(float));
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(ch_rhs_fd_2d_kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Inv2d inv{inv_hx, inv_hy, inv_hx2, inv_hy2};
  ch_rhs_fd_2d_kernel<<<B, kThreads, static_cast<int>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(u, kappa, out, H, W, mu, dd, inv);
  return static_cast<int>(cudaGetLastError());
}

// Launches K8 (3D) on `stream`: u and out (B, N1, N2, N3) f32, kappa (B,)
// f32; inv and inv2 the three inverse spacings and their squares.  The slab
// depth is the largest P <= 4 (and <= N1) whose shared memory fits.
int ch_rhs_fd_3d_launch(const float* u, const float* kappa, float* out, int B, int N1, int N2,
                        int N3, const float* mu_c, int mu_n, int mu_form, const float* d_c,
                        int d_n, int d_form, const float* inv, const float* inv2,
                        void* stream) {
  const Coeff mu{mu_c, mu_n, mu_form}, dd{d_c, d_n, d_form};
  if (B < 1 || N1 < 1 || N2 < 1 || N3 < 1 || bad_coeff(mu) || bad_coeff(dd))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n23 = N2 * N3;
  int P = N1 < kMaxPlanes ? N1 : kMaxPlanes;
  while (P > 1 && static_cast<long long>(smem_floats_3d(P, n23)) * 4 > optin) --P;
  const long long bytes = static_cast<long long>(smem_floats_3d(P, n23)) * 4;
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (N1 + P - 1) / P;
  if (static_cast<long long>(B) * slabs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(ch_rhs_fd_3d_kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Inv3d iv;
  for (int a = 0; a < 3; ++a) {
    iv.h[a] = inv[a];
    iv.h2[a] = inv2[a];
  }
  ch_rhs_fd_3d_kernel<<<B * slabs, kThreads, static_cast<int>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(u, kappa, out, N1, N2, N3, P,
                                                             slabs, mu, dd, iv);
  return static_cast<int>(cudaGetLastError());
}

const char* ch_rhs_fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
