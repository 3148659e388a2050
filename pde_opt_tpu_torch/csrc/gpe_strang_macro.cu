// Fused midpoint-Strang Gross-Pitaevskii macro-step on the cas (Hartley)
// transform, hand-written for Hopper (sm_90a), with the optional RL env
// epilogue: K5.
//
// Replaces the TPU kernels of pde_opt_tpu/ops/gpe_cas.py,
// make_gpe_strang_cas_macro (`kernel` launched at :371 and `kernel_ep` at
// :393, both around `_evolve_packed` :194).  Per env, psi = pr + i*pi:
//
//   prop(c, s):  rh = fwd(pr), ih = fwd(pi)
//                pr = inv(c*rh + s*ih),  pi = inv(c*ih - s*rh)
//   b_phase:     th = dt * (V + ctrl + g*(pr^2 + pi^2))
//                pr, pi = cos(th)*pr + sin(th)*pi, cos(th)*pi - sin(th)*pr
//   renorm:      pr, pi *= 1/sqrt(sum(pr^2 + pi^2) * dx^2)     (full f32)
//
//   prop(cosH, sinH)
//   n_steps - 1 times: b_phase; prop(cosF, sinF); renorm
//   b_phase; prop(cosH, sinH); renorm
//
// cosF/sinF (cosH/sinH) are cos/sin of the kinetic symbol (2*pi*k)^2/2 times
// dt (dt/2), even in each frequency axis, so the cas transform diagonalises
// them.  With phase_poly the B-phase cos/sin are the JAX kernel's degree-6/7
// Taylor polynomials; otherwise sincosf.  With bf16 matrices each transform's
// operand and intermediate are rounded to bf16; products accumulate in f32;
// the per-env norm is a full-f32 block reduction (bf16 would leave ~4e-3 of
// norm noise).  The epilogue emits [sum(w*rho), sum(rho), n_finite] over
// finite pixels of rho = pr^2 + pi^2 and the uint8 observation
// clip(rho*scale, 0, 255).
//
// Bound: each propagation is 4 transforms = 8*H*W*(H+W) FLOPs, n_steps + 1
// of them per macro (4.2 MFLOP each at 64^2): arithmetic-bound.  Two kernels,
// picked by the matrices' type alone, as K4's:
//
// - bf16 matrices (the preset's): gpe_strang_macro_wg_kernel runs every
//   transform on the tensor cores (cas_wgmma.cuh: warpgroup wgmma m64n32k16,
//   bf16 operands, f32 accumulation, the JAX rounding sites).  pr and pi are
//   transformed independently, so each propagation runs them as pairs
//   (wg_transform2): both fields' product 1 under one barrier, then both
//   product 2, 4 barriers a propagation where four wg_transform calls take
//   8 (and ran slower).  That needs a second Z^T and T tile: eight 64 x 64
//   bf16 tiles, 64 KB; one block an SM.  pr, pi and V + ctrl live in the
//   fragment layout (16 each a thread); the phase tables and the epilogue
//   weight are read in it per use (float2 pairs).
// - f32 matrices: gpe_strang_macro_kernel, f32 FMA on the CUDA cores.  Design
//   as K1: matrices and two f32 transform tiles in 96 KB of shared memory, a
//   4 x 4 tile a thread; the four phase tables (H, W) are read per use
//   through the read-only cache (64 KB, L2-resident), not held: held, they
//   would push the thread past its register budget and spill.
//
// Both: one block of 256 threads per env at a time (grid-stride), the B phase
// and the full-f32 renorm in the same code; the state is read and written in
// its interleaved (B, H, W, 2) layout.
//
// Grids above 64 x 64 (any H and W that are multiples of 8 up to 256) run
// gpe_strang_macro_tiled_kernel at the end of this file, bf16 and f32 alike:
// an env's planes live in device memory and each transform streams 64-wide
// chunks through shared memory (cas_tiled.cuh).  The launch picks the kernel
// by grid; the 64^2 kernels are unchanged.

#include "cas_common.cuh"
#include "cas_tiled.cuh"
#include "cas_wgmma.cuh"
#include "kernel_error.cuh"

namespace {

// Shared memory of the tensor-core kernel: cas_wgmma.cuh's six tiles and a
// second Z^T and T.
constexpr int kGpeWgSmemBytes = kWgSmemBytes + 2 * kTile * static_cast<int>(sizeof(__nv_bfloat16));

struct Tables {
  const float *cosF, *sinF, *cosH, *sinH;   // (H, W) each
};

struct GpeEpilogue {
  float* stats;          // (B, 3) or nullptr for the plain macro
  unsigned char* obs;    // (B, H, W)
  const float* weight;   // (H, W)
  float scale;
};

// One kinetic propagation of (pr, pi) by the phase tables (c, s).
__device__ __forceinline__ void propagate(float pr[4][4], float pi[4][4],
                                          const float* __restrict__ c_tab,
                                          const float* __restrict__ s_tab,
                                          const Tiles& sm, int H, int W, int ty4,
                                          int tx4, bool own, bool rnd) {
  if (own) store_tile(sm.zs, ty4, tx4, pr, rnd);
  transform(sm.zs, sm.ts, sm.ch, sm.cw, H, W, ty4, tx4, rnd, pr);     // rh
  if (own) store_tile(sm.zs, ty4, tx4, pi, rnd);
  transform(sm.zs, sm.ts, sm.ch, sm.cw, H, W, ty4, tx4, rnd, pi);     // ih
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (ty4 + i) * W + tx4 + j;
        const float c = __ldg(c_tab + o), s = __ldg(s_tab + o);
        const float rh = pr[i][j], ih = pi[i][j];
        pr[i][j] = c * rh + s * ih;
        pi[i][j] = c * ih - s * rh;
      }
    store_tile(sm.zs, ty4, tx4, pr, rnd);
  }
  transform(sm.zs, sm.ts, sm.ich, sm.icw, H, W, ty4, tx4, rnd, pr);
  if (own) store_tile(sm.zs, ty4, tx4, pi, rnd);
  transform(sm.zs, sm.ts, sm.ich, sm.icw, H, W, ty4, tx4, rnd, pi);
}

// The pointwise B phase exp(-i*th), th = dt*(vc + g*|psi|^2).
__device__ __forceinline__ void b_phase(float pr[4][4], float pi[4][4],
                                        const float vc[4][4], float g, float dt,
                                        bool poly) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = pr[i][j], m = pi[i][j];
      const float th = dt * (vc[i][j] + g * (r * r + m * m));
      float c, s;
      if (poly) {
        const float t2 = th * th;
        c = 1.0f + t2 * (-0.5f + t2 * (static_cast<float>(1.0 / 24.0) +
                                       t2 * static_cast<float>(-1.0 / 720.0)));
        s = th * (1.0f + t2 * (static_cast<float>(-1.0 / 6.0) +
                               t2 * (static_cast<float>(1.0 / 120.0) +
                                     t2 * static_cast<float>(-1.0 / 5040.0))));
      } else {
        sincosf(th, &s, &c);
      }
      pr[i][j] = c * r + s * m;
      pi[i][j] = c * m - s * r;
    }
}

// Scale the env to unit L2 norm from each thread's share n2 of sum(pr^2 +
// pi^2): a full-f32 block sum, broadcast to all.
__device__ __forceinline__ void renorm(float pr[4][4], float pi[4][4], float n2,
                                       float (*red)[3], float dx2, int tid) {
  float unused1 = 0.f, unused2 = 0.f;
  block_sum3(n2, unused1, unused2, red, tid);
  __syncthreads();                       // red is read by all: free it again
  const float scale = 1.0f / sqrtf(n2 * dx2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pr[i][j] *= scale;
      pi[i][j] *= scale;
    }
}

// This thread's share of sum(pr^2 + pi^2): its 4 x 4 tile (FMA kernel) ...
__device__ __forceinline__ float norm2_tile(const float pr[4][4], const float pi[4][4],
                                            bool own) {
  float n2 = 0.f;
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) n2 += pr[i][j] * pr[i][j] + pi[i][j] * pi[i][j];
  }
  return n2;
}

// ... or the pixels of its fragment that lie in the grid (tensor-core kernel).
__device__ __forceinline__ float norm2_frag(const float pr[4][4], const float pi[4][4],
                                            const Own& o, int H, int W) {
  float n2 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (o.valid(j, hi, H, W))
#pragma unroll
        for (int e = 2 * hi; e < 2 * hi + 2; ++e) n2 += pr[j][e] * pr[j][e] + pi[j][e] * pi[j][e];
  return n2;
}

__global__ void __launch_bounds__(kThreads)
gpe_strang_macro_kernel(const float* __restrict__ y_in, const float* __restrict__ ctrl,
                        const float* __restrict__ V, const float* __restrict__ g_ch,
                        const float* __restrict__ g_cw, const float* __restrict__ g_ich,
                        const float* __restrict__ g_icw, Tables tab,
                        float* __restrict__ y_out, int B, int H, int W, int n_steps,
                        float g, float dt, float dx2, bool poly, GpeEpilogue ep) {
  constexpr bool rnd = false;   // f32 matrices: bf16 runs gpe_strang_macro_wg_kernel
  extern __shared__ float4 smem4[];
  const Tiles sm = carve_tiles(reinterpret_cast<float*>(smem4));
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const int ty4 = (tid / 16) * 4;        // first row (H axis) this thread owns
  const int tx4 = (tid % 16) * 4;        // first column (W axis)
  const bool own = ty4 < H && tx4 < W;
  load_mats(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    float pr[4][4], pi[4][4], vc[4][4];
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (ty4 + i) * W + tx4;
        const float4 a = *reinterpret_cast<const float4*>(y_in + 2 * (off + o));
        const float4 b = *reinterpret_cast<const float4*>(y_in + 2 * (off + o) + 4);
        pr[i][0] = a.x; pi[i][0] = a.y; pr[i][1] = a.z; pi[i][1] = a.w;
        pr[i][2] = b.x; pi[i][2] = b.y; pr[i][3] = b.z; pi[i][3] = b.w;
        const float4 v = *reinterpret_cast<const float4*>(V + o);
        const float4 q = *reinterpret_cast<const float4*>(ctrl + off + o);
        vc[i][0] = v.x + q.x;
        vc[i][1] = v.y + q.y;
        vc[i][2] = v.z + q.z;
        vc[i][3] = v.w + q.w;
      }
    }

    propagate(pr, pi, tab.cosH, tab.sinH, sm, H, W, ty4, tx4, own, rnd);
    for (int s = 0; s < n_steps - 1; ++s) {
      if (own) b_phase(pr, pi, vc, g, dt, poly);
      propagate(pr, pi, tab.cosF, tab.sinF, sm, H, W, ty4, tx4, own, rnd);
      renorm(pr, pi, norm2_tile(pr, pi, own), red, dx2, tid);
    }
    if (own) b_phase(pr, pi, vc, g, dt, poly);
    propagate(pr, pi, tab.cosH, tab.sinH, sm, H, W, ty4, tx4, own, rnd);
    renorm(pr, pi, norm2_tile(pr, pi, own), red, dx2, tid);

    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (ty4 + i) * W + tx4;
        float* dst = y_out + 2 * (off + o);
        *reinterpret_cast<float4*>(dst) = make_float4(pr[i][0], pi[i][0], pr[i][1], pi[i][1]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(pr[i][2], pi[i][2], pr[i][3], pi[i][3]);
      }
    }
    if (ep.stats == nullptr) continue;

    // ---- env epilogue (`kernel_ep`'s emit) on the register-resident state ----
    float sw = 0.f, sr = 0.f, nf = 0.f;
    if (own) {
      unsigned char* oe = ep.obs + off;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned char q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (ty4 + i) * W + tx4 + j;
          const float rho = pr[i][j] * pr[i][j] + pi[i][j] * pi[i][j];
          const bool fin = isfinite(rho);
          const float rz = fin ? rho : 0.f;
          sw += rz * __ldg(ep.weight + o);
          sr += rz;
          nf += fin ? 1.f : 0.f;
          q[j] = static_cast<unsigned char>(fminf(fmaxf(rz * ep.scale, 0.f), 255.f));
        }
        *reinterpret_cast<uchar4*>(oe + (ty4 + i) * W + tx4) =
            make_uchar4(q[0], q[1], q[2], q[3]);
      }
    }
    block_sum3(sw, sr, nf, red, tid);
    if (tid == 0) {
      float* st = ep.stats + static_cast<size_t>(env) * 3;
      st[0] = sw;
      st[1] = sr;
      st[2] = nf;
    }
    __syncthreads();                     // red free for the next env
  }
}

// The state (H, W, 2) of one env into the fragment (0 off the grid): each
// pixel pair (pr, pi, pr, pi) is one float4.
__device__ __forceinline__ void load_state_frag(const float* y, int H, int W, const Own& o,
                                                float pr[4][4], float pi[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (o.valid(j, hi, H, W))
        q = *reinterpret_cast<const float4*>(y + 2 * (o.row(2 * hi) * W + o.col(j, 0)));
      pr[j][2 * hi] = q.x;
      pi[j][2 * hi] = q.y;
      pr[j][2 * hi + 1] = q.z;
      pi[j][2 * hi + 1] = q.w;
    }
}

__device__ __forceinline__ void save_state_frag(float* y, int H, int W, const Own& o,
                                                const float pr[4][4], const float pi[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (o.valid(j, hi, H, W))
        *reinterpret_cast<float4*>(y + 2 * (o.row(2 * hi) * W + o.col(j, 0))) =
            make_float4(pr[j][2 * hi], pi[j][2 * hi], pr[j][2 * hi + 1], pi[j][2 * hi + 1]);
}

// One kinetic propagation of (pr, pi) by the phase tables (c, s) on the
// tensor cores: both fields forward as a pair, the phase rotation in the
// frequency domain (the tables read in the fragment layout; pixels off the
// grid are left as they are: store_operand zeroes them), both inverse.
__device__ __forceinline__ void propagate_wg(float pr[4][4], float pi[4][4],
                                             const float* __restrict__ c_tab,
                                             const float* __restrict__ s_tab, const WgTiles& sm,
                                             __nv_bfloat16* zt2, __nv_bfloat16* t2,
                                             const Own& o, int H, int W) {
  store_operand(sm.zt, pr, o, H, W);
  store_operand(zt2, pi, o, H, W);
  wg_transform2(sm, zt2, t2, sm.ch, sm.cw, o, pr, pi);             // rh, ih
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (!o.valid(j, hi, H, W)) continue;
      const int at = o.row(2 * hi) * W + o.col(j, 0);
      const float2 c2 = __ldg(reinterpret_cast<const float2*>(c_tab + at));
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(s_tab + at));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float c = e ? c2.y : c2.x, s = e ? s2.y : s2.x;
        const float rh = pr[j][2 * hi + e], ih = pi[j][2 * hi + e];
        pr[j][2 * hi + e] = c * rh + s * ih;
        pi[j][2 * hi + e] = c * ih - s * rh;
      }
    }
  store_operand(sm.zt, pr, o, H, W);
  store_operand(zt2, pi, o, H, W);
  wg_transform2(sm, zt2, t2, sm.ich, sm.icw, o, pr, pi);
}

// The bf16 path on the tensor cores: the same macro as
// gpe_strang_macro_kernel with every transform on cas_wgmma.cuh (operand and
// intermediate rounded to bf16), the fields in its fragment layout.  Not
// capped at 128 registers: the paired transform's two T fragments beside pr,
// pi and V + ctrl spill there (384 B), and one block an SM without spills
// ran faster than two with them (PERF.md, section 6).
__global__ void __launch_bounds__(kThreads, 1)
gpe_strang_macro_wg_kernel(const float* __restrict__ y_in, const float* __restrict__ ctrl,
                           const float* __restrict__ V, const float* __restrict__ g_ch,
                           const float* __restrict__ g_cw, const float* __restrict__ g_ich,
                           const float* __restrict__ g_icw, Tables tab,
                           float* __restrict__ y_out, int B, int H, int W, int n_steps,
                           float g, float dt, float dx2, bool poly, GpeEpilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const WgTiles sm = carve_wg_tiles(smem_wg);
  __nv_bfloat16* zt2 = sm.t + kTile;
  __nv_bfloat16* t2 = zt2 + kTile;
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const Own o = make_own(tid);
  load_mats_wg(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    float pr[4][4], pi[4][4], vc[4][4], q[4][4];
    load_state_frag(y_in + 2 * off, H, W, o, pr, pi);
    load_frag(V, H, W, o, vc);
    load_frag(ctrl + off, H, W, o, q);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) vc[j][e] += q[j][e];

    // The previous env's last barriers have finished every read of the tiles.
    propagate_wg(pr, pi, tab.cosH, tab.sinH, sm, zt2, t2, o, H, W);
    for (int s = 0; s < n_steps - 1; ++s) {
      b_phase(pr, pi, vc, g, dt, poly);
      propagate_wg(pr, pi, tab.cosF, tab.sinF, sm, zt2, t2, o, H, W);
      renorm(pr, pi, norm2_frag(pr, pi, o, H, W), red, dx2, tid);
    }
    b_phase(pr, pi, vc, g, dt, poly);
    propagate_wg(pr, pi, tab.cosH, tab.sinH, sm, zt2, t2, o, H, W);
    renorm(pr, pi, norm2_frag(pr, pi, o, H, W), red, dx2, tid);

    save_state_frag(y_out + 2 * off, H, W, o, pr, pi);
    if (ep.stats == nullptr) continue;

    // ---- env epilogue (`kernel_ep`'s emit) on the fragment-resident state ----
    float sw = 0.f, sr = 0.f, nf = 0.f;
    unsigned char* oe = ep.obs + off;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        if (!o.valid(j, hi, H, W)) continue;
        const int at = o.row(2 * hi) * W + o.col(j, 0);
        const float2 w = __ldg(reinterpret_cast<const float2*>(ep.weight + at));
        unsigned char ob[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = pr[j][2 * hi + e], y = pi[j][2 * hi + e];
          const float rho = x * x + y * y;
          const bool fin = isfinite(rho);
          const float rz = fin ? rho : 0.f;
          sw += rz * (e ? w.y : w.x);
          sr += rz;
          nf += fin ? 1.f : 0.f;
          ob[e] = static_cast<unsigned char>(fminf(fmaxf(rz * ep.scale, 0.f), 255.f));
        }
        *reinterpret_cast<uchar2*>(oe + at) = make_uchar2(ob[0], ob[1]);
      }
    block_sum3(sw, sr, nf, red, tid);
    if (tid == 0) {
      float* st = ep.stats + static_cast<size_t>(env) * 3;
      st[0] = sw;
      st[1] = sr;
      st[2] = nf;
    }
    __syncthreads();                     // red free for the next env
  }
}

// ---- K5 above 64 x 64: the tiled kernel ------------------------------------
//
// One block owns one env at a time (grid-stride).  Its planes live in this
// block's slot of a scratch that the wrapper allocates
// (gpe_strang_macro_scratch): [zr, zi, t, pr, pi], five H x W f32 planes (the
// operands zr, zi and the intermediate t hold bf16 on the tensor-core path,
// whose matrices g_* are then bf16 copies).  A propagation is four
// tiled_transforms whose epilogues work at a pixel pair:
//
//   fwd(zr): rh into the pr plane, in f32 (the JAX kernel's products emit
//            f32; rh is rounded only as part of the next operand)
//   fwd(zi): c rh + s ih -> zr and c ih - s rh -> zi, formed in f32
//   inv(zr): pr
//   inv(zi): pi, and this thread's share of sum(pr^2 + pi^2)
//
// The norm is whole only after the last tile of inv(zi), so the scale is a
// full-f32 block sum applied where the pixels are next read: the B-phase
// pass scales (pr, pi) first and takes theta from the scaled field (JAX's
// order of operations), then writes the next operands; after the last
// propagation one closing pass scales, writes the interleaved state and runs
// the epilogue.  The first propagation's operands are the state itself,
// deinterleaved as it is read, and it is not renormalised.

constexpr int kGpeTiledPlanes = 5;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
gpe_strang_macro_tiled_kernel(const float* __restrict__ y_in, const float* __restrict__ ctrl,
                              const float* __restrict__ V, const Op<kBf16>* __restrict__ g_ch,
                              const Op<kBf16>* __restrict__ g_cw,
                              const Op<kBf16>* __restrict__ g_ich,
                              const Op<kBf16>* __restrict__ g_icw, Tables tab,
                              float* __restrict__ y_out, float* scratch, int B, int H, int W,
                              int n_steps, float g, float dt, float dx2, bool poly,
                              GpeEpilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  __shared__ float red[kWarps][3];
  const int tid = threadIdx.x, hw = H * W;
  // B phases a macro: n_steps - 1 before full propagations, one before the
  // closing half propagation (n_steps 0 runs as 1, as in JAX).
  const int n_b = n_steps > 1 ? n_steps : 1;
  float* zr = scratch + static_cast<size_t>(blockIdx.x) * kGpeTiledPlanes * hw;
  float* zi = zr + hw;
  float* t = zi + hw;
  float* pr = t + hw;
  float* pi = pr + hw;

  // One kinetic propagation by the phase tables (c_tab, s_tab) of the
  // operands in zr, zi; returns this thread's share of sum(pr^2 + pi^2).
  auto propagate = [&](const float* __restrict__ c_tab, const float* __restrict__ s_tab) {
    tiled_transform<kBf16>(smem_tl, zr, t, g_ch, g_cw, H, W, tid,          // rh
                           [&](int r, int c, float2 v) { st2(pr + r * W + c, v); });
    tiled_transform<kBf16>(                                                 // ih
        smem_tl, zi, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
          const int p = r * W + c;
          const float2 rh = ld2(pr + p), cs = ld2(c_tab + p), sn = ld2(s_tab + p);
          put_z<kBf16>(zr, r, c, H, W,
                       make_float2(cs.x * rh.x + sn.x * v.x, cs.y * rh.y + sn.y * v.y));
          put_z<kBf16>(zi, r, c, H, W,
                       make_float2(cs.x * v.x - sn.x * rh.x, cs.y * v.y - sn.y * rh.y));
        });
    tiled_transform<kBf16>(smem_tl, zr, t, g_ich, g_icw, H, W, tid,        // pr
                           [&](int r, int c, float2 v) { st2(pr + r * W + c, v); });
    float n2 = 0.f;
    tiled_transform<kBf16>(                                                 // pi
        smem_tl, zi, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
          const int p = r * W + c;
          const float2 a = ld2(pr + p);
          st2(pi + p, v);
          n2 += a.x * a.x + v.x * v.x;
          n2 += a.y * a.y + v.y * v.y;
        });
    return n2;
  };

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float* ce = ctrl + off;
    for (int p = 2 * tid; p < hw; p += 2 * kThreads) {
      const float4 q = *reinterpret_cast<const float4*>(y_in + 2 * (off + p));
      put_z<kBf16>(zr, p / W, p % W, H, W, make_float2(q.x, q.z));
      put_z<kBf16>(zi, p / W, p % W, H, W, make_float2(q.y, q.w));
    }
    propagate(tab.cosH, tab.sinH);
    float inv_norm = 1.0f;
    for (int s = 0; s < n_b; ++s) {
      // The B phase exp(-i th), th = dt (V + ctrl + g |psi|^2), on the
      // scaled field, into the next propagation's operands.
      __syncthreads();               // every pixel of pr and pi is written
      for (int p = 2 * tid; p < hw; p += 2 * kThreads) {
        const float2 a = ld2(pr + p), b = ld2(pi + p), v = ld2(V + p), q = ld2(ce + p);
        const float rs[2] = {a.x * inv_norm, a.y * inv_norm};
        const float ms[2] = {b.x * inv_norm, b.y * inv_norm};
        const float vc[2] = {v.x + q.x, v.y + q.y};
        float nr[2], ni[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float r = rs[e], m = ms[e];
          const float th = dt * (vc[e] + g * (r * r + m * m));
          float c, sn;
          if (poly) {
            const float t2 = th * th;
            c = 1.0f + t2 * (-0.5f + t2 * (static_cast<float>(1.0 / 24.0) +
                                           t2 * static_cast<float>(-1.0 / 720.0)));
            sn = th * (1.0f + t2 * (static_cast<float>(-1.0 / 6.0) +
                                    t2 * (static_cast<float>(1.0 / 120.0) +
                                          t2 * static_cast<float>(-1.0 / 5040.0))));
          } else {
            sincosf(th, &sn, &c);
          }
          nr[e] = c * r + sn * m;
          ni[e] = c * m - sn * r;
        }
        put_z<kBf16>(zr, p / W, p % W, H, W, make_float2(nr[0], nr[1]));
        put_z<kBf16>(zi, p / W, p % W, H, W, make_float2(ni[0], ni[1]));
      }
      const bool half = s + 1 == n_b;
      float n2 = propagate(half ? tab.cosH : tab.cosF, half ? tab.sinH : tab.sinF);
      // renorm: a full-f32 block sum, broadcast to all.
      float unused1 = 0.f, unused2 = 0.f;
      block_sum3(n2, unused1, unused2, red, tid);
      inv_norm = 1.0f / sqrtf(n2 * dx2);
    }

    // ---- closing pass: the scaled state, interleaved, and the epilogue ----
    __syncthreads();                 // every read of red is done
    float sw = 0.f, sr = 0.f, nf = 0.f;
    for (int p = 2 * tid; p < hw; p += 2 * kThreads) {
      const float2 a = ld2(pr + p), b = ld2(pi + p);
      const float x[2] = {a.x * inv_norm, a.y * inv_norm};
      const float y[2] = {b.x * inv_norm, b.y * inv_norm};
      *reinterpret_cast<float4*>(y_out + 2 * (off + p)) = make_float4(x[0], y[0], x[1], y[1]);
      if (ep.stats == nullptr) continue;
      const float2 w = ld2(ep.weight + p);
      unsigned char ob[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float rho = x[e] * x[e] + y[e] * y[e];
        const bool fin = isfinite(rho);
        const float rz = fin ? rho : 0.f;
        sw += rz * (e ? w.y : w.x);
        sr += rz;
        nf += fin ? 1.f : 0.f;
        ob[e] = static_cast<unsigned char>(fminf(fmaxf(rz * ep.scale, 0.f), 255.f));
      }
      *reinterpret_cast<uchar2*>(ep.obs + off + p) = make_uchar2(ob[0], ob[1]);
    }
    if (ep.stats != nullptr) {
      block_sum3(sw, sr, nf, red, tid);
      if (tid == 0) {
        float* st = ep.stats + static_cast<size_t>(env) * 3;
        st[0] = sw;
        st[1] = sr;
        st[2] = nf;
      }
    }
    __syncthreads();                 // red and the planes free for the next env
  }
}

}  // namespace

extern "C" {

// The scratch a launch needs on the current device: `slots` blocks resident
// at once of the kernel that the grid and round_bf16 pick, each with a slot
// of `floats` f32: none at 64^2 and below (0, 0), kGpeTiledPlanes H x W
// planes above.  Returns a cudaError_t value.
int gpe_strang_macro_scratch(int round_bf16, int H, int W, int* slots, long long* floats) {
  *slots = 0;
  *floats = 0;
  if (!tiled(H, W)) return 0;
  return static_cast<int>(
      round_bf16 != 0 ? tiled_scratch(gpe_strang_macro_tiled_kernel<true>, true, kGpeTiledPlanes,
                                      H, W, slots, floats)
                      : tiled_scratch(gpe_strang_macro_tiled_kernel<false>, false,
                                      kGpeTiledPlanes, H, W, slots, floats));
}

// Launches K5 on `stream`: at 64^2 and below the tensor-core kernel when
// round_bf16 (bf16 matrices), the FMA kernel otherwise; above, the tiled
// kernel of that type, on min(B, n_slots) blocks with `scratch` as
// gpe_strang_macro_scratch sizes it (unused at 64^2).  ch16 .. icw16 are the
// matrices as bf16 (read by the tiled tensor-core kernel alone; may be null
// otherwise).  y (B, H, W, 2) and ctrl (B, H, W) in, y_out (B, H, W, 2) out;
// stats == nullptr runs the plain macro, otherwise stats (B, 3) and obs (B,
// H, W) are written too.  Returns a cudaError_t value.
int gpe_strang_macro_launch(const float* y, const float* ctrl, const float* V,
                            const float* ch, const float* cw, const float* ich,
                            const float* icw, const void* ch16, const void* cw16,
                            const void* ich16, const void* icw16, const float* cos_full,
                            const float* sin_full, const float* cos_half,
                            const float* sin_half, float* out, float* stats,
                            unsigned char* obs, const float* weight, float obs_scale,
                            float* scratch, int n_slots,
                            int B, int H, int W, int n_steps, float g, float dt,
                            float dx2, int phase_poly, int round_bf16, void* stream) {
  const bool big = tiled(H, W);
  if ((big ? bad_tiled_grid(B, H, W, n_steps) : bad_grid(B, H, W, n_steps)) ||
      (stats != nullptr && weight == nullptr) ||
      (big && (scratch == nullptr || n_slots < 1 ||
               (round_bf16 != 0 && bad_mats16(ch16, cw16, ich16, icw16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tab{cos_full, sin_full, cos_half, sin_half};
  const GpeEpilogue ep{stats, obs, weight, obs_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int resident = 0;
  cudaError_t err;
  if (big && round_bf16 != 0) {
    return static_cast<int>(launch_tiled(gpe_strang_macro_tiled_kernel<true>, true, B, n_slots,
                                         st, y, ctrl, V, B16(ch16), B16(cw16), B16(ich16),
                                         B16(icw16), tab, out, scratch, B, H, W, n_steps, g, dt,
                                         dx2, phase_poly != 0, ep));
  } else if (big) {
    return static_cast<int>(launch_tiled(gpe_strang_macro_tiled_kernel<false>, false, B, n_slots,
                                         st, y, ctrl, V, ch, cw, ich, icw, tab, out, scratch, B,
                                         H, W, n_steps, g, dt, dx2, phase_poly != 0, ep));
  } else if (round_bf16 != 0) {
    if ((err = resident_blocks(gpe_strang_macro_wg_kernel, &resident, kGpeWgSmemBytes)) !=
        cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    gpe_strang_macro_wg_kernel<<<grid, kThreads, kGpeWgSmemBytes, st>>>(
        y, ctrl, V, ch, cw, ich, icw, tab, out, B, H, W, n_steps, g, dt, dx2,
        phase_poly != 0, ep);
  } else {
    if ((err = resident_blocks(gpe_strang_macro_kernel, &resident)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    gpe_strang_macro_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        y, ctrl, V, ch, cw, ich, icw, tab, out, B, H, W, n_steps, g, dt, dx2,
        phase_poly != 0, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
