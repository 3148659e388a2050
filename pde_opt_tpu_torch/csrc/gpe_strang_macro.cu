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
// of them per macro (4.2 MFLOP each at 64^2), f32 FMA on the CUDA cores:
// arithmetic-bound.  Design as K1: one block of 256 threads per env at a time
// (grid-stride), matrices and two transform tiles in 96 KB of shared memory.
// An env holds two fields where K1 holds one; pr, pi and V + ctrl stay in
// registers (16 each a thread) and the four phase tables (H, W) are read per
// use through the read-only cache (64 KB, L2-resident), not held: held, they
// would push the thread past its register budget and spill.  The state is
// read and written in its interleaved (B, H, W, 2) layout.

#include "cas_common.cuh"

namespace {

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

// Scale the env to unit L2 norm: a full-f32 block sum, broadcast to all.
__device__ __forceinline__ void renorm(float pr[4][4], float pi[4][4], float (*red)[3],
                                       float dx2, int tid, bool own) {
  float n2 = 0.f, unused1 = 0.f, unused2 = 0.f;
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) n2 += pr[i][j] * pr[i][j] + pi[i][j] * pi[i][j];
  }
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

__global__ void __launch_bounds__(kThreads)
gpe_strang_macro_kernel(const float* __restrict__ y_in, const float* __restrict__ ctrl,
                        const float* __restrict__ V, const float* __restrict__ g_ch,
                        const float* __restrict__ g_cw, const float* __restrict__ g_ich,
                        const float* __restrict__ g_icw, Tables tab,
                        float* __restrict__ y_out, int B, int H, int W, int n_steps,
                        float g, float dt, float dx2, bool poly, bool rnd,
                        GpeEpilogue ep) {
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
      renorm(pr, pi, red, dx2, tid, own);
    }
    if (own) b_phase(pr, pi, vc, g, dt, poly);
    propagate(pr, pi, tab.cosH, tab.sinH, sm, H, W, ty4, tx4, own, rnd);
    renorm(pr, pi, red, dx2, tid, own);

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

}  // namespace

extern "C" {

// Launches K5 on `stream`: y (B, H, W, 2) and ctrl (B, H, W) in, y_out
// (B, H, W, 2) out; stats == nullptr runs the plain macro, otherwise stats
// (B, 3) and obs (B, H, W) are written too.  Returns a cudaError_t value.
int gpe_strang_macro_launch(const float* y, const float* ctrl, const float* V,
                            const float* ch, const float* cw, const float* ich,
                            const float* icw, const float* cos_full,
                            const float* sin_full, const float* cos_half,
                            const float* sin_half, float* out, float* stats,
                            unsigned char* obs, const float* weight, float obs_scale,
                            int B, int H, int W, int n_steps, float g, float dt,
                            float dx2, int phase_poly, int round_bf16, void* stream) {
  if (bad_grid(B, H, W, n_steps) || (stats != nullptr && weight == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  cudaError_t err = resident_blocks(gpe_strang_macro_kernel, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < resident ? B : resident;
  const Tables tab{cos_full, sin_full, cos_half, sin_half};
  const GpeEpilogue ep{stats, obs, weight, obs_scale};
  gpe_strang_macro_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      y, ctrl, V, ch, cw, ich, icw, tab, out, B, H, W, n_steps, g, dt, dx2,
      phase_poly != 0, round_bf16 != 0, ep);
  return static_cast<int>(cudaGetLastError());
}

const char* gpe_strang_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
