// Fused smoothed-boundary (SBM) galvanostatic Butler-Volmer RK4 macro-step,
// hand-written for Hopper (sm_90a), with the optional psi-weighted RL env
// epilogue: K7.
//
// Replaces the TPU kernel of pde_opt_tpu/ops/sbm_bv.py,
// make_sbm_bv_fused_macro (`kernel`, launched at :308, and `kernel_ep` at
// :326, both over `_evolve_packed`, :151).  Per env with its own C-rate C,
// n_steps classical RK4 substeps; per stage, on the stage input z, with each
// env wrapping periodically by index ((i +- 1) mod H, (j +- 1) mod W):
//
//   Fx  = psi_ax*(z[i+1,j] - z[i,j]) * (1/hx)     Fy likewise along j
//   div = (Fx[i,j] - Fx[i-1,j]) * (1/hx) + (Fy[i,j] - Fy[i,j-1]) * (1/hy)
//   m   = mu(z) - (kappa/psi)*div,  j = j0(z),  em = exp(m/2)
//   I+  = sum(j*em*psi*cell),  I- = sum(j/em*psi*cell)    (one block reduction)
//   y   = (-C + sqrt(C^2 + 4 I+ I-)) / (2 I+),  k = j*(1/(em*y) - em*y)
//
// f32 throughout; mu and j0 as in bv_common.cuh.  The TPU kernel packs four
// 64^2 envs into one 128-wide tile and corrects every roll at the seams with
// 0/1 masks; here each block owns whole envs, so the wrap is an index.  The
// epilogue: [sum(w(u-c)), sum(w(u-c)^2), n_finite] over finite pixels with
// w = psi*cell, and the uint8 observation clip(u*psi*scale, 0, 255), NaN
// pixels read as 0.
//
// Bound: no matrix products.  Per pixel-stage about 60 operations (two
// stencils, the closure with a logf, an expf, a sqrtf and three divisions)
// against 32 KB of field traffic per env and macro: bound by the CUDA cores'
// arithmetic and issue rate, and by the three barriers a stage (the field
// tile, the flux tiles, the reduction).  Design: one block of 256 threads
// owns one env at a time (grid-stride), each thread a 4 x 4 tile; the stage
// input and the two flux fields go through three 64 x 64 f32 tiles in shared
// memory (48 KB) so that neighbours can be read.  The five psi constants
// (80 KB at 64^2, shared by every env) are read through the read-only cache
// at each use, not held in shared memory: that keeps a block at 48 KB, so
// registers, not shared memory, set how many blocks share an SM.  Left to
// itself ptxas gives the kernel 171 registers, one block an SM; capped at
// 128 (two blocks an SM) it spills a few hundred bytes a thread to L1 and
// runs faster all the same (scripts/k7_launch_bounds_ab.py measures both).

#include "bv_common.cuh"
#include "cas_common.cuh"

namespace {

// zs (the stage input), fx, fy: three 64 x 64 f32 tiles, 48 KB.
constexpr int kSbmSmemBytes = 3 * kLd * kLd * static_cast<int>(sizeof(float));

struct SbmEpilogue {
  float* stats;          // (B, 3) or nullptr for the plain macro
  unsigned char* obs;    // (B, H, W)
  float scale, center;
};

__device__ __forceinline__ void ldg_tile(const float* __restrict__ src, int W, int ty4,
                                         int tx4, int i, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(src + (ty4 + i) * W + tx4));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__global__ void __launch_bounds__(kThreads, 2)
sbm_bv_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ crate,
                    const float* __restrict__ psi_ax, const float* __restrict__ psi_ay,
                    const float* __restrict__ kop, const float* __restrict__ psic,
                    const float* __restrict__ psi, float* __restrict__ u_out, int B, int H,
                    int W, int n_steps, Rk4 rk, float inv_hx, float inv_hy, BvCoeffs bv,
                    SbmEpilogue ep) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  float* fx = zs + kLd * kLd;
  float* fy = fx + kLd * kLd;
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const int ty4 = (tid / 16) * 4;        // first row (H axis) this thread owns
  const int tx4 = (tid % 16) * 4;        // first column (W axis)
  const bool own = ty4 < H && tx4 < W;

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float C = crate[env];
    // u: the field; acc: the RK sum; z: the stage input, then j0(z); a:
    // exp(m/2), then the stage's k.
    float u[4][4], acc[4][4], z[4][4], a[4][4] = {};
    if (own) load_tile(u_in + off, W, ty4, tx4, u);

    for (int s = 0; s < n_steps; ++s) {
      for (int stage = 0; stage < 4; ++stage) {
        // The previous stage's flux barrier has finished every read of zs.
        if (own) {
          rk4_stage_input(z, u, a, stage, rk);
          store_tile(zs, ty4, tx4, z, false);
        }
        __syncthreads();                                   // zs complete
        if (own) {
          float f[4][4], g[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty4 + i;
            const int rp = r + 1 == H ? 0 : r + 1;
            float pax[4], pay[4];
            ldg_tile(psi_ax, W, ty4, tx4, i, pax);
            ldg_tile(psi_ay, W, ty4, tx4, i, pay);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = tx4 + j;
              const int cp = c + 1 == W ? 0 : c + 1;
              f[i][j] = __fmul_rn(__fmul_rn(pax[j], zs[rp * kLd + c] - z[i][j]), inv_hx);
              g[i][j] = __fmul_rn(__fmul_rn(pay[j], zs[r * kLd + cp] - z[i][j]), inv_hy);
            }
          }
          store_tile(fx, ty4, tx4, f, false);
          store_tile(fy, ty4, tx4, g, false);
        }
        __syncthreads();                                   // fx, fy complete
        float ip = 0.f, im = 0.f, unused = 0.f;
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty4 + i;
            const int rm = r == 0 ? H - 1 : r - 1;
            float kp[4], pc[4];
            ldg_tile(kop, W, ty4, tx4, i, kp);
            ldg_tile(psic, W, ty4, tx4, i, pc);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = tx4 + j;
              const int cm = c == 0 ? W - 1 : c - 1;
              const float div =
                  __fadd_rn(__fmul_rn(fx[r * kLd + c] - fx[rm * kLd + c], inv_hx),
                            __fmul_rn(fy[r * kLd + c] - fy[r * kLd + cm], inv_hy));
              const float m = __fsub_rn(bv_mu(bv, z[i][j]), __fmul_rn(kp[j], div));
              const float jj = bv_j0(bv, z[i][j]);
              const float em = expf(0.5f * m);
              ip += __fmul_rn(__fmul_rn(jj, em), pc[j]);
              im += __fmul_rn(__fmul_rn(jj, __fdiv_rn(1.0f, em)), pc[j]);
              z[i][j] = jj;
              a[i][j] = em;
            }
          }
        }
        block_sum3(ip, im, unused, red, tid);
        const float y = bv_root(C, ip, im);
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = bv_reaction(z[i][j], a[i][j], y);
          rk4_accumulate(acc, a, stage);
        }
      }
      if (own) rk4_finish(u, acc, rk);
    }

    if (own) save_tile(u_out + off, W, ty4, tx4, u);
    // Every thread has read the last reduction's totals before red is
    // written again.
    __syncthreads();
    if (ep.stats != nullptr) {
      float s1 = 0.f, s2 = 0.f, nf = 0.f;
      if (own) {
        unsigned char* oe = ep.obs + off;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pc[4], ps[4];
          ldg_tile(psic, W, ty4, tx4, i, pc);
          ldg_tile(psi, W, ty4, tx4, i, ps);
          unsigned char q[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool fin = isfinite(u[i][j]);
            const float uz = fin ? u[i][j] - ep.center : 0.f;
            const float wuz = __fmul_rn(pc[j], uz);
            s1 += wuz;
            s2 += __fmul_rn(wuz, uz);
            nf += fin ? 1.f : 0.f;
            const float x = __fmul_rn(__fmul_rn(fin ? u[i][j] : 0.f, ps[j]), ep.scale);
            q[j] = static_cast<unsigned char>(fminf(fmaxf(x, 0.f), 255.f));
          }
          *reinterpret_cast<uchar4*>(oe + (ty4 + i) * W + tx4) =
              make_uchar4(q[0], q[1], q[2], q[3]);
        }
      }
      block_sum3(s1, s2, nf, red, tid);
      if (tid == 0) {
        float* st = ep.stats + static_cast<size_t>(env) * 3;
        st[0] = s1;
        st[1] = s2;
        st[2] = nf;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches K7 on `stream`.  stats == nullptr runs the plain macro; otherwise
// stats and obs are written too.  dt_half, dt, dt_sixth are the RK4 stage
// constants and inv_hx, inv_hy the inverse spacings, rounded to f32.
// Returns a cudaError_t value, 0 on success.
int sbm_bv_macro_launch(const float* u, const float* crate, const float* psi_ax,
                        const float* psi_ay, const float* kop, const float* psic,
                        const float* psi, float* out, float* stats, unsigned char* obs, int B,
                        int H, int W, int n_steps, float dt_half, float dt, float dt_sixth,
                        float inv_hx, float inv_hy, float omega, float clip_lo,
                        float clip_hi, float j0_floor, float obs_scale, float center,
                        void* stream) {
  if (bad_grid(B, H, W, n_steps)) return static_cast<int>(cudaErrorInvalidValue);
  const SbmEpilogue ep{stats, obs, obs_scale, center};
  const Rk4 rk{dt_half, dt, dt_sixth};
  const BvCoeffs bv{omega, clip_lo, clip_hi, j0_floor};
  int resident = 0;
  cudaError_t err = resident_blocks(sbm_bv_macro_kernel, &resident, kSbmSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < resident ? B : resident;
  sbm_bv_macro_kernel<<<grid, kThreads, kSbmSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      u, crate, psi_ax, psi_ay, kop, psic, psi, out, B, H, W, n_steps, rk, inv_hx, inv_hy,
      bv, ep);
  return static_cast<int>(cudaGetLastError());
}

const char* sbm_bv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
