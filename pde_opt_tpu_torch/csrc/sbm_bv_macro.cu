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
// Bound: no matrix products and 32 KB of field traffic per env and macro, so
// the CUDA cores' issue rate bounds it: per pixel-stage two stencils and the
// closure, whose accurate logf, expf, sqrtf and four IEEE divisions (the log
// ratio's, 1/em, and two in the root and the reaction) are multi-instruction
// sequences around the 16-lane MUFU unit.  Design: one block owns one env at
// a time (grid-stride), each thread a K7_ROWS x K7_COLS tile of pixels.
//
// * The face fluxes are computed in registers: a thread reads the stage
//   input z of the rows above and below its tile and the columns beside it
//   from one shared tile zs, computes each face of its tile once, and
//   computes the faces on its tile's top and left edges from the same zs
//   values and psi constants as the neighbour that owns them, so both round
//   alike.  No flux tiles, and two barriers a stage: zs complete, and the
//   reduction's.  The reduction's barrier also fences the next stage's
//   write of zs (every read of zs comes before it), and the block sum
//   alternates between two buffers, so a reduction never waits for the
//   reads of the one before.
// * The four stencil and closure constants (psi_ax, psi_ay, kappa/psi,
//   psi*cell) are copied into shared memory once per block, not fetched
//   from the read-only cache at every pixel-stage: 64 KB at 64^2 beside zs
//   (16 KB); psi itself, read once per env by the epilogue, stays in device
//   memory.
// * 1/em is computed once a pixel-stage and held to the reaction
//   (bv_reaction's four-argument form); z dies after the closure, so a
//   thread carries u, the RK sum, j, em and 1/em (five floats a pixel)
//   across the reduction.
//
// The tile and the register budget (kR, kC, kMinBlocks below):
// scripts/torch_k7_k8_ab.py builds the candidates side by side and times
// them on the card (PERF.md, section 6).  These are the fastest there:
// 2 x 2 tiles on 1024 threads, one block an
// SM at 64 registers (24 B of spills), against 2 x 4 on 512 (108
// registers, no spills), 1 x 4 on 1024 and 4 x 4 on 256 at one or two
// blocks an SM.  At 1024 envs x 64^2 x 10 its loop issues one RK stage in
// about 200 SASS instructions a pixel, so the time sits near the issue
// rate's floor for them: the accurate closure, not the barriers or the
// memory, is what is left.

#include "bv_common.cuh"
#include "cas_common.cuh"

namespace {

constexpr int kR = 2, kC = 2;                       // a thread's tile
constexpr int kMinBlocks = 1;                       // blocks an SM (the register cap)
constexpr int kColThreads = kLd / kC;               // threads along a row
constexpr int kSbmThreads = (kLd / kR) * kColThreads;
constexpr int kSbmWarps = kSbmThreads / 32;
static_assert((kC == 1 || kC == 2 || kC == 4) && kLd % kR == 0 && kSbmWarps <= 32 &&
                  kSbmThreads % 32 == 0,
              "a tile of 1, 2 or 4 columns, at most 1024 threads");

// zs and the four constants, each H x W f32 with row stride W.
constexpr int kSbmPlanes = 5;

struct SbmEpilogue {
  float* stats;          // (B, 3) or nullptr for the plain macro
  unsigned char* obs;    // (B, H, W)
  float scale, center;
};

// kC consecutive floats of a row, as one vector access where kC > 1 (the
// row stride W and the column are multiples of kC).
__device__ __forceinline__ void load_row(const float* p, float (&v)[kC]) {
  if constexpr (kC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (kC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[kC]) {
  if constexpr (kC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (kC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

__device__ __forceinline__ void store_obs(unsigned char* p, const unsigned char (&q)[kC]) {
  if constexpr (kC == 4)
    *reinterpret_cast<uchar4*>(p) = make_uchar4(q[0], q[1], q[2], q[3]);
  else if constexpr (kC == 2)
    *reinterpret_cast<uchar2*>(p) = make_uchar2(q[0], q[1]);
  else
    *p = q[0];
}

// Sum a[0..N) over the block into every thread, in the same order on every
// thread: each warp's butterfly, lane 0 of each warp into red, a barrier,
// then every warp sums the per-warp values by the same butterfly (lane l
// reads warp l's; fadd commutes, so every lane ends on the same bits).  The
// caller alternates red between two buffers, so the write here never races
// the previous reduction's reads.
template <int N>
__device__ __forceinline__ void block_sum(float (&a)[N], float (*red)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp][k] = a[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = lane < kSbmWarps ? red[lane][k] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
}

__global__ void __launch_bounds__(kSbmThreads, kMinBlocks)
sbm_bv_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ crate,
                    const float* __restrict__ psi_ax, const float* __restrict__ psi_ay,
                    const float* __restrict__ kop, const float* __restrict__ psic,
                    const float* __restrict__ psi, float* __restrict__ u_out, int B, int H,
                    int W, int n_steps, Rk4 rk, float inv_hx, float inv_hy, BvCoeffs bv,
                    SbmEpilogue ep) {
  extern __shared__ float4 smem4[];
  const int n = H * W;
  float* zs = reinterpret_cast<float*>(smem4);
  float* s_ax = zs + n;
  float* s_ay = s_ax + n;
  float* s_kop = s_ay + n;
  float* s_pc = s_kop + n;
  __shared__ float red[2][kSbmWarps][3];

  const int tid = threadIdx.x;
  const int ty = (tid / kColThreads) * kR;     // first row (H axis) of the tile
  const int tx = (tid % kColThreads) * kC;     // first column (W axis)
  const bool own = ty < H && tx < W;
  // The rows above and below the tile and the columns left and right of it.
  const int up = (ty == 0 ? H : ty) - 1, dn = ty + kR >= H ? 0 : ty + kR;
  const int lf = (tx == 0 ? W : tx) - 1, rt = tx + kC >= W ? 0 : tx + kC;

  // n is a multiple of 64 (H, W multiples of 8): whole float4s.
  for (int p = 4 * tid; p < n; p += 4 * kSbmThreads) {
    *reinterpret_cast<float4*>(s_ax + p) = *reinterpret_cast<const float4*>(psi_ax + p);
    *reinterpret_cast<float4*>(s_ay + p) = *reinterpret_cast<const float4*>(psi_ay + p);
    *reinterpret_cast<float4*>(s_kop + p) = *reinterpret_cast<const float4*>(kop + p);
    *reinterpret_cast<float4*>(s_pc + p) = *reinterpret_cast<const float4*>(psic + p);
  }
  __syncthreads();
  int rb = 0;                                  // the block sum's buffer

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * n;
    const float C = crate[env];
    // u: the field; acc: the RK sum; z: the stage input; jj, em, iem: j0(z),
    // exp(m/2) and 1/em, carried across the reduction.
    float u[kR][kC] = {}, acc[kR][kC], z[kR][kC], jj[kR][kC], em[kR][kC], iem[kR][kC];
    if (own) {
#pragma unroll
      for (int i = 0; i < kR; ++i) load_row(u_in + off + (ty + i) * W + tx, u[i]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) z[i][j] = u[i][j];

    for (int s = 0; s < n_steps; ++s) {
      for (int stage = 0; stage < 4; ++stage) {
        // The previous reduction's barrier has finished every read of zs.
        if (own) {
#pragma unroll
          for (int i = 0; i < kR; ++i) store_row(zs + (ty + i) * W + tx, z[i]);
        }
        __syncthreads();                                   // zs complete
        float sums[2] = {0.f, 0.f};                        // I+, I-
        if (own) {
          float zu[kC], zd[kC], pax[kC], fxp[kC];
          load_row(zs + up * W + tx, zu);
          load_row(zs + dn * W + tx, zd);
          load_row(s_ax + up * W + tx, pax);
          // The faces above the tile's first row.
#pragma unroll
          for (int j = 0; j < kC; ++j)
            fxp[j] = __fmul_rn(__fmul_rn(pax[j], z[0][j] - zu[j]), inv_hx);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const int r = (ty + i) * W;
            float pay[kC], kp[kC], pc[kC];
            load_row(s_ax + r + tx, pax);
            load_row(s_ay + r + tx, pay);
            load_row(s_kop + r + tx, kp);
            load_row(s_pc + r + tx, pc);
            // The face left of the row's first pixel.
            float fyp = __fmul_rn(__fmul_rn(s_ay[r + lf], z[i][0] - zs[r + lf]), inv_hy);
            const float z_rt = zs[r + rt];
#pragma unroll
            for (int j = 0; j < kC; ++j) {
              const float zb = i + 1 < kR ? z[i + 1 < kR ? i + 1 : i][j] : zd[j];
              const float zr = j + 1 < kC ? z[i][j + 1 < kC ? j + 1 : j] : z_rt;
              const float fx = __fmul_rn(__fmul_rn(pax[j], zb - z[i][j]), inv_hx);
              const float fy = __fmul_rn(__fmul_rn(pay[j], zr - z[i][j]), inv_hy);
              const float div = __fadd_rn(__fmul_rn(fx - fxp[j], inv_hx),
                                          __fmul_rn(fy - fyp, inv_hy));
              fxp[j] = fx;
              fyp = fy;
              const float m = __fsub_rn(bv_mu(bv, z[i][j]), __fmul_rn(kp[j], div));
              const float j0 = bv_j0(bv, z[i][j]);
              const float e = expf(0.5f * m);
              const float ie = __fdiv_rn(1.0f, e);
              sums[0] += __fmul_rn(__fmul_rn(j0, e), pc[j]);
              sums[1] += __fmul_rn(__fmul_rn(j0, ie), pc[j]);
              jj[i][j] = j0;
              em[i][j] = e;
              iem[i][j] = ie;
            }
          }
        }
        block_sum(sums, red[rb]);
        rb ^= 1;
        const float y = bv_root(C, sums[0], sums[1]);
        if (own) {
          // k, the RK sum ((k1 + 2 k2) + 2 k3) + k4, and the next stage's
          // input u + c k (or, after k4, the new u).
          const float c = stage == 2 ? rk.full : rk.half;
#pragma unroll
          for (int i = 0; i < kR; ++i)
#pragma unroll
            for (int j = 0; j < kC; ++j) {
              const float k = bv_reaction(jj[i][j], em[i][j], iem[i][j], y);
              acc[i][j] = stage == 0 ? k : __fadd_rn(acc[i][j], (stage == 3 ? 1.0f : 2.0f) * k);
              if (stage == 3) {
                u[i][j] = __fadd_rn(u[i][j], __fmul_rn(rk.sixth, acc[i][j]));
                z[i][j] = u[i][j];
              } else {
                z[i][j] = __fadd_rn(u[i][j], __fmul_rn(c, k));
              }
            }
        }
      }
    }

    if (own) {
#pragma unroll
      for (int i = 0; i < kR; ++i) store_row(u_out + off + (ty + i) * W + tx, u[i]);
    }
    if (ep.stats != nullptr) {
      float sums[3] = {0.f, 0.f, 0.f};     // sum w(u-c), sum w(u-c)^2, n_finite
      if (own) {
        unsigned char* oe = ep.obs + off;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int r = (ty + i) * W + tx;
          float pc[kC];
          load_row(s_pc + r, pc);
          unsigned char q[kC];
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            const bool fin = isfinite(u[i][j]);
            const float uz = fin ? u[i][j] - ep.center : 0.f;
            const float wuz = __fmul_rn(pc[j], uz);
            sums[0] += wuz;
            sums[1] += __fmul_rn(wuz, uz);
            sums[2] += fin ? 1.f : 0.f;
            const float x = __fmul_rn(__fmul_rn(fin ? u[i][j] : 0.f, __ldg(psi + r + j)),
                                      ep.scale);
            q[j] = static_cast<unsigned char>(fminf(fmaxf(x, 0.f), 255.f));
          }
          store_obs(oe + r, q);
        }
      }
      block_sum(sums, red[rb]);
      rb ^= 1;
      if (tid == 0) {
        float* st = ep.stats + static_cast<size_t>(env) * 3;
        st[0] = sums[0];
        st[1] = sums[1];
        st[2] = sums[2];
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
  const int smem = kSbmPlanes * H * W * static_cast<int>(sizeof(float));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = allow_smem(sbm_bv_macro_kernel, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sbm_bv_macro_kernel,
                                                           kSbmThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = B < resident ? B : resident;
  sbm_bv_macro_kernel<<<grid, kSbmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, crate, psi_ax, psi_ay, kop, psic, psi, out, B, H, W, n_steps, rk, inv_hx, inv_hy,
      bv, ep);
  return static_cast<int>(cudaGetLastError());
}

const char* sbm_bv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
