#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Sixteen paths run at full width.  Serving: the flagship Cahn-Hilliard (CH)
control fleet, 4096 envs on a 64x64 periodic grid, 10 semi-implicit
substeps per RL step, per-env kappa control, reward -var, uint8
observation, auto-reset on.  Training: gradients through the same macro at
1024 envs x 64^2 x 10 substeps (the JAX package's ``train_grad`` bench
config) and ``PDEModel.optimize`` with Adam on the fused stepper.  The
Allen-Cahn (AC) fleet at 4096 x 64^2 x 10 and the Gross-Pitaevskii (GPE)
Strang fleet at 1024 x 64^2 x 10 (the JAX package's ``ac64``/``gpe64``
bench configs).  The Butler-Volmer (BV) charging fleet at 2048 x 64^2 x 10
RK4 substeps and the smoothed-boundary BV (SBM) fleet at 1024 x 64^2 x 10
(the JAX package's ``_bv_rate``/``run_sbm_bv`` bench configs), per-env
C-rate control.  The 3D general-mobility Cahn-Hilliard path at the JAX
bench's ``ch3d_mobility_32cubed_256batch``: 256 envs x 32^3, Legendre mu and
D, 50 substeps a call through ``FusedMobilitySpectral`` (one launch of the
fused FD rhs K8 a substep), and its unit-mobility twin.  The flagship CH
fleet with ``derivs="pallas"`` (K8 2D, once a substep of the fft stepper).
The CH and AC fleets and the CH training path on the packed-DFT macros
(``algo="dft"``: K9a, K9b).  The RL learners on the flagship fleet (K1):
PPO at the JAX bench's ``run_ppo`` shape, DQN with three discrete actions,
and DDPG.  Above 64^2, on the tiled K1-K3: the 128^2 CH control fleet of
the JAX bench's ``run_ch128`` (1024 envs), the 256^2 macro of ``run_ch256``
(256 envs) and the differentiable NN-control rollout of
``run_train_grad_128`` (4096 envs x 128^2, value and gradient with respect
to the net's parameters).  Phases (each passes or raises; nothing is
caught):

1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written Hopper kernels from ``pde_opt_tpu_torch/csrc``,
   one ``nvcc`` per source, in parallel; print ``ptxas -v``'s lines and each
   library's count of warpgroup MMA (``HGMMA``) instructions in its SASS
   (``cuobjdump -sass``): the bf16 paths of K1-K3, K4, K5, K6, K9a and K9b
   run on the tensor cores, so ``ch_cas_macro``, ``ac_cas_macro``,
   ``gpe_strang_macro``, ``bv_cc_macro``, ``ch_sif_macro`` and
   ``ac_sif_macro`` must hold some.
3. Hold each kernel against its plain-torch version on the card at its
   path's shapes, with f32 and bf16 matrices: the CH macro (K2 without, K1
   with the env epilogue, obs_downsample 1 and 4; also against the FFT
   oracle) and its backward K3 (with bf16 matrices after 10 substeps also
   against a plain backward accumulated in f64, the control of its bound;
   see TOL_BWD); K1-K3 with bf16 matrices also at 16 x 16 and 24 x 40; the
   epilogue variant's gradient (stats fold + K3) against the plain autograd
   Function on the CPU; the AC macro (K4,
   epilogue on and off, the R == 1 path and a polynomial R; also against the
   FFT oracle); the GPE macro (K5, epilogue on and off, phase polynomials on
   and off; also against the FFT oracle); the BV macro (K6, f32 and bf16,
   epilogue on and off; f32 also against the roll-stencil oracle) and the
   SBM macro (K7, epilogue on and off, and against its oracle; also at 24
   x 40 with a NaN env that must stay in its env), each epilogue also
   against the kernel's own final field; K4, K5 and K6 with
   bf16 matrices also at 16 x 16 and 24 x 40 (the tensor-core kernels'
   padding of grids below 64 x 64), epilogue on and off.  K2, K3 (du and dkappa on
   the loss's cotangent, and TOL_BWD), K4, K5 and K6 with
   bf16 matrices are also held after one substep, where a misplaced
   rounding shows: the RMS of kernel - plain must sit below a bound that
   the unrounded plain version (the control) exceeds.  K8 against its plain
   version, 2D at 4096 x 64^2 (the fleet's c^3 - c and D == 1, c^3 - c and
   1 + 0.5 c^2, the Legendre pair), 2D also at 64 x 16 x 24, 8 x 128^2
   and 4 x 256^2 (the row march's lanes of one, four and eight columns),
   and 3D at 256 x 32^3 (the Legendre
   pair), on the paths' fields and on fields far outside [0, 1], and 3D at
   N1 = 2 and 10 and on a non-cubic grid (the march's wrap in N1); the 3D
   mobility macro (f32 matrices, 16 envs) against its FFT oracle and with
   K8 against the roll chain.  K9a at the CH path's and K9b at the AC
   fleet's shapes (R == 1, and a polynomial R on 256 envs), f32 and bf16
   tables, against their plain versions, after one bf16 substep at the
   rounding sites, and with f32 tables (16 envs) against the FFT oracles;
   with bf16 tables (the tensor-core kernels) also at 16 x 16 and 24 x 40
   and at 64 x 64 with the full spectrum (the padding of the spectrum's
   width to a multiple of 8), each with one NaN env that must stay in its
   env.
4. Reset the launch counts, then drive the CH serving path: a 120-step
   random-policy rollout of the fused-epilogue fleet (K1), which crosses
   the episode end and its auto-reset, and 10 steps of the same fleet
   without the fused epilogue (K2).  Check the rewards, the launch counts,
   the per-env mass drift and the epilogue reward against the env's own
   reward function; poison one env with NaN and check it is flagged and
   reset.
5. The same for the AC fleet (K4: 120 steps with the epilogue, 10 without),
   the GPE fleet (K5: likewise; the per-env norm must stay 1), the BV
   fleet (K6) and the SBM fleet (K7; 40-step episodes, so every env resets
   twice), each with its launch counts reset just before and read just
   after.  For BV and SBM one more zero-action step must charge each env
   that did not reset at its own C-rate: d(sum psi c cell)/dt = Crate
   (psi = 1 for BV).  Value and gradient of sum(macro(u, crate)^2) with
   respect to crate, kernel forward and oracle backward on the card, must
   agree with the same call on the CPU.
   The 3D mobility path: 10 calls of ``PDEModel.solve`` under sync debug
   mode "error", launch counts reset just before and read just after:
   finite, per-env mass held, exactly 50 K8 launches a call; its rate
   against the FFT path (``SemiImplicitFourierSpectral`` on the
   equation's ``rhs_fd``), one call's time split (K8, transforms, the
   rest; K8 also on two fields in turn, each launch finding its input out
   of L2 as in the call), the solve's host enqueue against its wall time
   and the unit-mobility macro's rate against its FFT path.  The CH
   fleet with ``derivs="pallas"``: 30 fft steps (10 K8 launches a step)
   and 5 fused steps (K1, no K8), each with its own counts.  Value and
   gradient of the 3D macro with respect to kappa on the card against the
   CPU.  The CH and AC fleets without the fused epilogue and with
   ``"algo": "dft"`` in their solver parameters: 120-step rollouts across
   the episode end, one K9a (K9b) launch a step and nothing else.
6. Reset the launch counts, then drive the training path: value and grad
   of ``sum(macro(u, kappa)**2)`` with respect to a per-env kappa (K2 +
   K3), and 5 Adam steps of ``PDEModel.optimize`` on a two-segment
   checkpointed rollout (each step: K2 twice per segment, the backward's
   recompute included, and K3 once).  Check finiteness, the launch counts,
   that kappa moved in every env, and (f32 matrices) the fused kappa
   gradient against autograd through the FFT oracle.  Through K9a: value
   and gradient of sum(w * macro(u, kappa)) on the card against the CPU,
   and 5 Adam steps of ``PDEModel.optimize`` with ``algo="dft"`` (two K9a
   launches a segment a step: the forward and its checkpoint recompute; the
   backward is the FFT oracle's, plain torch, as in JAX).  The repaired
   fault: 3 Adam steps of ``optimize`` over a Legendre mu module on the card
   against the CPU.
7. Time the kernels against their plain versions with CUDA events, the
   fused and the FFT-stepper value+grad, the auto-reset block, the
   rollouts' env-steps/s, the GPE fleet's fused against its FFT path and
   the BV and SBM fleets' fused against their RK4 paths, K9a against K2 and
   K9b against K4 at the same shapes, the dft fleets against the K1 and K4
   fleets, and the dft value+grad against the cas one.  Each kernel's
   bound (the least time the card could take: operations over the peak for
   their type, or bytes over the memory rate, whichever is larger) is
   computed from this run's shapes.

8. The RL learners on the flagship fleet, each with its launch counts
   reset just before its timed updates and read just after: PPO at
   ``run_ppo``'s shape (4096 x 64^2 x 10, ``derivs="pallas"``, the fused
   epilogue at ``obs_downsample=4``, the bf16 ``ActorCriticMLP``, T = 64,
   2 epochs x 4 minibatches): trained env-steps/s, the update time, the
   physics floor (a random-policy rollout of the same env) and the
   learner's share; 64 K1 launches an update and no other kernel; finite
   metrics, moved parameters, an auto-reset inside a rollout; one update's
   loss and gradients on a fixed trajectory against the CPU.  DQN
   (``QNetConv``, default ``DQNConfig``) on the flagship fleet with the
   discrete actions {0, +1, -1} on kappa's offset, and DDPG
   (``DeterministicActorConv``, ``QCriticConv``, default ``DDPGConfig``) on
   the preset: the update time, one K1 launch an update, finite losses,
   epsilon's decay, the replay's fill, targets that trail the online nets.
9. The CH macros above 64^2 (the tiled K1-K3).  Each kernel against its
   plain version at 128^2, 96 x 136 and 256^2 (K3 at 128^2), f32 and bf16
   matrices, K1 at obs_downsample 1 and 4, each launch with a NaN env that
   must stay in its env, at phase 3's bounds; one bf16 substep at the
   rounding sites.  Then the three paths, each with its launch counts reset
   just before and read just after, under sync debug mode "error": the
   128^2 fleet (30 steps, K1 only), the 256^2 macro (20 chained calls, K2
   only, per-env mass held) and the NN-control value+grad (K2 and K3 once a
   call; with f32 matrices also against the CPU on a few envs).  Their
   rates, and the tiled kernels' times beside their plain versions' and
   their bounds at these shapes.

Every rollout and update runs under ``torch.cuda.set_sync_debug_mode("error")``: a
step that waits for the device fails the run.  The last two lines are a
JSON object per kernel and the JSON result line.
"""

import itertools
import json
import math
import shutil
import subprocess
import sys
import time

NUM_ENVS, GRID, SUBSTEPS, STEPS, K2_STEPS = 4096, 64, 10, 120, 10
HX = HY = 0.01                 # the preset's grid: L = 0.01 * grid_size
DT, A = 0.01 / SUBSTEPS, 1.0   # the preset's substep and splitting constant
CENTER = 0.5                   # the preset's stats_center
TOL_U = {"f32": 1e-5, "bf16": 1e-3}      # kernel vs plain, field
TOL_ORACLE = {"f32": 1e-5, "bf16": 5e-3}  # macro vs FFT oracle, field
SOURCES = {"ch_cas_macro": "pde_opt_tpu_torch/csrc/ch_cas_macro.cu",
           "ac_cas_macro": "pde_opt_tpu_torch/csrc/ac_cas_macro.cu",
           "gpe_strang_macro": "pde_opt_tpu_torch/csrc/gpe_strang_macro.cu",
           "bv_cc_macro": "pde_opt_tpu_torch/csrc/bv_cc_macro.cu",
           "sbm_bv_macro": "pde_opt_tpu_torch/csrc/sbm_bv_macro.cu",
           "ch_rhs_fd": "pde_opt_tpu_torch/csrc/ch_rhs_fd.cu",
           "ch_sif_macro": "pde_opt_tpu_torch/csrc/ch_sif_macro.cu",
           "ac_sif_macro": "pde_opt_tpu_torch/csrc/ac_sif_macro.cu"}
# kernel (launch-count name) -> (library, the TPU kernel it replaces)
KERNELS = {
    "ch_cas_macro_ep": ("ch_cas_macro", "pde_opt_tpu/ops/cas_spectral.py:630"),
    "ch_cas_macro": ("ch_cas_macro", "pde_opt_tpu/ops/cas_spectral.py:392"),
    "ch_cas_macro_bwd": ("ch_cas_macro", "pde_opt_tpu/ops/cas_spectral.py:411"),
    "ac_cas_macro_ep": ("ac_cas_macro", "pde_opt_tpu/ops/cas_spectral.py:1014"),
    "ac_cas_macro": ("ac_cas_macro", "pde_opt_tpu/ops/cas_spectral.py:981"),
    "gpe_strang_macro_ep": ("gpe_strang_macro", "pde_opt_tpu/ops/gpe_cas.py:393"),
    "gpe_strang_macro": ("gpe_strang_macro", "pde_opt_tpu/ops/gpe_cas.py:371"),
    "bv_cc_macro_ep": ("bv_cc_macro", "pde_opt_tpu/ops/bv_cas.py:208"),
    "bv_cc_macro": ("bv_cc_macro", "pde_opt_tpu/ops/bv_cas.py:193"),
    "sbm_bv_macro_ep": ("sbm_bv_macro", "pde_opt_tpu/ops/sbm_bv.py:244"),
    "sbm_bv_macro": ("sbm_bv_macro", "pde_opt_tpu/ops/sbm_bv.py:228"),
    "ch_rhs_fd": ("ch_rhs_fd", "pde_opt_tpu/ops/fused.py:154"),
    "ch3d_rhs_fd": ("ch_rhs_fd", "pde_opt_tpu/ops/fused.py:264"),
    "ch_sif_macro": ("ch_sif_macro", "pde_opt_tpu/ops/fused_spectral.py:340"),
    "ac_sif_macro": ("ac_sif_macro", "pde_opt_tpu/ops/fused_spectral.py:546"),
}
# Training path: bench.py's train_grad config and the optimize run.
TG_ENVS, TG_CALLS, OPT_STEPS, OPT_TS = 1024, 3, 5, (0.0, 0.01, 0.02)
# K3 vs its plain backward, each error relative to its maximum (du, dkappa),
# measured plus headroom: f32 is the same arithmetic (du 5.9e-7, dkappa
# 3.7e-5 measured on an H100); with bf16 matrices and the training loss's
# cotangent, du 3.5e-7 and dkappa 4.2e-3 for the FMA kernel, whose f32 sums
# ran in cuBLAS's order.  With bf16 matrices the sweep rounds gbar (about 1,
# bf16 ulp 7.8e-3) to bf16 every substep, so sums in another order flip a
# rounding now and then, and one flip moves du by about that ulp: after 10
# substeps the plain backward with its products accumulated in f64 sits
# 8.0e-3 (du) and 2.5e-2 (dkappa) from the plain one on the training fields,
# in a few of 1024 envs, as the tensor-core kernel does (H100).  So bf16 is held
# at TOL_BWD after one substep, and after 10 within TOL_BWD or twice the
# f64-accumulated control's distance, whichever is larger; the random
# cotangent (a flip moves dkappa by ~1e-2 there) is reported, not bounded.
# The tiled K3 at the NN-control path's 4096 x 128^2 sums two 64-term
# chunks a product on the tensor cores: there the plain backward with its
# products on the TF32 tensor cores sits 1.6e-2 (dkappa) from plain against
# 8.7e-3 for the f64 control (H100, scripts/torch_tiled_ab.py), so that check
# is held to twice the larger of the two controls' distances.
TOL_BWD = {"f32": (5e-6, 1e-4), "bf16": (1e-5, 1e-2)}
# AC fleet (the preset: L = 0.01 * grid, step_dt 0.01, A = 1, kappa in
# [1e-4, 1e-3]); K4 is held at the CH macro's bounds, bf16 tighter (5e-4:
# R == 1 reads 1.3e-4, R = 1 + 0.5 u^2 2.9e-4 on an H100 with the
# tensor-core kernel, 2.5e-4 with the FMA kernel before it).  A polynomial
# non-identity mobility R = 1 + 0.5 u^2 drives the 4-transform path.
AC_ENVS = 4096
AC_R_GENERAL = (1.0, 0.0, 0.5)
TOL_AC = {"f32": 1e-5, "bf16": 5e-4}
# GPE fleet (the preset: box 16, step_dt 0.02, g = 100, intensity in
# [0, 50]).  K5 against its plain version: f32 to 5e-6; with bf16 matrices
# two correct macros drift apart to the macro's own bf16 noise (a 1e-7
# relative input perturbation moves the bf16 output by 6.7e-3 at 64^2 x 10
# substeps; the kinetic propagator is unitary and damps none of it), so the
# 10-substep bf16 bounds are that noise level, against plain and against
# the oracle: they catch a broken kernel, not a misplaced rounding.
GPE_ENVS, GPE_BOX, GPE_G = 1024, 16.0, 100.0
TOL_GPE = {"f32": 5e-6, "bf16": 2e-2}
TOL_GPE_ORACLE = {"f32": 5e-6, "bf16": 3e-2}
# Rounding sites, bf16 matrices.  After 10 substeps a kernel that rounds in
# the wrong places, or not at all, sits about as far from the plain version
# as a correct one (GPE: the same max, RMS and share of pixels above 1e-3;
# AC: within 2x), so K4 and K5 are also held after ONE substep, by the RMS of
# kernel - plain over the fleet.  The bound must lie below the same RMS of
# the control, the plain version with the rounding off (what a kernel that
# ignores it computes), which every run measures.
TOL_SITE = {"ac_r1": 2e-6, "ac_general": 6e-6, "gpe": 5e-5, "bv": 2e-7}
# K2 and K3 (du, dkappa) after one substep, loss cotangent (measured on an
# H100: K2 rms 2.4e-6 against the control's 8.8e-4; K3 du 4.7e-8 against
# 2.0e-3, dkappa 5.1e-6 against 5.6e-2).
TOL_SITE.update({"ch": 2e-5, "ch_bwd": (5e-7, 1e-4)})
FLEET_STEPS_NO_EP = 10          # steps of each fleet without the epilogue
# BV and SBM fleets (the presets: box 1, h = 1/64, kappa 5e-4, step_dt 5e-3,
# dt 5e-4, C-rate in [0.2, 3], 40-step episodes).  K6 and K7 against their
# plain versions: same arithmetic, sums in another order (measured on an
# H100: K6 8.9e-8 with f32 matrices, 4.1e-6 with bf16 after 10 substeps; K7
# 8.9e-8); against the roll-stencil oracles the JAX tests' 2e-5 (the cas
# Laplacian equals the roll stencil's for periodic fields).  The galvanostatic
# closure makes d(sum psi c cell)/dt equal the C-rate at every RK stage, so
# the charging check's 5% (the JAX tests') holds with room.
BV_ENVS, SBM_ENVS, BV_KAPPA, BV_DT = 2048, 1024, 5e-4, 5e-4
TOL_BV = {"f32": 1e-5, "bf16": 1e-4}
TOL_BV_ORACLE = 2e-5
# Grids below 64 x 64 on the tensor-core kernels of K1-K6 (bf16 matrices,
# zero-padded to 64 in shared memory), at the paths' env counts.
SMALL_GRIDS = ((16, 16), (24, 40))
SBM_SMALL = (24, 40)           # K7 beside the fleet's 64^2, a NaN env in it
# Libraries whose SASS must hold warpgroup MMA (HGMMA) instructions.
WGMMA_LIBS = ("ch_cas_macro", "ac_cas_macro", "gpe_strang_macro", "bv_cc_macro", "ch_sif_macro",
              "ac_sif_macro")
TOL_CHARGE = 0.05
# The card-side gradient (64 envs x 64^2 x 2 substeps, bf16 matrices for BV):
# value to rtol 1e-5, d/dcrate to 1e-3 of its largest entry.  Both sides run
# the same oracle backward; they differ by the forward's output (the bf16
# kernel vs its plain version, 4e-6) and the sums' order.
GRAD_ENVS, GRAD_STEPS, TOL_GRAD = 64, 2, (1e-5, 1e-3)
# The 3D general-mobility path: bench.py's ch3d_mobility_32cubed_256batch,
# uncut (256 envs x 32^3, L = 0.32, Legendre mu [0, 1, 0.5] and D [0.3, 0.2],
# kappa 0.002, A 1, stab_scale 2, dt 2.5e-4, 50 substeps a call, bf16
# matrices): 10 calls through FusedMobilitySpectral, 50 K8 launches each.
# Its unit-mobility twin is ch3d_32cubed_256batch_substeps (c^3 - c, dt 5e-7).
M3_ENVS, M3_N, M3_SUBSTEPS, M3_CALLS = 256, 32, 50, 10
M3_DT, M3_KAPPA, M3_A, M3_STAB, U3_DT = 2.5e-4, 0.002, 1.0, 2.0, 5e-7
M3_MU, M3_D = (0.0, 1.0, 0.5), (0.3, 0.2)
# K8 against its plain version, relative to max|plain| (the JAX test's
# bound, tests/test_cas_mobility.py:227-228); the 3D macro (f32 matrices, 16
# envs) against its FFT oracle and "pallas" against "xla" (the JAX tests'
# 1e-6 and 2e-5 bounds, here over 50 substeps of the bench's dt).
TOL_K8, M3_CHECK_ENVS, TOL_M3_ORACLE, TOL_M3_IMPL = 1e-5, 16, 1e-5, 2e-5
# K8 2D also at 16 x 24 (one column a lane, 24 lanes), 128^2 and 256^2 (four
# and eight columns a lane), where the row march's lanes and wraps differ.
K8_2D_SHAPES = ((64, 16, 24), (8, 128, 128), (4, 256, 256))
# K8 3D also at N1 = 2 and 10 (the march's wrap in N1 within a run of a few
# planes), on a non-cubic grid and on planes of an odd number of floats (the
# (m, d) pairs' padding), (B, N1, N2, N3) and spacings, Legendre pair.
K8_3D_SHAPES = (((M3_ENVS, 2, 32, 32), (0.01, 0.01, 0.01)),
                ((M3_ENVS, 10, 32, 32), (0.01, 0.01, 0.01)),
                ((M3_ENVS, 24, 16, 40), (0.01, 0.02, 0.03)),
                ((M3_ENVS, 4, 5, 7), (0.01, 0.02, 0.03)),
                ((M3_ENVS, 9, 9, 9), (0.01, 0.01, 0.01)))
# Per-env mass drift over the main path's 10 calls.  The flux form
# telescopes; with bf16 matrices the k = 0 mode carries rounding noise, in
# the JAX macro too: 6.3e-4 (JAX) and 5.8e-4 (the port) over 10 calls of 4
# envs of the configuration on the CPU, all of it in the first call (the
# Legendre mu is convex, so the field relaxes to uniform within it and the
# rhs vanishes).  Bounds: 5e-3 with bf16 matrices, 1e-5 with f32.
TOL_DRIFT_BF16, TOL_DRIFT_F32 = 5e-3, 1e-5
# The 2D fleet with derivs="pallas": 30 steps of the fft stepper (10 K8
# launches a step) and 5 of the fused stepper (K1, no K8).
PALLAS_FFT_STEPS, PALLAS_FUSED_STEPS = 30, 5
# The packed-DFT macros K9a (CH) and K9b (AC), selected by algo="dft": the
# main paths' shapes (4096 x 64^2 x 10, bf16 tables, the CH and AC fleets'
# kappa ranges).  Against their plain versions at the CH/AC macros' bounds;
# with f32 tables on K9_ORACLE_ENVS envs against the FFT oracle at the JAX
# test's 5e-5 (tests/test_fused_spectral.py:33); the rounding sites after one
# substep (measured on an H100 with the tensor-core kernels: K9a rms 3.1e-6
# against the control's 8.8e-4, K9b 1.9e-7 with R == 1 and 2.6e-7 with the
# polynomial R on K9_R_ENVS envs, against 8.6e-6; the FMA kernels before
# them read 2.0e-6, 4.6e-8 and 9.2e-8).
K9_ORACLE_ENVS, K9_R_ENVS, TOL_K9_ORACLE = 16, 256, 5e-5
TOL_SITE.update({"ch_sif": 2e-5, "ac_sif": 1e-6})
# The dft fleets (fused_epilogue=False, solver_parameters["algo"] = "dft"),
# one K9 launch a step; training through K9a: value+grad at TG_ENVS and
# OPT_STEPS Adam steps of PDEModel.optimize on the dft stepper.
# The repaired fault: 3 Adam steps of optimize with a Legendre mu (the
# ROADMAP's case: 16^2, f64, field amplitude 0.05, kappa 0.002, mu [0, 1,
# 0.5], objective mean(u_T^2)) on the card against the CPU, to 1e-4.
LEG_N, LEG_MU0, LEG_STEPS, TOL_LEG = 16, (0.0, 1.0, 0.5), 3, 1e-4
# The RL learners on the flagship fleet (phase 8).  PPO at bench.py's run_ppo
# shape, uncut: 4096 envs x 64^2 x 10 substeps, derivs="pallas", the fused
# epilogue (K1) with obs_downsample 4; ActorCriticMLP 256 -> 256 -> 64 in
# bf16; T = 64, 2 epochs x 4 minibatches, lr 3e-4.  PPO_WARM updates, then
# PPO_TIMED timed, the physics floor (a random-policy 64-step rollout of the
# same env, PPO_FLOOR_RUNS times), and PPO_BRACKET more timed updates around
# it.  One update's loss and gradients on a fixed trajectory (its first
# PPO_CHECK_ENVS envs, all 64 steps) on the card against the CPU, to
# TOL_RL_BF16 (the bf16 nets' bound in tests/test_torch_rl.py).  DQN
# (QNetConv, the default DQNConfig) on the flagship fleet with the actions
# {0, +1, -1} on kappa's offset, and DDPG (DeterministicActorConv,
# QCriticConv, the default DDPGConfig) on the preset itself: RL_WARM updates,
# then RL_TIMED timed.
PPO_T, PPO_WARM, PPO_TIMED, PPO_BRACKET, PPO_FLOOR_RUNS = 64, 2, 8, 4, 3
PPO_CHECK_ENVS, TOL_RL_BF16 = 256, 2e-2
RL_WARM, RL_TIMED = 2, 4
DQN_ACTIONS = {"type": "discrete", "num_actions": 3,
               "action_mapping": {0: [0.0], 1: [1.0], 2: [-1.0]}}
# The CH macros above 64^2 (the tiled K1-K3, phase 9).  Kernel against
# plain at 128^2, 96 x 136 (no multiple of 64, not square) and 256^2 (K3 at
# 128^2 alone), f32 and bf16 matrices, K1 at ds 1 and 4, one NaN env each
# (BIG_NAN_ENV), at the card bounds of phase 3 (TOL_U, stats rtol 1e-3, obs
# 1 LSB, TOL_BWD, TOL_SITE["ch"]).  Then the paths, uncut: bench.py's run_ch128
# fleet (1024 envs x 128^2 x 10 substeps, derivs="pallas", fused epilogue:
# K1), run_ch256's macro (256 envs x 256^2 x 10, dt 1e-4: K2, BIG256_CALLS
# chained calls) and run_train_grad_128's NN-control value+grad (BASELINE
# config 3: 4096 envs x 128^2 x 10, dt 1e-3, bf16: K2 + K3, NN_CALLS calls),
# its loss and gradients on NN_CHECK_ENVS envs with f32 matrices also against
# the CPU (value rtol 1e-6, gradients 1e-4 of their largest entry).  The
# kernels are timed at those paths' shapes and held against plain there too
# (bf16, the same card bounds), where a block walks several envs through its
# scratch slot.
BIG_GRIDS = ((128, 128), (96, 136), (256, 256))
BIG_CHECK_ENVS, BIG_NAN_ENV = 256, 5
FLEET128_ENVS, FLEET128_GRID, FLEET128_STEPS = 1024, 128, 30
BIG256_ENVS, BIG256_GRID, BIG256_DT, BIG256_CALLS = 256, 256, 1e-4, 20
NN_ENVS, NN_GRID, NN_DT, NN_CALLS, NN_CHECK_ENVS = 4096, 128, 1e-3, 3, 16
TOL_NN = (1e-6, 1e-4)
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores,
# f32 on the CUDA cores, HBM bandwidth.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _end_step(torch, env):
    """The step at which the f32 episode clock first reaches end_time."""
    t, n = torch.zeros((), dtype=torch.float32), 0
    while not bool(t >= env.end_time - 1e-9):
        t, n = t + env.step_dt, n + 1
    return n


def _stats_err(got, want, n_px):
    """Epilogue stats of the field epilogue (K1/K4): n_finite must agree;
    returns (relative error of s2, error of s1 over its natural scale
    sqrt(n_px * s2))."""
    _check(bool((got[:, 2] == want[:, 2]).all()), "stats n_finite differs")
    e2 = ((got[:, 1] - want[:, 1]).abs() / want[:, 1].abs()).max().item()
    e1 = ((got[:, 0] - want[:, 0]).abs() / (n_px * want[:, 1]).sqrt()).max().item()
    return e2, e1


def _rms(d):
    return d.double().pow(2).mean().sqrt().item()


def _time_pair(torch, timings, name, plain, kernel, what, card, flops=None):
    """CUDA-event times of ``kernel`` against ``plain``, in turns (plain,
    kernel, kernel, plain); the means go into ``timings[name]``.  ``flops``:
    the transform operations of one call, for the rate printed beside."""
    p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, kernel, plain))
    timings[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    line = f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms at {what}"
    if flops:
        line += f"; transforms at {flops / (timings[name][0] * 1e-3) / 1e12:.2f} TFLOP/s"
    print(f"{line} [{card}]", flush=True)


def _check_own_epilogue(line, got, own_stats, own_obs, n_px):
    """An epilogue's ``(u1, stats, obs)`` against what the kernel's own
    final field gives: stats[:, :2] against ``own_stats`` to 1e-5 relative,
    obs within 1 LSB of ``own_obs``, n_finite every pixel."""
    e_st = ((got[1][:, :2].double() - own_stats).abs() / own_stats.abs()).max().item()
    lsb = (got[2].int() - own_obs.int()).abs().max().item()
    line += f", stats max_rel_err {e_st:.3e}, obs max_lsb {lsb} (own field)"
    _check(e_st <= 1e-5 and lsb <= 1, f"{line}: epilogue")
    _check(bool((got[1][:, 2] == n_px).all()), f"{line}: n_finite")
    return line


def _moments(torch, u, w, center):
    """``[sum w (u - center), sum w (u - center)^2]`` per env, in f64."""
    uz = u.double() - center
    return torch.stack([(w * uz).sum((-2, -1)), (w * uz * uz).sum((-2, -1))], -1)


def _check_sites(name, got, want, control, bound):
    """One substep, bf16 matrices: the kernel within ``bound`` (RMS over the
    fleet) of the plain version, the unrounded control beyond it."""
    rms, ctl = _rms(got - want), _rms(control - want)
    line = (f"check {name}, 1 substep: rms(kernel - plain) {rms:.3e} <= {bound:.0e} < "
            f"rms(unrounded - plain) {ctl:.3e}")
    _check(rms <= bound, f"{line}: the kernel is above the bound")
    _check(ctl > bound, f"{line}: the bound does not separate the control")
    print(line, flush=True)
    return rms, ctl


def _bound(transforms, H, W, B, mats, ew_ops, nbytes):
    """The least time (ms) the card could take for a macro, and what bounds
    it: ``transforms`` cas transforms an env (each 2 H W (H + W) operations,
    at the bf16 tensor-core peak with bf16 matrices, else the f32 peak),
    plus ``ew_ops`` elementwise operations in all at the f32 peak, against
    ``nbytes`` read and written once at the memory rate."""
    return _bound_ops(transforms * 2.0 * H * W * (H + W) * B, mats, ew_ops, nbytes)


def _bound_ops(product_ops, mats, ew_ops, nbytes):
    """``_bound`` from the products' operations in all (at the bf16
    tensor-core peak with bf16 matrices, else the f32 peak)."""
    peak = PEAK_BF16 if mats == "bf16" else PEAK_F32
    ops_s = product_ops / peak + ew_ops / PEAK_F32
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _dft_ops(H, W):
    """Operations of the products of one packed-DFT transform pair (forward
    and inverse) of one env, as K9 computes them: with W2 = W/2 + 1 kept
    columns, the forward's real-by-complex product along w (2 H W 2 W2) and
    complex product along h (8 H^2 W2), the inverse the same two in the
    other order."""
    w2 = W // 2 + 1
    return 2 * (2 * H * W * 2 * w2 + 8 * H * H * w2)


def _bounds():
    """Each kernel's bound at the shapes its path runs (this run's
    constants).  Elementwise operations are counted a pixel per substep (per
    RK stage for K6 and K7) from the kernels' code, each arithmetic
    operation or transcendental one; bytes are each input read once and
    each output written once (f32 fields and matrices, uint8 obs, 12-byte
    stats rows)."""
    n, H, W, px = SUBSTEPS, GRID, GRID, GRID * GRID
    mats = 4 * (H * H + W * W) * 4              # ch, cw, ich, icw as stored
    ep = px + 12                                 # obs and a stats row, per env

    def field(B, planes=2):
        return B * px * 4 * planes

    ch = (1 + 2 * n, 21 * px * n, mats + 2 * px * 4)     # + lam, lam2
    ac = (3 * n, 21 * px * n, mats + px * 4)
    bv = (8 * n, (4 * 33 + 2) * px * n, mats + px * 4)
    gpe_b = GPE_ENVS * px * 4 * 5                        # y in/out (x2), ctrl
    gpe_c = mats + 5 * px * 4                            # V, four phase tables
    sbm_b = 5 * px * 4                                   # the psi constants
    sbm_ew = (4 * 44 + 2) * px * n
    sif_b = (4 * H * H + 4 * W * (W // 2 + 1)) * 4
    out = {
        "ch_cas_macro_ep": _bound(ch[0], H, W, NUM_ENVS, "bf16", ch[1] * NUM_ENVS,
                                  field(NUM_ENVS) + NUM_ENVS * (4 + ep) + ch[2]),
        "ch_cas_macro": _bound(ch[0], H, W, NUM_ENVS, "bf16", ch[1] * NUM_ENVS,
                               field(NUM_ENVS) + NUM_ENVS * 4 + ch[2]),
        # K3: the forward re-run plus 5 transforms a substep backward.
        "ch_cas_macro_bwd": _bound(1 + 7 * n, H, W, TG_ENVS, "bf16", 50 * px * n * TG_ENVS,
                                   field(TG_ENVS, 3) + TG_ENVS * 8 + ch[2]),
        "ac_cas_macro_ep": _bound(ac[0], H, W, AC_ENVS, "bf16", ac[1] * AC_ENVS,
                                  field(AC_ENVS) + AC_ENVS * (4 + ep) + ac[2]),
        "ac_cas_macro": _bound(ac[0], H, W, AC_ENVS, "bf16", ac[1] * AC_ENVS,
                               field(AC_ENVS) + AC_ENVS * 4 + ac[2]),
        # K5: n + 1 propagations of 4 transforms (pr, pi; forward, inverse).
        "gpe_strang_macro_ep": _bound(4 * (n + 1), H, W, GPE_ENVS, "bf16",
                                      40 * px * n * GPE_ENVS,
                                      gpe_b + GPE_ENVS * ep + gpe_c + px * 4),
        "gpe_strang_macro": _bound(4 * (n + 1), H, W, GPE_ENVS, "bf16",
                                   40 * px * n * GPE_ENVS, gpe_b + gpe_c),
        "bv_cc_macro_ep": _bound(bv[0], H, W, BV_ENVS, "bf16", bv[1] * BV_ENVS,
                                 field(BV_ENVS) + BV_ENVS * (4 + ep) + bv[2]),
        "bv_cc_macro": _bound(bv[0], H, W, BV_ENVS, "bf16", bv[1] * BV_ENVS,
                              field(BV_ENVS) + BV_ENVS * 4 + bv[2]),
        "sbm_bv_macro_ep": _bound(0, H, W, SBM_ENVS, "f32", sbm_ew * SBM_ENVS,
                                  field(SBM_ENVS) + SBM_ENVS * (4 + ep) + sbm_b),
        "sbm_bv_macro": _bound(0, H, W, SBM_ENVS, "f32", sbm_ew * SBM_ENVS,
                               field(SBM_ENVS) + SBM_ENVS * 4 + sbm_b),
        # K8: no products.  A pixel's operations, each face flux counted
        # once: the Laplacian 4 an axis + 1 a sum, mu_tot 2, the face flux 5
        # an axis, the divergence 2 an axis + 1 a sum, and mu and D as the
        # path evaluates them: 2D c^3 - c by Horner 6 and D == 1 0 (the
        # fleet); 3D Legendre mu 11 (2c - 1, then the degree-2 recurrence)
        # and exp-Legendre D 5.  Bytes: u read once, the rhs written once,
        # kappa and the coefficients.
        "ch_rhs_fd": _bound(0, H, W, NUM_ENVS, "f32", (9 + 2 + 6 + 10 + 5) * px * NUM_ENVS,
                            field(NUM_ENVS) + NUM_ENVS * 4 + 5 * 4),
        "ch3d_rhs_fd": _bound(0, H, W, M3_ENVS, "f32",
                              (14 + 2 + 11 + 5 + 15 + 8) * M3_N**3 * M3_ENVS,
                              M3_ENVS * M3_N**3 * 4 * 2 + M3_ENVS * 4 + 5 * 4),
        # K9a: n transform pairs and the first forward (half a pair); a
        # pixel's operations mu 16 (8 FMAs), the update 1, the inverse's
        # real part 1; a kept spectral entry's (H x W2) the denominator 4,
        # cm 2, cu 2, the increment 6, the carried spectrum 2, the complex
        # combines of the two h-axis products 4.  K9b: n pairs; a pixel's
        # Laplacian 8, mu 16, g 3, the update 2; an entry's multiplier 5,
        # its product 2, the combines 4.  Bytes: the field in and out, kappa,
        # the f32 tables (four H x H, four W x W2) and lam (and lam2).
        "ch_sif_macro": _bound_ops((n + 0.5) * _dft_ops(H, W) * NUM_ENVS, "bf16",
                                   (18 * px + 20 * H * (W // 2 + 1)) * n * NUM_ENVS,
                                   field(NUM_ENVS) + NUM_ENVS * 4 + sif_b + H * (W // 2 + 1) * 8),
        "ac_sif_macro": _bound_ops(n * _dft_ops(H, W) * AC_ENVS, "bf16",
                                   (29 * px + 11 * H * (W // 2 + 1)) * n * AC_ENVS,
                                   field(AC_ENVS) + AC_ENVS * 4 + sif_b + H * (W // 2 + 1) * 4),
    }
    return out


def _bv_inputs(torch, dev, gen, B):
    """Charging fields: the preset's reset field (0.05 + 0.005 N(0, 1)) with
    each env filled further by up to 0.4, and a C-rate per env in the
    control range [0.2, 3]."""
    u = torch.clamp(0.05 + 0.005 * torch.randn((B, GRID, GRID), generator=gen, device=dev),
                    0.01, 0.99)
    u = (u + 0.4 * torch.rand((B, 1, 1), generator=gen, device=dev)).contiguous()
    return u, 0.2 + 2.8 * torch.rand((B,), generator=gen, device=dev)


def _branch_inputs(torch, dev, gen, B):
    """Fields that cross the closure's clip and floor, as an overfilled or
    emptied particle does: 0.5 + a sin(2 pi x) sin(2 pi y) on x, y = i / GRID,
    a per env in [0.49995, 0.5001], so every env's extremes lie beyond
    mu's clip (c > 1 - 1e-4, c < 1e-4) and most envs' reach j0's floor
    (c (1 - c) < 1e-6); a C-rate per env in [0.2, 3].  Smooth, so the
    Laplacian stays small and 10 RK4 substeps stay bounded."""
    s = torch.sin(2.0 * torch.pi * torch.arange(GRID, device=dev, dtype=torch.float64) / GRID)
    a = 0.49995 + 1.5e-4 * torch.rand((B, 1, 1), generator=gen, device=dev, dtype=torch.float64)
    u = (0.5 + a * s[:, None] * s[None, :]).float().contiguous()
    return u, 0.2 + 2.8 * torch.rand((B,), generator=gen, device=dev)


def _branch_pixels(u):
    """Pixels of ``u`` in mu's clip (c > 1 - 1e-4 or c < 1e-4) and in j0's
    floor (c (1 - c) < 1e-6)."""
    clip = int(((u > 1 - 1e-4) | (u < 1e-4)).sum())
    return clip, int((u * (1 - u) < 1e-6).sum())


def _check_bv(torch, dev, gen):
    """K6 against its plain version and the roll-stencil oracle at the BV
    fleet's shapes, on charging fields and on fields across the closure's
    clip and floor; returns the charging inputs and the main path's (bf16,
    charging) errors."""
    from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
    from pde_opt_tpu_torch.ops.bv_cas import (
        bv_cc_macro_cuda,
        bv_cc_macro_plain,
        bv_cc_reference,
    )
    from pde_opt_tpu_torch.ops.cas_spectral import Epilogue, cas_constants

    h = 1.0 / GRID
    inputs = {"charging": _bv_inputs(torch, dev, gen, BV_ENVS),
              "clip/floor": _branch_inputs(torch, dev, gen, BV_ENVS)}
    clip, floor = _branch_pixels(inputs["clip/floor"][0])
    print(f"K6 clip/floor fields: {clip} pixels in mu's clip, {floor} in j0's floor",
          flush=True)
    _check(clip >= BV_ENVS and floor > 0, "the clip/floor fields miss a branch")
    max_err = {"bv_cc_macro": 0.0, "bv_cc_macro_ep": 0.0}
    mats_dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    for (field, (u, cr)), (mats, mdt) in itertools.product(inputs.items(), mats_dtypes):
        consts = cas_constants(GRID, GRID, h, h, mdt, dev)
        kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA, cell=h * h, dt=BV_DT,
                  n_steps=SUBSTEPS, round_bf16=mdt == torch.bfloat16)
        for ep in (None, Epilogue(255.0, 0.0, CENTER, 1)):
            got = bv_cc_macro_cuda(u, cr, consts, epilogue=ep, **kw)
            want = bv_cc_macro_plain(u, cr, consts, epilogue=ep, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "bv_cc_macro_ep" if ep else "bv_cc_macro"
            line = f"check {name} mats={mats} {field}: u1 max_abs_err {err:.3e}"
            _check(err <= TOL_BV[mats], f"{line} > {TOL_BV[mats]}")
            if ep is not None:
                line = _check_own_epilogue(
                    line, got, _moments(torch, got[0], 1.0, CENTER),
                    torch.clamp(got[0] * 255.0, 0, 255).to(torch.uint8), GRID * GRID)
            print(line, flush=True)
            if mats == "bf16" and field == "charging":
                max_err[name] = err
        if mdt == torch.float32:
            oracle = bv_cc_reference(BV_MU, BV_J0, BV_KAPPA, h, h, BV_DT, SUBSTEPS,
                                     remat=False)(u, cr)
            err = (bv_cc_macro_cuda(u, cr, consts, **kw) - oracle).abs().max().item()
            print(f"check bv_cc_macro mats=f32 {field} vs roll-stencil oracle: "
                  f"max_abs_err {err:.3e}", flush=True)
            _check(err <= TOL_BV_ORACLE, f"K6 vs oracle {err} > {TOL_BV_ORACLE}")
        elif field == "charging":
            one = {**kw, "n_steps": 1}
            _check_sites("bv_cc_macro mats=bf16", bv_cc_macro_cuda(u, cr, consts, **one),
                         bv_cc_macro_plain(u, cr, consts, **one),
                         bv_cc_macro_plain(u, cr, consts, **{**one, "round_bf16": False}),
                         TOL_SITE["bv"])
    for H, W in SMALL_GRIDS:
        u = torch.clamp(0.05 + 0.005 * torch.randn((BV_ENVS, H, W), generator=gen, device=dev),
                        0.01, 0.99)
        u = (u + 0.4 * torch.rand((BV_ENVS, 1, 1), generator=gen, device=dev)).contiguous()
        cr = 0.2 + 2.8 * torch.rand((BV_ENVS,), generator=gen, device=dev)
        consts = cas_constants(H, W, 1.0 / H, 1.0 / W, torch.bfloat16, dev)
        kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA, cell=1.0 / (H * W), dt=BV_DT,
                  n_steps=SUBSTEPS, round_bf16=True)
        for ep in (None, Epilogue(255.0, 0.0, CENTER, 1)):
            got = bv_cc_macro_cuda(u, cr, consts, epilogue=ep, **kw)
            want = bv_cc_macro_plain(u, cr, consts, epilogue=ep, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "bv_cc_macro_ep" if ep else "bv_cc_macro"
            line = f"check {name} mats=bf16 {H}x{W}: u1 max_abs_err {err:.3e}"
            _check(err <= TOL_BV["bf16"], f"{line} > {TOL_BV['bf16']}")
            if ep is not None:
                line = _check_own_epilogue(
                    line, got, _moments(torch, got[0], 1.0, CENTER),
                    torch.clamp(got[0] * 255.0, 0, 255).to(torch.uint8), H * W)
            print(line, flush=True)
    return (*inputs["charging"], max_err)


def _check_sbm(torch, dev, gen, env):
    """K7 against its plain version and the roll-stencil oracle at the SBM
    fleet's shapes and psi, on charging fields and on fields across the
    closure's clip and floor; returns the charging inputs, the constants
    and the (charging) errors."""
    from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
    from pde_opt_tpu_torch.ops.sbm_bv import (
        SbmEpilogue,
        sbm_bv_constants,
        sbm_bv_macro_cuda,
        sbm_bv_macro_plain,
        sbm_bv_reference,
    )

    h = 1.0 / GRID
    inputs = {"charging": _bv_inputs(torch, dev, gen, SBM_ENVS),
              "clip/floor": _branch_inputs(torch, dev, gen, SBM_ENVS)}
    consts = sbm_bv_constants(env.static_equation_parameters["psi"], BV_KAPPA, h, h, dev)
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=BV_DT, n_steps=SUBSTEPS)
    max_err = {}
    for field, (u, cr) in inputs.items():
        for ep in (None, SbmEpilogue(255.0, CENTER)):
            got = sbm_bv_macro_cuda(u, cr, consts, epilogue=ep, **kw)
            want = sbm_bv_macro_plain(u, cr, consts, epilogue=ep, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "sbm_bv_macro_ep" if ep else "sbm_bv_macro"
            line = f"check {name} {field}: u1 max_abs_err {err:.3e}"
            _check(err <= TOL_BV["f32"], f"{line} > {TOL_BV['f32']}")
            if ep is not None:
                # The psi-weighted epilogue against the kernel's own final field.
                line = _check_own_epilogue(
                    line, got, _moments(torch, got[0], consts.psic.double(), CENTER),
                    torch.clamp(got[0] * consts.psi * 255.0, 0, 255).to(torch.uint8),
                    GRID * GRID)
            print(line, flush=True)
            if field == "charging":
                max_err[name] = err
        oracle = sbm_bv_reference(BV_MU, BV_J0, BV_KAPPA, consts.psi, h, h, BV_DT, SUBSTEPS,
                                  remat=False)(u, cr)
        err = (sbm_bv_macro_cuda(u, cr, consts, **kw) - oracle).abs().max().item()
        print(f"check sbm_bv_macro {field} vs roll-stencil oracle: max_abs_err {err:.3e}",
              flush=True)
        _check(err <= TOL_BV_ORACLE, f"K7 vs oracle {err} > {TOL_BV_ORACLE}")
    _check_sbm_small(torch, dev, gen)
    return (*inputs["charging"], consts, max_err)


def _check_sbm_small(torch, dev, gen):
    """K7 at SBM_SMALL (H != W, so the tiles' wraps at both seams differ)
    on the preset's disk psi of that grid: charging fields with one NaN env,
    against plain (epilogue on and off; the NaN must stay in its env) and
    the roll-stencil oracle on the finite envs."""
    from pde_opt_tpu_torch import grid as gridmod
    from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU, sbm_disk_psi
    from pde_opt_tpu_torch.ops.sbm_bv import (
        SbmEpilogue,
        sbm_bv_constants,
        sbm_bv_macro_cuda,
        sbm_bv_macro_plain,
        sbm_bv_reference,
    )

    H, W = SBM_SMALL
    hx, hy = 1.0 / H, 1.0 / W
    psi = sbm_disk_psi(gridmod.Domain((H, W), ((-0.5, 0.5), (-0.5, 0.5)), "dimensionless",
                                      dtype=torch.float32))
    consts = sbm_bv_constants(psi, BV_KAPPA, hx, hy, dev)
    u = torch.clamp(0.05 + 0.005 * torch.randn((SBM_ENVS, H, W), generator=gen, device=dev),
                    0.01, 0.99)
    u = (u + 0.4 * torch.rand((SBM_ENVS, 1, 1), generator=gen, device=dev)).contiguous()
    u[0, 3, 7] = float("nan")
    cr = 0.2 + 2.8 * torch.rand((SBM_ENVS,), generator=gen, device=dev)
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=BV_DT, n_steps=SUBSTEPS)
    for ep in (None, SbmEpilogue(255.0, CENTER)):
        got = sbm_bv_macro_cuda(u, cr, consts, epilogue=ep, **kw)
        want = sbm_bv_macro_plain(u, cr, consts, epilogue=ep, **kw)
        torch.cuda.synchronize()
        if ep is None:
            got, want = (got,), (want,)
        name = "sbm_bv_macro_ep" if ep else "sbm_bv_macro"
        err = (got[0][1:] - want[0][1:]).abs().max().item()
        line = f"check {name} {H}x{W}, env 0 NaN: u1 max_abs_err {err:.3e} (finite envs)"
        _check(torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
               and bool(torch.isnan(got[0][0]).all())
               and not bool(torch.isnan(got[0][1:]).any()), f"{line}: the NaN left its env")
        _check(err <= TOL_BV["f32"], f"{line} > {TOL_BV['f32']}")
        if ep is not None:
            line = _check_own_epilogue(
                line, tuple(t[1:] for t in got),
                _moments(torch, got[0][1:], consts.psic.double(), CENTER),
                torch.clamp(got[0][1:] * consts.psi * 255.0, 0, 255).to(torch.uint8), H * W)
            _check(float(got[1][0, 2]) == 0.0, f"{line}: the NaN env's n_finite")
        print(line, flush=True)
    oracle = sbm_bv_reference(BV_MU, BV_J0, BV_KAPPA, consts.psi, hx, hy, BV_DT, SUBSTEPS,
                              remat=False)(u[1:], cr[1:])
    err = (sbm_bv_macro_cuda(u, cr, consts, **kw)[1:] - oracle).abs().max().item()
    print(f"check sbm_bv_macro {H}x{W} vs roll-stencil oracle: max_abs_err {err:.3e} "
          f"(finite envs)", flush=True)
    _check(err <= TOL_BV_ORACLE, f"K7 {H}x{W} vs oracle {err} > {TOL_BV_ORACLE}")


def _check_charging(torch, env, gen, name):
    """From a fresh fleet driven 10 random-policy steps (so each env has its
    own C-rate and a partly filled particle), one zero-action step: each env
    that did not reset charges at its own C-rate, d(sum psi c cell)/dt =
    Crate (psi = 1 without a level set).  Late in an episode a particle at
    a high C-rate overfills, the closure's two integrals grow by orders of
    magnitude and their f32 difference loses the balance before the env
    diverges, so the check is made early in the episode, as the JAX test
    makes it (one step after reset)."""
    state, _ = env.reset(gen)
    state, _, _ = env.make_rollout(lambda o, g: env.sample_actions(g), 10)(state, gen)
    psi = env.static_equation_parameters.get("psi", 1.0)
    cell = float(env.domain.dx[0]) * float(env.domain.dx[1])
    crate = state.control_value.clone()
    q0 = (psi * state.y).sum((-2, -1)) * cell
    B = env.num_envs
    state, _, _, terminated, _, _ = env.step(
        state, torch.zeros((B, 1), device=state.y.device))
    q1 = (psi * state.y).sum((-2, -1)) * cell
    kept = ~terminated
    rel = (((q1 - q0) / env.step_dt - crate).abs() / crate)[kept].max().item()
    print(f"{name}: charging on a zero-action step (the 11th of an episode) over "
          f"{int(kept.sum())} envs: "
          f"max |d(sum psi c cell)/dt - Crate| / Crate {rel:.3e}", flush=True)
    _check(int(kept.sum()) > 0 and rel <= TOL_CHARGE, f"{name}: charge balance {rel}")


def _check_late(torch, env, state, name, kernel, plain, oracle, tol):
    """From a rollout's final state (many envs late in their episode; a
    random policy near C-rate 3 drives some SBM particles to overfill, into
    mu's clip and j0's floor), one macro through the kernel, its plain
    version and the f64 roll-stencil oracle.  The kernel must agree with
    plain within ``tol`` on every env plain keeps finite, and be non-finite
    on the same envs.  Each version's charge balance |d(sum psi c cell)/dt -
    Crate| / Crate is reported (no bound: late in an episode the f32
    closure may lose it, and the f64 oracle shows whether the arithmetic or
    the dynamics does)."""
    u, crate = state.y.contiguous(), state.control_value.contiguous()
    psi = env.static_equation_parameters.get("psi", 1.0)
    cell = float(env.domain.dx[0]) * float(env.domain.dx[1])
    clip, floor = _branch_pixels(u)
    got, want = kernel(u, crate), plain(u, crate)
    ref = oracle(u.double(), crate.double())
    torch.cuda.synchronize()
    fin_k, fin_p = (torch.isfinite(x).all((-2, -1)) for x in (got, want))
    _check(torch.equal(fin_k, fin_p), f"{name} late state: kernel and plain differ in "
                                      "which envs stay finite")
    err = (got - want)[fin_p].abs().max().item()
    line = (f"check {name} late state (step counts {int(state.step_count.min())}-"
            f"{int(state.step_count.max())}; {clip} pixels in mu's clip, {floor} in j0's "
            f"floor): kernel vs plain max_abs_err {err:.3e} over {int(fin_p.sum())} finite envs")
    _check(err <= tol, f"{line} > {tol}")
    print(line, flush=True)
    q0 = (psi * u.double()).sum((-2, -1)) * cell
    area = float((psi * torch.ones_like(u[0], dtype=torch.float64)).sum()) * cell
    worst = None
    for what, u1 in (("kernel", got), ("plain", want), ("f64 oracle", ref)):
        rate = ((psi * u1.double()).sum((-2, -1)) * cell - q0) / env.step_dt
        rel = (rate - crate.double()).abs() / crate.double()
        fin = torch.isfinite(rel)
        if worst is None:
            worst = int(torch.where(fin, rel, -1.0).argmax())
        print(f"{name} late state, {what}: charge balance max rel err "
              f"{rel[fin].max().item():.3e} over {int(fin.sum())} finite envs, "
              f"{int((rel[fin] > TOL_CHARGE).sum())} above {TOL_CHARGE}; at the kernel's worst "
              f"env {worst} (C-rate {float(crate[worst]):.3f}, fill "
              f"{float(q0[worst]) / area:.4f}): {float(rel[worst]):.3e}", flush=True)
    return err


def _check_card_grad(torch, dev, gen, name, make_macro):
    """Value and gradient of sum(macro(u, crate)^2) with respect to crate:
    the kernel forward and the oracle backward on the card against the same
    call on the CPU."""
    u, cr = _bv_inputs(torch, dev, gen, GRAD_ENVS)
    macro = make_macro()

    def value_grad(uu, cc):
        cc = cc.clone().requires_grad_()
        v = (macro(uu, cc) ** 2).sum()
        v.backward()
        return v.detach(), cc.grad

    v_gpu, g_gpu = value_grad(u, cr)
    v_cpu, g_cpu = value_grad(u.cpu(), cr.cpu())
    e_v = abs(float(v_gpu) - float(v_cpu)) / abs(float(v_cpu))
    e_g = ((g_gpu.cpu() - g_cpu).abs().max() / g_cpu.abs().max()).item()
    line = (f"check {name} value+grad wrt crate on the card vs the CPU ({GRAD_ENVS} envs x "
            f"{GRID}^2 x {GRAD_STEPS} substeps): value rel_err {e_v:.3e}, grad max_err / "
            f"max|grad| {e_g:.3e}")
    _check(bool(torch.isfinite(g_gpu).all()) and e_v <= TOL_GRAD[0] and e_g <= TOL_GRAD[1],
           f"{line} > {TOL_GRAD}")
    print(line, flush=True)


def _bwd_errs(got, want):
    """The (du, dkappa) max errors of ``got`` against ``want``, each relative
    to want's largest entry."""
    return tuple(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))


def _bwd_f64_accumulated(torch, u, kap, g, consts, kw, tensor_cores=False):
    """The plain CH backward with every product accumulated in f64 and
    rounded once to f32: a second correct bf16 backward, at the same
    rounding sites, whose distance from the plain version is the control of
    K3's bf16 check.  With ``tensor_cores`` a third: every product on the
    TF32 tensor cores instead, whose operands (bf16 values) TF32 holds
    exactly, so the products are exact and summed in the tensor cores' f32,
    the arithmetic of the kernel's wgmma."""
    from unittest import mock

    from pde_opt_tpu_torch.ops import cas_spectral

    def mm(a, b):
        return a @ b if tensor_cores else torch.matmul(a.double(), b.double()).float()

    def transforms(c, round_bf16):
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32)

        def tr(z, mh, mw):
            t = rnd(mm(rnd(z).transpose(-1, -2), mh))
            return mm(t.transpose(-1, -2), mw)

        return (lambda z: tr(z, c.ch, c.cw), lambda z: tr(z, c.ich, c.icw))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tensor_cores
    try:
        with mock.patch.object(cas_spectral, "_transforms", transforms):
            return cas_spectral.ch_cas_macro_bwd_plain(u, kap, g, consts, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _check_bwd_bf16(torch, line, got, want, alt, alt_tc=None):
    """K3 with bf16 matrices against its plain backward after n substeps on
    the loss's cotangent: each of du and dkappa within TOL_BWD["bf16"] or
    twice the f64-accumulated control's distance from plain, whichever is
    larger (see TOL_BWD); with ``alt_tc`` (the tensor-core control of
    _bwd_f64_accumulated), twice the larger control's.  Returns the
    errors."""
    e, c = _bwd_errs(got, want), _bwd_errs(alt, want)
    c_tc = (0.0, 0.0) if alt_tc is None else _bwd_errs(alt_tc, want)
    bounds = [max(t, 2.0 * ci, 2.0 * cj) for t, ci, cj in zip(TOL_BWD["bf16"], c, c_tc)]
    rms = [_rms(a - b) / _rms(b) for a, b in zip(got, want)]

    def envs_off(du):
        """Envs with a du pixel off plain's by more than TOL_BWD of max|du|."""
        d = (du - want[0]).abs().amax((-2, -1))
        return int((d > TOL_BWD["bf16"][0] * want[0].abs().max()).sum())

    tc = "" if alt_tc is None else f"tensor-core plain {c_tc[0]:.3e}, {c_tc[1]:.3e}; "
    line += (f": du max_rel_err {e[0]:.3e} (rms {rms[0]:.3e}, {envs_off(got[0])} of "
             f"{len(got[1])} envs above {TOL_BWD['bf16'][0]:.0e}), dkappa max_rel_err {e[1]:.3e}; "
             f"f64-accumulated plain {c[0]:.3e} ({envs_off(alt[0])} envs), {c[1]:.3e}; {tc}"
             f"bounds {bounds[0]:.3e}, {bounds[1]:.3e}")
    _check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
           f"{line}: non-finite")
    _check(e[0] <= bounds[0] and e[1] <= bounds[1], line)
    print(line, flush=True)
    return e


def _check_ch_small(torch, dev, gen, kap, kap_tg):
    """K1, K2 and K3 with bf16 matrices (the tensor-core kernels' zero
    padding) at grids below 64 x 64, at the serving and training env counts;
    K3 on the loss's cotangent."""
    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        cas_constants,
        ch_cas_macro_bwd_cuda,
        ch_cas_macro_bwd_plain,
        ch_cas_macro_cuda,
        ch_cas_macro_plain,
    )

    for H, W in SMALL_GRIDS:
        us = 0.45 + 0.05 * torch.randn((NUM_ENVS, H, W), generator=gen, device=dev)
        consts = cas_constants(H, W, HX, HY, torch.bfloat16, dev)
        kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
        for ep in (None, Epilogue(255.0, 0.0, CENTER, 1), Epilogue(255.0, 0.0, CENTER, 4)):
            got = ch_cas_macro_cuda(us, kap, consts, epilogue=ep, **kw)
            want = ch_cas_macro_plain(us, kap, consts, epilogue=ep, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "ch_cas_macro_ep" if ep else "ch_cas_macro"
            line = (f"check {name} mats=bf16 ds={ep.ds if ep else '-'} {H}x{W}: u1 max_abs_err "
                    f"{err:.3e}")
            _check(err <= TOL_U["bf16"], f"{line} > {TOL_U['bf16']}")
            if ep is not None:
                _check(torch.equal(got[1][:, 2], want[1][:, 2]), f"{line}: n_finite differs")
                rel = ((got[1][:, :2] - want[1][:, :2]).abs() / want[1][:, :2].abs()).max().item()
                lsb = (got[2].int() - want[2].int()).abs().max().item()
                line += f", stats max_rel_err {rel:.3e}, obs max_lsb {lsb}"
                _check(rel <= 1e-3 and lsb <= 1, f"{line}: epilogue bounds")
            print(line, flush=True)
        ub = (0.5 + 0.01 * torch.randn((TG_ENVS, H, W), generator=gen, device=dev)).contiguous()
        g = 2.0 * ch_cas_macro_plain(ub, kap_tg, consts, **kw)
        got = ch_cas_macro_bwd_cuda(ub, kap_tg, g, consts, **kw)
        want = ch_cas_macro_bwd_plain(ub, kap_tg, g, consts, **kw)
        torch.cuda.synchronize()
        _check_bwd_bf16(torch, f"check ch_cas_macro_bwd mats=bf16 cotangent=loss {H}x{W}", got,
                        want, _bwd_f64_accumulated(torch, ub, kap_tg, g, consts, kw))


def _check_ac(torch, dev, gen):
    """K4 against its plain version and the FFT oracle at the AC fleet's
    shapes; returns the inputs and the main path's (R == 1, bf16) errors."""
    from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        PolynomialMu,
        ac_cas_macro_cuda,
        ac_cas_macro_plain,
        cas_constants,
        r_is_identity,
    )
    from pde_opt_tpu_torch.ops.fused_spectral import ac_sif_macro_reference

    u = 0.1 * torch.randn((AC_ENVS, GRID, GRID), generator=gen, device=dev)
    kap = 1e-4 + 9e-4 * torch.rand((AC_ENVS,), generator=gen, device=dev)
    max_err = {"ac_cas_macro": 0.0, "ac_cas_macro_ep": 0.0}
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = cas_constants(GRID, GRID, HX, HY, mdt, dev)
        for rname, R in (("1", AC_R), ("1+0.5u^2", PolynomialMu(AC_R_GENERAL))):
            kw = dict(mu_fn=AC_MU, R_fn=R, r_identity=r_is_identity(R), dt=DT, A=A,
                      n_steps=SUBSTEPS, round_bf16=mdt == torch.bfloat16)
            for ep in (None, Epilogue(127.5, 127.5, 0.0, 1)):
                got = ac_cas_macro_cuda(u, kap, consts, epilogue=ep, **kw)
                want = ac_cas_macro_plain(u, kap, consts, epilogue=ep, **kw)
                torch.cuda.synchronize()
                if ep is None:
                    got, want = (got,), (want,)
                err = (got[0] - want[0]).abs().max().item()
                name = "ac_cas_macro_ep" if ep else "ac_cas_macro"
                line = f"check {name} mats={mats} R={rname}: u1 max_abs_err {err:.3e}"
                _check(err <= TOL_AC[mats], f"{line} > {TOL_AC[mats]}")
                if ep is not None:
                    e2, e1 = _stats_err(got[1], want[1], GRID * GRID)
                    lsb = (got[2].int() - want[2].int()).abs().max().item()
                    line += (f", stats s2 max_rel_err {e2:.3e}, s1 err/sqrt(n s2) {e1:.3e}, "
                             f"obs max_lsb {lsb}")
                    _check(e2 <= 1e-3 and e1 <= 1e-3, f"{line}: stats bound 1e-3")
                    _check(lsb <= 1, f"{line}: obs > 1 LSB")
                print(line, flush=True)
                if mats == "bf16" and R is AC_R:
                    max_err[name] = err
            if mdt == torch.bfloat16:
                one = {**kw, "n_steps": 1}
                _check_sites(f"ac_cas_macro mats=bf16 R={rname}",
                             ac_cas_macro_cuda(u, kap, consts, **one),
                             ac_cas_macro_plain(u, kap, consts, **one),
                             ac_cas_macro_plain(u, kap, consts, **{**one, "round_bf16": False}),
                             TOL_SITE["ac_r1" if R is AC_R else "ac_general"])
            oracle = ac_sif_macro_reference(AC_MU, R, HX, HY, A, DT, SUBSTEPS)(u, kap)
            err = (ac_cas_macro_cuda(u, kap, consts, **kw) - oracle).abs().max().item()
            print(f"check ac_cas_macro mats={mats} R={rname} vs FFT oracle: max_abs_err {err:.3e}",
                  flush=True)
            _check(err <= TOL_ORACLE[mats], f"K4 vs FFT oracle {err} > {TOL_ORACLE[mats]}")
    for H, W in SMALL_GRIDS:
        us = 0.1 * torch.randn((AC_ENVS, H, W), generator=gen, device=dev)
        consts = cas_constants(H, W, HX, HY, torch.bfloat16, dev)
        for (rname, R), ep in itertools.product(
                (("1", AC_R), ("1+0.5u^2", PolynomialMu(AC_R_GENERAL))),
                (None, Epilogue(127.5, 127.5, 0.0, 1))):
            kw = dict(mu_fn=AC_MU, R_fn=R, r_identity=r_is_identity(R), dt=DT, A=A,
                      n_steps=SUBSTEPS, round_bf16=True, epilogue=ep)
            got = ac_cas_macro_cuda(us, kap, consts, **kw)
            want = ac_cas_macro_plain(us, kap, consts, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "ac_cas_macro_ep" if ep else "ac_cas_macro"
            line = f"check {name} mats=bf16 R={rname} {H}x{W}: u1 max_abs_err {err:.3e}"
            _check(err <= TOL_AC["bf16"], f"{line} > {TOL_AC['bf16']}")
            if ep is not None:
                e2, e1 = _stats_err(got[1], want[1], H * W)
                lsb = (got[2].int() - want[2].int()).abs().max().item()
                line += (f", stats s2 max_rel_err {e2:.3e}, s1 err/sqrt(n s2) {e1:.3e}, "
                         f"obs max_lsb {lsb}")
                _check(e2 <= 1e-3 and e1 <= 1e-3 and lsb <= 1, f"{line}: epilogue bounds")
            print(line, flush=True)
    return u, kap, max_err


def _check_gpe(torch, dev, gen, env):
    """K5 against its plain version and the FFT oracle at the GPE fleet's
    shapes (the preset's reset state, trap, spot and an intensity per env in
    its control range); returns the inputs and the main path's (bf16, phase
    polynomials) errors."""
    from pde_opt_tpu_torch.ops.gpe_cas import (
        GpeEpilogue,
        gpe_constants,
        gpe_strang_fast_reference,
        gpe_strang_macro_cuda,
        gpe_strang_macro_plain,
    )

    y = env.reset(gen)[0].y.clone()
    X, Y = (torch.from_numpy(m).to(dev) for m in env.domain.mesh())
    V = (0.5 * (X**2 + Y**2)).contiguous()
    spot = env.fused_epilogue["weight"]
    ctrl = ((50.0 * torch.rand((GPE_ENVS,), generator=gen, device=dev))[:, None, None]
            * spot).contiguous()
    dx, dt = float(env.domain.dx[0]), env.dt_sub
    max_err = {"gpe_strang_macro": 0.0, "gpe_strang_macro_ep": 0.0}
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = gpe_constants(GRID, GRID, dx, dt, mdt, dev)
        for poly in (True, False):
            for ep in (None, GpeEpilogue(2550.0, spot)):
                kw = dict(g=GPE_G, dt=dt, dx=dx, n_steps=SUBSTEPS,
                          round_bf16=mdt == torch.bfloat16, phase_poly=poly, epilogue=ep)
                got = gpe_strang_macro_cuda(y, ctrl, V, consts, **kw)
                want = gpe_strang_macro_plain(y, ctrl, V, consts, **kw)
                torch.cuda.synchronize()
                if ep is None:
                    got, want = (got,), (want,)
                err = (got[0] - want[0]).abs().max().item()
                rho = got[0][..., 0] ** 2 + got[0][..., 1] ** 2
                norm_err = (rho.sum((-2, -1)) * dx * dx - 1.0).abs().max().item()
                name = "gpe_strang_macro_ep" if ep else "gpe_strang_macro"
                line = (f"check {name} mats={mats} phase_poly={poly}: y1 max_abs_err {err:.3e}, "
                        f"max |norm - 1| {norm_err:.3e}")
                _check(err <= TOL_GPE[mats], f"{line} > {TOL_GPE[mats]}")
                _check(norm_err <= 1e-5, f"{line}: norm off by more than 1e-5")
                if ep is not None:
                    # The epilogue against the kernel's own final state.
                    own = torch.stack([(rho * spot).sum((-2, -1)), rho.sum((-2, -1))], -1)
                    line = _check_own_epilogue(
                        line, got, own, torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8),
                        GRID * GRID)
                    _check(got[2].shape == (GPE_ENVS, GRID, GRID) and got[2].dtype == torch.uint8,
                           f"{line}: obs shape/dtype")
                print(line, flush=True)
                if mats == "bf16" and poly:
                    max_err[name] = err
            if mdt == torch.bfloat16:
                one = dict(g=GPE_G, dt=dt, dx=dx, n_steps=1, phase_poly=poly)
                _check_sites(f"gpe_strang_macro mats=bf16 phase_poly={poly}",
                             gpe_strang_macro_cuda(y, ctrl, V, consts, round_bf16=True, **one),
                             gpe_strang_macro_plain(y, ctrl, V, consts, round_bf16=True, **one),
                             gpe_strang_macro_plain(y, ctrl, V, consts, round_bf16=False, **one),
                             TOL_SITE["gpe"])
        oracle = gpe_strang_fast_reference(V, GPE_G, dx, dt, SUBSTEPS, remat=False)(y, ctrl)
        got = gpe_strang_macro_cuda(y, ctrl, V, consts, g=GPE_G, dt=dt, dx=dx, n_steps=SUBSTEPS,
                                    round_bf16=mdt == torch.bfloat16, phase_poly=True)
        err = (got - oracle).abs().max().item()
        print(f"check gpe_strang_macro mats={mats} vs FFT oracle: max_abs_err {err:.3e}",
              flush=True)
        _check(err <= TOL_GPE_ORACLE[mats], f"K5 vs FFT oracle {err} > {TOL_GPE_ORACLE[mats]}")
    for H, W in SMALL_GRIDS:
        _check_gpe_small(torch, dev, gen, H, W)
    return y, ctrl, V, spot, max_err


def _check_gpe_small(torch, dev, gen, H, W):
    """K5 with bf16 matrices (the tensor-core kernel's zero padding) on an
    H x W grid at the fleet's env count, epilogue on and off: the preset's
    reset state on that grid (a Gaussian on the 16-wide box, noise added, unit
    norm), its trap, a spot control per env in the control range."""
    from pde_opt_tpu_torch.ops.gpe_cas import (
        GpeEpilogue,
        gpe_constants,
        gpe_strang_macro_cuda,
        gpe_strang_macro_plain,
    )

    dx = GPE_BOX / H
    xs = (torch.arange(H, device=dev) - H / 2) * dx
    ys = (torch.arange(W, device=dev) - W / 2) * dx
    X, Y = torch.meshgrid(xs, ys, indexing="ij")
    V = (0.5 * (X**2 + Y**2)).contiguous()
    spot = torch.exp(-((X - 1.0) ** 2 + Y**2)).contiguous()
    noise = 0.1 * torch.randn((GPE_ENVS, H, W, 2), generator=gen, device=dev)
    y = torch.exp(-(X**2 + Y**2) / 4)[..., None] * (torch.tensor([1.0, 0.0], device=dev) + noise)
    y = (y / ((y**2).sum((-3, -2, -1), keepdim=True) * dx * dx).sqrt()).contiguous()
    ctrl = ((50.0 * torch.rand((GPE_ENVS,), generator=gen, device=dev))[:, None, None]
            * spot).contiguous()
    consts = gpe_constants(H, W, dx, 2e-3, torch.bfloat16, dev)
    for ep in (None, GpeEpilogue(2550.0, spot)):
        kw = dict(g=GPE_G, dt=2e-3, dx=dx, n_steps=SUBSTEPS, round_bf16=True, phase_poly=True,
                  epilogue=ep)
        got = gpe_strang_macro_cuda(y, ctrl, V, consts, **kw)
        want = gpe_strang_macro_plain(y, ctrl, V, consts, **kw)
        torch.cuda.synchronize()
        if ep is None:
            got, want = (got,), (want,)
        err = (got[0] - want[0]).abs().max().item()
        name = "gpe_strang_macro_ep" if ep else "gpe_strang_macro"
        line = f"check {name} mats=bf16 {H}x{W}: y1 max_abs_err {err:.3e}"
        _check(bool(torch.isfinite(got[0]).all()) and err <= TOL_GPE["bf16"],
               f"{line} > {TOL_GPE['bf16']}")
        if ep is not None:
            rho = got[0][..., 0] ** 2 + got[0][..., 1] ** 2
            own = torch.stack([(rho * spot).sum((-2, -1)), rho.sum((-2, -1))], -1)
            line = _check_own_epilogue(line, got, own,
                                       torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8), H * W)
        print(line, flush=True)


def _episode_ends(torch, terms, end_step):
    """From a rollout's (STEPS, B) terminations: check that no episode
    outlives ``end_step`` steps; return (episodes that ended before it, all
    episodes, each env's steps since its last termination)."""
    terms = terms.cpu()
    last = torch.full((terms.shape[1],), -1, dtype=torch.long)
    early = 0
    for k in range(terms.shape[0]):
        length = k - last
        _check(bool((terms[k] | (length < end_step)).all()),
               f"an episode outlived {end_step} steps at step {k + 1}")
        early += int((terms[k] & (length < end_step)).sum())
        last = torch.where(terms[k], k, last)
    return early, int(terms.sum()), terms.shape[0] - 1 - last


def _drive_fleet(torch, kernels, env, env0, gen, name, reward_rtol, may_diverge=False):
    """One fleet's serving path: with the launch counts reset just before, a
    STEPS-step random-policy rollout of ``env`` (fused epilogue) that crosses
    the episode end and its auto-reset, then FLEET_STEPS_NO_EP steps of
    ``env0`` (no epilogue), all under sync debug mode "error"; the counts
    are read just after.  Checks the launches, the rewards, the resets, the
    epilogue reward against the env's own reward function, and a poisoned
    env.  With ``may_diverge`` an env may also end its episode early by
    diverging (the SBM fleet under a random policy overfills its particle,
    in the JAX package too): the number is reported.  Returns (final state,
    launch counts, env-steps/s)."""

    def policy(obs, g):
        return env.sample_actions(g)

    B = env.num_envs
    for e in (env, env0):          # warm the env glue and the cached constants
        st, _ = e.reset(gen)
        e.make_rollout(policy, 2)(st, gen)
    end_step = _end_step(torch, env)
    _check(end_step < STEPS, "the rollout must cross the episode end")
    state, _ = env.reset(gen)
    state0, _ = env0.reset(gen)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rewards, terms = env.make_rollout(policy, STEPS)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("error")
    state0, rew0, _ = env0.make_rollout(policy, FLEET_STEPS_NO_EP)(state0, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    print(f"{name} path: {STEPS}-step rollout of {B} envs x {GRID}^2 x {SUBSTEPS} substeps "
          f"(+{FLEET_STEPS_NO_EP} without the epilogue); episode end at step {end_step}; "
          f"launches {counts}", flush=True)
    _check(rewards.shape == (STEPS, B), "rewards shape")
    _check(bool(torch.isfinite(rewards).all()), "non-finite rewards")
    _check(bool(torch.isfinite(rew0).all()), "non-finite rewards without the epilogue")
    early, episodes, since = _episode_ends(torch, terms, end_step)
    print(f"{name}: {episodes} episodes ended, {early} of them early (diverged)", flush=True)
    _check(may_diverge or early == 0, f"{name}: {early} episodes ended early")
    _check(torch.equal(state.step_count.cpu().long(), since), "step counts after the resets")
    _check(bool(torch.isfinite(state.y).all()), "final field")
    # The epilogue's reward equals the env's own reward function on the field
    # it emitted: state.y for every env the last step did not reset.
    kept = ~terms[-1]
    _check(int(kept.sum()) > 0, "the last step reset every env")
    plain = env.reward_function(state.y)
    rel = ((rewards[-1] - plain).abs() / plain.abs())[kept].max().item()
    print(f"{name}: epilogue reward vs the reward function on the emitted field: "
          f"max_rel_err {rel:.3e}", flush=True)
    _check(rel < reward_rtol, f"{name}: epilogue reward disagrees")

    state.y[7] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    torch.cuda.synchronize()
    _check(bool(info["diverged"][7]) and (may_diverge or int(info["diverged"].sum()) == 1),
           "NaN env not flagged")
    _check(bool(terminated[7]) and float(reward[7]) == 0.0, "NaN env not terminated")
    _check(bool(torch.isfinite(state.y).all()) and int(state.step_count[7]) == 0,
           "NaN env not reset")
    _check(obs.shape == (B, 1, GRID, GRID) and obs.dtype == torch.uint8, "obs")
    print(f"{name}: poisoned env 7 flagged diverged, reward 0, reset", flush=True)
    return state, counts, B * STEPS / t_roll


def _m3_coeffs(torch, dev):
    """The 3D path's Legendre mu and D on the card, fixed (no gradient)."""
    from pde_opt_tpu_torch.models.functions import (
        ChemicalPotentialLegendrePolynomials,
        DiffusionLegendrePolynomials,
    )

    return (ChemicalPotentialLegendrePolynomials(list(M3_MU)).to(dev).requires_grad_(False),
            DiffusionLegendrePolynomials(list(M3_D)).to(dev).requires_grad_(False))


def _m3_field(torch, dev, gen, B):
    """The bench's field: clip(0.5 + 0.01 N(0, 1), 0, 1)."""
    return torch.clamp(0.5 + 0.01 * torch.randn((B, M3_N, M3_N, M3_N), generator=gen, device=dev),
                       0.0, 1.0)


def _check_k8(torch, dev, gen):
    """K8 against its plain version at the main paths' shapes: 2D at 4096 x
    64^2 with the fleet's mu/D (c^3 - c, 1), with c^3 - c and 1 + 0.5 c^2 and
    with the Legendre pair; 3D at 256 x 32^3 with the Legendre pair; each on
    the fields the paths run and on fields far outside [0, 1], where
    exp-Legendre D grows.  Returns the main paths' inputs and errors."""
    from pde_opt_tpu_torch.envs.presets import CH_D, CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
    from pde_opt_tpu_torch.ops.fused import (
        ch3d_rhs_fd_cuda,
        ch3d_rhs_fd_plain,
        ch_rhs_fd_cuda,
        ch_rhs_fd_plain,
    )

    mu3, d3 = _m3_coeffs(torch, dev)
    pairs2 = {"fleet c^3-c, 1": (CH_MU, CH_D),
              "c^3-c, 1+0.5c^2": (CH_MU, PolynomialMu((1.0, 0.0, 0.5))),
              "Legendre": (mu3, d3)}
    u2 = torch.clamp(0.5 + 0.01 * torch.randn((NUM_ENVS, GRID, GRID), generator=gen, device=dev),
                     0.0, 1.0)
    k2 = 2e-3 + 8e-3 * torch.rand((NUM_ENVS,), generator=gen, device=dev)
    u3 = _m3_field(torch, dev, gen, M3_ENVS)
    k3 = torch.full((M3_ENVS,), M3_KAPPA, device=dev)
    cases = []
    for name, (mu, D) in pairs2.items():
        wide = 0.5 + 1.5 * torch.randn(u2.shape, generator=gen, device=dev)
        for field, u in (("path", u2), ("wide", wide)):
            cases.append(("ch_rhs_fd", f"2D {NUM_ENVS}x{GRID}^2 {name} {field}", ch_rhs_fd_cuda,
                          ch_rhs_fd_plain, u, k2, dict(mu_fn=mu, D_fn=D, hx=HX, hy=HY)))
    wide = 0.5 + 1.5 * torch.randn(u3.shape, generator=gen, device=dev)
    for field, u in (("path", u3), ("wide", wide)):
        h = 0.01
        cases.append(("ch3d_rhs_fd", f"3D {M3_ENVS}x{M3_N}^3 Legendre {field}", ch3d_rhs_fd_cuda,
                      ch3d_rhs_fd_plain, u, k3, dict(mu_fn=mu3, D_fn=d3, h1=h, h2=h, h3=h)))
    for shape in K8_2D_SHAPES:
        us = torch.clamp(0.5 + 0.05 * torch.randn(shape, generator=gen, device=dev), 0.0, 1.0)
        cases.append(("ch_rhs_fd", f"2D {'x'.join(map(str, shape))} Legendre", ch_rhs_fd_cuda,
                      ch_rhs_fd_plain, us, k2[:shape[0]].contiguous(),
                      dict(mu_fn=mu3, D_fn=d3, hx=HX, hy=2 * HY)))
    for shape, (h1, h2, h3) in K8_3D_SHAPES:
        us = torch.clamp(0.5 + 0.05 * torch.randn(shape, generator=gen, device=dev), 0.0, 1.0)
        cases.append(("ch3d_rhs_fd", f"3D {'x'.join(map(str, shape))} Legendre",
                      ch3d_rhs_fd_cuda, ch3d_rhs_fd_plain, us, k3,
                      dict(mu_fn=mu3, D_fn=d3, h1=h1, h2=h2, h3=h3)))
    max_err = {}
    for name, what, cuda, plain, u, k, kw in cases:
        got, want = cuda(u, k, **kw), plain(u, k, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        line = (f"check {name} {what}: max_abs_err {err:.3e}, max|plain| {scale:.3e}, "
                f"ratio {err / scale:.3e} <= {TOL_K8}")
        _check(bool(torch.isfinite(got).all()) and err <= TOL_K8 * scale, line)
        print(line, flush=True)
        if what.endswith("path") and (name == "ch3d_rhs_fd" or "fleet" in what):
            max_err[name] = err
    return (u2, k2, pairs2["fleet c^3-c, 1"]), (u3, k3, (mu3, d3)), max_err


def _check_mobility_macro(torch, dev, gen):
    """The 3D mobility macro with f32 matrices on 16 envs of the main path's
    configuration: against its FFT oracle, "pallas" (K8) against "xla" (the
    roll chain), and its per-env mass."""
    from pde_opt_tpu_torch.ops.cas_mobility import (
        ch3d_mobility_macro_reference,
        make_ch3d_mobility_cas_macro,
    )

    mu, D = _m3_coeffs(torch, dev)
    h = 0.01
    u = _m3_field(torch, dev, gen, M3_CHECK_ENVS)
    kap = torch.full((M3_CHECK_ENVS,), M3_KAPPA, device=dev)
    args = (mu, D, M3_N, M3_N, M3_N, h, h, h, M3_A, M3_DT, M3_SUBSTEPS)
    out = {impl: make_ch3d_mobility_cas_macro(*args, stab_scale=M3_STAB, mats_dtype=torch.float32,
                                              rhs_impl=impl)(u, kap)
           for impl in ("pallas", "xla")}
    oracle = ch3d_mobility_macro_reference(mu, D, h, h, h, M3_A, M3_DT, M3_SUBSTEPS,
                                           stab_scale=M3_STAB)(u, kap)
    e_or = (out["pallas"] - oracle).abs().max().item()
    e_impl = (out["pallas"] - out["xla"]).abs().max().item()
    drift = (out["pallas"].mean((-3, -2, -1)) - u.mean((-3, -2, -1))).abs().max().item()
    moved = (out["pallas"] - u).abs().max().item()
    line = (f"check 3D mobility macro, f32 matrices, {M3_CHECK_ENVS} envs x {M3_N}^3 x "
            f"{M3_SUBSTEPS} substeps: vs FFT oracle {e_or:.3e} <= {TOL_M3_ORACLE}, pallas (K8) vs "
            f"xla {e_impl:.3e} <= {TOL_M3_IMPL}, mass drift {drift:.3e} <= {TOL_DRIFT_F32}, "
            f"max |u1 - u0| {moved:.3e}")
    _check(e_or <= TOL_M3_ORACLE and e_impl <= TOL_M3_IMPL and drift <= TOL_DRIFT_F32
           and moved > 1e-3, line)
    print(line, flush=True)


def _drive_mobility(torch, kernels, dev, gen, card):
    """The main 3D path: with the launch counts reset just before, M3_CALLS
    calls of the full configuration (PDEModel.solve on FusedMobilitySpectral,
    one save a call, per-env kappa on the card) under sync debug mode
    "error"; the counts are read just after.  Then the FFT counterpart
    (CahnHilliard3DPeriodic(derivs="fd") + SemiImplicitFourierSpectral, 3
    calls) as bench.py's run_ch3d_mobility times it, the time split of one
    call (K8, transforms, the rest), and the unit-mobility macro
    (FusedSemiImplicitSpectral3D) against its FFT path.  Returns (launch
    counts, K8 3D launches per call)."""
    from pde_opt_tpu_torch import Domain, PDEModel
    from pde_opt_tpu_torch.envs.presets import CH_D, CH_MU
    from pde_opt_tpu_torch.models import CahnHilliard3DPeriodic
    from pde_opt_tpu_torch.ops.cas3d import cas_nd_constants, cas_nd_transform
    from pde_opt_tpu_torch.ops.fused import ch3d_rhs_fd_cuda
    from pde_opt_tpu_torch.ops.integrate import evolve
    from pde_opt_tpu_torch.ops.steppers import (
        FusedMobilitySpectral,
        FusedSemiImplicitSpectral3D,
        SemiImplicitFourierSpectral,
    )
    from pde_opt_tpu_torch.utils.compat import prepare_solver_params

    mu, D = _m3_coeffs(torch, dev)
    N, B, h = M3_N, M3_ENVS, 0.01
    L = h * N
    domain = Domain((N, N, N), ((-L / 2, L / 2),) * 3, "dimensionless")
    kappa = torch.full((B, 1, 1, 1), M3_KAPPA, device=dev)
    params = {"kappa": kappa, "mu": mu, "D": D, "derivs": "fd"}
    solver_params = {"A": M3_A, "stab_scale": M3_STAB}
    model = PDEModel(CahnHilliard3DPeriodic, domain, FusedMobilitySpectral)
    ts = [i * M3_SUBSTEPS * M3_DT for i in range(M3_CALLS + 1)]
    y0 = _m3_field(torch, dev, gen, B)
    model.solve(params, y0, ts[:2], solver_params, dt0=M3_DT)        # warm the caches
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    sol = model.solve(params, y0, ts, solver_params, dt0=M3_DT)
    t_enq = time.perf_counter() - t0            # the host's enqueue, before the wait
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_cas = time.perf_counter() - t0
    counts = kernels.launch_counts()
    per_call = counts["ch3d_rhs_fd"] / M3_CALLS
    drift = (sol[-1].mean((-3, -2, -1)) - sol[0].mean((-3, -2, -1))).abs().max().item()
    moved = (sol[-1] - sol[0]).abs().max().item()
    print(f"3D mobility path: {M3_CALLS} calls of PDEModel.solve on FusedMobilitySpectral, "
          f"{B} envs x {N}^3 x {M3_SUBSTEPS} substeps, Legendre mu/D, bf16 matrices; "
          f"launches {counts}", flush=True)
    _check(sol.shape == (M3_CALLS + 1, B, N, N, N) and bool(torch.isfinite(sol).all()),
           "3D path: non-finite or misshapen solution")
    _check(counts["ch3d_rhs_fd"] == M3_CALLS * M3_SUBSTEPS,
           f"3D path: {counts['ch3d_rhs_fd']} K8 launches, expected {M3_CALLS * M3_SUBSTEPS}")
    line = (f"3D path: per-env mass drift over {M3_CALLS} calls {drift:.3e} <= {TOL_DRIFT_BF16}, "
            f"max |u - u0| {moved:.3e}")
    _check(drift <= TOL_DRIFT_BF16 and moved > 1e-3, line)
    print(line, flush=True)
    cas_rate = B * M3_SUBSTEPS * M3_CALLS / t_cas

    # The FFT counterpart, as bench.py times it: 3 calls of 50 substeps.
    eq = CahnHilliard3DPeriodic(domain, kappa, mu, D, derivs="fd")
    sif = SemiImplicitFourierSpectral(
        **prepare_solver_params(SemiImplicitFourierSpectral, {"A": M3_A}, eq))
    y = evolve(sif, eq.rhs, y0, 0.0, M3_DT, M3_SUBSTEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        y = evolve(sif, eq.rhs, y, 0.0, M3_DT, M3_SUBSTEPS)
    torch.cuda.synchronize()
    fft_rate = B * M3_SUBSTEPS * 3 / (time.perf_counter() - t0)
    _check(bool(torch.isfinite(y).all()), "3D FFT path: non-finite field")
    print(f"3D mobility path: cas {cas_rate:.1f} field-substeps/s, fft {fft_rate:.1f} "
          f"field-substeps/s, cas/fft {cas_rate / fft_rate:.2f}x ({B} envs x {N}^3 x "
          f"{M3_SUBSTEPS} substeps) [{card}]", flush=True)

    # One call's time split: the whole macro, K8 alone, the two transforms
    # alone (50 each), and the rest (the implicit multiplier, the update).
    c = cas_nd_constants((N, N, N), (h, h, h), torch.bfloat16, dev)
    kf = kappa.reshape(B)
    stepper = FusedMobilitySpectral(**prepare_solver_params(
        FusedMobilitySpectral, solver_params, CahnHilliard3DPeriodic(domain, kappa, mu, D)))
    z = sol[-1].contiguous()
    r = ch3d_rhs_fd_cuda(z, kf, mu_fn=mu, D_fn=D, h1=h, h2=h, h3=h)

    def transforms():
        for _ in range(M3_SUBSTEPS):
            cas_nd_transform(cas_nd_transform(r, c.fwd, torch.bfloat16), c.inv, torch.bfloat16)

    def k8():
        for _ in range(M3_SUBSTEPS):
            ch3d_rhs_fd_cuda(z, kf, mu_fn=mu, D_fn=D, h1=h, h2=h, h3=h)

    # K8 on two fields in turn: each launch's input (33.5 MB) and output were
    # pushed out of the 50 MB L2 by the other launch's, as the call's
    # transforms push them out between its K8 launches.
    z2 = sol[-2].contiguous()

    def k8_cold():
        for i in range(M3_SUBSTEPS):
            ch3d_rhs_fd_cuda(z if i % 2 else z2, kf, mu_fn=mu, D_fn=D, h1=h, h2=h, h3=h)

    t_call = _time_ms(torch, lambda: stepper.evolve(None, z, 0.0, M3_DT, M3_SUBSTEPS), reps=3,
                      warmup=1)
    t_k8 = _time_ms(torch, k8, reps=3, warmup=1)
    t_k8c = _time_ms(torch, k8_cold, reps=3, warmup=1)
    t_tr = _time_ms(torch, transforms, reps=3, warmup=1)
    print(f"3D mobility call split ({B} envs x {N}^3 x {M3_SUBSTEPS} substeps, bf16): call "
          f"{t_call:.4f} ms = K8 {t_k8:.4f} ms ({t_k8 / t_call:.1%}) + transforms {t_tr:.4f} ms "
          f"({t_tr / t_call:.1%}) + rest {t_call - t_k8 - t_tr:.4f} ms "
          f"({(t_call - t_k8 - t_tr) / t_call:.1%}); K8 on one field (L2-warm) "
          f"{t_k8 / M3_SUBSTEPS:.4f} ms a launch, on two in turn (L2-cold) "
          f"{t_k8c / M3_SUBSTEPS:.4f} [{card}]", flush=True)
    # The solve's host enqueue against its wall time and a call's time on
    # the card: where the enqueue takes as long as the wall, the host paces
    # the path and the card idles for the difference.  The events also count
    # any wait for the host inside their window, so the idle share is a
    # lower bound.
    wall = t_cas / M3_CALLS * 1e3
    print(f"3D mobility path: host enqueue {t_enq / M3_CALLS * 1e3:.4f} ms of a {wall:.4f} ms "
          f"call (wall), {t_call:.4f} ms on the card (events): device idle share at least "
          f"{1 - t_call / wall:.1%} [{card}]", flush=True)

    # The unit-mobility 3D macro against its FFT path (bench.py's run_ch3d).
    eq1 = CahnHilliard3DPeriodic(domain, kappa, CH_MU, CH_D, derivs="fourier")
    st1 = FusedSemiImplicitSpectral3D(**prepare_solver_params(
        FusedSemiImplicitSpectral3D, {"A": 1.0}, eq1))
    sif1 = SemiImplicitFourierSpectral(
        **prepare_solver_params(SemiImplicitFourierSpectral, {"A": 0.5}, eq1))
    y1 = (0.5 + 0.05 * torch.randn((B, N, N, N), generator=gen, device=dev))
    rates = {}
    for name, stp, runs in (("cas", st1, 10), ("fft", sif1, 3)):
        y = evolve(stp, eq1.rhs, y1, 0.0, U3_DT, M3_SUBSTEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            y = evolve(stp, eq1.rhs, y, 0.0, U3_DT, M3_SUBSTEPS)
        torch.cuda.synchronize()
        rates[name] = B * M3_SUBSTEPS * runs / (time.perf_counter() - t0)
        _check(bool(torch.isfinite(y).all()), f"3D unit-mobility {name}: non-finite field")
    print(f"3D unit-mobility macro: cas {rates['cas']:.1f} field-substeps/s, fft "
          f"{rates['fft']:.1f}, cas/fft {rates['cas'] / rates['fft']:.2f}x ({B} envs x {N}^3 x "
          f"{M3_SUBSTEPS} substeps, bf16) [{card}]", flush=True)
    return counts, per_call


def _check_m3_card_grad(torch, dev, gen):
    """Value and gradient of sum(w * macro(u, kappa)) (w random) with respect
    to kappa of the 3D mobility macro on the card (K8 forward, roll-chain
    backward) against the same call on the CPU (roll chain both ways), f32
    matrices, 4 envs x 32^3 x 2 substeps, u = 0.5 + 0.05 N(0, 1).  The
    kappa gradient is poorly conditioned in f32 (w is zero-mean, so the
    entries are sums that cancel): against the f64 FFT oracle on the CPU it
    is off by 4e-4 to 6e-4 of its largest entry on draws of this size (by
    5.8 % for sum(u1^2)), and the card rounds differently from the CPU
    (cuBLAS sums, expf), so the bound is 5e-3."""
    from pde_opt_tpu_torch.ops.cas_mobility import make_ch3d_mobility_cas_macro

    u = torch.clamp(0.5 + 0.05 * torch.randn((4, M3_N, M3_N, M3_N), generator=gen, device=dev),
                    0.0, 1.0)
    w = torch.randn(u.shape, generator=gen, device=dev)
    res = []
    for d in (dev, torch.device("cpu")):
        mu, D = _m3_coeffs(torch, d)
        macro = make_ch3d_mobility_cas_macro(mu, D, M3_N, M3_N, M3_N, 0.01, 0.01, 0.01, M3_A,
                                             M3_DT, 2, stab_scale=M3_STAB, mats_dtype=torch.float32)
        k = torch.full((4,), M3_KAPPA, device=d, requires_grad=True)
        v = (w.to(d) * macro(u.to(d), k)).sum()
        v.backward()
        res.append((v.item(), k.grad.cpu()))
    (v_card, g_card), (v_cpu, g_cpu) = res
    e_v = abs(v_card - v_cpu) / abs(v_cpu)
    e_g = ((g_card - g_cpu).abs().max() / g_cpu.abs().max()).item()
    line = (f"check 3D mobility macro value+grad wrt kappa on the card (K8 forward) vs the CPU "
            f"(4 envs x {M3_N}^3 x 2 substeps, f32): value rel_err {e_v:.3e}, grad max_err / "
            f"max|grad| {e_g:.3e}")
    _check(e_v <= 1e-5 and e_g <= 5e-3, f"{line} > (1e-5, 5e-3)")
    print(line, flush=True)


def _drive_pallas_fleet(torch, kernels, dev, gen, card):
    """The flagship CH fleet with derivs="pallas": PALLAS_FFT_STEPS steps of
    the fft stepper (K8 once a substep) and PALLAS_FUSED_STEPS of the fused
    stepper (K1, no K8), each with the launch counts reset just before and
    read just after, under sync debug mode "error".  Returns the fft run's
    counts and env-steps/s."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env

    out = {}
    for solve, derivs, steps in (("fft", "pallas", PALLAS_FFT_STEPS),
                                 ("fft", "fd", PALLAS_FFT_STEPS),
                                 ("fused", "pallas", PALLAS_FUSED_STEPS)):
        env = make_cahn_hilliard_control_env(num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                             spectral_solve=solve, derivs=derivs, device=dev)

        def policy(obs, g, env=env):
            return env.sample_actions(g)

        state, _ = env.reset(gen)
        env.make_rollout(policy, 2)(state, gen)                        # warm the env glue
        state, _ = env.reset(gen)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        state, rewards, _ = env.make_rollout(policy, steps)(state, gen)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rate = NUM_ENVS * steps / (time.perf_counter() - t0)
        counts = kernels.launch_counts()
        print(f"CH fleet derivs={derivs} spectral_solve={solve}: {steps} steps of {NUM_ENVS} envs "
              f"x {GRID}^2 x {SUBSTEPS} substeps, {rate:.1f} env-steps/s; launches {counts} "
              f"[{card}]", flush=True)
        _check(bool(torch.isfinite(rewards).all()) and bool(torch.isfinite(state.y).all()),
               f"derivs={derivs} {solve}: non-finite rewards or field")
        if derivs == "fd":                  # the same stepper on the roll chain: no kernel
            _check(sum(counts.values()) == 0, f"derivs=fd fft: launches {counts}")
            print(f"CH fleet fft stepper, derivs=pallas vs fd: {out[1] / rate:.2f}x [{card}]",
                  flush=True)
        elif solve == "fft":
            _check(counts["ch_rhs_fd"] == steps * SUBSTEPS and counts["ch_cas_macro_ep"] == 0,
                   f"derivs=pallas fft: launches {counts}")
            out = (counts, rate)
        else:
            _check(counts["ch_cas_macro_ep"] == steps and counts["ch_rhs_fd"] == 0,
                   f"derivs=pallas fused: launches {counts}")
    return out

def _check_k9(torch, dev, gen, u, kap, u_ac, kap_ac):
    """K9a against its plain version at the CH path's shapes and K9b at the
    AC fleet's (R == 1), bf16 and f32 tables; with f32 tables on
    K9_ORACLE_ENVS envs against the FFT oracle; the bf16 rounding sites
    after one substep; K9b with a polynomial R on K9_R_ENVS envs.  The
    tensor-core kernels (bf16) also at SMALL_GRIDS and at 64 x 64 with the
    full spectrum, one NaN env each.  Returns the main paths' (bf16, 10
    substeps) errors."""
    from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R, CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
    from pde_opt_tpu_torch.ops.fused_spectral import (
        ac_sif_macro_cuda,
        ac_sif_macro_plain,
        ac_sif_macro_reference,
        ch_sif_macro_cuda,
        ch_sif_macro_plain,
        ch_sif_macro_reference,
        sif_constants,
    )

    r_gen = PolynomialMu(AC_R_GENERAL)
    ch = ("ch_sif_macro", ch_sif_macro_cuda, ch_sif_macro_plain, u, kap,
          dict(mu_fn=CH_MU), ch_sif_macro_reference(CH_MU, HX, HY, A, DT, SUBSTEPS), "ch_sif")
    cases = [ch] + [
        ("ac_sif_macro", ac_sif_macro_cuda, ac_sif_macro_plain, uu, kk,
         dict(mu_fn=AC_MU, R_fn=R, r_identity=R is AC_R, hx=HX, hy=HY),
         ac_sif_macro_reference(AC_MU, R, HX, HY, A, DT, SUBSTEPS), "ac_sif")
        for R, uu, kk in ((AC_R, u_ac, kap_ac), (r_gen, u_ac[:K9_R_ENVS], kap_ac[:K9_R_ENVS]))]
    tol = {"ch_sif_macro": TOL_U, "ac_sif_macro": TOL_AC}
    max_err = {}
    for name, cuda, plain, uu, kk, extra, oracle, site in cases:
        what = f"{name} {uu.shape[0]}x{GRID}^2x{SUBSTEPS}" + (
            " R=1+0.5u^2" if extra.get("R_fn") is r_gen else "")
        for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            consts = sif_constants(GRID, GRID, HX, HY, mdt, True, dev)
            kw = dict(extra, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=mdt == torch.bfloat16)
            got, want = cuda(uu, kk, consts, **kw), plain(uu, kk, consts, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            line = f"check {what} mats={mats}: u1 max_abs_err {err:.3e}"
            _check(bool(torch.isfinite(got).all()) and err <= tol[name][mats],
                   f"{line} > {tol[name][mats]}")
            print(line, flush=True)
            if mats == "bf16":
                max_err.setdefault(name, err)
                one = {**kw, "n_steps": 1}
                _check_sites(f"{what} mats=bf16", cuda(uu, kk, consts, **one),
                             plain(uu, kk, consts, **one),
                             plain(uu, kk, consts, **{**one, "round_bf16": False}), TOL_SITE[site])
            else:
                n = K9_ORACLE_ENVS
                err = (cuda(uu[:n], kk[:n], consts, **kw) - oracle(uu[:n], kk[:n])).abs().max().item()
                line = f"check {what} mats=f32 vs FFT oracle ({n} envs): max_abs_err {err:.3e}"
                _check(err <= TOL_K9_ORACLE, f"{line} > {TOL_K9_ORACLE}")
                print(line, flush=True)
    # The spectrum's width padded to a multiple of 8 (W2 9, 21; 64 full).
    for (H, W), half in [(hw, True) for hw in SMALL_GRIDS] + [((GRID, GRID), False)]:
        consts = sif_constants(H, W, HX, HY, torch.bfloat16, half, dev)
        for name, cuda, plain, uu, kk, extra, _, _ in cases:
            x = uu[:, :H, :W].clone(memory_format=torch.contiguous_format)
            x[0, 3, 7] = float("nan")
            kw = dict(extra, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
            got, want = cuda(x, kk, consts, **kw), plain(x, kk, consts, **kw)
            torch.cuda.synchronize()
            err = (got[1:] - want[1:]).abs().max().item()
            line = (f"check {name} {x.shape[0]}x{H}x{W}x{SUBSTEPS} "
                    f"{'half' if half else 'full'} spectrum mats=bf16"
                    f"{'' if extra.get('R_fn') is not r_gen else ' R=1+0.5u^2'}, env 0 NaN: "
                    f"u1 max_abs_err {err:.3e} over the other envs")
            _check(torch.equal(torch.isnan(got), torch.isnan(want))
                   and not bool(torch.isnan(got[1:]).any()), f"{line}: the NaN left its env")
            _check(err <= tol[name]["bf16"], f"{line} > {tol[name]['bf16']}")
            print(line, flush=True)
    return max_err


def _drive_dft_fleet(torch, kernels, make_env, name, kernel, card):
    """A preset fleet on the packed-DFT macro: ``spectral_solve="fused"``,
    no fused epilogue, and ``"algo": "dft"`` in the env's solver_parameters
    (read at every step).  With the launch counts reset just before, a
    STEPS-step random-policy rollout across the episode end and its
    auto-reset under sync debug mode "error"; the counts are read just
    after: one launch of ``kernel`` a step and nothing else.  Returns
    (launch counts, env-steps/s)."""
    env = make_env(num_envs=NUM_ENVS if name == "CH" else AC_ENVS, grid_size=GRID,
                   substeps=SUBSTEPS, spectral_solve="fused", fused_epilogue=False,
                   device=torch.device("cuda"))
    env.solver_parameters["algo"] = "dft"
    gen = torch.Generator(device="cuda").manual_seed(70)

    def policy(obs, g):
        return env.sample_actions(g)

    st, _ = env.reset(gen)
    env.make_rollout(policy, 2)(st, gen)                  # warm the env glue
    end_step = _end_step(torch, env)
    _check(end_step < STEPS, "the rollout must cross the episode end")
    state, _ = env.reset(gen)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rewards, terms = env.make_rollout(policy, STEPS)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rate = env.num_envs * STEPS / (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    print(f"{name} fleet algo=dft: {STEPS}-step rollout of {env.num_envs} envs x {GRID}^2 x "
          f"{SUBSTEPS} substeps, {rate:.1f} env-steps/s; episode end at step {end_step}; "
          f"launches {counts} [{card}]", flush=True)
    _check(counts[kernel] == STEPS and sum(counts.values()) == STEPS,
           f"{name} dft fleet: launches {counts}, expected {STEPS} {kernel} and nothing else")
    _check(bool(torch.isfinite(rewards).all()) and bool(torch.isfinite(state.y).all()),
           f"{name} dft fleet: non-finite rewards or field")
    early, episodes, since = _episode_ends(torch, terms, end_step)
    _check(early == 0 and episodes >= env.num_envs, f"{name} dft fleet: {episodes} episodes "
                                                    f"ended, {early} early")
    _check(torch.equal(state.step_count.cpu().long(), since), "step counts after the resets")
    print(f"{name} fleet algo=dft: {episodes} episodes ended at the end step, rewards finite "
          "across the auto-reset", flush=True)
    return counts, rate


def _check_k9_training(torch, kernels, dev, gen, u_tg, kap_tg, card):
    """Training through K9a.  Value and gradient of sum(w * macro(u, kappa))
    (w random, independent of u) with respect to kappa at TG_ENVS x 64^2 x
    10, f32 tables: the kernel forward and the checkpointed-oracle backward
    on the card against the same call on the CPU (plain forward).  The
    bound is _check_m3_card_grad's: kappa's gradient of a sum with a
    zero-mean w cancels, so f32 rounding alone moves it by ~1e-3 of its
    largest entry, and the card's FFTs round otherwise than the CPU's.  Then
    OPT_STEPS Adam steps of PDEModel.optimize on the dft stepper (bf16
    tables), counts reset just before and read just after: K9a forward and
    its checkpoint recompute, two a segment a step.  Returns (launch counts,
    ms of a bf16 value+grad)."""
    from pde_opt_tpu_torch import Domain, PDEModel
    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.models import CahnHilliard2DPeriodic
    from pde_opt_tpu_torch.ops.fused_spectral import make_ch_sif_fused_macro
    from pde_opt_tpu_torch.ops.steppers import FusedSemiImplicitSpectral

    w = torch.randn(u_tg.shape, generator=gen, device=dev)
    res = []
    for d in (dev, torch.device("cpu")):
        macro = make_ch_sif_fused_macro(CH_MU, GRID, GRID, HX, HY, A, DT, SUBSTEPS,
                                        mats_dtype=torch.float32)
        k = kap_tg.to(d).clone().requires_grad_()
        v = (w.to(d) * macro(u_tg.to(d), k)).sum()
        v.backward()
        res.append((v.item(), k.grad.cpu()))
    (v_card, g_card), (v_cpu, g_cpu) = res
    e_v = abs(v_card - v_cpu) / abs(v_cpu)
    e_g = ((g_card - g_cpu).abs().max() / g_cpu.abs().max()).item()
    line = (f"check K9a value+grad wrt kappa on the card vs the CPU ({TG_ENVS} envs x {GRID}^2 x "
            f"{SUBSTEPS} substeps, f32 tables): value rel_err {e_v:.3e}, grad max_err / "
            f"max|grad| {e_g:.3e}")
    _check(bool(torch.isfinite(g_card).all()) and e_v <= 1e-5 and e_g <= 5e-3,
           f"{line} > (1e-5, 5e-3)")
    print(line, flush=True)

    macro = make_ch_sif_fused_macro(CH_MU, GRID, GRID, HX, HY, A, DT, SUBSTEPS)

    def value_and_grad():
        k = kap_tg.clone().requires_grad_()
        v = (macro(u_tg, k) ** 2).sum()
        v.backward()
        return v.detach(), k.grad

    grad_ms = _time_ms(torch, value_and_grad, reps=3, warmup=1)
    print(f"time value+grad dft (K9a forward, checkpointed FFT-oracle backward): {grad_ms:.4f} ms "
          f"per call, {TG_ENVS * SUBSTEPS / (grad_ms * 1e-3):.1f} grad-env-substeps/s ({TG_ENVS} "
          f"envs x {GRID}^2 x {SUBSTEPS} substeps, bf16) [{card}]", flush=True)

    L = 0.01 * GRID
    domain = Domain((GRID, GRID), ((-L / 2, L / 2), (-L / 2, L / 2)), "dimensionless")
    model = PDEModel(CahnHilliard2DPeriodic, domain, FusedSemiImplicitSpectral)
    losses = []

    def objective(sol):
        v = sol[-1].var(dim=(-2, -1), correction=0).sum()
        losses.append(v.detach())
        return v

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    res = model.optimize(
        objective, y0=u_tg, ts=OPT_TS, opt_parameters={"kappa": kap_tg},
        other_parameters={"mu": CH_MU, "D": torch.ones_like},
        solver_parameters={"A": A, "algo": "dft"}, weights={"kappa": None}, lambda_reg=0.0,
        max_steps=OPT_STEPS, dt0=DT, method="adam", learning_rate=1e-4)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n_seg = len(OPT_TS) - 1
    want = OPT_STEPS * n_seg * 2
    print(f"training path algo=dft: {OPT_STEPS} optimize steps ({n_seg} checkpointed segments of "
          f"{SUBSTEPS} substeps) at {TG_ENVS} envs x {GRID}^2; launches {counts}", flush=True)
    _check(counts["ch_sif_macro"] == want and sum(counts.values()) == want,
           f"dft training launches {counts}: expected {want} K9a and nothing else")
    moved = (res["kappa"] - kap_tg).abs()
    _check(len(losses) == OPT_STEPS and all(bool(torch.isfinite(v)) for v in losses)
           and bool(torch.isfinite(res["kappa"]).all()) and bool((moved > 0).all()),
           "dft optimize: losses and kappa must be finite and kappa must move in every env")
    print(f"optimize algo=dft: loss {float(losses[0]):.6e} -> {float(losses[-1]):.6e}; kappa "
          f"moved in every env, |change| {moved.min().item():.3e} to {moved.max().item():.3e}",
          flush=True)
    return counts, grad_ms


def _check_module_fault(torch, dev):
    """The repaired fault: a Legendre mu in opt_parameters trains.  LEG_STEPS
    Adam steps of PDEModel.optimize over kappa and mu on
    SemiImplicitFourierSpectral (the ROADMAP's case, f64), on the card and
    on the CPU: the coefficients move, agree to TOL_LEG, and the caller's
    module keeps its own."""
    import numpy as np

    from pde_opt_tpu_torch import Domain, PDEModel
    from pde_opt_tpu_torch.models import CahnHilliard2DPeriodic
    from pde_opt_tpu_torch.models.functions import ChemicalPotentialLegendrePolynomials
    from pde_opt_tpu_torch.ops.steppers import SemiImplicitFourierSpectral

    rng = np.random.default_rng(0)
    y0 = torch.from_numpy(np.clip(0.5 + 0.05 * rng.standard_normal((LEG_N, LEG_N)), 0.0, 1.0))
    ln = 0.01 * LEG_N
    model = PDEModel(CahnHilliard2DPeriodic,
                     Domain((LEG_N, LEG_N), ((-ln / 2, ln / 2),) * 2, dtype=torch.float64),
                     SemiImplicitFourierSpectral)
    out = []
    for d in (dev, torch.device("cpu")):
        mu0 = ChemicalPotentialLegendrePolynomials(
            torch.tensor(LEG_MU0, dtype=torch.float64, device=d))
        res = model.optimize(
            lambda s: (s[-1] ** 2).mean(), y0.to(d), [0.0, 1e-5, 2e-5],
            opt_parameters={"kappa": torch.tensor(0.002, dtype=torch.float64, device=d),
                            "mu": mu0},
            other_parameters={"D": torch.ones_like, "derivs": "fd", "device": d},
            solver_parameters={"A": 0.5}, weights={"kappa": None, "mu": None}, lambda_reg=0.0,
            max_steps=LEG_STEPS, dt0=1e-6, method="adam", learning_rate=1e-2)
        _check(type(res["mu"]) is type(mu0) and res["mu"] is not mu0
               and torch.equal(mu0.expansion.params.detach().cpu(),
                               torch.tensor(LEG_MU0, dtype=torch.float64)),
               "optimize must return a new module and leave the caller's alone")
        out.append(res["mu"].expansion.params.detach().cpu())
    card_mu, cpu_mu = out
    err = (card_mu - cpu_mu).abs().max().item()
    moved = (card_mu - torch.tensor(LEG_MU0, dtype=torch.float64)).abs().max().item()
    line = (f"check Legendre mu trained by optimize ({LEG_STEPS} Adam steps, {LEG_N}^2, f64) on "
            f"the card {[round(float(c), 6) for c in card_mu]} vs the CPU: max_abs_err "
            f"{err:.3e} <= {TOL_LEG}, moved {moved:.3e}")
    _check(err <= TOL_LEG and moved > 1e-3, line)
    print(line, flush=True)


def _timed(torch, n, fn):
    """Host seconds per call of ``fn`` over ``n`` calls under sync debug mode
    "error" (a call that waits for the device fails), to one trailing
    synchronisation."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def _only_k1(counts, n, what):
    """K1 launched ``n`` times and no other kernel."""
    others = {k: v for k, v in counts.items() if k != "ch_cas_macro_ep" and v}
    _check(counts["ch_cas_macro_ep"] == n and not others,
           f"{what}: launches {counts}, expected {n} of K1 and nothing else")


def _finite_metrics(history, what):
    from pde_opt_tpu_torch.utils.metrics import to_host

    rows = [to_host(m) for m in history]
    _check(all(all(math.isfinite(v) for v in r.values()) for r in rows),
           f"{what}: a non-finite metric")
    return rows


def _moved(before, params):
    return sum(float((p.detach() - q).abs().sum()) for p, q in zip(params, before))


def _loss_grads(torch, net, traj, last_value, cfg, loss_fn):
    """The PPO loss and its gradients on one fixed trajectory, as one batch."""
    from pde_opt_tpu_torch.rl.ppo import advantages

    adv, ret = advantages(traj, last_value, cfg)
    flat = type(traj)(*(x.reshape(-1, *x.shape[2:]) for x in traj))
    net.zero_grad(set_to_none=True)
    loss, aux = loss_fn(net, flat, adv.reshape(-1), ret.reshape(-1))
    loss.backward()
    pg, v, ent = (abs(float(a.detach())) for a in aux[:3])
    scale = pg + cfg.vf_coef * v + cfg.ent_coef * ent     # the size of the loss's terms
    return float(loss), scale, [p.grad.detach().cpu() for p in net.parameters()]


def _drive_ppo(torch, kernels, dev, card):
    """PPO at run_ppo's shape (see PPO_T): trained env-steps/s, the update
    time, the physics floor and the learner's share; K1 64 times an update
    and nothing else; an auto-reset inside a rollout; one update's loss and
    gradients on the card against the CPU.  Returns the launch counts of the
    PPO_TIMED timed updates."""
    import copy

    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.rl import ActorCriticMLP, PPOConfig, Sampler, make_ppo_train_step

    env = make_cahn_hilliard_control_env(NUM_ENVS, GRID, SUBSTEPS, derivs="pallas",
                                         spectral_solve="fused", obs_downsample=4, device=dev)
    net = ActorCriticMLP(1, (GRID // 4) ** 2, widths=(256,), features=64,
                         compute_dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(70), device=dev)
    w0 = [p.detach().clone() for p in net.parameters()]
    cfg = PPOConfig(rollout_steps=PPO_T, epochs=2, minibatches=4, lr=3e-4)
    train_step, optimizer = make_ppo_train_step(env, cfg)
    opt = optimizer(net.parameters())
    sampler = Sampler(torch.Generator(device=dev).manual_seed(71))
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(72))
    history = []

    def update():
        nonlocal state
        state, m = train_step(net, opt, state, sampler)
        history.append(m)

    for _ in range(PPO_WARM):
        update()
    kernels.reset_launch_counts()
    dt = _timed(torch, PPO_TIMED, update)
    counts = kernels.launch_counts()

    # The physics floor: a random-policy rollout of the same env, same T.
    run = env.make_rollout(lambda o, g: env.sample_actions(g), PPO_T)
    gen = torch.Generator(device=dev).manual_seed(74)
    floor_state, _ = env.reset(torch.Generator(device=dev).manual_seed(73))

    def floor():
        nonlocal floor_state
        floor_state, _, _ = run(floor_state, gen)

    floor()
    physics_s = _timed(torch, PPO_FLOOR_RUNS, floor)
    dt2 = _timed(torch, PPO_BRACKET, update)
    split = 0.5 * (dt + dt2)
    physics_ms = 1e3 * physics_s
    learner_ms = max(1e3 * split - physics_ms, 0.0)
    share = min(physics_ms / (1e3 * split), 1.0)
    rate = PPO_T * NUM_ENVS / dt
    per_update = counts["ch_cas_macro_ep"] / PPO_TIMED
    print("ppo: " + json.dumps({
        "trained_env_steps_per_s": rate, "update_ms": 1e3 * dt,
        "update_ms_bracket": [1e3 * dt, 1e3 * dt2], "split_update_ms": 1e3 * split,
        "physics_ms": physics_ms, "learner_ms": learner_ms, "physics_share": share,
        "k1_launches_per_update": per_update}) + f" ({NUM_ENVS} envs x {GRID}^2 x {SUBSTEPS} "
          f"substeps, T {PPO_T}, ActorCriticMLP bf16, 2 epochs x 4 minibatches) [{card}]",
          flush=True)
    _only_k1(counts, PPO_TIMED * PPO_T, "PPO")
    rows = _finite_metrics(history, "PPO")
    _check(len(rows[0]) == 7, f"PPO metrics {sorted(rows[0])}")
    moved = _moved(w0, net.parameters())
    _check(moved > 0.0, "PPO: the parameters did not move")
    total = (PPO_WARM + PPO_TIMED + PPO_BRACKET) * PPO_T
    end_step = _end_step(torch, env)
    max_count = int(state.step_count.max())
    _check(total > end_step and max_count < total,
           f"PPO: no auto-reset in {total} steps (step counts up to {max_count})")
    print(f"ppo: {len(rows)} updates, reward_mean {rows[0]['reward_mean']:.6e} -> "
          f"{rows[-1]['reward_mean']:.6e}, loss {rows[-1]['loss']:.6e}; parameters moved "
          f"(sum |change| {moved:.6e}); {total} env steps crossed the episode end at step "
          f"{end_step} (step counts now <= {max_count})", flush=True)

    # One update's loss and gradients on a fixed trajectory, card vs CPU.
    cpu_net = copy.deepcopy(net).to("cpu")
    _, traj, last = train_step.rollout(net, state, sampler)
    traj = type(traj)(*(x[:, :PPO_CHECK_ENVS] for x in traj))
    last = last[:PPO_CHECK_ENVS]
    lc, _, gc = _loss_grads(torch, net, traj, last, cfg, train_step.loss_fn)
    lp, scale, gp = _loss_grads(torch, cpu_net, type(traj)(*(x.cpu() for x in traj)),
                                last.cpu(), cfg, train_step.loss_fn)
    e_loss = abs(lc - lp) / max(scale, 1e-12)
    e_grad = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                 for a, b in zip(gc, gp))
    line = (f"check ppo loss and gradients, card vs CPU ({PPO_CHECK_ENVS} envs x {PPO_T} "
            f"steps, bf16 net): loss err {e_loss:.3e} of its terms' size, gradients max "
            f"rel err {e_grad:.3e}")
    _check(e_loss <= TOL_RL_BF16 and e_grad <= TOL_RL_BF16, f"{line} > {TOL_RL_BF16}")
    print(line, flush=True)
    return counts


_ENV_ARGS = ("equation_type", "domain", "solver_type", "end_time", "step_dt", "numeric_dt",
             "state_to_observation_func", "reward_function", "reset_func",
             "reset_control_value", "update_control_value", "update_control_parameter",
             "static_equation_parameters", "control_equation_parameter_name",
             "solver_parameters", "num_envs", "auto_reset", "vectorized_control",
             "fused_epilogue", "device")


def _drive_replay_learner(torch, kernels, name, step, cfg, env, card, **action_kw):
    """RL_WARM then RL_TIMED calls of ``step(replay, state, obs, k, sampler)``
    (a replay learner's train step, its nets and optimizers bound) on
    ``env``; checks K1 once an update and nothing else, finite metrics and
    the replay's fill.  Returns (the launch counts of the timed updates, the
    metrics rows)."""
    from pde_opt_tpu_torch.rl import Sampler, init_replay

    dev = env.device
    sampler = Sampler(torch.Generator(device=dev).manual_seed(81))
    state, obs = env.reset(torch.Generator(device=dev).manual_seed(82))
    replay = init_replay(cfg, obs.shape[1:], obs.dtype, device=dev, **action_kw)
    history, sizes = [], []

    def update():
        nonlocal state, obs, replay
        replay, state, obs, m = step(replay, state, obs, len(history), sampler)
        history.append(m)
        sizes.append(replay.size)

    for _ in range(RL_WARM):
        update()
    kernels.reset_launch_counts()
    dt = _timed(torch, RL_TIMED, update)
    counts = kernels.launch_counts()
    _only_k1(counts, RL_TIMED, name)
    rows = _finite_metrics(history, name)
    want = [min((i + 1) * env.num_envs, cfg.capacity) for i in range(len(sizes))]
    _check(sizes == want, f"{name}: replay sizes {sizes} != {want}")
    print(f"{name}: {RL_WARM} + {RL_TIMED} updates on {env.num_envs} envs x {GRID}^2 x "
          f"{SUBSTEPS} substeps, {1e3 * dt:.4f} ms an update, replay size {sizes[-1]} of "
          f"{cfg.capacity}; launches {counts} [{card}]", flush=True)
    return counts, rows


def _drive_dqn_ddpg(torch, kernels, dev, card):
    """DQN on the flagship fleet with a three-action table, DDPG on the
    preset itself (fused epilogue, K1).  Returns their launch counts."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv
    from pde_opt_tpu_torch.rl import (
        DDPGConfig,
        DDPGState,
        DeterministicActorConv,
        DQNConfig,
        QCriticConv,
        QNetConv,
        make_ddpg_train_step,
        make_dqn_train_step,
    )
    from pde_opt_tpu_torch.rl.dqn import target_copy

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def trail(targets, nets):
        return sum(_moved([p.detach() for p in t.parameters()], n.parameters())
                   for t, n in zip(targets, nets))

    base = make_cahn_hilliard_control_env(NUM_ENVS, GRID, SUBSTEPS, spectral_solve="fused",
                                          device=dev)
    denv = VectorPDEEnv(**{n: getattr(base, n) for n in _ENV_ARGS},
                        action_space_config=DQN_ACTIONS)
    qnet = QNetConv(3, generator=gen(80), device=dev)
    target = target_copy(qnet)
    q0 = [p.detach().clone() for p in qnet.parameters()]
    dcfg = DQNConfig()
    dstep, dopt = make_dqn_train_step(denv, dcfg)
    opt = dopt(qnet.parameters())
    dqn_counts, rows = _drive_replay_learner(
        torch, kernels, "dqn", lambda *a: dstep(qnet, target, opt, *a), dcfg, denv, card)
    _check(rows[-1]["epsilon"] < rows[0]["epsilon"], "DQN: epsilon did not anneal")
    _check(_moved(q0, qnet.parameters()) > 0.0, "DQN: the Q-net did not move")
    gap = trail([target], [qnet])
    _check(gap > 0.0, "DQN: the target does not trail the online net")
    print(f"dqn: loss {rows[0]['loss']:.6e} -> {rows[-1]['loss']:.6e}, epsilon "
          f"{rows[0]['epsilon']:.4f} -> {rows[-1]['epsilon']:.4f}, sum |target - online| "
          f"{gap:.6e}", flush=True)

    actor = DeterministicActorConv(1, generator=gen(83), device=dev)
    critic = QCriticConv(1, generator=gen(84), device=dev)
    a0 = [p.detach().clone() for p in actor.parameters()]
    ccfg = DDPGConfig()
    cstep, (ao, co) = make_ddpg_train_step(base, ccfg)
    agent = DDPGState(actor, critic, target_copy(actor), target_copy(critic),
                      ao(actor.parameters()), co(critic.parameters()))
    ddpg_counts, rows = _drive_replay_learner(
        torch, kernels, "ddpg", lambda *a: cstep(agent, *a), ccfg, base, card,
        action_shape=tuple(base.action_shape), action_dtype=torch.float32)
    _check(_moved(a0, actor.parameters()) > 0.0, "DDPG: the actor did not move")
    gap = trail([agent.target_actor, agent.target_critic], [actor, critic])
    _check(gap > 0.0, "DDPG: the targets do not trail the online nets")
    print(f"ddpg: critic_loss {rows[0]['critic_loss']:.6e} -> {rows[-1]['critic_loss']:.6e}, "
          f"actor_loss {rows[-1]['actor_loss']:.6e}, sum |target - online| {gap:.6e}",
          flush=True)
    return dqn_counts, ddpg_counts


def _big_bounds():
    """The bounds of the tiled kernels at this phase's path shapes, counted
    as _bounds() counts them at 64^2: K1 (the 128^2 fleet), K2 (the 256^2
    macro, and the NN-control value+grad's forward at 4096 x 128^2) and K3
    (the value+grad's backward).  The tiled K3 runs 7n - 1 transforms an
    env, not the 1 + 7n of the 64^2 one: its forward re-run stops before the
    last substep, whose output the sweep never reads."""
    n = SUBSTEPS

    def ch(B, N, transforms, ew, planes, extra):
        px = N * N
        mats = 4 * 2 * N * N * 4
        return _bound(transforms, N, N, B, "bf16", ew * px * n * B,
                      B * px * 4 * planes + B * extra + mats + 2 * px * 4)

    f, b, g = FLEET128_GRID, BIG256_GRID, NN_GRID
    return {
        "ch_cas_macro_ep 128^2": ch(FLEET128_ENVS, f, 1 + 2 * n, 21, 2, 4 + f * f + 12),
        "ch_cas_macro 256^2": ch(BIG256_ENVS, b, 1 + 2 * n, 21, 2, 4),
        "ch_cas_macro 128^2 nn": ch(NN_ENVS, g, 1 + 2 * n, 21, 2, 4),
        "ch_cas_macro_bwd 128^2 nn": ch(NN_ENVS, g, 7 * n - 1, 50, 3, 8),
    }


def _check_big(torch, dev, gen):
    """Phase 9a: the tiled K1/K2 at BIG_GRIDS and K3 at 128^2 against their
    plain versions on the card, f32 and bf16 matrices, each launch with one
    NaN env that must stay in its env; one bf16 substep at the rounding
    sites at 128^2.  Returns the largest bf16 field error of each."""
    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        cas_constants,
        ch_cas_macro_bwd_cuda,
        ch_cas_macro_bwd_plain,
        ch_cas_macro_cuda,
        ch_cas_macro_plain,
    )

    B, bad = BIG_CHECK_ENVS, BIG_NAN_ENV
    keep = torch.arange(B, device=dev) != bad
    kap = 2e-3 + 8e-3 * torch.rand((B,), generator=gen, device=dev)
    errs = {}
    for H, W in BIG_GRIDS:
        u = 0.45 + 0.05 * torch.randn((B, H, W), generator=gen, device=dev)
        u[bad, 3, 7] = float("nan")
        for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            consts = cas_constants(H, W, HX, HY, mdt, dev)
            kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=mats == "bf16")
            for ep in (None, Epilogue(255.0, 0.0, CENTER, 1), Epilogue(255.0, 0.0, CENTER, 4)):
                got = ch_cas_macro_cuda(u, kap, consts, epilogue=ep, **kw)
                want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **kw)
                torch.cuda.synchronize()
                if ep is None:
                    got, want = (got,), (want,)
                name = "ch_cas_macro_ep" if ep else "ch_cas_macro"
                err = (got[0][keep] - want[0][keep]).abs().max().item()
                line = (f"check {name} mats={mats} ds={ep.ds if ep else '-'} {H}x{W} ({B} envs, "
                        f"env {bad} NaN): u1 max_abs_err {err:.3e}")
                _check(err <= TOL_U[mats], f"{line} > {TOL_U[mats]}")
                _check(torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
                       and bool(torch.isnan(got[0][bad]).any())
                       and not bool(torch.isnan(got[0][keep]).any()),
                       f"{line}: the NaN env left its env")
                if ep is not None:
                    _check(torch.equal(got[1][:, 2], want[1][:, 2])
                           and float(got[1][bad, 2]) < H * W, f"{line}: n_finite differs")
                    rel = ((got[1][keep, :2] - want[1][keep, :2]).abs()
                           / want[1][keep, :2].abs()).max().item()
                    lsb = (got[2].int() - want[2].int()).abs().max().item()
                    line += f", stats max_rel_err {rel:.3e}, obs max_lsb {lsb}"
                    _check(rel <= 1e-3 and lsb <= 1, f"{line}: epilogue bounds")
                    _check(got[2].shape == (B, H // ep.ds, W // ep.ds), f"{line}: obs shape")
                print(line, flush=True)
                if mats == "bf16":
                    errs[name] = max(errs.get(name, 0.0), err)
            if mats == "bf16" and (H, W) == (128, 128):
                one = {**kw, "n_steps": 1}
                _check_sites(f"ch_cas_macro mats=bf16 {H}x{W}",
                             ch_cas_macro_cuda(u[keep], kap[keep], consts, **one),
                             ch_cas_macro_plain(u[keep], kap[keep], consts, **one),
                             ch_cas_macro_plain(u[keep], kap[keep], consts,
                                                **{**one, "round_bf16": False}),
                             TOL_SITE["ch"])
    # K3 at 128^2 on the training fields and the loss's cotangent.
    H = W = NN_GRID
    ub = 0.5 + 0.01 * torch.randn((B, H, W), generator=gen, device=dev)
    kb = torch.full((B,), 0.004, device=dev)
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = cas_constants(H, W, HX, HY, mdt, dev)
        kw = dict(mu_fn=CH_MU, dt=NN_DT, A=A, n_steps=SUBSTEPS, round_bf16=mats == "bf16")
        g = 2.0 * ch_cas_macro_plain(ub, kb, consts, **kw)
        got = ch_cas_macro_bwd_cuda(ub, kb, g, consts, **kw)
        want = ch_cas_macro_bwd_plain(ub, kb, g, consts, **kw)
        torch.cuda.synchronize()
        line = f"check ch_cas_macro_bwd mats={mats} cotangent=loss {H}x{W} ({B} envs)"
        if mats == "f32":
            e = _bwd_errs(got, want)
            line += f": du max_rel_err {e[0]:.3e}, dkappa max_rel_err {e[1]:.3e}"
            _check(e[0] <= TOL_BWD["f32"][0] and e[1] <= TOL_BWD["f32"][1],
                   f"{line} > {TOL_BWD['f32']}")
            print(line, flush=True)
        else:
            e = _check_bwd_bf16(torch, line, got, want,
                                _bwd_f64_accumulated(torch, ub, kb, g, consts, kw))
            errs["ch_cas_macro_bwd"] = (got[0] - want[0]).abs().max().item()
            one = {**kw, "n_steps": 1}
            g1 = 2.0 * ch_cas_macro_plain(ub, kb, consts, **one)
            got1 = ch_cas_macro_bwd_cuda(ub, kb, g1, consts, **one)
            want1 = ch_cas_macro_bwd_plain(ub, kb, g1, consts, **one)
            ctl1 = ch_cas_macro_bwd_plain(ub, kb, g1, consts, **{**one, "round_bf16": False})
            e1 = _bwd_errs(got1, want1)
            line1 = (f"check ch_cas_macro_bwd mats=bf16 cotangent=loss {H}x{W}, 1 substep: "
                     f"du max_rel_err {e1[0]:.3e}, dkappa max_rel_err {e1[1]:.3e}")
            _check(e1[0] <= TOL_BWD["bf16"][0] and e1[1] <= TOL_BWD["bf16"][1],
                   f"{line1} > {TOL_BWD['bf16']}")
            print(line1, flush=True)
            for i, part in enumerate(("du", "dkappa")):
                _check_sites(f"ch_cas_macro_bwd mats=bf16 {H}x{W} loss cotangent, {part}",
                             got1[i], want1[i], ctl1[i], TOL_SITE["ch_bwd"][i])
        # One NaN env: its du and dkappa are NaN, no other env's is.
        un = ub.clone()
        un[bad, 3, 7] = float("nan")
        du, dk = ch_cas_macro_bwd_cuda(un, kb, g, consts, **kw)
        torch.cuda.synchronize()
        _check(bool(torch.isnan(du[bad]).any()) and bool(torch.isnan(dk[bad]))
               and bool(torch.isfinite(du[keep]).all()) and bool(torch.isfinite(dk[keep]).all()),
               f"K3 mats={mats} {H}x{W}: the NaN env left its env")
        print(f"check ch_cas_macro_bwd mats={mats} {H}x{W}: NaN env {bad} stays in its env",
              flush=True)
    return errs


def _check_fwd_bf16(torch, line, got, want):
    """A bf16 forward against its plain version at the card bounds: the
    field within TOL_U["bf16"] and, for K1's (field, stats, obs), the stats
    to rtol 1e-3, n_finite equal and the obs within 1 LSB."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = (got[0] - want[0]).abs().max().item()
    line += f": u1 max_abs_err {err:.3e}"
    _check(bool(torch.isfinite(got[0]).all()), f"{line}: non-finite field")
    _check(err <= TOL_U["bf16"], f"{line} > {TOL_U['bf16']}")
    if len(got) == 3:
        rel = ((got[1][:, :2] - want[1][:, :2]).abs() / want[1][:, :2].abs()).max().item()
        lsb = (got[2].int() - want[2].int()).abs().max().item()
        line += f", stats max_rel_err {rel:.3e}, obs max_lsb {lsb}"
        _check(torch.equal(got[1][:, 2], want[1][:, 2]), f"{line}: n_finite differs")
        _check(rel <= 1e-3 and lsb <= 1, f"{line}: epilogue bounds")
    print(line, flush=True)


def _drive_big(torch, kernels, dev, gen, card):
    """Phase 9b: the 128^2 fleet (K1), the 256^2 macro (K2) and the 128^2
    NN-control value+grad (K2 + K3) through their entry points, each with
    its launch counts reset just before and read just after, under sync
    debug mode "error"; then the tiled kernels' times against their plain
    versions and bounds at these shapes, and each kernel held against its
    plain version there.  Returns each path's counts."""
    from pde_opt_tpu_torch.envs.presets import CH_MU, make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        cas_constants,
        ch_cas_macro_bwd_cuda,
        ch_cas_macro_bwd_plain,
        ch_cas_macro_cuda,
        ch_cas_macro_plain,
        make_ch_cas_fused_macro,
    )
    from pde_opt_tpu_torch.bench.nn_control import KappaControlNet, nn_control_loss

    # -- the 128^2 control fleet (run_ch128) --
    env = make_cahn_hilliard_control_env(num_envs=FLEET128_ENVS, grid_size=FLEET128_GRID,
                                         substeps=SUBSTEPS, derivs="pallas",
                                         spectral_solve="fused", device=dev)
    state, _ = env.reset(gen)
    env.make_rollout(lambda o, g: env.sample_actions(g), 2)(state, gen)
    state, _ = env.reset(gen)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rew, term = env.make_rollout(lambda o, g: env.sample_actions(g),
                                        FLEET128_STEPS)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_fleet = time.perf_counter() - t0
    fleet_counts = kernels.launch_counts()
    _check(fleet_counts["ch_cas_macro_ep"] == FLEET128_STEPS
           and sum(fleet_counts.values()) == FLEET128_STEPS, f"128^2 fleet launches {fleet_counts}")
    _check(rew.shape == (FLEET128_STEPS, FLEET128_ENVS) and bool(torch.isfinite(rew).all())
           and bool(torch.isfinite(state.y).all()), "128^2 fleet: non-finite rewards or field")
    fleet_rate = FLEET128_ENVS * FLEET128_STEPS / t_fleet
    print(f"128^2 fleet: {FLEET128_STEPS}-step rollout of {FLEET128_ENVS} envs x "
          f"{FLEET128_GRID}^2 x {SUBSTEPS} substeps (derivs=pallas, fused epilogue), no host "
          f"sync, launches {fleet_counts}: {fleet_rate:.1f} env-steps/s [{card}]", flush=True)

    # -- the 256^2 macro (run_ch256) --
    N = BIG256_GRID
    macro = make_ch_cas_fused_macro(CH_MU, N, N, 0.01, 0.01, 1.0, BIG256_DT, SUBSTEPS)
    u = 0.5 + 0.01 * torch.randn((BIG256_ENVS, N, N), generator=gen, device=dev)
    k = torch.full((BIG256_ENVS,), 4e-3, device=dev)
    out = macro(u, k)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for _ in range(BIG256_CALLS):
        out = macro(out, k)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_256 = time.perf_counter() - t0
    m256_counts = kernels.launch_counts()
    _check(m256_counts["ch_cas_macro"] == BIG256_CALLS
           and sum(m256_counts.values()) == BIG256_CALLS, f"256^2 macro launches {m256_counts}")
    _check(bool(torch.isfinite(out).all()), "256^2 macro: non-finite field")
    drift = (out.mean((-2, -1)) - u.mean((-2, -1))).abs().max().item()
    _check(drift < 1e-3, f"256^2 macro: per-env mean drift {drift}")
    rate_256 = BIG256_ENVS * SUBSTEPS * BIG256_CALLS / t_256
    print(f"256^2 macro: {BIG256_CALLS} chained calls of {BIG256_ENVS} envs x {N}^2 x "
          f"{SUBSTEPS} substeps (dt {BIG256_DT}), no host sync, launches {m256_counts}, per-env "
          f"mean drift {drift:.3e}: {rate_256:.1f} field-substeps/s [{card}]", flush=True)

    # -- the NN-control value+grad (run_train_grad_128, BASELINE config 3) --
    G = NN_GRID
    u_nn = 0.5 + 0.01 * torch.randn((NN_ENVS, G, G), generator=gen, device=dev)
    net = KappaControlNet(generator=torch.Generator(device=dev).manual_seed(56), device=dev)
    m_nn = make_ch_cas_fused_macro(CH_MU, G, G, 0.01, 0.01, 1.0, NN_DT, SUBSTEPS)

    def value_and_grad(m, uu, nn_):
        nn_.zero_grad(set_to_none=True)
        v = nn_control_loss(nn_, m, uu)
        v.backward()
        return v.detach(), [p.grad for p in nn_.parameters()]

    value_and_grad(m_nn, u_nn, net)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    vg = [value_and_grad(m_nn, u_nn, net) for _ in range(NN_CALLS)]
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_nn = time.perf_counter() - t0
    nn_counts = kernels.launch_counts()
    _check(nn_counts["ch_cas_macro"] == NN_CALLS and nn_counts["ch_cas_macro_bwd"] == NN_CALLS
           and sum(nn_counts.values()) == 2 * NN_CALLS, f"NN value+grad launches {nn_counts}")
    _check(all(bool(torch.isfinite(v)) and all(bool(torch.isfinite(g).all()) for g in gs)
               for v, gs in vg), "NN value+grad: non-finite value or gradient")
    nn_rate = NN_ENVS * SUBSTEPS * NN_CALLS / t_nn
    print(f"128^2 NN-control value+grad: {NN_CALLS} calls of {NN_ENVS} envs x {G}^2 x "
          f"{SUBSTEPS} substeps (bf16), no host sync, launches {nn_counts}, loss "
          f"{float(vg[-1][0]):.6e}: {nn_rate:.1f} grad-env-substeps/s, "
          f"{t_nn / NN_CALLS * 1e3:.4f} ms a call [{card}]", flush=True)
    # Its loss and gradients with f32 matrices on NN_CHECK_ENVS envs: the card
    # (the tiled FMA K2 and K3) against the CPU (the plain macro and backward).
    m32 = make_ch_cas_fused_macro(CH_MU, G, G, 0.01, 0.01, 1.0, NN_DT, SUBSTEPS,
                                  mats_dtype=torch.float32)
    cpu_net = KappaControlNet(device="cpu")
    cpu_net.load_state_dict({n_: p.detach().cpu() for n_, p in net.state_dict().items()})
    v_card, g_card = value_and_grad(m32, u_nn[:NN_CHECK_ENVS].contiguous(), net)
    v_cpu, g_cpu = value_and_grad(m32, u_nn[:NN_CHECK_ENVS].cpu(), cpu_net)
    e_v = abs(float(v_card) / float(v_cpu) - 1.0)
    e_g = max(((a.cpu() - b).abs().max() / b.abs().max()).item() for a, b in zip(g_card, g_cpu))
    line = (f"check NN-control value+grad (f32, {NN_CHECK_ENVS} envs) card vs CPU: value "
            f"rel_err {e_v:.3e}, gradients max_rel_err {e_g:.3e}")
    _check(e_v <= TOL_NN[0] and e_g <= TOL_NN[1], f"{line} > {TOL_NN}")
    print(line, flush=True)

    # -- the tiled kernels' times at these shapes, against plain and bounds --
    bounds = _big_bounds()
    c128 = cas_constants(FLEET128_GRID, FLEET128_GRID, HX, HY, torch.bfloat16, dev)
    # Fields around 0.45, as in phase 9a: sum(u - 0.5), the first stat, far
    # from 0, so that its relative error is a fair check.
    u128 = 0.45 + 0.05 * torch.randn((FLEET128_ENVS, FLEET128_GRID, FLEET128_GRID),
                                     generator=gen, device=dev)
    k128 = 2e-3 + 8e-3 * torch.rand((FLEET128_ENVS,), generator=gen, device=dev)
    kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
    ep = Epilogue(255.0, 0.0, CENTER, 1)
    c256 = cas_constants(N, N, 0.01, 0.01, torch.bfloat16, dev)
    kw256 = {**kw, "dt": BIG256_DT}
    cnn = cas_constants(G, G, 0.01, 0.01, torch.bfloat16, dev)
    kwnn = {**kw, "dt": NN_DT}
    knn = net(u_nn).detach()
    g_nn = 2.0 * (ch_cas_macro_cuda(u_nn, knn, cnn, **kwnn) - 0.5)
    cases = (
        ("ch_cas_macro_ep 128^2", f"{FLEET128_ENVS}x{FLEET128_GRID}^2x{SUBSTEPS}",
         lambda: ch_cas_macro_cuda(u128, k128, c128, epilogue=ep, **kw),
         lambda: ch_cas_macro_plain(u128, k128, c128, epilogue=ep, **kw)),
        ("ch_cas_macro 256^2", f"{BIG256_ENVS}x{N}^2x{SUBSTEPS}",
         lambda: ch_cas_macro_cuda(u, k, c256, **kw256),
         lambda: ch_cas_macro_plain(u, k, c256, **kw256)),
        ("ch_cas_macro 128^2 nn", f"{NN_ENVS}x{G}^2x{SUBSTEPS}",
         lambda: ch_cas_macro_cuda(u_nn, knn, cnn, **kwnn),
         lambda: ch_cas_macro_plain(u_nn, knn, cnn, **kwnn)),
        ("ch_cas_macro_bwd 128^2 nn", f"{NN_ENVS}x{G}^2x{SUBSTEPS}",
         lambda: ch_cas_macro_bwd_cuda(u_nn, knn, g_nn, cnn, **kwnn),
         lambda: ch_cas_macro_bwd_plain(u_nn, knn, g_nn, cnn, **kwnn)),
    )
    for name, what, kernel, plain in cases:
        k1, p1, k2 = (_time_ms(torch, f, reps=3, warmup=1) for f in (kernel, plain, kernel))
        ms = (k1 + k2) / 2
        b_ms, b_by = bounds[name]
        print(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of the kernel's time) at {what} bf16 "
              f"[{card}]", flush=True)
        # The kernel against plain on these inputs: each block walks several
        # envs through its slot here, which the checks of phase 9a at 256
        # envs (one env a block) do not reach.
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        line = f"check {name} mats=bf16 at {what}"
        if name.startswith("ch_cas_macro_bwd"):
            # K3 sums 2 x 64 terms a product on the tensor cores: its bf16
            # dkappa strays from plain's as far as a plain backward with
            # tensor-core products does, further than the f64 control
            # (scripts/torch_tiled_ab.py), so both controls bound it here.
            _check_bwd_bf16(torch, line, got, want,
                            _bwd_f64_accumulated(torch, u_nn, knn, g_nn, cnn, kwnn),
                            _bwd_f64_accumulated(torch, u_nn, knn, g_nn, cnn, kwnn, True))
            # And each env's du and dkappa are those of the same kernel on
            # BIG_CHECK_ENVS envs at a time (one env a block), bit for bit.
            alone = [ch_cas_macro_bwd_cuda(*(x[i:i + BIG_CHECK_ENVS].contiguous()
                                             for x in (u_nn, knn, g_nn)), cnn, **kwnn)
                     for i in range(0, NN_ENVS, BIG_CHECK_ENVS)]
            same = all(torch.equal(got[j], torch.cat([a[j] for a in alone])) for j in range(2))
            _check(same, f"{line}: differs from its launches of {BIG_CHECK_ENVS} envs")
            print(f"{line}: equals its launches of {BIG_CHECK_ENVS} envs (one env a block) "
                  f"bit for bit", flush=True)
        else:
            _check_fwd_bf16(torch, line, got, want)
    return fleet_counts, m256_counts, nn_counts


def main():
    import torch

    from pde_opt_tpu_torch.envs.presets import (
        AC_MU,
        AC_R,
        BV_J0,
        BV_MU,
        CH_MU,
        make_allen_cahn_control_env,
        make_butler_volmer_control_env,
        make_cahn_hilliard_control_env,
        make_gpe_control_env,
        make_sbm_butler_volmer_control_env,
    )
    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        cas_constants,
        ch_cas_macro_bwd_cuda,
        ch_cas_macro_bwd_plain,
        ch_cas_macro_cuda,
        ch_cas_macro_plain,
        ch_cas_macro_reference,
        make_ch_cas_fused_macro,
        make_ch_cas_fused_macro_ep,
    )

    # ---- 1. the card ----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda")
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_libraries(*SOURCES)
    print(f"build: {', '.join(SOURCES.values())} (K1-K9), in parallel, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in SOURCES:
        for line in kernels.build_log(lib).splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "stack frame")):
                print(f"build: {lib}: {line.strip()}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", kernels.library_path(lib)],
                              capture_output=True, text=True, check=True).stdout
        n_hgmma = sass.count("HGMMA")
        print(f"build: {lib}: {n_hgmma} HGMMA instructions in its SASS", flush=True)
        _check(lib not in WGMMA_LIBS or n_hgmma > 0, f"{lib} has no HGMMA instruction")

    # ---- 3. kernel vs plain on the card, main-path shapes ---------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    # Around 0.45, so sum(u - CENTER) is far from 0 and its rtol is meaningful.
    u = 0.45 + 0.05 * torch.randn((NUM_ENVS, GRID, GRID), generator=gen, device=dev)
    kap = 2e-3 + 8e-3 * torch.rand((NUM_ENVS,), generator=gen, device=dev)
    max_err = {"ch_cas_macro": 0.0, "ch_cas_macro_ep": 0.0}
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = cas_constants(GRID, GRID, HX, HY, mdt, dev)
        for ep in (None, Epilogue(255.0, 0.0, CENTER, 1), Epilogue(255.0, 0.0, CENTER, 4)):
            kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS,
                      round_bf16=mdt == torch.bfloat16, epilogue=ep)
            got = ch_cas_macro_cuda(u, kap, consts, **kw)
            want = ch_cas_macro_plain(u, kap, consts, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "ch_cas_macro_ep" if ep else "ch_cas_macro"
            line = f"check {name} mats={mats} ds={ep.ds if ep else '-'}: u1 max_abs_err {err:.3e}"
            _check(err <= TOL_U[mats], f"{line} > {TOL_U[mats]}")
            if ep is not None:
                _check(torch.equal(got[1][:, 2], want[1][:, 2]), f"{line}: n_finite differs")
                rel = ((got[1][:, :2] - want[1][:, :2]).abs()
                       / want[1][:, :2].abs()).max().item()
                lsb = (got[2].int() - want[2].int()).abs().max().item()
                line += f", stats max_rel_err {rel:.3e}, obs max_lsb {lsb}"
                _check(rel <= 1e-3, f"{line}: stats rtol 1e-3")
                _check(lsb <= 1, f"{line}: obs > 1 LSB")
                _check(got[2].shape == (NUM_ENVS, GRID // ep.ds, GRID // ep.ds)
                       and got[2].dtype == torch.uint8, f"{line}: obs shape/dtype")
            print(line, flush=True)
            if mats == "bf16":
                max_err[name] = max(max_err[name], err)
        if mdt == torch.bfloat16:
            one = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=1, round_bf16=True)
            _check_sites("ch_cas_macro mats=bf16", ch_cas_macro_cuda(u, kap, consts, **one),
                         ch_cas_macro_plain(u, kap, consts, **one),
                         ch_cas_macro_plain(u, kap, consts, **{**one, "round_bf16": False}),
                         TOL_SITE["ch"])
        oracle = ch_cas_macro_reference(CH_MU, HX, HY, A, DT, SUBSTEPS)(u, kap)
        got = ch_cas_macro_cuda(u, kap, consts, mu_fn=CH_MU, dt=DT, A=A,
                                n_steps=SUBSTEPS, round_bf16=mdt == torch.bfloat16)
        err = (got - oracle).abs().max().item()
        print(f"check ch_cas_macro mats={mats} vs FFT oracle: max_abs_err {err:.3e}",
              flush=True)
        _check(err <= TOL_ORACLE[mats], f"kernel vs FFT oracle {err} > {TOL_ORACLE[mats]}")

    # ---- 3b. K3 vs its plain backward, training shapes --------------------
    tg = torch.Generator(device=dev).manual_seed(50)
    u_tg = 0.5 + 0.01 * torch.randn((TG_ENVS, GRID, GRID), generator=tg, device=dev)
    kap_tg = torch.full((TG_ENVS,), 0.004, device=dev)
    w_tg = torch.randn((TG_ENVS, GRID, GRID), generator=tg, device=dev)
    bwd_err = 0.0
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = cas_constants(GRID, GRID, HX, HY, mdt, dev)
        kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=mdt == torch.bfloat16)
        # The cotangent of the train_grad loss sum(u1**2), and a random one.
        g_loss = 2.0 * ch_cas_macro_plain(u_tg, kap_tg, consts, **kw)
        for cot, g in (("loss", g_loss), ("random", w_tg)):
            du, dk = ch_cas_macro_bwd_cuda(u_tg, kap_tg, g, consts, **kw)
            pdu, pdk = ch_cas_macro_bwd_plain(u_tg, kap_tg, g, consts, **kw)
            torch.cuda.synchronize()
            e_abs = (du - pdu).abs().max().item()
            e_du = e_abs / pdu.abs().max().item()
            e_dk = ((dk - pdk).abs().max() / pdk.abs().max()).item()
            line = (f"check ch_cas_macro_bwd mats={mats} cotangent={cot}: du max_rel_err "
                    f"{e_du:.3e} (max_abs_err {e_abs:.3e}), dkappa max_rel_err {e_dk:.3e}")
            tol_u, tol_k = TOL_BWD[mats]
            _check(bool(torch.isfinite(du).all() and torch.isfinite(dk).all()), f"{line}: non-finite")
            if mats == "f32":
                _check(e_du <= tol_u and e_dk <= tol_k, f"{line} > {TOL_BWD[mats]}")
            elif cot == "loss":
                _check_bwd_bf16(torch, f"check ch_cas_macro_bwd mats=bf16 cotangent=loss "
                                f"(max_abs_err {e_abs:.3e})", (du, dk), (pdu, pdk),
                                _bwd_f64_accumulated(torch, u_tg, kap_tg, g, consts, kw))
                bwd_err = e_abs
                # The same launch again, and the first 200 envs alone (one a
                # block, where 1024 envs give a block up to four): bitwise
                # equal, so no state leaks between a block's envs.
                again = ch_cas_macro_bwd_cuda(u_tg, kap_tg, g, consts, **kw)
                few = ch_cas_macro_bwd_cuda(u_tg[:200].contiguous(), kap_tg[:200].contiguous(),
                                            g[:200].contiguous(), consts, **kw)
                _check(torch.equal(again[0], du) and torch.equal(again[1], dk)
                       and torch.equal(few[0], du[:200]) and torch.equal(few[1], dk[:200]),
                       "K3 bf16 is not deterministic, or an env depends on its block's others")
                print("check ch_cas_macro_bwd mats=bf16: deterministic, and 200 envs alone equal "
                      "their share of the 1024-env launch", flush=True)
                continue
            else:
                line += " (reported, no bound)"
            print(line, flush=True)
        if mdt == torch.bfloat16:
            one = {**kw, "n_steps": 1}
            g1 = 2.0 * ch_cas_macro_plain(u_tg, kap_tg, consts, **one)
            got = ch_cas_macro_bwd_cuda(u_tg, kap_tg, g1, consts, **one)
            want = ch_cas_macro_bwd_plain(u_tg, kap_tg, g1, consts, **one)
            ctl = ch_cas_macro_bwd_plain(u_tg, kap_tg, g1, consts, **{**one, "round_bf16": False})
            e_du, e_dk = _bwd_errs(got, want)
            line = (f"check ch_cas_macro_bwd mats=bf16 cotangent=loss, 1 substep: du max_rel_err "
                    f"{e_du:.3e}, dkappa max_rel_err {e_dk:.3e}")
            _check(e_du <= TOL_BWD["bf16"][0] and e_dk <= TOL_BWD["bf16"][1],
                   f"{line} > {TOL_BWD['bf16']}")
            print(line, flush=True)
            for i, part in enumerate(("du", "dkappa")):
                _check_sites(f"ch_cas_macro_bwd mats=bf16 loss cotangent, {part}", got[i],
                             want[i], ctl[i], TOL_SITE["ch_bwd"][i])
    _check_ch_small(torch, dev, gen, kap, kap_tg)

    # The epilogue variant's gradient (stats fold + K3) against the plain
    # autograd Function on the CPU, on the first 64 envs.
    m_ep = make_ch_cas_fused_macro_ep(CH_MU, GRID, GRID, HX, HY, A, DT, SUBSTEPS,
                                      stats_center=CENTER, mats_dtype=torch.float32)

    def ep_grads(uu, kk, ww):
        uu, kk = uu.clone().requires_grad_(), kk.clone().requires_grad_()
        u1, stats, _ = m_ep(uu, kk)
        ((ww * u1).sum() + stats[:, 0].sum() + stats[:, 1].sum()).backward()
        return uu.grad, kk.grad

    du, dk = ep_grads(u_tg, kap_tg, w_tg)
    cdu, cdk = ep_grads(u_tg[:64].cpu(), kap_tg[:64].cpu(), w_tg[:64].cpu())
    e_du = ((du[:64].cpu() - cdu).abs().max() / cdu.abs().max()).item()
    e_dk = ((dk[:64].cpu() - cdk).abs().max() / cdk.abs().max()).item()
    line = (f"check epilogue gradient (K1 + fold + K3) vs the plain Function on the CPU, "
            f"f32: du max_rel_err {e_du:.3e}, dkappa max_rel_err {e_dk:.3e}")
    _check(e_du <= TOL_BWD["f32"][0] and e_dk <= TOL_BWD["f32"][1], line)
    print(line, flush=True)

    # ---- 3c/3d. K4 and K5 vs their plain versions and oracles ----------------
    u_ac, kap_ac, err_ac = _check_ac(torch, dev, gen)
    max_err.update(err_ac)
    gpe_env = make_gpe_control_env(num_envs=GPE_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                   box_size=GPE_BOX, k_interaction=GPE_G, device=dev)
    y_gpe, ctrl_gpe, v_gpe, spot, err_gpe = _check_gpe(torch, dev, gen, gpe_env)
    max_err.update(err_gpe)

    # ---- 3e/3f. K6 and K7 vs their plain versions and oracles ------------------
    u_bv, cr_bv, err_bv = _check_bv(torch, dev, gen)
    max_err.update(err_bv)
    bv_kw = dict(num_envs=BV_ENVS, grid_size=GRID, substeps=SUBSTEPS, device=dev)
    sbm_kw = dict(num_envs=SBM_ENVS, grid_size=GRID, substeps=SUBSTEPS, device=dev)
    sbm_env = make_sbm_butler_volmer_control_env(**sbm_kw)
    u_sbm, cr_sbm, sbm_consts, err_sbm = _check_sbm(torch, dev, gen, sbm_env)
    max_err.update(err_sbm)

    # ---- 3g/3h. K8 vs its plain version; the 3D mobility macro vs its oracle --
    k8_2d, k8_3d, err_k8 = _check_k8(torch, dev, gen)
    max_err.update(err_k8)
    _check_mobility_macro(torch, dev, gen)

    # ---- 3i. K9a and K9b vs their plain versions and the FFT oracles --------
    max_err.update(_check_k9(torch, dev, gen, u, kap, u_ac, kap_ac))

    # ---- 4. the serving path ----------------------------------------------
    env = make_cahn_hilliard_control_env(
        num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
        spectral_solve="fused", device=dev)
    env0 = make_cahn_hilliard_control_env(
        num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
        spectral_solve="fused", fused_epilogue=False, device=dev)

    def policy(obs, g):
        return env.sample_actions(g)

    # Warm the env glue (allocator, generators) on a throwaway fleet.
    state, _ = env.reset(gen)
    env.make_rollout(policy, 2)(state, gen)
    state0, _ = env0.reset(gen)
    env0.make_rollout(policy, 2)(state0, gen)

    # The step at which the f32 episode clock first reaches end_time.
    t, end_step = torch.zeros((), dtype=torch.float32), 0
    while not bool(t >= env.end_time - 1e-9):
        t, end_step = t + env.step_dt, end_step + 1
    _check(end_step < STEPS, "the rollout must cross the episode end")

    state, _ = env.reset(gen)
    mean0 = state.y.mean(dim=(-2, -1))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    # A rollout step must never wait for the device: make any synchronising
    # call inside the timed windows an error.
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rew_a, term_a = env.make_rollout(policy, end_step - 1)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    mean1 = state.y.mean(dim=(-2, -1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rew_b, term_b = env.make_rollout(policy, STEPS - end_step + 1)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    k1_launches = kernels.launch_counts()["ch_cas_macro_ep"]
    state0 = env.reset(gen)[0]
    state0, rew0, _ = env0.make_rollout(policy, K2_STEPS)(state0, gen)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    rewards = torch.cat([rew_a, rew_b])
    terms = torch.cat([term_a, term_b])
    print(f"main path: {STEPS}-step rollout of {NUM_ENVS} envs x {GRID}^2 x "
          f"{SUBSTEPS} substeps; episode end at step {end_step}; "
          f"launches {counts}", flush=True)
    _check(rewards.shape == (STEPS, NUM_ENVS), "rewards shape")
    _check(bool(torch.isfinite(rewards).all()), "non-finite rewards")
    _check(bool(torch.isfinite(rew0).all()), "non-finite rewards without the epilogue")
    _check(k1_launches == STEPS, f"K1 launches {k1_launches} != {STEPS}")
    _check(counts["ch_cas_macro_ep"] == STEPS, f"K1 launches {counts}")
    _check(counts["ch_cas_macro"] == K2_STEPS, f"K2 launches {counts}")
    _check(bool(terms[end_step - 1].all()), "every env must end its episode at the end step")
    kept = ~term_a.any(dim=0)
    _check(int(kept.sum()) > 0, "no env ran to the episode end")
    drift = (mean1 - mean0)[kept].abs().max().item()
    print(f"mass drift over {end_step - 1} steps on {int(kept.sum())} envs that "
          f"did not reset: max |mean change| {drift:.3e}", flush=True)
    _check(drift < 1e-3, f"per-env mean drift {drift} >= 1e-3")
    _check(bool(torch.isfinite(state.y).all()) and state.y.shape == (NUM_ENVS, GRID, GRID),
           "final field")
    _check(int(state.step_count.max()) == STEPS - end_step, "step counts after the reset")
    # The epilogue's reward equals the env's own -var on the field it emitted
    # (the last step reset no env, so state.y is that field).
    _check(not bool(term_b[-1].any()), "the last step must not reset")
    plain_reward = env.reward_function(state.y)
    rel = ((rew_b[-1] - plain_reward).abs() / plain_reward.abs()).max().item()
    print(f"epilogue reward vs -var of the field: max_rel_err {rel:.3e}", flush=True)
    _check(rel < 1e-3, "epilogue reward disagrees with -var")

    state.y[7] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    torch.cuda.synchronize()
    _check(bool(info["diverged"][7]) and int(info["diverged"].sum()) == 1, "NaN env not flagged")
    _check(bool(terminated[7]) and float(reward[7]) == 0.0, "NaN env not terminated")
    _check(bool(torch.isfinite(state.y).all()) and int(state.step_count[7]) == 0,
           "NaN env not reset")
    _check(obs.shape == (NUM_ENVS, 1, GRID, GRID) and obs.dtype == torch.uint8, "obs")
    print("poisoned env 7: flagged diverged, reward 0, reset", flush=True)

    # ---- 5. the AC and GPE serving paths ------------------------------------
    ac_env = make_allen_cahn_control_env(num_envs=AC_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                         device=dev)
    ac_env0 = make_allen_cahn_control_env(num_envs=AC_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                          fused_epilogue=False, device=dev)
    _, ac_counts, ac_rate = _drive_fleet(torch, kernels, ac_env, ac_env0, gen, "AC", 1e-3)
    _check(ac_counts["ac_cas_macro_ep"] == STEPS and ac_counts["ac_cas_macro"] == FLEET_STEPS_NO_EP,
           f"AC launches {ac_counts}")
    gpe_env0 = make_gpe_control_env(num_envs=GPE_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                    box_size=GPE_BOX, k_interaction=GPE_G, fused_epilogue=False,
                                    device=dev)
    gpe_state, gpe_counts, gpe_rate = _drive_fleet(torch, kernels, gpe_env, gpe_env0, gen,
                                                   "GPE", 1e-4)
    _check(gpe_counts["gpe_strang_macro_ep"] == STEPS
           and gpe_counts["gpe_strang_macro"] == FLEET_STEPS_NO_EP, f"GPE launches {gpe_counts}")
    dx_gpe = float(gpe_env.domain.dx[0])
    norms = (gpe_state.y ** 2).sum((-3, -2, -1)) * dx_gpe * dx_gpe
    norm_err = (norms - 1.0).abs().max().item()
    print(f"GPE: per-env norm after the rollout: max |norm - 1| {norm_err:.3e}", flush=True)
    _check(norm_err <= 1e-4, "GPE per-env norm must stay 1 to rtol 1e-4")

    # ---- 5b. the BV and SBM charging fleets ------------------------------------
    from pde_opt_tpu_torch.ops.bv_cas import (
        bv_cc_macro_cuda,
        bv_cc_macro_plain,
        bv_cc_reference,
        make_bv_cc_fused_macro,
    )
    from pde_opt_tpu_torch.ops.sbm_bv import (
        SbmEpilogue,
        make_sbm_bv_fused_macro,
        sbm_bv_macro_cuda,
        sbm_bv_macro_plain,
        sbm_bv_reference,
    )

    h_bv = 1.0 / GRID
    bconsts = cas_constants(GRID, GRID, h_bv, h_bv, torch.bfloat16, dev)
    bv_kw_macro = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA, cell=h_bv * h_bv, dt=BV_DT,
                       n_steps=SUBSTEPS, round_bf16=True)
    sbm_kw_macro = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=BV_DT, n_steps=SUBSTEPS)
    bv_env = make_butler_volmer_control_env(**bv_kw)
    bv_env0 = make_butler_volmer_control_env(fused_epilogue=False, **bv_kw)
    bv_state, bv_counts, bv_rate = _drive_fleet(torch, kernels, bv_env, bv_env0, gen, "BV", 1e-4)
    _check(bv_counts["bv_cc_macro_ep"] == STEPS
           and bv_counts["bv_cc_macro"] == FLEET_STEPS_NO_EP, f"BV launches {bv_counts}")
    _check_late(torch, bv_env, bv_state, "bv_cc_macro mats=bf16",
                lambda uu, cc: bv_cc_macro_cuda(uu, cc, bconsts, **bv_kw_macro),
                lambda uu, cc: bv_cc_macro_plain(uu, cc, bconsts, **bv_kw_macro),
                bv_cc_reference(BV_MU, BV_J0, BV_KAPPA, h_bv, h_bv, BV_DT, SUBSTEPS,
                                remat=False), TOL_BV["bf16"])
    _check_charging(torch, bv_env, gen, "BV")
    sbm_env0 = make_sbm_butler_volmer_control_env(fused_epilogue=False, **sbm_kw)
    sbm_state, sbm_counts, sbm_rate = _drive_fleet(torch, kernels, sbm_env, sbm_env0, gen,
                                                   "SBM", 1e-4, may_diverge=True)
    _check(sbm_counts["sbm_bv_macro_ep"] == STEPS
           and sbm_counts["sbm_bv_macro"] == FLEET_STEPS_NO_EP, f"SBM launches {sbm_counts}")
    _check_late(torch, sbm_env, sbm_state, "sbm_bv_macro",
                lambda uu, cc: sbm_bv_macro_cuda(uu, cc, sbm_consts, **sbm_kw_macro),
                lambda uu, cc: sbm_bv_macro_plain(uu, cc, sbm_consts, **sbm_kw_macro),
                sbm_bv_reference(BV_MU, BV_J0, BV_KAPPA, sbm_consts.psi.double(), h_bv, h_bv,
                                 BV_DT, SUBSTEPS, remat=False), TOL_BV["f32"])
    _check_charging(torch, sbm_env, gen, "SBM")
    _check_card_grad(torch, dev, gen, "bv_cc macro (K6 forward, bf16)",
                     lambda: make_bv_cc_fused_macro(BV_MU, BV_J0, BV_KAPPA, GRID, GRID, h_bv,
                                                    h_bv, BV_DT, GRAD_STEPS))
    _check_card_grad(torch, dev, gen, "sbm_bv macro (K7 forward)",
                     lambda: make_sbm_bv_fused_macro(BV_MU, BV_J0, BV_KAPPA,
                                                     sbm_env.static_equation_parameters["psi"],
                                                     h_bv, h_bv, BV_DT, GRAD_STEPS))

    # ---- 5c/5d. the 3D mobility path (K8 3D) and the derivs="pallas" fleet (K8 2D)
    m3_counts, m3_per_call = _drive_mobility(torch, kernels, dev, gen, card)
    pallas_counts, pallas_rate = _drive_pallas_fleet(torch, kernels, dev, gen, card)
    _check_m3_card_grad(torch, dev, gen)

    # ---- 5e. the CH and AC fleets on the packed-DFT macros (K9a, K9b) ------
    dft_ch_counts, dft_ch_rate = _drive_dft_fleet(torch, kernels, make_cahn_hilliard_control_env,
                                                  "CH", "ch_sif_macro", card)
    dft_ac_counts, dft_ac_rate = _drive_dft_fleet(torch, kernels, make_allen_cahn_control_env,
                                                  "AC", "ac_sif_macro", card)

    # ---- 6. the training path ---------------------------------------------
    from pde_opt_tpu_torch import Domain, PDEModel
    from pde_opt_tpu_torch.models import CahnHilliard2DPeriodic
    from pde_opt_tpu_torch.ops.integrate import evolve
    from pde_opt_tpu_torch.ops.steppers import (
        FusedSemiImplicitSpectral,
        SemiImplicitFourierSpectral,
    )
    from pde_opt_tpu_torch.utils.compat import prepare_solver_params

    L = 0.01 * GRID
    domain = Domain((GRID, GRID), ((-L / 2, L / 2), (-L / 2, L / 2)), "dimensionless")
    macro_tg = make_ch_cas_fused_macro(CH_MU, GRID, GRID, HX, HY, A, DT, SUBSTEPS)

    def value_and_grad(loss):
        k = kap_tg.clone().requires_grad_()
        v = loss(k)
        v.backward()
        return v.detach(), k.grad

    def fused_loss(k, m=macro_tg):
        return (m(u_tg, k) ** 2).sum()

    def sif_loss(k):
        eq = CahnHilliard2DPeriodic(domain, k[:, None, None], CH_MU, torch.ones_like)
        st = SemiImplicitFourierSpectral(
            **prepare_solver_params(SemiImplicitFourierSpectral, {"A": A}, eq))
        return (evolve(st, eq.rhs, u_tg, 0.0, DT, SUBSTEPS) ** 2).sum()

    losses = []

    def objective(sol):
        v = sol[-1].var(dim=(-2, -1), correction=0).sum()
        losses.append(v.detach())
        return v

    model = PDEModel(CahnHilliard2DPeriodic, domain, FusedSemiImplicitSpectral)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    vg = [value_and_grad(fused_loss) for _ in range(TG_CALLS)]
    torch.cuda.synchronize()
    tg_counts = kernels.launch_counts()
    res = model.optimize(
        objective, y0=u_tg, ts=OPT_TS, opt_parameters={"kappa": kap_tg},
        other_parameters={"mu": CH_MU, "D": torch.ones_like},
        solver_parameters={"A": A}, weights={"kappa": None}, lambda_reg=0.0,
        max_steps=OPT_STEPS, dt0=DT, method="adam", learning_rate=1e-4)
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()

    n_seg = len(OPT_TS) - 1
    print(f"training path: {TG_CALLS} value+grad calls and {OPT_STEPS} optimize steps "
          f"({n_seg} checkpointed segments of {SUBSTEPS} substeps) at {TG_ENVS} envs x "
          f"{GRID}^2; launches {train_counts}", flush=True)
    _check(all(bool(torch.isfinite(v)) and bool(torch.isfinite(g).all()) for v, g in vg),
           "non-finite value or gradient")
    _check(tg_counts["ch_cas_macro"] == TG_CALLS and tg_counts["ch_cas_macro_bwd"] == TG_CALLS,
           f"value+grad launches {tg_counts} != {TG_CALLS} each")
    want_k2 = TG_CALLS + OPT_STEPS * n_seg * 2       # forward + checkpoint recompute
    want_k3 = TG_CALLS + OPT_STEPS * n_seg
    _check(train_counts["ch_cas_macro"] == want_k2 and train_counts["ch_cas_macro_bwd"] == want_k3
           and train_counts["ch_cas_macro_ep"] == 0,
           f"training launches {train_counts}: expected K2 {want_k2}, K3 {want_k3}")
    _check(len(losses) == OPT_STEPS and all(bool(torch.isfinite(v)) for v in losses),
           f"optimize losses {losses}")
    kap_opt = res["kappa"]
    moved = (kap_opt - 0.004).abs()
    _check(kap_opt.shape == (TG_ENVS,) and bool(torch.isfinite(kap_opt).all())
           and bool((moved > 0).all()),
           "kappa must be finite and move in every env")
    print(f"optimize: loss {float(losses[0]):.6e} -> {float(losses[-1]):.6e}; kappa moved in "
          f"every env, |change| {moved.min().item():.3e} to {moved.max().item():.3e}",
          flush=True)

    # f32 matrices: the fused kappa gradient against autograd through the
    # FFT oracle (the same semantics; tests/test_fused_grad.py's tolerance).
    macro32 = make_ch_cas_fused_macro(CH_MU, GRID, GRID, HX, HY, A, DT, SUBSTEPS,
                                      mats_dtype=torch.float32)
    oracle = ch_cas_macro_reference(CH_MU, HX, HY, A, DT, SUBSTEPS)
    _, g32 = value_and_grad(lambda k: fused_loss(k, macro32))
    _, g_or = value_and_grad(lambda k: (oracle(u_tg, k) ** 2).sum())
    rel = ((g32 - g_or).abs() / (1e-6 + 2e-3 * g_or.abs())).max().item()
    print(f"check fused dkappa (f32) vs FFT-oracle autograd: max |diff| / (1e-6 + 2e-3 |ref|) "
          f"= {rel:.3e}", flush=True)
    _check(rel <= 1.0, "fused kappa gradient disagrees with the FFT oracle's")

    # ---- 6b. training through K9a; the repaired module-parameter fault -------
    dft_train_counts, dft_grad_ms = _check_k9_training(torch, kernels, dev, gen, u_tg, kap_tg,
                                                       card)
    _check_module_fault(torch, dev)

    # ---- 7. timings ------------------------------------------------------
    consts = cas_constants(GRID, GRID, HX, HY, torch.bfloat16, dev)
    timings = {}
    px = GRID * GRID * (GRID + GRID)            # operations / 2 of one transform
    for name, ep in (("ch_cas_macro_ep", Epilogue(255.0, 0.0, CENTER, 1)),
                     ("ch_cas_macro", None)):
        kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True, epilogue=ep)
        _time_pair(torch, timings, name, lambda: ch_cas_macro_plain(u, kap, consts, **kw),
                   lambda: ch_cas_macro_cuda(u, kap, consts, **kw),
                   f"{NUM_ENVS}x{GRID}^2x{SUBSTEPS} bf16", card,
                   4 * px * SUBSTEPS * NUM_ENVS)

    kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
    g_tg = 2.0 * ch_cas_macro_plain(u_tg, kap_tg, consts, **kw)
    _time_pair(torch, timings, "ch_cas_macro_bwd",
               lambda: ch_cas_macro_bwd_plain(u_tg, kap_tg, g_tg, consts, **kw),
               lambda: ch_cas_macro_bwd_cuda(u_tg, kap_tg, g_tg, consts, **kw),
               f"{TG_ENVS}x{GRID}^2x{SUBSTEPS} bf16", card, 14 * px * SUBSTEPS * TG_ENVS)
    from pde_opt_tpu_torch.ops.cas_spectral import ac_cas_macro_cuda, ac_cas_macro_plain
    from pde_opt_tpu_torch.ops.gpe_cas import (
        GpeEpilogue,
        gpe_constants,
        gpe_strang_macro_cuda,
        gpe_strang_macro_plain,
    )

    for name, ep in (("ac_cas_macro_ep", Epilogue(127.5, 127.5, 0.0, 1)), ("ac_cas_macro", None)):
        kw = dict(mu_fn=AC_MU, R_fn=AC_R, r_identity=True, dt=DT, A=A, n_steps=SUBSTEPS,
                  round_bf16=True, epilogue=ep)
        _time_pair(torch, timings, name, lambda: ac_cas_macro_plain(u_ac, kap_ac, consts, **kw),
                   lambda: ac_cas_macro_cuda(u_ac, kap_ac, consts, **kw),
                   f"{AC_ENVS}x{GRID}^2x{SUBSTEPS} bf16, R == 1", card,
                   6 * px * SUBSTEPS * AC_ENVS)
    gconsts = gpe_constants(GRID, GRID, dx_gpe, gpe_env.dt_sub, torch.bfloat16, dev)
    for name, ep in (("gpe_strang_macro_ep", GpeEpilogue(2550.0, spot)), ("gpe_strang_macro", None)):
        kw = dict(g=GPE_G, dt=gpe_env.dt_sub, dx=dx_gpe, n_steps=SUBSTEPS, round_bf16=True,
                  phase_poly=True, epilogue=ep)
        _time_pair(torch, timings, name,
                   lambda: gpe_strang_macro_plain(y_gpe, ctrl_gpe, v_gpe, gconsts, **kw),
                   lambda: gpe_strang_macro_cuda(y_gpe, ctrl_gpe, v_gpe, gconsts, **kw),
                   f"{GPE_ENVS}x{GRID}^2x{SUBSTEPS} bf16, phase polynomials", card,
                   (SUBSTEPS + 1) * 8 * px * GPE_ENVS)
    for name, ep in (("bv_cc_macro_ep", Epilogue(255.0, 0.0, CENTER, 1)), ("bv_cc_macro", None)):
        kw = {**bv_kw_macro, "epilogue": ep}
        _time_pair(torch, timings, name, lambda: bv_cc_macro_plain(u_bv, cr_bv, bconsts, **kw),
                   lambda: bv_cc_macro_cuda(u_bv, cr_bv, bconsts, **kw),
                   f"{BV_ENVS}x{GRID}^2x{SUBSTEPS} bf16", card, 16 * px * SUBSTEPS * BV_ENVS)
    for name, ep in (("sbm_bv_macro_ep", SbmEpilogue(255.0, CENTER)), ("sbm_bv_macro", None)):
        kw = {**sbm_kw_macro, "epilogue": ep}
        _time_pair(torch, timings, name,
                   lambda: sbm_bv_macro_plain(u_sbm, cr_sbm, sbm_consts, **kw),
                   lambda: sbm_bv_macro_cuda(u_sbm, cr_sbm, sbm_consts, **kw),
                   f"{SBM_ENVS}x{GRID}^2x{SUBSTEPS} f32", card)

    from pde_opt_tpu_torch.ops.fused import (
        ch3d_rhs_fd_cuda,
        ch3d_rhs_fd_plain,
        ch_rhs_fd_cuda,
        ch_rhs_fd_plain,
    )

    for name, (uu, kk, (mu, D)), cuda, plain, kw, what in (
            ("ch_rhs_fd", k8_2d, ch_rhs_fd_cuda, ch_rhs_fd_plain, dict(hx=HX, hy=HY),
             f"{NUM_ENVS}x{GRID}^2, c^3 - c and D == 1"),
            ("ch3d_rhs_fd", k8_3d, ch3d_rhs_fd_cuda, ch3d_rhs_fd_plain,
             dict(h1=0.01, h2=0.01, h3=0.01), f"{M3_ENVS}x{M3_N}^3, Legendre mu and D")):
        kw = dict(kw, mu_fn=mu, D_fn=D)
        _time_pair(torch, timings, name, lambda: plain(uu, kk, **kw), lambda: cuda(uu, kk, **kw),
                   what, card)

    from pde_opt_tpu_torch.ops.fused_spectral import (
        ac_sif_macro_cuda,
        ac_sif_macro_plain,
        ch_sif_macro_cuda,
        ch_sif_macro_plain,
        sif_constants,
    )

    # K9a and K9b at the shapes K2 and K4 were timed at.
    sconsts = sif_constants(GRID, GRID, HX, HY, torch.bfloat16, True, dev)
    kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
    _time_pair(torch, timings, "ch_sif_macro", lambda: ch_sif_macro_plain(u, kap, sconsts, **kw),
               lambda: ch_sif_macro_cuda(u, kap, sconsts, **kw),
               f"{NUM_ENVS}x{GRID}^2x{SUBSTEPS} bf16", card,
               (SUBSTEPS + 0.5) * _dft_ops(GRID, GRID) * NUM_ENVS)
    kw_ac = dict(mu_fn=AC_MU, R_fn=AC_R, r_identity=True, hx=HX, hy=HY, dt=DT, A=A,
                 n_steps=SUBSTEPS, round_bf16=True)
    _time_pair(torch, timings, "ac_sif_macro",
               lambda: ac_sif_macro_plain(u_ac, kap_ac, sconsts, **kw_ac),
               lambda: ac_sif_macro_cuda(u_ac, kap_ac, sconsts, **kw_ac),
               f"{AC_ENVS}x{GRID}^2x{SUBSTEPS} bf16, R == 1", card,
               SUBSTEPS * _dft_ops(GRID, GRID) * AC_ENVS)
    print(f"K9a vs K2: {timings['ch_sif_macro'][0]:.4f} vs {timings['ch_cas_macro'][0]:.4f} ms "
          f"({timings['ch_sif_macro'][0] / timings['ch_cas_macro'][0]:.2f}x); K9b vs K4: "
          f"{timings['ac_sif_macro'][0]:.4f} vs {timings['ac_cas_macro'][0]:.4f} ms "
          f"({timings['ac_sif_macro'][0] / timings['ac_cas_macro'][0]:.2f}x) [{card}]", flush=True)

    # The GPE fleet on its fused path (K5) against its FFT path
    # (StrangSplitting(fast_evolve=True)), as bench.py's gpe64 compares them:
    # 30-step random-policy rollouts, in turns.
    gpe_fft = make_gpe_control_env(num_envs=GPE_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                   box_size=GPE_BOX, k_interaction=GPE_G, spectral_solve="fft",
                                   device=dev)

    def fleet_rate(e, n=30):
        st, _ = e.reset(gen)
        e.make_rollout(lambda o, g: e.sample_actions(g), 2)(st, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.make_rollout(lambda o, g: e.sample_actions(g), n)(st, gen)
        torch.cuda.synchronize()
        return e.num_envs * n / (time.perf_counter() - t0)

    r_f1, r_x1, r_x2, r_f2 = (fleet_rate(e) for e in (gpe_env, gpe_fft, gpe_fft, gpe_env))
    gpe_fused_rate, gpe_fft_rate = (r_f1 + r_f2) / 2, (r_x1 + r_x2) / 2
    print(f"GPE fleet fused vs fft: {r_f1:.1f} / {r_f2:.1f} vs {r_x1:.1f} / {r_x2:.1f} "
          f"env-steps/s, {gpe_fused_rate / gpe_fft_rate:.2f}x ({GPE_ENVS} envs x {GRID}^2 x "
          f"{SUBSTEPS} substeps, 30 steps) [{card}]", flush=True)
    # The BV and SBM fleets on their fused paths (K6, K7) against their RK4
    # paths, as bench.py's _bv_rate and run_sbm_bv compare them.
    for name, env_f, make, kw in (("BV", bv_env, make_butler_volmer_control_env, bv_kw),
                                  ("SBM", sbm_env, make_sbm_butler_volmer_control_env, sbm_kw)):
        env_r = make(method="rk4", **kw)
        r_f1, r_x1, r_x2, r_f2 = (fleet_rate(e) for e in (env_f, env_r, env_r, env_f))
        print(f"{name} fleet fused vs rk4: {r_f1:.1f} / {r_f2:.1f} vs {r_x1:.1f} / {r_x2:.1f} "
              f"env-steps/s, {(r_f1 + r_f2) / (r_x1 + r_x2):.2f}x ({env_f.num_envs} envs x "
              f"{GRID}^2 x {SUBSTEPS} substeps, 30 steps) [{card}]", flush=True)

    rates = {}
    for name, loss in (("fused", fused_loss), ("fft", sif_loss)):
        ms = _time_ms(torch, lambda: value_and_grad(loss), reps=5, warmup=1)
        rates[name] = TG_ENVS * SUBSTEPS / (ms * 1e-3)
        print(f"time value+grad {name}: {ms:.4f} ms per call, {rates[name]:.1f} "
              f"grad-env-substeps/s ({TG_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps) [{card}]",
              flush=True)
    print(f"fused vs fft value+grad: {rates['fused'] / rates['fft']:.2f}x [{card}]", flush=True)
    kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
    k2_tg = _time_ms(torch, lambda: ch_cas_macro_cuda(u_tg, kap_tg, consts, **kw))
    k3_tg = timings["ch_cas_macro_bwd"][0]
    print(f"value+grad fused: K2 at {TG_ENVS} envs {k2_tg:.4f} ms + K3 {k3_tg:.4f} ms = "
          f"{k2_tg + k3_tg:.4f} ms of a {TG_ENVS * SUBSTEPS / rates['fused'] * 1e3:.4f} ms call "
          f"[{card}]", flush=True)
    dft_rate = TG_ENVS * SUBSTEPS / (dft_grad_ms * 1e-3)
    print(f"value+grad dft (K9a + oracle backward) vs cas (K2 + K3): {dft_rate:.1f} vs "
          f"{rates['fused']:.1f} grad-env-substeps/s, {dft_rate / rates['fused']:.2f}x [{card}]",
          flush=True)

    y1 = state.y.clone()
    cv1 = state.control_value.clone()
    obs1 = env.state_to_observation_func(y1)
    none = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
    reset_ms = _time_ms(torch, lambda: env._auto_reset(none, y1, cv1, obs1))
    step_ms = (t_a + t_b) / STEPS * 1e3
    rate = NUM_ENVS * STEPS / (t_a + t_b)
    print(f"time auto-reset block (fleet-wide draw + selects): {reset_ms:.4f} ms per step, "
          f"{reset_ms / step_ms:.3%} of a {step_ms:.4f} ms env step [{card}]", flush=True)
    print(f"rollout: {rate:.1f} env-steps/s ({STEPS} steps in {t_a + t_b:.4f} s, "
          f"{NUM_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps) [{card}]", flush=True)
    print(f"AC rollout: {ac_rate:.1f} env-steps/s ({STEPS} steps, {AC_ENVS} envs x {GRID}^2 x "
          f"{SUBSTEPS} substeps, fused epilogue) [{card}]", flush=True)
    print(f"GPE rollout: {gpe_rate:.1f} env-steps/s ({STEPS} steps, {GPE_ENVS} envs x {GRID}^2 "
          f"x {SUBSTEPS} substeps, fused epilogue) [{card}]", flush=True)
    print(f"BV rollout: {bv_rate:.1f} env-steps/s ({STEPS} steps, {BV_ENVS} envs x {GRID}^2 "
          f"x {SUBSTEPS} substeps, fused epilogue) [{card}]", flush=True)
    print(f"SBM rollout: {sbm_rate:.1f} env-steps/s ({STEPS} steps, {SBM_ENVS} envs x "
          f"{GRID}^2 x {SUBSTEPS} substeps, fused epilogue) [{card}]", flush=True)
    print(f"CH fleet algo=dft rollout: {dft_ch_rate:.1f} env-steps/s (K9a, no epilogue) vs "
          f"{rate:.1f} (K1); AC fleet algo=dft: {dft_ac_rate:.1f} (K9b) vs {ac_rate:.1f} (K4) "
          f"[{card}]", flush=True)
    print(f"CH derivs=pallas fft rollout: {pallas_rate:.1f} env-steps/s ({PALLAS_FFT_STEPS} "
          f"steps, {NUM_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps, K8 {SUBSTEPS} a step); "
          f"3D mobility path: {m3_per_call:.0f} K8 launches a call [{card}]", flush=True)

    # ---- 8. the RL learners on the flagship fleet (K1) ----------------------
    ppo_counts = _drive_ppo(torch, kernels, dev, card)
    dqn_counts, ddpg_counts = _drive_dqn_ddpg(torch, kernels, dev, card)

    # ---- 9. the CH macros above 64^2: the tiled K1-K3 -----------------------
    big_err = _check_big(torch, dev, gen)
    print(f"tiled kernels' largest bf16 field errors: {big_err}", flush=True)
    big_counts = _drive_big(torch, kernels, dev, gen, card)

    # Launches: each path's own run (CH serving and training together).
    max_err["ch_cas_macro_bwd"] = bwd_err
    launches = {n: sum(c[n] for c in (counts, train_counts, ac_counts, gpe_counts, bv_counts,
                                      sbm_counts, m3_counts, pallas_counts, dft_ch_counts,
                                      dft_ac_counts, dft_train_counts, ppo_counts, dqn_counts,
                                      ddpg_counts, *big_counts)) for n in KERNELS}
    _check(all(v > 0 for v in launches.values()), f"a kernel was never launched: {launches}")
    bounds = _bounds()
    # library_ms is null for every kernel: no single PyTorch call computes a
    # whole macro (transforms, closure and epilogue over all substeps; K9's
    # carried spectrum or roll Laplacian), nor the flux rhs of K8 (mu, D, two
    # stencils and a face flux).
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[lib], "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timings[name][0], "plain_ms": timings[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (lib, replaces) in KERNELS.items()
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
