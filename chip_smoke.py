#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Thirty-four paths run at full width.  Serving: the flagship Cahn-Hilliard (CH)
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
to the net's parameters).  Above 64^2 on the tiled K4, K5 and K3: the GPE
fleet of ``run_gpe128`` (BASELINE config 5: 256 envs x 128^2), the AC fleet
at ``run_ch128``'s shape (1024 envs x 128^2) and the value and gradient of
``sum(macro(u, kappa)^2)`` at ``run_ch256``'s shape (256 envs x 256^2).
The inverse-problem layer at the JAX package's examples' sizes: the 32^3
Legendre mu and D fit by Levenberg-Marquardt (``examples/optimize_3d.py``),
the 128^2 NN-mu fit by L-BFGS (``examples/optimize_nn.py --grid 128``) and
an adaptive Allen-Cahn solve (Tsit5 under a PID controller).  The
rotating-frame GPE at the JAX bench's ``run_gpe_rot`` (512 fields of 64^2,
50 imaginary-time substeps a call, the batched-matmul ADI and the FFT ADI)
and its stirring fleet (1024 envs x 64^2 x 10), and the SBM fleet (1024
envs) on a level set from the ``Shape`` smoothing flow.  Above 64^2 on the
tiled K6 and K7: the BV charging fleet at 512 envs x 128^2 and the SBM
fleet at 256 envs x 128^2 (analytic psi).  Above 64^2 on the tiled K9a and
K9b: the CH and AC fleets with ``algo="dft"`` at 1024 envs x 128^2, K9a at
``run_ch256``'s shape and a value+grad through K9a at 1024 x 128^2.  The CH
fleet with ``spectral_solve="dense"`` (the dense spectral solve, 4096 x
64^2) and one backward-Euler solve by Newton-GMRES (``ImplicitEuler``).
Per-env stepping (the JAX env's default mode) of the CH and AC fleets at
4096 x 64^2 x 10 through K2, K9a, K8, the dense solve, K4 and K9b, against
their batched twins; a time-dependent advection-diffusion fleet; the gym
adapter's core; checkpoint and resume of the flagship fleet.  The scale-out
layer (``pde_opt_tpu_torch.parallel``) on a one-rank NCCL group: the
sharded flagship (K1, K2) and GPE (K5) fleets against the unsharded ones,
the halo functions and the distributed FFT pairs on a 4096^2 field and a
256^3 volume, the sharded SIF macros at those sizes, ``ppo_train(mesh=...)``
at ``run_ppo``'s shape and the multi-card dry run (K2, K3); its four-card
run is ``scripts/torch_multichip.py``.
Phases (each passes or raises; nothing is
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
   without the fused epilogue (K2).  Check the rewards, the launch counts
   (and one fleet-reset pass a fused step, none without the epilogue),
   the per-env mass drift and the epilogue reward against the env's own
   reward function; poison one env with NaN and check it is flagged and
   reset.
5. The same for the AC fleet (K4: 120 steps with the epilogue, 10 without),
   the GPE fleet (K5: likewise; the per-env norm must stay 1), the BV
   fleet (K6) and the SBM fleet (K7; 40-step episodes, so every env resets
   twice), each with its launch counts reset just before and read just
   after (the fleet-reset pass once a fused BV step, never in the others).
   For BV and SBM one more zero-action step must charge each env
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
   fleets, and the dft value+grad against the cas one.  The fleet-reset
   pass at the three cells' fleets (CH 4096 x 64^2 and 4096 x 128^2, BV
   2048 x 64^2) against the torch auto-reset and the step's in-place
   copies, from the same card tensors and draw, with no env, every third
   env and every env ended, an env gone NaN and a carried NaN pixel: the
   state, the next observation and the untouched step observation bit for
   bit; then timed alone against that twin fed the same draw.  Each kernel's
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
   128^2 fleet (30 steps, K1 and the fleet-reset pass only), the 256^2 macro (20 chained calls, K2
   only, per-env mass held) and the NN-control value+grad (K2 and K3 once a
   call; with f32 matrices also against the CPU on a few envs).  Their
   rates, and the tiled kernels' times beside their plain versions' and
   their bounds at these shapes.
10. The AC and GPE macros above 64^2 and K3 at 256^2 (the tiled K4, K5,
   K3).  K4 (R == 1 and a polynomial R) and K5 (phase polynomials on and
   off) against their plain versions at 128^2, 96 x 136 and 256^2, f32 and
   bf16 matrices, epilogue off and on, K3 at 256^2; each launch with a NaN
   env that must stay in its env, at phase 3's bounds (K3's bf16 check by
   phase 9's rule); one bf16 substep of K4 and K5 at the rounding sites.
   Then the three paths, each with its launch counts reset just before and
   read just after, under sync debug mode "error": the GPE 128^2 fleet and
   the AC 128^2 fleet (STEPS steps across the episode end, then
   FLEET_STEPS_NO_EP without the epilogue: K5, K4 only; rewards, episode
   ends, a poisoned env, per-env GPE norms) and the 256^2 value+grad (K2
   and K3 once a call).  The GPE fleet's fused and fft rates in turns; each
   kernel against plain at its path's shape (K4, K5 also where a block walks
   several envs through its slot) and timed beside plain and its bound.
11. The inverse-problem layer, with the launch counts reset just before and
   read just after (none of K1-K9 may launch; no kernel of the port lies on
   this path, as no Pallas kernel does in JAX): (a) the 32^3 fit of
   ``examples/optimize_3d.py`` (Legendre mu and D from zeros,
   ``PDEModel.train(method="least_squares")``, f32): its Jacobian at theta0
   against the CPU's in f64, the loss falling 100x, the coefficients within
   2e-2 of the truth; the LM steps, seconds, ms an iteration and a Jacobian.
   (b) ``examples/optimize_nn.py``'s data at 128^2 with a seeded
   ``PeriodicCNN`` mu and 5 L-BFGS steps of ``train(method="mse")``: the
   first loss and gradient against the CPU's in f64, a loss that falls, ms
   a step.  (c) ``Mixer2d`` on 128^2 fields: output and input gradient
   against the CPU's in f64.  (d) a 2D Allen-Cahn ``PDEModel.solve`` with
   ``Tsit5`` and ``PIDController(1e-4, 1e-6)`` in f64 and f32 against the
   CPU's f64 saves, the accepted and rejected step counts.  Every tensor
   the phase makes lies on the card.
12. The rotating-frame GPE and the smoothed-boundary geometry (the
   constants ``ROT_*`` and ``TOL_SHAPE`` say how): (a) ``run_gpe_rot``, the
   matmul ADI macro against ``DirectionalSplitting`` on the card and both
   against the CPU's f64, their field-substeps/s, the sweeps' layout timed,
   the vortex census against the CPU's; (b) the stirring fleet: a rollout,
   its auto-reset, fused against fft from one state (12a-b launch none of
   K1-K9); (c) the SBM fleet with ``smooth_geometry=True``: the construction
   seconds and Tsit5 step counts, psi against the CPU's f64 ``Shape`` (run
   by a child process from the start of the script), K7 against plain at
   that psi, the charge balance, and the fleet's rollout (K7 once a step).
13. The BV and SBM macros above 64^2 (the tiled K6 and K7; the constants
   ``BVBIG_*``, ``*128*`` say how).  (a) K6 (f32 and bf16 matrices) and K7
   (the preset's analytic psi) against their plain versions at 128^2, 96 x
   136 and 256^2, epilogue off and on, on more envs than resident blocks
   and with a NaN env that must stay in its env, at phase 3's bounds; at
   128^2 against the roll-stencil oracles, and one bf16 K6 substep at the
   rounding sites.  (b) The BV 128^2 fleet (512 envs, K6 alone, once a
   step) and (c) the SBM 128^2 fleet (256 envs, K7 alone), each with its
   launch counts reset just before and read just after, under sync debug
   mode "error": STEPS steps across the episode end and FLEET_STEPS_NO_EP
   without the epilogue, rewards, episode ends, a poisoned env, the charge
   balance, one step of the fused fleet against the RK4 fleet from one
   state.  (d) Their env-steps/s, and K6 and K7 at these shapes against
   plain, timed beside plain and their bounds.
14. The packed-DFT macros above 64^2 (the tiled K9a and K9b; the constants
   ``DFT128_*``, ``K9_VG_*`` say how), the dense solve and implicit Euler.
   (a) K9a, K9b (R == 1 and a polynomial R) against their plain versions
   at 128^2, 96 x 136 and 256^2, f32 and bf16 tables, half and full
   spectrum, a NaN env in each launch, bf16 also against two correct plain
   controls; at 128^2 one bf16 substep at the rounding sites and, with f32
   tables, against the FFT oracles and the tiled K2 / K4.  (b) The CH and AC
   dft fleets at 1024 x 128^2 (K9a, K9b alone, once a step; their rates
   beside phases 9 and 10's cas fleets at that shape), K9a at 256 x 256^2
   (chained calls, field-substeps/s), a value+grad through K9a at 1024 x
   128^2 (K9a once a call; f32 tables against the CPU on a few envs); K9a
   and K9b timed at these shapes beside plain and their bounds.  (c) The CH
   fleet with ``spectral_solve="dense"`` at 4096 x 64^2 x 10 (no K1-K9
   launch, rewards finite, its rate beside the fused fleet's, the product
   route named), one substep of its stepper against the CPU's.  (d) One
   ``ImplicitEuler.solve_step`` on the card against the CPU's (f64).
15. Per-env stepping (``vectorized_control=False``, the JAX env's default:
   ``torch.func.vmap`` of one env's macro-step), with PyTorch's
   batching-fallback warning as an error (the constants ``PE_*`` say how).
   (a) The CH fleets (fused K2, fused ``algo="dft"`` K9a, fft with
   ``derivs="pallas"`` K8, dense) and the AC fleets (fused K4, ``algo="dft"``
   K9b) per env at 4096 x 64^2 x 10, across an episode end under sync debug
   mode "error", launch counts reset just before and read just after: one
   launch a step (SUBSTEPS of K8, none for dense) and nothing else; each
   against its batched twin from one state, generator and action list
   (fields bit for bit on the one-launch paths), their rates side by side.
   (b) An advection-diffusion fleet whose velocity depends on each env's
   own time, from staggered times, against the CPU's f64.  (c) The gym
   adapter's step core on one env against env 0 of a per-env fleet.  (d) A
   checkpoint of the flagship fleet (K1) with its generator and a PPO net
   with its Adam state, restored into fresh objects and resumed bit for
   bit; ``max_to_keep``.
16. Scale-out at world size 1 on a one-rank NCCL group (the constants
   ``SO_*`` say how): (a) the sharded flagship fleet (K1) across an episode
   end and the sharded GPE fleet (K5), (b) the sharded fleet without the
   epilogue (K2), each against the unsharded fleet from one seed and one
   action list, bit for bit, one launch a step; (c) the halo functions and
   the distributed FFT pairs against ``torch.roll`` stencils and
   ``torch.fft``; (d) the sharded 2D and 3D SIF macros against the
   one-card FD-symbol update; (e) one ``ppo_train(mesh=...)`` update
   against the unsharded update, and one under sync debug mode "error";
   (f) ``dryrun_multichip(1)``'s ``MULTICHIP_SCALING`` line.

Every rollout and update of phases 4-10, 12, 13, 14, 15a and 16a-b and one
of 16e (but 14b's value+grad) runs under
``torch.cuda.set_sync_debug_mode("error")``: a step that waits for the device
fails the run.  Phase 11's loops and phase 12's smoothing flow read a value
each step by design (LM's loss, the adaptive controller's error norm).  The last two lines are a
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
           "ac_sif_macro": "pde_opt_tpu_torch/csrc/ac_sif_macro.cu",
           "fleet_reset": "pde_opt_tpu_torch/csrc/fleet_reset.cu"}
# The env fleet's auto-reset pass: its launch count's key.
FLEET_RESET = "vector_env.fleet_reset"
# kernel (launch-count name) -> (library, the TPU kernel it replaces; None
# where XLA fused the work inside the JAX step and no TPU kernel was written)
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
    FLEET_RESET: ("fleet_reset", None),
}
# Of the K1/K2 launches above, those that ran the on-chip kernel (bf16, up
# to 128^2): counted again under this key.  Every key with a "." is such a
# sub-count (``bv_cc_macro.tiled``: K6's launches above 64^2), so the sums of
# all keys leave them out.
ONCHIP = "ch_cas_macro.onchip"
# Of those, the launches that built each env's multipliers once into the
# kernel's folded table (CasConstants.fold): every one at the presets' spacing.
ONCHIP_FOLD = "ch_cas_macro.onchip_fold"
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
# 8.7e-3 for the f64 control (H100, one-off A/B in CHANGES.md), so that check
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
# The AC and GPE macros above 64^2 and K3 at 256^2 (the tiled K4, K5 and K3,
# phase 10).  Kernel against plain at BIG_GRIDS on BIG_CHECK_ENVS envs: K4
# f32 and bf16, R == 1 and R = 1 + 0.5 u^2, epilogue off and on; K5 f32 and
# bf16, phase polynomials on and off, epilogue off and on (the fleet's box
# and g on square cells, dt 2e-3); K3 at 256 x 256^2 (run_ch256's fields and
# dt, the loss's cotangent); a NaN env in each; one bf16 substep of K4 and K5
# at 128^2 at the rounding sites; at phase 3's bounds (TOL_AC, TOL_GPE,
# TOL_BWD with phase 9's rule, TOL_SITE).  Then the paths, uncut: bench.py's
# run_gpe128 (BASELINE config 5: 256 envs x 128^2 x 10, the preset's fused
# epilogue, K5; its fft mode timed beside it in turns over GPE128_FFT_STEPS),
# the AC preset at run_ch128's shape (1024 x 128^2 x 10, R == 1, K4), both
# over STEPS steps across the episode end and FLEET_STEPS_NO_EP without the
# epilogue, and the 256^2 value+grad of sum(macro(u, kappa)^2) at run_ch256's
# shape (K2 + K3, VG256_CALLS calls).  Each kernel is held against plain
# and timed at its path's shape; K4 and K5 also where a block walks several
# envs through its slot (1024 envs at 128^2).
GPE128_ENVS, GPE128_GRID, GPE128_DT, GPE128_FFT_STEPS = 256, 128, 2e-3, 10
AC128_ENVS, AC128_GRID = 1024, 128
VG256_CALLS = 3
WALK_ENVS = 1024
# The inverse-problem layer (phase 11), at the JAX package's examples' own
# sizes (pde_opt_tpu_torch/bench/inverse.py).  (a) examples/optimize_3d.py:
# 32^3, L = 0.32, kappa 0.002, the SIF stepper with A 0.5 on the FD rhs, dt0
# 2.5e-4, saves at linspace(0, 0.004, 9), windows [[0, 2, 4], [4, 6, 8]],
# truth mu [0, 1, 0.5] and D [0.3, 0.2], both fitted from zeros by LM
# (train(method="least_squares"), at most FIT3D_STEPS steps), f32; the
# initial field from numpy seed 0.  Its Jacobian at theta0 against the CPU's
# in f64 (relative Frobenius error TOL_FIT_JAC), the loss falling by
# FIT3D_LOSS_DROP, the coefficients within TOL_FIT_COEF of the truth (the
# atol of tests/test_3d.py:138).  (b) examples/optimize_nn.py --grid 128: the
# same dynamics in 2D with the Flory-Huggins mu, a PeriodicCNN(1,
# NNFIT_HIDDEN, 1, 3) mu, NNFIT_STEPS L-BFGS steps of train(method="mse");
# its first loss and gradient against the CPU's in f64 (relative TOL_NNFIT),
# and a loss that falls.  (c) Mixer2d (patch 8, hidden 64, token and channel
# MLPs 256 wide, 4 blocks) on MIXER_BATCH 128^2 fields: output and input
# gradient against the CPU's in f64 (relative TOL_MIXER).  (d) a 2D
# Allen-Cahn PDEModel.solve with Tsit5 under PIDController(1e-4, 1e-6) at
# 128^2 from a field of amplitude 0.1: in f64 on the card, the CPU's f64
# saves within TOL_ADAPT and the same step counts; in f32, the CPU's final
# save (a step end) within TOL_ADAPT.
FIT3D_GRID, FIT3D_STEPS, FIT3D_JAC_REPS = 32, 60, 3
FIT3D_LOSS_DROP, TOL_FIT_JAC, TOL_FIT_COEF = 100.0, 1e-3, 2e-2
NNFIT_GRID, NNFIT_HIDDEN, NNFIT_STEPS, TOL_NNFIT = 128, (16, 16), 5, 1e-3
MIXER_GRID, MIXER_ARGS, MIXER_BATCH, MIXER_REPS, TOL_MIXER = 128, (8, 64, 256, 256, 4), 8, 10, 1e-4
ADAPT_GRID, ADAPT_KAPPA, ADAPT_T_END, ADAPT_SAVES, ADAPT_DT0, ADAPT_TOL, TOL_ADAPT = (
    128, 0.002, 0.05, 6, 1e-4, (1e-4, 1e-6), 1e-4)
# The rotating-frame GPE and the smoothed-boundary geometry (phase 12), at
# bench.py's shapes.  (a) run_gpe_rot: ROT_ENVS fields of 64^2, box 20, k
# 500, e 0, Omega 0.9, dt 2e-4, ROT_SUBSTEPS substeps a call in imaginary
# time, from initialize_Psi(64, width=14, vortexnumber=1) normalised; the
# matmul ADI macro (FusedRotatingSplitting's) against DirectionalSplitting
# on the card, and both against the CPU's f64 DirectionalSplitting on the
# first ROT_CPU_FIELDS fields, by density within TOL_ROT of the largest
# density (3.2e-5 to 5.2e-5 of it measured on an H100); the FFT path
# timed over ROT_FFT_CALLS calls and the matmul path over ROT_MM_CALLS;
# the ground state's vortex census at 0.05 max|psi| against the CPU's
# census of the same field.  (b) make_gpe_rot_control_env(1024, 64, 10):
# ROT_FLEET_STEPS steps (bench.py's 25) under sync debug mode "error",
# then a fleet with end_time ROT_RESET_END (11-step episodes on the f32
# clock) across two episode ends; the fused
# and fft paths from one shared state, one step: obs within 1 LSB, density
# within TOL_ROT_FLEET (the JAX env test's 5e-5).  (c) the SBM fleet on a
# Shape psi: make_sbm_butler_volmer_control_env(1024, 64,
# smooth_geometry=True), its psi against the CPU's f64 Shape of the same
# mask (computed in a child process while phases 2-11 run) within
# TOL_SHAPE (f32 against f64 on the CPU: 1.2e-4), K7 against plain at this
# psi (_check_sbm), the charge balance, STEPS + FLEET_STEPS_NO_EP steps.
# Phases 12a-b launch no K1-K9 kernel; 12c launches K7 once a step.
ROT_ENVS, ROT_GRID, ROT_BOX, ROT_K, ROT_OMEGA, ROT_DT, ROT_SUBSTEPS = 512, 64, 20.0, 500.0, 0.9, 2e-4, 50
ROT_FFT_CALLS, ROT_MM_CALLS, ROT_CPU_FIELDS, TOL_ROT = 3, 8, 8, 1e-4
ROT_FLEET_ENVS, ROT_FLEET_STEPS, ROT_RESET_END, TOL_ROT_FLEET = 1024, 25, 0.1, 5e-5
TOL_SHAPE = 1e-3
# The BV and SBM macros above 64^2 (the tiled K6 and K7, phase 13).  Kernel
# against plain at BIG_GRIDS on BVBIG_CHECK_ENVS envs, more than the resident
# blocks, so each block walks two or three envs through its scratch slot,
# with env BIG_NAN_ENV NaN: K6 with f32 and bf16 matrices, K7 on the
# preset's analytic psi of that grid, epilogue off and on, at phase 3's
# bounds (TOL_BV; stats to rtol 1e-4, obs 1 LSB); at 128^2 also against the
# roll-stencil oracles (TOL_BV_ORACLE, f32) and one bf16 substep of K6 at the
# rounding sites (TOL_SITE["bv"]).  Then the fleets, at the presets' widths
# (box 1, h = 1/128, 10 substeps, 40-step episodes):
# make_butler_volmer_control_env(BV128_ENVS) (512 x 128^2, the 64^2 fleet's
# 2048 x 64^2 pixels; K6) and make_sbm_butler_volmer_control_env(SBM128_ENVS)
# on the analytic psi (K7), each over STEPS steps across the episode end and
# FLEET_STEPS_NO_EP without the epilogue, the charge balance (TOL_CHARGE), and
# one step of the fused fleet against the RK4 fleet from one state on
# BIG_RK4_ENVS envs: K7 and K6 with f32 matrices at TOL_BV_ORACLE, the
# path's bf16 K6 at TOL_BV_RK4_BF16 (the JAX preset tests' bound for the
# fused env against RK4 with bf16 matrices; 2.0e-5 measured on the CPU at
# 128^2 after one step).  The 128^2 Shape psi is left out: its flow would
# take about 16 times the 64^2 flow's 68-91 s.
BVBIG_CHECK_ENVS = 600
BV128_ENVS, SBM128_ENVS, BVSBM128_GRID, BIG_RK4_ENVS = 512, 256, 128, 8
TOL_BV_RK4_BF16 = 5e-5
# The packed-DFT macros above 64^2 (the tiled K9a and K9b, phase 14).  Kernel
# against plain at BIG_GRIDS on BIG_CHECK_ENVS envs with env BIG_NAN_ENV NaN:
# K9a, K9b with R == 1 and with R = 1 + 0.5 u^2, f32 and bf16 tables, half
# and full spectrum, at phase 3's bounds (TOL_U, TOL_AC); bf16 at the larger
# of those and twice the farther of two correct plain controls (products
# accumulated in f64; on the TF32 tensor cores), as phase 13 holds K6 at
# 256^2; one bf16 substep of each at 128^2 at the rounding sites (TOL_SITE);
# with f32 tables on K9_ORACLE_ENVS envs at 128^2 against the FFT oracles and
# K9a against the tiled K2, K9b against the tiled K4 (the same semantics on
# the cas transform), both at TOL_K9_ORACLE.  Then the paths, uncut: the CH
# fleet with "algo": "dft" at run_ch128's shape (DFT128_ENVS x 128^2 x 10,
# K9a) and the AC fleet at phase 10's AC 128^2 shape (K9b), STEPS steps
# across the episode end; K9a at run_ch256's shape (BIG256_ENVS x 256^2 x 10,
# BIG256_CALLS chained calls); a value+grad of sum(macro(u, kappa)^2) through
# K9a (the checkpointed FFT oracle's backward) at DFT128_ENVS x 128^2 x 10,
# K9_VG_CALLS calls, and with f32 tables on K9_VG_CHECK_ENVS envs against the
# CPU (phase 6's bounds); the CH fleet with spectral_solve="dense" at the
# flagship's NUM_ENVS x 64^2 x 10 (DENSE_STEPS steps, no K1-K9 launch), one
# substep of its stepper on DENSE_CHECK_ENVS envs against the CPU's (the
# increment within TOL_DENSE of its largest entry: the half-solved field
# rounds to bf16 at ties that other sums round apart); one
# ImplicitEuler.solve_step on a stiff nonlinear rhs at IE_SHAPE in f64 on the
# card against the CPU's (TOL_IE).
DFT128_ENVS, DFT128_GRID = 1024, 128
K9_VG_CALLS, K9_VG_CHECK_ENVS = 3, 4
DENSE_STEPS, DENSE_CHECK_ENVS, TOL_DENSE = 30, 8, 1e-2
IE_SHAPE, TOL_IE = (4, 64, 64), 1e-10
# Per-env stepping (phase 15): the JAX env's default mode,
# vectorized_control=False, by torch.func.vmap of one env's macro-step.
# (a) Six per-env fleets at the flagship's width (4096 envs, AC_ENVS for
# AC) x 64^2 x 10 substeps, PE_STEPS random-policy steps across the episode
# end at PE_END: one K2, K9a, K4 or K9b launch a step (SUBSTEPS K8 launches
# for the fft stepper with derivs="pallas", none for the dense solve) and
# nothing else, each against its batched twin (vectorized_control=True,
# fused_epilogue=False, the same stepper) from one state, generator and
# action list: fields bit for bit on the one-launch paths, within
# TOL_PE_OTHER elsewhere; rewards to TOL_PE_REWARD of the largest.  (b) An
# advection-diffusion fleet whose velocity control also depends on t
# (PE_AD_ENVS x 64^2, RK4), started at staggered times, against the CPU's
# f64 for PE_AD_CHECK envs after PE_AD_STEPS steps, to TOL_PE_AD.  (c) The
# gym adapter's core (envs.vector_env.macro_step) on one env against env 0
# of a per-env fleet, PE_GYM_STEPS steps, bit for bit.  (d) Checkpoint and
# resume of the flagship fused-epilogue fleet (K1) with a PPO net and its
# Adam state, PE_RESUME_STEPS steps again bit for bit; max_to_keep.
PE_STEPS, PE_END = 30, 0.2
TOL_PE_OTHER, TOL_PE_REWARD = 1e-6, 1e-6
PE_AD_ENVS, PE_AD_STEPS, PE_AD_CHECK, TOL_PE_AD = 1024, 3, 4, 1e-5
PE_GYM_STEPS, PE_GYM_ENVS = 3, 64
PE_RESUME_AT, PE_RESUME_STEPS = 10, 20
# Scale-out (phase 16) at world size 1: a one-rank NCCL group in this process
# (parallel.init_distributed, a file:// store), destroyed at the end.  (a)
# The sharded flagship fleet (ShardedVectorPDEEnv on make_mesh(), K1) at
# NUM_ENVS x GRID^2 x SUBSTEPS, SO_STEPS random-policy steps across the
# episode end at SO_END, under sync debug mode "error", against the
# unsharded fleet from one seed and one action list: fields, rewards, obs
# and terminations bit for bit, one K1 launch a step and nothing else; the
# GPE fleet (K5, GPE_ENVS) the same way for SO_GPE_STEPS steps.  (b)
# SO_K2_STEPS steps without the epilogue (K2).  (c) halo_pad_rows, the halo
# Laplacians and the distributed FFT pairs on a SO_GRID2D^2 field and a
# SO_GRID3D^3 volume against torch.roll stencils and torch.fft, to
# TOL_SO_LAP and TOL_SO_FFT of the largest value (f32).  (d) The sharded
# SIF macros (2D at SO_GRID2D^2, 3D at SO_GRID3D^3, SO_SIF_SUBSTEPS
# substeps, kappa SO_KAPPA) against the same FD-symbol update with
# torch.fft on the card, to TOL_SO_SIF (f32, fields ~0.5).  (e) One
# ppo_train(mesh=...) update at run_ppo's shape (phase 8's) against
# ppo_train's unsharded update from one net and the same seeds: the same
# rollout (reward_mean equal) and the parameters within TOL_RL_BF16 of the
# unsharded step's norm (the global advantage normalisation sums in another
# order than adv.std(), and the bf16 net rounds the difference); then one
# sharded update under sync debug mode "error"; 64 K1 launches an update.
# (f) dryrun_multichip(1): its MULTICHIP_SCALING line (K2 forward, K3
# backward).
SO_STEPS, SO_END, SO_GPE_STEPS, SO_K2_STEPS = 30, 0.2, 10, 10
SO_GRID2D, SO_GRID3D, SO_SIF_SUBSTEPS, SO_KAPPA = 4096, 256, 10, 0.004
TOL_SO_LAP, TOL_SO_FFT, TOL_SO_SIF = 1e-6, 1e-5, 1e-5
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
        # The fleet-reset pass at the CH fleet's shape, no env ended (99 of
        # 100 steps): bytes only.
        FLEET_RESET: _bound_ops(0, "f32", 0, _fleet_reset_bytes(NUM_ENVS, px, 0)),
    }
    return out


def _fleet_reset_bytes(B, px, ended):
    """The fleet-reset pass's bytes with ``ended`` of ``B`` envs ended, each
    read or written once: a pixel's f32 field in (the stepped field, or the
    draw where the env ended) and out, its uint8 observation out and, for
    an env that goes on, in; an env's flag, the step's control, clock and
    count in, and the state's four out."""
    return B * px * 9 + (B - ended) * px + B * (1 + 12 + 12 + 1)


def _bv_inputs(torch, dev, gen, B, H=GRID, W=GRID):
    """Charging fields: the preset's reset field (0.05 + 0.005 N(0, 1)) with
    each env filled further by up to 0.4, and a C-rate per env in the
    control range [0.2, 3]."""
    u = torch.clamp(0.05 + 0.005 * torch.randn((B, H, W), generator=gen, device=dev),
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


def _control_transforms(torch, tensor_cores):
    """``transforms`` of the cas macros with bf16 matrices, the rounding
    sites kept, every product accumulated in f64 and rounded once to f32;
    with ``tensor_cores`` every product on the TF32 tensor cores instead,
    whose operands (bf16 values) TF32 holds exactly, so the products are
    exact and summed in the tensor cores' f32, the arithmetic of the
    kernels' wgmma.  Either is a second correct bf16 macro whose distance
    from the plain version is a control of a bf16 kernel's bound."""

    def mm(a, b):
        return a @ b if tensor_cores else torch.matmul(a.double(), b.double()).float()

    def transforms(c, round_bf16):
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32)

        def tr(z, mh, mw):
            t = rnd(mm(rnd(z).transpose(-1, -2), mh))
            return mm(t.transpose(-1, -2), mw)

        return (lambda z: tr(z, c.ch, c.cw), lambda z: tr(z, c.ich, c.icw))

    return transforms


def _with_control_transforms(torch, module, tensor_cores, fn, *args, **kw):
    """``fn(*args, **kw)`` with ``module``'s ``transforms`` replaced by
    :func:`_control_transforms` (TF32 on for the tensor-core control)."""
    from unittest import mock

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tensor_cores
    try:
        with mock.patch.object(module, "transforms", _control_transforms(torch, tensor_cores)):
            return fn(*args, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _bwd_f64_accumulated(torch, u, kap, g, consts, kw, tensor_cores=False):
    """The plain CH backward on :func:`_control_transforms`: the control of
    K3's bf16 check."""
    from pde_opt_tpu_torch.ops import cas_spectral

    return _with_control_transforms(torch, cas_spectral, tensor_cores,
                                    cas_spectral.ch_cas_macro_bwd_plain, u, kap, g, consts, **kw)


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


def _drive_fleet(torch, kernels, env, env0, gen, name, reward_rtol, may_diverge=False,
                 fleet_resets=False):
    """One fleet's serving path: with the launch counts reset just before, a
    STEPS-step random-policy rollout of ``env`` (fused epilogue) that crosses
    the episode end and its auto-reset, then FLEET_STEPS_NO_EP steps of
    ``env0`` (no epilogue), all under sync debug mode "error"; the counts
    are read just after.  Checks the launches, the rewards, the resets, the
    epilogue reward against the env's own reward function, and a poisoned
    env.  With ``may_diverge`` an env may also end its episode early by
    diverging (the SBM fleet under a random policy overfills its particle,
    in the JAX package too): the number is reported.  With ``fleet_resets``
    the fused fleet auto-resets in the fleet-reset pass, one launch a step,
    else none runs.  Returns (final state, launch counts, env-steps/s)."""

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
    N = state.y.shape[1]
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

    print(f"{name} path: {STEPS}-step rollout of {B} envs x {N}^2 x {SUBSTEPS} substeps "
          f"(+{FLEET_STEPS_NO_EP} without the epilogue); episode end at step {end_step}; "
          f"launches {counts}", flush=True)
    _check(counts[FLEET_RESET] == (STEPS if fleet_resets else 0),
           f"{name}: {counts[FLEET_RESET]} fleet-reset launches in {STEPS} fused steps")
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
    _check(obs.shape == (B, 1, N, N) and obs.dtype == torch.uint8, "obs")
    print(f"{name}: poisoned env 7 flagged diverged, reward 0, reset", flush=True)
    return state, counts, B * STEPS / t_roll


def _check_fleet_reset(torch, kernels, fleets, card):
    """The fleet-reset pass against its plain-torch twin on the card, at
    each ``(name, env)`` fleet's shape.  From one set of card tensors (a
    stepped field with an env gone NaN and a carried NaN pixel, random
    observations, controls, clocks and counts) and one draw: the env's
    ``_auto_reset`` (the draw and the pass) against ``_torch_auto_reset``
    and the step's ``copy_`` into the state, with no env, every third env
    and every env ended; the state, the next observation and the step's
    observation, which must stay as it was, bit for bit from sentinel
    states.  Then the pass alone against that twin fed the same draw, no
    env and every env ended, timed in turns beside the pass's byte floor.
    Returns (largest |field difference|, {(name, ended): (pass ms, plain
    ms)})."""
    from types import SimpleNamespace

    from pde_opt_tpu_torch.envs.vector_env import EnvState, _normal_draw, _torch_auto_reset
    from pde_opt_tpu_torch.ops.fleet_reset import fleet_reset

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def sentinel(state):
        return EnvState(torch.full_like(state.y, -7.0), torch.full_like(state.t, -1.0),
                        torch.full_like(state.control_value, -1.0),
                        torch.full_like(state.step_count, -5),
                        torch.ones_like(state.done))

    err, times = 0.0, {}
    for name, env in fleets:
        dev = env.device
        gen = torch.Generator(device=dev).manual_seed(26)
        state, obs0 = env.reset(gen)
        B, px = state.y.shape[0], state.y[0].numel()
        y1 = state.y + 0.2 * torch.randn(state.y.shape, generator=gen, device=dev)
        y1[0] = float("nan")                       # ends where any env ends
        y1[1, 2, 3] = float("nan")                 # carried: env 1 never ends here
        obs = torch.randint(0, 256, obs0.shape, generator=gen, device=dev, dtype=torch.uint8)
        obs_in = obs.clone()
        cv1, t1 = torch.rand((B,), generator=gen, device=dev), torch.rand((B,), generator=gen,
                                                                           device=dev)
        steps1 = torch.randint(1, 100, (B,), generator=gen, device=dev, dtype=torch.int32)
        envs = torch.arange(B, device=dev)
        cases = {"none": envs < 0, "some": envs % 3 == 0, "all": envs >= 0}
        kernels.reset_launch_counts()
        for i, (label, ended) in enumerate(cases.items()):
            got, want = sentinel(state), sentinel(state)
            env.set_generator(torch.Generator(device=dev).manual_seed(100 + i))
            nxt, got_obs = env._auto_reset(got, ended, y1, cv1, t1, steps1, obs)
            env.set_generator(torch.Generator(device=dev).manual_seed(100 + i))
            twin, want_obs = _torch_auto_reset(env, want, ended, y1, cv1, t1, steps1, obs)
            for dst, src in zip(want, twin):
                dst.copy_(src)
            same = {f: torch.equal(bits(a), bits(b))
                    for f, a, b in zip(EnvState._fields, got, want)}
            same.update(obs_next=torch.equal(got_obs, want_obs), obs=torch.equal(obs, obs_in))
            _check(nxt is None and all(same.values()),
                   f"fleet-reset pass vs torch, {name}, {label} ended: {same}")
            err = max(err, torch.nan_to_num((got.y - want.y).abs(), nan=0.0).max().item())
        counts = kernels.launch_counts()
        _check(counts[FLEET_RESET] == len(cases), f"{name}: the pass did not run: {counts}")
        print(f"check fleet-reset pass vs torch auto-reset + copy_, {name} ({B} envs x {px} px): "
              f"no env, every third, every env ended, a NaN env and a carried NaN pixel: state, "
              f"next obs and obs bit for bit", flush=True)

        z = _normal_draw(env.domain, gen, B, torch.float32)
        mean, noise, lo, hi = env.reset_func.affine
        fixed = SimpleNamespace(reset_func=lambda d, g, n: torch.clamp(mean + noise * z, lo, hi),
                                domain=env.domain, _generator=None, _reset_cv=env._reset_cv,
                                state_to_observation_func=env.state_to_observation_func)
        got, want = sentinel(state), sentinel(state)

        def plain(ended):
            nxt, _ = _torch_auto_reset(fixed, want, ended, y1, cv1, t1, steps1, obs)
            for dst, src in zip(want, nxt):
                dst.copy_(src)

        def kernel(ended):
            fleet_reset(got, ended, y1, z, obs, cv1, t1, steps1, env.reset_func.affine,
                        env._reset_cv_value, env.fused_epilogue["obs_scale"])

        draw = _time_ms(torch, lambda: _normal_draw(env.domain, gen, B, torch.float32))
        for label in ("none", "all"):
            ended, key = cases[label], f"{FLEET_RESET} {name}, {label} ended"
            _time_pair(torch, times, key, lambda: plain(ended), lambda: kernel(ended),
                       f"{B} envs x {px} px", card)
            floor = _fleet_reset_bytes(B, px, B if label == "all" else 0) / PEAK_BYTES * 1e3
            ms, plain_ms = times[(name, label)] = times.pop(key)
            print(f"fleet-reset pass {name}, {label} ended: {ms:.4f} ms against its byte floor "
                  f"{floor:.4f} ms ({floor / ms:.1%}); plain twin {plain_ms:.4f} ms; the draw "
                  f"beside it {draw:.4f} ms [{card}]", flush=True)
    return err, times


def _fleet_rate(torch, env, gen, n):
    """env-steps/s of an ``n``-step random-policy rollout of ``env`` after a
    2-step warm-up, host clock to a trailing synchronize."""
    st, _ = env.reset(gen)
    env.make_rollout(lambda o, g: env.sample_actions(g), 2)(st, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env.make_rollout(lambda o, g: env.sample_actions(g), n)(st, gen)
    torch.cuda.synchronize()
    return env.num_envs * n / (time.perf_counter() - t0)


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
            _check(_total(counts) == 0, f"derivs=fd fft: launches {counts}")
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


def _drive_dft_fleet(torch, kernels, make_env, name, kernel, card, num_envs=None, grid=GRID):
    """A preset fleet on the packed-DFT macro: ``spectral_solve="fused"``,
    no fused epilogue, and ``"algo": "dft"`` in the env's solver_parameters
    (read at every step); ``num_envs`` (default: the CH or AC fleet's) envs
    of ``grid``^2.  With the launch counts reset just before, a STEPS-step
    random-policy rollout across the episode end and its auto-reset under
    sync debug mode "error"; the counts are read just after: one launch of
    ``kernel`` a step and nothing else.  Returns (launch counts,
    env-steps/s)."""
    if num_envs is None:
        num_envs = NUM_ENVS if name == "CH" else AC_ENVS
    env = make_env(num_envs=num_envs, grid_size=grid, substeps=SUBSTEPS, spectral_solve="fused",
                   fused_epilogue=False, device=torch.device("cuda"))
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
    print(f"{name} fleet algo=dft: {STEPS}-step rollout of {env.num_envs} envs x {grid}^2 x "
          f"{SUBSTEPS} substeps, {rate:.1f} env-steps/s; episode end at step {end_step}; "
          f"launches {counts} [{card}]", flush=True)
    _check(counts[kernel] == STEPS and _total(counts) == STEPS,
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
    _check(counts["ch_sif_macro"] == want and _total(counts) == want,
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


def _total(counts):
    """Every macro launch once: a sub-count (``ONCHIP``, ``bv_cc_macro.tiled``)
    counts again launches that its kernel's own keys count, and the fleet's
    auto-reset pass (``vector_env.fleet_reset``) is no macro."""
    return sum(v for k, v in counts.items() if "." not in k)


def _only_k1(counts, n, what):
    """K1 launched ``n`` times and no other macro."""
    others = {k: v for k, v in counts.items() if "." not in k and k != "ch_cas_macro_ep" and v}
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
    as _bounds() counts them at 64^2: K1 (the 128^2 fleet, and the 128^2
    cell's 4096 envs), K2 (the 256^2 macro, and the NN-control value+grad's
    forward at 4096 x 128^2) and K3
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
        "ch_cas_macro_ep 128^2 cell": ch(NN_ENVS, g, 1 + 2 * n, 21, 2, 4 + g * g + 12),
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
                _check_nan_env(torch, line, got[0], want[0], bad, keep)
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
    _check(fleet_counts["ch_cas_macro_ep"] == FLEET128_STEPS == fleet_counts[ONCHIP]
           == fleet_counts[ONCHIP_FOLD] == fleet_counts[FLEET_RESET]
           and _total(fleet_counts) == FLEET128_STEPS,
           f"128^2 fleet launches {fleet_counts}")
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
    _check(m256_counts["ch_cas_macro"] == BIG256_CALLS and m256_counts[ONCHIP] == 0
           and m256_counts[ONCHIP_FOLD] == 0
           and _total(m256_counts) == BIG256_CALLS, f"256^2 macro launches {m256_counts}")
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
    _check(nn_counts["ch_cas_macro"] == NN_CALLS == nn_counts[ONCHIP] == nn_counts[ONCHIP_FOLD]
           and nn_counts["ch_cas_macro_bwd"] == NN_CALLS
           and _total(nn_counts) == 2 * NN_CALLS, f"NN value+grad launches {nn_counts}")
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
            # (one-off A/B in CHANGES.md), so both controls bound it here.
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

    # -- K1 at the 128^2 cell's fleet (4096 envs): the folded table against
    # the per-substep rebuild of the multipliers (constants whose fold check
    # is forced false), bit for bit, each timed (table, rebuild, table).
    _check(cnn.fold, "128^2 constants: the planes do not fold")
    k_nn = 2e-3 + 8e-3 * torch.rand((NN_ENVS,), generator=gen, device=dev)
    k1 = {c.fold: (lambda c=c: ch_cas_macro_cuda(u_nn, k_nn, c, epilogue=ep, **kwnn))
          for c in (cnn, cnn._replace(fold=False))}
    t1, r1, t2 = (_time_ms(torch, k1[f], reps=5, warmup=1) for f in (True, False, True))
    k1_ms = (t1 + t2) / 2
    got, want = k1[True](), k1[False]()
    torch.cuda.synchronize()
    what = f"{NN_ENVS}x{G}^2x{SUBSTEPS}"
    _check(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"K1 at {what}: the folded table differs from the rebuild")
    b_ms = bounds["ch_cas_macro_ep 128^2 cell"][0]
    print(f"time ch_cas_macro_ep at {what} bf16: folded table {t1:.4f} / {t2:.4f} ms, rebuild "
          f"{r1:.4f} ms ({r1 / k1_ms:.3f}x), bound {b_ms:.4f} ms ({b_ms / k1_ms:.1%} of the "
          f"table's time); field, stats and obs equal bit for bit [{card}]", flush=True)
    return (fleet_counts, m256_counts, nn_counts), fleet_rate, k1_ms


def _tiled_bounds():
    """The bounds of the tiled K4, K5 and K3 at phase 10's path shapes,
    counted as _bounds() counts them at 64^2: K4 with the epilogue, R == 1
    (3 transforms a substep) at 1024 x 128^2; K5 with the epilogue (n + 1
    propagations of 4 transforms) at 256 x 128^2, and at WALK_ENVS envs; K3
    (7n - 1 transforms, as phase 9's) at 256 x 256^2."""
    n = SUBSTEPS

    def mats(N):
        return 4 * 2 * N * N * 4

    a, g, b = AC128_GRID, GPE128_GRID, BIG256_GRID
    ac_px, g_px, b_px = a * a, g * g, b * b

    def gpe(B):
        return _bound(4 * (n + 1), g, g, B, "bf16", 40 * g_px * n * B,
                      B * (g_px * 4 * 5 + g_px + 12) + mats(g) + 6 * g_px * 4)

    return {
        "ac_cas_macro_ep 128^2": _bound(
            3 * n, a, a, AC128_ENVS, "bf16", 21 * ac_px * n * AC128_ENVS,
            AC128_ENVS * (ac_px * 4 * 2 + 4 + ac_px + 12) + mats(a) + ac_px * 4),
        "gpe_strang_macro_ep 128^2": gpe(GPE128_ENVS),
        "gpe_strang_macro_ep 128^2 walk": gpe(WALK_ENVS),
        "ch_cas_macro_bwd 256^2": _bound(
            7 * n - 1, b, b, BIG256_ENVS, "bf16", 50 * b_px * n * BIG256_ENVS,
            BIG256_ENVS * (b_px * 4 * 3 + 8) + mats(b) + 2 * b_px * 4),
    }


def _gpe_fields(torch, dev, gen, B, H, W):
    """The GPE fleet's fields on an H x W grid of square cells in its 16-wide
    box: a Gaussian condensate with complex noise at unit norm per env, the
    harmonic trap, the control spot, an intensity per env in [0, 50].
    Returns (y, ctrl, V, spot, dx)."""
    dx = GPE_BOX / H
    x = (torch.arange(H, device=dev) + 0.5) * dx - H * dx / 2
    xw = (torch.arange(W, device=dev) + 0.5) * dx - W * dx / 2
    X, Y = torch.meshgrid(x, xw, indexing="ij")
    noise = 0.1 * torch.randn((B, H, W, 2), generator=gen, device=dev)
    psi = torch.exp(-(X**2 + Y**2) / 4)[None, ..., None] * (
        torch.tensor([1.0, 0.0], device=dev) + noise)
    psi = psi / ((psi**2).sum((-3, -2, -1), keepdim=True) * dx * dx).sqrt()
    spot = torch.exp(-((X - 1.0) ** 2 + Y**2)).contiguous()
    ctrl = (50.0 * torch.rand((B, 1, 1), generator=gen, device=dev) * spot).contiguous()
    return psi.contiguous(), ctrl, (0.5 * (X**2 + Y**2)).contiguous(), spot, dx


def _check_nan_env(torch, line, got, want, bad, keep):
    """The NaN env's field is NaN where plain's is, and no other env's is
    (``bad`` None: no env is NaN)."""
    _check(torch.equal(torch.isnan(got), torch.isnan(want))
           and (bad is None or bool(torch.isnan(got[bad]).any()))
           and not bool(torch.isnan(got[keep]).any()), f"{line}: the NaN env left its env")


def _check_ac_big(torch, line, got, want, mats, bad, keep, n_px):
    """K4 against plain with the NaN env ``bad`` (None: none): the field
    off plain by at most TOL_AC on the other envs ``keep``; with the
    epilogue, n_finite equal (the NaN env's below n_px), stats within 1e-3
    (phase 3c's measures) and obs within 1 LSB.  Returns (the line, the
    field error)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if bad is None:
        keep = torch.ones(len(got[0]), dtype=torch.bool, device=got[0].device)
    err = (got[0][keep] - want[0][keep]).abs().max().item()
    line += f": u1 max_abs_err {err:.3e}"
    _check(err <= TOL_AC[mats], f"{line} > {TOL_AC[mats]}")
    _check_nan_env(torch, line, got[0], want[0], bad, keep)
    if len(got) == 3:
        e2, e1 = _stats_err(got[1][keep], want[1][keep], n_px)
        lsb = (got[2].int() - want[2].int()).abs().max().item()
        line += (f", stats s2 max_rel_err {e2:.3e}, s1 err/sqrt(n s2) {e1:.3e}, "
                 f"obs max_lsb {lsb}")
        _check(torch.equal(got[1][:, 2], want[1][:, 2])
               and (bad is None or float(got[1][bad, 2]) < n_px), f"{line}: n_finite")
        _check(e2 <= 1e-3 and e1 <= 1e-3 and lsb <= 1, f"{line}: epilogue bounds")
    return line, err


def _check_gpe_big(torch, line, got, want, mats, spot, dx, bad, keep):
    """K5 against plain with the NaN env ``bad`` (None: none): the state off
    plain by at most TOL_GPE on the other envs ``keep``, each of them at
    unit norm to 1e-5; with the epilogue, its stats and obs against the
    kernel's own final state (the NaN env's n_finite below the pixel
    count).  Returns (the line, the state error)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if bad is None:
        keep = torch.ones(len(got[0]), dtype=torch.bool, device=got[0].device)
    err = (got[0][keep] - want[0][keep]).abs().max().item()
    rho = got[0][keep][..., 0] ** 2 + got[0][keep][..., 1] ** 2
    norm_err = (rho.sum((-2, -1)) * dx * dx - 1.0).abs().max().item()
    line += f": y1 max_abs_err {err:.3e}, max |norm - 1| {norm_err:.3e}"
    _check(err <= TOL_GPE[mats], f"{line} > {TOL_GPE[mats]}")
    _check(norm_err <= 1e-5, f"{line}: norm off by more than 1e-5")
    _check_nan_env(torch, line, got[0], want[0], bad, keep)
    if len(got) == 3:
        n_px = spot.numel()
        own = torch.stack([(rho * spot).sum((-2, -1)), rho.sum((-2, -1))], -1)
        line = _check_own_epilogue(line, tuple(t[keep] for t in got), own,
                                   torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8), n_px)
        _check(bad is None or float(got[1][bad, 2]) < n_px, f"{line}: the NaN env's n_finite")
    return line, err


def _check_tiled(torch, dev, gen):
    """Phase 10a: the tiled K4 and K5 at BIG_GRIDS and K3 at 256^2 against
    their plain versions on the card, f32 and bf16 matrices, each launch
    with one NaN env that must stay in its env; one bf16 substep of K4 and
    K5 at the rounding sites at 128^2.  Returns the largest bf16 error of
    each."""
    from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R, CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        PolynomialMu,
        ac_cas_macro_cuda,
        ac_cas_macro_plain,
        cas_constants,
        ch_cas_macro_bwd_cuda,
        ch_cas_macro_bwd_plain,
        ch_cas_macro_plain,
        r_is_identity,
    )
    from pde_opt_tpu_torch.ops.gpe_cas import (
        GpeEpilogue,
        gpe_constants,
        gpe_strang_macro_cuda,
        gpe_strang_macro_plain,
    )

    B, bad = BIG_CHECK_ENVS, BIG_NAN_ENV
    keep = torch.arange(B, device=dev) != bad
    kap = 1e-4 + 9e-4 * torch.rand((B,), generator=gen, device=dev)
    errs = {}
    for H, W in BIG_GRIDS:
        u = 0.1 * torch.randn((B, H, W), generator=gen, device=dev)
        u[bad, 3, 7] = float("nan")
        y, ctrl, V, spot, dx = _gpe_fields(torch, dev, gen, B, H, W)
        y[bad, 3, 7, 0] = float("nan")
        for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            consts = cas_constants(H, W, HX, HY, mdt, dev)
            for rname, R in (("1", AC_R), ("1+0.5u^2", PolynomialMu(AC_R_GENERAL))):
                kw = dict(mu_fn=AC_MU, R_fn=R, r_identity=r_is_identity(R), dt=DT, A=A,
                          n_steps=SUBSTEPS, round_bf16=mats == "bf16")
                for ep in (None, Epilogue(127.5, 127.5, 0.0, 1)):
                    got = ac_cas_macro_cuda(u, kap, consts, epilogue=ep, **kw)
                    want = ac_cas_macro_plain(u, kap, consts, epilogue=ep, **kw)
                    torch.cuda.synchronize()
                    name = "ac_cas_macro_ep" if ep else "ac_cas_macro"
                    line, err = _check_ac_big(
                        torch, f"check {name} mats={mats} R={rname} {H}x{W} ({B} envs, env "
                        f"{bad} NaN)", got, want, mats, bad, keep, H * W)
                    print(line, flush=True)
                    if mats == "bf16":
                        errs[name] = max(errs.get(name, 0.0), err)
                if mats == "bf16" and (H, W) == (128, 128):
                    one = {**kw, "n_steps": 1}
                    _check_sites(f"ac_cas_macro mats=bf16 R={rname} {H}x{W}",
                                 ac_cas_macro_cuda(u[keep], kap[keep], consts, **one),
                                 ac_cas_macro_plain(u[keep], kap[keep], consts, **one),
                                 ac_cas_macro_plain(u[keep], kap[keep], consts,
                                                    **{**one, "round_bf16": False}),
                                 TOL_SITE["ac_r1" if R is AC_R else "ac_general"])
            gconsts = gpe_constants(H, W, dx, GPE128_DT, mdt, dev)
            for poly in (True, False):
                kw = dict(g=GPE_G, dt=GPE128_DT, dx=dx, n_steps=SUBSTEPS,
                          round_bf16=mats == "bf16", phase_poly=poly)
                for ep in (None, GpeEpilogue(2550.0, spot)):
                    got = gpe_strang_macro_cuda(y, ctrl, V, gconsts, epilogue=ep, **kw)
                    want = gpe_strang_macro_plain(y, ctrl, V, gconsts, epilogue=ep, **kw)
                    torch.cuda.synchronize()
                    name = "gpe_strang_macro_ep" if ep else "gpe_strang_macro"
                    line, err = _check_gpe_big(
                        torch, f"check {name} mats={mats} phase_poly={poly} {H}x{W} ({B} envs, "
                        f"env {bad} NaN)", got, want, mats, spot, dx, bad, keep)
                    print(line, flush=True)
                    if mats == "bf16":
                        errs[name] = max(errs.get(name, 0.0), err)
                if mats == "bf16" and (H, W) == (128, 128):
                    one = {**kw, "n_steps": 1}
                    yk, ck = y[keep], ctrl[keep]
                    _check_sites(f"gpe_strang_macro mats=bf16 phase_poly={poly} {H}x{W}",
                                 gpe_strang_macro_cuda(yk, ck, V, gconsts, **one),
                                 gpe_strang_macro_plain(yk, ck, V, gconsts, **one),
                                 gpe_strang_macro_plain(yk, ck, V, gconsts,
                                                        **{**one, "round_bf16": False}),
                                 TOL_SITE["gpe"])
            if (H, W) == (128, 128):
                # A state at 1.5 times unit norm: each B phase after the first
                # takes theta from the field its renormalisation scaled.
                y15 = 1.5 * y[keep]
                line, _ = _check_gpe_big(
                    torch, f"check gpe_strang_macro mats={mats} {H}x{W}, state at 1.5 x unit norm",
                    gpe_strang_macro_cuda(y15, ctrl[keep], V, gconsts, **kw),
                    gpe_strang_macro_plain(y15, ctrl[keep], V, gconsts, **kw), mats, spot, dx,
                    None, None)
                print(line, flush=True)
    # K3 at 256^2: run_ch256's fields and dt, the loss's cotangent.
    H = W = BIG256_GRID
    ub = 0.5 + 0.01 * torch.randn((B, H, W), generator=gen, device=dev)
    kb = torch.full((B,), 0.004, device=dev)
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = cas_constants(H, W, 0.01, 0.01, mdt, dev)
        kw = dict(mu_fn=CH_MU, dt=BIG256_DT, A=A, n_steps=SUBSTEPS, round_bf16=mats == "bf16")
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
            _check_bwd_bf16(torch, line, got, want,
                            _bwd_f64_accumulated(torch, ub, kb, g, consts, kw),
                            _bwd_f64_accumulated(torch, ub, kb, g, consts, kw, True))
            errs["ch_cas_macro_bwd"] = (got[0] - want[0]).abs().max().item()
        un = ub.clone()
        un[bad, 3, 7] = float("nan")
        du, dk = ch_cas_macro_bwd_cuda(un, kb, g, consts, **kw)
        torch.cuda.synchronize()
        _check(bool(torch.isnan(du[bad]).any()) and bool(torch.isnan(dk[bad]))
               and bool(torch.isfinite(du[keep]).all()) and bool(torch.isfinite(dk[keep]).all()),
               f"K3 mats={mats} {H}x{W}: the NaN env left its env")
        print(f"check ch_cas_macro_bwd mats={mats} {H}x{W}: NaN env {bad} stays in its env",
              flush=True)
    # K3 at 256^2 with 50 substeps a call: a slot holds 55 planes (14 MB),
    # one for each resident block; the scratch allocates and the call runs.
    from pde_opt_tpu_torch.ops import cas_spectral
    from pde_opt_tpu_torch.ops.kernels import alloc_scratch, library

    kw = dict(mu_fn=CH_MU, dt=BIG256_DT, A=A, n_steps=50, round_bf16=True)
    scratch, slots = alloc_scratch(library("ch_cas_macro", cas_spectral._bind_library),
                                   "ch_cas_macro_scratch", dev, B, 1, 1, H, W, 50)
    nbytes = scratch.numel() * 4
    del scratch
    du, dk = ch_cas_macro_bwd_cuda(ub, kb, torch.ones_like(ub), consts, **kw)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(du).all() and torch.isfinite(dk).all()),
           "K3 at 256^2 x 50 substeps: non-finite")
    print(f"check ch_cas_macro_bwd mats=bf16 {H}x{W} x 50 substeps ({B} envs): scratch "
          f"{slots} slots, {nbytes / 2**30:.2f} GiB; finite du and dkappa", flush=True)
    return errs


def _drive_tiled(torch, kernels, dev, gen, card):
    """Phase 10b: the GPE 128^2 fleet (run_gpe128: K5), the AC 128^2 fleet
    (K4) and the 256^2 value+grad (K2 + K3) through their entry points, each
    with its launch counts reset just before and read just after, under sync
    debug mode "error"; the GPE fleet's fft mode timed beside its fused one;
    then the tiled kernels held against plain and timed at these shapes.
    Returns (each path's counts, the AC 128^2 fleet's env-steps/s)."""
    from pde_opt_tpu_torch.envs.presets import (
        AC_MU,
        AC_R,
        CH_MU,
        make_allen_cahn_control_env,
        make_gpe_control_env,
    )
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        ac_cas_macro_cuda,
        ac_cas_macro_plain,
        cas_constants,
        ch_cas_macro_bwd_cuda,
        ch_cas_macro_bwd_plain,
        ch_cas_macro_plain,
        make_ch_cas_fused_macro,
    )
    from pde_opt_tpu_torch.ops.gpe_cas import (
        GpeEpilogue,
        gpe_constants,
        gpe_strang_macro_cuda,
        gpe_strang_macro_plain,
    )

    # -- the GPE 128^2 fleet (run_gpe128, BASELINE config 5), fused and fft --
    G = GPE128_GRID
    gpe = make_gpe_control_env(num_envs=GPE128_ENVS, grid_size=G, substeps=SUBSTEPS,
                               spectral_solve="fused", device=dev)
    gpe0 = make_gpe_control_env(num_envs=GPE128_ENVS, grid_size=G, substeps=SUBSTEPS,
                                fused_epilogue=False, device=dev)
    g_state, g_counts, g_rate = _drive_fleet(torch, kernels, gpe, gpe0, gen, "GPE 128^2", 1e-4)
    _check(g_counts["gpe_strang_macro_ep"] == STEPS
           and g_counts["gpe_strang_macro"] == FLEET_STEPS_NO_EP
           and _total(g_counts) == STEPS + FLEET_STEPS_NO_EP,
           f"GPE 128^2 launches {g_counts}")
    dx = float(gpe.domain.dx[0])
    norm_err = ((g_state.y ** 2).sum((-3, -2, -1)) * dx * dx - 1.0).abs().max().item()
    print(f"GPE 128^2: per-env norm after the rollout: max |norm - 1| {norm_err:.3e}", flush=True)
    _check(norm_err <= 1e-5, "GPE 128^2: per-env norm must stay 1 to 1e-5")
    gpe_fft = make_gpe_control_env(num_envs=GPE128_ENVS, grid_size=G, substeps=SUBSTEPS,
                                   spectral_solve="fft", device=dev)
    r_f1, r_x1, r_x2, r_f2 = (_fleet_rate(torch, e, gen, GPE128_FFT_STEPS)
                              for e in (gpe, gpe_fft, gpe_fft, gpe))
    print(f"GPE 128^2 fleet (run_gpe128): fused {g_rate:.1f} env-steps/s over the {STEPS}-step "
          f"rollout; fused vs fft in turns over {GPE128_FFT_STEPS} steps: {r_f1:.1f} / "
          f"{r_f2:.1f} vs {r_x1:.1f} / {r_x2:.1f} env-steps/s, "
          f"{(r_f1 + r_f2) / (r_x1 + r_x2):.2f}x ({GPE128_ENVS} envs x {G}^2 x {SUBSTEPS} "
          f"substeps) [{card}]", flush=True)

    # -- the AC 128^2 fleet (run_ch128's shape on the AC preset, R == 1) --
    N = AC128_GRID
    ac = make_allen_cahn_control_env(num_envs=AC128_ENVS, grid_size=N, substeps=SUBSTEPS,
                                     device=dev)
    ac0 = make_allen_cahn_control_env(num_envs=AC128_ENVS, grid_size=N, substeps=SUBSTEPS,
                                      fused_epilogue=False, device=dev)
    _, a_counts, a_rate = _drive_fleet(torch, kernels, ac, ac0, gen, "AC 128^2", 1e-3)
    _check(a_counts["ac_cas_macro_ep"] == STEPS and a_counts["ac_cas_macro"] == FLEET_STEPS_NO_EP
           and _total(a_counts) == STEPS + FLEET_STEPS_NO_EP,
           f"AC 128^2 launches {a_counts}")
    print(f"AC 128^2 fleet: {a_rate:.1f} env-steps/s ({AC128_ENVS} envs x {N}^2 x {SUBSTEPS} "
          f"substeps, {STEPS} steps) [{card}]", flush=True)

    # -- the 256^2 value+grad of sum(macro(u, kappa)^2) (run_ch256's shape) --
    M = BIG256_GRID
    macro = make_ch_cas_fused_macro(CH_MU, M, M, 0.01, 0.01, 1.0, BIG256_DT, SUBSTEPS)
    u0 = 0.5 + 0.01 * torch.randn((BIG256_ENVS, M, M), generator=gen, device=dev)
    k0 = torch.full((BIG256_ENVS,), 4e-3, device=dev)

    def value_and_grad():
        u, k = u0.detach().requires_grad_(), k0.detach().requires_grad_()
        v = (macro(u, k) ** 2).sum()
        v.backward()
        return v.detach(), u.grad, k.grad

    value_and_grad()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    vg = [value_and_grad() for _ in range(VG256_CALLS)]
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_vg = time.perf_counter() - t0
    v_counts = kernels.launch_counts()
    _check(v_counts["ch_cas_macro"] == VG256_CALLS and v_counts["ch_cas_macro_bwd"] == VG256_CALLS
           and _total(v_counts) == 2 * VG256_CALLS, f"256^2 value+grad launches {v_counts}")
    _check(all(bool(torch.isfinite(t).all()) for r in vg for t in r),
           "256^2 value+grad: non-finite value or gradient")
    print(f"256^2 value+grad: {VG256_CALLS} calls of sum(macro(u, kappa)^2) at {BIG256_ENVS} envs "
          f"x {M}^2 x {SUBSTEPS} substeps (dt {BIG256_DT}, bf16), no host sync, launches "
          f"{v_counts}: {BIG256_ENVS * SUBSTEPS * VG256_CALLS / t_vg:.1f} grad-env-substeps/s, "
          f"{t_vg / VG256_CALLS * 1e3:.4f} ms a call [{card}]", flush=True)

    # -- the kernels at these shapes: against plain where a block walks
    # several envs through its slot, and timed against plain and the bound --
    bounds = _tiled_bounds()
    ep = Epilogue(127.5, 127.5, 0.0, 1)
    c_ac = cas_constants(N, N, HX, HY, torch.bfloat16, dev)
    kw_ac = dict(mu_fn=AC_MU, R_fn=AC_R, r_identity=True, dt=DT, A=A, n_steps=SUBSTEPS,
                 round_bf16=True, epilogue=ep)
    u_ac = 0.1 * torch.randn((AC128_ENVS, N, N), generator=gen, device=dev)
    k_ac = 1e-4 + 9e-4 * torch.rand((AC128_ENVS,), generator=gen, device=dev)
    y, ctrl, V, spot, dxg = _gpe_fields(torch, dev, gen, WALK_ENVS, G, G)
    c_g = gpe_constants(G, G, dxg, GPE128_DT, torch.bfloat16, dev)
    kw_g = dict(g=GPE_G, dt=GPE128_DT, dx=dxg, n_steps=SUBSTEPS, round_bf16=True,
                phase_poly=True, epilogue=GpeEpilogue(2550.0, spot))
    yb, cb = y[:GPE128_ENVS], ctrl[:GPE128_ENVS]
    c_vg = cas_constants(M, M, 0.01, 0.01, torch.bfloat16, dev)
    kw_vg = dict(mu_fn=CH_MU, dt=BIG256_DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
    g_vg = 2.0 * ch_cas_macro_plain(u0, k0, c_vg, **kw_vg)
    got = ac_cas_macro_cuda(u_ac, k_ac, c_ac, **kw_ac)
    want = ac_cas_macro_plain(u_ac, k_ac, c_ac, **kw_ac)
    torch.cuda.synchronize()
    line, _ = _check_ac_big(torch, f"check ac_cas_macro_ep mats=bf16 R=1 at {AC128_ENVS}x{N}^2x"
                            f"{SUBSTEPS} (a block walks several envs)", got, want, "bf16",
                            None, None, N * N)
    print(line, flush=True)
    for B_, yy, cc in ((GPE128_ENVS, yb, cb), (WALK_ENVS, y, ctrl)):
        got = gpe_strang_macro_cuda(yy, cc, V, c_g, **kw_g)
        want = gpe_strang_macro_plain(yy, cc, V, c_g, **kw_g)
        torch.cuda.synchronize()
        walk = " (a block walks several envs)" if B_ == WALK_ENVS else ""
        line, _ = _check_gpe_big(torch, f"check gpe_strang_macro_ep mats=bf16 phase_poly=True at "
                                 f"{B_}x{G}^2x{SUBSTEPS}{walk}", got, want, "bf16", spot, dxg,
                                 None, None)
        print(line, flush=True)
    cases = (
        ("ac_cas_macro_ep 128^2", f"{AC128_ENVS}x{N}^2x{SUBSTEPS}, R == 1",
         lambda: ac_cas_macro_cuda(u_ac, k_ac, c_ac, **kw_ac),
         lambda: ac_cas_macro_plain(u_ac, k_ac, c_ac, **kw_ac)),
        ("gpe_strang_macro_ep 128^2", f"{GPE128_ENVS}x{G}^2x{SUBSTEPS}, phase polynomials",
         lambda: gpe_strang_macro_cuda(yb, cb, V, c_g, **kw_g),
         lambda: gpe_strang_macro_plain(yb, cb, V, c_g, **kw_g)),
        # The same at WALK_ENVS envs, several waves of blocks: its time an
        # env-transform beside the path's single wave.
        ("gpe_strang_macro_ep 128^2 walk", f"{WALK_ENVS}x{G}^2x{SUBSTEPS}, phase polynomials",
         lambda: gpe_strang_macro_cuda(y, ctrl, V, c_g, **kw_g),
         lambda: gpe_strang_macro_plain(y, ctrl, V, c_g, **kw_g)),
        ("ch_cas_macro_bwd 256^2", f"{BIG256_ENVS}x{M}^2x{SUBSTEPS}",
         lambda: ch_cas_macro_bwd_cuda(u0, k0, g_vg, c_vg, **kw_vg),
         lambda: ch_cas_macro_bwd_plain(u0, k0, g_vg, c_vg, **kw_vg)),
    )
    for name, what, kernel, plain in cases:
        k1, p1, k2 = (_time_ms(torch, f, reps=3, warmup=1) for f in (kernel, plain, kernel))
        ms = (k1 + k2) / 2
        b_ms, b_by = bounds[name]
        print(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of the kernel's time) at {what} bf16 "
              f"[{card}]", flush=True)
    return (g_counts, a_counts, v_counts), a_rate


def _on_card(dev, what, *tensors):
    """Every tensor of phase 11 lies on the run's device (the card)."""
    bad = [tuple(t.shape) for t in tensors if t.device.type != dev.type]
    _check(not bad, f"{what}: tensors of shapes {bad} are not on {dev.type}")


def _rel(got, want):
    """||got - want|| / ||want||, in f64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


def _logged(fn):
    """``fn()``'s result, its host seconds (``fn`` ends in a
    synchronisation) and the lines it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, time.perf_counter() - t0, buf.getvalue().splitlines()


def _drive_inverse(torch, kernels, dev, card):
    """Phase 11: the inverse-problem layer on the card, through
    ``PDEModel.train``/``solve``, with the launch counts reset just before
    and read just after (no K1-K9 launch): (a) the reference's 32^3
    Legendre mu and D fit by Levenberg-Marquardt, its Jacobian at theta0
    against the CPU's in f64; (b) the NN-mu fit at 128^2 (a PeriodicCNN mu,
    L-BFGS), its first loss and gradient against the CPU's in f64; (c)
    Mixer2d's forward and input gradient at 128^2 against the CPU's in f64;
    (d) an adaptive Allen-Cahn solve (Tsit5, PIDController) against the
    CPU's in f64."""
    import copy

    import numpy as np

    from pde_opt_tpu_torch.bench.inverse import legendre_fit_3d, nn_mu_fit_2d
    from pde_opt_tpu_torch.grid import Domain
    from pde_opt_tpu_torch.models.allen_cahn import AllenCahn2DPeriodic
    from pde_opt_tpu_torch.models.functions import Mixer2d
    from pde_opt_tpu_torch.models.pde_model import PDEModel
    from pde_opt_tpu_torch.ops.integrate import PIDController, integrate_adaptive
    from pde_opt_tpu_torch.ops.steppers import Tsit5

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64

    def sync():
        torch.cuda.synchronize()

    kernels.reset_launch_counts()

    # -- (a) examples/optimize_3d.py: Legendre mu and D at 32^3 by LM ----------
    fit3 = legendre_fit_3d(dev, f32, FIT3D_GRID)
    fit3_cpu = legendre_fit_3d(cpu, f64, FIT3D_GRID, ys=fit3.ys)
    _check(all(bool(torch.isfinite(y).all()) for y in fit3.ys), "3D fit data: not finite")
    jac = fit3.jacobian()
    sync()
    t0 = time.perf_counter()
    for _ in range(FIT3D_JAC_REPS):
        jac = fit3.jacobian()
    sync()
    jac_ms = (time.perf_counter() - t0) / FIT3D_JAC_REPS * 1e3
    jac_err = _rel(jac, fit3_cpu.jacobian())
    _on_card(dev, "3D fit", *fit3.ys, jac)
    line = (f"check fit3d: Jacobian at theta0 {tuple(jac.shape)} on the card (f32) vs the "
            f"CPU (f64): rel Frobenius err {jac_err:.3e}")
    _check(jac_err <= TOL_FIT_JAC, f"{line} > {TOL_FIT_JAC}")
    print(line, flush=True)

    fit, secs, log = _logged(lambda: (fit3.train("least_squares", FIT3D_STEPS, verbose=True),
                                      sync())[0])
    steps = sum(ln.startswith("[LM] step=") for ln in log)
    got = {k: fit[k].expansion.params for k in ("mu", "D")}
    _on_card(dev, "3D fit result", *got.values())
    with torch.no_grad():
        loss0 = float(0.5 * fit3.residuals(fit3.start())[0].pow(2).sum())
        loss1 = float(0.5 * fit3.residuals({k: fit[k] for k in got})[0].pow(2).sum())
    err = {k: (got[k] - fit3.truth[k].expansion.params).abs().max().item() for k in got}
    line = (f"fit3d: {FIT3D_GRID}^3 x 2 windows, Legendre mu and D from zeros, LM (f32): "
            f"{steps} steps in {secs:.4f} s, {secs / steps * 1e3:.4f} ms an iteration, a "
            f"Jacobian {jac_ms:.4f} ms; loss {loss0:.6e} -> {loss1:.6e} ({loss0 / loss1:.3e}x); "
            + "; ".join(f"{k} {[round(v, 6) for v in got[k].tolist()]} (err {err[k]:.3e})"
                        for k in got)
            + f"; last: {log[-1] if log else '-'}")
    _check(loss1 * FIT3D_LOSS_DROP <= loss0, f"{line}: loss fell less than {FIT3D_LOSS_DROP}x")
    _check(max(err.values()) <= TOL_FIT_COEF, f"{line}: coefficients off by > {TOL_FIT_COEF}")
    print(f"{line} [{card}]", flush=True)

    # -- (b) examples/optimize_nn.py --grid 128: a PeriodicCNN mu by L-BFGS ----
    nn = nn_mu_fit_2d(dev, f32, NNFIT_GRID, NNFIT_HIDDEN)
    cnn = nn.start()["mu"]
    nn_cpu = nn_mu_fit_2d(cpu, f64, NNFIT_GRID, ys=nn.ys, cnn=copy.deepcopy(cnn).to(cpu, f64))

    def mse_grad(problem):
        net = problem.start()["mu"]
        res, _ = problem.residuals({"mu": net}, adjoint="checkpoint")
        loss = res.pow(2).mean()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        return loss.detach(), torch.cat([gr.reshape(-1) for gr in grads])

    loss_c, grad_c = mse_grad(nn)
    loss_h, grad_h = mse_grad(nn_cpu)
    _on_card(dev, "NN fit", *nn.ys, loss_c, grad_c, *cnn.parameters())
    l_err, g_err = _rel(loss_c, loss_h), _rel(grad_c, grad_h)
    line = (f"check nnfit: first loss and gradient ({grad_c.numel()} parameters) on the card "
            f"(f32) vs the CPU (f64): rel err {l_err:.3e}, {g_err:.3e}")
    _check(max(l_err, g_err) <= TOL_NNFIT, f"{line} > {TOL_NNFIT}")
    print(line, flush=True)

    nfit, nsecs, nlog = _logged(lambda: (nn.train("mse", NNFIT_STEPS, verbose=True), sync())[0])
    nsteps = sum(ln.startswith("[LBFGS] step=") for ln in nlog)
    _on_card(dev, "NN fit result", *nfit["mu"].parameters())
    with torch.no_grad():
        loss_last = float(nn.residuals({"mu": nfit["mu"]})[0].pow(2).mean())
    line = (f"nnfit: {NNFIT_GRID}^2 x 2 windows, PeriodicCNN(1, {NNFIT_HIDDEN}, 1, 3) mu, "
            f"train(method='mse') (f32): {nsteps} L-BFGS steps in {nsecs:.4f} s, "
            f"{nsecs / nsteps * 1e3:.4f} ms a step; loss {float(loss_c):.6e} -> {loss_last:.6e}")
    _check(nsteps >= 1 and loss_last < float(loss_c), f"{line}: the loss did not fall")
    print(f"{line} [{card}]", flush=True)

    # -- (c) Mixer2d on 128^2 fields ------------------------------------------
    mixer = Mixer2d((1, MIXER_GRID, MIXER_GRID), *MIXER_ARGS,
                    generator=torch.Generator().manual_seed(2), device=dev)
    rng = np.random.default_rng(3)
    mx = rng.standard_normal((MIXER_BATCH, MIXER_GRID, MIXER_GRID))
    mw = rng.standard_normal((MIXER_BATCH, MIXER_GRID, MIXER_GRID))

    def mixer_pair(net, device, dtype):
        x = torch.tensor(mx, dtype=dtype, device=device).requires_grad_(True)
        out = net(x)
        (gx,) = torch.autograd.grad((torch.tensor(mw, dtype=dtype, device=device) * out).sum(),
                                    [x])
        return out.detach(), gx

    out_c, gx_c = mixer_pair(mixer, dev, f32)
    out_h, gx_h = mixer_pair(copy.deepcopy(mixer).to(cpu, f64), cpu, f64)
    _on_card(dev, "Mixer2d", out_c, gx_c, *mixer.parameters())
    o_err, x_err = _rel(out_c, out_h), _rel(gx_c, gx_h)
    sync()
    t0 = time.perf_counter()
    for _ in range(MIXER_REPS):
        mixer_pair(mixer, dev, f32)
    sync()
    mix_ms = (time.perf_counter() - t0) / MIXER_REPS * 1e3
    line = (f"check mixer2d: {MIXER_BATCH} x {MIXER_GRID}^2, patch {MIXER_ARGS[0]}, hidden "
            f"{MIXER_ARGS[1]}, {MIXER_ARGS[4]} blocks, card (f32) vs CPU (f64): output rel err "
            f"{o_err:.3e}, input gradient {x_err:.3e}; forward + input gradient {mix_ms:.4f} ms")
    _check(max(o_err, x_err) <= TOL_MIXER, f"{line} > {TOL_MIXER}")
    print(f"{line} [{card}]", flush=True)

    # -- (d) an adaptive Allen-Cahn solve: Tsit5 under a PIDController --------
    a = ADAPT_GRID
    ay0 = 0.1 * np.random.default_rng(4).standard_normal((a, a))
    ats = np.linspace(0.0, ADAPT_T_END, ADAPT_SAVES)
    ac_params = {"kappa": ADAPT_KAPPA, "mu": lambda c: c**3 - c, "R": torch.ones_like,
                 "derivs": "fd"}

    def adaptive(device, dtype):
        dom = Domain((a, a), ((-0.005 * a, 0.005 * a),) * 2, dtype=dtype)
        y0_ = torch.tensor(ay0, dtype=dtype, device=device)
        ctl = PIDController(*ADAPT_TOL)
        out = PDEModel(AllenCahn2DPeriodic, dom, Tsit5).solve(
            {**ac_params, "device": device}, y0_, ats, dt0=ADAPT_DT0, stepsize_controller=ctl)
        eq = AllenCahn2DPeriodic(dom, **ac_params, device=device)
        again, stats = integrate_adaptive(Tsit5(), eq.rhs, y0_, ats, ADAPT_DT0, *ADAPT_TOL,
                                          return_stats=True)
        _check(torch.equal(out, again), "adaptive: solve and integrate_adaptive differ")
        return out, stats

    sol_h, st_h = adaptive(cpu, f64)
    for dtype in (f64, f32):
        (sol_c, st_c), asecs, _ = _logged(lambda: (adaptive(dev, dtype), sync())[0])
        _on_card(dev, "adaptive solve", sol_c)
        errs = (sol_c.double().cpu() - sol_h).abs().amax(dim=(1, 2))
        line = (f"check adaptive: AllenCahn2DPeriodic {a}^2, Tsit5, PIDController{ADAPT_TOL}, "
                f"{ADAPT_SAVES} saves to t = {ADAPT_T_END}: card ({str(dtype)[6:]}) "
                f"{st_c['accepted_steps']} accepted / {st_c['rejected_steps']} rejected steps, "
                f"CPU (float64) {st_h['accepted_steps']} / {st_h['rejected_steps']}; saves "
                f"max_abs_err {errs.max().item():.3e}, at t_end {errs[-1].item():.3e}; solve + "
                f"integrate_adaptive {asecs:.4f} s")
        if dtype == f64:
            _check(st_c == st_h and errs.max().item() <= TOL_ADAPT,
                   f"{line}: steps differ or > {TOL_ADAPT}")
        else:
            # f32's error estimate has a rounding floor (~1e-10) that f64's has
            # not, so the controller may place its steps elsewhere and the saves
            # between step ends carry another O(dt^2) interpolation error.
            _check(errs[-1].item() <= TOL_ADAPT, f"{line}: at t_end > {TOL_ADAPT}")
        print(f"{line} [{card}]", flush=True)

    counts = kernels.launch_counts()
    _check(not any(counts.values()), f"phase 11 launched a kernel: {counts}")
    print(f"phase 11: no launch of K1-K9 ({len(counts)} counters at 0)", flush=True)


# The SBM preset's Shape of its disk at GRID^2, in f64 on the CPU, computed
# by a child process (no card) while phases 2-11 run: it prints the step
# counts and seconds, then psi, as two .npy blobs on its stdout.
_SHAPE_REF_CODE = """
import sys, time
import numpy as np
import torch
from pde_opt_tpu_torch import grid as gridmod
from pde_opt_tpu_torch.geometry import Shape
torch.set_num_threads(1)
torch.set_default_dtype(torch.float64)
n = int(sys.argv[1])
dom = gridmod.Domain((n, n), ((-0.5, 0.5), (-0.5, 0.5)), dtype=torch.float32)
X, Y = dom.mesh()
t0 = time.perf_counter()
shape = Shape((np.sqrt(X**2 + Y**2) < 0.35).astype(X.dtype), dx=dom.dx,
              smooth_epsilon=4.0 * float(dom.dx[0]), device="cpu")
st = shape.smooth_stats
np.save(sys.stdout.buffer, np.array([st["accepted_steps"], st["rejected_steps"],
                                     time.perf_counter() - t0]))
np.save(sys.stdout.buffer, shape.smooth.numpy())
"""


class _CpuShape:
    """The child process that computes the CPU's f64 Shape (phase 12c's
    reference); ``stop`` ends it if it still runs."""

    def __init__(self, n):
        import os

        self.proc = subprocess.Popen(
            [sys.executable, "-c", _SHAPE_REF_CODE, str(n)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def result(self, timeout):
        """(psi, [accepted, rejected, seconds]) as numpy."""
        import io

        import numpy as np

        out, err = self.proc.communicate(timeout=timeout)
        _check(self.proc.returncode == 0, f"the CPU's Shape failed: {err.decode()[-2000:]}")
        buf = io.BytesIO(out)
        stats = np.load(buf)
        return np.load(buf), stats

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _density_err(torch, got, want, peak):
    """max |(|got|^2 - |want|^2)| over ``peak``, in f64 on the CPU."""
    got, want = got.detach().cpu().to(torch.complex128), want.detach().cpu().to(torch.complex128)
    return ((got.abs() ** 2 - want.abs() ** 2).abs().max() / peak).item()


def _rot_bound(B, N, n):
    """One macro call's least time, ms: the packed products (3n + 1 sweeps,
    each 2 (2N)^2 N = 8 N^3 operations a field) at the f32 peak against the
    bytes (the complex64 state in and out, the three block tensors)."""
    ops = B * 8 * N**3 * (3 * n + 1)
    nbytes = B * N * N * 8 * 2 + 3 * N * (2 * N) ** 2 * 4
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops


def _drive_rotating(torch, kernels, dev, card):
    """Phase 12a-b: bench.py's run_gpe_rot (the matmul ADI macro and the FFT
    DirectionalSplitting in imaginary time, checked against each other and
    the CPU's f64 DirectionalSplitting, timed; the sweeps' layout timed; the
    vortex census against the CPU's) and the stirring fleet
    make_gpe_rot_control_env (ROT_FLEET_STEPS steps under sync debug mode
    "error", its auto-reset, fused against fft).  Launches no K1-K9."""
    from pde_opt_tpu_torch.envs.presets import make_gpe_rot_control_env
    from pde_opt_tpu_torch.envs.vector_env import EnvState
    from pde_opt_tpu_torch.grid import Domain
    from pde_opt_tpu_torch.models.gross_pitaevskii import GPE2DTSRot
    from pde_opt_tpu_torch.ops.gpe_rot_fast import _sweep_mats, make_rot_adi_macro
    from pde_opt_tpu_torch.ops.integrate import evolve
    from pde_opt_tpu_torch.ops.steppers import DirectionalSplitting
    from pde_opt_tpu_torch.utils import density, initialize_Psi
    from pde_opt_tpu_torch.utils.rl import detect_vortices, vortex_winding

    _check(torch.get_float32_matmul_precision() == "highest",
           "TF32 is on: the ADI products must run in true f32")
    kernels.reset_launch_counts()
    B, N, n = ROT_ENVS, ROT_GRID, ROT_SUBSTEPS
    box = ((-ROT_BOX / 2, ROT_BOX / 2),) * 2

    def setup(device, dtype):
        dom = Domain((N, N), box, dtype=dtype)
        eq = GPE2DTSRot(dom, ROT_K, 0.0, ROT_OMEGA, device=device)
        return dom, eq, DirectionalSplitting(eq.A_terms, eq.B_terms, dom.dx[0], time_scale=-1j)

    dom, eq, stepper = setup(dev, torch.float32)
    dx = float(dom.dx[0])
    psi0 = initialize_Psi(N, width=14, vortexnumber=1, device=dev)
    psi0 = psi0 / torch.sqrt(density(psi0).sum() * dx * dx)
    y0 = psi0.expand(B, N, N).contiguous()
    macro = make_rot_adi_macro(eq.A_terms, eq.B_terms, dx, N, N, ROT_DT, n, time_scale=-1j)

    def fft_run(y):
        return evolve(stepper, None, y, 0.0, ROT_DT, n)

    # -- (a) checks: the two paths on the card, and the CPU's f64 oracle -----
    y_mm, y_fft = macro(y0), fft_run(y0)
    _, _, cstepper = setup(torch.device("cpu"), torch.float64)
    y_cpu = evolve(cstepper, None, y0[:ROT_CPU_FIELDS].cpu().to(torch.complex128), 0.0, ROT_DT, n)
    peak = (y_cpu.abs() ** 2).max().item()
    e_mf = _density_err(torch, y_mm, y_fft, peak)
    e_mc = _density_err(torch, y_mm[:ROT_CPU_FIELDS], y_cpu, peak)
    e_fc = _density_err(torch, y_fft[:ROT_CPU_FIELDS], y_cpu, peak)
    line = (f"check gpe_rot {B}x{N}^2x{n} imaginary time (Omega {ROT_OMEGA}, k {ROT_K}): density "
            f"max_abs_err / max density: matmul ADI vs fft {e_mf:.3e}; vs the CPU's f64 "
            f"DirectionalSplitting ({ROT_CPU_FIELDS} fields) matmul {e_mc:.3e}, fft {e_fc:.3e}")
    _check(max(e_mf, e_mc, e_fc) <= TOL_ROT, f"{line} > {TOL_ROT}")
    print(line, flush=True)

    # -- (a) rates, as bench.py's run_gpe_rot takes them ----------------------
    def rate(run, calls):
        y = run(y0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            y = run(y)
        torch.cuda.synchronize()
        return B * n * calls / (time.perf_counter() - t0), y

    fft_rate, _ = rate(fft_run, ROT_FFT_CALLS)
    mm_rate, y = rate(macro, ROT_MM_CALLS)
    _check(bool(torch.isfinite(y).all()), "gpe_rot: the matmul path's state is not finite")
    mm_ms = _time_ms(torch, lambda: macro(y0), reps=5, warmup=1)
    fft_ms = _time_ms(torch, lambda: fft_run(y0), reps=3, warmup=1)
    bound_ms, bound_by, ops = _rot_bound(B, N, n)
    print(f"gpe_rot rates: fft {fft_rate:.1f} field-substeps/s ({ROT_FFT_CALLS} calls), matmul ADI "
          f"{mm_rate:.1f} ({ROT_MM_CALLS} calls), {mm_rate / fft_rate:.2f}x; a call (CUDA events) "
          f"matmul {mm_ms:.4f} ms, fft {fft_ms:.4f} ms; matmul bound {bound_ms:.4f} ms "
          f"({bound_by}: {ops:.4e} product operations at {PEAK_F32 / 1e12:.0f} TFLOP/s f32), "
          f"{bound_ms / mm_ms:.1%} of it [{card}]", flush=True)

    # The sweeps' layout: state (H, 2, W, B); y-sweep a contiguous batched
    # product, x-sweep on strided views (no copy), against the x-sweep through
    # a permuted copy each way.
    mats = _sweep_mats(*eq.A_terms(None, 0.0), ROT_DT, -1j, torch.float32, dev)
    p = torch.randn((N, 2, N, B), device=dev)
    q = torch.empty_like(p)

    def lines(buf):
        return buf.permute(2, 0, 1, 3).view(N, 2 * N, B)

    def sweep_x_copy():
        lines(q).copy_(torch.bmm(mats.Mxh, lines(p).contiguous()))

    t_y = _time_ms(torch, lambda: torch.bmm(mats.Myh, p.view(N, 2 * N, B),
                                            out=q.view(N, 2 * N, B)), reps=20)
    t_x = _time_ms(torch, lambda: torch.bmm(mats.Mxh, lines(p), out=lines(q)), reps=20)
    t_xc = _time_ms(torch, sweep_x_copy, reps=20)
    sweep_ops = B * 8 * N**3
    sweeps = (3 * n + 1) * (t_x + t_y) / 2
    print(f"gpe_rot sweeps at {B}x{N}^2: y-sweep {t_y:.4f} ms ({sweep_ops / t_y / 1e9:.2f} "
          f"TFLOP/s), x-sweep on strided views {t_x:.4f} ms ({sweep_ops / t_x / 1e9:.2f}), x-sweep "
          f"through permuted copies {t_xc:.4f} ms; a {n}-substep call's {3 * n + 1} sweeps "
          f"{sweeps:.4f} ms of {mm_ms:.4f} ({sweeps / mm_ms:.1%}), the B phases and the "
          f"relayouts the rest [{card}]", flush=True)

    g = y[0]
    thresh = 0.05 * float(g.abs().max())
    n_card = int((vortex_winding(g, amp_thresh=thresh) != 0).sum())
    census = detect_vortices(g.cpu(), amp_thresh=thresh)
    line = (f"gpe_rot ground state after {(ROT_MM_CALLS + 1) * n} substeps: {n_card} vortices "
            f"on the card at amp_thresh 0.05 max|psi|, {census['num_vortices']} on the CPU "
            f"(total charge {census['total_topological_charge']})")
    _check(n_card == census["num_vortices"], f"{line}: the census differs")
    print(line, flush=True)

    # -- (b) the stirring fleet -------------------------------------------------
    def fleet(**kw):
        return make_gpe_rot_control_env(num_envs=ROT_FLEET_ENVS, grid_size=ROT_GRID,
                                        substeps=SUBSTEPS, device=dev, **kw)

    def policy(obs, g):
        return env.sample_actions(g)

    env, renv = fleet(), fleet(end_time=ROT_RESET_END)
    gen = torch.Generator(device=dev).manual_seed(95)
    for e in (env, renv):           # warm: the sweep matrices, the env glue
        st, _ = e.reset(gen)
        e.make_rollout(policy, 2)(st, gen)
    state, _ = env.reset(gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rewards, terms = env.make_rollout(policy, ROT_FLEET_STEPS)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    fleet_rate = ROT_FLEET_ENVS * ROT_FLEET_STEPS / (time.perf_counter() - t0)
    _check(rewards.shape == (ROT_FLEET_STEPS, ROT_FLEET_ENVS)
           and bool(torch.isfinite(rewards).all()), "stirring fleet: rewards")
    _check(not bool(terms.any()) and bool(torch.isfinite(state.y).all()), "stirring fleet: state")

    rstate, _ = renv.reset(gen)
    end_step = _end_step(torch, renv)
    torch.cuda.set_sync_debug_mode("error")
    rstate, rrew, rterms = renv.make_rollout(policy, ROT_FLEET_STEPS)(rstate, gen)
    torch.cuda.set_sync_debug_mode("default")
    early, episodes, since = _episode_ends(torch, rterms, end_step)
    norms = density(rstate.y).sum((-2, -1)) * dx * dx
    _check(early == 0 and episodes == (ROT_FLEET_STEPS // end_step) * ROT_FLEET_ENVS
           and torch.equal(rstate.step_count.cpu().long(), since)
           and bool(torch.isfinite(rrew).all())
           and (norms - 1.0).abs().max().item() < 1e-4, "stirring fleet: auto-reset")

    # Fused and fft from one shared state, one step, the same actions.
    fenv = fleet(spectral_solve="fft")
    fenv.reset(gen)
    a = env.sample_actions(gen)
    s1, o1, r1, *_ = env.step(EnvState(*(t.clone() for t in state)), a)
    s2, o2, r2, *_ = fenv.step(EnvState(*(t.clone() for t in state)), a)
    lsb = (o1.int() - o2.int()).abs().max().item()
    drho = (density(s1.y) - density(s2.y)).abs().max().item()
    drew = (r1 - r2).abs().max().item()
    line = (f"stirring fleet: {ROT_FLEET_ENVS} envs x {ROT_GRID}^2 x {SUBSTEPS} substeps, "
            f"{ROT_FLEET_STEPS} steps under sync debug mode 'error': {fleet_rate:.1f} env-steps/s; "
            f"with {end_step}-step episodes {episodes} ended and reset; fused vs fft, one step "
            f"from a shared state: obs max_lsb {lsb}, density max_abs_err {drho:.3e}, reward "
            f"max_abs_err {drew:.3e}")
    _check(lsb <= 1 and drho <= TOL_ROT_FLEET and drew <= 1e-4, f"{line}: fused and fft differ")
    print(f"{line} [{card}]", flush=True)
    counts = kernels.launch_counts()
    _check(not any(counts.values()), f"phase 12a-b launched a kernel: {counts}")
    print(f"phase 12a-b: no launch of K1-K9 ({len(counts)} counters at 0)", flush=True)


def _drive_shape_sbm(torch, kernels, dev, gen, card, shape_ref, sbm_rate):
    """Phase 12c: the SBM fleet on the Shape psi (smooth_geometry=True),
    built before any sync debug mode; its psi against the CPU's f64 Shape,
    K7 against plain at this psi, the charge balance, the fleet's STEPS +
    FLEET_STEPS_NO_EP steps (K7 once a step).  Returns the launch counts."""
    from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU, make_sbm_butler_volmer_control_env
    from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv
    from pde_opt_tpu_torch.ops.sbm_bv import SbmEpilogue, sbm_bv_macro_cuda, sbm_bv_macro_plain

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env = make_sbm_butler_volmer_control_env(num_envs=SBM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                             smooth_geometry=True, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = env.shape.smooth_stats
    psi = env.static_equation_parameters["psi"]
    ref, ref_stats = shape_ref.result(timeout=900)
    err = (psi.double().cpu() - torch.from_numpy(ref)).abs().max().item()
    band = int(((psi > 0.2) & (psi < 0.8)).sum())
    line = (f"phase 12c: Shape of the {GRID}^2 disk (eps 4 dx, smooth_dt 0.1) on the card "
            f"({str(env.shape.smooth.dtype)[6:]}): {st['accepted_steps']} accepted / "
            f"{st['rejected_steps']} rejected steps, the fleet built in {secs:.4f} s; the CPU's "
            f"f64: {int(ref_stats[0])} / {int(ref_stats[1])} in {ref_stats[2]:.4f} s; psi "
            f"max_abs_err {err:.3e}, {band} interface pixels (0.2 < psi < 0.8)")
    _check(err <= TOL_SHAPE and band > 0 and st["accepted_steps"] > 0, f"{line} > {TOL_SHAPE}")
    print(f"{line} [{card}]", flush=True)

    print("phase 12c: K7 at the Shape psi:", flush=True)
    u, cr, consts, _ = _check_sbm(torch, dev, gen, env)
    timings = {}
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=BV_DT, n_steps=SUBSTEPS,
              epilogue=SbmEpilogue(255.0, CENTER))
    _time_pair(torch, timings, "sbm_bv_macro_ep (Shape psi)",
               lambda: sbm_bv_macro_plain(u, cr, consts, **kw),
               lambda: sbm_bv_macro_cuda(u, cr, consts, **kw),
               f"{SBM_ENVS}x{GRID}^2x{SUBSTEPS}, the Shape psi", card)
    _check_charging(torch, env, gen, "SBM (Shape psi)")
    env0 = VectorPDEEnv(**{**{a: getattr(env, a) for a in _ENV_ARGS}, "fused_epilogue": None},
                        action_space_config=env.action_space_config)
    _, counts, rate = _drive_fleet(torch, kernels, env, env0, gen, "SBM (Shape psi)", 1e-4,
                                   may_diverge=True)
    _check(counts["sbm_bv_macro_ep"] == STEPS and counts["sbm_bv_macro"] == FLEET_STEPS_NO_EP
           and _total(counts) == STEPS + FLEET_STEPS_NO_EP, f"phase 12c launches {counts}")
    print(f"SBM (Shape psi) rollout: {rate:.1f} env-steps/s vs {sbm_rate:.1f} on the analytic psi "
          f"({STEPS} steps, {SBM_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps, fused epilogue) "
          f"[{card}]", flush=True)
    return counts


def _check_bv_big(torch, line, got, want, tol, bad, keep, n_px):
    """K6 or K7 against plain with the NaN env ``bad``: the field off plain
    by at most ``tol`` on the other envs ``keep``; with the epilogue,
    n_finite equal (the NaN env's below n_px), stats to rtol 1e-4 and obs
    within 1 LSB.  Returns (the line, the field error)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = (got[0][keep] - want[0][keep]).abs().max().item()
    line += f": u1 max_abs_err {err:.3e}"
    _check(err <= tol, f"{line} > {tol}")
    _check_nan_env(torch, line, got[0], want[0], bad, keep)
    if len(got) == 3:
        e_st = ((got[1][keep, :2] - want[1][keep, :2]).abs()
                / want[1][keep, :2].abs()).max().item()
        lsb = (got[2].int() - want[2].int()).abs().max().item()
        line += f", stats max_rel_err {e_st:.3e}, obs max_lsb {lsb}"
        _check(torch.equal(got[1][:, 2], want[1][:, 2])
               and (bad is None or float(got[1][bad, 2]) < n_px), f"{line}: n_finite")
        _check(e_st <= 1e-4 and lsb <= 1, f"{line}: epilogue bounds")
    return line, err


def _sbm_psi(torch, H, W):
    """The SBM preset's analytic disk psi on an H x W grid of the unit box."""
    from pde_opt_tpu_torch import grid as gridmod
    from pde_opt_tpu_torch.envs.presets import sbm_disk_psi

    return sbm_disk_psi(gridmod.Domain((H, W), ((-0.5, 0.5), (-0.5, 0.5)), "dimensionless",
                                       dtype=torch.float32))


def _check_bv_sbm_big(torch, dev, gen):
    """Phase 13a: the tiled K6 (f32 and bf16 matrices) and K7 (the preset's
    analytic psi) at BIG_GRIDS against their plain versions on the card,
    epilogue off and on, BVBIG_CHECK_ENVS envs (blocks walk several envs
    through their slots) with one NaN env that must stay in its env; at
    128^2 against the roll-stencil oracles, and one bf16 K6 substep at the
    rounding sites.  Returns the largest bf16 K6 and f32 K7 field errors."""
    from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
    from pde_opt_tpu_torch.ops import bv_cas, sbm_bv
    from pde_opt_tpu_torch.ops.cas_spectral import Epilogue, cas_constants
    from pde_opt_tpu_torch.ops.kernels import library, scratch_size

    B, bad = BVBIG_CHECK_ENVS, BIG_NAN_ENV
    keep = torch.arange(B, device=dev) != bad
    errs = {}
    for H, W in BIG_GRIDS:
        u, cr = _bv_inputs(torch, dev, gen, B, H, W)
        u[bad, 3, 7] = float("nan")
        n_px, big = H * W, (H, W) == (128, 128)
        for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            consts = cas_constants(H, W, 1.0 / H, 1.0 / W, mdt, dev)
            slots = scratch_size(library("bv_cc_macro", bv_cas._bind_library),
                                 "bv_cc_macro_scratch", u.device.index, int(mats == "bf16"), H,
                                 W)[0]
            _check(B > slots, f"K6 {H}x{W}: {B} envs do not outnumber its {slots} slots")
            kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA, cell=1.0 / n_px, dt=BV_DT,
                      n_steps=SUBSTEPS, round_bf16=mats == "bf16")
            tol, what = TOL_BV[mats], ""
            if mats == "bf16":
                # Two correct bf16 macros drift apart by bf16 ties that their
                # sums' orders round apart, more as the grid grows: the bound
                # is TOL_BV or twice the farther control, whichever is larger.
                plain = bv_cas.bv_cc_macro_plain(u, cr, consts, **kw)
                ctl = [(_with_control_transforms(torch, bv_cas, tc, bv_cas.bv_cc_macro_plain, u,
                                                 cr, consts, **kw) - plain)[keep].abs().max().item()
                       for tc in (False, True)]
                tol = max(tol, 2.0 * max(ctl))
                what = (f"; controls: f64-accumulated plain {ctl[0]:.3e}, tensor-core plain "
                        f"{ctl[1]:.3e}; bound {tol:.3e}")
            for ep in (None, Epilogue(255.0, 0.0, CENTER, 1)):
                got = bv_cas.bv_cc_macro_cuda(u, cr, consts, epilogue=ep, **kw)
                want = bv_cas.bv_cc_macro_plain(u, cr, consts, epilogue=ep, **kw)
                torch.cuda.synchronize()
                name = "bv_cc_macro_ep" if ep else "bv_cc_macro"
                line, err = _check_bv_big(
                    torch, f"check {name} mats={mats} {H}x{W} ({B} envs on {slots} slots, env "
                    f"{bad} NaN{what})", got, want, tol, bad, keep, n_px)
                print(line, flush=True)
                if mats == "bf16":
                    errs[name] = max(errs.get(name, 0.0), err)
            if big and mats == "f32":
                oracle = bv_cas.bv_cc_reference(BV_MU, BV_J0, BV_KAPPA, 1.0 / H, 1.0 / W, BV_DT,
                                                SUBSTEPS, remat=False)(u[keep], cr[keep])
                err = (bv_cas.bv_cc_macro_cuda(u[keep], cr[keep], consts, **kw)
                       - oracle).abs().max().item()
                print(f"check bv_cc_macro mats=f32 {H}x{W} vs roll-stencil oracle: max_abs_err "
                      f"{err:.3e}", flush=True)
                _check(err <= TOL_BV_ORACLE, f"K6 {H}x{W} vs oracle {err} > {TOL_BV_ORACLE}")
            if big and mats == "bf16":
                one = {**kw, "n_steps": 1}
                uk, ck = u[keep], cr[keep]
                _check_sites(f"bv_cc_macro mats=bf16 {H}x{W}",
                             bv_cas.bv_cc_macro_cuda(uk, ck, consts, **one),
                             bv_cas.bv_cc_macro_plain(uk, ck, consts, **one),
                             bv_cas.bv_cc_macro_plain(uk, ck, consts,
                                                      **{**one, "round_bf16": False}),
                             TOL_SITE["bv"])
        sconsts = sbm_bv.sbm_bv_constants(_sbm_psi(torch, H, W), BV_KAPPA, 1.0 / H, 1.0 / W, dev)
        slots = scratch_size(library("sbm_bv_macro", sbm_bv._bind_library),
                             "sbm_bv_macro_scratch", u.device.index, H, W)[0]
        _check(B > slots, f"K7 {H}x{W}: {B} envs do not outnumber its {slots} slots")
        kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=BV_DT, n_steps=SUBSTEPS)
        for ep in (None, sbm_bv.SbmEpilogue(255.0, CENTER)):
            got = sbm_bv.sbm_bv_macro_cuda(u, cr, sconsts, epilogue=ep, **kw)
            want = sbm_bv.sbm_bv_macro_plain(u, cr, sconsts, epilogue=ep, **kw)
            torch.cuda.synchronize()
            name = "sbm_bv_macro_ep" if ep else "sbm_bv_macro"
            line, err = _check_bv_big(
                torch, f"check {name} {H}x{W} analytic psi ({B} envs on {slots} slots, env "
                f"{bad} NaN)", got, want, TOL_BV["f32"], bad, keep, n_px)
            print(line, flush=True)
            errs[name] = max(errs.get(name, 0.0), err)
        if big:
            oracle = sbm_bv.sbm_bv_reference(BV_MU, BV_J0, BV_KAPPA, sconsts.psi, 1.0 / H,
                                             1.0 / W, BV_DT, SUBSTEPS, remat=False)(u[keep],
                                                                                   cr[keep])
            err = (sbm_bv.sbm_bv_macro_cuda(u[keep], cr[keep], sconsts, **kw)
                   - oracle).abs().max().item()
            print(f"check sbm_bv_macro {H}x{W} vs roll-stencil oracle: max_abs_err {err:.3e}",
                  flush=True)
            _check(err <= TOL_BV_ORACLE, f"K7 {H}x{W} vs oracle {err} > {TOL_BV_ORACLE}")
    return errs


def _check_fused_vs_rk4(torch, env, rk4, gen, name, variants):
    """One step of fused fleets against the same preset's RK4 fleet ``rk4``
    from one state (``env`` driven 10 random-policy steps from a reset) and
    the same actions; ``variants`` maps a label to (a fused env, its
    bound)."""
    from pde_opt_tpu_torch.envs.vector_env import EnvState

    state, _ = env.reset(gen)
    state, _, _ = env.make_rollout(lambda o, g: env.sample_actions(g), 10)(state, gen)
    a = env.sample_actions(gen)

    def step(e):
        return e.step(EnvState(*(t.clone() for t in state)), a)[0].y

    ref = step(rk4)
    for label, (fused, tol) in variants.items():
        err = (step(fused) - ref).abs().max().item()
        line = (f"check {name} fused ({label}) vs RK4 fleet, one step from one state on "
                f"{env.num_envs} envs: y max_abs_err {err:.3e}")
        _check(err <= tol, f"{line} > {tol}")
        print(line, flush=True)


def _with_f32_mats(torch, env):
    """``env`` with its fused stepper on f32 matrices."""
    from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv

    return VectorPDEEnv(**{**{a: getattr(env, a) for a in _ENV_ARGS},
                           "solver_parameters": {**env.solver_parameters,
                                                 "mats_dtype": torch.float32}},
                        action_space_config=env.action_space_config)


def _bvsbm_bounds():
    """The bounds of the tiled K6 and K7 at phase 13's fleet shapes, counted
    as _bounds() counts them at 64^2: K6 with the epilogue (8 transforms a
    substep, bf16) at BV128_ENVS x 128^2, K7 with the epilogue at
    SBM128_ENVS x 128^2."""
    n, G = SUBSTEPS, BVSBM128_GRID
    px = G * G
    mats = 4 * 2 * G * G * 4

    def ep_bytes(B):
        return B * (px * 4 * 2 + 4 + px + 12)

    return {
        "bv_cc_macro_ep 128^2": _bound(8 * n, G, G, BV128_ENVS, "bf16",
                                       (4 * 33 + 2) * px * n * BV128_ENVS,
                                       ep_bytes(BV128_ENVS) + mats + px * 4),
        "sbm_bv_macro_ep 128^2": _bound(0, G, G, SBM128_ENVS, "f32",
                                        (4 * 44 + 2) * px * n * SBM128_ENVS,
                                        ep_bytes(SBM128_ENVS) + 5 * px * 4),
    }


def _drive_bv_sbm_big(torch, kernels, dev, gen, card):
    """Phase 13b-d: the BV 128^2 fleet (K6) and the SBM 128^2 fleet on the
    analytic psi (K7) through their presets, each with its launch counts
    reset just before and read just after, under sync debug mode "error";
    the charge balance; the fused fleets against the RK4 fleets from one
    state; then K6 and K7 held against plain and timed at the fleets'
    shapes beside plain and their bounds.  Returns (each fleet's counts,
    the timings, each fleet's env-steps/s)."""
    from pde_opt_tpu_torch.envs.presets import (
        BV_J0,
        BV_MU,
        make_butler_volmer_control_env,
        make_sbm_butler_volmer_control_env,
    )
    from pde_opt_tpu_torch.ops import bv_cas, sbm_bv
    from pde_opt_tpu_torch.ops.cas_spectral import Epilogue, cas_constants

    G = BVSBM128_GRID
    fleets, rates = [], {}
    for name, make, B, kernel, diverge in (
            ("BV 128^2", make_butler_volmer_control_env, BV128_ENVS, "bv_cc_macro", False),
            ("SBM 128^2", make_sbm_butler_volmer_control_env, SBM128_ENVS, "sbm_bv_macro", True)):
        env = make(num_envs=B, grid_size=G, substeps=SUBSTEPS, device=dev)
        env0 = make(num_envs=B, grid_size=G, substeps=SUBSTEPS, fused_epilogue=False, device=dev)
        _check(abs(float(env.domain.dx[0]) - 1.0 / G) < 1e-12, f"{name}: h is not 1/{G}")
        _, counts, rate = _drive_fleet(torch, kernels, env, env0, gen, name, 1e-4,
                                       may_diverge=diverge,
                                       fleet_resets=kernel == "bv_cc_macro")
        _check(counts[f"{kernel}_ep"] == STEPS and counts[kernel] == FLEET_STEPS_NO_EP
               and _total(counts) == STEPS + FLEET_STEPS_NO_EP, f"{name} launches {counts}")
        print(f"{name}: {kernel} alone launched, once a step, no host sync: {counts}", flush=True)
        _check_charging(torch, env, gen, name)
        small, rk4 = (make(num_envs=BIG_RK4_ENVS, grid_size=G, substeps=SUBSTEPS,
                           auto_reset=False, method=m, device=dev) for m in ("fused", "rk4"))
        if kernel == "bv_cc_macro":
            variants = {"bf16 matrices": (small, TOL_BV_RK4_BF16),
                        "f32 matrices": (_with_f32_mats(torch, small), TOL_BV_ORACLE)}
        else:
            variants = {"f32": (small, TOL_BV_ORACLE)}
        _check_fused_vs_rk4(torch, small, rk4, gen, name, variants)
        fleets.append(counts)
        rates[name] = rate
        print(f"{name} fleet: {rate:.1f} env-steps/s ({B} envs x {G}^2 x {SUBSTEPS} substeps, "
              f"{STEPS} steps, fused epilogue) [{card}]", flush=True)

    # K6 and K7 at the fleets' shapes: against plain (blocks walk up to two
    # envs through their slots at 512 envs), then timed beside plain and the bound.
    bounds, timings = _bvsbm_bounds(), {}
    u6, c6 = _bv_inputs(torch, dev, gen, BV128_ENVS, G, G)
    consts = cas_constants(G, G, 1.0 / G, 1.0 / G, torch.bfloat16, dev)
    kw6 = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA, cell=1.0 / (G * G), dt=BV_DT,
               n_steps=SUBSTEPS, round_bf16=True, epilogue=Epilogue(255.0, 0.0, CENTER, 1))
    u7, c7 = _bv_inputs(torch, dev, gen, SBM128_ENVS, G, G)
    sconsts = sbm_bv.sbm_bv_constants(_sbm_psi(torch, G, G), BV_KAPPA, 1.0 / G, 1.0 / G, dev)
    kw7 = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=BV_DT, n_steps=SUBSTEPS,
               epilogue=sbm_bv.SbmEpilogue(255.0, CENTER))
    cases = (
        ("bv_cc_macro_ep 128^2", f"{BV128_ENVS}x{G}^2x{SUBSTEPS} bf16", TOL_BV["bf16"],
         lambda: bv_cas.bv_cc_macro_cuda(u6, c6, consts, **kw6),
         lambda: bv_cas.bv_cc_macro_plain(u6, c6, consts, **kw6)),
        ("sbm_bv_macro_ep 128^2", f"{SBM128_ENVS}x{G}^2x{SUBSTEPS}, analytic psi",
         TOL_BV["f32"], lambda: sbm_bv.sbm_bv_macro_cuda(u7, c7, sconsts, **kw7),
         lambda: sbm_bv.sbm_bv_macro_plain(u7, c7, sconsts, **kw7)),
    )
    for name, what, tol, kernel, plain in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        B = len(got[0])
        line, _ = _check_bv_big(torch, f"check {name} at {what}", got, want, tol, None,
                                torch.ones(B, dtype=torch.bool, device=dev), G * G)
        print(line, flush=True)
        _time_pair(torch, timings, name, plain, kernel, what, card)
        b_ms, b_by = bounds[name]
        ms = timings[name][0]
        print(f"bound {name}: {b_ms:.4f} ms ({b_by}); the kernel at {b_ms / ms:.1%} of it, "
              f"plain {timings[name][1]:.4f} ms [{card}]", flush=True)
    return fleets, timings, rates


def _dft_control_transforms(torch, tensor_cores):
    """``_dft_transforms`` of the packed-DFT macros with bf16 tables, the
    rounding sites kept, every product accumulated in f64 and rounded once
    to f32, or with ``tensor_cores`` on the TF32 tensor cores (exact
    products of bf16 values, f32 sums): a second correct bf16 macro, as
    :func:`_control_transforms` is for the cas macros."""

    def mm(a, b):
        return a @ b if tensor_cores else torch.matmul(a.double(), b.double()).float()

    def transforms(c, round_bf16):
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32)

        wr_hT, wi_hT, vr_hT, vi_hT = c.wr_h.T, c.wi_h.T, c.vr_h.T, c.vi_h.T

        def fwd(x):
            x = rnd(x)
            ar, ai = rnd(mm(x, c.wr_w)), rnd(mm(x, c.wi_w))
            return mm(wr_hT, ar) - mm(wi_hT, ai), mm(wi_hT, ar) + mm(wr_hT, ai)

        def inv(zr, zi):
            zr, zi = rnd(zr), rnd(zi)
            cr = rnd(mm(vr_hT, zr) - mm(vi_hT, zi))
            ci = rnd(mm(vi_hT, zr) + mm(vr_hT, zi))
            return mm(cr, c.vr_w) - mm(ci, c.vi_w)

        return fwd, inv

    return transforms


def _with_dft_controls(torch, fn, *args, **kw):
    """``fn(*args, **kw)`` on each of the two :func:`_dft_control_transforms`
    (TF32 on for the tensor-core one): ``[f64-accumulated, tensor-core]``."""
    from unittest import mock

    from pde_opt_tpu_torch.ops import fused_spectral

    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for tc in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tc
        try:
            with mock.patch.object(fused_spectral, "_dft_transforms",
                                   _dft_control_transforms(torch, tc)):
                out.append(fn(*args, **kw))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _k9_cases(torch, dev, gen, B, H, W):
    """K9a, K9b (R == 1) and K9b (R = 1 + 0.5 u^2) on B fields of H x W at
    the CH and AC fleets' amplitudes and kappa ranges: a list of (label,
    launch-count name, cuda, plain, u, kappa, keyword arguments less the
    tables' and the substeps', bound of the field, rounding-site bound)."""
    from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R, CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
    from pde_opt_tpu_torch.ops.fused_spectral import (
        ac_sif_macro_cuda,
        ac_sif_macro_plain,
        ch_sif_macro_cuda,
        ch_sif_macro_plain,
    )

    u = 0.45 + 0.05 * torch.randn((B, H, W), generator=gen, device=dev)
    kap = 2e-3 + 8e-3 * torch.rand((B,), generator=gen, device=dev)
    u_ac = 0.1 * torch.randn((B, H, W), generator=gen, device=dev)
    kap_ac = 1e-4 + 9e-4 * torch.rand((B,), generator=gen, device=dev)
    r_gen = PolynomialMu(AC_R_GENERAL)
    ac = dict(mu_fn=AC_MU, hx=HX, hy=HY, dt=DT, A=A)
    return [("ch_sif_macro", "ch_sif_macro", ch_sif_macro_cuda, ch_sif_macro_plain, u, kap,
             dict(mu_fn=CH_MU, dt=DT, A=A), TOL_U, TOL_SITE["ch_sif"]),
            ("ac_sif_macro R=1", "ac_sif_macro", ac_sif_macro_cuda, ac_sif_macro_plain, u_ac,
             kap_ac, dict(ac, R_fn=AC_R, r_identity=True), TOL_AC, TOL_SITE["ac_sif"]),
            ("ac_sif_macro R=1+0.5u^2", "ac_sif_macro", ac_sif_macro_cuda, ac_sif_macro_plain,
             u_ac, kap_ac, dict(ac, R_fn=r_gen, r_identity=False), TOL_AC, TOL_SITE["ac_sif"])]


def _check_k9_big(torch, dev, gen):
    """Phase 14a: the tiled K9a and K9b at BIG_GRIDS against their plain
    versions on BIG_CHECK_ENVS envs with env BIG_NAN_ENV NaN, f32 and bf16
    tables, half and full spectrum; bf16 also against two correct plain
    controls; at 128^2 one bf16 substep at the rounding sites, and with f32
    tables against the FFT oracles and the tiled K2 / K4.  Returns the
    largest bf16 field errors."""
    from pde_opt_tpu_torch.envs.presets import AC_MU, CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import (
        ac_cas_macro_cuda,
        cas_constants,
        ch_cas_macro_cuda,
    )
    from pde_opt_tpu_torch.ops.fused_spectral import (
        ac_sif_macro_reference,
        ch_sif_macro_reference,
        sif_constants,
    )

    B, bad = BIG_CHECK_ENVS, BIG_NAN_ENV
    keep = torch.arange(B, device=dev) != bad
    errs = {}
    for H, W in BIG_GRIDS:
        cases = _k9_cases(torch, dev, gen, B, H, W)
        for label, name, cuda, plain, u, kap, kw0, tol, site in cases:
            x = u.clone()
            x[bad, 3, 7] = float("nan")
            for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                for half in (True, False):
                    consts = sif_constants(H, W, HX, HY, mdt, half, dev)
                    kw = dict(kw0, n_steps=SUBSTEPS, round_bf16=mats == "bf16")
                    got, want = cuda(x, kap, consts, **kw), plain(x, kap, consts, **kw)
                    torch.cuda.synchronize()
                    err = (got[keep] - want[keep]).abs().max().item()
                    bound, what = tol[mats], ""
                    if mats == "bf16":
                        # Two correct bf16 macros drift apart at bf16 ties that
                        # their sums' orders round apart: the bound is the field
                        # bound or twice the farther control, whichever is larger.
                        ctl = [(c - want)[keep].abs().max().item()
                               for c in _with_dft_controls(torch, plain, x, kap, consts, **kw)]
                        bound = max(bound, 2.0 * max(ctl))
                        what = (f"; controls: f64-accumulated plain {ctl[0]:.3e}, tensor-core "
                                f"plain {ctl[1]:.3e}; bound {bound:.3e}")
                    line = (f"check {label} {B}x{H}x{W}x{SUBSTEPS} mats={mats} "
                            f"{'half' if half else 'full'} spectrum, env {bad} NaN: u1 "
                            f"max_abs_err {err:.3e}{what}")
                    _check_nan_env(torch, line, got, want, bad, keep)
                    _check(err <= bound, f"{line} > {bound}")
                    print(line, flush=True)
                    if mats == "bf16":
                        errs[name] = max(errs.get(name, 0.0), err)
            if (H, W) != (128, 128):
                continue
            one = dict(kw0, n_steps=1, round_bf16=True)
            consts = sif_constants(H, W, HX, HY, torch.bfloat16, True, dev)
            _check_sites(f"{label} {B}x{H}x{W} mats=bf16", cuda(u, kap, consts, **one),
                         plain(u, kap, consts, **one),
                         plain(u, kap, consts, **{**one, "round_bf16": False}), site)
            # f32 tables: against the FFT oracle and the tiled cas macro.
            n = K9_ORACLE_ENVS
            consts = sif_constants(H, W, HX, HY, torch.float32, True, dev)
            kw = dict(kw0, n_steps=SUBSTEPS, round_bf16=False)
            got = cuda(u[:n], kap[:n], consts, **kw)
            if name == "ch_sif_macro":
                oracle = ch_sif_macro_reference(CH_MU, HX, HY, A, DT, SUBSTEPS)
                other = ch_cas_macro_cuda(u[:n], kap[:n],
                                          cas_constants(H, W, HX, HY, torch.float32, dev),
                                          mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS,
                                          round_bf16=False)
            else:
                oracle = ac_sif_macro_reference(AC_MU, kw0["R_fn"], HX, HY, A, DT, SUBSTEPS)
                other = ac_cas_macro_cuda(u[:n], kap[:n],
                                          cas_constants(H, W, HX, HY, torch.float32, dev),
                                          mu_fn=AC_MU, R_fn=kw0["R_fn"],
                                          r_identity=kw0["r_identity"], dt=DT, A=A,
                                          n_steps=SUBSTEPS, round_bf16=False)
            e_o = (got - oracle(u[:n], kap[:n])).abs().max().item()
            e_c = (got - other).abs().max().item()
            line = (f"check {label} {n}x{H}x{W}x{SUBSTEPS} mats=f32: vs FFT oracle max_abs_err "
                    f"{e_o:.3e}, vs the tiled {'K2' if name == 'ch_sif_macro' else 'K4'} "
                    f"{e_c:.3e}")
            _check(e_o <= TOL_K9_ORACLE and e_c <= TOL_K9_ORACLE, f"{line} > {TOL_K9_ORACLE}")
            print(line, flush=True)
    return errs


def _k9big_bounds():
    """The bounds of the tiled K9a and K9b at phase 14's path shapes,
    counted as _bounds() counts them at 64^2: K9a and K9b (R == 1) at
    DFT128_ENVS x 128^2, K9a at BIG256_ENVS x 256^2, bf16 tables."""
    n, out = SUBSTEPS, {}
    for name, B, G in (("ch_sif_macro 128^2", DFT128_ENVS, DFT128_GRID),
                       ("ac_sif_macro 128^2", DFT128_ENVS, DFT128_GRID),
                       ("ch_sif_macro 256^2", BIG256_ENVS, BIG256_GRID)):
        px, w2 = G * G, G // 2 + 1
        tables = (4 * G * G + 4 * G * w2) * 4
        field = B * px * 4 * 2 + B * 4
        if name.startswith("ch"):
            out[name] = _bound_ops((n + 0.5) * _dft_ops(G, G) * B, "bf16",
                                   (18 * px + 20 * G * w2) * n * B, field + tables + G * w2 * 8)
        else:
            out[name] = _bound_ops(n * _dft_ops(G, G) * B, "bf16",
                                   (29 * px + 11 * G * w2) * n * B, field + tables + G * w2 * 4)
    return out


def _drive_k9_big(torch, kernels, dev, gen, card, ch128_rate, ac128_rate):
    """Phase 14b: the dft fleets at 128^2 (K9a, K9b), K9a at 256^2 and a
    value+grad through K9a at 128^2, each with its launch counts reset just
    before and read just after; then K9a and K9b timed at these shapes
    beside plain and their bounds.  Returns (each path's counts, timings)."""
    from pde_opt_tpu_torch.envs.presets import (
        CH_MU,
        make_allen_cahn_control_env,
        make_cahn_hilliard_control_env,
    )
    from pde_opt_tpu_torch.ops.fused_spectral import make_ch_sif_fused_macro, sif_constants

    G = DFT128_GRID
    ch_counts, ch_rate = _drive_dft_fleet(torch, kernels, make_cahn_hilliard_control_env, "CH",
                                          "ch_sif_macro", card, DFT128_ENVS, G)
    ac_counts, ac_rate = _drive_dft_fleet(torch, kernels, make_allen_cahn_control_env, "AC",
                                          "ac_sif_macro", card, DFT128_ENVS, G)
    print(f"{G}^2 fleets, {DFT128_ENVS} envs: CH algo=dft {ch_rate:.1f} env-steps/s (K9a, no "
          f"epilogue) vs cas {ch128_rate:.1f} (K1, derivs=pallas, fused epilogue); AC algo=dft "
          f"{ac_rate:.1f} (K9b) vs cas {ac128_rate:.1f} (K4, fused epilogue) [{card}]",
          flush=True)

    # -- K9a at run_ch256's shape --
    N = BIG256_GRID
    macro = make_ch_sif_fused_macro(CH_MU, N, N, 0.01, 0.01, 1.0, BIG256_DT, SUBSTEPS)
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
    _check(m256_counts["ch_sif_macro"] == BIG256_CALLS
           and _total(m256_counts) == BIG256_CALLS, f"K9a 256^2 launches {m256_counts}")
    drift = (out.mean((-2, -1)) - u.mean((-2, -1))).abs().max().item()
    _check(bool(torch.isfinite(out).all()) and drift < 1e-3,
           f"K9a 256^2: non-finite field or per-env mean drift {drift}")
    print(f"K9a 256^2 macro: {BIG256_CALLS} chained calls of {BIG256_ENVS} envs x {N}^2 x "
          f"{SUBSTEPS} substeps (dt {BIG256_DT}), no host sync, launches {m256_counts}, per-env "
          f"mean drift {drift:.3e}: {BIG256_ENVS * SUBSTEPS * BIG256_CALLS / t_256:.1f} "
          f"field-substeps/s [{card}]", flush=True)

    # -- a value+grad through K9a at 128^2 (the oracle's backward) --
    u128 = 0.5 + 0.01 * torch.randn((DFT128_ENVS, G, G), generator=gen, device=dev)
    k128 = 2e-3 + 8e-3 * torch.rand((DFT128_ENVS,), generator=gen, device=dev)
    m128 = make_ch_sif_fused_macro(CH_MU, G, G, HX, HY, A, DT, SUBSTEPS)

    def value_and_grad(m, uu, kk):
        kk = kk.clone().requires_grad_()
        v = (m(uu, kk) ** 2).sum()
        v.backward()
        return v.detach(), kk.grad

    value_and_grad(m128, u128, k128)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vg = [value_and_grad(m128, u128, k128) for _ in range(K9_VG_CALLS)]
    torch.cuda.synchronize()
    t_vg = time.perf_counter() - t0
    vg_counts = kernels.launch_counts()
    _check(vg_counts["ch_sif_macro"] == K9_VG_CALLS and _total(vg_counts) == K9_VG_CALLS,
           f"K9a value+grad launches {vg_counts}")
    _check(all(bool(torch.isfinite(v)) and bool(torch.isfinite(g).all()) for v, g in vg),
           "K9a value+grad: non-finite value or gradient")
    print(f"K9a value+grad (checkpointed FFT-oracle backward): {K9_VG_CALLS} calls of "
          f"{DFT128_ENVS} envs x {G}^2 x {SUBSTEPS} substeps (bf16), launches {vg_counts}: "
          f"{DFT128_ENVS * SUBSTEPS * K9_VG_CALLS / t_vg:.1f} grad-env-substeps/s, "
          f"{t_vg / K9_VG_CALLS * 1e3:.4f} ms a call [{card}]", flush=True)
    # f32 tables on a few envs: the card (the tiled FMA K9a) against the CPU.
    n = K9_VG_CHECK_ENVS
    w = torch.randn((n, G, G), generator=gen, device=dev)
    res = []
    for d in (dev, torch.device("cpu")):
        m32 = make_ch_sif_fused_macro(CH_MU, G, G, HX, HY, A, DT, SUBSTEPS,
                                      mats_dtype=torch.float32)
        kk = k128[:n].to(d).clone().requires_grad_()
        v = (w.to(d) * m32(u128[:n].to(d), kk)).sum()
        v.backward()
        res.append((v.item(), kk.grad.cpu()))
    (v_card, g_card), (v_cpu, g_cpu) = res
    e_v = abs(v_card - v_cpu) / abs(v_cpu)
    e_g = ((g_card - g_cpu).abs().max() / g_cpu.abs().max()).item()
    line = (f"check K9a value+grad wrt kappa on the card vs the CPU ({n} envs x {G}^2 x "
            f"{SUBSTEPS} substeps, f32 tables): value rel_err {e_v:.3e}, grad max_err / "
            f"max|grad| {e_g:.3e}")
    _check(bool(torch.isfinite(g_card).all()) and e_v <= 1e-5 and e_g <= 5e-3,
           f"{line} > (1e-5, 5e-3)")
    print(line, flush=True)

    # -- K9a and K9b at these shapes: against plain, timed beside plain and the bound --
    bounds, timings = _k9big_bounds(), {}
    for label, (B, H) in (("128^2", (DFT128_ENVS, G)), ("256^2", (BIG256_ENVS, N))):
        cases = _k9_cases(torch, dev, gen, B, H, H)
        consts = sif_constants(H, H, HX, HY, torch.bfloat16, True, dev)
        for case_label, name, cuda, plain, uu, kk, kw0, tol, _ in cases[:2 if H == G else 1]:
            key = f"{name} {label}"
            kw = dict(kw0, n_steps=SUBSTEPS, round_bf16=True)
            what = f"{B}x{H}^2x{SUBSTEPS} bf16"
            got, want = cuda(uu, kk, consts, **kw), plain(uu, kk, consts, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            line = f"check {case_label} at {what}: u1 max_abs_err {err:.3e}"
            _check(bool(torch.isfinite(got).all()) and err <= tol["bf16"],
                   f"{line} > {tol['bf16']}")
            print(line, flush=True)
            _time_pair(torch, timings, key, lambda: plain(uu, kk, consts, **kw),
                       lambda: cuda(uu, kk, consts, **kw), what, card)
            b_ms, b_by = bounds[key]
            ms = timings[key][0]
            print(f"bound {key}: {b_ms:.4f} ms ({b_by}); the kernel at {b_ms / ms:.1%} of it, "
                  f"plain {timings[key][1]:.4f} ms [{card}]", flush=True)
    return (ch_counts, ac_counts, m256_counts, vg_counts), timings


def _drive_dense(torch, kernels, dev, gen, card, fused_rate):
    """Phase 14c: the CH fleet with spectral_solve="dense" at the flagship's
    shape, launch counts reset just before and read just after (none of
    K1-K9: the dense solve is a plain product in JAX too), under sync debug
    mode "error"; one substep of its stepper on the card against the CPU's.
    Returns its env-steps/s."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.ops.steppers import SemiImplicitDenseSolve

    env = make_cahn_hilliard_control_env(num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
                                         spectral_solve="dense", device=dev)

    def policy(obs, g):
        return env.sample_actions(g)

    st, _ = env.reset(gen)
    t0 = time.perf_counter()
    env.make_rollout(policy, 2)(st, gen)               # builds and copies the matrix once
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    state, _ = env.reset(gen)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rewards, _ = env.make_rollout(policy, DENSE_STEPS)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rate = NUM_ENVS * DENSE_STEPS / (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    _check(not any(counts.values()), f"dense fleet launched a kernel: {counts}")
    _check(bool(torch.isfinite(rewards).all()) and bool(torch.isfinite(state.y).all()),
           "dense fleet: non-finite rewards or field")
    print(f"CH fleet spectral_solve=dense ({env.solver_parameters['dtype']}, products "
          f"torch.mm(bf16, bf16, out_dtype=f32)): {DENSE_STEPS}-step rollout of {NUM_ENVS} envs x "
          f"{GRID}^2 x {SUBSTEPS} substeps, no host sync, no K1-K9 launch, rewards finite: "
          f"{rate:.1f} env-steps/s vs the fused fleet's {fused_rate:.1f} (K1); the first two "
          f"steps with the matrix's build and copy {t_build:.4f} s [{card}]", flush=True)

    # Where a step's time goes: one substep's solve (two bf16 products of
    # NUM_ENVS x HW by HW x HW) and its FD rhs, CUDA events.
    name = env.control_equation_parameter_name
    eq = env.equation_type(domain=env.domain, **{
        **env.static_equation_parameters,
        name: env.update_control_parameter(state.control_value, state.control_value)})
    solve = SemiImplicitDenseSolve(**env.solver_parameters)._solve_for_dt(env.dt_sub, dev)
    f0 = eq.rhs(state.y, 0.0)
    ms_solve = _time_ms(torch, lambda: solve(f0))
    ms_rhs = _time_ms(torch, lambda: eq.rhs(state.y, 0.0))
    hw = GRID * GRID
    print(f"dense step split: the solve {ms_solve:.4f} ms a substep "
          f"({2 * 2.0 * NUM_ENVS * hw * hw / (ms_solve * 1e-3) / 1e12:.1f} TFLOP/s), the FD rhs "
          f"{ms_rhs:.4f} ms, of a {NUM_ENVS / rate * 1e3 / SUBSTEPS:.4f} ms substep (host clock) "
          f"[{card}]", flush=True)

    # One substep from the fleet's own fields, card against CPU.
    n = DENSE_CHECK_ENVS
    y, cv = state.y[:n], state.control_value[:n]
    steps = []
    for d in (dev, torch.device("cpu")):
        params = {**env.static_equation_parameters, "device": d,
                  env.control_equation_parameter_name: env.update_control_parameter(cv.to(d),
                                                                                    cv.to(d))}
        eq = env.equation_type(domain=env.domain, **params)
        for dtype in ("bf16_sqrt", "f32"):
            stp = SemiImplicitDenseSolve(**{**env.solver_parameters, "dtype": dtype})
            steps.append(stp.step(eq.rhs, y.to(d), 0.0, env.dt_sub)[0].cpu() - y.cpu())
    got, got32, want, ctl = steps
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    e32 = (got32 - ctl).abs().max().item() / ctl.abs().max().item()
    line = (f"check dense substep card vs CPU ({n} envs x {GRID}^2): increment max_err "
            f"{err:.3e} of max {scale:.3e} ({err / scale:.3e}; rms {_rms(got - want):.3e}, the "
            f"f32 solve's {_rms(ctl - want):.3e}); f32 products {e32:.3e} of the largest")
    _check(err <= TOL_DENSE * scale and _rms(got - want) <= 0.1 * _rms(ctl - want)
           and e32 <= 1e-4, f"{line}: bounds {TOL_DENSE}, 0.1 of the f32 solve's rms, 1e-4")
    print(line, flush=True)
    return rate


def _check_implicit_euler(torch, dev, card):
    """Phase 14d: one ImplicitEuler.solve_step (Newton-GMRES) on a stiff
    nonlinear rhs, f64, on the card against the CPU's: y1 within TOL_IE
    (relative to its largest entry), the same iterations and flag."""
    from pde_opt_tpu_torch import ImplicitEuler

    def rhs(y, t):
        lap = (torch.roll(y, 1, -1) + torch.roll(y, -1, -1) + torch.roll(y, 1, -2)
               + torch.roll(y, -1, -2) - 4.0 * y)
        return 40.0 * lap + y - y**3

    y0 = torch.rand(IE_SHAPE, generator=torch.Generator().manual_seed(140),
                    dtype=torch.float64) * 2.0 - 1.0
    res = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        y1, stats = ImplicitEuler().solve_step(rhs, y0.to(d), 0.0, 0.05)
        res.append((y1.cpu(), {k: v.item() for k, v in stats.items()},
                    time.perf_counter() - t0))
    (yc, sc, tc), (yh, sh, th) = res
    err = ((yc - yh).abs().max() / yh.abs().max()).item()
    line = (f"check ImplicitEuler.solve_step on the card vs the CPU ({IE_SHAPE}, f64): y1 "
            f"max_err / max|y1| {err:.3e}; converged {sc['converged']} / {sh['converged']}, "
            f"iterations {sc['iterations']} / {sh['iterations']}, residual "
            f"{sc['residual_norm']:.3e} / {sh['residual_norm']:.3e}; {tc:.4f} s / {th:.4f} s "
            f"[{card}]")
    _check(err <= TOL_IE and sc["converged"] and sc["iterations"] == sh["iterations"], line)
    print(line, flush=True)


def _pe_fleets(torch, dev):
    """Phase 15a's six fleets: (name, the per-env env, its batched twin,
    the kernel of a step or None, its launches a step)."""
    from pde_opt_tpu_torch.envs.presets import (
        make_allen_cahn_control_env,
        make_cahn_hilliard_control_env,
    )

    cases = (
        ("CH fused (K2)", make_cahn_hilliard_control_env, NUM_ENVS,
         dict(spectral_solve="fused"), {}, "ch_cas_macro", 1),
        ("CH fused algo=dft (K9a)", make_cahn_hilliard_control_env, NUM_ENVS,
         dict(spectral_solve="fused"), {"algo": "dft"}, "ch_sif_macro", 1),
        ("CH fft derivs=pallas (K8)", make_cahn_hilliard_control_env, NUM_ENVS,
         dict(spectral_solve="fft", derivs="pallas"), {}, "ch_rhs_fd", SUBSTEPS),
        ("CH dense", make_cahn_hilliard_control_env, NUM_ENVS,
         dict(spectral_solve="dense"), {}, None, 0),
        ("AC fused (K4)", make_allen_cahn_control_env, AC_ENVS,
         dict(spectral_solve="fused"), {}, "ac_cas_macro", 1),
        ("AC fused algo=dft (K9b)", make_allen_cahn_control_env, AC_ENVS,
         dict(spectral_solve="fused"), {"algo": "dft"}, "ac_sif_macro", 1),
    )
    for name, make, n, kw, extra, kernel, per_step in cases:
        pair = []
        for vc in (False, True):
            env = make(num_envs=n, grid_size=GRID, substeps=SUBSTEPS, end_time=PE_END,
                       vectorized_control=vc, fused_epilogue=False, device=dev, **kw)
            env.solver_parameters.update(extra)
            pair.append(env)
        yield (name, *pair, kernel, per_step)


def _pe_run(torch, env, state, gen, actions):
    """``env`` stepped through ``actions`` from ``state`` (in place) with
    auto-resets drawn from ``gen``: (state, rewards, terminations, host
    seconds to a trailing synchronize)."""
    env.set_generator(gen)
    rewards, terms = [], []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for a in actions:
        state, _, r, te, _, _ = env.step(state, a)
        rewards.append(r)
        terms.append(te)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, torch.stack(rewards), torch.stack(terms), time.perf_counter() - t0


def _drive_per_env(torch, kernels, dev, card):
    """Phase 15a: each per-env fleet of :func:`_pe_fleets` against its
    batched twin.  Returns (the per-env runs' summed launch counts, the
    rates)."""
    from pde_opt_tpu_torch.envs.vector_env import EnvState

    total = {n: 0 for n in KERNELS}
    rates = {}
    for name, penv, benv, kernel, per_step in _pe_fleets(torch, dev):
        gen = torch.Generator(device=dev).manual_seed(150)
        for e in (penv, benv):                   # warm the glue and the cached tables
            st, _ = e.reset(gen)
            e.step(st, e.sample_actions(gen))
        end_step = _end_step(torch, penv)
        _check(end_step < PE_STEPS, "the per-env rollout must cross the episode end")
        state, _ = penv.reset(gen)
        start = EnvState(*(t.clone() for t in state))
        g_state = gen.get_state()
        agen = torch.Generator(device=dev).manual_seed(151)
        actions = [penv.sample_actions(agen) for _ in range(PE_STEPS)]
        kernels.reset_launch_counts()
        state, rew, terms, t_pe = _pe_run(torch, penv, state, gen, actions)
        counts = kernels.launch_counts()
        bstate, brew, bterms, t_b = _pe_run(
            torch, benv, EnvState(*(t.clone() for t in start)),
            torch.Generator(device=dev).set_state(g_state), actions)
        want = {n: 0 for n in counts}
        if kernel is not None:
            want[kernel] = per_step * PE_STEPS
        _check(counts == want, f"per-env {name}: launches {counts}, expected {want}")
        for n in total:
            total[n] += counts[n]
        _check(bool(torch.isfinite(rew).all()) and bool(torch.isfinite(state.y).all()),
               f"per-env {name}: non-finite rewards or field")
        _check(bool(terms[end_step - 1].all()), f"per-env {name}: no episode end")
        _check(torch.equal(terms, bterms), f"per-env {name}: terminations differ")
        gap = (state.y - bstate.y).abs().max().item()
        rgap = ((rew - brew).abs().max() / brew.abs().max()).item()
        same = torch.equal(state.y, bstate.y)
        for f in ("t", "control_value", "step_count", "done"):
            _check(torch.equal(getattr(state, f), getattr(bstate, f)),
                   f"per-env {name}: {f} differs from the batched fleet's")
        n, B = penv.num_envs, PE_STEPS
        rates[name] = (n * B / t_pe, n * B / t_b)
        line = (f"per-env {name}: {B} steps of {n} envs x {GRID}^2 x {SUBSTEPS} substeps across "
                f"the episode end at step {end_step}, launches {dict((k, v) for k, v in counts.items() if v)}; "
                f"field vs the batched fleet: max gap {gap:.3e} (bit for bit: {same}), reward "
                f"max gap {rgap:.3e} of the largest; {rates[name][0]:.1f} env-steps/s per env vs "
                f"{rates[name][1]:.1f} batched [{card}]")
        _check(same if per_step == 1 else gap <= TOL_PE_OTHER, line)
        _check(rgap <= TOL_PE_REWARD, line)
        print(line, flush=True)
    return total, rates


def _check_per_env_time(torch, dev, card):
    """Phase 15b: a fleet of AdvectionDiffusion-v0's dynamics (RK4, a
    2-vector velocity control) whose velocity also depends on each env's
    own time, started at staggered times, against the CPU's f64."""
    import numpy as np

    from pde_opt_tpu_torch import grid as gridmod
    from pde_opt_tpu_torch.envs.vector_env import (
        VectorPDEEnv,
        env_state_from_numpy,
        env_state_to_numpy,
    )
    from pde_opt_tpu_torch.models.advection_diffusion import AdvectionDiffusion2D
    from pde_opt_tpu_torch.ops.steppers import RK4

    def make(d, n, dtype):
        return VectorPDEEnv(
            equation_type=AdvectionDiffusion2D,
            domain=gridmod.Domain((GRID, GRID), ((-0.5, 0.5), (-0.5, 0.5)), dtype=dtype),
            solver_type=RK4, end_time=1.0, step_dt=0.01, numeric_dt=0.0025,
            state_to_observation_func=lambda y: torch.clamp(y * 255.0, 0, 255).to(
                torch.uint8)[..., None, :, :],
            reward_function=lambda y: -y.var(),
            reset_func=lambda domain, g, b: torch.rand((b, *domain.points), generator=g,
                                                       device=g.device, dtype=dtype),
            reset_control_value=np.zeros(2, np.float32),
            update_control_value=lambda off, old: old + 0.1 * off,
            update_control_parameter=lambda old, new: (
                lambda t, X, Y: (new[0] * torch.cos(6.0 * t), new[1] + t)),
            action_space_config={"type": "continuous", "shape": (2,)},
            static_equation_parameters={"diffusion_coeff": 0.01, "device": d},
            control_equation_parameter_name="velocity",
            solver_parameters={}, num_envs=n, device=d)

    rng = np.random.default_rng(152)
    n = PE_AD_ENVS
    xs = np.linspace(-0.5, 0.5, GRID, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1))
    arrs = {"y": (0.5 + 0.3 * np.sin(2 * np.pi * X + phase) * np.cos(2 * np.pi * Y)),
            "t": (0.01 * rng.integers(0, 50, n)).astype(np.float32),
            "control_value": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "step_count": np.zeros(n, np.int32), "done": np.zeros(n, bool)}
    acts = rng.uniform(-1, 1, (PE_AD_STEPS, n, 2)).astype(np.float32)
    env = make(dev, n, torch.float32)
    env.set_generator(torch.Generator(device=dev).manual_seed(153))
    state = env_state_from_numpy({**arrs, "y": arrs["y"].astype(np.float32)}, dev)
    for a in acts:
        state, *_ = env.step(state, torch.from_numpy(a).to(dev))
    got = env_state_to_numpy(state)
    k = PE_AD_CHECK
    ref = make("cpu", k, torch.float64)
    ref.set_generator(torch.Generator().manual_seed(153))
    rstate = env_state_from_numpy({f: v[:k] for f, v in arrs.items()}, "cpu")
    for a in acts:
        rstate, *_ = ref.step(rstate, torch.from_numpy(a[:k]))
    want = env_state_to_numpy(rstate)
    err = np.abs(got["y"][:k] - want["y"]).max()
    moved = np.abs(want["y"] - arrs["y"][:k]).max()
    # Each env at its own time: the same envs started all at t = 0 end
    # elsewhere, by far more than the tolerance.
    r0 = make("cpu", k, torch.float64)
    r0.set_generator(torch.Generator().manual_seed(153))
    zstate = env_state_from_numpy({**{f: v[:k] for f, v in arrs.items()},
                                   "t": np.zeros(k, np.float32)}, "cpu")
    for a in acts:
        zstate, *_ = r0.step(zstate, torch.from_numpy(a[:k]))
    t_effect = np.abs(env_state_to_numpy(zstate)["y"] - want["y"]).max()
    line = (f"per-env time: advection-diffusion fleet ({n} envs x {GRID}^2, RK4, velocity of "
            f"the control and t), {PE_AD_STEPS} steps from staggered t in "
            f"[{arrs['t'].min():.2f}, {arrs['t'].max():.2f}]: {k} envs vs the CPU's f64 max_err "
            f"{err:.3e} (the field moved {moved:.3e}; from t = 0 it would end {t_effect:.3e} "
            f"away) [{card}]")
    _check(err <= TOL_PE_AD and t_effect > 100 * TOL_PE_AD and np.array_equal(
        got["t"][:k], want["t"]), line)
    print(line, flush=True)


def _check_gym_core(torch, kernels, dev, card):
    """Phase 15c: the gym adapter's step core
    (:func:`~pde_opt_tpu_torch.envs.vector_env.macro_step`, one env, 0-d
    control and time tensors) against env 0 of a per-env fleet (K2), from
    one start and action list, bit for bit."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.envs.vector_env import macro_step

    env = make_cahn_hilliard_control_env(
        num_envs=PE_GYM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
        end_time=PE_GYM_STEPS * 0.01, vectorized_control=False, spectral_solve="fused",
        auto_reset=False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(154)
    state, _ = env.reset(gen)
    y, cv, t = state.y[0].clone(), state.control_value[0].clone(), state.t[0].clone()
    actions = [env.sample_actions(gen) for _ in range(PE_GYM_STEPS)]
    kernels.reset_launch_counts()
    for a in actions:
        new_cv = env.update_control_value(a[0], cv)
        y = macro_step(env, y, cv, new_cv, t)
        cv, t = new_cv, t + env.step_dt
    gym_counts = kernels.launch_counts()
    for a in actions:
        state, _, _, term, _, _ = env.step(state, a)
    torch.cuda.synchronize()
    same = torch.equal(y, state.y[0])
    line = (f"gym core: {PE_GYM_STEPS}-step episode of one env at {GRID}^2 through macro_step "
            f"({gym_counts['ch_cas_macro']} K2 launches) vs env 0 of a {PE_GYM_ENVS}-env per-env "
            f"fleet: max gap {(y - state.y[0]).abs().max().item():.3e}, bit for bit: {same}; "
            f"episode ended {bool(term[0])} [{card}]")
    _check(same and torch.equal(cv, state.control_value[0]) and bool(term.all())
           and gym_counts["ch_cas_macro"] == PE_GYM_STEPS, line)
    print(line, flush=True)


def _check_checkpoint(torch, kernels, dev, card):
    """Phase 15d: save the flagship fused-epilogue fleet (K1) mid-rollout
    with its auto-reset generator and a PPO actor-critic with its Adam
    state; restore into fresh objects and run the same PE_RESUME_STEPS
    steps again, bit for bit; max_to_keep.  Returns K1's launches."""
    import os
    import tempfile

    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.rl import ActorCriticMLP, PPOConfig, Sampler, make_ppo_train_step
    from pde_opt_tpu_torch.utils.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    def fleet():
        return make_cahn_hilliard_control_env(NUM_ENVS, GRID, SUBSTEPS, spectral_solve="fused",
                                              obs_downsample=4, end_time=PE_END, device=dev)

    def net_and_opt(seed, env):
        net = ActorCriticMLP(1, (GRID // 4) ** 2, widths=(256,), features=64,
                             compute_dtype=torch.bfloat16,
                             generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        train_step, optimizer = make_ppo_train_step(
            env, PPOConfig(rollout_steps=4, epochs=1, minibatches=2, lr=3e-4))
        return net, optimizer(net.parameters()), train_step

    env = fleet()
    net, opt, train_step = net_and_opt(155, env)
    gen = torch.Generator(device=dev).manual_seed(156)
    state, _ = env.reset(gen)
    kernels.reset_launch_counts()
    state, _ = train_step(net, opt, state, Sampler(torch.Generator(device=dev).manual_seed(157)))
    for a in [env.sample_actions(gen) for _ in range(PE_RESUME_AT - 4)]:
        state, *_ = env.step(state, a)
    agen = torch.Generator(device=dev).manual_seed(158)
    actions = [env.sample_actions(agen) for _ in range(PE_RESUME_STEPS)]
    tree = {"env": state, "generator": gen.get_state(),
            "ppo": {"params": net.state_dict(), "adam": opt.adam.state_dict()}}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(root, "run"), PE_RESUME_AT, tree)
        t_save = time.perf_counter() - t0
        saved_params = {k: v.clone() for k, v in net.state_dict().items()}
        state, rew, terms, _ = _pe_run(torch, env, state, gen, actions)
        counts = kernels.launch_counts()

        env2 = fleet()
        net2, opt2, _ = net_and_opt(159, env2)
        template_state, _ = env2.reset(torch.Generator(device=dev).manual_seed(160))
        t0 = time.perf_counter()
        back = restore_checkpoint(os.path.join(root, "run"), template={
            "env": template_state, "generator": torch.Generator().get_state(),
            "ppo": {"params": net2.state_dict()}})
        adam = restore_checkpoint(os.path.join(root, "run"))["ppo"]["adam"]
        t_restore = time.perf_counter() - t0
        net2.load_state_dict(back["ppo"]["params"])
        opt2.adam.load_state_dict(adam)
        for k, v in net2.state_dict().items():
            _check(torch.equal(v, saved_params[k]) and v.dtype == saved_params[k].dtype
                   and v.device == saved_params[k].device, f"checkpoint: parameter {k}")
        for (k, s1), s2 in zip(opt.adam.state_dict()["state"].items(),
                               opt2.adam.state_dict()["state"].values()):
            for f, v in s1.items():
                _check(torch.equal(v, s2[f]) and v.dtype == s2[f].dtype
                       and v.device == s2[f].device, f"checkpoint: Adam state {k} {f}")
        gen2 = torch.Generator(device=dev).set_state(back["generator"])
        state2, rew2, terms2, _ = _pe_run(torch, env2, back["env"], gen2, actions)
        ok = (torch.equal(rew, rew2) and torch.equal(terms, terms2)
              and all(torch.equal(a, b) for a, b in zip(state, state2)))
        size = os.path.getsize(os.path.join(root, "run", f"ckpt_{PE_RESUME_AT}.pt"))
        line = (f"checkpoint: the {NUM_ENVS}-env fused-epilogue fleet at step {PE_RESUME_AT} "
                f"with its generator, a PPO actor-critic and its Adam state ({size / 2**20:.1f} "
                f"MiB, save {t_save:.3f} s, restore {t_restore:.3f} s): parameters and Adam "
                f"state bit for bit on {dev}; {PE_RESUME_STEPS} steps again from the restored "
                f"state ({int(terms.sum())} episode ends) bit for bit: {ok} [{card}]")
        _check(ok and bool(terms.any()), line)
        print(line, flush=True)
        keep = os.path.join(root, "keep")
        for step in (1, 2, 3, 4):
            save_checkpoint(keep, step, {"x": torch.full((2,), float(step), device=dev)},
                            max_to_keep=3)
        names = sorted(os.listdir(keep))
        _check(names == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"] and latest_step(keep) == 4
               and float(restore_checkpoint(keep)["x"][0]) == 4.0,
               f"checkpoint max_to_keep: {names}")
        print(f"checkpoint: steps 1-4 saved with max_to_keep=3 keep {names}, latest 4", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def _drive_phase15(torch, kernels, dev, card):
    """Phase 15 with PyTorch's batching-fallback warning as an error: a
    per-sample loop cannot hide.  Returns (the main paths' launch counts,
    the per-env and batched rates)."""
    import warnings

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        counts, rates = _drive_per_env(torch, kernels, dev, card)
        _check_per_env_time(torch, dev, card)
        _check_gym_core(torch, kernels, dev, card)
        ck_counts = _check_checkpoint(torch, kernels, dev, card)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return counts, ck_counts, rates


def _so_run(torch, env, state, actions):
    """``env`` stepped through ``actions`` from ``state`` under sync debug
    mode "error": (state, rewards, obs, terminations, host seconds to a
    trailing synchronize)."""
    rewards, obs, terms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for a in actions:
        state, o, r, te, _, _ = env.step(state, a)
        rewards.append(r)
        obs.append(o)
        terms.append(te)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (state, torch.stack(rewards), torch.stack(obs), torch.stack(terms),
            time.perf_counter() - t0)


def _so_fleet(torch, kernels, mesh, make, name, kernel, steps, seed, card):
    """Phase 16a-b: the fleet ``make()`` sharded on the one-rank mesh
    against the unsharded one from one seed and one action list.  Returns
    the sharded run's launch counts."""
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    whole, senv = make(), ShardedVectorPDEEnv(make(), mesh)
    dev = whole.device
    for e in (whole, senv):                      # warm the glue and the cached tables
        st, _ = e.reset(torch.Generator(device=dev).manual_seed(seed + 2))
        e.step(st, whole.sample_actions(torch.Generator(device=dev).manual_seed(seed + 3)))
    ss, obs_s0 = senv.reset(torch.Generator(device=dev).manual_seed(seed))
    sw, obs_w0 = whole.reset(torch.Generator(device=dev).manual_seed(seed))
    agen = torch.Generator(device=dev).manual_seed(seed + 1)
    actions = [whole.sample_actions(agen) for _ in range(steps)]
    kernels.reset_launch_counts()
    ss, rs, os_, ts, _ = _so_run(torch, senv, ss, actions)
    counts = kernels.launch_counts()
    sw, rw, ow, tw, _ = _so_run(torch, whole, sw, actions)
    want = {n: 0 for n in counts}
    want[kernel] = steps
    # The rank's step is VectorPDEEnv.step: a fleet with a declared reset and
    # the fused epilogue auto-resets in one pass a step.
    want[FLEET_RESET] = steps * (hasattr(whole.reset_func, "affine")
                                 and whole.fused_epilogue is not None)
    _check(counts == want, f"sharded {name}: launches {counts}, expected {want}")
    same = {"reset obs": torch.equal(obs_s0, obs_w0), "fields": torch.equal(ss.y, sw.y),
            "rewards": torch.equal(rs, rw), "obs": torch.equal(os_, ow),
            "terminations": torch.equal(ts, tw),
            **{f: torch.equal(getattr(ss, f), getattr(sw, f))
               for f in ("t", "control_value", "step_count", "done")}}
    end_step = _end_step(torch, whole)
    ended = end_step <= steps and bool(tw[end_step - 1].all())
    _check(bool(torch.isfinite(rs).all()), f"sharded {name}: non-finite rewards")
    # The rates: more runs of each fleet from its own state, in turns.
    secs = {id(senv): [], id(whole): []}
    for e, st in ((senv, ss), (whole, sw), (whole, sw), (senv, ss)):
        secs[id(e)].append(_so_run(torch, e, st, actions)[-1])
    rate_s, rate_w = (2 * whole.num_envs * steps / sum(secs[id(e)]) for e in (senv, whole))
    line = (f"sharded {name} (world 1, NCCL): {steps} steps of {whole.num_envs} envs x "
            f"{GRID}^2 x {SUBSTEPS} substeps against the unsharded fleet, bit for bit: {same}; "
            f"episode end at step {end_step}{' crossed' if ended else ', after this run'}; launches "
            f"{dict((k, v) for k, v in counts.items() if v)}; {rate_s:.1f} env-steps/s sharded vs "
            f"{rate_w:.1f} (two runs each, in turns) [{card}]")
    _check(all(same.values()) and (ended or end_step > steps), line)
    print(line, flush=True)
    return counts


def _so_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _so_sif_oracle(torch, mu, shape, hs, dev, kappa, n):
    """The FD-symbol semi-implicit CH update with ``torch.fft`` over a whole
    field of ``shape`` on one card, its f64 symbol built once and cast to
    f32 (the oracle of tests/test_halo.py's 3D case)."""
    import numpy as np

    lam = sum(((2 * np.cos(2 * np.pi * np.arange(s) / s) - 2) / h**2).reshape(
        [s if j == i else 1 for j in range(len(shape))])
        for i, (s, h) in enumerate(zip(shape, hs)))
    lam = torch.from_numpy(lam).to(device=dev, dtype=torch.float32)
    denom = 1.0 / (1.0 + A * DT * kappa * lam**2)

    def update(u):
        for _ in range(n):
            incr = denom * (lam * torch.fft.fftn(mu(u)) - kappa * lam**2 * torch.fft.fftn(u))
            u = u + DT * torch.fft.ifftn(incr).real
        return u

    return update


def _so_spatial(torch, dev, card):
    """Phase 16c-d: the halo functions, the distributed FFT pairs and the
    sharded SIF macros at world 1 against the one-card ops."""
    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.ops.fused_spectral import ch_sif_macro_reference
    from pde_opt_tpu_torch.ops.stencils import lap_2nd_2d, lap_2nd_3d
    from pde_opt_tpu_torch.parallel import halo

    gen = torch.Generator(device=dev).manual_seed(162)
    N, N3, n = SO_GRID2D, SO_GRID3D, SO_SIF_SUBSTEPS
    u = torch.randn((N, N), generator=gen, device=dev)
    _check(torch.equal(halo.halo_pad_rows(u, halo=2), torch.cat([u[-2:], u, u[:2]])),
           "halo_pad_rows at world 1 is the periodic wrap")
    f = halo.distributed_fft2(u)
    errs = {"lap2d": _so_rel(halo.sharded_lap_2nd_2d(u, HX, HY), lap_2nd_2d(u, HX, HY)),
            "fft2": _so_rel(f, torch.fft.fft2(u.to(torch.complex64))),
            "ifft2": _so_rel(halo.distributed_ifft2(f).real, u)}
    v = torch.randn((N3, N3, N3), generator=gen, device=dev)
    f3 = halo.distributed_fft3(v)
    errs.update({"lap3d": _so_rel(halo.sharded_lap_2nd_3d(v, HX, HY, HX), lap_2nd_3d(v, HX, HY, HX)),
                 "fft3": _so_rel(f3, torch.fft.fftn(v.to(torch.complex64))),
                 "ifft3": _so_rel(halo.distributed_ifft3(f3).real, v)})
    del f, f3
    line = (f"halo and distributed FFT at world 1 ({N}^2, {N3}^3, f32), relative to the largest "
            "value: " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    _check(max(errs["lap2d"], errs["lap3d"]) <= TOL_SO_LAP
           and max(errs[k] for k in ("fft2", "ifft2", "fft3", "ifft3")) <= TOL_SO_FFT,
           f"{line} > ({TOL_SO_LAP}, {TOL_SO_FFT})")
    print(line + f" [{card}]", flush=True)
    us = 0.5 + 0.05 * torch.randn((N, N), generator=gen, device=dev)
    macro = halo.make_sharded_sif_ch_macro(CH_MU, N, N, HX, HY, A, DT, n)
    one = _so_sif_oracle(torch, CH_MU, (N, N), (HX, HY), dev, SO_KAPPA, n)
    got = macro(us, SO_KAPPA)
    sif2 = max(float((got - ch_sif_macro_reference(CH_MU, HX, HY, A, DT, n)(us, SO_KAPPA))
                     .abs().max()), float((got - one(us)).abs().max()))
    t2 = (_time_ms(torch, lambda: macro(us, SO_KAPPA), reps=3, warmup=1),
          _time_ms(torch, lambda: one(us), reps=3, warmup=1))
    vs = 0.5 + 0.05 * torch.randn((N3, N3, N3), generator=gen, device=dev)
    macro3 = halo.make_sharded_sif_ch3d_macro(CH_MU, N3, N3, N3, HX, HX, HX, A, DT, n)
    one3 = _so_sif_oracle(torch, CH_MU, (N3, N3, N3), (HX, HX, HX), dev, SO_KAPPA, n)
    got3 = macro3(vs, SO_KAPPA)
    sif3 = float((got3 - one3(vs)).abs().max())
    t3 = (_time_ms(torch, lambda: macro3(vs, SO_KAPPA), reps=3, warmup=1),
          _time_ms(torch, lambda: one3(vs), reps=3, warmup=1))
    finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(got3).all())
    line = (f"sharded SIF macros at world 1 ({n} substeps, f32) against the one-card FD-symbol "
            f"update (ch_sif_macro_reference too at {N}^2): {N}^2 max abs err {sif2:.3e} "
            f"({t2[0]:.4f} ms a call vs {t2[1]:.4f}, CUDA events), {N3}^3 {sif3:.3e} "
            f"({t3[0]:.4f} ms vs {t3[1]:.4f}) [{card}]")
    _check(finite and max(sif2, sif3) <= TOL_SO_SIF, f"{line} > {TOL_SO_SIF}")
    print(line, flush=True)
    return errs, {"sif2d": sif2, "sif3d": sif3, "sif2d_ms": t2, "sif3d_ms": t3}


def _so_ppo(torch, kernels, dev, mesh, card):
    """Phase 16e: one ppo_train(mesh=...) update at world 1 against the
    unsharded update; one sharded update under sync debug mode "error".
    Returns the ppo_train(mesh=...) update's launch counts."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv
    from pde_opt_tpu_torch.rl import ActorCriticMLP, PPOConfig, Sampler, make_ppo_train_step, ppo_train

    cfg = PPOConfig(rollout_steps=PPO_T, epochs=2, minibatches=4, lr=3e-4)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def env():
        return make_cahn_hilliard_control_env(NUM_ENVS, GRID, SUBSTEPS, derivs="pallas",
                                              spectral_solve="fused", obs_downsample=4, device=dev)

    def net():
        return ActorCriticMLP(1, (GRID // 4) ** 2, widths=(256,), features=64,
                              compute_dtype=torch.bfloat16, generator=gen(70), device=dev)

    def flat(m):
        return torch.cat([p.detach().reshape(-1).float() for p in m.parameters()])

    net_w, net_s = net(), net()
    start = flat(net_w)
    _, hist_w = ppo_train(env(), net_w, cfg, 1, generator=gen(71), env_generator=gen(72))
    kernels.reset_launch_counts()
    _, hist_s = ppo_train(env(), net_s, cfg, 1, generator=gen(71), env_generator=gen(72),
                          mesh=mesh)
    counts = kernels.launch_counts()
    _only_k1(counts, PPO_T, "ppo_train(mesh=...)")
    step = float((flat(net_w) - start).norm())
    gap = float((flat(net_s) - flat(net_w)).norm())
    line = (f"ppo_train(mesh=...) at world 1 against ppo_train, one update at run_ppo's shape: "
            f"reward_mean {hist_s[0]['reward_mean']:.6e} vs {hist_w[0]['reward_mean']:.6e}, loss "
            f"{hist_s[0]['loss']:.6e} vs {hist_w[0]['loss']:.6e}; parameters {gap:.3e} apart, "
            f"{gap / step:.3e} of the update's norm {step:.3e}")
    _check(hist_s[0]["reward_mean"] == hist_w[0]["reward_mean"] and gap <= TOL_RL_BF16 * step,
           f"{line} > {TOL_RL_BF16}")
    senv = ShardedVectorPDEEnv(env(), mesh)
    train_step, optimizer = make_ppo_train_step(senv.local, cfg, group=senv.group)
    opt = optimizer(net_s.parameters())
    state, _ = senv.reset(gen(73))
    sampler = Sampler(gen(74))

    def update():
        nonlocal state
        state, _ = train_step(net_s, opt, state, sampler)

    update()
    ms = 1e3 * _timed(torch, 1, update)
    print(f"{line}; a sharded update under sync debug mode 'error': {ms:.4f} ms [{card}]",
          flush=True)
    return counts


def _drive_phase16(torch, kernels, dev, card):
    """Phase 16: the scale-out layer at world size 1 on a one-rank NCCL
    group.  Returns (the paths' summed launch counts, the MULTICHIP_SCALING
    record)."""
    import tempfile

    import torch.distributed as dist

    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env, make_gpe_control_env
    from pde_opt_tpu_torch.parallel import init_distributed, make_mesh
    from pde_opt_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    init_distributed(num_processes=1, process_id=0, init_method=f"file://{store}/store")
    total = {n: 0 for n in KERNELS}
    try:
        mesh = make_mesh()
        _check(dist.get_backend() == "nccl" and mesh.device_type == "cuda" and mesh.size() == 1,
               f"phase 16: backend {dist.get_backend()}, mesh {mesh}")
        runs = [
            _so_fleet(torch, kernels, mesh, lambda: make_cahn_hilliard_control_env(
                NUM_ENVS, GRID, SUBSTEPS, end_time=SO_END, spectral_solve="fused", device=dev),
                "flagship fleet", "ch_cas_macro_ep", SO_STEPS, 160, card),
            _so_fleet(torch, kernels, mesh, lambda: make_gpe_control_env(
                GPE_ENVS, GRID, SUBSTEPS, device=dev),
                "GPE fleet", "gpe_strang_macro_ep", SO_GPE_STEPS, 164, card),
            _so_fleet(torch, kernels, mesh, lambda: make_cahn_hilliard_control_env(
                NUM_ENVS, GRID, SUBSTEPS, spectral_solve="fused", fused_epilogue=False,
                device=dev), "CH fleet without the epilogue", "ch_cas_macro", SO_K2_STEPS, 168,
                card),
        ]
        _so_spatial(torch, dev, card)
        runs.append(_so_ppo(torch, kernels, dev, mesh, card))
        kernels.reset_launch_counts()
        record = dryrun_multichip(1)
        runs.append(kernels.launch_counts())
        _check(runs[-1]["ch_cas_macro"] > 0 and runs[-1]["ch_cas_macro_bwd"] > 0,
               f"dryrun_multichip(1): launches {runs[-1]}")
        for counts in runs:
            for k in total:
                total[k] += counts[k]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s, launches "
          f"{dict((k, v) for k, v in total.items() if v)} [{card}]", flush=True)
    return total, record


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    shape_ref = _CpuShape(GRID)
    try:
        return _main(shape_ref)
    finally:
        shape_ref.stop()


def _main(shape_ref):
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
    from pde_opt_tpu_torch.envs.vector_env import EnvState
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
    print(f"build: {', '.join(SOURCES.values())} (K1-K9, the fleet-reset pass), in parallel, in "
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
    _check(counts[FLEET_RESET] == STEPS, f"fleet-reset launches {counts}: one a fused step")
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
    bv_state, bv_counts, bv_rate = _drive_fleet(torch, kernels, bv_env, bv_env0, gen, "BV", 1e-4,
                                                fleet_resets=True)
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

    def fleet_rate(e):
        return _fleet_rate(torch, e, gen, 30)

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

    # The auto-reset with its state write-back, into a copy of the state.
    into = EnvState(*(t.clone() for t in state))
    y1 = state.y.clone()
    cv1 = state.control_value.clone()
    t1, steps1 = state.t + env.step_dt, state.step_count + 1
    obs1 = env.state_to_observation_func(y1)
    none = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
    reset_ms = _time_ms(torch, lambda: env._auto_reset(into, none, y1, cv1, t1, steps1, obs1))
    step_ms = (t_a + t_b) / STEPS * 1e3
    rate = NUM_ENVS * STEPS / (t_a + t_b)
    print(f"time auto-reset block (fleet-wide draw + the fleet-reset pass): {reset_ms:.4f} ms "
          f"per step, {reset_ms / step_ms:.3%} of a {step_ms:.4f} ms env step [{card}]",
          flush=True)
    print(f"rollout: {rate:.1f} env-steps/s ({STEPS} steps in {t_a + t_b:.4f} s, "
          f"{NUM_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps) [{card}]", flush=True)
    # The fleet-reset pass at the three cells' fleets (CH 64^2 and 128^2, BV).
    ch128 = make_cahn_hilliard_control_env(num_envs=NUM_ENVS, grid_size=FLEET128_GRID,
                                           substeps=SUBSTEPS, spectral_solve="fused", device=dev)
    fr_fleets = ((f"CH {NUM_ENVS}x{GRID}^2", env),
                 (f"CH {NUM_ENVS}x{FLEET128_GRID}^2", ch128),
                 (f"BV {BV_ENVS}x{GRID}^2", bv_env))
    max_err[FLEET_RESET], fr_times = _check_fleet_reset(torch, kernels, fr_fleets, card)
    timings[FLEET_RESET] = fr_times[(fr_fleets[0][0], "none")]
    del ch128, fr_fleets
    torch.cuda.empty_cache()
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
    big_counts, ch128_rate, k1_128_ms = _drive_big(torch, kernels, dev, gen, card)

    # ---- 10. the AC and GPE macros above 64^2, K3 at 256^2: the tiled K4, K5, K3
    tiled_err = _check_tiled(torch, dev, gen)
    print(f"tiled K4, K5, K3 (256^2): largest bf16 errors: {tiled_err}", flush=True)
    tiled_counts, ac128_rate = _drive_tiled(torch, kernels, dev, gen, card)

    # ---- 11. the inverse-problem layer: LM, the coefficient nets, adaptive --
    _drive_inverse(torch, kernels, dev, card)

    # ---- 12. the rotating-frame GPE and the smoothed-boundary geometry -------
    _drive_rotating(torch, kernels, dev, card)
    shape_counts = _drive_shape_sbm(torch, kernels, dev, gen, card, shape_ref, sbm_rate)

    # ---- 13. the BV and SBM macros above 64^2: the tiled K6 and K7 ------------
    bvbig_err = _check_bv_sbm_big(torch, dev, gen)
    print(f"tiled K6 (bf16), K7: largest field errors: {bvbig_err}", flush=True)
    bvbig_counts, bvbig_times, bvbig_rates = _drive_bv_sbm_big(torch, kernels, dev, gen, card)
    k6_64, k7_64 = timings["bv_cc_macro_ep"][0], timings["sbm_bv_macro_ep"][0]
    k6_128, k7_128 = (bvbig_times[f"{k} 128^2"][0] for k in ("bv_cc_macro_ep", "sbm_bv_macro_ep"))
    print(f"phase 13: BV 128^2 {bvbig_rates['BV 128^2']:.1f} env-steps/s vs {bv_rate:.1f} at "
          f"64^2; SBM 128^2 {bvbig_rates['SBM 128^2']:.1f} vs {sbm_rate:.1f}; per env-substep "
          f"K6 {k6_128 / (BV128_ENVS * SUBSTEPS) * 1e3:.4f} us at 128^2 vs "
          f"{k6_64 / (BV_ENVS * SUBSTEPS) * 1e3:.4f} at 64^2, K7 "
          f"{k7_128 / (SBM128_ENVS * SUBSTEPS) * 1e3:.4f} vs "
          f"{k7_64 / (SBM_ENVS * SUBSTEPS) * 1e3:.4f} [{card}]", flush=True)

    # ---- 14. the packed-DFT macros above 64^2 (the tiled K9a, K9b); the dense
    # spectral solve, Newton-GMRES implicit Euler ----------------------------
    k9big_err = _check_k9_big(torch, dev, gen)
    print(f"tiled K9a, K9b: largest bf16 field errors: {k9big_err}", flush=True)
    k9big_counts, k9big_times = _drive_k9_big(torch, kernels, dev, gen, card, ch128_rate,
                                              ac128_rate)
    k9a_64, k9b_64 = timings["ch_sif_macro"][0], timings["ac_sif_macro"][0]
    k9a_128, k9b_128 = (k9big_times[f"{k} 128^2"][0] for k in ("ch_sif_macro", "ac_sif_macro"))
    print(f"phase 14: per env-substep K9a {k9a_128 / (DFT128_ENVS * SUBSTEPS) * 1e3:.4f} us at "
          f"128^2 vs {k9a_64 / (NUM_ENVS * SUBSTEPS) * 1e3:.4f} at 64^2, K9b "
          f"{k9b_128 / (DFT128_ENVS * SUBSTEPS) * 1e3:.4f} vs "
          f"{k9b_64 / (AC_ENVS * SUBSTEPS) * 1e3:.4f} [{card}]", flush=True)
    _drive_dense(torch, kernels, dev, gen, card, rate)
    _check_implicit_euler(torch, dev, card)

    # ---- 15. per-env stepping (vectorized_control=False): the six fleets
    # against their batched twins, per-env time, the gym core, checkpoints --
    pe_counts, ck_counts, pe_rates = _drive_phase15(torch, kernels, dev, card)
    print("phase 15: per-env vs batched env-steps/s: " + "; ".join(
        f"{k} {v[0]:.1f} vs {v[1]:.1f}" for k, v in pe_rates.items()) + f" [{card}]", flush=True)

    # ---- 16. scale-out at world size 1 on a one-rank NCCL group: the sharded
    # fleets, the halo and distributed FFT, ppo_train(mesh=...), the dry run --
    so_counts, _ = _drive_phase16(torch, kernels, dev, card)

    # Launches: each path's own run (CH serving and training together).
    max_err["ch_cas_macro_bwd"] = bwd_err
    launches = {n: sum(c[n] for c in (counts, train_counts, ac_counts, gpe_counts, bv_counts,
                                      sbm_counts, m3_counts, pallas_counts, dft_ch_counts,
                                      dft_ac_counts, dft_train_counts, ppo_counts, dqn_counts,
                                      ddpg_counts, *big_counts, *tiled_counts, shape_counts,
                                      *bvbig_counts, *k9big_counts, pe_counts, ck_counts,
                                      so_counts))
                for n in KERNELS}
    _check(all(v > 0 for v in launches.values()), f"a kernel was never launched: {launches}")
    bounds = _bounds()
    # library_ms is null for every kernel: no single PyTorch call computes a
    # whole macro (transforms, closure and epilogue over all substeps; K9's
    # carried spectrum or roll Laplacian), nor the flux rhs of K8 (mu, D, two
    # stencils and a face flux).  K1 also gives its time at the 128^2 cell's
    # fleet (4096 x 128^2 x 10, the on-chip kernel with its folded table).
    at_128 = {"ch_cas_macro_ep": {"ms_4096x128": k1_128_ms}}
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[lib], "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timings[name][0], "plain_ms": timings[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
         **at_128.get(name, {})}
        for name, (lib, replaces) in KERNELS.items()
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
