#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Two paths run at full width.  Serving: the flagship Cahn-Hilliard control
fleet, 4096 envs on a 64x64 periodic grid, 10 semi-implicit substeps per RL
step, per-env kappa control, reward -var, uint8 observation, auto-reset on.
Training: gradients through the same macro at 1024 envs x 64^2 x 10
substeps (the JAX package's ``train_grad`` bench config) and
``PDEModel.optimize`` with Adam on the fused stepper.
Phases (each passes or raises; nothing is caught):

1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written Hopper kernels from ``pde_opt_tpu_torch/csrc``.
3. Hold each kernel against its plain-torch version on the card at its
   path's shapes, with f32 and bf16 matrices: the macro (K2 without, K1
   with the env epilogue, obs_downsample 1 and 4; also against the FFT
   oracle) and its backward K3; run the epilogue variant's gradient (stats
   fold + K3) against the plain autograd Function on the CPU.
4. Reset the launch counts, then drive the serving path: a 120-step
   random-policy rollout of the fused-epilogue fleet (K1), which crosses
   the episode end and its auto-reset, and 10 steps of the same fleet
   without the fused epilogue (K2).  Check the rewards, the launch counts,
   the per-env mass drift and the epilogue reward against the env's own
   reward function; poison one env with NaN and check it is flagged and
   reset.
5. Reset the launch counts, then drive the training path: value and grad
   of ``sum(macro(u, kappa)**2)`` with respect to a per-env kappa (K2 +
   K3), and 5 Adam steps of ``PDEModel.optimize`` on a two-segment
   checkpointed rollout (each step: K2 twice per segment, the backward's
   recompute included, and K3 once).  Check finiteness, the launch counts,
   that kappa moved in every env, and (f32 matrices) the fused kappa
   gradient against autograd through the FFT oracle.
6. Time the kernels against their plain versions with CUDA events, the
   fused and the FFT-stepper value+grad, the auto-reset block, and the
   rollout's env-steps/s.

The last two lines are a JSON object per kernel and the JSON result line.
"""

import json
import subprocess
import sys
import time

NUM_ENVS, GRID, SUBSTEPS, STEPS, K2_STEPS = 4096, 64, 10, 120, 10
HX = HY = 0.01                 # the preset's grid: L = 0.01 * grid_size
DT, A = 0.01 / SUBSTEPS, 1.0   # the preset's substep and splitting constant
CENTER = 0.5                   # the preset's stats_center
TOL_U = {"f32": 1e-5, "bf16": 1e-3}      # kernel vs plain, field
TOL_ORACLE = {"f32": 1e-5, "bf16": 5e-3}  # macro vs FFT oracle, field
SOURCE = "pde_opt_tpu_torch/csrc/ch_cas_macro.cu"
REPLACES = {"ch_cas_macro_ep": "pde_opt_tpu/ops/cas_spectral.py:630",
            "ch_cas_macro": "pde_opt_tpu/ops/cas_spectral.py:392",
            "ch_cas_macro_bwd": "pde_opt_tpu/ops/cas_spectral.py:411"}
# Training path: bench.py's train_grad config and the optimize run.
TG_ENVS, TG_CALLS, OPT_STEPS, OPT_TS = 1024, 3, 5, (0.0, 0.01, 0.02)
# K3 vs its plain backward, each error relative to its maximum (du, dkappa),
# measured plus headroom: f32 is the same arithmetic (du 5.9e-7, dkappa
# 3.7e-5 measured on an H100); with bf16 matrices and the training loss's
# cotangent, du 3.5e-7 and dkappa 4.2e-3.  With bf16 matrices and a random
# cotangent no bound is held: on the training field (0.5 +- 0.01) rounding
# u_k to bf16 (ulp 2e-3) is ~10% of the fluctuation fwd(u_k) carries, so a
# flipped rounding between two accumulation orders moves dkappa by ~1e-2.
TOL_BWD = {"f32": (5e-6, 1e-4), "bf16": (1e-5, 1e-2)}


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


def main():
    import torch

    from pde_opt_tpu_torch.envs.presets import CH_MU, make_cahn_hilliard_control_env
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
    kernels.load_library("ch_cas_macro")
    print(f"build: {SOURCE} (K1, K2, K3) in {time.perf_counter() - t0:.2f} s", flush=True)

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
            if mats == "f32" or cot == "loss":
                _check(e_du <= tol_u and e_dk <= tol_k, f"{line} > {TOL_BWD[mats]}")
            else:
                line += " (reported, no bound)"
            print(line, flush=True)
            if mats == "bf16" and cot == "loss":
                bwd_err = e_abs

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

    # ---- 5. the training path ---------------------------------------------
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

    # ---- 6. timings ------------------------------------------------------
    consts = cas_constants(GRID, GRID, HX, HY, torch.bfloat16, dev)
    timings = {}
    for name, ep in (("ch_cas_macro_ep", Epilogue(255.0, 0.0, CENTER, 1)),
                     ("ch_cas_macro", None)):
        kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True, epilogue=ep)

        def plain():
            ch_cas_macro_plain(u, kap, consts, **kw)

        def kernel():
            ch_cas_macro_cuda(u, kap, consts, **kw)

        p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, kernel, plain))
        timings[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        flops = 4 * GRID * GRID * (GRID + GRID) * SUBSTEPS * NUM_ENVS
        print(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
              f"at {NUM_ENVS}x{GRID}^2x{SUBSTEPS} bf16; kernel "
              f"{flops / (timings[name][0] * 1e-3) / 1e12:.2f} TFLOP/s [{card}]", flush=True)

    kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True)
    g_tg = 2.0 * ch_cas_macro_plain(u_tg, kap_tg, consts, **kw)

    def plain_bwd():
        ch_cas_macro_bwd_plain(u_tg, kap_tg, g_tg, consts, **kw)

    def kernel_bwd():
        ch_cas_macro_bwd_cuda(u_tg, kap_tg, g_tg, consts, **kw)

    p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain_bwd, kernel_bwd, kernel_bwd, plain_bwd))
    timings["ch_cas_macro_bwd"] = ((k1 + k2) / 2, (p1 + p2) / 2)
    flops = 14 * GRID * GRID * (GRID + GRID) * SUBSTEPS * TG_ENVS
    print(f"time ch_cas_macro_bwd: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
          f"at {TG_ENVS}x{GRID}^2x{SUBSTEPS} bf16; kernel "
          f"{flops / (timings['ch_cas_macro_bwd'][0] * 1e-3) / 1e12:.2f} TFLOP/s [{card}]",
          flush=True)
    rates = {}
    for name, loss in (("fused", fused_loss), ("fft", sif_loss)):
        ms = _time_ms(torch, lambda: value_and_grad(loss), reps=5, warmup=1)
        rates[name] = TG_ENVS * SUBSTEPS / (ms * 1e-3)
        print(f"time value+grad {name}: {ms:.4f} ms per call, {rates[name]:.1f} "
              f"grad-env-substeps/s ({TG_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps) [{card}]",
              flush=True)
    print(f"fused vs fft value+grad: {rates['fused'] / rates['fft']:.2f}x [{card}]", flush=True)

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

    # Launches: the serving path's and the training path's runs together.
    max_err["ch_cas_macro_bwd"] = bwd_err
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": counts[name] + train_counts[name], "max_abs_err": max_err[name],
         "ms": timings[name][0], "plain_ms": timings[name][1]}
        for name in ("ch_cas_macro_ep", "ch_cas_macro", "ch_cas_macro_bwd")
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
