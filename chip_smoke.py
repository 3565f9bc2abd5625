#!/usr/bin/env python
"""Smoke test of the solver on an NVIDIA GPU: the quickest proof that the
system still starts on the card.

    python chip_smoke.py                # one card: phases (a)-(f)
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Every phase runs the normal entry points (``mpc_solve``, ``jax.grad``,
``make_dp_train_step``, the receding-horizon loop, the AOT artifact) with
the Pallas kernels compiled for the card, asserts that the compiled program
really calls them (``__gpu$xla.gpu.triton`` in its HLO), and compares the
result with the plain XLA path (``use_pallas=False``) under
``jax.default_matmul_precision("highest")``. Kernel-versus-XLA times (median
of warm, synchronized repetitions) are printed along the way. The last line
is one JSON object naming the device; the script exits non-zero, with no
such line, if there is no GPU or any phase fails.

Tolerances. Single steps (``lqr_iter=1``) are compared where they are well
conditioned: the pendulum headline (T=20) with objectives and controls
within 1e-4 absolute; the hanging-pendulum regulation at T=128 and T=512
with controls within 1e-4 and objectives within 1e-4 per 20 steps summed;
the NN dynamics from small starts within bounds set from chip readings.
(A swing-up single step at T>=128 is not: the box clamps the controls along
a falling trajectory, and an f32 solve departs from an f64 one by the whole
box width on some scenarios on either path.) Full solves: scenarios are
compared only where both paths converged in the same number of
iterations, and every one of those within 1e-3 relative; the mean
objective within 1e-3 relative. Gradients (``lqr_iter=1``): within 1e-3
relative.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

TRITON_CALL = "__gpu$xla.gpu.triton"
# NN dynamics single step from small starts: f32 rounding differs between
# the paths, and each departs from an f64 solve by more than 1e-4 (H100:
# kernel 1.5e-3, XLA 3.6e-4 in controls); bounds ~3x the largest
# kernel-vs-XLA difference read on an H100 (1.2e-3 controls, 3.5e-3 objs)
NN_US_TOL, NN_OBJ_TOL = 3e-3, 1e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


class Smoke:
    """Checks and timings shared by the phases."""

    def __init__(self, jax, jnp, np):
        self.jax, self.jnp, self.np = jax, jnp, np

    def compile(self, fn, *args, kernel: bool):
        """jit, lower and compile ``fn``; assert the Triton kernel call is
        present exactly when ``kernel``. Returns the compiled callable."""
        t0 = time.perf_counter()
        compiled = self.jax.jit(fn).trace(*args).lower().compile()
        has = TRITON_CALL in compiled.as_text()
        if has != kernel:
            raise AssertionError(
                f"expected the Triton kernel call {'in' if kernel else 'not in'}"
                " the compiled program"
            )
        return compiled, time.perf_counter() - t0

    def time_ms(self, compiled, *args, reps=5):
        self.jax.block_until_ready(compiled(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            self.jax.block_until_ready(compiled(*args))
            ts.append(time.perf_counter() - t0)
        return float(self.np.median(ts)) * 1e3

    def versus(self, label, kern, ref, *args, reps=5):
        """Compile the kernel and XLA versions, time both, print one line,
        return both outputs."""
        ck, sk = self.compile(kern, *args, kernel=True)
        cr, sr = self.compile(ref, *args, kernel=False)
        tk = self.time_ms(ck, *args, reps=reps)
        tr = self.time_ms(cr, *args, reps=reps)
        print(
            f"  {label}: kernel {tk:.3f} ms, XLA {tr:.3f} ms "
            f"(compile {sk:.1f} s / {sr:.1f} s)",
            flush=True,
        )
        return ck(*args), cr(*args)

    def single_step(self, name, got, want, obj_tol=1e-4, us_tol=1e-4):
        np = self.np
        go, wo = np.asarray(got.objs), np.asarray(want.objs)
        d_obj = float(np.max(np.abs(go - wo)))
        d_us = float(np.max(np.abs(np.asarray(got.us) - np.asarray(want.us))))
        assert np.all(np.isfinite(go)), f"{name}: non-finite objectives"
        assert d_obj <= obj_tol, f"{name}: objectives differ by {d_obj:.2e}"
        assert d_us <= us_tol, f"{name}: controls differ by {d_us:.2e}"
        print(f"  {name}: objs {d_obj:.1e} abs, us {d_us:.1e} abs", flush=True)

    def full_solve(self, name, got, want):
        np = self.np
        go, wo = np.asarray(got.objs), np.asarray(want.objs)
        assert np.all(np.isfinite(go)), f"{name}: non-finite objectives"
        same = (
            np.asarray(got.info.converged) & np.asarray(want.info.converged)
            & (np.asarray(got.info.iters) == np.asarray(want.info.iters))
        )
        rel = np.abs(go - wo)[same] / np.maximum(1.0, np.abs(wo[same]))
        worst = float(rel.max()) if same.any() else 0.0
        d_mean = abs(go.mean() - wo.mean()) / max(1.0, abs(wo.mean()))
        assert worst <= 1e-3, (
            f"{name}: {int(np.sum(rel > 1e-3))} of the {int(same.sum())} "
            f"scenarios that converged alike differ (worst {worst:.2e} rel)"
        )
        assert d_mean <= 1e-3, f"{name}: mean objective differs {d_mean:.2e}"
        print(
            f"  {name}: {int(same.sum())} of {len(go)} converged on both in "
            f"the same iterations, worst {worst:.1e} rel; mean objective "
            f"{d_mean:.1e} rel",
            flush=True,
        )

    def grads(self, name, got, want):
        np = self.np
        g, w = np.asarray(got), np.asarray(want)
        rel = float(np.max(np.abs(g - w)) / max(1e-12, np.max(np.abs(w))))
        assert np.all(np.isfinite(g)), f"{name}: non-finite gradient"
        assert rel <= 1e-3, f"{name}: gradients differ by {rel:.2e} rel"
        print(f"  {name}: gradient {rel:.1e} rel", flush=True)


def problems(jnp, np):
    """The env configurations the phases solve (seeded initial states)."""
    import jax

    from diffmpc_tpu import MPCConfig, QuadCost
    from diffmpc_tpu.models import (
        AcrobotDx, CartpoleDx, NNDynamics, PendulumDx, QuadrotorDx, VehicleDx,
    )

    def cfg(n, m, T=20, lqr_iter=10):
        return MPCConfig(
            n_state=n, n_ctrl=m, T=T, lqr_iter=lqr_iter, eps=1e-5,
            exit_unconverged=False, detach_unconverged=False,
        )

    def quad(dx):
        q, p = dx.get_true_obj()
        return QuadCost(jnp.diag(q), p)

    def hang(dx):
        """Regulation around the hanging pendulum (a stable equilibrium)
        with the control weight raised to 0.1: the box clamps a few steps
        and no clamp rides an unstable trajectory, so a single step is well
        conditioned at any horizon."""
        q, _ = dx.get_true_obj()
        q = q.at[3].set(0.1)
        goal = jnp.asarray([-1.0, 0.0, 0.0, 0.0], jnp.float32)
        return QuadCost(jnp.diag(q), -q * goal)

    def uniform(seed, B, cols):
        rng = np.random.default_rng(seed)
        return rng, [rng.uniform(lo, hi, B) for lo, hi in cols]

    def pendulum_x(B, seed):
        _, (th, thdot) = uniform(seed, B, [(-np.pi, np.pi), (-1, 1)])
        return jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), jnp.float32)

    def hanging_x(B, seed):
        _, (th, thdot) = uniform(seed, B, [(np.pi - 0.5, np.pi + 0.5), (-0.5, 0.5)])
        return jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), jnp.float32)

    def small_x(B, seed):
        _, (th, thdot) = uniform(seed, B, [(-0.3, 0.3), (-0.3, 0.3)])
        return jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), jnp.float32)

    def cartpole_x(B, seed):
        _, (p, pd, th, thd) = uniform(
            seed, B, [(-0.5, 0.5), (-0.5, 0.5), (-0.3, 0.3), (-0.5, 0.5)]
        )
        return jnp.asarray(
            np.stack([p, pd, np.cos(th), np.sin(th), thd], -1), jnp.float32
        )

    def quadrotor_x(B, seed):
        _, (a, b, c) = uniform(seed, B, [(-0.5, 0.5), (-0.5, 0.5), (-0.2, 0.2)])
        z = np.zeros(B)
        return jnp.asarray(np.stack([a, b, c, z, z, z], -1), jnp.float32)

    def acrobot_x(B, seed):
        s = 0.05
        _, (t1, t2, w1, w2) = uniform(seed, B, [(-s, s)] * 4)
        return jnp.asarray(
            np.stack(
                [np.cos(t1), np.sin(t1), np.cos(t2), np.sin(t2), w1, w2], -1
            ),
            jnp.float32,
        )

    def vehicle_x(B, seed):
        _, (py, psi, v) = uniform(seed, B, [(-1, 1), (-0.3, 0.3), (3, 7)])
        return jnp.asarray(
            np.stack([np.zeros(B), py, psi, v], -1), jnp.float32
        )

    pend = PendulumDx.default(jnp.float32)
    cart = CartpoleDx.default(jnp.float32)
    quadr = QuadrotorDx.default(jnp.float32)
    acro = AcrobotDx.default(jnp.float32)
    veh = VehicleDx.default(jnp.float32)
    nn = NNDynamics.init(jax.random.PRNGKey(0), 3, 1, hidden=(16, 16), residual=True)
    return {
        "pendulum": (cfg(3, 1), quad(pend), pend, pendulum_x, -2.0, 2.0),
        "cartpole": (cfg(5, 1), quad(cart), cart, cartpole_x, -10.0, 10.0),
        "quadrotor": (cfg(6, 2), quad(quadr), quadr, quadrotor_x, 0.0, quadr.max_thrust),
        "acrobot": (cfg(6, 1), quad(acro), acro, acrobot_x, -acro.max_torque, acro.max_torque),
        "vehicle": (
            cfg(4, 2), quad(veh), veh, vehicle_x,
            jnp.asarray([-veh.max_brake, -veh.max_steer], jnp.float32),
            jnp.asarray([veh.max_accel, veh.max_steer], jnp.float32),
        ),
        "nn": (cfg(3, 1, T=15, lqr_iter=8), quad(pend), nn, pendulum_x, -2.0, 2.0),
        "nn small": (cfg(3, 1, T=15, lqr_iter=1), quad(pend), nn, small_x, -2.0, 2.0),
        "hanging": (cfg(3, 1), hang(pend), pend, hanging_x, -2.0, 2.0),
    }


def _solver(cfg, cost, dx, lo, hi, use_pallas):
    from diffmpc_tpu import mpc_solve

    c = dataclasses.replace(cfg, use_pallas=use_pallas)
    return lambda x: mpc_solve(c, x, cost, dx, u_lower=lo, u_upper=hi)


def phase_headline(sm: Smoke, P):
    """(a) __graft_entry__.entry()'s pendulum solve at T=20, B=1024."""
    jnp = sm.jnp
    from diffmpc_tpu import mpc_solve
    from __graft_entry__ import _pendulum_setup, entry

    fn, (x0, params) = entry()
    cfg, cost, dx = _pendulum_setup()
    ref_fn = lambda x, p: mpc_solve(  # noqa: E731
        dataclasses.replace(cfg, use_pallas=False), x, cost,
        dx.replace(params=p), u_lower=-2.0, u_upper=2.0,
    ).us
    us_k, us_r = sm.versus("entry() forward", fn, ref_fn, x0, params, reps=20)
    assert us_k.shape == (20, 1024, 1) and bool(jnp.all(jnp.isfinite(us_k)))
    k, r = sm.versus(
        "full solve", _solver(cfg, cost, dx, -2.0, 2.0, None),
        _solver(cfg, cost, dx, -2.0, 2.0, False), x0, reps=20,
    )
    sm.full_solve("pendulum T=20 full", k, r)
    c1 = dataclasses.replace(cfg, lqr_iter=1)
    k, r = sm.versus(
        "lqr_iter=1", _solver(c1, cost, dx, -2.0, 2.0, None),
        _solver(c1, cost, dx, -2.0, 2.0, False), x0,
    )
    sm.single_step("pendulum T=20 lqr_iter=1", k, r)
    x = P["pendulum"][3](65536, 12)
    k, r = sm.versus(
        "full solve B=65536", _solver(cfg, cost, dx, -2.0, 2.0, None),
        _solver(cfg, cost, dx, -2.0, 2.0, False), x,
    )
    sm.full_solve("pendulum T=20 B=65536 full", k, r)


def phase_envs(sm: Smoke, P):
    """(b) every env through mpc_solve against the XLA path."""
    cases = [
        ("cartpole", 4096, None), ("quadrotor", 1024, None),
        ("acrobot", 1024, None), ("vehicle", 1024, None), ("nn", 1024, None),
        ("pendulum", 1024, 128), ("pendulum", 1024, 512),
        ("hanging", 1024, 128), ("hanging", 1024, 512),
    ]
    for name, B, T in cases:
        cfg, cost, dx, make_x, lo, hi = P[name]
        if T is not None:
            cfg = dataclasses.replace(cfg, T=T)
        label = f"{name} T={cfg.T} B={B}"
        k, r = sm.versus(
            label, _solver(cfg, cost, dx, lo, hi, None),
            _solver(cfg, cost, dx, lo, hi, False), make_x(B, 11),
        )
        sm.full_solve(label, k, r)
    # single steps where they are well conditioned (module docstring); the
    # objective sums T per-step costs, so its bound is 1e-4 per 20 steps
    for name, T, tols in (
        ("hanging", 128, {}), ("hanging", 512, {}),
        ("nn small", 15, dict(obj_tol=NN_OBJ_TOL, us_tol=NN_US_TOL)),
    ):
        cfg, cost, dx, make_x, lo, hi = P[name]
        cfg = dataclasses.replace(cfg, T=T, lqr_iter=1)
        tols = dict(dict(obj_tol=1e-4 * T / 20), **tols)
        label = f"{name} T={T} lqr_iter=1"
        k, r = sm.versus(
            label, _solver(cfg, cost, dx, lo, hi, None),
            _solver(cfg, cost, dx, lo, hi, False), make_x(1024, 11),
        )
        sm.single_step(label, k, r, **tols)


def phase_gradient(sm: Smoke, P):
    """(c) jax.grad through the KKT kernel against the XLA backward."""
    jax, jnp = sm.jax, sm.jnp
    from diffmpc_tpu import mpc_solve

    cfg, cost, dx, make_x, lo, hi = P["pendulum"]

    def grad_fn(use_pallas, lqr_iter):
        c = dataclasses.replace(cfg, lqr_iter=lqr_iter, use_pallas=use_pallas)

        def loss(p, x):
            sol = mpc_solve(c, x, cost, dx.replace(params=p), u_lower=lo, u_upper=hi)
            return jnp.mean(sol.us**2)

        return lambda x, p: jax.grad(loss)(p, x)

    for B in (1024, 65536):
        x = make_x(B, 21)
        gk, gr = sm.versus(
            f"solve+grad lqr_iter=1 B={B}", grad_fn(None, 1), grad_fn(False, 1),
            x, dx.params,
        )
        sm.grads(f"B={B}", gk, gr)
        # the full solve's gradient depends on which fixed point each
        # chaotic scenario reaches, so it is timed and checked finite only
        gk, _ = sm.versus(
            f"solve+grad full B={B}", grad_fn(None, cfg.lqr_iter),
            grad_fn(False, cfg.lqr_iter), x, dx.params,
        )
        assert bool(jnp.all(jnp.isfinite(gk))), "non-finite full-solve gradient"


def phase_training(sm: Smoke, P):
    """(d) imitation-learning steps of make_dp_train_step on a one-card
    mesh: cartpole at B=4096."""
    jax, jnp, np = sm.jax, sm.jnp, sm.np
    import optax

    from diffmpc_tpu.parallel import (
        generate_expert_data, init_train_state, make_dp_train_step, make_mesh,
        shard_batch,
    )

    cfg, cost, dx, make_x, lo, hi = P["cartpole"]
    x = make_x(4096, 31)
    _, u_exp, _ = jax.jit(
        lambda x: generate_expert_data(cfg, cost, dx, x, lo, hi)
    )(x)
    mesh = make_mesh(jax.devices()[:1])
    opt = optax.adam(2e-2)
    step = make_dp_train_step(
        cfg, lambda p: (cost, dx.replace(params=p)), opt, mesh,
        u_lower=lo, u_upper=hi,
    )
    p0 = dx.params * jnp.asarray([1.2, 0.8, 1.25, 0.85], jnp.float32)
    state = init_train_state(p0, opt)
    xs, us = shard_batch(mesh, x, 0), shard_batch(mesh, u_exp, 1)
    compiled, secs = sm.compile(step, state, xs, us, kernel=True)
    losses = []
    for _ in range(5):
        state, stats = compiled(state, xs, us)
        losses.append(float(stats.loss))
    print(f"  losses {['%.6f' % v for v in losses]} (compile {secs:.1f} s)", flush=True)
    assert all(np.isfinite(losses)), "non-finite training loss"
    assert losses[-1] < losses[0], "training loss did not fall"


def phase_receding(sm: Smoke, P):
    """(e) a short receding-horizon episode, warm starts through the
    kernel."""
    jax, jnp = sm.jax, sm.jnp
    from diffmpc_tpu.receding import run_receding_horizon

    cfg, cost, dx, make_x, lo, hi = P["pendulum"]

    def episode(use_pallas):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        return lambda x: run_receding_horizon(c, x, cost, dx, 20, u_lower=lo, u_upper=hi)

    (_, us_k, objs_k), (_, _, objs_r) = sm.versus(
        "20-step episode", episode(None), episode(False), make_x(1024, 41), reps=3
    )
    assert bool(jnp.all(jnp.isfinite(objs_k))) and bool(jnp.all(jnp.abs(us_k) <= 2.0))
    # closed-loop cost of the whole episode: chaotic per scenario, close on
    # the mean
    ek, er = float(jnp.mean(objs_k)), float(jnp.mean(objs_r))
    assert abs(ek - er) <= 1e-2 * abs(er), f"episode cost {ek} vs {er}"
    print(f"  mean episode objective {ek:.4f} (XLA {er:.4f})", flush=True)


def phase_artifact(sm: Smoke, P):
    """(f) an AOT export, then load and run, against the live solve."""
    jax, jnp = sm.jax, sm.jnp
    from diffmpc_tpu.aot import export_solve, load_solve

    cfg, cost, dx, make_x, lo, hi = P["pendulum"]
    x = make_x(1024, 51)
    blob = export_solve(cfg, cost, dx, 1024, u_lower=lo, u_upper=hi)
    art = load_solve(blob)
    assert art.manifest["jax_version"] == jax.__version__
    got = art(x)
    live = jax.jit(_solver(cfg, cost, dx, lo, hi, None))(x)
    assert TRITON_CALL in jax.jit(art).lower(x).compile().as_text()
    d = float(jnp.max(jnp.abs(got.us - live.us)))
    assert d <= 1e-5, f"artifact diverges from the live solve by {d}"
    print(f"  {len(blob) / 1e3:.1f} kB artifact, controls within {d:.1e} of live", flush=True)


ONE_CARD_PHASES = [
    phase_headline, phase_envs, phase_gradient, phase_training,
    phase_receding, phase_artifact,
]


def one_card(sm: Smoke, phases=ONE_CARD_PHASES):
    P = problems(sm.jnp, sm.np)
    for phase in phases:
        print(" ".join(phase.__doc__.split()), flush=True)
        phase(sm, P)


def four_cards(sm: Smoke):
    jax, jnp, np = sm.jax, sm.jnp, sm.np
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from diffmpc_tpu import mpc_solve
    from diffmpc_tpu.aot import export_solve, load_solve, read_manifest
    from diffmpc_tpu.parallel import (
        generate_expert_data, init_train_state, make_dp_train_step, make_mesh,
        shard_batch,
    )
    from diffmpc_tpu.parallel.mesh import BATCH_AXIS
    from __graft_entry__ import _pendulum_setup, _x_init

    devices = jax.devices()
    assert len(devices) == 4, f"--four-cards needs 4 GPUs, found {len(devices)}"
    cfg, cost, dx = _pendulum_setup()
    mesh4 = make_mesh(devices)
    mesh1 = make_mesh(devices[:1])

    print("DP training step: 4-card mesh vs the same global batch on one card", flush=True)
    B = 4096
    x = _x_init(B, seed=61)
    _, u_exp, _ = jax.jit(
        lambda x: generate_expert_data(cfg, cost, dx, x, -2.0, 2.0)
    )(x)
    opt = optax.sgd(1.0)  # params move by the gradient (f32 rounding aside)
    p0 = dx.params * jnp.asarray([1.1, 0.9, 1.05], jnp.float32)
    out = {}
    for name, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
        step = make_dp_train_step(
            cfg, lambda p: (cost, dx.replace(params=p)), opt, mesh,
            u_lower=-2.0, u_upper=2.0,
        )
        xs, us = shard_batch(mesh, x, 0), shard_batch(mesh, u_exp, 1)
        state = init_train_state(p0, opt)
        compiled, secs = sm.compile(step, state, xs, us, kernel=True)
        new, stats = compiled(state, xs, us)
        grad = np.asarray(p0) - np.asarray(new.params)
        out[name] = (float(stats.loss), float(stats.grad_norm), grad)
        print(
            f"  {name}: loss {float(stats.loss):.6f} grad_norm "
            f"{float(stats.grad_norm):.6f} grad {grad} (compile {secs:.1f} s)",
            flush=True,
        )
    (l4, n4, g4), (l1, n1, g1) = out["4 cards"], out["1 card"]
    assert abs(l4 - l1) <= 1e-4 * abs(l1), f"loss {l4} vs {l1}"
    assert abs(n4 - n1) <= 1e-4 * abs(n1), f"grad_norm {n4} vs {n1}"
    # the gradient read back from p0 - p1 carries f32 rounding of p0
    slack = 1e-6 * float(np.max(np.abs(np.asarray(p0))))
    g_rel = float(np.max(np.abs(g4 - g1)) / np.max(np.abs(g1)))
    assert np.max(np.abs(g4 - g1)) <= 1e-4 * np.max(np.abs(g1)) + slack, (
        f"gradients differ by {g_rel:.2e} rel"
    )
    print(
        f"  loss {abs(l4 - l1) / abs(l1):.1e} rel, grad_norm "
        f"{abs(n4 - n1) / abs(n1):.1e} rel, gradient {g_rel:.1e} rel",
        flush=True,
    )

    print("shard_map fused solve at B=65536 vs unsharded", flush=True)
    B = 65536
    x = _x_init(B, seed=62)

    def local(xl):
        return mpc_solve(cfg, xl, cost, dx, u_lower=-2.0, u_upper=2.0).us

    sharded = jax.shard_map(
        local, mesh=mesh4, in_specs=(P(BATCH_AXIS),),
        out_specs=P(None, BATCH_AXIS), check_vma=False,
    )
    xs = jax.device_put(x, NamedSharding(mesh4, P(BATCH_AXIS)))
    cs, _ = sm.compile(sharded, xs, kernel=True)
    cu, _ = sm.compile(local, x, kernel=True)
    ts, tu = sm.time_ms(cs, xs), sm.time_ms(cu, x)
    us_s, us_u = np.asarray(cs(xs)), np.asarray(cu(x))
    print(f"  4 cards {ts:.3f} ms, 1 card {tu:.3f} ms", flush=True)
    assert np.array_equal(us_s, us_u), "sharded solve is not bitwise equal"
    print("  bitwise equal", flush=True)

    print("sharded artifact vs live", flush=True)
    blob = export_solve(cfg, cost, dx, B, u_lower=-2.0, u_upper=2.0, mesh=mesh4)
    assert read_manifest(blob)["mesh"]["form"] == "shard_map_fused"
    got = load_solve(blob)(xs)
    assert np.array_equal(np.asarray(got.us), us_s), "artifact diverges from live"
    print(f"  {len(blob) / 1e3:.1f} kB artifact, bitwise equal to live", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded paths, on four cards",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
            file=sys.stderr,
        )
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax.numpy as jnp
    import numpy as np

    from diffmpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        (four_cards if args.four_cards else one_card)(Smoke(jax, jnp, np))
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    d = jax.devices()[0]
    print(json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(jax.devices())}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
