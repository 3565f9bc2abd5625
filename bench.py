"""Benchmark: batched pendulum MPC solves/s on one device.

Prints ONE JSON line
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}`` and writes
secondary rows to ``BENCH_DETAILS.json``.
Target (BASELINE.md): >= 10,000 pendulum MPC solves/s at T=20, B=1024
(full iLQR solve with box constraints and learned-dynamics-compatible path).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_SOLVES_PER_S = 10_000.0
# Soft wall-clock budget for the secondary metrics below (each one costs a
# compile); whatever does not fit is skipped, never the primary line.
# Blocks run in value order: the 65k ensemble and the quadrotor come before
# the informational rows (cartpole, long-horizon, NN).
SECONDARY_BUDGET_S = 600.0



def best_of(loops, fn_timed):
    """Run the timing closure `loops` times, return the minimum duration."""
    dt = float("inf")
    for _ in range(loops):
        dt = min(dt, fn_timed())
    return dt

def main():
    t_start = time.perf_counter()
    from diffmpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from diffmpc_tpu import mpc_solve
    from __graft_entry__ import _pendulum_setup, _x_init

    B, T = 1024, 20
    config, cost, dx = _pendulum_setup(T=T)

    @jax.jit
    def solve(x_init):
        sol = mpc_solve(
            config, x_init, cost, dx, u_lower=-2.0, u_upper=2.0
        )
        return sol.us, sol.objs, sol.info.converged

    # Distinct problem sets so no solve is trivially cached. They are
    # solved sequentially ON DEVICE under one dispatch (lax.map) so the
    # measurement reflects device throughput, not host dispatch cost.
    n_sets = 8
    xs_stack = jnp.stack([_x_init(B, seed=s) for s in range(n_sets)])

    @jax.jit
    def solve_many(xs):
        return jax.lax.map(solve, xs)

    us, objs, conv = jax.block_until_ready(solve_many(xs_stack))

    n_timed = 4  # dispatches of n_sets solves each

    def _t_primary():
        t0 = time.perf_counter()
        out = None
        for _ in range(n_timed):
            out = solve_many(xs_stack)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    solves_per_s = n_timed * n_sets * B / best_of(12, _t_primary)
    objs, conv = objs[0], conv[0]

    # Warm-start throughput (the receding-horizon deployment pattern) is
    # part of the headline line: throughput next to convergence and the
    # deployment-pattern figure, so it cannot silently trade one for the
    # other. Budget-guarded: one extra compile.
    warm_start_solves_per_s = None
    try:
        if time.perf_counter() - t_start < 420.0:
            u_warm = jnp.roll(us[0], -1, axis=0)

            @jax.jit
            def solve_warm_many(xs, u):
                def one(x):
                    sol = mpc_solve(
                        config, x, cost, dx, u_init=u,
                        u_lower=-2.0, u_upper=2.0,
                    )
                    return sol.objs
                return jax.lax.map(one, xs)

            jax.block_until_ready(solve_warm_many(xs_stack, u_warm))

            def _t_warm():
                t0 = time.perf_counter()
                for _ in range(n_timed):
                    r = solve_warm_many(xs_stack, u_warm)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            warm_start_solves_per_s = round(
                n_timed * n_sets * B / best_of(8, _t_warm), 1
            )
    except Exception:  # pragma: no cover - never block the primary line
        pass

    # The JSON line goes out FIRST: the secondary metrics below trigger
    # additional compiles and must not be able to swallow the primary
    # result if the run is timed out.
    print(
        json.dumps(
            {
                "metric": "pendulum_mpc_solves_per_s_per_chip_T20_B1024",
                "value": round(solves_per_s, 1),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 3),
                "converged_frac": round(float(jnp.mean(conv)), 4),
                "warm_start_solves_per_s": warm_start_solves_per_s,
            }
        )
    )
    import sys

    sys.stdout.flush()

    # secondary tracked metrics (end-to-end training-step throughput) —
    # written to a side file; stdout stays one JSON line.
    details = {
        "solves_per_s": round(solves_per_s, 1),
        "mean_obj": float(jnp.mean(objs)),
        "converged_frac": float(jnp.mean(conv)),
    }
    if warm_start_solves_per_s is not None:
        details["warm_start_solves_per_s"] = warm_start_solves_per_s
    try:
        def train_loss(params, x):
            from diffmpc_tpu import mpc_solve

            sol = mpc_solve(
                config, x, cost, dx.replace(params=params), u_lower=-2.0, u_upper=2.0
            )
            return jnp.mean(sol.us**2)

        @jax.jit
        def grads_many(params, xs_all):
            return jax.lax.map(lambda x: jax.grad(train_loss)(params, x), xs_all)

        jax.block_until_ready(grads_many(dx.params, xs_stack))

        # Forward and solve+grad are timed in strict alternation with
        # per-variant minima, so drift between two separate loops cannot
        # masquerade as backward cost.
        t_f = t_g = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(3):
                rf = solve_many(xs_stack)
            jax.block_until_ready(rf)
            t_f = min(t_f, time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(3):
                rg = grads_many(dx.params, xs_stack)
            jax.block_until_ready(rg)
            t_g = min(t_g, time.perf_counter() - t0)
        details["solve_plus_grad_per_s"] = round(3 * n_sets * B / t_g, 1)
        details["fwd_interleaved_per_s"] = round(3 * n_sets * B / t_f, 1)
        details["grad_vs_fwd_frac"] = round(t_f / t_g, 4)
    except Exception as e:  # pragma: no cover - secondary metrics best-effort
        details["secondary_error"] = repr(e)

    def flush():
        # incremental: a kill or budget cut must never lose the blocks
        # already measured
        with open("BENCH_DETAILS.json", "w") as fh:
            json.dump(details, fh, indent=1)

    flush()

    def budget_left():
        flush()
        return time.perf_counter() - t_start < SECONDARY_BUDGET_S

    # ------------------------------------------------------------------
    # Priority 1: eval-config-5 shape (BASELINE.md row 3): one
    # 65,536-scenario ensemble dispatch, so a regression at the scale shape
    # cannot hide behind the B=1024 headline. Forward and solve+grad.
    # ------------------------------------------------------------------
    try:
        if budget_left():
            B_ens = 65_536
            x_ens = _x_init(B_ens, seed=21)

            @jax.jit
            def solve_ens(x):
                sol = mpc_solve(
                    config, x, cost, dx, u_lower=-2.0, u_upper=2.0
                )
                return sol.objs

            jax.block_until_ready(solve_ens(x_ens))

            def _t_ens():
                t0 = time.perf_counter()
                for _ in range(3):
                    r = solve_ens(x_ens)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            details["ensemble_solves_per_s_B65536"] = round(
                3 * B_ens / best_of(3, _t_ens), 1
            )

            def ens_loss(params, x):
                sol = mpc_solve(
                    config, x, cost, dx.replace(params=params),
                    u_lower=-2.0, u_upper=2.0,
                )
                return jnp.mean(sol.us**2)

            grad_ens = jax.jit(jax.grad(ens_loss))
            jax.block_until_ready(grad_ens(dx.params, x_ens))

            def _t_ens_g():
                t0 = time.perf_counter()
                for _ in range(3):
                    r = grad_ens(dx.params, x_ens)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            details["ensemble_solve_plus_grad_per_s_B65536"] = round(
                3 * B_ens / best_of(3, _t_ens_g), 1
            )
    except Exception as e:  # pragma: no cover
        details["ensemble_error"] = repr(e)

    # ------------------------------------------------------------------
    # Priority 2: quadrotor (n=6, m=2): multi-control box-DDP on real
    # dynamics — the in-kernel m=2 pnqp (active-set enumeration) / masked
    # 2x2 Cholesky path under load.
    # ------------------------------------------------------------------
    try:
        if budget_left():
            from diffmpc_tpu import MPCConfig, QuadCost
            from diffmpc_tpu.models import QuadrotorDx

            qd = QuadrotorDx.default(jnp.float32)
            qq, pq = qd.get_true_obj()
            cost_qd = QuadCost(jnp.diag(qq), pq)
            config_qd = MPCConfig(
                n_state=6, n_ctrl=2, T=20, lqr_iter=10, eps=1e-5,
                exit_unconverged=False, detach_unconverged=False,
            )
            Bq = 1024
            rngq = np.random.default_rng(5)
            xq = jnp.asarray(
                np.stack(
                    [rngq.uniform(-0.5, 0.5, Bq), rngq.uniform(-0.5, 0.5, Bq),
                     rngq.uniform(-0.2, 0.2, Bq), 0 * np.ones(Bq),
                     0 * np.ones(Bq), 0 * np.ones(Bq)], -1,
                ),
                jnp.float32,
            )

            @jax.jit
            def solve_qd(x):
                sol = mpc_solve(
                    config_qd, x, cost_qd, qd,
                    u_lower=0.0, u_upper=qd.max_thrust,
                )
                return sol.objs

            jax.block_until_ready(solve_qd(xq))

            def _t_qd():
                t0 = time.perf_counter()
                for _ in range(8):
                    r = solve_qd(xq)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            details["quadrotor_solves_per_s_T20_B1024"] = round(
                8 * Bq / best_of(3, _t_qd), 1
            )
    except Exception as e:  # pragma: no cover
        details["quadrotor_error"] = repr(e)

    # ------------------------------------------------------------------
    # Informational rows (dropped first under budget pressure).
    # ------------------------------------------------------------------

    # Cartpole (eval-config-4 shape): n=5 fused solve at B=4096.
    try:
        if budget_left():
            from diffmpc_tpu import MPCConfig, QuadCost
            from diffmpc_tpu.models import CartpoleDx

            cp = CartpoleDx.default(jnp.float32)
            qc_, pc_ = cp.get_true_obj()
            cost_cp = QuadCost(jnp.diag(qc_), pc_)
            config_cp = MPCConfig(
                n_state=5, n_ctrl=1, T=20, lqr_iter=10, eps=1e-5,
                exit_unconverged=False, detach_unconverged=False,
            )
            Bc = 4096
            rngc = np.random.default_rng(3)
            thc = rngc.uniform(-0.3, 0.3, Bc)
            xc = jnp.asarray(
                np.stack([rngc.uniform(-0.5, 0.5, Bc), 0 * thc,
                          np.cos(thc), np.sin(thc),
                          rngc.uniform(-0.5, 0.5, Bc)], -1), jnp.float32)

            @jax.jit
            def solve_cp(x):
                sol = mpc_solve(
                    config_cp, x, cost_cp, cp, u_lower=-10.0, u_upper=10.0
                )
                return sol.objs

            jax.block_until_ready(solve_cp(xc))

            def _t_cp():
                t0 = time.perf_counter()
                for _ in range(8):
                    r = solve_cp(xc)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            details["cartpole_solves_per_s_T20_B4096"] = round(
                8 * Bc / best_of(3, _t_cp), 1
            )
    except Exception as e:  # pragma: no cover
        details["cartpole_error"] = repr(e)

    # Long horizon (T=128).
    try:
        if budget_left():
            config_lh, cost_lh, dx_lh = _pendulum_setup(T=128)
            x_lh = _x_init(B, seed=11)

            @jax.jit
            def solve_lh(x):
                sol = mpc_solve(
                    config_lh, x, cost_lh, dx_lh, u_lower=-2.0, u_upper=2.0
                )
                return sol.objs

            jax.block_until_ready(solve_lh(x_lh))

            def _t_lh():
                t0 = time.perf_counter()
                for _ in range(5):
                    r = solve_lh(x_lh)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            dt_lh = best_of(3, _t_lh) / 5
            details["long_horizon_T128_B1024_ms"] = round(dt_lh * 1e3, 2)
            details["long_horizon_T128_solves_per_s"] = round(B / dt_lh, 1)
    except Exception as e:  # pragma: no cover
        details["long_horizon_error"] = repr(e)

    # Vehicle (kinematic bicycle, n=4, m=2): the industrial lane-keeping
    # shape with an asymmetric mixed box through the m=2 enumeration
    # (round 5, fifth env family).
    try:
        if budget_left():
            from diffmpc_tpu import MPCConfig, QuadCost
            from diffmpc_tpu.models import VehicleDx

            vd = VehicleDx.default(jnp.float32)
            qv, pv = vd.get_true_obj()
            cost_vd = QuadCost(jnp.diag(qv), pv)
            config_vd = MPCConfig(
                n_state=4, n_ctrl=2, T=20, lqr_iter=10, eps=1e-5,
                exit_unconverged=False, detach_unconverged=False,
            )
            lo_vd = jnp.asarray([-vd.max_brake, -vd.max_steer], jnp.float32)
            hi_vd = jnp.asarray([vd.max_accel, vd.max_steer], jnp.float32)
            rngv = np.random.default_rng(9)
            Bv = 1024
            xv = jnp.asarray(
                np.stack(
                    [np.zeros(Bv), rngv.uniform(-1, 1, Bv),
                     rngv.uniform(-0.3, 0.3, Bv), rngv.uniform(3, 7, Bv)],
                    -1,
                ),
                jnp.float32,
            )

            @jax.jit
            def solve_vd(x):
                sol = mpc_solve(
                    config_vd, x, cost_vd, vd, u_lower=lo_vd, u_upper=hi_vd
                )
                return jnp.sum(sol.objs)

            float(solve_vd(xv))

            def _t_vd():
                t0 = time.perf_counter()
                for _ in range(8):
                    r = solve_vd(xv)
                float(r)  # guaranteed drain
                return time.perf_counter() - t0

            details["vehicle_solves_per_s_T20_B1024"] = round(
                8 * Bv / best_of(3, _t_vd), 1
            )
    except Exception as e:  # pragma: no cover
        details["vehicle_error"] = repr(e)

    # Long horizon (T=512): the far end of the ~20-1000 horizon axis.
    try:
        if budget_left():
            config_l2, cost_l2, dx_l2 = _pendulum_setup(T=512)
            x_l2 = _x_init(B, seed=13)

            @jax.jit
            def solve_l2(x):
                sol = mpc_solve(
                    config_l2, x, cost_l2, dx_l2, u_lower=-2.0, u_upper=2.0
                )
                return sol.objs

            jax.block_until_ready(solve_l2(x_l2))

            def _t_l2():
                t0 = time.perf_counter()
                for _ in range(3):
                    r = solve_l2(x_l2)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            dt_l2 = best_of(3, _t_l2) / 3
            details["long_horizon_T512_B1024_ms"] = round(dt_l2 * 1e3, 2)
            details["long_horizon_T512_solves_per_s"] = round(B / dt_l2, 1)
    except Exception as e:  # pragma: no cover
        details["long_horizon_T512_error"] = repr(e)

    # Learned NN dynamics (SURVEY §3.5 imitation shape) on the fused path.
    try:
        if budget_left():
            from diffmpc_tpu.models import NNDynamics

            nn = NNDynamics.init(
                jax.random.PRNGKey(0), 3, 1, hidden=(16, 16), residual=True
            )
            assert nn.kernel_fusable
            import dataclasses as _dc

            config_nn = _dc.replace(config, T=15, lqr_iter=8)
            x_nn = _x_init(B, seed=7)

            @jax.jit
            def solve_nn(x):
                sol = mpc_solve(config_nn, x, cost, nn, u_lower=-2.0, u_upper=2.0)
                return sol.objs

            jax.block_until_ready(solve_nn(x_nn))

            def _t_nn():
                t0 = time.perf_counter()
                for _ in range(8):
                    r = solve_nn(x_nn)
                jax.block_until_ready(r)
                return time.perf_counter() - t0

            details["nn_dynamics_solves_per_s_T15_B1024"] = round(
                8 * B / best_of(3, _t_nn), 1
            )
    except Exception as e:  # pragma: no cover
        details["nn_dynamics_error"] = repr(e)

    flush()


if __name__ == "__main__":
    main()
