"""Worker process for tests/test_multiprocess.py — one of two localhost
processes forming a real JAX process group (SURVEY.md §5.8), so that
``distributed.initialize()`` + ``host_local_to_global()`` run with
``process_count > 1``.

Each worker owns 4 forced-host CPU devices (8 global), joins the group via
an explicit coordinator address, assembles its contiguous half of the
seeded global batch with ``host_local_to_global``, and runs ONE
data-parallel imitation train step. Process 0 prints the resulting scalars
and updated params as a JSON line for the parent test to compare against
the single-process 8-device reference.

Invoked as: python _mp_worker.py <coordinator_port> <process_id>
(env: JAX_PLATFORMS=cpu, XLA_FLAGS=--xla_force_host_platform_device_count=4)
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def seeded_problem(dtype, B=32, T=10):
    """The same seeded pendulum problem as tests/test_sharding.py's fixture
    (eps=0 fixed work: discrete branches far from ties, exact 1-vs-N
    agreement in f64)."""
    import numpy as np
    import jax.numpy as jnp

    from diffmpc_tpu import MPCConfig, QuadCost
    from diffmpc_tpu.models import PendulumDx

    dx = PendulumDx.default(dtype)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=6, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, dtype=dtype,
    )
    rng = np.random.default_rng(50)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1, 1, B)
    x_init = np.stack([np.cos(th), np.sin(th), thdot], -1).astype(dtype)
    return config, cost, dx, x_init


def main():
    port, pid = sys.argv[1], int(sys.argv[2])

    from diffmpc_tpu.parallel import distributed

    idx = distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=pid,
    )
    assert idx == pid, (idx, pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.local_devices()) == 4, jax.local_devices()
    assert jax.device_count() == 8, jax.device_count()

    import numpy as np
    import jax.numpy as jnp
    import optax

    from diffmpc_tpu.parallel import (
        init_train_state, make_dp_train_step, make_mesh,
    )

    dtype = jnp.float64
    config, cost, dx, x_init = seeded_problem(dtype)
    B, T = x_init.shape[0], config.T
    u_expert = np.zeros((T, B, 1), dtype)

    mesh = make_mesh()  # 1-D mesh over all 8 global devices
    # This process's contiguous half of the global batch: the mesh orders
    # devices process-0-first, so process p's addressable shards are global
    # rows [p*B/2, (p+1)*B/2).
    half = B // 2
    x_local = x_init[pid * half:(pid + 1) * half]
    u_local = u_expert[:, pid * half:(pid + 1) * half]
    x_g = distributed.host_local_to_global(mesh, x_local, batch_dim=0)
    u_g = distributed.host_local_to_global(mesh, u_local, batch_dim=1)
    assert x_g.shape == (B, 3), x_g.shape
    assert u_g.shape == (T, B, 1), u_g.shape

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    step = make_dp_train_step(config, make_problem, opt, mesh, -2.0, 2.0)
    state, stats = step(init_train_state(dx.params, opt), x_g, u_g)

    out = {
        "loss": float(stats.loss),
        "grad_norm": float(stats.grad_norm),
        "converged_frac": float(stats.converged_frac),
        "params": np.asarray(state.params).tolist(),
    }
    if pid == 0:
        print("MP_RESULT " + json.dumps(out), flush=True)
    # Orderly teardown: both processes reach here before the coordinator
    # (process 0) exits.
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
