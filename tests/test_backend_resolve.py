"""The platform table: which solver path ``use_pallas=None`` takes.

``use_kernels`` resolves the platform from the devices IN the computation:
(1) an explicit platform hint (``make_dp_train_step`` passes its mesh's
device platform, ``export_solve`` its export target), (2) a CPU mesh in the
trace context (``shard_map``), and only then (3) the default backend. The
GPU runs the Triton kernels, the CPU the XLA path (kernels only in
interpret mode), anything else is an error. These tests emulate a GPU
default backend by monkeypatching ``jax.default_backend``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import PendulumDx
from diffmpc_tpu.ops import lqr_step as lqr_step_mod
from diffmpc_tpu.ops.lqr_step import solver_platform, use_kernels
from diffmpc_tpu.parallel import (
    init_train_state,
    make_dp_train_step,
    make_mesh,
    shard_batch,
)


@pytest.fixture
def gpu_default_backend(monkeypatch):
    """Emulate a process whose default backend is the GPU while the
    devices actually in use are the 8 virtual CPU devices."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    # lqr_step resolves through its own module-level ``jax`` import; patch
    # both lookups in case of future refactors.
    monkeypatch.setattr(lqr_step_mod.jax, "default_backend", lambda: "gpu")
    yield


def _problem(T=5, B=16, dtype=jnp.float32):
    dx = PendulumDx.default(dtype)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False, dtype=dtype,
    )
    rng = np.random.default_rng(7)
    th = rng.uniform(-np.pi, np.pi, B)
    x_init = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1), dtype
    )
    return config, cost, dx, x_init


def test_auto_platform_prefers_mesh_context(gpu_default_backend):
    assert solver_platform() == "gpu"  # no mesh in context -> default backend
    assert use_kernels(None) is True

    seen = []

    def body(x):
        seen.append((solver_platform(), use_kernels(None)))
        return x

    mesh = make_mesh(jax.devices("cpu")[:8])
    jax.eval_shape(
        jax.shard_map(body, mesh=mesh, in_specs=(P("batch"),), out_specs=P("batch")),
        jnp.zeros((8,), jnp.float32),
    )
    assert seen == [("cpu", False)], (
        "inside a CPU-mesh shard_map the abstract mesh must override the "
        f"GPU default backend; got {seen}"
    )


def test_auto_platform_hint_wins(gpu_default_backend):
    # the table, by hint
    assert use_kernels(None, platform_hint="cpu") is False
    assert use_kernels(None, interpret=True, platform_hint="cpu") is True
    assert use_kernels(None, platform_hint="gpu") is True
    assert use_kernels(None, platform_hint="cuda") is True
    # explicit use_pallas always wins on a supported platform
    assert use_kernels(False, platform_hint="gpu") is False
    assert use_kernels(True, platform_hint="cpu") is True


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_is_an_error(platform):
    """No quiet fallback: a platform outside the table raises, in auto
    mode and with an explicit choice alike."""
    for use_pallas in (None, True, False):
        with pytest.raises(ValueError, match="no solver path"):
            use_kernels(use_pallas, platform_hint=platform)


def test_cpu_mesh_solve_under_gpu_default(gpu_default_backend):
    """mpc_solve (use_pallas=None) compiled for a CPU mesh while the default
    backend reports the GPU must take the XLA path — a kernel dispatched
    into the CPU program would fail to lower."""
    config, cost, dx, x_init = _problem()
    mesh = make_mesh(jax.devices("cpu")[:8])

    def local(x):
        sol = mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
        return sol.us

    f = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P("batch"),), out_specs=P("batch"),
            check_vma=True,
        )
    )
    us = f(x_init)
    assert bool(jnp.all(jnp.isfinite(us)))


def test_dp_train_step_under_gpu_default(gpu_default_backend):
    """make_dp_train_step resolves from ITS mesh's device platform: on the
    CPU mesh it must pick the XLA path + check_vma=True and run."""
    config, cost, dx, x_init = _problem()
    T, B = config.T, x_init.shape[0]
    mesh = make_mesh(jax.devices("cpu")[:8])

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.adam(1e-3)
    step = make_dp_train_step(
        config, make_problem, opt, mesh, u_lower=-2.0, u_upper=2.0
    )
    state = init_train_state(dx.params, opt)
    x = shard_batch(mesh, x_init, batch_dim=0)
    u_expert = shard_batch(mesh, jnp.zeros((T, B, 1), jnp.float32), batch_dim=1)
    state, stats = step(state, x, u_expert)
    assert bool(jnp.isfinite(stats.loss))
