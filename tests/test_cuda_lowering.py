"""The GPU kernel path lowers for CUDA from this CPU host.

The Triton route can be lowered without a card: ``lowering_platforms=
("cuda",)`` runs the whole Pallas-to-Triton-IR translation, so every
model's mega-kernel (forward) and KKT kernel (``jax.grad``) is checked to
lower, and to appear in the program as the Triton custom call. What only
the card can say (that Triton compiles the IR, and how fast it runs) is
``chip_smoke.py``'s job.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import (
    AcrobotDx,
    CartpoleDx,
    NNDynamics,
    PendulumDx,
    QuadrotorDx,
    VehicleDx,
)

TRITON_CALL = "__gpu$xla.gpu.triton"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def f32_lowering():
    """Lower with x64 off, as a build host does (the kernels are f32)."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _model(name, B):
    f32 = jnp.float32
    if name == "nn":
        dx = NNDynamics.init(jax.random.PRNGKey(0), 3, 1, hidden=(16, 16), residual=True)
        return dx, PendulumDx.default(f32).get_true_obj(), -2.0, 2.0
    if name == "batched_params":
        dx = PendulumDx.default(f32)
        scale = np.random.default_rng(0).uniform(0.9, 1.1, (B, 3))
        dxb = dx.replace(params=jnp.asarray(np.asarray(dx.params) * scale, f32))
        return dxb, dx.get_true_obj(), -2.0, 2.0
    dx = {
        "pendulum": PendulumDx, "cartpole": CartpoleDx,
        "quadrotor": QuadrotorDx, "acrobot": AcrobotDx, "vehicle": VehicleDx,
    }[name].default(f32)
    lo, hi = {
        "pendulum": (-2.0, 2.0), "cartpole": (-10.0, 10.0),
        "quadrotor": (0.0, 5.0), "acrobot": (-4.0, 4.0),
        "vehicle": (jnp.asarray([-6.0, -0.5], f32), jnp.asarray([3.0, 0.5], f32)),
    }[name]
    return dx, dx.get_true_obj(), lo, hi


@pytest.mark.parametrize("kind", ["forward", "grad"])
@pytest.mark.parametrize(
    "name",
    ["pendulum", "cartpole", "quadrotor", "acrobot", "vehicle", "nn",
     "batched_params"],
)
def test_lowers_for_cuda_with_triton_kernels(name, kind, f32_lowering):
    B, T = 64, 8
    dx, (q, p), lo, hi = _model(name, B)
    n = q.shape[0] - (2 if name in ("quadrotor", "vehicle") else 1)
    m = q.shape[0] - n
    config = MPCConfig(
        n_state=n, n_ctrl=m, T=T, lqr_iter=2, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False, use_pallas=True,
    )
    cost = QuadCost(jnp.diag(q), p)
    x = jnp.zeros((B, n), jnp.float32)
    params = dx.weights if name == "nn" else dx.params

    def solve(x, params):
        d = dx.replace(weights=params) if name == "nn" else dx.replace(params=params)
        return mpc_solve(config, x, cost, d, u_lower=lo, u_upper=hi)

    if kind == "forward":
        fn = lambda x, params: solve(x, params).us  # noqa: E731
    else:
        fn = jax.grad(
            lambda params, x: jnp.mean(solve(x, params).us ** 2)
        )
        fn = (lambda g: lambda x, params: g(params, x))(fn)
    text = (
        jax.jit(fn).trace(x, params).lower(lowering_platforms=("cuda",)).as_text()
    )
    # forward: the mega-kernel; grad: the mega-kernel and the KKT kernel
    assert text.count(TRITON_CALL) == (1 if kind == "forward" else 2)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_a_host_without_gpu(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line on a CPU-only
    host — run from the repo, and alone in a directory without the
    package."""
    src = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(src, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
