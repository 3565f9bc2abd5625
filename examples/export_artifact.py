#!/usr/bin/env python
"""Build and run AOT solve artifacts (the deployment workflow).

Build host (any machine, CPU is fine):
    python export_artifact.py build --env pendulum --batch 1024 \
        --target cuda --out solve.bin
Serving host (loads WITHOUT the config/model code paths below):
    python export_artifact.py run solve.bin --reps 20

The artifact bakes config + cost + dynamics + bounds + batch shape
(`diffmpc_tpu.aot.export_solve`); `--target cuda` cross-lowers the fused
Pallas program from a CPU build host. `--warm-start` adds the u_init
runtime input (receding-horizon serving); `--params-input` leaves the
dynamics parameters as a runtime input (serve learned models without
re-exporting).
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

import common  # noqa: F401,E402 — sys.path bootstrap (run from a clean shell)
from diffmpc_tpu import MPCConfig, QuadCost
from diffmpc_tpu.aot import export_solve, load_solve
from diffmpc_tpu.models import (
    AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx,
)

from common import (
    random_acrobot_x_init,
    random_cartpole_x_init,
    random_pendulum_x_init,
    random_vehicle_x_init,
)


def random_quadrotor_x_init(B, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
                  rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                  rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B)],
                 -1), dtype)


# name -> (cls, n, m, (lo, hi) scalars or per-dim lists, x_init generator)
ENVS = {
    "pendulum": (PendulumDx, 3, 1, (-2.0, 2.0), random_pendulum_x_init),
    "cartpole": (CartpoleDx, 5, 1, (-10.0, 10.0), random_cartpole_x_init),
    "quadrotor": (QuadrotorDx, 6, 2, (0.0, 5.0), random_quadrotor_x_init),
    "acrobot": (AcrobotDx, 6, 1, (-4.0, 4.0), random_acrobot_x_init),
    "vehicle": (
        VehicleDx, 4, 2,
        ([-6.0, -0.5], [3.0, 0.5]),  # asymmetric mixed box
        random_vehicle_x_init,
    ),
}


def build(args):
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    cls, n, m, (lo, hi), _ = ENVS[args.env]
    if isinstance(lo, list):
        lo = jnp.asarray(lo, jnp.float32)
        hi = jnp.asarray(hi, jnp.float32)
    dx = cls.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=n, n_ctrl=m, T=args.horizon, lqr_iter=args.lqr_iter,
        eps=1e-5, exit_unconverged=False, detach_unconverged=False,
        dtype=jnp.float32,
    )
    t0 = time.time()
    blob = export_solve(
        config, cost, dx, B=args.batch, u_lower=lo, u_upper=hi,
        warm_start=args.warm_start, params_input=args.params_input,
        vjp_order=args.vjp_order,
        platforms=[args.target] if args.target else None,
    )
    with open(args.out, "wb") as f:
        f.write(blob)
    print(
        f"wrote {args.out}: {len(blob)/1e6:.3f} MB in {time.time()-t0:.1f}s "
        f"(env={args.env} B={args.batch} T={args.horizon} "
        f"target={args.target or jax.default_backend()} "
        f"warm_start={args.warm_start} params_input={args.params_input})"
    )


def inspect_artifact(args):
    """Print the embedded manifest WITHOUT deserializing the program —
    the fleet-side validation step."""
    import json

    from diffmpc_tpu.aot import read_manifest

    m = read_manifest(open(args.artifact, "rb").read())
    if m is None:
        raise SystemExit(
            "pre-manifest artifact (raw jax.export payload): no embedded "
            "self-description; rebuild with this library version"
        )
    print(json.dumps(m, indent=2, sort_keys=True))


def run(args):
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    solve = load_solve(open(args.artifact, "rb").read())
    exp = solve.exported
    names = (
        solve.manifest["input_names"]
        if solve.manifest is not None
        else [f"arg{i}" for i in range(len(exp.in_avals))]
    )
    print(
        f"artifact platforms={exp.platforms} nr_devices={exp.nr_devices} "
        f"inputs={names} shapes={[str(a.shape) for a in exp.in_avals]}"
    )
    x_aval = exp.in_avals[0]
    B, n = x_aval.shape
    # Input generation only — the solve itself is entirely inside the
    # artifact. The manifest's dynamics class name picks the generator
    # (n_state alone is ambiguous: quadrotor and acrobot are both n=6);
    # pre-manifest blobs fall back to the n_state map where unambiguous.
    by_name = {
        "PendulumDx": random_pendulum_x_init,
        "CartpoleDx": random_cartpole_x_init,
        "QuadrotorDx": random_quadrotor_x_init,
        "AcrobotDx": random_acrobot_x_init,
        "VehicleDx": random_vehicle_x_init,
    }
    gen = None
    if solve.manifest is not None:
        gen = by_name.get(solve.manifest.get("dynamics", ""))
    if gen is None:
        gen = {3: random_pendulum_x_init, 4: random_vehicle_x_init,
               5: random_cartpole_x_init}.get(n)
    if gen is None:
        raise SystemExit(f"no input generator for n_state={n}")
    x = gen(B, args.seed, jnp.float32)
    inputs = [x]
    for aval in exp.in_avals[1:]:
        if aval.ndim == 3:  # warm-start u_init (T, B, m): cold start
            inputs.append(jnp.zeros(aval.shape, jnp.float32))
        else:  # dynamics params — cannot be guessed (zeros = zero masses)
            if args.params is None:
                raise SystemExit(
                    "artifact was built with --params-input: pass "
                    f"--params v1,v2,... matching shape {aval.shape}"
                )
            vals = jnp.asarray(
                [float(v) for v in args.params.split(",")], jnp.float32
            )
            inputs.append(jnp.broadcast_to(vals, aval.shape))
    t0 = time.time()
    sol = jax.block_until_ready(solve(*inputs))
    print(f"first call {time.time()-t0:.1f}s; mean obj "
          f"{float(jnp.mean(sol.objs)):.4f}, converged "
          f"{float(jnp.mean(sol.info.converged)):.2f}")
    t0 = time.time()
    for _ in range(args.reps):
        r = solve(*inputs)
    jax.block_until_ready(r)
    dt = (time.time() - t0) / args.reps
    print(f"{dt*1e3:.2f} ms/batch ({B/dt:,.0f} solves/s incl. dispatch)")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="export an artifact")
    b.add_argument("--env", choices=sorted(ENVS), default="pendulum")
    b.add_argument("--batch", type=int, default=1024)
    b.add_argument("--horizon", type=int, default=20)
    b.add_argument("--lqr-iter", type=int, default=10)
    b.add_argument("--target", default=None,
                   help="lowering platform (e.g. cuda); default = current")
    b.add_argument("--warm-start", action="store_true")
    b.add_argument("--params-input", action="store_true")
    b.add_argument("--vjp-order", type=int, default=0)
    b.add_argument("--cpu", action="store_true")
    b.add_argument("--out", default="solve.bin")
    b.set_defaults(fn=build)
    i = sub.add_parser(
        "inspect", help="print the embedded manifest (no deserialize)"
    )
    i.add_argument("artifact")
    i.set_defaults(fn=inspect_artifact)
    r = sub.add_parser("run", help="load + benchmark an artifact")
    r.add_argument("artifact")
    r.add_argument("--reps", type=int, default=20)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument(
        "--params", default=None,
        help="comma-separated dynamics params for --params-input artifacts",
    )
    r.add_argument("--cpu", action="store_true")
    r.set_defaults(fn=run)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
