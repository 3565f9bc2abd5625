"""Examples must run from a clean shell: no
installed package, no exported PYTHONPATH — ``common``'s sys.path bootstrap
makes ``diffmpc_tpu`` importable from the repo checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

ALL_EXAMPLES = [
    "export_artifact.py",
    "gen_expert_data.py",
    "il_acrobot.py",
    "il_cartpole.py",
    "il_nn_dynamics.py",
    "il_pendulum.py",
    "il_quadrotor.py",
    "il_vehicle.py",
    "receding_mpc.py",
    "render_trajectory.py",
    "sysid_domain_rand.py",
]


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the clean-shell condition under test
    return env


@pytest.mark.parametrize("script", ALL_EXAMPLES)
def test_example_imports_without_pythonpath(script):
    """--help exercises the full import block (the r2 failure mode was
    ModuleNotFoundError at import time) without running a solve."""
    res = subprocess.run(
        [sys.executable, script, "--help"],
        cwd=EXAMPLES,
        env=_clean_env(),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, (
        f"{script} --help failed from a clean shell:\n{res.stderr[-2000:]}"
    )


def test_il_pendulum_runs_end_to_end_without_pythonpath(tmp_path):
    res = subprocess.run(
        [
            sys.executable, "il_pendulum.py", "--cpu", "--batch", "8",
            "--horizon", "6", "--steps", "1", "--lqr-iter", "3",
            "--ckpt-every", "0", "--out", str(tmp_path / "out"),
        ],
        cwd=EXAMPLES,
        env=_clean_env(),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "final params" in res.stdout


def test_receding_mpc_runs_end_to_end_without_pythonpath(tmp_path):
    """The deployment-pattern CLI: closed-loop episode compiles and reports
    the summary row (success_frac etc.), including under plant-vs-model
    parameter mismatch and the slew penalty (the two knobs that only
    matter in this pattern)."""
    res = subprocess.run(
        [
            sys.executable, "receding_mpc.py", "--cpu", "--batch", "8",
            "--horizon", "8", "--env-steps", "10", "--lqr-iter", "4",
            "--plant-param-error", "0.1", "--slew", "1e-2",
            "--out", str(tmp_path / "receding.csv"),
        ],
        cwd=EXAMPLES,
        env=_clean_env(),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "success_frac" in res.stdout
    assert (tmp_path / "receding.csv").exists()


def test_export_artifact_build_then_run_without_pythonpath(tmp_path):
    """The deployment workflow CLI: build writes a loadable artifact, run
    loads it blind (no env/config flags) and solves."""
    art = str(tmp_path / "solve.bin")
    res = subprocess.run(
        [
            sys.executable, "export_artifact.py", "build", "--cpu",
            "--env", "pendulum", "--batch", "8", "--horizon", "6",
            "--lqr-iter", "3", "--warm-start", "--out", art,
        ],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    res = subprocess.run(
        [sys.executable, "export_artifact.py", "run", art, "--cpu",
         "--reps", "2"],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "solves/s" in res.stdout


def test_export_artifact_vehicle_zoo_coverage(tmp_path):
    """Round-5 CLI additions: the per-dim asymmetric-bounds branch (build)
    and the manifest-dynamics-name generator selection (run) — the
    pendulum test above exercises neither."""
    art = str(tmp_path / "veh.bin")
    res = subprocess.run(
        [
            sys.executable, "export_artifact.py", "build", "--cpu",
            "--env", "vehicle", "--batch", "8", "--horizon", "6",
            "--lqr-iter", "2", "--out", art,
        ],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    res = subprocess.run(
        [sys.executable, "export_artifact.py", "run", art, "--cpu",
         "--reps", "2"],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "solves/s" in res.stdout
    res = subprocess.run(
        [sys.executable, "export_artifact.py", "inspect", art],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert '"dynamics": "VehicleDx"' in res.stdout
    assert '"u_lower"' in res.stdout  # per-dim bounds recorded


def test_il_acrobot_runs_end_to_end_without_pythonpath(tmp_path):
    """The fourth env's IL driver: expert gen + one
    training step through the KKT backward on the configuration-dependent
    mass matrix, from a clean shell."""
    res = subprocess.run(
        [
            sys.executable, "il_acrobot.py", "--cpu", "--batch", "8",
            "--horizon", "6", "--steps", "1", "--lqr-iter", "3",
            "--ckpt-every", "0", "--out", str(tmp_path / "out"),
        ],
        cwd=EXAMPLES,
        env=_clean_env(),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "final params" in res.stdout
    assert (tmp_path / "out" / "train.csv").exists()


def test_il_vehicle_runs_end_to_end_without_pythonpath(tmp_path):
    """The fifth env's IL driver (round 5): expert gen + one training
    step with the asymmetric mixed box, from a clean shell."""
    res = subprocess.run(
        [
            sys.executable, "il_vehicle.py", "--cpu", "--batch", "8",
            "--horizon", "6", "--steps", "1", "--lqr-iter", "3",
            "--ckpt-every", "0", "--out", str(tmp_path / "out"),
        ],
        cwd=EXAMPLES,
        env=_clean_env(),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "final params" in res.stdout


def test_gen_expert_data_vehicle_without_pythonpath(tmp_path):
    """The env-choice CLI solves with the vehicle's per-dim asymmetric
    bounds (the other envs' scalar-bound path is covered above)."""
    out = str(tmp_path / "veh.npz")
    res = subprocess.run(
        [
            sys.executable, "gen_expert_data.py", "--cpu", "--env",
            "vehicle", "--batch", "4", "--horizon", "6", "--lqr-iter",
            "2", "--out", out,
        ],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.exists(out)


def test_gen_expert_data_acrobot_without_pythonpath(tmp_path):
    """The env-choice CLI actually solves with the newest env (the other
    envs get end-to-end coverage via their il_* runs above)."""
    out = str(tmp_path / "acro.npz")
    res = subprocess.run(
        [
            sys.executable, "gen_expert_data.py", "--cpu", "--env",
            "acrobot", "--batch", "4", "--horizon", "6", "--lqr-iter",
            "2", "--out", out,
        ],
        cwd=EXAMPLES, env=_clean_env(), capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.exists(out)
