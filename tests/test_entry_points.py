"""Entry points around the solver: compile-cache placement, the former
package name, the GPU-only refusals of `bench.py` and `chip_smoke.py`,
and chip_smoke's oracles."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _cache_dir_in_child(env):
    code = ("import abip, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env_set", "env_unset"])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set (the package sets no other);
    unset, the cache goes to one fixed directory inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        assert _cache_dir_in_child(env) == str(tmp_path / "cache")
    else:
        assert _cache_dir_in_child(env) == os.path.join(REPO, ".jax_cache")


FORMER_NAME = "abip_tpu"


def test_former_package_name_is_the_same_package():
    """The package's former name still imports, and each module under it
    is the `abip` module object itself (one copy, shared state)."""
    import importlib

    import abip
    import abip.parallel.batched

    assert importlib.import_module(FORMER_NAME) is abip
    sub = importlib.import_module(FORMER_NAME + ".parallel.batched")
    assert sub is abip.parallel.batched
    assert sub.__spec__.name == "abip.parallel.batched"


def test_former_package_name_in_fresh_process():
    """`from <former name>.<module> import ...` works in a process that
    never imported `abip` itself."""
    code = (f"from {FORMER_NAME}.ops.admm_delta import run_delta_chunk; "
            "import abip.ops.admm_delta as d; "
            "print(run_delta_chunk is d.run_delta_chunk)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True"


def test_bench_refuses_cpu_only_process(monkeypatch, capsys):
    """Without a GPU (and without the explicit CPU rehearsal) the bench
    exits non-zero and prints no result line."""
    import bench

    monkeypatch.delenv("ABIP_BENCH_CPU", raising=False)
    assert bench.main() == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_chip_smoke_refuses_cpu_only_process(monkeypatch, capsys):
    """Past a (faked) nvidia-smi, chip_smoke's device phase still refuses
    a process whose JAX runs on the CPU: exit 1, no final JSON line."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: ["fake GPU, 1 W"])
    monkeypatch.setattr(chip_smoke, "phase_gpu_tests", lambda: None)
    assert chip_smoke.main([]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert not any(ln.startswith('{"ok"') for ln in lines)
    assert json.loads(lines[-1])["phase"] == "device"


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repo exits
    non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cone_violation_oracle():
    """chip_smoke's independent cone check: SOC, RSOC (2 t1 t2 >= |z|^2),
    zero and nonneg blocks."""
    from abip import ConeSpec
    from chip_smoke import cone_violation

    cones = ConeSpec(soc=(3,), rsoc=(3,), zero=1, nonneg=2)
    inside = np.array([2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.5, 0.0])
    assert cone_violation(inside, cones) == 0.0
    soc_out = inside.copy()
    soc_out[0] = 1.0                       # |(1, 1)| > 1
    assert cone_violation(soc_out, cones) > 0.1
    rsoc_out = inside.copy()
    rsoc_out[5] = 2.0                      # 2*1*1 < 4
    assert cone_violation(rsoc_out, cones) > 0.1
    assert cone_violation(np.r_[inside[:6], 0.3, 0.5, 0.0], cones) > 0.0
    assert cone_violation(np.array([1.0, -0.5])) == pytest.approx(0.25)


def test_kkt_oracle_on_known_lp():
    """chip_smoke's KKT oracle is zero on an exact primal-dual optimum
    and sees a perturbed one."""
    from chip_smoke import kkt

    A = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]])
    x = np.array([1.0, 0.0, 2.0])
    y = np.array([1.0, 2.0])
    s = np.array([0.0, 1.0, 0.0])
    b, c = A @ x, A.T @ y + s
    k = kkt(A, b, c, x, y, s)
    assert max(k.values()) < 1e-15
    k_bad = kkt(A, b, c, x + [0.0, 0.1, 0.0], y, s)
    assert k_bad["pres"] > 1e-3 and k_bad["gap"] > 1e-3


@pytest.mark.parametrize("phase", ["lp_batch", "lp_scale", "conic"])
def test_chip_smoke_phase_small_on_cpu(phase):
    """chip_smoke's solve phases run end to end at a small size on the
    CPU (the same code the card runs at full size); a failed check
    raises PhaseFailed."""
    import chip_smoke

    run = {"lp_batch": lambda: chip_smoke.phase_lp_batch(B=2),
           "lp_scale": lambda: chip_smoke.phase_lp_scale(100, 1000),
           "conic": lambda: chip_smoke.phase_conic(B=1, scale=1)}
    run[phase]()
