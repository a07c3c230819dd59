"""Test configuration: a virtual 8-device CPU mesh by default.

Sharding/collective tests need multiple devices, so the host platform
gets 8 virtual devices (SURVEY.md section 4).  The platform comes from
JAX_PLATFORMS and defaults to the CPU; `chip_smoke.py` runs the tests
marked `gpu` with JAX_PLATFORMS=cuda.  Tests marked `gpu` skip (inside
the `_gpu_only` fixture, never at import) when JAX's default backend is
not the GPU.  Must run before jax initializes.
"""
import os
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Persistent compilation cache outside the checkout by default: the
# suite compiles hundreds of distinct programs per process, and warm
# cache hits skip codegen on re-runs.  Opt out with ABIP_TEST_NO_CACHE=1.
if not os.environ.get("ABIP_TEST_NO_CACHE"):
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          os.path.join(tempfile.gettempdir(),
                                       "abip_test_cache"))
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_accumulation():
    """Drop in-memory compiled executables between test modules.

    This image's jaxlib flakily SEGFAULTS in executable handling
    (backend_compile / cache serialize / cache deserialize) once a long
    process has accumulated several hundred live compiled programs; the
    same programs compile, serialize, and load fine in a short process.
    Clearing per module keeps the accumulation bounded, and the
    persistent disk cache (above) makes the re-loads cheap.
    """
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked `gpu` unless JAX's default backend is the GPU
    (decided per test at run time, so every worker collects the same
    tests)."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run through chip_smoke.py)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_lp(rng, m=20, n=60, density=1.0):
    """A feasible, bounded standard-form LP with known interior point.

    Construction: pick x0 > 0, set b = A x0 (primal feasible); pick y0 and
    s0 > 0, set c = A' y0 + s0 (dual feasible).  Strong duality holds and
    both problems are solvable.
    """
    A = rng.standard_normal((m, n))
    if density < 1.0:
        mask = rng.random((m, n)) < density
        A = A * mask
        # ensure no zero rows/cols
        A[np.arange(m), rng.integers(0, n, m)] += rng.standard_normal(m)
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ y0 + s0
    return A, b, c
