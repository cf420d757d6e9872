"""On-device tier: regression tests that need a real GPU.

The CPU suite (tests/) is structurally blind to two classes of
accelerator-only numeric bugs: (1) f32 matmuls at default precision run
in TF32 on the GPU (a 10-bit mantissa), silently re-ranking top-k and
rounding pooled means; (2) scatter-adds run as atomics whose summation
order changes from run to run, and out-of-range dynamic_slice /
dynamic_update_slice offsets are clamped by backend rules, which can
shear chunked loops. This tier runs the regression checks on the device.

Usage (one JAX process per card — a second one cannot get the card's
memory):

    python -m pytest tests_gpu/ -q -m "not deterministic"
    XLA_FLAGS=--xla_gpu_deterministic_ops=true \
        python -m pytest tests_gpu/ -q -m deterministic

(The flag slows full-size training scatters by orders of magnitude, so
the tier's AmazonBooks-scale tests run without it.)

``python chip_smoke.py`` runs the ``deterministic`` tests first, in a child
process started with that flag, and the rest in its own process as its
last phase. Every test is marked ``gpu`` and skips, with its reason,
where JAX finds no GPU. Tests marked ``deterministic`` compare two
programs at tight bounds and skip, with their reason, unless the process
was started with the flag (XLA reads it once, when JAX creates its GPU
backend).
"""

import pytest


@pytest.fixture(autouse=True)
def require_gpu(request):
    import jax

    from heat_cf.utils.device import DETERMINISTIC_OPS_FLAG, deterministic_ops

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"the on-device tier needs a GPU (JAX found {platform})")
    if request.node.get_closest_marker("deterministic") and not deterministic_ops():
        pytest.skip(
            f"compares two programs at tight bounds; needs XLA_FLAGS="
            f"{DETERMINISTIC_OPS_FLAG} (atomic scatter order differs run to run)"
        )
