"""The narrow ``Super`` topology (dim 16, Super's multipliers, blocks,
attention and memory-efficient layout) against the JAX package on the CPU:
a guided forward and a ``stage_loss`` gradient, with the helpers,
tolerances and set-up of ``test_torch_presets.py``. A file of its own, so
that its JAX compile and the Base one's run on different test workers."""
from test_torch_presets import (  # noqa: F401 (the fixtures are used by name)
    check_guided_forward,
    check_stage_loss_gradient,
    jax_stage,
    narrow,
)


def test_narrow_super_guided_forward_matches_jax(narrow, jax_stage):  # noqa: F811
    check_guided_forward(narrow, jax_stage, 1)


def test_narrow_super_stage_loss_gradient_matches_jax(narrow, jax_stage):  # noqa: F811
    check_stage_loss_gradient(narrow, jax_stage, 1)
