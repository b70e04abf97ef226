# Importing the package registers the built-in agents and envs (the
# reference does this in realhf/impl/__init__.py with its register_* calls).
from areal_tpu_torch.agents import (  # noqa: F401
    code_single_step,
    math_multi_turn,
    math_single_step,
)
