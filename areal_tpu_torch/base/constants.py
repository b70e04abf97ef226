"""Per-process experiment identity and the canonical filesystem layout.

The port's copy of ``areal_tpu/base/constants.py``: one experiment trial
owns ``<fileroot>/<experiment>/<trial>/{checkpoints,realloc,recover,
name_resolve,logs}``; ``realloc`` is where the trainer publishes weights
for the generation fleet over disk.
"""

from __future__ import annotations

import getpass
import os
import tempfile
from typing import Dict, Optional

_experiment_name: Optional[str] = None
_trial_name: Optional[str] = None


def set_experiment_trial_names(experiment: str, trial: str) -> None:
    global _experiment_name, _trial_name
    _experiment_name = experiment
    _trial_name = trial


def experiment_name() -> str:
    if _experiment_name is None:
        raise RuntimeError("experiment name unset")
    return _experiment_name


def trial_name() -> str:
    if _trial_name is None:
        raise RuntimeError("trial name unset")
    return _trial_name


def get_fileroot() -> str:
    return os.environ.get(
        "AREAL_CACHE_ROOT",
        os.path.join(tempfile.gettempdir(), getpass.getuser(), "areal_tpu"))


def experiment_paths(
    experiment: Optional[str] = None,
    trial: Optional[str] = None,
    fileroot: Optional[str] = None,
) -> Dict[str, str]:
    root = os.path.join(fileroot or get_fileroot(),
                        experiment or experiment_name(),
                        trial or trial_name())
    return {
        "root": root,
        "save": os.path.join(root, "checkpoints"),
        "realloc": os.path.join(root, "realloc"),
        "recover": os.path.join(root, "recover"),
        "name_resolve": os.path.join(root, "name_resolve"),
        "log": os.path.join(root, "logs"),
    }
