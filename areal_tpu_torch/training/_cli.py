"""Shared command line of the training entry points.

The port's copy of ``training/_cli.py``: ``--config <yaml>`` merged onto
the experiment's config first (``api/cli_args.load_yaml``; a JSON file
where ``yaml`` is absent), then the ``key=value`` overrides
(``api/cli_args.apply_overrides``); ``--help`` prints the config tree,
``--backend=cuda`` (the default) or ``--backend=cpu`` picks every worker's
device.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple


def parse_argv(argv: List[str]) -> Tuple[dict, List[str]]:
    """Split the flags (--config, --backend, --help) from the key=value
    overrides."""
    flags = {"config": None, "backend": "cuda", "help": False}
    overrides: List[str] = []
    it = iter(argv)
    for a in it:
        if a in ("--help", "-h"):
            flags["help"] = True
        elif a.startswith("--config="):
            flags["config"] = a.split("=", 1)[1]
        elif a == "--config":
            flags["config"] = next(it)
        elif a.startswith("--backend="):
            flags["backend"] = a.split("=", 1)[1]
        elif a == "--backend":
            flags["backend"] = next(it)
        elif "=" in a and not a.startswith("-"):
            overrides.append(a)
        else:
            raise SystemExit(f"unrecognized argument: {a!r}")
    return flags, overrides


def main(experiment_name: str, default_cls,
         argv: Optional[List[str]] = None) -> dict:
    from areal_tpu_torch.api import cli_args as CA

    flags, overrides = parse_argv(sys.argv[1:] if argv is None else argv)
    cfg = default_cls()
    if flags["help"]:
        CA.print_config_help(cfg)
        raise SystemExit(0)
    if flags["backend"] not in CA.VALID_BACKENDS:
        raise SystemExit(f"--backend={flags['backend']}: use one of "
                         f"{', '.join(CA.VALID_BACKENDS)}")
    if flags["config"]:
        CA.load_yaml(cfg, flags["config"])
    cfg.backend = flags["backend"]
    CA.apply_overrides(cfg, overrides)
    # Bad settings fail here, while the operator is at the command line.
    CA.validate_config(cfg)
    cfg.resolve_trial_name()

    from areal_tpu_torch.base import logging

    logger = logging.getLogger("quickstart")
    logger.info(f"launching {experiment_name}: experiment_name="
                f"{cfg.experiment_name} trial_name={cfg.trial_name} "
                f"backend={cfg.backend}")

    from areal_tpu_torch.apps.launcher import run_experiment

    result = run_experiment(cfg)
    logger.info(f"experiment finished: steps={result.get('steps')}")
    return result
