"""Shared experiment-building helpers.

The port's copy of ``areal_tpu/experiments/common.py`` (reference
``realhf/experiments/common/common.py:72``): the allocation, model roles
turned into trainer role configs, the tokenizer, the run's paths and the
name-resolve repository.

Differences: the port runs on one device, so an allocation wider than one
raises (multi-GPU parallelism is ROADMAP.md Queue 1 item 8); a role's
``type.is_critic`` travels into its init dict, where the port's trainer
factory builds the value head (the reference drops it: ROADMAP.md Queue
3); a real tokenizer needs ``transformers``, which the port does not use,
so only ``mock_tokenizer`` runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from areal_tpu_torch.api.cli_args import (
    BaseExperimentConfig,
    ModelTrainEvalConfig,
)
from areal_tpu_torch.base import constants
from areal_tpu_torch.parallel.mesh import AllocationMode, ParallelSpec


def resolve_allocation(cfg: BaseExperimentConfig) -> AllocationMode:
    """Parse ``allocation_mode`` (default: every device, pure dp). Raises
    for a spec wider than one device."""
    total = cfg.n_nodes * cfg.n_gpus_per_node
    alloc = (AllocationMode.parse(cfg.allocation_mode) if cfg.allocation_mode
             else AllocationMode(global_spec=ParallelSpec(dp=total)))
    specs = [alloc.global_spec, alloc.gen_spec, *alloc.per_mfc.values()]
    wide = [str(s) for s in specs if s is not None and s.world_size > 1]
    if wide:
        raise NotImplementedError(
            f"allocation {', '.join(wide)} spans more than one device; the "
            "port runs every role on one device until multi-GPU parallelism "
            "lands (ROADMAP.md Queue 1 item 8)")
    return alloc


def model_init_dict(mc: ModelTrainEvalConfig) -> Dict[str, Any]:
    """ModelTrainEvalConfig -> the trainer's ModelRoleConfig.init dict."""
    critic = {"is_critic": True} if mc.type.is_critic else {}
    if mc.tiny:
        return {"tiny": {**mc.tiny, **critic}}
    if mc.type._class == "null" or (not mc.path and not mc.init_from_scratch):
        return {"null": True}
    if mc.path:
        return {"hf_dir": mc.path, **critic}
    raise ValueError(f"model config {mc} has init_from_scratch but no size "
                     "spec; use `tiny` or provide a path")


def backend_args_for(mc: ModelTrainEvalConfig) -> Dict[str, Any]:
    args: Dict[str, Any] = {
        "optimizer": mc.optimizer,
        "compute_dtype": "bfloat16" if mc.bf16 else "float32",
        "remat": mc.gradient_checkpointing,
    }
    if mc.tiny:
        # CPU-test scale: small buckets so tiny batches do not pad to 128.
        args.update(compute_dtype="float32", length_bucket=16,
                    rows_bucket=2, seqs_bucket=4, remat=False)
    return args


def make_tokenizer(cfg: BaseExperimentConfig, model_path: str):
    if cfg.mock_tokenizer:
        from areal_tpu_torch.base.testing import ByteTokenizer

        return ByteTokenizer()
    raise NotImplementedError(
        f"the tokenizer of {model_path!r} needs `transformers`, which the "
        "port does not use; set mock_tokenizer=true (the byte tokenizer)")


def experiment_paths(cfg: BaseExperimentConfig) -> Dict[str, str]:
    paths = constants.experiment_paths(
        cfg.experiment_name, cfg.trial_name, fileroot=cfg.cluster.fileroot)
    if cfg.cluster.name_resolve.nfs_record_root:
        paths["name_resolve"] = cfg.cluster.name_resolve.nfs_record_root
    return paths


def setup_name_resolve(cfg: BaseExperimentConfig) -> None:
    """Configure this process's name-resolve repository (a spawned child
    calls it again: module globals do not cross a spawn). The NFS root
    defaults under the run's directory."""
    from areal_tpu_torch.base import name_resolve

    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    nr = cfg.cluster.name_resolve
    if nr.type == "nfs" and not nr.nfs_record_root:
        nr = dataclasses.replace(
            nr, nfs_record_root=experiment_paths(cfg)["name_resolve"])
    name_resolve.reconfigure(nr)
