"""Shared experiment-building helpers.

The port's copy of ``areal_tpu/experiments/common.py`` (reference
``realhf/experiments/common/common.py:72``): the allocation, model roles
turned into trainer role configs, the tokenizer, the run's paths and the
name-resolve repository.

Differences: a rank holds one device, so an allocation's trainer spec
gives its number of trainer processes (the reference's
``trainer_dist_procs``, which the port derives; ``sp`` and ``pp`` enter
that world as every other axis, and so does ``ep``); a role's
``type.is_critic`` travels into its init dict, where the port's trainer
factory builds the value head (the reference drops it: ROADMAP.md Queue
3); a real tokenizer needs ``transformers``, which the port does not use,
so only ``mock_tokenizer`` runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from areal_tpu_torch.api.cli_args import (
    BaseExperimentConfig,
    ModelTrainEvalConfig,
)
from areal_tpu_torch.base import constants
from areal_tpu_torch.parallel.mesh import AllocationMode, ParallelSpec


def trainer_world(alloc: AllocationMode) -> int:
    """The trainer's ranks: the world of the allocation's trainer spec, one
    rank (process) per device. The reference sets it apart as
    ``trainer_dist_procs``, which the port derives. Every trainer spec
    must span it: the same ranks serve every role."""
    trainer = [alloc.global_spec, *(s for m, s in alloc.per_mfc.items()
                                    if m != "actor_gen")]
    worlds = sorted({s.world_size for s in trainer})
    if len(worlds) != 1:
        raise ValueError(
            f"trainer specs {[str(s) for s in trainer]} span {worlds} "
            f"devices: the port runs one trainer process per device, and "
            f"the same processes serve every role, so they must be equal")
    return worlds[0]


def resolve_allocation(cfg: BaseExperimentConfig) -> AllocationMode:
    """Parse ``allocation_mode`` (default: one device). Raises for trainer
    specs of different worlds
    (:func:`trainer_world`), and, on ``cuda``, for a world of several
    ranks wider than the visible GPUs (one rank needs none to build its
    config: the launcher checks the card)."""
    alloc = (AllocationMode.parse(cfg.allocation_mode) if cfg.allocation_mode
             else AllocationMode(global_spec=ParallelSpec()))
    world = trainer_world(alloc)
    if cfg._device() is None and world > 1:
        import torch

        n_gpus = torch.cuda.device_count()
        if world > n_gpus:
            raise ValueError(
                f"allocation {cfg.allocation_mode!r} needs {world} GPUs for "
                f"the trainer; {n_gpus} are visible")
    return alloc


# Which MFCs a model role serves, train-MFC first: a per-MFC allocation
# override for any of these steers the whole role's engine.
ROLE_MFCS: Dict[str, tuple] = {
    "actor": ("actor_train", "actor_inf", "actor_gen"),
    "critic": ("critic_train", "critic_inf"),
    "ref": ("ref_inf", "fused_rew_ref_inf"),
    "rew": ("rew_inf", "fused_rew_ref_inf"),
}


def spec_for_role(alloc: AllocationMode, role: str) -> ParallelSpec:
    """The ParallelSpec a model role's engine runs under (reference
    ``spec_for_role:42``): the first of the role's MFCs with a per-MFC
    override, else ``global_spec``."""
    for mfc in ROLE_MFCS.get(role, ()):
        spec = alloc.per_mfc.get(mfc)
        if spec is not None:
            return spec
    return alloc.global_spec


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


def backend_args_for(mc: ModelTrainEvalConfig,
                     spec: Optional[ParallelSpec] = None) -> Dict[str, Any]:
    args: Dict[str, Any] = {
        "optimizer": mc.optimizer,
        "compute_dtype": "bfloat16" if mc.bf16 else "float32",
        "remat": mc.gradient_checkpointing,
    }
    if mc.tiny:
        # CPU-test scale: small buckets so tiny batches do not pad to 128.
        args.update(compute_dtype="float32", length_bucket=16,
                    rows_bucket=2, seqs_bucket=4, remat=False)
    if spec is not None and spec.world_size > 1:
        args["parallel_spec"] = str(spec)
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
