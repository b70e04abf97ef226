"""SFT experiment definition.

The port of ``areal_tpu/experiments/sft_exp.py`` (reference
``realhf/experiments/common/sft_exp.py``): a one-node graph,
``trainDefault``, a TRAIN_STEP of the packed cross-entropy interface
(``"sft"``) over ``packed_input_ids`` + ``prompt_mask`` batches of the
``prompt_answer`` dataset, on one model role, ``default``. The master saves
that role under ``{save_dir}/default/step{N}``, which the automatic
evaluator watches when ``auto_eval`` is on.

Differences: the master writes its scalars (and the evaluator its
``eval/*``) under the run's log directory, as the PPO experiments do (the
reference's SFT master writes none); every worker runs on ``backend``'s
device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

from areal_tpu_torch.api.cli_args import (
    BaseExperimentConfig,
    MFCConfig,
    ModelTrainEvalConfig,
    PromptAnswerDatasetConfig,
)
from areal_tpu_torch.api.dfg import (
    MFCDef,
    MFCInterfaceType,
    ModelInterfaceAbstraction,
    build_graph,
)
from areal_tpu_torch.api.model import FinetuneSpec
from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments import register_experiment


@dataclasses.dataclass
class SFTConfig(BaseExperimentConfig):
    model: ModelTrainEvalConfig = dataclasses.field(
        default_factory=ModelTrainEvalConfig)
    allocation: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    dataset: PromptAnswerDatasetConfig = dataclasses.field(
        default_factory=PromptAnswerDatasetConfig)

    def initial_setup(self) -> Dict[str, Any]:
        from areal_tpu_torch.system.master_worker import MasterWorkerConfig
        from areal_tpu_torch.system.trainer_worker import (
            MFCRuntimeConfig,
            ModelRoleConfig,
            TrainerWorkerConfig,
        )

        C.resolve_allocation(self)
        paths = C.experiment_paths(self)
        dfg = build_graph([MFCDef(
            name="trainDefault", model_name="default",
            interface_type=MFCInterfaceType.TRAIN_STEP,
            interface_impl=ModelInterfaceAbstraction("sft"),
            input_keys=("packed_input_ids", "prompt_mask"),
            n_seqs=self.dataset.train_bs_n_seqs,
            mb_spec=self.allocation.mb_spec,
        )])
        trainer = TrainerWorkerConfig(
            experiment=self.experiment_name, trial=self.trial_name,
            handler="trainer",
            models={"default": ModelRoleConfig(
                init=C.model_init_dict(self.model),
                backend=self.model.backend,
                backend_args=C.backend_args_for(self.model),
            )},
            mfcs={"trainDefault": MFCRuntimeConfig(
                interface="sft", model_name="default")},
            dataset="prompt_answer",
            dataset_args={"dataset_path": self.dataset.path,
                          "max_length": self.dataset.max_seqlen},
            batch_size=self.dataset.train_bs_n_seqs,
            ft_spec=FinetuneSpec(
                total_train_epochs=self.exp_ctrl.total_train_epochs,
                dataset_size=10000,
                train_batch_size=self.dataset.train_bs_n_seqs,
            ),
            tokenizer=None,  # resolved in the trainer's process
            realloc_dir=paths["realloc"],
            device=self._device(),
        )
        master = MasterWorkerConfig(
            experiment=self.experiment_name, trial=self.trial_name,
            trainer_handler="trainer",
            train_batch_size=self.dataset.train_bs_n_seqs,
            exp_ctrl=self.exp_ctrl,
            save_dir=paths["save"],
            tensorboard_path=(self.tensorboard.path
                              or os.path.join(paths["log"], "tensorboard")),
            wandb_mode=self.wandb.mode,
        )
        return {"dfg": dfg, "master": master, "trainer": trainer}


register_experiment("sft", SFTConfig)
