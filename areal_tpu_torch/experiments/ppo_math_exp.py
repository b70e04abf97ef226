"""Sync PPO (math/code) experiment definition.

The port of ``areal_tpu/experiments/ppo_math_exp.py`` (reference
``realhf/experiments/common/ppo_math_exp.py:30``): the PPO DFG

    actor_gen -> {rew_inf, ref_inf, actor_inf, critic_inf}
              -> {actor_train, critic_train}

pruned as the reference prunes it (``ppo.disable_value`` drops the critic,
``ppo.kl_ctl == 0`` the reference model, ``recompute_logprob`` or
``use_decoupled_loss`` adds actor_inf; ``ref_ema_eta`` adds the EMA hook),
and the trainer's and the master's configs. In async mode generation
leaves the graph: the trainer's stream dataset yields trajectories with
their rewards.

With ``reward_service.enabled`` the setup adds the reward workers
(:meth:`PPOMATHConfig.build_reward_workers`), and the trainer's rw_inf
grades on them. With ``fuse_rew_ref`` (sync mode, a reference model in
the graph) one ``fused_rew_ref_inf`` node on the ref model
(``algorithms/fused.py``) replaces rew_inf and ref_inf: the reference
forward on the device overlaps the rule-based grading on the host.

Differences: the critic role always gets a value head
(``experiments/common.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.cli_args import (
    BaseExperimentConfig,
    MFCConfig,
    ModelTrainEvalConfig,
    PPOHyperparameters,
    PromptOnlyDatasetConfig,
)
from areal_tpu_torch.api.dfg import (
    DataFlowGraph,
    MFCDef,
    MFCInterfaceType,
    ModelInterfaceAbstraction,
    ParamReallocHook,
    WeightUpdateHook,
    build_graph,
)
from areal_tpu_torch.api.model import FinetuneSpec
from areal_tpu_torch.base import logging
from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments import register_experiment

logger = logging.getLogger("experiments.ppo_math")

# The keys the generate MFC produces (the trajectory contract).
TRAJ_KEYS = (
    "packed_input_ids", "prompt_mask", "packed_logprobs",
    "seq_no_eos_mask", "task_ids", "version_start", "version_end",
)


@dataclasses.dataclass
class PPOMATHConfig(BaseExperimentConfig):
    """The reference's command-line surface, so run scripts carry over."""

    actor: ModelTrainEvalConfig = dataclasses.field(
        default_factory=ModelTrainEvalConfig)
    ref: ModelTrainEvalConfig = dataclasses.field(
        default_factory=ModelTrainEvalConfig)
    critic: ModelTrainEvalConfig = dataclasses.field(
        default_factory=ModelTrainEvalConfig)

    actor_train: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    actor_gen: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    actor_inf: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    critic_train: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    critic_inf: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    rew_inf: MFCConfig = dataclasses.field(default_factory=MFCConfig)
    ref_inf: MFCConfig = dataclasses.field(default_factory=MFCConfig)

    dataset: PromptOnlyDatasetConfig = dataclasses.field(
        default_factory=PromptOnlyDatasetConfig)
    ppo: PPOHyperparameters = dataclasses.field(
        default_factory=PPOHyperparameters)
    group_size: int = 1
    ref_ema_eta: Optional[float] = None  # ref := eta*actor + (1-eta)*ref
    # One node for the reference log-probs and the rule-based reward
    # (reference fused_interface.py "fused-threading"), sync mode only:
    # async rollout workers grade off the trainer's path already.
    fuse_rew_ref: bool = False

    @property
    def _use_critic(self) -> bool:
        return not self.ppo.disable_value

    @property
    def _use_ref(self) -> bool:
        return self.ppo.kl_ctl != 0.0

    @property
    def _use_actor_inf(self) -> bool:
        return self.ppo.recompute_logprob or self.ppo.use_decoupled_loss

    def _hp(self) -> PPOHyperparameters:
        hp = dataclasses.replace(self.ppo)
        hp.group_size = self.group_size
        return hp

    def build_dfg(self, n_prompts: int,
                  async_mode: bool = False) -> DataFlowGraph:
        """``n_prompts`` = train_bs_n_seqs; the nodes after generation see
        n_prompts * group_size trajectories."""
        n_traj = n_prompts * self.group_size
        fuse = self._fuse(async_mode)
        mfcs: List[MFCDef] = []

        def node(name, role, kind, impl, inputs, outputs=(), n_seqs=n_traj,
                 **kw):
            mfcs.append(MFCDef(
                name=name, model_name=role, interface_type=kind,
                interface_impl=ModelInterfaceAbstraction(impl),
                input_keys=tuple(inputs), output_keys=tuple(outputs),
                n_seqs=n_seqs, mb_spec=getattr(self, name).mb_spec, **kw))

        if not async_mode:
            node("actor_gen", "actor", MFCInterfaceType.GENERATE,
                 "ppo_actor", ("packed_prompts", "task_ids"), TRAJ_KEYS,
                 n_seqs=n_prompts)
            if not fuse:
                node("rew_inf", "rew", MFCInterfaceType.INFERENCE,
                     "rw_math_code", ("packed_input_ids", "prompt_mask"),
                     ("rewards",))
        if fuse:
            # the ref model's node, with ref_inf's micro-batch spec
            mfcs.append(MFCDef(
                name="fused_rew_ref_inf", model_name="ref",
                interface_type=MFCInterfaceType.INFERENCE,
                interface_impl=ModelInterfaceAbstraction("fused_forward"),
                input_keys=("packed_input_ids", "prompt_mask"),
                output_keys=("rewards", "packed_ref_logprobs"),
                n_seqs=n_traj, mb_spec=self.ref_inf.mb_spec))
        elif self._use_ref:
            node("ref_inf", "ref", MFCInterfaceType.INFERENCE, "ref_logprob",
                 ("packed_input_ids",), ("packed_ref_logprobs",))
        if self._use_actor_inf:
            node("actor_inf", "actor", MFCInterfaceType.INFERENCE,
                 "ppo_actor", ("packed_input_ids",), ("prox_logprobs",))
        if self._use_critic:
            node("critic_inf", "critic", MFCInterfaceType.INFERENCE,
                 "ppo_critic", ("packed_input_ids",), ("values",))
        train_inputs = ["packed_input_ids", "prompt_mask", "packed_logprobs",
                        "rewards", "seq_no_eos_mask"]
        if self._use_ref:
            train_inputs.append("packed_ref_logprobs")
        if self._use_actor_inf:
            train_inputs.append("prox_logprobs")
        if self._use_critic:
            train_inputs.append("values")
        actor_post = [WeightUpdateHook(role="actor")]
        if self.ref_ema_eta is not None:
            actor_post.append(ParamReallocHook(
                source="actor", target="ref", eta=self.ref_ema_eta))
        node("actor_train", "actor", MFCInterfaceType.TRAIN_STEP, "ppo_actor",
             train_inputs, post_hooks=actor_post)
        if self._use_critic:
            node("critic_train", "critic", MFCInterfaceType.TRAIN_STEP,
                 "ppo_critic",
                 [k for k in train_inputs if k != "prox_logprobs"])
        return build_graph(mfcs)

    def _fuse(self, async_mode: bool) -> bool:
        return self.fuse_rew_ref and self._use_ref and not async_mode

    def _dataset_size(self) -> int:
        """The dataset's line count, for epochs and the LR schedule."""
        try:
            with open(self.dataset.path, "rb") as f:
                return max(1, sum(1 for line in f if line.strip()))
        except OSError:
            logger.warning(f"cannot read dataset {self.dataset.path}; "
                           "assuming 10000 samples for schedule math")
            return 10000

    def _telemetry(self):
        """``self.telemetry`` with ``flight_dir`` defaulted under the
        run's log dir: crash and eviction flight dumps land next to
        telemetry.jsonl unless the operator pointed them elsewhere."""
        if not self.telemetry.enabled or self.telemetry.flight_dir:
            return self.telemetry
        return dataclasses.replace(
            self.telemetry,
            flight_dir=os.path.join(C.experiment_paths(self)["log"],
                                    "flight"))

    def build_trainer_config(self, async_mode: bool = False):
        from areal_tpu_torch.system.trainer_worker import (
            MFCRuntimeConfig,
            ModelRoleConfig,
            TrainerWorkerConfig,
        )

        alloc = C.resolve_allocation(self)
        paths = C.experiment_paths(self)
        dataset_size = self._dataset_size()
        hp = self._hp()

        def role(mc, name, **kw):
            return ModelRoleConfig(
                init=C.model_init_dict(mc), backend=mc.backend,
                backend_args=C.backend_args_for(
                    mc, C.spec_for_role(alloc, name)), **kw)

        models: Dict[str, ModelRoleConfig] = {"actor": role(self.actor,
                                                            "actor")}
        if self._use_ref:
            models["ref"] = role(self.ref, "ref", train=False)
        if self._use_critic:
            critic = self.critic
            if not critic.tiny and not critic.path:
                critic = self.actor  # the critic starts from the actor
            models["critic"] = role(dataclasses.replace(  # a value head
                critic, type=dataclasses.replace(critic.type,
                                                 is_critic=True)), "critic")
        ppo = {"interface_args": {"hp": hp}}
        mfcs: Dict[str, MFCRuntimeConfig] = {}
        rew_args = {"dataset_path": self.dataset.path,
                    "group_size": self.group_size}
        fuse = self._fuse(async_mode)
        if not async_mode:
            mfcs["actor_gen"] = MFCRuntimeConfig(
                interface="ppo_actor", model_name="actor", **ppo)
            if not fuse:
                models["rew"] = ModelRoleConfig(init={"null": True},
                                                backend="null")
                mfcs["rew_inf"] = MFCRuntimeConfig(
                    interface="rw_math_code", model_name="rew",
                    interface_args=rew_args)
        if fuse:
            mfcs["fused_rew_ref_inf"] = MFCRuntimeConfig(
                interface="fused_forward", model_name="ref",
                interface_args={"interfaces": {
                    "rew": ("rw_math_code", rew_args),
                    "ref": ("ref_logprob", {})}})
        elif self._use_ref:
            mfcs["ref_inf"] = MFCRuntimeConfig(interface="ref_logprob",
                                               model_name="ref")
        if self._use_actor_inf:
            mfcs["actor_inf"] = MFCRuntimeConfig(
                interface="ppo_actor", model_name="actor", **ppo)
        if self._use_critic:
            for name in ("critic_inf", "critic_train"):
                mfcs[name] = MFCRuntimeConfig(
                    interface="ppo_critic", model_name="critic", **ppo)
        mfcs["actor_train"] = MFCRuntimeConfig(
            interface="ppo_actor", model_name="actor", **ppo)
        return TrainerWorkerConfig(
            experiment=self.experiment_name, trial=self.trial_name,
            handler="trainer", models=models, mfcs=mfcs,
            dataset=None if async_mode else "math_code_prompt",
            dataset_args={} if async_mode else {
                "dataset_path": self.dataset.path,
                "max_length": self.dataset.max_prompt_len},
            batch_size=self.dataset.train_bs_n_seqs,
            ft_spec=FinetuneSpec(
                total_train_epochs=self.exp_ctrl.total_train_epochs,
                dataset_size=dataset_size,
                train_batch_size=self.dataset.train_bs_n_seqs),
            tokenizer=None,  # resolved in the trainer's process
            stream_dataset=async_mode,
            realloc_dir=paths["realloc"],
            weight_sync=self.weight_sync,
            telemetry=self._telemetry(),
            goodput=self.goodput,
            compile_watch=self.compile_watch,
            # Sync mode's rw_inf grades on the reward fleet when it is on.
            reward_service=self.reward_service,
            device=self._device(),
            # the staleness gate of spooled replays
            durability=self.durability,
        )

    def build_master_config(self, async_mode: bool = False):
        from areal_tpu_torch.system.master_worker import MasterWorkerConfig

        paths = C.experiment_paths(self)
        # Sync: the master fetches prompts (actor_gen makes group_size
        # trajectories of each). Async: the stream yields trajectories, so
        # a step takes n_prompts * group_size samples.
        bs = self.dataset.train_bs_n_seqs
        if async_mode:
            bs *= self.group_size
        # The master hosts the aggregator; its telemetry.jsonl defaults
        # next to the run's tensorboard stream under the log dir.
        tel = dataclasses.replace(
            self._telemetry(),
            jsonl_path=(self.telemetry.jsonl_path
                        or os.path.join(paths["log"], "telemetry.jsonl")))
        return MasterWorkerConfig(
            experiment=self.experiment_name, trial=self.trial_name,
            trainer_handler="trainer",
            train_batch_size=bs,
            exp_ctrl=self.exp_ctrl,
            save_dir=paths["save"],
            tensorboard_path=(self.tensorboard.path
                              or os.path.join(paths["log"], "tensorboard")),
            wandb_mode=self.wandb.mode,
            recover_dir=paths["recover"],
            recover=self.recover_mode == "resume",
            telemetry=tel,
            # the sentinel and fleet goodput ride in the aggregator
            sentinel=self.sentinel,
            goodput=self.goodput,
            compile_watch=self.compile_watch,
            # arms the sentinel's sample_loss rule with the spool
            durability=self.durability,
        )

    def build_reward_workers(self) -> List[Any]:
        """The reward workers' configs (none while the service is off);
        shared by the sync and async setups."""
        if not self.reward_service.enabled:
            return []
        from areal_tpu_torch.system.reward_worker import RewardWorkerConfig

        return [
            RewardWorkerConfig(
                experiment=self.experiment_name, trial=self.trial_name,
                worker_index=i, port=self.reward_service.port,
                reward=self.reward_service, telemetry=self._telemetry(),
                keepalive_ttl_secs=self.fault_tolerance.keepalive_ttl_secs)
            for i in range(self.reward_service.n_workers)
        ]

    def initial_setup(self) -> Dict[str, Any]:
        """-> {dfg, master, trainer[, reward_workers]} (sync: generation in
        the trainer)."""
        setup = {
            "dfg": self.build_dfg(self.dataset.train_bs_n_seqs,
                                  async_mode=False),
            "master": self.build_master_config(async_mode=False),
            "trainer": self.build_trainer_config(async_mode=False),
        }
        if self.reward_service.enabled:
            # The fleet keeps untrusted code out of the trainer too.
            setup["reward_workers"] = self.build_reward_workers()
        return setup


register_experiment("ppo-math", PPOMATHConfig)
