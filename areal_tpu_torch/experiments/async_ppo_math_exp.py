"""Async PPO (math/code) experiment definition.

The port of ``areal_tpu/experiments/async_ppo_math_exp.py`` (reference
``realhf/experiments/async_exp/async_ppo_math_exp.py:26``): generation
leaves the DFG; rollout workers drive the generation fleet through the
manager's staleness gate and push trajectories, rewards included, to the
trainer's stream dataset; ``version_start`` / ``version_end`` ride along
for the decoupled loss. ``initial_setup`` adds the generation servers, the
manager and the rollout workers to the sync experiment's pieces, and the
reward workers when ``reward_service.enabled``: the rollout workers then
grade there, never in their own process. ``autoscale`` reaches the
manager (its scaling loop; the launcher's executor reads the same block)
and ``durability`` the rollout workers (the spool under ``recover_dir``),
the trainer and the master. A decoupled allocation (``gen.d2t2+d1``)
gives one server per data-parallel replica of the generation spec, each of
its ``tp`` ranks (reference ``:44-49``); otherwise one server.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments import register_experiment
from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig
from areal_tpu_torch.parallel.mesh import server_spec
from areal_tpu_torch.system import serving


@dataclasses.dataclass
class AsyncPPOMATHConfig(PPOMATHConfig):
    """Adds the reference's AsyncRLOptions (cli_args.py:1104)."""

    new_tokens_per_chunk: int = 1 << 10
    max_head_offpolicyness: int = 0
    n_rollout_workers: int = 1
    max_concurrent_rollouts: int = 64
    schedule_policy: str = "round_robin"
    # generation-server knobs
    gen_batch_window_ms: int = 5
    gen_max_batch_size: int = 64
    gen_prompt_bucket: int = 128

    def initial_setup(self) -> Dict[str, Any]:
        from areal_tpu_torch.system.generation_server import (
            GenerationServerConfig,
        )
        from areal_tpu_torch.system.gserver_manager import (
            GserverManagerConfig,
        )
        from areal_tpu_torch.system.rollout_worker import RolloutWorkerConfig

        alloc = C.resolve_allocation(self)
        n_gen, spec = 1, "d1"
        if alloc.decoupled:
            # One server per dp replica of the generation spec, each a
            # group of fsdp x pp x tp ranks (system/server_mesh.py) on GPUs
            # of its own; the reference makes dp x fsdp servers (:44-49)
            # and never applies their fsdp or pp (ROADMAP Queue 3 item 12).
            n_gen = alloc.gen_spec.dp
            spec = str(server_spec(alloc.gen_spec))
        paths = C.experiment_paths(self)
        # the mapping validate_config checked the serving policy with, so
        # the servers build exactly the validated policy
        shape_kw = serving.experiment_policy_kwargs(self)
        gen_servers = [
            GenerationServerConfig(
                experiment=self.experiment_name, trial=self.trial_name,
                server_id=f"gen{i}", spec=spec,
                chunk_tokens=shape_kw["chunk_tokens"],
                batch_window_ms=self.gen_batch_window_ms,
                max_batch_size=shape_kw["max_batch_size"],
                prompt_bucket=shape_kw["prompt_bucket"],
                kv_bucket=shape_kw["kv_bucket"],
                weight_stream_pipeline_depth=self.weight_sync.pipeline_depth,
                serving=self.serving,
                telemetry=self._telemetry(),
                goodput=self.goodput,
                compile_watch=self.compile_watch,
            )
            for i in range(n_gen)
        ]
        manager = GserverManagerConfig(
            experiment=self.experiment_name, trial=self.trial_name,
            model_role="actor", n_servers=n_gen,
            # staleness counts samples (reference async_rl_exp.py:327)
            train_batch_size=self.dataset.train_bs_n_seqs * self.group_size,
            max_head_offpolicyness=self.max_head_offpolicyness,
            max_concurrent_rollouts=self.max_concurrent_rollouts,
            schedule_policy=self.schedule_policy,
            realloc_dir=paths["realloc"],
            telemetry=self._telemetry(),
            # the scaling loop; the launcher's executor reads the same block
            autoscale=self.autoscale,
        )
        rollout_workers = [
            RolloutWorkerConfig(
                experiment=self.experiment_name, trial=self.trial_name,
                worker_index=i, n_workers=self.n_rollout_workers,
                dataset_path=self.dataset.path,
                gconfig=dataclasses.replace(self.ppo.gen, n=self.group_size),
                group_size=self.group_size,
                chunk_tokens=self.new_tokens_per_chunk,
                max_concurrent=max(
                    1, self.max_concurrent_rollouts // self.n_rollout_workers),
                seed=self.seed + i,
                # the consumed-prompt log lives next to the recover ckpts
                recover_dir=paths["recover"],
                telemetry=self._telemetry(),
                goodput=self.goodput,
                # agents grade on the reward fleet when it is on
                reward_service=self.reward_service,
                # the spool lands under recover_dir, beside the consumed log
                durability=self.durability,
            )
            for i in range(self.n_rollout_workers)
        ]
        setup = {
            "dfg": self.build_dfg(self.dataset.train_bs_n_seqs,
                                  async_mode=True),
            "master": self.build_master_config(async_mode=True),
            "trainer": self.build_trainer_config(async_mode=True),
            "gen_servers": gen_servers,
            "gserver_manager": manager,
            "rollout_workers": rollout_workers,
        }
        if self.reward_service.enabled:
            setup["reward_workers"] = self.build_reward_workers()
        return setup


register_experiment("async-ppo-math", AsyncPPOMATHConfig)
