"""Single-step math/code agent + verifier environment.

The port's copy of ``areal_tpu/agents/math_single_step.py``. Parity targets: ``realhf/impl/agent/math_single_step_agent.py:23``
(MathSingleStepAgent: prompt → grouped generation → env reward →
success-rate filtering → trajectory samples) and
``realhf/impl/environment/math_code_single_step_env.py:41``
(MathCodeSingleStepEnv: step = math/code verification).
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Tuple

import numpy as np

from areal_tpu_torch.api.agent import Agent, EnvironmentService
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model import register_agent, register_env
from areal_tpu_torch.base import logging
from areal_tpu_torch.rewards.client import abatch_reward, task_from_record

logger = logging.getLogger("agents.math")


class MathCodeSingleStepEnv(EnvironmentService):
    """step(action) grades generated texts against the dataset record."""

    def __init__(self, id2info: Dict[str, Dict[str, Any]]):
        self.id2info = id2info

    async def step(self, action: Tuple[str, List[str]]):
        qid, texts = action
        # ids carry "@"-separated suffixes (group index, epoch-pass tag);
        # the dataset key is everything before the first "@".
        info = self.id2info.get(str(qid).split("@", 1)[0], {})
        tasks = [task_from_record(info, t) for t in texts]
        # Real async entrypoint (rewards/client.py): grading — local,
        # legacy-domain, or reward-service fanout — never blocks the
        # rollout event loop on a dedicated grading thread.
        scores = await abatch_reward(tasks)
        return None, scores, True, {}


class MathSingleStepAgent(Agent):
    """One obs → one grouped generation → rewards → trajectories."""

    def __init__(
        self,
        tokenizer=None,
        success_rate_lb: float = 0.0,
        success_rate_ub: float = 1.0,
        reward_scaling: float = 1.0,
        reward_bias: float = 0.0,
    ):
        self.tokenizer = tokenizer
        self.success_rate_lb = success_rate_lb
        self.success_rate_ub = success_rate_ub
        self.reward_scaling = reward_scaling
        self.reward_bias = reward_bias

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        qid = prompt.ids[0]
        prompt_ids = prompt.data["packed_prompts"]
        await obs_queue.put((qid, prompt_ids, None))
        # trajectory samples assembled by the generation client side
        trajs: List[SequenceSample] = await act_queue.get()
        if not trajs:
            return []
        texts = []
        for t in trajs:
            toks = t.data["packed_input_ids"]
            pm = t.data["prompt_mask"]
            gen = toks[pm == 0]
            texts.append(self.tokenizer.decode(gen) if self.tokenizer else "")
        _, scores, _, _ = await env.step((qid, texts))
        scores = np.asarray(scores, np.float32)
        # filter prompts that are too easy/hard for the whole group
        # (reference agent :44 success-rate bounds)
        rate = float((scores > 0).mean())
        if not (self.success_rate_lb <= rate <= self.success_rate_ub):
            logger.info(f"{qid}: success rate {rate:.2f} out of bounds; drop")
            return []
        out = []
        for t, s in zip(trajs, scores):
            t.update_(SequenceSample.from_default(
                ids=list(t.ids),
                data={"rewards": np.asarray(
                    [(s - self.reward_bias) * self.reward_scaling], np.float32
                )},
                seqlens=[1],
            ))
            out.append(t)
        return out


register_agent("math_single_step", MathSingleStepAgent)
register_env("math_code_single_step", MathCodeSingleStepEnv)
