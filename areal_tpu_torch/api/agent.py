"""Agent and environment abstractions for rollout workers.

The port's copy of ``areal_tpu/api/agent.py`` (reference
``realhf/api/core/agent_api.py:15`` and ``env_api.py:8``): an agent puts
generation requests on ``obs_queue`` and awaits the grouped outputs on
``act_queue``; the rollout worker bridges the two queues to the generation
client.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Tuple

from areal_tpu_torch.api.data import SequenceSample


class EnvironmentService:
    async def reset(self, seed: int = 0) -> Any:
        return None

    async def step(self, action: Any) -> Tuple[Any, float, bool, dict]:
        raise NotImplementedError()


class Agent:
    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        """Put generation requests on obs_queue, await grouped outputs from
        act_queue, interact with env for rewards, return trajectory samples
        (possibly empty when filtered)."""
        raise NotImplementedError()
