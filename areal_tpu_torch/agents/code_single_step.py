"""Single-step code-RL agent.

The port's copy of ``areal_tpu/agents/code_single_step.py``.

Proof that the Agent/EnvironmentService queue contract (SURVEY §2.9,
api/agent.py) is the workload extension point rather than a math-only
special case: this agent rides the SAME rollout worker, staleness gate,
partial-rollout failover, and reward path as the math agent — the only
code here is what is genuinely code-specific.

Differences from MathSingleStepAgent:

 - **Format gate**: a sample that never emitted a fenced code block is
   scored 0.0 WITHOUT entering the sandbox (no subprocess spawned for
   prose). (The reference also counts the gate in its telemetry, which
   the port does not have yet.)
 - **Partial credit** (``pass_rate_reward=True``): reward is the fraction
   of test cases passed instead of the all-or-nothing verdict — the
   denser signal most code-RL recipes start from. Off by default: the
   default reward is bit-identical to the strict verifier.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from areal_tpu_torch.agents.math_single_step import MathSingleStepAgent
from areal_tpu_torch.api.agent import EnvironmentService
from areal_tpu_torch.api.model import register_agent, register_env
from areal_tpu_torch.base import logging
from areal_tpu_torch.rewards import code_verify
from areal_tpu_torch.rewards.client import abatch_reward, task_from_record
from areal_tpu_torch.rewards.code_verify import extract_code

logger = logging.getLogger("agents.code")

# Per-generation cap on pass-rate case fanout — the SAME bound the
# strict grader applies (and the reward service budgets for).
MAX_PASS_RATE_CASES = code_verify.MAX_CASES_DEFAULT


class CodeSingleStepEnv(EnvironmentService):
    """step((qid, texts)) grades generated programs against the record's
    ``input_output`` cases, with the format gate and optional per-case
    partial credit."""

    def __init__(self, id2info: Dict[str, Dict[str, Any]],
                 pass_rate_reward: bool = False):
        self.id2info = id2info
        self.pass_rate_reward = pass_rate_reward

    async def step(self, action):
        qid, texts = action
        info = self.id2info.get(str(qid).split("@", 1)[0], {})
        io_raw = info.get("input_output", "{}")
        tasks, slots = [], []
        scores: List[float] = [0.0] * len(texts)
        for i, t in enumerate(texts):
            if extract_code(t) is None:
                continue  # no code block: 0.0 without touching the sandbox
            base = task_from_record({**info, "task": "code"}, t)
            io = None
            if self.pass_rate_reward:
                try:
                    io = json.loads(io_raw) if isinstance(io_raw, str) \
                        else io_raw
                except (ValueError, TypeError):
                    io = None
                if not isinstance(io, dict):
                    # Malformed record: degrade to the strict path (the
                    # grader returns verdict=error, 0.0) exactly like
                    # pass_rate_reward=False would — one bad dataset
                    # line must not raise out of the rollout loop.
                    io = None
            if io is not None:
                # One task per SAMPLED test case; the reward is the pass
                # fraction over the sample. The SAME sampling policy as
                # the strict grader (code_verify.sample_cases) — a
                # 500-case record must not fan 500 sandbox tasks per
                # generation and starve the fleet, and both paths must
                # pick the same cases.
                sampled = code_verify.sample_cases(
                    io.get("inputs", []), io.get("outputs", []),
                    MAX_PASS_RATE_CASES,
                )
                for inp, out in sampled:
                    case = {"inputs": [inp], "outputs": [out]}
                    if io.get("fn_name"):
                        case["fn_name"] = io["fn_name"]
                    tasks.append({**base, "input_output": json.dumps(case)})
                    slots.append((i, len(sampled) or 1))
            else:
                tasks.append(base)
                slots.append((i, 1))
        if tasks:
            verdicts = await abatch_reward(tasks)
            for (i, denom), v in zip(slots, verdicts):
                scores[i] += float(v) / denom
        return None, scores, True, {}


class CodeSingleStepAgent(MathSingleStepAgent):
    """One obs → one grouped generation → sandboxed code rewards.

    Inherits the whole trajectory/filtering machinery; only the reward
    environment differs — which is exactly the extension contract."""


register_agent("code_single_step", CodeSingleStepAgent)
register_env("code_single_step", CodeSingleStepEnv)
