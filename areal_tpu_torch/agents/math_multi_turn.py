"""Multi-turn math agent: generate, grade, feed back, retry.

The port of ``areal_tpu/agents/math_multi_turn.py`` (reference
``realhf/impl/agent/math_multi_turn_agent.py:23``, MathMultiTurnAgent): up
to ``num_turns`` rounds in which the model answers, the environment
grades the answer, and a verdict is appended to the context before the
next attempt; turn rewards are credited backwards with
``turn_level_discount`` (turn t's reward includes the discounted rewards
of the later turns).

As in the JAX package, each turn is a trajectory sample of its own (the
reference packs the turns into one multi-segment sample): turn t's
sequence holds the whole accumulated context as its prompt (its
prompt_mask covers it), so the token-level credit is the same and the
packer keeps one segment per sample.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np

from areal_tpu_torch.api.agent import Agent, EnvironmentService
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model import GenerationHyperparameters, register_agent
from areal_tpu_torch.base import logging

logger = logging.getLogger("agents.math_multi_turn")

_FEEDBACK_OK = "Congratulations! You are correct!"
_FEEDBACK_RETRY = "Unfortunately your answer is wrong. Let's try again."


class MathMultiTurnAgent(Agent):
    """``num_turns`` obs -> act rounds per prompt, one sample per turn."""

    def __init__(
        self,
        tokenizer=None,
        num_turns: int = 4,
        turn_level_discount: float = 1.0,
        reward_scaling: float = 1.0,
        reward_bias: float = 0.0,
        max_new_tokens_per_turn: int = 1024,
        stop_on_success: bool = True,
        answer_save_path: Optional[str] = None,
        gconfig: Optional[GenerationHyperparameters] = None,
    ):
        assert tokenizer is not None, "the multi-turn agent needs a tokenizer"
        self.tokenizer = tokenizer
        self.num_turns = num_turns
        self.turn_level_discount = turn_level_discount
        self.reward_scaling = reward_scaling
        self.reward_bias = reward_bias
        self.stop_on_success = stop_on_success
        self.answer_save_path = answer_save_path
        self.gconfig = dataclasses.replace(
            gconfig or GenerationHyperparameters(), n=1,
            max_new_tokens=max_new_tokens_per_turn)

    def _feedback_ids(self, success: bool) -> List[int]:
        text = _FEEDBACK_OK if success else _FEEDBACK_RETRY
        tok = self.tokenizer
        if hasattr(tok, "apply_chat_template"):
            try:
                text = "\n" + tok.apply_chat_template(
                    [{"content": text, "role": "user"}],
                    add_generation_prompt=True, tokenize=False)
            except Exception:  # noqa: BLE001 — tokenizers without a template
                text = f"\nUser: {text}\nAssistant:"
        else:
            text = f"\nUser: {text}\nAssistant:"
        return list(tok.encode(text))

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        await env.reset()
        qid = prompt.ids[0]
        token_ids = list(map(int, prompt.data["packed_prompts"]))

        turns: List[SequenceSample] = []
        rewards: List[float] = []
        log: List[dict] = []
        for turn in range(self.num_turns):
            await obs_queue.put((qid, token_ids, self.gconfig))
            trajs: List[SequenceSample] = await act_queue.get()
            if not trajs:
                break
            t = trajs[0]
            toks = np.asarray(t.data["packed_input_ids"])
            pm = np.asarray(t.data["prompt_mask"])
            answer = self.tokenizer.decode(list(map(int, toks[pm == 0])))
            _, success, *_ = await env.step((qid, [answer]))
            ok = bool(np.asarray(success).reshape(-1)[0] > 0)
            rewards.append((float(ok) - 0.5) * 2 - self.reward_bias)
            turns.append(t)
            log.append({"turn": turn, "success": ok,
                        "prompt_len": int(pm.sum()),
                        "answer_len": int((pm == 0).sum())})
            if ok and self.stop_on_success:
                break
            # The next turn continues from the whole sequence and a verdict.
            token_ids = list(map(int, toks)) + self._feedback_ids(ok)

        # Turn-level credit (reference :208-211): reward[t] +=
        # discount * reward[t+1], then the scaling.
        for i in reversed(range(len(rewards) - 1)):
            rewards[i] = rewards[i] + rewards[i + 1] * self.turn_level_discount
        for t, r in zip(turns, rewards):
            t.update_(SequenceSample.from_default(
                ids=list(t.ids),
                data={"rewards": np.asarray([r * self.reward_scaling],
                                            np.float32)},
                seqlens=[1]))
        self._log_to_file(qid, log)
        return turns

    def _log_to_file(self, qid, log: List[dict]) -> None:
        """A jsonl of pass/fail per turn for each qid (reference
        log_rewards_to_file)."""
        if not self.answer_save_path:
            return
        try:
            os.makedirs(self.answer_save_path, exist_ok=True)
            path = os.path.join(self.answer_save_path, f"{qid}.jsonl")
            with open(path, "a") as f:
                for rec in log:
                    f.write(json.dumps({**rec, "time": time.time()}) + "\n")
        except OSError as e:
            logger.warning(f"answer log write failed: {e}")


register_agent("math_multi_turn", MathMultiTurnAgent)
