"""The port's multi-turn math agent (areal_tpu_torch/agents/math_multi_turn.py)
against the reference's (areal_tpu/agents/math_multi_turn.py), driven the
way tests/test_agents.py drives it: fake obs/act queues, a scripted
environment, one fake generation per turn. Every turn's observation, every
sample (ids, tokens, masks, rewards) and the answer log agree exactly.
"""

import asyncio
import json

import numpy as np
import pytest

from areal_tpu.agents.math_multi_turn import MathMultiTurnAgent as JAgent
from areal_tpu.api.agent import EnvironmentService as JEnv
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base.testing import MockTokenizer
from areal_tpu_torch.agents.math_multi_turn import (
    MathMultiTurnAgent as TAgent,
)
from areal_tpu_torch.api.agent import EnvironmentService as TEnv
from areal_tpu_torch.api.data import SequenceSample as TSample
from areal_tpu_torch.api.model import make_agent
from areal_tpu_torch.base.testing import MockTokenizer as TMockTokenizer

PKGS = {"ref": (JAgent, JEnv, JSample, MockTokenizer),
        "port": (TAgent, TEnv, TSample, TMockTokenizer)}


def _env_cls(base):
    class ScriptedEnv(base):
        """Grades turn t with the scripted verdict list."""

        def __init__(self, verdicts):
            self.verdicts = list(verdicts)
            self.calls = 0
            self.answers = []

        async def step(self, action):
            self.answers.append(action)
            ok = self.verdicts[min(self.calls, len(self.verdicts) - 1)]
            self.calls += 1
            return None, [1.0 if ok else 0.0], True, {}

    return ScriptedEnv


async def _drive(agent, env, prompt, gens, sample_cls, max_rounds=10):
    """Serve the agent's observations until it returns; turn t's act is a
    one-sample generation of ``gens[t]``'s tokens."""
    obs_q: asyncio.Queue = asyncio.Queue()
    act_q: asyncio.Queue = asyncio.Queue()
    task = asyncio.create_task(
        agent.collect_trajectory(prompt, env, obs_q, act_q))
    seen = []
    for turn in range(max_rounds):
        get_obs = asyncio.create_task(obs_q.get())
        done, _ = await asyncio.wait({task, get_obs},
                                     return_when=asyncio.FIRST_COMPLETED)
        if get_obs not in done:
            get_obs.cancel()
            break
        qid, token_ids, gconfig = get_obs.result()
        seen.append((qid, list(token_ids), gconfig.n,
                     gconfig.max_new_tokens))
        p = np.asarray(token_ids, np.int32)
        g = np.asarray(gens[turn % len(gens)], np.int32)
        toks = np.concatenate([p, g]).astype(np.int32)
        await act_q.put([sample_cls.from_default(
            ids=[f"{qid}@t{turn}@0"],
            data={"packed_input_ids": toks,
                  "prompt_mask": np.concatenate(
                      [np.ones(len(p), np.int32), np.zeros(len(g), np.int32)]),
                  "packed_logprobs": np.zeros(len(toks), np.float32),
                  "seq_no_eos_mask": np.asarray([0.0], np.float32),
                  "version_start": np.asarray([0], np.int32),
                  "version_end": np.asarray([0], np.int32)},
            seqlens=[len(toks)])])
    return await task, seen


def _run(pkg, verdicts, log_dir=None, **agent_kw):
    agent_cls, env_base, sample_cls, tok_cls = PKGS[pkg]
    tok = tok_cls()
    rng = np.random.RandomState(7)
    gens = [tok.encode(f"answer {rng.randint(100)}") for _ in range(4)]
    ids = tok.encode("What is 12+30? ")
    prompt = sample_cls.from_default(
        ids=["q7"], data={"packed_prompts": np.asarray(ids, np.int32)},
        seqlens=[len(ids)])
    env = _env_cls(env_base)(verdicts)
    agent = agent_cls(tokenizer=tok, answer_save_path=log_dir, **agent_kw)
    out, seen = asyncio.run(_drive(agent, env, prompt, gens, sample_cls))
    samples = [(list(s.ids), {k: np.asarray(v).tolist()
                              for k, v in s.data.items()},
                {k: [list(x) for x in v] for k, v in s.seqlens.items()})
               for s in out]
    return samples, seen, env.answers


@pytest.mark.parametrize("verdicts,kw", [
    ([False, False, True], dict(num_turns=4, turn_level_discount=0.5)),
    ([False, False, False], dict(num_turns=3)),
    ([True, True, True], dict(num_turns=3, stop_on_success=False)),
    ([False, True], dict(num_turns=2, turn_level_discount=0.9,
                         reward_scaling=2.0, reward_bias=0.25,
                         max_new_tokens_per_turn=16)),
])
def test_multi_turn_samples_and_rewards_match_reference(verdicts, kw):
    got, want = _run("port", verdicts, **kw), _run("ref", verdicts, **kw)
    assert got == want
    samples, seen, _ = got
    assert len(samples) == len(seen) >= 1
    # turn t+1's context is turn t's whole sequence plus the feedback
    for a, (_, data, _) in zip(seen[1:], samples):
        assert a[1][:len(data["packed_input_ids"])] == data[
            "packed_input_ids"]
    assert all(n == 1 for _, _, n, _ in seen)


def test_multi_turn_discount_and_feedback():
    """tests/test_agents.py's numbers on the port: raw turn rewards (-1,
    -1, +1) discounted backwards with 0.5 give (-1.25, -0.5, 1.0), and the
    retry verdict's tokens follow a failed turn."""
    samples, seen, _ = _run("port", [False, False, True], num_turns=4,
                            turn_level_discount=0.5)
    assert [s[1]["rewards"] for s in samples] == [[-1.25], [-0.5], [1.0]]
    tok = TMockTokenizer()
    first = samples[0][1]["packed_input_ids"]
    assert "wrong" in tok.decode(seen[1][1][len(first):])


def test_multi_turn_answer_log_matches_reference(tmp_path):
    for pkg in ("ref", "port"):
        _run(pkg, [False, True], log_dir=str(tmp_path / pkg), num_turns=2)
    logs = {pkg: [{k: v for k, v in json.loads(line).items() if k != "time"}
                  for line in (tmp_path / pkg / "q7.jsonl").read_text()
                  .splitlines()] for pkg in ("ref", "port")}
    assert logs["port"] == logs["ref"] and len(logs["port"]) == 2


def test_registered_as_math_multi_turn():
    import areal_tpu_torch.agents  # noqa: F401 (registers)

    agent = make_agent("math_multi_turn", tokenizer=TMockTokenizer(),
                       num_turns=2)
    assert isinstance(agent, TAgent) and agent.gconfig.n == 1
