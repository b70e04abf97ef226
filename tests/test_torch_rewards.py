"""The port's rule-based rewards and prompt dataset against the reference:
``rewards/math_verify.py`` on every pair of the math parity corpus,
``rewards/code_verify.py`` on ``make_code_jsonl`` records (passing and
failing programs), ``rewards/service.grade_task``,
``algorithms/reward.MultiTaskRewardInterface.inference`` on planted
trajectories, and ``datasets/jsonl.MathCodePromptDataset`` items. Every
comparison is exact."""

import json
import os

import numpy as np
import pytest

from areal_tpu.algorithms.reward import MultiTaskRewardInterface as JRw
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.api.model import Model as JModel
from areal_tpu.base import testing as jtesting
from areal_tpu.datasets.jsonl import MathCodePromptDataset as JDataset
from areal_tpu.rewards import code_verify as jcode
from areal_tpu.rewards import math_verify as jmath
from areal_tpu.rewards import service as jservice
from areal_tpu_torch.algorithms.reward import MultiTaskRewardInterface as TRw
from areal_tpu_torch.api.data import SequenceSample as TSample
from areal_tpu_torch.api.model import Model as TModel
from areal_tpu_torch.base import testing as ttesting
from areal_tpu_torch.datasets.jsonl import MathCodePromptDataset as TDataset
from areal_tpu_torch.rewards import client as tclient
from areal_tpu_torch.rewards import code_verify as tcode
from areal_tpu_torch.rewards import math_verify as tmath
from areal_tpu_torch.rewards import service as tservice

CORPUS = os.path.join(os.path.dirname(__file__), "fixtures",
                      "math_parity_corpus.jsonl")


def test_verify_math_matches_the_reference_on_the_corpus():
    with open(CORPUS) as f:
        entries = [json.loads(ln) for ln in f if ln.strip()]
    assert len(entries) >= 200
    differ = [e["id"] for e in entries
              if tmath.verify_math(e["generated"], e["solutions"])
              != jmath.verify_math(e["generated"], e["solutions"])]
    assert differ == []


def _programs(record):
    """A passing program, a failing one and a reply with no code, for a
    make_code_jsonl record ("reads x and prints x+k")."""
    k = int(record["prompt"].rsplit("+", 1)[1].rstrip(". "))
    ok = f"```python\nx = int(input())\nprint(x + {k})\n```"
    bad = f"```python\nx = int(input())\nprint(x + {k + 1})\n```"
    return [(ok, 1.0), (bad, 0.0), ("no program here", 0.0)]


def test_verify_code_matches_the_reference(tmp_path):
    records = ttesting.make_code_jsonl(str(tmp_path / "code.jsonl"), n=3)
    assert records == jtesting.make_code_jsonl(str(tmp_path / "j.jsonl"), n=3)
    for r in records:
        for text, want in _programs(r):
            got = tcode.verify_code(text, r["input_output"])
            assert got == jcode.verify_code(text, r["input_output"]) == want


def test_grade_task_matches_the_reference(tmp_path):
    code = ttesting.make_code_jsonl(str(tmp_path / "code.jsonl"), n=1)[0]
    tasks = [
        {"task": "math", "generated": "so \\boxed{4}", "solutions": ["4"]},
        {"task": "math", "generated": "\\boxed{5}", "solutions": ["4"]},
        {"task": "code", "generated": _programs(code)[0][0],
         "input_output": code["input_output"]},
        {"task": "code", "generated": _programs(code)[0][0],
         "input_output": code["input_output"], "language": "cobol"},
        {"task": "poetry", "generated": "x"},
    ]
    for t in tasks:
        got = tservice.grade_task(dict(t))
        assert got == jservice.grade_task(dict(t)), t
        assert got["verdict"] in tservice.VERDICTS
    assert tservice.task_budget_secs(tasks[2], 1.0) == \
        jservice.task_budget_secs(tasks[2], 1.0)


def test_mock_tokenizer_matches_the_reference():
    tt, jt = ttesting.MockTokenizer(), jtesting.MockTokenizer()
    text = "What is 3+4? \\boxed{7} é"
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text)) == text
    for tok in (tt, jt):  # ids past the byte range do not decode
        with pytest.raises(ValueError):
            tok.decode([300])


def _planted(pkg, records, tok):
    """One trajectory per (record, reply): prompt tokens then the reply's,
    ids "qid@k" as a flattened group has them."""
    Sample = TSample if pkg == "port" else JSample
    samples = []
    for r in records:
        if r["task"] == "math":
            answer = r["solutions"][0]
            replies = [f"The answer is {answer}.", "\\boxed{-1}", "no idea"]
        else:
            replies = [t for t, _ in _programs(r)]
        for k, reply in enumerate(replies):
            p, g = tok.encode(r["prompt"]), tok.encode(reply)
            samples.append(Sample.from_default(
                ids=[f"{r['query_id']}@{k}"], seqlens=[len(p) + len(g)],
                data={"packed_input_ids": np.asarray(p + g, np.int32),
                      "prompt_mask": np.asarray([1] * len(p) + [0] * len(g),
                                                np.int32),
                      "task_ids": np.asarray(
                          [0 if r["task"] == "math" else 1], np.int32)}))
    return Sample.gather(samples)


def test_reward_interface_matches_the_reference(tmp_path):
    path = str(tmp_path / "mixed.jsonl")
    records = ttesting.make_mixed_jsonl(path, n_math=3, n_code=2)
    scores = {}
    for pkg, Rw, Mdl, tok in (
            ("port", TRw, TModel, ttesting.MockTokenizer()),
            ("ref", JRw, JModel, jtesting.MockTokenizer())):
        out = Rw(dataset_path=path).inference(
            Mdl("rw", None, tokenizer=tok), _planted(pkg, records, tok), None)
        scores[pkg] = (list(out.ids), np.asarray(out.data["rewards"]))
    assert scores["port"][0] == scores["ref"][0]
    np.testing.assert_array_equal(scores["port"][1], scores["ref"][1])
    # every record: the right reply scores 1, the others 0
    np.testing.assert_array_equal(
        scores["port"][1], np.tile([1.0, 0.0, 0.0], len(records)))


def test_math_code_dataset_items_match_the_reference(tmp_path):
    path = str(tmp_path / "mixed.jsonl")
    ttesting.make_mixed_jsonl(path, n_math=5, n_code=3)
    kw = dict(dataset_path=path, max_length=24)
    t = TDataset(tokenizer=ttesting.MockTokenizer(), **kw)
    j = JDataset(tokenizer=jtesting.MockTokenizer(), **kw)
    assert len(t) == len(j) == 8
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a.ids == b.ids
        assert a.seqlens == b.seqlens and a.metadata == b.metadata
        for key in ("packed_prompts", "task_ids"):
            np.testing.assert_array_equal(a.data[key], b.data[key])
            assert a.data[key].dtype == b.data[key].dtype


def test_batch_reward_refuses_the_remote_service(monkeypatch):
    """With FUNCTIONCALL_SERVICE_DOMAIN set, the port grades on that host
    (here a port reward worker) and nothing locally; the reference's client
    on the same host answers the same. With the variable unset, grading
    stays local. (The name is the one this test had when the port refused
    the variable; it keeps it so that its history can be followed.)"""
    from areal_tpu.rewards import client as jclient
    from areal_tpu_torch.api.train_config import RewardServiceConfig
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.system.reward_worker import (
        RewardWorker,
        RewardWorkerConfig,
    )

    task = {"task": "math", "generated": "\\boxed{4}", "solutions": ["4"]}
    assert tclient.batch_reward([task]) == [1.0]
    monkeypatch.setattr(tnr, "DEFAULT_REPO", tnr.MemoryNameRecordRepo())
    w = RewardWorker(RewardWorkerConfig(
        reward=RewardServiceConfig(enabled=True)))
    url = w.start()
    try:
        monkeypatch.setenv(tclient.SERVICE_ENV, url.split("//", 1)[1])
        before = dict(tclient.verdict_counts)
        assert tclient.batch_reward([task, {**task, "solutions": ["5"]}]) \
            == [1.0, 0.0]
        assert w.service._graded == 2
        assert dict(tclient.verdict_counts) == before  # nothing local
        assert jclient.batch_reward([task]) == [1.0]
        assert w.service._graded == 3
    finally:
        w.stop()
