"""Rule-based multi-task reward interface (math + code).

The port's copy of ``areal_tpu/algorithms/reward.py`` (reference
``realhf/impl/model/interface/math_rw_interface.py:181``,
``MultiTaskRewardInterface``, registered "rw-math-code"): decode the
generated suffix of each trajectory, grade it per ``task_ids`` with the math
or the code verifier, and emit one scalar reward per sequence. No learned
reward model is involved: the reward role holds only a tokenizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Optional

import numpy as np

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import Model, ModelInterface, register_interface
from areal_tpu_torch.base import logging
from areal_tpu_torch.datasets.jsonl import RL_TASKS, load_jsonl
from areal_tpu_torch.rewards.client import batch_reward, task_from_record

logger = logging.getLogger("algorithms.reward")


@dataclasses.dataclass
class MultiTaskRewardInterface(ModelInterface):
    """``id2info`` maps query_id → dataset record ({"task", "solutions",
    "input_output", ...}); built from ``dataset_path`` when given. Sample ids
    are "qid@k" (flattened groups) or bare qids."""

    dataset_path: Optional[str] = None
    id2info: Optional[Dict[Hashable, Dict[str, Any]]] = None
    group_size: int = 1
    check_verifier_status: bool = False

    def __post_init__(self):
        if self.id2info is None and self.dataset_path:
            self.id2info = {
                str(d["query_id"]): d for d in load_jsonl(self.dataset_path)
            }
        self.id2info = self.id2info or {}

    def _lookup(self, sample_id: Hashable) -> Dict[str, Any]:
        # ids carry "@"-separated suffixes (group index, epoch-pass tag);
        # the dataset key is everything before the first "@".
        qid = str(sample_id).split("@", 1)[0]
        return self.id2info.get(qid, {})

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        tok = model.tokenizer
        offs = data.offsets("packed_input_ids")
        lens = data.total_lens("packed_input_ids")
        pm = np.asarray(data.data["prompt_mask"])
        task_ids = np.asarray(
            data.data.get("task_ids", np.zeros(data.bs, np.int32))
        ).reshape(-1)
        tasks = []
        for i in range(data.bs):
            span = slice(int(offs[i]), int(offs[i] + lens[i]))
            gen_tokens = data.data["packed_input_ids"][span][pm[span] == 0]
            text = tok.decode(gen_tokens) if tok is not None else ""
            info = self._lookup(data.ids[i])
            # The kind falls back to the sample's task_ids when the record
            # is missing.
            kind = info.get("task") or RL_TASKS[int(task_ids[i])]
            tasks.append(task_from_record({**info, "task": kind}, text))
        scores = np.asarray(batch_reward(tasks), np.float32)
        if self.check_verifier_status and float(np.abs(scores).sum()) == 0:
            logger.warning(
                "all rewards are zero — check the verifier / dataset wiring")
        logger.info(f"reward batch: n={data.bs} mean={scores.mean():.3f} "
                    f"solve_rate={(scores > 0).mean():.3f}")
        return SequenceSample.from_default(
            ids=list(data.ids),
            data={"rewards": scores},
            seqlens=[1] * data.bs,
        )


register_interface("rw_math_code", MultiTaskRewardInterface)
register_interface("rw-math-code", MultiTaskRewardInterface)
