"""The grading core of the reward service.

The port's copy of ``areal_tpu/rewards/service.py:43-108``: the verdict
vocabulary, the per-task wall budget and ``grade_task``, the one dispatch
that grades a {task, generated, solutions|input_output} dict. The HTTP
service around it (aiohttp) and the reward-worker fleet come with the
async-PPO loop (ROADMAP.md Queue 1 item 3); until then the port grades
locally, in the calling process.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import logging
from areal_tpu_torch.rewards import code_verify, math_verify

logger = logging.getLogger("rewards.service")

VERDICTS = ("pass", "fail", "timeout", "error", "unsupported_language")

# Worst-case sampled test cases per code grade: the code-task wall-budget
# floor derives from the grader's own cap.
_CODE_MAX_CASES = code_verify.MAX_CASES_DEFAULT


def task_budget_secs(task: Dict[str, Any], base_secs: float) -> float:
    """Wall budget for one task: ``base_secs`` bounds a wedged grader; a
    code task floors at its legal worst case (per-case timeout x the cases
    it carries, capped at the grader's sample bound, + slack)."""
    budget = float(base_secs)
    if task.get("task", "math") == "code":
        n_cases = _CODE_MAX_CASES
        io = task.get("input_output")
        try:
            d = json.loads(io) if isinstance(io, str) else io
            n = len(d.get("inputs", []))
            if n:
                n_cases = min(n, _CODE_MAX_CASES)
        except Exception:  # noqa: BLE001 — malformed io grades 0.0 fast
            pass
        worst = float(task.get("timeout", 8.0)) * n_cases + 5.0
        budget = max(budget, worst)
    return budget


def grade_task(task: Dict[str, Any],
               languages: Optional[List[str]] = None) -> Dict[str, Any]:
    """Grade one {task, generated, solutions|input_output} dict ->
    {score, verdict}. ``languages`` is a service's language policy (None:
    no policy). A grader that raises (sympy missing among the causes) gives
    score 0.0 with verdict "error"."""
    kind = task.get("task", "math")
    try:
        if kind in ("math", "stem"):
            score = math_verify.verify_math(
                task["generated"], task.get("solutions", []))
        elif kind == "code":
            language = task.get("language", "python")
            if (languages is not None and language not in languages) or \
                    language not in code_verify.GRADERS:
                return {"score": 0.0, "verdict": "unsupported_language"}
            score = code_verify.verify_code(
                task["generated"], task.get("input_output", "{}"),
                timeout=float(task.get("timeout", 8.0)), language=language)
        else:
            logger.warning(f"unknown reward task kind {kind}; 0 reward")
            return {"score": 0.0, "verdict": "error"}
    except Exception as e:  # noqa: BLE001 — a bad task must not fail a batch
        logger.warning(f"grading failed ({kind}): {e}")
        return {"score": 0.0, "verdict": "error"}
    return {"score": float(score),
            "verdict": "pass" if score > 0 else "fail"}
