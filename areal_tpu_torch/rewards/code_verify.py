"""Local sandboxed code verification.

The port's copy of ``areal_tpu/rewards/code_verify.py``. Parity target:
``functioncall/code/local_verify.py`` + ``testing_util.py`` (the
reference's local fallback when no remote FUNCTIONCALL_SERVICE_DOMAIN is
configured). Runs a generated python solution against the dataset's
``input_output`` test cases in a subprocess with time/output limits.

Two test-case styles (same as the reference / LiveCodeBench):
 - stdin/stdout: inputs/outputs are raw text, the program reads stdin;
 - fn_name: inputs are argument lists, outputs the expected return values.
"""

from __future__ import annotations

import json
import os
import re
import resource
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from areal_tpu_torch.base import logging

logger = logging.getLogger("rewards.code")

_CODE_BLOCK = re.compile(r"```(?:python|py)?\n(.*?)```", re.DOTALL)
MAX_OUTPUT_BYTES = 4 * 1024 * 1024  # cap read-back of graded program output

# Sandbox limits for the graded program (reference
# functioncall/code/function/testing_util.py:702-760 reliability_guard:
# rlimits + os/builtins disarm before running untrusted model code).
MEM_LIMIT_BYTES = 1024 * 1024 * 1024  # RLIMIT_AS
FSIZE_LIMIT_BYTES = 64 * 1024 * 1024  # RLIMIT_FSIZE

# Default cap on test cases sampled per grade. THE shared constant: the
# reward service's wall-budget floor (rewards/service.py task_budget_secs)
# and the pass-rate agent's fanout cap (agents/code_single_step.py)
# derive from it — a larger per-call max_cases must come with a larger
# grade/request budget.
MAX_CASES_DEFAULT = 16

# Injected ABOVE the untrusted code: disarm os-level footguns and
# escape hatches inside the child (belt; the rlimits below are braces).
_GUARD = """\
import builtins as _b
import os as _os
import sys as _s
_s.setrecursionlimit(100000)
for _name in (
    "system", "popen", "execv", "execve", "execvp", "execvpe", "fork",
    "forkpty", "spawnl", "spawnv", "spawnve", "killpg", "kill", "rename",
    "renames", "truncate", "replace", "unlink", "removedirs", "rmdir",
    "remove", "chmod", "chown", "chroot", "lchown", "setuid", "setgid",
    "fchmod", "fchown", "putenv",
):
    if hasattr(_os, _name):
        setattr(_os, _name, None)
_b.exit = None
_b.quit = None
try:
    import shutil as _sh
    _sh.rmtree = None
    _sh.move = None
    _sh.chown = None
except Exception:
    pass
try:
    import subprocess as _sp
    _sp.Popen = None
    _sp.run = None
    _sp.call = None
    _sp.check_output = None
except Exception:
    pass
del _b, _os, _s, _name
"""


def _child_limits(cpu_seconds: int):
    """preexec_fn for the grading subprocess: hard rlimits. Runs between
    fork and exec, so it must not import or allocate — ``resource`` is
    captured from the module scope (imported at module load) and the
    session split is done by ``start_new_session=True``, not os.setsid
    here (fork-safety in a multithreaded parent)."""

    def fn():
        resource.setrlimit(resource.RLIMIT_CPU, (cpu_seconds, cpu_seconds + 1))
        resource.setrlimit(
            resource.RLIMIT_FSIZE, (FSIZE_LIMIT_BYTES, FSIZE_LIMIT_BYTES)
        )
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        try:
            resource.setrlimit(
                resource.RLIMIT_AS, (MEM_LIMIT_BYTES, MEM_LIMIT_BYTES)
            )
        except ValueError:
            pass

    return fn


def extract_code(text: str) -> Optional[str]:
    blocks = _CODE_BLOCK.findall(text)
    if blocks:
        return blocks[-1].strip()
    if "def " in text or "print(" in text or "input(" in text:
        return text.strip()
    return None


_FN_RUNNER = """
import json, sys
{code}
_args = json.loads(sys.stdin.read())
_res = {fn_name}(*_args)
print(json.dumps(_res))
"""


def _run_one(
    code: str,
    stdin: str,
    timeout: float,
    fn_name: Optional[str] = None,
) -> Tuple[bool, str]:
    if fn_name:
        src = _FN_RUNNER.format(code=code, fn_name=fn_name)
    else:
        src = code
    src = _GUARD + src
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(src)
        path = f.name
    # Spool stdout/stderr to files so a print-flood program can't balloon
    # the trainer host's RSS; read back capped.
    out_f = tempfile.NamedTemporaryFile("w+", delete=False)
    err_f = tempfile.NamedTemporaryFile("w+", delete=False)
    scratch = tempfile.mkdtemp(prefix="areal_sbx_")
    proc = None

    def _reap_group(p) -> None:
        """SIGKILL the graded program's whole session, then reap the
        leader. Callers guarantee the leader is alive or an UNREAPED
        zombie — the zombie pins the pid/pgid, so this killpg can never
        hit an unrelated (recycled) process group."""
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        p.wait()

    try:
        proc = subprocess.Popen(
            [sys.executable, path],
            stdin=subprocess.PIPE,
            stdout=out_f,
            stderr=err_f,
            text=True,
            cwd=scratch,
            env={"PATH": os.environ.get("PATH", ""), "HOME": scratch,
                 "OMP_NUM_THREADS": "1"},
            start_new_session=True,
            preexec_fn=_child_limits(int(timeout) + 1),
        )
        # stdin fed from a side thread (communicate()'s deadlock
        # avoidance) because the wait below must NOT reap the child:
        # communicate/wait/poll all reap on exit, and killing the
        # process group through a REAPED leader's pid would race pid
        # recycling. waitid(WNOWAIT) observes exit while leaving the
        # zombie in place, so the group sweep in _reap_group — which
        # must run on EVERY exit path: fn_name solutions that spawned
        # children, or a leader that exited leaving grandchildren,
        # cannot outlive their grading slot — always targets OUR group.
        import threading

        def _feed():
            try:
                if stdin:
                    proc.stdin.write(stdin)
                proc.stdin.close()
            except (BrokenPipeError, OSError, ValueError):
                pass  # child exited without reading; its verdict decides

        threading.Thread(target=_feed, daemon=True).start()

        def _exited() -> bool:
            return os.waitid(
                os.P_PID, proc.pid,
                os.WEXITED | os.WNOHANG | os.WNOWAIT,
            ) is not None

        deadline = time.monotonic() + timeout
        while not (exited := _exited()) and time.monotonic() < deadline:
            time.sleep(0.005)
        # One FINAL check past the deadline: a program that exited during
        # the last sleep slice (or a GIL-delayed wakeup) finished within
        # its budget and must not be misgraded as a timeout.
        timed_out = not exited and not _exited()
        _reap_group(proc)  # group sweep + reap (sets returncode)
        if timed_out:
            return False, "timeout"
        err_f.seek(0)
        if proc.returncode != 0:
            return False, err_f.read(500)
        out_f.seek(0)
        return True, out_f.read(MAX_OUTPUT_BYTES)
    finally:
        import shutil

        # Exception path (spawn/waitid raised): the leader, if any, was
        # never reaped — the sweep is still pid-safe.
        if proc is not None and proc.returncode is None:
            _reap_group(proc)
        for fh in (out_f, err_f):
            fh.close()
            os.unlink(fh.name)
        os.unlink(path)
        shutil.rmtree(scratch, ignore_errors=True)


def sample_cases(inputs: List, outputs: List,
                 max_cases: int = MAX_CASES_DEFAULT) -> List[Tuple]:
    """Deterministic (input, output) sample honoring ``max_cases`` for
    EVERY length via a ceil-division stride (floor division let sizes
    just above the cap through at full count). THE sampling policy —
    the strict grader here and the pass-rate agent
    (agents/code_single_step.py) must pick the same cases."""
    cases = list(zip(inputs, outputs))
    if not cases:
        return []
    step = -(-len(cases) // max(int(max_cases), 1))
    return cases[::step]


def _outputs_match(got: str, want: str) -> bool:
    g = [l.rstrip() for l in got.strip().splitlines()]
    w = [l.rstrip() for l in want.strip().splitlines()]
    if g == w:
        return True
    # numeric comparison fallback (whitespace/format tolerant)
    try:
        gn = [float(x) for x in got.split()]
        wn = [float(x) for x in want.split()]
        return len(gn) == len(wn) and all(
            abs(a - b) <= 1e-6 * max(1.0, abs(b)) for a, b in zip(gn, wn)
        )
    except ValueError:
        return False


def verify_code(
    generated: str,
    input_output: str | Dict,
    timeout: float = 8.0,
    max_cases: int = MAX_CASES_DEFAULT,
    language: str = "python",
) -> float:
    """1.0 iff the extracted program passes ALL (sampled) test cases.

    ``language`` dispatches through :data:`GRADERS`; an unregistered
    language grades 0.0 (logged) instead of raising, so a mixed-language
    dataset degrades per task rather than killing the reward path."""
    grader = GRADERS.get(language)
    if grader is None:
        logger.warning(
            f"no grader registered for language {language!r} "
            f"(available: {', '.join(sorted(GRADERS))}); 0 reward"
        )
        return 0.0
    return grader(generated, input_output, timeout=timeout,
                  max_cases=max_cases)


def _verify_code_python(
    generated: str,
    input_output: str | Dict,
    timeout: float = 8.0,
    max_cases: int = MAX_CASES_DEFAULT,
) -> float:
    code = extract_code(generated)
    if code is None:
        return 0.0
    io = json.loads(input_output) if isinstance(input_output, str) else input_output
    inputs = io.get("inputs", [])
    outputs = io.get("outputs", [])
    fn_name = io.get("fn_name")
    if not inputs:
        return 0.0
    for inp, want in sample_cases(inputs, outputs, max_cases):
        if fn_name:
            stdin = inp if isinstance(inp, str) else json.dumps(inp)
            ok, got = _run_one(code, stdin, timeout, fn_name=fn_name)
            if not ok:
                return 0.0
            try:
                want_v = json.loads(want) if isinstance(want, str) else want
                got_v = json.loads(got)
                if got_v != want_v and not (
                    isinstance(want_v, list) and got_v == want_v[0]
                ):
                    return 0.0
            except (json.JSONDecodeError, IndexError):
                return 0.0
        else:
            ok, got = _run_one(code, inp, timeout)
            if not ok or not _outputs_match(got, want):
                return 0.0
    return 1.0


# Per-task language dispatch (docs/rewards.md): the reward service routes
# each code task's ``language`` field (default "python") through this
# registry, so C++/bash graders slot in as new entries — subprocess +
# rlimit guard included — without touching the service or client.
GRADERS: Dict[str, Any] = {"python": _verify_code_python}


def register_grader(language: str, fn) -> None:
    """Register a code grader: ``fn(generated, input_output, *, timeout,
    max_cases) -> float``. New-language graders MUST sandbox like the
    python one (subprocess + ``_child_limits`` rlimits +
    ``start_new_session`` with a finally-killpg sweep)."""
    GRADERS[language] = fn


def batch_verify_code(
    pairs: List[Tuple[str, str | Dict]], timeout: float = 8.0
) -> List[float]:
    return [verify_code(g, io, timeout=timeout) for g, io in pairs]
