"""Local math answer extraction + grading.

The port's copy of ``areal_tpu/rewards/math_verify.py``. Parity target:
``realhf/impl/dataset/math_parser.py`` (869 LoC) and
``functioncall/math/verify.py:12`` — the rule-based math reward. This is a
native reimplementation of the same contract: extract the final answer from
a generated solution (\\boxed{}, "the answer is", last standalone math
expression) and grade it against any of the ground-truth solutions,
tolerant to formatting (fractions, percents, commas, units, LaTeX noise).
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Optional, Tuple

__all__ = ["extract_answer", "math_equal", "verify_math", "batch_verify_math"]


_BOXED = re.compile(r"\\boxed\s*\{")
_ANSWER_IS = re.compile(
    r"(?:final answer|answer)\s*(?:is|:|=)\s*\$?([^\n$]+)", re.IGNORECASE
)
# Trailing prose after an inline answer ("5, which is prime").
_TRAILING_PROSE = re.compile(r"[,;]?\s+(?:which|because|since|so|as|and)\b.*$")


def _find_boxed(text: str) -> Optional[str]:
    """Last \\boxed{...} with balanced braces."""
    out = None
    for m in _BOXED.finditer(text):
        depth = 1
        i = m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        if depth == 0:
            out = text[m.end() : i - 1]
    return out


def extract_answer(text: str) -> Optional[str]:
    boxed = _find_boxed(text)
    if boxed is not None:
        return boxed.strip()
    m = None
    for m in _ANSWER_IS.finditer(text):
        pass
    if m is not None:
        ans = _TRAILING_PROSE.sub("", m.group(1))
        return ans.strip().rstrip(".").strip()
    # Fall back to the last number in the text.
    nums = re.findall(r"-?\d+(?:/\d+)?(?:\.\d+)?", text)
    return nums[-1] if nums else None


_UNIT_WORDS = (
    "degrees?", "percent", "dollars?", "cents?", "units?", "square", "cubic",
    "meters?", "cm", "mm", "km", "inches", "feet", "ft", "miles?", "hours?",
    "minutes?", "seconds?", "\\\\text\\{[^}]*\\}", "\\\\mathrm\\{[^}]*\\}",
    "\\\\,", "\\\\!", "\\\\;", "\\\\ ",
)


def normalize(ans: str) -> str:
    s = ans.strip()
    s = re.sub(r"\\left|\\right", "", s)
    # Innermost-out rewriting: \sqrt/\frac args may nest ({\sqrt{2}} inside
    # \frac) — iterate until fixpoint, each pass resolving brace-free args.
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"\\sqrt\s*\{([^{}]+)\}", r"sqrt(\1)", s)
        s = re.sub(
            r"\\[dt]?frac\s*\{([^{}]+)\}\s*\{([^{}]+)\}", r"(\1)/(\2)", s
        )
    s = re.sub(r"\\frac\s*(\d)\s*(\d)", r"\1/\2", s)  # \frac12
    s = re.sub(r"\\pi", "pi", s)
    s = re.sub(r"\\cdot|\\times", "*", s)
    s = re.sub("|".join(_UNIT_WORDS), "", s)
    s = s.replace("\\%", "%").replace("$", "").replace("°", "")
    s = s.replace("{", "(").replace("}", ")").replace("^", "**")
    s = re.sub(r"(?<=\d),(?=\d{3}\b)", "", s)  # thousands separators
    s = re.sub(r"\s+", "", s)
    s = s.rstrip(".")
    return s


def _as_number(s: str) -> Optional[Fraction]:
    s = s.strip()
    neg = False
    if s.startswith("(") and s.endswith(")"):
        s = s[1:-1]
    if s.startswith("-"):
        neg, s = True, s[1:]
    pct = s.endswith("%")
    if pct:
        s = s[:-1]
    # mixed numbers: "1(1)/(2)" (normalized "1\frac{1}{2}") → 3/2; parens
    # required — "12/5" must stay 12/5, not 1+2/5
    m = re.fullmatch(r"(\d+)\((\d+)\)/\((\d+)\)", s)
    if m:
        whole, num, den = map(int, m.groups())
        v: Optional[Fraction] = Fraction(whole) + Fraction(num, den)
    else:
        try:
            m = re.fullmatch(r"\(?([^()/]+)\)?/\(?([^()/]+)\)?", s)
            if m:
                v = Fraction(m.group(1)) / Fraction(m.group(2))
            elif re.fullmatch(r"-?\d+(?:\.\d+)?[eE][+-]?\d+", s):
                v = Fraction(float(s))  # scientific notation
            else:
                v = Fraction(s)
        except (ValueError, ZeroDivisionError, OverflowError):
            return None
    if pct:
        v /= 100
    return -v if neg else v


_CHOICES = ("a", "b", "c", "d", "e")
_MATRIX = re.compile(
    r"\\begin\{[pb]matrix\}(.*)\\end\{[pb]matrix\}", re.DOTALL
)


def _choice_clean(pred: str) -> Optional[str]:
    """Last standalone choice letter in the prediction (reference
    choice_answer_clean)."""
    hits = re.findall(r"\b([A-Ea-e])\b", pred.strip().strip(".:()"))
    return hits[-1].lower() if hits else None


def _numeric_equal(vp: Fraction, vr: Fraction, rel_tol: float) -> bool:
    # Percentage ambiguity (reference math_equal include_percentage): accept
    # the reference at 1x, /100 and *100 scales.
    for item in (vr, vr / 100, vr * 100):
        if vp == item:
            return True
        try:
            denom = max(abs(float(item)), 1e-12)
            if abs(float(vp - item)) / denom < rel_tol:
                return True
        except OverflowError:
            # >~308-digit integers overflow float(); exact equality was
            # already checked above, and values this size differing by
            # less than rel_tol·value cannot be distinguished anyway —
            # treat as unequal rather than crash the reward path.
            continue
    return False


def _split_top_level(s: str) -> List[str]:
    """Split on commas not nested in brackets."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _symbolic_equal_inprocess(a: str, b: str) -> bool:
    try:
        import sympy
        from sympy.parsing.sympy_parser import (
            implicit_multiplication_application,
            parse_expr,
            standard_transformations,
        )

        tf = standard_transformations + (
            implicit_multiplication_application,
        )

        def p(s):
            return parse_expr(normalize(s), transformations=tf)

        ea, eb = p(a), p(b)
        if ea == eb:
            return True
        return sympy.simplify(ea - eb) == 0
    except Exception:  # noqa: BLE001 — unparseable ⇒ not equal
        return False


def _symbolic_child(a: str, b: str, q) -> None:
    q.put(_symbolic_equal_inprocess(a, b))


def _symbolic_equal(a: str, b: str, timeout: float = 3.0) -> bool:
    """sympy difference-is-zero check in a KILLABLE subprocess (reference
    math_parser.py:686 call_with_timeout): even short inputs can explode —
    '3^3^3^3' parses to 3**3**27 and sympy eagerly evaluates the integer —
    so a length cap alone cannot bound CPU. A hung grader would stall the
    whole rollout/reward path."""
    if len(a) > 192 or len(b) > 192:
        return False
    import multiprocessing as mp

    # Pre-import sympy in the PARENT: forked children inherit the loaded
    # module. Without this every fork re-imports sympy from disk (~1s),
    # eating the timeout and nondeterministically failing genuinely-equal
    # symbolic answers on a loaded host.
    import sympy  # noqa: F401
    import sympy.parsing.sympy_parser  # noqa: F401

    ctx = mp.get_context("fork")
    q = ctx.Queue()
    proc = ctx.Process(target=_symbolic_child, args=(a, b, q), daemon=True)
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join(1.0)
        if proc.is_alive():
            proc.kill()
        return False
    try:
        return bool(q.get_nowait())
    except Exception:  # noqa: BLE001 — child died without an answer
        return False


def math_equal(pred: str, ref: str, rel_tol: float = 1e-4) -> bool:
    """Semantic parity with the reference grader (math_parser.py:497):
    string/MC/numeric(+percent)/tuple/matrix/equation/symbolic, in order."""
    if pred is None or ref is None:
        return False
    pred, ref = str(pred).strip(), str(ref).strip()
    if pred.lower() == ref.lower():
        return True
    # multiple choice
    if ref.strip(".:() ").lower() in _CHOICES and len(ref.strip(".:() ")) == 1:
        return _choice_clean(pred) == ref.strip(".:() ").lower()

    np_, nr = normalize(pred), normalize(ref)
    if np_ == nr:
        return True
    vp, vr = _as_number(np_), _as_number(nr)
    if vp is not None and vr is not None:
        return _numeric_equal(vp, vr, rel_tol)

    # Bracket-sensitive comparison. NOTE (deviation from the reference,
    # which strips all brackets): "(0,1]" and "[0,1)" are DIFFERENT
    # intervals — equal content with different bracket types must not
    # grade 1.0, so stripping/element-wise paths require the SAME bracket
    # characters at both ends.
    both_bracketed = (
        re.fullmatch(r"[\[(].+[\])]", np_) and re.fullmatch(r"[\[(].+[\])]", nr)
    )
    same_brackets = (
        not both_bracketed or (np_[0] == nr[0] and np_[-1] == nr[-1])
    )
    if (
        same_brackets
        and np_.strip("[]()") == nr.strip("[]()")
        and np_.strip("[]()")
    ):
        return True

    # tuples / intervals / coordinate lists: element-wise, order-sensitive
    if both_bracketed and same_brackets:
        pp, rr = _split_top_level(np_[1:-1]), _split_top_level(nr[1:-1])
        if len(pp) == len(rr) and len(pp) > 1:
            if all(math_equal(a, b, rel_tol) for a, b in zip(pp, rr)):
                return True

    # pmatrix/bmatrix: element-wise over rows (\\\\) and cols (&)
    mp_, mr = _MATRIX.search(pred), _MATRIX.search(ref)
    if mp_ and mr:
        rows_p = [r for r in mp_.group(1).split("\\\\") if r.strip()]
        rows_r = [r for r in mr.group(1).split("\\\\") if r.strip()]
        if len(rows_p) == len(rows_r):
            ok = True
            for rp, rr_ in zip(rows_p, rows_r):
                cp, cr = rp.split("&"), rr_.split("&")
                if len(cp) != len(cr) or not all(
                    math_equal(a, b, rel_tol) for a, b in zip(cp, cr)
                ):
                    ok = False
                    break
            if ok:
                return True

    # equations: "lhs = rhs" on both sides → difference equivalence (either
    # sign); single short-LHS assignment vs bare value → compare the value
    if pred.count("=") == 1 and ref.count("=") == 1:
        pl, pr_ = (x.strip() for x in pred.split("="))
        rl, rr_ = (x.strip() for x in ref.split("="))
        da, db = f"({pl})-({pr_})", f"({rl})-({rr_})"
        if _symbolic_equal(da, db) or _symbolic_equal(f"-({da})", db):
            return True
    elif pred.count("=") == 1 and len(pred.split("=")[0].strip()) <= 2:
        if math_equal(pred.split("=")[1], ref, rel_tol):
            return True
    elif ref.count("=") == 1 and len(ref.split("=")[0].strip()) <= 2:
        if math_equal(pred, ref.split("=")[1], rel_tol):
            return True

    return _symbolic_equal(np_, nr)


def verify_math(generated: str, solutions: List[str]) -> float:
    """1.0 if the extracted answer matches ANY ground-truth solution.
    Ground-truth entries may themselves contain \\boxed{} (full solutions)
    or be bare answers."""
    pred = extract_answer(generated)
    if pred is None:
        return 0.0
    for sol in solutions:
        ref = extract_answer(sol) if ("\\boxed" in sol or len(sol) > 64) else sol
        if ref is not None and math_equal(pred, ref):
            return 1.0
    return 0.0


def batch_verify_math(
    pairs: List[Tuple[str, List[str]]],
) -> List[float]:
    return [verify_math(g, s) for g, s in pairs]
