"""Character error rate engine (the port's copy of ``ttasr/text/cer.py``).

Behavioural parity with the reference ``cer.py`` (
``HOMOPHONE_MAPPING`` at :7-15, ``arabic_to_chinese_number`` at :41-85,
``clean_text`` at :89-137, ``calculate_cer`` at :141-297, ``compare_texts``
at :301-315), re-implemented from the observed contract:

- Alignment uses ``difflib.SequenceMatcher`` opcodes (NOT minimal edit
  distance — parity requires difflib's matching-block semantics).
- A ``replace`` span counts ``min(len(ref), len(hyp))`` substitutions; the
  overflow is counted as insertions (hyp longer) or deletions (ref longer).
- Highlight markup: ``[x]`` substitution, ``<x>`` deletion, ``(x)``
  insertion, ``□`` placeholder on the opposite side; a blank line is
  inserted every >=250 processed characters (ref+hyp span lengths summed).
- CER = (S + D + I) / N with N = len(cleaned reference).

For training/eval where a true minimal-edit-distance CER is wanted (the
reference uses ``evaluate.load("cer")`` in ``train_asr.py:662-675``), use
:func:`cer_metric`, which is Levenshtein-based.
"""

from __future__ import annotations

import difflib
import re
from dataclasses import dataclass, field
from typing import List, Optional

# Forced homophone / variant folding applied before comparison
# (reference cer.py:7-15). Identity entries are kept for surface parity.
HOMOPHONE_MAPPING = {
    "她": "他",
    "它": "他",
    "臺": "台",
    "著": "著",
    "的": "的",
    "得": "的",
}

_CJK_ALPHA_RE = re.compile(r"[^一-龥a-zA-Z]")
_DIGITS_RE = re.compile(r"\d+")

_CN_DIGITS = "零一二三四五六七八九"
# Positional units indexed by power of ten (reference cer.py:49).
_CN_UNITS = ["", "十", "百", "千", "萬", "十萬", "百萬", "千萬", "億"]

# Highlight layout constant (reference cer.py:159).
_BREAK_INTERVAL = 250


def arabic_to_chinese_number(num_str: str) -> str:
    """Convert an ASCII digit string to Chinese numerals.

    Digit-sequence mode (digit-by-digit) when the string has a leading zero
    with length > 1, or is longer than 9 digits; positional mode otherwise.
    Mirrors reference cer.py:41-85.
    """
    if (num_str.startswith("0") and len(num_str) > 1) or len(num_str) > 9:
        return "".join(_CN_DIGITS[int(d)] for d in num_str)

    try:
        canonical = str(int(num_str))
    except ValueError:
        return ""

    n = len(canonical)
    parts: List[str] = []
    pending_zero = False
    for i, ch in enumerate(canonical):
        d = int(ch)
        if d == 0:
            pending_zero = True
            continue
        if pending_zero:
            parts.append(_CN_DIGITS[0])
            pending_zero = False
        parts.append(_CN_DIGITS[d] + _CN_UNITS[n - i - 1])

    if not parts:
        return _CN_DIGITS[0]
    if parts[-1] == _CN_DIGITS[0] and len(parts) > 1:
        parts.pop()
    if len(parts) == 2 and parts[0] == "一十":
        parts[0] = "十"
    return "".join(parts)


def _convert_digit_runs(text: str) -> str:
    return _DIGITS_RE.sub(lambda m: arabic_to_chinese_number(m.group(0)), text)


def clean_text(text: str, to_lower: bool = True) -> str:
    """Normalize text for CER comparison (reference cer.py:89-137).

    Steps: strip CR/LF, fold homophones, convert Arabic digit runs to
    Chinese numerals, keep only CJK (U+4E00–U+9FA5) and ASCII letters,
    lowercase.  Note the reference lowercases regardless of ``to_lower``
    (cer.py:137); we reproduce that.
    """
    out = text.replace("\n", "").replace("\r", "")
    for old, new in HOMOPHONE_MAPPING.items():
        out = out.replace(old, new)
    out = _convert_digit_runs(out)
    out = _CJK_ALPHA_RE.sub("", out)
    return out.lower()


@dataclass
class CERResult:
    """CER comparison outcome (field set mirrors reference cer.py:18-37)."""

    reference_text: str
    hypothesis_text: str
    reference_cleaned: str = ""
    hypothesis_cleaned: str = ""
    correct_rate: float = 0.0
    cer_rate: float = 0.0
    total_errors: int = 0
    substitutions_count: int = 0
    deletions_count: int = 0
    insertions_count: int = 0
    total_chars: int = 0
    substitutions_errors: List[str] = field(default_factory=list)
    deletions_errors: List[str] = field(default_factory=list)
    insertions_errors: List[str] = field(default_factory=list)
    reference_highlighted: str = ""
    hypothesis_highlighted: str = ""

    def to_dict(self) -> dict:
        """JSON payload shape used by asr_comparison_results.json
        (reference asr_core.py:212-225)."""
        return {
            "correct_rate": self.correct_rate,
            "cer_rate": self.cer_rate,
            "total_errors": self.total_errors,
            "substitutions_count": self.substitutions_count,
            "deletions_count": self.deletions_count,
            "insertions_count": self.insertions_count,
            "total_chars": self.total_chars,
            "substitutions_errors": self.substitutions_errors,
            "deletions_errors": self.deletions_errors,
            "insertions_errors": self.insertions_errors,
            "reference_highlighted": self.reference_highlighted,
            "hypothesis_highlighted": self.hypothesis_highlighted,
        }


class _HighlightBuilder:
    """Accumulates the two marked-up strings with the 250-char line breaks."""

    def __init__(self) -> None:
        self.ref_parts: List[str] = []
        self.hyp_parts: List[str] = []
        self._span_chars = 0

    def add(self, ref_piece: str, hyp_piece: str) -> None:
        self.ref_parts.append(ref_piece)
        self.hyp_parts.append(hyp_piece)

    def end_opcode(self, ref_span: int, hyp_span: int) -> None:
        self._span_chars += ref_span + hyp_span
        if self._span_chars >= _BREAK_INTERVAL:
            self.ref_parts.append("\n\n")
            self.hyp_parts.append("\n\n")
            self._span_chars = 0

    def build(self) -> tuple:
        return "".join(self.ref_parts), "".join(self.hyp_parts)


def calculate_cer(reference: str, hypothesis: str) -> CERResult:
    """Compute CER with difflib-opcode accounting and highlight markup.

    Parity contract: reference cer.py:141-297.
    """
    res = CERResult(reference, hypothesis)
    res.reference_cleaned = clean_text(reference)
    res.hypothesis_cleaned = clean_text(hypothesis)
    ref, hyp = res.reference_cleaned, res.hypothesis_cleaned

    sm = difflib.SequenceMatcher(None, ref, hyp)
    hl = _HighlightBuilder()
    subs = dels = ins = 0

    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        rpiece, hpiece = ref[i1:i2], hyp[j1:j2]
        if tag == "equal":
            hl.add(rpiece, hpiece)
        elif tag == "replace":
            k = min(len(rpiece), len(hpiece))
            subs += k
            res.substitutions_errors.append(
                f"正確文本中的「{rpiece}」 在 ASR 轉譯文本中被替換成 「{hpiece}」"
            )
            hl.add(
                "".join(f"[{c}]" for c in rpiece[:k]),
                "".join(f"[{c}]" for c in hpiece[:k]),
            )
            if len(rpiece) > len(hpiece):
                extra = len(rpiece) - k
                dels += extra
                res.deletions_errors.append(
                    f"正確文本中的「{rpiece[k:]}」 被刪除，未被 ASR 轉譯成功 (替換造成)"
                )
                hl.add("".join(f"<{c}>" for c in rpiece[k:]), "□" * extra)
            elif len(hpiece) > len(rpiece):
                extra = len(hpiece) - k
                ins += extra
                res.insertions_errors.append(
                    f"「{hpiece[k:]}」 在 ASR 結果 額外輸出，不屬於正確文本內容 (替換造成)"
                )
                hl.add("□" * extra, "".join(f"({c})" for c in hpiece[k:]))
        elif tag == "delete":
            dels += len(rpiece)
            res.deletions_errors.append(
                f"正確文本中的「{rpiece}」 被刪除 ，未被 ASR 轉譯成功"
            )
            hl.add("".join(f"<{c}>" for c in rpiece), "□" * len(rpiece))
        elif tag == "insert":
            ins += len(hpiece)
            res.insertions_errors.append(
                f"「{hpiece}」 在 ASR 結果 額外輸出，不屬於正確文本內容"
            )
            hl.add("□" * len(hpiece), "".join(f"({c})" for c in hpiece))
        hl.end_opcode(i2 - i1, j2 - j1)

    n = len(ref)
    errors = subs + dels + ins
    cer = errors / n if n > 0 else 0
    res.cer_rate = cer
    res.correct_rate = 100 * (1 - cer)
    res.total_errors = errors
    res.substitutions_count = subs
    res.deletions_count = dels
    res.insertions_count = ins
    res.total_chars = n
    res.reference_highlighted, res.hypothesis_highlighted = hl.build()
    return res


def compare_texts(reference_text: str, hypothesis_text: str) -> Optional[CERResult]:
    """Top-level comparison helper (reference cer.py:301-315)."""
    if not reference_text or not hypothesis_text:
        return None
    return calculate_cer(reference_text, hypothesis_text)


def cer_metric(references: List[str], hypotheses: List[str], *, clean: bool = False) -> float:
    """Minimal-edit-distance corpus CER, semantics of ``evaluate.load("cer")``
    (used for training eval at reference train_asr.py:662-675).

    ``clean=True`` applies :func:`clean_text` first.
    """
    from ttasr_torch import native

    # the native lane (ttasr_torch/native) first, as the reference does
    _lev = native.levenshtein if native.available() else None
    if _lev is None:
        try:
            from Levenshtein import distance as _lev
        except ImportError:  # pragma: no cover
            def _lev(a: str, b: str) -> int:
                prev = list(range(len(b) + 1))
                for i, ca in enumerate(a, 1):
                    cur = [i]
                    for j, cb in enumerate(b, 1):
                        cur.append(min(prev[j] + 1, cur[-1] + 1,
                                       prev[j - 1] + (ca != cb)))
                    prev = cur
                return prev[-1]

    total_edits = 0
    total_chars = 0
    for ref, hyp in zip(references, hypotheses):
        if clean:
            ref, hyp = clean_text(ref), clean_text(hyp)
        total_edits += _lev(ref, hyp)
        total_chars += len(ref)
    return total_edits / total_chars if total_chars else 0.0
