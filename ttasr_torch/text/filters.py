"""Hallucination filtering and language-code mapping.

Parity surface: reference ``api/stt_streaming/src/utils.py:132-158``
(``ignore_text`` blocklist + ``filter_text``) and ``:174-276``
(``language_codes``).  The blocklist entries are the product's curated
YouTube-subtitle hallucination phrases and must match exactly.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

# Curated hallucination phrases (reference utils.py:132-152).
IGNORE_TEXT: List[str] = [
    "字幕by",
    "中文字幕由",
    "中文字幕 by",
    "中文字幕提供",
    "請你一定要顯示繁體中文",
    "订阅",
    "打赏",
    "不吝點贊",
    "阿波羅網編譯",
    "逐字稿機器",
    "請看影片資訊欄",
    "Amara.org",
    "整理&字幕志願者",
    "以上言論不代表本台立場",
    "點點欄目",
    "不吝點贊",
    "訂閱轉發",
    "喜歡請訂閱",
    "按讚及分享",
]


def filter_text(text: str) -> Optional[str]:
    """Return None when the text contains a known hallucination phrase
    (reference utils.py:155-158)."""
    if any(phrase in text for phrase in IGNORE_TEXT):
        return None
    return text


def filter_segments(segments: Iterable[dict]) -> List[dict]:
    """Drop segments whose text hits the blocklist (semantics of reference
    utils.py:161-171, with the reference's membership-test bug fixed)."""
    kept = []
    for seg in segments:
        text = seg.get("text", "") if isinstance(seg, dict) else getattr(seg, "text", "")
        if filter_text(text) is None:
            continue
        kept.append(seg)
    return kept


# Whisper language-name -> ISO code map (reference utils.py:174-276).
language_codes = {
    "afrikaans": "af", "amharic": "am", "arabic": "ar", "assamese": "as",
    "azerbaijani": "az", "bashkir": "ba", "belarusian": "be", "bulgarian": "bg",
    "bengali": "bn", "tibetan": "bo", "breton": "br", "bosnian": "bs",
    "catalan": "ca", "czech": "cs", "welsh": "cy", "danish": "da",
    "german": "de", "greek": "el", "english": "en", "spanish": "es",
    "estonian": "et", "basque": "eu", "persian": "fa", "finnish": "fi",
    "faroese": "fo", "french": "fr", "galician": "gl", "gujarati": "gu",
    "hausa": "ha", "hawaiian": "haw", "hebrew": "he", "hindi": "hi",
    "croatian": "hr", "haitian": "ht", "hungarian": "hu", "armenian": "hy",
    "indonesian": "id", "icelandic": "is", "italian": "it", "japanese": "ja",
    "javanese": "jw", "georgian": "ka", "kazakh": "kk", "khmer": "km",
    "kannada": "kn", "korean": "ko", "latin": "la", "luxembourgish": "lb",
    "lingala": "ln", "lao": "lo", "lithuanian": "lt", "latvian": "lv",
    "malagasy": "mg", "maori": "mi", "macedonian": "mk", "malayalam": "ml",
    "mongolian": "mn", "marathi": "mr", "malay": "ms", "maltese": "mt",
    "burmese": "my", "nepali": "ne", "dutch": "nl", "norwegian nynorsk": "nn",
    "norwegian": "no", "occitan": "oc", "punjabi": "pa", "polish": "pl",
    "pashto": "ps", "portuguese": "pt", "romanian": "ro", "russian": "ru",
    "sanskrit": "sa", "sindhi": "sd", "sinhalese": "si", "slovak": "sk",
    "slovenian": "sl", "shona": "sn", "somali": "so", "albanian": "sq",
    "serbian": "sr", "sundanese": "su", "swedish": "sv", "swahili": "sw",
    "tamil": "ta", "telugu": "te", "tajik": "tg", "thai": "th",
    "turkmen": "tk", "tagalog": "tl", "turkish": "tr", "tatar": "tt",
    "ukrainian": "uk", "urdu": "ur", "uzbek": "uz", "vietnamese": "vi",
    "yiddish": "yi", "yoruba": "yo",
    "simplifiedchinese": "zh", "traditionalchinese": "zh", "cantonese": "yue",
}
