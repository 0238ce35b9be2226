"""Batch file-transcription CLI on the PyTorch engine (port of
``ttasr/cli/asr.py``).

    python -m ttasr_torch.cli.asr <folder> [--model large-v3] [--device cuda]

Same workflow as the JAX package's CLI, whose sequential path this module
copies:

- scans for ``.wav/.mp3/.flac/.m4a/.aac`` (case-insensitive, non-recursive),
- transcribes each file with ``language=zh, beam_size=5, vad_filter=True,
  condition_on_previous_text=True, initial_prompt=""``,
- post-processes (replace_words -> s2tw -> strip specials -> lower) and
  writes ``{name}_asr.txt`` next to the audio,
- finds reference transcripts by the five filename patterns, computes
  per-file CER and aggregate stats, and
- writes ``asr_comparison_results.json`` (into ``results_json_dir`` or the
  CWD).

The engine is ``ttasr_torch``'s ``WhisperEngine(model,
compute_type="bfloat16")`` unless one is injected.  ``--concurrency N``
(N > 1) runs every file's seek loop at once through one
:class:`~ttasr_torch.engine.serving.BatchServer` of N slots
(:func:`~ttasr_torch.engine.serving.transcribe_files`); ``--batched`` decodes
each file's VAD chunks concurrently through one
:class:`~ttasr_torch.engine.batched.BatchedInferencePipeline` (no prompt
carry), shared by all files.  A file whose served decode failed gets its
error entry; nothing falls back to the sequential loop.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
from typing import Callable, Optional

from ttasr_torch.text.cer import compare_texts
from ttasr_torch.text.normalize import postprocess_transcript

AUDIO_EXTENSIONS = ["*.wav", "*.mp3", "*.flac", "*.m4a", "*.aac"]

TRANSCRIPT_PATTERNS = [
    "{name}.txt",
    "{name}_transcript.txt",
    "{name}_original.txt",
    "{name}_reference.txt",
    "{name}_ground_truth.txt",
]


def convert_time(time_value: float) -> str:
    """Seconds -> ``HH:MM:SS.mmm``."""
    seconds = int(time_value)
    ms = int(round((time_value - seconds) * 1000))
    if ms >= 1000:
        seconds += 1
        ms -= 1000
    hours, rem = divmod(seconds, 3600)
    minutes, secs = divmod(rem, 60)
    return f"{hours:02d}:{minutes:02d}:{secs:02d}.{ms:03d}"


def find_original_transcript(audio_file: str) -> Optional[str]:
    """Locate the matching ground-truth transcript."""
    audio_dir = os.path.dirname(audio_file)
    name = os.path.splitext(os.path.basename(audio_file))[0]
    for pattern in TRANSCRIPT_PATTERNS:
        path = os.path.join(audio_dir, pattern.format(name=name))
        if os.path.exists(path):
            return path
    return None


def list_audio_files(folder_path: str) -> list:
    files = []
    for ext in AUDIO_EXTENSIONS:
        files.extend(glob.glob(os.path.join(folder_path, ext)))
        files.extend(glob.glob(os.path.join(folder_path, ext.upper())))
    return sorted(set(files))


def build_engine(model: str = "models", device="cuda"):
    from ttasr_torch.engine.transcriber import WhisperEngine

    return WhisperEngine(model, compute_type="bfloat16", device=device)


# the reference's decode kwargs (sequential and --concurrency); --batched
# takes them without vad_filter and condition_on_previous_text
TRANSCRIBE_KWARGS = dict(language="zh", word_timestamps=False, vad_filter=True,
                         beam_size=5, condition_on_previous_text=True,
                         initial_prompt="")
BATCHED_KWARGS = dict(language="zh", word_timestamps=False, beam_size=5,
                      initial_prompt="")


def _transcribe_file(audio_file: str, run: Callable[[str], tuple]) -> dict:
    """One file: ``run(audio_file)`` gives its (segments, info); post-process, write
    ``{name}_asr.txt`` and score against a reference transcript when one
    exists.  A failure becomes the file's error entry."""
    audio_dir = os.path.dirname(audio_file)
    audio_name = os.path.splitext(os.path.basename(audio_file))[0]
    output_path = os.path.join(audio_dir, f"{audio_name}_asr.txt")
    try:
        segments, info = run(audio_file)
        text = "".join(seg.text for seg in segments)
        processed_text = postprocess_transcript(text)

        with open(output_path, "w", encoding="utf-8") as fh:
            fh.write(f"{processed_text}")
        print(f"轉錄結果已儲存至: {output_path}")

        result = {
            "audio_file": os.path.basename(audio_file),
            "asr_result": processed_text,
            "original_transcript": None,
            "cer_result": None,
            "has_original_transcript": False,
        }
        transcript_path = find_original_transcript(audio_file)
        if transcript_path:
            with open(transcript_path, encoding="utf-8") as fh:
                original_text = fh.read().strip()
            result["original_transcript"] = original_text
            result["has_original_transcript"] = True
            cer = compare_texts(original_text, processed_text)
            if cer:
                result["cer_result"] = cer.to_dict()
                print(f"CER: {cer.cer_rate:.4f}, 正確率: {cer.correct_rate:.2f}%")
        else:
            print("找不到對應的原始逐字稿檔案")
        return result
    except Exception as exc:
        # a file that fails is recorded and the folder goes on, as in the
        # JAX package's CLI
        print(f"處理音檔 {audio_file} 時發生錯誤: {exc}")
        with open(output_path, "w", encoding="utf-8") as fh:
            fh.write(f"檔案名稱: {os.path.basename(audio_file)}\n")
            fh.write(f"錯誤: {exc}\n")
        return {
            "audio_file": os.path.basename(audio_file),
            "asr_result": None,
            "original_transcript": None,
            "cer_result": None,
            "has_original_transcript": False,
            "error": str(exc),
        }


def process_audio_folder(folder_path: str,
                         output_file: str = "transcription_results.txt",
                         model: str = "models",
                         engine=None,
                         results_json_dir: Optional[str] = None,
                         concurrency: int = 1,
                         batched: bool = False,
                         device="cuda") -> Optional[dict]:
    """Transcribe every audio file in ``folder_path`` with the PyTorch
    engine (built from ``model`` on ``device`` unless one is injected).
    Returns the aggregate result dict (also written to JSON), or None when
    no audio was found.  A model that fails to load raises."""
    audio_files = list_audio_files(folder_path)
    if not audio_files:
        print(f"在資料夾 {folder_path} 中找不到音檔")
        return None
    print(f"找到 {len(audio_files)} 個音檔")
    if engine is None:
        engine = build_engine(model, device=device)
        print(f"模型載入成功: {model}")

    # continuous batching across files: windows of up to ``concurrency``
    # files pack into shared decode slots (prompt carry stays sequential
    # within each file); a file's value is its result or its exception
    served = {}
    if concurrency > 1:
        from ttasr_torch.engine.serving import transcribe_files

        served = asyncio.run(transcribe_files(
            engine, audio_files, slots=concurrency, **TRANSCRIBE_KWARGS))
    # ONE pipeline (and its BatchServer) serves every --batched file
    pipeline = None
    if batched:
        from ttasr_torch.engine.batched import BatchedInferencePipeline

        pipeline = BatchedInferencePipeline(engine,
                                            batch_size=max(concurrency, 4))

    def run(audio_file):
        if audio_file in served:
            value = served[audio_file]
            if isinstance(value, BaseException):
                raise value
            return value
        if pipeline is not None:
            return pipeline.transcribe(audio_file, **BATCHED_KWARGS)
        return engine.transcribe(audio_file, **TRANSCRIBE_KWARGS)

    comparison_results = []
    try:
        for i, audio_file in enumerate(audio_files, 1):
            print(f"處理音檔 {i}/{len(audio_files)}: {os.path.basename(audio_file)}")
            comparison_results.append(_transcribe_file(audio_file, run))
    finally:
        if pipeline is not None:
            pipeline.close()

    with_cer = [r for r in comparison_results if r.get("cer_result")]
    n_cer = len(with_cer)
    summary = {
        "total_files": len(comparison_results),
        "files_with_transcript": sum(
            1 for r in comparison_results if r.get("has_original_transcript")
        ),
        "files_with_cer": n_cer,
        "average_cer": sum(r["cer_result"]["cer_rate"] for r in with_cer) / n_cer
        if n_cer else 0,
        "average_correct_rate": sum(
            r["cer_result"]["correct_rate"] for r in with_cer
        ) / n_cer if n_cer else 0,
        "total_substitutions": sum(
            r["cer_result"]["substitutions_count"] for r in with_cer
        ),
        "total_deletions": sum(r["cer_result"]["deletions_count"] for r in with_cer),
        "total_insertions": sum(r["cer_result"]["insertions_count"] for r in with_cer),
    }
    final_result = {"summary": summary, "detailed_results": comparison_results}

    out_dir = results_json_dir or os.getcwd()
    json_path = os.path.join(out_dir, "asr_comparison_results.json")
    with open(json_path, "w", encoding="utf-8") as fh:
        json.dump(final_result, fh, ensure_ascii=False, indent=2)
    print("\n=== 處理完成 ===")
    print(f"總檔案數: {summary['total_files']}")
    if n_cer:
        print(f"平均 CER: {summary['average_cer']:.4f}")
    print(f"詳細結果已儲存至: {json_path}")
    return final_result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="音檔轉錄工具 (PyTorch/CUDA)")
    parser.add_argument("folder", help="音檔資料夾路徑")
    parser.add_argument(
        "--output", default="transcription_results.txt",
        help="輸出檔案名稱 (已棄用，保留用於向後相容)",
    )
    parser.add_argument("--model", default="models", help="模型路徑或預設名稱")
    parser.add_argument("--device", default="cuda",
                        help="torch 裝置 (預設 cuda；無 CUDA 時報錯)")
    parser.add_argument("--concurrency", type=int, default=1,
                        help="同時處理的檔案數（視窗連續批次化）")
    parser.add_argument("--batched", action="store_true",
                        help="單檔內以 VAD 語音區塊並行解碼"
                             "（BatchedInferencePipeline，不做前文接續）")
    args = parser.parse_args(argv)
    if not os.path.exists(args.folder):
        print(f"資料夾不存在: {args.folder}")
        return
    process_audio_folder(args.folder, args.output, model=args.model,
                         concurrency=args.concurrency, batched=args.batched,
                         device=args.device)


if __name__ == "__main__":
    main()
