"""Batch file-transcription CLI on the PyTorch engine (port of
``ttasr/cli/asr.py``).

    python -m ttasr_torch.cli.asr <folder> [--model large-v3] [--device cuda]

Builds ``ttasr_torch``'s ``WhisperEngine(model, compute_type="bfloat16")``
and hands it to the shared, jax-free ``ttasr.cli.asr.process_audio_folder``
(file discovery, ``language=zh, beam_size=5, vad_filter=True,
condition_on_previous_text=True`` transcription, post-processing, CER and
the results JSON).  ``--concurrency > 1`` and ``--batched`` need the
continuous-batching server, which is not ported yet: they raise instead of
silently running files one by one.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from ttasr.cli.asr import process_audio_folder as _process_audio_folder


def build_engine(model: str = "models", device="cuda"):
    from ttasr_torch.engine.transcriber import WhisperEngine

    return WhisperEngine(model, compute_type="bfloat16", device=device)


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
    Returns the aggregate result dict, or None when no audio was found.
    A model that fails to load raises."""
    if concurrency > 1 or batched:
        raise NotImplementedError(
            "--concurrency > 1 and --batched need BatchServer / "
            "BatchedInferencePipeline, not ported to ttasr_torch yet "
            "(ROADMAP A7)")
    if engine is None:
        engine = build_engine(model, device=device)
        print(f"模型載入成功: {model}")
    return _process_audio_folder(folder_path, output_file, model=model,
                                 engine=engine,
                                 results_json_dir=results_json_dir)


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
                        help="同時處理的檔案數（尚未移植，僅接受 1）")
    parser.add_argument("--batched", action="store_true",
                        help="單檔內 VAD 區塊並行解碼（尚未移植）")
    args = parser.parse_args(argv)
    if not os.path.exists(args.folder):
        print(f"資料夾不存在: {args.folder}")
        return
    process_audio_folder(args.folder, args.output, model=args.model,
                         concurrency=args.concurrency, batched=args.batched,
                         device=args.device)


if __name__ == "__main__":
    main()
