"""Standalone streaming server CLI (port of ``ttasr/streaming/main.py``).

    python -m ttasr_torch.streaming.main --port 8765

Flag surface of the reference's legacy entry (api/stt_streaming/src/
main.py:127-161): ``--vad-type/--vad-args/--asr-type/--asr-args/--host/
--port``; unlike the reference (whose Server import is broken), this one
runs.
"""

from __future__ import annotations

import argparse
import json
import logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="ttasr streaming WS server")
    parser.add_argument("--vad-type", default="simple",
                        help="VAD pipeline type ('simple', 'energy')")
    parser.add_argument("--vad-args", default='{"min_duration": 0.1}',
                        help="JSON kwargs for the VAD pipeline")
    parser.add_argument("--asr-type", default="torch_whisper",
                        help="ASR pipeline type ('torch_whisper')")
    parser.add_argument("--asr-args", default='{"model_size": "models"}',
                        help="JSON kwargs for the ASR pipeline")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    return parser.parse_args(argv)


def main(argv=None) -> None:  # pragma: no cover - blocking entry
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from ttasr_torch.streaming.asr.asr_factory import ASRFactory
    from ttasr_torch.streaming.server import Server
    from ttasr_torch.streaming.vad.vad_factory import VADFactory

    vad = VADFactory.create_vad_pipeline(args.vad_type, **json.loads(args.vad_args))
    asr = ASRFactory.create_asr_pipeline(args.asr_type, **json.loads(args.asr_args))
    Server(vad, asr, host=args.host, port=args.port).start()


if __name__ == "__main__":  # pragma: no cover
    main()
