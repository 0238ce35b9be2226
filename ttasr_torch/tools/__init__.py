"""Command-line tools of the port, run as ``python -m ttasr_torch.tools.<name>``:
the VAD trainer (``train_vad``), the trained-recognition check
(``check_trained_recognition``), the beam-divergence report
(``check_beam_divergence``) and the decode-step profile (``profile_decode``);
``synth`` holds the audio synthesizer they share."""
