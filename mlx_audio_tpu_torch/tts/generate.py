"""TTS CLI: ``python -m mlx_audio_tpu_torch.tts.generate --model DIR --text ...``

Counterpart of ``mlx_audio_tpu/tts/generate.py``: load a local checkpoint
through the registry, optionally take a reference clip (transcribed with
the port's Whisper when ``--ref_text`` is absent), generate the segments,
then play, save or join them with the real-time-factor report.  Runs on
``--device`` (``cuda`` unless ``cpu`` is asked for).  There is no
``--mesh``: the port targets one card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


def load_ref_audio(path: str, sample_rate: int = 24000,
                   max_seconds: float = 15.0) -> np.ndarray:
    from mlx_audio_tpu_torch.utils.audio_io import load_audio

    audio = load_audio(path, sample_rate)
    max_samples = int(max_seconds * sample_rate)
    if audio.shape[0] > max_samples:
        audio = audio[:max_samples]
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak * 0.95
    return audio


def generate_audio(
    text: str,
    model_path: str = "prince-canuma/Kokoro-82M",
    model=None,
    voice: Optional[str] = None,
    speed: float = 1.0,
    lang_code: str = "a",
    file_prefix: str = "audio",
    audio_format: str = "wav",
    join_audio: bool = False,
    play: bool = False,
    verbose: bool = True,
    ref_audio: Optional[str] = None,
    ref_text: Optional[str] = None,
    stt_model: str = "mlx-community/whisper-large-v3-turbo",
    trace_dir: Optional[str] = None,
    device: str = "cuda",
    **kwargs,
):
    """Generate speech from text; returns the list of GenerationResults.

    ``model_path`` and ``stt_model`` are local checkpoint directories.
    ``trace_dir`` records the generation's CUDA activity
    (``utils.profiling.trace``)."""
    from mlx_audio_tpu_torch.utils.loader import load_model
    from mlx_audio_tpu_torch.utils.profiling import trace

    if model is None:
        model = load_model(model_path, domain="tts", device=device)

    sample_rate = getattr(model, "sample_rate", 24000)

    ref_audio_arr = None
    if ref_audio is not None:
        ref_audio_arr = load_ref_audio(ref_audio, sample_rate)
        if ref_text is None:
            if verbose:
                print("Transcribing reference audio with Whisper...")
            from mlx_audio_tpu_torch.models.stt.whisper import Model as WhisperModel
            from mlx_audio_tpu_torch.utils.audio_io import resample_audio

            stt = WhisperModel.from_pretrained(stt_model, device=device)
            ref_text = stt.generate(
                resample_audio(ref_audio_arr, sample_rate, 16000)
            ).text.strip()
            if verbose:
                print(f"Reference text: {ref_text}")

    player = None
    if play:
        from mlx_audio_tpu_torch.tts.audio_player import AudioPlayer

        player = AudioPlayer(sample_rate=sample_rate)

    results = []
    segments = []
    gen = model.generate(
        text=text, voice=voice, speed=speed, lang_code=lang_code,
        ref_audio=ref_audio_arr, ref_text=ref_text, **kwargs,
    )
    if trace_dir:
        with trace(trace_dir):
            gen = list(gen)
    for result in gen:
        results.append(result)
        segments.append(np.asarray(result.audio).reshape(-1))
        if verbose:
            print("==========")
            print(f"Duration:              {result.audio_duration}")
            print(f"Samples/sec:           {result.audio_samples['samples-per-sec']}")
            print(f"Real-time factor:      {result.real_time_factor}")
            print(f"Processing time:       {result.processing_time_seconds:.2f}s")
            print(f"Peak memory:           {result.peak_memory_usage:.2f}GB")
        if player is not None:
            player.queue_audio(segments[-1])
        if not join_audio and file_prefix:
            from mlx_audio_tpu_torch.utils.audio_io import save_audio

            fname = f"{file_prefix}_{result.segment_idx:03d}.{audio_format}"
            save_audio(fname, segments[-1], sample_rate)
            if verbose:
                print(f"Saved: {fname}")

    if join_audio and segments and file_prefix:
        from mlx_audio_tpu_torch.utils.audio_io import save_audio

        fname = f"{file_prefix}.{audio_format}"
        save_audio(fname, np.concatenate(segments), sample_rate)
        if verbose:
            print(f"Saved joined audio: {fname}")

    if player is not None:
        player.wait_for_drain()
        player.stop()
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate speech from text")
    parser.add_argument("--model", type=str, default="prince-canuma/Kokoro-82M",
                        help="local checkpoint directory")
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--voice", type=str, default=None)
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--lang_code", type=str, default="a")
    parser.add_argument("--file_prefix", type=str, default="audio")
    parser.add_argument("--audio_format", type=str, default="wav")
    parser.add_argument("--join_audio", action="store_true")
    parser.add_argument("--play", action="store_true")
    parser.add_argument("--verbose", action="store_true", default=True)
    parser.add_argument("--ref_audio", type=str, default=None)
    parser.add_argument("--ref_text", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.9)
    parser.add_argument("--top_k", type=int, default=50)
    parser.add_argument("--top_p", type=float, default=0.9)
    parser.add_argument("--pitch", type=float, default=1.0,
                        help="Pitch factor (Spark level maps)")
    parser.add_argument("--gender", type=str, default=None,
                        choices=[None, "male", "female"],
                        help="Voice gender (Spark controllable TTS)")
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--max_tokens", type=int, default=1200,
                        help="Maximum number of tokens to generate")
    parser.add_argument("--repetition_penalty", type=float, default=1.1,
                        help="Repetition penalty for LM-based models")
    parser.add_argument("--streaming_interval", type=float, default=2.0,
                        help="Seconds of audio per streamed chunk")
    parser.add_argument("--stt_model", type=str,
                        default="mlx-community/whisper-large-v3-turbo",
                        help="local Whisper checkpoint that transcribes "
                             "--ref_audio when --ref_text is absent")
    parser.add_argument("--trace-dir", "--trace_dir", dest="trace_dir", type=str,
                        default=None,
                        help="record the generation's CUDA activity into this dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    text = args.text
    if text is None:
        if not sys.stdin.isatty():
            text = sys.stdin.read().strip()
        else:
            print("Please enter the text to generate:")
            text = input("> ").strip()
    generate_audio(
        text=text,
        model_path=args.model,
        voice=args.voice,
        speed=args.speed,
        lang_code=args.lang_code,
        file_prefix=args.file_prefix,
        audio_format=args.audio_format,
        join_audio=args.join_audio,
        play=args.play,
        verbose=args.verbose,
        ref_audio=args.ref_audio,
        ref_text=args.ref_text,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        pitch=args.pitch,
        **({"gender": args.gender} if args.gender else {}),
        stream=args.stream,
        max_tokens=args.max_tokens,
        repetition_penalty=args.repetition_penalty,
        streaming_interval=args.streaming_interval,
        stt_model=args.stt_model,
        trace_dir=args.trace_dir,
        device=args.device,
    )


if __name__ == "__main__":
    main()
