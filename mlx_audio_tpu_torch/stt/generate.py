"""STT CLI: ``python -m mlx_audio_tpu_torch.stt.generate --model DIR --audio f.wav``

Counterpart of ``mlx_audio_tpu/stt/generate.py``: load a local checkpoint
through the registry, transcribe, write txt/srt/vtt/tsv/json (Whisper's
writers; Parakeet's ``AlignedResult`` passes as its sentences) and report
the wall time and peak device memory.  Runs on ``--device`` (``cuda``
unless ``cpu`` is asked for).  ``--mesh 'dp=N'`` activates the device mesh
(``parallel.context.activate_cli_mesh``): Parakeet's chunks, Whisper's and
Voxtral's windows decode data-parallel.
"""

from __future__ import annotations

import argparse
import time

import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Transcribe audio")
    parser.add_argument("--model", type=str,
                        default="mlx-community/whisper-large-v3-turbo",
                        help="local checkpoint directory")
    parser.add_argument("--audio", type=str, required=True)
    parser.add_argument("--output-path", "--output", dest="output_path",
                        type=str, default=".")
    parser.add_argument("--max_tokens", type=int, default=None,
                        help="Maximum number of new tokens to generate "
                             "(LLM-based STT like Voxtral; Whisper/Parakeet "
                             "bound output by their own decode budgets)")
    parser.add_argument("--format", type=str, default="txt",
                        choices=["txt", "srt", "vtt", "json", "tsv", "all"])
    parser.add_argument("--language", type=str, default=None)
    parser.add_argument("--task", type=str, default="transcribe")
    parser.add_argument("--beam-size", type=int, default=None)
    parser.add_argument("--word-timestamps", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--chunk-duration", type=float, default=None,
                        help="split long audio into chunks of this many "
                             "seconds (Parakeet; batched decode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh spec 'dp=N': shard batched chunk "
                             "and window decodes over the data axis")
    return parser.parse_args(argv)


def generate(model_path: str, audio_path: str, output_path: str = ".",
             output_format: str = "txt", device: str = "cuda",
             mesh: str = None, **kwargs):
    from mlx_audio_tpu_torch.models.base import peak_memory_gb
    from mlx_audio_tpu_torch.models.stt.whisper.writers import get_writer
    from mlx_audio_tpu_torch.utils.loader import load_model

    if mesh:
        from mlx_audio_tpu_torch.parallel.context import activate_cli_mesh

        ctx = activate_cli_mesh(mesh, device)
        print(f"Mesh active: dp={ctx.dp} tp={ctx.tp} ({ctx.dp * ctx.tp} devices)")

    model = load_model(model_path, domain="stt", device=device)

    start = time.time()
    output = model.generate(audio_path, **kwargs)
    wall = time.time() - start

    print(f"Transcription: {output.text}")
    print(f"Processing time: {wall:.2f}s; peak memory: "
          f"{peak_memory_gb(torch.device(device)):.2f}GB")

    if hasattr(output, "sentences"):  # Parakeet AlignedResult
        segments = [
            {"start": sent.start, "end": sent.end, "text": sent.text}
            for sent in output.sentences
        ]
        language = "en"
    else:
        segments = output.segments or []
        language = output.language
    result = {
        "text": output.text,
        "segments": segments,
        "language": language,
    }
    writer = get_writer(output_format, output_path)
    written = writer(result, audio_path)
    print(f"Saved: {written}")
    return output


def main(argv=None):
    args = parse_args(argv)
    kwargs = {}
    if args.language:
        kwargs["language"] = args.language
    if args.beam_size:
        kwargs["beam_size"] = args.beam_size
    if args.max_tokens:
        kwargs["max_tokens"] = args.max_tokens
    if args.chunk_duration:
        kwargs["chunk_duration"] = args.chunk_duration
    generate(
        args.model, args.audio, args.output_path, args.format,
        device=args.device, mesh=args.mesh,
        task=args.task, word_timestamps=args.word_timestamps,
        verbose=args.verbose or None, **kwargs,
    )


if __name__ == "__main__":
    main()
