"""Transcript writers: txt / srt / vtt / json / tsv (a copy of
``mlx_audio_tpu/models/stt/whisper/writers.py``, which imports no JAX).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, TextIO


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    assert seconds >= 0
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str = "."):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, **kwargs):
        audio_basename = os.path.splitext(os.path.basename(audio_path))[0]
        output_path = os.path.join(self.output_dir,
                                   audio_basename + "." + self.extension)
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, f, **kwargs)
        return output_path

    def write_result(self, result: dict, file: TextIO, **kwargs):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result: dict, file: TextIO, **kwargs):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def iterate_result(self, result: dict, max_line_width: Optional[int] = None,
                       **kwargs):
        for segment in result["segments"]:
            segment_start = self.format_timestamp(segment["start"])
            segment_end = self.format_timestamp(segment["end"])
            segment_text = segment["text"].strip().replace("-->", "->")
            yield segment_start, segment_end, segment_text

    def format_timestamp(self, seconds: float):
        return format_timestamp(
            seconds=seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result: dict, file: TextIO, **kwargs):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, **kwargs):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result: dict, file: TextIO, **kwargs):
        for i, (start, end, text) in enumerate(
            self.iterate_result(result, **kwargs), start=1
        ):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    extension = "tsv"

    def write_result(self, result: dict, file: TextIO, **kwargs):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]),
                  round(1000 * segment["end"]),
                  segment["text"].strip().replace("\t", " "),
                  sep="\t", file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result: dict, file: TextIO, **kwargs):
        json.dump(result, file, ensure_ascii=False)


def get_writer(output_format: str, output_dir: str = ".") -> Callable:
    writers = {
        "txt": WriteTXT,
        "vtt": WriteVTT,
        "srt": WriteSRT,
        "tsv": WriteTSV,
        "json": WriteJSON,
    }
    if output_format == "all":
        all_writers = [w(output_dir) for w in writers.values()]

        def write_all(result: dict, file: str, **kwargs):
            return [w(result, file, **kwargs) for w in all_writers]

        return write_all
    return writers[output_format](output_dir)
