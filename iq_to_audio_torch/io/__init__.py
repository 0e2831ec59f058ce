"""Host ingest/encode layer.

Replaces the reference's external native trio — ffmpeg (decode/encode),
ffprobe (probing), libsndfile (WAV IO); see reference ``processing.py:84-279``
(IQReader), ``:381-524`` (AudioWriter), ``probe.py``, ``input_formats.py`` —
with a first-party WAV/RIFF + raw parser, a double-buffered chunk reader and
streaming WAV writers.  NumPy copies of the JAX package's modules, with the
optional ctypes fast path over ``native/iqio.cpp`` (:mod:`.native`).
"""

from .formats import (
    InputFormatSpec,
    InputFormatDetection,
    detect_input_format,
    get_format,
    list_supported_formats,
    parse_user_format,
    resolve_input_format,
    deduce_container,
)
from .probe import SampleRateProbe, probe_sample_rate
from .riff import WavInfo, parse_wav_header
from .reader import IQReader
from .writer import AudioWriter, IQDebugWriter, IQSliceWriter, write_stereo_wav

__all__ = [
    "InputFormatSpec",
    "InputFormatDetection",
    "detect_input_format",
    "get_format",
    "list_supported_formats",
    "parse_user_format",
    "resolve_input_format",
    "deduce_container",
    "SampleRateProbe",
    "probe_sample_rate",
    "WavInfo",
    "parse_wav_header",
    "IQReader",
    "AudioWriter",
    "IQDebugWriter",
    "IQSliceWriter",
    "write_stereo_wav",
]
