from .automata import DecoderAutomata, VideoIndex
from .ingest import (export_mp4, frame_pattern, frame_pattern_id,
                     ingest_videos, load_frames, load_video_meta,
                     open_automata, synthesize_video)
from .lib import Decoder, Encoder, ingest_file, write_mp4

__all__ = [
    "DecoderAutomata", "VideoIndex", "Decoder", "Encoder", "ingest_file",
    "write_mp4", "ingest_videos", "load_frames", "load_video_meta",
    "open_automata", "export_mp4", "synthesize_video", "frame_pattern",
    "frame_pattern_id",
]
