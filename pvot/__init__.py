"""pvot — parallel video object tracker in JAX.

A JAX/XLA framework with the capabilities of the reference
CUDA tracker (askEric0/Parallel-Video-Object-Tracker): NCC template-matching
single-object tracking with interchangeable compute backends, a sequential
bbox/adaptive-template state machine with lost-object global re-acquisition,
look-ahead frame batching, interactive & recording CLI modes, and FPS
instrumentation.  See SURVEY.md for the reference analysis this was built to.
"""

from pvot.config import DEFAULT_CONFIG, WINDOWS_TREE_CONFIG, TrackerConfig
from pvot.tracker.state import StepOutput, TrackerState, init_state
from pvot.tracker.step import make_step
from pvot.tracker.scan import track_video, track_video_batched

__version__ = "0.1.0"

__all__ = [
    "TrackerConfig",
    "DEFAULT_CONFIG",
    "WINDOWS_TREE_CONFIG",
    "TrackerState",
    "StepOutput",
    "init_state",
    "make_step",
    "track_video",
    "track_video_batched",
]


def __getattr__(name):  # lazy heavyweight entry points
    if name == "track_stream":
        from pvot.io.pipeline import track_stream

        return track_stream
    if name == "track_video_multi":
        from pvot.parallel.multi import track_video_multi

        return track_video_multi
    if name == "serve_streams":
        from pvot.io.serving import serve_streams

        return serve_streams
    if name == "serve_objects":
        from pvot.io.serving import serve_objects

        return serve_objects
    if name == "serve_streams_grouped":
        from pvot.io.serving import serve_streams_grouped

        return serve_streams_grouped
    raise AttributeError(f"module 'pvot' has no attribute {name!r}")
