"""High-level NCC tracker API — the flagship model.

Object-style convenience wrapper over the functional core
(pvot.tracker.*): construct from the first frame + ROI, call
`update(frame)` per frame or `track(frames)` for whole clips.  The
underlying step is the fused device path (matmul NCC, scan-carried
state); everything the reference tracker does (C5-C8 semantics,
SURVEY.md §2a) plus checkpoint/resume.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pvot.config import TrackerConfig
from pvot.tracker.state import StepOutput, TrackerState


class NccTracker:
    """Single-object NCC template tracker.

    >>> tracker = NccTracker(first_frame_gray_u8, roi=(x, y, w, h))
    >>> for frame in frames:
    ...     bbox, score = tracker.update(frame)
    """

    def __init__(
        self,
        first_frame,
        roi: Tuple[int, int, int, int],
        config: TrackerConfig = TrackerConfig(),
        strategy: str = "fused",
        backend: str = "xla",
        state: Optional[TrackerState] = None,
    ):
        import jax
        import jax.numpy as jnp

        from pvot.io.gray import gray_u8_to_f32
        from pvot.tracker.state import init_state
        from pvot.tracker.step import jitted_step

        first_frame = np.asarray(first_frame)
        if first_frame.ndim == 3:
            from pvot.runtime import native

            first_frame = native.bgr_to_gray_u8(first_frame)
        self.frame_shape = first_frame.shape
        self.config = config.validate()
        x, y, w, h = (int(v) for v in roi)
        if state is None:
            templ = gray_u8_to_f32(first_frame)[y : y + h, x : x + w]
            state = init_state(jnp.asarray(templ), (x, y, w, h))
        self.state = state
        th, tw = state.template.shape
        self._step = jitted_step(
            tuple(self.frame_shape), (th, tw), config, strategy, backend
        )

    @property
    def bbox(self) -> Tuple[int, int, int, int]:
        s = self.state
        return (int(s.bbox_x), int(s.bbox_y), int(s.bbox_w), int(s.bbox_h))

    def update(self, frame) -> Tuple[Tuple[int, int, int, int], float]:
        """Advance one frame; returns (bbox, score).  frame: gray u8/f32 or
        BGR u8 (converted)."""
        import jax.numpy as jnp

        frame = np.asarray(frame)
        if frame.ndim == 3:
            from pvot.runtime import native

            frame = native.bgr_to_gray_u8(frame)
        self.state, out = self._step(self.state, jnp.asarray(frame))
        return tuple(int(v) for v in np.asarray(out.bbox)), float(out.score)

    def track(self, frames, chunk_size: int = 32) -> StepOutput:
        """Track a whole clip (F, H, W) with the chunked scan driver."""
        from pvot.tracker.scan import track_video

        self.state, out = track_video(
            frames, self.state, self.config, chunk_size=chunk_size
        )
        return out

    def save(self, path: str) -> None:
        from pvot.utils.checkpoint import save_state

        save_state(path, self.state)

    @classmethod
    def load(
        cls, path: str, frame_shape: Tuple[int, int],
        config: TrackerConfig = TrackerConfig(), **kwargs
    ) -> "NccTracker":
        from pvot.utils.checkpoint import load_state

        state = load_state(path)
        dummy = np.zeros(frame_shape, np.uint8)
        return cls(dummy, roi=(0, 0, *state.template.shape[::-1]),
                   config=config, state=state, **kwargs)
