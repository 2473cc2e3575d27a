"""Pipeline progress and debug hooks (port of diarizen_tpu/hooks.py).

The protocol (pyannote.audio's pipelines/utils/hook.py): a hook is `hook(step_name, artifact, total=None, completed=None)`
called after each pipeline stage (and per batch inside long stages).

`ProgressHook` prints stage progress, `TimingHook` records wall time per
stage into a dict, `ArtifactHook` keeps selected artifacts, `Hooks` composes.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional


class ProgressHook:
    """Console progress per pipeline stage."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self._current: Optional[str] = None

    def __call__(self, step_name, artifact=None, total=None, completed=None, **kw):
        if step_name != self._current:
            if self._current is not None:
                self.stream.write("\n")
            self._current = step_name
        if total:
            self.stream.write(f"\r{step_name}: {completed or 0}/{total}")
        else:
            self.stream.write(f"\r{step_name}: done")
        self.stream.flush()


class TimingHook:
    """Wall-clock per stage -> `.timings` {step_name: seconds}; also computes
    audio-seconds/s when `audio_duration` is set.

    It times the gaps between hook calls. On `DiarizationPipeline`'s fused
    route (the default) a file's device work is only enqueued before its one
    host wait, so the segmentation and embedding seconds here are enqueue
    time, not device time: each stage's host time and the stream time of
    segmentation and embeddings are in `diarizen_tpu_torch.tracing.records()`."""

    def __init__(self):
        self.timings: Dict[str, float] = {}
        self.audio_duration: Optional[float] = None
        self._t0: Optional[float] = None
        self._current: Optional[str] = None

    def __call__(self, step_name, artifact=None, total=None, completed=None, **kw):
        now = time.perf_counter()
        if step_name != self._current:
            if self._current is not None and self._t0 is not None:
                self.timings[self._current] = now - self._t0
            self._current = step_name
            self._t0 = now
        # final call for a stage (no batches or last batch) closes it lazily

    def finish(self):
        if self._current is not None and self._t0 is not None:
            self.timings[self._current] = time.perf_counter() - self._t0
            self._current = None

    def throughput(self) -> Optional[float]:
        if not self.audio_duration:
            return None
        total = sum(self.timings.values())
        return self.audio_duration / total if total else None


class ArtifactHook:
    """Keep stage artifacts by name -> `.artifacts`."""

    def __init__(self, *step_names: str):
        self.step_names = step_names
        self.artifacts: Dict[str, object] = {}

    def __call__(self, step_name, artifact=None, total=None, completed=None, **kw):
        if artifact is not None and (not self.step_names or step_name in self.step_names):
            self.artifacts[step_name] = artifact


class Hooks:
    """Compose several hooks into one callable."""

    def __init__(self, *hooks):
        self.hooks = [h for h in hooks if h is not None]

    def __call__(self, *args, **kw):
        for h in self.hooks:
            h(*args, **kw)
