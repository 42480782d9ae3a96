"""frontend_ms (ms/frame): the synchronised host-clock time of the
batched frontend (replay.batched_frontend: ingest and feature extraction
of all B*F sweeps in one call) over the window, per scenario-frame."""


def read(s):
    seconds, calls = s.spans.get("frontend", (0.0, 0))
    if not calls or not s.window_frames:
        return None
    return 1e3 * seconds / s.window_frames
