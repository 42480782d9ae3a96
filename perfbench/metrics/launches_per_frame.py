"""launches_per_frame (launches): kernel launches on the device in the
profiled pass (copies and fills not counted) over the scenario-frames
it finished."""


def read(s):
    if not s.traced_frames or not s.kernel_launches:
        return None
    return s.kernel_launches / s.traced_frames
