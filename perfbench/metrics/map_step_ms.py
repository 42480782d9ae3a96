"""map_step_ms (ms): the synchronised host-clock time of one lockstep
mapping step that solves (mapping.mapping_step after a pass's first
mapping frame, which meets an empty map), the window's total over those
steps."""


def read(s):
    seconds, calls = s.solving
    return 1e3 * seconds / calls if calls else None
