"""odom_step_ms (ms): the synchronised host-clock time of one lockstep
odometry step (odometry.odometry_step for all B scenarios), the window's
total over its steps."""


def read(s):
    seconds, calls = s.spans.get("odometry", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
