"""The 95th percentile of every request's time in the window, in ms, timed
as ``request_ms_p50`` is. A closed loop's tail swings with the host's other
work (on an H100 80GB HBM3 machine, between runs of one seed: 21.4–28.3 ms
on ``fpn_mask-serve``, 4.7–16.4 ms on ``darknet_keypoint-serve``), too
far for a bound, so it stands beside the median without one."""


def read(r):
    return r.window_stats.get("request_ms_p95")
