"""Device ms a request of the NMS kernel's two device kernels (its mask
pass and its walk), by their names, from an uncaptured traced stretch."""

NAMES = ("nms_mask_kernel", "nms_walk_kernel")


def read(r):
    if r.eager is None:
        return None
    ms = r.eager.device_ms_named(NAMES)
    return ms if ms > 0 else None
