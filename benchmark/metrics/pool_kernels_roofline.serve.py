"""ROIAlign's forward kernel's (B2) share of its roofline over a request,
in %: the least time the card could take to write the pooled outputs and
read the boxes of the request's two pools
(:func:`benchmark.bounds.serve_pool_bytes`, over the HBM peak), over the
device time of its kernel, by name, in uncaptured traced requests. None
where it did not run."""

from benchmark.bounds import serve_pool_bytes

NAMES = ("roi_align_fwd_kernel",)


def read(r):
    if r.eager is None or r.peaks is None:
        return None
    ms = r.eager.device_ms_named(NAMES)
    if ms <= 0:
        return None
    bound_ms = serve_pool_bytes(r.config) / r.peaks.hbm_bytes_per_s * 1e3
    return 100.0 * bound_ms / ms
