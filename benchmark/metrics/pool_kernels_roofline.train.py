"""The pool kernels' share of their roofline over a train step, in %: the
least time the card could take to move the bytes that ROIAlign's forward
and its backward must move at the cell's shapes
(:func:`benchmark.bounds.train_pool_bytes`, over the HBM peak), over the
device time of their kernels, by name, in an uncaptured traced step:
ROIAlign's forward (B2) and the region scatter's four kernels (B1). None
where no such kernel ran."""

from benchmark.bounds import train_pool_bytes

NAMES = ("roi_align_fwd_kernel", "region_scatter_kernel", "roi_bounds_kernel",
         "rank_segments_kernel", "row_ptr_kernel")


def read(r):
    if r.eager is None or r.peaks is None:
        return None
    ms = r.eager.device_ms_named(NAMES)
    if ms <= 0:
        return None
    bound_ms = train_pool_bytes(r.config) / r.peaks.hbm_bytes_per_s * 1e3
    return 100.0 * bound_ms / ms
