"""The caching allocator's peak of reserved device memory over set-up and
the window, in GiB: a CUDA graph's private pool, allocated at capture,
shows only here."""


def read(r):
    return r.reserved_peak_bytes / 2**30
