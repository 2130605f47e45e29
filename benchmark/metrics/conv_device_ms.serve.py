"""Device ms a request of the convolutions (cuDNN: the backbone, the FPN,
the RPN and the heads; forward), read from an
uncaptured traced stretch, where each kernel is tied to the operation that
launched it: every kernel under an operation whose name holds "conv"."""


def read(r):
    if r.eager is None:
        return None
    ms = r.eager.device_ms_where(
        lambda kernel, ops: any("conv" in op.lower() for op in ops))
    return ms if ms > 0 else None
