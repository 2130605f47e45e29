"""Device-idle ms a request that falls inside the host's ``predict`` spans: in
the spanned stretch's profiled pass, each span's length less the union of
the device's intervals clipped to it (``benchmark/spans.py``). The rest of
the idle time is the client's. None without the program's tracer or a card."""

from benchmark import spans


def read(r):
    out = spans.result(r)
    return None if out is None else out["idle_in_predict_ms"]
