"""Host milliseconds a step of the span ``fbsde.step`` (````make_step``'s
step: issuing the whole step, with the profiler on), the median over the
traced steps; None where the program records no spans."""


def read(run):
    try:
        from deepfbsdejsolvers_torch.utils.profiling import span_summary
    except ImportError:
        return None
    got = span_summary()["spans"].get("fbsde.step")
    return None if got is None else got["host_ms"]
