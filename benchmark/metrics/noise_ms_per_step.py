"""Device milliseconds a step of the span ``fbsde.noise``, the noise draw
(``_prenoise``: the jumps and the Brownian increments): the current
stream's time between the CUDA events at the span's entry and exit, in the
traced steps, summed over the step's calls and the median over the steps;
None where the program records no spans."""


def read(run):
    try:
        from deepfbsdejsolvers_torch.utils.profiling import span_summary
    except ImportError:
        return None
    got = span_summary()["spans"].get("fbsde.noise")
    return None if got is None else got["stream_ms"]
