"""Device milliseconds a step of the span ``fbsde.price``, the model's price
A(i, x) (``price``: in the parity cells once a time step, in the loop): the
current stream's time between the CUDA events at the span's entry and exit,
in the traced steps, summed over the step's calls and the median over the
steps; None where the program records no spans."""


def read(run):
    try:
        from deepfbsdejsolvers_torch.utils.profiling import span_summary
    except ImportError:
        return None
    got = span_summary()["spans"].get("fbsde.price")
    return None if got is None else got["stream_ms"]
