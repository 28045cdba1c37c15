"""The window's peak of device memory allocated by PyTorch, in GiB."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
