"""Seconds this process spent building (nvcc) or loading the program's
kernel libraries, the set-up counter ``setup.kernels``; None where the
program keeps no such counter or loaded no kernel."""


def read(run):
    try:
        from deepfbsdejsolvers_torch.utils.profiling import setup_counters
    except ImportError:
        return None
    got = setup_counters().get("setup.kernels")
    return None if got is None else got["seconds"]
