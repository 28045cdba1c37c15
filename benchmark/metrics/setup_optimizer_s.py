"""Host seconds of the process's first optimizer construction and first
update (where torch's first-use imports land), the set-up counter
``setup.optimizer``; None where the program keeps no such counter."""


def read(run):
    try:
        from deepfbsdejsolvers_torch.utils.profiling import setup_counters
    except ImportError:
        return None
    got = setup_counters().get("setup.optimizer")
    return None if got is None else got["seconds"]
