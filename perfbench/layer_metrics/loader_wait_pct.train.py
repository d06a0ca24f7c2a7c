"""The share of the window the training loop waits in its loader's
``next`` (the host clock, timed by the generator around the trainer's
combined loader): the batches the thread loader had not ready."""


def read(trace):
    win = trace.get("window") or {}
    if win.get("loader_wait_s") is None or not win.get("seconds"):
        return None
    return 100.0 * win["loader_wait_s"] / win["seconds"]
