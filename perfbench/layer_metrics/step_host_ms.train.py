"""The host milliseconds a window step spends inside the port's
``train_step`` call (the host clock, timed by the generator): zero_grad,
forward, backward and AdamW enqueued by the loop's Python, with any wait
for the device inside the call.  Where the loader's threads hold the
interpreter or the cores, the loop stalls here and not in ``next``, and
the device idles while it does."""


def read(trace):
    win = trace.get("window") or {}
    if win.get("step_call_s") is None or not win.get("steps"):
        return None
    return 1000.0 * win["step_call_s"] / win["steps"]
