"""Host milliseconds inside each ``train_step`` call of the window."""


def read(run):
    s = run.stretch
    if run.kind != "train" or not s.steps:
        return None
    return 1e3 * s.dispatch_s / s.steps
