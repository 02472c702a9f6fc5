"""Images trained per second: every image of the steps completed in the
window over the whole window, host clock, the window ending in a device
synchronize."""


def read(run):
    return run.images / run.window_s
