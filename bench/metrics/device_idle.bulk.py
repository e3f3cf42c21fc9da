"""Device: 100 x (1 - the union of the device's operations / the traced
window) in the bulk cell, the share of the window the card had nothing to
run."""


def read(run):
    return run.idle_share()
