"""Device: 100 x the model FLOPs of the work done in the traced window
(bench/work/counts.py, per item or per trained sample) / (the window x the
dense TF32 peak) in the train cell: the whole step's share of the card's peak,
which bounds every kernel's."""


def read(run):
    return run.mfu()
