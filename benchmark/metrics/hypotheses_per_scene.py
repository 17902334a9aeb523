"""Pose hypotheses scored per scan (the program's ``hypotheses_scored``
counter, summed over a library's models), over the whole window."""


def read(run):
    hyp = [s["hypotheses"] for s in run.stats if s]
    return sum(hyp) / len(hyp) if hyp else None
