"""Host milliseconds of the program's "hypothesize" range per search round
in the traced window: sampling, pair queries, pose fits and the ranking's
launches."""


def read(run):
    if not run.trace or not run.trace["range_n"]["hypothesize"]:
        return None
    return run.trace["range_s"]["hypothesize"] * 1e3 / run.trace["range_n"]["hypothesize"]
