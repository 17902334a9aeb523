"""Host milliseconds of the program's "finalize" range per search round in
the traced window: the prescreen, ICP, greedy acceptance and polish."""


def read(run):
    if not run.trace or not run.trace["range_n"]["finalize"]:
        return None
    return run.trace["range_s"]["finalize"] * 1e3 / run.trace["range_n"]["finalize"]
