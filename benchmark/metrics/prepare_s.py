"""Per layer: the StageTimer stage ``prepare``'s seconds, mean a network
of the traced window."""


def read(run):
    return run.stage_mean("prepare")
